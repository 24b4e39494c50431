# Copied verbatim from kyverno_tpu/globalcontext/entry.py.
"""Store entries (pkg/globalcontext/{k8sresource,externalapi}/entry.go).

Both expose ``get() -> data | raise EntryError``. The k8s-resource
entry projects the ClusterSnapshot live (subscription keeps a uid set
current); the external-API entry re-executes its call when the cached
result is older than refreshInterval, and serves the last error state
when the call keeps failing (invalid/entry.go semantics)."""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .types import ExternalAPICallSpec, KubernetesResourceSpec


class EntryError(Exception):
    pass


class KubernetesResourceEntry:
    def __init__(self, spec: KubernetesResourceSpec, snapshot) -> None:
        self.spec = spec
        self.snapshot = snapshot
        self._lock = threading.Lock()
        self._uids: set = set()
        self._stopped = False
        snapshot.subscribe(self._on_change)
        # warm from current snapshot contents
        for uid, res, _ in snapshot.items():
            if self._matches(res):
                self._uids.add(uid)

    def _matches(self, res: Dict[str, Any]) -> bool:
        from ..vap.policy import kind_to_resource

        api_version = res.get("apiVersion", "")
        group, _, version = api_version.rpartition("/")
        if self.spec.group != group or (
                self.spec.version and self.spec.version != version):
            return False
        if kind_to_resource(res.get("kind", "")) != self.spec.resource:
            return False
        if self.spec.namespace:
            ns = (res.get("metadata") or {}).get("namespace", "")
            if ns != self.spec.namespace:
                return False
        return True

    def _on_change(self, uid: str, change: str) -> None:
        if self._stopped:
            return
        with self._lock:
            if change == "delete":
                self._uids.discard(uid)
                return
            res = self.snapshot.get(uid)
            if res is not None and self._matches(res):
                self._uids.add(uid)
            else:
                self._uids.discard(uid)

    def get(self) -> List[Dict[str, Any]]:
        if self._stopped:
            raise EntryError("entry stopped")
        with self._lock:
            uids = list(self._uids)
        out = []
        for uid in uids:
            res = self.snapshot.get(uid)
            if res is not None:
                out.append(res)
        return out

    def stop(self) -> None:
        self._stopped = True
        unsub = getattr(self.snapshot, "unsubscribe", None)
        if unsub is not None:
            unsub(self._on_change)


class ExternalApiEntry:
    """Polled API entry. ``executor(spec) -> data`` is the pluggable
    call (the reference goes through apicall.Execute with service URLs,
    apiCall.go:107); refresh happens lazily when the cached value is
    older than refreshInterval, and a ``refresh()`` hook exists for a
    background poller loop.

    Degradation ladder (invalid/entry.go semantics, resilience/):
    each refresh retries with jittered backoff inside a deadline
    budget; while refreshes keep failing the entry serves the
    last-known-good data until it is older than ``stale_ttl_s``
    (default 3x refreshInterval), after which ``get()`` surfaces the
    error state; a healed backend recovers the entry on the next poll."""

    STALE_TTL_FACTOR = 3.0

    def __init__(self, spec: ExternalAPICallSpec,
                 executor: Callable[[ExternalAPICallSpec], Any],
                 clock=time.monotonic,
                 retry=None,
                 stale_ttl_s: Optional[float] = None,
                 sleep=time.sleep) -> None:
        self.spec = spec
        self.executor = executor
        self._clock = clock
        self._sleep = sleep
        if retry is None:
            from ..resilience.retry import RetryPolicy

            # the refresh loop's budget must stay well inside the
            # refresh interval or a slow-failing backend makes polls
            # pile onto each other
            retry = RetryPolicy(
                max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
                deadline_s=min(5.0, max(spec.refresh_interval_s / 2.0, 0.1)))
        self.retry = retry
        self.stale_ttl_s = (stale_ttl_s if stale_ttl_s is not None
                            else self.STALE_TTL_FACTOR * spec.refresh_interval_s)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._data: Any = None                    # guarded-by: _lock
        self._err: Optional[str] = None           # guarded-by: _lock
        self._fetched_at: Optional[float] = None  # guarded-by: _lock  (last attempt)
        self._ok_at: Optional[float] = None       # guarded-by: _lock  (last success)
        # single-flight: one lazy refresh at a time
        self._refreshing = False                  # guarded-by: _lock
        self._stopped = False

    def refresh(self) -> None:
        from ..resilience.faults import SITE_GCTX_REFRESH, global_faults
        from ..resilience.retry import Deadline, retry_call

        def attempt():
            global_faults.fire(SITE_GCTX_REFRESH)
            return self.executor(self.spec)

        try:
            data = retry_call(
                attempt, policy=self.retry,
                deadline=Deadline(self.retry.deadline_s, clock=self._clock),
                site=SITE_GCTX_REFRESH, clock=self._clock, sleep=self._sleep)
            with self._lock:
                now = self._clock()
                self._data = data
                self._err = None
                self._fetched_at = now
                self._ok_at = now
        except Exception as e:
            with self._lock:
                self._err = str(e)
                # a failed poll marks the entry stale-with-error but
                # keeps the timestamp so we don't hot-loop the executor;
                # last-known-good data stays for the stale-serve window
                self._fetched_at = self._clock()

    def _stale_locked(self) -> bool:
        return (self._fetched_at is None
                or self._clock() - self._fetched_at >= self.spec.refresh_interval_s)

    def get(self) -> Any:
        if self._stopped:
            raise EntryError("entry stopped")
        # single-flight: exactly one reader pays the retry/backoff
        # budget per staleness window; everyone else serves the cached
        # (possibly stale) value immediately. Without this, M concurrent
        # admissions against a down backend each run their own retry
        # loop — M x deadline_s of added latency and 3M redundant calls
        # onto a backend that is already failing.
        do_refresh = False
        with self._cond:
            if self._stale_locked() and not self._refreshing:
                self._refreshing = True
                do_refresh = True
        if do_refresh:
            try:
                self.refresh()
            finally:
                with self._cond:
                    self._refreshing = False
                    self._cond.notify_all()
        with self._cond:
            # cold entry (never fetched): there is nothing to serve
            # stale, so wait for the in-flight first fetch to land
            # instead of handing back an empty result. wait_for bounds
            # the TOTAL wait (a bare wait() in a loop restarts its
            # timeout on every spurious wakeup): if the refresher is
            # wedged inside a hung executor past the retry budget, this
            # surfaces the error state instead of hanging every
            # admission thread that touches the entry
            # a deadline-free retry policy still gets a FINITE wait
            # here (the refresh interval, floored at 30s): an unbounded
            # cond.wait would let one hung executor wedge every
            # admission thread that touches the cold entry
            wait_s = (self.retry.deadline_s + 1.0
                      if self.retry.deadline_s is not None
                      else max(self.spec.refresh_interval_s, 30.0))
            if not self._cond.wait_for(
                    lambda: self._fetched_at is not None
                    or not self._refreshing,
                    timeout=wait_s):
                raise EntryError(
                    "api call failed: first fetch still in flight past "
                    "the retry deadline budget")
            if self._err is None:
                return self._data
            # serve last-known-good while it is younger than the TTL:
            # a flapping backend degrades reads to slightly-stale data
            # instead of erroring every admission that touches it
            if (self._ok_at is not None
                    and self._clock() - self._ok_at < self.stale_ttl_s):
                return self._data
            raise EntryError(f"api call failed: {self._err}")

    def stop(self) -> None:
        self._stopped = True
