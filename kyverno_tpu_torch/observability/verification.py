# Copied from kyverno_tpu/observability/verification.py (one line of the
# docstring reworded).
"""Continuous shadow verification — the bit-identity claim, audited.

The dispatch ladder's production claim is that every rung serves
verdicts bit-identical to the scalar oracle. Tests assert it; this
module AUDITS it continuously: a low-priority background thread
re-evaluates a sampled fraction of flight-recorded decisions through
the scalar oracle at the PINNED policy-set revision (the engine
reference each record carries — the same quarantine/host-cell oracle
machinery assemble() uses) and compares verdict columns bit-exactly.

Any divergence:

- increments ``kyverno_verification_divergence_total`` with the
  originating trace id attached as an OpenMetrics exemplar;
- persists the full record + both verdict tables to the flight spool
  (``divergences.ndjson``) for ``kyverno-tpu replay`` forensics;
- feeds the verdict-integrity SLO in SloTracker (advisory on
  ``/readyz``, like the other SLOs);
- emits a structured ``verdict_divergence`` operational log event.

Only records whose evaluation is a pure function of the record are
verified — the same eligibility predicate the verdict cache uses
(``engine.cache_eligible``): a policy doing live apiCall I/O can
legitimately answer differently five seconds later, and a false
divergence alarm is worse than no audit. Impure records count as
``skipped_impure`` so the blind spot is visible, not silent.

This is the approximate-automata architecture (PAPERS.md, arxiv
1710.08647) generalized to the whole engine: a fast evaluator backed
by an exact confirmer — the DFA bank applies it per pattern cell; here the
"confirmer" runs as a sampled, continuous, production-wide audit.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .flightrecorder import FlightRecord, global_flight

Rows = List[Tuple[Tuple[str, str], int]]

_QUEUE_CAP = 512


def info_from_dict(userinfo: Optional[Dict[str, Any]]):
    """RequestInfo from a recorded (or replayed) userinfo dict."""
    from ..engine.match import RequestInfo

    u = userinfo or {}
    return RequestInfo(
        username=u.get("username", ""), uid=u.get("uid", ""),
        groups=list(u.get("groups") or []),
        roles=list(u.get("roles") or []),
        cluster_roles=list(u.get("cluster_roles") or []))


def scalar_rows(engine: Any, resource: Dict[str, Any],
                ns_labels: Optional[Dict[str, str]], operation: str,
                info: Any = None) -> Rows:
    """One (resource, request) through the scalar oracle, in the
    engine's compiled-rule row order — the exact machinery assemble()
    uses for quarantine/host cells, so the shadow comparison is against
    the same oracle the ladder itself degrades to. A policy the oracle
    cannot evaluate yields per-rule ERROR, never a crash."""
    from ..tpu.engine import _scalar_rule_verdicts, build_scan_context
    from ..tpu.evaluator import ERROR, NOT_MATCHED

    per_policy: Dict[int, Optional[Dict[str, int]]] = {}
    rows: Rows = []
    for entry in engine.cps.rules:
        if entry.policy_idx not in per_policy:
            policy = engine.cps.policies[entry.policy_idx]
            try:
                pctx = build_scan_context(policy, resource, ns_labels or {},
                                          operation, info)
                per_policy[entry.policy_idx] = _scalar_rule_verdicts(
                    engine.scalar, policy, pctx)
            except Exception:
                per_policy[entry.policy_idx] = None
        verdicts = per_policy[entry.policy_idx]
        rows.append(((entry.policy_name, entry.rule_name),
                     ERROR if verdicts is None
                     else verdicts.get(entry.rule_name, NOT_MATCHED)))
    return rows


def scalar_patched(engine: Any, resource: Dict[str, Any],
                   ns_labels: Optional[Dict[str, str]], operation: str,
                   info: Any = None) -> Dict[str, Any]:
    """The full scalar mutate chain — every policy in compiled-bank
    order through ``Engine.mutate``, patched output feeding the next
    policy — the patched-output oracle for mutate records."""
    import copy

    from ..tpu.engine import build_scan_context

    patched = copy.deepcopy(resource)
    for policy in engine.cps.policies:
        if not any(r.has_mutate() for r in policy.get_rules()):
            continue
        pctx = build_scan_context(policy, patched, ns_labels or {},
                                  operation, info)
        resp = engine.scalar.mutate(pctx)
        if resp.patched_resource is not None:
            patched = resp.patched_resource
    return patched


class ShadowVerifier:
    """Sampled oracle re-evaluation of flight records.

    ``rate`` is the fraction of captured records verified (0 = off,
    the default; ``serve --shadow-verify-rate``). Async mode runs a
    bounded-queue daemon thread that yields between records (low
    priority: a full admission queue always wins the GIL race);
    ``synchronous=True`` verifies inline at offer time (tests,
    bench)."""

    def __init__(self, metrics=None, clock=time.monotonic):
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque = deque()  # guarded-by: _lock
        # popped but not yet verified (drain waits)
        self._inflight = 0  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None
        self._stopping = False  # guarded-by: _lock
        self._rng = random.Random()
        self._registered = False
        with self._lock:
            self._reset_state_locked()

    def _reset_state_locked(self) -> None:
        self.rate = 0.0
        self.synchronous = False
        # guarded-by: _lock
        self.stats: Dict[str, int] = {
            "offered": 0, "sampled_out": 0, "checked": 0, "matched": 0,
            "divergences": 0, "skipped_no_engine": 0,
            "skipped_impure": 0, "skipped_overflow": 0, "errors": 0}

    def _registry(self):
        if self._metrics is None:
            from .metrics import global_registry

            self._metrics = global_registry
        return self._metrics

    # -- configuration / lifecycle

    def configure(self, rate: Optional[float] = None,
                  synchronous: Optional[bool] = None) -> None:
        if rate is not None:
            self.rate = min(1.0, max(0.0, rate))
        if synchronous is not None:
            self.synchronous = synchronous
        if not self._registered:
            self._registered = True
            global_flight.add_sink(self.offer)
        if self.rate > 0 and not self.synchronous:
            self._ensure_thread()

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stopping = False  # guarded-by: _lock
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="shadow-verifier")
            self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    def reset(self) -> None:
        """Per-test isolation: stop the thread, drop the queue, zero
        the stats, disable. The sink registration is forgotten too —
        the recorder's own reset() clears its sink list, so the next
        configure() must re-register."""
        self.stop(timeout=2.0)
        with self._lock:
            self._queue.clear()
            self._inflight = 0
            self._reset_state_locked()
        self._registered = False

    # -- write side (flight recorder sink)

    def offer(self, rec: FlightRecord) -> None:
        if self.rate <= 0.0 or rec.verdicts is None:
            return
        with self._lock:
            self.stats["offered"] += 1
        if self.rate < 1.0 and self._rng.random() >= self.rate:
            with self._lock:
                self.stats["sampled_out"] += 1
            return
        if self.synchronous:
            self._verify(rec, rec.engine)
            return
        with self._cv:
            if len(self._queue) >= _QUEUE_CAP:
                # low priority means the audit drops work, never the
                # serving path — the counter keeps the drop honest
                self.stats["skipped_overflow"] += 1
                self._count_check("skipped_overflow")
                return
            # the queue holds ITS OWN strong engine reference: the
            # recorder drops rec.engine right after the sinks run so
            # the ring cannot pin superseded compiled versions
            self._queue.append((rec, rec.engine))
            depth = len(self._queue)
            self._cv.notify()
        self._ensure_thread()
        try:
            self._registry().verification_queue_depth.set(depth)
        except Exception:
            pass

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until the queue AND any in-flight check finish (tests,
        bench rollups)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._queue and not self._inflight:
                    return True
                pending = bool(self._queue)
            if self._thread is None or not self._thread.is_alive():
                if pending and self.rate > 0 and not self.synchronous:
                    self._ensure_thread()
                elif not pending:
                    return True
            time.sleep(0.01)
        return False

    # -- the verification loop

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopping:
                    self._cv.wait(timeout=1.0)
                if self._stopping:
                    return
                rec, engine = self._queue.popleft()
                self._inflight += 1
                depth = len(self._queue)
            try:
                self._registry().verification_queue_depth.set(depth)
            except Exception:
                pass
            try:
                self._verify(rec, engine)
            finally:
                with self._lock:
                    self._inflight -= 1
            # low priority: hand the GIL back between records so the
            # serving threads always win contention
            time.sleep(0)

    def _count_check(self, result: str) -> None:
        try:
            self._registry().verification_checks.inc({"result": result})
        except Exception:
            pass

    def _bump(self, key: str) -> None:
        with self._lock:
            self.stats[key] += 1

    def _verify(self, rec: FlightRecord, engine: Any = None) -> None:
        if engine is None:
            engine = rec.engine
        if engine is None or not isinstance(rec.resource, dict) \
                or rec.verdicts is None:
            self._bump("skipped_no_engine")
            self._count_check("skipped_no_engine")
            return
        if rec.kind == "mutate":
            self._verify_mutate(rec, engine)
            return
        try:
            eligible = bool(engine.cache_eligible)
        except Exception:
            eligible = False
        if not eligible:
            self._bump("skipped_impure")
            self._count_check("skipped_impure")
            return
        try:
            expected = scalar_rows(engine, rec.resource, rec.ns_labels,
                                   rec.operation,
                                   info_from_dict(rec.userinfo))
        except Exception:
            self._bump("errors")
            self._count_check("error")
            return
        got = list(rec.verdicts)
        diverged = {k: int(v) for k, v in got} != \
            {k: int(v) for k, v in expected}
        self._bump("checked")
        try:
            from .analytics import global_slo

            global_slo.record_verification(diverged)
        except Exception:
            pass
        if not diverged:
            self._bump("matched")
            self._count_check("match")
            return
        self._bump("divergences")
        self._count_check("diverge")
        try:
            reg = self._registry()
            reg.verification_divergence.inc(
                exemplar=({"trace_id": rec.trace_id}
                          if rec.trace_id else None))
        except Exception:
            pass
        try:
            global_flight.spool_divergence(
                rec.to_dict(), expected, got)
        except Exception:
            pass
        try:
            from .log import global_oplog

            diff_cells = [
                f"{p}/{r}:{dict(expected).get((p, r))}!={c}"
                for (p, r), c in got
                if dict(expected).get((p, r)) != int(c)][:5]
            global_oplog.emit(
                "verdict_divergence", level="error",
                record_trace_id=rec.trace_id or None,
                resource_sha=rec.resource_sha, path=rec.path,
                policyset_revision=rec.revision, cells=diff_cells)
        except Exception:
            pass

    def _verify_mutate(self, rec: FlightRecord, engine: Any) -> None:
        """Mutate records diff the PATCHED OUTPUT, not the triage rows:
        HOST rows are routing, and the all-HOST fallback column is
        correct by construction (everything scalar-patches) — a row
        diff would false-alarm on every degraded batch. The claim under
        audit is bit-identity of the served patched body against a full
        scalar re-patch at the pinned revision."""
        try:
            eligible = bool(engine.mutate_cache_eligible)
        except Exception:
            eligible = False
        if not eligible:
            # a mutate rule with live context can legitimately patch
            # differently on replay — visible blind spot, not an alarm
            self._bump("skipped_impure")
            self._count_check("skipped_impure")
            return
        try:
            expected = scalar_patched(engine, rec.resource,
                                      rec.ns_labels, rec.operation,
                                      info_from_dict(rec.userinfo))
        except Exception:
            self._bump("errors")
            self._count_check("error")
            return
        from .flightrecorder import patched_digest

        got = rec.patched if rec.patched is not None else rec.resource
        got_sha = rec.patched_sha or patched_digest(got)
        diverged = got != expected \
            or got_sha != patched_digest(expected)
        self._bump("checked")
        try:
            from .analytics import global_slo

            global_slo.record_verification(diverged)
        except Exception:
            pass
        if not diverged:
            self._bump("matched")
            self._count_check("match")
            return
        self._bump("divergences")
        self._count_check("diverge")
        try:
            reg = self._registry()
            reg.mutate_divergence.inc(
                exemplar=({"trace_id": rec.trace_id}
                          if rec.trace_id else None))
            reg.verification_divergence.inc(
                exemplar=({"trace_id": rec.trace_id}
                          if rec.trace_id else None))
        except Exception:
            pass
        try:
            doc = rec.to_dict()
            doc["expected_patched"] = expected
            global_flight.spool_divergence(doc, [], list(rec.verdicts))
        except Exception:
            pass
        try:
            from .log import global_oplog

            global_oplog.emit(
                "mutate_divergence", level="error",
                record_trace_id=rec.trace_id or None,
                resource_sha=rec.resource_sha, path=rec.path,
                policyset_revision=rec.revision,
                patched_sha=got_sha,
                expected_sha=patched_digest(expected))
        except Exception:
            pass

    # -- read side

    def state(self) -> Dict[str, Any]:
        with self._lock:
            queued = len(self._queue)
            stats = dict(self.stats)
        return {"rate": self.rate, "synchronous": self.synchronous,
                "queued": queued,
                "running": self._thread is not None
                and self._thread.is_alive(),
                "stats": stats}

    def totals(self) -> Dict[str, int]:
        """Lifetime checked/divergence counts — the monotonic half the
        fleet telemetry snapshot ships so the leader can delta-merge
        divergence across replicas (fleet/telemetry.py)."""
        with self._lock:
            return {"checked": self.stats["checked"],
                    "divergences": self.stats["divergences"]}


global_verifier = ShadowVerifier()
