# Copied verbatim from kyverno_tpu/resilience/faults.py.
"""Fault-injection registry — chaos behavior as a reproducible fixture.

Every failure mode this repo defends against has a *named site* where
the failure physically happens:

    tpu.dispatch        the jitted device program call (tpu/engine.py)
    context.api_call    the apiCall context backend (contextloaders.py)
    context.image_data  the imageRegistry context backend
    gctx.refresh        the GlobalContext external-API poll (entry.py)
    serving.flush       the admission pipeline's batch evaluation
    serving.hedge       the hedged scalar dispatch racing an in-flight
                        device batch (serving/batcher.py) — a raise
                        here degrades the hedge to plain waiting, a
                        delay makes the device win the race
    policyset.compile   the lifecycle manager's compile-ahead lowering
                        (full-set compiles AND per-policy bisect probes)
    encode.pool_dispatch  the encoder pool's supervisor-side chunk
                          dispatch (encode/pool.py)
    encode.worker       the encode executed INSIDE a pool worker
                        process (encode/worker.py)
    fleet.heartbeat     a replica's outbound membership heartbeat
                        (fleet/manager.py) — a raise here looks like a
                        network partition: the peer's lease keeps
                        aging and failover engages at the TTL
    fleet.peer_fetch    the verdict-cache fetch-on-miss call to a peer
                        (fleet/peering.py) — degrades to local compute
    fleet.gossip        the async push of freshly computed verdict
                        columns to peers (fleet/manager.py)
    mutate.triage       the needs-mutation device batch over the
                        compiled mutate bank (tpu/engine.py) — a raise
                        degrades every row to HOST, routing the whole
                        batch to the scalar patcher bit-identically
    mutate.patch        a policy's template-stamp pass in the mutation
                        coordinator (mutation/coordinator.py) — a raise
                        falls that policy back to the scalar patcher
    reports.fold        the incremental report delta fold
                        (reports/store.py) — a raise mid-fold degrades
                        to a full derived-count rebuild from base rows,
                        counted, never a wrong report
    reports.journal     the report WAL append (reports/store.py) — a
                        raise loses the delta from the journal (counted;
                        the in-memory fold still lands); corrupt writes
                        a mangled wire record the replay ladder must
                        truncate at
    storage.open        opening/creating a durability file or dir
                        (resilience/storage.py shim) — every surface's
                        open_append/makedirs routes through it
    storage.write       a durability write (journal frame, spool line,
                        oplog record, span export, arena flush)
    storage.fsync       the fsync of a durability file
    storage.replace     the atomic os.replace() publishing a snapshot,
                        manifest, or rotated spool file

The four ``storage.*`` sites additionally accept the OS-error modes
``enospc`` / ``eio`` / ``erofs`` — ``fire()`` raises a real ``OSError``
with the matching errno instead of ``FaultInjected``, so the injected
failure and a genuine disk failure travel the SAME except-clause — and
``storage.write`` accepts ``short`` (write a partial prefix, then
raise EIO: the torn-write fixture). Scope a storage fault to one
surface with ``match=<surface>`` (the shim's payload is
``"<surface>:<path>"``).

Tests (and the ``KYVERNO_TPU_FAULTS`` env knob) arm a site with a
probability- or count-based trigger and a mode — ``raise``, ``delay``,
``corrupt`` (shape-mangle the site's result), or ``crash``
(``os._exit`` the current process — only meaningful at
``encode.worker``, where a supervised worker process dying is a
first-class failure the pool must absorb) — so degradation paths
are exercised deterministically in CI instead of waiting for real
hardware to misbehave. Probability triggers draw from a per-fault
seeded RNG, making a chaos run replayable. A ``match=<substring>``
option scopes a fault to calls whose payload (e.g. the chunk of
resources a worker is encoding) contains the substring — the poison-
resource chaos tests use it to make ONE resource reliably lethal.

``corrupt`` is only meaningful at sites that pass their RESULT through
``FaultRegistry.corrupt()`` (today: ``tpu.dispatch``, whose verdict
table is shape-validated downstream, and ``reports.journal``, whose
mangled wire record the WAL replay ladder must truncate at). Arming
corrupt at a raise/delay only site is rejected at arm time — a chaos
run that silently injects nothing is worse than no chaos run.

Env syntax (';'-separated site specs)::

    KYVERNO_TPU_FAULTS="tpu.dispatch:raise:p=0.3;gctx.refresh:raise:count=3"
    site ':' mode [':' key=value (',' key=value)*]
    keys: p=<float 0..1> | count=<int first-N calls> | delay_s=<float>
          | seed=<int> | match=<substring of the call payload>
          | flip=1 (corrupt mode only: flip verdict VALUES with the
            shape intact — the silent wrong answer that passes every
            shape check and is only caught by shadow verification)
"""

from __future__ import annotations

import errno as _errno
import os
import threading
import time
from dataclasses import dataclass, field
from random import Random
from typing import Any, Dict, Optional

SITE_TPU_DISPATCH = "tpu.dispatch"
SITE_CONTEXT_API_CALL = "context.api_call"
SITE_CONTEXT_IMAGE_DATA = "context.image_data"
SITE_GCTX_REFRESH = "gctx.refresh"
SITE_SERVING_FLUSH = "serving.flush"
SITE_SERVING_HEDGE = "serving.hedge"
SITE_POLICYSET_COMPILE = "policyset.compile"
SITE_ENCODE_POOL_DISPATCH = "encode.pool_dispatch"
SITE_ENCODE_WORKER = "encode.worker"
SITE_FLEET_HEARTBEAT = "fleet.heartbeat"
SITE_FLEET_PEER_FETCH = "fleet.peer_fetch"
SITE_FLEET_GOSSIP = "fleet.gossip"
SITE_FLEET_TELEMETRY = "fleet.telemetry"
SITE_MUTATE_TRIAGE = "mutate.triage"
SITE_MUTATE_PATCH = "mutate.patch"
SITE_REPORTS_FOLD = "reports.fold"
SITE_REPORTS_JOURNAL = "reports.journal"
SITE_STORAGE_OPEN = "storage.open"
SITE_STORAGE_WRITE = "storage.write"
SITE_STORAGE_FSYNC = "storage.fsync"
SITE_STORAGE_REPLACE = "storage.replace"

KNOWN_SITES = frozenset({
    SITE_TPU_DISPATCH, SITE_CONTEXT_API_CALL, SITE_CONTEXT_IMAGE_DATA,
    SITE_GCTX_REFRESH, SITE_SERVING_FLUSH, SITE_SERVING_HEDGE,
    SITE_POLICYSET_COMPILE, SITE_ENCODE_POOL_DISPATCH, SITE_ENCODE_WORKER,
    SITE_FLEET_HEARTBEAT, SITE_FLEET_PEER_FETCH, SITE_FLEET_GOSSIP,
    SITE_FLEET_TELEMETRY,
    SITE_MUTATE_TRIAGE, SITE_MUTATE_PATCH,
    SITE_REPORTS_FOLD, SITE_REPORTS_JOURNAL,
    SITE_STORAGE_OPEN, SITE_STORAGE_WRITE, SITE_STORAGE_FSYNC,
    SITE_STORAGE_REPLACE,
})

MODES = ("raise", "delay", "corrupt", "crash",
         "enospc", "eio", "erofs", "short")

# OS-error modes: fire() raises OSError with the matching errno — the
# SAME exception class and errno a real full/erroring/read-only disk
# produces, so the degraded-storage ladder cannot tell (and must not
# care) whether the failure was injected or genuine.
OS_ERROR_MODES = {
    "enospc": _errno.ENOSPC,
    "eio": _errno.EIO,
    "erofs": _errno.EROFS,
}

STORAGE_SITES = frozenset({SITE_STORAGE_OPEN, SITE_STORAGE_WRITE,
                           SITE_STORAGE_FSYNC, SITE_STORAGE_REPLACE})

# sites whose result flows through FaultRegistry.corrupt(); every other
# site only has the fire() (raise/delay) hook. fleet.telemetry filters
# the OUTGOING snapshot doc server-side — the chaos fixture for the
# receiver's checksum/trust-ladder rejection path
CORRUPTIBLE_SITES = frozenset({SITE_TPU_DISPATCH, SITE_REPORTS_JOURNAL,
                               SITE_FLEET_TELEMETRY})

# sites where mode=crash (os._exit) is meaningful: the site runs in a
# SUPERVISED child process whose death the parent is built to absorb.
# Crashing an unsupervised site would just kill the engine — reject it
# at arm time like corrupt-at-non-filtering sites.
CRASHABLE_SITES = frozenset({SITE_ENCODE_WORKER})


class FaultInjected(RuntimeError):
    """The error an armed ``raise`` fault throws at its site."""


class ShortWrite(OSError):
    """Raised by an armed ``short`` fault at ``storage.write``. The
    write shim catches it, writes a partial prefix of the buffer for
    real, then re-raises it as the EIO a torn write surfaces as — the
    fixture for every loadable-prefix recovery property."""

    def __init__(self) -> None:
        super().__init__(_errno.EIO, "injected short write")


class FaultConfigError(ValueError):
    """Malformed KYVERNO_TPU_FAULTS spec / arm() arguments."""


@dataclass
class FaultSpec:
    site: str
    mode: str = "raise"
    p: Optional[float] = None       # probability trigger per call
    count: Optional[int] = None     # trigger on the first N calls
    delay_s: float = 0.01           # sleep for mode=delay
    seed: int = 0                   # RNG seed for probability triggers
    match: Optional[str] = None     # only fire when payload contains this
    # corrupt variant: instead of shape-mangling the result (which the
    # engine's shape validation CATCHES, exercising the breaker
    # ladder), flip verdict VALUES in place — a shape-valid wrong
    # answer, the silent-device-lie failure class only continuous
    # shadow verification (observability/verification.py) can detect
    flip: bool = False
    calls: int = 0                  # observed calls (all)
    fired: int = 0                  # calls that triggered
    _rng: Random = field(default_factory=Random, repr=False)

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise FaultConfigError(f"unknown fault mode {self.mode!r}")
        if self.flip and self.mode != "corrupt":
            raise FaultConfigError(
                "flip=1 only modifies corrupt-mode faults")
        if self.p is None and self.count is None:
            self.p = 1.0  # armed with no trigger = always fires
        if self.p is not None and not (0.0 <= self.p <= 1.0):
            raise FaultConfigError(f"fault probability out of range: {self.p}")
        self._rng = Random(self.seed)

    def _triggers(self) -> bool:
        self.calls += 1
        if self.count is not None:
            if self.fired >= self.count:
                return False
        elif self.p is not None and self._rng.random() >= self.p:
            return False
        self.fired += 1
        return True


def _corrupt(value: Any) -> Any:
    """Shape-mangle a site result: the wrong-shaped answer a sick
    device or a half-written upstream response produces."""
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            return value[..., :-1] if value.size else value
    except ImportError:  # numpy always present in this repo; belt+braces
        pass
    if isinstance(value, list):
        return value[:-1]
    if isinstance(value, dict):
        out = dict(value)
        if out:
            out.pop(next(iter(out)))
        return out
    if isinstance(value, str):
        return value[:-1]
    return None


def _flip(value: Any) -> Any:
    """Value-corrupt a verdict table WITHOUT changing its shape: swap
    PASS(0) <-> FAIL(2) cells. This clears every downstream shape/dtype
    check — exactly a device silently computing the wrong answer —
    so it is the fixture for shadow-verification divergence tests."""
    try:
        import numpy as np

        if isinstance(value, np.ndarray) and \
                np.issubdtype(value.dtype, np.integer):
            out = value.copy()
            out[value == 0] = 2
            out[value == 2] = 0
            return out
    except ImportError:
        pass
    return value


class FaultRegistry:
    """Armed faults by site. ``fire()`` is the raise/delay hook placed
    BEFORE the protected operation; ``corrupt()`` filters the
    operation's RESULT. Unarmed sites cost one dict lookup."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._armed: Dict[str, FaultSpec] = {}

    # -- arming

    def arm(self, site: str, mode: str = "raise", p: Optional[float] = None,
            count: Optional[int] = None, delay_s: float = 0.01,
            seed: int = 0, match: Optional[str] = None,
            flip: bool = False) -> FaultSpec:
        if site not in KNOWN_SITES:
            raise FaultConfigError(
                f"unknown fault site {site!r} (known: {sorted(KNOWN_SITES)})")
        if mode == "corrupt" and site not in CORRUPTIBLE_SITES:
            raise FaultConfigError(
                f"site {site!r} does not filter results through corrupt() "
                f"(corruptible: {sorted(CORRUPTIBLE_SITES)}) — arming it "
                f"would inject nothing")
        if mode == "crash" and site not in CRASHABLE_SITES:
            raise FaultConfigError(
                f"site {site!r} does not run in a supervised child process "
                f"(crashable: {sorted(CRASHABLE_SITES)}) — crashing it "
                f"would kill the engine, not exercise recovery")
        if mode in OS_ERROR_MODES and site not in STORAGE_SITES:
            raise FaultConfigError(
                f"mode {mode!r} is an OS-error mode; only the storage shim "
                f"sites ({sorted(STORAGE_SITES)}) route OSError through the "
                f"degraded-storage ladder")
        if mode == "short" and site != SITE_STORAGE_WRITE:
            raise FaultConfigError(
                f"mode 'short' (partial write then EIO) is only meaningful "
                f"at {SITE_STORAGE_WRITE!r}")
        spec = FaultSpec(site=site, mode=mode, p=p, count=count,
                         delay_s=delay_s, seed=seed, match=match, flip=flip)
        with self._lock:
            self._armed[site] = spec
        return spec

    def disarm(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._armed.clear()
            else:
                self._armed.pop(site, None)

    def armed(self) -> Dict[str, FaultSpec]:
        with self._lock:
            return dict(self._armed)

    def arm_from_string(self, text: str) -> int:
        """Parse the KYVERNO_TPU_FAULTS syntax; returns #faults armed."""
        n = 0
        for chunk in (text or "").split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            parts = chunk.split(":")
            if len(parts) < 2:
                raise FaultConfigError(
                    f"fault spec {chunk!r} needs at least site:mode")
            site, mode = parts[0].strip(), parts[1].strip()
            kw: Dict[str, Any] = {}
            for pair in ",".join(parts[2:]).split(","):
                pair = pair.strip()
                if not pair:
                    continue
                if "=" not in pair:
                    raise FaultConfigError(f"bad fault option {pair!r}")
                k, v = (s.strip() for s in pair.split("=", 1))
                if k == "p":
                    kw["p"] = float(v)
                elif k == "count":
                    kw["count"] = int(v)
                elif k == "delay_s":
                    kw["delay_s"] = float(v)
                elif k == "seed":
                    kw["seed"] = int(v)
                elif k == "match":
                    kw["match"] = v
                elif k == "flip":
                    kw["flip"] = v.lower() not in ("0", "false", "off", "")
                else:
                    raise FaultConfigError(f"unknown fault option {k!r}")
            self.arm(site, mode=mode, **kw)
            n += 1
        return n

    # -- firing

    def fire(self, site: str, payload: Any = None) -> None:
        """Raise/delay/crash hook. A ``corrupt`` fault never fires here
        — its trigger is consumed by ``corrupt()`` on the result
        instead. ``payload`` scopes ``match=`` faults: a string (or a
        zero-arg callable returning one, evaluated only when a match
        fault is armed — building the text is not free) describing the
        call's content."""
        spec = self._armed.get(site)  # GIL-safe fast path when unarmed
        if spec is None or spec.mode == "corrupt":
            return
        if spec.match is not None:
            text = payload() if callable(payload) else (payload or "")
            if spec.match not in text:
                return
        with self._lock:
            triggered = spec._triggers()
        if not triggered:
            return
        self._count(spec)
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            return
        if spec.mode == "crash":
            # the supervised-worker death path: no cleanup, no excuses —
            # exactly what an OOM kill or a segfaulting extension does
            os._exit(70)
        if spec.mode in OS_ERROR_MODES:
            code = OS_ERROR_MODES[spec.mode]
            raise OSError(code, os.strerror(code), str(payload() if
                          callable(payload) else payload or site))
        if spec.mode == "short":
            raise ShortWrite()
        raise FaultInjected(f"injected fault at {site}")

    def corrupt(self, site: str, value: Any) -> Any:
        """Result filter for ``corrupt``-mode faults."""
        spec = self._armed.get(site)
        if spec is None or spec.mode != "corrupt":
            return value
        with self._lock:
            triggered = spec._triggers()
        if not triggered:
            return value
        self._count(spec)
        return _flip(value) if spec.flip else _corrupt(value)

    @staticmethod
    def _count(spec: FaultSpec) -> None:
        from ..observability.metrics import global_registry
        from ..observability.tracing import global_tracer

        global_registry.faults_injected.inc(
            {"site": spec.site, "mode": spec.mode})
        # chaos runs must be attributable per-trace: the span under
        # which the fault fired records it as an event
        global_tracer.add_event("fault_injected", site=spec.site,
                                mode=spec.mode, fired=spec.fired)


global_faults = FaultRegistry()
# env arming happens once at import: the knob is a process-launch
# switch (chaos CI runs), not a hot-reloaded config. A malformed spec
# fails the process LOUDLY here — silently running a chaos suite with
# no chaos armed would be the worst possible degradation — but names
# the env var so the operator knows exactly what to fix.
try:
    global_faults.arm_from_string(os.environ.get("KYVERNO_TPU_FAULTS", ""))
except FaultConfigError as e:
    raise FaultConfigError(f"malformed KYVERNO_TPU_FAULTS env value: {e}") \
        from None
