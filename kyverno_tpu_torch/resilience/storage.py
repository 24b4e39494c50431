# Copied verbatim from kyverno_tpu/resilience/storage.py.
"""Storage shim + per-surface degraded-storage ladder.

Every durability surface in the engine (reports journal/snapshot,
columnar arenas, flight spool, divergence log, op-log, OTLP trace
export, XLA compile cache) routes its filesystem side effects through
the thin wrappers here — ``open_append`` / ``write_frame`` /
``atomic_replace`` / ``fsync`` / ``mmap_sync`` / ``makedirs`` — for
two reasons:

1. **One fault choke point.** Each wrapper fires a ``storage.*`` fault
   site (``resilience/faults.py``) before touching the OS, so chaos
   runs can inject ENOSPC / EIO / EROFS / short writes per surface
   (``match=<surface>``) and the injected ``OSError`` travels the SAME
   except-clause a genuinely full or erroring disk does. Injected and
   real failures are indistinguishable by construction.

2. **One degradation ladder.** Every wrapper reports into a per-surface
   :class:`StorageHealth`: OK -> DEGRADED on the first ``OSError``,
   then capped jittered re-probes (``RetryPolicy.delay``) until a probe
   write succeeds and the surface heals. While degraded, each surface
   runs a defined *memory mode* chosen by its owner — reports fold
   in memory only (bit-identical) and compact on heal, the columnar
   store drops its mmap backing to anonymous arenas, spool/op-log/trace
   surfaces drop-and-count, the XLA cache disables itself — so a sick
   disk degrades durability and NOTHING else: verdicts stay correct,
   serving stays up, readiness stays green (a ``/readyz`` advisory and
   the ``kyverno_storage_degraded`` gauge carry the alert instead).

Transitions (and only transitions) emit an op-log event, a tracer
event, and flip the gauge; every error counts on
``kyverno_storage_errors_total{surface,kind}`` and every heal on
``kyverno_storage_heals_total{surface}``. All emission happens OUTSIDE
the health lock — the op-log is itself a guarded surface, and a ladder
that deadlocks reporting its own degradation would be worse than the
disk failure it survived.
"""

from __future__ import annotations

import errno
import os
import threading
import time
from random import Random
from typing import IO, Any, Dict, Optional

from .faults import (SITE_STORAGE_FSYNC, SITE_STORAGE_OPEN,
                     SITE_STORAGE_REPLACE, SITE_STORAGE_WRITE, ShortWrite,
                     global_faults)
from .retry import RetryPolicy

# The durability surfaces. One StorageHealth per surface; the shim's
# fault payload is "<surface>:<path>" so match=<surface> scopes a
# chaos run to exactly one of them.
SURFACE_REPORTS = "reports"
SURFACE_COLUMNAR = "columnar"
SURFACE_FLIGHT = "flight_spool"
SURFACE_DIVERGENCES = "divergences"
SURFACE_OPLOG = "oplog"
SURFACE_TRACE = "trace_export"
SURFACE_XLA_CACHE = "xla_cache"

SURFACES = (SURFACE_REPORTS, SURFACE_COLUMNAR, SURFACE_FLIGHT,
            SURFACE_DIVERGENCES, SURFACE_OPLOG, SURFACE_TRACE,
            SURFACE_XLA_CACHE)

OK = "ok"
DEGRADED = "degraded"

# Re-probe cadence while degraded: ~0.5s after the first failure,
# doubling (jittered) to a 15s cap — frequent enough that freed disk
# space restores durability within seconds, slow enough that a dead
# disk costs one failed syscall per surface per 15s, not a hot loop.
REPROBE_POLICY = RetryPolicy(max_attempts=1, base_delay_s=0.5,
                             max_delay_s=15.0, multiplier=2.0,
                             jitter=0.5, deadline_s=None)
_MAX_BACKOFF_STEP = 8


def classify_os_error(err: OSError) -> str:
    """Map an OSError to the error-kind label. EFBIG (RLIMIT_FSIZE —
    how CI manufactures a *real* full disk) and EDQUOT are
    space-exhaustion like ENOSPC; EACCES/EPERM/EROFS are all
    'the mount went read-only on us' class."""
    no = getattr(err, "errno", None)
    if no in (errno.ENOSPC, errno.EFBIG, getattr(errno, "EDQUOT", -1)):
        return "enospc"
    if no == errno.EIO:
        return "eio"
    if no in (errno.EROFS, errno.EACCES, errno.EPERM):
        return "erofs"
    return "other"


class StorageHealth:
    """OK/DEGRADED ladder for one durability surface.

    The contract mirrors the circuit breaker: state mutation happens
    under ``_lock``; metric/op-log/tracer emission happens after the
    lock is released and only on TRANSITIONS, so a flapping disk
    produces a bounded event stream and the op-log surface can be
    guarded by its own StorageHealth without re-entrancy."""

    def __init__(self, surface: str, policy: RetryPolicy = REPROBE_POLICY,
                 clock=time.monotonic) -> None:
        self.surface = surface
        self.policy = policy
        self._clock = clock
        self._lock = threading.Lock()
        self._rng = Random(hash(surface) & 0xFFFF)
        self._state = OK
        self._kind: Optional[str] = None
        self._errno: Optional[int] = None
        self._last_error: str = ""
        self._errors = 0
        self._drops = 0
        self._heals = 0
        self._probes = 0
        self._fail_streak = 0
        self._next_probe_at = 0.0
        self._degraded_since: Optional[float] = None

    # -- fast-path queries ------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self._state == DEGRADED  # racy read is fine: advisory

    def allow(self) -> bool:
        """Gate a durability write. Healthy -> always True. Degraded ->
        True only when a re-probe is due (and then the probe slot is
        consumed, so concurrent writers don't stampede the sick disk);
        otherwise the write is a counted drop and the caller runs its
        memory mode."""
        if self._state == OK:
            return True
        with self._lock:
            if self._state == OK:
                return True
            now = self._clock()
            if now >= self._next_probe_at:
                self._probes += 1
                self._next_probe_at = now + self.policy.delay(
                    min(self._fail_streak, _MAX_BACKOFF_STEP), self._rng)
                return True
            self._drops += 1
            return False

    def count_drop(self) -> None:
        with self._lock:
            self._drops += 1

    def force_probe(self) -> None:
        """Test/ops hook: make the next ``allow()`` a probe now instead
        of waiting out the backoff."""
        with self._lock:
            self._next_probe_at = 0.0

    # -- transitions ------------------------------------------------------

    def record_error(self, err: OSError, op: str = "") -> str:
        """An OSError reached this surface (injected or real — same
        path). Degrades on first error, pushes the next probe out on
        every error. Returns the classified kind."""
        kind = classify_os_error(err)
        with self._lock:
            self._errors += 1
            self._kind = kind
            self._errno = getattr(err, "errno", None)
            self._last_error = f"{op + ': ' if op else ''}{err}"[:200]
            degrading = self._state == OK
            if degrading:
                self._state = DEGRADED
                self._degraded_since = self._clock()
            self._fail_streak += 1
            self._next_probe_at = self._clock() + self.policy.delay(
                min(self._fail_streak, _MAX_BACKOFF_STEP), self._rng)
        self._emit_error(kind)
        if degrading:
            self._emit_transition("storage_degraded", kind=kind, op=op,
                                  error=str(err))
        return kind

    def record_success(self) -> bool:
        """A guarded write landed. Heals a degraded surface (returns
        True exactly on the degraded->ok transition so the owner can
        run its re-establish-durability step, e.g. snapshot
        compaction)."""
        if self._state == OK:
            return False
        with self._lock:
            if self._state == OK:
                return False
            self._state = OK
            self._fail_streak = 0
            self._heals += 1
            self._degraded_since = None
        self._emit_transition("storage_healed", kind=self._kind or "other")
        return True

    # -- emission (never under the lock) ----------------------------------

    def _emit_error(self, kind: str) -> None:
        try:
            from ..observability.metrics import global_registry

            global_registry.storage_errors.inc(
                {"surface": self.surface, "kind": kind})
        except Exception:
            pass

    def _emit_transition(self, event: str, **fields: Any) -> None:
        healed = event == "storage_healed"
        try:
            from ..observability.metrics import global_registry

            global_registry.storage_degraded.set(
                0.0 if healed else 1.0, {"surface": self.surface})
            if healed:
                global_registry.storage_heals.inc({"surface": self.surface})
        except Exception:
            pass
        try:
            from ..observability.tracing import global_tracer

            global_tracer.add_event(event, surface=self.surface, **fields)
        except Exception:
            pass
        # The op-log is itself a guarded surface: if IT is the degraded
        # one, this emit drops-and-counts on the file sink (stderr still
        # prints) instead of recursing — OpLog checks allow() first.
        try:
            from ..observability.log import global_oplog

            global_oplog.emit(event, surface=self.surface, **fields)
        except Exception:
            pass

    def state(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "state": self._state,
                "errors": self._errors,
                "drops": self._drops,
                "heals": self._heals,
                "probes": self._probes,
            }
            if self._kind is not None:
                out["last_kind"] = self._kind
                out["last_errno"] = self._errno
                out["last_error"] = self._last_error
            if self._degraded_since is not None:
                out["degraded_for_s"] = round(
                    self._clock() - self._degraded_since, 3)
        return out


class StorageHealthRegistry:
    """Process-global surface -> StorageHealth map, created on demand
    (introspection of an unused surface must not invent state)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_surface: Dict[str, StorageHealth] = {}

    def get(self, surface: str) -> StorageHealth:
        h = self._by_surface.get(surface)
        if h is not None:
            return h
        with self._lock:
            return self._by_surface.setdefault(surface,
                                               StorageHealth(surface))

    def state(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            items = list(self._by_surface.items())
        return {s: h.state() for s, h in sorted(items)}

    def degraded_surfaces(self) -> list:
        with self._lock:
            items = list(self._by_surface.items())
        return sorted(s for s, h in items if h.degraded)

    def reset(self) -> None:
        """Test isolation: drop all surface state and zero the gauge."""
        with self._lock:
            surfaces = list(self._by_surface)
            self._by_surface.clear()
        try:
            from ..observability.metrics import global_registry

            for s in surfaces:
                global_registry.storage_degraded.remove({"surface": s})
        except Exception:
            pass


global_storage = StorageHealthRegistry()


def storage_health(surface: str) -> StorageHealth:
    return global_storage.get(surface)


def storage_state() -> Dict[str, Dict[str, Any]]:
    return global_storage.state()


def reset_storage() -> None:
    global_storage.reset()


# ---------------------------------------------------------------------------
# The shim wrappers. Each fires its fault site (payload
# "<surface>:<path>", lazily built), performs the real OS call, and —
# unless record=False — folds the outcome into the surface's
# StorageHealth. record=False is for call sites that must defer health
# accounting until after they release their own lock (the op-log,
# whose degrade event would otherwise re-enter it).


def _payload(surface: str, path: Any):
    return lambda: f"{surface}:{path}"


def _record(surface: str, err: Optional[OSError], op: str,
            record: bool) -> None:
    if not record:
        return
    h = global_storage.get(surface)
    if err is None:
        h.record_success()
    else:
        h.record_error(err, op=op)


def open_append(path: str, surface: str, *, binary: bool = False,
                buffering: int = -1, record: bool = True) -> IO[Any]:
    """Open a durability file for append (fault site storage.open)."""
    try:
        global_faults.fire(SITE_STORAGE_OPEN, _payload(surface, path))
        fh = open(path, "ab", buffering=buffering) if binary \
            else open(path, "a", buffering=buffering, encoding="utf-8")
    except OSError as e:
        _record(surface, e, "open", record)
        raise
    _record(surface, None, "open", record)
    return fh


def open_truncate(path: str, surface: str, *, binary: bool = False,
                  buffering: int = -1, record: bool = True) -> IO[Any]:
    """Open a durability file for truncate-write — snapshot/manifest
    tmp files, fresh spool segments (fault site storage.open)."""
    try:
        global_faults.fire(SITE_STORAGE_OPEN, _payload(surface, path))
        fh = open(path, "wb", buffering=buffering) if binary \
            else open(path, "w", buffering=buffering, encoding="utf-8")
    except OSError as e:
        _record(surface, e, "open", record)
        raise
    _record(surface, None, "open", record)
    return fh


def write_frame(fh: IO[Any], data, surface: str, *, path: Any = "",
                flush: bool = False, record: bool = True) -> None:
    """Write one durability frame (fault site storage.write). An armed
    ``short`` fault makes this write a partial PREFIX of the frame for
    real before raising EIO — the torn-write fixture every
    loadable-prefix recovery property is tested against."""
    try:
        try:
            global_faults.fire(SITE_STORAGE_WRITE, _payload(surface, path))
        except ShortWrite:
            try:
                fh.write(data[: max(1, len(data) // 2)])
                fh.flush()
            except (OSError, ValueError):
                pass  # the torn write already failed harder; keep the EIO
            raise
        fh.write(data)
        if flush:
            fh.flush()
    except OSError as e:
        _record(surface, e, "write", record)
        raise
    _record(surface, None, "write", record)


def fsync(fh: IO[Any], surface: str, *, path: Any = "",
          record: bool = True) -> None:
    """Flush + fsync a durability file (fault site storage.fsync)."""
    try:
        global_faults.fire(SITE_STORAGE_FSYNC, _payload(surface, path))
        fh.flush()
        os.fsync(fh.fileno())
    except OSError as e:
        _record(surface, e, "fsync", record)
        raise
    _record(surface, None, "fsync", record)


def atomic_replace(src: str, dst: str, surface: str, *,
                   record: bool = True) -> None:
    """os.replace publishing a snapshot/manifest/rotation (fault site
    storage.replace)."""
    try:
        global_faults.fire(SITE_STORAGE_REPLACE, _payload(surface, dst))
        os.replace(src, dst)
    except OSError as e:
        _record(surface, e, "replace", record)
        raise
    _record(surface, None, "replace", record)


def mmap_sync(arr, surface: str, *, path: Any = "",
              record: bool = True) -> None:
    """Flush a numpy memmap arena to its backing file (fault site
    storage.write — it is a write, just a page-cache one)."""
    try:
        global_faults.fire(SITE_STORAGE_WRITE, _payload(surface, path))
        arr.flush()
    except OSError as e:
        _record(surface, e, "mmap_sync", record)
        raise
    _record(surface, None, "mmap_sync", record)


def makedirs(path: str, surface: str, *, record: bool = True) -> None:
    """mkdir -p for a durability dir (fault site storage.open).
    NOTE: exist_ok=True succeeds on an EXISTING dir even on a
    read-only filesystem — surfaces that need writability (XLA cache)
    must follow up with ``probe_writable``."""
    try:
        global_faults.fire(SITE_STORAGE_OPEN, _payload(surface, path))
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        _record(surface, e, "makedirs", record)
        raise
    _record(surface, None, "makedirs", record)


def probe_writable(dirpath: str, surface: str, *,
                   record: bool = True) -> None:
    """Prove a directory is actually writable by writing and removing a
    probe file — the only reliable EROFS/ENOSPC detector for surfaces
    (XLA cache) whose writes happen inside a library we don't wrap."""
    probe = os.path.join(dirpath, ".kyverno-write-probe")
    try:
        global_faults.fire(SITE_STORAGE_WRITE, _payload(surface, probe))
        with open(probe, "w") as fh:
            fh.write("probe")
        os.remove(probe)
    except OSError as e:
        _record(surface, e, "probe", record)
        raise
    _record(surface, None, "probe", record)
