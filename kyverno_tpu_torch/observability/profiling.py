# Copied from kyverno_tpu/observability/profiling.py (the one-shot trace is
# taken with torch.profiler, written as a Chrome trace).
"""Per-phase profiling — where did the scan's wall time actually go?

SURVEY §5 splits accelerator scan cost into encode / device / host
phases; tuning any of them requires attribution first. The profiler
accumulates (seconds, calls) per named phase process-wide; the engine
hot paths mark ``encode`` / ``compile`` / ``dispatch`` / ``readback`` /
``host_complete``, and consumers (``apply --profile``, ``bench.py
--phases``, ``/debug/state``) read the breakdown without re-timing
anything.

Also here: the thread-local dispatch-path marker (device vs scalar
fallback — the serving pipeline reads it to name the per-request
dispatch span honestly) and the one-shot ``torch.profiler`` capture
latch behind ``KYVERNO_TPU_XLA_TRACE_DIR`` (the reference's flag name).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

PHASE_ENCODE = "encode"
PHASE_COMPILE = "compile"
PHASE_DISPATCH = "dispatch"
PHASE_READBACK = "readback"
PHASE_HOST_COMPLETE = "host_complete"
# pipelined-scan consumer idle time: the main loop blocked on the
# encode queue with nothing in flight — the device was starving
# (observability/analytics.py StarvationTracker owns the windowed view)
PHASE_ENCODE_WAIT = "encode_wait"

# canonical print order; unknown phases sort after these
PHASE_ORDER = (PHASE_ENCODE, PHASE_ENCODE_WAIT, PHASE_COMPILE,
               PHASE_DISPATCH, PHASE_READBACK, PHASE_HOST_COMPLETE)


class PhaseProfiler:
    """Thread-safe accumulator of per-phase wall time."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seconds: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._seconds[name] = self._seconds.get(name, 0.0) + seconds
            self._calls[name] = self._calls.get(name, 0) + 1

    def breakdown(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "seconds": round(self._seconds[name], 6),
                    "calls": self._calls[name],
                    "mean_ms": round(
                        self._seconds[name] / self._calls[name] * 1e3, 4),
                }
                for name in self._ordered_names()
            }

    def _ordered_names(self):
        known = [p for p in PHASE_ORDER if p in self._seconds]
        extra = sorted(n for n in self._seconds if n not in PHASE_ORDER)
        return known + extra

    def render_table(self, title: str = "per-phase latency breakdown") -> str:
        """Aligned text table (the `apply --profile` output)."""
        bd = self.breakdown()
        if not bd:
            return f"{title}: no phases recorded"
        total = sum(v["seconds"] for v in bd.values())
        rows = [("phase", "seconds", "calls", "mean_ms", "share")]
        for name, v in bd.items():
            share = (v["seconds"] / total * 100.0) if total else 0.0
            rows.append((name, f"{v['seconds']:.4f}", str(v["calls"]),
                         f"{v['mean_ms']:.3f}", f"{share:5.1f}%"))
        rows.append(("total", f"{total:.4f}", "", "", "100.0%"))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        lines = [title]
        for i, r in enumerate(rows):
            lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._seconds.clear()
            self._calls.clear()


global_profiler = PhaseProfiler()


# -- dispatch-path marker ---------------------------------------------------
# guarded_dispatch records HOW the last batch on this thread resolved
# (device vs scalar fallback); the serving flusher — which runs the
# evaluator inline on its own thread — reads it to name the request's
# dispatch span. Thread-local, so concurrent scanners don't cross-talk.

_tls = threading.local()

PATH_DEVICE = "device"
PATH_SCALAR_FALLBACK = "scalar_fallback"


def set_dispatch_path(path: str) -> None:
    _tls.dispatch_path = path


def last_dispatch_path(default: str = PATH_DEVICE) -> str:
    return getattr(_tls, "dispatch_path", default)


# -- optional device profiler capture ---------------------------------------

XLA_TRACE_ENV = "KYVERNO_TPU_XLA_TRACE_DIR"
_xla_latch_lock = threading.Lock()
_xla_captured = False


@contextmanager
def maybe_xla_trace(out_dir: Optional[str] = None):
    """Capture ONE ``torch.profiler`` trace (host and CUDA activity) of
    the wrapped region when the flag is set (``KYVERNO_TPU_XLA_TRACE_DIR``
    or an explicit dir), written as ``<dir>/trace-<pid>.json`` in the
    Chrome trace format; a one-shot latch keeps steady-state dispatches
    unperturbed after the first capture. No flag -> zero-cost
    passthrough."""
    global _xla_captured
    target = out_dir or os.environ.get(XLA_TRACE_ENV, "")
    if not target:
        yield False
        return
    with _xla_latch_lock:
        if _xla_captured:
            yield False
            return
        _xla_captured = True
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:
        prof = None  # profiler unavailability must not fail the dispatch
    try:
        yield prof is not None
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(target, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(target, f"trace-{os.getpid()}.json"))
            except Exception:
                pass


def reset_xla_trace_latch() -> None:
    """Re-arm the one-shot capture (tests / repeated profile runs)."""
    global _xla_captured
    with _xla_latch_lock:
        _xla_captured = False
