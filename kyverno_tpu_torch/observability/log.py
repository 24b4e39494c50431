# Copied verbatim from kyverno_tpu/observability/log.py.
"""Structured operational event log — JSONL with trace correlation.

The repo's observability stack answers "how fast" (/metrics), "what
happened to THIS request" (tracing), and "which rules are hot"
(analytics) — but the discrete operational events in between (breaker
transitions, quarantine enter/heal, snapshot swap/rollback, encoder
pool restarts, SLO burns, verdict divergences) were ad-hoc
``print(file=sys.stderr)`` lines or trace events nobody tails. This
module gives them ONE structured channel:

- every event is a flat dict: ``ts`` (ISO-8601 UTC), ``level``,
  ``event``, plus event-specific fields; when the emitting thread is
  inside a traced operation the event carries its ``trace_id`` so a
  log line links straight to /debug/traces;
- sinks: human-readable stderr (the ``serve`` default) and/or a
  newline-delimited JSON file (``serve --log-file PATH``) that a log
  shipper tails without parsing prose;
- emit() never raises and never blocks on anything but the file write
  lock — operational logging must not be able to take down the ladder
  it narrates.

Library default is SILENT (no sink): tests and embedding callers opt
in via configure(); the serve entrypoint configures stderr-human by
default.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Dict, Optional

_LEVELS = ("debug", "info", "warn", "error")


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts)) + \
        f".{int((ts % 1) * 1000):03d}Z"


class OpLog:
    """Process-wide operational event log. Thread-safe; sinks are
    reconfigurable at runtime (serve wires them from flags)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._path: Optional[str] = None   # guarded-by: _lock
        self._fh = None                    # guarded-by: _lock
        self._stderr = False               # guarded-by: _lock
        self.events_emitted = 0            # guarded-by: _lock

    # -- configuration

    def configure(self, path: Optional[str] = None,
                  stderr: Optional[bool] = None) -> None:
        """``path``: JSONL sink file (append; "" / None leaves the file
        sink untouched, "off" closes it). ``stderr``: toggle the human-
        format stderr sink. An unopenable file sink degrades the
        ``oplog`` storage surface instead of raising — stderr still
        narrates, and emit()'s re-probes retry the open."""
        from ..resilience import storage as st

        err: Optional[OSError] = None
        with self._lock:
            if path == "off":
                if self._fh is not None:
                    try:
                        self._fh.close()
                    except Exception:
                        pass
                self._fh, self._path = None, None
            elif path:
                if self._fh is not None:
                    try:
                        self._fh.close()
                    except Exception:
                        pass
                try:
                    self._fh = st.open_append(path, st.SURFACE_OPLOG,
                                              record=False)
                except OSError as e:
                    self._fh, err = None, e
                self._path = path  # kept: emit()'s probes retry the open
            if stderr is not None:
                self._stderr = stderr
        if err is not None:
            # recorded OUTSIDE our lock: the degrade transition's own
            # op-log event re-enters emit()
            st.storage_health(st.SURFACE_OPLOG).record_error(err, op="open")

    def reset(self) -> None:
        self.configure(path="off", stderr=False)
        with self._lock:
            self.events_emitted = 0

    @property
    def enabled(self) -> bool:
        return self._stderr or self._fh is not None \
            or self._path is not None

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {"stderr": self._stderr, "file": self._path,
                    "events_emitted": self.events_emitted}

    # -- emission

    def emit(self, event: str, level: str = "info", **fields: Any) -> None:
        if not (self._stderr or self._fh is not None
                or self._path is not None):
            with self._lock:
                self.events_emitted += 1  # counted even when unsunk (tests)
            return
        try:
            self._emit(event, level if level in _LEVELS else "info", fields)
        except Exception:
            pass  # the log must never take down what it narrates

    def _emit(self, event: str, level: str, fields: Dict[str, Any]) -> None:
        rec: Dict[str, Any] = {"ts": _iso(time.time()), "level": level,
                               "event": event}
        # trace correlation: an event emitted under a live span carries
        # that span's trace id (breaker transitions inside a dispatch
        # span link to the batch that tripped them)
        try:
            from .tracing import global_tracer

            ctx = global_tracer.current_context()
            if ctx is not None:
                rec["trace_id"] = ctx.trace_id
        except Exception:
            pass
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        # degraded-storage ladder (surface ``oplog``): the file sink is
        # drop-and-count while the disk is sick — the stderr sink keeps
        # narrating regardless. Health accounting happens AFTER our
        # (non-reentrant) lock is released, because the degrade/heal
        # transition emits an op-log event of its own.
        from ..resilience import storage as st

        health = st.storage_health(st.SURFACE_OPLOG)
        err: Optional[OSError] = None
        wrote = False
        with self._lock:
            self.events_emitted += 1
            if self._path is not None and health.allow():
                try:
                    if self._fh is None:
                        self._fh = st.open_append(self._path,
                                                  st.SURFACE_OPLOG,
                                                  record=False)
                    st.write_frame(self._fh,
                                   json.dumps(rec, default=str) + "\n",
                                   st.SURFACE_OPLOG, path=self._path,
                                   flush=True, record=False)
                    wrote = True
                except OSError as e:
                    err = e
            if self._stderr:
                extras = " ".join(
                    f"{k}={v}" for k, v in rec.items()
                    if k not in ("ts", "level", "event"))
                print(f"{rec['ts']} {level.upper():5s} {event} "
                      f"{extras}".rstrip(), file=sys.stderr)
        if err is not None:
            health.record_error(err, op="write")
        elif wrote:
            health.record_success()


global_oplog = OpLog()
