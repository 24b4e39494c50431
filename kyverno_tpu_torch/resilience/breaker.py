# Copied verbatim from kyverno_tpu/resilience/breaker.py.
"""Circuit breaker — degradation as a first-class state.

The TPU device plane is one failure unit: a wedged runtime, a
recompile loop, or a driver fault takes out every batch, not one
request. The breaker makes that degradation deterministic (PAPERS.md,
"Applying static code analysis to firewall policies": policy engines
must fail *predictably*): after ``failure_threshold`` consecutive
device errors the breaker OPENs and callers route whole batches to the
scalar oracle — verdicts stay bit-identical, only latency degrades.
After ``reset_timeout_s`` one half-open probe batch is let through;
success closes the breaker, failure re-opens it.

State and transitions are exported on /metrics
(kyverno_tpu_breaker_state, kyverno_tpu_breaker_transitions_total) so
a trip is an alert, not a silent slowdown.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_GAUGE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """Thread-safe consecutive-failure breaker with half-open probes.

    Protocol: callers ask ``allow()`` before attempting the protected
    operation, then report ``record_success()`` / ``record_failure()``.
    ``allow() is False`` means "go straight to the fallback path".
    """

    def __init__(
        self,
        name: str = "tpu",
        failure_threshold: int = 3,
        reset_timeout_s: float = 10.0,
        half_open_probes: int = 1,
        clock=time.monotonic,
        metrics=None,
    ) -> None:
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_probes = half_open_probes
        # constructor tuning is the canonical tuning: reset() restores
        # it unless the caller retunes explicitly, so a test that tunes
        # the process-wide breaker can't leak its knobs forward
        self._default_failure_threshold = failure_threshold
        self._default_reset_timeout_s = reset_timeout_s
        self._clock = clock
        if metrics is None:
            from ..observability.metrics import global_registry

            metrics = global_registry
        self.metrics = metrics
        self._lock = threading.Lock()
        self._state = CLOSED                 # guarded-by: _lock
        self._consecutive_failures = 0       # guarded-by: _lock
        self._opened_at: Optional[float] = None  # guarded-by: _lock
        self._probes_in_flight = 0           # guarded-by: _lock
        self._publish_state_locked()

    # -- introspection

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def reset(self, failure_threshold: Optional[int] = None,
              reset_timeout_s: Optional[float] = None) -> None:
        """Force-close and retune (tests, operator action). Omitted
        tuning args restore the constructor defaults — a bare reset()
        is a full reset, not a state-only reset that silently keeps a
        previous caller's retuning."""
        with self._lock:
            self.failure_threshold = (
                failure_threshold if failure_threshold is not None
                else self._default_failure_threshold)
            self.reset_timeout_s = (
                reset_timeout_s if reset_timeout_s is not None
                else self._default_reset_timeout_s)
            self._consecutive_failures = 0
            self._probes_in_flight = 0
            self._opened_at = None
            if self._state != CLOSED:
                self._transition_locked(CLOSED)
            else:
                self._publish_state_locked()

    # -- protocol

    def allow(self) -> bool:
        with self._lock:
            if self._state == OPEN:
                if (self._opened_at is not None
                        and self._clock() - self._opened_at >= self.reset_timeout_s):
                    self._transition_locked(HALF_OPEN)
                    self._probes_in_flight = 0
                else:
                    return False
            if self._state == HALF_OPEN:
                if self._probes_in_flight >= self.half_open_probes:
                    return False
                self._probes_in_flight += 1
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state in (HALF_OPEN, OPEN):
                # OPEN can see a success when a probe raced the trip;
                # either way the device path just worked end to end
                self._transition_locked(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                self._open_locked()
            elif (self._state == CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._open_locked()

    # -- internals (lock held)

    def _open_locked(self) -> None:
        self._opened_at = self._clock()
        self._transition_locked(OPEN)

    def _transition_locked(self, to: str) -> None:
        frm, self._state = self._state, to
        if frm != to:
            self.metrics.breaker_transitions.inc(
                {"breaker": self.name, "from": frm, "to": to})
            # a transition inside a traced operation (dispatch span)
            # lands on that span, so the trace of the batch that tripped
            # or healed the breaker says so itself
            from ..observability.tracing import global_tracer

            global_tracer.add_event(
                "breaker_transition", breaker=self.name,
                from_state=frm, to_state=to,
                consecutive_failures=self._consecutive_failures)
            # flight recorder: a breaker transition is an incident
            # moment — spool the last N decisions (the evidence) when a
            # spool dir is configured, and log it structurally.
            # Transitions are rare, so the file write under the breaker
            # lock is acceptable; the cooldown bounds a flapping breaker
            try:
                from ..observability.flightrecorder import global_flight

                global_flight.on_breaker_transition(self.name, frm, to)
            except Exception:
                pass
            try:
                from ..observability.log import global_oplog

                global_oplog.emit(
                    "breaker_transition",
                    level="warn" if to == OPEN else "info",
                    breaker=self.name, from_state=frm, to_state=to,
                    consecutive_failures=self._consecutive_failures)
            except Exception:
                pass
        self._publish_state_locked()

    def _publish_state_locked(self) -> None:
        self.metrics.breaker_state.set(
            _STATE_GAUGE[self._state], {"breaker": self.name})


# the process-wide breaker guarding the TPU device plane: device errors
# are device-wide, so every TpuEngine instance (they churn with policy
# revisions) shares one breaker unless a caller injects its own
_default_lock = threading.Lock()
_default_breaker: Optional[CircuitBreaker] = None


def tpu_breaker() -> CircuitBreaker:
    global _default_breaker
    with _default_lock:
        if _default_breaker is None:
            _default_breaker = CircuitBreaker(name="tpu")
        return _default_breaker
