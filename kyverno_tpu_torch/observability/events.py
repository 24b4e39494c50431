# Copied verbatim from kyverno_tpu/observability/events.py.
"""Event generator — async policy-event emission.

Mirror of pkg/event/controller.go:34: events enqueue without blocking
the admission/scan path, worker threads drain the queue to a pluggable
sink (in-cluster this would be the Events API; offline it is a log or
callback), the queue drops on overflow (maxQueuedEvents), and reasons
can be omitted (omit-list, cmd/kyverno/main.go:354).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

REASON_POLICY_VIOLATION = "PolicyViolation"
REASON_POLICY_APPLIED = "PolicyApplied"
REASON_POLICY_ERROR = "PolicyError"
REASON_POLICY_SKIPPED = "PolicySkipped"


@dataclass
class Event:
    reason: str
    message: str
    policy: str = ""
    rule: str = ""
    resource_kind: str = ""
    resource_name: str = ""
    resource_namespace: str = ""
    type: str = "Warning"  # Warning | Normal
    related: Dict[str, Any] = field(default_factory=dict)


class EventGenerator:
    def __init__(
        self,
        sink: Optional[Callable[[Event], None]] = None,
        workers: int = 3,
        max_queued: int = 1000,
        omit_reasons: Optional[List[str]] = None,
        metrics=None,
    ) -> None:
        self._sink = sink or (lambda e: None)
        self._queue: "queue.Queue[Optional[Event]]" = queue.Queue(maxsize=max_queued)
        self._omit = set(omit_reasons or [])
        # every counter mutation holds _counter_lock — add() and the
        # worker threads race on these, and a lost drop increment hides
        # an overload signal
        self.dropped = 0   # guarded-by: _counter_lock
        self.emitted = 0   # guarded-by: _counter_lock
        self._counter_lock = threading.Lock()
        if metrics is None:
            from .metrics import global_registry

            metrics = global_registry
        self.metrics = metrics
        self._workers = [
            threading.Thread(target=self._drain, daemon=True) for _ in range(workers)
        ]
        self._started = False
        self._stopping = False
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            if not self._started:
                for w in self._workers:
                    w.start()
                self._started = True

    def add(self, *events: Event) -> None:
        """Non-blocking enqueue; drops on overflow (the reference logs
        and drops rather than back-pressuring admission)."""
        self.start()
        for e in events:
            if e.reason in self._omit:
                continue
            try:
                self._queue.put_nowait(e)
            except queue.Full:
                with self._counter_lock:
                    self.dropped += 1
                self.metrics.events_dropped.inc()

    def _drain(self) -> None:
        while True:
            e = self._queue.get()
            if e is None:
                self._queue.task_done()
                return
            try:
                self._sink(e)
                with self._counter_lock:
                    self.emitted += 1
                self.metrics.events_emitted.inc()
            except Exception:
                pass
            finally:
                self._queue.task_done()

    def flush(self, timeout: float = 5.0) -> None:
        """Wait until every queued event has been fully processed
        (task_done accounting covers sink calls in flight)."""
        import time

        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._queue.all_tasks_done:
                if self._queue.unfinished_tasks == 0:
                    return
            time.sleep(0.005)

    def stop(self, timeout: float = 5.0) -> None:
        """Stop workers and JOIN them within a bound: a sentinel that
        cannot be enqueued now (queue full) is retried as workers drain,
        and a worker wedged in a stuck sink is abandoned at the deadline
        (daemon threads) rather than hanging shutdown forever."""
        import time

        with self._lock:
            if not self._started or self._stopping:
                return
            self._stopping = True
        deadline = time.time() + timeout
        pending = len(self._workers)
        while pending and time.time() < deadline:
            try:
                self._queue.put(None, timeout=0.05)
                pending -= 1
            except queue.Full:
                continue
        for w in self._workers:
            w.join(timeout=max(0.0, deadline - time.time()))
