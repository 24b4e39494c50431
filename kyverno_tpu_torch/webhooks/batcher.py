# Copied verbatim from kyverno_tpu/webhooks/batcher.py.
"""Micro-batching frontend for the admission path.

The scan engine wants big batches; admission wants low p99 latency
(SURVEY §7 'latency vs throughput split'). The batcher collects
concurrent AdmissionReview payloads for up to `max_wait_ms` (or until
`max_batch` accumulate), evaluates them as ONE device dispatch, and
fans the verdicts back out to the waiting request threads. Single
in-flight requests pay one flush interval (~2 ms default) — far below
the reference's 10 s webhook budget — while bursts amortize the
dispatch across the whole batch.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class _Pending:
    __slots__ = ("payload", "event", "result")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.result = None


class MicroBatcher:
    """evaluate_fn(payloads: list) -> list of per-payload results."""

    def __init__(
        self,
        evaluate_fn: Callable[[List[Any]], List[Any]],
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
    ) -> None:
        self._fn = evaluate_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []               # guarded-by: _lock
        self._flusher: Optional[threading.Timer] = None  # guarded-by: _lock
        self._stopped = False                          # guarded-by: _lock

    def submit(self, payload: Any, timeout: float = 30.0) -> Any:
        p = _Pending(payload)
        flush_now = False
        # _stopped is checked under the same lock that stop()'s final
        # flush drains the queue under, so a submit racing stop() either
        # fails fast here or is drained by that flush — never stranded
        # until the wait timeout
        with self._lock:
            if self._stopped:
                raise RuntimeError("batcher is stopped")
            self._queue.append(p)
            if len(self._queue) >= self.max_batch:
                flush_now = True
            elif self._flusher is None:
                self._flusher = threading.Timer(self.max_wait, self._flush)
                self._flusher.daemon = True
                self._flusher.start()
        if flush_now:
            self._flush()
        if not p.event.wait(timeout):
            raise TimeoutError("admission batch evaluation timed out")
        if isinstance(p.result, BaseException):
            raise p.result
        return p.result

    def _flush(self) -> None:
        with self._lock:
            if self._flusher is not None:
                self._flusher.cancel()
                self._flusher = None
            batch, self._queue = self._queue, []
        if not batch:
            return
        try:
            results = self._fn([p.payload for p in batch])
            if len(results) != len(batch):
                raise RuntimeError("batch evaluator returned wrong arity")
        except BaseException as e:  # propagate to every waiter
            for p in batch:
                p.result = e
                p.event.set()
            return
        for p, r in zip(batch, results):
            p.result = r
            p.event.set()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
        self._flush()
