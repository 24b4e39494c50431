# Copied verbatim from kyverno_tpu/resilience/retry.py.
"""Retry with jittered exponential backoff under a deadline budget.

The reference engine retries external context calls (apiCall's client
retry semantics) and bounds each entry's blast radius with the webhook
budget. ``retry_call`` packages both: attempts back off exponentially
with symmetric jitter, and the whole loop is clamped to a ``Deadline``
— a retry that could not finish inside the remaining budget is not
attempted, so a flaky backend degrades into ONE bounded stall, never
an unbounded hot-loop.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


class Deadline:
    """Absolute time budget that propagates through call layers."""

    def __init__(self, budget_s: Optional[float], clock=time.monotonic) -> None:
        self._clock = clock
        self.at: Optional[float] = None if budget_s is None \
            else clock() + budget_s

    def remaining(self) -> float:
        if self.at is None:
            return float("inf")
        return self.at - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0


class RetryBudgetExceeded(TimeoutError):
    """The deadline budget ran out before an attempt succeeded."""


class PermanentError(Exception):
    """Marker for failures retrying cannot fix — a 404-style lookup, a
    validation rejection, a misconfigured reference. ``retry_call``
    re-raises these immediately instead of burning attempts and backoff
    against a backend that will give the same answer every time.
    Pluggable backends (``DataSources.api_call`` / ``image_data``,
    GlobalContext executors) raise it (or a subclass) to opt a failure
    out of retries; anything else is treated as transient."""


@dataclass(frozen=True)
class RetryPolicy:
    """APICall-style retry knobs (retries + exponential backoff)."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5          # +/- fraction of the computed delay
    deadline_s: Optional[float] = 5.0  # per-call total budget

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Backoff before attempt ``attempt+1`` (0-based failures)."""
        d = min(self.max_delay_s, self.base_delay_s * self.multiplier ** attempt)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)


DEFAULT_RETRY = RetryPolicy()


def retry_call(
    fn: Callable[[], T],
    policy: RetryPolicy = DEFAULT_RETRY,
    deadline: Optional[Deadline] = None,
    site: str = "",
    clock=time.monotonic,
    sleep=time.sleep,
    rng: Optional[random.Random] = None,
    metrics=None,
) -> T:
    """Call ``fn`` until it succeeds, attempts run out, or the deadline
    budget cannot cover the next backoff. Raises the last error (or
    RetryBudgetExceeded when the budget expired before any attempt)."""
    if metrics is None:
        from ..observability.metrics import global_registry

        metrics = global_registry
    from ..observability.tracing import global_tracer

    rng = rng or random.Random()
    if deadline is None:
        deadline = Deadline(policy.deadline_s, clock=clock)
    last: Optional[BaseException] = None
    for attempt in range(max(policy.max_attempts, 1)):
        if deadline.expired():
            break
        try:
            out = fn()
            if attempt:
                metrics.retry_attempts.inc(
                    {"site": site or "unknown", "outcome": "recovered"},
                    value=attempt)
                global_tracer.add_event(
                    "retry_recovered", site=site or "unknown",
                    attempts=attempt + 1)
            return out
        except PermanentError:
            # deterministic failure: surface it now, the backend will
            # not answer differently on attempt 2
            metrics.retry_attempts.inc(
                {"site": site or "unknown", "outcome": "permanent"})
            raise
        except Exception as e:  # noqa: BLE001 — other failures are transient
            last = e
            global_tracer.add_event(
                "retry_attempt_failed", site=site or "unknown",
                attempt=attempt + 1, error=f"{type(e).__name__}: {e}")
            if attempt + 1 >= policy.max_attempts:
                break
            pause = policy.delay(attempt, rng)
            # a backoff the budget cannot cover is a budget failure NOW,
            # not a sleep that wakes up past the caller's deadline
            if pause >= deadline.remaining():
                break
            sleep(pause)
    metrics.retry_attempts.inc({"site": site or "unknown", "outcome": "exhausted"})
    if last is None:
        raise RetryBudgetExceeded(
            f"{site or 'call'}: deadline budget exhausted before an attempt")
    raise last
