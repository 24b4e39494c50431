# Copied from kyverno_tpu/serving/batcher.py (two comments reworded for
# the port's CUDA graphs and TorchEngine).
"""AdmissionPipeline — coalesce concurrent requests into padded device
batches, scheduled by class.

The pipeline sits between the HTTP admission handler and the batch
engine. A dedicated flusher thread drains the class-aware queue when a
flush trigger matures — `max_batch_size` requests accumulated, the
oldest non-bulk entry waited `max_wait_ms`, the oldest bulk entry
waited `bulk_max_wait_ms` (the coalescing window), or an entry's
deadline would otherwise expire before any timer (deadline-aware
flush). Each flush pads the live requests up to a power-of-two bucket
so the device program is dispatched at one of O(log2) shapes: the
engine keeps one CUDA graph per lane-shape bucket (tpu/graphs.py), so
bucketed padding means batches of 3, 9, or 14 requests all replay the
16-wide graph instead of capturing anew.

Scheduling (serving/queue.py + serving/scheduler.py): requests carry a
(tenant x operation x priority) class; flush composition takes urgent
(deadline-imminent) entries first, then weighted-fair order across the
non-bulk classes, and bulk traffic only when its own timer matured or
as free riders filling the flush up to its shape bucket.

Overload policy, a ladder that degrades BY CLASS instead of uniformly:

- burn-driven admission control: when the admission-latency SLO burn
  rate (observability/analytics.py SloTracker) crosses a class's
  threshold, that class sheds at submit() — bulk first, then default;
  the critical tier is never burn-shed;
- class queue shares: bulk is capped at `bulk_share` of the queue and
  the top `critical_reserve` fraction only admits critical requests;
- the global high-water mark refuses everyone (the classic backstop).

A shed either degrades to the caller-supplied scalar fallback
(graceful, verdicts still exact) or raises QueueFullError for the
handler to translate per failurePolicy; the queue never blocks
unboundedly. Separately, hedged scalar dispatch races the scalar
oracle against an in-flight device batch for any dispatched request
whose remaining deadline budget falls below `hedge_threshold` — first
resolution wins (bit-identical either way), the loser's result is
discarded, and the race lands in the flight ring.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..observability.metrics import MetricsRegistry, global_registry
from ..observability.profiling import (PATH_DEVICE, last_dispatch_path,
                                       set_dispatch_path)
from ..observability.tracing import global_tracer
from .queue import (PIN_PENDING, AdmissionQueue, DeadlineExceededError,
                    QueuedRequest, QueueFullError)
from .scheduler import (DEFAULT_CLASS_WEIGHTS, burn_shed_threshold,
                        priority_of)


@dataclass
class BatchConfig:
    max_batch_size: int = 64
    max_wait_ms: float = 2.0
    # total budget a request may spend queued; in-flight evaluation is
    # allowed to complete past it (eval_grace_s bounds the full wait)
    deadline_ms: float = 5000.0
    # how far BEFORE the oldest entry's deadline a deadline-triggered
    # flush fires: flushing at the deadline itself would drain an
    # already-expired entry that then never reaches the evaluator
    deadline_lead_ms: float = 2.0
    high_water: int = 1024
    shed_mode: str = "scalar"  # scalar | fail
    # smallest padded shape; callers wiring the pipeline to a
    # TorchEngine overwrite this with TorchEngine.MIN_BUCKET
    # (tpu/engine.py) so the pipeline's padding and the engine's own
    # bucketing agree on the dispatched shape (no double padding).
    # serving/ stays torch-free, so the engine constant is not imported
    # here
    min_bucket: int = 16
    eval_grace_s: float = 30.0
    # -- class scheduling (serving/scheduler.py)
    # weighted-fair share per priority tier; each (tenant, operation,
    # priority) class is its own flow weighted by its tier
    class_weights: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_CLASS_WEIGHTS))
    # bulk coalescing window: bulk entries wait up to this long to fill
    # whole shape buckets instead of riding (and fragmenting) every
    # max_wait_ms flush
    bulk_max_wait_ms: float = 50.0
    # entries whose remaining deadline drops below this ride the next
    # flush regardless of class credit (never below deadline_lead_ms)
    urgent_ms: float = 10.0
    # hedged scalar dispatch: once a DISPATCHED request's remaining
    # deadline budget falls below this fraction while its device batch
    # is still in flight, the submitting thread races the scalar oracle
    # against the batch (0 disables; needs a scalar fallback)
    hedge_threshold: float = 0.0
    # burn-driven shed ladder: admission-latency SLO burn rate above
    # which the tier sheds at submit() (0 disables a rung). Bulk sheds
    # first; critical is never burn-shed.
    shed_burn_bulk: float = 1.0
    shed_burn_default: float = 0.0
    # class queue shares: bulk may occupy at most bulk_share of the
    # queue; the top critical_reserve fraction admits only critical
    bulk_share: float = 0.5
    critical_reserve: float = 0.1
    # shed mode override for the bulk tier (None = shed_mode): bulk
    # floods usually want "fail" — resolve per failurePolicy instead of
    # spending scalar-oracle work on traffic that is being shed
    bulk_shed_mode: Optional[str] = None

    def bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return b

    def shed_mode_for(self, cls: Any) -> str:
        if priority_of(cls) == "bulk" and self.bulk_shed_mode:
            return self.bulk_shed_mode
        return self.shed_mode


class AdmissionPipeline:
    """evaluate_fn(padded_payloads) -> per-payload results.

    `padded_payloads` is the drained batch padded with None up to the
    bucket size; evaluate_fn must return at least as many results as
    there are real (non-None) leading payloads. scalar_fallback(payload)
    -> result is the single-request degradation path used on shed."""

    def __init__(
        self,
        evaluate_fn: Callable[[List[Any]], List[Any]],
        scalar_fallback: Optional[Callable[[Any], Any]] = None,
        config: Optional[BatchConfig] = None,
        metrics: Optional[MetricsRegistry] = None,
        version_provider: Optional[Callable[[], Any]] = None,
        cache_lookup: Optional[Callable[[Any], Any]] = None,
        flight_hook: Optional[Callable[..., None]] = None,
        hedge_fn: Optional[Callable[[Any, Any], Any]] = None,
        burn_provider: Optional[Callable[[], float]] = None,
    ) -> None:
        self._fn = evaluate_fn
        self._scalar = scalar_fallback
        # hedged dispatch path: hedge_fn(payload, pinned_version) must
        # produce the SAME rows the racing device batch would (webhooks
        # wire the scalar oracle pinned at the flush's revision); bare
        # scalar fallbacks that ignore the version work too
        self._hedge = hedge_fn if hedge_fn is not None else (
            None if scalar_fallback is None
            else (lambda payload, version: scalar_fallback(payload)))
        # SLO burn signal for the shed ladder (default: the process
        # SloTracker's cached short-window admission burn rate)
        self._burn_provider = burn_provider
        # flight recorder (observability/flightrecorder.py): called
        # once per resolved request with (payload, result-or-exception,
        # path, latency_s, trace_id, timings). Batched requests are
        # recorded from the FLUSHER thread after every waiter is woken
        # — like span recording, the black box must not tax request
        # latency; cached/shed resolutions record at submit()
        self._flight = flight_hook
        # content-addressed fast path: when the caller supplies a
        # lookup (webhooks/server.py wires the verdict cache), a repeat
        # admission of an identical manifest resolves at submit() —
        # before the queue, before the flusher, before the device.
        # None = miss; the request then takes the normal batched path
        self._cache_lookup = cache_lookup
        # policy-set version pinning (lifecycle/): with a provider, the
        # flusher captures ONE compiled version per flush and hands it
        # to evaluate_fn(padded, version) — a hot swap landing mid-queue
        # affects the NEXT flush; no batch ever mixes revisions
        self._version_provider = version_provider
        self.config = config or BatchConfig()
        self.metrics = metrics or global_registry
        self.queue = AdmissionQueue(self.config.high_water,
                                    config=self.config)
        self._stopped = False
        # guarded-by: _stats_lock
        self.stats: Dict[str, Any] = {
            "requests": 0, "flushes": 0, "evaluated": 0, "shed": 0,
            "expired": 0, "cache_hits": 0, "flush_reasons": {},
            "flushes_by_bucket": {}, "occupancy_sum": 0.0,
            "by_class": {}, "hedges": 0, "hedge_wins_scalar": 0,
            "hedge_wins_device": 0, "hedge_lost_to_error": 0,
            "hedge_lost_to_expiry": 0,
            "hedge_errors": 0, "bulk_topups": 0,
        }
        self._stats_lock = threading.Lock()
        self.metrics.serving_queue_depth.set(0)
        self._flusher = threading.Thread(target=self._run, daemon=True,
                                         name="admission-flusher")
        self._flusher.start()

    # -- caller side

    def submit(self, payload: Any, deadline_ms: Optional[float] = None,
               eval_grace_s: Optional[float] = None, cls: Any = None) -> Any:
        """``eval_grace_s`` caps how long a DISPATCHED request may wait
        past its queue budget for the evaluator; callers with a hard
        wall (the webhook's request timeout — the API server hangs up
        at timeoutSeconds regardless) pass their remaining budget so
        a wedged evaluator resolves per failurePolicy inside it instead
        of holding the connection for the full default grace. ``cls``
        is the request's scheduling class (scheduler.classify_request);
        unclassified requests ride the default tier."""
        if self._stopped:
            raise RuntimeError("admission pipeline is stopped")
        pri = priority_of(cls)
        # ONE trace per request: the submit span is the root, its
        # context rides the queue entry across the flusher handoff, and
        # the latency histogram carries the trace id as an exemplar so a
        # slow bucket links back to a concrete trace (/debug/traces).
        # The span opens BEFORE the cache lookup: a lookup that falls
        # through to a peer fetch carries this context on the wire, so
        # a peer-served admission is one connected cross-replica trace
        # — and even a pure cache hit gets a trace id in its flight
        # record.
        with global_tracer.span("admission.submit") as root:
            exemplar = {"trace_id": root.trace_id}
            if self._cache_lookup is not None:
                t0 = time.monotonic()
                try:
                    cached = self._cache_lookup(payload)
                except Exception:
                    cached = None  # lookup failures take the normal path
                if cached is not None:
                    with self._stats_lock:
                        self.stats["cache_hits"] = \
                            self.stats.get("cache_hits", 0) + 1
                        self._cstat_locked(pri)["cache_hits"] += 1
                    dt = time.monotonic() - t0
                    self.metrics.serving_request_latency.observe(
                        dt, {"path": "cached", "class": pri},
                        exemplar=exemplar)
                    self.metrics.serving_class_requests.inc(
                        {"class": pri, "outcome": "cached"})
                    self._record_slo(dt, pri)
                    self._record_flight(payload, cached, "cached", dt,
                                        root.trace_id)
                    return cached
            budget = (deadline_ms if deadline_ms is not None
                      else self.config.deadline_ms) / 1000.0
            grace = (eval_grace_s if eval_grace_s is not None
                     else self.config.eval_grace_s)
            t0 = time.monotonic()
            # burn-driven admission control BEFORE the queue: a class
            # past its burn threshold sheds now — bulk first (lowest
            # threshold), default above it, critical never
            thr = burn_shed_threshold(self.config, cls)
            if thr > 0 and self._burn() > thr:
                return self._shed(payload, cls, "burn", root, exemplar, t0)
            try:
                req = self.queue.put(payload, t0 + budget, now=t0,
                                     trace_ctx=root.context, cls=cls)
            except QueueFullError as e:
                return self._shed(payload, cls, e.reason, root, exemplar,
                                  t0, err=e)
            self.metrics.serving_queue_depth.set(self.queue.depth())
            self._publish_class_depths()
            # the deadline governs QUEUE time; only a request that
            # actually made it onto the device earns eval_grace_s to
            # complete — a request still queued past its budget (wedged
            # flusher) resolves per failurePolicy NOW, honoring the
            # webhook's request timeout
            resolved = self._wait_with_hedge(req, payload, budget, root)
            if not resolved:
                if not req.dispatched:
                    # still queued: the flusher will drain this entry
                    # later and count its expiry — counting here too
                    # would double it
                    raise DeadlineExceededError(
                        "request deadline expired while queued")
                if not req.event.wait(grace):
                    # dispatched but the evaluator outran the grace:
                    # the flusher's eventual resolve goes unread, so
                    # this is the only place the outcome can count
                    self.metrics.serving_class_requests.inc(
                        {"class": pri, "outcome": "expired"})
                    raise DeadlineExceededError(
                        "admission batch evaluation timed out")
            dt = time.monotonic() - t0
            path = "hedged" if req.winner == "hedge_scalar" else "batched"
            self.metrics.serving_request_latency.observe(
                dt, {"path": path, "class": pri}, exemplar=exemplar)
            self._record_slo(dt, pri)
            if isinstance(req.result, BaseException):
                # one outcome per request: mid-queue expiries were
                # already counted "expired" by the flusher; anything
                # else resolved-with-error is an evaluator failure
                if not isinstance(req.result, DeadlineExceededError):
                    self.metrics.serving_class_requests.inc(
                        {"class": pri, "outcome": "error"})
                raise req.result
            self.metrics.serving_class_requests.inc(
                {"class": pri, "outcome": path})
            return req.result

    # -- overload ladder (shed) and hedged dispatch

    def _cstat_locked(self, pri: str) -> Dict[str, int]:
        """Per-class stats bucket; callers hold _stats_lock."""
        c = self.stats["by_class"].get(pri)
        if c is None:
            c = {"requests": 0, "evaluated": 0, "shed": 0, "expired": 0,
                 "cache_hits": 0, "hedges": 0}
            self.stats["by_class"][pri] = c
        return c

    def _burn(self) -> float:
        if self._burn_provider is not None:
            try:
                return float(self._burn_provider())
            except Exception:
                return 0.0
        try:
            from ..observability.analytics import global_slo

            return global_slo.admission_burn_fast()
        except Exception:
            return 0.0

    def _publish_class_depths(self) -> None:
        try:
            depths = self.queue.depth_by_class()
            for pri in ("critical", "default", "bulk"):
                self.metrics.serving_class_queue_depth.set(
                    depths.get(pri, 0), {"class": pri})
        except Exception:
            pass

    def _shed(self, payload: Any, cls: Any, reason: str, root, exemplar,
              t0: float, err: Optional[BaseException] = None) -> Any:
        """One shed decision: degrade to the scalar fallback (verdicts
        still exact) or raise for the handler to translate per
        failurePolicy — per the CLASS's shed mode (bulk floods usually
        fail fast; critical sheds prefer the exact scalar path)."""
        pri = priority_of(cls)
        with self._stats_lock:
            self.stats["shed"] += 1
            self._cstat_locked(pri)["shed"] += 1
        root.add_event("shed", reason=reason, cls=pri,
                       depth=self.queue.depth())
        self.metrics.serving_class_requests.inc(
            {"class": pri, "outcome": "shed"})
        mode = self.config.shed_mode_for(cls)
        if mode == "scalar" and self._scalar is not None:
            self.metrics.serving_shed_total.inc(
                {"outcome": "scalar", "class": pri, "reason": reason})
            with global_tracer.span("admission.scalar_fallback",
                                    parent=root.context, reason=reason):
                out = self._scalar(payload)
            dt = time.monotonic() - t0
            self.metrics.serving_request_latency.observe(
                dt, {"path": "shed", "class": pri}, exemplar=exemplar)
            self._record_slo(dt, pri)
            self._record_flight(payload, out, "shed", dt, root.trace_id)
            return out
        self.metrics.serving_shed_total.inc(
            {"outcome": "rejected", "class": pri, "reason": reason})
        e = err if err is not None else QueueFullError(
            f"shed ({reason}, class={pri})", reason=reason)
        self._record_flight(payload, e, "shed",
                            time.monotonic() - t0, root.trace_id)
        raise e

    def _wait_with_hedge(self, req: QueuedRequest, payload: Any,
                         budget: float, root) -> bool:
        """Wait out the queue budget; with hedging enabled, once the
        remaining budget falls below ``hedge_threshold`` and the
        request is DISPATCHED (its device batch is in flight), race the
        scalar oracle against the batch. Returns whether the request
        resolved inside the budget."""
        frac = self.config.hedge_threshold
        if frac <= 0 or self._hedge is None:
            return req.event.wait(budget)
        first = max(0.0, budget * (1.0 - min(frac, 1.0)))
        if req.event.wait(first):
            return True
        # the hedge condition is CONTINUOUS, not a single sample: under
        # overload — the very scenario hedging targets — the request is
        # often still QUEUED when the threshold trips (queue wait ate
        # the budget), and it gets dispatched moments later with almost
        # nothing left. Poll until the flush owns it, then race. The
        # race also waits for the flush to ASSIGN the pin: dispatched
        # flips at drain, but the pinned version lands a little later
        # in _process — racing inside that window would evaluate the
        # hedge at whatever revision is live, not the batch's, and a
        # hot swap could then make the "bit-identical" race lie. A
        # None pin (pure-scalar ladder / no version provider) is fine:
        # the hedge fn resolves the revision the same way the flush
        # evaluator will.
        while not req.event.is_set():
            remaining = req.deadline - time.monotonic()
            if remaining <= 0:
                break
            if req.dispatched and (self._version_provider is None
                                   or req.pin is not PIN_PENDING):
                self._hedge_race(req, payload, root)
                break
            req.event.wait(min(0.005, remaining))
        # the remaining wait is DEADLINE-relative, not (budget - first):
        # time spent inside the hedge race (a slow or fault-delayed
        # oracle) must come out of the request's own budget, or hedging
        # would hold the caller past the wall it exists to protect
        return req.event.wait(max(0.0, req.deadline - time.monotonic()))

    def _hedge_race(self, req: QueuedRequest, payload: Any, root) -> None:
        """The submitting thread (otherwise just blocked) evaluates the
        request through the scalar oracle at the revision its flush
        pinned and races the in-flight device batch: first resolution
        wins, the loser's bit-identical result is discarded, and the
        race is recorded in the flight ring with the winning path."""
        pri = priority_of(req.cls)
        with self._stats_lock:
            self.stats["hedges"] += 1
            self._cstat_locked(pri)["hedges"] += 1
        req.hedged = True
        # claim the flight record UP FRONT: a race that runs to
        # completion must be the one to record (labeled with its
        # winner), even when the flush's own record loop runs while
        # the oracle is still evaluating. A failed claim means the
        # request was already recorded (expired at drain, or the
        # flush raced ahead) — then whatever we produce goes
        # unrecorded, never double-recorded.
        owns = req.claim_flight()
        try:
            # chaos hook: serving.hedge faults land here, so an
            # injected hedge failure degrades to plain waiting on the
            # device batch — hedging must never make a request worse
            from ..resilience.faults import SITE_SERVING_HEDGE, global_faults

            global_faults.fire(SITE_SERVING_HEDGE)
            pin = None if req.pin is PIN_PENDING else req.pin
            with global_tracer.span("admission.hedge_dispatch",
                                    parent=root.context, cls=pri):
                out = self._hedge(payload, pin)
        except Exception:
            with self._stats_lock:
                self.stats["hedge_errors"] += 1
            self.metrics.serving_hedge.inc({"winner": "error"})
            if owns:
                # nothing to record: hand the claim back so the flush
                # records normally — and if the flush ALREADY resolved
                # (its record loop lost the claim to us and skipped),
                # re-claim and write the record ourselves, or the
                # request would vanish from the ring
                req.release_flight()
                if req.event.is_set() and req.claim_flight():
                    self._record_flight(
                        payload, req.result, "batched",
                        time.monotonic() - req.enqueued_at, root.trace_id)
            return
        if req.resolve(out, winner="hedge_scalar"):
            with self._stats_lock:
                self.stats["hedge_wins_scalar"] += 1
            self.metrics.serving_hedge.inc({"winner": "scalar"})
            root.add_event("hedge_won", winner="scalar")
            if owns:
                self._record_flight(
                    payload, out, "hedged_scalar",
                    time.monotonic() - req.enqueued_at, root.trace_id)
        elif isinstance(req.result, DeadlineExceededError):
            # the flush expired this request (deadline passed at drain)
            # while the oracle ran: no device batch raced at all, so
            # neither "device" nor "device_error" is true — the expiry
            # stood and the hedge's verdict arrived too late
            with self._stats_lock:
                self.stats["hedge_lost_to_expiry"] += 1
            self.metrics.serving_hedge.inc({"winner": "expired"})
            root.add_event("hedge_lost", winner="expired")
            if owns:
                self._record_flight(
                    payload, req.result, "hedged_expired",
                    time.monotonic() - req.enqueued_at, root.trace_id)
        elif isinstance(req.result, BaseException):
            # the flush resolved this request with an evaluator ERROR
            # before the oracle finished: the device did not "win" —
            # its batch failed, and the hedge's valid verdict arrived
            # too late to rescue the already-woken waiter. Count and
            # record that truthfully (operators reading the ring during
            # an incident must not see "device won" over an exception).
            with self._stats_lock:
                self.stats["hedge_lost_to_error"] += 1
            self.metrics.serving_hedge.inc({"winner": "device_error"})
            root.add_event("hedge_lost", winner="device_error")
            if owns:
                self._record_flight(
                    payload, req.result, "hedged_device_error",
                    time.monotonic() - req.enqueued_at,
                    root.trace_id)
        else:
            # device landed first while the oracle ran: ours is the
            # discarded (bit-identical) loser — record the race
            with self._stats_lock:
                self.stats["hedge_wins_device"] += 1
            self.metrics.serving_hedge.inc({"winner": "device"})
            root.add_event("hedge_lost", winner="device")
            if owns:
                self._record_flight(
                    payload, req.result, "hedged_device",
                    time.monotonic() - req.enqueued_at,
                    root.trace_id)

    def _record_flight(self, payload: Any, result: Any, path: str,
                       latency_s: float, trace_id: str,
                       timings: Optional[Dict[str, float]] = None) -> None:
        if self._flight is None:
            return
        try:
            self._flight(payload, result, path, latency_s, trace_id,
                         timings)
        except Exception:
            pass  # the black box must never fail a request

    @staticmethod
    def _record_slo(latency_s: float, cls: Any = None) -> None:
        """Feed the admission-latency SLO window (every path a request
        can resolve through: batched, cached, hedged, shed-to-scalar)
        — per class, so the per-class burn windows see the split."""
        try:
            from ..observability.analytics import global_slo

            global_slo.record_admission(latency_s, cls=priority_of(cls))
        except Exception:
            pass

    def stop(self) -> None:
        with self.queue.cv:
            self._stopped = True
            self.queue.closed = True
            self.queue.cv.notify_all()
        self._flusher.join(timeout=self.config.eval_grace_s)
        # the flusher's final drain normally empties the queue; if it
        # is wedged on a stuck evaluator (join timed out), whoever is
        # still QUEUED resolves now via the scalar fallback — in
        # priority order (drain_all sorts critical first), so shutdown
        # degrades service by class and never strands a waiter
        for req in self.queue.drain_all():
            try:
                if self._scalar is None:
                    raise RuntimeError(
                        "admission pipeline stopped before evaluation")
                req.resolve(self._scalar(req.payload))
                self.metrics.serving_shed_total.inc(
                    {"outcome": "shutdown",
                     "class": priority_of(req.cls)})
            except BaseException as e:  # waiter gets the error, not a hang
                req.resolve(e)

    # -- flusher side

    def _run(self) -> None:
        cfg = self.config
        while True:
            with self.queue.cv:
                while True:
                    if self.queue.depth() >= cfg.max_batch_size:
                        reason = "size"
                        break
                    if self._stopped:
                        # final drain: anything still queued flushes now
                        # (an empty queue makes this a no-op exit)
                        reason = "shutdown"
                        break
                    # class-aware flush triggers: the oldest non-bulk
                    # entry's timer, the oldest bulk entry's (longer)
                    # coalescing timer, and — EARLY, with
                    # deadline_lead_ms to spare — the tightest entry
                    # deadline, which would otherwise expire before any
                    # timer delivered it to the evaluator
                    times = self.queue.wake_times(cfg)
                    if not times:
                        t_w = time.monotonic()
                        self.queue.cv.wait()
                        self.metrics.serving_flusher_seconds.inc(
                            {"state": "wait_queue"}, time.monotonic() - t_w)
                        continue
                    now = time.monotonic()
                    flush_at = min(times.values())
                    if now >= flush_at:
                        # tie-break precedence mirrors the classic
                        # single-FIFO labels: timer before deadline,
                        # bulk's own window last
                        for label in ("timer", "deadline", "bulk_timer"):
                            if times.get(label) == flush_at:
                                reason = label
                                break
                        break
                    t_w = time.monotonic()
                    self.queue.cv.wait(flush_at - now)
                    self.metrics.serving_flusher_seconds.inc(
                        {"state": "wait_queue"}, time.monotonic() - t_w)
                batch = self.queue.drain(cfg.max_batch_size, config=cfg,
                                         stopping=self._stopped)
                drain_info = dict(self.queue.last_drain_info)
                drained_at = time.monotonic()
                stopped = self._stopped
            if batch:
                self._process(batch, reason, drained_at,
                              drain_info=drain_info)
                self.metrics.serving_queue_depth.set(self.queue.depth())
                self._publish_class_depths()
            if stopped and not batch:
                return

    def _process(self, batch: List[QueuedRequest], reason: str,
                 now: Optional[float] = None,
                 drain_info: Optional[Dict[str, Any]] = None) -> None:
        # expiry is judged at the moment the flush decision drained the
        # queue: a deadline-triggered flush fires deadline_lead_ms early
        # precisely so the entry it fires for is still live here, and
        # scheduling jitter between drain and this check must not
        # re-expire it (drained entries are marked dispatched under the
        # cv, so submit()'s wait has eval_grace_s slack for them)
        if now is None:
            now = time.monotonic()
        # queue-wait spans materialize HERE, retroactively, in each
        # request's own trace: the flusher owns the drain timestamp and
        # the queue entry carried the submit span's context over
        for req in batch:
            if req.trace_ctx is not None:
                global_tracer.record_span(
                    "admission.queue_wait", req.enqueued_at,
                    req.drained_at or now, parent=req.trace_ctx,
                    flush_reason=reason)
        # queue-occupancy attribution: aggregate request-seconds spent
        # queued, scrapeable next to the flusher's own state split
        self.metrics.serving_flusher_seconds.inc(
            {"state": "request_queue_wait"},
            sum(max(0.0, (req.drained_at or now) - req.enqueued_at)
                for req in batch))
        live: List[QueuedRequest] = []
        expired_ids = set()
        for req in batch:
            if req.deadline <= now:
                # expired mid-queue: resolve with the error instead of
                # spending device work on a verdict nobody is waiting for
                err = DeadlineExceededError(
                    "request deadline expired while queued")
                if req.resolve(err):
                    expired_ids.add(id(req))
                    self.metrics.serving_class_requests.inc(
                        {"class": priority_of(req.cls),
                         "outcome": "expired"})
                    if req.claim_flight():
                        self._record_flight(
                            req.payload, err, "batched",
                            now - req.enqueued_at,
                            req.trace_ctx.trace_id if req.trace_ctx else "")
                # else: a hedge race already resolved it — the hedge's
                # verdict stands and its accounting owns the outcome
                # (counting "expired" here too would double-count the
                # request: one outcome per request)
            else:
                live.append(req)
        n_expired = len(expired_ids)
        if n_expired:
            self.metrics.serving_deadline_expired_total.inc(value=n_expired)
        bucket = self.config.bucket(len(live)) if live else 0
        with self._stats_lock:
            self.stats["requests"] += len(batch)
            self.stats["expired"] += n_expired
            self.stats["flushes"] += 1
            reasons = self.stats["flush_reasons"]
            reasons[reason] = reasons.get(reason, 0) + 1
            if drain_info:
                self.stats["bulk_topups"] += drain_info.get("bulk_topup", 0)
            for req in batch:
                c = self._cstat_locked(priority_of(req.cls))
                c["requests"] += 1
                if id(req) in expired_ids:
                    c["expired"] += 1
                elif req.deadline > now:
                    c["evaluated"] += 1
                # hedge-rescued past-deadline entries count neither:
                # the hedge's own counters carry them
            if live:
                by_bucket = self.stats["flushes_by_bucket"]
                by_bucket[bucket] = by_bucket.get(bucket, 0) + 1
                self.stats["evaluated"] += len(live)
                self.stats["occupancy_sum"] += len(live) / bucket
        self.metrics.serving_flush_total.inc({"reason": reason})
        if not live:
            return
        self.metrics.serving_batch_size.observe(len(live))
        self.metrics.serving_batch_occupancy.observe(len(live) / bucket)
        padded = [req.payload for req in live] + [None] * (bucket - len(live))
        # pin the compiled policy-set version for this WHOLE flush
        # before evaluation: every request drained into this batch
        # evaluates against exactly this version, even if a hot swap
        # promotes a newer one while the batch is on the device
        pin = None
        if self._version_provider is not None:
            try:
                pin = self._version_provider()
            except BaseException:
                pin = None  # evaluator owns the unavailability ladder
        pin_rev = getattr(pin, "revision", None)
        if pin_rev is not None:
            with self._stats_lock:
                self.stats["last_flush_revision"] = pin_rev
        # a hedged scalar dispatch racing this batch must evaluate at
        # the SAME pinned revision, or the race could legitimately
        # produce different rows under policy churn
        for req in live:
            req.pin = pin
        t_eval0 = time.monotonic()
        set_dispatch_path(PATH_DEVICE)  # evaluator overwrites on fallback
        try:
            # chaos hook: an armed serving.flush fault lands here, so
            # an injected flush failure takes the SAME path a real
            # evaluator error takes — every waiter gets the exception
            # and the webhook layer resolves it per failurePolicy
            from ..resilience.faults import SITE_SERVING_FLUSH, global_faults

            global_faults.fire(SITE_SERVING_FLUSH)
            results = (self._fn(padded) if self._version_provider is None
                       else self._fn(padded, pin))
            if len(results) < len(live):
                raise RuntimeError("batch evaluator returned wrong arity")
        except BaseException as e:  # propagate to every waiter
            t_eval1 = time.monotonic()
            self.metrics.serving_flusher_seconds.inc(
                {"state": "evaluate"}, t_eval1 - t_eval0)
            # a request a hedged scalar dispatch already resolved keeps
            # its (correct) verdict: the evaluator error only reaches
            # waiters the hedge did not rescue
            wins = [req.resolve(e) for req in live]
            self._record_flush_spans(live, reason, bucket, now, t_eval0,
                                     t_eval1, error=f"{type(e).__name__}: {e}",
                                     revision=pin_rev)
            for req, won in zip(live, wins):
                # claim-gated like the success loop: a completed hedge
                # race owns (and already wrote) this request's record
                if not req.claim_flight():
                    continue
                self._record_flight(
                    req.payload, e if won else req.result,
                    "batched" if won else "hedged_scalar",
                    t_eval1 - req.enqueued_at,
                    req.trace_ctx.trace_id if req.trace_ctx else "",
                    {"eval_s": t_eval1 - t_eval0})
            return
        t_eval1 = time.monotonic()
        self.metrics.serving_flusher_seconds.inc(
            {"state": "evaluate"}, t_eval1 - t_eval0)
        t_resolve0 = time.monotonic()
        # first-writer-wins: a request whose hedged scalar dispatch
        # landed first keeps the scalar rows (bit-identical by the
        # hedge contract) and this flush's result for it is discarded
        wins = [req.resolve(result) for req, result in zip(live, results)]
        t_resolve1 = time.monotonic()
        self.metrics.serving_flusher_seconds.inc(
            {"state": "resolve"}, t_resolve1 - t_resolve0)
        # span recording (and any exporter I/O it triggers) happens
        # AFTER every waiter is woken: the spans carry explicit
        # timestamps, so ordering costs nothing — doing it first would
        # tax every request's latency with tracing overhead
        self._record_flush_spans(live, reason, bucket, now, t_eval0, t_eval1,
                                 revision=pin_rev)
        for req in live:
            if req.trace_ctx is not None:
                global_tracer.record_span(
                    "admission.verdict_dispatch", t_resolve0, t_resolve1,
                    parent=req.trace_ctx, batch_size=len(live))
        if self._flight is not None:
            # AFTER the waiters are resolved and the spans recorded:
            # the flusher thread still holds the dispatch-path thread-
            # local, so the hook can classify device vs fallback. A
            # lost hedge race records here too — path "hedged_scalar",
            # the rows that actually served (this flush's bit-identical
            # copy was discarded)
            eval_s = t_eval1 - t_eval0
            for req, result, won in zip(live, results, wins):
                if not req.claim_flight():
                    # a hedge race claimed this request's record up
                    # front and writes it itself labeled with the
                    # winner (hedged_scalar / hedged_device) — a second
                    # "batched" record here would double-count the
                    # request in the ring and the shadow verifier's
                    # denominators
                    continue
                self._record_flight(
                    req.payload, result if won else req.result,
                    "batched" if won else "hedged_scalar",
                    t_resolve1 - req.enqueued_at,
                    req.trace_ctx.trace_id if req.trace_ctx else "",
                    {"queue_wait_s": max(0.0, (req.drained_at or now)
                                         - req.enqueued_at),
                     "eval_s": eval_s})

    def _record_flush_spans(self, live: List[QueuedRequest], reason: str,
                            bucket: int, drained_at: float,
                            t_eval0: float, t_eval1: float,
                            error: Optional[str] = None,
                            revision: Optional[int] = None) -> None:
        """Per-request flush + dispatch spans: the batch evaluation is
        shared work, but each request's trace must tell the whole story,
        so the shared timings are recorded once per participating trace
        — named by HOW the batch actually resolved (the engine marks the
        device-vs-scalar path in a thread-local this flusher thread
        reads back). With ``error`` set (the evaluator raised), the
        flush span records the failure and no dispatch span is emitted —
        nothing dispatched."""
        traced = [r for r in live if r.trace_ctx is not None]
        if not traced:
            return
        rev_attr = {} if revision is None else {"policyset_revision": revision}
        if error is not None:
            for req in traced:
                global_tracer.record_span(
                    "admission.flush", req.drained_at or drained_at, t_eval1,
                    parent=req.trace_ctx, status="error", reason=reason,
                    batch_size=len(live), bucket=bucket, error=error,
                    **rev_attr)
            return
        path = last_dispatch_path()
        dispatch_name = ("admission.device_dispatch" if path == PATH_DEVICE
                         else "admission.scalar_fallback")
        try:
            from ..resilience.breaker import tpu_breaker

            breaker_state = tpu_breaker().state
        except Exception:
            breaker_state = "unknown"
        for req in traced:
            global_tracer.record_span(
                "admission.flush", req.drained_at or drained_at, t_eval1,
                parent=req.trace_ctx, reason=reason, batch_size=len(live),
                bucket=bucket, **rev_attr)
            global_tracer.record_span(
                dispatch_name, t_eval0, t_eval1, parent=req.trace_ctx,
                engine=path, breaker=breaker_state, batch_size=len(live))

    # -- introspection

    def mean_batch_size(self) -> float:
        with self._stats_lock:
            flushes = sum(self.stats["flushes_by_bucket"].values())
            return self.stats["evaluated"] / flushes if flushes else 0.0

    def state(self) -> Dict[str, Any]:
        """JSON-ready snapshot for /debug/state: queue pressure by
        class, bucket occupancy, flush/shed/hedge accounting."""
        with self._stats_lock:
            stats = {}
            for k, v in self.stats.items():
                if k == "by_class":
                    stats[k] = {pri: dict(c) for pri, c in v.items()}
                else:
                    stats[k] = dict(v) if isinstance(v, dict) else v
        flushes = sum(stats["flushes_by_bucket"].values())
        return {
            "queue_depth": self.queue.depth(),
            "queue_depth_by_class": self.queue.depth_by_class(),
            "high_water": self.queue.high_water,
            "stopped": self._stopped,
            "mean_batch_size": round(
                stats["evaluated"] / flushes, 3) if flushes else 0.0,
            "mean_occupancy": round(
                stats["occupancy_sum"] / flushes, 3) if flushes else 0.0,
            "config": {
                "max_batch_size": self.config.max_batch_size,
                "max_wait_ms": self.config.max_wait_ms,
                "deadline_ms": self.config.deadline_ms,
                "min_bucket": self.config.min_bucket,
                "shed_mode": self.config.shed_mode,
                "class_weights": dict(self.config.class_weights),
                "bulk_max_wait_ms": self.config.bulk_max_wait_ms,
                "hedge_threshold": self.config.hedge_threshold,
                "shed_burn_bulk": self.config.shed_burn_bulk,
                "shed_burn_default": self.config.shed_burn_default,
                "bulk_share": self.config.bulk_share,
                "critical_reserve": self.config.critical_reserve,
                "bulk_shed_mode": self.config.bulk_shed_mode,
            },
            "stats": stats,
        }
