# Copied verbatim from kyverno_tpu/serving/queue.py.
"""Bounded admission queue — classes, fairness, deadlines, backpressure.

Every entry carries its arrival time, an absolute deadline, and a
scheduling class (serving/scheduler.py). The queue refuses work past a
high-water mark (QueueFullError) instead of blocking unboundedly, so
overload surfaces as an explicit shed decision at the pipeline layer
rather than as threads piling up on a lock — and the refusal is
class-aware: the bulk tier is capped at its queue share, and the top
``critical_reserve`` fraction of the queue only admits critical-tier
requests, so a kubelet storm can never occupy the headroom a user
apply needs.

Scheduling happens at DRAIN time over one arrival-ordered store:

- each entry gets a weighted-fair **virtual finish tag** at put()
  (classic WFQ: ``F = max(V, F_last[class]) + 1/weight``), so flushes
  interleave backlogged classes by weight instead of FIFO;
- **urgent** entries (remaining deadline below the urgent window) ride
  the next flush regardless of class credit;
- **bulk** entries coalesce: they are held back until their own
  (longer) timer matures or they can fill a whole batch — except as
  free riders topping a flush up to its padded shape bucket, where the
  device work is already paid for.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from .scheduler import priority_of, priority_rank, class_weight


class QueueFullError(RuntimeError):
    """Queue depth crossed a shed threshold; request was shed.
    ``reason`` says which rung refused it: ``high_water`` (global),
    ``critical_reserve`` (non-critical in the reserved headroom), or
    ``class_share`` (bulk past its queue share)."""

    def __init__(self, message: str, reason: str = "high_water"):
        super().__init__(message)
        self.reason = reason


class DeadlineExceededError(TimeoutError):
    """Request spent its whole deadline budget waiting in the queue."""


# sentinel for QueuedRequest.pin before the flush assigns its pinned
# version: drain() marks a request dispatched BEFORE _process acquires
# the pin, and a hedge racing inside that window must be able to tell
# "not assigned yet" from "pinned None (pure-scalar ladder)"
PIN_PENDING = object()


class QueuedRequest:
    __slots__ = ("payload", "enqueued_at", "deadline", "event", "result",
                 "dispatched", "trace_ctx", "drained_at", "cls", "vft",
                 "pin", "hedged", "winner", "flight_claimed", "_rlock")

    def __init__(self, payload: Any, enqueued_at: float, deadline: float,
                 trace_ctx: Any = None, cls: Any = None):
        self.payload = payload
        self.enqueued_at = enqueued_at
        self.deadline = deadline  # absolute monotonic time
        self.event = threading.Event()
        self.result: Any = None
        # the submitting request's SpanContext, carried by VALUE across
        # the queue handoff so the flusher thread's queue-wait / flush /
        # dispatch / verdict spans land in the SAME trace as the
        # submit span (observability/tracing.py)
        self.trace_ctx = trace_ctx
        self.drained_at: float = 0.0
        # set under the queue cv the instant drain() hands this entry
        # to the flusher: submit() only extends its wait past the
        # deadline budget for requests the flusher owns (eval grace),
        # never for ones still stuck in a wedged queue — and because
        # the flag flips atomically with the pop, a waiter's timeout
        # can never observe "queued" for an entry already in a flush
        self.dispatched = False
        # scheduling class (serving/scheduler.py RequestClass) + the
        # weighted-fair virtual finish tag assigned at put()
        self.cls = cls
        self.vft: float = 0.0
        # the compiled policy-set version the flush that drained this
        # entry pinned — the hedged scalar dispatch evaluates at the
        # SAME revision the racing device batch runs, so the race can
        # only ever produce bit-identical rows. PIN_PENDING until the
        # flush assigns it (possibly to None: the pure-scalar ladder)
        self.pin: Any = PIN_PENDING
        # hedge-race state: resolve() is first-writer-wins under a
        # per-request lock so the device batch and a hedged scalar
        # dispatch can race without double resolution; the loser's
        # result is discarded and `winner` names the path that landed
        self.hedged = False
        self.winner: Optional[str] = None
        # one-shot flight-record ownership: the flush's record loops
        # and a racing hedge both want to write THE record for this
        # request — claim_flight() arbitrates so exactly one side does,
        # whatever order they finish in
        self.flight_claimed = False  # guarded-by: _rlock
        self._rlock = threading.Lock()

    def claim_flight(self) -> bool:
        """Atomically claim the right to write this request's flight
        record; False when another path already owns it."""
        with self._rlock:
            if self.flight_claimed:
                return False
            self.flight_claimed = True
            return True

    def release_flight(self) -> None:
        """Hand the record back (a hedge that claimed upfront but then
        errored before producing anything to record)."""
        with self._rlock:
            self.flight_claimed = False

    def resolve(self, result: Any, winner: Optional[str] = None) -> bool:
        """First resolution wins; returns False when the request was
        already resolved (the caller lost the hedge race and must
        discard its result)."""
        with self._rlock:
            if self.event.is_set():
                return False
            self.result = result
            self.winner = winner
            self.event.set()
            return True


class AdmissionQueue:
    """Class-aware request queue guarded by one condition variable:
    put() notifies the flusher; the flusher sleeps on the cv until work
    arrives or a flush timer matures. Without a scheduling ``config``
    the queue degrades to the classic single-FIFO behavior."""

    def __init__(self, high_water: int = 1024, config: Any = None):
        self.high_water = high_water
        self.cv = threading.Condition()
        # set under cv together with the pipeline's stop flag: a put
        # racing shutdown either fails fast here or lands before the
        # final drain — never stranded until the wait timeout
        self.closed = False          # guarded-by: cv
        self._items: List[QueuedRequest] = []  # guarded-by: cv
        self._config = config
        # WFQ state: global virtual time + per-class last finish tag
        self._vt = 0.0               # guarded-by: cv
        self._finish: Dict[Any, float] = {}    # guarded-by: cv
        self._class_depth: Dict[str, int] = {}  # guarded-by: cv
        # wake_times() aggregates (oldest non-bulk arrival, oldest bulk
        # arrival, tightest deadline), maintained incrementally: put()
        # updates them in O(1) — an append at the tail can only SET an
        # empty oldest or tighten the min deadline — and drain() marks
        # them dirty for one O(n) recompute at the next read. Without
        # this, every put's notify_all would send the flusher on an
        # O(depth) walk under the cv submitters contend on.
        self._agg: Optional[tuple] = (None, None, None)  # guarded-by: cv
        # drain() telemetry for the pipeline (single flusher reader)
        self.last_drain_info: Dict[str, Any] = {}

    # -- write side

    def put(self, payload: Any, deadline: float,
            now: Optional[float] = None, trace_ctx: Any = None,
            cls: Any = None) -> QueuedRequest:
        req = QueuedRequest(payload, now if now is not None
                            else time.monotonic(), deadline, trace_ctx,
                            cls=cls)
        pri = priority_of(cls)
        cfg = self._config
        with self.cv:
            if self.closed:
                raise RuntimeError("admission queue is closed")
            depth = len(self._items)
            if depth >= self.high_water:
                raise QueueFullError(
                    f"admission queue at high-water mark "
                    f"({self.high_water})", reason="high_water")
            if cfg is not None:
                reserve = float(getattr(cfg, "critical_reserve", 0.0) or 0.0)
                if pri != "critical" and reserve > 0:
                    cap = max(1, int(self.high_water * (1.0 - reserve)))
                    if depth >= cap:
                        raise QueueFullError(
                            f"queue headroom reserved for critical class "
                            f"(depth {depth} >= {cap})",
                            reason="critical_reserve")
                share = float(getattr(cfg, "bulk_share", 1.0))
                if pri == "bulk" and share < 1.0:
                    bcap = max(1, int(self.high_water * share))
                    if self._class_depth.get("bulk", 0) >= bcap:
                        raise QueueFullError(
                            f"bulk class at its queue share ({bcap})",
                            reason="class_share")
            # weighted-fair finish tag: flows (class keys) interleave
            # by weight when backlogged; an idle flow re-enters at the
            # current virtual time instead of collecting credit
            key = cls if cls is not None else pri
            w = class_weight(getattr(cfg, "class_weights", None), cls)
            req.vft = max(self._vt, self._finish.get(key, 0.0)) + 1.0 / w
            self._finish[key] = req.vft
            self._items.append(req)
            self._class_depth[pri] = self._class_depth.get(pri, 0) + 1
            if self._agg is not None:
                nb, b, dl = self._agg
                if pri == "bulk":
                    b = req.enqueued_at if b is None else b
                else:
                    nb = req.enqueued_at if nb is None else nb
                dl = deadline if dl is None else min(dl, deadline)
                self._agg = (nb, b, dl)
            self.cv.notify_all()
        return req

    # -- flusher side (callers hold self.cv unless noted)

    def wake_times(self, config: Any) -> Dict[str, float]:
        """Absolute times at which a flush trigger matures: ``timer``
        (oldest non-bulk entry + max_wait), ``bulk_timer`` (oldest bulk
        entry + bulk_max_wait — the coalescing window), ``deadline``
        (tightest entry deadline - lead). Empty when the queue is."""
        if not self._items:
            return {}
        max_wait = config.max_wait_ms / 1000.0
        bulk_wait = getattr(config, "bulk_max_wait_ms", None)
        bulk_wait = max_wait if bulk_wait is None else bulk_wait / 1000.0
        lead = config.deadline_lead_ms / 1000.0
        if self._agg is None:  # dirtied by a drain: one O(n) recompute
            oldest_nb = oldest_b = None
            dmin = None
            for r in self._items:
                if priority_of(r.cls) == "bulk":
                    if oldest_b is None or r.enqueued_at < oldest_b:
                        oldest_b = r.enqueued_at
                else:
                    if oldest_nb is None or r.enqueued_at < oldest_nb:
                        oldest_nb = r.enqueued_at
                if dmin is None or r.deadline < dmin:
                    dmin = r.deadline
            self._agg = (oldest_nb, oldest_b, dmin)
        oldest_nb, oldest_b, dmin = self._agg
        out: Dict[str, float] = {}
        if oldest_nb is not None:
            out["timer"] = oldest_nb + max_wait
        if oldest_b is not None:
            out["bulk_timer"] = oldest_b + bulk_wait
        if dmin is not None:
            out["deadline"] = dmin - lead
        return out

    def drain(self, max_n: int, now: Optional[float] = None,
              config: Any = None, stopping: bool = False
              ) -> List[QueuedRequest]:
        """Pop up to max_n entries in scheduler order (legacy FIFO
        when no config). Callers hold self.cv."""
        now = time.monotonic() if now is None else now
        self._agg = None  # wake_times() recomputes after any pop
        if config is None:
            batch, self._items = self._items[:max_n], self._items[max_n:]
            self.last_drain_info = {}
        else:
            batch = self._select_locked(max_n, now, config, stopping)
        t = time.monotonic()
        for req in batch:
            req.dispatched = True
            req.drained_at = t  # queue-wait span boundary
            pri = priority_of(req.cls)
            if self._class_depth.get(pri, 0) > 0:
                self._class_depth[pri] -= 1
        if batch:
            self._vt = max([self._vt] + [r.vft for r in batch])
            # prune idle flows: a finish tag at or below the virtual
            # time is indistinguishable from no entry (the flow would
            # re-enter at V either way), and flow keys carry request
            # namespaces — without pruning, namespace churn grows
            # _finish without bound on a never-quiescent server
            if len(self._finish) > 64:
                vt = self._vt
                self._finish = {k: f for k, f in self._finish.items()
                                if f > vt}
        if not self._items:
            # quiescent queue: reset the virtual clock so tags do not
            # grow without bound across a long-lived process
            self._vt = 0.0
            self._finish.clear()
        return batch

    def _select_locked(self, max_n: int, now: float, cfg: Any,
                stopping: bool) -> List[QueuedRequest]:
        items = self._items
        if stopping:
            # shutdown flush: everything drains, latency-critical
            # waiters first so they resolve before bulk
            order = sorted(items, key=lambda r: (priority_rank(r.cls),
                                                 r.enqueued_at))
            chosen = order[:max_n]
            self.last_drain_info = {"stopping": True}
        else:
            # 1) urgent: remaining deadline inside the urgent window
            #    rides the next flush regardless of class credit (the
            #    window never undercuts the deadline-flush lead, or a
            #    deadline-triggered flush could strand its own trigger)
            urgent_s = max(getattr(cfg, "urgent_ms", 0.0),
                           cfg.deadline_lead_ms) / 1000.0
            urgent = sorted((r for r in items
                             if r.deadline - now <= urgent_s),
                            key=lambda r: r.deadline)
            chosen = urgent[:max_n]
            chosen_ids = {id(r) for r in chosen}
            # 2) weighted-fair order across the non-bulk classes
            nonbulk = sorted((r for r in items
                              if id(r) not in chosen_ids
                              and priority_of(r.cls) != "bulk"),
                             key=lambda r: r.vft)
            for r in nonbulk:
                if len(chosen) >= max_n:
                    break
                chosen.append(r)
                chosen_ids.add(id(r))
            # 3) bulk coalesces: eligible only when its own timer
            #    matured or it can fill a whole batch — otherwise it
            #    only tops the flush up to the padded shape bucket
            #    (free riders on slots that would have been padding)
            bulk = sorted((r for r in items
                           if id(r) not in chosen_ids
                           and priority_of(r.cls) == "bulk"),
                          key=lambda r: r.vft)
            topup = 0
            mature = False
            if bulk:
                bulk_wait_s = getattr(cfg, "bulk_max_wait_ms",
                                      cfg.max_wait_ms) / 1000.0
                oldest = min(r.enqueued_at for r in bulk)
                mature = (len(bulk) >= max_n
                          or now - oldest >= bulk_wait_s)
                if mature:
                    for r in bulk:
                        if len(chosen) >= max_n:
                            break
                        chosen.append(r)
                        chosen_ids.add(id(r))
                elif chosen:
                    cap = min(cfg.bucket(len(chosen)), max_n)
                    for r in bulk:
                        if len(chosen) >= cap:
                            break
                        chosen.append(r)
                        chosen_ids.add(id(r))
                        topup += 1
            self.last_drain_info = {
                "urgent": min(len(urgent), max_n),
                "bulk_topup": topup,
                "bulk_mature": mature,
            }
        chosen_ids = {id(r) for r in chosen}
        self._items = [r for r in items if id(r) not in chosen_ids]
        return chosen

    def drain_all(self) -> List[QueuedRequest]:
        """Pop everything, priority tiers first (shutdown path: every
        waiter must resolve, latency-critical ones before bulk)."""
        with self.cv:
            batch, self._items = self._items, []
            self._class_depth.clear()
            self._vt = 0.0
            self._finish.clear()
            self._agg = (None, None, None)
        return sorted(batch, key=lambda r: (priority_rank(r.cls),
                                            r.enqueued_at))

    # -- introspection

    def depth(self) -> int:
        return len(self._items)

    def depth_by_class(self) -> Dict[str, int]:
        # lock-free snapshot: _class_depth is written only under the cv,
        # but this runs on every submit for a GAUGE — taking the cv here
        # would serialize submitters against the flusher for telemetry.
        # The keys are the three fixed tiers, so the dict stops resizing
        # after warmup; the locked path covers the rare early race.
        try:
            return {k: v for k, v in list(self._class_depth.items())
                    if v > 0}
        except RuntimeError:
            with self.cv:
                return {k: v for k, v in self._class_depth.items() if v > 0}

    def oldest(self) -> Optional[QueuedRequest]:
        return self._items[0] if self._items else None
