# Copied from kyverno_tpu/observability/analytics.py (one line of the
# docstring reworded).
"""Policy observatory — workload-level analytics over the dispatch ladder.

Tracing gives each *request* a trace; this module answers *workload*
questions: which rules are hot, which never fire, how much of the
policy set actually runs on device, is the TPU starving while the host
encodes, and are we burning the latency/freshness error budgets?

Three connected pieces:

- **RuleStatsAccumulator** — exact per-rule verdict counts (pass /
  skip / fail / not-matched / error) across EVERY path a verdict can
  take: device dispatch (where the compiled program reduces the counts
  on device, O(rules) readback), host-cell completion, scalar and
  breaker fallback, quarantine, the pipelined scanner, and
  verdict-cache hits (replayed so cached work still counts). Keyed by
  a per-policy content hash over the policy SPEC, so stats survive
  snapshot swaps, no-op re-applies, and renames.

- **StarvationTracker** — rolling-window device feed accounting: the
  fraction of device-relevant wall time the device sat idle waiting on
  host encode. This is the target metric for the encode-pool work
  (ROADMAP item 1: device capable of ~7.4B rule-evals/s, e2e bounded
  by ~927 res/s host encode).

- **SloTracker** — multi-window burn-rate tracking for the serving
  SLOs: admission p99 vs target, background-scan freshness, and the
  device-coverage floor. State lands on ``/readyz`` and the
  ``kyverno_slo_*`` gauges.

The module stays importable without jax (the CLI ``top`` view and the
metrics registry import it); verdict-code constants mirror
``tpu/evaluator.py`` and are asserted equal in tests.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

# verdict codes, tpu/evaluator.py order (mirrored, not imported: this
# module must not pull jax into metrics-only consumers)
PASS, SKIP, FAIL, NOT_MATCHED, ERROR, HOST, CONFIRM = 0, 1, 2, 3, 4, 5, 6
NUM_CLASSES = 7
CLASS_NAMES = ("pass", "skip", "fail", "not_matched", "error", "host",
               "confirm")


def class_counts(table: Any, num_classes: int = NUM_CLASSES) -> np.ndarray:
    """(rules, N) verdict table -> (rules, num_classes) per-class
    counts in ONE vectorized bincount — the host-side mirror of the
    device-side reduction the compiled program performs."""
    table = np.asarray(table)
    if table.ndim == 1:
        table = table.reshape(table.shape[0], 1) if table.size else \
            table.reshape(0, 1)
    d = table.shape[0]
    if table.size == 0:
        return np.zeros((d, num_classes), dtype=np.int64)
    idx = (table.astype(np.int64)
           + np.arange(d, dtype=np.int64)[:, None] * num_classes)
    return np.bincount(idx.ravel(),
                       minlength=d * num_classes).reshape(d, num_classes)


def policy_spec_hash(policy: Any) -> str:
    """Analytics identity of a policy: a content hash over the SPEC
    only (metadata excluded), so rule stats survive snapshot swaps,
    no-op re-applies, AND renames — the entry retires naturally when
    the rule content itself changes.

    Content-addressed identity cuts both ways: two loaded policies
    with byte-identical specs are ONE logical rule set to the
    accumulator (same stance the verdict cache takes) — their counts
    merge under the most recently compiled display name."""
    raw = getattr(policy, "raw", None)
    if isinstance(raw, dict) and raw.get("spec") is not None:
        payload = json.dumps(raw.get("spec"), sort_keys=True, default=str)
    else:
        payload = repr(getattr(policy, "spec", None))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _static_status(policy: str, rule: str) -> Dict[str, Any]:
    """The static-analysis correlation for one never-fired rule: once
    the lifecycle lint has run, a never-fired /debug/rules entry says
    WHY — ``static: "dead"`` (can never fire), ``static:
    "shadowed_by"`` + ``by`` (another rule decides first), or
    ``static: "ok"`` (just no traffic yet). Empty before any analysis
    (or when the rule's match shape was not synthesizable), so the
    field's absence itself means "no static evidence". Lazy import:
    analysis/ pulls engine machinery this module must not load."""
    try:
        from ..analysis import global_analysis

        return global_analysis.static_for(policy, rule) or {}
    except Exception:
        return {}


class RuleIdent(NamedTuple):
    """Stable identity of one rule row in a compiled set."""

    policy_hash: str
    policy_name: str
    rule_name: str
    on_device: bool


class _RuleRecord:
    __slots__ = ("policy_hash", "policy_name", "rule_name", "on_device",
                 "counts", "by_source", "first_seen", "last_fired")

    def __init__(self, ident: RuleIdent, now: float):
        self.policy_hash = ident.policy_hash
        self.policy_name = ident.policy_name
        self.rule_name = ident.rule_name
        self.on_device = ident.on_device
        self.counts = np.zeros(NUM_CLASSES, dtype=np.int64)
        self.by_source: Dict[str, int] = {}
        self.first_seen = now
        self.last_fired: Optional[float] = None

    def fired(self) -> int:
        return int(self.counts[PASS] + self.counts[FAIL] + self.counts[ERROR])


class RuleStatsAccumulator:
    """Process-wide per-rule verdict accounting. Thread-safe; every
    ingest point hands a counts matrix aligned with a rule-ident list,
    so the accumulator itself never walks verdict tables."""

    def __init__(self, clock=time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._records: Dict[Tuple[str, str], _RuleRecord] = {}  # guarded-by: _lock
        self.enabled = os.environ.get(
            "KYVERNO_TPU_RULE_STATS", "1").lower() not in ("0", "false", "off")

    # -- write side

    def _rec_locked(self, ident: RuleIdent, now: float) -> _RuleRecord:
        key = (ident.policy_hash, ident.rule_name)
        rec = self._records.get(key)
        if rec is None:
            rec = _RuleRecord(ident, now)
            self._records[key] = rec
        else:
            # latest compile wins for display name + device placement
            rec.policy_name = ident.policy_name
            rec.on_device = ident.on_device
        return rec

    def register(self, idents: Sequence[RuleIdent]) -> None:
        """Make rules visible (never-fired tracking starts at first
        registration — compile time, not first evaluation)."""
        if not self.enabled or not idents:
            return
        now = self._clock()
        with self._lock:
            for ident in idents:
                self._rec_locked(ident, now)

    def ingest_counts(self, idents: Sequence[RuleIdent], counts: Any,
                      source: str = "device") -> None:
        """``counts``: (len(idents), >=5) per-class totals in verdict-
        code order. The one write path every ladder rung funnels into."""
        if not self.enabled or not len(idents):
            return
        counts = np.asarray(counts, dtype=np.int64)
        now = self._clock()
        with self._lock:
            for ri, ident in enumerate(idents):
                row = counts[ri]
                rec = self._rec_locked(ident, now)
                rec.counts[: row.shape[0]] += row
                evals = int(row.sum())
                if evals:
                    rec.by_source[source] = rec.by_source.get(source, 0) + evals
                if int(row[PASS]) + int(row[FAIL]) + int(row[ERROR]):
                    rec.last_fired = now

    def ingest_table(self, idents: Sequence[RuleIdent], table: Any,
                     source: str = "host") -> None:
        if not self.enabled or not len(idents):
            return
        self.ingest_counts(idents, class_counts(table), source=source)

    def ingest_column(self, idents: Sequence[RuleIdent], column: Any,
                      source: str = "cached") -> None:
        if not self.enabled or not len(idents):
            return
        col = np.asarray(column).reshape(len(idents), 1)
        self.ingest_counts(idents, class_counts(col), source=source)

    def reset(self) -> None:
        with self._lock:
            self._records.clear()

    # -- read side

    def _snapshot(self) -> List[_RuleRecord]:
        with self._lock:
            return list(self._records.values())

    def rules_tracked(self) -> int:
        with self._lock:
            return len(self._records)

    def rule_rows(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        now = self._clock() if now is None else now
        rows = []
        with self._lock:
            for rec in self._records.values():
                c = rec.counts
                rows.append({
                    "policy": rec.policy_name,
                    "rule": rec.rule_name,
                    "policy_hash": rec.policy_hash,
                    "on_device": rec.on_device,
                    "evals": int(c.sum()),
                    "fired": rec.fired(),
                    "pass": int(c[PASS]),
                    "skip": int(c[SKIP]),
                    "fail": int(c[FAIL]),
                    "not_matched": int(c[NOT_MATCHED]),
                    "error": int(c[ERROR]),
                    "by_source": dict(rec.by_source),
                    "age_s": round(max(0.0, now - rec.first_seen), 3),
                    "last_fired_age_s": (
                        round(max(0.0, now - rec.last_fired), 3)
                        if rec.last_fired is not None else None),
                })
        return rows

    def report(self, top: int = 20, now: Optional[float] = None
               ) -> Dict[str, Any]:
        """The /debug/rules document: top-N hot rules, never-fired
        rules with age, per-policy device coverage."""
        rows = self.rule_rows(now=now)
        hot = sorted((r for r in rows if r["fired"]),
                     key=lambda r: (-r["fired"], r["policy"], r["rule"]))
        never = sorted((r for r in rows if not r["fired"]),
                       key=lambda r: (-r["age_s"], r["policy"], r["rule"]))
        return {
            "rules_tracked": len(rows),
            "top": hot[: max(top, 0)],
            "never_fired": [
                {"policy": r["policy"], "rule": r["rule"],
                 "policy_hash": r["policy_hash"], "age_s": r["age_s"],
                 "on_device": r["on_device"], "evals": r["evals"],
                 **_static_status(r["policy"], r["rule"])}
                for r in never],
            "policies": self.policy_aggregates(),
        }

    def policy_aggregates(self) -> List[Dict[str, Any]]:
        """Per-policy rollup (by display name — the Prometheus label)."""
        agg: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for rec in self._records.values():
                a = agg.setdefault(rec.policy_name, {
                    "policy": rec.policy_name, "rules": 0, "device_rules": 0,
                    "evals": 0, "fired": 0, "fails": 0, "never_fired": 0})
                a["rules"] += 1
                a["device_rules"] += 1 if rec.on_device else 0
                a["evals"] += int(rec.counts.sum())
                fired = rec.fired()
                a["fired"] += fired
                a["fails"] += int(rec.counts[FAIL])
                a["never_fired"] += 0 if fired else 1
        out = []
        pattern_cells = global_pattern_cells.per_policy()
        for a in agg.values():
            a["device_coverage"] = round(
                a["device_rules"] / a["rules"], 4) if a["rules"] else 0.0
            pc = pattern_cells.get(a["policy"])
            if pc:
                # pattern host cells vs other host cells: the pattern
                # block isolates how much host work is pattern-caused
                a["pattern_cells"] = pc
            out.append(a)
        return sorted(out, key=lambda a: (-a["evals"], a["policy"]))

    def render_table(self, top: int = 20,
                     title: str = "per-rule analytics") -> str:
        """Aligned text table (`apply --rule-stats`)."""
        rows = sorted(self.rule_rows(),
                      key=lambda r: (-r["fired"], -r["evals"],
                                     r["policy"], r["rule"]))
        if not rows:
            return f"{title}: no rules tracked"
        table = [("policy/rule", "evals", "pass", "fail", "error", "skip",
                  "fired", "where")]
        for r in rows[: max(top, 0)]:
            table.append((
                f"{r['policy']}/{r['rule']}", str(r["evals"]),
                str(r["pass"]), str(r["fail"]), str(r["error"]),
                str(r["skip"]),
                "never" if not r["fired"] else str(r["fired"]),
                "device" if r["on_device"] else "host"))
        widths = [max(len(row[i]) for row in table)
                  for i in range(len(table[0]))]
        lines = [title]
        for i, row in enumerate(table):
            lines.append("  ".join(c.ljust(w)
                                   for c, w in zip(row, widths)).rstrip())
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
        never = [r for r in rows if not r["fired"]]
        if never:
            lines.append(f"never fired: {len(never)} rule(s): " + ", ".join(
                f"{r['policy']}/{r['rule']}" for r in never[:10]))
        return "\n".join(lines)


global_rule_stats = RuleStatsAccumulator()


class PatternCellTracker:
    """Process-wide accounting of pattern-bearing cells by resolution
    path (tpu/dfa.py ladder): ``device`` — the DFA verdict stood,
    ``confirm`` — an approximate/byte-sensitive hit was confirmed by
    the scalar oracle, ``host`` — a non-lowerable pattern kept the
    whole cell on the host route. Feeds
    kyverno_tpu_pattern_cells_total and the /debug/rules per-policy
    coverage breakdown (pattern host cells vs other host cells)."""

    PATHS = ("device", "confirm", "host")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._per_policy: Dict[str, Dict[str, int]] = {}  # guarded-by: _lock

    def record(self, policy: str, device: int = 0, confirm: int = 0,
               host: int = 0) -> None:
        if not (device or confirm or host):
            return
        with self._lock:
            d = self._per_policy.setdefault(
                policy, {"device": 0, "confirm": 0, "host": 0})
            d["device"] += int(device)
            d["confirm"] += int(confirm)
            d["host"] += int(host)
        try:
            from .metrics import global_registry as reg

            for path, v in (("device", device), ("confirm", confirm),
                            ("host", host)):
                if v:
                    reg.pattern_cells.inc({"path": path}, int(v))
        except Exception:  # noqa: BLE001
            pass  # metrics must never block the verdict path

    def per_policy(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {k: dict(v) for k, v in self._per_policy.items()}

    def totals(self) -> Dict[str, int]:
        out = {p: 0 for p in self.PATHS}
        with self._lock:
            for d in self._per_policy.values():
                for p in self.PATHS:
                    out[p] += d[p]
        return out

    def confirm_rate(self) -> float:
        t = self.totals()
        denom = t["device"] + t["confirm"]
        return round(t["confirm"] / denom, 6) if denom else 0.0

    def state(self) -> Dict[str, Any]:
        return {"totals": self.totals(),
                "confirm_rate": self.confirm_rate(),
                "per_policy": self.per_policy()}

    def reset(self) -> None:
        with self._lock:
            self._per_policy.clear()


global_pattern_cells = PatternCellTracker()


# ---------------------------------------------------------------------------
# cardinality-bounded Prometheus exposition of the rule stats

DEFAULT_RULE_METRICS_TOPK = 20
OVERFLOW_POLICY = "_overflow"


def _env_topk() -> int:
    try:
        return int(os.environ.get("KYVERNO_TPU_RULE_METRICS_TOPK", "")
                   or DEFAULT_RULE_METRICS_TOPK)
    except ValueError:
        return DEFAULT_RULE_METRICS_TOPK


class RuleStatsCollector:
    """Pseudo-instrument rendered at scrape time: per-policy
    ``kyverno_rule_*`` families bounded to K policies; everything else
    collapses into one ``policy="_overflow"`` series — label
    cardinality stays O(K) no matter how many policies churn through
    the process.

    Membership is STICKY: once a policy earns a named series it keeps
    it, and a policy folded into the overflow bucket stays there (until
    the accumulator resets). Counter semantics demand this — if
    membership re-ranked per scrape, a policy crossing the K boundary
    would make both its own series and the overflow series DECREASE,
    which Prometheus reads as a counter reset and turns into spurious
    rate() spikes on exactly the families built for alerting."""

    def __init__(self, accumulator: Optional[RuleStatsAccumulator] = None,
                 top_k: Optional[int] = None):
        self.accumulator = accumulator
        self.top_k = top_k if top_k is not None else _env_topk()
        self._named: set = set()
        self._overflowed: set = set()

    def _acc(self) -> RuleStatsAccumulator:
        return self.accumulator if self.accumulator is not None \
            else global_rule_stats

    def _partition(self, aggs: List[Dict[str, Any]], k: int
                   ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
        """Split into (named, overflow) with sticky membership; free
        named slots go to the highest-volume undecided policies. An
        accumulator reset (fewer policies than we remember) clears the
        memory so tests and restarts start fresh."""
        seen = {a["policy"] for a in aggs}
        if not (self._named | self._overflowed) <= seen:
            self._named = set()
            self._overflowed = set()
        keep, over, undecided = [], [], []
        for a in aggs:  # aggs arrive sorted by eval volume
            if a["policy"] in self._named:
                keep.append(a)
            elif a["policy"] in self._overflowed:
                over.append(a)
            else:
                undecided.append(a)
        for a in undecided:
            if len(keep) < k:
                keep.append(a)
                self._named.add(a["policy"])
            else:
                over.append(a)
                self._overflowed.add(a["policy"])
        return keep, over

    def collect(self) -> List[str]:
        from .metrics import _fmt_labels, _labels_key

        aggs = self._acc().policy_aggregates()
        k = max(int(self.top_k), 0)
        keep, over = self._partition(aggs, k)
        if over:
            folded = {"policy": OVERFLOW_POLICY, "rules": 0,
                      "device_rules": 0, "evals": 0, "fired": 0,
                      "fails": 0, "never_fired": 0}
            for a in over:
                for key in ("rules", "device_rules", "evals", "fired",
                            "fails", "never_fired"):
                    folded[key] += a[key]
            folded["device_coverage"] = round(
                folded["device_rules"] / folded["rules"], 4) \
                if folded["rules"] else 0.0
            keep = keep + [folded]
        fams = (
            ("kyverno_rule_evals_total", "counter",
             "rule evaluations (all verdict classes) by policy", "evals"),
            ("kyverno_rule_fired_total", "counter",
             "rule firings (pass/fail/error verdicts) by policy", "fired"),
            ("kyverno_rule_fail_total", "counter",
             "rule FAIL verdicts by policy", "fails"),
            ("kyverno_rule_never_fired", "gauge",
             "rules that have never fired, by policy", "never_fired"),
            ("kyverno_policy_device_coverage", "gauge",
             "fraction of a policy's rules lowered onto the device",
             "device_coverage"),
        )
        out: List[str] = []
        for name, kind, help_, field in fams:
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {kind}")
            for a in sorted(keep, key=lambda a: a["policy"]):
                labels = _fmt_labels(_labels_key({"policy": a["policy"]}))
                out.append(f"{name}{labels} {float(a[field])}")
        return out


# ---------------------------------------------------------------------------
# device feed-starvation accounting

class StarvationTracker:
    """Rolling-window accounting of device busy vs encode-starved time.
    ``record`` is fed from the serial scan ladder and the pipelined
    scanner per chunk; the gauge is the continuously-updated fraction
    of device-relevant wall time spent waiting on host encode."""

    def __init__(self, window_s: float = 300.0, metrics=None,
                 clock=time.monotonic):
        self.window_s = window_s
        self._clock = clock
        self._metrics = metrics
        self._lock = threading.Lock()
        # (t, busy_s, starved_s) events inside the rolling window, plus
        # running window sums maintained incrementally — record() sits
        # on the per-flush/per-chunk hot path and must not re-walk the
        # whole window per call
        self._events: deque = deque()   # guarded-by: _lock
        self._win_busy = 0.0            # guarded-by: _lock
        self._win_starved = 0.0         # guarded-by: _lock
        self._totals = {"device_busy": 0.0, "encode_wait": 0.0,  # guarded-by: _lock
                        "readback": 0.0, "host_assemble": 0.0}
        self._hooked = False

    def _registry(self):
        if self._metrics is None:
            from .metrics import global_registry

            self._metrics = global_registry
        if not self._hooked:
            self._hooked = True
            try:
                # the ratio decays as the window slides: refresh the
                # gauge at scrape time, not only at record time
                self._metrics.add_collect_hook(self.update_gauge)
            except Exception:
                pass
        return self._metrics

    def _evict_locked(self, now: float) -> None:
        while self._events and self._events[0][0] < now - self.window_s:
            _, busy, starved = self._events.popleft()
            self._win_busy -= busy
            self._win_starved -= starved

    def record(self, busy_s: float = 0.0, starved_s: float = 0.0,
               readback_s: float = 0.0, assemble_s: float = 0.0) -> None:
        now = self._clock()
        with self._lock:
            if busy_s or starved_s:
                self._events.append((now, busy_s, starved_s))
                self._win_busy += busy_s
                self._win_starved += starved_s
            self._evict_locked(now)
            self._totals["device_busy"] += busy_s
            self._totals["encode_wait"] += starved_s
            self._totals["readback"] += readback_s
            self._totals["host_assemble"] += assemble_s
        self.update_gauge()

    def ratio(self, now: Optional[float] = None) -> float:
        """starved / (busy + starved) over the rolling window, in
        [0, 1]; 0.0 with no samples."""
        now = self._clock() if now is None else now
        with self._lock:
            self._evict_locked(now)
            busy, starved = self._win_busy, self._win_starved
        denom = busy + starved
        return round(min(1.0, max(0.0, starved) / denom), 4) \
            if denom > 0 else 0.0

    def update_gauge(self) -> None:
        try:
            self._registry().feed_starvation.set(self.ratio())
        except Exception:
            pass

    def state(self) -> Dict[str, Any]:
        with self._lock:
            totals = {k: round(v, 6) for k, v in self._totals.items()}
            samples = len(self._events)
        return {"ratio": self.ratio(), "window_s": self.window_s,
                "samples": samples, "seconds_total": totals}

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._win_busy = 0.0
            self._win_starved = 0.0
            for k in self._totals:
                self._totals[k] = 0.0


global_starvation = StarvationTracker()


# ---------------------------------------------------------------------------
# SLO burn-rate tracking

class SloConfig:
    """Targets; mutable so `serve` flags can tune the process-global
    tracker before traffic starts."""

    def __init__(self,
                 admission_p99_target_ms: float = 50.0,
                 admission_error_budget: float = 0.01,
                 scan_freshness_target_s: float = 300.0,
                 device_coverage_floor: float = 0.9,
                 windows: Optional[Dict[str, float]] = None):
        self.admission_p99_target_ms = admission_p99_target_ms
        self.admission_error_budget = admission_error_budget
        self.scan_freshness_target_s = scan_freshness_target_s
        self.device_coverage_floor = device_coverage_floor
        # multi-rate: a short window catches fast burns, a long window
        # catches slow leaks (the classic SRE pairing)
        self.windows = dict(windows) if windows else {"5m": 300.0,
                                                      "1h": 3600.0}


class SloTracker:
    """Rolling-window, multi-rate burn-rate tracking for the serving
    SLOs. Burn rate 1.0 = consuming exactly the error budget; >1 means
    the budget runs out before the window does."""

    def __init__(self, config: Optional[SloConfig] = None, metrics=None,
                 clock=time.monotonic, max_samples: int = 65536):
        self.config = config or SloConfig()
        self._clock = clock
        self._metrics = metrics
        self._lock = threading.Lock()
        # (t, latency_s, class) — class is the scheduling priority tier
        # (serving/scheduler.py), "default" for unclassified callers,
        # so the windows split per class without unbounded cardinality
        self._adm: deque = deque(maxlen=max_samples)  # guarded-by: _lock
        # burn-rate cache for the serving shed ladder: submit() reads
        # the burn signal per request, so the read must not walk the
        # whole sample window each time
        self._burn_cache: Tuple[float, float] = (-1e9, 0.0)
        self._last_scan: Optional[float] = None  # guarded-by: _lock
        self._coverage: Optional[float] = None   # guarded-by: _lock
        # verdict-integrity samples: (t, diverged 0/1) per shadow-
        # verification check (observability/verification.py)
        self._verif: deque = deque(maxlen=max_samples)  # guarded-by: _lock
        # lifetime totals for the fleet telemetry plane: unlike the
        # bounded sample windows above these are true monotonic
        # counters, so the leader can merge cross-replica DELTAS
        # (fleet/telemetry.py) without window-alignment drift
        self._totals: Dict[str, int] = {           # guarded-by: _lock
            "admission_requests": 0, "admission_slow": 0, "scan_ticks": 0}
        self._hooked = False

    def _registry(self):
        if self._metrics is None:
            from .metrics import global_registry

            self._metrics = global_registry
        if not self._hooked:
            self._hooked = True
            try:
                self._metrics.add_collect_hook(self.update_gauges)
            except Exception:
                pass
        return self._metrics

    # -- write side

    def record_admission(self, latency_s: float,
                         cls: Optional[str] = None) -> None:
        slow = latency_s > self.config.admission_p99_target_ms / 1000.0
        with self._lock:
            self._adm.append((self._clock(), latency_s, cls or "default"))
            self._totals["admission_requests"] += 1
            if slow:
                self._totals["admission_slow"] += 1

    def admission_burn_fast(self, max_age_s: float = 0.25) -> float:
        """Cached short-window admission burn rate — the signal the
        serving pipeline's burn-driven shed ladder reads per submit().
        Recomputed at most every ``max_age_s``; between refreshes the
        ladder sees a trailing value, which is fine — burn is a
        windowed rate, not an instantaneous one."""
        now = self._clock()
        cached_at, cached = self._burn_cache
        if now - cached_at < max_age_s:
            return cached
        cfg = self.config
        span = min(cfg.windows.values()) if cfg.windows else 300.0
        target_s = cfg.admission_p99_target_ms / 1000.0
        budget = max(cfg.admission_error_budget, 1e-9)
        cutoff = now - span
        n = slow = 0
        with self._lock:
            for t, l, _c in reversed(self._adm):
                if t < cutoff:
                    break
                n += 1
                if l > target_s:
                    slow += 1
        burn = (slow / n) / budget if n else 0.0
        self._burn_cache = (now, burn)
        return burn

    def record_scan(self, coverage: Optional[float] = None,
                    lag_s: float = 0.0) -> None:
        """A scan tick completed. ``lag_s`` sets the freshness clock
        BACK: under a fleet the completed tick may still be serving
        shards whose last real scan happened on a now-dead replica —
        the scan-freshness SLO must age from the oldest owned shard,
        not from the tick that merely took ownership."""
        with self._lock:
            self._last_scan = self._clock() - max(lag_s, 0.0)
            if coverage is not None:
                self._coverage = coverage
            self._totals["scan_ticks"] += 1
        self.update_gauges()

    def set_device_coverage(self, coverage: float) -> None:
        with self._lock:
            self._coverage = coverage
        self.update_gauges()

    def record_verification(self, diverged: bool) -> None:
        """One shadow-verification check: the verdict-integrity SLO's
        error budget is ZERO divergences — any diverged sample in a
        window marks the SLO breached for that window's span."""
        with self._lock:
            self._verif.append((self._clock(), 1 if diverged else 0))
        if diverged:
            self.update_gauges()

    def reset(self) -> None:
        with self._lock:
            self._adm.clear()
            self._last_scan = None
            self._coverage = None
            self._verif.clear()
            self._burn_cache = (-1e9, 0.0)
            self._totals = {"admission_requests": 0, "admission_slow": 0,
                            "scan_ticks": 0}

    # -- fleet telemetry feed (fleet/telemetry.py)

    def telemetry_counters(self) -> Dict[str, int]:
        """Lifetime monotonic totals — the delta-mergeable half of a
        replica's telemetry snapshot."""
        with self._lock:
            return dict(self._totals)

    def telemetry_windows(self, now: Optional[float] = None
                          ) -> Dict[str, Dict[str, int]]:
        """Per-window raw admission/divergence sample counts. These are
        the numbers the leader SUMS across replicas to recompute the
        fleet burn — shipping counts instead of each replica's own burn
        ratio keeps the fleet rollup a weighted merge, not an average
        of averages."""
        now = self._clock() if now is None else now
        target_s = self.config.admission_p99_target_ms / 1000.0
        with self._lock:
            adm = list(self._adm)
            verif = list(self._verif)
        out: Dict[str, Dict[str, int]] = {}
        for name, span in self.config.windows.items():
            lat = [l for (t, l, _c) in adm if t >= now - span]
            out[name] = {
                "requests": len(lat),
                "slow": sum(1 for l in lat if l > target_s),
                "divergences": sum(d for (t, d) in verif
                                   if t >= now - span),
            }
        return out

    # -- read side

    @staticmethod
    def _window_stats(lat: List[float], target_s: float,
                      budget: float) -> Dict[str, Any]:
        n = len(lat)
        slow = sum(1 for l in lat if l > target_s)
        p99 = float(np.percentile(np.asarray(lat), 99)) if lat else 0.0
        burn = (slow / n) / budget if n else 0.0
        return {"requests": n, "slow": slow,
                "p99_ms": round(p99 * 1e3, 3),
                "burn_rate": round(burn, 4)}

    def _admission_windows(self, now: float) -> Dict[str, Dict[str, Any]]:
        cfg = self.config
        target_s = cfg.admission_p99_target_ms / 1000.0
        budget = max(cfg.admission_error_budget, 1e-9)
        with self._lock:
            samples = list(self._adm)
        out: Dict[str, Dict[str, Any]] = {}
        for name, span in cfg.windows.items():
            win = [(l, c) for (t, l, c) in samples if t >= now - span]
            w = self._window_stats([l for l, _ in win], target_s, budget)
            # per-class split (serving scheduling classes): the shed
            # ladder degrades bulk first, and these windows are how an
            # operator verifies the critical class really stayed flat
            by_class: Dict[str, Dict[str, Any]] = {}
            for c in sorted({c for _, c in win}):
                by_class[c] = self._window_stats(
                    [l for l, cc in win if cc == c], target_s, budget)
            w["by_class"] = by_class
            out[name] = w
        return out

    def _verification_windows(self, now: float) -> Dict[str, Dict[str, int]]:
        with self._lock:
            samples = list(self._verif)
        out: Dict[str, Dict[str, int]] = {}
        for name, span in self.config.windows.items():
            win = [d for (t, d) in samples if t >= now - span]
            out[name] = {"checked": len(win), "divergences": sum(win)}
        return out

    def state(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = self._clock() if now is None else now
        cfg = self.config
        adm = self._admission_windows(now)
        verif = self._verification_windows(now)
        with self._lock:
            last_scan, coverage = self._last_scan, self._coverage
        freshness = (now - last_scan) if last_scan is not None else None
        fresh_burn = (freshness / max(cfg.scan_freshness_target_s, 1e-9)
                      if freshness is not None else 0.0)
        cov_ok = coverage is None or coverage >= cfg.device_coverage_floor
        breached = []
        if any(w["burn_rate"] > 1.0 for w in adm.values()):
            breached.append("admission_latency")
        if freshness is not None and fresh_burn > 1.0:
            breached.append("scan_freshness")
        if not cov_ok:
            breached.append("device_coverage")
        if any(w["divergences"] for w in verif.values()):
            # error budget zero: verdicts diverging from the oracle is
            # never acceptable spend
            breached.append("verdict_integrity")
        return {
            "verdict_integrity": {
                "windows": verif,
                "ok": "verdict_integrity" not in breached,
            },
            "admission": {
                "target_p99_ms": cfg.admission_p99_target_ms,
                "error_budget": cfg.admission_error_budget,
                "windows": adm,
            },
            "scan_freshness": {
                "seconds_since_scan": (round(freshness, 3)
                                       if freshness is not None else None),
                "target_s": cfg.scan_freshness_target_s,
                "burn_rate": round(fresh_burn, 4),
            },
            "device_coverage": {
                "ratio": coverage,
                "floor": cfg.device_coverage_floor,
                "ok": cov_ok,
            },
            "breached": breached,
        }

    def update_gauges(self) -> None:
        try:
            reg = self._registry()
            state = self.state()
            self._notify_burns(state["breached"])
            for name, w in state["admission"]["windows"].items():
                reg.slo_admission_p99.set(w["p99_ms"] / 1e3,
                                          {"window": name})
                reg.slo_admission_burn.set(w["burn_rate"], {"window": name})
                for cls, cw in w.get("by_class", {}).items():
                    reg.slo_admission_p99.set(
                        cw["p99_ms"] / 1e3, {"window": name, "class": cls})
                    reg.slo_admission_burn.set(
                        cw["burn_rate"], {"window": name, "class": cls})
            fresh = state["scan_freshness"]
            if fresh["seconds_since_scan"] is not None:
                reg.slo_scan_freshness.set(fresh["seconds_since_scan"])
                reg.slo_scan_freshness_burn.set(fresh["burn_rate"])
            cov = state["device_coverage"]["ratio"]
            if cov is not None:
                reg.slo_device_coverage.set(cov)
            for name, w in state["verdict_integrity"]["windows"].items():
                reg.slo_verification_divergences.set(
                    float(w["divergences"]), {"window": name})
            for slo in ("admission_latency", "scan_freshness",
                        "device_coverage", "verdict_integrity"):
                reg.slo_breached.set(
                    1.0 if slo in state["breached"] else 0.0, {"slo": slo})
        except Exception:
            pass  # SLO bookkeeping must never break a scrape or request

    def _notify_burns(self, breached) -> None:
        """A NEWLY burning SLO is an incident moment: spool the flight
        ring (the last N decisions are the evidence) and emit one
        structured log event. Repeats while the same SLO keeps burning
        stay quiet — the gauges carry the ongoing state."""
        prev = getattr(self, "_last_breached", frozenset())
        cur = frozenset(breached)
        self._last_breached = cur
        new = cur - prev
        if not new:
            return
        try:
            from .flightrecorder import global_flight

            global_flight.on_slo_burn(sorted(new))
        except Exception:
            pass
        try:
            from .log import global_oplog

            global_oplog.emit("slo_burn", level="warn",
                              slos=sorted(new), all_breached=sorted(cur))
        except Exception:
            pass


global_slo = SloTracker()
