# Copied from kyverno_tpu/observability/metrics.py (the port's
# kernel_errors counter and mesh_failed gauge added; one comment
# reworded).
"""Metrics — counters/gauges/histograms with Prometheus exposition.

The reference instruments via OpenTelemetry with a Prometheus exporter
(pkg/metrics/metrics.go:132). This registry covers the same instrument
set (kyverno_policy_results_total, kyverno_policy_execution_duration_
seconds, kyverno_admission_requests_total, ...) plus the TPU engine's
own: batch sizes, device dispatch time, compile cache hits. Exposition
is the Prometheus text format served by the admission server or a
standalone endpoint.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    return tuple(sorted((labels or {}).items()))


def _escape(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, and
    newline must be escaped or the line is unscrapeable."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._values: Dict[LabelKey, float] = {}
        # OpenMetrics counter exemplars: the LAST exemplar per series
        # (the verification layer attaches the diverging record's trace
        # id, so an alert on the counter links straight to the trace)
        self._exemplars: Dict[LabelKey, Tuple[LabelKey, float, float]] = {}
        self._lock = threading.Lock()

    def inc(self, labels: Optional[Dict[str, str]] = None, value: float = 1.0,
            exemplar: Optional[Dict[str, str]] = None) -> None:
        k = _labels_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value
            if exemplar:
                self._exemplars[k] = (_labels_key(exemplar), float(value),
                                      time.time())

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        """Programmatic read (tests, bench artifacts) — exposition
        parsing is for scrapers, not assertions."""
        with self._lock:
            return self._values.get(_labels_key(labels), 0.0)

    def series(self) -> List[Tuple[Dict[str, str], float]]:
        """Every labeled series as (labels dict, value) — the
        programmatic enumeration /debug/utilization renders from."""
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._values.items())]

    def remove(self, labels: Optional[Dict[str, str]] = None) -> None:
        """Drop one labeled series. Per-entity families (replica-id
        labels in the fleet layer) call this when the entity leaves so
        label cardinality stays bounded by the LIVE population, not by
        every replica that ever existed."""
        k = _labels_key(labels)
        with self._lock:
            self._values.pop(k, None)
            self._exemplars.pop(k, None)

    def _exemplar_suffix(self, k: LabelKey) -> str:
        ex = self._exemplars.get(k)
        if ex is None:
            return ""
        ex_labels, ex_value, ex_ts = ex
        body = ",".join(f'{lk}="{_escape(lv)}"' for lk, lv in ex_labels)
        return f" # {{{body}}} {ex_value} {round(ex_ts, 3)}"

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for k, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(k)} {v}"
                           + self._exemplar_suffix(k))
        return out


class Gauge(Counter):
    def set(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_labels_key(labels)] = value

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            for k, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(k)} {v}")
        return out


_DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Histogram with OpenMetrics exemplar support: an observation may
    carry exemplar labels (typically ``{"trace_id": ...}``) and the
    bucket it lands in remembers the LAST one — so a slow latency bucket
    links straight back to a concrete trace in ``/debug/traces``."""

    def __init__(self, name: str, help_: str, buckets: Sequence[float] = _DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = list(buckets)
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}
        self._totals: Dict[LabelKey, int] = {}
        # (labelkey, bucket idx) -> (exemplar labels, value, unix ts);
        # idx == len(buckets) is the +Inf bucket
        self._exemplars: Dict[Tuple[LabelKey, int], Tuple[LabelKey, float, float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        k = _labels_key(labels)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            i = bisect.bisect_left(self.buckets, value)
            if i < len(counts):
                counts[i] += 1
            if exemplar:
                self._exemplars[(k, i)] = (
                    _labels_key(exemplar), float(value), time.time())
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1

    def _exemplar_suffix(self, k: LabelKey, i: int) -> str:
        ex = self._exemplars.get((k, i))
        if ex is None:
            return ""
        ex_labels, ex_value, ex_ts = ex
        body = ",".join(f'{lk}="{_escape(lv)}"' for lk, lv in ex_labels)
        return f" # {{{body}}} {ex_value} {round(ex_ts, 3)}"

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for k in sorted(self._counts):
                cum = 0
                for i, (b, c) in enumerate(zip(self.buckets, self._counts[k])):
                    cum += c
                    le = f'le="{b}"'
                    out.append(f"{self.name}_bucket{_fmt_labels(k, le)} {cum}"
                               + self._exemplar_suffix(k, i))
                inf = 'le="+Inf"'
                out.append(
                    f"{self.name}_bucket{_fmt_labels(k, inf)} {self._totals[k]}"
                    + self._exemplar_suffix(k, len(self.buckets)))
                out.append(f"{self.name}_sum{_fmt_labels(k)} {self._sums[k]}")
                out.append(f"{self.name}_count{_fmt_labels(k)} {self._totals[k]}")
        return out


class MetricsRegistry:
    def __init__(self) -> None:
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()
        # the reference's instrument set (pkg/metrics)
        self.policy_results = self.counter(
            "kyverno_policy_results_total", "policy rule results by status")
        self.policy_duration = self.histogram(
            "kyverno_policy_execution_duration_seconds", "per-policy evaluation latency")
        self.admission_requests = self.counter(
            "kyverno_admission_requests_total", "admission requests handled")
        self.admission_duration = self.histogram(
            "kyverno_admission_review_duration_seconds", "admission review latency")
        self.policy_changes = self.counter(
            "kyverno_policy_changes_total", "policy create/update/delete events")
        # TPU engine instruments
        self.batch_size = self.histogram(
            "kyverno_tpu_batch_size", "resources per device dispatch",
            buckets=(1, 8, 32, 128, 512, 2048, 8192, 32768))
        self.device_dispatch = self.histogram(
            "kyverno_tpu_device_dispatch_seconds", "device program wall time")
        self.compile_cache = self.counter(
            "kyverno_tpu_compile_cache_total", "policy-set compiles by outcome")
        # content-addressed result caches (tpu/cache.py): per-resource
        # verdict-column and encode-row lookups by outcome, eviction
        # pressure, and live size — the hit RATE is the amortization
        # signal (a cold rate on a steady cluster means keys churn)
        self.verdict_cache = self.counter(
            "kyverno_tpu_verdict_cache_total",
            "verdict-column cache lookups by outcome (hit/miss/bypass)")
        self.verdict_cache_evictions = self.counter(
            "kyverno_tpu_verdict_cache_evictions_total",
            "verdict-column cache entries evicted at the LRU bound")
        self.verdict_cache_size = self.gauge(
            "kyverno_tpu_verdict_cache_size",
            "verdict-column cache entries currently held")
        self.encode_cache = self.counter(
            "kyverno_tpu_encode_cache_total",
            "encode-row cache lookups by outcome (hit/miss)")
        self.encode_cache_evictions = self.counter(
            "kyverno_tpu_encode_cache_evictions_total",
            "encode-row cache entries evicted at the LRU bound")
        # columnar resource store (cluster/columnar.py): encoded rows —
        # not JSON — are the system of record between watch event and
        # device batch. The walk counter is the feed-work gate metric:
        # an unchanged-resource rescan with the store warm must move
        # NEITHER the full-walk nor the diff-segment counter
        # (scripts_columnar_gate.sh asserts exactly that).
        self.encode_json_walks = self.counter(
            "kyverno_tpu_encode_json_walks_total",
            "full JSON flatten walks performed by the row encoders "
            "(pad resources excluded)")
        self.encode_diff_segments = self.counter(
            "kyverno_tpu_encode_diff_segments_total",
            "top-level subtree segment encodes on the incremental "
            "watch-diff path")
        self.columnar_store = self.counter(
            "kyverno_tpu_columnar_store_total",
            "columnar row-store lookups by outcome (hit/miss)")
        self.columnar_segments_reused = self.counter(
            "kyverno_tpu_columnar_segments_reused_total",
            "unchanged top-level subtrees spliced from stored segments "
            "instead of re-encoded during a watch-diff encode")
        self.columnar_gather_rows = self.counter(
            "kyverno_tpu_columnar_gather_rows_total",
            "encoded rows assembled into device batches by vectorized "
            "per-lane gather from the columnar store")
        self.columnar_store_entries = self.gauge(
            "kyverno_tpu_columnar_store_entries",
            "live encoded-resource entries across all columnar tables")
        self.columnar_store_rows = self.gauge(
            "kyverno_tpu_columnar_store_rows",
            "encoded lane rows resident in the columnar store arenas "
            "(live + not-yet-compacted dead)")
        self.columnar_store_bytes = self.gauge(
            "kyverno_tpu_columnar_store_bytes",
            "bytes held by the columnar store arenas (or mapped from "
            "disk when mmap-backed)")
        self.columnar_rebuilds = self.counter(
            "kyverno_tpu_columnar_rebuilds_total",
            "columnar mmap tables discarded at load (truncated/corrupt/"
            "mismatched) and rebuilt empty")
        self.columnar_compactions = self.counter(
            "kyverno_tpu_columnar_compactions_total",
            "columnar arena compactions reclaiming dead rows")
        # incremental report store (reports/store.py): delta folds over
        # verdict columns, journaled for crash consistency — the skip
        # counter is the zero-work proof for unchanged rescans, the
        # recovery counter labels every journal/snapshot degradation
        self.reports_resources = self.gauge(
            "kyverno_reports_resources",
            "resources with report rows held in the incremental store")
        self.reports_fold_ops = self.counter(
            "kyverno_reports_fold_ops_total",
            "report deltas folded (journal append + count update)")
        self.reports_fold_skipped = self.counter(
            "kyverno_reports_fold_skipped_total",
            "report upserts skipped as zero-work: (resource sha, "
            "policy-set key) unchanged since the last fold")
        self.reports_journal_records = self.counter(
            "kyverno_reports_journal_records_total",
            "delta records appended to the report journal")
        self.reports_journal_bytes = self.gauge(
            "kyverno_reports_journal_bytes",
            "current report journal size (resets at each compacted "
            "snapshot)")
        self.reports_snapshots = self.counter(
            "kyverno_reports_snapshots_total",
            "compacted report snapshots written (journal resets)")
        self.reports_recoveries = self.counter(
            "kyverno_reports_recoveries_total",
            "report store recovery/degradation events by reason "
            "(short_header/truncated_record/checksum/decode/duplicate/"
            "snapshot/replay/append_error)")
        self.reports_rebuilds = self.counter(
            "kyverno_reports_rebuilds_total",
            "from-scratch derived-count rebuilds (the delta-fold "
            "bit-identity oracle, also the mid-fold failure fallback)")
        # device-side string matching (tpu/dfa.py): pattern-bearing
        # cells by resolution path — device (DFA verdict stood),
        # confirm (approximate/byte-sensitive hit confirmed by the
        # scalar oracle), host (non-lowerable pattern) — plus the
        # compiled bank's size gauges (set at policy-set compile)
        self.pattern_cells = self.counter(
            "kyverno_tpu_pattern_cells_total",
            "pattern-bearing (rule, resource) cells by resolution path "
            "(device/confirm/host)")
        self.dfa_tables = self.gauge(
            "kyverno_tpu_dfa_tables",
            "compiled DFA pattern tables in the active policy set's bank")
        self.dfa_states = self.gauge(
            "kyverno_tpu_dfa_states",
            "total DFA states across the active bank's tables")
        self.dfa_bytes = self.gauge(
            "kyverno_tpu_dfa_table_bytes",
            "packed size of the active DFA bank's device arrays "
            "(stride-1 tables plus multi-stride tables)")
        # multi-stride + approximate-reduction pattern engine
        # (tpu/dfa.py): stride selection, reduction outcomes and the
        # CONFIRM traffic the approximations cost
        self.dfa_stride_tables = self.gauge(
            "kyverno_dfa_stride_tables",
            "active bank's pattern tables by chosen transition stride")
        self.dfa_stride_bytes = self.gauge(
            "kyverno_dfa_stride_table_bytes",
            "packed size of the active bank's stride>1 transition tables")
        self.dfa_approx_states_merged = self.gauge(
            "kyverno_dfa_approx_states_merged",
            "exact DFA states folded away by minimization / k-lookahead "
            "reduction across the active bank")
        self.dfa_approx_error_max = self.gauge(
            "kyverno_dfa_approx_error_max",
            "largest sampled over-approximation error among the active "
            "bank's reduced patterns (0-1)")
        self.dfa_top_collapse = self.counter(
            "kyverno_dfa_top_collapse_total",
            "patterns that fell back to accept-all TOP-collapse at "
            "compile, by reason (error_ceiling / approx_disabled / "
            "explore_overflow)")
        self.dfa_confirm_cells = self.counter(
            "kyverno_dfa_confirm_cells_total",
            "device pattern cells escalated to scalar-oracle CONFIRM "
            "(the price of over-approximated tables)")
        # pipelined scan (tpu/pipeline.py): how much host work hid
        # behind device time in the last pipelined scan (0 = strictly
        # serial, higher = more overlap), plus chunk accounting
        self.pipeline_overlap = self.gauge(
            "kyverno_tpu_pipeline_overlap_ratio",
            "(encode+device+host seconds - wall) / wall of the last "
            "pipelined scan")
        self.pipeline_chunks = self.counter(
            "kyverno_tpu_pipeline_chunks_total",
            "pipelined scan chunks by how they resolved")
        # policy observatory (observability/analytics.py): device feed
        # starvation — the fraction of device-relevant wall time the
        # accelerator sat idle waiting on host encode (rolling window;
        # the headline metric for the encode-pool roadmap item) — plus
        # continuously-incremented utilization attribution per phase
        self.feed_starvation = self.gauge(
            "kyverno_tpu_feed_starvation_ratio",
            "fraction of device-relevant wall time the device was idle "
            "waiting on host encode (rolling window, 0-1)")
        self.utilization_seconds = self.counter(
            "kyverno_tpu_utilization_seconds_total",
            "scan-ladder wall seconds by phase "
            "(encode_wait/device_busy/readback/host_assemble)")
        self.serving_flusher_seconds = self.counter(
            "kyverno_serving_flusher_seconds_total",
            "admission flusher wall seconds by state "
            "(wait_queue/evaluate/resolve/request_queue_wait)")
        # encoder pool (encode/pool.py): the supervised multiprocess
        # device feed — worker population and churn, dispatch queue
        # pressure, and per-chunk outcomes across the whole ladder
        # (ok / retried_ok / poison / encode_error / infra_fail /
        # bypass)
        self.encode_pool_workers = self.gauge(
            "kyverno_encode_pool_workers_alive",
            "encoder-pool worker processes alive and ready")
        self.encode_pool_restarts = self.counter(
            "kyverno_encode_pool_restarts_total",
            "encoder-pool workers restarted after a crash, hang, or "
            "silent heartbeat")
        self.encode_pool_queue_depth = self.gauge(
            "kyverno_encode_pool_queue_depth",
            "encode chunks queued or in flight on pool workers")
        self.encode_pool_chunks = self.counter(
            "kyverno_encode_pool_chunks_total",
            "encode chunks dispatched to the pool by outcome")
        # SLO layer (observability/analytics.py SloTracker): rolling-
        # window multi-rate burn-rate gauges; state also rides /readyz
        self.slo_admission_p99 = self.gauge(
            "kyverno_slo_admission_latency_p99_seconds",
            "admission p99 latency over the rolling window, by window")
        self.slo_admission_burn = self.gauge(
            "kyverno_slo_admission_burn_rate",
            "admission latency error-budget burn rate (1.0 = burning "
            "exactly the budget), by window")
        self.slo_scan_freshness = self.gauge(
            "kyverno_slo_scan_freshness_seconds",
            "seconds since the last completed background scan")
        self.slo_scan_freshness_burn = self.gauge(
            "kyverno_slo_scan_freshness_burn_rate",
            "scan freshness / target (>1 = scans running stale)")
        self.slo_device_coverage = self.gauge(
            "kyverno_slo_device_coverage_ratio",
            "fraction of compiled rules running on the device path")
        self.slo_breached = self.gauge(
            "kyverno_slo_breached",
            "1 when the named SLO is currently burning past budget")
        # flight recorder (observability/flightrecorder.py): the black
        # box over the admission/scan ladder — captured records by
        # outcome, head-sampling drops, ring occupancy, auto-spools
        self.flight_records = self.counter(
            "kyverno_flight_records_total",
            "flight-recorder records captured, by outcome "
            "(ok/error/fallback/shed/confirm/cached/expired)")
        self.flight_sampled_out = self.counter(
            "kyverno_flight_sampled_out_total",
            "decisions not recorded because head-based sampling "
            "dropped them (interesting outcomes are never dropped)")
        self.flight_ring_size = self.gauge(
            "kyverno_flight_ring_records",
            "flight-recorder records currently held in the ring")
        self.flight_spools = self.counter(
            "kyverno_flight_spools_total",
            "flight-recorder ring spools to --flight-dir, by reason")
        self.flight_spool_dropped = self.counter(
            "kyverno_flight_spool_dropped_total",
            "spool segments deleted by size-capped rotation, by kind "
            "(segment = oldest flight-*.ndjson beyond the keep window, "
            "divergence = rotated-out divergences.ndjson segment)")
        # continuous shadow verification (observability/verification.py):
        # sampled oracle re-evaluation of recorded decisions — check
        # outcomes, bit-exact divergences (exemplar = originating trace
        # id), and audit-queue pressure
        self.verification_checks = self.counter(
            "kyverno_verification_checks_total",
            "shadow-verification checks by result (match/diverge/error/"
            "skipped_no_engine/skipped_impure/skipped_overflow)")
        self.verification_divergence = self.counter(
            "kyverno_verification_divergence_total",
            "recorded verdicts that did NOT match the scalar oracle at "
            "the pinned revision — the bit-identity claim failing")
        self.verification_queue_depth = self.gauge(
            "kyverno_verification_queue_depth",
            "flight records queued for shadow verification")
        self.slo_verification_divergences = self.gauge(
            "kyverno_slo_verification_divergences",
            "verdict-integrity SLO: shadow-verification divergences in "
            "the rolling window, by window (target: 0)")
        # policy-set static analysis (analysis/): witness-synthesis +
        # cross-product anomaly detection — lint run outcomes, the last
        # completed report's anomaly counts by kind, corpus size, and
        # the per-phase wall split (synthesize/evaluate/classify/
        # confirm) so a slow lint is attributable at a glance
        self.analysis_runs = self.counter(
            "kyverno_analysis_runs_total",
            "static-analysis runs by outcome (ok/aborted/error)")
        self.analysis_anomalies = self.gauge(
            "kyverno_analysis_anomalies",
            "confirmed anomalies in the last completed analysis, by "
            "kind (shadow/conflict/redundant/dead)")
        self.analysis_witnesses = self.gauge(
            "kyverno_analysis_witnesses",
            "synthesized witness resources evaluated by the last "
            "completed analysis")
        self.analysis_wall_seconds = self.gauge(
            "kyverno_analysis_wall_seconds",
            "wall seconds of the last completed analysis, by phase "
            "(synthesize/evaluate/classify/confirm)")
        # serving pipeline instruments (serving/batcher.py): queue
        # depth, batch occupancy, flush reasons, shed/expiry counters,
        # and submit-to-verdict latency (p50-p99 read from buckets)
        self.serving_queue_depth = self.gauge(
            "kyverno_serving_queue_depth",
            "admission requests waiting in the batching queue")
        self.serving_batch_size = self.histogram(
            "kyverno_serving_batch_size",
            "live requests per batched device dispatch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self.serving_batch_occupancy = self.histogram(
            "kyverno_serving_batch_occupancy",
            "live requests / padded bucket capacity per flush",
            buckets=(0.125, 0.25, 0.5, 0.75, 0.9, 1.0))
        self.serving_flush_total = self.counter(
            "kyverno_serving_flush_total", "batch flushes by trigger reason")
        self.serving_shed_total = self.counter(
            "kyverno_serving_shed_total",
            "requests shed at the queue high-water mark by outcome")
        self.serving_deadline_expired_total = self.counter(
            "kyverno_serving_deadline_expired_total",
            "requests whose deadline expired while queued")
        self.serving_request_latency = self.histogram(
            "kyverno_serving_request_latency_seconds",
            "admission submit-to-verdict latency")
        # admission scheduling (serving/scheduler.py + queue.py): the
        # per-class view of the pipeline — queue pressure by priority
        # tier, request resolutions by class and path, and the hedged
        # scalar-vs-device races by winner. The class label is the
        # PRIORITY TIER (critical/default/bulk), never the tenant —
        # tenant-level fairness stays internal so label cardinality is
        # bounded at three no matter how many namespaces submit
        self.serving_class_queue_depth = self.gauge(
            "kyverno_serving_class_queue_depth",
            "admission requests waiting in the batching queue, by "
            "priority class")
        self.serving_class_requests = self.counter(
            "kyverno_serving_class_requests_total",
            "admission requests by priority class and resolution "
            "outcome (batched/cached/hedged/shed/expired)")
        self.serving_hedge = self.counter(
            "kyverno_serving_hedge_total",
            "hedged scalar dispatches racing an in-flight device batch, "
            "by winner (scalar/device/device_error/expired/error)")
        # fleet layer (fleet/): multi-replica membership, rendezvous
        # shard ownership, and cache peering. Peer labels are replica
        # ids — cardinality is bounded by the (small, operator-
        # configured) fleet size, so per-peer families are safe here
        # where per-tenant ones would not be
        self.fleet_replicas = self.gauge(
            "kyverno_fleet_replicas",
            "live replicas in this replica's membership view "
            "(self included)")
        self.fleet_is_leader = self.gauge(
            "kyverno_fleet_is_leader",
            "1 when this replica is the fleet leader (lowest live id)")
        self.fleet_epoch = self.gauge(
            "kyverno_fleet_epoch",
            "membership-change epoch the current shard map was "
            "computed at")
        self.fleet_shards_owned = self.gauge(
            "kyverno_fleet_shards_owned",
            "resource-keyspace shards this replica currently owns")
        self.fleet_shard_reassignments = self.counter(
            "kyverno_fleet_shard_reassignments_total",
            "shards that moved INTO this replica's ownership, by "
            "reason (initial/membership)")
        self.fleet_shard_staleness = self.gauge(
            "kyverno_fleet_shard_staleness_seconds",
            "seconds by which the oldest owned shard trails the last "
            "scan tick (takeover shards inherit the dead owner's last "
            "gossiped stamp until rescanned)")
        self.fleet_heartbeats = self.counter(
            "kyverno_fleet_heartbeats_total",
            "outbound membership heartbeats by peer and outcome")
        self.fleet_peer_fetch = self.counter(
            "kyverno_fleet_peer_fetch_total",
            "verdict-cache peer fetch keys by peer and outcome "
            "(hit/miss/error/rejected)")
        self.fleet_peer_rejects = self.counter(
            "kyverno_fleet_peer_rejects_total",
            "peer cache entries rejected at receive verification by "
            "reason (checksum/key_mismatch/shape/decode) — every "
            "reject is served as a miss, never a wrong verdict")
        self.fleet_gossip = self.counter(
            "kyverno_fleet_gossip_total",
            "async verdict-column gossip by outcome "
            "(sent/received/error/dropped)")
        # fleet telemetry plane (fleet/telemetry.py): the leader pulls
        # checksummed per-replica snapshots on the heartbeat cadence
        # and folds counter DELTAS into the kyverno_fleet_agg_*
        # families — a restarted replica resetting to zero can never
        # drive an aggregate backwards, and a snapshot failing the
        # trust ladder is dropped and counted, never merged wrong.
        # Replica labels are bounded by the operator-configured fleet
        # size (the fleet gauges' rule) and pruned when a replica leaves
        self.fleet_telemetry_pulls = self.counter(
            "kyverno_fleet_telemetry_pulls_total",
            "leader-side telemetry snapshot pulls by peer and outcome "
            "(ok/rejected/error)")
        self.fleet_telemetry_rejects = self.counter(
            "kyverno_fleet_telemetry_rejects_total",
            "telemetry snapshots dropped at the aggregation trust "
            "ladder by reason (checksum/schema_version/stale_seq/"
            "epoch/stale/decode) — a rejected snapshot is never "
            "merged wrong")
        self.fleet_agg_admissions = self.counter(
            "kyverno_fleet_agg_admission_requests_total",
            "fleet-wide admission requests folded from per-replica "
            "telemetry counter deltas (leader-maintained)")
        self.fleet_agg_admission_slow = self.counter(
            "kyverno_fleet_agg_admission_slow_total",
            "fleet-wide admissions slower than the p99 target, folded "
            "from per-replica telemetry counter deltas")
        self.fleet_agg_scan_ticks = self.counter(
            "kyverno_fleet_agg_scan_ticks_total",
            "fleet-wide background scan ticks folded from per-replica "
            "telemetry counter deltas")
        self.fleet_agg_verification_checked = self.counter(
            "kyverno_fleet_agg_verification_checked_total",
            "fleet-wide shadow-verification checks folded from "
            "per-replica telemetry counter deltas")
        self.fleet_agg_divergence = self.counter(
            "kyverno_fleet_agg_divergence_total",
            "fleet-wide shadow-verification divergences folded from "
            "per-replica telemetry counter deltas — nonzero flips the "
            "fleet-degraded advisory bit")
        self.fleet_agg_burn = self.gauge(
            "kyverno_fleet_agg_admission_burn_rate",
            "fleet-wide admission SLO burn computed over the merged "
            "per-replica window samples, by window")
        self.fleet_agg_replicas_reporting = self.gauge(
            "kyverno_fleet_agg_replicas_reporting",
            "replicas with a fresh accepted telemetry snapshot in the "
            "leader's aggregation view")
        self.fleet_agg_snapshot_age = self.gauge(
            "kyverno_fleet_agg_snapshot_age_seconds",
            "age of the last accepted telemetry snapshot by replica "
            "(series pruned when a replica leaves the live set)")
        self.fleet_agg_degraded = self.gauge(
            "kyverno_fleet_agg_degraded",
            "1 when the fleet-aggregated divergence total is nonzero "
            "(the advisory fleet-degraded bit /readyz surfaces)")
        # batched mutation (mutation/): device triage over the compiled
        # mutate bank, patch application by source, degradation-ladder
        # fallbacks, and shadow-verification divergence — the mutate
        # mirror of the validate serving instruments
        self.mutate_triage = self.counter(
            "kyverno_mutate_triage_total",
            "needs-mutation triage batches by outcome "
            "(device/fallback/cached)")
        self.mutate_triage_rows = self.counter(
            "kyverno_mutate_triage_rows_total",
            "triage (rule, resource) cells by result "
            "(positive/negative/host)")
        self.mutate_patches = self.counter(
            "kyverno_mutate_patches_total",
            "mutate patch applications by source (template/scalar)")
        self.mutate_patch_fallbacks = self.counter(
            "kyverno_mutate_patch_fallbacks_total",
            "template-stamp passes degraded to the scalar patcher")
        self.mutate_divergence = self.counter(
            "kyverno_mutate_divergence_total",
            "shadow-verified mutate records whose patched output "
            "differed from the scalar oracle's")
        self.mutate_duration = self.histogram(
            "kyverno_mutate_duration_seconds",
            "batched mutate handling latency (triage + patch)")
        # resilience layer (resilience/): breaker state machine, scalar
        # fallback routing, retry outcomes, injected faults
        self.breaker_state = self.gauge(
            "kyverno_tpu_breaker_state",
            "circuit breaker state (0 closed, 1 open, 2 half-open)")
        self.breaker_transitions = self.counter(
            "kyverno_tpu_breaker_transitions_total",
            "circuit breaker state transitions")
        self.breaker_fallback = self.counter(
            "kyverno_tpu_breaker_fallback_total",
            "batches completed by the scalar oracle instead of the device")
        # the port's own kernels: a build, load, launch or CUDA-graph
        # capture failure is raised to the caller, never answered
        # all-HOST (tpu/engine.py:guarded_dispatch)
        self.kernel_errors = self.counter(
            "kyverno_tpu_kernel_errors_total",
            "kernel build, load, launch or graph-capture failures raised "
            "to the caller")
        # a mesh across processes whose process group failed (a peer
        # that never joined a collective within the timeout): its scans
        # answer through the scalar engine until the process restarts
        # (parallel/sharding.py)
        self.mesh_failed = self.gauge(
            "kyverno_tpu_mesh_failed",
            "1 when this process's cross-process mesh has failed")
        self.retry_attempts = self.counter(
            "kyverno_resilience_retry_total",
            "retried call outcomes by site (recovered counts extra attempts)")
        self.faults_injected = self.counter(
            "kyverno_resilience_faults_injected_total",
            "injected faults fired by site and mode")
        # degraded-storage ladder (resilience/storage.py): OS-level I/O
        # errors per durability surface, which surfaces are currently
        # running in their memory mode, and completed heals — a full
        # disk must be an alert with a bounded blast radius, never a
        # crash or a wrong verdict
        self.storage_errors = self.counter(
            "kyverno_storage_errors_total",
            "storage I/O errors by durability surface and error kind")
        self.storage_degraded = self.gauge(
            "kyverno_storage_degraded",
            "1 while a durability surface runs degraded (memory mode)")
        self.storage_heals = self.counter(
            "kyverno_storage_heals_total",
            "degraded->ok heals per durability surface")
        # policy-set lifecycle (lifecycle/manager.py): the served
        # compiled revision, hot-swap promotions, compile-ahead
        # failures, and the quarantine population — a policy churn
        # problem must be an alert, not a latency mystery
        self.policyset_revision = self.gauge(
            "kyverno_policyset_revision",
            "policy-set revision of the active compiled version")
        self.policyset_swaps = self.counter(
            "kyverno_policyset_swaps_total",
            "compiled policy-set versions promoted (atomic hot swaps)")
        self.policyset_compile_failures = self.counter(
            "kyverno_policyset_compile_failures_total",
            "compile-ahead failures by kind (set-level rollbacks)")
        self.policyset_quarantined = self.gauge(
            "kyverno_policyset_quarantined",
            "policies currently quarantined off the device path")
        # scan_stream phase split (SURVEY §5: encode/device/host costs)
        self.scan_encode_seconds = self.histogram(
            "kyverno_tpu_scan_encode_seconds", "host encode time per scan")
        self.scan_device_seconds = self.histogram(
            "kyverno_tpu_scan_device_seconds", "device wall time per scan")
        self.scan_host_seconds = self.histogram(
            "kyverno_tpu_scan_host_seconds", "host completion time per scan")
        # event generator accounting (observability/events.py): drops
        # are an overload signal that must be scrapeable, not an
        # attribute on a Python object nobody reads
        self.events_emitted = self.counter(
            "kyverno_events_emitted_total",
            "policy events delivered to the sink")
        self.events_dropped = self.counter(
            "kyverno_events_dropped_total",
            "policy events dropped on queue overflow")
        # per-rule analytics exposition: a scrape-time pseudo-instrument
        # rendering kyverno_rule_* / kyverno_policy_device_coverage with
        # bounded label cardinality (top-K policies + one _overflow
        # series). Lazy import: analytics must stay importable first.
        from .analytics import RuleStatsCollector

        self.rule_stats = RuleStatsCollector()
        self._instruments["kyverno_rule_stats"] = self.rule_stats
        # pre-collect hooks: window-decaying gauges (SLO burn rates,
        # starvation ratio) refresh here so a scrape between records
        # still sees live values
        self._collect_hooks: List[Any] = []

    def add_collect_hook(self, fn) -> None:
        with self._lock:
            if fn not in self._collect_hooks:
                self._collect_hooks.append(fn)

    def counter(self, name: str, help_: str) -> Counter:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = Counter(name, help_)
                self._instruments[name] = inst
            return inst  # type: ignore[return-value]

    def gauge(self, name: str, help_: str) -> Gauge:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = Gauge(name, help_)
                self._instruments[name] = inst
            return inst  # type: ignore[return-value]

    def histogram(self, name: str, help_: str, buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = Histogram(name, help_, buckets)
                self._instruments[name] = inst
            return inst  # type: ignore[return-value]

    # exemplars are an OpenMetrics construct: a scraper that negotiates
    # the plain text format would reject the mid-line '#'. The HTTP
    # surfaces serve this content type (and the terminator below) so
    # the right parser is selected; exposition() itself stays a plain
    # string for tests and programmatic readers.
    OPENMETRICS_CONTENT_TYPE = \
        "application/openmetrics-text; version=1.0.0; charset=utf-8"

    def exposition(self) -> str:
        lines: List[str] = []
        with self._lock:
            insts = list(self._instruments.values())
            hooks = list(getattr(self, "_collect_hooks", ()))
        for hook in hooks:
            try:
                hook()
            except Exception:
                pass  # a broken hook must not break the scrape
        for inst in insts:
            lines.extend(inst.collect())  # type: ignore[attr-defined]
        return "\n".join(lines) + "\n"

    def http_body(self) -> "Tuple[bytes, str]":
        """(body, content-type) for a /metrics endpoint: OpenMetrics
        framing — exposition plus the mandatory '# EOF' terminator."""
        return (self.exposition() + "# EOF\n").encode(), \
            self.OPENMETRICS_CONTENT_TYPE


global_registry = MetricsRegistry()
