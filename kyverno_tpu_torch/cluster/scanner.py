# Copied from kyverno_tpu/cluster/scanner.py, with one addition: beside the
# reference's mesh= the service takes device= (a one-entry mesh; "cpu" for
# the plain path) and passes either to ShardedScanner.
"""Background scan service — the reports-controller hot loop on the card.

Mirror of pkg/controllers/report/background (controller.go:247
needsReconcile / :299 reconcileReport) re-expressed batch-first:

- dirty tracking: a resource needs rescan when its content hash or the
  policy-set revision changed since its last scan (the reference keys
  reports with per-policy resourceVersion labels + a last-scan
  annotation; here one (hash, revision) pair per resource);
- the policy set compiles once per cache revision (compile cache keyed
  by revision — recompilation churn control, SURVEY §7);
- dirty resources batch-encode and evaluate as one device program
  dispatch instead of per-policy sequential engine.Validate calls;
- verdicts land in the ReportAggregator as per-resource results.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ..observability.metrics import MetricsRegistry, global_registry
from ..serving.dispatch import resource_verdicts
from ..tpu.evaluator import ERROR, FAIL, NOT_MATCHED, PASS, SKIP
from .policycache import PolicyCache
from .reports import ReportAggregator, ReportResult
from .snapshot import ClusterSnapshot

_CODE_TO_RESULT = {PASS: "pass", SKIP: "skip", FAIL: "fail", ERROR: "error"}


_INFRA_KINDS = frozenset({
    "ValidatingWebhookConfiguration", "MutatingWebhookConfiguration",
    "ValidatingAdmissionPolicy", "ValidatingAdmissionPolicyBinding",
})


def _is_kyverno_infrastructure(res: Dict[str, Any]) -> bool:
    """Only kyverno's own materialized admission plumbing is excluded
    from scans — keyed by kind AND managed-by label, so user resources
    that happen to carry a managed-by label still background-scan."""
    from .webhookconfig import MANAGED_BY_LABEL

    if res.get("kind") not in _INFRA_KINDS:
        return False
    labels = (res.get("metadata") or {}).get("labels") or {}
    return ("kyverno" in (labels.get(MANAGED_BY_LABEL, ""),
                          labels.get("app.kubernetes.io/managed-by", "")))


class BackgroundScanService:
    def __init__(
        self,
        snapshot: ClusterSnapshot,
        cache: PolicyCache,
        aggregator: Optional[ReportAggregator] = None,
        mesh=None,
        batch_size: int = 4096,
        exceptions=None,
        device=None,
    ) -> None:
        self.snapshot = snapshot
        self.cache = cache
        self.exceptions = exceptions or []
        self.aggregator = aggregator or ReportAggregator()
        self.mesh = mesh
        self.device = device
        self.batch_size = batch_size
        self.metrics = global_registry
        # uid -> (resource hash, policy revision) at last scan
        self._scanned: Dict[str, Tuple[str, int]] = {}  # guarded-by: _lock
        self._dirty: Set[str] = set()                   # guarded-by: _lock
        self._lock = threading.Lock()
        self._scanner = None
        self._scanner_rev = -1
        self._pipeline = None
        self.stats = {"scans": 0, "resources_scanned": 0, "skipped_clean": 0,
                      "verdict_cache_hits": 0, "pipeline_overlap_ratio": 0.0}
        snapshot.subscribe(self._on_change)

    # -- watch plumbing

    def _on_change(self, uid: str, change: str) -> None:
        if change == "delete":
            with self._lock:
                self._scanned.pop(uid, None)
                self._dirty.discard(uid)
            self.aggregator.drop(uid)
            try:
                from .columnar import get_store

                store = get_store()
                if store is not None:
                    store.forget_uid(uid)
            except Exception:
                pass
            # the incremental report store unfolds the deleted
            # resource's rows (and journals the delete) — reports must
            # never fail a watch event
            try:
                from ..reports import get_report_store

                rstore = get_report_store()
                if rstore is not None:
                    rstore.delete(uid)
            except Exception:
                pass
            # a deleted Namespace invalidates members too (the uid no
            # longer resolves, so derive the name from the uid key)
            if '/Namespace:' in uid:
                ns_name = uid.rsplit("/", 1)[-1]
                self._invalidate_namespace(ns_name)
            return
        with self._lock:
            self._dirty.add(uid)
        # namespace label changes invalidate every resource in that
        # namespace (namespaceSelector results can flip without the
        # member resources changing)
        res = self.snapshot.get(uid)
        if res is not None and res.get("kind") == "Namespace":
            self._invalidate_namespace((res.get("metadata") or {}).get("name", ""))

    def _invalidate_namespace(self, ns_name: str) -> None:
        if not ns_name:
            return
        members = [member_uid for member_uid, member, _ in self.snapshot.items()
                   if (member.get("metadata") or {}).get("namespace", "") == ns_name]
        with self._lock:
            self._dirty.update(members)

    def _configmap_sources(self):
        from ..engine.contextloaders import DataSources

        snapshot = self.snapshot

        class _View:
            def get(self, key):
                ns, _, name = key.partition("/")
                for _, res, _ in snapshot.items():
                    meta = res.get("metadata") or {}
                    if (res.get("kind") == "ConfigMap"
                            and meta.get("name") == name
                            and (meta.get("namespace") or "") == ns):
                        return res
                return None

        return DataSources(configmaps=_View())

    def _deps_moved(self) -> bool:
        """Did any configmap folded into the compiled programs change?
        (compile-time context specialization invalidation). Uses the
        snapshot's STORED hashes — no rehash, one items() pass."""
        cps = getattr(self._scanner, "cps", None)
        if cps is None or not cps.context_deps:
            return False
        current: Dict[str, str] = {}
        for _, res, h in self.snapshot.items():
            if res.get("kind") == "ConfigMap":
                meta = res.get("metadata") or {}
                current[f"{meta.get('namespace', '')}/{meta.get('name', '')}"] = h
        return any(current.get(key) != compiled_hash
                   for key, compiled_hash in cps.context_deps.items())

    def _get_scanner(self, revision: int, recompile: bool = False):
        if self._scanner is None or self._scanner_rev != revision or recompile:
            from ..parallel.sharding import ShardedScanner

            _, policies = self.cache.snapshot()
            # neither mesh= nor device=: make_mesh(), every CUDA device
            self._scanner = ShardedScanner(policies, mesh=self.mesh,
                                           device=self.device,
                                           exceptions=self.exceptions,
                                           data_sources=self._configmap_sources())
            self._scanner_rev = revision
            self._pipeline = None  # compiled set changed: new pipeline
        return self._scanner

    def _get_pipeline(self, scanner):
        if self._pipeline is None or self._pipeline.scanner is not scanner:
            from ..tpu.pipeline import PipelinedScanner

            self._pipeline = PipelinedScanner(scanner)
        return self._pipeline

    # -- the scan loop body

    def scan_once(self, full: bool = False) -> int:
        """Scan dirty (or all, when full/revision changed) resources.
        Returns the number of resources evaluated. Under a fleet
        (fleet/manager.py) the keyspace is sharded: this replica scans
        ONLY the shards it owns, and shards just taken over from a
        dead replica force-rescan (the dead owner's reports died with
        it — clean-skip bookkeeping must not hide that)."""
        revision = self.cache.revision
        # ONE dep-movement decision per tick: it drives both the full
        # rescan (stale verdicts) and the recompile, so a configmap
        # change can never recompile without also rescanning
        deps_moved = self._deps_moved()
        if deps_moved:
            full = True
        # ONE ownership snapshot per tick (the fleet heartbeat thread
        # rebalances concurrently; mid-tick changes land next tick)
        fleet = None
        owned = takeover = None
        try:
            from ..fleet import get_fleet, shard_of

            fleet = get_fleet()
        except Exception:
            fleet = None
        if fleet is not None and fleet.active:
            owned = fleet.owned_view()
            # peek, don't drain: a tick that dies mid-scan must retry
            # the takeover (note_scan_tick clears it at completion)
            takeover = fleet.pending_takeover()
        # swap the dirty set FIRST: changes arriving during this scan
        # land in the fresh set and are picked up next pass (no lost
        # invalidations between items() and processing)
        with self._lock:
            dirty, self._dirty = self._dirty, set()
            # one locked snapshot of the scan ledger instead of a
            # lock-free dict read per resource in the loop below (the
            # watch thread mutates _scanned concurrently)
            scanned = dict(self._scanned)
        items = self.snapshot.items()
        todo: List[Tuple[str, Dict[str, Any], str]] = []
        for uid, res, h in items:
            if _is_kyverno_infrastructure(res):
                # kyverno's own materialized objects (webhook configs,
                # generated VAPs) never background-scan — the reference
                # excludes them via the default resourceFilters
                continue
            if owned is not None:
                shard = shard_of(uid, fleet.config.num_shards)
                if shard not in owned:
                    self.stats["skipped_unowned"] = \
                        self.stats.get("skipped_unowned", 0) + 1
                    continue
                if takeover and shard in takeover:
                    todo.append((uid, res, h))
                    continue
            if full or uid in dirty \
                    or scanned.get(uid) != (h, revision):
                todo.append((uid, res, h))
            else:
                self.stats["skipped_clean"] += 1
        if not todo:
            # a clean tick is still a completed scan: freshness resets
            # (fleet: by the oldest owned shard, not unconditionally)
            try:
                from ..observability.analytics import global_slo

                global_slo.record_scan(
                    lag_s=self._fleet_lag(fleet, owned, takeover))
            except Exception:
                pass
            return 0
        import numpy as np

        from ..tpu.cache import global_verdict_cache as vc
        from ..tpu.engine import ScanResult

        scanner = self._get_scanner(revision, recompile=deps_moved)
        ns_labels = self.snapshot.namespace_labels()
        pipe = self._get_pipeline(scanner)
        eng = pipe.engine
        # incremental report store: scan rows fold keyed by (resource
        # sha, policy-set content key) — an unchanged rescan is zero
        # report work, a changed resource touches only its own rows
        rstore = None
        rstore_key = ""
        try:
            from ..reports import get_report_store

            rstore = get_report_store()
            if rstore is not None:
                from ..observability.flightrecorder import policyset_key

                rstore_key = policyset_key(eng)
        except Exception:
            rstore = None

        def report(chunk, result, evaluated: bool = False) -> None:
            """Report rows for one evaluated (or cache-served) chunk —
            in the pipelined path this runs for chunk k-1 while chunk k
            executes on the device. ``evaluated`` marks chunks that
            actually went through the dispatch ladder on THIS thread,
            where the dispatch-path thread-local and the engine's
            confirm flag are trustworthy."""
            for ci, (uid, res, h) in enumerate(chunk):
                meta = res.get("metadata") or {}
                results = []
                # same dispatch helper as the admission pipeline, so
                # scan report rows and serve verdict rows can't drift
                # in rule ordering
                for (pname, rname), code in resource_verdicts(result, ci):
                    if code == NOT_MATCHED:
                        continue
                    status = _CODE_TO_RESULT.get(code, "error")
                    self.metrics.policy_results.inc(
                        {"policy": pname, "status": status})
                    results.append(ReportResult(
                        policy=pname, rule=rname,
                        result=status,
                        resource_kind=res.get("kind", ""),
                        resource_name=meta.get("name", ""),
                        resource_namespace=meta.get("namespace", ""),
                    ))
                self.aggregator.put(uid, results)
                if rstore is not None:
                    try:
                        rstore.apply(
                            uid, h, rstore_key,
                            meta.get("namespace", "") or "",
                            res.get("kind", ""), meta.get("name", ""),
                            [(r.policy, r.rule, r.result) for r in results])
                    except Exception:
                        pass  # reports must never fail a scan tick
                with self._lock:
                    self._scanned[uid] = (h, revision)
            # flight recorder: sampled per-resource records for this
            # chunk (error/fallback/confirm columns always captured) —
            # the scan side of the black box, uniform with admission
            # records so replay and shadow verification treat both
            # identically
            try:
                from ..observability.flightrecorder import global_flight

                fallback = confirm = False
                if evaluated:
                    from ..observability.profiling import (
                        PATH_SCALAR_FALLBACK, last_dispatch_path)

                    fallback = last_dispatch_path() == PATH_SCALAR_FALLBACK
                    confirm = eng.confirm_seen()
                global_flight.record_scan_chunk(
                    chunk, result, engine=eng, ns_labels=ns_labels,
                    revision=revision, fallback=fallback, confirm=confirm)
            except Exception:
                pass

        # verdict cache: content-identical (resource, ns-labels) pairs
        # under the same compiled set serve their columns straight from
        # the LRU — a full rescan of a mostly-unchanged cluster only
        # pays encode + device for what actually moved
        # the snapshot already hashed every resource (its dirty
        # tracking runs on the same canonical sha-16): reuse those
        # hashes instead of re-serializing 100k bodies per tick
        keys = (eng.verdict_cache_keys(
                    [r for (_, r, _) in todo], ns_labels,
                    resource_hashes=[h for (_, _, h) in todo])
                if vc.enabled else None)
        rules = [(e.policy_name, e.rule_name) for e in eng.cps.rules]
        miss: List[Tuple[str, Dict[str, Any], str]] = []
        miss_keys: List[Optional[Tuple]] = []
        hit_entries: List[Tuple[str, Dict[str, Any], str]] = []
        hit_cols: List[Any] = []
        if keys is None:
            if vc.enabled:
                vc.bypass()
            miss = todo
            miss_keys = [None] * len(todo)
        else:
            for entry, key in zip(todo, keys):
                col = (vc.get(key, expect_rows=len(rules))
                       if key is not None else None)
                if col is None:
                    miss.append(entry)
                    miss_keys.append(key)
                else:
                    hit_entries.append(entry)
                    hit_cols.append(col)
        if miss and fleet is not None and fleet.active and keys is not None:
            # fleet cache peering: before paying encode + device for
            # the misses, ask live peers for their columns (one
            # bounded batch fetch; dead peers cost nothing past their
            # breaker). Verified hits are served exactly like local
            # hits — content-addressed keys make a wrong-revision or
            # poisoned peer answer impossible to serve.
            try:
                peer_cols = fleet.fetch_missing(
                    [k for k in miss_keys if k is not None], len(rules))
            except Exception:
                peer_cols = {}
            if peer_cols:
                still: List[Tuple[str, Dict[str, Any], str]] = []
                still_keys: List[Optional[Tuple]] = []
                for entry, key in zip(miss, miss_keys):
                    col = peer_cols.get(key) if key is not None else None
                    if col is None:
                        still.append(entry)
                        still_keys.append(key)
                    else:
                        hit_entries.append(entry)
                        hit_cols.append(col)
                miss, miss_keys = still, still_keys
                self.stats["fleet_peer_hits"] = \
                    self.stats.get("fleet_peer_hits", 0) + len(peer_cols)
        if hit_entries:
            hit_table = np.stack(hit_cols, axis=1)
            report(hit_entries, ScanResult(verdicts=hit_table, rules=rules))
            self.stats["verdict_cache_hits"] += len(hit_entries)
            # cache-served verdicts still count: replay the hit columns
            # into the rule analytics so a warm rescan reports the same
            # per-rule stats as the cold scan that populated the cache
            from ..observability.analytics import global_rule_stats

            global_rule_stats.ingest_table(eng.rule_idents(), hit_table,
                                           source="cached")
            eng.record_pattern_replay(len(hit_entries))
        if miss:
            # columnar feed: diff-encode what actually moved BEFORE
            # chunk assembly — a watch upsert re-encodes only its
            # touched top-level subtrees against the uid's stored
            # segments, so the pipelined encode below is pure gather
            from .columnar import get_store

            store = get_store()
            if store is not None and store.enabled:
                cfg = eng.cps.encode_cfg
                bp, kbp = eng.cps.byte_paths, eng.cps.key_byte_paths
                for uid, res, h in miss:
                    try:
                        store.warm(cfg, bp, kbp, res, h, uid=uid,
                                   subhashes=self.snapshot.subhashes_of(uid))
                    except Exception:
                        break  # store trouble: the encoder still works
            chunks, chunk_keys, chunk_hashes = [], [], []
            for start in range(0, len(miss), self.batch_size):
                chunks.append([r for (_, r, _) in
                               miss[start:start + self.batch_size]])
                chunk_keys.append(miss_keys[start:start + self.batch_size])
                chunk_hashes.append([h for (_, _, h) in
                                     miss[start:start + self.batch_size]])

            reported = set()

            def on_result(idx: int, result) -> None:
                reported.add(idx)
                chunk = miss[idx * self.batch_size:
                             (idx + 1) * self.batch_size]
                self.metrics.batch_size.observe(len(chunk))
                report(chunk, result, evaluated=True)
                if getattr(result, "infra_error", False):
                    return  # ERROR fill-in rows are not content truth
                for ci, key in enumerate(chunk_keys[idx]):
                    if key is not None:
                        vc.put(key, result.verdicts[:, ci])

            # host encode of chunk k+1 and report generation of chunk
            # k-1 both overlap chunk k's device execution
            try:
                pstats = pipe.scan_chunks(chunks, ns_labels,
                                          on_result=on_result,
                                          content_hashes=chunk_hashes)
                self.stats["pipeline_overlap_ratio"] = \
                    pstats["overlap_ratio"]
                # the supervised encode pool (encode/pool.py) feeds the
                # pipeline when configured: surface its health next to
                # the scan numbers (worker churn here is an incident
                # breadcrumb, not just a /metrics curve)
                if "encode_pool" in pstats:
                    self.stats["encode_pool"] = pstats["encode_pool"]
            except Exception:
                # the pipeline's own ladder (quarantine, breaker,
                # scalar completion) should have absorbed this — if it
                # still escapes, unreported chunks get per-rule ERROR
                # verdicts rather than aborting the whole scan loop
                from ..tpu.evaluator import ERROR as _ERR

                for idx, chunk_res in enumerate(chunks):
                    if idx in reported:
                        continue
                    # reported, NOT cached: an infrastructure failure's
                    # ERROR rows must never be served as content truth
                    fill = ScanResult(
                        verdicts=np.full((len(rules), len(chunk_res)),
                                         _ERR, dtype=np.int32),
                        rules=rules)
                    # the flag the cache check reads; the flight
                    # recorder also keys off it (records stay, but
                    # without an engine the verifier won't compare
                    # infra noise against the oracle)
                    fill.infra_error = True
                    report(miss[idx * self.batch_size:
                                (idx + 1) * self.batch_size], fill)
        total = len(todo)
        self.stats["scans"] += 1
        self.stats["resources_scanned"] += total
        self._record_slo(eng, lag_s=self._fleet_lag(fleet, owned, takeover))
        try:
            from .columnar import get_store

            store = get_store()
            if store is not None:
                store.sync()  # persist mmap arenas once per tick
        except Exception:
            pass
        if rstore is not None:
            try:
                rstore.sync()  # compact the report journal if over cap
            except Exception:
                pass
        return total

    @staticmethod
    def _fleet_lag(fleet, owned, takeover=None) -> float:
        """Stamp this tick's covered shards fresh (clearing the
        honored takeover set) and return the fleet freshness lag (0
        outside a fleet): a completed tick covered every owned shard,
        so the lag is nonzero only while a takeover's shards still
        carry the dead owner's stamps."""
        if fleet is None or owned is None or not fleet.active:
            return 0.0
        try:
            return fleet.note_scan_tick(owned, taken=takeover)
        except Exception:
            return 0.0

    def _record_slo(self, eng, lag_s: float = 0.0) -> None:
        """Scan-freshness + device-coverage SLO inputs: every completed
        scan tick stamps the freshness clock (set back by the fleet
        shard lag, so takeover staleness is visible) and republishes
        the active compiled set's device coverage."""
        try:
            from ..observability.analytics import (global_slo,
                                                   global_starvation)

            dev, total_rules = eng.coverage()
            global_slo.record_scan(
                coverage=(dev / total_rules) if total_rules else 1.0,
                lag_s=lag_s)
            self.stats["feed_starvation"] = global_starvation.ratio()
        except Exception:
            pass  # observability must never fail a scan tick

    def run(self, interval_s: float = 30.0, stop=None) -> None:
        """Blocking scan loop (the Run(ctx, workers) equivalent)."""
        while stop is None or not stop.is_set():
            self.scan_once()
            time.sleep(interval_s)
