# Copied from kyverno_tpu/webhooks/server.py. The device engine is
# TorchEngine: Handlers and build_handlers take device= and pass it to
# every engine they build; the compile-ahead warm captures the smallest
# bucket's CUDA graph; /debug/xla/start|stop drive torch.profiler.
"""Admission HTTPS server (pkg/webhooks/server.go equivalent).

Routes: /validate, /mutate, /health/liveness, /health/readiness.
AdmissionReview v1 decode/encode mirrors handlers/admission.go; the
validate path micro-batches concurrent requests into one device
dispatch on the card (see batcher.py); mutate runs the host strategic-merge engine
and returns an RFC 6902 patch. failurePolicy is honored per request
path suffix (/validate/ignore vs /validate/fail, server.go:296).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import time

from ..api.policy import ClusterPolicy
from ..cluster.policycache import PolicyCache, PolicyType
from ..config import Configuration, Toggles
from ..lifecycle import (PolicySetLifecycleManager, PolicySetUnavailable,
                         PolicySetVersion)
from ..observability.metrics import MetricsRegistry, global_registry
from ..cluster.reports import ReportAggregator, ReportResult
from ..cluster.snapshot import ClusterSnapshot, resource_uid
from ..engine.engine import Engine as ScalarEngine
from ..engine.match import RequestInfo
from ..serving import (AdmissionPipeline, BatchConfig, ClassifyConfig,
                       DeadlineExceededError, QueueFullError,
                       classify_request, resource_verdicts)
from ..tpu.engine import (TorchEngine, VERDICT_NAMES, _scalar_rule_verdicts,
                          build_scan_context)
from ..tpu.evaluator import ERROR, FAIL, HOST, NOT_MATCHED
from ..utils.jsonpatch import diff as jsonpatch_diff
from .batcher import MicroBatcher


class VerdictRows(list):
    """Per-request verdict rows [((policy, rule), code)] tagged with
    the compiled policy-set version that produced them. The tag is how
    batch pinning becomes ASSERTABLE: a churn test can check each
    response against the scalar oracle evaluated at the exact revision
    that served it, and validate() derives its Enforce set from the
    same version instead of racing the live cache."""

    def __init__(self, rows, version: Optional[PolicySetVersion] = None,
                 revision: int = -1):
        super().__init__(rows)
        self.version = version
        self.revision = version.revision if version is not None else revision


class AdmissionPayload:
    __slots__ = ("resource", "operation", "info", "namespace", "old",
                 "dry_run")

    def __init__(self, resource, operation, info, namespace, old=None,
                 dry_run=False):
        self.resource = resource
        self.operation = operation
        self.info = info
        self.namespace = namespace
        self.old = old
        # AdmissionReview.request.dryRun: rescan storms replay with
        # dryRun=true, so the scheduler classifies them into the bulk
        # tier (serving/scheduler.py)
        self.dry_run = dry_run


class Handlers:
    """Validate/mutate admission logic shared by server and tests."""

    def __init__(
        self,
        cache: PolicyCache,
        snapshot: Optional[ClusterSnapshot] = None,
        aggregator: Optional[ReportAggregator] = None,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        configuration: Optional[Configuration] = None,
        toggles: Optional[Toggles] = None,
        metrics: Optional[MetricsRegistry] = None,
        registry_client=None,
        iv_cache=None,
        exceptions=None,
        batching: bool = False,
        batch_config: Optional[BatchConfig] = None,
        request_timeout_s: float = 10.0,
        classify_config: Optional[ClassifyConfig] = None,
        mutate_batching: bool = False,
        device=None,
    ) -> None:
        self.cache = cache
        # every engine these handlers compile runs on this device: the
        # card unless the caller asks for "cpu" (tests)
        self.device = device
        self.snapshot = snapshot
        self.aggregator = aggregator
        self.configuration = configuration
        self.toggles = toggles or Toggles()
        self.metrics = metrics or global_registry
        self.registry_client = registry_client
        if iv_cache is None:
            from ..images import ImageVerifyCache
            iv_cache = ImageVerifyCache()
        self.iv_cache = iv_cache
        self.exceptions = exceptions or []
        # per-request time budget (the reference webhook's 10 s
        # timeoutSeconds): propagated into the serving pipeline's queue
        # deadline so an overrun resolves per failurePolicy, not a 500
        self.request_timeout_s = request_timeout_s
        self.scalar = ScalarEngine(exceptions=self.exceptions)
        self._rbac_needed: Dict[int, bool] = {}  # per cache revision
        self._lock = threading.Lock()
        # flight-record support: the flusher stashes its flush's
        # namespace-labels map here so per-record capture never pays
        # another O(snapshot) walk (incident paths capture EVERY
        # record — the walk would run per request exactly when the
        # system is degraded)
        self._flight_tls = threading.local()
        # policy-set lifecycle: every cache mutation snapshots +
        # compiles ahead off the request path; serving acquires the
        # last-known-good compiled version (lifecycle/manager.py). The
        # worker thread is started by the control plane (serve) — with
        # it stopped, stale revisions compile synchronously, preserving
        # the classic compile-on-demand behavior for CLI and tests.
        self.lifecycle = PolicySetLifecycleManager(
            cache, compile_fn=self._compile_version, metrics=self.metrics)
        self.batcher = MicroBatcher(self._evaluate_batch, max_batch, max_wait_ms)
        # --batching: the serving pipeline replaces the plain batcher on
        # the validate path — shape-bucketed padding, deadline-aware
        # flushing, and high-water shedding (serving/batcher.py)
        self.pipeline: Optional[AdmissionPipeline] = None
        # class extraction (serving/scheduler.py): every validate
        # request is classified from its AdmissionReview metadata —
        # username globs, dryRun, groups, the priority annotation —
        # and the pipeline schedules/sheds by that class
        self.classify_config = classify_config or ClassifyConfig()
        if batching:
            cfg = batch_config or BatchConfig(
                max_batch_size=max_batch, max_wait_ms=max_wait_ms)
            # the pipeline's padding and the engine's own bucketing must
            # agree on the dispatched shape (no double padding, no
            # surprise recompiles) — the engine is the single source
            cfg.min_bucket = TorchEngine.MIN_BUCKET
            # the critical_reserve headroom only makes sense when some
            # request can actually classify critical; with no promotion
            # path configured (no --critical-users globs, annotation
            # promotion off) the reserve would just cut effective queue
            # capacity by its fraction — every request shed at
            # (1-reserve)*high_water against slots nothing can use
            if (not self.classify_config.critical_users
                    and not self.classify_config.trust_annotation_critical):
                cfg.critical_reserve = 0.0
            self.pipeline = AdmissionPipeline(
                self._evaluate_padded,
                scalar_fallback=self._scalar_verdict_rows,
                config=cfg,
                metrics=self.metrics,
                version_provider=self._pin_version,
                cache_lookup=self._cached_verdict_rows,
                flight_hook=self._flight_hook,
                # hedged dispatch evaluates at the PINNED revision of
                # the flush it races, so the race is bit-identical
                # even while a hot swap lands mid-flight
                hedge_fn=self._scalar_verdict_rows)
        # --mutate-batching: a SECOND serving pipeline fronting the
        # mutate workload, whose evaluator is the compiled needs-
        # mutation triage (tpu.engine.triage_mutate) instead of the
        # validate scan. Only triage-positive resources reach the host
        # patcher (mutation/coordinator.py); every degradation rung —
        # shed-to-scalar, hedge, breaker fallback, no compiled version
        # — produces all-HOST rows that route EVERY mutate policy to
        # the scalar patcher: bit-identical output, just without the
        # device shortcut.
        self.mutate_pipeline: Optional[AdmissionPipeline] = None
        # triage-path stash: the mutate pipeline's flight hook runs on
        # the flusher thread and is the only place that knows HOW a
        # request resolved (batched / cached / hedged_* / shed-to-
        # scalar); mutate() needs that label on the REQUEST thread for
        # its post-patch record. AdmissionPayload has __slots__, so the
        # hook parks (path, trace_id) here keyed by payload identity
        # and the request thread pops it.
        self._mutate_paths: Dict[int, Tuple[str, str]] = {}  # guarded-by: _mutate_paths_lock
        self._mutate_paths_lock = threading.Lock()
        if mutate_batching:
            # mirror the validate pipeline's operator-tuned knobs but
            # never share the config OBJECT — a shared instance would
            # couple the two queues' reserves and buckets
            mcfg = dataclasses.replace(batch_config) if batch_config \
                else BatchConfig(max_batch_size=max_batch,
                                 max_wait_ms=max_wait_ms)
            mcfg.min_bucket = TorchEngine.MIN_BUCKET
            if (not self.classify_config.critical_users
                    and not self.classify_config.trust_annotation_critical):
                mcfg.critical_reserve = 0.0
            self.mutate_pipeline = AdmissionPipeline(
                self._triage_padded,
                scalar_fallback=self._host_triage_rows,
                config=mcfg,
                metrics=self.metrics,
                version_provider=self._pin_version,
                cache_lookup=self._cached_triage_rows,
                flight_hook=self._mutate_flight_hook,
                # an all-HOST hedge is always safe to race the device
                # triage: HOST only widens the scalar-patched set, and
                # the scalar patcher is the bit-identity oracle
                hedge_fn=self._host_triage_rows)

    # -- versioned engine acquisition (lifecycle/manager.py)

    def _compile_version(self, policies, quarantine) -> TorchEngine:
        from ..tpu.compiler import compile_policy_set

        cps = compile_policy_set(policies, quarantine=quarantine)
        eng = TorchEngine(cps=cps, exceptions=self.exceptions,
                          device=self.device)
        # with the compile-ahead worker running, "ahead" includes the
        # smallest shape bucket's first runs: its eager run and its
        # graph capture happen here, on the lifecycle worker, so the
        # first post-swap flush replays a captured program instead of
        # capturing on the flusher. Bisect PROBE compiles skip it: those
        # engines are thrown away.
        lifecycle = getattr(self, "lifecycle", None)
        if (lifecycle is not None and lifecycle.worker_running
                and not lifecycle.probing and cps.device_programs):
            try:
                eng.warm_buckets([TorchEngine.MIN_BUCKET])
            except Exception as e:
                # best-effort, as the reference's warm scan: the flush
                # meets the same failure on the engine's guarded ladder
                from ..observability.log import global_oplog

                global_oplog.emit("compile_warm_failed", level="warn",
                                  error=f"{type(e).__name__}: {e}",
                                  bucket=TorchEngine.MIN_BUCKET)
        return eng

    def _pin_version(self) -> Optional[PolicySetVersion]:
        """Flush-time pin for the serving pipeline: None when no
        compiled version exists yet (the evaluator then degrades to the
        pure scalar ladder instead of failing the batch)."""
        try:
            return self.lifecycle.acquire()
        except PolicySetUnavailable:
            return None

    def _cached_verdict_rows(self, payload: AdmissionPayload):
        """Submit-time verdict-cache lookup (tpu/cache.py): a repeat
        admission of a content-identical manifest under the active
        compiled version answers instantly — no queue, no flush, no
        device. None on miss/ineligible; the request then batches
        normally and its flush populates the cache."""
        from ..tpu.cache import global_verdict_cache

        if not global_verdict_cache.enabled:
            return None  # --verdict-cache-size 0 must cost nothing
        version = self.lifecycle.active  # wait-free; never compiles
        if version is None:
            return None
        eng = version.engine
        if not eng.cache_eligible:
            return None  # before the O(snapshot) namespace-label walk
        res = payload.old if (payload.operation == "DELETE" and payload.old) \
            else payload.resource
        ns_labels = self.snapshot.namespace_labels() if self.snapshot else {}
        keys = eng.verdict_cache_keys(
            [res], ns_labels, [payload.operation], [payload.info])
        if keys is None or keys[0] is None:
            return None
        col = global_verdict_cache.get(keys[0],
                                       expect_rows=len(eng.cps.rules))
        if col is None:
            # fleet peering: a local miss may be a fleet-wide hit — one
            # bounded single-key peer fetch (tight budget, per-peer
            # breaker) before falling through to the batch path. With
            # every peer down this costs at most one peer timeout and
            # then nothing until a breaker half-opens — the p99
            # envelope guarantee of the degradation ladder.
            try:
                from ..fleet import get_fleet

                fleet = get_fleet()
                if fleet is not None and fleet.active:
                    col = fleet.fetch_one(keys[0], len(eng.cps.rules))
            except Exception:
                col = None
        if col is None:
            return None
        # submit-time cache hits never reach the engine: replay the
        # column into the rule analytics so cached admissions count
        try:
            from ..observability.analytics import global_rule_stats

            global_rule_stats.ingest_column(eng.rule_idents(), col,
                                            source="cached")
            eng.record_pattern_replay(1)
        except Exception:
            pass
        return VerdictRows(
            [((e.policy_name, e.rule_name), int(col[row]))
             for row, e in enumerate(eng.cps.rules)],
            version=version)

    def _engine(self) -> Tuple[int, TorchEngine]:
        ver = self.lifecycle.acquire()
        return ver.revision, ver.engine

    def _need_roles(self) -> bool:
        """Binding resolution is O(snapshot) — skip it unless some
        loaded policy actually reads roles/clusterRoles/subjects."""
        from ..engine.userinfo import policies_use_rbac

        rev, policies = self.cache.snapshot()
        with self._lock:
            need = self._rbac_needed.get(rev)
            if need is None:
                need = policies_use_rbac(policies)
                self._rbac_needed.clear()
                self._rbac_needed[rev] = need
        return need

    def _scalar_verdict_rows(self, payload: AdmissionPayload,
                             version: Optional[PolicySetVersion] = None):
        """One request through the scalar oracle, emitted in the same
        compiled-rule row order as the batch path (the shed/degradation
        path must be bit-identical to the batched one). With no compiled
        version available at all (initial compile still failing), the
        rows come straight from the live cache policies — the deepest
        rung of the ladder still answers."""
        if version is None:
            try:
                version = self.lifecycle.acquire()
            except PolicySetUnavailable:
                return self._pure_scalar_rows(payload)
        eng = version.engine
        res = payload.old if (payload.operation == "DELETE" and payload.old) \
            else payload.resource
        ns_labels = self.snapshot.namespace_labels() if self.snapshot else {}
        per_policy: Dict[int, Optional[Dict[str, int]]] = {}
        rows = []
        for entry in eng.cps.rules:
            if entry.policy_idx not in per_policy:
                policy = eng.cps.policies[entry.policy_idx]
                try:
                    pctx = build_scan_context(
                        policy, res, ns_labels.get(payload.namespace, {}),
                        payload.operation, payload.info)
                    per_policy[entry.policy_idx] = _scalar_rule_verdicts(
                        self.scalar, policy, pctx)
                except Exception:
                    # oracle choked on this policy (quarantined-and-
                    # broken): per-rule ERROR, never a lost request
                    per_policy[entry.policy_idx] = None
            verdicts = per_policy[entry.policy_idx]
            rows.append(((entry.policy_name, entry.rule_name),
                         ERROR if verdicts is None
                         else verdicts.get(entry.rule_name, NOT_MATCHED)))
        try:
            from ..observability.analytics import global_rule_stats

            global_rule_stats.ingest_column(
                eng.rule_idents(), [code for _, code in rows],
                source="scalar")
        except Exception:
            pass
        return VerdictRows(rows, version=version)

    def _pure_scalar_rows(self, payload: AdmissionPayload):
        """No compiled artifact exists: evaluate the live cache's
        policies on the scalar engine, rows in the same (policy order,
        validate-rule order) layout the compiler would emit."""
        rev, policies = self.cache.snapshot()
        res = payload.old if (payload.operation == "DELETE" and payload.old) \
            else payload.resource
        ns_labels = self.snapshot.namespace_labels() if self.snapshot else {}
        rows = []
        for policy in policies:
            try:
                pctx = build_scan_context(
                    policy, res, ns_labels.get(payload.namespace, {}),
                    payload.operation, payload.info)
                verdicts = _scalar_rule_verdicts(self.scalar, policy, pctx)
            except Exception:
                verdicts = None
            for rule in policy.get_rules():
                if not rule.has_validate():
                    continue
                rows.append(((policy.name, rule.name),
                             ERROR if verdicts is None
                             else verdicts.get(rule.name, NOT_MATCHED)))
        try:
            # no compiled artifact: build the analytics identities
            # straight from the live cache policies (all host-resolved)
            from ..observability.analytics import (RuleIdent,
                                                   global_rule_stats,
                                                   policy_spec_hash)

            idents = []
            for policy in policies:
                ph = policy_spec_hash(policy)
                for rule in policy.get_rules():
                    if rule.has_validate():
                        idents.append(RuleIdent(ph, policy.name, rule.name,
                                                False))
            global_rule_stats.ingest_column(
                idents, [code for _, code in rows], source="scalar")
        except Exception:
            pass
        return VerdictRows(rows, revision=rev)

    # -- batched mutation (mutation/): triage evaluator + rungs

    def _triage_padded(self, payloads: List[Optional[AdmissionPayload]],
                       pinned: Optional[PolicySetVersion] = None):
        """Mutate-pipeline batch evaluator: ONE device cross-product of
        the compiled needs-mutation predicates over the whole flush
        (pad slots encode as empty resources — the same shape-bucket
        contract as _evaluate_padded). Every degradation — scalar
        toggle, no compiled version, breaker/dispatch failure inside
        triage_mutate — yields all-HOST rows; the coordinator then
        scalar-patches everything, so degraded and device paths stay
        bit-identical."""
        pad = AdmissionPayload({}, "", RequestInfo(), "")
        real_n = sum(1 for p in payloads if p is not None)
        filled = [p if p is not None else pad for p in payloads]
        t0 = time.perf_counter()
        if pinned is None:
            try:
                pinned = self.lifecycle.acquire()
            except PolicySetUnavailable:
                pinned = None
        try:
            self._flight_tls.nsmap = (self.snapshot.namespace_labels()
                                      if self.snapshot else {})
        except Exception:
            self._flight_tls.nsmap = {}
        if self.toggles.engine == "scalar" or pinned is None:
            return [self._host_triage_rows(p, version=pinned)
                    for p in filled[:real_n]]
        eng = pinned.engine
        result = eng.triage_mutate(
            [p.resource for p in filled], self._flight_tls.nsmap,
            operations=[p.operation for p in filled],
            admission_infos=[p.info for p in filled])
        self.metrics.device_dispatch.observe(time.perf_counter() - t0,
                                             {"engine": "tpu_mutate"})
        self.metrics.batch_size.observe(real_n)
        return [VerdictRows(result.rows_for(ci), version=pinned)
                for ci in range(real_n)]

    def _host_triage_rows(self, payload: AdmissionPayload,
                          version: Optional[PolicySetVersion] = None):
        """All-HOST triage rows — the mutate pipeline's shed / hedge /
        no-device rung. Routing every mutate policy to the scalar
        patcher is always CORRECT (device triage is only a skip
        shortcut), so the deepest mutate rung costs throughput, never
        fidelity. With no compiled version at all there is no mutate
        bank either: the rows come back empty and versionless, and
        mutate() takes the legacy per-policy host loop."""
        if version is None:
            try:
                version = self.lifecycle.acquire()
            except PolicySetUnavailable:
                version = None
        if version is None:
            rev, _ = self.cache.snapshot()
            return VerdictRows([], revision=rev)
        return VerdictRows(
            [((e.policy_name, e.rule_name), HOST)
             for e in version.engine.cps.mutate_entries],
            version=version)

    def _cached_triage_rows(self, payload: AdmissionPayload):
        """Submit-time triage-cache hit: a content-identical manifest
        under the active compiled version answers its (M,) triage
        column without queue, flush, or device. Keys carry the
        "mutate|" ident namespace (tpu/engine.py) so a triage column
        and a validate column for the same request can never collide
        in the shared verdict cache."""
        from ..tpu.cache import global_verdict_cache

        if not global_verdict_cache.enabled:
            return None
        version = self.lifecycle.active  # wait-free; never compiles
        if version is None:
            return None
        eng = version.engine
        entries = eng.cps.mutate_entries
        if not entries or not eng.mutate_cache_eligible:
            return None
        ns_labels = self.snapshot.namespace_labels() if self.snapshot else {}
        keys = eng.mutate_triage_cache_keys(
            [payload.resource], ns_labels, [payload.operation],
            [payload.info])
        if keys is None or keys[0] is None:
            return None
        col = global_verdict_cache.get(keys[0], expect_rows=len(entries))
        if col is None:
            return None
        self.metrics.mutate_triage.inc({"outcome": "cached"})
        return VerdictRows(
            [((e.policy_name, e.rule_name), int(col[row]))
             for row, e in enumerate(entries)],
            version=version)

    def _mutate_flight_hook(self, payload: AdmissionPayload, result: Any,
                            path: str, latency_s: float, trace_id: str,
                            timings: Optional[Dict[str, float]] = None
                            ) -> None:
        """Mutate-pipeline black-box hook. A successful triage is NOT
        the end of a mutate admission — the coordinator still has to
        patch — so success paths only stash (path, trace_id) for the
        request thread's post-patch record (kind="mutate", carrying the
        patched body). Terminal failures (shed-rejected, expired,
        evaluator error) never reach the coordinator and record here,
        so no mutate decision escapes the ring."""
        if not isinstance(result, BaseException):
            with self._mutate_paths_lock:
                if len(self._mutate_paths) > 1024:
                    # abandoned entries (waiter gave up before the
                    # flusher resolved) must not accumulate forever
                    self._mutate_paths.clear()
                self._mutate_paths[id(payload)] = (path, trace_id)
            return
        from ..observability.flightrecorder import global_flight

        if not global_flight.enabled:
            return
        outcome = global_flight.classify(None, path, error=result)
        if not global_flight.should_capture(outcome):
            return
        t = dict(timings or {})
        t["total_s"] = latency_s
        info = payload.info
        global_flight.record_admission(
            payload.resource, None, path, error=result,
            namespace=payload.namespace, operation=payload.operation,
            userinfo={"username": info.username, "uid": info.uid,
                      "groups": list(info.groups or [])},
            trace_id=trace_id, timings=t, kind="mutate", outcome=outcome)

    def _pop_mutate_path(self, payload: AdmissionPayload
                         ) -> Tuple[str, str]:
        with self._mutate_paths_lock:
            return self._mutate_paths.pop(id(payload), ("batched", ""))

    # -- flight recorder (observability/flightrecorder.py)

    def _flight_hook(self, payload: AdmissionPayload, result: Any,
                     path: str, latency_s: float, trace_id: str,
                     timings: Optional[Dict[str, float]] = None) -> None:
        """Per-resolved-request black-box record builder, called by the
        serving pipeline (cached/shed at submit, batched from the
        flusher thread — where the dispatch-path thread-local and the
        engine's confirm flag are still this flush's truth)."""
        from ..observability.flightrecorder import global_flight
        from ..observability.profiling import (PATH_SCALAR_FALLBACK,
                                               last_dispatch_path)

        if not global_flight.enabled:
            return
        error = result if isinstance(result, BaseException) else None
        rows = result if isinstance(result, list) else None
        version = getattr(rows, "version", None)
        engine = version.engine if version is not None else None
        revision = getattr(rows, "revision", None)
        confirm = False
        if path == "batched" and rows is not None:
            # the dispatch-path thread-local describes the LAST engine
            # evaluation on this thread: only a request that actually
            # produced rows may trust it — an expired/errored request
            # never reached the engine and must not inherit a prior
            # flush's path
            if last_dispatch_path() == PATH_SCALAR_FALLBACK:
                path = "scalar_fallback"
            if engine is not None:
                try:
                    confirm = engine.confirm_seen()
                except Exception:
                    confirm = False
            if version is None:
                path = "pure_scalar"  # deepest rung: no compiled set
        # sampling gate FIRST: everything below (the O(snapshot)
        # namespace-labels walk, userinfo dict) is built only for the
        # ~1% of decisions actually captured
        outcome = global_flight.classify(rows, path, error=error,
                                         confirm=confirm)
        if not global_flight.should_capture(outcome):
            return
        res = payload.old if (payload.operation == "DELETE" and payload.old) \
            else payload.resource
        # the flush that produced these rows stashed its ns-labels map
        # on this thread (_evaluate_padded); submit-side paths (cached
        # hit, shed) have no flush and walk the snapshot themselves
        nsmap = getattr(self._flight_tls, "nsmap", None) \
            if path not in ("cached", "shed") else None
        if nsmap is None and self.snapshot is not None:
            try:
                nsmap = self.snapshot.namespace_labels()
            except Exception:
                nsmap = {}
        ns_labels = (nsmap or {}).get(payload.namespace, {})
        info = payload.info
        t = dict(timings or {})
        t["total_s"] = latency_s
        global_flight.record_admission(
            res, rows, path, error=error, engine=engine,
            revision=revision, namespace=payload.namespace,
            operation=payload.operation,
            userinfo={"username": info.username, "uid": info.uid,
                      "groups": list(info.groups or []),
                      "roles": list(info.roles or []),
                      "cluster_roles": list(info.cluster_roles or [])},
            ns_labels=ns_labels, trace_id=trace_id, timings=t,
            confirm=confirm, outcome=outcome)

    def _evaluate_batch(self, payloads: List[AdmissionPayload]):
        # unpadded MicroBatcher path: same evaluator as the serving
        # pipeline (zero pad slots), so batched and non-batched verdict
        # computation cannot drift. The single _engine() acquisition
        # below pins one compiled version for this flush too. Flight
        # records materialize here (the pipeline path records via its
        # own hook, so the two never double-count).
        t0 = time.perf_counter()
        out = self._evaluate_padded(payloads)
        dt = time.perf_counter() - t0
        try:
            for payload, rows in zip(payloads, out):
                self._flight_hook(payload, rows, "batched", dt, "")
        except Exception:
            pass
        return out

    def _evaluate_padded(self, payloads: List[Optional[AdmissionPayload]],
                         pinned: Optional[PolicySetVersion] = None):
        """Batch evaluator shared by the MicroBatcher (no pad slots) and
        the serving pipeline, whose batches arrive padded with trailing
        None up to their shape bucket; pad slots encode as empty
        resources so every flush dispatches at a bucketed
        (compile-cached) shape. HOST-flagged cells inside eng.scan
        complete via the scalar engine — a request the device path can't
        cover degrades to the host oracle instead of failing the whole
        batch. ``pinned`` is the policy-set version the flusher captured
        for this flush (serving/batcher.py): the whole batch evaluates
        against exactly that version, never a mid-swap mix."""
        pad = AdmissionPayload({}, "", RequestInfo(), "")
        real_n = sum(1 for p in payloads if p is not None)
        filled = [p if p is not None else pad for p in payloads]
        t0 = time.perf_counter()
        if pinned is None:
            # ONE acquire for the whole flush, before ANY branch: the
            # scalar-toggle path must pin exactly like the device path,
            # or requests in one batch could straddle a hot swap
            try:
                pinned = self.lifecycle.acquire()
            except PolicySetUnavailable:
                pinned = None  # pure scalar ladder below
        if self.toggles.engine == "scalar" or pinned is None:
            # toggle-gated host path (pkg/toggle analogue), and the
            # deepest rung (no compiled artifact at all): the same
            # verdict table, computed by the scalar oracle per
            # (policy, resource) — against the pinned version when one
            # exists, else the live cache revision
            from ..observability.profiling import (PATH_SCALAR_FALLBACK,
                                                   set_dispatch_path)

            set_dispatch_path(PATH_SCALAR_FALLBACK)
            try:
                self._flight_tls.nsmap = (
                    self.snapshot.namespace_labels()
                    if self.snapshot else {})
            except Exception:
                self._flight_tls.nsmap = {}
            if pinned is None:
                out = [self._pure_scalar_rows(p) for p in filled[:real_n]]
            else:
                out = [self._scalar_verdict_rows(p, version=pinned)
                       for p in filled[:real_n]]
            self.metrics.device_dispatch.observe(time.perf_counter() - t0,
                                                 {"engine": "scalar"})
            return out
        eng = pinned.engine
        resources = [
            p.old if (p.operation == "DELETE" and p.old) else p.resource
            for p in filled
        ]
        ns_labels = self.snapshot.namespace_labels() if self.snapshot else {}
        # ONE walk per flush, reused by every flight record this flush
        # produces (the hook runs on this same flusher thread)
        self._flight_tls.nsmap = ns_labels
        result = eng.scan(
            resources,
            ns_labels,
            operations=[p.operation for p in filled],
            admission_infos=[p.info for p in filled],
            # pad slots are empty resources: verdicts are computed for
            # them (shape bucketing) but they must not pollute the rule
            # analytics
            live_n=real_n,
        )
        self.metrics.device_dispatch.observe(time.perf_counter() - t0,
                                             {"engine": "tpu"})
        self.metrics.batch_size.observe(real_n)
        return [VerdictRows(resource_verdicts(result, ci), version=pinned)
                for ci in range(real_n)]

    # -- health / introspection

    def ready(self) -> Tuple[bool, Dict[str, Any]]:
        """/readyz: the loaded policy set compiles AND the TPU breaker
        is not OPEN. An OPEN breaker still serves correct verdicts (the
        scalar ladder), but a rollout gate that can't tell "healthy" from
        "limping on the host oracle" will happily scale a degraded
        fleet — readiness is where that distinction surfaces."""
        from ..resilience.breaker import tpu_breaker

        detail: Dict[str, Any] = {}
        try:
            rev, eng = self._engine()
            dev, total = eng.coverage()
            detail["policy_revision"] = rev
            detail["compiled_rules"] = total
            detail["device_rules"] = dev
            compiled = True
        except Exception as e:
            detail["compile_error"] = f"{type(e).__name__}: {e}"
            compiled = False
        breaker = tpu_breaker()
        detail["breaker"] = breaker.state
        # lifecycle surface: the ACTIVE compiled revision (what traffic
        # is really served with — may trail the cache revision while a
        # compile-ahead runs) and the quarantine list. A stale-but-
        # compiled set is still ready; quarantine is visible, not fatal.
        ls = self.lifecycle.state()
        detail["policyset"] = {
            "active_revision": ls["active_revision"],
            "cache_revision": ls["cache_revision"],
            "quarantined": [q["policy"] for q in ls["quarantined"]],
            "compile_breaker": ls["compile_breaker"],
        }
        # SLO surface: burn-rate state rides readiness so a rollout
        # gate (or an operator) sees budget burn next to the ladder
        # state. Burning an SLO does not flip readiness — verdicts are
        # still correct — it is the early-warning channel.
        try:
            from ..observability.analytics import global_slo

            detail["slo"] = global_slo.state()
        except Exception:
            pass
        # fleet advisory: the gossiped telemetry rollup's degraded bit
        # (fleet-aggregated shadow-verification divergence) rides the
        # slo block — advisory like the rest of it, the gate sees a
        # fleet limping on divergent verdicts without readiness lying
        # about this replica's own health
        try:
            from ..fleet import get_fleet

            fleet = get_fleet()
            if fleet is not None and isinstance(detail.get("slo"), dict):
                advisory = fleet.slo_advisory()
                detail["slo"]["fleet"] = advisory
                if advisory.get("degraded"):
                    breached = detail["slo"].setdefault("breached", [])
                    if "fleet_divergence" not in breached:
                        breached.append("fleet_divergence")
        except Exception:
            pass
        # storage advisory: degraded durability surfaces ride readiness
        # the same way SLO burn does — visible, NEVER fatal. A replica
        # on a full disk still serves bit-identical verdicts; flipping
        # readiness would trade reduced durability for an outage.
        try:
            from ..resilience.storage import global_storage

            degraded = global_storage.degraded_surfaces()
            if degraded:
                detail["storage_degraded"] = degraded
        except Exception:
            pass
        ok = compiled and breaker.state != "open"
        detail["ready"] = ok
        return ok, detail

    def debug_state(self) -> Dict[str, Any]:
        """/debug/state: one JSON document answering "what is the
        engine doing RIGHT NOW" — queue depth and bucket occupancy,
        breaker state, compile-cache contents, armed faults, and the
        accumulated per-phase cost split."""
        from ..observability.profiling import global_profiler
        from ..resilience.breaker import tpu_breaker
        from ..resilience.faults import global_faults

        breaker = tpu_breaker()
        active = self.lifecycle.active
        compile_cache = [] if active is None else [{
            "revision": active.revision,
            "device_rules": active.engine.coverage()[0],
            "total_rules": active.engine.coverage()[1],
            "dyn_slots": len(active.engine.cps.dyn_slots),
            "jit_built": bool(active.engine.cps._fns),
            "policies": [p.name for p in active.engine.cps.policies],
        }]
        from ..observability.metrics import global_registry as _reg
        from ..tpu.cache import global_encode_cache, global_verdict_cache

        state: Dict[str, Any] = {
            "engine_toggle": self.toggles.engine,
            "breaker": {"name": breaker.name, "state": breaker.state},
            "compile_cache": compile_cache,
            "perf_caches": {
                "verdict": {
                    "size": len(global_verdict_cache),
                    "hits": _reg.verdict_cache.value({"outcome": "hit"}),
                    "misses": _reg.verdict_cache.value({"outcome": "miss"}),
                    "evictions": global_verdict_cache.evictions,
                },
                "encode": {
                    "size": len(global_encode_cache),
                    "hits": _reg.encode_cache.value({"outcome": "hit"}),
                    "misses": _reg.encode_cache.value({"outcome": "miss"}),
                    "evictions": global_encode_cache.evictions,
                },
                # the port has no compile cache: None, as the
                # reference reports with its cache off
                "xla_cache_dir": None,
            },
            "policyset": self.lifecycle.state(),
            "patterns": _pattern_state(
                active.engine.cps if active is not None else None),
            "encode_pool": _encode_pool_state(),
            "columnar": _columnar_state(),
            "reports": _reports_state(),
            "faults_armed": {
                site: {"mode": spec.mode, "calls": spec.calls,
                       "fired": spec.fired}
                for site, spec in global_faults.armed().items()},
            "flight": _flight_state(),
            "verification": _verification_state(),
            "fleet": _fleet_state(),
            "storage": _storage_state(),
            "phase_breakdown": global_profiler.breakdown(),
        }
        if self.pipeline is not None:
            state["pipeline"] = self.pipeline.state()
        # mutation subsystem block (mutation/): bank shape, template
        # coverage, and the triage/patch counters the mutate gate
        # asserts on — present (enabled=false) even with the pipeline
        # off, so dashboards never key-error across configs
        mut: Dict[str, Any] = {"enabled": self.mutate_pipeline is not None}
        if active is not None:
            m_eng = active.engine
            m_dev, m_total = m_eng.mutate_coverage()
            mut["rules"] = m_total
            mut["device_rows"] = m_dev
            mut["templates"] = sum(
                1 for t in m_eng.cps.mutate_templates if t is not None)
            mut["cache_eligible"] = bool(m_eng.mutate_cache_eligible)
        mut["counters"] = {
            "triage": {o: _reg.mutate_triage.value({"outcome": o})
                       for o in ("device", "fallback", "cached")},
            "rows": {r: _reg.mutate_triage_rows.value({"result": r})
                     for r in ("positive", "negative", "host")},
            "patches": {s: _reg.mutate_patches.value({"source": s})
                        for s in ("template", "scalar")},
            "patch_fallbacks": _reg.mutate_patch_fallbacks.value(),
            "divergence": _reg.mutate_divergence.value(),
        }
        if self.mutate_pipeline is not None:
            mut["pipeline"] = self.mutate_pipeline.state()
        state["mutation"] = mut
        return state

    # -- public handlers

    def _lookup_policy(self, policy_key, policies=None):
        """Fine-grained URL param -> policy (handlers.go:206-219): a
        missing policy is an evaluation error, not a silent allow."""
        ns, name = policy_key
        if policies is None:
            _, policies = self.cache.snapshot()
        for p in policies:
            if p.name == name and (not ns or getattr(p, "namespace", "") == ns):
                return p
        raise KeyError(f"key {ns}/{name}: policy not found")

    def _class_filter(self, failure_policy: str, policy_key, policies=None):
        """handlers.go:244 filterPolicies: the /fail and /ignore webhook
        paths each evaluate only their failurePolicy class; the bare
        path ("all") evaluates everything. Fine-grained paths scope to
        the one named policy (also class-filtered). Returns the set of
        evaluable policy names, or None for no filtering. ``policies``
        scopes the filter to a pinned version's set (validate recomputes
        it from the SERVED version so the filter and the verdict rows
        can never straddle two revisions under churn)."""
        if failure_policy not in ("fail", "ignore") and policy_key is None:
            return None
        if policies is None:
            _, policies = self.cache.snapshot()
        names = set()
        for p in policies:
            cls = "ignore" if (p.spec.failure_policy or "Fail") == "Ignore" \
                else "fail"
            if failure_policy in ("fail", "ignore") and cls != failure_policy:
                continue
            names.add(p.name)
        if policy_key is not None:
            scoped = self._lookup_policy(policy_key, policies)  # raises KeyError
            # verdict rows are keyed by bare policy name; refuse the
            # fine-grained route when that name is ambiguous rather
            # than leak another policy's verdicts into the decision
            if sum(1 for p in policies if p.name == scoped.name) > 1:
                raise KeyError(
                    f"policy name {scoped.name!r} is ambiguous across "
                    f"namespaces; fine-grained routing cannot scope it")
            names &= {scoped.name}
        return names

    def _fail_open(self, failure_policy: str) -> bool:
        """Resolve an evaluation error per failurePolicy: the /ignore
        path class (or the force toggle, pkg/toggle) allows, everything
        else denies with reason — a degraded engine never surfaces as
        an unhandled 500."""
        return (failure_policy == "ignore"
                or bool(getattr(self.toggles, "force_failure_policy_ignore",
                                False)))

    def _loaded_policies_all_ignore(self) -> bool:
        """True when no loaded policy's failurePolicy is Fail — the
        bare webhook path's shed/expiry resolution: with no Fail policy
        in the set (including an EMPTY set, which evaluated normally
        would allow) there is nothing a deny would protect."""
        try:
            _, policies = self.cache.snapshot()
        except Exception:
            return False
        return all((p.spec.failure_policy or "Fail") == "Ignore"
                   for p in policies)

    def validate(self, review: Dict[str, Any], failure_policy: str = "all",
                 policy_key=None) -> Dict[str, Any]:
        from ..resilience.retry import Deadline

        t0 = time.perf_counter()
        # the request's time budget starts when WE start processing it:
        # every downstream wait (queue, batch, device) draws from the
        # same Deadline, so total webhook latency stays bounded
        deadline = Deadline(self.request_timeout_s)
        req = review.get("request") or {}
        payload = _payload_from_request(req, self.snapshot, self._need_roles())
        self.metrics.admission_requests.inc(
            {"operation": payload.operation, "path": "validate"})
        if self._filtered(payload):
            return _response(req, True, "")
        try:
            evaluable = self._class_filter(failure_policy, policy_key)
        except KeyError as e:
            return _response(req, self._fail_open(failure_policy),
                             f"evaluation error: {e}")
        try:
            # --batching routes through the serving pipeline (padded
            # shape buckets, deadline-aware flush, high-water shedding);
            # a shed in "fail" mode or an expired deadline lands here as
            # an exception and resolves per failurePolicy below
            remaining = deadline.remaining()
            if remaining <= 0:
                raise DeadlineExceededError(
                    "request budget exhausted before evaluation")
            if self.pipeline is not None:
                # queue budget: the TIGHTER of the request's remaining
                # webhook budget and the pipeline's configured queue
                # deadline — always passing the webhook remainder alone
                # would make --deadline-ms dead configuration. The
                # eval grace for a dispatched request is whatever the
                # webhook wall leaves after the queue budget: the API
                # server hangs up at timeoutSeconds, so waiting longer
                # only strands the connection
                queue_ms = min(remaining * 1000.0,
                               self.pipeline.config.deadline_ms)
                cls = classify_request(
                    self.classify_config, operation=payload.operation,
                    username=payload.info.username,
                    namespace=payload.namespace,
                    groups=payload.info.groups,
                    dry_run=payload.dry_run, resource=payload.resource)
                verdicts = self.pipeline.submit(
                    payload, deadline_ms=queue_ms,
                    eval_grace_s=min(self.pipeline.config.eval_grace_s,
                                     max(0.0, remaining - queue_ms / 1000.0)),
                    cls=cls)
            else:
                verdicts = self.batcher.submit(payload, timeout=remaining)
        except Exception as e:
            allowed = self._fail_open(failure_policy)
            if not allowed and failure_policy == "all" and \
                    isinstance(e, (QueueFullError, DeadlineExceededError)):
                # per-class failurePolicy resolution: a shed or expiry
                # is an ADMISSION-CONTROL decision, not an engine
                # error. On the bare ("all") path — which carries no
                # class filter of its own — resolve it per the
                # failurePolicy of the policies that WOULD have
                # evaluated: an all-Ignore set allows, any Fail policy
                # keeps the deny. The /fail and /ignore paths already
                # said what their class wants.
                allowed = self._loaded_policies_all_ignore()
            return _response(req, allowed, f"evaluation error: {e}")
        served = getattr(verdicts, "version", None)
        if served is not None:
            # recompute the class filter from the SERVED version: the
            # pre-submit value fast-failed missing fine-grained routes,
            # but the filter applied to the rows must describe the same
            # revision that produced them, not the live cache
            try:
                evaluable = self._class_filter(failure_policy, policy_key,
                                               policies=served.policies)
            except KeyError as e:
                return _response(req, self._fail_open(failure_policy),
                                 f"evaluation error: {e}")
        if evaluable is not None:
            # the batch evaluates the full compiled program (one device
            # dispatch for every concurrent request); rows outside this
            # path's policy class / fine-grained scope are dropped so
            # the decision and reports only reflect the routed policies
            verdicts = [(pr, code) for pr, code in verdicts
                        if pr[0] in evaluable]
        # the Enforce set comes from the SAME policy-set version that
        # produced the verdict rows (VerdictRows.version) — reading the
        # live cache here would mix revisions when a hot swap lands
        # between the flush and this decision
        if served is not None:
            decision_policies = served.policies
        else:
            _, decision_policies = self.cache.snapshot()
        enforce = {
            p.name for p in decision_policies
            if (p.spec.validation_failure_action or "Audit").lower().startswith("enforce")
        }
        # DELETE requests carry the object in oldObject (object is null)
        evaluated = payload.old if (payload.operation == "DELETE" and payload.old) \
            else payload.resource
        block_msgs: List[str] = []
        audit_results: List[ReportResult] = []
        for (pname, rname), code in verdicts:
            if code in (NOT_MATCHED,):
                continue
            if code in (FAIL, ERROR) and pname in enforce:
                block_msgs.append(f"{pname}/{rname}: {VERDICT_NAMES.get(code, 'fail')}")
            if self.aggregator is not None:
                meta = evaluated.get("metadata") or {}
                audit_results.append(ReportResult(
                    policy=pname, rule=rname,
                    result=VERDICT_NAMES.get(code, "error"),
                    resource_kind=evaluated.get("kind", ""),
                    resource_name=meta.get("name", ""),
                    resource_namespace=meta.get("namespace", ""),
                ))
        if self.aggregator is not None and audit_results:
            if payload.operation == "DELETE":
                self.aggregator.drop(resource_uid(evaluated))
            else:
                # merge scope = policies the batch actually produced
                # verdict rows for — NOT the whole failurePolicy class,
                # which would clobber verify-image rows stored by the
                # mutate webhook for policies this path never evaluates
                covered = {pr[0] for pr, _ in verdicts}
                self.aggregator.put(resource_uid(evaluated), audit_results,
                                    scope=covered)
        self.metrics.admission_duration.observe(time.perf_counter() - t0,
                                                {"path": "validate"})
        if block_msgs:
            return _response(req, False, "; ".join(block_msgs))
        return _response(req, True, "")

    def validate_exception(self, review: Dict[str, Any]) -> Dict[str, Any]:
        """PolicyException CR validation webhook
        (pkg/webhooks/exception, pkg/validation/exception)."""
        from ..api.exception import PolicyException

        req = review.get("request") or {}
        obj = req.get("object") or {}
        errs = PolicyException.from_dict(obj).validate()
        if errs:
            return _response(req, False, "; ".join(errs))
        return _response(req, True, "")

    def validate_globalcontext(self, review: Dict[str, Any]) -> Dict[str, Any]:
        """GlobalContextEntry CR validation webhook
        (pkg/webhooks/globalcontext)."""
        from ..globalcontext import GlobalContextEntry

        req = review.get("request") or {}
        obj = req.get("object") or {}
        errs = GlobalContextEntry.from_dict(obj).validate()
        if errs:
            return _response(req, False, "; ".join(errs))
        return _response(req, True, "")

    def validate_policy_cr(self, review: Dict[str, Any]) -> Dict[str, Any]:
        """Policy CR validation webhook (/policyvalidate,
        pkg/webhooks/policy/handlers.go:27 Validate -> pkg/validation/
        policy Validate): denies malformed policies at admission time,
        surfaces non-fatal findings as warnings."""
        from ..policy.validation import validate_policy

        req = review.get("request") or {}
        obj = req.get("object") or {}
        # DELETE carries a null object — deleting a policy is never
        # gated on its validity
        if req.get("operation") == "DELETE" or not obj:
            return _response(req, True, "")
        try:
            policy = ClusterPolicy.from_dict(obj)
            errors, warnings = validate_policy(policy)
        except Exception as e:  # malformed CR bodies are denials too
            return _response(req, False, f"invalid policy: {e}")
        out = _response(req, not errors, "; ".join(errors))
        if warnings:
            out["response"]["warnings"] = warnings
        return out

    def mutate_policy_cr(self, review: Dict[str, Any]) -> Dict[str, Any]:
        """Policy CR mutation webhook (/policymutate): the reference's
        handler is a no-op success since v1.11 (pkg/webhooks/policy/
        handlers.go:41 Mutate returns ResponseSuccess — defaulting
        moved to CRD defaults)."""
        req = review.get("request") or {}
        return _response(req, True, "")

    def _filtered(self, payload: AdmissionPayload) -> bool:
        """WithFilter middleware: resourceFilters + user exclusions
        short-circuit processing (handlers/filter.go)."""
        if self.configuration is None:
            return False
        res = payload.old if (payload.operation == "DELETE" and payload.old) \
            else payload.resource
        meta = res.get("metadata") or {}
        if self.configuration.to_filter(
                res.get("kind", ""), meta.get("namespace", ""), meta.get("name", "")):
            return True
        return self.configuration.is_excluded(
            payload.info.username, payload.info.groups, payload.info.roles)

    def mutate(self, review: Dict[str, Any], failure_policy: str = "all",
               policy_key=None) -> Dict[str, Any]:
        from ..resilience.retry import Deadline

        t0 = time.perf_counter()
        deadline = Deadline(self.request_timeout_s)
        req = review.get("request") or {}
        payload = _payload_from_request(req, self.snapshot, self._need_roles())
        self.metrics.admission_requests.inc(
            {"operation": payload.operation, "path": "mutate"})
        if self._filtered(payload):
            return _response(req, True, "")
        resource = payload.resource
        patched = resource
        ns_labels = self.snapshot.namespace_labels() if self.snapshot else {}
        try:
            evaluable = self._class_filter(failure_policy, policy_key)
        except KeyError as e:
            return _response(req, self._fail_open(failure_policy),
                             f"evaluation error: {e}")
        mutate_rec = None  # (rows, path, trace_id) for the post-patch record
        served: Optional[PolicySetVersion] = None
        try:
            rows = None
            if self.mutate_pipeline is not None:
                # --mutate-batching: the batched front door. Triage
                # through the serving pipeline (same queue budget math
                # as validate()); the rows come back pinned to the
                # compiled version that produced them.
                remaining = deadline.remaining()
                if remaining <= 0:
                    raise DeadlineExceededError(
                        "request budget exhausted before mutation")
                queue_ms = min(remaining * 1000.0,
                               self.mutate_pipeline.config.deadline_ms)
                cls = classify_request(
                    self.classify_config, operation=payload.operation,
                    username=payload.info.username,
                    namespace=payload.namespace,
                    groups=payload.info.groups,
                    dry_run=payload.dry_run, resource=payload.resource)
                rows = self.mutate_pipeline.submit(
                    payload, deadline_ms=queue_ms,
                    eval_grace_s=min(
                        self.mutate_pipeline.config.eval_grace_s,
                        max(0.0, remaining - queue_ms / 1000.0)),
                    cls=cls)
                served = getattr(rows, "version", None)
            if served is not None:
                from ..mutation.coordinator import apply_mutations

                path, trace_id = self._pop_mutate_path(payload)
                # the class filter must describe the SERVED version,
                # exactly like validate() (dropping a policy's rows
                # drops its whole group from the coordinator — the
                # batched analogue of the legacy loop's `continue`)
                try:
                    evaluable = self._class_filter(
                        failure_policy, policy_key,
                        policies=served.policies)
                except KeyError as e:
                    return _response(req, self._fail_open(failure_policy),
                                     f"evaluation error: {e}")
                outm = apply_mutations(
                    served.engine, resource,
                    [(pr, code) for pr, code in rows
                     if evaluable is None or pr[0] in evaluable],
                    namespace_labels=ns_labels.get(payload.namespace, {}),
                    operation=payload.operation,
                    admission_info=payload.info,
                    registry=self.metrics)
                patched = outm.patched
                mutate_rec = (rows, path, trace_id)
            else:
                # legacy host loop: no mutate pipeline configured, or
                # no compiled artifact exists (versionless rows) — the
                # deepest rung evaluates the live cache policies
                # scalar, one at a time
                for policy in self.cache.get_policies(
                    PolicyType.MUTATE, kind=resource.get("kind"),
                    namespace=payload.namespace
                ):
                    if evaluable is not None and policy.name not in evaluable:
                        continue
                    pctx = build_scan_context(
                        policy, patched, ns_labels.get(payload.namespace, {}),
                        payload.operation, payload.info,
                    )
                    response = self.scalar.mutate(pctx)
                    if response.patched_resource is not None:
                        patched = response.patched_resource
            # image verification runs after mutation on the patched
            # resource (resource/handlers.go:139-177: mutate policies
            # then verify-image policies, patches joined)
            for policy in self.cache.get_policies(
                PolicyType.VERIFY_IMAGES_MUTATE, kind=resource.get("kind"),
                namespace=payload.namespace,
            ):
                if evaluable is not None and policy.name not in evaluable:
                    continue
                pctx = build_scan_context(
                    policy, patched, ns_labels.get(payload.namespace, {}),
                    payload.operation, payload.info,
                )
                pctx.old_resource = payload.old or {}
                response = self.scalar.verify_and_patch_images(
                    pctx, registry_client=self.registry_client,
                    iv_cache=self.iv_cache)
                if response.patched_resource is not None:
                    patched = response.patched_resource
                # all verifyImages results land in reports, mirroring
                # the validate path's audit plumbing
                if self.aggregator is not None and response.policy_response.rules:
                    meta = patched.get("metadata") or {}
                    # scope to this one policy so successive
                    # verify-image policies (and the validate path's
                    # rows) merge instead of replacing each other
                    self.aggregator.put(resource_uid(patched), [
                        ReportResult(
                            policy=policy.name, rule=rr.name,
                            result=rr.status,
                            resource_kind=patched.get("kind", ""),
                            resource_name=meta.get("name", ""),
                            resource_namespace=meta.get("namespace", ""),
                        ) for rr in response.policy_response.rules],
                        scope={policy.name})
                # only Enforce policies block; Audit failures surface
                # via the report path above (utils/block.go semantics)
                enforce = (policy.spec.validation_failure_action
                           or "Audit").lower().startswith("enforce")
                if enforce and not response.is_successful():
                    failed = ", ".join(response.get_failed_rules())
                    return _response(
                        req, False,
                        f"image verification failed: {policy.name}: {failed}")
            # composed mutate+validate: ONE admission pass — the
            # patched object feeds the validate scan at the SAME
            # pinned revision that triaged it, so a mutation that
            # produces a blocked object denies here instead of
            # surfacing a revision-skewed deny from the separate
            # validate webhook later
            if served is not None and patched is not resource \
                    and patched != resource:
                block = self._validate_patched(payload, patched, served,
                                               failure_policy, policy_key)
                if block:
                    return _response(
                        req, False,
                        f"mutation produced a blocked object: {block}")
        except Exception as e:
            allowed = self._fail_open(failure_policy)
            if not allowed and failure_policy == "all" and \
                    isinstance(e, (QueueFullError, DeadlineExceededError)):
                # shed/expiry is an admission-control decision, not an
                # engine error — same per-class resolution as validate()
                allowed = self._loaded_policies_all_ignore()
            return _response(req, allowed, f"mutation error: {e}")
        out = _response(req, True, "")
        ops = jsonpatch_diff(resource, patched)
        if ops:
            out["response"]["patchType"] = "JSONPatch"
            out["response"]["patch"] = base64.b64encode(
                json.dumps(ops).encode()).decode()
        dt = time.perf_counter() - t0
        self.metrics.admission_duration.observe(dt, {"path": "mutate"})
        if mutate_rec is not None:
            self.metrics.mutate_duration.observe(dt)
            rows, path, trace_id = mutate_rec
            self._record_mutate(payload, patched, rows, path, trace_id, dt)
        return out

    def _validate_patched(self, payload: AdmissionPayload,
                          patched: Dict[str, Any],
                          served: PolicySetVersion,
                          failure_policy: str, policy_key) -> str:
        """The composed pass's validate leg: one direct batch (NOT a
        pipeline submit — the pin must be exactly the triage's version,
        and a queued submit could flush after a hot swap) of the
        patched object. Returns the deny message, or "" to allow.
        Reports stay with the validate webhook, which will re-evaluate
        the patched object the API server sends it."""
        vp = AdmissionPayload(patched, payload.operation, payload.info,
                              payload.namespace, old=payload.old,
                              dry_run=payload.dry_run)
        verdicts = self._evaluate_padded([vp], pinned=served)[0]
        try:
            evaluable = self._class_filter(failure_policy, policy_key,
                                           policies=served.policies)
        except KeyError as e:
            return "" if self._fail_open(failure_policy) \
                else f"evaluation error: {e}"
        enforce = {
            p.name for p in served.policies
            if (p.spec.validation_failure_action or "Audit")
            .lower().startswith("enforce")
        }
        return "; ".join(
            f"{pn}/{rn}: {VERDICT_NAMES.get(code, 'fail')}"
            for (pn, rn), code in verdicts
            if code in (FAIL, ERROR) and pn in enforce
            and (evaluable is None or pn in evaluable))

    def _record_mutate(self, payload: AdmissionPayload,
                       patched: Dict[str, Any], rows, path: str,
                       trace_id: str, latency_s: float) -> None:
        """Post-patch mutate record: kind="mutate" with the patched
        body and its digest. The shadow verifier re-derives the patch
        through the scalar oracle at the pinned revision and diffs the
        bodies (observability/verification.py) — zero divergence is the
        vectorized patcher's correctness budget."""
        from ..observability.flightrecorder import global_flight

        if not global_flight.enabled:
            return
        version = getattr(rows, "version", None)
        engine = version.engine if version is not None else None
        rec_path = path if path.endswith("_mutate") else f"{path}_mutate"
        outcome = global_flight.classify(rows, rec_path, mutated=True)
        if not global_flight.should_capture(outcome):
            return
        try:
            nsmap = self.snapshot.namespace_labels() if self.snapshot else {}
        except Exception:
            nsmap = {}
        info = payload.info
        global_flight.record_admission(
            payload.resource, rows, rec_path, engine=engine,
            revision=getattr(rows, "revision", None),
            namespace=payload.namespace, operation=payload.operation,
            userinfo={"username": info.username, "uid": info.uid,
                      "groups": list(info.groups or []),
                      "roles": list(info.roles or []),
                      "cluster_roles": list(info.cluster_roles or [])},
            ns_labels=(nsmap or {}).get(payload.namespace, {}),
            trace_id=trace_id, timings={"total_s": latency_s},
            kind="mutate", outcome=outcome, patched=patched)


def _payload_from_request(req: Dict[str, Any], snapshot=None,
                          need_roles: bool = True) -> AdmissionPayload:
    user = req.get("userInfo") or {}
    roles: list = []
    cluster_roles: list = []
    if snapshot is not None and need_roles:
        # resolve (cluster)roles from bindings so match.roles /
        # match.clusterRoles policies gate raw admission requests
        # (pkg/userinfo/roleRef.go:26 GetRoleRef)
        from ..engine.userinfo import resolve_roles_from_snapshot

        roles, cluster_roles = resolve_roles_from_snapshot(
            snapshot, user.get("username", ""), list(user.get("groups") or []))
    info = RequestInfo(
        username=user.get("username", ""),
        uid=user.get("uid", ""),
        groups=list(user.get("groups") or []),
        roles=roles,
        cluster_roles=cluster_roles,
    )
    return AdmissionPayload(
        resource=req.get("object") or {},
        operation=req.get("operation", "CREATE"),
        info=info,
        namespace=req.get("namespace", ""),
        old=req.get("oldObject"),
        dry_run=bool(req.get("dryRun")),
    )


def _response(req: Dict[str, Any], allowed: bool, message: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": {"uid": req.get("uid", ""), "allowed": allowed},
    }
    if message:
        out["response"]["status"] = {"message": message}
    return out


def build_handlers(cache: PolicyCache, snapshot=None, aggregator=None,
                   device=None, **kw) -> Handlers:
    return Handlers(cache, snapshot, aggregator, device=device, **kw)


def _flight_state():
    try:
        from ..observability.flightrecorder import global_flight

        return global_flight.state()
    except Exception:
        return {}


def _verification_state():
    try:
        from ..observability.verification import global_verifier

        return global_verifier.state()
    except Exception:
        return {}


def _encode_pool_state():
    """The encoder pool's /debug/state block ({'enabled': False} when
    --encode-workers is 0 — introspection must not start a pool)."""
    try:
        from ..encode import pool_state

        return pool_state()
    except Exception:
        return {"enabled": False}


def _fleet_state():
    """The fleet layer's /debug/state block ({'enabled': False}
    outside a fleet — introspection must not start one)."""
    try:
        from ..fleet import get_fleet

        fleet = get_fleet()
        return fleet.state() if fleet is not None else {"enabled": False}
    except Exception:
        return {"enabled": False}


def _columnar_state():
    """The columnar row store's /debug/state block: per-table arena
    occupancy, hit/miss/segment accounting, and the feed-work counters
    the columnar gate asserts on ({'enabled': False} when off)."""
    try:
        from ..cluster.columnar import store_state

        return store_state()
    except Exception:
        return {"enabled": False}


def _storage_state():
    """The degraded-storage ladder's /debug/state block: per-surface
    ok/degraded state, error/drop/heal counts — only surfaces that
    have actually been exercised appear (introspection must not
    invent health state for unused surfaces)."""
    try:
        from ..resilience.storage import storage_state

        return storage_state()
    except Exception:
        return {}


def _reports_state():
    """The incremental report store's /debug/state block: resource and
    namespace counts, journal occupancy, sequence number, and the
    recovery/compaction stats the soak gate asserts on ({'enabled':
    False} when off)."""
    try:
        from ..reports import reports_state

        return reports_state()
    except Exception:
        return {"enabled": False}


def _active_cps(handlers):
    try:
        active = handlers.lifecycle.active
        return active.engine.cps if active is not None else None
    except Exception:
        return None


def _pattern_state(cps=None):
    """Device-side string matching introspection: the compiled DFA
    bank's shape plus the pattern-cell path accounting (device /
    confirm / host) — the /debug/state and /debug/utilization
    ``patterns`` block."""
    try:
        from ..observability.analytics import global_pattern_cells

        out = global_pattern_cells.state()
    except Exception:
        out = {}
    if cps is not None and getattr(cps, "dfa", None) is not None:
        try:
            out["bank"] = cps.dfa.stats()
        except Exception:
            pass
    return out


# /debug/xla/start|stop: one torch.profiler session a process (host and
# CUDA activity), exported on stop as a Chrome trace into its directory
_profile_lock = threading.Lock()
_profile: Optional[Tuple[Any, str]] = None  # guarded-by: _profile_lock


def _torch_profile_start(out_dir: str) -> None:
    global _profile
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _profile_lock:
        if _profile is not None:
            raise RuntimeError("a trace is already running")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        _profile = (prof, out_dir)


def _torch_profile_stop() -> None:
    """Stop the running trace and write ``<dir>/trace-<pid>.json``."""
    global _profile
    import os

    with _profile_lock:
        if _profile is None:
            raise RuntimeError("no trace is running")
        prof, out_dir = _profile
        _profile = None
    prof.__exit__(None, None, None)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"trace-{os.getpid()}.json"))


def handle_debug_path(path: str, handlers: Optional[Handlers] = None
                      ) -> Tuple[int, bytes, str]:
    """One debug router shared by the admission server and the serve
    control plane's metrics port — the two surfaces must answer
    identically or operators end up debugging the debug endpoints."""
    from urllib.parse import parse_qs, urlparse

    from ..observability.tracing import global_tracer

    parsed = urlparse(path)
    route = parsed.path
    query = parse_qs(parsed.query)
    if route == "/debug/traces":
        try:
            min_ms = float(query.get("min_ms", ["0"])[0])
        except ValueError:
            return 400, b'{"error": "min_ms must be a number"}\n', "application/json"
        traces = global_tracer.recent_traces(min_duration_s=min_ms / 1000.0)
        return 200, (json.dumps({"traces": traces}) + "\n").encode(), \
            "application/json"
    if route == "/debug/state":
        state = handlers.debug_state() if handlers is not None else {}
        return 200, (json.dumps(state) + "\n").encode(), "application/json"
    if route == "/debug/rules":
        # the policy observatory: top-N hot rules, never-fired rules
        # with age, per-policy device coverage — the runtime half of
        # policy anomaly detection (a never-fired rule is a shadowing /
        # dead-rule candidate for `analyze` to confirm statically)
        from ..observability.analytics import global_rule_stats

        try:
            top = int(query.get("top", ["20"])[0])
        except ValueError:
            return 400, b'{"error": "top must be an integer"}\n', \
                "application/json"
        doc = global_rule_stats.report(top=top)
        # per-pattern compile status (exact / minimized / approximated
        # / top_collapse, chosen stride, owning rules): which rules pay
        # scalar CONFIRM trips and why — the un-silenced budget footgun
        cps = _active_cps(handlers) if handlers is not None else None
        if cps is not None and getattr(cps, "dfa", None) is not None:
            try:
                doc["patterns"] = cps.dfa.pattern_report()
            except Exception:
                pass
        return 200, (json.dumps(doc) + "\n").encode(), "application/json"
    if route == "/debug/analysis":
        # the last completed policy-set static analysis (analysis/):
        # confirmed anomalies, per-rule static status, witness/phase
        # stats, and lint-run accounting — populated by the lifecycle
        # lint (`serve --analyze-on-swap`) or any run_analysis caller
        from ..analysis import global_analysis

        doc = global_analysis.report_dict()
        return 200, (json.dumps(doc) + "\n").encode(), "application/json"
    if route == "/debug/fleet":
        # the fleet layer's operator surface: membership/lease view,
        # shard ownership + takeover staleness, per-peer breaker
        # states, and the push-queue depth ({'enabled': False} on a
        # single-replica engine)
        doc = _fleet_state()
        return 200, (json.dumps(doc) + "\n").encode(), "application/json"
    if route == "/debug/flight":
        # the flight recorder's ring, newest-last: the last N decisions
        # with bodies (size-capped), verdict columns, dispatch path,
        # and trace ids — the incident-forensics surface the spool
        # files mirror on disk
        from ..observability.flightrecorder import global_flight

        try:
            last = int(query.get("last", ["100"])[0])
        except ValueError:
            return 400, b'{"error": "last must be an integer"}\n', \
                "application/json"
        doc = {"records": global_flight.dump(last=last),
               "state": global_flight.state(),
               "verification": _verification_state()}
        return 200, (json.dumps(doc, default=str) + "\n").encode(), \
            "application/json"
    if route == "/debug/utilization":
        from ..observability.analytics import global_slo, global_starvation
        from ..observability.metrics import global_registry as _reg
        from ..observability.profiling import global_profiler
        from ..tpu.cache import global_encode_cache, global_verdict_cache

        doc = {
            "feed_starvation": global_starvation.state(),
            "pipeline": {
                "overlap_ratio": _reg.pipeline_overlap.value(),
                "chunks": {labels.get("path", ""): v for labels, v
                           in _reg.pipeline_chunks.series()},
            },
            "utilization_seconds": {
                labels.get("phase", ""): round(v, 6) for labels, v
                in _reg.utilization_seconds.series()},
            "flusher_seconds": {
                labels.get("state", ""): round(v, 6) for labels, v
                in _reg.serving_flusher_seconds.series()},
            "perf_caches": {"verdict_hit_rate": global_verdict_cache.hit_rate(),
                            "encode_hit_rate": global_encode_cache.hit_rate()},
            "patterns": _pattern_state(_active_cps(handlers)),
            "encode_pool": _encode_pool_state(),
            "verification": _verification_state(),
            "slo": global_slo.state(),
            "phase_breakdown": global_profiler.breakdown(),
        }
        if handlers is not None and handlers.pipeline is not None:
            doc["serving"] = handlers.pipeline.state()
        return 200, (json.dumps(doc) + "\n").encode(), "application/json"
    if route == "/debug/spans":
        lines = []
        for s in global_tracer.finished()[-200:]:
            attrs = " ".join(f"{k}={v}" for k, v in s.attributes.items())
            lines.append(f"{s.name} {s.duration * 1e3:.3f}ms "
                         f"trace={s.trace_id} status={s.status} {attrs}".rstrip())
        return 200, ("\n".join(lines) + "\n").encode(), "text/plain"
    if route.startswith("/debug/xla/start"):
        out_dir = query.get("dir", ["/tmp/kyverno-tpu-xla-trace"])[0]
        try:
            _torch_profile_start(out_dir)
        except Exception as e:
            return 500, f"profiler start failed: {e}\n".encode(), "text/plain"
        return 200, f"xla trace started -> {out_dir}\n".encode(), "text/plain"
    if route.startswith("/debug/xla/stop"):
        try:
            _torch_profile_stop()
        except Exception as e:
            return 500, f"profiler stop failed: {e}\n".encode(), "text/plain"
        return 200, b"xla trace stopped\n", "text/plain"
    return 404, b"unknown debug path\n", "text/plain"


class AdmissionServer:
    """ThreadingHTTPServer wrapper with optional TLS."""

    def __init__(
        self,
        handlers: Handlers,
        host: str = "127.0.0.1",
        port: int = 9443,
        certfile: Optional[str] = None,
        keyfile: Optional[str] = None,
        enable_debug: bool = False,
    ) -> None:
        self.handlers = handlers
        # the reference serves pprof on a separate localhost-only port
        # behind the `profile` flag (pkg/profiling); here the /debug/*
        # surface is opt-in and OFF by default on the admission port
        self.enable_debug = enable_debug
        outer = self

        class _Req(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/health/liveness", "/health/readiness",
                                 "/healthz"):
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(b"ok")
                elif self.path == "/readyz":
                    ok, detail = outer.handlers.ready()
                    body = json.dumps(detail).encode()
                    self.send_response(200 if ok else 503)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/debug/") and outer.enable_debug:
                    # pprof-equivalent surface (pkg/profiling, SURVEY §5)
                    code, body, ctype = outer.handle_debug(self.path)
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                try:
                    review = json.loads(body)
                except ValueError:
                    self.send_response(400)
                    self.end_headers()
                    return
                path = self.path.rstrip("/")
                segs = [s for s in path.split("/") if s]
                base = segs[0] if segs else ""
                # /validate[/{fail|ignore}[/finegrained/[ns/]name]]
                # (server.go:296-300 registerWebhookHandlers routes);
                # the bare path is the "all" class — no failurePolicy
                # filtering, errors fail closed
                failure_policy = "all"
                policy_key = None
                if len(segs) >= 2 and segs[1] in ("fail", "ignore"):
                    failure_policy = segs[1]
                    if len(segs) >= 3 and segs[2] == "finegrained":
                        if len(segs) < 4:
                            # truncated fine-grained URL: refuse rather
                            # than silently fall back to the catch-all
                            self.send_response(404)
                            self.end_headers()
                            return
                        # [ns, name] or [name] (handlers.go:200-210)
                        rest = segs[3:]
                        policy_key = (rest[0], rest[1]) if len(rest) >= 2 \
                            else ("", rest[0])
                if base == "validate":
                    out = outer.handlers.validate(review, failure_policy,
                                                  policy_key=policy_key)
                elif base == "mutate":
                    out = outer.handlers.mutate(review, failure_policy,
                                                policy_key=policy_key)
                elif base == "policyvalidate":
                    out = outer.handlers.validate_policy_cr(review)
                elif base == "policymutate":
                    out = outer.handlers.mutate_policy_cr(review)
                elif base == "exception":
                    out = outer.handlers.validate_exception(review)
                elif base == "globalcontext":
                    out = outer.handlers.validate_globalcontext(review)
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                data = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), _Req)
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self._ssl_ctx = ctx
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket, server_side=True)
        self._thread: Optional[threading.Thread] = None

    def handle_debug(self, path: str) -> Tuple[int, bytes, str]:
        """Debug introspection surface (pkg/profiling pprof analogue +
        the device profiler hook, SURVEY §5). Shared with the serve
        control plane's metrics port (cli/serve.py):

        /debug/traces[?min_ms=N]  recent traces as JSON, filterable by
                                  total trace duration
        /debug/state              queue/breaker/compile-cache/faults/
                                  phase-split snapshot as JSON
        /debug/rules[?top=N]      policy observatory: top-N hot rules,
                                  never-fired rules with age, per-policy
                                  device coverage
        /debug/utilization        feed-starvation ratio, pipeline
                                  overlap, flusher state split, SLO
                                  burn state
        /debug/analysis           policy-set static analysis: confirmed
                                  anomalies, per-rule static status,
                                  witness stats, lint-run accounting
        /debug/flight[?last=N]    flight-recorder ring: the last N
                                  recorded admission/scan decisions
                                  (bodies, verdicts, path, trace ids)
                                  + recorder/verifier state
        /debug/spans              recent spans, one line each (legacy)
        /debug/xla/start?dir=D    start a torch.profiler trace
        /debug/xla/stop           stop it (a Chrome trace lands in
                                  the dir)
        """
        return handle_debug_path(path, self.handlers)

    def reload_cert(self, certfile: str, keyfile: Optional[str] = None) -> None:
        """Hot cert rotation (tls/renewer.go): reloading the chain into
        the live SSLContext affects only new handshakes — established
        connections and the listening socket keep serving."""
        if self._ssl_ctx is None:
            raise RuntimeError("server was not started with TLS")
        self._ssl_ctx.load_cert_chain(certfile, keyfile)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self.handlers.batcher.stop()
        if self.handlers.pipeline is not None:
            self.handlers.pipeline.stop()
        if self.handlers.mutate_pipeline is not None:
            self.handlers.mutate_pipeline.stop()
