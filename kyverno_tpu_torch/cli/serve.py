# Copied from kyverno_tpu/cli/serve.py. The control plane runs its
# engines on the card (device=, --device cpu for the plain path);
# --xla-cache-dir is kept and logs that the port has no compile cache;
# --distributed brings up torch.distributed (gloo) and, at a world size
# above 1, the cross-process mesh the background scan shards over.
"""`serve` — run the admission + scan control plane in one process.

The deployment-unit equivalent (cmd/kyverno + cmd/reports-controller):
loads policies, starts the admission HTTPS server (micro-batched
validation on the card), the background scan loop over an in-memory snapshot fed
by /snapshot/upsert, a Prometheus /metrics endpoint, and health probes.
Offline-first: no kube-apiserver needed; the snapshot API stands in for
informers, which keeps the whole data plane drivable in CI.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict

import yaml

from ..api.policy import ClusterPolicy, is_policy_document
from ..cluster import BackgroundScanService, ClusterSnapshot, PolicyCache, ReportAggregator
from ..config import Configuration, Toggles
from ..observability.metrics import global_registry
from ..webhooks import AdmissionServer, build_handlers


def add_parser(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("serve", help="run admission server + background scanner")
    p.add_argument("policies", nargs="+", help="policy files or directories")
    p.add_argument("--port", type=int, default=9443, help="admission port")
    p.add_argument("--metrics-port", type=int, default=8000)
    p.add_argument("--scan-interval", type=float, default=30.0)
    p.add_argument("--cert", default=None, help="TLS certificate file")
    p.add_argument("--key", default=None, help="TLS key file")
    p.add_argument("--engine", choices=["tpu", "scalar"], default=None,
                   help="override the KYVERNO_TPU_ENGINE toggle")
    p.add_argument("--device", default=None,
                   help="torch device of the admission and scan engines "
                        "(default: the CUDA card; 'cpu' runs the plain "
                        "PyTorch path)")
    p.add_argument("--config", default=None,
                   help="kyverno ConfigMap-style YAML (resourceFilters etc.)")
    # micro-batching serving pipeline (serving/batcher.py) — default
    # off, so the existing per-flush MicroBatcher path is untouched
    p.add_argument("--batching", action="store_true",
                   help="coalesce concurrent AdmissionReviews into padded "
                        "device batches (deadline-aware flush + shedding)")
    p.add_argument("--mutate-batching", action="store_true",
                   help="route the mutate webhook through a device-triaged "
                        "serving pipeline (mutation/): batched needs-"
                        "mutation triage, template-stamped patches, scalar "
                        "fallback for everything else")
    p.add_argument("--max-batch-size", type=int, default=64,
                   help="flush when this many requests are queued")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="flush when the oldest request has waited this long")
    p.add_argument("--deadline-ms", type=float, default=5000.0,
                   help="per-request queue budget before deadline expiry")
    p.add_argument("--queue-high-water", type=int, default=1024,
                   help="queue depth beyond which requests are shed")
    p.add_argument("--shed-mode", choices=["scalar", "fail"], default="scalar",
                   help="shed overload to the scalar engine, or fail the "
                        "request per the webhook path's failurePolicy")
    # admission scheduling (serving/scheduler.py): per-class weighted
    # fair queuing, bulk coalescing, hedged dispatch, and the
    # burn-driven shed ladder — the engine degrades BY CLASS under
    # overload instead of uniformly
    p.add_argument("--class-weights", default=None,
                   metavar="critical=8,default=4,bulk=1",
                   help="weighted-fair share per priority tier; each "
                        "(tenant x operation x priority) class is its own "
                        "flow weighted by its tier")
    p.add_argument("--bulk-max-wait-ms", type=float, default=50.0,
                   help="bulk coalescing window: bulk requests wait up to "
                        "this long to fill whole shape buckets instead of "
                        "fragmenting every flush (they still top flushes "
                        "up to their padded bucket for free)")
    p.add_argument("--hedge-threshold", type=float, default=0.25,
                   help="hedged scalar dispatch: once a dispatched "
                        "request's remaining deadline budget falls below "
                        "this fraction while its device batch is in "
                        "flight, race the scalar oracle against the batch "
                        "(first bit-identical result wins; 0 disables)")
    p.add_argument("--shed-burn-bulk", type=float, default=1.0,
                   help="admission-SLO burn rate above which the BULK "
                        "class sheds at submit (0 disables); bulk always "
                        "sheds first")
    p.add_argument("--shed-burn-default", type=float, default=3.0,
                   help="burn rate above which the DEFAULT class sheds "
                        "too (0 disables); the critical class is never "
                        "burn-shed")
    p.add_argument("--bulk-share", type=float, default=0.5,
                   help="fraction of the queue the bulk class may occupy "
                        "before it sheds")
    p.add_argument("--critical-reserve", type=float, default=0.1,
                   help="top fraction of the queue reserved for the "
                        "critical class")
    p.add_argument("--bulk-shed-mode", choices=["scalar", "fail"],
                   default=None,
                   help="shed mode override for the bulk class "
                        "(default: --shed-mode); 'fail' resolves shed "
                        "bulk per failurePolicy instead of spending "
                        "scalar work on traffic being shed")
    p.add_argument("--bulk-users", default=None,
                   metavar="GLOB[,GLOB...]",
                   help="usernames classified into the bulk tier "
                        "(default: system:node:*,system:serviceaccount:"
                        "kube-system:*)")
    p.add_argument("--critical-users", default=None,
                   metavar="GLOB[,GLOB...]",
                   help="usernames classified into the critical tier "
                        "(default: none; identity globs are the only "
                        "promotion path — the policies.kyverno.io/priority "
                        "resource annotation may only demote)")
    p.add_argument("--request-timeout-s", type=float, default=10.0,
                   help="per-request time budget; an overrun resolves per "
                        "the webhook path's failurePolicy, never a 500")
    p.add_argument("--trace-export", default=None, metavar="PATH",
                   help="append every finished span to PATH as "
                        "newline-delimited OTLP-JSON (offline trace capture)")
    # live policy churn (lifecycle/): poll DIR for policy file changes
    # and hot-swap the compiled set via the compile-ahead worker —
    # serving keeps answering on the last-known-good version throughout
    p.add_argument("--policy-watch", default=None, metavar="DIR",
                   help="poll DIR (mtime/hash) for policy YAML changes and "
                        "hot-reload them through the compile-ahead swap "
                        "ladder (snapshot -> compile -> atomic swap)")
    p.add_argument("--reload-interval", type=float, default=2.0,
                   help="seconds between --policy-watch polls")
    # performance: content-addressed verdict/encode caches
    # (tpu/cache.py). --xla-cache-dir is accepted so command lines carry
    # over; the port has no compile cache (a bucket's CUDA graph is
    # captured in-process), so setting it only logs that.
    p.add_argument("--xla-cache-dir", default=None, metavar="DIR",
                   help="accepted for command-line compatibility; the "
                        "port has no persistent compile cache and logs "
                        "that when this is set")
    p.add_argument("--verdict-cache-size", type=int, default=None,
                   metavar="N",
                   help="verdict-column LRU capacity in entries "
                        "(default $KYVERNO_TPU_VERDICT_CACHE or 65536; "
                        "0 disables)")
    p.add_argument("--encode-cache-size", type=int, default=None,
                   metavar="N",
                   help="encode-row LRU capacity in entries "
                        "(default $KYVERNO_TPU_ENCODE_CACHE or 8192; "
                        "0 disables)")
    # columnar resource store (cluster/columnar.py): encoded rows are
    # the system of record between watch event and device batch —
    # rescans gather pre-flattened lanes, watch upserts re-encode only
    # the touched top-level subtrees
    p.add_argument("--columnar-dir", default=None, metavar="DIR",
                   help="back the columnar row store onto mmap files "
                        "under DIR so restarts (and other processes "
                        "mapping the same directory) share warm rows "
                        "zero-copy (default $KYVERNO_TPU_COLUMNAR_DIR "
                        "or in-memory only)")
    p.add_argument("--no-columnar", action="store_true",
                   help="disable the columnar row store entirely: "
                        "every rescan re-walks resource JSON (the "
                        "pre-PR-13 feed path)")
    p.add_argument("--columnar-entries", type=int, default=None,
                   metavar="N",
                   help="live encoded-resource entries kept per encode "
                        "path before LRU eviction + arena compaction "
                        "(default $KYVERNO_TPU_COLUMNAR_ENTRIES or "
                        "131072)")
    # incremental report store (reports/store.py): scan verdicts fold
    # into crash-consistent per-namespace reports, journaled when
    # --reports-dir names a directory
    p.add_argument("--reports-dir", default=None, metavar="DIR",
                   help="journal the incremental report store here "
                        "(length-prefixed CRC'd deltas + compacted "
                        "snapshots; SIGKILL recovers to the last good "
                        "prefix). Default $KYVERNO_TPU_REPORTS_DIR or "
                        "in-memory")
    p.add_argument("--no-reports", action="store_true",
                   help="disable the incremental report store: /reports "
                        "serves only the in-memory aggregator")
    p.add_argument("--reports-journal-max-bytes", type=int, default=None,
                   metavar="N",
                   help="report journal size that triggers a compacted "
                        "snapshot + journal reset (default "
                        "$KYVERNO_TPU_REPORTS_JOURNAL_MAX or 4 MiB)")
    # supervised multiprocess encode pool (encode/pool.py): scales the
    # device feed past one Python process, with crash/hang supervision,
    # poison-resource quarantine, and an encode-pool breaker that
    # bypasses to in-process encode
    p.add_argument("--encode-workers", type=int, default=None, metavar="N",
                   help="encoder worker processes feeding the device "
                        "(default $KYVERNO_TPU_ENCODE_WORKERS or 0; "
                        "0 keeps the in-process encode path byte-for-byte)")
    # policy observatory (observability/analytics.py): SLO targets for
    # the kyverno_slo_* burn-rate gauges + /readyz state, and the
    # cardinality bound on the per-policy kyverno_rule_* metrics
    p.add_argument("--slo-admission-p99-ms", type=float, default=50.0,
                   help="admission latency SLO target: requests slower "
                        "than this burn the error budget")
    p.add_argument("--slo-admission-budget", type=float, default=0.01,
                   help="fraction of admissions allowed over the latency "
                        "target (burn rate 1.0 = exactly this rate)")
    p.add_argument("--slo-scan-freshness-s", type=float, default=300.0,
                   help="background-scan freshness SLO target: seconds "
                        "since the last completed scan tick")
    p.add_argument("--slo-device-coverage-floor", type=float, default=0.9,
                   help="minimum fraction of compiled rules expected on "
                        "the device path")
    p.add_argument("--rule-metrics-top-k", type=int, default=None,
                   metavar="K",
                   help="per-policy kyverno_rule_* metric series kept "
                        "before collapsing into the _overflow bucket "
                        "(default $KYVERNO_TPU_RULE_METRICS_TOPK or 20)")
    # flight recorder + continuous shadow verification
    # (observability/flightrecorder.py, observability/verification.py)
    p.add_argument("--flight-sample-rate", type=float, default=None,
                   metavar="R",
                   help="fraction of ok/cached decisions captured in the "
                        "flight-recorder ring (default "
                        "$KYVERNO_TPU_FLIGHT_SAMPLE or 0.01; error/"
                        "fallback/confirm/shed outcomes always capture)")
    p.add_argument("--flight-capacity", type=int, default=None, metavar="N",
                   help="flight-recorder ring size in records (default "
                        "$KYVERNO_TPU_FLIGHT_CAPACITY or 2048)")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="spool the flight ring to DIR as NDJSON on "
                        "breaker transitions and SLO burns; shadow-"
                        "verification divergences append to "
                        "divergences.ndjson (replayable via "
                        "`kyverno-tpu replay`)")
    p.add_argument("--shadow-verify-rate", type=float, default=0.0,
                   metavar="R",
                   help="fraction of captured records continuously "
                        "re-evaluated through the scalar oracle at the "
                        "pinned revision by a low-priority background "
                        "thread; divergences count on kyverno_"
                        "verification_divergence_total and burn the "
                        "verdict-integrity SLO (0 disables)")
    p.add_argument("--log-file", default=None, metavar="PATH",
                   help="append structured operational events (breaker "
                        "transitions, swaps/rollbacks, quarantine, pool "
                        "restarts, SLO burns, divergences) to PATH as "
                        "JSONL; without it events go to stderr in human "
                        "format")
    p.add_argument("--analyze-on-swap", action="store_true",
                   help="run policy-set static analysis (witness "
                        "synthesis + shadow/conflict/redundant/dead "
                        "detection, scalar-oracle confirmed) on the "
                        "compile-ahead worker after every successful "
                        "hot swap; findings land on the op log, "
                        "kyverno_analysis_* metrics, /debug/analysis, "
                        "and the /debug/rules never-fired correlation")
    # fleet (fleet/): multi-replica scan sharding with lease-based
    # failover and peered verdict caches. Process-level replicas run
    # the whole chaos story on CPU; --distributed brings up
    # torch.distributed and shards the background scan over the
    # processes' (hosts, per_host) mesh.
    p.add_argument("--fleet-listen", type=int, default=None, metavar="PORT",
                   help="run the localhost fleet peer protocol on PORT "
                        "(membership heartbeats, verdict-cache fetch/"
                        "push); enables the fleet layer — background "
                        "scans then cover only this replica's "
                        "rendezvous-assigned keyspace shards, with "
                        "failover when a peer's lease expires (0 picks "
                        "an ephemeral port)")
    p.add_argument("--fleet-peers", default=None,
                   metavar="URL[,URL...]",
                   help="peer replica base URLs "
                        "(http://127.0.0.1:PORT,...); additional peers "
                        "are discovered through heartbeat exchange")
    p.add_argument("--replica-id", default=None, metavar="ID",
                   help="this replica's stable fleet identity "
                        "(default: r<pid>); the lowest live id leads")
    p.add_argument("--fleet-lease-s", type=float, default=3.0,
                   help="membership lease TTL: a replica that stops "
                        "heartbeating for this long is declared dead "
                        "and its shards fail over")
    p.add_argument("--fleet-shards", type=int, default=64,
                   help="fixed shard count the resource keyspace is "
                        "rendezvous-hashed into (must match across "
                        "the fleet)")
    p.add_argument("--fleet-telemetry-max-age", type=float, default=30.0,
                   help="telemetry snapshots older than this many "
                        "seconds are rejected as stale by the leader's "
                        "aggregation fold (0 disables the age check)")
    p.add_argument("--distributed", action="store_true",
                   help="bring up torch.distributed (gloo) from "
                        "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK; "
                        "at a world size above 1 the background scan "
                        "shards over a (hosts=world size, per_host=this "
                        "process's devices) mesh and its verdict counts "
                        "reduce across every process. Every rank must "
                        "serve the same snapshot and scan in step: send "
                        "each /scan to every rank, as each rank's i-th "
                        "scan pairs with every other rank's i-th. A scan "
                        "that a peer does not join within 60 s fails the "
                        "mesh for good (op-log mesh_failed, gauge "
                        "kyverno_tpu_mesh_failed): later scans complete "
                        "on the scalar engine until restart. Without "
                        "that env, or at world size 1, this logs and "
                        "continues single-host")
    p.add_argument("--dfa-state-budget", type=int, default=None, metavar="N",
                   help="per-pattern DFA state budget for device-side "
                        "string matching: exact tables up to N states, "
                        "over-approximating reduced tables (device hits "
                        "confirmed by the scalar oracle) beyond it "
                        "(default $KYVERNO_TPU_DFA_STATE_BUDGET or 192)")
    p.add_argument("--dfa-stride", type=int, default=None, metavar="K",
                   choices=(1, 2, 4),
                   help="largest transition stride the DFA bank may "
                        "compile: stride-K tables consume K bytes per "
                        "scan step (table columns grow as classes**K; "
                        "per-pattern stride is chosen under a "
                        "table-growth budget). 1 disables multi-stride "
                        "(default $KYVERNO_TPU_DFA_STRIDE or 4)")
    p.add_argument("--dfa-approx-error", type=float, default=None,
                   metavar="E",
                   help="over-approximation error ceiling for "
                        "budget-blowing patterns: reduced tables whose "
                        "sampled acceptance delta vs the exact automaton "
                        "exceeds E fall back to accept-all TOP-collapse; "
                        "0 disables approximate reduction entirely "
                        "(default $KYVERNO_TPU_DFA_APPROX_ERROR or 0.02)")
    p.set_defaults(func=run)


class ControlPlane:
    """Everything `serve` wires together; used directly by tests."""

    def __init__(self, policies, port=0, metrics_port=0, cert=None, key=None,
                 configuration=None, toggles=None, batching=False,
                 mutate_batching=False,
                 batch_config=None, request_timeout_s=10.0,
                 policy_watch=None, reload_interval=2.0,
                 flight_sample_rate=None, flight_capacity=None,
                 flight_dir=None, shadow_verify_rate=None,
                 analyze_on_swap=False, classify_config=None,
                 fleet_config=None, mesh=None, device=None):
        # flight recorder + shadow verifier are process-global (like
        # the caches); only explicitly-passed knobs are applied so a
        # test-configured recorder survives ControlPlane construction
        from ..observability.flightrecorder import global_flight
        from ..observability.verification import global_verifier

        if (flight_sample_rate is not None or flight_capacity is not None
                or flight_dir is not None):
            global_flight.configure(capacity=flight_capacity,
                                    sample_rate=flight_sample_rate,
                                    spool_dir=flight_dir)
        if shadow_verify_rate is not None:
            global_verifier.configure(rate=shadow_verify_rate)
        self.cache = PolicyCache()
        for p in policies:
            self.cache.set(p)
        self.snapshot = ClusterSnapshot()
        self.aggregator = ReportAggregator()
        self.configuration = configuration or Configuration()
        self.toggles = toggles or Toggles()
        # the engines run on ``device`` (the card unless the caller asks
        # for "cpu"); a mesh, when given, is the scan service's instead
        self.device = device
        self.scan_service = BackgroundScanService(
            self.snapshot, self.cache, self.aggregator, mesh=mesh,
            device=device if mesh is None else None)
        # Kyverno->VAP generation: eligible CEL policies materialize a
        # ValidatingAdmissionPolicy + binding pair in the snapshot
        # (controllers/validatingadmissionpolicy-generate/controller.go)
        from ..vap import VapGenerateController

        self.vap_generator = VapGenerateController(self.snapshot)
        for p in policies:
            self.vap_generator.reconcile(p)
        # webhook-config lifecycle: desired configurations materialize
        # in the snapshot; the startup janitor clears state stale from
        # prior runs, and stop() deregisters (server.go:243 cleanup —
        # a dead endpoint must not keep a Fail webhook registered)
        from ..cluster.leaderelection import LeaseStore
        from ..cluster.lifecycle import InitJanitor, cleanup_on_shutdown
        from ..cluster.webhookconfig import WebhookConfigGenerator

        self.lease_store = LeaseStore()
        self._cleanup_on_shutdown = cleanup_on_shutdown
        InitJanitor(self.snapshot, self.lease_store).run()
        self.webhook_config = WebhookConfigGenerator(
            self.cache,
            sink=lambda _name, cfg: self.snapshot.upsert(cfg))
        self.webhook_config.reconcile()
        self.handlers = build_handlers(
            self.cache, self.snapshot, self.aggregator,
            configuration=self.configuration, toggles=self.toggles,
            batching=batching, batch_config=batch_config,
            request_timeout_s=request_timeout_s,
            classify_config=classify_config,
            mutate_batching=mutate_batching, device=device)
        # policy-set lifecycle: the compile-ahead worker owns recompiles
        # from here on (started in start()); webhook-config and VAP
        # reconciliation ride every cache mutation so hot-reloaded
        # policies also refresh the materialized admission plumbing
        self.lifecycle = self.handlers.lifecycle
        if analyze_on_swap:
            # the compile-ahead worker lints each promoted version off
            # the request path (lifecycle/manager.py run_lint)
            from ..analysis import global_analysis

            global_analysis.lint_enabled = True
            self.lifecycle.analyze_on_swap = True
        self.cache.subscribe(self._on_policy_change)
        # fleet layer: membership + shard failover + cache peering
        # (fleet/manager.py). Configured BEFORE the scan thread starts
        # so the first tick already scans only owned shards.
        self.fleet = None
        if fleet_config is not None:
            from ..fleet import configure_fleet

            self.fleet = configure_fleet(fleet_config)
            lifecycle = self.lifecycle

            def _active_rows():
                active = lifecycle.active
                return (len(active.engine.cps.rules)
                        if active is not None else None)

            # push-receive shape verification: pushed columns must
            # match the active compiled set's rule count
            self.fleet.rows_provider = _active_rows
        self.watcher = None
        if policy_watch:
            from ..lifecycle import PolicyDirWatcher

            self.watcher = PolicyDirWatcher(
                policy_watch, self.cache, interval_s=reload_interval)
        self.admission = AdmissionServer(
            self.handlers, port=port, certfile=cert, keyfile=key)
        self.metrics_server = _metrics_server(self, metrics_port)
        self._stop = threading.Event()
        self._scan_thread: threading.Thread | None = None

    def _on_policy_change(self, key: str, change: str, revision: int) -> None:
        # materialized admission plumbing follows every cache mutation:
        # webhook configurations AND the generated VAP/binding pairs —
        # a hot-reloaded CEL policy materializes its pair exactly like a
        # startup policy, and a deleted policy retracts its stale pair
        try:
            self.webhook_config.reconcile()
        except Exception:
            pass  # materialized config refresh must not block mutation
        try:
            if change == "delete":
                self.vap_generator.on_policy_deleted(key.rpartition("/")[2])
            else:
                policy = self.cache.get(key)  # raw, like the startup pass
                if policy is not None:
                    self.vap_generator.reconcile(policy)
        except Exception:
            pass

    def start(self, scan_interval: float = 30.0) -> None:
        self.lifecycle.start()
        if self.watcher is not None:
            self.watcher.start()
        self.admission.start()
        threading.Thread(
            target=self.metrics_server.serve_forever, daemon=True).start()
        self._scan_thread = threading.Thread(
            target=self.scan_service.run, args=(scan_interval, self._stop), daemon=True)
        self._scan_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self.fleet is not None:
            # graceful leave: peers rebalance immediately instead of
            # waiting out the lease TTL
            from ..fleet import configure_fleet, get_fleet

            if get_fleet() is self.fleet:
                configure_fleet(None)
            else:
                self.fleet.stop()
            self.fleet = None
        if self.watcher is not None:
            self.watcher.stop()
        self.admission.stop()
        self.lifecycle.stop()
        from ..observability.verification import global_verifier

        global_verifier.stop()
        self.metrics_server.shutdown()
        # encoder-pool drain rides the lifecycle: in-flight chunks
        # finish (bounded), workers join, zero orphan children
        from ..encode import shutdown_pool

        shutdown_pool()
        from ..cluster.columnar import get_store

        store = get_store()
        if store is not None:
            try:
                store.sync()  # flush mmap arenas for the next process
            except Exception:
                pass
        from ..reports import get_report_store

        rstore = get_report_store()
        if rstore is not None:
            try:
                # clean close compacts: an empty journal at next boot
                # means no replay recovery to count
                rstore.close()
            except Exception:
                pass
        self._cleanup_on_shutdown(self.snapshot, self.lease_store)


def _metrics_server(cp: "ControlPlane", port: int) -> ThreadingHTTPServer:
    class _Req(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes, ctype: str = "text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                body, ctype = global_registry.http_body()
                self._send(200, body, ctype)
            elif self.path == "/reports" or self.path.startswith("/reports?"):
                # default: the in-memory aggregator (admission + scan
                # rows). ?source=store reads the crash-consistent
                # incremental store instead — same wgpolicyk8s shape
                source = cp.aggregator
                if "source=store" in self.path:
                    from ..reports import get_report_store

                    source = get_report_store()
                if source is None:
                    self._send(404, b"report store not configured")
                    return
                reports = {ns or "_cluster": r.to_dict()
                           for ns, r in source.aggregate().items()}
                self._send(200, json.dumps(reports).encode(), "application/json")
            elif self.path == "/healthz":
                self._send(200, b"ok")
            elif self.path == "/readyz":
                # ready = policy cache compiled + device breaker not OPEN
                # (webhooks/server.py Handlers.ready)
                ok, detail = cp.handlers.ready()
                self._send(200 if ok else 503,
                           json.dumps(detail).encode(), "application/json")
            elif self.path.startswith("/debug/"):
                # introspection next to /metrics: the metrics port is
                # the operator-facing localhost surface, so the debug
                # router is always on here (the ADMISSION port keeps it
                # behind enable_debug)
                from ..webhooks.server import handle_debug_path

                code, body, ctype = handle_debug_path(self.path, cp.handlers)
                self._send(code, body, ctype)
            else:
                self._send(404, b"")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                doc = json.loads(self.rfile.read(length))
            except ValueError:
                self._send(400, b"bad json")
                return
            if self.path == "/snapshot/upsert":
                uid = cp.snapshot.upsert(doc)
                self._send(200, json.dumps({"uid": uid}).encode(), "application/json")
            elif self.path == "/snapshot/delete":
                cp.snapshot.delete(doc)
                self._send(200, b"{}")
            elif self.path == "/scan":
                n = cp.scan_service.scan_once(full=bool(doc.get("full")))
                self._send(200, json.dumps(
                    {"scanned": n, "summary": cp.aggregator.summary()}).encode(),
                    "application/json")
            else:
                self._send(404, b"")

    return ThreadingHTTPServer(("127.0.0.1", port), _Req)


_DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _init_distributed(device=None):
    """serve --distributed: initialize torch.distributed from
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK (backend gloo: the
    mesh's collectives run on host tensors, and one card may hold
    several ranks) and, at a world size above 1, build the 2-D (hosts,
    data) mesh from parallel/sharding.py across the processes: hosts is
    the world size, per_host this process's device count (its CUDA
    devices, or 1 for ``device="cpu"``). Returns the mesh or None;
    without that environment it logs ``distributed_init_skipped``, at
    world size 1 ``distributed_single_host``, and any other failure
    ``distributed_init_failed``, each continuing single-host."""
    from ..observability.log import global_oplog

    env = {k: os.environ.get(k) for k in _DIST_ENV}
    missing = [k for k, v in env.items() if not v]
    if missing:
        global_oplog.emit("distributed_init_skipped", level="warn",
                          error=f"no {', '.join(missing)} in the "
                                f"environment")
        return None
    try:
        import datetime

        import torch
        import torch.distributed as dist

        from ..parallel.sharding import XPROC_TIMEOUT_S, make_mesh_2d
        from ..tpu.engine import resolve_device

        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        dev = resolve_device(device)
        backend = "gloo"
        if not dist.is_initialized():
            dist.init_process_group(
                backend,
                init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                world_size=world, rank=rank,
                timeout=datetime.timedelta(seconds=XPROC_TIMEOUT_S))
        hosts = dist.get_world_size()
        per_host = torch.cuda.device_count() if dev.type == "cuda" else 1
        if hosts <= 1:
            global_oplog.emit("distributed_single_host", backend=backend,
                              devices=per_host)
            return None
        mesh = make_mesh_2d(hosts, per_host,
                            devices=None if dev.type == "cuda" else ["cpu"])
        global_oplog.emit("distributed_initialized", hosts=hosts,
                          per_host=per_host)
        return mesh
    except Exception as e:  # noqa: BLE001
        global_oplog.emit("distributed_init_failed", level="warn",
                          error=str(e)[:200])
        return None


def _load_policies(paths) -> list:
    from .apply import _load_docs

    return [ClusterPolicy.from_dict(d) for d in _load_docs(paths)
            if is_policy_document(d)]


def run(args: argparse.Namespace) -> int:
    # the structured operational log replaces the ad-hoc stderr prints
    # below: human format on stderr by default, JSONL when --log-file
    # names a sink (both carry the same events)
    from ..observability.log import global_oplog

    global_oplog.configure(path=args.log_file, stderr=True)
    policies = _load_policies(args.policies)
    if not policies:
        print("no policies found", file=sys.stderr)
        return 2
    # performance caches BEFORE any compile happens
    from ..tpu.cache import configure as configure_caches

    configure_caches(verdict_capacity=args.verdict_cache_size,
                     encode_capacity=args.encode_cache_size)
    # observatory targets before traffic: the SLO windows and the rule-
    # metric cardinality bound are process-global like the caches
    from ..observability.analytics import global_slo

    global_slo.config.admission_p99_target_ms = args.slo_admission_p99_ms
    global_slo.config.admission_error_budget = args.slo_admission_budget
    global_slo.config.scan_freshness_target_s = args.slo_scan_freshness_s
    global_slo.config.device_coverage_floor = args.slo_device_coverage_floor
    if args.rule_metrics_top_k is not None:
        global_registry.rule_stats.top_k = args.rule_metrics_top_k
    if args.dfa_state_budget is not None:
        # compile-time knob read at every policy-set compile (hot
        # reloads included) via tpu/dfa.py state_budget()
        os.environ["KYVERNO_TPU_DFA_STATE_BUDGET"] = \
            str(args.dfa_state_budget)
    if args.dfa_stride is not None:
        # bank-finalize knob (tpu/dfa.py max_stride())
        os.environ["KYVERNO_TPU_DFA_STRIDE"] = str(args.dfa_stride)
    if args.dfa_approx_error is not None:
        # compile-time knob (tpu/dfa.py approx_error_ceiling())
        os.environ["KYVERNO_TPU_DFA_APPROX_ERROR"] = \
            str(args.dfa_approx_error)
    if args.xla_cache_dir is not None:
        global_oplog.emit("xla_cache_unavailable", dir=args.xla_cache_dir,
                          reason="the port has no persistent compile "
                                 "cache; each bucket's CUDA graph is "
                                 "captured in-process")
    # columnar row store ON by default for serve (in-memory unless
    # --columnar-dir): encoded rows — not JSON — feed the device
    from ..cluster.columnar import configure_store

    store = configure_store(directory=args.columnar_dir,
                            enabled=not args.no_columnar,
                            capacity=args.columnar_entries)
    if store is not None:
        global_oplog.emit("columnar_store_enabled",
                          dir=store.dir or "(memory)")
    # incremental report store ON by default (in-memory unless
    # --reports-dir journals it): scan verdicts fold into reports
    # instead of being re-aggregated per read
    from ..reports import configure_reports

    rstore = configure_reports(
        directory=args.reports_dir,
        enabled=not args.no_reports,
        journal_max_bytes=args.reports_journal_max_bytes)
    if rstore is not None:
        global_oplog.emit("report_store_enabled",
                          dir=rstore.directory or "(memory)")
    # the encoder pool spawns BEFORE any compile: worker interpreters
    # come up (torch-free) while the parent compiles
    from ..encode import configure_pool

    pool = configure_pool(args.encode_workers)
    if pool is not None:
        global_oplog.emit("encode_pool_started", workers=pool.n_workers)
    configuration = Configuration()
    if args.config:
        with open(args.config) as f:
            doc = yaml.safe_load(f) or {}
        configuration.load(doc.get("data") or doc)
    toggles = Toggles(engine=args.engine) if args.engine else Toggles()
    batch_config = None
    classify_config = None
    if args.batching:
        from ..serving import BatchConfig, ClassifyConfig, parse_class_weights

        batch_config = BatchConfig(
            max_batch_size=args.max_batch_size,
            max_wait_ms=args.max_wait_ms,
            deadline_ms=args.deadline_ms,
            high_water=args.queue_high_water,
            shed_mode=args.shed_mode,
            bulk_max_wait_ms=args.bulk_max_wait_ms,
            hedge_threshold=args.hedge_threshold,
            shed_burn_bulk=args.shed_burn_bulk,
            shed_burn_default=args.shed_burn_default,
            bulk_share=args.bulk_share,
            critical_reserve=args.critical_reserve,
            bulk_shed_mode=args.bulk_shed_mode)
        if args.class_weights:
            try:
                batch_config.class_weights = \
                    parse_class_weights(args.class_weights)
            except ValueError as e:
                print(f"bad --class-weights: {e}", file=sys.stderr)
                return 2
        classify_kw = {}
        if args.bulk_users is not None:
            classify_kw["bulk_users"] = tuple(
                u.strip() for u in args.bulk_users.split(",") if u.strip())
        if args.critical_users is not None:
            classify_kw["critical_users"] = tuple(
                u.strip() for u in args.critical_users.split(",")
                if u.strip())
        if classify_kw:
            classify_config = ClassifyConfig(**classify_kw)
    fleet_config = None
    if args.fleet_listen is not None:
        from ..fleet import FleetConfig

        if args.fleet_shards <= 0:
            print("--fleet-shards must be positive (0 would scan "
                  "nothing, everywhere)", file=sys.stderr)
            return 2
        peers = tuple(u.strip().rstrip("/")
                      for u in (args.fleet_peers or "").split(",")
                      if u.strip())
        fleet_config = FleetConfig(
            replica_id=args.replica_id or f"r{os.getpid()}",
            listen_port=args.fleet_listen,
            peers=peers,
            lease_s=args.fleet_lease_s,
            num_shards=args.fleet_shards,
            telemetry_max_age_s=args.fleet_telemetry_max_age)
    elif args.fleet_peers or args.replica_id:
        print("--fleet-peers/--replica-id need --fleet-listen "
              "(the peer protocol endpoint)", file=sys.stderr)
        return 2
    mesh = None
    if args.distributed:
        # torch.distributed from the standard env; at a world size above
        # 1 the background scan shards over the processes' mesh.
        # Anything short of a working topology logs and stays
        # single-host — the fleet layer above is what carries the
        # process-level story either way.
        mesh = _init_distributed(args.device)
    exporter = None
    if args.trace_export:
        from ..observability.tracing import (OTLPJsonFileExporter,
                                             global_tracer)

        exporter = OTLPJsonFileExporter(args.trace_export)
        global_tracer.add_exporter(exporter)
        global_oplog.emit("trace_export_enabled", path=args.trace_export)
    cp = ControlPlane(policies, port=args.port, metrics_port=args.metrics_port,
                      cert=args.cert, key=args.key,
                      configuration=configuration, toggles=toggles,
                      batching=args.batching, batch_config=batch_config,
                      mutate_batching=args.mutate_batching,
                      request_timeout_s=args.request_timeout_s,
                      policy_watch=args.policy_watch,
                      reload_interval=args.reload_interval,
                      flight_sample_rate=args.flight_sample_rate,
                      flight_capacity=args.flight_capacity,
                      flight_dir=args.flight_dir,
                      shadow_verify_rate=args.shadow_verify_rate,
                      analyze_on_swap=args.analyze_on_swap,
                      classify_config=classify_config,
                      fleet_config=fleet_config, mesh=mesh,
                      device=args.device)
    if fleet_config is not None and cp.fleet is not None:
        global_oplog.emit("fleet_enabled",
                          replica_id=fleet_config.replica_id,
                          listen=cp.fleet.url,
                          peers=list(fleet_config.peers),
                          lease_s=fleet_config.lease_s,
                          shards=fleet_config.num_shards)
    if args.analyze_on_swap:
        global_oplog.emit("analyze_on_swap_enabled")
    if args.policy_watch:
        global_oplog.emit("policy_watch_enabled", dir=args.policy_watch,
                          interval_s=args.reload_interval)
    if args.flight_dir:
        global_oplog.emit("flight_spool_enabled", dir=args.flight_dir)
    if args.shadow_verify_rate:
        global_oplog.emit("shadow_verification_enabled",
                          rate=args.shadow_verify_rate)
    from ..resilience.faults import global_faults

    armed = global_faults.armed()
    if armed:
        # chaos runs must be unmistakable in the serve log
        global_oplog.emit("faults_armed", level="warn",
                          sites=sorted(armed))
    cp.start(args.scan_interval)
    global_oplog.emit("serve_started", admission_port=cp.admission.port,
                      metrics_port=cp.metrics_server.server_address[1],
                      policies=len(policies))
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    cp.stop()
    if exporter is not None:
        exporter.close()
    return 0
