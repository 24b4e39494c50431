#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (kyverno_tpu_torch) on one GPU.

    python3 chip_smoke.py [--n 16384] [--scan-n 50000] [--tile 8192]
        [--tenant-n 16384] [--tenant-batch 1024] [--mutate-n 4000]
        [--mutate-tile 1024] [--adm-requests 20000] [--adm-bulk 10000]
        [--reports-n 40000] [--seed 0]

Phases, each printed as it runs; any failure raises and exits nonzero:

1. the card (``nvidia-smi --query-gpu=name,power.limit``);
2. the kernel build (one ``nvcc`` per CUDA source, started together)
   and each kernel's registers;
3. every kernel against its plain PyTorch twin on the card, exactly:
   K1 at strides 1, 2 and 4 on the PSS bank and on an approximated
   small-budget bank, over seeded subjects with non-ASCII bytes and
   lengths that are not multiples of the stride; K3's one-level entry
   with 1 and 5 predicates (counts, any, both; contiguous, strided,
   unaligned and broadcast) and its two-level entry, on the main path's
   scopes and on hazard scopes (-1, >= I, valid zeros); K4 on a seeded
   table at the dense shape; and, on one
   encoded tile of the background scan (its vocabulary lanes and
   shapes), K5 over index widths uint8, uint16 and int32 with hostile
   indices (its launch plan, its time with no, the tile's and every
   cell gathering a live row, and a fill of its output bytes beside
   it), K6 with 0, 1, 5 and 40 constants, K7 on a strided DFA accept
   column (and its form), K8 (and on seeded masks at the dense shape,
   16,384 x 256), and K4's uint8 output (K4 and K8 each timed on its
   inputs, L2-warm, and on copies rotated past the L2, beside its byte
   bound and one launch's floor, with the form its plan function
   picks); K9's packed launch
   over the tenant's NFA-route globs and every pattern class (packs of
   one 32-bit word and of 1, 2 and 8 64-bit words) on the tenant batch's
   namespace, name and pool lanes with real and hostile lengths, its
   pack of one there and on 320-byte seeded subjects (state words 2 to
   16), and B4's standalone non-ASCII entry at the tenant scan and
   triage shapes (the namespace lane and seeded subjects); K1's
   non-ASCII flag from both entries (the walk of pattern 0) on seeded
   ASCII subjects with an accented letter inside and past the length,
   and at the tenant bank's shapes, timed with and without the flag;
   K10 ``meta_any`` on the
   tenant policy's 3,264-entry ``namespaces`` list at the tenant scan
   and triage shapes, under every tile a block may serve; K12
   ``row_fold`` on the dense lanes at the main shape, a seeded tape of
   every instruction over lanes of every element type. Each is timed
   by CUDA-graph replay beside its plain twin and its library yardstick;
4. the dense path: ``TorchEngine(PSS).scan`` on N seeded resources
   (Pod / Deployment / CronJob / Service): the completed table over all
   rules (codes 0..4), its launch counts and the program's K3 counts,
   memo hits and launches (at most 1,065), the device table of ``run``
   against the same program with the plain twins, a small input
   against the CPU run, and the time of encode, host-to-device copy,
   program (median of 5) and readback. The stride-1 scan entry runs on
   the same path with ``KYVERNO_TPU_DFA_STRIDE=1``;
5. the background scan path: ``ShardedScanner(PSS).scan_stream`` over
   a 50,000-resource snapshot (``--scan-n``) in 8,192-resource tiles
   (the vocabulary
   form): its coverage, stats and resources/s, its launch counts, the
   first tile against the dense ``TorchEngine``, the step against the
   plain-twin step, 257 resources against the CPU scanner, the
   steady-state step time on one resident tile (median of 5), a check
   that the step never waits for the device, and the tile's lane bytes
   against the dense form's;
6. the ``kernels`` JSON line (launches by path: dense, background
   scan, tenant validate, tenant triage, mutate leg; the standalone
   non-ASCII entry must launch on none: each path's K1 launches give
   the flags), then the device JSON line (last line);
7. the tenant path: the 18 PSS policies and a tenant policy (a
   validate and a mutate rule over 3,200 + 64 namespace globs) that
   fill the DFA bank's 60,000 states, so hundreds of globs run on K9:
   its bank split, ``TorchEngine.scan`` of 16,384 seeded Pods and
   Namespaces (equal to the plain-twin program on the same lanes and,
   on a slice, to the CPU run), and ``triage_mutate`` in batches of
   1,024, each with its launch counts (K9: at most 4 a program run, no
   glob outside the compiled packs) and times;
8. bench.py's mutate leg at its own sizes: ``triage_mutate`` over 4,000
   Pods (1 in 20 in ``prod``) in tiles of 1,024, ``apply_mutations``
   over every routed resource, every patched output against the port's
   scalar chain and every negative unchanged, and an all-negative batch
   of 512 costing one device dispatch and no patcher call.

9. the guarded dispatch ladder on the card: an armed ``tpu.dispatch``
   fault (the breaker trips after two failures and the third scan never
   tries the device), a corrupt-shape fault and its half-open probe, the
   three hostile resources (``metadata: "x"``, ``kind: 7``,
   ``metadata.namespace: ["x"]``) through ``TorchEngine.scan`` and
   ``ShardedScanner.scan``, a device fault in ``ShardedScanner.scan``,
   and an armed ``mutate.triage`` fault: every table equals the clean
   scan and the CPU run, the triage batch is all-HOST and patches as the
   clean one.
10. the pipelined background scan: phase 5's snapshot through
   ``tpu/pipeline.py:PipelinedScanner`` in chunks of the tile, (a) fed
   by an encode thread, (b) by an encoder pool of min(8, cpu_count - 2)
   worker processes, (c) its first 2 tiles cold and then warm in a
   columnar store (a temporary directory) with the encode cache on
   (cut from all 13 for the time limit): resources/s,
   ``encode_s``, ``encode_wait_s``, ``device_s``, ``host_s`` and
   ``overlap_ratio`` of each; each table equals phase 5's, the pool
   encodes every chunk (no bypass, no infra failure, no worker that
   loaded torch or JAX), the warm rescan walks no JSON. Then a repeat
   ``TorchEngine.scan`` of the dense batch with the verdict cache on
   (its table equals the cold one; the hit rate is printed). Phases 3
   to 9 run with both content caches off and no columnar store, so
   they time the device, not cache hits.
11. admission serving (``serving/``, ``lifecycle/``): the 18 PSS
   policies (66 device rules) in ``TorchEngine(...,
   EncodeConfig(max_rows=128))``, its buckets 16, 32 and 64 warmed twice
   each (the eager run, then the capture), both content caches off;
   ``AdmissionPipeline`` over the admission server's evaluator core.
   (a) bench.py's config #5: 10,000 requests (``--adm-requests``; the
   bench's 50,000 cut for the time limit) from 64 threads over 2,048
   seeded resources, the flight recorder at its default sampling and
   the shadow verifier at rate 0.1: requests/s, latency p50 / p99 /
   p99.9, flushes by bucket and reason, the mean batch, eager runs,
   captures and replays by bucket (one capture each); (b) bench.py's
   mixed traffic (its ``BatchConfig``, a one-resource scan as the
   scalar fallback): 200 unloaded critical requests, then 5,000 bulk
   (``--adm-bulk``; the bench's 20,000 cut) from 32 threads beside 400
   critical at 2 ms spacing: critical p99 unloaded and loaded, bulk
   shed, hedges and their winners; (c) a ``PolicySetLifecycleManager``
   (worker started, ``warm=True`` at the three buckets) behind the
   pipeline's ``version_provider`` while 8 threads submit at least
   4,000 requests: a policy added, then a policy whose compile faults
   (``policyset.compile``, two raises) and is quarantined to the host:
   swaps, quarantine entries, flushes by revision, captures by thread.
   Gates: every answer equals a CPU engine's (plain twins) rows for its
   resource under the revision its flush pinned; no divergence of the
   verifier; every flush on the device; no kernel error; captures in
   (c)'s traffic only on the worker. Then each bucket's flush: its
   launches, its program call's device time, each kernel's trace time,
   and ``graph_check`` (replay == eager == plain twins at every bucket;
   the kernels timed at 64 alone, the admission path's row of the
   ``graphs`` lines).
12. incremental reports and the background scan service
   (``cluster/scanner.py``, ``reports/``): bench.py's soak (config #17)
   at 40,000 lean Pods in 16 namespaces (``--reports-n``; the bench's
   1,000,000 cut for the time limit), the 18 PSS policies in a
   ``PolicyCache``, a journaled ``ReportStore`` in a temporary
   directory (the bench's journal cap, 1 GiB), the flight recorder
   sampling 0.001 and the shadow verifier at rate 1.0. (a) the fill, ``scan_once(full=True)``, 10 churn ticks
   of 2,000 (``random.Random(1729)``: 80 % re-revisioned upserts, 10 %
   adds, 10 % deletes), an unchanged tick; (b) 5 churn ticks under the
   bench's ambient faults (``tpu.dispatch`` p 0.01, ``reports.fold`` and
   ``reports.journal`` p 0.005); (c) the store closed (a compaction
   of every row, timed) and reopened; (d) a fresh store, the verdict
   cache emptied, a new service's full scan.
   Each tick prints its dirty count, chunks, wall time, the pipeline's
   ``encode_s`` / ``device_s`` / ``host_s`` / ``overlap_ratio`` and the
   report side (the service's report callback, timed by wrapping the
   pipeline's ``on_result``; in it the aggregator's ``put``, the
   store's ``apply`` and the flight records, each wrapped), its folds,
   journal records and RSS; then recoveries by reason, the step graph's
   keys. Gates: the unchanged tick does no fold and no journal record;
   the digest equals ``rebuild()`` after (a) and (b); the reopened
   digest equals the closed one; (d)'s digest equals the churned
   store's; the verifier checks at least one record and finds no
   divergence; no scan-freshness breach; the store's rows of 2,048
   seeded live uids (every live uid of the last tick among them; its
   deleted ones absent) equal a CPU ``ShardedScanner`` (plain twins)
   scan's; no kernel error; at most four graph keys for the step.
13. policy-set analysis (``analysis/``): bench.py's analyze config, PSS
   plus ``tests/golden/analysis/seeded_anomalies.yaml`` in one
   ``TorchEngine``, ``analyze_engine(tile=256)`` cold and warm:
   witnesses, tiles, anomalies by kind, confirm checked / confirmed /
   refuted, each phase's seconds and the program's graph keys. Gates:
   every anomaly class found, none refuted, none outside the seeded
   policies; the report and the verdict table equal a CPU engine's
   (plain twins); the clean corpus gives no anomaly on the card. Then
   the lifecycle's lint under traffic: phase 11 (c)'s manager and
   pipeline (buckets 16 / 32 / 64 warmed) with ``analyze_on_swap``, 8
   threads submitting, a policy added so the worker swaps and lints:
   the lint's seconds and outcome, latency p50 / p99 before, during and
   after it, each admission bucket's eager runs, captures and replays
   before and after it, the captures by thread. Gates: every answer
   equals a CPU engine's rows under the revision its flush pinned; the
   lint's outcome is ``ok``; no admission bucket's graph is evicted or
   captured again after the lint.
14. the sharded scan on a mesh of CUDA devices (``parallel/``, one
   process's devices; a card repeats when the machine has fewer cards
   than the mesh has entries, and the phase prints how many are
   distinct): phase 5's snapshot in 8,192 tiles on
   ``make_mesh()`` (every card) and on ``make_mesh_2d(2, 2, devs)``
   (``devs`` = ``cuda:(i % count)`` for i < 4), each through
   ``scan_stream`` (cold, then warm) and ``PipelinedScanner`` (an encode
   thread), beside the one-device scanner's warm ``scan_stream``: every
   table equal to the one-device table, the first tile's uint8 table and
   counts equal to the one-device scanner's, every scan kernel launched
   on every distinct device (``ShardedScanner.device_launches``); (b)
   ``dryrun.dryrun_multichip(4, devs)``; (c) two in-process fleet
   replicas (``fleet/``) on one ``LeaseStore``, their peer servers on
   localhost, each a ``BackgroundScanService`` on the 2 x 2 mesh over
   20,000 lean Pods with a report store of its own: the owned shards
   partition the keyspace, the two stores' rows are a one-replica
   store's, and after one replica leaves gracefully the other's takeover
   rescan gives the one-replica store's digest. Both caches off.
15. the admission webhook server and its entry points
   (``webhooks/server.py``, ``cli/serve.py``, ``cli/apply.py``): (a) a
   ``ControlPlane`` on the card with ``--batching`` and
   ``--mutate-batching`` over PSS (Audit), a mutate policy, a
   digest-only verifyImages policy and an Enforce policy answers 2,048
   seeded AdmissionReviews over HTTP
   (``/validate``, ``/mutate`` and one PSS policy's fine-grained path)
   from 4 client threads of another process (``http_load``; fewer
   than the server's accept backlog of 5):
   requests/s, p50, p99 with and without the requests that overlap a
   bucket's eager run or capture, the requests of 1 s or more, the
   eager runs and captures by thread and batch, then its scan service
   over a 512 resource snapshot, and the launches of the traffic and the
   scan. Gates: a seeded 256 of the answers, some of them denied, and
   the admission report rows of their resources (the Audit verdicts)
   equal a CPU ``Handlers``' (plain twins; their columns computed first
   in three batched CPU scans and taken from the verdict cache,
   ``cpu_prewarm``), the rows hold both passes and failures, the scan's
   rows equal a CPU scan service's, every validate
   and mutate-triage flush ran on the card, every kernel of the dense
   and scan paths launched; (b) bench.py's ``churn`` config (32
   workers, 8 s, the churned policy re-set every 50 ms, ``BatchConfig
   (64, 2.0, 30,000, 120)``): requests/s, p50 / p99, swaps, revisions
   served, the eager runs and captures by thread; gates: no error, no
   kernel error, at least one swap; (c) ``python -m kyverno_tpu_torch
   serve`` as a process (ready, one ``/validate``, ``/metrics``,
   SIGTERM exits 0) and ``apply --engine tpu`` against ``--engine
   scalar`` on one resource directory (the same exit code, summary and
   failing (policy, rule, resource) rows). Both caches off in (a) and
   (b).
16. the CLI and the background controllers (``cli/analyze.py``,
   ``cli/test.py``, ``cli/chainsaw.py`` over ``background/`` and
   ``cluster/cleanup.py``, ``cli/report.py``, ``cli/lint.py``), each
   command a ``python -m kyverno_tpu_torch`` process, all started
   together: (a) ``analyze`` of bench.py's analyze corpus (PSS plus the
   seeded anomalies, tile 256) on the card, in this process (with
   ``--fail-on any``, its launches counted) and as a process with no
   ``--device``, each report (timings aside) and exit code equal to a
   ``--device cpu`` process's of the same command; (b) ``test
   tests/cli-tests`` exits 0 with the in-process run's output; (c)
   ``chainsaw`` over a tree the phase writes (``CHAINSAW_SCENARIOS``:
   generate from data with ``synchronize`` and the trigger deleted,
   generate by clone, mutate-existing, a scheduled
   ``ClusterCleanupPolicy``, an Enforce denial checked with an ``error``
   step): every scenario passes; (d) ``report --rebuild-check`` on phase
   12's journal directory and ``lint --json`` on the port exit 0, the
   lint's findings all in the port's baseline.
17. the mesh across processes (``parallel/sharding.py`` over
   ``torch.distributed``, gloo): (a) two rank processes (``python3
   chip_smoke.py xproc-rank``; ``MASTER_ADDR``, ``MASTER_PORT``,
   ``WORLD_SIZE=2``, ``RANK``), both on ``cuda:0``, each a
   ``ShardedScanner(PSS, mesh=make_mesh_2d(2, 1))`` over all of phase
   14's snapshot (``--scan-n``): a cold and a warm
   ``scan_stream``, one ``scan`` of the first tile and its
   ``scan_device``; every rank's tables and counts equal this process's
   one-device scan, bit for bit, and every scan kernel launched on
   every rank in the warm scan (each rank's launches printed); (b) two
   ``python -m kyverno_tpu_torch serve --distributed`` processes of the
   same environment and policies (PSS) and a single ``serve``, all on
   the card: both ranks log ``distributed_initialized`` with ``hosts=2``
   and ``per_host=1``, the same 1,024 ``/snapshot/upsert`` calls go to
   all three, one ``/scan`` to both ranks at once: each rank's summary
   equals the single ``serve``'s. Every child runs under a hard
   timeout; one that exits nonzero, times out or disagrees fails the
   run.

On every path (dense, step, tenant scan, tenant triage, mutate leg) the
program runs as one CUDA graph per shape bucket (``tpu/graphs.py``): the
replay equals the eager program and the plain-twin program exactly, with
the same launches and stats, and the phase prints eager and replayed
times, captures, the aten operations issued per eager run and per
replayed call, the device events of one replay, and the program's byte
bound (its lanes read once, its outputs written once). Every K11
``class_fold`` launch of an eager run (one a rule: the rule's class
logic, recorded on its tape by ``tpu/fold.py``) is held against its
plain twin on the same inputs, exactly, and the values forced off the
tapes (``fold_forced``) are printed, and so is every K12 ``row_fold``
launch of the same run (the rule's row-plane logic, recorded on its row
tape by ``tpu/rowfold.py``), with the values forced off the row tapes
(``rows_forced``), the run's K6 launches and its torch reductions over
rows (none may remain on the dense path) and the K12 launches that
split a rule's flush (one K12 launch a rule otherwise); K12 is timed
over the run's launches beside its plain twin and bound, and on the
dense path the launches' own bytes are summed against the bound's
distinct bytes and its slowest launches are printed with their launch
plan (warps, tile, the blocks an SM holds), their bytes, a
device-to-device copy of their inputs for a yardstick, and their time
at every warp count (each held against its twin); each path's K12
launches are counted by fill unit (uint8 batches, 4-byte lanes, hash
lanes); every K7 ``pool_rows`` launch of the same run is kept
(``Keep``), held against its twin and timed (``time_pool_rows``):
the run's launches together on the run's own lanes (which several
launches share) beside their twins, ``torch.gather`` and a bound that
reads each distinct lane once; the same launches on copies with their
own storage, rotated through more bytes than the L2 holds
(``rotated_ms``), beside a bound that reads each launch's lanes; their
time in the replay's device trace; and each distinct shape alone on
rotated copies with its plane's K, strides and the kernel's form;
every K4 ``verdict_counts`` and K8 ``first_true_take`` launch of the
same run is kept too, held against its twin and timed together on the
run's own inputs and on rotated copies, beside their byte bound, their
time in the replay's trace and a launch's floor (``time_kept``); the
replay's device-to-device copies are counted;
K11 is also timed over the run's launches (kept from that run) beside
its plain twin and bound, at the
lane counts the host chose and at every lane count G (each launch held
against its twin under each); on the dense path its slowest launches
are timed alone at every G, the eager run's aten operations are counted by output shape kind
and call site and its torch kernels' device time by call site
(``Sites``, ``op_census``, ``device_profile``), and the replay's 15
longest kernels are printed. A ``torch.profiler`` trace of the dense
program, eager and replayed, gives the device's busy share. The port's breaker and metrics
are reset before each phase; after each phase but the fault phase the
script fails unless no ``breaker_fallback`` was counted, the last
dispatch went to the device and the breaker is closed.

Phases 7 and 8 run after phase 5, then phases 9 to 17; phase 6's
lines come last (the kernels line gives launches by path, the admission
path's from part (a), the reports tick path's from phase 12 (a)'s churn
ticks, the analysis tile path's from phase 13's warm run, the mesh scan
path's from phase 14's warm ``scan_stream`` on the 2 x 2 mesh, with its
launches by device, the server path's from phase 15 (a)'s traffic and
scan, the analyze_cli path's from phase 16 (a)'s ``analyze`` in this
process, the xproc path's from phase 17 (a)'s warm ``scan_stream``,
summed over its two ranks, and each kernel's launches and trace time in
one flush at each admission bucket).

Every number is printed with the card's name and power limit. Without
CUDA, or without the ``kyverno_tpu_torch`` package beside this file, it
exits nonzero before printing any result. It imports nothing of JAX
and nothing of ``kyverno_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data sheet figures (the bound of each kernel)
HBM_BYTES_PER_S = 3.35e12
# no integer rate is published beside the tensor-core ones; the
# non-tensor fp32 rate (67 TFLOP/s) stands for the int32 ALU work
ALU_OPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20  # the H100 SXM's L2 cache

KERNEL_META = {
    "dfa_scan_fused": ("kyverno_tpu_torch/csrc/dfa_scan.cu",
                       "kyverno_tpu/tpu/dfa.py:1155"),
    "dfa_scan_stride1": ("kyverno_tpu_torch/csrc/dfa_scan.cu",
                         "kyverno_tpu/tpu/dfa.py:1128"),
    "instance_count": ("kyverno_tpu_torch/csrc/instance_count.cu",
                       "kyverno_tpu/tpu/evaluator.py:454"),
    "instance_count2": ("kyverno_tpu_torch/csrc/instance_count.cu",
                        "kyverno_tpu/tpu/evaluator.py:469"),
    "verdict_counts": ("kyverno_tpu_torch/csrc/verdict_counts.cu",
                       "kyverno_tpu/tpu/evaluator.py:1946"),
    "verdict_counts_u8": ("kyverno_tpu_torch/csrc/verdict_counts.cu",
                          "kyverno_tpu/parallel/sharding.py:100"),
    "vocab_gather": ("kyverno_tpu_torch/csrc/vocab_gather.cu",
                     "kyverno_tpu/tpu/evaluator.py:144"),
    "vocab_gather_rows": ("kyverno_tpu_torch/csrc/vocab_gather.cu",
                          "kyverno_tpu/tpu/evaluator.py:156"),
    "hash_match": ("kyverno_tpu_torch/csrc/hash_match.cu",
                   "kyverno_tpu/tpu/evaluator.py:222"),
    "pool_rows": ("kyverno_tpu_torch/csrc/pool_rows.cu",
                  "kyverno_tpu/tpu/evaluator.py:361"),
    "first_true_take": ("kyverno_tpu_torch/csrc/first_true_take.cu",
                        "kyverno_tpu/tpu/evaluator.py:641"),
    "nonascii": ("kyverno_tpu_torch/csrc/dfa_scan.cu",
                 "kyverno_tpu/tpu/dfa.py:1246"),
    "glob_nfa": ("kyverno_tpu_torch/csrc/glob_nfa.cu",
                 "kyverno_tpu/tpu/evaluator.py:386"),
    "meta_any": ("kyverno_tpu_torch/csrc/meta_any.cu",
                 "kyverno_tpu/tpu/evaluator.py:1589"),
    "class_fold": ("kyverno_tpu_torch/csrc/class_fold.cu",
                   "kyverno_tpu/tpu/evaluator.py:1886"),
    "row_fold": ("kyverno_tpu_torch/csrc/row_fold.cu",
                 "kyverno_tpu/tpu/evaluator.py:480"),
}
PATHS = ("dense", "background_scan", "tenant_validate", "tenant_triage",
         "mutate_leg")

# the kernels each path must launch
DENSE_KERNELS = ("dfa_scan_fused", "instance_count", "instance_count2",
                 "verdict_counts", "hash_match", "pool_rows",
                 "first_true_take", "class_fold", "row_fold")
SCAN_KERNELS = ("vocab_gather", "vocab_gather_rows", "hash_match",
                "pool_rows", "first_true_take", "verdict_counts_u8",
                "dfa_scan_fused", "instance_count", "instance_count2",
                "class_fold", "row_fold")
TENANT_KERNELS = ("glob_nfa", "meta_any", "class_fold", "row_fold")
# the mutate triage programs match on metadata alone: no row planes
TRIAGE_KERNELS = ("glob_nfa", "meta_any", "class_fold")
# kernels no path may launch: every family whose non-ASCII flag a path
# needs is scanned by one of its K1 launches, which writes the flag
# (the standalone entry serves a family no K1 launch scans)
NOT_ON_A_PATH = ("nonascii",)
# eager aten operations a tenant triage batch may issue (46,747 before
# K10 took the per-entry loop over the namespace globs)
TRIAGE_OPS_MAX = 5000
# one-level K3 launches the dense PSS program may issue: its 1,875
# counts less the memo's hits on identical row masks
DENSE_K3_MAX = 1065

# the tenant policy's namespace globs, and the split of them between
# the DFA bank and the NFA route that compile_policy_set gives beside
# the 18 PSS policies under the default 60,000-state cap (computed on
# the CPU with the same compiler): (in the bank, on the NFA route)
TENANT_GLOBS = ([f"tenant-{i:05d}-*-prod" for i in range(3200)]
                + [f"t{i:03d}-??-*" for i in range(64)])
TENANT_SPLIT = (2997, 267)
# phase 10 (c): tiles of the snapshot through the columnar store (its
# cold fill cut from the whole snapshot's 13 tiles to keep the run
# within its limit)
COLUMNAR_CHUNKS = 2


class PhaseClock:
    """Wall seconds of each phase of ``main`` (from its mark to the next),
    printed with the kernels line: what to cut first when the run nears
    its limit."""

    def __init__(self):
        self.seconds = {}
        self._at = None

    def mark(self, phase) -> None:
        now = time.perf_counter()
        if self._at is not None:
            name, t0 = self._at
            self.seconds[name] = round(now - t0, 3)
        self._at = None if phase is None else (phase, now)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# seeded PSS-style workload (Pod / Deployment / CronJob / Service)


def _sec_ctx(rng, pod_level=False):
    out = {}
    if rng.random() < 0.3:
        out["privileged"] = rng.choice([True, False, "false", "true"])
    if rng.random() < 0.3:
        out["allowPrivilegeEscalation"] = rng.choice([True, False])
    if rng.random() < 0.3:
        out["runAsNonRoot"] = rng.choice([True, False])
    if rng.random() < 0.3:
        out["runAsUser"] = rng.choice([0, 1000, "0", 65535])
    if rng.random() < 0.25:
        out["seccompProfile"] = {"type": rng.choice(
            ["RuntimeDefault", "Localhost", "Unconfined", None])}
    if rng.random() < 0.2:
        out["seLinuxOptions"] = {"type": rng.choice(["container_t", "spc_t"])}
    if rng.random() < 0.2:
        out["capabilities"] = {rng.choice(["add", "drop"]): rng.sample(
            ["ALL", "CHOWN", "SYS_ADMIN", "KILL", "NET_RAW",
             "NET_BIND_SERVICE"], k=rng.randint(0, 3))}
    if not pod_level and rng.random() < 0.2:
        out["procMount"] = rng.choice(["Default", "Unmasked"])
    if not pod_level and rng.random() < 0.15:
        out["windowsOptions"] = {"hostProcess": rng.choice([True, False])}
    if pod_level and rng.random() < 0.2:
        out["sysctls"] = [{"name": rng.choice(
            ["kernel.shm_rmid_forced", "net.core.somaxconn"]), "value": "1"}]
    return out


def _container(rng, name):
    c = {"name": name, "image": rng.choice(["nginx", "docker.io/redis:7",
                                            "evil.io/x"])}
    sc = _sec_ctx(rng)
    if sc or rng.random() < 0.3:
        c["securityContext"] = sc
    if rng.random() < 0.25:
        port = {"containerPort": 80}
        if rng.random() < 0.5:
            port["hostPort"] = rng.choice([0, 8080])
        c["ports"] = [port]
    return c


def _pod_spec(rng):
    spec = {"containers": [_container(rng, f"c{i}")
                           for i in range(rng.randint(1, 3))]}
    if rng.random() < 0.3:
        spec["initContainers"] = [_container(rng, "init")]
    if rng.random() < 0.15:
        spec["ephemeralContainers"] = [_container(rng, "dbg")]
    for key in ("hostPID", "hostIPC", "hostNetwork"):
        if rng.random() < 0.2:
            spec[key] = rng.choice([True, False])
    if rng.random() < 0.35:
        kinds = ["emptyDir", "configMap", "hostPath", "secret", "nfs"]
        spec["volumes"] = [{"name": f"v{i}", (k := rng.choice(kinds)):
                            ({"path": "/"} if k == "hostPath" else {})}
                           for i in range(rng.randint(1, 3))]
    sc = _sec_ctx(rng, pod_level=True)
    if sc:
        spec["securityContext"] = sc
    return spec


def workload(n: int, seed: int):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        kind = rng.choice(["Pod"] * 4 + ["Deployment", "CronJob", "Service"])
        meta = {"name": f"r{i}",
                "namespace": rng.choice(["default", "prod", "kube-system"])}
        if rng.random() < 0.2:
            meta["annotations"] = {
                "container.apparmor.security.beta.kubernetes.io/c0":
                    rng.choice(["runtime/default", "localhost/prof",
                                "unconfined"])}
        if kind == "Pod":
            out.append({"apiVersion": "v1", "kind": "Pod", "metadata": meta,
                        "spec": _pod_spec(rng)})
        elif kind == "Deployment":
            out.append({"apiVersion": "apps/v1", "kind": "Deployment",
                        "metadata": meta,
                        "spec": {"replicas": 1, "template": {
                            "metadata": {"labels": {"app": "x"}},
                            "spec": _pod_spec(rng)}}})
        elif kind == "CronJob":
            out.append({"apiVersion": "batch/v1", "kind": "CronJob",
                        "metadata": meta,
                        "spec": {"schedule": "* * * * *", "jobTemplate": {
                            "spec": {"template": {"spec": _pod_spec(rng)}}}}})
        else:
            out.append({"apiVersion": "v1", "kind": "Service",
                        "metadata": meta, "spec": {"ports": [{"port": 80}]}})
    ops = [rng.choice(["", "CREATE", "UPDATE", "DELETE"]) for _ in out]
    return out, ops


# ---------------------------------------------------------------------------
# measurement helpers


def eager_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Mean time of one call of ``fn`` over ``reps`` back-to-back eager
    calls (CUDA events around the loop, after a warm-up). For a short
    kernel this is the host's issue rate (wrapper checks, allocation,
    the ctypes call), not the kernel."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of one call of ``fn``: ``reps`` calls captured
    in one CUDA graph, replayed once between two CUDA events, so no
    host work falls inside the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def timed(torch, kfn, pfn, lib=None, plain_reps: int = 3,
          plain_eager: bool = False):
    """The kernel's device time (graph replay) and its eager issue
    time, the plain version's device time (its eager time, CUDA events
    around one call, with ``plain_eager``: a plain version of hundreds
    of thousands of small ops) and the library call's device time."""
    plain = eager_ms(torch, pfn, reps=1, warm=1) if plain_eager \
        else graph_ms(torch, pfn, reps=plain_reps, warm=1)
    return {"ms": graph_ms(torch, kfn), "eager_ms": eager_ms(torch, kfn),
            "plain_ms": plain,
            "library_ms": None if lib is None else graph_ms(torch, lib)}


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def exact(torch, name: str, got, want) -> float:
    """Max |kernel - plain| over int/bool outputs (float outputs as
    their bit patterns); raises unless 0."""
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel {tuple(got.shape)} {got.dtype}"
                             f" vs plain {tuple(want.shape)} {want.dtype}")
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0.0
    if err != 0.0:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {err})")
    return err


def zero_stats(fn):
    fn.stats.update(dict.fromkeys(fn.stats, 0))


def program_stats(fn):
    """A program's K3 requests, memo hits and kernel calls issued, and
    the NFA-route globs outside its packs, since ``zero_stats``."""
    st = dict(fn.stats)
    return (f"K3 one level {st['inst_calls']} counts, {st['inst_hits']} memo "
            f"hits, {st['inst_issued']} launches; two levels "
            f"{st['inst2_calls']} counts, {st['inst2_hits']} hits, "
            f"{st['inst2_issued']} launches; unrecorded NFA globs "
            f"{st['nfa_unpacked']}"), st


def program_ops(torch, kernels, fn):
    """Runs ``fn`` once and counts what the host issued for it: the aten
    operations dispatched (each a kernel launch on the card, or a view)
    and the launches of the port's own kernels."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    before = sum(kernels.LAUNCHES.values())
    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n, sum(kernels.LAUNCHES.values()) - before


# the evaluator functions whose device time and aten operations are
# told apart by call site (each run under a ``record_function`` range)
SITES = ("eval_rule", "eval_match", "eval_cond_tree", "eval_cond",
         "eval_node", "_eval_map", "_eval_leaf", "_eval_array_maps",
         "_eval_array_scalar", "_eval_existence", "_eval_wildcard_anchor",
         "_first_nonpass", "_eval_foreach_deny", "_eval_condition_block",
         "_glob_fallback", "leaf_row_pred", "_cmp_pred", "_meta_heq",
         "_pairs_any", "_hash_in_lanes")
# the kernel entries (and their plain twins) the evaluator calls: their
# own operations and device time are the kernels', not the program's
KERNEL_SITES = ("scope8", "instance_count_many", "instance_count_many_plain",
                "instance_count2", "instance_count_plain", "hash_match",
                "hash_match_plain", "pool_rows", "pool_rows_plain",
                "first_true_take", "first_true_take_plain", "glob_nfa",
                "glob_nfa_plain", "glob_nfa_pack", "glob_nfa_pack_plain",
                "meta_any", "meta_any_plain", "verdict_counts",
                "verdict_counts_plain", "verdict_counts_u8",
                "verdict_counts_u8_plain", "vocab_gather",
                "vocab_gather_plain", "vocab_gather_rows",
                "vocab_gather_rows_plain", "class_fold", "class_fold_plain",
                "row_fold", "row_fold_plain")


class Sites:
    """While entered, the evaluator's functions named in ``SITES`` run
    inside a ``torch.profiler.record_function("site:<name>")`` range and
    keep a stack of the sites entered (``current()``, the innermost);
    the kernel entries of ``KERNEL_SITES`` and the DFA scans
    (``bank_match``, ``nonascii_mask``) do so as "kernel:<name>"."""

    def __init__(self, ev):
        from kyverno_tpu_torch import kernels

        self.targets = [(ev, n, n) for n in SITES if hasattr(ev, n)]
        self.targets += [(ev, n, "kernel:" + n)
                         for n in ("bank_match", "nonascii_mask")]
        self.targets += [(kernels, n, "kernel:" + n) for n in KERNEL_SITES
                         if hasattr(kernels, n)]
        self.stack, self.saved = [], []

    def __enter__(self):
        from torch.profiler import record_function

        for mod, name, label in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _label=label, **k):
                self.stack.append(_label)
                try:
                    with record_function("site:" + _label):
                        return _fn(*a, **k)
                finally:
                    self.stack.pop()

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)

    def current(self) -> str:
        return self.stack[-1] if self.stack else "build_program.run"


def shape_kind(shape, N, I, R) -> str:
    """An output's shape as the program's layers see it."""
    shape = tuple(shape)
    for kind, want in (("N", (N,)), ("NI", (N, I)), ("NIJ", (N, I, I)),
                       ("NR", (N, R))):
        if shape == want:
            return kind
    return "0-d" if not shape else "other"


def op_census(torch, fn, N, I, R, sites=None):
    """The non-view aten operations one call of ``fn`` dispatches, by
    the shape kind of their first output and, with ``sites``, by the
    innermost evaluator call site; with ``sites``, those inside a kernel
    entry or its plain twin count as kind "kernel" (on the card a
    kernel's wrapper issues only its output allocations)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    kinds, by_site = {}, {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                first = out[0] if isinstance(out, (tuple, list)) and out \
                    else out
                kind = shape_kind(first.shape, N, I, R) \
                    if isinstance(first, torch.Tensor) else "other"
                site = sites.current() if sites is not None else None
                if site is not None and site.startswith("kernel:"):
                    kind = "kernel"
                kinds[kind] = kinds.get(kind, 0) + 1
                if site is not None:
                    s = by_site.setdefault(site, {})
                    s[kind] = s.get(kind, 0) + 1
            return out

    with Count():
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"by_kind": kinds, "total": sum(kinds.values()),
            "class_logic": sum(kinds.get(k, 0) for k in ("N", "NI", "NIJ")),
            "by_site": by_site}


def device_profile(torch, fn, sites=None, top: int = 15):
    """One call of ``fn`` under ``torch.profiler``: device events and
    their time by kernel name (all, and the ``top`` longest), and with
    ``sites``
    the device time of each innermost evaluator call site (kernels
    charged to the range that launched them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, n_dev, dev_us = {}, 0, 0.0
    site_us = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("site:"):
                continue  # a range's span on the device's timeline
            us = e.time_range.end - e.time_range.start
            n_dev += 1
            dev_us += us
            c, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (c + 1, t + us)
            continue
        ks = getattr(e, "kernels", None)
        if sites is None or not ks:
            continue
        p, site = e, "build_program.run"
        while p is not None:
            if p.name.startswith("site:"):
                site = p.name[5:]
                break
            p = p.cpu_parent
        site_us[site] = site_us.get(site, 0.0) + sum(k.duration for k in ks)
    ranked = [{"name": k[:120], "calls": c, "ms": t / 1e3} for k, (c, t)
              in sorted(by_name.items(), key=lambda kv: -kv[1][1])]
    return {"device_events": n_dev, "device_ms": dev_us / 1e3,
            "kernels": len(by_name), "top": ranked[:top], "all": ranked,
            "by_site_ms": {k: v / 1e3 for k, v in sorted(
                site_us.items(), key=lambda kv: -kv[1])}}


def ladder_reset():
    """Before a phase: no fault armed, the port's breaker reset (closed,
    default tuning), its fallback counters and the triage fallback
    outcome at 0, and no dispatch path recorded on this thread."""
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.observability.profiling import set_dispatch_path
    from kyverno_tpu_torch.resilience.breaker import tpu_breaker
    from kyverno_tpu_torch.resilience.faults import global_faults

    global_faults.disarm()
    tpu_breaker().reset()
    for reason in ("error", "open"):
        global_registry.breaker_fallback.remove({"reason": reason})
    global_registry.mutate_triage.remove({"outcome": "fallback"})
    set_dispatch_path("none")


def ladder_check(phase: str) -> None:
    """After a phase other than the fault phase: the ladder must not
    have hidden the card — no breaker fallback, no triage fallback, the
    last dispatch on the device, the breaker closed."""
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.observability.profiling import (PATH_DEVICE,
                                                           last_dispatch_path)
    from kyverno_tpu_torch.resilience.breaker import CLOSED, tpu_breaker

    fb = {r: global_registry.breaker_fallback.value({"reason": r})
          for r in ("error", "open")}
    tri = global_registry.mutate_triage.value({"outcome": "fallback"})
    path = last_dispatch_path("none")
    state = tpu_breaker().state
    if any(fb.values()) or tri or path != PATH_DEVICE or state != CLOSED:
        raise AssertionError(f"phase {phase}: breaker_fallback {fb}, triage "
                             f"fallbacks {tri}, last dispatch path {path!r}, "
                             f"breaker {state}: the card was not used")
    say(phase, "ladder: no breaker_fallback and no triage fallback, last "
               "dispatch path device, breaker closed")


def same_outputs(torch, name: str, got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want) or not all(
            g.dtype == w.dtype and torch.equal(g, w)
            for g, w in zip(got, want)):
        raise AssertionError(f"{name} differ")


class FoldCheck:
    """A ``fold.CHECK`` hook: each K11 launch of a program run held
    against its plain twin on the same inputs, exactly; with ``keep``,
    each launch's code and tensors are kept (for ``time_class_fold``)."""

    def __init__(self, torch, kernels, keep: bool = False):
        self.torch, self.kernels, self.keep = torch, kernels, keep
        self.launches, self.max_abs_err, self.kept = 0, 0.0, []

    def __call__(self, code, ios, dims):
        N, I, J = dims
        outs = list(ios[code.n_ext:])
        twin = [self.torch.empty_like(o) for o in outs]
        self.kernels.class_fold_plain(code, list(ios[:code.n_ext]) + twin,
                                      N, I, J)
        for got, want in zip(outs, twin):
            self.max_abs_err = max(self.max_abs_err, exact(
                self.torch, "class_fold", got, want))
        self.launches += 1
        if self.keep:
            self.kept.append((code, list(ios), dims))


class RowCheck:
    """A ``rowfold.CHECK`` hook: each K12 launch of a program run held
    against its plain twin on the same inputs, exactly; each launch's
    code and tensors are kept (for ``time_row_fold``)."""

    def __init__(self, torch, kernels):
        self.torch, self.kernels = torch, kernels
        self.launches, self.max_abs_err, self.kept = 0, 0.0, []

    def __call__(self, code, ios, N, R):
        outs = list(ios[code.n_in:])
        twin = [self.torch.empty_like(o) for o in outs]
        self.kernels.row_fold_plain(code, list(ios[:code.n_in]) + twin, N, R)
        for got, want in zip(outs, twin):
            self.max_abs_err = max(self.max_abs_err, exact(
                self.torch, "row_fold", got, want))
        self.launches += 1
        self.kept.append((code, list(ios), (N, R)))


class Keep:
    """While entered, every launch of the named kernel wrappers in a
    program run is kept as its arguments and its output
    (``kernels.<name>`` wrapped; the evaluator looks each up at its
    call): ``kept[name]``, a list of ``(*args, out)``."""

    def __init__(self, kernels, *names):
        self.kernels, self.names = kernels, names
        self.kept = {n: [] for n in names}

    def __enter__(self):
        self.fns = {n: getattr(self.kernels, n) for n in self.names}
        for n, fn in self.fns.items():
            def keep(*args, _n=n, _fn=fn, **kw):
                out = _fn(*args, **kw)
                self.kept[_n].append((*args, out))
                return out

            setattr(self.kernels, n, keep)
        return self

    def __exit__(self, *exc):
        for n, fn in self.fns.items():
            setattr(self.kernels, n, fn)


def pool_bytes(plane, slot) -> int:
    """K7's bytes a launch: the slot lane read and the mask written
    once, and each resource's K plane bytes read once."""
    return slot.numel() * 5 + plane.shape[0] * plane.shape[1]


def pool_work(kept) -> int:
    """K7's bytes over launches that share lanes: each distinct slot
    lane and plane read once, each launch's mask written once."""
    seen, n = set(), 0
    for plane, slot, out in kept:
        for t in (plane, slot):
            key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()))
            if key not in seen:
                seen.add(key)
                n += _distinct_bytes(t)
        n += out.numel() * out.element_size()
    return n


def own(torch, t):
    """A copy of ``t`` with its own storage, its strides and its
    address modulo 16 kept (so a kernel takes the same form on it)."""
    e = t.element_size()
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    off = t.data_ptr() % 16 // e
    buf = torch.empty(span + 16 // e, dtype=t.dtype, device=t.device)
    return buf.as_strided(t.size(), t.stride(), off).copy_(t)


def rotated_ms(torch, fn, args, nbytes: int, reps: int = 3) -> float:
    """Mean device time of ``fn(*args)`` with its inputs read from
    memory, not from the L2: copies of ``args`` with their own storage,
    enough that their bytes (``nbytes`` a call) are at least four times
    the L2, called in turn in one CUDA graph (``graph_ms``)."""
    n = max(1, -(-4 * L2_BYTES // max(1, nbytes)))
    sets = [[own(torch, a) for a in args] for _ in range(n)]

    def run():
        for c in sets:
            fn(*c)

    ms = graph_ms(torch, run, reps=reps, warm=1) / n
    del sets
    torch.cuda.empty_cache()
    return ms


def time_pool_rows(torch, kernels, kept, phase, label, tag,
                   trace_ms=None):
    """K7 over the launches one eager run of a path made: each held
    against its plain twin, exactly; the run's launches timed together
    on the run's own lanes (one CUDA graph of one call each; launches
    that share a slot lane find it in the L2) beside their twins, the
    ``torch.gather`` yardstick on contiguous planes and a bound that
    reads each distinct lane once (``pool_work``); the same launches
    each on its own copies, rotated past the L2 (``rotated_ms``),
    beside a bound that reads every launch's lanes; ``trace_ms``, their
    time in one replay's device trace; and each distinct launch shape
    alone on rotated copies beside its bound, with its plane's K and
    strides and the form the kernel takes for it."""
    if not kept:
        say(phase, f"pool_rows: no launch on {label} {tag}")
        return {"launches": 0}
    err = 0.0
    for plane, slot, out in kept:
        err = max(err, exact(torch, f"pool_rows {label}", out,
                             kernels.pool_rows_plain(plane, slot)))
    lib_in = [(plane.contiguous(),
               torch.clamp(slot, 0, plane.shape[1] - 1).to(torch.int64))
              for plane, slot, _ in kept]

    def k7():
        for plane, slot, _ in kept:
            kernels.pool_rows(plane, slot)

    def twin():
        for plane, slot, _ in kept:
            kernels.pool_rows_plain(plane, slot)

    def lib():
        for pc, safe in lib_in:
            torch.gather(pc, 1, safe)

    def k7_each(*lanes):
        for i in range(0, len(lanes), 2):
            kernels.pool_rows(lanes[i], lanes[i + 1])

    r = timed(torch, k7, twin, lib, plain_reps=1)
    nbytes = pool_work(kept)
    each = sum(pool_bytes(p, s) for p, s, _ in kept)
    cold = rotated_ms(torch, k7_each, [t for p, s, _ in kept for t in (p, s)],
                      each)
    r.update(launches=len(kept), max_abs_err=err, bytes=nbytes,
             bound=bound(nbytes, 0), rotated_ms=cold, rotated_bytes=each,
             rotated_bound_ms=bound(each, 0)[0], trace_ms=trace_ms)
    shapes = {}
    for plane, slot, _ in kept:
        key = (tuple(slot.shape), plane.shape[1], tuple(plane.stride()))
        shapes.setdefault(key, []).append((plane, slot))
    r["shapes"] = []
    for (shape, K, strides), group in shapes.items():
        plane, slot = group[0]
        one = pool_bytes(plane, slot)
        ms = rotated_ms(torch, kernels.pool_rows, [plane, slot], one)
        b_ms, _ = bound(one, 0)
        form = kernels.pool_rows_form(plane, slot)
        r["shapes"].append({"shape": list(shape), "K": K,
                            "strides": list(strides), "launches": len(group),
                            "ms": ms, "bound_ms": b_ms, "form": form})
        say(phase, f"K7 pool_rows {label}: {len(group)} launches at slot "
                   f"{shape}, plane K {K} strides {strides}, form {form}: "
                   f"{ms:.4f} ms a launch alone on rotated copies, bound "
                   f"{b_ms:.4f} ms {tag}")
    lib_ms = r["library_ms"]
    trace = "not traced" if trace_ms is None else f"{trace_ms:.4f} ms"
    say(phase, f"K7 pool_rows over the {len(kept)} launches of {label}: "
               f"{r['ms']:.4f} ms on the run's lanes (eager "
               f"{r['eager_ms']:.4f} ms), bound {r['bound'][0]:.4f} ms "
               f"({nbytes} distinct bytes); {cold:.4f} ms on rotated "
               f"copies, bound {r['rotated_bound_ms']:.4f} ms ({each} "
               f"bytes); in the replay's trace {trace}; plain "
               f"{r['plain_ms']:.4f} ms, torch.gather {lib_ms:.4f} ms; each "
               f"equal to its twin (max abs err {err}) {tag}")
    return r


# K4 and K8 wrappers a path's run keeps (``Keep``), and the name each
# kernel's device events carry
KEPT = {"first_true_take": "first_true_take_",
        "verdict_counts": "verdict_counts_kernel",
        "verdict_counts_u8": "verdict_counts_kernel"}


def take_bytes(accept, pred) -> int:
    """K8's bytes on these masks: accept up to each resource's first
    true row (all R rows when none), one 32-byte sector of pred, and the
    two output bytes."""
    import torch

    N, R = accept.shape
    first = accept.to(torch.uint8).argmax(dim=-1).to(torch.int64)
    need = torch.where(accept.any(dim=-1), first + 1,
                       torch.full_like(first, R))
    return int(need.sum()) + N * 32 + N * 2


def counts_bytes(table, u8: bool = False) -> int:
    """K4's bytes: the int32 table read once, the counts written (and
    the uint8 table with ``u8``)."""
    rules, N = table.shape
    return rules * N * (5 if u8 else 4) + rules * 7 * 4


def kept_work(name, args):
    """(bytes, operations) of one kept K4 or K8 launch."""
    if name == "first_true_take":
        nbytes = take_bytes(*args)
        return nbytes, nbytes - args[0].shape[0] * 34
    table = args[0]
    return counts_bytes(table, name == "verdict_counts_u8"), table.numel() * 7


def kernel_form(kernels, name, args) -> str:
    """The form the kernel takes on these inputs (its plan function)."""
    if name == "first_true_take":
        accept = args[0]
        lanes = kernels.first_true_take_form(accept.shape[1],
                                             accept.data_ptr() % 16 == 0)
        return f"{lanes} lanes a resource" if lanes else "warp walk"
    table = args[0]
    C, threads, vector = kernels.verdict_counts_plan(
        table.shape[1], table.data_ptr() % 16 == 0)
    blocks = f"a cluster of {C} blocks" if C > 1 else "one block"
    return (f"{blocks} of {threads} threads a rule, "
            f"{'16-byte' if vector else '4-byte'} loads")


def time_kept(torch, kernels, name, kept, phase, label, tag, trace_ms=None):
    """K4 or K8 over the launches one eager run of a path made: each
    held against its plain twin, exactly; the run's launches together on
    the run's own inputs (one CUDA graph; L2-warm, as the path finds
    them after K11 or K12 wrote them) and on copies rotated past the L2
    (``rotated_ms``), each beside the byte bound of every launch's
    inputs and outputs; ``trace_ms``, their time in one replay's device
    trace; and the one launch's floor."""
    if not kept:
        return {"launches": 0}
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    err = 0.0
    for *args, out in kept:
        got = out if isinstance(out, tuple) else (out,)
        want = plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            err = max(err, exact(torch, f"{name} {label}", g, w))
    n_args = len(kept[0]) - 1
    ins = [t for *args, _ in kept for t in args]

    def each(*ts):
        for i in range(0, len(ts), n_args):
            fn(*ts[i:i + n_args])

    work = [kept_work(name, args) for *args, _ in kept]
    nbytes, ops = sum(w[0] for w in work), sum(w[1] for w in work)
    ms = graph_ms(torch, lambda: each(*ins))
    cold = rotated_ms(torch, each, ins, nbytes)
    b_ms, b_by = bound(nbytes, ops)
    floor = launch_floor_ms(torch)
    forms = sorted({kernel_form(kernels, name, args) for *args, _ in kept})
    shapes = sorted({tuple(args[0].shape) for *args, _ in kept})
    trace = "not traced" if trace_ms is None else f"{trace_ms:.4f} ms"
    say(phase, f"{name} over the {len(kept)} launches of {label} at "
               f"{shapes} ({'; '.join(forms)}): {ms:.4f} ms on the run's "
               f"own inputs, {cold:.4f} ms on rotated copies, in the "
               f"replay's trace {trace}; bound {b_ms:.5f} ms ({b_by}, "
               f"{nbytes} bytes), {len(kept)} x a launch's floor "
               f"{len(kept) * floor:.4f} ms; each equal to its twin (max "
               f"abs err {err}) {tag}")
    return {"launches": len(kept), "ms": ms, "rotated_ms": cold,
            "trace_ms": trace_ms, "bytes": nbytes, "bound": (b_ms, b_by),
            "floor_ms": floor, "forms": forms,
            "shapes": [list(x) for x in shapes], "max_abs_err": err}


_FLOOR = {}


def launch_floor_ms(torch) -> float:
    """One launch's floor on this card: a 4-byte fill replayed in a CUDA
    graph (``graph_ms``), measured once a run."""
    if "ms" not in _FLOOR:
        t = torch.zeros(1, dtype=torch.int32, device="cuda")
        _FLOOR["ms"] = graph_ms(torch, t.zero_)
    return _FLOOR["ms"]


def row_work(kept):
    """K12's work over kept launches: the distinct bytes its descriptors
    read or write, the element operations its instructions make (a
    compare or a hash pair an element, a logic step or a reduction a
    32-row word), and the instruction rows."""
    seen, nbytes, ops, rows = set(), 0, 0, 0
    for code, ios, (N, R) in kept:
        for t in ios:
            key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()))
            if key not in seen:
                seen.add(key)
                nbytes += _distinct_bytes(t)
        words = N * -(-R // 32)
        pc, instrs = 0, code.instrs
        while pc < len(instrs):
            x, a, b, c = instrs[pc]
            op = x & 0xFF
            pc += 1
            if op == 0:  # a lane group: c compares
                ops += c * N * R
                pc += c
            elif op == 1:  # a hash group: each set's pairs
                q, end = pc, pc + c
                while q < end:
                    ops += 2 * instrs[q][0] * N * R
                    q += 1 + (instrs[q][0] + 1) // 2
                pc = end
            elif op == 10:  # a batch of uint8 lane groups: a compares
                ops += a * N * R
                pc += (x >> 8) + a
            else:
                ops += words
        rows += len(instrs)
    return nbytes, ops, rows


def launch_bytes(ios) -> int:
    """The distinct bytes one launch's descriptors read or write."""
    seen, n = set(), 0
    for t in ios:
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()))
        if key not in seen:
            seen.add(key)
            n += _distinct_bytes(t)
    return n


def copy_floor(torch, ins) -> float:
    """A yardstick for reading a launch's input bytes: one device-to-
    device ``Tensor.copy_`` of each distinct input (a broadcast row
    once), replayed in a CUDA graph. It reads and writes each byte."""
    seen, srcs = set(), []
    for t in ins:
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()))
        if key not in seen:
            seen.add(key)
            srcs.append(t[:1] if t.stride(0) == 0 else t)
    dsts = [torch.empty(s.shape, dtype=s.dtype, device=s.device)
            for s in srcs]

    def copy():
        for d, s in zip(dsts, srcs):
            d.copy_(s)

    return graph_ms(torch, copy, reps=10)


# the scalar entries of ``kernels.row_fold_plan`` a line prints
PLAN_KEYS = ("warps", "T", "tiles", "grid", "rounds", "units",
             "stage_bytes", "smem", "resident", "n_slots", "code_staged",
             "slab", "rows", "bcast")


def row_plan(kernels, code, ios, N, R, **kw):
    plan = kernels.row_fold_plan(code, ios, N, R, **kw)
    return {k: plan[k] for k in PLAN_KEYS}


def row_slowest(torch, kernels, kept, phase, label, tag, top: int = 6):
    """Each K12 launch of one run timed alone (graph replay): the
    ``top`` slowest with their code's shape, launch plan (warps a block,
    resources a tile T, tiles, grid, tiles a block, fill units,
    stage and shared-memory bytes, the blocks an SM holds by the card's
    count, value slots, inputs by staging kind), the bytes they read
    and write, the copy floor of their input bytes (``copy_floor``) and
    their time at every warp count that fits (``warps`` swept, each
    launch held against its twin), and the time
    by the number of lanes a launch reads and by plan (where K12's time
    goes)."""
    rows = []
    for code, ios, (N, R) in kept:
        ms = graph_ms(torch, lambda: kernels.row_fold(code, ios, N, R),
                      reps=10)
        stores = sum(op == kernels.RF_STORE for op in code.out_ops)
        rows.append((ms, code, stores, ios, N, R))
    rows.sort(key=lambda r: -r[0])
    for ms, code, stores, ios, N, R in rows[:top]:
        plan = row_plan(kernels, code, ios, N, R)
        nb = launch_bytes(ios)
        floor = copy_floor(torch, ios[:code.n_in])
        say(phase, f"  row_fold {label} launch {ms:.4f} ms: {len(code.rows)} "
                   f"rows, {code.n_in} lanes, {code.n_out} outputs ({stores} "
                   f"stored planes); plan "
                   + ", ".join(f"{k} {v}" for k, v in plan.items())
                   + f"; {nb} bytes read and written "
                   f"({nb / (ms * 1e-3) / 1e12:.3f} TB/s); input copy floor "
                   f"{floor:.4f} ms {tag}")
        sweep = []
        for w in (1, 2, 4, 8):
            try:
                kernels.row_fold_plan(code, ios, N, R, warps=w)
            except ValueError:
                continue
            outs = [torch.empty_like(t) for t in ios[code.n_in:]]
            twin = [torch.empty_like(t) for t in outs]
            args = list(ios[:code.n_in])
            kernels.row_fold(code, args + outs, N, R, warps=w)
            kernels.row_fold_plain(code, args + twin, N, R)
            for g, t in zip(outs, twin):
                exact(torch, "row_fold", g, t)
            w_ms = graph_ms(torch, lambda: kernels.row_fold(
                code, args + outs, N, R, warps=w), reps=10)
            sweep.append(f"{w} {w_ms:.4f}")
        say(phase, f"    warps swept, ms (each equal to its twin): "
                   + ", ".join(sweep) + f" {tag}")
    by_plan = {}
    for ms, code, _, ios, N, R in rows:
        plan = row_plan(kernels, code, ios, N, R)
        key = tuple((k, plan.get(k)) for k in ("warps", "T", "resident"))
        n, t = by_plan.get(key, (0, 0.0))
        by_plan[key] = (n + 1, t + ms)
    say(phase, f"  row_fold {label} launches alone, by plan: "
               + "; ".join(", ".join(f"{k} {v}" for k, v in key)
                           + f": {n} launches {t:.4f} ms"
                           for key, (n, t) in sorted(by_plan.items()))
               + f" {tag}")
    by = {}
    for ms, code, *_ in rows:
        k = min(code.n_in // 4 * 4, 20)
        n, t = by.get(k, (0, 0.0))
        by[k] = (n + 1, t + ms)
    say(phase, f"  row_fold {label} launches alone, by lanes read (from): "
               + ", ".join(f"{k}+ {n} launches {t:.4f} ms"
                           for k, (n, t) in sorted(by.items()))
               + f"; sum {sum(r[0] for r in rows):.4f} ms {tag}")


def row_units(kernels, kept) -> dict:
    """The fill units of one run's K12 launches by kind (each a load step
    of every tile, behind a block barrier; a HASH's two lanes share a
    step): uint8 batches and the lanes in them, 4-byte lanes (LANE) and
    hash lanes."""
    n = {"u8_batches": 0, "u8_lanes": 0, "lanes4": 0, "hash_lanes": 0}
    for code, _, _ in kept:
        for u, lanes in zip(code.units, code.unit_lanes):
            op = code.instrs[u & 0xFFFFFF][0] & 0xFF
            if op == kernels.RF_BATCH:
                n["u8_batches"] += 1
                n["u8_lanes"] += len(lanes)
            elif op == kernels.RF_LANE:
                n["lanes4"] += 1
            else:
                n["hash_lanes"] += 1
    return n


def time_row_fold(torch, kernels, kept, err, phase, label, tag,
                  slowest: bool = False):
    """K12 over one program run's launches (``RowCheck``, whose largest
    error against the twins is ``err``): device time of all of them
    (graph replay) against their plain twins (eager), and the bound: the
    distinct inputs read once and the outputs written once, or
    ``row_work``'s operations, the larger; with ``slowest``, each launch
    alone (``row_slowest``). A path with no K12 launch (a triage of
    metadata matches alone has no row tape) has no time and no bound:
    None."""
    def k12():
        for code, ios, (N, R) in kept:
            kernels.row_fold(code, ios, N, R)

    def twin():
        for code, ios, (N, R) in kept:
            kernels.row_fold_plain(code, ios, N, R)

    nbytes, ops, rows = row_work(kept)
    if not kept:
        say(phase, f"row_fold: no launch on {label} (no row tape) {tag}")
        return {"ms": None, "eager_ms": None, "plain_ms": None,
                "library_ms": None, "bound": (None, None),
                "max_abs_err": None, "launches": 0, "bytes": 0, "ops": 0,
                "instructions": 0, "path": label}
    r = timed(torch, k12, twin, plain_eager=True)
    r["bound"] = bound(nbytes, ops)
    r["max_abs_err"] = err
    r.update(launches=len(kept), bytes=nbytes, ops=ops, instructions=rows,
             path=label)
    say(phase, f"row_fold over the {len(kept)} launches of {label} "
               f"({rows} instructions, {nbytes} distinct bytes, {ops} "
               f"element operations): {r['ms']:.4f} ms (graph replay; eager "
               f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
               f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}) {tag}")
    u = r["units"] = row_units(kernels, kept)
    steps = u["u8_batches"] + u["lanes4"] + u["hash_lanes"] // 2
    say(phase, f"row_fold {label} load steps: {steps} ({u['u8_batches']} "
               f"uint8 batches of {u['u8_lanes']} lanes, {u['lanes4']} "
               f"4-byte lanes, {u['hash_lanes'] // 2} hash pairs); 4-byte "
               f"lanes {u['lanes4'] / max(steps, 1):.3f} of the steps {tag}")
    if slowest:
        # the bytes each launch reads and writes, summed over launches,
        # against the distinct bytes of the bound: re-reads across
        # launches times the rate within a launch
        summed = sum(launch_bytes(ios) for _, ios, _ in kept)
        r["launch_bytes"] = summed
        say(phase, f"row_fold {label}: the launches' own bytes sum to "
                   f"{summed} ({summed / max(nbytes, 1):.3f}x the "
                   f"{nbytes} distinct bytes); over the launches' time "
                   f"{summed / (r['ms'] * 1e-3) / 1e12:.3f} TB/s, "
                   f"{bound(summed, 0)[0]:.4f} ms at the card's rate {tag}")
        row_slowest(torch, kernels, kept, phase, label, tag)
    return r


def row_reductions(torch, fn, N, R, sites):
    """The torch ``any`` / ``sum`` reductions over an (N, R) row plane
    one call of ``fn`` dispatches outside the kernel entries (on the
    card a kernel's wrapper issues none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if name in ("any", "sum") and args \
                    and isinstance(args[0], torch.Tensor) \
                    and tuple(args[0].shape) == (N, R) \
                    and not sites.current().startswith("kernel:"):
                n[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    torch.cuda.synchronize()
    return n[0]


def _distinct_bytes(t) -> int:
    """The bytes a view reads once (a broadcast dimension counts once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def fold_work(kept):
    """K11's work over kept launches: the distinct bytes its descriptors
    read or write, one operation per value element an instruction (or a
    load group's entry) makes, and the instruction rows."""
    seen, nbytes, ops, rows = set(), 0, 0, 0
    for code, ios, (N, I, J) in kept:
        for t in ios:
            key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()))
            if key not in seen:
                seen.add(key)
                nbytes += _distinct_bytes(t)
        per = (N, N * I, N * I * J)
        pc, instrs = 0, code.instrs
        while pc < len(instrs):
            x = instrs[pc][0]
            op, kind, f = x & 0xFF, (x >> 8) & 0xFF, x >> 16
            pc += 1
            if op == 0:  # a load group: its entries' kinds
                ops += sum(per[e[0]] for e in instrs[pc:pc + f])
                pc += f
            else:
                ops += per[kind]
        rows += len(instrs)
    return nbytes, ops, rows


def fold_sweep(torch, kernels, kept):
    """K11 over kept launches under every lane count G: each launch
    (at G where G is legal for its code, else at its chosen G) against
    its plain twin on the same inputs, exactly, and the device time of
    all of them (graph replay). Returns ({G: ms}, {G: launches run at
    another G})."""
    wants = []
    for code, ios, (N, I, J) in kept:
        twin = [torch.empty_like(o) for o in ios[code.n_ext:]]
        kernels.class_fold_plain(code, list(ios[:code.n_ext]) + twin, N, I,
                                 J)
        wants.append(twin)
    ms, other = {}, {}

    def at(G, code, I):
        return G if G in kernels.fold_legal(code, I) else None

    for G in kernels.CLASS_FOLD_LANES:
        other[G] = 0
        for (code, ios, (N, I, J)), want in zip(kept, wants):
            got = [torch.empty_like(o) for o in ios[code.n_ext:]]
            kernels.class_fold(code, list(ios[:code.n_ext]) + got, N, I, J,
                               lanes=at(G, code, I))
            other[G] += at(G, code, I) is None
            for g, w in zip(got, want):
                exact(torch, f"class_fold at G = {G}", g, w)

        def run(G=G):
            for code, ios, (N, I, J) in kept:
                kernels.class_fold(code, ios, N, I, J, lanes=at(G, code, I))

        ms[G] = graph_ms(torch, run)
    return ms, other


def fold_kinds(code):
    """A segment's instructions by result kind (N, NI, NIJ) and its load
    entries."""
    kinds, loads, pc = [0, 0, 0], 0, 0
    while pc < len(code.instrs):
        x = code.instrs[pc][0]
        op, kind, f = x & 0xFF, (x >> 8) & 0xFF, x >> 16
        pc += 1
        if op == 0:
            loads += f
            pc += f
        else:
            kinds[kind] += 1
    return kinds, loads


def fold_slowest(torch, kernels, kept, phase, label, tag, top: int = 6):
    """The ``top`` launches of one run that take longest at their
    chosen G, each timed alone (graph replay) at every G it allows, with
    its code's shape: where K11's time goes."""
    rows = []
    for code, ios, (N, I, J) in kept:
        ms = {G: graph_ms(torch, lambda G=G: kernels.class_fold(
            code, ios, N, I, J, lanes=G)) for G in kernels.fold_legal(code, I)}
        rows.append((ms[kernels.fold_lanes(code, N, I)], code, (N, I, J), ms))
    rows.sort(key=lambda r: -r[0])
    for t, code, (N, I, J), ms in rows[:top]:
        kinds, loads = fold_kinds(code)
        say(phase, f"  class_fold {label} launch {t:.4f} ms at G "
                   f"{kernels.fold_lanes(code, N, I)}: {len(code.rows)} rows "
                   f"(N / NI / NIJ steps {kinds}, {loads} loads), "
                   f"{code.n_uniform} N words and {code.n_lane} lane units; "
                   "by G " + ", ".join(f"{G} {m:.4f}" for G, m in ms.items())
                   + f" {tag}")


def time_class_fold(torch, kernels, kept, err, phase, label, tag,
                    slowest: bool = False):
    """K11 over one program run's launches (``FoldCheck(keep=True)``,
    whose largest error against the twins is ``err``):
    device time of all of them (graph replay) against their plain twins
    (eager), and the bound — each distinct input read once and each
    output written once, or one integer operation per instruction and
    value element, the larger; the lane counts the host chose (launches
    by G), the sweep of every G (``fold_sweep``) and, with ``slowest``,
    the slowest launches alone (``fold_slowest``)."""
    def k11():
        for code, ios, (N, I, J) in kept:
            kernels.class_fold(code, ios, N, I, J)

    def twin():
        for code, ios, (N, I, J) in kept:
            kernels.class_fold_plain(code, ios, N, I, J)

    nbytes, ops, rows = fold_work(kept)
    r = timed(torch, k11, twin, plain_eager=True)
    r["bound"] = bound(nbytes, ops)
    r["max_abs_err"] = err
    chosen = {}
    for code, ios, (N, I, J) in kept:
        G = kernels.fold_lanes(code, N, I)
        chosen[G] = chosen.get(G, 0) + 1
    g_ms, other = fold_sweep(torch, kernels, kept)
    r.update(launches=len(kept), bytes=nbytes, ops=ops, instructions=rows,
             path=label, g_chosen=chosen, g_ms=g_ms, g_other=other)
    say(phase, f"class_fold over the {len(kept)} launches of {label} "
               f"({rows} instructions, {nbytes} distinct bytes, {ops} value "
               f"operations): {r['ms']:.4f} ms (graph replay; eager "
               f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
               f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}); launches by "
               f"chosen G {json.dumps(chosen, sort_keys=True)} {tag}")
    say(phase, f"class_fold {label} under every G (each launch equal to its "
               "twin): " + ", ".join(
                   f"G {G} {ms:.4f} ms" + (f" ({other[G]} launches at "
                                           "their own G)" if other[G] else "")
                   for G, ms in g_ms.items()) + f" {tag}")
    if slowest:
        fold_slowest(torch, kernels, kept, phase, label, tag)
    return r


def graph_check(torch, kernels, phase, label, g, lanes, plain_fn, tag,
                top: bool = False, timing: bool = True):
    """One path's program as a CUDA graph (``tpu/graphs.py``) on one
    lane dict: the replay against the eager program (``g.run``) and the
    plain-twin program, exactly; the launches and program stats of one
    eager run against one replay; eager and replayed times (host clock
    to a sync, median of 5); captures; the aten operations the host
    issues per eager run and per replayed call; every K11 launch of an
    eager run against its plain twin and the values the run forced off
    its tapes (``fold_forced``), and those launches timed together
    (``time_class_fold``); every K12 launch of the same run against its
    twin, the values forced off its row tapes (``rows_forced``), the K6
    launches and the torch reductions over rows of a run, and the K12
    launches timed together (``time_row_fold``); and the device events
    of one replay (with ``top``, its 15 longest kernels by name).
    Without ``timing``, only the checks up to the launches and stats of
    an eager run against a replay."""
    from kyverno_tpu_torch.tpu import evaluator as ev
    from kyverno_tpu_torch.tpu import fold, rowfold
    from kyverno_tpu_torch.tpu.graphs import GraphedProgram

    if not isinstance(g, GraphedProgram):
        raise AssertionError(f"{label}: the program is not graphed")

    def five(fn):
        ts, out = [], None
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts), ts, out

    eager_ms, eager_all, eager_out = five(lambda: g.run(lanes))
    # a key's first call runs eagerly, its second captures: both happen
    # here unless the path already made them
    g(lanes)
    g(lanes)
    replay_ms, replay_all, replay_out = five(lambda: g(lanes))
    same_outputs(torch, f"{label}: replay and eager outputs", replay_out,
                 eager_out)
    same_outputs(torch, f"{label}: replay and plain-twin outputs",
                 replay_out, plain_fn(lanes))
    counted = []
    for fn in (g.run, g):
        kernels.reset_launches()
        zero_stats(g)
        fn(lanes)
        torch.cuda.synchronize()
        counted.append((dict(kernels.LAUNCHES), dict(g.stats)))
    if counted[0] != counted[1]:
        raise AssertionError(f"{label}: an eager run counts {counted[0]}, a "
                             f"replay {counted[1]}")
    if not timing:
        say(phase, f"{label} as a CUDA graph: replay equals the eager program "
                   f"and the plain-twin program, with the same "
                   f"{sum(counted[0][0].values())} launches and stats; eager "
                   f"{eager_ms:.3f} ms, replay {replay_ms:.3f} ms (medians of "
                   f"5); captures {g.captures}, replays {g.replays} {tag}")
        return {"eager_ms": eager_ms, "replay_ms": replay_ms,
                "captures": g.captures}
    ops_eager, _ = program_ops(torch, kernels, lambda: g.run(lanes))
    ops_replay, _ = program_ops(torch, kernels, lambda: g(lanes))
    n_launch = sum(counted[0][0].values())
    chk = FoldCheck(torch, kernels, keep=True)
    rchk = RowCheck(torch, kernels)
    zero_stats(g)
    fold.CHECK, rowfold.CHECK = chk, rchk
    try:
        with Keep(kernels, "pool_rows", *KEPT) as pk:
            g.run(lanes)
        torch.cuda.synchronize()
    finally:
        fold.CHECK = rowfold.CHECK = None
    for name, kept in pk.kept.items():
        if len(kept) != counted[0][0][name]:
            raise AssertionError(f"{label}: {len(kept)} {name} launches "
                                 f"kept, {counted[0][0][name]} counted")
    forced, rforced = g.stats["fold_forced"], g.stats["rows_forced"]
    if chk.launches <= 0 or chk.launches != counted[0][0]["class_fold"]:
        raise AssertionError(f"{label}: {chk.launches} K11 launches checked, "
                             f"{counted[0][0]['class_fold']} counted")
    if rchk.launches != counted[0][0]["row_fold"]:
        raise AssertionError(f"{label}: {rchk.launches} K12 launches checked,"
                             f" {counted[0][0]['row_fold']} counted")
    # the torch reductions over rows an eager run issues (outside the
    # kernel entries; a replay runs the same kernels)
    rl = next(t for k, t in lanes.items() if k in ("norm_hi", "row_idx"))
    with Sites(ev) as sites:
        n_red = row_reductions(torch, lambda: g.run(lanes), *rl.shape,
                               sites)
    rp = device_profile(torch, lambda: g(lanes))
    copies = sum(t["calls"] for t in rp["all"] if "Memcpy DtoD" in t["name"])
    copies_ms = sum(t["ms"] for t in rp["all"] if "Memcpy DtoD" in t["name"])
    # the program's bound: every lane read once, its outputs written once
    outs = eager_out if isinstance(eager_out, tuple) else (eager_out,)
    io_bytes = sum(t.numel() * t.element_size() for t in lanes.values()) \
        + sum(t.numel() * t.element_size() for t in outs)
    b_ms, _ = bound(io_bytes, 0)
    say(phase, f"{label} as a CUDA graph: replay equals the eager program and "
               f"the plain-twin program; eager {eager_ms:.3f} ms median of 5 "
               f"({', '.join(f'{x:.3f}' for x in eager_all)}), replay "
               f"{replay_ms:.3f} ms median of 5 "
               f"({', '.join(f'{x:.3f}' for x in replay_all)}) {tag}")
    say(phase, f"{label}: captures {g.captures} (live {g.live_graphs}), "
               f"replays {g.replays}; aten operations per eager run "
               f"{ops_eager}, per replayed call {ops_replay}; {n_launch} "
               "launches of the port's kernels per run, the same counted "
               "eagerly and replayed")
    say(phase, f"{label}: K11 class_fold equals its plain twin on all "
               f"{chk.launches} launches of an eager run (max abs err "
               f"{chk.max_abs_err}); fold_forced {forced}; one replay "
               f"{rp['device_events']} device events, {rp['device_ms']:.3f} "
               f"ms of device time (torch.profiler); bound {b_ms:.4f} ms "
               f"({io_bytes} bytes of lanes and outputs) {tag}")
    held = (f"equals its plain twin on all {rchk.launches} launches of an "
            f"eager run (max abs err {rchk.max_abs_err})" if rchk.launches
            else "has no launch in an eager run")
    splits = counted[0][1]["row_splits"]
    say(phase, f"{label}: K12 row_fold {held}; {counted[0][0]['row_fold']} "
               f"launches a run, {splits} of them splits of a rule's flush; "
               f"rows_forced {rforced}; a run's K6 "
               f"hash_match launches {counted[0][0]['hash_match']}, torch "
               f"any/sum reductions over rows {n_red}, one replay "
               f"{rp['device_events']} device events {tag}")
    say(phase, f"{label}: one replay {copies} device-to-device copies, "
               f"{copies_ms:.4f} ms {tag}")
    if top:
        for t in rp["top"]:
            say(phase, f"  replay kernel {t['ms']:.3f} ms {t['calls']} x "
                       f"{t['name']}")
    return {"eager_ms": eager_ms, "replay_ms": replay_ms,
            "captures": g.captures, "ops_eager": ops_eager,
            "ops_replay": ops_replay, "launches": n_launch,
            "fold_checked": chk.launches, "fold_forced": forced,
            "rows_checked": rchk.launches, "rows_forced": rforced,
            "row_splits": splits,
            "k6_launches": counted[0][0]["hash_match"],
            "row_reductions": n_red,
            "replay_events": rp["device_events"],
            "replay_device_ms": rp["device_ms"], "top": rp["top"],
            "bound_ms": b_ms, "io_bytes": io_bytes,
            "k11": time_class_fold(torch, kernels, chk.kept,
                                   chk.max_abs_err, phase, label, tag,
                                   slowest=top),
            "k12": time_row_fold(torch, kernels, rchk.kept,
                                 rchk.max_abs_err, phase, label, tag,
                                 slowest=top),
            "copies": copies, "copies_ms": copies_ms,
            "k7": time_pool_rows(
                torch, kernels, pk.kept["pool_rows"], phase, label, tag,
                trace_ms=sum(t["ms"] for t in rp["all"]
                             if "pool_rows_kernel" in t["name"])),
            **{name: time_kept(
                torch, kernels, name, pk.kept[name], phase, label, tag,
                trace_ms=sum(t["ms"] for t in rp["all"]
                             if KEPT[name] in t["name"]))
               for name in KEPT}}


def busy_share(torch, fn, reps: int = 3):
    """The device's busy share over ``reps`` calls of ``fn`` under
    ``torch.profiler``: the union of the CUDA activity intervals over the
    traced window (first to last event). None when the trace holds no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.time_range.end > e.time_range.start]
    dev = sorted((e.time_range.start, e.time_range.end) for e in evs
                 if e.device_type == DeviceType.CUDA)
    if not dev:
        return None
    lo = min(e.time_range.start for e in evs)
    hi = max(e.time_range.end for e in evs)
    busy, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    for a, b in dev[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    return {"busy_share": busy / (hi - lo), "window_ms": (hi - lo) / 1e3,
            "busy_ms": busy / 1e3, "device_events": len(dev)}


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain twin


def accented(torch, gen, S: int, W: int, dev):
    """Seeded (S, W) ASCII subjects and (S,) lengths in [0, W + 8]:
    about one row in ten carries an 'e' with an acute accent (0xC3
    0xA9) at a random position, inside or past its length, and half the
    rows hold 0xFF past their length, so a flag that reads a byte past
    the length is caught."""
    b = torch.randint(32, 127, (S, W), generator=gen, dtype=torch.uint8)
    ln = torch.randint(0, W + 9, (S,), generator=gen, dtype=torch.int32)
    rows = torch.nonzero(torch.rand(S, generator=gen) < 0.1).flatten()
    at = torch.randint(0, W - 1, (rows.numel(),), generator=gen)
    b[rows, at] = 0xC3
    b[rows, at + 1] = 0xA9
    past = torch.arange(W)[None, :] >= ln[:, None]
    b[past & (torch.rand(S, generator=gen) < 0.5)[:, None]] = 0xFF
    return b.to(dev), ln.to(dev)


def check_dfa(torch, kernels, dfa_mod, pool, pool_len, seed, results):
    """K1 at strides 1, 2, 4 on the PSS patterns (over the main path's
    pool lanes) and on an approximated bank (over seeded random bytes,
    and over seeded ASCII subjects with an accented letter inside or
    past the length); both entries' non-ASCII flags (B4, written by the
    walk of pattern 0) against ``nonascii_plain``."""
    dev = pool.device
    W = pool.shape[-1]
    subj = pool.reshape(-1, W).contiguous()
    slen = pool_len.reshape(-1).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rb = torch.randint(0, 256, tuple(subj.shape), generator=gen,
                       dtype=torch.uint8).to(dev)
    # lengths 0 .. W + 7: not multiples of any stride, some past W
    rl = torch.randint(0, W + 8, (subj.shape[0],), generator=gen,
                       dtype=torch.int32).to(dev)
    pss_patterns = [("glob", "localhost/*"),
                    ("glob", "container.apparmor.security.beta.kubernetes.io/*")]
    approx_patterns = [("re2", "^(ab|cd){1,10}x[0-9]{3}$"),
                       ("re2", "^v[0-9]{1,4}\\.[0-9]{1,4}\\.[0-9]{1,4}$"),
                       ("glob", "*-suffix-*-mid-*-tail"),
                       ("glob", "prefix-????-*-????-end"),
                       ("glob", "nginx-?"), ("re2", "[a-c]+é")]
    old = os.environ.get("KYVERNO_TPU_DFA_STATE_BUDGET")
    for label, patterns, budget, (b, ln) in (
            ("pss", pss_patterns, None, (subj, slen)),
            ("approx", approx_patterns, "12", (rb, rl)),
            ("accented", approx_patterns, "12",
             accented(torch, gen, subj.shape[0], W, dev))):
        for stride in (4, 2, 1):
            if budget is not None:
                os.environ["KYVERNO_TPU_DFA_STATE_BUDGET"] = budget
            bank = dfa_mod.DfaBank()
            for kind, pat in patterns:
                (bank.add_glob if kind == "glob" else bank.add_re2)(pat, "pool")
            bank.finalize(stride=stride)
            if budget is not None:
                if old is None:
                    os.environ.pop("KYVERNO_TPU_DFA_STATE_BUDGET")
                else:
                    os.environ["KYVERNO_TPU_DFA_STATE_BUDGET"] = old
                if not bank.stats()["approx"]:
                    raise AssertionError("approximated bank has no "
                                         "approximated pattern")
            ids = [i for i in bank.families["pool"]
                   if int(bank.strides[i]) == stride]
            if not ids:
                raise AssertionError(f"{label} bank: no pattern at stride {stride}")
            (tiles,) = dfa_mod.scan_groups(bank, ids, dev)
            kfn, name = k1_entry(kernels, tiles)
            out = torch.empty((b.shape[0], len(ids)), dtype=torch.bool,
                              device=dev)
            got, na = kfn(b, ln, tiles, out, want_nonascii=True)
            want = tiles.plain_scan(b, ln)
            err = exact(torch, f"{name} {label} stride {stride}", got, want)
            err = max(err, exact(torch, f"nonascii {label} stride {stride}",
                                 na, kernels.nonascii_plain(b, ln)))
            say("3", f"K1 {name} {label} bank stride {stride}: "
                     f"{tuple(got.shape)} accepts, {int(got.sum())} hits, "
                     f"{int(na.sum())} non-ASCII subjects, max abs err {err}; "
                     + k1_layout(tiles, b))
            # time each entry at the main path's own configuration: the
            # compiled PSS bank (stride 4) and its stride-1 build
            if label == "pss" and stride in (4, 1):
                K = len(ids)
                nbytes, steps, table_bytes = k1_work(torch, tiles, b, ln)
                results[name] = {
                    "max_abs_err": err,
                    **timed(torch, lambda: kfn(b, ln, tiles, out),
                            lambda: tiles.plain_scan(b, ln)),
                    "bound": bound(nbytes, steps * K * 4),
                }
                say("3", f"K1 {name} bound inputs: {b.shape[0]} subjects, "
                         f"{steps * K} steps, {table_bytes} table bytes")


def k1_entry(kernels, tiles):
    """K1's wrapper for a stride group's tiles, and its name."""
    if tiles.kind == "stride1":
        return kernels.dfa_scan_stride1, "dfa_scan_stride1"
    return kernels.dfa_scan_fused, "dfa_scan_fused"


def k1_layout(tiles, b):
    """The tiles and the grid of a K1 launch over subjects ``b``."""
    S, W = b.shape
    chunk = tiles.chunk(S, W, b.device)
    flags = tiles.tiles[:, 3].cpu()
    return (f"{tiles.n_tiles} tiles ({int((flags & 2).sum())} in global "
            f"memory, {int((flags & 1).sum())} wide) of "
            f"{int(tiles.blob.numel())} bytes, the largest staged "
            f"{tiles.smem_tile}; grid ({-(-S // chunk)}, {tiles.n_tiles}), "
            f"{chunk} subjects a chunk, {tiles.smem} bytes of shared memory")


def check_dfa_tenant(torch, kernels, dfa_mod, bank, lanes, results):
    """K1 where most of its launches run: the tenant bank's ``ns`` and
    ``name`` families (3,000 patterns, 59,993 states) over the tenant
    batch's namespace and name lanes, at the scan shape (every row)
    and at the triage shape (the first 1,024 rows), both entries held
    exactly against their plain twins and timed."""
    dev = lanes["meta_ns_bytes"].device
    rows = []
    for family in ("ns", "name"):
        byt = lanes[f"meta_{family}_bytes"]
        ln = lanes[f"meta_{family}_len"]
        ids = bank.families[family]
        # the whole family, both groups writing the plane in place
        err = exact(torch, f"bank_match tenant {family}",
                    dfa_mod.bank_match(bank, ids, byt, ln),
                    dfa_mod.bank_match(bank, ids, byt, ln, plain=True))
        say("3", f"K1 bank_match tenant {family} ({len(ids)} patterns, "
                 f"{byt.shape[0]} subjects): equal to the plain twins, max "
                 f"abs err {err}")
        for stride in (1, 4):
            sub = [i for i in ids if int(bank.strides[i]) == stride]
            (tiles,) = dfa_mod.scan_groups(bank, sub, dev)
            kfn, name = k1_entry(kernels, tiles)
            for shape, n in (("scan", byt.shape[0]),
                             ("triage", min(1024, byt.shape[0]))):
                b, l = byt[:n].contiguous(), ln[:n].contiguous()
                out = torch.empty((n, len(sub)), dtype=torch.bool, device=dev)
                got, na = kfn(b, l, tiles, out, want_nonascii=True)
                err = exact(torch, f"{name} tenant {family} {shape}", got,
                            tiles.plain_scan(b, l))
                err = max(err, exact(torch, f"{name} tenant {family} {shape}"
                                     " non-ASCII flag", na,
                                     kernels.nonascii_plain(b, l)))
                nbytes, steps, table_bytes = k1_work(torch, tiles, b, l)
                row = {"name": name, "family": family, "shape": shape,
                       "K": len(sub), "S": n, "W": b.shape[1],
                       "steps": steps * len(sub), "table_bytes": table_bytes,
                       "max_abs_err": err,
                       **timed(torch, lambda: kfn(b, l, tiles, out),
                               lambda: tiles.plain_scan(b, l),
                               plain_eager=True),
                       "bound": bound(nbytes, steps * len(sub) * 4),
                       "flag_ms": graph_ms(torch, lambda: kfn(
                           b, l, tiles, out, want_nonascii=True)),
                       "nonascii": int(na.sum()),
                       "chunk_ms": k1_chunk_sweep(torch, kernels, kfn, tiles,
                                                  b, l, out)}
                rows.append(row)
                say("3", f"K1 {name} tenant {family} {shape}: K {len(sub)}, "
                         f"S {n}, W {b.shape[1]}, steps {steps * len(sub)}, "
                         f"table bytes {table_bytes}; "
                         + k1_layout(tiles, b))
                say("3", f"K1 {name} tenant {family} {shape}: "
                         f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}),"
                         f" with the non-ASCII flag {row['flag_ms']:.4f} ms,"
                         f" plain {row['plain_ms']:.4f} ms, bound "
                         f"{row['bound'][0]:.6f} ms ({row['bound'][1]}), "
                         f"{int(got.sum())} hits, {row['nonascii']} "
                         f"non-ASCII subjects, max abs err {err}")
                say("3", f"K1 {name} tenant {family} {shape}: chunks a tile"
                         f" -> ms (the wrapper's rule: "
                         f"{-(-n // tiles.chunk(n, b.shape[1], dev))}): "
                         + ", ".join(
                             f"{c}: {ms:.4f}"
                             for c, ms in row["chunk_ms"].items()))
    results["dfa_tenant"] = rows


def k1_chunk_sweep(torch, kernels, kfn, tiles, b, ln, out):
    """K1's device time over ``b`` with the subjects of each tile split
    into 1, 2, 3, 4, 8, 16, 32 and 64 chunks and the wrapper's own count
    (while a chunk keeps ``kernels.DFA_MIN_CHUNK`` subjects):
    {chunks: ms}."""
    S, W = b.shape
    own = -(-S // tiles.chunk(S, W, b.device))
    sweep = {}
    try:
        for c in sorted({1, 2, 3, 4, 8, 16, 32, 64, own}):
            if c > 1 and -(-S // c) < kernels.DFA_MIN_CHUNK:
                break
            tiles.chunk = lambda S, W, device, c=c: -(-S // c)
            sweep[c] = graph_ms(torch, lambda: kfn(b, ln, tiles, out))
    finally:
        del tiles.chunk
    return sweep


def k1_work(torch, tiles, b, ln):
    """The least work K1 needs on these subjects: (bytes moved, steps
    per pattern, table bytes). The tables are the group's packed tiles,
    their directory and (fused) the 4 KB pair map, each read once. The
    scan stops after ceil(min(len, W) / 2) pairs (fused) or min(len, W)
    bytes (stride 1), and bytes past that cannot change the result, so
    only live bytes count, beside the lengths and the (S, K) output."""
    S, W = b.shape
    live = torch.clamp(ln, 0, W).to(torch.int64)
    table_bytes = tiles.blob.numel() + tiles.tiles.numel() * 4
    if tiles.kind == "stride1":
        steps = int(live.sum())
    else:
        steps = int(((live + 1) // 2).sum())
        table_bytes += 4096
    nbytes = S * 4 + S * tiles.cols.numel() + int(live.sum()) + table_bytes
    return nbytes, steps, table_bytes


def check_instance_count(torch, kernels, lanes, n_inst, seed, results):
    """K3's one-level entry (P = 1 and 5 predicates, counts, any and
    both, contiguous, strided, unaligned and broadcast predicates) and
    its two-level entry against their plain twins, on the main path's
    scopes and on hazard scopes; both timed at the path shape beside
    scatter_add_."""
    dev = lanes["scope1"].device
    N, R = lanes["scope1"].shape
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rand_pred(shape, q):
        return (torch.rand(shape, generator=gen) < q).to(dev)

    pred = rand_pred((N, R), 0.5)
    wide = rand_pred((N, R + 8), 0.3)
    preds = {"contiguous": pred,
             "strided": wide[:, :R],        # row stride R + 8
             "unaligned": wide[:, 3:R + 3],  # rows start off 8 bytes
             "broadcast": rand_pred((1, R), 0.5).expand(N, R),
             "sparse": rand_pred((N, R), 0.02)}
    hz1 = torch.randint(-1, n_inst + 3, (N, R), generator=gen,
                        dtype=torch.int32).to(dev)
    hz2 = torch.randint(-1, n_inst + 3, (N, R), generator=gen,
                        dtype=torch.int32).to(dev)
    hzv = rand_pred((N, R), 0.8)
    valid = lanes["valid"] != 0
    s1, s2 = lanes["scope1"], lanes["scope2"]
    errs = {"instance_count": 0.0, "instance_count2": 0.0}
    names = list(preds)
    for label, (a, b, v) in (("main-path lanes", (s1, s2, valid)),
                             ("hazard scopes", (hz1, hz2, hzv))):
        sc = kernels.scope8(a, v, n_inst)
        runs = [([k], w) for k in names for w in ("count", "any")]
        runs += [(names, "count"), (names, "any"),
                 (names, ["count", "any", "any", "count", "any"])]
        for ks, want in runs:
            ps = [preds[k] for k in ks]
            got = kernels.instance_count_many(ps, sc, n_inst, want)
            ref = kernels.instance_count_many_plain(ps, sc, n_inst, want)
            wants = [want] * len(ks) if isinstance(want, str) else want
            for k, w, g, r, p in zip(ks, wants, got, ref, ps):
                e = exact(torch, f"instance_count {label} {k} {w} P={len(ks)}",
                          g, r)
                # and the one-hot count on scope1 and valid themselves
                full = kernels.instance_count_plain(p.contiguous(), a, v,
                                                    n_inst)
                e = max(e, exact(torch, f"instance_count {label} {k} {w} "
                                        "vs one-hot", g,
                                 full > 0 if w == "any" else full))
                errs["instance_count"] = max(errs["instance_count"], e)
        g2 = kernels.instance_count2(pred, a, b, v, n_inst)
        w2 = kernels.instance_count_plain(pred, a, v, n_inst, b)
        errs["instance_count2"] = max(errs["instance_count2"], exact(
            torch, f"instance_count2 {label}", g2, w2))
        say("3", f"K3 instance_count {label}: {len(runs)} launches of 1 and "
                 f"5 predicates ({', '.join(names)}; count, any, mixed) "
                 f"equal the plain twin and the one-hot count; two-level "
                 f"{tuple(g2.shape)} sum {int(g2.sum())}; max abs err "
                 f"{max(errs.values())}")
    # the one PyTorch call computing the same counts: scatter_add_ over a
    # precomputed flat cell index (the index and weights are prepared
    # outside the timed call)
    live = pred & valid
    ok1 = live & (s1 >= 0) & (s1 < n_inst)
    ok2 = ok1 & (s2 >= 0) & (s2 < n_inst)
    rows = torch.arange(N, device=dev)[:, None]
    idx1 = (rows * n_inst + s1.clamp(0, n_inst - 1)).reshape(-1)
    idx2 = (rows * n_inst * n_inst + s1.clamp(0, n_inst - 1) * n_inst
            + s2.clamp(0, n_inst - 1)).reshape(-1)
    w1 = ok1.to(torch.int32).reshape(-1)
    w2 = ok2.to(torch.int32).reshape(-1)
    out1 = torch.zeros(N * n_inst, dtype=torch.int32, device=dev)
    out2 = torch.zeros(N * n_inst * n_inst, dtype=torch.int32, device=dev)
    sc = kernels.scope8(s1, valid, n_inst)
    # five predicates on the vector path (the unaligned one is not)
    five = [preds[k] for k in names if k != "unaligned"] + [
        rand_pred((N, R), 0.7)]
    five_bytes = sum(R if p.stride(0) == 0 else N * R for p in five)
    out1.zero_().scatter_add_(0, idx1, w1)
    if not torch.equal(out1.view(N, n_inst),
                       kernels.instance_count_many([pred], sc, n_inst)[0]):
        raise AssertionError("scatter_add_ yardstick disagrees with K3")
    one = timed(torch, lambda: kernels.instance_count_many([pred], sc, n_inst),
                lambda: kernels.instance_count_many_plain([pred], sc, n_inst),
                lambda: out1.zero_().scatter_add_(0, idx1, w1))
    p5 = timed(torch, lambda: kernels.instance_count_many(five, sc, n_inst),
               lambda: kernels.instance_count_many_plain(five, sc, n_inst))
    any1 = graph_ms(torch, lambda: kernels.instance_count_many(
        [pred], sc, n_inst, "any"))
    counts_out = N * n_inst * 4
    results["instance_count"] = {
        "max_abs_err": errs["instance_count"], **one,
        # the bytes this entry reads and writes (pred, scope8, counts)
        "bound": bound(N * R * 2 + counts_out, N * R * 4),
        "ms_p5": p5["ms"], "eager_ms_p5": p5["eager_ms"],
        "plain_ms_p5": p5["plain_ms"], "ms_any": any1,
        "bound_p5": bound(five_bytes + N * R + 5 * counts_out,
                          5 * N * R * 4),
        # the earlier kernel's measure: pred, valid and int32 scope1
        # (6 bytes a row)
        "bound_6_bytes": bound(N * R * 6 + counts_out, N * R * 4),
    }
    results["instance_count2"] = {
        "max_abs_err": errs["instance_count2"],
        **timed(torch,
                lambda: kernels.instance_count2(pred, s1, s2, valid, n_inst),
                lambda: kernels.instance_count_plain(pred, s1, valid, n_inst,
                                                     s2),
                lambda: out2.zero_().scatter_add_(0, idx2, w2)),
        "bound": bound(N * R * 10 + N * n_inst * n_inst * 4, N * R * 4),
    }
    r = results["instance_count"]
    say("3", f"K3 one level at ({N}, {R}), I={n_inst}: P=1 {r['ms']:.4f} ms "
             f"(bound {r['bound'][0]:.4f}; 6-byte bound "
             f"{r['bound_6_bytes'][0]:.4f}), any {r['ms_any']:.4f} ms, P=5 "
             f"{r['ms_p5']:.4f} ms (bound {r['bound_p5'][0]:.4f}), "
             f"scatter_add_ {r['library_ms']:.4f} ms")


def check_row_fold(torch, kernels, lanes, seed, results):
    """K12 on the dense lanes at the main path's shape: a seeded tape of
    every instruction over lanes of every element type (the uint8 type
    tag, bool and valid lanes, a bool plane and a (1, R) broadcast, the
    int32 scope lane, the float32 number and duration lanes, scaled, and
    the int32 repr hash pair against sets of 0, 1 and 5 constants taken
    from the lanes), its outputs (any, count, stored planes) against the
    plain twin, exactly, and timed beside it and its bound."""
    from kyverno_tpu_torch.tpu import fold, rowfold

    rng = random.Random(seed)
    tt = lanes["type_tag"]
    N, R = tt.shape
    dev = tt.device
    ft = fold.Tape(N, 1, 1, dev, fold.FoldCache(), False)
    rt = rowfold.RowTape(N, R, dev, rowfold.RowCache(), False, ft)
    hi, lo = lanes["repr_hi"], lanes["repr_lo"]
    seen = list(zip(hi[:8, :16].flatten().tolist(),
                    lo[:8, :16].flatten().tolist()))
    lane = rt.lane
    vals = [rt.wrap(lanes["valid"] != 0),
            rt.wrap((torch.arange(R, device=dev) % 3 == 0)[None, :]),
            lane(lanes["bool_val"]) == 1, lane(lanes["valid"]) != 0,
            lane(lanes["scope1"]) == 0, lane(lanes["scope1"]) != -1,
            lane(lanes["num_val"]) == 0, lane(lanes["num_val"]) > 1.0,
            lane(lanes["num_val"]) < 100.0, lane(lanes["arr_len"]) != 0,
            lane(lanes["dur_val"]) * 1e9 > 5e9,
            rt.heq(hi, lo, []), rt.heq(hi, lo, seen[:1]),
            rt.heq(hi, lo, rng.sample(seen, 5))]
    vals += [lane(tt) == k for k in range(7)]
    for _ in range(200):
        a, b, c = (rng.choice(vals) for _ in range(3))
        vals.append(rng.choice([lambda: a & b, lambda: a | b, lambda: ~a,
                                lambda: rowfold.where(c, a, b)])())
    picks = rng.sample(range(len(vals)), 24)
    ops = (rowfold.ANY, rowfold.COUNT, rowfold.STORE)
    outs = [(ops[k % 3], vals[i].vid) for k, i in enumerate(picks)]
    segs = rowfold.compile_rows(rt.code, rt.etypes, outs)

    def dests():
        return [torch.empty((N, R) if op == rowfold.STORE else (N,),
                            dtype=torch.int32 if op == rowfold.COUNT
                            else torch.bool, device=dev) for op, _ in outs]

    got, want = dests(), dests()
    launches = []
    for seg in segs:
        ios = [rt.inputs[i] for i in seg.ins]
        kernels.row_fold(seg.code, ios + [got[k] for k in seg.outs], N, R)
        kernels.row_fold_plain(seg.code, ios + [want[k] for k in seg.outs],
                               N, R)
        launches.append((seg.code, ios + [got[k] for k in seg.outs], (N, R)))
    torch.cuda.synchronize()
    err = max(exact(torch, "row_fold", g, w) for g, w in zip(got, want))
    nbytes, n_ops, rows = row_work(launches)

    def k12():
        for code, ios, _ in launches:
            kernels.row_fold(code, ios, N, R)

    def twin():
        for code, ios, _ in launches:
            kernels.row_fold_plain(code, ios, N, R)

    r = timed(torch, k12, twin, plain_eager=True)
    r["bound"] = bound(nbytes, n_ops)
    r["max_abs_err"] = err
    results["row_fold_phase3"] = r
    say("3", f"row_fold equals its plain twin on a random tape at ({N}, {R})"
             f": {len(rt.code)} recorded instructions, {len(outs)} outputs, "
             f"{len(segs)} launches ({rows} rows); {r['ms']:.4f} ms (eager "
             f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound "
             f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")


def phase3_kernel(torch, kernels, name, args, results, tag, lib=None,
                  key=None, plain_reps: int = 3):
    """One K4 or K8 launch on seeded or path inputs in phase 3: held
    against its plain twin, exactly; timed on these inputs (graph
    replay; L2-warm) beside its twin and ``lib``, and on copies rotated
    past the L2; its byte bound and one launch's floor; kept in
    ``results[key]`` (default ``name``)."""
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    got, want = fn(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(exact(torch, name, g, w) for g, w in zip(got, want))
    nbytes, ops = kept_work(name, args)
    r = timed(torch, lambda: fn(*args), lambda: plain(*args), lib,
              plain_reps=plain_reps)
    r.update(max_abs_err=err, bound=bound(nbytes, ops), bytes=nbytes,
             rotated_ms=rotated_ms(torch, fn, list(args), nbytes),
             floor_ms=launch_floor_ms(torch),
             form=kernel_form(kernels, name, args),
             shape=list(args[0].shape))
    results[key or name] = r
    say("3", f"{name} {tuple(args[0].shape)} ({r['form']}): max abs err "
             f"{err}; {r['ms']:.4f} ms on these inputs (eager "
             f"{r['eager_ms']:.4f}), {r['rotated_ms']:.4f} ms on rotated "
             f"copies; bound {r['bound'][0]:.5f} ms ({r['bound'][1]}, "
             f"{nbytes} bytes), a launch's floor {r['floor_ms']:.4f} ms; "
             f"plain {r['plain_ms']:.4f} ms {tag}")
    return got


def check_verdict_counts(torch, kernels, dev, rules, N, seed, results, tag):
    """K4 on a seeded (rules, N) table of the codes 0..6, at the dense
    path's shape."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    table = torch.randint(0, 7, (rules, N), generator=gen,
                          dtype=torch.int32).to(dev)
    ar = torch.arange(7, device=dev, dtype=torch.int32)
    got, = phase3_kernel(torch, kernels, "verdict_counts", (table,), results,
                         tag, lib=lambda: (table[..., None] == ar).sum(1),
                         plain_reps=20)
    if int(got.sum()) != rules * N:
        raise AssertionError("verdict_counts: counts do not cover the table")


def uint16_index(rng, shape, V: int):
    """A uint16 index table with about a fifth of its values at or past
    ``V`` (filled, as jnp.take does), as a CPU torch.uint16 tensor
    (made through int16 bits: torch orders no uint16)."""
    import numpy as np
    import torch

    top = min(1 << 16, V + V // 4 + 8)
    bits = rng.integers(0, top, size=shape, dtype=np.uint16).view(np.int16)
    return torch.from_numpy(bits).view(torch.uint16)


def check_vocab_kernels(torch, kernels, dfa_mod, scanner, lanes, seed,
                        results, tag):
    """K5 (both entries), K6, K7, K8 and K4's uint8 output against their
    plain twins on one encoded tile of the background scan: its
    vocabulary lanes, index tables and shapes."""
    import numpy as np

    from kyverno_tpu_torch.tpu.flatten import _ROW_LANE_DTYPES

    dev = lanes["row_idx"].device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rng = np.random.default_rng(seed)

    # K5, the lane gather: every vocabulary lane of the tile, one launch
    idx = lanes["row_idx"]
    names = [k[len("vocab_"):] for k in lanes if k.startswith("vocab_")]
    srcs = [lanes["vocab_" + n] for n in names]
    fills = [kernels.TAKE_FILL[np.dtype(_ROW_LANE_DTYPES[n])] for n in names]
    V = srcs[0].shape[0]
    idx8 = torch.randint(0, 256, tuple(idx.shape), generator=gen,
                         dtype=torch.uint8).to(dev)
    # hostile: wrapping negatives, and indices outside [-V, V)
    idx32 = torch.randint(-V - 64, V + 64, tuple(idx.shape), generator=gen,
                          dtype=torch.int32).to(dev)
    idx16 = uint16_index(rng, tuple(idx.shape), V).to(dev)
    err = 0.0
    widths = set()
    for label, ix in ((f"tile row_idx {idx.dtype}", idx), ("uint8", idx8),
                      ("hostile uint16", idx16), ("hostile int32", idx32)):
        widths.add(ix.element_size())
        got = kernels.vocab_gather(srcs, ix, fills)
        for n, src, f, g in zip(names, srcs, fills, got):
            err = max(err, exact(torch, f"vocab_gather {n} {label}", g,
                                 kernels.vocab_gather_plain(src, ix, f)))
        say("3", f"K5 vocab_gather {len(names)} lanes by {label} "
                 f"{tuple(ix.shape)} (V={V}): max abs err {err}")
    if widths != {1, 2, 4}:
        raise AssertionError(f"vocab_gather index widths {sorted(widths)}")
    flat = kernels._index_plain(idx).reshape(-1)
    lib = [torch.index_select(src, 0, flat).view(tuple(idx.shape))
           for src in srcs]
    for g, want in zip(kernels.vocab_gather(srcs, idx, fills), lib):
        exact(torch, "vocab_gather vs index_select", g, want)
    out_bytes = sum(idx.numel() * src.element_size() for src in srcs)
    results["vocab_gather"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.vocab_gather(srcs, idx, fills),
                lambda: [kernels.vocab_gather_plain(src, idx, f)
                         for src, f in zip(srcs, fills)],
                lambda: [torch.index_select(src, 0, flat) for src in srcs]),
        "bound": bound(idx.numel() * idx.element_size()
                       + sum(src.numel() * src.element_size() for src in srcs)
                       + out_bytes, 0),
    }
    pad = float((kernels._index_plain(idx) == 0).float().mean())
    results["launch_floor_ms"] = launch_floor_ms(torch)
    say("3", f"K5 vocab_gather bound inputs: {idx.numel()} cells "
             f"({pad:.4f} of them padding, index 0), {out_bytes} bytes "
             f"written; one launch's floor (a 4-byte fill replayed): "
             f"{results['launch_floor_ms']:.4f} ms")
    # the launch plan
    elems = [src.element_size() for src in srcs]
    plan = kernels.VocabPlan(elems, idx.numel())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # the share of cells that gather a live row (the rest read row 0),
    # and a fill of the same bytes (the stores alone)
    def as_index(t):  # int32 values -> the tile's index dtype
        if idx.dtype == torch.uint16:
            return t.to(torch.int16).view(torch.uint16).to(dev)
        return t.to(idx.dtype).to(dev)

    shape = tuple(idx.shape)
    live = {label: graph_ms(torch, lambda ix=ix: kernels.vocab_gather(
        srcs, ix, fills)) for label, ix in (
        ("none", as_index(torch.zeros(shape, dtype=torch.int32))),
        ("the tile's", idx),
        ("all", as_index(torch.randint(1, V, shape, generator=gen,
                                       dtype=torch.int32))))}
    fill_out = torch.empty(out_bytes, dtype=torch.uint8, device=dev)
    fill_ms = graph_ms(torch, lambda: fill_out.fill_(7))
    del fill_out
    results["vocab_gather"].update(
        plan={"lanes_1": plan.n1, "lanes_4": len(elems) - plan.n1,
              "chunks_1": plan.chunks1, "chunks_4": plan.chunks4,
              "sms": sms},
        live_ms=live, fill_ms=fill_ms)
    say("3", f"K5 vocab_gather plan: {plan.n1} 1-byte lanes in "
             f"{plan.chunks1} chunks and {len(elems) - plan.n1} 4-byte lanes "
             f"in {plan.chunks4} chunks of {kernels.VOCAB_GATHER_THREADS} "
             f"vectors, looped over by the blocks {sms} SMs hold resident")
    say("3", "K5 vocab_gather ms by the cells that gather a live row: "
             + ", ".join(f"{k} {t:.4f}" for k, t in live.items())
             + f"; a fill of its {out_bytes} output bytes {fill_ms:.4f} ms")

    # K5, the pool rows and their lengths
    sidx, svocab, slen = lanes["pool_sidx"], lanes["pool_svocab"], \
        lanes["pool_slen"]
    Sv = svocab.shape[0]
    sidx32 = torch.randint(-Sv - 8, Sv + 8, tuple(sidx.shape), generator=gen,
                           dtype=torch.int32).to(dev)
    sidx8 = torch.randint(0, 256, tuple(sidx.shape), generator=gen,
                          dtype=torch.uint8).to(dev)
    sidx16 = uint16_index(rng, tuple(sidx.shape), Sv).to(dev)
    err = 0.0
    widths = set()
    for label, ix in ((f"tile pool_sidx {sidx.dtype}", sidx),
                      ("uint8", sidx8), ("hostile uint16", sidx16),
                      ("hostile int32", sidx32)):
        widths.add(ix.element_size())
        rows, lens = kernels.vocab_gather_rows(svocab, slen, ix)
        wrows, wlens = kernels.vocab_gather_rows_plain(svocab, slen, ix)
        err = max(err, exact(torch, f"vocab_gather_rows {label}", rows, wrows),
                  exact(torch, f"vocab_gather_rows len {label}", lens, wlens))
        say("3", f"K5 vocab_gather_rows by {label} {tuple(ix.shape)} "
                 f"(Sv={Sv}, W={svocab.shape[1]}): max abs err {err}")
    if widths != {1, 2, 4}:
        raise AssertionError(f"vocab_gather_rows index widths {sorted(widths)}")
    sflat = kernels._index_plain(sidx).reshape(-1)
    results["vocab_gather_rows"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.vocab_gather_rows(svocab, slen, sidx),
                lambda: kernels.vocab_gather_rows_plain(svocab, slen, sidx),
                lambda: (torch.index_select(svocab, 0, sflat),
                         torch.index_select(slen, 0, sflat))),
        "bound": bound(sidx.numel() * sidx.element_size() + svocab.numel()
                       + slen.numel() * 4
                       + sidx.numel() * (svocab.shape[1] + 4), 0),
    }

    # the tile's dense lanes, as the step gathers them
    view = {n: g for n, g in zip(names, kernels.vocab_gather(srcs, idx,
                                                             fills))}
    pool, pool_len = kernels.vocab_gather_rows(svocab, slen, sidx)
    valid = view["valid"] != 0
    N, R = idx.shape

    # K6 on the path's norm lanes: one constant AND valid (_mask), and
    # sets of 0, 5 and 40 constants
    hi, lo = view["norm_hi"], view["norm_lo"]
    # constants drawn from valid rows (so the masks have hits)
    live = torch.nonzero(valid.reshape(-1)).reshape(-1)
    pick = live[torch.randint(0, live.numel(), (40,), generator=gen).to(dev)]
    pairs = torch.stack([hi.reshape(-1), lo.reshape(-1)], 1)[pick].cpu().tolist()
    pairs = [tuple(p) for p in pairs]
    err = 0.0
    for k, v in ((1, valid), (0, None), (1, None), (5, valid), (40, None)):
        consts = kernels.hash_consts(pairs[:k], dev)
        got = kernels.hash_match(hi, lo, consts, v)
        err = max(err, exact(torch, f"hash_match k={k}", got,
                             kernels.hash_match_plain(hi, lo, consts, v)))
        say("3", f"K6 hash_match {tuple(hi.shape)} k={k} "
                 f"valid={'yes' if v is not None else 'no'}: "
                 f"{int(got.sum())} hits, max abs err {err}")
    one = kernels.hash_consts(pairs[:1], dev)
    results["hash_match"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.hash_match(hi, lo, one, valid),
                lambda: kernels.hash_match_plain(hi, lo, one, valid)),
        "bound": bound(N * R * (4 + 4 + 1 + 1), N * R * 3),
    }

    # K7: a pool-slot accept column of the PSS bank (a strided view)
    bank = scanner.cps.dfa
    ids = bank.families["pool"]
    acc = dfa_mod.bank_match(bank, ids, pool, pool_len)  # (N, K, patterns)
    plane = acc[..., 0]
    err = 0.0
    for lane in ("byte_slot", "key_byte_slot"):
        slot = view[lane]
        got = kernels.pool_rows(plane, slot)
        err = max(err, exact(torch, f"pool_rows {lane}", got,
                             kernels.pool_rows_plain(plane, slot)))
        say("3", f"K7 pool_rows plane {tuple(plane.shape)} strides "
                 f"{plane.stride()} by {lane} {tuple(slot.shape)} "
                 f"({kernels.pool_rows_form(plane, slot)}): "
                 f"{int(got.sum())} rows, max abs err {err}")
    slot = view["byte_slot"]
    safe = torch.clamp(slot, 0, plane.shape[1] - 1).to(torch.int64)
    pc = plane.contiguous()
    results["pool_rows"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.pool_rows(plane, slot),
                lambda: kernels.pool_rows_plain(plane, slot),
                lambda: torch.gather(pc, 1, safe)),
        "bound": bound(N * R * 5 + plane.shape[0] * plane.shape[1], N * R * 3),
    }

    # K8 over the masks its caller builds on this tile: rows whose map
    # KEY matches the PSS bank's apparmor glob (the wildcard anchor of
    # restrict-apparmor-profiles), most resources having none
    col = ids.index(bank.glob_ids[
        "container.apparmor.security.beta.kubernetes.io/*"])
    accept = kernels.pool_rows(acc[..., col], view["key_byte_slot"])
    pred = view["type_tag"] == 4  # string rows
    has, _ = phase3_kernel(torch, kernels, "first_true_take", (accept, pred),
                           results, tag)
    say("3", f"K8 first_true_take {tuple(accept.shape)}: {int(has.sum())} "
             f"resources with a true row")
    # K8 at the dense and tenant programs' shape, on seeded masks with
    # the tile's share of resources that have a true row, at a random
    # row (the first or the last row for some)
    share = float(has.float().mean())
    phase3_kernel(torch, kernels, "first_true_take",
                  take_masks(torch, 16384, 256, share, seed, dev), results,
                  tag, key="first_true_take_dense")

    # K4's uint8 output on a (rules, tile) table
    rules = len(scanner.cps.device_programs)
    table = torch.randint(0, 7, (rules, N), generator=gen,
                          dtype=torch.int32).to(dev)
    phase3_kernel(torch, kernels, "verdict_counts_u8", (table,), results, tag,
                  plain_reps=20)


def take_masks(torch, N, R, share, seed, dev):
    """Seeded K8 masks: ``share`` of the resources have one true accept
    row, at a random row (one in eight of them the first, one in eight
    the last), the rest none; pred is true in half the rows."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    live = torch.rand((N,), generator=gen) < share
    row = torch.randint(0, R, (N,), generator=gen)
    pick = torch.randint(0, 8, (N,), generator=gen)
    row = torch.where(pick == 0, torch.zeros_like(row), row)
    row = torch.where(pick == 1, torch.full_like(row, R - 1), row)
    accept = torch.zeros((N, R), dtype=torch.bool)
    accept[torch.nonzero(live).reshape(-1), row[live]] = True
    pred = torch.rand((N, R), generator=gen) < 0.5
    return accept.to(dev), pred.to(dev)


# ---------------------------------------------------------------------------


def dense_phase(torch, kernels, eng, policies, resources, ops, padded, pops,
                n, tag, results):
    """Phase 4: the dense TorchEngine path. Returns its launch counts;
    puts K11's time over the program's launches in ``results``."""
    from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device

    ladder_reset()
    kernels.reset_launches()
    zero_stats(eng.cps.device_fn())
    t0 = time.perf_counter()
    res = eng.scan(resources, operations=ops)
    scan_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    line, st = program_stats(eng.cps.device_fn())
    say("4", f"TorchEngine.scan N={n}: table {res.verdicts.shape}, "
             f"{scan_s:.3f} s end to end {tag}; launches {launches}")
    say("4", f"the program: {line}")
    for name in DENSE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"dense path never launched {name}")
    if launches["instance_count"] != st["inst_issued"] \
            or launches["instance_count"] > DENSE_K3_MAX:
        raise AssertionError(f"dense program: {launches['instance_count']} "
                             f"one-level K3 launches ({st['inst_issued']} "
                             f"issued), want at most {DENSE_K3_MAX}")
    if res.verdicts.shape != (len(eng.cps.rules), n):
        raise AssertionError(f"table shape {res.verdicts.shape}")
    if not ((res.verdicts >= 0) & (res.verdicts <= 4)).all():
        raise AssertionError("completed table holds codes outside 0..4")
    say("4", "completed table covers every rule, codes 0..4 only: "
             + json.dumps(res.counts()))

    small = 257
    cpu_eng = TorchEngine(cps=eng.cps, device="cpu")
    cpu = cpu_eng.scan_device(resources[:small], operations=ops[:small])
    gpu = eng.scan_device(resources[:small], operations=ops[:small])
    if not ((cpu[0] == gpu[0]).all() and (cpu[1] == gpu[1]).all()):
        raise AssertionError("card device table differs from the CPU run on "
                             f"{small} resources")
    cfull = cpu_eng.scan(resources[:small], operations=ops[:small])
    gfull = eng.scan(resources[:small], operations=ops[:small])
    if not (cfull.verdicts == gfull.verdicts).all():
        raise AssertionError("card scan differs from the CPU scan on "
                             f"{small} resources")
    probe = [{"apiVersion": "v1", "kind": "Pod",
              "metadata": {"name": "priv", "namespace": "d"},
              "spec": {"containers": [{"name": "c", "image": "nginx",
                                       "securityContext": {"privileged": True}}]}},
             {"apiVersion": "v1", "kind": "Pod",
              "metadata": {"name": "ok", "namespace": "d"},
              "spec": {"containers": [{"name": "c", "image": "nginx"}]}}]
    pr = eng.scan(probe)
    row = pr.rules.index(("disallow-privileged-containers",
                          "privileged-containers"))
    if pr.verdicts[row].tolist() != [2, 0]:
        raise AssertionError(f"privileged probe: {pr.verdicts[row].tolist()}")
    say("4", f"small input ({small}) equals the CPU run (device table and "
             "completed table); privileged probe FAIL / plain probe PASS")

    t0 = time.perf_counter()
    batch = eng.encode(padded, None, pops)[0]
    encode_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lanes = lanes_to_device(batch, eng.device)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    lane_bytes = sum(v.nbytes for v in batch.values())
    # the program as a CUDA graph (its key first seen by the scan above) against
    # the eager program and the plain-twin program, on the same lanes
    graph = eng.cps.device_fn(device=eng.device)
    gr = graph_check(torch, kernels, "4", "the dense program", graph, lanes,
                     eng.cps.device_fn(plain=True), tag, top=True)
    program_ms = gr["replay_ms"]
    results["class_fold"] = gr["k11"]
    results["row_fold"] = gr["k12"]
    if gr["row_reductions"]:
        raise AssertionError(f"the dense program reduces rows with torch "
                             f"{gr['row_reductions']} times outside K12")
    # where the eager run's operations and device time go
    from kyverno_tpu_torch.tpu import evaluator as ev

    N, R = lanes["norm_hi"].shape
    I = eng.cps.encode_cfg.max_instances
    with Sites(ev) as sites:
        census = op_census(torch, lambda: graph.run(lanes), N, I, R, sites)
    say("4", f"aten operations of one eager dense run by output shape kind "
             f"{json.dumps(census['by_kind'], sort_keys=True)}: class logic "
             f"((N,), (N, I), (N, I, J)) {census['class_logic']}, total "
             f"{census['total']} (record_function ranges included)")
    for site, kinds in sorted(census["by_site"].items(),
                              key=lambda kv: -sum(kv[1].values()))[:12]:
        say("4", f"  aten operations at {site}: {sum(kinds.values())} "
                 f"{json.dumps(kinds, sort_keys=True)}")
    with Sites(ev) as sites:
        dp = device_profile(torch, lambda: graph.run(lanes), sites)
    say("4", f"one eager dense run: {dp['device_events']} device events, "
             f"{dp['device_ms']:.3f} ms of device time; torch kernels' time "
             f"by call site {tag}:")
    for site, ms in list(dp["by_site_ms"].items())[:14]:
        say("4", f"  device ms at {site}: {ms:.3f}")
    gr["census"] = census
    table, counts = eng.run(lanes)
    peak = torch.cuda.max_memory_allocated()
    for label, fn in (("eager", graph.run), ("replayed", graph)):
        share = busy_share(torch, lambda: fn(lanes))
        say("4", f"device busy share of the dense program, {label} "
                 "(torch.profiler, 3 runs): " + (
                     "not measured (no device activity in the trace)"
                     if share is None else
                     f"{share['busy_share']:.4f} ({share['busy_ms']:.3f} ms "
                     f"busy of a {share['window_ms']:.3f} ms window, "
                     f"{share['device_events']} device events)") + f" {tag}")
        gr[f"busy_{label}"] = share
    t0 = time.perf_counter()
    dtab = table.cpu().numpy()
    counts.cpu().numpy()
    readback_ms = (time.perf_counter() - t0) * 1e3
    # the completed table keeps every device verdict the host did not
    # have to complete
    for ri, e in enumerate(eng.cps.rules):
        if e.device_row is None:
            continue
        d = dtab[e.device_row, :n]
        keep = d < 5
        if not (res.verdicts[ri][keep] == d[keep]).all():
            raise AssertionError(f"completed row {e.rule_name} differs from "
                                 "the device table on device-decided cells")
    host_cells = int((dtab[:, :n] >= 5).sum())
    say("4", f"completed table equals the device table on its {dtab[:, :n].size - host_cells} "
             f"device-decided cells; {host_cells} HOST/CONFIRM cells completed "
             "on the host")
    cells = len(eng.cps.device_programs) * n
    say("4", f"encode {encode_s:.4f} s (host, {len(padded)} padded "
             f"resources, {lane_bytes} lane bytes) {tag}")
    say("4", f"H2D {h2d_ms:.3f} ms (pack into pinned memory + one copy) {tag}")
    say("4", f"program {gr['eager_ms']:.3f} ms eager, {program_ms:.3f} ms "
             f"replayed (medians of 5) {tag}")
    say("4", f"readback {readback_ms:.3f} ms {tag}")
    say("4", f"{cells / (program_ms / 1e3):.0f} rule x resource evals/s "
             f"on the replayed program, {cells / scan_s:.0f} end to end {tag}")
    say("4", f"peak device memory of the lanes and the program {peak} "
             f"bytes {tag}")
    del lanes, table, counts

    # the stride-1 scan entry on the same path: the PSS bank compiled
    # with KYVERNO_TPU_DFA_STRIDE=1, counted on its own
    old = os.environ.get("KYVERNO_TPU_DFA_STRIDE")
    os.environ["KYVERNO_TPU_DFA_STRIDE"] = "1"
    eng1 = TorchEngine(policies)
    if old is None:
        os.environ.pop("KYVERNO_TPU_DFA_STRIDE")
    else:
        os.environ["KYVERNO_TPU_DFA_STRIDE"] = old
    kernels.reset_launches()
    res1 = eng1.scan(resources, operations=ops)
    launches1 = dict(kernels.LAUNCHES)
    say("4", f"TorchEngine.scan with KYVERNO_TPU_DFA_STRIDE=1: launches "
             f"{launches1}")
    if launches1["dfa_scan_stride1"] <= 0:
        raise AssertionError("stride-1 path never launched dfa_scan_stride1")
    if not (res1.verdicts == res.verdicts).all():
        raise AssertionError("stride-1 scan differs from the stride-4 scan")
    say("4", "stride-1 completed table equals the stride-4 scan")
    launches["dfa_scan_stride1"] = launches1["dfa_scan_stride1"]
    ladder_check("4")
    return launches, gr


def scan_phase(torch, kernels, scanner, policies, scan_n, tile, seed, tag):
    """Phase 5: the background scan (ShardedScanner.scan_stream over the
    vocabulary form). Returns its launch counts, the step's graph check
    and the snapshot with its table (phase 10's feed)."""
    import warnings

    import numpy as np

    from kyverno_tpu_torch import native
    from kyverno_tpu_torch.parallel.sharding import ShardedScanner
    from kyverno_tpu_torch.tpu.engine import TorchEngine
    from kyverno_tpu_torch.tpu.evaluator import build_program

    say("5", "host encoder: " + ("native (fastencode.c)"
                                 if native.load() is not None
                                 else "Python walk (native build unavailable)"))
    t0 = time.perf_counter()
    resources, ops = workload(scan_n, seed)
    say("5", f"snapshot of {scan_n} resources generated in "
             f"{time.perf_counter() - t0:.3f} s (host)")

    ladder_reset()
    kernels.reset_launches()
    zero_stats(scanner.step_jitted())
    t0 = time.perf_counter()
    res, stats = scanner.scan_stream(resources, tile=tile, operations=ops)
    scan_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    say("5", f"the step over {-(-scan_n // tile)} tiles: "
             + program_stats(scanner.step_jitted())[0])
    say("5", f"ShardedScanner.scan_stream {scan_n} resources, tile {tile}: "
             f"{scan_s:.3f} s end to end, {scan_n / scan_s:.1f} resources/s, "
             f"{len(scanner.cps.rules) * scan_n / scan_s:.0f} rule x "
             f"resource evals/s {tag}")
    say("5", "stats " + json.dumps(stats) + f" {tag}")
    say("5", f"launches {launches}")
    for name in SCAN_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"background scan never launched {name}")
    if res.verdicts.shape != (len(scanner.cps.rules), scan_n):
        raise AssertionError(f"scan table {res.verdicts.shape}: not every "
                             "rule x resource")
    if res.rules != [(e.policy_name, e.rule_name) for e in scanner.cps.rules]:
        raise AssertionError("scan rules differ from the compiled rules")
    if not ((res.verdicts >= 0) & (res.verdicts <= 4)).all():
        raise AssertionError("scan table holds codes outside 0..4")
    if stats["tiles"] != -(-scan_n // tile):
        raise AssertionError(f"{stats['tiles']} tiles for {scan_n} resources")
    say("5", "table covers every rule and resource, codes 0..4 only: "
             + json.dumps(res.counts()))

    # the first tile against the dense engine
    first, fops = resources[:tile], ops[:tile]
    dense = TorchEngine(cps=scanner.cps)
    sv, _ = scanner.scan_device(first, operations=fops)
    dv, _ = dense.scan_device(first, operations=fops)
    if sv.dtype != np.uint8 or not (sv.astype(np.int32) == dv).all():
        raise AssertionError("first tile: scan_device table differs from the "
                             "dense TorchEngine device table")
    dfull = dense.scan(first, operations=fops)
    if not (res.verdicts[:, :len(first)] == dfull.verdicts).all():
        raise AssertionError("first tile: scan_stream columns differ from "
                             "TorchEngine.scan")
    say("5", f"first tile ({len(first)}): scan_device table equals the dense "
             "device table; scan_stream columns equal TorchEngine.scan")

    # the step against the plain-twin step on the same vocabulary lanes
    pad = tile - len(first)
    host, _ = scanner.encode(list(first) + [{}] * pad, None,
                             list(fops) + [""] * pad)
    t0 = time.perf_counter()
    lanes = scanner.put(host)[0]  # one device: one shard
    torch.cuda.synchronize()
    put_ms = (time.perf_counter() - t0) * 1e3
    v, c = scanner.step_jitted()(lanes)
    plain = build_program(scanner.cps.device_programs,
                          scanner.cps.encode_cfg.max_instances,
                          dfa=scanner.cps.dfa, plain=True, verdicts_u8=True,
                          nfa_globs=scanner.cps.nfa_globs)
    pv, pc = plain(lanes)
    if not (torch.equal(v, pv) and torch.equal(c, pc)):
        raise AssertionError("step differs from the plain-twin step")
    say("5", "step (uint8 table and counts) equals the plain-twin step on "
             "the same vocabulary lanes")

    # the step never waits for the device, eager or replayed (the
    # graph of these lanes' bucket exists by now)
    step = scanner.step_jitted()
    step(lanes)
    torch.cuda.synchronize()
    for label, fn in (("eager", step.run), ("replayed", step)):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn(lanes)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message).lower()]
        if syncs:
            raise AssertionError(f"the {label} step synchronizes the host "
                                 f"{len(syncs)} times: {syncs[:3]}")
    say("5", "the step issued no synchronizing operation, eager or "
             "replayed (torch.cuda.set_sync_debug_mode)")

    # 257 resources: the CPU scanner against the card's
    small = 257
    cpu = ShardedScanner(policies, device="cpu")
    a = cpu.scan(resources[:small], operations=ops[:small])
    b = scanner.scan(resources[:small], operations=ops[:small])
    if not (a.verdicts == b.verdicts).all() or a.rules != b.rules:
        raise AssertionError(f"card scan differs from the CPU scan on {small}")
    say("5", f"ShardedScanner(device='cpu').scan of {small} resources equals "
             "the card's")

    # steady-state step on one resident tile (bench.py's measure),
    # eager and replayed, against the plain-twin step
    gr = graph_check(torch, kernels, "5", "the step", step, lanes, plain,
                     tag)
    step_ms = gr["replay_ms"]
    cells = len(scanner.cps.device_programs) * tile
    say("5", f"steady-state step {gr['eager_ms']:.3f} ms eager, "
             f"{step_ms:.3f} ms replayed (medians of 5) on one resident "
             f"{tile}-resource tile: {cells / (step_ms / 1e3):.0f} rule x "
             f"resource evals/s replayed {tag}")
    vocab_bytes = sum(a.nbytes for a in host.values())
    dpad, dops, _ = dense.pad(first, fops)
    dense_host = dense.encode(dpad, None, dops)[0]
    dense_bytes = sum(a.nbytes for a in dense_host.values())
    say("5", f"lane bytes per {tile}-resource tile: vocabulary form "
             f"{vocab_bytes}, dense form {dense_bytes} "
             f"({dense_bytes / vocab_bytes:.1f}x); put (pack + one copy) "
             f"{put_ms:.3f} ms {tag}")
    say("5", f"row_idx {host['row_idx'].dtype} {host['row_idx'].shape}, "
             f"pool_sidx {host['pool_sidx'].dtype} {host['pool_sidx'].shape}, "
             f"{len([k for k in host if k.startswith('vocab_')])} vocabulary "
             f"lanes of {host['vocab_valid'].shape[0]} rows")
    ladder_check("5")
    feed = {"resources": resources, "ops": ops, "verdicts": res.verdicts,
            "scan_s": scan_s, "stats": stats}
    return launches, gr, feed


# ---------------------------------------------------------------------------
# the tenant set: a namespace glob per tenant, more than the bank holds


def tenant_policy():
    """One validate rule (a ``team`` label on Pods) and one mutate rule
    (stamp ``+(team)``), both matching the tenant namespace globs."""
    from kyverno_tpu_torch.api.policy import ClusterPolicy

    def match():
        return {"resources": {"kinds": ["Pod"],
                              "namespaces": list(TENANT_GLOBS)}}

    return ClusterPolicy.from_dict({
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "tenant"},
        "spec": {"validationFailureAction": "Enforce", "rules": [
            {"name": "require-team", "match": match(),
             "validate": {"message": "team label required", "pattern":
                          {"metadata": {"labels": {"team": "?*"}}}}},
            {"name": "stamp-team", "match": match(),
             "mutate": {"patchStrategicMerge":
                        {"metadata": {"labels": {"+(team)": "core"}}}}}]}})


def glob_instance(rng, glob: str, nonascii: bool = False) -> str:
    """A string the glob accepts: '*' becomes a short token, '?' a
    letter; ``nonascii`` puts an 'é' (two UTF-8 bytes) in the first '*'
    or '?' instead."""
    out = []
    for c in glob:
        if c in "*?":
            tok = (rng.choice("abcxyz") if c == "?" else
                   "".join(rng.choice("abcxyz0123")
                           for _ in range(rng.randint(1, 6))))
            if nonascii:
                tok, nonascii = "é", False
            out.append(tok)
        else:
            out.append(c)
    return "".join(out)


def tenant_workload(n: int, seed: int, in_bank, nfa):
    """Seeded Pods (3 in 4) and Namespaces whose namespace (or name)
    is drawn from globs in the bank, globs on the NFA route ('?' ones
    among them) and default / kube-system; about 1 in 50 carries a
    non-ASCII byte."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        r = rng.random()
        glob = (rng.choice(in_bank) if r < 0.4 else
                rng.choice(nfa) if r < 0.85 else None)
        odd = rng.random() < 0.02
        ns = (rng.choice(["default", "kube-system"]) if glob is None
              else glob_instance(rng, glob, odd))
        if rng.random() < 0.25:
            out.append({"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": ns}})
            continue
        meta = {"name": f"pod-{i}", "namespace": ns}
        if rng.random() < 0.5:
            meta["labels"] = {"team": rng.choice(["a", "b", "c"])}
        out.append({"apiVersion": "v1", "kind": "Pod", "metadata": meta,
                    "spec": {"containers": [{"name": "c", "image": "nginx"}]}})
    return out


def glob_subjects(torch, rng, pattern: str, S: int, W: int):
    """(S, W) uint8 / (S,) int32 seeded subjects: half instances of the
    pattern, half noise over its bytes, NUL and non-ASCII bytes."""
    import numpy as np

    alpha = np.array(sorted({ord(c) & 0xFF for c in pattern
                             if c not in "*?"}) + [0, 0x2D, 0x61, 0xE9],
                     dtype=np.uint8)
    byt = rng.choice(alpha, size=(S, W)).astype(np.uint8)
    lens = rng.integers(0, W + 1, size=(S,)).astype(np.int32)
    # about 16 stars of an instance take bytes, so long patterns fit
    take = 16 / max(16, pattern.count("*"))
    for i in range(0, S, 2):
        inst = []
        for c in pattern:
            if c == "*":
                k = int(rng.integers(0, 3)) if rng.random() < take else 0
                inst += list(rng.choice(alpha, size=k))
            elif c == "?":
                inst.append(int(rng.choice(alpha[alpha != 0])))
            else:
                inst.append(ord(c) & 0xFF)
        inst = inst[:W]
        byt[i, :len(inst)] = inst
        lens[i] = len(inst)
    return torch.from_numpy(byt), torch.from_numpy(lens)


def check_glob_nfa(torch, kernels, lanes, nfa, seed, results):
    """Packed K9 against its plain twin on the tenant batch's namespace,
    name and pool lanes, with real and hostile lengths, over the packs
    of the tenant's NFA-route globs and every pattern class (1, 2 and 8
    64-bit state words); the pack of one (``glob_nfa``) against the same
    rows and on 320-byte seeded subjects (2 to 16 state words). Then the
    packed launch timed on the namespace lane beside the pack of one,
    and B4's standalone non-ASCII entry at the tenant scan and triage
    shapes."""
    import numpy as np

    dev = lanes["meta_ns_bytes"].device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rng = np.random.default_rng(seed)
    qglob = next(g for g in nfa if "?" in g)
    classes = [nfa[0], qglob, "", "*", "***", "?", "a*b?c*", "é*", "中?",
               "a" * 63, "a" * 64, "a" * 65, ("ab*?" * 75)[:299]]
    packs = kernels.glob_packs(list(nfa) + [c for c in classes
                                            if c not in nfa])
    words = [p.nw for p in packs]
    if words != [1, 2, 8]:
        raise AssertionError(f"glob packs of {words} state words")
    planes = [("ns", lanes["meta_ns_bytes"], lanes["meta_ns_len"]),
              ("name", lanes["meta_name_bytes"], lanes["meta_name_len"]),
              ("pool", lanes["pool"], lanes["pool_len"])]
    err = 0.0
    words = set()
    for label, byt, ln in planes:
        W = byt.shape[-1]
        hostile = torch.randint(-3, W + 6, tuple(ln.shape), generator=gen,
                                dtype=torch.int32).to(dev)
        for lname, lens in (("lengths", ln), ("hostile lengths", hostile)):
            hits = 0
            rows = {}
            for pack in packs:
                got = kernels.glob_nfa_pack(pack, byt, lens)
                err = max(err, exact(
                    torch, f"glob_nfa pack of {len(pack.patterns)} "
                           f"({pack.nw} words) {label} {lname}",
                    got, kernels.glob_nfa_pack_plain(pack, byt, lens)))
                hits += int(got.sum())
                rows.update(zip(pack.patterns, got))
            for p in classes:
                err = max(err, exact(torch, f"glob_nfa {p!r} {label} {lname}",
                                     kernels.glob_nfa(p, byt, lens), rows[p]))
            say("3", f"K9 glob_nfa {len(packs)} packs of "
                     f"{sum(len(p.patterns) for p in packs)} patterns on "
                     f"{label} {tuple(byt.shape)} with {lname}: {hits} "
                     f"accepts; the pack of one on {len(classes)} classes "
                     f"equal; max abs err {err}")
    # past one state word: 320-byte subjects (the label-key width)
    for p in ("a" * 65, ("ab*?" * 75)[:299], "a*" * 150, "a*" * 260):
        byt, lens = glob_subjects(torch, rng, p, 4096, 320)
        lens[:4] = torch.tensor([-1, 0, 320, 325], dtype=torch.int32)
        byt, lens = byt.to(dev), lens.to(dev)
        got = kernels.glob_nfa(p, byt, lens)
        err = max(err, exact(torch, f"glob_nfa m={len(p)} wide", got,
                             kernels.glob_nfa_plain(p, byt, lens)))
        words.add(kernels.glob_words(p))
        say("3", f"K9 glob_nfa m={len(kernels.glob_chars(p))} "
                 f"({kernels.glob_words(p)} state words) on {tuple(byt.shape)}"
                 f": {int(got.sum())} accepts, max abs err {err}")
    if not {2, 8, 16} <= words:
        raise AssertionError(f"glob_nfa state words run: {sorted(words)}")

    # timed at the main path's shape: the pack of the tenant's NFA-route
    # globs over the batch's namespace lane (one launch per family)
    byt, ln = lanes["meta_ns_bytes"], lanes["meta_ns_len"]
    S, W = byt.shape
    (pack,) = kernels.glob_packs(nfa)
    P = len(pack.patterns)
    steps = torch.stack([kernels.glob_nfa_plain(p, byt, ln,
                                                with_steps=True)[1]
                         for p in pack.patterns]).to(torch.int64)
    need = int(steps.sum())
    # memory moves the subjects once (the bytes any pattern of the pack
    # reads; the pairs read them again from shared memory), the lengths,
    # the tables and the (P, S) plane; the operations are the pairs'
    # steps
    subj = int(steps.max(dim=0).values.sum())
    tables = sum(t.nbytes for t in pack.on(dev))
    results["glob_nfa"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.glob_nfa_pack(pack, byt, ln),
                lambda: kernels.glob_nfa_pack_plain(pack, byt, ln),
                plain_eager=True),
        "bound": bound(S * 4 + subj + tables + P * S, need * pack.nw * 6),
        "pack_of_one_ms": graph_ms(
            torch, lambda: kernels.glob_nfa(pack.patterns[0], byt, ln)),
    }
    r = results["glob_nfa"]
    say("3", f"K9 packed over {P} globs x {S} subjects of {W} bytes: "
             f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f}), bound "
             f"{r['bound'][0]:.6f} ms ({need} pair steps, {subj} subject "
             f"bytes, {tables} table bytes, {pack.classes} table rows); the "
             f"pack of one {r['pack_of_one_ms']:.4f} ms x {P} = "
             f"{r['pack_of_one_ms'] * P:.4f} ms")

    # B4's standalone entry (a family no K1 launch scans): on the
    # namespace lane at the tenant scan and triage shapes, and on seeded
    # accented subjects of the same shapes
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    floor = launch_floor_ms(torch)
    shapes = []
    for label, (b, l) in (
            ("namespace lane, scan", (byt, ln)),
            ("namespace lane, triage", (byt[:1024].contiguous(),
                                        ln[:1024].contiguous())),
            ("seeded, scan", accented(torch, gen, S, W, dev)),
            ("seeded, triage", accented(torch, gen, min(1024, S), W, dev))):
        na = kernels.nonascii(b, l)
        nerr = exact(torch, f"nonascii {label}", na,
                     kernels.nonascii_plain(b, l))
        n, w = b.shape
        live = torch.clamp(l, 0, w).to(torch.int64)
        pos = torch.arange(w, device=dev)[None, :]
        high = (b >= 0x80) & (pos < live[:, None])
        first = torch.where(high.any(-1), high.to(torch.uint8).argmax(-1) + 1,
                            live)
        nbytes = int(first.sum())
        row = {"label": label, "shape": [n, w], "max_abs_err": nerr,
               "nonascii": int(na.sum()), "floor_ms": floor,
               **timed(torch, lambda: kernels.nonascii(b, l),
                       lambda: kernels.nonascii_plain(b, l)),
               "bound": bound(nbytes + n * 4 + n, nbytes)}
        shapes.append(row)
        say("3", f"B4 nonascii alone, {label} {tuple(b.shape)}: "
                 f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}), plain "
                 f"{row['plain_ms']:.4f} ms, bound {row['bound'][0]:.6f} ms "
                 f"({nbytes} bytes up to the first non-ASCII byte or the "
                 f"length), a launch's floor {floor:.4f} ms, "
                 f"{row['nonascii']} non-ASCII subjects, max abs err {nerr}")
    results["nonascii"] = dict(shapes[0], shapes=shapes)


def check_meta_any(torch, kernels, eng, resources, lanes, batch_n, results):
    """K10 against its plain twin on the tenant policy's namespace list
    (3,264 entries a family: bank columns, K9 pack rows and two
    non-ASCII masks) at the tenant scan shape (the validate program over
    ``lanes``) and the triage shape (the mutate program over the first
    ``batch_n`` resources), with the arguments the evaluator gives it
    (``Ctx.meta_any_args``). Bound: the plane cells of the entries, the
    hash lanes, the masks, the entry table and the two outputs over
    3.35 TB/s; or a compare a cell over 67 TOPS."""
    from kyverno_tpu_torch.tpu.engine import lanes_to_device
    from kyverno_tpu_torch.tpu.evaluator import Ctx, NfaPacks, densify

    cps = eng.cps
    padded, _, _ = eng.pad(resources[:batch_n])
    tri_lanes = lanes_to_device(eng.encode(padded)[0], eng.device)
    shapes = (("scan", lanes, cps.device_programs, cps.nfa_globs),
              ("triage", tri_lanes, cps.mutate_programs,
               cps.mutate_nfa_globs))
    out = []
    for shape, ln, programs, nfa in shapes:
        flt = next(f for p in programs for f in p.match.filters
                   if len(f.namespaces) >= len(TENANT_GLOBS))
        ctx = Ctx(densify(ln), cps.encode_cfg.max_instances, dfa=cps.dfa,
                  nfa=NfaPacks(nfa))
        args = ctx.meta_any_args("namespaces", flt.namespaces)
        table, planes, hashes, is_ns, na = args
        got = kernels.meta_any(*args)
        want = kernels.meta_any_plain(*args)
        err = max(exact(torch, f"K10 meta_any {shape} {w}", g, p)
                  for w, g, p in zip(("hit", "confirm"), got, want))
        N = hashes[0].shape[0]
        E = table.ent.shape[0]
        e_plane = int((table.ent[:, 0] >= 0).sum())
        nbytes = (N * e_plane + sum(h.numel() * 4 for h in hashes)
                  + table.ent.nbytes + N * (1 + sum(m is not None for m in na))
                  + 2 * N)
        r = timed(torch, lambda: kernels.meta_any(*args),
                  lambda: kernels.meta_any_plain(*args))
        # every tile a block may serve, each equal to the twin
        tile_ms = {}
        for R in kernels.META_ANY_TILES:
            for w, g, p in zip(("hit", "confirm"),
                               kernels.meta_any(*args, tile=R), want):
                exact(torch, f"K10 meta_any {shape} {w} tile {R}", g, p)
            tile_ms[R] = graph_ms(torch,
                                  lambda R=R: kernels.meta_any(*args, tile=R))
        r.update(tile=kernels.meta_any_tile(N), tile_ms=tile_ms)
        r.update({"name": "meta_any", "shape": shape, "N": N, "E": E,
                  "plane_entries": e_plane, "planes": len(planes),
                  "bytes": nbytes, "max_abs_err": err,
                  "bound": bound(nbytes, 2 * N * E), "library_ms": None})
        out.append(r)
        say("3", f"K10 meta_any at the tenant {shape} shape: N {N}, {E} "
                 f"entries ({e_plane} in {len(planes)} planes, "
                 f"{E - e_plane} hash pairs), hits {int(got[0].sum())}, "
                 f"confirms {int(got[1].sum())}, max abs err {err}; "
                 f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f}), plain "
                 f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms "
                 f"({r['bound'][1]}, {nbytes} bytes); tile {r['tile']} "
                 "chosen; every tile (equal to the twin): " + ", ".join(
                     f"{R} {ms:.4f} ms" for R, ms in tile_ms.items()))
    results["meta_any"] = out[0]
    results["meta_any_shapes"] = out
    del tri_lanes


def tenant_phase(torch, kernels, eng, resources, batch_n, compile_s, tag):
    """Phase 7: the tenant set's scan and mutate triage. Returns the
    launch counts of the scan and of the triage."""
    import numpy as np

    from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device

    n = len(resources)
    ladder_reset()
    kernels.reset_launches()
    zero_stats(eng.cps.device_fn())
    t0 = time.perf_counter()
    res = eng.scan(resources)
    scan_s = time.perf_counter() - t0
    lv = dict(kernels.LAUNCHES)
    line, st = program_stats(eng.cps.device_fn())
    say("7", f"TorchEngine.scan of {n} tenant resources: {scan_s:.3f} s end "
             f"to end {tag}; launches {lv}")
    say("7", f"the scan's program: {line}")
    for name in TENANT_KERNELS:
        if lv[name] <= 0:
            raise AssertionError(f"tenant scan never launched {name}")
    # one packed K9 launch per lane family (namespace and name)
    if lv["glob_nfa"] > 4 or st["nfa_unpacked"]:
        raise AssertionError(f"tenant scan: {lv['glob_nfa']} K9 launches, "
                             f"{st['nfa_unpacked']} unrecorded NFA globs")
    if res.verdicts.shape != (len(eng.cps.rules), n) or not (
            (res.verdicts >= 0) & (res.verdicts <= 4)).all():
        raise AssertionError("tenant scan: table not complete")
    say("7", "completed table over every rule, codes 0..4: "
             + json.dumps(res.counts()))

    # the program against the same program with the plain twins, on the
    # same lanes
    padded, _, _ = eng.pad(resources)
    t0 = time.perf_counter()
    batch = eng.encode(padded)[0]
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lanes = lanes_to_device(batch, eng.device)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    gv = graph_check(torch, kernels, "7", "the tenant scan program",
                     eng.cps.device_fn(device=eng.device), lanes,
                     eng.cps.device_fn(plain=True), tag)
    say("7", f"scan parts: encode {encode_s:.4f} s, H2D {h2d_ms:.3f} ms, "
             f"program {gv['eager_ms']:.3f} ms eager, {gv['replay_ms']:.3f} ms "
             f"replayed (host clock to a sync) {tag}")
    table, counts = eng.run(lanes)
    dtab = table.cpu().numpy()
    confirm = int((dtab[:, :n] == 6).sum())
    host = int((dtab[:, :n] == 5).sum())
    for ri, e in enumerate(eng.cps.rules):
        if e.device_row is None:
            continue
        d = dtab[e.device_row, :n]
        keep = d < 5
        if not (res.verdicts[ri][keep] == d[keep]).all():
            raise AssertionError(f"tenant row {e.rule_name}: completed table "
                                 "differs on device-decided cells")
    if confirm <= 0:
        raise AssertionError("no CONFIRM cell: the non-ASCII subjects of the "
                             "'?' globs did not reach the scan")
    say("7", f"{confirm} CONFIRM and {host} HOST cells of the device table "
             "completed on the host")
    del lanes, table, counts

    # mutate triage in batches
    eng.triage_dispatches = eng.triage_encode_fallbacks = 0
    kernels.reset_launches()
    zero_stats(eng.cps.mutate_device_fn())
    t0 = time.perf_counter()
    parts = [eng.triage_mutate(resources[i:i + batch_n])
             for i in range(0, n, batch_n)]
    triage_s = time.perf_counter() - t0
    lt = dict(kernels.LAUNCHES)
    line, st = program_stats(eng.cps.mutate_device_fn())
    say("7", f"triage_mutate of {n} in batches of {batch_n}: {triage_s:.3f} s,"
             f" {n / triage_s:.1f} resources/s {tag}; launches {lt}")
    say("7", f"the triage programs: {line}")
    for name in TRIAGE_KERNELS:
        if lt[name] <= 0:
            raise AssertionError(f"tenant triage never launched {name}")
    if lt["glob_nfa"] > 4 * len(parts) or st["nfa_unpacked"]:
        raise AssertionError(f"tenant triage: {lt['glob_nfa']} K9 launches "
                             f"over {len(parts)} batches, "
                             f"{st['nfa_unpacked']} unrecorded NFA globs")
    if eng.triage_dispatches != len(parts) or eng.triage_encode_fallbacks:
        raise AssertionError(f"{eng.triage_dispatches} device batches, "
                             f"{eng.triage_encode_fallbacks} encode fallbacks "
                             f"for {len(parts)} batches")
    dev_rows, rows = eng.mutate_coverage()
    if dev_rows != rows or rows == 0:
        raise AssertionError(f"mutate coverage {dev_rows}/{rows}")
    tri = np.concatenate([p.verdicts for p in parts], axis=1)
    counts = {k: sum(p.counts()[k] for p in parts)
              for k in ("positive", "negative", "host")}
    if counts["positive"] <= 0 or counts["negative"] <= 0:
        raise AssertionError(f"triage rows {counts}")
    say("7", f"triage rows {counts}; mutate coverage {dev_rows}/{rows} on "
             "the device; no batch took the encode fallback")
    # one batch against the plain-twin triage program
    first = resources[:batch_n]
    padded, _, _ = eng.pad(first)
    t0 = time.perf_counter()
    batch = eng.encode(padded)[0]
    encode_s = time.perf_counter() - t0
    lanes = lanes_to_device(batch, eng.device)
    torch.cuda.synchronize()
    gt = graph_check(torch, kernels, "7", "one tenant triage batch",
                     eng.cps.mutate_device_fn(device=eng.device), lanes,
                     eng.cps.mutate_device_fn(plain=True), tag)
    say("7", f"one triage batch of {len(first)}: encode {encode_s:.4f} s, "
             f"program {gt['eager_ms']:.3f} ms eager, {gt['replay_ms']:.3f} ms "
             f"replayed {tag}; {gt['ops_eager']} aten operations an eager "
             f"run (at most {TRIAGE_OPS_MAX})")
    if gt["ops_eager"] >= TRIAGE_OPS_MAX:
        raise AssertionError(f"a triage batch issues {gt['ops_eager']} aten "
                             f"operations eagerly, want < {TRIAGE_OPS_MAX}")
    del lanes

    # a slice against the CPU run
    small = 96
    cpu = TorchEngine(cps=eng.cps, device="cpu")
    t0 = time.perf_counter()
    if not (cpu.scan(resources[:small]).verdicts == res.verdicts[:, :small]
            ).all():
        raise AssertionError(f"tenant scan differs from the CPU on {small}")
    if not (cpu.triage_mutate(resources[:small]).verdicts == tri[:, :small]
            ).all():
        raise AssertionError(f"tenant triage differs from the CPU on {small}")
    say("7", f"scan and triage of {small} resources equal the CPU run "
             f"({time.perf_counter() - t0:.3f} s on the host)")
    say("7", f"compile {compile_s:.3f} s, scan {scan_s:.3f} s, triage "
             f"{triage_s:.3f} s; glob_nfa launches {lv['glob_nfa']} (scan) + "
             f"{lt['glob_nfa']} (triage) {tag}")
    ladder_check("7")
    return lv, lt, gv, gt


def mutate_leg_pod(i, ns):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"bench-{ns}-{i}", "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "nginx"}]}}


def mutate_leg_setup(n, tile):
    """bench.py's mutate leg (bench_mutate) at its own sizes: the engine
    over its two stamp policies, the policies, ``n`` Pods (1 in 20 in ``prod``) in
    tiles of ``tile``, and the namespace map."""
    from kyverno_tpu_torch.api.policy import ClusterPolicy
    from kyverno_tpu_torch.tpu.engine import TorchEngine

    def pol(name, rule, overlay):
        return ClusterPolicy.from_dict({
            "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name},
            "spec": {"validationFailureAction": "Enforce", "rules": [{
                "name": rule,
                "match": {"resources": {"kinds": ["Pod"],
                                        "namespaces": ["prod"]}},
                "mutate": {"patchStrategicMerge": overlay}}]}})

    policies = [
        pol("stamp-labels", "labels",
            {"metadata": {"labels": {"+(team)": "core", "env": "prod"}}}),
        pol("stamp-scheduling", "sched",
            {"spec": {"priority": 100, "dnsPolicy": "ClusterFirst"}})]
    eng = TorchEngine(policies)
    nsmap = {"prod": {}, "dev": {}}

    resources = [mutate_leg_pod(i, "prod" if i % 20 == 0 else "dev")
                 for i in range(n)]
    tiles = [resources[i:i + tile] for i in range(0, n, tile)]
    return eng, policies, tiles, nsmap


def mutate_leg_phase(torch, kernels, n, tile, tag):
    """Phase 8: bench.py's mutate leg (bench_mutate) at its own sizes.
    Returns the launch counts of the triage over the tiles."""
    import copy

    from kyverno_tpu_torch.mutation.coordinator import apply_mutations
    from kyverno_tpu_torch.tpu.engine import build_scan_context, lanes_to_device
    from kyverno_tpu_torch.tpu.evaluator import ERROR, FAIL, HOST, PASS

    eng, policies, tiles, nsmap = mutate_leg_setup(n, tile)
    ladder_reset()
    eng.triage_mutate(tiles[0], nsmap)  # first-use costs outside timing
    padded, _, _ = eng.pad(tiles[0])
    t0 = time.perf_counter()
    batch = eng.encode(padded, nsmap)[0]
    encode_s = time.perf_counter() - t0
    lanes = lanes_to_device(batch, eng.device)
    torch.cuda.synchronize()
    gm = graph_check(torch, kernels, "8", "one mutate-leg tile",
                     eng.cps.mutate_device_fn(device=eng.device), lanes,
                     eng.cps.mutate_device_fn(plain=True), tag)
    del lanes
    say("8", f"one tile of {len(tiles[0])}: encode {encode_s:.4f} s, program "
             f"{gm['eager_ms']:.3f} ms eager, {gm['replay_ms']:.3f} ms "
             f"replayed {tag}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    results = [eng.triage_mutate(t, nsmap) for t in tiles]
    triage_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    routed, negatives = [], []
    for t, res in zip(tiles, results):
        for ci, r in enumerate(t):
            rows = res.rows_for(ci)
            if any(c in (PASS, FAIL, ERROR) or c >= HOST for _, c in rows):
                routed.append((r, rows))
            else:
                negatives.append((r, rows))
    t0 = time.perf_counter()
    outs = [apply_mutations(eng, r, rows, namespace_labels={})
            for r, rows in routed]
    patch_s = time.perf_counter() - t0
    say("8", f"triage_mutate of {n} Pods in tiles of {tile}: "
             f"{triage_s:.4f} s, {n / triage_s:.1f} resources/s {tag}; "
             f"launches {launches}")
    say("8", f"apply_mutations over {len(routed)} routed: {patch_s:.4f} s, "
             f"{len(routed) / patch_s:.1f} patches/s {tag}")
    if len(routed) != -(-n // 20):
        raise AssertionError(f"{len(routed)} routed, want {-(-n // 20)}")
    for name in ("meta_any", "class_fold"):
        if launches[name] <= 0:
            raise AssertionError(f"the mutate leg never launched {name}")

    def scalar_chain(resource):
        patched = copy.deepcopy(resource)
        for p in policies:
            pctx = build_scan_context(p, patched, {}, "CREATE", None)
            resp = eng.scalar.mutate(pctx)
            if resp.patched_resource is not None:
                patched = resp.patched_resource
        return patched

    for (r, _), out in zip(routed, outs):
        if not out.changed or out.patched != scalar_chain(r):
            raise AssertionError(f"{r['metadata']['name']}: patched output "
                                 "differs from the scalar chain")
    templates = sum(o.template_rules for o in outs)
    for r, rows in negatives:
        out = apply_mutations(eng, r, rows, namespace_labels={})
        if out.changed or out.patched is not r or out.scalar_policies \
                or out.template_rules or scalar_chain(r) != r:
            raise AssertionError(f"negative {r['metadata']['name']} was "
                                 "touched")
    say("8", f"all {len(routed)} patched outputs equal the scalar chain "
             f"({templates} template stamps); all {len(negatives)} negatives "
             "come back unchanged")
    untouched = [mutate_leg_pod(i, "dev") for i in range(10_000, 10_512)]
    d0 = eng.triage_dispatches
    t0 = time.perf_counter()
    ures = eng.triage_mutate(untouched, nsmap)
    untouched_s = time.perf_counter() - t0
    calls = 0
    for ci, r in enumerate(untouched):
        out = apply_mutations(eng, r, ures.rows_for(ci), namespace_labels={})
        calls += out.scalar_policies + out.template_rules
    uc = ures.counts()
    if eng.triage_dispatches - d0 != 1 or calls or uc["positive"] or uc["host"]:
        raise AssertionError(f"all-negative batch: "
                             f"{eng.triage_dispatches - d0} dispatches, "
                             f"{calls} patcher calls, rows {uc}")
    say("8", f"all-negative batch of {len(untouched)}: one device dispatch, "
             f"no patcher call, {untouched_s:.4f} s {tag}")
    ladder_check("8")
    return launches, gm


def fault_phase(torch, kernels, eng, scanner, tenant, resources, ops,
                tenant_res, tag):
    """Phase 9: the guarded dispatch ladder on the card. Every table
    must equal the clean scan's and the CPU run's; fallbacks are counted
    here (the only phase where they are expected)."""
    import numpy as np

    from kyverno_tpu_torch.mutation.coordinator import apply_mutations
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.resilience.breaker import CLOSED, OPEN, tpu_breaker
    from kyverno_tpu_torch.resilience.faults import (SITE_MUTATE_TRIAGE,
                                                     SITE_TPU_DISPATCH,
                                                     global_faults)
    from kyverno_tpu_torch.tpu.engine import TorchEngine
    from kyverno_tpu_torch.tpu.evaluator import HOST

    def fallbacks():
        return {r: int(global_registry.breaker_fallback.value({"reason": r}))
                for r in ("error", "open")}

    def check(name, got, want):
        if got.rules != want.rules or not np.array_equal(got.verdicts,
                                                         want.verdicts):
            raise AssertionError(f"fault phase: {name} differs")

    ladder_reset()
    breaker = tpu_breaker()
    res, rops = resources[:64], ops[:64]
    cpu = TorchEngine(cps=eng.cps, device="cpu")
    clean = eng.scan(res, operations=rops)
    check("the clean scan against the CPU run", clean,
          cpu.scan(res, operations=rops))
    breaker.reset(failure_threshold=2, reset_timeout_s=600.0)
    global_faults.arm(SITE_TPU_DISPATCH, mode="raise", p=1.0)
    for i, want_state in enumerate((CLOSED, OPEN)):
        check(f"scan under an armed dispatch fault ({i + 1})",
              eng.scan(res, operations=rops), clean)
        if breaker.state != want_state:
            raise AssertionError(f"breaker {breaker.state} after {i + 1} "
                                 f"failures, want {want_state}")
    fired = global_faults.armed()[SITE_TPU_DISPATCH].fired
    check("scan with the breaker open", eng.scan(res, operations=rops), clean)
    if global_faults.armed()[SITE_TPU_DISPATCH].fired != fired \
            or fallbacks() != {"error": 2, "open": 1}:
        raise AssertionError(f"open breaker: fault fired again or fallbacks "
                             f"{fallbacks()}")
    say("9", "armed tpu.dispatch fault: two failures trip the breaker, the "
             "third scan never tries the device; all three tables equal the "
             f"clean scan and the CPU run; breaker_fallback {fallbacks()}")
    global_faults.disarm()
    breaker.reset(failure_threshold=1, reset_timeout_s=0.0)
    global_faults.arm(SITE_TPU_DISPATCH, mode="corrupt", count=1)
    check("scan under a corrupt-shape fault", eng.scan(res, operations=rops),
          clean)
    if breaker.state != OPEN:
        raise AssertionError(f"corrupt shape: breaker {breaker.state}")
    check("the half-open probe", eng.scan(res, operations=rops), clean)
    if breaker.state != CLOSED:
        raise AssertionError(f"half-open probe: breaker {breaker.state}")
    say("9", "corrupt-shape fault: a device failure (breaker open), the "
             "half-open probe closes it; tables equal the clean scan")
    global_faults.disarm()
    breaker.reset()
    hostile = {"metadata: \"x\"": {"apiVersion": "v1", "kind": "Pod",
                                    "metadata": "x"},
               "kind: 7": {"apiVersion": "v1", "kind": 7,
                           "metadata": {"name": "k", "namespace": "d"}},
               "metadata.namespace: [\"x\"]": {
                   "apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": "n", "namespace": ["x"]}}}
    for name, h in hostile.items():
        batch, bops = [res[0], h, res[1]], [rops[0], "", rops[1]]
        want = cpu.scan(batch, operations=bops)
        check(f"TorchEngine.scan with {name}",
              eng.scan(batch, operations=bops), want)
        check(f"ShardedScanner.scan with {name}",
              scanner.scan(batch, operations=bops), want)
        if not np.array_equal(want.verdicts[:, [0, 2]],
                              clean.verdicts[:, :2]):
            raise AssertionError(f"{name}: the good resources changed")
    say("9", f"hostile resources {list(hostile)}: TorchEngine.scan and "
             "ShardedScanner.scan equal the CPU run, the good resources keep "
             "their clean verdicts")
    e0 = fallbacks()["error"]
    global_faults.arm(SITE_TPU_DISPATCH, mode="raise", count=1)
    check("ShardedScanner.scan under a dispatch fault",
          scanner.scan(res, operations=rops), clean)
    if fallbacks()["error"] != e0 + 1 or breaker.state != CLOSED:
        raise AssertionError("ShardedScanner.scan: the fault was not a "
                             "counted device failure")
    global_faults.disarm()
    trs = tenant_res[:48]
    tclean = tenant.triage_mutate(trs)
    global_faults.arm(SITE_MUTATE_TRIAGE, mode="raise")
    tfault = tenant.triage_mutate(trs)
    global_faults.disarm()
    if not (tfault.verdicts == HOST).all() or tfault.rules != tclean.rules:
        raise AssertionError("mutate.triage fault: the batch is not all-HOST")
    for ci, r in enumerate(trs):
        a = apply_mutations(tenant, r, tfault.rows_for(ci))
        b = apply_mutations(tenant, r, tclean.rows_for(ci))
        if a.patched != b.patched:
            raise AssertionError(f"mutate.triage fault: resource {ci} "
                                 "patches differently")
    say("9", f"ShardedScanner.scan under a dispatch fault equals the clean "
             f"scan (all-HOST, completed on the host); mutate.triage fault: "
             f"{len(trs)} resources all-HOST, patched as the clean triage "
             f"routes them; breaker_fallback {fallbacks()} {tag}")
    ladder_reset()


# ---------------------------------------------------------------------------
# phase 10: the pipelined background scan, the encoder pool and the caches


def pipeline_phase(torch, kernels, scanner, eng, feed, dense_res, dense_ops,
                   tile, cache_caps, tenant, triage_res, tag):
    """Phase 10: phase 5's snapshot through ``PipelinedScanner`` over
    the same scanner, in chunks of ``tile``: (a) the feed an encode
    thread, (b) an encoder pool of min(8, cpu_count - 2) workers, (c) a
    rescan warm in a columnar store (in a temporary directory) with the
    encode cache on, after the cold run that fills it. Each run's table
    must equal phase 5's ``scan_stream`` table (which runs again first,
    its step's graph captured, as the baseline); (b) must encode every
    chunk on the pool (no bypass, no infra failure, workers that loaded
    neither torch nor JAX) and (c)'s warm rescan must walk no JSON and
    encode no segment. Then what the caches' default costs cold traffic
    (``cache_cost``), and a repeat ``TorchEngine.scan`` of the dense
    batch with the verdict cache on: equal to the cold scan, its hit
    rate printed. The caches and the store are off again, and the pool
    stopped, when it returns."""
    import shutil
    import tempfile

    import numpy as np

    from kyverno_tpu_torch.cluster.columnar import (configure_store,
                                                    reset_store)
    from kyverno_tpu_torch.encode import EncoderPool
    from kyverno_tpu_torch.observability.metrics import global_registry as reg
    from kyverno_tpu_torch.tpu import cache as tcache
    from kyverno_tpu_torch.tpu.pipeline import PipelinedScanner

    resources, ops, want = feed["resources"], feed["ops"], feed["verdicts"]
    n = len(resources)
    chunks = [resources[i:i + tile] for i in range(0, n, tile)]
    op_chunks = [ops[i:i + tile] for i in range(0, n, tile)]
    s5 = feed["stats"]
    say("10", f"scan_stream (phase 5) {n} resources: {feed['scan_s']:.3f} s,"
              f" {n / feed['scan_s']:.1f} resources/s, encode_s "
              f"{s5['encode_s']:.3f}, device_s {s5['device_s']:.3f}, host_s "
              f"{s5['host_s']:.3f} {tag}")

    def run(label, pool=None, depth=2, k=None):
        # the first k chunks (all by default)
        sub = chunks[:k]
        m = sum(len(c) for c in sub)
        ladder_reset()
        out = {}
        t0 = time.perf_counter()
        st = PipelinedScanner(scanner, depth=depth,
                              encode_pool=pool).scan_chunks(
            sub, operations=op_chunks[:k],
            on_result=lambda i, r: out.__setitem__(i, r.verdicts))
        wall = time.perf_counter() - t0
        if sorted(out) != list(range(len(sub))):
            raise AssertionError(f"pipelined {label}: chunks {sorted(out)}")
        table = np.concatenate([out[i] for i in range(len(sub))], axis=1)
        if table.shape != want[:, :m].shape \
                or not (table == want[:, :m]).all():
            raise AssertionError(f"pipelined {label}: verdicts differ from "
                                 "phase 5's scan_stream")
        if st["encode_fallback_chunks"]:
            raise AssertionError(f"pipelined {label}: "
                                 f"{st['encode_fallback_chunks']} chunks "
                                 "fell back to the serial scan")
        paths = [t["path"] for t in st["timeline"]]
        if paths != ["device"] * len(sub):
            raise AssertionError(f"pipelined {label}: chunk paths {paths}")
        per = [t["encode_s"] for t in st["timeline"]]
        say("10", f"pipelined scan, {label}: {m} resources in "
                  f"{len(sub)} chunks of {tile}: {wall:.3f} s, "
                  f"{m / wall:.1f} resources/s, encode_s "
                  f"{st['encode_s']:.3f}, encode_wait_s "
                  f"{st['encode_wait_s']:.3f}, device_s "
                  f"{st['device_s']:.3f}, host_s {st['host_s']:.3f}, "
                  f"overlap_ratio {st['overlap_ratio']}, depth {depth}, a "
                  f"chunk's encode median {statistics.median(per):.3f} s "
                  f"(max {max(per):.3f}); verdicts equal scan_stream's "
                  f"{tag}")
        ladder_check("10")
        return st

    # the serial scan again, its step's graph already captured: the
    # baseline of the runs below
    t0 = time.perf_counter()
    again, s0 = scanner.scan_stream(resources, tile=tile, operations=ops)
    wall = time.perf_counter() - t0
    if not (again.verdicts == want).all():
        raise AssertionError("scan_stream differs from its first run")
    say("10", f"scan_stream again (warm): {wall:.3f} s, {n / wall:.1f} "
              f"resources/s, encode_s {s0['encode_s']:.3f}, device_s "
              f"{s0['device_s']:.3f}, host_s {s0['host_s']:.3f} {tag}")

    # (a) the feed an encode thread of this process
    run("(a) no pool")

    # (b) an encoder pool
    cpus = os.cpu_count() or 1
    workers = max(1, min(8, cpus - 2))
    say("10", f"os.cpu_count() {cpus}: a pool of {workers} workers")
    outcomes = ("ok", "retried_ok", "bypass", "infra_fail", "encode_error",
                "poison")
    before = {o: reg.encode_pool_chunks.value({"outcome": o})
              for o in outcomes}
    t0 = time.perf_counter()
    pool = EncoderPool(workers).start()
    try:
        ready = pool.wait_ready(120)
        say("10", f"pool of {workers}: {ready} ready in "
                  f"{time.perf_counter() - t0:.3f} s")
        slots = pool.state()["worker_slots"]
        loaded = [(w["torch_loaded"], w["jax_loaded"]) for w in slots]
        if ready != workers or any(a or b for a, b in loaded):
            raise AssertionError(f"pool: {ready} of {workers} ready, "
                                 f"(torch, jax) loaded {loaded}")
        # as many chunks ahead as there are workers, so every worker has
        # a chunk to encode
        st = run(f"(b) a pool of {workers} workers", pool, depth=workers)
        moved = {o: reg.encode_pool_chunks.value({"outcome": o}) - before[o]
                 for o in outcomes}
        summary = pool.summary()
        say("10", f"pool chunks by outcome {moved}; summary "
                  f"{json.dumps(summary)}; each worker loaded neither torch "
                  f"nor jax")
        if (moved["ok"] != len(chunks) or moved["bypass"]
                or moved["infra_fail"] or moved["retried_ok"]
                or summary["breaker"] != "closed" or summary["restarts"]
                or st.get("encode_pool", {}).get("alive") != workers):
            raise AssertionError(f"pool did not encode every chunk: {moved},"
                                 f" {summary}")
    finally:
        pids = pool.worker_pids()
        pool.stop()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            os.path.exists(f"/proc/{p}") for p in pids):
        time.sleep(0.05)
    if any(os.path.exists(f"/proc/{p}") for p in pids):
        raise AssertionError(f"pool workers left running: {pids}")

    # (c) the columnar store and the encode cache
    tmp = tempfile.mkdtemp(prefix="columnar-")
    try:
        tcache.configure(0, cache_caps[1])
        configure_store(directory=tmp, enabled=True)
        # the first COLUMNAR_CHUNKS tiles: the store's cold fill is cut
        # to keep the whole run within its limit
        cut = (f"the first {COLUMNAR_CHUNKS} of {len(chunks)} tiles, cut "
               f"for the time limit")
        run(f"(c) columnar store, cold (fills the store; {cut})",
            k=COLUMNAR_CHUNKS)
        walks = reg.encode_json_walks.value()
        segs = reg.encode_diff_segments.value()
        run(f"(c) columnar store, warm rescan ({cut})", k=COLUMNAR_CHUNKS)
        dw = reg.encode_json_walks.value() - walks
        ds = reg.encode_diff_segments.value() - segs
        say("10", f"warm rescan: {dw} JSON walks, {ds} segment encodes")
        if dw or ds:
            raise AssertionError(f"warm rescan walked JSON ({dw}) or encoded "
                                 f"segments ({ds})")
    finally:
        reset_store()
        tcache.configure(0, 0)
        shutil.rmtree(tmp, ignore_errors=True)

    cache_cost(eng, dense_res, dense_ops, tenant, triage_res, cache_caps,
               tag)

    # the verdict cache on a repeat dense scan
    tcache.configure(*cache_caps)
    try:
        ladder_reset()
        t0 = time.perf_counter()
        cold = eng.scan(dense_res, operations=dense_ops)
        cold_s = time.perf_counter() - t0
        hits = reg.verdict_cache.value({"outcome": "hit"})
        miss = reg.verdict_cache.value({"outcome": "miss"})
        t0 = time.perf_counter()
        warm = eng.scan(dense_res, operations=dense_ops)
        warm_s = time.perf_counter() - t0
        dh = reg.verdict_cache.value({"outcome": "hit"}) - hits
        dm = reg.verdict_cache.value({"outcome": "miss"}) - miss
        if not (warm.verdicts == cold.verdicts).all():
            raise AssertionError("cached dense scan differs from the cold "
                                 "scan")
        say("10", f"TorchEngine.scan of {len(dense_res)} dense resources "
                  f"with the verdict cache on: cold {cold_s:.3f} s, repeat "
                  f"{warm_s:.3f} s, {dh} hits and {dm} misses (hit rate "
                  f"{dh / max(dh + dm, 1):.4f}); the repeat's table equals "
                  f"the cold one {tag}")
        ladder_check("10")
    finally:
        tcache.configure(0, 0)


def cache_cost(eng, dense_res, dense_ops, tenant, triage_res, cache_caps,
               tag, runs=3):
    """What the caches' default capacities cost traffic they cannot
    serve (every lookup a miss, as admission's mostly unique resources):
    a cold dense ``TorchEngine.scan`` and a cold tenant
    ``triage_mutate`` batch with both caches off (0, 0) and at their
    defaults emptied first, interleaved ``runs`` times, on the host
    clock; and the content hashing alone (``verdict_cache_keys``, which
    the scan makes once and the encode cache again). Each run's table
    must equal the first cache-free one. The caches are off on
    return."""
    from kyverno_tpu_torch.tpu import cache as tcache

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out

    times = {(what, mode): [] for what in ("scan", "triage")
             for mode in ("off", "default")}
    want = {}
    ladder_reset()
    try:
        for _ in range(runs):
            for mode, caps in (("off", (0, 0)), ("default", cache_caps)):
                for what, fn in (
                        ("scan", lambda: eng.scan(dense_res,
                                                  operations=dense_ops)),
                        ("triage", lambda: tenant.triage_mutate(triage_res))):
                    tcache.global_verdict_cache.clear()
                    tcache.global_encode_cache.clear()
                    tcache.configure(*caps)
                    sec, got = timed(fn)
                    if what not in want:
                        want[what] = got.verdicts
                    elif not (got.verdicts == want[what]).all():
                        raise AssertionError(f"cold {what} with the caches "
                                             f"{mode} differs")
                    times[(what, mode)].append(sec)
        ladder_check("10")
        tcache.configure(0, 0)
        hash_s = [timed(lambda: eng.verdict_cache_keys(
            dense_res, operations=dense_ops))[0] for _ in range(runs)]
    finally:
        tcache.global_verdict_cache.clear()
        tcache.global_encode_cache.clear()
        tcache.configure(0, 0)
    for what, n in (("scan", len(dense_res)), ("triage", len(triage_res))):
        off, on = times[(what, "off")], times[(what, "default")]
        say("10", f"cold {what} of {n}: caches off "
                  + ", ".join(f"{t:.3f}" for t in off) + " s; at their "
                  f"defaults {cache_caps} (all misses) "
                  + ", ".join(f"{t:.3f}" for t in on) + f" s; medians "
                  f"{statistics.median(off):.3f} -> "
                  f"{statistics.median(on):.3f} s "
                  f"({statistics.median(on) / statistics.median(off):.3f}x)"
                  f"; tables equal {tag}")
    say("10", f"content hashing of the {len(dense_res)} dense resources "
              "(verdict_cache_keys): " + ", ".join(f"{t:.3f}" for t in hash_s)
              + f" s {tag}")


# ---------------------------------------------------------------------------
# phase 11: admission serving on the card (serving/, lifecycle/)

# the pipeline's buckets: BatchConfig(max_batch_size=64) over
# TorchEngine.MIN_BUCKET (16)
ADMISSION_BUCKETS = (16, 32, 64)
# each kernel's events in a replay's device trace
TRACE_NAMES = {"dfa_scan_fused": "dfa_scan_fused_kernel",
               "instance_count": "count_many_kernel",
               "instance_count2": "instance_count2_kernel",
               "verdict_counts": "verdict_counts_kernel",
               "hash_match": "hash_match_kernel",
               "pool_rows": "pool_rows_kernel",
               "first_true_take": "first_true_take_",
               "class_fold": "class_fold_kernel",
               "row_fold": "row_fold_kernel"}


def admission_policy(name: str, image: str) -> dict:
    """A one-rule policy on Pod images, for the hot swap (autogen adds
    its Deployment and CronJob rules)."""
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name},
            "spec": {"validationFailureAction": "Enforce", "background": True,
                     "rules": [{
                         "name": "image",
                         "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
                         "validate": {"message": f"{name}: image {image}",
                                      "pattern": {"spec": {"containers": [
                                          {"image": image}]}}}}]}}


def pct_ms(lats, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(lats), q)) * 1e3 if lats else 0.0


class Admission:
    """The admission server's batch evaluator core (pad slots scan as
    empty resources, ``scan(..., live_n=real)``, one ``resource_verdicts``
    row list a real column), over ``resources`` by index, recording each
    flush (revision, bucket, live requests, dispatch path, seconds) and
    each request into the flight recorder."""

    def __init__(self, resources, eng=None):
        import threading

        self.resources = resources
        self.eng = eng
        self.flushes = []
        self.versions = {}
        self.lock = threading.Lock()

    def __call__(self, padded, version=None):
        from kyverno_tpu_torch.observability.flightrecorder import global_flight
        from kyverno_tpu_torch.observability.profiling import last_dispatch_path
        from kyverno_tpu_torch.serving import resource_verdicts

        eng = self.eng if version is None else version.engine
        rev = 0 if version is None else version.revision
        real = sum(1 for p in padded if p is not None)
        res_list = [self.resources[p] if p is not None else {} for p in padded]
        ops = ["CREATE" if p is not None else "" for p in padded]
        t0 = time.perf_counter()
        res = eng.scan(res_list, operations=ops, live_n=real)
        dt = time.perf_counter() - t0
        path = last_dispatch_path("none")
        with self.lock:
            self.flushes.append((rev, len(padded), real, path, dt))
            if version is not None:
                self.versions.setdefault(rev, version)
        out = []
        for ci in range(real):
            rows = resource_verdicts(res, ci)
            global_flight.record_admission(
                res_list[ci], rows, "batched", engine=eng, revision=rev,
                namespace=(res_list[ci].get("metadata") or {}).get(
                    "namespace", ""), operation="CREATE")
            out.append((rev, padded[ci], rows))
        return out

    def one(self, idx):
        """The scalar fallback and hedge: a one-resource scan."""
        from kyverno_tpu_torch.observability.flightrecorder import global_flight
        from kyverno_tpu_torch.serving import resource_verdicts

        res = self.eng.scan([self.resources[idx]], operations=["CREATE"])
        rows = resource_verdicts(res, 0)
        global_flight.record_admission(
            self.resources[idx], rows, "scalar_fallback", engine=self.eng,
            revision=0, operation="CREATE")
        return (0, idx, rows)


def admission_reference(eng, resources, idx):
    """{index: rows} of one CPU TorchEngine (plain twins) scan of
    ``resources[i]`` for i in ``idx``, under ``eng``'s compiled set."""
    from kyverno_tpu_torch.serving import resource_verdicts
    from kyverno_tpu_torch.tpu.engine import TorchEngine

    idx = sorted(idx)
    res = TorchEngine(cps=eng.cps, device="cpu").scan(
        [resources[i] for i in idx], operations=["CREATE"] * len(idx))
    return {i: resource_verdicts(res, ci) for ci, i in enumerate(idx)}


def check_answers(label, answers, want_by_rev):
    """Every answer (revision, index, rows) against the CPU rows of its
    resource under the revision its flush pinned."""
    bad = [(rev, i) for rev, i, rows in answers if rows != want_by_rev[rev][i]]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} of {len(answers)} answers "
                             f"differ from the CPU engine's rows (first "
                             f"{bad[:5]})")


def key_counts_by_bucket(g):
    out = {}
    for key, n in g.key_counts.items():
        b = key[0][1][0]
        out[b] = {k: out.get(b, {}).get(k, 0) + v for k, v in n.items()}
    return out


def flush_device_ms(torch, g, lanes, reps: int = 10) -> float:
    """Median device time of one flush's program call (copy into the
    graph's inputs, the replay, the output clones) between CUDA events."""
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g(lanes)
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def admission_phase(torch, kernels, seed, tag, n_requests=20000,
                    n_bulk=10000):
    """Phase 11: micro-batched admission serving on the card. (a) steady
    admission (bench.py's config #5), (b) mixed traffic (bench.py's
    mixed leg), (c) a policy-set hot swap and a compile-time quarantine
    under traffic. Returns the admission path's launches (of (a)'s run),
    one flush's launches and trace times at each bucket, and each
    bucket's ``graph_check``."""
    import random as _random
    import threading

    from kyverno_tpu_torch.cluster.policycache import PolicyCache
    from kyverno_tpu_torch.lifecycle import PolicySetLifecycleManager
    from kyverno_tpu_torch.lifecycle.manager import default_compile_fn
    from kyverno_tpu_torch.api.policy import ClusterPolicy
    from kyverno_tpu_torch.observability.analytics import global_slo
    from kyverno_tpu_torch.observability.flightrecorder import global_flight
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.observability.profiling import PATH_DEVICE
    from kyverno_tpu_torch.observability.verification import global_verifier
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.policy.autogen import expand_policy
    from kyverno_tpu_torch.resilience.faults import (SITE_POLICYSET_COMPILE,
                                                     global_faults)
    from kyverno_tpu_torch.serving import (AdmissionPipeline, BatchConfig,
                                           QueueFullError, RequestClass)
    from kyverno_tpu_torch.tpu import cache as tcache
    from kyverno_tpu_torch.tpu import graphs
    from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device
    from kyverno_tpu_torch.tpu.flatten import EncodeConfig

    t_phase = time.perf_counter()
    ladder_reset()
    tcache.configure(0, 0)  # every flush reaches the program
    kerr0 = global_registry.kernel_errors.value()
    # every capture of the phase, by thread and batch size
    captures = []
    real_capture = graphs.GraphedProgram._capture

    def capture(self, key, dev, lanes):
        t0 = time.perf_counter()
        try:
            return real_capture(self, key, dev, lanes)
        finally:
            captures.append((threading.current_thread().name, key[0][1][0],
                             time.perf_counter() - t0))

    graphs.GraphedProgram._capture = capture
    try:
        raw = load_pss_policies()
        policies = [expand_policy(p) for p in raw]
        t0 = time.perf_counter()
        eng = TorchEngine(policies, encode_cfg=EncodeConfig(max_rows=128))
        dev_rules = sum(e.device_row is not None for e in eng.cps.rules)
        if dev_rules != 66:
            raise AssertionError(f"admission engine: {dev_rules} device "
                                 f"rules, want 66")
        resources, _ = workload(2048, seed)
        g = eng.cps.device_fn(device=eng.device)
        eng.warm_buckets(ADMISSION_BUCKETS)
        warm_s = time.perf_counter() - t0
        kc = key_counts_by_bucket(g)
        say("11", f"admission engine: 18 PSS policies, {dev_rules} device "
                  f"rules, EncodeConfig(max_rows=128); compiled and warmed "
                  f"buckets {ADMISSION_BUCKETS} twice each in {warm_s:.3f} s "
                  f"{tag}: {kc}")

        # -- (a) steady admission: bench.py config #5; each part starts
        # with an empty admission-latency SLO window, as a fresh server
        # would (the burn of one part must not shed the next's traffic)
        global_slo.reset()
        global_flight.reset()
        global_verifier.reset()
        global_verifier.configure(rate=0.1)
        adm = Admission(resources, eng)
        cfg = BatchConfig(max_batch_size=64, max_wait_ms=2.0)
        cfg.min_bucket = TorchEngine.MIN_BUCKET
        pipe = AdmissionPipeline(adm, config=cfg)
        answers, lats, errors = [], [], []
        lock = threading.Lock()
        work = [n_requests]

        def worker(wseed):
            rng = _random.Random(wseed)
            local, lat = [], []
            while True:
                with lock:
                    if work[0] <= 0:
                        break
                    work[0] -= 1
                i = rng.randrange(len(resources))
                t = time.perf_counter()
                try:
                    local.append(pipe.submit(i))
                    lat.append(time.perf_counter() - t)
                except Exception as e:  # noqa: BLE001 - a gate below
                    errors.append(f"{type(e).__name__}: {e}"[:300])
            with lock:
                answers.extend(local)
                lats.extend(lat)

        kernels.reset_launches()
        threads = [threading.Thread(target=worker, args=(seed * 1000 + w,))
                   for w in range(64)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        pipe.stop()
        st = pipe.state()["stats"]
        kc = key_counts_by_bucket(g)
        if errors:
            raise AssertionError(f"(a): {len(errors)} requests failed: "
                                 f"{errors[:3]}")
        for name in DENSE_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"admission path never launched {name}")
        say("11", f"(a) steady admission: {n_requests} requests (bench.py's "
                  f"50,000, cut for the smoke's time limit) from 64 threads "
                  f"over 2,048 seeded resources in {wall:.3f} s: "
                  f"{n_requests / wall:.1f} requests/s; latency p50 "
                  f"{pct_ms(lats, 50):.3f} ms, p99 {pct_ms(lats, 99):.3f} ms, "
                  f"p99.9 {pct_ms(lats, 99.9):.3f} ms {tag}")
        say("11", f"(a) flushes {st['flushes']} by bucket "
                  f"{st['flushes_by_bucket']} by reason {st['flush_reasons']}"
                  f"; mean batch {pipe.mean_batch_size():.3f}, mean occupancy "
                  f"{pipe.state()['mean_occupancy']}; eager runs, captures "
                  f"and replays by bucket (warm-up included) {kc}")
        by_b = {}
        for _, b, _, _, dt in adm.flushes:
            by_b.setdefault(b, []).append(dt)
        say("11", "(a) a flush's scan (encode, copy-in, replay, readback, "
                  "completion) by bucket, median ms: " + ", ".join(
                      f"{b} {1e3 * statistics.median(v):.3f} ({len(v)})"
                      for b, v in sorted(by_b.items())) + f" {tag}")
        say("11", f"(a) launches {launches}")
        for b in ADMISSION_BUCKETS:
            if kc.get(b, {}).get("captures") != 1 \
                    or kc.get(b, {}).get("eager") != 1:
                raise AssertionError(f"(a) bucket {b}: {kc.get(b)}, want one "
                                     f"eager run and one capture")
        if set(st["flushes_by_bucket"]) - set(ADMISSION_BUCKETS):
            raise AssertionError(f"(a) buckets {st['flushes_by_bucket']}")
        flushes_a = list(adm.flushes)

        # -- (b) mixed traffic: bench.py's mixed leg
        CRIT = RequestClass("user", "CREATE", "critical")
        BULK = RequestClass("kubelet", "CREATE", "bulk")
        mcfg = BatchConfig(
            max_batch_size=64, max_wait_ms=2.0, high_water=256,
            bulk_share=0.5, critical_reserve=0.1, bulk_max_wait_ms=25.0,
            hedge_threshold=0.25, bulk_shed_mode="fail",
            shed_burn_bulk=1.0, shed_burn_default=0.0)
        mcfg.min_bucket = TorchEngine.MIN_BUCKET
        madm = Admission(resources, eng)
        mpipe = AdmissionPipeline(madm, scalar_fallback=madm.one, config=mcfg)
        m_answers = []

        def trickle(n, spacing_s):
            rng = _random.Random(seed + 5)
            out = []
            for _ in range(n):
                i = rng.randrange(len(resources))
                t = time.perf_counter()
                m_answers.append(mpipe.submit(i, cls=CRIT))
                out.append(time.perf_counter() - t)
                if spacing_s:
                    time.sleep(spacing_s)
            return out

        global_slo.reset()
        unloaded = trickle(200, 0.0)
        bulk = {"lat": [], "shed": 0, "errors": []}
        bwork = [n_bulk]

        def bulk_worker(wseed):
            rng = _random.Random(wseed)
            local, lat, shed = [], [], 0
            while True:
                with lock:
                    if bwork[0] <= 0:
                        break
                    bwork[0] -= 1
                i = rng.randrange(len(resources))
                t = time.perf_counter()
                try:
                    local.append(mpipe.submit(i, cls=BULK))
                    lat.append(time.perf_counter() - t)
                except QueueFullError:
                    shed += 1
                except Exception as e:  # noqa: BLE001 - a gate below
                    bulk["errors"].append(f"{type(e).__name__}: {e}"[:300])
            with lock:
                m_answers.extend(local)
                bulk["lat"].extend(lat)
                bulk["shed"] += shed

        threads = [threading.Thread(target=bulk_worker,
                                    args=(seed * 2000 + w,))
                   for w in range(32)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        loaded = trickle(400, 0.002)
        for th in threads:
            th.join()
        m_wall = time.perf_counter() - t0
        mpipe.stop()
        mst = mpipe.state()["stats"]
        if bulk["errors"]:
            raise AssertionError(f"(b): {len(bulk['errors'])} bulk requests "
                                 f"failed: {bulk['errors'][:3]}")
        say("11", f"(b) mixed traffic: critical p99 unloaded "
                  f"{pct_ms(unloaded, 99):.3f} ms (200 requests), loaded "
                  f"{pct_ms(loaded, 99):.3f} ms (400 at 2 ms spacing beside "
                  f"{n_bulk} bulk requests from 32 threads, bench.py's "
                  f"20,000 cut for the time limit, {m_wall:.3f} s); bulk "
                  f"shed {bulk['shed']}, bulk p99 {pct_ms(bulk['lat'], 99):.3f}"
                  f" ms; hedges {mst['hedges']} won by the scalar path "
                  f"{mst['hedge_wins_scalar']}, by the device "
                  f"{mst['hedge_wins_device']}; flushes by bucket "
                  f"{mst['flushes_by_bucket']}, by reason "
                  f"{mst['flush_reasons']}; shed {mst['shed']}, expired "
                  f"{mst['expired']} {tag}")

        # (a) and (b) against the CPU engine (one version: revision 0)
        t0 = time.perf_counter()
        asked = {i for _, i, _ in answers} | {i for _, i, _ in m_answers}
        want0 = admission_reference(eng, resources, asked)
        check_answers("(a)", answers, {0: want0})
        check_answers("(b)", m_answers, {0: want0})
        say("11", f"(a) {len(answers)} and (b) {len(m_answers)} answers "
                  f"equal one CPU TorchEngine (plain twins) scan of their "
                  f"{len(asked)} distinct resources "
                  f"({time.perf_counter() - t0:.3f} s)")

        # -- (c) hot swap and compile-time quarantine under traffic
        cache = PolicyCache()
        for p in raw:
            cache.set(p)
        mgr = PolicySetLifecycleManager(cache, compile_fn=default_compile_fn(
            encode_cfg=EncodeConfig(max_rows=128), warm=True,
            warm_buckets=ADMISSION_BUCKETS))
        global_slo.reset()
        n_cap0 = len(captures)
        mgr.start()
        v1 = mgr.acquire()
        cadm = Admission(resources)
        cpipe = AdmissionPipeline(cadm, config=cfg,
                                  version_provider=mgr.acquire)
        pool = _random.Random(seed + 7).sample(range(len(resources)), 128)
        c_answers, c_errors = [], []
        served = [0]
        stop = threading.Event()

        def c_worker(wseed):
            rng = _random.Random(wseed)
            local = []
            while not stop.is_set():
                try:
                    local.append(cpipe.submit(rng.choice(pool)))
                except Exception as e:  # noqa: BLE001 - a gate below
                    c_errors.append(f"{type(e).__name__}: {e}"[:300])
                with lock:
                    served[0] += 1
            with lock:
                c_answers.extend(local)

        def wait_for(cond, what, limit=120.0):
            t = time.perf_counter()
            while not cond():
                if time.perf_counter() - t > limit:
                    raise AssertionError(f"(c): no {what} in {limit} s")
                time.sleep(0.01)

        threads = [threading.Thread(target=c_worker, args=(seed * 3000 + w,))
                   for w in range(8)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        cap_traffic0 = len(captures)
        wait_for(lambda: served[0] >= 1000, "traffic")
        cache.set(ClusterPolicy.from_dict(admission_policy(
            "admission-registry", "!evil.io/*")))
        wait_for(lambda: mgr.active.revision > v1.revision, "swap")
        v2 = mgr.active
        global_faults.arm(SITE_POLICYSET_COMPILE, mode="raise", count=2)
        cache.set(ClusterPolicy.from_dict(admission_policy(
            "admission-no-latest", "!*:latest")))
        wait_for(lambda: mgr.active.quarantined, "quarantine")
        v3 = mgr.active
        wait_for(lambda: served[0] >= 4000, "4,000 requests")
        stop.set()
        for th in threads:
            th.join()
        c_wall = time.perf_counter() - t0
        cpipe.stop()
        global_faults.disarm()
        cap_traffic = captures[cap_traffic0:]
        mstate = mgr.state()
        mgr.stop()
        if c_errors:
            raise AssertionError(f"(c): {len(c_errors)} requests failed: "
                                 f"{c_errors[:3]}")
        q_rules = [e for e in v3.engine.cps.rules
                   if e.policy_name == "admission-no-latest"]
        if not q_rules or not all(
                e.device_row is None
                and e.fallback_reason.startswith("quarantined:")
                for e in q_rules):
            raise AssertionError("(c): the quarantined policy's rules are "
                                 "not host rules")
        by_rev = {}
        for rev, _, _, _, _ in cadm.flushes:
            by_rev[rev] = by_rev.get(rev, 0) + 1
        say("11", f"(c) hot swap under traffic: {served[0]} requests from 8 "
                  f"threads over 128 of the resources in {c_wall:.3f} s; "
                  f"revisions {v1.revision} -> {v2.revision} (policy added) "
                  f"-> {v3.revision} (quarantined {v3.quarantined}, "
                  f"{len(q_rules)} rules on the host) -> "
                  f"{mstate['active_revision']}; swaps "
                  f"{mstate['stats']['swaps']}, quarantine entries "
                  f"{mstate['stats']['quarantine_enters']}, exits "
                  f"{mstate['stats']['quarantine_exits']}; flushes by "
                  f"revision {by_rev}; captures during traffic by thread "
                  + str({t: sum(1 for c in cap_traffic if c[0] == t)
                         for t in sorted({c[0] for c in cap_traffic})})
                  + f", {len(captures) - n_cap0} in (c) in all "
                  f"(median {statistics.median([c[2] for c in captures[n_cap0:]] or [0.0]):.3f} s) {tag}")
        say("11", "(c) captures (thread, batch, s, before traffic): " + str(
            [(t, n, round(d, 3), k < cap_traffic0)
             for k, (t, n, d) in enumerate(captures) if k >= n_cap0]))
        t0 = time.perf_counter()
        want_c = {}
        asked = {i for _, i, _ in c_answers}
        for rev, v in cadm.versions.items():
            if v.engine.cps.cache_key() == eng.cps.cache_key():
                # (a)'s compiled set: its rows, and the rest scanned
                want_c[rev] = want0 | admission_reference(
                    eng, resources, asked - set(want0))
            else:
                want_c[rev] = admission_reference(v.engine, resources, asked)
        check_answers("(c)", c_answers, want_c)
        say("11", f"(c) {len(c_answers)} answers equal the CPU engine's rows "
                  f"under the revision their flush pinned "
                  f"({time.perf_counter() - t0:.3f} s)")

        # the gates the three parts share
        flushes = flushes_a + madm.flushes + cadm.flushes
        off = [f for f in flushes if f[3] != PATH_DEVICE]
        if off:
            raise AssertionError(f"{len(off)} flushes were not answered on "
                                 f"the device: {off[:3]}")
        bad_caps = [c for c in cap_traffic
                    if c[0] != "policyset-compile-ahead"]
        if bad_caps:
            raise AssertionError(f"(c): captures off the worker thread during "
                                 f"traffic: {bad_caps}")
        global_verifier.drain(timeout=60.0)
        vst = global_verifier.state()["stats"]
        global_verifier.configure(rate=0.0)
        global_verifier.stop()
        fst = global_flight.state()["stats"]
        say("11", f"shadow verification (rate 0.1, flight recorder at its "
                  f"default sampling, {fst['captured']} captured): checked "
                  f"{vst['checked']}, divergences {vst['divergences']}, "
                  f"skipped {vst['skipped_impure'] + vst['skipped_no_engine']}"
                  f" + {vst['skipped_overflow']} overflow")
        if vst["divergences"] or not vst["checked"]:
            raise AssertionError(f"shadow verification: {vst}")
        kerr = global_registry.kernel_errors.value() - kerr0
        if kerr:
            raise AssertionError(f"{kerr} kernel errors in the phase")
        # the flushes' dispatch paths are the flusher's; one more scan
        # through the ladder on this thread for ladder_check's
        eng.scan(resources[:16], operations=["CREATE"] * 16)
        ladder_check("11")

        # one flush at each bucket: launches, device time, trace, graph_check
        flush = {}
        for b in ADMISSION_BUCKETS:
            padded, _, _ = eng.pad(resources[:b], ["CREATE"] * b)
            lanes = lanes_to_device(eng.encode(padded, None,
                                               ["CREATE"] * b)[0], eng.device)
            g(lanes)
            torch.cuda.synchronize()
            kernels.reset_launches()
            g(lanes)
            torch.cuda.synchronize()
            fl = {k: v for k, v in kernels.LAUNCHES.items() if v}
            ms = flush_device_ms(torch, g, lanes)
            rp = device_profile(torch, lambda: g(lanes))
            trace = {k: sum(t["ms"] for t in rp["all"] if n in t["name"])
                     for k, n in TRACE_NAMES.items()}
            # every check at each bucket; the kernels timed at the largest
            gr = graph_check(torch, kernels, "11", f"admission bucket {b}", g,
                             lanes, eng.cps.device_fn(plain=True), tag,
                             timing=b == ADMISSION_BUCKETS[-1])
            flush[b] = {"launches": fl, "ms": ms, "trace_ms": trace,
                        "graph": gr}
            say("11", f"bucket {b}: one flush's program call {ms:.4f} ms of "
                      f"device time (copy-in, replay, output clones; median "
                      f"of 10), {rp['device_events']} device events; "
                      f"launches {fl}; kernel trace ms "
                      + ", ".join(f"{k} {v:.4f}" for k, v in trace.items())
                      + f" {tag}")
        say("11", f"phase 11 in {time.perf_counter() - t_phase:.3f} s")
        return {"launches": launches, "flush": flush}
    finally:
        graphs.GraphedProgram._capture = real_capture
        global_faults.disarm()


# bench.py's soak (config #17): namespaces of its lean Pods, churn per
# tick, and its churn mix (80 % re-revisioned upserts, 10 % adds, 10 %
# deletes, random.Random(1729))
SOAK_NAMESPACES = 16
SOAK_CHURN = 2000
# the bench's journal cap (BENCH_SOAK_JOURNAL_MAX): at the store's
# default of 4 MiB, a store of the soak's size rewrites every row every
# few thousand folds (PERF.md §6)
SOAK_JOURNAL_MAX = 1 << 30
# graph keys the soak's step may hold: a program keeps at most this many
# graphs (tpu/graphs.py:MAX_GRAPHS)
STEP_MAX_KEYS = 4
# phase 13: admission requests before the policy's add (twice as many
# after the lint)
LINT_REQUESTS = 1000
# the golden analysis fixtures (bench.py's analyze config)
ANALYSIS_DIR = os.path.join(HERE, "tests", "golden", "analysis")


def soak_pod(i, rev=0):
    """bench.py:2349's lean Pod: 1 in 9 privileged, 16 namespaces."""
    sc = {"securityContext": {"privileged": True}} if i % 9 == 0 else {}
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"soak-{i}",
                         "namespace": f"ns{i % SOAK_NAMESPACES}",
                         "uid": f"soak-u{i}", "labels": {"rev": str(rev)}},
            "spec": {"containers": [{"name": "c", "image": "nginx", **sc}]}}


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return round(int(line.split()[1]) / 1024.0, 1)
    return 0.0


class Timed:
    """A callable wrapped to sum its seconds and calls."""

    def __init__(self, fn):
        self.fn = fn
        self.s = 0.0
        self.n = 0

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            self.s += time.perf_counter() - t0
            self.n += 1

    def take(self):
        out = (self.s, self.n)
        self.s, self.n = 0.0, 0
        return out


def key_label(key) -> str:
    """A step graph's key, short: its lanes' distinct shapes."""
    shapes = sorted({s for _, s, _ in key})
    return "/".join("x".join(map(str, s)) for s in shapes)


def step_keys(g) -> dict:
    """{key label: eager runs, captures, replays} of a graphed step (an
    empty dict for an eager one)."""
    return {key_label(k): dict(v) for k, v in
            getattr(g, "key_counts", {}).items()}


def report_rows(result, ci):
    """The scan service's report rows of one column (cluster/scanner.py
    report()): (policy, rule, result) of every matched rule."""
    from kyverno_tpu_torch.cluster.scanner import _CODE_TO_RESULT
    from kyverno_tpu_torch.serving import resource_verdicts
    from kyverno_tpu_torch.tpu.evaluator import NOT_MATCHED

    return [[p, r, _CODE_TO_RESULT.get(code, "error")]
            for (p, r), code in resource_verdicts(result, ci)
            if code != NOT_MATCHED]


def bucket_counts(g) -> dict:
    """``key_counts_by_bucket`` of a graphed program (an empty dict for
    an eager one or none)."""
    return key_counts_by_bucket(g) if hasattr(g, "key_counts") else {}


def reports_phase(torch, kernels, tag, n, cache_caps, seed):
    """Phase 12: incremental reports and the background scan service on
    the card, bench.py's soak (config #17) at ``n`` lean Pods: (a) the
    fill, a full scan, 10 churn ticks of 2,000, an unchanged tick; (b)
    5 churn ticks under the bench's ambient faults; (c) the store closed
    and reopened; (d) a full recompute by a new service into a fresh
    store. Returns the launches of (a)'s churn ticks and the journal
    directory, which phase 16 reads and which is removed at exit."""
    import atexit
    import gc
    import shutil
    import tempfile

    from kyverno_tpu_torch.cluster import (BackgroundScanService,
                                           ClusterSnapshot, PolicyCache)
    from kyverno_tpu_torch.cluster.columnar import reset_store
    from kyverno_tpu_torch.observability.analytics import global_slo
    from kyverno_tpu_torch.observability.flightrecorder import (global_flight,
                                                                policyset_key)
    from kyverno_tpu_torch.observability.metrics import global_registry as reg
    from kyverno_tpu_torch.observability.verification import global_verifier
    from kyverno_tpu_torch.parallel.sharding import ShardedScanner
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.reports import (configure_reports,
                                           get_report_store, reset_reports)
    from kyverno_tpu_torch.resilience.faults import global_faults
    from kyverno_tpu_torch.tpu import cache as tcache
    from kyverno_tpu_torch.tpu.pipeline import PipelinedScanner

    t_phase = time.perf_counter()
    ladder_reset()
    reset_store()
    tcache.configure(*cache_caps)  # the service's default: caches on
    kerr0 = reg.kernel_errors.value()
    rdir = tempfile.mkdtemp(prefix="chip-smoke-reports-")
    atexit.register(shutil.rmtree, rdir, ignore_errors=True)
    sample_rate0 = global_flight.sample_rate
    real_chunks = PipelinedScanner.scan_chunks
    pstats = []

    def scan_chunks(self, chunks, namespace_labels=None, operations=None,
                    on_result=None, content_hashes=None):
        # the pipeline's own split, with its on_result (the service's
        # report callback) timed: the report side of a tick
        rep = Timed(on_result) if on_result is not None else None
        st = real_chunks(self, chunks, namespace_labels, operations,
                         on_result=rep, content_hashes=content_hashes)
        pstats.append(dict(st, report_s=rep.s if rep else 0.0))
        return st

    PipelinedScanner.scan_chunks = scan_chunks
    flight = global_flight.record_scan_chunk = Timed(
        global_flight.record_scan_chunk)
    try:
        global_slo.reset()
        global_flight.reset()
        global_verifier.reset()
        store = configure_reports(directory=rdir,
                                  journal_max_bytes=SOAK_JOURNAL_MAX)
        global_flight.configure(sample_rate=0.001)
        global_verifier.configure(rate=1.0)
        cache = PolicyCache()
        for p in load_pss_policies():
            cache.set(p)
        snap = ClusterSnapshot()
        t0 = time.perf_counter()
        for i in range(n):
            snap.upsert(soak_pod(i))
        t_fill = time.perf_counter() - t0
        svc = BackgroundScanService(snap, cache)
        put = svc.aggregator.put = Timed(svc.aggregator.put)
        apply = store.apply = Timed(store.apply)
        say("12", f"bench.py soak (config #17) at {n} lean Pods in "
                  f"{SOAK_NAMESPACES} namespaces (1 in 9 privileged; the "
                  f"bench's 1,000,000 cut for the time limit, --reports-n); "
                  f"fill {t_fill:.3f} s {tag}")

        def tick(label, full=False):
            pstats.clear()
            put.take()
            apply.take()
            flight.take()
            f0 = reg.reports_fold_ops.value()
            j0 = reg.reports_journal_records.value()
            hits0 = svc.stats["verdict_cache_hits"]
            t0 = time.perf_counter()
            count = svc.scan_once(full=full)
            wall = time.perf_counter() - t0
            gc.collect()
            row = {"label": label, "dirty": count, "wall_s": wall,
                   "chunks": sum(s["chunks"] for s in pstats),
                   "cache_hits": svc.stats["verdict_cache_hits"] - hits0,
                   "folds": int(reg.reports_fold_ops.value() - f0),
                   "journal_records": int(
                       reg.reports_journal_records.value() - j0),
                   "put_s": put.take()[0], "apply_s": apply.take()[0],
                   "flight_s": flight.take()[0], "rss_mb": rss_mb()}
            for k in ("encode_s", "device_s", "host_s", "report_s"):
                row[k] = sum(s[k] for s in pstats)
            row["overlap_ratio"] = (pstats[-1]["overlap_ratio"]
                                    if pstats else 0.0)
            say("12", f"{label}: dirty {count}, chunks {row['chunks']}, "
                      f"{wall:.3f} s; encode_s {row['encode_s']:.3f}, "
                      f"device_s {row['device_s']:.3f}, host_s "
                      f"{row['host_s']:.3f} (report side {row['report_s']:.3f}"
                      f": aggregator put {row['put_s']:.3f}, store apply "
                      f"{row['apply_s']:.3f}, flight records "
                      f"{row['flight_s']:.3f}), overlap_ratio "
                      f"{row['overlap_ratio']}; verdict-cache hits "
                      f"{row['cache_hits']}, folds {row['folds']}, journal "
                      f"records {row['journal_records']}, RSS "
                      f"{row['rss_mb']} MB {tag}")
            return row

        rng = random.Random(1729)
        state = {"next": n, "last": set()}

        def churn(rev):
            # bench.py bench_soak's churn loop (live_max stays n, as there)
            touched = set()
            for _ in range(SOAK_CHURN):
                roll = rng.random()
                if roll < 0.8:
                    i = rng.randrange(n)
                    snap.upsert(soak_pod(i, rev=rev))
                elif roll < 0.9:
                    i = state["next"]
                    snap.upsert(soak_pod(i))
                    state["next"] += 1
                else:
                    i = rng.randrange(n)
                    if snap.get(f"soak-u{i}") is not None:
                        snap.delete(f"soak-u{i}")
                touched.add(f"soak-u{i}")
            state["last"] = touched

        def digest_gate(label):
            d = store.digest()
            if store.rebuild() != d:
                raise AssertionError(f"({label}): the delta-folded digest "
                                     f"differs from rebuild()")
            return d

        # -- (a) the full scan, churn with no fault, an unchanged tick
        full = tick("(a) full scan", full=True)
        say("12", f"(a) full scan: {full['dirty']} resources in "
                  f"{full['wall_s']:.3f} s, "
                  f"{full['dirty'] / full['wall_s']:.1f} resources/s {tag}")
        ticks = []
        kernels.reset_launches()
        for k in range(10):
            churn(k + 1)
            ticks.append(tick(f"(a) churn tick {k + 1}"))
        launches = dict(kernels.LAUNCHES)
        for name in SCAN_KERNELS:
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"the reports tick path never launched "
                                     f"{name}")
        ladder_check("12")
        f0 = reg.reports_fold_ops.value()
        j0 = reg.reports_journal_records.value()
        zero = tick("(a) unchanged tick")
        if zero["dirty"] or reg.reports_fold_ops.value() != f0 \
                or reg.reports_journal_records.value() != j0:
            raise AssertionError(f"(a) the unchanged tick did report work: "
                                 f"{zero}")
        d_a = digest_gate("a")
        steady = [t["wall_s"] for t in ticks[2:]]
        say("12", f"(a) churn ticks 3-10 (past the step's eager run and "
                  f"capture at the tick's bucket): median "
                  f"{statistics.median(steady):.3f} s, max {max(steady):.3f} "
                  f"s; ticks 1-2 {ticks[0]['wall_s']:.3f}, "
                  f"{ticks[1]['wall_s']:.3f} s; the unchanged tick "
                  f"{zero['wall_s']:.4f} s, 0 folds, 0 journal records; "
                  f"digest == rebuild() {tag}")

        # -- (b) churn under the bench's ambient faults
        global_faults.arm("tpu.dispatch", mode="raise", p=0.01, seed=7)
        global_faults.arm("reports.fold", mode="raise", p=0.005, seed=11)
        global_faults.arm("reports.journal", mode="raise", p=0.005, seed=13)
        try:
            for k in range(5):
                churn(11 + k)
                ticks.append(tick(f"(b) churn tick {k + 1} under faults"))
        finally:
            global_faults.disarm()
        d_b = digest_gate("b")
        recov = {r: int(reg.reports_recoveries.value({"reason": r})) for r in
                 ("short_header", "truncated_record", "checksum", "decode",
                  "duplicate", "snapshot", "replay", "append_error")}
        st = store.state()
        fallbacks = {r: reg.breaker_fallback.value({"reason": r})
                     for r in ("error", "open")}
        say("12", f"(b) under faults: digest == rebuild(); folds "
                  f"{int(reg.reports_fold_ops.value())}, fold skips "
                  f"{int(reg.reports_fold_skipped.value())}, rebuilds "
                  f"{int(reg.reports_rebuilds.value())}, journal records "
                  f"{int(reg.reports_journal_records.value())}, journal bytes "
                  f"{st['journal_bytes']}, compactions {st['compactions']}, "
                  f"seq {st['seq']}, live rows {st['resources']}; recoveries "
                  f"by reason {recov}; breaker fallbacks {fallbacks}")
        g = svc._scanner._step
        keys = step_keys(g)
        say("12", f"step graph keys (eager runs, captures, replays): {keys}")
        if len(keys) > STEP_MAX_KEYS:
            raise AssertionError(f"the step held {len(keys)} graph keys")

        # -- the rows against the plain twins: a seeded sample of 2,048
        # live uids with every uid of the last tick
        live = {uid for uid, _, _ in snap.items()}
        last = sorted(state["last"] & live)
        rest = sorted(live - set(last))
        sample = last + random.Random(seed).sample(
            rest, max(0, min(len(rest), 2048 - len(last))))
        gone = sorted(state["last"] - live)
        t0 = time.perf_counter()
        # the verdict cache is keyed by content, not by device: off, or
        # the CPU scan would answer from the card's columns
        tcache.configure(0, 0)
        cpu = ShardedScanner(svc._scanner.cps.policies, device="cpu",
                             data_sources=svc._configmap_sources())
        res = cpu.scan([snap.get(u) for u in sample], snap.namespace_labels())
        ps_key = policyset_key(svc._get_pipeline(svc._scanner).engine)
        bad = [u for ci, u in enumerate(sample)
               if store._rows.get(u) is None
               or store._rows[u][0] != snap.hash_of(u)
               or store._rows[u][1] != ps_key
               or store._rows[u][5] != report_rows(res, ci)]
        bad += [u for u in gone if u in store._rows]
        tcache.configure(*cache_caps)
        if bad:
            raise AssertionError(f"{len(bad)} store rows differ from the "
                                 f"plain twins' (first {bad[:5]})")
        say("12", f"the store's rows of {len(sample)} uids ({len(last)} of "
                  f"the last tick, {len(gone)} deleted in it and absent) "
                  f"equal a CPU ShardedScanner (plain twins) scan's "
                  f"({time.perf_counter() - t0:.3f} s)")

        global_verifier.drain(timeout=120.0)
        vst = global_verifier.state()["stats"]
        fst = global_flight.state()["stats"]
        breached = list(global_slo.state().get("breached", []))
        say("12", f"shadow verification (rate 1.0, flight recorder at "
                  f"0.001, {fst['captured']} captured): checked "
                  f"{vst['checked']}, divergences {vst['divergences']}; SLOs "
                  f"breached {breached}")
        if vst["divergences"] or not vst["checked"]:
            raise AssertionError(f"shadow verification: {vst}")
        if "scan_freshness" in breached:
            raise AssertionError("the scan-freshness SLO was breached")

        # -- (c) close (one compaction: every row to the snapshot), reopen
        t0 = time.perf_counter()
        store.close()
        t_close = time.perf_counter() - t0
        t0 = time.perf_counter()
        store = configure_reports(directory=rdir,
                                  journal_max_bytes=SOAK_JOURNAL_MAX)
        if store.digest() != d_b:
            raise AssertionError("(c) the reopened store's digest differs")
        say("12", f"(c) closed (a compaction of "
                  f"{store.state()['resources']} rows) in {t_close:.3f} s, "
                  f"reopened in {time.perf_counter() - t0:.3f} s: digest "
                  f"equal {tag}")

        # -- (d) a full recompute on the card into a fresh store
        ladder_reset()
        reset_reports()
        tcache.global_verdict_cache.clear()
        fresh = configure_reports()
        svc2 = BackgroundScanService(snap, cache)
        t0 = time.perf_counter()
        count = svc2.scan_once(full=True)
        wall = time.perf_counter() - t0
        ladder_check("12")
        if fresh.digest() != store.digest():
            raise AssertionError("(d) the full recompute's digest differs "
                                 "from the churned store's")
        say("12", f"(d) a new service's full recompute: {count} resources in "
                  f"{wall:.3f} s ({count / wall:.1f} /s): digest equals the "
                  f"churned store's; its step's keys "
                  f"{step_keys(svc2._scanner._step)} {tag}")
        rss = [full["rss_mb"]] + [t["rss_mb"] for t in ticks]
        say("12", f"RSS MB after the full scan and each churn tick: {rss}")
        kerr = reg.kernel_errors.value() - kerr0
        if kerr:
            raise AssertionError(f"{kerr} kernel errors in the phase")
        global_verifier.configure(rate=0.0)
        global_verifier.stop()
        say("12", f"phase 12 in {time.perf_counter() - t_phase:.3f} s")
        return {"launches": launches, "ticks": ticks, "full": full,
                "dir": rdir}
    finally:
        PipelinedScanner.scan_chunks = real_chunks
        del global_flight.record_scan_chunk
        global_flight.configure(sample_rate=sample_rate0)
        global_faults.disarm()
        reset_reports()
        tcache.configure(0, 0)


ANALYSIS_TIMINGS = ("synthesize_s", "evaluate_s", "classify_s", "confirm_s",
                    "witness_evals_per_s")


def analysis_view(report):
    """An AnalysisReport less its timings: anomalies (with evidence),
    counts, rule rows and the rest of its stats."""
    doc = report.to_dict()
    doc["stats"] = {k: v for k, v in doc["stats"].items()
                    if k not in ANALYSIS_TIMINGS}
    doc["evidence"] = [a.evidence for a in report.anomalies]
    return doc


def load_fixture(name):
    import yaml

    from kyverno_tpu_torch.api.policy import ClusterPolicy, is_policy_document
    from kyverno_tpu_torch.policy.autogen import expand_policy

    with open(os.path.join(ANALYSIS_DIR, name)) as f:
        return [expand_policy(ClusterPolicy.from_dict(d))
                for d in yaml.safe_load_all(f)
                if isinstance(d, dict) and is_policy_document(d)]


def analysis_phase(torch, kernels, tag, seed, cache_caps):
    """Phase 13: policy-set analysis on the card (bench.py's analyze
    config: PSS plus the seeded anomalies, tile 256), cold and warm,
    against a CPU engine's; the clean corpus; then the lifecycle's lint
    under admission traffic (``LINT_REQUESTS`` before the policy's add,
    twice as many after its lint). Returns the launches of the warm
    run."""
    import random as _random
    import threading

    from kyverno_tpu_torch.analysis import analyzer, global_analysis
    from kyverno_tpu_torch.api.policy import ClusterPolicy
    from kyverno_tpu_torch.cluster.policycache import PolicyCache
    from kyverno_tpu_torch.lifecycle import PolicySetLifecycleManager
    from kyverno_tpu_torch.lifecycle.manager import default_compile_fn
    from kyverno_tpu_torch.observability.analytics import global_slo
    from kyverno_tpu_torch.observability.metrics import global_registry as reg
    from kyverno_tpu_torch.observability.profiling import PATH_DEVICE
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.policy.autogen import expand_policy
    from kyverno_tpu_torch.serving import AdmissionPipeline, BatchConfig
    from kyverno_tpu_torch.tpu import cache as tcache
    from kyverno_tpu_torch.tpu import graphs
    from kyverno_tpu_torch.tpu.engine import TorchEngine
    from kyverno_tpu_torch.tpu.flatten import EncodeConfig

    t_phase = time.perf_counter()
    ladder_reset()
    tcache.configure(*cache_caps)  # bench.py's analyze: default caches
    kerr0 = reg.kernel_errors.value()
    real_eval = analyzer.evaluate_corpus
    tables = []

    def evaluate_corpus(engine, corpus, *a, **kw):
        table, n = real_eval(engine, corpus, *a, **kw)
        tables.append(table)
        return table, n

    captures = []
    real_capture = graphs.GraphedProgram._capture

    def capture(self, key, dev, lanes):
        t0 = time.perf_counter()
        try:
            return real_capture(self, key, dev, lanes)
        finally:
            captures.append((threading.current_thread().name, key[0][1][0],
                             time.perf_counter() - t0, id(self)))

    analyzer.evaluate_corpus = evaluate_corpus
    graphs.GraphedProgram._capture = capture
    try:
        seeded = load_fixture("seeded_anomalies.yaml")
        policies = [expand_policy(p) for p in load_pss_policies()] + seeded
        t0 = time.perf_counter()
        eng = TorchEngine(policies)
        g = eng.cps.device_fn(device=eng.device)
        say("13", f"analysis engine: 18 PSS policies + {len(seeded)} seeded "
                  f"(tests/golden/analysis/seeded_anomalies.yaml), "
                  f"{len(eng.cps.rules)} rules, compiled in "
                  f"{time.perf_counter() - t0:.3f} s {tag}")
        reports = {}
        launches = {}
        for run in ("cold", "warm"):
            kernels.reset_launches()
            t0 = time.perf_counter()
            rep = analyzer.analyze_engine(eng, tile=256)
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            reports[run] = rep
            st = rep.stats
            say("13", f"analyze_engine {run}: {wall:.3f} s; witnesses "
                      f"{st['witnesses']} {st['witnesses_by_intent']}, tiles "
                      f"(device dispatches) {st['device_dispatches']}; "
                      f"anomalies {rep.counts()}; confirm checked "
                      f"{st['checked_cells']}, confirmed "
                      f"{st['confirmed_cells']}, refuted {st['refuted']}; "
                      f"phase s synthesize {st['synthesize_s']}, evaluate "
                      f"{st['evaluate_s']}, classify {st['classify_s']}, "
                      f"confirm {st['confirm_s']}; {st['witness_evals_per_s']}"
                      f" witnesses/s; graph keys {step_keys(g)} {tag}")
        for name in DENSE_KERNELS:
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"the analysis tile path never launched "
                                     f"{name}")
        ladder_check("13")
        rep = reports["warm"]
        counts = rep.counts()
        seeded_names = {p.name for p in seeded}
        stray = [a.to_dict() for a in rep.anomalies
                 if a.policy not in seeded_names]
        same = analysis_view(reports["cold"]) == analysis_view(rep)
        if any(counts[k] < 1 for k in counts) or rep.stats["refuted"] \
                or stray or not same:
            raise AssertionError(f"analysis: counts {counts}, refuted "
                                 f"{rep.stats['refuted']}, anomalies outside "
                                 f"the seeded policies {stray[:3]}, cold == "
                                 f"warm {same}")
        # the same analysis on a CPU engine (plain twins; the verdict
        # cache plays no part: evaluate_corpus scans uncached)
        t0 = time.perf_counter()
        cpu_rep = analyzer.analyze_engine(TorchEngine(cps=eng.cps,
                                                      device="cpu"), tile=256)
        if analysis_view(cpu_rep) != analysis_view(rep) \
                or tables[-1].shape != tables[-2].shape \
                or not (tables[-1] == tables[-2]).all():
            raise AssertionError("analysis: the card's report or verdict "
                                 "table differs from the CPU engine's")
        say("13", f"the card's report (anomalies, counts, rule rows) and "
                  f"verdict table {tables[-2].shape} equal a CPU TorchEngine "
                  f"(plain twins) run's ({time.perf_counter() - t0:.3f} s)")
        clean = TorchEngine(load_fixture("clean_corpus.yaml"))
        crep = analyzer.analyze_engine(clean, tile=256)
        if crep.anomalies or crep.stats["refuted"]:
            raise AssertionError(f"clean corpus: {crep.counts()}")
        say("13", f"clean corpus on the card: {crep.stats['witnesses']} "
                  f"witnesses, {crep.stats['device_dispatches']} tiles, no "
                  f"anomaly {tag}")

        # -- the lifecycle's lint under admission traffic (phase 11 (c)'s
        # lifecycle and pipeline, analyze_on_swap on)
        tcache.configure(0, 0)
        resources, _ = workload(2048, seed)
        raw = load_pss_policies()
        cache = PolicyCache()
        for p in raw:
            cache.set(p)
        mgr = PolicySetLifecycleManager(cache, compile_fn=default_compile_fn(
            encode_cfg=EncodeConfig(max_rows=128), warm=True,
            warm_buckets=ADMISSION_BUCKETS))
        mgr.analyze_on_swap = True
        lints = []
        real_lint = mgr.run_lint

        def run_lint(force=False):
            v = mgr.active
            prog = v.engine.cps.device_fn(device=v.engine.device) \
                if v is not None else None
            kc0 = bucket_counts(prog)
            t0 = time.perf_counter()
            rep = real_lint(force)
            t1 = time.perf_counter()
            if v is not None:
                lints.append({"revision": v.revision, "t0": t0, "t1": t1,
                              "ok": rep is not None, "before": kc0,
                              "after": bucket_counts(prog),
                              "program": prog,
                              "thread": threading.current_thread().name})
            return rep

        mgr.run_lint = run_lint
        global_analysis.reset()
        global_slo.reset()
        mgr.start()
        v1 = mgr.acquire()
        cadm = Admission(resources)
        cfg = BatchConfig(max_batch_size=64, max_wait_ms=2.0)
        cfg.min_bucket = TorchEngine.MIN_BUCKET
        cpipe = AdmissionPipeline(cadm, config=cfg,
                                  version_provider=mgr.acquire)
        pool = _random.Random(seed + 7).sample(range(len(resources)), 128)
        answers, errors, lats = [], [], []
        served = [0]
        lock = threading.Lock()
        stop = threading.Event()

        def worker(wseed):
            rng = _random.Random(wseed)
            local, lat = [], []
            while not stop.is_set():
                t = time.perf_counter()
                try:
                    local.append(cpipe.submit(rng.choice(pool)))
                    lat.append((t, time.perf_counter() - t))
                except Exception as e:  # noqa: BLE001 - a gate below
                    errors.append(f"{type(e).__name__}: {e}"[:300])
                with lock:
                    served[0] += 1
            with lock:
                answers.extend(local)
                lats.extend(lat)

        def wait_for(cond, what, limit=180.0):
            t = time.perf_counter()
            while not cond():
                if time.perf_counter() - t > limit:
                    raise AssertionError(f"lint under traffic: no {what} in "
                                         f"{limit} s")
                time.sleep(0.01)

        wait_for(lambda: any(x["revision"] == v1.revision for x in lints),
                 "lint of the first version")
        threads = [threading.Thread(target=worker, args=(seed * 4000 + w,))
                   for w in range(8)]
        t_start = time.perf_counter()
        for th in threads:
            th.start()
        wait_for(lambda: served[0] >= LINT_REQUESTS, "traffic")
        cap0 = len(captures)
        cache.set(ClusterPolicy.from_dict(admission_policy(
            "admission-registry", "!evil.io/*")))
        wait_for(lambda: mgr.active.revision > v1.revision, "swap")
        v2 = mgr.active
        wait_for(lambda: any(x["revision"] == v2.revision for x in lints),
                 "lint of the new version")
        lint = [x for x in lints if x["revision"] == v2.revision][-1]
        after0 = served[0]
        wait_for(lambda: served[0] >= after0 + 2 * LINT_REQUESTS,
                 "traffic after the lint")
        stop.set()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t_start
        cpipe.stop()
        mgr.stop()
        if errors:
            raise AssertionError(f"lint under traffic: {len(errors)} requests "
                                 f"failed: {errors[:3]}")
        kc_end = bucket_counts(lint["program"])
        evicted = [b for b in ADMISSION_BUCKETS
                   if not any(k[0][1][0] == b
                              for k in lint["program"]._graphs)] \
            if hasattr(lint["program"], "_graphs") else []
        again = {b: kc_end.get(b, {}).get("captures", 0)
                 - lint["after"].get(b, {}).get("captures", 0)
                 for b in ADMISSION_BUCKETS}
        # the lint tile's bucket is captured on the worker before the
        # swap: the lint itself runs no bucket eagerly and captures none
        in_lint = {b: {k: c[k] - lint["before"].get(b, {}).get(k, 0)
                       for k in ("eager", "captures")}
                   for b, c in lint["after"].items()}
        in_lint = {b: d for b, d in in_lint.items() if any(d.values())}
        windows = {"before": [l for t, l in lats if t < lint["t0"]],
                   "during": [l for t, l in lats
                              if lint["t0"] <= t <= lint["t1"]],
                   "after": [l for t, l in lats if t > lint["t1"]]}
        new_caps = captures[cap0:]
        lint_rows = [(x["revision"], round(x["t1"] - x["t0"], 3), x["ok"])
                     for x in lints]
        say("13", f"lint under traffic: {served[0]} requests from 8 threads "
                  f"in {wall:.3f} s; revisions {v1.revision} -> "
                  f"{v2.revision}; the new version's lint "
                  f"{lint['t1'] - lint['t0']:.3f} s on "
                  f"{lint['thread']!r}, outcome "
                  f"{'ok' if lint['ok'] else 'none'}; global_analysis runs "
                  f"{global_analysis.runs}; lints (revision, s, ok) "
                  f"{lint_rows} {tag}")
        p99 = {k: pct_ms(v, 99) for k, v in windows.items()}
        ratio = (f"{p99['during'] / p99['before']:.3f}"
                 if windows["during"] and windows["before"] else "n/a")
        say("13", "latency p50 / p99 ms, before / during / after the lint: "
                  + ", ".join(f"{k} {pct_ms(v, 50):.3f} / {p99[k]:.3f}"
                              f" ({len(v)})" for k, v in windows.items())
                  + f"; p99 during / before {ratio}")
        say("13", f"admission buckets' eager runs, captures, replays: before "
                  f"the lint {lint['before']}, after it {lint['after']}, at "
                  f"the end {kc_end}; live graphs "
                  f"{getattr(lint['program'], 'live_graphs', 0)} (at most "
                  f"{graphs.MAX_GRAPHS}); admission buckets evicted "
                  f"{evicted}; captures again after the lint {again}; "
                  f"eager runs or captures during the lint {in_lint}")
        say("13", "captures from the policy's add on (thread, batch, s): "
                  + str([(t, b, round(d, 3)) for t, b, d, _ in new_caps]))
        if not lint["ok"] or global_analysis.runs.get("error"):
            raise AssertionError(f"the lint's outcome: {lint['ok']}, runs "
                                 f"{global_analysis.runs}")
        if any(again.values()) or evicted:
            raise AssertionError(f"the lint evicted admission graphs: "
                                 f"{evicted}, captured again {again}")
        if in_lint:
            raise AssertionError(f"the lint ran or captured a bucket on the "
                                 f"version it linted: {in_lint}")
        t0 = time.perf_counter()
        want = {}
        asked = {i for _, i, _ in answers}
        for rev, v in cadm.versions.items():
            want[rev] = admission_reference(v.engine, resources, asked)
        check_answers("lint under traffic", answers, want)
        off = [f for f in cadm.flushes if f[3] != PATH_DEVICE]
        if off:
            raise AssertionError(f"{len(off)} flushes were not answered on "
                                 f"the device: {off[:3]}")
        say("13", f"{len(answers)} answers equal the CPU engine's rows under "
                  f"the revision their flush pinned "
                  f"({time.perf_counter() - t0:.3f} s); every flush on the "
                  f"device")
        kerr = reg.kernel_errors.value() - kerr0
        if kerr:
            raise AssertionError(f"{kerr} kernel errors in the phase")
        say("13", f"phase 13 in {time.perf_counter() - t_phase:.3f} s")
        return {"launches": launches}
    finally:
        analyzer.evaluate_corpus = real_eval
        graphs.GraphedProgram._capture = real_capture
        tcache.configure(0, 0)


# ---------------------------------------------------------------------------
# phase 14: the sharded scan on a mesh of CUDA devices, the dry run, and
# two fleet replicas behind the scan service

# entries of the 2-axis mesh (make_mesh_2d(2, 2, devs)); a card repeats
# when the machine has fewer
MESH_ENTRIES = 4
# Pods each fleet replica's scan service holds (bench.py's lean soak Pods)
FLEET_N = 20000
# the fleet's shards (fleet/shards.py's default)
FLEET_SHARDS = 64


def mesh_devices(torch, k: int):
    """``k`` mesh entries over the visible cards: ``cuda:(i % count)``."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(k)]


def mesh_scan(torch, kernels, label, sc, feed, one_table, one_s, tile, tag):
    """Phase 14 (a) on one mesh: ``scan_stream`` over the snapshot cold
    and warm, then ``PipelinedScanner`` (an encode thread), each table
    equal to the one-device scan's; the first tile's device table and
    counts equal the one-device scanner's. Returns the warm scan's
    launches (all, and by device)."""
    import numpy as np

    from kyverno_tpu_torch.tpu.pipeline import PipelinedScanner

    resources, ops = feed["resources"], feed["ops"]
    n = len(resources)
    mesh = sc.mesh
    shards = mesh.flat
    distinct = mesh.distinct
    say("14", f"{label}: mesh {mesh.shape} of {[str(d) for d in shards]}: "
              f"{len(distinct)} distinct device(s) of "
              f"{torch.cuda.device_count()} visible"
              + (f"; {len(shards) - len(distinct)} entries name a card "
                 "already in the mesh (the machine has fewer cards than "
                 "the mesh has entries)"
                 if len(distinct) < len(shards) else "")
              + f"; tile {tile} -> shards of {sc.pad(tile) // mesh.size}")
    ladder_reset()
    t0 = time.perf_counter()
    res, _ = sc.scan_stream(resources, tile=tile, operations=ops)
    cold = time.perf_counter() - t0
    if not np.array_equal(res.verdicts, one_table):
        raise AssertionError(f"{label}: cold scan_stream differs from the "
                             "one-device scan")
    kernels.reset_launches()
    for d in sc.device_launches.values():
        d.clear()
    t0 = time.perf_counter()
    res, st = sc.scan_stream(resources, tile=tile, operations=ops)
    warm = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    by_device = {d: dict(v) for d, v in sc.device_launches.items()}
    if not np.array_equal(res.verdicts, one_table):
        raise AssertionError(f"{label}: warm scan_stream differs from the "
                             "one-device scan")
    for d in distinct:
        missing = [k for k in SCAN_KERNELS if not by_device[str(d)].get(k)]
        if missing:
            raise AssertionError(f"{label}: {missing} never launched on {d}")
    say("14", f"{label}: scan_stream {n} resources, tile {tile}: cold "
              f"{cold:.3f} s, warm {warm:.3f} s, {n / warm:.1f} resources/s "
              f"(one device warm {one_s:.3f} s, {n / one_s:.1f} /s), "
              f"encode_s {st['encode_s']:.3f}, device_s "
              f"{st['device_s']:.3f}, host_s {st['host_s']:.3f}; table equal "
              f"to the one-device scan's {tag}")
    say("14", f"{label}: warm scan's launches by device "
              + json.dumps(by_device))
    chunks = [resources[i:i + tile] for i in range(0, n, tile)]
    op_chunks = [ops[i:i + tile] for i in range(0, n, tile)]
    out = {}
    t0 = time.perf_counter()
    pst = PipelinedScanner(sc, encode_pool=None).scan_chunks(
        chunks, operations=op_chunks,
        on_result=lambda i, r: out.__setitem__(i, r.verdicts))
    wall = time.perf_counter() - t0
    table = np.concatenate([out[i] for i in range(len(chunks))], axis=1)
    if not np.array_equal(table, one_table):
        raise AssertionError(f"{label}: the pipelined scan differs from the "
                             "one-device scan")
    paths = [t["path"] for t in pst["timeline"]]
    if paths != ["device"] * len(chunks):
        raise AssertionError(f"{label}: pipelined chunk paths {paths}")
    say("14", f"{label}: PipelinedScanner (encode thread) {n} resources in "
              f"{len(chunks)} chunks: {wall:.3f} s, {n / wall:.1f} "
              f"resources/s, overlap_ratio {pst['overlap_ratio']}; table "
              f"equal {tag}")
    first, fops = resources[:tile], ops[:tile]
    return launches, by_device, sc.scan_device(first, operations=fops)


@contextlib.contextmanager
def as_replica(mgr, store):
    """One in-process fleet replica's scan tick: ``mgr`` as the
    process-global fleet the scan service consults and ``store`` as the
    report store it folds into."""
    from kyverno_tpu_torch.fleet import manager as fm
    from kyverno_tpu_torch.reports import store as rstore

    with fm._fleet_lock:
        prev_fleet, fm._global_fleet = fm._global_fleet, mgr
    with rstore._store_lock:
        prev_store, rstore._store = rstore._store, store
    try:
        yield
    finally:
        with fm._fleet_lock:
            fm._global_fleet = prev_fleet
        with rstore._store_lock:
            rstore._store = prev_store


def fleet_check(torch, mesh, tag):
    """Phase 14 (c): a one-replica scan service over ``FLEET_N`` Pods on
    the mesh, then two in-process replicas on one ``LeaseStore`` (their
    peer servers on localhost, ``listen_port=0``; ticks driven by hand),
    each a service on the mesh over its own copy of the snapshot: the
    owned shards partition the keyspace, the two report stores' rows are
    the one-replica store's, and after one replica leaves gracefully the
    other's takeover rescan gives the one-replica store's digest."""
    from kyverno_tpu_torch.cluster import (BackgroundScanService,
                                           ClusterSnapshot, PolicyCache)
    from kyverno_tpu_torch.cluster.leaderelection import LeaseStore
    from kyverno_tpu_torch.fleet import FleetConfig, FleetManager, shard_of
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.reports import ReportStore

    policies = load_pss_policies()
    pods = [soak_pod(i) for i in range(FLEET_N)]

    def service():
        snap, cache = ClusterSnapshot(), PolicyCache()
        for p in policies:
            cache.set(p)
        for p in pods:
            snap.upsert(p)
        return BackgroundScanService(snap, cache, mesh=mesh), snap

    def timed_scan(svc, full):
        t0 = time.perf_counter()
        n = svc.scan_once(full=full)
        return n, time.perf_counter() - t0

    one = ReportStore()
    svc1, snap1 = service()
    with as_replica(None, one):
        n1, s1 = timed_scan(svc1, True)
    if n1 != FLEET_N:
        raise AssertionError(f"one replica scanned {n1} of {FLEET_N}")
    want_rows, want_digest = dict(one._rows), one.digest()
    say("14", f"(c) one replica: {n1} Pods in {s1:.3f} s "
              f"({n1 / s1:.1f} /s), {len(want_rows)} report rows, digest "
              f"{want_digest[:16]} {tag}")

    leases = LeaseStore()
    mgrs = [FleetManager(FleetConfig(
        replica_id=rid, listen_port=0, lease_s=60.0,
        heartbeat_interval_s=3600.0, num_shards=FLEET_SHARDS))
        for rid in ("replica-a", "replica-b")]
    a, b = mgrs
    for m in mgrs:
        m.membership.store = leases
    a.add_peers(b.url)
    b.add_peers(a.url)
    try:
        for m in mgrs:
            m.start()
        for _ in range(3):
            for m in mgrs:
                m.tick()
        live = [m.membership.live() for m in mgrs]
        if live != [["replica-a", "replica-b"]] * 2:
            raise AssertionError(f"(c) membership {live}")
        owned = [m.owned_view() for m in mgrs]
        if owned[0] & owned[1] or owned[0] | owned[1] != \
                frozenset(range(FLEET_SHARDS)):
            raise AssertionError(f"(c) owned shards {owned} do not "
                                 "partition the keyspace")
        stores = [ReportStore(), ReportStore()]
        svcs = [service()[0], service()[0]]
        for m, svc, store, mine in zip(mgrs, svcs, stores, owned):
            with as_replica(m, store):
                n, s = timed_scan(svc, True)
            want_n = sum(shard_of(u, FLEET_SHARDS) in mine
                         for u, _, _ in snap1.items())
            if n != want_n:
                raise AssertionError(f"(c) {m.config.replica_id} scanned "
                                     f"{n}, owns {want_n}")
            say("14", f"(c) {m.config.replica_id}: {len(mine)} shards, "
                      f"{n} Pods in {s:.3f} s, skipped_unowned "
                      f"{svc.stats.get('skipped_unowned', 0)} {tag}")
        ra, rb = stores[0]._rows, stores[1]._rows
        if set(ra) & set(rb) or {**ra, **rb} != want_rows:
            raise AssertionError("(c) the two replicas' report rows are "
                                 "not the one replica's")
        say("14", f"(c) the replicas' report rows ({len(ra)} + {len(rb)}) "
                  "are the one-replica store's rows")
        b.stop(leave=True)
        a.tick()
        if a.membership.live() != ["replica-a"] or \
                a.owned_view() != frozenset(range(FLEET_SHARDS)):
            raise AssertionError(f"(c) after the leave: live "
                                 f"{a.membership.live()}, owned "
                                 f"{len(a.owned_view())}")
        with as_replica(a, stores[0]):
            n, s = timed_scan(svcs[0], False)
        if n != len(rb) or stores[0]._rows != want_rows \
                or stores[0].digest() != want_digest:
            raise AssertionError(f"(c) the takeover rescan ({n} Pods) does "
                                 "not give the one-replica digest")
        say("14", f"(c) replica-b left gracefully: replica-a took over "
                  f"{FLEET_SHARDS - len(owned[0])} shards, rescanned {n} Pods "
                  f"in {s:.3f} s; digest {stores[0].digest()[:16]} equals "
                  f"the one-replica store's {tag}")
    finally:
        for m in mgrs:
            m.stop(leave=False)


def mesh_phase(torch, kernels, scanner, policies, feed, tile, tag):
    """Phase 14: (a) the background scan's snapshot on two meshes,
    ``make_mesh()`` (every CUDA device) and ``make_mesh_2d(2, 2, devs)``
    with ``devs`` = ``cuda:(i % count)`` for i < 4, through
    ``scan_stream`` and ``PipelinedScanner``, each table equal to the
    one-device scanner's (its warm ``scan_stream``, timed beside them);
    every scan kernel launches on every distinct device; (b) the dry run
    ``dryrun_multichip(4, devs)``; (c) ``fleet_check`` on the 2 x 2
    mesh. Both content caches off. Returns the 2 x 2 mesh's warm scan's
    launches, all and by device."""
    import numpy as np

    from kyverno_tpu_torch.dryrun import dryrun_multichip
    from kyverno_tpu_torch.observability.flightrecorder import global_flight
    from kyverno_tpu_torch.observability.metrics import global_registry as reg
    from kyverno_tpu_torch.observability.verification import global_verifier
    from kyverno_tpu_torch.parallel import (ShardedScanner, make_mesh,
                                            make_mesh_2d)
    from kyverno_tpu_torch.tpu import cache as tcache

    t_phase = time.perf_counter()
    tcache.configure(0, 0)
    global_flight.reset()
    global_verifier.reset()
    kerr0 = reg.kernel_errors.value()
    devs = mesh_devices(torch, MESH_ENTRIES)
    resources, ops = feed["resources"], feed["ops"]
    n = len(resources)
    ladder_reset()
    t0 = time.perf_counter()
    base, _ = scanner.scan_stream(resources, tile=tile, operations=ops)
    one_s = time.perf_counter() - t0
    one_table = feed["verdicts"]
    if not np.array_equal(base.verdicts, one_table):
        raise AssertionError("the one-device scan_stream differs from "
                             "phase 5's")
    first, fops = resources[:tile], ops[:tile]
    one_v, one_c = scanner.scan_device(first, operations=fops)
    say("14", f"one device ({scanner.device}): scan_stream {n} resources "
              f"warm {one_s:.3f} s, {n / one_s:.1f} resources/s {tag}")
    out = {}
    for label, mesh in (("make_mesh()", make_mesh()),
                        ("make_mesh_2d(2, 2)", make_mesh_2d(2, 2, devs))):
        t0 = time.perf_counter()
        sc = ShardedScanner(policies, mesh=mesh)
        say("14", f"{label}: compiled in {time.perf_counter() - t0:.3f} s")
        launches, by_device, (v, c) = mesh_scan(
            torch, kernels, label, sc, feed, one_table, one_s, tile, tag)
        if not (np.array_equal(v, one_v) and np.array_equal(c, one_c)):
            raise AssertionError(f"{label}: the first tile's device table "
                                 "and counts differ from one device's")
        say("14", f"{label}: the first tile's uint8 table and counts equal "
                  "the one-device scanner's")
        out[label] = (launches, by_device)
        ladder_check("14")
        del sc
    t0 = time.perf_counter()
    again, _ = scanner.scan_stream(resources, tile=tile, operations=ops)
    again_s = time.perf_counter() - t0
    if not np.array_equal(again.verdicts, one_table):
        raise AssertionError("the one-device scan_stream differs from "
                             "phase 5's")
    say("14", f"one device again, after the meshes: warm {again_s:.3f} s, "
              f"{n / again_s:.1f} resources/s (the spread of the one-device "
              f"time within this call) {tag}")
    t0 = time.perf_counter()
    dry = dryrun_multichip(MESH_ENTRIES, devs)
    say("14", f"(b) dryrun_multichip({MESH_ENTRIES}, {[str(d) for d in devs]})"
              f": {json.dumps(dry)} in {time.perf_counter() - t0:.3f} s; "
              "parity with one device, privileged Pods fail, scan_stream "
              f"covers every resource, one leader {tag}")
    fleet_check(torch, make_mesh_2d(2, 2, devs), tag)
    kerr = reg.kernel_errors.value() - kerr0
    if kerr:
        raise AssertionError(f"{kerr} kernel errors in the phase")
    ladder_check("14")
    say("14", f"phase 14 in {time.perf_counter() - t_phase:.3f} s {tag}")
    return out["make_mesh_2d(2, 2)"]


# ---------------------------------------------------------------------------
# phase 15: the admission webhook server and its entry points on the card
# (webhooks/server.py, cli/serve.py, cli/apply.py, python -m
# kyverno_tpu_torch)

# (a): PSS (Audit), a mutate policy, a digest-only verifyImages policy (no
# attestor, so no registry: its validate side fails an image without a
# digest) and an Enforce policy (about half of the seeded Pods and their
# controllers run an image from evil.io, and are denied) behind a
# ControlPlane with --batching and --mutate-batching
SERVER_POLICIES = (
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "add-team-label"},
     "spec": {"rules": [{
         "name": "team",
         "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
         "mutate": {"patchStrategicMerge": {"metadata": {
             "labels": {"+(team)": "core"}}}}}]}},
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "image-digests"},
     "spec": {"validationFailureAction": "Audit", "rules": [{
         "name": "digest",
         "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
         "verifyImages": [{"imageReferences": ["*"], "verifyDigest": True,
                           "mutateDigest": False, "required": False}]}]}},
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "trusted-registries"},
     "spec": {"validationFailureAction": "Enforce", "rules": [{
         "name": "registry",
         "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
         "validate": {"message": "images from evil.io are not allowed",
                      "pattern": {"spec": {"containers": [
                          {"image": "!evil.io/*"}]}}}}]}},
)
# the fine-grained path of (a): one PSS policy's own webhook
SERVER_FINEGRAINED = "/validate/fail/finegrained/disallow-privileged-containers"
SERVER_REQUESTS = 2048  # (a)'s AdmissionReviews over HTTP
SERVER_CHECKED = 256  # (a)'s reviews held against the CPU's answers
# (a)'s HTTP clients, one connection a request: fewer than the server's
# accept backlog (socketserver's default of 5). More concurrent connects
# overflow the accept queue: TCP retries a dropped one after 1 s, or the
# connection is reset and the request fails
SERVER_CLIENTS = 4
# bench.py's churn config (bench_churn): 32 workers for 8 s, the churn
# policy re-set every 50 ms, BatchConfig(64, 2.0, 30,000, 120)
CHURN_WORKERS = 32
CHURN_SECONDS = 8.0
CHURN_EVERY_S = 0.05


def churn_policy(i: int) -> dict:
    """bench.py's churned policy at revision ``i``."""
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": "churned"},
            "spec": {"validationFailureAction": "Enforce", "rules": [{
                "name": "r",
                "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
                "validate": {"message": f"v{i}", "pattern": {
                    "spec": {"containers": [{"=(securityContext)": {
                        "=(privileged)": "true" if i % 2 else "false"}}]}}},
            }]}}


def churn_snapshot(n: int, seed: int = 0):
    """bench.py's ``make_snapshot``: Pods with varied security settings."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        containers = []
        for c in range(rng.randint(1, 3)):
            sc = {}
            if rng.random() < 0.3:
                sc["privileged"] = rng.choice([True, False])
            if rng.random() < 0.4:
                sc["allowPrivilegeEscalation"] = rng.choice([True, False])
            if rng.random() < 0.3:
                sc["runAsNonRoot"] = rng.choice([True, False])
            if rng.random() < 0.3:
                sc["seccompProfile"] = {"type": rng.choice(
                    ["RuntimeDefault", "Unconfined", "Localhost"])}
            if rng.random() < 0.2:
                sc["capabilities"] = {"add": rng.sample(
                    ["CHOWN", "KILL", "SYS_ADMIN", "NET_RAW"],
                    k=rng.randint(1, 2))}
            if rng.random() < 0.15:
                sc["capabilities"] = {"drop": ["ALL"]}
            containers.append({
                "name": f"c{c}", "image": rng.choice(["nginx:1.25",
                                                      "redis:7"]),
                **({"securityContext": sc} if sc else {}),
                "resources": {"limits": {"memory": rng.choice(
                    ["256Mi", "1Gi", "4Gi"])}},
                **({"ports": [{"containerPort": 80 + c,
                               **({"hostPort": 8080}
                                  if rng.random() < 0.1 else {})}]}
                   if rng.random() < 0.3 else {}),
            })
        spec = {"containers": containers}
        if rng.random() < 0.2:
            spec["hostNetwork"] = rng.choice([True, False])
        if rng.random() < 0.3:
            spec["volumes"] = [{"name": "v", rng.choice(
                ["emptyDir", "configMap", "hostPath", "secret"]): {}}]
        if rng.random() < 0.3:
            spec["securityContext"] = {"runAsUser": rng.choice([0, 1000])}
        meta = {"name": f"pod-{i}",
                "namespace": rng.choice(["default", "prod", "dev"]),
                "labels": {"app": f"app-{i % 17}"}}
        if rng.random() < 0.1:
            meta["annotations"] = {
                "container.apparmor.security.beta.kubernetes.io/c0":
                    rng.choice(["runtime/default", "localhost/p1",
                                "unconfined"])}
        out.append({"apiVersion": "v1", "kind": "Pod", "metadata": meta,
                    "spec": spec})
    return out


class ServerTrace:
    """The phase's device program calls and admission flushes: every
    ``GraphedProgram`` call's thread, batch, kind (eager run, capture,
    replay) and interval; every validate flush's dispatch path and
    every mutate-triage flush's device batches, read on the flusher's
    thread (the dispatch path is kept per thread)."""

    def __init__(self):
        import threading

        self.calls = []
        self.flushes = []
        self.lock = threading.Lock()

    def install(self):
        import threading

        from kyverno_tpu_torch.observability.profiling import \
            last_dispatch_path
        from kyverno_tpu_torch.tpu import graphs
        from kyverno_tpu_torch.webhooks import server

        trace = self
        self._saved = (graphs.GraphedProgram.__call__,
                       server.Handlers._evaluate_padded,
                       server.Handlers._triage_padded)
        real_call, real_eval, real_triage = self._saved

        def call(gp, lanes):
            key = gp.key(lanes)
            before = dict(gp.key_counts.get(key, {}))
            t0 = time.perf_counter()
            try:
                return real_call(gp, lanes)
            finally:
                t1 = time.perf_counter()
                after = gp.key_counts.get(key, {})
                kind = next((k for k in ("captures", "eager")
                             if after.get(k, 0) > before.get(k, 0)),
                            "replays")
                with trace.lock:
                    trace.calls.append((threading.current_thread().name,
                                        key[0][1][0], kind, t0, t1))

        def evaluate(h, payloads, pinned=None):
            out = real_eval(h, payloads, pinned)
            dev = None if pinned is None else pinned.engine.device.type
            with trace.lock:
                trace.flushes.append(("validate", len(payloads),
                                      last_dispatch_path("none"), dev))
            return out

        def triage(h, payloads, pinned=None):
            eng = None if pinned is None else pinned.engine
            d0 = None if eng is None else (eng.triage_dispatches,
                                           eng.triage_encode_fallbacks)
            out = real_triage(h, payloads, pinned)
            path = "none"
            if eng is not None:
                d1 = (eng.triage_dispatches, eng.triage_encode_fallbacks)
                path = "device" if d1[0] > d0[0] and d1[1] == d0[1] \
                    else "host"
            with trace.lock:
                trace.flushes.append(("triage", len(payloads), path,
                                      None if eng is None
                                      else eng.device.type))
            return out

        graphs.GraphedProgram.__call__ = call
        server.Handlers._evaluate_padded = evaluate
        server.Handlers._triage_padded = triage

    def uninstall(self):
        from kyverno_tpu_torch.tpu import graphs
        from kyverno_tpu_torch.webhooks import server

        (graphs.GraphedProgram.__call__, server.Handlers._evaluate_padded,
         server.Handlers._triage_padded) = self._saved

    def firsts(self, since: float):
        """(thread, batch, kind, s) of the eager runs and captures since
        ``since``."""
        return [(t, b, k, round(t1 - t0, 3)) for t, b, k, t0, t1 in self.calls
                if t0 >= since and k != "replays"]

    def busy(self, since: float):
        """Intervals of the eager runs and captures since ``since``."""
        return [(t0, t1) for _, _, k, t0, t1 in self.calls
                if t0 >= since and k != "replays"]


# phase 15 (a)'s load generator: a process of its own, so that the
# server's interpreter (its GIL) runs only the server's work. Arguments:
# the reviews' file, the answers' file, the port, the client threads.
# One connection a request; each answer is [status, body, t0, t1] on the
# system-wide monotonic clock (``time.perf_counter``), which the
# server's process reads too.
HTTP_CLIENT = r"""
import concurrent.futures, http.client, json, sys, time
src, dst, port, clients = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
with open(src) as f:
    reqs = json.load(f)

def post(pr):
    path, body = pr
    data = json.dumps(body)
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, data,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
    finally:
        conn.close()
    return [resp.status, raw.decode(), t0, time.perf_counter()]

with concurrent.futures.ThreadPoolExecutor(max_workers=clients) as ex:
    out = list(ex.map(post, reqs))
with open(dst, "w") as f:
    json.dump(out, f)
"""


def http_load(port: int, reviews, clients: int):
    """(status, response, t0, t1) of each (path, review) of ``reviews``,
    posted by ``HTTP_CLIENT`` in a process of its own from ``clients``
    threads."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip-smoke-load-") as d:
        src, dst = os.path.join(d, "in.json"), os.path.join(d, "out.json")
        with open(src, "w") as f:
            json.dump(reviews, f)
        subprocess.run([sys.executable, "-c", HTTP_CLIENT, src, dst,
                        str(port), str(clients)], check=True, timeout=1200)
        with open(dst) as f:
            out = json.load(f)
    return [(st, json.loads(b) if st == 200 else b, t0, t1)
            for st, b, t0, t1 in out]


def http_post(port: int, path: str, body) -> tuple:
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    t1 = time.perf_counter()
    return resp.status, json.loads(data) if resp.status == 200 else data, \
        t0, t1


def http_get(port: int, path: str) -> tuple:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def server_reviews(n: int, seed: int):
    """(path, AdmissionReview) pairs: ``workload``'s resources and
    operations (an UPDATE carries its old object, a DELETE only its old
    object) spread over /validate, /mutate and the fine-grained path."""
    resources, ops = workload(n, seed)
    rng = random.Random(seed)
    out = []
    for i, (res, op) in enumerate(zip(resources, ops)):
        op = op or "CREATE"
        req = {"uid": f"s{i}", "operation": op,
               "namespace": res["metadata"]["namespace"],
               "userInfo": {"username": rng.choice(
                   ["alice", "system:serviceaccount:ci:deployer"]),
                   "groups": ["dev"]}}
        if op == "DELETE":
            req["oldObject"] = res
        else:
            req["object"] = res
            if op == "UPDATE":
                req["oldObject"] = res
        path = ("/validate", "/mutate", SERVER_FINEGRAINED)[i % 3]
        out.append((path, {"apiVersion": "admission.k8s.io/v1",
                           "kind": "AdmissionReview", "request": req}))
    return out


def cpu_prewarm(h, reviews) -> dict:
    """Put into the verdict cache (which must be on) the CPU engine's
    columns for ``reviews``: the validate scans, the mutate triage, and
    the patched objects of the composed validate leg, in three batched
    scans on ``h``'s own compiled version. The patched objects are
    predicted by ``h``'s host mutate engine over the set's mutate
    policies (the server's own loop when it has no compiled version).
    ``h`` (CPU ``Handlers``) then answers every review itself, taking
    those columns from the cache; a patched object the prediction missed
    is scanned by ``h``. Returns the resources of each scan."""
    from kyverno_tpu_torch.cluster.policycache import PolicyType
    from kyverno_tpu_torch.tpu.engine import build_scan_context
    from kyverno_tpu_torch.webhooks.server import (AdmissionPayload,
                                                   _payload_from_request)

    _, eng = h._engine()
    nsmap = h.snapshot.namespace_labels() if h.snapshot else {}
    need = h._need_roles()
    val, tri, pat = [], [], []
    for path, rv in reviews:
        p = _payload_from_request(rv["request"], h.snapshot, need)
        if path != "/mutate":
            val.append(p)
            continue
        tri.append(p)
        patched = p.resource
        for policy in h.cache.get_policies(
                PolicyType.MUTATE, kind=patched.get("kind"),
                namespace=p.namespace):
            out = h.scalar.mutate(build_scan_context(
                policy, patched, nsmap.get(p.namespace, {}), p.operation,
                p.info))
            if out.patched_resource is not None:
                patched = out.patched_resource
        if patched != p.resource:
            pat.append(AdmissionPayload(patched, p.operation, p.info,
                                        p.namespace, old=p.old,
                                        dry_run=p.dry_run))
    for group in (val, pat):
        if group:
            eng.scan([p.old if (p.operation == "DELETE" and p.old)
                      else p.resource for p in group], nsmap,
                     operations=[p.operation for p in group],
                     admission_infos=[p.info for p in group])
    if tri:
        eng.triage_mutate([p.resource for p in tri], nsmap,
                          operations=[p.operation for p in tri],
                          admission_infos=[p.info for p in tri])
    return {"validate": len(val), "triage": len(tri), "patched": len(pat)}


def admission_report_rows(agg, uids) -> dict:
    """Each of ``uids``' rows in the aggregator ``agg``, without their
    timestamps, in a fixed order."""
    import dataclasses

    out = {}
    for uid in uids:
        rows = agg._per_resource.get(uid)
        if rows is not None:
            out[uid] = sorted(tuple(v for k, v in dataclasses.asdict(r).items()
                                    if k != "timestamp") for r in rows)
    return out


def p99_without(lats, spans, busy) -> tuple:
    """(p99 ms, requests left out) of the requests whose span overlaps
    no eager run or capture."""
    keep = [lat for lat, (a, b) in zip(lats, spans)
            if not any(a < e and s < b for s, e in busy)]
    return pct_ms(keep, 99), len(lats) - len(keep)


def server_phase(torch, kernels, seed, tag):
    """Phase 15: the admission webhook server on the card. (a) a
    ``ControlPlane`` (``--batching --mutate-batching``) answering
    seeded AdmissionReviews over HTTP, held against a CPU ``Handlers``,
    then its scan service over a snapshot; (b) bench.py's churn config;
    (c) ``python -m kyverno_tpu_torch serve`` and ``apply`` as
    processes. Returns the server path's launches (of (a))."""
    import concurrent.futures
    import copy
    import signal
    import socket
    import tempfile
    import threading

    from kyverno_tpu_torch.api.policy import ClusterPolicy
    from kyverno_tpu_torch.cli.serve import ControlPlane
    from kyverno_tpu_torch.cluster import (BackgroundScanService,
                                           ClusterSnapshot, PolicyCache,
                                           ReportAggregator)
    from kyverno_tpu_torch.cluster.snapshot import resource_uid
    from kyverno_tpu_torch.config import Configuration, Toggles
    from kyverno_tpu_torch.engine.match import RequestInfo
    from kyverno_tpu_torch.observability.analytics import global_slo
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.observability.profiling import PATH_DEVICE
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.serving import BatchConfig
    from kyverno_tpu_torch.tpu import cache as tcache
    from kyverno_tpu_torch.webhooks import build_handlers
    from kyverno_tpu_torch.webhooks.server import AdmissionPayload

    t_phase = time.perf_counter()
    ladder_reset()
    tcache.configure(0, 0)  # every flush reaches the program
    kerr0 = global_registry.kernel_errors.value()
    tri_fb0 = global_registry.mutate_triage.value({"outcome": "fallback"})
    policies = list(load_pss_policies()) + [
        ClusterPolicy.from_dict(copy.deepcopy(d)) for d in SERVER_POLICIES]
    trace = ServerTrace()
    trace.install()
    try:
        # -- (a) the ControlPlane on the card, over HTTP
        global_slo.reset()
        cfg = BatchConfig(max_batch_size=64, max_wait_ms=2.0)
        t0 = time.perf_counter()
        cp = ControlPlane(policies, port=0, metrics_port=0, batching=True,
                          mutate_batching=True, batch_config=cfg)
        cp.start(scan_interval=3600)
        while cp.lifecycle.active is None:
            if time.perf_counter() - t0 > 300:
                raise AssertionError("(a): no compiled version in 300 s")
            time.sleep(0.05)
        eng = cp.lifecycle.active.engine
        start_s = time.perf_counter() - t0
        if eng.device.type != "cuda":
            raise AssertionError(f"(a): the server's engine is on {eng.device}")
        say("15", f"(a) ControlPlane(--batching --mutate-batching) on "
                  f"{eng.device}: {len(policies)} policies (18 PSS, a "
                  f"mutate policy, a digest-only verifyImages policy, an "
                  f"Enforce policy), "
                  f"coverage {eng.coverage()}, mutate "
                  f"{eng.mutate_coverage()}; compiled and warmed on the "
                  f"lifecycle worker in {start_s:.3f} s; calls before "
                  f"traffic {trace.firsts(0.0)} {tag}")
        reviews = server_reviews(SERVER_REQUESTS, seed)
        kernels.reset_launches()
        t_traffic = time.perf_counter()
        answers = http_load(cp.admission.port, reviews, SERVER_CLIENTS)
        wall = max(a[3] for a in answers) - min(a[2] for a in answers)
        bad = [(i, a[0]) for i, a in enumerate(answers) if a[0] != 200]
        if bad:
            raise AssertionError(f"(a): {len(bad)} requests failed: {bad[:3]}")
        lats = [a[3] - a[2] for a in answers]
        spans = [(a[2], a[3]) for a in answers]
        busy = trace.busy(t_traffic)
        p99_clean, n_over = p99_without(lats, spans, busy)
        # a connect that finds the server's accept queue full is retried
        # by the client's TCP after 1 s
        over_1s = sum(lat >= 1.0 for lat in lats)
        # the admission reports the card's verdicts wrote, read before the
        # scan service writes its own
        pick = sorted(random.Random(seed + 2).sample(range(SERVER_REQUESTS),
                                                     SERVER_CHECKED))
        uids = [resource_uid(reviews[i][1]["request"].get("object")
                             or reviews[i][1]["request"]["oldObject"])
                for i in pick]
        card_adm = admission_report_rows(cp.aggregator, uids)
        pst = cp.handlers.pipeline.state()["stats"]
        mst = cp.handlers.mutate_pipeline.state()["stats"]
        denied = sum(not a[1]["response"]["allowed"] for a in answers)
        patched = sum("patch" in a[1]["response"] for a in answers)
        say("15", f"(a) {SERVER_REQUESTS} AdmissionReviews over HTTP from "
                  f"{SERVER_CLIENTS} client threads of another process (/validate, /mutate, {SERVER_FINEGRAINED}) in "
                  f"{wall:.3f} s: {SERVER_REQUESTS / wall:.1f} requests/s; "
                  f"latency p50 {pct_ms(lats, 50):.3f} ms, p99 "
                  f"{pct_ms(lats, 99):.3f} ms, p99 without the "
                  f"{n_over} requests that overlap an eager run or capture "
                  f"{p99_clean:.3f} ms; {over_1s} requests took 1 s or more; "
                  f"denied {denied}, patched {patched} {tag}")
        say("15", f"(a) validate pipeline: flushes by bucket "
                  f"{pst['flushes_by_bucket']}, by reason "
                  f"{pst['flush_reasons']}, shed {pst['shed']}, expired "
                  f"{pst['expired']}, hedges {pst['hedges']}; mutate "
                  f"pipeline: flushes by bucket {mst['flushes_by_bucket']}, "
                  f"shed {mst['shed']}, expired {mst['expired']}, hedges "
                  f"{mst['hedges']}")
        say("15", "(a) eager runs and captures during traffic (thread, "
                  f"batch, kind, s): {trace.firsts(t_traffic)}")
        # its scan service over a snapshot of other resources
        scan_res = [dict(r, metadata=dict(r["metadata"], name=f"s{i}"))
                    for i, r in enumerate(workload(512, seed + 1)[0])]
        mport = cp.metrics_server.server_address[1]
        for r in scan_res:
            code, _, _, _ = http_post(mport, "/snapshot/upsert", r)
            if code != 200:
                raise AssertionError(f"(a): snapshot upsert {code}")
        t0 = time.perf_counter()
        code, scan_out, _, _ = http_post(mport, "/scan", {"full": True})
        scan_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if code != 200 or scan_out["scanned"] < len(scan_res):
            raise AssertionError(f"(a): /scan {code} {scan_out}")
        say("15", f"(a) scan service: {scan_out['scanned']} resources "
                  f"scanned on the card in {scan_s:.3f} s {tag}")
        say("15", f"(a) launches (the traffic and the scan) {launches}")
        for name in DENSE_KERNELS + SCAN_KERNELS:
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"the server path never launched {name}")
        code, metrics = http_get(mport, "/metrics")
        rcode, ready = http_get(mport, "/readyz")
        if code != 200 or b"# TYPE" not in metrics or rcode != 200:
            raise AssertionError(f"(a): /metrics {code}, /readyz {rcode}")
        card_rows = {uid: sorted((r.policy, r.rule, r.result) for r in rows)
                     for uid, rows in cp.aggregator._per_resource.items()}
        # the card's flushes (the CPU Handlers' below are not)
        flushes = list(trace.flushes)
        # the card's answers and admission reports against a CPU Handlers'
        # over the same set
        t0 = time.perf_counter()
        cache = PolicyCache()
        for p in policies:
            cache.set(p)
        # the plain program is thousands of small operations: one torch
        # thread, and budgets no CPU flush can overrun (an expiry would
        # be an answer of its own)
        threads0 = torch.get_num_threads()
        torch.set_num_threads(1)
        tcache.configure(1 << 16, 0)
        cpu_agg = ReportAggregator()
        cpu = build_handlers(cache, ClusterSnapshot(), cpu_agg,
                             configuration=Configuration(),
                             toggles=Toggles(), batching=True,
                             mutate_batching=True,
                             batch_config=BatchConfig(
                                 max_batch_size=64, max_wait_ms=2.0,
                                 deadline_ms=3_600_000.0,
                                 eval_grace_s=3600.0),
                             request_timeout_s=3600.0, device="cpu")

        def cpu_answer(i):
            path, rv = reviews[i]
            rv = copy.deepcopy(rv)
            if path == "/mutate":
                out = cpu.mutate(rv)
            elif path == "/validate":
                out = cpu.validate(rv)
            else:
                out = cpu.validate(rv, "fail", policy_key=(
                    "", path.rsplit("/", 1)[1]))
            return json.loads(json.dumps(out))

        warmed = cpu_prewarm(cpu, [reviews[i] for i in pick])
        warm_s = time.perf_counter() - t0
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=len(pick)) as ex:
            want = list(ex.map(cpu_answer, pick))
        cpu.pipeline.stop()
        cpu.mutate_pipeline.stop()
        cpu.batcher.stop()
        cpu_s = time.perf_counter() - t0
        diff = [i for i, w in zip(pick, want) if answers[i][1] != w]
        if diff:
            raise AssertionError(f"(a): {len(diff)} of {len(pick)} answers "
                                 f"differ from the CPU Handlers' (first "
                                 f"{diff[:3]}: {answers[diff[0]][1]} vs "
                                 f"{want[pick.index(diff[0])]})")
        # the Enforce policy denies some of them, and the Audit verdicts
        # are in the reports: both must show, and equal the CPU's
        n_denied = sum(not answers[i][1]["response"]["allowed"] for i in pick)
        cpu_adm = admission_report_rows(cpu_agg, uids)
        adm_diff = [u for u in uids if card_adm.get(u) != cpu_adm.get(u)]
        results = {}
        for rows in card_adm.values():
            for row in rows:
                results[row[2]] = results.get(row[2], 0) + 1
        if not n_denied or adm_diff or not results.get("fail") \
                or not results.get("pass"):
            raise AssertionError(
                f"(a): {n_denied} of {len(pick)} answers denied; "
                f"{len(adm_diff)} of {len(uids)} resources' admission "
                f"reports differ from the CPU Handlers' (first "
                f"{adm_diff[:1]}: {card_adm.get(adm_diff[0]) if adm_diff else ''} "
                f"vs {cpu_adm.get(adm_diff[0]) if adm_diff else ''}); the "
                f"card's rows by result {results}")
        # the scan service's rows against a CPU service over the same set
        snap = ClusterSnapshot()
        for r in scan_res:
            snap.upsert(r)
        agg = ReportAggregator()
        tcache.configure(0, 0)
        BackgroundScanService(snap, cache, agg, device="cpu").scan_once(
            full=True)
        torch.set_num_threads(threads0)
        cpu_rows = {uid: sorted((r.policy, r.rule, r.result) for r in rows)
                    for uid, rows in agg._per_resource.items()}
        scan_diff = [u for u in cpu_rows if card_rows.get(u) != cpu_rows[u]]
        if not cpu_rows or scan_diff:
            raise AssertionError(f"(a): {len(scan_diff)} of {len(cpu_rows)} "
                                 f"scanned resources' rows differ from the "
                                 f"CPU scan service's")
        say("15", f"(a) {len(pick)} of the answers ({n_denied} denied) and "
                  f"the admission reports of their {len(card_adm)} "
                  f"resources (rows by result {results}) equal a CPU "
                  f"Handlers' (plain twins; {cpu_s:.3f} s, of which "
                  f"{warm_s:.3f} s "
                  f"the batched CPU scans that put their columns into the "
                  f"verdict cache first: {warmed}), and the scan's rows of "
                  f"{len(cpu_rows)} resources a CPU scan service's "
                  f"({time.perf_counter() - t0:.3f} s in all)")
        off = [f for f in flushes if (f[0] == "validate" and f[2] != PATH_DEVICE)
               or (f[0] == "triage" and f[2] != "device") or f[3] != "cuda"]
        if off or not flushes:
            raise AssertionError(f"(a): {len(off)} of {len(flushes)} flushes "
                                 f"were not answered on the card: {off[:3]}")
        say("15", f"(a) every flush on the card: "
                  f"{sum(f[0] == 'validate' for f in flushes)} validate, "
                  f"{sum(f[0] == 'triage' for f in flushes)} mutate triage")
        cp.stop()

        # -- (b) bench.py's churn config
        global_slo.reset()
        cache = PolicyCache()
        for p in load_pss_policies():
            cache.set(p)
        cache.set(ClusterPolicy.from_dict(churn_policy(0)))
        h = build_handlers(cache, batching=True, batch_config=BatchConfig(
            max_batch_size=64, max_wait_ms=2.0, deadline_ms=30_000.0,
            eval_grace_s=120.0))
        h.lifecycle.start()
        pods = churn_snapshot(512, seed=13)
        t0 = time.perf_counter()
        while h.lifecycle.active is None:
            if time.perf_counter() - t0 > 300:
                raise AssertionError("(b): no compiled version in 300 s")
            time.sleep(0.05)
        h.pipeline.submit(AdmissionPayload(pods[0], "CREATE", RequestInfo(),
                                           "default"))
        stop = threading.Event()
        c_lats, served, errors = [], set(), []
        lock = threading.Lock()

        def worker(wseed):
            rng = random.Random(wseed)
            local, local_served = [], set()
            while not stop.is_set():
                payload = AdmissionPayload(rng.choice(pods), "CREATE",
                                           RequestInfo(), "default")
                t = time.perf_counter()
                try:
                    rows = h.pipeline.submit(payload)
                except Exception as e:  # noqa: BLE001 - a gate below
                    errors.append(f"{type(e).__name__}: {e}"[:300])
                    continue
                local.append(time.perf_counter() - t)
                local_served.add(getattr(rows, "revision", -1))
            with lock:
                c_lats.extend(local)
                served.update(local_served)

        def mutator():
            i = 0
            while not stop.is_set():
                i += 1
                cache.set(ClusterPolicy.from_dict(churn_policy(i)))
                stop.wait(CHURN_EVERY_S)

        threads = [threading.Thread(target=worker, args=(seed * 5000 + w,))
                   for w in range(CHURN_WORKERS)]
        mut = threading.Thread(target=mutator)
        t_churn = time.perf_counter()
        for th in threads:
            th.start()
        mut.start()
        time.sleep(CHURN_SECONDS)
        stop.set()
        for th in threads + [mut]:
            th.join()
        c_wall = time.perf_counter() - t_churn
        cst = dict(h.pipeline.stats)
        life = dict(h.lifecycle.stats)
        h.lifecycle.stop()
        h.pipeline.stop()
        h.batcher.stop()
        kerr = global_registry.kernel_errors.value() - kerr0
        if errors or kerr or life["swaps"] < 1:
            raise AssertionError(f"(b): {len(errors)} errors {errors[:3]}, "
                                 f"{kerr} kernel errors, {life['swaps']} "
                                 f"swaps")
        busy = trace.busy(t_churn)
        say("15", f"(b) churn (bench.py's config: {CHURN_WORKERS} workers, "
                  f"{CHURN_SECONDS:g} s, the churned policy re-set every "
                  f"{1e3 * CHURN_EVERY_S:g} ms, BatchConfig(64, 2.0, "
                  f"30,000, 120)) over bench.py's 512 Pods: {len(c_lats)} "
                  f"requests in {c_wall:.3f} s, {len(c_lats) / c_wall:.1f} "
                  f"requests/s; p50 {pct_ms(c_lats, 50):.3f} ms, p99 "
                  f"{pct_ms(c_lats, 99):.3f} ms; cache revisions "
                  f"{cache.revision}, swaps {life['swaps']}, compile "
                  f"failures {life['compile_failures']}, revisions served "
                  f"{len(served)}; shed {cst['shed']}, expired "
                  f"{cst['expired']}, flushes by bucket "
                  f"{cst['flushes_by_bucket']} {tag}")
        by = {}
        for t, b, k, _ in trace.firsts(t_churn):
            by[(t, b, k)] = by.get((t, b, k), 0) + 1
        say("15", f"(b) eager runs and captures during churn by (thread, "
                  f"batch, kind): {by}; {len(busy)} in all")

        # -- (c) the entry points as processes
        with socket.socket() as s1, socket.socket() as s2:
            s1.bind(("127.0.0.1", 0))
            s2.bind(("127.0.0.1", 0))
            sport, smport = s1.getsockname()[1], s2.getsockname()[1]
        pss_dir = os.path.join(HERE, "kyverno_tpu_torch", "policies", "pss")
        tmp = tempfile.mkdtemp(prefix="chip-smoke-serve-")
        res_dir = os.path.join(tmp, "resources")
        os.makedirs(res_dir)
        import yaml

        docs, _ = workload(256, seed + 3)
        with open(os.path.join(res_dir, "resources.yaml"), "w") as f:
            yaml.safe_dump_all(docs, f, sort_keys=False)
        env = dict(os.environ, PYTHONPATH=HERE)
        t0 = time.perf_counter()
        serve = subprocess.Popen(
            [sys.executable, "-m", "kyverno_tpu_torch", "serve", pss_dir,
             "--port", str(sport), "--metrics-port", str(smport),
             "--batching", "--scan-interval", "3600"],
            cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        applies = {e: subprocess.Popen(
            [sys.executable, "-m", "kyverno_tpu_torch", "apply", pss_dir,
             "--resource", res_dir, "--engine", e, "--output-json",
             "--audit-warn"], cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for e in ("tpu", "scalar")}
        try:
            ready = None
            while time.perf_counter() - t0 < 300:
                if serve.poll() is not None:
                    raise AssertionError(f"(c): serve exited "
                                         f"{serve.returncode}: "
                                         f"{serve.stdout.read()[-2000:]}")
                try:
                    code, body = http_get(smport, "/readyz")
                    if code == 200:
                        ready = json.loads(body)
                        break
                except OSError:
                    pass
                time.sleep(0.2)
            ready_s = time.perf_counter() - t0
            if not ready or not ready.get("ready"):
                raise AssertionError(f"(c): serve not ready: {ready}")
            rv = server_reviews(1, seed + 4)[0][1]
            code, out, a, b = http_post(sport, "/validate", rv)
            mcode, body = http_get(smport, "/metrics")
            if code != 200 or out["response"]["uid"] != "s0" \
                    or mcode != 200 or b"# TYPE" not in body:
                raise AssertionError(f"(c): /validate {code} {out}, "
                                     f"/metrics {mcode}")
        finally:
            serve.send_signal(signal.SIGTERM)
            try:
                rc = serve.wait(timeout=120)
            except subprocess.TimeoutExpired:
                serve.kill()
                serve.wait()
                raise AssertionError("(c): serve did not stop on SIGTERM")
        if rc != 0:
            raise AssertionError(f"(c): serve exited {rc} on SIGTERM: "
                                 f"{serve.stdout.read()[-2000:]}")
        outs = {}
        for e, p in applies.items():
            so, se = p.communicate(timeout=600)
            if p.returncode not in (0, 1):
                raise AssertionError(f"(c): apply --engine {e} exited "
                                     f"{p.returncode}: {se[-2000:]}")
            doc = json.loads(so.decode().strip().splitlines()[-1])
            outs[e] = (p.returncode, doc["summary"], {
                k: sorted((x["policy"], x["rule"], x["resource"])
                          for x in doc[k]) for k in ("failures", "warnings")})
        if outs["tpu"] != outs["scalar"]:
            raise AssertionError(f"(c): apply --engine tpu and --engine "
                                 f"scalar differ: {outs['tpu'][:2]} vs "
                                 f"{outs['scalar'][:2]}")
        say("15", f"(c) python -m kyverno_tpu_torch serve (PSS, --batching): "
                  f"ready in {ready_s:.3f} s (a process's start, the import, "
                  f"the compile and the worker's warm), one /validate "
                  f"answered in {1e3 * (b - a):.3f} ms, /metrics served, "
                  f"SIGTERM -> exit 0; apply --engine tpu and --engine "
                  f"scalar over {len(docs)} resources agree (exit "
                  f"{outs['tpu'][0]}, {outs['tpu'][1]}) {tag}")

        kerr = global_registry.kernel_errors.value() - kerr0
        tri_fb = global_registry.mutate_triage.value(
            {"outcome": "fallback"}) - tri_fb0
        if kerr or tri_fb:
            raise AssertionError(f"{kerr} kernel errors, {tri_fb} triage "
                                 f"fallbacks in the phase")
        # the flushes' dispatch paths are the flusher's; one more scan
        # through the ladder on this thread for ladder_check's
        eng.scan(workload(16, seed)[0])
        ladder_check("15")
        say("15", f"phase 15 in {time.perf_counter() - t_phase:.3f} s")
        return {"launches": launches}
    finally:
        trace.uninstall()


def analysis_json(out: str) -> dict:
    """``analyze --json``'s report less its timings."""
    doc = json.loads(out.strip().splitlines()[-1])
    doc["stats"] = {k: v for k, v in doc["stats"].items()
                    if k not in ANALYSIS_TIMINGS}
    return doc


def cli_phase(torch, kernels, tag, reports_dir):
    """Phase 16: the CLI and the background controllers. Every command
    runs as ``python -m kyverno_tpu_torch`` in a process of its own, all
    started together; ``analyze`` (on the card, no ``--device``) and
    ``test`` also run in this process. Returns the launches of the
    in-process ``analyze``."""
    import concurrent.futures
    import io
    import shutil
    import tempfile

    from kyverno_tpu_torch.cli.__main__ import main as cli_main
    from kyverno_tpu_torch.cli.chainsaw import run_tree
    from kyverno_tpu_torch.observability.metrics import global_registry as reg

    t_phase = time.perf_counter()
    ladder_reset()
    kerr0 = reg.kernel_errors.value()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    procs = {}
    try:
        # bench.py's analyze corpus: PSS plus the seeded anomalies
        corpus = os.path.join(tmp, "analyze")
        os.makedirs(corpus)
        pss = os.path.join(HERE, "kyverno_tpu_torch", "policies", "pss")
        for name in sorted(os.listdir(pss)):
            shutil.copy(os.path.join(pss, name), corpus)
        shutil.copy(os.path.join(ANALYSIS_DIR, "seeded_anomalies.yaml"),
                    corpus)
        tree = os.path.join(tmp, "chainsaw")
        scenarios = write_chainsaw_tree(tree)
        ana = ["analyze", corpus, "--json", "--tile", "256"]
        commands = {
            "analyze (card)": ana,
            "analyze --fail-on any (cpu)": ana + ["--fail-on", "any",
                                                 "--device", "cpu"],
            "analyze (cpu)": ana + ["--device", "cpu"],
            "test": ["test", "tests/cli-tests"],
            "chainsaw": ["chainsaw", tree],
            "report": ["report", reports_dir, "--rebuild-check"],
            "lint": ["lint", "--json"],
        }
        env = dict(os.environ, PYTHONPATH=HERE)
        # the plain program is thousands of small operations: one
        # thread each for the CPU runs, which share the cores
        cpu_env = dict(env, OMP_NUM_THREADS="1")
        t0 = time.perf_counter()
        for label, argv in commands.items():
            procs[label] = subprocess.Popen(
                [sys.executable, "-m", "kyverno_tpu_torch", *argv], cwd=HERE,
                env=cpu_env if "(cpu)" in label else env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def finish(p):
            out, err = p.communicate(timeout=600)
            return p.returncode, out, err, time.perf_counter() - t0

        pool = concurrent.futures.ThreadPoolExecutor(len(procs))
        waits = {label: pool.submit(finish, p) for label, p in procs.items()}
        pool.shutdown(wait=False)

        def in_process(argv):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli_main(argv)
            return rc, out.getvalue()

        # -- (a) analyze on the card, in this process, counted
        kernels.reset_launches()
        t1 = time.perf_counter()
        rc_card, out_card = in_process(ana + ["--fail-on", "any"])
        card_s = time.perf_counter() - t1
        launches = dict(kernels.LAUNCHES)
        ladder_check("16")
        # -- (b) test and (c) chainsaw, in this process
        rc_test, out_test = in_process(
            ["test", os.path.join(HERE, "tests", "cli-tests")])
        rows = run_tree(tree)

        done = {label: w.result() for label, w in waits.items()}
        for label, (rc, out, err, _) in done.items():
            if rc not in (0, 1) or (rc == 1 and not label.startswith(
                    "analyze --fail-on")):
                raise AssertionError(f"16: {label} exited {rc}: "
                                     f"{(out + err)[-2000:]}")

        card = analysis_json(out_card)
        counts = card["counts"]
        for name in DENSE_KERNELS:
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"16: analyze on the card never "
                                     f"launched {name}: {launches}")
        want = {"in-process, --fail-on any": (
                    (rc_card, card), done["analyze --fail-on any (cpu)"]),
                "process": (
                    (done["analyze (card)"][0],
                     analysis_json(done["analyze (card)"][1])),
                    done["analyze (cpu)"])}
        for what, (got, cpu) in want.items():
            if got != (cpu[0], analysis_json(cpu[1])):
                raise AssertionError(f"16 (a): analyze on the card "
                                     f"({what}) differs from --device cpu: "
                                     f"exit {got[0]} vs {cpu[0]}, counts "
                                     f"{got[1]['counts']} vs "
                                     f"{analysis_json(cpu[1])['counts']}")
        if rc_card != 1 or done["analyze (card)"][0] != 0 \
                or any(counts[k] < 1 for k in counts):
            raise AssertionError(f"16 (a): exits {rc_card} / "
                                 f"{done['analyze (card)'][0]}, counts "
                                 f"{counts}")
        st = card["stats"]
        say("16", f"(a) analyze on the card (PSS + seeded anomalies, tile "
                  f"256): {card_s:.3f} s in this process (the compile, the "
                  f"eager runs and captures included), witnesses "
                  f"{st['witnesses']}, tiles {st['device_dispatches']}, "
                  f"anomalies {counts}, exit {rc_card} with --fail-on any; "
                  f"the process (no --device) exit "
                  f"{done['analyze (card)'][0]} in "
                  f"{done['analyze (card)'][3]:.3f} s; both equal --device "
                  f"cpu's report and exit ({done['analyze (cpu)'][3]:.3f} s, "
                  f"{done['analyze --fail-on any (cpu)'][3]:.3f} s); "
                  f"launches {({k: v for k, v in launches.items() if v})} "
                  f"{tag}")
        # -- (b) test
        rc, out, _, s = done["test"]
        if rc != 0 or rc_test != 0 or out != out_test \
                or "0 failed" not in out:
            raise AssertionError(f"16 (b): test exited {rc} (in-process "
                                 f"{rc_test}): {out[-1000:]}")
        say("16", f"(b) test tests/cli-tests: exit 0 in {s:.3f} s, "
                  f"{out.strip().splitlines()[-1]!r}, output equal to the "
                  f"in-process run's")
        # -- (c) chainsaw
        rc, out, _, s = done["chainsaw"]
        want_lines = [f"PASS  {rel}" for rel in scenarios]
        if rc != 0 or out.splitlines() != want_lines \
                or rows != [(rel, "pass", "") for rel in scenarios]:
            raise AssertionError(f"16 (c): chainsaw exited {rc}: {out} "
                                 f"(in-process rows {rows})")
        say("16", f"(c) chainsaw: {len(scenarios)} scenarios "
                  f"({', '.join(scenarios)}) pass, in the process (exit 0, "
                  f"{s:.3f} s) and in this one")
        # -- (d) report and lint
        rc, out, _, s = done["report"]
        if rc != 0 or "rebuild-check: identical" not in out:
            raise AssertionError(f"16 (d): report --rebuild-check exited "
                                 f"{rc}: {out[-1000:]}")
        say("16", f"(d) report {os.path.basename(reports_dir)} (phase 12's "
                  f"journal directory) --rebuild-check: exit 0 in {s:.3f} s; "
                  f"{out.splitlines()[0]}")
        rc, out, _, s = done["lint"]
        doc = json.loads(out)
        if rc != 0 or doc["findings"] or doc["exit"] != 0 \
                or not all(f.get("baseline_reason")
                           for f in doc["baselined"]):
            raise AssertionError(f"16 (d): lint exited {rc}: "
                                 f"{doc['findings'][:5]}")
        say("16", f"(d) lint --json: exit 0 in {s:.3f} s, no finding, "
                  f"{len(doc['baselined'])} baselined (each with its reason, "
                  f"kyverno_tpu_torch/devtools/lint_baseline.json)")
        kerr = reg.kernel_errors.value() - kerr0
        if kerr:
            raise AssertionError(f"{kerr} kernel errors in the phase")
        say("16", f"phase 16 in {time.perf_counter() - t_phase:.3f} s")
        return {"launches": launches}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 17: the mesh across processes (parallel/sharding.py on
# torch.distributed) and serve --distributed

XPROC_SERVE_N = 1024  # (b)'s snapshot upserts
XPROC_CHILD_S = 300  # each child's hard limit, seconds


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def xproc_rank(argv) -> int:
    """Phase 17 (a)'s rank: ``python3 chip_smoke.py xproc-rank DIR
    SCAN_N TILE SEED`` with ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` set. Joins the gloo world, builds
    ``ShardedScanner(PSS, mesh=make_mesh_2d(2, 1))`` (this rank's row:
    its CUDA device) and scans phase 14's snapshot
    (``workload(SCAN_N, SEED)``): ``scan_stream`` cold, then warm with
    the launches counted from 0, ``scan`` of the first tile and its
    ``scan_device``. Writes the tables and counts to ``DIR/rankR.npz``
    and its launches and times to ``DIR/rankR.json``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from kyverno_tpu_torch import kernels
    from kyverno_tpu_torch.observability.metrics import global_registry as reg
    from kyverno_tpu_torch.parallel.sharding import (ShardedScanner,
                                                     make_mesh_2d)
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.policy.autogen import expand_policy
    from kyverno_tpu_torch.tpu import cache as tcache

    out, scan_n, tile, seed = (argv[0], int(argv[1]), int(argv[2]),
                               int(argv[3]))
    rank = int(os.environ["RANK"])
    t0 = time.perf_counter()
    dist.init_process_group(
        "gloo", init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                             f"{os.environ['MASTER_PORT']}"),
        world_size=int(os.environ["WORLD_SIZE"]), rank=rank,
        timeout=datetime.timedelta(seconds=120))
    kernels.build_all()
    tcache.configure(0, 0)
    mesh = make_mesh_2d(2, 1, timeout_s=120)
    sc = ShardedScanner([expand_policy(p) for p in load_pss_policies()],
                        mesh=mesh)
    resources, ops = workload(scan_n, seed)
    info = {"mesh": repr(mesh), "local": mesh.local,
            "setup_s": time.perf_counter() - t0}
    arrays = {}
    ladder_reset()
    t0 = time.perf_counter()
    res, _ = sc.scan_stream(resources, tile=tile, operations=ops)
    info["cold_s"] = time.perf_counter() - t0
    arrays["cold"] = res.verdicts
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, st = sc.scan_stream(resources, tile=tile, operations=ops)
    info["warm_s"] = time.perf_counter() - t0
    info["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    info["stats"] = {k: st[k] for k in ("encode_s", "device_s", "host_s",
                                        "tiles", "tile")}
    arrays["warm"] = res.verdicts
    arrays["scan"] = sc.scan(resources[:tile], operations=ops[:tile]).verdicts
    arrays["device_v"], arrays["device_c"] = sc.scan_device(
        resources[:tile], operations=ops[:tile])
    info["fallbacks"] = {r: reg.breaker_fallback.value({"reason": r})
                         for r in ("error", "open", "mesh_peer")}
    info["kernel_errors"] = reg.kernel_errors.value()
    info["failed"] = mesh.failed
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    print(f"rank {rank}: launches of the warm scan_stream "
          + json.dumps(info["launches"]), flush=True)
    dist.destroy_process_group()
    return 0


def _serve_events(path):
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass  # a line being written
    return out


def xproc_phase(torch, kernels, scanner, policies, scan_n, tile, seed, tag):
    """Phase 17: (a) two rank processes scan phase 14's snapshot (all
    ``scan_n`` resources) on ``make_mesh_2d(2, 1)`` across them (``xproc_rank``),
    each table and the counts equal to this process's one-device scan;
    (b) two ``serve --distributed`` ranks and a single ``serve`` over
    the same snapshot, their ``/scan`` summaries equal. All five
    processes start together. Returns the warm scan's launches summed
    over the ranks."""
    import concurrent.futures
    import shutil
    import tempfile

    import numpy as np

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-xproc-")
    procs = {}
    try:
        env = dict(os.environ, PYTHONPATH=HERE, MASTER_ADDR="127.0.0.1",
                   WORLD_SIZE="2")
        a_port, b_port = _free_port(), _free_port()
        # each child's output goes to a file of its own (a pipe nobody
        # reads could fill and stall it)
        outs = {}

        def output(label):
            outs[label] = os.path.join(tmp, label.replace(" ", "_") + ".out")
            return open(outs[label], "w")

        def tail(label):
            with open(outs[label]) as f:
                return f.read()[-3000:]

        for r in (0, 1):
            with output(f"rank {r}") as f:
                procs[f"rank {r}"] = subprocess.Popen(
                    [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                     "xproc-rank", tmp, str(scan_n), str(tile),
                     str(seed)], cwd=HERE,
                    env=dict(env, MASTER_PORT=str(a_port), RANK=str(r)),
                    stdout=f, stderr=subprocess.STDOUT)
        pfile = os.path.join(tmp, "pss.yaml")
        pss = os.path.join(HERE, "kyverno_tpu_torch", "policies", "pss")
        with open(pfile, "w") as f:
            f.write("\n---\n".join(
                open(os.path.join(pss, name)).read().strip()
                for name in sorted(os.listdir(pss))) + "\n")
        logs = {}
        for label in ("serve rank 0", "serve rank 1", "serve"):
            logs[label] = os.path.join(tmp, label.replace(" ", "_") + ".jsonl")
            argv = [sys.executable, "-m", "kyverno_tpu_torch", "serve", pfile,
                    "--port", "0", "--metrics-port", "0", "--scan-interval",
                    "3600", "--no-reports", "--no-columnar", "--log-file",
                    logs[label]]
            penv = dict(os.environ, PYTHONPATH=HERE)
            if label != "serve":
                argv.append("--distributed")
                penv = dict(env, MASTER_PORT=str(b_port), RANK=label[-1])
            with output(label) as f:
                procs[label] = subprocess.Popen(
                    argv, cwd=HERE, env=penv, stdout=f,
                    stderr=subprocess.STDOUT)

        # (a)'s reference meanwhile: this process's one-device scanner
        resources, ops = workload(scan_n, seed)
        say("17", f"(a) all {scan_n} of phase 14's resources (no cut), "
                  f"tile {tile}; (b) {XPROC_SERVE_N} upserts")
        ladder_reset()
        one, _ = scanner.scan_stream(resources, tile=tile, operations=ops)
        one_scan = scanner.scan(resources[:tile], operations=ops[:tile])
        one_v, one_c = scanner.scan_device(resources[:tile],
                                           operations=ops[:tile])
        ladder_check("17")

        # (b): wait for the three servers, upsert, scan
        deadline = time.monotonic() + XPROC_CHILD_S
        started = {}
        while len(started) < 3:
            for label in logs:
                if procs[label].poll() is not None:
                    raise AssertionError(f"17 (b): {label} exited "
                                         f"{procs[label].returncode}: "
                                         f"{tail(label)}")
                for e in _serve_events(logs[label]):
                    if e.get("event") == "serve_started":
                        started[label] = e["metrics_port"]
            if time.monotonic() > deadline:
                raise AssertionError("17 (b): the servers did not start "
                                     f"within {XPROC_CHILD_S} s")
            time.sleep(0.2)
        for r in (0, 1):
            init = [e for e in _serve_events(logs[f"serve rank {r}"])
                    if e.get("event", "").startswith("distributed_")]
            if [(e["event"], e.get("hosts"), e.get("per_host"))
                    for e in init] != [("distributed_initialized", 2, 1)]:
                raise AssertionError(f"17 (b): serve rank {r} logged {init}")
        say("17", "(b) both serve --distributed ranks logged "
                  "distributed_initialized hosts=2 per_host=1")
        docs = workload(XPROC_SERVE_N, seed + 1)[0]

        def upsert(label):
            for d in docs:
                st, body, _, _ = http_post(started[label],
                                           "/snapshot/upsert", d)
                if st != 200:
                    raise AssertionError(f"17 (b): {label} upsert {st}")

        def scan(label):
            st, body, t0, t1 = http_post(started[label], "/scan", {})
            if st != 200:
                raise AssertionError(f"17 (b): {label} /scan {st}: {body}")
            return body, t1 - t0

        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            list(pool.map(upsert, started))
            ranks = list(pool.map(scan, ("serve rank 0", "serve rank 1")))
            single = scan("serve")
        for r, (body, s) in enumerate(ranks):
            if (body["scanned"], body["summary"]) != (single[0]["scanned"],
                                                     single[0]["summary"]):
                raise AssertionError(f"17 (b): serve rank {r}'s scan "
                                     f"{body} differs from the single "
                                     f"serve's {single[0]}")
        say("17", f"(b) /scan on both ranks at once: {ranks[0][0]['scanned']}"
                  f" resources, {ranks[0][1]:.3f} s / {ranks[1][1]:.3f} s; "
                  f"the single serve {single[1]:.3f} s; each summary "
                  f"{ranks[0][0]['summary']} equal to the single serve's "
                  f"{tag}")

        # (a): the ranks' tables, counts and launches
        for r in (0, 1):
            p = procs[f"rank {r}"]
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"17 (a): rank {r} did not finish "
                                     f"within {XPROC_CHILD_S} s")
            if p.returncode != 0:
                raise AssertionError(f"17 (a): rank {r} exited "
                                     f"{p.returncode}: {tail(f'rank {r}')}")
        launches = {}
        for r in (0, 1):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                info = json.load(f)
            got = np.load(os.path.join(tmp, f"rank{r}.npz"))
            for what, want in (("cold", one.verdicts), ("warm", one.verdicts),
                               ("scan", one_scan.verdicts),
                               ("device_v", one_v), ("device_c", one_c)):
                if got[what].dtype != want.dtype \
                        or not np.array_equal(got[what], want):
                    raise AssertionError(f"17 (a): rank {r}'s {what} "
                                         "differs from one process's")
            if any(info["fallbacks"].values()) or info["kernel_errors"] \
                    or info["failed"]:
                raise AssertionError(f"17 (a): rank {r}: fallbacks "
                                     f"{info['fallbacks']}, kernel errors "
                                     f"{info['kernel_errors']}, mesh "
                                     f"{info['failed']}")
            missing = [k for k in SCAN_KERNELS if not info["launches"].get(k)]
            if missing:
                raise AssertionError(f"17 (a): {missing} never launched on "
                                     f"rank {r}")
            for k, v in info["launches"].items():
                launches[k] = launches.get(k, 0) + v
            say("17", f"(a) rank {r} {info['mesh']}: setup "
                      f"{info['setup_s']:.3f} s, scan_stream cold "
                      f"{info['cold_s']:.3f} s, warm {info['warm_s']:.3f} s "
                      f"({scan_n / info['warm_s']:.1f} resources/s; stats "
                      f"{json.dumps(info['stats'])}); tables and counts "
                      f"equal to one process's; launches of the warm scan "
                      f"{json.dumps(info['launches'])} {tag}")
        say("17", f"phase 17 in {time.perf_counter() - t_phase:.3f} s {tag}")
        return {"launches": launches}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        for p in procs.values():
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


# phase 16 (c): the chainsaw scenarios the phase writes. Each is
# {file name: documents} and its steps, in the chainsaw Test schema the
# runner (cli/chainsaw.py) replays; every one must report pass.
DENIED = [{"check": {"($error != null)": True}}]


def _ns(name, labels=None):
    meta = {"name": name}
    if labels:
        meta["labels"] = labels
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": meta}


def _cpol(name, rules, **spec):
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name}, "spec": {**spec, "rules": rules}}


def _ready(kind, name):
    return {"apiVersion": "kyverno.io/v1", "kind": kind,
            "metadata": {"name": name},
            "status": {"conditions": [{"reason": "Succeeded",
                                       "status": "True", "type": "Ready"}]}}


def _pod(name, ns="default", labels=None, privileged=None):
    c = {"name": "c", "image": "nginx:1.25"}
    if privileged is not None:
        c["securityContext"] = {"privileged": privileged}
    meta = {"name": name, "namespace": ns}
    if labels:
        meta["labels"] = labels
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"containers": [c]}}


CHAINSAW_SCENARIOS = {
    "generate/data-sync": ({
        "policy.yaml": [_cpol("gen-netpol", [{
            "name": "default-deny",
            "match": {"any": [{"resources": {"kinds": ["Namespace"]}}]},
            "generate": {
                "apiVersion": "networking.k8s.io/v1",
                "kind": "NetworkPolicy", "name": "default-deny",
                "namespace": "{{request.object.metadata.name}}",
                "synchronize": True,
                "data": {"spec": {"podSelector": {},
                                  "policyTypes": ["Ingress"]}}}}])],
        "policy-assert.yaml": [_ready("ClusterPolicy", "gen-netpol")],
        "namespace.yaml": [_ns("gen-ns")],
        "netpol.yaml": [{"apiVersion": "networking.k8s.io/v1",
                         "kind": "NetworkPolicy",
                         "metadata": {"name": "default-deny",
                                      "namespace": "gen-ns"},
                         "spec": {"policyTypes": ["Ingress"]}}],
    }, [
        [{"apply": {"file": "policy.yaml"}},
         {"assert": {"file": "policy-assert.yaml"}}],
        [{"apply": {"file": "namespace.yaml"}},
         {"assert": {"file": "netpol.yaml"}}],
        [{"delete": {"ref": {"apiVersion": "v1", "kind": "Namespace",
                             "name": "gen-ns"}}},
         {"error": {"file": "netpol.yaml"}}],
    ]),
    "generate/clone": ({
        "source.yaml": [{"apiVersion": "v1", "kind": "Secret",
                         "metadata": {"name": "regcred",
                                      "namespace": "default"},
                         "type": "Opaque", "data": {"token": "c2VjcmV0"}}],
        "policy.yaml": [_cpol("clone-regcred", [{
            "name": "clone",
            "match": {"any": [{"resources": {"kinds": ["Namespace"]}}]},
            "generate": {
                "apiVersion": "v1", "kind": "Secret", "name": "regcred",
                "namespace": "{{request.object.metadata.name}}",
                "synchronize": True,
                "clone": {"namespace": "default", "name": "regcred"}}}])],
        "policy-assert.yaml": [_ready("ClusterPolicy", "clone-regcred")],
        "namespace.yaml": [_ns("clone-ns")],
        "cloned.yaml": [{"apiVersion": "v1", "kind": "Secret",
                         "metadata": {"name": "regcred",
                                      "namespace": "clone-ns"},
                         "data": {"token": "c2VjcmV0"}}],
    }, [
        [{"apply": {"file": "source.yaml"}},
         {"apply": {"file": "policy.yaml"}},
         {"assert": {"file": "policy-assert.yaml"}}],
        [{"apply": {"file": "namespace.yaml"}},
         {"assert": {"file": "cloned.yaml"}}],
    ]),
    "mutate-existing/label-secrets": ({
        "setup.yaml": [_ns("mx"),
                       {"apiVersion": "v1", "kind": "Secret",
                        "metadata": {"name": "s1", "namespace": "mx"},
                        "data": {"k": "dg=="}}],
        "policy.yaml": [_cpol("label-secrets", [{
            "name": "mark",
            "match": {"any": [{"resources": {
                "kinds": ["ConfigMap"], "names": ["trigger"]}}]},
            "mutate": {
                "targets": [{"apiVersion": "v1", "kind": "Secret",
                             "namespace": "{{request.object.metadata.namespace}}"}],
                "patchStrategicMerge": {"metadata": {"labels": {
                    "audited": "true"}}}}}])],
        "policy-assert.yaml": [_ready("ClusterPolicy", "label-secrets")],
        "trigger.yaml": [{"apiVersion": "v1", "kind": "ConfigMap",
                          "metadata": {"name": "trigger", "namespace": "mx"},
                          "data": {"go": "1"}}],
        "secret-assert.yaml": [{"apiVersion": "v1", "kind": "Secret",
                                "metadata": {"name": "s1", "namespace": "mx",
                                             "labels": {"audited": "true"}}}],
    }, [
        [{"apply": {"file": "setup.yaml"}},
         {"apply": {"file": "policy.yaml"}},
         {"assert": {"file": "policy-assert.yaml"}}],
        [{"apply": {"file": "trigger.yaml"}},
         {"assert": {"file": "secret-assert.yaml"}}],
    ]),
    "cleanup/scheduled": ({
        "pods.yaml": [_pod("sweep-me", labels={"cleanup": "yes"}),
                      _pod("keep-me", labels={"cleanup": "no"})],
        "cleanup-policy.yaml": [{
            "apiVersion": "kyverno.io/v2beta1",
            "kind": "ClusterCleanupPolicy",
            "metadata": {"name": "sweep-labelled"},
            "spec": {"schedule": "*/1 * * * *",
                     "match": {"any": [{"resources": {
                         "kinds": ["Pod"], "selector": {
                             "matchLabels": {"cleanup": "yes"}}}}]}}}],
        "cleanup-assert.yaml": [{"apiVersion": "kyverno.io/v2beta1",
                                 "kind": "ClusterCleanupPolicy",
                                 "metadata": {"name": "sweep-labelled"}}],
        "swept.yaml": [{"apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": "sweep-me",
                                     "namespace": "default"}}],
        "kept.yaml": [{"apiVersion": "v1", "kind": "Pod",
                       "metadata": {"name": "keep-me",
                                    "namespace": "default"}}],
    }, [
        [{"apply": {"file": "pods.yaml"}},
         {"apply": {"file": "cleanup-policy.yaml"}},
         {"assert": {"file": "cleanup-assert.yaml"}}],
        [{"error": {"file": "swept.yaml"}},
         {"assert": {"file": "kept.yaml"}}],
    ]),
    "validate/enforce-denial": ({
        "policy.yaml": [_cpol("no-privileged", [{
            "name": "privileged",
            "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
            "validate": {"message": "privileged containers are forbidden",
                         "pattern": {"spec": {"containers": [{
                             "=(securityContext)": {
                                 "=(privileged)": "false"}}]}}}}],
            validationFailureAction="Enforce", background=True)],
        "policy-assert.yaml": [_ready("ClusterPolicy", "no-privileged")],
        "bad-pod.yaml": [_pod("bad", privileged=True)],
        "good-pod.yaml": [_pod("good", privileged=False)],
    }, [
        [{"apply": {"file": "policy.yaml"}},
         {"assert": {"file": "policy-assert.yaml"}}],
        [{"apply": {"file": "bad-pod.yaml", "expect": DENIED}},
         {"error": {"file": "bad-pod.yaml"}}],
        [{"apply": {"file": "good-pod.yaml"}},
         {"assert": {"file": "good-pod.yaml"}}],
    ]),
}


def write_chainsaw_tree(root: str) -> list:
    """Writes ``CHAINSAW_SCENARIOS`` under ``root`` (one directory a
    scenario: its files and its ``chainsaw-test.yaml``); returns the
    scenario directories relative to ``root``, sorted."""
    import yaml

    for rel, (files, steps) in CHAINSAW_SCENARIOS.items():
        d = os.path.join(root, rel)
        os.makedirs(d, exist_ok=True)
        for name, docs in files.items():
            with open(os.path.join(d, name), "w") as f:
                yaml.safe_dump_all(docs, f, sort_keys=False)
        test = {"apiVersion": "chainsaw.kyverno.io/v1alpha1", "kind": "Test",
                "metadata": {"name": rel.replace("/", "-")},
                "spec": {"steps": [{"name": f"step-{i}", "try": ops}
                                   for i, ops in enumerate(steps)]}}
        with open(os.path.join(d, "chainsaw-test.yaml"), "w") as f:
            yaml.safe_dump(test, f, sort_keys=False)
    return sorted(CHAINSAW_SCENARIOS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--n", type=int, default=16384,
                    help="resources in the dense-path scan")
    ap.add_argument("--scan-n", type=int, default=50000,
                    help="resources in the background scan's snapshot")
    ap.add_argument("--tile", type=int, default=8192,
                    help="resources per background-scan tile")
    ap.add_argument("--tenant-n", type=int, default=16384,
                    help="resources in the tenant scan and triage")
    ap.add_argument("--tenant-batch", type=int, default=1024,
                    help="resources per tenant triage batch")
    ap.add_argument("--mutate-n", type=int, default=4000,
                    help="Pods in the mutate leg (bench.py bench_mutate)")
    ap.add_argument("--mutate-tile", type=int, default=1024,
                    help="Pods per mutate-leg triage tile")
    ap.add_argument("--adm-requests", type=int, default=20000,
                    help="requests in phase 11's steady admission")
    ap.add_argument("--adm-bulk", type=int, default=10000,
                    help="bulk requests in phase 11's mixed traffic")
    ap.add_argument("--reports-n", type=int, default=40000,
                    help="lean Pods in phase 12's soak (bench.py's "
                         "1,000,000 cut for the time limit)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from kyverno_tpu_torch import kernels
        from kyverno_tpu_torch.parallel.sharding import ShardedScanner
        from kyverno_tpu_torch.policies import load_pss_policies
        from kyverno_tpu_torch.policy.autogen import expand_policy
        from kyverno_tpu_torch.tpu import dfa as dfa_mod
        from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device
    except ImportError as e:
        print(f"chip_smoke: the kyverno_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 3

    # phases 3-9 time the device, not cache hits: both content caches
    # off and no columnar store until phase 10
    from kyverno_tpu_torch.cluster.columnar import reset_store
    from kyverno_tpu_torch.tpu import cache as tcache

    cache_caps = (tcache.global_verdict_cache._lru.capacity,
                  tcache.global_encode_cache._lru.capacity)
    tcache.configure(0, 0)
    reset_store()

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    say("1", f"torch {torch.__version__} cuda {torch.version.cuda}, "
             f"device 0 {torch.cuda.get_device_name(0)}, "
             f"{torch.cuda.device_count()} visible")
    tag = f"({card})"

    # phase 2: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    libs = kernels.build_all()
    say("2", f"built {len(libs)} kernel libraries in "
             f"{time.perf_counter() - t0:.3f} s {tag}: "
             + ", ".join(os.path.basename(p) for p in libs.values()))
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                say("2", f"{name}.cu ptxas: {line.strip()}")

    # the workloads and their encoded lanes (kernel shapes of both paths)
    policies = [expand_policy(p) for p in load_pss_policies()]
    t0 = time.perf_counter()
    eng = TorchEngine(policies)
    # the one-device scanner (phase 14 holds each mesh to it)
    scanner = ShardedScanner(policies, device="cuda")
    say("4", f"compiled {len(policies)} PSS policies twice (engine, "
             f"scanner): coverage {eng.coverage()} in "
             f"{time.perf_counter() - t0:.3f} s {tag}")
    resources, ops = workload(args.n, args.seed)
    padded, pops, _ = eng.pad(resources, ops)
    batch = eng.encode(padded, None, pops)[0]
    lanes = lanes_to_device(batch, eng.device)
    tile_res, tile_ops = workload(args.tile, args.seed + 4)
    tile_host, _ = scanner.encode(tile_res, None, tile_ops)
    tile_lanes = scanner.put(tile_host)[0]
    # the tenant set: PSS plus a policy whose namespace globs overflow
    # the DFA bank
    t0 = time.perf_counter()
    tenant = TorchEngine(policies + [expand_policy(tenant_policy())])
    tenant_compile_s = time.perf_counter() - t0
    in_bank = [g for g in TENANT_GLOBS if g in tenant.cps.dfa.glob_ids]
    nfa = [g for g in TENANT_GLOBS if g not in tenant.cps.dfa.glob_ids]
    say("7", f"compiled PSS + tenant ({len(TENANT_GLOBS)} namespace globs) in "
             f"{tenant_compile_s:.3f} s {tag}: {len(tenant.cps.dfa.patterns)} "
             f"bank patterns, {sum(p.n_states for p in tenant.cps.dfa.patterns)}"
             f" states; tenant globs {len(in_bank)} in the bank, {len(nfa)} on "
             f"the NFA route ({sum('?' in g for g in nfa)} with '?'); coverage "
             f"{tenant.coverage()}, mutate {tenant.mutate_coverage()}")
    if (len(in_bank), len(nfa)) != TENANT_SPLIT or len(nfa) < 200:
        raise AssertionError(f"tenant bank split {(len(in_bank), len(nfa))}, "
                             f"want {TENANT_SPLIT}")
    tenant_res = tenant_workload(args.tenant_n, args.seed + 20, in_bank, nfa)
    tpadded, _, _ = tenant.pad(tenant_res)
    tenant_lanes = lanes_to_device(tenant.encode(tpadded)[0], tenant.device)
    torch.cuda.synchronize()

    phase_s = PhaseClock()
    phase_s.mark("3")
    # phase 3: every kernel against its plain twin on the card
    results = {}
    check_dfa(torch, kernels, dfa_mod, lanes["pool"], lanes["pool_len"],
              args.seed + 1, results)
    check_instance_count(torch, kernels, lanes, eng.cps.encode_cfg.max_instances,
                         args.seed + 2, results)
    check_verdict_counts(torch, kernels, eng.device, len(eng.cps.device_programs),
                         len(padded), args.seed + 3, results, tag)
    check_row_fold(torch, kernels, lanes, args.seed + 7, results)
    check_vocab_kernels(torch, kernels, dfa_mod, scanner, tile_lanes,
                        args.seed + 5, results, tag)
    check_glob_nfa(torch, kernels, tenant_lanes, nfa, args.seed + 6, results)
    check_dfa_tenant(torch, kernels, dfa_mod, tenant.cps.dfa, tenant_lanes,
                     results)
    check_meta_any(torch, kernels, tenant, tenant_res, tenant_lanes,
                   args.tenant_batch, results)
    del lanes, tile_lanes, tenant_lanes

    phase_s.mark("4")
    # phase 4: the dense path through the user's entry point
    dense, g_dense = dense_phase(torch, kernels, eng, policies, resources,
                                 ops, padded, pops, args.n, tag, results)
    phase_s.mark("5")
    # phase 5: the background scan through the user's entry point
    scan, g_step, feed = scan_phase(torch, kernels, scanner, policies,
                                    args.scan_n, args.tile, args.seed + 10,
                                    tag)
    phase_s.mark("7")
    # phase 7: the tenant set's scan and triage
    tv, tt, g_tv, g_tt = tenant_phase(torch, kernels, tenant, tenant_res,
                                      args.tenant_batch, tenant_compile_s,
                                      tag)
    phase_s.mark("8")
    # phase 8: bench.py's mutate leg
    leg, g_leg = mutate_leg_phase(torch, kernels, args.mutate_n,
                                  args.mutate_tile, tag)
    phase_s.mark("9")
    # phase 9: the guarded dispatch ladder under faults
    fault_phase(torch, kernels, eng, scanner, tenant, resources, ops,
                tenant_res, tag)
    phase_s.mark("10")
    # phase 10: the pipelined background scan, the encoder pool and the
    # caches (the only phase that turns them on)
    pipeline_phase(torch, kernels, scanner, eng, feed, resources, ops,
                   args.tile, cache_caps, tenant,
                   tenant_res[:args.tenant_batch], tag)
    phase_s.mark("11")
    # phase 11: admission serving on the card
    adm = admission_phase(torch, kernels, args.seed + 30, tag,
                          n_requests=args.adm_requests, n_bulk=args.adm_bulk)
    phase_s.mark("12")
    # phase 12: incremental reports and the background scan service
    rep = reports_phase(torch, kernels, tag, args.reports_n, cache_caps,
                        args.seed + 40)
    phase_s.mark("13")
    # phase 13: policy-set analysis, and the lifecycle's lint under traffic
    ana = analysis_phase(torch, kernels, tag, args.seed + 50, cache_caps)
    phase_s.mark("14")
    # phase 14: the sharded scan on a mesh of CUDA devices, the dry run,
    # two fleet replicas behind the scan service
    mesh_launches, mesh_by_device = mesh_phase(
        torch, kernels, scanner, policies, feed, args.tile, tag)
    del feed
    phase_s.mark("15")
    # phase 15: the admission webhook server and its entry points
    srv = server_phase(torch, kernels, args.seed + 60, tag)
    phase_s.mark("16")
    # phase 16: the CLI and the background controllers
    cli = cli_phase(torch, kernels, tag, rep["dir"])
    phase_s.mark("17")
    # phase 17: the mesh across processes and serve --distributed
    xproc = xproc_phase(torch, kernels, scanner, policies, args.scan_n,
                        args.tile, args.seed + 10, tag)
    phase_s.mark(None)
    # each path's graph_check, and each admission bucket's
    b = ADMISSION_BUCKETS[-1]
    gpaths = list(zip(PATHS, (g_dense, g_step, g_tv, g_tt, g_leg))) + [
        (f"admission_{b}", adm["flush"][b]["graph"])]
    for path, gr in gpaths:
        say("6", f"graphs {path}: eager {gr['eager_ms']:.3f} ms, replay "
                 f"{gr['replay_ms']:.3f} ms, captures {gr['captures']}, aten "
                 f"operations {gr['ops_eager']} eager / {gr['ops_replay']} "
                 f"replayed, {gr['replay_events']} device events a replay "
                 f"({gr['replay_device_ms']:.3f} ms), K11 launches "
                 f"{gr['fold_checked']} (checked), fold_forced "
                 f"{gr['fold_forced']}, K12 launches {gr['rows_checked']} "
                 f"(checked, {gr['row_splits']} splits), rows_forced "
                 f"{gr['rows_forced']}, K6 launches "
                 f"{gr['k6_launches']}, torch reductions over rows "
                 f"{gr['row_reductions']}, bound {gr['bound_ms']:.4f} ms "
                 f"({gr['io_bytes']} bytes) {tag}")

    # phase 6: the kernels line, then the device line
    by_path = dict(zip(PATHS, (dense, scan, tv, tt, leg)))
    by_path["admission"] = adm["launches"]
    by_path["reports_tick"] = rep["launches"]
    by_path["analysis_tile"] = ana["launches"]
    by_path["mesh_scan"] = mesh_launches
    by_path["server"] = srv["launches"]
    by_path["analyze_cli"] = cli["launches"]
    by_path["xproc"] = xproc["launches"]
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        r = results[name]
        b_ms, b_by = r["bound"]
        per = {p: launches.get(name, 0) for p, launches in by_path.items()}
        n_launch = sum(per.values())
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": n_launch,
                    "launches_by_path": per,
                    "mesh_launches_by_device": {
                        d: launches.get(name, 0)
                        for d, launches in mesh_by_device.items()},
                    "admission_flush": {
                        str(b): {"launches": f["launches"].get(name, 0),
                                 "trace_ms": f["trace_ms"].get(name)}
                        for b, f in adm["flush"].items()},
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": r["library_ms"]})
        lib = r["library_ms"]
        say("6", f"{name}: {r['ms']:.4f} ms (graph replay; eager "
                 f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                 f"bound {b_ms:.4f} ms ({b_by}), library "
                 f"{'none' if lib is None else f'{lib:.4f} ms'}, launches "
                 + ", ".join(f"{p} {k}" for p, k in per.items()) + f" {tag}")
        if name in NOT_ON_A_PATH:
            if n_launch:
                raise AssertionError(f"{name} launched on a path: {per}")
        elif n_launch <= 0:
            raise AssertionError(f"{name} was launched on no path")
    # K1 at the tenant bank's shapes, beside the rows above
    by_name = {e["name"]: e for e in out}
    for path, gr in gpaths:
        r = gr["k11"]
        b_ms, b_by = r["bound"]
        # the largest error any path's launches measured
        e = by_name["class_fold"]
        e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])
        by_name["class_fold"].setdefault("paths", []).append(
            {"path": path, "launches_timed": r["launches"]}
            | {k: r[k] for k in ("ms", "eager_ms", "plain_ms", "bytes",
                                 "ops", "instructions", "g_chosen", "g_ms",
                                 "g_other")}
            | {"bound_ms": b_ms, "bound_by": b_by})
        say("6", f"class_fold {path}: {r['launches']} launches of one run "
                 f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f} ms), plain "
                 f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
                 f"{tag}")
    for path, gr in gpaths:
        r = gr["k12"]
        b_ms, b_by = r["bound"]
        e = by_name["row_fold"]
        if r["launches"]:
            e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])
        by_name["row_fold"].setdefault("paths", []).append(
            {"path": path, "launches_timed": r["launches"],
             "row_splits": gr["row_splits"],
             "rows_forced": gr["rows_forced"], "k6_launches": gr["k6_launches"],
             "row_reductions": gr["row_reductions"],
             "replay_events": gr["replay_events"]}
            | {k: r[k] for k in ("ms", "eager_ms", "plain_ms", "bytes", "ops",
                                 "instructions")}
            | {"bound_ms": b_ms, "bound_by": b_by})
        if not r["launches"]:
            say("6", f"row_fold {path}: no launch; rows_forced "
                     f"{gr['rows_forced']} {tag}")
            continue
        say("6", f"row_fold {path}: {r['launches']} launches of one run "
                 f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f} ms), plain "
                 f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                 f"rows_forced {gr['rows_forced']} {tag}")
    for path, gr in gpaths:
        r = gr["k7"]
        if not r["launches"]:
            continue
        b_ms, b_by = r["bound"]
        by_name["pool_rows"].setdefault("paths", []).append(
            {"path": path, "launches_timed": r["launches"],
             "shapes": r["shapes"]}
            | {k: r[k] for k in ("ms", "eager_ms", "plain_ms", "library_ms",
                                 "bytes", "max_abs_err", "rotated_ms",
                                 "rotated_bytes", "rotated_bound_ms",
                                 "trace_ms")}
            | {"bound_ms": b_ms, "bound_by": b_by})
        say("6", f"pool_rows {path}: {r['launches']} launches of one run "
                 f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f} ms), bound "
                 f"{b_ms:.4f} ms ({b_by}, distinct lanes); rotated copies "
                 f"{r['rotated_ms']:.4f} ms, bound "
                 f"{r['rotated_bound_ms']:.4f} ms; replay trace "
                 f"{r['trace_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms, "
                 f"torch.gather {r['library_ms']:.4f} ms {tag}")
    for name in KEPT:
        e = by_name[name]
        e.update({k: results[name][k] for k in ("rotated_ms", "floor_ms",
                                                 "form", "shape")})
        for path, gr in gpaths:
            r = gr[name]
            if not r["launches"]:
                continue
            e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])
            e.setdefault("paths", []).append(
                {"path": path, "launches_timed": r["launches"],
                 "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                | {k: r[k] for k in ("ms", "rotated_ms", "trace_ms", "bytes",
                                     "floor_ms", "forms", "shapes")})
            trace = "not traced" if r["trace_ms"] is None \
                else f"{r['trace_ms']:.4f} ms"
            say("6", f"{name} {path}: {r['launches']} launches of one run "
                     f"{r['ms']:.4f} ms on its own inputs, "
                     f"{r['rotated_ms']:.4f} ms on rotated copies, replay "
                     f"trace {trace}; bound "
                     f"{r['bound'][0]:.5f} ms ({r['bound'][1]}), "
                     f"{r['launches']} x a launch's floor "
                     f"{r['launches'] * r['floor_ms']:.4f} ms {tag}")
    r = results["first_true_take_dense"]
    by_name["first_true_take"]["dense_shape"] = {
        k: r[k] for k in ("shape", "form", "ms", "eager_ms", "plain_ms",
                          "rotated_ms", "floor_ms", "max_abs_err")} | {
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
    p3 = results["row_fold_phase3"]
    by_name["row_fold"]["phase3"] = {
        k: p3[k] for k in ("ms", "eager_ms", "plain_ms", "max_abs_err")} | {
        "bound_ms": p3["bound"][0], "bound_by": p3["bound"][1]}
    for r in results["meta_any_shapes"]:
        b_ms, b_by = r["bound"]
        by_name["meta_any"].setdefault("tenant_shapes", []).append({
            k: r[k] for k in ("shape", "N", "E", "plane_entries", "planes",
                              "bytes", "ms", "eager_ms", "plain_ms", "tile",
                              "tile_ms")}
            | {"bound_ms": b_ms, "bound_by": b_by})
    for r in results["nonascii"]["shapes"]:
        by_name["nonascii"].setdefault("shapes", []).append(
            {k: r[k] for k in ("label", "shape", "ms", "eager_ms", "plain_ms",
                               "floor_ms", "nonascii")}
            | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]})
    for r in results["dfa_tenant"]:
        b_ms, b_by = r["bound"]
        by_name[r["name"]].setdefault("tenant_shapes", []).append({
            k: r[k] for k in ("family", "shape", "K", "S", "W", "steps",
                              "table_bytes", "ms", "flag_ms", "eager_ms",
                              "plain_ms", "chunk_ms")}
            | {"bound_ms": b_ms, "bound_by": b_by})
        say("6", f"{r['name']} tenant {r['family']} {r['shape']} (K "
                 f"{r['K']}, S {r['S']}): {r['ms']:.4f} ms (eager "
                 f"{r['eager_ms']:.4f} ms; with the non-ASCII flag "
                 f"{r['flag_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                 f"bound {b_ms:.6f} ms ({b_by}) {tag}")
    say("6", f"seconds by phase (3 includes the workloads' encode): "
             f"{phase_s.seconds}")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["xproc-rank"]:
        sys.exit(xproc_rank(sys.argv[2:]))
    sys.exit(main())
