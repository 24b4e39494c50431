"""The tiled background scan on one CUDA device — the port of
kyverno_tpu/parallel/sharding.py:ShardedScanner on a one-device mesh.

The scan workload is data-parallel over resources: every batch lane has
a leading N axis and the compiled program is elementwise across it.
Each tile travels in the vocabulary form (flatten.VocabBatch): a
per-tile row vocabulary plus a (n, Rb) ``row_idx`` table, and a pool
string table plus a (n, K) ``pool_sidx`` table. The device gathers the
dense lanes it reads from them (``evaluator.LaneView``, kernel K5), so
a tile moves a fraction of the dense form's bytes.

The step is the program of ``evaluator.build_program`` over a LaneView;
kernel K4 then takes the per-(rule, verdict-class) counts over every
column and writes the uint8 verdict table in the same pass.

On CUDA the step replays as one CUDA graph per shape bucket
(``tpu/graphs.py``; the eager step is ``step_jitted().run``).

``scan`` goes through the reference's resilience ladder: an encode
failure quarantines the hostile resources through ``TorchEngine.scan``,
and a device failure (raised, injected or wrong-shaped) takes the one
guarded dispatch of ``TorchEngine`` and answers the batch all-HOST, so
the scalar engine completes it. ``scan_stream`` raises on either, as
the reference's does.

``n_devices`` is 1: the multi-GPU scanner (``torch.distributed``) is
not ported yet. With a columnar store configured
(``cluster.columnar.configure_store``) ``encode`` gathers a tile's rows
from the store instead of walking its JSON; ``tpu/pipeline.py`` drives
``encode`` and the step with the encode on a feed thread or the
encoder pool.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"`` (every kernel replaced by its plain twin).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.policy import ClusterPolicy
from ..tpu.compiler import (CompiledPolicySet, compile_policy_set,
                            nonascii_families)
from ..observability.analytics import class_counts, global_starvation
from ..observability.metrics import global_registry
from ..observability.profiling import (PHASE_DISPATCH, PHASE_ENCODE,
                                       PHASE_HOST_COMPLETE, PHASE_READBACK,
                                       global_profiler)
from ..observability.tracing import global_tracer
from ..tpu.engine import (ScanResult, TorchEngine, lanes_to_device,
                          resolve_device)
from ..tpu.evaluator import HOST, build_program
from ..tpu.graphs import graphed
from ..tpu.flatten import EncodeConfig, encode_resources_vocab
from ..tpu.metadata import encode_metadata


class ShardedScanner:
    """Compile once, evaluate resource tiles on one device.

    The step returns (verdicts, counts): the (rules, N) uint8 verdict
    table plus the per-(rule, verdict-class) int32 totals over all N
    columns — the scan-service summary used for report rollups.
    """

    NUM_CLASSES = 7  # evaluator.NUM_VERDICT_CLASSES (incl. HOST/CONFIRM)

    def __init__(
        self,
        policies: Sequence[ClusterPolicy],
        device=None,
        encode_cfg: Optional[EncodeConfig] = None,
        meta_cfg=None,
        exceptions: Sequence = (),
        data_sources=None,
    ):
        self.device = resolve_device(device)
        self.cps: CompiledPolicySet = compile_policy_set(
            policies, encode_cfg, meta_cfg, data_sources)
        self.exceptions = list(exceptions)
        # vocabulary-axis buckets grow monotonically so tile-to-tile
        # vocabulary size changes keep the lane shapes; the rows axis
        # starts small (typical resources use a fraction of max_rows)
        # and grows the same way
        self._vbucket = 1024
        self._sbucket = 256
        self._rbucket = min(64, self.cps.encode_cfg.max_rows)
        step = build_program(
            self.cps.device_programs, self.cps.encode_cfg.max_instances,
            dfa=self.cps.dfa, verdicts_u8=True,
            nfa_globs=self.cps.nfa_globs,
            na_families=nonascii_families(self.cps.dfa,
                                          self.cps.device_programs,
                                          self.cps.nfa_globs))
        self._step = graphed(step, self.device)
        # recording run: which compact lanes does THIS program read?
        # encode() drops everything else before transfer (meta lanes a
        # policy set never touches are most of the per-resource bytes)
        self._used_keys = self._record_used_keys()

    def _record_used_keys(self) -> set:
        """Run the program once, eagerly on the CPU through the plain
        twins, over the reference's probe (two empty resources at the
        initial buckets) with a recording LaneView. The program has no
        data-dependent Python branch, so this run reads every lane any
        run would."""
        from ..tpu.evaluator import Ctx, densify, eval_rule

        vb = encode_resources_vocab([{}, {}], self.cps.encode_cfg,
                                    self.cps.byte_paths, self.cps.key_byte_paths)
        meta = encode_metadata([{}, {}], cfg=self.cps.meta_cfg)
        probe = lanes_to_device(vb.to_host(meta, self._vbucket, self._sbucket),
                                "cpu")
        view = densify(probe, record=True, plain=True)
        ctx = Ctx(view, self.cps.encode_cfg.max_instances, dfa=self.cps.dfa,
                  plain=True)
        for p in self.cps.device_programs:
            eval_rule(ctx, p)
        used = set(view.used_keys)
        # structural keys the step itself needs even if no rule reads them
        used.update({"row_idx", "vocab_valid", "fallback", "meta_fallback"})
        self._meta_need = {k[len("meta_"):] for k in used if k.startswith("meta_")}
        return used

    @property
    def n_devices(self) -> int:
        return 1

    def pad(self, n: int) -> int:
        """The batch size ``n`` resources actually evaluate at: the
        power-of-two batch bucket (encode/tasks.py encode_vocab_host),
        rounded to the device multiple (1)."""
        b = 16
        while b < n:
            b *= 2
        d = self.n_devices
        return ((b + d - 1) // d) * d

    def encode(self, resources, namespace_labels=None, operations=None,
               content_hashes=None):
        """The vocabulary-form host dict of one batch (pruned to the
        lanes the program reads) and its live resource count
        (kyverno_tpu/parallel/sharding.py:ShardedScanner.encode). With
        the columnar store on, rows gather from the store (misses
        encode into it); ``content_hashes`` skips re-serializing the
        resources whose canonical hash the caller holds."""
        from ..cluster.columnar import get_store
        from ..encode.tasks import encode_vocab_host

        store = get_store()
        if store is not None and store.enabled:
            hashes = list(content_hashes or [])

            def encoder(res, cfg, bp, kbp):
                return store.encode_vocab(res, cfg, bp, kbp,
                                          hashes=hashes[: len(res)])
        else:
            # late-bound through this module, so a patched
            # sharding.encode_resources_vocab still intercepts
            def encoder(*a, **kw):
                return encode_resources_vocab(*a, **kw)

        host, n, buckets = encode_vocab_host(
            resources, namespace_labels, operations,
            self.cps.encode_cfg, self.cps.byte_paths,
            self.cps.key_byte_paths, self.cps.meta_cfg,
            getattr(self, "_meta_need", None),
            getattr(self, "_used_keys", None),
            self.n_devices,
            (self._vbucket, self._sbucket, self._rbucket),
            encoder=encoder)
        self._vbucket, self._sbucket, self._rbucket = buckets
        return host, n

    def put(self, batch: Dict[str, Any],
            keep: Optional[list] = None) -> Dict[str, torch.Tensor]:
        """Place a host batch on the device in ONE asynchronous copy
        from pinned memory (``engine.lanes_to_device``); ``keep``
        receives the pinned buffer."""
        return lanes_to_device(batch, self.device, keep)

    def scan_device(self, resources, namespace_labels=None, operations=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Device layer only: (uint8 verdicts (device_rules, n), int32
        counts over the padded batch). Verdicts may contain HOST(5) for
        resources exceeding encode caps, and host-fallback rules are
        absent — use scan() for the complete, resolved result."""
        batch, n = self.encode(resources, namespace_labels, operations)
        verdicts, counts = self._step(self.put(batch))
        return verdicts.cpu().numpy()[:, :n], counts.cpu().numpy()

    def _engine(self) -> TorchEngine:
        return TorchEngine(cps=self.cps, device=self.device,
                           exceptions=self.exceptions)

    def scan(self, resources, namespace_labels=None, operations=None
             ) -> ScanResult:
        """Complete ScanResult over ALL rules: device verdicts merged
        with scalar-engine completions (host rules, exception-named
        rules, capped resources) — HOST never escapes
        (kyverno_tpu/parallel/sharding.py:ShardedScanner.scan).

        An encode failure quarantines the hostile resources through
        TorchEngine.scan; a device failure (raised, injected, or
        wrong-shaped) trips the shared breaker in the engine's guarded
        dispatch and the whole batch completes on the scalar engine."""
        eng = self._engine()
        try:
            batch, n = self.encode(resources, namespace_labels, operations)
        except Exception:
            return eng.scan(resources, namespace_labels, operations)
        D = len(self.cps.device_programs)

        def run():
            v, c = self._step(self.put(batch))
            v = v.cpu().numpy()
            # the step's counts are the rule analytics' source: drop
            # the pad columns and stash them for the assemble() below
            eng.set_pending_counts(c.cpu().numpy().astype(np.int64)
                                   - class_counts(v[:, n:]))
            return v[:, :n].astype(np.int32)

        table = eng.guarded_dispatch(run, (D, n))
        if table is None:
            table = np.full((D, len(resources)), HOST, dtype=np.int32)
        return eng.assemble(table, resources, namespace_labels, operations)

    def scan_stream(
        self,
        resources,
        tile: int = 8192,
        namespace_labels=None,
        operations=None,
        complete_host: bool = True,
        in_flight: int = 3,
    ):
        """Tiled streaming scan for snapshots larger than one device
        batch (a 100k-resource background scan). Every tile is padded
        to the same size. CUDA's asynchronous launches overlap the
        device work of up to ``in_flight`` tiles with the host's encode
        of the next: nothing before ``drain`` waits for the device, and
        each tile's pinned host buffer is held until its table is read
        back. Returns (ScanResult, stats) where stats carries the cost
        split: encode seconds, device wait seconds, host completion
        seconds, host-resolved cell count, tiles and tile size."""
        tile = self.pad(tile)
        n = len(resources)
        stats = {"encode_s": 0.0, "device_s": 0.0, "host_s": 0.0,
                 "host_cells": 0, "tiles": 0, "tile": tile}
        eng = self._engine() if complete_host else None
        tables: List[np.ndarray] = []
        # (device verdicts, pinned buffers, tile slice, n_valid)
        pending: List[Tuple[torch.Tensor, list, slice, int]] = []
        # every tile span is an explicit child of one scan-level span
        scan_span = global_tracer.start_span(
            "scan_stream", resources=n, tile=tile)
        scan_ctx = scan_span.context

        def drain():
            dv, _pinned, sl, nv = pending.pop(0)
            t0 = time.perf_counter()
            with global_profiler.phase(PHASE_READBACK), \
                    global_tracer.span("scan_device_wait", parent=scan_ctx,
                                       tile=nv):
                table = dv.cpu().numpy()[:, :nv]  # waits for the device
            dt = time.perf_counter() - t0
            stats["device_s"] += dt
            global_starvation.record(busy_s=dt)
            if eng is not None:
                t0 = time.perf_counter()
                with global_profiler.phase(PHASE_HOST_COMPLETE), \
                        global_tracer.span("scan_host_complete",
                                           parent=scan_ctx, tile=nv):
                    res = eng.assemble(
                        table, resources[sl], namespace_labels,
                        operations[sl] if operations else None)
                # HOST and CONFIRM cells both resolved on the host
                stats["host_cells"] += int((table >= HOST).sum())
                stats["host_s"] += time.perf_counter() - t0
                tables.append(res.verdicts)
            else:
                tables.append(table)

        try:
            for start in range(0, max(n, 1), tile):
                sl = slice(start, min(start + tile, n))
                chunk = resources[sl]
                nv = len(chunk)
                t0 = time.perf_counter()
                with global_profiler.phase(PHASE_ENCODE), \
                        global_tracer.span("scan_encode", parent=scan_ctx,
                                           tile=nv):
                    padded = list(chunk) + [{} for _ in range(tile - nv)]
                    ops = None
                    if operations:
                        ops = list(operations[sl]) + [""] * (tile - nv)
                    batch, _ = self.encode(padded, namespace_labels, ops)
                enc_dt = time.perf_counter() - t0
                stats["encode_s"] += enc_dt
                if not pending:
                    # no tile in flight while this one encoded: the
                    # device sat idle waiting on the host
                    global_starvation.record(starved_s=enc_dt)
                # asynchronous copy then launch: the H2D copy of tile
                # k+1 overlaps the device work of tiles k, k-1, ...
                pinned: list = []
                with global_profiler.phase(PHASE_DISPATCH), \
                        global_tracer.span("scan_dispatch", parent=scan_ctx,
                                           tile=nv):
                    verdicts, _ = self._step(self.put(batch, pinned))
                pending.append((verdicts, pinned, sl, nv))
                stats["tiles"] += 1
                while len(pending) > max(in_flight, 1):
                    drain()
            while pending:
                drain()
        except BaseException as e:
            scan_span.set_status("error", f"{type(e).__name__}: {e}")
            raise
        finally:
            scan_span.attributes["tiles"] = stats["tiles"]
            global_tracer.end_span(scan_span)
        # phase timings land in metrics too, exemplar-linked to the
        # scan's trace
        ex = {"trace_id": scan_ctx.trace_id}
        global_registry.scan_encode_seconds.observe(stats["encode_s"],
                                                    exemplar=ex)
        global_registry.scan_device_seconds.observe(stats["device_s"],
                                                    exemplar=ex)
        global_registry.scan_host_seconds.observe(stats["host_s"],
                                                  exemplar=ex)

        total = np.concatenate(tables, axis=1) if tables else np.zeros(
            (len(self.cps.rules if eng else self.cps.device_programs), 0),
            dtype=np.int32)
        rules = ([(e.policy_name, e.rule_name) for e in self.cps.rules]
                 if eng is not None
                 else [(p.policy_name, p.rule_name)
                       for p in self.cps.device_programs])
        return ScanResult(verdicts=total, rules=rules), stats

    def step_jitted(self):
        """The step: device lanes -> ((rules, N) uint8 verdicts, (rules,
        7) int32 counts over every column), asynchronous on CUDA —
        nothing in it waits for the device. (The reference's jitted
        step: on CUDA a ``GraphedProgram``, whose ``run`` is the eager
        step; on the CPU the eager step.)"""
        return self._step
