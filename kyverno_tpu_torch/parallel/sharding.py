"""The tiled background scan over a mesh of devices — the port of
kyverno_tpu/parallel/sharding.py (``make_mesh``, ``make_mesh_2d``,
``ShardedScanner``).

The scan workload is data-parallel over resources: every batch lane has
a leading N axis and the compiled program is elementwise across it.
Each tile travels in the vocabulary form (flatten.VocabBatch): a
per-tile row vocabulary plus a (n, Rb) ``row_idx`` table, and a pool
string table plus a (n, K) ``pool_sidx`` table. The device gathers the
dense lanes it reads from them (``evaluator.LaneView``, kernel K5), so
a tile moves a fraction of the dense form's bytes.

A mesh (``Mesh``) is a grid of ``torch.device``s of ONE process, as the
reference's is a grid of one process's JAX devices (its multi-host form
runs under ``jax.distributed``; the port's ``torch.distributed`` comes
with the serving entry points). Policies are replicated and resources
shard: ``put`` splits every per-resource lane host-major into
``mesh.size`` contiguous slices in the order of ``mesh.devices``, and
copies the vocabulary lanes (``vocab_*``, ``pool_svocab``,
``pool_slen``) once to each distinct device, all of a device's lanes in
one pinned buffer and one copy. A mesh may name a device more than once
(the CPU tests use ``["cpu"] * 8``; a one-GPU machine names ``cuda:0``
more than once): each entry is one shard.

Each distinct device has its own compiled program (``evaluator.
build_program``; on CUDA one CUDA graph per shape bucket, ``tpu/
graphs.py``). ``step`` runs each shard through its device's program
inside ``torch.cuda.device(d)`` (the kernels launch on the current
device's stream and raise ``KernelError`` for tensors elsewhere), shards
of one device one after another; kernel K4 gives each shard's uint8
verdict table and per-(rule, verdict-class) int32 counts, and the counts
are summed on the mesh's first device (a peer copy of each shard's
(rules, 7) counts, then one add: the counterpart of the reference's
cross-device reduction). The tables are read back into one host array in
mesh order.

``scan`` goes through the reference's resilience ladder: an encode
failure quarantines the hostile resources through ``TorchEngine.scan``,
and a device failure (raised, injected or wrong-shaped) takes the one
guarded dispatch of ``TorchEngine`` and answers the batch all-HOST, so
the scalar engine completes it. ``scan_stream`` raises on either, as
the reference's does.

With a columnar store configured (``cluster.columnar.configure_store``)
``encode`` gathers a tile's rows from the store instead of walking its
JSON; ``tpu/pipeline.py`` drives ``encode`` and the step with the encode
on a feed thread or the encoder pool.

Entry points run on the card: ``make_mesh()`` spans every CUDA device
and raises without one (never a CPU fallback); ``device="cpu"`` (a
one-entry CPU mesh) or a mesh of CPU entries runs every kernel's plain
twin.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
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


class Mesh:
    """A grid of devices of one process — the port's counterpart of
    ``jax.sharding.Mesh``: ``devices`` is an object ndarray of
    ``torch.device`` (its shape is the mesh's), ``axis_names`` names its
    axes, ``size`` counts its entries. A device may appear more than
    once; each entry holds one shard."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(tuple(axis_names)):
            raise ValueError(f"a mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        if devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def flat(self) -> List[torch.device]:
        """The entries in mesh order (host-major on a 2-axis mesh): the
        order of the shards."""
        return list(self.devices.reshape(-1))

    @property
    def distinct(self) -> List[torch.device]:
        """Each device once, in the order it first appears."""
        out: List[torch.device] = []
        for d in self.flat:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.flat]}, shape {self.shape})")


def _mesh_device(d) -> torch.device:
    """A mesh entry: a CPU device, or a CUDA device with its index."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {dev}: no CUDA device is "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"mesh device {dev}: only "
                             f"{torch.cuda.device_count()} CUDA devices")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev}")
    return dev


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    """The given devices, or every CUDA device (never the CPU)."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is available; the default mesh "
                "spans every CUDA device and never falls back to the CPU "
                "(pass devices=, e.g. ['cpu'] * 8, for a CPU mesh)")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [_mesh_device(d) for d in devices]


def _object_array(devices: List[torch.device]) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return arr


def make_mesh(devices: Optional[Sequence] = None, axis: str = "data"
              ) -> Mesh:
    """A one-axis mesh over ``devices`` (default: every CUDA device)."""
    return Mesh(_object_array(_devices(devices)), (axis,))


def make_mesh_2d(
    hosts: int,
    per_host: int,
    devices: Optional[Sequence] = None,
    axes: Tuple[str, str] = ("hosts", "data"),
) -> Mesh:
    """Two-axis (hosts, devices-per-host) mesh — the multi-host shape:
    the tile's resources shard host-major over both axes, so each host
    owns a contiguous range, and the verdict-count reduction crosses
    both (kyverno_tpu/parallel/sharding.py:make_mesh_2d)."""
    devices = _devices(devices)
    if len(devices) < hosts * per_host:
        raise ValueError(
            f"need {hosts * per_host} devices for a {hosts}x{per_host} mesh, "
            f"have {len(devices)}")
    arr = _object_array(devices[: hosts * per_host]).reshape(hosts, per_host)
    return Mesh(arr, axes)


def _on(dev: torch.device):
    """``torch.cuda.device(dev)`` for a CUDA device; nothing for the
    CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


class ShardedScanner:
    """Compile once, evaluate resource tiles sharded across a mesh.

    The step returns (verdicts, counts): each shard's (rules, N / size)
    uint8 verdict table, in mesh order, plus the per-(rule,
    verdict-class) int32 totals over every column of the mesh — the
    scan-service summary used for report rollups.
    """

    NUM_CLASSES = 7  # evaluator.NUM_VERDICT_CLASSES (incl. HOST/CONFIRM)

    def __init__(
        self,
        policies: Sequence[ClusterPolicy],
        mesh: Optional[Mesh] = None,
        device=None,
        encode_cfg: Optional[EncodeConfig] = None,
        meta_cfg=None,
        exceptions: Sequence = (),
        data_sources=None,
    ):
        if mesh is not None and device is not None:
            raise ValueError("ShardedScanner: pass mesh= or device=, not both")
        if mesh is None:
            # device= is shorthand for a one-entry mesh
            mesh = make_mesh() if device is None \
                else make_mesh([resolve_device(device)])
        self.mesh = mesh
        # resources shard over ALL mesh axes jointly, host-major
        self.axes: Tuple[str, ...] = tuple(mesh.axis_names)
        self.axis = self.axes[0]
        # the mesh's first device: the counts reduce there, and the
        # scan's TorchEngine (assemble, the quarantining fallback) runs
        # there
        self.device = mesh.flat[0]
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
        # one program per distinct device (its K6 constants, K9 packs,
        # K10 tables and tapes live on that device), graphed on CUDA
        na = nonascii_families(self.cps.dfa, self.cps.device_programs,
                               self.cps.nfa_globs)
        self._steps: Dict[torch.device, Any] = {}
        for dev in mesh.distinct:
            step = build_program(
                self.cps.device_programs, self.cps.encode_cfg.max_instances,
                dfa=self.cps.dfa, verdicts_u8=True,
                nfa_globs=self.cps.nfa_globs, na_families=na)
            self._steps[dev] = graphed(step, dev)
        self._step = self._steps[self.device]
        # each distinct device's kernel launches in the step (replays
        # count the launches they stand for), by kernel name
        self.device_launches: Dict[str, Dict[str, int]] = {
            str(d): {} for d in mesh.distinct}
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

    # vocabulary lanes are replicated; everything else leads with N and
    # shards across the mesh
    @staticmethod
    def _replicated_key(k: str) -> bool:
        return k.startswith("vocab_") or k in ("pool_svocab", "pool_slen")

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def pad(self, n: int) -> int:
        """The batch size ``n`` resources actually evaluate at: the
        power-of-two batch bucket (encode/tasks.py encode_vocab_host),
        rounded to the mesh multiple."""
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
            keep: Optional[list] = None) -> List[Dict[str, torch.Tensor]]:
        """Place a host batch on the mesh: one lane dict a mesh entry,
        in mesh order. Each per-resource lane is split into
        ``mesh.size`` contiguous slices; the vocabulary lanes go once to
        each distinct device. A device's lanes (the replicated ones and
        its shards') travel in ONE asynchronous copy from one pinned
        buffer (``engine.lanes_to_device``); ``keep`` receives the
        pinned buffers."""
        shards = self.mesh.flat
        n = next((len(v) for k, v in batch.items()
                  if not self._replicated_key(k)), 0)
        if n % len(shards):
            raise ValueError(f"put: a batch of {n} does not split over "
                             f"{len(shards)} mesh entries")
        per = n // len(shards)
        out: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(shards)
        for dev in self.mesh.distinct:
            mine = [i for i, d in enumerate(shards) if d == dev]
            lanes = {k: v for k, v in batch.items() if self._replicated_key(k)}
            for i in mine:
                for k, v in batch.items():
                    if not self._replicated_key(k):
                        lanes[f"{i}/{k}"] = v[i * per:(i + 1) * per]
            with _on(dev):
                on = lanes_to_device(lanes, dev, keep)
            for i in mine:
                out[i] = {k: on[k] if self._replicated_key(k)
                          else on[f"{i}/{k}"] for k in batch}
        return out

    def step(self, shards: List[Dict[str, torch.Tensor]]
             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The mesh's step over ``put``'s shards: each through its
        device's program inside ``torch.cuda.device(d)`` (nothing waits
        for a device). Returns each shard's uint8 (rules, N / size)
        table, in mesh order, and the int32 (rules, 7) counts over every
        column, summed on the mesh's first device."""
        verdicts, counts = [], []
        for dev, lanes in zip(self.mesh.flat, shards):
            # the first device's program is ``_step`` (step_jitted())
            prog = self._step if dev == self.device else self._steps[dev]
            with _on(dev), kernels.tallying_into(
                    self.device_launches[str(dev)]):
                v, c = prog(lanes)
            verdicts.append(v)
            counts.append(c)
        if len(counts) == 1:
            return verdicts, counts[0]
        with _on(self.device):
            total = torch.stack([c.to(self.device, non_blocking=True)
                                 for c in counts]).sum(dim=0,
                                                       dtype=torch.int32)
        return verdicts, total

    @staticmethod
    def table(verdicts: List[torch.Tensor]) -> np.ndarray:
        """The shards' tables read back into one host array, in mesh
        order (waits for the devices)."""
        parts = [v.cpu().numpy() for v in verdicts]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)

    def scan_device(self, resources, namespace_labels=None, operations=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Device layer only: (uint8 verdicts (device_rules, n), int32
        counts over the padded batch). Verdicts may contain HOST(5) for
        resources exceeding encode caps, and host-fallback rules are
        absent — use scan() for the complete, resolved result."""
        batch, n = self.encode(resources, namespace_labels, operations)
        verdicts, counts = self.step(self.put(batch))
        return self.table(verdicts)[:, :n], counts.cpu().numpy()

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
            with _on(self.device):
                return eng.scan(resources, namespace_labels, operations)
        D = len(self.cps.device_programs)

        def run():
            vs, c = self.step(self.put(batch))
            v = self.table(vs)
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
        # (each shard's device verdicts, pinned buffers, tile slice,
        # n_valid)
        pending: List[Tuple[List[torch.Tensor], list, slice, int]] = []
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
                table = self.table(dv)[:, :nv]  # waits for the devices
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
                    verdicts, _ = self.step(self.put(batch, pinned))
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
        """The program of the mesh's first device: one shard's lanes ->
        ((rules, n) uint8 verdicts, (rules, 7) int32 counts over its
        columns), asynchronous on CUDA — nothing in it waits for the
        device (on CUDA a ``GraphedProgram``, whose ``run`` is the eager
        program; on the CPU the eager program). ``step`` runs the
        mesh."""
        return self._step
