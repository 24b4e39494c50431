# Copied from kyverno_tpu/tpu/pipeline.py; a chunk's launch and readback
# are the port's own (_launch, _wait: CUDA copies, a graph replay on each
# shard's device, an event a device).
"""Pipelined scan — overlap host encode, device execute, and host
completion across consecutive chunks (the port of
kyverno_tpu/tpu/pipeline.py on CUDA streams).

The serial scan loop alternates host and device idle time: encode
chunk k -> dispatch -> BLOCKING readback -> assemble -> report, with
the device idle during encode/assemble and the host idle during the
readback wait. Hardware matching engines hide exactly this host
preprocessing behind the matcher's execution (PAPERS: Hyperflex
SIMD-DFA pipelines packet staging against automata execution); CUDA's
asynchronous copies and launches give the same lever, as long as
nobody waits on the stream too early.

Structure (double buffer, depth-bounded):

- a worker thread encodes chunk k+1 while the device executes chunk k
  (encode results — host batches of numpy arrays — ride a bounded
  queue, so encode can run at most ``depth`` chunks ahead —
  backpressure, not unbounded memory);
- the dispatching thread, the only one that makes CUDA calls, launches
  chunk k (``_launch``: the batch packed into pinned buffers and copied
  to the mesh's devices, each shard's CUDA graph replayed on its
  device, each shard's verdicts copied back into its own block of the
  slot's pinned buffer and the counts into another, an event recorded
  on each distinct device — nothing waits) and only then drains chunk
  k-1: the wait on k-1's events overlaps the devices executing k, and
  the host
  completion + report-row generation for k-1 (the ``on_result``
  callback) overlaps it too. A slot holds its buffers until its event
  has fired; the step's graph returns clones of its outputs, so a
  slot's table survives the next replay. On a mesh across processes
  the launch holds this rank's shards (the counts already summed over
  the ranks by the step) and the readback gathers every rank's tables
  (``ShardedScanner.table``); a chunk this rank cannot launch (its
  encode failed, its breaker is open) still joins the chunk's first
  collective, failed (``ShardedScanner.skip_step``), so the ranks stay
  in step. Feed threads and the pool's
  reader threads make no CUDA call: one during a graph capture on the
  dispatching thread would break it.

Verdicts are bit-identical to the serial path: every chunk goes
through the engine's guarded dispatch ladder (breaker, fault hook,
corrupt filter, validation) split into its launch/complete phases, a
failed chunk scalar-completes via ``assemble`` exactly like a failed
serial dispatch, and an encode failure falls back to the serial
quarantining scan for that chunk.

With an encoder pool configured (encode/pool.py, --encode-workers),
the encode side fans out: the feeder keeps >= 2 chunks encoding
concurrently on worker processes while the device runs, with the
pool's own ladder underneath — a chunk whose worker crashes retries
once, a chunk that kills two workers is bisected to the poison
resource (its column arrives flagged and scalar-completes through the
same quarantine path as an encode-cap overflow), and pool-infra
failures or an OPEN encode-pool breaker drop that chunk back to the
in-process encoder. Delivery order, backpressure, and verdict
bit-identity are unchanged.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability.analytics import (class_counts, global_starvation)
from ..observability.metrics import global_registry
from ..observability.profiling import (PHASE_DISPATCH, PHASE_ENCODE,
                                       PHASE_ENCODE_WAIT,
                                       PHASE_HOST_COMPLETE, PHASE_READBACK,
                                       global_profiler)
from ..observability.tracing import global_tracer
from .engine import ScanResult
from .evaluator import ERROR, HOST

# on_result(chunk_idx, ScanResult) — called in pipeline order (chunk 0
# first), overlapping the device time of later chunks
OnResult = Callable[[int, ScanResult], None]


def scanner_encode_profile(scanner, ns_labels=None) -> Dict[str, Any]:
    """The encoder-pool profile for a ShardedScanner: everything its
    encode() bakes in besides the chunk itself (caps, byte paths, meta
    config, used lanes, mesh pad — and optionally the scan's ns-label
    map, invariant across chunks, so it ships once per worker instead
    of riding every task). encode/tasks.py run_vocab drives the SAME
    encode body ShardedScanner.encode uses against this spec."""
    from ..encode import profile_spec

    return profile_spec(
        scanner.cps.encode_cfg,
        byte_paths=scanner.cps.byte_paths,
        key_byte_paths=scanner.cps.key_byte_paths,
        meta_cfg=scanner.cps.meta_cfg,
        meta_need=getattr(scanner, "_meta_need", None),
        used_keys=getattr(scanner, "_used_keys", None),
        pad_multiple=scanner.n_devices,
        ns_labels=ns_labels,
    )


class _Slot:
    """One launched chunk: the step's verdicts and counts (on the CPU
    the tensors themselves; on CUDA the slot's own pinned host buffers,
    filled by asynchronous copies: the verdicts as (shards, rules,
    N / shards), a shard's table a contiguous block), the pinned input
    buffers and the device tensors the copies read, held until every
    one of ``events`` (one a distinct device) has fired. On a mesh
    across processes ``verdicts`` is this rank's shards and ``gather``
    reads every rank's tables back."""

    __slots__ = ("verdicts", "counts", "keep", "events", "gather")

    def __init__(self, verdicts, counts, keep, events, gather=None):
        self.verdicts, self.counts = verdicts, counts
        self.keep, self.events = keep, events
        self.gather = gather


def _launch(scanner, batch: Dict[str, Any]) -> _Slot:
    """Enqueue one chunk on the mesh's devices' current streams and
    return at once: the copies in from the batch's pinned buffers, the
    step (each shard's CUDA graph replayed on its device), the copy of
    each shard's verdicts into its block of one pinned buffer, of the
    counts (on the mesh's first device) into another, and an event on
    each distinct device after its copies. Called on the dispatching
    thread only."""
    import torch

    keep: list = []
    vs, c = scanner._put_step(batch, keep)
    mesh = scanner.mesh
    if mesh.cross_process:
        # the counts are already summed over the ranks; the tables are
        # gathered at the readback (``_wait``)
        return _Slot(vs, c, keep, None, gather=scanner.table)
    if c.device.type != "cuda":
        return _Slot(vs[0] if len(vs) == 1 else torch.cat(vs, dim=1), c,
                     keep, None)
    vh = torch.empty((len(vs),) + tuple(vs[0].shape), dtype=vs[0].dtype,
                     pin_memory=True)
    ch = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
    for i, (dev, v) in enumerate(zip(mesh.local_devices, vs)):
        with torch.cuda.device(dev):
            vh[i].copy_(v, non_blocking=True)
    events = []
    for dev in mesh.distinct:
        with torch.cuda.device(dev):
            if dev == c.device:
                ch.copy_(c, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            events.append(event)
    return _Slot(vh, ch, keep + vs + [c], events)


def _wait(slot: _Slot) -> Tuple[np.ndarray, np.ndarray]:
    """The slot's (verdicts, counts) on the host, once all its events
    have fired; the shards' blocks are read back in mesh order. On a
    mesh across processes every rank's tables are gathered."""
    if slot.gather is not None:
        v = slot.gather(slot.verdicts)
        slot.keep = None
        return v, slot.counts.numpy()
    for event in slot.events or ():
        event.synchronize()
    v, c = slot.verdicts.numpy(), slot.counts.numpy()
    if v.ndim == 3:
        v = v.transpose(1, 0, 2).reshape(v.shape[1], -1)
    slot.keep = None
    return v, c


class PipelinedScanner:
    """Drive a ShardedScanner's encode/step through the overlap
    pipeline, completing verdicts with the TorchEngine ladder.

    ``encode_pool``: an EncoderPool to fan the encode side out on;
    None resolves the process-wide pool (encode.get_pool(), i.e. the
    --encode-workers / $KYVERNO_TPU_ENCODE_WORKERS knob) at scan time,
    which is None when disabled — the in-process encode thread then
    runs exactly as before."""

    def __init__(self, scanner, depth: int = 2, encode_pool=None):
        self.scanner = scanner
        self.engine = scanner._engine()
        self.depth = max(1, depth)
        self._encode_pool = encode_pool
        self._pool_profile: Optional[Tuple[Any, int]] = None

    def _resolve_pool(self):
        from ..cluster.columnar import get_store

        if get_store() is not None:
            # columnar feed active: chunks assemble by gather from the
            # store (misses diff-encode into it) — shipping them to
            # pool workers would re-walk JSON and bypass the store.
            # The pool still serves the admission rows feed.
            return None
        if self._encode_pool is not None:
            return self._encode_pool if self._encode_pool.running else None
        from ..encode import get_pool

        pool = get_pool()
        return pool if (pool is not None and pool.running) else None

    def _profile_for(self, pool) -> int:
        if self._pool_profile is None or self._pool_profile[0] is not pool:
            self._pool_profile = (
                pool, pool.register_profile(
                    scanner_encode_profile(self.scanner)))
        return self._pool_profile[1]

    def scan_chunks(
        self,
        chunks: Sequence[Sequence[Dict[str, Any]]],
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        operations: Optional[Sequence[Sequence[str]]] = None,
        on_result: Optional[OnResult] = None,
        content_hashes: Optional[Sequence[Sequence[Optional[str]]]] = None,
    ) -> Dict[str, Any]:
        """Scan ``chunks`` (a list of resource lists). Results are
        delivered through ``on_result`` per chunk, in order; the
        returned stats carry the phase split and the measured overlap
        ratio ((encode+device+host seconds - wall) / wall — 0 means
        strictly serial). ``content_hashes`` (per-chunk, aligned with
        ``chunks``) lets the columnar-store feed key its gathers off
        the snapshot's stored hashes instead of re-serializing
        every body."""
        stats: Dict[str, Any] = {
            "encode_s": 0.0, "device_s": 0.0, "host_s": 0.0,
            "encode_wait_s": 0.0, "starved_s": 0.0,
            "chunks": len(chunks), "resources": sum(len(c) for c in chunks),
            "encode_fallback_chunks": 0, "overlap_ratio": 0.0,
            # per-chunk timeline: encode / encode-wait / device /
            # host-assemble seconds and resolution path per chunk, in
            # completion order (bench + /debug introspection)
            "timeline": [],
        }
        if not chunks:
            return stats
        t_wall0 = time.perf_counter()
        scan_span = global_tracer.start_span(
            "pipelined_scan", chunks=len(chunks),
            resources=stats["resources"])
        scan_ctx = scan_span.context
        enc_q: "queue.Queue[Tuple[int, Optional[Any]]]" = queue.Queue(
            maxsize=self.depth)
        stop = threading.Event()

        chunk_encode_s: Dict[int, float] = {}
        pool = self._resolve_pool()

        def put_payload(idx: int, payload: Optional[Any]) -> bool:
            while not stop.is_set():
                try:
                    enc_q.put((idx, payload), timeout=0.1)
                    return True
                except queue.Full:
                    continue  # consumer died: stop flag ends us
            return False

        def encode_inprocess(idx: int) -> Optional[Any]:
            """One chunk through the in-process encoder — the serial
            path, and the pool's bypass/infra fallback rung."""
            chunk = chunks[idx]
            t0 = time.perf_counter()
            try:
                with global_profiler.phase(PHASE_ENCODE), \
                        global_tracer.span("scan_encode",
                                           parent=scan_ctx,
                                           tile=len(chunk)):
                    ops = list(operations[idx]) if operations else None
                    if content_hashes is not None:
                        batch, n = self.scanner.encode(
                            chunk, namespace_labels, ops,
                            content_hashes=content_hashes[idx])
                    else:
                        batch, n = self.scanner.encode(
                            chunk, namespace_labels, ops)
                payload: Optional[Any] = (batch, n, None)
            except Exception:
                payload = None  # serial quarantining fallback
            dt = time.perf_counter() - t0
            stats["encode_s"] += dt
            chunk_encode_s[idx] = dt
            return payload

        def encode_worker() -> None:
            # encode chunk k+1 while the device executes chunk k; the
            # bounded queue is the double buffer (encode never runs
            # more than `depth` chunks ahead)
            for idx in range(len(chunks)):
                if stop.is_set():
                    return
                if not put_payload(idx, encode_inprocess(idx)):
                    return

        def encode_worker_pooled() -> None:
            # pool feed: keep >= 2 chunks encoding concurrently on
            # worker processes while the device runs; results are
            # delivered in chunk order with the same backpressure
            from ..encode import (PoolBypassed, PoolInfraError,
                                  WorkerEncodeError)

            if namespace_labels:
                # scan-scoped profile: the ns-label map is invariant
                # across this scan's chunks — ship it once per worker
                # (with the profile), not pickled into every task
                profile_id = pool.register_profile(
                    scanner_encode_profile(self.scanner,
                                           ns_labels=namespace_labels))
                scan_profile = profile_id
            else:
                profile_id = self._profile_for(pool)
                scan_profile = None
            s = self.scanner
            lookahead = max(self.depth, 2)
            handles: Dict[int, Optional[Any]] = {}
            submitted = 0

            def submit_next() -> None:
                nonlocal submitted
                idx = submitted
                ops = list(operations[idx]) if operations else None
                task = {"resources": list(chunks[idx]),
                        "operations": ops,
                        "buckets": (s._vbucket, s._sbucket, s._rbucket)}
                try:
                    handles[idx] = pool.submit(profile_id, "vocab", task)
                except (PoolBypassed, PoolInfraError):
                    handles[idx] = None  # in-process at resolve time
                submitted += 1

            def resolve(idx: int) -> Optional[Any]:
                h = handles.pop(idx)
                if h is not None:
                    try:
                        out = pool.await_result(h)
                        # fold the worker's monotone bucket growth back
                        # so later chunks (and the next scan) reuse the
                        # same graph shape buckets
                        vb_, sb_, rb_ = out["buckets"]
                        s._vbucket = max(s._vbucket, vb_)
                        s._sbucket = max(s._sbucket, sb_)
                        s._rbucket = max(s._rbucket, rb_)
                        dt = float(out.get("encode_s", 0.0))
                        stats["encode_s"] += dt
                        chunk_encode_s[idx] = dt
                        global_profiler.add(PHASE_ENCODE, dt)
                        # the encode happened in a worker process: the
                        # span is recorded retroactively from the
                        # worker-reported duration so pooled scans keep
                        # the same trace shape as in-process ones
                        now = time.monotonic()
                        global_tracer.record_span(
                            "scan_encode", now - dt, now, parent=scan_ctx,
                            tile=len(chunks[idx]), pooled=True)
                        return (out["host"], out["n"], out.get("poison"))
                    except WorkerEncodeError:
                        # content failure inside the worker — exactly
                        # an in-process encode raise: quarantine ladder
                        return None
                    except (PoolBypassed, PoolInfraError):
                        pass  # pool infra out: encode here instead
                return encode_inprocess(idx)

            try:
                for idx in range(len(chunks)):
                    if stop.is_set():
                        return
                    if submitted == idx:
                        # cold start (and single-chunk scans): first
                        # chunk alone, so its result warms the shape
                        # buckets the lookahead chunks then ride
                        submit_next()
                    if not put_payload(idx, resolve(idx)):
                        return
                    while (submitted < len(chunks)
                            and submitted - (idx + 1) < lookahead):
                        submit_next()
            finally:
                if scan_profile is not None:
                    pool.release_profile(scan_profile)

        worker = threading.Thread(
            target=encode_worker_pooled if pool is not None
            else encode_worker,
            daemon=True, name="scan-encode")
        worker.start()
        eng = self.engine
        D = len(eng.cps.device_programs)
        # (chunk idx, launch handle, live n, poison column indices)
        inflight: List[Tuple[int, Optional[Tuple[Any]], int,
                             Optional[List[int]]]] = []

        def publish_live_ratios() -> None:
            # satellite contract: /metrics mid-scan must see LIVE
            # pipeline numbers — the overlap gauge updates per chunk,
            # and the starvation tracker got its per-chunk samples as
            # they happened (its gauge rides along)
            wall = time.perf_counter() - t_wall0
            busy = stats["encode_s"] + stats["device_s"] + stats["host_s"]
            if wall > 0:
                global_registry.pipeline_overlap.set(
                    round(max(0.0, busy - wall) / wall, 4))

        def readback(fut, n, poison):
            # the launched handle is the step's (verdicts, counts) in
            # the slot's host buffers once its event fires: counts are
            # the device-side rule-analytics reduction; pad columns
            # leave them before the stash
            v, c = _wait(fut)
            if poison:
                # poison columns were encoded as {} placeholders after
                # the pool's bisect: flag them HOST so assemble()
                # scalar-completes the REAL resources (the encode-
                # failure quarantine), and drop the device counts —
                # assemble's host recount over the final table stays
                # exact without correction bookkeeping
                v = np.array(v, copy=True)
                v[:, poison] = HOST
                c = None
            if c is not None:
                c = c.astype(np.int64) - class_counts(v[:, n:])
            eng.set_pending_counts(c)
            return v[:, :n].astype(np.int32)

        def drain() -> None:
            idx, handle, n, poison = inflight.pop(0)
            chunk = chunks[idx]
            ops = list(operations[idx]) if operations else None
            t0 = time.perf_counter()
            with global_profiler.phase(PHASE_READBACK), \
                    global_tracer.span("scan_device_wait", parent=scan_ctx,
                                       tile=n):
                table = eng.guarded_complete(
                    handle, lambda fut: readback(fut, n, poison), (D, n))
            device_s = time.perf_counter() - t0
            stats["device_s"] += device_s
            global_registry.device_dispatch.observe(
                device_s, {"engine": "scan"})
            global_registry.utilization_seconds.inc(
                {"phase": "readback"}, device_s)
            if table is None:
                # breaker open / launch or readback failed: the WHOLE
                # chunk scalar-completes, bit-identical to the serial
                # ladder's all-HOST fallback
                eng.set_pending_counts(None)
                table = np.full((D, n), HOST, dtype=np.int32)
                global_registry.pipeline_chunks.inc({"path": "fallback"})
                path = "fallback"
            else:
                global_registry.pipeline_chunks.inc({"path": "device"})
                path = "device"
            t0 = time.perf_counter()
            with global_profiler.phase(PHASE_HOST_COMPLETE), \
                    global_tracer.span("scan_host_complete",
                                       parent=scan_ctx, tile=n):
                result = eng.assemble(table, chunk, namespace_labels, ops)
            if on_result is not None:
                on_result(idx, result)
            host_s = time.perf_counter() - t0
            stats["host_s"] += host_s
            global_registry.utilization_seconds.inc(
                {"phase": "host_assemble"}, host_s)
            # fallback chunks never ran on device: no busy sample, or a
            # breaker-open scan would read as ~100% feed starvation
            if path == "device":
                global_starvation.record(busy_s=device_s, assemble_s=host_s)
            stats["timeline"].append({
                "chunk": idx, "path": path, "resources": n,
                "encode_s": round(chunk_encode_s.get(idx, 0.0), 6),
                "device_s": round(device_s, 6),
                "host_s": round(host_s, 6),
                "poison": len(poison) if poison else 0,
            })
            publish_live_ratios()

        def serial_chunk(idx: int) -> None:
            """Encode failed for this chunk: the engine's quarantining
            scan (and, if even that raises, a per-rule ERROR table)
            answers — the pipeline never aborts a scan."""
            chunk = chunks[idx]
            ops = list(operations[idx]) if operations else None
            stats["encode_fallback_chunks"] += 1
            global_registry.pipeline_chunks.inc({"path": "encode_fallback"})
            t0 = time.perf_counter()
            try:
                result = eng.scan(chunk, namespace_labels, ops)
            except Exception:
                rules = [(e.policy_name, e.rule_name)
                         for e in eng.cps.rules]
                result = ScanResult(
                    verdicts=np.full((len(rules), len(chunk)), ERROR,
                                     dtype=np.int32),
                    rules=rules)
                # infrastructure failure, not content truth: callers
                # (cluster/scanner.py) must not verdict-cache these rows
                # — and the rule analytics skip them for the same reason
                result.infra_error = True
            if on_result is not None:
                on_result(idx, result)
            host_s = time.perf_counter() - t0
            stats["host_s"] += host_s
            stats["timeline"].append({
                "chunk": idx, "path": "encode_fallback",
                "resources": len(chunk),
                "encode_s": round(chunk_encode_s.get(idx, 0.0), 6),
                "device_s": 0.0, "host_s": round(host_s, 6),
            })
            publish_live_ratios()

        try:
            done = 0
            while done < len(chunks):
                t_wait0 = time.perf_counter()
                idx, payload = enc_q.get()
                waited = time.perf_counter() - t_wait0
                stats["encode_wait_s"] += waited
                global_profiler.add(PHASE_ENCODE_WAIT, waited)
                global_registry.utilization_seconds.inc(
                    {"phase": "encode_wait"}, waited)
                if not inflight and eng.breaker.state != "open":
                    # nothing on the device while we waited for the
                    # encoder: that wait is pure feed starvation — the
                    # gauge the encode-pool work will be judged against
                    # (an OPEN breaker means there is no device to
                    # starve; those waits are outage time, not feed)
                    stats["starved_s"] += waited
                    global_starvation.record(starved_s=waited)
                done += 1
                if payload is None:
                    # a cross-process mesh's peers are launching this
                    # chunk: join its first collective, failed, before
                    # the in-flight readbacks (their launch order)
                    self.scanner.skip_step()
                    # keep result ordering: everything in flight lands
                    # before the fallback chunk's rows are emitted
                    while inflight:
                        drain()
                    serial_chunk(idx)
                    continue
                batch, n, poison = payload
                t0 = time.perf_counter()
                launched = []

                def launch():
                    launched.append(True)
                    return _launch(self.scanner, batch)

                with global_profiler.phase(PHASE_DISPATCH), \
                        global_tracer.span("scan_dispatch",
                                           parent=scan_ctx, tile=n):
                    handle = eng.guarded_launch(launch)
                if not launched:
                    # the breaker was open or a fault fired first
                    self.scanner.skip_step()
                stats["device_s"] += time.perf_counter() - t0
                inflight.append((idx, handle, n, poison))
                # double buffer: with chunk k launched, the readback +
                # host completion of chunk k-1 overlaps k's device time
                while len(inflight) > 1:
                    drain()
            while inflight:
                drain()
        except BaseException as e:
            stop.set()
            scan_span.set_status("error", f"{type(e).__name__}: {e}")
            raise
        finally:
            stop.set()
            # unblock a worker stuck on a full queue before joining
            while True:
                try:
                    enc_q.get_nowait()
                except queue.Empty:
                    break
            worker.join(timeout=30.0)
            wall = time.perf_counter() - t_wall0
            busy = stats["encode_s"] + stats["device_s"] + stats["host_s"]
            stats["wall_s"] = wall
            stats["overlap_ratio"] = round(
                max(0.0, busy - wall) / wall, 4) if wall > 0 else 0.0
            global_registry.pipeline_overlap.set(stats["overlap_ratio"])
            scan_span.attributes["overlap_ratio"] = stats["overlap_ratio"]
            if pool is not None:
                stats["encode_pool"] = pool.summary()
            global_tracer.end_span(scan_span)
        return stats
