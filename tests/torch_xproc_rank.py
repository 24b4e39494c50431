"""One rank of a cross-process mesh, for tests/test_torch_xproc.py.

Run as ``python torch_xproc_rank.py DIR RANK PORT TIMEOUT_S``: joins a
gloo world of two at 127.0.0.1:PORT, reads ``DIR/input.json`` (a PSS
subset, policy and resource documents) and writes what it computed to
``DIR/rank{RANK}.npz`` and ``DIR/rank{RANK}.json``. Imports the port
only (never JAX or the JAX package):

- ``api``: ``ShardedScanner`` on ``make_mesh_2d(2, 4, ["cpu"] * 4)``:
  ``scan_device``, ``scan``, a cold then a warm ``scan_stream``. Rank 1
  first grows its lane buckets, a choice of its own.
- ``skew``: rank 1 alone fails before the step, once by its encode
  raising in ``scan``, once by a ``tpu.dispatch`` fault; then a
  ``scan_device``. Each rank's fallbacks by reason and its breaker.
- ``service``: ``BackgroundScanService`` on the same mesh, where rank
  0 alone has a third of the resources in its verdict cache; then a
  tick that is clean on rank 0 and has one changed resource on rank 1,
  and a ``scan_device``.
- ``alone``: rank 1 never joins; rank 0's ``scan`` meets the mesh's
  timeout and answers through the scalar engine.

Each rank's op-log goes to ``DIR/rank{RANK}.oplog.jsonl``; its events
are written out with the rest.
"""

from __future__ import annotations

import copy
import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)


def _fallbacks(registry) -> dict:
    return {labels.get("reason"): v
            for labels, v in registry.breaker_fallback.series()}


def _since(registry, before: dict) -> dict:
    now = _fallbacks(registry)
    return {r: v - before.get(r, 0) for r, v in now.items()
            if v != before.get(r, 0)}


def main(out: str, rank: int, port: int, timeout_s: float) -> None:
    from kyverno_tpu_torch.api.policy import ClusterPolicy
    from kyverno_tpu_torch.cluster import (BackgroundScanService,
                                           ClusterSnapshot, PolicyCache)
    from kyverno_tpu_torch.observability.log import global_oplog
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.parallel.sharding import (ShardedScanner,
                                                     make_mesh_2d)
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.policy.autogen import expand_policy
    from kyverno_tpu_torch.resilience.breaker import tpu_breaker
    from kyverno_tpu_torch.resilience.faults import global_faults
    from kyverno_tpu_torch.tpu.engine import TorchEngine

    with open(os.path.join(out, "input.json")) as f:
        doc = json.load(f)
    oplog = os.path.join(out, f"rank{rank}.oplog.jsonl")
    global_oplog.configure(path=oplog)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    mesh = make_mesh_2d(2, 4, ["cpu"] * 4, timeout_s=timeout_s)
    arrays, info = {}, {"local": mesh.local, "world": mesh.world}

    # -- api
    policies = [expand_policy(p)
                for p in load_pss_policies(doc["api_subset"])]
    resources = doc["api_resources"]
    scanner = ShardedScanner(policies, mesh=mesh)
    if rank == 1:
        scanner._vbucket *= 2
        scanner._rbucket = scanner.cps.encode_cfg.max_rows
    arrays["device_v"], arrays["device_c"] = scanner.scan_device(
        copy.deepcopy(resources))
    arrays["scan"] = scanner.scan(copy.deepcopy(resources)).verdicts
    for tag in ("cold", "warm"):
        got, stats = scanner.scan_stream(copy.deepcopy(resources), tile=32)
        arrays[f"stream_{tag}"] = got.verdicts
        info[f"stream_{tag}_tiles"] = stats["tiles"]

    # -- skew: rank 1 alone does not reach the step
    fallbacks0 = _fallbacks(global_registry)
    real = scanner.encode
    if rank == 1:
        calls = []

        def encode(*a, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise ValueError("rank 1's encode fails alone")
            return real(*a, **kw)

        scanner.encode = encode
    arrays["skew_encode"] = scanner.scan(copy.deepcopy(resources)).verdicts
    scanner.encode = real
    if rank == 1:
        global_faults.arm("tpu.dispatch", mode="raise", count=1)
    arrays["skew_fault"] = scanner.scan(copy.deepcopy(resources)).verdicts
    global_faults.disarm()
    info["skew_breaker"] = [tpu_breaker().state,
                            tpu_breaker()._consecutive_failures]
    tpu_breaker().reset()
    arrays["skew_v"], arrays["skew_c"] = scanner.scan_device(
        copy.deepcopy(resources))
    info["skew_failed"] = mesh.failed
    info["skew_fallbacks"] = _since(global_registry, fallbacks0)

    # -- service
    snap, cache = ClusterSnapshot(), PolicyCache()
    for p in doc["service_policies"]:
        cache.set(ClusterPolicy.from_dict(copy.deepcopy(p)))
    for d in doc["service_docs"]:
        snap.upsert(copy.deepcopy(d))
    svc = BackgroundScanService(snap, cache, mesh=mesh, batch_size=32)
    if rank == 0:
        # rank 0 alone: a third of the resources in its verdict cache,
        # keyed as the service keys them
        items = [(r, h) for _, r, h in snap.items()][: len(snap) // 3]
        eng = TorchEngine(cps=svc._get_scanner(cache.revision).cps,
                          device="cpu")
        eng.scan([r for r, _ in items], snap.namespace_labels())
    info["service_scanned"] = svc.scan_once()
    info["service_stats"] = {k: v for k, v in svc.stats.items()
                             if isinstance(v, int)}
    info["service_summary"] = svc.aggregator.summary()
    info["service_results"] = {
        uid: sorted((r.policy, r.rule, r.result) for r in rows)
        for uid, rows in svc.aggregator._per_resource.items()}
    # a clean tick on rank 0 beside one changed resource on rank 1
    if rank == 1:
        changed = copy.deepcopy(doc["service_docs"][-1])
        changed["metadata"].setdefault("labels", {})["touched"] = "1"
        snap.upsert(changed)
    info["clean_scanned"] = svc.scan_once()
    arrays["clean_v"], arrays["clean_c"] = scanner.scan_device(
        copy.deepcopy(resources))

    # -- alone: rank 1 never joins another collective
    if rank == 1:
        deadline = time.monotonic() + 4 * timeout_s + 30
        while not os.path.exists(os.path.join(out, "rank0.json")) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
    else:
        before = _fallbacks(global_registry)
        t0 = time.monotonic()
        arrays["alone"] = scanner.scan(copy.deepcopy(resources)).verdicts
        info["alone_s"] = time.monotonic() - t0
        info["alone_failed"] = mesh.failed
        info["alone_fallbacks"] = _since(global_registry, before)
        info["alone_breaker"] = [tpu_breaker().state,
                                 tpu_breaker()._consecutive_failures]
        info["alone_gauge"] = global_registry.mesh_failed.value()
    with open(oplog) as f:
        info["events"] = [json.loads(line) for line in f]
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    tmp = os.path.join(out, f"rank{rank}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.replace(tmp, os.path.join(out, f"rank{rank}.json"))
    sys.stdout.flush()
    # no process-group teardown: rank 1 never joins rank 0's last
    # collective, so the group is not in a state to be shut down
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4]))
