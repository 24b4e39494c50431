"""Driver entry points of the port — the counterparts of the reference's
``entry()`` and ``dryrun_multichip(n)`` (``__graft_entry__.py``).

entry():                the one-device program of the flagship workload
                        (the compiled PSS policy set) and example lanes.
dryrun_multichip(n, devices=None):
                        build an n-entry 2-axis mesh of devices of this
                        process, run the FULL sharded scan step on it
                        (resources sharded over both axes, policies and
                        vocabulary lanes replicated, the verdict-count
                        reduction crossing devices) on tiny shapes, and
                        hold it to a one-device run; then stream the
                        same resources through it and elect one scan
                        coordinator among the mesh's hosts.

Both run on the card unless the caller passes CPU devices
(``entry(device="cpu")``, ``dryrun_multichip(8, ["cpu"] * 8)``). A mesh
may name one device more than once (a one-GPU machine:
``["cuda:0"] * 4``); each entry holds one shard.

    python -m kyverno_tpu_torch.dryrun 4 cuda:0 cuda:0 cuda:0 cuda:0
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Sequence


def _policies():
    from .policies import load_pss_policies
    from .policy.autogen import expand_policy

    return [expand_policy(p) for p in load_pss_policies()]


def _tiny_resources(n: int = 16) -> List[Dict[str, Any]]:
    out = []
    for i in range(n):
        sc = {"privileged": i % 3 == 0}
        out.append({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"p{i}", "namespace": "default"},
            "spec": {"containers": [
                {"name": "c", "image": "nginx", "securityContext": sc}]},
        })
    return out


def entry(device=None):
    """Returns (fn, example_args): fn(*example_args) evaluates every
    device-compiled PSS rule against a batch of 16 Pods, giving the
    (rules, 16) int32 verdict table and the (rules, 7) int32 counts."""
    from .tpu.engine import TorchEngine, lanes_to_device

    eng = TorchEngine(_policies(), device=device)
    padded, ops, _ = eng.pad(_tiny_resources(16))
    batch = eng.encode(padded, None, ops)[0]
    fn = eng.cps.device_fn(device=eng.device)
    return fn, (lanes_to_device(batch, eng.device),)


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None
                     ) -> Dict[str, Any]:
    """The sharded scan on an ``n_devices``-entry mesh (default: every
    CUDA device) against one device, exactly; raises when fewer than
    ``n_devices`` devices are given or any check fails. Returns what it
    checked."""
    import numpy as np

    from .cluster.leaderelection import LeaderElector, LeaseStore
    from .parallel import ShardedScanner, make_mesh, make_mesh_2d
    from .parallel.sharding import _devices

    have = _devices(devices)
    if len(have) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(have)}")
    devs = have[:n_devices]

    policies = _policies()
    resources = _tiny_resources(2 * n_devices)

    # the one-device oracle for the verdict-parity check
    single = ShardedScanner(policies, mesh=make_mesh(devs[:1]))
    ref_verdicts, ref_counts = single.scan_device(resources)

    # the 2-axis (hosts, devices-per-host) mesh: resources shard over
    # both axes host-major; the count reduction crosses both
    hosts = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh_2d(hosts, n_devices // hosts, devs)
    _require(mesh.axis_names == ("hosts", "data") and mesh.devices.shape
             == (hosts, n_devices // hosts), f"mesh {mesh}")
    scanner = ShardedScanner(policies, mesh=mesh)
    verdicts, counts = scanner.scan_device(resources)
    _require(verdicts.shape[1] == 2 * n_devices,
             f"table {verdicts.shape} for {2 * n_devices} resources")
    _require(counts.shape == (verdicts.shape[0], ShardedScanner.NUM_CLASSES),
             f"counts {counts.shape}")
    # the mesh must not change results
    _require(np.array_equal(verdicts, ref_verdicts),
             "2-axis mesh verdicts diverge from the one-device run")
    _require(np.array_equal(counts, ref_counts),
             "2-axis mesh counts diverge from the one-device run")
    # privileged pods must fail disallow-privileged-containers
    row = next(i for i, e in enumerate(
        [e for e in scanner.cps.rules if e.device_row is not None])
        if e.policy_name == "disallow-privileged-containers"
        and e.rule_name == "privileged-containers")
    _require(bool((verdicts[row] == 2).any()), "expected failing pods")

    # the streamed scan over the same mesh (the snapshot path), with a
    # leader-elected coordinator owning the report write: every host
    # contends, exactly one writes
    result, stats = scanner.scan_stream(resources, tile=n_devices)
    _require(result.verdicts.shape[1] == len(resources),
             f"scan_stream table {result.verdicts.shape}")
    store = LeaseStore()
    writes: List[int] = []
    electors = [LeaderElector("scan-coordinator", f"host-{h}", store,
                              on_started_leading=lambda h=h: writes.append(h))
                for h in range(hosts)]
    for e in electors:
        e.tick()
    leaders = [e for e in electors if e.is_leader()]
    _require(len(leaders) == 1, "exactly one coordinator must hold the lease")
    _require(len(writes) == 1, f"{len(writes)} coordinators wrote")
    leaders[0].store.release("scan-coordinator", leaders[0].identity)
    return {"devices": [str(d) for d in devs],
            "distinct": [str(d) for d in mesh.distinct],
            "mesh": mesh.shape, "rules": int(verdicts.shape[0]),
            "resources": len(resources), "tiles": stats["tiles"],
            "leader": leaders[0].identity}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    print(dryrun_multichip(n, sys.argv[2:] or None))
