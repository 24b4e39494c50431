"""The CUDA-graphed programs (``tpu/graphs.py``) are built only for a
CUDA device: on the CPU, and for the plain-twin program anywhere, the
compiled set hands out its eager program and the scanner its eager
step, and a scan builds no ``GraphedProgram``. (Replays themselves need
the card: tests/test_torch_cuda.py.)"""

import pytest

from kyverno_tpu_torch.parallel.sharding import ShardedScanner
from kyverno_tpu_torch.policies import load_pss_policies
from kyverno_tpu_torch.policy.autogen import expand_policy
from kyverno_tpu_torch.tpu import graphs
from kyverno_tpu_torch.tpu.engine import TorchEngine

from torch_parity_util import fresh_port_state  # noqa: F401 - autouse


def test_no_graph_for_the_cpu_or_the_plain_program(monkeypatch):
    def refuse(self, run):
        raise AssertionError("a GraphedProgram was built")

    monkeypatch.setattr(graphs.GraphedProgram, "__init__", refuse)
    policies = [expand_policy(p)
                for p in load_pss_policies("disallow-privileged")]
    eng = TorchEngine(policies, device="cpu")
    cps = eng.cps
    eager = cps.device_fn()
    assert cps.device_fn(device="cpu") is eager
    assert cps.device_fn(plain=True, device="cuda") is cps.device_fn(plain=True)
    assert cps.mutate_device_fn(device="cpu") is cps.mutate_device_fn()
    assert cps.mutate_device_fn(plain=True, device="cuda") is \
        cps.mutate_device_fn(plain=True)
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "p", "namespace": "d"},
           "spec": {"containers": [{"name": "c", "image": "nginx",
                                    "securityContext": {"privileged": True}}]}}
    assert eng.scan([pod]).verdicts.shape[1] == 1
    eng.triage_mutate([pod])
    sc = ShardedScanner(policies, device="cpu")
    assert sc.step_jitted() is sc._step and not isinstance(
        sc.step_jitted(), graphs.GraphedProgram)
    assert sc.scan([pod]).verdicts.shape[1] == 1
    assert not cps.device_fn().__dict__.get("graphed")
    assert not cps.mutate_device_fn().__dict__.get("graphed")


def test_graphed_program_refuses_cpu_lanes():
    import torch

    g = graphs.GraphedProgram(lambda lanes: lanes["x"])
    for _ in range(2):
        with pytest.raises(ValueError, match="CUDA"):
            g({"x": torch.zeros(3)})
    assert g.captures == 0 and g.run({"x": torch.ones(2)}).sum() == 2


def test_launch_counts_stay_exact_under_threads_and_a_capture():
    """``kernels.count_launch`` from more threads than cores, with the
    interpreter switching threads every microsecond, loses no launch;
    a thread counting into its own dict (a capture, ``counting_into``)
    takes nothing from the others and gives them nothing."""
    import sys
    import threading

    from kyverno_tpu_torch import kernels

    n_threads, per = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.reset_launches()
        captured = {}
        go = threading.Barrier(n_threads + 1)

        def launches():
            go.wait(timeout=30)
            for _ in range(per):
                kernels.count_launch("row_fold")
                kernels.count_launch("class_fold", 2)

        def capture():
            with kernels.counting_into(captured):
                go.wait(timeout=30)
                for _ in range(per):
                    kernels.count_launch("row_fold")

        threads = [threading.Thread(target=launches)
                   for _ in range(n_threads - 1)]
        threads.append(threading.Thread(target=capture))
        for th in threads:
            th.start()
        go.wait(timeout=30)
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.LAUNCHES["row_fold"] == (n_threads - 1) * per
    assert kernels.LAUNCHES["class_fold"] == 2 * (n_threads - 1) * per
    assert captured == {"row_fold": per}
    kernels.reset_launches()


def test_warm_buckets_dispatches_past_the_verdict_cache(monkeypatch):
    """Two dispatches a bucket even with the verdict cache on (a repeat
    scan of the same empty resources would be served from it and never
    reach a graph's capture); a size that is no bucket is refused."""
    from kyverno_tpu_torch.tpu.cache import global_verdict_cache

    policies = [expand_policy(p)
                for p in load_pss_policies("disallow-privileged")]
    eng = TorchEngine(policies, device="cpu")
    seen = []
    real = eng.run
    monkeypatch.setattr(eng, "run", lambda lanes: seen.append(
        lanes["valid"].shape[0]) or real(lanes))
    assert global_verdict_cache.enabled
    eng.warm_buckets([16, 32])
    assert seen == [16, 16, 32, 32]
    with pytest.raises(ValueError, match="bucket"):
        eng.warm_buckets([24])


def test_admission_batches_share_one_lane_key_a_bucket():
    """At the admission engine's max_rows 128, every batch of a bucket
    (any content, any live count, the empty warm-up batch) has one lane
    key, so one capture a bucket serves all traffic."""
    import random

    from chip_smoke import workload
    from kyverno_tpu_torch.tpu.engine import lanes_to_device
    from kyverno_tpu_torch.tpu.flatten import EncodeConfig

    eng = TorchEngine([expand_policy(p) for p in load_pss_policies()],
                      device="cpu", encode_cfg=EncodeConfig(max_rows=128))
    resources, _ = workload(256, 3)
    rng = random.Random(4)

    def key(batch, ops=None):
        padded, pops, _ = eng.pad(batch, ops)
        return graphs.GraphedProgram.key(lanes_to_device(
            eng.encode(padded, None, pops)[0], "cpu"))

    for b in (16, 32, 64):
        keys = {key([{}] * b)}
        for _ in range(4):
            n = rng.randint(b // 2 + 1, b)
            keys.add(key(rng.sample(resources, n), ["CREATE"] * n))
        assert len(keys) == 1, b
        assert next(iter(keys))[0][1][0] == b
