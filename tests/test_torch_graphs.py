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
