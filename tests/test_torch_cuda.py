"""kyverno_tpu_torch's CUDA kernels on the card, against their plain
PyTorch twins, and the port's scan on the card against its CPU run.

These need an NVIDIA GPU with nvcc (kernels build at first use into
build/kernels/): they carry the ``cuda`` marker and skip elsewhere.
On a machine with the card: ``python -m pytest tests/test_torch_cuda.py``.
Bool and int32 outputs: tolerance 0."""

import random

import numpy as np
import pytest
import torch

from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.policies import load_pss_policies
from kyverno_tpu_torch.policy.autogen import expand_policy
from kyverno_tpu_torch.tpu import dfa as tdfa
from kyverno_tpu_torch.tpu.engine import TorchEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _subjects(seed, S=4096, W=96):
    g = torch.Generator().manual_seed(seed)
    byt = torch.randint(0, 256, (S, W), generator=g, dtype=torch.uint8)
    lens = torch.randint(0, W + 8, (S,), generator=g, dtype=torch.int32)
    return byt, lens


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_dfa_scan_kernel_equals_plain(cuda, stride):
    bank = tdfa.DfaBank(budget=12)
    for p in ("a*b", "nginx-?", "*-suffix-*-mid-*-tail", "localhost/*"):
        bank.add_glob(p, "pool")
    bank.add_re2("^(ab|cd){1,10}x[0-9]{3}$", "pool")
    bank.finalize(stride=stride)
    byt, lens = _subjects(stride)
    ids = bank.families["pool"]
    want = tdfa.bank_match(bank, ids, byt, lens)
    got = tdfa.bank_match(bank, ids, byt.to(cuda), lens.to(cuda))
    assert torch.equal(got.cpu(), want)
    na = tdfa.nonascii_mask(byt.to(cuda), lens.to(cuda))
    assert torch.equal(na.cpu(), kernels.nonascii_plain(byt, lens))


def test_instance_count_kernel_equals_plain(cuda):
    g = torch.Generator().manual_seed(3)
    N, R, I = 512, 256, 16
    pred = torch.rand((N, R), generator=g) < 0.5
    valid = torch.rand((N, R), generator=g) < 0.8
    s1 = torch.randint(-1, I + 3, (N, R), generator=g, dtype=torch.int32)
    s2 = torch.randint(-1, I + 3, (N, R), generator=g, dtype=torch.int32)
    d = [t.to(cuda) for t in (pred, s1, s2, valid)]
    assert torch.equal(kernels.instance_count(d[0], d[1], d[3], I).cpu(),
                       kernels.instance_count_plain(pred, s1, valid, I))
    assert torch.equal(kernels.instance_count2(*d, I).cpu(),
                       kernels.instance_count_plain(pred, s1, valid, I, s2))


def test_verdict_counts_kernel_equals_plain(cuda):
    g = torch.Generator().manual_seed(4)
    table = torch.randint(0, 7, (66, 5000), generator=g, dtype=torch.int32)
    assert torch.equal(kernels.verdict_counts(table.to(cuda)).cpu(),
                       kernels.verdict_counts_plain(table))


def test_pss_scan_on_the_card_equals_cpu(cuda):
    eng = TorchEngine([expand_policy(p) for p in load_pss_policies()])
    rng = random.Random(5)
    pods = []
    for i in range(100):
        sc = {"privileged": rng.random() < 0.3}
        pods.append({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": f"p{i}", "namespace": "d"},
                     "spec": {"containers": [{"name": "c", "image": "nginx",
                                              "securityContext": sc}]}})
    kernels.reset_launches()
    got = eng.scan(pods)
    assert kernels.LAUNCHES["dfa_scan_fused"] > 0
    assert kernels.LAUNCHES["instance_count"] > 0
    assert kernels.LAUNCHES["verdict_counts"] == 1
    want = TorchEngine(cps=eng.cps, device="cpu").scan(pods)
    assert np.array_equal(got.verdicts, want.verdicts)
    assert np.array_equal(got.counts, want.counts)
