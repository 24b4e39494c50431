"""kyverno_tpu_torch/tpu/evaluator.py against kyverno_tpu/tpu/evaluator.py.

Kernel K3 (per-instance counts) must count what the reference's
``InstScope.count`` / ``Inst2Scope.count`` one-hot einsums count —
including rows whose scope is -1 or >= I and rows with valid = 0 — and
kernel K4 (verdict-class counts) what ``build_program``'s counts are.
Here both run as their plain PyTorch twins (CPU tensors). The port's
whole ``build_program`` is held against the reference's on the same
encoded batch. Integer and bool outputs: tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kyverno_tpu.tpu import evaluator as jev
from kyverno_tpu.tpu.compiler import compile_policy_set as jcompile
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.tpu import evaluator as tev
from kyverno_tpu_torch.tpu.engine import lanes_to_device

from test_tpu_parity import (CAPABILITIES_DENY_RULE, HOST_NS_RULE,
                             PRIVILEGED_RULE, SECCOMP_RULE, VOLUME_TYPES_RULE,
                             make_policy)
from torch_parity_util import port_engine


def _scope_batch(seed, N=24, R=40, I=16):
    rng = np.random.default_rng(seed)
    # scopes span -1 (padding), [0, I) and >= I (overflowed instances)
    s1 = rng.integers(-1, I + 3, size=(N, R)).astype(np.int32)
    s2 = rng.integers(-1, I + 3, size=(N, R)).astype(np.int32)
    valid = (rng.random((N, R)) < 0.8).astype(np.uint8)
    pred = rng.random((N, R)) < 0.5
    batch = {"norm_hi": np.zeros((N, R), np.uint32), "valid": valid,
             "scope1": s1, "scope2": s2}
    return batch, pred


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("I", [4, 16])
def test_instance_count_equals_reference(seed, I):
    batch, pred = _scope_batch(seed, I=I)
    ctx = jev.Ctx({k: jnp.asarray(v) for k, v in batch.items()}, I)
    want1 = np.asarray(jev.InstScope(ctx).count(jnp.asarray(pred)))
    want2 = np.asarray(jev.Inst2Scope(ctx).count(jnp.asarray(pred)))
    # f32 sums of 0/1 below 2**24 are integers
    assert np.array_equal(want1, np.round(want1))
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    tpred = torch.from_numpy(pred)
    valid = t["valid"] != 0
    got1 = kernels.instance_count(tpred, t["scope1"], valid, I)
    got2 = kernels.instance_count2(tpred, t["scope1"], t["scope2"], valid, I)
    assert got1.dtype == torch.int32 and got2.dtype == torch.int32
    assert np.array_equal(got1.numpy(), want1.astype(np.int32))
    assert np.array_equal(got2.numpy(), want2.astype(np.int32))
    # the port's scopes reach the same counts and the same any()
    tctx = tev.Ctx(t, I)
    assert torch.equal(tev.InstScope(tctx).count(tpred), got1)
    assert np.array_equal(tev.InstScope(tctx).any(tpred).numpy(),
                          np.asarray(jev.InstScope(ctx).any(jnp.asarray(pred))))
    assert np.array_equal(tev.Inst2Scope(tctx).any(tpred).numpy(),
                          np.asarray(jev.Inst2Scope(ctx).any(jnp.asarray(pred))))


@pytest.mark.parametrize("seed", [0, 1])
def test_verdict_counts_equal_reference_formula(seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 7, size=(9, 301)).astype(np.int32)
    want = np.stack([(table == c).sum(axis=1) for c in range(7)], axis=-1)
    got = kernels.verdict_counts(torch.from_numpy(table))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def _pods(seed, n=23):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sc = {}
        if rng.random() < 0.5:
            sc["privileged"] = bool(rng.random() < 0.5)
        if rng.random() < 0.3:
            sc["capabilities"] = {"add": ["SYS_ADMIN"] if rng.random() < 0.5
                                  else ["NET_BIND_SERVICE"]}
        if rng.random() < 0.3:
            sc["seccompProfile"] = {"type": ["RuntimeDefault", "Unconfined"][
                int(rng.integers(0, 2))]}
        spec = {"containers": [{"name": f"c{j}", "image": "nginx",
                                "securityContext": sc}
                               for j in range(int(rng.integers(1, 4)))]}
        if rng.random() < 0.3:
            spec["hostPID"] = bool(rng.random() < 0.5)
        if rng.random() < 0.3:
            spec["volumes"] = [{"name": "v", "hostPath": {"path": "/"}}]
        out.append({"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": f"p{i}", "namespace": "default"},
                    "spec": spec})
    return out


@pytest.fixture(scope="module")
def small_set():
    pols = [make_policy("p1", [HOST_NS_RULE, PRIVILEGED_RULE]),
            make_policy("p2", [SECCOMP_RULE, CAPABILITIES_DENY_RULE,
                               VOLUME_TYPES_RULE])]
    jeng = TpuEngine(cps=jcompile(pols))
    return jeng, port_engine(jeng)


@pytest.mark.parametrize("seed", [3, 4])
def test_build_program_equals_reference(small_set, seed):
    """The whole program on one encoded batch: the reference's jitted
    ``build_program(with_counts=True)`` vs the port's, table and counts
    (K4 over the port's own table)."""
    jeng, teng = small_set
    pods = _pods(seed) + [{}] * 9  # pad columns, as a bucket adds
    batch = jeng.encode(pods)[0]
    jtab, jcnt = jeng.cps.device_fn()(batch)
    ttab, tcnt = teng.cps.device_fn()(lanes_to_device(batch, "cpu"))
    assert ttab.dtype == torch.int32 and tcnt.dtype == torch.int32
    assert np.array_equal(ttab.numpy(), np.asarray(jtab))
    assert np.array_equal(tcnt.numpy(), np.asarray(jcnt))
    # plain twins on demand give the same program
    ptab, pcnt = teng.cps.device_fn(plain=True)(lanes_to_device(batch, "cpu"))
    assert torch.equal(ptab, ttab) and torch.equal(pcnt, tcnt)
    assert np.array_equal(kernels.verdict_counts(torch.from_numpy(
        np.array(jtab))).numpy(), np.asarray(jcnt))


def test_hash_constants_fold_to_int32_bit_patterns():
    assert tev._i32(0) == 0 and tev._i32(0x7FFFFFFF) == 0x7FFFFFFF
    assert tev._i32(0x80000000) == -(1 << 31) and tev._i32(0xFFFFFFFF) == -1
    lane = np.array([0, 1, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    t = lanes_to_device({"x": lane}, "cpu")["x"]
    assert t.dtype == torch.int32
    for v in lane.tolist():
        assert (t == tev._i32(v)).numpy().tolist() == (lane == v).tolist()
