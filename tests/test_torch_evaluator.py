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
from torch_parity_util import fresh_port_state  # noqa: F401


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


# --- kernels K6 (hash_match), K7 (pool_rows), K8 (first_true_take) ---


def _hash_batch(seed, N=19, R=37):
    """uint32 hash lanes drawn from a small pool of values (so constants
    hit), including the bit patterns whose int32 view is negative."""
    rng = np.random.default_rng(seed)
    pool = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 12345,
                     0xDEADBEEF, 0x9E3779B9], dtype=np.uint32)
    hi = pool[rng.integers(0, len(pool), size=(N, R))]
    lo = pool[rng.integers(0, len(pool), size=(N, R))]
    valid = (rng.random((N, R)) < 0.7).astype(np.uint8)
    batch = {"norm_hi": hi, "norm_lo": lo, "repr_hi": lo.copy(),
             "repr_lo": hi.copy(), "valid": valid}
    return batch, pool


def _ctxs(batch):
    jctx = jev.Ctx({k: jnp.asarray(v) for k, v in batch.items()}, 4)
    tctx = tev.Ctx(lanes_to_device(batch, "cpu"), 4)
    return jctx, tctx


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_match_twin_equals_reference_masks(seed):
    batch, pool = _hash_batch(seed)
    jctx, tctx = _ctxs(batch)
    rng = np.random.default_rng(seed + 10)
    hashes = [int(pool[a]) << 32 | int(pool[b])
              for a, b in rng.integers(0, len(pool), size=(40, 2))]
    for lane in ("norm", "repr"):
        for h in hashes[:6]:
            assert np.array_equal(tctx.heq(lane, h).numpy(),
                                  np.asarray(jctx.heq(lane, h)))
            assert np.array_equal(tctx._mask(h, lane).numpy(),
                                  np.asarray(jctx._mask(h, lane)))
        # sets of size 0, 1, a few and many
        for k in (0, 1, 5, 40):
            want = np.asarray(jctx.hset(lane, hashes[:k]))
            got = tctx.hset(lane, hashes[:k]).numpy()
            assert got.dtype == np.bool_ and np.array_equal(got, want)
    # one (k, 2) constant table per distinct set, reused on a repeat
    tables = dict(tctx._hash_consts)
    tctx.hset("norm", hashes[:5])
    assert tctx._hash_consts == tables
    assert {t.shape for t in tables.values()} >= {(0, 2), (1, 2), (40, 2)}


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_rows_twin_equals_reference(seed):
    rng = np.random.default_rng(seed)
    N, R, K = 13, 29, 6
    # slots -1 (no slot), in range, and past K - 1 (clipped)
    slot = rng.integers(-1, K + 3, size=(N, R)).astype(np.int32)
    batch = {"norm_hi": np.zeros((N, R), np.uint32),
             "valid": np.ones((N, R), np.uint8), "byte_slot": slot,
             "key_byte_slot": np.flip(slot, axis=1).copy()}
    jctx, tctx = _ctxs(batch)
    accepts = rng.random((N, K, 3)) < 0.5  # a bank's (N, K, patterns)
    for p in range(3):
        plane = accepts[..., p]
        tplane = torch.from_numpy(accepts)[..., p]  # a strided column
        for lane in ("byte_slot", "key_byte_slot"):
            want = np.asarray(jctx._rows_from_pool(jnp.asarray(plane), lane))
            got = tctx._rows_from_pool(tplane, lane).numpy()
            assert np.array_equal(got, want)
            assert np.array_equal(kernels.pool_rows_plain(
                tplane.contiguous(), torch.from_numpy(batch[lane])).numpy(),
                want)


@pytest.mark.parametrize("R", [1, 3, 130])
@pytest.mark.parametrize("K", [1, 32, 33, 200])
def test_pool_rows_twin_equals_reference_at_kernel_forms(R, K):
    """K7's twin against the reference ``_rows_from_pool`` at the row
    counts and plane widths that pick the kernel's forms (R no multiple
    of 4; K in one, two and eight mask words), on a strided plane, with
    INT_MIN, -1 and out-of-range slots."""
    rng = np.random.default_rng(R * 1000 + K)
    N = 9
    slot = rng.integers(-1, K + 5, size=(N, R)).astype(np.int32)
    slot[0, 0] = -2 ** 31
    slot[-1, -1] = 2 ** 31 - 1
    batch = {"norm_hi": np.zeros((N, R), np.uint32),
             "valid": np.ones((N, R), np.uint8), "byte_slot": slot,
             "key_byte_slot": np.flip(slot, axis=1).copy()}
    jctx, tctx = _ctxs(batch)
    accepts = rng.random((N, K, 2)) < 0.5
    for p in range(2):
        tplane = torch.from_numpy(accepts)[..., p]  # strides (2K, 2)
        for lane in ("byte_slot", "key_byte_slot"):
            want = np.asarray(jctx._rows_from_pool(
                jnp.asarray(accepts[..., p]), lane))
            assert np.array_equal(tctx._rows_from_pool(tplane, lane).numpy(),
                                  want)
    words = kernels.pool_rows_words(K)
    assert words in (1, 2, 4, 8) and 32 * (words // 2) < K <= 32 * words
    assert "registers" in kernels.pool_rows_form(tplane, tctx.b["byte_slot"])
    assert kernels.pool_rows_words(257) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_true_take_twin_equals_reference(seed):
    """has / val_ok as _eval_wildcard_anchor computes them: any true
    row, and pred at jnp.argmax's first true row — row 0 when no row is
    true (all-false rows included on purpose)."""
    rng = np.random.default_rng(seed)
    N, R = 31, 45
    accept = rng.random((N, R)) < 0.04
    accept[:5] = False
    accept[5, -1] = True
    pred = rng.random((N, R)) < 0.5
    ja, jp = jnp.asarray(accept), jnp.asarray(pred)
    want_has = np.asarray(ja.any(axis=-1))
    idx = jnp.argmax(ja, axis=-1)
    want_val = np.asarray(jnp.take_along_axis(jp, idx[:, None], axis=-1)[:, 0])
    has, val_ok = kernels.first_true_take(torch.from_numpy(accept),
                                          torch.from_numpy(pred))
    assert np.array_equal(has.numpy(), want_has)
    assert np.array_equal(val_ok.numpy(), want_val)
    assert np.array_equal(val_ok.numpy()[:5], pred[:5, 0])


def test_wildcard_anchor_program_equals_reference():
    """The PSS apparmor rule (a wildcard metadata-key anchor, K8's
    caller) through both programs on resources whose annotations match
    none, one or several keys."""
    from kyverno_tpu.policies import load_pss_policies
    from kyverno_tpu.policy.autogen import expand_policy

    pols = [expand_policy(p) for p in load_pss_policies("restrict-apparmor")]
    jeng = TpuEngine(cps=jcompile(pols))
    teng = port_engine(jeng)
    key = "container.apparmor.security.beta.kubernetes.io/"
    annots = [{}, {"other": "x"}, {key + "a": "runtime/default"},
              {key + "a": "unconfined"},
              {"z": "1", key + "b": "localhost/p", key + "a": "unconfined"},
              {key + "a": "runtime/default", key + "b": "unconfined"}]
    pods = [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}", "namespace": "d",
                          "annotations": a},
             "spec": {"containers": [{"name": "c", "image": "nginx"}]}}
            for i, a in enumerate(annots)]
    batch = jeng.encode(pods + [{}] * 10)[0]
    jtab, _ = jeng.cps.device_fn()(batch)
    ttab, _ = teng.cps.device_fn()(lanes_to_device(batch, "cpu"))
    assert np.array_equal(ttab.numpy(), np.asarray(jtab))
    assert len(set(np.asarray(jtab)[:, :6].ravel().tolist())) > 1
