"""The vocabulary form of a scan tile in the PyTorch port against the
JAX package, on the CPU.

- ``encode/tasks.py:encode_vocab_host`` gives the same host dict (every
  key, dtype, shape and value), live count and buckets, across bucket
  growth.
- ``LaneView`` gives the lanes the JAX ``LaneView`` gives, over index
  tables of width uint8, uint16 and int32, lazily one lane at a time
  (recording) and all at once (kernel K5's path).
- K5's plain twin follows ``jnp.take`` on hostile indices: [-V, 0)
  wraps, outside [-V, V) fills (255, 0xFFFFFFFF, INT_MIN, NaN).
- The lanes the PSS program reads, recorded by one eager run, equal the
  JAX scanner's ``_record_used_keys``.

Every comparison is exact (bit patterns for float lanes)."""

import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kyverno_tpu.encode.tasks import encode_vocab_host as j_encode_vocab_host
from kyverno_tpu.parallel.sharding import ShardedScanner as JScanner
from kyverno_tpu.parallel.sharding import make_mesh
from kyverno_tpu.policies import load_pss_policies
from kyverno_tpu.policy.autogen import expand_policy
from kyverno_tpu.tpu import evaluator as jev
from kyverno_tpu.tpu import flatten as jflat
from kyverno_tpu.tpu.compiler import compile_policy_set as jcompile
from kyverno_tpu.tpu.metadata import MetaConfig as JMetaConfig
from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.encode.tasks import encode_vocab_host
from kyverno_tpu_torch.parallel.sharding import ShardedScanner
from kyverno_tpu_torch.tpu import evaluator as tev
from kyverno_tpu_torch.tpu import flatten as tflat
from kyverno_tpu_torch.tpu.engine import lanes_to_device
from kyverno_tpu_torch.tpu.metadata import MetaConfig

from test_tpu_pss_parity import _resource
from torch_parity_util import assert_lanes_equal, port_policies
from torch_parity_util import fresh_port_state  # noqa: F401


def _pss_resources(seed, n):
    rng = random.Random(seed)
    return ([_resource(rng, i) for i in range(n)],
            [rng.choice(["", "CREATE", "DELETE"]) for _ in range(n)])


@pytest.fixture(scope="module")
def pss_paths():
    cps = jcompile([expand_policy(p) for p in load_pss_policies()])
    return sorted(cps.byte_paths), sorted(cps.key_byte_paths)


@pytest.mark.parametrize("filtered", [False, True])
def test_encode_vocab_host_equals_reference_across_bucket_growth(
        pss_paths, filtered):
    """Batches of growing size and variety from small starting buckets:
    the vocabulary, string and row buckets grow by doubling, in both
    packages alike, and every host lane agrees."""
    bp, kbp = pss_paths
    used = meta_need = None
    if filtered:
        used = {"row_idx", "vocab_valid", "vocab_norm_hi", "vocab_norm_lo",
                "vocab_scope1", "vocab_byte_slot", "pool_sidx",
                "pool_svocab", "pool_slen", "fallback", "meta_fallback",
                "meta_op_code", "meta_kind_h"}
        meta_need = {"fallback", "op_code", "kind_h"}
    jb = tb = (4, 2, 2)
    for step, n in enumerate((3, 17, 40, 90)):
        res, ops = _pss_resources(100 + step, n)
        want, wn, jb = j_encode_vocab_host(
            copy.deepcopy(res), None, ops, jflat.EncodeConfig(), bp, kbp,
            JMetaConfig(), meta_need, used, 1, jb)
        got, gn, tb = encode_vocab_host(
            copy.deepcopy(res), None, ops, tflat.EncodeConfig(), bp, kbp,
            MetaConfig(), meta_need, used, 1, tb)
        assert (gn, tb) == (wn, jb)
        assert_lanes_equal(want, got)
    assert jb[0] > 4 and jb[1] > 2 and jb[2] > 2  # every bucket grew


def _vocab_host(res, vb_bucket, sb_bucket):
    cfg = tflat.EncodeConfig()
    vb = tflat.encode_resources_vocab(copy.deepcopy(res), cfg)
    jvb = jflat.encode_resources_vocab(copy.deepcopy(res),
                                       jflat.EncodeConfig())
    host = vb.to_host(None, vb_bucket, sb_bucket, 64)
    jhost = jvb.to_host(None, vb_bucket, sb_bucket, 64)
    assert_lanes_equal(jhost, host)
    return jhost, host


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


@pytest.mark.parametrize("buckets,idx_dtype,sid_dtype", [
    ((200, 16), np.uint8, np.uint8),
    ((1024, 300), np.uint16, np.uint16),
    ((70000, 70000), np.int32, np.int32),
])
def test_laneview_equals_reference_over_index_widths(buckets, idx_dtype,
                                                     sid_dtype):
    res, _ = _pss_resources(5, 4)
    jhost, host = _vocab_host(res, *buckets)
    assert host["row_idx"].dtype == idx_dtype
    assert host["pool_sidx"].dtype == sid_dtype
    jview = jev.LaneView({k: jnp.asarray(v) for k, v in jhost.items()})
    names = list(tflat._ROW_LANES) + ["pool", "pool_len", "n_rows",
                                      "fallback"]
    lanes = lanes_to_device(host, "cpu")
    lazy = tev.LaneView(lanes, record=True)
    eager = tev.LaneView(lanes)
    for name in names:
        want = _bits(np.asarray(jview[name]))
        for view in (lazy, eager):
            got = view[name].numpy()
            assert got.shape == want.shape, name
            assert np.array_equal(_bits(got), want), name
    assert set(lazy.used_keys) >= {"row_idx", "pool_sidx", "pool_svocab",
                                   "pool_slen", "vocab_norm_hi"}


_DTYPES = [np.uint8, np.uint32, np.int32, np.float32]


@pytest.mark.parametrize("dtype", _DTYPES, ids=[d.__name__ for d in _DTYPES])
def test_vocab_gather_twin_follows_jnp_take_on_hostile_indices(dtype):
    rng = np.random.default_rng(3)
    V = 7
    src = rng.integers(1, 200, size=V).astype(dtype)
    idx32 = np.concatenate([np.arange(-V - 4, V + 5),
                            [2 ** 31 - 1, -2 ** 31]]).astype(np.int32)
    idx32 = np.tile(idx32, (3, 1))
    idx16 = np.array([[0, 6, 7, 300, 65535]], dtype=np.uint16)
    idx8 = np.array([[0, 6, 7, 255]], dtype=np.uint8)
    fill = kernels.TAKE_FILL[np.dtype(dtype)]
    tsrc = lanes_to_device({"s": src}, "cpu")["s"]
    for idx in (idx32, idx16, idx8):
        want = np.asarray(jnp.take(jnp.asarray(src),
                                   jnp.asarray(idx).astype(jnp.int32), axis=0))
        tidx = lanes_to_device({"i": idx}, "cpu")["i"]
        got = kernels.vocab_gather(
            [tsrc], tidx, [fill])[0].numpy()
        assert np.array_equal(_bits(got), _bits(want)), idx.dtype
        alone = kernels.vocab_gather_plain(tsrc, tidx, fill).numpy()
        assert np.array_equal(_bits(alone), _bits(want))


_PLAN_CASES = [  # lanes' numpy dtypes, (n, R) of the index table
    ([np.uint8], (1, 1)),
    ([np.float32, np.uint8, np.int32, np.uint8, np.uint32], (3, 7)),
    ([np.uint8] * 17 + [np.int32] * 23, (5, 13)),
    ([np.uint32, np.float32, np.int32], (4, 16)),
    ([np.uint8, np.int32] * 6, (33, 65)),
    ([np.uint8] * 3, (1, 17)),
    ([np.int32, np.uint8], (2, 255)),
    ([np.float32] * 40, (64, 64)),
]


@pytest.mark.parametrize("index", ["uint8", "uint16", "int32"])
@pytest.mark.parametrize("case", range(len(_PLAN_CASES)))
def test_vocab_plan_with_the_twin_follows_jnp_take(index, case):
    """K5's host plan: the 1-byte lanes first, then the 4-byte lanes,
    each group in its given order; each group's chunks of 256 vectors
    (16 or 4 cells) cover the cells, the last vector partly when the
    cell count is no multiple of it. The lanes in the plan's order,
    each through the plain twin, equal ``jnp.take`` on hostile indices
    (wrapping negatives, past V, the top of each width) at such cell
    counts, lanes of mixed sizes."""
    dtypes, shape = _PLAN_CASES[case]
    rng = np.random.default_rng(case)
    V = 300 if index != "uint8" else 200
    srcs_np = [rng.integers(0, 250, size=V).astype(d) for d in dtypes]
    if index == "uint8":
        idx = rng.integers(0, 256, size=shape).astype(np.uint8)
    elif index == "uint16":
        idx = rng.integers(0, 1 << 16, size=shape).astype(np.uint16)
        idx.flat[0] = 0xFFFF
    else:
        idx = rng.integers(-V - 9, V + 9, size=shape).astype(np.int32)
        idx.flat[-1] = -2 ** 31
    t = lanes_to_device({f"s{i}": a for i, a in enumerate(srcs_np)}
                        | {"i": idx}, "cpu")
    srcs = [t[f"s{i}"] for i in range(len(dtypes))]
    fills = [kernels.TAKE_FILL[np.dtype(d)] for d in dtypes]
    elems = [s.element_size() for s in srcs]
    cells = idx.size
    plan = kernels.VocabPlan(elems, cells)
    n1 = elems.count(1)
    assert plan.n1 == n1
    assert plan.order == ([i for i, e in enumerate(elems) if e == 1]
                          + [i for i, e in enumerate(elems) if e == 4])
    for elem, chunks in ((1, plan.chunks1), (4, plan.chunks4)):
        if elem not in elems:
            assert chunks == 0
            continue
        span = kernels.VOCAB_GATHER_THREADS * kernels.VOCAB_GATHER_VEC[elem]
        assert (chunks - 1) * span < cells <= chunks * span
    jidx = jnp.asarray(idx).astype(jnp.int32)
    for i in plan.order:
        got = kernels.vocab_gather_plain(srcs[i], t["i"], fills[i])
        want = np.asarray(jnp.take(jnp.asarray(srcs_np[i]), jidx, axis=0))
        assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_vocab_plan_lane_limit():
    """At most ``VOCAB_GATHER_MAX_LANES`` (40) lanes, at least one, of 1
    or 4 bytes."""
    assert len(kernels.VocabPlan([4] * 40, 100).order) == 40
    for elems in ([], [1] * 41, [1, 2], [8]):
        with pytest.raises(ValueError):
            kernels.VocabPlan(elems, 100)


def test_vocab_gather_rows_twin_follows_jnp_take_on_hostile_indices():
    rng = np.random.default_rng(4)
    Sv, W = 6, 16
    svocab = rng.integers(0, 255, size=(Sv, W)).astype(np.uint8)
    slen = rng.integers(0, W, size=Sv).astype(np.int32)
    idx = np.array([[0, 5, -1, -6, -7, 6, 1000]], dtype=np.int32)
    t = lanes_to_device({"v": svocab, "l": slen, "i": idx}, "cpu")
    rows, lens = kernels.vocab_gather_rows(t["v"], t["l"], t["i"])
    jidx = jnp.asarray(idx)
    assert np.array_equal(rows.numpy(), np.asarray(
        jnp.take(jnp.asarray(svocab), jidx, axis=0)))
    assert np.array_equal(lens.numpy(), np.asarray(
        jnp.take(jnp.asarray(slen), jidx, axis=0)))
    only_len = kernels.vocab_gather_rows(None, t["l"], t["i"])
    assert only_len[0] is None and torch.equal(only_len[1], lens)


@pytest.fixture(scope="module")
def pss_scanners():
    policies = [expand_policy(p) for p in load_pss_policies()]
    js = JScanner(policies, mesh=make_mesh(jax.devices()[:1]))
    ts = ShardedScanner(port_policies(policies), device="cpu")
    return js, ts


def test_recorded_used_keys_equal_reference(pss_scanners):
    """One eager recording run of the port's program reads exactly the
    lanes the JAX scanner's traced recording run reads."""
    js, ts = pss_scanners
    assert ts._used_keys == js._used_keys
    assert ts._meta_need == js._meta_need
    assert {"vocab_norm_hi", "pool_svocab", "pool_slen"} <= ts._used_keys
