"""The port's columnar resource store (kyverno_tpu_torch/cluster/
columnar.py) against the JAX package's, on the CPU — the counterparts
of tests/test_columnar.py (its ClusterSnapshot, scan-service and
webhook tests wait for those modules).

Tolerance: exact. Every row the store serves — gathered, diffed,
composed, restored from the mmap tier — equals a fresh full-walk encode
of the same object, in both packages, and the port's entries equal the
JAX package's. A warm rescan walks no JSON and encodes no segment; a
truncated or corrupt mmap file rebuilds an empty table; the port's
scanner and engine give the JAX package's verdicts with the store on
and off."""

import copy
import json
import os

import numpy as np
import pytest

from kyverno_tpu.cluster import columnar as jcol
from kyverno_tpu.parallel.sharding import ShardedScanner as JScanner
from kyverno_tpu.parallel.sharding import make_mesh
from kyverno_tpu.policies import load_pss_policies
from kyverno_tpu.policy.autogen import expand_policy
from kyverno_tpu.tpu import cache as jcache
from kyverno_tpu.tpu import flatten as jflat
from kyverno_tpu_torch.cluster.columnar import (ColumnarStore,
                                                configure_store, get_store,
                                                reset_store, store_state,
                                                subtree_hash)
from kyverno_tpu_torch.observability.metrics import global_registry as reg
from kyverno_tpu_torch.parallel.sharding import ShardedScanner
from kyverno_tpu_torch.tpu.cache import (apply_rows, apply_rows_multi,
                                         extract_rows, resource_content_hash)
from kyverno_tpu_torch.tpu.engine import TorchEngine
from kyverno_tpu_torch.tpu.flatten import (EncodeConfig, RowBatch,
                                           encode_resources,
                                           encode_resources_vocab)
from kyverno_tpu_torch.tpu.hashing import hash_path

from torch_parity_util import port_policies
from torch_parity_util import fresh_port_state  # noqa: F401


@pytest.fixture(autouse=True)
def _no_jax_store():
    jcol.reset_store()
    yield
    jcol.reset_store()


def make_pod(i=0, **spec_extra):
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": f"p{i}", "namespace": "default",
                     "uid": f"uid-{i}", "labels": {"app": f"a{i % 3}"}},
        "spec": {"containers": [
            {"name": "c", "image": "nginx:1.25",
             "securityContext": {"privileged": i % 2 == 0}}],
            **spec_extra},
    }


BP = {hash_path(("spec", "containers", "[]", "image"))}
KBP = {hash_path(("metadata", "labels"))}


def entries_equal(a, b):
    assert a.n_rows == b.n_rows
    assert a.fallback == b.fallback
    assert set(a.lanes) == set(b.lanes)
    for name in b.lanes:
        assert np.array_equal(a.lanes[name], b.lanes[name]), name
    if b.pool is None:
        assert a.pool is None
    else:
        assert np.array_equal(a.pool, b.pool)
        assert np.array_equal(a.pool_len, b.pool_len)


def fresh_entry(res, cfg, bp=(), kbp=()):
    return extract_rows(encode_resources([res], cfg, bp, kbp), 0)


def jax_fresh_entry(res, cfg, bp=(), kbp=()):
    jcfg = jflat.EncodeConfig(cfg.max_rows, cfg.max_instances,
                              cfg.byte_pool_slots, cfg.byte_pool_width)
    return jcache.extract_rows(jflat.encode_resources([res], jcfg, bp, kbp),
                               0)


def _diff_roundtrip(store, subhash, cfg, r_old, r_new, bp, kbp):
    store.warm(cfg, bp, kbp, r_old, resource_content_hash(r_old),
               uid="u", subhashes={k: subhash(v) for k, v in r_old.items()})
    store.warm(cfg, bp, kbp, r_new, resource_content_hash(r_new),
               uid="u", subhashes={k: subhash(v) for k, v in r_new.items()})
    return store.get_entry(store.encode_key(cfg, bp, kbp),
                           resource_content_hash(r_new))


def diff_both(cfg, r_old, r_new, bp=(), kbp=()):
    """The port's diffed entry of ``r_new`` (after ``r_old``), checked
    against a fresh encode of ``r_new`` and against the JAX store's
    diffed entry."""
    got = _diff_roundtrip(ColumnarStore(), subtree_hash, cfg, r_old, r_new,
                          bp, kbp)
    jcfg = jflat.EncodeConfig(cfg.max_rows, cfg.max_instances,
                              cfg.byte_pool_slots, cfg.byte_pool_width)
    want = _diff_roundtrip(jcol.ColumnarStore(), jcol.subtree_hash, jcfg,
                           r_old, r_new, bp, kbp)
    entries_equal(got, fresh_entry(r_new, cfg, bp, kbp))
    entries_equal(got, want)
    return got


def test_diff_value_type_change_equals_reference():
    r_old = make_pod(1, hostNetwork=True)
    r_new = copy.deepcopy(r_old)
    r_new["spec"]["hostNetwork"] = "true"
    diff_both(EncodeConfig(), r_old, r_new, BP, KBP)


def test_diff_array_length_change_equals_reference():
    r_old = make_pod(2)
    r_new = copy.deepcopy(r_old)
    r_new["spec"]["containers"].append(
        {"name": "c2", "image": "redis:7", "ports": [{"containerPort": 1}]})
    diff_both(EncodeConfig(), r_old, r_new, BP, KBP)


def test_diff_label_key_deleted_equals_reference():
    r_old = make_pod(3)
    r_new = copy.deepcopy(r_old)
    del r_new["metadata"]["labels"]["app"]
    diff_both(EncodeConfig(), r_old, r_new, BP, KBP)


def test_diff_path_moves_in_and_out_of_byte_pool():
    cfg = EncodeConfig()
    r_old = make_pod(4)
    r_old["metadata"]["labels"]["z"] = "pooled-via-wildcard"
    r_new = copy.deepcopy(r_old)
    r_new["spec"]["containers"] = []
    diff_both(cfg, r_old, r_new, BP, KBP)
    store = ColumnarStore()
    for r in (r_old, r_new, r_old):
        store.warm(cfg, BP, KBP, r, resource_content_hash(r), uid="u",
                   subhashes={k: subtree_hash(v) for k, v in r.items()})
    e2 = store.get_entry(store.encode_key(cfg, BP, KBP),
                         resource_content_hash(r_old))
    entries_equal(e2, fresh_entry(r_old, cfg, BP, KBP))
    entries_equal(e2, jax_fresh_entry(r_old, cfg, BP, KBP))


def test_diff_row_cap_overflow_equals_reference():
    cfg = EncodeConfig(max_rows=24)
    r_old = make_pod(5)
    r_new = copy.deepcopy(r_old)
    r_new["status"] = {"conditions": [{"type": f"t{j}", "status": "True"}
                                      for j in range(10)]}
    got = diff_both(cfg, r_old, r_new)
    assert got.fallback == 1


def test_diff_reencodes_only_touched_subtrees():
    cfg = EncodeConfig()
    store = ColumnarStore()
    r1 = make_pod(6)
    store.warm(cfg, (), (), r1, resource_content_hash(r1), uid="u6",
               subhashes={k: subtree_hash(v) for k, v in r1.items()})
    r2 = copy.deepcopy(r1)
    r2["spec"]["hostNetwork"] = True
    s0 = reg.encode_diff_segments.value()
    u0 = reg.columnar_segments_reused.value()
    w0 = reg.encode_json_walks.value()
    store.warm(cfg, (), (), r2, resource_content_hash(r2), uid="u6",
               subhashes={k: subtree_hash(v) for k, v in r2.items()})
    assert reg.encode_json_walks.value() == w0
    assert reg.encode_diff_segments.value() - s0 == 1
    assert reg.columnar_segments_reused.value() - u0 == 3


def densified(vb):
    out = {name: arr[vb.row_idx] for name, arr in vb.lanes.items()}
    strs = {i: s for i, s in enumerate(vb.strs)}
    pools = [[strs[int(s)] for s in row] for row in vb.pool_sidx]
    return out, pools


def assert_vocab_equal(got, want):
    a, pa = densified(got)
    b, pb = densified(want)
    assert set(a) == set(b)
    for name in b:
        assert np.array_equal(a[name], b[name]), name
    assert pa == pb
    assert np.array_equal(got.n_rows, want.n_rows)
    assert np.array_equal(got.fallback, want.fallback)


def test_vocab_from_store_equals_reference():
    cfg = EncodeConfig()
    res = [make_pod(i) for i in range(6)] + [{}]
    res[2]["spec"]["volumes"] = [{"name": "v", "hostPath": {}}]
    vb_store = ColumnarStore().encode_vocab(res, cfg, BP, KBP)
    assert_vocab_equal(vb_store, encode_resources_vocab(res, cfg, BP, KBP))
    assert_vocab_equal(vb_store, jcol.ColumnarStore().encode_vocab(
        res, jflat.EncodeConfig(), BP, KBP))


def test_warm_rescan_zero_feed_work():
    cfg = EncodeConfig()
    res = [make_pod(i) for i in range(8)]
    store = ColumnarStore()
    store.encode_vocab(res, cfg, BP, KBP)
    w0 = reg.encode_json_walks.value()
    s0 = reg.encode_diff_segments.value()
    vb = store.encode_vocab(res, cfg, BP, KBP)
    assert reg.encode_json_walks.value() == w0
    assert reg.encode_diff_segments.value() == s0
    assert int(vb.n_rows.sum()) > 0


def test_scan_verdicts_store_on_off_equal_reference():
    pols = [expand_policy(p) for p in load_pss_policies()][:3]
    res = [make_pod(i) for i in range(12)]
    res[1]["spec"]["hostNetwork"] = True
    want = JScanner(pols, mesh=make_mesh()).scan(copy.deepcopy(res))
    reset_store()
    off = ShardedScanner(port_policies(pols), device="cpu").scan(
        copy.deepcopy(res))
    configure_store(enabled=True)
    on = ShardedScanner(port_policies(pols), device="cpu").scan(
        copy.deepcopy(res))
    assert off.rules == on.rules == want.rules
    assert np.array_equal(off.verdicts, want.verdicts)
    assert np.array_equal(on.verdicts, want.verdicts)
    w0 = reg.encode_json_walks.value()
    s0 = reg.encode_diff_segments.value()
    on2 = ShardedScanner(port_policies(pols), device="cpu").scan(
        copy.deepcopy(res))
    assert np.array_equal(on2.verdicts, want.verdicts)
    assert reg.encode_json_walks.value() == w0
    assert reg.encode_diff_segments.value() == s0


def test_apply_rows_multi_equals_loop():
    cfg = EncodeConfig()
    res = [make_pod(i) for i in range(7)]
    res[3] = {"weird": [1, "x", None, {"deep": {"er": True}}]}
    src = encode_resources(res, cfg, BP, KBP)
    entries = [extract_rows(src, i) for i in range(len(res))]
    idxs = [5, 0, 3, 7, 2, 9, 6]
    loop = RowBatch(10, cfg)
    for e, i in zip(entries, idxs):
        apply_rows(e, loop, i)
    multi = RowBatch(10, cfg)
    apply_rows_multi(entries, multi, idxs)
    jsrc = jflat.encode_resources(res, jflat.EncodeConfig(), BP, KBP)
    jmulti = jflat.RowBatch(10, jflat.EncodeConfig())
    jcache.apply_rows_multi([jcache.extract_rows(jsrc, i)
                             for i in range(len(res))], jmulti, idxs)
    la, ma, ja = loop.arrays(), multi.arrays(), jmulti.arrays()
    for name in la:
        assert np.array_equal(la[name], ma[name]), name
        assert np.array_equal(ma[name], ja[name]), name


def test_apply_rows_multi_single_and_empty():
    cfg = EncodeConfig()
    e = extract_rows(encode_resources([make_pod(0)], cfg), 0)
    b1, b2 = RowBatch(2, cfg), RowBatch(2, cfg)
    apply_rows(e, b1, 1)
    apply_rows_multi([e], b2, [1])
    for name, arr in b1.arrays().items():
        assert np.array_equal(arr, b2.arrays()[name]), name
    apply_rows_multi([], RowBatch(1, cfg), [])


def test_engine_encode_rows_uses_store_tier():
    from kyverno_tpu.tpu.engine import TpuEngine
    from kyverno_tpu_torch.tpu.cache import global_encode_cache

    pols = [expand_policy(p) for p in load_pss_policies()][:2]
    res = [make_pod(i) for i in range(4)]
    configure_store(enabled=True)
    eng = TorchEngine(port_policies(pols), device="cpu")
    rows1 = eng._encode_rows(copy.deepcopy(res))
    global_encode_cache.clear()
    h0 = reg.columnar_store.value({"outcome": "hit"})
    w0 = reg.encode_json_walks.value()
    rows2 = eng._encode_rows(copy.deepcopy(res))
    assert reg.columnar_store.value({"outcome": "hit"}) - h0 == len(res)
    assert reg.encode_json_walks.value() == w0
    want = TpuEngine(pols)._encode_rows(copy.deepcopy(res)).arrays()
    a, b = rows1.arrays(), rows2.arrays()
    for name in a:
        assert np.array_equal(a[name], b[name]), name
        assert np.array_equal(a[name], want[name]), name


def test_mmap_store_roundtrip(tmp_path):
    cfg = EncodeConfig()
    res = [make_pod(i) for i in range(5)]
    d = str(tmp_path / "col")
    s1 = ColumnarStore(directory=d)
    vb1 = s1.encode_vocab(res, cfg, BP, KBP)
    s1.sync()
    s2 = ColumnarStore(directory=d)
    w0 = reg.encode_json_walks.value()
    s0 = reg.encode_diff_segments.value()
    vb2 = s2.encode_vocab(res, cfg, BP, KBP)
    assert reg.encode_json_walks.value() == w0
    assert reg.encode_diff_segments.value() == s0
    assert_vocab_equal(vb2, vb1)
    # the JAX package's store reads the port's files alike
    vb3 = jcol.ColumnarStore(directory=d).encode_vocab(
        res, jflat.EncodeConfig(), BP, KBP)
    assert_vocab_equal(vb3, vb1)


@pytest.mark.parametrize("corruption", ["truncate", "garbage_manifest",
                                        "flip_bytes", "missing_lane",
                                        "tamper_offsets"])
def test_mmap_corruption_rebuilds_never_crashes(tmp_path, corruption):
    cfg = EncodeConfig()
    res = [make_pod(i) for i in range(4)]
    d = str(tmp_path / "col")
    s1 = ColumnarStore(directory=d)
    s1.encode_vocab(res, cfg, BP, KBP)
    s1.sync()
    (tdir,) = [os.path.join(d, n) for n in os.listdir(d)
               if os.path.isdir(os.path.join(d, n))]
    if corruption == "truncate":
        with open(os.path.join(tdir, "lane_norm_hi.bin"), "r+b") as f:
            f.truncate(4)
    elif corruption == "garbage_manifest":
        with open(os.path.join(tdir, "manifest.json"), "w") as f:
            f.write("{not json")
    elif corruption == "flip_bytes":
        with open(os.path.join(tdir, "lane_repr_lo.bin"), "r+b") as f:
            f.seek(0)
            f.write(b"\xff\xff\xff\xff")
    elif corruption == "tamper_offsets":
        mpath = os.path.join(tdir, "manifest.json")
        with open(mpath) as f:
            man = json.load(f)
        man["entries"]["row_off"][0] = -4
        with open(mpath, "w") as f:
            json.dump(man, f)
    else:
        os.remove(os.path.join(tdir, "lane_valid.bin"))
    r0 = reg.columnar_rebuilds.value()
    s2 = ColumnarStore(directory=d)  # must not raise
    assert reg.columnar_rebuilds.value() == r0 + 1
    vb = s2.encode_vocab(res, cfg, BP, KBP)
    assert_vocab_equal(vb, encode_resources_vocab(res, cfg, BP, KBP))


def test_eviction_and_compaction_keep_live_rows_correct():
    cfg = EncodeConfig()
    store = ColumnarStore(capacity=8)
    store.compact_min_rows = 1
    all_res = [make_pod(i) for i in range(32)]
    for r in all_res:
        store.warm(cfg, (), (), r, resource_content_hash(r))
    c0 = reg.columnar_compactions.value()
    store.maybe_compact()
    assert reg.columnar_compactions.value() - c0 >= 1
    ekey = store.encode_key(cfg, (), ())
    live = 0
    for r in all_res:
        e = store.get_entry(ekey, resource_content_hash(r))
        if e is None:
            continue
        live += 1
        entries_equal(e, fresh_entry(r, cfg))
        entries_equal(e, jax_fresh_entry(r, cfg))
    assert live == 8


def test_subtree_hash_equals_reference():
    r = make_pod(0)
    for k, v in r.items():
        assert subtree_hash(v) == jcol.subtree_hash(v)
    assert resource_content_hash(r) == jcache.resource_content_hash(r)


def test_store_state():
    assert store_state() == jcol.store_state() == {"enabled": False}
    configure_store(enabled=True)
    get_store().encode_vocab([make_pod(0)], EncodeConfig())
    st = store_state()
    assert st["enabled"] and st["tables"][0]["entries"] == 1
    reset_store()
    assert store_state() == {"enabled": False}
