"""The port's content-addressed caches (kyverno_tpu_torch/tpu/cache.py)
against the JAX package's, on the CPU — the counterparts of
tests/test_perf_cache.py (its persistent-XLA-cache tests have none: the
port builds its kernels once by content hash; its scan-service and
admission tests wait for those modules, and its pipelined-scan tests
are in tests/test_torch_pipeline.py).

Tolerance: exact. Every cached and uncached table equals the JAX
package's, and the hit / miss / bypass counts of the port's registry
move as the reference's do, under resource mutation, policy revision
bumps, namespace-label, operation and user changes, compile-folded
context movement and LRU pressure. The verdict-cache keys of both
packages are the same strings for the same compiled set and
resources."""

import copy

import numpy as np
import pytest

from kyverno_tpu.api.policy import ClusterPolicy as JaxPolicy
from kyverno_tpu.engine.match import RequestInfo as JaxInfo
from kyverno_tpu.observability.metrics import global_registry as jreg
from kyverno_tpu.tpu import cache as jcache
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch.api.policy import ClusterPolicy as PortPolicy
from kyverno_tpu_torch.engine.match import RequestInfo as PortInfo
from kyverno_tpu_torch.observability.metrics import global_registry as reg
from kyverno_tpu_torch.tpu import cache as tcache
from kyverno_tpu_torch.tpu.cache import (LruCache, VerdictCache,
                                         global_encode_cache,
                                         global_verdict_cache,
                                         request_digest,
                                         resource_content_hash)
from kyverno_tpu_torch.tpu.engine import TorchEngine

from torch_parity_util import assert_result_equal
from torch_parity_util import (fresh_port_state,  # noqa: F401
                               no_port_verdict_cache)


def _pol_doc(name="p1", field="privileged", value="false"):
    return {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": name},
        "spec": {"rules": [{
            "name": "r1",
            "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
            "validate": {"message": "m", "pattern": {"spec": {"containers": [
                {"=(securityContext)": {f"=({field})": value}}]}}},
        }]}}


def _engines(*docs, **kw):
    """(JAX engine, port engine on the CPU) over the same documents."""
    jeng = TpuEngine([JaxPolicy.from_dict(copy.deepcopy(d)) for d in docs],
                     **kw)
    teng = TorchEngine([PortPolicy.from_dict(copy.deepcopy(d))
                        for d in docs], device="cpu", **kw)
    return jeng, teng


def _pods(n, priv_every=3, ns="default"):
    return [{
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": f"p{i}", "namespace": ns, "uid": f"u-{ns}-{i}"},
        "spec": {"containers": [{
            "name": "c", "image": "nginx",
            **({"securityContext": {"privileged": True}}
               if i % priv_every == 0 else {})}]},
    } for i in range(n)]


class _Moves:
    """Hit / miss / bypass deltas of both registries since creation."""

    OUTCOMES = ("hit", "miss", "bypass")

    def __init__(self):
        self.t0 = {o: reg.verdict_cache.value({"outcome": o})
                   for o in self.OUTCOMES}
        self.j0 = {o: jreg.verdict_cache.value({"outcome": o})
                   for o in self.OUTCOMES}

    def port(self):
        return {o: reg.verdict_cache.value({"outcome": o}) - self.t0[o]
                for o in self.OUTCOMES}

    def jax(self):
        return {o: jreg.verdict_cache.value({"outcome": o}) - self.j0[o]
                for o in self.OUTCOMES}


def _scan_both(jeng, teng, resources, **kw):
    """Scan with both engines (their inputs deep-copied, the user infos
    in each package's type); the results must be equal."""
    jkw, tkw = dict(kw), dict(kw)
    infos = kw.get("admission_infos")
    if infos is not None:
        jkw["admission_infos"] = [JaxInfo(**i) for i in infos]
        tkw["admission_infos"] = [PortInfo(**i) for i in infos]
    want = jeng.scan(copy.deepcopy(resources), **jkw)
    got = teng.scan(copy.deepcopy(resources), **tkw)
    assert_result_equal(want, got)
    return got


# ---------------------------------------------------------------------------
# the LRU primitive


def test_lru_bound_and_eviction_order():
    for cls in (LruCache, jcache.LruCache):
        lru = cls(3)
        for k in "abc":
            lru.put(k, k.upper())
        assert len(lru) == 3 and lru.evictions == 0
        lru.get("a")
        lru.put("d", "D")
        assert lru.evictions == 1
        assert lru.get("b") is None
        assert lru.get("a") == "A" and lru.get("d") == "D"
        lru.set_capacity(1)
        assert len(lru) == 1 and lru.evictions == 3
        lru.set_capacity(0)
        lru.put("x", "X")
        assert lru.get("x") is None and len(lru) == 0


def test_verdict_cache_lru_bound_and_metrics():
    vc = VerdictCache(capacity=4, metrics=reg)
    ev0 = reg.verdict_cache_evictions.value()
    for i in range(8):
        vc.put(("k", i), np.full(3, i, dtype=np.int32))
    assert len(vc) == 4
    assert reg.verdict_cache_evictions.value() - ev0 == 4
    col = vc.get(("k", 7))
    assert col.tolist() == [7, 7, 7]
    col[0] = 99  # a caller's copy never aliases the cached column
    assert vc.get(("k", 7)).tolist() == [7, 7, 7]
    assert vc.get(("k", 0)) is None


# ---------------------------------------------------------------------------
# the verdict cache: equal to the reference, hits and invalidation


def test_cached_scan_equals_reference_and_hits():
    jeng, teng = _engines(_pol_doc())
    assert teng.cache_eligible and jeng.cache_eligible
    pods = _pods(12)
    first = _scan_both(jeng, teng, pods)
    moves = _Moves()
    second = _scan_both(jeng, teng, pods)
    assert np.array_equal(first.verdicts, second.verdicts)
    assert moves.port() == moves.jax() == {"hit": 12, "miss": 0,
                                           "bypass": 0}
    oracle = teng._scan_uncached(copy.deepcopy(pods))
    assert np.array_equal(second.verdicts, oracle.verdicts)


def test_cache_keys_equal_the_reference():
    """The same compiled set and resources give the same key strings in
    both packages: the policy-set digest (policy content, the empty
    quarantine set, context dependencies, caps, byte paths, the DFA
    bank's digest), the resource hash and the request digest."""
    docs = [_pol_doc(), _pol_doc("p2", "allowPrivilegeEscalation")]
    jeng, teng = _engines(*docs)
    pods = _pods(6) + [{"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": "default"}}]
    labels = {"default": {"team": "a"}}
    ops = ["CREATE", "UPDATE"] * 3 + ["DELETE"]
    assert teng.cps.cache_key() == jeng.cps.cache_key()
    want = jeng.verdict_cache_keys(pods, labels, ops,
                                   [JaxInfo(username="eve")] * 7)
    got = teng.verdict_cache_keys(pods, labels, ops,
                                  [PortInfo(username="eve")] * 7)
    assert got == want and None not in got
    assert teng.mutate_triage_cache_keys(pods) == \
        jeng.mutate_triage_cache_keys(pods)


def test_resource_mutation_invalidates_only_that_resource():
    jeng, teng = _engines(_pol_doc())
    pods = _pods(10)
    _scan_both(jeng, teng, pods)
    mutated = [dict(p) for p in pods]
    mutated[4] = {**pods[4], "spec": {"containers": [{
        "name": "c", "image": "nginx",
        "securityContext": {"privileged": True}}]}}
    moves = _Moves()
    res = _scan_both(jeng, teng, mutated)
    assert moves.port() == moves.jax() == {"hit": 9, "miss": 1, "bypass": 0}
    assert np.array_equal(res.verdicts,
                          teng._scan_uncached(mutated).verdicts)


def test_policy_revision_bump_invalidates():
    pods = _pods(6)
    j1, t1 = _engines(_pol_doc(value="false"))
    _scan_both(j1, t1, pods)
    j2, t2 = _engines(_pol_doc(value="true"))
    moves = _Moves()
    res = _scan_both(j2, t2, pods)
    assert moves.port() == moves.jax() == {"hit": 0, "miss": 6, "bypass": 0}
    assert np.array_equal(res.verdicts, t2._scan_uncached(pods).verdicts)
    # the first engine's entries are still live (nothing is flushed)
    moves = _Moves()
    _scan_both(j1, t1, pods)
    assert moves.port()["hit"] == moves.jax()["hit"] == 6


def test_ns_label_change_invalidates():
    pods = _pods(5)
    jeng, teng = _engines(_pol_doc())
    _scan_both(jeng, teng, pods, namespace_labels={"default": {"team": "a"}})
    moves = _Moves()
    _scan_both(jeng, teng, pods, namespace_labels={"default": {"team": "b"}})
    assert moves.port() == moves.jax() == {"hit": 0, "miss": 5, "bypass": 0}
    moves = _Moves()
    _scan_both(jeng, teng, pods, namespace_labels={"default": {"team": "a"}})
    assert moves.port()["hit"] == moves.jax()["hit"] == 5


def test_operation_and_userinfo_are_part_of_the_key():
    pods = _pods(3)
    jeng, teng = _engines(_pol_doc())
    _scan_both(jeng, teng, pods, operations=["CREATE"] * 3)
    moves = _Moves()
    _scan_both(jeng, teng, pods, operations=["UPDATE"] * 3)
    assert moves.port()["miss"] == moves.jax()["miss"] == 3
    moves = _Moves()
    _scan_both(jeng, teng, pods, operations=["CREATE"] * 3,
               admission_infos=[{"username": "eve"}] * 3)
    assert moves.port()["miss"] == moves.jax()["miss"] == 3


_CM_POLICY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "cm-pol"},
    "spec": {"rules": [{
        "name": "r1",
        "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
        "context": [{"name": "cm", "configMap": {
            "name": "limits", "namespace": "default"}}],
        "validate": {"message": "m", "deny": {"conditions": {"any": [{
            "key": "{{ cm.data.mode }}",
            "operator": "Equals", "value": "deny"}]}}},
    }]}}


class _CM:
    def __init__(self, mode):
        self.mode = mode

    def get(self, key):
        return {"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": "limits", "namespace": "default"},
                "data": {"mode": self.mode}}


def test_context_dep_movement_rotates_the_policyset_key():
    from kyverno_tpu.engine.contextloaders import DataSources as JaxSources
    from kyverno_tpu.tpu.compiler import compile_policy_set as jcompile
    from kyverno_tpu_torch.engine.contextloaders import DataSources
    from kyverno_tpu_torch.tpu.compiler import compile_policy_set

    pol = PortPolicy.from_dict(copy.deepcopy(_CM_POLICY))
    jpol = JaxPolicy.from_dict(copy.deepcopy(_CM_POLICY))
    keys = {}
    for mode in ("allow", "deny"):
        cps = compile_policy_set([pol],
                                 data_sources=DataSources(configmaps=_CM(mode)))
        jcps = jcompile([jpol], data_sources=JaxSources(configmaps=_CM(mode)))
        assert cps.context_deps and cps.context_deps == jcps.context_deps
        assert cps.cache_key() == jcps.cache_key()
        keys[mode] = cps.cache_key()
    assert keys["allow"] != keys["deny"]
    again = compile_policy_set(
        [pol], data_sources=DataSources(configmaps=_CM("allow")))
    assert again.cache_key() == keys["allow"]


def test_dyn_slot_sets_are_cache_ineligible():
    jeng, teng = _engines(_CM_POLICY)  # no data sources: a host rule
    assert not teng.cache_eligible and not jeng.cache_eligible
    assert teng.verdict_cache_keys(_pods(2)) is None
    moves = _Moves()
    _scan_both(jeng, teng, _pods(2))
    assert moves.port()["bypass"] == moves.jax()["bypass"] == 1


def test_unhashable_resource_bypasses_but_still_scans():
    jeng, teng = _engines(_pol_doc())
    hostile = {"kind": b"bytes", "metadata": {"name": "h"}}
    pods = _pods(2) + [hostile]
    res = _scan_both(jeng, teng, pods)
    assert res.verdicts.shape[1] == 3
    moves = _Moves()
    res2 = _scan_both(jeng, teng, pods)
    assert moves.port()["hit"] == moves.jax()["hit"] == 2
    assert np.array_equal(res.verdicts, res2.verdicts)


def test_repeat_scan_serves_90pct_from_cache():
    """The engine-level half of the reference's scan-service test (the
    scan service is not ported): a rescan of an unchanged set of 30
    resources is served from the cache, with equal verdicts."""
    jeng, teng = _engines(_pol_doc())
    pods = _pods(30)
    first = _scan_both(jeng, teng, pods)
    moves = _Moves()
    second = _scan_both(jeng, teng, pods)
    assert moves.port()["hit"] >= 27 and moves.port()["miss"] == 0
    assert moves.port() == moves.jax()
    assert np.array_equal(first.verdicts, second.verdicts)


def test_cached_triage_equals_reference():
    """triage_mutate over the cached ladder: a warm batch is served from
    the cache (``mutate_triage{outcome="cached"}``) with the table of
    the uncached one, and the JAX package's."""
    doc = {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "stamp"},
        "spec": {"rules": [{
            "name": "team", "match": {"any": [{"resources": {
                "kinds": ["Pod"]}}]},
            "mutate": {"patchStrategicMerge": {
                "metadata": {"labels": {"+(team)": "core"}}}}}]}}
    jeng, teng = _engines(doc)
    assert teng.mutate_cache_eligible
    pods = _pods(9)
    c0 = reg.mutate_triage.value({"outcome": "cached"})
    for _ in range(2):
        want = jeng.triage_mutate(copy.deepcopy(pods))
        got = teng.triage_mutate(copy.deepcopy(pods))
        assert np.array_equal(got.verdicts, want.verdicts)
    assert reg.mutate_triage.value({"outcome": "cached"}) - c0 == 9
    assert np.array_equal(got.verdicts,
                          teng._triage_uncached(pods).verdicts)


def _rule_stats(acc):
    """An accumulator's rows without their clock fields."""
    keys = ("policy", "rule", "policy_hash", "evals", "fired", "pass",
            "skip", "fail", "not_matched", "error", "by_source")
    return sorted(tuple(str(r[k]) if k == "by_source" else r[k]
                        for k in keys) for r in acc.rule_rows())


def test_live_n_keeps_pad_columns_out_of_the_rule_stats():
    """``scan(live_n=)``: verdicts of every column, rule analytics of
    the live ones — cold and warm, equal to the reference's."""
    from kyverno_tpu.observability.analytics import \
        global_rule_stats as jstats
    from kyverno_tpu_torch.observability.analytics import global_rule_stats

    jeng, teng = _engines(_pol_doc())
    batch = _pods(6) + [{} for _ in range(10)]
    for _ in range(2):
        want = jeng.scan(copy.deepcopy(batch), live_n=6)
        got = teng.scan(copy.deepcopy(batch), live_n=6)
        assert_result_equal(want, got)
        assert _rule_stats(global_rule_stats) == _rule_stats(jstats)
        assert _rule_stats(global_rule_stats)[0][3] > 0


# ---------------------------------------------------------------------------
# the encode-row cache


def test_encode_row_cache_roundtrip_equals_reference(no_verdict_cache,
                                                     no_port_verdict_cache):
    jeng, teng = _engines(_pol_doc())
    pods = _pods(8)
    a = teng.encode(copy.deepcopy(pods))[0]
    eh0 = reg.encode_cache.value({"outcome": "hit"})
    b = teng.encode(copy.deepcopy(pods))[0]
    assert reg.encode_cache.value({"outcome": "hit"}) - eh0 == 8
    want = jeng.encode(copy.deepcopy(pods))[0]
    assert set(a) == set(b) == set(want)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a[k], want[k], err_msg=k)
    r1 = _scan_both(jeng, teng, pods)
    r2 = _scan_both(jeng, teng, pods)
    assert np.array_equal(r1.verdicts, r2.verdicts)


def test_encode_cache_survives_policy_revision_bump():
    pods = _pods(6)
    j1, t1 = _engines(_pol_doc(value="false"))
    _scan_both(j1, t1, pods)
    j2, t2 = _engines(_pol_doc(value="true"))
    eh0 = reg.encode_cache.value({"outcome": "hit"})
    jh0 = jreg.encode_cache.value({"outcome": "hit"})
    _scan_both(j2, t2, pods)
    hits = reg.encode_cache.value({"outcome": "hit"}) - eh0
    assert hits >= 6 and hits == jreg.encode_cache.value(
        {"outcome": "hit"}) - jh0


def test_encode_cache_disabled_matches_enabled():
    jeng, teng = _engines(_pol_doc())
    pods = _pods(5)
    enabled = teng.encode(copy.deepcopy(pods))[0]
    cap = global_encode_cache._lru.capacity
    global_encode_cache.set_capacity(0)
    try:
        disabled = teng.encode(copy.deepcopy(pods))[0]
    finally:
        global_encode_cache.set_capacity(cap)
    for k in enabled:
        np.testing.assert_array_equal(enabled[k], disabled[k], err_msg=k)


# ---------------------------------------------------------------------------
# key and hash helpers


def test_resource_content_hash_stability():
    a = {"kind": "Pod", "metadata": {"name": "x", "labels": {"a": "1"}}}
    b = {"metadata": {"labels": {"a": "1"}, "name": "x"}, "kind": "Pod"}
    assert resource_content_hash(a) == resource_content_hash(b)
    assert resource_content_hash(a) == jcache.resource_content_hash(a)
    assert resource_content_hash({"k": b"bytes"}) is None
    from kyverno_tpu_torch.cluster.snapshot import resource_hash

    assert resource_content_hash(a) == resource_hash(a)
    assert request_digest({"t": "a"}, "CREATE", None) != \
        request_digest({"t": "b"}, "CREATE", None)
    assert request_digest({}, "", None) != request_digest({}, "CREATE", None)
    assert request_digest({"t": "a"}, "CREATE", PortInfo(username="u")) == \
        jcache.request_digest({"t": "a"}, "CREATE", JaxInfo(username="u"))


def test_configure_resizes_and_disables():
    caps = (global_verdict_cache._lru.capacity,
            global_encode_cache._lru.capacity)
    tcache.configure(0, 0)
    try:
        assert not global_verdict_cache.enabled
        assert not global_encode_cache.enabled
        jeng, teng = _engines(_pol_doc())
        moves = _Moves()
        teng.scan(_pods(4))
        assert moves.port() == {"hit": 0, "miss": 0, "bypass": 0}
    finally:
        tcache.configure(*caps)
    assert global_verdict_cache.enabled and global_encode_cache.enabled


@pytest.mark.parametrize("cap", [3, 7])
def test_lru_pressure_keeps_verdicts_equal(cap):
    """A verdict cache smaller than the batch: evictions, equal
    tables."""
    jeng, teng = _engines(_pol_doc())
    pods = _pods(10)
    old = global_verdict_cache._lru.capacity
    global_verdict_cache.set_capacity(cap)
    try:
        for _ in range(3):
            _scan_both(jeng, teng, pods)
        assert len(global_verdict_cache) <= cap
    finally:
        global_verdict_cache.set_capacity(old)


def test_pss_cache_keys_equal_the_reference():
    """The bundled PSS policies (a DFA bank, autogen rules): the same
    policy-set key and per-resource keys in both packages."""
    from kyverno_tpu.policies import load_pss_policies
    from kyverno_tpu.policy.autogen import expand_policy

    from torch_parity_util import port_policies

    policies = [expand_policy(p) for p in load_pss_policies()]
    jeng = TpuEngine(policies)
    teng = TorchEngine(port_policies(policies), device="cpu")
    assert teng.cps.dfa is not None and len(teng.cps.dfa)
    assert teng.cps.dfa.digest() == jeng.cps.dfa.digest()
    pods = _pods(5)
    assert teng.verdict_cache_keys(pods) == jeng.verdict_cache_keys(pods)
