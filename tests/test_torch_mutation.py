"""Mutate triage of kyverno_tpu_torch against the JAX package.

- Compile: for sets that mix validate and mutate rules, the port's
  compiler builds the reference's mutate bank (``mutate_entries`` with
  their device rows and host reasons, templates compared by what they
  stamp), the reference's shared DFA bank (patterns, families, ids,
  tables), byte paths and encode configs, ``label_bytes_enabled``
  included.
- Triage: ``TorchEngine.triage_mutate`` (the mutate bank's program on
  the CPU, the kernels' plain twins) gives the reference's
  ``TpuEngine.triage_mutate`` table, bit for bit.
- Patching: the port's ``apply_mutations`` gives the reference's
  outcome on every triaged resource, and its output equals the port's
  scalar chain (policy after policy through ``Engine.mutate``).

The corpora: every compile and triage that tests/test_mutation.py makes
(recorded as that module runs), bench.py's ``bench_mutate`` set, a
mixed validate + mutate set, a PolicyException naming a mutate rule
with user infos whose groups hold a glob, and the tenant set of
tests/test_torch_glob_nfa.py with its DFA bank overflowing. Codes are
int32: tolerance 0."""

import copy
import importlib

import numpy as np
import pytest

from kyverno_tpu.api.policy import ClusterPolicy as JaxPolicy
from kyverno_tpu.engine.match import RequestInfo as JaxRequestInfo
from kyverno_tpu.mutation.coordinator import \
    apply_mutations as jax_apply_mutations
from kyverno_tpu.tpu import compiler as jcompiler
from kyverno_tpu.tpu import dfa as jdfa
from kyverno_tpu.tpu import engine as jengine
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch.mutation.coordinator import apply_mutations
from kyverno_tpu_torch.resilience.faults import (SITE_MUTATE_PATCH,
                                                 global_faults)
from kyverno_tpu_torch.tpu import dfa as tdfa
from kyverno_tpu_torch.tpu.compiler import compile_policy_set
from kyverno_tpu_torch.tpu.convert import bank_to_numpy
from kyverno_tpu_torch.tpu.engine import TorchEngine, build_scan_context
from kyverno_tpu_torch.tpu.evaluator import HOST, NOT_MATCHED, SKIP

from test_torch_glob_nfa import (BANK_STATES, tenant_policy,
                                 tenant_resources)
from torch_parity_util import port_infos, port_policies
from torch_parity_util import fresh_port_state  # noqa: F401

# functions of tests/test_mutation.py that compile a set with mutate
# rules or triage resources
MUTATION_TESTS = [
    "test_chain_dependent_rule_demotes_to_host",
    "test_independent_rules_stay_on_device",
    "test_triage_mutate_verdict_codes",
    "test_triage_host_rows_for_uncompilable_predicates",
    "test_coordinator_all_negative_skips_everything",
    "test_coordinator_positive_stamps_template_bit_identical",
    "test_coordinator_host_rows_route_scalar_bit_identical",
    "test_coordinator_multi_policy_chain_order",
    "test_triage_negative_batch_cost_one_dispatch",
]


class Triage:
    """One triage call: its inputs and the reference's answer."""

    def __init__(self, engine, resources, namespace_labels=None,
                 operations=None, admission_infos=None, exceptions=()):
        self.engine = engine
        self.resources = copy.deepcopy(list(resources))
        self.namespace_labels = copy.deepcopy(namespace_labels)
        self.operations = list(operations) if operations else None
        self.admission_infos = list(admission_infos) if admission_infos \
            else None
        self.exceptions = copy.deepcopy(list(exceptions))
        self.result = engine.triage_mutate(
            self.resources, self.namespace_labels, self.operations,
            self.admission_infos)


def record_mutation_test(monkeypatch, name):
    """Run tests/test_mutation.py's ``name`` and return the policy lists
    it compiled and the triage calls it made."""
    mod = importlib.import_module("test_mutation")
    compiles, triages = [], []
    real_compile = jcompiler.compile_policy_set
    real_triage = jengine.TpuEngine.triage_mutate

    def compile_(policies, *a, **kw):
        compiles.append(list(policies))
        return real_compile(policies, *a, **kw)

    def triage(self, resources, namespace_labels=None, operations=None,
               admission_infos=None):
        rec = Triage.__new__(Triage)
        rec.engine = self
        rec.resources = copy.deepcopy(list(resources))
        rec.namespace_labels = copy.deepcopy(namespace_labels)
        rec.operations = list(operations) if operations else None
        rec.admission_infos = list(admission_infos) if admission_infos \
            else None
        rec.exceptions = []
        rec.result = real_triage(self, resources, namespace_labels,
                                 operations, admission_infos)
        triages.append(rec)
        return rec.result

    monkeypatch.setattr(mod, "compile_policy_set", compile_)
    monkeypatch.setattr(jengine.TpuEngine, "triage_mutate", triage)
    getattr(mod, name)()
    monkeypatch.setattr(jengine.TpuEngine, "triage_mutate", real_triage)
    monkeypatch.setattr(mod, "compile_policy_set", real_compile)
    assert compiles, f"test_mutation.{name} compiled nothing"
    return compiles, triages


# ---------------------------------------------------------------------------
# the other corpora


def _cpol(name, rules):
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name},
            "spec": {"validationFailureAction": "Enforce", "rules": rules}}


def _pod(name, ns, labels=None):
    meta = {"name": name, "namespace": ns}
    if labels is not None:
        meta["labels"] = dict(labels)
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"containers": [{"name": "c", "image": "nginx"}]}}


def bench_policies():
    """bench.py:bench_mutate's two policies."""
    def pol(name, rule, overlay):
        return _cpol(name, [{
            "name": rule,
            "match": {"resources": {"kinds": ["Pod"], "namespaces": ["prod"]}},
            "mutate": {"patchStrategicMerge": overlay}}])

    return [pol("stamp-labels", "labels",
                {"metadata": {"labels": {"+(team)": "core", "env": "prod"}}}),
            pol("stamp-scheduling", "sched",
                {"spec": {"priority": 100, "dnsPolicy": "ClusterFirst"}})]


def bench_resources(n=64, positive_every=20):
    return [_pod(f"bench-{i}", "prod" if i % positive_every == 0 else "dev")
            for i in range(n)]


def mixed_policies():
    """One validate and one mutate rule matching namespace, name and
    label-selector globs: the mutate rule's globs join the bank."""
    match = {"resources": {"kinds": ["Pod"], "namespaces": ["team-*"],
                           "names": ["app-*-?"],
                           "selector": {"matchLabels": {"tier": "web-*"}}}}
    return [_cpol("mixed", [
        {"name": "v", "match": copy.deepcopy(match),
         "validate": {"message": "team", "pattern":
                      {"metadata": {"labels": {"team": "?*"}}}}},
        {"name": "m", "match": copy.deepcopy(match),
         "mutate": {"patchStrategicMerge":
                    {"metadata": {"labels": {"+(team)": "core"}}}}}])]


def mixed_resources():
    out = []
    for i, (ns, name, tier) in enumerate([
            ("team-a", "app-x-1", "web-1"), ("team-b", "app-yy-2", "db"),
            ("other", "app-x-1", "web-2"), ("team-c", "app-1", "web-3"),
            ("team-é", "app-z-é", "web-4"), ("team-d", "app-q-9", None)]):
        labels = {"tier": tier} if tier else {}
        if i % 2:
            labels["team"] = "t"
        out.append(_pod(name, ns, labels))
    return out


EXCEPTION = {
    "apiVersion": "kyverno.io/v2", "kind": "PolicyException",
    "metadata": {"name": "skip-stamp", "namespace": "kyverno"},
    "spec": {"exceptions": [{"policyName": "guarded",
                             "ruleNames": ["stamp-owner"]}],
             "match": {"any": [{"resources": {"kinds": ["Pod"],
                                              "namespaces": ["prod"]}}]}},
}


def guarded_policies():
    """A mutate rule a PolicyException names, a mutate rule reading the
    requester's groups, and a plain one."""
    return [_cpol("guarded", [
        {"name": "stamp-owner",
         "match": {"resources": {"kinds": ["Pod"]}},
         "mutate": {"patchStrategicMerge":
                    {"metadata": {"labels": {"owner": "platform"}}}}},
        {"name": "devs-only",
         "match": {"resources": {"kinds": ["Pod"]}},
         "preconditions": {"all": [{
             "key": "{{ request.userInfo.groups }}", "operator": "AnyIn",
             "value": ["devs"]}]},
         "mutate": {"patchStrategicMerge":
                    {"metadata": {"annotations": {"dev": "true"}}}}},
        {"name": "zone",
         "match": {"resources": {"kinds": ["Pod"], "namespaces": ["prod"]}},
         "mutate": {"patchStrategicMerge": {"spec": {"priority": 7}}}}])]


def guarded_args():
    resources = [_pod("a", "prod"), _pod("b", "dev"), _pod("c", "prod"),
                 _pod("d", "dev", {"x": "y"})]
    infos = [JaxRequestInfo(username="u", groups=["devs"]),
             JaxRequestInfo(username="u", groups=["team-*"]),  # a glob
             None,
             JaxRequestInfo(username="v", groups=["ops"])]
    ops = ["CREATE", "UPDATE", "CREATE", "CREATE"]
    return resources, infos, ops


def jax_engine(docs, exceptions=()):
    return TpuEngine([JaxPolicy.from_dict(copy.deepcopy(d)) for d in docs],
                     exceptions=copy.deepcopy(list(exceptions)))


def extra_triages(name):
    """The corpora that tests/test_mutation.py does not hold."""
    if name == "bench_mutate":
        eng = jax_engine(bench_policies())
        res = bench_resources()
        return [Triage(eng, res[i:i + 32], {"prod": {}, "dev": {}})
                for i in (0, 32)]
    if name == "mixed":
        eng = jax_engine(mixed_policies())
        return [Triage(eng, mixed_resources(), {"team-a": {"x": "1"}})]
    if name == "exception_userinfo":
        eng = jax_engine(guarded_policies(), [EXCEPTION])
        res, infos, ops = guarded_args()
        return [Triage(eng, res, {"prod": {}}, ops, infos, [EXCEPTION])]
    if name == "tenant":
        eng = jax_engine([tenant_policy()])
        return [Triage(eng, tenant_resources(seed), {}) for seed in (0, 1)]
    raise KeyError(name)


EXTRA = ["bench_mutate", "mixed", "exception_userinfo", "tenant"]
CORPORA = ([pytest.param("test_mutation", n, id=n) for n in MUTATION_TESTS]
           + [pytest.param("extra", n, id=n) for n in EXTRA])


@pytest.fixture
def corpus_bank(request, monkeypatch):
    """The tenant corpus runs with the DFA bank's cap lowered in both
    packages, so some of its globs overflow to the NFA."""
    if request.node.callspec.params.get("name") == "tenant":
        monkeypatch.setattr(jdfa, "MAX_BANK_STATES", BANK_STATES)
        monkeypatch.setattr(tdfa, "MAX_BANK_STATES", BANK_STATES)


def corpus(monkeypatch, source, name):
    """(policy lists compiled, triage calls) of one corpus. A function
    of tests/test_mutation.py that triages nothing has the sets it
    compiled triaged over ``STAMP_ON``."""
    if source == "test_mutation":
        compiles, triages = record_mutation_test(monkeypatch, name)
        if not triages:
            triages = [Triage(TpuEngine(policies), STAMP_ON, {})
                       for policies in compiles]
        return compiles, triages
    triages = extra_triages(name)
    return [list(t.engine.cps.policies) for t in triages[:1]], triages


# ---------------------------------------------------------------------------
# compile parity


STAMP_ON = [
    _pod("p", "prod"),
    _pod("q", "dev", {"team": "x", "env": "dev"}),
    {"apiVersion": "v1", "kind": "Pod",
     "metadata": {"name": "r", "annotations": {"audit": "off"}},
     "spec": {"priority": 1, "containers": []}},
]


def _entries(entries):
    return [(e.policy_idx, e.policy_name, e.rule_name, e.device_row,
             e.fallback_reason) for e in entries]


def assert_same_compile(jcps, tcps):
    assert _entries(tcps.rules) == _entries(jcps.rules)
    assert _entries(tcps.mutate_entries) == _entries(jcps.mutate_entries)
    assert tcps.mutate_rules == jcps.mutate_rules
    assert tcps.mutate_coverage() == jcps.mutate_coverage()
    assert len(tcps.mutate_programs) == len(jcps.mutate_programs)
    for tp, jp in zip(tcps.mutate_programs, jcps.mutate_programs):
        assert (tp.uses_userinfo, tp.uses_patterns) == \
            (jp.uses_userinfo, jp.uses_patterns)
    assert len(tcps.mutate_templates) == len(jcps.mutate_templates)
    for tt, jt in zip(tcps.mutate_templates, jcps.mutate_templates):
        assert (tt is None) == (jt is None)
        if tt is None:
            continue
        assert tt.policy_name == jt.policy_name
        for res in STAMP_ON:
            assert tt.stamp(copy.deepcopy(res)) == jt.stamp(copy.deepcopy(res))
    assert bank_to_numpy(tcps.dfa).keys() == bank_to_numpy(jcps.dfa).keys()
    ja, ta = bank_to_numpy(jcps.dfa), bank_to_numpy(tcps.dfa)
    for k, v in ja.items():
        if isinstance(v, np.ndarray):
            assert ta[k].dtype == v.dtype and np.array_equal(ta[k], v), k
        else:
            assert ta[k] == v, k
    assert tcps.dfa.digest() == jcps.dfa.digest()
    assert tcps.byte_paths == jcps.byte_paths
    assert tcps.key_byte_paths == jcps.key_byte_paths
    assert vars(tcps.encode_cfg) == vars(jcps.encode_cfg)
    assert vars(tcps.meta_cfg) == vars(jcps.meta_cfg)


@pytest.mark.parametrize("source,name", CORPORA)
def test_compile_parity(monkeypatch, corpus_bank, source, name):
    compiles, _ = corpus(monkeypatch, source, name)
    for policies in compiles:
        jcps = jcompiler.compile_policy_set(policies)
        tcps = compile_policy_set(port_policies(policies))
        assert_same_compile(jcps, tcps)


def test_mixed_set_encodes_the_reference_lanes():
    """A set with a mutate rule: the bank holds the mutate rule's
    patterns too, label byte lanes are on, and the port encodes the
    reference's lanes."""
    from torch_parity_util import assert_lanes_equal

    jeng = jax_engine(mixed_policies())
    teng = TorchEngine(port_policies(jeng.cps.policies), device="cpu")
    assert teng.cps.meta_cfg.label_bytes_enabled
    assert set(teng.cps.dfa.families) == {"pool", "name", "ns", "labels_kb",
                                          "labels_vb"}
    res = mixed_resources()
    padded, _, _ = teng.pad(res)
    assert_lanes_equal(jeng.encode(padded, {})[0], teng.encode(padded, {})[0])


# ---------------------------------------------------------------------------
# triage and patching parity


def _port_engine(rec):
    return TorchEngine(port_policies(rec.engine.cps.policies), device="cpu",
                       exceptions=copy.deepcopy(rec.exceptions))


def _ns_labels(rec, resource):
    ns = (resource.get("metadata") or {}).get("namespace", "")
    return (rec.namespace_labels or {}).get(ns, {})


def port_scalar_chain(teng, resource, ns_labels, op, info):
    """The legacy per-policy host loop on the port's scalar engine."""
    patched = copy.deepcopy(resource)
    for pol in teng.cps.policies:
        pctx = build_scan_context(pol, patched, ns_labels, op, info)
        resp = teng.scalar.mutate(pctx)
        if resp.patched_resource is not None:
            patched = resp.patched_resource
    return patched


OUTCOME = ("changed", "template_rules", "scalar_policies",
           "skipped_policies", "fallbacks", "errors")


@pytest.mark.parametrize("source,name", CORPORA)
def test_triage_and_patch_parity(monkeypatch, corpus_bank, source, name):
    _, triages = corpus(monkeypatch, source, name)
    assert triages
    for rec in triages:
        teng = _port_engine(rec)
        tinfos = port_infos(rec.admission_infos)
        got = teng.triage_mutate(rec.resources, rec.namespace_labels,
                                 rec.operations, tinfos)
        want = rec.result
        assert got.rules == want.rules
        assert got.verdicts.dtype == want.verdicts.dtype == np.int32
        assert np.array_equal(got.verdicts, want.verdicts)
        assert got.counts() == want.counts()
        for ci, res in enumerate(rec.resources):
            nsl = _ns_labels(rec, res)
            op = (rec.operations[ci] if rec.operations else "") or "CREATE"
            jinfo = rec.admission_infos[ci] if rec.admission_infos else None
            tinfo = tinfos[ci] if tinfos else None
            jout = jax_apply_mutations(rec.engine, copy.deepcopy(res),
                                       want.rows_for(ci), nsl, op, jinfo)
            tout = apply_mutations(teng, copy.deepcopy(res),
                                   got.rows_for(ci), nsl, op, tinfo)
            assert tout.patched == jout.patched
            for k in OUTCOME:
                assert getattr(tout, k) == getattr(jout, k), k
            assert tout.patched == port_scalar_chain(teng, res, nsl, op,
                                                     tinfo)
            if not tout.changed:
                assert tout.patched == res


def test_exception_and_group_glob_rows_stay_host():
    """The excepted rule's row is HOST everywhere; the userinfo rule's
    row is HOST for the request whose groups hold a glob."""
    rec = extra_triages("exception_userinfo")[0]
    teng = _port_engine(rec)
    got = teng.triage_mutate(rec.resources, rec.namespace_labels,
                             rec.operations, port_infos(rec.admission_infos))
    rows = dict(zip((r for _, r in got.rules), got.verdicts))
    assert (rows["stamp-owner"] == HOST).all()
    assert rows["devs-only"][1] == HOST
    assert (np.delete(rows["devs-only"], 1) < HOST).all()
    assert (rows["zone"] < HOST).all()
    assert teng.mutate_coverage() == (3, 3)


def test_triage_negative_batch_cost_one_dispatch():
    """A batch of triage-negative resources costs one device program
    run and no patcher call (tests/test_mutation.py's guarantee, on the
    port)."""
    pol = _cpol("prod-only", [{
        "name": "prod-only",
        "match": {"resources": {"kinds": ["Pod"], "namespaces": ["prod"]}},
        "mutate": {"patchStrategicMerge":
                   {"metadata": {"labels": {"env": "prod"}}}}}])
    teng = TorchEngine(port_policies([JaxPolicy.from_dict(pol)]),
                       device="cpu")
    resources = [_pod(f"p{i}", "dev") for i in range(8)]
    res = teng.triage_mutate(resources, {"dev": {}})
    assert teng.triage_dispatches == 1
    assert teng.triage_encode_fallbacks == 0
    calls = []
    for ci, r in enumerate(resources):
        out = apply_mutations(teng, r, res.rows_for(ci))
        calls.append(out.scalar_policies + out.template_rules)
        assert not out.changed and out.patched is r
    assert sum(calls) == 0, "triage-negative rows must never reach a patcher"
    assert res.counts() == {"positive": 0, "negative": 8, "host": 0}
    assert set(np.unique(res.verdicts)) <= {SKIP, NOT_MATCHED}


def test_patch_fault_falls_back_to_scalar():
    """A template stamp that raises degrades that policy to the scalar
    patcher, bit-identically, and is counted."""
    pol = JaxPolicy.from_dict(_cpol("mpol", [{
        "name": "m", "match": {"resources": {"kinds": ["Pod"]}},
        "mutate": {"patchStrategicMerge":
                   {"metadata": {"labels": {"env": "prod"}}}}}]))
    teng = TorchEngine(port_policies([pol]), device="cpu")
    res = _pod("p", "prod")
    rows = teng.triage_mutate([res], {}).rows_for(0)

    class Registry:
        def __init__(self):
            self.seen = []
            self.mutate_patches = self.mutate_patch_fallbacks = self

        def inc(self, labels=None, n=1):
            self.seen.append((dict(labels or {}), n))

    reg = Registry()
    global_faults.arm(SITE_MUTATE_PATCH, mode="raise")
    try:
        out = apply_mutations(teng, res, rows, registry=reg)
    finally:
        global_faults.disarm(SITE_MUTATE_PATCH)
    assert out.fallbacks == 1 and out.warnings
    assert out.patched == port_scalar_chain(teng, res, {}, "CREATE", None)
    assert reg.seen == [({}, 1), ({"source": "scalar"}, 1)]
    # without a fault the template stamps, and counts by source
    reg = Registry()
    out = apply_mutations(teng, res, rows, registry=reg)
    assert out.template_rules == 1 and out.fallbacks == 0
    assert reg.seen == [({"source": "template"}, 1)]


def test_encode_error_answers_host(monkeypatch):
    """A host encode error answers the batch HOST (the reference's
    rule) and is counted; the scalar patcher then decides."""
    teng = TorchEngine(port_policies([JaxPolicy.from_dict(p)
                                      for p in bench_policies()]),
                       device="cpu")

    def boom(*a, **kw):
        raise ValueError("hostile resource")

    monkeypatch.setattr(teng, "encode", boom)
    res = teng.triage_mutate([_pod("a", "prod")], {})
    assert (res.verdicts == HOST).all()
    assert teng.triage_encode_fallbacks == 1 and teng.triage_dispatches == 0
