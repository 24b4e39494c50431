"""The port's policy-set analysis (kyverno_tpu_torch/analysis/) and
policy validation (policy/validation.py) against the JAX package's,
exactly.

On both golden fixtures (tests/golden/analysis/): ``synthesize`` gives
equal corpora and rule summaries, ``evaluate_corpus`` equal verdict
tables through ``TorchEngine._scan_uncached(..., live_n=0)`` (the CPU
program, plain twins), and ``analyze_engine`` equal reports, timings
aside. ``validate_policy`` gives the same errors and warnings on every
call that tests/test_policy_validation.py makes (recorded while it
runs). The lifecycle's ``run_lint`` now resolves: it runs, is
idempotent, and feeds the never-fired rules' static correlation as the
reference's does."""

from __future__ import annotations

import copy
import dataclasses
import os

import pytest
import yaml

from kyverno_tpu.analysis import analyze_engine as janalyze
from kyverno_tpu.analysis import global_analysis as jglobal_analysis
from kyverno_tpu.analysis.analyzer import evaluate_corpus as jevaluate
from kyverno_tpu.analysis.witness import synthesize as jsynthesize
from kyverno_tpu.api.policy import ClusterPolicy as JPolicy
from kyverno_tpu.policy.autogen import expand_policy as jexpand
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch.analysis import analyze_engine as tanalyze
from kyverno_tpu_torch.analysis import global_analysis
from kyverno_tpu_torch.analysis.analyzer import evaluate_corpus as tevaluate
from kyverno_tpu_torch.analysis.witness import synthesize as tsynthesize
from kyverno_tpu_torch.api.policy import ClusterPolicy as TPolicy
from kyverno_tpu_torch.policy.autogen import expand_policy as texpand
from kyverno_tpu_torch.tpu.engine import TorchEngine

from torch_parity_util import fresh_port_state  # noqa: F401 - autouse

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "analysis")
FIXTURES = ("seeded_anomalies.yaml", "clean_corpus.yaml")
TIMINGS = ("synthesize_s", "evaluate_s", "classify_s", "confirm_s",
           "witness_evals_per_s")


def _docs(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return [d for d in yaml.safe_load_all(f) if isinstance(d, dict)]


@pytest.fixture(scope="module", params=FIXTURES)
def engines(request):
    docs = _docs(request.param)
    jeng = TpuEngine([jexpand(JPolicy.from_dict(copy.deepcopy(d)))
                      for d in docs])
    teng = TorchEngine([texpand(TPolicy.from_dict(copy.deepcopy(d)))
                        for d in docs], device="cpu")
    return request.param, jeng, teng


def witness_view(w):
    info = None if w.info is None else dataclasses.asdict(w.info)
    return (w.resource, w.rule_row, w.intent, w.operation, w.ns_labels,
            info, w.note)


def test_synthesize_parity(engines):
    _, jeng, teng = engines
    jcorpus, jper = jsynthesize(jeng.cps)
    tcorpus, tper = tsynthesize(teng.cps)
    assert len(jcorpus) > 0
    assert [witness_view(w) for w in tcorpus] \
        == [witness_view(w) for w in jcorpus]
    assert {r: dataclasses.asdict(s) for r, s in tper.items()} \
        == {r: dataclasses.asdict(s) for r, s in jper.items()}


def test_evaluate_corpus_parity(engines):
    _, jeng, teng = engines
    corpus, _ = jsynthesize(jeng.cps)
    tcorpus, _ = tsynthesize(teng.cps)
    jtable, jn = jevaluate(jeng, corpus, tile=16)
    ttable, tn = tevaluate(teng, tcorpus, tile=16)
    assert tn == jn and jn > 1
    assert ttable.dtype == jtable.dtype and ttable.shape == jtable.shape
    assert (ttable == jtable).all()


def report_view(report):
    doc = report.to_dict()
    doc["stats"] = {k: v for k, v in doc["stats"].items() if k not in TIMINGS}
    doc["evidence"] = [a.evidence for a in report.anomalies]
    return doc, report.render_table()


def test_analyze_engine_parity(engines):
    name, jeng, teng = engines
    jrep = janalyze(jeng)
    trep = tanalyze(teng)
    assert report_view(trep) == report_view(jrep)
    counts = trep.counts()
    assert trep.stats["refuted"] == 0
    if name == "seeded_anomalies.yaml":
        assert all(counts[k] >= 1 for k in counts), counts
    else:
        assert not trep.anomalies


def test_validation_parity(monkeypatch):
    """Every validate_policy call of tests/test_policy_validation.py,
    recorded as it runs, gives the same (errors, warnings) in the
    port."""
    import kyverno_tpu.policy.validation as jval
    import test_policy_validation as suite
    from kyverno_tpu_torch.policy.validation import validate_policy

    calls = []
    real = jval.validate_policy

    def recording(policy, *a, **kw):
        out = real(policy, *a, **kw)
        calls.append((copy.deepcopy(policy.raw), a, kw, out))
        return out

    monkeypatch.setattr(jval, "validate_policy", recording)
    monkeypatch.setattr(suite, "validate_policy", recording)
    names = [n for n in dir(suite) if n.startswith("test_")]
    for n in names:
        getattr(suite, n)()
    monkeypatch.undo()
    assert len(names) >= 10 and len(calls) >= 30
    kinds = set()
    for raw, a, kw, want in calls:
        got = validate_policy(TPolicy.from_dict(copy.deepcopy(raw)), *a, **kw)
        assert got == want, raw.get("metadata")
        kinds.add((bool(want[0]), bool(want[1])))
    # calls with errors, with warnings and clean ones were all compared
    assert {(True, False), (False, True), (False, False)} <= kinds


def _lint_policies():
    from test_analysis import _tiny_policies

    return [p.raw for p in _tiny_policies()]


def test_run_lint_runs_and_is_idempotent():
    from kyverno_tpu.cluster import PolicyCache as JCache
    from kyverno_tpu.lifecycle import PolicySetLifecycleManager as JManager
    from kyverno_tpu_torch.cluster import PolicyCache
    from kyverno_tpu_torch.lifecycle import PolicySetLifecycleManager
    from kyverno_tpu_torch.lifecycle.manager import default_compile_fn
    from kyverno_tpu_torch.observability.analytics import (_static_status,
                                                           global_rule_stats)

    cache = PolicyCache()
    jcache = JCache()
    for d in _lint_policies():
        cache.set(TPolicy.from_dict(copy.deepcopy(d)))
        jcache.set(JPolicy.from_dict(copy.deepcopy(d)))
    mgr = PolicySetLifecycleManager(
        cache, compile_fn=default_compile_fn(device="cpu"))
    jmgr = JManager(jcache)
    version = mgr.acquire()
    jmgr.acquire()
    compiles = mgr.stats["compiles"]
    report = mgr.run_lint()
    jreport = jmgr.run_lint()
    assert report is not None and report_view(report) == report_view(jreport)
    assert any(a.kind == "redundant" for a in report.anomalies)
    # the active engine was analysed as it was: no compile
    assert mgr.stats["compiles"] == compiles and mgr.stats["lints"] == 1
    assert global_analysis.report is report and global_analysis.lint_enabled
    assert global_analysis.runs == jglobal_analysis.runs == {
        "ok": 1, "aborted": 0, "error": 0}
    # idempotent per (content hash, quarantine set)
    assert mgr.run_lint() is None and mgr.stats["lints"] == 1
    assert mgr.run_lint(force=True) is not None and mgr.stats["lints"] == 2
    # the observatory's static correlation resolves
    global_rule_stats.register(version.engine.rule_idents())
    never = global_rule_stats.report(top=5)["never_fired"]
    assert never and all(r["static"] == "ok" for r in never)
    for r in never:
        assert _static_status(r["policy"], r["rule"]) \
            == jglobal_analysis.static_for(r["policy"], r["rule"])
