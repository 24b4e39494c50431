"""The compile is observable on the port as on the JAX package: the
``compile`` phase of the profiler's breakdown, the
``kyverno_tpu_compile_cache_total{outcome}`` deltas of each path that
looks a program up, and the ``policy_set_compile`` / ``xla_jit_build`` /
``xla_jit_build_mutate`` spans with their attributes. Each case makes
the same calls on both packages and compares what their own
observability recorded."""

from __future__ import annotations

import copy

import pytest

from kyverno_tpu.api.policy import ClusterPolicy as RefPolicy
from kyverno_tpu_torch.api.policy import ClusterPolicy as PortPolicy
from torch_parity_util import fresh_port_state  # noqa: F401 - autouse
from torch_parity_util import no_port_verdict_cache  # noqa: F401
from torch_parity_util import port_cli_main

POLICY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "t"},
    "spec": {"rules": [{
        "name": "r",
        "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
        "validate": {"pattern": {"metadata": {"name": "?*"}}},
    }]},
}

MUTATE = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "m"},
    "spec": {"rules": [{
        "name": "add-label",
        "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
        "mutate": {"patchStrategicMerge": {
            "metadata": {"labels": {"+(team)": "core"}}}},
    }]},
}

PODS = [{"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": f"p{i}", "namespace": "d"}, "spec": {}}
        for i in range(8)]


class Side:
    """One package's compile-relevant observability."""

    def __init__(self, pkg: str):
        from importlib import import_module

        self.pkg = pkg
        self.registry = import_module(
            f"{pkg}.observability.metrics").global_registry
        self.profiler = import_module(
            f"{pkg}.observability.profiling").global_profiler
        self.tracer = import_module(
            f"{pkg}.observability.tracing").global_tracer
        self.Policy = RefPolicy if pkg == "kyverno_tpu" else PortPolicy

    def cache(self):
        values = self.registry.compile_cache._values
        return {o: values.get((("outcome", o),), 0.0)
                for o in ("miss", "hit")}

    def mark(self):
        self.profiler.reset()
        self._cache0 = self.cache()
        self._spans0 = {n: len(self.tracer.finished(n))
                        for n in ("policy_set_compile", "xla_jit_build",
                                  "xla_jit_build_mutate")}

    def since(self):
        """(phases of the breakdown, compile_cache deltas, new compile
        spans by name with their attributes)."""
        c = self.cache()
        spans = {}
        for n, k in self._spans0.items():
            new = self.tracer.finished(n)[k:]
            spans[n] = [{a: s.attributes[a] for a in sorted(s.attributes)
                         if a in ("policies", "quarantined", "programs")}
                        for s in new]
        return (sorted(self.profiler.breakdown()),
                {o: c[o] - self._cache0[o] for o in c}, spans)


def _engine(side, policies):
    pols = [side.Policy.from_dict(copy.deepcopy(p)) for p in policies]
    if side.pkg == "kyverno_tpu":
        from kyverno_tpu.tpu.engine import TpuEngine

        return TpuEngine(pols)
    from kyverno_tpu_torch.tpu.engine import TorchEngine

    return TorchEngine(pols, device="cpu")


def _scanner(side, policies):
    pols = [side.Policy.from_dict(copy.deepcopy(p)) for p in policies]
    if side.pkg == "kyverno_tpu":
        from kyverno_tpu.parallel.sharding import ShardedScanner, make_mesh

        return ShardedScanner(pols, mesh=make_mesh())
    from kyverno_tpu_torch.parallel.sharding import ShardedScanner

    return ShardedScanner(pols, device="cpu")


def _two_scans(side):
    eng = _engine(side, [POLICY])
    eng.scan(copy.deepcopy(PODS[:1]))
    eng.scan(copy.deepcopy(PODS[:1]))


def _sharded_scan(side):
    _scanner(side, [POLICY]).scan(copy.deepcopy(PODS))


def _triage(side):
    eng = _engine(side, [POLICY, MUTATE])
    eng.triage_mutate(copy.deepcopy(PODS))
    eng.triage_mutate(copy.deepcopy(PODS))


def _quarantined_compile(side):
    from importlib import import_module

    compiler = import_module(f"{side.pkg}.tpu.compiler")
    pols = [side.Policy.from_dict(copy.deepcopy(p))
            for p in (POLICY, MUTATE)]
    compiler.compile_policy_set(pols, quarantine={1: "crashed"})


CALLS = {"two_scans": _two_scans, "sharded_scan": _sharded_scan,
         "triage_mutate": _triage, "quarantined_compile": _quarantined_compile}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_compile_observability_equals_reference(call):
    ref, port = Side("kyverno_tpu"), Side("kyverno_tpu_torch")
    got = {}
    for side in (ref, port):
        side.mark()
        CALLS[call](side)
        got[side.pkg] = side.since()
    phases, deltas, spans = got["kyverno_tpu_torch"]
    assert (phases, deltas, spans) == got["kyverno_tpu"]
    assert "compile" in phases
    assert len(spans["policy_set_compile"]) >= 1


def test_two_scans_count_one_miss_then_hits(no_verdict_cache,
                                            no_port_verdict_cache):
    """tests/test_observability_tracing.py's assertion of the reference,
    on both packages with their verdict caches off: one program build,
    then a lookup that finds it."""
    ref, port = Side("kyverno_tpu"), Side("kyverno_tpu_torch")
    got = {}
    for side in (ref, port):
        side.mark()
        _two_scans(side)
        got[side.pkg] = side.since()
    phases, deltas, spans = got["kyverno_tpu_torch"]
    assert (phases, deltas, spans) == got["kyverno_tpu"]
    for phase in ("encode", "compile", "dispatch", "readback"):
        assert phase in phases, phases
    assert deltas["miss"] == 1 and deltas["hit"] >= 1, deltas
    assert spans["xla_jit_build"] == [{"programs": 1}]
    assert spans["policy_set_compile"] == [{"policies": 1,
                                            "quarantined": 0}]


def test_apply_profile_prints_a_compile_row(tmp_path, capsys):
    pol = tmp_path / "p.yaml"
    pol.write_text("""
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata: {name: named}
spec:
  rules:
    - name: has-name
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate: {message: m, pattern: {metadata: {name: "?*"}}}
""")
    res = tmp_path / "r.yaml"
    res.write_text("""
apiVersion: v1
kind: Pod
metadata: {name: ok, namespace: default}
spec: {containers: [{name: c, image: nginx}]}
""")
    rc = port_cli_main(["apply", str(pol), "-r", str(res), "--profile"])
    err = capsys.readouterr().err
    assert rc == 0
    assert "per-phase latency breakdown" in err
    rows = [line.split()[0] for line in err.splitlines() if line.strip()]
    assert "compile" in rows and "dispatch" in rows, err
