"""Shared helpers of the tests/test_torch_*.py files: the same inputs go
through the JAX package (the reference) and the PyTorch port.

The corpora of the JAX parity modules are taken as those modules build
them: a module's test function runs with ``TpuEngine.scan`` wrapped so
that every scan it makes is recorded (engine, resources, namespace
labels, operations, user infos, and the ScanResult it returned) and
then carried out as before.

The JAX package's own test modules also run against the port:
``port_test_module`` executes one with its imports pointed at
``kyverno_tpu_torch``, ``scenario_params`` lists its test functions
(expanded over their ``parametrize`` marks) and ``run_port_scenario``
calls one with its fixtures resolved."""

from __future__ import annotations

import ast
import copy
import functools
import inspect
import os
import re
import types
from typing import Any, Dict, List, Optional, Tuple

import jax
import numpy as np
import pytest
import torch

from kyverno_tpu.tpu import engine as jengine
from kyverno_tpu_torch.api.policy import ClusterPolicy as PortPolicy
from kyverno_tpu_torch.engine.match import RequestInfo as PortRequestInfo
from kyverno_tpu_torch.tpu.engine import TorchEngine, class_counts

# The port's CPU program is thousands of small tensor ops; with one
# intra-op thread each op runs inline instead of waking a thread pool,
# which matters when several test workers share the cores.
torch.set_num_threads(1)

# the port's process-global state, reset around each test of a module
# that imports fresh_port_state (tests/conftest.py resets the reference's)
from torch_port_state import fresh_port_state, reset_port_state  # noqa: E402,F401


@pytest.fixture
def no_port_verdict_cache():
    """The port's counterpart of tests/conftest.py's ``no_verdict_cache``:
    for tests that count dispatches on repeat scans of identical
    content (the cache legitimately skips those)."""
    from kyverno_tpu_torch.tpu.cache import global_verdict_cache

    cap = global_verdict_cache._lru.capacity
    global_verdict_cache.set_capacity(0)
    yield
    global_verdict_cache.set_capacity(cap)


# the functions of the JAX parity modules that scan, by module
CORPORA = {
    "test_tpu_parity": [
        "test_equality_anchor_pattern",
        "test_array_of_maps_anchors",
        "test_or_alternatives_leaf",
        "test_deny_multiselect_capabilities",
        "test_deny_keys_projection",
        "test_negation_and_anypattern",
        "test_match_exclude_selectors_namespaces",
        "test_glob_leaf_operand",
        "test_operator_leaves",
        "test_host_fallback_rules_complete",
        "test_static_context_folding",
        "test_literal_key_condition_constant_folds",
        "test_deprecated_in_notin_device_parity",
        "test_deprecated_in_operation_key_and_nonstring_values",
        "test_wildcard_label_selector_device_parity",
        "test_wildcard_selector_invalid_label_syntax_goes_host",
        "test_value_only_wildcard_multi_entries_lower",
        "test_userinfo_key_membership_parity",
        "test_not_null_defaults_loader_semantics_parity",
    ],
    "test_tpu_foreach": [
        "test_foreach_deny_parity",
        "test_foreach_mixed_drop_lists_parity",
        "test_membership_glob_resource_value_falls_back_to_host",
        "test_double_flatten_nested_arrays_parity",
        "test_scalar_chain_glob_value_falls_back",
    ],
    "test_tpu_nested_wildcard": [
        "test_nested_array_of_maps_parity",
        "test_wildcard_metadata_key_parity",
        "test_existence_anchor_depth_accounting",
        "test_wildcard_metadata_key_in_array_scope_falls_back",
        "test_wildcard_key_in_labels_parity",
    ],
}

CORPUS_PARAMS = [pytest.param(mod, name, id=f"{mod}::{name}")
                 for mod, names in CORPORA.items() for name in names]


class Recorded:
    def __init__(self, engine, resources, namespace_labels, operations,
                 admission_infos):
        self.engine = engine
        self.resources = list(resources)
        self.namespace_labels = copy.deepcopy(namespace_labels)
        self.operations = list(operations) if operations else None
        self.admission_infos = list(admission_infos) if admission_infos \
            else None
        self.result = None  # the reference's ScanResult, once recorded


def record_corpus(monkeypatch, module: str, name: str) -> List[Recorded]:
    """Run ``module.name()`` and return every scan it made."""
    import importlib

    mod = importlib.import_module(module)
    seen: List[Recorded] = []
    real = jengine.TpuEngine.scan

    def scan(self, resources, namespace_labels=None, operations=None,
             admission_infos=None, live_n=None):
        rec = Recorded(self, resources, namespace_labels, operations,
                       admission_infos)
        seen.append(rec)
        rec.result = real(self, resources, namespace_labels, operations,
                          admission_infos, live_n=live_n)
        return rec.result

    monkeypatch.setattr(jengine.TpuEngine, "scan", scan)
    getattr(mod, name)()
    monkeypatch.setattr(jengine.TpuEngine, "scan", real)
    assert seen, f"{module}.{name} made no scan"
    return seen


def port_policies(policies) -> List[PortPolicy]:
    return [PortPolicy.from_dict(copy.deepcopy(p.raw)) for p in policies]


def port_infos(infos) -> Optional[List[Any]]:
    if infos is None:
        return None
    return [None if i is None else PortRequestInfo(
        roles=list(i.roles), cluster_roles=list(i.cluster_roles),
        username=i.username, uid=i.uid, groups=list(i.groups))
        for i in infos]


def padded_args(jeng, rec: Recorded):
    n = len(rec.resources)
    padded_n = jeng.bucket_size(max(n, 1))
    pad = padded_n - n
    resources = rec.resources + [{} for _ in range(pad)]
    ops = rec.operations + [""] * pad if rec.operations else None
    infos = rec.admission_infos + [None] * pad if rec.admission_infos \
        else None
    return resources, ops, infos


def jax_encode(jeng, rec: Recorded) -> Dict[str, np.ndarray]:
    resources, ops, infos = padded_args(jeng, rec)
    return jeng.encode(resources, rec.namespace_labels, ops, infos)[0]


def jax_device_scan(jeng, rec: Recorded):
    """The JAX package's device program on the recorded scan, as
    TpuEngine._dispatch runs it: (table[:, :n], counts less the pad
    columns), both int32."""
    n = len(rec.resources)
    batch = jax_encode(jeng, rec)
    table, counts = jeng.cps.device_fn()(jax.device_put(batch))
    table, counts = np.asarray(table), np.asarray(counts)
    counts = (counts.astype(np.int64) - class_counts(table[:, n:])
              ).astype(np.int32)
    return table[:, :n], counts


def port_engine(jeng, exceptions=None) -> TorchEngine:
    """The port's CPU engine over the reference engine's policies and
    (unless given) its PolicyExceptions."""
    if exceptions is None:
        exceptions = jeng.scalar.exceptions
    docs = [e if isinstance(e, dict) else e.raw for e in exceptions]
    return TorchEngine(port_policies(jeng.cps.policies), device="cpu",
                       exceptions=copy.deepcopy(docs))


def port_scan_device(teng: TorchEngine, rec: Recorded):
    """The port's device layer on the recorded scan: (table, counts)."""
    return teng.scan_device(rec.resources, rec.namespace_labels,
                            rec.operations, port_infos(rec.admission_infos))


def port_scan(teng: TorchEngine, rec: Recorded):
    """The port's complete scan (scalar-completed ScanResult)."""
    return teng.scan(rec.resources, rec.namespace_labels, rec.operations,
                     port_infos(rec.admission_infos))


def assert_result_equal(want, got) -> None:
    """Two ScanResults (the reference's and the port's) are the same:
    table (dtype, shape, cells), rules, counts() and violations()."""
    assert got.verdicts.dtype == want.verdicts.dtype
    assert got.verdicts.shape == want.verdicts.shape
    assert np.array_equal(got.verdicts, want.verdicts)
    assert list(got.rules) == list(want.rules)
    assert got.counts() == want.counts()
    assert got.violations() == want.violations()
    assert not ((got.verdicts >= 5).any())  # HOST / CONFIRM never escape


def assert_full_scan_equal(teng: TorchEngine, rec: Recorded) -> None:
    """The port's TorchEngine.scan equals the recorded TpuEngine.scan."""
    assert rec.result is not None
    assert_result_equal(rec.result, port_scan(teng, rec))


def assert_same_program(jeng, teng: TorchEngine) -> None:
    """Both compilers lowered the same rules to the same device rows."""
    jrows = [(e.policy_name, e.rule_name, e.device_row) for e in jeng.cps.rules]
    trows = [(e.policy_name, e.rule_name, e.device_row) for e in teng.cps.rules]
    assert jrows == trows


def assert_scan_equal(jeng, teng: TorchEngine, rec: Recorded) -> None:
    """The port's device table and counts (``scan_device``) equal the
    JAX package's device program on the recorded scan."""
    want_table, want_counts = jax_device_scan(jeng, rec)
    got_table, got_counts = port_scan_device(teng, rec)
    assert got_table.dtype == np.int32 and got_counts.dtype == np.int32
    assert got_table.shape == want_table.shape
    assert np.array_equal(got_table, want_table)
    assert np.array_equal(got_counts, want_counts)


def assert_lanes_equal(want: Dict[str, np.ndarray],
                       got: Dict[str, np.ndarray]) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        assert g.dtype == v.dtype, (k, g.dtype, v.dtype)
        assert g.shape == v.shape, (k, g.shape, v.shape)
        assert np.array_equal(g, v), k


def port_lanes_cpu(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    from kyverno_tpu_torch.tpu.engine import lanes_to_device

    return lanes_to_device(batch, "cpu")


# ---------------------------------------------------------------------------
# the JAX package's own test functions, run against the port

_TESTS = os.path.dirname(os.path.abspath(__file__))
_PYTEST_FIXTURES = {"tmp_path", "capsys", "monkeypatch", "request"}


@functools.lru_cache(maxsize=None)
def port_test_module(name: str, rewrites: Tuple[Tuple[str, str], ...] = ()):
    """tests/<name>.py executed with every ``kyverno_tpu.`` pointed at
    ``kyverno_tpu_torch.`` and then each (pattern, replacement) of
    ``rewrites`` applied to its source: the reference test's scenarios,
    run against the port. One module object per (name, rewrites)."""
    path = os.path.join(_TESTS, f"{name}.py")
    src = re.sub(r"\bkyverno_tpu\.", "kyverno_tpu_torch.", open(path).read())
    for pattern, repl in rewrites:
        src = re.sub(pattern, repl, src)
    mod = types.ModuleType(f"port_{name}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def scenario_params(name: str, skip: Tuple[str, ...] = ()) -> List[Any]:
    """One pytest param (module name, function name, its parametrize
    arguments) for each test function of tests/<name>.py not in
    ``skip``, expanded over its ``parametrize`` marks."""
    out = []
    tree = ast.parse(open(os.path.join(_TESTS, f"{name}.py")).read())
    for node in tree.body:
        if not (isinstance(node, ast.FunctionDef)
                and node.name.startswith("test_") and node.name not in skip):
            continue
        cases = [({}, "")]
        for deco in node.decorator_list:
            if (isinstance(deco, ast.Call)
                    and getattr(deco.func, "attr", "") == "parametrize"):
                names = [n.strip() for n in
                         ast.literal_eval(deco.args[0]).split(",")]
                values = ast.literal_eval(deco.args[1])
                cases = [({**kw, **dict(zip(names, v if len(names) > 1
                                            else (v,)))},
                          f"{tag}[{'-'.join(map(str, v if len(names) > 1 else (v,)))}]")
                         for kw, tag in cases for v in values]
        for kw, tag in cases:
            out.append(pytest.param(name, node.name, kw,
                                    id=f"{name}::{node.name}{tag}"))
    return out


def run_port_scenario(module, name: str, params: Dict[str, Any],
                      request) -> None:
    """Call ``module.<name>`` with ``params`` and its other arguments
    resolved as pytest would: pytest's own fixtures from ``request``,
    the module's fixtures (function scope) by calling them, generator
    fixtures torn down after the call."""
    cache: Dict[str, Any] = dict(params)
    teardown = []

    def resolve(arg):
        if arg in cache:
            return cache[arg]
        if arg in _PYTEST_FIXTURES:
            value = request.getfixturevalue(arg)
        else:
            fx = getattr(module, arg)
            fn = getattr(fx, "_get_wrapped_function", lambda: fx)()
            value = fn(**{a: resolve(a)
                          for a in inspect.signature(fn).parameters})
            if inspect.isgenerator(value):
                teardown.append(value)
                value = next(value)
        cache[arg] = value
        return value

    fn = getattr(module, name)
    try:
        fn(**{a: resolve(a) for a in inspect.signature(fn).parameters})
    finally:
        for gen in reversed(teardown):
            next(gen, None)


def port_cli_main(argv=None) -> int:
    """The port's ``python -m kyverno_tpu_torch`` entry, with
    ``--device cpu`` added to the commands that take it (``apply``,
    ``analyze``) unless the caller named a device or asked for help."""
    from kyverno_tpu_torch.cli.__main__ import main

    argv = list(argv or [])
    if argv and argv[0] in ("apply", "analyze") and "--device" not in argv \
            and not {"-h", "--help"} & set(argv):
        argv += ["--device", "cpu"]
    return main(argv)
