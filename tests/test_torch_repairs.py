"""Repairs of the PyTorch port (kyverno_tpu_torch) held against the JAX
package on the CPU.

- The port's vocabulary encode (``encode_resources_vocab``) loads its
  own native encoder and equals the JAX package's lane for lane: the
  native walk against the native walk, and the Python walk against the
  Python walk (the two walks may order vocabulary rows differently, so
  like is paired with like).
- ``compile_policy_set`` with a ConfigMap data source folds the map as
  the JAX package does (device programs and ``context_deps``).
- ``TorchEngine.scan`` returns the reference's scalar-completed
  ScanResult over ALL rules (codes 0..4 only, ``counts()`` and
  ``violations()``), here on PSS and with a PolicyException; the
  corpora of the JAX parity modules are held in test_torch_engine.py.
- ``lanes_to_device`` carries uint16 lanes (the vocabulary index
  tables) as their raw bytes.

Every comparison is exact."""

import copy
import random

import numpy as np
import pytest
import torch

from kyverno_tpu.api.policy import ClusterPolicy
from kyverno_tpu.engine.contextloaders import DataSources
from kyverno_tpu.native import load as jax_native_load
from kyverno_tpu.policies import load_pss_policies
from kyverno_tpu.policy.autogen import expand_policy
from kyverno_tpu.tpu import flatten as jflat
from kyverno_tpu.tpu.compiler import compile_policy_set as jcompile
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch.engine.contextloaders import \
    DataSources as PortDataSources
from kyverno_tpu_torch.native import load as port_native_load
from kyverno_tpu_torch.tpu import flatten as tflat
from kyverno_tpu_torch.tpu.compiler import compile_policy_set as tcompile
from kyverno_tpu_torch.tpu.engine import ScanResult, lanes_to_device

from test_tpu_pss_parity import _resource
from torch_parity_util import (assert_result_equal, port_engine,
                               port_policies)
from torch_parity_util import fresh_port_state  # noqa: F401


def _vocab_fields(vb):
    return {"row_idx": vb.row_idx, "n_rows": vb.n_rows,
            "fallback": vb.fallback, "pool_sidx": vb.pool_sidx,
            **{"lane_" + k: v for k, v in vb.lanes.items()}}


def _assert_vocab_equal(want, got):
    w, g = _vocab_fields(want), _vocab_fields(got)
    assert sorted(w) == sorted(g)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert g[k].shape == w[k].shape, k
        assert np.array_equal(g[k], w[k]), k
    assert list(got.strs) == list(want.strs)
    assert got.vocab_size == want.vocab_size


def _python_walk(F, res, cfg, bp, kbp):
    """The Python vocabulary walk of flatten module ``F``, driven
    directly (``load()`` memoizes the native choice per process)."""
    enc = F._FastEncoder(F._CfgShell(cfg), set(bp), set(kbp))
    vb = F.VocabBatch(len(res), cfg)
    for i, r in enumerate(res):
        enc.begin(i)
        enc.walk(r, F._ROOT_REC, 0, 0, -1, -1, 0)
        vb.n_rows[i] = enc.row
        vb.fallback[i] = 0 if enc.ok else 1
    F._finish_vocab(enc, vb)
    return vb


def _encode_cases():
    """(resources, port cfg, reference cfg, byte paths, key byte paths)
    per case: PSS resources under the PSS set's byte paths, and the
    overflow shapes of test_vocab_encode.py."""
    pss = jcompile([expand_policy(p)
                    for p in load_pss_policies("restrict-apparmor")])
    rng = random.Random(11)
    pods = [_resource(rng, i) for i in range(40)] + [{}]
    bp, kbp = sorted(pss.byte_paths), sorted(pss.key_byte_paths)
    from kyverno_tpu.tpu.hashing import hash_path

    small_pool = ((1, 4), {hash_path(("a",)), hash_path(("b",))})
    return [
        ("pss", pods, {}, bp, kbp),
        ("row-overflow", [{"a": {f"k{i}": i for i in range(20)}}, {"b": 1}],
         {"max_rows": 8}, (), ()),
        ("instance-overflow",
         [{"spec": {"containers": [{"n": i} for i in range(4)]}},
          {"spec": {"containers": [{"env": [{"v": i} for i in range(4)]}]}}],
         {"max_instances": 2}, (), ()),
        ("pool-overflow", [{"a": "xy", "b": "zw"}, {"a": "toolongvalue"}],
         {"byte_pool_slots": small_pool[0][0],
          "byte_pool_width": small_pool[0][1]}, sorted(small_pool[1]), ()),
    ]


ENCODE_CASES = _encode_cases()


@pytest.mark.parametrize("case", ENCODE_CASES, ids=[c[0] for c in ENCODE_CASES])
def test_vocab_encode_native_walk_equals_reference(case):
    """Fault 1: the port's encode_resources_vocab imported a native
    module that did not exist. It now builds its own copy of
    fastencode.c, and its lanes equal the JAX native walk's."""
    if jax_native_load() is None:
        pytest.skip("the JAX package's native encoder does not build here")
    assert port_native_load() is not None
    _, res, kw, bp, kbp = case
    want = jflat.encode_resources_vocab(copy.deepcopy(res),
                                        jflat.EncodeConfig(**kw), bp, kbp)
    got = tflat.encode_resources_vocab(copy.deepcopy(res),
                                       tflat.EncodeConfig(**kw), bp, kbp)
    _assert_vocab_equal(want, got)


@pytest.mark.parametrize("case", ENCODE_CASES, ids=[c[0] for c in ENCODE_CASES])
def test_vocab_encode_python_walk_equals_reference(case):
    _, res, kw, bp, kbp = case
    want = _python_walk(jflat, copy.deepcopy(res), jflat.EncodeConfig(**kw),
                        bp, kbp)
    got = _python_walk(tflat, copy.deepcopy(res), tflat.EncodeConfig(**kw),
                       bp, kbp)
    _assert_vocab_equal(want, got)


def test_native_library_is_built_outside_the_package():
    import os

    from kyverno_tpu_torch import native

    path = native.library_path()
    assert os.sep + os.path.join("build", "native") + os.sep in path
    assert "kyverno_tpu_torch" not in os.path.relpath(
        path, os.path.dirname(os.path.dirname(native.__file__)))


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


@pytest.mark.parametrize("mode", ["allow", "deny"])
def test_configmap_data_source_compiles_as_reference(mode):
    """Fault 2: compiling a ConfigMap context entry imported a missing
    cluster.snapshot module. The port folds the map as the JAX package
    does: same device rows, programs and context dependencies."""
    jcps = jcompile([ClusterPolicy.from_dict(copy.deepcopy(_CM_POLICY))],
                    data_sources=DataSources(configmaps=_CM(mode)))
    tcps = tcompile(port_policies(jcps.policies),
                    data_sources=PortDataSources(configmaps=_CM(mode)))
    assert jcps.context_deps and tcps.context_deps == jcps.context_deps
    assert [(e.policy_name, e.rule_name, e.device_row) for e in tcps.rules] \
        == [(e.policy_name, e.rule_name, e.device_row) for e in jcps.rules]
    assert [repr(p) for p in tcps.device_programs] \
        == [repr(p) for p in jcps.device_programs]


@pytest.fixture(scope="module")
def pss():
    jeng = TpuEngine([expand_policy(p) for p in load_pss_policies()])
    return jeng, port_engine(jeng)


@pytest.mark.parametrize("seed", [3, 8])
def test_pss_scan_returns_the_reference_scan_result(pss, seed):
    """Fault 3: TorchEngine.scan returned the raw device table. It now
    returns the reference's ScanResult over all rules."""
    jeng, teng = pss
    rng = random.Random(seed)
    resources = [_resource(rng, i) for i in range(29)]
    ops = [rng.choice(["", "CREATE", "UPDATE", "DELETE"]) for _ in resources]
    want = jeng.scan(resources, operations=ops)
    got = teng.scan(resources, operations=ops)
    assert isinstance(got, ScanResult)
    assert_result_equal(want, got)
    assert got.counts()["fail"] > 0 and got.violations()


_PRIV = {"securityContext": {"privileged": True}}


def _priv_pods():
    out = []
    for i, ns in enumerate(["default", "exempt", "default", "exempt"]):
        c = {"name": "c", "image": "nginx", **(_PRIV if i < 3 else {})}
        out.append({"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": f"p{i}", "namespace": ns},
                    "spec": {"containers": [c]}})
    return out


def test_policy_exception_scan_equals_reference():
    """A PolicyException moves the rules it names to the scalar engine,
    which skips the excepted resources, as in the reference."""
    exc = {"apiVersion": "kyverno.io/v2", "kind": "PolicyException",
           "metadata": {"name": "exempt-ns", "namespace": "exempt"},
           "spec": {"exceptions": [{
               "policyName": "disallow-privileged-containers",
               "ruleNames": ["privileged-containers",
                             "autogen-privileged-containers"]}],
               "match": {"any": [{"resources": {
                   "kinds": ["Pod"], "namespaces": ["exempt"]}}]}}}
    policies = [expand_policy(p)
                for p in load_pss_policies("disallow-privileged")]
    jeng = TpuEngine(policies, exceptions=[copy.deepcopy(exc)])
    teng = port_engine(jeng, exceptions=[exc])
    assert teng._exception_rules == jeng._exception_rules != set()
    pods = _priv_pods()
    want = jeng.scan(pods)
    got = teng.scan(pods)
    assert_result_equal(want, got)
    row = got.rules.index(("disallow-privileged-containers",
                           "privileged-containers"))
    assert got.verdicts[row].tolist() == [2, 1, 2, 1]
    # the device table of the excepted rule is untouched by the exception
    table, _ = teng.scan_device(pods)
    drow = teng.rules.index(("disallow-privileged-containers",
                             "privileged-containers"))
    assert table[drow].tolist() == [2, 2, 2, 0]


def test_scan_result_api_matches_reference():
    verdicts = np.array([[0, 2, 3], [2, 1, 4]], dtype=np.int32)
    rules = [("p", "a"), ("p", "b")]
    from kyverno_tpu.tpu.engine import ScanResult as JScanResult

    want, got = JScanResult(verdicts, rules), ScanResult(verdicts, rules)
    assert got.counts() == want.counts()
    assert got.violations() == want.violations() == [(0, 1), (1, 0)]


def test_lanes_to_device_carries_uint16_lanes():
    """Fault 4: the lane dtype map had no uint16, so a vocabulary batch
    with a uint16 index table raised."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 65536, size=(5, 7)).astype(np.uint16)
    sidx = rng.integers(0, 300, size=(5, 3)).astype(np.uint16)
    out = lanes_to_device({"row_idx": idx, "pool_sidx": sidx}, "cpu")
    for k, want in (("row_idx", idx), ("pool_sidx", sidx)):
        t = out[k]
        assert t.dtype == torch.uint16 and tuple(t.shape) == want.shape
        assert t.numpy().tobytes() == want.tobytes()
        wide = t.view(torch.int16).to(torch.int32) & 0xFFFF
        assert np.array_equal(wide.numpy(), want.astype(np.int32))
