"""The port's guarded dispatch ladder against the JAX package's, on the
CPU (tests/test_resilience.py's device cases, run through both).

Each case goes through the reference (``TpuEngine`` / its
``ShardedScanner`` on a one-device mesh, verdict cache off) and through
the port (``TorchEngine(device="cpu")`` / ``ShardedScanner``), and the
two ``ScanResult``s must be equal:

- an armed ``tpu.dispatch`` fault keeps every verdict, trips the port's
  breaker after its threshold and counts ``breaker_fallback`` (reason
  "error" while closed, "open" once tripped, when the device is not even
  tried);
- a corrupt-shape fault is a device failure, and the half-open probe
  that follows closes the breaker;
- hostile resources (``metadata: "x"``, ``kind: 7``,
  ``metadata.namespace: ["x"]``) between two good Pods are quarantined
  by ``TorchEngine.scan`` and ``ShardedScanner.scan``; one the scalar
  engine cannot evaluate either gives per-rule ERROR;
- an armed ``mutate.triage`` fault answers the triage batch all-HOST
  and ``apply_mutations`` then gives the patches of the clean run;
- a ``kernels.KernelError`` (a kernel of the port that fails to build,
  load or launch, or a failed CUDA-graph capture) is raised through
  every path of the ladder, counted as ``kernel_errors``, and neither
  answered all-HOST nor held against the breaker (port only: the
  reference has no such error).

Faults and breakers are process-wide in both packages: a fixture
disarms and resets both around every test."""

import copy

import jax
import numpy as np
import pytest

from kyverno_tpu.api.policy import ClusterPolicy as JaxPolicy
from kyverno_tpu.mutation.coordinator import \
    apply_mutations as jax_apply_mutations
from kyverno_tpu.parallel.sharding import ShardedScanner as JScanner
from kyverno_tpu.parallel.sharding import make_mesh
from kyverno_tpu.policies import load_pss_policies
from kyverno_tpu.policy.autogen import expand_policy
from kyverno_tpu.resilience import faults as jfaults
from kyverno_tpu.resilience.breaker import tpu_breaker as jax_breaker
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch.kernels import KernelError
from kyverno_tpu_torch.mutation.coordinator import apply_mutations
from kyverno_tpu_torch.observability.metrics import global_registry
from kyverno_tpu_torch.parallel.sharding import ShardedScanner
from kyverno_tpu_torch.resilience.breaker import CLOSED, OPEN, tpu_breaker
from kyverno_tpu_torch.resilience.faults import (SITE_MUTATE_TRIAGE,
                                                 SITE_TPU_DISPATCH,
                                                 global_faults)
from kyverno_tpu_torch.tpu.engine import TorchEngine, class_counts
from kyverno_tpu_torch.tpu.evaluator import ERROR, FAIL, HOST, PASS

from test_torch_mutation import bench_policies, port_scalar_chain
from test_torch_mutation import _pod as _ns_pod
from torch_parity_util import assert_result_equal, port_policies
from torch_parity_util import (fresh_port_state,  # noqa: F401
                               no_port_verdict_cache)


@pytest.fixture(autouse=True)
def _clean(no_verdict_cache, no_port_verdict_cache):
    for reg in (global_faults, jfaults.global_faults):
        reg.disarm()
    tpu_breaker().reset()
    jax_breaker().reset()
    yield
    for reg in (global_faults, jfaults.global_faults):
        reg.disarm()
    tpu_breaker().reset()
    jax_breaker().reset()


def _pod(name, priv):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{
                "name": "c", "image": "nginx",
                "securityContext": {"privileged": priv}}]}}


HOSTILE = {
    "metadata-not-a-map": {"apiVersion": "v1", "kind": "Pod",
                           "metadata": "x"},
    "kind-not-a-string": {"apiVersion": "v1", "kind": 7,
                          "metadata": {"name": "k", "namespace": "default"}},
    "namespace-a-list": {"apiVersion": "v1", "kind": "Pod",
                         "metadata": {"name": "n", "namespace": ["x"]}},
}


@pytest.fixture(scope="module")
def pss4():
    """The first four bundled PSS policy files, compiled by each
    package."""
    policies = [expand_policy(p) for p in load_pss_policies()[:4]]
    jeng = TpuEngine(policies)
    teng = TorchEngine(port_policies(policies), device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def scanners(pss4):
    jeng, _ = pss4
    js = JScanner(jeng.cps.policies, mesh=make_mesh(jax.devices()[:1]))
    ts = ShardedScanner(port_policies(jeng.cps.policies), device="cpu")
    return js, ts


def _fallbacks(reason):
    return global_registry.breaker_fallback.value({"reason": reason})


def _arm(site, **kw):
    global_faults.arm(site, **kw)
    jfaults.global_faults.arm(site, **kw)


def test_dispatch_fault_keeps_verdicts_and_trips_the_breaker(pss4):
    jeng, teng = pss4
    assert teng.breaker is tpu_breaker()
    teng.breaker.reset(failure_threshold=2, reset_timeout_s=60.0)
    jeng.breaker.reset(failure_threshold=2, reset_timeout_s=60.0)
    resources = [_pod("a", True), _pod("b", False)]
    want = jeng.scan(copy.deepcopy(resources))
    assert_result_equal(want, teng.scan(copy.deepcopy(resources)))
    err0, open0 = _fallbacks("error"), _fallbacks("open")

    _arm(SITE_TPU_DISPATCH, mode="raise", p=1.0)
    for state in (CLOSED, OPEN):  # failure 1, then failure 2 trips it
        assert_result_equal(want, jeng.scan(copy.deepcopy(resources)))
        assert_result_equal(want, teng.scan(copy.deepcopy(resources)))
        assert teng.breaker.state == jeng.breaker.state == state
    assert _fallbacks("error") - err0 == 2
    # open: the device is not even tried, yet the verdicts are the same
    fired = global_faults.armed()[SITE_TPU_DISPATCH].fired
    assert_result_equal(want, teng.scan(copy.deepcopy(resources)))
    assert global_faults.armed()[SITE_TPU_DISPATCH].fired == fired
    assert _fallbacks("open") - open0 == 1
    # the device layer answers all-HOST while the breaker is open
    table, counts = teng.scan_device(copy.deepcopy(resources))
    assert (table == HOST).all()
    assert (counts[:, HOST] == len(resources)).all()


def test_corrupt_shape_is_a_device_failure(pss4):
    jeng, teng = pss4
    teng.breaker.reset(failure_threshold=1, reset_timeout_s=0.0)
    jeng.breaker.reset(failure_threshold=1, reset_timeout_s=0.0)
    resources = [_pod("a", True), _pod("b", False)]
    want = jeng.scan(copy.deepcopy(resources))
    _arm(SITE_TPU_DISPATCH, mode="corrupt", count=1)
    err0 = _fallbacks("error")
    assert_result_equal(want, teng.scan(copy.deepcopy(resources)))
    assert teng.breaker.state == OPEN
    assert _fallbacks("error") - err0 == 1
    # reset timeout 0: the next scan is the half-open probe, and closes
    assert_result_equal(want, teng.scan(copy.deepcopy(resources)))
    assert teng.breaker.state == CLOSED


@pytest.mark.parametrize("hostile", list(HOSTILE))
def test_hostile_resource_is_quarantined(pss4, hostile):
    jeng, teng = pss4
    resources = [_pod("a", True), HOSTILE[hostile], _pod("b", False)]
    want = jeng.scan(copy.deepcopy(resources))
    got = teng.scan(copy.deepcopy(resources))
    assert_result_equal(want, got)
    # the good Pods kept their device verdicts
    clean = teng.scan(copy.deepcopy([resources[0], resources[2]]))
    assert np.array_equal(got.verdicts[:, [0, 2]], clean.verdicts)


@pytest.mark.parametrize("hostile", list(HOSTILE))
def test_sharded_scan_survives_a_hostile_resource(scanners, hostile):
    js, ts = scanners
    resources = [_pod("a", True), HOSTILE[hostile], _pod("b", False)]
    want = js.scan(copy.deepcopy(resources))
    assert_result_equal(want, ts.scan(copy.deepcopy(resources)))


def test_sharded_scan_device_fault_answers_all_host(scanners):
    js, ts = scanners
    tpu_breaker().reset(failure_threshold=5)
    resources = [_pod("a", True), _pod("b", False), _pod("c", True)]
    want = js.scan(copy.deepcopy(resources))
    err0 = _fallbacks("error")
    global_faults.arm(SITE_TPU_DISPATCH, mode="raise", count=1)
    assert_result_equal(want, ts.scan(copy.deepcopy(resources)))
    assert _fallbacks("error") - err0 == 1
    assert tpu_breaker().state == CLOSED


def test_scalar_failure_gives_per_rule_error(pss4):
    jeng, teng = pss4
    resources = [{"kind": b"x", "metadata": "not-a-dict"}, _pod("ok", False)]
    want = jeng.scan(copy.deepcopy(resources))
    got = teng.scan(copy.deepcopy(resources))
    assert_result_equal(want, got)
    assert (got.verdicts[:, 0] == ERROR).all()
    assert (got.verdicts[:, 1] != ERROR).all()
    assert (got.verdicts[:, 1] == PASS).any()


def test_mutate_triage_fault_answers_all_host():
    docs = bench_policies()
    jeng = TpuEngine([JaxPolicy.from_dict(copy.deepcopy(d)) for d in docs])
    teng = TorchEngine(port_policies(jeng.cps.policies), device="cpu")
    resources = [_ns_pod(f"p{i}", "prod" if i % 3 == 0 else "dev")
                 for i in range(6)]
    clean = teng.triage_mutate(copy.deepcopy(resources), {})
    assert (clean.verdicts != HOST).any()
    dispatched = teng.triage_dispatches
    _arm(SITE_MUTATE_TRIAGE, mode="raise")
    want = jeng.triage_mutate(copy.deepcopy(resources), {})
    got = teng.triage_mutate(copy.deepcopy(resources), {})
    assert got.rules == want.rules
    assert np.array_equal(got.verdicts, want.verdicts)
    assert (got.verdicts == HOST).all()
    assert teng.triage_dispatches == dispatched
    assert global_faults.armed()[SITE_MUTATE_TRIAGE].fired == 1
    for ci, res in enumerate(resources):
        tout = apply_mutations(teng, copy.deepcopy(res), got.rows_for(ci))
        jout = jax_apply_mutations(jeng, copy.deepcopy(res),
                                   want.rows_for(ci))
        ref = apply_mutations(teng, copy.deepcopy(res), clean.rows_for(ci))
        assert tout.patched == jout.patched == ref.patched
        assert tout.patched == port_scalar_chain(teng, res, {}, "CREATE",
                                                 None)


@pytest.mark.parametrize("path", ["scan", "scan_device", "triage",
                                  "sharded_scan"])
def test_kernel_error_is_raised_not_answered_all_host(pss4, scanners,
                                                      monkeypatch, path):
    _, teng = pss4
    _, ts = scanners
    tpu_breaker().reset(failure_threshold=1)

    def broken(lanes):
        raise KernelError("CUDA kernel hash_match failed to launch: "
                          "cudaError 98")

    resources = [_pod("a", True), _pod("b", False)]
    if path == "triage":
        teng = TorchEngine(port_policies(
            [JaxPolicy.from_dict(copy.deepcopy(d)) for d in bench_policies()]),
            device="cpu")
        resources = [_ns_pod("p0", "prod"), _ns_pod("p1", "dev")]
        monkeypatch.setattr(teng.cps, "mutate_device_fn",
                            lambda **kw: broken)
        call = teng.triage_mutate
    elif path == "sharded_scan":
        monkeypatch.setattr(ts, "_step", broken)
        call = ts.scan
    else:
        monkeypatch.setattr(teng, "run", broken)
        call = getattr(teng, path)
    err0, open0 = _fallbacks("error"), _fallbacks("open")
    kerr0 = global_registry.kernel_errors.value()
    for _ in range(2):
        with pytest.raises(KernelError, match="failed to launch"):
            call(copy.deepcopy(resources))
    assert global_registry.kernel_errors.value() - kerr0 == 2
    assert (_fallbacks("error"), _fallbacks("open")) == (err0, open0)
    assert tpu_breaker().state == CLOSED


def _ref_dispatch(jeng, resources):
    """One dispatch of the reference's ladder on ``resources``, as its
    ``_scan_uncached`` makes it -> the live columns of its table."""
    n = len(resources)
    padded = list(resources) + [{} for _ in range(jeng.bucket_size(n) - n)]
    batch, _, _ = jeng.encode(padded, None, None, None)
    return jeng._dispatch(batch, len(padded), n)[:, :n]


def _port_dispatch(teng, resources):
    n = len(resources)
    padded, ops, infos = teng.pad(resources, None, None)
    batch, _, _ = teng.encode(padded, None, ops, infos)
    return teng._dispatch(batch, len(padded), n)[:, :n]


@pytest.mark.parametrize("fault", [None, "flip"])
def test_counts_beside_a_corrupted_table(pss4, monkeypatch, fault):
    """A value-corrupting fault at ``tpu.dispatch`` keeps the table's
    shape, so the ladder serves it: the program's counts of the table
    before the flip must not stand beside it. Both packages drop the
    stash under the fault; ``scan_device`` then counts the table it
    returns. Without the fault the program's counts are used."""
    jeng, teng = pss4
    teng.breaker.reset(failure_threshold=5)
    jeng.breaker.reset(failure_threshold=5)
    resources = [_pod("a", True), _pod("b", False), _pod("c", True)]
    if fault:
        _arm(SITE_TPU_DISPATCH, mode="corrupt", flip=True)
    want = _ref_dispatch(jeng, copy.deepcopy(resources))
    got = _port_dispatch(teng, copy.deepcopy(resources))
    assert np.array_equal(want, got)
    jstash, tstash = jeng.take_pending_counts(), teng.take_pending_counts()
    if fault:
        assert jstash is None and tstash is None
        assert ((want == PASS) | (want == FAIL)).any()  # cells the flip swaps
    else:
        assert np.array_equal(jstash, tstash)

    taken = []
    take = teng.take_pending_counts

    def spy():
        taken.append(take())
        return taken[-1]

    monkeypatch.setattr(teng, "take_pending_counts", spy)
    table, counts = teng.scan_device(copy.deepcopy(resources))
    assert np.array_equal(table, want)
    assert np.array_equal(counts, class_counts(table))
    assert len(taken) == 1
    if fault:
        assert taken[0] is None
        assert global_faults.armed()[SITE_TPU_DISPATCH].fired == 2
    else:
        # the program's own counts, not a recount of the table
        assert taken[0] is not None
        assert np.array_equal(counts, taken[0])
