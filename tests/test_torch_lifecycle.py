"""The port's policy-set lifecycle (``kyverno_tpu_torch/lifecycle``,
``cluster/policycache.py``) and its compile-time quarantine
(``tpu/compiler.py``), against the JAX package's, on the CPU
(tolerance: exact).

- ``compile_policy_set(quarantine=...)`` gives the same rule entries
  (names, host flag, reason), the same quarantine and the same
  ``cache_key`` in both packages, and scans give equal tables.
- The manager in sync mode, driven by one script in both packages:
  a swap on a cache change, a compile fault that quarantines the new
  policy (two raises: the full set, then its probe), its heal, and a
  set-level failure that rolls back; ``state()`` is the same after
  every step (timers aside).
- Through the pipeline's ``version_provider`` every flush pins one
  version, and each request's rows equal a scan under it.
- ``PolicyDirWatcher`` on a temporary directory.
- With ``analyze_on_swap`` False (the default) a swap never lints; the
  lint itself resolves (tests/test_torch_analysis.py compares it).
- With ``analyze_on_swap`` set, a CUDA engine of a version to promote
  has its lint tile's bucket warmed before the swap, and no probe
  compile or CPU engine is warmed (the lint then only replays on the
  card; tests/test_torch_cuda.py checks that there)."""

import concurrent.futures
import copy
import time

import numpy as np
import pytest
import torch

from kyverno_tpu.api.policy import ClusterPolicy as JPolicy
from kyverno_tpu.cluster.policycache import PolicyCache as JPolicyCache
from kyverno_tpu.lifecycle import PolicySetLifecycleManager as JManager
from kyverno_tpu.policies import load_pss_policies as jload_pss
from kyverno_tpu.policy.autogen import expand_policy as jexpand
from kyverno_tpu.resilience.faults import global_faults as jfaults
from kyverno_tpu.resilience.retry import RetryPolicy as JRetry
from kyverno_tpu.tpu.compiler import compile_policy_set as jcompile
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch.api.policy import ClusterPolicy
from kyverno_tpu_torch.cluster.policycache import PolicyCache
from kyverno_tpu_torch.lifecycle import (PolicyDirWatcher,
                                         PolicySetLifecycleManager)
from kyverno_tpu_torch.lifecycle.manager import default_compile_fn
from kyverno_tpu_torch.policies import load_pss_policies
from kyverno_tpu_torch.policy.autogen import expand_policy
from kyverno_tpu_torch.resilience.faults import global_faults
from kyverno_tpu_torch.resilience.retry import RetryPolicy
from kyverno_tpu_torch.serving import AdmissionPipeline, BatchConfig
from kyverno_tpu_torch.serving import resource_verdicts
from kyverno_tpu_torch.tpu.compiler import compile_policy_set
from kyverno_tpu_torch.tpu.engine import TorchEngine
from kyverno_tpu_torch.tpu.evaluator import FAIL

from test_lifecycle import _pod, _pol_dict, _write
from torch_parity_util import fresh_port_state  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (global_faults, jfaults):
        f.disarm()
    yield
    for f in (global_faults, jfaults):
        f.disarm()


def _entries(cps):
    return [(e.policy_idx, e.policy_name, e.rule_name, e.device_row is None,
             e.fallback_reason) for e in cps.rules]


def _mutate_entries(cps):
    return [(e.policy_name, e.rule_name, e.device_row is None,
             e.fallback_reason) for e in cps.mutate_entries]


@pytest.mark.parametrize("quarantine", [{}, {0: "boom"},
                                        {2: "RuntimeError: lowering crashed",
                                         9: "boom"}])
def test_quarantine_compiles_to_the_reference_entries_and_key(quarantine):
    jp = [jexpand(p) for p in jload_pss()]
    tp = [expand_policy(p) for p in load_pss_policies()]
    want = jcompile(jp, quarantine=quarantine)
    got = compile_policy_set(tp, quarantine=quarantine)
    assert got.quarantined == want.quarantined == quarantine
    assert _entries(got) == _entries(want)
    assert _mutate_entries(got) == _mutate_entries(want)
    assert got.cache_key() == want.cache_key()
    for i, err in quarantine.items():
        q = [e for e in got.rules if e.policy_idx == i]
        assert q and all(e.device_row is None
                         and e.fallback_reason == f"quarantined: {err}"
                         for e in q)
    assert len(got.device_programs) == len(want.device_programs)


def test_quarantined_keys_differ_from_the_plain_set():
    tp = [expand_policy(p) for p in load_pss_policies()]
    assert compile_policy_set(tp).cache_key() != \
        compile_policy_set(tp, quarantine={0: "boom"}).cache_key()


def _docs():
    return [_pol_dict("a"), _pol_dict("b", priv="true"),
            _pol_dict("c", priv="true")]


def test_quarantined_scan_equals_reference():
    docs = _docs()
    q = {1: "boom"}
    jeng = TpuEngine(cps=jcompile([JPolicy.from_dict(copy.deepcopy(d))
                                   for d in docs], quarantine=q))
    teng = TorchEngine(cps=compile_policy_set(
        [ClusterPolicy.from_dict(copy.deepcopy(d)) for d in docs],
        quarantine=q), device="cpu")
    pods = [_pod(f"p{i}", priv=bool(i % 2)) for i in range(5)]
    want, got = jeng.scan(copy.deepcopy(pods)), teng.scan(copy.deepcopy(pods))
    assert got.rules == want.rules
    assert np.array_equal(got.verdicts, want.verdicts)
    # the quarantined policy answers through the scalar oracle: its
    # pattern wants privileged containers, and pods 0, 2, 4 are not
    assert (got.verdicts[1] == FAIL).tolist() == [True, False] * 2 + [True]


def _fast(retry_cls):
    return retry_cls(base_delay_s=0.02, max_delay_s=0.05, jitter=0.0,
                     deadline_s=None)


def _state(mgr):
    st = copy.deepcopy(mgr.state())
    st.pop("set_retry_in_s", None)
    for q in st["quarantined"]:
        q.pop("quarantined_for_s")
        q.pop("next_retry_in_s")
    return st


def _script(cache_cls, policy_cls, manager, faults, retry_cls, scan_pods):
    """One lifecycle script: the state after each step, and each
    promoted version's verdict table over ``scan_pods``."""
    cache = cache_cls()
    mgr = manager(cache, retry_cls)
    states, tables = [], {}

    def step(label):
        v = mgr.acquire()
        states.append((label, v.revision, v.quarantined, _state(mgr)))
        if v.revision not in tables:
            res = v.engine.scan(copy.deepcopy(scan_pods))
            tables[v.revision] = (res.rules, res.verdicts.tolist())

    pol = lambda *a, **k: policy_cls.from_dict(_pol_dict(*a, **k))  # noqa
    cache.set(pol("a"))
    step("first")
    cache.set(pol("b", priv="true"))
    step("swap")
    faults.arm("policyset.compile", mode="raise", count=2)
    cache.set(pol("c", priv="true"))
    step("quarantine")
    faults.disarm()
    time.sleep(0.2)  # past the re-probe's backoff
    step("heal")
    faults.arm("policyset.compile", mode="raise", p=1.0)
    cache.set(pol("d"))
    step("rollback")
    faults.disarm()
    return states, tables, mgr.stats


def test_manager_script_equals_reference():
    pods = [_pod(f"p{i}", priv=bool(i % 2)) for i in range(3)]
    want = _script(JPolicyCache, JPolicy,
                   lambda c, r: JManager(c, retry_policy=_fast(r)),
                   jfaults, JRetry, pods)
    got = _script(PolicyCache, ClusterPolicy,
                  lambda c, r: PolicySetLifecycleManager(
                      c, compile_fn=default_compile_fn(device="cpu"),
                      retry_policy=_fast(r)),
                  global_faults, RetryPolicy, pods)
    assert got == want
    states = dict((s[0], s) for s in got[0])
    assert states["quarantine"][2] == ("c",)
    assert states["heal"][2] == ()
    assert states["rollback"][1] == states["heal"][1]
    assert got[2]["swaps"] >= 3 and got[2]["rollbacks"] == 1
    assert got[2]["quarantine_enters"] == got[2]["quarantine_exits"] == 1


def test_pipeline_pins_one_version_per_flush():
    cache = PolicyCache()
    cache.set(ClusterPolicy.from_dict(_pol_dict("a")))
    mgr = PolicySetLifecycleManager(
        cache, compile_fn=default_compile_fn(device="cpu"),
        retry_policy=_fast(RetryPolicy))
    flushes = []

    def evaluate(padded, version):
        real = sum(1 for p in padded if p is not None)
        res = version.engine.scan(
            [p if p is not None else {} for p in padded], live_n=real)
        flushes.append((version.revision, real))
        return [(version.revision, resource_verdicts(res, ci))
                for ci in range(real)]

    pipe = AdmissionPipeline(evaluate, config=BatchConfig(
        max_batch_size=8, max_wait_ms=1.0, deadline_ms=60000.0),
        version_provider=mgr.acquire)
    pods = [_pod(f"p{i}", priv=bool(i % 3)) for i in range(48)]
    try:
        with concurrent.futures.ThreadPoolExecutor(6) as ex:
            futs = []
            for i, pod in enumerate(pods):
                if i in (16, 32):
                    cache.set(ClusterPolicy.from_dict(
                        _pol_dict(f"n{i}", priv="true")))
                futs.append(ex.submit(pipe.submit, copy.deepcopy(pod)))
            out = [f.result() for f in futs]
    finally:
        pipe.stop()
    revisions = {rev for rev, _ in out}
    assert len(revisions) >= 2 and sum(n for _, n in flushes) == len(pods)
    engines = {}
    for pod, (rev, rows) in zip(pods, out):
        if rev not in engines:
            snap_cache = PolicyCache()
            for name in ["a"] + [f"n{i}" for i in (16, 32)
                                 if rev >= (2 if i == 16 else 3)]:
                snap_cache.set(ClusterPolicy.from_dict(
                    _pol_dict(name) if name == "a"
                    else _pol_dict(name, priv="true")))
            engines[rev] = TorchEngine(
                list(snap_cache.policyset_snapshot().policies), device="cpu")
        want = engines[rev].scan([copy.deepcopy(pod)])
        assert rows == resource_verdicts(want, 0)


def test_policy_dir_watcher_add_update_delete_and_malformed(tmp_path):
    cache = PolicyCache()
    w = PolicyDirWatcher(str(tmp_path), cache, interval_s=0.01)
    _write(tmp_path / "a.yaml", _pol_dict("a"))
    assert w.sync_once() is True
    assert cache.policyset_snapshot().keys() == ("a",)
    rev = cache.revision
    assert w.sync_once() is False and cache.revision == rev
    time.sleep(0.01)
    _write(tmp_path / "a.yaml", _pol_dict("a", priv="true"))
    assert w.sync_once() is True and cache.revision == rev + 1
    _write(tmp_path / "b.yaml", _pol_dict("b"), _pol_dict("c"))
    assert w.sync_once() is True
    assert set(cache.policyset_snapshot().keys()) == {"a", "b", "c"}
    (tmp_path / "bad.yaml").write_text("{unbalanced: [")
    assert w.sync_once() is False
    assert set(cache.policyset_snapshot().keys()) == {"a", "b", "c"}
    assert "bad.yaml" in " ".join(w.state()["parse_errors"])
    time.sleep(0.01)
    _write(tmp_path / "b.yaml", _pol_dict("b"))
    assert w.sync_once() is True
    assert set(cache.policyset_snapshot().keys()) == {"a", "b"}
    (tmp_path / "a.yaml").unlink()
    assert w.sync_once() is True
    assert set(cache.policyset_snapshot().keys()) == {"b"}


def test_watcher_thread_drives_a_worker_swap_without_analysis(tmp_path):
    cache = PolicyCache()
    mgr = PolicySetLifecycleManager(
        cache, compile_fn=default_compile_fn(device="cpu"),
        retry_policy=_fast(RetryPolicy))
    assert mgr.analyze_on_swap is False
    _write(tmp_path / "a.yaml", _pol_dict("a"))
    w = PolicyDirWatcher(str(tmp_path), cache, interval_s=0.02)
    mgr.start()
    w.start()
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and mgr.active is None:
            time.sleep(0.02)
        assert mgr.active is not None
        rev1 = mgr.active.revision
        time.sleep(0.01)
        _write(tmp_path / "a.yaml", _pol_dict("a", priv="true"))
        while time.monotonic() < deadline and mgr.active.revision == rev1:
            time.sleep(0.02)
        assert mgr.active.revision > rev1 and mgr.worker_running
    finally:
        w.stop()
        mgr.stop()
    from kyverno_tpu_torch.analysis import global_analysis

    # no lint ran with analyze_on_swap False; asked for after stop(),
    # it resolves and yields to the stopped manager (aborted, no report)
    assert mgr.stats.get("lints", 0) == 0
    assert global_analysis.report is None
    assert global_analysis.runs == {"ok": 0, "aborted": 0, "error": 0}
    assert mgr.run_lint(force=True) is None
    assert global_analysis.runs == {"ok": 0, "aborted": 1, "error": 0}


class _Engine:
    """A compiled engine's stand-in: its device, its compiled set, and
    each warm-up with the manager's active version at that moment."""

    MIN_BUCKET = TorchEngine.MIN_BUCKET
    bucket_size = TorchEngine.bucket_size

    def __init__(self, device, cps, log, box):
        self.device = torch.device(device)
        self.cps = cps
        self._log, self._box = log, box

    def warm_buckets(self, buckets):
        self._log.append((list(buckets), self._box[0].active))


@pytest.mark.parametrize("device,analyze,lint_tile,want", [
    ("cuda", True, 128, [128]),
    ("cuda", True, 100, [128]),
    ("cuda", False, 128, []),
    ("cpu", True, 128, []),
])
def test_lint_tile_is_warmed_before_the_swap(device, analyze, lint_tile,
                                             want):
    log, box, compiled = [], [None], []

    def compile_fn(policies, quarantine):
        names = [p.name for i, p in enumerate(policies)
                 if i not in quarantine]
        compiled.append(names)
        if "bad" in names:
            raise RuntimeError("bad policy")
        return _Engine(device, compile_policy_set(
            policies, quarantine=quarantine), log, box)

    cache = PolicyCache()
    for name in ("a", "bad"):
        cache.set(ClusterPolicy.from_dict(_pol_dict(name)))
    mgr = PolicySetLifecycleManager(cache, compile_fn=compile_fn,
                                    retry_policy=_fast(RetryPolicy))
    box[0] = mgr
    mgr.analyze_on_swap = analyze
    mgr.lint_tile = lint_tile
    v1 = mgr.acquire()
    # the set, then each policy alone (probes), then the set without
    # the quarantined policy: only the last is a version to promote
    assert compiled == [["a", "bad"], ["a"], ["bad"], ["a"]]
    assert [b for b, _ in log] == [want] * bool(want)
    assert all(active is None for _, active in log)
    cache.set(ClusterPolicy.from_dict(_pol_dict("b")))
    v2 = mgr.acquire()
    assert v2.revision > v1.revision
    assert [b for b, _ in log] == [want] * (2 * bool(want))
    assert all(active is v1 for _, active in log[1:])

