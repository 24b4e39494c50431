"""The port's supervised encode pool (kyverno_tpu_torch/encode/) on the
CPU, against the in-process encode and the JAX package.

Workers are spawned interpreters running ``python -m
kyverno_tpu_torch.encode.worker``; their handshake must show that
neither torch nor JAX was imported. Rows (the admission feed) and
vocabulary batches (the scan feed) from the workers equal the
in-process encode and the JAX package's (tolerance: exact), and a
pooled pipelined scan gives the JAX engine's verdicts — also when a
poison resource kills the workers that touch it (bisected into the
quarantine), when the pool's breaker opens (chunks bypass to the
in-process encode) and when the pool stops mid-scan (no orphan
process). Every wait on a worker has a deadline of its own."""

import copy
import os
import threading
import time

import numpy as np
import pytest

from kyverno_tpu.api.policy import ClusterPolicy as JaxPolicy
from kyverno_tpu.parallel.sharding import ShardedScanner as JScanner
from kyverno_tpu.parallel.sharding import make_mesh
from kyverno_tpu.tpu import flatten as jflat
from kyverno_tpu.tpu.cache import extract_rows as jextract_rows
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch.api.policy import ClusterPolicy
from kyverno_tpu_torch.encode import (KIND_ROWS, KIND_VOCAB, EncoderPool,
                                      PoolBypassed, PoolConfig,
                                      PoolInfraError, configure_pool,
                                      get_pool, pool_state, profile_spec,
                                      shutdown_pool)
from kyverno_tpu_torch.observability.metrics import global_registry as reg
from kyverno_tpu_torch.parallel.sharding import ShardedScanner
from kyverno_tpu_torch.resilience.breaker import tpu_breaker
from kyverno_tpu_torch.resilience.faults import global_faults
from kyverno_tpu_torch.tpu.cache import extract_rows
from kyverno_tpu_torch.tpu.engine import TorchEngine
from kyverno_tpu_torch.tpu.flatten import EncodeConfig, encode_resources
from kyverno_tpu_torch.tpu.pipeline import (PipelinedScanner,
                                            scanner_encode_profile)

from torch_parity_util import (fresh_port_state,  # noqa: F401
                               no_port_verdict_cache)

READY_S = 60  # the deadline of a pool's workers to report ready

POLICY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "p1"},
    "spec": {"rules": [{
        "name": "r1",
        "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
        "validate": {"message": "m", "pattern": {"spec": {"containers": [
            {"=(securityContext)": {"=(privileged)": "false"}}]}}},
    }]}}


def _pods(n, name_of=None):
    return [{
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name_of(i) if name_of else f"p{i}",
                     "namespace": "default", "labels": {"app": f"a{i % 3}"}},
        "spec": {"containers": [{
            "name": "c", "image": f"nginx:{i % 4}",
            **({"securityContext": {"privileged": True}}
               if i % 3 == 0 else {})}]},
    } for i in range(n)]


def _chunks(pods, size=8):
    return [pods[i:i + size] for i in range(0, len(pods), size)]


def _pids_gone(pids, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(os.path.exists(f"/proc/{p}") for p in pids):
            return True
        time.sleep(0.05)
    return False


@pytest.fixture()
def scanner():
    return ShardedScanner([ClusterPolicy.from_dict(copy.deepcopy(POLICY))],
                          device="cpu")


@pytest.fixture()
def reference():
    """The JAX engine's verdicts, chunk by chunk — the oracle every
    pooled run must give."""
    eng = TpuEngine([JaxPolicy.from_dict(copy.deepcopy(POLICY))])

    def compute(chunk_list, ns_labels=None):
        return np.concatenate([eng.scan(copy.deepcopy(c), ns_labels).verdicts
                               for c in chunk_list], axis=1)
    return compute


@pytest.fixture(autouse=True)
def _pool_hygiene(no_verdict_cache, no_port_verdict_cache):
    yield
    shutdown_pool()
    global_faults.disarm("encode.pool_dispatch")
    global_faults.disarm("tpu.dispatch")
    tpu_breaker().reset()


def _run_pool_scan(scanner, chunk_list, pool, ns_labels=None):
    pipe = PipelinedScanner(scanner, encode_pool=pool)
    got = {}
    stats = pipe.scan_chunks(chunk_list, ns_labels,
                             on_result=lambda i, r: got.update(
                                 {i: r.verdicts}))
    assert sorted(got) == list(range(len(chunk_list)))
    return np.concatenate([got[i] for i in range(len(chunk_list))],
                          axis=1), stats


def test_workers_load_neither_torch_nor_jax_and_encode_equal(scanner):
    pods = _pods(20)
    pool = EncoderPool(2).start()
    try:
        assert pool.wait_ready(READY_S) == 2
        slots = pool.state()["worker_slots"]
        assert all(w["torch_loaded"] is False for w in slots)
        assert all(w["jax_loaded"] is False for w in slots)
        # the admission feed: trimmed rows, as the in-process encode and
        # the JAX package's give them
        cfg = scanner.cps.encode_cfg
        prof = pool.register_profile(profile_spec(
            cfg, byte_paths=scanner.cps.byte_paths,
            key_byte_paths=scanner.cps.key_byte_paths))
        out = pool.encode_chunk(prof, KIND_ROWS,
                                {"resources": copy.deepcopy(pods)})
        mine = encode_resources(pods, cfg, scanner.cps.byte_paths,
                                scanner.cps.key_byte_paths)
        jcfg = jflat.EncodeConfig(cfg.max_rows, cfg.max_instances,
                                  cfg.byte_pool_slots, cfg.byte_pool_width)
        theirs = jflat.encode_resources(pods, jcfg, scanner.cps.byte_paths,
                                        scanner.cps.key_byte_paths)
        assert out["n"] == len(pods)
        for i, got in enumerate(out["rows"]):
            for want in (extract_rows(mine, i), jextract_rows(theirs, i)):
                assert got.n_rows == want.n_rows
                assert got.fallback == want.fallback
                for name in want.lanes:
                    assert np.array_equal(got.lanes[name], want.lanes[name])
        # the scan feed: the vocabulary batch of ShardedScanner.encode
        vprof = pool.register_profile(scanner_encode_profile(scanner))
        buckets = (scanner._vbucket, scanner._sbucket, scanner._rbucket)
        out = pool.encode_chunk(vprof, KIND_VOCAB,
                                {"resources": copy.deepcopy(pods),
                                 "buckets": buckets})
        host, n = scanner.encode(copy.deepcopy(pods))
        js = JScanner([JaxPolicy.from_dict(copy.deepcopy(POLICY))],
                      mesh=make_mesh())
        jhost, jn = js.encode(copy.deepcopy(pods))
        assert out["n"] == n == jn == len(pods)
        assert set(out["host"]) == set(host) == set(jhost)
        for k in host:
            assert np.array_equal(out["host"][k], host[k]), k
            assert np.array_equal(out["host"][k], jhost[k]), k
    finally:
        pids = pool.worker_pids()
        pool.stop()
    assert _pids_gone(pids), "stop() left orphan worker processes"


def test_pooled_pipeline_equals_reference(scanner, reference):
    chunk_list = _chunks(_pods(40))
    want = reference(chunk_list)
    pool = EncoderPool(2).start()
    ok0 = reg.encode_pool_chunks.value({"outcome": "ok"})
    try:
        assert pool.wait_ready(READY_S) == 2
        got, stats = _run_pool_scan(scanner, chunk_list, pool)
        assert np.array_equal(got, want)
        assert stats["encode_fallback_chunks"] == 0
        assert stats["encode_pool"]["alive"] == 2
        assert stats["encode_pool"]["breaker"] == "closed"
        assert reg.encode_pool_chunks.value({"outcome": "ok"}) - ok0 == 5
    finally:
        pool.stop()


def test_no_pool_keeps_the_inprocess_feed(scanner, reference):
    configure_pool(0)
    assert get_pool() is None and pool_state() == {"enabled": False}
    chunk_list = _chunks(_pods(24))
    got, stats = _run_pool_scan(scanner, chunk_list, None)
    assert np.array_equal(got, reference(chunk_list))
    assert "encode_pool" not in stats


def test_poison_resource_bisected_into_quarantine(scanner, reference):
    pods = _pods(32, name_of=lambda i:
                 "POISON-PILL" if i == 11 else f"p{i}")
    chunk_list = _chunks(pods)
    want = reference(chunk_list)
    pool = EncoderPool(
        2, config=PoolConfig(chunk_deadline_s=15),
        worker_faults="encode.worker:crash:match=POISON-PILL").start()
    p0 = reg.encode_pool_chunks.value({"outcome": "poison"})
    try:
        assert pool.wait_ready(READY_S) == 2
        got, stats = _run_pool_scan(scanner, chunk_list, pool)
        assert np.array_equal(got, want)
        assert reg.encode_pool_chunks.value({"outcome": "poison"}) - p0 == 1
        assert [t["poison"] for t in stats["timeline"]].count(1) == 1
        assert pool.restarts >= 2
        assert pool.wait_ready(30) == 2
    finally:
        pool.stop()


def test_pool_breaker_opens_bypasses_and_restores(scanner, reference):
    chunk_list = _chunks(_pods(40))
    want = reference(chunk_list)
    pool = EncoderPool(
        1, config=PoolConfig(breaker_threshold=2, breaker_reset_s=0.4),
    ).start()
    b0 = reg.encode_pool_chunks.value({"outcome": "bypass"})
    i0 = reg.encode_pool_chunks.value({"outcome": "infra_fail"})
    try:
        assert pool.wait_ready(READY_S) == 1
        global_faults.arm("encode.pool_dispatch", mode="raise", count=2)
        got, _ = _run_pool_scan(scanner, chunk_list, pool)
        global_faults.disarm("encode.pool_dispatch")
        assert np.array_equal(got, want)
        assert reg.encode_pool_chunks.value(
            {"outcome": "infra_fail"}) - i0 == 2
        assert reg.encode_pool_chunks.value({"outcome": "bypass"}) - b0 >= 1
        assert pool.breaker.state == "open"
        time.sleep(0.5)
        got2, stats2 = _run_pool_scan(scanner, chunk_list, pool)
        assert np.array_equal(got2, want)
        assert pool.breaker.state == "closed"
        assert stats2["encode_pool"]["breaker"] == "closed"
    finally:
        pool.stop()


def test_stop_mid_scan_leaves_no_orphans(scanner, reference):
    chunk_list = _chunks(_pods(160))
    want = reference(chunk_list)
    pool = EncoderPool(
        2, config=PoolConfig(chunk_deadline_s=20, drain_timeout_s=10),
        worker_faults="encode.worker:delay:p=0.9,delay_s=0.03,seed=5",
    ).start()
    assert pool.wait_ready(READY_S) == 2
    pids = pool.worker_pids()
    stopper = threading.Timer(0.15, lambda: pool.stop())
    stopper.start()
    got, _ = _run_pool_scan(scanner, chunk_list, pool)
    stopper.join()
    assert np.array_equal(got, want)
    assert _pids_gone(pids), "mid-scan stop() left orphan workers"
    with pytest.raises((PoolInfraError, PoolBypassed)):
        pool.submit(1, "rows", {"resources": [{}]})


def test_ns_labels_ship_once_per_scan_and_release(scanner, reference):
    ns_labels = {"prod": {"env": "prod"}, "default": {"env": "dev"}}
    chunk_list = _chunks(_pods(24))
    pool = EncoderPool(2).start()
    try:
        assert pool.wait_ready(READY_S) == 2
        got, _ = _run_pool_scan(scanner, chunk_list, pool, ns_labels)
        assert np.array_equal(got, reference(chunk_list, ns_labels))
        assert len(pool._profiles) == 0, "scan-scoped profile leaked"
    finally:
        pool.stop()


def test_rows_feed_pooled_and_cache_blocks_reentry():
    """TorchEngine's admission feed: cache misses encode on the pool,
    the pooled rows warm the encode cache, and warm rows never re-enter
    the pool; verdicts equal the JAX engine's."""
    from kyverno_tpu_torch.tpu.cache import global_encode_cache

    pods = _pods(12)
    want = TpuEngine([JaxPolicy.from_dict(copy.deepcopy(POLICY))]).scan(
        copy.deepcopy(pods)).verdicts
    configure_pool(2)
    assert get_pool().wait_ready(READY_S) == 2
    ok0 = reg.encode_pool_chunks.value({"outcome": "ok"})
    eng = TorchEngine([ClusterPolicy.from_dict(copy.deepcopy(POLICY))],
                      device="cpu")
    assert np.array_equal(eng.scan(copy.deepcopy(pods)).verdicts, want)
    assert reg.encode_pool_chunks.value({"outcome": "ok"}) - ok0 == 1
    assert len(global_encode_cache) > 0
    ok1 = reg.encode_pool_chunks.value({"outcome": "ok"})
    assert np.array_equal(eng.scan(copy.deepcopy(pods)).verdicts, want)
    assert reg.encode_pool_chunks.value({"outcome": "ok"}) - ok1 == 0


def test_rows_feed_poison_marks_host_fallback():
    pods = _pods(8, name_of=lambda i: "POISON-PILL" if i == 2 else f"p{i}")
    want = TpuEngine([JaxPolicy.from_dict(copy.deepcopy(POLICY))]).scan(
        copy.deepcopy(pods)).verdicts
    configure_pool(2, config=PoolConfig(chunk_deadline_s=15),
                   worker_faults="encode.worker:crash:match=POISON-PILL")
    assert get_pool().wait_ready(READY_S) == 2
    p0 = reg.encode_pool_chunks.value({"outcome": "poison"})
    eng = TorchEngine([ClusterPolicy.from_dict(copy.deepcopy(POLICY))],
                      device="cpu")
    assert np.array_equal(eng.scan(copy.deepcopy(pods)).verdicts, want)
    assert reg.encode_pool_chunks.value({"outcome": "poison"}) - p0 >= 1


def test_pool_state_and_atexit_kill():
    configure_pool(1)
    assert get_pool().wait_ready(READY_S) == 1
    st = pool_state()
    assert st["enabled"] and st["workers"] == 1
    assert st["breaker"] in ("closed", "open", "half_open")
    import json

    json.dumps(st)
    pids = get_pool().worker_pids()
    get_pool()._kill_all_workers()  # what the interpreter-exit guard runs
    assert _pids_gone(pids)
    shutdown_pool()
    assert pool_state() == {"enabled": False}


def test_worker_imports_no_torch_in_a_fresh_interpreter():
    """The worker module and what it imports, in a fresh interpreter:
    neither torch nor JAX nor the JAX package is loaded."""
    import subprocess
    import sys

    code = ("import sys; import kyverno_tpu_torch.encode.worker, "
            "kyverno_tpu_torch.encode.tasks, kyverno_tpu_torch.encode; "
            "bad = [m for m in sys.modules if m in ('torch', 'jax') or "
            "m == 'kyverno_tpu' or m.startswith('kyverno_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], env=env, timeout=60,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
