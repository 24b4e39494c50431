"""The port's mesh across processes: two ranks of a gloo world on the CPU,
each with four CPU entries, against the JAX package's
``make_mesh_2d(2, 4)`` on its 8 virtual devices in this process.

Each rank is a subprocess (``torch_xproc_rank.py``, which imports
nothing of the JAX package) with a hard timeout. Each rank's table and
counts must equal the reference's bit for bit, for ``scan_device``,
``scan`` and a cold and a warm ``scan_stream``, although rank 1 grew
its lane buckets alone; the scan service must give every rank the
reference's reports although rank 0 alone served a third of the
snapshot from its verdict cache, and a tick clean on one rank alone
must keep the ranks in step; a peer that never joins must fail the
collective within the mesh's timeout, and ``scan`` then answers through
the scalar engine, equal to the reference's, as it does when one rank
alone fails before the step (its encode, a fault) and the ranks stay in
step. A peer's failure counts on no rank's breaker but the failing
one's; a failed mesh says so on the op-log and its gauge.
``serve --distributed`` at
a world size of 2 brings the mesh up in both processes and their
``/scan`` summaries equal the reference service's. Tolerance: exact."""

from __future__ import annotations

import copy
import http.client
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import yaml

from kyverno_tpu.api.policy import ClusterPolicy as JPolicy
from kyverno_tpu.cluster import BackgroundScanService as JService
from kyverno_tpu.cluster import ClusterSnapshot as JSnapshot
from kyverno_tpu.cluster import PolicyCache as JCache
from kyverno_tpu.parallel.sharding import ShardedScanner as JScanner
from kyverno_tpu.parallel.sharding import make_mesh_2d as jmake_mesh_2d
from kyverno_tpu.policies import load_pss_policies
from kyverno_tpu.policy.autogen import expand_policy
from test_torch_scanner import NAMESPACES, configmap, namespace, policy_docs
from test_torch_scanner import resource as service_resource
from test_tpu_pss_parity import _resource
from torch_parity_util import fresh_port_state  # noqa: F401 - autouse

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
SUBSET = "disallow-host"
TIMEOUT_S = 4.0       # the mesh's collective timeout in the ranks
CHILD_S = 100         # each child's hard limit


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _api_resources():
    rng = random.Random(64)
    return [_resource(rng, i) for i in range(64)]


def _service_docs():
    rng = random.Random(5)
    docs = [configmap("bad-name")]
    docs += [namespace(n, "prod" if k % 2 else "dev")
             for k, n in enumerate(NAMESPACES)]
    return docs + [service_resource(rng, i) for i in range(60)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks run once for the module; their outputs by rank."""
    out = str(tmp_path_factory.mktemp("xproc"))
    with open(os.path.join(out, "input.json"), "w") as f:
        json.dump({"api_subset": SUBSET, "api_resources": _api_resources(),
                   "service_policies": policy_docs(),
                   "service_docs": _service_docs()}, f)
    port = _free_port()
    procs, logs = [], [os.path.join(out, f"rank{r}.out") for r in (0, 1)]
    try:
        for r in (0, 1):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(TESTS, "torch_xproc_rank.py"),
                     out, str(r), str(port), str(TIMEOUT_S)],
                    env=_child_env(), stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + CHILD_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            assert p.returncode == 0, \
                f"rank {r} exited {p.returncode}:\n{f.read()[-4000:]}"
    got = []
    for r in (0, 1):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            info = json.load(f)
        info.update(np.load(os.path.join(out, f"rank{r}.npz")))
        got.append(info)
    return got


@pytest.fixture(scope="module")
def reference():
    return JScanner([expand_policy(p) for p in load_pss_policies(SUBSET)],
                    mesh=jmake_mesh_2d(2, 4))


def test_each_rank_holds_its_row_of_the_mesh(ranks):
    assert [r["local"] for r in ranks] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert all(r["world"] == 2 for r in ranks)


@pytest.mark.parametrize("what", ["device", "scan", "stream_cold",
                                  "stream_warm"])
def test_every_rank_equals_the_reference(ranks, reference, what):
    res = _api_resources()
    if what == "device":
        wv, wc = reference.scan_device(copy.deepcopy(res))
        for r in ranks:
            assert r["device_v"].dtype == wv.dtype == np.uint8
            assert np.array_equal(r["device_v"], wv)
            assert r["device_c"].dtype == wc.dtype
            assert np.array_equal(r["device_c"], wc)
        return
    if what == "scan":
        want = reference.scan(copy.deepcopy(res)).verdicts
    else:
        want, stats = reference.scan_stream(copy.deepcopy(res), tile=32)
        want = want.verdicts
        assert all(r[f"{what}_tiles"] == stats["tiles"] == 2 for r in ranks)
    for r in ranks:
        assert r[what].dtype == want.dtype
        assert np.array_equal(r[what], want)


def test_a_rank_alone_failing_before_the_step_keeps_the_ranks_in_step(
        ranks, reference):
    """Rank 1's encode raises in one ``scan`` and a ``tpu.dispatch``
    fault fires before its step in the next: it joins the tile failed,
    every rank answers through the scalar engine, and the ranks' next
    step still pairs up."""
    res = _api_resources()
    want = reference.scan(copy.deepcopy(res)).verdicts
    wv, wc = reference.scan_device(copy.deepcopy(res))
    for r in ranks:
        assert np.array_equal(r["skew_encode"], want)
        assert np.array_equal(r["skew_fault"], want)
        assert np.array_equal(r["skew_v"], wv)
        assert np.array_equal(r["skew_c"], wc)
        assert r["skew_failed"] is None
    # rank 0 met the failure flag in both steps; rank 1's own encode
    # failure went to its engine alone, its fault to the scalar engine
    assert [r["skew_fallbacks"] for r in ranks] == [{"mesh_peer": 2},
                                                    {"error": 1}]
    # only rank 1's own fault counts on a breaker (the admission path
    # shares it): rank 0's card did its part both times
    assert [r["skew_breaker"] for r in ranks] == [["closed", 0],
                                                  ["closed", 1]]


def _reference_service():
    snap, cache = JSnapshot(), JCache()
    for d in policy_docs():
        cache.set(JPolicy.from_dict(copy.deepcopy(d)))
    for d in _service_docs():
        snap.upsert(copy.deepcopy(d))
    return JService(snap, cache, mesh=jmake_mesh_2d(2, 4), batch_size=32)


def test_a_rank_local_cache_hit_keeps_the_ranks_in_step(ranks):
    svc = _reference_service()
    n = svc.scan_once()
    want = {uid: sorted((r.policy, r.rule, r.result) for r in rows)
            for uid, rows in svc.aggregator._per_resource.items()}
    hits = [r["service_stats"]["verdict_cache_hits"] for r in ranks]
    assert hits[0] == len(_service_docs()) // 3 and hits[1] == 0
    for r in ranks:
        assert r["service_scanned"] == n
        assert r["service_summary"] == svc.aggregator.summary()
        got = {uid: sorted(map(tuple, rows))
               for uid, rows in r["service_results"].items()}
        assert got == want


def test_a_tick_clean_on_one_rank_keeps_the_ranks_in_step(ranks, reference):
    """Rank 0's tick is clean while rank 1's has one changed resource:
    rank 0 still joins the tick's agreement, rank 1 scans its change
    alone, and the next step pairs up."""
    assert [r["clean_scanned"] for r in ranks] == [0, 1]
    wv, wc = reference.scan_device(copy.deepcopy(_api_resources()))
    for r in ranks:
        assert np.array_equal(r["clean_v"], wv)
        assert np.array_equal(r["clean_c"], wc)


def test_a_peer_that_never_joins_fails_within_the_timeout(ranks, reference):
    rank0 = ranks[0]
    want = reference.scan(copy.deepcopy(_api_resources())).verdicts
    assert np.array_equal(rank0["alone"], want)
    assert rank0["alone_failed"] and "Timed out" in rank0["alone_failed"]
    assert TIMEOUT_S - 0.5 < rank0["alone_s"] < TIMEOUT_S + 30
    assert set(rank0["alone_fallbacks"]) == {"mesh_peer"}
    assert rank0["alone_fallbacks"]["mesh_peer"] >= 1
    # the peer's failure is not this card's: the breaker counts none
    assert rank0["alone_breaker"] == ["closed", 0]
    failed = [e for e in rank0["events"] if e["event"] == "mesh_failed"]
    assert len(failed) == 1 and failed[0]["level"] == "error"
    assert (failed[0]["rank"], failed[0]["world"]) == (0, 2)
    assert "Timed out" in failed[0]["error"]
    assert rank0["alone_gauge"] == 1.0
    assert not [e for e in ranks[1]["events"]
                if e["event"] == "mesh_failed"]


# ---------------------------------------------------------------------------
# serve --distributed at a world size of 2


def _post(port, path, doc, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(doc).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200, (path, resp.status, body)
        return json.loads(body)
    finally:
        conn.close()


def _events(path):
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                pass  # a line being written
    return out


def test_serve_distributed_world_two(tmp_path):
    policies = tmp_path / "policies.yaml"
    policies.write_text(yaml.safe_dump_all(policy_docs()))
    port = _free_port()
    logs = [str(tmp_path / f"rank{r}.jsonl") for r in (0, 1)]
    # serve mirrors its op-log to stderr: a file each, as a pipe nobody
    # reads could fill and stall a rank
    errs = [str(tmp_path / f"rank{r}.err") for r in (0, 1)]

    def err(r):
        with open(errs[r]) as f:
            return f.read()[-4000:]

    procs = []
    for r in (0, 1):
        env = _child_env()
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "WORLD_SIZE": "2", "RANK": str(r)})
        with open(errs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kyverno_tpu_torch", "serve",
                 str(policies), "--distributed", "--device", "cpu",
                 "--port", "0", "--metrics-port", "0", "--scan-interval",
                 "3600", "--no-reports", "--no-columnar", "--log-file",
                 logs[r]],
                env=env, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=f))
    try:
        deadline = time.monotonic() + CHILD_S
        started = [None, None]
        while None in started:
            for r in (0, 1):
                assert procs[r].poll() is None, \
                    f"serve rank {r} exited:\n{err(r)}"
                for e in _events(logs[r]):
                    if e.get("event") == "serve_started":
                        started[r] = e
            assert time.monotonic() < deadline, "serve did not start"
            time.sleep(0.2)
        for r in (0, 1):
            init = [e for e in _events(logs[r])
                    if e.get("event", "").startswith("distributed_")]
            assert [e["event"] for e in init] == ["distributed_initialized"]
            assert (init[0]["hosts"], init[0]["per_host"]) == (2, 1)
        ports = [e["metrics_port"] for e in started]
        for d in _service_docs():
            for p in ports:
                _post(p, "/snapshot/upsert", d)
        answers = [None, None]

        def scan(r):
            answers[r] = _post(ports[r], "/scan", {}, timeout=CHILD_S)

        threads = [threading.Thread(target=scan, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(CHILD_S)
        assert None not in answers
        svc = _reference_service()
        n = svc.scan_once()
        for a in answers:
            assert a["scanned"] == n
            assert a["summary"] == svc.aggregator.summary()
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
