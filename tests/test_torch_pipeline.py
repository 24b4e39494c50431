"""The port's pipelined scan (kyverno_tpu_torch/tpu/pipeline.py) on the
CPU, against ``ShardedScanner.scan_stream`` and the JAX package's
``PipelinedScanner`` — the counterparts of the pipelined-scan tests of
tests/test_perf_cache.py.

Tolerance: exact. Every chunk's verdicts equal the serial scan's and the
JAX pipeline's, with the verdict cache on and off, under seeded
``tpu.dispatch`` faults (a failed launch or readback answers the chunk
on the scalar engine) and with the columnar store on; a chunk whose
encode raises falls back to the quarantining scan; a
``kernels.KernelError`` from the launch is raised, never answered
all-HOST; the rule analytics match the JAX pipeline's."""

import copy

import numpy as np
import pytest

from kyverno_tpu.api.policy import ClusterPolicy as JaxPolicy
from kyverno_tpu.observability.analytics import global_rule_stats as jstats
from kyverno_tpu.parallel.sharding import ShardedScanner as JScanner
from kyverno_tpu.parallel.sharding import make_mesh
from kyverno_tpu.policies import load_pss_policies
from kyverno_tpu.policy.autogen import expand_policy
from kyverno_tpu.resilience import faults as jfaults
from kyverno_tpu.resilience.breaker import tpu_breaker as jax_breaker
from kyverno_tpu.tpu.pipeline import PipelinedScanner as JPipeline
from kyverno_tpu_torch.api.policy import ClusterPolicy
from kyverno_tpu_torch.cluster.columnar import configure_store
from kyverno_tpu_torch.kernels import KernelError
from kyverno_tpu_torch.observability.analytics import global_rule_stats
from kyverno_tpu_torch.observability.metrics import global_registry as reg
from kyverno_tpu_torch.parallel.sharding import ShardedScanner
from kyverno_tpu_torch.resilience.breaker import tpu_breaker
from kyverno_tpu_torch.resilience.faults import global_faults
from kyverno_tpu_torch.tpu import pipeline as tpipeline
from kyverno_tpu_torch.tpu.pipeline import PipelinedScanner

from test_torch_cache import _pods, _pol_doc, _rule_stats
from torch_parity_util import (fresh_port_state,  # noqa: F401
                               no_port_verdict_cache, port_policies)


@pytest.fixture(autouse=True)
def _clean():
    for r in (global_faults, jfaults.global_faults):
        r.disarm()
    tpu_breaker().reset()
    jax_breaker().reset()
    yield
    for r in (global_faults, jfaults.global_faults):
        r.disarm()
    tpu_breaker().reset()
    jax_breaker().reset()


def _scanners(*docs):
    docs = docs or (_pol_doc(),)
    js = JScanner([JaxPolicy.from_dict(copy.deepcopy(d)) for d in docs],
                  mesh=make_mesh())
    ts = ShardedScanner([ClusterPolicy.from_dict(copy.deepcopy(d))
                         for d in docs], device="cpu")
    return js, ts


def _run(pipe, chunks, **kw):
    out = {}
    stats = pipe.scan_chunks(chunks, on_result=lambda i, r: out.__setitem__(
        i, r), **kw)
    assert sorted(out) == list(range(len(chunks)))
    return np.concatenate([out[i].verdicts for i in sorted(out)],
                          axis=1), stats, out


def _mixed_pods():
    return _pods(40) + _pods(10, ns="prod")


def test_pipelined_scan_equals_serial_and_reference():
    js, ts = _scanners()
    pods = _mixed_pods()
    chunks = [pods[i:i + 16] for i in range(0, len(pods), 16)]
    serial = ts.scan(copy.deepcopy(pods))
    stream, _ = ts.scan_stream(copy.deepcopy(pods), tile=16)
    global_rule_stats.reset()  # the rule analytics of the pipelines alone
    got, stats, _ = _run(PipelinedScanner(ts), chunks)
    want, _, _ = _run(JPipeline(js), copy.deepcopy(chunks))
    assert np.array_equal(got, serial.verdicts)
    assert np.array_equal(got, stream.verdicts)
    assert np.array_equal(got, want)
    assert stats["chunks"] == 4 and stats["resources"] == 50
    assert stats["encode_fallback_chunks"] == 0
    assert reg.pipeline_chunks.value({"path": "device"}) >= 4
    for k in ("encode_s", "encode_wait_s", "device_s", "host_s",
              "overlap_ratio", "wall_s"):
        assert stats[k] >= 0.0, k
    assert [t["chunk"] for t in stats["timeline"]] == [0, 1, 2, 3]
    assert _rule_stats(global_rule_stats) == _rule_stats(jstats)


def test_pipelined_pss_scan_equals_scan_stream():
    """The PSS program (a DFA bank, K1-K12's twins) in chunks of 8."""
    pols = [expand_policy(p) for p in load_pss_policies()][:4]
    js = JScanner(pols, mesh=make_mesh())
    ts = ShardedScanner(port_policies(pols), device="cpu")
    pods = _mixed_pods()[:24]
    chunks = [pods[i:i + 8] for i in range(0, len(pods), 8)]
    stream, _ = ts.scan_stream(copy.deepcopy(pods), tile=8)
    got, _, _ = _run(PipelinedScanner(ts, depth=3), chunks)
    want, _, _ = _run(JPipeline(js, depth=3), copy.deepcopy(chunks))
    assert np.array_equal(got, stream.verdicts)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [11, 12])
def test_pipelined_scan_equal_under_dispatch_faults(no_verdict_cache,
                                                    no_port_verdict_cache,
                                                    seed):
    js, ts = _scanners()
    pods = _pods(32)
    chunks = [pods[i:i + 8] for i in range(0, 32, 8)]
    serial = ts.scan(copy.deepcopy(pods))
    f0 = reg.pipeline_chunks.value({"path": "fallback"})
    global_faults.arm("tpu.dispatch", mode="raise", p=0.5, seed=seed)
    jfaults.global_faults.arm("tpu.dispatch", mode="raise", p=0.5, seed=seed)
    got, stats, _ = _run(PipelinedScanner(ts), chunks)
    want, _, _ = _run(JPipeline(js), copy.deepcopy(chunks))
    assert np.array_equal(got, serial.verdicts)
    assert np.array_equal(got, want)
    paths = [t["path"] for t in stats["timeline"]]
    assert "fallback" in paths
    assert reg.pipeline_chunks.value({"path": "fallback"}) - f0 == \
        paths.count("fallback")


def test_a_failed_readback_answers_the_chunk_on_the_scalar_engine(
        monkeypatch):
    """The second half of the ladder: a readback that raises counts as a
    dispatch failure and the chunk completes all-HOST, with equal
    verdicts."""
    js, ts = _scanners()
    pods = _pods(24)
    chunks = [pods[i:i + 8] for i in range(0, 24, 8)]
    want, _, _ = _run(JPipeline(js), copy.deepcopy(chunks))
    real = tpipeline._wait
    calls = {"n": 0}

    def wait(slot):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("readback lost")
        return real(slot)

    monkeypatch.setattr(tpipeline, "_wait", wait)
    e0 = reg.breaker_fallback.value({"reason": "error"})
    got, stats, _ = _run(PipelinedScanner(ts), chunks)
    assert np.array_equal(got, want)
    assert [t["path"] for t in stats["timeline"]] == \
        ["device", "fallback", "device"]
    assert reg.breaker_fallback.value({"reason": "error"}) - e0 == 1


def test_pipelined_scan_encode_failure_falls_back_not_aborts():
    js, ts = _scanners()
    hostile = {"kind": b"bytes-break-encoding", "metadata": {"name": "h"}}
    pods = _pods(8)
    chunks = [pods[:4], pods[4:] + [hostile]]
    got, stats, out = _run(PipelinedScanner(ts), chunks)
    want, jstats_, _ = _run(JPipeline(js), copy.deepcopy(chunks))
    assert stats["encode_fallback_chunks"] == 1 == \
        jstats_["encode_fallback_chunks"]
    assert out[1].verdicts.shape[1] == 5
    assert np.array_equal(got, want)
    assert np.array_equal(out[0].verdicts, ts.scan(pods[:4]).verdicts)


def test_a_kernel_error_is_raised(monkeypatch):
    """A kernel of the port that fails (here: the step raises
    ``KernelError``) is raised out of the pipeline, counted as
    ``kernel_errors``, and no chunk is answered all-HOST."""
    _, ts = _scanners()
    pods = _pods(16)

    def broken(lanes):
        raise KernelError("row_fold: launch refused")

    monkeypatch.setattr(ts, "_step", broken)
    k0 = reg.kernel_errors.value()
    f0 = reg.breaker_fallback.value({"reason": "error"})
    with pytest.raises(KernelError):
        PipelinedScanner(ts).scan_chunks([pods[:8], pods[8:]])
    assert reg.kernel_errors.value() - k0 == 1
    assert reg.breaker_fallback.value({"reason": "error"}) == f0
    assert tpu_breaker().state == "closed"


def test_pipelined_scan_with_the_columnar_store(tmp_path):
    """The columnar feed: a warm rescan walks no JSON and gives the same
    verdicts, also after the store is reopened from its mmap tier."""
    js, ts = _scanners()
    pods = _mixed_pods()
    chunks = [pods[i:i + 16] for i in range(0, len(pods), 16)]
    want, _, _ = _run(JPipeline(js), copy.deepcopy(chunks))
    configure_store(directory=str(tmp_path / "col"), enabled=True)
    cold, _, _ = _run(PipelinedScanner(ts), chunks)
    w0 = reg.encode_json_walks.value()
    warm, _, _ = _run(PipelinedScanner(ts), chunks)
    assert reg.encode_json_walks.value() == w0
    assert np.array_equal(cold, want) and np.array_equal(warm, want)


def test_the_launch_holds_its_buffers_until_the_readback():
    """On the CPU the slot holds the step's tensors and no event; the
    readback releases the slot's buffers."""
    _, ts = _scanners()
    batch, n = ts.encode(_pods(8))
    slot = tpipeline._launch(ts, batch)
    assert slot.events is None and slot.keep is not None
    v, c = tpipeline._wait(slot)
    assert slot.keep is None
    assert v.shape[1] >= n and c.shape == (v.shape[0], 7)
