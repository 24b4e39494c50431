"""The port's sharded scan on a mesh of CPU entries (kyverno_tpu_torch.
parallel: ``make_mesh``, ``make_mesh_2d``, ``ShardedScanner(mesh=...)``,
``PipelinedScanner``) against the JAX package's on its 8 virtual CPU
devices (tests/conftest.py), in the same mesh shapes.

The reference's mesh is ``make_mesh()`` (8 devices, one axis) or
``make_mesh_2d(2, 4)``; the port's is ``["cpu"] * 8`` in the same shape
(each entry one shard: a device may repeat). A 3-entry mesh of each
exercises a pad that is no power of two. ``scan_device`` (uint8 table,
counts over the padded batch), ``scan`` (the scalar-completed
ScanResult), ``scan_stream(tile=16)`` and ``PipelinedScanner`` must be
bit-identical to the reference's on the scenarios of
tests/test_sharding.py (the 80-container Pod overflows ``max_rows=64``
into HOST) and on 257 seeded PSS resources; ``pad(n)`` must equal the
reference's for n in 1..300. Tolerance: exact."""

import copy

import jax
import numpy as np
import pytest
import torch

from kyverno_tpu.parallel.sharding import ShardedScanner as JScanner
from kyverno_tpu.parallel.sharding import make_mesh as jmake_mesh
from kyverno_tpu.parallel.sharding import make_mesh_2d as jmake_mesh_2d
from kyverno_tpu.policies import load_pss_policies
from kyverno_tpu.policy.autogen import expand_policy
from kyverno_tpu.tpu.flatten import EncodeConfig as JEncodeConfig
from kyverno_tpu.tpu.pipeline import PipelinedScanner as JPipeline
from kyverno_tpu_torch.parallel import (Mesh, ShardedScanner, make_mesh,
                                        make_mesh_2d)
from kyverno_tpu_torch.tpu.flatten import EncodeConfig
from kyverno_tpu_torch.tpu.pipeline import PipelinedScanner

from test_sharding import pods
from torch_parity_util import fresh_port_state  # noqa: F401
from torch_parity_util import port_policies

# (the reference's mesh, the port's mesh in the same shape)
MESHES = {
    "8": (lambda: jmake_mesh(), lambda: make_mesh(["cpu"] * 8)),
    "2x4": (lambda: jmake_mesh_2d(2, 4),
            lambda: make_mesh_2d(2, 4, ["cpu"] * 8)),
    "3": (lambda: jmake_mesh(jax.devices()[:3]),
          lambda: make_mesh(["cpu"] * 3)),
}


_SHARED = {}


def _shared(mesh, subset):
    """One (reference, port) pair a mesh and subset for the module: the
    reference's jitted step compiles once a shape."""
    if (mesh, subset) not in _SHARED:
        _SHARED[(mesh, subset)] = _scanners(mesh, subset)
    return _SHARED[(mesh, subset)]


def _scanners(mesh, subset=None, max_rows=None):
    jm, tm = MESHES[mesh]
    policies = [expand_policy(p) for p in load_pss_policies(subset)]
    jkw = {"encode_cfg": JEncodeConfig(max_rows=max_rows)} if max_rows else {}
    tkw = {"encode_cfg": EncodeConfig(max_rows=max_rows)} if max_rows else {}
    js = JScanner(policies, mesh=jm(), **jkw)
    ts = ShardedScanner(port_policies(policies), mesh=tm(), **tkw)
    assert ts._used_keys == js._used_keys
    assert ts.n_devices == js.n_devices
    assert ts.axes == js.axes
    return js, ts


def _assert_device_equal(js, ts, resources, operations=None):
    jv, jc = js.scan_device(resources, operations=operations)
    tv, tc = ts.scan_device(resources, operations=operations)
    assert tv.dtype == jv.dtype == np.uint8
    assert tc.dtype == jc.dtype and tc.shape == jc.shape
    assert tv.shape == jv.shape and np.array_equal(tv, jv)
    assert np.array_equal(tc, jc)
    return tv, tc


def _assert_result_equal(want, got):
    assert got.verdicts.dtype == want.verdicts.dtype
    assert got.verdicts.shape == want.verdicts.shape
    assert np.array_equal(got.verdicts, want.verdicts)
    assert list(got.rules) == list(want.rules)
    assert got.counts() == want.counts()
    assert got.violations() == want.violations()


def _assert_stream_equal(js, ts, resources, tile, operations=None):
    want, wstats = js.scan_stream(resources, tile=tile, operations=operations)
    got, gstats = ts.scan_stream(resources, tile=tile, operations=operations)
    _assert_result_equal(want, got)
    for k in ("host_cells", "tiles", "tile"):
        assert gstats[k] == wstats[k], k
    return got, gstats


def test_meshes_have_the_reference_shapes():
    for name, (jm, tm) in MESHES.items():
        want, got = jm(), tm()
        assert isinstance(got, Mesh)
        assert got.axis_names == tuple(want.axis_names), name
        assert got.devices.shape == want.devices.shape, name
        assert got.size == want.size, name
        assert got.shape == dict(want.shape), name
        assert got.distinct == [torch.device("cpu")]
    mesh = make_mesh_2d(2, 2, ["cpu", "cpu", "cpu", "cpu", "cpu"])
    assert mesh.devices.shape == (2, 2) and mesh.size == 4


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pad_matches_reference(mesh):
    js, ts = _scanners(mesh, "disallow-privileged")
    for n in range(1, 301):
        assert ts.pad(n) == js.pad(n), n
        assert ts.pad(n) % ts.mesh.size == 0


def test_put_splits_host_major_and_replicates_the_vocabulary():
    ts = ShardedScanner(port_policies([expand_policy(p) for p in
                                       load_pss_policies("disallow")]),
                        mesh=make_mesh_2d(2, 2, ["cpu"] * 4))
    batch, n = ts.encode(pods(10))
    shards = ts.put(batch)
    assert len(shards) == 4 and n == 10
    N = len(batch["row_idx"])
    assert N == ts.pad(10) == 16
    for i, lanes in enumerate(shards):
        assert list(lanes) == list(batch)
        for k, v in batch.items():
            want = v if ts._replicated_key(k) else v[i * 4:(i + 1) * 4]
            assert np.array_equal(lanes[k].numpy().view(want.dtype)
                                  if lanes[k].dtype != torch.uint16
                                  else lanes[k].numpy(), want), k
    # the vocabulary lanes of one device are one tensor, shared
    assert all(s["vocab_valid"].data_ptr() == shards[0]["vocab_valid"]
               .data_ptr() for s in shards)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_scan_device_matches_reference(mesh):
    js, ts = _shared(mesh, "disallow")
    resources = pods(33)  # not divisible by any mesh size here
    tv, tc = _assert_device_equal(js, ts, resources)
    # the counts cover every column of the mesh's padded batch
    assert (tc.sum(axis=1) == ts.pad(33)).all()
    _assert_result_equal(js.scan(resources), ts.scan(resources))


@pytest.mark.parametrize("mesh", ["8", "2x4"])
def test_host_verdicts_resolve_as_reference(mesh):
    js, ts = _scanners(mesh, "disallow-privileged", max_rows=64)
    big = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "big", "namespace": "default"},
        "spec": {"containers": [
            {"name": f"c{i}", "image": "nginx",
             "securityContext": {"privileged": i == 0}} for i in range(80)
        ]},
    }
    resources = pods(4) + [big]
    tv, _ = _assert_device_equal(js, ts, resources)
    assert (tv[:, 4] == 5).all()  # the big pod overflows into HOST
    got = ts.scan(resources)
    _assert_result_equal(js.scan(resources), got)
    assert (got.verdicts != 5).all()
    row = [i for i, (p, r) in enumerate(got.rules)
           if r == "privileged-containers"][0]
    assert got.verdicts[row, 4] == 2  # fails via scalar completion
    _, stats = _assert_stream_equal(js, ts, resources, tile=16)
    assert stats["host_cells"] > 0


@pytest.mark.parametrize("mesh", ["8", "2x4"])
def test_scan_stream_tiled_matches_reference(mesh):
    js, ts = _shared(mesh, "disallow")
    resources = pods(41)
    got, stats = _assert_stream_equal(js, ts, resources, tile=16)
    assert stats["tiles"] == 3 and got.verdicts.shape[1] == 41
    _assert_result_equal(ts.scan(resources), got)


def test_pipelined_scanner_on_the_mesh_matches_reference():
    js, ts = _shared("8", "disallow")
    # chunks of one padded size (16): one step shape
    chunks = [pods(16), pods(7), pods(12)]

    def run(pipe, chunks):
        out = {}
        stats = pipe.scan_chunks(chunks, on_result=lambda i, r:
                                 out.__setitem__(i, r))
        assert sorted(out) == list(range(len(chunks)))
        assert stats["encode_fallback_chunks"] == 0
        return out

    want = run(JPipeline(js), copy.deepcopy(chunks))
    got = run(PipelinedScanner(ts), chunks)
    for i in range(len(chunks)):
        _assert_result_equal(want[i], got[i])
        _assert_result_equal(ts.scan(chunks[i]), got[i])


def test_mesh_errors():
    with pytest.raises(ValueError) as want:
        jmake_mesh_2d(2, 8)
    with pytest.raises(ValueError) as got:
        make_mesh_2d(2, 8, ["cpu"] * 8)
    assert str(got.value) == str(want.value) == \
        "need 16 devices for a 2x8 mesh, have 8"
    policies = port_policies([expand_policy(p) for p in
                              load_pss_policies("disallow-privileged")])
    with pytest.raises(ValueError, match="not both"):
        ShardedScanner(policies, mesh=make_mesh(["cpu"]), device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        make_mesh(["meta"])


def test_make_mesh_without_cuda_raises(monkeypatch):
    """The default mesh spans every CUDA device; without one it raises
    and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh_2d(1, 1)
    policies = port_policies([expand_policy(p) for p in
                              load_pss_policies("disallow-privileged")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedScanner(policies)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(["cuda:0"])


def test_a_launch_off_the_current_device_raises(monkeypatch):
    """A kernel launches on the current device's stream with the current
    device's shared-memory opt-in: its tensors must lie there, else
    ``KernelError`` (the mesh step enters each shard's device; nothing
    switches quietly). Checked here with the current device faked."""
    from kyverno_tpu_torch import kernels

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(kernels.KernelError, match="current device is cuda:1"):
        kernels._on_current("row_fold", torch.device("cuda", 0))
    with pytest.raises(kernels.KernelError):
        kernels._on_current("row_fold", torch.device("cpu"))
    kernels._on_current("row_fold", torch.device("cuda", 1))
