"""The PyTorch port's ShardedScanner (kyverno_tpu_torch.parallel) against
the JAX package's ShardedScanner on a one-device mesh, on the CPU.

The port scans on one device, so the reference runs on a one-device
mesh (``make_mesh(jax.devices()[:1])``): both pad a batch to the same
power-of-two bucket. ``scan_device`` (uint8 table and counts over the
padded batch), ``scan`` (the scalar-completed ScanResult) and
``scan_stream`` (tiled) must be bit-identical to the reference's on the
scenarios of tests/test_sharding.py — including the 80-container pod
that overflows ``max_rows=64`` into HOST, and ``scan_stream(tile=16)``
over 41 pods — and on 257 seeded PSS resources."""

import random

import jax
import numpy as np
import pytest

from kyverno_tpu.parallel.sharding import ShardedScanner as JScanner
from kyverno_tpu.parallel.sharding import make_mesh
from kyverno_tpu.policies import load_pss_policies
from kyverno_tpu.policy.autogen import expand_policy
from kyverno_tpu.tpu.flatten import EncodeConfig as JEncodeConfig
from kyverno_tpu_torch.parallel.sharding import ShardedScanner
from kyverno_tpu_torch.tpu.flatten import EncodeConfig

from test_sharding import pods
from test_tpu_pss_parity import _resource
from torch_parity_util import port_policies
from torch_parity_util import fresh_port_state  # noqa: F401


def _scanners(subset=None, max_rows=None):
    policies = [expand_policy(p) for p in load_pss_policies(subset)]
    jkw = {"encode_cfg": JEncodeConfig(max_rows=max_rows)} if max_rows else {}
    tkw = {"encode_cfg": EncodeConfig(max_rows=max_rows)} if max_rows else {}
    js = JScanner(policies, mesh=make_mesh(jax.devices()[:1]), **jkw)
    ts = ShardedScanner(port_policies(policies), device="cpu", **tkw)
    assert ts._used_keys == js._used_keys
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


def _assert_stream_equal(js, ts, resources, tile, operations=None,
                         complete_host=True):
    want, wstats = js.scan_stream(resources, tile=tile, operations=operations,
                                  complete_host=complete_host)
    got, gstats = ts.scan_stream(resources, tile=tile, operations=operations,
                                 complete_host=complete_host)
    _assert_result_equal(want, got)
    assert sorted(gstats) == sorted(wstats)
    for k in ("host_cells", "tiles", "tile"):
        assert gstats[k] == wstats[k], k
    return got, gstats


@pytest.fixture(scope="module")
def disallow():
    return _scanners("disallow")


def test_scan_device_matches_reference(disallow):
    js, ts = disallow
    resources = pods(33)
    tv, tc = _assert_device_equal(js, ts, resources)
    # the counts cover the 64-column bucket: 31 pad columns NOT_MATCHED
    assert (tc.sum(axis=1) == ts.pad(33)).all()
    _assert_result_equal(js.scan(resources), ts.scan(resources))


def test_host_verdicts_resolve_as_reference():
    js, ts = _scanners("disallow-privileged", max_rows=64)
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


def test_scan_stream_tiled_matches_reference(disallow):
    js, ts = disallow
    resources = pods(41)
    got, stats = _assert_stream_equal(js, ts, resources, tile=16)
    assert stats["tiles"] == 3 and got.verdicts.shape[1] == 41
    _assert_result_equal(ts.scan(resources), got)
    raw, _ = _assert_stream_equal(js, ts, resources, tile=16,
                                  complete_host=False)
    assert raw.verdicts.dtype == np.uint8


def test_pss_257_resources_match_reference():
    js, ts = _scanners()
    rng = random.Random(257)
    resources = [_resource(rng, i) for i in range(257)]
    ops = [rng.choice(["", "CREATE", "UPDATE", "DELETE"]) for _ in resources]
    _assert_device_equal(js, ts, resources, ops)
    got = ts.scan(resources, operations=ops)
    _assert_result_equal(js.scan(resources, operations=ops), got)
    assert not (got.verdicts >= 5).any()
    # one 512-column tile: the same step shape as the scans above
    stream, _ = _assert_stream_equal(js, ts, resources, tile=512,
                                     operations=ops)
    _assert_result_equal(got, stream)
