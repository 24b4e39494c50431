"""The port's sharded scan on a mesh of CPU entries against the JAX
package's on its 8 virtual CPU devices (tests/test_torch_mesh.py
describes both), over 257 seeded resources of the 18 PSS policies:
``scan_device``, ``scan`` and ``scan_stream`` on ``make_mesh()`` and on
``make_mesh_2d(2, 4)``. Tolerance: exact."""

import random

import pytest

from test_torch_mesh import (_assert_device_equal, _assert_result_equal,
                             _assert_stream_equal, _scanners)
from test_tpu_pss_parity import _resource
from torch_parity_util import fresh_port_state  # noqa: F401


@pytest.mark.parametrize("mesh", ["8", "2x4"])
def test_pss_257_resources_match_reference(mesh):
    js, ts = _scanners(mesh)
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
