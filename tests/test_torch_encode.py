"""TorchEngine.encode (kyverno_tpu_torch) against TpuEngine.encode.

The port's host encode (its copies of tpu/flatten.py and
tpu/metadata.py, and the dynamic-operand lanes) must produce every
lane of the JAX package's encode with the same values and dtype, on
PSS over the seeded PSS generator and on the corpora of the JAX parity
modules. The lanes the device sees (uint32 hash lanes as int32 bit
patterns) must carry the same bits."""

import random

import pytest

from kyverno_tpu.policies import load_pss_policies
from kyverno_tpu.policy.autogen import expand_policy
from kyverno_tpu.tpu.engine import TpuEngine

from test_tpu_pss_parity import _resource
from torch_parity_util import (CORPUS_PARAMS, Recorded, assert_lanes_equal,
                               jax_encode, padded_args, port_engine,
                               port_infos, port_lanes_cpu, record_corpus)
from torch_parity_util import fresh_port_state  # noqa: F401


def _port_encode(teng, jeng, rec):
    resources, ops, infos = padded_args(jeng, rec)
    return teng.encode(resources, rec.namespace_labels, ops,
                       port_infos(infos))[0]


def _check(jeng, teng, rec):
    want = jax_encode(jeng, rec)
    got = _port_encode(teng, jeng, rec)
    assert_lanes_equal(want, got)
    dev = port_lanes_cpu(got)
    for k, v in want.items():
        t = dev[k].numpy()
        assert t.shape == v.shape and t.tobytes() == v.tobytes(), k


@pytest.fixture(scope="module")
def pss():
    jeng = TpuEngine([expand_policy(p) for p in load_pss_policies()])
    return jeng, port_engine(jeng)


@pytest.mark.parametrize("seed", [7, 21, 1234])
def test_pss_lanes_equal_reference(pss, seed):
    jeng, teng = pss
    rng = random.Random(seed)
    resources = [_resource(rng, i) for i in range(37)]
    ops = [rng.choice(["", "CREATE", "UPDATE", "DELETE"]) for _ in resources]
    _check(jeng, teng, Recorded(jeng, resources, None, ops, None))


@pytest.mark.parametrize("module,name", CORPUS_PARAMS)
def test_corpus_lanes_equal_reference(monkeypatch, module, name):
    ports = {}
    for rec in record_corpus(monkeypatch, module, name):
        if id(rec.engine) not in ports:
            ports[id(rec.engine)] = port_engine(rec.engine)
        _check(rec.engine, ports[id(rec.engine)], rec)
