"""The port's shadow verifier (``observability/verification.py``)
against the JAX package's, on the CPU (tolerance: exact).

Flight records of admissions are made from each package's own engine
(a scan's ``resource_verdicts`` rows, recorded with the engine that
served them, as the admission pipeline's flight hook does). The port's
verifier re-evaluates every record through the scalar oracle and counts
no divergence; a record with one verdict flipped counts one; and on the
same records its totals and stats equal the reference verifier's on the
reference's records."""

import copy

import pytest

from kyverno_tpu.api.policy import ClusterPolicy as JPolicy
from kyverno_tpu.observability.flightrecorder import global_flight as jflight
from kyverno_tpu.observability.verification import ShadowVerifier as JVerifier
from kyverno_tpu.serving import resource_verdicts as jrows
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch.api.policy import ClusterPolicy
from kyverno_tpu_torch.observability.flightrecorder import global_flight
from kyverno_tpu_torch.observability.verification import (ShadowVerifier,
                                                          scalar_rows)
from kyverno_tpu_torch.serving import resource_verdicts
from kyverno_tpu_torch.tpu.engine import TorchEngine
from kyverno_tpu_torch.tpu.evaluator import FAIL, PASS

from test_lifecycle import _pod, _pol_dict
from torch_parity_util import fresh_port_state  # noqa: F401


@pytest.fixture(autouse=True)
def _recorders():
    for fr in (global_flight, jflight):
        fr.reset()
        fr.configure(sample_rate=1.0)
    yield
    for fr in (global_flight, jflight):
        fr.reset()


def _docs():
    return [_pol_dict("a"), _pol_dict("b", priv="true"),
            _pol_dict("c", priv="true")]


def _pods():
    return [_pod(f"p{i}", priv=bool(i % 3)) for i in range(12)]


def _records(recorder, eng, rows_of, flip=None):
    """One flight record a pod, its rows from one scan of ``eng``;
    ``flip`` = (record, rule row) whose verdict is flipped."""
    pods = _pods()
    res = eng.scan(copy.deepcopy(pods))
    out = []
    for ci, pod in enumerate(pods):
        rows = rows_of(res, ci)
        if flip is not None and flip[0] == ci:
            (key, code) = rows[flip[1]]
            rows[flip[1]] = (key, PASS if code == FAIL else FAIL)
        rec = recorder.record_admission(
            copy.deepcopy(pod), rows, "batched", engine=eng,
            namespace="default", operation="CREATE",
            userinfo={"username": "alice"}, outcome="ok")
        assert rec is not None
        out.append(rec)
    return out


def _verify(verifier_cls, make_records):
    """A synchronous verifier at rate 1, a sink of the recorder before
    the records are made (the recorder drops each record's engine once
    its sinks have run)."""
    v = verifier_cls()
    v.configure(rate=1.0, synchronous=True)
    make_records()
    return v


@pytest.mark.parametrize("flip", [None, (4, 1), (0, 0)])
def test_verifier_counts_equal_reference(flip):
    teng = TorchEngine([ClusterPolicy.from_dict(d) for d in _docs()],
                       device="cpu")
    jeng = TpuEngine([JPolicy.from_dict(d) for d in _docs()])
    got = _verify(ShadowVerifier, lambda: _records(
        global_flight, teng, resource_verdicts, flip))
    want = _verify(JVerifier, lambda: _records(jflight, jeng, jrows, flip))
    assert got.totals() == want.totals()
    assert got.state()["stats"] == want.state()["stats"]
    assert got.totals() == {"checked": 12,
                            "divergences": 0 if flip is None else 1}


def test_scalar_rows_equal_the_engine_rows():
    teng = TorchEngine([ClusterPolicy.from_dict(d) for d in _docs()],
                       device="cpu")
    pods = _pods()
    res = teng.scan(copy.deepcopy(pods))
    for ci, pod in enumerate(pods):
        assert scalar_rows(teng, copy.deepcopy(pod), {}, "CREATE") \
            == resource_verdicts(res, ci)
