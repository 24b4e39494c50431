"""The port's offline replay (kyverno_tpu_torch/cli/flight.py:
``replay_capture``, a copy of the reference's with ``TorchEngine`` where
the reference builds a ``TpuEngine``) against the JAX package's, on the
CPU: the same capture replayed against the same policy set gives the
same diff document, through the device ladder, the scalar oracle and
both (cross-checked).

The captures are real flight records: a background scan's chunk records
from the reference's scan service and from the port's (each package's
own flight recorder at sample rate 1), replayed against the recorded
policy (an empty diff), against a changed policy (the diff is the
change's blast radius) and with records whose namespace labels disagree
(the per-record replay path). Tolerance: exact."""

import copy
import json

import pytest

from kyverno_tpu.api.policy import ClusterPolicy as JPolicy
from kyverno_tpu.cli.flight import replay_capture as jreplay
from kyverno_tpu.cluster import BackgroundScanService as JService
from kyverno_tpu.cluster import ClusterSnapshot as JSnapshot
from kyverno_tpu.cluster import PolicyCache as JCache
from kyverno_tpu.observability.flightrecorder import \
    global_flight as jflight
from kyverno_tpu.policy.autogen import expand_policy as jexpand
from kyverno_tpu_torch.api.policy import ClusterPolicy
from kyverno_tpu_torch.cli.flight import replay_capture
from kyverno_tpu_torch.cluster import (BackgroundScanService,
                                       ClusterSnapshot, PolicyCache)
from kyverno_tpu_torch.observability.flightrecorder import global_flight
from kyverno_tpu_torch.policy.autogen import expand_policy
from kyverno_tpu_torch.tpu.engine import TorchEngine

from torch_parity_util import fresh_port_state  # noqa: F401


def _policy_doc(name="fr-pol", value="false"):
    return {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": name},
        "spec": {"validationFailureAction": "Enforce", "rules": [
            {"name": "named",
             "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
             "validate": {"message": "m",
                          "pattern": {"metadata": {"name": "?*"}}}},
            {"name": "unprivileged",
             "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
             "validate": {"message": "m", "pattern": {"spec": {
                 "containers": [{"=(securityContext)": {
                     "=(privileged)": value}}]}}}},
        ]}}


def _pods(n):
    return [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"sp{i}", "namespace": f"ns{i % 3}",
                          "uid": f"su{i}"},
             "spec": {"containers": [{
                 "name": "c", "image": "nginx",
                 **({"securityContext": {"privileged": True}}
                    if i % 4 == 0 else {})}]}} for i in range(n)]


@pytest.fixture(autouse=True)
def _fresh_flight():
    global_flight.reset()
    yield
    global_flight.reset()


def _capture(port: bool, n=12):
    """A background scan's flight records (sample rate 1), as a spool
    file would hold them (JSON)."""
    flight, service, snapshot, cache, policy = (
        (global_flight, BackgroundScanService, ClusterSnapshot, PolicyCache,
         ClusterPolicy) if port else
        (jflight, JService, JSnapshot, JCache, JPolicy))
    flight.configure(sample_rate=1.0)
    c = cache()
    c.set(policy.from_dict(_policy_doc()))
    snap = snapshot()
    for p in _pods(n):
        snap.upsert(p)
    kw = {"device": "cpu"} if port else {}
    assert service(snap, c, **kw).scan_once(full=True) == n
    recs = [r for r in flight.dump(4 * n) if r["kind"] == "scan"]
    assert len(recs) == n
    return json.loads(json.dumps(recs, default=str))


def _both(records, doc, against):
    want = jreplay(copy.deepcopy(records), [JPolicy.from_dict(doc)],
                   against=against)
    eng = TorchEngine([expand_policy(ClusterPolicy.from_dict(
        copy.deepcopy(doc)))], device="cpu")
    got = replay_capture(copy.deepcopy(records),
                         [ClusterPolicy.from_dict(copy.deepcopy(doc))],
                         against=against, engine=eng)
    assert got == want
    return got


@pytest.mark.parametrize("port", [False, True], ids=["reference", "port"])
@pytest.mark.parametrize("against", ["device", "scalar", "both"])
def test_replay_against_the_recorded_policy_matches(port, against):
    rep = _both(_capture(port), _policy_doc(), against)
    assert rep["replayed"] == 12 and rep["match"] is True, rep["diffs"]
    if against == "both":
        assert rep["device_vs_scalar_consistent"] is True


@pytest.mark.parametrize("port", [False, True], ids=["reference", "port"])
def test_replay_against_a_changed_policy_gives_the_reference_diff(port):
    rep = _both(_capture(port), _policy_doc(value="true"), "both")
    assert rep["match"] is False
    # the privileged Pods' (every fourth) "unprivileged" cell moves
    # from fail to pass; the others set no securityContext and pass both
    assert rep["divergent_records"] == 3
    cells = [c for d in rep["diffs"] for c in d["device"]["cells"]]
    assert {c["rule"] for c in cells} == {"unprivileged"}
    assert rep["device_vs_scalar_consistent"] is True


def test_replay_with_disagreeing_namespace_labels_and_a_limit():
    records = _capture(True)
    for i, rec in enumerate(records):
        rec["ns_labels"] = {"tier": f"t{i}"}  # one label set a record
    records.append({"kind": "scan", "resource": "truncated"})  # unusable
    rep = _both(records, _policy_doc(value="true"), "both")
    assert rep["skipped"] == 1 and rep["replayed"] == 12
    rep = _both(records, _policy_doc(), "device")
    assert rep["match"] is True
    limited = replay_capture(copy.deepcopy(records),
                             [ClusterPolicy.from_dict(_policy_doc())],
                             limit=5, engine=TorchEngine(
                                 [expand_policy(ClusterPolicy.from_dict(
                                     _policy_doc()))], device="cpu"))
    assert limited == jreplay(copy.deepcopy(records),
                              [jexpand(JPolicy.from_dict(_policy_doc()))],
                              limit=5)
    assert limited["replayed"] == 5 and limited["skipped"] == 8
