"""The lazy imports of the port's copied observability modules that now
resolve (tpu/cache.py, resilience/storage.py and
observability/analytics.py are ported), against the JAX package's on
the CPU (tolerance: exact).

- The flight recorder records each captured resource's content hash and
  the engine's policy-set key, as the reference's does.
- The metrics exposition carries the ``kyverno_rule_*`` series of the
  rule analytics, with the reference's lines after the same scans.
- The operator log writes its file through the storage ladder."""

import copy
import json

from kyverno_tpu.api.policy import ClusterPolicy as JaxPolicy
from kyverno_tpu.observability.flightrecorder import global_flight as jflight
from kyverno_tpu.observability.metrics import global_registry as jreg
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch.api.policy import ClusterPolicy
from kyverno_tpu_torch.observability.flightrecorder import global_flight
from kyverno_tpu_torch.observability.metrics import global_registry as reg
from kyverno_tpu_torch.tpu.cache import resource_content_hash
from kyverno_tpu_torch.tpu.engine import TorchEngine

from test_torch_cache import _pods as _pod_doc_list, _pol_doc
from torch_parity_util import fresh_port_state  # noqa: F401


def _engines():
    doc = _pol_doc()
    return (TpuEngine([JaxPolicy.from_dict(copy.deepcopy(doc))]),
            TorchEngine([ClusterPolicy.from_dict(copy.deepcopy(doc))],
                        device="cpu"))


def test_flight_recorder_records_resource_hashes():
    jeng, teng = _engines()
    pod = _pod_doc_list(1)[0]
    rows = [(("p1", "r1"), 0)]
    try:
        for fr in (global_flight, jflight):
            fr.reset()
            fr.configure(sample_rate=1.0)
        got = global_flight.record_admission(copy.deepcopy(pod), rows,
                                             "device", engine=teng,
                                             outcome="ok")
        want = jflight.record_admission(copy.deepcopy(pod), rows, "device",
                                        engine=jeng, outcome="ok")
        assert got is not None and want is not None
        assert got.resource_sha == resource_content_hash(pod)
        assert got.resource_sha == want.resource_sha
        assert got.ps_key == teng.cps.cache_key() == want.ps_key
    finally:
        global_flight.reset()
        jflight.reset()


def _rule_lines(registry):
    return sorted(line for line in registry.exposition().splitlines()
                  if line.startswith("kyverno_rule_"))


def test_metrics_exposition_has_the_rule_stats_series():
    assert reg.rule_stats is not None
    jeng, teng = _engines()
    pods = _pod_doc_list(9)
    jeng.scan(copy.deepcopy(pods))
    teng.scan(copy.deepcopy(pods))
    lines = _rule_lines(reg)
    assert any(line.startswith("kyverno_rule_evals_total") for line in lines)
    assert lines == _rule_lines(jreg)


def test_oplog_writes_its_file_through_the_storage_ladder(tmp_path):
    from kyverno_tpu_torch.observability.log import global_oplog

    path = tmp_path / "oplog.jsonl"
    try:
        global_oplog.reset()
        global_oplog.configure(path=str(path))
        global_oplog.emit("cache_probe", level="info", rows=3)
        events = [json.loads(line) for line in path.read_text().splitlines()]
        assert any(e.get("event") == "cache_probe" for e in events)
    finally:
        global_oplog.reset()
