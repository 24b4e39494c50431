"""The port's cluster snapshot and background scan service
(kyverno_tpu_torch/cluster/) against the JAX package's, exactly.

``ClusterSnapshot`` keeps the same uids, hashes, namespace-label index
and per-subtree hashes. The reference ``BackgroundScanService`` (JAX on
the CPU over ``make_mesh()``, as tests/test_cluster.py runs it) and the
port's (``device="cpu"``) scan the same seeded cluster through the same
ticks, each with its package's report store configured: every tick
returns the same count, the same ``stats`` (less the two timing ratios,
``pipeline_overlap_ratio`` and ``feed_starvation``), the same
aggregated reports (less their timestamps) and the same store digest,
and the policy-set key the store folds under is the same."""

from __future__ import annotations

import copy
import random

from kyverno_tpu.api.policy import ClusterPolicy as JPolicy
from kyverno_tpu.cluster import BackgroundScanService as JService
from kyverno_tpu.cluster import ClusterSnapshot as JSnapshot
from kyverno_tpu.cluster import PolicyCache as JCache
from kyverno_tpu.parallel import make_mesh
from kyverno_tpu.reports import configure_reports as jconfigure_reports
from kyverno_tpu.tpu import pipeline as jpipeline
from kyverno_tpu_torch.api.policy import ClusterPolicy as TPolicy
from kyverno_tpu_torch.cluster import BackgroundScanService as TService
from kyverno_tpu_torch.cluster import ClusterSnapshot as TSnapshot
from kyverno_tpu_torch.cluster import PolicyCache as TCache
from kyverno_tpu_torch.reports import configure_reports as tconfigure_reports
from kyverno_tpu_torch.tpu import pipeline as tpipeline

from torch_parity_util import fresh_port_state  # noqa: F401 - autouse

NAMESPACES = ("ns0", "ns1", "ns2", "ns3")
TIMING_STATS = ("pipeline_overlap_ratio", "feed_starvation")


def policy_docs():
    priv = {"=(securityContext)": {"=(privileged)": "false"}}
    return [
        {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
         "metadata": {"name": "no-privileged"},
         "spec": {"validationFailureAction": "Audit", "rules": [{
             "name": "no-privileged",
             "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
             "validate": {"message": "privileged forbidden",
                          "pattern": {"spec": {"containers": [priv]}}}}]}},
        {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
         "metadata": {"name": "prod-gated"},
         "spec": {"validationFailureAction": "Enforce", "rules": [{
             "name": "gate",
             "match": {"any": [{"resources": {
                 "kinds": ["Pod"],
                 "namespaceSelector": {"matchLabels": {"env": "prod"}}}}]},
             "validate": {"message": "no latest",
                          "pattern": {"spec": {"containers": [
                              {"image": "!*:latest"}]}}}}]}},
        {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
         "metadata": {"name": "cm-policy"},
         "spec": {"validationFailureAction": "Enforce", "rules": [{
             "name": "r",
             "context": [{"name": "dict", "configMap": {
                 "name": "dict", "namespace": "default"}}],
             "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
             "validate": {"message": "m", "deny": {"conditions": {"any": [{
                 "key": "{{ request.object.metadata.name }}",
                 "operator": "Equals",
                 "value": "{{ dict.data.forbidden }}"}]}}}}]}},
        {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
         "metadata": {"name": "svc-label"},
         "spec": {"validationFailureAction": "Audit", "rules": [{
             "name": "team",
             "match": {"any": [{"resources": {"kinds": ["Service"]}}]},
             "validate": {"message": "team label",
                          "pattern": {"metadata": {"labels": {
                              "team": "?*"}}}}}]}},
    ]


def namespace(name, env):
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": name, "labels": {"env": env}}}


def configmap(forbidden):
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "dict", "namespace": "default"},
            "data": {"forbidden": forbidden}}


def resource(rng, i, rev=0):
    ns = NAMESPACES[i % len(NAMESPACES)]
    meta = {"name": f"r{i}", "namespace": ns, "uid": f"uid-{i}",
            "labels": {"rev": str(rev)}}
    if i % 5 == 4:
        if rng.random() < 0.5:
            meta["labels"]["team"] = "core"
        return {"apiVersion": "v1", "kind": "Service", "metadata": meta,
                "spec": {"ports": [{"port": 80}]}}
    sc = {"securityContext": {"privileged": rng.random() < 0.3}}
    image = rng.choice(("nginx:1.25", "nginx:latest", "redis"))
    if i % 11 == 0:
        meta["name"] = "bad-name"
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"containers": [{"name": "c", "image": image, **sc}]}}


def test_snapshot_parity():
    rng = random.Random(11)
    snaps = (JSnapshot(), TSnapshot())
    events = ([], [])
    for s, ev in zip(snaps, events):
        s.subscribe(lambda uid, change, ev=ev: ev.append((uid, change)))
    docs = [namespace(n, "dev") for n in NAMESPACES] + [configmap("x")]
    docs += [resource(rng, i) for i in range(80)]
    # no uid: keyed by gvk, namespace and name
    docs.append({"apiVersion": "apps/v1", "kind": "Deployment",
                 "metadata": {"name": "d", "namespace": "ns1"},
                 "spec": {"replicas": 2, "template": {"spec": {}}}})
    for d in docs:
        assert snaps[0].upsert(copy.deepcopy(d)) \
            == snaps[1].upsert(copy.deepcopy(d))
    for i in range(0, 80, 7):
        for s in snaps:
            s.upsert(resource(random.Random(i), i, rev=1))
    for s in snaps:
        s.upsert(namespace("ns2", "prod"))
        s.delete("uid-3")
        s.delete(namespace("ns3", "dev"))
        s.upsert(namespace("ns3", "prod"))
    j, t = snaps
    assert [(u, h) for u, _, h in t.items()] == [(u, h) for u, _, h in j.items()]
    assert len(t) == len(j)
    assert t.namespace_labels() == j.namespace_labels()
    for uid, _, _ in j.items():
        assert t.subhashes_of(uid) == j.subhashes_of(uid)
        assert t.hash_of(uid) == j.hash_of(uid)
    assert events[1] == events[0]


class Pair:
    """The two services over the same cluster, changed together."""

    def __init__(self, seed: int, n: int = 200):
        self.rng = random.Random(seed)
        self.snaps = (JSnapshot(), TSnapshot())
        self.caches = (JCache(), TCache())
        for d in policy_docs():
            self.caches[0].set(JPolicy.from_dict(copy.deepcopy(d)))
            self.caches[1].set(TPolicy.from_dict(copy.deepcopy(d)))
        self.stores = (jconfigure_reports(), tconfigure_reports())
        self.n = n
        self.upsert(configmap("bad-name"))
        for k, name in enumerate(NAMESPACES):
            self.upsert(namespace(name, "prod" if k % 2 else "dev"))
        for i in range(n):
            self.upsert(resource(self.rng, i))
        self.svcs = (JService(self.snaps[0], self.caches[0], mesh=make_mesh(),
                              batch_size=64),
                     TService(self.snaps[1], self.caches[1], device="cpu",
                              batch_size=64))

    def upsert(self, doc):
        for s in self.snaps:
            s.upsert(copy.deepcopy(doc))

    def delete(self, uid):
        for s in self.snaps:
            s.delete(uid)

    def churn(self, rev: int, count: int = 30):
        for _ in range(count):
            roll = self.rng.random()
            if roll < 0.7:
                i = self.rng.randrange(self.n)
                self.upsert(resource(random.Random(rev * 1000 + i), i, rev))
            elif roll < 0.85:
                self.upsert(resource(self.rng, self.n))
                self.n += 1
            else:
                self.delete(f"uid-{self.rng.randrange(self.n)}")

    def tick(self, full: bool = False):
        counts = [svc.scan_once(full=full) for svc in self.svcs]
        assert counts[1] == counts[0]
        stats = [{k: v for k, v in svc.stats.items() if k not in TIMING_STATS}
                 for svc in self.svcs]
        assert stats[1] == stats[0]
        reports = [{ns: _untimed(rep.to_dict())
                    for ns, rep in svc.aggregator.aggregate().items()}
                   for svc in self.svcs]
        assert reports[1] == reports[0]
        assert self.svcs[1].aggregator.summary() \
            == self.svcs[0].aggregator.summary()
        assert self.stores[1].digest() == self.stores[0].digest()
        assert self.stores[1].summary() == self.stores[0].summary()
        return counts[0]


def _untimed(doc):
    for r in doc["results"]:
        r.pop("timestamp")
    return doc


def test_scan_service_parity():
    pair = Pair(seed=5)
    # the first tick scans everything
    assert pair.tick() == pair.n + len(NAMESPACES) + 1
    rows = pair.stores[0].state()["resources"]
    assert rows > 0 and pair.stores[0].summary()["fail"] > 0
    # the store folds under the same policy-set key in both packages
    jkey = {rec[1] for rec in pair.stores[0]._rows.values()}
    tkey = {rec[1] for rec in pair.stores[1]._rows.values()}
    assert tkey == jkey and len(jkey) == 1 and "" not in jkey
    # churn: upserts, adds and deletes
    for rev in (1, 2):
        pair.churn(rev)
        assert 0 < pair.tick() <= 30
    # a namespace's labels change: its members rescan
    pair.upsert(namespace("ns0", "prod"))
    assert pair.tick() >= pair.n // len(NAMESPACES)
    # the folded ConfigMap changes: a recompile and a full rescan
    pair.upsert(configmap("r2"))
    assert pair.tick() == len(pair.snaps[0])
    # an unchanged tick: no resource, no report work
    fold0 = pair.stores[0].state()["seq"], pair.stores[1].state()["seq"]
    assert pair.tick() == 0
    assert (pair.stores[0].state()["seq"],
            pair.stores[1].state()["seq"]) == fold0
    # a full rescan is served from the verdict cache alike
    assert pair.tick(full=True) > 0
    assert pair.svcs[1].stats["verdict_cache_hits"] > 0


def test_pipeline_failure_reports_error_rows_never_cached(monkeypatch):
    pair = Pair(seed=9, n=60)

    def broken(self, *a, **kw):
        raise RuntimeError("pipeline down")

    monkeypatch.setattr(jpipeline.PipelinedScanner, "scan_chunks", broken)
    monkeypatch.setattr(tpipeline.PipelinedScanner, "scan_chunks", broken)
    assert pair.tick() == 60 + len(NAMESPACES) + 1
    for store in pair.stores:
        summary = store.summary()
        assert summary["error"] > 0
        assert summary["pass"] == summary["fail"] == 0
    monkeypatch.undo()
    # the ERROR rows were never cached: a full rescan evaluates again
    # (no verdict-cache hit) and replaces them with the real verdicts
    hits0 = [svc.stats["verdict_cache_hits"] for svc in pair.svcs]
    assert pair.tick(full=True) == 60 + len(NAMESPACES) + 1
    assert [svc.stats["verdict_cache_hits"] for svc in pair.svcs] == hits0
    for svc in pair.svcs:
        assert svc.aggregator.summary()["error"] == 0
        assert svc.aggregator.summary()["fail"] > 0
    # the store folds by (content hash, policy-set key), both unchanged:
    # in both packages it keeps the ERROR rows until the content moves
    for store in pair.stores:
        assert store.summary()["error"] > 0
