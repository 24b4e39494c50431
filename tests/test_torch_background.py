"""The port's background controllers (``background/``), cleanup
(``cluster/cleanup.py``), cron (``utils/cron.py``) and kyverno-json
assertions (``engine/jsonassert.py``) against the JAX package's, on the
CPU. These are host semantics: every comparison is exact.

- The same seeded steps drive each package's ``ClusterSnapshot`` and
  controllers; the snapshots' resources and the UpdateRequests' states
  are equal after each step.
- Cron: the next instants of a seeded set of expressions (steps, ranges,
  lists, day-of-week 7) from seeded start times, and the same errors.
- ``assert_tree`` / ``scan_payload`` on seeded trees and payloads.
- The reference's own test functions (tests/test_background.py,
  tests/test_cleanup.py) run against the port."""

import copy
import datetime as dt
import importlib
import random
import types

import pytest

from torch_parity_util import (fresh_port_state,  # noqa: F401
                               port_test_module, run_port_scenario,
                               scenario_params)

PKGS = ("kyverno_tpu", "kyverno_tpu_torch")


def pkg(name):
    imp = importlib.import_module
    return types.SimpleNamespace(
        bg=imp(f"{name}.background"),
        policy=imp(f"{name}.api.policy"),
        snapshot=imp(f"{name}.cluster.snapshot"),
        cleanup=imp(f"{name}.cluster.cleanup"),
        cron=imp(f"{name}.utils.cron"),
        jsonassert=imp(f"{name}.engine.jsonassert"))


REF, PORT = pkg(PKGS[0]), pkg(PKGS[1])


def state(snap):
    return sorted((uid, res) for uid, res, _ in snap.items())


def urs(queue):
    return [(u.name, u.policy, u.rule_type, u.operation, u.status, u.retries,
             u.message) for u in queue.all()]


def namespace(name, labels=None):
    meta = {"name": name}
    if labels:
        meta["labels"] = labels
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": meta}


GENERATE = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "add-networkpolicy"},
    "spec": {"rules": [{
        "name": "default-deny",
        "match": {"any": [{"resources": {"kinds": ["Namespace"]}}]},
        "exclude": {"any": [{"resources": {"selector": {
            "matchLabels": {"tier": "system"}}}}]},
        "generate": {
            "apiVersion": "networking.k8s.io/v1", "kind": "NetworkPolicy",
            "name": "default-deny",
            "namespace": "{{request.object.metadata.name}}",
            "synchronize": True,
            "data": {"metadata": {"labels": {
                "team": "{{request.object.metadata.labels.team || 'none'}}"}},
                "spec": {"podSelector": {}, "policyTypes": ["Ingress"]}},
        },
    }, {
        "name": "quota",
        "match": {"any": [{"resources": {"kinds": ["Namespace"]}}]},
        "preconditions": {"all": [{
            "key": "{{request.object.metadata.labels.quota || ''}}",
            "operator": "Equals", "value": "yes"}]},
        "generate": {
            "apiVersion": "v1", "kind": "ResourceQuota", "name": "q",
            "namespace": "{{request.object.metadata.name}}",
            "data": {"spec": {"hard": {"pods": "10"}}},
        },
    }]},
}

CLONE = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "clone-secret"},
    "spec": {"rules": [{
        "name": "clone-regcred",
        "match": {"any": [{"resources": {"kinds": ["Namespace"]}}]},
        "generate": {
            "apiVersion": "v1", "kind": "Secret", "name": "regcred",
            "namespace": "{{request.object.metadata.name}}",
            "synchronize": True,
            "clone": {"namespace": "default", "name": "regcred"},
        },
    }]},
}

MUTATE_EXISTING = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "label-secrets"},
    "spec": {"rules": [{
        "name": "mark-ns-secrets",
        "match": {"any": [{"resources": {"kinds": ["Namespace"]}}]},
        "mutate": {
            "targets": [{"apiVersion": "v1", "kind": "Secret",
                         "namespace": "{{request.object.metadata.name}}"}],
            "patchStrategicMerge": {"metadata": {"labels": {
                "audited": "true",
                "owner": "{{request.object.metadata.labels.team || 'x'}}"}}},
        },
    }, {
        "name": "annotate-cms",
        "match": {"any": [{"resources": {"kinds": ["Namespace"]}}]},
        "mutate": {
            "targets": [{"apiVersion": "v1", "kind": "ConfigMap",
                         "namespace": "{{request.object.metadata.name}}",
                         "name": "cm-*"}],
            "patchStrategicMerge": {"metadata": {"annotations": {
                "seen-by": "{{request.object.metadata.name}}"}}},
        },
    }]},
}


def seeded_namespaces(seed, n):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        labels = {}
        if rng.random() < 0.6:
            labels["team"] = rng.choice(("a", "b", "c"))
        if rng.random() < 0.4:
            labels["quota"] = rng.choice(("yes", "no"))
        if rng.random() < 0.2:
            labels["tier"] = "system"
        out.append(namespace(f"ns-{i}", labels))
    return out


class Both:
    """One step applied to both packages' objects side by side."""

    def __init__(self, make):
        self.ref, self.port = make(REF), make(PORT)

    def __iter__(self):
        return iter((self.ref, self.port))


def test_generate_from_data_then_the_triggers_deleted():
    def make(p):
        snap = p.snapshot.ClusterSnapshot()
        pol = p.policy.ClusterPolicy.from_dict(copy.deepcopy(GENERATE))
        return types.SimpleNamespace(
            snap=snap, pol=pol, q=p.bg.UpdateRequestQueue(),
            gc=p.bg.GenerateController(snap, {pol.name: pol}), p=p)

    both = Both(make)
    nss = seeded_namespaces(3, 12)
    for x in both:
        for ns in nss:
            x.snap.upsert(copy.deepcopy(ns))
            x.q.add(x.p.bg.UpdateRequest(policy=x.pol.name,
                                         rule_type="generate",
                                         trigger=copy.deepcopy(ns)))
    assert both.ref.q.process(both.ref.gc.process_ur) == \
        both.port.q.process(both.port.gc.process_ur)
    assert urs(both.port.q) == urs(both.ref.q)
    assert state(both.port.snap) == state(both.ref.snap)
    # the generated set is not empty: the seed has both skips and hits
    kinds = [r["kind"] for _, r in state(both.ref.snap)]
    assert kinds.count("NetworkPolicy") > 0 and kinds.count("ResourceQuota") > 0
    for ns in nss[::2]:
        deleted = [x.gc.process_trigger_deletion(x.pol, ns) for x in both]
        assert deleted[0] == deleted[1]
        assert state(both.port.snap) == state(both.ref.snap)
    # a DELETE UpdateRequest takes the same path
    for x in both:
        x.q.add(x.p.bg.UpdateRequest(policy=x.pol.name, rule_type="generate",
                                     trigger=nss[1], operation="DELETE"))
        x.q.process(x.gc.process_ur)
    assert urs(both.port.q) == urs(both.ref.q)
    assert state(both.port.snap) == state(both.ref.snap)


def test_generate_by_clone_waits_for_its_source():
    def make(p):
        snap = p.snapshot.ClusterSnapshot()
        pol = p.policy.ClusterPolicy.from_dict(copy.deepcopy(CLONE))
        return types.SimpleNamespace(
            snap=snap, pol=pol, q=p.bg.UpdateRequestQueue(),
            gc=p.bg.GenerateController(snap, {pol.name: pol}), p=p)

    both = Both(make)
    for x in both:
        for ns in ("team-a", "team-b", "team-c"):
            x.q.add(x.p.bg.UpdateRequest(policy=x.pol.name,
                                         rule_type="generate",
                                         trigger=namespace(ns)))
    for step in range(4):
        if step == 2:
            for x in both:
                x.snap.upsert({"apiVersion": "v1", "kind": "Secret",
                               "metadata": {"name": "regcred",
                                            "namespace": "default",
                                            "uid": "u-1",
                                            "resourceVersion": "7"},
                               "data": {"k": "v"}})
        done = [x.q.process(x.gc.process_ur) for x in both]
        assert done[0] == done[1]
        assert urs(both.port.q) == urs(both.ref.q)
        assert state(both.port.snap) == state(both.ref.snap)
    # the triggers' deletion removes the synchronized clones
    for ns in ("team-a", "team-c"):
        assert both.ref.gc.process_trigger_deletion(both.ref.pol, namespace(ns)) \
            == both.port.gc.process_trigger_deletion(both.port.pol, namespace(ns))
    assert state(both.port.snap) == state(both.ref.snap)


@pytest.mark.parametrize("allowed", [None, {"", "apps"}])
def test_update_request_retry_limit(allowed):
    def make(p):
        snap = p.snapshot.ClusterSnapshot()
        pols = {d["metadata"]["name"]: p.policy.ClusterPolicy.from_dict(
            copy.deepcopy(d)) for d in (CLONE, GENERATE)}
        return types.SimpleNamespace(
            snap=snap, q=p.bg.UpdateRequestQueue(), p=p,
            gc=p.bg.GenerateController(snap, pols, allowed_groups=allowed))

    both = Both(make)
    for x in both:
        x.q.add(x.p.bg.UpdateRequest(policy="clone-secret",
                                     rule_type="generate",
                                     trigger=namespace("never")))
        x.q.add(x.p.bg.UpdateRequest(policy="add-networkpolicy",
                                     rule_type="generate",
                                     trigger=namespace("net")))
        x.q.add(x.p.bg.UpdateRequest(policy="gone", rule_type="generate",
                                     trigger=namespace("x")))
    assert REF.bg.updaterequest.MAX_RETRIES == \
        PORT.bg.updaterequest.MAX_RETRIES
    for _ in range(REF.bg.updaterequest.MAX_RETRIES + 2):
        done = [x.q.process(x.gc.process_ur) for x in both]
        assert done[0] == done[1]
        assert urs(both.port.q) == urs(both.ref.q)
    assert both.port.q.all()[0].status == PORT.bg.UR_FAILED
    assert state(both.port.snap) == state(both.ref.snap)


def test_mutate_existing_targets():
    rng = random.Random(11)
    nss = seeded_namespaces(5, 6)
    seeded = []
    for i in range(40):
        ns = rng.choice(nss)["metadata"]["name"]
        kind = rng.choice(("Secret", "ConfigMap"))
        name = rng.choice(("cm-", "s-", "other-")) + str(i)
        res = {"apiVersion": "v1", "kind": kind,
               "metadata": {"name": name, "namespace": ns}}
        if rng.random() < 0.3:
            res["metadata"]["labels"] = {"keep": "1"}
        seeded.append(res)

    def make(p):
        snap = p.snapshot.ClusterSnapshot()
        for r in seeded:
            snap.upsert(copy.deepcopy(r))
        pol = p.policy.ClusterPolicy.from_dict(copy.deepcopy(MUTATE_EXISTING))
        return types.SimpleNamespace(
            snap=snap, q=p.bg.UpdateRequestQueue(), pol=pol, p=p,
            mc=p.bg.MutateExistingController(snap, {pol.name: pol}))

    both = Both(make)
    for ns in nss:
        for x in both:
            x.q.add(x.p.bg.UpdateRequest(policy=x.pol.name, rule_type="mutate",
                                         trigger=copy.deepcopy(ns)))
        done = [x.q.process(x.mc.process_ur) for x in both]
        assert done[0] == done[1]
        assert urs(both.port.q) == urs(both.ref.q)
        assert state(both.port.snap) == state(both.ref.snap)
    labelled = [r for _, r in state(both.ref.snap)
                if (r["metadata"].get("labels") or {}).get("audited")]
    assert labelled


def seeded_pods(seed, n):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        out.append({"apiVersion": "v1", "kind": rng.choice(("Pod", "Job")),
                    "metadata": {"name": f"p{i}",
                                 "namespace": rng.choice(("jobs", "web")),
                                 "labels": {"state": rng.choice(
                                     ("done", "running"))}},
                    "status": {"phase": rng.choice(
                        ("Succeeded", "Running", "Failed"))}})
    return out


CLEANUP_POLICIES = [{
    "apiVersion": "kyverno.io/v2beta1", "kind": "ClusterCleanupPolicy",
    "metadata": {"name": "sweep-done"},
    "spec": {"schedule": "*/5 * * * *",
             "match": {"any": [{"resources": {
                 "kinds": ["Pod"], "selector": {
                     "matchLabels": {"state": "done"}}}}]}},
}, {
    "apiVersion": "kyverno.io/v2beta1", "kind": "CleanupPolicy",
    "metadata": {"name": "sweep-failed-jobs", "namespace": "jobs"},
    "spec": {"schedule": "0 */2 * * 1-5",
             "match": {"any": [{"resources": {"kinds": ["Job"]}}]},
             "conditions": {"all": [{
                 "key": "{{ request.object.status.phase }}",
                 "operator": "Equals", "value": "Failed"}]}},
}, {
    "apiVersion": "kyverno.io/v2beta1", "kind": "ClusterCleanupPolicy",
    "metadata": {"name": "sweep-succeeded-web"},
    "spec": {"schedule": "30 1 * * 7",
             "match": {"any": [{"resources": {
                 "kinds": ["Pod", "Job"], "namespaces": ["web"]}}]},
             "exclude": {"any": [{"resources": {"selector": {
                 "matchLabels": {"state": "running"}}}}]},
             "conditions": {"any": [{
                 "key": "{{ request.object.status.phase }}",
                 "operator": "AnyIn", "value": ["Succeeded"]}]}},
}]


def test_cleanup_controller_on_a_schedule():
    pods = seeded_pods(21, 60)

    def make(p):
        snap = p.snapshot.ClusterSnapshot()
        for r in pods:
            snap.upsert(copy.deepcopy(r))
        ctl = p.cleanup.CleanupController(snap)
        for d in CLEANUP_POLICIES:
            ctl.set_policy(copy.deepcopy(d))
        return types.SimpleNamespace(snap=snap, ctl=ctl)

    both = Both(make)
    t = dt.datetime(2026, 7, 31, 11, 58)  # a Friday
    rng = random.Random(4)
    for _ in range(30):
        t += dt.timedelta(minutes=rng.choice((1, 3, 7, 61, 600)))
        got = [x.ctl.run_due(t) for x in both]
        assert got[0] == got[1], t
        assert state(both.port.snap) == state(both.ref.snap)
    assert len(state(both.ref.snap)) < len(pods)
    # execute() and unset_policy as well
    for x in both:
        x.ctl.unset_policy("sweep-done")
    for x in both:
        for r in pods[:10]:
            x.snap.upsert(copy.deepcopy(r))
    t += dt.timedelta(days=8)
    assert both.ref.ctl.run_due(t) == both.port.ctl.run_due(t)
    assert state(both.port.snap) == state(both.ref.snap)


def test_validate_cleanup_policy():
    docs = copy.deepcopy(CLEANUP_POLICIES) + [
        {"kind": "ClusterCleanupPolicy", "metadata": {"name": "bad-cron"},
         "spec": {"schedule": "61 * * * *",
                  "match": {"any": [{"resources": {"kinds": ["Pod"]}}]}}},
        {"kind": "ClusterCleanupPolicy", "metadata": {"name": "no-match"},
         "spec": {"schedule": "* * * * *"}},
        {"kind": "CleanupPolicy", "metadata": {"name": "x"},
         "spec": {"schedule": "* * * *",
                  "match": {"any": [{"resources": {"kinds": ["Pod"]}}]}}},
    ]
    for d in docs:
        assert PORT.cleanup.validate_cleanup_policy(copy.deepcopy(d)) == \
            REF.cleanup.validate_cleanup_policy(copy.deepcopy(d))


def test_ttl_controller():
    rng = random.Random(8)
    base = dt.datetime(2026, 7, 29, 10, 0, tzinfo=dt.timezone.utc)
    objs = []
    for i in range(40):
        labels = {}
        pick = rng.random()
        if pick < 0.4:
            labels["cleanup.kyverno.io/ttl"] = rng.choice(
                ("30m", "1h", "90m", "2h30m", "48h", "bogus"))
        elif pick < 0.7:
            at = base + dt.timedelta(minutes=rng.randrange(-60, 600))
            labels["cleanup.kyverno.io/ttl"] = at.strftime("%Y-%m-%dT%H:%M:%SZ")
        meta = {"name": f"cm{i}", "namespace": "d", "labels": labels}
        if rng.random() < 0.8:
            meta["creationTimestamp"] = (
                base - dt.timedelta(minutes=rng.randrange(0, 120))
            ).strftime("%Y-%m-%dT%H:%M:%SZ")
        objs.append({"apiVersion": "v1", "kind": "ConfigMap",
                     "metadata": meta})

    def make(p):
        snap = p.snapshot.ClusterSnapshot()
        for r in objs:
            snap.upsert(copy.deepcopy(r))
        return types.SimpleNamespace(snap=snap,
                                     ttl=p.cleanup.TtlController(snap))

    both = Both(make)
    for minutes in (0, 31, 61, 95, 151, 700, 3000):
        now = base + dt.timedelta(minutes=minutes)
        assert both.ref.ttl.run_once(now) == both.port.ttl.run_once(now)
        assert state(both.port.snap) == state(both.ref.snap)


CRON_EXPRS = [
    "* * * * *", "*/15 2 * * *", "5/20 * * * *", "0 0 * * 7",
    "0 0 * * 5-7", "0 0 * * 0-7", "0 0 * * 3-7/3", "0 0 * * 1-7/2",
    "0 0 * * 1-5/2", "0 0 1 * 5", "30 4 1,15 * *", "0 12 * 2 *",
    "0 0 29 2 *", "10-20/5 8-17 * * 1-5", "0 */6 1-7 * 0",
    "59 23 31 12 *", "0 0 L * *", "0 0 * * 8", "61/2 * * * *",
    "x * * * *", "* * * *", "0 0 0 * *", "*/0 * * * *", "1-0 * * * *",
]


@pytest.mark.parametrize("expr", CRON_EXPRS)
def test_cron_next_instants(expr):
    def build(p):
        try:
            return p.cron.Cron(expr), None
        except p.cron.CronError as e:
            return None, str(e)

    (rc, rerr), (pc, perr) = build(REF), build(PORT)
    assert perr == rerr
    if rc is None:
        return
    assert (pc.minute, pc.hour, pc.dom, pc.month, pc.dow) == \
        (rc.minute, rc.hour, rc.dom, rc.month, rc.dow)
    rng = random.Random(hash(expr) & 0xFFFF)
    for _ in range(6):
        t = dt.datetime(2024 + rng.randrange(3), rng.randrange(1, 13),
                        rng.randrange(1, 29), rng.randrange(24),
                        rng.randrange(60), rng.randrange(60))
        for _ in range(4):
            want = rc.next_after(t)
            assert pc.next_after(t) == want
            assert pc.matches(want) == rc.matches(want)
            t = want


JSON_POLICY = {
    "apiVersion": "json.kyverno.io/v1alpha1", "kind": "ValidatingPolicy",
    "metadata": {"name": "db-policy"},
    "spec": {"rules": [
        {"name": "no-public",
         "match": {"any": [{"kind": "Inventory"}]},
         "assert": {"all": [{"check": {
             "~.(instances)": {"publiclyAccessible": False}}}]}},
        {"name": "min-storage",
         "exclude": {"any": [{"tier": "dev"}]},
         "assert": {"all": [{"check": {"~.(instances)": {
             "storage": ">=10", "(length(name) > `3`)": True}}}]}},
        {"name": "some-tag",
         "assert": {"any": [{"check": {"tags": {"env": "prod"}}},
                            {"check": {"tags": {"env": "staging"}},
                             "message": "staging is fine"}]}},
    ]},
}


def seeded_payloads(seed, n):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        insts = [{"name": rng.choice(("db", "db-1", "cache-22")),
                  "publiclyAccessible": rng.random() < 0.3,
                  "storage": rng.choice((5, 10, 20, 40))}
                 for _ in range(rng.randrange(0, 4))]
        doc = {"kind": rng.choice(("Inventory", "Other")),
               "tier": rng.choice(("dev", "prod")),
               "instances": insts}
        if rng.random() < 0.7:
            doc["tags"] = {"env": rng.choice(("prod", "staging", "test"))}
        out.append(doc)
    return out


def test_jsonassert_scan_payload():
    payloads = seeded_payloads(17, 40)
    for p in payloads:
        want = [r.to_dict() for r in REF.jsonassert.scan_payload(
            [copy.deepcopy(p)], [copy.deepcopy(JSON_POLICY)])]
        got = [r.to_dict() for r in PORT.jsonassert.scan_payload(
            [copy.deepcopy(p)], [copy.deepcopy(JSON_POLICY)])]
        assert got == want
    # every payload at once, as `json scan` passes them
    want = [r.to_dict() for r in REF.jsonassert.scan_payload(
        copy.deepcopy(payloads), [copy.deepcopy(JSON_POLICY)])]
    got = [r.to_dict() for r in PORT.jsonassert.scan_payload(
        copy.deepcopy(payloads), [copy.deepcopy(JSON_POLICY)])]
    assert got == want
    assert {r["result"] for r in want} >= {"pass", "fail"}


ASSERT_TREES = [
    {"kind": "Inventory"},
    {"instances": [{"storage": 20}]},
    {"~.(instances)": {"storage": ">=10"}},
    {"(length(instances))": 2},
    {"tags": {"env": "prod | staging"}},
    {"(tags.env)": "prod"},
    {"tier": "?*", "kind": "!Other"},
    {"~.(instances)": {"(publiclyAccessible)": False}},
    {"missing": None},
    {"instances": []},
]


@pytest.mark.parametrize("tree", range(len(ASSERT_TREES)))
def test_jsonassert_assert_tree(tree):
    def outcome(p, payload):
        try:
            return "ok", p.jsonassert.assert_tree(
                copy.deepcopy(ASSERT_TREES[tree]), copy.deepcopy(payload))
        except p.jsonassert.AssertionError_ as e:
            return "error", str(e)

    for payload in seeded_payloads(29, 30):
        assert outcome(PORT, payload) == outcome(REF, payload)


# the reference's own test functions, run against the port


@pytest.mark.parametrize(
    "module,name,params",
    scenario_params("test_background") + scenario_params("test_cleanup"))
def test_reference_scenario(module, name, params, request):
    run_port_scenario(port_test_module(module), name, params, request)


def test_port_modules_are_the_ports():
    for p in (PORT.bg, PORT.cleanup, PORT.cron, PORT.jsonassert,
              PORT.bg.generate, PORT.bg.mutate_existing):
        assert p.__name__.startswith("kyverno_tpu_torch.")
