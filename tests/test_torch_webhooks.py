"""The port's admission webhook (``kyverno_tpu_torch/webhooks/server.py``:
``Handlers``, ``build_handlers``, ``AdmissionServer``) against the JAX
package's, on the CPU (tolerance: exact).

Both packages' handlers get the same policy set, the same seeded
AdmissionReviews and the same paths; the port's run with
``device="cpu"`` (every kernel replaced by its plain twin). Three
serving modes: the plain micro-batcher, ``batching`` (the serving
pipeline), and ``batching`` with ``mutate_batching`` (the device-triaged
mutate pipeline). Every response is compared whole, with the JSON patch
decoded: ``allowed``, ``status``, ``patchType``, ``patch``,
``warnings`` and ``auditAnnotations`` included. The scenarios are those
of tests/test_webhooks.py: an Enforce failure and an Audit warning,
the mutate patch and mutate with image verification, fine-grained and
failure-policy class paths, the policy, exception and global-context
CR routes, partial evaluations merged in reports; then the same
reviews over HTTP through ``AdmissionServer``, and the keys of
``debug_state()``."""

import base64
import concurrent.futures
import copy
import http.client
import importlib
import json
import random

import pytest

from torch_parity_util import fresh_port_state  # noqa: F401

PKGS = ("kyverno_tpu", "kyverno_tpu_torch")
MODES = {
    "plain": {},
    "batching": {"batching": True},
    "mutate_batching": {"batching": True, "mutate_batching": True},
}

ENFORCE = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "no-privileged"},
    "spec": {"validationFailureAction": "Enforce", "rules": [{
        "name": "privileged",
        "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
        "validate": {"message": "privileged is forbidden",
                     "pattern": {"spec": {"containers": [
                         {"=(securityContext)": {"=(privileged)": "false"}}]}}},
    }]},
}
AUDIT = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "require-team"},
    "spec": {"validationFailureAction": "Audit", "rules": [{
        "name": "team-label",
        "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
        "validate": {"message": "label team is required",
                     "pattern": {"metadata": {"labels": {"team": "?*"}}}},
    }]},
}
IGNORE_CLASS = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "no-latest", "namespace": ""},
    "spec": {"validationFailureAction": "Enforce", "failurePolicy": "Ignore",
             "rules": [{
                 "name": "tag",
                 "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
                 "validate": {"message": "the latest tag is forbidden",
                              "pattern": {"spec": {"containers": [
                                  {"image": "!*:latest"}]}}},
             }]},
}
MUTATE = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "add-label"},
    "spec": {"rules": [{
        "name": "add-team-label",
        "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
        "mutate": {"patchStrategicMerge": {
            "metadata": {"labels": {"+(team)": "core"}}}},
    }]},
}
MUTATE_NS = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "annotate-prod"},
    "spec": {"rules": [{
        "name": "owner",
        "match": {"any": [{"resources": {"kinds": ["Pod"],
                                         "namespaces": ["prod"]}}]},
        "mutate": {"patchStrategicMerge": {
            "metadata": {"annotations": {"+(owner)": "platform"}}}},
    }]},
}
POLICIES = [ENFORCE, AUDIT, IGNORE_CLASS, MUTATE, MUTATE_NS]
EXCEPTIONS = [{
    "apiVersion": "kyverno.io/v2", "kind": "PolicyException",
    "metadata": {"name": "exempt-debug", "namespace": "default"},
    "spec": {"exceptions": [{"policyName": "no-privileged",
                             "ruleNames": ["privileged"]}],
             "match": {"any": [{"resources": {"kinds": ["Pod"],
                                              "names": ["debug-*"]}}]}},
}]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def review(resource, uid="u1", operation="CREATE", old=None, user="alice",
           dry_run=False):
    req = {"uid": uid, "operation": operation,
           "namespace": (resource.get("metadata") or {}).get("namespace", ""),
           "object": resource,
           "userInfo": {"username": user, "groups": ["dev"]}}
    if old is not None:
        req["oldObject"] = old
    if dry_run:
        req["dryRun"] = True
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": req}


def pod(name, priv=None, image="nginx:1.2", labels=None, ns="default"):
    sc = {"securityContext": {"privileged": priv}} if priv is not None else {}
    meta = {"name": name, "namespace": ns}
    if labels:
        meta["labels"] = labels
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"containers": [{"name": "c", "image": image, **sc}]}}


def seeded_reviews(seed, n):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        name = rng.choice(("web", "api", "debug", "job")) + f"-{i}"
        labels = rng.choice((None, {"team": "a"}, {"app": "x"},
                             {"team": ""}))
        res = pod(name, rng.choice((None, True, False)),
                  rng.choice(("nginx:1.2", "nginx:latest", "redis")),
                  labels, rng.choice(("default", "prod")))
        op = rng.choice(("CREATE", "CREATE", "UPDATE", "DELETE"))
        old = None
        if op != "CREATE":
            old = copy.deepcopy(res)
            old["spec"]["containers"][0]["image"] = "nginx:1.1"
        out.append(review(res, uid=f"u{seed}-{i}", operation=op, old=old,
                          user=rng.choice(("alice", "system:node:n1")),
                          dry_run=rng.random() < 0.1))
    return out


# the webhook paths a review is posted to: (failure policy, policy key)
PATHS = [("all", None), ("fail", None), ("ignore", None),
         ("fail", ("", "no-privileged")), ("fail", ("", "require-team")),
         ("ignore", ("", "no-latest")), ("fail", ("", "add-label")),
         ("fail", ("", "no-such-policy")), ("ignore", ("", "no-such-policy"))]


def _handlers(pkg, mode, policies=POLICIES, **kw):
    cluster = _mod(pkg, "cluster")
    policy = _mod(pkg, "api.policy")
    cache = cluster.PolicyCache()
    for d in policies:
        cache.set(policy.ClusterPolicy.from_dict(copy.deepcopy(d)))
    if pkg == "kyverno_tpu_torch":
        kw["device"] = "cpu"
    agg = kw.pop("aggregator", None) or cluster.ReportAggregator()
    return _mod(pkg, "webhooks").build_handlers(
        cache, cluster.ClusterSnapshot(), agg, max_wait_ms=2.0,
        exceptions=copy.deepcopy(EXCEPTIONS), **MODES[mode], **kw)


def _stop(h):
    h.batcher.stop()
    for p in (h.pipeline, h.mutate_pipeline):
        if p is not None:
            p.stop()


@pytest.fixture(scope="module", params=list(MODES))
def pair(request):
    hs = [_handlers(pkg, request.param) for pkg in PKGS]
    yield request.param, hs
    for h in hs:
        _stop(h)


def norm(out):
    """The response with its JSON patch decoded."""
    out = copy.deepcopy(out)
    r = out.get("response") or {}
    if "patch" in r:
        r["patch"] = json.loads(base64.b64decode(r["patch"]))
    return out


def _both(hs, fn):
    return [norm(fn(h)) for h in hs]


def test_validate_responses_equal_reference(pair):
    """Enforce failures deny and Audit failures admit, on every class
    and fine-grained path."""
    _, hs = pair
    denied = allowed = 0
    for i, rv in enumerate(seeded_reviews(11, 36)):
        fp, key = PATHS[i % len(PATHS)]
        want, got = _both(hs, lambda h: h.validate(copy.deepcopy(rv), fp,
                                                   policy_key=key))
        assert got == want, (fp, key, rv)
        denied += not got["response"]["allowed"]
        allowed += got["response"]["allowed"]
    assert denied and allowed


def test_mutate_responses_equal_reference(pair):
    _, hs = pair
    patched = 0
    for i, rv in enumerate(seeded_reviews(12, 36)):
        fp, key = PATHS[i % len(PATHS)]
        want, got = _both(hs, lambda h: h.mutate(copy.deepcopy(rv), fp,
                                                 policy_key=key))
        assert got == want, (fp, key, rv)
        patched += "patch" in got["response"]
    assert patched


def test_concurrent_validate_and_mutate_equal_reference(pair):
    """Concurrent requests coalesce into batches (micro-batcher or
    pipeline flushes); every answer is still the reference's."""
    _, hs = pair
    reviews = seeded_reviews(13, 16)
    outs = []
    for h in hs:
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            v = list(ex.map(lambda r: norm(h.validate(copy.deepcopy(r))),
                            reviews))
            m = list(ex.map(lambda r: norm(h.mutate(copy.deepcopy(r))),
                            reviews))
        outs.append((v, m))
    assert outs[1] == outs[0]


def test_cr_routes_equal_reference(pair):
    _, hs = pair
    bad_policy = {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
                  "metadata": {"name": "empty"}, "spec": {"rules": []}}
    # a variable outside the allowed list is a warning, not an error
    warn_policy = copy.deepcopy(ENFORCE)
    warn_policy["spec"]["rules"][0]["validate"]["message"] = \
        "{{ unknownroot.field }} is forbidden"
    gctx = [{"metadata": {"name": "x"}, "spec": {}},
            {"metadata": {"name": "x"},
             "spec": {"kubernetesResource": {"version": "v1",
                                             "resource": "pods"},
                      "apiCall": {"urlPath": "/x"}}},
            {"metadata": {"name": "x"},
             "spec": {"apiCall": {"urlPath": "/api/v1/pods",
                                  "refreshInterval": "30s"}}}]
    exc_bad = {"metadata": {"name": "e"}, "spec": {"exceptions": []}}
    calls = [
        lambda h: h.validate_policy_cr(review(ENFORCE, uid="pv1")),
        lambda h: h.validate_policy_cr(review(bad_policy, uid="pv2")),
        lambda h: h.validate_policy_cr(review(warn_policy, uid="pv3")),
        lambda h: h.validate_policy_cr(review({}, uid="pv4",
                                              operation="DELETE")),
        lambda h: h.mutate_policy_cr(review(ENFORCE, uid="pm1")),
        lambda h: h.validate_exception(review(EXCEPTIONS[0], uid="e1")),
        lambda h: h.validate_exception(review(exc_bad, uid="e2")),
    ] + [lambda h, g=g: h.validate_globalcontext(review(g, uid="g"))
         for g in gctx]
    allowed, warned = [], 0
    for call in calls:
        want, got = _both(hs, call)
        assert got == want
        allowed.append(got["response"]["allowed"])
        warned += bool(got["response"].get("warnings"))
    assert True in allowed and False in allowed and warned


def test_scalar_toggle_and_config_filter_equal_reference():
    outs = []
    for pkg in PKGS:
        config = _mod(pkg, "config")
        cfg = config.Configuration()
        cfg.load({"resourceFilters": "[Pod,skip-ns,*]",
                  "excludeUsernames": "system:serviceaccount:kyverno:*"})
        h = _handlers(pkg, "plain", configuration=cfg,
                      toggles=config.Toggles(engine="scalar"))
        filtered = pod("bad", True, ns="skip-ns")
        sa = review(pod("bad2", True))
        sa["request"]["userInfo"] = {
            "username": "system:serviceaccount:kyverno:admission"}
        outs.append([norm(h.validate(r)) for r in
                     (review(pod("bad", True)), review(filtered), sa)]
                    + [norm(h.mutate(r)) for r in seeded_reviews(14, 8)])
        _stop(h)
    assert outs[1] == outs[0]
    assert [o["response"]["allowed"] for o in outs[1][:3]] == \
        [False, True, True]


def _reports(agg):
    return sorted((uid, r.policy, r.rule, r.result)
                  for uid, rows in agg._per_resource.items() for r in rows)


def test_partial_evaluations_merge_in_reports_equal_reference(pair):
    """Class-split and fine-grained paths cover disjoint policy sets;
    their rows merge per policy in the aggregator, in both packages."""
    mode, _ = pair
    outs = []
    for pkg in PKGS:
        agg = _mod(pkg, "cluster").ReportAggregator()
        h = _handlers(pkg, mode, aggregator=agg)
        for i, rv in enumerate(seeded_reviews(15, 12)):
            rv["request"]["operation"] = "CREATE"
            rv["request"].pop("oldObject", None)
            for fp, key in PATHS[:6]:
                h.validate(copy.deepcopy(rv), fp, policy_key=key)
        outs.append((_reports(agg), agg.summary()))
        _stop(h)
    assert outs[1] == outs[0]
    assert outs[1][0]
    # the reference test's direct merge, in both packages
    merged = []
    for pkg in PKGS:
        reports = _mod(pkg, "cluster.reports")
        agg = reports.ReportAggregator()
        mk = lambda pol, res: reports.ReportResult(  # noqa: E731
            policy=pol, rule="r", result=res, resource_kind="Pod",
            resource_name="p", resource_namespace="default")
        agg.put("uid1", [mk("a", "fail"), mk("b", "pass")])
        agg.put("uid1", [mk("a", "pass")], scope={"a"})
        merged.append({(r.policy, r.result) for r in agg._per_resource["uid1"]})
    assert merged[0] == merged[1] == {("a", "pass"), ("b", "pass")}


# -- mutate with image verification (resource/handlers.go:139-177)

VERIFY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "verify-img"},
    "spec": {"validationFailureAction": "Enforce", "rules": [{
        "name": "check-sig",
        "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
        "verifyImages": [{"imageReferences": ["ghcr.io/org/*"],
                          "attestors": [{"entries": [{"keys": {
                              "publicKeys": "KEY"}}]}]}],
    }]},
}
VERIFY_AUDIT = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "verify-img-audit"},
    "spec": {"validationFailureAction": "Audit", "rules": [{
        "name": "check-sig",
        "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
        "verifyImages": [{"imageReferences": ["quay.io/org/*"],
                          "mutateDigest": False,
                          "attestors": [{"entries": [{"keys": {
                              "publicKeys": "-----BEGIN PUBLIC KEY-----\nX\n"
                                            "-----END PUBLIC KEY-----"}}]}]}],
    }]},
}


@pytest.mark.requires_crypto
def test_mutate_with_image_verification_equal_reference(pair):
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import ec

    mode, _ = pair
    priv = ec.generate_private_key(ec.SECP256R1())
    pem = priv.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo).decode()
    digest = "sha256:" + "cd" * 32
    verify = copy.deepcopy(VERIFY)
    verify["spec"]["rules"][0]["verifyImages"][0]["attestors"][0][
        "entries"][0]["keys"]["publicKeys"] = pem
    images = ["ghcr.io/org/app:v1", "ghcr.io/org/other:v2", "nginx:1.2",
              "quay.io/org/tool:v3"]
    outs = []
    for pkg in PKGS:
        StaticRegistry = _mod(pkg, "images").StaticRegistry
        signed = StaticRegistry()
        signed.add_image(images[0], digest)
        signed.sign(images[0], key=priv)
        unsigned = StaticRegistry()
        unsigned.add_image(images[0], digest)
        got = []
        for reg in (signed, unsigned):
            agg = _mod(pkg, "cluster").ReportAggregator()
            h = _handlers(pkg, mode, [verify, VERIFY_AUDIT, MUTATE],
                          registry_client=reg, aggregator=agg)
            for i, img in enumerate(images):
                got.append(norm(h.mutate(review(
                    pod(f"iv-{i}", image=img), uid=f"iv{i}"))))
            got.append(agg.summary())
            _stop(h)
        outs.append(got)
    assert outs[1] == outs[0]
    allowed = [o["response"]["allowed"] for o in outs[1]
               if isinstance(o, dict) and "response" in o]
    assert True in allowed and False in allowed
    patch = outs[1][0]["response"]["patch"]
    assert f"ghcr.io/org/app:v1@{digest}" in [op.get("value") for op in patch]


# -- over HTTP


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.status, resp.read()
    conn.close()
    return data


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.status, resp.read()
    conn.close()
    return data


def _url(base, fp, key):
    if key is None:
        return f"/{base}" if fp == "all" else f"/{base}/{fp}"
    return f"/{base}/{fp}/finegrained/{key[1]}"


def test_http_round_trip_equal_reference(pair):
    _, hs = pair
    reviews = seeded_reviews(16, 16)
    calls = [(_url("validate" if i % 2 else "mutate", *PATHS[i % len(PATHS)]),
              rv) for i, rv in enumerate(reviews)]
    calls += [("/policyvalidate", review(ENFORCE, uid="pv")),
              ("/exception", review(EXCEPTIONS[0], uid="ex")),
              ("/globalcontext", review({"metadata": {"name": "g"},
                                         "spec": {}}, uid="gc")),
              ("/validate/fail/finegrained", reviews[0]),
              ("/nowhere", reviews[0])]
    outs = []
    for pkg, h in zip(PKGS, hs):
        srv = _mod(pkg, "webhooks").AdmissionServer(h, port=0,
                                                    enable_debug=True)
        srv.start()
        try:
            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                got = list(ex.map(lambda c: _post(srv.port, *c), calls))
            got = [(code, norm(json.loads(body)) if code == 200 else body)
                   for code, body in got]
            health = [_get(srv.port, p)[0] for p in
                      ("/health/liveness", "/healthz", "/nothing")]
            ready_code, ready = _get(srv.port, "/readyz")
            debug_code, debug = _get(srv.port, "/debug/state")
            outs.append((got, health, ready_code,
                         sorted(json.loads(ready)), debug_code,
                         sorted(json.loads(debug))))
        finally:
            # the handlers are the module fixture's: stop the HTTP side only
            srv._httpd.shutdown()
            srv._httpd.server_close()
    assert outs[1] == outs[0]


def _keys(doc, depth=2):
    """The key tree of ``doc`` to ``depth``; the phase breakdown's keys
    are the phases that have run in the process (the profiler is
    process-global, and neither package's test state resets it), not a
    schema."""
    if not isinstance(doc, dict) or depth == 0:
        return None
    return {k: _keys(v, 0 if k == "phase_breakdown" else depth - 1)
            for k, v in doc.items()}


def test_debug_state_keys_equal_reference(pair):
    _, hs = pair
    for h in hs:  # a compiled version, so compile_cache has its entry
        h.validate(review(pod("warm", False)))
    want, got = [h.debug_state() for h in hs]
    assert _keys(got) == _keys(want)
    assert sorted(got["compile_cache"][0]) == sorted(want["compile_cache"][0])
    assert got["perf_caches"]["xla_cache_dir"] is None


def test_debug_profiler_routes():
    """/debug/xla/start|stop keep their names; the port's run
    torch.profiler and write a Chrome trace into the directory."""
    import os
    import tempfile

    from kyverno_tpu_torch.webhooks.server import handle_debug_path

    with tempfile.TemporaryDirectory() as d:
        code, body, _ = handle_debug_path(f"/debug/xla/start?dir={d}")
        assert code == 200 and d in body.decode()
        assert handle_debug_path(f"/debug/xla/start?dir={d}")[0] == 500
        assert handle_debug_path("/debug/xla/stop")[0] == 200
        assert os.path.exists(os.path.join(d, f"trace-{os.getpid()}.json"))
        assert handle_debug_path("/debug/xla/stop")[0] == 500


def test_handlers_default_to_the_card():
    """No device= means CUDA, as TorchEngine's default: without a card
    the first compile raises rather than run on the CPU."""
    import torch

    from kyverno_tpu_torch.webhooks.server import Handlers

    h = _handlers("kyverno_tpu_torch", "plain")
    assert h.device == "cpu"
    _stop(h)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cluster = _mod("kyverno_tpu_torch", "cluster")
    policy = _mod("kyverno_tpu_torch", "api.policy")
    cache = cluster.PolicyCache()
    cache.set(policy.ClusterPolicy.from_dict(copy.deepcopy(ENFORCE)))
    h = Handlers(cache)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        h._engine()
    _stop(h)
