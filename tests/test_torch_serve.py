"""The port's control plane and entry points (``kyverno_tpu_torch/cli/
serve.py``, ``cli/apply.py``, ``python -m kyverno_tpu_torch``) and the
small modules they need (``config``, ``globalcontext``, ``vap``,
``engine/userinfo``, ``utils/jsonpatch``, ``cluster/{webhookconfig,
lifecycle}``) against the JAX package's, on the CPU (tolerance: exact).

- The reference tests' scenarios against the port: each ``test_*``
  function of tests/test_serve.py, test_webhooks.py,
  test_webhook_lifecycle.py, test_vap.py, test_vap_generate.py and
  test_userinfo_rbac.py runs from the same source with its imports
  pointed at ``kyverno_tpu_torch`` (the port's ``utils/tlsutil``'s
  ``CertRenewer`` against the port's server among them) and every
  ``build_handlers`` / ``ControlPlane`` given ``device="cpu"``. The
  reference's own run of them is in their own files.
- ``ControlPlane`` side by side: the same snapshot upserts, scans,
  reports, admission reviews and metric families.
- ``_init_distributed``: no environment, world size 1 (gloo), a world
  size that is no number (single-host). World size 2 is in
  tests/test_torch_xproc.py.
- ``apply --output-json`` over the PSS set and a seeded resource
  directory, ``--engine tpu`` and ``--engine scalar``: the port's output
  equals the reference's.
- ``python -m kyverno_tpu_torch serve --device cpu`` as a process:
  ready, one review answered, /metrics served, SIGTERM exits 0."""

import argparse
import ast
import copy
import functools
import http.client
import importlib
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import time
import types

import pytest
import yaml

from torch_parity_util import fresh_port_state  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)

# ---------------------------------------------------------------------------
# the reference tests' scenarios, run against the port

SCENARIO_MODULES = ("test_serve", "test_webhooks", "test_webhook_lifecycle",
                    "test_vap", "test_vap_generate", "test_userinfo_rbac")


def _on_cpu(fn):
    return functools.partial(fn, device="cpu")


def _port_source(src):
    """The reference test module's source with its imports pointed at the
    port and the device engines' constructors given device="cpu"."""
    src = re.sub(r"\bkyverno_tpu\.", "kyverno_tpu_torch.", src)
    for name in ("build_handlers", "ControlPlane"):
        src = re.sub(rf"(?<![\w.]){name}\(", f"_on_cpu({name})(", src)
    return src


@functools.lru_cache(maxsize=None)
def _scenario_module(name):
    path = os.path.join(TESTS, f"{name}.py")
    mod = types.ModuleType(f"port_{name}")
    mod.__file__ = path
    mod._on_cpu = _on_cpu
    exec(compile(_port_source(open(path).read()), path, "exec"), mod.__dict__)
    return mod


def _scenarios():
    out = []
    for name in SCENARIO_MODULES:
        tree = ast.parse(open(os.path.join(TESTS, f"{name}.py")).read())
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and \
                    node.name.startswith("test_"):
                args = [a.arg for a in node.args.args]
                out.append(pytest.param(name, node.name, args,
                                        id=f"{name}::{node.name}"))
    return out


_BUILTIN = {"tmp_path", "capsys", "monkeypatch"}


@pytest.fixture(scope="module")
def module_fixtures():
    """Module-scoped fixtures of the scenario modules, one instance per
    (module, name), torn down at the end of this module."""
    live = {}
    yield live
    for gen, _ in live.values():
        next(gen, None)


@pytest.mark.parametrize("module,name,args", _scenarios())
def test_reference_scenario(module, name, args, request, module_fixtures):
    mod = _scenario_module(module)
    if "cryptography" in str(getattr(getattr(mod, name), "pytestmark", "")):
        pytest.importorskip("cryptography")
    kw = {}
    for a in args:
        if a in _BUILTIN:
            kw[a] = request.getfixturevalue(a)
            continue
        key = (module, a)
        if key not in module_fixtures:
            gen = getattr(mod, a)._get_wrapped_function()()
            module_fixtures[key] = (gen, next(gen))
        kw[a] = module_fixtures[key][1]
    getattr(mod, name)(**kw)


# ---------------------------------------------------------------------------
# ControlPlane side by side

POLICY = {
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


def pod(name, priv, ns="default"):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "nginx",
                                     "securityContext": {"privileged": priv}}]}}


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


# the port's registry has two families more: its kernels' build, load,
# launch and capture failures, and whether its mesh across processes
# has failed (observability/metrics.py)
PORT_ONLY_FAMILIES = {"kyverno_tpu_kernel_errors_total",
                      "kyverno_tpu_mesh_failed"}


def _families(text):
    return sorted({ln.split()[2] for ln in text.decode().splitlines()
                   if ln.startswith("# TYPE")} - PORT_ONLY_FAMILIES)


def _control_plane_run(pkg, **kw):
    serve = importlib.import_module(f"{pkg}.cli.serve")
    policy = importlib.import_module(f"{pkg}.api.policy")
    if pkg == "kyverno_tpu_torch":
        kw["device"] = "cpu"
    cp = serve.ControlPlane(
        [policy.ClusterPolicy.from_dict(copy.deepcopy(d))
         for d in (POLICY, MUTATE)], port=0, metrics_port=0, **kw)
    cp.start(scan_interval=3600)
    try:
        mport = cp.metrics_server.server_address[1]
        rng = random.Random(5)
        out = []
        for i in range(12):
            res = pod(f"p{i}", rng.random() < 0.4,
                      rng.choice(("default", "prod")))
            code, body = _req(mport, "POST", "/snapshot/upsert", res)
            out.append((code, json.loads(body)))
        code, body = _req(mport, "POST", "/scan", {})
        out.append((code, json.loads(body)))
        code, body = _req(mport, "POST", "/scan", {"full": True})
        out.append((code, json.loads(body)))
        code, body = _req(mport, "GET", "/reports")
        reports = json.loads(body)
        for r in reports.values():
            r.pop("metadata", None)
            for row in r.get("results", []):
                row.pop("timestamp", None)
        out.append((code, reports))
        for i in range(6):
            rv = {"apiVersion": "admission.k8s.io/v1",
                  "kind": "AdmissionReview",
                  "request": {"uid": f"u{i}", "operation": "CREATE",
                              "namespace": "default",
                              "object": pod(f"a{i}", i % 2 == 0)}}
            for path in ("/validate", "/mutate"):
                code, body = _req(cp.admission.port, "POST", path, rv)
                out.append((path, code, json.loads(body)))
        code, body = _req(mport, "GET", "/metrics")
        out.append((code, _families(body)))
        code, body = _req(mport, "GET", "/readyz")
        out.append((code, sorted(json.loads(body))))
        code, body = _req(mport, "GET", "/debug/state")
        out.append((code, sorted(json.loads(body))))
        out.append(sorted((d.get("kind"), (d.get("metadata") or {})
                           .get("name")) for _, d, _ in cp.snapshot.items()
                          if d.get("kind", "").endswith(
                              "WebhookConfiguration")))
        return out
    finally:
        cp.stop()


@pytest.mark.parametrize("kw", [{}, {"batching": True,
                                     "mutate_batching": True}],
                         ids=["plain", "batching"])
def test_control_plane_round_trip_equals_reference(kw):
    want = _control_plane_run("kyverno_tpu", **kw)
    got = _control_plane_run("kyverno_tpu_torch", **kw)
    assert got == want


def test_control_plane_warms_the_smallest_bucket_on_the_worker():
    """With the compile-ahead worker running, a promoted version has run
    its smallest bucket twice (eager, then the capture on CUDA) before
    any flush; a warm that fails logs an op-log event and the version
    still serves."""
    from kyverno_tpu_torch.api.policy import ClusterPolicy
    from kyverno_tpu_torch.cli.serve import ControlPlane
    from kyverno_tpu_torch.tpu.engine import TorchEngine

    warmed = []
    orig = TorchEngine.warm_buckets

    def spy(self, buckets):
        warmed.append(list(buckets))
        return orig(self, buckets)

    TorchEngine.warm_buckets = spy
    try:
        cp = ControlPlane([ClusterPolicy.from_dict(POLICY)], device="cpu")
        cp.start(scan_interval=3600)
        try:
            deadline = time.time() + 60
            while cp.lifecycle.active is None and time.time() < deadline:
                time.sleep(0.05)
            cp.lifecycle.acquire()
            assert warmed == [[TorchEngine.MIN_BUCKET]]
        finally:
            cp.stop()
    finally:
        TorchEngine.warm_buckets = orig


# ---------------------------------------------------------------------------
# serve --distributed


class _OpLog:
    def __init__(self):
        self.events = []

    def emit(self, event, level="info", **fields):
        self.events.append((event, fields))

    def configure(self, **kw):
        pass


@pytest.fixture
def oplog(monkeypatch):
    from kyverno_tpu_torch.observability import log

    rec = _OpLog()
    monkeypatch.setattr(log, "global_oplog", rec)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    return rec


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_distributed_without_env_is_skipped(oplog):
    from kyverno_tpu_torch.cli.serve import _init_distributed

    assert _init_distributed("cpu") is None
    assert [e for e, _ in oplog.events] == ["distributed_init_skipped"]


def test_init_distributed_single_host_with_gloo(oplog, monkeypatch):
    import torch.distributed as dist

    from kyverno_tpu_torch.cli.serve import _init_distributed

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert not dist.is_initialized()
    try:
        assert _init_distributed("cpu") is None
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1
        assert oplog.events == [("distributed_single_host",
                                 {"backend": "gloo", "devices": 1})]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_init_distributed_with_a_bad_world_size_continues_single_host(
        oplog, monkeypatch):
    import torch.distributed as dist

    from kyverno_tpu_torch.cli.serve import _init_distributed

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "two")
    monkeypatch.setenv("RANK", "0")
    assert _init_distributed("cpu") is None
    assert [e for e, _ in oplog.events] == ["distributed_init_failed"]
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# apply --output-json


@pytest.fixture(scope="module")
def pss_dirs(tmp_path_factory):
    """The PSS policy directory and a seeded resource directory (Pods
    and Deployments across three namespaces, with their Namespace
    objects)."""
    sys.path.insert(0, TESTS)
    from test_tpu_pss_parity import _resource

    rng = random.Random(3)
    res_dir = tmp_path_factory.mktemp("resources")
    docs = [{"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": ns, "labels": {"team": ns}}}
            for ns in ("default", "prod", "dev")]
    for i in range(24):
        r = _resource(rng, i)
        r.setdefault("metadata", {})["namespace"] = rng.choice(
            ("default", "prod", "dev"))
        docs.append(r)
    for k in range(3):
        with open(res_dir / f"batch{k}.yaml", "w") as f:
            yaml.safe_dump_all(docs[k::3], f, sort_keys=False)
    return os.path.join(ROOT, "kyverno_tpu_torch", "policies", "pss"), \
        str(res_dir)


def _apply(pkg, engine, pss, res_dir, capsys):
    main = importlib.import_module(f"{pkg}.cli.__main__").main
    argv = ["apply", pss, "--resource", res_dir, "--engine", engine,
            "--output-json", "--audit-warn"]
    if pkg == "kyverno_tpu_torch" and engine == "tpu":
        argv += ["--device", "cpu"]
    capsys.readouterr()
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("engine", ["tpu", "scalar"])
def test_apply_output_json_equals_reference(engine, pss_dirs, capsys):
    want = _apply("kyverno_tpu", engine, *pss_dirs, capsys)
    got = _apply("kyverno_tpu_torch", engine, *pss_dirs, capsys)
    assert got == want
    assert got[1]["summary"]["pass"] and (got[1]["summary"]["fail"]
                                          or got[1]["summary"]["warn"])


def apply_verdicts(out):
    """What ``--engine tpu`` and ``--engine scalar`` agree on, in both
    packages: the exit code, the summary and which (policy, rule,
    resource) failed or warned. The messages differ by design: the
    device engine reports the rule's message, the scalar engine its
    full pattern message with paths."""
    rc, doc = out
    return rc, doc["summary"], {
        kind: sorted((e["policy"], e["rule"], e["resource"])
                     for e in doc[kind]) for kind in ("failures", "warnings")}


def test_apply_engines_agree(pss_dirs, capsys):
    got = [apply_verdicts(_apply("kyverno_tpu_torch", e, *pss_dirs, capsys))
           for e in ("tpu", "scalar")]
    assert got[0] == got[1]


def test_apply_xla_trace_writes_a_torch_profile(pss_dirs, tmp_path, capsys):
    from kyverno_tpu_torch.cli.apply import run
    from kyverno_tpu_torch.observability.profiling import \
        reset_xla_trace_latch

    pss, res_dir = pss_dirs
    reset_xla_trace_latch()
    args = argparse.Namespace(
        policies=[os.path.join(pss, sorted(os.listdir(pss))[0])],
        resource=[res_dir], engine="tpu", device="cpu", audit_warn=True,
        detailed_results=False, output_json=True, registry_fixture=None,
        xla_trace=str(tmp_path))
    try:
        run(args)
    finally:
        reset_xla_trace_latch()
    assert os.path.exists(tmp_path / f"trace-{os.getpid()}.json")


# ---------------------------------------------------------------------------
# python -m kyverno_tpu_torch serve, as a process


def test_serve_process_answers_and_stops_on_sigterm(tmp_path):
    pss = os.path.join(ROOT, "kyverno_tpu_torch", "policies", "pss")
    policy = os.path.join(pss, sorted(os.listdir(pss))[0])
    port, mport = _free_port(), _free_port()
    log = tmp_path / "oplog.jsonl"
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kyverno_tpu_torch", "serve", policy,
         "--device", "cpu", "--port", str(port), "--metrics-port",
         str(mport), "--scan-interval", "3600", "--batching",
         "--xla-cache-dir", str(tmp_path / "xla"), "--log-file", str(log)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        ready = None
        while time.time() < deadline:
            try:
                code, body = _req(mport, "GET", "/readyz")
                if code == 200:
                    ready = json.loads(body)
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.2)
        assert ready and ready["ready"]
        rv = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
              "request": {"uid": "u", "operation": "CREATE",
                          "namespace": "default",
                          "object": pod("p", True)}}
        code, body = _req(port, "POST", "/validate", rv)
        assert code == 200 and json.loads(body)["response"]["uid"] == "u"
        code, body = _req(mport, "GET", "/metrics")
        assert code == 200 and b"# TYPE" in body
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert rc == 0
    events = [json.loads(ln)["event"] for ln in log.read_text().splitlines()]
    assert events.count("xla_cache_unavailable") == 1
    assert "serve_started" in events
