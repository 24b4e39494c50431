"""The port's static lint (``kyverno_tpu_torch/devtools/lintcore.py``
and its five checks, ``cli/lint.py``), aimed at the port, against the
JAX package's lint on the CPU.

- The port is clean modulo its own baseline
  (``kyverno_tpu_torch/devtools/lint_baseline.json``): every entry has a
  reason and suppresses a finding, and the default baseline is that file,
  never the JAX package's root ``lint_baseline.json``.
- The port's findings are the reference's findings on the reference,
  file for file, plus the port's own dispatch modules (``kernels.py``,
  ``tpu/graphs.py``), which the port lists as hot.
- ``tests/lint_fixtures/badpkg`` trips all five check classes, at the
  same lines in both packages.
- A tree whose ``encode/worker.py`` reaches ``import torch`` gives a
  finding that names the import chain (the port's workers load neither
  torch nor JAX); the reference's lint does not forbid torch.
- Baselines match by content, and the CLI's exit codes.
- The reference's own lint tests (tests/test_lint.py) that do not read
  the JAX package's baseline run against the port."""

import json
import os
import subprocess
import sys

import pytest

from kyverno_tpu.devtools import lintcore as ref_lint
from kyverno_tpu_torch.devtools import check_imports, lintcore
from torch_parity_util import fresh_port_state  # noqa: F401 - autouse
from torch_parity_util import (port_test_module, run_port_scenario,
                               scenario_params)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "lint_fixtures", "badpkg")
PORT_BASELINE = os.path.join(REPO, "kyverno_tpu_torch", "devtools",
                             "lint_baseline.json")


@pytest.fixture(scope="module", autouse=True)
def parsed_once():
    """The port's tree is parsed once for this module: each lint of it
    here reuses the first ``build_context`` of its root (a fixture tree's
    too). The checks still run on every call."""
    real = lintcore.build_context
    cache = {}

    def build_context(root=None, hot_modules=lintcore.HOT_MODULES):
        k = (root, hot_modules)
        if k not in cache:
            cache[k] = real(root, hot_modules)
        return cache[k]

    mp = pytest.MonkeyPatch()
    mp.setattr(lintcore, "build_context", build_context)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def port_findings():
    return lintcore.run_lint(baseline=lintcore.load_baseline(None))


@pytest.fixture(scope="module")
def ref_findings():
    return ref_lint.run_lint()


def key(f):
    # the copies are one header line longer than their sources
    return (f.check, f.file, f.message)


def test_the_default_baseline_is_the_ports_own(tmp_path, monkeypatch):
    assert os.path.samefile(lintcore.default_baseline_path(), PORT_BASELINE)
    assert lintcore.load_baseline(None) == json.load(open(PORT_BASELINE))
    # neither a lint_baseline.json in the working directory nor the JAX
    # package's one at the repo root is read
    (tmp_path / "lint_baseline.json").write_text(json.dumps(
        [{"check": "guarded-by", "file": "x.py", "reason": "cwd"}]))
    monkeypatch.chdir(tmp_path)
    assert lintcore.load_baseline(None) == json.load(open(PORT_BASELINE))
    monkeypatch.chdir(REPO)
    assert lintcore.load_baseline(None) != json.load(
        open(os.path.join(REPO, "lint_baseline.json")))


def test_port_clean_modulo_its_baseline(port_findings):
    baseline = lintcore.load_baseline(None)
    live = [f for f in port_findings if not f.baselined]
    assert live == [], "\n".join(f.render() for f in live)
    used = {f.baseline_reason for f in port_findings if f.baselined}
    for entry in baseline:
        assert entry["reason"].strip()
        assert entry["reason"] in used, f"dead baseline entry: {entry}"
    assert lintcore.build_context().root == os.path.join(REPO,
                                                         "kyverno_tpu_torch")


def test_port_findings_are_the_references_plus_its_dispatch(port_findings,
                                                            ref_findings):
    port = sorted(key(f) for f in port_findings)
    ref = sorted(key(f) for f in ref_findings)
    # the copies' findings are the reference's; the port adds its
    # kernel build's
    extra = [k for k in port if k[1] == "kernels.py"]
    assert [k for k in port if k[1] != "kernels.py"] == ref
    assert {c for c, _, _ in extra} == {"blocking-under-lock"}
    # the reference's baseline reasons carry over to the same findings
    ref_base = {(e["check"], e["file"], e["match"]): e["reason"]
                for e in json.load(open(os.path.join(REPO,
                                                     "lint_baseline.json")))}
    port_base = {(e["check"], e["file"], e["match"]): e["reason"]
                 for e in lintcore.load_baseline(None)}
    for k, reason in ref_base.items():
        assert port_base[k] == reason


def test_hot_modules_cover_the_ports_dispatch():
    assert lintcore.HOT_MODULES == ref_lint.HOT_MODULES | {
        "kernels.py", "tpu/graphs.py"}
    ctx = lintcore.build_context()
    rels = {f.rel for f in ctx.files}
    for h in lintcore.HOT_MODULES:
        assert h in rels, h


def test_invariants_are_the_ports():
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.resilience.faults import KNOWN_SITES

    _, known, families = lintcore.load_engine_invariants()
    assert known == KNOWN_SITES
    for name in global_registry._instruments:
        if name.startswith("kyverno"):
            assert name in families, name
    assert "kyverno_tpu_kernel_errors_total" in families


def test_fixture_trips_every_class_as_the_reference_does():
    port = lintcore.run_lint(root=FIXTURES)
    ref = ref_lint.run_lint(root=FIXTURES)
    assert {f.check for f in port} == set(lintcore.CHECK_CLASSES)
    assert [(f.check, f.file, f.line) for f in port] == \
        [(f.check, f.file, f.line) for f in ref]
    for p, r in zip(port, ref):
        if p.check != "jax-import":
            assert p.message == r.message
        else:
            assert "'jax' import reachable" in p.message
            assert "encode/worker.py" in p.message


def worker_tree(root, runtime):
    (root / "encode").mkdir()
    (root / "encode" / "__init__.py").write_text("")
    (root / "encode" / "worker.py").write_text(
        "def main():\n    from .. import feed\n")
    (root / "__init__.py").write_text("")
    (root / "feed.py").write_text("from .util import lanes\n")
    (root / "util").mkdir()
    (root / "util" / "__init__.py").write_text("")
    (root / "util" / "lanes.py").write_text(
        f"import numpy\nimport {runtime}.cuda\n")


@pytest.mark.parametrize("runtime", ["torch", "jax", "jaxlib"])
def test_worker_closure_reaching_a_device_runtime(runtime, tmp_path):
    worker_tree(tmp_path, runtime)
    (f,) = lintcore.run_lint(root=str(tmp_path), checks=["jax-import"])
    assert (f.file, f.line) == ("util/lanes.py", 2)
    assert f"'{runtime}.cuda' import reachable" in f.message
    assert "encode/worker.py -> feed.py -> util/lanes.py" in f.message
    assert "free of torch and JAX" in f.message
    # the reference forbids JAX only
    ref = ref_lint.run_lint(root=str(tmp_path), checks=["jax-import"])
    assert len(ref) == (0 if runtime == "torch" else 1)


def test_a_lazy_torch_import_outside_the_worker_is_not_reached(tmp_path):
    worker_tree(tmp_path, "torch")
    (tmp_path / "util" / "lanes.py").write_text(
        "import numpy\n\ndef put():\n    import torch\n")
    assert lintcore.run_lint(root=str(tmp_path), checks=["jax-import"]) == []


def test_port_worker_closure_is_nontrivial():
    ctx = lintcore.build_context()
    by_name = {check_imports._module_name(f.rel): f for f in ctx.files}
    seen, queue = set(), [check_imports._module_name(
        check_imports.ROOT_MODULE)]
    while queue:
        name = queue.pop()
        if name in seen or name not in by_name:
            continue
        seen.add(name)
        sf = by_name[name]
        for node in check_imports._iter_imports(
                sf.tree, sf.rel == check_imports.ROOT_MODULE):
            for target, _ in check_imports._resolve(name, sf.rel, node,
                                                    by_name):
                if target in by_name:
                    queue.append(target)
    assert "tpu.flatten" in seen and "encode.tasks" in seen
    for device_module in ("tpu.engine", "kernels", "tpu.graphs"):
        assert device_module not in seen
    assert len(seen) > 10
    assert "torch" in check_imports.FORBIDDEN


def test_blocking_under_lock_sees_a_host_wait_on_the_card(tmp_path):
    (tmp_path / "m.py").write_text(
        "import threading\n"
        "import torch\n"
        "_lock = threading.Lock()\n"
        "def f(ev):\n"
        "    with _lock:\n"
        "        torch.cuda.synchronize()\n"
        "        ev.synchronize()\n"
        "    ev.synchronize()\n")
    fs = lintcore.run_lint(root=str(tmp_path),
                           checks=["blocking-under-lock"])
    assert [(f.line, f.message.split("(")[0]) for f in fs] == [
        (6, "blocking call torch.cuda.synchronize"),
        (7, "blocking call ev.synchronize")]


def test_baseline_matching_is_by_content_not_line():
    f = lintcore.Finding(check="blocking-under-lock", file="kernels.py",
                         line=9999, message="blocking call os.replace() "
                                            "while holding _lock")
    lintcore.apply_baseline([f], lintcore.load_baseline(None))
    assert f.baselined and "one-time build" in f.baseline_reason


def lint_cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "kyverno_tpu_torch", "lint", *argv],
        capture_output=True, text=True, cwd=REPO, timeout=120)


def test_cli_lint_json_clean_on_the_port_from_the_repo_root():
    proc = lint_cli("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["findings"] == [] and doc["exit"] == 0
    assert doc["baselined"] and all(f["baseline_reason"]
                                     for f in doc["baselined"])
    assert set(doc["checks_run"]) == set(lintcore.CHECK_CLASSES)


def test_cli_lint_exit_codes(capsys):
    from kyverno_tpu_torch.cli.__main__ import main

    # 0 with the port's baseline, by default and named
    assert main(["lint", "--json"]) == 0
    assert main(["lint", "--json", "--baseline", PORT_BASELINE,
                 "--checks", "blocking-under-lock,fault-site"]) == 0
    capsys.readouterr()
    # 1: the JAX package's baseline does not cover the port's kernel build
    assert main(["lint", "--json", "--checks", "blocking-under-lock",
                 "--baseline", os.path.join(REPO, "lint_baseline.json")]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert {f["file"] for f in doc["findings"]} == {"kernels.py"}
    # 1 with no baseline; 0 when the classes run have no finding
    assert main(["lint", "--json", "--no-baseline",
                 "--checks", "guarded-by"]) == 1
    assert main(["lint", "--json", "--no-baseline", "--checks",
                 "fault-site,jax-import,metric-family"]) == 0
    # 1: the seeded-violation tree
    assert main(["lint", "--json", "--no-baseline", FIXTURES]) == 1
    capsys.readouterr()
    # 2: usage errors
    assert main(["lint", "--fail-on", "bogus-class"]) == 2
    assert main(["lint", os.path.join(REPO, "does-not-exist")]) == 2
    assert main(["lint", "--baseline", os.path.join(REPO, "nope.json")]) == 2
    capsys.readouterr()


# the reference's own lint tests, run against the port; those that read
# the JAX package's baseline or its package have port versions above
REF_SKIP = ("test_package_clean_modulo_baseline",
            "test_package_worker_closure_is_nontrivial",
            "test_cli_lint_json_clean_on_package")


@pytest.mark.parametrize("module,name,params",
                         scenario_params("test_lint", skip=REF_SKIP))
def test_reference_scenario(module, name, params, request):
    run_port_scenario(port_test_module(module), name, params, request)
