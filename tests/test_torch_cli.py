"""The rest of the port's command line (``kyverno_tpu_torch/cli/``:
``analyze``, ``jp``, ``test``, ``report``, ``json scan``, ``fix``,
``create``, ``docs``, ``oci``, ``top``, ``chainsaw``, and
``utils/tlsutil.py``) against the JAX package's, on the CPU. Outputs
and exit codes are compared whole: these are host semantics, no
tolerance applies.

- ``analyze --json --device cpu`` on tests/test_cli.py's redundant pair
  and on the seeded-anomaly corpus, with every ``--fail-on`` exit code;
  without a card and without ``--device cpu`` the command exits 2.
- ``jp``, ``test`` on tests/cli-tests, ``report`` on a journal directory
  that the port wrote, ``json scan``, ``fix``, ``create``, ``docs``,
  ``oci`` across the two packages, ``top`` over a stubbed debug surface
  and ``flight-dump``'s GET through ``cli/tools``.
- ``chainsaw``: ``run_tree`` over the scenario tree that chip_smoke.py's
  phase 16 writes gives the reference's rows, every one a pass; a
  broken expectation fails in both.
- ``--help`` lists every command of the reference.
- The reference's own test functions (tests/test_cli.py,
  tests/test_cli_tools.py) run against the port, ``apply`` and
  ``analyze`` given ``--device cpu``."""

import copy
import datetime as dt
import io
import json
import os
import random
import sys

import pytest
import yaml

from kyverno_tpu.cli import __main__ as ref_cli
from kyverno_tpu_torch.cli import __main__ as port_cli
from test_cli import REDUNDANT_PAIR
from torch_parity_util import (fresh_port_state,  # noqa: F401
                               port_test_module, run_port_scenario,
                               scenario_params)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (phase 16's chainsaw tree and report view)


def run(main, argv, capsys, stdin=None):
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        rc = main(list(argv))
    except SystemExit as e:
        rc = e.code
    finally:
        sys.stdin = sys.__stdin__
    out = capsys.readouterr()
    return rc, out.out, out.err


def both(argv, capsys, port_extra=(), stdin=None):
    ref = run(ref_cli.main, argv, capsys, stdin)
    port = run(port_cli.main, list(argv) + list(port_extra), capsys, stdin)
    return ref, port


def commands(cli):
    import argparse

    parser = cli.build_parser()
    subs = next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction))
    return set(subs.choices)


def test_help_lists_every_reference_command(capsys):
    assert commands(port_cli) == commands(ref_cli)
    rc, out, _ = run(port_cli.main, ["--help"], capsys)
    assert rc == 0
    for name in sorted(commands(ref_cli)):
        assert name in out


# ---------------------------------------------------------------- analyze

analysis_doc = chip_smoke.analysis_json


@pytest.fixture
def redundant_pair(tmp_path):
    f = tmp_path / "twins.yaml"
    f.write_text(REDUNDANT_PAIR)
    return str(f)


@pytest.mark.parametrize("fail_on", [None, "redundant", "shadow,conflict",
                                     "any"])
def test_analyze_json_equals_reference(redundant_pair, fail_on, capsys):
    argv = ["analyze", redundant_pair, "--json"]
    if fail_on:
        argv += ["--fail-on", fail_on]
    (rrc, rout, _), (prc, pout, _) = both(argv, capsys,
                                          port_extra=["--device", "cpu"])
    assert prc == rrc
    assert analysis_doc(pout) == analysis_doc(rout)
    assert rrc == (1 if fail_on in ("redundant", "any") else 0)


@pytest.mark.parametrize("tile", [7, 256])
def test_analyze_seeded_anomalies_equal_reference(tile, capsys):
    path = os.path.join(TESTS, "golden", "analysis", "seeded_anomalies.yaml")
    argv = ["analyze", path, "--json", "--tile", str(tile), "--fail-on",
            "any"]
    (rrc, rout, _), (prc, pout, _) = both(argv, capsys,
                                          port_extra=["--device", "cpu"])
    assert (prc, analysis_doc(pout)) == (rrc, analysis_doc(rout))
    counts = analysis_doc(pout)["counts"]
    assert rrc == 1 and all(counts[k] >= 1 for k in counts)
    # the table form too
    (rrc, rout, rerr), (prc, pout, perr) = both(
        ["analyze", path, "--tile", str(tile)], capsys,
        port_extra=["--device", "cpu"])
    assert (prc, perr) == (rrc, rerr)
    strip = [ln for ln in rout.splitlines() if " s" not in ln]
    assert [ln for ln in pout.splitlines() if " s" not in ln] == strip


def test_analyze_without_a_card_exits_2(redundant_pair, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(port_cli.main, ["analyze", redundant_pair, "--json"],
                       capsys)
    assert rc == 2 and out == ""
    assert "CUDA" in err and "device='cpu'" in err


def test_analyze_usage_errors_equal_reference(tmp_path, capsys):
    empty = tmp_path / "empty.yaml"
    empty.write_text("apiVersion: v1\nkind: Pod\nmetadata: {name: x}\n")
    for argv in (["analyze", str(empty)],
                 ["analyze", str(empty), "--fail-on", "bogus"]):
        ref, port = both(argv, capsys, port_extra=["--device", "cpu"])
        assert port == ref


# -------------------------------------------------------------------- jp

JP_CASES = [
    (["jp", "query", "sum(a)"], '{"a": [1, 2, 3]}'),
    (["jp", "query", "items[?v > `1`].k | sort(@)"],
     '{"items": [{"k": "b", "v": 2}, {"k": "a", "v": 3}, {"k": "c", "v": 1}]}'),
    (["jp", "query", "to_upper(name)"], "name: kyverno\n"),
    (["jp", "query", "divide(`1`, `0`)"], "{}"),
    (["jp", "function"], None),
    (["jp", "function", "time"], None),
    (["jp", "parse", "a.b[0] | length(@) || `3`"], None),
    (["jp", "parse", "a[?"], None),
]


@pytest.mark.parametrize("case", range(len(JP_CASES)))
def test_jp_equals_reference(case, capsys):
    argv, stdin = JP_CASES[case]
    ref, port = both(argv, capsys, stdin=stdin)
    assert port == ref
    if case < 3:
        assert ref[0] == 0 and ref[1].strip()


# ------------------------------------------------------------------ test


def test_test_command_on_the_cli_tests_equals_reference(capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    for argv in (["test", "tests/cli-tests"],
                 ["test", "tests/cli-tests/pss-baseline", "--fail-only"]):
        ref, port = both(argv, capsys)
        assert port == ref
        assert ref[0] == 0 and ref[1]


def test_test_command_failing_case_equals_reference(tmp_path, capsys):
    pss = os.path.join(ROOT, "kyverno_tpu_torch", "policies", "pss")
    res = [chip_smoke._pod("priv", privileged=True),
           chip_smoke._pod("plain")]
    (tmp_path / "resources.yaml").write_text(yaml.safe_dump_all(res))
    (tmp_path / "kyverno-test.yaml").write_text(yaml.safe_dump({
        "apiVersion": "cli.kyverno.io/v1alpha1", "kind": "Test",
        "metadata": {"name": "wrong-expectations"},
        "policies": [os.path.join(pss, "disallow-privileged-containers.yaml")],
        "resources": ["resources.yaml"],
        "results": [
            {"policy": "disallow-privileged-containers",
             "rule": "privileged-containers", "kind": "Pod",
             "resources": ["priv"], "result": "pass"},
            {"policy": "disallow-privileged-containers",
             "rule": "privileged-containers", "kind": "Pod",
             "resources": ["plain"], "result": "pass"},
        ]}))
    ref, port = both(["test", str(tmp_path)], capsys)
    assert port == ref and ref[0] != 0


# ---------------------------------------------------------------- report


def port_journal(d, seed=3, n=40):
    from kyverno_tpu_torch.reports import ReportStore

    rng = random.Random(seed)
    store = ReportStore(directory=d)
    for i in range(n):
        ns = rng.choice(("prod", "dev", ""))
        rows = [(p, r, rng.choice(("pass", "fail", "skip", "error")))
                for p, r in (("no-privileged", "privileged"),
                             ("require-labels", "team"))
                if rng.random() < 0.8]
        store.apply(f"u{i % 30}", f"h{i}", "ps", ns,
                    rng.choice(("Pod", "Deployment")), f"r{i % 30}", rows)
    for i in range(0, 30, 7):
        store.delete(f"u{i}")
    store.close(compact=False)  # the journal carries every fold


@pytest.mark.parametrize("flags", [[], ["--json"], ["--summary"],
                                   ["--rebuild-check"],
                                   ["--rebuild-check", "--json"]])
def test_report_on_a_port_journal_equals_reference(flags, tmp_path, capsys):
    d = str(tmp_path / "reports")
    port_journal(d)
    ref, port = both(["report", d] + flags, capsys)
    assert port == ref
    assert ref[0] == 0


def test_report_bad_dir_equals_reference(tmp_path, capsys):
    ref, port = both(["report", str(tmp_path / "nope")], capsys)
    assert port == ref and ref[0] == 2


# ----------------------------------------------------- json / fix / create

JSON_POLICY = {
    "apiVersion": "json.kyverno.io/v1alpha1", "kind": "ValidatingPolicy",
    "metadata": {"name": "db-policy"},
    "spec": {"rules": [
        {"name": "no-public",
         "assert": {"all": [{"check": {
             "~.(instances)": {"publiclyAccessible": False}}}]}},
        {"name": "min-storage",
         "assert": {"all": [{"check": {
             "~.(instances)": {"storage": ">=10"}},
             "message": "too small"}]}},
    ]},
}


@pytest.mark.parametrize("extra", [[], ["--output", "json"],
                                   ["--pre-process", "fleet",
                                    "--output", "json"]])
def test_json_scan_equals_reference(extra, tmp_path, capsys):
    rng = random.Random(6)
    inst = [{"name": f"db-{i}", "publiclyAccessible": rng.random() < 0.3,
             "storage": rng.choice((5, 10, 20))} for i in range(6)]
    payload = {"instances": inst}
    if "--pre-process" in extra:
        payload = {"fleet": [{"instances": inst[:3]},
                             {"instances": inst[3:]}]}
    (tmp_path / "payload.json").write_text(json.dumps(payload))
    (tmp_path / "policy.yaml").write_text(yaml.safe_dump(JSON_POLICY))
    argv = ["json", "scan", "--payload", str(tmp_path / "payload.json"),
            "--policy", str(tmp_path / "policy.yaml")] + extra
    ref, port = both(argv, capsys)
    assert port == ref
    assert ref[0] == 1  # the seed fails some instance


LEGACY_TEST = {
    "name": "legacy-test",
    "policies": ["p.yaml"], "resources": ["r.yaml"],
    "results": [
        {"policy": "pol", "rule": "r", "resource": "a", "status": "pass"},
        {"policy": "pol", "rule": "r", "resource": "b", "status": "pass",
         "namespace": "ns1"},
        {"policy": "pol", "rule": "r", "resources": ["c"], "result": "pass"},
        {"policy": "pol", "rule": "q", "resource": "a", "status": "fail"},
    ],
}


@pytest.mark.parametrize("flags", [[], ["--save"], ["--save", "--compress"]])
def test_fix_test_equals_reference(flags, tmp_path, capsys):
    outs = {}
    for name, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        d = tmp_path / name
        d.mkdir()
        (d / "kyverno-test.yaml").write_text(yaml.safe_dump(LEGACY_TEST))
        rc, out, err = run(main, ["fix", "test", str(d)] + flags, capsys)
        outs[name] = (rc, out.replace(str(d), "D"), err.replace(str(d), "D"),
                      (d / "kyverno-test.yaml").read_text())
    assert outs["port"] == outs["ref"]
    assert outs["ref"][0] == 0


def test_create_equals_reference(tmp_path, capsys):
    from kyverno_tpu.cli.tools import _CREATE_TEMPLATES

    for kind in sorted(_CREATE_TEMPLATES):
        ref, port = both(["create", kind], capsys)
        assert port == ref and ref[0] == 0 and yaml.safe_load(ref[1])


def test_docs_covers_the_same_commands(capsys):
    ref, port = both(["docs"], capsys)
    assert port[0] == ref[0] == 0

    def sections(text):
        out, name = {}, None
        for line in text.splitlines():
            if line.startswith("## "):
                name = line.split()[-1]
                out[name] = []
            elif name:
                out[name].append(line)
        return out

    rs, ps = sections(ref[1]), sections(port[1])
    assert list(ps) == list(rs)
    # the help that names the device or the package differs; every
    # other command's documentation is the reference's
    differ = {n for n in rs if rs[n] != ps[n]}
    assert differ == {"analyze", "apply", "lint", "serve"}


def test_oci_round_trip_across_packages(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    for i in range(3):
        pol = chip_smoke._cpol(f"oci-pol-{i}", [{
            "name": "r", "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
            "validate": {"message": "m",
                         "pattern": {"metadata": {"name": "?*"}}}}])
        (src / f"p{i}.yaml").write_text(yaml.safe_dump(pol))
    layouts = {}
    for name, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        layout = tmp_path / f"layout-{name}"
        layout.mkdir()
        rc, out, _ = run(main, ["oci", "push", "-i", str(layout), "-p",
                                str(src), "-t", "v1"], capsys)
        assert rc == 0 and "pushed 3" in out
        layouts[name] = {os.path.relpath(os.path.join(dp, f), layout):
                         open(os.path.join(dp, f), "rb").read()
                         for dp, _, fs in os.walk(layout) for f in fs}
    assert layouts["port"] == layouts["ref"]
    # what one package pushed, the other pulls
    for pusher, puller in (("ref", port_cli.main), ("port", ref_cli.main)):
        dest = tmp_path / f"pulled-by-other-of-{pusher}"
        rc, _, _ = run(puller, ["oci", "pull", "-i",
                                str(tmp_path / f"layout-{pusher}"), "-t", "v1",
                                "-o", str(dest)], capsys)
        assert rc == 0
        assert sorted(os.listdir(dest)) == [f"oci-pol-{i}.yaml"
                                            for i in range(3)]
    ref, port = both(["oci", "pull", "-i", str(tmp_path / "layout-ref"),
                      "-t", "nope", "-o", str(tmp_path / "x")], capsys)
    assert port == ref and ref[0] == 2


# ------------------------------------------------------------- top / flight

DEBUG_DOCS = {
    "/debug/rules?top=5": {"rules": [
        {"policy": "p", "rule": "r", "fail": 3, "pass": 9, "skip": 1,
         "device_coverage": 1.0, "last_fired_s": 1.5}],
        "never_fired": [{"policy": "q", "rule": "s", "age_s": 60.0}]},
    "/debug/utilization": {
        "feed_starvation": {"ratio": 0.25},
        "pipeline": {"overlap_ratio": 0.75},
        "slo": {"admission": {"windows": {"5m": {"p99_ms": 12.5,
                                                 "burn": 0.5}}},
                "scan_freshness": {"age_s": 3.0},
                "device_coverage": {"ratio": 0.97}}},
    "/readyz": {"ready": True, "policyset": {"active_revision": 4}},
    "/debug/fleet": {"enabled": True, "replica_id": "r0", "epoch": 2,
                     "members": {"r0": {"alive": True, "shards": 32},
                                 "r1": {"alive": False, "shards": 32}}},
}


@pytest.mark.parametrize("fleet", [False, True])
def test_top_renders_like_reference(fleet, capsys, monkeypatch):
    from kyverno_tpu.cli import tools as ref_tools
    from kyverno_tpu_torch.cli import tools as port_tools

    def fake(host, port, path, timeout=10.0):
        return copy.deepcopy(DEBUG_DOCS[path])

    for mod in (ref_tools, port_tools):
        monkeypatch.setattr(mod, "_http_get_json", fake)
    argv = ["top", "--iterations", "1", "--no-clear", "--top", "5"]
    ref, port = both(argv + (["--fleet"] if fleet else []), capsys)
    assert port == ref and ref[0] == 0 and ref[1]


def test_flight_dump_gets_through_tools(monkeypatch):
    from kyverno_tpu_torch.cli import flight, tools

    calls = []

    def fake(host, port, path, timeout=10.0):
        calls.append((host, port, path, timeout))
        return {"records": []}

    monkeypatch.setattr(tools, "_http_get_json", fake)
    assert flight._fetch_flight("h", 9, 7) == {"records": []}
    assert calls == [("h", 9, "/debug/flight?last=7", 30.0)]


# ------------------------------------------------------------- chainsaw


def test_chainsaw_tree_equals_reference(tmp_path, capsys):
    from kyverno_tpu.cli.chainsaw import run_tree as ref_run_tree
    from kyverno_tpu_torch.cli.chainsaw import run_tree as port_run_tree

    scenarios = chip_smoke.write_chainsaw_tree(str(tmp_path))
    rows = port_run_tree(str(tmp_path))
    assert rows == ref_run_tree(str(tmp_path))
    assert rows == [(s, "pass", "") for s in scenarios]
    ref, port = both(["chainsaw", str(tmp_path)], capsys)
    assert port == ref and ref[0] == 0
    assert [ln.split()[0] for ln in ref[1].splitlines()] == \
        ["PASS"] * len(scenarios)


@pytest.mark.parametrize("broken", ["netpol.yaml", "bad-pod.yaml",
                                    "secret-assert.yaml", "kept.yaml"])
def test_chainsaw_broken_expectation_fails_in_both(broken, tmp_path):
    """The phase-16 scenarios are not vacuous: one wrong expectation
    fails its scenario in both packages, with the same detail."""
    from kyverno_tpu.cli.chainsaw import run_tree as ref_run_tree
    from kyverno_tpu_torch.cli.chainsaw import run_tree as port_run_tree

    chip_smoke.write_chainsaw_tree(str(tmp_path))
    for dirpath, _, files in os.walk(tmp_path):
        if broken in files:
            path = os.path.join(dirpath, broken)
            docs = list(yaml.safe_load_all(open(path)))
            if broken == "bad-pod.yaml":  # now admitted: the denial expected
                docs[0]["spec"]["containers"][0]["securityContext"] = {
                    "privileged": False}
            else:
                docs[0]["metadata"].setdefault("labels", {})["x"] = "y"
            with open(path, "w") as f:
                yaml.safe_dump_all(docs, f)
    rows = port_run_tree(str(tmp_path))
    assert rows == ref_run_tree(str(tmp_path))
    assert sum(st == "fail" for _, st, _ in rows) == 1


# ------------------------------------------------------------- tlsutil


def test_cert_renewer_issues_like_reference(tmp_path):
    x509 = pytest.importorskip("cryptography.x509")
    from kyverno_tpu.utils import tlsutil as ref_tls
    from kyverno_tpu_torch.utils import tlsutil as port_tls

    now = [dt.datetime(2026, 7, 29, tzinfo=dt.timezone.utc)]
    shapes = {}
    for name, mod in (("ref", ref_tls), ("port", port_tls)):
        reloads = []
        r = mod.CertRenewer(str(tmp_path / name), ["svc.ns.svc", "10.0.0.1"],
                            on_reload=lambda *a: reloads.append(a),
                            clock=lambda: now[0])
        ticks = []
        for days in (0, 1, 300, 360, 3000):
            now[0] = dt.datetime(2026, 7, 29, tzinfo=dt.timezone.utc) + \
                dt.timedelta(days=days)
            ticks.append(r.renew_if_needed())
        cert = x509.load_pem_x509_certificate(open(r.certfile, "rb").read())
        san = cert.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value
        shapes[name] = (ticks, r.renewals, len(reloads),
                        sorted(str(v) for v in san.get_values_for_type(
                            x509.DNSName)),
                        sorted(str(v) for v in san.get_values_for_type(
                            x509.IPAddress)),
                        cert.subject.rfc4514_string(),
                        cert.issuer.rfc4514_string(),
                        (cert.not_valid_after_utc
                         - cert.not_valid_before_utc).days,
                        sorted(os.listdir(tmp_path / name)))
    assert shapes["port"] == shapes["ref"]


# the reference's own test functions, run against the port (the lint
# exit codes test reads the JAX package's baseline: the port's lint has
# its own, tests/test_torch_lint.py)

CLI_REWRITES = (
    (r"from kyverno_tpu_torch\.cli\.__main__ import main",
     "from torch_parity_util import port_cli_main as main"),
    (r'"-m", "kyverno_tpu",', '"-m", "kyverno_tpu_torch",'),
)


@pytest.mark.parametrize(
    "module,name,params",
    scenario_params("test_cli", skip=("test_lint_exit_codes",))
    + scenario_params("test_cli_tools"))
def test_reference_scenario(module, name, params, request):
    run_port_scenario(port_test_module(module, CLI_REWRITES), name, params,
                      request)
