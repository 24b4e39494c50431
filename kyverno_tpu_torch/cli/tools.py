# Copied verbatim from kyverno_tpu/cli/tools.py.
"""Remaining reference CLI surface: json scan, fix, create, docs, oci.

- ``json scan``: cmd/cli/kubectl-kyverno/commands/json/scan — evaluate
  ValidatingPolicy (json.kyverno.io/v1alpha1) assertion trees against
  arbitrary JSON/YAML payloads (engine/jsonassert.py), with
  ``--pre-process`` JMESPath payload transforms and text/json output.
- ``fix test``: cmd/cli/kubectl-kyverno/fix/test.go FixTest — upgrade
  deprecated kyverno-test.yaml schemas in place (name ->
  metadata.name, result.resource -> resources, status -> result,
  namespace folded into the policy name, dedup, optional --compress).
- ``create``: commands/create — scaffold test / values / exception /
  user-info / metrics-config documents.
- ``docs``: commands/docs — render the CLI's command tree as markdown.
- ``oci push|pull``: commands/oci — pack policies into / unpack from a
  local OCI image-layout directory with the kyverno media types
  (internal/annotations.go: config v1+json, policy layer v1+yaml).
  Zero-egress: the layout directory stands in for a remote registry.
- ``top``: TPU-native extra — a live terminal view of the policy
  observatory (hot/never-fired rules, feed starvation, SLO burn) polled
  from a running serve's metrics-port debug surface.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Any, Dict, List, Tuple

import yaml

POLICY_CONFIG_MEDIA_TYPE = "application/vnd.cncf.kyverno.config.v1+json"
POLICY_LAYER_MEDIA_TYPE = "application/vnd.cncf.kyverno.policy.layer.v1+yaml"


def _load_docs_from(paths: List[str]) -> List[Dict[str, Any]]:
    # shared loader: same dir-walk, stdin and YAMLError handling as
    # `apply` (a malformed file exits cleanly, not with a traceback)
    from .apply import _load_docs

    return _load_docs(paths)


# ---------------------------------------------------------------------------
# json scan


def run_json_scan(args: argparse.Namespace) -> int:
    from ..engine.jmespath import compile as jp_compile
    from ..engine.jsonassert import scan_payload

    with open(args.payload) as f:
        payload = yaml.safe_load(f)
    for pre in args.pre_process or []:
        payload = jp_compile(pre).search(payload)
    payloads = payload if isinstance(payload, list) else [payload]
    policies = [d for d in _load_docs_from(args.policy)
                if d.get("kind") == "ValidatingPolicy"]
    if not policies:
        print("no ValidatingPolicy documents found", file=sys.stderr)
        return 2
    results = scan_payload(payloads, policies)
    failed = [r for r in results if r.status == "fail"]
    if args.output == "json":
        print(json.dumps([r.to_dict() for r in results], indent=2))
    else:
        for r in results:
            line = f"- {r.policy}/{r.rule} payload[{r.index}]: {r.status.upper()}"
            print(line)
            for f in r.failures:
                print(f"    {f}")
        print(f"\n{len(results) - len(failed)} passed, {len(failed)} failed")
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# fix test (fix/test.go FixTest)


def fix_test_doc(doc: Dict[str, Any], compress: bool = False) -> Tuple[Dict[str, Any], List[str]]:
    messages: List[str] = []
    out = dict(doc)
    if not out.get("apiVersion"):
        messages.append("api version is not set, setting `cli.kyverno.io/v1alpha1`")
        out["apiVersion"] = "cli.kyverno.io/v1alpha1"
    if not out.get("kind"):
        messages.append("kind is not set, setting `Test`")
        out["kind"] = "Test"
    if out.get("name"):
        messages.append("name is deprecated, moving it into `metadata.name`")
        out.setdefault("metadata", {})["name"] = out.pop("name")
    if not out.get("policies"):
        messages.append("test has no policies")
    if not out.get("resources"):
        messages.append("test has no resources")
    results = []
    for result in out.get("results") or []:
        r = dict(result)
        if r.get("resource") and r.get("resources"):
            messages.append("test result should not use both `resource` and `resources` fields")
        if r.get("resource"):
            messages.append("test result uses deprecated `resource` field, moving it into the `resources` field")
            r["resources"] = list(r.get("resources") or []) + [r.pop("resource")]
        resources = r.get("resources") or []
        if len(set(resources)) != len(resources):
            messages.append("test results contains duplicate resources")
            r["resources"] = sorted(set(resources))
        if r.get("namespace"):
            messages.append("test result uses deprecated `namespace` field, "
                            "replacing `policy` with a `<namespace>/<name>` pattern")
            r["policy"] = f"{r.pop('namespace')}/{r.get('policy', '')}"
        if r.get("status") and r.get("result"):
            raise ValueError("test result should not use both `status` and `result` fields")
        if r.get("status"):
            messages.append("test result uses deprecated `status` field, moving it into the `result` field")
            r["result"] = r.pop("status")
        results.append(r)
    if compress and results:
        grouped: Dict[tuple, Dict[str, Any]] = {}
        for r in results:
            key = tuple(sorted((k, json.dumps(v, sort_keys=True))
                               for k, v in r.items() if k != "resources"))
            g = grouped.setdefault(key, {**{k: v for k, v in r.items()
                                            if k != "resources"}, "resources": []})
            g["resources"] += r.get("resources") or []
        results = []
        for g in grouped.values():
            res = g.get("resources") or []
            if len(set(res)) != len(res):
                messages.append("test results contains duplicate resources")
            g["resources"] = sorted(set(res))
            results.append(g)
    if results or "results" in out:
        out["results"] = results
    return out, messages


def run_fix(args: argparse.Namespace) -> int:
    if args.target != "test":
        print(f"unsupported fix target {args.target!r} (supported: test)",
              file=sys.stderr)
        return 2
    rc = 0
    for path in args.paths:
        files = [path]
        if os.path.isdir(path):
            files = [os.path.join(r, n) for r, _, ns in os.walk(path)
                     for n in ns if n == "kyverno-test.yaml"]
        for f in files:
            with open(f) as fh:
                doc = yaml.safe_load(fh) or {}
            try:
                fixed, messages = fix_test_doc(doc, compress=args.compress)
            except ValueError as e:
                print(f"{f}: ERROR {e}", file=sys.stderr)
                rc = 1
                continue
            print(f"Processing test file ({f})...")
            for m in messages:
                print(f"  {m}")
            if args.save:
                with open(f, "w") as fh:
                    yaml.safe_dump(fixed, fh, sort_keys=False)
                print("  saved")
    return rc


# ---------------------------------------------------------------------------
# create (commands/create templates)

_CREATE_TEMPLATES = {
    "test": {
        "apiVersion": "cli.kyverno.io/v1alpha1", "kind": "Test",
        "metadata": {"name": "kyverno-test"},
        "policies": ["policy.yaml"], "resources": ["resource.yaml"],
        "results": [{"policy": "policy-name", "rule": "rule-name",
                     "resources": ["resource-name"], "kind": "Pod",
                     "result": "pass"}],
    },
    "values": {
        "apiVersion": "cli.kyverno.io/v1alpha1", "kind": "Values",
        "metadata": {"name": "values"},
        "globalValues": {}, "policies": [],
        "namespaceSelector": [],
    },
    "exception": {
        "apiVersion": "kyverno.io/v2", "kind": "PolicyException",
        "metadata": {"name": "exception", "namespace": "default"},
        "spec": {"exceptions": [{"policyName": "policy-name",
                                 "ruleNames": ["rule-name"]}],
                 "match": {"any": [{"resources": {"kinds": ["Pod"]}}]}},
    },
    "user-info": {
        "apiVersion": "cli.kyverno.io/v1alpha1", "kind": "UserInfo",
        "metadata": {"name": "user-info"},
        "clusterRoles": [], "roles": [],
        "userInfo": {"username": "user", "groups": []},
    },
    "metrics-config": {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "kyverno-metrics", "namespace": "kyverno"},
        "data": {"namespaces": json.dumps({"include": [], "exclude": []}),
                 "metricsRefreshInterval": "10m"},
    },
}


def run_create(args: argparse.Namespace) -> int:
    tpl = _CREATE_TEMPLATES.get(args.kind)
    if tpl is None:
        print(f"unknown template {args.kind!r} "
              f"(supported: {', '.join(sorted(_CREATE_TEMPLATES))})",
              file=sys.stderr)
        return 2
    text = yaml.safe_dump(tpl, sort_keys=False)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"created {args.output}")
    else:
        print(text, end="")
    return 0


# ---------------------------------------------------------------------------
# docs (commands/docs — markdown of the command tree)


def run_docs(args: argparse.Namespace) -> int:
    from . import __main__ as entry

    parser = entry.build_parser()
    lines = [f"# {parser.prog}", "", parser.description or "", ""]
    subs = next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction))
    for name, sub in sorted(subs.choices.items()):
        lines.append(f"## {parser.prog} {name}")
        lines.append("")
        lines.append(sub.format_help())
        lines.append("")
    text = "\n".join(lines)
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        path = os.path.join(args.output, "kyverno-tpu.md")
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote {path}")
    else:
        print(text)
    return 0


# ---------------------------------------------------------------------------
# oci push / pull (local OCI image layout, kyverno media types)


def _blob_put(layout: str, data: bytes) -> Dict[str, Any]:
    digest = "sha256:" + hashlib.sha256(data).hexdigest()
    os.makedirs(os.path.join(layout, "blobs", "sha256"), exist_ok=True)
    with open(os.path.join(layout, "blobs", digest.replace("sha256:", "sha256/")), "wb") as f:
        f.write(data)
    return {"digest": digest, "size": len(data)}


def _blob_get(layout: str, digest: str) -> bytes:
    with open(os.path.join(layout, "blobs", digest.replace("sha256:", "sha256/")), "rb") as f:
        return f.read()


def run_oci(args: argparse.Namespace) -> int:
    if args.direction == "push":
        docs = [d for d in _load_docs_from([args.policy])
                if d.get("kind") in ("ClusterPolicy", "Policy",
                                     "ValidatingPolicy")]
        if not docs:
            print("no policies found", file=sys.stderr)
            return 2
        layout = args.image
        layers = []
        for doc in docs:
            data = yaml.safe_dump(doc, sort_keys=False).encode()
            ref = _blob_put(layout, data)
            name = (doc.get("metadata") or {}).get("name", "policy")
            layers.append({"mediaType": POLICY_LAYER_MEDIA_TYPE, **ref,
                           "annotations": {"kyverno.io/policy.name": name}})
        config = _blob_put(layout, json.dumps(
            {"created_by": "kyverno-tpu oci push"}).encode())
        manifest = {
            "schemaVersion": 2,
            "mediaType": "application/vnd.oci.image.manifest.v1+json",
            "config": {"mediaType": POLICY_CONFIG_MEDIA_TYPE, **config},
            "layers": layers,
        }
        mref = _blob_put(layout, json.dumps(manifest, sort_keys=True).encode())
        index = {"schemaVersion": 2, "manifests": [
            {"mediaType": "application/vnd.oci.image.manifest.v1+json", **mref,
             "annotations": {"org.opencontainers.image.ref.name":
                             args.tag or "latest"}}]}
        with open(os.path.join(layout, "index.json"), "w") as f:
            json.dump(index, f)
        with open(os.path.join(layout, "oci-layout"), "w") as f:
            json.dump({"imageLayoutVersion": "1.0.0"}, f)
        print(f"pushed {len(layers)} polic{'y' if len(layers) == 1 else 'ies'} "
              f"to {layout}")
        return 0
    # pull
    layout = args.image
    with open(os.path.join(layout, "index.json")) as f:
        index = json.load(f)
    want = args.tag or "latest"
    manifest_ref = None
    for m in index.get("manifests") or []:
        if (m.get("annotations") or {}).get(
                "org.opencontainers.image.ref.name", "latest") == want:
            manifest_ref = m
            break
    if manifest_ref is None:
        print(f"tag {want!r} not found in {layout}", file=sys.stderr)
        return 2
    manifest = json.loads(_blob_get(layout, manifest_ref["digest"]))
    os.makedirs(args.output or ".", exist_ok=True)
    n = 0
    for layer in manifest.get("layers") or []:
        if layer.get("mediaType") != POLICY_LAYER_MEDIA_TYPE:
            continue  # pull ignores non-policy layers (pull/options.go:78)
        data = _blob_get(layout, layer["digest"])
        name = (layer.get("annotations") or {}).get(
            "kyverno.io/policy.name", f"policy-{n}")
        path = os.path.join(args.output or ".", f"{name}.yaml")
        with open(path, "wb") as f:
            f.write(data)
        print(f"pulled {path}")
        n += 1
    return 0 if n else 2


# ---------------------------------------------------------------------------
# top — live policy-observatory view against a running serve


def _http_get_json(host: str, port: int, path: str, timeout: float = 10.0):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status >= 400:
        raise RuntimeError(f"GET {path} -> {resp.status}")
    return json.loads(body)


def _render_top(rules: Dict[str, Any], util: Dict[str, Any],
                ready: Dict[str, Any], n: int) -> str:
    lines: List[str] = []
    starv = util.get("feed_starvation") or {}
    pipe = util.get("pipeline") or {}
    slo = util.get("slo") or {}
    adm = (slo.get("admission") or {}).get("windows") or {}
    fresh = slo.get("scan_freshness") or {}
    cov = slo.get("device_coverage") or {}
    ps = ready.get("policyset") or {}
    lines.append(
        f"kyverno-tpu top — revision {ps.get('active_revision', '?')}"
        f"  rules tracked {rules.get('rules_tracked', 0)}"
        f"  breaker {ready.get('breaker', '?')}")
    lines.append(
        f"feed starvation {starv.get('ratio', 0.0):.3f}"
        f"  pipeline overlap {pipe.get('overlap_ratio', 0.0):.3f}"
        f"  device coverage "
        f"{cov.get('ratio') if cov.get('ratio') is not None else '-'}"
        f" (floor {cov.get('floor', '-')})")
    burn = "  ".join(
        f"burn[{w}]={v.get('burn_rate', 0.0):.2f} "
        f"p99={v.get('p99_ms', 0.0):.1f}ms" for w, v in sorted(adm.items()))
    freshness = fresh.get("seconds_since_scan")
    lines.append(
        (burn or "no admission traffic")
        + f"  scan freshness "
          f"{freshness if freshness is not None else '-'}s")
    breached = slo.get("breached") or []
    if breached:
        lines.append(f"SLO BURNING: {', '.join(breached)}")
    lines.append("")
    header = f"{'POLICY/RULE':<52}{'FIRED':>8}{'FAIL':>8}{'ERR':>6}" \
             f"{'EVALS':>10}  WHERE"
    lines.append(header)
    for r in (rules.get("top") or [])[:n]:
        name = f"{r['policy']}/{r['rule']}"
        lines.append(f"{name[:51]:<52}{r['fired']:>8}{r['fail']:>8}"
                     f"{r['error']:>6}{r['evals']:>10}  "
                     f"{'device' if r.get('on_device') else 'host'}")
    never = rules.get("never_fired") or []
    if never:
        names = ", ".join(f"{r['policy']}/{r['rule']}" for r in never[:8])
        more = f" (+{len(never) - 8} more)" if len(never) > 8 else ""
        lines.append("")
        lines.append(f"never fired ({len(never)}): {names}{more}")
    return "\n".join(lines)


def _render_fleet(fleet: Dict[str, Any]) -> str:
    """The fleet health matrix + rollup, from a /debug/fleet doc. Any
    replica can serve it: the leader computes the rollup and gossips
    it back on heartbeats."""
    lines: List[str] = []
    if not fleet.get("enabled"):
        return "fleet: disabled (serve without --fleet-listen)"
    mem = fleet.get("membership") or {}
    tel = fleet.get("telemetry") or {}
    rollup = tel.get("rollup") or {}
    lines.append(
        f"fleet — replica {mem.get('replica_id', '?')}"
        f"  epoch {mem.get('epoch', '?')}"
        f"  live {len(mem.get('live') or [])}"
        f"  leader {'yes' if tel.get('is_leader') else 'no'}")
    if not rollup:
        lines.append("no rollup yet (waiting for the leader's first "
                     "telemetry fold)")
        return "\n".join(lines)
    age = tel.get("rollup_age_s")
    totals = rollup.get("totals") or {}
    burn = "  ".join(f"burn[{w}]={v:.2f}"
                     for w, v in sorted((rollup.get("burn") or {}).items()))
    lines.append(
        f"rollup by {rollup.get('computed_by', '?')}"
        f" ({age if age is not None else '?'}s old)"
        f"  admissions {totals.get('admission_requests', 0):.0f}"
        f"  divergences {totals.get('verification_divergences', 0):.0f}"
        f"  {'DEGRADED' if rollup.get('degraded') else 'healthy'}")
    if burn:
        lines.append(burn)
    rejects = rollup.get("rejects") or {}
    if rejects:
        lines.append("snapshot rejects: " + ", ".join(
            f"{r}={n}" for r, n in sorted(rejects.items())))
    lines.append("")
    lines.append(f"{'REPLICA':<16}{'SEQ':>6}{'AGE':>8}{'BURN':>8}"
                 f"{'DIVERG':>8}{'SHARDS':>8}{'HIT%':>7}")
    for rid, row in sorted((rollup.get("replicas") or {}).items()):
        hit = row.get("cache_hit_rate")
        lines.append(
            f"{rid[:15]:<16}{row.get('seq', 0):>6}"
            f"{row.get('snapshot_age_s', 0.0):>7.1f}s"
            f"{row.get('slo_burn', 0.0):>8.2f}"
            f"{row.get('divergences', 0):>8.0f}"
            f"{row.get('shards_owned') if row.get('shards_owned') is not None else '-':>8}"
            f"{f'{hit * 100:.0f}' if hit is not None else '-':>7}")
    return "\n".join(lines)


def run_top(args: argparse.Namespace) -> int:
    """`kyverno-tpu top` — poll a running serve's metrics-port debug
    surface (/debug/rules, /debug/utilization, /readyz — plus
    /debug/fleet with --fleet) and render a live terminal view of the
    policy observatory."""
    import time as _time

    iterations = args.iterations
    i = 0
    while True:
        try:
            rules = _http_get_json(args.host, args.port,
                                   f"/debug/rules?top={args.top}")
            util = _http_get_json(args.host, args.port, "/debug/utilization")
            try:
                ready = _http_get_json(args.host, args.port, "/readyz")
            except Exception:
                ready = {}  # 503 still renders; readiness is advisory
            fleet = None
            if getattr(args, "fleet", False):
                fleet = _http_get_json(args.host, args.port, "/debug/fleet")
        except Exception as e:
            print(f"cannot reach serve metrics port "
                  f"{args.host}:{args.port}: {e}", file=sys.stderr)
            return 1
        if not args.no_clear:
            sys.stdout.write("\x1b[2J\x1b[H")
        print(_render_top(rules, util, ready, args.top))
        if fleet is not None:
            print()
            print(_render_fleet(fleet))
        i += 1
        if iterations and i >= iterations:
            return 0
        _time.sleep(args.interval)


# ---------------------------------------------------------------------------
# parser wiring


def add_parsers(sub) -> None:
    js = sub.add_parser("json", help="work with JSON payloads")
    jsub = js.add_subparsers(dest="json_command", required=True)
    scan = jsub.add_parser("scan", help="scan JSON payloads with ValidatingPolicies")
    scan.add_argument("--payload", required=True, help="payload file (json/yaml)")
    scan.add_argument("--pre-process", action="append", default=[],
                      dest="pre_process", help="JMESPath payload transform")
    scan.add_argument("--policy", action="append", required=True,
                      help="ValidatingPolicy file or directory")
    scan.add_argument("--output", choices=["text", "json"], default="text")
    scan.set_defaults(func=run_json_scan)

    fix = sub.add_parser("fix", help="fix deprecated file schemas")
    fix.add_argument("target", choices=["test"])
    fix.add_argument("paths", nargs="+")
    fix.add_argument("--save", action="store_true", help="write fixes back")
    fix.add_argument("--compress", action="store_true",
                     help="merge results rows differing only in resources")
    fix.set_defaults(func=run_fix)

    create = sub.add_parser("create", help="scaffold kyverno documents")
    create.add_argument("kind", choices=sorted(_CREATE_TEMPLATES))
    create.add_argument("--output", "-o", default=None)
    create.set_defaults(func=run_create)

    docs = sub.add_parser("docs", help="generate CLI markdown docs")
    docs.add_argument("--output", "-o", default=None, help="output directory")
    docs.set_defaults(func=run_docs)

    oci = sub.add_parser("oci", help="push/pull policies to an OCI image layout")
    oci.add_argument("direction", choices=["push", "pull"])
    oci.add_argument("--image", "-i", required=True,
                     help="OCI image-layout directory")
    oci.add_argument("--policy", "-p", default=".",
                     help="policy file/dir to push")
    oci.add_argument("--tag", "-t", default="latest")
    oci.add_argument("--output", "-o", default=".",
                     help="directory to pull policies into")
    oci.set_defaults(func=run_oci)

    top = sub.add_parser(
        "top", help="live policy-observatory view against a running serve")
    top.add_argument("--host", default="127.0.0.1",
                     help="serve metrics host")
    top.add_argument("--port", type=int, default=8000,
                     help="serve metrics port (the /debug surface)")
    top.add_argument("--interval", type=float, default=2.0,
                     help="seconds between refreshes")
    top.add_argument("--top", type=int, default=20,
                     help="hot rules shown")
    top.add_argument("--iterations", type=int, default=0,
                     help="stop after N refreshes (0 = run until ^C)")
    top.add_argument("--no-clear", action="store_true",
                     help="append frames instead of clearing the screen "
                          "(log-friendly)")
    top.add_argument("--fleet", action="store_true",
                     help="also render the fleet health matrix and "
                          "telemetry rollup from /debug/fleet")
    top.set_defaults(func=run_top)
