# Copied from kyverno_tpu/cli/apply.py. --engine tpu runs TorchEngine on
# the card (--device cpu asks for the plain PyTorch path), and
# --xla-trace DIR traces the validate stage with torch.profiler.
"""`apply` — evaluate policies against resources offline.

Equivalent of cmd/cli/kubectl-kyverno/commands/apply (command.go:72,
processor/policy_processor.go:59): load policies and resources from
files/dirs/stdin, autogen-expand, run mutate then validate per
resource, print results and exit non-zero on enforce failures.

The validate stage runs on the batch engine: `--engine tpu` (default)
compiles the policy set once and evaluates the full cross-product on
the card (`TorchEngine`; `--device cpu` runs its plain PyTorch path);
`--engine scalar` forces the host oracle (the reference's Go-path
analogue, selectable like pkg/toggle gates).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import yaml

from ..api.policy import ClusterPolicy, is_policy_document
from ..engine.engine import Engine as ScalarEngine
from ..policy.autogen import expand_policy
from ..tpu.evaluator import FAIL, NOT_MATCHED


def _iter_yaml_files(paths: List[str]):
    for p in paths:
        if p == "-":
            yield "-", sys.stdin.read()
            continue
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs.sort()  # deterministic policy load (and mutate) order
                for f in sorted(files):
                    if f.endswith((".yaml", ".yml", ".json")):
                        fp = os.path.join(root, f)
                        with open(fp) as fh:
                            yield fp, fh.read()
        else:
            with open(p) as fh:
                yield p, fh.read()


def _load_docs(paths: List[str]) -> List[Dict[str, Any]]:
    docs: List[Dict[str, Any]] = []
    for name, text in _iter_yaml_files(paths):
        try:
            for d in yaml.safe_load_all(text):
                if isinstance(d, dict):
                    docs.append(d)
        except yaml.YAMLError as e:
            raise SystemExit(f"failed to parse {name}: {e}")
    return docs


def add_parser(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("apply", help="apply policies to resources")
    p.add_argument("policies", nargs="+", help="policy files or directories")
    p.add_argument("--resource", "-r", action="append", default=[],
                   help="resource file/dir (repeatable, '-' for stdin)")
    p.add_argument("--engine", choices=["tpu", "scalar"], default="tpu",
                   help="validate executor (default tpu: the device "
                        "engine; scalar = host oracle)")
    p.add_argument("--device", default=None,
                   help="torch device of the device engine (default: "
                        "the CUDA card; 'cpu' runs the plain PyTorch "
                        "path)")
    p.add_argument("--audit-warn", action="store_true",
                   help="treat Audit-mode failures as warnings for the exit code")
    p.add_argument("--detailed-results", action="store_true",
                   help="print one line per rule result")
    p.add_argument("--registry-fixture", default=None,
                   help="YAML/JSON file seeding the offline image "
                        "registry (image -> digest/signers/attestations) "
                        "for verifyImages rules")
    p.add_argument("--output-json", action="store_true",
                   help="machine-readable summary on stdout")
    p.add_argument("--output", "-o", default=None,
                   help="write (mutated) resources to this file or "
                        "directory (the reference's forceMutate output)")
    p.add_argument("--profile", action="store_true",
                   help="print a per-phase latency breakdown table "
                        "(encode/compile/dispatch/readback/host) after "
                        "the scan")
    p.add_argument("--rule-stats", action="store_true",
                   help="print per-rule analytics after the run: evals, "
                        "pass/fail/error counts, never-fired rules, and "
                        "device vs host placement (policy observatory)")
    p.add_argument("--xla-trace", default=None, metavar="DIR",
                   help="capture one torch.profiler trace (host and CUDA "
                        "activity) of the validate stage into DIR")
    p.add_argument("--encode-workers", type=int, default=None, metavar="N",
                   help="encoder worker processes for the resource encode "
                        "(default $KYVERNO_TPU_ENCODE_WORKERS or 0; 0 = "
                        "in-process encode, byte-for-byte today's path)")
    p.set_defaults(func=run)


def _verdict_rows(policies, resources, ns_labels, engine_kind,
                  device=None):
    """Returns list of (policy, rule_name, resource_idx, status, message)."""
    if engine_kind == "tpu":
        from ..tpu.engine import TorchEngine, VERDICT_NAMES

        eng = TorchEngine(policies, device=device)
        result = eng.scan(resources, ns_labels)
        out = []
        for row, (pname, rname) in enumerate(result.rules):
            entry = eng.cps.rules[row]
            policy = eng.cps.policies[entry.policy_idx]
            fail_msg = _rule_message(policy, rname)
            for ci in range(len(resources)):
                code = int(result.verdicts[row, ci])
                if code == NOT_MATCHED:  # no result, like the engine
                    continue
                msg = fail_msg if code == FAIL else ""
                out.append((policy, rname, ci, VERDICT_NAMES[code], msg))
        return out
    # scalar path
    from ..tpu.engine import build_scan_context

    eng = ScalarEngine()
    out = []
    for policy in policies:
        for ci, res in enumerate(resources):
            ns = (res.get("metadata") or {}).get("namespace", "")
            pctx = build_scan_context(policy, res, (ns_labels or {}).get(ns, {}))
            response = eng.validate(pctx)
            for rr in response.policy_response.rules:
                out.append((policy, rr.name, ci, rr.status, rr.message))
    return out


def _rule_message(policy: ClusterPolicy, rule_name: str) -> str:
    for r in policy.get_rules():
        if r.name == rule_name and r.validation is not None:
            return (r.validation.message or "").strip()
    return ""


def _res_id(res: Dict[str, Any]) -> str:
    meta = res.get("metadata") or {}
    ns = meta.get("namespace", "")
    kind = res.get("kind", "?")
    name = meta.get("name", "?")
    return f"{ns + '/' if ns else ''}{kind}/{name}"


def _apply_stage(policies, resources, has_rule, invoke
                 ) -> Tuple[List[Dict[str, Any]], List[Tuple]]:
    """One patching stage of ApplyPoliciesOnResource
    (policy_processor.go:59): sequentially apply each policy whose
    rules match ``has_rule`` to every resource via ``invoke(engine,
    pctx)``; later stages run on the patched resources."""
    from ..tpu.engine import build_scan_context

    eng = ScalarEngine()
    active = [p for p in policies if any(has_rule(r) for r in p.get_rules())]
    if not active:
        return list(resources), []
    patched_resources: List[Dict[str, Any]] = []
    results: List[Tuple] = []
    for ci, res in enumerate(resources):
        current = res
        for policy in active:
            pctx = build_scan_context(policy, current, None)
            response = invoke(eng, pctx)
            for rr in response.policy_response.rules:
                results.append((policy, rr.name, ci, rr.status, rr.message))
            if response.patched_resource is not None:
                current = response.patched_resource
        patched_resources.append(current)
    return patched_resources, results


def _apply_mutations(policies, resources) -> Tuple[List[Dict[str, Any]], List[Tuple]]:
    """Mutate stage (policy_processor.go:109)."""
    return _apply_stage(policies, resources,
                        lambda r: r.has_mutate(),
                        lambda eng, pctx: eng.mutate(pctx))


def _apply_image_verification(policies, resources, registry_client=None
                              ) -> Tuple[List[Dict[str, Any]], List[Tuple]]:
    """verifyImages stage (policy_processor.go:126): digest patches and
    the verify-images annotation land on the resources the validate
    stage sees. Without a configured registry, lookups raise
    RegistryError which surfaces as rule ERRORs — same shape as the
    reference offline."""
    return _apply_stage(
        policies, resources,
        lambda r: r.has_verify_images(),
        lambda eng, pctx: eng.verify_and_patch_images(
            pctx, registry_client=registry_client))


class _VapShim:
    """Gives VAP result rows the .name/.spec surface the output loop
    expects from ClusterPolicy."""

    def __init__(self, name: str):
        self.name = name


def _vap_rows(vap_docs, resources, ns_labels=None):
    """Evaluate ValidatingAdmissionPolicy objects in-process
    (commands/apply/command.go:213 -> validatingadmissionpolicy
    Validate). namespaceSelector constraints resolve against labels of
    Namespace resources supplied alongside (the reference CLI resolves
    selectors the same way) — without them a selector-bearing VAP
    would silently never apply."""
    from ..vap import validate_vap

    ns_labels = ns_labels or {}
    rows = []
    for doc in vap_docs:
        shim = _VapShim((doc.get("metadata") or {}).get("name", "vap"))
        for ci, res in enumerate(resources):
            ns = (res.get("metadata") or {}).get("namespace", "")
            results = validate_vap(doc, res,
                                   namespace_labels=ns_labels.get(ns, {}))
            if results is None:
                continue
            for r in results:
                rows.append((shim, f"validation[{r.index}]" if r.index >= 0
                             else "validation", ci, r.status, r.message))
    return rows


def _write_output(target: str, resources) -> None:
    """Dump post-mutation resources (apply --output / forceMutate)."""
    import os

    if target.endswith(("/", os.sep)) or os.path.isdir(target):
        os.makedirs(target, exist_ok=True)
        for res in resources:
            meta = res.get("metadata") or {}
            # namespace is part of identity: same-kind same-name
            # resources in two namespaces must not overwrite each other
            parts = [res.get("kind", "resource"),
                     meta.get("namespace", ""), meta.get("name", "unnamed")]
            name = "-".join(p for p in parts if p) + ".yaml"
            with open(os.path.join(target, name.lower()), "w") as f:
                yaml.safe_dump(res, f, sort_keys=False)
    else:
        with open(target, "w") as f:
            yaml.safe_dump_all(resources, f, sort_keys=False)


def run(args: argparse.Namespace) -> int:
    from ..vap.policy import is_vap_document

    loaded = _load_docs(args.policies)
    policy_docs = [d for d in loaded if is_policy_document(d)]
    vap_docs = [d for d in loaded if is_vap_document(d)]
    if not policy_docs and not vap_docs:
        print("no policies found", file=sys.stderr)
        return 2
    resource_docs = [d for d in _load_docs(args.resource)
                     if not is_policy_document(d) and not is_vap_document(d)]
    if not resource_docs:
        print("no resources found", file=sys.stderr)
        return 2
    policies = [expand_policy(ClusterPolicy.from_dict(d)) for d in policy_docs]
    enforce = {p.name: (p.spec.validation_failure_action or "Audit").lower()
               for p in policies}
    # VAP failures deny at admission; treat them as enforce here
    for d in vap_docs:
        enforce[(d.get("metadata") or {}).get("name", "vap")] = "enforce"

    if getattr(args, "profile", False):
        # profile THIS apply run, not whatever warmed the process
        from ..observability.profiling import global_profiler

        global_profiler.reset()
    if getattr(args, "rule_stats", False):
        # scope the analytics to THIS apply run
        from ..observability.analytics import global_rule_stats

        global_rule_stats.reset()
    resource_docs, mutate_rows = _apply_mutations(policies, resource_docs)
    registry_client = None
    if getattr(args, "registry_fixture", None):
        from ..images import StaticRegistry
        with open(args.registry_fixture) as f:
            registry_client = StaticRegistry(yaml.safe_load(f) or {})
    resource_docs, vi_rows = _apply_image_verification(
        policies, resource_docs, registry_client)
    if getattr(args, "output", None):
        _write_output(args.output, resource_docs)
    # namespace labels come from Namespace resources in the input set
    # (the reference CLI resolves namespaceSelector the same way)
    ns_labels = {(d.get("metadata") or {}).get("name", ""):
                 ((d.get("metadata") or {}).get("labels") or {})
                 for d in resource_docs if d.get("kind") == "Namespace"}
    from ..encode import configure_pool, shutdown_pool
    from ..observability.profiling import maybe_xla_trace

    configure_pool(getattr(args, "encode_workers", None))
    try:
        with maybe_xla_trace(getattr(args, "xla_trace", None)):
            rows = (mutate_rows + vi_rows
                    + (_verdict_rows(policies, resource_docs,
                                     ns_labels or None, args.engine,
                                     getattr(args, "device", None))
                       if policies else [])
                    + _vap_rows(vap_docs, resource_docs, ns_labels))
    finally:
        shutdown_pool()  # drain + join: apply leaves zero children

    counts = {"pass": 0, "fail": 0, "warn": 0, "error": 0, "skip": 0}
    failures: List[Tuple[str, str, str, str]] = []
    warnings: List[Tuple[str, str, str, str]] = []
    for policy, rule, ci, status, msg in rows:
        if status == "fail":
            action = enforce.get(policy.name, "audit")
            entry = (policy.name, rule, _res_id(resource_docs[ci]), msg)
            if args.audit_warn and action.startswith("audit"):
                counts["warn"] += 1
                warnings.append(entry)
            else:
                counts["fail"] += 1
                failures.append(entry)
        elif status in counts:
            counts[status] += 1
        if args.detailed_results:
            print(f"{policy.name}/{rule} -> {_res_id(resource_docs[ci])}: {status}"
                  + (f" ({msg})" if msg and status != "pass" else ""))

    if args.output_json:
        as_dicts = lambda items: [  # noqa: E731
            {"policy": p, "rule": r, "resource": res, "message": m}
            for p, r, res, m in items]
        print(json.dumps({"summary": counts, "failures": as_dicts(failures),
                          "warnings": as_dicts(warnings)}))
    else:
        for pname, rule, res, msg in failures:
            first = (msg or "validation failure").splitlines()[0]
            print(f"policy {pname} -> resource {res} failed:")
            print(f"  {rule}: {first}")
        for pname, rule, res, msg in warnings:
            first = (msg or "validation failure").splitlines()[0]
            print(f"policy {pname} -> resource {res} warning:")
            print(f"  {rule}: {first}")
        total = sum(counts.values())
        print(f"\nApplied {len(policies)} policy rule(s) to {len(resource_docs)} resource(s)...")
        print(f"pass: {counts['pass']}, fail: {counts['fail']}, warn: {counts['warn']}, "
              f"error: {counts['error']}, skip: {counts['skip']}")
    if getattr(args, "profile", False):
        # stderr: --output-json consumers own stdout
        from ..observability.profiling import global_profiler

        print(global_profiler.render_table(
            "per-phase latency breakdown (apply --profile)"),
            file=sys.stderr)
    if getattr(args, "rule_stats", False):
        from ..observability.analytics import global_rule_stats

        print(global_rule_stats.render_table(
            title="per-rule analytics (apply --rule-stats)"),
            file=sys.stderr)
    if counts["error"]:
        return 3
    return 1 if counts["fail"] else 0
