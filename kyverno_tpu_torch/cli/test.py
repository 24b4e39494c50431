# Copied verbatim from kyverno_tpu/cli/test.py.
"""`test` — declarative regression harness (kyverno-test.yaml).

Equivalent of cmd/cli/kubectl-kyverno/commands/test: discover test
manifests, load their policies/resources, run the engine, and diff
actual rule results against the declared expectations. Autogen rule
names match through their base rule (a `rule: check-x` expectation
accepts `autogen-check-x` / `autogen-cronjob-check-x` responses, the
same normalization the reference applies in test/output.go).
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import yaml

from ..api.policy import ClusterPolicy, is_policy_document
from ..engine.engine import Engine as ScalarEngine
from ..policy.autogen import expand_policy


def add_parser(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("test", help="run declarative kyverno-test.yaml tests")
    p.add_argument("paths", nargs="*", default=["."],
                   help="dirs/files to search for kyverno-test.yaml")
    p.add_argument("--fail-only", action="store_true",
                   help="only print failing checks")
    p.set_defaults(func=run)


def _discover(paths: List[str]) -> List[str]:
    found = []
    for p in paths or ["."]:
        if os.path.isfile(p):
            found.append(p)
            continue
        for root, _, files in os.walk(p):
            for f in files:
                if f in ("kyverno-test.yaml", "kyverno-test.yml"):
                    found.append(os.path.join(root, f))
    return sorted(found)


def _load_yaml_docs(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [d for d in yaml.safe_load_all(f) if isinstance(d, dict)]


class TestCase:
    def __init__(self, path: str):
        self.path = path
        docs = _load_yaml_docs(path)
        if not docs:
            raise ValueError(f"{path}: empty test manifest")
        self.spec = docs[0]
        base = os.path.dirname(path)
        self.policies: List[ClusterPolicy] = []
        self.resources: List[Dict[str, Any]] = []
        self.vaps: List[Dict[str, Any]] = []
        for rel in self.spec.get("policies") or []:
            for d in _load_yaml_docs(os.path.join(base, rel)):
                if is_policy_document(d):
                    self.policies.append(ClusterPolicy.from_dict(d))
                elif d.get("kind") == "ValidatingAdmissionPolicy":
                    self.vaps.append(d)
        for rel in self.spec.get("resources") or []:
            for d in _load_yaml_docs(os.path.join(base, rel)):
                if not is_policy_document(d):
                    # the reference CLI loader defaults every
                    # namespace-less resource to "default"
                    # (cli resource/resource.go:56-58)
                    meta = d.setdefault("metadata", {})
                    if not meta.get("namespace"):
                        meta["namespace"] = "default"
                    self.resources.append(d)
        # values: inline (spec.values) or the variables file named by
        # spec.variables (default sibling values.yaml) — the reference
        # Values schema (apis/v1alpha1/values.go)
        values = dict(self.spec.get("values") or {})
        var_file = self.spec.get("variables") or "values.yaml"
        var_path = os.path.join(base, var_file)
        if os.path.exists(var_path):
            with open(var_path) as f:
                file_vals = yaml.safe_load(f) or {}
            for k, v in file_vals.items():
                values.setdefault(k, v)
        self.ns_labels: Dict[str, Dict[str, str]] = {}
        for ns in values.get("namespaces") or []:
            meta = ns.get("metadata") or {}
            name = meta.get("name", "") or ns.get("name", "")
            self.ns_labels[name] = dict(
                (meta.get("labels") or {}) or (ns.get("labels") or {}))
        # Values.namespaceSelector: bare {name, labels} pairs feeding
        # namespaceSelector matching (values.go NamespaceSelector)
        for ns in values.get("namespaceSelector") or []:
            name = ns.get("name", "")
            if name:
                self.ns_labels.setdefault(name, {}).update(ns.get("labels") or {})
        # subresource mappings (Values.subresources, values.go): a
        # document whose GVK equals a declared subresource GVK is
        # matched as <parent-kind>/<subresource> — the CLI's clusterless
        # equivalent of discovery (policy_processor.go:86-105)
        self.subresources: List[Tuple[Tuple[str, str, str],
                                      Tuple[str, str, str], str]] = []
        for sr in values.get("subresources") or []:
            sub = sr.get("subresource") or {}
            parent = sr.get("parentResource") or {}
            sub_gvk = (sub.get("group", "") or "", sub.get("version", "") or "",
                       sub.get("kind", "") or "")
            parent_gvk = (parent.get("group", "") or "",
                          parent.get("version", "") or "",
                          parent.get("kind", "") or "")
            name = sub.get("name", "")
            sub_name = name.split("/", 1)[1] if "/" in name else ""
            self.subresources.append((sub_gvk, parent_gvk, sub_name))
        # GlobalValues is a map in the reference schema (values.go)
        self.variables: Dict[str, Any] = dict(values.get("globalValues") or {})
        # per-policy rule values (context variables) and per-resource
        # values (request.* seeds)
        self.rule_values: Dict[str, Dict[str, Any]] = {}
        self.resource_values: Dict[tuple, Dict[str, Any]] = {}
        for pv in values.get("policies") or []:
            pname = pv.get("name", "")
            merged = {}
            for rv in pv.get("rules") or []:
                merged.update(rv.get("values") or {})
                # foreachValues: per-element value lists; the reference
                # store pins element N (default 0) for the whole run
                # (store.go GetForeachElement, contextloader.go:29-34)
                for k, v in (rv.get("foreachValues") or {}).items():
                    if isinstance(v, list) and v:
                        merged[k] = v[0]
            if merged:
                self.rule_values[pname] = merged
            for rv in pv.get("resources") or []:
                if rv.get("values"):
                    self.resource_values[(pname, rv.get("name", ""))] = \
                        dict(rv["values"])
        self.results: List[Dict[str, Any]] = list(self.spec.get("results") or [])

    def values_for(self, pname: str, resource: Dict[str, Any]) -> Dict[str, Any]:
        meta = resource.get("metadata") or {}
        name = meta.get("name", "")
        ns = meta.get("namespace", "")
        out = dict(self.variables)
        out.update(self.rule_values.get(pname, {}))
        out.update(self.resource_values.get((pname, name), {}))
        if ns:
            out.update(self.resource_values.get((pname, f"{ns}/{name}"), {}))
        return out

    def name(self) -> str:
        meta = self.spec.get("metadata") or {}
        return meta.get("name") or self.spec.get("name") or self.path


def _rule_names_match(expected: str, actual: str) -> bool:
    return actual in (expected, f"autogen-{expected}", f"autogen-cronjob-{expected}")


def _run_case(case: TestCase) -> List[Tuple[Dict[str, Any], str, bool]]:
    """Returns (expected-result row, actual, ok) per declared result."""
    from ..tpu.engine import build_scan_context

    eng = ScalarEngine()

    def build_ctx(policy, current, key):
        """Admission-shaped context mirroring the reference CLI
        (policy_processor.go:204-270): the engine-level operation is
        CREATE unless values name DELETE/UPDATE exactly; the raw value
        (default CREATE, possibly "") lands in request.operation; an
        UPDATE seeds oldObject with the same resource; CLI-store values
        PIN over context loaders."""
        from ..utils import kube

        vals = case.values_for(policy.name, current)
        raw_op = vals.pop("request.operation", "CREATE")
        engine_op = raw_op if raw_op in ("DELETE", "UPDATE") else "CREATE"
        pctx = build_scan_context(policy, current, case.ns_labels.get(key, {}),
                                  operation=engine_op)
        ctx = pctx.json_context
        ctx.add_operation(engine_op)
        if raw_op != engine_op:
            ctx.add_variable("request.operation", raw_op)
        if engine_op == "UPDATE":
            pctx.old_resource = copy.deepcopy(current)
            ctx.add_old_resource(pctx.old_resource)
        for name, value in vals.items():
            ctx.pin_variable(name, value)
        # subresource documents match via the parent GVK
        gvk = kube.gvk_from_resource(current)
        for sub_gvk, parent_gvk, sub_name in case.subresources:
            if gvk == sub_gvk:
                pctx.gvk = parent_gvk
                pctx.subresource = sub_name
                break
        return pctx

    # evaluate every (policy, resource) once; collect rule responses.
    # a policy row carries "scored": fail maps to warn for policies
    # annotated policies.kyverno.io/scored=false (cli report.go:40-45
    # ComputePolicyReportResult)
    responses: List[Tuple[str, str, Dict[str, Any], str, str]] = []
    evaluated: set = set()  # (policy, resource-id) pairs that ran
    patched: Dict[int, Dict[str, Any]] = {}
    expanded = [expand_policy(p) for p in case.policies]
    scored = {p.name: (p.annotations.get("policies.kyverno.io/scored") != "false")
              for p in expanded}
    for policy in expanded:
        for ri, res in enumerate(case.resources):
            current = patched.get(ri, res)
            meta = current.get("metadata") or {}
            ns = meta.get("namespace", "")
            key = meta.get("name", "") if current.get("kind") == "Namespace" else ns
            rid = meta.get("name", "")
            evaluated.add((policy.name, rid, current.get("kind", "")))
            if ns:
                evaluated.add((policy.name, f"{ns}/{rid}",
                               current.get("kind", "")))
            pctx = build_ctx(policy, current, key)
            if any(r.has_mutate() for r in policy.get_rules()):
                m = eng.mutate(pctx)
                for rr in m.policy_response.rules:
                    responses.append((policy.name, rr.name, current, rr.status,
                                      policy.namespace))
                if m.patched_resource is not None:
                    patched[ri] = m.patched_resource
                    current = m.patched_resource
                    pctx = build_ctx(policy, current, key)
            if any(r.has_verify_images() for r in policy.get_rules()):
                iv = eng.verify_and_patch_images(pctx)
                for rr in iv.policy_response.rules:
                    responses.append((policy.name, rr.name, current, rr.status,
                                      policy.namespace))
                if iv.patched_resource is not None:
                    patched[ri] = iv.patched_resource
                    current = iv.patched_resource
                    pctx = build_ctx(policy, current, key)
            v = eng.validate(pctx)
            for rr in v.policy_response.rules:
                responses.append((policy.name, rr.name, current, rr.status,
                              policy.namespace))
    # ValidatingAdmissionPolicy documents evaluate via the in-process
    # VAP engine (vap_processor.go; rule name stays empty for non-
    # Kyverno policies, report.go:52-54)
    from ..vap import validate_vap

    for vap in case.vaps:
        vname = ((vap.get("metadata") or {}).get("name")) or ""
        for ri, res in enumerate(case.resources):
            current = patched.get(ri, res)
            meta = current.get("metadata") or {}
            rid = meta.get("name", "")
            ns = meta.get("namespace", "")
            evaluated.add((vname, rid, current.get("kind", "")))
            if ns:
                evaluated.add((vname, f"{ns}/{rid}",
                               current.get("kind", "")))
            results = validate_vap(
                vap, current,
                namespace_labels=case.ns_labels.get(ns, {}))
            if results is None:
                continue  # matchConstraints did not select the resource
            statuses = {r.status for r in results}
            if "error" in statuses:
                status = "error"
            elif "fail" in statuses:
                status = "fail"
            elif statuses in ({"skip"},):
                status = "skip"
            else:
                status = "pass"
            responses.append((vname, "", current, status, ""))

    # final mutated form per (kind, resource id), for patchedResource
    # checks — kind disambiguates same-named resources of two kinds
    final_patched: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for ri, res in enumerate(case.resources):
        doc = patched.get(ri, res)
        meta = res.get("metadata") or {}
        rid = meta.get("name", "")
        rkind = res.get("kind", "")
        final_patched[(rkind, rid)] = doc
        if meta.get("namespace"):
            final_patched[(rkind, f"{meta['namespace']}/{rid}")] = doc

    def policy_matches(expected: str, actual_name: str,
                       actual_ns: str = "") -> bool:
        # result rows may namespace-qualify a namespaced Policy
        # ("default/test-jmespath", cache.MetaObjectToName); an empty
        # expected policy matches nothing (the reference filters on
        # exact equality after namespace qualification — a bare-name
        # fallback would let ns1/p satisfy a row declaring ns2/p)
        if not expected:
            return False
        if expected == actual_name:
            return True
        if "/" in expected:
            ns, _, name = expected.rpartition("/")
            return name == actual_name and (not actual_ns or ns == actual_ns)
        return False

    out = []
    base = os.path.dirname(case.path)
    for exp in case.results:
        want = (exp.get("result") or exp.get("status") or "").lower()
        names = list(exp.get("resources") or [])
        if exp.get("resource"):
            names.append(exp["resource"])
        kind = exp.get("kind")
        # one row per named resource (printTestResult iterates the
        # resources of each declared result independently)
        for res_name in names or [None]:
            matching = []
            for pname, rname, res, status, pns in responses:
                if not policy_matches(exp.get("policy", ""), pname, pns):
                    continue
                if exp.get("rule") and not _rule_names_match(exp["rule"], rname):
                    continue
                meta = res.get("metadata") or {}
                rid = meta.get("name", "")
                nsid = f"{meta.get('namespace')}/{rid}" if meta.get("namespace") else rid
                if res_name is not None and rid != res_name and nsid != res_name:
                    continue
                if kind and res.get("kind") != kind:
                    continue
                if status == "fail" and not scored.get(pname, True):
                    status = "warn"
                matching.append(status)
            # patchedResource: the mutated output must equal the named
            # file (checkResult, commands/test/command.go:160-168); a
            # want=fail row asserts the declared file INTENTIONALLY
            # diverges from the actual mutation output
            patched_ok = None
            if exp.get("patchedResource") and res_name is not None:
                expected_docs = _load_yaml_docs(
                    os.path.join(base, exp["patchedResource"]))
                if expected_docs:
                    # the expected file rides the same loader and gets
                    # the same namespace defaulting (resource.go:56-58)
                    meta = expected_docs[0].setdefault("metadata", {})
                    if not meta.get("namespace"):
                        meta["namespace"] = "default"
                actual_doc = final_patched.get((kind or "", res_name))
                if actual_doc is None and not kind:
                    for (k, rid), doc in final_patched.items():
                        if rid == res_name:
                            actual_doc = doc
                            break
                patched_ok = bool(expected_docs) and actual_doc == expected_docs[0]
            if not matching:
                # the reference filters engine responses by the row's
                # kind BEFORE deciding excluded-vs-not-found
                # (commands/test/command.go:192), so an empty row only
                # auto-passes when a resource of the DECLARED kind was
                # actually evaluated for this policy
                pname = (exp.get("policy", "") or "").split("/")[-1]
                if res_name is not None and (
                        (pname, res_name, kind) in evaluated
                        or (not kind and any(e[0] == pname and e[1] == res_name
                                             for e in evaluated))):
                    # evaluated but no rule response: the resource was
                    # excluded — upstream counts this row as a success
                    # (output.go:224-239 "Excluded")
                    out.append((exp, res_name, "(excluded)", True))
                else:
                    out.append((exp, res_name, "no result found", False))
                continue
            # every matching response must carry the expected result
            actual = sorted(set(matching))
            ok = actual == [want]
            if patched_ok is not None:
                if want == "fail":
                    ok = ok or not patched_ok
                else:
                    ok = ok and patched_ok
            out.append((exp, res_name, ",".join(actual), ok))
    return out


def run(args: argparse.Namespace) -> int:
    files = _discover(args.paths)
    if not files:
        print("no kyverno-test.yaml found", file=sys.stderr)
        return 2
    total = failed = 0
    for path in files:
        try:
            case = TestCase(path)
        except Exception as e:
            print(f"ERROR loading {path}: {e}", file=sys.stderr)
            failed += 1
            total += 1
            continue
        rows = _run_case(case)
        for exp, res_name, actual, ok in rows:
            total += 1
            if not ok:
                failed += 1
            if ok and args.fail_only:
                continue
            tag = "PASS" if ok else "FAIL"
            print(f"{tag}  {case.name()}: {exp.get('policy')}/{exp.get('rule')} "
                  f"[{exp.get('kind')} {res_name or '*'}] "
                  f"want={exp.get('result') or exp.get('status')} got={actual}")
    print(f"\nTest summary: {total - failed} passed, {failed} failed")
    return 1 if failed else 0
