# Copied verbatim from kyverno_tpu/engine/jsonassert.py.
"""kyverno-json assertion-tree engine (the `kyverno json scan` core).

The reference CLI's `json scan` delegates to the kyverno-json library:
ValidatingPolicy (json.kyverno.io/v1alpha1) rules carry `assert`
any/all assertion trees evaluated against arbitrary JSON payloads
(cmd/cli/kubectl-kyverno/commands/json/scan/options.go). This module
implements the assertion-tree subset those policies use:

- maps: every key must assert against the payload's value; a missing
  key fails (unlike validate.pattern's conditional anchors);
- `(expression)` keys: the JMESPath expression evaluates against the
  CURRENT payload node and its result asserts against the value;
- `~.(expression)` / `~.field` iteration keys: the expression's result
  (a list) asserts the value tree against EVERY element;
- lists: pairwise assertion when lengths match, else fail;
- scalar leaves: equality, with the engine's pattern-operator grammar
  for strings (>=, !, |, globs — a documented superset);
- match/exclude: the same trees, used as gates (no fail message).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from . import pattern as patternpkg
from .jmespath import compile as jp_compile


class AssertionError_(Exception):
    pass


def _eval_jp(expr: str, node: Any, bindings: Optional[Dict[str, Any]] = None) -> Any:
    try:
        return jp_compile(expr).search(node)
    except Exception as e:
        raise AssertionError_(f"jmespath {expr!r}: {e}")


def assert_tree(tree: Any, payload: Any, path: str = "") -> List[str]:
    """Returns a list of failure strings (empty = assertion holds)."""
    fails: List[str] = []
    if isinstance(tree, dict):
        if not isinstance(payload, dict) and not any(
                k.startswith("(") or k.startswith("~") for k in tree
                if isinstance(k, str)):
            return [f"{path or '.'}: expected an object"]
        for k, v in tree.items():
            ks = str(k)
            if ks.startswith("~"):
                # iteration: ~.(expr) or ~.field — assert v against
                # every element of the projected list
                proj = ks[1:]
                if proj.startswith("."):
                    proj = proj[1:]
                if proj.startswith("(") and proj.endswith(")"):
                    proj = proj[1:-1]
                items = _eval_jp(proj, payload) if proj else payload
                if items is None:
                    fails.append(f"{path}/{ks}: nothing to iterate")
                    continue
                if not isinstance(items, list):
                    items = [items]
                for i, item in enumerate(items):
                    fails.extend(assert_tree(v, item, f"{path}/{ks}[{i}]"))
            elif ks.startswith("(") and ks.endswith(")"):
                got = _eval_jp(ks[1:-1], payload)
                fails.extend(assert_tree(v, got, f"{path}/{ks}"))
            else:
                if not isinstance(payload, dict) or ks not in payload:
                    fails.append(f"{path}/{ks}: not found")
                    continue
                fails.extend(assert_tree(v, payload[ks], f"{path}/{ks}"))
        return fails
    if isinstance(tree, list):
        if not isinstance(payload, list):
            return [f"{path or '.'}: expected an array"]
        if len(tree) != len(payload):
            return [f"{path or '.'}: length {len(payload)} != {len(tree)}"]
        for i, (t, p) in enumerate(zip(tree, payload)):
            fails.extend(assert_tree(t, p, f"{path}[{i}]"))
        return fails
    # scalar leaf
    if isinstance(tree, str):
        ok = patternpkg.validate(payload, tree)
    elif isinstance(tree, (bool, int, float)) or tree is None:
        ok = patternpkg.validate(payload, tree)
    else:
        ok = payload == tree
    if not ok:
        return [f"{path or '.'}: {payload!r} does not satisfy {tree!r}"]
    return []


def _gate(block: Optional[Dict[str, Any]], payload: Any) -> bool:
    """match/exclude block: {any: [trees]} / {all: [trees]}."""
    if not block:
        return True
    any_trees = block.get("any") or []
    all_trees = block.get("all") or []
    if any_trees and not any(not assert_tree(t, payload) for t in any_trees):
        return False
    if all_trees and not all(not assert_tree(t, payload) for t in all_trees):
        return False
    return True


class JsonScanResult:
    __slots__ = ("policy", "rule", "index", "status", "failures")

    def __init__(self, policy, rule, index, status, failures):
        self.policy = policy
        self.rule = rule
        self.index = index
        self.status = status
        self.failures = failures

    def to_dict(self) -> Dict[str, Any]:
        return {"policy": self.policy, "rule": self.rule,
                "payload_index": self.index, "result": self.status,
                **({"failures": self.failures} if self.failures else {})}


def scan_payload(
    payloads: List[Any],
    policies: List[Dict[str, Any]],
) -> List[JsonScanResult]:
    """Evaluate ValidatingPolicy documents against payload items."""
    out: List[JsonScanResult] = []
    for pi, payload in enumerate(payloads):
        for pol in policies:
            pname = (pol.get("metadata") or {}).get("name", "")
            for rule in (pol.get("spec") or {}).get("rules") or []:
                rname = rule.get("name", "")
                try:
                    if not _gate(rule.get("match"), payload):
                        continue
                    if rule.get("exclude") and _gate_matches_any(
                            rule["exclude"], payload):
                        continue
                except AssertionError_ as e:
                    out.append(JsonScanResult(pname, rname, pi, "error", [str(e)]))
                    continue
                a = rule.get("assert") or {}
                failures: List[str] = []
                status = "pass"
                try:
                    any_trees = a.get("any") or []
                    all_trees = a.get("all") or []
                    if any_trees:
                        branch_fails = [assert_tree(_tree(t), payload)
                                        for t in any_trees]
                        if not any(not f for f in branch_fails):
                            status = "fail"
                            failures = [f for fs in branch_fails for f in fs]
                    for t in all_trees:
                        f = assert_tree(_tree(t), payload)
                        if f:
                            status = "fail"
                            failures.extend(f)
                except AssertionError_ as e:
                    # bad expressions surface as a per-rule error row,
                    # never as a CLI traceback
                    status = "error"
                    failures = [str(e)]
                out.append(JsonScanResult(pname, rname, pi, status, failures))
    return out


def _tree(entry: Any) -> Any:
    """assert entries may wrap the tree in {check: ..., message: ...}."""
    if isinstance(entry, dict) and "check" in entry:
        return entry["check"]
    return entry


def _gate_matches_any(block: Dict[str, Any], payload: Any) -> bool:
    """exclude semantics: excluded when ANY declared tree matches."""
    for t in (block.get("any") or []):
        if not assert_tree(t, payload):
            return True
    all_trees = block.get("all") or []
    if all_trees and all(not assert_tree(t, payload) for t in all_trees):
        return True
    return False
