# Copied verbatim from kyverno_tpu/policy/validation.py.
"""Policy object validation (pkg/validation/policy/validate.go).

Validates policies at admission/load time: structural rules (unique
rule names, exactly one rule type, non-empty match), the variable
whitelist with background-mode safety (background policies may not use
admission-request variables, background.go), and pattern sanity
(anchors on scalar leaves, operator spelling). Returns a list of
error strings; empty means valid. Warnings are returned separately.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Set, Tuple

from ..api.policy import ClusterPolicy
from ..engine.anchor import parse as parse_anchor
from ..engine.variables import REGEX_VARIABLES

# allowed_vars (pkg/validation/policy/validate.go ValidateVariables):
# everything the engine seeds plus rule context entry names
_ALLOWED_PREFIXES = (
    "request.", "element", "elementIndex", "@", "images", "image",
    "serviceAccountName", "serviceAccountNamespace", "target.",
    "globalContext.",
)
# background policies cannot see admission request data (background.go)
_BACKGROUND_FORBIDDEN = re.compile(
    r"^request\.(userInfo|roles|clusterRoles)\b")


def _iter_variables(tree: Any):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_variables(k)
            yield from _iter_variables(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _iter_variables(v)
    elif isinstance(tree, str):
        for m in REGEX_VARIABLES.finditer(tree):
            yield m.group(2)[2:-2].strip()


def _rule_types(rule: Dict[str, Any]) -> List[str]:
    out = []
    for key in ("validate", "mutate", "generate", "verifyImages"):
        if rule.get(key) is not None:
            out.append(key)
    return out


def _validate_body_types(v: Dict[str, Any]) -> List[str]:
    bodies = [k for k in ("pattern", "anyPattern", "deny", "foreach",
                          "podSecurity", "cel", "manifests") if v.get(k) is not None]
    errs = []
    if len(bodies) == 0:
        errs.append("validate rule requires one of pattern/anyPattern/deny/"
                    "foreach/podSecurity/cel/manifests")
    if len(bodies) > 1:
        errs.append(f"validate rule may declare only one body, found {bodies}")
    return errs


def _check_match_block(rule: Dict[str, Any]) -> List[str]:
    match = rule.get("match") or {}
    blocks = []
    if match.get("any"):
        blocks = [rf.get("resources") or {} for rf in match["any"]]
    elif match.get("all"):
        blocks = [rf.get("resources") or {} for rf in match["all"]]
    else:
        blocks = [match.get("resources") or {}]
    errs = []
    user_blocks = [match] + list(match.get("any") or []) + list(match.get("all") or [])
    has_user = any(b.get("subjects") or b.get("roles") or b.get("clusterRoles")
                   for b in user_blocks)
    if not has_user and all(not any(b.get(f) for f in (
            "kinds", "name", "names", "namespaces", "annotations",
            "selector", "namespaceSelector", "operations")) for b in blocks):
        errs.append(f"rule {rule.get('name')!r}: match block cannot be empty")
    # subject kinds (user_info_types.go:38 ValidateSubjects) — match
    # and exclude both carry UserInfo, at top level and per any/all
    exclude = rule.get("exclude") or {}
    for b in user_blocks + [exclude] + list(exclude.get("any") or []) \
            + list(exclude.get("all") or []):
        for subject in b.get("subjects") or []:
            kind = subject.get("kind", "")
            if not subject.get("name"):
                errs.append(f"rule {rule.get('name')!r}: subject name is "
                            f"required")
            if kind not in ("User", "Group", "ServiceAccount"):
                errs.append(f"rule {rule.get('name')!r}: subject kind must be "
                            f"'User', 'Group', or 'ServiceAccount', got {kind!r}")
            elif kind == "ServiceAccount" and not subject.get("namespace"):
                errs.append(f"rule {rule.get('name')!r}: namespace is required "
                            f"when subject kind is ServiceAccount")
    return errs


# bare kinds that only exist as subresources (discovery would report
# them with a parent resource; validate.go:1462 rejects them for
# background scans — there is no parent object to scan)
_SUBRESOURCE_ONLY_KINDS = frozenset({
    "Scale", "Eviction", "PodExecOptions", "PodAttachOptions",
    "PodPortForwardOptions", "PodProxyOptions", "NodeProxyOptions",
    "ServiceProxyOptions", "TokenRequest", "Binding",
    "LocalSubjectAccessReview",
})


def _check_background_subresources(rule: Dict[str, Any],
                                   errs: List[str]) -> None:
    """validate.go:1447 checkForScanSubresource: background scans
    cannot target subresources."""
    from ..utils.kube import parse_kind_selector

    match = rule.get("match") or {}
    blocks = ([match.get("resources") or {}]
              + [rf.get("resources") or {} for rf in match.get("any") or []]
              + [rf.get("resources") or {} for rf in match.get("all") or []])
    for b in blocks:
        for k in b.get("kinds") or []:
            _, _, kind, subresource = parse_kind_selector(str(k))
            if subresource or kind in _SUBRESOURCE_ONLY_KINDS:
                errs.append(f"background scan enabled with subresource {k}")


def _check_pattern_anchors(pattern: Any, path: str, errs: List[str]) -> None:
    if isinstance(pattern, dict):
        for k, v in pattern.items():
            a = parse_anchor(str(k))
            if a is not None and a.modifier == "+":
                errs.append(f"addIfNotPresent anchor +() is a mutate anchor, "
                            f"not valid in validate patterns (at {path}/{k})")
            _check_pattern_anchors(v, f"{path}/{k}", errs)
    elif isinstance(pattern, list):
        for i, v in enumerate(pattern):
            _check_pattern_anchors(v, f"{path}/{i}", errs)


# api/kyverno/v1/common_types.go:278-297 — the 18 condition operators
_CONDITION_OPERATORS = {
    "Equal", "Equals", "NotEqual", "NotEquals", "In", "AnyIn", "AllIn",
    "NotIn", "AnyNotIn", "AllNotIn", "GreaterThanOrEquals", "GreaterThan",
    "LessThanOrEquals", "LessThan", "DurationGreaterThanOrEquals",
    "DurationGreaterThan", "DurationLessThanOrEquals", "DurationLessThan",
}

_REQUEST_OPERATIONS = {"CREATE", "UPDATE", "DELETE", "CONNECT"}

# exactly one source per context entry (validateRuleContext,
# validate.go:1184)
_CONTEXT_SOURCES = ("configMap", "apiCall", "imageRegistry", "variable",
                    "globalReference")

# names the engine seeds itself; context entries may not shadow them
_RESERVED_CONTEXT_NAMES = {"request", "element", "elementIndex", "images",
                           "image", "serviceAccountName",
                           "serviceAccountNamespace", "target"}

_JSON_PATCH_OPS = {"add", "remove", "replace", "move", "copy", "test"}


def _iter_conditions(node: Any):
    """Yield {key, operator, value} condition dicts from any/all trees
    or legacy flat lists."""
    if isinstance(node, dict):
        if "operator" in node or "key" in node:
            yield node
        for sub in (node.get("any"), node.get("all")):
            if isinstance(sub, list):
                for c in sub:
                    yield from _iter_conditions(c)
    elif isinstance(node, list):
        for c in node:
            yield from _iter_conditions(c)


def _check_conditions(node: Any, where: str, errs: List[str]) -> None:
    """validateConditions (validate.go:1004): operator must be one of
    the 18; {{request.operation}} values constrained to the four
    admission operations (validate.go:1139)."""
    for c in _iter_conditions(node):
        op = c.get("operator", "")
        if op and op not in _CONDITION_OPERATORS:
            errs.append(f"{where}: invalid condition operator {op!r}")
        key = c.get("key")
        if isinstance(key, str) and key.replace(" ", "") == "{{request.operation}}":
            values = c.get("value")
            values = values if isinstance(values, list) else [values]
            for v in values:
                if isinstance(v, str) and v.startswith("{{") and v.endswith("}}"):
                    continue
                if v not in _REQUEST_OPERATIONS:
                    errs.append(
                        f"{where}: unknown value {v!r} for "
                        f"{{{{request.operation}}}}; allowed: "
                        f"[CREATE, UPDATE, DELETE, CONNECT]")


def _check_context_entries(rule: Dict[str, Any], errs: List[str]) -> None:
    """validateRuleContext (validate.go:1184): one source per entry,
    no reserved names, apiCall/variable field sanity."""
    name = rule.get("name") or ""
    for entry in rule.get("context") or []:
        ename = entry.get("name") or ""
        if not ename:
            errs.append(f"rule {name!r}: context entry without a name")
        if ename in _RESERVED_CONTEXT_NAMES:
            errs.append(f"rule {name!r}: context entry name {ename!r} "
                        f"shadows a reserved variable")
        sources = [s for s in _CONTEXT_SOURCES if entry.get(s) is not None]
        if len(sources) != 1:
            errs.append(
                f"rule {name!r}: context entry {ename!r} requires exactly "
                f"one of {'/'.join(_CONTEXT_SOURCES)}, found {sources or 'none'}")
            continue
        if sources == ["variable"]:
            var = entry["variable"] or {}
            if var.get("value") is None and not var.get("jmesPath"):
                errs.append(f"rule {name!r}: variable context entry "
                            f"{ename!r} requires value or jmesPath")
        if sources == ["apiCall"]:
            call = entry["apiCall"] or {}
            if not call.get("urlPath") and not (call.get("service") or {}).get("url"):
                errs.append(f"rule {name!r}: apiCall context entry "
                            f"{ename!r} requires urlPath or service.url")
            if call.get("urlPath") and (call.get("service") or {}).get("url"):
                errs.append(f"rule {name!r}: apiCall context entry "
                            f"{ename!r} cannot have both urlPath and service")


def _check_mutate_existing(raw_spec: Dict[str, Any], rule: Dict[str, Any],
                           errs: List[str]) -> None:
    """Mutate-existing validation (pkg/validation/policy):
    - mutateExistingOnPolicyUpdate requires every mutate rule to
      declare targets (there is no admission object to mutate);
    - target selectors may not reference {{ target.* }} — the target
      is not resolved until after selection."""
    name = rule.get("name") or ""
    mutate = rule.get("mutate") or {}
    if not mutate:
        return
    targets = mutate.get("targets")
    if raw_spec.get("mutateExistingOnPolicyUpdate") and not targets:
        errs.append(f"rule {name!r}: mutateExistingOnPolicyUpdate requires "
                    f"mutate.targets")
    for i, t in enumerate(targets or []):
        for field_name in ("name", "namespace", "apiVersion", "kind"):
            val = t.get(field_name)
            if isinstance(val, str) and ("{{target." in val.replace(" ", "")):
                errs.append(
                    f"rule {name!r}: mutate.targets[{i}].{field_name} may "
                    f"not reference target.* variables (unresolved at "
                    f"target selection)")


def _check_json_patch(rule: Dict[str, Any], errs: List[str]) -> None:
    """validateJSONPatch (validate.go:87): op/path shape, no variables
    in the path section (validate.go:590)."""
    import yaml as _yaml

    name = rule.get("name") or ""
    mutate = rule.get("mutate") or {}
    patch = mutate.get("patchesJson6902")
    if not patch:
        return
    try:
        ops = _yaml.safe_load(patch) if isinstance(patch, str) else patch
    except _yaml.YAMLError as e:
        errs.append(f"rule {name!r}: invalid patchesJson6902: {e}")
        return
    if not isinstance(ops, list):
        errs.append(f"rule {name!r}: patchesJson6902 must be a list")
        return
    for i, op in enumerate(ops):
        if not isinstance(op, dict):
            errs.append(f"rule {name!r}: patchesJson6902[{i}] must be a map")
            continue
        if op.get("op") not in _JSON_PATCH_OPS:
            errs.append(f"rule {name!r}: patchesJson6902[{i}] has invalid "
                        f"op {op.get('op')!r}")
        path = op.get("path", "")
        if not isinstance(path, str) or not path.startswith("/"):
            errs.append(f"rule {name!r}: patchesJson6902[{i}] path must "
                        f"start with '/'")
        elif REGEX_VARIABLES.search(path):
            errs.append(f"rule {name!r}: variables are not allowed in "
                        f"patchesJson6902 path")


def _check_forbidden_variables(rule: Dict[str, Any], errs: List[str]) -> None:
    """ruleForbiddenSectionsHaveVariables (validate.go:528): match,
    exclude and verifyImages imageReferences may not contain
    variables."""
    name = rule.get("name") or ""
    for section in ("match", "exclude"):
        for var in _iter_variables(rule.get(section) or {}):
            if var.strip().startswith("element"):
                continue
            errs.append(f"rule {name!r}: variables are not allowed in the "
                        f"{section} section ({{{{{var}}}}})")
            break
    for iv in rule.get("verifyImages") or []:
        for ref in (iv.get("imageReferences") or []):
            if isinstance(ref, str) and REGEX_VARIABLES.search(ref):
                errs.append(f"rule {name!r}: variables are not allowed in "
                            f"image reference {ref!r}")


def _check_generate(rule: Dict[str, Any], errs: List[str],
                    auth_checker=None) -> None:
    """generate-rule structure + CanIGenerate permission seam
    (validate.go generate checks, pkg/auth CanI)."""
    name = rule.get("name") or ""
    gen = rule.get("generate")
    if gen is None:
        return
    has_data = gen.get("data") is not None
    has_clone = bool(gen.get("clone")) or bool(gen.get("cloneList"))
    if has_data == has_clone:
        errs.append(f"rule {name!r}: generate requires exactly one of "
                    f"data or clone/cloneList")
    if not gen.get("kind") and not gen.get("cloneList"):
        # cloneList carries its kinds inside the block
        errs.append(f"rule {name!r}: generate requires kind")
    if not gen.get("name") and not gen.get("cloneList"):
        errs.append(f"rule {name!r}: generate requires name")
    clone = gen.get("clone") or {}
    if clone and not clone.get("name"):
        errs.append(f"rule {name!r}: generate clone requires name")
    if auth_checker is not None and gen.get("kind"):
        for verb in ("create", "update", "delete", "get"):
            if not auth_checker(verb, gen.get("kind", ""),
                                gen.get("namespace", "")):
                errs.append(
                    f"rule {name!r}: controller lacks {verb!r} permission "
                    f"for generated kind {gen.get('kind')!r} "
                    f"(CanIGenerate)")
                break


def _check_kinds_resolvable(policy: ClusterPolicy, rule: Dict[str, Any],
                            kind_resolver, errors: List[str]) -> None:
    """validKinds (validate.go:1384,1404): every non-wildcard kind must
    resolve against discovery, and a namespaced Policy cannot match
    cluster-scoped resources. `kind_resolver(selector)` returns
    'Namespaced' | 'Cluster' | None (unknown)."""
    namespaced = policy.raw.get("kind") == "Policy"
    kinds: List[str] = []
    for block_name in ("match", "exclude"):
        block = rule.get(block_name) or {}
        kinds.extend((block.get("resources") or {}).get("kinds") or [])
        for rf in (block.get("any") or []) + (block.get("all") or []):
            kinds.extend((rf.get("resources") or {}).get("kinds") or [])
    from ..utils.kube import parse_kind_selector

    for k in kinds:
        if parse_kind_selector(k)[2] == "*":
            continue  # wildcard KINDS bypass discovery (validateKinds);
            # 'Foo/*' still resolves Foo
        scope = kind_resolver(k)
        if scope is None:
            errors.append(f"unable to convert GVK to GVR for kinds {k}")
        elif namespaced and scope == "Cluster":
            errors.append(f"namespaced policy cannot match cluster-scoped "
                          f"resource kind {k}")


def validate_policy(policy: ClusterPolicy,
                    extra_allowed: Tuple[str, ...] = (),
                    auth_checker=None,
                    kind_resolver=None) -> Tuple[List[str], List[str]]:
    """Returns (errors, warnings)."""
    errors: List[str] = []
    warnings: List[str] = []
    raw = policy.raw
    if not policy.name:
        errors.append("policy has no name")
    spec = raw.get("spec") or {}
    rules = spec.get("rules") or []
    if not rules:
        errors.append("policy has no rules")
    seen: Set[str] = set()
    background = spec.get("background", True)
    admission = spec.get("admission", True)
    # spec-level gates (pkg/validation/policy/validate.go:211-218,
    # api/kyverno/v1/spec_types.go:339)
    if not admission and not background:
        errors.append("disabling both admission and background processing "
                      "is not allowed")
    if not admission and any(
            r.get("mutate") or r.get("generate") or r.get("verifyImages")
            for r in rules):
        errors.append("disabling admission processing is only allowed with "
                      "validation policies")
    timeout = spec.get("webhookTimeoutSeconds")
    if timeout is not None and not (isinstance(timeout, int)
                                    and not isinstance(timeout, bool)
                                    and 1 <= timeout <= 30):
        errors.append("the timeout value must be between 1 and 30 seconds")
    for rule in rules:
        name = rule.get("name") or ""
        if not name:
            errors.append("rule without a name")
        if name in seen:
            errors.append(f"duplicate rule name {name!r}")
        seen.add(name)
        if len(name) > 63:
            errors.append(f"rule name {name!r} exceeds 63 characters")
        types = _rule_types(rule)
        if len(types) != 1:
            errors.append(
                f"rule {name!r} must define exactly one of validate/mutate/"
                f"generate/verifyImages, found {types or 'none'}")
        errors.extend(_check_match_block(rule))
        if kind_resolver is not None:
            _check_kinds_resolvable(policy, rule, kind_resolver, errors)
        # validate.go:1459: subresource kinds only invalid for VALIDATE
        # rules under background scanning
        if background and rule.get("validate") is not None:
            _check_background_subresources(rule, errors)
        # rule-level context entries and preconditions run before any
        # target binds, so {{target.*}} references there can never
        # resolve (validate.go:46 allowed-variable split for targets)
        rule_scope = {"context": rule.get("context") or [],
                      "preconditions": rule.get("preconditions")}
        if "{{target." in json.dumps(rule_scope, default=str).replace(" ", ""):
            errors.append(f"rule {name!r}: target.* variables are only "
                          f"allowed inside mutate.targets")
        _check_context_entries(rule, errors)
        _check_json_patch(rule, errors)
        _check_mutate_existing(spec, rule, errors)
        _check_forbidden_variables(rule, errors)
        _check_generate(rule, errors, auth_checker)
        _check_conditions(rule.get("preconditions"),
                          f"rule {name!r} preconditions", errors)
        v = rule.get("validate")
        if v is not None:
            errors.extend(f"rule {name!r}: {e}" for e in _validate_body_types(v))
            if v.get("pattern") is not None:
                _check_pattern_anchors(v["pattern"], "pattern", errors)
            for p in v.get("anyPattern") or []:
                _check_pattern_anchors(p, "anyPattern", errors)
            deny = v.get("deny") or {}
            _check_conditions(deny.get("conditions"),
                              f"rule {name!r} deny conditions", errors)
            for fe in v.get("foreach") or []:
                _check_conditions((fe.get("deny") or {}).get("conditions"),
                                  f"rule {name!r} foreach deny", errors)
                _check_conditions(fe.get("preconditions"),
                                  f"rule {name!r} foreach preconditions",
                                  errors)
        # variable whitelist
        context_names = tuple(
            (c.get("name") or "") for c in (rule.get("context") or []))
        allowed = _ALLOWED_PREFIXES + context_names + extra_allowed
        for var in set(_iter_variables(rule)):
            base = var.split("|")[0].strip()
            if base.startswith("\"") or base.startswith("'"):
                continue
            root = re.split(r"[.\[(]", base, 1)[0]
            if not any(base.startswith(p) or root == p.rstrip(".")
                       for p in allowed):
                warnings.append(
                    f"rule {name!r}: variable {{{{{var}}}}} is not in the "
                    f"allowed list and will fail policy admission")
            if background and _BACKGROUND_FORBIDDEN.match(base):
                errors.append(
                    f"rule {name!r}: background policies cannot reference "
                    f"admission request data ({{{{{var}}}}}); set "
                    f"spec.background=false")
    return errors, warnings
