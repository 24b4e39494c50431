# Copied verbatim from kyverno_tpu/policy/autogen.py.
"""Autogen — rewrite Pod rules for the seven pod controllers.

Re-implementation of pkg/autogen (autogen.go:236 ComputeRules,
rule.go:73 generateRule, rule.go:308 updateGenRuleByte): Pod-targeted
rules gain `autogen-<name>` variants whose patterns are wrapped under
`spec.template` (and `spec.jobTemplate.spec.template` for CronJob),
with JMESPath references in deny conditions / preconditions / messages
rewritten from `request.object.spec` to the template-shifted paths.

Controller selection follows the reference exactly: the
`pod-policies.kyverno.io/autogen-controllers` annotation filters the
supported set; rules with names, selectors, annotations, or non-Pod
kinds in any match/exclude block disable autogen for the whole spec
(autogen.go:31 checkAutogenSupport).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Tuple

from ..api.policy import ClusterPolicy, Rule

AUTOGEN_ANNOTATION = "pod-policies.kyverno.io/autogen-controllers"
POD_CONTROLLERS = [
    "DaemonSet", "Deployment", "Job", "StatefulSet",
    "ReplicaSet", "ReplicationController", "CronJob",
]
_NON_CRON = [c for c in POD_CONTROLLERS if c != "CronJob"]
_CONTROLLER_SET = set(POD_CONTROLLERS) | {"Pod"}


def _is_kind_other_than_pod(kinds: List[str]) -> bool:
    return len(kinds) > 1 and "Pod" in kinds


def _block_supported(needed: List[bool], block: Dict[str, Any]) -> bool:
    """checkAutogenSupport (autogen.go:31) over one ResourceDescription."""
    rd = block or {}
    if rd.get("name") or rd.get("names") or rd.get("selector") is not None \
            or rd.get("annotations") is not None or _is_kind_other_than_pod(rd.get("kinds") or []):
        return False
    if any(k in _CONTROLLER_SET for k in (rd.get("kinds") or [])):
        needed[0] = True
    return True


def can_auto_gen(spec: Dict[str, Any]) -> Tuple[bool, str]:
    """Port of CanAutoGen (autogen.go:68)."""
    needed = [False]
    for rule in spec.get("rules") or []:
        mutate = rule.get("mutate") or {}
        if mutate.get("patchesJson6902") or rule.get("generate") is not None:
            return False, "none"
        for fe in mutate.get("foreach") or []:
            if fe.get("patchesJson6902"):
                return False, "none"
        for block in (rule.get("match"), rule.get("exclude")):
            block = block or {}
            if not _block_supported(needed, block.get("resources") or {}):
                return False, ""
            for rf in (block.get("any") or []) + (block.get("all") or []):
                if not _block_supported(needed, rf.get("resources") or {}):
                    return False, ""
    if not needed[0]:
        return False, ""
    return True, ",".join(POD_CONTROLLERS)


def _rewrite_refs(rule_dict: Dict[str, Any], kind: str) -> Dict[str, Any]:
    """updateGenRuleByte (rule.go:308): string-level JMESPath shifting."""
    s = json.dumps(rule_dict)
    if kind == "Pod":
        pairs = [
            ("request.object.spec", "request.object.spec.template.spec"),
            ("request.oldObject.spec", "request.oldObject.spec.template.spec"),
            ("request.object.metadata", "request.object.spec.template.metadata"),
            ("request.oldObject.metadata", "request.oldObject.spec.template.metadata"),
        ]
    else:  # Cronjob
        pairs = [
            ("request.object.spec", "request.object.spec.jobTemplate.spec.template.spec"),
            ("request.oldObject.spec", "request.oldObject.spec.jobTemplate.spec.template.spec"),
            ("request.object.metadata", "request.object.spec.jobTemplate.spec.template.metadata"),
            ("request.oldObject.metadata", "request.oldObject.spec.jobTemplate.spec.template.metadata"),
        ]
    for old, new in pairs:
        s = s.replace(old, new)
    return json.loads(s)


def _shift_message_refs(value: str, shift: str, pivot: str) -> str:
    """FindAndShiftReferences (vars.go:474): $() references in validate
    messages get the template shift inserted after the pivot segment."""
    from ..engine.variables import REGEX_REFERENCES

    for m in list(REGEX_REFERENCES.finditer(value or "")):
        old_ref = m.group(0)
        ref = old_ref
        initial = ref[:2] == "$("
        if not initial:
            ref = ref[1:]
        p = pivot
        idx = ref.find(p)
        if p == "anyPattern":
            rule_index = ref[idx + len(p) + 1:].split("/")[0]
            p = p + "/" + rule_index
        shifted = ref.replace(p, p + "/" + shift)
        replacement = ("" if initial else old_ref[0]) + shifted
        value = value.replace(old_ref, replacement, 1)
    return value


def _autogen_name(prefix: str, name: str) -> str:
    out = f"{prefix}-{name}"
    return out[:63]


def _replace_kinds(block: Optional[Dict[str, Any]], kinds: List[str],
                   match_pod_only: bool, is_exclude: bool) -> None:
    """Overwrite Kinds with the controller list (rule.go:81-95,223)."""
    if not block:
        return
    if block.get("any"):
        for rf in block["any"]:
            rd = rf.get("resources") or {}
            if (not match_pod_only) or "Pod" in (rd.get("kinds") or []):
                rd["kinds"] = list(kinds)
    elif block.get("all"):
        for rf in block["all"]:
            rd = rf.get("resources") or {}
            if (not match_pod_only) or "Pod" in (rd.get("kinds") or []):
                rd["kinds"] = list(kinds)
    else:
        rd = block.setdefault("resources", {})
        if is_exclude:
            if rd.get("kinds"):
                rd["kinds"] = list(kinds)
        else:
            rd["kinds"] = list(kinds)


def _wrap(tpl_key: str, value: Any) -> Dict[str, Any]:
    return {"spec": {tpl_key: value}}


def _generate_rule(name: str, rule: Dict[str, Any], tpl_key: str, shift: str,
                   kinds: List[str], match_pod_only: bool) -> Optional[Dict[str, Any]]:
    """generateRule (rule.go:73) over the raw rule dict."""
    rule = copy.deepcopy(rule)
    rule["name"] = name
    _replace_kinds(rule.get("match"), kinds, match_pod_only, is_exclude=False)
    _replace_kinds(rule.get("exclude"), kinds, match_pod_only, is_exclude=True)

    mutate = rule.get("mutate") or {}
    if mutate.get("patchStrategicMerge") is not None:
        rule["mutate"] = {"patchStrategicMerge": _wrap(tpl_key, mutate["patchStrategicMerge"])}
        return rule
    if mutate.get("foreach"):
        out = []
        for fe in mutate["foreach"]:
            nfe = {k: v for k, v in fe.items()
                   if k in ("list", "context", "preconditions")}
            nfe["patchStrategicMerge"] = _wrap(tpl_key, fe.get("patchStrategicMerge"))
            out.append(nfe)
        rule["mutate"] = {"foreach": out}
        return rule

    validate = rule.get("validate") or {}
    if validate.get("pattern") is not None:
        rule["validate"] = {
            "message": _shift_message_refs(validate.get("message", ""), shift, "pattern"),
            "pattern": _wrap(tpl_key, validate["pattern"]),
        }
        return rule
    if validate.get("deny") is not None:
        rule["validate"] = {
            "message": _shift_message_refs(validate.get("message", ""), shift, "deny"),
            "deny": validate["deny"],
        }
        return rule
    if validate.get("podSecurity") is not None:
        rule["validate"] = {
            "message": _shift_message_refs(validate.get("message", ""), shift, "podSecurity"),
            "podSecurity": copy.deepcopy(validate["podSecurity"]),
        }
        return rule
    if validate.get("anyPattern") is not None:
        rule["validate"] = {
            "message": _shift_message_refs(validate.get("message", ""), shift, "anyPattern"),
            "anyPattern": [_wrap(tpl_key, p) for p in validate["anyPattern"]],
        }
        return rule
    if validate.get("foreach"):
        rule["validate"] = {
            "message": _shift_message_refs(validate.get("message", ""), shift, "pattern"),
            "foreach": copy.deepcopy(validate["foreach"]),
        }
        return rule
    if rule.get("verifyImages"):
        return rule
    if validate.get("cel") is not None:
        return rule
    return None


def _kinds_of(block: Optional[Dict[str, Any]]) -> List[str]:
    block = block or {}
    kinds = list((block.get("resources") or {}).get("kinds") or [])
    for rf in (block.get("any") or []) + (block.get("all") or []):
        kinds.extend((rf.get("resources") or {}).get("kinds") or [])
    return kinds


def _rule_for_controllers(rule: Dict[str, Any], controllers: str) -> Optional[Dict[str, Any]]:
    """generateRuleForControllers (rule.go:233)."""
    if rule.get("name", "").startswith("autogen-") or not controllers:
        return None
    match_kinds = _kinds_of(rule.get("match"))
    exclude_kinds = _kinds_of(rule.get("exclude"))
    if "Pod" not in match_kinds or (exclude_kinds and "Pod" not in exclude_kinds):
        return None
    if controllers == "all":
        controllers = ",".join(_NON_CRON)
    else:
        validated = [c for c in controllers.split(",") if c in _NON_CRON]
        if validated:
            controllers = ",".join(validated)
    kinds = [c for c in controllers.split(",") if c]
    if not kinds:
        return None
    return _generate_rule(_autogen_name("autogen", rule["name"]), rule,
                          "template", "spec/template", kinds, match_pod_only=True)


def _cronjob_rule(rule: Dict[str, Any], controllers: str) -> Optional[Dict[str, Any]]:
    """generateCronJobRule (rule.go:286)."""
    if "CronJob" not in controllers and "all" not in controllers:
        return None
    base = _rule_for_controllers(rule, controllers)
    if base is None:
        return None
    return _generate_rule(_autogen_name("autogen-cronjob", rule["name"]), base,
                          "jobTemplate", "spec/jobTemplate/spec/template",
                          ["CronJob"], match_pod_only=False)


def compute_rule_dicts(policy_dict: Dict[str, Any]) -> List[Dict[str, Any]]:
    """ComputeRules (autogen.go:236) over raw dicts: original rules plus
    generated controller variants."""
    spec = policy_dict.get("spec") or {}
    rules = list(spec.get("rules") or [])
    apply_autogen, desired = can_auto_gen(spec)
    annotations = (policy_dict.get("metadata") or {}).get("annotations") or {}
    # key PRESENCE matters: an explicitly empty annotation disables
    # autogen (autogen.go:247 `ok` check), absence means "all supported"
    if AUTOGEN_ANNOTATION in annotations and apply_autogen:
        actual = annotations[AUTOGEN_ANNOTATION]
    else:
        actual = desired
    if not apply_autogen or actual == "none":
        return rules
    strip = ",".join(c for c in actual.split(",") if c != "CronJob") \
        if actual != "all" else actual
    gen: List[Dict[str, Any]] = []
    for rule in rules:
        g = _rule_for_controllers(rule, strip)
        if g is not None:
            gen.append(_rewrite_refs(g, "Pod"))
        c = _cronjob_rule(rule, actual)
        if c is not None:
            gen.append(_rewrite_refs(c, "Cronjob"))
    if not gen:
        return rules
    return rules + gen


def compute_rules(policy: ClusterPolicy) -> List[Rule]:
    return [Rule.from_dict(r) for r in compute_rule_dicts(policy.raw)]


def expand_policy(policy: ClusterPolicy) -> ClusterPolicy:
    """Return a policy whose spec.rules include the autogen variants."""
    raw = copy.deepcopy(policy.raw)
    raw.setdefault("spec", {})["rules"] = compute_rule_dicts(raw)
    return ClusterPolicy.from_dict(raw)
