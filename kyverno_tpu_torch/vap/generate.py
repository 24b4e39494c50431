# Copied verbatim from kyverno_tpu/vap/generate.py.
"""Kyverno -> ValidatingAdmissionPolicy generation.

Translates a ClusterPolicy whose single rule uses validate.cel into a
Kubernetes ValidatingAdmissionPolicy + ValidatingAdmissionPolicyBinding
pair, so clusters can enforce the policy natively in the apiserver.

Mirrors the reference:
- eligibility: pkg/validatingadmissionpolicy/kyvernopolicy_checker.go:8
  CanGenerateVAP (single rule, CEL-only, no exclude, no user-info, no
  namespaces/annotations in resource descriptions, at most one
  namespace/object selector across `any`, at most one `all` entry);
- object construction: pkg/validatingadmissionpolicy/builder.go:17
  BuildValidatingAdmissionPolicy / :69 ...PolicyBinding (owner refs,
  managed-by label, group/version/resource translation with rule
  merging on shared group+version, operation defaults CREATE+UPDATE);
- reconcile shape: pkg/controllers/validatingadmissionpolicy-generate/
  controller.go:287 (VAP named after the policy, binding "<name>-
  binding", exceptions suppress generation, ineligible policies delete
  any previously generated pair).

Round-trip property (tested): evaluating the generated VAP with
vap/policy.validate_vap agrees with the scalar engine's verdict for
the source Kyverno rule over a resource corpus.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..api.policy import ClusterPolicy, MatchResources, ResourceDescription, UserInfo
from ..utils.kube import parse_kind_selector
from .policy import kind_to_resource

MANAGED_BY_LABEL = {"app.kubernetes.io/managed-by": "kyverno"}


def can_generate_vap(policy: ClusterPolicy) -> Tuple[bool, str]:
    """kyvernopolicy_checker.go:8 CanGenerateVAP."""
    spec = policy.spec
    rules = spec.rules
    if len(rules) > 1:
        return False, ("skip generating ValidatingAdmissionPolicy: "
                       "multiple rules aren't applicable.")
    if not rules:
        return False, "skip generating ValidatingAdmissionPolicy: no rules."
    rule = rules[0]
    if not (rule.validation and rule.validation.cel):
        return False, ("skip generating ValidatingAdmissionPolicy for "
                       "non CEL rules.")
    overrides = spec.raw.get("validationFailureActionOverrides") or []
    if len(overrides) > 1:
        return False, ("skip generating ValidatingAdmissionPolicy: multiple "
                       "validationFailureActionOverrides aren't applicable.")
    if overrides and overrides[0].get("namespaces"):
        return False, ("skip generating ValidatingAdmissionPolicy: Namespaces "
                       "in validationFailureActionOverrides isn't applicable.")
    match, exclude = rule.match, rule.exclude
    if (not exclude.user_info.is_empty() or not exclude.resources.is_empty()
            or exclude.any or exclude.all):
        return False, ("skip generating ValidatingAdmissionPolicy: Exclude "
                       "isn't applicable.")
    ok, msg = _check_user_info(match.user_info)
    if not ok:
        return False, msg
    ok, msg = _check_resources(match.resources)
    if not ok:
        return False, msg
    contains_ns_sel = contains_obj_sel = False
    for f in match.any:
        ok, msg = _check_user_info(f.user_info)
        if not ok:
            return False, msg
        ok, msg = _check_resources(f.resources)
        if not ok:
            return False, msg
        if f.resources.namespace_selector is not None:
            if contains_ns_sel:
                return False, ("skip generating ValidatingAdmissionPolicy: "
                               "multiple NamespaceSelector across 'any' "
                               "aren't applicable.")
            contains_ns_sel = True
        if f.resources.selector is not None:
            if contains_obj_sel:
                return False, ("skip generating ValidatingAdmissionPolicy: "
                               "multiple ObjectSelector across 'any' aren't "
                               "applicable.")
            contains_obj_sel = True
    if match.all:
        if len(match.all) > 1:
            return False, ("skip generating ValidatingAdmissionPolicy: "
                           "multiple 'all' isn't applicable.")
        ok, msg = _check_user_info(match.all[0].user_info)
        if not ok:
            return False, msg
        ok, msg = _check_resources(match.all[0].resources)
        if not ok:
            return False, msg
    return True, ""


def _check_resources(res: ResourceDescription) -> Tuple[bool, str]:
    if res.namespaces or res.annotations:
        return False, ("skip generating ValidatingAdmissionPolicy: Namespaces "
                       "/ Annotations in resource description isn't "
                       "applicable.")
    return True, ""


def _check_user_info(info: UserInfo) -> Tuple[bool, str]:
    if not info.is_empty():
        return False, ("skip generating ValidatingAdmissionPolicy: Roles / "
                       "ClusterRoles / Subjects in `any/all` isn't "
                       "applicable.")
    return True, ""


# -- builder (builder.go) ----------------------------------------------------

# minimal discovery analogue: version defaults per well-known group
# (builder.go uses the discovery client; offline, group membership of
# the kind is the available signal)
_KIND_GROUPS = {
    "Deployment": ("apps", "v1"), "StatefulSet": ("apps", "v1"),
    "DaemonSet": ("apps", "v1"), "ReplicaSet": ("apps", "v1"),
    "Job": ("batch", "v1"), "CronJob": ("batch", "v1"),
    "Ingress": ("networking.k8s.io", "v1"),
    "NetworkPolicy": ("networking.k8s.io", "v1"),
    "Role": ("rbac.authorization.k8s.io", "v1"),
    "RoleBinding": ("rbac.authorization.k8s.io", "v1"),
    "ClusterRole": ("rbac.authorization.k8s.io", "v1"),
    "ClusterRoleBinding": ("rbac.authorization.k8s.io", "v1"),
    "HorizontalPodAutoscaler": ("autoscaling", "v2"),
    "PodDisruptionBudget": ("policy", "v1"),
}


_CORE_KINDS = frozenset({
    "Pod", "Service", "ConfigMap", "Secret", "Namespace", "Node",
    "PersistentVolume", "PersistentVolumeClaim", "ServiceAccount",
    "Endpoints", "Event", "LimitRange", "ResourceQuota",
    "ReplicationController", "PodTemplate",
})


def _resolve_gvr(kind_selector: str) -> Tuple[str, str, str]:
    group, version, kind, subresource = parse_kind_selector(kind_selector)
    unspecified = group in ("", "*")
    if unspecified and kind in _KIND_GROUPS:
        group, default_version = _KIND_GROUPS[kind]
        if version in ("", "*"):
            version = default_version
    elif unspecified and kind in _CORE_KINDS:
        group = ""
        if version in ("", "*"):
            version = "v1"
    resource = kind_to_resource(kind)
    if subresource:
        resource = f"{resource}/{subresource}"
    return group, version or "*", resource


def _translate_ops(operations: List[str]) -> List[str]:
    ops = [op for op in ("CREATE", "UPDATE", "CONNECT", "DELETE")
           if op in (operations or [])]
    # required field in VAPs: default CREATE+UPDATE (builder.go:189)
    return ops or ["CREATE", "UPDATE"]


def _translate_resource(res: ResourceDescription, match: Dict[str, Any],
                        rules: List[Dict[str, Any]]) -> None:
    ops = _translate_ops(res.operations)
    for kind_sel in res.kinds:
        group, version, resource = _resolve_gvr(kind_sel)
        # merge into an existing rule sharing group+version
        # (builder.go:150) — but ONLY when the operations also agree:
        # the reference merges on group+version alone, which silently
        # drops the merged entry's operations (a correctness bug we
        # deliberately do not replicate)
        for r in rules:
            if (group in r["apiGroups"] and version in r["apiVersions"]
                    and r["operations"] == list(ops)):
                if resource not in r["resources"]:
                    r["resources"].append(resource)
                break
        else:
            rules.append({
                "apiGroups": [group], "apiVersions": [version],
                "resources": [resource], "operations": list(ops),
            })
    match["resourceRules"] = rules
    if res.namespace_selector is not None:
        match["namespaceSelector"] = res.namespace_selector
    if res.selector is not None:
        match["objectSelector"] = res.selector


def build_vap(policy: ClusterPolicy) -> Dict[str, Any]:
    """builder.go:17 BuildValidatingAdmissionPolicy."""
    rule = policy.spec.rules[0]
    cel = rule.validation.cel or {}
    match: Dict[str, Any] = {}
    rules: List[Dict[str, Any]] = []
    if not rule.match.resources.is_empty():
        _translate_resource(rule.match.resources, match, rules)
    for f in rule.match.any:
        _translate_resource(f.resources, match, rules)
    for f in rule.match.all:
        _translate_resource(f.resources, match, rules)
    spec: Dict[str, Any] = {
        "matchConstraints": match,
        "validations": cel.get("expressions") or [],
        # apiserver-defaulted field the conformance asserts observe
        "failurePolicy": policy.spec.failure_policy or "Fail",
    }
    if cel.get("paramKind") is not None:
        spec["paramKind"] = cel["paramKind"]
    if cel.get("variables"):
        spec["variables"] = cel["variables"]
    if cel.get("auditAnnotations"):
        spec["auditAnnotations"] = cel["auditAnnotations"]
    if rule.cel_preconditions:
        spec["matchConditions"] = rule.cel_preconditions
    return {
        "apiVersion": "admissionregistration.k8s.io/v1alpha1",
        "kind": "ValidatingAdmissionPolicy",
        "metadata": {
            "name": policy.name,
            "labels": dict(MANAGED_BY_LABEL),
            "ownerReferences": [_owner_ref(policy)],
        },
        "spec": spec,
    }


def build_vap_binding(policy: ClusterPolicy) -> Dict[str, Any]:
    """builder.go:69 BuildValidatingAdmissionPolicyBinding."""
    rule = policy.spec.rules[0]
    cel = rule.validation.cel or {}
    action = (policy.spec.validation_failure_action or "Audit").lower()
    actions = ["Deny"] if action.startswith("enforce") else ["Audit", "Warn"]
    spec: Dict[str, Any] = {
        "policyName": policy.name,
        "validationActions": actions,
    }
    if cel.get("paramRef") is not None:
        spec["paramRef"] = cel["paramRef"]
    return {
        "apiVersion": "admissionregistration.k8s.io/v1alpha1",
        "kind": "ValidatingAdmissionPolicyBinding",
        "metadata": {
            "name": vap_binding_name(policy.name),
            "labels": dict(MANAGED_BY_LABEL),
            "ownerReferences": [_owner_ref(policy)],
        },
        "spec": spec,
    }


def vap_binding_name(vap_name: str) -> str:
    return vap_name + "-binding"  # controller.go:283


def _owner_ref(policy: ClusterPolicy) -> Dict[str, Any]:
    kind = policy.raw.get("kind") or ("Policy" if policy.namespace else "ClusterPolicy")
    return {"apiVersion": "kyverno.io/v1", "kind": kind,
            "name": policy.name,
            "uid": (policy.raw.get("metadata") or {}).get("uid", "")}


class VapGenerateController:
    """Reconciles generated VAP/binding pairs into a sink (the
    in-memory ClusterSnapshot stands in for the apiserver).

    controller.go:287 reconcile: eligible policy -> upsert pair;
    ineligible / exception-covered / deleted policy -> delete pair and
    record the skip reason in status."""

    def __init__(self, sink, exceptions: Optional[List[Any]] = None):
        self.sink = sink
        self.exceptions = list(exceptions or [])
        self.status: Dict[str, Tuple[bool, str]] = {}  # policy -> (generated, msg)

    def _has_exception(self, policy: ClusterPolicy) -> bool:
        from ..api.exception import PolicyException

        for e in self.exceptions:
            typed = e if isinstance(e, PolicyException) else PolicyException.from_dict(e)
            for rule in policy.get_rules():
                if typed.contains(policy.name, rule.name):
                    return True
        return False

    def reconcile(self, policy: ClusterPolicy) -> None:
        if not any(r.has_validate() for r in policy.get_rules()):
            # a policy UPDATED away from validate rules must retract
            # its previously generated pair, not keep stale state
            self._delete_pair(policy.name)
            self.status[policy.name] = (False, "no validate rules")
            return
        ok, msg = can_generate_vap(policy)
        if ok and self._has_exception(policy):
            ok, msg = False, ("skip generating ValidatingAdmissionPolicy: "
                              "a policy exception is configured.")
        if not ok:
            self._delete_pair(policy.name)
            self.status[policy.name] = (False, msg)
            return
        self.sink.upsert(build_vap(policy))
        self.sink.upsert(build_vap_binding(policy))
        self.status[policy.name] = (True, "")

    def on_policy_deleted(self, name: str) -> None:
        self._delete_pair(name)
        self.status.pop(name, None)

    def _delete_pair(self, name: str) -> None:
        for kind, obj_name in (("ValidatingAdmissionPolicy", name),
                               ("ValidatingAdmissionPolicyBinding",
                                vap_binding_name(name))):
            # absent is fine (controller.go tolerates NotFound)
            self.sink.delete({
                "apiVersion": "admissionregistration.k8s.io/v1alpha1",
                "kind": kind, "metadata": {"name": obj_name}})
