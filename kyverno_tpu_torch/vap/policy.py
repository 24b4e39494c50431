# Copied verbatim from kyverno_tpu/vap/policy.py.
"""ValidatingAdmissionPolicy object evaluation (in-process).

The reference evaluates VAP objects for reports and the CLI through
the upstream admission libraries (pkg/validatingadmissionpolicy/
validate.go:66 Validate). This module does the same against plain
dicts: matchConstraints resourceRules (+ exclude, object/namespace
selectors) gate the resource, then the CEL validator runs with the
VAP's validations/variables/matchConditions/auditAnnotations and an
optional bound param resource."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..engine.selector import matches_selector
from ..utils.wildcard import match as wildcard_match
from .validator import CelValidator, ValidationResult

# kind -> plural resource for the common built-ins; anything else uses
# naive lowercase pluralization (the CLI/scan path has no discovery)
_PLURALS = {
    "Pod": "pods", "Service": "services", "Deployment": "deployments",
    "DaemonSet": "daemonsets", "StatefulSet": "statefulsets",
    "ReplicaSet": "replicasets", "Job": "jobs", "CronJob": "cronjobs",
    "ConfigMap": "configmaps", "Secret": "secrets", "Namespace": "namespaces",
    "Ingress": "ingresses", "NetworkPolicy": "networkpolicies",
    "PersistentVolumeClaim": "persistentvolumeclaims",
    "PersistentVolume": "persistentvolumes",
    "ServiceAccount": "serviceaccounts", "Node": "nodes",
    "ReplicationController": "replicationcontrollers",
    "HorizontalPodAutoscaler": "horizontalpodautoscalers",
    "PodDisruptionBudget": "poddisruptionbudgets",
    "Role": "roles", "RoleBinding": "rolebindings",
    "ClusterRole": "clusterroles", "ClusterRoleBinding": "clusterrolebindings",
    "CustomResourceDefinition": "customresourcedefinitions",
    "Endpoints": "endpoints", "LimitRange": "limitranges",
    "ResourceQuota": "resourcequotas",
}


def kind_to_resource(kind: str) -> str:
    if kind in _PLURALS:
        return _PLURALS[kind]
    low = kind.lower()
    if low.endswith("s") or low.endswith("x") or low.endswith("ch"):
        return low + "es"
    # -ies only after a consonant (policy->policies, gateway->gateways)
    if low.endswith("y") and len(low) > 1 and low[-2] not in "aeiou":
        return low[:-1] + "ies"
    return low + "s"


def _group_version(api_version: str):
    if "/" in api_version:
        g, v = api_version.split("/", 1)
        return g, v
    return "", api_version


def _rule_matches(rule: Dict[str, Any], group: str, version: str,
                  resource: str, operation: str) -> bool:
    ops = rule.get("operations") or ["*"]
    if "*" not in ops and operation and operation not in ops:
        return False
    groups = rule.get("apiGroups") or ["*"]
    if "*" not in groups and group not in groups:
        return False
    versions = rule.get("apiVersions") or ["*"]
    if "*" not in versions and version not in versions:
        return False
    resources = rule.get("resources") or ["*"]
    for r in resources:
        base = r.split("/", 1)[0]  # subresources: "pods/status"
        if base == "*" or wildcard_match(base, resource):
            return True
    return False


def match_constraints_match(
    constraints: Optional[Dict[str, Any]],
    resource: Dict[str, Any],
    operation: str = "CREATE",
    namespace_labels: Optional[Dict[str, str]] = None,
) -> bool:
    """spec.matchConstraints evaluation (MatchResources shape)."""
    if not constraints:
        return True
    group, version = _group_version(resource.get("apiVersion", "v1"))
    plural = kind_to_resource(resource.get("kind", ""))
    rules = constraints.get("resourceRules") or []
    if rules and not any(
            _rule_matches(r.get("ruleWithOperations", r), group, version, plural, operation)
            for r in rules):
        return False
    for r in constraints.get("excludeResourceRules") or []:
        if _rule_matches(r.get("ruleWithOperations", r), group, version, plural, operation):
            return False
    obj_sel = constraints.get("objectSelector")
    if obj_sel is not None and obj_sel != {}:
        labels = ((resource.get("metadata") or {}).get("labels")) or {}
        if not matches_selector(obj_sel, labels):
            return False
    ns_sel = constraints.get("namespaceSelector")
    if ns_sel is not None and ns_sel != {}:
        # apiserver semantics (matchesResourceRules / rules.go): a
        # Namespace object evaluates the selector against its OWN
        # labels; other cluster-scoped KINDS match unconditionally;
        # namespaced objects (even with the namespace field implicit)
        # use their namespace's labels
        meta = resource.get("metadata") or {}
        kind = resource.get("kind", "")
        if kind == "Namespace":
            if not matches_selector(ns_sel, meta.get("labels") or {}):
                return False
        elif kind not in _CLUSTER_SCOPED_KINDS:
            if not matches_selector(ns_sel, namespace_labels or {}):
                return False
    return True


# well-known cluster-scoped kinds (scope is a schema property; without
# an apiserver, kind identity is the available signal)
_CLUSTER_SCOPED_KINDS = frozenset({
    "Namespace", "Node", "PersistentVolume", "ClusterRole",
    "ClusterRoleBinding", "CustomResourceDefinition", "StorageClass",
    "PriorityClass", "RuntimeClass", "IngressClass", "APIService",
    "MutatingWebhookConfiguration", "ValidatingWebhookConfiguration",
    "ValidatingAdmissionPolicy", "ValidatingAdmissionPolicyBinding",
    "CertificateSigningRequest", "ClusterPolicy", "PolicyException",
    "GlobalContextEntry", "VolumeAttachment", "CSIDriver", "CSINode",
    "FlowSchema", "PriorityLevelConfiguration",
})


def validate_vap(
    vap: Dict[str, Any],
    resource: Dict[str, Any],
    operation: str = "CREATE",
    old_resource: Optional[Dict[str, Any]] = None,
    request: Optional[Dict[str, Any]] = None,
    params: Optional[Dict[str, Any]] = None,
    namespace_object: Optional[Dict[str, Any]] = None,
    namespace_labels: Optional[Dict[str, str]] = None,
) -> Optional[List[ValidationResult]]:
    """Evaluate one ValidatingAdmissionPolicy against one resource.
    Returns None when matchConstraints do not select the resource."""
    spec = vap.get("spec") or {}
    if not match_constraints_match(spec.get("matchConstraints"), resource,
                                   operation, namespace_labels):
        return None
    validator = CelValidator(
        validations=spec.get("validations") or [],
        match_conditions=spec.get("matchConditions") or [],
        variables=spec.get("variables") or [],
        audit_annotations=spec.get("auditAnnotations") or [],
    )
    meta = resource.get("metadata") or {}
    req = request or {
        "operation": operation,
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", ""),
        "kind": {"kind": resource.get("kind", "")},
        "userInfo": {},
    }
    return validator.validate(
        object=resource, old_object=old_resource, request=req,
        params=params, namespace_object=namespace_object)


def is_vap_document(doc: Dict[str, Any]) -> bool:
    return (doc.get("kind") == "ValidatingAdmissionPolicy"
            and str(doc.get("apiVersion", "")).startswith("admissionregistration.k8s.io/"))
