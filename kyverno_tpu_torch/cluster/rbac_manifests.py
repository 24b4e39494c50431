# Copied verbatim from kyverno_tpu/cluster/rbac_manifests.py.
"""Static install-surface RBAC objects.

The chart installs aggregated ClusterRoles that fold kyverno CR access
into the built-in admin role (charts/kyverno rbac templates, rendered
in the reference's config/install-latest-testing.yaml); the rbac
conformance scenarios assert their presence in any installed cluster.
"""

from __future__ import annotations

from typing import Any, Dict, List

_VERBS = ["create", "delete", "get", "list", "patch", "update", "watch"]

_LABELS = {
    "app.kubernetes.io/component": "rbac",
    "app.kubernetes.io/instance": "kyverno",
    "app.kubernetes.io/part-of": "kyverno",
    "app.kubernetes.io/version": "latest",
    "rbac.authorization.k8s.io/aggregate-to-admin": "true",
}


def _role(name: str, rules: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRole",
        "metadata": {"name": name, "labels": dict(_LABELS)},
        "rules": rules,
    }


def aggregated_admin_roles() -> List[Dict[str, Any]]:
    """The four kyverno:rbac:admin:* aggregated ClusterRoles."""
    return [
        _role("kyverno:rbac:admin:policies", [{
            "apiGroups": ["kyverno.io"],
            "resources": ["cleanuppolicies", "clustercleanuppolicies",
                          "policies", "clusterpolicies"],
            "verbs": list(_VERBS),
        }]),
        _role("kyverno:rbac:admin:policyreports", [{
            "apiGroups": ["wgpolicyk8s.io"],
            "resources": ["policyreports", "clusterpolicyreports"],
            "verbs": list(_VERBS),
        }]),
        _role("kyverno:rbac:admin:reports", [
            {"apiGroups": ["kyverno.io"],
             "resources": ["admissionreports", "clusteradmissionreports",
                           "backgroundscanreports",
                           "clusterbackgroundscanreports"],
             "verbs": list(_VERBS)},
            {"apiGroups": ["reports.kyverno.io"],
             "resources": ["ephemeralreports", "clusterephemeralreports"],
             "verbs": list(_VERBS)},
        ]),
        _role("kyverno:rbac:admin:updaterequests", [{
            "apiGroups": ["kyverno.io"],
            "resources": ["updaterequests"],
            "verbs": list(_VERBS),
        }]),
    ]
