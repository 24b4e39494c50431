# Copied verbatim from kyverno_tpu/engine/userinfo.py.
"""RBAC role resolution for admission requests.

Port of pkg/userinfo/roleRef.go:26 GetRoleRef: resolve the roles and
clusterRoles a requesting user holds from (Cluster)RoleBinding objects,
so `match.roles` / `match.clusterRoles` policies work from a raw
AdmissionReview (the engine's RequestInfo expects resolved names).

Binding subject matching (roleRef.go:77 matchBindingSubjects):
- ServiceAccount subject: username equals
  "system:serviceaccount:<ns>:<name>" (subject namespace, else the
  binding's namespace; skipped when neither exists);
- Group subject: any of the user's groups equals the subject name;
- User subject: username equals the subject name.

RoleBinding -> roleRef Role adds "<binding-ns>:<role>" to roles;
roleRef ClusterRole adds the name to clusterRoles. ClusterRoleBinding
only ever adds clusterRoles. Results are deduplicated and sorted
(sets.List in the reference).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple


def _match_binding_subjects(subjects: Iterable[Dict[str, Any]],
                            username: str, groups: List[str],
                            namespace: str) -> bool:
    for subject in subjects or ():
        kind = subject.get("kind", "")
        name = subject.get("name", "")
        if kind == "ServiceAccount":
            ns = subject.get("namespace") or namespace
            if ns and username == f"system:serviceaccount:{ns}:{name}":
                return True
        elif kind == "Group":
            if name in groups:
                return True
        elif kind == "User":
            if username == name:
                return True
    return False


def get_role_ref(
    role_bindings: Iterable[Dict[str, Any]],
    cluster_role_bindings: Iterable[Dict[str, Any]],
    username: str,
    groups: List[str],
) -> Tuple[List[str], List[str]]:
    """(roles, cluster_roles) held by the user per the bindings."""
    roles: List[str] = []
    cluster_roles: List[str] = []
    for rb in role_bindings:
        ns = (rb.get("metadata") or {}).get("namespace", "")
        if _match_binding_subjects(rb.get("subjects"), username, groups, ns):
            ref = rb.get("roleRef") or {}
            if ref.get("kind") == "Role":
                roles.append(f"{ns}:{ref.get('name', '')}")
            elif ref.get("kind") == "ClusterRole":
                cluster_roles.append(ref.get("name", ""))
    for crb in cluster_role_bindings:
        if _match_binding_subjects(crb.get("subjects"), username, groups, ""):
            ref = crb.get("roleRef") or {}
            if ref.get("kind") == "ClusterRole":
                cluster_roles.append(ref.get("name", ""))
    return sorted(set(roles)), sorted(set(cluster_roles))


def resolve_roles_from_snapshot(snapshot, username: str,
                                groups: List[str]) -> Tuple[List[str], List[str]]:
    """GetRoleRef against the in-memory ClusterSnapshot (the lister
    analogue): bindings are plain RoleBinding / ClusterRoleBinding
    resources in the snapshot."""
    rbs: List[Dict[str, Any]] = []
    crbs: List[Dict[str, Any]] = []
    for _, r, _ in snapshot.items():  # one pass; items() copies under lock
        kind = r.get("kind")
        if kind == "RoleBinding":
            rbs.append(r)
        elif kind == "ClusterRoleBinding":
            crbs.append(r)
    return get_role_ref(rbs, crbs, username, groups)


def policies_use_rbac(policies) -> bool:
    """Does any rule's match/exclude read roles / clusterRoles /
    subjects? When none do, admission requests skip binding resolution
    entirely (it is O(snapshot) per request otherwise)."""
    for p in policies:
        for rule in p.get_rules():
            for block in (rule.match, rule.exclude):
                if not block.user_info.is_empty():
                    return True
                for f in list(block.any) + list(block.all):
                    if not f.user_info.is_empty():
                        return True
    return False
