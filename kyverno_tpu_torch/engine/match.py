# Copied verbatim from kyverno_tpu/engine/match.py.
"""Match/exclude resolver — decides rule applicability per resource.

Re-implementation of pkg/engine/utils/match.go (MatchesResourceDescription
:168, doesResourceMatchConditionBlock :52) plus the pkg/utils/match
helpers (CheckKind/CheckName/CheckAnnotations/CheckSubjects). Semantics:

- ResourceDescription attributes AND together; list-valued attributes
  OR within (kinds, names, namespaces).
- UserInfo (roles/clusterRoles/subjects) ORs across and inside.
- ``match.any`` => include if ANY filter matches; ``match.all`` =>
  include if ALL match; otherwise the deprecated flat block.
- exclude only consulted when match succeeded; ``exclude.any`` excludes
  if ANY filter matches, ``exclude.all`` only if ALL do.
- namespace policies only apply to resources in their namespace
  (match.go:183).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..api.policy import ResourceDescription, ResourceFilter, Rule, UserInfo
from ..utils import kube, wildcard
from .selector import SelectorError, check_selector


class RequestInfo:
    """kyvernov1beta1.RequestInfo: admission user-info + resolved roles."""

    __slots__ = ("roles", "cluster_roles", "username", "uid", "groups")

    def __init__(
        self,
        roles: Optional[List[str]] = None,
        cluster_roles: Optional[List[str]] = None,
        username: str = "",
        uid: str = "",
        groups: Optional[List[str]] = None,
    ):
        self.roles = roles or []
        self.cluster_roles = cluster_roles or []
        self.username = username
        self.uid = uid
        self.groups = groups or []

    def is_empty(self) -> bool:
        return not (self.roles or self.cluster_roles or self.username or self.uid or self.groups)


_POD_GVK = ("", "v1", "Pod")


def check_kind(
    kinds: List[str],
    gvk: Tuple[str, str, str],
    subresource: str = "",
    allow_ephemeral_containers: bool = True,
) -> bool:
    """Port of matchutils.CheckKind (pkg/utils/match/kind.go)."""
    group, version, kind = gvk
    for k in kinds:
        sel_group, sel_version, sel_kind, sel_sub = kube.parse_kind_selector(k)
        if (
            wildcard.match(sel_group, group)
            and wildcard.match(sel_version, version)
            and wildcard.match(sel_kind, kind)
        ):
            if wildcard.match(sel_sub, subresource):
                return True
            if (
                allow_ephemeral_containers
                and gvk == _POD_GVK
                and subresource == "ephemeralcontainers"
            ):
                return True
    return False


def check_name(expected: str, actual: str) -> bool:
    return wildcard.match(expected, actual)


def check_annotations(expected: Dict[str, str], actual: Dict[str, str]) -> bool:
    """Port of matchutils.CheckAnnotations: every expected k/v glob must
    match some actual annotation."""
    if not expected:
        return True
    for k, v in expected.items():
        if not any(
            wildcard.match(k, k1) and wildcard.match(str(v), str(v1)) for k1, v1 in (actual or {}).items()
        ):
            return False
    return True


def check_subjects(rule_subjects: List[Dict[str, Any]], user: RequestInfo) -> bool:
    """Port of matchutils.CheckSubjects (pkg/utils/match/subjects.go)."""
    for subject in rule_subjects:
        kind = subject.get("kind")
        name = subject.get("name", "")
        if kind == "ServiceAccount":
            username = f"system:serviceaccount:{subject.get('namespace', '')}:{name}"
            if wildcard.match(username, user.username):
                return True
        elif kind == "Group":
            if any(wildcard.match(name, g) for g in user.groups):
                return True
        elif kind == "User":
            if wildcard.match(name, user.username):
                return True
    return False


def _check_namespaces(namespaces: List[str], resource: Dict[str, Any]) -> bool:
    # match.go:18-31 checkNameSpace: for Namespace resources the *name*
    # is compared
    ns = kube.get_namespace(resource)
    if resource.get("kind") == "Namespace":
        ns = kube.get_name(resource)
    return any(wildcard.match(pattern, ns) for pattern in namespaces)


def _slice_contains(haystack: List[str], *needles: str) -> bool:
    # datautils.SliceContains semantics: any needle present in haystack
    s = set(haystack)
    return any(n in s for n in needles)


def does_resource_match_condition_block(
    block: ResourceDescription,
    user_info: UserInfo,
    admission_info: RequestInfo,
    resource: Dict[str, Any],
    namespace_labels: Dict[str, str],
    gvk: Tuple[str, str, str],
    subresource: str,
    operation: str,
) -> List[str]:
    """Port of doesResourceMatchConditionBlock (match.go:52). Returns a
    list of failure reasons; empty list means the block matched."""
    if block.operations:
        if operation not in block.operations:
            return ["operation does not match"]

    errs: List[str] = []
    if block.kinds:
        if not check_kind(block.kinds, gvk, subresource, allow_ephemeral_containers=True):
            errs.append(f"kind does not match {block.kinds}")

    resource_name = kube.get_name(resource) or kube.get_generate_name(resource)

    if block.name:
        if not check_name(block.name, resource_name):
            errs.append("name does not match")

    if block.names:
        if not any(check_name(n, resource_name) for n in block.names):
            errs.append("none of the names match")

    if block.namespaces:
        if not _check_namespaces(block.namespaces, resource):
            errs.append("namespace does not match")

    if block.annotations:
        if not check_annotations(block.annotations, kube.get_annotations(resource)):
            errs.append("annotations does not match")

    if block.selector is not None:
        try:
            if not check_selector(block.selector, kube.get_labels(resource)):
                errs.append("selector does not match")
        except SelectorError as e:
            errs.append(f"failed to parse selector: {e}")

    if block.namespace_selector is not None:
        kind = resource.get("kind") or ""
        if kind == "Namespace":
            errs.append("namespace selector is not applicable for namespace resource")
        elif kind != "" or ("*" in block.kinds):
            try:
                if not check_selector(block.namespace_selector, namespace_labels):
                    errs.append("namespace selector does not match labels")
            except SelectorError as e:
                errs.append(f"failed to parse namespace selector: {e}")

    if user_info.roles:
        if not _slice_contains(user_info.roles, *admission_info.roles):
            errs.append("user info does not match roles for the given conditionBlock")
    if user_info.cluster_roles:
        if not _slice_contains(user_info.cluster_roles, *admission_info.cluster_roles):
            errs.append("user info does not match clustersRoles for the given conditionBlock")
    if user_info.subjects:
        if not check_subjects(user_info.subjects, admission_info):
            errs.append("user info does not match subject for the given conditionBlock")
    return errs


def _match_helper(
    rf: ResourceFilter,
    admission_info: RequestInfo,
    resource: Dict[str, Any],
    namespace_labels: Dict[str, str],
    gvk: Tuple[str, str, str],
    subresource: str,
    operation: str,
) -> List[str]:
    # match.go:253-276
    user_info = rf.user_info
    if admission_info.is_empty():
        user_info = UserInfo()
    if rf.resources.is_empty() and user_info.is_empty():
        return ["match cannot be empty"]
    return does_resource_match_condition_block(
        rf.resources, user_info, admission_info, resource, namespace_labels, gvk, subresource, operation
    )


def _exclude_helper(
    rf: ResourceFilter,
    admission_info: RequestInfo,
    resource: Dict[str, Any],
    namespace_labels: Dict[str, str],
    gvk: Tuple[str, str, str],
    subresource: str,
    operation: str,
) -> List[str]:
    # match.go:278-300 — empty exclude block excludes nothing
    if rf.resources.is_empty() and rf.user_info.is_empty():
        return []
    errs = does_resource_match_condition_block(
        rf.resources, rf.user_info, admission_info, resource, namespace_labels, gvk, subresource, operation
    )
    if not errs:
        return ["resource excluded since one of the criteria excluded it"]
    return []


def matches_resource_description(
    resource: Dict[str, Any],
    rule: Rule,
    admission_info: Optional[RequestInfo] = None,
    namespace_labels: Optional[Dict[str, str]] = None,
    policy_namespace: str = "",
    gvk: Optional[Tuple[str, str, str]] = None,
    subresource: str = "",
    operation: str = "CREATE",
) -> List[str]:
    """Port of MatchesResourceDescription (match.go:168). Returns a
    list of failure reasons; empty list means the rule applies."""
    if not resource:
        return ["resource is empty"]
    admission_info = admission_info or RequestInfo()
    namespace_labels = namespace_labels or {}
    if gvk is None:
        gvk = kube.gvk_from_resource(resource)

    if policy_namespace and policy_namespace != kube.get_namespace(resource):
        return ["policy and resource namespaces mismatch"]

    reasons: List[str] = []
    match = rule.match
    if match.any:
        if not any(
            not _match_helper(rf, admission_info, resource, namespace_labels, gvk, subresource, operation)
            for rf in match.any
        ):
            reasons.append("no resource matched")
    elif match.all:
        for rf in match.all:
            reasons.extend(
                _match_helper(rf, admission_info, resource, namespace_labels, gvk, subresource, operation)
            )
    else:
        rf = ResourceFilter(resources=match.resources, user_info=match.user_info)
        reasons.extend(
            _match_helper(rf, admission_info, resource, namespace_labels, gvk, subresource, operation)
        )

    if not reasons:
        exclude = rule.exclude
        if exclude.any:
            for rf in exclude.any:
                reasons.extend(
                    _exclude_helper(
                        rf, admission_info, resource, namespace_labels, gvk, subresource, operation
                    )
                )
        elif exclude.all:
            # excluded only if ALL filters exclude it (match.go:218-231)
            excluded_by_all = True
            for rf in exclude.all:
                if not _exclude_helper(
                    rf, admission_info, resource, namespace_labels, gvk, subresource, operation
                ):
                    excluded_by_all = False
                    break
            if excluded_by_all:
                reasons.append("resource excluded since the combination of all criteria exclude it")
        else:
            rf = ResourceFilter(resources=exclude.resources, user_info=exclude.user_info)
            reasons.extend(
                _exclude_helper(rf, admission_info, resource, namespace_labels, gvk, subresource, operation)
            )
    return reasons
