# Copied verbatim from kyverno_tpu/api/policy.py.
"""Policy object model — the CRD-equivalent API types.

Mirrors the reference's api/kyverno/v1 Go structs (ClusterPolicy,
Policy, Spec at spec_types.go:51, Rule at rule_types.go:47,
MatchResources, ResourceDescription, UserInfo, the validate / mutate /
generate rule bodies) as thin dataclasses over the parsed YAML dicts.
Raw dicts are retained (``raw``) so that pattern trees, JMESPath
expressions and foreach bodies keep their original shape for both the
scalar engine and the TPU compiler.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ResourceDescription:
    """api/kyverno/v1/match_resources_types.go ResourceDescription."""

    kinds: List[str] = field(default_factory=list)
    name: str = ""
    names: List[str] = field(default_factory=list)
    namespaces: List[str] = field(default_factory=list)
    annotations: Dict[str, str] = field(default_factory=dict)
    selector: Optional[Dict[str, Any]] = None
    namespace_selector: Optional[Dict[str, Any]] = None
    operations: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ResourceDescription":
        d = d or {}
        return cls(
            kinds=list(d.get("kinds") or []),
            name=d.get("name") or "",
            names=list(d.get("names") or []),
            namespaces=list(d.get("namespaces") or []),
            annotations=dict(d.get("annotations") or {}),
            selector=d.get("selector"),
            namespace_selector=d.get("namespaceSelector"),
            operations=list(d.get("operations") or []),
        )

    def is_empty(self) -> bool:
        return not (
            self.kinds
            or self.name
            or self.names
            or self.namespaces
            or self.annotations
            or self.selector is not None
            or self.namespace_selector is not None
            or self.operations
        )


@dataclass
class UserInfo:
    """api/kyverno/v1 UserInfo: roles, clusterRoles, subjects."""

    roles: List[str] = field(default_factory=list)
    cluster_roles: List[str] = field(default_factory=list)
    subjects: List[Dict[str, Any]] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "UserInfo":
        d = d or {}
        return cls(
            roles=list(d.get("roles") or []),
            cluster_roles=list(d.get("clusterRoles") or []),
            subjects=list(d.get("subjects") or []),
        )

    def is_empty(self) -> bool:
        return not (self.roles or self.cluster_roles or self.subjects)


@dataclass
class ResourceFilter:
    """One entry of a match/exclude any/all list."""

    resources: ResourceDescription = field(default_factory=ResourceDescription)
    user_info: UserInfo = field(default_factory=UserInfo)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ResourceFilter":
        d = d or {}
        return cls(
            resources=ResourceDescription.from_dict(d.get("resources")),
            user_info=UserInfo.from_dict(d),
        )


@dataclass
class MatchResources:
    """match/exclude block: any / all lists, or the deprecated flat
    resources + user-info form."""

    any: List[ResourceFilter] = field(default_factory=list)
    all: List[ResourceFilter] = field(default_factory=list)
    resources: ResourceDescription = field(default_factory=ResourceDescription)
    user_info: UserInfo = field(default_factory=UserInfo)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "MatchResources":
        d = d or {}
        return cls(
            any=[ResourceFilter.from_dict(x) for x in d.get("any") or []],
            all=[ResourceFilter.from_dict(x) for x in d.get("all") or []],
            resources=ResourceDescription.from_dict(d.get("resources")),
            user_info=UserInfo.from_dict(d),
        )

    def is_empty(self) -> bool:
        return (
            not self.any
            and not self.all
            and self.resources.is_empty()
            and self.user_info.is_empty()
        )


@dataclass
class Validation:
    """validate rule body (api/kyverno/v1/rule_types.go Validation)."""

    message: str = ""
    pattern: Any = None
    any_pattern: Optional[List[Any]] = None
    deny: Optional[Dict[str, Any]] = None
    foreach: Optional[List[Dict[str, Any]]] = None
    pod_security: Optional[Dict[str, Any]] = None
    cel: Optional[Dict[str, Any]] = None
    manifests: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["Validation"]:
        if not d:
            return None
        return cls(
            message=d.get("message") or "",
            pattern=d.get("pattern"),
            any_pattern=d.get("anyPattern"),
            deny=d.get("deny"),
            foreach=d.get("foreach"),
            pod_security=d.get("podSecurity"),
            cel=d.get("cel"),
            manifests=d.get("manifests"),
        )


@dataclass
class Rule:
    """api/kyverno/v1/rule_types.go:47 Rule."""

    name: str
    match: MatchResources = field(default_factory=MatchResources)
    exclude: MatchResources = field(default_factory=MatchResources)
    context: List[Dict[str, Any]] = field(default_factory=list)
    preconditions: Any = None  # any/all condition lists, or legacy flat list
    validation: Optional[Validation] = None
    mutation: Optional[Dict[str, Any]] = None
    generation: Optional[Dict[str, Any]] = None
    verify_images: Optional[List[Dict[str, Any]]] = None
    cel_preconditions: Optional[List[Dict[str, Any]]] = None
    # kind -> [{path, value, key, name, jmesPath}] (rule_types.go ImageExtractors)
    image_extractors: Optional[Dict[str, List[Dict[str, Any]]]] = None
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Rule":
        return cls(
            name=d.get("name") or "",
            match=MatchResources.from_dict(d.get("match")),
            exclude=MatchResources.from_dict(d.get("exclude")),
            context=list(d.get("context") or []),
            preconditions=d.get("preconditions"),
            validation=Validation.from_dict(d.get("validate")),
            mutation=d.get("mutate"),
            generation=d.get("generate"),
            verify_images=d.get("verifyImages"),
            cel_preconditions=d.get("celPreconditions"),
            image_extractors=d.get("imageExtractors"),
            raw=d,
        )

    def has_validate(self) -> bool:
        return self.validation is not None

    def has_mutate(self) -> bool:
        return self.mutation is not None

    def has_generate(self) -> bool:
        return self.generation is not None

    def has_verify_images(self) -> bool:
        return bool(self.verify_images)


@dataclass
class Spec:
    """api/kyverno/v1/spec_types.go:51 Spec."""

    rules: List[Rule] = field(default_factory=list)
    validation_failure_action: str = "Audit"
    background: bool = True
    admission: bool = True
    webhook_timeout_seconds: Optional[int] = None
    failure_policy: Optional[str] = None
    schema_validation: Optional[bool] = None
    # spec_types.go GenerateExisting (+ deprecated
    # generateExistingOnPolicyUpdate): generate for pre-existing
    # triggers when the policy is installed
    generate_existing: bool = False
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "Spec":
        d = d or {}
        return cls(
            rules=[Rule.from_dict(r) for r in d.get("rules") or []],
            validation_failure_action=d.get("validationFailureAction") or "Audit",
            background=d.get("background", True),
            admission=d.get("admission", True),
            webhook_timeout_seconds=d.get("webhookTimeoutSeconds"),
            failure_policy=d.get("failurePolicy"),
            schema_validation=d.get("schemaValidation"),
            generate_existing=bool(
                d.get("generateExisting",
                      d.get("generateExistingOnPolicyUpdate", False))),
            raw=d,
        )


@dataclass
class ClusterPolicy:
    """ClusterPolicy / (namespaced) Policy."""

    name: str
    namespace: str = ""  # empty => cluster-scoped ClusterPolicy
    spec: Spec = field(default_factory=Spec)
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    # metadata.resourceVersion — cache-invalidation key for compiled
    # programs and image-verify results (imageverifycache key layout)
    resource_version: str = ""
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ClusterPolicy":
        meta = d.get("metadata") or {}
        kind = d.get("kind") or "ClusterPolicy"
        return cls(
            name=meta.get("name") or "",
            namespace=(meta.get("namespace") or "") if kind == "Policy" else "",
            spec=Spec.from_dict(d.get("spec")),
            annotations=dict(meta.get("annotations") or {}),
            labels=dict(meta.get("labels") or {}),
            resource_version=str(meta.get("resourceVersion") or ""),
            raw=d,
        )

    @property
    def is_namespaced(self) -> bool:
        return self.namespace != ""

    def get_rules(self) -> List[Rule]:
        return self.spec.rules


def is_policy_document(doc: Dict[str, Any]) -> bool:
    return (doc.get("kind") in ("ClusterPolicy", "Policy")) and "kyverno.io" in (
        doc.get("apiVersion") or ""
    )
