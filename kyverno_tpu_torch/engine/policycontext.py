# Copied verbatim from kyverno_tpu/engine/policycontext.py.
"""PolicyContext — everything the engine needs for one evaluation.

Mirrors pkg/engine/api/policycontext.go + engine/policycontext/
policy_context.go: the policy, the new/old resource, admission info,
namespace labels, operation, and the JSON variable context.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ..api.policy import ClusterPolicy
from .context import Context
from .match import RequestInfo


def context_image_infos(resource: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The ``images`` context document extracted from a resource's
    pod-spec containers (context.go:306 AddImageInfos →
    convertImagesToUnstructured): {containerType: {containerName:
    {registry,name,path,tag,digest,reference,referenceWithTag}}}."""
    try:
        from ..images import extract_images

        extracted = extract_images(resource)
    except Exception:
        return None  # malformed image strings must not break context building
    if not extracted:
        return None
    return {
        group: {key: info.to_dict() for key, info in entries.items()}
        for group, entries in extracted.items()
    }


@dataclass
class PolicyContext:
    policy: ClusterPolicy
    new_resource: Dict[str, Any] = field(default_factory=dict)
    old_resource: Dict[str, Any] = field(default_factory=dict)
    admission_info: RequestInfo = field(default_factory=RequestInfo)
    namespace_labels: Dict[str, str] = field(default_factory=dict)
    operation: str = "CREATE"
    subresource: str = ""
    # explicit (group, version, kind) for match gating; when set it
    # overrides the resource's own apiVersion/kind — the admission and
    # CLI subresource paths use this (WithResourceKind,
    # policy_processor.go:86-105: a Scale document matches as
    # Deployment/scale via the parent GVK + subresource name)
    gvk: Optional[Tuple[str, str, str]] = None
    json_context: Context = field(default_factory=Context)
    element: Optional[Dict[str, Any]] = None

    @classmethod
    def build(
        cls,
        policy: ClusterPolicy,
        resource: Dict[str, Any],
        old_resource: Optional[Dict[str, Any]] = None,
        operation: str = "CREATE",
        admission_info: Optional[RequestInfo] = None,
        namespace_labels: Optional[Dict[str, str]] = None,
        variables: Optional[Dict[str, Any]] = None,
    ) -> "PolicyContext":
        """Convenience builder mirroring NewPolicyContext: seeds the
        JSON context with request.object/oldObject/userInfo/operation."""
        ctx = Context()
        ctx.add_resource(resource)
        if old_resource:
            ctx.add_old_resource(old_resource)
        ctx.add_operation(operation)
        images = context_image_infos(resource)
        if images:
            ctx.add_image_infos(images)
        info = admission_info or RequestInfo()
        ctx.add_user_info({"username": info.username, "uid": info.uid, "groups": info.groups})
        if info.username:
            ctx.add_service_account(info.username)
        for name, value in (variables or {}).items():
            ctx.add_variable(name, value)
        return cls(
            policy=policy,
            new_resource=resource,
            old_resource=old_resource or {},
            admission_info=info,
            namespace_labels=namespace_labels or {},
            operation=operation,
            json_context=ctx,
        )

    def resource_for_match(self) -> Dict[str, Any]:
        """DELETE admission requests match against oldObject."""
        if self.operation == "DELETE" and not self.new_resource and self.old_resource:
            return self.old_resource
        return self.new_resource
