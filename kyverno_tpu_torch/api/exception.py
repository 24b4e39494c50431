# Copied verbatim from kyverno_tpu/api/exception.py.
"""PolicyException CRD model
(api/kyverno/v2beta1/policy_exception_types.go).

An exception carries a match block (which resources it covers), an
optional any/all conditions tree evaluated against the JSON context
(policy_exception_types.go:70-73), the excluded (policy, rules) pairs
with wildcard rule names (:136 Contains), optional podSecurity
controls applied to validate.podSecurity rules, and a background flag
gating use during background scans."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils.wildcard import match as wildcard_match


@dataclass
class ExceptionRef:
    policy_name: str
    rule_names: List[str] = field(default_factory=list)

    def contains(self, policy: str, rule: str) -> bool:
        if self.policy_name != policy:
            return False
        return any(wildcard_match(rn, rule) for rn in self.rule_names)


@dataclass
class PolicyException:
    name: str
    namespace: str = ""
    background: bool = True
    match: Optional[Dict[str, Any]] = None
    conditions: Optional[Dict[str, Any]] = None  # {any: [...], all: [...]}
    exceptions: List[ExceptionRef] = field(default_factory=list)
    pod_security: List[Dict[str, Any]] = field(default_factory=list)
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PolicyException":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        bg = spec.get("background")
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            background=True if bg is None else bool(bg),
            match=spec.get("match"),
            conditions=spec.get("conditions"),
            exceptions=[
                ExceptionRef(policy_name=e.get("policyName", ""),
                             rule_names=list(e.get("ruleNames") or []))
                for e in spec.get("exceptions") or []
            ],
            pod_security=list(spec.get("podSecurity") or []),
            raw=d,
        )

    def contains(self, policy: str, rule: str) -> bool:
        return any(e.contains(policy, rule) for e in self.exceptions)

    def has_pod_security(self) -> bool:
        return bool(self.pod_security)

    def validate(self) -> List[str]:
        """Admission-time validation of the exception CR itself
        (pkg/validation/exception + spec.Validate)."""
        errs: List[str] = []
        if not self.exceptions:
            errs.append("spec.exceptions: at least one exception entry is required")
        for i, e in enumerate(self.exceptions):
            if not e.policy_name:
                errs.append(f"spec.exceptions[{i}].policyName is required")
            if not e.rule_names:
                errs.append(f"spec.exceptions[{i}].ruleNames is required")
        if self.background and self.match:
            # background exceptions may not rely on admission-only
            # request data (policy_exception_types.go:41-44 +
            # match.ValidateNoUserInfo)
            for block in (self.match.get("any") or []) + (self.match.get("all") or []):
                if block.get("subjects") or block.get("roles") or block.get("clusterRoles"):
                    errs.append(
                        "spec.match: user information (subjects/roles/"
                        "clusterRoles) requires spec.background=false")
        return errs


def is_exception_document(doc: Dict[str, Any]) -> bool:
    return (doc.get("kind") == "PolicyException"
            and str(doc.get("apiVersion", "")).startswith("kyverno.io/"))
