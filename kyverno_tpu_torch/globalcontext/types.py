# Copied verbatim from kyverno_tpu/globalcontext/types.py.
"""GlobalContextEntry CRD model
(api/kyverno/v2alpha1/global_context_entry_types.go)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils.duration import parse_duration


@dataclass
class KubernetesResourceSpec:
    group: str = ""
    version: str = ""
    resource: str = ""   # plural, e.g. "deployments"
    namespace: str = ""  # empty = cluster-wide

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KubernetesResourceSpec":
        return cls(group=d.get("group", ""), version=d.get("version", ""),
                   resource=d.get("resource", ""),
                   namespace=d.get("namespace", ""))


@dataclass
class ExternalAPICallSpec:
    """kyvernov1.APICall + refreshInterval
    (global_context_entry_types.go:135)."""

    url_path: str = ""
    method: str = "GET"
    data: Optional[List[Dict[str, Any]]] = None
    service: Optional[Dict[str, Any]] = None
    jmes_path: str = ""
    refresh_interval_s: float = 600.0  # default 10m

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExternalAPICallSpec":
        interval = d.get("refreshInterval") or "10m"
        ns = parse_duration(str(interval))
        return cls(
            url_path=d.get("urlPath", ""),
            method=d.get("method", "GET"),
            data=d.get("data"),
            service=d.get("service"),
            jmes_path=d.get("jmesPath", ""),
            refresh_interval_s=(ns / 1e9) if ns else 600.0,
        )


@dataclass
class GlobalContextEntry:
    name: str
    kubernetes_resource: Optional[KubernetesResourceSpec] = None
    api_call: Optional[ExternalAPICallSpec] = None
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GlobalContextEntry":
        spec = d.get("spec") or {}
        kres = spec.get("kubernetesResource")
        call = spec.get("apiCall")
        return cls(
            name=(d.get("metadata") or {}).get("name", ""),
            kubernetes_resource=KubernetesResourceSpec.from_dict(kres) if kres else None,
            api_call=ExternalAPICallSpec.from_dict(call) if call else None,
            raw=d,
        )

    def validate(self) -> List[str]:
        """global_context_entry_types.go Validate: exactly one source,
        with its required fields."""
        errs: List[str] = []
        if self.kubernetes_resource is None and self.api_call is None:
            errs.append("a global context entry requires exactly one of "
                        "kubernetesResource or apiCall")
        if self.kubernetes_resource is not None and self.api_call is not None:
            errs.append("a global context entry cannot have both "
                        "kubernetesResource and apiCall")
        k = self.kubernetes_resource
        if k is not None:
            if not k.version:
                errs.append("kubernetesResource requires a version")
            if not k.resource:
                errs.append("kubernetesResource requires a resource")
        a = self.api_call
        if a is not None:
            if not a.url_path and not (a.service or {}).get("url"):
                errs.append("apiCall requires a urlPath or service.url")
            if a.refresh_interval_s <= 0:
                errs.append("apiCall requires a refreshInterval greater "
                            "than 0 seconds")
        return errs
