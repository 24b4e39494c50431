# Copied verbatim from kyverno_tpu/utils/kube.py.
"""Small Kubernetes helpers: GVK parsing and kind selectors.

Ports of pkg/utils/kube/kind.go.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

# kind.go:10 — note the unanchored alternation: "starts with vN[alphaN|betaN]"
# OR "ends with *" (the Go regex `^v\d((alpha|beta)\d)?|\*$` behaves this way).
_VERSION_START = re.compile(r"^v\d((alpha|beta)\d)?")
_STAR_END = re.compile(r"\*$")


def _is_version(s: str) -> bool:
    return bool(_VERSION_START.search(s)) or bool(_STAR_END.search(s))


def parse_kind_selector(selector: str) -> Tuple[str, str, str, str]:
    """Port of ParseKindSelector (kind.go:12): returns (group, version,
    kind, subresource), with "*" wildcards for unspecified group/version.
    Accepts "Kind", "version/Kind", "group/version/Kind",
    "group/version/Kind/subresource", and dotted subresource forms
    ("Pod.status")."""
    parts = selector.split("/")
    if parts:
        parts = parts[:-1] + parts[-1].split(".")
    n = len(parts)
    if n == 1:
        return "*", "*", parts[0], ""
    if n == 2:
        if parts[0] == "*" and parts[1] == "*":
            return "*", "*", "*", "*"
        if parts[0] == "*" and parts[1].lower() == parts[1]:
            return "*", "*", parts[0], parts[1]
        if _is_version(parts[0]):
            return "*", parts[0], parts[1], ""
        return "*", "*", parts[0], parts[1]
    if n == 3:
        if _is_version(parts[0]):
            return "*", parts[0], parts[1], parts[2]
        return parts[0], parts[1], parts[2], ""
    if n == 4:
        return parts[0], parts[1], parts[2], parts[3]
    return "", "", "", ""


def gvk_from_resource(resource: Dict[str, Any]) -> Tuple[str, str, str]:
    """Derive (group, version, kind) from a resource's apiVersion/kind."""
    api_version = resource.get("apiVersion", "") or ""
    kind = resource.get("kind", "") or ""
    if "/" in api_version:
        group, version = api_version.split("/", 1)
    else:
        group, version = "", api_version
    return group, version, kind


def get_name(resource: Dict[str, Any]) -> str:
    return (resource.get("metadata") or {}).get("name", "") or ""


def get_generate_name(resource: Dict[str, Any]) -> str:
    return (resource.get("metadata") or {}).get("generateName", "") or ""


def get_namespace(resource: Dict[str, Any]) -> str:
    return (resource.get("metadata") or {}).get("namespace", "") or ""


def get_labels(resource: Dict[str, Any]) -> Dict[str, str]:
    return (resource.get("metadata") or {}).get("labels") or {}


def get_annotations(resource: Dict[str, Any]) -> Dict[str, str]:
    return (resource.get("metadata") or {}).get("annotations") or {}
