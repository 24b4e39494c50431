# Copied verbatim from kyverno_tpu/images/extract.py.
"""Image extraction from resources.

Mirrors pkg/utils/api/image.go: per-kind registered extractors (the
standard pod-spec paths for Pod and the seven pod controllers,
image.go:135 BuildStandardExtractors) overridable by a rule's
``imageExtractors`` config (kind -> [{path, value, key, name,
jmesPath}], image.go:146 lookupImageExtractor). Extraction yields
{extractor_name: {key: ImageInfo}} with JSON pointers into the
resource for digest patching.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .infos import BadImageError, ImageInfo, get_image_info


class Extractor:
    def __init__(self, fields: List[str], key: str = "", value: str = "image",
                 name: str = "", jmespath: str = ""):
        self.fields = fields          # path segments; "*" = iterate array
        self.key = key                # sibling field naming the entry
        self.value = value            # field holding the image string
        self.name = name or "custom"
        self.jmespath = jmespath


def _standard(*prefix: str) -> List[Extractor]:
    return [
        Extractor(fields=[*prefix, tag, "*"], key="name", value="image", name=tag)
        for tag in ("initContainers", "containers", "ephemeralContainers")
    ]


# kind -> extractors (image.go registeredExtractors)
REGISTERED: Dict[str, List[Extractor]] = {
    "Pod": _standard("spec"),
    "Deployment": _standard("spec", "template", "spec"),
    "DaemonSet": _standard("spec", "template", "spec"),
    "StatefulSet": _standard("spec", "template", "spec"),
    "ReplicaSet": _standard("spec", "template", "spec"),
    "ReplicationController": _standard("spec", "template", "spec"),
    "Job": _standard("spec", "template", "spec"),
    "CronJob": _standard("spec", "jobTemplate", "spec", "template", "spec"),
}


def _custom_extractors(configs: List[Dict[str, Any]]) -> List[Extractor]:
    out = []
    for c in configs:
        fields = [f.strip() for f in (c.get("path") or "").split("/") if f.strip()]
        value = c.get("value") or ""
        if not value and fields:
            value = fields[-1]
            fields = fields[:-1]
        out.append(Extractor(fields=fields, key=c.get("key") or "",
                             value=value, name=c.get("name") or "",
                             jmespath=c.get("jmesPath") or ""))
    return out


def _walk(node: Any, fields: List[str], pointer: str, hits: List) -> None:
    if node is None:
        return
    if not fields:
        hits.append((node, pointer))
        return
    f, rest = fields[0], fields[1:]
    if f == "*":
        if isinstance(node, list):
            for i, item in enumerate(node):
                _walk(item, rest, f"{pointer}/{i}", hits)
        elif isinstance(node, dict):
            for k, item in node.items():
                _walk(item, rest, f"{pointer}/{_escape(k)}", hits)
    elif isinstance(node, dict):
        _walk(node.get(f), rest, f"{pointer}/{_escape(f)}", hits)


def _escape(seg: str) -> str:
    return seg.replace("~", "~0").replace("/", "~1")


def extract_images(
    resource: Dict[str, Any],
    configs: Optional[Dict[str, List[Dict[str, Any]]]] = None,
    default_registry: str = "docker.io",
    enable_default_registry_mutation: bool = True,
    jmes=None,
) -> Dict[str, Dict[str, ImageInfo]]:
    """ExtractImagesFromResource (image.go:183): {extractor_name:
    {entry_key: ImageInfo}}. Malformed image strings raise
    BadImageError, matching the reference's error-out behavior."""
    kind = resource.get("kind", "")
    if configs and kind in configs:
        extractors = _custom_extractors(configs[kind])
    else:
        extractors = REGISTERED.get(kind, [])
    out: Dict[str, Dict[str, ImageInfo]] = {}
    for ex in extractors:
        hits: List = []
        _walk(resource, ex.fields, "", hits)
        for idx, (entry, pointer) in enumerate(hits):
            if not isinstance(entry, dict):
                continue
            value = entry.get(ex.value)
            if not isinstance(value, str) or not value.strip():
                continue
            if ex.jmespath:
                if jmes is None:
                    from ..engine.jmespath import search as jmes_search
                    value = jmes_search(ex.jmespath, value)
                else:
                    value = jmes(ex.jmespath, value)
                if not isinstance(value, str):
                    raise BadImageError(
                        f"jmespath {ex.jmespath} must produce a string")
            # without a key field, the VALUE's JSON pointer is the
            # entry key — unique across multiple same-named (default
            # "custom") extractors even when they share a path but
            # extract different fields
            value_pointer = f"{pointer}/{_escape(ex.value)}"
            key = str(entry.get(ex.key, idx)) if ex.key else (value_pointer or str(idx))
            info = get_image_info(
                value, default_registry, enable_default_registry_mutation,
                pointer=value_pointer)
            out.setdefault(ex.name, {})[key] = info
    return out
