# Copied verbatim from kyverno_tpu/images/infos.py.
"""Image reference parsing (registry/path/name/tag/digest).

Semantics follow the reference's pkg/utils/image/infos.go: the default
registry is prepended when the first path component is not a domain
(infos.go:98 addDefaultRegistry — a domain contains ``.`` or ``:``, is
``localhost``, or has uppercase letters), the default tag is ``latest``
when neither tag nor digest is present, and ``String()`` renders
``registry/path@digest`` when digested else ``registry/path:tag``
(infos.go:34).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_REGISTRY = "docker.io"

# distribution reference grammar, trimmed to what image strings in pod
# specs can contain: [domain/]path[:tag][@digest]
_DIGEST_RE = re.compile(r"^[A-Za-z][A-Za-z0-9]*(?:[-_+.][A-Za-z][A-Za-z0-9]*)*:[0-9a-fA-F]{32,}$")
_TAG_RE = re.compile(r"^[\w][\w.-]{0,127}$")
_PATH_COMPONENT_RE = re.compile(r"^[a-z0-9]+(?:(?:\.|_|__|-+)[a-z0-9]+)*$")
_DOMAIN_RE = re.compile(r"^(?:[a-zA-Z0-9](?:[a-zA-Z0-9-]*[a-zA-Z0-9])?)(?:\.[a-zA-Z0-9](?:[a-zA-Z0-9-]*[a-zA-Z0-9])?)*(?::[0-9]+)?$")


class BadImageError(ValueError):
    pass


@dataclass
class ImageInfo:
    registry: str = ""
    name: str = ""
    path: str = ""
    tag: str = ""
    digest: str = ""
    reference: str = ""
    reference_with_tag: str = ""
    pointer: str = ""  # JSON pointer to the image field in the resource

    def __str__(self) -> str:
        image = f"{self.registry}/{self.path}" if self.registry else self.path
        if self.digest:
            return f"{image}@{self.digest}"
        return f"{image}:{self.tag}"

    def to_dict(self) -> dict:
        # the shape AddImageInfo exposes under images.<container>.<name>
        # in the JSON context (pkg/engine/context/context.go)
        return {
            "registry": self.registry,
            "name": self.name,
            "path": self.path,
            "tag": self.tag,
            "digest": self.digest,
            "reference": self.reference,
            "referenceWithTag": self.reference_with_tag,
        }


def _has_domain(image: str) -> bool:
    i = image.find("/")
    if i == -1:
        return False
    head = image[:i]
    # infos.go:100 — a leading component is a domain when it contains
    # '.'/':' or is "localhost" or is not all-lowercase
    return ("." in head or ":" in head or head == "localhost"
            or head.lower() != head)


def get_image_info(
    image: str,
    default_registry: str = DEFAULT_REGISTRY,
    enable_default_registry_mutation: bool = True,
    pointer: str = "",
) -> ImageInfo:
    """Parse an image string; raises BadImageError on malformed refs."""
    if not image or not image.strip():
        raise BadImageError("empty image")
    full = image if _has_domain(image) else f"{default_registry}/{image}"

    rest = full
    digest = ""
    if "@" in rest:
        rest, digest = rest.rsplit("@", 1)
        if not _DIGEST_RE.match(digest):
            raise BadImageError(f"bad digest in image {image!r}")
    tag = ""
    # tag separator: last ':' after the last '/'
    slash = rest.rfind("/")
    colon = rest.rfind(":")
    if colon > slash:
        rest, tag = rest[:colon], rest[colon + 1:]
        if not _TAG_RE.match(tag):
            raise BadImageError(f"bad tag in image {image!r}")

    parts = rest.split("/")
    registry, path = parts[0], "/".join(parts[1:])
    if not path:
        raise BadImageError(f"bad image {image!r}")
    if not _DOMAIN_RE.match(registry):
        raise BadImageError(f"bad registry in image {image!r}")
    for comp in path.split("/"):
        if not _PATH_COMPONENT_RE.match(comp):
            raise BadImageError(f"bad path component {comp!r} in image {image!r}")
    name = path.rsplit("/", 1)[-1]
    if not digest and not tag:
        tag = "latest"
    # when default-registry mutation is off, a defaulted registry is not
    # recorded (infos.go:73-76)
    if full != image and not enable_default_registry_mutation:
        registry = ""
    ref_with_tag = (f"{registry}/{path}:{tag}" if registry else f"{path}:{tag}")
    info = ImageInfo(registry=registry, name=name, path=path, tag=tag,
                     digest=digest, reference_with_tag=ref_with_tag,
                     pointer=pointer)
    info.reference = str(info)
    return info
