# Copied verbatim from kyverno_tpu/images/__init__.py.
"""Image verification subsystem (host plane).

Reference parity: pkg/engine/internal/imageverifier.go (flow),
pkg/utils/image (parsing), pkg/utils/api/image.go (extraction),
pkg/imageverifycache (cache). Crypto backends are pluggable behind
``registry.StaticRegistry``'s protocol."""

from .cache import ImageVerifyCache, disabled_cache
from .extract import REGISTERED, extract_images
from .infos import BadImageError, ImageInfo, get_image_info
from .registry import (
    RegistryError,
    Response,
    StaticRegistry,
    VerificationFailed,
    VerifyOptions,
)
from .verify import (
    VERIFY_ANNOTATION,
    ImageVerificationMetadata,
    Verifier,
    expand_static_keys,
    has_verify_image_checks,
    validate_image,
    validate_image_rule,
)

__all__ = [
    "BadImageError", "ImageInfo", "get_image_info", "extract_images",
    "REGISTERED", "ImageVerifyCache", "disabled_cache", "StaticRegistry",
    "VerifyOptions", "Response", "RegistryError", "VerificationFailed",
    "Verifier", "ImageVerificationMetadata", "VERIFY_ANNOTATION",
    "expand_static_keys", "validate_image", "validate_image_rule",
    "has_verify_image_checks",
]
