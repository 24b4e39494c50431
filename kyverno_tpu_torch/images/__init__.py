"""Image reference parsing and extraction for the JSON context
(copies of ``kyverno_tpu/images/{extract,infos}.py``). Image
verification is not part of the port yet."""

from .extract import REGISTERED, extract_images
from .infos import BadImageError, ImageInfo, get_image_info

__all__ = ["BadImageError", "ImageInfo", "get_image_info", "extract_images",
           "REGISTERED"]
