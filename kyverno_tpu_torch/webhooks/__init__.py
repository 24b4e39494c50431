# Copied from kyverno_tpu/webhooks/__init__.py.
"""Admission server: AdmissionReview handling + micro-batched device
validation on the card (pkg/webhooks equivalent)."""

from .batcher import MicroBatcher
from .server import AdmissionServer, build_handlers

__all__ = ["AdmissionServer", "MicroBatcher", "build_handlers"]
