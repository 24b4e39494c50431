# Copied from kyverno_tpu/serving/__init__.py (one line of the docstring
# reworded).
"""Micro-batching admission pipeline.

The traffic-facing counterpart of the scan engine's batch-first design:
concurrent AdmissionReviews coalesce into padded, shape-bucketed device
batches (one CUDA graph per bucket, reused across flushes), with
deadline-aware flushing, overload shedding, and per-request verdict
dispatch. See serving/batcher.py for the pipeline proper.
"""

from .batcher import AdmissionPipeline, BatchConfig
from .dispatch import resource_verdicts
from .queue import (AdmissionQueue, DeadlineExceededError, QueuedRequest,
                    QueueFullError)
from .scheduler import (ClassifyConfig, RequestClass, classify_request,
                        parse_class_weights)

__all__ = [
    "AdmissionPipeline",
    "AdmissionQueue",
    "BatchConfig",
    "ClassifyConfig",
    "DeadlineExceededError",
    "QueueFullError",
    "QueuedRequest",
    "RequestClass",
    "classify_request",
    "parse_class_weights",
    "resource_verdicts",
]
