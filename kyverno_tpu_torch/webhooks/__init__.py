"""Admission front end of the port (a part of ``kyverno_tpu/webhooks``):
the micro-batcher. ``server.py`` (the AdmissionReview HTTP server and its
handlers) is not ported yet; it comes with the mutate pipeline."""

from .batcher import MicroBatcher

__all__ = ["MicroBatcher"]
