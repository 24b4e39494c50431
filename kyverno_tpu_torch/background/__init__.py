# Copied verbatim from kyverno_tpu/background/__init__.py.
"""Background processing: UpdateRequests, generate and mutate-existing
executors (pkg/background equivalent)."""

from .generate import GenerateController
from .mutate_existing import MutateExistingController
from .updaterequest import UpdateRequest, UpdateRequestQueue, UR_COMPLETED, UR_FAILED, UR_PENDING
