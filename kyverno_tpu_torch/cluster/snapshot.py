# Copied from kyverno_tpu/cluster/snapshot.py (resource_hash only).
"""Resource content hashing of the cluster snapshot, as far as the
policy compiler needs it (the hash of a folded ConfigMap is part of a
compiled set's context dependencies)."""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict


def resource_hash(resource: Dict[str, Any]) -> str:
    """Stable content hash (the reference hashes the full object JSON,
    report/resource/controller.go)."""
    return hashlib.sha256(
        json.dumps(resource, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()[:16]
