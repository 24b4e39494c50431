# Copied verbatim from kyverno_tpu/lifecycle/snapshot.py.
"""PolicySetSnapshot — the immutable input of a compile.

Every mutation of the live policy set produces a new snapshot: the
cache revision, the (autogen-expanded) policy list frozen as a tuple,
a per-policy content hash, and a combined content hash over the whole
set. The hash is what the compile-ahead worker keys its work on — two
revisions with identical content (a no-op re-apply) share one compiled
artifact, and a swapped-in version can always say exactly which bytes
it was compiled from (the DPI-engine discipline: compiled automata are
replaced atomically, never patched live).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


def policy_key(policy: Any) -> str:
    """Cache key of a policy object: ``namespace/name`` for namespaced
    Policy, bare ``name`` for ClusterPolicy (policycache.py keying)."""
    ns = getattr(policy, "namespace", "") or ""
    name = getattr(policy, "name", "") or ""
    return f"{ns}/{name}" if ns else name


def policy_content_hash(policy: Any) -> str:
    """Stable content hash of one policy. The raw parsed document is
    the canonical content (api/policy.py retains it); policies built
    programmatically without a raw dict hash their identity + spec
    repr, which is stable within a process — enough for churn
    detection, which is all this hash feeds."""
    raw = getattr(policy, "raw", None)
    if raw:
        payload = json.dumps(raw, sort_keys=True, default=str)
    else:
        payload = "|".join((
            getattr(policy, "namespace", "") or "",
            getattr(policy, "name", "") or "",
            getattr(policy, "resource_version", "") or "",
            repr(getattr(policy, "spec", None)),
        ))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def combined_hash(policy_hashes: Dict[str, str]) -> str:
    """Order-insensitive hash of the whole set: sorted (key, hash)
    pairs, so insertion order never forces a spurious recompile."""
    payload = ";".join(f"{k}={h}" for k, h in sorted(policy_hashes.items()))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclass(frozen=True)
class PolicySetSnapshot:
    """Immutable view of the policy set at one cache revision."""

    revision: int
    policies: Tuple[Any, ...]          # autogen-expanded, cache order
    policy_hashes: Dict[str, str] = field(default_factory=dict)
    content_hash: str = ""

    def __post_init__(self) -> None:
        if not self.content_hash:
            object.__setattr__(
                self, "content_hash", combined_hash(self.policy_hashes))

    def keys(self) -> Tuple[str, ...]:
        return tuple(policy_key(p) for p in self.policies)
