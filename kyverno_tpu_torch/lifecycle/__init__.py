# Copied verbatim from kyverno_tpu/lifecycle/__init__.py.
"""Policy-set lifecycle: versioned snapshots, compile-ahead hot swap,
per-policy quarantine, rollback under load.

The compiled policy program becomes an immutable, versioned artifact
with a controlled promotion path (snapshot -> compile-ahead -> atomic
swap) and a controlled failure path (quarantine -> rollback -> capped
retry), completing the degradation ladder started by resilience/:
serving never stalls on a recompile and never evaluates a torn set.
"""

from .manager import (PolicySetLifecycleManager, PolicySetUnavailable,
                      PolicySetVersion, QuarantineEntry, default_compile_fn)
from .snapshot import (PolicySetSnapshot, combined_hash, policy_content_hash,
                       policy_key)
from .watch import PolicyDirWatcher

__all__ = [
    "PolicyDirWatcher",
    "PolicySetLifecycleManager",
    "PolicySetSnapshot",
    "PolicySetUnavailable",
    "PolicySetVersion",
    "QuarantineEntry",
    "combined_hash",
    "default_compile_fn",
    "policy_content_hash",
    "policy_key",
]
