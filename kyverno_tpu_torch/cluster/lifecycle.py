# Copied verbatim from kyverno_tpu/cluster/lifecycle.py.
"""Process lifecycle hygiene: shutdown cleanup + startup janitor.

- ``cleanup_on_shutdown`` mirrors pkg/webhooks/server.go:243 cleanup
  (gated on the runtime going down): delete the kyverno-managed
  webhook configurations (by managed-by label) and release the
  coordination leases, so an exiting admission server never leaves a
  failurePolicy=Fail webhook pointing at a dead endpoint.
- ``InitJanitor`` mirrors cmd/kyverno-init/main.go: before the main
  process serves, a leader-gated pass ("kyvernopre-lock" lease —
  main.go:109 acquireLeader exits if another janitor holds it) clears
  state stale from prior runs: managed webhook configurations and
  leftover PolicyReport / ClusterPolicyReport objects (main.go:53
  request kinds).
"""

from __future__ import annotations

from typing import List, Optional

from .leaderelection import LeaseStore
from .snapshot import ClusterSnapshot
from .webhookconfig import MANAGED_BY_LABEL

JANITOR_LOCK = "kyvernopre-lock"
HEALTH_LEASE = "kyverno-health"

_WEBHOOK_KINDS = ("ValidatingWebhookConfiguration",
                  "MutatingWebhookConfiguration")
_REPORT_KINDS = ("PolicyReport", "ClusterPolicyReport")


def _delete_managed(snapshot: ClusterSnapshot, kinds) -> List[str]:
    deleted = []
    for uid, res, _ in snapshot.items():
        labels = (res.get("metadata") or {}).get("labels") or {}
        if res.get("kind") in kinds and labels.get(MANAGED_BY_LABEL) == "kyverno":
            snapshot.delete(uid)
            deleted.append(uid)
    return deleted


def cleanup_on_shutdown(snapshot: Optional[ClusterSnapshot],
                        lease_store: Optional[LeaseStore],
                        identity: str = "") -> List[str]:
    """server.go:243: deregister managed webhook configurations and
    release our leases. Returns deleted uids (for tests/logs)."""
    deleted: List[str] = []
    if snapshot is not None:
        deleted = _delete_managed(snapshot, _WEBHOOK_KINDS)
    if lease_store is not None:
        for name in (JANITOR_LOCK, HEALTH_LEASE):
            try:
                lease_store.release(name, identity or lease_store.holder(name) or "")
            except Exception:
                pass  # absent lease is fine (NotFound tolerated)
    return deleted


class InitJanitor:
    """kyverno-init: one-shot stale-state cleanup, leader-gated."""

    def __init__(self, snapshot: ClusterSnapshot, lease_store: LeaseStore,
                 identity: str = "kyverno-init"):
        self.snapshot = snapshot
        self.lease_store = lease_store
        self.identity = identity

    def run(self) -> Optional[List[str]]:
        """Returns deleted uids, or None when another janitor holds the
        lock (main.go:112 'Leader was elected, quitting')."""
        holder = self.lease_store.holder(JANITOR_LOCK)
        if holder is not None and holder != self.identity:
            return None
        if not self.lease_store.try_acquire_or_renew(
                JANITOR_LOCK, self.identity, lease_duration_s=60.0):
            return None
        try:
            deleted = _delete_managed(self.snapshot, _WEBHOOK_KINDS)
            # stale reports from prior runs re-aggregate from scratch
            for uid, res, _ in self.snapshot.items():
                if res.get("kind") in _REPORT_KINDS:
                    self.snapshot.delete(uid)
                    deleted.append(uid)
            return deleted
        finally:
            self.lease_store.release(JANITOR_LOCK, self.identity)
