# Copied verbatim from kyverno_tpu/cluster/policycache.py.
"""Policy cache — typed in-memory index of the live policy set.

Mirror of pkg/policycache (cache.go:16 Cache, store.go:58): policies
indexed by PolicyType flags x kind so request paths fetch exactly the
policies that can apply, plus a monotonically increasing revision the
scan engine uses as its compile-cache key (the analogue of policy
resourceVersion labels on reports).
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api.policy import ClusterPolicy
from ..lifecycle.snapshot import (PolicySetSnapshot, policy_content_hash)
from ..policy.autogen import expand_policy
from ..utils import kube
from ..utils.wildcard import match as wildcard_match


class PolicyType(enum.IntFlag):
    MUTATE = 1
    VALIDATE_ENFORCE = 2
    VALIDATE_AUDIT = 4
    GENERATE = 8
    VERIFY_IMAGES_MUTATE = 16
    VERIFY_IMAGES_VALIDATE = 32


def _policy_types(policy: ClusterPolicy) -> PolicyType:
    t = PolicyType(0)
    enforce = (policy.spec.validation_failure_action or "Audit").lower().startswith("enforce")
    for rule in policy.get_rules():
        if rule.has_mutate():
            t |= PolicyType.MUTATE
        if rule.has_validate():
            t |= PolicyType.VALIDATE_ENFORCE if enforce else PolicyType.VALIDATE_AUDIT
        if rule.has_generate():
            t |= PolicyType.GENERATE
        if rule.has_verify_images():
            t |= PolicyType.VERIFY_IMAGES_MUTATE | PolicyType.VERIFY_IMAGES_VALIDATE
    return t


def _match_kinds(policy: ClusterPolicy) -> Set[str]:
    kinds: Set[str] = set()
    for rule in policy.get_rules():
        for rd in [rule.match.resources] + [rf.resources for rf in rule.match.any] \
                + [rf.resources for rf in rule.match.all]:
            kinds.update(rd.kinds)
    return kinds


class PolicyCache:
    """Set/Unset/GetPolicies plus revisioned full-set access for the
    batch compiler."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._policies: Dict[str, ClusterPolicy] = {}   # guarded-by: _lock
        self._expanded: Dict[str, ClusterPolicy] = {}   # guarded-by: _lock
        self._types: Dict[str, PolicyType] = {}         # guarded-by: _lock
        self._kinds: Dict[str, Set[str]] = {}           # guarded-by: _lock
        self._hashes: Dict[str, str] = {}               # guarded-by: _lock
        self._revision = 0                              # guarded-by: _lock
        # lifecycle subscribers: called AFTER a mutation commits, with
        # (key, change, revision). Fired outside the lock — a listener
        # that re-reads the cache (compile-ahead worker) must not
        # deadlock or serialize mutators behind its work.
        self._listeners: List[Callable[[str, str, int], None]] = []  # guarded-by: _lock

    def subscribe(self, fn: Callable[[str, str, int], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def _notify(self, key: str, change: str, revision: int) -> None:
        from ..observability.metrics import global_registry

        global_registry.policy_changes.inc({"type": change})
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(key, change, revision)
            except Exception:  # a sick listener must not block mutation
                pass

    def set(self, policy: ClusterPolicy) -> None:
        key = f"{policy.namespace}/{policy.name}" if policy.namespace else policy.name
        # expansion and hashing are pure and potentially expensive:
        # compute OUTSIDE the lock, commit every index + the revision
        # bump under ONE acquisition so a concurrent get_policies /
        # snapshot can never observe a torn entry (policy present but
        # types/kinds/hash stale) or a revision that lags its content
        expanded = expand_policy(policy)
        types = _policy_types(expanded)
        kinds = _match_kinds(expanded)
        h = policy_content_hash(policy)
        with self._lock:
            change = "update" if key in self._policies else "create"
            self._policies[key] = policy
            self._expanded[key] = expanded
            self._types[key] = types
            self._kinds[key] = kinds
            self._hashes[key] = h
            self._revision += 1
            revision = self._revision
        self._notify(key, change, revision)

    def unset(self, name: str, namespace: str = "") -> None:
        key = f"{namespace}/{name}" if namespace else name
        with self._lock:
            if self._policies.pop(key, None) is None:
                return
            self._expanded.pop(key, None)
            self._types.pop(key, None)
            self._kinds.pop(key, None)
            self._hashes.pop(key, None)
            self._revision += 1
            revision = self._revision
        self._notify(key, "delete", revision)

    @property
    def revision(self) -> int:
        with self._lock:
            return self._revision

    def get(self, key: str) -> Optional[ClusterPolicy]:
        """The RAW (un-expanded) policy at a cache key, or None."""
        with self._lock:
            return self._policies.get(key)

    def get_policies(
        self,
        ptype: PolicyType,
        kind: Optional[str] = None,
        namespace: str = "",
    ) -> List[ClusterPolicy]:
        """Autogen-expanded policies of the given type applicable to the
        kind (wildcard kind selectors honored), cluster-scoped first
        then namespace policies of `namespace` (store.go:185 get)."""
        with self._lock:
            cluster, namespaced = [], []
            for key, policy in self._expanded.items():
                if not (self._types[key] & ptype):
                    continue
                if kind is not None:
                    sels = self._kinds[key]
                    if not any(
                        wildcard_match(kube.parse_kind_selector(s)[2], kind) for s in sels
                    ):
                        continue
                if policy.namespace:
                    if policy.namespace == namespace:
                        namespaced.append(policy)
                else:
                    cluster.append(policy)
            return cluster + namespaced

    def snapshot(self) -> Tuple[int, List[ClusterPolicy]]:
        """(revision, all expanded policies) — the scan compiler input."""
        with self._lock:
            return self._revision, list(self._expanded.values())

    def policyset_snapshot(self) -> PolicySetSnapshot:
        """Immutable snapshot (revision, policies, content hashes) for
        the lifecycle manager. Captured under ONE lock acquisition so
        revision, policy list, and hashes always describe the same
        instant — the compile-ahead worker keys its artifact on the
        combined content hash."""
        with self._lock:
            return PolicySetSnapshot(
                revision=self._revision,
                policies=tuple(self._expanded.values()),
                policy_hashes=dict(self._hashes),
            )
