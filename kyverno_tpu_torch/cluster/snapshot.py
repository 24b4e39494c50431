# Copied verbatim from kyverno_tpu/cluster/snapshot.py.
"""In-memory cluster snapshot — the scan engine's resource source.

Plays the role of the reference's resource metadata cache + dynamic
watchers (pkg/controllers/report/resource/controller.go:57
MetadataCache): resources keyed by UID with a content hash so the scan
service can detect change without re-reading; namespaces feed the
namespaceSelector labels. Watch-style subscribers get (uid, change)
callbacks, mirroring MetadataCache.AddEventHandler.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple


def resource_hash(resource: Dict[str, Any]) -> str:
    """Stable content hash (the reference hashes the full object JSON,
    report/resource/controller.go)."""
    return hashlib.sha256(
        json.dumps(resource, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()[:16]


def resource_uid(resource: Dict[str, Any]) -> str:
    meta = resource.get("metadata") or {}
    uid = meta.get("uid")
    if uid:
        return str(uid)
    gvk = f"{resource.get('apiVersion', '')}/{resource.get('kind', '')}"
    return f"{gvk}:{meta.get('namespace', '')}/{meta.get('name', '')}"


class ClusterSnapshot:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._resources: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._hashes: Dict[str, str] = {}                # guarded-by: _lock
        self._subscribers: List[Callable[[str, str], None]] = []  # guarded-by: _lock
        # namespace -> labels index, maintained incrementally at
        # upsert/delete: namespace_labels() is called per scan tick AND
        # per admission flush, so it must not walk every resource
        self._ns_labels: Dict[str, Dict[str, str]] = {}  # guarded-by: _lock
        self._ns_uids: Dict[str, str] = {}   # guarded-by: _lock  (uid -> ns name)
        self._ns_owner: Dict[str, str] = {}  # guarded-by: _lock  (ns -> owning uid)
        # per-resource top-level subtree hashes, computed lazily for
        # the columnar store's watch-diff encode (cluster/columnar.py)
        # and invalidated by content-hash movement
        self._subhash_cache: Dict[str, Tuple[str, Dict[str, str]]] = {}  # guarded-by: _lock

    # -- mutation (watch events)

    def _index_namespace_locked(self, uid: str,
                                resource: Dict[str, Any]) -> None:
        """Caller holds the lock. Ownership check: a namespace can be
        recreated under a new uid before the old uid's delete event
        arrives (watch relist) — only the CURRENT owner's removal may
        drop the index entry, or the late delete would wipe the live
        namespace's labels."""
        old_name = self._ns_uids.pop(uid, None)
        if old_name is not None and self._ns_owner.get(old_name) == uid:
            self._ns_labels.pop(old_name, None)
            self._ns_owner.pop(old_name, None)
        if resource.get("kind") == "Namespace":
            meta = resource.get("metadata") or {}
            name = meta.get("name", "")
            self._ns_labels[name] = dict(meta.get("labels") or {})
            self._ns_uids[uid] = name
            self._ns_owner[name] = uid

    def upsert(self, resource: Dict[str, Any]) -> str:
        uid = resource_uid(resource)
        h = resource_hash(resource)
        with self._lock:
            changed = self._hashes.get(uid) != h
            self._resources[uid] = resource
            self._hashes[uid] = h
            self._index_namespace_locked(uid, resource)
            if changed:
                self._subhash_cache.pop(uid, None)
        if changed:
            self._notify(uid, "upsert")
        return uid

    def delete(self, uid_or_resource) -> None:
        uid = uid_or_resource if isinstance(uid_or_resource, str) else resource_uid(uid_or_resource)
        with self._lock:
            self._resources.pop(uid, None)
            self._hashes.pop(uid, None)
            self._subhash_cache.pop(uid, None)
            name = self._ns_uids.pop(uid, None)
            if name is not None and self._ns_owner.get(name) == uid:
                self._ns_labels.pop(name, None)
                self._ns_owner.pop(name, None)
        self._notify(uid, "delete")

    def _notify(self, uid: str, change: str) -> None:
        # snapshot the list under the lock, call subscribers outside it
        # (a subscriber that re-reads the snapshot must not deadlock)
        with self._lock:
            subscribers = list(self._subscribers)
        for fn in subscribers:
            fn(uid, change)

    def subscribe(self, fn: Callable[[str, str], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[str, str], None]) -> None:
        """Detach a watcher (informer handler removal); long-lived
        subscribers like GlobalContext entries must unsubscribe on
        stop or every reconcile leaks a callback."""
        with self._lock:
            try:
                self._subscribers.remove(fn)
            except ValueError:
                pass

    # -- reads

    def get(self, uid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._resources.get(uid)

    def hash_of(self, uid: str) -> Optional[str]:
        with self._lock:
            return self._hashes.get(uid)

    def items(self) -> List[Tuple[str, Dict[str, Any], str]]:
        with self._lock:
            return [(uid, self._resources[uid], self._hashes[uid])
                    for uid in self._resources]

    def namespace_labels(self) -> Dict[str, Dict[str, str]]:
        """namespace -> labels from the incrementally-maintained index
        (O(namespaces), not O(resources) — this runs every scan tick
        and every admission flush). Returns copies: callers may stash
        the maps across a later upsert."""
        with self._lock:
            return {name: dict(labels)
                    for name, labels in self._ns_labels.items()}

    def subhashes_of(self, uid: str) -> Dict[str, str]:
        """Per-top-level-key content hashes of the resource — the
        flatten-path-level diff units the columnar store splices by
        (the ONE shared formula, columnar.subtree_hash — segment reuse
        keys on these matching exactly). Computed lazily (zero cost
        when the store is off) and cached against the resource's
        content hash."""
        from .columnar import subtree_hash

        with self._lock:
            res = self._resources.get(uid)
            if res is None or not isinstance(res, dict):
                return {}
            h = self._hashes[uid]
            cached = self._subhash_cache.get(uid)
            if cached is not None and cached[0] == h:
                return cached[1]
            subs: Dict[str, str] = {}
            for k, v in res.items():
                sh = subtree_hash(v)
                if sh is not None:  # unhashable subtree: always re-encoded
                    subs[str(k)] = sh
            self._subhash_cache[uid] = (h, subs)
            return subs

    def __len__(self) -> int:
        with self._lock:
            return len(self._resources)
