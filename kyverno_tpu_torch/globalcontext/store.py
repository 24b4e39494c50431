# Copied verbatim from kyverno_tpu/globalcontext/store.py.
"""Entry store + reconciler (pkg/globalcontext/store/store.go,
pkg/controllers/globalcontext/controller.go).

``GlobalContextStore`` implements the mapping protocol the engine's
``globalReference`` context loader consumes
(engine/contextloaders.py _load_global): ``name in store`` and
``store[name]``, where a present-but-failing entry raises EntryError
so rules surface a context-load error rather than silently evaluating
against stale data."""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from .entry import EntryError, ExternalApiEntry, KubernetesResourceEntry
from .types import GlobalContextEntry


class GlobalContextStore:
    def __init__(self, snapshot=None,
                 api_executor: Optional[Callable] = None) -> None:
        self.snapshot = snapshot
        self.api_executor = api_executor
        self._lock = threading.Lock()
        self._entries: Dict[str, Any] = {}  # guarded-by: _lock

    # -- store protocol (store.go:24)

    def set(self, key: str, entry) -> None:
        with self._lock:
            old = self._entries.get(key)
            self._entries[key] = entry
            if old is not None:
                old.stop()

    def get_entry(self, key: str):
        with self._lock:
            return self._entries.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
        if entry is not None:
            entry.stop()

    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    # -- reconciler (controllers/globalcontext/controller.go)

    def apply(self, doc_or_entry) -> List[str]:
        """Reconcile one GlobalContextEntry CR into the store. Returns
        validation errors (entry not stored when invalid)."""
        entry = (doc_or_entry if isinstance(doc_or_entry, GlobalContextEntry)
                 else GlobalContextEntry.from_dict(doc_or_entry))
        errs = entry.validate()
        if errs:
            return errs
        if entry.kubernetes_resource is not None:
            if self.snapshot is None:
                return ["kubernetesResource entries require a cluster snapshot"]
            self.set(entry.name, KubernetesResourceEntry(
                entry.kubernetes_resource, self.snapshot))
        else:
            if self.api_executor is None:
                return ["apiCall entries require an API executor"]
            self.set(entry.name, ExternalApiEntry(
                entry.api_call, self.api_executor))
        return []

    def refresh_all(self) -> None:
        """Poll tick for external-API entries (the controller's
        background loop)."""
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            if isinstance(e, ExternalApiEntry):
                e.refresh()

    # -- mapping protocol for DataSources.global_context

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def __getitem__(self, name: str) -> Any:
        entry = self.get_entry(name)
        if entry is None:
            raise KeyError(name)
        return entry.get()
