# Copied verbatim from kyverno_tpu/globalcontext/__init__.py.
"""GlobalContextEntry subsystem.

Reference parity: api/kyverno/v2alpha1/global_context_entry_types.go
(CRD model), pkg/globalcontext/store/store.go (entry store),
pkg/controllers/globalcontext (reconciler), with the two entry kinds:

- ``kubernetesResource``: a live projection of cluster resources
  (group/version/resource[/namespace]) kept current by subscribing to
  the ClusterSnapshot — the snapshot IS this framework's watch layer
  (pkg/globalcontext/k8sresource/entry.go uses informers);
- ``apiCall``: an external call polled on ``refreshInterval``
  (pkg/globalcontext/externalapi/entry.go), executed through a
  pluggable executor so tests/air-gapped runs stay offline.

The store plugs into the engine as ``DataSources.global_context``
(mapping protocol): a missing or errored entry raises at rule
evaluation time, matching the reference's invalid-entry behavior
(pkg/globalcontext/invalid/entry.go)."""

from .entry import EntryError, ExternalApiEntry, KubernetesResourceEntry
from .store import GlobalContextStore
from .types import GlobalContextEntry

__all__ = ["GlobalContextStore", "GlobalContextEntry", "EntryError",
           "KubernetesResourceEntry", "ExternalApiEntry"]
