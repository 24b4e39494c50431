# Copied verbatim from kyverno_tpu/images/cache.py.
"""TTL'd image-verification result cache.

Mirrors pkg/imageverifycache/client.go: entries keyed by (policy id,
policy resourceVersion, rule name, image reference) so any policy edit
invalidates its entries; bounded size with oldest-first eviction; TTL
per entry (default 1h, client.go:13). Only successful verifications
are cached (imageverifier.go:283-295)."""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional, Tuple

DEFAULT_TTL_S = 3600.0
DEFAULT_MAX_SIZE = 1000


class ImageVerifyCache:
    def __init__(self, enabled: bool = True, ttl_s: float = DEFAULT_TTL_S,
                 max_size: int = DEFAULT_MAX_SIZE, clock=time.monotonic):
        self.enabled = enabled
        self.ttl_s = ttl_s
        self.max_size = max_size
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, str, str, str], float]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(policy, rule_name: str, image: str) -> Tuple[str, str, str, str]:
        # policy identity + resourceVersion: an updated policy must not
        # reuse results from its previous spec (client.go key layout).
        # Policies loaded from files carry no resourceVersion — fall
        # back to a content fingerprint of the spec so an edited spec
        # can never reuse stale entries.
        pid = f"{getattr(policy, 'namespace', '') or ''}/{getattr(policy, 'name', '')}"
        rv = str(getattr(policy, "resource_version", "") or "")
        if not rv:
            rv = getattr(policy, "_ivcache_fingerprint", "")
            if not rv:
                import hashlib
                import json
                spec = (getattr(policy, "raw", None) or {}).get("spec", {})
                rv = hashlib.sha256(
                    json.dumps(spec, sort_keys=True, default=str).encode()
                ).hexdigest()[:16]
                try:
                    object.__setattr__(policy, "_ivcache_fingerprint", rv)
                except (AttributeError, TypeError):
                    pass
        return (pid, rv, rule_name, image)

    def get(self, policy, rule_name: str, image: str) -> bool:
        if not self.enabled:
            return False
        k = self._key(policy, rule_name, image)
        now = self._clock()
        with self._lock:
            exp = self._entries.get(k)
            if exp is not None and exp > now:
                self.hits += 1
                return True
            if exp is not None:
                del self._entries[k]
            self.misses += 1
            return False

    def set(self, policy, rule_name: str, image: str) -> bool:
        if not self.enabled:
            return False
        k = self._key(policy, rule_name, image)
        with self._lock:
            self._entries[k] = self._clock() + self.ttl_s
            self._entries.move_to_end(k)
            while len(self._entries) > self.max_size:
                self._entries.popitem(last=False)
        return True


def disabled_cache() -> ImageVerifyCache:
    return ImageVerifyCache(enabled=False)
