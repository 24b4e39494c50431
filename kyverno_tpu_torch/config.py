# Copied verbatim from kyverno_tpu/config.py.
"""Dynamic configuration + toggles (pkg/config, pkg/toggle).

Three tiers like the reference: (1) constructor kwargs play the role of
binary flags; (2) Toggles carry env-overridable feature gates — notably
`engine` selecting the TPU vs scalar evaluation path (the north star's
gating mechanism); (3) Configuration mirrors the hot-reloaded `kyverno`
ConfigMap (pkg/config/config.go:157): resourceFilters in the
"[kind,namespace,name]" string form, username/role exclusions, default
registry, with OnChanged callbacks firing after every update.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from .utils.wildcard import match as wildcard_match

_FILTER_RE = re.compile(r"\[([^\[\]]*)\]")


def parse_resource_filters(text: str) -> List[Tuple[str, str, str]]:
    """"[Event,*,*][*/status,*,*]" -> [(kind, namespace, name), ...]."""
    out = []
    for body in _FILTER_RE.findall(text or ""):
        parts = [p.strip() for p in body.split(",")]
        while len(parts) < 3:
            parts.append("*")
        out.append((parts[0] or "*", parts[1] or "*", parts[2] or "*"))
    return out


class Configuration:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.resource_filters: List[Tuple[str, str, str]] = []
        self.exclude_usernames: List[str] = []
        self.exclude_groups: List[str] = []
        self.exclude_roles: List[str] = []
        self.default_registry = "docker.io"
        self.generate_success_events = False
        self.webhook_annotations: Dict[str, str] = {}
        self._callbacks: List[Callable[[], None]] = []

    def on_changed(self, fn: Callable[[], None]) -> None:
        self._callbacks.append(fn)

    def load(self, data: Dict[str, str]) -> None:
        """Apply a `kyverno` ConfigMap's data section (hot reload)."""
        with self._lock:
            if "resourceFilters" in data:
                self.resource_filters = parse_resource_filters(data["resourceFilters"])
            if "excludeUsernames" in data:
                self.exclude_usernames = [u.strip() for u in data["excludeUsernames"].split(",") if u.strip()]
            if "excludeGroups" in data:
                self.exclude_groups = [g.strip() for g in data["excludeGroups"].split(",") if g.strip()]
            if "excludeRoles" in data:
                self.exclude_roles = [r.strip() for r in data["excludeRoles"].split(",") if r.strip()]
            if "defaultRegistry" in data:
                self.default_registry = data["defaultRegistry"]
            if "generateSuccessEvents" in data:
                self.generate_success_events = data["generateSuccessEvents"] == "true"
        for fn in list(self._callbacks):
            fn()

    def to_filter(self, kind: str, namespace: str, name: str) -> bool:
        """True when the resource matches a resourceFilter (excluded
        from admission processing, WithFilter middleware)."""
        with self._lock:
            filters = list(self.resource_filters)
        for fk, fns, fn_ in filters:
            if wildcard_match(fk, kind) and wildcard_match(fns, namespace) \
                    and wildcard_match(fn_, name):
                return True
        return False

    def is_excluded(self, username: str, groups: List[str], roles: List[str]) -> bool:
        with self._lock:
            eu, eg, er = self.exclude_usernames, self.exclude_groups, self.exclude_roles
        if any(wildcard_match(p, username) for p in eu):
            return True
        if any(wildcard_match(p, g) for p in eg for g in groups):
            return True
        if any(wildcard_match(p, r) for p in er for r in roles):
            return True
        return False


class Toggles:
    """Env-overridable feature gates (pkg/toggle/toggle.go)."""

    _DEFS = {
        # name: (env var, default)
        "engine": ("KYVERNO_TPU_ENGINE", "tpu"),           # tpu | scalar
        "force_failure_policy_ignore": ("FLAG_FORCE_FAILURE_POLICY_IGNORE", "false"),
        "protect_managed_resources": ("FLAG_PROTECT_MANAGED_RESOURCES", "false"),
        "enable_deferred_loading": ("FLAG_ENABLE_DEFERRED_LOADING", "true"),
    }

    def __init__(self, **overrides: str) -> None:
        self._values = {}
        for name, (env, default) in self._DEFS.items():
            self._values[name] = overrides.get(name, os.environ.get(env, default))

    def __getattr__(self, name: str) -> Any:
        values = self.__dict__.get("_values", {})
        if name in values:
            v = values[name]
            return v if name == "engine" else v == "true"
        raise AttributeError(name)


default_configuration = Configuration()
default_toggles = Toggles()
