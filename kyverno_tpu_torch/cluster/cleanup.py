# Copied verbatim from kyverno_tpu/cluster/cleanup.py.
"""Cleanup + TTL controllers.

CleanupController mirrors pkg/controllers/cleanup/controller.go: a
CleanupPolicy carries a cron `schedule` plus match/exclude and
conditions; at each due time, matching resources are deleted from the
snapshot and the deletion counter increments (deletedObjectsTotal,
controller.go:63).

TtlController mirrors pkg/controllers/ttl: resources labeled
`cleanup.kyverno.io/ttl` are deleted once the duration (from
creationTimestamp) or the absolute time passes.
"""

from __future__ import annotations

import datetime as dt
from typing import Any, Dict, List, Optional, Tuple

from ..api.policy import ClusterPolicy, Rule
from ..engine.conditions import evaluate_conditions
from ..engine.match import matches_resource_description
from ..tpu.engine import build_scan_context
from ..utils.cron import Cron, CronError
from ..utils.duration import parse_duration
from .snapshot import ClusterSnapshot

TTL_LABEL = "cleanup.kyverno.io/ttl"


class CleanupPolicy:
    """v2beta1 CleanupPolicy / ClusterCleanupPolicy."""

    def __init__(self, doc: Dict[str, Any]):
        self.raw = doc
        meta = doc.get("metadata") or {}
        self.name = meta.get("name", "")
        self.namespace = meta.get("namespace", "") if doc.get("kind") == "CleanupPolicy" else ""
        spec = doc.get("spec") or {}
        self.schedule = Cron(spec.get("schedule", "* * * * *"))
        self.conditions = spec.get("conditions")
        # reuse the Rule match/exclude machinery
        self._pseudo_rule = Rule.from_dict({
            "name": self.name,
            "match": spec.get("match") or {},
            "exclude": spec.get("exclude") or {},
        })
        self.last_execution: Optional[dt.datetime] = None

    def next_execution(self, after: dt.datetime) -> dt.datetime:
        return self.schedule.next_after(after)

    def matches(self, resource: Dict[str, Any], ns_labels: Dict[str, str],
                data_sources=None) -> bool:
        if self.namespace and (resource.get("metadata") or {}).get("namespace") != self.namespace:
            return False
        reasons = matches_resource_description(
            resource, self._pseudo_rule, namespace_labels=ns_labels)
        if reasons:
            return False
        if self.conditions is not None:
            pctx = build_scan_context(
                ClusterPolicy.from_dict({"metadata": {"name": self.name}, "spec": {}}),
                resource, ns_labels)
            # cleanup conditions address the candidate as {{ target.* }}
            # (cleanup handlers.go: the target resource binds there)
            pctx.json_context.add_json({"target": resource})
            context_entries = (self.raw.get("spec") or {}).get("context")
            if context_entries:
                from ..engine.contextloaders import load_context_entries

                load_context_entries(pctx.json_context, context_entries,
                                     sources=data_sources)
            return evaluate_conditions(pctx.json_context, self.conditions)
        return True


def validate_cleanup_policy(doc: Dict[str, Any]) -> List[str]:
    """Admission-time (Cluster)CleanupPolicy validation
    (pkg/validation/cleanuppolicy): schedule must be a valid cron,
    match/exclude may not carry user info (there is no requester at
    cleanup time), and context entries are restricted — imageRegistry
    is not supported for cleanup policies."""
    errors: List[str] = []
    spec = doc.get("spec") or {}
    schedule = spec.get("schedule")
    if not schedule:
        errors.append("spec.schedule is required")
    else:
        try:
            Cron(schedule)
        except CronError as e:
            errors.append(f"invalid cron schedule {schedule!r}: {e}")
    for block_name in ("match", "exclude"):
        block = spec.get(block_name) or {}
        for entry in list(block.get("any") or []) + list(block.get("all") or []):
            if any(entry.get(k) for k in ("subjects", "roles", "clusterRoles")):
                errors.append(
                    f"{block_name} may not contain subjects/roles/clusterRoles")
    # cleanup_policy_types.go:180 ValidateContext: imageRegistry and
    # configMap context entries are not allowed in cleanup policies
    for entry in spec.get("context") or []:
        if "imageRegistry" in entry:
            errors.append("ImageRegistry is not allowed in CleanUp Policy")
        if "configMap" in entry:
            errors.append("ConfigMap is not allowed in CleanUp Policy")
    return errors


class CleanupController:
    def __init__(self, snapshot: ClusterSnapshot, data_sources=None):
        self.snapshot = snapshot
        self.data_sources = data_sources  # context-entry backends
        self.policies: Dict[str, CleanupPolicy] = {}
        self.deleted_total = 0

    def set_policy(self, doc: Dict[str, Any]) -> CleanupPolicy:
        p = CleanupPolicy(doc)
        self.policies[p.name] = p
        return p

    def unset_policy(self, name: str) -> None:
        self.policies.pop(name, None)

    def run_due(self, now: Optional[dt.datetime] = None) -> int:
        """Execute every policy whose schedule fired since its last
        execution; returns deletions performed."""
        now = now or dt.datetime.now()
        deleted = 0
        for policy in list(self.policies.values()):
            baseline = policy.last_execution or now - dt.timedelta(minutes=1)
            due = policy.next_execution(baseline)
            if due <= now:
                deleted += self.execute(policy)
                policy.last_execution = now
        self.deleted_total += deleted
        return deleted

    def execute(self, policy: CleanupPolicy) -> int:
        ns_labels = self.snapshot.namespace_labels()
        doomed: List[str] = []
        for uid, res, _ in self.snapshot.items():
            meta = res.get("metadata") or {}
            key = meta.get("name", "") if res.get("kind") == "Namespace" else meta.get("namespace", "")
            if policy.matches(res, ns_labels.get(key, {}), self.data_sources):
                doomed.append(uid)
        for uid in doomed:
            self.snapshot.delete(uid)
        return len(doomed)


class TtlController:
    def __init__(self, snapshot: ClusterSnapshot):
        self.snapshot = snapshot
        self.deleted_total = 0

    @staticmethod
    def _expiry(res: Dict[str, Any]) -> Optional[dt.datetime]:
        meta = res.get("metadata") or {}
        ttl = (meta.get("labels") or {}).get(TTL_LABEL)
        if not ttl:
            return None
        dur = parse_duration(ttl)
        if dur is not None:
            created = meta.get("creationTimestamp")
            if not created:
                return None
            try:
                base = dt.datetime.fromisoformat(created.replace("Z", "+00:00"))
            except ValueError:
                return None
            return base + dt.timedelta(seconds=dur / 1e9)
        try:  # absolute forms the reference accepts: ISO date or datetime
            return dt.datetime.fromisoformat(ttl.replace("Z", "+00:00"))
        except ValueError:
            return None

    def run_once(self, now: Optional[dt.datetime] = None) -> int:
        now = now or dt.datetime.now(dt.timezone.utc)
        doomed = []
        for uid, res, _ in self.snapshot.items():
            exp = self._expiry(res)
            if exp is None:
                continue
            if exp.tzinfo is None:
                exp = exp.replace(tzinfo=dt.timezone.utc)
            if exp <= now:
                doomed.append(uid)
        for uid in doomed:
            self.snapshot.delete(uid)
        self.deleted_total += len(doomed)
        return len(doomed)
