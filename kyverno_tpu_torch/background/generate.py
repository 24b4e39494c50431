# Copied verbatim from kyverno_tpu/background/generate.py.
"""Generate executor — synthesize/clone downstream resources.

Mirror of pkg/background/generate (generate.go:97 ProcessUR,
:334 ApplyGeneratePolicy, :401 applyRule, data.go, clone.go,
cleanup.go): on a trigger admission the rule's target is created from
inline `data` (with variable substitution against the trigger context)
or cloned from a source resource; `synchronize: true` keeps downstream
resources updated and deletes them when their trigger goes away.

Downstream bookkeeping uses labels the reference also applies
(generate.kyverno.io/policy-name, .../trigger-uid) so cleanup can find
what a (policy, trigger) pair produced.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from ..api.policy import ClusterPolicy, Rule
from ..cluster.snapshot import ClusterSnapshot, resource_uid
from ..engine.conditions import evaluate_conditions
from ..engine.context import Context
from ..engine.match import matches_resource_description
from ..engine.variables import SubstitutionError, substitute_all
from ..tpu.engine import build_scan_context
from .updaterequest import UpdateRequest

LABEL_POLICY = "generate.kyverno.io/policy-name"
LABEL_TRIGGER_UID = "generate.kyverno.io/trigger-uid"


class GenerateError(Exception):
    pass


class GenerateController:
    def __init__(self, snapshot: ClusterSnapshot,
                 policies: Dict[str, ClusterPolicy],
                 allowed_groups: Optional[set] = None):
        self.snapshot = snapshot
        self.policies = policies  # name -> policy (live view)
        # API groups the background service account may write to
        # (generate.go auth.CanIGenerate / the chart's aggregated
        # clusterroles); None = unrestricted
        self.allowed_groups = allowed_groups

    # -- UR processing (generate.go:97)

    def process_ur(self, ur: UpdateRequest) -> List[Dict[str, Any]]:
        """Returns references to the resources actually generated (empty
        when every rule skipped) so callers can emit per-target events
        the way the reference's generate controller does."""
        generated: List[Dict[str, Any]] = []
        policy = self.policies.get(ur.policy)
        if policy is None:
            # policy deleted: nothing to generate; sync cleanup handles
            # downstreams via process_trigger_deletion
            return generated
        trigger = ur.trigger
        if ur.operation == "DELETE":
            self.process_trigger_deletion(policy, trigger)
            return generated
        for rule in policy.get_rules():
            if not rule.has_generate():
                continue
            if matches_resource_description(trigger, rule, operation=ur.operation):
                continue  # reasons => no match
            pctx = build_scan_context(policy, trigger, None, ur.operation)
            if not evaluate_conditions(pctx.json_context, rule.preconditions):
                continue
            ref = self._apply_rule(policy, rule, trigger, pctx.json_context)
            if ref is not None:
                generated.append(ref)
        return generated

    # -- rule application (generate.go:401)

    def _apply_rule(self, policy: ClusterPolicy, rule: Rule,
                    trigger: Dict[str, Any],
                    ctx: Context) -> Optional[Dict[str, Any]]:
        gen = rule.generation or {}
        try:
            spec = substitute_all(ctx, copy.deepcopy(gen))
        except SubstitutionError as e:
            raise GenerateError(f"substitution failed: {e}")
        api_version = spec.get("apiVersion", "v1")
        if self.allowed_groups is not None:
            group = api_version.split("/")[0] if "/" in api_version else ""
            if group not in self.allowed_groups:
                raise GenerateError(
                    f"background service account cannot create "
                    f"{api_version} resources (permission denied)")
        kind = spec.get("kind")
        name = spec.get("name")
        namespace = spec.get("namespace", "")
        if not kind or not name:
            raise GenerateError("generate rule needs kind and name")
        if spec.get("data") is not None:
            body = copy.deepcopy(spec["data"])
        elif spec.get("clone") is not None:
            src = self._find(kind, spec["clone"].get("namespace", ""), spec["clone"].get("name", ""))
            if src is None:
                raise GenerateError(
                    f"clone source {kind}/{spec['clone'].get('name')} not found")
            body = copy.deepcopy(src)
            (body.get("metadata") or {}).pop("uid", None)
            (body.get("metadata") or {}).pop("resourceVersion", None)
        else:
            raise GenerateError("generate rule needs data or clone")

        target = {
            "apiVersion": api_version,
            "kind": kind,
            **body,
        }
        meta = target.setdefault("metadata", {})
        meta["name"] = name
        if namespace:
            meta["namespace"] = namespace
        labels = meta.setdefault("labels", {})
        labels[LABEL_POLICY] = policy.name
        labels[LABEL_TRIGGER_UID] = resource_uid(trigger)

        existing = self._find(kind, namespace, name)
        if existing is not None and not spec.get("synchronize", False):
            return None  # without synchronize, existing targets are left alone
        self.snapshot.upsert(target)
        return {"apiVersion": api_version, "kind": kind, "name": name,
                "namespace": namespace}

    # -- downstream sync/cleanup (cleanup.go)

    def process_trigger_deletion(self, policy: ClusterPolicy, trigger: Dict[str, Any]) -> int:
        """Delete synchronized downstream resources of a deleted
        trigger. Returns number deleted."""
        uid = resource_uid(trigger)
        sync_rules = [r for r in policy.get_rules()
                      if r.has_generate() and (r.generation or {}).get("synchronize")]
        if not sync_rules:
            return 0
        deleted = 0
        for target_uid, res, _ in self.snapshot.items():
            labels = (res.get("metadata") or {}).get("labels") or {}
            if labels.get(LABEL_POLICY) == policy.name and labels.get(LABEL_TRIGGER_UID) == uid:
                self.snapshot.delete(target_uid)
                deleted += 1
        return deleted

    def _find(self, kind: str, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        for _, res, _ in self.snapshot.items():
            meta = res.get("metadata") or {}
            if res.get("kind") == kind and meta.get("name") == name \
                    and meta.get("namespace", "") == (namespace or ""):
                return res
        return None
