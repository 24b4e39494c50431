# Copied verbatim from kyverno_tpu/background/mutate_existing.py.
"""Mutate-existing executor — patch pre-existing target resources.

Mirror of pkg/background/mutate + engine handlers/mutation/
mutate_existing.go: rules with `mutate.targets` patch resources other
than the trigger. On a trigger event the UR names the policy; targets
are resolved from the snapshot by kind/name/namespace (with variable
substitution against the trigger context), patched with the rule's
strategic-merge/JSON6902 body, and written back.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from ..api.policy import ClusterPolicy, Rule
from ..cluster.snapshot import ClusterSnapshot
from ..engine import mutate as mutatepkg
from ..engine.conditions import evaluate_conditions
from ..engine.variables import SubstitutionError, substitute_all
from ..tpu.engine import build_scan_context
from ..utils.wildcard import match as wildcard_match
from .updaterequest import UpdateRequest


class MutateExistingError(Exception):
    pass


class MutateExistingController:
    def __init__(self, snapshot: ClusterSnapshot, policies: Dict[str, ClusterPolicy]):
        self.snapshot = snapshot
        self.policies = policies

    def process_ur(self, ur: UpdateRequest) -> None:
        policy = self.policies.get(ur.policy)
        if policy is None:
            return
        for rule in policy.get_rules():
            m = rule.mutation or {}
            if not m.get("targets"):
                continue
            pctx = build_scan_context(policy, ur.trigger, None, ur.operation)
            ctx = pctx.json_context
            if not evaluate_conditions(ctx, rule.preconditions):
                continue
            # per-target preconditions reference {{ target.* }}, which
            # only binds once a concrete target is selected — strip
            # them before selector substitution, evaluate them inside
            # _patch after add_target_resource
            raw_targets = copy.deepcopy(m["targets"])
            target_pres = [t.pop("preconditions", None) for t in raw_targets]
            try:
                targets = substitute_all(ctx, raw_targets)
            except SubstitutionError as e:
                raise MutateExistingError(f"target substitution failed: {e}")
            for tsel, pre in zip(targets, target_pres):
                for uid, res, _ in self.snapshot.items():
                    if not self._target_matches(tsel, res):
                        continue
                    patched = self._patch(ctx, rule, res, pre)
                    if patched is not None and patched != res:
                        self.snapshot.upsert(patched)

    @staticmethod
    def _target_matches(tsel: Dict[str, Any], res: Dict[str, Any]) -> bool:
        meta = res.get("metadata") or {}
        if tsel.get("kind") and not wildcard_match(tsel["kind"], res.get("kind", "")):
            return False
        if tsel.get("apiVersion") and not wildcard_match(
                tsel["apiVersion"], res.get("apiVersion", "")):
            return False
        if tsel.get("name") and not wildcard_match(tsel["name"], meta.get("name", "")):
            return False
        if tsel.get("namespace") and not wildcard_match(
                tsel["namespace"], meta.get("namespace", "")):
            return False
        return True

    def _patch(self, ctx, rule: Rule, target: Dict[str, Any],
               preconditions=None) -> Optional[Dict[str, Any]]:
        m = rule.mutation or {}
        ctx.checkpoint()
        try:
            ctx.add_target_resource(target)
            if preconditions is not None and not evaluate_conditions(
                    ctx, preconditions):
                return None
            try:
                if m.get("patchStrategicMerge") is not None:
                    overlay = substitute_all(ctx, copy.deepcopy(m["patchStrategicMerge"]))
                    return mutatepkg.strategic_merge(copy.deepcopy(target), overlay)
                if m.get("patchesJson6902") is not None:
                    patches = mutatepkg.load_json6902(m["patchesJson6902"])
                    patches = substitute_all(ctx, patches)
                    return mutatepkg.apply_json6902(copy.deepcopy(target), patches)
            except (SubstitutionError, mutatepkg.PatchError) as e:
                raise MutateExistingError(str(e))
            return None
        finally:
            ctx.restore()
