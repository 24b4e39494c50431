# Copied from kyverno_tpu/mutation/coordinator.py (metrics counted only
# when a registry is passed: the port has no global registry).
"""Batched-mutation coordinator: triage rows in, patched resource out.

Per admission the webhook hands over one resource plus the (M,) triage
row list from ``TorchEngine.triage_mutate`` (bank order). The coordinator
walks policies in compiled-bank order and, per policy, takes exactly
one of three paths:

- **skip** — every rule row is triage-negative (SKIP / NOT_MATCHED):
  the policy never touches the resource. This is the ~95% case the
  device batch exists for.
- **template** — every row is decidable on device and every positive
  rule carries a lowered ``PatchTemplate``: stamp the templates in
  rule order, bit-identical to the scalar patcher.
- **scalar** — anything else (host-routed rows, positive rules outside
  the lowerable subset, or a template stamp that throws): run the full
  policy through ``Engine.mutate``, which re-evaluates predicates
  host-side and chains patches exactly like the legacy path.

Patched output chains across policies either way, so a later policy's
scalar pass sees earlier template stamps and vice versa. Scalar-path
crashes degrade to per-rule ERROR entries with the resource left as it
was before that policy — the bottom of the degradation ladder.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..resilience.faults import SITE_MUTATE_PATCH, global_faults


@dataclass
class MutationOutcome:
    """Result of one coordinated mutate pass over all policies."""

    patched: Any
    changed: bool = False
    template_rules: int = 0     # rules applied by template stamp
    scalar_policies: int = 0    # policies routed to Engine.mutate
    skipped_policies: int = 0   # all-negative policies (never touched)
    fallbacks: int = 0          # template paths that degraded to scalar
    errors: List[Tuple[str, str, str]] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)


def _scalar_policy(engine: Any, policy: Any, patched: Any,
                   namespace_labels: Optional[Dict[str, str]],
                   operation: str, admission_info: Any,
                   out: MutationOutcome) -> Any:
    """Run one policy through the scalar patcher; returns the (possibly
    new) patched resource. Crashes become per-rule ERROR entries."""
    from ..tpu.engine import build_scan_context

    try:
        pctx = build_scan_context(policy, patched, namespace_labels,
                                  operation, admission_info)
        resp = engine.scalar.mutate(pctx)
    except Exception as e:  # noqa: BLE001 — ladder bottom: per-rule ERROR
        for rule in policy.get_rules():
            if rule.has_mutate():
                out.errors.append((policy.name, rule.name,
                                   f"scalar patcher crashed: {e}"))
        return patched
    out.scalar_policies += 1
    for rr in resp.policy_response.rules:
        if rr.status == "error":
            out.errors.append((policy.name, rr.name, rr.message))
    new = resp.patched_resource
    return patched if new is None else new


def apply_mutations(
    engine: Any,
    resource: Dict[str, Any],
    rows: Sequence[Tuple[Tuple[str, str], int]],
    namespace_labels: Optional[Dict[str, str]] = None,
    operation: str = "CREATE",
    admission_info: Any = None,
    registry: Any = None,
) -> MutationOutcome:
    """Apply every mutate policy in ``engine.cps`` to ``resource``,
    routed by ``rows`` — the bank-ordered ``((policy, rule), code)``
    triage verdicts (an all-HOST list degrades everything to the scalar
    patcher, which is the pipeline's fallback/hedge contract).
    ``registry``, when given, counts patches by source and template
    fallbacks as the reference's metrics registry does; the outcome
    carries the same counts either way."""
    from ..tpu.evaluator import ERROR, HOST, NOT_MATCHED, SKIP

    def count(metric: str, labels=None, n: int = 1) -> None:
        if registry is None:
            return
        m = getattr(registry, metric)
        if labels is None:
            m.inc()
        else:
            m.inc(labels, n)

    cps = engine.cps
    out = MutationOutcome(patched=resource)
    if not cps.mutate_rules:
        return out

    codes = {ident: int(code) for ident, code in rows}
    templates = dict(zip(cps.mutate_rules, cps.mutate_templates))
    by_policy: Dict[str, List[Tuple[str, str]]] = {}
    for ident in cps.mutate_rules:
        by_policy.setdefault(ident[0], []).append(ident)
    policies = {p.name: p for p in cps.policies}

    patched = resource
    for pname, idents in by_policy.items():
        policy = policies.get(pname)
        if policy is None:
            continue
        pcodes = [codes.get(i, HOST) for i in idents]
        if all(c in (SKIP, NOT_MATCHED) for c in pcodes):
            out.skipped_policies += 1
            continue
        host = any(c == ERROR or c >= HOST for c in pcodes)
        positive = [i for i, c in zip(idents, pcodes)
                    if c not in (SKIP, NOT_MATCHED, ERROR) and c < HOST]
        if host or any(templates.get(i) is None for i in positive):
            patched = _scalar_policy(engine, policy, patched,
                                     namespace_labels, operation,
                                     admission_info, out)
            count("mutate_patches", {"source": "scalar"})
            continue
        try:
            global_faults.fire(SITE_MUTATE_PATCH)
            stamped = patched
            for ident in positive:
                stamped = templates[ident].stamp(stamped)
            patched = stamped
            out.template_rules += len(positive)
            count("mutate_patches", {"source": "template"}, len(positive))
        except Exception as e:  # noqa: BLE001 — degrade to the oracle
            out.fallbacks += 1
            out.warnings.append(f"{pname}: template stamp fell back "
                                f"to scalar patcher: {e}")
            count("mutate_patch_fallbacks")
            patched = _scalar_policy(engine, policy, patched,
                                     namespace_labels, operation,
                                     admission_info, out)
            count("mutate_patches", {"source": "scalar"})

    out.patched = patched
    out.changed = patched is not resource and patched != resource
    return out
