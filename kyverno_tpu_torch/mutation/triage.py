# Copied verbatim from kyverno_tpu/mutation/triage.py.
"""Needs-mutation triage predicates.

A mutate rule's match/exclude/preconditions decide WHETHER the rule
applies; only then does the patch body matter. Triage reuses the
validate compiler wholesale by wrapping that predicate in a synthetic
``validate: {deny: {}}`` shell: an empty deny compiles to an
unconditionally-satisfied program, so the device verdict collapses to
the predicate itself —

    PASS / FAIL        -> rule applies (triage-positive)
    SKIP / NOT_MATCHED -> rule does not apply (triage-negative)
    ERROR / HOST       -> could not decide on device (host-routes)

``celPreconditions`` ride along in the synthetic dict on purpose: the
IR compiler raises ``Unsupported`` on them, which host-routes the rule
instead of silently dropping the condition.
"""

from __future__ import annotations

from typing import Any, Dict

from ..api.policy import ClusterPolicy, Rule

# predicate-relevant keys copied verbatim from the mutate rule's raw
# dict into the synthetic validate rule
_PREDICATE_KEYS = ("match", "exclude", "preconditions", "context",
                   "celPreconditions")


def triage_rule(rule: Rule) -> Rule:
    """Wrap a mutate rule's predicate in an empty-deny validate shell.

    The returned Rule compiles through ``tpu.ir.compile_rule`` exactly
    like a validate rule; its raw dict carries the original match /
    exclude / preconditions / context / celPreconditions so static
    context folding and unsupported-feature detection see the real
    predicate."""
    d: Dict[str, Any] = {"name": rule.name}
    raw = rule.raw or {}
    for key in _PREDICATE_KEYS:
        if raw.get(key) is not None:
            d[key] = raw[key]
    d["validate"] = {"deny": {}}
    return Rule.from_dict(d)


def synthetic_triage_policy(policy: ClusterPolicy) -> ClusterPolicy:
    """A ClusterPolicy whose rules are the triage shells of ``policy``'s
    mutate rules — the scalar oracle for triage verdicts (bench and
    shadow verification run it through ``Engine.validate``)."""
    meta = dict((policy.raw or {}).get("metadata") or {})
    meta["name"] = policy.name
    return ClusterPolicy.from_dict({
        "apiVersion": "kyverno.io/v1",
        "kind": "Policy" if policy.is_namespaced else "ClusterPolicy",
        "metadata": meta,
        "spec": {
            "validationFailureAction": "Enforce",
            "rules": [triage_rule(r).raw for r in policy.get_rules()
                      if r.has_mutate()],
        },
    })
