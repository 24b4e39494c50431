# Copied verbatim from kyverno_tpu/analysis/witness.py.
"""Witness synthesis — machine-generated resources that exercise a rule.

For each compiled rule the synthesizer builds a small targeted corpus:

- one **minimal passing witness**: a resource the rule's match/exclude
  selectors accept whose body satisfies the validate constraints;
- one or more **minimal violating witnesses**: the passing witness with
  ONE constraint flipped (a leaf value the pattern rejects, a negation
  key materialized, a deny condition driven true);
- **boundary mutants** for glob/DFA string patterns and numeric
  comparisons: values sitting just inside/outside the accepting set,
  generated from the compiled leaf IR (``tpu/ir.py`` ``compile_leaf``)
  and checked against the compiled glob DFA (``tpu/dfa.py``) plus the
  scalar pattern oracle (``engine/pattern.validate``) so every mutant's
  intent label is *verified*, never guessed.

Everything is over-approximate by design (the approximate-reduction
stance of arXiv:1710.08647): a witness set can miss inputs, so absence
of evidence is reported conservatively — the analyzer only calls a rule
``dead`` when the synthesizer covered the whole match shape
(``exhaustive``) and still could not produce a matching resource, and
every surfaced anomaly is re-confirmed through the scalar oracle.

The module imports no jax: synthesis is pure host work reusing the IR
leaf compilers and the host matchers as checking oracles.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..api.policy import ClusterPolicy, MatchResources, ResourceFilter, Rule
from ..engine import anchor as anchorpkg
from ..engine.match import RequestInfo, matches_resource_description
from ..engine.pattern import go_parse_float, validate as leaf_validate
from ..utils import kube
from ..utils.wildcard import contains_wildcard, match as wild_match


class Unsynthesizable(Exception):
    """Match/validate shape outside the synthesizer's subset — the rule
    is reported unanalyzable, never anomalous."""


_UNSAT = object()

# core-group kinds served from apiVersion v1; everything else defaults
# to apps/v1 (witnesses only need to LOOK like the kind for the match
# plane — kind/apiVersion/metadata — not to be schema-complete)
_CORE_KINDS = {
    "Pod", "Service", "ConfigMap", "Secret", "Namespace", "Node",
    "ServiceAccount", "PersistentVolume", "PersistentVolumeClaim",
    "ReplicationController", "Endpoints", "Event", "LimitRange",
    "ResourceQuota",
}
_GROUP_VERSIONS = {
    "apps": "apps/v1", "batch": "batch/v1",
    "networking.k8s.io": "networking.k8s.io/v1",
    "rbac.authorization.k8s.io": "rbac.authorization.k8s.io/v1",
}
_KIND_GROUPS = {
    "Deployment": "apps/v1", "StatefulSet": "apps/v1",
    "DaemonSet": "apps/v1", "ReplicaSet": "apps/v1",
    "Job": "batch/v1", "CronJob": "batch/v1",
    "Ingress": "networking.k8s.io/v1",
    "NetworkPolicy": "networking.k8s.io/v1",
    "Role": "rbac.authorization.k8s.io/v1",
    "RoleBinding": "rbac.authorization.k8s.io/v1",
}

_CLUSTER_SCOPED = {"Namespace", "Node", "PersistentVolume", "ClusterRole",
                   "ClusterRoleBinding", "CustomResourceDefinition"}


def glob_instance(pattern: str, avoid: Sequence[str] = ()) -> Optional[str]:
    """A concrete string matching the glob, verified through the SAME
    matcher the engine uses (utils/wildcard.match); ``avoid`` lists
    strings the instance must differ from (exclude avoidance)."""
    fills = ["x", "w1", "wit", "a0", "zz9"]
    cands = []
    for f in fills:
        cands.append(pattern.replace("*", f).replace("?", f[0]))
        cands.append(pattern.replace("*", "").replace("?", f[0]))
    if not contains_wildcard(pattern):
        cands = [pattern]
    for c in cands:
        if c and c not in avoid and wild_match(pattern, c):
            return c
    return None


def glob_counterexample(pattern: str) -> Optional[str]:
    """A concrete string the glob rejects (boundary mutants)."""
    inst = glob_instance(pattern) or "x"
    for c in ("witness-no-match-zq", inst + "-zq", "zq-" + inst, inst[:-1],
              ""):
        if not wild_match(pattern, c):
            return c
    return None


def dfa_boundary_values(pattern: str, cap: int = 3) -> List[str]:
    """Strings probing the accept frontier of the COMPILED glob DFA
    (tpu/dfa.py compile_glob — the very transition tables the device
    scans, memoized process-wide): the verified instance plus
    single-edit perturbations, each labeled by the host-side table
    walk AND cross-checked against the scalar glob matcher. A value
    the two disagree on sits in the table's over-approximation zone —
    dropped, because its intent label would be a guess."""
    try:
        from ..tpu.dfa import compile_glob

        dfa = compile_glob(pattern)
    except Exception:  # noqa: BLE001
        return []  # unsupported pattern class: no DFA to probe
    inst = glob_instance(pattern)
    if inst is None:
        return []
    out: List[str] = []
    for cand in (inst, inst[:-1], inst + "z", "z" + inst):
        if cand in out:
            continue
        try:
            hit = dfa.match_str(cand)
        except Exception:  # noqa: BLE001
            continue
        if hit == wild_match(pattern, cand):
            out.append(cand)
        if len(out) >= cap:
            break
    return out


# ---------------------------------------------------------------------------
# leaf value synthesis (reuses the ir.py leaf compilers + the scalar
# pattern oracle as the accept/reject checker)


def _leaf_candidates(pattern: Any) -> List[Any]:
    """Candidate values for a scalar pattern leaf, derived from the
    compiled leaf IR (operators, ranges, globs, units)."""
    from ..tpu.ir import (BoolLeaf, Cmp, NullLeaf, NumLeaf, StrLeaf,
                          Unsupported, compile_leaf)

    try:
        leaf = compile_leaf(pattern)
    except Unsupported:
        return []
    if isinstance(leaf, BoolLeaf):
        return [leaf.value, not leaf.value]
    if isinstance(leaf, NumLeaf):
        v = leaf.value
        return [v, v + 1, v - 1, 0]
    if isinstance(leaf, NullLeaf):
        return [None, "set"]
    out: List[Any] = []
    if isinstance(leaf, StrLeaf):
        if leaf.is_star:
            return ["anything"]
        for units in leaf.alternatives:
            for unit in units:
                for c in unit:
                    out.extend(_cmp_candidates(c))
    # generic fallbacks so violation candidates always exist
    out.extend(["witness-no-match-zq", 0, 9999999, -1, True, False, ""])
    return out


def _cmp_candidates(c) -> List[Any]:
    """Values around ONE operator+operand comparison: the operand
    itself, boundary neighbours for numeric/range operators, and
    glob instances/counterexamples for glob operands."""
    from ..engine.operator import Operator

    out: List[Any] = []
    op, operand = c.op, c.operand
    if c.is_glob:
        inst = glob_instance(operand)
        if inst is not None:
            out.append(inst)
        ce = glob_counterexample(operand)
        if ce is not None:
            out.append(ce)
        # frontier probes from the compiled DFA tables themselves
        for v in dfa_boundary_values(operand):
            if v not in out:
                out.append(v)
        return out
    out.append(operand)
    f = go_parse_float(operand)
    if f is not None and op in (Operator.MORE, Operator.MORE_EQUAL,
                                Operator.LESS, Operator.LESS_EQUAL,
                                Operator.EQUAL, Operator.NOT_EQUAL):
        base = int(f) if f == int(f) else f
        out.extend([base, base + 1, base - 1])
    if c.dur_ns is not None:
        out.extend([operand, "0s", "1000h"])
    if c.qty is not None:
        out.extend(["1m", "512Mi", "100"])
    if op is Operator.NOT_EQUAL:
        out.append(str(operand) + "-zq")
    return out


def satisfy_leaf(pattern: Any) -> Any:
    """A value the scalar pattern oracle ACCEPTS for this leaf, or
    _UNSAT."""
    for cand in _leaf_candidates(pattern):
        try:
            if leaf_validate(cand, pattern):
                return cand
        except Exception:  # noqa: BLE001
            continue
    return _UNSAT


def violate_leaf(pattern: Any) -> Any:
    """A value the oracle REJECTS, or _UNSAT (e.g. pattern '*')."""
    for cand in _leaf_candidates(pattern):
        try:
            if not leaf_validate(cand, pattern):
                return cand
        except Exception:  # noqa: BLE001
            continue
    return _UNSAT


def boundary_mutants(pattern: Any, cap: int = 4) -> List[Any]:
    """Distinct leaf values sitting around the accepting boundary
    (glob near-misses, numeric +-1 neighbours) — each verified against
    the oracle so it is a REAL boundary probe, capped to keep the
    witness corpus small."""
    seen: List[Any] = []
    for cand in _leaf_candidates(pattern):
        if cand in seen:
            continue
        try:
            leaf_validate(cand, pattern)
        except Exception:  # noqa: BLE001
            continue
        seen.append(cand)
        if len(seen) >= cap:
            break
    return seen


# ---------------------------------------------------------------------------
# pattern-tree assignment synthesis


def _is_scalar(v: Any) -> bool:
    return not isinstance(v, (dict, list))


def synth_pattern(pattern: Any):
    """(passing_fragment, violations) for one validate pattern tree.

    ``passing_fragment`` is a resource fragment satisfying the pattern
    (required keys present with accepting leaf values, negation keys
    absent, condition anchors satisfied so sibling constraints apply);
    ``violations`` is a list of (fragment, note) alternatives, each the
    passing fragment with exactly one constraint flipped. Raises
    Unsynthesizable for shapes the assignment walk cannot model."""
    frag = _satisfy(pattern)
    if frag is _UNSAT:
        raise Unsynthesizable("pattern has no satisfying assignment")
    violations: List[Tuple[Any, str]] = []
    _violations(pattern, frag, [], violations, cap=3)
    return frag, violations


def _satisfy(pattern: Any) -> Any:
    if isinstance(pattern, dict):
        out: Dict[str, Any] = {}
        for raw_key, value in pattern.items():
            raw_key = str(raw_key)
            a = anchorpkg.parse(raw_key)
            key = a.key if a is not None else raw_key
            if anchorpkg.is_negation(a):
                continue  # X(key): key must stay absent
            if contains_wildcard(key):
                inst = glob_instance(key)
                if inst is None:
                    return _UNSAT
                key = inst
            if anchorpkg.is_existence(a):
                if not isinstance(value, list) or not value:
                    return _UNSAT
                el = _satisfy(value[0])
                if el is _UNSAT:
                    return _UNSAT
                out[key] = [el]
                continue
            sub = _satisfy(value)
            if sub is _UNSAT:
                return _UNSAT
            out[key] = sub
        return out
    if isinstance(pattern, list):
        if not pattern:
            return _UNSAT  # empty pattern array: constant fail
        el = _satisfy(pattern[0])
        if el is _UNSAT:
            return _UNSAT
        return [el]
    if pattern == "*":
        return "anything"
    val = satisfy_leaf(pattern)
    return val


def _violations(pattern: Any, root: Any, path: List[Any],
                out: List[Tuple[Any, str]], cap: int) -> None:
    """Collect up to ``cap`` single-flip violating fragments; ``root``
    is always the whole passing fragment, ``path`` the walk position."""
    if len(out) >= cap:
        return
    if isinstance(pattern, dict):
        for raw_key, value in pattern.items():
            if len(out) >= cap:
                return
            raw_key = str(raw_key)
            a = anchorpkg.parse(raw_key)
            key = a.key if a is not None else raw_key
            if contains_wildcard(key):
                key = glob_instance(key) or key
            if anchorpkg.is_negation(a):
                # materialize the forbidden key
                v = copy.deepcopy(root)
                _set_path(v, path + [key], "present")
                out.append((v, f"negation key {key} present"))
                continue
            if anchorpkg.is_condition(a):
                continue  # flipping a condition merely skips the branch
            if anchorpkg.is_existence(a):
                v = copy.deepcopy(root)
                _set_path(v, path + [key], [])
                out.append((v, f"existence anchor {key} unmet"))
                continue
            _violations(value, root, path + [key], out, cap)
        return
    if isinstance(pattern, list):
        if pattern:
            _violations(pattern[0], root, path + [0], out, cap)
        return
    # scalar leaf: flip the value at `path` inside the ROOT fragment
    bad = violate_leaf(pattern)
    if bad is _UNSAT or not path:
        return
    v = copy.deepcopy(root)
    try:
        _set_path(v, path, bad)
    except Exception:  # noqa: BLE001
        return
    out.append((v, f"leaf at {'.'.join(str(p) for p in path)} violated"))


def _set_path(tree: Any, path: List[Any], value: Any) -> None:
    cur = tree
    for seg in path[:-1]:
        if isinstance(seg, int):
            cur = cur[seg]
        else:
            cur = cur.setdefault(seg, {})
    last = path[-1]
    if isinstance(last, int):
        cur[last] = value
    else:
        cur[last] = value


def pattern_mutants(pattern: Any, frag: Any, cap: int = 4
                    ) -> List[Tuple[Any, str]]:
    """Boundary-mutant fragments: the passing fragment with one leaf
    replaced by each verified boundary value (glob/DFA and numeric
    boundaries — tpu/dfa.py pattern semantics probed from the host
    side)."""
    leaves: List[Tuple[List[Any], Any]] = []
    _collect_leaves(pattern, [], leaves)
    out: List[Tuple[Any, str]] = []
    for path, leaf_pattern in leaves:
        if len(out) >= cap:
            break
        if not isinstance(leaf_pattern, str) or leaf_pattern == "*":
            continue
        interesting = (contains_wildcard(leaf_pattern)
                       or any(leaf_pattern.startswith(op)
                              for op in ("<", ">", "!"))
                       or "-" in leaf_pattern or "|" in leaf_pattern)
        if not interesting:
            continue
        for mv in boundary_mutants(leaf_pattern, cap=2):
            if len(out) >= cap:
                break
            root = copy.deepcopy(frag)
            try:
                _set_path(root, path, mv)
            except Exception:  # noqa: BLE001
                continue
            out.append((root, f"boundary {mv!r} at "
                              f"{'.'.join(str(p) for p in path)}"))
    return out


def _collect_leaves(pattern: Any, path: List[Any],
                    out: List[Tuple[List[Any], Any]]) -> None:
    if isinstance(pattern, dict):
        for raw_key, value in pattern.items():
            raw_key = str(raw_key)
            a = anchorpkg.parse(raw_key)
            if anchorpkg.is_negation(a):
                continue
            key = a.key if a is not None else raw_key
            if contains_wildcard(key):
                key = glob_instance(key) or key
            if anchorpkg.is_existence(a):
                if isinstance(value, list) and value:
                    _collect_leaves(value[0], path + [key, 0], out)
                continue
            _collect_leaves(value, path + [key], out)
    elif isinstance(pattern, list):
        if pattern:
            _collect_leaves(pattern[0], path + [0], out)
    else:
        out.append((path, pattern))


# ---------------------------------------------------------------------------
# deny-condition assignment (the tractable request.object chain subset)


def _cond_key_path(key: Any) -> Optional[Tuple[str, ...]]:
    """`{{ request.object.a.b.c }}` -> ('a','b','c'); None otherwise."""
    if not isinstance(key, str):
        return None
    key = key.strip()
    if not (key.startswith("{{") and key.endswith("}}")):
        return None
    expr = key[2:-2].strip()
    parts = expr.split(".")
    if len(parts) < 3 or parts[0] != "request" or parts[1] != "object":
        return None
    segs = tuple(p for p in parts[2:])
    if any(not s or "[" in s or "(" in s or " " in s for s in segs):
        return None
    return segs


def _cond_assignment(cond: Dict[str, Any], want_true: bool
                     ) -> Optional[Tuple[Tuple[str, ...], Any]]:
    """(resource path, value) driving one condition to ``want_true``,
    or None when the condition shape is outside the subset."""
    segs = _cond_key_path(cond.get("key"))
    if segs is None:
        return None
    op = str(cond.get("operator", "")).lower()
    value = cond.get("value")
    scalar = _is_scalar(value) and not (
        isinstance(value, str) and "{{" in value)
    listval = (isinstance(value, list)
               and all(_is_scalar(v) for v in value) and value)
    if op in ("equals", "equal"):
        if not scalar:
            return None
        return (segs, value) if want_true else (segs, "zq-not-it")
    if op in ("notequals", "notequal"):
        if not scalar:
            return None
        return (segs, "zq-not-it") if want_true else (segs, value)
    if op in ("anyin", "in"):
        if not listval:
            return None
        return (segs, value[0]) if want_true else (segs, "zq-not-in")
    if op in ("anynotin", "notin"):
        if not listval:
            return None
        return (segs, "zq-not-in") if want_true else (segs, value[0])
    if op in ("greaterthan", "greaterthanorequals", "lessthan",
              "lessthanorequals"):
        f = value if isinstance(value, (int, float)) \
            else go_parse_float(str(value))
        if f is None or isinstance(value, bool):
            return None
        gt = op.startswith("greaterthan")
        hi, lo = f + 1, f - 1
        return (segs, hi if gt == want_true else lo)
    return None


def deny_assignments(conditions: Any, want_true: bool
                     ) -> Optional[List[Tuple[Tuple[str, ...], Any]]]:
    """Path assignments driving a deny/precondition tree to
    ``want_true`` (conditions all hold) or false. None = outside the
    subset."""
    if conditions is None:
        return []
    blocks: List[Dict[str, Any]] = []
    flat: List[Dict[str, Any]] = []
    if isinstance(conditions, dict):
        blocks = [conditions]
    elif isinstance(conditions, list):
        for item in conditions:
            if not isinstance(item, dict):
                return None
            if "any" in item or "all" in item:
                blocks.append(item)
            else:
                flat.append(item)
    else:
        return None
    if flat:
        blocks.append({"all": flat})
    out: List[Tuple[Tuple[str, ...], Any]] = []
    for block in blocks:
        any_list = block.get("any") or []
        all_list = block.get("all") or []
        if want_true:
            # every block true: all of `all`, first of `any`
            for c in all_list:
                a = _cond_assignment(c, True)
                if a is None:
                    return None
                out.append(a)
            if any_list:
                a = _cond_assignment(any_list[0], True)
                if a is None:
                    return None
                out.append(a)
        else:
            # ONE block false suffices: falsify the first condition
            target = (all_list or any_list)
            if not target:
                continue
            if all_list:
                a = _cond_assignment(all_list[0], False)
                if a is None:
                    return None
                return out + [a]
            # any-block false needs EVERY disjunct false
            for c in any_list:
                a = _cond_assignment(c, False)
                if a is None:
                    return None
                out.append(a)
            return out
    return out


# ---------------------------------------------------------------------------
# match skeleton

# max kind x operation combinations instantiated per match filter before
# synthesis falls back to first-index-only (and forfeits exhaustiveness)
_VARIANT_CAP = 8


@dataclass
class Skeleton:
    """The match-plane identity of a witness: the base resource plus
    the request attributes the selectors read."""

    resource: Dict[str, Any]
    operation: str = "CREATE"
    ns_labels: Dict[str, Dict[str, str]] = field(default_factory=dict)
    info: Optional[RequestInfo] = None


def _selector_labels(selector: Optional[Dict[str, Any]]
                     ) -> Optional[Dict[str, str]]:
    """Labels satisfying a label selector, or None (unsatisfiable /
    unsupported)."""
    if selector is None:
        return {}
    labels: Dict[str, str] = {}
    for k, v in (selector.get("matchLabels") or {}).items():
        k, v = str(k), str(v)
        ki = glob_instance(k) if contains_wildcard(k) else k
        vi = glob_instance(v) if contains_wildcard(v) else v
        if ki is None or vi is None:
            return None
        labels[ki] = vi
    for e in selector.get("matchExpressions") or []:
        key = str(e.get("key", ""))
        op = str(e.get("operator", ""))
        values = [str(v) for v in (e.get("values") or [])]
        if op == "In":
            if not values:
                return None
            labels[key] = values[0]
        elif op == "Exists":
            labels.setdefault(key, "present")
        elif op == "NotIn":
            labels.setdefault(key, "zq-none-of-these")
            if labels[key] in values:
                return None
        elif op == "DoesNotExist":
            if key in labels:
                return None
        else:
            return None
    return labels


def _filter_skeleton(rf: ResourceFilter, fallback_kind: str,
                     name_avoid: Sequence[str] = (),
                     ns_avoid: Sequence[str] = (),
                     kind_idx: int = 0, op_idx: int = 0
                     ) -> Tuple[Optional[Skeleton], bool]:
    """(skeleton, exhaustive) for one match filter. skeleton None =
    could not synthesize; exhaustive False = the filter uses features
    the synthesizer does not model (never classify dead from it).
    kind_idx/op_idx select which entry of a multi-valued kinds /
    operations list this skeleton instantiates — exhaustive dead
    classification requires the caller to cover every index (an exclude
    may eliminate kinds[0] while kinds[1] stays live)."""
    rd = rf.resources
    ui = rf.user_info
    exhaustive = True
    kind = fallback_kind
    api_version = None
    if rd.kinds:
        g, v, k, sub = kube.parse_kind_selector(str(rd.kinds[kind_idx]))
        if sub:
            return None, False  # subresource admission not modeled
        if contains_wildcard(k) and k != "*":
            return None, False
        kind = fallback_kind if k == "*" else k
        if g not in ("", "*"):
            api_version = _GROUP_VERSIONS.get(g, f"{g}/{v if v != '*' else 'v1'}")
        elif v not in ("", "*"):
            api_version = v
    if api_version is None:
        api_version = "v1" if kind in _CORE_KINDS \
            else _KIND_GROUPS.get(kind, "v1")
    name = "witness"
    if rd.name or rd.names:
        pats = ([rd.name] if rd.name else []) + list(rd.names)
        name = None
        for p in pats:
            name = glob_instance(str(p), avoid=name_avoid)
            if name is not None:
                break
        if name is None:
            return None, exhaustive
    elif kind == "Namespace" and rd.namespaces:
        # Namespace-kind resources compare their NAME against the
        # namespaces constraint (match.go) — the witness name must
        # come from that list, not the default
        name = glob_instance(str(rd.namespaces[0]), avoid=name_avoid) \
            or name
    namespace = "" if kind in _CLUSTER_SCOPED else "default"
    if rd.namespaces and kind not in _CLUSTER_SCOPED:
        namespace = None
        for p in rd.namespaces:
            namespace = glob_instance(str(p), avoid=ns_avoid)
            if namespace is not None:
                break
        if namespace is None:
            return None, exhaustive
    labels = _selector_labels(rd.selector)
    if labels is None:
        return None, exhaustive
    nsl = _selector_labels(rd.namespace_selector)
    if nsl is None:
        return None, exhaustive
    meta: Dict[str, Any] = {"name": name}
    if namespace:
        meta["namespace"] = namespace
    if labels:
        meta["labels"] = labels
    if rd.annotations:
        ann = {}
        for k, v in rd.annotations.items():
            if contains_wildcard(str(k)) or contains_wildcard(str(v)):
                return None, False
            ann[str(k)] = str(v)
        meta["annotations"] = ann
    resource = {"apiVersion": api_version, "kind": kind, "metadata": meta}
    operation = "CREATE"
    if rd.operations:
        operation = str(rd.operations[op_idx])
    info = None
    if not ui.is_empty():
        roles, croles, username, groups = [], [], "", []
        for r in ui.roles:
            if contains_wildcard(str(r)):
                return None, False
            roles.append(str(r))
        for r in ui.cluster_roles:
            if contains_wildcard(str(r)):
                return None, False
            croles.append(str(r))
        for s in ui.subjects or []:
            skind = s.get("kind")
            sname = str(s.get("name", ""))
            if skind == "User":
                username = sname
            elif skind == "Group":
                groups.append(sname)
            elif skind == "ServiceAccount":
                username = (f"system:serviceaccount:"
                            f"{s.get('namespace') or 'default'}:{sname}")
            else:
                return None, False
        info = RequestInfo(roles=roles, cluster_roles=croles,
                           username=username, groups=groups)
    ns_labels = {}
    if nsl and namespace:
        ns_labels[namespace] = nsl
    return Skeleton(resource=resource, operation=operation,
                    ns_labels=ns_labels, info=info), exhaustive


def _merge_skeletons(parts: List[Skeleton]) -> Optional[Skeleton]:
    """Conjoin `match.all` filter skeletons (shallow merge; conflicting
    identities are unsynthesizable)."""
    if not parts:
        return None
    base = copy.deepcopy(parts[0])
    for p in parts[1:]:
        for key in ("apiVersion", "kind"):
            if p.resource.get(key) != base.resource.get(key):
                return None
        bm, pm = base.resource["metadata"], p.resource["metadata"]
        for key in ("name", "namespace"):
            if key in pm and pm[key] != bm.get(key, pm[key]):
                return None
            if key in pm:
                bm[key] = pm[key]
        for key in ("labels", "annotations"):
            merged = dict(bm.get(key) or {})
            merged.update(pm.get(key) or {})
            if merged:
                bm[key] = merged
        base.ns_labels.update(p.ns_labels)
        if p.info is not None:
            base.info = p.info
        if p.operation != "CREATE":
            base.operation = p.operation
    return base


def _rule_kind_hint(rule: Rule) -> str:
    """Fallback kind when the match uses '*' kinds: prefer Pod."""
    return "Pod"


def match_skeletons(rule: Rule, policy_namespace: str = ""
                    ) -> Tuple[List[Skeleton], List[Skeleton], bool]:
    """Candidate skeletons for a rule's match block (one per `any`
    filter, or the merged `all`/legacy filter), each VERIFIED against
    the host matcher (match + exclude). Returns (matching skeletons,
    all candidates, exhaustive) — unmatched candidates still serve as
    dead-rule probe witnesses (their NOT_MATCHED verdicts are the
    oracle-confirmable evidence)."""
    m: MatchResources = rule.match
    exhaustive = True
    candidates: List[Skeleton] = []
    hint = _rule_kind_hint(rule)

    def alternatives(rf: ResourceFilter) -> List[Skeleton]:
        outs = []
        rd = rf.resources
        n_kinds = max(1, len(rd.kinds))
        n_ops = max(1, len(rd.operations))
        if n_kinds * n_ops > _VARIANT_CAP:
            # too many kind x operation combinations to instantiate —
            # first-index witnesses only, never claimable as dead
            nonlocal_flags["exhaustive"] = False
            n_kinds = n_ops = 1
        for ki in range(n_kinds):
            for oi in range(n_ops):
                for name_avoid, ns_avoid in (
                        ((), ()), (("witness",), ("default",)),
                        (("witness", "x"), ("default", "x"))):
                    sk, exh = _filter_skeleton(rf, hint, name_avoid, ns_avoid,
                                               kind_idx=ki, op_idx=oi)
                    if not exh:
                        nonlocal_flags["exhaustive"] = False
                    if sk is not None:
                        outs.append(sk)
        return outs

    nonlocal_flags = {"exhaustive": True}
    if m.any:
        for rf in m.any:
            candidates.extend(alternatives(rf))
    elif m.all:
        # the merged conjunction instantiates only each filter's first
        # kind/operation; varying indices independently across conjoined
        # filters is not modeled, so multi-valued filters forfeit the
        # exhaustiveness that dead classification requires
        for rf in m.all:
            if len(rf.resources.kinds) > 1 or len(rf.resources.operations) > 1:
                nonlocal_flags["exhaustive"] = False
                break
        # merged conjunction; alternatives vary the shared tweak level
        for i in range(3):
            parts = []
            ok = True
            for rf in m.all:
                avoid = ((), ()) if i == 0 else (
                    ("witness",) * i, ("default",) * i)
                sk, exh = _filter_skeleton(rf, hint, *avoid)
                if not exh:
                    nonlocal_flags["exhaustive"] = False
                if sk is None:
                    ok = False
                    break
                parts.append(sk)
            if ok:
                merged = _merge_skeletons(parts)
                if merged is not None:
                    candidates.append(merged)
    else:
        rf = ResourceFilter(resources=m.resources, user_info=m.user_info)
        if m.is_empty():
            return [], [], False  # match-all rules: no targeted synthesis
        candidates.extend(alternatives(rf))
    exhaustive = nonlocal_flags["exhaustive"]
    if policy_namespace:
        for sk in candidates:
            sk.resource["metadata"]["namespace"] = policy_namespace
    matched = []
    for sk in candidates:
        try:
            ns = sk.resource["metadata"].get("namespace", "")
            nsl = sk.ns_labels.get(ns, {})
            reasons = matches_resource_description(
                sk.resource, rule, sk.info, nsl,
                policy_namespace=policy_namespace,
                operation=sk.operation or "CREATE")
        except Exception:  # noqa: BLE001
            exhaustive = False
            continue
        if not reasons:
            matched.append(sk)
    return matched, candidates, exhaustive


# ---------------------------------------------------------------------------
# per-rule witness synthesis


@dataclass
class Witness:
    """One synthesized resource plus the request attributes it rides
    with, tagged with its generating rule and intent."""

    resource: Dict[str, Any]
    rule_row: int
    intent: str          # pass | violate | mutant | probe
    operation: str = "CREATE"
    ns_labels: Dict[str, Dict[str, str]] = field(default_factory=dict)
    info: Optional[RequestInfo] = None
    note: str = ""


@dataclass
class RuleSynthesis:
    """What the synthesizer could do for one rule row."""

    rule_row: int
    policy_name: str
    rule_name: str
    witnesses: List[int] = field(default_factory=list)  # corpus indices
    exhaustive: bool = False      # match shape fully modeled
    match_found: bool = True      # some skeleton passed the host matcher
    note: str = ""


def _deep_merge(base: Dict[str, Any], frag: Any) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    _merge_into(out, frag)
    return out


def _merge_into(dst: Any, src: Any) -> None:
    if not isinstance(dst, dict) or not isinstance(src, dict):
        return
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge_into(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)


def _validate_fragments(rule: Rule):
    """(passing fragment, violating fragments, mutant fragments) from
    the rule's validate body. Unsupported bodies yield bare-skeleton
    probes only."""
    v = rule.validation
    if v is None:
        raise Unsynthesizable("not a validate rule")
    if v.pattern is not None:
        frag, violations = synth_pattern(v.pattern)
        mutants = pattern_mutants(v.pattern, frag)
        return frag, violations, mutants
    if v.any_pattern:
        frag, violations = synth_pattern(v.any_pattern[0])
        # a single-pattern violation may satisfy another alternative;
        # over-approximation is fine — the verdict table is the truth
        mutants = pattern_mutants(v.any_pattern[0], frag)
        return frag, violations, mutants
    if v.deny is not None:
        conditions = (v.deny or {}).get("conditions")
        tru = deny_assignments(conditions, True)
        fls = deny_assignments(conditions, False)
        frag: Dict[str, Any] = {}
        violations = []
        if fls is not None:
            for segs, val in fls:
                _set_path(frag, list(segs), val)
        if tru is not None:
            bad: Dict[str, Any] = {}
            for segs, val in tru:
                _set_path(bad, list(segs), val)
            violations.append((bad, "deny conditions driven true"))
        return frag, violations, []
    # foreach / cel / podSecurity: probe witnesses only (the match
    # skeleton still exercises match/exclude + preconditions)
    return {}, [], []


def synthesize_rule(rule_row: int, policy: ClusterPolicy, rule: Rule
                    ) -> Tuple[RuleSynthesis, List[Witness]]:
    syn = RuleSynthesis(rule_row=rule_row, policy_name=policy.name,
                        rule_name=rule.name)
    skels, candidates, exhaustive = match_skeletons(rule, policy.namespace)
    syn.exhaustive = exhaustive
    out: List[Witness] = []
    if not skels:
        syn.match_found = False
        syn.note = ("no matching skeleton"
                    if exhaustive else "match shape not modeled")
        # unmatched probes: evaluated anyway so a statically-dead rule
        # has table cells (NOT_MATCHED) the confirm ladder can check
        for cand in candidates[:2]:
            out.append(Witness(resource=cand.resource, rule_row=rule_row,
                               intent="probe", operation=cand.operation,
                               ns_labels=cand.ns_labels, info=cand.info,
                               note="unmatched probe"))
        return syn, out
    sk = skels[0]
    try:
        frag, violations, mutants = _validate_fragments(rule)
    except Unsynthesizable as e:
        syn.note = f"validate not modeled: {e}"
        frag, violations, mutants = {}, [], []

    def emit(body_frag: Any, intent: str, note: str, skel: Skeleton) -> None:
        res = _deep_merge(skel.resource, body_frag) \
            if isinstance(body_frag, dict) else copy.deepcopy(skel.resource)
        out.append(Witness(resource=res, rule_row=rule_row, intent=intent,
                           operation=skel.operation, ns_labels=skel.ns_labels,
                           info=skel.info, note=note))

    emit(frag, "pass", "minimal passing witness", sk)
    for vfrag, note in violations:
        emit(vfrag, "violate", note, sk)
    for mfrag, note in mutants:
        emit(mfrag, "mutant", note, sk)
    # one probe per ADDITIONAL matching skeleton (distinct match arms
    # discriminate selector overlap between rules)
    for extra in skels[1:3]:
        emit(frag, "probe", "alternate match arm", extra)
    return syn, out


def synthesize(cps) -> Tuple[List[Witness], Dict[int, RuleSynthesis]]:
    """Witness corpus for a compiled policy set: per rule row, the
    targeted witnesses plus the bookkeeping the analyzer's dead-rule
    classification needs."""
    corpus: List[Witness] = []
    per_rule: Dict[int, RuleSynthesis] = {}
    for row, entry in enumerate(cps.rules):
        policy = cps.policies[entry.policy_idx]
        rule = next((r for r in policy.get_rules()
                     if r.name == entry.rule_name and r.has_validate()),
                    None)
        if rule is None:
            per_rule[row] = RuleSynthesis(row, entry.policy_name,
                                          entry.rule_name,
                                          note="rule not found")
            continue
        try:
            syn, wits = synthesize_rule(row, policy, rule)
        except Exception as e:  # noqa: BLE001
            syn = RuleSynthesis(row, entry.policy_name, entry.rule_name,
                                match_found=False, exhaustive=False,
                                note=f"synthesis error: {e}")
            wits = []
        for w in wits:
            syn.witnesses.append(len(corpus))
            corpus.append(w)
        per_rule[row] = syn
    return corpus, per_rule
