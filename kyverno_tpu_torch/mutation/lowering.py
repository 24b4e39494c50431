# Copied verbatim from kyverno_tpu/mutation/lowering.py.
"""Vectorized patch synthesis: constant strategic-merge overlays
lowered into precomputed templates, plus the chain-dependency analysis
that keeps device triage sound.

Lowerable subset (the dominant admission-mutation shape — default
labels/annotations, securityContext defaults): a mutate rule whose only
patch is a ``patchStrategicMerge`` overlay of plain keys and
``+(key)`` add-if-not-present anchors, with no variables (``{{``), no
condition/negation/existence/equality anchors, no context entries, and
no lists under plain keys except all-scalar replacement lists. For
this subset the merge result depends on the target resource only
through copy-on-write dict merging and absent-key adds — both
precomputable — so ``PatchTemplate.stamp`` reproduces
``engine/mutate.py``'s ``strategic_merge`` bit-identically without
walking the overlay per resource. Everything else falls through to the
scalar patcher (the bit-identity oracle).

Chain dependency: the scalar chain evaluates rule *j*'s
match/preconditions against the patched-so-far resource, while device
triage evaluates against the ORIGINAL. ``rule_write_paths`` /
``rule_read_paths`` over-approximate each rule's written and
predicate-read path sets (``None`` = unknown = everything), and the
compiler demotes rule *j* to host triage when any earlier mutate rule
may write a path *j*'s predicate reads.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..api.policy import Rule
from ..engine import anchor as anchorpkg
from ..engine.mutate import _strip_anchors, load_json6902

Path = Tuple[str, ...]
# None = top (unknown / everything): any analysis that cannot bound a
# rule's path set returns None and the conflict check stays conservative
PathSet = Optional[List[Path]]


# ---------------------------------------------------------------------------
# patch templates


@dataclass
class PatchTemplate:
    """One lowered ``patchStrategicMerge`` overlay.

    ``entries`` is the compiled op list in overlay key order — the same
    order ``_merge_element`` walks — where each op is one of::

        ("set",   key, value)                 # plain key, constant value
        ("add",   key, payload)               # +(key), stamped if absent
        ("merge", key, sub_entries, stripped) # plain key, dict value

    ``stripped`` mirrors ``_strip_anchors(overlay)`` for the paths the
    oracle replaces wholesale (non-dict merge targets)."""

    policy_name: str
    rule_name: str
    entries: List[Tuple] = field(default_factory=list)
    stripped: Any = None
    write_paths: List[Path] = field(default_factory=list)

    def stamp(self, resource: Any) -> Any:
        """Apply the template; returns the patched copy (resource
        untouched), value-identical to
        ``strategic_merge(resource, overlay)`` for the lowered rule."""
        if not isinstance(resource, dict):
            # dict overlay on a non-dict: the oracle replaces with the
            # stripped overlay (_merge_element's first branch)
            return copy.deepcopy(self.stripped)
        return _stamp_entries(resource, self.entries)


def _stamp_entries(resource: Dict[str, Any], entries: List[Tuple]) -> Dict[str, Any]:
    out = dict(resource)  # copy-on-write, like _merge_element
    for op in entries:
        kind, key = op[0], op[1]
        if kind == "set":
            value = op[2]
            out[key] = copy.deepcopy(value) \
                if isinstance(value, (dict, list)) else value
        elif kind == "add":
            if key not in out:
                out[key] = copy.deepcopy(op[2])
        else:  # merge
            target = out.get(key)
            if isinstance(target, dict):
                out[key] = _stamp_entries(target, op[2])
            else:
                out[key] = copy.deepcopy(op[3])
    return out


def _has_variable(node: Any) -> bool:
    if isinstance(node, dict):
        return any(_has_variable(k) or _has_variable(v)
                   for k, v in node.items())
    if isinstance(node, list):
        return any(_has_variable(x) for x in node)
    return isinstance(node, str) and "{{" in node


def _has_anchor_key(node: Any) -> bool:
    if isinstance(node, dict):
        return any(anchorpkg.parse(k) is not None or _has_anchor_key(v)
                   for k, v in node.items())
    if isinstance(node, list):
        return any(_has_anchor_key(x) for x in node)
    return False


def _contains_dict(node: Any) -> bool:
    if isinstance(node, dict):
        return True
    if isinstance(node, list):
        return any(_contains_dict(x) for x in node)
    return False


def _compile_overlay(overlay: Dict[str, Any]) -> Optional[List[Tuple]]:
    """Compile one overlay map level; None = not lowerable."""
    entries: List[Tuple] = []
    for key, value in overlay.items():
        if not isinstance(key, str) or "{{" in key:
            return None
        a = anchorpkg.parse(key)
        if anchorpkg.is_add_if_not_present(a):
            # payload stamped verbatim when the key is absent; any
            # nested anchor or variable would make _strip_anchors /
            # substitution resource- or context-dependent
            if _has_variable(value) or _has_anchor_key(value):
                return None
            entries.append(("add", a.key, copy.deepcopy(value)))
            continue
        if a is not None:
            # condition/negation/existence/equality anchors gate the
            # merge on resource content — scalar patcher territory
            return None
        if isinstance(value, dict):
            sub = _compile_overlay(value)
            if sub is None:
                return None
            entries.append(("merge", key, sub, _strip_anchors(value)))
        elif isinstance(value, list):
            # _merge_list replaces for non-empty scalar lists whatever
            # the target holds; dict elements merge per-element by name
            # (target-dependent) and empty overlays no-op on lists but
            # replace non-lists — neither is constant
            if not value or _contains_dict(value) or _has_variable(value):
                return None
            entries.append(("set", key, copy.deepcopy(value)))
        elif isinstance(value, str):
            if "{{" in value:
                return None
            entries.append(("set", key, value))
        else:
            entries.append(("set", key, value))
    return entries


def lower_mutate_rule(rule: Rule) -> Optional[PatchTemplate]:
    """Lower a mutate rule into a PatchTemplate, or None when the rule
    is outside the lowerable subset (it then rides the scalar patcher
    when triage-positive). Never raises."""
    try:
        m = rule.mutation
        if not isinstance(m, dict) or rule.context:
            return None
        overlay = m.get("patchStrategicMerge")
        if overlay is None or not isinstance(overlay, dict):
            return None
        if any(v is not None for k, v in m.items()
               if k != "patchStrategicMerge"):
            return None
        entries = _compile_overlay(overlay)
        if entries is None:
            return None
        writes = _overlay_write_paths(overlay, ())
        if writes is None:
            return None
        return PatchTemplate(
            policy_name="", rule_name=rule.name, entries=entries,
            stripped=_strip_anchors(overlay), write_paths=writes)
    except Exception:  # noqa: BLE001 — lowering must never fail a compile
        return None


# ---------------------------------------------------------------------------
# write-path analysis (what a mutate rule may change)


def _overlay_write_paths(overlay: Any, prefix: Path) -> PathSet:
    if not isinstance(overlay, dict):
        return None
    out: List[Path] = []
    for key, value in overlay.items():
        if not isinstance(key, str) or "{{" in key:
            return None  # substituted key — unbounded write target
        a = anchorpkg.parse(key)
        k = a.key if a is not None else key
        if "{{" in k:
            return None
        if isinstance(value, dict) and a is None:
            sub = _overlay_write_paths(value, prefix + (k,))
            if sub is None:
                return None
            out.extend(sub)
        else:
            # anchored keys, lists, and scalars write (at most) the
            # whole subtree at this key
            out.append(prefix + (k,))
    return out


def _json6902_write_paths(patch: Any) -> PathSet:
    try:
        ops = load_json6902(patch)
    except Exception:  # noqa: BLE001
        return None
    out: List[Path] = []
    for p in ops:
        if not isinstance(p, dict) or _has_variable(p):
            return None
        if p.get("op") == "test":
            continue  # reads only
        for ptr_key in ("path",) + (("from",) if p.get("op") == "move" else ()):
            ptr = p.get(ptr_key, "")
            if not isinstance(ptr, str) or not ptr.startswith("/"):
                return None
            segs: List[str] = []
            for seg in ptr.split("/")[1:]:
                seg = seg.replace("~1", "/").replace("~0", "~")
                if seg == "-" or seg.lstrip("-").isdigit():
                    break  # index writes touch the parent list subtree
                segs.append(seg)
            out.append(tuple(segs))
    return out


def rule_write_paths(rule: Rule) -> PathSet:
    """Over-approximate path prefixes a mutate rule may write; None =
    unbounded (foreach lists with variable targets, substituted keys,
    targets, unknown patch kinds)."""
    try:
        m = rule.mutation
        if not isinstance(m, dict):
            return None
        out: List[Path] = []
        for key, body in m.items():
            if body is None:
                continue
            if key == "patchStrategicMerge":
                sub = _overlay_write_paths(body, ())
            elif key == "patchesJson6902":
                sub = _json6902_write_paths(body)
            elif key == "foreach":
                sub = []
                for fe in body if isinstance(body, list) else [None]:
                    if not isinstance(fe, dict):
                        return None
                    if fe.get("patchStrategicMerge") is not None:
                        s = _overlay_write_paths(
                            fe["patchStrategicMerge"], ())
                    elif fe.get("patchesJson6902") is not None:
                        s = _json6902_write_paths(fe["patchesJson6902"])
                    else:
                        s = None
                    if s is None:
                        return None
                    sub.extend(s)
            else:
                return None  # targets / unknown mutate construct
            if sub is None:
                return None
            out.extend(sub)
        return out
    except Exception:  # noqa: BLE001
        return None


# ---------------------------------------------------------------------------
# predicate read-path analysis (what device triage evaluates against
# the ORIGINAL resource)

_VAR_RE = re.compile(r"\{\{(.*?)\}\}", re.S)
_OBJ_PATH_RE = re.compile(
    r"^request\.object\.([A-Za-z0-9_][\w\-]*(?:\.[A-Za-z0-9_][\w\-]*)*)$")
# variables whose value does not read the admission resource at all
_RESOURCE_FREE_RE = re.compile(
    r"^(request\.operation|request\.userInfo(\.[\w\-]+)*"
    r"|serviceAccountName|serviceAccountNamespace)$")


def _string_read_paths(s: str, out: List[Path]) -> bool:
    """Collect resource paths a template string reads; False = some
    variable reads the resource in a way we cannot bound."""
    for m in _VAR_RE.finditer(s):
        expr = m.group(1).strip()
        om = _OBJ_PATH_RE.match(expr)
        if om is not None:
            out.append(tuple(om.group(1).split(".")))
            continue
        if expr == "request.namespace":
            out.append(("metadata", "namespace"))
            continue
        if _RESOURCE_FREE_RE.match(expr):
            continue
        return False  # functions, element.*, context vars, pipes, ...
    return True


def _walk_read_strings(node: Any, out: List[Path]) -> bool:
    if isinstance(node, dict):
        return all(_walk_read_strings(k, out) and _walk_read_strings(v, out)
                   for k, v in node.items())
    if isinstance(node, list):
        return all(_walk_read_strings(x, out) for x in node)
    if isinstance(node, str) and "{{" in node:
        return _string_read_paths(node, out)
    return True


def _match_block_reads(block, out: List[Path]) -> None:
    filters = list(block.any) + list(block.all)
    from ..api.policy import ResourceFilter

    if not filters and not block.resources.is_empty():
        filters = [ResourceFilter(resources=block.resources,
                                  user_info=block.user_info)]
    for f in filters:
        r = f.resources
        if r.name or r.names:
            out.append(("metadata", "name"))
        if r.namespaces:
            out.append(("metadata", "namespace"))
        if r.selector is not None:
            out.append(("metadata", "labels"))
        if r.namespace_selector is not None:
            out.append(("metadata", "namespace"))
        if r.annotations:
            out.append(("metadata", "annotations"))


def rule_read_paths(rule: Rule) -> PathSet:
    """Over-approximate resource paths the rule's triage predicate
    (match/exclude/preconditions) reads; None = unbounded."""
    try:
        out: List[Path] = [("kind",)]
        _match_block_reads(rule.match, out)
        _match_block_reads(rule.exclude, out)
        if rule.cel_preconditions:
            return None  # host-routed at compile anyway; stay safe
        if rule.preconditions is not None:
            if not _walk_read_strings(rule.preconditions, out):
                return None
        return out
    except Exception:  # noqa: BLE001
        return None


def paths_conflict(writes: PathSet, reads: PathSet) -> bool:
    """Does any written path prefix-overlap any read path (either
    direction)? None on either side = unbounded = conflict (except
    against a provably empty set)."""
    if reads is not None and not reads:
        return False
    if writes is not None and not writes:
        return False
    if writes is None or reads is None:
        return True
    for w in writes:
        for r in reads:
            if w[:len(r)] == r or r[:len(w)] == w:
                return True
    return False
