# Copied verbatim from kyverno_tpu/tpu/ir.py.
"""Rule -> device IR with capability analysis.

The compiler lowers each rule's match/exclude block, preconditions, and
validate body (pattern / anyPattern / deny) into a device IR that the
evaluator turns into JAX ops. Anything outside the supported subset
raises :class:`Unsupported`; the policy-set compiler catches it and
routes that rule to the scalar engine (host fallback) — the device path
is never wrong, only selectively absent.

Supported subset (grown over rounds):
- patterns: map trees with condition ``()``, equality ``=()``, negation
  ``X()``, existence ``^()`` and global ``<()`` anchors; arrays-of-maps
  (one array level deep on any path); scalar-array broadcast; scalar
  leaves with the full ``|``/``&``/operator/range grammar
  (pkg/engine/pattern/pattern.go) including glob operands;
- deny/preconditions: keys that are single ``{{ ... }}`` JMESPath
  templates over ``request.object`` path chains, multiselects,
  ``[]`` projections, ``keys(@)`` and ``|| literal`` defaults; also
  ``request.operation``; non-variable literal keys (constant-folded
  via the scalar oracle); operators Equals/NotEquals, the In family
  including deprecated In/NotIn (scalar-chain keys, literal string
  list values), numeric/duration comparisons with literal values;
  bare chains without defaults ERROR on missing paths (forked
  go-jmespath semantics);
- context: ``variable`` entries with literal values and ``configMap``
  entries resolved against cluster-backed data sources constant-fold
  at compile (context deps recorded for invalidation);
- match/exclude: kinds (exact or ``*`` segments), names/namespaces with
  globs, exact annotations, label/namespace selectors (incl. wildcard
  matchLabels via label byte lanes, with dict-collision soundness
  guards), operations, exact user roles/clusterRoles/subjects.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..api.policy import ClusterPolicy, ResourceDescription, ResourceFilter, Rule, UserInfo
from ..engine.jmespath.parser import Parser as JmesParser
from ..engine.operator import (
    IN_RANGE_RE,
    NOT_IN_RANGE_RE,
    Operator,
    get_operator_from_string_pattern,
)
from ..engine.pattern import go_parse_float, go_parse_int
from ..utils import kube
from ..utils.duration import parse_duration
from ..utils.quantity import parse_quantity
from ..utils.wildcard import contains_wildcard
from .hashing import ARRAY_SEG, hash_path, hash_str
from .metadata import OP_CODES


class Unsupported(Exception):
    """Construct outside the device subset -> host fallback."""


class _NullDefault:
    """Sentinel: a `|| <always-null>` default arm (key becomes null)."""

    def __repr__(self) -> str:  # pragma: no cover
        return "NULL_DEFAULT"


NULL_DEFAULT = _NullDefault()


# ---------------------------------------------------------------------------
# scalar leaf IR (pattern.Validate lowering)


@dataclass
class Cmp:
    """One operator+operand comparison (one &-term, after range expansion)."""

    op: Operator
    operand: str
    dur_ns: Optional[int] = None      # operand parsed as Go duration
    qty: Optional[Fraction] = None    # operand parsed as k8s quantity
    is_glob: bool = False             # operand contains * or ?

    def __post_init__(self) -> None:
        self.dur_ns = parse_duration(self.operand)
        self.qty = parse_quantity(self.operand)
        self.is_glob = contains_wildcard(self.operand)


@dataclass
class StrLeaf:
    full: str
    # disjunction (|) of conjunctions (&) of disjunctions (notrange pairs)
    alternatives: List[List[List[Cmp]]] = field(default_factory=list)
    is_star: bool = False

    @classmethod
    def compile(cls, pattern: str) -> "StrLeaf":
        alts: List[List[List[Cmp]]] = []
        for condition in pattern.split("|"):
            condition = condition.strip(" ")
            units: List[List[Cmp]] = []
            for term in condition.split("&"):
                term = term.strip(" ")
                op = get_operator_from_string_pattern(term)
                if op is Operator.IN_RANGE:
                    m = IN_RANGE_RE.match(term)
                    if not m:
                        units.append([])  # unmatched range -> always false
                        continue
                    units.append([Cmp(Operator.MORE_EQUAL, m.group(1).strip())])
                    units.append([Cmp(Operator.LESS_EQUAL, m.group(2).strip())])
                elif op is Operator.NOT_IN_RANGE:
                    m = NOT_IN_RANGE_RE.match(term)
                    if not m:
                        units.append([])
                        continue
                    units.append([
                        Cmp(Operator.LESS, m.group(1).strip()),
                        Cmp(Operator.MORE, m.group(2).strip()),
                    ])
                else:
                    units.append([Cmp(op, term[len(op.value):].strip())])
            alts.append(units)
        return cls(full=pattern, alternatives=alts, is_star=(pattern == "*"))


@dataclass
class BoolLeaf:
    value: bool


@dataclass
class NumLeaf:
    value: Any  # int | float
    is_int: bool


@dataclass
class NullLeaf:
    pass


Leaf = Any  # BoolLeaf | NumLeaf | NullLeaf | StrLeaf


def compile_leaf(pattern: Any) -> Leaf:
    if isinstance(pattern, bool):
        return BoolLeaf(pattern)
    if isinstance(pattern, int):
        return NumLeaf(pattern, True)
    if isinstance(pattern, float):
        return NumLeaf(pattern, False)
    if pattern is None:
        return NullLeaf()
    if isinstance(pattern, str):
        if "{{" in pattern:
            raise Unsupported("variable in pattern leaf")
        return StrLeaf.compile(pattern)
    raise Unsupported(f"unsupported leaf pattern type {type(pattern).__name__}")


# ---------------------------------------------------------------------------
# pattern tree IR


@dataclass
class Node:
    path: Tuple[str, ...]
    scope: Optional[Tuple[str, ...]]  # enclosing array path (<=1 level)


@dataclass
class LeafNode(Node):
    leaf: Leaf


@dataclass
class MapEmptyNode(Node):
    """Pattern ``{}``-equivalent or dict-type check via scalar dispatch."""


@dataclass
class WildcardKeyInfo:
    """A wildcard key inside a metadata labels/annotations pattern map
    (wildcards.go:62 ExpandInMetadata): at evaluation time the glob key
    expands to the FIRST resource key matching it (map insertion order —
    the scalar oracle's dict order); if the resource map is absent, has
    non-string values, or nothing matches, the key stays literal."""

    glob: str                     # the glob key (modifier stripped)
    map_path: Tuple[str, ...]     # the annotations/labels map path
    leaf: Any                     # compiled string leaf of the value


@dataclass
class AnchorChild:
    kind: str          # condition | equality | negation | existence
    key: str
    raw_key: str       # with modifier, phase-1 iterates sorted raw keys
    child: Optional["Node"]
    wildcard: Optional[WildcardKeyInfo] = None


@dataclass
class Phase2Child:
    key: str
    is_global: bool
    is_star: bool      # pattern literal "*" under a plain key
    child: Optional["Node"]
    wildcard: Optional[WildcardKeyInfo] = None


@dataclass
class MapNode(Node):
    anchors: List[AnchorChild] = field(default_factory=list)
    phase2: List[Phase2Child] = field(default_factory=list)


@dataclass
class ArrayMapsNode(Node):
    element: "Node" = None  # MapNode over elements


@dataclass
class ArrayScalarNode(Node):
    leaf: Leaf = None


@dataclass
class ExistenceNode(Node):
    """^(key) anchor value: list of element-map patterns, each must be
    satisfied by at least one resource element (handlers.go:228)."""

    elements: List["Node"] = field(default_factory=list)


_GLOBBY_KEY = re.compile(r"[*?]")


class PatternCompiler:
    def __init__(self) -> None:
        self.byte_paths: Set[int] = set()
        self.key_byte_paths: Set[int] = set()
        self._arr_depth = 0

    def compile(self, pattern: Any) -> Node:
        if not isinstance(pattern, dict):
            raise Unsupported("non-map pattern root")
        self._scan_vars(pattern)
        return self._map(pattern, (), None)

    def _scan_vars(self, tree: Any) -> None:
        if isinstance(tree, dict):
            for k, v in tree.items():
                if "{{" in str(k):
                    raise Unsupported("variable in pattern key")
                self._scan_vars(v)
        elif isinstance(tree, list):
            for v in tree:
                self._scan_vars(v)
        elif isinstance(tree, str) and "{{" in tree:
            raise Unsupported("variable in pattern")

    def _element(self, pattern: Any, path: Tuple[str, ...],
                 scope: Optional[Tuple[str, ...]]) -> Node:
        """_validate_resource_element dispatch (validate.go:71)."""
        if isinstance(pattern, dict):
            return self._map(pattern, path, scope)
        if isinstance(pattern, list):
            return self._array(pattern, path, scope)
        leaf = compile_leaf(pattern)
        self._note_glob_paths(leaf, path)
        return LeafNode(path, scope, leaf)

    def _note_glob_paths(self, leaf: Leaf, path: Tuple[str, ...]) -> None:
        if isinstance(leaf, StrLeaf):
            globby = any(
                c.is_glob and c.op in (Operator.EQUAL, Operator.NOT_EQUAL) and c.operand != "*"
                for units in leaf.alternatives for unit in units for c in unit
            )
            if globby:
                # glob compare runs on raw bytes of the value *and* of
                # any array elements it may broadcast over
                self.byte_paths.add(hash_path(path))
                self.byte_paths.add(hash_path(path + (ARRAY_SEG,)))

    def _map(self, pattern: Dict[str, Any], path: Tuple[str, ...],
             scope: Optional[Tuple[str, ...]]) -> MapNode:
        from ..engine import anchor as anchorpkg

        anchors: List[AnchorChild] = []
        phase2: List[Phase2Child] = []
        anchor_keys: Dict[str, Any] = {}
        resource_keys: Dict[str, Any] = {}
        # ExpandInMetadata (wildcards.go:62) rewrites wildcard keys of
        # metadata labels/annotations string maps against the resource's
        # keys; everywhere else pattern keys are literal strings
        in_meta_map = (
            len(path) >= 2
            and path[-2] == "metadata"
            and path[-1] in ("annotations", "labels")
            and all(isinstance(v, str) for v in pattern.values())
        )
        expandable = scope is None and in_meta_map
        wildcards: Dict[str, WildcardKeyInfo] = {}
        for key, value in pattern.items():
            key = str(key)
            a = anchorpkg.parse(key)
            if anchorpkg.is_condition(a) or anchorpkg.is_existence(a) \
                    or anchorpkg.is_equality(a) or anchorpkg.is_negation(a):
                anchor_keys[key] = (a, value)
            else:
                resource_keys[key] = (a, value)
            inner = a.key if a is not None else key
            if _GLOBBY_KEY.search(inner):
                if in_meta_map and scope is not None:
                    # the reference expands per array element; the row
                    # encoding cannot express that join -> host
                    raise Unsupported("wildcard metadata key in array scope")
                if not expandable:
                    continue  # literal key outside expandable metadata maps
                if anchorpkg.is_existence(a) or anchorpkg.is_global(a):
                    raise Unsupported("wildcard key under existence/global anchor")
                if wildcards:
                    raise Unsupported("multiple wildcard pattern keys in one map")
                wildcards[key] = WildcardKeyInfo(inner, path, compile_leaf(value))
                self.key_byte_paths.add(hash_path(path))

        for raw_key in sorted(anchor_keys.keys()):
            a, value = anchor_keys[raw_key]
            kind = (
                "condition" if anchorpkg.is_condition(a)
                else "equality" if anchorpkg.is_equality(a)
                else "negation" if anchorpkg.is_negation(a)
                else "existence"
            )
            child: Optional[Node] = None
            if kind == "negation":
                child = None  # value never evaluated (handlers.go:66)
            elif kind == "existence":
                child = self._existence(value, path + (a.key,), scope)
            else:
                child = self._element(value, path + (a.key,), scope)
            anchors.append(AnchorChild(kind, a.key, raw_key, child,
                                       wildcards.get(raw_key)))

        # phase-2 order: getSortedNestedAnchorResource — stable sorted
        # keys, then keys that are global anchors or contain nested
        # anchors are pushed front (reversing their relative order)
        front: List[str] = []
        back: List[str] = []
        for k in sorted(resource_keys.keys()):
            a, value = resource_keys[k]
            if anchorpkg.is_global(a) or self._has_nested_anchors(value):
                front.insert(0, k)
            else:
                back.append(k)
        for k in front + back:
            a, value = resource_keys[k]
            is_global = anchorpkg.is_global(a)
            inner = a.key if is_global else k
            is_star = value == "*"
            child = self._element(value, path + (inner,), scope)
            phase2.append(Phase2Child(inner, is_global, is_star, child,
                                      wildcards.get(k)))
        return MapNode(path, scope, anchors, phase2)

    @staticmethod
    def _has_nested_anchors(pattern: Any) -> bool:
        from ..engine.validate import _has_nested_anchors

        return _has_nested_anchors(pattern)

    def _array(self, pattern: List[Any], path: Tuple[str, ...],
               scope: Optional[Tuple[str, ...]]) -> Node:
        if len(pattern) == 0:
            raise Unsupported("empty pattern array")  # constant FAIL; rare
        first = pattern[0]
        if isinstance(first, dict):
            if self._arr_depth >= 2:
                raise Unsupported("array-of-maps nested beyond two levels")
            self._arr_depth += 1
            try:
                element = self._map(first, path + (ARRAY_SEG,), path)
            finally:
                self._arr_depth -= 1
            return ArrayMapsNode(path, scope, element)
        if isinstance(first, list):
            raise Unsupported("positional array-of-arrays pattern")
        leaf = compile_leaf(first)
        self._note_glob_paths(leaf, path + (ARRAY_SEG,))
        return ArrayScalarNode(path, scope, leaf)

    def _existence(self, value: Any, path: Tuple[str, ...],
                   scope: Optional[Tuple[str, ...]]) -> ExistenceNode:
        if scope is not None:
            raise Unsupported("existence anchor nested in array scope")
        if not isinstance(value, list):
            # non-list pattern under ^() is a constant error (handlers.go:243)
            raise Unsupported("existence anchor with non-list pattern")
        # element patterns evaluate per-instance (InstScope): they consume
        # the first instance level, so arrays inside may nest once more
        self._arr_depth += 1
        try:
            return self._existence_elements(value, path, scope)
        finally:
            self._arr_depth -= 1

    def _existence_elements(self, value: List[Any], path: Tuple[str, ...],
                            scope: Optional[Tuple[str, ...]]) -> ExistenceNode:
        elements: List[Node] = []
        for pm in value:
            if not isinstance(pm, dict):
                raise Unsupported("existence anchor with non-map element")
            elements.append(self._map(pm, path + (ARRAY_SEG,), path))
        return ExistenceNode(path, scope, elements)


# ---------------------------------------------------------------------------
# condition (deny / precondition) IR


@dataclass
class PathState:
    segs: Tuple[str, ...]
    mode: str  # value | keys | mselect
    no_arr: bool = False   # array rows here were spliced by a flatten
    no_null: bool = False  # null rows dropped (projection semantics)


@dataclass
class OpKey:
    """key == {{ request.operation }} (with optional || default)."""

    default: Optional[str]


@dataclass
class DynSlot:
    """One host-resolved context operand: the rule's context entries
    load per request (through the real context loaders, I/O included —
    SURVEY §7 "context-dependent rules"), the expression is queried
    against the loaded context, and the value's canonical lanes feed
    the device program as per-resource operands."""

    query: str        # full jmespath expression (roots include context vars)
    entries: List[Dict[str, Any]] = field(default_factory=list)  # full rule context
    # resource paths whose STRING values must be glob-free for hash
    # membership against this slot's list value to be sound (scalar
    # _wild_either matches globs in either direction) — glob hits
    # route the cell to host
    guard_paths: List[Tuple[str, ...]] = field(default_factory=list)


@dataclass
class DynKey:
    """Condition key backed by a dynamic context operand slot."""

    slot: int  # global slot index (compiler-assigned)


@dataclass
class DynValueRef:
    """Condition VALUE backed by a dynamic context operand slot (list
    membership against a host-resolved string list)."""

    slot: int


@dataclass
class UserInfoKey:
    """key == {{ request.userInfo.groups|roles|clusterRoles }} — the
    per-request RBAC identity, already encoded as hash lanes for
    match/exclude subjects (metadata.py groups_h/roles_h/croles_h)."""

    field: str  # groups | roles | clusterRoles


@dataclass
class LiteralKey:
    """A non-variable condition key (foreach deny's `key: ALL`)."""

    value: Any


@dataclass
class ElementCollect:
    """A {{ element... }} expression inside a foreach body: rows are
    collected RELATIVE to the current array element and joined per
    instance via the scope index."""

    states: List[PathState]
    array_roots: List[Tuple[Tuple[str, ...], str]]
    is_projection: bool
    default: Optional[Any]          # only None / [] / '' supported
    keys_error_states: List[PathState] = field(default_factory=list)


@dataclass
class PathCollect:
    """key collects rows of the flattened resource."""

    states: List[PathState]
    # (path, kind) pairs whose presence makes the key a list (vs null):
    # kind 'array' => row at path exists with type array;
    # kind 'mselect' => row at path exists non-null (multiselect lists)
    array_roots: List[Tuple[Tuple[str, ...], str]]
    is_projection: bool                 # list-valued (vs scalar path chain)
    default: Optional[Any]
    # element paths keys(@) was applied to: non-map elements there make
    # the whole condition a query error -> rule ERROR
    keys_error_states: List[PathState] = field(default_factory=list)
    # not_null(chain, default) semantics: the default fires on
    # null/missing only (context-loader defaults), not jmespath falsy
    default_null_only: bool = False
    # not_null(chain, other.chain): a second path chain as the default
    default_collect: Optional["PathCollect"] = None


@dataclass
class CondIR:
    key: Any                 # OpKey | PathCollect
    op: str                  # canonical lower-case operator
    value: Any               # literal (list or scalar)


@dataclass
class CondTreeIR:
    """AnyAllConditions: ANDed blocks of {any, all} lists."""

    blocks: List[Tuple[List[CondIR], List[CondIR]]]  # (any, all) per block


_VAR_RE = re.compile(r"^\{\{(.*)\}\}$", re.DOTALL)


def _mentions_element(ast: Any) -> bool:
    if isinstance(ast, tuple):
        if ast == ("field", "element"):
            return True
        return any(_mentions_element(x) for x in ast)
    if isinstance(ast, list):
        return any(_mentions_element(x) for x in ast)
    return False

# deprecated In/NotIn lower for scalar-chain keys with literal LIST
# values: scalar keys behave like AnyIn/AnyNotIn, list keys evaluate
# strict all-in with non-string elements forcing false (in.go:35-43,
# modeled by the evaluator's in_strict/notin_strict modes). String-
# encoded values (wildcard / JSON forms) and projection keys keep
# their richer host semantics.
_SUPPORTED_OPS = {
    "equals", "equal", "notequals", "notequal",
    "anyin", "allin", "anynotin", "allnotin", "in", "notin",
    "greaterthan", "greaterthanorequals", "lessthan", "lessthanorequals",
}


class ConditionCompiler:
    def __init__(self, element_mode: bool = False,
                 dyn_vars: Optional[Dict[str, List[Dict[str, Any]]]] = None) -> None:
        self._parser = JmesParser()
        self.element_mode = element_mode
        # set when a compiled key reads the request identity lanes —
        # glob-bearing runtime identities then route to host per cell
        self.saw_userinfo = False
        # dynamic context variables: name -> the rule's full context
        # entry list (loads happen per request on the host)
        self.dyn_vars = dyn_vars or {}
        self.dyn_slots: List[DynSlot] = []

    def _dyn_slot(self, query: str, entries: List[Dict[str, Any]]) -> int:
        for i, s in enumerate(self.dyn_slots):
            if s.query == query:
                return i
        self.dyn_slots.append(DynSlot(query, entries))
        return len(self.dyn_slots) - 1

    def _dyn_expr(self, expr: str) -> Optional[int]:
        """Slot index when the expression's roots involve a dynamic
        context variable (the whole expression then evaluates on host
        through the real context machinery — functions, pipes and
        mixed request.* references included)."""
        if not self.dyn_vars:
            return None
        roots: Set[str] = set()
        try:
            _root_refs(self._parser.parse(expr), roots)
        except Exception:  # noqa: BLE001
            return None
        hit = roots & set(self.dyn_vars)
        if not hit or "?" in roots or "@" in roots:
            return None
        entries = self.dyn_vars[next(iter(hit))]
        return self._dyn_slot(expr, entries)

    def compile_tree(self, conditions: Any) -> Optional[CondTreeIR]:
        """None/empty conditions -> None (always pass)."""
        if conditions is None:
            return None
        blocks: List[Tuple[List[CondIR], List[CondIR]]] = []
        if isinstance(conditions, list):
            flat: List[CondIR] = []
            for item in conditions:
                if not isinstance(item, dict):
                    raise Unsupported("non-map condition")
                if "any" in item or "all" in item:
                    blocks.append(self._block(item))
                else:
                    flat.append(self.compile_condition(item))
            if flat:
                blocks.append(([], flat))
        elif isinstance(conditions, dict):
            blocks.append(self._block(conditions))
        else:
            raise Unsupported("invalid conditions type")
        if not blocks:
            return None
        return CondTreeIR(blocks)

    def _block(self, block: Dict[str, Any]) -> Tuple[List[CondIR], List[CondIR]]:
        any_list = [self.compile_condition(c) for c in (block.get("any") or [])]
        all_list = [self.compile_condition(c) for c in (block.get("all") or [])]
        return any_list, all_list

    @staticmethod
    def _guard_literal_key_value(op: str, value: Any) -> None:
        """LiteralKey + {{element}} value is only lowered for membership
        operators over projection collects (the `key: ALL` shape);
        equals/numeric against a dynamic list would need deep-equality."""
        if isinstance(value, ElementCollect):
            if op not in ("anyin", "allin", "anynotin", "allnotin"):
                raise Unsupported("element value with non-membership operator")
            if not value.is_projection:
                raise Unsupported("non-projection element value")

    def compile_condition(self, cond: Dict[str, Any]) -> CondIR:
        op = str(cond.get("operator", "")).lower()
        if op not in _SUPPORTED_OPS:
            raise Unsupported(f"operator {op}")
        key = cond.get("key")
        is_var_key = isinstance(key, str) and _VAR_RE.match(key.strip())
        if not is_var_key:
            return self._compile_literal_key_condition(cond, op, key)
        value = self._compile_value(cond.get("value"))
        m = _VAR_RE.match(key.strip())
        expr = m.group(1).strip()
        if "{{" in expr:
            raise Unsupported("nested variables in key")
        if not self.element_mode:
            slot = self._dyn_expr(expr)
            if slot is not None:
                self._guard_dyn_key(op, value)
                return CondIR(DynKey(slot), op, value)
        ast = self._parser.parse(expr)
        if self.element_mode and _mentions_element(ast):
            key_ir = self._compile_element_key(ast)
        else:
            key_ir = self._compile_key(ast)
        if isinstance(value, DynValueRef):
            # dynamic operand value: list membership of collected key
            # rows, or scalar equality against a path-chain key
            if op in ("anyin", "allin", "anynotin", "allnotin", "in", "notin"):
                pass
            elif op in ("equals", "equal", "notequals", "notequal"):
                if getattr(key_ir, "is_projection", False):
                    raise Unsupported("dynamic value equality with projection key")
            else:
                raise Unsupported(f"dynamic value with operator {op}")
            if not isinstance(key_ir, PathCollect):
                raise Unsupported("dynamic value with non-path key")
            if key_ir.default is not None or key_ir.default_collect is not None:
                raise Unsupported("dynamic value with defaulted key")
            slot = self.dyn_slots[value.slot]
            for st in key_ir.states:
                if st.mode != "value":
                    raise Unsupported("dynamic value with keys() key")
                slot.guard_paths.append(st.segs)
            return CondIR(key_ir, op, value)
        if op in ("equals", "equal", "notequals", "notequal") and isinstance(value, (list, dict)):
            raise Unsupported("deep-equality condition value")
        if op in ("greaterthan", "greaterthanorequals", "lessthan", "lessthanorequals"):
            if isinstance(value, str) and value != "0":
                vd = parse_duration(value)
                vq = parse_quantity(value)
                try:
                    vf: Optional[float] = float(value)
                except ValueError:
                    vf = None
                if vd is None and vq is None and vf is None:
                    raise Unsupported("possible semver comparison value")
        if isinstance(value, ElementCollect):
            raise Unsupported("element value with non-literal key")
        if isinstance(key_ir, PathCollect) and key_ir.default_collect is not None \
                and op not in ("equals", "equal", "notequals", "notequal",
                               "greaterthan", "greaterthanorequals",
                               "lessthan", "lessthanorequals"):
            raise Unsupported("chain default with membership operator")
        if isinstance(key_ir, UserInfoKey):
            # list-key membership only, against glob-free string lists
            # (hash-lane equality mirrors _set_in exactly then)
            if op not in ("anyin", "allin", "anynotin", "allnotin"):
                raise Unsupported("userInfo key with non-membership operator")
            if not (isinstance(value, list)
                    and all(isinstance(v, str) and not contains_wildcard(v)
                            and get_operator_from_string_pattern(v)
                            not in (Operator.IN_RANGE, Operator.NOT_IN_RANGE)
                            for v in value)):
                raise Unsupported("userInfo key with non-literal-list value")
        if op in ("in", "notin"):
            if not isinstance(value, list):
                # string values carry wildcard/JSON-decode semantics
                raise Unsupported("deprecated In/NotIn with non-list value")
            if not all(isinstance(v, str) for v in value):
                # list keys invalidType on non-string VALUE elements
                # (in.go) while device literals sprint-coerce — host
                raise Unsupported("deprecated In/NotIn with non-string values")
            if getattr(key_ir, "is_projection", False):
                raise Unsupported("deprecated In/NotIn with projection key")
        return CondIR(key_ir, op, value)

    def _compile_literal_key_condition(self, cond: Dict[str, Any], op: str,
                                       key: Any) -> CondIR:
        """Non-variable keys: with a literal value the whole condition
        is a compile/eval-time CONSTANT the evaluator folds via the
        scalar oracle (evaluator.eval_cond LiteralKey branch) — any key
        and value types, globs included, exactly the oracle's
        semantics. With an {{element...}} value (foreach bodies), the
        key joins the collected list on device, which needs hashable
        exact keys (no globs)."""
        if isinstance(key, str):
            if "{{" in key:
                raise Unsupported("partial/nested variable in key")
        elif not (isinstance(key, (int, float, bool, list, dict)) or key is None):
            raise Unsupported("non-literal condition key")
        value = self._compile_value_lenient(cond.get("value"))
        if isinstance(value, ElementCollect):
            if isinstance(key, str) and contains_wildcard(key):
                raise Unsupported("glob literal key")
            if not isinstance(key, (str, int, float, bool)):
                raise Unsupported("non-scalar key with element value")
            self._guard_literal_key_value(op, value)
        if isinstance(value, DynValueRef):
            # constant key vs host-resolved list: hash membership
            if op not in ("anyin", "allin", "anynotin", "allnotin",
                          "in", "notin"):
                raise Unsupported("dynamic value with non-membership operator")
            if not isinstance(key, (str, int, float, bool)):
                raise Unsupported("non-scalar key with dynamic value")
            if isinstance(key, str) and contains_wildcard(key):
                raise Unsupported("glob key with dynamic value")
        return CondIR(LiteralKey(key), op, value)

    def _guard_dyn_key(self, op: str, value: Any) -> None:
        """Dynamic-operand keys compare through canonical lanes: scalar
        string/number/bool equality and plain numeric comparisons only
        (no globs, ranges, durations/quantities or cross-type coercion
        — those stay on host)."""
        if isinstance(value, (DynValueRef, ElementCollect)):
            raise Unsupported("dynamic key with non-literal value")
        if op in ("equals", "equal", "notequals", "notequal"):
            if isinstance(value, str):
                if contains_wildcard(value):
                    raise Unsupported("dynamic key with glob value")
                if parse_duration(value) is not None \
                        or parse_quantity(value) is not None:
                    raise Unsupported("dynamic key with unit value")
                try:
                    float(value)
                except ValueError:
                    return
                raise Unsupported("dynamic key with numeric-string value")
            if isinstance(value, (bool, int, float)) or value is None:
                return
            raise Unsupported("dynamic key with composite value")
        if op in ("greaterthan", "greaterthanorequals", "lessthan",
                  "lessthanorequals"):
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                return
            raise Unsupported("dynamic key numeric op with non-number value")
        raise Unsupported(f"dynamic key with operator {op}")

    def _try_dyn_value(self, value: Any) -> Optional["DynValueRef"]:
        """A whole-string {{ expr }} value whose roots involve a
        dynamic context variable -> operand-slot reference."""
        if not (self.dyn_vars and isinstance(value, str)):
            return None
        m = _VAR_RE.match(value.strip())
        if m is None:
            return None
        slot = self._dyn_expr(m.group(1).strip())
        return DynValueRef(slot) if slot is not None else None

    def _try_element_value(self, value: Any) -> Optional["ElementCollect"]:
        """{{ element... }} string value in foreach bodies -> the
        collected projection; None when not an element value."""
        if not (self.element_mode and isinstance(value, str)):
            return None
        m = _VAR_RE.match(value.strip())
        if m is None:
            return None
        expr = m.group(1).strip()
        if "{{" in expr:
            raise Unsupported("nested variables in value")
        ast = self._parser.parse(expr)
        ec = self._compile_element_key(ast)
        if not isinstance(ec, ElementCollect):
            raise Unsupported("non-element variable value")
        return ec

    def _compile_value_lenient(self, value: Any) -> Any:
        """Value for a literal-key condition: ElementCollect in foreach
        bodies, a dynamic context-operand reference, otherwise any
        reference-free literal (the constant fold handles all types)."""
        import json as _json

        dv = self._try_dyn_value(value)
        if dv is not None:
            return dv
        ec = self._try_element_value(value)
        if ec is not None:
            return ec
        if "{{" in _json.dumps(value, default=str):
            raise Unsupported("variable in condition value")
        return value

    def _compile_value(self, value: Any) -> Any:
        """Literal passthrough, an {{ element... }} ElementCollect in
        foreach bodies, or a dynamic context-operand reference."""
        dv = self._try_dyn_value(value)
        if dv is not None:
            return dv
        ec = self._try_element_value(value)
        if ec is not None:
            return ec
        self._check_literal_value(value)
        return value

    def _check_literal_value(self, value: Any) -> None:
        if isinstance(value, str):
            if "{{" in value:
                raise Unsupported("variable in condition value")
            if contains_wildcard(value):
                raise Unsupported("glob condition value")
            if get_operator_from_string_pattern(value) in (Operator.IN_RANGE, Operator.NOT_IN_RANGE):
                raise Unsupported("range expression value")
            try:
                import json

                if isinstance(json.loads(value), list):
                    raise Unsupported("JSON-array-encoded condition value")
            except ValueError:
                pass
            return
        if isinstance(value, list):
            for v in value:
                self._check_literal_value(v)
            return
        if isinstance(value, (bool, int, float)) or value is None:
            return
        raise Unsupported("unsupported condition value type")

    # -- key AST lowering

    def _compile_element_key(self, ast: Tuple) -> "ElementCollect":
        default: Optional[Any] = None
        if ast[0] == "or":
            lhs, rhs = ast[1], ast[2]
            if rhs[0] != "literal":
                raise Unsupported("non-literal || default")
            default = rhs[1]
            ast = lhs
        if default not in (None, [], ""):
            raise Unsupported("foreach default other than []/''")
        self._keys_error_states = []
        # rebase: the walk treats `element` as the root
        states, roots, is_proj = self._walk_element(ast)
        return ElementCollect(states, roots, is_proj, default,
                              keys_error_states=self._keys_error_states)

    def _walk_element(self, ast: Tuple):
        kind = ast[0]
        if ast == ("field", "element"):
            return [PathState((), "value")], [], False
        if kind == "subexpression":
            states, roots, proj = self._walk_element(ast[1])
            return self._apply_rhs(ast[2], states, roots, proj)
        if kind == "projection":
            flat = ast[1]
            if flat[0] != "flatten":
                raise Unsupported("non-flatten projection")
            states, roots, lhs_proj = self._walk_element(flat[1])
            estates, eroots = self._flatten(states, lhs_proj)
            roots = roots + eroots
            out_states, out_roots, _ = self._apply_rhs(ast[2], estates, roots, True)
            return out_states, out_roots, True
        raise Unsupported(f"element expression construct {kind}")

    def _compile_key(self, ast: Tuple) -> Any:
        default: Optional[Any] = None
        if ast[0] == "or":
            lhs, rhs = ast[1], ast[2]
            if rhs == ("field", ""):
                # `|| ""` — a quoted EMPTY IDENTIFIER, not a string
                # literal: evaluates to a root field named "", i.e.
                # always null (a corpus-pinned authoring idiom)
                default = NULL_DEFAULT
            elif rhs[0] != "literal":
                raise Unsupported("non-literal || default")
            else:
                default = rhs[1]
            ast = lhs
        if ast == ("subexpression", ("field", "request"), ("field", "operation")):
            return OpKey(default if isinstance(default, (str, type(None))) else None)
        if ast[0] == "function" and ast[1] == "not_null" and default is None \
                and len(ast[2]) == 2:
            # not_null(chain, default): loader-default (null-only)
            # semantics; the default may itself be a scalar chain
            first, second = ast[2]
            self._keys_error_states = []
            states, roots, is_proj = self._walk(first)
            if is_proj:
                raise Unsupported("not_null over a projection")
            if second[0] == "literal":
                return PathCollect(states, roots, False, second[1],
                                   keys_error_states=self._keys_error_states,
                                   default_null_only=True)
            err_states = self._keys_error_states
            self._keys_error_states = []
            dstates, droots, dproj = self._walk(second)
            if dproj:
                raise Unsupported("not_null default projection")
            dflt = PathCollect(dstates, droots, False, None,
                               keys_error_states=self._keys_error_states)
            return PathCollect(states, roots, False, None,
                               keys_error_states=err_states,
                               default_null_only=True,
                               default_collect=dflt)
        # groups is the only identity list the request context exposes
        # under request.userInfo (roles/clusterRoles are separate
        # context keys in the reference and error here — host handles)
        if ast == ("subexpression",
                   ("subexpression", ("field", "request"),
                    ("field", "userInfo")), ("field", "groups")) \
                and default is None:
            self.saw_userinfo = True
            return UserInfoKey("groups")
        self._keys_error_states: List[PathState] = []
        states, roots, is_proj = self._walk(ast)
        return PathCollect(states, roots, is_proj, default,
                           keys_error_states=self._keys_error_states)

    def _walk(self, ast: Tuple) -> Tuple[List[PathState], List[Tuple[str, ...]], bool]:
        """Symbolic path-set evaluation. Returns (states, array_roots,
        is_projection). The AST must be rooted at request.object."""
        kind = ast[0]
        if kind == "subexpression":
            states, roots, proj = self._walk_lhs(ast[1])
            return self._apply_rhs(ast[2], states, roots, proj)
        if kind == "projection":
            flat = ast[1]
            if flat[0] != "flatten":
                raise Unsupported("non-flatten projection")
            states, roots, lhs_proj = self._walk_lhs(flat[1])
            estates, eroots = self._flatten(states, lhs_proj)
            roots = roots + eroots
            out_states, out_roots, _ = self._apply_rhs(ast[2], estates, roots, True)
            return out_states, out_roots, True
        if kind == "field":
            raise Unsupported("key not rooted at request.object")
        raise Unsupported(f"jmespath construct {kind}")

    def _walk_lhs(self, ast: Tuple) -> Tuple[List[PathState], List[Tuple[str, ...]], bool]:
        # base case: request.object
        if ast == ("subexpression", ("field", "request"), ("field", "object")):
            return [PathState((), "value")], [], False
        if ast[0] in ("subexpression", "projection"):
            return self._walk(ast)
        raise Unsupported(f"jmespath construct {ast[0]}")

    def _apply_rhs(self, rhs: Tuple, states: List[PathState],
                   roots: List[Tuple[str, ...]], proj: bool):
        kind = rhs[0]
        if kind == "field":
            out = []
            for st in states:
                if st.mode == "keys":
                    raise Unsupported("field access on keys()")
                # extending the path resets splice exclusion (it applied
                # to rows at the previous depth); projections still drop
                # null results
                out.append(PathState(st.segs + (rhs[1],), "value", no_null=proj))
            return out, roots, proj
        if kind == "subexpression":
            states, roots, proj = self._apply_rhs(rhs[1], states, roots, proj)
            return self._apply_rhs(rhs[2], states, roots, proj)
        if kind == "multiselect_list":
            out = []
            for sub in rhs[1]:
                s2, r2, _ = self._apply_rhs(sub, states, roots, proj)
                out.extend(s2)
            # a multiselect yields a literal list whenever its input is
            # non-null; record the input paths as mselect roots and mark
            # states so a following flatten treats each as one element
            roots = roots + [(s.segs, "mselect") for s in states if s.mode == "value"]
            return [PathState(s.segs, "mselect") for s in out], roots, proj
        if kind == "identity" or kind == "current":
            return states, roots, proj
        if kind == "function" and rhs[1] == "keys":
            if rhs[2] != [("current",)] and rhs[2] != [("identity",)]:
                raise Unsupported("keys() with non-@ argument")
            self._keys_error_states.extend(states)
            return [PathState(s.segs, "keys") for s in states], roots, proj
        raise Unsupported(f"jmespath construct {kind}")

    def _flatten(self, states: List[PathState], proj: bool = False):
        """[] applied to the value(s): arrays are spliced one level,
        non-array elements (maps, scalars, nulls) stay as elements.
        ``proj``: the input states are already a projection's per-element
        values — flatten then operates on the projected LIST (each value
        is an element; array values splice), not on the values as
        arrays."""
        out: List[PathState] = []
        roots: List[Tuple[Tuple[str, ...], str]] = []
        for st in states:
            if st.mode == "keys":
                out.append(st)  # already a flat string list
            elif st.mode == "mselect" or proj:
                # element is the sub-value itself; arrays splice — but a
                # state already marked no_arr holds no arrays to splice
                out.append(PathState(st.segs, "value", no_arr=True, no_null=True))
                if not st.no_arr:
                    out.append(PathState(st.segs + (ARRAY_SEG,), "value", no_null=True))
            else:
                out.append(PathState(st.segs + (ARRAY_SEG,), "value",
                                     no_arr=True, no_null=True))
                out.append(PathState(st.segs + (ARRAY_SEG, ARRAY_SEG), "value",
                                     no_null=True))
                roots.append((st.segs, "array"))
        return out, roots


@dataclass
class ForeachDeny:
    """One validate.foreach entry of the deny flavor: per-element
    condition evaluation over the listed arrays (the capabilities-strict
    shape). Semantics per validate_resource.go:163-233: any denied
    element fails the rule; zero applied elements skips it."""

    arrays: List[Tuple[str, ...]]   # absolute array paths (depth-1)
    tree: CondTreeIR
    # explicit elementScope:true — non-map elements are a rule ERROR
    # (utils/foreach.go:41-56), order-dependent vs earlier failures, so
    # such cells complete on host
    strict_maps: bool = False


def compile_foreach_list(ast: Tuple) -> List[Tuple[str, ...]]:
    """Recognize `request.object.<chain>[]` and
    `request.object.<chain>.[f1, f2, ...][]` foreach lists; returns the
    element array paths."""

    def chain_fields(node: Tuple) -> Optional[List[str]]:
        if node == ("subexpression", ("field", "request"), ("field", "object")):
            return []
        if node[0] == "subexpression" and node[2][0] == "field":
            base = chain_fields(node[1])
            if base is None:
                return None
            return base + [node[2][1]]
        return None

    if ast[0] != "projection" or ast[1][0] != "flatten":
        raise Unsupported("foreach list must be a [] projection")
    if ast[2] not in (("identity",), ("current",)):
        raise Unsupported("foreach list with projected RHS")
    inner = ast[1][1]
    # multiselect form: chain . [f1, f2, f3]
    if inner[0] == "subexpression" and inner[2][0] == "multiselect_list":
        base = chain_fields(inner[1])
        if base is None:
            raise Unsupported("foreach list base not request.object")
        arrays = []
        for sub in inner[2][1]:
            if sub[0] != "field":
                raise Unsupported("foreach multiselect with non-field entry")
            arrays.append(tuple(base + [sub[1]]))
        return arrays
    fields = chain_fields(inner)
    if fields is None:
        raise Unsupported("foreach list base not request.object")
    return [tuple(fields)]


# ---------------------------------------------------------------------------
# CEL validate.cel IR (the tractable matches() subset)
#
# CEL rules historically had NO device lowering (the whole rule routed
# to the scalar engine). The subset below — boolean combinations of
# `object.<chain>.matches('literal')`, string ==/!=, has() guards and
# bool literals — covers the pattern-bearing VAP/cel shapes that cap
# device_coverage, and lowers onto the DFA bank (tpu/dfa.py) plus the
# existing row lanes. Everything else keeps today's host route.


@dataclass
class CelMatches:
    """object.<path>.matches('<re2 literal>') — DFA over the value's
    byte-pool lane; non-string/missing targets are CEL errors."""

    path: Tuple[str, ...]
    regex: str


@dataclass
class CelStrCmp:
    """object.<path> ==/!= '<literal>' — heterogeneous equality is
    false (never an error); select errors on missing paths."""

    path: Tuple[str, ...]
    value: str
    negate: bool


@dataclass
class CelHas:
    """has(object.<parent>.<field>): parent must be a map (else CEL
    error), truth is key presence."""

    parent: Tuple[str, ...]
    fld: str


@dataclass
class CelNot:
    sub: Any


@dataclass
class CelAnd:
    left: Any
    right: Any


@dataclass
class CelOr:
    left: Any
    right: Any


@dataclass
class CelConst:
    value: bool


def _cel_chain(ast: Any) -> Tuple[str, ...]:
    segs: List[str] = []
    while isinstance(ast, tuple) and ast[0] == "select":
        segs.append(str(ast[2]))
        ast = ast[1]
    if ast != ("ident", "object"):
        raise Unsupported("cel expression not rooted at object")
    return tuple(reversed(segs))


def _lower_cel_ast(ast: Any) -> Any:
    tag = ast[0]
    if tag == "lit":
        if isinstance(ast[1], bool):
            return CelConst(ast[1])
        raise Unsupported("cel non-boolean literal expression")
    if tag == "not":
        return CelNot(_lower_cel_ast(ast[1]))
    if tag == "and":
        return CelAnd(_lower_cel_ast(ast[1]), _lower_cel_ast(ast[2]))
    if tag == "or":
        return CelOr(_lower_cel_ast(ast[1]), _lower_cel_ast(ast[2]))
    if tag == "method" and ast[2] == "matches" and len(ast[3]) == 1:
        return _lower_cel_matches(ast[1], ast[3][0])
    if tag == "call" and ast[1] == "matches" and len(ast[2]) == 2:
        return _lower_cel_matches(ast[2][0], ast[2][1])
    if tag == "binop" and ast[1] in ("==", "!="):
        lhs, rhs = ast[2], ast[3]
        if isinstance(rhs, tuple) and rhs[0] == "lit":
            chain, lit = lhs, rhs
        elif isinstance(lhs, tuple) and lhs[0] == "lit":
            chain, lit = rhs, lhs
        else:
            raise Unsupported("cel comparison without a literal side")
        if not isinstance(lit[1], str):
            raise Unsupported("cel non-string comparison literal")
        return CelStrCmp(_cel_chain(chain), lit[1], ast[1] == "!=")
    if tag == "has":
        return CelHas(_cel_chain(ast[1]), str(ast[2]))
    raise Unsupported(f"cel construct {tag}")


def _lower_cel_matches(target: Any, arg: Any) -> "CelMatches":
    if not (isinstance(arg, tuple) and arg[0] == "lit"
            and isinstance(arg[1], str)):
        raise Unsupported("cel matches() with non-literal pattern")
    path = _cel_chain(target)
    from .dfa import DfaUnsupported, compile_re2

    try:
        compile_re2(arg[1])
    except DfaUnsupported as e:
        # genuinely non-lowerable pattern — today's host-cell route;
        # the "pattern:" tag attributes these host cells to the
        # pattern class in coverage accounting
        raise Unsupported(f"pattern: {e}")
    except Exception as e:  # Re2Error etc: host compile will error too
        raise Unsupported(f"pattern: regex {e}")
    return CelMatches(path, arg[1])


def _walk_cel_ir(node: Any, paths: Set[Tuple[str, ...]],
                 regexes: List[str]) -> None:
    if isinstance(node, CelMatches):
        paths.add(node.path)
        regexes.append(node.regex)
    elif isinstance(node, CelNot):
        _walk_cel_ir(node.sub, paths, regexes)
    elif isinstance(node, (CelAnd, CelOr)):
        _walk_cel_ir(node.left, paths, regexes)
        _walk_cel_ir(node.right, paths, regexes)


def compile_cel_validation(rule: Rule, prog: "RuleProgram") -> None:
    """Lower validate.cel onto ``prog`` (kind='cel') or raise
    Unsupported. Mirrors engine._validate_cel semantics for the
    lowered shape: every expression must hold (first error -> rule
    ERROR, else any false -> FAIL); DELETE admissions divert per cell
    to the host (the skip-on-delete guard)."""
    from ..cel import compile as cel_compile
    from ..cel.parser import parse as cel_parse

    if rule.cel_preconditions:
        raise Unsupported("celPreconditions (matchConditions)")
    spec = rule.validation.cel or {}
    extra = {k for k, v in spec.items()
             if v not in (None, [], {}) and k != "expressions"}
    if extra:
        # variables / auditAnnotations / paramKind change evaluation or
        # response content in ways the lowering does not model
        raise Unsupported(f"cel spec keys {sorted(extra)}")
    exprs = spec.get("expressions") or []
    if not exprs:
        raise Unsupported("cel without expressions")
    prog.kind = "cel"
    for e in exprs:
        if not isinstance(e, dict):
            raise Unsupported("malformed cel expression entry")
        bad = set(e) - {"expression", "message"}
        if bad:
            # messageExpression computes per-resource messages on host
            raise Unsupported(f"cel expression keys {sorted(bad)}")
        text = e.get("expression") or ""
        try:
            cel_compile(text)  # host compile failure => rule-level error
        except Exception as ex:  # noqa: BLE001
            raise Unsupported(f"cel compile: {ex}")
        prog.cel.append(_lower_cel_ast(cel_parse(text)))
    paths: Set[Tuple[str, ...]] = set()
    regexes: List[str] = []
    for node in prog.cel:
        _walk_cel_ir(node, paths, regexes)
    for pth in paths:
        prog.byte_paths.add(hash_path(pth))
    prog.regex_patterns = regexes


# ---------------------------------------------------------------------------
# match / exclude IR


@dataclass
class KindSel:
    group: str
    version: str
    kind: str
    sub: str


@dataclass
class SelectorIR:
    match_labels: List[Tuple[str, str]]
    expressions: List[Tuple[str, str, List[str]]]  # (key, op, values)
    invalid: bool  # malformed selector => constant "does not match"
    # wildcard matchLabels entries (CheckSelector expands them against
    # the actual labels): matched on device via the glob NFA over the
    # label byte lanes, plus the '0'-substitution fallback pair
    wild_labels: List[Tuple[str, str]] = field(default_factory=list)


@dataclass
class FilterIR:
    kinds: List[KindSel]
    name: str
    names: List[str]
    namespaces: List[str]
    annotations: List[Tuple[str, str]]
    selector: Optional[SelectorIR]
    ns_selector: Optional[SelectorIR]
    operations: List[str]
    roles: List[str]
    cluster_roles: List[str]
    subjects: List[Dict[str, Any]]
    resources_empty: bool
    user_empty: bool


@dataclass
class MatchIR:
    mode: str  # any | all | legacy
    filters: List[FilterIR]


def _compile_selector(sel: Optional[Dict[str, Any]],
                      allow_wild: bool = False) -> Optional[SelectorIR]:
    if sel is None:
        return None
    from ..engine.selector import SelectorError, check_selector, matches_selector

    ml: List[Tuple[str, str]] = []
    wild: List[Tuple[str, str]] = []
    for k, v in (sel.get("matchLabels") or {}).items():
        k, v = str(k), str(v)
        if contains_wildcard(k) or contains_wildcard(v):
            if not allow_wild:
                raise Unsupported("wildcard label selector")
            wild.append((k, v))
        else:
            ml.append((k, v))
    # CheckSelector expands wildcard entries into a DICT, where an
    # expanded key can overwrite another entry (last write wins). The
    # device lowers entries as an independent conjunction, which is
    # only equivalent when no collision can occur: at most one
    # wildcard entry, whose key pattern cannot match any literal key.
    if wild:
        from ..utils.wildcard import match as _wmatch

        # value-only wildcard entries keep their literal key under
        # expansion and can never collide; only wildcard KEYS move
        wild_keys = [k for k, _ in wild if contains_wildcard(k)]
        if len(wild_keys) > 1:
            raise Unsupported("multiple wildcard matchLabels keys")
        if wild_keys and (
                any(_wmatch(wild_keys[0], lit_k) for lit_k, _ in ml)
                or any(_wmatch(wild_keys[0], k) for k, _ in wild
                       if k != wild_keys[0])):
            raise Unsupported("wildcard matchLabels key may collide with "
                              "another entry")
    exprs: List[Tuple[str, str, List[str]]] = []
    for e in sel.get("matchExpressions") or []:
        exprs.append((str(e.get("key")), str(e.get("operator")), [str(v) for v in (e.get("values") or [])]))
    # malformed selectors become a constant no-match (scalar engine adds
    # a "failed to parse selector" reason); probe through the wildcard-
    # expanding entry point so wildcard chars themselves don't trip the
    # label-syntax validation
    try:
        check_selector(sel, {})
        invalid = False
    except SelectorError:
        if wild:
            # validity is resource-dependent for wildcard selectors
            # (the '0'-substitution probe fails, but a glob-matching
            # label would substitute to a VALID actual key) — host
            raise Unsupported("wildcard selector with invalid substitution")
        invalid = True
    except Exception:
        raise Unsupported("selector evaluation error")
    return SelectorIR(ml, exprs, invalid, wild_labels=wild)


def _compile_filter(rf: ResourceFilter) -> FilterIR:
    rd: ResourceDescription = rf.resources
    ui: UserInfo = rf.user_info
    kinds: List[KindSel] = []
    for k in rd.kinds:
        g, v, kk, sub = kube.parse_kind_selector(k)
        for part in (g, v, kk, sub):
            if contains_wildcard(part) and part != "*":
                raise Unsupported(f"glob kind selector {k}")
        kinds.append(KindSel(g, v, kk, sub))
    for a_k, a_v in (rd.annotations or {}).items():
        if contains_wildcard(str(a_k)) or contains_wildcard(str(a_v)):
            raise Unsupported("glob annotations match")
    for s in ui.subjects or []:
        if contains_wildcard(str(s.get("name", ""))) or contains_wildcard(str(s.get("namespace", ""))):
            raise Unsupported("glob subject")
        if s.get("kind") not in ("ServiceAccount", "User", "Group"):
            raise Unsupported(f"subject kind {s.get('kind')}")
    for r in list(ui.roles or []) + list(ui.cluster_roles or []):
        if contains_wildcard(r):
            raise Unsupported("glob role")
    return FilterIR(
        kinds=kinds,
        name=rd.name,
        names=list(rd.names),
        namespaces=list(rd.namespaces),
        annotations=[(str(k), str(v)) for k, v in (rd.annotations or {}).items()],
        selector=_compile_selector(rd.selector, allow_wild=True),
        ns_selector=_compile_selector(rd.namespace_selector),
        operations=list(rd.operations),
        roles=list(ui.roles),
        cluster_roles=list(ui.cluster_roles),
        subjects=list(ui.subjects),
        resources_empty=rd.is_empty(),
        user_empty=ui.is_empty(),
    )


def compile_match(rule: Rule) -> Tuple[MatchIR, MatchIR]:
    match = rule.match
    if match.any:
        m = MatchIR("any", [_compile_filter(rf) for rf in match.any])
    elif match.all:
        m = MatchIR("all", [_compile_filter(rf) for rf in match.all])
    else:
        m = MatchIR("legacy", [_compile_filter(
            ResourceFilter(resources=match.resources, user_info=match.user_info))])
    exclude = rule.exclude
    if exclude.any:
        e = MatchIR("any", [_compile_filter(rf) for rf in exclude.any])
    elif exclude.all:
        e = MatchIR("all", [_compile_filter(rf) for rf in exclude.all])
    else:
        e = MatchIR("legacy", [_compile_filter(
            ResourceFilter(resources=exclude.resources, user_info=exclude.user_info))])
    return m, e


# ---------------------------------------------------------------------------
# rule program


@dataclass
class RuleProgram:
    policy_name: str
    rule_name: str
    policy_namespace: str
    match: Optional[MatchIR]
    exclude: Optional[MatchIR]
    preconditions: Optional[CondTreeIR]
    kind: str  # pattern | any_pattern | deny | foreach_deny | cel
    patterns: List[Node] = field(default_factory=list)
    deny: Optional[CondTreeIR] = None
    foreach: List[ForeachDeny] = field(default_factory=list)
    # validate.cel lowering: per-expression IR trees (the matches()
    # subset) + the re2 patterns they reference (DFA-bank input)
    cel: List[Any] = field(default_factory=list)
    regex_patterns: List[str] = field(default_factory=list)
    # set by the policy-set compiler when this program evaluates any
    # glob/regex through the DFA bank (pattern-cell accounting)
    uses_patterns: bool = False
    byte_paths: Set[int] = field(default_factory=set)
    key_byte_paths: Set[int] = field(default_factory=set)
    message: str = ""
    # set when this rule cannot run on device
    fallback_reason: Optional[str] = None
    # reads request.userInfo identity lanes (hash equality): requests
    # whose identity strings carry globs divert to host per cell
    uses_userinfo: bool = False
    # host-resolved context operand slots (slot indices are rule-local
    # here; the policy-set compiler rebases them globally)
    dyn_slots: List["DynSlot"] = field(default_factory=list)


_FOLD_VAR_RE = re.compile(r"\{\{\s*([^{}]+?)\s*\}\}")
_FOLD_ROOT_RE = re.compile(r"^([A-Za-z_][A-Za-z_0-9]*)")


def _root_refs(ast: Tuple, out: Set[str]) -> None:
    """Collect the ROOT identifiers a jmespath AST reads from the
    evaluation context (rhs fields of subexpressions / projections /
    pipes operate on intermediate values, not the root). Unknown
    constructs poison the set with '?'."""
    kind = ast[0]
    if kind == "field":
        out.add(ast[1])
    elif kind in ("literal", "identity", "index", "flatten_marker"):
        pass
    elif kind == "current":
        out.add("@")
    elif kind == "index_expression":
        # child is a [left, index] LIST; the left node holds the root
        _root_refs(ast[1][0], out)
    elif kind in ("subexpression", "value_projection", "filter_projection",
                  "pipe", "flatten", "not", "projection"):
        _root_refs(ast[1], out)
    elif kind in ("or", "and"):
        _root_refs(ast[1], out)
        _root_refs(ast[2], out)
    elif kind == "comparator":
        _root_refs(ast[2], out)
        _root_refs(ast[3], out)
    elif kind == "function":
        for a in ast[2]:
            _root_refs(a, out)
    elif kind == "multiselect_list":
        for a in ast[1]:
            _root_refs(a, out)
    elif kind == "multiselect_dict":
        for _k, a in ast[1]:
            _root_refs(a, out)
    else:
        out.add("?")


# roots the engine itself provides — references to these are dynamic
# but not context-entry references
_BUILTIN_ROOTS = {"request", "element", "elementIndex", "images", "@",
                  "serviceAccountName", "serviceAccountNamespace"}

_CHAIN_REF_RE = re.compile(r"^([A-Za-z_][A-Za-z_0-9]*)((?:\.[A-Za-z_0-9\-]+)*)$")


def _jmes_literal(v: Any) -> Optional[str]:
    """Render a Python literal as jmespath literal syntax."""
    import json as _json

    if isinstance(v, str) and "'" not in v and "`" not in v:
        return f"'{v}'"
    try:
        return "`" + _json.dumps(v) + "`"
    except Exception:  # noqa: BLE001
        return None


def _fold_static_context(rule: Rule, data_sources=None,
                         deps: Optional[Dict[str, Optional[str]]] = None) -> Optional[Rule]:
    """Compile-time context specialization. Each context entry resolves
    to one of three forms, and every ``{{ name... }}`` reference in the
    rule body substitutes accordingly, so the rule lowers like a
    context-free one:

    - **constant**: `variable` entries whose value/jmesPath close over
      literals (and earlier constants — chained entries fold through
      the full jmespath engine, custom functions included), and
      `configMap` entries resolved against ``data_sources``
      (dependencies recorded in ``deps`` for recompilation when the
      configmap's content hash moves);
    - **template tree**: `variable.value` trees whose leaves still
      contain ``{{ request... }}`` templates — references navigate the
      tree and splice the underlying template;
    - **expression**: `variable.jmesPath` specs that read the live
      request context — references inline the expression text (with
      ``|| default`` for literal or template defaults), exactly what
      the deferred loader would evaluate per request.

    apiCall/imageRegistry/globalReference entries stay dynamic; the
    rule only falls back when such an entry is actually REFERENCED
    (unreferenced entries are dropped, matching deferred-loading
    semantics). Returns None when any reference cannot be resolved."""
    import json as _json

    from ..engine.context import Context
    from ..engine.contextloaders import _load_configmap, _load_variable
    from ..engine.jmespath import compile as jp_compile

    parser = JmesParser()
    env: Dict[str, Any] = {}        # fully-resolved constants
    trees: Dict[str, Any] = {}      # value trees w/ embedded templates
    exprs: Dict[str, str] = {}      # live-context expression text
    entry_names: Set[str] = set()
    local_deps: Dict[str, Optional[str]] = {}

    def is_pure(v: Any) -> bool:
        return "{{" not in _json.dumps(v, default=str)

    def resolve_expr_text(text: str) -> Optional[str]:
        """Substitute {{const}} references inside an expression TEXT
        (e.g. a jmesPath spec referencing an earlier constant)."""
        out = text
        for m in reversed(list(_FOLD_VAR_RE.finditer(text))):
            inner = m.group(1).strip()
            roots: Set[str] = set()
            try:
                _root_refs(parser.parse(inner), roots)
            except Exception:  # noqa: BLE001
                return None
            if not roots <= set(env):
                return None
            try:
                val = jp_compile(inner).search(env)
            except Exception:  # noqa: BLE001
                return None
            if not isinstance(val, str):
                return None
            out = out[:m.start()] + val + out[m.end():]
        return out

    def navigate(tree: Any, suffix: str) -> Any:
        """Walk a template tree by a .a.b identifier chain."""
        cur = tree
        for seg in [s for s in suffix.split(".") if s]:
            if isinstance(cur, dict) and seg in cur:
                cur = cur[seg]
            else:
                return None  # loader: missing path -> null
        return cur

    for entry in rule.context:
        if not isinstance(entry, dict):
            return None
        name = entry.get("name")
        if not name or name in _BUILTIN_ROOTS:
            return None
        entry_names.add(name)
        # an overriding entry drops the previous resolution
        env.pop(name, None)
        trees.pop(name, None)
        exprs.pop(name, None)
        spec = entry.get("variable")
        cm_spec = entry.get("configMap")
        if isinstance(spec, dict):
            value = spec.get("value")
            jmes = spec.get("jmesPath")
            default = spec.get("default")
            if value is not None:
                if is_pure(spec):
                    try:
                        env[name] = _load_variable(Context(), spec)
                    except Exception:  # noqa: BLE001
                        pass  # stays unresolved; fails only if referenced
                    continue
                val = _subst_const_templates(value, env, jp_compile, parser)
                if jmes is not None:
                    # the loader evaluates jmesPath AGAINST the value
                    # tree; identifier chains navigate it structurally
                    jtext = resolve_expr_text(jmes) if "{{" in jmes else jmes
                    if jtext is None or not _CHAIN_REF_RE.match(jtext):
                        continue  # unresolved
                    val = navigate({"_": val}, "_." + jtext)
                if val is None and default is not None:
                    # loader: a null navigation result takes the default
                    if not is_pure(default):
                        continue  # template default on a tree: dynamic
                    val = default
                if val is not None and is_pure(val):
                    env[name] = val
                else:
                    trees[name] = val
                continue
            if jmes is None:
                continue  # unresolved shape
            jtext = resolve_expr_text(jmes) if "{{" in jmes else jmes
            if jtext is None or "{{" in jtext:
                continue  # unresolved
            roots: Set[str] = set()
            try:
                _root_refs(parser.parse(jtext), roots)
            except Exception:  # noqa: BLE001
                continue
            if roots <= set(env):
                # closes over earlier constants -> fold fully (custom
                # functions run through the real engine)
                try:
                    val = jp_compile(jtext).search(env)
                except Exception:  # noqa: BLE001
                    val = None
                if val is None and default is not None and is_pure(default):
                    val = default
                env[name] = val
                continue
            if default is None:
                exprs[name] = jtext
            else:
                # the loader's default fires on null/missing ONLY
                # (contextloaders.py _load_variable), which is exactly
                # not_null() — NOT jmespath `||` (falsy) semantics
                if isinstance(default, str) and "{{" in default:
                    m = _FOLD_VAR_RE.fullmatch(default.strip())
                    if m is None:
                        continue  # partial template default
                    exprs[name] = f"not_null({jtext}, {m.group(1).strip()})"
                else:
                    lit = _jmes_literal(default)
                    if lit is None:
                        continue
                    exprs[name] = f"not_null({jtext}, {lit})"
        elif isinstance(cm_spec, dict):
            if data_sources is None or data_sources.configmaps is None:
                continue
            if "{{" in _json.dumps(cm_spec, default=str):
                continue  # per-request namespace/name -> dynamic
            try:
                env[name] = _load_configmap(Context(), cm_spec, data_sources)
            except Exception:  # noqa: BLE001
                continue
            from ..cluster.snapshot import resource_hash

            key = (f"{cm_spec.get('namespace', '') or 'default'}/"
                   f"{cm_spec.get('name', '')}")
            local_deps[key] = resource_hash(env[name])
        # apiCall / imageRegistry / globalReference: unresolved

    def resolve_full(expr: str):
        """Resolve a whole-string {{expr}}: constant, spliced template
        string, or _UNFOLDED."""
        roots: Set[str] = set()
        try:
            ast = parser.parse(expr)
        except Exception:  # noqa: BLE001
            return _UNFOLDED
        _root_refs(ast, roots)
        ctx_roots = roots & entry_names
        if not ctx_roots:
            return _UNFOLDED  # request-rooted etc. — leave as-is
        if "?" in roots:
            return _UNFOLDED
        if roots <= set(env):
            try:
                return jp_compile(expr).search(env)
            except Exception:  # noqa: BLE001
                return _UNFOLDED
        m = _CHAIN_REF_RE.match(expr)
        if m is None:
            return _UNFOLDED
        name, suffix = m.group(1), m.group(2)
        if name in trees:
            sub = navigate(trees[name], suffix)
            if sub is None or is_pure(sub) or isinstance(sub, str):
                # a constant, or a template STRING (splices verbatim
                # and re-compiles as a request-rooted key)
                return sub
            return _UNFOLDED  # composite with embedded templates
        if name in exprs:
            base = exprs[name]
            if not suffix:
                return "{{ " + base + " }}"
            if "||" in base:
                return _UNFOLDED  # suffix would bind tighter than ||
            return "{{ " + base + suffix + " }}"
        return _UNFOLDED

    def subst(node: Any) -> Any:
        if isinstance(node, dict):
            return {subst(k) if isinstance(k, str) else k: subst(v)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [subst(x) for x in node]
        if not isinstance(node, str):
            return node
        matches = list(_FOLD_VAR_RE.finditer(node))
        if not matches:
            return node
        if len(matches) == 1 and matches[0].span() == (0, len(node)):
            val = resolve_full(matches[0].group(1).strip())
            return node if val is _UNFOLDED else val
        out = node
        for m in reversed(matches):
            val = resolve_full(m.group(1).strip())
            if val is _UNFOLDED:
                continue
            if isinstance(val, bool):
                s = "true" if val else "false"
            elif val is None or isinstance(val, (dict, list)):
                return node  # composite interpolation stays dynamic
            else:
                s = str(val)
            out = out[:m.start()] + s + out[m.end():]
        return out

    raw = subst({k: v for k, v in rule.raw.items() if k != "context"})
    # entries that did not resolve statically stay DYNAMIC: their
    # values load per request on the host and feed the device program
    # as operand lanes. References to them are only evaluable in
    # condition positions (preconditions / deny conditions).
    resolved = set(env) | set(trees) | set(exprs)
    dyn_names = entry_names - resolved

    def references(node: Any, names: Set[str]) -> bool:
        if isinstance(node, dict):
            return any(references(k, names) or references(v, names)
                       for k, v in node.items())
        if isinstance(node, list):
            return any(references(x, names) for x in node)
        if not isinstance(node, str):
            return False
        for m in _FOLD_VAR_RE.finditer(node):
            roots: Set[str] = set()
            try:
                _root_refs(parser.parse(m.group(1).strip()), roots)
            except Exception:  # noqa: BLE001
                return True  # unparseable template — stay conservative
            if roots & names or "?" in roots:
                return True
        return False

    # resolved-entry references must all have substituted away
    if references(raw, resolved):
        return None
    dyn_map: Dict[str, List[Dict[str, Any]]] = {}
    if references(raw, dyn_names):
        # dynamic references outside the condition zones (match blocks,
        # patterns, foreach bodies) have no operand-lane lowering
        cond_free = {k: v for k, v in raw.items()
                     if k not in ("preconditions", "validate")}
        v_raw = dict(raw.get("validate") or {})
        v_raw.pop("deny", None)
        v_raw.pop("message", None)
        if references(cond_free, dyn_names) or references(v_raw, dyn_names):
            return None
        dyn_map = {n: list(rule.context) for n in dyn_names}
    if deps is not None:
        deps.update(local_deps)
    return Rule.from_dict(raw), dyn_map


def _subst_const_templates(tree: Any, env: Dict[str, Any], jp_compile,
                           parser) -> Any:
    """Substitute {{...}} templates inside a value tree when they close
    over constants; other templates stay verbatim."""
    if isinstance(tree, dict):
        return {k: _subst_const_templates(v, env, jp_compile, parser)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_subst_const_templates(x, env, jp_compile, parser)
                for x in tree]
    if not isinstance(tree, str) or "{{" not in tree:
        return tree
    m = _FOLD_VAR_RE.fullmatch(tree.strip())
    if m is not None:
        roots: Set[str] = set()
        try:
            _root_refs(parser.parse(m.group(1).strip()), roots)
            if roots <= set(env):
                return jp_compile(m.group(1).strip()).search(env)
        except Exception:  # noqa: BLE001
            pass
    return tree


_UNFOLDED = object()


def compile_rule(policy: ClusterPolicy, rule: Rule, data_sources=None,
                 deps: Optional[Dict[str, Optional[str]]] = None) -> RuleProgram:
    """Compile one validate rule; raises Unsupported for host-only
    rules. Context deps only merge into ``deps`` when the WHOLE rule
    compiles — a host-fallback rule must not register invalidation
    hooks for configmaps no device program folds."""
    fold_deps: Dict[str, Optional[str]] = {}
    dyn_map: Dict[str, List[Dict[str, Any]]] = {}
    if rule.validation is None:
        raise Unsupported("not a validate rule")
    if rule.context:
        folded = _fold_static_context(rule, data_sources, fold_deps)
        if folded is None or folded[0].validation is None:
            raise Unsupported("rule context entries")
        rule, dyn_map = folded
    prog = _compile_rule_body(policy, rule, dyn_map)
    if deps is not None:
        deps.update(fold_deps)
    return prog


def _compile_rule_body(policy: ClusterPolicy, rule: Rule,
                       dyn_map: Optional[Dict[str, List[Dict[str, Any]]]] = None) -> RuleProgram:
    v = rule.validation
    match_ir, exclude_ir = compile_match(rule)
    cc = ConditionCompiler(dyn_vars=dyn_map)
    pre_ir = cc.compile_tree(rule.preconditions)

    prog = RuleProgram(
        policy_name=policy.name,
        rule_name=rule.name,
        policy_namespace=policy.namespace,
        match=match_ir,
        exclude=exclude_ir,
        preconditions=pre_ir,
        kind="",
        message=v.message or "",
    )
    if v.deny is not None:
        prog.kind = "deny"
        prog.deny = cc.compile_tree((v.deny or {}).get("conditions"))
        prog.uses_userinfo = cc.saw_userinfo
        prog.dyn_slots = cc.dyn_slots
        return prog
    prog.uses_userinfo = cc.saw_userinfo
    prog.dyn_slots = cc.dyn_slots
    if v.pattern is not None:
        pc = PatternCompiler()
        prog.kind = "pattern"
        prog.patterns = [pc.compile(v.pattern)]
        prog.byte_paths = pc.byte_paths
        prog.key_byte_paths = pc.key_byte_paths
        return prog
    if v.any_pattern is not None:
        pc = PatternCompiler()
        prog.kind = "any_pattern"
        prog.patterns = [pc.compile(p) for p in v.any_pattern]
        prog.byte_paths = pc.byte_paths
        prog.key_byte_paths = pc.key_byte_paths
        return prog
    if v.foreach is not None:
        prog.kind = "foreach_deny"
        ecc = ConditionCompiler(element_mode=True)
        for fe in v.foreach:
            extra = set(fe.keys()) - {"list", "deny", "elementScope"}
            if extra:
                raise Unsupported(f"foreach with {sorted(extra)}")
            if fe.get("deny") is None:
                raise Unsupported("foreach without deny")
            scope_flag = fe.get("elementScope")
            if scope_flag is False:
                # explicit false unbinds {{element}} — host semantics
                raise Unsupported("foreach deny with elementScope=false")
            list_expr = fe.get("list", "")
            if "{{" in list_expr:
                raise Unsupported("variable foreach list")
            arrays = compile_foreach_list(ecc._parser.parse(list_expr))
            tree = ecc.compile_tree((fe["deny"] or {}).get("conditions"))
            if tree is None:
                raise Unsupported("foreach deny without conditions")
            prog.foreach.append(ForeachDeny(arrays, tree,
                                            strict_maps=scope_flag is True))
        return prog
    # scalar dispatch order (engine._validate_rule): podSecurity comes
    # before cel — a rule carrying both must keep the scalar handler
    if v.cel is not None and v.pod_security is None \
            and v.manifests is None:
        compile_cel_validation(rule, prog)
        return prog
    raise Unsupported("podSecurity/cel/manifest rule")
