# Copied verbatim from kyverno_tpu/tpu/flatten.py.
"""Resource JSON -> padded row tables (the device-side resource encoding).

Every node of the resource tree (maps, arrays, scalars, nulls) becomes
one row. Rows carry:

- ``norm`` hash: the normalized path (array indices -> the reserved
  ``[]`` segment), the join key for pattern-leaf and deny-path lookups;
- ``parent`` hash: normalized parent path (for ``keys(@)`` collections);
- ``key`` hash: the map-key name of this node (last path segment);
- ``scope1``/``scope2``: element index within the outermost / second
  enclosing array (-1 when none) — the per-instance join keys used by
  anchor semantics inside arrays-of-maps;
- typed value lanes, pre-parsed on host so the device never touches
  strings: Go-repr canonical hash (exact equality), f32 numeric lanes
  + canonical hashes for quantity / duration / Go-number comparisons
  (mirrors pattern.go:207-215 trial order), bool lane, array length;
- an optional byte-pool slot for values that compiled policies need to
  glob-match (operands containing ``*``/``?``).

Encoding is resource-count-linear: one pass per resource regardless of
how many policies later evaluate against it — this is what turns the
reference's O(policies x rules x resources) tree walks
(pkg/engine/validate/validate.go:31) into O(resources) host work plus
a device cross-product.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..engine.pattern import go_format_float_e, go_parse_float, go_parse_int
from ..utils.duration import parse_duration
from ..utils.quantity import parse_quantity
from .hashing import (
    ARRAY_SEG,
    PATH_SEP,
    _FNV_PRIME,
    _MASK,
    canon_duration,
    canon_number,
    canon_quantity,
    fnv1a64,
    hash_path,
    hash_str,
    split32,
)

# type tags
T_NULL, T_BOOL, T_NUM, T_STR, T_MAP, T_ARR = 0, 1, 2, 3, 4, 5

ROOT_HASH = hash_path(())


class EncodeConfig:
    """Shape caps. Exceeding a cap flags the resource for host fallback
    (never silently wrong)."""

    def __init__(
        self,
        max_rows: int = 256,
        max_instances: int = 16,
        byte_pool_slots: int = 32,
        byte_pool_width: int = 96,
    ):
        self.max_rows = max_rows
        self.max_instances = max_instances
        self.byte_pool_slots = byte_pool_slots
        self.byte_pool_width = byte_pool_width


def plan_byte_pool(cfg: EncodeConfig, byte_paths, key_byte_paths) -> EncodeConfig:
    """Byte-lane capacity planning for pattern-referenced paths.

    Every value at a pattern-referenced path occupies one pool slot per
    resource (array broadcast and wildcard-key maps can occupy
    several), so a pattern-heavy policy set can exhaust the default
    slot count and silently demote whole resources to host fallback.
    Grow the pool (on a COPY — callers may share the config across
    compiles) to 2x the referenced-path count, power-of-two, capped at
    256: overflow beyond the plan still flags ``fallback`` — degraded
    to host completion, never wrong."""
    n_paths = len(set(byte_paths)) + len(set(key_byte_paths))
    if n_paths == 0:
        return cfg
    need = min(max(2 * n_paths, cfg.byte_pool_slots), 256)
    slots = max(cfg.byte_pool_slots, 1)
    while slots < need:
        slots *= 2
    slots = min(slots, 256)
    if slots <= cfg.byte_pool_slots:
        return cfg
    import copy as _copy

    cfg = _copy.copy(cfg)
    cfg.byte_pool_slots = slots
    return cfg


_LANES_U32 = (
    "norm_hi", "norm_lo", "parent_hi", "parent_lo", "key_hi", "key_lo",
    "repr_hi", "repr_lo", "qty_hi", "qty_lo", "dur_hi", "dur_lo",
    "num_hi", "num_lo", "sprint_hi", "sprint_lo",
)
_LANES_F32 = ("num_val", "qty_val", "dur_val", "arr_len")
_LANES_I32 = ("scope1", "scope2", "byte_slot", "key_byte_slot")
_LANES_U8 = (
    "type_tag", "bool_val", "has_repr", "has_qty", "has_dur", "has_num",
    "str_goint", "str_gofloat", "has_glob", "key_glob", "s2_overflow",
)


class RowBatch:
    """Struct-of-arrays over (n_resources, max_rows)."""

    def __init__(self, n: int, cfg: EncodeConfig):
        r = cfg.max_rows
        self.cfg = cfg
        for name in _LANES_U32:
            setattr(self, name, np.zeros((n, r), dtype=np.uint32))
        for name in _LANES_F32:
            setattr(self, name, np.zeros((n, r), dtype=np.float32))
        for name in _LANES_I32:
            setattr(self, name, np.full((n, r), -1, dtype=np.int32))
        for name in _LANES_U8:
            setattr(self, name, np.zeros((n, r), dtype=np.uint8))
        self.valid = np.zeros((n, r), dtype=np.uint8)
        self.n_rows = np.zeros((n,), dtype=np.int32)
        self.fallback = np.zeros((n,), dtype=np.uint8)  # caps exceeded
        self.pool = np.zeros((n, cfg.byte_pool_slots, cfg.byte_pool_width), dtype=np.uint8)
        self.pool_len = np.zeros((n, cfg.byte_pool_slots), dtype=np.int32)

    def arrays(self) -> Dict[str, np.ndarray]:
        out = {name: getattr(self, name) for name in
               _LANES_U32 + _LANES_F32 + _LANES_I32 + _LANES_U8}
        out.update(valid=self.valid, n_rows=self.n_rows, fallback=self.fallback,
                   pool=self.pool, pool_len=self.pool_len)
        return out


def _go_repr(value: Any) -> Optional[str]:
    """The string form used by pattern.go compareString (pattern.go:270):
    bools spell true/false, floats use FormatFloat('E', -1, 64)."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, str):
        return value
    if isinstance(value, float):
        return go_format_float_e(value)
    if isinstance(value, int):
        return str(value)
    return None


def go_sprint(value: Any) -> Optional[str]:
    """fmt.Sprint spelling for scalars (conditions.py _go_sprint), None
    for null/map/array (those never match literal sets)."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float):
        return str(int(value)) if value == int(value) else repr(value)
    if isinstance(value, int):
        return str(value)
    if isinstance(value, str):
        return value
    return None


def _number_string(value: Any) -> Optional[str]:
    """pattern.go:307 convertNumberToString: nil -> "0", float -> %f."""
    if value is None:
        return "0"
    if isinstance(value, bool):
        return None
    if isinstance(value, str):
        return value
    if isinstance(value, float):
        return "%f" % value
    if isinstance(value, int):
        return str(value)
    return None


class _ResourceEncoder:
    def __init__(self, batch: RowBatch, res_idx: int, byte_paths: Set[int],
                 key_byte_paths: Set[int]):
        self.b = batch
        self.i = res_idx
        self.byte_paths = byte_paths
        # map paths whose CHILD KEYS the policy set glob-matches
        # (wildcard metadata keys, wildcards.go:62 ExpandInMetadata)
        self.key_byte_paths = key_byte_paths
        self.row = 0
        self.pool_used = 0
        self.ok = True

    def _emit(self, segs: Tuple[str, ...], scope1: int, scope2: int) -> int:
        if self.row >= self.b.cfg.max_rows:
            self.ok = False
            return -1
        r = self.row
        self.row += 1
        b, i = self.b, self.i
        norm = hash_path(segs)
        parent = hash_path(segs[:-1]) if segs else 0
        key = hash_str(segs[-1], tag="k") if segs else 0
        b.norm_hi[i, r], b.norm_lo[i, r] = split32(norm)
        b.parent_hi[i, r], b.parent_lo[i, r] = split32(parent)
        b.key_hi[i, r], b.key_lo[i, r] = split32(key)
        # map keys containing glob metachars wildcard-match in membership
        # operators (conditions _wild_either) — flag for host fallback
        if segs and segs[-1] != ARRAY_SEG and ("*" in segs[-1] or "?" in segs[-1]):
            b.key_glob[i, r] = 1
        b.scope1[i, r] = scope1
        b.scope2[i, r] = scope2
        b.valid[i, r] = 1
        return r

    def _fill_scalar(self, r: int, norm: int, value: Any) -> None:
        b, i = self.b, self.i
        if value is None:
            b.type_tag[i, r] = T_NULL
        elif isinstance(value, bool):
            b.type_tag[i, r] = T_BOOL
            b.bool_val[i, r] = 1 if value else 0
        elif isinstance(value, (int, float)):
            b.type_tag[i, r] = T_NUM
            b.num_val[i, r] = np.float32(value)
            b.has_num[i, r] = 1
            b.num_hi[i, r], b.num_lo[i, r] = split32(canon_number(value))
        else:
            b.type_tag[i, r] = T_STR
            # condition membership wildcard-matches in BOTH directions
            # (_wild_either): a resource value containing */? acts as a
            # pattern — those cells must resolve on the host
            if "*" in value or "?" in value:
                b.has_glob[i, r] = 1
            # int-pattern vs string value requires the *int* grammar,
            # float-pattern the float grammar (pattern.go:71,107); the
            # str_goint / str_gofloat flags keep them distinct on device
            g_int = go_parse_int(value)
            g_float = go_parse_float(value)
            if g_int is not None:
                b.str_goint[i, r] = 1
            if g_float is not None:
                b.str_gofloat[i, r] = 1
            num = g_int if g_int is not None else g_float
            if num is not None:
                b.has_num[i, r] = 1
                b.num_val[i, r] = np.float32(num)
                b.num_hi[i, r], b.num_lo[i, r] = split32(canon_number(num))

        # repr lane (string comparisons, pattern.go:270 spelling)
        rep = _go_repr(value)
        if rep is not None:
            b.has_repr[i, r] = 1
            b.repr_hi[i, r], b.repr_lo[i, r] = split32(hash_str(rep, tag="s"))
            if norm in self.byte_paths:
                self._assign_pool(r, rep)
        # sprint lane (fmt.Sprint spelling used by condition operators:
        # integral floats print as ints, pkg/engine/variables/operator)
        sp = go_sprint(value)
        if sp is not None:
            b.sprint_hi[i, r], b.sprint_lo[i, r] = split32(hash_str(sp, tag="s"))
        # quantity / duration trial lanes (pattern.go:217,243 both go
        # through convertNumberToString first)
        ns = _number_string(value)
        if ns is not None:
            q = parse_quantity(ns)
            if q is not None:
                b.has_qty[i, r] = 1
                b.qty_val[i, r] = np.float32(q)
                b.qty_hi[i, r], b.qty_lo[i, r] = split32(canon_quantity(q))
            d = parse_duration(ns)
            if d is not None:
                b.has_dur[i, r] = 1
                b.dur_val[i, r] = np.float32(d / 1e9)
                b.dur_hi[i, r], b.dur_lo[i, r] = split32(canon_duration(d))

    def _assign_pool(self, r: int, s: str, lane: str = "byte_slot") -> None:
        b, i = self.b, self.i
        data = s.encode("utf-8")
        if len(data) > b.cfg.byte_pool_width or self.pool_used >= b.cfg.byte_pool_slots:
            self.ok = False
            return
        slot = self.pool_used
        self.pool_used += 1
        b.pool[i, slot, : len(data)] = np.frombuffer(data, dtype=np.uint8)
        b.pool_len[i, slot] = len(data)
        getattr(b, lane)[i, r] = slot

    def walk(self, node: Any, segs: Tuple[str, ...], scope1: int, scope2: int, depth: int) -> None:
        r = self._emit(segs, scope1, scope2)
        if r < 0:
            return
        b, i = self.b, self.i
        if isinstance(node, dict):
            b.type_tag[i, r] = T_MAP
            b.arr_len[i, r] = len(node)
            pool_keys = hash_path(segs) in self.key_byte_paths
            for k, v in node.items():
                child = self.walk(v, segs + (str(k),), scope1, scope2, depth)
                if pool_keys and child is not None and child >= 0:
                    self._assign_pool(child, str(k), "key_byte_slot")
                    # wildcard-matched keys' VALUES glob-compare against
                    # policy operands (e.g. "localhost/*"); pool them too
                    if isinstance(v, str) and b.byte_slot[i, child] < 0:
                        self._assign_pool(child, v)
        elif isinstance(node, list):
            b.type_tag[i, r] = T_ARR
            b.arr_len[i, r] = len(node)
            if len(node) > b.cfg.max_instances and depth == 0:
                # instance joins cap out; deny-path collection still works
                # so only flag when the policy set does instance joins —
                # handled conservatively: flag always (cheap, rare)
                self.ok = False
            if len(node) > b.cfg.max_instances and depth == 1:
                # second-level instance joins (nested array-of-maps
                # patterns) cap out; depth-1 arrays are common (env,
                # ports) so flag the ROW, and only rules that join at
                # this path fall back (evaluator _eval_array_maps)
                b.s2_overflow[i, r] = 1
            for idx, v in enumerate(node):
                s1, s2 = scope1, scope2
                if depth == 0:
                    s1 = idx
                elif depth == 1:
                    s2 = idx
                self.walk(v, segs + (ARRAY_SEG,), s1, s2, depth + 1)
        else:
            self._fill_scalar(r, hash_path(segs), node)
        return r


def _count_json_walks(resources: Sequence[Any]) -> None:
    """Account a full JSON flatten walk per non-empty resource on
    ``kyverno_tpu_encode_json_walks_total`` — the gate metric for the
    columnar store (cluster/columnar.py): an unchanged-resource rescan
    with the store warm must not move this counter. Pad resources
    ({}) carry no content to walk and are excluded so bucket padding
    never counts as feed work."""
    n = sum(1 for r in resources if r)
    if not n:
        return
    try:
        from ..observability.metrics import global_registry

        global_registry.encode_json_walks.inc(value=n)
    except Exception:
        pass  # accounting must never break an encode


def encode_resources_reference(
    resources: Sequence[Dict[str, Any]],
    cfg: Optional[EncodeConfig] = None,
    byte_paths: Optional[Iterable[int]] = None,
    key_byte_paths: Optional[Iterable[int]] = None,
) -> RowBatch:
    """Reference (slow, obviously-correct) encoder — the parity oracle
    for the memoized fast path below and the native C encoder."""
    cfg = cfg or EncodeConfig()
    bp = set(byte_paths or ())
    kbp = set(key_byte_paths or ())
    batch = RowBatch(len(resources), cfg)
    for i, res in enumerate(resources):
        enc = _ResourceEncoder(batch, i, bp, kbp)
        enc.walk(res, (), -1, -1, 0)
        batch.n_rows[i] = enc.row
        batch.fallback[i] = 0 if enc.ok else 1
    return batch


# ---------------------------------------------------------------------------
# Fast path: memoized rolling-hash walk + columnar assembly.
#
# The naive encoder above re-hashes the full path string at every node
# (O(depth * bytes) FNV per row, pure Python) and re-runs the scalar
# value analysis (Go number grammar, quantity/duration trials) for
# every occurrence of every value. Cluster snapshots are massively
# repetitive — resources of one kind share their entire path vocabulary
# and most scalar values — so both are memoized:
#
# - path memo: (parent FNV state, segment) -> child path record. FNV-1a
#   is a streaming hash, so a child's full-path hash continues from the
#   parent's 64-bit state; each distinct (parent, seg) edge is hashed
#   once per process, not once per row.
# - scalar memo: (type, value) -> the full lane tuple (type tag, repr /
#   sprint / quantity / duration / number hashes and floats, grammar
#   flags) computed by the same helpers the reference encoder uses.
#
# Rows are accumulated as Python tuples and written into the RowBatch
# with one vectorized scatter per lane at the end (zip(*rows) columnar
# transpose), replacing ~20 numpy scalar stores per row.

_FNV_ROOT_STATE = fnv1a64(b"p")  # state after hashing the path tag

_SEP_BYTES = PATH_SEP.encode("utf-8")


def _fnv_continue(state: int, data: bytes) -> int:
    h = state
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


class _PathMemo:
    """(parent_state, seg) -> (state, norm, norm_hi, norm_lo, key_hi,
    key_lo, key_glob). Bounded: cleared wholesale if it ever exceeds
    the cap (path vocabularies are tiny; this is a leak guard)."""

    __slots__ = ("memo",)
    CAP = 1 << 20

    def __init__(self):
        self.memo: Dict[Tuple[int, str], Tuple[int, int, int, int, int, int, int]] = {}

    def child(self, parent_state: int, seg: str) -> Tuple[int, int, int, int, int, int, int]:
        key = (parent_state, seg)
        rec = self.memo.get(key)
        if rec is None:
            data = seg.encode("utf-8")
            if parent_state != _FNV_ROOT_STATE:
                data = _SEP_BYTES + data
            state = _fnv_continue(parent_state, data)
            norm = state
            khash = hash_str(seg, tag="k")
            glob = 1 if (seg != ARRAY_SEG and ("*" in seg or "?" in seg)) else 0
            rec = (state, norm, (norm >> 32) & 0xFFFFFFFF, norm & 0xFFFFFFFF,
                   (khash >> 32) & 0xFFFFFFFF, khash & 0xFFFFFFFF, glob)
            if len(self.memo) >= self.CAP:
                self.memo.clear()
            self.memo[key] = rec
        return rec


def _scalar_rec(value: Any) -> tuple:
    """All scalar lanes for one value, as a tuple in _NODE_FIELDS order
    (see below); computed with the exact helpers the reference encoder
    uses so the two paths cannot diverge."""
    type_tag = T_NULL
    bool_val = 0
    has_num = num_hi = num_lo = 0
    num_val = 0.0
    str_goint = str_gofloat = has_glob = 0
    if value is None:
        pass
    elif isinstance(value, bool):
        type_tag = T_BOOL
        bool_val = 1 if value else 0
    elif isinstance(value, (int, float)):
        type_tag = T_NUM
        num_val = float(np.float32(value))
        has_num = 1
        num_hi, num_lo = split32(canon_number(value))
    else:
        type_tag = T_STR
        if "*" in value or "?" in value:
            has_glob = 1
        g_int = go_parse_int(value)
        g_float = go_parse_float(value)
        if g_int is not None:
            str_goint = 1
        if g_float is not None:
            str_gofloat = 1
        num = g_int if g_int is not None else g_float
        if num is not None:
            has_num = 1
            num_val = float(np.float32(num))
            num_hi, num_lo = split32(canon_number(num))

    has_repr = repr_hi = repr_lo = 0
    rep = _go_repr(value)
    if rep is not None:
        has_repr = 1
        repr_hi, repr_lo = split32(hash_str(rep, tag="s"))
    sprint_hi = sprint_lo = 0
    sp = go_sprint(value)
    if sp is not None:
        sprint_hi, sprint_lo = split32(hash_str(sp, tag="s"))
    has_qty = qty_hi = qty_lo = 0
    qty_val = 0.0
    has_dur = dur_hi = dur_lo = 0
    dur_val = 0.0
    ns = _number_string(value)
    if ns is not None:
        q = parse_quantity(ns)
        if q is not None:
            has_qty = 1
            qty_val = float(np.float32(q))
            qty_hi, qty_lo = split32(canon_quantity(q))
        d = parse_duration(ns)
        if d is not None:
            has_dur = 1
            dur_val = float(np.float32(d / 1e9))
            dur_hi, dur_lo = split32(canon_duration(d))
    return (type_tag, bool_val, 0.0,
            has_repr, repr_hi, repr_lo, sprint_hi, sprint_lo,
            has_num, num_hi, num_lo, num_val,
            has_qty, qty_hi, qty_lo, qty_val,
            has_dur, dur_hi, dur_lo, dur_val,
            str_goint, str_gofloat, has_glob, rep)


# node-record field order (last element, repr string, is stripped before
# columnar assembly)
_NODE_FIELDS = (
    "type_tag", "bool_val", "arr_len",
    "has_repr", "repr_hi", "repr_lo", "sprint_hi", "sprint_lo",
    "has_num", "num_hi", "num_lo", "num_val",
    "has_qty", "qty_hi", "qty_lo", "qty_val",
    "has_dur", "dur_hi", "dur_lo", "dur_val",
    "str_goint", "str_gofloat", "has_glob",
)

_NODE_DTYPES = {
    "type_tag": np.uint8, "bool_val": np.uint8, "arr_len": np.float32,
    "has_repr": np.uint8, "repr_hi": np.uint32, "repr_lo": np.uint32,
    "sprint_hi": np.uint32, "sprint_lo": np.uint32,
    "has_num": np.uint8, "num_hi": np.uint32, "num_lo": np.uint32,
    "num_val": np.float32,
    "has_qty": np.uint8, "qty_hi": np.uint32, "qty_lo": np.uint32,
    "qty_val": np.float32,
    "has_dur": np.uint8, "dur_hi": np.uint32, "dur_lo": np.uint32,
    "dur_val": np.float32,
    "str_goint": np.uint8, "str_gofloat": np.uint8, "has_glob": np.uint8,
}

_PATH_MEMO = _PathMemo()
_SCALAR_MEMO: Dict[Tuple[type, Any], tuple] = {}
_SCALAR_MEMO_CAP = 1 << 20

_ROOT_REC = (_FNV_ROOT_STATE, ROOT_HASH,
             (ROOT_HASH >> 32) & 0xFFFFFFFF, ROOT_HASH & 0xFFFFFFFF, 0, 0, 0)

# prebuilt container records keyed by (type_tag, length)
_CONTAINER_MEMO: Dict[Tuple[int, int], tuple] = {}


def _container_rec(tag: int, length: int) -> tuple:
    rec = _CONTAINER_MEMO.get((tag, length))
    if rec is None:
        rec = (tag, 0, float(length)) + (0,) * 17 + (0, 0, 0, None)
        _CONTAINER_MEMO[(tag, length)] = rec
    return rec


class _FastEncoder:
    """One batch-level accumulation; per-resource state is only the
    byte-pool cursor."""

    def __init__(self, batch: RowBatch, byte_paths: Set[int], key_byte_paths: Set[int]):
        self.b = batch
        self.byte_paths = byte_paths
        self.key_byte_paths = key_byte_paths
        self.max_rows = batch.cfg.max_rows
        self.max_instances = batch.cfg.max_instances
        # columnar accumulators (whole batch)
        self.flat: List[int] = []
        self.paths: List[tuple] = []   # (norm_hi,norm_lo,par_hi,par_lo,key_hi,key_lo,key_glob)
        self.nodes: List[tuple] = []   # _NODE_FIELDS order + trailing repr str
        self.scope1: List[int] = []
        self.scope2: List[int] = []
        self.s2_over: List[int] = []
        self.byte_slots: List[Tuple[int, int]] = []      # (flat_idx, slot)
        self.key_byte_slots: List[Tuple[int, int]] = []  # (flat_idx, slot)
        self.pool_strs: List[Tuple[int, int, bytes]] = []  # (res, slot, utf8)
        # per-resource state
        self.i = 0
        self.base = 0
        self.row = 0
        self.pool_used = 0
        self.ok = True

    def begin(self, i: int) -> None:
        self.i = i
        self.base = i * self.max_rows
        self.row = 0
        self.pool_used = 0
        self.ok = True

    def _assign_pool(self, flat_idx: int, s: str, key_lane: bool) -> Optional[int]:
        b = self.b
        data = s.encode("utf-8")
        if len(data) > b.cfg.byte_pool_width or self.pool_used >= b.cfg.byte_pool_slots:
            self.ok = False
            return None
        slot = self.pool_used
        self.pool_used += 1
        self.pool_strs.append((self.i, slot, data))
        (self.key_byte_slots if key_lane else self.byte_slots).append((flat_idx, slot))
        return slot

    def walk(self, node: Any, prec: tuple, par_hi: int, par_lo: int,
             scope1: int, scope2: int, depth: int):
        if self.row >= self.max_rows:
            self.ok = False
            return None
        r = self.row
        self.row += 1
        flat = self.base + r
        state, norm, norm_hi, norm_lo, key_hi, key_lo, key_glob = prec
        self.flat.append(flat)
        self.paths.append((norm_hi, norm_lo, par_hi, par_lo, key_hi, key_lo, key_glob))
        self.scope1.append(scope1)
        self.scope2.append(scope2)

        if isinstance(node, dict):
            self.s2_over.append(0)
            self.nodes.append(_container_rec(T_MAP, len(node)))
            pool_keys = norm in self.key_byte_paths
            child = _PATH_MEMO.child
            for k, v in node.items():
                ks = k if type(k) is str else str(k)
                crec = child(state, ks)
                cr = self.walk(v, crec, norm_hi, norm_lo, scope1, scope2, depth)
                if pool_keys and cr is not None and cr >= 0:
                    cflat = self.base + cr
                    self._assign_pool(cflat, ks, key_lane=True)
                    if isinstance(v, str) and not self._has_byte_slot(cflat):
                        self._assign_pool(cflat, v, key_lane=False)
        elif isinstance(node, list):
            over = 0
            if len(node) > self.max_instances:
                if depth == 0:
                    self.ok = False
                elif depth == 1:
                    over = 1
            self.s2_over.append(over)
            self.nodes.append(_container_rec(T_ARR, len(node)))
            crec = _PATH_MEMO.child(state, ARRAY_SEG)
            for idx, v in enumerate(node):
                s1, s2 = scope1, scope2
                if depth == 0:
                    s1 = idx
                elif depth == 1:
                    s2 = idx
                self.walk(v, crec, norm_hi, norm_lo, s1, s2, depth + 1)
        else:
            self.s2_over.append(0)
            # floats need the sign bit in the key: 0.0 == -0.0 as dict
            # keys but their Go reprs differ (0E+00 vs -0E+00)
            if node.__class__ is float and node == 0.0:
                key = (float, node, str(node))
            else:
                key = (node.__class__, node)
            try:
                rec = _SCALAR_MEMO.get(key)
            except TypeError:  # unhashable exotic scalar — not JSON, but be safe
                rec = _scalar_rec(node)
                key = None
            if rec is None:
                rec = _scalar_rec(node)
                if key is not None:
                    if len(_SCALAR_MEMO) >= _SCALAR_MEMO_CAP:
                        _SCALAR_MEMO.clear()
                    _SCALAR_MEMO[key] = rec
            self.nodes.append(rec)
            if rec[3] and norm in self.byte_paths:  # has_repr
                self._assign_pool(flat, rec[-1], key_lane=False)
        return r

    def _has_byte_slot(self, flat_idx: int) -> bool:
        # only consulted for just-emitted children of pool_keys maps —
        # scan the (short) tail of byte_slots for this resource
        for fi, _ in reversed(self.byte_slots):
            if fi < self.base:
                return False
            if fi == flat_idx:
                return True
        return False

    def finish_batch(self) -> None:
        """Columnar scatter of the accumulated rows into the RowBatch."""
        b = self.b
        if not self.flat:
            return
        fa = np.asarray(self.flat, dtype=np.int64)
        b.valid.ravel()[fa] = 1
        # paths record: (norm_hi, norm_lo, par_hi, par_lo, key_hi, key_lo, glob)
        pcols = tuple(zip(*self.paths))
        b.norm_hi.ravel()[fa] = np.asarray(pcols[0], dtype=np.uint32)
        b.norm_lo.ravel()[fa] = np.asarray(pcols[1], dtype=np.uint32)
        b.parent_hi.ravel()[fa] = np.asarray(pcols[2], dtype=np.uint32)
        b.parent_lo.ravel()[fa] = np.asarray(pcols[3], dtype=np.uint32)
        b.key_hi.ravel()[fa] = np.asarray(pcols[4], dtype=np.uint32)
        b.key_lo.ravel()[fa] = np.asarray(pcols[5], dtype=np.uint32)
        b.key_glob.ravel()[fa] = np.asarray(pcols[6], dtype=np.uint8)
        b.scope1.ravel()[fa] = np.asarray(self.scope1, dtype=np.int32)
        b.scope2.ravel()[fa] = np.asarray(self.scope2, dtype=np.int32)
        b.s2_overflow.ravel()[fa] = np.asarray(self.s2_over, dtype=np.uint8)
        ncols = tuple(zip(*self.nodes))
        for idx, name in enumerate(_NODE_FIELDS):
            getattr(b, name).ravel()[fa] = np.asarray(ncols[idx], dtype=_NODE_DTYPES[name])
        if self.byte_slots:
            idxs, slots = zip(*self.byte_slots)
            b.byte_slot.ravel()[np.asarray(idxs, dtype=np.int64)] = np.asarray(slots, dtype=np.int32)
        if self.key_byte_slots:
            idxs, slots = zip(*self.key_byte_slots)
            b.key_byte_slot.ravel()[np.asarray(idxs, dtype=np.int64)] = np.asarray(slots, dtype=np.int32)
        for i, slot, data in self.pool_strs:
            b.pool[i, slot, : len(data)] = np.frombuffer(data, dtype=np.uint8)
            b.pool_len[i, slot] = len(data)


def encode_resources(
    resources: Sequence[Dict[str, Any]],
    cfg: Optional[EncodeConfig] = None,
    byte_paths: Optional[Iterable[int]] = None,
    key_byte_paths: Optional[Iterable[int]] = None,
) -> RowBatch:
    """Encode a list of resource dicts into a padded RowBatch.

    ``byte_paths``: normalized-path hashes whose string values must be
    available as raw bytes (compiled policy set's glob operand paths).
    ``key_byte_paths``: map-path hashes whose child KEYS must be
    available as raw bytes (wildcard metadata pattern keys).
    """
    cfg = cfg or EncodeConfig()
    bp = set(byte_paths or ())
    kbp = set(key_byte_paths or ())
    _count_json_walks(resources)
    batch = RowBatch(len(resources), cfg)
    enc = _FastEncoder(batch, bp, kbp)
    for i, res in enumerate(resources):
        enc.begin(i)
        enc.walk(res, _ROOT_REC, 0, 0, -1, -1, 0)
        batch.n_rows[i] = enc.row
        batch.fallback[i] = 0 if enc.ok else 1
    enc.finish_batch()
    return batch


# ---------------------------------------------------------------------------
# Vocabulary encoding: row-dedup + device-side gather.
#
# The dense RowBatch is ~33KB per resource after padding (256 rows x
# ~25 lanes + the byte pool) — far more than a tunneled or PCIe H2D
# link wants to move per tile. But cluster snapshots are massively
# repetitive at ROW granularity: two Pods of the same shape share
# almost every (path, value, scope) row. So the transferable form is a
# per-tile row VOCABULARY (V distinct rows, all lanes, V << n*R) plus
# one (n, max_rows) int32 index table per tile — an embedding-table
# layout. The device program gathers dense lanes from the vocabulary
# (XLA fuses the gathers into the consumers), so the evaluator is
# unchanged. Pool strings dedup the same way into a string table.
#
# Typical effect on the PSS bench tile (8192 pods): 267MB dense ->
# ~12MB compact, which turns a ~4s per-tile H2D stall into ~0.2s.

_ROW_LANES = _LANES_U32 + _LANES_F32 + _LANES_I32 + _LANES_U8 + ("valid",)

_ROW_LANE_DTYPES = dict(_NODE_DTYPES)
_ROW_LANE_DTYPES.update({
    "norm_hi": np.uint32, "norm_lo": np.uint32, "parent_hi": np.uint32,
    "parent_lo": np.uint32, "key_hi": np.uint32, "key_lo": np.uint32,
    "scope1": np.int32, "scope2": np.int32,
    "byte_slot": np.int32, "key_byte_slot": np.int32,
    "key_glob": np.uint8, "s2_overflow": np.uint8, "valid": np.uint8,
})


class VocabBatch:
    """Compact encoded batch: row vocabulary + per-resource index table.

    ``lanes[name]`` is (V,) with row id 0 reserved for the all-zero
    (invalid / padding) row; ``row_idx`` is (n, max_rows) int32 into it.
    ``strs`` is the pool string table (id 0 = empty); ``pool_sidx`` maps
    (resource, pool slot) -> string id."""

    def __init__(self, n: int, cfg: EncodeConfig):
        self.cfg = cfg
        self.n = n
        self.row_idx = np.zeros((n, cfg.max_rows), dtype=np.int32)
        self.lanes: Dict[str, np.ndarray] = {}
        self.strs: List[bytes] = [b""]
        self.pool_sidx = np.zeros((n, cfg.byte_pool_slots), dtype=np.int32)
        self.n_rows = np.zeros((n,), dtype=np.int32)
        self.fallback = np.zeros((n,), dtype=np.uint8)

    @property
    def vocab_size(self) -> int:
        return int(next(iter(self.lanes.values())).shape[0]) if self.lanes else 1

    def to_host(self, meta, v_bucket: Optional[int] = None,
                s_bucket: Optional[int] = None,
                r_bucket: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Flat lane dict for device_put. Vocabulary axes pad to
        ``v_bucket`` / ``s_bucket`` and the rows axis trims to
        ``r_bucket`` so tile-to-tile size changes never re-trigger XLA
        compilation (shapes stay fixed; callers grow buckets
        monotonically). ``r_bucket`` must cover max(n_rows): typical
        resources use well under half of max_rows, and every dense
        lane — transfer AND device compute — scales with it."""
        V = self.vocab_size
        vb = v_bucket or V
        if vb < V:
            raise ValueError(f"v_bucket {vb} < vocabulary {V}")
        rb = r_bucket or self.cfg.max_rows
        if rb < int(self.n_rows.max(initial=0)):
            raise ValueError(f"r_bucket {rb} < max n_rows {int(self.n_rows.max())}")
        # index tables are the biggest per-resource lanes: use the
        # narrowest uint that addresses the padded vocabulary
        idx_t = np.uint8 if vb <= 0xFF else np.uint16 if vb <= 0xFFFF else np.int32
        sid_t = np.uint8 if (s_bucket or len(self.strs)) <= 0xFF else np.uint16 \
            if (s_bucket or len(self.strs)) <= 0xFFFF else np.int32
        out: Dict[str, np.ndarray] = {"row_idx": self.row_idx[:, :rb].astype(idx_t),
                                      "pool_sidx": self.pool_sidx.astype(sid_t),
                                      "n_rows": self.n_rows,
                                      "fallback": self.fallback}
        for name, arr in self.lanes.items():
            if vb > V:
                pad = np.zeros((vb - V,), dtype=arr.dtype)
                if name in ("scope1", "scope2", "byte_slot", "key_byte_slot"):
                    pad -= 1  # these lanes default to -1
                arr = np.concatenate([arr, pad])
            out["vocab_" + name] = arr
        S = len(self.strs)
        sb = s_bucket or S
        if sb < S:
            raise ValueError(f"s_bucket {sb} < string table {S}")
        w = self.cfg.byte_pool_width
        svocab = np.zeros((sb, w), dtype=np.uint8)
        slen = np.zeros((sb,), dtype=np.int32)
        for sid, data in enumerate(self.strs):
            svocab[sid, : len(data)] = np.frombuffer(data, dtype=np.uint8)
            slen[sid] = len(data)
        out["pool_svocab"] = svocab
        out["pool_slen"] = slen
        if meta is not None:
            for k, v in meta.arrays().items():
                out["meta_" + k] = v
        return out


class _CfgShell:
    """Stands in for RowBatch during a vocab encode — the walk only
    touches ``.cfg``; dense lane allocation is skipped entirely."""

    def __init__(self, cfg: EncodeConfig):
        self.cfg = cfg


# vocab-row tuple order emitted by the native encoder (fastencode.c
# row_tuple) — _ROW_LANES minus the implicit "valid"
_VOCAB_TUPLE_ORDER = tuple(n for n in _ROW_LANES if n != "valid")


# the native encoder's memo tables are process-global and mutated
# without locks; the GIL can switch threads inside the scalar callback,
# so concurrent admission-server threads must serialize native encodes
# (encode is GIL-bound CPU work anyway — serialization costs nothing)
_NATIVE_LOCK = __import__("threading").Lock()


def _encode_vocab_native(native, resources, cfg, byte_paths, key_byte_paths) -> VocabBatch:
    vb = VocabBatch(len(resources), cfg)
    bp = np.array(sorted(set(byte_paths or ())), dtype=np.uint64)
    kbp = np.array(sorted(set(key_byte_paths or ())), dtype=np.uint64)
    with _NATIVE_LOCK:
        vrows, pool_strs = native.encode_vocab(
            list(resources), cfg.max_rows, cfg.max_instances,
            cfg.byte_pool_slots, cfg.byte_pool_width, bp, kbp, _scalar_rec,
            vb.row_idx, vb.n_rows, vb.fallback, vb.pool_sidx)
    V = len(vrows) + 1
    lanes = {name: np.zeros((V,), dtype=_ROW_LANE_DTYPES[name]) for name in _ROW_LANES}
    for l in ("scope1", "scope2", "byte_slot", "key_byte_slot"):
        lanes[l][0] = -1
    if vrows:
        cols = tuple(zip(*vrows))
        for idx, name in enumerate(_VOCAB_TUPLE_ORDER):
            lanes[name][1:] = np.asarray(cols[idx], dtype=_ROW_LANE_DTYPES[name])
        lanes["valid"][1:] = 1
    vb.lanes = lanes
    vb.strs = list(pool_strs)
    return vb


def encode_resources_vocab(
    resources: Sequence[Dict[str, Any]],
    cfg: Optional[EncodeConfig] = None,
    byte_paths: Optional[Iterable[int]] = None,
    key_byte_paths: Optional[Iterable[int]] = None,
) -> VocabBatch:
    """Vocabulary-form twin of encode_resources (same walk, same
    semantics — parity-tested against it lane by lane). Uses the
    native C walk when the extension builds; Python otherwise."""
    cfg = cfg or EncodeConfig()
    _count_json_walks(resources)
    from ..native import load as _load_native

    native = _load_native()
    if native is not None:
        res = resources if isinstance(resources, list) else list(resources)
        return _encode_vocab_native(native, res, cfg, byte_paths, key_byte_paths)
    enc = _FastEncoder(_CfgShell(cfg), set(byte_paths or ()), set(key_byte_paths or ()))
    vb = VocabBatch(len(resources), cfg)
    for i, res in enumerate(resources):
        enc.begin(i)
        enc.walk(res, _ROOT_REC, 0, 0, -1, -1, 0)
        vb.n_rows[i] = enc.row
        vb.fallback[i] = 0 if enc.ok else 1
    _finish_vocab(enc, vb)
    return vb


# node-record fields carried as floats: for the vectorized dedup they
# key by their float64 BIT PATTERN (via .view), which is exact — equal
# bits <=> identical lane bytes, and the records already distinguish
# 0.0 from -0.0 through their repr hashes
_NODE_FLOAT_FIELDS = frozenset({"arr_len", "num_val", "qty_val", "dur_val"})

_PATH_FIELDS = ("norm_hi", "norm_lo", "parent_hi", "parent_lo",
                "key_hi", "key_lo", "key_glob")

# the canonical packed-int64 row-matrix column order used for the
# exact vocabulary dedup: (lane name, packs-as-float64-bits). Shared by
# _finish_vocab and the columnar store's gather assembly
# (cluster/columnar.py) so the two vocabulary forms cannot drift.
VOCAB_MATRIX_FIELDS: Tuple[Tuple[str, bool], ...] = tuple(
    [(n, False) for n in _PATH_FIELDS]
    + [(n, n in _NODE_FLOAT_FIELDS) for n in _NODE_FIELDS]
    + [("scope1", False), ("scope2", False), ("s2_overflow", False),
       ("byte_slot", False), ("key_byte_slot", False)])


def vocab_lanes_from_unique(uniq: np.ndarray) -> Dict[str, np.ndarray]:
    """Vocabulary lane arrays from a deduped row matrix in
    ``VOCAB_MATRIX_FIELDS`` column order (row id 0 is the reserved
    all-zero padding row)."""
    V = uniq.shape[0] + 1
    lanes = {name: np.zeros((V,), dtype=_ROW_LANE_DTYPES[name])
             for name in _ROW_LANES}
    for l in ("scope1", "scope2", "byte_slot", "key_byte_slot"):
        lanes[l][0] = -1
    for k, (name, is_float) in enumerate(VOCAB_MATRIX_FIELDS):
        col = uniq[:, k]
        if is_float:
            lanes[name][1:] = col.view(np.float64).astype(
                _ROW_LANE_DTYPES[name])
        else:
            lanes[name][1:] = col.astype(_ROW_LANE_DTYPES[name])
    lanes["valid"][1:] = 1
    return lanes


def _finish_vocab(enc: _FastEncoder, vb: VocabBatch) -> None:
    """Columnar vocabulary assembly: one zip-transpose per record
    family, one ``np.unique(axis=0)`` over the packed int64 row matrix
    for the dedup, one scatter per lane — no per-row Python tuple
    construction or dict probes (the former inner loop was the
    per-worker encode hot spot; the dedup is exact, it just orders the
    vocabulary lexicographically instead of by first appearance, which
    the device gather never observes)."""
    nflat = len(enc.flat)
    lanes = {name: np.zeros((1,), dtype=_ROW_LANE_DTYPES[name])
             for name in _ROW_LANES}
    for l in ("scope1", "scope2", "byte_slot", "key_byte_slot"):
        lanes[l][0] = -1
    if nflat:
        flat_arr = np.asarray(enc.flat, dtype=np.int64)
        # columns in VOCAB_MATRIX_FIELDS order (the shared dedup layout)
        cols: List[np.ndarray] = []
        pcols = tuple(zip(*enc.paths))
        for k, name in enumerate(_PATH_FIELDS):
            cols.append(np.asarray(pcols[k], dtype=np.int64))
        ncols = tuple(zip(*enc.nodes))
        for k, name in enumerate(_NODE_FIELDS):
            if name in _NODE_FLOAT_FIELDS:
                cols.append(np.asarray(ncols[k],
                                       dtype=np.float64).view(np.int64))
            else:
                cols.append(np.asarray(ncols[k], dtype=np.int64))
        for data in (enc.scope1, enc.scope2, enc.s2_over):
            cols.append(np.asarray(data, dtype=np.int64))
        # byte-slot assignments arrive as sparse (flat idx, slot) pairs;
        # enc.flat ascends strictly, so searchsorted maps them back
        for pairs in (enc.byte_slots, enc.key_byte_slots):
            arr = np.full((nflat,), -1, dtype=np.int64)
            if pairs:
                idxs, slots = zip(*pairs)
                arr[np.searchsorted(flat_arr,
                                    np.asarray(idxs, dtype=np.int64))] = slots
            cols.append(arr)
        matrix = np.stack(cols, axis=1)
        uniq, inverse = np.unique(matrix, axis=0, return_inverse=True)
        vb.row_idx.ravel()[flat_arr] = \
            (inverse.reshape(-1) + 1).astype(np.int32)
        lanes = vocab_lanes_from_unique(uniq)
    vb.lanes = lanes

    sids: Dict[bytes, int] = {b"": 0}
    for (i, slot, data) in enc.pool_strs:
        sid = sids.get(data)
        if sid is None:
            sid = len(vb.strs)
            sids[data] = sid
            vb.strs.append(data)
        vb.pool_sidx[i, slot] = sid


# ---------------------------------------------------------------------------
# Segment-level encoding — the incremental watch-diff unit.
#
# A resource's rows are emitted in one DFS pass, so each top-level key's
# subtree occupies a CONTIGUOUS row range whose lane values depend only
# on the subtree itself (path hashes continue from the root FNV state,
# scopes/depth reset at the top level). The two pieces of whole-resource
# state — the row budget and the byte-pool slot counter — are both
# strictly sequential in walk order, so a watch diff can re-encode only
# the CHANGED top-level subtrees and splice the untouched segments back
# from the columnar store (cluster/columnar.py), replaying the pool
# counter across the composed sequence. compose_segments reproduces the
# full walk's truncation and pool-overflow ladders exactly, so a diffed
# re-encode is bit-identical to a fresh encode of the same object.


class Segment:
    """Encoded rows of one top-level subtree: trimmed lane arrays (the
    byte-slot lanes are derived at compose time), the pool-assignment
    list in walk order as (row_rel, lane, utf8 bytes), and the
    subtree's own cap-overflow flag."""

    __slots__ = ("key", "lanes", "assigns", "n", "ok")

    def __init__(self, key: str, lanes: Dict[str, np.ndarray],
                 assigns: List[Tuple[int, str, bytes]], n: int, ok: bool):
        self.key = key
        self.lanes = lanes
        self.assigns = assigns
        self.n = n
        self.ok = ok


# lanes a Segment carries directly; byte_slot/key_byte_slot are
# replayed from ``assigns`` and ``valid`` is constant 1
SEGMENT_LANES = tuple(n for n in _ROW_LANES
                      if n not in ("byte_slot", "key_byte_slot", "valid"))


def _segment_from_encoder(key: str, enc: _FastEncoder) -> Segment:
    n = len(enc.flat)
    lanes: Dict[str, np.ndarray] = {}
    if n:
        pcols = tuple(zip(*enc.paths))
        for k, name in enumerate(_PATH_FIELDS):
            lanes[name] = np.asarray(pcols[k], dtype=_ROW_LANE_DTYPES[name])
        ncols = tuple(zip(*enc.nodes))
        for k, name in enumerate(_NODE_FIELDS):
            lanes[name] = np.asarray(ncols[k], dtype=_ROW_LANE_DTYPES[name])
        lanes["scope1"] = np.asarray(enc.scope1, dtype=np.int32)
        lanes["scope2"] = np.asarray(enc.scope2, dtype=np.int32)
        lanes["s2_overflow"] = np.asarray(enc.s2_over, dtype=np.uint8)
    else:
        lanes = {name: np.zeros((0,), dtype=_ROW_LANE_DTYPES[name])
                 for name in SEGMENT_LANES}
    # pool assignments in walk order: each successful _assign_pool
    # appended one pool_strs row AND one (flat, slot) pair, slot-major
    by_slot: Dict[int, Tuple[int, str]] = {}
    for (fi, slot) in enc.byte_slots:
        by_slot[slot] = (fi, "byte_slot")
    for (fi, slot) in enc.key_byte_slots:
        by_slot[slot] = (fi, "key_byte_slot")
    assigns: List[Tuple[int, str, bytes]] = []
    for (_, slot, data) in enc.pool_strs:
        fi, lane = by_slot[slot]
        assigns.append((fi, lane, data))
    return Segment(key, lanes, assigns, n, enc.ok)


def encode_segment(key: Any, value: Any, cfg: EncodeConfig,
                   byte_paths: Optional[Iterable[int]] = None,
                   key_byte_paths: Optional[Iterable[int]] = None) -> Segment:
    """Encode ONE top-level subtree (``resource[key]``) — the partial
    walk of the incremental watch-diff path. Counts on
    ``kyverno_tpu_encode_diff_segments_total``, never on the full-walk
    counter."""
    enc = _FastEncoder(_CfgShell(cfg), set(byte_paths or ()),
                       set(key_byte_paths or ()))
    enc.begin(0)
    ks = key if type(key) is str else str(key)
    crec = _PATH_MEMO.child(_FNV_ROOT_STATE, ks)
    hi, lo = split32(ROOT_HASH)
    enc.walk(value, crec, hi, lo, -1, -1, 0)
    try:
        from ..observability.metrics import global_registry

        global_registry.encode_diff_segments.inc()
    except Exception:
        pass
    return _segment_from_encoder(ks, enc)


def root_row_lanes(n_keys: int) -> Dict[str, Any]:
    """Lane values of the resource's root map row (row 0 of every
    encoded resource): recomputed at compose time from the new object's
    key count."""
    hi, lo = split32(ROOT_HASH)
    out: Dict[str, Any] = {name: 0 for name in _ROW_LANES}
    out.update(norm_hi=hi, norm_lo=lo, type_tag=T_MAP,
               arr_len=float(n_keys), scope1=-1, scope2=-1,
               byte_slot=-1, key_byte_slot=-1, valid=1)
    return out


def compose_segments(n_keys: int, segments: Sequence[Segment],
                     cfg: EncodeConfig):
    """Compose per-top-level-key segments (in the object's key order)
    into one resource's trimmed row entry. Reproduces the full walk's
    whole-resource ladders: rows clip at ``max_rows`` in DFS order, and
    the byte pool replays as one sequential counter — an assignment to
    a clipped row never happened, an assignment past the slot cap fails
    without consuming a slot, and either overflow flags fallback.

    Returns ``(lanes, pool, pool_len, n_rows, fallback, placed)`` with
    ``placed = [(segment, row_off, rows_kept)]`` for the diff index."""
    max_rows = cfg.max_rows
    ok = True
    placed: List[Tuple[Segment, int, int]] = []
    off = 1  # the root row
    for seg in segments:
        kept = max(0, min(seg.n, max_rows - off))
        if kept < seg.n or not seg.ok:
            ok = False
        placed.append((seg, off, kept))
        off += kept
    total = off
    lanes = {name: np.zeros((total,), dtype=_ROW_LANE_DTYPES[name])
             for name in _ROW_LANES}
    for l in ("scope1", "scope2", "byte_slot", "key_byte_slot"):
        lanes[l][:] = -1
    lanes["valid"][:] = 1
    root = root_row_lanes(n_keys)
    for name in _ROW_LANES:
        lanes[name][0] = root[name]
    for seg, so, kept in placed:
        if not kept:
            continue
        for name in SEGMENT_LANES:
            lanes[name][so:so + kept] = seg.lanes[name][:kept]
    pool_rows: List[bytes] = []
    for seg, so, kept in placed:
        for (row_rel, lane, data) in seg.assigns:
            if row_rel >= kept:
                continue  # row never emitted in the full walk
            if len(pool_rows) >= cfg.byte_pool_slots:
                ok = False
                continue  # slots exhausted: fails, consumes nothing
            lanes[lane][so + row_rel] = len(pool_rows)
            pool_rows.append(data)
    # canonical trimmed form (cache.extract_rows): drop trailing
    # zero-length slots — dangling byte_slot refs past the pool write
    # nothing when applied, exactly like the LRU entries
    s = len(pool_rows)
    while s and not pool_rows[s - 1]:
        s -= 1
    pool = pool_len = None
    if s:
        pool = np.zeros((s, cfg.byte_pool_width), dtype=np.uint8)
        pool_len = np.zeros((s,), dtype=np.int32)
        for i, data in enumerate(pool_rows[:s]):
            pool[i, : len(data)] = np.frombuffer(data, dtype=np.uint8)
            pool_len[i] = len(data)
    return lanes, pool, pool_len, total, (0 if ok else 1), placed
