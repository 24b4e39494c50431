"""IR -> PyTorch batch program (the port of kyverno_tpu/tpu/evaluator.py).

The policy set compiles into ONE function evaluating every device rule
against every resource in a batch:

    fn(batch: dict[str, torch.Tensor]) -> ((num_rules, N) int32 verdicts,
                                           (num_rules, 7) int32 counts)

The rule-by-rule walk over the IR happens in Python, as the reference
unrolls it at trace time, and every step is a PyTorch tensor operation
on the batch's device. These pieces are kernels (``kernels.py``):

- the DFA bank scan (K1) behind ``dfa.bank_match`` / ``nonascii_mask``;
- per-instance counts (K3) behind ``InstScope`` and ``Inst2Scope`` —
  integer counts where the reference takes f32 one-hot einsums; sums
  below 2**24 are exact in f32, so ``> 0`` and ``==`` on the integers
  give the reference's booleans. ``Ctx.inst_counts`` counts each keyed
  row mask once a batch (XLA's CSE merges the reference's identical
  einsums) and issues the rest of a node's counts together;
- the verdict-class histogram (K4) of ``build_program``, with the
  uint8 table of the background scan's step;
- the vocabulary gathers (K5) behind ``LaneView``;
- the hash-equality row masks (K6) behind ``Ctx.heq/hset/_mask``;
- the pool-slot row gather (K7) behind ``Ctx._rows_from_pool``;
- the first-true-row take (K8) of ``_eval_wildcard_anchor``;
- the glob NFA (K9) of the globs outside the bank, one launch per pack
  of a lane family's NFA-route globs (``NfaPacks``);
- the any-of over a match filter's ``names`` / ``namespaces`` (K10,
  ``Ctx.meta_any``): one launch per filter list and batch reads the
  entries' bank columns, pack rows and hash equalities in place;
- each rule's class logic (K11, ``tpu/fold.py``): while ``eval_rule``
  walks a rule, the per-node classes and flags ((N,), (N, I) and
  (N, I, J) values: ``where`` chains, class compares, ANDs and ORs of
  reductions, first-non-pass folds) are handles on the rule's tape
  (``Ctx.fold``), not tensors; the row-plane predicates, the
  reductions of row planes and the kernels above still run as they are
  reached, and their (N,) / (N, I) / (N, I, J) results join the tape as
  inputs. The rule's tape then runs as one K11 launch that writes its
  row of the verdict table.

The program has no data-dependent Python branch (no ``.item()``,
``bool(tensor)`` or ``.any()`` in control flow): one eager run reads
every lane that any run would, which ``LaneView(record=True)`` relies
on.

``plain=True`` runs the kernels' plain PyTorch twins whatever the
device (the reference program ``chip_smoke.py`` compares against).

Hash lanes (``*_hi``/``*_lo``, uint32 in the encoded batch) arrive as
int32 bit patterns (see ``engine.lanes_to_device``): every hash compare
is an equality, so constants are folded to the same int32 patterns by
``_i32``. Float compares use float32 constants, as the reference does.

Verdict codes: 0 PASS, 1 SKIP, 2 FAIL, 3 NOT_MATCHED, 4 ERROR,
5 HOST (resource exceeded encode caps -> host fallback), 6 CONFIRM
(a pattern evaluated through an over-approximating DFA — or over bytes
whose codepoint semantics can differ — hit this cell: the device
verdict is a maybe, the scalar oracle confirms it; see tpu/dfa.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..engine import pattern as patternpkg
from ..engine.operator import Operator
from ..utils.duration import parse_duration
from ..utils.quantity import parse_quantity
from . import fold
from .dfa import DfaBank, bank_match, nonascii_mask
from .flatten import T_ARR, T_BOOL, T_MAP, T_NULL, T_NUM, T_STR, RowBatch, go_sprint
from .hashing import (
    ARRAY_SEG,
    canon_duration,
    canon_number,
    canon_quantity,
    hash_path,
    hash_str,
    split32,
)
from .ir import (
    ArrayMapsNode,
    ArrayScalarNode,
    BoolLeaf,
    CelAnd,
    CelConst,
    CelHas,
    CelMatches,
    CelNot,
    CelOr,
    CelStrCmp,
    CondIR,
    CondTreeIR,
    Cmp,
    ElementCollect,
    ExistenceNode,
    FilterIR,
    LeafNode,
    LiteralKey,
    MapNode,
    MatchIR,
    Node,
    NullLeaf,
    NumLeaf,
    DynKey,
    DynValueRef,
    OpKey,
    UserInfoKey,
    PathCollect,
    PathState,
    RuleProgram,
    StrLeaf,
    Unsupported,
)
from .metadata import MetaBatch, OP_CODES

PASS, SKIP, FAIL, NOT_MATCHED, ERROR, HOST, CONFIRM = 0, 1, 2, 3, 4, 5, 6
NUM_VERDICT_CLASSES = kernels.NUM_VERDICT_CLASSES


def _i32(v: int) -> int:
    """A uint32 constant as the int32 bit pattern of the hash lanes."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _f32(v) -> float:
    """A constant rounded to float32, as the reference compares."""
    return float(np.float32(v))


# ---------------------------------------------------------------------------
# batch assembly


def batch_to_host(rows: RowBatch, meta: MetaBatch) -> Dict[str, Any]:
    """Assemble the flat lane dict on host (numpy views, no copy)."""
    out = dict(rows.arrays())
    for k, v in meta.arrays().items():
        out["meta_" + k] = v
    return out


class LaneView:
    """Lazy dense view over a vocabulary batch (flatten.VocabBatch
    .to_host on the device) — kyverno_tpu/tpu/evaluator.py:LaneView.
    A dense (n, Rb) row lane is ``vocab_<lane>[row_idx]``, ``pool`` is
    ``pool_svocab[pool_sidx]`` and ``pool_len`` is
    ``pool_slen[pool_sidx]``, all with jnp.take's index rule (kernel K5
    and its plain twin).

    Lanes are gathered on first access. With ``record`` the view notes
    every batch key it reads (``used_keys``), one lane at a time, so a
    recording run learns which lanes a program reads and callers can
    PRUNE the rest from the host dict before transfer. Without
    ``record`` the first row-lane access gathers every vocabulary lane
    the (pruned) batch holds in ONE K5 launch; the pool rows and their
    lengths come together in one launch too. The lanes are the same
    either way.

    A vocabulary lane absent from the (pruned) batch densifies to
    zeros — sound only because pruning is driven by a recording run of
    the same program, which by construction never reads them."""

    def __init__(self, batch: Dict[str, torch.Tensor], record: bool = False,
                 plain: bool = False):
        from .flatten import _ROW_LANE_DTYPES, _ROW_LANES

        self._b = batch
        self._cache: Dict[str, torch.Tensor] = {}
        self._row_lanes = tuple(_ROW_LANES)
        self._row_set = set(_ROW_LANES)
        self._dtypes = _ROW_LANE_DTYPES
        self._plain = plain
        self.used_keys: Optional[set] = set() if record else None
        self._shape = tuple(batch["row_idx"].shape)  # (n, Rb)
        self.device = batch["row_idx"].device

    def _note(self, *keys: str) -> None:
        if self.used_keys is not None:
            self.used_keys.update(keys)

    def _fill(self, name: str) -> int:
        return kernels.TAKE_FILL[np.dtype(self._dtypes[name])]

    def _gather_lanes(self, names: Sequence[str]) -> None:
        b = self._b
        srcs = [b["vocab_" + n] for n in names]
        fills = [self._fill(n) for n in names]
        if self._plain:
            outs = [kernels.vocab_gather_plain(t, b["row_idx"], f)
                    for t, f in zip(srcs, fills)]
        else:
            outs = kernels.vocab_gather(srcs, b["row_idx"], fills)
        self._cache.update(zip(names, outs))

    def _gather_pool(self, names: Sequence[str]) -> None:
        b = self._b
        fn = kernels.vocab_gather_rows_plain if self._plain \
            else kernels.vocab_gather_rows
        rows, lens = fn(b["pool_svocab"] if "pool" in names else None,
                        b["pool_slen"] if "pool_len" in names else None,
                        b["pool_sidx"])
        if rows is not None:
            self._cache["pool"] = rows
        if lens is not None:
            self._cache["pool_len"] = lens

    def _zeros(self, name: str) -> torch.Tensor:
        dt = np.dtype(self._dtypes[name])
        tdt = {np.dtype(np.uint8): torch.uint8,
               np.dtype(np.uint32): torch.int32,  # hash lanes: int32 bits
               np.dtype(np.int32): torch.int32,
               np.dtype(np.float32): torch.float32}[dt]
        return torch.zeros(self._shape, dtype=tdt, device=self.device)

    def __getitem__(self, name: str) -> torch.Tensor:
        out = self._cache.get(name)
        if out is not None:
            return out
        b = self._b
        if name in self._row_set:
            vkey = "vocab_" + name
            self._note("row_idx", vkey)
            if vkey not in b:
                out = self._zeros(name)
            else:
                # recording: this lane alone; else every lane held
                self._gather_lanes([name] if self.used_keys is not None
                                   else [n for n in self._row_lanes
                                         if "vocab_" + n in b
                                         and n not in self._cache])
                return self._cache[name]
        elif name in ("pool", "pool_len"):
            src = "pool_svocab" if name == "pool" else "pool_slen"
            self._note("pool_sidx", src)
            if src not in b:
                raise KeyError(src)
            # recording: this lane alone; else the rows and lengths held
            self._gather_pool([name] if self.used_keys is not None
                              else [n for n, k in (("pool", "pool_svocab"),
                                                   ("pool_len", "pool_slen"))
                                    if k in b])
            return self._cache[name]
        else:  # meta_*, n_rows, fallback — pass through
            self._note(name)
            out = b[name]
        self._cache[name] = out
        return out


def densify(batch: Dict[str, torch.Tensor], record: bool = False,
            plain: bool = False):
    """Dense batches pass through; vocabulary batches wrap in a lazy
    LaneView (gather-on-access, see LaneView)."""
    if "row_idx" not in batch:
        return batch
    return LaneView(batch, record=record, plain=plain)


# ---------------------------------------------------------------------------
# evaluation context with memoization


# a Ctx's counters, which a program adds up over its runs: one-level
# (inst) and two-level (inst2) count requests, memo hits and kernel
# calls issued, NFA-route globs outside the program's packs (each ran as
# a pack of one), and tape values a torch operation outside the tape
# made materialize (``fold.Tape.force``)
STAT_KEYS = ("inst_calls", "inst_hits", "inst_issued", "inst2_calls",
             "inst2_hits", "inst2_issued", "nfa_unpacked", "fold_forced")


def _usable_bank(dfa: Optional[DfaBank]) -> Optional[DfaBank]:
    return dfa if (dfa is not None and dfa.trans is not None
                   and len(dfa)) else None


def bank_columns(dfa: Optional[DfaBank]) -> Dict[str, Dict[int, int]]:
    """Each lane family's column in its ``bank_match`` accept plane, by
    pattern id."""
    bank = _usable_bank(dfa)
    if bank is None:
        return {}
    return {family: {pid: col for col, pid in enumerate(ids)}
            for family, ids in bank.families.items()}


class NfaPacks:
    """The K9 packs of a program's NFA-route globs: per lane family, one
    ``kernels.GlobPack`` per state-word count, and (family, pattern) ->
    (pack, row). A glob too long for the kernel stays out (its pack of
    one raises unless it cannot match at all)."""

    def __init__(self, globs: Dict[str, List[str]]):
        self.packs: Dict[str, List[kernels.GlobPack]] = {}
        self.index: Dict[Tuple[str, str], Tuple[int, int]] = {}
        for family, patterns in globs.items():
            packs = kernels.glob_packs([
                p for p in patterns
                if kernels.glob_words(p) <= kernels.GLOB_MAX_WORDS])
            self.packs[family] = packs
            for g, pack in enumerate(packs):
                for row, p in enumerate(pack.patterns):
                    self.index[(family, p)] = (g, row)


class Ctx:
    def __init__(self, batch: Dict[str, torch.Tensor], max_instances: int,
                 dfa: Optional[DfaBank] = None, plain: bool = False,
                 hash_consts: Optional[Dict[Any, torch.Tensor]] = None,
                 nfa: Optional[NfaPacks] = None,
                 bank_cols: Optional[Dict[str, Dict[int, int]]] = None,
                 meta_tables: Optional[Dict[Any, Any]] = None):
        self.b = batch
        self.I = max_instances
        self.plain = plain
        self.dfa = _usable_bank(dfa)
        n, r = batch["norm_hi"].shape
        self.N, self.R = n, r
        self.dev = batch["norm_hi"].device
        self._row_masks: Dict[Tuple[int, str], torch.Tensor] = {}
        # K6 constant tables by (device, pairs), which build_program
        # keeps for the life of the compiled program, as it keeps each
        # family's bank column by pattern id and the K9 packs of its
        # NFA-route globs
        self._hash_consts = {} if hash_consts is None else hash_consts
        self._bank_cols = bank_columns(self.dfa) if bank_cols is None \
            else bank_cols
        self._nfa = nfa if nfa is not None else NfaPacks({})
        # K10's entry tables by filter list (kept with the program)
        self._meta_tables = {} if meta_tables is None else meta_tables
        self._glob_cache: Dict[Tuple[str, str], Any] = {}
        self._valid = batch["valid"] != 0
        self._types: Dict[Tuple[int, bool], torch.Tensor] = {}
        # the count memo: keys of the row predicates it recognises (by
        # the id of a tensor this Ctx keeps alive), typed masks, and
        # the counts / anys by (level, predicate key, want)
        self._pred_keys: Dict[int, Tuple] = {}
        self._typed: Dict[Tuple, torch.Tensor] = {}
        self._counts: Dict[Tuple, torch.Tensor] = {}
        self._scope8: Optional[torch.Tensor] = None
        self.stats: Dict[str, int] = dict.fromkeys(STAT_KEYS, 0)
        # per-rule host-fallback masks appended during evaluation
        # (nested instance-join overflow); eval_rule drains them
        self.host_acc: List[torch.Tensor] = []
        # per-rule oracle-confirmation masks (approximate-DFA hits,
        # non-ASCII subjects under byte-sensitive patterns)
        self.confirm_acc: List[torch.Tensor] = []
        # the tape of the rule being evaluated (build_program sets it)
        self.fold: Optional[fold.Tape] = None

    def _on_tape(self, shape) -> bool:
        shape = tuple(shape)
        return self.fold is not None and shape != (self.N, self.R) \
            and shape in ((self.N,), (self.N, self.I),
                          (self.N, self.I, self.I))

    def full(self, shape, value):
        """A constant of ``shape``: on the rule's tape for a class
        shape, else a tensor (bool for a bool value, else int32)."""
        if self._on_tape(shape):
            return self.fold.const(value, shape)
        dt = torch.bool if isinstance(value, bool) else torch.int32
        return torch.full(tuple(shape), value, dtype=dt, device=self.dev)

    def false(self, shape):
        return self.full(shape, False)

    def true(self, shape):
        return self.full(shape, True)

    def lift(self, t: torch.Tensor):
        """A class-shaped tensor as an input of the rule's tape (itself
        when no rule is being recorded)."""
        return t if self.fold is None else self.fold.input(t)

    def row_any(self, plane: torch.Tensor):
        """Any over a (N, R) row plane's rows, on the tape as an input."""
        return self.lift(plane.any(dim=-1))

    # -- row masks

    def rows_at(self, path: Tuple[str, ...]) -> torch.Tensor:
        return self._mask(hash_path(path), "norm")

    def rows_with_parent(self, path: Tuple[str, ...]) -> torch.Tensor:
        return self._mask(hash_path(path), "parent")

    def _mask(self, h: int, lane: str) -> torch.Tensor:
        key = (h, lane)
        if key not in self._row_masks:
            m = self._row_masks[key] = self._hash_match(lane, (h,),
                                                        self._valid)
            self._pred_keys[id(m)] = key
        return self._row_masks[key]

    def heq(self, lane: str, h: int) -> torch.Tensor:
        return self._hash_match(lane, (h,))

    def hset(self, lane: str, hashes: Sequence[int]) -> torch.Tensor:
        return self._hash_match(lane, hashes)

    def _hash_match(self, lane: str, hashes: Sequence[int],
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """OR over ``hashes`` of the 64-bit equality on the lane's
        hi/lo pair, AND ``valid`` (kernel K6; the empty set is all
        false)."""
        pairs = tuple((_i32(hi), _i32(lo)) for hi, lo in map(split32, hashes))
        key = (str(self.dev), pairs)
        consts = self._hash_consts.get(key)
        if consts is None:
            consts = self._hash_consts[key] = kernels.hash_consts(pairs,
                                                                  self.dev)
        fn = kernels.hash_match_plain if self.plain else kernels.hash_match
        return fn(self.b[lane + "_hi"], self.b[lane + "_lo"], consts, valid)

    def type_is(self, t: int, neg: bool = False) -> torch.Tensor:
        key = (t, neg)
        if key not in self._types:
            eq = self.b["type_tag"] == t
            self._types[key] = ~eq if neg else eq
        return self._types[key]

    def typed(self, mask: torch.Tensor, t: int,
              neg: bool = False) -> torch.Tensor:
        """``mask & type_is(t)`` (``& ~type_is(t)`` with ``neg``). For a
        row mask of ``rows_at`` / ``rows_with_parent`` it is made once
        and keyed, so the count memo recognises it."""
        key = self._pred_keys.get(id(mask))
        if key is None:
            return mask & self.type_is(t, neg)
        key = key + (t, neg)
        out = self._typed.get(key)
        if out is None:
            out = self._typed[key] = mask & self.type_is(t, neg)
            self._pred_keys[id(out)] = key
        return out

    # -- per-instance counts (kernel K3), memoized as the reference's
    # identical einsums are merged by XLA

    def scope8(self) -> torch.Tensor:
        """The batch's compact one-level scope (kernels.scope8)."""
        if self._scope8 is None:
            self._scope8 = kernels.scope8(self.b["scope1"], self._valid,
                                          self.I)
        return self._scope8

    def _row_operand(self, rowpred: torch.Tensor) -> torch.Tensor:
        """(N, R) view of a row predicate: a (1, R) broadcast keeps row
        stride 0 (no copy); only a predicate whose rows are not
        contiguous is copied."""
        p = rowpred.expand(self.N, self.R)
        if self.R > 1 and p.stride(1) != 1:
            p = p.contiguous()
        return p

    def inst_counts(self, level: int,
                    items: Sequence[Tuple[torch.Tensor, str]]
                    ) -> List[torch.Tensor]:
        """Per-instance counts ("count": (N, I) int32) or their "any"
        ((N, I) bool) of row predicates, at scope ``level`` 1 (by scope1)
        or 2 ((N, I, I), by scope1 and scope2). A predicate the memo
        knows is counted once a batch (an "any" reuses its count); the
        rest go to K3 together, up to 8 a launch at level 1."""
        tag = "inst" if level == 1 else "inst2"
        out: List[Optional[torch.Tensor]] = [None] * len(items)
        # memo key (the item's index when its predicate has none) ->
        # the items asking for it
        todo: Dict[Any, List[int]] = {}
        for i, (pred, want) in enumerate(items):
            self.stats[tag + "_calls"] += 1
            pk = self._pred_keys.get(id(pred))
            if pk is not None:
                key = (level, pk, want)
                got = self._counts.get(key)
                if got is None and want == "any":
                    got = self._counts.get((level, pk, "count"))
                    if got is not None:
                        got = self._counts[key] = got > 0
                if got is not None:
                    self.stats[tag + "_hits"] += 1
                    out[i] = got
                    continue
            else:
                key = i
            todo.setdefault(key, []).append(i)
        keys = list(todo)
        step = kernels.COUNT_MAX_PREDS if level == 1 else 1
        for c in range(0, len(keys), step):
            chunk = keys[c:c + step]
            first = [items[todo[k][0]] for k in chunk]
            self.stats[tag + "_issued"] += 1
            if level == 1:
                fn = kernels.instance_count_many_plain if self.plain \
                    else kernels.instance_count_many
                got = fn([self._row_operand(p) for p, _ in first],
                         self.scope8(), self.I, [w for _, w in first])
            else:
                got = [self._count2(p, w) for p, w in first]
            for k, g in zip(chunk, got):
                if isinstance(k, tuple):
                    self._counts[k] = g
                for i in todo[k]:
                    out[i] = g
        return out

    def _count2(self, rowpred: torch.Tensor, want: str) -> torch.Tensor:
        pred = rowpred.expand(self.N, self.R).contiguous()
        s1, s2 = self.b["scope1"], self.b["scope2"]
        if self.plain:
            c = kernels.instance_count_plain(pred, s1, self._valid, self.I, s2)
        else:
            c = kernels.instance_count2(pred, s1, s2, self._valid, self.I)
        return c > 0 if want == "any" else c

    # -- pattern matching over byte lanes. Every pattern of a lane
    # family is stepped through the compiled DFA bank (tpu/dfa.py) in
    # ONE shared scan; a glob the bank had no room for runs on the
    # legacy per-pattern NFA (the reference's glob_match, kernel K9).

    _FAMILY_LANES = {
        "pool": ("pool", "pool_len"),
        "name": ("meta_name_bytes", "meta_name_len"),
        "ns": ("meta_ns_bytes", "meta_ns_len"),
        "user": ("meta_user_bytes", "meta_user_len"),
        "labels_kb": ("meta_labels_kb", "meta_labels_kb_len"),
        "labels_vb": ("meta_labels_vb", "meta_labels_vb_len"),
    }

    def _family_tensors(self, family: str):
        byte_lane, len_lane = self._FAMILY_LANES[family]
        return self.b[byte_lane], self.b[len_lane]

    def _bank_lookup(self, kind: str, pattern: str, family: str):
        """(accept plane, Dfa) for one bank pattern on one lane family
        — the family's FULL accept tensor is computed once and cached,
        so N patterns on a family cost one scan, not N. None when the
        pattern is not in the bank for that family (a glob then takes
        the NFA)."""
        bank = self.dfa
        if bank is None:
            return None
        pid = (bank.glob_ids if kind == "glob" else bank.re2_ids).get(pattern)
        col = self._bank_cols.get(family, {}).get(pid)
        if col is None:
            return None
        return self._bank_plane(family)[..., col], bank.patterns[pid]

    def _bank_plane(self, family: str) -> torch.Tensor:
        key = ("\x00bank", family)
        if key not in self._glob_cache:
            byt, lens = self._family_tensors(family)
            self._glob_cache[key] = bank_match(
                self.dfa, self.dfa.families[family], byt, lens,
                plain=self.plain)
        return self._glob_cache[key]

    def _family_nonascii(self, family: str) -> torch.Tensor:
        key = ("\x00nonascii", family)
        if key not in self._glob_cache:
            byt, lens = self._family_tensors(family)
            self._glob_cache[key] = nonascii_mask(byt, lens, plain=self.plain)
        return self._glob_cache[key]

    def _accept_confirm(self, kind: str, pattern: str, family: str):
        """(accepts, confirm-needed | None) over a lane family. The
        confirm plane marks positions whose device verdict is a maybe:
        over-approximating tables on a HIT (miss stays definitive),
        byte-sensitive patterns on non-ASCII subjects (either way)."""
        got = self._bank_lookup(kind, pattern, family)
        if got is None:
            if kind == "re2":
                return None, None  # no bank => caller routes to host
            acc = self._glob_match(pattern, family)
            if "?" in pattern:
                # legacy NFA consumes one BYTE per '?': confirm
                # non-ASCII subjects exactly like the bank path
                return acc, self._family_nonascii(family)
            return acc, None
        acc, dfa = got
        conf = None
        if not dfa.exact:
            conf = acc
        if dfa.confirm_nonascii:
            na = self._family_nonascii(family)
            conf = na if conf is None else (conf | na)
        return acc, conf

    def _glob_match(self, pattern: str, family: str) -> torch.Tensor:
        """One glob outside the bank over a lane family (kernel K9): a
        row of the plane of its pack, which is computed once a batch for
        every NFA-route glob of the family that compile recorded. A glob
        compile did not record runs as a pack of one, counted in
        ``stats["nfa_unpacked"]``."""
        where = self._nfa.index.get((family, pattern))
        if where is None:
            self.stats["nfa_unpacked"] += 1
            byt, lens = self._family_tensors(family)
            fn = kernels.glob_nfa_plain if self.plain else kernels.glob_nfa
            return fn(pattern, byt, lens)
        g, row = where
        return self._nfa_plane(family, g)[row]

    def _nfa_plane(self, family: str, g: int) -> torch.Tensor:
        """The (P, ...) plane of one of the family's K9 packs."""
        key = ("\x00nfa", family, g)
        if key not in self._glob_cache:
            byt, lens = self._family_tensors(family)
            fn = kernels.glob_nfa_pack_plain if self.plain \
                else kernels.glob_nfa_pack
            self._glob_cache[key] = fn(self._nfa.packs[family][g], byt, lens)
        return self._glob_cache[key]

    def _accept_confirm_cached(self, kind: str, pattern: str, family: str):
        """One (accepts, confirm) pair per (kind, pattern, family) —
        the legacy NFA fallback runs a full scan per pattern, so the
        pair MUST be computed once, not once per consumer."""
        key = ("\x00ac", kind, pattern, family)
        if key not in self._glob_cache:
            self._glob_cache[key] = self._accept_confirm(
                kind, pattern, family)
        return self._glob_cache[key]

    def glob_pool(self, pattern: str) -> torch.Tensor:
        return self._accept_confirm_cached("glob", pattern, "pool")[0]

    def _pool_confirm(self, kind: str, pattern: str):
        return self._accept_confirm_cached(kind, pattern, "pool")[1]

    def glob_meta(self, pattern: str, which: str) -> torch.Tensor:
        """which: name | ns | user. Returns (N,) accepts; confirm-needy
        cells accumulate into confirm_acc."""
        acc, conf = self._accept_confirm_cached("glob", pattern, which)
        if conf is not None:
            self.confirm_acc.append(conf)
        return acc

    def meta_any(self, which: str, patterns: Sequence[str]) -> torch.Tensor:
        """(N,) OR over a filter's ``names`` (which="names") or
        ``namespaces`` of ``_glob_or_eq`` — a Namespace-kind resource
        compares its name under ``namespaces`` (match.go:18-31) — in one
        K10 launch a batch. The OR of the entries' confirm planes, of
        both families under ``namespaces``, joins ``confirm_acc`` once a
        call, as the per-entry loop's planes did. Lists of the same
        entries (a rule and its autogen copies) share one launch."""
        key = ("\x00meta_any", id(self._meta_table(which, patterns)))
        got = self._glob_cache.get(key)
        if got is None:
            args = self.meta_any_args(which, patterns)
            fn = kernels.meta_any_plain if self.plain else kernels.meta_any
            got = self._glob_cache[key] = (fn(*args), args[0].confirms)
        (hit, conf), confirms = got
        if confirms:
            self.confirm_acc.append(conf)
        return hit

    def meta_any_args(self, which: str, patterns: Sequence[str]) -> tuple:
        """K10's arguments for one filter list on this batch: (entry
        table, planes, hash lanes, Namespace-kind mask or None, each
        family's non-ASCII mask or None); the planes come from (and
        stay in) the batch's glob cache."""
        table = self._meta_table(which, patterns)
        planes = [self._meta_plane(table, k) for k in table.slots]
        ns = which == "namespaces"
        hashes = [self.b["meta_name_h"]] + ([self.b["meta_ns_h"]] if ns else [])
        is_ns = (self.b["meta_is_namespace_kind"] == 1) if ns else None
        na = [self._family_nonascii(f) if want else None
              for f, want in zip(table.families, table.na)]
        return table, planes, hashes, is_ns, na

    def _meta_plane(self, table, key: Tuple) -> torch.Tensor:
        if key[0] == "bank":
            return self._bank_plane(key[1])
        if key[0] == "nfa":
            return self._nfa_plane(key[1], key[2])
        return torch.stack([self._accept_confirm_cached("glob", p, key[1])[0]
                            for p in table.unpacked[key[1]]])

    def _meta_table(self, which: str, patterns: Sequence[str]):
        """K10's entry table of one filter list, built once per program
        (``kernels.MetaAnyTable``): per family, each entry's source as
        ``_glob_or_eq`` and ``_accept_confirm`` choose it — a literal's
        hash pair, a bank column (confirming itself when its DFA is not
        exact), a K9 pack row or a glob outside the packs — and whether
        the family's non-ASCII mask confirms. Lists of the same entries
        share one table."""
        key = (which, tuple(patterns))
        table = self._meta_tables.get(key)
        if table is None:
            table = self._meta_tables[key] = self._build_meta_table(
                which, patterns)
        return table

    def _build_meta_table(self, which: str, patterns: Sequence[str]):
        from ..utils.wildcard import contains_wildcard

        families = ("name",) if which == "names" else ("name", "ns")
        tags = {"name": "m", "ns": "N"}
        slots: List[Tuple] = []
        entry_major: List[bool] = []

        def slot(k: Tuple, em: bool) -> int:
            if k not in slots:
                slots.append(k)
                entry_major.append(em)
            return slots.index(k)

        bank = self.dfa
        rows: List[Tuple[int, int, int, int]] = []
        off: List[int] = []
        na: List[bool] = []
        unpacked: Dict[str, List[str]] = {}
        for fam in families:
            frows: List[Tuple[int, int, int, int]] = []
            fna = False
            for pat in patterns:
                if not contains_wildcard(pat):
                    hi, lo = split32(hash_str(pat, tag=tags[fam]))
                    frows.append((-1, _i32(hi), _i32(lo), 0))
                    continue
                col = None
                if bank is not None:
                    pid = bank.glob_ids.get(pat)
                    col = self._bank_cols.get(fam, {}).get(pid)
                if col is not None:
                    dfa = bank.patterns[pid]
                    frows.append((slot(("bank", fam), False), col, 0,
                                  0 if dfa.exact else 1))
                    fna = fna or bool(dfa.confirm_nonascii)
                    continue
                where = self._nfa.index.get((fam, pat))
                if where is not None:
                    frows.append((slot(("nfa", fam, where[0]), True),
                                  where[1], 0, 0))
                else:
                    ups = unpacked.setdefault(fam, [])
                    if pat not in ups:
                        ups.append(pat)
                    frows.append((slot(("unpacked", fam), True),
                                  ups.index(pat), 0, 0))
                fna = fna or "?" in pat
            rows.extend(sorted(frows, key=lambda r: (r[0], r[1])))
            off.append(len(rows))
            na.append(fna)
        if len(off) == 1:
            off.append(off[0])
        return kernels.MetaAnyTable(families, slots, entry_major,
                                    np.asarray(rows, dtype=np.int32),
                                    (off[0], off[1]), tuple(na), unpacked)

    def _rows_from_pool(self, plane: torch.Tensor,
                        lane: str = "byte_slot") -> torch.Tensor:
        """Gather a (N, K) pool-slot plane to (N, R) rows via the
        row->slot lane (False when the row has no slot) — kernel K7."""
        fn = kernels.pool_rows_plain if self.plain else kernels.pool_rows
        return fn(plane, self.b[lane])

    def glob_rows(self, pattern: str, lane: str = "byte_slot") -> torch.Tensor:
        """(N, R) glob accept per row via its byte-pool slot (False when
        the row has no slot)."""
        acc = self._rows_from_pool(self.glob_pool(pattern), lane)
        conf = self._pool_confirm("glob", pattern)
        if conf is not None:
            self.confirm_acc.append(
                self._rows_from_pool(conf, lane).any(dim=-1))
        return acc

    def glob_key_rows(self, pattern: str) -> torch.Tensor:
        """(N, R) glob accept of each row's map KEY bytes."""
        return self.glob_rows(pattern, "key_byte_slot")


# ---------------------------------------------------------------------------
# scopes: depth-0 (per-resource) vs instance (per array element)


class Depth0:
    """The resource scope: reductions over a row plane's rows, which join
    the rule's tape as inputs (plain tensors without a ``ctx``)."""

    shape_suffix = ()

    def __init__(self, ctx: Optional[Ctx] = None):
        self.ctx = ctx

    def _lift(self, t: torch.Tensor):
        return t if self.ctx is None else self.ctx.lift(t)

    def any(self, rowpred: torch.Tensor):
        return self._lift(rowpred.any(dim=-1))

    def count(self, rowpred: torch.Tensor):
        return self._lift(rowpred.sum(dim=-1, dtype=torch.int32))

    def many(self, items: Sequence[Tuple[torch.Tensor, str]]
             ) -> List[torch.Tensor]:
        return [self.any(p) if w == "any" else self.count(p)
                for p, w in items]


class _Counted:
    """A scope whose reductions are per-instance counts (K3)."""

    level = 0

    def __init__(self, ctx: Ctx):
        self.ctx = ctx

    def any(self, rowpred: torch.Tensor) -> torch.Tensor:
        return self.many([(rowpred, "any")])[0]

    def count(self, rowpred: torch.Tensor) -> torch.Tensor:
        return self.many([(rowpred, "count")])[0]

    def many(self, items: Sequence[Tuple[torch.Tensor, str]]
             ) -> List[torch.Tensor]:
        """Counts ("count") or their ``> 0`` ("any") of several row
        predicates, issued together (Ctx.inst_counts); inputs of the
        rule's tape while one is recorded."""
        return [self.ctx.lift(t)
                for t in self.ctx.inst_counts(self.level, items)]


class InstScope(_Counted):
    level = 1


class Inst2Scope(_Counted):
    """Second-level instance scope: joins rows by (scope1, scope2) pairs
    for nested arrays-of-maps (containers[].ports[]); reductions land in
    (N, I, J)."""

    level = 2


# ---------------------------------------------------------------------------
# leaf row predicates (pattern.Validate lowering, pattern.go:26)


def leaf_row_pred(ctx: Ctx, leaf: Any) -> torch.Tensor:
    if isinstance(leaf, BoolLeaf):
        return ctx.type_is(T_BOOL) & (ctx.b["bool_val"] == int(1 if leaf.value else 0))
    if isinstance(leaf, NumLeaf):
        canon = canon_number(leaf.value)
        num_eq = ctx.heq("num", canon)
        grammar = ctx.b["str_goint" if leaf.is_int else "str_gofloat"] == 1
        return (ctx.type_is(T_NUM) & num_eq) | (ctx.type_is(T_STR) & grammar & num_eq)
    if isinstance(leaf, NullLeaf):
        return (
            ctx.type_is(T_NULL)
            | (ctx.type_is(T_BOOL) & (ctx.b["bool_val"] == 0))
            | (ctx.type_is(T_NUM) & (ctx.b["num_val"] == 0))
            | (ctx.type_is(T_STR) & ctx.heq("repr", hash_str("", tag="s")))
        )
    if isinstance(leaf, StrLeaf):
        pred = ctx.type_is(T_STR) & ctx.heq("repr", hash_str(leaf.full, tag="s"))
        for units in leaf.alternatives:
            conj = None
            for unit in units:
                disj = None
                for c in unit:
                    p = _cmp_pred(ctx, c)
                    disj = p if disj is None else (disj | p)
                if disj is None:  # unmatched range -> always false
                    disj = ctx.false((ctx.N, ctx.R))
                conj = disj if conj is None else (conj & disj)
            if conj is not None:
                pred = pred | conj
        return pred
    raise Unsupported(f"leaf {type(leaf).__name__}")


_ORD_OPS = {
    Operator.EQUAL: "eq", Operator.NOT_EQUAL: "ne", Operator.MORE: "gt",
    Operator.LESS: "lt", Operator.MORE_EQUAL: "ge", Operator.LESS_EQUAL: "le",
}


def _ord_cmp(val: torch.Tensor, const: float, canon_eq: torch.Tensor, op: Operator) -> torch.Tensor:
    """Ordered compare on f32 lanes; equality points are exact via the
    canonical hash, strict compares are exact except in the final ulp."""
    kind = _ORD_OPS[op]
    c = _f32(const)
    if kind == "eq":
        return canon_eq
    if kind == "ne":
        return ~canon_eq
    if kind == "gt":
        return (val > c) & ~canon_eq
    if kind == "lt":
        return (val < c) & ~canon_eq
    if kind == "ge":
        return (val > c) | canon_eq
    return (val < c) | canon_eq


def _cmp_pred(ctx: Ctx, c: Cmp) -> torch.Tensor:
    """One operator+operand term (pattern.go:207 validateString trial
    order: duration, then quantity, then string)."""
    if c.op not in _ORD_OPS:
        return ctx.false((ctx.N, ctx.R))
    res: Optional[torch.Tensor] = None
    processed: Optional[torch.Tensor] = None
    if c.dur_ns is not None:
        has = ctx.b["has_dur"] == 1
        r = _ord_cmp(ctx.b["dur_val"], c.dur_ns / 1e9, ctx.heq("dur", canon_duration(c.dur_ns)), c.op)
        res, processed = torch.where(has, r, False), has
    if c.qty is not None:
        has_q = (ctx.b["has_qty"] == 1)
        if processed is not None:
            has_q = has_q & ~processed
        r = _ord_cmp(ctx.b["qty_val"], float(c.qty), ctx.heq("qty", canon_quantity(c.qty)), c.op)
        if res is None:
            res, processed = torch.where(has_q, r, False), has_q
        else:
            res = torch.where(has_q, r, res)
            processed = processed | has_q
    # string branch (only Equal / NotEqual ever succeed, pattern.go:272)
    if c.op in (Operator.EQUAL, Operator.NOT_EQUAL):
        has_repr = ctx.b["has_repr"] == 1
        if c.operand == "*":
            m = ctx.true((ctx.N, ctx.R))
        elif c.is_glob:
            m = ctx.glob_rows(c.operand)
        else:
            m = ctx.heq("repr", hash_str(c.operand, tag="s"))
        s = has_repr & (~m if c.op is Operator.NOT_EQUAL else m)
    else:
        s = ctx.false((ctx.N, ctx.R))
    if res is None:
        return s
    return torch.where(processed, res, s)


# ---------------------------------------------------------------------------
# pattern node evaluation


def _leaf_missing_cls(leaf: Any) -> int:
    """validate(None, pattern) is a compile-time constant."""
    if isinstance(leaf, NullLeaf):
        return PASS
    if isinstance(leaf, (BoolLeaf, NumLeaf)):
        return FAIL
    if isinstance(leaf, StrLeaf):
        return PASS if patternpkg.validate(None, leaf.full) else FAIL
    return FAIL


def _first_nonpass(ctx: Ctx, classes: List[Any], shape):
    """The first class that is not PASS (PASS when none): ``res`` is
    taken exactly when it is not PASS, so each step keeps ``res`` or
    takes the next class (``fold.first_nonpass``)."""
    res = ctx.full(shape, PASS)
    for cls in classes:
        res = fold.first_nonpass(res, cls)
    return res


def eval_node(ctx: Ctx, scope, node: Node) -> torch.Tensor:
    if isinstance(node, LeafNode):
        return _eval_leaf(ctx, scope, node)
    if isinstance(node, MapNode):
        return _eval_map(ctx, scope, node)
    if isinstance(node, ArrayMapsNode):
        return _eval_array_maps(ctx, scope, node)
    if isinstance(node, ArrayScalarNode):
        return _eval_array_scalar(ctx, scope, node)
    raise Unsupported(f"node {type(node).__name__}")


def _eval_leaf(ctx: Ctx, scope, node: LeafNode) -> torch.Tensor:
    mask = ctx.rows_at(node.path)
    pred = leaf_row_pred(ctx, node.leaf)
    elem_mask = ctx.rows_at(node.path + (ARRAY_SEG,))
    exists, is_arr, scalar_ok, n_elem, n_ok = scope.many([
        (mask, "any"), (ctx.typed(mask, T_ARR), "any"),
        (ctx.typed(mask, T_ARR, neg=True) & pred, "any"),
        (elem_mask, "count"), (elem_mask & pred, "count")])
    arr_ok = n_elem == n_ok  # every element matches; empty array passes
    ok = fold.where(is_arr, arr_ok, scalar_ok)
    missing = _leaf_missing_cls(node.leaf)
    cls = fold.where(ok, PASS, FAIL)
    return fold.where(exists, cls, missing)


def _eval_wildcard_anchor(ctx: Ctx, wc, kind: str, literal_cls: torch.Tensor) -> torch.Tensor:
    """ExpandInMetadata select (wildcards.go:62, via engine/wildcards.py):
    when the labels/annotations map exists with all-string values and a
    resource key matches the glob, the anchor applies to the FIRST
    matching key's value (oracle dict order = row order); otherwise the
    literal glob-key behavior stands. Depth-0 only (compile-enforced)."""
    P = wc.map_path
    map_rows = ctx.rows_at(P)
    children = ctx.rows_with_parent(P)
    is_map = ctx.row_any(map_rows & ctx.type_is(T_MAP))
    nonstring = ctx.row_any(children & ~ctx.type_is(T_STR))
    accept = children & ctx.glob_key_rows(wc.glob)
    pred = leaf_row_pred(ctx, wc.leaf)
    # any matching row, and the leaf at the FIRST matching row (row 0
    # when none matches, as jnp.argmax gives) — kernel K8
    fn = kernels.first_true_take_plain if ctx.plain \
        else kernels.first_true_take
    has, val_ok = fn(accept.contiguous(),
                     pred.expand(ctx.N, ctx.R).contiguous())
    has, val_ok = ctx.lift(has), ctx.lift(val_ok)
    if kind == "condition":
        m_cls = fold.where(val_ok, PASS, SKIP)
    elif kind == "negation":  # expanded key exists -> negation fails
        m_cls = FAIL
    else:  # equality / plain: key exists, value must match the leaf
        m_cls = fold.where(val_ok, PASS, FAIL)
    use = is_map & ~nonstring & has
    return fold.where(use, m_cls, literal_cls)


def _eval_map(ctx: Ctx, scope, node: MapNode) -> torch.Tensor:
    mask = ctx.rows_at(node.path)
    # every reduction of the map and its children that needs no child's
    # evaluation, issued together: exists, is_map, each anchor's and
    # phase-2 child's existence, and the non-null of plain '*' children
    items = [(mask, "any"), (ctx.typed(mask, T_MAP), "any")]
    items += [(ctx.rows_at(node.path + (a.key,)), "any") for a in node.anchors]
    for c in node.phase2:
        cmask = ctx.rows_at(node.path + (c.key,))
        items.append((cmask, "any"))
        if c.is_star and not c.is_global:
            items.append((ctx.typed(cmask, T_NULL, neg=True), "any"))
    got = iter(scope.many(items))
    exists, is_map = next(got), next(got)

    anchor_cls: List[torch.Tensor] = []
    for a in node.anchors:
        cexists = next(got)
        if a.kind == "negation":
            cls = fold.where(cexists, FAIL, PASS)
        elif a.kind == "condition":
            ch = eval_node(ctx, scope, a.child)
            cls = fold.where(cexists & (ch == PASS), PASS, SKIP)
        elif a.kind == "equality":
            ch = eval_node(ctx, scope, a.child)
            cls = fold.where(cexists, ch, PASS)
        else:  # existence
            cls = _eval_existence(ctx, scope, a.child, cexists)
        if a.wildcard is not None:
            cls = _eval_wildcard_anchor(ctx, a.wildcard, a.kind, cls)
        anchor_cls.append(cls)

    shape = exists.shape
    if anchor_cls:
        any_fail = fold.any_of([c == FAIL for c in anchor_cls])
        all_skip = fold.all_of([c == SKIP for c in anchor_cls])
    else:
        any_fail = ctx.false(shape)
        all_skip = ctx.false(shape)

    p2_cls: List[torch.Tensor] = []
    for c in node.phase2:
        cexists = next(got)
        if c.is_star and not c.is_global:
            # "*" under a plain key: present and non-null (handlers.go:128)
            non_null = next(got)
            cls = fold.where(cexists & non_null, PASS, FAIL)
        elif c.is_global:
            ch = eval_node(ctx, scope, c.child)
            cls = fold.where(cexists, fold.where(ch == PASS, PASS, SKIP), PASS)
        else:
            cls = eval_node(ctx, scope, c.child)
        if c.wildcard is not None:
            cls = _eval_wildcard_anchor(ctx, c.wildcard, "plain", cls)
        p2_cls.append(cls)

    phase2 = _first_nonpass(ctx, p2_cls, shape)
    cls = fold.where(any_fail, FAIL, fold.where(all_skip, SKIP, phase2))
    return fold.where(exists & is_map, cls, FAIL)


def _eval_existence(ctx: Ctx, scope, node: ExistenceNode, cexists: torch.Tensor) -> torch.Tensor:
    if not isinstance(scope, Depth0):
        raise Unsupported("existence anchor in array scope")
    mask = ctx.rows_at(node.path)
    is_arr = ctx.row_any(mask & ctx.type_is(T_ARR))
    inst = InstScope(ctx)
    valid_i = inst.any(ctx.rows_at(node.path + (ARRAY_SEG,)))
    sat = ctx.true(cexists.shape)
    for pm in node.elements:
        cls_i = eval_node(ctx, inst, pm)  # (N, I)
        sat = sat & (valid_i & (cls_i == PASS)).any(dim=-1)
    cls = fold.where(is_arr, fold.where(sat, PASS, FAIL), FAIL)
    return fold.where(cexists, cls, PASS)


def _eval_array_maps(ctx: Ctx, scope, node: ArrayMapsNode) -> torch.Tensor:
    if isinstance(scope, Depth0):
        mask = ctx.rows_at(node.path)
        exists = ctx.row_any(mask)
        is_arr = ctx.row_any(mask & ctx.type_is(T_ARR))
        inst = InstScope(ctx)
        valid_i = inst.any(ctx.rows_at(node.path + (ARRAY_SEG,)))
        elem = eval_node(ctx, inst, node.element)  # (N, I)
    elif isinstance(scope, InstScope):
        # nested array-of-maps (containers[].ports[]): join elements by
        # (scope1, scope2); classes land in (N, I, J), reduced over J
        mask = ctx.rows_at(node.path)
        exists, is_arr = scope.many([(mask, "any"),
                                     (ctx.typed(mask, T_ARR), "any")])
        inst2 = Inst2Scope(ctx)
        valid_i = inst2.any(ctx.rows_at(node.path + (ARRAY_SEG,)))  # (N, I, J)
        elem = eval_node(ctx, inst2, node.element)
        # second-level joins cap at max_instances; overflowing arrays
        # route the resource to host for this rule
        over = (mask & (ctx.b["s2_overflow"] == 1)).any(dim=-1)
        ctx.host_acc.append(over)
    else:
        raise Unsupported("array-of-maps nested beyond two levels")
    any_fail = (valid_i & (elem == FAIL)).any(dim=-1)
    any_pass = (valid_i & (elem == PASS)).any(dim=-1)
    nonempty = valid_i.any(dim=-1)
    cls = fold.where(
        any_fail, FAIL, fold.where(any_pass, PASS, fold.where(nonempty, SKIP, PASS))
    )
    return fold.where(exists & is_arr, cls, FAIL)


def _eval_array_scalar(ctx: Ctx, scope, node: ArrayScalarNode) -> torch.Tensor:
    mask = ctx.rows_at(node.path)
    pred = leaf_row_pred(ctx, node.leaf)
    elem_mask = ctx.rows_at(node.path + (ARRAY_SEG,))
    exists, is_arr, n_elem, n_ok = scope.many([
        (mask, "any"), (ctx.typed(mask, T_ARR), "any"),
        (elem_mask, "count"), (elem_mask & pred, "count")])
    all_ok = n_elem == n_ok
    cls = fold.where(all_ok, PASS, FAIL)
    return fold.where(exists & is_arr, cls, FAIL)


# ---------------------------------------------------------------------------
# condition evaluation (deny / preconditions)


def _op_canon(op: str) -> str:
    op = op.lower()
    return {"equal": "equals", "notequal": "notequals"}.get(op, op)


_IN_MODES = {"anyin": "any_in", "allin": "all_in",
             "anynotin": "any_not_in", "allnotin": "all_not_in",
             # deprecated In/NotIn (in.go): scalar keys behave like
             # AnyIn/AnyNotIn; list keys are strict (all-in / any-not-
             # in with non-string elements forcing false — see the
             # strict handling in _eval_path_cond)
             "in": "in_strict", "notin": "notin_strict"}
_NUM_OPS = {"greaterthan": "gt", "greaterthanorequals": "ge",
            "lessthan": "lt", "lessthanorequals": "le"}


def _cond_shape(ctx: Ctx, scope) -> Tuple[int, ...]:
    return (ctx.N, ctx.I) if isinstance(scope, InstScope) else (ctx.N,)


def _expand(ctx: Ctx, scope, r):
    """Broadcast a per-resource (N,) result into the element scope (on
    the rule's tape, ``Tape.expand``)."""
    if isinstance(scope, InstScope) and r.ndim == 1:
        if ctx.fold is not None:
            return ctx.fold.expand(r)
        return r[:, None].expand(ctx.N, ctx.I)
    return r


def eval_cond_tree(
    ctx: Ctx, tree: Optional[CondTreeIR], scope=None, prefix: Tuple[str, ...] = ()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (ok, err) bools — (N,) at resource scope, (N, I) inside a
    foreach element scope."""
    scope = scope if scope is not None else Depth0(ctx)
    shape = _cond_shape(ctx, scope)
    ok = ctx.true(shape)
    err = ctx.false(shape)
    if tree is None:
        return ok, err
    for any_list, all_list in tree.blocks:
        if any_list:
            acc = ctx.false(shape)
            for c in any_list:
                p, e = eval_cond(ctx, c, scope, prefix)
                acc = acc | p
                err = err | e
            ok = ok & acc
        for c in all_list:
            p, e = eval_cond(ctx, c, scope, prefix)
            ok = ok & p
            err = err | e
    return ok, err


def eval_cond(
    ctx: Ctx, ir: CondIR, scope=None, prefix: Tuple[str, ...] = ()
) -> Tuple[torch.Tensor, torch.Tensor]:
    scope = scope if scope is not None else Depth0(ctx)
    shape = _cond_shape(ctx, scope)
    zero_err = ctx.false(shape)
    op = _op_canon(ir.op)
    if isinstance(ir.key, OpKey):
        return _expand(ctx, scope, _eval_op_cond(ctx, ir.key, op, ir.value)), zero_err
    if isinstance(ir.key, UserInfoKey):
        return _expand(ctx, scope,
                       _eval_userinfo_cond(ctx, ir.key, op, ir.value)), zero_err
    if isinstance(ir.key, DynKey):
        res, errs = _eval_dyn_key_cond(ctx, ir.key, op, ir.value)
        return _expand(ctx, scope, res), _expand(ctx, scope, errs)
    if isinstance(ir.value, DynValueRef):
        res, errs = _eval_path_vs_dyn_list(ctx, ir.key, op, ir.value, prefix)
        return _expand(ctx, scope, res), _expand(ctx, scope, errs)
    if isinstance(ir.key, LiteralKey):
        if isinstance(ir.value, ElementCollect):
            return _eval_literal_vs_collect(ctx, scope, prefix, ir.key.value, op, ir.value)
        # literal key + literal value: constant-fold via the scalar oracle
        from ..engine.conditions import evaluate_condition_values

        const = bool(evaluate_condition_values(ir.key.value, ir.op, ir.value))
        return ctx.full(shape, const), zero_err
    if isinstance(ir.key, ElementCollect):
        return _eval_path_cond(ctx, ir.key, op, ir.value, scope, prefix)
    # PathCollect keys always resolve at resource scope
    res, err = _eval_path_cond(ctx, ir.key, op, ir.value, Depth0(ctx), ())
    return _expand(ctx, scope, res), _expand(ctx, scope, err)


def _eval_literal_vs_collect(
    ctx: Ctx, scope, prefix: Tuple[str, ...], key_val: Any, op: str, ec: ElementCollect
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LiteralKey membership against an {{element...}} collected list
    (the capabilities-strict `key: ALL` shape): hit iff any collected
    element go_sprint-equals the key (conditions.py _key_exists_in_array
    list branch). Null / empty / []-default collections all yield
    hit=False, so no explicit presence gating is needed."""
    shape = _cond_shape(ctx, scope)
    err = _keys_errors(ctx, ec.keys_error_states, scope, prefix)
    mode = _IN_MODES[op]
    ks = go_sprint(key_val)
    if ks is None:
        hit = ctx.false(shape)
    else:
        rows = ctx.false((ctx.N, ctx.R))
        for st in ec.states:
            if st.mode == "keys":
                m = ctx.rows_with_parent(prefix + st.segs) & ctx.heq("key", hash_str(ks, tag="k"))
            else:
                m = ctx.rows_at(prefix + st.segs)
                if st.no_arr:
                    m = m & ~ctx.type_is(T_ARR)
                if st.no_null:
                    m = m & ~ctx.type_is(T_NULL)
                m = m & ctx.heq("sprint", hash_str(ks, tag="s"))
            rows = rows | m
        hit = scope.any(rows)
    return (hit if mode in ("any_in", "all_in") else ~hit), err


def _eval_dyn_key_cond(ctx: Ctx, key: DynKey, op: str,
                       value: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host-resolved context operand vs literal. Lanes carry the
    value's canonical forms (type / bool / go-parsed number / sprint
    hash); load failures surface as rule ERROR exactly like the scalar
    engine's context-load errors. Returns ((N,) res, (N,) err)."""
    s = key.slot
    t = ctx.b["dyn_type"][s]
    err = t == 0
    # host-flagged cells (value shapes hash lanes can't express)
    ctx.host_acc.append((ctx.b["dyn_host"][s] == 1) & ~err)
    if op in ("equals", "notequals"):
        if isinstance(value, bool):
            eq = (t == 2) & (ctx.b["dyn_bool"][s] == (1 if value else 0))
        elif isinstance(value, (int, float)):
            # numeric equality go-coerces number strings (equal.go)
            eq = (ctx.b["dyn_has_num"][s] == 1) \
                & (ctx.b["dyn_num"][s] == _f32(value))
        elif isinstance(value, str):
            hi, lo = split32(hash_str(value, tag="s"))
            sh = ctx.b["dyn_sprint"][s]
            eq = (t == 4) & (sh[:, 0] == _i32(hi)) \
                & (sh[:, 1] == _i32(lo))
        else:  # None — Equals never matches nil (equal.go)
            eq = ctx.false(t.shape)
        if op == "notequals":
            # nil/err/composite keys are False, not negated-True
            typed = (t == 2) | (t == 3) | (t == 4)
            return typed & ~eq, err
        return eq, err
    if op in _NUM_OPS:
        kind = _NUM_OPS[op]
        num = ctx.b["dyn_num"][s]
        has = ctx.b["dyn_has_num"][s] == 1
        c = _f32(value)
        res = {"gt": num > c, "ge": num >= c,
               "lt": num < c, "le": num <= c}[kind]
        return has & res, err
    return ctx.false(t.shape), err


def _dyn_in_set(ctx: Ctx, slot: int, mask: torch.Tensor) -> torch.Tensor:
    """Row-hash membership against a per-resource list operand."""
    ln = ctx.b["dyn_list_n"][slot]
    lh = ctx.b["dyn_list_h"][slot]       # (N, L, 2)
    shi, slo = ctx.b["sprint_hi"], ctx.b["sprint_lo"]
    in_set = ctx.false((ctx.N, ctx.R))
    for l in range(lh.shape[1]):
        live = (l < ln)[:, None]
        eq = (shi == lh[:, l, 0][:, None]) & (slo == lh[:, l, 1][:, None])
        in_set = in_set | (live & eq)
    return in_set & mask


def _eval_path_vs_dyn_list(ctx: Ctx, pc, op: str, ref: DynValueRef,
                           prefix: Tuple[str, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Path-chain / projection keys against a host-resolved operand:
    list membership (_set_in semantics, hash equality) or scalar
    equality. Glob/unit-bearing values and list overflow were flagged
    host-side. ((N,) res, (N,) err)."""
    scope = Depth0(ctx)
    s = ref.slot
    t = ctx.b["dyn_type"][s]
    err = t == 0
    # flagged cells complete on host (per-cell HOST verdict)
    ctx.host_acc.append((ctx.b["dyn_host"][s] == 1) & ~err)
    if isinstance(pc, LiteralKey):
        # constant key vs per-resource list (scalar keys: the strict
        # In/NotIn modes behave like AnyIn/AnyNotIn)
        from .flatten import go_sprint

        ks = go_sprint(pc.value)
        ln = ctx.b["dyn_list_n"][s]
        lh = ctx.b["dyn_list_h"][s]
        hit = ctx.false((ctx.N,))
        if ks is not None:
            hi, lo = split32(hash_str(ks, tag="s"))
            for l in range(lh.shape[1]):
                live = l < ln
                hit = hit | (live & (lh[:, l, 0] == _i32(hi))
                             & (lh[:, l, 1] == _i32(lo)))
        is_list = t == 5
        mode = _IN_MODES[op]
        pos = mode in ("any_in", "all_in", "in_strict")
        return is_list & hit if pos else is_list & ~hit, err
    mask = ctx.false((ctx.N, ctx.R))
    for st in pc.states:
        m = ctx.rows_at(prefix + st.segs)
        if st.no_arr:
            m = m & ~ctx.type_is(T_ARR)
        if st.no_null:
            m = m & ~ctx.type_is(T_NULL)
        mask = mask | m
    if op in ("equals", "notequals"):
        # scalar chain key vs scalar operand
        sh = ctx.b["dyn_sprint"][s]
        eq_str = scope.any(mask & ctx.type_is(T_STR)
                           & (ctx.b["sprint_hi"] == sh[:, 0][:, None])
                           & (ctx.b["sprint_lo"] == sh[:, 1][:, None]))
        nh = ctx.b["dyn_num_h"][s]
        has_num = (ctx.b["dyn_has_num"][s] == 1)[:, None]
        eq_num = scope.any(mask & ctx.type_is(T_NUM) & has_num
                           & (ctx.b["num_hi"] == nh[:, 0][:, None])
                           & (ctx.b["num_lo"] == nh[:, 1][:, None]))
        ab = ctx.b["dyn_as_bool"][s]
        eq_bool = scope.any(mask & ctx.type_is(T_BOOL)
                            & (ab < 2)[:, None]
                            & (ctx.b["bool_val"] == ab[:, None]))
        eq = eq_str | eq_num | eq_bool
        if op == "notequals":
            null_or_missing = (~scope.any(mask)) \
                | scope.any(ctx.typed(mask, T_NULL))
            return ~eq & ~null_or_missing, err
        return eq, err
    # membership. value shapes: a real list (t==5), or a STRING that
    # JSON-decodes to a string array (strict In/NotIn + the AnyIn
    # family both decode; other string forms keep oracle-only
    # semantics and route to host / evaluate false)
    mode = _IN_MODES[op]
    strict = mode in ("in_strict", "notin_strict")
    is_list = t == 5
    json_list = (t == 4) & (ctx.b["dyn_json_list"][s] == 1)
    if strict:
        usable = is_list | json_list
        # raw singleton-equality (the wildcard arm of keyExistsInArray)
        # is exact equality for non-glob values; non-decodable string
        # values keep oracle-only edge semantics -> host
        ctx.host_acc.append((t == 4) & ~json_list & ~err)
        sh = ctx.b["dyn_sprint"][s]
        raw_eq = scope.any(mask & ctx.type_is(T_STR)
                           & (ctx.b["sprint_hi"] == sh[:, 0][:, None])
                           & (ctx.b["sprint_lo"] == sh[:, 1][:, None]))
    else:
        usable = is_list
        raw_eq = ctx.false((ctx.N,))
        # AnyIn-family string values have singleton/range semantics
        # hash lanes don't model: those cells complete on host
        ctx.host_acc.append((t == 4) & ~err)
    in_set = _dyn_in_set(ctx, s, mask)
    if pc.is_projection:
        present = _list_exists(ctx, pc, scope, prefix)
        any_in = scope.any(in_set)
        any_not_in = scope.any(mask & ~in_set)
        res = {
            "any_in": any_in,
            "all_in": ~any_not_in,
            "any_not_in": any_not_in,
            "all_not_in": ~any_in,
            "in_strict": ~any_not_in,
            "notin_strict": any_not_in,
        }[mode]
        return present & usable & res, err
    # scalar chain key: scalar vs array semantics as in the static
    # membership branch
    st = pc.states[0]
    is_scalar = scope.any(mask & (ctx.type_is(T_STR) | ctx.type_is(T_NUM)
                                  | ctx.type_is(T_BOOL)))
    is_arr = scope.any(ctx.typed(mask, T_ARR))
    hit = scope.any(in_set) | raw_eq
    em = ctx.rows_at(prefix + st.segs + (ARRAY_SEG,))
    e_in = _dyn_in_set(ctx, s, em)
    e_any_in = scope.any(e_in)
    e_any_not = scope.any(em & ~e_in)
    e_nonstr = scope.any(ctx.typed(em, T_STR, neg=True))
    if strict and pc is not None:
        # strict array keys vs string values mix decode rules — host
        ctx.host_acc.append(is_arr & (t == 4) & ~err)
    res = {
        "any_in": fold.where(is_arr, e_any_in, is_scalar & hit),
        "all_in": fold.where(is_arr, ~e_any_not, is_scalar & hit),
        "any_not_in": fold.where(is_arr, e_any_not, is_scalar & ~hit),
        "all_not_in": fold.where(is_arr, ~e_any_in, is_scalar & ~hit),
        "in_strict": fold.where(is_arr, ~e_any_not & ~e_nonstr,
                              is_scalar & hit),
        "notin_strict": fold.where(is_arr, e_any_not & ~e_nonstr,
                                 is_scalar & ~hit),
    }[mode]
    return usable & res, err


def _eval_userinfo_cond(ctx: Ctx, key: UserInfoKey, op: str,
                        value: Any) -> torch.Tensor:
    """{{ request.userInfo.<field> }} membership against a literal
    string list — per-lane hash equality over the RBAC identity lanes,
    mirroring conditions.py _set_in for glob-free values (vacuous
    truths on empty identity lists included)."""
    lane, n_lane, tag = {
        "groups": ("groups_h", "groups_n", "u"),
        "roles": ("roles_h", "roles_n", "r"),
        "clusterRoles": ("croles_h", "croles_n", "r"),
    }[key.field]
    arr = ctx.b["meta_" + lane]          # (N, L, 2)
    n = ctx.b["meta_" + n_lane]
    L = arr.shape[1]
    live = torch.arange(L, dtype=torch.int32, device=ctx.dev)[None, :] < n[:, None]
    hit = ctx.false(tuple(arr.shape[:2]))
    for v in value:
        hi, lo = split32(hash_str(v, tag=tag))
        hit = hit | ((arr[..., 0] == _i32(hi))
                     & (arr[..., 1] == _i32(lo)))
    mode = _IN_MODES[op]
    if mode == "any_in":
        return (live & hit).any(-1)
    if mode == "all_in":
        return (~live | hit).all(-1)
    if mode == "any_not_in":
        return (live & ~hit).any(-1)
    return (~live | ~hit).all(-1)  # all_not_in


def _eval_op_cond(ctx: Ctx, key: OpKey, op: str, value: Any) -> torch.Tensor:
    """request.operation comparisons: a per-resource vocabulary-code
    compare. The vocab covers the four admission ops plus any literal
    strings appearing in this condition."""
    vocab: Dict[str, int] = {}

    def code(s: str) -> int:
        if s not in vocab:
            vocab[s] = len(vocab)
        return vocab[s]

    for s in OP_CODES:
        code(s)
    # 0..4 per OP_CODES order of insertion
    op_lane = ctx.lift(ctx.b["meta_op_code"])
    present = op_lane != 0
    if key.default is not None:
        key_code = fold.where(present, op_lane, int(code(key.default)))
        key_present = ctx.true((ctx.N,))
    else:
        key_code = op_lane
        key_present = present
    if op in ("equals", "notequals"):
        if not isinstance(value, str):
            eq = ctx.false((ctx.N,))
        else:
            eq = key_present & (key_code == int(code(value)))
        return ~eq if op == "notequals" else eq
    if op in _IN_MODES:
        vals = value if isinstance(value, list) else [value]
        vcodes = [code(v) for v in vals if isinstance(v, str)]
        hit = ctx.false((ctx.N,))
        for vc in vcodes:
            hit = hit | (key_code == int(vc))
        hit = key_present & hit
        mode = _IN_MODES[op]
        # request.operation is a scalar string: deprecated In/NotIn
        # behave exactly like AnyIn/AnyNotIn on it
        if mode in ("any_in", "all_in", "in_strict"):
            return hit
        return key_present & ~hit
    # numeric on operation strings never succeeds
    return ctx.false((ctx.N,))


def _collect_masks(
    ctx: Ctx, pc: PathCollect, literals: List[Any], prefix: Tuple[str, ...] = ()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask, in_set) over rows for a projection collect; literal
    membership per row uses the sprint lane (value states) or key lane
    (keys() states). Works for ElementCollect too (same field shape)
    with the element prefix prepended."""
    lits = [go_sprint(v) for v in literals]
    lits = [l for l in lits if l is not None]
    sprint_set = [hash_str(l, tag="s") for l in lits]
    key_set = [hash_str(l, tag="k") for l in lits]
    mask = ctx.false((ctx.N, ctx.R))
    in_set = ctx.false((ctx.N, ctx.R))
    for st in pc.states:
        if st.mode == "keys":
            m = ctx.rows_with_parent(prefix + st.segs)
            s = ctx.hset("key", key_set)
        else:
            m = ctx.rows_at(prefix + st.segs)
            if st.no_arr:
                m = m & ~ctx.type_is(T_ARR)
            if st.no_null:
                m = m & ~ctx.type_is(T_NULL)
            s = ctx.hset("sprint", sprint_set)
        mask = mask | m
        in_set = in_set | (m & s)
    return mask, in_set


def _list_exists(ctx: Ctx, pc: PathCollect, scope, prefix: Tuple[str, ...] = ()) -> torch.Tensor:
    """Projection result is a list (vs null) when any root produces one."""
    ex = ctx.false(_cond_shape(ctx, scope))
    for segs, kind in pc.array_roots:
        m = ctx.rows_at(prefix + segs)
        if kind == "array":
            ex = ex | scope.any(ctx.typed(m, T_ARR))
        else:  # mselect: any non-null input yields a literal list
            ex = ex | scope.any(ctx.typed(m, T_NULL, neg=True))
    return ex


def _keys_errors(
    ctx: Ctx, states: List[PathState], scope, prefix: Tuple[str, ...] = ()
) -> torch.Tensor:
    """keys(@) on a non-object element is a JMESPath error -> rule ERROR."""
    err = ctx.false(_cond_shape(ctx, scope))
    for st in states:
        m = ctx.rows_at(prefix + st.segs)
        bad = ctx.type_is(T_BOOL) | ctx.type_is(T_NUM) | ctx.type_is(T_STR)
        if not st.no_arr:
            bad = bad | ctx.type_is(T_ARR)
        if not st.no_null:
            bad = bad | ctx.type_is(T_NULL)
        err = err | scope.any(m & bad)
    return err


def _scalar_falsy(ctx: Ctx, mask: torch.Tensor, scope) -> torch.Tensor:
    """JMESPath falsy for a scalar path value: missing/null/''/false/
    empty map/empty list."""
    exists = scope.any(mask)
    null = scope.any(ctx.typed(mask, T_NULL))
    empty_str = scope.any(mask & ctx.type_is(T_STR) & ctx.heq("repr", hash_str("", tag="s")))
    false_b = scope.any(mask & ctx.type_is(T_BOOL) & (ctx.b["bool_val"] == 0))
    empty_cont = scope.any(
        mask & (ctx.type_is(T_MAP) | ctx.type_is(T_ARR)) & (ctx.b["arr_len"] == 0)
    )
    return (~exists) | null | empty_str | false_b | empty_cont


def _scalar_membership_const(default: Any, literals: List[Any], mode: str) -> bool:
    """Host-computed membership result when the || default kicks in
    (exact conditions.py semantics via the scalar oracle)."""
    from ..engine.conditions import _deprecated_in, _membership
    from .ir import _NullDefault

    if isinstance(default, _NullDefault):
        default = None
    if mode in ("in_strict", "notin_strict"):
        return _deprecated_in(default, list(literals),
                              not_in=(mode == "notin_strict"))
    return _membership(default, literals, mode)


def _eval_path_cond(
    ctx: Ctx, pc: PathCollect, op: str, value: Any, scope=None, prefix: Tuple[str, ...] = ()
) -> Tuple[torch.Tensor, torch.Tensor]:
    scope = scope if scope is not None else Depth0(ctx)
    shape = _cond_shape(ctx, scope)
    err = _keys_errors(ctx, pc.keys_error_states, scope, prefix)
    # a bare {{ request.object... }} chain with NO || default raises
    # VariableNotFoundError when the path is absent (forked go-jmespath
    # behavior pinned by the reference corpus) -> rule ERROR. A null
    # VALUE is a present row (T_NULL) and does not error. not_null()
    # keys never error: the function absorbs missing paths.
    if (pc.default is None and pc.default_collect is None
            and not pc.default_null_only and not pc.is_projection
            and len(pc.states) == 1 and pc.states[0].mode == "value"):
        exists = scope.any(ctx.rows_at(prefix + pc.states[0].segs))
        err = err | ~exists
    if op in _IN_MODES:
        mode = _IN_MODES[op]
        literals = value if isinstance(value, list) else [value]
        if pc.is_projection:
            mask, in_set = _collect_masks(ctx, pc, literals, prefix)
            count = scope.count(mask)
            present = _list_exists(ctx, pc, scope, prefix)
            any_in = scope.any(in_set)
            any_not_in = scope.any(mask & ~in_set)
            res = {
                "any_in": any_in,
                "all_in": ~any_not_in,
                "any_not_in": any_not_in,
                "all_not_in": ~any_in,
            }[mode]
            res = present & res
            if pc.default is not None:
                falsy = (~present) | (count == 0)
                const = _scalar_membership_const(pc.default, literals, mode)
                res = fold.where(falsy, const, res)
            return res, err
        # scalar chain key
        st = pc.states[0]
        mask = ctx.rows_at(prefix + st.segs)
        lits = [go_sprint(v) for v in (value if isinstance(value, list) else [value])]
        sset = [hash_str(l, tag="s") for l in lits if l is not None]
        in_set = ctx.hset("sprint", sset)
        is_scalar = scope.any(mask & (ctx.type_is(T_STR) | ctx.type_is(T_NUM) | ctx.type_is(T_BOOL)))
        is_arr = scope.any(ctx.typed(mask, T_ARR))
        hit = scope.any(mask & in_set)
        em = ctx.rows_at(prefix + st.segs + (ARRAY_SEG,))
        e_any_in = scope.any(em & in_set)
        e_any_not = scope.any(em & ~in_set)
        # deprecated In/NotIn list-key strictness (in.go:35-43): any
        # non-string element makes the whole condition false
        e_nonstr = scope.any(ctx.typed(em, T_STR, neg=True))
        res = {
            "any_in": fold.where(is_arr, e_any_in, is_scalar & hit),
            "all_in": fold.where(is_arr, ~e_any_not, is_scalar & hit),
            "any_not_in": fold.where(is_arr, e_any_not, is_scalar & ~hit),
            "all_not_in": fold.where(is_arr, ~e_any_in, is_scalar & ~hit),
            "in_strict": fold.where(is_arr, ~e_any_not & ~e_nonstr,
                                  is_scalar & hit),
            "notin_strict": fold.where(is_arr, e_any_not & ~e_nonstr,
                                     is_scalar & ~hit),
        }[mode]
        if pc.default is not None:
            falsy = _default_falsy(ctx, pc, mask, scope)
            const = _scalar_membership_const(pc.default, value if isinstance(value, list) else [value], mode)
            res = fold.where(falsy, const, res)
        return res, err
    if op in ("equals", "notequals"):
        if pc.is_projection:
            # list-vs-literal deep equality: lists never equal scalars;
            # only list literals could match — unsupported at compile
            res = ctx.false(shape)
            return (~res if op == "notequals" else res), err
        res = _eval_scalar_eqop(ctx, pc, op, value, scope, prefix)
        res = _apply_scalar_default(
            ctx, pc, scope, prefix, res,
            lambda dpc: _eval_scalar_eqop(ctx, dpc, op, value, scope, prefix),
            lambda d: _const_cond(d, op, value))
        return res, err
    if op in _NUM_OPS:
        if pc.is_projection:
            return ctx.false(shape), err
        res = _eval_scalar_numeric(ctx, pc, _NUM_OPS[op], value, scope, prefix)
        res = _apply_scalar_default(
            ctx, pc, scope, prefix, res,
            lambda dpc: _eval_scalar_numeric(ctx, dpc, _NUM_OPS[op], value,
                                             scope, prefix),
            lambda d: _const_cond(d, op, value))
        return res, err
    return ctx.false(shape), err


def _const_cond(key: Any, op: str, value: Any) -> bool:
    """Host-folded condition on a constant key (the default arm)."""
    from ..engine.conditions import evaluate_condition_values
    from .ir import _NullDefault

    if isinstance(key, _NullDefault):
        key = None
    try:
        return bool(evaluate_condition_values(key, op, value))
    except Exception:  # noqa: BLE001
        return False


def _eval_scalar_eqop(ctx: Ctx, pc: PathCollect, op: str, value: Any,
                      scope, prefix: Tuple[str, ...]) -> torch.Tensor:
    """equals/notequals on a scalar chain, with the oracle's null-key
    rule: NotEquals on a nil/missing key is FALSE, not the negation
    (notequal.go:47-49 — unsupported key types evaluate false)."""
    res = _eval_scalar_equals(ctx, pc, value, scope, prefix)
    if op != "notequals":
        return res
    st = pc.states[0]
    mask = ctx.rows_at(prefix + st.segs)
    null_or_missing = (~scope.any(mask)) | scope.any(ctx.typed(mask, T_NULL))
    return ~res & ~null_or_missing


def _default_falsy(ctx: Ctx, pc: PathCollect, mask: torch.Tensor,
                   scope) -> torch.Tensor:
    """When does this key's default arm fire: jmespath `||` on any
    falsy value; not_null() on null/missing only."""
    if pc.default_null_only:
        exists = scope.any(mask)
        null = scope.any(ctx.typed(mask, T_NULL))
        return (~exists) | null
    return _scalar_falsy(ctx, mask, scope)


def _apply_scalar_default(ctx: Ctx, pc: PathCollect, scope,
                          prefix: Tuple[str, ...], res: torch.Tensor,
                          eval_chain, eval_const) -> torch.Tensor:
    """Route a scalar-chain key through its default arm (literal
    constant or not_null's second chain) where the primary chain is
    falsy/null."""
    if pc.default is None and pc.default_collect is None:
        return res
    mask = ctx.rows_at(prefix + pc.states[0].segs)
    falsy = _default_falsy(ctx, pc, mask, scope)
    if pc.default_collect is not None:
        alt = eval_chain(pc.default_collect)
    else:
        alt = ctx.full(res.shape, bool(eval_const(pc.default)))
    return fold.where(falsy, alt, res)


def _jcmp(kind: str, val, const: float, canon_eq) -> torch.Tensor:
    c = _f32(const)
    if kind == "ge":
        return (val > c) | canon_eq
    if kind == "le":
        return (val < c) | canon_eq
    if kind == "gt":
        return (val > c) & ~canon_eq
    return (val < c) & ~canon_eq


def _eval_scalar_equals(
    ctx: Ctx, pc: PathCollect, v: Any, scope=None, prefix: Tuple[str, ...] = ()
) -> torch.Tensor:
    scope = scope if scope is not None else Depth0(ctx)
    shape = _cond_shape(ctx, scope)
    st = pc.states[0]
    mask = ctx.rows_at(prefix + st.segs)
    b = ctx.b
    t_str = mask & ctx.type_is(T_STR)
    t_num = mask & ctx.type_is(T_NUM)
    t_bool = mask & ctx.type_is(T_BOOL)
    zero_repr = ctx.heq("repr", hash_str("0", tag="s"))
    key_d_valid = t_str & (b["has_dur"] == 1) & ~zero_repr

    if isinstance(v, bool):
        return scope.any(t_bool & (b["bool_val"] == (1 if v else 0)))
    if v is None:
        return ctx.false(shape)
    if isinstance(v, (int, float)):
        num_eq = scope.any(t_num & ctx.heq("num", canon_number(v)))
        dur_eq = scope.any(key_d_valid & ctx.heq("dur", canon_duration(int(float(v) * 1e9))))
        return num_eq | dur_eq
    if isinstance(v, str):
        vd = parse_duration(v) if v != "0" else None
        vq = parse_quantity(v)
        try:
            vf: Optional[float] = float(v)
        except ValueError:
            vf = None
        # string keys (equal.go:70-99): duration pair, then quantity
        # (no fallthrough), then exact/wildcard string compare
        if vd is not None:
            dur_eq_str = key_d_valid & ctx.heq("dur", canon_duration(vd))
            dur_proc_str = key_d_valid
        else:
            dur_eq_str = torch.zeros_like(mask)
            dur_proc_str = torch.zeros_like(mask)
        has_q = t_str & (b["has_qty"] == 1)
        qty_eq = (has_q & ctx.heq("qty", canon_quantity(vq))) if vq is not None \
            else torch.zeros_like(mask)
        exact = ctx.heq("repr", hash_str(v, tag="s"))
        str_eq = torch.where(
            dur_proc_str, dur_eq_str, torch.where(has_q, qty_eq, t_str & exact)
        )
        # numeric keys only try float(value) (equal.go _equals_number)
        if vf is not None:
            num_eq = t_num & ctx.heq("num", canon_number(float(vf)))
        else:
            num_eq = torch.zeros_like(mask)
        return scope.any((t_str & str_eq) | num_eq)
    return ctx.false(shape)


def _eval_scalar_numeric(
    ctx: Ctx, pc: PathCollect, kind: str, v: Any, scope=None, prefix: Tuple[str, ...] = ()
) -> torch.Tensor:
    scope = scope if scope is not None else Depth0(ctx)
    shape = _cond_shape(ctx, scope)
    st = pc.states[0]
    mask = ctx.rows_at(prefix + st.segs)
    b = ctx.b
    t_str = mask & ctx.type_is(T_STR)
    t_num = mask & ctx.type_is(T_NUM)
    zero_repr = ctx.heq("repr", hash_str("0", tag="s"))
    key_d_valid = t_str & (b["has_dur"] == 1) & ~zero_repr
    z = torch.zeros_like(mask)

    if isinstance(v, bool) or v is None or isinstance(v, (list, dict)):
        return ctx.false(shape)
    if isinstance(v, (int, float)):
        num_cmp = t_num & _jcmp(kind, b["num_val"], float(v), ctx.heq("num", canon_number(v)))
        dur_cmp = key_d_valid & _jcmp(
            kind, b["dur_val"], float(v), ctx.heq("dur", canon_duration(int(float(v) * 1e9))))
        lane_num = t_str & (b["has_num"] == 1) & _jcmp(
            kind, b["num_val"], float(v), ctx.heq("num", canon_number(v)))
        str_cmp = torch.where(key_d_valid, dur_cmp, lane_num)
        return scope.any(num_cmp | (t_str & str_cmp))
    # v is str
    vd = parse_duration(v) if v != "0" else None
    vq = parse_quantity(v)
    try:
        vf: Optional[float] = float(v)
    except ValueError:
        vf = None
    num_key = z
    if vd is not None:
        num_key = t_num & _jcmp(kind, b["num_val"] * _f32(1e9), float(vd),
                                ctx.heq("dur", canon_duration(vd)))
    elif vf is not None:
        num_key = t_num & _jcmp(kind, b["num_val"], vf, ctx.heq("num", canon_number(float(vf))))
    # string key trial order: duration pair, quantity, float lane
    dur_b = z
    if vd is not None:
        dur_b = key_d_valid & _jcmp(kind, b["dur_val"], vd / 1e9, ctx.heq("dur", canon_duration(vd)))
    qty_b = z
    if vq is not None:
        qty_b = t_str & (b["has_qty"] == 1) & _jcmp(
            kind, b["qty_val"], float(vq), ctx.heq("qty", canon_quantity(vq)))
    flt_b = z
    if vf is not None:
        flt_b = t_str & (b["has_num"] == 1) & _jcmp(
            kind, b["num_val"], vf, ctx.heq("num", canon_number(float(vf))))
    dur_proc = key_d_valid if vd is not None else z
    qty_proc = (t_str & (b["has_qty"] == 1)) if vq is not None else z
    str_key = torch.where(dur_proc, dur_b, torch.where(qty_proc, qty_b, flt_b))
    return scope.any(num_key | str_key)


# ---------------------------------------------------------------------------
# match / exclude program (MatchesResourceDescription, match.go:168)


def _meta_heq(ctx: Ctx, lane: str, s: str, tag: str):
    hi, lo = split32(hash_str(s, tag=tag))
    l = ctx.b["meta_" + lane]
    return (ctx.lift(l[..., 0]) == _i32(hi)) & (ctx.lift(l[..., 1]) == _i32(lo))


def _pairs_any(ctx: Ctx, kh_lane: str, vh_lane: str, n_lane: str,
               k: Optional[str], v: Optional[str], ktag: str, vtag: str) -> torch.Tensor:
    """Any (key, value) pair matching; None key/value = wildcard slot."""
    kh = ctx.b["meta_" + kh_lane]  # (N, L, 2)
    vh = ctx.b["meta_" + vh_lane]
    n = ctx.b["meta_" + n_lane]
    L = kh.shape[1]
    live = torch.arange(L, dtype=torch.int32, device=ctx.dev)[None, :] < n[:, None]
    acc = live
    if k is not None:
        hi, lo = split32(hash_str(k, tag=ktag))
        acc = acc & (kh[..., 0] == _i32(hi)) & (kh[..., 1] == _i32(lo))
    if v is not None:
        hi, lo = split32(hash_str(v, tag=vtag))
        acc = acc & (vh[..., 0] == _i32(hi)) & (vh[..., 1] == _i32(lo))
    return acc.any(dim=-1)


def _glob_or_eq(ctx: Ctx, pattern: str, which: str, hash_lane: str, tag: str) -> torch.Tensor:
    from ..utils.wildcard import contains_wildcard

    if contains_wildcard(pattern):
        return ctx.glob_meta(pattern, which)
    return _meta_heq(ctx, hash_lane, pattern, tag)


def _eval_selector(ctx: Ctx, sel, kh_lane: str, vh_lane: str, n_lane: str) -> torch.Tensor:
    if sel.invalid:
        return ctx.false((ctx.N,))
    ok = ctx.true((ctx.N,))
    for k, v in sel.match_labels:
        ok = ok & _pairs_any(ctx, kh_lane, vh_lane, n_lane, k, v, "lk", "lv")
    for k_pat, v_pat in getattr(sel, "wild_labels", ()):
        # CheckSelector wildcard expansion: a label pair glob-matching
        # (k_pat, v_pat) satisfies the entry. The '0'-substitution
        # fallback pair is subsumed: the glob itself matches its own
        # '0'-substitution, so no separate exact term is needed
        # (wildcards.go:14 ReplaceInSelector)
        ok = ok & _label_glob_pair_any(ctx, n_lane, k_pat, v_pat)
    for key, op, values in sel.expressions:
        if op == "In":
            hit = ctx.false((ctx.N,))
            for v in values:
                hit = hit | _pairs_any(ctx, kh_lane, vh_lane, n_lane, key, v, "lk", "lv")
            ok = ok & hit
        elif op == "NotIn":
            hit = ctx.false((ctx.N,))
            for v in values:
                hit = hit | _pairs_any(ctx, kh_lane, vh_lane, n_lane, key, v, "lk", "lv")
            ok = ok & ~hit
        elif op == "Exists":
            ok = ok & _pairs_any(ctx, kh_lane, vh_lane, n_lane, key, None, "lk", "lv")
        elif op == "DoesNotExist":
            ok = ok & ~_pairs_any(ctx, kh_lane, vh_lane, n_lane, key, None, "lk", "lv")
        else:
            ok = ctx.false((ctx.N,))
    return ok


def _label_glob_pair_any(ctx: Ctx, n_lane: str, k_pat: str, v_pat: str) -> torch.Tensor:
    """Any live label slot whose KEY bytes glob-match k_pat AND VALUE
    bytes glob-match v_pat (resource label byte lanes). Literal
    patterns degrade to exact byte equality via the same tables."""
    n = ctx.b["meta_" + n_lane]
    k_acc, k_conf = ctx._accept_confirm_cached("glob", k_pat, "labels_kb")
    v_acc, v_conf = ctx._accept_confirm_cached("glob", v_pat, "labels_vb")
    L = k_acc.shape[1]
    live = torch.arange(L, dtype=torch.int32, device=ctx.dev)[None, :] < n[:, None]
    for conf in (k_conf, v_conf):
        if conf is not None:
            ctx.confirm_acc.append((conf & live).any(-1))
    return (k_acc & v_acc & live).any(-1)


def _hash_in_lanes(ctx: Ctx, lane: str, n_lane: str, values: List[str], tag: str) -> torch.Tensor:
    """Any of the per-resource hash slots equals any of the values."""
    arr = ctx.b["meta_" + lane]  # (N, L, 2)
    n = ctx.b["meta_" + n_lane]
    L = arr.shape[1]
    live = torch.arange(L, dtype=torch.int32, device=ctx.dev)[None, :] < n[:, None]
    acc = ctx.false((ctx.N,))
    for v in values:
        hi, lo = split32(hash_str(v, tag=tag))
        acc = acc | (live & (arr[..., 0] == _i32(hi)) & (arr[..., 1] == _i32(lo))).any(-1)
    return acc


def _eval_condition_block(ctx: Ctx, f: FilterIR, with_user: bool) -> torch.Tensor:
    """doesResourceMatchConditionBlock (match.go:52): AND across
    attributes, OR within list attributes."""
    ok = ctx.true((ctx.N,))
    if f.operations:
        codes = [OP_CODES.get(o, -1) for o in f.operations]
        # background scans evaluate as CREATE (the scalar engine default)
        op_lane = ctx.lift(ctx.b["meta_op_code"])
        eff = fold.where(op_lane == 0, int(OP_CODES["CREATE"]), op_lane)
        hit = ctx.false((ctx.N,))
        for c in codes:
            hit = hit | (eff == int(c))
        ok = ok & hit
    if f.kinds:
        hit = ctx.false((ctx.N,))
        for ks in f.kinds:
            p = ctx.true((ctx.N,))
            if ks.group != "*":
                p = p & _meta_heq(ctx, "group_h", ks.group, "g")
            if ks.version != "*":
                p = p & _meta_heq(ctx, "version_h", ks.version, "v")
            if ks.kind != "*":
                p = p & _meta_heq(ctx, "kind_h", ks.kind, "K")
            if ks.sub not in ("", "*"):
                p = p & False  # background scans carry no subresource
            hit = hit | p
        ok = ok & hit
    if f.name:
        ok = ok & _glob_or_eq(ctx, f.name, "name", "name_h", "m")
    if f.names:
        ok = ok & ctx.meta_any("names", f.names)
    if f.namespaces:
        # Namespace-kind resources compare their name (match.go:18-31)
        ok = ok & ctx.meta_any("namespaces", f.namespaces)
    if f.annotations:
        for k, v in f.annotations:
            ok = ok & _pairs_any(ctx, "ann_kh", "ann_vh", "ann_n", k, v, "ak", "av")
    if f.selector is not None:
        ok = ok & _eval_selector(ctx, f.selector, "labels_kh", "labels_vh", "labels_n")
    if f.ns_selector is not None:
        is_ns = ctx.b["meta_is_namespace_kind"] == 1
        sel_ok = _eval_selector(ctx, f.ns_selector, "nsl_kh", "nsl_vh", "nsl_n")
        ok = ok & ~is_ns & sel_ok
    if with_user:
        if f.roles:
            ok = ok & _hash_in_lanes(ctx, "roles_h", "roles_n", f.roles, "r")
        if f.cluster_roles:
            ok = ok & _hash_in_lanes(ctx, "croles_h", "croles_n", f.cluster_roles, "r")
        if f.subjects:
            hit = ctx.false((ctx.N,))
            for s in f.subjects:
                kind, name = s.get("kind"), s.get("name", "")
                if kind == "ServiceAccount":
                    uname = f"system:serviceaccount:{s.get('namespace', '')}:{name}"
                    hit = hit | _meta_heq(ctx, "user_h", uname, "u")
                elif kind == "User":
                    hit = hit | _meta_heq(ctx, "user_h", name, "u")
                else:  # Group
                    hit = hit | _hash_in_lanes(ctx, "groups_h", "groups_n", [name], "u")
            ok = ok & hit
    return ok


def _eval_match_filter(ctx: Ctx, f: FilterIR) -> torch.Tensor:
    """_match_helper (match.go:253): empty-admission requests drop user
    constraints; fully-empty filters never match."""
    adm_empty = ctx.lift(ctx.b["meta_admission_empty"]) == 1
    with_user = _eval_condition_block(ctx, f, with_user=True)
    without_user = _eval_condition_block(ctx, f, with_user=False)
    empty_bg = f.resources_empty           # user dropped => match cannot be empty
    empty_adm = f.resources_empty and f.user_empty
    bg = ctx.false((ctx.N,)) if empty_bg else without_user
    adm = ctx.false((ctx.N,)) if empty_adm else with_user
    return fold.where(adm_empty, bg, adm)


def _eval_exclude_filter(ctx: Ctx, f: FilterIR) -> torch.Tensor:
    """_exclude_helper (match.go:278): empty excludes nothing; user
    constraints always evaluated (empty admission naturally fails them)."""
    if f.resources_empty and f.user_empty:
        return ctx.false((ctx.N,))
    return _eval_condition_block(ctx, f, with_user=True)


def eval_match(ctx: Ctx, match: MatchIR, exclude: MatchIR, policy_ns: str) -> torch.Tensor:
    if match.mode == "any":
        m = ctx.false((ctx.N,))
        for f in match.filters:
            m = m | _eval_match_filter(ctx, f)
    else:  # all | legacy
        m = ctx.true((ctx.N,))
        for f in match.filters:
            m = m & _eval_match_filter(ctx, f)
    if policy_ns:
        m = m & _meta_heq(ctx, "ns_h", policy_ns, "N")
    if exclude.mode == "any":
        e = ctx.false((ctx.N,))
        for f in exclude.filters:
            e = e | _eval_exclude_filter(ctx, f)
    elif exclude.mode == "all":
        e = ctx.true((ctx.N,))
        for f in exclude.filters:
            e = e & _eval_exclude_filter(ctx, f)
    else:
        e = _eval_exclude_filter(ctx, exclude.filters[0])
    return m & ~e


# ---------------------------------------------------------------------------
# rule & policy-set assembly


def _membership_glob_states(prog: RuleProgram) -> List[Tuple[Tuple[str, ...], PathState]]:
    """All (prefix, state) value/key cells that membership operators
    compare against literal sets. Resource strings containing */? at
    those cells wildcard-match in BOTH directions (conditions.py
    _wild_either) — hash equality cannot reproduce that, so such
    resources take the host path."""
    out: List[Tuple[Tuple[str, ...], PathState]] = []

    def add(collect, prefixes) -> None:
        for pfx in prefixes:
            for st in collect.states:
                out.append((pfx, st))
                if not collect.is_projection and st.mode == "value":
                    # scalar-chain keys also compare array elements
                    out.append((pfx, PathState(st.segs + (ARRAY_SEG,), "value")))

    def from_tree(tree: Optional[CondTreeIR], eprefixes) -> None:
        if tree is None:
            return
        for any_list, all_list in tree.blocks:
            for c in any_list + all_list:
                if _op_canon(c.op) not in _IN_MODES:
                    continue
                for side in (c.key, c.value):
                    if isinstance(side, ElementCollect):
                        add(side, eprefixes)
                    elif isinstance(side, PathCollect):
                        add(side, ((),))

    from_tree(prog.preconditions, ((),))
    from_tree(prog.deny, ((),))
    for fe in prog.foreach:
        prefixes = tuple(arr + (ARRAY_SEG,) for arr in fe.arrays)
        from_tree(fe.tree, prefixes)
    return out


def _glob_fallback(ctx: Ctx, prog: RuleProgram) -> torch.Tensor:
    acc = ctx.false((ctx.N,))
    for pfx, st in _membership_glob_states(prog):
        if st.mode == "keys":
            m = ctx.rows_with_parent(pfx + st.segs) & (ctx.b["key_glob"] == 1)
        else:
            m = ctx.rows_at(pfx + st.segs) & (ctx.b["has_glob"] == 1)
        acc = acc | m.any(dim=-1)
    return acc


def _eval_foreach_deny(
    ctx: Ctx, prog: RuleProgram
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """validate.foreach with deny bodies (validate_resource.go:163-233):
    elements iterate in list order; the first denied element fails the
    rule, a condition error errors it, zero applied (non-null) elements
    skips it. Returns (cls, err, host) each (N,)."""
    inst = InstScope(ctx)
    decided = ctx.false((ctx.N,))
    failed = ctx.false((ctx.N,))
    errored = ctx.false((ctx.N,))
    applied = ctx.false((ctx.N,))
    host = ctx.false((ctx.N,))
    for fe in prog.foreach:
        for arr in fe.arrays:
            arr_rows = ctx.rows_at(arr)
            elem_rows = ctx.rows_at(arr + (ARRAY_SEG,))
            # scalar iterates dict lists as {key,value} pairs and errors
            # on scalar lists; flatten would splice array elements — all
            # shapes the row encoding can't see, so those go host
            bad = arr_rows & ~ctx.type_is(T_ARR) & ~ctx.type_is(T_NULL)
            bad = bad | (elem_rows & ctx.type_is(T_ARR))
            host = host | bad.any(dim=-1)
            nonnull_i = inst.any(ctx.typed(elem_rows, T_NULL, neg=True))  # (N, I)
            den_i, err_i = eval_cond_tree(ctx, fe.tree, inst, arr + (ARRAY_SEG,))
            den_i = den_i & nonnull_i
            err_i = err_i & nonnull_i
            # first-event ordering along the element axis: an error at
            # element j <= i pre-empts a deny at i (evaluate_conditions
            # raises before returning); a deny at j < i pre-empts an
            # error at i (the loop returned already)
            err_incl = fold.scan_or(err_i)
            den_excl = fold.scan_or(den_i, exclusive=True)
            deny_event = (den_i & ~err_incl).any(dim=-1)
            err_event = (err_i & ~den_excl).any(dim=-1)
            failed = failed | (~decided & deny_event)
            errored = errored | (~decided & err_event)
            decided = decided | deny_event | err_event
            applied = applied | nonnull_i.any(dim=-1)
    cls = fold.where(failed, FAIL, fold.where(applied, PASS, SKIP))
    return cls, errored, host


# ---------------------------------------------------------------------------
# validate.cel (the matches() subset, ir.compile_cel_validation)


def _eval_cel_node(ctx: Ctx, node: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """CEL three-valued evaluation over (N,) lanes: (val, err) with the
    invariant val is False wherever err — mirroring cel/interp.py
    semantics for the lowered subset, including &&/|| error absorption
    (_logic: a determined operand absorbs the other side's error)."""
    shape = (ctx.N,)
    if isinstance(node, CelConst):
        return ctx.full(shape, bool(node.value)), ctx.false(shape)
    if isinstance(node, CelNot):
        v, e = _eval_cel_node(ctx, node.sub)
        return ~v & ~e, e
    if isinstance(node, CelAnd):
        lv, le = _eval_cel_node(ctx, node.left)
        rv, re_ = _eval_cel_node(ctx, node.right)
        lfalse = ~lv & ~le
        rfalse = ~rv & ~re_
        return lv & rv, (le | re_) & ~lfalse & ~rfalse
    if isinstance(node, CelOr):
        lv, le = _eval_cel_node(ctx, node.left)
        rv, re_ = _eval_cel_node(ctx, node.right)
        val = lv | rv
        return val, (le | re_) & ~val
    if isinstance(node, CelStrCmp):
        mask = ctx.rows_at(node.path)
        exists = ctx.row_any(mask)
        eq = ctx.row_any(mask & ctx.type_is(T_STR)
                         & ctx.heq("repr", hash_str(node.value, tag="s")))
        # select on a missing path is no_such_field; heterogeneous
        # equality on a present non-string is false, never an error
        err = ~exists
        val = (exists & ~eq) if node.negate else eq
        return val & ~err, err
    if isinstance(node, CelHas):
        prows = ctx.rows_at(node.parent)
        is_map = ctx.row_any(prows & ctx.type_is(T_MAP))
        child = ctx.row_any(ctx.rows_at(node.parent + (node.fld,)))
        # has() on a missing/non-map target is a CEL error
        return is_map & child, ~is_map
    if isinstance(node, CelMatches):
        mask = ctx.rows_at(node.path)
        str_rows = mask & ctx.type_is(T_STR)
        is_str = ctx.row_any(str_rows)
        got = ctx._bank_lookup("re2", node.regex, "pool")
        if got is None:
            # compiled without a bank (legacy build_program callers):
            # the whole cell resolves on the host
            ctx.host_acc.append(ctx.true(shape))
            return ctx.false(shape), ctx.false(shape)
        acc, conf = ctx._accept_confirm_cached("re2", node.regex, "pool")
        hit = ctx.row_any(str_rows & ctx._rows_from_pool(acc))
        if conf is not None:
            ctx.confirm_acc.append(
                (str_rows & ctx._rows_from_pool(conf)).any(dim=-1))
        # matches() on a non-string / missing target is a CEL error
        err = ~is_str
        return hit & ~err, err
    raise Unsupported(f"cel IR node {type(node).__name__}")


def _eval_cel_rule(ctx: Ctx, prog: RuleProgram
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All expressions must hold; any expression error is a rule ERROR
    (engine._validate_cel orders errors before fails). DELETE
    admissions divert per cell to the host — the skip-on-delete guard
    depends on request state the lanes don't carry."""
    from .metadata import OP_CODES as _OPS

    ok = ctx.true((ctx.N,))
    err = ctx.false((ctx.N,))
    for node in prog.cel:
        v, e = _eval_cel_node(ctx, node)
        ok = ok & v
        err = err | e
    ctx.host_acc.append(
        ctx.lift(ctx.b["meta_op_code"]) == int(_OPS["DELETE"]))
    return fold.where(ok, PASS, FAIL), err


def eval_rule(ctx: Ctx, prog: RuleProgram):
    """The rule's (N,) verdict codes: a value of its tape (``ctx.fold``,
    which ``build_program`` sets and runs), or an int32 tensor when no
    tape is being recorded."""
    ctx.host_acc = []
    ctx.confirm_acc = []
    matched = eval_match(ctx, prog.match, prog.exclude, prog.policy_namespace)
    pre_ok, pre_err = eval_cond_tree(ctx, prog.preconditions)
    host_extra = ctx.false((ctx.N,))
    if prog.kind == "deny":
        denied, deny_err = eval_cond_tree(ctx, prog.deny)
        cls = fold.where(denied, FAIL, PASS)
        err = deny_err
    elif prog.kind == "pattern":
        cls = eval_node(ctx, Depth0(ctx), prog.patterns[0])
        err = ctx.false((ctx.N,))
    elif prog.kind == "foreach_deny":
        cls, err, host_extra = _eval_foreach_deny(ctx, prog)
    elif prog.kind == "cel":
        cls, err = _eval_cel_rule(ctx, prog)
    else:  # any_pattern (validate_resource.go:382)
        classes = [eval_node(ctx, Depth0(ctx), p) for p in prog.patterns]
        any_pass = fold.any_of([c == PASS for c in classes])
        any_skip = fold.any_of([c == SKIP for c in classes])
        any_fail = fold.any_of([c == FAIL for c in classes])
        cls = fold.where(any_pass, PASS, fold.where(any_skip & ~any_fail, SKIP, FAIL))
        err = ctx.false((ctx.N,))
    verdict = fold.where(err, ERROR, cls)
    verdict = fold.where(pre_err, ERROR, fold.where(pre_ok, verdict, SKIP))
    verdict = fold.where(matched, verdict, NOT_MATCHED)
    # pattern confirmation (tpu/dfa.py ladder): cells whose pattern
    # verdict is a maybe resolve via the scalar oracle like host cells,
    # but are attributed separately (miss = definitive, hit = confirm)
    if ctx.confirm_acc:
        confirm = fold.any_of([ctx.lift(c) if isinstance(c, torch.Tensor)
                               else c for c in ctx.confirm_acc])
        verdict = fold.where(confirm, CONFIRM, verdict)
    fallback = (ctx.lift(ctx.b["fallback"]) == 1) \
        | (ctx.lift(ctx.b["meta_fallback"]) == 1)
    fallback = fallback | host_extra | _glob_fallback(ctx, prog)
    for h in ctx.host_acc:
        fallback = fallback | h
    return fold.where(fallback, HOST, verdict)



def build_program(programs: Sequence[RuleProgram], max_instances: int,
                  dfa: Optional[DfaBank] = None,
                  plain: bool = False,
                  verdicts_u8: bool = False,
                  with_counts: bool = True,
                  nfa_globs: Optional[Dict[str, List[str]]] = None
                  ) -> Callable:
    """Returns fn(batch dict of tensors) -> ((num_rules, N) int32 table,
    (num_rules, NUM_VERDICT_CLASSES) int32 counts) — the reference's
    ``build_program(..., with_counts=True)``. The counts are kernel K4
    (its plain twin with ``plain=True`` or on the CPU). With
    ``verdicts_u8`` the table comes back as uint8, written by K4 in the
    same pass as the counts (the background scan's step,
    kyverno_tpu/parallel/sharding.py:101-111). With ``with_counts``
    False it returns the int32 table alone (the mutate bank's triage
    program). Dense and vocabulary (``row_idx``) batches both run.
    ``nfa_globs`` holds each lane family's globs the bank refused (the
    compiler's record, ``CompiledPolicySet.nfa_globs``): K9 runs each
    family's in one packed launch a batch. Each rule's row of the table
    is written by one K11 launch of the rule's tape (``tpu/fold.py``),
    compiled once per program and kept in the returned function's
    ``fold_cache``. The returned function's ``stats`` sums its runs'
    Ctx counters (``STAT_KEYS``)."""

    hash_consts: Dict[Any, torch.Tensor] = {}
    meta_tables: Dict[Any, Any] = {}
    bank_cols = bank_columns(dfa)
    nfa = NfaPacks(nfa_globs or {})
    # each rule's compiled tape (K11's instructions), kept as the K6
    # constants and K10 tables are
    fold_cache = fold.FoldCache()
    stats = dict.fromkeys(STAT_KEYS, 0)

    def run(batch: Dict[str, torch.Tensor]):
        ctx = Ctx(densify(batch, plain=plain), max_instances, dfa=dfa,
                  plain=plain, hash_consts=hash_consts, nfa=nfa,
                  bank_cols=bank_cols, meta_tables=meta_tables)
        table = torch.empty((len(programs), ctx.N), dtype=torch.int32,
                            device=ctx.dev)
        # each rule's class logic is recorded on its tape and runs as
        # one K11 launch writing its row of the table
        for r, p in enumerate(programs):
            ctx.fold = fold.Tape(ctx.N, ctx.I, ctx.I, ctx.dev, fold_cache,
                                 plain, ctx.stats)
            ctx.fold.run([eval_rule(ctx, p)], [table[r]])
        ctx.fold = None
        for k, v in ctx.stats.items():
            stats[k] += v
        if not with_counts:
            return table
        if verdicts_u8:
            return kernels.verdict_counts_u8_plain(table) if plain \
                else kernels.verdict_counts_u8(table)
        counts = kernels.verdict_counts_plain(table) if plain \
            else kernels.verdict_counts(table)
        return table, counts

    run.stats = stats  # the Ctx counters (STAT_KEYS) of all its runs
    run.fold_cache = fold_cache
    return run
