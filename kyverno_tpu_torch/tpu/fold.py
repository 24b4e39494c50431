"""The class-logic tape of a rule: what kernel K11 ``class_fold`` runs.

A rule's verdict is a fold of per-node classes (PASS/SKIP/FAIL, ...)
and flags over (N,) resources, (N, I) array instances and (N, I, J)
nested instances: ``where`` chains, compares to a class, ANDs and ORs
of reduction results, first-non-pass folds and any-over-instance
reductions (kyverno_tpu/tpu/evaluator.py, traced by ``jax.jit`` and
fused by XLA into a few kernels). Issued as torch operations, that logic
is ~18,400 small kernels a dense PSS run. Here the evaluator's walk over
the IR stays in Python as before, but its class-logic steps record
instructions on a ``Tape`` instead of issuing torch operations, and the
rule's whole tape runs as ONE launch of K11 (or of its plain twin on
the CPU), which writes the rule's row of the verdict table.

- **Values** are ``FV`` handles: a shape kind (``N``, ``NI``, ``NIJ``)
  and a dtype (bool, or int32 for classes and counts). ``&``, ``|``,
  ``~``, ``==`` and ``!=`` record; so do ``where``, ``first_nonpass``,
  ``any_last``/``all_last`` (NI -> N, NIJ -> NI; also ``.any(dim=-1)``),
  ``expand`` (N -> NI) and ``scan_or`` (a prefix OR over instances).
- **Inputs** are tensors already on the device, taken by reference
  (pointer and strides, no copy): K3's counts, Depth0 reductions, K8-K10
  outputs, lanes such as ``meta_op_code`` and ``fallback``.
- **Shapes never broadcast implicitly**: an operand of another kind
  raises ``KindError`` when the instruction is recorded. A Python
  scalar takes the kind of the other operands.
- **Escapes**: a handle that reaches a torch function outside the tape
  is materialized (its cone of instructions runs as a launch of its
  own) and counted in the program's ``stats["fold_forced"]``.

Recording folds constants and merges identical instructions (XLA's
CSE). ``compile_tape`` turns a recorded tape into ``kernels.FoldCode``
segments: only the cone of the outputs, inputs loaded just before
their first use, value slots allocated by liveness, and a tape whose
inputs and outputs overflow K11's parameter block (``kernels.
CLASS_FOLD_MAX_IO``) split at a value boundary into launches that hand
their live values on through scratch tensors. The compiled segments of
a tape depend only on its instructions, not on N: ``FoldCache`` keeps
them with the program, built at a bucket's first (eager) call, so a
CUDA-graph capture only reads them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels

N_, NI, NIJ = 0, 1, 2
KIND_NAMES = ("N", "NI", "NIJ")
BOOL, INT = 0, 1

# opcodes, as csrc/class_fold.cu decodes them
(OP_LOAD, OP_CONST, OP_NOT, OP_AND, OP_OR, OP_EQC, OP_NEC, OP_EQ, OP_WHERE,
 OP_FNP, OP_ANY, OP_ALL, OP_EXPAND, OP_SCAN, OP_SCANX, OP_STORE,
 OP_LOADJ) = range(17)
# outside values a load instruction reads together (kLoadGroup)
LOAD_GROUP = 8

_COMMUTATIVE = (OP_AND, OP_OR, OP_EQ)


class KindError(ValueError):
    """Operands of different shape kinds met in one instruction."""


class FV:
    """A value on a rule's tape (see the module docstring)."""

    __slots__ = ("tape", "vid", "kind", "dtype")

    def __init__(self, tape: "Tape", vid: int, kind: int, dtype: int):
        self.tape, self.vid, self.kind, self.dtype = tape, vid, kind, dtype

    # -- recorded operators
    def __and__(self, o):
        return self.tape.logic(OP_AND, self, o)

    __rand__ = __and__

    def __or__(self, o):
        return self.tape.logic(OP_OR, self, o)

    __ror__ = __or__

    def __invert__(self):
        return self.tape.not_(self)

    def __eq__(self, o):  # type: ignore[override]
        return self.tape.compare(OP_EQC, self, o)

    def __ne__(self, o):  # type: ignore[override]
        return self.tape.compare(OP_NEC, self, o)

    __hash__ = object.__hash__

    def any(self, dim: int = -1) -> "FV":
        _last(dim, self)
        return self.tape.reduce(OP_ANY, self)

    def all(self, dim: int = -1) -> "FV":
        _last(dim, self)
        return self.tape.reduce(OP_ALL, self)

    def __bool__(self):
        raise TypeError("a tape value has no host truth value (the program "
                        "takes no data-dependent Python branch)")

    # -- what torch code may read
    @property
    def shape(self) -> Tuple[int, ...]:
        t = self.tape
        return ((t.N,), (t.N, t.I), (t.N, t.I, t.J))[self.kind]

    @property
    def ndim(self) -> int:
        return self.kind + 1

    @property
    def device(self):
        return self.tape.dev

    def force(self) -> torch.Tensor:
        return self.tape.force(self)

    # -- a torch function on a handle: the logical operators record, any
    # other function materializes its handles first (counted)
    _RECORDED = {"__and__", "__rand__", "__or__", "__ror__", "__invert__",
                 "__eq__", "__ne__", "eq", "ne", "logical_and", "logical_or"}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in cls._RECORDED and not kwargs and len(args) in (1, 2):
            t = next(a for a in args if isinstance(a, FV)).tape
            if name == "__invert__":
                return t.not_(args[0])
            a, b = args
            if name in ("__eq__", "__ne__", "eq", "ne"):
                op = OP_EQC if "eq" in name else OP_NEC
                return t.compare(op, *((a, b) if isinstance(a, FV)
                                       else (b, a)))
            return t.logic(OP_AND if "and" in name else OP_OR, a, b)
        return func(*_forced(args), **_forced(kwargs))


def _forced(x):
    """``x`` with every tape value in it materialized."""
    if isinstance(x, FV):
        return x.force()
    if isinstance(x, (list, tuple)):
        return type(x)(_forced(a) for a in x)
    if isinstance(x, dict):
        return {k: _forced(v) for k, v in x.items()}
    return x


def _last(dim: int, v: FV) -> None:
    if dim not in (-1, v.kind):
        raise KindError(f"a reduction over dim {dim} of a {KIND_NAMES[v.kind]}"
                        " value; only the last axis folds")


class Tape:
    """One rule's recorded class logic (module docstring). ``stats`` is
    the Ctx's counter dict (``fold_forced``)."""

    def __init__(self, N: int, I: int, J: int, device,
                 cache: "FoldCache", plain: bool,
                 stats: Optional[Dict[str, int]] = None):
        self.N, self.I, self.J = N, I, J
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.dev = dev
        self.cache = cache
        self.plain = plain
        self.stats = stats if stats is not None else {}
        self.code: List[Tuple[int, ...]] = []
        self._memo: Dict[Tuple[int, ...], FV] = {}
        self.consts: Dict[int, int] = {}  # vid -> value of a CONST
        self.inputs: List[torch.Tensor] = []
        self._in: Dict[Tuple, FV] = {}

    # -- recording
    def _emit(self, op: int, kind: int, dtype: int, a: int = 0, b: int = 0,
              c: int = 0) -> FV:
        if op in _COMMUTATIVE and a > b:
            a, b = b, a
        ins = (op, kind, dtype, a, b, c)
        got = self._memo.get(ins)
        if got is None:
            got = self._memo[ins] = FV(self, len(self.code), kind, dtype)
            self.code.append(ins)
            if op == OP_CONST:
                self.consts[got.vid] = a
        return got

    def kind_of(self, shape) -> int:
        shape = tuple(shape)
        want = ((self.N,), (self.N, self.I), (self.N, self.I, self.J))
        if len(shape) not in (1, 2, 3) or shape != want[len(shape) - 1]:
            raise KindError(f"shape {shape} is no class shape of this batch "
                            f"(N={self.N}, I={self.I}, J={self.J})")
        return len(shape) - 1

    def const(self, value, shape_or_kind, dtype: Optional[int] = None) -> FV:
        kind = shape_or_kind if isinstance(shape_or_kind, int) \
            else self.kind_of(shape_or_kind)
        if dtype is None:
            dtype = BOOL if isinstance(value, (bool, np.bool_)) else INT
        return self._emit(OP_CONST, kind, dtype, int(value))

    def input(self, t: torch.Tensor) -> FV:
        """A tensor on the device as a tape input, by reference (the same
        memory, shape and strides give the same input)."""
        if t.device != self.dev:
            raise ValueError(f"tape input on {t.device}, tape on {self.dev}")
        kind = self.kind_of(t.shape)
        if t.dtype not in (torch.bool, torch.uint8, torch.int32):
            t = t.to(torch.int32)
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)
        got = self._in.get(key)
        if got is None:
            self.inputs.append(t)
            got = self._in[key] = self._emit(
                OP_LOAD, kind, BOOL if t.dtype == torch.bool else INT,
                len(self.inputs) - 1)
        return got

    def wrap(self, x, kind: Optional[int] = None) -> FV:
        if isinstance(x, FV):
            if x.tape is not self:
                raise ValueError("a value of another rule's tape")
            v = x
        elif isinstance(x, torch.Tensor):
            v = self.input(x)
        elif isinstance(x, (bool, int, np.bool_, np.integer)):
            if kind is None:
                raise KindError("an operation of scalars alone")
            return self.const(x, kind)
        else:
            raise TypeError(f"not a tape operand: {type(x).__name__}")
        if kind is not None and v.kind != kind:
            raise KindError(f"a {KIND_NAMES[v.kind]} value where "
                            f"{KIND_NAMES[kind]} is wanted (no implicit "
                            "broadcast)")
        return v

    def _kind(self, *xs) -> int:
        kinds = {x.kind if isinstance(x, FV) else self.kind_of(x.shape)
                 for x in xs if isinstance(x, (FV, torch.Tensor))}
        if len(kinds) != 1:
            raise KindError(f"operands of kinds "
                            f"{sorted(KIND_NAMES[k] for k in kinds)} "
                            "(no implicit broadcast)")
        return kinds.pop()

    def _cval(self, v: FV) -> Optional[int]:
        return self.consts.get(v.vid)

    def not_(self, x) -> FV:
        v = self.wrap(x)
        c = self._cval(v)
        if c is not None:
            return self.const(not c, v.kind, BOOL)
        op, kind, dtype, a = self.code[v.vid][:4]
        if op == OP_NOT:
            src = self._value(a)
            if src.dtype == BOOL:
                return src
        return self._emit(OP_NOT, v.kind, BOOL, v.vid)

    def _value(self, vid: int) -> FV:
        op, kind, dtype = self.code[vid][:3]
        return FV(self, vid, kind, dtype)

    def logic(self, op: int, x, y) -> FV:
        kind = self._kind(x, y)
        a, b = self.wrap(x, kind), self.wrap(y, kind)
        ca, cb = self._cval(a), self._cval(b)
        absorb = 0 if op == OP_AND else 1
        for c, other in ((ca, b), (cb, a)):
            if c is not None:
                if bool(c) == bool(absorb):
                    return self.const(bool(absorb), kind, BOOL)
                if other.dtype == BOOL:
                    return other
        if a.vid == b.vid and a.dtype == BOOL:
            return a
        return self._emit(op, kind, BOOL, a.vid, b.vid)

    def compare(self, op: int, x, y) -> FV:
        """``x == y`` (op EQC) or ``x != y`` (NEC): against a Python int
        a compare to a constant, else an equality of two values."""
        kind = self._kind(x, *([y] if isinstance(y, (FV, torch.Tensor))
                               else []))
        a = self.wrap(x, kind)
        if isinstance(y, (FV, torch.Tensor)):
            b = self.wrap(y, kind)
            eq = self._emit(OP_EQ, kind, BOOL, a.vid, b.vid) \
                if a.vid != b.vid else self.const(True, kind)
            return eq if op == OP_EQC else self.not_(eq)
        if isinstance(y, (bool, np.bool_)):
            y = int(y)
        if not isinstance(y, (int, np.integer)):
            raise TypeError(f"compare to {type(y).__name__}")
        c = self._cval(a)
        if c is not None:
            return self.const((c == int(y)) == (op == OP_EQC), kind, BOOL)
        return self._emit(op, kind, BOOL, a.vid, int(y))

    def where(self, cond, x, y) -> FV:
        kind = self._kind(cond, x, y)
        c = self.wrap(cond, kind)
        a, b = self.wrap(x, kind), self.wrap(y, kind)
        dtype = BOOL if (a.dtype == BOOL and b.dtype == BOOL) else INT
        cc = self._cval(c)
        if cc is not None:
            pick = a if cc else b
            return pick if pick.dtype == dtype else self._emit(
                OP_WHERE, kind, dtype, c.vid, a.vid, b.vid)
        if a.vid == b.vid:
            return a
        if dtype == BOOL:
            ca, cb = self._cval(a), self._cval(b)
            if ca == 1 and cb == 0 and c.dtype == BOOL:
                return c
            if ca == 0 and cb == 1:
                return self.not_(c)
        return self._emit(OP_WHERE, kind, dtype, c.vid, a.vid, b.vid)

    def first_nonpass(self, res, cls) -> FV:
        """``res`` where it is not PASS (0), else ``cls``: one step of
        the evaluator's first-non-pass fold."""
        kind = self._kind(res, cls)
        r, c = self.wrap(res, kind), self.wrap(cls, kind)
        cr = self._cval(r)
        if cr is not None:
            return r if cr != 0 else c
        return self._emit(OP_FNP, kind, INT, r.vid, c.vid)

    def reduce(self, op: int, x) -> FV:
        v = self.wrap(x)
        if v.kind == N_:
            raise KindError("an any/all over an N value (nothing to fold)")
        c = self._cval(v)
        if c is not None:
            return self.const(bool(c), v.kind - 1, BOOL)
        # an instruction's kind is its result's (the source is one deeper)
        return self._emit(op, v.kind - 1, BOOL, v.vid)

    def expand(self, x) -> FV:
        """An N value into the instance scope (NI), as the evaluator's
        ``_expand`` broadcast."""
        v = self.wrap(x, N_)
        c = self._cval(v)
        if c is not None:
            return self.const(c, NI, v.dtype)
        return self._emit(OP_EXPAND, NI, v.dtype, v.vid)

    def scan_or(self, x, exclusive: bool = False) -> FV:
        """The prefix OR over an NI value's instances (inclusive, or of
        the instances before each one)."""
        v = self.wrap(x, NI)
        return self._emit(OP_SCANX if exclusive else OP_SCAN, NI, BOOL, v.vid)

    # -- running
    def run(self, outs: Sequence[FV], dests: Sequence[torch.Tensor]) -> None:
        """Compile (cached) and run the cone of ``outs`` into ``dests``
        (tensors of their shapes; bool or int32)."""
        vids = tuple(self.wrap(o).vid for o in outs)
        segs = self.cache.get(self.code, vids, self.J)
        run_segments(segs, self.inputs, list(dests), self.plain,
                     (self.N, self.I, self.J))

    def force(self, v: FV) -> torch.Tensor:
        """Materialize one value for a torch operation outside the tape
        (counted in ``stats["fold_forced"]``)."""
        self.stats["fold_forced"] = self.stats.get("fold_forced", 0) + 1
        op, kind, dtype, a = self.code[v.vid][:4]
        if op == OP_LOAD:
            return self.inputs[a]
        out = torch.empty(v.shape, device=self.dev,
                          dtype=torch.bool if dtype == BOOL else torch.int32)
        self.run([v], [out])
        return out


# ---------------------------------------------------------------------------
# compile: a recorded tape -> K11 segments


class Segment:
    """One K11 launch of a compiled tape: its code, the values it reads
    (``ext``: ("in", input index) or ("tmp", scratch index)) and writes
    (``outs``: ("out", output index) or ("tmp", scratch index)), in the
    order of its descriptors (ext first)."""

    def __init__(self, code: "kernels.FoldCode", ext: List[Tuple[str, int]],
                 outs: List[Tuple[str, int]]):
        self.code, self.ext, self.outs = code, ext, outs


class Compiled:
    def __init__(self, segments: List[Segment], tmps: List[Tuple[int, int]]):
        self.segments = segments
        self.tmps = tmps  # (kind, dtype) of each scratch value


def _operands(ins: Tuple[int, ...]) -> Tuple[int, ...]:
    op, a, b, c = ins[0], ins[3], ins[4], ins[5]
    if op in (OP_LOAD, OP_CONST):
        return ()
    if op in (OP_NOT, OP_EQC, OP_NEC, OP_ANY, OP_ALL, OP_EXPAND, OP_SCAN,
              OP_SCANX):
        return (a,)
    if op == OP_WHERE:
        return (a, b, c)
    return (a, b)


def compile_tape(code: Sequence[Tuple[int, ...]], outs: Sequence[int],
                 J: int) -> Compiled:
    """The segments that compute ``outs`` (value ids of ``code``); see
    the module docstring."""
    max_io = kernels.CLASS_FOLD_MAX_IO
    # the cone of the outputs
    need = set()
    stack = list(outs)
    while stack:
        v = stack.pop()
        if v in need:
            continue
        need.add(v)
        stack.extend(_operands(code[v]))
    order = sorted(need)
    body = [v for v in order if code[v][0] != OP_LOAD]
    last: Dict[int, int] = {}
    for pos, v in enumerate(body):
        for a in _operands(code[v]):
            last[a] = pos
    n_outs: Dict[int, int] = {}
    for o in outs:
        n_outs[o] = n_outs.get(o, 0) + 1

    # split into segments whose descriptors fit the parameter block: the
    # descriptors if a segment ended after v are what it reads, what it
    # defines that a later segment reads (``live``), and its outputs
    seg_bodies: List[List[int]] = []
    cur: List[int] = []
    ext: set = set()
    defined: set = set()
    live: set = set()
    n_fin = 0
    for pos, v in enumerate(body):
        ops = _operands(code[v])
        new_ext = {a for a in ops if a not in defined}
        dying = {a for a in ops if a in live and last[a] == pos}
        lives = last.get(v, -1) > pos
        n_io = len(ext | new_ext) + len(live) - len(dying) + lives \
            + n_fin + n_outs.get(v, 0)
        if cur and n_io > max_io:
            seg_bodies.append(cur)
            cur, ext, defined, live, n_fin = [], set(), set(), set(), 0
            new_ext, dying = set(ops), set()
        cur.append(v)
        ext |= new_ext
        defined.add(v)
        live -= dying
        if lives:
            live.add(v)
        n_fin += n_outs.get(v, 0)
    if cur or not seg_bodies:
        seg_bodies.append(cur)
    # outputs that are inputs themselves are read and stored by the last
    # segment, or by one of their own when they would overflow it
    copies = [o for o in outs if code[o][0] == OP_LOAD]
    if copies and cur and len(ext) + n_fin + 2 * len(copies) > max_io:
        seg_bodies.append([])
    # an output that is an input or never computed in a body (a LOAD)
    # is loaded and stored by the last segment
    home: Dict[int, int] = {}
    for s, sb in enumerate(seg_bodies):
        for v in sb:
            home[v] = s
    tmps: List[Tuple[int, int]] = []
    tmp_of: Dict[int, int] = {}
    segs: List[Segment] = []
    for s, sb in enumerate(seg_bodies):
        later = set()
        for sb2 in seg_bodies[s + 1:]:
            for v in sb2:
                later.update(_operands(code[v]))
        mine = set(sb)
        stores: List[int] = [v for v in sb if v in later]
        for v in stores:
            if v not in tmp_of:
                tmp_of[v] = len(tmps)
                tmps.append((code[v][1], code[v][2]))
        seg_final = [o for o in outs if home.get(o) == s
                     or (s == len(seg_bodies) - 1 and o not in home)]
        segs.append(_emit_segment(code, sb, mine, stores, seg_final, outs,
                                  tmp_of, J))
    return Compiled(segs, tmps)


def _emit_segment(code, sb: List[int], mine: set, stores: List[int],
                  finals: List[int], outs: Sequence[int],
                  tmp_of: Dict[int, int], J: int) -> Segment:
    ext: List[Tuple[str, int]] = []
    ext_idx: Dict[int, int] = {}
    out_refs: List[Tuple[str, int]] = []
    out_idx: Dict[int, List[int]] = {}
    for v in stores:
        out_idx.setdefault(v, []).append(len(out_refs))
        out_refs.append(("tmp", tmp_of[v]))
    for k, o in enumerate(outs):
        if o in finals:
            out_idx.setdefault(o, []).append(len(out_refs))
            out_refs.append(("out", k))
    # values read from outside: inputs (LOAD) and earlier segments' tmps;
    # an output that is itself outside is read to be stored
    seq: List[Tuple[str, int]] = []  # ("x", vid) instructions of the body
    for v in sb:
        seq.append(("x", v))
    for o in finals:
        if o not in mine:
            seq.append(("copy", o))
    last: Dict[int, int] = {}
    first: List[int] = []  # outside values in the order of their first use
    for pos, (what, v) in enumerate(seq):
        for a in (_operands(code[v]) if what == "x" else (v,)):
            if a not in mine and a not in last:
                first.append(a)
            last[a] = pos
    for v in sb:
        last.setdefault(v, -1)
    # slots by kind: N values one word a warp (every lane holds the same
    # value), NI values a word a lane, NIJ values J words a lane
    slot: Dict[int, Tuple[int, int]] = {}  # vid -> (kind, index)
    free: Tuple[List[int], ...] = ([], [], [])
    count = [0, 0, 0]
    rows: List[List] = []

    def alloc(v: int) -> Tuple[int, int]:
        kind = code[v][1]
        idx = free[kind].pop() if free[kind] else count[kind]
        if idx == count[kind]:
            count[kind] += 1
        slot[v] = (kind, idx)
        return slot[v]

    def release(v: int, pos: int) -> None:
        if v in slot and last.get(v, -1) <= pos:
            kind, idx = slot.pop(v)
            free[kind].append(idx)

    def desc(v: int) -> int:
        if v not in ext_idx:
            ext_idx[v] = len(ext)
            if code[v][0] == OP_LOAD:
                ext.append(("in", code[v][3]))
            else:
                ext.append(("tmp", tmp_of[v]))
        return ext_idx[v]

    def load(v: int) -> None:
        """Load ``v`` and, in the same group, the next outside values the
        segment will read (up to ``LOAD_GROUP``): the kernel issues a
        group's reads together."""
        if v in slot:
            return
        if code[v][1] == NIJ:
            rows.append([OP_LOADJ, NIJ, alloc(v), desc(v)])
            return
        group = [v] + [u for u in first[first.index(v) + 1:]
                       if u not in slot and code[u][1] != NIJ][
                           :LOAD_GROUP - 1]
        rows.append([OP_LOAD, 0, len(group)])
        for u in group:
            rows.append(["entry", code[u][1], alloc(u), desc(u)])

    for pos, (what, v) in enumerate(seq):
        if what == "copy":
            load(v)
            for d in out_idx[v]:
                rows.append([OP_STORE, code[v][1], slot[v], d])
            continue
        op, kind, dtype, a, b, c = code[v]
        ops = _operands(code[v])
        for x in ops:
            load(x)
        args = [slot[x] for x in ops]
        for x in set(ops):
            release(x, pos)
        dst = alloc(v)
        if op == OP_CONST:
            rows.append([op, kind, dst, a])
        elif op in (OP_EQC, OP_NEC):
            rows.append([op, kind, dst, args[0], b])
        else:
            rows.append([op, kind, dst] + args)
        for d in out_idx.get(v, ()):
            rows.append([OP_STORE, kind, dst, d])
        if last.get(v, -1) <= pos:
            slot.pop(v)
            free[kind].append(dst[1])
    # slot (kind, index) -> word: N slots index the warp's words, NI
    # slots its lane words, then J lane words per NIJ slot
    n_ni = count[NI]

    def unit(s) -> int:
        kind, idx = s
        return idx if kind != NIJ else n_ni + idx * J

    n_lane = n_ni + count[NIJ] * J
    if max(count[N_], n_lane) >= 1 << 15:
        raise ValueError("class_fold: a tape with more live values than "
                         "an instruction can address")
    out = np.zeros((len(rows), 4), dtype=np.int32)
    for r, row in enumerate(rows):
        op = row[0]
        if op == "entry":
            out[r, :3] = row[1], unit(row[2]), row[3]
            continue
        kind = row[1]
        if op == OP_LOAD:
            f, args = row[2], ()
        elif op == OP_STORE:  # outputs follow the inputs' descriptors
            f, args = 0, (unit(row[2]), len(ext) + row[3])
        elif op == OP_LOADJ:
            f, args = unit(row[2]), (row[3],)
        elif op == OP_CONST:
            f, args = unit(row[2]), (row[3],)
        elif op in (OP_EQC, OP_NEC):
            f, args = unit(row[2]), (unit(row[3]), row[4])
        else:
            f, args = unit(row[2]), tuple(unit(x) for x in row[3:])
        out[r, 0] = op | (kind << 8) | (f << 16)
        out[r, 1:1 + len(args)] = args
    return Segment(kernels.FoldCode(out, count[N_], n_lane, len(ext),
                                    len(out_refs)), ext, out_refs)


class FoldCache:
    """A program's compiled tapes, by their instructions and outputs
    (kept with the program, as its K6 constants and K10 tables are)."""

    def __init__(self):
        self._by_code: Dict[Tuple, Compiled] = {}

    def get(self, code: Sequence[Tuple[int, ...]], outs: Tuple[int, ...],
            J: int) -> Compiled:
        key = (tuple(code), outs, J)
        got = self._by_code.get(key)
        if got is None:
            got = self._by_code[key] = compile_tape(code, outs, J)
        return got

    def __len__(self) -> int:
        return len(self._by_code)


# a callback run after every segment launch (chip_smoke.py holds K11
# against its plain twin with it): fn(code, descriptors, dims)
CHECK: Optional[Any] = None


def run_segments(comp: Compiled, inputs: Sequence[torch.Tensor],
                 dests: List[torch.Tensor], plain: bool,
                 dims: Tuple[int, int, int]) -> None:
    """Run a compiled tape's segments in order: K11 (its plain twin with
    ``plain`` or on the CPU), scratch tensors between them."""
    N, I, J = dims
    dev = dests[0].device
    tmps: List[Optional[torch.Tensor]] = [None] * len(comp.tmps)
    shapes = ((N,), (N, I), (N, I, J))
    for seg in comp.segments:
        ios = []
        for what, k in seg.ext:
            ios.append(inputs[k] if what == "in" else tmps[k])
        for what, k in seg.outs:
            if what == "tmp":
                kind, dtype = comp.tmps[k]
                tmps[k] = torch.empty(shapes[kind], device=dev,
                                      dtype=torch.bool if dtype == BOOL
                                      else torch.int32)
                ios.append(tmps[k])
            else:
                ios.append(dests[k])
        fn = kernels.class_fold_plain if plain else kernels.class_fold
        fn(seg.code, ios, N, I, J)
        if CHECK is not None:
            CHECK(seg.code, ios, dims)


# ---------------------------------------------------------------------------
# helpers the evaluator calls (torch values pass through when no handle
# is involved)


def _tape_of(*xs) -> Optional[Tape]:
    for x in xs:
        if isinstance(x, FV):
            return x.tape
    return None


def where(cond, x, y):
    t = _tape_of(cond, x, y)
    if t is None:
        return torch.where(cond, x, y)
    return t.where(cond, x, y)


def first_nonpass(res, cls):
    t = _tape_of(res, cls)
    if t is None:
        return torch.where(res != 0, res, cls)
    return t.first_nonpass(res, cls)


def any_of(values: Sequence):
    """The OR of a non-empty list of values."""
    acc = values[0]
    for v in values[1:]:
        acc = acc | v
    return acc


def all_of(values: Sequence):
    acc = values[0]
    for v in values[1:]:
        acc = acc & v
    return acc


def scan_or(x, exclusive: bool = False):
    """The prefix OR over the instances of an (N, I) value (inclusive,
    or of the instances before each one)."""
    t = _tape_of(x)
    if t is None:
        s = torch.cumsum(x.to(torch.int32), dim=-1)
        return (s - x.to(torch.int32) if exclusive else s) > 0
    return t.scan_or(x, exclusive)


def expand(x):
    """An (N,) value broadcast into the instance scope (N, I)."""
    t = _tape_of(x)
    if t is None:
        raise TypeError("expand takes a tape value")
    return t.expand(x)
