"""The row-plane tape of a rule: what kernel K12 ``row_fold`` runs.

Below a rule's class logic (``tpu/fold.py``, K11) lies its row-plane
logic: boolean (N, R) planes over each resource's R encoded rows, built
from lane compares, 64-bit hash equalities and ANDs/ORs/NOTs/wheres,
then reduced per resource (kyverno_tpu/tpu/evaluator.py: ``heq`` /
``type_is`` 234-246, ``Depth0`` 437-443, ``leaf_row_pred`` 480,
``_ord_cmp`` / ``_cmp_pred`` 519-537, the node evaluators 612-708 and
the condition collectors 1142-1226, all traced by ``jax.jit`` and fused
by XLA). Issued as torch operations, that logic is thousands of small
kernels a dense PSS run, each writing an (N, R) mask. Here the
evaluator's walk stays in Python, but its row steps record instructions
on a ``RowTape``; the tape runs as a launch of K12 (or of its plain twin
on the CPU) that evaluates every plane in registers and writes only
what another kernel or the class tape reads.

- **Values** are ``RV`` handles, bool (N, R) planes. ``&``, ``|`` and
  ``~`` record, and so do ``where`` (this module's), ``.any(dim=-1)``
  and ``.sum(dim=-1)``.
- **Leaves** read lanes (tensors already on the device, by reference):
  a bool plane (a K6 path mask, a K7 glob row plane, ``valid``), a lane
  compared to a constant (``Lane``: ``==`` / ``!=`` on the uint8 and
  int32 lanes, ``==`` / ``!=`` / ``>`` / ``<`` on the float32 lanes,
  after an optional multiply by a float32 constant), and the 64-bit
  equality of a hash lane pair against a constant set (B6's function).
- **Outputs** are reductions over rows, ``any`` (bool (N,)) and
  ``count`` (int32 (N,)), whose tensors are allocated when they are
  recorded and join the rule's class tape as inputs, and stored planes
  (``stored``): K3's operands and K8's ``accept`` / ``pred``, whose
  launches wait for the flush that writes them (``defer``).
- **Escapes**: a handle that reaches another torch function is
  materialized through its cone and counted in the program's
  ``stats["rows_forced"]``.

Recording folds constants and merges identical instructions (XLA's
CSE). The tape runs once, at the rule's end (``run``, the class tape's
``fold.Tape.prerun``): one flush of everything recorded (one K12
launch; more when its descriptors overflow K12's parameter block,
``kernels.ROW_FOLD_MAX_IO``, each segment then recomputing its cone
from the lanes), then the K3 and K8 launches recorded with ``defer``,
in order. So a rule's launch order is K12 -> K3 / K8 -> K11. A forced
value flushes at once.
``compile_rows`` turns a flush into ``kernels.RowCode``: each lane read
once (every compare on it grouped under one load: the uint8 lanes
first, in batches of ``kernels.ROW_FOLD_BATCH`` read together, the
others at their first use), the logic in recording order, each output
written right after its value, value slots allocated by liveness. The compiled code depends only on the
instructions, not on N or the lanes' addresses: ``RowCache`` keeps it
with the program, built at a bucket's first (eager) call, so a CUDA-
graph capture only reads it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels

# recorded instructions (op, a, b, c, d): CMP (input, compare, constant,
# scale), HEQ (hi input, lo input, pairs), CONST (value), NOT, AND, OR
# (operands), WHERE (cond, then, else)
R_CMP, R_HEQ, R_CONST, R_NOT, R_AND, R_OR, R_WHERE = range(7)
# outputs of a flush
ANY, COUNT, STORE = kernels.RF_ANY, kernels.RF_COUNT, kernels.RF_STORE
_COMMUTATIVE = (R_AND, R_OR)

_ETYPES = {torch.bool: kernels.RF_U8, torch.uint8: kernels.RF_U8,
           torch.int32: kernels.RF_I32, torch.float32: kernels.RF_F32}


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


class RV:
    """A bool (N, R) plane on a rule's row tape (module docstring)."""

    __slots__ = ("tape", "vid")

    def __init__(self, tape: "RowTape", vid: int):
        self.tape, self.vid = tape, vid

    def __and__(self, o):
        return self.tape.logic(R_AND, self, o)

    __rand__ = __and__

    def __or__(self, o):
        return self.tape.logic(R_OR, self, o)

    __ror__ = __or__

    def __invert__(self):
        return self.tape.not_(self)

    def any(self, dim: int = -1):
        _last(dim)
        return self.tape.reduce(ANY, self)

    def sum(self, dim: int = -1, dtype=None):
        _last(dim)
        if dtype not in (None, torch.int32):
            raise TypeError(f"a row count is int32, not {dtype}")
        return self.tape.reduce(COUNT, self)

    def __bool__(self):
        raise TypeError("a row value has no host truth value (the program "
                        "takes no data-dependent Python branch)")

    __hash__ = object.__hash__

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.tape.N, self.tape.R)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        return torch.bool

    @property
    def device(self):
        return self.tape.dev

    def force(self) -> torch.Tensor:
        return self.tape.force(self)

    _RECORDED = {"__and__", "__rand__", "__or__", "__ror__", "__invert__",
                 "logical_and", "logical_or", "bitwise_and", "bitwise_or"}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in cls._RECORDED and not kwargs and len(args) in (1, 2):
            t = next(a for a in args if isinstance(a, RV)).tape
            if name == "__invert__":
                return t.not_(args[0])
            return t.logic(R_AND if "and" in name else R_OR, *args)
        return func(*_forced(args), **_forced(kwargs))


def _forced(x):
    if isinstance(x, RV):
        return x.force()
    if isinstance(x, (list, tuple)):
        return type(x)(_forced(a) for a in x)
    if isinstance(x, dict):
        return {k: _forced(v) for k, v in x.items()}
    return x


def _last(dim: int) -> None:
    if dim not in (-1, 1):
        raise ValueError(f"a row reduction over dim {dim}; only the rows "
                         "(the last axis) fold")


class Lane:
    """A row lane as the operand of compares to constants: ``==``,
    ``!=`` (and on float32 lanes ``>``, ``<``, after ``* scale``)."""

    __slots__ = ("tape", "idx", "etype", "scale")

    def __init__(self, tape: "RowTape", idx: int, etype: int,
                 scale: Optional[float] = None):
        self.tape, self.idx, self.etype, self.scale = tape, idx, etype, scale

    def _cmp(self, cop: int, c) -> RV:
        if isinstance(c, (bool, np.bool_)):
            c = int(c)
        if self.etype == kernels.RF_F32:
            s = 1.0 if self.scale is None else self.scale
            return self.tape.cmp(self.idx, cop, _f32_bits(float(c)),
                                 _f32_bits(s))
        if self.scale is not None or not isinstance(c, (int, np.integer)):
            raise TypeError("an integer lane compares to an integer")
        if cop in (kernels.RF_GT, kernels.RF_LT):
            raise TypeError("ordered compares are float32-lane compares")
        return self.tape.cmp(self.idx, cop, int(c), 0)

    def __eq__(self, c):  # type: ignore[override]
        return self._cmp(kernels.RF_EQ, c)

    def __ne__(self, c):  # type: ignore[override]
        return self._cmp(kernels.RF_NE, c)

    def __gt__(self, c):
        return self._cmp(kernels.RF_GT, c)

    def __lt__(self, c):
        return self._cmp(kernels.RF_LT, c)

    def __mul__(self, s):
        if self.etype != kernels.RF_F32 or self.scale is not None:
            raise TypeError("only a float32 lane takes one scale")
        return Lane(self.tape, self.idx, self.etype, float(np.float32(s)))

    __hash__ = object.__hash__


class RowTape:
    """One rule's recorded row-plane logic (module docstring). ``fold``
    is the rule's class tape (reductions join it as inputs); ``stats``
    the Ctx's counters (``rows_forced``)."""

    def __init__(self, N: int, R: int, device, cache: "RowCache",
                 plain: bool, fold_tape, stats: Optional[Dict] = None):
        self.N, self.R = N, R
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.dev = dev
        self.cache = cache
        self.plain = plain
        self.fold = fold_tape
        self.stats = stats if stats is not None else {}
        self.code: List[Tuple] = []
        self._memo: Dict[Tuple, RV] = {}
        self.consts: Dict[int, bool] = {}
        self.inputs: List[torch.Tensor] = []
        self.etypes: List[int] = []
        self._in: Dict[Tuple, int] = {}
        # value id -> the count memo's key (``Ctx.typed``)
        self.keys: Dict[int, Tuple] = {}
        # outputs recorded and not yet run, and those already run
        self.pending: List[Tuple[int, int, torch.Tensor]] = []
        self._outs: Dict[Tuple[int, int], Any] = {}
        # launches of other kernels (K3, K8) that read stored planes,
        # recorded to run after the rule's flush (``run``)
        self.after: List[Callable[[], Any]] = []

    # -- recording
    def _emit(self, ins: Tuple) -> RV:
        if ins[0] in _COMMUTATIVE and ins[1] > ins[2]:
            ins = (ins[0], ins[2], ins[1]) + ins[3:]
        got = self._memo.get(ins)
        if got is None:
            got = self._memo[ins] = RV(self, len(self.code))
            self.code.append(ins)
            if ins[0] == R_CONST:
                self.consts[got.vid] = bool(ins[1])
        return got

    def _input(self, t: torch.Tensor) -> int:
        """A lane (or plane) tensor by reference: (N, R), (1, R) or (N, 1)
        shaped. A broadcast over resources keeps stride 0; a lane whose
        rows are not adjacent (a broadcast over rows) is made
        contiguous."""
        if t.device != self.dev:
            raise ValueError(f"row tape input on {t.device}, tape on "
                             f"{self.dev}")
        if t.dtype not in _ETYPES:
            raise TypeError(f"a row lane of dtype {t.dtype}")
        if t.ndim != 2 or t.shape[0] not in (1, self.N) \
                or t.shape[1] not in (1, self.R):
            raise ValueError(f"shape {tuple(t.shape)} is no row plane of "
                             f"({self.N}, {self.R})")
        t = t.expand(self.N, self.R)
        if self.R > 1 and t.stride(1) != 1:
            t = t.contiguous()
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)
        got = self._in.get(key)
        if got is None:
            got = self._in[key] = len(self.inputs)
            self.inputs.append(t)
            self.etypes.append(_ETYPES[t.dtype])
        return got

    def lane(self, t: torch.Tensor) -> Lane:
        i = self._input(t)
        return Lane(self, i, self.etypes[i])

    def const(self, value) -> RV:
        return self._emit((R_CONST, int(bool(value))))

    def cmp(self, idx: int, cop: int, c: int, s: int) -> RV:
        return self._emit((R_CMP, idx, cop, int(c), int(s)))

    def heq(self, hi: torch.Tensor, lo: torch.Tensor,
            pairs: Sequence[Tuple[int, int]]) -> RV:
        """OR over ``pairs`` of the 64-bit equality on a hash lane pair
        (int32 bit patterns); the empty set is all false."""
        pairs = tuple(sorted(set((int(h), int(l)) for h, l in pairs)))
        if not pairs:
            return self.const(False)
        a, b = self._input(hi), self._input(lo)
        if self.etypes[a] != kernels.RF_I32 or self.etypes[b] != kernels.RF_I32:
            raise TypeError("hash lanes are int32")
        return self._emit((R_HEQ, a, b, pairs))

    def wrap(self, x) -> RV:
        if isinstance(x, RV):
            if x.tape is not self:
                raise ValueError("a value of another rule's row tape")
            return x
        if isinstance(x, (bool, np.bool_)):
            return self.const(x)
        if isinstance(x, torch.Tensor):
            if x.dtype != torch.bool:
                raise TypeError(f"a row plane is bool, not {x.dtype}")
            return self.cmp(self._input(x), kernels.RF_NZ, 0, 0)
        raise TypeError(f"not a row operand: {type(x).__name__}")

    def _cval(self, v: RV) -> Optional[bool]:
        return self.consts.get(v.vid)

    def not_(self, x) -> RV:
        v = self.wrap(x)
        c = self._cval(v)
        if c is not None:
            return self.const(not c)
        ins = self.code[v.vid]
        if ins[0] == R_NOT:
            return RV(self, ins[1])
        return self._emit((R_NOT, v.vid))

    def logic(self, op: int, x, y) -> RV:
        a, b = self.wrap(x), self.wrap(y)
        absorb = op == R_OR
        for c, other in ((self._cval(a), b), (self._cval(b), a)):
            if c is not None:
                return self.const(absorb) if c == absorb else other
        if a.vid == b.vid:
            return a
        return self._emit((op, a.vid, b.vid))

    def where(self, cond, x, y) -> RV:
        c, a, b = self.wrap(cond), self.wrap(x), self.wrap(y)
        cc = self._cval(c)
        if cc is not None:
            return a if cc else b
        if a.vid == b.vid:
            return a
        ca, cb = self._cval(a), self._cval(b)
        if ca is not None or cb is not None:
            # a constant branch is an AND / OR with the condition
            if ca is True:
                return self.logic(R_OR, c, b)
            if ca is False:
                return self.logic(R_AND, self.not_(c), b)
            if cb is True:
                return self.logic(R_OR, self.not_(c), a)
            return self.logic(R_AND, c, a)
        return self._emit((R_WHERE, c.vid, a.vid, b.vid))

    def reduce(self, op: int, x):
        """``any`` (bool) or ``count`` (int32) over each resource's rows,
        as a value of the rule's class tape (its tensor is written when
        the tape next runs)."""
        v = self.wrap(x)
        c = self._cval(v)
        if c is not None:
            value = c if op == ANY else (self.R if c else 0)
            return self.fold.const(value, 0)
        key = (op, v.vid)
        got = self._outs.get(key)
        if got is None:
            out = torch.empty((self.N,), device=self.dev,
                              dtype=torch.bool if op == ANY else torch.int32)
            self.pending.append((op, v.vid, out))
            got = self._outs[key] = self.fold.input(out)
        return got

    def store(self, xs: Sequence) -> List[torch.Tensor]:
        """Materialize planes as contiguous (N, R) bool tensors: runs
        the tape now, with whatever it holds pending. A tensor passes
        through."""
        out = self.stored(xs)
        self.flush()
        return out

    def stored(self, xs: Sequence) -> List[torch.Tensor]:
        """The contiguous (N, R) bool tensors the next flush writes
        planes into (K3's and K8's operands, read by a launch ``defer``
        records). A tensor passes through."""
        out: List[Optional[torch.Tensor]] = []
        for x in xs:
            if isinstance(x, torch.Tensor):
                out.append(x)
                continue
            v = self.wrap(x)
            got = self._outs.get((STORE, v.vid))
            if got is None:
                got = torch.empty((self.N, self.R), device=self.dev,
                                  dtype=torch.bool)
                if self._cval(v) is not None:
                    got.fill_(self._cval(v))
                else:
                    self.pending.append((STORE, v.vid, got))
                self._outs[(STORE, v.vid)] = got
            out.append(got)
        return out

    def force(self, v: RV) -> torch.Tensor:
        """A value for a torch operation outside the tape (counted in
        ``stats["rows_forced"]``)."""
        self.stats["rows_forced"] = self.stats.get("rows_forced", 0) + 1
        return self.store([v])[0]

    # -- running
    def defer(self, launch: Callable[[], Any]) -> None:
        """Record a launch that reads planes ``stored`` hands out: it
        runs at the rule's end, after the flush that writes them."""
        self.after.append(launch)

    def run(self) -> None:
        """The rule's end (``fold.Tape.prerun``, before its class tape
        reads its inputs): one flush of everything recorded, then the
        deferred launches in the order they were recorded."""
        self.flush()
        after, self.after = self.after, []
        for launch in after:
            launch()

    def flush(self) -> None:
        """Run every output recorded since the last flush (one K12
        launch a segment)."""
        if not self.pending:
            return
        outs = tuple((op, vid) for op, vid, _ in self.pending)
        dests = [t for _, _, t in self.pending]
        self.pending = []
        segs = self.cache.get(self.code, self.etypes, outs)
        self.stats["row_splits"] = self.stats.get("row_splits", 0) \
            + len(segs) - 1
        run_segments(segs, self.inputs, dests, self.plain, self.N, self.R)


# ---------------------------------------------------------------------------
# compile: a flush -> K12 segments


class RowSegment:
    """One K12 launch: its code, the tape inputs its descriptors read (in
    order) and the flush outputs it writes (after them)."""

    def __init__(self, code: "kernels.RowCode", ins: List[int],
                 outs: List[int]):
        self.code, self.ins, self.outs = code, ins, outs


def _operands(ins: Tuple) -> Tuple[int, ...]:
    op = ins[0]
    if op in (R_CMP, R_HEQ, R_CONST):
        return ()
    return tuple(ins[1:])


def _leaf_inputs(ins: Tuple) -> Tuple[int, ...]:
    if ins[0] == R_CMP:
        return (ins[1],)
    if ins[0] == R_HEQ:
        return (ins[1], ins[2])
    return ()


def _cone(code: Sequence[Tuple], roots: Sequence[int]) -> set:
    need, stack = set(), list(roots)
    while stack:
        v = stack.pop()
        if v not in need:
            need.add(v)
            stack.extend(_operands(code[v]))
    return need


def compile_rows(code: Sequence[Tuple], etypes: Sequence[int],
                 outs: Sequence[Tuple[int, int]]) -> List[RowSegment]:
    """The segments that compute a flush's ``outs`` ((op, value id)
    pairs) from ``code`` over inputs of element types ``etypes``: the
    outputs grouped so each group's descriptors (its cone's inputs and
    its outputs) fit K12's parameter block."""
    max_io = kernels.ROW_FOLD_MAX_IO
    groups: List[Tuple[List[int], set]] = []
    for k, (_, vid) in enumerate(outs):
        ins = {i for v in _cone(code, [vid]) for i in _leaf_inputs(code[v])}
        if groups and len(groups[-1][1] | ins) + len(groups[-1][0]) + 1 \
                <= max_io:
            groups[-1][0].append(k)
            groups[-1][1].update(ins)
        else:
            if len(ins) + 1 > max_io:
                raise ValueError(f"row_fold: a value reads {len(ins)} "
                                 f"lanes, more than {max_io - 1}")
            groups.append(([k], set(ins)))
    return [_emit_segment(code, etypes, [outs[k] for k in ks], ks)
            for ks, _ in groups]


def _emit_segment(code: Sequence[Tuple], etypes: Sequence[int],
                  outs: Sequence[Tuple[int, int]], out_idx: List[int]
                  ) -> RowSegment:
    cone = _cone(code, [v for _, v in outs])
    order = sorted(cone)
    # every compare on one lane, and every hash set on one lane pair, is
    # one group: the lane is read once
    groups: Dict[Tuple, List[int]] = {}
    for v in order:
        ins = code[v]
        if ins[0] == R_CMP:
            groups.setdefault((ins[1],), []).append(v)
        elif ins[0] == R_HEQ:
            groups.setdefault((ins[1], ins[2]), []).append(v)
    outs_of: Dict[int, List[int]] = {}
    for j, (_, v) in enumerate(outs):
        outs_of.setdefault(v, []).append(j)
    # the program: the uint8 lane groups first, in batches of up to
    # ROW_FOLD_BATCH lanes read together; then each other group at its
    # first member and the other values in order; each output right
    # after its value (or its value's group or batch)
    u8 = [k for k in groups if len(k) == 1 and etypes[k[0]] == kernels.RF_U8]
    seq: List[Tuple[str, Any]] = []
    for b in range(0, len(u8), kernels.ROW_FOLD_BATCH):
        keys = u8[b:b + kernels.ROW_FOLD_BATCH]
        seq.append(("batch", keys))
        seq.extend(("out", j) for key in keys for u in groups[key]
                   for j in outs_of.get(u, ()))
    done: set = set(u8)
    for v in order:
        ins = code[v]
        if ins[0] in (R_CMP, R_HEQ):
            key = (ins[1],) if ins[0] == R_CMP else (ins[1], ins[2])
            if key in done:
                continue
            done.add(key)
            seq.append(("group", key))
            seq.extend(("out", j) for u in groups[key]
                       for j in outs_of.get(u, ()))
            continue
        seq.append(("val", v))
        seq.extend(("out", j) for j in outs_of.get(v, ()))
    # liveness: a value's last position in seq
    last: Dict[int, int] = {}
    for pos, (what, x) in enumerate(seq):
        if what == "val":
            for a in _operands(code[x]):
                last[a] = pos
        elif what == "out":
            last[outs[x][1]] = pos
    slot: Dict[int, int] = {}
    free: List[int] = []
    n_slots = 0

    def alloc(v: int) -> int:
        nonlocal n_slots
        if free:
            s = free.pop()
        else:
            s, n_slots = n_slots, n_slots + 1
        slot[v] = s
        return s

    def release(vs, pos: int) -> None:
        for a in set(vs):
            if a in slot and last.get(a, -1) <= pos:
                free.append(slot.pop(a))

    # descriptors: inputs in the order of first use, then the outputs
    desc: Dict[int, int] = {}
    in_list: List[int] = []
    for what, x in seq:
        for i in (x if what == "group" else
                  [k[0] for k in x] if what == "batch" else ()):
            if i not in desc:
                desc[i] = len(in_list)
                in_list.append(i)
    n_in = len(in_list)
    rows: List[List[int]] = []
    for pos, (what, x) in enumerate(seq):
        if what == "batch":
            members = [u for key in x for u in groups[key]]
            rows.append([kernels.RF_BATCH | (len(x) << 8), len(members), 0,
                         0])
            rows.extend([desc[key[0]], len(groups[key]), 0, 0] for key in x)
            for u in members:
                _, _, cop, c, _ = code[u]
                rows.append([cop | (alloc(u) << 8), c, 0, 0])
            release(members, pos)
            continue
        if what == "group":
            members = groups[x]
            dsts = [alloc(u) for u in members]
            if len(x) == 1:
                i = x[0]
                rows.append([kernels.RF_LANE, desc[i], etypes[i],
                             len(members)])
                for u, s in zip(members, dsts):
                    _, _, cop, c, sc = code[u]
                    rows.append([cop | (s << 8), c, sc, 0])
            else:
                body: List[List[int]] = []
                for u, s in zip(members, dsts):
                    pairs = code[u][3]
                    body.append([len(pairs), s, 0, 0])
                    flat = [w for p in pairs for w in p]
                    flat += [0] * (-len(flat) % 4)
                    body.extend(flat[k:k + 4] for k in range(0, len(flat), 4))
                rows.append([kernels.RF_HASH | (len(members) << 8),
                             desc[x[0]], desc[x[1]], len(body)])
                rows.extend(body)
            release(members, pos)
            continue
        if what == "out":
            op, v = outs[x]
            rows.append([op, slot[v], n_in + x, 0])
            release([v], pos)
            continue
        ins = code[x]
        ops = _operands(ins)
        args = [slot[a] for a in ops]
        release(ops, pos)
        d = alloc(x)
        if ins[0] == R_CONST:
            rows.append([kernels.RF_CONST | (d << 8), ins[1], 0, 0])
        else:
            op = {R_NOT: kernels.RF_NOT, R_AND: kernels.RF_AND,
                  R_OR: kernels.RF_OR, R_WHERE: kernels.RF_WHERE}[ins[0]]
            rows.append([op | (d << 8)] + args + [0] * (3 - len(args)))
        release([x], pos)
    arr = np.asarray(rows, dtype=np.int64).reshape(-1, 4)
    # hash constants are int32 bit patterns; float constants f32 bits
    arr = ((arr + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    rc = kernels.RowCode(arr, max(1, n_slots), [etypes[i] for i in in_list],
                         [op for op, _ in outs])
    return RowSegment(rc, in_list, out_idx)


class RowCache:
    """A program's compiled row flushes, by the tape's instructions and
    the flush's outputs (kept with the program, as ``fold.FoldCache``)."""

    def __init__(self):
        self._by_code: Dict[Tuple, List[RowSegment]] = {}

    def get(self, code: Sequence[Tuple], etypes: Sequence[int],
            outs: Tuple[Tuple[int, int], ...]) -> List[RowSegment]:
        key = (tuple(code), tuple(etypes), outs)
        got = self._by_code.get(key)
        if got is None:
            got = self._by_code[key] = compile_rows(code, etypes, outs)
        return got

    def __len__(self) -> int:
        return len(self._by_code)


# a callback run after every K12 launch (chip_smoke.py holds K12 against
# its plain twin with it): fn(code, descriptors, N, R)
CHECK: Optional[Any] = None


def run_segments(segs: List[RowSegment], inputs: Sequence[torch.Tensor],
                 dests: Sequence[torch.Tensor], plain: bool, N: int,
                 R: int) -> None:
    """Run a flush's segments: K12 (its plain twin with ``plain`` or on
    the CPU)."""
    fn = kernels.row_fold_plain if plain else kernels.row_fold
    for seg in segs:
        ios = [inputs[i] for i in seg.ins] + [dests[k] for k in seg.outs]
        fn(seg.code, ios, N, R)
        if CHECK is not None:
            CHECK(seg.code, ios, N, R)


# ---------------------------------------------------------------------------
# helpers the evaluator calls (torch values pass through when no row
# handle is involved)


def _tape_of(*xs) -> Optional[RowTape]:
    for x in xs:
        if isinstance(x, RV):
            return x.tape
    return None


def where(cond, x, y):
    """``torch.where`` over row planes (recorded when one is a handle)."""
    t = _tape_of(cond, x, y)
    if t is None:
        return torch.where(cond, x, y)
    return t.where(cond, x, y)
