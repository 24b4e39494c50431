# Lines up to the table compiler's end are copied verbatim from kyverno_tpu/tpu/dfa.py; the device half at the bottom is rewritten for PyTorch.
"""Pattern classes -> dense multi-stride DFA transition tables.

The device engine historically evaluated glob operands with a
bit-parallel NFA unrolled at trace time: one ``lax.scan`` with
O(pattern_len) boolean state columns PER DISTINCT PATTERN
(evaluator.glob_match). That shape is linear in patterns twice — XLA
program size and device work both grow with (patterns x positions) —
and regex patterns (CEL ``matches()``) had no device story at all,
keeping whole rules on the host path.

This module compiles the pattern classes the engine already parses —
``utils/wildcard`` globs, the tractable subset of ``cel/re2.py``
regexes — into dense DFA transition tables stepped as batched table
lookups (the Hyperflex SIMD-DFA model, arXiv:2512.07123): one
``(states x alphabet)`` uint16 table per pattern, alphabet compressed
to per-pattern byte classes, all tables of a policy set concatenated
into ONE bank evaluated in ONE ``lax.scan`` over the byte lanes —
every (pattern x string-lane) pair in a single fused dispatch.

Two composable compressions make the path hardware-shaped:

Multi-stride tables (Hyperflex): strided patterns share one FUSED
pad-extended group-pair table. The admitted patterns' byte-class maps
are jointly refined into Cg GROUP classes plus one PAD class (class id
Cg, representing "past end-of-string"); each pattern contributes a
``(S, (Cg+1)^2)`` two-step table built by composing its one-step table
with itself (``step1[step1]``), where the pad column is the identity —
so a (real, pad) column performs exactly the one trailing stride-1
move (the tail epilogue, folded into the table) and (pad, pad) freezes
the state. Table values are premultiplied by the pair pitch, so the
scan body is gather+add only: stride 2 runs ceil(W/2) steps of ONE
gather, stride 4 runs ceil(W/4) steps of TWO chained gathers — no
active mask, no length test, no epilogue in the scan at all. The
per-DFA stride is chosen by a table-growth budget
(``stride_table_entries`` per pattern, ``MAX_BANK_STRIDE_ENTRIES`` per
bank): stride 4 costs half the scan steps of stride 2 on the SAME
table, so it is preferred whenever the table fits half the per-pattern
cap. Stride composition is exact (T_2 = T_1 o T_1, chaining = T_4), so
every stride accepts the identical language.

Approximate reduction (arXiv:1710.08647): a DFA whose exact subset
construction exceeds the state budget is no longer bluntly collapsed.
The exact automaton is explored up to a larger cap, then reduced by a
k-lookahead language-equivalence heuristic: Moore partition refinement
stopped at the budgeted block count (states indistinguishable on all
suffixes of length <= k share a block), quotiented existentially and
re-determinized. The quotient of ANY partition over-approximates the
exact language, so a device MISS stays definitive. When refinement
reaches its fixpoint within budget the quotient IS the minimal DFA —
language-equal, the pattern stays ``exact`` and pays no confirmation
at all. Otherwise the over-approximation error (sampled acceptance
delta against the exact automaton over the class alphabet) is
measured; past the configured ceiling the pattern falls back to the
legacy accept-all TOP-collapse (counted on
``kyverno_dfa_top_collapse_total{reason}``). Containment
L(exact) subset-of L(approx) is additionally PROVEN by a product-state
BFS (``prove_miss_definitive``) under ``KYVERNO_TPU_SANITIZE=1``.

Exactness ladder:

- A pattern with a non-exact (over-approximating) DFA confirms device
  HITs on the scalar oracle — approximation costs confirmation work on
  the rare hits, never correctness.
- Tables run over UTF-8 BYTES while the host oracles match CODEPOINTS.
  For pure-ASCII subjects the two are identical; patterns whose
  semantics can differ on multi-byte subjects (``?`` globs — one char
  vs one byte — and every regex) carry ``confirm_nonascii``: subjects
  containing a byte >= 0x80 route to oracle confirmation regardless of
  the DFA verdict. ``*``-only ASCII-literal globs are byte-exact for
  ALL subjects and skip the ladder entirely.

Genuinely non-lowerable patterns (word boundaries, multiline anchors,
lookaround — which cel/re2.py itself rejects) raise
:class:`DfaUnsupported` and keep today's host route.
"""

from __future__ import annotations

import functools
import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..cel.re2 import (
    A_BOT,
    A_EOT,
    Re2Error,
    _NFA,
    _Parser,
    _compile as _re2_nfa_compile,
)

__all__ = [
    "Dfa", "DfaBank", "DfaUnsupported", "compile_glob", "compile_re2",
    "bank_match", "nonascii_mask", "scan_groups", "state_budget",
    "max_stride",
    "approx_error_ceiling", "prove_miss_definitive",
]


class DfaUnsupported(Exception):
    """Pattern outside the lowerable subset -> host route."""


DEFAULT_STATE_BUDGET = 192
# total bank states must index as uint16 with headroom
MAX_BANK_STATES = 60000
# exact-exploration headroom over the state budget before giving up
# on reduction and falling back to budgeted TOP-collapse
_EXPLORE_MULT = 8
_EXPLORE_MIN = 256
_EXPLORE_MAX = 4096
DEFAULT_MAX_STRIDE = 4
DEFAULT_APPROX_ERROR = 0.02
# strided-table growth budget: a fused pattern's table is
# n_states x (group_classes+1)^2 int32 entries, so cap the per-pattern
# and whole-bank entry counts
DEFAULT_STRIDE_TABLE_ENTRIES = 1 << 19
MAX_BANK_STRIDE_ENTRIES = 8 << 20
# the fused bank carries TWO 512-entry pad-extended byte -> group
# maps (byte | pad flag in bit 8; hi map premultiplied); charge them
# to the bank cap as stride-independent overhead
_FUSED_PAIR_ENTRIES = 1 << 10
# error-sampling corpus (seeded, deterministic per pattern)
_ERR_SAMPLES = 512
# product-BFS pair cap for the sanitize-time containment proof
_PROOF_PAIR_CAP = 4_000_000


def state_budget() -> int:
    """Per-pattern DFA state budget (the approximate-reduction knob):
    exact subset construction up to this many states, reduced /
    over-approximated beyond it. serve --dfa-state-budget / env
    override."""
    try:
        return max(4, int(os.environ.get("KYVERNO_TPU_DFA_STATE_BUDGET",
                                         str(DEFAULT_STATE_BUDGET))))
    except ValueError:
        return DEFAULT_STATE_BUDGET


def max_stride() -> int:
    """Largest transition stride the bank may compile (1, 2 or 4).
    serve --dfa-stride / KYVERNO_TPU_DFA_STRIDE; values in between
    clamp down to the nearest supported stride."""
    try:
        v = int(os.environ.get("KYVERNO_TPU_DFA_STRIDE",
                               str(DEFAULT_MAX_STRIDE)))
    except ValueError:
        return DEFAULT_MAX_STRIDE
    return 4 if v >= 4 else (2 if v >= 2 else 1)


def approx_error_ceiling() -> float:
    """Maximum measured over-approximation error tolerated before a
    budget-blowing pattern falls back to TOP-collapse. 0 disables
    approximate reduction entirely (legacy collapse behavior).
    serve --dfa-approx-error / KYVERNO_TPU_DFA_APPROX_ERROR."""
    try:
        v = float(os.environ.get("KYVERNO_TPU_DFA_APPROX_ERROR",
                                 str(DEFAULT_APPROX_ERROR)))
    except ValueError:
        return DEFAULT_APPROX_ERROR
    return min(1.0, max(0.0, v))


def stride_table_entries() -> int:
    """Per-pattern strided-table entry budget (table growth knob)."""
    try:
        return max(256, int(os.environ.get(
            "KYVERNO_TPU_DFA_STRIDE_ENTRIES",
            str(DEFAULT_STRIDE_TABLE_ENTRIES))))
    except ValueError:
        return DEFAULT_STRIDE_TABLE_ENTRIES


def _note_top_collapse(reason: str) -> None:
    # compile-time signal for the silent-footgun: memoization means one
    # increment per distinct (pattern, budget, ceiling) per process
    try:
        from ..observability.metrics import global_registry
        global_registry.dfa_top_collapse.inc({"reason": reason})
    except Exception:
        pass


@dataclass
class Dfa:
    """One compiled pattern: dense transition table over byte classes.

    ``trans`` is (n_states, n_classes) int32 with LOCAL state ids;
    ``class_map`` maps each byte 0..255 to its column; ``accept`` marks
    accepting states (evaluated at end-of-string — the scan freezes the
    state once the cursor passes the string length).

    ``approx_method`` records how the table relates to the pattern's
    language: ``exact`` (subset construction fit), ``minimized``
    (Moore fixpoint quotient — language-equal, still exact),
    ``klookahead`` (budgeted-refinement quotient — over-approximating
    with ``approx_error`` measured against the exact automaton) or
    ``top_collapse`` (legacy accept-all overflow state)."""

    pattern: str
    kind: str                    # glob | re2
    trans: np.ndarray
    class_map: np.ndarray        # (256,) uint8
    accept: np.ndarray           # (n_states,) bool
    start: int
    exact: bool                  # False => over-approximating (hit -> confirm)
    confirm_nonascii: bool       # byte/codepoint semantics may differ
    approx_method: str = "exact"
    states_merged: int = 0       # exact states folded away by reduction
    approx_error: float = 0.0    # sampled acceptance delta vs exact
    _stride_memo: Dict[int, np.ndarray] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_states(self) -> int:
        return int(self.trans.shape[0])

    @property
    def n_classes(self) -> int:
        return int(self.trans.shape[1])

    def strided_table(self, k: int) -> np.ndarray:
        """(n_states, n_classes**k) int32 LOCAL-id table consuming k
        byte classes per step: T_2 = T_1 o T_1, T_4 = T_2 o T_2 —
        composition is exact, every stride accepts the same language.
        Column index is the base-n_classes big-endian fold of the
        class k-tuple."""
        if k == 1:
            return self.trans
        tab = self._stride_memo.get(k)
        if tab is None:
            t2 = self.trans[self.trans]          # (S, C, C)
            t2 = t2.reshape(self.n_states, -1)   # (S, C^2)
            if k == 2:
                tab = np.ascontiguousarray(t2)
            elif k == 4:
                t4 = t2[t2]                      # (S, C^2, C^2)
                tab = np.ascontiguousarray(t4.reshape(self.n_states, -1))
            else:
                raise ValueError(f"unsupported stride {k}")
            self._stride_memo[k] = tab
        return tab

    def match_bytes(self, data: bytes) -> bool:
        """Host-side table walk — the parity/fuzz oracle for the packed
        device kernel (identical table, identical stepping order)."""
        s = self.start
        trans, cmap = self.trans, self.class_map
        for b in data:
            s = int(trans[s, cmap[b]])
        return bool(self.accept[s])

    def match_bytes_strided(self, data: bytes, k: int) -> bool:
        """Host-side strided walk mirroring the device kernel's group
        order: whole k-byte groups on the strided table, then the tail
        on the stride-1 table. Referee for stride composition."""
        tab = self.strided_table(k)
        C = self.n_classes
        cmap = self.class_map
        s = self.start
        n = (len(data) // k) * k
        for g in range(0, n, k):
            idx = 0
            for j in range(k):
                idx = idx * C + int(cmap[data[g + j]])
            s = int(tab[s, idx])
        for b in data[n:]:
            s = int(self.trans[s, cmap[b]])
        return bool(self.accept[s])

    def match_str(self, text: str) -> bool:
        return self.match_bytes(text.encode("utf-8"))


# ---------------------------------------------------------------------------
# alphabet compression: partition bytes by membership signature

def _byte_classes(predicates: Sequence[FrozenSet[int]]
                  ) -> Tuple[np.ndarray, List[int]]:
    """Bytes indistinguishable by every predicate share a class.
    Returns (class_map (256,) uint8, representative byte per class)."""
    if not predicates:
        return np.zeros(256, dtype=np.uint8), [0]
    member = np.zeros((len(predicates), 256), dtype=bool)
    for i, pred in enumerate(predicates):
        for b in pred:
            member[i, b] = True
    # unique signature columns -> class ids
    _, inverse = np.unique(member.T, axis=0, return_inverse=True)
    class_map = inverse.astype(np.uint8)
    reps: List[int] = []
    seen: Dict[int, int] = {}
    for b in range(256):
        c = int(class_map[b])
        if c not in seen:
            seen[c] = b
    for c in range(int(class_map.max()) + 1):
        reps.append(seen[c])
    return class_map, reps


class _Determinizer:
    """Budgeted subset construction. Overflow states collapse into one
    accept-all TOP state (over-approximation: miss stays definitive)."""

    def __init__(self, n_classes: int, budget: int):
        self.n_classes = n_classes
        self.budget = budget
        self.ids: Dict[object, int] = {}
        self.trans: List[List[int]] = []
        self.accept: List[bool] = []
        self.exact = True
        self._top: Optional[int] = None

    def top(self) -> int:
        if self._top is None:
            self._top = len(self.trans)
            self.trans.append([self._top] * self.n_classes)
            self.accept.append(True)
        return self._top

    def intern(self, key) -> Tuple[int, bool]:
        """(state id, is_new). Over budget -> TOP, exact=False."""
        sid = self.ids.get(key)
        if sid is not None:
            return sid, False
        if len(self.trans) >= self.budget:
            self.exact = False
            return self.top(), False
        sid = len(self.trans)
        self.ids[key] = sid
        self.trans.append([0] * self.n_classes)
        self.accept.append(False)
        return sid, True


# ---------------------------------------------------------------------------
# approximate reduction: k-lookahead quotient with measured error

def _moore_partition(trans: np.ndarray, accept: np.ndarray,
                     max_blocks: int) -> Tuple[np.ndarray, bool]:
    """Moore partition refinement stopped at the block budget.

    Returns (block id per state, at_fixpoint). Each refinement round
    deepens the lookahead by one byte class: after r rounds two states
    share a block iff they agree on acceptance for every suffix of
    length <= r — the k-lookahead language-equivalence heuristic of
    the approximate-reduction literature. At the fixpoint the blocks
    are exactly Myhill-Nerode classes (quotient = minimal DFA)."""
    block = accept.astype(np.int64)
    nb = int(block.max()) + 1 if block.size else 1
    while True:
        sig = np.concatenate([block[:, None], block[trans]], axis=1)
        _, newblock = np.unique(sig, axis=0, return_inverse=True)
        newblock = newblock.astype(np.int64)
        nnew = int(newblock.max()) + 1
        if nnew == nb:
            return block, True
        if nnew > max_blocks:
            # refusing the refinement keeps blocks <= max_blocks;
            # coarser partition => larger (over-approximated) language
            return block, False
        block, nb = newblock, nnew


def _quotient_exact(trans: np.ndarray, accept: np.ndarray, start: int,
                    block: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Quotient by a FIXPOINT partition: all members of a block agree
    on target blocks, so a representative per block yields the minimal
    DFA — language-equal to the input."""
    nb = int(block.max()) + 1
    rep = np.zeros(nb, dtype=np.int64)
    seen = np.zeros(nb, dtype=bool)
    for s in range(block.shape[0]):
        b = int(block[s])
        if not seen[b]:
            seen[b] = True
            rep[b] = s
    qtrans = block[trans[rep]].astype(np.int32)
    qaccept = accept[rep].copy()
    return qtrans, qaccept, int(block[start])


def _quotient_determinize(trans: np.ndarray, accept: np.ndarray,
                          start: int, block: np.ndarray, budget: int
                          ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Existential quotient of a NON-fixpoint partition, re-determinized
    under the budget. The quotient NFA of any partition accepts a
    superset of the input language (every exact run maps to a valid
    block run), and budgeted determinization only ever TOP-collapses
    further — the result is over-approximating by construction."""
    nb = int(block.max()) + 1
    S, C = trans.shape
    members: List[np.ndarray] = [np.nonzero(block == b)[0]
                                 for b in range(nb)]
    baccept = np.zeros(nb, dtype=bool)
    np.logical_or.at(baccept, block, accept)
    btrans: List[List[FrozenSet[int]]] = [
        [frozenset(int(x) for x in np.unique(block[trans[members[b], c]]))
         for c in range(C)]
        for b in range(nb)]
    det = _Determinizer(C, budget)
    key0 = frozenset((int(block[start]),))
    sid0, _ = det.intern(key0)
    det.accept[sid0] = bool(any(baccept[b] for b in key0))
    work: List[Tuple[int, FrozenSet[int]]] = [(sid0, key0)]
    while work:
        sid, K = work.pop()
        for c in range(C):
            tgt: FrozenSet[int] = frozenset().union(
                *[btrans[b][c] for b in K]) if K else frozenset()
            nid, fresh = det.intern(tgt)
            det.trans[sid][c] = nid
            if fresh:
                det.accept[nid] = bool(any(baccept[b] for b in tgt))
                work.append((nid, tgt))
    qtrans = np.asarray(det.trans, dtype=np.int32).reshape(
        len(det.trans), C)
    qaccept = np.asarray(det.accept, dtype=bool)
    return qtrans, qaccept, sid0


def _accept_goals(trans: np.ndarray, accept: np.ndarray) -> np.ndarray:
    """Per-state class choice stepping along a shortest path toward an
    accepting state (arbitrary for states that cannot reach one).
    Bellman iteration with early exit — iteration count is the
    automaton's accept eccentricity, ~pattern length in practice."""
    S = trans.shape[0]
    inf = np.int64(1) << 30
    dist = np.where(accept, np.int64(0), inf)
    for _ in range(S):
        nd = np.minimum(dist, 1 + dist[trans].min(axis=1))
        if np.array_equal(nd, dist):
            break
        dist = nd
    return np.argmin(dist[trans], axis=1).astype(np.int64)


def _sampled_error(etrans: np.ndarray, eaccept: np.ndarray, estart: int,
                   atrans: np.ndarray, aaccept: np.ndarray, astart: int,
                   seed: int) -> float:
    """Measured over-approximation error: P(approx accepts | exact
    rejects) over a seeded corpus of class strings (classes ARE the
    alphabet — every class is realized by >= 1 byte). Both walks are
    vectorized; determinism comes from the derived seed.

    A third of the corpus is uniform random; a third is guided toward
    the EXACT automaton's accepts (near-accepts: truncated digests,
    typo'd names — budget-starved quotients over-merge precisely
    around the accept neighborhood); a third is guided toward the
    APPROXIMATION's accepts — the adversarial probe that surfaces
    whole over-accepted sublanguages (e.g. a quotient that merged its
    dead state into a counting chain and now accepts anything CARRYING
    a digest-shaped suffix). Each guided step follows a shortest path
    toward an accepting state with high probability and deviates
    uniformly otherwise. The adversarial third makes the measure an
    upper-bound-seeking estimate: it can only over-report error, which
    costs a TOP-collapse (performance), never correctness."""
    C = etrans.shape[1]
    rng = np.random.default_rng(seed)
    L = int(min(max(16, 2 * etrans.shape[0]), 96))
    n = _ERR_SAMPLES
    lens = rng.integers(0, L + 1, size=n)
    seqs = rng.integers(0, C, size=(n, L))
    mode = np.arange(n) % 3          # 0 uniform | 1 exact | 2 approx
    follow = rng.random(size=(n, L)) < 0.85
    goal_e = _accept_goals(etrans, eaccept)
    goal_a = _accept_goals(atrans, aaccept)
    se = np.full(n, estart, dtype=np.int64)
    sa = np.full(n, astart, dtype=np.int64)
    for j in range(L):
        cls = seqs[:, j]
        cls = np.where(follow[:, j] & (mode == 1), goal_e[se], cls)
        cls = np.where(follow[:, j] & (mode == 2), goal_a[sa], cls)
        live = j < lens
        se = np.where(live, etrans[se, cls], se)
        sa = np.where(live, atrans[sa, cls], sa)
    neg = ~eaccept[se]
    false_acc = aaccept[sa] & neg
    return float(false_acc.sum()) / float(max(1, neg.sum()))


def _containment(etrans: np.ndarray, eaccept: np.ndarray, estart: int,
                 atrans: np.ndarray, aaccept: np.ndarray, astart: int,
                 max_pairs: int = _PROOF_PAIR_CAP) -> bool:
    """PROOF (not a sample) that L(exact) is contained in L(approx):
    BFS over reachable (exact, approx) state pairs looking for a pair
    accepting in the exact automaton but not in the approximation.
    Both automata must share one class alphabet (same class_map)."""
    if etrans.shape[1] != atrans.shape[1]:
        raise ValueError("containment proof needs a shared class alphabet")
    Se, Sa = etrans.shape[0], atrans.shape[0]
    if Se * Sa > max_pairs:
        raise ValueError(f"product too large ({Se * Sa} pairs)")
    visited = np.zeros(Se * Sa, dtype=bool)
    frontier = np.asarray([estart * Sa + astart], dtype=np.int64)
    visited[frontier] = True
    while frontier.size:
        se, sa = np.divmod(frontier, Sa)
        if bool(np.any(eaccept[se] & ~aaccept[sa])):
            return False
        nxt = (etrans[se].astype(np.int64) * Sa + atrans[sa]).ravel()
        nxt = np.unique(nxt)
        fresh = nxt[~visited[nxt]]
        visited[fresh] = True
        frontier = fresh
    return True


def prove_miss_definitive(exact: "Dfa", approx: "Dfa") -> bool:
    """Property-style miss-definitive proof: True iff every string the
    exact automaton accepts is accepted by the (possibly approximated)
    automaton — i.e. a device MISS on ``approx`` implies an oracle
    MISS. Requires both Dfas to share a byte-class map (always the
    case for the same pattern compiled at different budgets: the class
    partition is budget-independent)."""
    if not np.array_equal(exact.class_map, approx.class_map):
        raise ValueError("class_map mismatch: not the same pattern alphabet")
    return _containment(exact.trans, exact.accept, exact.start,
                        approx.trans, approx.accept, approx.start)


def _sanitize_on() -> bool:
    return os.environ.get("KYVERNO_TPU_SANITIZE", "") not in ("", "0")


def _reduce(kind: str, pattern: str, trans: np.ndarray,
            accept: np.ndarray, start: int, budget: int, ceiling: float
            ) -> Optional[Tuple[np.ndarray, np.ndarray, int, str, int,
                                float, bool]]:
    """Shrink an exact-but-over-budget DFA. Returns (trans, accept,
    start, method, states_merged, error, exact) or None when only
    TOP-collapse remains (caller rebuilds at the budget)."""
    S = trans.shape[0]
    block, fixpoint = _moore_partition(trans, accept, budget)
    nb = int(block.max()) + 1
    if fixpoint and nb <= budget:
        qtrans, qaccept, qstart = _quotient_exact(trans, accept, start,
                                                  block)
        return (qtrans, qaccept, qstart, "minimized", S - nb, 0.0, True)
    if ceiling <= 0.0:
        return None
    qtrans, qaccept, qstart = _quotient_determinize(
        trans, accept, start, block, budget)
    seed = int.from_bytes(
        hashlib.sha256(f"{kind}|{pattern}|{budget}".encode()).digest()[:8],
        "little")
    err = _sampled_error(trans, accept, start, qtrans, qaccept, qstart,
                         seed)
    if err > ceiling:
        return None
    merged = S - qtrans.shape[0]
    if _sanitize_on() and S * qtrans.shape[0] <= _PROOF_PAIR_CAP:
        if not _containment(trans, accept, start, qtrans, qaccept, qstart):
            raise RuntimeError(
                f"approximate reduction broke miss-definitive for "
                f"{kind} pattern {pattern!r}")
    return (qtrans, qaccept, qstart, "klookahead", merged, err, False)


def _explore_cap(budget: int) -> int:
    return max(budget,
               min(max(_EXPLORE_MULT * budget, _EXPLORE_MIN), _EXPLORE_MAX))


def _finish(kind: str, pattern: str, build, class_map: np.ndarray,
            budget: int, ceiling: float, confirm_nonascii: bool) -> Dfa:
    """Shared compile tail: explore exactly past the budget, reduce if
    needed, fall back to legacy budgeted TOP-collapse.

    A NEGATIVE ceiling selects pure legacy behavior (collapse at the
    budget with no exploration, minimization or reduction) — the
    pre-reduction baseline bench legs compare against."""
    if ceiling < 0.0:
        det, start = build(budget)
        trans = np.asarray(det.trans, dtype=np.int32).reshape(
            len(det.trans), det.n_classes)
        return Dfa(pattern=pattern, kind=kind, trans=trans,
                   class_map=class_map,
                   accept=np.asarray(det.accept, dtype=bool), start=start,
                   exact=det.exact, confirm_nonascii=confirm_nonascii,
                   approx_method="exact" if det.exact else "top_collapse")
    det, start = build(_explore_cap(budget))
    trans = np.asarray(det.trans, dtype=np.int32).reshape(
        len(det.trans), det.n_classes)
    accept = np.asarray(det.accept, dtype=bool)
    if det.exact and trans.shape[0] <= budget:
        return Dfa(pattern=pattern, kind=kind, trans=trans,
                   class_map=class_map, accept=accept, start=start,
                   exact=True, confirm_nonascii=confirm_nonascii)
    if det.exact:
        red = _reduce(kind, pattern, trans, accept, start, budget, ceiling)
        if red is not None:
            rtrans, raccept, rstart, method, merged, err, rexact = red
            return Dfa(pattern=pattern, kind=kind, trans=rtrans,
                       class_map=class_map, accept=raccept, start=rstart,
                       exact=rexact, confirm_nonascii=confirm_nonascii,
                       approx_method=method, states_merged=merged,
                       approx_error=err)
        _note_top_collapse(
            "error_ceiling" if ceiling > 0.0 else "approx_disabled")
    else:
        _note_top_collapse("explore_overflow")
    det, start = build(budget)
    trans = np.asarray(det.trans, dtype=np.int32).reshape(
        len(det.trans), det.n_classes)
    return Dfa(pattern=pattern, kind=kind, trans=trans,
               class_map=class_map,
               accept=np.asarray(det.accept, dtype=bool), start=start,
               exact=det.exact, confirm_nonascii=confirm_nonascii,
               approx_method="exact" if det.exact else "top_collapse")


# ---------------------------------------------------------------------------
# glob -> DFA (anchored full match, go-wildcard semantics over bytes)

def _glob_elems(pattern: str) -> List[Tuple]:
    elems: List[Tuple] = []
    for ch in pattern:
        if ch == "*":
            if elems and elems[-1][0] == "star":
                continue
            elems.append(("star",))
        elif ch == "?":
            elems.append(("any",))
        else:
            for b in ch.encode("utf-8"):
                elems.append(("byte", b))
    return elems


# compiled-table memo: subset construction runs once per (pattern,
# budget, ceiling) per process, not once per policy-set compile — the
# IR lowering probes compile_re2 for lowerability and the bank compiles
# the same pattern again, and lifecycle compile-ahead / quarantine
# bisect recompile whole sets repeatedly. Dfa instances are
# read-only-by-convention and safely shared across banks (the strided
# tables they memoize are shared too — composed once per process).
_DFA_MEMO: Dict[Tuple[str, str, int, float], "Dfa"] = {}
_DFA_MEMO_CAP = 1024


def _memoized(kind: str, pattern: str, budget: int, ceiling: float,
              build) -> "Dfa":
    key = (kind, pattern, budget, ceiling)
    dfa = _DFA_MEMO.get(key)
    if dfa is None:
        dfa = build()
        if len(_DFA_MEMO) >= _DFA_MEMO_CAP:
            _DFA_MEMO.clear()
        _DFA_MEMO[key] = dfa
    return dfa


def compile_glob(pattern: str, budget: Optional[int] = None,
                 ceiling: Optional[float] = None) -> Dfa:
    budget = budget or state_budget()
    ceiling = approx_error_ceiling() if ceiling is None else ceiling
    return _memoized("glob", pattern, budget, ceiling,
                     lambda: _compile_glob(pattern, budget, ceiling))


def _compile_glob(pattern: str, budget: int, ceiling: float) -> Dfa:
    elems = _glob_elems(pattern)
    m = len(elems)

    def close(posns: Set[int]) -> FrozenSet[int]:
        out = set(posns)
        stack = list(posns)
        while stack:
            j = stack.pop()
            if j < m and elems[j][0] == "star" and j + 1 not in out:
                out.add(j + 1)
                stack.append(j + 1)
        return frozenset(out)

    lits = sorted({e[1] for e in elems if e[0] == "byte"})
    predicates = [frozenset((b,)) for b in lits]
    has_any = any(e[0] in ("any", "star") for e in elems)
    if has_any:
        predicates.append(frozenset(range(256)))
    class_map, reps = _byte_classes(predicates)

    def build(cap: int) -> Tuple[_Determinizer, int]:
        det = _Determinizer(len(reps), cap)
        start_set = close({0})
        start, _ = det.intern(start_set)
        det.accept[start] = m in start_set
        work = [(start, start_set)]
        while work:
            sid, S = work.pop()
            for c, rb in enumerate(reps):
                moved: Set[int] = set()
                for j in S:
                    if j >= m:
                        continue
                    k, *payload = elems[j]
                    if k == "byte":
                        if payload[0] == rb:
                            moved.add(j + 1)
                    elif k == "any":
                        moved.add(j + 1)
                    else:  # star: consumes any byte, stays (closure adds j+1)
                        moved.add(j)
                nset = close(moved)
                nid, fresh = det.intern(nset)
                det.trans[sid][c] = nid
                if fresh:
                    det.accept[nid] = m in nset
                    work.append((nid, nset))
        return det, start

    return _finish("glob", pattern, build, class_map, budget, ceiling,
                   confirm_nonascii=("?" in pattern))


# ---------------------------------------------------------------------------
# re2 subset -> DFA (unanchored search, cel matches() semantics)

def _charset_bytes(cs) -> FrozenSet[int]:
    """ASCII bytes the charset matches exactly, plus the 0x80-0xFF lump
    whenever the set can match any non-ASCII codepoint (subjects with
    such bytes confirm on the oracle anyway — see module docstring)."""
    out = {b for b in range(128) if cs.matches(chr(b))}
    if cs.ci:
        high = True  # case folds can cross the ASCII boundary
    elif cs.negated:
        # negation matches some codepoint >= 128 unless the ranges
        # cover [128, 0x10FFFF] completely
        cursor = 128
        for lo, hi in sorted(cs.ranges):
            if hi < cursor:
                continue
            if lo > cursor:
                break
            cursor = hi + 1
        high = cursor <= 0x10FFFF
    else:
        high = any(hi >= 128 for _, hi in cs.ranges)
    if high:
        out |= set(range(128, 256))
    return frozenset(out)


def compile_re2(pattern: str, budget: Optional[int] = None,
                ceiling: Optional[float] = None) -> Dfa:
    """Compile a cel/re2.py pattern into a search DFA (partial-match
    semantics: the byte automaton re-seeds the NFA start at every
    position, acceptance is sticky). Raises DfaUnsupported for
    constructs byte tables cannot carry (word boundaries, multiline
    anchors) — and Re2Error propagates for non-RE2 syntax."""
    budget = budget or state_budget()
    ceiling = approx_error_ceiling() if ceiling is None else ceiling
    return _memoized("re2", pattern, budget, ceiling,
                     lambda: _compile_re2(pattern, budget, ceiling))


def _compile_re2(pattern: str, budget: int, ceiling: float) -> Dfa:
    try:
        ast = _Parser(pattern).parse()
    except Re2Error:
        raise
    nfa = _NFA()
    accept_id = nfa.state()
    nfa_start = _re2_nfa_compile(nfa, ast, accept_id)
    for a in nfa.asserts:
        if a is not None and a not in (A_BOT, A_EOT):
            raise DfaUnsupported(
                f"assertion {a} (word boundary / multiline anchor) has no "
                f"byte-DFA lowering")

    char_states = [s for s in range(len(nfa.chars))
                   if nfa.chars[s] is not None]
    byteset: Dict[int, FrozenSet[int]] = {
        s: _charset_bytes(nfa.chars[s]) for s in char_states}
    class_map, reps = _byte_classes(list(byteset.values()))

    def closure(raw: FrozenSet[int], at_start: bool, at_end: bool
                ) -> Tuple[FrozenSet[int], bool]:
        seen: Set[int] = set()
        chars: Set[int] = set()
        hit = False
        stack = list(raw)
        while stack:
            s = stack.pop()
            if s in seen:
                continue
            seen.add(s)
            if s == accept_id:
                hit = True
                continue
            if nfa.chars[s] is not None:
                chars.add(s)
                continue
            a = nfa.asserts[s]
            if a == A_BOT and not at_start:
                continue
            if a == A_EOT and not at_end:
                continue
            stack.extend(nfa.eps[s])
        return frozenset(chars), hit

    def build(cap: int) -> Tuple[_Determinizer, int]:
        det = _Determinizer(len(reps), cap)
        start_key = (frozenset((nfa_start,)), True)
        start, _ = det.intern(start_key)
        _, acc0 = closure(start_key[0], True, True)
        det.accept[start] = acc0
        work = [(start, start_key)]
        while work:
            sid, (raw, at_start) = work.pop()
            chars, hit_mid = closure(raw, at_start, False)
            if hit_mid:
                # search already succeeded before this position: sticky
                det.trans[sid] = [det.top()] * det.n_classes
                det.accept[sid] = True
                continue
            for c, rb in enumerate(reps):
                moved: Set[int] = set()
                for s in chars:
                    if rb in byteset[s]:
                        moved.update(nfa.eps[s])
                # unanchored search: re-seed the NFA start at the next byte
                nraw = frozenset(moved | {nfa_start})
                nkey = (nraw, False)
                nid, fresh = det.intern(nkey)
                det.trans[sid][c] = nid
                if fresh:
                    _, acc = closure(nraw, False, True)
                    det.accept[nid] = acc
                    work.append((nid, nkey))
        return det, start

    return _finish("re2", pattern, build, class_map, budget, ceiling,
                   confirm_nonascii=True)


# ---------------------------------------------------------------------------
# the bank: one packed table set per compiled policy set

@dataclass
class DfaBank:
    """All of a policy set's patterns, concatenated for one-dispatch
    evaluation. ``families`` records which byte-lane family each
    pattern is matched against (pool / name / ns / labels_kb /
    labels_vb), so the evaluator runs one scan per family covering
    every pattern used on it. ``owners`` tracks which policy/rule
    registered each pattern (for /debug/rules attribution)."""

    budget: int = field(default_factory=state_budget)
    ceiling: float = field(default_factory=approx_error_ceiling)
    patterns: List[Dfa] = field(default_factory=list)
    glob_ids: Dict[str, int] = field(default_factory=dict)
    re2_ids: Dict[str, int] = field(default_factory=dict)
    families: Dict[str, List[int]] = field(default_factory=dict)
    owners: Dict[int, List[str]] = field(default_factory=dict)
    # packed (finalize())
    trans: Optional[np.ndarray] = None       # (S_total, C_max) uint16, GLOBAL ids
    class_map: Optional[np.ndarray] = None   # (P, 256) uint8
    start: Optional[np.ndarray] = None       # (P,) int32 global
    accept: Optional[np.ndarray] = None      # (S_total,) bool
    exact: Optional[np.ndarray] = None       # (P,) bool
    confirm_nonascii: Optional[np.ndarray] = None  # (P,) bool
    # multi-stride packing (finalize()) — the FUSED pad-extended
    # group-pair tables shared by every stride>1 pattern
    strides: Optional[np.ndarray] = None     # (P,) int32 chosen stride
    fused_trans: Optional[np.ndarray] = None  # (S_fused*GP,) int32 premul
    fused_accept: Optional[np.ndarray] = None  # (S_fused,) bool
    fused_start: Optional[np.ndarray] = None  # (P,) int32 premul fused ids
    fused_pairs: Optional[np.ndarray] = None  # (1024,) int32 hi|lo maps
    fused_pitch: int = 0                      # (Cg+1)^2 row pitch

    def _room(self, dfa: Dfa) -> bool:
        total = sum(p.n_states for p in self.patterns)
        return total + dfa.n_states <= MAX_BANK_STATES

    def add_glob(self, pattern: str, family: str,
                 owner: Optional[str] = None) -> Optional[int]:
        """Register a glob; None when the bank is full (the evaluator
        then falls back to the legacy per-pattern NFA for it)."""
        pid = self.glob_ids.get(pattern)
        if pid is None:
            dfa = compile_glob(pattern, self.budget, self.ceiling)
            if not self._room(dfa):
                return None
            pid = len(self.patterns)
            self.patterns.append(dfa)
            self.glob_ids[pattern] = pid
        self._note(family, pid)
        self._own(pid, owner)
        return pid

    def add_re2(self, pattern: str, family: str = "pool",
                owner: Optional[str] = None) -> int:
        """Register a regex; raises DfaUnsupported when non-lowerable
        or the bank has no room (the rule keeps its host route)."""
        pid = self.re2_ids.get(pattern)
        if pid is None:
            dfa = compile_re2(pattern, self.budget, self.ceiling)
            if not self._room(dfa):
                raise DfaUnsupported("DFA bank state capacity exhausted")
            pid = len(self.patterns)
            self.patterns.append(dfa)
            self.re2_ids[pattern] = pid
        self._note(family, pid)
        self._own(pid, owner)
        return pid

    def _note(self, family: str, pid: int) -> None:
        ids = self.families.setdefault(family, [])
        if pid not in ids:
            ids.append(pid)
            ids.sort()

    def _own(self, pid: int, owner: Optional[str]) -> None:
        if owner is None:
            return
        names = self.owners.setdefault(pid, [])
        if owner not in names:
            names.append(owner)

    def __len__(self) -> int:
        return len(self.patterns)

    def finalize(self, stride: Optional[int] = None,
                 stride_entries: Optional[int] = None) -> "DfaBank":
        P = len(self.patterns)
        c_max = max((p.n_classes for p in self.patterns), default=1)
        s_total = sum(p.n_states for p in self.patterns)
        trans = np.zeros((max(s_total, 1), c_max), dtype=np.uint16)
        cmap = np.zeros((max(P, 1), 256), dtype=np.uint8)
        start = np.zeros((max(P, 1),), dtype=np.int32)
        accept = np.zeros((max(s_total, 1),), dtype=bool)
        exact = np.ones((max(P, 1),), dtype=bool)
        conf_na = np.zeros((max(P, 1),), dtype=bool)
        base = 0
        for i, p in enumerate(self.patterns):
            n = p.n_states
            # pad columns repeat the state's class-0 move: class ids
            # beyond the pattern's own alphabet are never produced by
            # its class_map, so the padding is unreachable by design
            local = p.trans + base
            trans[base:base + n, :p.n_classes] = local
            if p.n_classes < c_max:
                trans[base:base + n, p.n_classes:] = local[:, :1]
            cmap[i] = p.class_map
            start[i] = base + p.start
            accept[base:base + n] = p.accept
            exact[i] = p.exact
            conf_na[i] = p.confirm_nonascii
            base += n
        self.trans, self.class_map = trans, cmap
        self.start, self.accept = start, accept
        self.exact, self.confirm_nonascii = exact, conf_na

        # per-pattern stride selection under the table-growth budget.
        # All admitted patterns share ONE fused table family: the joint
        # group-class alphabet (plus the pad class) fixes the row pitch
        # GP = (Cg+1)^2, and a pattern's table costs n_states * GP
        # entries. Strides 2 and 4 use the SAME two-step table — stride
        # 4 chains two lookups per scan step, so the total gather count
        # is identical (W/2) and the deeper stride is strictly better
        # (half the sequential scan steps); admission is therefore a
        # pure table-size question and every admitted pattern runs at
        # the configured maximum stride.
        ms = max_stride() if stride is None else (
            4 if stride >= 4 else (2 if stride >= 2 else 1))
        per_cap = stride_table_entries() if stride_entries is None \
            else stride_entries
        strides = np.ones((max(P, 1),), dtype=np.int32)
        self.fused_trans = self.fused_accept = None
        self.fused_start = self.fused_pairs = None
        self.fused_pitch = 0
        admitted: List[int] = []
        if ms > 1 and P:
            # pass 1: admission against the pitch of the FULL candidate
            # set (conservative — the joint alphabet only shrinks when
            # patterns drop out)
            sigs = np.stack([p.class_map for p in self.patterns])
            uniq, _, _ = np.unique(sigs.T, axis=0, return_inverse=True,
                                   return_index=True)
            gp = (uniq.shape[0] + 1) ** 2
            total_entries = _FUSED_PAIR_ENTRIES
            for i, p in enumerate(self.patterns):
                e = p.n_states * gp
                if e > per_cap:
                    continue
                if total_entries + e > MAX_BANK_STRIDE_ENTRIES:
                    continue
                total_entries += e
                strides[i] = ms
                admitted.append(i)
        if admitted:
            # pass 2: joint byte-class refinement over the admitted
            # patterns; rep_idx picks one representative byte per group
            # class for translating each pattern's own class columns
            sigs = np.stack([self.patterns[i].class_map
                             for i in admitted])
            uniq, rep_idx, gcmap = np.unique(
                sigs.T, axis=0, return_index=True, return_inverse=True)
            cg = int(uniq.shape[0])
            gb = cg + 1          # + the pad class
            gp = gb * gb
            s_f = sum(self.patterns[i].n_states for i in admitted)
            ftab = np.zeros((s_f, gp), dtype=np.int64)
            facc = np.zeros((s_f,), dtype=bool)
            fstart = np.zeros((max(P, 1),), dtype=np.int64)
            fb = 0
            for i in admitted:
                p = self.patterns[i]
                n = p.n_states
                cm = p.class_map[rep_idx].astype(np.int64)
                # one-step table over group classes; the pad column is
                # the identity, so composing the table with itself
                # yields the two-step table WITH the tail epilogue
                # folded in: (real, pad) = one stride-1 move,
                # (pad, pad) = freeze
                step1 = np.concatenate(
                    [p.trans.astype(np.int64)[:, cm],
                     np.arange(n, dtype=np.int64)[:, None]], axis=1)
                ftab[fb:fb + n] = (step1[step1] + fb).reshape(n, gp)
                facc[fb:fb + n] = p.accept
                fstart[i] = fb + p.start
                fb += n
            # premultiply every stored id by the pitch: the scan body
            # becomes gather+add only (state already carries the row
            # offset), final states divide the pitch back out
            gx = np.concatenate([gcmap.astype(np.int64),
                                 np.full(256, cg, dtype=np.int64)])
            self.fused_trans = (ftab * gp).astype(np.int32).reshape(-1)
            self.fused_accept = facc
            self.fused_start = (fstart * gp).astype(np.int32)
            # two cache-resident 512-entry maps (hi premultiplied by
            # the group base) instead of one 512x512 product table: a
            # pair column is fused_pairs[b0] + fused_pairs[512 + b1]
            self.fused_pairs = np.concatenate(
                [gx * gb, gx]).astype(np.int32)
            self.fused_pitch = gp
        self.strides = strides
        return self

    # -- introspection / identity

    def stats(self) -> Dict[str, object]:
        states = sum(p.n_states for p in self.patterns)
        packed = 0
        stride_bytes = 0
        if self.trans is not None and self.patterns:
            # pattern-free banks hold 1-row placeholder arrays only —
            # report 0, not the placeholder footprint
            if self.fused_trans is not None:
                stride_bytes = (self.fused_trans.nbytes
                                + self.fused_pairs.nbytes
                                + self.fused_accept.nbytes)
            packed = (self.trans.nbytes + self.class_map.nbytes
                      + self.start.nbytes + self.accept.nbytes
                      + stride_bytes)
        hist: Dict[str, int] = {}
        if self.strides is not None and self.patterns:
            for k in self.strides[:len(self.patterns)]:
                hist[str(int(k))] = hist.get(str(int(k)), 0) + 1
        return {"tables": len(self.patterns), "states": states,
                "bytes": packed,
                "approx": sum(1 for p in self.patterns if not p.exact),
                "top_collapsed": sum(
                    1 for p in self.patterns
                    if p.approx_method == "top_collapse"),
                "states_merged": sum(p.states_merged
                                     for p in self.patterns),
                "max_approx_error": max(
                    (p.approx_error for p in self.patterns), default=0.0),
                "stride_hist": hist, "stride_bytes": stride_bytes}

    def pattern_report(self) -> List[Dict[str, object]]:
        """Per-pattern compile status for /debug/rules: which rules pay
        CONFIRM trips (approximated / TOP-collapsed patterns) and which
        stride each pattern runs at."""
        out: List[Dict[str, object]] = []
        for i, p in enumerate(self.patterns):
            if p.approx_method == "top_collapse":
                status = "top_collapse"
            elif not p.exact:
                status = "approximated"
            elif p.states_merged:
                status = "minimized"
            else:
                status = "exact"
            out.append({
                "pattern": p.pattern[:120], "kind": p.kind,
                "status": status,
                "stride": int(self.strides[i])
                if self.strides is not None else 1,
                "states": p.n_states,
                "states_merged": p.states_merged,
                "approx_error": round(float(p.approx_error), 6),
                "confirm_on_hit": not p.exact,
                "confirm_nonascii": p.confirm_nonascii,
                "families": sorted(f for f, ids in self.families.items()
                                   if i in ids),
                "rules": list(self.owners.get(i, [])),
            })
        return out

    def digest(self) -> str:
        """Cache-key material: the state budget, error ceiling and
        chosen strides change table shapes (and the confirm ladder)
        without changing policy content, so the compiled-set identity
        must cover them."""
        h = hashlib.sha256()
        h.update(f"{self.budget}:{self.ceiling}".encode())
        for i, p in enumerate(self.patterns):
            k = int(self.strides[i]) if self.strides is not None else 0
            h.update(f"|{p.kind}:{p.pattern}:{int(p.exact)}:"
                     f"{p.n_states}:{p.approx_method}:"
                     f"{p.states_merged}:{k}".encode())
        return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# batched device scan (the PyTorch port of dfa.py's device half): the
# patterns are partitioned by compiled stride, each group runs through
# kernel K1 (kernels.dfa_scan_fused / dfa_scan_stride1), which writes its
# accepts straight into the family's (S, K) plane at the group's
# columns. The kernels read each group's patterns from tiles that
# kernels.pack_stride1 / pack_fused build from the bank's arrays.


def device_tables(bank: DfaBank, device) -> Dict[str, object]:
    """The bank's tables as tensors on ``device``, built once per
    (bank, device) and kept on the bank: the plain twins' arguments."""
    import torch

    device = torch.device(device)
    cache = bank.__dict__.setdefault("_device_tables", {})
    key = str(device)
    if key not in cache:
        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        tabs = {
            "trans": t(bank.trans.reshape(-1).astype(np.int32), torch.int32),
            "class_map": t(bank.class_map, torch.uint8),
            "start": t(bank.start, torch.int32),
            "accept": t(bank.accept.astype(np.uint8), torch.uint8),
        }
        if bank.fused_trans is not None:
            tabs.update({
                "fused_trans": t(bank.fused_trans, torch.int32),
                "fused_pairs": t(bank.fused_pairs, torch.int32),
                "fused_start": t(bank.fused_start, torch.int32),
                "fused_accept": t(bank.fused_accept.astype(np.uint8),
                                  torch.uint8),
            })
        cache[key] = tabs
    return cache[key]


def _plain_args(bank: DfaBank, ids: np.ndarray, stride: int, device):
    """The plain twin's table arguments for the patterns ``ids`` of one
    stride group."""
    import torch

    tabs = device_tables(bank, device)
    sel = torch.as_tensor(ids, dtype=torch.int64, device=device)
    if stride == 1:
        return (tabs["trans"], int(bank.trans.shape[1]),
                tabs["class_map"][sel].contiguous(),
                tabs["start"][sel].contiguous(), tabs["accept"])
    return (tabs["fused_trans"], tabs["fused_pairs"],
            tabs["fused_start"][sel].contiguous(), tabs["fused_accept"],
            int(bank.fused_pitch), 2 if stride == 4 else 1)


def _subjects(bytes_, lens):
    """Flatten the lead dims: (..., W) uint8 + (...) lengths -> (S, W)
    uint8 and (S,) int32, both contiguous."""
    import torch

    W = bytes_.shape[-1]
    b = bytes_.reshape(-1, W).contiguous()
    ln = lens.reshape(-1).to(torch.int32).contiguous()
    return b, ln


def scan_groups(bank: DfaBank, ids: Sequence[int], device):
    """K1's tables for the patterns ``ids``, one ``kernels.DfaTiles`` a
    stride group, each with its columns in the (S, len(ids)) accept
    plane; built once per (bank, ids, device) and kept on the bank (a
    later batch copies nothing to the device). The bank's full tables
    reach the device only for a plain scan."""
    import torch

    from .. import kernels

    device = torch.device(device)
    cache = bank.__dict__.setdefault("_scan_groups", {})
    key = (str(device), tuple(int(i) for i in ids))
    if key in cache:
        return cache[key]
    idx = np.asarray(key[1], dtype=np.int64)
    strides = (np.ones(idx.shape, dtype=np.int32) if bank.strides is None
               else bank.strides[idx])

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    groups = []
    for k in sorted(set(int(s) for s in strides)):
        sel = np.nonzero(strides == k)[0]
        sub = idx[sel]
        if k == 1:
            blob, tdir, smem = kernels.pack_stride1(
                bank.trans, bank.class_map, bank.start, bank.accept, sub, sel)
            extra = {}
        else:
            blob, tdir, smem = kernels.pack_fused(
                bank.fused_trans, int(bank.fused_pitch), bank.fused_start,
                bank.fused_accept, sub, sel)
            extra = {"pairs": t(bank.fused_pairs, torch.int32),
                     "pitch": int(bank.fused_pitch)}
        groups.append(kernels.DfaTiles(
            "stride1" if k == 1 else "fused", idx.shape[0],
            t(sel, torch.int64), t(blob, torch.uint8), t(tdir, torch.int32),
            smem, functools.partial(_plain_args, bank, sub, k, device),
            **extra))
    cache[key] = groups
    return groups


def bank_match(bank: DfaBank, ids: Sequence[int], bytes_, lens,
               plain: bool = False, want_nonascii: bool = False):
    """Evaluate the bank patterns ``ids`` against padded byte tensors.

    bytes_: (..., W) uint8, lens: (...) int32 -> (..., K) bool accepts,
    K = len(ids) — kyverno_tpu/tpu/dfa.py:bank_match. Each stride group
    writes its columns of the plane in place. ``plain`` runs the
    kernels' plain PyTorch twins whatever the device. With
    ``want_nonascii`` it returns (accepts, (...) bool non-ASCII flags),
    the flags (``nonascii_mask``) written by the first group's K1
    launch from the words it reads anyway."""
    import torch

    from .. import kernels

    assert bank.trans is not None, "bank not finalized"
    lead = tuple(bytes_.shape[:-1])
    b, ln = _subjects(bytes_, lens)
    groups = scan_groups(bank, ids, b.device)
    out = torch.empty((b.shape[0], len(ids)), dtype=torch.bool,
                      device=b.device)
    na = None
    for g in groups:
        want = want_nonascii and na is None
        if plain:
            out[:, g.cols] = g.plain_scan(b, ln)
            if want:
                na = kernels.nonascii_plain(b, ln)
        elif g.kind == "stride1":
            _, na_g = kernels.dfa_scan_stride1(b, ln, g, out, want)
            na = na_g if want else na
        else:
            _, na_g = kernels.dfa_scan_fused(b, ln, g, out, want)
            na = na_g if want else na
    plane = out.reshape(lead + (len(ids),))
    if not want_nonascii:
        return plane
    if na is None:  # no pattern to scan
        na = (kernels.nonascii_plain if plain else kernels.nonascii)(b, ln)
    return plane, na.reshape(lead)


def nonascii_mask(bytes_, lens, plain: bool = False):
    """(...,) bool: any byte >= 0x80 within the string length —
    kyverno_tpu/tpu/dfa.py:nonascii_mask, K1's non-ASCII output."""
    from .. import kernels

    lead = tuple(bytes_.shape[:-1])
    b, ln = _subjects(bytes_, lens)
    fn = kernels.nonascii_plain if plain else kernels.nonascii
    return fn(b, ln).reshape(lead)
