"""Seeded inputs for kernel K10 ``meta_any`` shared by the CPU tests
(tests/test_torch_meta_any.py: a numpy model of the kernel's table) and
the card's (tests/test_torch_cuda.py), and the subjects of the K1 /
B4 non-ASCII flag tests. Imports no JAX: the card's machine has
none."""

from typing import Sequence, Tuple

import numpy as np
import torch

from kyverno_tpu_torch import kernels

# plane slots of ``meta_any_mix``, by source kind: resource-major bank
# planes (contiguous with 16-byte rows, contiguous with 4-byte rows, a
# column slice at an odd offset, a transposed view) and entry-major
# planes (two K9 packs, one of them a row slice, and an unpacked stack)
MIX_SLOTS = [("bank", "a"), ("bank", "b"), ("bank", "c"), ("bank", "d"),
             ("nfa", "a", 0), ("nfa", "a", 1), ("unpacked", "a")]
MIX_SOURCES = {"every": (-1, 0, 1, 2, 3, 4, 5, 6), "hash": (-1,),
               "bank": (0, 1, 2, 3), "pack": (4, 5, 6)}


def meta_any_mix(seed: int, N: int, sizes: Tuple[int, int],
                 sources: Sequence[int], density: float = 0.02,
                 device="cpu") -> Tuple[kernels.MetaAnyTable, list, list,
                                        torch.Tensor, list]:
    """A random namespaces-style K10 case: ``sizes`` entries in the name
    and the namespace family, each drawn from ``sources`` (-1 a literal,
    else a slot of ``MIX_SLOTS``; a third of the plane entries are
    ``self``, duplicates included), with the planes, both hash lanes
    (literals drawn from a small range, so some match), the
    Namespace-kind mask and both non-ASCII masks, on ``device`` (the
    views made there)."""
    rng = np.random.default_rng(seed)
    K = (48, 36, 40, 45)

    def bits(shape, p=density):
        return torch.from_numpy(rng.random(shape) < p).to(device)

    planes = [bits((N, K[0])), bits((N, K[1])),
              bits((N, K[2] + 7))[:, 3:K[2] + 3], bits((K[3], N)).T,
              bits((30, N)), bits((40, N))[5:35], bits((6, N), 0.05)]
    extent = list(K) + [30, 30, 6]
    entry_major = [False] * 4 + [True] * 3
    hashes = [torch.from_numpy(rng.integers(-3, 3, (N, 2)).astype(np.int32))
              .to(device) for _ in range(2)]
    rows, off = [], []
    for f in range(2):
        frows = []
        for _ in range(sizes[f]):
            s = int(rng.choice(sources))
            if s == -1:
                frows.append((-1, int(rng.integers(-3, 3)),
                              int(rng.integers(-3, 3)), 0))
            else:
                frows.append((s, int(rng.integers(0, extent[s])), 0,
                              int(rng.random() < 1 / 3)))
        rows += sorted(frows)
        off.append(len(rows))
    ent = np.asarray(rows, np.int32).reshape(-1, 4)
    table = kernels.MetaAnyTable(("name", "ns"), list(MIX_SLOTS),
                                 entry_major, ent, tuple(off), (True, True),
                                 {"a": ["x", "y", "z", "u", "v", "w"]})
    is_ns = torch.from_numpy(rng.random(N) < 0.3).to(device)
    na = [bits(N, 0.05), bits(N, 0.05)]
    return table, planes, hashes, is_ns, na


# ---------------------------------------------------------------------------
# kernel K12 ``row_fold``: seeded lanes of every element type and random
# row tapes over them (tests/test_torch_rowfold.py holds them against a
# numpy model, tests/test_torch_cuda.py the kernel against its twin)

F32_VALUES = np.array([0.0, -0.0, 1.5, -2.0, 3e-9, 7.0, np.nan, np.inf,
                       -np.inf, 1e9], dtype=np.float32)
HASH_VALUES = np.array([0, 1, -1, 7, 0x7FFFFFFF, -0x80000000],
                       dtype=np.int32)


def row_lanes(seed: int, N: int, R: int, device="cpu") -> dict:
    """Row lanes of (N, R): ``u8`` (values 0..6), ``plane`` / ``plane2``
    (bool), ``bcast`` (a bool (1, R) row broadcast to every resource),
    ``i32`` (small signed values), ``f32`` (zeros of both signs, NaN,
    infinities), and a hash pair ``h_hi`` / ``h_lo`` (int32 bit
    patterns drawn from a few values, so sets match)."""
    rng = np.random.default_rng(seed)
    out = {
        "u8": rng.integers(0, 7, (N, R)).astype(np.uint8),
        "plane": rng.random((N, R)) < 0.4,
        "plane2": rng.random((N, R)) < 0.6,
        "bcast": rng.random((1, R)) < 0.5,
        "i32": rng.integers(-3, 4, (N, R)).astype(np.int32),
        "f32": rng.choice(F32_VALUES, (N, R)),
        "h_hi": rng.choice(HASH_VALUES, (N, R)),
        "h_lo": rng.choice(HASH_VALUES, (N, R)),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def random_row_tape(tape, lanes: dict, seed: int, steps: int = 60):
    """Record ``steps`` random row instructions on ``tape`` (a
    ``rowfold.RowTape``) over ``lanes`` (``row_lanes``): every compare of
    every lane type, scaled float compares, hash sets of 0 to 5 pairs,
    constants, NOT / AND / OR / where. Returns [(RV, numpy bool (N, R)
    value)] in recording order."""
    from kyverno_tpu_torch.tpu import rowfold

    rng = np.random.default_rng(seed)
    np_l = {k: v.cpu().numpy() for k, v in lanes.items()}
    N, R = tape.N, tape.R
    np_l["bcast"] = np.broadcast_to(np_l["bcast"], (N, R))
    vals = []

    def leaf():
        kind = int(rng.integers(0, 7))
        if kind == 0:
            name = ["plane", "plane2", "bcast"][int(rng.integers(0, 3))]
            return tape.wrap(lanes[name]), np_l[name].copy()
        if kind in (1, 2):
            name = "u8" if kind == 1 else "i32"
            c = int(rng.integers(-1, 7))
            lane, x = tape.lane(lanes[name]), np_l[name].astype(np.int64)
            if rng.random() < 0.5:
                return lane == c, x == c
            return lane != c, x != c
        if kind == 3:
            c = np.float32(rng.choice(F32_VALUES))
            lane, x = tape.lane(lanes["f32"]), np_l["f32"]
            if rng.random() < 0.3:
                s = np.float32(rng.choice([1e9, -0.5, 3.0]))
                lane, x = lane * float(s), x * s
            op = int(rng.integers(0, 4))
            with np.errstate(invalid="ignore"):
                want = (x == c, x != c, x > c, x < c)[op]
            got = (lane == float(c), lane != float(c), lane > float(c),
                   lane < float(c))[op]
            return got, want
        if kind == 4:
            k = int(rng.integers(0, 6))
            pairs = [(int(rng.choice(HASH_VALUES)), int(rng.choice(HASH_VALUES)))
                     for _ in range(k)]
            want = np.zeros((N, R), bool)
            for h, l in pairs:
                want |= (np_l["h_hi"] == h) & (np_l["h_lo"] == l)
            return tape.heq(lanes["h_hi"], lanes["h_lo"], pairs), want
        if kind == 5 and rng.random() < 0.3:
            b = bool(rng.random() < 0.5)
            return tape.const(b), np.full((N, R), b)
        return vals[int(rng.integers(0, len(vals)))] if vals else leaf()

    for _ in range(steps):
        op = int(rng.integers(0, 5)) if len(vals) > 1 else 0
        if op == 0:
            v = leaf()
        else:
            (a, na), (b, nb) = (vals[int(rng.integers(0, len(vals)))]
                                for _ in range(2))
            if op == 1:
                v = (a & b, na & nb)
            elif op == 2:
                v = (a | b, na | nb)
            elif op == 3:
                v = (~a, ~na)
            else:
                (c, nc) = vals[int(rng.integers(0, len(vals)))]
                v = (rowfold.where(c, a, b), np.where(nc, na, nb))
        vals.append(v)
    return vals


def accented_subjects(seed: int, S: int, W: int, rate: float = 0.1
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(S, W) uint8 ASCII subjects and (S,) int32 lengths in [0, W + 8]
    (past W too): about ``rate`` of the rows carry an 'e' with an acute
    accent (0xC3 0xA9) at a random position, inside or past the length,
    and the bytes past the length are random ASCII or 0xFF, so a flag
    that reads past the length is caught."""
    rng = np.random.default_rng(seed)
    byt = rng.integers(32, 127, (S, W), dtype=np.uint8)
    lens = rng.integers(0, W + 9, S).astype(np.int32)
    for i in np.nonzero(rng.random(S) < rate)[0]:
        at = int(rng.integers(0, W - 1))
        byt[i, at:at + 2] = (0xC3, 0xA9)
    for i in range(S):
        if lens[i] < W and rng.random() < 0.5:
            byt[i, lens[i]:] = 0xFF
    return byt, lens
