"""K12 ``row_fold`` and the row-plane tape (kyverno_tpu_torch/tpu/
rowfold.py) on the CPU, exactly (bool and int32 outputs; tolerance 0).

- each instruction recorded on a row tape and run by the plain twin
  ``kernels.row_fold_plain`` against the op-by-op torch expression it
  replaces, over lanes of every element type (uint8, bool, int32,
  float32), a (1, R) broadcast, an empty hash set, and N not a multiple
  of 32;
- seeded random tapes against a numpy model of their values, and the
  compiled code against a numpy model of the CUDA kernel's layout (G
  lanes a resource, 32 rows a lane in a word's bits, W words past 1,024
  rows, padding bits masked);
- recording's constant folding and merging, escapes (``rows_forced``),
  segments split at the parameter block, and the wrapper's checks;
- the whole program with row tapes: the dense PSS program, the parity
  corpora, ``ShardedScanner`` on the vocabulary form and the tenant set
  at test size, against the JAX package, bit for bit, with no value
  forced off either tape and no K6 launch but the path masks'."""

import numpy as np
import pytest
import torch

from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.tpu import fold, rowfold

from torch_kernel_cases import random_row_tape, row_lanes


def _tapes(N, R, stats=None):
    ft = fold.Tape(N, 1, 1, "cpu", fold.FoldCache(), True, stats)
    rt = rowfold.RowTape(N, R, "cpu", rowfold.RowCache(), True, ft, stats)
    ft.prerun = rt.flush
    return ft, rt


def _plane(rt, v):
    return rt.store([v])[0]


# ---------------------------------------------------------------------------
# each instruction against the torch expression it replaces

N0, R0 = 37, 40


def _case(name, rt, L):
    """(recorded value, torch expression) of one instruction."""
    f32 = L["f32"]
    return {
        "nz_bool": (rt.wrap(L["plane"]), L["plane"]),
        "nz_bcast": (rt.wrap(L["bcast"]), L["bcast"].expand(N0, R0)),
        "eq_u8": (rt.lane(L["u8"]) == 3, L["u8"] == 3),
        "ne_u8": (rt.lane(L["u8"]) != 0, L["u8"] != 0),
        "eq_i32": (rt.lane(L["i32"]) == -2, L["i32"] == -2),
        "ne_i32": (rt.lane(L["i32"]) != 1, L["i32"] != 1),
        "eq_f32": (rt.lane(f32) == 0, f32 == 0),
        "ne_f32": (rt.lane(f32) != 1.5, f32 != 1.5),
        "gt_f32": (rt.lane(f32) > 1.5, f32 > 1.5),
        "lt_f32": (rt.lane(f32) < -0.0, f32 < -0.0),
        "gt_f32_scaled": (rt.lane(f32) * float(np.float32(1e9)) > 2e9,
                          f32 * float(np.float32(1e9)) > 2e9),
        "heq_one": (rt.heq(L["h_hi"], L["h_lo"], [(7, -1)]),
                    (L["h_hi"] == 7) & (L["h_lo"] == -1)),
        "hset_many": (rt.heq(L["h_hi"], L["h_lo"], [(7, -1), (0, 0), (1, 7)]),
                      ((L["h_hi"] == 7) & (L["h_lo"] == -1))
                      | ((L["h_hi"] == 0) & (L["h_lo"] == 0))
                      | ((L["h_hi"] == 1) & (L["h_lo"] == 7))),
        "hset_empty": (rt.heq(L["h_hi"], L["h_lo"], []),
                       torch.zeros((N0, R0), dtype=torch.bool)),
        "not": (~rt.wrap(L["plane"]), ~L["plane"]),
        "and": (rt.wrap(L["plane"]) & (rt.lane(L["u8"]) == 2),
                L["plane"] & (L["u8"] == 2)),
        "or": (rt.wrap(L["plane"]) | rt.wrap(L["bcast"]),
               L["plane"] | L["bcast"]),
        "where": (rowfold.where(rt.wrap(L["plane"]), rt.lane(L["u8"]) == 1,
                                rt.wrap(L["plane2"])),
                  torch.where(L["plane"], L["u8"] == 1, L["plane2"])),
        "where_false": (rowfold.where(rt.lane(L["i32"]) == 0,
                                      rt.wrap(L["plane2"]), False),
                        torch.where(L["i32"] == 0, L["plane2"], False)),
        "tensor_and": (L["plane2"] & rt.wrap(L["plane"]),
                       L["plane2"] & L["plane"]),
        "column_bcast": (rt.wrap(L["plane"]) & L["plane2"][:, :1],
                         L["plane"] & L["plane2"][:, :1]),
    }[name]


CASES = ["nz_bool", "nz_bcast", "eq_u8", "ne_u8", "eq_i32", "ne_i32",
         "eq_f32", "ne_f32", "gt_f32", "lt_f32", "gt_f32_scaled", "heq_one",
         "hset_many", "hset_empty", "not", "and", "or", "where",
         "where_false", "tensor_and", "column_bcast"]


@pytest.mark.parametrize("name", CASES)
def test_each_instruction_equals_torch(name):
    L = row_lanes(5, N0, R0)
    stats = {}
    ft, rt = _tapes(N0, R0, stats)
    got, want = _case(name, rt, L)
    assert torch.equal(_plane(rt, got), want)
    # the reductions over rows, through the class tape
    assert torch.equal(got.any(dim=-1).force(), want.any(dim=-1))
    assert torch.equal(got.sum(dim=-1, dtype=torch.int32).force(),
                       want.sum(dim=-1, dtype=torch.int32))
    assert stats.get("rows_forced", 0) == 0


def test_heq_matches_the_k6_twin():
    """B6's function on the tape equals K6's plain twin (with and without
    constants)."""
    L = row_lanes(6, N0, R0)
    _, rt = _tapes(N0, R0)
    for pairs in ([], [(7, -1)], [(0, 0), (-1, 1), (7, 7)]):
        consts = kernels.hash_consts(pairs, "cpu")
        want = kernels.hash_match_plain(L["h_hi"], L["h_lo"], consts)
        assert torch.equal(_plane(rt, rt.heq(L["h_hi"], L["h_lo"], pairs)),
                           want)


# ---------------------------------------------------------------------------
# random tapes against numpy


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("N,R", [(37, 40), (64, 1), (33, 256), (5, 1100)])
def test_random_tapes_equal_numpy_model(seed, N, R):
    L = row_lanes(seed, N, R)
    ft, rt = _tapes(N, R)
    vals = random_row_tape(rt, L, seed, steps=50)
    rng = np.random.default_rng(seed + 100)
    picks = rng.choice(len(vals), size=min(12, len(vals)), replace=False)
    anys = [vals[i][0].any(dim=-1) for i in picks]
    counts = [vals[i][0].sum(dim=-1) for i in picks]
    planes = rt.store([vals[i][0] for i in picks])
    for i, a, c, p in zip(picks, anys, counts, planes):
        want = vals[i][1]
        assert np.array_equal(p.numpy(), want)
        assert np.array_equal(ft.force(a).numpy(), want.any(-1))
        assert np.array_equal(ft.force(c).numpy(),
                              want.sum(-1).astype(np.int32))


def _kernel_model(code, ios, N, R):
    """A numpy model of csrc/row_fold.cu: G lanes a resource, lane g's
    32 rows (w * G + g) * 32 .. + 31 as a word's bits, W words; padding
    bits 0 (masked after compares, constants and NOT)."""
    G, W = kernels.row_lanes(R), kernels.row_words(R)
    arr = [t.expand(N, R).numpy() if d < code.n_in else None
           for d, t in enumerate(ios)]
    f32 = lambda bits: np.asarray([bits], np.int32).view(np.float32)[0]  # noqa: E731
    outs = {}
    for n in range(N):
        V = {}
        for gl in range(G):
            for w in range(W):
                r0 = (w * G + gl) * 32
                left = R - r0
                live = 0 if left <= 0 else (1 << min(32, left)) - 1

                def rows_of(d):
                    return [arr[d][n, r0 + k] if r0 + k < R else 0
                            for k in range(32)]

                pc = 0
                while pc < len(code.instrs):
                    x, a, b, c = code.instrs[pc]
                    op, f = x & 0xFF, x >> 8
                    pc += 1
                    if op == kernels.RF_BATCH:
                        q = pc + f
                        for d, m, _, _ in code.instrs[pc:pc + f]:
                            row = rows_of(d)
                            for e in code.instrs[q:q + m]:
                                cop, s = e[0] & 0xFF, e[0] >> 8
                                bits = 0
                                for k, v in enumerate(row):
                                    hit = (v != 0, v == e[1], v != e[1],
                                           v > e[1], v < e[1])[cop]
                                    bits |= int(bool(hit)) << k
                                V[(s, gl, w)] = bits & live
                            q += m
                        pc = q
                    elif op == kernels.RF_LANE:  # a 4-byte lane
                        assert b in (kernels.RF_I32, kernels.RF_F32)
                        row = rows_of(a)
                        for e in code.instrs[pc:pc + c]:
                            cop, s = e[0] & 0xFF, e[0] >> 8
                            bits = 0
                            for k, v in enumerate(row):
                                if b == kernels.RF_F32:
                                    y, k0 = np.float32(v) * f32(e[2]), f32(e[1])
                                else:
                                    y, k0 = int(v), e[1]
                                with np.errstate(invalid="ignore"):
                                    hit = (y != 0, y == k0, y != k0, y > k0,
                                           y < k0)[cop]
                                bits |= int(bool(hit)) << k
                            V[(s, gl, w)] = bits & live
                        pc += c
                    elif op == kernels.RF_HASH:
                        q, end = pc, pc + c
                        hi, lo = rows_of(a), rows_of(b)
                        while q < end:
                            cnt, s = code.instrs[q][0], code.instrs[q][1]
                            flat = [v for r4 in code.instrs[
                                q + 1:q + 1 + (cnt + 1) // 2] for v in r4]
                            bits = 0
                            for j in range(cnt):
                                for k in range(32):
                                    if hi[k] == flat[2 * j] \
                                            and lo[k] == flat[2 * j + 1]:
                                        bits |= 1 << k
                            V[(s, gl, w)] = bits & live
                            q += 1 + (cnt + 1) // 2
                        pc = end
                    elif op == kernels.RF_CONST:
                        V[(f, gl, w)] = live if a else 0
                    elif op == kernels.RF_NOT:
                        V[(f, gl, w)] = ~V[(a, gl, w)] & live
                    elif op == kernels.RF_AND:
                        V[(f, gl, w)] = V[(a, gl, w)] & V[(b, gl, w)]
                    elif op == kernels.RF_OR:
                        V[(f, gl, w)] = V[(a, gl, w)] | V[(b, gl, w)]
                    elif op == kernels.RF_WHERE:
                        cc = V[(a, gl, w)]
                        V[(f, gl, w)] = (cc & V[(b, gl, w)]) | (
                            ~cc & V[(c, gl, w)])
                    else:  # an output: keep the word
                        outs.setdefault((b, op), {})[(n, gl, w)] = \
                            V[(a, gl, w)]
    got = []
    for d in range(code.n_in, len(ios)):
        op = code.out_ops[d - code.n_in]
        words = outs[(d, op)]
        if op == kernels.RF_STORE:
            p = np.zeros((N, R), bool)
            for (n, gl, w), bits in words.items():
                for k in range(32):
                    r = (w * G + gl) * 32 + k
                    if r < R:
                        p[n, r] = bool(bits >> k & 1)
            got.append(p)
        else:
            per = np.zeros(N, np.int64)
            anyv = np.zeros(N, bool)
            for (n, gl, w), bits in words.items():
                per[n] += bin(bits).count("1")
                anyv[n] |= bits != 0
            got.append(anyv if op == kernels.RF_ANY else per.astype(np.int32))
    return got


@pytest.mark.parametrize("R", [1, 31, 33, 40, 256, 1100])
def test_kernel_layout_model_equals_plain(R):
    N = 3
    L = row_lanes(R, N, R)
    _, rt = _tapes(N, R)
    vals = random_row_tape(rt, L, R, steps=30)
    outs = [(op, vals[i][0].vid) for i, op in (
        (len(vals) - 1, rowfold.ANY), (len(vals) - 2, rowfold.COUNT),
        (len(vals) - 3, rowfold.STORE), (len(vals) // 2, rowfold.COUNT))]
    for seg in rowfold.compile_rows(rt.code, rt.etypes, outs):
        ios = [rt.inputs[i] for i in seg.ins]
        dests = [torch.empty((N, R) if outs[k][0] == rowfold.STORE else (N,),
                             dtype=torch.int32 if outs[k][0] == rowfold.COUNT
                             else torch.bool) for k in seg.outs]
        kernels.row_fold_plain(seg.code, ios + dests, N, R)
        for got, want in zip(dests, _kernel_model(seg.code, ios + dests, N,
                                                  R)):
            assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("R,G,W", [(1, 1, 1), (32, 1, 1), (33, 2, 1),
                                   (40, 2, 1), (256, 8, 1), (1024, 32, 1),
                                   (1025, 32, 2), (3000, 32, 3)])
def test_lanes_a_resource(R, G, W):
    assert kernels.row_lanes(R) == G and kernels.row_words(R) == W


# ---------------------------------------------------------------------------
# recording, escapes, segments and the wrapper's checks


def test_recording_folds_constants_and_merges():
    L = row_lanes(1, N0, R0)
    _, rt = _tapes(N0, R0)
    a = rt.wrap(L["plane"])
    b = rt.lane(L["u8"]) == 2
    assert (a & b).vid == (b & a).vid == (a & b).vid
    assert (rt.lane(L["u8"]) == 2).vid == b.vid  # one compare, merged
    assert (a & True).vid == a.vid and (a | False).vid == a.vid
    assert rt.consts[(a & False).vid] is False
    assert rt.consts[(a | True).vid] is True
    assert (~~a).vid == a.vid and (a & a).vid == a.vid
    assert rowfold.where(True, a, b).vid == a.vid
    assert rowfold.where(b, a, a).vid == a.vid
    assert rt.heq(L["h_hi"], L["h_lo"], []).vid == rt.const(False).vid
    # pairs are a set: order and repeats merge
    assert rt.heq(L["h_hi"], L["h_lo"], [(1, 2), (3, 4), (1, 2)]).vid == \
        rt.heq(L["h_hi"], L["h_lo"], [(3, 4), (1, 2)]).vid
    # a reduction of a constant is a constant of the class tape
    n = len(rt.pending)
    rt.const(True).sum(dim=-1)
    rt.const(False).any(dim=-1)
    assert len(rt.pending) == n
    # the same reduction twice is one output
    assert a.any(dim=-1) is a.any(dim=-1) and len(rt.pending) == n + 1


def test_a_torch_function_forces_and_counts():
    L = row_lanes(2, N0, R0)
    stats = {}
    _, rt = _tapes(N0, R0, stats)
    v = rt.wrap(L["plane"]) & (rt.lane(L["u8"]) == 1)
    got = torch.logical_xor(v, L["plane2"])
    assert stats["rows_forced"] == 1
    assert torch.equal(got, torch.logical_xor(L["plane"] & (L["u8"] == 1),
                                              L["plane2"]))
    with pytest.raises(TypeError):
        bool(v)
    with pytest.raises(TypeError):
        rt.wrap(L["u8"])  # a plane is bool
    with pytest.raises(TypeError):
        rt.lane(L["u8"]) > 1  # ordered compares are float32-lane ones


def test_segments_split_at_the_parameter_block(monkeypatch):
    """A flush whose lanes and outputs overflow the block runs as several
    launches, each recomputing its cone, with the same results."""
    monkeypatch.setattr(kernels, "ROW_FOLD_MAX_IO", 6)
    N, R = 40, 33
    rng = np.random.default_rng(3)
    planes = [torch.from_numpy(rng.random((N, R)) < 0.5) for _ in range(9)]
    _, rt = _tapes(N, R)
    vals = [rt.wrap(planes[i]) & rt.wrap(planes[(i + 1) % 9])
            for i in range(9)]
    outs = [(rowfold.STORE, v.vid) for v in vals]
    segs = rowfold.compile_rows(rt.code, rt.etypes, outs)
    assert len(segs) > 1
    assert all(len(s.ins) + len(s.outs) <= 6 for s in segs)
    got = rt.store(vals)
    for i, g in enumerate(got):
        assert torch.equal(g, planes[i] & planes[(i + 1) % 9])


def test_wrapper_checks():
    N, R = 8, 40
    L = row_lanes(0, N, R)
    _, rt = _tapes(N, R)
    v = rt.lane(L["u8"]) == 1
    (seg,) = rowfold.compile_rows(rt.code, rt.etypes, [(rowfold.ANY, v.vid)])
    out = torch.empty((N,), dtype=torch.bool)
    kernels.row_fold_plain(seg.code, [L["u8"], out], N, R)
    assert torch.equal(out, (L["u8"] == 1).any(-1))
    with pytest.raises(TypeError):  # a lane of another dtype
        kernels.row_fold(seg.code, [L["i32"], out], N, R)
    with pytest.raises(TypeError):  # an output of another dtype
        kernels.row_fold(seg.code, [L["u8"], out.to(torch.int32)], N, R)
    with pytest.raises(ValueError):  # rows not adjacent
        wide = torch.zeros((N, 2 * R), dtype=torch.uint8)[:, ::2]
        kernels.row_fold(seg.code, [wide, out], N, R)
    with pytest.raises(ValueError):  # a descriptor missing
        kernels.row_fold(seg.code, [L["u8"]], N, R)


def test_uint8_lanes_only_in_batches():
    """The compiler puts every uint8 / bool lane group in a BATCH and
    every int32 / float32 one in a LANE group; a code with a 1-byte LANE
    group (or a 4-byte lane in a BATCH) is refused."""
    N, R = 8, 40
    L = row_lanes(1, N, R)
    _, rt = _tapes(N, R)
    vals = [rt.lane(L["u8"]) == 2, rt.wrap(L["plane"]),
            rt.lane(L["i32"]) != 1, rt.lane(L["f32"]) > 0.5]
    (seg,) = rowfold.compile_rows(
        rt.code, rt.etypes, [(rowfold.ANY, v.vid) for v in vals])
    code, lanes, pc = seg.code, [], 0
    while pc < len(code.instrs):
        x, a, b, c = code.instrs[pc]
        op = x & 0xFF
        pc += 1
        if op == kernels.RF_BATCH:
            lanes += [("batch", code.in_types[d])
                      for d, _, _, _ in code.instrs[pc:pc + (x >> 8)]]
            pc += (x >> 8) + a
        elif op in (kernels.RF_LANE, kernels.RF_HASH):
            if op == kernels.RF_LANE:
                lanes.append(("lane", b))
            pc += c
    assert sorted(lanes) == sorted([
        ("batch", kernels.RF_U8), ("batch", kernels.RF_U8),
        ("lane", kernels.RF_I32), ("lane", kernels.RF_F32)])
    lane_u8 = np.asarray([[kernels.RF_LANE, 0, kernels.RF_U8, 1],
                          [kernels.RF_EQ, 1, 0, 0],
                          [kernels.RF_ANY, 0, 1, 0]], np.int32)
    with pytest.raises(ValueError):
        kernels.RowCode(lane_u8, 1, [kernels.RF_U8], [kernels.RF_ANY])
    batch_i32 = np.asarray([[kernels.RF_BATCH | (1 << 8), 1, 0, 0],
                            [0, 1, 0, 0], [kernels.RF_EQ, 1, 0, 0],
                            [kernels.RF_ANY, 0, 1, 0]], np.int32)
    with pytest.raises(ValueError):
        kernels.RowCode(batch_i32, 1, [kernels.RF_I32], [kernels.RF_ANY])
    kernels.RowCode(batch_i32, 1, [kernels.RF_U8], [kernels.RF_ANY])


@pytest.mark.parametrize("N", [1, 64, 16384])
@pytest.mark.parametrize("R", [1, 40, 256, 1100])
def test_launch_plan_stages_every_fill_unit(N, R):
    """``kernels.row_fold_plan`` (on an H100's 132 SMs): the fill units
    cover every load instruction (a HASH's two lanes apart), each input
    is staged by the kind its strides give (adjacent rows, a view of a
    wider tensor, a broadcast row), a stage holds every unit's slabs at
    the plan's T, and the layout fits a block's shared memory in the
    kernel's alignment."""
    n = min(N, 64)
    L = row_lanes(4, n, R)
    L["plane2"] = torch.zeros((n, R + 3), dtype=torch.bool)[:, 1:R + 1]
    _, rt = _tapes(n, R)
    vals = random_row_tape(rt, L, R, 40)
    outs = [(op, vals[-1 - k][0].vid) for k, op in enumerate(
        (rowfold.ANY, rowfold.COUNT, rowfold.STORE))]

    def at_n(t):  # the lane's dtype and strides at N resources (untouched)
        if t.stride(0) == 0 or t.shape[0] == 1:
            return t[:1]
        if t.stride(0) != R:
            return torch.empty((N, R + 3), dtype=t.dtype)[:, 1:R + 1]
        return torch.empty((N, R), dtype=t.dtype)

    for seg in rowfold.compile_rows(rt.code, rt.etypes, outs):
        code = seg.code
        ins = [at_n(rt.inputs[i]) for i in seg.ins]
        loads = [pc for pc in range(len(code.instrs))
                 if code.instrs[pc][0] & 0xFF in
                 (kernels.RF_LANE, kernels.RF_HASH, kernels.RF_BATCH)
                 and pc in {u & 0xFFFFFF for u in code.units}]
        hashes = [u for u in code.units if u >> 24]
        assert len(hashes) % 2 == 0
        assert [u >> 24 for u in hashes] == [1, 2] * (len(hashes) // 2)
        assert sorted({u & 0xFFFFFF for u in code.units}) == loads
        assert sorted(d for unit in code.unit_lanes for d in unit) \
            == list(range(code.n_in))
        plan = kernels.row_fold_plan(code, ins, N, R, sms=132)
        G = kernels.row_lanes(R)
        assert plan["T"] == plan["warps"] * (32 // G)
        assert plan["warps"] in (1, 2, 4, 8)
        assert plan["smem"] <= kernels.ROW_FOLD_MAX_SMEM
        want = [kernels.RF_BCAST if t.shape[0] == 1 else
                kernels.RF_SLAB if t.stride(0) == R else kernels.RF_ROWS
                for t in ins]
        assert plan["kinds"] == want
        at_code, at_bcast, at_stage, stage_bytes, at_vals = plan["layout"]
        assert at_bcast % 16 == 0 and at_stage % 128 == 0
        assert stage_bytes % 128 == 0 and at_vals == at_stage \
            + kernels.ROW_FOLD_STAGES * stage_bytes
        T = plan["T"]
        for unit in code.unit_lanes:
            need = 0
            for d in unit:
                es = ins[d].element_size()
                need += {kernels.RF_SLAB: -(-T * R * es // 16) * 16 + 16,
                         kernels.RF_ROWS: T * (-(-R * es // 16) * 16 + 16),
                         kernels.RF_BCAST: 0}[want[d]]
            assert need <= stage_bytes
        # the grid follows the card's occupancy count: none off the card
        assert plan["tiles"] == -(-N // T)
        assert plan["grid"] is plan["resident"] is plan["rounds"] is None


def test_an_unexpanded_row_is_read_by_every_resource():
    """A contiguous (1, R) lane handed straight to the wrapper is the row
    every resource reads (stride 0), as the plain twin's ``expand``."""
    N, R = 9, 40
    L = row_lanes(2, N, R)
    _, rt = _tapes(N, R)
    row = L["u8"][:1].clone()
    assert row.stride(0) == R
    v = rt.lane(row) == 3
    (seg,) = rowfold.compile_rows(rt.code, rt.etypes, [(rowfold.STORE, v.vid)])
    assert kernels._row_stride(row) == 0
    assert kernels._row_stride(row.expand(N, R)) == 0
    assert kernels._row_stride(L["u8"]) == R
    out = torch.empty((N, R), dtype=torch.bool)
    kernels.row_fold(seg.code, [row, out], N, R)
    assert torch.equal(out, (row == 3).expand(N, R))


# ---------------------------------------------------------------------------
# the whole program with row tapes, against the JAX package

import jax.numpy as jnp  # noqa: E402

from kyverno_tpu.policies import load_pss_policies  # noqa: E402
from kyverno_tpu.policy.autogen import expand_policy  # noqa: E402
from kyverno_tpu.tpu.engine import TpuEngine  # noqa: E402
from kyverno_tpu_torch.tpu.engine import lanes_to_device  # noqa: E402

from test_tpu_pss_parity import _resource  # noqa: E402
from torch_parity_util import (CORPUS_PARAMS, assert_scan_equal,  # noqa: E402
                               port_engine, record_corpus)
from torch_parity_util import fresh_port_state  # noqa: F401, E402


class _Calls:
    """Counts calls of kernel entries (plain twins on the CPU), and
    appends their names to ``order`` when given."""

    def __init__(self, monkeypatch, names, order=None):
        self.n = dict.fromkeys(names, 0)
        for name in names:
            real = getattr(kernels, name)

            def f(*a, _real=real, _name=name, **k):
                self.n[_name] += 1
                if order is not None:
                    order.append(_name)
                return _real(*a, **k)

            monkeypatch.setattr(kernels, name, f)


@pytest.fixture(scope="module")
def pss():
    jeng = TpuEngine([expand_policy(p) for p in load_pss_policies()])
    return jeng, port_engine(jeng)


# the dense PSS program's K3 requests, memo hits and launches a run,
# one level and two (the same before and after K3 moved to the rules'
# ends), and its K8 launches
PSS_K3 = {"inst_calls": 1794, "inst_hits": 1107, "inst_issued": 339,
          "inst2_calls": 81, "inst2_hits": 18, "inst2_issued": 63}
PSS_K8 = 3


@pytest.mark.parametrize("seed", [7, 21])
def test_pss_program_with_row_tapes_equals_reference(pss, monkeypatch, seed):
    """The dense PSS program (66 rules): bit for bit the JAX program's
    table and counts; K6 runs only the path masks (one a distinct path,
    no heq / hset); each rule with row logic runs its row tape in one K12
    launch (more only for a split, counted in ``row_splits``) at the
    rule's end, then its K3 and K8 launches, then K11; K3's requests,
    memo hits and launches are the stated ones; no value is forced off
    either tape."""
    import random

    jeng, teng = pss
    rng = random.Random(seed)
    pods = [_resource(rng, i) for i in range(37)] + [{}] * 27
    batch = jeng.encode(pods)[0]
    jtab, jcnt = jeng.cps.device_fn()(batch)
    run = teng.cps.device_fn()
    for k in run.stats:
        run.stats[k] = 0
    order: list = []
    names = ("row_fold_plain", "instance_count_many_plain",
             "instance_count_plain", "first_true_take_plain",
             "class_fold_plain")
    calls = _Calls(monkeypatch, ("hash_match_plain",) + names, order)
    flushes = []
    real_flush = rowfold.RowTape.flush

    def flush(self):
        flushes.append(bool(self.pending))
        return real_flush(self)

    monkeypatch.setattr(rowfold.RowTape, "flush", flush)
    ttab, tcnt = run(lanes_to_device(batch, "cpu"))
    assert np.array_equal(ttab.numpy(), np.asarray(jtab))
    assert np.array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert run.stats["rows_forced"] == 0 and run.stats["fold_forced"] == 0
    assert calls.n["class_fold_plain"] == 66
    # one flush a rule, at its end; K12 launches = rules with row logic
    # plus the splits
    assert len(flushes) == 66
    assert calls.n["row_fold_plain"] == sum(flushes) \
        + run.stats["row_splits"] == 66
    assert {k: run.stats[k] for k in PSS_K3} == PSS_K3
    assert calls.n["instance_count_many_plain"] == PSS_K3["inst_issued"]
    assert calls.n["instance_count_plain"] == PSS_K3["inst2_issued"]
    assert calls.n["first_true_take_plain"] == PSS_K8
    # each rule: K12, then K3 / K8, then K11
    rule: list = []
    for name in (n for n in order if n != "hash_match_plain"):
        rule.append(name)
        if name == "class_fold_plain":
            k12 = [i for i, n in enumerate(rule) if n == "row_fold_plain"]
            assert k12 == list(range(len(k12))), rule
            rule = []
    # 461 distinct path masks, each one K6 call a run (PERF.md)
    assert calls.n["hash_match_plain"] == 461
    assert len(run.row_cache) > 0


@pytest.mark.parametrize("module,name", CORPUS_PARAMS)
def test_corpus_programs_force_nothing(monkeypatch, module, name):
    """Every parity corpus through the port's program with row tapes:
    the device table and counts equal the JAX package's, and no value is
    forced off either tape."""
    ports = {}
    for rec in record_corpus(monkeypatch, module, name):
        key = id(rec.engine)
        if key not in ports:
            ports[key] = port_engine(rec.engine)
        run = ports[key].cps.device_fn()
        assert_scan_equal(rec.engine, ports[key], rec)
        assert run.stats["rows_forced"] == 0, run.stats
        assert run.stats["fold_forced"] == 0, run.stats


def test_sharded_scanner_vocabulary_form_equals_reference():
    """``ShardedScanner(device="cpu")`` (vocabulary lanes through K5's
    twin into the row tapes) against the JAX scanner's step."""
    import jax

    from kyverno_tpu.parallel.sharding import ShardedScanner as JScanner
    from kyverno_tpu.parallel.sharding import make_mesh
    from kyverno_tpu_torch.parallel.sharding import ShardedScanner
    from test_sharding import pods
    from torch_parity_util import port_policies

    policies = [expand_policy(p) for p in load_pss_policies("disallow")]
    js = JScanner(policies, mesh=make_mesh(jax.devices()[:1]))
    ts = ShardedScanner(port_policies(policies), device="cpu")
    resources = pods(11)
    jv, jc = js.scan_device(resources)
    tv, tc = ts.scan_device(resources)
    assert np.array_equal(tv, jv) and np.array_equal(tc, jc)
    st = ts.step_jitted().stats
    assert st["rows_forced"] == 0 and st["fold_forced"] == 0
    assert len(ts.step_jitted().row_cache) > 0


def test_tenant_set_with_row_tapes_equals_reference(monkeypatch):
    """The tenant set at test size (bank cap lowered so globs overflow to
    K9): scan and mutate triage equal the JAX package's, nothing forced."""
    from kyverno_tpu.tpu import dfa as jdfa
    from kyverno_tpu_torch.tpu import dfa as tdfa
    from test_torch_glob_nfa import (BANK_STATES, tenant_engines,
                                     tenant_resources)
    from torch_parity_util import Recorded, assert_full_scan_equal

    monkeypatch.setattr(jdfa, "MAX_BANK_STATES", BANK_STATES)
    monkeypatch.setattr(tdfa, "MAX_BANK_STATES", BANK_STATES)
    jeng, teng = tenant_engines()
    resources = tenant_resources(3)
    rec = Recorded(jeng, resources, None, None, None)
    rec.result = jeng.scan(resources)
    assert_scan_equal(jeng, teng, rec)
    assert_full_scan_equal(teng, rec)
    want = jeng.triage_mutate(resources)
    got = teng.triage_mutate(resources)
    assert np.array_equal(got.verdicts, want.verdicts)
    for fn in (teng.cps.device_fn(), teng.cps.mutate_device_fn()):
        assert fn.stats["rows_forced"] == 0 and fn.stats["fold_forced"] == 0
