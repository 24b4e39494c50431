"""K1's packed tiles (kyverno_tpu_torch/kernels.py:pack_stride1 /
pack_fused) against the JAX package's bank scan.

A plain model of each kernel's arithmetic (csrc/dfa_scan.cu) runs here
on the CPU over the very tile bytes the kernel receives: the
field-major pattern fields, the class maps at their pitch, the rows of
pattern-local ids (uint8, or uint16 past 256 states), the fused
table's local premultiplied entries (uint16, or int32 past 65,536), the
pair columns folded from each subject's bytes (two pairs a word, the
second past the length being the identity), and
the empty-subject shortcut. Its (S, K) plane must equal ``kyverno_tpu/tpu/dfa.py:
bank_match`` bit for bit (tolerance 0: bool outputs) on exact and
approximated banks at strides 1, 2 and 4, on banks split over many
tiles, with a pattern too large for any tile, with patterns past 256
states and past the uint16 range, and on a 300-glob tenant family.
Subjects hold non-ASCII bytes, length 0 and lengths past the width."""

import numpy as np
import pytest
import torch

from kyverno_tpu.tpu import dfa as jdfa
from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.tpu import dfa as tdfa
from kyverno_tpu_torch.tpu.convert import bank_from_numpy, bank_to_numpy

from torch_parity_util import fresh_port_state  # noqa: F401 - autouse
from test_torch_dfa import _banks, _corpus, _pack

CM_PITCH = 260


def _tiles(blob, tdir):
    for off, nbytes, P, flags in tdir.tolist():
        T = blob[off:off + nbytes]
        yield T, P, flags, T[:16 * P].view(np.uint32).reshape(4, P)


def model_stride1(blob, tdir, byt, lens, out):
    """csrc/dfa_scan.cu's stride-1 walk over the tile bytes."""
    S, W = byt.shape
    lc = np.clip(lens, 0, W)
    for T, P, flags, f in _tiles(blob, tdir):
        dt = np.uint16 if flags & 1 else np.uint8
        for k in range(P):
            rows_off, acc_off, packed, col = (int(x) for x in f[:, k])
            rows = T[rows_off:acc_off].view(dt).astype(np.int64)
            C, state = packed & 0xFFFF, np.full(S, packed >> 16, np.int64)
            cm = T[16 * P + CM_PITCH * k:16 * P + CM_PITCH * k + 256]
            for w in range(W):
                nxt = rows[state * C + cm[byt[:, w]]]
                state = np.where(w < lc, nxt, state)
            out[:, col] = T[acc_off + state] != 0


def pair_stream(byt, lens, pairs):
    """(S, ceil(W/2)) pair columns and the pairs a subject's walk takes:
    the kernel reads a word (two pairs) a step, from rows padded to a
    multiple of 4 bytes, so 2 * ceil(min(len, W) / 4); a pair wholly
    past the length is (pad, pad), the identity."""
    S, W = byt.shape
    lc = np.clip(lens, 0, W)
    npairs = (W + 1) // 2
    p0 = np.arange(npairs) * 2
    p1 = p0 + 1
    b = np.pad(byt.astype(np.int64), ((0, 0), (0, 1)))
    b0 = b[:, p0] + (p0[None, :] >= lc[:, None]) * 256
    b1 = np.where(p1 < W, b[:, np.minimum(p1, W)], 0) \
        + (p1[None, :] >= lc[:, None]) * 256
    taken = 2 * ((lc + 3) // 4)
    return pairs[b0] + pairs[512 + b1], taken


def model_fused(blob, tdir, pairs, pitch, byt, lens, out):
    """csrc/dfa_scan.cu's fused walk over the tile bytes."""
    u, taken = pair_stream(byt, lens, pairs.astype(np.int64))
    for T, P, flags, f in _tiles(blob, tdir):
        dt = np.int32 if flags & 1 else np.uint16
        for k in range(P):
            tab_off, acc_off, start, col = (int(x) for x in f[:, k])
            tab = T[tab_off:acc_off].view(dt).astype(np.int64)
            state = np.full(byt.shape[0], start, np.int64)
            for p in range(u.shape[1]):
                # a subject with no live pair (length 0) takes no step
                state = np.where(p < taken, tab[state + u[:, p]], state)
            out[:, col] = T[acc_off + state // pitch] != 0


def model_match(bank, ids, byt, lens, budgets=(None, None)):
    """The (S, len(ids)) plane of both kernels' models over the tiles
    that ``bank_match`` packs (or tiles of the given byte budgets)."""
    idx = np.asarray(ids, dtype=np.int64)
    strides = bank.strides[idx]
    out = np.zeros((byt.shape[0], idx.shape[0]), dtype=bool)
    out[:] = True  # every column must be written
    written = np.zeros(idx.shape[0], dtype=bool)
    layout = {}
    for k in sorted(set(strides.tolist())):
        sel = np.nonzero(strides == k)[0]
        if k == 1:
            kw = {} if budgets[0] is None else {"budget": budgets[0]}
            blob, tdir, smem = kernels.pack_stride1(
                bank.trans, bank.class_map, bank.start, bank.accept,
                idx[sel], sel, **kw)
            model_stride1(blob, tdir, byt, lens, out)
        else:
            kw = {} if budgets[1] is None else {"budget": budgets[1]}
            blob, tdir, smem = kernels.pack_fused(
                bank.fused_trans, int(bank.fused_pitch), bank.fused_start,
                bank.fused_accept, idx[sel], sel, **kw)
            model_fused(blob, tdir, bank.fused_pairs, bank.fused_pitch, byt,
                        lens, out)
        assert (tdir[:, 0] % 16 == 0).all()
        assert (tdir[:, 1] % 16 == 0).all()
        written[sel] = True
        layout[k] = (tdir, smem)
    assert written.all()
    return out, layout


def _port(jbank):
    return bank_from_numpy(bank_to_numpy(jbank))


CASES = [(kind, stride) for kind in ("exact", "approx") for stride in (1, 2, 4)]


@pytest.mark.parametrize("kind,stride", CASES)
@pytest.mark.parametrize("width", [33, 96])
def test_tile_models_equal_reference(kind, stride, width):
    jbank, _ = _banks(kind, stride)
    bank = _port(jbank)
    byt, lens = _pack(_corpus(stride * 10 + width), width, seed=width + 1)
    ids = jbank.families["pool"]
    want = np.asarray(jdfa.bank_match(jbank, ids, byt, lens))
    got, layout = model_match(bank, ids, byt, lens)
    assert np.array_equal(got, want)
    # a subset of ids, out of order
    sub = ids[::-2]
    want = np.asarray(jdfa.bank_match(jbank, sub, byt, lens))
    assert np.array_equal(model_match(bank, sub, byt, lens)[0], want)


@pytest.mark.parametrize("stride,budget", [(1, 500), (4, 30000)])
def test_tiles_split_and_oversize_pattern(stride, budget):
    """Small budgets split the bank over several tiles, and a pattern
    larger than a tile alone gets a global tile of its own."""
    jbank, _ = _banks("exact", stride)
    bank = _port(jbank)
    byt, lens = _pack(_corpus(31), 64, seed=31)
    ids = jbank.families["pool"]
    want = np.asarray(jdfa.bank_match(jbank, ids, byt, lens))
    got, layout = model_match(bank, ids, byt, lens, budgets=(budget, budget))
    assert np.array_equal(got, want)
    for tdir, smem in layout.values():
        assert tdir.shape[0] > 1
        assert (tdir[:, 3] & 2).any(), "no pattern overflowed a tile"
        assert ((tdir[:, 3] & 2) == 0).any()
        staged = tdir[(tdir[:, 3] & 2) == 0]
        assert smem == staged[:, 1].max() <= budget
        # a global tile holds one pattern
        assert (tdir[(tdir[:, 3] & 2) != 0][:, 2] == 1).all()


def _wide_banks(stride):
    """A pattern of 512 states (uint16 local ids) beside literal-rich
    globs that widen the joint pitch, so its fused slice passes 65,536
    entries (int32); the per-pattern cap of the fused table is raised
    so that it runs at the stride asked for."""
    out = []
    for mod in (jdfa, tdfa):
        bank = mod.DfaBank(budget=600)
        bank.add_re2("^[ab]*a[ab]{8}$", "pool")
        for g in ("0123456789*", "klmnopqrst*", "uvwxyz-_.:*", "a*b", "x?z"):
            bank.add_glob(g, "pool")
        out.append(bank.finalize(stride=stride, stride_entries=1 << 21))
    return out


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_tiles_wide_local_ids(stride):
    jbank, tbank = _wide_banks(stride)
    assert max(p.n_states for p in tbank.patterns) > 256
    bank = _port(jbank)
    byt, lens = _pack(_corpus(stride) + ["ab" * 12 + "a" * 9,
                                         "a" + "b" * 8, "b" * 40 + "a" * 9],
                      48, seed=stride)
    ids = jbank.families["pool"]
    want = np.asarray(jdfa.bank_match(jbank, ids, byt, lens))
    got, layout = model_match(bank, ids, byt, lens)
    assert np.array_equal(got, want)
    assert want.any()
    tdir, _ = layout[stride]
    assert (tdir[:, 3] & 1).any(), "no wide tile"
    if stride > 1:
        assert bank.fused_pitch * 512 > 65536
        assert (tdir[:, 3] & 2).any(), "int32 entries stay in global memory"


def _tenant_banks():
    """A tenant family of 300 namespace globs; the fused table's bank
    cap is lowered in both packages so that, as in a full tenant bank,
    the first globs run fused and the rest at stride 1."""
    globs = ([f"tenant-{i:05d}-*-prod" for i in range(280)]
             + [f"t{i:03d}-??-*" for i in range(20)])
    out = []
    for mod in (jdfa, tdfa):
        bank = mod.DfaBank()
        for g in globs:
            bank.add_glob(g, "ns")
        out.append(bank.finalize())
    return globs, out


def _tenant_subjects(globs, S, W, seed):
    rng = np.random.default_rng(seed)
    strs = []
    for i in range(S):
        r = rng.random()
        if r < 0.6:
            g = globs[int(rng.integers(len(globs)))]
            s = "".join("xy"[int(rng.integers(2))] if c == "?" else
                        ("ab" * int(rng.integers(0, 3)) if c == "*" else c)
                        for c in g)
            strs.append(s if rng.random() > 0.05 else s.replace("a", "é", 1))
        else:
            strs.append(["default", "kube-system", "", "tenant-00001-prod"]
                        [int(rng.integers(4))])
    return _pack(strs, W, seed)


def test_tenant_family_tiles_equal_reference(monkeypatch):
    monkeypatch.setattr(jdfa, "MAX_BANK_STRIDE_ENTRIES", 1 << 20)
    monkeypatch.setattr(tdfa, "MAX_BANK_STRIDE_ENTRIES", 1 << 20)
    globs, (jbank, tbank) = _tenant_banks()
    bank = _port(jbank)
    ids = jbank.families["ns"]
    strides = jbank.strides[ids]
    assert set(strides.tolist()) == {1, 4}
    byt, lens = _tenant_subjects(globs, 300, 64, seed=3)
    want = np.asarray(jdfa.bank_match(jbank, ids, byt, lens))
    got, layout = model_match(bank, ids, byt, lens)
    assert np.array_equal(got, want)
    assert want.sum() >= 100
    # the port's bank_match (each group writes its columns in place)
    port = tdfa.bank_match(bank, ids, torch.from_numpy(byt),
                           torch.from_numpy(lens))
    assert np.array_equal(port.numpy(), want)


def test_bank_match_writes_interleaved_strides_in_place():
    """A bank whose strides interleave (large patterns refused by the
    fused table's per-pattern cap run at stride 1 between fused ones):
    each group's columns land where the JAX ``bank_match`` puts them."""
    out = []
    for mod in (jdfa, tdfa):
        bank = mod.DfaBank(budget=64)
        for p in ("a*", "^(ab|cd){1,10}x[0-9]{3}$", "b?c", "*-mid-*-x",
                  "nginx-*", "^v[0-9]{1,4}\\.[0-9]{1,4}$", "z*"):
            if p.startswith("^"):
                bank.add_re2(p, "pool")
            else:
                bank.add_glob(p, "pool")
        out.append(bank.finalize(stride=4, stride_entries=3000))
    jbank, _ = out
    ids = jbank.families["pool"]
    strides = jbank.strides[ids].tolist()
    assert set(strides) == {1, 4}
    assert strides != sorted(strides), "strides do not interleave"
    bank = _port(jbank)
    byt, lens = _pack(_corpus(9), 40, seed=9)
    for sub in (ids, ids[::-1], ids[1::2]):
        want = np.asarray(jdfa.bank_match(jbank, sub, byt, lens))
        for plain in (False, True):
            got = tdfa.bank_match(bank, sub, torch.from_numpy(byt),
                                  torch.from_numpy(lens), plain=plain)
            assert np.array_equal(got.numpy(), want)
        assert np.array_equal(model_match(bank, sub, byt, lens)[0], want)


def test_scan_groups_cover_the_plane_once():
    """``scan_groups`` keeps one DfaTiles a stride group, built once,
    whose columns partition the plane; the bank's full tables are built
    only for a plain scan."""
    jbank, _ = _banks("exact", 4)
    bank = _port(jbank)
    ids = jbank.families["pool"]
    groups = tdfa.scan_groups(bank, ids, "cpu")
    assert tdfa.scan_groups(bank, ids, "cpu") is groups
    assert "_device_tables" not in bank.__dict__
    cols = torch.cat([g.cols for g in groups]).sort().values
    assert torch.equal(cols, torch.arange(len(ids)))
    assert {g.kind for g in groups} <= {"stride1", "fused"}
    for g in groups:
        assert g.width == len(ids) and g.n_tiles >= 1
        assert g.blob.dtype == torch.uint8 and g.tiles.dtype == torch.int32
        # the wrapper's CPU path is the plain twin at the group's columns
        byt, lens = _pack(_corpus(2), 32, seed=2)
        b, ln = torch.from_numpy(byt), torch.from_numpy(lens)
        out = torch.zeros((b.shape[0], len(ids)), dtype=torch.bool)
        fn = kernels.dfa_scan_stride1 if g.kind == "stride1" \
            else kernels.dfa_scan_fused
        fn(b, ln, g, out)
        assert torch.equal(out[:, g.cols], g.plain_scan(b, ln))


@pytest.mark.parametrize("args,want", [
    (("fused", 524288, 96, 1, 2, 53904), 264),
    (("stride1", 524288, 96, 1, 2, 1616), 264),
    (("stride1", 16384, 64, 17, 2615, 92112), 31),
    (("stride1", 1024, 64, 17, 2615, 92112), 15),
    (("fused", 16384, 64, 96, 382, 174384), 4),
    (("fused", 1024, 64, 96, 382, 174384), 1),
    (("stride1", 40, 64, 3, 50, 5000), 1),
])
def test_dfa_chunks_at_the_measured_shapes(args, want):
    """The chunks a tile's subjects split into, for an H100's 132 SMs, at
    the shapes ``chip_smoke.py`` sweeps (the PSS pool lanes at strides 4
    and 1, the tenant families' stride-1 and fused groups at the scan
    and triage shapes) and at a batch smaller than one chunk."""
    c = kernels.dfa_chunks(*args, 132)
    assert c == want
    assert c == 1 or -(-args[1] // c) >= kernels.DFA_MIN_CHUNK
