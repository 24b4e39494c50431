"""kyverno_tpu_torch's CUDA kernels on the card, against their plain
PyTorch twins, and the port's scan on the card against its CPU run.

These need an NVIDIA GPU with nvcc (kernels build at first use into
build/kernels/): they carry the ``cuda`` marker and skip elsewhere.
On a machine with the card: ``python -m pytest tests/test_torch_cuda.py``.
Bool, uint8, int32 and float-bit outputs: tolerance 0."""

import random

import numpy as np
import pytest
import torch

from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.policies import load_pss_policies
from kyverno_tpu_torch.policy.autogen import expand_policy
from kyverno_tpu_torch.tpu import dfa as tdfa
from kyverno_tpu_torch.parallel.sharding import ShardedScanner
from kyverno_tpu_torch.tpu.engine import TorchEngine

from torch_kernel_cases import (MIX_SOURCES, accented_subjects, meta_any_mix,
                                random_row_tape, row_lanes)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _uncached():
    """The port's verdict and encode caches are on by default and keyed
    by content, not by device: a CPU engine over the card engine's
    compiled set would answer from the card's cached columns. Every test
    here starts from empty caches and store, with both caches off, so a
    card-vs-CPU comparison runs both scans; a test that wants a cache
    turns it on itself."""
    from kyverno_tpu_torch.cluster.columnar import reset_store
    from kyverno_tpu_torch.tpu.cache import (global_encode_cache,
                                             global_verdict_cache)

    caches = (global_verdict_cache, global_encode_cache)
    caps = [c._lru.capacity for c in caches]
    for c in caches:
        c.clear()
        c.set_capacity(0)
    reset_store()
    yield
    reset_store()
    for c, cap in zip(caches, caps):
        c.clear()
        c.set_capacity(cap)


def _subjects(seed, S=4096, W=96):
    g = torch.Generator().manual_seed(seed)
    byt = torch.randint(0, 256, (S, W), generator=g, dtype=torch.uint8)
    lens = torch.randint(0, W + 8, (S,), generator=g, dtype=torch.int32)
    return byt, lens


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_dfa_scan_kernel_equals_plain(cuda, stride):
    bank = tdfa.DfaBank(budget=12)
    for p in ("a*b", "nginx-?", "*-suffix-*-mid-*-tail", "localhost/*"):
        bank.add_glob(p, "pool")
    bank.add_re2("^(ab|cd){1,10}x[0-9]{3}$", "pool")
    bank.finalize(stride=stride)
    byt, lens = _subjects(stride)
    ids = bank.families["pool"]
    want = tdfa.bank_match(bank, ids, byt, lens)
    got = tdfa.bank_match(bank, ids, byt.to(cuda), lens.to(cuda))
    assert torch.equal(got.cpu(), want)
    na = tdfa.nonascii_mask(byt.to(cuda), lens.to(cuda))
    assert torch.equal(na.cpu(), kernels.nonascii_plain(byt, lens))


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("W", [64, 33])
def test_k1_nonascii_flag_equals_plain(cuda, stride, W):
    """K1's flag from the walk of pattern 0 (B4): on subjects with an
    accented letter inside or past the length, both entries' flags
    equal ``nonascii_plain``, and the plane the plain scan's."""
    bank = tdfa.DfaBank(budget=12)
    for p in ("a*b", "nginx-?", "*-suffix-*-mid-*-tail", "localhost/*"):
        bank.add_glob(p, "pool")
    bank.add_re2("^(ab|cd){1,10}x[0-9]{3}$", "pool")
    bank.finalize(stride=stride)
    byt, lens = (torch.from_numpy(a) for a in
                 accented_subjects(stride * 100 + W, 4096, W))
    ids = bank.families["pool"]
    want = tdfa.bank_match(bank, ids, byt, lens)
    got, na = tdfa.bank_match(bank, ids, byt.to(cuda), lens.to(cuda),
                              want_nonascii=True)
    flag = kernels.nonascii_plain(byt, lens)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(na.cpu(), flag) and 0 < int(flag.sum()) < 4096


@pytest.mark.parametrize("S,W,offset", [(16384, 64, 0), (1024, 64, 0),
                                        (3000, 33, 1), (500, 1000, 0)])
def test_standalone_nonascii_equals_plain(cuda, S, W, offset):
    """The standalone B4 entry: W/16 lanes a subject, one 16-byte load a
    lane, one ballot; rows of another pitch or alignment are padded."""
    byt, lens = (torch.from_numpy(a) for a in
                 accented_subjects(S + W, S, W))
    flat = torch.empty((byt.numel() + offset,), dtype=torch.uint8,
                       device=cuda)
    dev = flat[offset:].view(byt.shape)
    dev.copy_(byt)
    kernels.reset_launches()
    na = kernels.nonascii(dev, lens.to(cuda))
    assert kernels.LAUNCHES["nonascii"] == 1
    flag = kernels.nonascii_plain(byt, lens)
    assert torch.equal(na.cpu(), flag) and 0 < int(flag.sum()) < S


def _tenant_bank(monkeypatch, n=300):
    """A tenant family of ``n`` namespace globs; the fused table's cap is
    lowered so that, as in a full tenant bank, the first globs run fused
    and the rest at stride 1."""
    monkeypatch.setattr(tdfa, "MAX_BANK_STRIDE_ENTRIES", 1 << 19)
    bank = tdfa.DfaBank()
    globs = [f"tenant-{i:05d}-*-prod" for i in range(n - 20)] + [
        f"t{i:03d}-??-*" for i in range(20)]
    for g in globs:
        bank.add_glob(g, "ns")
    return globs, bank.finalize()


def _tenant_lane(globs, S, W=64, seed=0):
    rng = random.Random(seed)
    byt = torch.zeros((S, W), dtype=torch.uint8)
    lens = torch.zeros((S,), dtype=torch.int32)
    for i in range(S):
        g = rng.choice(globs)
        s = "".join(rng.choice("xy") if c == "?" else
                    ("ab" * rng.randint(0, 3) if c == "*" else c) for c in g)
        s = rng.choice([s, s, s.replace("a", "é", 1), "", "default"])
        e = s.encode()[:W]
        byt[i, :len(e)] = torch.tensor(list(e), dtype=torch.uint8)
        lens[i] = len(s.encode()) + (W if i % 97 == 0 else 0)
    return byt, lens


@pytest.mark.parametrize("S", [1024, 5000])
def test_dfa_tiles_tenant_family_equal_plain(cuda, monkeypatch, S):
    """Both K1 entries over a 300-glob family (241 stride-1 patterns in
    two tiles, 59 fused ones in five) at the triage batch size and past
    it, writing the family plane in place."""
    globs, bank = _tenant_bank(monkeypatch)
    ids = bank.families["ns"]
    groups = tdfa.scan_groups(bank, ids, cuda)
    assert {g.kind for g in groups} == {"stride1", "fused"}
    assert all(g.n_tiles > 1 for g in groups)
    byt, lens = _tenant_lane(globs, S)
    kernels.reset_launches()
    got = tdfa.bank_match(bank, ids, byt.to(cuda), lens.to(cuda))
    assert kernels.LAUNCHES["dfa_scan_stride1"] == 1
    assert kernels.LAUNCHES["dfa_scan_fused"] == 1
    want = tdfa.bank_match(bank, ids, byt, lens)
    assert torch.equal(got.cpu(), want) and int(want.sum()) > 0


@pytest.mark.parametrize("budget", [(600, 30000), (300, 3000)])
def test_dfa_tiles_small_and_global_tiles_equal_plain(cuda, budget):
    """Tiles packed with small budgets: many tiles, and patterns larger
    than a tile read in place from global memory."""
    byt, lens = _subjects(9, S=3000, W=80)
    for stride in (1, 4):
        bank = tdfa.DfaBank(budget=48)
        for p in ("a*b", "nginx-?", "*-suffix-*-mid-*-tail", "localhost/*",
                  "prefix-????-*-????-end", "x*y*z*w", "*.example.com"):
            bank.add_glob(p, "pool")
        bank.add_re2("^(ab|cd){1,10}x[0-9]{3}$", "pool")
        bank.add_re2("^v[0-9]{1,4}\\.[0-9]{1,4}$", "pool")
        bank.finalize(stride=stride)
        ids = [i for i in bank.families["pool"]
               if int(bank.strides[i]) == stride]
        (g,) = tdfa.scan_groups(bank, ids, cuda)
        cols = list(range(len(ids)))
        if stride == 1:
            blob, tdir, smem = kernels.pack_stride1(
                bank.trans, bank.class_map, bank.start, bank.accept, ids,
                cols, budget=budget[0])
        else:
            blob, tdir, smem = kernels.pack_fused(
                bank.fused_trans, int(bank.fused_pitch), bank.fused_start,
                bank.fused_accept, ids, cols, budget=budget[1])
        assert tdir.shape[0] > 1 and (tdir[:, 3] & 2).any()
        tiles = kernels.DfaTiles(
            g.kind, len(ids), g.cols, torch.from_numpy(blob).to(cuda),
            torch.from_numpy(tdir).to(cuda), smem, g.plain_args, g.pairs,
            g.pitch)
        fn = kernels.dfa_scan_stride1 if stride == 1 \
            else kernels.dfa_scan_fused
        out = torch.empty((byt.shape[0], len(ids)), dtype=torch.bool,
                          device=cuda)
        got, na = fn(byt.to(cuda), lens.to(cuda), tiles, out,
                     want_nonascii=True)
        assert torch.equal(got.cpu(), tdfa.bank_match(bank, ids, byt, lens))
        assert torch.equal(na.cpu(), kernels.nonascii_plain(byt, lens))


@pytest.mark.parametrize("stride", [1, 4])
def test_dfa_tiles_wide_local_ids_equal_plain(cuda, stride):
    """A 512-state pattern: uint16 local ids at stride 1, int32 fused
    entries read from global memory at stride 4."""
    bank = tdfa.DfaBank(budget=600)
    bank.add_re2("^[ab]*a[ab]{8}$", "pool")
    for g in ("0123456789*", "klmnopqrst*", "uvwxyz-_.:*", "a*b", "x?z"):
        bank.add_glob(g, "pool")
    bank.finalize(stride=stride, stride_entries=1 << 21)
    ids = bank.families["pool"]
    groups = tdfa.scan_groups(bank, ids, cuda)
    assert any(int((g.tiles[:, 3] & 1).sum()) for g in groups)
    g = torch.Generator().manual_seed(stride)
    byt = torch.randint(97, 99, (4096, 48), generator=g, dtype=torch.uint8)
    lens = torch.randint(0, 56, (4096,), generator=g, dtype=torch.int32)
    got = tdfa.bank_match(bank, ids, byt.to(cuda), lens.to(cuda))
    want = tdfa.bank_match(bank, ids, byt, lens)
    assert torch.equal(got.cpu(), want) and int(want.sum()) > 0


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("W,offset", [(33, 0), (64, 1), (33, 3)])
def test_dfa_scan_unpadded_rows_equal_plain(cuda, stride, W, offset):
    """Rows of a width that is no multiple of 4, or from a base that is
    not 4-byte aligned: the wrapper pads them to words for the kernel;
    both entries and the non-ASCII output equal the plain twins."""
    bank = tdfa.DfaBank(budget=12)
    for p in ("a*b", "nginx-?", "*-suffix-*-mid-*-tail", "localhost/*"):
        bank.add_glob(p, "pool")
    bank.add_re2("^(ab|cd){1,10}x[0-9]{3}$", "pool")
    bank.add_re2("[a-c]+é", "pool")
    bank.finalize(stride=stride)
    ids = bank.families["pool"]
    byt, lens = _subjects(W + stride, S=3000, W=W)
    flat = torch.empty((byt.numel() + offset,), dtype=torch.uint8,
                       device=cuda)
    dev = flat[offset:].view(byt.shape)
    dev.copy_(byt)
    assert dev.is_contiguous() and (dev.data_ptr() % 4 == 0) == (offset == 0)
    dl = lens.to(cuda)
    for g in tdfa.scan_groups(bank, ids, cuda):
        fn = kernels.dfa_scan_stride1 if g.kind == "stride1" \
            else kernels.dfa_scan_fused
        out = torch.zeros((byt.shape[0], len(ids)), dtype=torch.bool,
                          device=cuda)
        kernels.reset_launches()
        got, na = fn(dev, dl, g, out, want_nonascii=True)
        assert kernels.LAUNCHES[f"dfa_scan_{g.kind}"] == 1
        assert torch.equal(got[:, g.cols], g.plain_scan(byt.to(cuda), dl))
        assert torch.equal(na.cpu(), kernels.nonascii_plain(byt, lens))
    assert torch.equal(tdfa.bank_match(bank, ids, dev, dl).cpu(),
                       tdfa.bank_match(bank, ids, byt, lens))


def test_instance_count_kernel_equals_plain(cuda):
    g = torch.Generator().manual_seed(3)
    N, R, I = 512, 256, 16
    pred = torch.rand((N, R), generator=g) < 0.5
    valid = torch.rand((N, R), generator=g) < 0.8
    s1 = torch.randint(-1, I + 3, (N, R), generator=g, dtype=torch.int32)
    s2 = torch.randint(-1, I + 3, (N, R), generator=g, dtype=torch.int32)
    d = [t.to(cuda) for t in (pred, s1, s2, valid)]
    assert torch.equal(kernels.instance_count(d[0], d[1], d[3], I).cpu(),
                       kernels.instance_count_plain(pred, s1, valid, I))
    assert torch.equal(kernels.instance_count2(*d, I).cpu(),
                       kernels.instance_count_plain(pred, s1, valid, I, s2))


@pytest.mark.parametrize("R", [256, 200, 37])
@pytest.mark.parametrize("I", [4, 16, 33, 64])
def test_instance_count_many_kernel_equals_plain(cuda, I, R):
    """1 to 8 predicates a launch (contiguous, strided, unaligned and
    broadcast; count, any and mixed) on hazard scopes. R = 37 and the
    unaligned predicate take the byte loads; at R = 200 a warp's last
    lanes hold no row."""
    g = torch.Generator().manual_seed(I + R)
    N = 1001
    valid = torch.rand((N, R), generator=g) < 0.8
    s1 = torch.randint(-1, I + 3, (N, R), generator=g, dtype=torch.int32)
    wide = torch.rand((N, R + 8), generator=g) < 0.4
    row = torch.rand((1, R), generator=g) < 0.5
    full = [torch.rand((N, R), generator=g) < q for q in (0.5, 0.02, 0.9)]
    full += [torch.ones((N, R), dtype=torch.bool),
             torch.zeros((N, R), dtype=torch.bool)]

    def views(w, r, f):  # strided, unaligned, broadcast, contiguous
        return [w[:, :R], w[:, 3:R + 3], r.expand(N, R)] + f

    preds = views(wide, row, full)
    dpreds = views(wide.to(cuda), row.to(cuda), [f.to(cuda) for f in full])
    assert dpreds[2].stride(0) == 0 and dpreds[0].stride(0) == R + 8
    sc = kernels.scope8(s1, valid, I)
    dsc = sc.to(cuda)
    for P in range(1, 9):
        for want in ("count", "any",
                     ["any" if q % 2 else "count" for q in range(P)]):
            kernels.reset_launches()
            got = kernels.instance_count_many(dpreds[:P], dsc, I, want)
            assert kernels.LAUNCHES["instance_count"] == 1
            ref = kernels.instance_count_many_plain(preds[:P], sc, I, want)
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    one = kernels.instance_count(full[0].to(cuda), s1.to(cuda),
                                 valid.to(cuda), I)
    assert torch.equal(one.cpu(),
                       kernels.instance_count_plain(full[0], s1, valid, I))


def test_verdict_counts_kernel_equals_plain(cuda):
    g = torch.Generator().manual_seed(4)
    table = torch.randint(0, 7, (66, 5000), generator=g, dtype=torch.int32)
    assert torch.equal(kernels.verdict_counts(table.to(cuda)).cpu(),
                       kernels.verdict_counts_plain(table))


def test_pss_scan_on_the_card_equals_cpu(cuda):
    eng = TorchEngine([expand_policy(p) for p in load_pss_policies()])
    rng = random.Random(5)
    pods = []
    for i in range(100):
        sc = {"privileged": rng.random() < 0.3}
        pods.append({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": f"p{i}", "namespace": "d"},
                     "spec": {"containers": [{"name": "c", "image": "nginx",
                                              "securityContext": sc}]}})
    kernels.reset_launches()
    got = eng.scan_device(pods)
    assert kernels.LAUNCHES["dfa_scan_fused"] > 0
    assert kernels.LAUNCHES["instance_count"] > 0
    assert kernels.LAUNCHES["verdict_counts"] == 1
    assert kernels.LAUNCHES["hash_match"] > 0
    assert kernels.LAUNCHES["pool_rows"] > 0
    assert kernels.LAUNCHES["first_true_take"] > 0
    cpu = TorchEngine(cps=eng.cps, device="cpu")
    want = cpu.scan_device(pods)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    full, full_cpu = eng.scan(pods), cpu.scan(pods)
    assert np.array_equal(full.verdicts, full_cpu.verdicts)
    assert full.rules == full_cpu.rules


def test_cached_scan_on_the_card_equals_uncached_cpu(cuda):
    """With the verdict cache on (its default), a repeat scan on the card
    restores every column from the cache and equals both its cold scan
    and the CPU engine's scan taken with the cache off."""
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.tpu.cache import global_verdict_cache as vc

    def hits():
        return global_registry.verdict_cache.value({"outcome": "hit"})

    eng = TorchEngine([expand_policy(p) for p in load_pss_policies()])
    pods = _pss_pods(100, 11)
    want = TorchEngine(cps=eng.cps, device="cpu").scan(pods)
    vc.set_capacity(65536)
    cold = eng.scan(pods)
    before = hits()
    kernels.reset_launches()
    warm = eng.scan(pods)
    assert hits() - before == len(pods)
    assert sum(kernels.LAUNCHES.values()) == 0
    for got in (cold, warm):
        assert np.array_equal(got.verdicts, want.verdicts)
        assert got.rules == want.rules


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("idx_dtype", ["uint8", "uint16", "int32"])
def test_vocab_gather_kernel_equals_plain(cuda, idx_dtype):
    """All lane element types in one launch, over uint8 / uint16 /
    int32 index tables with out-of-range and negative (int32) indices."""
    g = torch.Generator().manual_seed(7)
    V, N, R = 1000, 257, 64
    srcs = [torch.randint(0, 256, (V,), generator=g, dtype=torch.uint8),
            torch.randint(-2 ** 31, 2 ** 31 - 1, (V,), generator=g,
                          dtype=torch.int32),
            torch.randn((V,), generator=g)]
    fills = [0xFF, 0xFFFFFFFF, 0x7FC00000]
    if idx_dtype == "uint8":
        idx = torch.randint(0, 256, (N, R), generator=g, dtype=torch.uint8)
    elif idx_dtype == "uint16":  # built through int16 bits
        idx = torch.randint(0, 65536, (N, R), generator=g, dtype=torch.int32
                            ).to(torch.int16).view(torch.uint16)
    else:
        idx = torch.randint(-V - 50, V + 50, (N, R), generator=g,
                            dtype=torch.int32)
    got = kernels.vocab_gather([s.to(cuda) for s in srcs], idx.to(cuda), fills)
    for s, f, o in zip(srcs, fills, got):
        want = kernels.vocab_gather_plain(s, idx, f)
        assert torch.equal(_bits(o.cpu()), _bits(want))


def _lanes_of(g, sizes, V):
    """Seeded vocabulary lanes of the given element sizes (1: uint8; 4:
    int32, uint32 bits or float32 in turn) and their fills."""
    srcs, fills = [], []
    for i, e in enumerate(sizes):
        if e == 1:
            srcs.append(torch.randint(0, 256, (V,), generator=g,
                                      dtype=torch.uint8))
            fills.append(0xFF)
        elif i % 3 == 2:
            srcs.append(torch.randn((V,), generator=g))
            fills.append(0x7FC00000)
        else:
            srcs.append(torch.randint(-2 ** 31, 2 ** 31 - 1, (V,),
                                      generator=g, dtype=torch.int32))
            fills.append(0xFFFFFFFF if i % 3 else 0x80000000)
    return srcs, fills


@pytest.mark.parametrize("n_lanes", [1, 2, 7, 17, 40])
@pytest.mark.parametrize("cells", [1, 15, 16, 17, 4095, 4097, 1100001])
@pytest.mark.parametrize("idx_dtype", ["uint8", "uint16", "int32"])
def test_vocab_gather_plan_forms_equal_plain(cuda, n_lanes, cells,
                                             idx_dtype):
    """K5's row entry over 1 to 40 lanes of mixed sizes, at cell counts
    one either side of the 16- and 4-cell vectors and of a chunk's
    4,096 cells, and past a resident grid's chunks (1,100,001 cells: the
    grid-stride loop), with an aligned and an unaligned index view."""
    g = torch.Generator().manual_seed(n_lanes * 7919 + cells)
    V = 3000
    sizes = [1 if (i * 5) % 3 == 0 else 4 for i in range(n_lanes)]
    srcs, fills = _lanes_of(g, sizes, V)
    if idx_dtype == "uint8":
        big = torch.randint(0, 256, (cells + 1,), generator=g,
                            dtype=torch.uint8)
    elif idx_dtype == "uint16":
        big = torch.randint(0, 65536, (cells + 1,), generator=g,
                            dtype=torch.int32).to(torch.int16).view(
                                torch.uint16)
    else:
        big = torch.randint(-V - 50, V + 50, (cells + 1,), generator=g,
                            dtype=torch.int32)
    dev_srcs = [s.to(cuda) for s in srcs]
    dbig = big.to(cuda)
    for off in (0, 1):  # the second view starts one element in
        idx = dbig[off:off + cells].view(1, cells)
        want = [kernels.vocab_gather_plain(s, big[off:off + cells].view(
            1, cells), f) for s, f in zip(srcs, fills)]
        got = kernels.vocab_gather(dev_srcs, idx, fills)
        for o, w in zip(got, want):
            assert torch.equal(_bits(o.cpu()), _bits(w)), off


def test_vocab_gather_rejects_41_lanes(cuda):
    g = torch.Generator().manual_seed(1)
    srcs, fills = _lanes_of(g, [1] * 41, 10)
    with pytest.raises(ValueError):
        kernels.vocab_gather([s.to(cuda) for s in srcs],
                             torch.zeros((2, 3), dtype=torch.uint8,
                                         device=cuda), fills)


def test_vocab_gather_rows_kernel_equals_plain(cuda):
    g = torch.Generator().manual_seed(8)
    Sv, W, N, K = 300, 96, 513, 32
    svocab = torch.randint(0, 256, (Sv, W), generator=g, dtype=torch.uint8)
    slen = torch.randint(0, W, (Sv,), generator=g, dtype=torch.int32)
    idx = torch.randint(-Sv - 5, Sv + 5, (N, K), generator=g,
                        dtype=torch.int32)
    rows, lens = kernels.vocab_gather_rows(svocab.to(cuda), slen.to(cuda),
                                           idx.to(cuda))
    want_rows, want_lens = kernels.vocab_gather_rows_plain(svocab, slen, idx)
    assert torch.equal(rows.cpu(), want_rows)
    assert torch.equal(lens.cpu(), want_lens)
    # a row width that is no multiple of 16 takes the byte path
    odd = svocab[:, :90].contiguous()
    rows2, _ = kernels.vocab_gather_rows(odd.to(cuda), None, idx.to(cuda))
    assert torch.equal(rows2.cpu(),
                       kernels.vocab_gather_rows_plain(odd, None, idx)[0])


@pytest.mark.parametrize("k", [0, 1, 5, 40])
def test_hash_match_kernel_equals_plain(cuda, k):
    g = torch.Generator().manual_seed(9)
    N, R = 513, 64
    pool = torch.tensor([0, 1, -1, -2 ** 31, 2 ** 31 - 1, 77], dtype=torch.int32)
    hi = pool[torch.randint(0, 6, (N, R), generator=g)]
    lo = pool[torch.randint(0, 6, (N, R), generator=g)]
    valid = torch.rand((N, R), generator=g) < 0.7
    pairs = [(int(pool[a]), int(pool[b])) for a, b in
             torch.randint(0, 6, (k, 2), generator=g).tolist()]
    consts = kernels.hash_consts(pairs, "cpu")
    for v in (None, valid):
        got = kernels.hash_match(hi.to(cuda), lo.to(cuda),
                                 kernels.hash_consts(pairs, cuda),
                                 None if v is None else v.to(cuda))
        assert torch.equal(got.cpu(), kernels.hash_match_plain(hi, lo, consts, v))


def test_pool_rows_kernel_equals_plain(cuda):
    g = torch.Generator().manual_seed(10)
    N, K, P, R = 513, 32, 3, 64
    accepts = torch.rand((N, K, P), generator=g) < 0.3
    slot = torch.randint(-1, K + 4, (N, R), generator=g, dtype=torch.int32)
    slot[0, 0] = -2 ** 31
    for p in range(P):
        plane = accepts[..., p]
        got = kernels.pool_rows(accepts.to(cuda)[..., p], slot.to(cuda))
        assert torch.equal(got.cpu(), kernels.pool_rows_plain(plane, slot))


@pytest.mark.parametrize("K", [1, 32, 33, 64, 100, 200, 256, 300])
@pytest.mark.parametrize("R", [1, 3, 4, 128, 130, 256])
def test_pool_rows_forms_equal_plain(cuda, K, R):
    """K7 in every form: a plane row of one, two, four or eight mask
    words in registers and one read in global memory (K 300); 4 slots a
    load (R a multiple of 4) and 1 (R 1, 3, 130, or a slot view one
    int32 off 16-byte alignment); strided and contiguous planes; N above
    one wave (20,000 resources are 2,500 blocks of 8); INT_MIN, -1 and
    out-of-range slots."""
    g = torch.Generator().manual_seed(K * 1000 + R)
    N = 20000 if R == 128 else 1031
    accepts = torch.rand((N, K, 3), generator=g) < 0.4
    big = torch.randint(-2, K + 3, (N * R + 1,), generator=g,
                        dtype=torch.int32)
    big[5] = -2 ** 31
    big[-1] = 2 ** 31 - 1
    dacc, dbig = accepts.to(cuda), big.to(cuda)
    for off in (0, 1):
        slot = big[off:off + N * R].view(N, R)
        dslot = dbig[off:off + N * R].view(N, R)
        for plane, dplane in ((accepts[..., 1], dacc[..., 1]),
                              (accepts[..., 2].contiguous(),
                               dacc[..., 2].contiguous())):
            form = kernels.pool_rows_form(dplane, dslot)
            assert ("global" in form) == (K > 256), form
            assert ("4 slots" in form) == (R % 4 == 0 and off == 0), form
            got = kernels.pool_rows(dplane, dslot)
            assert torch.equal(got.cpu(), kernels.pool_rows_plain(plane,
                                                                  slot))


@pytest.mark.parametrize("R", [1, 31, 64, 256, 300])
def test_first_true_take_kernel_equals_plain(cuda, R):
    g = torch.Generator().manual_seed(R)
    N = 1000
    accept = torch.rand((N, R), generator=g) < 2.0 / R
    accept[:7] = False
    pred = torch.rand((N, R), generator=g) < 0.5
    has, val_ok = kernels.first_true_take(accept.to(cuda), pred.to(cuda))
    want_has, want_val = kernels.first_true_take_plain(accept, pred)
    assert torch.equal(has.cpu(), want_has)
    assert torch.equal(val_ok.cpu(), want_val)


def test_verdict_counts_u8_kernel_equals_plain(cuda):
    g = torch.Generator().manual_seed(11)
    table = torch.randint(0, 7, (66, 8192), generator=g, dtype=torch.int32)
    t8, counts = kernels.verdict_counts_u8(table.to(cuda))
    w8, wc = kernels.verdict_counts_u8_plain(table)
    assert t8.dtype == torch.uint8 and torch.equal(t8.cpu(), w8)
    assert torch.equal(counts.cpu(), wc)


def _table(rules, N, seed, offset=0):
    """A (rules, N) int32 table of the codes 0..6 with 7 and -1 mixed in;
    ``offset`` cells into its buffer (4 bytes: no 16-byte row start)."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randint(-1, 8, (offset + rules * N,), generator=g,
                         dtype=torch.int32)
    return flat[offset:].view(rules, N)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("N", [1, 3, 1000, 5000, 8192, 16384, 16387])
@pytest.mark.parametrize("rules", [1, 66])
def test_verdict_counts_forms_equal_plain(cuda, rules, N, offset):
    table = _table(rules, N, rules * N + offset, offset)
    if offset:  # the same misaligned view on the card
        flat = torch.empty(offset + rules * N, dtype=torch.int32,
                           device=cuda)
        dev = flat[offset:].view(rules, N).copy_(table)
        assert dev.data_ptr() % 16 != 0
    else:
        dev = table.to(cuda)
    counts = kernels.verdict_counts(dev)
    t8, counts8 = kernels.verdict_counts_u8(dev)
    want8, wantc = kernels.verdict_counts_u8_plain(table)
    assert torch.equal(counts.cpu(), wantc)
    assert torch.equal(counts8.cpu(), wantc)
    assert t8.dtype == torch.uint8 and torch.equal(t8.cpu(), want8)


def test_verdict_counts_cluster_launch_replays_in_a_graph(cuda):
    table = _table(66, 8192, 12).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.verdict_counts_u8(table)  # built and loaded before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        t8, counts = kernels.verdict_counts_u8(table)
    table.copy_(_table(66, 8192, 13).to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    want8, wantc = kernels.verdict_counts_u8_plain(table.cpu())
    assert torch.equal(t8.cpu(), want8) and torch.equal(counts.cpu(), wantc)


def test_verdict_counts_refused_launch_raises_kernel_error(cuda):
    table = _table(2, 64, 1).to(cuda)
    out = torch.empty((2, 7), dtype=torch.int32, device=cuda)
    kernels.build_all()
    with pytest.raises(kernels.KernelError):  # 2,048 threads a block
        kernels._call("verdict_counts", table.device, kernels._ptr(table),
                      2, 64, kernels._ptr(out), None, 1, 2048, 1)
    # nothing sticky: the next launch runs
    assert torch.equal(kernels.verdict_counts(table).cpu(),
                       kernels.verdict_counts_plain(table.cpu()))


def _take_masks(N, R, seed):
    """Rows whose only true cell is the first or the last, rows with
    none, and random rows."""
    g = torch.Generator().manual_seed(seed)
    accept = torch.rand((N, R), generator=g) < 2.0 / R
    accept[0::4] = False
    accept[1::4] = False
    accept[1::4, 0] = True
    accept[2::4] = False
    accept[2::4, R - 1] = True
    pred = torch.rand((N, R), generator=g) < 0.5
    return accept, pred


@pytest.mark.parametrize("N", [1, 7, 1000])
@pytest.mark.parametrize("R", [1, 16, 31, 45, 128, 256, 300, 600])
def test_first_true_take_forms_equal_plain(cuda, R, N):
    accept, pred = _take_masks(N, R, R * 10 + N)
    want = kernels.first_true_take_plain(accept, pred)
    got = kernels.first_true_take(accept.to(cuda), pred.to(cuda))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    # an accept mask off 16 bytes takes the warp walk
    flat = torch.zeros(1 + N * R, dtype=torch.bool, device=cuda)
    off = flat[1:].view(N, R).copy_(accept.to(cuda))
    got = kernels.first_true_take(off, pred.to(cuda))
    want = kernels.first_true_take_plain(accept, pred)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_sharded_scanner_on_the_card_equals_cpu(cuda):
    policies = [expand_policy(p) for p in load_pss_policies()]
    sc = ShardedScanner(policies)
    cpu = ShardedScanner(policies, device="cpu")
    rng = random.Random(6)
    pods = []
    for i in range(70):
        ann = ({"container.apparmor.security.beta.kubernetes.io/c":
                rng.choice(["runtime/default", "unconfined"])}
               if rng.random() < 0.3 else {})
        pods.append({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": f"p{i}", "namespace": "d",
                                  "annotations": ann},
                     "spec": {"containers": [{"name": "c", "image": "nginx"}]}})
    kernels.reset_launches()
    got = sc.scan_device(pods)
    for name in ("vocab_gather", "vocab_gather_rows", "hash_match",
                 "pool_rows", "first_true_take", "verdict_counts_u8"):
        assert kernels.LAUNCHES[name] > 0, name
    want = cpu.scan_device(pods)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    a, _ = sc.scan_stream(pods, tile=32)
    b, _ = cpu.scan_stream(pods, tile=32)
    assert np.array_equal(a.verdicts, b.verdicts)


GLOB_PATTERNS = ["", "*", "***", "?", "a*b?c*", "é*", "中?", "t?-1-*",
                 "tenant-0*-*-prod", "a" * 63, "a" * 64, "a" * 65,
                 "a*" * 40 + "?", ("ab*?" * 75)[:299], "a*" * 520]


def _glob_subjects(pattern, lead, seed):
    """Subjects over the pattern's own bytes, NUL and non-ASCII; half
    are instances of the pattern; lengths include -1, 0, B, B + 3."""
    rng = np.random.default_rng(seed)
    alpha = np.array(sorted({ord(c) & 0xFF for c in pattern if c not in "*?"})
                     + [0, 0x2D, 0x61, 0x62, 0xE9, 0xFF], dtype=np.uint8)
    B = max(8, len(pattern) + 2 * pattern.count("*") + 12)
    n = int(np.prod(lead))
    byt = rng.choice(alpha, size=(n, B)).astype(np.uint8)
    lens = rng.integers(0, B + 1, size=(n,)).astype(np.int32)
    for i in range(0, n, 2):
        inst = []
        for c in pattern:
            if c == "*":
                inst += list(rng.choice(alpha, size=int(rng.integers(0, 4))))
            elif c == "?":
                inst.append(int(rng.choice(alpha[alpha != 0])))
            else:
                inst.append(ord(c) & 0xFF)
        inst = inst[:B]
        byt[i, :len(inst)] = inst
        lens[i] = len(inst)
    lens[:4] = [-1, 0, B, B + 3]
    return (torch.from_numpy(byt.reshape(tuple(lead) + (B,))),
            torch.from_numpy(lens.reshape(tuple(lead))))


@pytest.mark.parametrize("lead", [(3000,), (300, 11)])
@pytest.mark.parametrize("pattern", GLOB_PATTERNS)
def test_glob_nfa_kernel_equals_plain(cuda, pattern, lead):
    byt, lens = _glob_subjects(pattern, lead, seed=len(pattern))
    want = kernels.glob_nfa_plain(pattern, byt, lens)
    kernels.reset_launches()
    got = kernels.glob_nfa(pattern, byt.to(cuda), lens.to(cuda))
    assert kernels.LAUNCHES["glob_nfa"] == 1
    assert got.dtype == torch.bool and torch.equal(got.cpu(), want)
    assert int(want.sum()) > 0


@pytest.mark.parametrize("lead", [(3000,), (300, 11)])
def test_glob_nfa_pack_kernel_equals_plain(cuda, lead):
    """GLOB_PATTERNS in packs of 1 to 32 64-bit state words, one launch
    a pack, over subjects of every pattern with hostile lengths."""
    parts = [_glob_subjects(p, (lead[0] // 3,), seed=i)
             for i, p in enumerate(GLOB_PATTERNS[::3])]
    B = max(b.shape[-1] for b, _ in parts)
    byt = torch.cat([torch.nn.functional.pad(b, (0, B - b.shape[-1]))
                     for b, _ in parts])
    lens = torch.cat([ln for _, ln in parts])
    n = byt.shape[0] - byt.shape[0] % int(np.prod(lead[1:], dtype=int))
    byt = byt[:n].reshape((-1,) + tuple(lead[1:]) + (B,)).contiguous()
    lens = lens[:n].reshape((-1,) + tuple(lead[1:])).contiguous()
    packs = kernels.glob_packs(GLOB_PATTERNS)
    assert [p.nw for p in packs] == [1, 2, 8, 32]
    for pack in packs:
        kernels.reset_launches()
        got = kernels.glob_nfa_pack(pack, byt.to(cuda), lens.to(cuda))
        assert kernels.LAUNCHES["glob_nfa"] == 1
        assert torch.equal(got.cpu(),
                           kernels.glob_nfa_pack_plain(pack, byt, lens))


def test_glob_nfa_pack_tiles_patterns_past_shared_memory(cuda):
    """1,250 tenant globs of 64-bit words do not fit one block's shared
    memory: the pattern tiles over the grid's second axis give the plain
    twin's answers."""
    globs = [f"tenant-{i:05d}-*-production-east-zone" for i in range(1150)] + [
        f"t{i:03d}-??-*-production-east-zone" for i in range(100)]
    pack = kernels.GlobPack(globs)
    assert pack.nw == 1
    assert len(pack.patterns) * pack.classes * 8 > 200 * 1024
    rng = random.Random(3)
    names = [(f"tenant-{rng.randrange(1250):05d}-x{'é' if i % 50 == 0 else ''}"
              f"-production-east-zone" if i % 3 else
              f"t{rng.randrange(100):03d}-ab--production-east-zone"
              ).encode()[:64] for i in range(2048)]
    byt = torch.zeros((2048, 64), dtype=torch.uint8)
    for i, nm in enumerate(names):
        byt[i, :len(nm)] = torch.tensor(list(nm), dtype=torch.uint8)
    lens = torch.tensor([len(nm) for nm in names], dtype=torch.int32)
    lens[:3] = torch.tensor([-1, 0, 70], dtype=torch.int32)
    kernels.reset_launches()
    got = kernels.glob_nfa_pack(pack, byt.to(cuda), lens.to(cuda))
    assert kernels.LAUNCHES["glob_nfa"] == 1
    want = kernels.glob_nfa_pack_plain(pack, byt.to(cuda), lens.to(cuda))
    assert torch.equal(got, want) and int(got.sum()) > 0


def test_glob_nfa_kernel_pattern_longer_than_subjects(cuda):
    """More non-'*' characters than bytes: all False, no launch."""
    byt, lens = _glob_subjects("ab", (64,), seed=1)
    kernels.reset_launches()
    got = kernels.glob_nfa("x" * (byt.shape[-1] + 1), byt.to(cuda),
                           lens.to(cuda))
    assert kernels.LAUNCHES["glob_nfa"] == 0 and not got.any()
    assert not kernels.glob_nfa_plain("x" * (byt.shape[-1] + 1), byt,
                                      lens).any()


def test_tenant_overflow_on_the_card_equals_cpu(cuda, monkeypatch):
    """A tenant set whose namespace globs overflow a lowered bank: the
    scan and the mutate triage on the card launch K9, take the namespace
    family's non-ASCII flag from its K1 launch (the bank scans the
    family, so no standalone entry runs), and equal the CPU run."""
    from kyverno_tpu_torch.api.policy import ClusterPolicy

    monkeypatch.setattr(tdfa, "MAX_BANK_STATES", 200)
    globs = ([f"tenant-{i:03d}-*-prod" for i in range(12)]
             + [f"t?-{i}-*" for i in range(4)])
    match = {"resources": {"kinds": ["Pod"], "namespaces": globs}}
    pol = ClusterPolicy.from_dict({
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "tenant"},
        "spec": {"validationFailureAction": "Enforce", "rules": [
            {"name": "require-team", "match": match,
             "validate": {"pattern": {"metadata": {"labels": {"team": "?*"}}}}},
            {"name": "stamp-team", "match": match,
             "mutate": {"patchStrategicMerge":
                        {"metadata": {"labels": {"+(team)": "core"}}}}}]}})
    eng = TorchEngine([pol])
    cpu = TorchEngine(cps=eng.cps, device="cpu")
    spaces = ["tenant-003-a-prod", "tx-2-foo", "té-1-x", "default",
              "tenant-011-b-prod", "tq-0-é"]
    res = [{"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"p{i}", "namespace": spaces[i % 6],
                         **({"labels": {"team": "a"}} if i % 3 else {})},
            "spec": {"containers": [{"name": "c", "image": "nginx"}]}}
           for i in range(60)]
    kernels.reset_launches()
    got = eng.scan_device(res)
    assert kernels.LAUNCHES["glob_nfa"] > 0
    assert kernels.LAUNCHES["nonascii"] == 0
    assert kernels.LAUNCHES["dfa_scan_stride1"] + \
        kernels.LAUNCHES["dfa_scan_fused"] > 0
    want = cpu.scan_device(res)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert np.array_equal(eng.scan(res).verdicts, cpu.scan(res).verdicts)
    kernels.reset_launches()
    tri = eng.triage_mutate(res)
    assert kernels.LAUNCHES["glob_nfa"] > 0
    assert np.array_equal(tri.verdicts, cpu.triage_mutate(res).verdicts)


def test_tenant_overflow_packs_one_launch_per_family(cuda, monkeypatch):
    """With the bank lowered, the tenant scan's program runs its NFA
    globs in one K9 launch per lane family (namespace and name), and
    asks for no glob outside its packs."""
    from kyverno_tpu_torch.api.policy import ClusterPolicy

    monkeypatch.setattr(tdfa, "MAX_BANK_STATES", 200)
    globs = [f"tenant-{i:03d}-*-prod" for i in range(40)]
    pol = ClusterPolicy.from_dict({
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "tenant"},
        "spec": {"validationFailureAction": "Enforce", "rules": [
            {"name": "require-team",
             "match": {"resources": {"kinds": ["Pod"], "namespaces": globs}},
             "validate": {"pattern": {"metadata": {"labels": {"team": "?*"}}}}}]}})
    eng = TorchEngine([pol])
    res = [{"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"p{i}", "namespace": f"tenant-0{i:02d}-a-prod"},
            "spec": {"containers": [{"name": "c", "image": "nginx"}]}}
           for i in range(50)]
    kernels.reset_launches()
    got = eng.scan_device(res)
    assert kernels.LAUNCHES["glob_nfa"] == 2
    assert eng.cps.device_fn().stats["nfa_unpacked"] == 0
    want = TorchEngine(cps=eng.cps, device="cpu").scan_device(res)
    assert np.array_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# K10 meta_any, and the programs replayed as CUDA graphs


def _meta_any_case(E, N=3000, seed=0):
    """A random K10 table of E entries a family over every source kind
    (a resource-major bank plane read through a column slice, two
    entry-major pack planes, an unpacked stack and hash pairs), with
    the planes, hash lanes, Namespace-kind mask and non-ASCII masks."""
    rng = np.random.default_rng(seed)
    K, P, U = 2 * E + 3, E + 2, 3
    planes = [torch.from_numpy(rng.random((N, K + 5)) < 0.01)[:, 2:K + 2],
              torch.from_numpy(rng.random((P, N)) < 0.02),
              torch.from_numpy(rng.random((P, N)) < 0.02),
              torch.from_numpy(rng.random((U, N)) < 0.05)]
    slots = [("bank", "x"), ("nfa", "x", 0), ("nfa", "x", 1),
             ("unpacked", "x")]
    entry_major = [False, True, True, True]
    hashes = [torch.from_numpy(rng.integers(-4, 4, (N, 2)).astype(np.int32))
              for _ in range(2)]
    rows, off = [], []
    for f in range(2):
        frows = []
        for _ in range(E):
            s = int(rng.integers(-1, 4))
            if s == -1:
                frows.append((-1, int(rng.integers(-4, 4)),
                              int(rng.integers(-4, 4)), 0))
            else:
                lim = (K, P, P, U)[s]
                frows.append((s, int(rng.integers(0, lim)), 0,
                              int(rng.random() < 0.3)))
        rows += sorted(frows)
        off.append(len(rows))
    table = kernels.MetaAnyTable(("name", "ns"), slots, entry_major,
                                 np.asarray(rows, np.int32), tuple(off),
                                 (True, False), {"x": ["a", "b", "c"]})
    is_ns = torch.from_numpy(rng.random(N) < 0.3)
    na = [torch.from_numpy(rng.random(N) < 0.1), None]
    return table, planes, hashes, is_ns, na


@pytest.mark.parametrize("E", [1, 40, 3300])
def test_meta_any_kernel_equals_plain(cuda, E):
    table, planes, hashes, is_ns, na = _meta_any_case(E, seed=E)
    want = kernels.meta_any_plain(table, planes, hashes, is_ns, na)
    kernels.reset_launches()
    got = kernels.meta_any(table, [p.to(cuda) for p in planes],
                           [h.to(cuda) for h in hashes], is_ns.to(cuda),
                           [na[0].to(cuda), None])
    assert kernels.LAUNCHES["meta_any"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert want[0].any() and want[1].any()
    # names: one family, no Namespace-kind mask
    one = kernels.MetaAnyTable(("name",), table.slots, table.entry_major,
                               table.ent[:table.off[0]],
                               (table.off[0], table.off[0]), (False,),
                               table.unpacked)
    want = kernels.meta_any_plain(one, planes, hashes[:1])
    got = kernels.meta_any(one, [p.to(cuda) for p in planes],
                           [hashes[0].to(cuda)])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("case", ["every", "hash", "bank", "pack",
                                  "no-name", "no-ns"])
def test_meta_any_kernel_every_source_and_tile(cuda, case):
    """K10 against its plain twin on tables of one source kind (literals
    alone, bank planes alone: rows at 16-byte, 4-byte and odd offsets,
    a transposed view; packs alone) or of every
    kind, with ``self`` entries, both non-ASCII masks, an empty name or
    namespace family, N no multiple of any tile, under every tile."""
    sizes = {"no-name": (0, 50), "no-ns": (50, 0)}.get(case, (50, 50))
    sources = MIX_SOURCES.get(case, MIX_SOURCES["every"])
    N = 3001
    table, planes, hashes, is_ns, na = meta_any_mix(len(case), N, sizes,
                                                    sources, device=cuda)
    # rows at offsets 0 mod 16, 0 mod 4, odd; and a transposed plane
    assert [p.stride(1) for p in planes[:4]] == [1, 1, 1, N]
    want = kernels.meta_any_plain(table, planes, hashes, is_ns, na)
    for tile in kernels.META_ANY_TILES:
        kernels.reset_launches()
        got = kernels.meta_any(table, planes, hashes, is_ns, na, tile=tile)
        assert kernels.LAUNCHES["meta_any"] == 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), tile
    assert want[0].any() and want[1].any()


def _pss_pods(n, seed):
    rng = random.Random(seed)
    return [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}", "namespace": "d"},
             "spec": {"containers": [{
                 "name": "c", "image": "nginx",
                 "securityContext": {"privileged": rng.random() < 0.3}}]}}
            for i in range(n)]


def _zero(stats):
    for k in stats:
        stats[k] = 0


def _assert_same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


def _replay_equals_eager(g, plain, lanes_of):
    """First call (eager), second call (capture, then replay) of the
    same bucket: same outputs, launches and stats; a replay over other
    lanes of the bucket equals the eager program and the plain twins."""
    from kyverno_tpu_torch.tpu.graphs import GraphedProgram

    assert isinstance(g, GraphedProgram)
    seen = []
    for lanes in (lanes_of(0), lanes_of(0)):
        kernels.reset_launches()
        _zero(g.stats)
        out = g(lanes)
        torch.cuda.synchronize()
        seen.append((out, dict(kernels.LAUNCHES), dict(g.stats)))
    assert (g.captures, g.replays) == (1, 1)
    _assert_same(seen[0][0], seen[1][0])
    assert seen[0][1] == seen[1][1] and seen[0][2] == seen[1][2]
    assert sum(seen[1][1].values()) > 0
    lanes = lanes_of(1)
    got = g(lanes)
    assert (g.captures, g.replays) == (1, 2)
    _assert_same(got, g.run(lanes))
    _assert_same(got, plain(lanes))


def test_dense_program_replay_equals_eager_and_plain(cuda):
    from kyverno_tpu_torch.tpu.engine import lanes_to_device

    eng = TorchEngine([expand_policy(p) for p in load_pss_policies()])
    g = eng.cps.device_fn(device=cuda)
    assert g is eng.cps.device_fn(device=cuda) and g.run is eng.cps.device_fn()

    def lanes_of(seed, n=100):
        padded, ops, infos = eng.pad(_pss_pods(n, seed))
        return lanes_to_device(eng.encode(padded)[0], cuda)

    _replay_equals_eager(g, eng.cps.device_fn(plain=True), lanes_of)
    # a second bucket runs eagerly once, then captures a second graph
    lanes = lanes_of(2, n=300)
    want = eng.cps.device_fn(plain=True)(lanes)
    _assert_same(g(lanes), want)
    assert g.captures == 1 and g.live_graphs == 1
    _assert_same(g(lanes), want)
    assert g.captures == 2 and g.live_graphs == 2


RULE_END_KERNELS = ("row_fold", "instance_count_many", "instance_count2",
                    "first_true_take", "class_fold")


def rule_launch_order(monkeypatch, run, lanes):
    """The kernel entries one eager run of ``run`` calls, in order, cut
    into rules at each K11 launch: [[name, ...] a rule]."""
    calls = []
    for name in RULE_END_KERNELS:
        real = getattr(kernels, name)

        def rec(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(kernels, name, rec)
    run(lanes)
    monkeypatch.undo()
    rules, cur = [], []
    for name in calls:
        cur.append(name)
        if name == "class_fold":
            rules.append(cur)
            cur = []
    return rules


def test_deferred_counts_and_anchor_replay_equals_eager(cuda, monkeypatch):
    """K3 and K8 are recorded mid-rule and launched at the rule's end:
    each rule of an eager dense run launches K12 once, then its K3 / K8
    launches, then K11; the program captured as a CUDA graph replays
    equal to its eager run and to the plain-twin program."""
    from kyverno_tpu_torch.tpu.engine import lanes_to_device

    eng = TorchEngine([expand_policy(p) for p in load_pss_policies()])
    padded, _, _ = eng.pad(_pss_pods(200, 4))
    lanes = lanes_to_device(eng.encode(padded)[0], cuda)
    g = eng.cps.device_fn(device=cuda)
    rules = rule_launch_order(monkeypatch, g.run, lanes)
    assert len(rules) == len(eng.cps.device_programs)
    seen = set()
    for names in rules:
        k12 = [i for i, n in enumerate(names) if n == "row_fold"]
        assert len(k12) <= 1 and (not k12 or k12[0] == 0)
        assert names[-1] == "class_fold"
        seen.update(names)
    assert {"instance_count_many", "instance_count2",
            "first_true_take"} <= seen
    eager = g.run(lanes)
    for _ in range(3):  # eager, capture, replay
        out = g(lanes)
    assert g.replays >= 1
    _assert_same(out, eager)
    _assert_same(out, eng.cps.device_fn(plain=True)(lanes))


def test_step_replay_equals_eager_and_plain(cuda):
    from kyverno_tpu_torch.tpu.evaluator import build_program

    sc = ShardedScanner([expand_policy(p) for p in load_pss_policies()],
                        device=cuda)
    plain = build_program(sc.cps.device_programs,
                          sc.cps.encode_cfg.max_instances, dfa=sc.cps.dfa,
                          plain=True, verdicts_u8=True,
                          nfa_globs=sc.cps.nfa_globs)

    def lanes_of(seed):
        host, _ = sc.encode(_pss_pods(100, seed) + [{}] * 28)
        return sc.put(host)[0]  # a one-entry mesh: one shard

    _replay_equals_eager(sc.step_jitted(), plain, lanes_of)


def test_triage_replay_equals_eager_and_plain(cuda, monkeypatch):
    from kyverno_tpu_torch.api.policy import ClusterPolicy
    from kyverno_tpu_torch.tpu.engine import lanes_to_device

    monkeypatch.setattr(tdfa, "MAX_BANK_STATES", 200)
    globs = ([f"tenant-{i:03d}-*-prod" for i in range(12)]
             + [f"t?-{i}-*" for i in range(4)] + ["default"])
    pol = ClusterPolicy.from_dict({
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "tenant"},
        "spec": {"rules": [{
            "name": "stamp-team",
            "match": {"resources": {"kinds": ["Pod", "Namespace"],
                                    "namespaces": globs}},
            "mutate": {"patchStrategicMerge":
                       {"metadata": {"labels": {"+(team)": "core"}}}}}]}})
    eng = TorchEngine([pol])
    spaces = ["tenant-003-a-prod", "tx-2-foo", "té-1-x", "default",
              "tenant-011-b-prod", "tq-0-é", "other"]

    def lanes_of(seed):
        rng = random.Random(seed)
        res = []
        for i in range(64):
            ns = rng.choice(spaces)
            res.append({"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": ns}} if i % 5 == 4 else
                       {"apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": f"p{i}", "namespace": ns}})
        return lanes_to_device(eng.encode(eng.pad(res)[0])[0], cuda)

    g = eng.cps.mutate_device_fn(device=cuda)
    _replay_equals_eager(g, eng.cps.mutate_device_fn(plain=True), lanes_of)
    kernels.reset_launches()
    g(lanes_of(3))
    assert kernels.LAUNCHES["meta_any"] == 1
    assert kernels.LAUNCHES["glob_nfa"] == 2


def test_a_failed_capture_is_a_kernel_error(cuda):
    """A program that syncs with the host cannot be captured: its first
    call runs eagerly, its second raises ``KernelError``, which the
    guarded ladder passes to the caller."""
    from kyverno_tpu_torch.tpu.graphs import GraphedProgram

    def run(lanes):
        x = lanes["x"] * 2
        return x + int(x.sum().item() > 0)

    g = GraphedProgram(run)
    lanes = {"x": torch.ones(4, device=cuda)}
    assert g(lanes).tolist() == [3.0] * 4
    with pytest.raises(kernels.KernelError, match="capture"):
        g(lanes)
    assert g.captures == 0 and g.live_graphs == 0
    torch.cuda.synchronize()


# --- K11 class_fold ---


def _fold_tape(dev, seed, N, I, steps=300, J=None):
    """A seeded random tape on ``dev`` over every opcode and shape kind
    (bool, int32 and uint8 inputs; a strided, a broadcast and a
    transposed view) and the values it recorded; J = I by default."""
    from kyverno_tpu_torch.tpu import fold

    rng = np.random.default_rng(seed)
    J = I if J is None else J
    tape = fold.Tape(N, I, J, dev, fold.FoldCache(), plain=False)
    shapes = ((N,), (N, I), (N, I, J))
    pool = {0: [], 1: [], 2: []}
    for kind in range(3):
        for dt in ("bool", "int32", "uint8"):
            a = rng.random(shapes[kind]) < 0.5 if dt == "bool" else \
                rng.integers(0, 7, shapes[kind]).astype(dt)
            pool[kind].append(tape.input(torch.from_numpy(a).to(dev)))
    pool[0].append(tape.input(torch.from_numpy(
        rng.random((N, 3)) < 0.5).to(dev)[:, 1]))
    pool[1].append(tape.input(torch.from_numpy(
        rng.random((N, 1)) < 0.5).to(dev).expand(N, I)))
    pool[1].append(tape.input(torch.from_numpy(
        rng.integers(0, 7, (I, N)).astype(np.int32)).to(dev).T))
    for _ in range(steps):
        kind = int(rng.integers(0, 3))
        op = int(rng.integers(0, 11))
        vals = pool[kind]
        a, b, c = (vals[int(rng.integers(0, len(vals)))] for _ in range(3))
        ab = [v for v in vals if v.dtype == fold.BOOL]
        x, y = (ab[int(rng.integers(0, len(ab)))] for _ in range(2))
        if op == 0:
            pool[kind].append(x & y)
        elif op == 1:
            pool[kind].append(~x | y)
        elif op == 2:
            pool[kind].append(a == int(rng.integers(0, 4)))
        elif op == 3:
            pool[kind].append(a != b)
        elif op == 4:
            pool[kind].append(fold.where(x, a, b))
        elif op == 5:
            pool[kind].append(fold.where(x, int(rng.integers(0, 7)), c))
        elif op == 6:
            pool[kind].append(fold.first_nonpass(a, b))
        elif op in (7, 8) and kind > 0:
            pool[kind - 1].append(a.any(dim=-1) if op == 7 else a.all(dim=-1))
        elif op == 9:
            pool[1].append(fold.expand(pool[0][-1]))
        elif op == 10:
            v = [v for v in pool[1] if v.dtype == fold.BOOL][-1]
            pool[1].append(fold.scan_or(v, exclusive=bool(seed % 2)))
    outs = [v for k in range(3) for v in pool[k][-12:]]
    return tape, outs


@pytest.mark.parametrize("I", [16, 32, 5])
@pytest.mark.parametrize("max_io", [None, 8])
def test_class_fold_kernel_equals_plain_random_tapes(cuda, monkeypatch, I,
                                                     max_io):
    """K11 against its plain twin on random tapes (split into many
    launches with a descriptor block of 8), I up to a full warp."""
    from kyverno_tpu_torch.tpu import fold

    if max_io is not None:
        monkeypatch.setattr(kernels, "CLASS_FOLD_MAX_IO", max_io)
    N = 1500
    tape, outs = _fold_tape(cuda, I + (max_io or 0), N, I)
    comp = tape.cache.get(tape.code, tuple(o.vid for o in outs), I)
    assert (len(comp.segments) > 1) == (max_io is not None)

    def dests():
        return [torch.empty(o.shape, device=cuda, dtype=torch.bool
                            if o.dtype == fold.BOOL else torch.int32)
                for o in outs]

    got, want = dests(), dests()
    kernels.reset_launches()
    fold.run_segments(comp, tape.inputs, got, False, (N, I, I))
    assert kernels.LAUNCHES["class_fold"] == len(comp.segments)
    fold.run_segments(comp, tape.inputs, want, True, (N, I, I))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("I", [1, 3, 16, 17, 32])
@pytest.mark.parametrize("J", [0, 3])
@pytest.mark.parametrize("max_io", [None, 8])
def test_class_fold_kernel_every_lane_count(cuda, monkeypatch, I, J,
                                            max_io):
    """K11 against its plain twin under every legal lane count G (and
    so every instance count a lane, padding instances included) on a
    random tape, whole or split into many launches, over N resources
    that fill no warp or block evenly."""
    from kyverno_tpu_torch.tpu import fold

    if max_io is not None:
        monkeypatch.setattr(kernels, "CLASS_FOLD_MAX_IO", max_io)
    N = 1037
    tape, outs = _fold_tape(cuda, 7 * I + J, N, I, steps=200, J=J)
    comp = tape.cache.get(tape.code, tuple(o.vid for o in outs), J)
    assert (len(comp.segments) > 1) == (max_io is not None)

    def dests():
        return [torch.empty(o.shape, device=cuda, dtype=torch.bool
                            if o.dtype == fold.BOOL else torch.int32)
                for o in outs]

    want = dests()
    fold.run_segments(comp, tape.inputs, want, True, (N, I, J))
    chosen = kernels.fold_lanes
    tried = set()
    for G in kernels.CLASS_FOLD_LANES:
        monkeypatch.setattr(
            kernels, "fold_lanes",
            lambda code, n, i: G if G in kernels.fold_legal(code, i)
            else chosen(code, n, i))
        got = dests()
        kernels.reset_launches()
        fold.run_segments(comp, tape.inputs, got, False, (N, I, J))
        assert kernels.LAUNCHES["class_fold"] == len(comp.segments)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu()), G
        tried |= {G for seg in comp.segments
                  if G in kernels.fold_legal(seg.code, I)}
    # every lane count a segment allows: all those no wider than I's
    # power of two, G = 1 aside (at I > 16 a segment's NIJ values may
    # not fit a warp's shared memory at 32 instances a lane)
    top = 1 << (I - 1).bit_length()
    assert tried == set().union(*(kernels.fold_legal(seg.code, I)
                                  for seg in comp.segments))
    assert tried >= {G for G in kernels.CLASS_FOLD_LANES if 1 < G <= top}


def test_class_fold_kernel_equals_plain_on_the_dense_program(cuda):
    """Every K11 launch of the dense PSS program, held against its plain
    twin on the same inputs: one launch a rule, and the program equals
    the plain-twin program."""
    import chip_smoke
    from kyverno_tpu_torch.tpu import fold
    from kyverno_tpu_torch.tpu.engine import lanes_to_device

    eng = TorchEngine([expand_policy(p) for p in load_pss_policies()])
    res, ops = chip_smoke.workload(700, 3)
    padded, pops, _ = eng.pad(res, ops)
    lanes = lanes_to_device(eng.encode(padded, None, pops)[0], cuda)
    checked = []

    def check(code, ios, dims):
        N, I, J = dims
        outs = list(ios[code.n_ext:])
        twin = [torch.empty_like(o) for o in outs]
        kernels.class_fold_plain(code, list(ios[:code.n_ext]) + twin, N, I, J)
        for g, w in zip(outs, twin):
            assert torch.equal(g, w)
        checked.append(code)

    run = eng.cps.device_fn()
    kernels.reset_launches()
    fold.CHECK = check
    try:
        out = run(lanes)
    finally:
        fold.CHECK = None
    n_rules = len(eng.cps.device_programs)
    assert len(checked) == n_rules == kernels.LAUNCHES["class_fold"]
    assert run.stats["fold_forced"] == 0
    _assert_same(out, eng.cps.device_fn(plain=True)(lanes))


# ---------------------------------------------------------------------------
# K12 row_fold


def _row_flush(dev, seed, N, R, steps=80):
    """A random row tape over lanes of every element type on ``dev``,
    and a flush of it: (tape, outputs) with every output kind."""
    from kyverno_tpu_torch.tpu import fold, rowfold

    lanes = row_lanes(seed, N, R, dev)
    ft = fold.Tape(N, 1, 1, dev, fold.FoldCache(), False)
    rt = rowfold.RowTape(N, R, dev, rowfold.RowCache(), False, ft)
    vals = random_row_tape(rt, lanes, seed, steps)
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(vals), size=min(24, len(vals)), replace=False)
    ops = (rowfold.ANY, rowfold.COUNT, rowfold.STORE)
    outs = [(ops[k % 3], vals[i][0].vid) for k, i in enumerate(picks)]
    return rt, outs


def _row_dests(outs, N, R, dev):
    from kyverno_tpu_torch.tpu import rowfold

    return [torch.empty((N, R) if op == rowfold.STORE else (N,),
                        dtype=torch.int32 if op == rowfold.COUNT
                        else torch.bool, device=dev) for op, _ in outs]


def _row_launches(rt, outs, N, R, dev, **kw):
    """Run a flush's segments through K12 (``kw``: ``warps`` / ``grid``)
    and its plain twin; every output equal, one launch a segment."""
    from kyverno_tpu_torch.tpu import rowfold

    segs = rowfold.compile_rows(rt.code, rt.etypes, outs)
    got, want = (_row_dests(outs, N, R, dev) for _ in range(2))
    before = kernels.LAUNCHES["row_fold"]
    for seg in segs:
        ios = [rt.inputs[i] for i in seg.ins]
        kernels.row_fold(seg.code, ios + [got[k] for k in seg.outs], N, R,
                         **kw)
        kernels.row_fold_plain(seg.code, ios + [want[k] for k in seg.outs],
                               N, R)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["row_fold"] - before == len(segs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return segs


@pytest.mark.parametrize("R", [1, 40, 256, 1100])
@pytest.mark.parametrize("N", [1, 31, 32, 33, "T-1", "T", "T+1", 16391])
@pytest.mark.parametrize("max_io", [None, 10])
def test_row_fold_kernel_equals_plain_random_tapes(cuda, monkeypatch, N, R,
                                                   max_io):
    """K12 against its plain twin on random tapes over every instruction
    and lane type (uint8, bool, a (1, R) broadcast staged once a block,
    int32, float32 with scaled compares, hash sets of 0 to 5 pairs); N
    "T-1", "T" and "T+1" are a tile of two warps (T = 2 x 32 / G
    resources) less one, exactly and plus one; with ``max_io`` (a
    value's cone reads at most the 8 lanes, so 10 always fits one) the
    flush splits into segments."""
    warps = None
    if isinstance(N, str):
        warps = 2
        N = 2 * (32 // kernels.row_lanes(R)) + int(N[1:] or 0)
    if max_io is not None:
        monkeypatch.setattr(kernels, "ROW_FOLD_MAX_IO", max_io)
    for seed in range(1 if N * R > 1 << 22 else 3):
        rt, outs = _row_flush(cuda, seed + 10 * N + R, N, R)
        _row_launches(rt, outs, N, R, cuda, warps=warps)


@pytest.mark.parametrize("warps,grid", [(1, 1), (2, 3), (8, 2), (None, 5)])
def test_row_fold_kernel_persistent_loop(cuda, warps, grid):
    """More tiles than blocks: each block walks many tiles through both
    stages (the next tile's copies in flight while one computes), a tail
    tile included."""
    from kyverno_tpu_torch.tpu import rowfold

    N, R = 16391, 256
    rt, outs = _row_flush(cuda, 5, N, R)
    segs = rowfold.compile_rows(rt.code, rt.etypes, outs)
    ios = [rt.inputs[i] for i in segs[0].ins] + _row_dests(
        [outs[k] for k in segs[0].outs], N, R, cuda)
    plan = kernels.row_fold_plan(segs[0].code, ios, N, R, warps, grid)
    assert plan["rounds"] >= 3 and plan["tiles"] > plan["grid"]
    assert N % plan["T"]
    _row_launches(rt, outs, N, R, cuda, warps=warps, grid=grid)


@pytest.mark.parametrize("view", ["rows", "slab"])
@pytest.mark.parametrize("R", [1100, 33, 256])
def test_row_fold_kernel_unaligned_and_wide_rows(cuda, R, view):
    """Rows past 1,024 (several words a value, a warp a resource) and
    lanes whose rows are not 16-byte aligned against the twin: "rows",
    a view at an odd offset of a wider tensor (resource stride R + 1,
    staged by cp.async); "slab", adjacent rows at an odd base (one bulk
    copy of the aligned span around each tile's slab)."""
    from kyverno_tpu_torch.tpu import fold, rowfold

    N = 300
    if view == "rows":
        lanes = {k: v[:, 1:] for k, v in row_lanes(R, N, R + 1, cuda).items()}
    else:
        lanes = {}
        for k, v in row_lanes(R, N, R, cuda).items():
            flat = torch.empty(v.numel() + 1, dtype=v.dtype, device=cuda)
            lanes[k] = flat[1:].view(v.shape)
            lanes[k].copy_(v)
    ft = fold.Tape(N, 1, 1, cuda, fold.FoldCache(), False)
    rt = rowfold.RowTape(N, R, cuda, rowfold.RowCache(), False, ft)
    vals = random_row_tape(rt, lanes, R, 60)
    outs = [(op, vals[-1 - k][0].vid) for k, op in enumerate(
        (rowfold.ANY, rowfold.COUNT, rowfold.STORE, rowfold.STORE))]
    (seg,) = _row_launches(rt, outs, N, R, cuda)
    ios = [rt.inputs[i] for i in seg.ins]
    plan = kernels.row_fold_plan(seg.code, ios + _row_dests(outs, N, R, cuda),
                                 N, R)
    assert plan["rows" if view == "rows" else "slab"] > 0


def test_row_fold_kernel_at_the_descriptor_limit(cuda):
    """One launch of ``ROW_FOLD_MAX_IO`` descriptors: 120 uint8 lanes,
    each staged, and 8 outputs of every kind."""
    from kyverno_tpu_torch.tpu import fold, rowfold

    N, R = 3000, 40
    gen = torch.Generator(device=cuda).manual_seed(0)
    lanes = [torch.randint(0, 4, (N, R), dtype=torch.uint8, device=cuda,
                           generator=gen) for _ in range(120)]
    ft = fold.Tape(N, 1, 1, cuda, fold.FoldCache(), False)
    rt = rowfold.RowTape(N, R, cuda, rowfold.RowCache(), False, ft)
    ops = (rowfold.ANY, rowfold.COUNT, rowfold.STORE)
    outs = []
    for o in range(8):
        v = rt.lane(lanes[15 * o]) == 1
        for i in range(15 * o + 1, 15 * o + 15):
            v = (v | (rt.lane(lanes[i]) == i % 4)) if i % 2 else \
                (v & (rt.lane(lanes[i]) != i % 4))
        outs.append((ops[o % 3], v.vid))
    (seg,) = _row_launches(rt, outs, N, R, cuda)
    assert seg.code.n_in + seg.code.n_out == kernels.ROW_FOLD_MAX_IO


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_row_fold_kernel_reads_an_unexpanded_row(cuda, dtype):
    """A contiguous (1, R) lane (stride R) handed straight to the kernel
    is the row every resource reads, as the twin's broadcast."""
    from kyverno_tpu_torch.tpu import fold, rowfold

    N, R = 300, 40
    row = torch.arange(R, dtype=dtype, device=cuda).remainder(5)[None]
    assert row.stride(0) == R
    ft = fold.Tape(N, 1, 1, cuda, fold.FoldCache(), False)
    rt = rowfold.RowTape(N, R, cuda, rowfold.RowCache(), False, ft)
    v = rt.lane(row) == 3
    outs = [(rowfold.STORE, v.vid), (rowfold.COUNT, v.vid)]
    (seg,) = rowfold.compile_rows(rt.code, rt.etypes, outs)
    got, want = (_row_dests(outs, N, R, cuda) for _ in range(2))
    kernels.row_fold(seg.code, [row] + got, N, R)
    kernels.row_fold_plain(seg.code, [row] + want, N, R)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[0], (row == 3).expand(N, R))


def test_row_fold_kernel_equals_plain_on_the_dense_program(cuda):
    """Every K12 launch of the dense PSS program, held against its plain
    twin on the same inputs: no K6 launch but the path masks', no value
    forced off a tape, and the program equals the plain-twin program."""
    import chip_smoke
    from kyverno_tpu_torch.tpu import rowfold
    from kyverno_tpu_torch.tpu.engine import lanes_to_device

    eng = TorchEngine([expand_policy(p) for p in load_pss_policies()])
    res, ops = chip_smoke.workload(700, 3)
    padded, pops, _ = eng.pad(res, ops)
    lanes = lanes_to_device(eng.encode(padded, None, pops)[0], cuda)
    checked = []

    def check(code, ios, N, R):
        outs = list(ios[code.n_in:])
        twin = [torch.empty_like(o) for o in outs]
        kernels.row_fold_plain(code, list(ios[:code.n_in]) + twin, N, R)
        for g, w in zip(outs, twin):
            assert torch.equal(g, w)
        checked.append(code)

    run = eng.cps.device_fn()
    _zero(run.stats)
    kernels.reset_launches()
    rowfold.CHECK = check
    try:
        out = run(lanes)
    finally:
        rowfold.CHECK = None
    assert len(checked) == kernels.LAUNCHES["row_fold"] >= \
        len(eng.cps.device_programs)
    assert kernels.LAUNCHES["hash_match"] == 461
    assert run.stats["rows_forced"] == 0 and run.stats["fold_forced"] == 0
    _assert_same(out, eng.cps.device_fn(plain=True)(lanes))


def test_a_question_glob_off_the_bank_launches_the_standalone_flag(
        cuda, monkeypatch):
    """Every glob refused by the bank: each family with a '?' glob takes
    its flag from the standalone B4 entry, once a run (the namespace, a
    Namespace's name and the pool's '?*'), and the table equals the CPU
    run's (CONFIRM cells of non-ASCII namespaces included)."""
    from kyverno_tpu_torch.api.policy import ClusterPolicy

    monkeypatch.setattr(tdfa, "MAX_BANK_STATES", 0)
    pol = ClusterPolicy.from_dict({
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "nfa-only"},
        "spec": {"validationFailureAction": "Enforce", "rules": [
            {"name": "team", "match": {"any": [{"resources": {
                "kinds": ["Pod"], "namespaces": ["t?-*", "x??y*"]}}]},
             "validate": {"pattern": {"metadata": {"labels": {
                 "team": "?*"}}}}}]}})
    eng = TorchEngine([pol])
    cpu = TorchEngine(cps=eng.cps, device="cpu")
    spaces = ["t1-a", "té-a", "tx-é", "xaby", "xéy", "x12y-z", "default"]
    res = [{"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"p{i}", "namespace": spaces[i % 7]},
            "spec": {"containers": [{"name": "c", "image": "nginx"}]}}
           for i in range(70)]
    kernels.reset_launches()
    got = eng.scan_device(res)
    assert set(eng.cps.nfa_globs) == {"ns", "name", "pool"}
    assert kernels.LAUNCHES["nonascii"] == 3
    want = cpu.scan_device(res)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert (got[0] == 6).any()  # CONFIRM


def test_pipelined_scan_on_the_card_equals_scan_stream(cuda):
    """PipelinedScanner over the PSS scanner on the card, without and
    with a pool of two workers, and with the columnar store: every run's
    verdicts equal ``scan_stream``'s and the CPU pipeline's; the feed
    makes no CUDA call and the workers load no torch."""
    from kyverno_tpu_torch.cluster.columnar import configure_store, reset_store
    from kyverno_tpu_torch.encode import EncoderPool
    from kyverno_tpu_torch.tpu.pipeline import PipelinedScanner

    policies = [expand_policy(p) for p in load_pss_policies()]
    sc = ShardedScanner(policies)
    cpu = ShardedScanner(policies, device="cpu")
    pods = _pss_pods(600, 9)
    chunks = [pods[i:i + 128] for i in range(0, len(pods), 128)]

    def run(scanner, pool=None):
        out = {}
        stats = PipelinedScanner(scanner, encode_pool=pool).scan_chunks(
            chunks, on_result=lambda i, r: out.__setitem__(i, r.verdicts))
        assert stats["encode_fallback_chunks"] == 0
        return np.concatenate([out[i] for i in range(len(chunks))], axis=1)

    stream, _ = sc.scan_stream(pods, tile=128)
    want = run(cpu)
    assert np.array_equal(stream.verdicts, want)
    kernels.reset_launches()
    assert np.array_equal(run(sc), want)
    assert kernels.LAUNCHES["verdict_counts_u8"] == len(chunks)
    pool = EncoderPool(2).start()
    try:
        assert pool.wait_ready(60) == 2
        assert not any(w["torch_loaded"] or w["jax_loaded"]
                       for w in pool.state()["worker_slots"])
        assert np.array_equal(run(sc, pool), want)
    finally:
        pool.stop()
    try:
        configure_store(enabled=True)
        assert np.array_equal(run(sc), want)
        assert np.array_equal(run(sc), want)
    finally:
        reset_store()


# --- admission serving: several threads, buckets 16-64 at max_rows 128 ---


def _admission_engine(cps=None):
    from kyverno_tpu_torch.tpu.flatten import EncodeConfig

    if cps is not None:
        return TorchEngine(cps=cps)
    return TorchEngine([expand_policy(p) for p in load_pss_policies()],
                       encode_cfg=EncodeConfig(max_rows=128))


def _admission_pods(n, seed):
    from chip_smoke import workload

    return workload(n, seed)[0]


def _loop_scans(eng, pods, want, stop, errors, counts):
    """Scan ``pods`` on ``eng`` until ``stop``; errors and tables unlike
    ``want`` are recorded."""
    while not stop.is_set():
        try:
            got = eng.scan(pods).verdicts
        except Exception as e:  # noqa: BLE001 - the test counts them
            errors.append(repr(e))
            continue
        counts.append(1)
        if not np.array_equal(got, want):
            errors.append("table unlike the CPU's")


@pytest.mark.parametrize("scenario", ["bucket", "swap"])
def test_capture_while_another_thread_replays(cuda, scenario):
    """Thread A replays bucket 16 in a loop while thread B's first two
    calls capture a graph: at bucket 32 on the same engine ("bucket"),
    or at bucket 16 of a second engine compiled afresh, as the lifecycle
    worker warms the next version ("swap"). In CUDA's default capture
    mode A's pinned copies and readbacks invalidate B's recording
    (``KernelError``); the thread-local mode keeps both whole."""
    import threading

    from kyverno_tpu_torch.tpu.compiler import compile_policy_set

    eng = _admission_engine()
    cpu = TorchEngine(cps=eng.cps, device="cpu")
    pods = _admission_pods(48, 3)
    a_pods, b_pods = pods[:16], pods[16:] if scenario == "bucket" else pods[:16]
    want_a, want_b = cpu.scan(a_pods).verdicts, cpu.scan(b_pods).verdicts
    eng.warm_buckets([16])
    if scenario == "swap":
        b_eng = TorchEngine(cps=compile_policy_set(eng.cps.policies,
                                                   eng.cps.encode_cfg))
    else:
        b_eng = eng
    g = b_eng.cps.device_fn(device=b_eng.device)
    captures0 = g.captures
    stop, errors, counts = threading.Event(), [], []
    th = threading.Thread(target=_loop_scans,
                          args=(eng, a_pods, want_a, stop, errors, counts))
    th.start()
    try:
        for _ in range(3):  # eager, capture, replay
            assert np.array_equal(b_eng.scan(b_pods).verdicts, want_b)
    finally:
        stop.set()
        th.join()
    assert errors == [] and counts
    assert g.captures == captures0 + 1


def test_two_threads_scan_buckets_16_and_64_at_once(cuda):
    import threading

    eng = _admission_engine()
    cpu = TorchEngine(cps=eng.cps, device="cpu")
    pods = _admission_pods(80, 4)
    small, large = pods[:16], pods[16:]
    want = {16: cpu.scan(small).verdicts, 64: cpu.scan(large).verdicts}
    stop, errors, counts = threading.Event(), [], []
    threads = [threading.Thread(target=_loop_scans,
                                args=(eng, p, want[b], stop, errors, c))
               for p, b, c in ((small, 16, counts), (large, 64, []))]
    for th in threads:
        th.start()
    try:
        import time

        time.sleep(4.0)
    finally:
        stop.set()
        for th in threads:
            th.join()
    assert errors == [] and len(counts) >= 3
    g = eng.cps.device_fn(device=eng.device)
    assert g.captures == 2 and g.live_graphs == 2


@pytest.mark.parametrize("n", [16, 32, 64])
def test_admission_program_at_each_bucket_equals_plain(cuda, n):
    """The PSS program at the admission shapes (N = 16, 32 and 64 at
    max_rows 128: K4's plan, K8's form, K7's ballot form and K12's grid
    with fewer tiles than SMs chosen for them): eager, captured and
    replayed, equal to the plain-twin program."""
    from kyverno_tpu_torch.tpu.engine import lanes_to_device

    eng = _admission_engine()
    g = eng.cps.device_fn(device=cuda)

    def lanes_of(seed, k=n):
        padded, _, _ = eng.pad(_admission_pods(k, seed))
        assert len(padded) == n
        return lanes_to_device(eng.encode(padded)[0], cuda)

    _replay_equals_eager(g, eng.cps.device_fn(plain=True), lanes_of)


def test_lifecycle_swap_captures_while_another_thread_replays(cuda):
    """A PolicySetLifecycleManager with ``warm=True`` and its worker
    started: a policy added to the cache compiles and captures the new
    version's MIN_BUCKET graph on the worker while a serving thread
    replays the old version's; every scan equals the CPU's under the
    version it used."""
    import threading
    import time

    from kyverno_tpu_torch.cluster.policycache import PolicyCache
    from kyverno_tpu_torch.lifecycle import PolicySetLifecycleManager
    from kyverno_tpu_torch.lifecycle.manager import default_compile_fn
    from kyverno_tpu_torch.tpu.flatten import EncodeConfig

    policies = load_pss_policies()  # the cache expands them
    cache = PolicyCache()
    for p in policies[:-1]:
        cache.set(p)
    mgr = PolicySetLifecycleManager(cache, compile_fn=default_compile_fn(
        encode_cfg=EncodeConfig(max_rows=128), warm=True))
    mgr.start()
    pods = _admission_pods(16, 5)
    want, errors, served = {}, [], []
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            v = mgr.acquire()
            try:
                got = v.engine.scan(pods).verdicts
            except Exception as e:  # noqa: BLE001 - the test counts them
                errors.append(repr(e))
                continue
            served.append(v.revision)
            if v.revision not in want:
                want[v.revision] = TorchEngine(
                    cps=v.engine.cps, device="cpu").scan(pods).verdicts
            if not np.array_equal(got, want[v.revision]):
                errors.append(f"revision {v.revision} unlike the CPU's")

    try:
        v1 = mgr.acquire()
        g1 = v1.engine.cps.device_fn(device=v1.engine.device)
        assert g1.captures == 1  # the worker's warm-up captured bucket 16
        th = threading.Thread(target=serve)
        th.start()
        time.sleep(0.5)
        cache.set(policies[-1])
        deadline = time.monotonic() + 120
        while mgr.active.revision == v1.revision \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)
        stop.set()
        th.join()
    finally:
        mgr.stop()
    v2 = mgr.active
    assert v2.revision > v1.revision and mgr.stats["swaps"] == 1
    g2 = v2.engine.cps.device_fn(device=v2.engine.device)
    assert g2.captures == 1 and g1.captures == 1
    assert errors == []
    assert v1.revision in served and v2.revision in served


def test_lint_on_the_card_only_replays_warmed_buckets(cuda):
    """A lifecycle manager with ``analyze_on_swap`` set and the
    admission buckets 16 / 32 / 64 warmed by its compile_fn: its
    version is promoted with the lint tile's bucket (128) captured too,
    so the lint runs no bucket eagerly and captures none, every warmed
    key stays live, and the lint's report equals a CPU engine's
    analysis of the same set."""
    from kyverno_tpu_torch.analysis import analyzer, global_analysis
    from kyverno_tpu_torch.cluster.policycache import PolicyCache
    from kyverno_tpu_torch.lifecycle import PolicySetLifecycleManager
    from kyverno_tpu_torch.lifecycle.manager import default_compile_fn
    from kyverno_tpu_torch.tpu.flatten import EncodeConfig

    def by_bucket(g):
        out = {}
        for key, n in g.key_counts.items():
            b = key[0][1][0]
            out[b] = {k: out.get(b, {}).get(k, 0) + v for k, v in n.items()}
        return out

    cache = PolicyCache()
    for p in load_pss_policies():
        cache.set(p)
    mgr = PolicySetLifecycleManager(cache, compile_fn=default_compile_fn(
        encode_cfg=EncodeConfig(max_rows=128), warm=True,
        warm_buckets=(16, 32, 64), device=cuda))
    mgr.analyze_on_swap = True
    global_analysis.reset()
    v = mgr.acquire()
    g = v.engine.cps.device_fn(device=v.engine.device)
    before = by_bucket(g)
    assert {b: c["captures"] for b, c in before.items()} == \
        {16: 1, 32: 1, 64: 1, 128: 1}
    rep = mgr.run_lint()
    after = by_bucket(g)
    assert rep is not None and global_analysis.runs["ok"] == 1
    assert sorted(after) == [16, 32, 64, 128] and g.live_graphs == 4
    for b in after:
        assert after[b]["eager"] == before[b]["eager"]
        assert after[b]["captures"] == before[b]["captures"]
    assert after[128]["replays"] > before[128]["replays"]
    cpu = analyzer.analyze_engine(TorchEngine(cps=v.engine.cps,
                                              device="cpu"), tile=128)

    def view(r):
        doc = r.to_dict()
        doc["stats"] = {k: x for k, x in doc["stats"].items()
                        if not k.endswith("_s") and k != "witness_evals_per_s"}
        return doc

    assert view(rep) == view(cpu)


def _soak_pods(n, rev=0):
    """bench.py's soak Pods (1 in 9 privileged, 16 namespaces)."""
    return [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"soak-{i}", "namespace": f"ns{i % 16}",
                          "uid": f"soak-u{i}", "labels": {"rev": str(rev)}},
             "spec": {"containers": [{
                 "name": "c", "image": "nginx",
                 **({"securityContext": {"privileged": True}}
                    if i % 9 == 0 else {})}]}}
            for i in range(n)]


def test_scan_tick_on_the_card_folds_the_cpu_digest(cuda):
    """The background scan service on the card and on the CPU over the
    same cluster and the same churn: after the full scan and after a
    churn tick (upserts, adds, deletes), both report stores hold the
    same digest, and the tick folded what moved."""
    from kyverno_tpu_torch.cluster import (BackgroundScanService,
                                           ClusterSnapshot, PolicyCache)
    from kyverno_tpu_torch.reports import configure_reports, reset_reports

    def run(device):
        store = configure_reports()
        cache = PolicyCache()
        for p in load_pss_policies():
            cache.set(p)
        snap = ClusterSnapshot()
        for pod in _soak_pods(600):
            snap.upsert(pod)
        svc = BackgroundScanService(snap, cache, device=device,
                                    batch_size=256)
        out = [svc.scan_once(full=True), store.digest()]
        for pod in _soak_pods(700, rev=1)[::5]:
            snap.upsert(pod)
        for i in range(3, 600, 37):
            snap.delete(f"soak-u{i}")
        out += [svc.scan_once(), store.digest(), store.summary()]
        reset_reports()
        return out

    try:
        got, want = run(cuda), run("cpu")
    finally:
        reset_reports()
    assert got == want
    assert got[0] == 600 and got[2] > 0 and got[4]["fail"] > 0


def test_analyze_engine_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """analyze_engine on the card (PSS plus the seeded anomalies) and on
    a CPU engine over the same compiled set: the same report, timings
    aside, and the same verdict table."""
    import os

    import yaml

    from kyverno_tpu_torch.analysis import analyzer
    from kyverno_tpu_torch.api.policy import ClusterPolicy

    path = os.path.join(os.path.dirname(__file__), "golden", "analysis",
                        "seeded_anomalies.yaml")
    with open(path) as f:
        seeded = [expand_policy(ClusterPolicy.from_dict(d))
                  for d in yaml.safe_load_all(f) if isinstance(d, dict)]
    eng = TorchEngine([expand_policy(p) for p in load_pss_policies()]
                      + seeded, device=cuda)
    tables = []
    real = analyzer.evaluate_corpus

    def evaluate_corpus(*a, **kw):
        out = real(*a, **kw)
        tables.append(out[0])
        return out

    monkeypatch.setattr(analyzer, "evaluate_corpus", evaluate_corpus)

    def view(rep):
        doc = rep.to_dict()
        doc["stats"] = {k: v for k, v in doc["stats"].items()
                        if not k.endswith("_s") and k != "witness_evals_per_s"}
        return doc, [a.evidence for a in rep.anomalies]

    reps = [analyzer.analyze_engine(e, tile=256)
            for e in (eng, eng, TorchEngine(cps=eng.cps, device="cpu"))]
    assert view(reps[0]) == view(reps[1]) == view(reps[2])
    assert np.array_equal(tables[0], tables[2])
    assert np.array_equal(tables[1], tables[2])
    counts = reps[0].counts()
    assert all(counts[k] >= 1 for k in counts) and reps[0].stats["refuted"] == 0


# ---------------------------------------------------------------------------
# the sharded scan on a mesh of CUDA devices (a device may repeat)


def _mesh_devices(k):
    """``k`` mesh entries over the visible cards (``cuda:0`` repeats on
    a one-card machine)."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(k)]


def test_mesh_on_the_card_equals_one_device(cuda):
    """A 2-entry and a 2 x 2 mesh give the one-device scanner's table
    and counts exactly (scan_device, scan_stream, PipelinedScanner), and
    every kernel of the step launches on every distinct device."""
    from kyverno_tpu_torch.parallel import make_mesh, make_mesh_2d
    from kyverno_tpu_torch.tpu.pipeline import PipelinedScanner

    policies = [expand_policy(p) for p in load_pss_policies()]
    one = ShardedScanner(policies, device=cuda)
    pods = _pss_pods(300, 7)
    want_v, want_c = one.scan_device(pods)
    want_s, _ = one.scan_stream(pods, tile=128)
    for mesh in (make_mesh(_mesh_devices(2)),
                 make_mesh_2d(2, 2, _mesh_devices(4))):
        sc = ShardedScanner(policies, mesh=mesh)
        for _ in range(3):  # eager run, capture, replay
            v, c = sc.scan_device(pods)
            assert np.array_equal(v, want_v) and np.array_equal(c, want_c)
        got, stats = sc.scan_stream(pods, tile=128)
        assert stats["tiles"] == 3
        assert np.array_equal(got.verdicts, want_s.verdicts)
        out = {}
        PipelinedScanner(sc).scan_chunks(
            [pods[:128], pods[128:256], pods[256:]],
            on_result=lambda i, r: out.__setitem__(i, r))
        assert np.array_equal(np.concatenate(
            [out[i].verdicts for i in range(3)], axis=1), want_s.verdicts)
        for d in mesh.distinct:
            got_l = sc.device_launches[str(d)]
            for name in ("vocab_gather", "hash_match", "class_fold",
                         "row_fold", "verdict_counts_u8"):
                assert got_l.get(name, 0) > 0, (d, name)


def test_kernels_on_a_second_device_after_the_first(cuda, monkeypatch):
    """K1 (tiles past 48 KB of shared memory), K11 and K12 launch on
    cuda:1 after cuda:0 (each device opts in to its shared memory), and a
    launch whose tensors are off the current device raises."""
    from kyverno_tpu_torch.tpu import fold

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    globs, bank = _tenant_bank(monkeypatch)
    ids = bank.families["ns"]
    byt, lens = _tenant_lane(globs, 1024)
    want = tdfa.bank_match(bank, ids, byt, lens)
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        with torch.cuda.device(dev):
            assert max(g.smem for g in tdfa.scan_groups(bank, ids, dev)) \
                > 48 << 10
            got = tdfa.bank_match(bank, ids, byt.to(dev), lens.to(dev))
            assert torch.equal(got.cpu(), want)
            N, I = 1500, 16
            tape, outs = _fold_tape(dev, 3, N, I)
            comp = tape.cache.get(tape.code, tuple(o.vid for o in outs), I)
            got_f, want_f = ([torch.empty(o.shape, device=dev,
                                          dtype=torch.bool if o.dtype ==
                                          fold.BOOL else torch.int32)
                              for o in outs] for _ in range(2))
            fold.run_segments(comp, tape.inputs, got_f, False, (N, I, I))
            fold.run_segments(comp, tape.inputs, want_f, True, (N, I, I))
            torch.cuda.synchronize()
            for g, w in zip(got_f, want_f):
                assert torch.equal(g.cpu(), w.cpu())
            rt, routs = _row_flush(dev, 4, 4096, 256)
            _row_launches(rt, routs, 4096, 256, dev)
    hi = torch.zeros((64, 8), dtype=torch.int32, device="cuda:1")
    consts = kernels.hash_consts([(1, 2)], "cuda:1")
    with torch.cuda.device(0):
        with pytest.raises(kernels.KernelError, match="current device"):
            kernels.hash_match(hi, hi, consts)
