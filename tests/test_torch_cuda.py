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

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


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
    scan and the mutate triage on the card launch K9 and the non-ASCII
    entry, and equal the CPU run."""
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
    assert kernels.LAUNCHES["glob_nfa"] > 0 and kernels.LAUNCHES["nonascii"] > 0
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


def test_step_replay_equals_eager_and_plain(cuda):
    from kyverno_tpu_torch.tpu.evaluator import build_program

    sc = ShardedScanner([expand_policy(p) for p in load_pss_policies()])
    plain = build_program(sc.cps.device_programs,
                          sc.cps.encode_cfg.max_instances, dfa=sc.cps.dfa,
                          plain=True, verdicts_u8=True,
                          nfa_globs=sc.cps.nfa_globs)

    def lanes_of(seed):
        host, _ = sc.encode(_pss_pods(100, seed) + [{}] * 28)
        return sc.put(host)

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


def _fold_tape(dev, seed, N, I, steps=300):
    """A seeded random tape on ``dev`` over every opcode and shape kind
    (bool, int32 and uint8 inputs; a strided, a broadcast and a
    transposed view) and the values it recorded."""
    from kyverno_tpu_torch.tpu import fold

    rng = np.random.default_rng(seed)
    tape = fold.Tape(N, I, I, dev, fold.FoldCache(), plain=False)
    shapes = ((N,), (N, I), (N, I, I))
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
