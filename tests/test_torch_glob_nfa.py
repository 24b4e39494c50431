"""The legacy glob NFA (kernel K9) of kyverno_tpu_torch against the JAX
package's ``glob_match``, and the slice that reaches it: a policy set
whose globs overflow the DFA bank.

- The port's NFA route (``Ctx._accept_confirm`` with the pattern
  outside the bank, K9's plain twin on the CPU) equals the reference's
  on seeded subjects in both lane shapes, (N, W) and (N, K, W), with
  hostile lengths (negative, 0, W, past W), NUL bytes, non-ASCII bytes
  and patterns of every class: empty, all stars, '?', mixed, literals
  outside ASCII (taken character by character, ``ord(c) & 0xFF``), and
  lengths m = 63, 64, 65 and about 300.
- A model of the kernel's bitset arithmetic over ``glob_table`` equals
  the reference on the same inputs, and the one-pass closure equals
  the reference's column-by-column loop.
- With ``MAX_BANK_STATES`` lowered in both packages, a tenant set of 16
  namespace globs leaves globs outside the bank; the bank split, the
  device table and counts, the completed scan and the mutate triage
  equal the JAX package's.

All outputs are bool or int32 codes: tolerance 0."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kyverno_tpu.api.policy import ClusterPolicy as JaxPolicy
from kyverno_tpu.tpu import dfa as jdfa
from kyverno_tpu.tpu import evaluator as jev
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.tpu import dfa as tdfa
from kyverno_tpu_torch.tpu import evaluator as tev
from kyverno_tpu_torch.tpu.convert import bank_to_numpy
from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device

from torch_parity_util import (Recorded, assert_full_scan_equal,
                               assert_same_program, assert_scan_equal,
                               port_policies)
from torch_parity_util import fresh_port_state  # noqa: F401

PATTERNS = [
    "", "*", "***", "?", "a*b?c*", "a**b", "*?*", "??", "é*", "中?",
    "abc", "*-prod", "tenant-0*-*-prod", "t?-1-*", "a" * 63, "a" * 64,
    "?" * 64, "a*" * 32 + "b", "a" * 65, ("ab*?" * 75)[:299],
]


def _alphabet(pattern):
    """Bytes the subjects are made of: the pattern's own (as K9 reads
    them), NUL, non-ASCII and a few others."""
    own = sorted({ord(c) & 0xFF for c in pattern if c not in "*?"})
    return np.array(own + [0, 0x2D, 0x61, 0x62, 0x63, 0xE9, 0xFF],
                    dtype=np.uint8)


def _instance(rng, pattern, alpha):
    """Bytes that the pattern accepts."""
    out = []
    for c in pattern:
        if c == "*":
            out += list(rng.choice(alpha, size=int(rng.integers(0, 4))))
        elif c == "?":
            out.append(int(rng.choice(alpha[alpha != 0])))
        else:
            out.append(ord(c) & 0xFF)
    return out


def _subjects(pattern, shape, seed):
    """(lead..., B) uint8 and (lead...) int32: half instances of the
    pattern (some with one byte changed, which may be a NUL), half noise
    over the pattern's alphabet; lengths include -1, 0, B and B + 3."""
    rng = np.random.default_rng(seed)
    alpha = _alphabet(pattern)
    B = max(8, len(pattern) + 2 * pattern.count("*") + 12)
    n = int(np.prod(shape))
    byt = rng.choice(alpha, size=(n, B)).astype(np.uint8)
    lens = rng.integers(0, B + 1, size=(n,)).astype(np.int32)
    for i in range(0, n, 2):
        inst = _instance(rng, pattern, alpha)[:B]
        byt[i, :len(inst)] = inst
        lens[i] = len(inst)
        if i % 6 == 2 and inst:  # one byte changed
            byt[i, int(rng.integers(0, len(inst)))] = rng.choice(alpha)
    lens[:6] = [-1, 0, B, B + 3, 1, -7][:min(6, n)]
    return byt.reshape(shape + (B,)), lens.reshape(shape)


def _ctxs(family, byt, lens):
    """A reference Ctx and a port Ctx (no DFA bank) over one lane
    family, so every glob takes the NFA route."""
    lane, len_lane = tev.Ctx._FAMILY_LANES[family]
    N = byt.shape[0]
    batch = {"norm_hi": np.zeros((N, 1), np.uint32),
             "valid": np.ones((N, 1), np.uint8), lane: byt, len_lane: lens}
    jctx = jev.Ctx({k: jnp.asarray(v) for k, v in batch.items()}, 4)
    tctx = tev.Ctx(lanes_to_device(batch, "cpu"), 4)
    assert jctx.dfa is None and tctx.dfa is None
    return jctx, tctx


SHAPES = [("ns", (29,)), ("pool", (7, 5))]


@pytest.mark.parametrize("family,shape", SHAPES)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_nfa_route_equals_reference(pattern, family, shape):
    byt, lens = _subjects(pattern, shape, seed=len(pattern) + len(shape))
    jctx, tctx = _ctxs(family, byt, lens)
    jacc, jconf = jctx._accept_confirm("glob", pattern, family)
    tacc, tconf = tctx._accept_confirm("glob", pattern, family)
    assert tacc.dtype == torch.bool and tuple(tacc.shape) == shape
    assert np.array_equal(tacc.numpy(), np.asarray(jacc))
    # '?' confirms non-ASCII subjects, as the bank path does
    assert (tconf is None) == (jconf is None) == ("?" not in pattern)
    if tconf is not None:
        assert np.array_equal(tconf.numpy(), np.asarray(jconf))
    # the kernel's entry on the CPU is the same function
    got = kernels.glob_nfa(pattern, torch.from_numpy(byt),
                           torch.from_numpy(lens))
    assert np.array_equal(got.numpy(), np.asarray(jev.glob_match(
        pattern, jnp.asarray(byt), jnp.asarray(lens))))


def test_nfa_semantics_by_hand():
    """The rules of the reference spelled out: the answer is read at
    ``len`` (outside [0, B] is False), '?' refuses NUL, '*' takes NUL,
    literals compare ord(c) & 0xFF."""
    def run(pattern, data, length):
        byt = np.zeros((1, 8), np.uint8)
        byt[0, :len(data)] = data
        lens = np.array([length], np.int32)
        want = bool(np.asarray(jev.glob_match(pattern, jnp.asarray(byt),
                                              jnp.asarray(lens)))[0])
        got = bool(kernels.glob_nfa_plain(pattern, torch.from_numpy(byt),
                                          torch.from_numpy(lens))[0])
        assert got == want
        return got

    assert run("", [], 0) and not run("", [], 1)
    assert run("***", [], 0) and run("*", [0, 0], 2)
    assert not run("?", [0], 1) and run("?", [7], 1)
    assert run("é", [0xE9], 1) and not run("é", [0xC3, 0xA9], 2)
    assert run("中", [0x2D], 1)
    assert not run("a", [0x61], -1) and not run("*", [], 9)
    assert run("a*", [0x61] * 8, 8) and not run("a*", [0x61] * 8, 9)


def _kernel_model(pattern, byt, lens):
    """K9's arithmetic on Python integers: the state is a bitset read
    from ``glob_table``'s words, stepped as csrc/glob_nfa.cu steps it."""
    table = kernels.glob_table(pattern, "cpu").numpy().view(np.uint64)
    words = table.shape[1]

    def row(r):
        return sum(int(table[r, k]) << (64 * k) for k in range(words))

    rows = [row(r) for r in range(257)]
    star = rows[256]
    m = len(kernels.glob_chars(pattern))
    B = byt.shape[-1]
    flat_b, flat_l = byt.reshape(-1, B), lens.reshape(-1)
    out = np.zeros(flat_l.shape, bool)
    for s in range(flat_l.shape[0]):
        n = int(flat_l[s])
        if n < 0 or n > B:
            continue
        dp = 1
        dp |= (dp << 1) & star
        for w in range(n):
            dp = ((dp << 1) & rows[int(flat_b[s, w])]) | (dp & star)
            dp |= (dp << 1) & star
            if not dp:
                break
        out[s] = bool(dp >> m & 1)
    return out.reshape(lens.shape)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_kernel_bitset_model_equals_reference(pattern):
    byt, lens = _subjects(pattern, (41,), seed=7)
    want = np.asarray(jev.glob_match(pattern, jnp.asarray(byt),
                                     jnp.asarray(lens)))
    assert np.array_equal(_kernel_model(pattern, byt, lens), want)
    # the words hold m + 1 bits; no row sets bit 0 or a bit past m
    table = kernels.glob_table(pattern, "cpu").numpy().view(np.uint64)
    m = len(kernels.glob_chars(pattern))
    assert table.shape == (257, kernels.glob_words(pattern))
    assert 64 * table.shape[1] >= m + 1
    for r in table:
        bits = sum(int(w) << (64 * k) for k, w in enumerate(r))
        assert bits & 1 == 0 and bits >> (m + 1) == 0


def _pack_model(pack, byt, lens):
    """The packed kernel's arithmetic on Python integers: each byte
    through the pack's class map to its pattern's class row, the '*'
    row last, stepped as csrc/glob_nfa.cu steps it -> (P, ...) bool."""
    tables = pack.tables.view(np.uint64)
    B = byt.shape[-1]
    flat_b, flat_l = byt.reshape(-1, B), lens.reshape(-1)
    out = np.zeros((len(pack.patterns), flat_l.shape[0]), bool)
    for p in range(len(pack.patterns)):
        rows = [sum(int(w) << (64 * k) for k, w in enumerate(r))
                for r in tables[p]]
        star, m = rows[-1], int(pack.ms[p])
        for s in range(flat_l.shape[0]):
            n = int(flat_l[s])
            if n < 0 or n > B:
                continue
            dp = 1 | (2 & star)
            for w in range(n):
                t = rows[pack.cmap[flat_b[s, w]]]
                dp = ((dp << 1) & t) | (dp & star)
                dp |= (dp << 1) & star
                if not dp:
                    break
            out[p, s] = bool(dp >> m & 1)
    return out.reshape((len(pack.patterns),) + lens.shape)


def _shared_subjects(patterns, per, seed):
    """Each pattern's ``_subjects`` (instances, noise, hostile lengths),
    zero-padded to one width and stacked."""
    parts = [_subjects(p, (per,), seed + i) for i, p in enumerate(patterns)]
    B = max(b.shape[-1] for b, _ in parts)
    byt = np.concatenate([np.pad(b, ((0, 0), (0, B - b.shape[-1])))
                          for b, _ in parts])
    return byt, np.concatenate([ln for _, ln in parts])


def test_packs_equal_reference():
    """PATTERNS fall into packs of 1, 2 and 8 64-bit state words; each
    pack's class-compressed tables (the kernel's arithmetic), its plain
    twin and the pack of one equal the reference per pattern."""
    packs = kernels.glob_packs(PATTERNS)
    assert [p.nw for p in packs] == [1, 2, 8]
    assert sorted(q for p in packs for q in p.patterns) == sorted(PATTERNS)
    byt, lens = _shared_subjects(PATTERNS, 6, seed=11)
    tb, tl = torch.from_numpy(byt), torch.from_numpy(lens)
    for pack in packs:
        model = _pack_model(pack, byt, lens)
        plane = kernels.glob_nfa_pack(pack, tb, tl)
        assert plane.dtype == torch.bool
        assert tuple(plane.shape) == (len(pack.patterns),) + lens.shape
        assert np.array_equal(kernels.glob_nfa_pack_plain(pack, tb, tl)
                              .numpy(), plane.numpy())
        for row, pattern in enumerate(pack.patterns):
            want = np.asarray(jev.glob_match(pattern, jnp.asarray(byt),
                                             jnp.asarray(lens)))
            assert np.array_equal(model[row], want), pattern
            assert np.array_equal(plane[row].numpy(), want), pattern
            assert np.array_equal(kernels.glob_nfa(pattern, tb, tl).numpy(),
                                  want)


def test_pack_class_map():
    """Literal bytes (ord(c) & 0xFF, NUL included) get a class each, NUL
    one of its own, every other byte the "no literal" class; a table row
    is the pattern's full-table row at a byte of its class."""
    pack = kernels.GlobPack(["ab?", "\x00*b", "中?"])
    lits = {ord("a"), ord("b"), 0, ord("中") & 0xFF}
    assert pack.classes == 1 + len(lits) + 1  # "no literal", literals, '*'
    full = [kernels.glob_table(p, "cpu").numpy().view(np.uint64)
            for p in pack.patterns]
    for c in range(256):
        k = int(pack.cmap[c])
        same = [d for d in range(256) if pack.cmap[d] == k]
        assert (c in lits) == (same == [c])
        for p, f in enumerate(full):
            assert np.array_equal(pack.tables.view(np.uint64)[p, k], f[c])
    for p, f in enumerate(full):
        assert np.array_equal(pack.tables.view(np.uint64)[p, -1], f[256])
    # the kernel's operands: the class map, the tables as 64-bit words
    cmap, words, ms = pack.on("cpu")
    assert np.array_equal(cmap.numpy(), pack.cmap)
    assert words.dtype == torch.int64
    assert np.array_equal(words.numpy().view(np.uint64),
                          pack.tables.view(np.uint64))
    assert np.array_equal(ms.numpy(), [3, 3, 2])


def test_unrecorded_glob_runs_as_a_pack_of_one():
    """A glob asked on a family whose packs do not hold it still runs (a
    pack of one, counted); a recorded one reads its pack's row."""
    patterns = ["a*b?c*", "*-prod", "?" * 64]
    byt, lens = _shared_subjects(patterns, 8, seed=3)
    lane, len_lane = tev.Ctx._FAMILY_LANES["ns"]
    N = byt.shape[0]
    batch = {"norm_hi": np.zeros((N, 1), np.uint32),
             "valid": np.ones((N, 1), np.uint8), lane: byt, len_lane: lens}
    nfa = tev.NfaPacks({"ns": patterns[:2] + patterns[2:], "name": ["x*"]})
    assert [p.nw for p in nfa.packs["ns"]] == [1, 2]
    tctx = tev.Ctx(lanes_to_device(batch, "cpu"), 4, nfa=nfa)
    for pattern in patterns + ["tenant-0*-*-prod"]:
        got = tctx.glob_meta(pattern, "ns")
        want = np.asarray(jev.glob_match(pattern, jnp.asarray(byt),
                                         jnp.asarray(lens)))
        assert np.array_equal(got.numpy(), want)
    assert tctx.stats["nfa_unpacked"] == 1
    assert ("\x00nfa", "ns", 0) in tctx._glob_cache
    assert ("\x00nfa", "ns", 1) in tctx._glob_cache


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_pass_closure_equals_reference_loop(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        raw = "".join(rng.choice(list("*?ab"), size=int(rng.integers(0, 12))))
        chars = kernels.glob_chars(raw)
        m = len(chars)
        cols = rng.random((9, m + 1)) < 0.4
        # the reference's closure (kyverno_tpu/tpu/evaluator.py:400-406)
        want = [cols[:, j].copy() for j in range(m + 1)]
        for j in range(1, m + 1):
            if chars[j - 1] == "*":
                want[j] = want[j] | want[j - 1]
        star = torch.tensor([c == "*" for c in chars], dtype=torch.bool)
        got = kernels._glob_closure(torch.from_numpy(cols), star)
        assert np.array_equal(got.numpy(), np.stack(want, axis=1))


# ---------------------------------------------------------------------------
# the slice: a tenant set whose globs overflow the bank

TENANT_GLOBS = ([f"tenant-{i:03d}-*-prod" for i in range(12)]
                + [f"t?-{i}-*" for i in range(4)])
BANK_STATES = 200


def tenant_policy(globs=TENANT_GLOBS):
    """One validate rule (a ``team`` label on Pods) and one mutate rule
    (stamp ``+(team)``), both matching the tenant namespace globs."""
    match = {"resources": {"kinds": ["Pod"], "namespaces": list(globs)}}
    return {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "tenant"},
        "spec": {"validationFailureAction": "Enforce", "rules": [
            {"name": "require-team", "match": copy.deepcopy(match),
             "validate": {"message": "team label required",
                          "pattern": {"metadata": {"labels": {"team": "?*"}}}}},
            {"name": "stamp-team", "match": copy.deepcopy(match),
             "mutate": {"patchStrategicMerge":
                        {"metadata": {"labels": {"+(team)": "core"}}}}}]},
    }


def tenant_resources(seed=0, n=48):
    """Pods and Namespaces in namespaces drawn from in-bank globs, NFA
    globs (with '?'), others, and names with a non-ASCII byte."""
    rng = np.random.default_rng(seed)
    spaces = ["tenant-003-a-prod", "tenant-011-xyz-prod", "tenant-010-q-prod",
              "tx-2-foo", "ta-3-", "té-1-x", "tq-0-é", "t中-2-z",
              "default", "kube-system", "t-1-x", "tenant-003-prod"]
    out = []
    for i in range(n):
        ns = spaces[int(rng.integers(0, len(spaces)))]
        if i % 5 == 4:
            out.append({"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": ns}})
            continue
        meta = {"name": f"p{i}", "namespace": ns}
        if rng.random() < 0.5:
            meta["labels"] = {"team": rng.choice(["a", "b"])}
        out.append({"apiVersion": "v1", "kind": "Pod", "metadata": meta,
                    "spec": {"containers": [{"name": "c", "image": "nginx"}]}})
    return out


@pytest.fixture
def small_bank(monkeypatch):
    monkeypatch.setattr(jdfa, "MAX_BANK_STATES", BANK_STATES)
    monkeypatch.setattr(tdfa, "MAX_BANK_STATES", BANK_STATES)


def tenant_engines():
    jeng = TpuEngine([JaxPolicy.from_dict(tenant_policy())])
    teng = TorchEngine(port_policies(jeng.cps.policies), device="cpu")
    return jeng, teng


def test_tenant_bank_split_equals_reference(small_bank):
    jeng, teng = tenant_engines()
    ja, ta = bank_to_numpy(jeng.cps.dfa), bank_to_numpy(teng.cps.dfa)
    assert ta["patterns"] == ja["patterns"]
    assert ta["families"] == ja["families"] and ta["glob_ids"] == ja["glob_ids"]
    assert_same_program(jeng, teng)
    outside = [g for g in TENANT_GLOBS if g not in teng.cps.dfa.glob_ids]
    # the bank is full: some globs (the '?' ones among them) are left
    # to the NFA, and both rules still run on the device
    assert outside and any("?" in g for g in outside)
    assert teng.coverage() == (1, 1) and teng.mutate_coverage() == (1, 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_tenant_scan_equals_reference(small_bank, seed):
    jeng, teng = tenant_engines()
    resources = tenant_resources(seed)
    ns_labels = {"tenant-003-a-prod": {"tier": "gold"}}
    rec = Recorded(jeng, resources, ns_labels, None, None)
    rec.result = jeng.scan(resources, ns_labels)
    assert_scan_equal(jeng, teng, rec)
    assert_full_scan_equal(teng, rec)
    # the device table holds CONFIRM cells ('?' globs on non-ASCII
    # namespaces), which the scan completed as the reference did
    table, _ = teng.scan_device(resources, ns_labels)
    assert (table == tev.CONFIRM).any()
    want = jeng.triage_mutate(resources, ns_labels)
    got = teng.triage_mutate(resources, ns_labels)
    assert got.rules == want.rules
    assert np.array_equal(got.verdicts, want.verdicts)
    assert (got.verdicts == tev.CONFIRM).any()


def test_tenant_program_packs_its_nfa_globs(small_bank):
    """The compiler records each program's NFA-route globs: the validate
    and the mutate program pack exactly the tenant globs the bank left
    out, on the namespace and name families, and their runs ask for no
    other glob."""
    jeng, teng = tenant_engines()
    outside = [g for g in TENANT_GLOBS if g not in teng.cps.dfa.glob_ids]
    for globs in (teng.cps.nfa_globs, teng.cps.mutate_nfa_globs):
        assert globs == {"ns": outside, "name": outside}
    resources = tenant_resources(2)
    teng.scan_device(resources)
    teng.triage_mutate(resources)
    assert teng.cps.device_fn().stats["nfa_unpacked"] == 0
    assert teng.cps.mutate_device_fn().stats["nfa_unpacked"] == 0
