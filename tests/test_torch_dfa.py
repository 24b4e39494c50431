"""kyverno_tpu_torch/tpu/dfa.py against kyverno_tpu/tpu/dfa.py.

The port's copy of the table compiler must build the JAX package's
arrays, and the port's bank scan (kernel K1's plain twin on the CPU)
must give the JAX ``bank_match`` / ``nonascii_mask`` accepts, bit for
bit, at every stride and on approximated automata. Subjects are made
from seeds and include non-ASCII bytes and lengths that are not
multiples of any stride. All outputs are bool: tolerance 0."""

import random

import numpy as np
import pytest
import torch

from kyverno_tpu.tpu import dfa as jdfa
from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.tpu import dfa as tdfa
from kyverno_tpu_torch.tpu.convert import bank_from_numpy, bank_to_numpy

from torch_parity_util import fresh_port_state  # noqa: F401 - autouse
from test_dfa import GLOB_CASES, RE2_CASES, REDUCE_PATTERNS


def _corpus(seed, n=80):
    rng = random.Random(seed)
    pool = "abcx01-./é名" + "\x80\xff"
    fixed = ["", "a", "ab", "abc", "abcd", "abcde", "nginx-1.25", "café",
             "名前-x", "xxxcafé", "a" * 31, "ab" * 13, "localhost/x",
             "container.apparmor.security.beta.kubernetes.io/c0"]
    return fixed + ["".join(rng.choice(pool) for _ in range(rng.randint(0, 40)))
                    for _ in range(n)]


def _pack(strs, width, seed):
    """(S, width) uint8 + (S,) int32; the bytes past each length are
    seeded noise (the scan must ignore them), and some lengths exceed
    the width (the encoder truncates at the width)."""
    rng = np.random.default_rng(seed)
    byt = rng.integers(0, 256, size=(len(strs), width), dtype=np.uint8)
    lens = np.zeros((len(strs),), np.int32)
    for i, s in enumerate(strs):
        e = s.encode("utf-8")[:width]
        byt[i, :len(e)] = np.frombuffer(e, np.uint8)
        lens[i] = len(s.encode("utf-8"))
    return byt, lens


def _banks(kind, stride):
    out = []
    for mod in (jdfa, tdfa):
        if kind == "approx":
            bank = mod.DfaBank(budget=12, ceiling=0.05)
            for k, pat in REDUCE_PATTERNS:
                (bank.add_glob if k == "glob" else bank.add_re2)(pat, "pool")
        else:
            bank = mod.DfaBank(budget=64)
            for p in GLOB_CASES:
                bank.add_glob(p, "pool")
            for p in RE2_CASES:
                bank.add_re2(p, "pool")
        out.append(bank.finalize(stride=stride))
    return out


CASES = [(kind, stride) for kind in ("exact", "approx") for stride in (1, 2, 4)]


@pytest.mark.parametrize("kind,stride", CASES)
def test_port_compiler_builds_reference_arrays(kind, stride):
    jbank, tbank = _banks(kind, stride)
    ja, ta = bank_to_numpy(jbank), bank_to_numpy(tbank)
    assert set(ja) == set(ta)
    for k, v in ja.items():
        if isinstance(v, np.ndarray):
            assert ta[k].dtype == v.dtype and np.array_equal(ta[k], v), k
        else:
            assert ta[k] == v, k
    if kind == "approx":
        assert jbank.stats()["approx"] >= 1
    assert jbank.digest() == tbank.digest()


@pytest.mark.parametrize("kind,stride", CASES)
@pytest.mark.parametrize("width", [32, 33, 96])
def test_bank_match_equals_reference(kind, stride, width):
    jbank, _ = _banks(kind, stride)
    bank = bank_from_numpy(bank_to_numpy(jbank))
    byt, lens = _pack(_corpus(stride * 100 + width), width, seed=width)
    # a lead axis, as the pool lanes have: (N, slots, W)
    byt3, lens3 = byt.reshape(2, -1, width), lens.reshape(2, -1)
    ids = jbank.families["pool"]
    want = np.asarray(jdfa.bank_match(jbank, ids, byt3, lens3))
    got = tdfa.bank_match(bank, ids, torch.from_numpy(byt3),
                          torch.from_numpy(lens3))
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    # the plain twins called directly agree with the wrapper's CPU path
    plain = tdfa.bank_match(bank, ids, torch.from_numpy(byt3),
                            torch.from_numpy(lens3), plain=True)
    assert torch.equal(plain, got)
    # a subset of ids, out of order, is put back in id order
    sub = ids[::-2]
    want = np.asarray(jdfa.bank_match(jbank, sub, byt, lens))
    got = tdfa.bank_match(bank, sub, torch.from_numpy(byt),
                          torch.from_numpy(lens))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [1, 32, 96])
def test_nonascii_mask_equals_reference(width):
    byt, lens = _pack(_corpus(width), width, seed=7 + width)
    want = np.asarray(jdfa.nonascii_mask(byt, lens))
    got = tdfa.nonascii_mask(torch.from_numpy(byt), torch.from_numpy(lens))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


def test_fused_entry_nonascii_output_equals_reference():
    """K1's optional non-ASCII output rides the scan's own entry."""
    jbank, _ = _banks("exact", 4)
    bank = bank_from_numpy(bank_to_numpy(jbank))
    byt, lens = _pack(_corpus(5), 96, seed=5)
    ids = [i for i in jbank.families["pool"] if jbank.strides[i] == 4]
    (tiles,) = tdfa.scan_groups(bank, ids, "cpu")
    out = torch.empty((byt.shape[0], len(ids)), dtype=torch.bool)
    acc, na = kernels.dfa_scan_fused(
        torch.from_numpy(byt), torch.from_numpy(lens), tiles, out,
        want_nonascii=True)
    assert acc is out
    assert np.array_equal(na.numpy(), np.asarray(jdfa.nonascii_mask(byt, lens)))
    want = np.asarray(jdfa.bank_match(jbank, ids, byt, lens))
    assert np.array_equal(acc.numpy(), want)


def test_stride_env_knob_reaches_both_compilers(monkeypatch):
    """``KYVERNO_TPU_DFA_STRIDE`` caps the stride of both packages'
    banks alike; the port's scan follows the caps it is given."""
    byt, lens = _pack(_corpus(11), 64, seed=11)
    for cap in ("1", "2", "4"):
        monkeypatch.setenv("KYVERNO_TPU_DFA_STRIDE", cap)
        banks = []
        for mod in (jdfa, tdfa):
            bank = mod.DfaBank(budget=64)
            for p in GLOB_CASES:
                bank.add_glob(p, "pool")
            banks.append(bank.finalize())
        jbank, tbank = banks
        assert np.array_equal(jbank.strides, tbank.strides)
        ids = jbank.families["pool"]
        want = np.asarray(jdfa.bank_match(jbank, ids, byt, lens))
        got = tdfa.bank_match(tbank, ids, torch.from_numpy(byt),
                              torch.from_numpy(lens))
        assert np.array_equal(got.numpy(), want), cap
