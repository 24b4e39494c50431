"""B4, the non-ASCII flag of a lane family, against the JAX package's
``nonascii_mask`` on the CPU (tolerance: exact, bool).

The flag comes from K1 (``bank_match(..., want_nonascii=True)``: the
walk of pattern 0 ORs the words it reads) on the families the bank scans
for a program and needs it for (``compiler.nonascii_families``), and
from the standalone entry otherwise. On the CPU both are the plain twin
``kernels.nonascii_plain``; the subjects carry an accented letter inside
and past their lengths. A program with a bank-scanned family that needs
the flag makes no standalone call, and a '?' glob of a family no bank
pattern scans still gets its flag; both programs' tables equal the JAX
package's."""

import copy

import numpy as np
import pytest
import torch

from kyverno_tpu.api.policy import ClusterPolicy as JaxPolicy
from kyverno_tpu.tpu import dfa as jdfa
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.tpu import compiler as tcompiler
from kyverno_tpu_torch.tpu import dfa as tdfa
from kyverno_tpu_torch.tpu import evaluator as tev
from kyverno_tpu_torch.tpu.engine import TorchEngine

from test_torch_meta_any import mix_policy, mix_resources
from torch_kernel_cases import accented_subjects
from torch_parity_util import (Recorded, assert_full_scan_equal,
                               assert_scan_equal, port_policies)
from torch_parity_util import fresh_port_state  # noqa: F401


def _bank(stride):
    bank = tdfa.DfaBank(budget=12)
    jbank = jdfa.DfaBank(budget=12)
    for b in (bank, jbank):
        for p in ("a*b", "nginx-?", "*-suffix-*-mid-*-tail", "localhost/*"):
            b.add_glob(p, "pool")
        b.add_re2("^(ab|cd){1,10}x[0-9]{3}$", "pool")
        b.finalize(stride=stride)
    return bank, jbank


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("W", [64, 33, 8])
def test_k1_flag_equals_reference(stride, W):
    """K1's plain scan with ``want_nonascii``: the plane as without it,
    the flag the JAX ``nonascii_mask``."""
    bank, jbank = _bank(stride)
    byt, lens = accented_subjects(stride * 1000 + W, 512, W)
    want = np.asarray(jdfa.nonascii_mask(byt, lens))
    assert 0 < want.sum() < len(want)
    ids = bank.families["pool"]
    tb, tl = torch.from_numpy(byt), torch.from_numpy(lens)
    for plain in (False, True):
        plane, na = tdfa.bank_match(bank, ids, tb, tl, plain=plain,
                                    want_nonascii=True)
        assert np.array_equal(na.numpy(), want)
        assert np.array_equal(
            plane.numpy(), np.asarray(jdfa.bank_match(jbank, ids, byt, lens)))
    # lead dims, as the pool family's (N, K, W) lane
    plane, na = tdfa.bank_match(bank, ids, tb.view(8, 64, W),
                                tl.view(8, 64), want_nonascii=True)
    assert np.array_equal(na.numpy(), want.reshape(8, 64))
    assert tuple(plane.shape) == (8, 64, len(ids))


@pytest.mark.parametrize("S,W", [(1024, 64), (300, 33), (64, 1000)])
def test_standalone_twin_equals_reference(S, W):
    byt, lens = accented_subjects(S + W, S, W)
    want = np.asarray(jdfa.nonascii_mask(byt, lens))
    assert 0 < want.sum() < S
    tb, tl = torch.from_numpy(byt), torch.from_numpy(lens)
    assert np.array_equal(kernels.nonascii(tb, tl).numpy(), want)
    assert np.array_equal(tdfa.nonascii_mask(tb, tl).numpy(), want)
    # the rows the kernels read: a 16-byte pitch for this entry, 4 for
    # K1's, the bytes past W never live
    for m in (16, 4):
        rows = kernels._padded_rows(tb, m)
        assert rows.shape[1] % m == 0 and rows.shape[1] >= W
        assert rows.data_ptr() % m == 0 and torch.equal(rows[:, :W], tb)


def _spy(monkeypatch):
    """Record the byte lanes of each standalone flag and each bank scan
    the evaluator makes (by data pointer), and the bank scans that asked
    K1 for the flag."""
    seen = {"standalone": [], "bank": [], "bank_flag": []}
    real_mask, real_match = tev.nonascii_mask, tev.bank_match

    def mask(byt, lens, plain=False):
        seen["standalone"].append(byt.data_ptr())
        return real_mask(byt, lens, plain=plain)

    def match(bank, ids, byt, lens, plain=False, want_nonascii=False):
        seen["bank"].append(byt.data_ptr())
        if want_nonascii:
            seen["bank_flag"].append(byt.data_ptr())
        return real_match(bank, ids, byt, lens, plain=plain,
                          want_nonascii=want_nonascii)

    monkeypatch.setattr(tev, "nonascii_mask", mask)
    monkeypatch.setattr(tev, "bank_match", match)
    return seen


@pytest.fixture
def mix(monkeypatch):
    """test_torch_meta_any's mix: bank globs with and without '?', NFA
    globs with '?', names and namespaces (a small tenant set)."""
    monkeypatch.setenv("KYVERNO_TPU_DFA_STATE_BUDGET", "8")
    monkeypatch.setattr(jdfa, "MAX_BANK_STATES", 120)
    monkeypatch.setattr(tdfa, "MAX_BANK_STATES", 120)
    jeng = TpuEngine([JaxPolicy.from_dict(mix_policy())])
    teng = TorchEngine(port_policies(jeng.cps.policies), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("seed", [0, 1])
def test_a_scanned_family_takes_its_flag_from_k1(mix, monkeypatch, seed):
    jeng, teng = mix
    cps = teng.cps
    fams = tcompiler.nonascii_families(cps.dfa, cps.device_programs,
                                       cps.nfa_globs)
    assert "ns" in fams
    seen = _spy(monkeypatch)
    resources = mix_resources(seed)
    rec = Recorded(jeng, resources, None, None, None)
    rec.result = jeng.scan(copy.deepcopy(resources))
    assert_scan_equal(jeng, teng, rec)
    assert_full_scan_equal(teng, rec)
    assert seen["bank_flag"]
    # no standalone flag of a family a K1 launch of this program scans
    assert not set(seen["standalone"]) & set(seen["bank"])
    if fams >= {f for f, globs in cps.nfa_globs.items()
                if any("?" in g for g in globs)}:
        assert seen["standalone"] == []
    want = jeng.triage_mutate(copy.deepcopy(resources))
    got = teng.triage_mutate(copy.deepcopy(resources))
    assert np.array_equal(got.verdicts, want.verdicts)


def _nfa_only_policy():
    return {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "nfa-only"},
        "spec": {"validationFailureAction": "Enforce", "rules": [
            {"name": "team", "match": {"any": [{"resources": {
                "kinds": ["Pod"], "namespaces": ["t?-*", "x??y*"]}}]},
             "validate": {"message": "team label required",
                          "pattern": {"metadata": {"labels": {
                              "team": "?*"}}}}}]},
    }


def test_a_question_glob_off_the_bank_gets_its_flag(monkeypatch):
    """Every glob refused by the bank (``MAX_BANK_STATES`` 0 in both
    packages): the namespace family is on the NFA route alone, so its
    flag takes the standalone entry, and the CONFIRM cells of non-ASCII
    namespaces match the JAX package's."""
    monkeypatch.setattr(jdfa, "MAX_BANK_STATES", 0)
    monkeypatch.setattr(tdfa, "MAX_BANK_STATES", 0)
    jeng = TpuEngine([JaxPolicy.from_dict(_nfa_only_policy())])
    teng = TorchEngine(port_policies(jeng.cps.policies), device="cpu")
    assert set(teng.cps.nfa_globs["ns"]) == {"t?-*", "x??y*"}
    assert tcompiler.nonascii_families(
        teng.cps.dfa, teng.cps.device_programs, teng.cps.nfa_globs) \
        == frozenset()
    seen = _spy(monkeypatch)
    spaces = ["t1-a", "té-a", "tx-é", "xaby", "xéy", "x12y-z", "default"]
    resources = [{"apiVersion": "v1", "kind": "Pod",
                  "metadata": {"name": f"p{i}", "namespace": ns,
                               **({"labels": {"team": "a"}} if i % 2
                                  else {})}}
                 for i, ns in enumerate(spaces * 3)]
    rec = Recorded(jeng, resources, None, None, None)
    rec.result = jeng.scan(copy.deepcopy(resources))
    assert_scan_equal(jeng, teng, rec)
    assert_full_scan_equal(teng, rec)
    # one flag a family with a '?' glob, a run: the namespace, a
    # Namespace's name and the pool's '?*', over the two runs above
    assert set(teng.cps.nfa_globs) == {"ns", "name", "pool"}
    assert len(seen["standalone"]) == 2 * 3 and seen["bank"] == []
    table, _ = teng.scan_device(resources)
    assert (table == tev.CONFIRM).any()


def _asked(monkeypatch):
    """Per program run (a ``Ctx``): its ``na_families``, the families
    whose flag the evaluator asked for, and those whose bank plane it
    scanned for an accept column (not only for the flag)."""
    runs = {}
    real_plane, real_flag = tev.Ctx._bank_plane, tev.Ctx._family_nonascii

    def run(ctx):
        return runs.setdefault(id(ctx), (ctx._na_families, set(), set()))

    def plane(ctx, family):
        if not getattr(ctx, "_in_flag", False):
            run(ctx)[2].add(family)
        return real_plane(ctx, family)

    def flag(ctx, family):
        run(ctx)[1].add(family)
        ctx._in_flag = True
        try:
            return real_flag(ctx, family)
        finally:
            ctx._in_flag = False

    monkeypatch.setattr(tev.Ctx, "_bank_plane", plane)
    monkeypatch.setattr(tev.Ctx, "_family_nonascii", flag)
    return runs


def _pss_accented():
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.policy.autogen import expand_policy

    pods = [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}-é" if i % 3 else f"p{i}",
                          "namespace": "dé" if i % 2 else "d"},
             "spec": {"containers": [{
                 "name": "c", "image": "nginx" if i % 4 else "ngïnx:1",
                 "securityContext": {"privileged": i % 5 == 0}}]}}
            for i in range(24)]
    return [expand_policy(p) for p in load_pss_policies()], pods


def _overflow_policy():
    """A bank glob without '?' and a '?' glob the bank refuses (with
    ``MAX_BANK_STATES`` 20), over the same lane families."""
    return {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "overflow"},
        "spec": {"validationFailureAction": "Enforce", "rules": [
            {"name": "team", "match": {"any": [{"resources": {
                "kinds": ["Pod"],
                "namespaces": ["tenant-*-prod", "x??y*-z*"]}}]},
             "validate": {"pattern": {"metadata": {"labels": {
                 "team": "?*"}}}}}]},
    }


@pytest.mark.parametrize("corpus", ["mix", "nfa_bank", "nfa_only",
                                    "overflow", "pss"])
def test_compile_names_the_families_the_evaluator_flags(monkeypatch,
                                                        corpus):
    """``compiler.nonascii_families`` and the evaluator's confirm sites
    decide the flag apart: on each corpus, and for the validate and the
    mutate program alike, the families K1 is asked to flag are exactly
    those whose flag the evaluator reads and whose bank plane it scans.
    A family missing from the set would take the standalone launch; one
    too many would make K1 flag for nothing."""
    if corpus == "mix":
        monkeypatch.setenv("KYVERNO_TPU_DFA_STATE_BUDGET", "8")
        monkeypatch.setattr(tdfa, "MAX_BANK_STATES", 120)
        policies = port_policies([JaxPolicy.from_dict(mix_policy())])
        resources = mix_resources(0)
    elif corpus == "pss":
        policies, resources = _pss_accented()
    elif corpus == "overflow":
        monkeypatch.setattr(tdfa, "MAX_BANK_STATES", 20)
        policies = port_policies([JaxPolicy.from_dict(_overflow_policy())])
        resources = [{"apiVersion": "v1", "kind": "Pod",
                      "metadata": {"name": f"p{i}", "namespace": ns}}
                     for i, ns in enumerate(["tenant-a-prod", "tenant-é-prod",
                                             "xaby-zz", "xéy-z", "default"])]
    else:
        if corpus == "nfa_only":
            monkeypatch.setattr(tdfa, "MAX_BANK_STATES", 0)
        policies = port_policies([JaxPolicy.from_dict(_nfa_only_policy())])
        resources = [{"apiVersion": "v1", "kind": "Pod",
                      "metadata": {"name": f"p{i}", "namespace": ns}}
                     for i, ns in enumerate(["t1-a", "té-a", "xéy", "x1y"])]
    teng = TorchEngine(policies, device="cpu")
    if corpus == "overflow":
        assert teng.cps.nfa_globs["ns"] == ["x??y*-z*"]
    runs = _asked(monkeypatch)
    teng.scan_device(copy.deepcopy(resources))
    teng.triage_mutate(copy.deepcopy(resources))
    assert runs
    for na_families, flagged, scanned in runs.values():
        assert na_families == flagged & scanned
    # every corpus but PSS has a '?' glob that needs the flag
    assert any(na for na, _, _ in runs.values()) == (corpus not in (
        "nfa_only", "pss"))
