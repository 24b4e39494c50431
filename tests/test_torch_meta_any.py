"""Kernel K10 ``meta_any`` (the names / namespaces any-of of a match
filter) through its plain twin, against the JAX package on the CPU.

The policy holds every kind of entry the per-entry loop of
``_eval_condition_block`` can meet, with the DFA state budget lowered to
8 (over-approximating bank DFAs) and ``MAX_BANK_STATES`` to 120 in both
packages (globs left to the NFA route):

- literals (a 64-bit hash equality);
- bank globs that are exact, inexact (their accept is the confirm
  plane) and ``confirm_nonascii`` (a '?': the family's non-ASCII mask
  confirms);
- NFA-route globs with and without '?', in K9 packs, and one glob left
  out of the packs (a pack of one, counted in ``nfa_unpacked``);
- lists under ``match`` and under ``exclude``, for ``names`` and
  ``namespaces``, over Pods and Namespace-kind resources whose names
  and namespaces carry non-ASCII bytes.

``Ctx.meta_any`` must give the hit and the OR of the confirm planes that
the reference's loop gives (bool, exact), and the whole scan's device
table, counts and completed result, and the mutate triage table, must
equal the JAX package's, bit for bit."""

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
from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device

from torch_parity_util import (Recorded, assert_full_scan_equal,
                               assert_same_program, assert_scan_equal,
                               padded_args, port_policies)
from torch_parity_util import fresh_port_state  # noqa: F401

NAMESPACES = (["default", "kube-system"]
              + [f"tenant-{i:02d}-*-prod" for i in range(6)]
              + ["*x???-*", "t?-1-*", "tq-?-*", "é*", "*-??-*-?", "a*b*c*d*"]
              + [f"grp{i}-*" for i in range(6)] + ["z?-*", "zz-*-?", "y*"])
NAMES = ["p1", "p2*", "é*", "n?-*", "web-*", "*q??-*"]
EXCLUDE_NS = ["kube-*", "t?-9-*"]
EXCLUDE_NAMES = ["skip-*", "x?"]

SPACES = ["tenant-03-a-prod", "tenant-05-zz-prod", "ax123-q", "bx1é3-q",
          "tq-7-z", "t1-1-u", "té-1-u", "é-ns", "a-b-c-d", "grp1-x",
          "grp4-y", "z1-k", "zé-k", "zz-a-b", "yak", "kube-public",
          "t4-9-x", "default", "kube-system", "other", "tq-é-z", "x-12-y-z",
          "tenant-03-prod"]
PODS = ["p1", "p22", "é-pod", "n1-x", "né-x", "web-1", "aq12-x", "skip-me",
        "xy", "plain"]


def mix_policy():
    match = {"any": [
        {"resources": {"kinds": ["Pod", "Namespace"],
                       "namespaces": list(NAMESPACES)}},
        {"resources": {"kinds": ["Pod"], "names": list(NAMES)}}]}
    exclude = {"any": [{"resources": {"namespaces": list(EXCLUDE_NS),
                                      "names": list(EXCLUDE_NAMES)}}]}
    return {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "mix"},
        "spec": {"validationFailureAction": "Enforce", "rules": [
            {"name": "require-team", "match": copy.deepcopy(match),
             "exclude": copy.deepcopy(exclude),
             "validate": {"message": "team label required",
                          "pattern": {"metadata": {"labels": {"team": "?*"}}}}},
            {"name": "stamp-team", "match": copy.deepcopy(match),
             "exclude": copy.deepcopy(exclude),
             "mutate": {"patchStrategicMerge":
                        {"metadata": {"labels": {"+(team)": "core"}}}}}]},
    }


def mix_resources(seed, n=64):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ns = SPACES[int(rng.integers(0, len(SPACES)))]
        if i % 4 == 3:
            out.append({"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": ns}})
            continue
        meta = {"name": PODS[int(rng.integers(0, len(PODS)))] + f"{i % 3}"
                if i % 2 else PODS[int(rng.integers(0, len(PODS)))],
                "namespace": ns}
        if rng.random() < 0.5:
            meta["labels"] = {"team": "a"}
        out.append({"apiVersion": "v1", "kind": "Pod", "metadata": meta,
                    "spec": {"containers": [{"name": "c", "image": "nginx"}]}})
    return out


@pytest.fixture
def mix(monkeypatch):
    monkeypatch.setenv("KYVERNO_TPU_DFA_STATE_BUDGET", "8")
    monkeypatch.setattr(jdfa, "MAX_BANK_STATES", 120)
    monkeypatch.setattr(tdfa, "MAX_BANK_STATES", 120)
    jeng = TpuEngine([JaxPolicy.from_dict(mix_policy())])
    teng = TorchEngine(port_policies(jeng.cps.policies), device="cpu")
    return jeng, teng


def test_the_mix_covers_every_source(mix):
    jeng, teng = mix
    assert_same_program(jeng, teng)
    bank = teng.cps.dfa
    ns_globs = [g for g in NAMESPACES if "*" in g or "?" in g]
    in_bank = [bank.patterns[bank.glob_ids[g]] for g in ns_globs
               if g in bank.glob_ids]
    assert any(d.exact and not d.confirm_nonascii for d in in_bank)
    assert any(not d.exact for d in in_bank)
    assert any(d.confirm_nonascii for d in in_bank)
    nfa = teng.cps.nfa_globs["ns"]
    assert any("?" in g for g in nfa) and any("?" not in g for g in nfa)
    assert set(EXCLUDE_NAMES) <= set(teng.cps.nfa_globs["name"])


def _ctxs(jeng, teng, resources, nfa):
    batch = jeng.encode(*padded_args(jeng, Recorded(jeng, resources, None,
                                                    None, None))[:1])[0]
    jctx = jev.Ctx({k: jnp.asarray(v) for k, v in batch.items()},
                   jeng.cps.encode_cfg.max_instances, dfa=jeng.cps.dfa)
    tctx = tev.Ctx(lanes_to_device(batch, "cpu"),
                   teng.cps.encode_cfg.max_instances, dfa=teng.cps.dfa,
                   plain=True, nfa=tev.NfaPacks(nfa))
    return jctx, tctx


def _reference_loop(jctx, which, patterns):
    """The JAX package's per-entry loop (_eval_condition_block,
    1618-1631) and the OR of the confirm planes it appends."""
    jctx.confirm_acc = []
    hit = jnp.zeros((jctx.N,), dtype=bool)
    if which == "names":
        for nm in patterns:
            hit = hit | jev._glob_or_eq(jctx, nm, "name", "name_h", "m")
    else:
        is_ns = jctx.b["meta_is_namespace_kind"] == 1
        for ns in patterns:
            by_ns = jev._glob_or_eq(jctx, ns, "ns", "ns_h", "N")
            by_name = jev._glob_or_eq(jctx, ns, "name", "name_h", "m")
            hit = hit | jnp.where(is_ns, by_name, by_ns)
    conf = jnp.zeros((jctx.N,), dtype=bool)
    for c in jctx.confirm_acc:
        conf = conf | c
    return np.asarray(hit), np.asarray(conf)


def _lists(prog):
    for f in list(prog.match.filters) + list(prog.exclude.filters):
        if f.names:
            yield "names", f.names
        if f.namespaces:
            yield "namespaces", f.namespaces


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("drop", [None, "zz-*-?", "grp4-*"])
def test_meta_any_plain_equals_the_reference_loop(mix, seed, drop):
    """Every filter list of both programs; ``drop`` leaves one NFA glob
    out of the packs (it runs as a pack of one)."""
    jeng, teng = mix
    resources = mix_resources(seed)
    nfa = {f: [g for g in gs if g != drop]
           for f, gs in teng.cps.nfa_globs.items()}
    jctx, tctx = _ctxs(jeng, teng, resources, nfa)
    seen = 0
    unpacked = set()
    for jprog, tprog in zip(jeng.cps.device_programs
                            + jeng.cps.mutate_programs,
                            teng.cps.device_programs
                            + teng.cps.mutate_programs):
        for (which, jl), (_, tl) in zip(_lists(jprog), _lists(tprog)):
            assert list(jl) == list(tl)
            want_hit, want_conf = _reference_loop(jctx, which, jl)
            tctx.confirm_acc = []
            hit = tctx.meta_any(which, tl)
            conf = torch.zeros((tctx.N,), dtype=torch.bool)
            for c in tctx.confirm_acc:
                conf = conf | c
            assert np.array_equal(hit.numpy(), want_hit), which
            assert np.array_equal(conf.numpy(), want_conf), which
            assert want_hit.any() and not want_hit.all()
            seen += 1
            fams = ("name",) if which == "names" else ("name", "ns")
            unpacked |= {(fam, drop) for fam in fams if drop in tl}
    assert seen == 8
    assert want_conf.any() or drop is not None
    assert tctx.stats["nfa_unpacked"] == len(unpacked)


def test_entry_table_layout(mix):
    """Each family's entries sorted by (plane, column), literals as
    hash pairs, one plane a bank family / pack / unpacked stack; lists
    of the same entries share one table."""
    jeng, teng = mix
    _, tctx = _ctxs(jeng, teng, mix_resources(0), teng.cps.nfa_globs)
    prog = teng.cps.device_programs[0]
    f = prog.match.filters[0]
    table = tctx._meta_table("namespaces", f.namespaces)
    assert table is tctx._meta_table("namespaces", f.namespaces)
    # the mutate rule's own copy of the list shares the table (and so
    # one launch a batch)
    mf = teng.cps.mutate_programs[0].match.filters[0]
    assert mf.namespaces is not f.namespaces
    assert tctx._meta_table("namespaces", mf.namespaces) is table
    assert table.families == ("name", "ns")
    E = len(f.namespaces)
    assert table.off == (E, 2 * E) and table.ent.shape == (2 * E, 4)
    for lo, hi in ((0, E), (E, 2 * E)):
        rows = table.ent[lo:hi]
        keys = [tuple(r[:2]) for r in rows]
        assert keys == sorted(keys)
        assert (rows[:, 0] == -1).sum() == 2  # the two literals
    assert table.na == (True, True) and table.confirms
    kinds = {k[0] for k in table.slots}
    assert kinds == {"bank", "nfa"}
    assert [k[0] == "bank" for k in table.slots] == \
        [not em for em in table.entry_major]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix_scan_and_triage_equal_reference(mix, seed):
    jeng, teng = mix
    resources = mix_resources(seed)
    rec = Recorded(jeng, resources, None, None, None)
    rec.result = jeng.scan(copy.deepcopy(resources))
    kernels.reset_launches()
    assert_scan_equal(jeng, teng, rec)
    assert_full_scan_equal(teng, rec)
    want = jeng.triage_mutate(copy.deepcopy(resources))
    got = teng.triage_mutate(copy.deepcopy(resources))
    assert got.rules == want.rules
    assert np.array_equal(got.verdicts, want.verdicts)
    assert teng.cps.device_fn().stats["nfa_unpacked"] == 0
    # the CPU path runs the twin and counts no launch
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_tenant_scan_and_triage_equal_reference(monkeypatch):
    """The tenant set of tests/test_torch_glob_nfa.py (globs overflowing
    the bank), through K10's twin."""
    from test_torch_glob_nfa import (BANK_STATES, tenant_policy,
                                     tenant_resources)

    monkeypatch.setattr(jdfa, "MAX_BANK_STATES", BANK_STATES)
    monkeypatch.setattr(tdfa, "MAX_BANK_STATES", BANK_STATES)
    jeng = TpuEngine([JaxPolicy.from_dict(tenant_policy())])
    teng = TorchEngine(port_policies(jeng.cps.policies), device="cpu")
    for seed in (3, 4):
        resources = tenant_resources(seed, n=40)
        ns_labels = {"tenant-003-a-prod": {"tier": "gold"}}
        rec = Recorded(jeng, resources, ns_labels, None, None)
        rec.result = jeng.scan(resources, ns_labels)
        assert_scan_equal(jeng, teng, rec)
        assert_full_scan_equal(teng, rec)
        want = jeng.triage_mutate(resources, ns_labels)
        got = teng.triage_mutate(resources, ns_labels)
        assert np.array_equal(got.verdicts, want.verdicts)


# ---------------------------------------------------------------------------
# the kernel's table (``MetaAnyTable.tab``), read by a numpy model of
# csrc/meta_any.cu


def _meta_any_model(table, planes, hashes, is_ns, na):
    """hit and confirm as the kernel reads ``table.tab``: each bank run's
    column masks ANDed with a resource's row, each pack run's rows
    (row | self << 31), and each family's sorted literals searched by
    bisection."""
    import bisect

    tab = table.tab
    raw = tab.view(np.uint8)
    nb, ne, at_runs, at_rows = (int(x) for x in tab[:4])
    runs = tab[at_runs:at_runs + 4 * (nb + ne)].reshape(-1, 4)
    N = hashes[0].shape[0]
    flags = np.zeros((N, 3), dtype=bool)  # family 0 / 1 hit, confirm
    for s, fs, ncols, moff in runs[:nb].tolist():
        fam, own = fs & 0xFF, fs >> 8
        pad = -(-ncols // 16) * 16
        row = planes[s].numpy()[:, :ncols]
        flags[:, fam] |= (row & (raw[moff:moff + ncols] != 0)).any(1)
        assert not raw[moff - 16:moff].any()
        assert not raw[moff + ncols:moff + pad + 32].any()
        if own:
            sm = raw[moff + pad + 48:moff + pad + 48 + ncols] != 0
            flags[:, 2] |= (row & sm).any(1)
    for s, fam, first, count in runs[nb:].tolist():
        q = tab[at_rows + first:at_rows + first + count].astype(np.int64)
        acc = planes[s].numpy()[q & 0x7FFFFFFF].T
        flags[:, fam] |= acc.any(1)
        flags[:, 2] |= (acc & (q < 0)).any(1)
    for f in range(len(hashes)):
        at, cnt = int(tab[4 + 2 * f]), int(tab[5 + 2 * f])
        lit = tab[at:at + 4 * cnt].reshape(-1, 4)
        keys = [tuple(r[:2]) for r in lit.tolist()]
        assert keys == sorted(set(keys))  # sorted, one row a literal
        for n, key in enumerate(map(tuple, hashes[f].numpy().tolist())):
            i = bisect.bisect_left(keys, key)
            if i < cnt and keys[i] == key:
                flags[n, f] = True
                flags[n, 2] |= bool(lit[i, 2])
    hit = flags[:, 0] if is_ns is None else \
        np.where(is_ns.numpy(), flags[:, 0], flags[:, 1])
    conf = flags[:, 2]
    for m in na:
        if m is not None:
            conf = conf | m.numpy()
    return hit, conf


@pytest.mark.parametrize("case", ["every", "hash", "bank", "pack", "no-name",
                                  "no-ns"])
@pytest.mark.parametrize("seed", [0, 1])
def test_meta_any_table_model_equals_plain(case, seed):
    """The kernel's derived table (bank column masks, pack row runs,
    sorted literals), read by a numpy model, gives ``meta_any_plain``'s
    hit and confirm on random tables of each source kind (bank planes
    aligned, at an odd offset and transposed; ``self`` entries and
    duplicates; both non-ASCII masks; an empty family); names (one
    family) too."""
    from torch_kernel_cases import MIX_SOURCES, meta_any_mix

    sizes = {"no-name": (0, 40), "no-ns": (40, 0)}.get(case, (40, 40))
    table, planes, hashes, is_ns, na = meta_any_mix(
        seed, 517, sizes, MIX_SOURCES.get(case, MIX_SOURCES["every"]))
    hit, conf = kernels.meta_any_plain(table, planes, hashes, is_ns, na)
    mhit, mconf = _meta_any_model(table, planes, hashes, is_ns, na)
    assert np.array_equal(hit.numpy(), mhit)
    assert np.array_equal(conf.numpy(), mconf)
    assert hit.any() and not hit.all()
    # names: the name family alone
    one = kernels.MetaAnyTable(("name",), table.slots, table.entry_major,
                               table.ent[:table.off[0]],
                               (table.off[0], table.off[0]), (False,),
                               table.unpacked)
    hit, conf = kernels.meta_any_plain(one, planes, hashes[:1])
    mhit, mconf = _meta_any_model(one, planes, hashes[:1], None, ())
    assert np.array_equal(hit.numpy(), mhit)
    assert np.array_equal(conf.numpy(), mconf)


def test_meta_any_table_on_the_tenant_list(mix):
    """The derived table of the mix policy's ``namespaces`` list: one
    mask run a bank family, one row run a pack, the literals sorted,
    the table a multiple of 16 bytes; its model equals the twin on the
    batch's own planes."""
    jeng, teng = mix
    _, tctx = _ctxs(jeng, teng, mix_resources(0), teng.cps.nfa_globs)
    f = teng.cps.device_programs[0].match.filters[0]
    args = tctx.meta_any_args("namespaces", f.namespaces)
    table = args[0]
    nb, ne = int(table.tab[0]), int(table.tab[1])
    assert nb == sum(k[0] == "bank" for k in table.slots) == 2
    assert ne == sum(k[0] != "bank" for k in table.slots) > 0
    assert table.tab.size % 4 == 0
    assert table.need == {s: int(table.ent[table.ent[:, 0] == s, 1].max()) + 1
                          for s in range(len(table.slots))}
    hit, conf = kernels.meta_any_plain(*args)
    mhit, mconf = _meta_any_model(*args)
    assert np.array_equal(hit.numpy(), mhit)
    assert np.array_equal(conf.numpy(), mconf)


def test_meta_any_tile_choice():
    """A block's resources: a tile of ``META_ANY_TILES``, the largest that
    leaves ``META_ANY_MIN_BLOCKS`` blocks, the smallest below that."""
    for N in (1, 100, 1024, 4000, 16384, 100000, 1 << 20):
        R = kernels.meta_any_tile(N)
        assert R in kernels.META_ANY_TILES and R == kernels.meta_any_tile(N)
        bigger = [t for t in kernels.META_ANY_TILES if t > R]
        if -(-N // R) >= kernels.META_ANY_MIN_BLOCKS:
            assert all(-(-N // t) < kernels.META_ANY_MIN_BLOCKS
                       for t in bigger)
        else:
            assert R == kernels.META_ANY_TILES[0]
