"""K3's one-level counts in kyverno_tpu_torch: the compact scope
(``kernels.scope8``), several predicates a launch (``instance_count_many``
and its plain twin) and the evaluator's count memo, against the JAX
package's ``InstScope.count`` / ``any`` einsums
(kyverno_tpu/tpu/evaluator.py) on the same numpy-seeded inputs.

- Hazard scopes (-1, >= I, invalid rows), predicates broadcast from
  (1, R), strided and sliced predicates, 1 to 8 predicates a call,
  "count", "any" and mixed requests.
- ``InstScope.many`` / ``Inst2Scope`` through a port ``Ctx``: memo hits
  on keyed row masks give the same tensors as a fresh count.
- The PSS program issues no more K3 calls than PERF.md states, guarded
  by the ``Ctx`` counters (the program's ``stats``).

All outputs are int32 counts or bools: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kyverno_tpu.tpu import evaluator as jev
from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.tpu import evaluator as tev
from kyverno_tpu_torch.tpu.flatten import T_ARR, T_MAP

import torch_parity_util  # noqa: F401  (one torch thread)
from torch_parity_util import fresh_port_state  # noqa: F401


def _batch(seed, N=24, R=40, I=16):
    rng = np.random.default_rng(seed)
    # scopes span -1 (padding), [0, I) and >= I (overflowed instances)
    s1 = rng.integers(-1, I + 3, size=(N, R)).astype(np.int32)
    s2 = rng.integers(-1, I + 3, size=(N, R)).astype(np.int32)
    valid = (rng.random((N, R)) < 0.8).astype(np.uint8)
    tags = rng.integers(0, 7, size=(N, R)).astype(np.uint8)
    return {"norm_hi": np.zeros((N, R), np.uint32), "valid": valid,
            "scope1": s1, "scope2": s2, "type_tag": tags}


def _preds(rng, N, R, P):
    """P numpy bool predicates: full (N, R) ones and (1, R) broadcasts."""
    out = []
    for q in range(P):
        shape = (1, R) if q % 3 == 1 else (N, R)
        out.append(rng.random(shape) < rng.choice([0.05, 0.5, 0.9]))
    return out


def _reference(batch, I, pred, want):
    ctx = jev.Ctx({k: jnp.asarray(v) for k, v in batch.items()}, I)
    full = jnp.asarray(np.broadcast_to(pred, batch["scope1"].shape))
    scope = jev.InstScope(ctx)
    return np.asarray(scope.any(full) if want == "any" else
                      scope.count(full).astype(jnp.int32))


@pytest.mark.parametrize("I", [4, 16, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_scope8_marks_rows_that_count_nowhere(seed, I):
    b = _batch(seed, I=I)
    s1 = torch.from_numpy(b["scope1"])
    valid = torch.from_numpy(b["valid"]) != 0
    got = kernels.scope8(s1, valid, I)
    assert got.dtype == torch.uint8
    ok = b["valid"].astype(bool) & (b["scope1"] >= 0) & (b["scope1"] < I)
    want = np.where(ok, b["scope1"], kernels.SCOPE_NONE).astype(np.uint8)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        kernels.scope8(s1, valid, 65)


@pytest.mark.parametrize("P", list(range(1, 9)))
@pytest.mark.parametrize("I", [4, 16])
def test_many_equals_reference_einsum(P, I):
    b = _batch(P * 7 + I, I=I)
    N, R = b["scope1"].shape
    rng = np.random.default_rng(P)
    preds = _preds(rng, N, R, P)
    wants = [rng.choice(["count", "any"]) for _ in range(P)]
    sc = kernels.scope8(torch.from_numpy(b["scope1"]),
                        torch.from_numpy(b["valid"]) != 0, I)
    tp = [torch.from_numpy(p).expand(N, R) for p in preds]
    for want in ("count", "any", wants):
        got = kernels.instance_count_many(tp, sc, I, want)
        plain = kernels.instance_count_many_plain(tp, sc, I, want)
        ws = [want] * P if isinstance(want, str) else want
        for g, pl, p, w in zip(got, plain, preds, ws):
            assert g.dtype == (torch.bool if w == "any" else torch.int32)
            assert tuple(g.shape) == (N, I)
            assert torch.equal(g, pl)
            assert np.array_equal(g.numpy(), _reference(b, I, p, w))
            if w == "count":  # and the two-argument one-hot count
                one = kernels.instance_count_plain(
                    torch.from_numpy(np.broadcast_to(p, (N, R)).copy()),
                    torch.from_numpy(b["scope1"]),
                    torch.from_numpy(b["valid"]) != 0, I)
                assert torch.equal(g, one)


def test_many_takes_strided_predicates():
    """A slice of a wider tensor (row stride > R, offset rows) counts
    as its contiguous copy does."""
    b = _batch(5)
    N, R = b["scope1"].shape
    rng = np.random.default_rng(5)
    wide = torch.from_numpy(rng.random((N, R + 11)) < 0.4)
    sc = kernels.scope8(torch.from_numpy(b["scope1"]),
                        torch.from_numpy(b["valid"]) != 0, 16)
    for view in (wide[:, :R], wide[:, 3:R + 3]):
        assert view.stride(0) == R + 11
        got, = kernels.instance_count_many([view], sc, 16)
        assert np.array_equal(got.numpy(), _reference(b, 16, view.numpy(),
                                                      "count"))


def test_many_refuses_bad_requests():
    sc = torch.zeros((2, 8), dtype=torch.uint8)
    p = torch.zeros((2, 8), dtype=torch.bool)
    with pytest.raises(ValueError):
        kernels.instance_count_many([p], sc, 4, "sum")
    with pytest.raises(ValueError):
        kernels.instance_count_many([p, p], sc, 4, ["count"])


def _ctxs(seed, I=16):
    b = _batch(seed, I=I)
    jctx = jev.Ctx({k: jnp.asarray(v) for k, v in b.items()}, I)
    tctx = tev.Ctx({k: torch.from_numpy(v.astype(np.int32)
                                        if v.dtype == np.uint32 else v)
                    for k, v in b.items()}, I)
    return b, jctx, tctx


def _keyed_mask(tctx, rng, h):
    """A row mask the port Ctx keys as its own ``_mask`` does."""
    N, R = tctx.N, tctx.R
    m = torch.from_numpy(rng.random((N, R)) < 0.5) & tctx._valid
    tctx._row_masks[(h, "norm")] = m
    tctx._pred_keys[id(m)] = (h, "norm")
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scopes_and_memo_equal_reference(seed):
    b, jctx, tctx = _ctxs(seed)
    rng = np.random.default_rng(seed)
    masks = [_keyed_mask(tctx, rng, h) for h in range(3)]
    items = []
    for m in masks:
        items += [(m, "any"), (tctx.typed(m, T_ARR), "any"),
                  (tctx.typed(m, T_MAP, neg=True), "count"), (m, "count")]
    for level, jscope in ((1, jev.InstScope(jctx)),
                          (2, jev.Inst2Scope(jctx))):
        scope = (tev.InstScope if level == 1 else tev.Inst2Scope)(tctx)
        first = scope.many(items)
        again = scope.many(items)  # every one a memo hit, same tensors
        for (p, w), g, g2 in zip(items, first, again):
            jp = jnp.asarray(p.numpy())
            want = jscope.any(jp) if w == "any" else jscope.count(jp)
            want = np.asarray(want)
            assert np.array_equal(g.numpy(), want.astype(g.numpy().dtype))
            assert g2 is g
        tag = "inst" if level == 1 else "inst2"
        # 12 requests (3 masks x any, typed any, typed count, count),
        # twice: the second call hits every one
        assert tctx.stats[tag + "_calls"] == 24
        assert tctx.stats[tag + "_hits"] == 12
    # level 1 issued its distinct misses in launches of up to 8
    assert tctx.stats["inst_issued"] == 2
    # an unkeyed predicate is counted, never remembered
    loose = torch.from_numpy(rng.random((tctx.N, tctx.R)) < 0.5)
    before = tctx.stats["inst_hits"]
    tev.InstScope(tctx).count(loose)
    tev.InstScope(tctx).count(loose)
    assert tctx.stats["inst_hits"] == before


def test_any_of_a_counted_mask_reuses_the_count():
    b, jctx, tctx = _ctxs(4)
    m = _keyed_mask(tctx, np.random.default_rng(4), 7)
    scope = tev.InstScope(tctx)
    scope.count(m)
    issued = tctx.stats["inst_issued"]
    got = scope.any(m)
    assert tctx.stats["inst_issued"] == issued and tctx.stats["inst_hits"] == 1
    assert np.array_equal(got.numpy(), np.asarray(
        jev.InstScope(jctx).any(jnp.asarray(m.numpy()))))


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("level", [1, 2])
def test_any_of_a_counted_mask_on_a_rule_tape(level, typed):
    """A rule recorded on its tapes, as ``build_program`` runs it: K3's
    count is recorded and launched at the rule's end, after the row
    tape's flush stores its plane (``typed``: a typed mask, a row-tape
    value carrying its memo key); the later "any" of the same mask is a
    memo hit that becomes "count != 0" on the class tape. The rule's end
    (row flush, K3, K11) gives the JAX package's count and any."""
    from kyverno_tpu_torch.tpu import fold, rowfold

    b, jctx, tctx = _ctxs(5)
    N, R, I = tctx.N, tctx.R, tctx.I
    m = _keyed_mask(tctx, np.random.default_rng(5), 7)
    tctx.fold = fold.Tape(N, I, I, "cpu", fold.FoldCache(), True, tctx.stats)
    tctx.rows = rowfold.RowTape(N, R, "cpu", rowfold.RowCache(), True,
                                tctx.fold, tctx.stats)
    tctx.fold.prerun = tctx.rows.run
    pred = tctx.typed(m, T_ARR) if typed else m
    assert isinstance(pred, rowfold.RV) == typed
    scope = (tev.InstScope if level == 1 else tev.Inst2Scope)(tctx)
    n = scope.count(pred)
    tag = "inst" if level == 1 else "inst2"
    issued = tctx.stats[tag + "_issued"]
    a = scope.any(pred)
    assert tctx.stats[tag + "_issued"] == issued == 1
    assert tctx.stats[tag + "_hits"] == 1
    # nothing ran yet: one K3 launch waits for the rule's end
    assert len(tctx.rows.after) == 1
    assert isinstance(n, fold.FV) and isinstance(a, fold.FV)
    shape = (N, I) if level == 1 else (N, I, I)
    got_n = torch.empty(shape, dtype=torch.int32)
    got_a = torch.empty(shape, dtype=torch.bool)
    tctx.fold.run([n, a], [got_n, got_a])
    assert not tctx.rows.after and not tctx.rows.pending
    jm = jnp.asarray(m.numpy())
    if typed:
        jm = jm & (jnp.asarray(b["type_tag"]) == T_ARR)
    jscope = (jev.InstScope if level == 1 else jev.Inst2Scope)(jctx)
    assert np.array_equal(got_n.numpy(), np.asarray(jscope.count(jm)))
    assert np.array_equal(got_a.numpy(), np.asarray(jscope.any(jm)))


@pytest.mark.parametrize("level", [1, 2])
def test_a_torch_op_on_a_deferred_count_forces_the_rule(level):
    """While a rule is recorded, K3's outputs are written only at its
    end, so ``Ctx.inst_counts`` hands out class-tape values: a torch
    operation on one mid-rule runs the rule's end first (row flush,
    K3), is counted in ``fold_forced`` and reads the JAX package's
    count, never unwritten memory."""
    from kyverno_tpu_torch.tpu import fold, rowfold

    b, jctx, tctx = _ctxs(6)
    N, R, I = tctx.N, tctx.R, tctx.I
    m = _keyed_mask(tctx, np.random.default_rng(6), 11)
    tctx.fold = fold.Tape(N, I, I, "cpu", fold.FoldCache(), True, tctx.stats)
    tctx.rows = rowfold.RowTape(N, R, "cpu", rowfold.RowCache(), True,
                                tctx.fold, tctx.stats)
    tctx.fold.prerun = tctx.rows.run
    pred = tctx.typed(m, T_ARR)
    (n,) = tctx.inst_counts(level, [(pred, "count")])
    assert isinstance(n, fold.FV) and len(tctx.rows.after) == 1
    forced = tctx.stats.get("fold_forced", 0)
    got = torch.add(n, 0)
    assert tctx.stats["fold_forced"] == forced + 1
    assert not tctx.rows.after and not tctx.rows.pending
    jm = jnp.asarray(m.numpy()) & (jnp.asarray(b["type_tag"]) == T_ARR)
    jscope = (jev.InstScope if level == 1 else jev.Inst2Scope)(jctx)
    assert np.array_equal(got.numpy(), np.asarray(jscope.count(jm)))


def test_typed_masks_are_kept_and_keyed():
    _, _, tctx = _ctxs(3)
    m = _keyed_mask(tctx, np.random.default_rng(3), 9)
    a = tctx.typed(m, T_ARR)
    assert tctx.typed(m, T_ARR) is a
    assert torch.equal(a, m & (tctx.b["type_tag"] == T_ARR))
    assert torch.equal(tctx.typed(m, T_ARR, neg=True),
                       m & (tctx.b["type_tag"] != T_ARR))
    loose = m.clone()  # not a keyed mask: computed, not kept
    assert tctx.typed(loose, T_ARR) is not tctx.typed(loose, T_ARR)


# the PSS program's K3 work (PERF.md, this port's dense program): 1,794
# one-level and 81 two-level requests; with the memo and the grouped
# calls at most 339 one-level and 63 two-level kernel calls
PSS_INST_CALLS, PSS_INST2_CALLS = 1794, 81
PSS_INST_ISSUED, PSS_INST2_ISSUED = 339, 63


def test_pss_program_issues_no_more_counts_than_stated():
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.policy.autogen import expand_policy
    from kyverno_tpu_torch.tpu.engine import TorchEngine

    eng = TorchEngine([expand_policy(p) for p in load_pss_policies()],
                      device="cpu")
    pods = [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}", "namespace": "d"},
             "spec": {"containers": [{
                 "name": "c", "image": "nginx",
                 "securityContext": {"privileged": i % 2 == 0}}]}}
            for i in range(4)]
    table, _ = eng.scan_device(pods)
    st = eng.cps.device_fn().stats
    assert st["inst_calls"] == PSS_INST_CALLS
    assert st["inst2_calls"] == PSS_INST2_CALLS
    assert st["inst_issued"] <= PSS_INST_ISSUED
    assert st["inst2_issued"] <= PSS_INST2_ISSUED
    assert st["nfa_unpacked"] == 0
    assert table.shape[1] == len(pods)
