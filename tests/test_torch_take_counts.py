"""K4 ``verdict_counts`` and K8 ``first_true_take``: their launch plans,
numpy models of each kernel's walk, and K8's operands on the program.

The CUDA kernels cannot run here. What they compute is held in three
ways: the host functions that pick each kernel's form
(``kernels.verdict_counts_plan``, ``kernels.first_true_take_form``) at
the main path's shapes; a numpy model of each form's walk over the
cells (which cluster block, thread and step reads which cell; which
lane of which segment finds which row), run on the plan the host picks,
against the plain twins and the JAX package's formulas; and, on the
PSS apparmor rule's program, K8's operands being the planes the rule's
row tape stores (no copy on the way). Integer and bool outputs:
tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kyverno_tpu.tpu.compiler import compile_policy_set as jcompile
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.tpu import rowfold
from kyverno_tpu_torch.tpu.engine import lanes_to_device

from torch_parity_util import port_engine
from torch_parity_util import fresh_port_state  # noqa: F401


# --- K4 ---------------------------------------------------------------

@pytest.mark.parametrize("N,aligned,want", [
    (16384, True, (8, 128, True)),   # the dense and tenant tables
    (8192, True, (1, 512, True)),    # the background step's tile
    (8196, True, (8, 96, True)),
    (5000, True, (1, 320, True)),
    (1000, True, (1, 64, True)),
    (3, True, (1, 32, False)),
    (1, True, (1, 32, False)),
    (16387, True, (8, 160, False)),  # a row start off 16 bytes
    (16384, False, (8, 128, False)),  # an unaligned table view
    (1 << 20, True, (8, 512, True)),
])
def test_verdict_counts_plan(N, aligned, want):
    assert kernels.verdict_counts_plan(N, aligned) == want


def test_verdict_counts_plan_is_one_round_of_loads():
    # a thread's share of the row fits its loads in flight; a cluster
    # only for a row one block of 512 threads cannot take so
    for N in list(range(1, 20000, 97)) + [8192, 16384]:
        C, threads, _ = kernels.verdict_counts_plan(N)
        assert threads % 32 == 0 and 32 <= threads <= 512
        assert C in (1, 2, 4, 8)
        assert C * threads * 4 * kernels.VERDICT_COUNTS_LOADS >= N
        assert C == 1 or N > 512 * 4 * kernels.VERDICT_COUNTS_LOADS


def test_verdict_counts_plan_rejects_an_empty_row():
    with pytest.raises(ValueError):
        kernels.verdict_counts_plan(0)


def _k4_cells(N, C, threads, vector):
    """The cells each (block rank, thread) of a rule's cluster reads, as
    csrc/verdict_counts.cu walks them: a list of index arrays."""
    stride = C * threads
    out = []
    for rank in range(C):
        for t in range(threads):
            first = rank * threads + t
            if vector:
                V, loads, vecs = N // 4, kernels.VERDICT_COUNTS_LOADS, []
                for i in range(first, V, loads * stride):  # loads a step
                    vecs += [j for j in range(i, i + loads * stride, stride)
                             if j < V]
                v = np.asarray(vecs, dtype=np.int64)
                cells = (4 * v[:, None] + np.arange(4)).reshape(-1)
            else:
                cells = np.arange(first, N, stride, dtype=np.int64)
            out.append((rank, cells))
    return out


def k4_model(table, aligned=True):
    """K4's counts and uint8 table as the kernel forms them: each
    thread's seven counters over its cells, summed in the warp and the
    block (one partial a block rank), then across the cluster."""
    rules, N = table.shape
    C, threads, vector = kernels.verdict_counts_plan(N, aligned)
    seen = np.zeros(N, dtype=np.int64)
    partial = np.zeros((rules, C, 7), dtype=np.int64)
    t8 = np.zeros((rules, N), dtype=np.uint8)
    for rank, cells in _k4_cells(N, C, threads, vector):
        seen[cells] += 1
        vals = table[:, cells]
        t8[:, cells] = vals.astype(np.uint8)
        for c in range(7):
            partial[:, rank, c] += (vals == c).sum(axis=1)
    assert np.all(seen == 1), "a cell read twice or never"
    return partial.sum(axis=1).astype(np.int32), t8


@pytest.mark.parametrize("rules", [1, 66])
@pytest.mark.parametrize("N", [1, 3, 1000, 5000, 8192, 16384, 16387])
def test_verdict_counts_model_equals_twin_and_reference(rules, N):
    rng = np.random.default_rng(N + rules)
    # codes 0..6 with 7 and -1 mixed in: counted in no class
    table = rng.integers(-1, 8, size=(rules, N)).astype(np.int32)
    counts, t8 = k4_model(table)
    want8, wantc = kernels.verdict_counts_u8_plain(torch.from_numpy(table))
    assert np.array_equal(counts, wantc.numpy())
    assert np.array_equal(t8, want8.numpy())
    jt = jnp.asarray(table)
    ref = np.stack([np.asarray((jt == c).sum(axis=1)) for c in range(7)], 1)
    assert np.array_equal(counts, ref)
    assert counts.sum() == ((table >= 0) & (table <= 6)).sum()


def test_verdict_counts_model_on_an_unaligned_table():
    rng = np.random.default_rng(5)
    table = rng.integers(-1, 8, size=(3, 4096)).astype(np.int32)
    counts, _ = k4_model(table, aligned=False)
    assert np.array_equal(counts, kernels.verdict_counts_plain(
        torch.from_numpy(table)).numpy())


# --- K8 ---------------------------------------------------------------

@pytest.mark.parametrize("R,aligned,want", [
    (128, True, 8),    # the background tile
    (256, True, 16),   # the dense and tenant programs
    (16, True, 1), (32, True, 2), (48, True, 4), (64, True, 4),
    (512, True, 32),
    (1, True, 0), (31, True, 0), (45, True, 0), (300, True, 0),
    (600, True, 0), (528, True, 0),
    (256, False, 0),   # an unaligned mask view
])
def test_first_true_take_form(R, aligned, want):
    assert kernels.first_true_take_form(R, aligned) == want


def test_first_true_take_form_rejects_no_rows():
    with pytest.raises(ValueError):
        kernels.first_true_take_form(0)


def _ffs(x):
    """CUDA's __ffs: 1 + the index of the lowest set bit, 0 for 0."""
    x = int(x)
    return (x & -x).bit_length()


def _first_byte(b16):
    """csrc/first_true_take.cu:first_byte on 16 bytes: four 32-bit
    words, __vcmpne4 (0xFF in each nonzero byte), __ffs."""
    words = np.frombuffer(b16.tobytes(), dtype="<u4")
    for k, w in enumerate(words):
        m = 0
        for j in range(4):
            if (int(w) >> (8 * j)) & 0xFF:
                m |= 0xFF << (8 * j)
        if m:
            return 4 * k + ((_ffs(m) - 1) >> 3)
    return -1


def k8_model(accept, pred):
    """K8 as the kernel computes it in the form the host picks: the
    segment form lane by lane (a 16-byte load, first byte, a ballot
    masked to the segment, a shuffle), or the warp walk."""
    N, R = accept.shape
    a = accept.astype(np.uint8)
    L = kernels.first_true_take_form(R)
    has = np.zeros(N, dtype=bool)
    val = np.zeros(N, dtype=bool)
    if L == 0:
        for n in range(N):
            first = -1
            for base in range(0, R, 32):
                m = sum(1 << ln for ln in range(32)
                        if base + ln < R and a[n, base + ln])
                if m:
                    first = base + _ffs(m) - 1
                    break
            has[n] = first >= 0
            val[n] = pred[n, max(first, 0)]
        return has, val
    P = 32 // L
    for w in range(-(-N // P)):
        f = [-1] * 32
        for lane in range(32):
            seg, sub = divmod(lane, L)
            n = w * P + seg
            if n < N and 16 * sub < R:
                f[lane] = _first_byte(a[n, 16 * sub:16 * sub + 16])
        ball = sum(1 << ln for ln in range(32) if f[ln] >= 0)
        for seg in range(P):
            n = w * P + seg
            if n >= N:
                continue
            mine = ball if L == 32 else (ball >> (seg * L)) & ((1 << L) - 1)
            at = _ffs(mine) - 1 if mine else 0
            fs = f[seg * L + at]
            row = 16 * at + fs if mine else 0
            has[n] = mine != 0
            val[n] = pred[n, row]
    return has, val


def _take_masks(N, R, seed):
    """Masks with rows whose only true cell is the first or the last,
    rows with none, and random rows."""
    rng = np.random.default_rng(seed)
    accept = rng.random((N, R)) < 2.0 / R
    accept[0::4] = False
    accept[1::4] = False
    accept[1::4, 0] = True
    accept[2::4] = False
    accept[2::4, R - 1] = True
    pred = rng.random((N, R)) < 0.5
    return accept, pred


@pytest.mark.parametrize("R", [1, 16, 31, 45, 48, 128, 256, 300, 512, 600])
@pytest.mark.parametrize("N", [1, 7, 100])
def test_first_true_take_model_equals_twin_and_reference(R, N):
    accept, pred = _take_masks(N, R, R * 1000 + N)
    has, val = k8_model(accept, pred)
    th, tv = kernels.first_true_take_plain(torch.from_numpy(accept),
                                           torch.from_numpy(pred))
    assert np.array_equal(has, th.numpy())
    assert np.array_equal(val, tv.numpy())
    ja, jp = jnp.asarray(accept), jnp.asarray(pred)
    idx = jnp.argmax(ja, axis=-1)
    assert np.array_equal(has, np.asarray(ja.any(axis=-1)))
    assert np.array_equal(val, np.asarray(
        jnp.take_along_axis(jp, idx[:, None], axis=-1)[:, 0]))


def test_k8_reads_the_planes_the_row_tape_stores(monkeypatch):
    """On the apparmor rule's program (K8's caller) the accept and pred
    planes K8 reads are the tensors the rule's flush writes: neither is
    copied on the way."""
    from kyverno_tpu.policies import load_pss_policies
    from kyverno_tpu.policy.autogen import expand_policy

    stored, calls = set(), []
    orig_stored = rowfold.RowTape.stored

    def spy_stored(self, xs):
        out = orig_stored(self, xs)
        stored.update(t.data_ptr() for t in out)
        return out

    def spy(fn):
        def take(accept, pred, out=None):
            calls.append((accept, pred))
            return fn(accept, pred, out=out)
        return take

    monkeypatch.setattr(rowfold.RowTape, "stored", spy_stored)
    for name in ("first_true_take", "first_true_take_plain"):
        monkeypatch.setattr(kernels, name, spy(getattr(kernels, name)))
    pols = [expand_policy(p) for p in load_pss_policies("restrict-apparmor")]
    jeng = TpuEngine(cps=jcompile(pols))
    teng = port_engine(jeng)
    key = "container.apparmor.security.beta.kubernetes.io/"
    pods = [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}", "namespace": "d",
                          "annotations": a},
             "spec": {"containers": [{"name": "c", "image": "nginx"}]}}
            for i, a in enumerate([{}, {key + "a": "unconfined"},
                                   {"z": "1", key + "b": "localhost/p"}])]
    batch = jeng.encode(pods + [{}] * 5)[0]
    teng.cps.device_fn()(lanes_to_device(batch, "cpu"))
    assert calls
    for accept, pred in calls:
        assert accept.data_ptr() in stored and pred.data_ptr() in stored
        assert accept.is_contiguous() and pred.is_contiguous()
