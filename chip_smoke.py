#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (kyverno_tpu_torch) on one GPU.

    python3 chip_smoke.py [--n 16384] [--scan-n 100000] [--tile 8192] [--seed 0]

Phases, each printed as it runs; any failure raises and exits nonzero:

1. the card (``nvidia-smi --query-gpu=name,power.limit``);
2. the kernel build (one ``nvcc`` per CUDA source, started together);
3. every kernel against its plain PyTorch twin on the card, exactly:
   K1 at strides 1, 2 and 4 on the PSS bank and on an approximated
   small-budget bank, over seeded subjects with non-ASCII bytes and
   lengths that are not multiples of the stride; K3 with scopes -1 and
   >= I and valid zeros; K4; and, on one encoded tile of the background
   scan (its vocabulary lanes and shapes), K5 over index widths uint8,
   uint16 and int32 with hostile indices, K6 with 0, 1, 5 and 40
   constants, K7 on a strided DFA accept column, K8, and K4's uint8
   output. Each is timed by CUDA-graph replay beside its plain twin and
   its library yardstick;
4. the dense path: ``TorchEngine(PSS).scan`` on N seeded resources
   (Pod / Deployment / CronJob / Service): the completed table over all
   rules (codes 0..4), its launch counts, the device table of ``run``
   against the same program with the plain twins, a small input
   against the CPU run, and the time of encode, host-to-device copy,
   program (median of 5) and readback. The stride-1 scan entry runs on
   the same path with ``KYVERNO_TPU_DFA_STRIDE=1``;
5. the background scan path: ``ShardedScanner(PSS).scan_stream`` over
   a 100,000-resource snapshot in 8,192-resource tiles (the vocabulary
   form): its coverage, stats and resources/s, its launch counts, the
   first tile against the dense ``TorchEngine``, the step against the
   plain-twin step, 257 resources against the CPU scanner, the
   steady-state step time on one resident tile (median of 5), a check
   that the step never waits for the device, and the tile's lane bytes
   against the dense form's;
6. the ``kernels`` JSON line, then the device JSON line (last line).

Every number is printed with the card's name and power limit. Without
CUDA, or without the ``kyverno_tpu_torch`` package beside this file, it
exits nonzero before printing any result. It imports nothing of JAX
and nothing of ``kyverno_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data sheet figures (the bound of each kernel)
HBM_BYTES_PER_S = 3.35e12
# no integer rate is published beside the tensor-core ones; the
# non-tensor fp32 rate (67 TFLOP/s) stands for the int32 ALU work
ALU_OPS_PER_S = 67e12

KERNEL_META = {
    "dfa_scan_fused": ("kyverno_tpu_torch/csrc/dfa_scan.cu",
                       "kyverno_tpu/tpu/dfa.py:1155"),
    "dfa_scan_stride1": ("kyverno_tpu_torch/csrc/dfa_scan.cu",
                         "kyverno_tpu/tpu/dfa.py:1128"),
    "instance_count": ("kyverno_tpu_torch/csrc/instance_count.cu",
                       "kyverno_tpu/tpu/evaluator.py:454"),
    "instance_count2": ("kyverno_tpu_torch/csrc/instance_count.cu",
                        "kyverno_tpu/tpu/evaluator.py:469"),
    "verdict_counts": ("kyverno_tpu_torch/csrc/verdict_counts.cu",
                       "kyverno_tpu/tpu/evaluator.py:1946"),
    "verdict_counts_u8": ("kyverno_tpu_torch/csrc/verdict_counts.cu",
                          "kyverno_tpu/parallel/sharding.py:100"),
    "vocab_gather": ("kyverno_tpu_torch/csrc/vocab_gather.cu",
                     "kyverno_tpu/tpu/evaluator.py:144"),
    "vocab_gather_rows": ("kyverno_tpu_torch/csrc/vocab_gather.cu",
                          "kyverno_tpu/tpu/evaluator.py:156"),
    "hash_match": ("kyverno_tpu_torch/csrc/hash_match.cu",
                   "kyverno_tpu/tpu/evaluator.py:222"),
    "pool_rows": ("kyverno_tpu_torch/csrc/pool_rows.cu",
                  "kyverno_tpu/tpu/evaluator.py:361"),
    "first_true_take": ("kyverno_tpu_torch/csrc/first_true_take.cu",
                        "kyverno_tpu/tpu/evaluator.py:641"),
}

# the kernels each path must launch
DENSE_KERNELS = ("dfa_scan_fused", "instance_count", "instance_count2",
                 "verdict_counts", "hash_match", "pool_rows",
                 "first_true_take")
SCAN_KERNELS = ("vocab_gather", "vocab_gather_rows", "hash_match",
                "pool_rows", "first_true_take", "verdict_counts_u8",
                "dfa_scan_fused", "instance_count", "instance_count2")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# seeded PSS-style workload (Pod / Deployment / CronJob / Service)


def _sec_ctx(rng, pod_level=False):
    out = {}
    if rng.random() < 0.3:
        out["privileged"] = rng.choice([True, False, "false", "true"])
    if rng.random() < 0.3:
        out["allowPrivilegeEscalation"] = rng.choice([True, False])
    if rng.random() < 0.3:
        out["runAsNonRoot"] = rng.choice([True, False])
    if rng.random() < 0.3:
        out["runAsUser"] = rng.choice([0, 1000, "0", 65535])
    if rng.random() < 0.25:
        out["seccompProfile"] = {"type": rng.choice(
            ["RuntimeDefault", "Localhost", "Unconfined", None])}
    if rng.random() < 0.2:
        out["seLinuxOptions"] = {"type": rng.choice(["container_t", "spc_t"])}
    if rng.random() < 0.2:
        out["capabilities"] = {rng.choice(["add", "drop"]): rng.sample(
            ["ALL", "CHOWN", "SYS_ADMIN", "KILL", "NET_RAW",
             "NET_BIND_SERVICE"], k=rng.randint(0, 3))}
    if not pod_level and rng.random() < 0.2:
        out["procMount"] = rng.choice(["Default", "Unmasked"])
    if not pod_level and rng.random() < 0.15:
        out["windowsOptions"] = {"hostProcess": rng.choice([True, False])}
    if pod_level and rng.random() < 0.2:
        out["sysctls"] = [{"name": rng.choice(
            ["kernel.shm_rmid_forced", "net.core.somaxconn"]), "value": "1"}]
    return out


def _container(rng, name):
    c = {"name": name, "image": rng.choice(["nginx", "docker.io/redis:7",
                                            "evil.io/x"])}
    sc = _sec_ctx(rng)
    if sc or rng.random() < 0.3:
        c["securityContext"] = sc
    if rng.random() < 0.25:
        port = {"containerPort": 80}
        if rng.random() < 0.5:
            port["hostPort"] = rng.choice([0, 8080])
        c["ports"] = [port]
    return c


def _pod_spec(rng):
    spec = {"containers": [_container(rng, f"c{i}")
                           for i in range(rng.randint(1, 3))]}
    if rng.random() < 0.3:
        spec["initContainers"] = [_container(rng, "init")]
    if rng.random() < 0.15:
        spec["ephemeralContainers"] = [_container(rng, "dbg")]
    for key in ("hostPID", "hostIPC", "hostNetwork"):
        if rng.random() < 0.2:
            spec[key] = rng.choice([True, False])
    if rng.random() < 0.35:
        kinds = ["emptyDir", "configMap", "hostPath", "secret", "nfs"]
        spec["volumes"] = [{"name": f"v{i}", (k := rng.choice(kinds)):
                            ({"path": "/"} if k == "hostPath" else {})}
                           for i in range(rng.randint(1, 3))]
    sc = _sec_ctx(rng, pod_level=True)
    if sc:
        spec["securityContext"] = sc
    return spec


def workload(n: int, seed: int):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        kind = rng.choice(["Pod"] * 4 + ["Deployment", "CronJob", "Service"])
        meta = {"name": f"r{i}",
                "namespace": rng.choice(["default", "prod", "kube-system"])}
        if rng.random() < 0.2:
            meta["annotations"] = {
                "container.apparmor.security.beta.kubernetes.io/c0":
                    rng.choice(["runtime/default", "localhost/prof",
                                "unconfined"])}
        if kind == "Pod":
            out.append({"apiVersion": "v1", "kind": "Pod", "metadata": meta,
                        "spec": _pod_spec(rng)})
        elif kind == "Deployment":
            out.append({"apiVersion": "apps/v1", "kind": "Deployment",
                        "metadata": meta,
                        "spec": {"replicas": 1, "template": {
                            "metadata": {"labels": {"app": "x"}},
                            "spec": _pod_spec(rng)}}})
        elif kind == "CronJob":
            out.append({"apiVersion": "batch/v1", "kind": "CronJob",
                        "metadata": meta,
                        "spec": {"schedule": "* * * * *", "jobTemplate": {
                            "spec": {"template": {"spec": _pod_spec(rng)}}}}})
        else:
            out.append({"apiVersion": "v1", "kind": "Service",
                        "metadata": meta, "spec": {"ports": [{"port": 80}]}})
    ops = [rng.choice(["", "CREATE", "UPDATE", "DELETE"]) for _ in out]
    return out, ops


# ---------------------------------------------------------------------------
# measurement helpers


def eager_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Mean time of one call of ``fn`` over ``reps`` back-to-back eager
    calls (CUDA events around the loop, after a warm-up). For a short
    kernel this is the host's issue rate (wrapper checks, allocation,
    the ctypes call), not the kernel."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of one call of ``fn``: ``reps`` calls captured
    in one CUDA graph, replayed once between two CUDA events, so no
    host work falls inside the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def timed(torch, kfn, pfn, lib=None, plain_reps: int = 3):
    """The kernel's device time (graph replay) and its eager issue
    time, the plain version's and the library call's device time."""
    return {"ms": graph_ms(torch, kfn), "eager_ms": eager_ms(torch, kfn),
            "plain_ms": graph_ms(torch, pfn, reps=plain_reps, warm=1),
            "library_ms": None if lib is None else graph_ms(torch, lib)}


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def exact(torch, name: str, got, want) -> float:
    """Max |kernel - plain| over int/bool outputs (float outputs as
    their bit patterns); raises unless 0."""
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel {tuple(got.shape)} {got.dtype}"
                             f" vs plain {tuple(want.shape)} {want.dtype}")
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0.0
    if err != 0.0:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {err})")
    return err


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain twin


def check_dfa(torch, kernels, dfa_mod, pool, pool_len, seed, results):
    """K1 at strides 1, 2, 4 on the PSS patterns (over the main path's
    pool lanes) and on an approximated bank (over seeded subjects)."""
    dev = pool.device
    W = pool.shape[-1]
    subj = pool.reshape(-1, W).contiguous()
    slen = pool_len.reshape(-1).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rb = torch.randint(0, 256, tuple(subj.shape), generator=gen,
                       dtype=torch.uint8).to(dev)
    # lengths 0 .. W + 7: not multiples of any stride, some past W
    rl = torch.randint(0, W + 8, (subj.shape[0],), generator=gen,
                       dtype=torch.int32).to(dev)
    pss_patterns = [("glob", "localhost/*"),
                    ("glob", "container.apparmor.security.beta.kubernetes.io/*")]
    approx_patterns = [("re2", "^(ab|cd){1,10}x[0-9]{3}$"),
                       ("re2", "^v[0-9]{1,4}\\.[0-9]{1,4}\\.[0-9]{1,4}$"),
                       ("glob", "*-suffix-*-mid-*-tail"),
                       ("glob", "prefix-????-*-????-end"),
                       ("glob", "nginx-?"), ("re2", "[a-c]+é")]
    old = os.environ.get("KYVERNO_TPU_DFA_STATE_BUDGET")
    for label, patterns, budget, (b, ln) in (
            ("pss", pss_patterns, None, (subj, slen)),
            ("approx", approx_patterns, "12", (rb, rl))):
        for stride in (4, 2, 1):
            if budget is not None:
                os.environ["KYVERNO_TPU_DFA_STATE_BUDGET"] = budget
            bank = dfa_mod.DfaBank()
            for kind, pat in patterns:
                (bank.add_glob if kind == "glob" else bank.add_re2)(pat, "pool")
            bank.finalize(stride=stride)
            if budget is not None:
                if old is None:
                    os.environ.pop("KYVERNO_TPU_DFA_STATE_BUDGET")
                else:
                    os.environ["KYVERNO_TPU_DFA_STATE_BUDGET"] = old
                if not bank.stats()["approx"]:
                    raise AssertionError("approximated bank has no "
                                         "approximated pattern")
            tabs = dfa_mod.device_tables(bank, dev)
            ids = [i for i in bank.families["pool"]
                   if int(bank.strides[i]) == stride]
            if not ids:
                raise AssertionError(f"{label} bank: no pattern at stride {stride}")
            idx = torch.as_tensor(ids, dtype=torch.int64, device=dev)
            if stride == 1:
                args = (b, ln, tabs["trans"], int(bank.trans.shape[1]),
                        tabs["class_map"][idx].contiguous(),
                        tabs["start"][idx].contiguous(), tabs["accept"])
                kfn, pfn, name = (kernels.dfa_scan_stride1,
                                  kernels.dfa_scan_stride1_plain,
                                  "dfa_scan_stride1")
            else:
                args = (b, ln, tabs["fused_trans"], tabs["fused_pairs"],
                        tabs["fused_start"][idx].contiguous(),
                        tabs["fused_accept"], int(bank.fused_pitch),
                        2 if stride == 4 else 1)
                kfn, pfn, name = (kernels.dfa_scan_fused,
                                  kernels.dfa_scan_fused_plain,
                                  "dfa_scan_fused")
            got, na = kfn(*args, want_nonascii=True)
            want = pfn(*args)
            err = exact(torch, f"{name} {label} stride {stride}", got, want)
            err = max(err, exact(torch, f"nonascii {label} stride {stride}",
                                 na, kernels.nonascii_plain(b, ln)))
            say("3", f"K1 {name} {label} bank stride {stride}: "
                     f"{tuple(got.shape)} accepts, {int(got.sum())} hits, "
                     f"{int(na.sum())} non-ASCII subjects, max abs err {err}")
            # time each entry at the main path's own configuration: the
            # compiled PSS bank (stride 4) and its stride-1 build
            if label == "pss" and stride in (4, 1):
                # the least work this run's data needs: the scan stops
                # after ceil(min(len, W) / 2) pairs (stride 4) or
                # min(len, W) bytes (stride 1), and bytes past that
                # cannot change the result, so only live bytes count
                S = b.shape[0]
                K = len(ids)
                live = torch.clamp(ln, 0, W).to(torch.int64)
                if stride == 4:
                    steps = int(((live + 1) // 2).sum())
                    live_bytes = 2 * steps
                    table_bytes = (tabs["fused_trans"].numel() * 4 + 4096
                                   + tabs["fused_accept"].numel())
                else:
                    steps = int(live.sum())
                    live_bytes = steps
                    table_bytes = (tabs["trans"].numel() * 4 + K * 256
                                   + tabs["accept"].numel())
                nbytes = S * 4 + S * K + live_bytes + table_bytes + K * 4
                results[name] = {
                    "max_abs_err": err,
                    **timed(torch, lambda: kfn(*args), lambda: pfn(*args)),
                    "bound": bound(nbytes, steps * K * 4),
                }
                say("3", f"K1 {name} bound inputs: {S} subjects, "
                         f"{live_bytes} live bytes, {steps * K} steps, "
                         f"{table_bytes} table bytes")


def check_instance_count(torch, kernels, lanes, n_inst, seed, results):
    dev = lanes["scope1"].device
    N, R = lanes["scope1"].shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    pred = (torch.rand((N, R), generator=gen) < 0.5).to(dev)
    hz1 = torch.randint(-1, n_inst + 3, (N, R), generator=gen,
                        dtype=torch.int32).to(dev)
    hz2 = torch.randint(-1, n_inst + 3, (N, R), generator=gen,
                        dtype=torch.int32).to(dev)
    hzv = (torch.rand((N, R), generator=gen) < 0.8).to(dev)
    valid = lanes["valid"] != 0
    s1, s2 = lanes["scope1"], lanes["scope2"]
    errs = {"instance_count": 0.0, "instance_count2": 0.0}
    for label, (a, b, v) in (("main-path lanes", (s1, s2, valid)),
                             ("hazard scopes", (hz1, hz2, hzv))):
        g1 = kernels.instance_count(pred, a, v, n_inst)
        w1 = kernels.instance_count_plain(pred, a, v, n_inst)
        e1 = exact(torch, f"instance_count {label}", g1, w1)
        g2 = kernels.instance_count2(pred, a, b, v, n_inst)
        w2 = kernels.instance_count_plain(pred, a, v, n_inst, b)
        e2 = exact(torch, f"instance_count2 {label}", g2, w2)
        errs["instance_count"] = max(errs["instance_count"], e1)
        errs["instance_count2"] = max(errs["instance_count2"], e2)
        say("3", f"K3 instance_count {label}: {tuple(g1.shape)} sum "
                 f"{int(g1.sum())}, two-level {tuple(g2.shape)} sum "
                 f"{int(g2.sum())}, max abs err {max(e1, e2)}")
    # the one PyTorch call computing the same counts: scatter_add_ over a
    # precomputed flat cell index (the index and weights are prepared
    # outside the timed call)
    live = pred & valid
    ok1 = live & (s1 >= 0) & (s1 < n_inst)
    ok2 = ok1 & (s2 >= 0) & (s2 < n_inst)
    rows = torch.arange(N, device=dev)[:, None]
    idx1 = (rows * n_inst + s1.clamp(0, n_inst - 1)).reshape(-1)
    idx2 = (rows * n_inst * n_inst + s1.clamp(0, n_inst - 1) * n_inst
            + s2.clamp(0, n_inst - 1)).reshape(-1)
    w1 = ok1.to(torch.int32).reshape(-1)
    w2 = ok2.to(torch.int32).reshape(-1)
    out1 = torch.zeros(N * n_inst, dtype=torch.int32, device=dev)
    out2 = torch.zeros(N * n_inst * n_inst, dtype=torch.int32, device=dev)
    out1.zero_().scatter_add_(0, idx1, w1)
    if not torch.equal(out1.view(N, n_inst),
                       kernels.instance_count(pred, s1, valid, n_inst)):
        raise AssertionError("scatter_add_ yardstick disagrees with K3")
    for name, times, nbytes, cells in (
            ("instance_count", timed(
                torch,
                lambda: kernels.instance_count(pred, s1, valid, n_inst),
                lambda: kernels.instance_count_plain(pred, s1, valid, n_inst),
                lambda: out1.zero_().scatter_add_(0, idx1, w1)),
             N * R * 6, n_inst),
            ("instance_count2", timed(
                torch,
                lambda: kernels.instance_count2(pred, s1, s2, valid, n_inst),
                lambda: kernels.instance_count_plain(pred, s1, valid, n_inst,
                                                     s2),
                lambda: out2.zero_().scatter_add_(0, idx2, w2)),
             N * R * 10, n_inst * n_inst)):
        results[name] = {"max_abs_err": errs[name], **times,
                         "bound": bound(nbytes + N * cells * 4, N * R * 4)}


def check_verdict_counts(torch, kernels, dev, rules, N, seed, results):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    table = torch.randint(0, 7, (rules, N), generator=gen,
                          dtype=torch.int32).to(dev)
    got = kernels.verdict_counts(table)
    want = kernels.verdict_counts_plain(table)
    err = exact(torch, "verdict_counts", got, want)
    if int(got.sum()) != rules * N:
        raise AssertionError("verdict_counts: counts do not cover the table")
    say("3", f"K4 verdict_counts: {tuple(got.shape)}, max abs err {err}")
    ar = torch.arange(7, device=dev, dtype=torch.int32)
    results["verdict_counts"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.verdict_counts(table),
                lambda: kernels.verdict_counts_plain(table),
                lambda: (table[..., None] == ar).sum(1), plain_reps=20),
        "bound": bound(rules * N * 4 + rules * 7 * 4, rules * N * 7),
    }


def uint16_index(rng, shape, V: int):
    """A uint16 index table with about a fifth of its values at or past
    ``V`` (filled, as jnp.take does), as a CPU torch.uint16 tensor
    (made through int16 bits: torch orders no uint16)."""
    import numpy as np
    import torch

    top = min(1 << 16, V + V // 4 + 8)
    bits = rng.integers(0, top, size=shape, dtype=np.uint16).view(np.int16)
    return torch.from_numpy(bits).view(torch.uint16)


def check_vocab_kernels(torch, kernels, dfa_mod, scanner, lanes, seed,
                        results):
    """K5 (both entries), K6, K7, K8 and K4's uint8 output against their
    plain twins on one encoded tile of the background scan: its
    vocabulary lanes, index tables and shapes."""
    import numpy as np

    from kyverno_tpu_torch.tpu.flatten import _ROW_LANE_DTYPES

    dev = lanes["row_idx"].device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rng = np.random.default_rng(seed)

    # K5, the lane gather: every vocabulary lane of the tile, one launch
    idx = lanes["row_idx"]
    names = [k[len("vocab_"):] for k in lanes if k.startswith("vocab_")]
    srcs = [lanes["vocab_" + n] for n in names]
    fills = [kernels.TAKE_FILL[np.dtype(_ROW_LANE_DTYPES[n])] for n in names]
    V = srcs[0].shape[0]
    idx8 = torch.randint(0, 256, tuple(idx.shape), generator=gen,
                         dtype=torch.uint8).to(dev)
    # hostile: wrapping negatives, and indices outside [-V, V)
    idx32 = torch.randint(-V - 64, V + 64, tuple(idx.shape), generator=gen,
                          dtype=torch.int32).to(dev)
    idx16 = uint16_index(rng, tuple(idx.shape), V).to(dev)
    err = 0.0
    widths = set()
    for label, ix in ((f"tile row_idx {idx.dtype}", idx), ("uint8", idx8),
                      ("hostile uint16", idx16), ("hostile int32", idx32)):
        widths.add(ix.element_size())
        got = kernels.vocab_gather(srcs, ix, fills)
        for n, src, f, g in zip(names, srcs, fills, got):
            err = max(err, exact(torch, f"vocab_gather {n} {label}", g,
                                 kernels.vocab_gather_plain(src, ix, f)))
        say("3", f"K5 vocab_gather {len(names)} lanes by {label} "
                 f"{tuple(ix.shape)} (V={V}): max abs err {err}")
    if widths != {1, 2, 4}:
        raise AssertionError(f"vocab_gather index widths {sorted(widths)}")
    flat = kernels._index_plain(idx).reshape(-1)
    lib = [torch.index_select(src, 0, flat).view(tuple(idx.shape))
           for src in srcs]
    for g, want in zip(kernels.vocab_gather(srcs, idx, fills), lib):
        exact(torch, "vocab_gather vs index_select", g, want)
    out_bytes = sum(idx.numel() * src.element_size() for src in srcs)
    results["vocab_gather"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.vocab_gather(srcs, idx, fills),
                lambda: [kernels.vocab_gather_plain(src, idx, f)
                         for src, f in zip(srcs, fills)],
                lambda: [torch.index_select(src, 0, flat) for src in srcs]),
        "bound": bound(idx.numel() * idx.element_size()
                       + sum(src.numel() * src.element_size() for src in srcs)
                       + out_bytes, 0),
    }
    say("3", f"K5 vocab_gather bound inputs: {idx.numel()} cells, "
             f"{out_bytes} bytes written")

    # K5, the pool rows and their lengths
    sidx, svocab, slen = lanes["pool_sidx"], lanes["pool_svocab"], \
        lanes["pool_slen"]
    Sv = svocab.shape[0]
    sidx32 = torch.randint(-Sv - 8, Sv + 8, tuple(sidx.shape), generator=gen,
                           dtype=torch.int32).to(dev)
    sidx8 = torch.randint(0, 256, tuple(sidx.shape), generator=gen,
                          dtype=torch.uint8).to(dev)
    sidx16 = uint16_index(rng, tuple(sidx.shape), Sv).to(dev)
    err = 0.0
    widths = set()
    for label, ix in ((f"tile pool_sidx {sidx.dtype}", sidx),
                      ("uint8", sidx8), ("hostile uint16", sidx16),
                      ("hostile int32", sidx32)):
        widths.add(ix.element_size())
        rows, lens = kernels.vocab_gather_rows(svocab, slen, ix)
        wrows, wlens = kernels.vocab_gather_rows_plain(svocab, slen, ix)
        err = max(err, exact(torch, f"vocab_gather_rows {label}", rows, wrows),
                  exact(torch, f"vocab_gather_rows len {label}", lens, wlens))
        say("3", f"K5 vocab_gather_rows by {label} {tuple(ix.shape)} "
                 f"(Sv={Sv}, W={svocab.shape[1]}): max abs err {err}")
    if widths != {1, 2, 4}:
        raise AssertionError(f"vocab_gather_rows index widths {sorted(widths)}")
    sflat = kernels._index_plain(sidx).reshape(-1)
    results["vocab_gather_rows"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.vocab_gather_rows(svocab, slen, sidx),
                lambda: kernels.vocab_gather_rows_plain(svocab, slen, sidx),
                lambda: (torch.index_select(svocab, 0, sflat),
                         torch.index_select(slen, 0, sflat))),
        "bound": bound(sidx.numel() * sidx.element_size() + svocab.numel()
                       + slen.numel() * 4
                       + sidx.numel() * (svocab.shape[1] + 4), 0),
    }

    # the tile's dense lanes, as the step gathers them
    view = {n: g for n, g in zip(names, kernels.vocab_gather(srcs, idx,
                                                             fills))}
    pool, pool_len = kernels.vocab_gather_rows(svocab, slen, sidx)
    valid = view["valid"] != 0
    N, R = idx.shape

    # K6 on the path's norm lanes: one constant AND valid (_mask), and
    # sets of 0, 5 and 40 constants
    hi, lo = view["norm_hi"], view["norm_lo"]
    # constants drawn from valid rows (so the masks have hits)
    live = torch.nonzero(valid.reshape(-1)).reshape(-1)
    pick = live[torch.randint(0, live.numel(), (40,), generator=gen).to(dev)]
    pairs = torch.stack([hi.reshape(-1), lo.reshape(-1)], 1)[pick].cpu().tolist()
    pairs = [tuple(p) for p in pairs]
    err = 0.0
    for k, v in ((1, valid), (0, None), (1, None), (5, valid), (40, None)):
        consts = kernels.hash_consts(pairs[:k], dev)
        got = kernels.hash_match(hi, lo, consts, v)
        err = max(err, exact(torch, f"hash_match k={k}", got,
                             kernels.hash_match_plain(hi, lo, consts, v)))
        say("3", f"K6 hash_match {tuple(hi.shape)} k={k} "
                 f"valid={'yes' if v is not None else 'no'}: "
                 f"{int(got.sum())} hits, max abs err {err}")
    one = kernels.hash_consts(pairs[:1], dev)
    results["hash_match"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.hash_match(hi, lo, one, valid),
                lambda: kernels.hash_match_plain(hi, lo, one, valid)),
        "bound": bound(N * R * (4 + 4 + 1 + 1), N * R * 3),
    }

    # K7: a pool-slot accept column of the PSS bank (a strided view)
    bank = scanner.cps.dfa
    ids = bank.families["pool"]
    acc = dfa_mod.bank_match(bank, ids, pool, pool_len)  # (N, K, patterns)
    plane = acc[..., 0]
    err = 0.0
    for lane in ("byte_slot", "key_byte_slot"):
        slot = view[lane]
        got = kernels.pool_rows(plane, slot)
        err = max(err, exact(torch, f"pool_rows {lane}", got,
                             kernels.pool_rows_plain(plane, slot)))
        say("3", f"K7 pool_rows plane {tuple(plane.shape)} strides "
                 f"{plane.stride()} by {lane} {tuple(slot.shape)}: "
                 f"{int(got.sum())} rows, max abs err {err}")
    slot = view["byte_slot"]
    safe = torch.clamp(slot, 0, plane.shape[1] - 1).to(torch.int64)
    pc = plane.contiguous()
    results["pool_rows"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.pool_rows(plane, slot),
                lambda: kernels.pool_rows_plain(plane, slot),
                lambda: torch.gather(pc, 1, safe)),
        "bound": bound(N * R * 5 + plane.shape[0] * plane.shape[1], N * R * 3),
    }

    # K8 over the masks its caller builds on this tile: rows whose map
    # KEY matches the PSS bank's apparmor glob (the wildcard anchor of
    # restrict-apparmor-profiles), most resources having none
    col = ids.index(bank.glob_ids[
        "container.apparmor.security.beta.kubernetes.io/*"])
    accept = kernels.pool_rows(acc[..., col], view["key_byte_slot"])
    pred = view["type_tag"] == 4  # string rows
    has, val_ok = kernels.first_true_take(accept, pred)
    whas, wval = kernels.first_true_take_plain(accept, pred)
    err = max(exact(torch, "first_true_take has", has, whas),
              exact(torch, "first_true_take val_ok", val_ok, wval))
    say("3", f"K8 first_true_take {tuple(accept.shape)}: {int(has.sum())} "
             f"resources with a true row, max abs err {err}")
    # the bytes this tile's masks need: accept up to each resource's
    # first true row (all R rows when none), one 32-byte sector of pred
    # at that row, and the two output bytes
    first = accept.to(torch.uint8).argmax(dim=-1).to(torch.int64)
    accept_bytes = int(torch.where(has, first + 1,
                                   torch.full_like(first, R)).sum())
    results["first_true_take"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.first_true_take(accept, pred),
                lambda: kernels.first_true_take_plain(accept, pred)),
        "bound": bound(accept_bytes + N * 32 + N * 2, accept_bytes),
    }
    say("3", f"K8 bound inputs: {accept_bytes} accept bytes to the first "
             f"true rows of {N} resources ({N * R} cells)")

    # K4's uint8 output on a (rules, tile) table
    rules = len(scanner.cps.device_programs)
    table = torch.randint(0, 7, (rules, N), generator=gen,
                          dtype=torch.int32).to(dev)
    t8, c = kernels.verdict_counts_u8(table)
    w8, wc = kernels.verdict_counts_u8_plain(table)
    err = max(exact(torch, "verdict_counts_u8 table", t8, w8),
              exact(torch, "verdict_counts_u8 counts", c, wc))
    say("3", f"K4 verdict_counts_u8 {tuple(table.shape)}: max abs err {err}")
    results["verdict_counts_u8"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.verdict_counts_u8(table),
                lambda: kernels.verdict_counts_u8_plain(table),
                plain_reps=20),
        "bound": bound(rules * N * 5 + rules * 7 * 4, rules * N * 7),
    }


# ---------------------------------------------------------------------------


def dense_phase(torch, kernels, eng, policies, resources, ops, padded, pops,
                n, tag):
    """Phase 4: the dense TorchEngine path. Returns its launch counts."""
    from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = eng.scan(resources, operations=ops)
    scan_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    say("4", f"TorchEngine.scan N={n}: table {res.verdicts.shape}, "
             f"{scan_s:.3f} s end to end {tag}; launches {launches}")
    for name in DENSE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"dense path never launched {name}")
    if res.verdicts.shape != (len(eng.cps.rules), n):
        raise AssertionError(f"table shape {res.verdicts.shape}")
    if not ((res.verdicts >= 0) & (res.verdicts <= 4)).all():
        raise AssertionError("completed table holds codes outside 0..4")
    say("4", "completed table covers every rule, codes 0..4 only: "
             + json.dumps(res.counts()))

    small = 257
    cpu_eng = TorchEngine(cps=eng.cps, device="cpu")
    cpu = cpu_eng.scan_device(resources[:small], operations=ops[:small])
    gpu = eng.scan_device(resources[:small], operations=ops[:small])
    if not ((cpu[0] == gpu[0]).all() and (cpu[1] == gpu[1]).all()):
        raise AssertionError("card device table differs from the CPU run on "
                             f"{small} resources")
    cfull = cpu_eng.scan(resources[:small], operations=ops[:small])
    gfull = eng.scan(resources[:small], operations=ops[:small])
    if not (cfull.verdicts == gfull.verdicts).all():
        raise AssertionError("card scan differs from the CPU scan on "
                             f"{small} resources")
    probe = [{"apiVersion": "v1", "kind": "Pod",
              "metadata": {"name": "priv", "namespace": "d"},
              "spec": {"containers": [{"name": "c", "image": "nginx",
                                       "securityContext": {"privileged": True}}]}},
             {"apiVersion": "v1", "kind": "Pod",
              "metadata": {"name": "ok", "namespace": "d"},
              "spec": {"containers": [{"name": "c", "image": "nginx"}]}}]
    pr = eng.scan(probe)
    row = pr.rules.index(("disallow-privileged-containers",
                          "privileged-containers"))
    if pr.verdicts[row].tolist() != [2, 0]:
        raise AssertionError(f"privileged probe: {pr.verdicts[row].tolist()}")
    say("4", f"small input ({small}) equals the CPU run (device table and "
             "completed table); privileged probe FAIL / plain probe PASS")

    t0 = time.perf_counter()
    batch = eng.encode(padded, None, pops)[0]
    encode_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lanes = lanes_to_device(batch, eng.device)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    lane_bytes = sum(v.nbytes for v in batch.values())
    prog = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table, counts = eng.run(lanes)
        torch.cuda.synchronize()
        prog.append((time.perf_counter() - t0) * 1e3)
    program_ms = statistics.median(prog)
    peak = torch.cuda.max_memory_allocated()
    # the same program with the kernels' plain twins, on the same lanes
    ptable, pcounts = eng.cps.device_fn(plain=True)(lanes)
    if not (torch.equal(ptable, table) and torch.equal(pcounts, counts)):
        raise AssertionError("kernel program differs from the plain-twin "
                             "program")
    del ptable, pcounts
    say("4", "device table and counts of run() equal the plain-twin "
             "program on the card")
    t0 = time.perf_counter()
    dtab = table.cpu().numpy()
    counts.cpu().numpy()
    readback_ms = (time.perf_counter() - t0) * 1e3
    # the completed table keeps every device verdict the host did not
    # have to complete
    for ri, e in enumerate(eng.cps.rules):
        if e.device_row is None:
            continue
        d = dtab[e.device_row, :n]
        keep = d < 5
        if not (res.verdicts[ri][keep] == d[keep]).all():
            raise AssertionError(f"completed row {e.rule_name} differs from "
                                 "the device table on device-decided cells")
    host_cells = int((dtab[:, :n] >= 5).sum())
    say("4", f"completed table equals the device table on its {dtab[:, :n].size - host_cells} "
             f"device-decided cells; {host_cells} HOST/CONFIRM cells completed "
             "on the host")
    cells = len(eng.cps.device_programs) * n
    say("4", f"encode {encode_s:.4f} s (host, {len(padded)} padded "
             f"resources, {lane_bytes} lane bytes) {tag}")
    say("4", f"H2D {h2d_ms:.3f} ms (pack into pinned memory + one copy) {tag}")
    say("4", f"program {program_ms:.3f} ms median of 5 "
             f"({', '.join(f'{x:.3f}' for x in prog)}) {tag}")
    say("4", f"readback {readback_ms:.3f} ms {tag}")
    say("4", f"{cells / (program_ms / 1e3):.0f} rule x resource evals/s "
             f"on the program, {cells / scan_s:.0f} end to end {tag}")
    say("4", f"peak device memory of the lanes and the program {peak} "
             f"bytes {tag}")
    del lanes, table, counts

    # the stride-1 scan entry on the same path: the PSS bank compiled
    # with KYVERNO_TPU_DFA_STRIDE=1, counted on its own
    old = os.environ.get("KYVERNO_TPU_DFA_STRIDE")
    os.environ["KYVERNO_TPU_DFA_STRIDE"] = "1"
    eng1 = TorchEngine(policies)
    if old is None:
        os.environ.pop("KYVERNO_TPU_DFA_STRIDE")
    else:
        os.environ["KYVERNO_TPU_DFA_STRIDE"] = old
    kernels.reset_launches()
    res1 = eng1.scan(resources, operations=ops)
    launches1 = dict(kernels.LAUNCHES)
    say("4", f"TorchEngine.scan with KYVERNO_TPU_DFA_STRIDE=1: launches "
             f"{launches1}")
    if launches1["dfa_scan_stride1"] <= 0:
        raise AssertionError("stride-1 path never launched dfa_scan_stride1")
    if not (res1.verdicts == res.verdicts).all():
        raise AssertionError("stride-1 scan differs from the stride-4 scan")
    say("4", "stride-1 completed table equals the stride-4 scan")
    launches["dfa_scan_stride1"] = launches1["dfa_scan_stride1"]
    return launches


def scan_phase(torch, kernels, scanner, policies, scan_n, tile, seed, tag):
    """Phase 5: the background scan (ShardedScanner.scan_stream over the
    vocabulary form). Returns its launch counts."""
    import warnings

    import numpy as np

    from kyverno_tpu_torch import native
    from kyverno_tpu_torch.parallel.sharding import ShardedScanner
    from kyverno_tpu_torch.tpu.engine import TorchEngine
    from kyverno_tpu_torch.tpu.evaluator import build_program

    say("5", "host encoder: " + ("native (fastencode.c)"
                                 if native.load() is not None
                                 else "Python walk (native build unavailable)"))
    t0 = time.perf_counter()
    resources, ops = workload(scan_n, seed)
    say("5", f"snapshot of {scan_n} resources generated in "
             f"{time.perf_counter() - t0:.3f} s (host)")

    kernels.reset_launches()
    t0 = time.perf_counter()
    res, stats = scanner.scan_stream(resources, tile=tile, operations=ops)
    scan_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    say("5", f"ShardedScanner.scan_stream {scan_n} resources, tile {tile}: "
             f"{scan_s:.3f} s end to end, {scan_n / scan_s:.1f} resources/s, "
             f"{len(scanner.cps.rules) * scan_n / scan_s:.0f} rule x "
             f"resource evals/s {tag}")
    say("5", "stats " + json.dumps(stats) + f" {tag}")
    say("5", f"launches {launches}")
    for name in SCAN_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"background scan never launched {name}")
    if res.verdicts.shape != (len(scanner.cps.rules), scan_n):
        raise AssertionError(f"scan table {res.verdicts.shape}: not every "
                             "rule x resource")
    if res.rules != [(e.policy_name, e.rule_name) for e in scanner.cps.rules]:
        raise AssertionError("scan rules differ from the compiled rules")
    if not ((res.verdicts >= 0) & (res.verdicts <= 4)).all():
        raise AssertionError("scan table holds codes outside 0..4")
    if stats["tiles"] != -(-scan_n // tile):
        raise AssertionError(f"{stats['tiles']} tiles for {scan_n} resources")
    say("5", "table covers every rule and resource, codes 0..4 only: "
             + json.dumps(res.counts()))

    # the first tile against the dense engine
    first, fops = resources[:tile], ops[:tile]
    dense = TorchEngine(cps=scanner.cps)
    sv, _ = scanner.scan_device(first, operations=fops)
    dv, _ = dense.scan_device(first, operations=fops)
    if sv.dtype != np.uint8 or not (sv.astype(np.int32) == dv).all():
        raise AssertionError("first tile: scan_device table differs from the "
                             "dense TorchEngine device table")
    dfull = dense.scan(first, operations=fops)
    if not (res.verdicts[:, :len(first)] == dfull.verdicts).all():
        raise AssertionError("first tile: scan_stream columns differ from "
                             "TorchEngine.scan")
    say("5", f"first tile ({len(first)}): scan_device table equals the dense "
             "device table; scan_stream columns equal TorchEngine.scan")

    # the step against the plain-twin step on the same vocabulary lanes
    pad = tile - len(first)
    host, _ = scanner.encode(list(first) + [{}] * pad, None,
                             list(fops) + [""] * pad)
    t0 = time.perf_counter()
    lanes = scanner.put(host)
    torch.cuda.synchronize()
    put_ms = (time.perf_counter() - t0) * 1e3
    v, c = scanner.step_jitted()(lanes)
    plain = build_program(scanner.cps.device_programs,
                          scanner.cps.encode_cfg.max_instances,
                          dfa=scanner.cps.dfa, plain=True, verdicts_u8=True)
    pv, pc = plain(lanes)
    if not (torch.equal(v, pv) and torch.equal(c, pc)):
        raise AssertionError("step differs from the plain-twin step")
    say("5", "step (uint8 table and counts) equals the plain-twin step on "
             "the same vocabulary lanes")

    # the step never waits for the device
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            scanner.step_jitted()(lanes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()]
    if syncs:
        raise AssertionError(f"the step synchronizes the host {len(syncs)} "
                             f"times: {syncs[:3]}")
    say("5", "the step issued no synchronizing operation "
             "(torch.cuda.set_sync_debug_mode)")

    # 257 resources: the CPU scanner against the card's
    small = 257
    cpu = ShardedScanner(policies, device="cpu")
    a = cpu.scan(resources[:small], operations=ops[:small])
    b = scanner.scan(resources[:small], operations=ops[:small])
    if not (a.verdicts == b.verdicts).all() or a.rules != b.rules:
        raise AssertionError(f"card scan differs from the CPU scan on {small}")
    say("5", f"ShardedScanner(device='cpu').scan of {small} resources equals "
             "the card's")

    # steady-state step on one resident tile (bench.py's measure)
    step = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scanner.step_jitted()(lanes)
        torch.cuda.synchronize()
        step.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(step)
    cells = len(scanner.cps.device_programs) * tile
    say("5", f"steady-state step {step_ms:.3f} ms median of 5 "
             f"({', '.join(f'{x:.3f}' for x in step)}) on one resident "
             f"{tile}-resource tile: {cells / (step_ms / 1e3):.0f} rule x "
             f"resource evals/s {tag}")
    vocab_bytes = sum(a.nbytes for a in host.values())
    dpad, dops, _ = dense.pad(first, fops)
    dense_host = dense.encode(dpad, None, dops)[0]
    dense_bytes = sum(a.nbytes for a in dense_host.values())
    say("5", f"lane bytes per {tile}-resource tile: vocabulary form "
             f"{vocab_bytes}, dense form {dense_bytes} "
             f"({dense_bytes / vocab_bytes:.1f}x); put (pack + one copy) "
             f"{put_ms:.3f} ms {tag}")
    say("5", f"row_idx {host['row_idx'].dtype} {host['row_idx'].shape}, "
             f"pool_sidx {host['pool_sidx'].dtype} {host['pool_sidx'].shape}, "
             f"{len([k for k in host if k.startswith('vocab_')])} vocabulary "
             f"lanes of {host['vocab_valid'].shape[0]} rows")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--n", type=int, default=16384,
                    help="resources in the dense-path scan")
    ap.add_argument("--scan-n", type=int, default=100000,
                    help="resources in the background scan's snapshot")
    ap.add_argument("--tile", type=int, default=8192,
                    help="resources per background-scan tile")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from kyverno_tpu_torch import kernels
        from kyverno_tpu_torch.parallel.sharding import ShardedScanner
        from kyverno_tpu_torch.policies import load_pss_policies
        from kyverno_tpu_torch.policy.autogen import expand_policy
        from kyverno_tpu_torch.tpu import dfa as dfa_mod
        from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device
    except ImportError as e:
        print(f"chip_smoke: the kyverno_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 3

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    say("1", f"torch {torch.__version__} cuda {torch.version.cuda}, "
             f"device 0 {torch.cuda.get_device_name(0)}, "
             f"{torch.cuda.device_count()} visible")
    tag = f"({card})"

    # phase 2: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    libs = kernels.build_all()
    say("2", f"built {len(libs)} kernel libraries in "
             f"{time.perf_counter() - t0:.3f} s {tag}: "
             + ", ".join(os.path.basename(p) for p in libs.values()))
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                say("2", f"{name}.cu ptxas: {line.strip()}")

    # the workloads and their encoded lanes (kernel shapes of both paths)
    policies = [expand_policy(p) for p in load_pss_policies()]
    t0 = time.perf_counter()
    eng = TorchEngine(policies)
    scanner = ShardedScanner(policies)
    say("4", f"compiled {len(policies)} PSS policies twice (engine, "
             f"scanner): coverage {eng.coverage()} in "
             f"{time.perf_counter() - t0:.3f} s {tag}")
    resources, ops = workload(args.n, args.seed)
    padded, pops, _ = eng.pad(resources, ops)
    batch = eng.encode(padded, None, pops)[0]
    lanes = lanes_to_device(batch, eng.device)
    tile_res, tile_ops = workload(args.tile, args.seed + 4)
    tile_host, _ = scanner.encode(tile_res, None, tile_ops)
    tile_lanes = scanner.put(tile_host)
    torch.cuda.synchronize()

    # phase 3: every kernel against its plain twin on the card
    results = {}
    check_dfa(torch, kernels, dfa_mod, lanes["pool"], lanes["pool_len"],
              args.seed + 1, results)
    check_instance_count(torch, kernels, lanes, eng.cps.encode_cfg.max_instances,
                         args.seed + 2, results)
    check_verdict_counts(torch, kernels, eng.device, len(eng.cps.device_programs),
                         len(padded), args.seed + 3, results)
    check_vocab_kernels(torch, kernels, dfa_mod, scanner, tile_lanes,
                        args.seed + 5, results)
    del lanes, tile_lanes

    # phase 4: the dense path through the user's entry point
    dense = dense_phase(torch, kernels, eng, policies, resources, ops, padded,
                        pops, args.n, tag)
    # phase 5: the background scan through the user's entry point
    scan = scan_phase(torch, kernels, scanner, policies, args.scan_n,
                      args.tile, args.seed + 10, tag)

    # phase 6: the kernels line, then the device line
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        r = results[name]
        b_ms, b_by = r["bound"]
        n_launch = dense.get(name, 0) + scan.get(name, 0)
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": n_launch,
                    "launches_by_path": {"dense": dense.get(name, 0),
                                         "background_scan": scan.get(name, 0)},
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": r["library_ms"]})
        lib = r["library_ms"]
        say("6", f"{name}: {r['ms']:.4f} ms (graph replay; eager "
                 f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                 f"bound {b_ms:.4f} ms ({b_by}), library "
                 f"{'none' if lib is None else f'{lib:.4f} ms'}, launches "
                 f"{dense.get(name, 0)} dense + {scan.get(name, 0)} "
                 f"background scan {tag}")
        if n_launch <= 0:
            raise AssertionError(f"{name} was launched on no path")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
