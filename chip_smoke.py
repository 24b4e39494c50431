#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (kyverno_tpu_torch) on one GPU.

    python3 chip_smoke.py [--n 16384] [--seed 0]

Phases, each printed as it runs; any failure raises and exits nonzero:

1. the card (``nvidia-smi --query-gpu=name,power.limit``);
2. the kernel build (one ``nvcc`` per CUDA source, started together);
3. every kernel against its plain PyTorch twin on the card, exactly
   (bool and int32 outputs): K1 at strides 1, 2 and 4 on the PSS bank
   and on an approximated small-budget bank, over seeded subjects with
   non-ASCII bytes and lengths that are not multiples of the stride;
   K3 with scopes -1 and >= I and valid zeros; K4;
4. the main path: ``TorchEngine(PSS).scan`` on N seeded resources
   (Pod / Deployment / CronJob / Service), its launch counts, its table
   and counts against the same program run with the plain twins on the
   card, a small input against the CPU run of the port, and the time of
   encode, host-to-device copy, program (median of 5) and readback.
   The stride-1 scan entry runs on the same path with
   ``KYVERNO_TPU_DFA_STRIDE=1``, as a second, separately counted scan;
5. the ``kernels`` JSON line, then the device JSON line (last line).

Without CUDA, or without the ``kyverno_tpu_torch`` package beside this
file, it exits nonzero before printing any result. It imports nothing
of JAX and nothing of ``kyverno_tpu``.
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
}


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
    """Max |kernel - plain| over int/bool outputs; raises unless 0."""
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel {tuple(got.shape)} {got.dtype}"
                             f" vs plain {tuple(want.shape)} {want.dtype}")
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


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=16384,
                    help="resources in the main-path scan")
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
             f"{time.perf_counter() - t0:.3f} s: "
             + ", ".join(os.path.basename(p) for p in libs.values()))
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                say("2", f"{name}.cu ptxas: {line.strip()}")

    # the workload and its encoded lanes (kernel shapes of the main path)
    policies = [expand_policy(p) for p in load_pss_policies()]
    t0 = time.perf_counter()
    eng = TorchEngine(policies)
    say("4", f"compiled {len(policies)} PSS policies: coverage "
             f"{eng.coverage()} in {time.perf_counter() - t0:.3f} s")
    resources, ops = workload(args.n, args.seed)
    padded, pops, _ = eng.pad(resources, ops)
    batch = eng.encode(padded, None, pops)[0]
    lanes = lanes_to_device(batch, eng.device)
    torch.cuda.synchronize()

    # phase 3: every kernel against its plain twin on the card
    results = {}
    check_dfa(torch, kernels, dfa_mod, lanes["pool"], lanes["pool_len"],
              args.seed + 1, results)
    check_instance_count(torch, kernels, lanes, eng.cps.encode_cfg.max_instances,
                         args.seed + 2, results)
    check_verdict_counts(torch, kernels, eng.device, len(eng.cps.device_programs),
                         len(padded), args.seed + 3, results)
    del lanes

    # phase 4: the main path through the user's entry point
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = eng.scan(resources, operations=ops)
    scan_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    say("4", f"TorchEngine.scan N={args.n}: table {res.verdicts.shape}, "
             f"{scan_s:.3f} s end to end {tag}; launches {launches}")
    for name in ("dfa_scan_fused", "instance_count", "instance_count2",
                 "verdict_counts"):
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched {name}")
    if res.verdicts.shape != (len(eng.cps.device_programs), args.n):
        raise AssertionError(f"table shape {res.verdicts.shape}")
    if not ((res.verdicts >= 0) & (res.verdicts <= 6)).all():
        raise AssertionError("verdict codes outside 0..6")
    if not (res.counts.sum(axis=1) == args.n).all():
        raise AssertionError("counts do not cover the live columns")

    small = 257
    cpu = TorchEngine(cps=eng.cps, device="cpu").scan(resources[:small],
                                                      operations=ops[:small])
    gpu = eng.scan(resources[:small], operations=ops[:small])
    if not ((cpu.verdicts == gpu.verdicts).all()
            and (cpu.counts == gpu.counts).all()):
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
    row = eng.rules.index(("disallow-privileged-containers",
                           "privileged-containers"))
    if pr.verdicts[row].tolist() != [2, 0]:
        raise AssertionError(f"privileged probe: {pr.verdicts[row].tolist()}")
    say("4", f"small input ({small}) equals the CPU run; privileged probe "
             "FAIL / plain probe PASS")

    hist = res.counts.sum(axis=0)
    names = ["pass", "skip", "fail", "not_matched", "error", "host", "confirm"]
    say("4", "verdict classes: " + ", ".join(
        f"{n}={int(c)}" for n, c in zip(names, hist)))

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
    if not (table[:, :args.n].cpu().numpy() == res.verdicts).all():
        raise AssertionError("scan table differs from the program's table")
    del ptable, pcounts
    say("4", "table and counts equal the plain-twin program on the card")
    t0 = time.perf_counter()
    table.cpu().numpy()
    counts.cpu().numpy()
    readback_ms = (time.perf_counter() - t0) * 1e3
    cells = len(eng.cps.device_programs) * args.n
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
    if not ((res1.verdicts == res.verdicts).all()
            and (res1.counts == res.counts).all()):
        raise AssertionError("stride-1 scan differs from the stride-4 scan")
    say("4", "stride-1 table and counts equal the stride-4 scan")
    launches["dfa_scan_stride1"] = launches1["dfa_scan_stride1"]

    # phase 5: the kernels line, then the device line
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        r = results[name]
        b_ms, b_by = r["bound"]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": r["library_ms"]})
        say("5", f"{name}: {r['ms']:.4f} ms (graph replay; eager "
                 f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                 f"bound {b_ms:.4f} ms ({b_by}), library "
                 f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
                 f" ms, {launches[name]} launches {tag}")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
