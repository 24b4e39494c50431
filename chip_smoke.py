#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (kyverno_tpu_torch) on one GPU.

    python3 chip_smoke.py [--n 16384] [--scan-n 100000] [--tile 8192]
        [--tenant-n 16384] [--tenant-batch 1024] [--mutate-n 4000]
        [--mutate-tile 1024] [--seed 0]

Phases, each printed as it runs; any failure raises and exits nonzero:

1. the card (``nvidia-smi --query-gpu=name,power.limit``);
2. the kernel build (one ``nvcc`` per CUDA source, started together);
3. every kernel against its plain PyTorch twin on the card, exactly:
   K1 at strides 1, 2 and 4 on the PSS bank and on an approximated
   small-budget bank, over seeded subjects with non-ASCII bytes and
   lengths that are not multiples of the stride; K3's one-level entry
   with 1 and 5 predicates (counts, any, both; contiguous, strided,
   unaligned and broadcast) and its two-level entry, on the main path's
   scopes and on hazard scopes (-1, >= I, valid zeros); K4; and, on one
   encoded tile of the background scan (its vocabulary lanes and
   shapes), K5 over index widths uint8, uint16 and int32 with hostile
   indices, K6 with 0, 1, 5 and 40 constants, K7 on a strided DFA
   accept column, K8, and K4's uint8 output; K9's packed launch over the
   tenant's NFA-route globs and every pattern class (packs of one 32-bit
   word and of 1, 2 and 8 64-bit words) on the tenant batch's
   namespace, name and pool lanes with real and hostile lengths, its
   pack of one there and on 320-byte seeded subjects (state words 2 to
   16), and K1's non-ASCII entry on its own; K10 ``meta_any`` on the
   tenant policy's 3,264-entry ``namespaces`` list at the tenant scan
   and triage shapes. Each is timed by CUDA-graph replay beside its
   plain twin and its library yardstick;
4. the dense path: ``TorchEngine(PSS).scan`` on N seeded resources
   (Pod / Deployment / CronJob / Service): the completed table over all
   rules (codes 0..4), its launch counts and the program's K3 counts,
   memo hits and launches (at most 1,065), the device table of ``run``
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
6. the ``kernels`` JSON line (launches by path: dense, background
   scan, tenant validate, tenant triage, mutate leg), then the device
   JSON line (last line);
7. the tenant path: the 18 PSS policies and a tenant policy (a
   validate and a mutate rule over 3,200 + 64 namespace globs) that
   fill the DFA bank's 60,000 states, so hundreds of globs run on K9:
   its bank split, ``TorchEngine.scan`` of 16,384 seeded Pods and
   Namespaces (equal to the plain-twin program on the same lanes and,
   on a slice, to the CPU run), and ``triage_mutate`` in batches of
   1,024, each with its launch counts (K9: at most 4 a program run, no
   glob outside the compiled packs) and times;
8. bench.py's mutate leg at its own sizes: ``triage_mutate`` over 4,000
   Pods (1 in 20 in ``prod``) in tiles of 1,024, ``apply_mutations``
   over every routed resource, every patched output against the port's
   scalar chain and every negative unchanged, and an all-negative batch
   of 512 costing one device dispatch and no patcher call.

9. the guarded dispatch ladder on the card: an armed ``tpu.dispatch``
   fault (the breaker trips after two failures and the third scan never
   tries the device), a corrupt-shape fault and its half-open probe, the
   three hostile resources (``metadata: "x"``, ``kind: 7``,
   ``metadata.namespace: ["x"]``) through ``TorchEngine.scan`` and
   ``ShardedScanner.scan``, a device fault in ``ShardedScanner.scan``,
   and an armed ``mutate.triage`` fault: every table equals the clean
   scan and the CPU run, the triage batch is all-HOST and patches as the
   clean one.

On every path (dense, step, tenant scan, tenant triage, mutate leg) the
program runs as one CUDA graph per shape bucket (``tpu/graphs.py``): the
replay equals the eager program and the plain-twin program exactly, with
the same launches and stats, and the phase prints eager and replayed
times, captures, the aten operations issued per eager run and per
replayed call, the device events of one replay, and the program's byte
bound (its lanes read once, its outputs written once). Every K11
``class_fold`` launch of an eager run (one a rule: the rule's class
logic, recorded on its tape by ``tpu/fold.py``) is held against its
plain twin on the same inputs, exactly, and the values forced off the
tapes (``fold_forced``) are printed; on the dense path K11 is also timed
over the run's launches (kept from that run) beside its plain twin and
bound, the eager run's aten operations are counted by output shape kind
and call site and its torch kernels' device time by call site
(``Sites``, ``op_census``, ``device_profile``), and the replay's 15
longest kernels are printed. A ``torch.profiler`` trace of the dense
program, eager and replayed, gives the device's busy share. The port's breaker and metrics
are reset before each phase; after each phase but the fault phase the
script fails unless no ``breaker_fallback`` was counted, the last
dispatch went to the device and the breaker is closed.

Phases 7 and 8 run after phase 5, then phase 9; phase 6's lines come
last.

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
    "nonascii": ("kyverno_tpu_torch/csrc/dfa_scan.cu",
                 "kyverno_tpu/tpu/dfa.py:1246"),
    "glob_nfa": ("kyverno_tpu_torch/csrc/glob_nfa.cu",
                 "kyverno_tpu/tpu/evaluator.py:386"),
    "meta_any": ("kyverno_tpu_torch/csrc/meta_any.cu",
                 "kyverno_tpu/tpu/evaluator.py:1589"),
    "class_fold": ("kyverno_tpu_torch/csrc/class_fold.cu",
                   "kyverno_tpu/tpu/evaluator.py:1886"),
}
PATHS = ("dense", "background_scan", "tenant_validate", "tenant_triage",
         "mutate_leg")

# the kernels each path must launch
DENSE_KERNELS = ("dfa_scan_fused", "instance_count", "instance_count2",
                 "verdict_counts", "hash_match", "pool_rows",
                 "first_true_take", "class_fold")
SCAN_KERNELS = ("vocab_gather", "vocab_gather_rows", "hash_match",
                "pool_rows", "first_true_take", "verdict_counts_u8",
                "dfa_scan_fused", "instance_count", "instance_count2",
                "class_fold")
TENANT_KERNELS = ("glob_nfa", "nonascii", "meta_any", "class_fold")
# eager aten operations a tenant triage batch may issue (46,747 before
# K10 took the per-entry loop over the namespace globs)
TRIAGE_OPS_MAX = 5000
# one-level K3 launches the dense PSS program may issue: its 1,875
# counts less the memo's hits on identical row masks
DENSE_K3_MAX = 1065

# the tenant policy's namespace globs, and the split of them between
# the DFA bank and the NFA route that compile_policy_set gives beside
# the 18 PSS policies under the default 60,000-state cap (computed on
# the CPU with the same compiler): (in the bank, on the NFA route)
TENANT_GLOBS = ([f"tenant-{i:05d}-*-prod" for i in range(3200)]
                + [f"t{i:03d}-??-*" for i in range(64)])
TENANT_SPLIT = (2997, 267)


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


def timed(torch, kfn, pfn, lib=None, plain_reps: int = 3,
          plain_eager: bool = False):
    """The kernel's device time (graph replay) and its eager issue
    time, the plain version's device time (its eager time, CUDA events
    around one call, with ``plain_eager``: a plain version of hundreds
    of thousands of small ops) and the library call's device time."""
    plain = eager_ms(torch, pfn, reps=1, warm=1) if plain_eager \
        else graph_ms(torch, pfn, reps=plain_reps, warm=1)
    return {"ms": graph_ms(torch, kfn), "eager_ms": eager_ms(torch, kfn),
            "plain_ms": plain,
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


def zero_stats(fn):
    fn.stats.update(dict.fromkeys(fn.stats, 0))


def program_stats(fn):
    """A program's K3 requests, memo hits and kernel calls issued, and
    the NFA-route globs outside its packs, since ``zero_stats``."""
    st = dict(fn.stats)
    return (f"K3 one level {st['inst_calls']} counts, {st['inst_hits']} memo "
            f"hits, {st['inst_issued']} launches; two levels "
            f"{st['inst2_calls']} counts, {st['inst2_hits']} hits, "
            f"{st['inst2_issued']} launches; unrecorded NFA globs "
            f"{st['nfa_unpacked']}"), st


def program_ops(torch, kernels, fn):
    """Runs ``fn`` once and counts what the host issued for it: the aten
    operations dispatched (each a kernel launch on the card, or a view)
    and the launches of the port's own kernels."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    before = sum(kernels.LAUNCHES.values())
    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n, sum(kernels.LAUNCHES.values()) - before


# the evaluator functions whose device time and aten operations are
# told apart by call site (each run under a ``record_function`` range)
SITES = ("eval_rule", "eval_match", "eval_cond_tree", "eval_cond",
         "eval_node", "_eval_map", "_eval_leaf", "_eval_array_maps",
         "_eval_array_scalar", "_eval_existence", "_eval_wildcard_anchor",
         "_first_nonpass", "_eval_foreach_deny", "_eval_condition_block",
         "_glob_fallback", "leaf_row_pred", "_cmp_pred", "_meta_heq",
         "_pairs_any", "_hash_in_lanes")
# the kernel entries (and their plain twins) the evaluator calls: their
# own operations and device time are the kernels', not the program's
KERNEL_SITES = ("scope8", "instance_count_many", "instance_count_many_plain",
                "instance_count2", "instance_count_plain", "hash_match",
                "hash_match_plain", "pool_rows", "pool_rows_plain",
                "first_true_take", "first_true_take_plain", "glob_nfa",
                "glob_nfa_plain", "glob_nfa_pack", "glob_nfa_pack_plain",
                "meta_any", "meta_any_plain", "verdict_counts",
                "verdict_counts_plain", "verdict_counts_u8",
                "verdict_counts_u8_plain", "vocab_gather",
                "vocab_gather_plain", "vocab_gather_rows",
                "vocab_gather_rows_plain", "class_fold", "class_fold_plain")


class Sites:
    """While entered, the evaluator's functions named in ``SITES`` run
    inside a ``torch.profiler.record_function("site:<name>")`` range and
    keep a stack of the sites entered (``current()``, the innermost);
    the kernel entries of ``KERNEL_SITES`` and the DFA scans
    (``bank_match``, ``nonascii_mask``) do so as "kernel:<name>"."""

    def __init__(self, ev):
        from kyverno_tpu_torch import kernels

        self.targets = [(ev, n, n) for n in SITES if hasattr(ev, n)]
        self.targets += [(ev, n, "kernel:" + n)
                         for n in ("bank_match", "nonascii_mask")]
        self.targets += [(kernels, n, "kernel:" + n) for n in KERNEL_SITES
                         if hasattr(kernels, n)]
        self.stack, self.saved = [], []

    def __enter__(self):
        from torch.profiler import record_function

        for mod, name, label in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _label=label, **k):
                self.stack.append(_label)
                try:
                    with record_function("site:" + _label):
                        return _fn(*a, **k)
                finally:
                    self.stack.pop()

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)

    def current(self) -> str:
        return self.stack[-1] if self.stack else "build_program.run"


def shape_kind(shape, N, I, R) -> str:
    """An output's shape as the program's layers see it."""
    shape = tuple(shape)
    for kind, want in (("N", (N,)), ("NI", (N, I)), ("NIJ", (N, I, I)),
                       ("NR", (N, R))):
        if shape == want:
            return kind
    return "0-d" if not shape else "other"


def op_census(torch, fn, N, I, R, sites=None):
    """The non-view aten operations one call of ``fn`` dispatches, by
    the shape kind of their first output and, with ``sites``, by the
    innermost evaluator call site; with ``sites``, those inside a kernel
    entry or its plain twin count as kind "kernel" (on the card a
    kernel's wrapper issues only its output allocations)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    kinds, by_site = {}, {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                first = out[0] if isinstance(out, (tuple, list)) and out \
                    else out
                kind = shape_kind(first.shape, N, I, R) \
                    if isinstance(first, torch.Tensor) else "other"
                site = sites.current() if sites is not None else None
                if site is not None and site.startswith("kernel:"):
                    kind = "kernel"
                kinds[kind] = kinds.get(kind, 0) + 1
                if site is not None:
                    s = by_site.setdefault(site, {})
                    s[kind] = s.get(kind, 0) + 1
            return out

    with Count():
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"by_kind": kinds, "total": sum(kinds.values()),
            "class_logic": sum(kinds.get(k, 0) for k in ("N", "NI", "NIJ")),
            "by_site": by_site}


def device_profile(torch, fn, sites=None, top: int = 15):
    """One call of ``fn`` under ``torch.profiler``: device events and
    their time by kernel name (the ``top`` longest), and with ``sites``
    the device time of each innermost evaluator call site (kernels
    charged to the range that launched them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, n_dev, dev_us = {}, 0, 0.0
    site_us = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("site:"):
                continue  # a range's span on the device's timeline
            us = e.time_range.end - e.time_range.start
            n_dev += 1
            dev_us += us
            c, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (c + 1, t + us)
            continue
        ks = getattr(e, "kernels", None)
        if sites is None or not ks:
            continue
        p, site = e, "build_program.run"
        while p is not None:
            if p.name.startswith("site:"):
                site = p.name[5:]
                break
            p = p.cpu_parent
        site_us[site] = site_us.get(site, 0.0) + sum(k.duration for k in ks)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"device_events": n_dev, "device_ms": dev_us / 1e3,
            "kernels": len(by_name),
            "top": [{"name": k[:120], "calls": c, "ms": t / 1e3}
                    for k, (c, t) in ranked[:top]],
            "by_site_ms": {k: v / 1e3 for k, v in sorted(
                site_us.items(), key=lambda kv: -kv[1])}}


def ladder_reset():
    """Before a phase: no fault armed, the port's breaker reset (closed,
    default tuning), its fallback counters and the triage fallback
    outcome at 0, and no dispatch path recorded on this thread."""
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.observability.profiling import set_dispatch_path
    from kyverno_tpu_torch.resilience.breaker import tpu_breaker
    from kyverno_tpu_torch.resilience.faults import global_faults

    global_faults.disarm()
    tpu_breaker().reset()
    for reason in ("error", "open"):
        global_registry.breaker_fallback.remove({"reason": reason})
    global_registry.mutate_triage.remove({"outcome": "fallback"})
    set_dispatch_path("none")


def ladder_check(phase: str) -> None:
    """After a phase other than the fault phase: the ladder must not
    have hidden the card — no breaker fallback, no triage fallback, the
    last dispatch on the device, the breaker closed."""
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.observability.profiling import (PATH_DEVICE,
                                                           last_dispatch_path)
    from kyverno_tpu_torch.resilience.breaker import CLOSED, tpu_breaker

    fb = {r: global_registry.breaker_fallback.value({"reason": r})
          for r in ("error", "open")}
    tri = global_registry.mutate_triage.value({"outcome": "fallback"})
    path = last_dispatch_path("none")
    state = tpu_breaker().state
    if any(fb.values()) or tri or path != PATH_DEVICE or state != CLOSED:
        raise AssertionError(f"phase {phase}: breaker_fallback {fb}, triage "
                             f"fallbacks {tri}, last dispatch path {path!r}, "
                             f"breaker {state}: the card was not used")
    say(phase, "ladder: no breaker_fallback and no triage fallback, last "
               "dispatch path device, breaker closed")


def same_outputs(torch, name: str, got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want) or not all(
            g.dtype == w.dtype and torch.equal(g, w)
            for g, w in zip(got, want)):
        raise AssertionError(f"{name} differ")


class FoldCheck:
    """A ``fold.CHECK`` hook: each K11 launch of a program run held
    against its plain twin on the same inputs, exactly; with ``keep``,
    each launch's code and tensors are kept (for ``time_class_fold``)."""

    def __init__(self, torch, kernels, keep: bool = False):
        self.torch, self.kernels, self.keep = torch, kernels, keep
        self.launches, self.max_abs_err, self.kept = 0, 0.0, []

    def __call__(self, code, ios, dims):
        N, I, J = dims
        outs = list(ios[code.n_ext:])
        twin = [self.torch.empty_like(o) for o in outs]
        self.kernels.class_fold_plain(code, list(ios[:code.n_ext]) + twin,
                                      N, I, J)
        for got, want in zip(outs, twin):
            self.max_abs_err = max(self.max_abs_err, exact(
                self.torch, "class_fold", got, want))
        self.launches += 1
        if self.keep:
            self.kept.append((code, list(ios), dims))


def _distinct_bytes(t) -> int:
    """The bytes a view reads once (a broadcast dimension counts once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def fold_work(kept):
    """K11's work over kept launches: the distinct bytes its descriptors
    read or write, one operation per value element an instruction (or a
    load group's entry) makes, and the instruction rows."""
    seen, nbytes, ops, rows = set(), 0, 0, 0
    for code, ios, (N, I, J) in kept:
        for t in ios:
            key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()))
            if key not in seen:
                seen.add(key)
                nbytes += _distinct_bytes(t)
        per = (N, N * I, N * I * J)
        pc, instrs = 0, code.instrs
        while pc < len(instrs):
            x = instrs[pc][0]
            op, kind, f = x & 0xFF, (x >> 8) & 0xFF, x >> 16
            pc += 1
            if op == 0:  # a load group: its entries' kinds
                ops += sum(per[e[0]] for e in instrs[pc:pc + f])
                pc += f
            else:
                ops += per[kind]
        rows += len(instrs)
    return nbytes, ops, rows


def time_class_fold(torch, kernels, kept, tag):
    """K11 over one program run's launches (``FoldCheck(keep=True)``):
    device time of all of them (graph replay) against their plain twins
    (eager), and the bound — each distinct input read once and each
    output written once, or one integer operation per instruction and
    value element, the larger."""
    def k11():
        for code, ios, (N, I, J) in kept:
            kernels.class_fold(code, ios, N, I, J)

    def twin():
        for code, ios, (N, I, J) in kept:
            kernels.class_fold_plain(code, ios, N, I, J)

    nbytes, ops, rows = fold_work(kept)
    r = timed(torch, k11, twin, plain_eager=True)
    r["bound"] = bound(nbytes, ops)
    r["max_abs_err"] = 0.0
    r.update(launches=len(kept), bytes=nbytes, ops=ops, instructions=rows)
    say("3", f"class_fold over the {len(kept)} launches of one dense run "
             f"({rows} instructions, {nbytes} distinct bytes, {ops} value "
             f"operations): {r['ms']:.4f} ms (graph replay; eager "
             f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound "
             f"{r['bound'][0]:.4f} ms ({r['bound'][1]}) {tag}")
    return r


def graph_check(torch, kernels, phase, label, g, lanes, plain_fn, tag,
                keep_folds: bool = False, top: bool = False):
    """One path's program as a CUDA graph (``tpu/graphs.py``) on one
    lane dict: the replay against the eager program (``g.run``) and the
    plain-twin program, exactly; the launches and program stats of one
    eager run against one replay; eager and replayed times (host clock
    to a sync, median of 5); captures; the aten operations the host
    issues per eager run and per replayed call; every K11 launch of an
    eager run against its plain twin and the values the run forced off
    its tapes (``fold_forced``); and the device events of one replay
    (with ``top``, its 15 longest kernels by name)."""
    from kyverno_tpu_torch.tpu import fold
    from kyverno_tpu_torch.tpu.graphs import GraphedProgram

    if not isinstance(g, GraphedProgram):
        raise AssertionError(f"{label}: the program is not graphed")

    def five(fn):
        ts, out = [], None
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts), ts, out

    eager_ms, eager_all, eager_out = five(lambda: g.run(lanes))
    # a key's first call runs eagerly, its second captures: both happen
    # here unless the path already made them
    g(lanes)
    g(lanes)
    replay_ms, replay_all, replay_out = five(lambda: g(lanes))
    same_outputs(torch, f"{label}: replay and eager outputs", replay_out,
                 eager_out)
    same_outputs(torch, f"{label}: replay and plain-twin outputs",
                 replay_out, plain_fn(lanes))
    counted = []
    for fn in (g.run, g):
        kernels.reset_launches()
        zero_stats(g)
        fn(lanes)
        torch.cuda.synchronize()
        counted.append((dict(kernels.LAUNCHES), dict(g.stats)))
    if counted[0] != counted[1]:
        raise AssertionError(f"{label}: an eager run counts {counted[0]}, a "
                             f"replay {counted[1]}")
    ops_eager, _ = program_ops(torch, kernels, lambda: g.run(lanes))
    ops_replay, _ = program_ops(torch, kernels, lambda: g(lanes))
    n_launch = sum(counted[0][0].values())
    chk = FoldCheck(torch, kernels, keep=keep_folds)
    zero_stats(g)
    fold.CHECK = chk
    try:
        g.run(lanes)
        torch.cuda.synchronize()
    finally:
        fold.CHECK = None
    forced = g.stats["fold_forced"]
    if chk.launches <= 0 or chk.launches != counted[0][0]["class_fold"]:
        raise AssertionError(f"{label}: {chk.launches} K11 launches checked, "
                             f"{counted[0][0]['class_fold']} counted")
    rp = device_profile(torch, lambda: g(lanes))
    # the program's bound: every lane read once, its outputs written once
    outs = eager_out if isinstance(eager_out, tuple) else (eager_out,)
    io_bytes = sum(t.numel() * t.element_size() for t in lanes.values()) \
        + sum(t.numel() * t.element_size() for t in outs)
    b_ms, _ = bound(io_bytes, 0)
    say(phase, f"{label} as a CUDA graph: replay equals the eager program and "
               f"the plain-twin program; eager {eager_ms:.3f} ms median of 5 "
               f"({', '.join(f'{x:.3f}' for x in eager_all)}), replay "
               f"{replay_ms:.3f} ms median of 5 "
               f"({', '.join(f'{x:.3f}' for x in replay_all)}) {tag}")
    say(phase, f"{label}: captures {g.captures} (live {g.live_graphs}), "
               f"replays {g.replays}; aten operations per eager run "
               f"{ops_eager}, per replayed call {ops_replay}; {n_launch} "
               "launches of the port's kernels per run, the same counted "
               "eagerly and replayed")
    say(phase, f"{label}: K11 class_fold equals its plain twin on all "
               f"{chk.launches} launches of an eager run (max abs err "
               f"{chk.max_abs_err}); fold_forced {forced}; one replay "
               f"{rp['device_events']} device events, {rp['device_ms']:.3f} "
               f"ms of device time (torch.profiler); bound {b_ms:.4f} ms "
               f"({io_bytes} bytes of lanes and outputs) {tag}")
    if top:
        for t in rp["top"]:
            say(phase, f"  replay kernel {t['ms']:.3f} ms {t['calls']} x "
                       f"{t['name']}")
    return {"eager_ms": eager_ms, "replay_ms": replay_ms,
            "captures": g.captures, "ops_eager": ops_eager,
            "ops_replay": ops_replay, "launches": n_launch,
            "fold_checked": chk.launches, "fold_forced": forced,
            "replay_events": rp["device_events"],
            "replay_device_ms": rp["device_ms"], "top": rp["top"],
            "bound_ms": b_ms, "io_bytes": io_bytes,
            "fold_kept": chk.kept}


def busy_share(torch, fn, reps: int = 3):
    """The device's busy share over ``reps`` calls of ``fn`` under
    ``torch.profiler``: the union of the CUDA activity intervals over the
    traced window (first to last event). None when the trace holds no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.time_range.end > e.time_range.start]
    dev = sorted((e.time_range.start, e.time_range.end) for e in evs
                 if e.device_type == DeviceType.CUDA)
    if not dev:
        return None
    lo = min(e.time_range.start for e in evs)
    hi = max(e.time_range.end for e in evs)
    busy, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    for a, b in dev[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    return {"busy_share": busy / (hi - lo), "window_ms": (hi - lo) / 1e3,
            "busy_ms": busy / 1e3, "device_events": len(dev)}


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
            ids = [i for i in bank.families["pool"]
                   if int(bank.strides[i]) == stride]
            if not ids:
                raise AssertionError(f"{label} bank: no pattern at stride {stride}")
            (tiles,) = dfa_mod.scan_groups(bank, ids, dev)
            kfn, name = k1_entry(kernels, tiles)
            out = torch.empty((b.shape[0], len(ids)), dtype=torch.bool,
                              device=dev)
            got, na = kfn(b, ln, tiles, out, want_nonascii=True)
            want = tiles.plain_scan(b, ln)
            err = exact(torch, f"{name} {label} stride {stride}", got, want)
            err = max(err, exact(torch, f"nonascii {label} stride {stride}",
                                 na, kernels.nonascii_plain(b, ln)))
            say("3", f"K1 {name} {label} bank stride {stride}: "
                     f"{tuple(got.shape)} accepts, {int(got.sum())} hits, "
                     f"{int(na.sum())} non-ASCII subjects, max abs err {err}; "
                     + k1_layout(tiles, b))
            # time each entry at the main path's own configuration: the
            # compiled PSS bank (stride 4) and its stride-1 build
            if label == "pss" and stride in (4, 1):
                K = len(ids)
                nbytes, steps, table_bytes = k1_work(torch, tiles, b, ln)
                results[name] = {
                    "max_abs_err": err,
                    **timed(torch, lambda: kfn(b, ln, tiles, out),
                            lambda: tiles.plain_scan(b, ln)),
                    "bound": bound(nbytes, steps * K * 4),
                }
                say("3", f"K1 {name} bound inputs: {b.shape[0]} subjects, "
                         f"{steps * K} steps, {table_bytes} table bytes")


def k1_entry(kernels, tiles):
    """K1's wrapper for a stride group's tiles, and its name."""
    if tiles.kind == "stride1":
        return kernels.dfa_scan_stride1, "dfa_scan_stride1"
    return kernels.dfa_scan_fused, "dfa_scan_fused"


def k1_layout(tiles, b):
    """The tiles and the grid of a K1 launch over subjects ``b``."""
    S, W = b.shape
    chunk = tiles.chunk(S, W, b.device)
    flags = tiles.tiles[:, 3].cpu()
    return (f"{tiles.n_tiles} tiles ({int((flags & 2).sum())} in global "
            f"memory, {int((flags & 1).sum())} wide) of "
            f"{int(tiles.blob.numel())} bytes, the largest staged "
            f"{tiles.smem_tile}; grid ({-(-S // chunk)}, {tiles.n_tiles}), "
            f"{chunk} subjects a chunk, {tiles.smem} bytes of shared memory")


def check_dfa_tenant(torch, kernels, dfa_mod, bank, lanes, results):
    """K1 where most of its launches run: the tenant bank's ``ns`` and
    ``name`` families (3,000 patterns, 59,993 states) over the tenant
    batch's namespace and name lanes, at the scan shape (every row)
    and at the triage shape (the first 1,024 rows), both entries held
    exactly against their plain twins and timed."""
    dev = lanes["meta_ns_bytes"].device
    rows = []
    for family in ("ns", "name"):
        byt = lanes[f"meta_{family}_bytes"]
        ln = lanes[f"meta_{family}_len"]
        ids = bank.families[family]
        # the whole family, both groups writing the plane in place
        err = exact(torch, f"bank_match tenant {family}",
                    dfa_mod.bank_match(bank, ids, byt, ln),
                    dfa_mod.bank_match(bank, ids, byt, ln, plain=True))
        say("3", f"K1 bank_match tenant {family} ({len(ids)} patterns, "
                 f"{byt.shape[0]} subjects): equal to the plain twins, max "
                 f"abs err {err}")
        for stride in (1, 4):
            sub = [i for i in ids if int(bank.strides[i]) == stride]
            (tiles,) = dfa_mod.scan_groups(bank, sub, dev)
            kfn, name = k1_entry(kernels, tiles)
            for shape, n in (("scan", byt.shape[0]),
                             ("triage", min(1024, byt.shape[0]))):
                b, l = byt[:n].contiguous(), ln[:n].contiguous()
                out = torch.empty((n, len(sub)), dtype=torch.bool, device=dev)
                got = kfn(b, l, tiles, out)[0]
                err = exact(torch, f"{name} tenant {family} {shape}", got,
                            tiles.plain_scan(b, l))
                nbytes, steps, table_bytes = k1_work(torch, tiles, b, l)
                row = {"name": name, "family": family, "shape": shape,
                       "K": len(sub), "S": n, "W": b.shape[1],
                       "steps": steps * len(sub), "table_bytes": table_bytes,
                       "max_abs_err": err,
                       **timed(torch, lambda: kfn(b, l, tiles, out),
                               lambda: tiles.plain_scan(b, l),
                               plain_eager=True),
                       "bound": bound(nbytes, steps * len(sub) * 4),
                       "chunk_ms": k1_chunk_sweep(torch, kernels, kfn, tiles,
                                                  b, l, out)}
                rows.append(row)
                say("3", f"K1 {name} tenant {family} {shape}: K {len(sub)}, "
                         f"S {n}, W {b.shape[1]}, steps {steps * len(sub)}, "
                         f"table bytes {table_bytes}; "
                         + k1_layout(tiles, b))
                say("3", f"K1 {name} tenant {family} {shape}: "
                         f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}),"
                         f" plain {row['plain_ms']:.4f} ms, bound "
                         f"{row['bound'][0]:.6f} ms ({row['bound'][1]}), "
                         f"{int(got.sum())} hits, max abs err {err}")
                say("3", f"K1 {name} tenant {family} {shape}: chunks a tile"
                         f" -> ms (the wrapper's rule: "
                         f"{-(-n // tiles.chunk(n, b.shape[1], dev))}): "
                         + ", ".join(
                             f"{c}: {ms:.4f}"
                             for c, ms in row["chunk_ms"].items()))
    results["dfa_tenant"] = rows


def k1_chunk_sweep(torch, kernels, kfn, tiles, b, ln, out):
    """K1's device time over ``b`` with the subjects of each tile split
    into 1, 2, 3, 4, 8, 16, 32 and 64 chunks and the wrapper's own count
    (while a chunk keeps ``kernels.DFA_MIN_CHUNK`` subjects):
    {chunks: ms}."""
    S, W = b.shape
    own = -(-S // tiles.chunk(S, W, b.device))
    sweep = {}
    try:
        for c in sorted({1, 2, 3, 4, 8, 16, 32, 64, own}):
            if c > 1 and -(-S // c) < kernels.DFA_MIN_CHUNK:
                break
            tiles.chunk = lambda S, W, device, c=c: -(-S // c)
            sweep[c] = graph_ms(torch, lambda: kfn(b, ln, tiles, out))
    finally:
        del tiles.chunk
    return sweep


def k1_work(torch, tiles, b, ln):
    """The least work K1 needs on these subjects: (bytes moved, steps
    per pattern, table bytes). The tables are the group's packed tiles,
    their directory and (fused) the 4 KB pair map, each read once. The
    scan stops after ceil(min(len, W) / 2) pairs (fused) or min(len, W)
    bytes (stride 1), and bytes past that cannot change the result, so
    only live bytes count, beside the lengths and the (S, K) output."""
    S, W = b.shape
    live = torch.clamp(ln, 0, W).to(torch.int64)
    table_bytes = tiles.blob.numel() + tiles.tiles.numel() * 4
    if tiles.kind == "stride1":
        steps = int(live.sum())
    else:
        steps = int(((live + 1) // 2).sum())
        table_bytes += 4096
    nbytes = S * 4 + S * tiles.cols.numel() + int(live.sum()) + table_bytes
    return nbytes, steps, table_bytes


def check_instance_count(torch, kernels, lanes, n_inst, seed, results):
    """K3's one-level entry (P = 1 and 5 predicates, counts, any and
    both, contiguous, strided, unaligned and broadcast predicates) and
    its two-level entry against their plain twins, on the main path's
    scopes and on hazard scopes; both timed at the path shape beside
    scatter_add_."""
    dev = lanes["scope1"].device
    N, R = lanes["scope1"].shape
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rand_pred(shape, q):
        return (torch.rand(shape, generator=gen) < q).to(dev)

    pred = rand_pred((N, R), 0.5)
    wide = rand_pred((N, R + 8), 0.3)
    preds = {"contiguous": pred,
             "strided": wide[:, :R],        # row stride R + 8
             "unaligned": wide[:, 3:R + 3],  # rows start off 8 bytes
             "broadcast": rand_pred((1, R), 0.5).expand(N, R),
             "sparse": rand_pred((N, R), 0.02)}
    hz1 = torch.randint(-1, n_inst + 3, (N, R), generator=gen,
                        dtype=torch.int32).to(dev)
    hz2 = torch.randint(-1, n_inst + 3, (N, R), generator=gen,
                        dtype=torch.int32).to(dev)
    hzv = rand_pred((N, R), 0.8)
    valid = lanes["valid"] != 0
    s1, s2 = lanes["scope1"], lanes["scope2"]
    errs = {"instance_count": 0.0, "instance_count2": 0.0}
    names = list(preds)
    for label, (a, b, v) in (("main-path lanes", (s1, s2, valid)),
                             ("hazard scopes", (hz1, hz2, hzv))):
        sc = kernels.scope8(a, v, n_inst)
        runs = [([k], w) for k in names for w in ("count", "any")]
        runs += [(names, "count"), (names, "any"),
                 (names, ["count", "any", "any", "count", "any"])]
        for ks, want in runs:
            ps = [preds[k] for k in ks]
            got = kernels.instance_count_many(ps, sc, n_inst, want)
            ref = kernels.instance_count_many_plain(ps, sc, n_inst, want)
            wants = [want] * len(ks) if isinstance(want, str) else want
            for k, w, g, r, p in zip(ks, wants, got, ref, ps):
                e = exact(torch, f"instance_count {label} {k} {w} P={len(ks)}",
                          g, r)
                # and the one-hot count on scope1 and valid themselves
                full = kernels.instance_count_plain(p.contiguous(), a, v,
                                                    n_inst)
                e = max(e, exact(torch, f"instance_count {label} {k} {w} "
                                        "vs one-hot", g,
                                 full > 0 if w == "any" else full))
                errs["instance_count"] = max(errs["instance_count"], e)
        g2 = kernels.instance_count2(pred, a, b, v, n_inst)
        w2 = kernels.instance_count_plain(pred, a, v, n_inst, b)
        errs["instance_count2"] = max(errs["instance_count2"], exact(
            torch, f"instance_count2 {label}", g2, w2))
        say("3", f"K3 instance_count {label}: {len(runs)} launches of 1 and "
                 f"5 predicates ({', '.join(names)}; count, any, mixed) "
                 f"equal the plain twin and the one-hot count; two-level "
                 f"{tuple(g2.shape)} sum {int(g2.sum())}; max abs err "
                 f"{max(errs.values())}")
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
    sc = kernels.scope8(s1, valid, n_inst)
    # five predicates on the vector path (the unaligned one is not)
    five = [preds[k] for k in names if k != "unaligned"] + [
        rand_pred((N, R), 0.7)]
    five_bytes = sum(R if p.stride(0) == 0 else N * R for p in five)
    out1.zero_().scatter_add_(0, idx1, w1)
    if not torch.equal(out1.view(N, n_inst),
                       kernels.instance_count_many([pred], sc, n_inst)[0]):
        raise AssertionError("scatter_add_ yardstick disagrees with K3")
    one = timed(torch, lambda: kernels.instance_count_many([pred], sc, n_inst),
                lambda: kernels.instance_count_many_plain([pred], sc, n_inst),
                lambda: out1.zero_().scatter_add_(0, idx1, w1))
    p5 = timed(torch, lambda: kernels.instance_count_many(five, sc, n_inst),
               lambda: kernels.instance_count_many_plain(five, sc, n_inst))
    any1 = graph_ms(torch, lambda: kernels.instance_count_many(
        [pred], sc, n_inst, "any"))
    counts_out = N * n_inst * 4
    results["instance_count"] = {
        "max_abs_err": errs["instance_count"], **one,
        # the bytes this entry reads and writes (pred, scope8, counts)
        "bound": bound(N * R * 2 + counts_out, N * R * 4),
        "ms_p5": p5["ms"], "eager_ms_p5": p5["eager_ms"],
        "plain_ms_p5": p5["plain_ms"], "ms_any": any1,
        "bound_p5": bound(five_bytes + N * R + 5 * counts_out,
                          5 * N * R * 4),
        # the earlier kernel's measure: pred, valid and int32 scope1
        # (6 bytes a row)
        "bound_6_bytes": bound(N * R * 6 + counts_out, N * R * 4),
    }
    results["instance_count2"] = {
        "max_abs_err": errs["instance_count2"],
        **timed(torch,
                lambda: kernels.instance_count2(pred, s1, s2, valid, n_inst),
                lambda: kernels.instance_count_plain(pred, s1, valid, n_inst,
                                                     s2),
                lambda: out2.zero_().scatter_add_(0, idx2, w2)),
        "bound": bound(N * R * 10 + N * n_inst * n_inst * 4, N * R * 4),
    }
    r = results["instance_count"]
    say("3", f"K3 one level at ({N}, {R}), I={n_inst}: P=1 {r['ms']:.4f} ms "
             f"(bound {r['bound'][0]:.4f}; 6-byte bound "
             f"{r['bound_6_bytes'][0]:.4f}), any {r['ms_any']:.4f} ms, P=5 "
             f"{r['ms_p5']:.4f} ms (bound {r['bound_p5'][0]:.4f}), "
             f"scatter_add_ {r['library_ms']:.4f} ms")


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
                n, tag, results):
    """Phase 4: the dense TorchEngine path. Returns its launch counts;
    puts K11's time over the program's launches in ``results``."""
    from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device

    ladder_reset()
    kernels.reset_launches()
    zero_stats(eng.cps.device_fn())
    t0 = time.perf_counter()
    res = eng.scan(resources, operations=ops)
    scan_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    line, st = program_stats(eng.cps.device_fn())
    say("4", f"TorchEngine.scan N={n}: table {res.verdicts.shape}, "
             f"{scan_s:.3f} s end to end {tag}; launches {launches}")
    say("4", f"the program: {line}")
    for name in DENSE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"dense path never launched {name}")
    if launches["instance_count"] != st["inst_issued"] \
            or launches["instance_count"] > DENSE_K3_MAX:
        raise AssertionError(f"dense program: {launches['instance_count']} "
                             f"one-level K3 launches ({st['inst_issued']} "
                             f"issued), want at most {DENSE_K3_MAX}")
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
    # the program as a CUDA graph (its key first seen by the scan above) against
    # the eager program and the plain-twin program, on the same lanes
    graph = eng.cps.device_fn(device=eng.device)
    gr = graph_check(torch, kernels, "4", "the dense program", graph, lanes,
                     eng.cps.device_fn(plain=True), tag, keep_folds=True,
                     top=True)
    program_ms = gr["replay_ms"]
    results["class_fold"] = time_class_fold(torch, kernels,
                                            gr.pop("fold_kept"), tag)
    # where the eager run's operations and device time go
    from kyverno_tpu_torch.tpu import evaluator as ev

    N, R = lanes["norm_hi"].shape
    I = eng.cps.encode_cfg.max_instances
    with Sites(ev) as sites:
        census = op_census(torch, lambda: graph.run(lanes), N, I, R, sites)
    say("4", f"aten operations of one eager dense run by output shape kind "
             f"{json.dumps(census['by_kind'], sort_keys=True)}: class logic "
             f"((N,), (N, I), (N, I, J)) {census['class_logic']}, total "
             f"{census['total']} (record_function ranges included)")
    for site, kinds in sorted(census["by_site"].items(),
                              key=lambda kv: -sum(kv[1].values()))[:12]:
        say("4", f"  aten operations at {site}: {sum(kinds.values())} "
                 f"{json.dumps(kinds, sort_keys=True)}")
    with Sites(ev) as sites:
        dp = device_profile(torch, lambda: graph.run(lanes), sites)
    say("4", f"one eager dense run: {dp['device_events']} device events, "
             f"{dp['device_ms']:.3f} ms of device time; torch kernels' time "
             f"by call site {tag}:")
    for site, ms in list(dp["by_site_ms"].items())[:14]:
        say("4", f"  device ms at {site}: {ms:.3f}")
    gr["census"] = census
    table, counts = eng.run(lanes)
    peak = torch.cuda.max_memory_allocated()
    for label, fn in (("eager", graph.run), ("replayed", graph)):
        share = busy_share(torch, lambda: fn(lanes))
        say("4", f"device busy share of the dense program, {label} "
                 "(torch.profiler, 3 runs): " + (
                     "not measured (no device activity in the trace)"
                     if share is None else
                     f"{share['busy_share']:.4f} ({share['busy_ms']:.3f} ms "
                     f"busy of a {share['window_ms']:.3f} ms window, "
                     f"{share['device_events']} device events)") + f" {tag}")
        gr[f"busy_{label}"] = share
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
    say("4", f"program {gr['eager_ms']:.3f} ms eager, {program_ms:.3f} ms "
             f"replayed (medians of 5) {tag}")
    say("4", f"readback {readback_ms:.3f} ms {tag}")
    say("4", f"{cells / (program_ms / 1e3):.0f} rule x resource evals/s "
             f"on the replayed program, {cells / scan_s:.0f} end to end {tag}")
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
    ladder_check("4")
    return launches, gr


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

    ladder_reset()
    kernels.reset_launches()
    zero_stats(scanner.step_jitted())
    t0 = time.perf_counter()
    res, stats = scanner.scan_stream(resources, tile=tile, operations=ops)
    scan_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    say("5", f"the step over {-(-scan_n // tile)} tiles: "
             + program_stats(scanner.step_jitted())[0])
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
                          dfa=scanner.cps.dfa, plain=True, verdicts_u8=True,
                          nfa_globs=scanner.cps.nfa_globs)
    pv, pc = plain(lanes)
    if not (torch.equal(v, pv) and torch.equal(c, pc)):
        raise AssertionError("step differs from the plain-twin step")
    say("5", "step (uint8 table and counts) equals the plain-twin step on "
             "the same vocabulary lanes")

    # the step never waits for the device, eager or replayed (the
    # graph of these lanes' bucket exists by now)
    step = scanner.step_jitted()
    step(lanes)
    torch.cuda.synchronize()
    for label, fn in (("eager", step.run), ("replayed", step)):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn(lanes)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message).lower()]
        if syncs:
            raise AssertionError(f"the {label} step synchronizes the host "
                                 f"{len(syncs)} times: {syncs[:3]}")
    say("5", "the step issued no synchronizing operation, eager or "
             "replayed (torch.cuda.set_sync_debug_mode)")

    # 257 resources: the CPU scanner against the card's
    small = 257
    cpu = ShardedScanner(policies, device="cpu")
    a = cpu.scan(resources[:small], operations=ops[:small])
    b = scanner.scan(resources[:small], operations=ops[:small])
    if not (a.verdicts == b.verdicts).all() or a.rules != b.rules:
        raise AssertionError(f"card scan differs from the CPU scan on {small}")
    say("5", f"ShardedScanner(device='cpu').scan of {small} resources equals "
             "the card's")

    # steady-state step on one resident tile (bench.py's measure),
    # eager and replayed, against the plain-twin step
    gr = graph_check(torch, kernels, "5", "the step", step, lanes, plain,
                     tag)
    step_ms = gr["replay_ms"]
    cells = len(scanner.cps.device_programs) * tile
    say("5", f"steady-state step {gr['eager_ms']:.3f} ms eager, "
             f"{step_ms:.3f} ms replayed (medians of 5) on one resident "
             f"{tile}-resource tile: {cells / (step_ms / 1e3):.0f} rule x "
             f"resource evals/s replayed {tag}")
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
    ladder_check("5")
    return launches, gr


# ---------------------------------------------------------------------------
# the tenant set: a namespace glob per tenant, more than the bank holds


def tenant_policy():
    """One validate rule (a ``team`` label on Pods) and one mutate rule
    (stamp ``+(team)``), both matching the tenant namespace globs."""
    from kyverno_tpu_torch.api.policy import ClusterPolicy

    def match():
        return {"resources": {"kinds": ["Pod"],
                              "namespaces": list(TENANT_GLOBS)}}

    return ClusterPolicy.from_dict({
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "tenant"},
        "spec": {"validationFailureAction": "Enforce", "rules": [
            {"name": "require-team", "match": match(),
             "validate": {"message": "team label required", "pattern":
                          {"metadata": {"labels": {"team": "?*"}}}}},
            {"name": "stamp-team", "match": match(),
             "mutate": {"patchStrategicMerge":
                        {"metadata": {"labels": {"+(team)": "core"}}}}}]}})


def glob_instance(rng, glob: str, nonascii: bool = False) -> str:
    """A string the glob accepts: '*' becomes a short token, '?' a
    letter; ``nonascii`` puts an 'é' (two UTF-8 bytes) in the first '*'
    or '?' instead."""
    out = []
    for c in glob:
        if c in "*?":
            tok = (rng.choice("abcxyz") if c == "?" else
                   "".join(rng.choice("abcxyz0123")
                           for _ in range(rng.randint(1, 6))))
            if nonascii:
                tok, nonascii = "é", False
            out.append(tok)
        else:
            out.append(c)
    return "".join(out)


def tenant_workload(n: int, seed: int, in_bank, nfa):
    """Seeded Pods (3 in 4) and Namespaces whose namespace (or name)
    is drawn from globs in the bank, globs on the NFA route ('?' ones
    among them) and default / kube-system; about 1 in 50 carries a
    non-ASCII byte."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        r = rng.random()
        glob = (rng.choice(in_bank) if r < 0.4 else
                rng.choice(nfa) if r < 0.85 else None)
        odd = rng.random() < 0.02
        ns = (rng.choice(["default", "kube-system"]) if glob is None
              else glob_instance(rng, glob, odd))
        if rng.random() < 0.25:
            out.append({"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": ns}})
            continue
        meta = {"name": f"pod-{i}", "namespace": ns}
        if rng.random() < 0.5:
            meta["labels"] = {"team": rng.choice(["a", "b", "c"])}
        out.append({"apiVersion": "v1", "kind": "Pod", "metadata": meta,
                    "spec": {"containers": [{"name": "c", "image": "nginx"}]}})
    return out


def glob_subjects(torch, rng, pattern: str, S: int, W: int):
    """(S, W) uint8 / (S,) int32 seeded subjects: half instances of the
    pattern, half noise over its bytes, NUL and non-ASCII bytes."""
    import numpy as np

    alpha = np.array(sorted({ord(c) & 0xFF for c in pattern
                             if c not in "*?"}) + [0, 0x2D, 0x61, 0xE9],
                     dtype=np.uint8)
    byt = rng.choice(alpha, size=(S, W)).astype(np.uint8)
    lens = rng.integers(0, W + 1, size=(S,)).astype(np.int32)
    # about 16 stars of an instance take bytes, so long patterns fit
    take = 16 / max(16, pattern.count("*"))
    for i in range(0, S, 2):
        inst = []
        for c in pattern:
            if c == "*":
                k = int(rng.integers(0, 3)) if rng.random() < take else 0
                inst += list(rng.choice(alpha, size=k))
            elif c == "?":
                inst.append(int(rng.choice(alpha[alpha != 0])))
            else:
                inst.append(ord(c) & 0xFF)
        inst = inst[:W]
        byt[i, :len(inst)] = inst
        lens[i] = len(inst)
    return torch.from_numpy(byt), torch.from_numpy(lens)


def check_glob_nfa(torch, kernels, lanes, nfa, seed, results):
    """Packed K9 against its plain twin on the tenant batch's namespace,
    name and pool lanes, with real and hostile lengths, over the packs
    of the tenant's NFA-route globs and every pattern class (1, 2 and 8
    64-bit state words); the pack of one (``glob_nfa``) against the same
    rows and on 320-byte seeded subjects (2 to 16 state words). Then the
    packed launch timed on the namespace lane beside the pack of one,
    and K1's non-ASCII entry."""
    import numpy as np

    dev = lanes["meta_ns_bytes"].device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rng = np.random.default_rng(seed)
    qglob = next(g for g in nfa if "?" in g)
    classes = [nfa[0], qglob, "", "*", "***", "?", "a*b?c*", "é*", "中?",
               "a" * 63, "a" * 64, "a" * 65, ("ab*?" * 75)[:299]]
    packs = kernels.glob_packs(list(nfa) + [c for c in classes
                                            if c not in nfa])
    words = [p.nw for p in packs]
    if words != [1, 2, 8]:
        raise AssertionError(f"glob packs of {words} state words")
    planes = [("ns", lanes["meta_ns_bytes"], lanes["meta_ns_len"]),
              ("name", lanes["meta_name_bytes"], lanes["meta_name_len"]),
              ("pool", lanes["pool"], lanes["pool_len"])]
    err = 0.0
    words = set()
    for label, byt, ln in planes:
        W = byt.shape[-1]
        hostile = torch.randint(-3, W + 6, tuple(ln.shape), generator=gen,
                                dtype=torch.int32).to(dev)
        for lname, lens in (("lengths", ln), ("hostile lengths", hostile)):
            hits = 0
            rows = {}
            for pack in packs:
                got = kernels.glob_nfa_pack(pack, byt, lens)
                err = max(err, exact(
                    torch, f"glob_nfa pack of {len(pack.patterns)} "
                           f"({pack.nw} words) {label} {lname}",
                    got, kernels.glob_nfa_pack_plain(pack, byt, lens)))
                hits += int(got.sum())
                rows.update(zip(pack.patterns, got))
            for p in classes:
                err = max(err, exact(torch, f"glob_nfa {p!r} {label} {lname}",
                                     kernels.glob_nfa(p, byt, lens), rows[p]))
            say("3", f"K9 glob_nfa {len(packs)} packs of "
                     f"{sum(len(p.patterns) for p in packs)} patterns on "
                     f"{label} {tuple(byt.shape)} with {lname}: {hits} "
                     f"accepts; the pack of one on {len(classes)} classes "
                     f"equal; max abs err {err}")
    # past one state word: 320-byte subjects (the label-key width)
    for p in ("a" * 65, ("ab*?" * 75)[:299], "a*" * 150, "a*" * 260):
        byt, lens = glob_subjects(torch, rng, p, 4096, 320)
        lens[:4] = torch.tensor([-1, 0, 320, 325], dtype=torch.int32)
        byt, lens = byt.to(dev), lens.to(dev)
        got = kernels.glob_nfa(p, byt, lens)
        err = max(err, exact(torch, f"glob_nfa m={len(p)} wide", got,
                             kernels.glob_nfa_plain(p, byt, lens)))
        words.add(kernels.glob_words(p))
        say("3", f"K9 glob_nfa m={len(kernels.glob_chars(p))} "
                 f"({kernels.glob_words(p)} state words) on {tuple(byt.shape)}"
                 f": {int(got.sum())} accepts, max abs err {err}")
    if not {2, 8, 16} <= words:
        raise AssertionError(f"glob_nfa state words run: {sorted(words)}")

    # timed at the main path's shape: the pack of the tenant's NFA-route
    # globs over the batch's namespace lane (one launch per family)
    byt, ln = lanes["meta_ns_bytes"], lanes["meta_ns_len"]
    S, W = byt.shape
    (pack,) = kernels.glob_packs(nfa)
    P = len(pack.patterns)
    steps = torch.stack([kernels.glob_nfa_plain(p, byt, ln,
                                                with_steps=True)[1]
                         for p in pack.patterns]).to(torch.int64)
    need = int(steps.sum())
    # memory moves the subjects once (the bytes any pattern of the pack
    # reads; the pairs read them again from shared memory), the lengths,
    # the tables and the (P, S) plane; the operations are the pairs'
    # steps
    subj = int(steps.max(dim=0).values.sum())
    tables = sum(t.nbytes for t in pack.on(dev))
    results["glob_nfa"] = {
        "max_abs_err": err,
        **timed(torch, lambda: kernels.glob_nfa_pack(pack, byt, ln),
                lambda: kernels.glob_nfa_pack_plain(pack, byt, ln),
                plain_eager=True),
        "bound": bound(S * 4 + subj + tables + P * S, need * pack.nw * 6),
        "pack_of_one_ms": graph_ms(
            torch, lambda: kernels.glob_nfa(pack.patterns[0], byt, ln)),
    }
    r = results["glob_nfa"]
    say("3", f"K9 packed over {P} globs x {S} subjects of {W} bytes: "
             f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f}), bound "
             f"{r['bound'][0]:.6f} ms ({need} pair steps, {subj} subject "
             f"bytes, {tables} table bytes, {pack.classes} table rows); the "
             f"pack of one {r['pack_of_one_ms']:.4f} ms x {P} = "
             f"{r['pack_of_one_ms'] * P:.4f} ms")

    # K1's non-ASCII entry alone (what the NFA route's '?' globs launch)
    na = kernels.nonascii(byt, ln)
    nerr = exact(torch, "nonascii", na, kernels.nonascii_plain(byt, ln))
    live = torch.clamp(ln, 0, W).to(torch.int64)
    pos = torch.arange(W, device=dev)[None, :]
    high = (byt >= 0x80) & (pos < live[:, None])
    first = torch.where(high.any(-1), high.to(torch.uint8).argmax(-1) + 1,
                        live)
    nbytes = int(first.sum())
    results["nonascii"] = {
        "max_abs_err": nerr,
        **timed(torch, lambda: kernels.nonascii(byt, ln),
                lambda: kernels.nonascii_plain(byt, ln)),
        "bound": bound(nbytes + S * 4 + S, nbytes),
    }
    say("3", f"K1 nonascii on the namespace lane {tuple(byt.shape)}: "
             f"{int(na.sum())} non-ASCII subjects, max abs err {nerr}; "
             f"{nbytes} bytes up to the first non-ASCII byte or the length")


def check_meta_any(torch, kernels, eng, resources, lanes, batch_n, results):
    """K10 against its plain twin on the tenant policy's namespace list
    (3,264 entries a family: bank columns, K9 pack rows and two
    non-ASCII masks) at the tenant scan shape (the validate program over
    ``lanes``) and the triage shape (the mutate program over the first
    ``batch_n`` resources), with the arguments the evaluator gives it
    (``Ctx.meta_any_args``). Bound: the plane cells of the entries, the
    hash lanes, the masks, the entry table and the two outputs over
    3.35 TB/s; or a compare a cell over 67 TOPS."""
    from kyverno_tpu_torch.tpu.engine import lanes_to_device
    from kyverno_tpu_torch.tpu.evaluator import Ctx, NfaPacks, densify

    cps = eng.cps
    padded, _, _ = eng.pad(resources[:batch_n])
    tri_lanes = lanes_to_device(eng.encode(padded)[0], eng.device)
    shapes = (("scan", lanes, cps.device_programs, cps.nfa_globs),
              ("triage", tri_lanes, cps.mutate_programs,
               cps.mutate_nfa_globs))
    out = []
    for shape, ln, programs, nfa in shapes:
        flt = next(f for p in programs for f in p.match.filters
                   if len(f.namespaces) >= len(TENANT_GLOBS))
        ctx = Ctx(densify(ln), cps.encode_cfg.max_instances, dfa=cps.dfa,
                  nfa=NfaPacks(nfa))
        args = ctx.meta_any_args("namespaces", flt.namespaces)
        table, planes, hashes, is_ns, na = args
        got = kernels.meta_any(*args)
        want = kernels.meta_any_plain(*args)
        err = max(exact(torch, f"K10 meta_any {shape} {w}", g, p)
                  for w, g, p in zip(("hit", "confirm"), got, want))
        N = hashes[0].shape[0]
        E = table.ent.shape[0]
        e_plane = int((table.ent[:, 0] >= 0).sum())
        nbytes = (N * e_plane + sum(h.numel() * 4 for h in hashes)
                  + table.ent.nbytes + N * (1 + sum(m is not None for m in na))
                  + 2 * N)
        r = timed(torch, lambda: kernels.meta_any(*args),
                  lambda: kernels.meta_any_plain(*args))
        r.update({"name": "meta_any", "shape": shape, "N": N, "E": E,
                  "plane_entries": e_plane, "planes": len(planes),
                  "bytes": nbytes, "max_abs_err": err,
                  "bound": bound(nbytes, 2 * N * E), "library_ms": None})
        out.append(r)
        say("3", f"K10 meta_any at the tenant {shape} shape: N {N}, {E} "
                 f"entries ({e_plane} in {len(planes)} planes, "
                 f"{E - e_plane} hash pairs), hits {int(got[0].sum())}, "
                 f"confirms {int(got[1].sum())}, max abs err {err}; "
                 f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f}), plain "
                 f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms "
                 f"({r['bound'][1]}, {nbytes} bytes)")
    results["meta_any"] = out[0]
    results["meta_any_shapes"] = out
    del tri_lanes


def tenant_phase(torch, kernels, eng, resources, batch_n, compile_s, tag):
    """Phase 7: the tenant set's scan and mutate triage. Returns the
    launch counts of the scan and of the triage."""
    import numpy as np

    from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device

    n = len(resources)
    ladder_reset()
    kernels.reset_launches()
    zero_stats(eng.cps.device_fn())
    t0 = time.perf_counter()
    res = eng.scan(resources)
    scan_s = time.perf_counter() - t0
    lv = dict(kernels.LAUNCHES)
    line, st = program_stats(eng.cps.device_fn())
    say("7", f"TorchEngine.scan of {n} tenant resources: {scan_s:.3f} s end "
             f"to end {tag}; launches {lv}")
    say("7", f"the scan's program: {line}")
    for name in TENANT_KERNELS:
        if lv[name] <= 0:
            raise AssertionError(f"tenant scan never launched {name}")
    # one packed K9 launch per lane family (namespace and name)
    if lv["glob_nfa"] > 4 or st["nfa_unpacked"]:
        raise AssertionError(f"tenant scan: {lv['glob_nfa']} K9 launches, "
                             f"{st['nfa_unpacked']} unrecorded NFA globs")
    if res.verdicts.shape != (len(eng.cps.rules), n) or not (
            (res.verdicts >= 0) & (res.verdicts <= 4)).all():
        raise AssertionError("tenant scan: table not complete")
    say("7", "completed table over every rule, codes 0..4: "
             + json.dumps(res.counts()))

    # the program against the same program with the plain twins, on the
    # same lanes
    padded, _, _ = eng.pad(resources)
    t0 = time.perf_counter()
    batch = eng.encode(padded)[0]
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lanes = lanes_to_device(batch, eng.device)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    gv = graph_check(torch, kernels, "7", "the tenant scan program",
                     eng.cps.device_fn(device=eng.device), lanes,
                     eng.cps.device_fn(plain=True), tag)
    say("7", f"scan parts: encode {encode_s:.4f} s, H2D {h2d_ms:.3f} ms, "
             f"program {gv['eager_ms']:.3f} ms eager, {gv['replay_ms']:.3f} ms "
             f"replayed (host clock to a sync) {tag}")
    table, counts = eng.run(lanes)
    dtab = table.cpu().numpy()
    confirm = int((dtab[:, :n] == 6).sum())
    host = int((dtab[:, :n] == 5).sum())
    for ri, e in enumerate(eng.cps.rules):
        if e.device_row is None:
            continue
        d = dtab[e.device_row, :n]
        keep = d < 5
        if not (res.verdicts[ri][keep] == d[keep]).all():
            raise AssertionError(f"tenant row {e.rule_name}: completed table "
                                 "differs on device-decided cells")
    if confirm <= 0:
        raise AssertionError("no CONFIRM cell: the non-ASCII subjects of the "
                             "'?' globs did not reach the scan")
    say("7", f"{confirm} CONFIRM and {host} HOST cells of the device table "
             "completed on the host")
    del lanes, table, counts

    # mutate triage in batches
    eng.triage_dispatches = eng.triage_encode_fallbacks = 0
    kernels.reset_launches()
    zero_stats(eng.cps.mutate_device_fn())
    t0 = time.perf_counter()
    parts = [eng.triage_mutate(resources[i:i + batch_n])
             for i in range(0, n, batch_n)]
    triage_s = time.perf_counter() - t0
    lt = dict(kernels.LAUNCHES)
    line, st = program_stats(eng.cps.mutate_device_fn())
    say("7", f"triage_mutate of {n} in batches of {batch_n}: {triage_s:.3f} s,"
             f" {n / triage_s:.1f} resources/s {tag}; launches {lt}")
    say("7", f"the triage programs: {line}")
    for name in TENANT_KERNELS:
        if lt[name] <= 0:
            raise AssertionError(f"tenant triage never launched {name}")
    if lt["glob_nfa"] > 4 * len(parts) or st["nfa_unpacked"]:
        raise AssertionError(f"tenant triage: {lt['glob_nfa']} K9 launches "
                             f"over {len(parts)} batches, "
                             f"{st['nfa_unpacked']} unrecorded NFA globs")
    if eng.triage_dispatches != len(parts) or eng.triage_encode_fallbacks:
        raise AssertionError(f"{eng.triage_dispatches} device batches, "
                             f"{eng.triage_encode_fallbacks} encode fallbacks "
                             f"for {len(parts)} batches")
    dev_rows, rows = eng.mutate_coverage()
    if dev_rows != rows or rows == 0:
        raise AssertionError(f"mutate coverage {dev_rows}/{rows}")
    tri = np.concatenate([p.verdicts for p in parts], axis=1)
    counts = {k: sum(p.counts()[k] for p in parts)
              for k in ("positive", "negative", "host")}
    if counts["positive"] <= 0 or counts["negative"] <= 0:
        raise AssertionError(f"triage rows {counts}")
    say("7", f"triage rows {counts}; mutate coverage {dev_rows}/{rows} on "
             "the device; no batch took the encode fallback")
    # one batch against the plain-twin triage program
    first = resources[:batch_n]
    padded, _, _ = eng.pad(first)
    t0 = time.perf_counter()
    batch = eng.encode(padded)[0]
    encode_s = time.perf_counter() - t0
    lanes = lanes_to_device(batch, eng.device)
    torch.cuda.synchronize()
    gt = graph_check(torch, kernels, "7", "one tenant triage batch",
                     eng.cps.mutate_device_fn(device=eng.device), lanes,
                     eng.cps.mutate_device_fn(plain=True), tag)
    say("7", f"one triage batch of {len(first)}: encode {encode_s:.4f} s, "
             f"program {gt['eager_ms']:.3f} ms eager, {gt['replay_ms']:.3f} ms "
             f"replayed {tag}; {gt['ops_eager']} aten operations an eager "
             f"run (at most {TRIAGE_OPS_MAX})")
    if gt["ops_eager"] >= TRIAGE_OPS_MAX:
        raise AssertionError(f"a triage batch issues {gt['ops_eager']} aten "
                             f"operations eagerly, want < {TRIAGE_OPS_MAX}")
    del lanes

    # a slice against the CPU run
    small = 96
    cpu = TorchEngine(cps=eng.cps, device="cpu")
    t0 = time.perf_counter()
    if not (cpu.scan(resources[:small]).verdicts == res.verdicts[:, :small]
            ).all():
        raise AssertionError(f"tenant scan differs from the CPU on {small}")
    if not (cpu.triage_mutate(resources[:small]).verdicts == tri[:, :small]
            ).all():
        raise AssertionError(f"tenant triage differs from the CPU on {small}")
    say("7", f"scan and triage of {small} resources equal the CPU run "
             f"({time.perf_counter() - t0:.3f} s on the host)")
    say("7", f"compile {compile_s:.3f} s, scan {scan_s:.3f} s, triage "
             f"{triage_s:.3f} s; glob_nfa launches {lv['glob_nfa']} (scan) + "
             f"{lt['glob_nfa']} (triage) {tag}")
    ladder_check("7")
    return lv, lt, gv, gt


def mutate_leg_phase(torch, kernels, n, tile, tag):
    """Phase 8: bench.py's mutate leg (bench_mutate) at its own sizes.
    Returns the launch counts of the triage over the tiles."""
    import copy

    from kyverno_tpu_torch.api.policy import ClusterPolicy
    from kyverno_tpu_torch.mutation.coordinator import apply_mutations
    from kyverno_tpu_torch.tpu.engine import (TorchEngine, build_scan_context,
                                              lanes_to_device)
    from kyverno_tpu_torch.tpu.evaluator import ERROR, FAIL, HOST, PASS

    def pol(name, rule, overlay):
        return ClusterPolicy.from_dict({
            "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name},
            "spec": {"validationFailureAction": "Enforce", "rules": [{
                "name": rule,
                "match": {"resources": {"kinds": ["Pod"],
                                        "namespaces": ["prod"]}},
                "mutate": {"patchStrategicMerge": overlay}}]}})

    policies = [
        pol("stamp-labels", "labels",
            {"metadata": {"labels": {"+(team)": "core", "env": "prod"}}}),
        pol("stamp-scheduling", "sched",
            {"spec": {"priority": 100, "dnsPolicy": "ClusterFirst"}})]
    eng = TorchEngine(policies)
    nsmap = {"prod": {}, "dev": {}}

    def pod(i, ns):
        return {"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": f"bench-{ns}-{i}", "namespace": ns},
                "spec": {"containers": [{"name": "c", "image": "nginx"}]}}

    resources = [pod(i, "prod" if i % 20 == 0 else "dev") for i in range(n)]
    tiles = [resources[i:i + tile] for i in range(0, n, tile)]
    ladder_reset()
    eng.triage_mutate(tiles[0], nsmap)  # first-use costs outside timing
    padded, _, _ = eng.pad(tiles[0])
    t0 = time.perf_counter()
    batch = eng.encode(padded, nsmap)[0]
    encode_s = time.perf_counter() - t0
    lanes = lanes_to_device(batch, eng.device)
    torch.cuda.synchronize()
    gm = graph_check(torch, kernels, "8", "one mutate-leg tile",
                     eng.cps.mutate_device_fn(device=eng.device), lanes,
                     eng.cps.mutate_device_fn(plain=True), tag)
    del lanes
    say("8", f"one tile of {len(tiles[0])}: encode {encode_s:.4f} s, program "
             f"{gm['eager_ms']:.3f} ms eager, {gm['replay_ms']:.3f} ms "
             f"replayed {tag}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    results = [eng.triage_mutate(t, nsmap) for t in tiles]
    triage_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    routed, negatives = [], []
    for t, res in zip(tiles, results):
        for ci, r in enumerate(t):
            rows = res.rows_for(ci)
            if any(c in (PASS, FAIL, ERROR) or c >= HOST for _, c in rows):
                routed.append((r, rows))
            else:
                negatives.append((r, rows))
    t0 = time.perf_counter()
    outs = [apply_mutations(eng, r, rows, namespace_labels={})
            for r, rows in routed]
    patch_s = time.perf_counter() - t0
    say("8", f"triage_mutate of {n} Pods in tiles of {tile}: "
             f"{triage_s:.4f} s, {n / triage_s:.1f} resources/s {tag}; "
             f"launches {launches}")
    say("8", f"apply_mutations over {len(routed)} routed: {patch_s:.4f} s, "
             f"{len(routed) / patch_s:.1f} patches/s {tag}")
    if len(routed) != -(-n // 20):
        raise AssertionError(f"{len(routed)} routed, want {-(-n // 20)}")
    for name in ("meta_any", "class_fold"):
        if launches[name] <= 0:
            raise AssertionError(f"the mutate leg never launched {name}")

    def scalar_chain(resource):
        patched = copy.deepcopy(resource)
        for p in policies:
            pctx = build_scan_context(p, patched, {}, "CREATE", None)
            resp = eng.scalar.mutate(pctx)
            if resp.patched_resource is not None:
                patched = resp.patched_resource
        return patched

    for (r, _), out in zip(routed, outs):
        if not out.changed or out.patched != scalar_chain(r):
            raise AssertionError(f"{r['metadata']['name']}: patched output "
                                 "differs from the scalar chain")
    templates = sum(o.template_rules for o in outs)
    for r, rows in negatives:
        out = apply_mutations(eng, r, rows, namespace_labels={})
        if out.changed or out.patched is not r or out.scalar_policies \
                or out.template_rules or scalar_chain(r) != r:
            raise AssertionError(f"negative {r['metadata']['name']} was "
                                 "touched")
    say("8", f"all {len(routed)} patched outputs equal the scalar chain "
             f"({templates} template stamps); all {len(negatives)} negatives "
             "come back unchanged")
    untouched = [pod(i, "dev") for i in range(10_000, 10_512)]
    d0 = eng.triage_dispatches
    t0 = time.perf_counter()
    ures = eng.triage_mutate(untouched, nsmap)
    untouched_s = time.perf_counter() - t0
    calls = 0
    for ci, r in enumerate(untouched):
        out = apply_mutations(eng, r, ures.rows_for(ci), namespace_labels={})
        calls += out.scalar_policies + out.template_rules
    uc = ures.counts()
    if eng.triage_dispatches - d0 != 1 or calls or uc["positive"] or uc["host"]:
        raise AssertionError(f"all-negative batch: "
                             f"{eng.triage_dispatches - d0} dispatches, "
                             f"{calls} patcher calls, rows {uc}")
    say("8", f"all-negative batch of {len(untouched)}: one device dispatch, "
             f"no patcher call, {untouched_s:.4f} s {tag}")
    ladder_check("8")
    return launches, gm


def fault_phase(torch, kernels, eng, scanner, tenant, resources, ops,
                tenant_res, tag):
    """Phase 9: the guarded dispatch ladder on the card. Every table
    must equal the clean scan's and the CPU run's; fallbacks are counted
    here (the only phase where they are expected)."""
    import numpy as np

    from kyverno_tpu_torch.mutation.coordinator import apply_mutations
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.resilience.breaker import CLOSED, OPEN, tpu_breaker
    from kyverno_tpu_torch.resilience.faults import (SITE_MUTATE_TRIAGE,
                                                     SITE_TPU_DISPATCH,
                                                     global_faults)
    from kyverno_tpu_torch.tpu.engine import TorchEngine
    from kyverno_tpu_torch.tpu.evaluator import HOST

    def fallbacks():
        return {r: int(global_registry.breaker_fallback.value({"reason": r}))
                for r in ("error", "open")}

    def check(name, got, want):
        if got.rules != want.rules or not np.array_equal(got.verdicts,
                                                         want.verdicts):
            raise AssertionError(f"fault phase: {name} differs")

    ladder_reset()
    breaker = tpu_breaker()
    res, rops = resources[:64], ops[:64]
    cpu = TorchEngine(cps=eng.cps, device="cpu")
    clean = eng.scan(res, operations=rops)
    check("the clean scan against the CPU run", clean,
          cpu.scan(res, operations=rops))
    breaker.reset(failure_threshold=2, reset_timeout_s=600.0)
    global_faults.arm(SITE_TPU_DISPATCH, mode="raise", p=1.0)
    for i, want_state in enumerate((CLOSED, OPEN)):
        check(f"scan under an armed dispatch fault ({i + 1})",
              eng.scan(res, operations=rops), clean)
        if breaker.state != want_state:
            raise AssertionError(f"breaker {breaker.state} after {i + 1} "
                                 f"failures, want {want_state}")
    fired = global_faults.armed()[SITE_TPU_DISPATCH].fired
    check("scan with the breaker open", eng.scan(res, operations=rops), clean)
    if global_faults.armed()[SITE_TPU_DISPATCH].fired != fired \
            or fallbacks() != {"error": 2, "open": 1}:
        raise AssertionError(f"open breaker: fault fired again or fallbacks "
                             f"{fallbacks()}")
    say("9", "armed tpu.dispatch fault: two failures trip the breaker, the "
             "third scan never tries the device; all three tables equal the "
             f"clean scan and the CPU run; breaker_fallback {fallbacks()}")
    global_faults.disarm()
    breaker.reset(failure_threshold=1, reset_timeout_s=0.0)
    global_faults.arm(SITE_TPU_DISPATCH, mode="corrupt", count=1)
    check("scan under a corrupt-shape fault", eng.scan(res, operations=rops),
          clean)
    if breaker.state != OPEN:
        raise AssertionError(f"corrupt shape: breaker {breaker.state}")
    check("the half-open probe", eng.scan(res, operations=rops), clean)
    if breaker.state != CLOSED:
        raise AssertionError(f"half-open probe: breaker {breaker.state}")
    say("9", "corrupt-shape fault: a device failure (breaker open), the "
             "half-open probe closes it; tables equal the clean scan")
    global_faults.disarm()
    breaker.reset()
    hostile = {"metadata: \"x\"": {"apiVersion": "v1", "kind": "Pod",
                                    "metadata": "x"},
               "kind: 7": {"apiVersion": "v1", "kind": 7,
                           "metadata": {"name": "k", "namespace": "d"}},
               "metadata.namespace: [\"x\"]": {
                   "apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": "n", "namespace": ["x"]}}}
    for name, h in hostile.items():
        batch, bops = [res[0], h, res[1]], [rops[0], "", rops[1]]
        want = cpu.scan(batch, operations=bops)
        check(f"TorchEngine.scan with {name}",
              eng.scan(batch, operations=bops), want)
        check(f"ShardedScanner.scan with {name}",
              scanner.scan(batch, operations=bops), want)
        if not np.array_equal(want.verdicts[:, [0, 2]],
                              clean.verdicts[:, :2]):
            raise AssertionError(f"{name}: the good resources changed")
    say("9", f"hostile resources {list(hostile)}: TorchEngine.scan and "
             "ShardedScanner.scan equal the CPU run, the good resources keep "
             "their clean verdicts")
    e0 = fallbacks()["error"]
    global_faults.arm(SITE_TPU_DISPATCH, mode="raise", count=1)
    check("ShardedScanner.scan under a dispatch fault",
          scanner.scan(res, operations=rops), clean)
    if fallbacks()["error"] != e0 + 1 or breaker.state != CLOSED:
        raise AssertionError("ShardedScanner.scan: the fault was not a "
                             "counted device failure")
    global_faults.disarm()
    trs = tenant_res[:48]
    tclean = tenant.triage_mutate(trs)
    global_faults.arm(SITE_MUTATE_TRIAGE, mode="raise")
    tfault = tenant.triage_mutate(trs)
    global_faults.disarm()
    if not (tfault.verdicts == HOST).all() or tfault.rules != tclean.rules:
        raise AssertionError("mutate.triage fault: the batch is not all-HOST")
    for ci, r in enumerate(trs):
        a = apply_mutations(tenant, r, tfault.rows_for(ci))
        b = apply_mutations(tenant, r, tclean.rows_for(ci))
        if a.patched != b.patched:
            raise AssertionError(f"mutate.triage fault: resource {ci} "
                                 "patches differently")
    say("9", f"ShardedScanner.scan under a dispatch fault equals the clean "
             f"scan (all-HOST, completed on the host); mutate.triage fault: "
             f"{len(trs)} resources all-HOST, patched as the clean triage "
             f"routes them; breaker_fallback {fallbacks()} {tag}")
    ladder_reset()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--n", type=int, default=16384,
                    help="resources in the dense-path scan")
    ap.add_argument("--scan-n", type=int, default=100000,
                    help="resources in the background scan's snapshot")
    ap.add_argument("--tile", type=int, default=8192,
                    help="resources per background-scan tile")
    ap.add_argument("--tenant-n", type=int, default=16384,
                    help="resources in the tenant scan and triage")
    ap.add_argument("--tenant-batch", type=int, default=1024,
                    help="resources per tenant triage batch")
    ap.add_argument("--mutate-n", type=int, default=4000,
                    help="Pods in the mutate leg (bench.py bench_mutate)")
    ap.add_argument("--mutate-tile", type=int, default=1024,
                    help="Pods per mutate-leg triage tile")
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
    # the tenant set: PSS plus a policy whose namespace globs overflow
    # the DFA bank
    t0 = time.perf_counter()
    tenant = TorchEngine(policies + [expand_policy(tenant_policy())])
    tenant_compile_s = time.perf_counter() - t0
    in_bank = [g for g in TENANT_GLOBS if g in tenant.cps.dfa.glob_ids]
    nfa = [g for g in TENANT_GLOBS if g not in tenant.cps.dfa.glob_ids]
    say("7", f"compiled PSS + tenant ({len(TENANT_GLOBS)} namespace globs) in "
             f"{tenant_compile_s:.3f} s {tag}: {len(tenant.cps.dfa.patterns)} "
             f"bank patterns, {sum(p.n_states for p in tenant.cps.dfa.patterns)}"
             f" states; tenant globs {len(in_bank)} in the bank, {len(nfa)} on "
             f"the NFA route ({sum('?' in g for g in nfa)} with '?'); coverage "
             f"{tenant.coverage()}, mutate {tenant.mutate_coverage()}")
    if (len(in_bank), len(nfa)) != TENANT_SPLIT or len(nfa) < 200:
        raise AssertionError(f"tenant bank split {(len(in_bank), len(nfa))}, "
                             f"want {TENANT_SPLIT}")
    tenant_res = tenant_workload(args.tenant_n, args.seed + 20, in_bank, nfa)
    tpadded, _, _ = tenant.pad(tenant_res)
    tenant_lanes = lanes_to_device(tenant.encode(tpadded)[0], tenant.device)
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
    check_glob_nfa(torch, kernels, tenant_lanes, nfa, args.seed + 6, results)
    check_dfa_tenant(torch, kernels, dfa_mod, tenant.cps.dfa, tenant_lanes,
                     results)
    check_meta_any(torch, kernels, tenant, tenant_res, tenant_lanes,
                   args.tenant_batch, results)
    del lanes, tile_lanes, tenant_lanes

    # phase 4: the dense path through the user's entry point
    dense, g_dense = dense_phase(torch, kernels, eng, policies, resources,
                                 ops, padded, pops, args.n, tag, results)
    # phase 5: the background scan through the user's entry point
    scan, g_step = scan_phase(torch, kernels, scanner, policies, args.scan_n,
                              args.tile, args.seed + 10, tag)
    # phase 7: the tenant set's scan and triage
    tv, tt, g_tv, g_tt = tenant_phase(torch, kernels, tenant, tenant_res,
                                      args.tenant_batch, tenant_compile_s,
                                      tag)
    # phase 8: bench.py's mutate leg
    leg, g_leg = mutate_leg_phase(torch, kernels, args.mutate_n,
                                  args.mutate_tile, tag)
    # phase 9: the guarded dispatch ladder under faults
    fault_phase(torch, kernels, eng, scanner, tenant, resources, ops,
                tenant_res, tag)
    for path, gr in zip(PATHS, (g_dense, g_step, g_tv, g_tt, g_leg)):
        say("6", f"graphs {path}: eager {gr['eager_ms']:.3f} ms, replay "
                 f"{gr['replay_ms']:.3f} ms, captures {gr['captures']}, aten "
                 f"operations {gr['ops_eager']} eager / {gr['ops_replay']} "
                 f"replayed, {gr['replay_events']} device events a replay "
                 f"({gr['replay_device_ms']:.3f} ms), K11 launches "
                 f"{gr['fold_checked']} (checked), fold_forced "
                 f"{gr['fold_forced']}, bound {gr['bound_ms']:.4f} ms "
                 f"({gr['io_bytes']} bytes) {tag}")

    # phase 6: the kernels line, then the device line
    by_path = dict(zip(PATHS, (dense, scan, tv, tt, leg)))
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        r = results[name]
        b_ms, b_by = r["bound"]
        per = {p: launches.get(name, 0) for p, launches in by_path.items()}
        n_launch = sum(per.values())
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": n_launch,
                    "launches_by_path": per,
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": r["library_ms"]})
        lib = r["library_ms"]
        say("6", f"{name}: {r['ms']:.4f} ms (graph replay; eager "
                 f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                 f"bound {b_ms:.4f} ms ({b_by}), library "
                 f"{'none' if lib is None else f'{lib:.4f} ms'}, launches "
                 + ", ".join(f"{p} {k}" for p, k in per.items()) + f" {tag}")
        if n_launch <= 0:
            raise AssertionError(f"{name} was launched on no path")
    # K1 at the tenant bank's shapes, beside the rows above
    by_name = {e["name"]: e for e in out}
    for r in results["meta_any_shapes"]:
        b_ms, b_by = r["bound"]
        by_name["meta_any"].setdefault("tenant_shapes", []).append({
            k: r[k] for k in ("shape", "N", "E", "plane_entries", "planes",
                              "bytes", "ms", "eager_ms", "plain_ms")}
            | {"bound_ms": b_ms, "bound_by": b_by})
    for r in results["dfa_tenant"]:
        b_ms, b_by = r["bound"]
        by_name[r["name"]].setdefault("tenant_shapes", []).append({
            k: r[k] for k in ("family", "shape", "K", "S", "W", "steps",
                              "table_bytes", "ms", "eager_ms", "plain_ms",
                              "chunk_ms")}
            | {"bound_ms": b_ms, "bound_by": b_by})
        say("6", f"{r['name']} tenant {r['family']} {r['shape']} (K "
                 f"{r['K']}, S {r['S']}): {r['ms']:.4f} ms (eager "
                 f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                 f"bound {b_ms:.6f} ms ({b_by}) {tag}")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
