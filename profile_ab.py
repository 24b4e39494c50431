#!/usr/bin/env python3
"""One tree's K12 kernel on tapes of one lane kind, its K7, K4, K8 and
K1 kernels at the main paths' shapes, and one mutate-leg tile's replay:
the parts that compare two commits on one card.

    python3 profile_ab.py [--root DIR] [--samples 200] [--out FILE]
        [--parts k12,k7,k4,k8,mutate,k1]

Imports ``kyverno_tpu_torch`` from ``--root`` (default: this script's
checkout) and ``chip_smoke.py``'s helpers from this script's own
checkout. Run it once a tree, in turns (parent, change, change,
parent), in one call on one card. It reports:

- K12 ``row_fold`` on a seeded row tape over 12 lanes of one kind at
  the dense shape (16,384, 256): uint8 lanes (``== k``), int32 lanes
  (``== k``), float32 lanes (scaled, ``> k``) and int32 hash lane pairs
  (a set of one pair); every compare's ``any``, and the OR of all of
  them counted and stored. Each launch equals its plain twin, exactly;
  time: CUDA events around one replay of 20 launches in a CUDA graph
  (``chip_smoke.graph_ms``); bytes: each input read once, each output
  written once.
- K7 ``pool_rows`` alone at each shape the main paths launch it with
  (``K7_SHAPES``: the background tile, the dense program and the tenant
  scan's two plane layouts), on a seeded plane of K = 32 (a column of a
  bool bank, so strided as on the paths) and a seeded slot lane (three
  cells in four -1, as padding, the rest in [0, K)); each launch equals
  its plain twin, exactly; time: ``chip_smoke.rotated_ms`` (copies of
  the inputs rotated through four times the L2, so they come from
  memory) beside the byte bound (``chip_smoke.pool_bytes``).
- K4 ``verdict_counts`` at each shape the main paths launch it with
  (``K4_SHAPES``: the dense program's (66, 16,384) table, the tenant
  scan's (69, 16,384), the background step's (66, 8,192) with its uint8
  output) on a seeded table of the codes 0..6, and K8
  ``first_true_take`` at each of its shapes (``K8_SHAPES``: the
  background tile's (8,192, 128), the dense and tenant programs'
  (16,384, 256)) on seeded masks (``chip_smoke.take_masks``: one
  resource in five with a true row, as chip_smoke's workload annotates
  one in five); each launch equals its plain twin, exactly; time on the
  seeded inputs (L2-warm, as the path finds a table or mask just
  written; ``chip_smoke.graph_ms``) and on rotated copies
  (``chip_smoke.rotated_ms``), beside the byte bound
  (``chip_smoke.kept_work``) and one launch's floor;
- on a tree whose K4 takes a launch plan (``kernels.verdict_counts_plan``),
  K4 at each of those shapes under every plan of ``K4_PLANS`` (C blocks
  a rule, threads a block; C = 1 takes no cluster barrier), each launch
  equal to its twin, timed on the seeded table and on rotated copies:
  the sweep the plan function's choice rests on;
- K1 (``dfa_scan_stride1`` / ``dfa_scan_fused``) at the shapes the
  main paths launch it with: the PSS bank's pool family over the dense
  batch (16,384 ``chip_smoke.workload`` resources) and the tenant
  bank's ``ns`` and ``name`` families over 16,384 tenant resources
  (``chip_smoke.tenant_workload``) at the scan shape and the first
  1,024 rows (the triage shape), each stride group alone, without and
  with the non-ASCII flag; and the standalone non-ASCII entry on seeded
  accented subjects (``chip_smoke.accented``) at (16,384, 64) and
  (1,024, 64), beside a launch's floor. Every launch and flag equals its
  plain twin; time: ``chip_smoke.graph_ms``;
- ``chip_smoke.py``'s phase-8 tile (bench.py's mutate leg, 1,024 Pods):
  its program's replay, ``--samples`` calls each timed on the host clock
  to a sync (median, 10th and 90th percentiles) beside the host time to
  issue one call, and one replay's device events and device time
  (``torch.profiler``, ``chip_smoke.device_profile``).

It prints the card's name and power limit first and one JSON object
last. It imports nothing of JAX and nothing of ``kyverno_tpu``.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KINDS = ("u8", "i32", "f32", "hash")
N, R, LANES = 16384, 256, 12
# K7 on the main paths: (label, (N, R), planes a bank row (the plane's
# stride over K; 1: a contiguous plane)); K = 32 on every path
K7_SHAPES = (("tile", (8192, 128), 2), ("dense", (16384, 256), 2),
             ("tenant (96, 3)", (16384, 256), 3),
             ("tenant (32, 1)", (16384, 256), 1))

# K4 on the main paths: (label, rules, N, uint8 output)
K4_SHAPES = (("dense", 66, 16384, False), ("tenant", 69, 16384, False),
             ("step", 66, 8192, True))
# K8 on the main paths: (label, N, R); the tenant scan's shape is the
# dense one
K8_SHAPES = (("tile", 8192, 128), ("dense", 16384, 256))
K8_SHARE = 0.2
# K4 launch plans swept: (C, threads)
K4_PLANS = ((1, 512), (1, 1024), (2, 256), (2, 512), (4, 128), (4, 256),
            (8, 128), (8, 256))


def tape(torch, fold, rowfold, kind, N, R, n_lanes, gen, dev):
    """A row tape over ``n_lanes`` seeded lanes of one kind and the
    flush's outputs ((op, value id) pairs)."""
    ft = fold.Tape(N, 1, 1, dev, fold.FoldCache(), False)
    rt = rowfold.RowTape(N, R, dev, rowfold.RowCache(), False, ft)

    def lane(dtype, hi):
        x = torch.randint(0, hi, (N, R), generator=gen, dtype=torch.int32)
        return x.to(dtype).to(dev)

    vals = []
    if kind == "hash":
        for i in range(n_lanes // 2):
            vals.append(rt.heq(lane(torch.int32, 4), lane(torch.int32, 4),
                               [(i % 4, (i + 1) % 4)]))
    else:
        for i in range(n_lanes):
            if kind == "f32":
                x = torch.rand((N, R), generator=gen).mul_(100.0).to(dev)
                vals.append(rt.lane(x) * 0.5 > float(4 * i))
            else:
                dtype = torch.uint8 if kind == "u8" else torch.int32
                vals.append(rt.lane(lane(dtype, 8)) == i % 8)
    acc = vals[0]
    for v in vals[1:]:
        acc = acc | v
    outs = [(rowfold.ANY, v.vid) for v in vals]
    outs += [(rowfold.COUNT, acc.vid), (rowfold.STORE, acc.vid)]
    return rt, outs


def k12_case(torch, kernels, fold, rowfold, cs, kind, N, R, n_lanes, seed,
             dev):
    gen = torch.Generator().manual_seed(seed)
    rt, outs = tape(torch, fold, rowfold, kind, N, R, n_lanes, gen, dev)
    segs = rowfold.compile_rows(rt.code, rt.etypes, outs)

    def dests():
        return [torch.empty((N, R) if op == rowfold.STORE else (N,),
                            dtype=torch.int32 if op == rowfold.COUNT
                            else torch.bool, device=dev) for op, _ in outs]

    got, want = dests(), dests()
    launches = []
    for seg in segs:
        ios = [rt.inputs[i] for i in seg.ins]
        kernels.row_fold(seg.code, ios + [got[k] for k in seg.outs], N, R)
        kernels.row_fold_plain(seg.code, ios + [want[k] for k in seg.outs],
                               N, R)
        launches.append((seg.code, ios + [got[k] for k in seg.outs]))
    torch.cuda.synchronize()
    err = max(cs.exact(torch, "row_fold", g, w) for g, w in zip(got, want))

    def k12():
        for code, ios in launches:
            kernels.row_fold(code, ios, N, R)

    ms = cs.graph_ms(torch, k12)
    nbytes = sum(t.numel() * t.element_size() for t in rt.inputs) \
        + sum(t.numel() * t.element_size() for t in got)
    return {"lanes": len(rt.inputs), "launches": len(segs),
            "instructions": sum(len(s.code.rows) for s in segs), "ms": ms,
            "bytes": nbytes, "tb_s": nbytes / (ms * 1e-3) / 1e12,
            "max_abs_err": err}


def k7_case(torch, kernels, cs, shape, planes, seed, dev):
    """K7 alone at one main-path shape on rotated copies of seeded
    inputs, held against its plain twin."""
    gen = torch.Generator().manual_seed(seed)
    n, r = shape
    bank = torch.randint(0, 2, (n, 32, planes), generator=gen,
                         dtype=torch.uint8).to(torch.bool).to(dev)
    plane = bank[..., 0]
    slot = torch.randint(0, 32, shape, generator=gen, dtype=torch.int32)
    pad = torch.randint(0, 4, shape, generator=gen) != 0
    slot = torch.where(pad, torch.full_like(slot, -1), slot).to(dev)
    err = cs.exact(torch, "pool_rows", kernels.pool_rows(plane, slot),
                   kernels.pool_rows_plain(plane, slot))
    nbytes = cs.pool_bytes(plane, slot)
    return {"shape": list(shape), "strides": list(plane.stride()),
            "ms": cs.rotated_ms(torch, kernels.pool_rows, [plane, slot],
                                nbytes),
            "bound_ms": cs.bound(nbytes, 0)[0], "max_abs_err": err}


def take_count_case(torch, kernels, cs, name, args):
    """K4 or K8 on seeded inputs: equal to its plain twin, timed on the
    inputs (L2-warm) and on rotated copies, beside its bound."""
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    got, want = fn(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(cs.exact(torch, name, g, w) for g, w in zip(got, want))
    nbytes, ops = cs.kept_work(name, args)
    return {"shape": list(args[0].shape),
            "ms": cs.graph_ms(torch, lambda: fn(*args)),
            "rotated_ms": cs.rotated_ms(torch, fn, list(args), nbytes),
            "bound_ms": cs.bound(nbytes, ops)[0], "bytes": nbytes,
            "floor_ms": cs.launch_floor_ms(torch), "max_abs_err": err}


def k4_plans(torch, kernels, cs, table, u8):
    """K4 on ``table`` under each plan of ``K4_PLANS`` (16-byte form),
    each held against its twin: {"C x threads": (ms, rotated ms)}."""
    rules, n = table.shape
    want = kernels.verdict_counts_plain(table)
    out = torch.empty((rules, 7), dtype=torch.int32, device=table.device)
    out8 = torch.empty((rules, n), dtype=torch.uint8,
                       device=table.device) if u8 else None
    got = {}
    for C, threads in K4_PLANS:
        # the tree's _call takes the launch's device where its kernel
        # state is kept per device; an older tree's does not
        dev = (table.device,) if "device" in inspect.signature(
            kernels._call).parameters else ()

        def k4(t=table):
            kernels._call("verdict_counts", *dev, kernels._ptr(t), rules, n,
                          kernels._ptr(out), kernels._ptr(out8), C, threads,
                          1)

        out.zero_()
        k4()
        cs.exact(torch, f"verdict_counts plan {C} x {threads}", out, want)
        got[f"{C} x {threads}"] = (
            cs.graph_ms(torch, k4),
            cs.rotated_ms(torch, k4, [table], cs.counts_bytes(table, u8)))
    return got


def mutate_tile(torch, cs, samples):
    from kyverno_tpu_torch.tpu.engine import lanes_to_device

    eng, _, tiles, nsmap = cs.mutate_leg_setup(1024, 1024)
    eng.triage_mutate(tiles[0], nsmap)  # first-use costs
    padded, _, _ = eng.pad(tiles[0])
    lanes = lanes_to_device(eng.encode(padded, nsmap)[0], eng.device)
    g = eng.cps.mutate_device_fn(device=eng.device)
    for _ in range(3):  # eager, capture, replay
        g(lanes)
    torch.cuda.synchronize()
    issue, total = [], []
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g(lanes)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        issue.append((t1 - t0) * 1e3)
        total.append((t2 - t0) * 1e3)

    def q(xs, p):
        return sorted(xs)[min(len(xs) - 1, int(p * len(xs)))]

    prof = cs.device_profile(torch, lambda: g(lanes))
    return {"samples": samples, "replay_ms_median": statistics.median(total),
            "replay_ms_p10": q(total, 0.1), "replay_ms_p90": q(total, 0.9),
            "issue_ms_median": statistics.median(issue),
            "device_events": prof["device_events"],
            "device_ms": prof["device_ms"], "captures": g.captures,
            "replays": g.replays}


def k1_cases(torch, kernels, cs, card, seed=0):
    """K1 and the standalone non-ASCII entry at the main paths' shapes
    (see the module docstring): a list of rows."""
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.policy.autogen import expand_policy
    from kyverno_tpu_torch.tpu import dfa as dfa_mod
    from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device

    dev = torch.device("cuda")
    policies = [expand_policy(p) for p in load_pss_policies()]
    eng = TorchEngine(policies)
    res, ops = cs.workload(N, seed)
    padded, pops, _ = eng.pad(res, ops)
    dense = lanes_to_device(eng.encode(padded, None, pops)[0], dev)
    tenant = TorchEngine(policies + [expand_policy(cs.tenant_policy())])
    in_bank = [g for g in cs.TENANT_GLOBS if g in tenant.cps.dfa.glob_ids]
    nfa = [g for g in cs.TENANT_GLOBS if g not in tenant.cps.dfa.glob_ids]
    tres = cs.tenant_workload(N, seed + 20, in_bank, nfa)
    tpadded, _, _ = tenant.pad(tres)
    tl = lanes_to_device(tenant.encode(tpadded)[0], dev)
    cases = [("dense pool", eng.cps.dfa, "pool",
              dense["pool"].reshape(-1, dense["pool"].shape[-1]),
              dense["pool_len"].reshape(-1), None)]
    for family in ("ns", "name"):
        for shape, n in (("scan", N), ("triage", 1024)):
            cases.append((f"tenant {family} {shape}", tenant.cps.dfa,
                          family, tl[f"meta_{family}_bytes"][:n],
                          tl[f"meta_{family}_len"][:n], None))
    rows = []
    for label, bank, family, byt, ln, _ in cases:
        b, l = byt.contiguous(), ln.to(torch.int32).contiguous()
        ids = bank.families[family]
        for tiles in dfa_mod.scan_groups(bank, ids, dev):
            kfn = kernels.dfa_scan_stride1 if tiles.kind == "stride1" \
                else kernels.dfa_scan_fused
            out = torch.empty((b.shape[0], tiles.width), dtype=torch.bool,
                              device=dev)
            got, na = kfn(b, l, tiles, out, want_nonascii=True)
            cs.exact(torch, f"K1 {label} {tiles.kind}", got[:, tiles.cols],
                     tiles.plain_scan(b, l))
            cs.exact(torch, f"K1 {label} {tiles.kind} flag", na,
                     kernels.nonascii_plain(b, l))
            r = {"label": label, "entry": tiles.kind,
                 "shape": list(b.shape), "K": int(tiles.cols.numel()),
                 "ms": cs.graph_ms(torch, lambda: kfn(b, l, tiles, out)),
                 "flag_ms": cs.graph_ms(torch, lambda: kfn(
                     b, l, tiles, out, want_nonascii=True))}
            rows.append(r)
            print(f"K1 {tiles.kind} {label} {tuple(b.shape)}, K {r['K']}: "
                  f"{r['ms']:.4f} ms, with the non-ASCII flag "
                  f"{r['flag_ms']:.4f} ms; equal to the plain twins "
                  f"({card})", flush=True)
    gen = torch.Generator().manual_seed(seed + 7)
    floor = cs.launch_floor_ms(torch)
    for S in (N, 1024):
        b, l = cs.accented(torch, gen, S, 64, dev)
        cs.exact(torch, f"nonascii ({S}, 64)", kernels.nonascii(b, l),
                 kernels.nonascii_plain(b, l))
        r = {"label": "nonascii alone", "entry": "nonascii",
             "shape": [S, 64], "floor_ms": floor,
             "ms": cs.graph_ms(torch, lambda: kernels.nonascii(b, l))}
        rows.append(r)
        print(f"nonascii alone ({S}, 64), seeded: {r['ms']:.4f} ms, a "
              f"launch's floor {floor:.4f} ms ({card})", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--samples", type=int, default=200)
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts", default="k12,k7,k4,k8,mutate,k1",
                    help="comma-separated parts to run")
    args = ap.parse_args()
    parts = set(args.parts.split(","))

    import torch

    if not torch.cuda.is_available():
        print("profile_ab: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # this checkout's helpers, whichever tree the package comes from
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from kyverno_tpu_torch import kernels
    from kyverno_tpu_torch.tpu import fold, rowfold

    if not kernels.__file__.startswith(root + os.sep):
        raise AssertionError(f"kyverno_tpu_torch from {kernels.__file__}, "
                             f"not {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    out = {"root": root, "card": card, "torch": torch.__version__,
           "N": N, "R": R, "k12": {}}
    for i, kind in enumerate(KINDS if "k12" in parts else ()):
        r = out["k12"][kind] = k12_case(torch, kernels, fold, rowfold, cs,
                                        kind, N, R, LANES, i, dev)
        print(f"row_fold, {r['lanes']} {kind} lanes at ({N}, {R}):"
              f" {r['ms']:.4f} ms, {r['launches']} launches, {r['bytes']} "
              f"bytes ({r['tb_s']:.3f} TB/s), max abs err "
              f"{r['max_abs_err']} ({card})", flush=True)
    out["k7"] = {}
    for i, (label, shape, planes) in enumerate(
            K7_SHAPES if "k7" in parts else ()):
        r = out["k7"][label] = k7_case(torch, kernels, cs, shape, planes, i,
                                       dev)
        print(f"pool_rows {label} at {tuple(shape)}, plane strides "
              f"{tuple(r['strides'])}: {r['ms']:.4f} ms a launch on rotated "
              f"copies, bound {r['bound_ms']:.4f} ms, max abs err "
              f"{r['max_abs_err']} ({card})", flush=True)
    out["k4"], out["k8"] = {}, {}
    for i, (label, rules, n, u8) in enumerate(
            K4_SHAPES if "k4" in parts else ()):
        gen = torch.Generator().manual_seed(100 + i)
        table = torch.randint(0, 7, (rules, n), generator=gen,
                              dtype=torch.int32).to(dev)
        name = "verdict_counts_u8" if u8 else "verdict_counts"
        r = out["k4"][label] = take_count_case(torch, kernels, cs, name,
                                               (table,))
        print(f"{name} {label} at ({rules}, {n}): {r['ms']:.4f} ms on the "
              f"seeded table, {r['rotated_ms']:.4f} ms on rotated copies, "
              f"bound {r['bound_ms']:.5f} ms, a launch's floor "
              f"{r['floor_ms']:.4f} ms, max abs err {r['max_abs_err']} "
              f"({card})", flush=True)
        if hasattr(kernels, "verdict_counts_plan"):
            r["plans"] = k4_plans(torch, kernels, cs, table, u8)
            print(f"{name} {label} by plan (C x threads: ms, rotated ms): "
                  + "; ".join(f"{k}: {a:.4f}, {b:.4f}"
                              for k, (a, b) in r["plans"].items())
                  + f" ({card})", flush=True)
    for i, (label, n, r_) in enumerate(K8_SHAPES if "k8" in parts else ()):
        masks = cs.take_masks(torch, n, r_, K8_SHARE, 200 + i, dev)
        r = out["k8"][label] = take_count_case(torch, kernels, cs,
                                               "first_true_take", masks)
        print(f"first_true_take {label} at ({n}, {r_}): {r['ms']:.4f} ms on "
              f"the seeded masks, {r['rotated_ms']:.4f} ms on rotated "
              f"copies, bound {r['bound_ms']:.5f} ms, a launch's floor "
              f"{r['floor_ms']:.4f} ms, max abs err {r['max_abs_err']} "
              f"({card})", flush=True)
    if "k1" in parts:
        out["k1"] = k1_cases(torch, kernels, cs, card)
    if "mutate" in parts:
        m = out["mutate_tile"] = mutate_tile(torch, cs, args.samples)
        print(f"mutate-leg tile replay: median {m['replay_ms_median']:.4f} "
              f"ms (p10 {m['replay_ms_p10']:.4f}, p90 "
              f"{m['replay_ms_p90']:.4f}) of {m['samples']}, issue "
              f"{m['issue_ms_median']:.4f} ms; one replay "
              f"{m['device_events']} device events, {m['device_ms']:.4f} ms "
              f"of device time ({card})", flush=True)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
