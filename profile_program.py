#!/usr/bin/env python3
"""Where the dense PSS program's operations and device time go.

    python3 profile_program.py [--n 16384] [--seed 0] [--device cuda]
        [--out profile_program.json]

Builds ``TorchEngine`` over the 18 PSS policies (66 device rules) and
``chip_smoke.py``'s seeded workload of ``--n`` resources, encodes it
once, and reports for the compiled program (``cps.device_fn()``):

- the non-view aten operations one eager run dispatches, by the shape
  kind of their output ((N,), (N, I), (N, I, J): class logic; (N, R):
  row planes; 0-d; other) and by the innermost evaluator call site
  (``chip_smoke.SITES``);
- on a card: the device time of one eager run by call site (each site
  under a ``torch.profiler.record_function`` range, a kernel charged to
  the range that launched it) and by kernel name; then the device
  events of one replay of the program's CUDA graph and the 15 kernels
  that take the most device time in it;
- the program's ``stats`` of one run.

With ``--device cpu`` it reports the operation census alone (no device
time exists there). The card's name and power limit head the output.
It imports nothing of JAX and nothing of ``kyverno_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.policy.autogen import expand_policy
    from kyverno_tpu_torch.tpu import evaluator as ev
    from kyverno_tpu_torch.tpu.engine import TorchEngine, lanes_to_device

    cuda = args.device != "cpu"
    if cuda and not torch.cuda.is_available():
        print("profile_program: no CUDA device", file=sys.stderr)
        return 2
    card = "cpu (no card)"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    policies = [expand_policy(p) for p in load_pss_policies()]
    eng = TorchEngine(policies, device=args.device)
    resources, ops = cs.workload(args.n, args.seed)
    padded, pops, _ = eng.pad(resources, ops)
    lanes = lanes_to_device(eng.encode(padded, None, pops)[0], eng.device)
    N, R = lanes["norm_hi"].shape
    I = eng.cps.encode_cfg.max_instances
    run = eng.cps.device_fn()
    run(lanes)  # builds the kernels and what the program keeps
    out = {"card": card, "torch": torch.__version__, "N": N, "R": R, "I": I,
           "rules": len(eng.cps.device_programs)}
    for k in run.stats:
        run.stats[k] = 0
    with cs.Sites(ev) as sites:
        out["eager_ops"] = cs.op_census(torch, lambda: run(lanes), N, I, R,
                                        sites)
    out["stats"] = dict(run.stats)
    if cuda:
        with cs.Sites(ev) as sites:
            out["eager_device"] = cs.device_profile(
                torch, lambda: run(lanes), sites)
        graph = eng.cps.device_fn(device=eng.device)
        graph(lanes)
        graph(lanes)  # the bucket's second call captures
        out["replay_device"] = cs.device_profile(torch, lambda: graph(lanes))
        out["replay_ops"] = cs.op_census(torch, lambda: graph(lanes), N, I,
                                         R)["total"]
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({k: out[k] for k in ("card", "N", "R", "I", "rules",
                                           "stats")}))
    e = out["eager_ops"]
    print(f"eager aten operations {e['total']}, by kind {e['by_kind']}; "
          f"class logic {e['class_logic']}")
    for site, kinds in sorted(e["by_site"].items(),
                              key=lambda kv: -sum(kv[1].values())):
        print(f"  ops {site}: {sum(kinds.values())} {kinds}")
    if cuda:
        d = out["eager_device"]
        print(f"eager device: {d['device_events']} events, "
              f"{d['device_ms']:.3f} ms ({card})")
        for site, ms in d["by_site_ms"].items():
            print(f"  device ms {site}: {ms:.3f}")
        r = out["replay_device"]
        print(f"replay device: {r['device_events']} events, "
              f"{r['device_ms']:.3f} ms, {r['kernels']} kernel names, "
              f"{out['replay_ops']} aten operations a replayed call ({card})")
        for t in r["top"]:
            print(f"  {t['ms']:.3f} ms {t['calls']} x {t['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
