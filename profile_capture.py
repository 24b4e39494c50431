#!/usr/bin/env python3
"""CUDA-graph capture under another thread's device work, on one GPU.

    python3 profile_capture.py [--root DIR] [--design as_is|global|lock]
        [--trials 6] [--seed 0] [--out FILE]

The admission pipeline drives one ``TorchEngine`` from several threads:
the flusher replays a bucket's graph while a new bucket, or the next
policy-set version on the lifecycle worker, captures its own. Each trial
here compiles the 18 PSS policies afresh (``EncodeConfig(max_rows=128)``,
the admission engine's), warms bucket 16 (an eager run, then the
capture), and starts thread A scanning 16 seeded resources in a loop.
Meanwhile thread B makes two scans of 32 resources on the same engine
(scenario ``bucket``: the eager run, then the capture of bucket 32), and
two scans of 16 on a second engine compiled afresh (scenario ``swap``:
a new version capturing bucket 16 while A replays the old one). Both
content caches are off, so every scan reaches the program.

It prints, per scenario: the trials, B's capture failures
(``KernelError``) and A's errors, the tables that differ from the CPU
engine's, B's two scan times, and A's scan times while B ran
beside A's times alone (the cost a design puts on the other thread).
Thread A's scans of the same engine wait on the program's own lock
while B records; its copy-in and readback do not.

Designs: ``as_is`` runs the tree at ``--root`` as it is; ``global``
records in CUDA's default ("global") capture mode, as the port did
before ``tpu/graphs.py:CAPTURE_MODE``; ``lock`` records in global mode
with one process-wide lock taken around every dispatch (copy-in,
program, readback), the other design that keeps a capture whole.
``--root`` runs another tree (an unpacked parent commit) with
``--design as_is``. Every time is printed beside the card's name and
power limit. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def pct(xs, q):
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--design", default="as_is",
                    choices=("as_is", "global", "lock"))
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_capture: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from kyverno_tpu_torch import kernels
    from kyverno_tpu_torch.policies import load_pss_policies
    from kyverno_tpu_torch.policy.autogen import expand_policy
    from kyverno_tpu_torch.tpu import cache as tcache
    from kyverno_tpu_torch.tpu import graphs
    from kyverno_tpu_torch.tpu.compiler import compile_policy_set
    from kyverno_tpu_torch.tpu.engine import TorchEngine
    from kyverno_tpu_torch.tpu.flatten import EncodeConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    tag = f"({card})"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, root {root}, "
          f"design {args.design}", flush=True)
    tcache.configure(0, 0)
    kernels.build_all()
    if args.design != "as_is":
        graphs.CAPTURE_MODE = "global"
    if args.design == "lock":
        lock = threading.Lock()
        real = TorchEngine._dispatch

        def locked(self, *a, **k):
            with lock:
                return real(self, *a, **k)

        TorchEngine._dispatch = locked

    policies = [expand_policy(p) for p in load_pss_policies()]
    cfg = EncodeConfig(max_rows=128)
    res, ops = chip_smoke.workload(64, args.seed)
    a_res, b_res = res[:16], res[16:48]
    cpu = TorchEngine(cps=compile_policy_set(policies, cfg), device="cpu")
    want = {16: cpu.scan(a_res).verdicts, 32: cpu.scan(b_res).verdicts}

    def fresh():
        return TorchEngine(cps=compile_policy_set(policies, cfg))

    out = {"card": card, "torch": torch.__version__, "design": args.design,
           "root": root, "scenarios": {}}
    for scenario in ("bucket", "swap"):
        fails, a_errors, wrong = [], [], 0
        a_alone, a_during, b_times = [], [], []
        for trial in range(args.trials):
            eng = fresh()
            for _ in range(3):
                eng.scan(a_res)
            t0 = time.perf_counter()
            for _ in range(10):
                eng.scan(a_res)
            a_alone.append((time.perf_counter() - t0) / 10)
            if scenario == "swap":
                b_eng, b_in, b_want = fresh(), a_res, want[16]
            else:
                b_eng, b_in, b_want = eng, b_res, want[32]
            stop = threading.Event()
            window = [0.0, 0.0]
            seen = []

            def loop_a():
                while not stop.is_set():
                    t = time.perf_counter()
                    try:
                        got = eng.scan(a_res)
                    except Exception as e:  # noqa: BLE001 - counted
                        a_errors.append(f"{type(e).__name__}: {e}"[:300])
                        continue
                    seen.append((t, time.perf_counter()))
                    if not np.array_equal(got.verdicts, want[16]):
                        seen.append(None)

            th = threading.Thread(target=loop_a)
            th.start()
            time.sleep(0.05)
            times = []
            window[0] = time.perf_counter()
            for call in range(2):
                t = time.perf_counter()
                try:
                    got = b_eng.scan(b_in)
                    if not np.array_equal(got.verdicts, b_want):
                        wrong += 1
                except Exception as e:  # noqa: BLE001 - counted
                    fails.append(f"{type(e).__name__}: {e}"[:300])
                times.append(time.perf_counter() - t)
            window[1] = time.perf_counter()
            time.sleep(0.05)
            stop.set()
            th.join()
            b_times.append(times)
            wrong += sum(1 for s in seen if s is None)
            a_during.extend(e - s for s, e in filter(None, seen)
                            if e > window[0] and s < window[1])
            torch.cuda.synchronize()
        r = {"trials": args.trials, "capture_failures": len(fails),
             "a_errors": len(a_errors), "wrong_tables": wrong,
             "first_errors": (fails + a_errors)[:3],
             "b_eager_s": statistics.median(t[0] for t in b_times),
             "b_capture_s": statistics.median(t[1] for t in b_times),
             "a_alone_ms": 1e3 * statistics.median(a_alone),
             "a_during_b_ms": {
                 "n": len(a_during),
                 "p50": None if not a_during else 1e3 * pct(a_during, 0.5),
                 "max": None if not a_during else 1e3 * max(a_during)}}
        out["scenarios"][scenario] = r
        d = r["a_during_b_ms"]
        during = ("none" if not d["n"] else
                  f"p50 {d['p50']:.3f} ms, max {d['max']:.3f} ms")
        print(f"[{args.design} {scenario}] {args.trials} trials: capture "
              f"failures {len(fails)}, thread A errors {len(a_errors)}, "
              f"tables unlike the CPU's {wrong}; B eager "
              f"{r['b_eager_s']:.3f} s, B capture {r['b_capture_s']:.3f} s; "
              f"A alone {r['a_alone_ms']:.3f} ms a scan, A during B's "
              f"scans {d['n']} scans ({during}) {tag}", flush=True)
        for e in r["first_errors"]:
            print(f"    {e}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
