# Copied from kyverno_tpu/cli/analyze.py, with TorchEngine where the
# reference builds a TpuEngine: on the card unless --device cpu asks
# for the plain PyTorch path.
"""`analyze` — policy-set static analysis as a device workload.

Synthesizes a witness corpus from every rule's match/exclude selectors
and validate constraints (analysis/witness.py), evaluates the full
policy x witness cross-product through the SAME batched device path
production traffic rides, classifies inter-policy anomalies from the
verdict table (shadow / conflict / redundant / dead — the firewall
static-analysis taxonomy), and confirms every candidate through the
scalar oracle before reporting (the approximate-DFA confirm ladder
stance: the device may over-approximate, the lint never cries wolf).

Exit codes: 0 = analysis completed (anomalies reported but not fatal);
1 = a confirmed anomaly matched --fail-on; 2 = usage / load error
(no CUDA card and no ``--device cpu`` included: the command never
carries on on the CPU by itself).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..api.policy import ClusterPolicy, is_policy_document
from ..policy.autogen import expand_policy


def add_parser(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "analyze",
        help="static policy-set analysis: witness synthesis + "
             "cross-product anomaly detection on the device path")
    p.add_argument("policies", nargs="+", help="policy files or directories")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    p.add_argument("--fail-on", default=None, metavar="KINDS",
                   help="comma-separated anomaly kinds that fail the "
                        "run (exit 1): any of shadow,conflict,"
                        "redundant,dead, or 'any'")
    p.add_argument("--tile", type=int, default=256,
                   help="witnesses per device dispatch tile "
                        "(default 256)")
    p.add_argument("--device", default=None,
                   help="torch device of the device engine (default: "
                        "the CUDA card; 'cpu' runs the plain PyTorch "
                        "path)")
    p.set_defaults(func=run)


def _parse_fail_on(spec):
    from ..analysis import ANOMALY_KINDS

    if spec is None:
        return set()
    kinds = {k.strip() for k in spec.split(",") if k.strip()}
    if "any" in kinds:
        return set(ANOMALY_KINDS)
    bad = kinds - set(ANOMALY_KINDS)
    if bad:
        print(f"--fail-on: unknown anomaly kind(s) {sorted(bad)} "
              f"(valid: {', '.join(ANOMALY_KINDS)}, any)", file=sys.stderr)
        raise SystemExit(2)
    return kinds


def run(args: argparse.Namespace) -> int:
    from .apply import _load_docs

    fail_on = _parse_fail_on(args.fail_on)
    docs = _load_docs(args.policies)
    policies = [expand_policy(ClusterPolicy.from_dict(d)) for d in docs
                if is_policy_document(d)]
    if not policies:
        print("no policies found", file=sys.stderr)
        return 2

    # the same autogen-expanded compiled set `serve` evaluates — the
    # analysis describes the program that actually runs, and the
    # witness evaluation itself is one batched device workload
    from ..analysis import run_analysis
    from ..tpu.engine import TorchEngine, resolve_device

    try:
        device = resolve_device(getattr(args, "device", None))
    except (RuntimeError, ValueError) as e:
        print(f"analyze: {e}", file=sys.stderr)
        return 2
    engine = TorchEngine(policies, device=device)
    report = run_analysis(engine, tile=max(args.tile, 1))
    if report is None:  # abort hook unused here; defensive
        print("analysis aborted", file=sys.stderr)
        return 2

    if args.as_json:
        print(json.dumps(report.to_dict()))
    else:
        print(report.render_table())

    counts = report.counts()
    if any(counts.get(k, 0) for k in fail_on):
        if not args.as_json:
            hit = {k: counts[k] for k in sorted(fail_on) if counts.get(k)}
            print(f"failing on anomalies: {hit}", file=sys.stderr)
        return 1
    return 0
