# Copied from kyverno_tpu/cli/lint.py; it lints the port, against the
# port's own baseline (devtools/lint_baseline.json).
"""kyverno-tpu lint — engine self-analysis (devtools static pass).

Exit codes: 0 clean (or every finding baselined / outside --fail-on),
1 findings matched --fail-on, 2 usage error (unknown check class, bad
path, malformed baseline).
"""

from __future__ import annotations

import json
import sys

from ..devtools import lintcore


def add_parser(sub) -> None:
    p = sub.add_parser(
        "lint",
        help="static self-analysis of the engine source (concurrency, "
             "fault sites, metric families, import hygiene)",
        description=(
            "Run the engine's own static analyzer: jax-import (the "
            "encode-worker import closure loads neither torch nor JAX), "
            "guarded-by "
            "(annotated shared attributes only touched under their "
            "lock), fault-site (fire()/arm() literals exist in "
            "KNOWN_SITES, no dead sites), metric-family (constructed "
            "families are registered for exposition, label keys "
            "bounded), blocking-under-lock (no sleep/IO/subprocess/"
            "device dispatch inside a held lock in hot-path modules). "
            "Deliberate exceptions live in the port's "
            "devtools/lint_baseline.json with a "
            "one-line justification each."))
    p.add_argument("path", nargs="?", default=None,
                   help="directory tree to lint (default: the installed "
                        "kyverno_tpu_torch package)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable findings")
    p.add_argument("--fail-on", default="any",
                   help="comma-separated check classes that cause exit 1 "
                        "(default: any). Classes: "
                        + ", ".join(lintcore.CHECK_CLASSES))
    p.add_argument("--checks", default=None,
                   help="comma-separated subset of check classes to run "
                        "(default: all)")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON path (default: the port's "
                        "devtools/lint_baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline: report everything")
    p.set_defaults(func=run)


def run(args) -> int:
    try:
        fail_on = [c.strip() for c in args.fail_on.split(",") if c.strip()]
        if fail_on == ["any"]:
            fail_on = list(lintcore.CHECK_CLASSES)
        for c in fail_on:
            if c not in lintcore.CHECK_CLASSES:
                raise lintcore.LintUsageError(
                    f"unknown --fail-on class {c!r} (known: "
                    f"{', '.join(lintcore.CHECK_CLASSES)}, any)")
        checks = None
        if args.checks:
            checks = [c.strip() for c in args.checks.split(",") if c.strip()]
        baseline = [] if args.no_baseline \
            else lintcore.load_baseline(args.baseline)
        findings = lintcore.run_lint(root=args.path, checks=checks,
                                     baseline=baseline)
    except lintcore.LintUsageError as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2
    live = [f for f in findings if not f.baselined]
    baselined = [f for f in findings if f.baselined]
    failing = [f for f in live if f.check in fail_on]
    if args.as_json:
        counts = {}
        for f in live:
            counts[f.check] = counts.get(f.check, 0) + 1
        print(json.dumps({
            "findings": [f.to_dict() for f in live],
            "baselined": [f.to_dict() for f in baselined],
            "counts": counts,
            "checks_run": checks or list(lintcore.CHECK_CLASSES),
            "fail_on": fail_on,
            "exit": 1 if failing else 0,
        }, indent=1))
    else:
        for f in findings:
            print(f.render())
        print(f"lint: {len(live)} finding(s), {len(baselined)} baselined, "
              f"{len(failing)} failing")
    return 1 if failing else 0
