# Copied verbatim from kyverno_tpu/cli/report.py.
"""`kyverno-tpu report` — the incremental report store's CLI surface.

Reads a ``--reports-dir`` journal directory OFFLINE: the same
snapshot + journal recovery ladder a serve restart runs (torn or
corrupt suffixes truncate to the last good prefix, counted), then
prints the aggregated report state. ``--rebuild-check`` recomputes the
derived counts from scratch and asserts bit-identity against the
recovered delta state — the crash-consistency oracle as an exit code.

Run it against a live serve process's directory only when that process
is stopped: recovery may truncate a corrupt journal suffix in place.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict


def add_parser(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "report",
        help="read a report-store journal directory offline and print "
             "the aggregated policy reports")
    p.add_argument("dir", help="the serve --reports-dir directory "
                               "(snapshot.json + journal.wal)")
    p.add_argument("--json", action="store_true",
                   help="print one JSON document (reports + store "
                        "state) for artifact embedding")
    p.add_argument("--summary", action="store_true",
                   help="print only the cluster-wide result totals")
    p.add_argument("--rebuild-check", action="store_true",
                   help="recompute derived counts from scratch and "
                        "exit 1 unless bit-identical to the recovered "
                        "delta state")
    p.set_defaults(func=run)


def run(args) -> int:
    if not os.path.isdir(args.dir):
        print(f"not a reports directory: {args.dir}", file=sys.stderr)
        return 2
    from ..reports import ReportStore

    store = ReportStore(directory=args.dir)
    try:
        state = store.state()
        rebuild_ok = True
        if args.rebuild_check:
            before = store.digest()
            rebuild_ok = store.rebuild() == before
        if args.json:
            doc: Dict[str, Any] = {
                "state": state,
                "summary": store.summary(),
                "namespaces": store.namespaces(),
                "policies": store.policies(),
                "reports": {ns or "_cluster": r.to_dict()
                            for ns, r in store.aggregate().items()},
            }
            if args.rebuild_check:
                doc["rebuild_identical"] = rebuild_ok
            print(json.dumps(doc, indent=2, sort_keys=True))
        elif args.summary:
            for result, n in sorted(store.summary().items()):
                print(f"{result}: {n}")
        else:
            print(f"resources: {state['resources']}  "
                  f"namespaces: {state['namespaces']}  "
                  f"seq: {state['seq']}  "
                  f"journal: {state['journal_bytes']}B")
            totals = ", ".join(f"{k}={v}" for k, v in
                               sorted(store.summary().items()))
            print(f"totals: {totals}")
            for ns, counts in store.namespaces().items():
                cells = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
                print(f"  {ns or '(cluster)'}: {cells}")
            if args.rebuild_check:
                print(f"rebuild-check: "
                      f"{'identical' if rebuild_ok else 'MISMATCH'}")
        return 0 if rebuild_ok else 1
    finally:
        # read-only close: leave the directory exactly as recovered so
        # a later serve restart still sees (and counts) the crash state
        store.close(compact=False)
