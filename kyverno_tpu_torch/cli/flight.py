# Copied from kyverno_tpu/cli/flight.py, with TorchEngine (on the card
# unless the caller passes an engine) where replay_capture builds a
# TpuEngine. Its `flight-dump` and `replay` commands import cli/tools
# and cli/apply, which the port does not have yet.
"""`flight-dump` and `replay` — the flight recorder's CLI surface.

flight-dump pulls the in-memory ring off a running serve process
(GET /debug/flight on the metrics port) and prints it human-readable,
as one JSON document (--json), or writes it as an NDJSON capture file
(--out) in exactly the spool format `replay` consumes.

replay re-evaluates a spooled capture against the CURRENT policy set
and diffs verdicts — a production capture becomes a regression fixture
(same policies -> the diff must be empty, asserted by exit code) or an
impact report (changed policies -> the diff IS the blast radius of the
change). --against picks the evaluator: the device ladder, the scalar
oracle, or both (which also cross-checks device vs scalar — the
offline form of the shadow verifier's bit-identity audit).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..observability.flightrecorder import load_capture

VERDICT_NAMES = {0: "pass", 1: "skip", 2: "fail", 3: "not_matched",
                 4: "error"}


def add_parsers(sub: argparse._SubParsersAction) -> None:
    d = sub.add_parser(
        "flight-dump",
        help="dump the flight-recorder ring of a running serve process")
    d.add_argument("--host", default="127.0.0.1")
    d.add_argument("--port", type=int, default=8000,
                   help="serve metrics port (the /debug router)")
    d.add_argument("--last", type=int, default=100,
                   help="newest N records to fetch")
    d.add_argument("--json", action="store_true",
                   help="print one JSON document (records + recorder/"
                        "verifier state) for artifact embedding")
    d.add_argument("--out", default=None, metavar="FILE",
                   help="also write the records as an NDJSON capture "
                        "file replayable via `kyverno-tpu replay`")
    d.set_defaults(func=run_flight_dump)

    r = sub.add_parser(
        "replay",
        help="re-evaluate a spooled flight capture against the current "
             "policy set and diff verdicts")
    r.add_argument("capture", help="NDJSON capture (flight spool, "
                                   "flight-dump --out, or "
                                   "divergences.ndjson)")
    r.add_argument("policies", nargs="+",
                   help="policy files or directories (the CURRENT set "
                        "to replay against)")
    r.add_argument("--against", choices=["device", "scalar", "both"],
                   default="both",
                   help="evaluator to replay through: the device "
                        "ladder, the scalar oracle, or both "
                        "(cross-checked)")
    r.add_argument("--json", action="store_true",
                   help="print the full diff document as JSON for "
                        "artifact embedding")
    r.add_argument("--limit", type=int, default=0,
                   help="replay at most N records (0 = all)")
    r.set_defaults(func=run_replay)


# ---------------------------------------------------------------------------
# flight-dump


def _fetch_flight(host: str, port: int, last: int) -> Dict[str, Any]:
    # same helper `kyverno-tpu top` uses against the same debug router
    from .tools import _http_get_json

    return _http_get_json(host, port, f"/debug/flight?last={last}",
                          timeout=30.0)


def run_flight_dump(args: argparse.Namespace) -> int:
    try:
        doc = _fetch_flight(args.host, args.port, args.last)
    except Exception as e:
        print(f"flight-dump: cannot reach serve metrics port "
              f"{args.host}:{args.port}: {e}", file=sys.stderr)
        return 2
    records = doc.get("records") or []
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            for rec in records:
                json.dump(rec, fh, default=str)
                fh.write("\n")
        print(f"wrote {len(records)} records -> {args.out}",
              file=sys.stderr)
    if args.json:
        print(json.dumps(doc, default=str))
        return 0
    if not args.out:
        for rec in records:
            codes = [c for _, _, c in (rec.get("verdicts") or [])]
            fails = sum(1 for c in codes if c == 2)
            errs = sum(1 for c in codes if c == 4)
            print(f"{rec.get('ts')} {rec.get('kind'):9s} "
                  f"{rec.get('outcome'):8s} path={rec.get('path')} "
                  f"rev={rec.get('policyset_revision')} "
                  f"sha={rec.get('resource_sha')} rules={len(codes)} "
                  f"fail={fails} error={errs} "
                  f"trace={rec.get('trace_id') or '-'}")
        state = doc.get("state") or {}
        print(f"-- ring {state.get('records')}/{state.get('capacity')} "
              f"sample_rate={state.get('sample_rate')} "
              f"spool_dir={state.get('spool_dir')}", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# replay


def _load_policies(paths) -> list:
    from ..api.policy import ClusterPolicy, is_policy_document
    from .apply import _load_docs

    return [ClusterPolicy.from_dict(d) for d in _load_docs(list(paths))
            if is_policy_document(d)]


def _rows_map(rows) -> Dict[Tuple[str, str], int]:
    out: Dict[Tuple[str, str], int] = {}
    for item in rows:
        if isinstance(item, (list, tuple)) and len(item) == 3:
            p, r, c = item
        else:  # ((policy, rule), code)
            (p, r), c = item
        out[(p, r)] = int(c)
    return out


def _diff_rows(recorded: Dict[Tuple[str, str], int],
               replayed: Dict[Tuple[str, str], int]) -> Dict[str, Any]:
    cells = []
    for key in sorted(recorded.keys() & replayed.keys()):
        a, b = recorded[key], replayed[key]
        if a != b:
            cells.append({"policy": key[0], "rule": key[1],
                          "recorded": VERDICT_NAMES.get(a, a),
                          "replayed": VERDICT_NAMES.get(b, b)})
    return {"cells": cells,
            "removed_rules": sorted(
                f"{p}/{r}" for (p, r) in recorded.keys() - replayed.keys()),
            "added_rules": sorted(
                f"{p}/{r}" for (p, r) in replayed.keys() - recorded.keys())}


def replay_capture(records: List[Dict[str, Any]], policies: list,
                   against: str = "both",
                   limit: int = 0, engine=None) -> Dict[str, Any]:
    """Re-evaluate capture records against ``policies``; returns the
    diff document. Device replay batches every usable record through
    ONE engine scan (the real ladder: breaker, quarantine, host cells
    — a box without a device still answers via scalar fallback,
    bit-identically); scalar replay runs each record through the
    oracle-rows machinery the shadow verifier uses online."""
    from ..observability.verification import info_from_dict, scalar_rows

    usable: List[Dict[str, Any]] = []
    skipped = 0
    for rec in records:
        if isinstance(rec.get("resource"), dict) and rec.get("verdicts"):
            usable.append(rec)
        else:
            skipped += 1  # truncated body / error record: diff impossible
    if limit and len(usable) > limit:
        skipped += len(usable) - limit
        usable = usable[:limit]
    doc: Dict[str, Any] = {
        "capture_records": len(records), "replayed": len(usable),
        "skipped": skipped, "against": against, "divergent_records": 0,
        "diffs": [],
    }
    if not usable:
        doc["match"] = True
        return doc

    if engine is not None:
        eng = engine  # caller-supplied compiled set (bench rollup)
    else:
        from ..policy.autogen import expand_policy
        from ..tpu.engine import TorchEngine

        # autogen expansion mirrors PolicyCache.set: a capture from a
        # serve process records the EXPANDED rule set (autogen-* rows),
        # so the replay engine must compile the same shape or every
        # record diffs on missing rules
        eng = TorchEngine([expand_policy(p) for p in policies])
    # merged namespace-labels view; per-record evaluation when two
    # records disagree about the same namespace's labels (a capture
    # spanning a label change must not replay one side with the
    # other's labels)
    nsmap: Dict[str, Dict[str, str]] = {}
    conflicted = False
    for rec in usable:
        ns = rec.get("namespace") or ""
        labels = rec.get("ns_labels") or {}
        if ns in nsmap and nsmap[ns] != labels:
            conflicted = True
        nsmap.setdefault(ns, labels)

    modes = ("device", "scalar") if against == "both" else (against,)
    per_mode: Dict[str, List[Dict[Tuple[str, str], int]]] = {}
    if "device" in modes:
        resources = [rec["resource"] for rec in usable]
        operations = [rec.get("operation") or "" for rec in usable]
        infos = [info_from_dict(rec.get("userinfo")) for rec in usable]
        # replay RE-EVALUATES — it must never touch the verdict cache.
        # In-process callers (tests, the bench rollup) share the global
        # LRU with the capture's own run: a corrupted column cached at
        # record time would vouch for itself on a cache-served replay,
        # and disabling/clearing the cache would destroy live shared
        # state. _scan_uncached is exactly the evaluate-only ladder
        # (no lookup, no populate); scan() is just cache glue over it
        if conflicted:
            cols = []
            for rec, op, info in zip(usable, operations, infos):
                ns = rec.get("namespace") or ""
                # live_n=0: replayed columns must not re-ingest into
                # the rule-stats observatory (in-process callers — the
                # bench verification rollup — share the global
                # accumulator with the capture's own run)
                res = eng._scan_uncached([rec["resource"]],
                                         {ns: rec.get("ns_labels") or {}},
                                         operations=[op],
                                         admission_infos=[info],
                                         live_n=0)
                cols.append(dict(zip(
                    res.rules, (int(c) for c in res.verdicts[:, 0]))))
            per_mode["device"] = cols
        else:
            res = eng._scan_uncached(resources, nsmap,
                                     operations=operations,
                                     admission_infos=infos, live_n=0)
            per_mode["device"] = [
                dict(zip(res.rules,
                         (int(c) for c in res.verdicts[:, ci])))
                for ci in range(len(usable))]
    if "scalar" in modes:
        per_mode["scalar"] = [
            _rows_map(scalar_rows(
                eng, rec["resource"], rec.get("ns_labels") or {},
                rec.get("operation") or "",
                info_from_dict(rec.get("userinfo"))))
            for rec in usable]

    cross_consistent = True
    for idx, rec in enumerate(usable):
        recorded = _rows_map(rec["verdicts"])
        entry: Dict[str, Any] = {}
        for mode in modes:
            d = _diff_rows(recorded, per_mode[mode][idx])
            if d["cells"] or d["removed_rules"] or d["added_rules"]:
                entry[mode] = d
        if against == "both" and per_mode["device"][idx] != \
                per_mode["scalar"][idx]:
            cross_consistent = False
            entry["device_vs_scalar"] = _diff_rows(per_mode["device"][idx],
                                                   per_mode["scalar"][idx])
        if entry:
            entry.update({"index": idx, "kind": rec.get("kind"),
                          "resource_sha": rec.get("resource_sha"),
                          "trace_id": rec.get("trace_id") or None,
                          "recorded_outcome": rec.get("outcome"),
                          "recorded_revision":
                              rec.get("policyset_revision")})
            doc["diffs"].append(entry)
            doc["divergent_records"] += 1
    doc["match"] = doc["divergent_records"] == 0
    if against == "both":
        doc["device_vs_scalar_consistent"] = cross_consistent
    return doc


def run_replay(args: argparse.Namespace) -> int:
    try:
        records = load_capture(args.capture)
    except OSError as e:
        print(f"replay: cannot read capture: {e}", file=sys.stderr)
        return 2
    policies = _load_policies(args.policies)
    if not policies:
        print("replay: no policies found", file=sys.stderr)
        return 2
    doc = replay_capture(records, policies, against=args.against,
                         limit=args.limit)
    if args.json:
        print(json.dumps(doc, default=str))
    else:
        print(f"replayed {doc['replayed']}/{doc['capture_records']} "
              f"records against {len(policies)} policies "
              f"({doc['skipped']} skipped) via {doc['against']}")
        for d in doc["diffs"]:
            head = (f"  DIFF record {d['index']} "
                    f"sha={d.get('resource_sha')} "
                    f"outcome={d.get('recorded_outcome')} "
                    f"rev={d.get('recorded_revision')}")
            print(head)
            for mode in ("device", "scalar", "device_vs_scalar"):
                sub = d.get(mode)
                if not sub:
                    continue
                for c in sub["cells"][:10]:
                    print(f"    [{mode}] {c['policy']}/{c['rule']}: "
                          f"{c['recorded']} -> {c['replayed']}")
                if sub["removed_rules"]:
                    print(f"    [{mode}] rules no longer present: "
                          f"{', '.join(sub['removed_rules'][:5])}")
                if sub["added_rules"]:
                    print(f"    [{mode}] new rules: "
                          f"{', '.join(sub['added_rules'][:5])}")
        verdict = "MATCH" if doc["match"] else \
            f"{doc['divergent_records']} divergent record(s)"
        print(f"replay: {verdict}")
    return 0 if doc["match"] else 1
