# Copied from kyverno_tpu/analysis/analyzer.py; its docstrings name the
# port's TorchEngine and its CUDA graphs.
"""Policy-set static analysis — cross-product anomaly detection.

The analyzer evaluates the synthesized witness corpus (witness.py)
against the FULL compiled policy set through the batched device path —
``TorchEngine`` / ``CompiledPolicySet.device_fn`` tiles, the same dispatch
ladder production traffic rides — and classifies inter-policy anomalies
from the resulting verdict table (the firewall static-analysis taxonomy
of arXiv:1102.1237, reinterpreted for admission control where every
matching rule evaluates):

- **dead** — the rule can never fire: the synthesizer covered its whole
  match shape and no witness in the corpus reaches it (all verdicts
  NOT_MATCHED; e.g. an exclude block swallowing the match, an
  unsatisfiable selector);
- **shadow** — rule A is subsumed by rule B of the same enforcement
  class: B fires on everything A fires on, produces the IDENTICAL
  verdict on every witness A fires on, and strictly covers more — A
  never changes the admission outcome;
- **redundant** — two same-action rules with bit-identical verdict
  columns across the whole corpus (both actually firing and failing
  somewhere — identical silence is not evidence);
- **conflict** — an Enforce rule and an Audit rule reject the same
  witnesses and agree everywhere both fire: the same violation class
  is simultaneously blocked and merely audited, an enforcement-intent
  ambiguity.

Every candidate anomaly is re-confirmed through the scalar oracle (the
same confirm ladder the approximate-DFA path uses): the supporting
cells are re-evaluated with the host engine and the anomaly only
surfaces when the oracle agrees — device over-approximation can refute
an anomaly, never invent one.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .witness import RuleSynthesis, Witness, synthesize

# verdict codes (tpu/evaluator.py order; mirrored like analytics.py so
# this module stays importable without torch)
PASS, SKIP, FAIL, NOT_MATCHED, ERROR = 0, 1, 2, 3, 4

ANOMALY_KINDS = ("shadow", "conflict", "redundant", "dead")

# bounded confirm ladder: at most this many witness cells re-evaluated
# through the scalar oracle per candidate anomaly
CONFIRM_CAP = 8


@dataclass
class Anomaly:
    kind: str
    policy: str
    rule: str
    other_policy: str = ""
    other_rule: str = ""
    detail: str = ""
    evidence: List[int] = field(default_factory=list)  # witness indices
    confirmed: bool = False

    def to_dict(self) -> Dict[str, Any]:
        out = {"kind": self.kind, "policy": self.policy, "rule": self.rule,
               "detail": self.detail, "confirmed": self.confirmed,
               "evidence_witnesses": len(self.evidence)}
        if self.other_policy or self.other_rule:
            out["other_policy"] = self.other_policy
            out["other_rule"] = self.other_rule
        return out


@dataclass
class AnalysisReport:
    anomalies: List[Anomaly] = field(default_factory=list)
    # per-rule static status rows: policy/rule/status(+by)
    rules: List[Dict[str, Any]] = field(default_factory=list)
    stats: Dict[str, Any] = field(default_factory=dict)

    def counts(self) -> Dict[str, int]:
        out = {k: 0 for k in ANOMALY_KINDS}
        for a in self.anomalies:
            out[a.kind] = out.get(a.kind, 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "anomalies": [a.to_dict() for a in self.anomalies],
            "counts": self.counts(),
            "rules": self.rules,
            "stats": self.stats,
        }

    def render_table(self) -> str:
        lines = ["policy-set static analysis"]
        st = self.stats
        lines.append(
            f"  rules: {st.get('rules_total', 0)} "
            f"({st.get('rules_unanalyzable', 0)} unanalyzable) | "
            f"witnesses: {st.get('witnesses', 0)} | "
            f"device dispatches: {st.get('device_dispatches', 0)} | "
            f"confirms: {st.get('confirmed_cells', 0)} ok / "
            f"{st.get('refuted', 0)} refuted")
        counts = self.counts()
        lines.append("  anomalies: " + ", ".join(
            f"{k}={counts[k]}" for k in ANOMALY_KINDS))
        for a in self.anomalies:
            tgt = f"{a.policy}/{a.rule}"
            if a.kind == "dead":
                lines.append(f"  DEAD      {tgt}: {a.detail}")
            elif a.kind == "shadow":
                lines.append(f"  SHADOW    {tgt} shadowed by "
                             f"{a.other_policy}/{a.other_rule}: {a.detail}")
            elif a.kind == "redundant":
                lines.append(f"  REDUNDANT {tgt} == "
                             f"{a.other_policy}/{a.other_rule}: {a.detail}")
            else:
                lines.append(f"  CONFLICT  {tgt} (Enforce) vs "
                             f"{a.other_policy}/{a.other_rule} (Audit): "
                             f"{a.detail}")
        if not self.anomalies:
            lines.append("  no anomalies")
        return "\n".join(lines)


class AnalysisAborted(Exception):
    """A pending policy-set change preempted the lint run."""


# ---------------------------------------------------------------------------
# process-global state: the last completed report, consumed by
# /debug/analysis, /debug/rules static correlation, and the metrics


class AnalysisState:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._report: Optional[AnalysisReport] = None
        self._static: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.lint_enabled = False
        self.runs = {"ok": 0, "aborted": 0, "error": 0}

    def set_report(self, report: AnalysisReport) -> None:
        static: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for row in report.rules:
            static[(row["policy"], row["rule"])] = row
        with self._lock:
            self._report = report
            self._static = static
        self._publish_metrics(report)

    def record_run(self, outcome: str) -> None:
        with self._lock:
            self.runs[outcome] = self.runs.get(outcome, 0) + 1
        try:
            from ..observability.metrics import global_registry

            global_registry.analysis_runs.inc({"outcome": outcome})
        except Exception:  # noqa: BLE001
            pass

    def _publish_metrics(self, report: AnalysisReport) -> None:
        try:
            from ..observability.metrics import global_registry as reg

            for kind, n in report.counts().items():
                reg.analysis_anomalies.set(float(n), {"kind": kind})
            reg.analysis_witnesses.set(
                float(report.stats.get("witnesses", 0)))
            for phase in ("synthesize", "evaluate", "classify", "confirm"):
                reg.analysis_wall_seconds.set(
                    float(report.stats.get(f"{phase}_s", 0.0)),
                    {"phase": phase})
        except Exception:  # noqa: BLE001
            pass  # metrics must never block the lint

    @property
    def report(self) -> Optional[AnalysisReport]:
        with self._lock:
            return self._report

    def report_dict(self) -> Dict[str, Any]:
        with self._lock:
            report, runs = self._report, dict(self.runs)
            enabled = self.lint_enabled
        out: Dict[str, Any] = {"lint_enabled": enabled, "runs": runs}
        if report is None:
            out["analyzed"] = False
        else:
            out["analyzed"] = True
            out.update(report.to_dict())
        return out

    def static_for(self, policy: str, rule: str) -> Optional[Dict[str, Any]]:
        """The /debug/rules correlation: the rule's static status from
        the last lint run ('dead' / 'shadowed_by' / 'ok'), or None when
        no analysis has run or the rule was not analyzable."""
        with self._lock:
            row = self._static.get((policy, rule))
        if row is None or row.get("status") == "unanalyzable":
            return None
        out = {"static": row["status"]}
        if row.get("by"):
            out["by"] = row["by"]
        return out

    def reset(self) -> None:
        with self._lock:
            self._report = None
            self._static = {}
            self.lint_enabled = False
            self.runs = {"ok": 0, "aborted": 0, "error": 0}


global_analysis = AnalysisState()


# ---------------------------------------------------------------------------
# evaluation: the witness corpus through the batched device path


def _compatible(ns_labels: Dict[str, Dict[str, str]],
                add: Dict[str, Dict[str, str]]) -> bool:
    for ns, labels in add.items():
        if ns in ns_labels and ns_labels[ns] != labels:
            return False
    return True


def _tiles(corpus: Sequence[Witness], tile: int) -> List[List[int]]:
    """Greedy tiling: bounded tile size, and witnesses whose namespace-
    label requirements conflict (same namespace, different labels) are
    split into separate tiles so one scan's ns_labels map stays
    consistent."""
    tiles: List[List[int]] = []
    cur: List[int] = []
    cur_nsl: Dict[str, Dict[str, str]] = {}
    for i, w in enumerate(corpus):
        if cur and (len(cur) >= tile or not _compatible(cur_nsl, w.ns_labels)):
            tiles.append(cur)
            cur, cur_nsl = [], {}
        cur.append(i)
        cur_nsl.update(w.ns_labels)
    if cur:
        tiles.append(cur)
    return tiles


def evaluate_corpus(engine, corpus: Sequence[Witness], tile: int = 256,
                    should_abort: Optional[Callable[[], bool]] = None
                    ) -> Tuple[np.ndarray, int]:
    """(rules x witnesses) verdict table via the batched device path.

    Goes through ``TorchEngine._scan_uncached`` — one device dispatch per
    tile, never a per-witness scalar loop; the verdict cache is
    deliberately bypassed (synthetic columns must not populate or
    consult the production cache) and ``live_n=0`` keeps the synthetic
    traffic out of the rule-stats observatory. Returns the table and
    the number of device-path scans (tiles) issued."""
    R = len(engine.cps.rules)
    table = np.full((R, len(corpus)), NOT_MATCHED, dtype=np.int32)
    dispatches = 0
    for idx_tile in _tiles(corpus, tile):
        if should_abort is not None and should_abort():
            raise AnalysisAborted("policy-set changed under analysis")
        ws = [corpus[i] for i in idx_tile]
        nsl: Dict[str, Dict[str, str]] = {}
        for w in ws:
            nsl.update(w.ns_labels)
        result = engine._scan_uncached(
            [w.resource for w in ws], nsl or None,
            [w.operation for w in ws], [w.info for w in ws], live_n=0)
        table[:, idx_tile] = result.verdicts
        dispatches += 1
    return table, dispatches


# ---------------------------------------------------------------------------
# classification


def _policy_actions(cps) -> List[bool]:
    """Per-policy enforce flag (True = Enforce)."""
    return [str(getattr(p.spec, "validation_failure_action", "") or "Audit")
            .lower().startswith("enforce") for p in cps.policies]


def classify(cps, table: np.ndarray, corpus: Sequence[Witness],
             per_rule: Dict[int, RuleSynthesis]) -> List[Anomaly]:
    R, W = table.shape
    enforce = _policy_actions(cps)
    fired = np.isin(table, (PASS, FAIL, ERROR))       # (R, W)
    fails = table == FAIL
    matched = table != NOT_MATCHED
    anomalies: List[Anomaly] = []

    def name(r: int) -> Tuple[str, str]:
        e = cps.rules[r]
        return e.policy_name, e.rule_name

    # -- dead: exhaustive synthesis, witnesses exist, nothing in the
    # whole corpus ever matches the rule
    for r in range(R):
        syn = per_rule.get(r)
        if syn is None or not syn.exhaustive or not syn.witnesses:
            continue
        if W and not matched[r].any():
            p, n = name(r)
            anomalies.append(Anomaly(
                kind="dead", policy=p, rule=n,
                detail="no satisfiable witness matches the rule "
                       "(match/exclude contradiction)",
                evidence=list(syn.witnesses[:CONFIRM_CAP])))

    if W == 0:
        return anomalies

    dead_set = {(a.policy, a.rule) for a in anomalies}

    # -- pairwise relations over the verdict table
    col_key: Dict[bytes, List[int]] = {}
    for r in range(R):
        col_key.setdefault(table[r].tobytes(), []).append(r)

    reported_redundant: Set[Tuple[int, int]] = set()
    for rows in col_key.values():
        if len(rows) < 2:
            continue
        base = rows[0]
        if not fails[base].any() or not fired[base].any():
            continue  # identical silence is not evidence
        for other in rows[1:]:
            a, b = sorted((base, other))
            ea, eb = cps.rules[a], cps.rules[b]
            if (ea.policy_name, ea.rule_name) == (eb.policy_name,
                                                  eb.rule_name):
                continue
            if enforce[ea.policy_idx] != enforce[eb.policy_idx]:
                continue  # differing action class -> conflict territory
            if (a, b) in reported_redundant:
                continue
            reported_redundant.add((a, b))
            pa, na = name(a)
            pb, nb = name(b)
            ev = np.nonzero(fails[a])[0].tolist()[:CONFIRM_CAP]
            anomalies.append(Anomaly(
                kind="redundant", policy=pa, rule=na,
                other_policy=pb, other_rule=nb,
                detail=f"identical verdict columns across all {W} "
                       f"witnesses",
                evidence=ev))

    redundant_pairs = reported_redundant

    for a in range(R):
        pa, na = name(a)
        if (pa, na) in dead_set or not fails[a].any():
            continue
        ea = cps.rules[a]
        for b in range(R):
            if a == b:
                continue
            eb = cps.rules[b]
            if (ea.policy_name, ea.rule_name) == (eb.policy_name,
                                                  eb.rule_name):
                continue
            same_action = enforce[ea.policy_idx] == enforce[eb.policy_idx]
            common_fail = fails[a] & fails[b]
            if not same_action:
                # Enforce-vs-Audit conflict on overlapping selectors:
                # both classes reject the same witnesses AND their
                # decisions agree on every witness both rules fire on —
                # the two rules police the same violations with
                # contradictory enforcement intent. The agreement
                # requirement keeps corpus artifacts out: a minimal
                # witness for rule A omits every field unrelated to A,
                # so an unrelated pattern rule fails on it spuriously —
                # but that rule then also fails A's PASSING witness,
                # which breaks agreement and kills the candidate.
                both = fired[a] & fired[b]
                if (enforce[ea.policy_idx] and common_fail.any()
                        and not ((fails[a] ^ fails[b]) & both).any()):
                    pb, nb = name(b)
                    ev = np.nonzero(common_fail)[0].tolist()[:CONFIRM_CAP]
                    anomalies.append(Anomaly(
                        kind="conflict", policy=pa, rule=na,
                        other_policy=pb, other_rule=nb,
                        detail=f"{int(common_fail.sum())} witness(es) "
                               f"rejected by both the Enforce and the "
                               f"Audit rule",
                        evidence=ev))
                continue
            if tuple(sorted((a, b))) in redundant_pairs:
                continue
            # shadow: B fires everywhere A fires, makes the IDENTICAL
            # reject decision on every witness A fires on, and covers
            # strictly more — removing A would change no admission
            # outcome. Bare fail-subset is NOT enough (see the conflict
            # comment: minimal witnesses make unrelated rules fail
            # supersets spuriously); pointwise agreement on A's fired
            # set is what makes B a true stand-in for A.
            if not (fired[a] & ~fired[b]).any() \
                    and not ((fails[a] ^ fails[b]) & fired[a]).any() \
                    and ((fails[b] & ~fails[a]).any()
                         or (fired[b] & ~fired[a]).any()):
                pb, nb = name(b)
                ev = np.nonzero(fails[a])[0].tolist()[:CONFIRM_CAP]
                anomalies.append(Anomaly(
                    kind="shadow", policy=pa, rule=na,
                    other_policy=pb, other_rule=nb,
                    detail="every witness this rule fires on gets the "
                           "identical verdict from the shadowing rule, "
                           "which also covers more",
                    evidence=ev))
                break  # one shadowing stand-in rule is enough
    return anomalies


# ---------------------------------------------------------------------------
# scalar-oracle confirmation (the same confirm ladder as DFA hits)


def _oracle_column(engine, policy_idx: int, w: Witness,
                   cache: Dict[Tuple[int, int], Optional[Dict[str, int]]],
                   wi: int) -> Optional[Dict[str, int]]:
    key = (policy_idx, wi)
    if key in cache:
        return cache[key]
    from ..tpu.engine import _scalar_rule_verdicts, build_scan_context

    policy = engine.cps.policies[policy_idx]
    try:
        ns = (w.resource.get("metadata") or {}).get("namespace", "")
        if w.resource.get("kind") == "Namespace":
            ns = (w.resource.get("metadata") or {}).get("name", "")
        nsl = w.ns_labels.get(ns, {})
        pctx = build_scan_context(policy, w.resource, nsl, w.operation,
                                  w.info)
        cache[key] = _scalar_rule_verdicts(engine.scalar, policy, pctx)
    except Exception:  # noqa: BLE001
        cache[key] = None
    return cache[key]


def confirm(engine, anomalies: List[Anomaly], table: np.ndarray,
            corpus: Sequence[Witness]) -> Tuple[List[Anomaly], Dict[str, int]]:
    """Re-evaluate each anomaly's supporting cells with the scalar
    oracle; only anomalies whose evidence the oracle reproduces
    survive. Over-approximation on the device side (approximate DFAs,
    byte-semantics divergence) is therefore refutable here — the lint
    never cries wolf."""
    cps = engine.cps
    rule_rows = {(e.policy_name, e.rule_name): r
                 for r, e in enumerate(cps.rules)}
    idx_of = {r: e.policy_idx for r, e in enumerate(cps.rules)}
    cache: Dict[Tuple[int, int], Optional[Dict[str, int]]] = {}
    confirmed: List[Anomaly] = []
    stats = {"checked_cells": 0, "confirmed_cells": 0, "refuted": 0}

    def cell_ok(row: int, wi: int, want_code: int) -> bool:
        stats["checked_cells"] += 1
        entry = cps.rules[row]
        col = _oracle_column(engine, idx_of[row], corpus[wi], cache, wi)
        if col is None:
            return False  # oracle could not evaluate: never surface
        got = col.get(entry.rule_name, NOT_MATCHED)
        ok = got == want_code
        if ok:
            stats["confirmed_cells"] += 1
        return ok

    for a in anomalies:
        row = rule_rows.get((a.policy, a.rule))
        other = rule_rows.get((a.other_policy, a.other_rule)) \
            if a.other_policy or a.other_rule else None
        ok = row is not None
        for wi in a.evidence[:CONFIRM_CAP]:
            if not ok:
                break
            if a.kind == "dead":
                ok = cell_ok(row, wi, NOT_MATCHED)
            elif a.kind in ("shadow", "conflict"):
                ok = cell_ok(row, wi, FAIL) and other is not None \
                    and cell_ok(other, wi, FAIL)
            else:  # redundant: oracle agrees both columns carry FAIL
                ok = cell_ok(row, wi, FAIL) and other is not None \
                    and cell_ok(other, wi, FAIL)
        if ok:
            a.confirmed = True
            confirmed.append(a)
        else:
            stats["refuted"] += 1
    return confirmed, stats


# ---------------------------------------------------------------------------
# the entry point


def analyze_engine(engine, tile: int = 256,
                   should_abort: Optional[Callable[[], bool]] = None
                   ) -> AnalysisReport:
    """Full static analysis of one compiled engine: synthesize ->
    batched device evaluation -> classify -> oracle-confirm. Raises
    AnalysisAborted when ``should_abort`` fires between tiles (the
    lifecycle lint's preemption hook). The engine is used AS-IS: no
    recompile, no new program beyond the shape buckets the tiles pad
    to (on CUDA, a graph per bucket met twice: ``tpu/graphs.py``)."""
    cps = engine.cps
    t0 = time.perf_counter()
    corpus, per_rule = synthesize(cps)
    t_synth = time.perf_counter() - t0

    t0 = time.perf_counter()
    table, dispatches = evaluate_corpus(engine, corpus, tile=tile,
                                        should_abort=should_abort)
    t_eval = time.perf_counter() - t0

    t0 = time.perf_counter()
    candidates = classify(cps, table, corpus, per_rule)
    t_classify = time.perf_counter() - t0

    t0 = time.perf_counter()
    anomalies, confirm_stats = confirm(engine, candidates, table, corpus)
    t_confirm = time.perf_counter() - t0

    shadowed = {(a.policy, a.rule): a for a in anomalies
                if a.kind == "shadow"}
    dead = {(a.policy, a.rule) for a in anomalies if a.kind == "dead"}
    rules_rows: List[Dict[str, Any]] = []
    unanalyzable = 0
    for r, entry in enumerate(cps.rules):
        syn = per_rule.get(r)
        key = (entry.policy_name, entry.rule_name)
        if key in dead:
            status: Dict[str, Any] = {"status": "dead"}
        elif key in shadowed:
            sh = shadowed[key]
            status = {"status": "shadowed_by",
                      "by": f"{sh.other_policy}/{sh.other_rule}"}
        elif syn is not None and syn.witnesses:
            status = {"status": "ok"}
        else:
            status = {"status": "unanalyzable",
                      "note": syn.note if syn is not None else ""}
            unanalyzable += 1
        status.update({"policy": entry.policy_name,
                       "rule": entry.rule_name})
        rules_rows.append(status)

    intents: Dict[str, int] = {}
    for w in corpus:
        intents[w.intent] = intents.get(w.intent, 0) + 1
    eval_rate = (len(corpus) / t_eval) if t_eval > 0 else 0.0
    report = AnalysisReport(
        anomalies=anomalies,
        rules=rules_rows,
        stats={
            "rules_total": len(cps.rules),
            "rules_unanalyzable": unanalyzable,
            "witnesses": len(corpus),
            "witnesses_by_intent": intents,
            "device_dispatches": dispatches,
            "candidates": len(candidates),
            "synthesize_s": round(t_synth, 4),
            "evaluate_s": round(t_eval, 4),
            "classify_s": round(t_classify, 4),
            "confirm_s": round(t_confirm, 4),
            "witness_evals_per_s": round(eval_rate, 1),
            **confirm_stats,
        })
    return report


def run_analysis(engine, tile: int = 256,
                 should_abort: Optional[Callable[[], bool]] = None,
                 state: Optional[AnalysisState] = None
                 ) -> Optional[AnalysisReport]:
    """analyze_engine + global-state/metrics bookkeeping. Returns None
    on abort (the caller retries on its own schedule)."""
    state = state or global_analysis
    try:
        report = analyze_engine(engine, tile=tile,
                                should_abort=should_abort)
    except AnalysisAborted:
        state.record_run("aborted")
        return None
    except Exception:
        state.record_run("error")
        raise
    state.set_report(report)
    state.record_run("ok")
    return report
