# Copied verbatim from kyverno_tpu/cluster/reports.py.
"""Policy reports — wgpolicyk8s.io/v1alpha2-shaped result aggregation.

Mirrors the reference's report pipeline (SURVEY §3.3): scan results
become per-resource ephemeral reports, aggregated per namespace into
PolicyReport / ClusterPolicyReport objects with pass/fail/warn/error/
skip summaries (pkg/controllers/report/aggregate).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

RESULT_NAMES = ("pass", "fail", "warn", "error", "skip")


@dataclass
class ReportResult:
    policy: str
    rule: str
    result: str            # pass|fail|warn|error|skip
    message: str = ""
    resource_uid: str = ""
    resource_kind: str = ""
    resource_name: str = ""
    resource_namespace: str = ""
    timestamp: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "policy": self.policy,
            "rule": self.rule,
            "result": self.result,
            "message": self.message,
            "resources": [{
                "kind": self.resource_kind,
                "name": self.resource_name,
                "namespace": self.resource_namespace,
                "uid": self.resource_uid,
            }],
            "timestamp": {"seconds": int(self.timestamp)},
        }


@dataclass
class PolicyReport:
    """One report per namespace ('' = ClusterPolicyReport)."""

    namespace: str
    results: List[ReportResult] = field(default_factory=list)

    @property
    def kind(self) -> str:
        return "PolicyReport" if self.namespace else "ClusterPolicyReport"

    def summary(self) -> Dict[str, int]:
        out = {k: 0 for k in RESULT_NAMES}
        for r in self.results:
            if r.result in out:
                out[r.result] += 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "wgpolicyk8s.io/v1alpha2",
            "kind": self.kind,
            "metadata": {
                "name": f"polr-ns-{self.namespace}" if self.namespace else "clusterpolicyreport",
                **({"namespace": self.namespace} if self.namespace else {}),
            },
            "summary": self.summary(),
            "results": [r.to_dict() for r in self.results],
        }


class ReportAggregator:
    """Ephemeral per-resource results -> merged per-namespace reports
    (aggregate/controller.go:307 reconcile, chunking elided). Shared by
    admission threads, the scan loop, and report readers -> locked."""

    def __init__(self) -> None:
        # uid -> results (the EphemeralReport equivalent)
        self._per_resource: Dict[str, List[ReportResult]] = {}
        self._lock = threading.Lock()

    def put(self, uid: str, results: List[ReportResult],
            scope: Optional[Iterable[str]] = None) -> None:
        """Record results for a resource. `scope` names the policies
        this evaluation covered: rows for other policies survive, so
        partial evaluations (failurePolicy-class webhook paths,
        fine-grained per-policy paths) merge instead of clobbering each
        other — the reference gets this for free because each
        EphemeralReport carries per-policy labels and aggregation merges
        by policy (aggregate/controller.go:307). None = full replace
        (the scanner's full-rescan semantics)."""
        now = time.time()
        for r in results:
            r.resource_uid = uid
            if not r.timestamp:
                r.timestamp = now
        with self._lock:
            if scope is None:
                self._per_resource[uid] = list(results)
            else:
                covered = set(scope)
                kept = [r for r in self._per_resource.get(uid, [])
                        if r.policy not in covered]
                self._per_resource[uid] = kept + list(results)

    def drop(self, uid: str) -> None:
        with self._lock:
            self._per_resource.pop(uid, None)

    def _snapshot(self) -> List[List[ReportResult]]:
        with self._lock:
            return list(self._per_resource.values())

    def aggregate(self) -> Dict[str, PolicyReport]:
        reports: Dict[str, PolicyReport] = {}
        for results in self._snapshot():
            for r in results:
                ns = r.resource_namespace
                reports.setdefault(ns, PolicyReport(ns)).results.append(r)
        return reports

    def summary(self) -> Dict[str, int]:
        out = {k: 0 for k in RESULT_NAMES}
        for results in self._snapshot():
            for r in results:
                if r.result in out:
                    out[r.result] += 1
        return out
