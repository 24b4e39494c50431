# Copied verbatim from kyverno_tpu/analysis/__init__.py.
"""Policy-set static analysis on device (ROADMAP item 4).

Witness synthesis (witness.py) + cross-product anomaly detection
(analyzer.py): the compiled policy set is evaluated against a
machine-generated witness corpus in one batched device workload, and
shadowing / conflict / redundancy / dead-rule anomalies are classified
from the verdict table, each confirmed through the scalar oracle
before surfacing. Surfaces: `kyverno-tpu analyze`, the lifecycle
compile-ahead lint (`serve --analyze-on-swap`), `/debug/analysis`, and
the `/debug/rules` never-fired static correlation.
"""

from .analyzer import (ANOMALY_KINDS, AnalysisAborted, AnalysisReport,
                       AnalysisState, Anomaly, analyze_engine,
                       global_analysis, run_analysis)
from .witness import RuleSynthesis, Witness, synthesize

__all__ = [
    "ANOMALY_KINDS", "AnalysisAborted", "AnalysisReport", "AnalysisState",
    "Anomaly", "RuleSynthesis", "Witness", "analyze_engine",
    "global_analysis", "run_analysis", "synthesize",
]
