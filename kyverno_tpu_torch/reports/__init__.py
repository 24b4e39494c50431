# Copied verbatim from kyverno_tpu/reports/__init__.py.
"""Crash-consistent incremental policy reports (PAPER.md layers 6-7).

``store.ReportStore`` maintains report state as a delta fold over the
per-resource verdict columns the scanner already produces, journaled
for crash consistency (``journal.py``); ``rebuild()`` is the
bit-identity oracle for every delta path.
"""

from .store import (ReportStore, configure_reports, get_report_store,
                    reports_state, reset_reports)

__all__ = ["ReportStore", "configure_reports", "get_report_store",
           "reports_state", "reset_reports"]
