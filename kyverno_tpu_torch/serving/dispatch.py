# Copied verbatim from kyverno_tpu/serving/dispatch.py.
"""Verdict dispatch — one ScanResult column to per-request rows.

Both consumers of a batch verdict table (the admission pipeline fanning
results back to waiting callers, and the background scanner writing
report rows) must read a resource's verdicts in the SAME compiled-rule
row order, or scan and serve drift apart on multi-rule policies.
"""

from __future__ import annotations

from typing import List, Tuple


def resource_verdicts(result, ci: int) -> List[Tuple[Tuple[str, str], int]]:
    """[( (policy_name, rule_name), code ), ...] for resource column
    `ci`, in compiled-rule row order. `result` is any object with the
    ScanResult shape (`.rules` list + `.verdicts` (rules, N) table)."""
    verdicts = result.verdicts
    return [(rule, int(verdicts[row, ci]))
            for row, rule in enumerate(result.rules)]
