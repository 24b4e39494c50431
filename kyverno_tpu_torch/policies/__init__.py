# Copied verbatim from kyverno_tpu/policies/__init__.py.
"""Bundled policy library (the charts/kyverno-policies equivalent).

`load_pss_policies()` returns the 18-policy Pod Security Standards set
(11 baseline, 6 restricted, 1 supplementary) used by the benchmark
configs (BASELINE.json) and the CLI smoke path.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import yaml

from ..api.policy import ClusterPolicy

_PSS_DIR = os.path.join(os.path.dirname(__file__), "pss")


def load_policy_file(path: str) -> List[ClusterPolicy]:
    with open(path) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    return [ClusterPolicy.from_dict(d) for d in docs]


def load_pss_policies(subset: Optional[str] = None) -> List[ClusterPolicy]:
    """subset: None for all, or a filename prefix filter."""
    out: List[ClusterPolicy] = []
    for name in sorted(os.listdir(_PSS_DIR)):
        if not name.endswith(".yaml"):
            continue
        if subset and not name.startswith(subset):
            continue
        out.extend(load_policy_file(os.path.join(_PSS_DIR, name)))
    return out
