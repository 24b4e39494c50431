# Copied verbatim from kyverno_tpu/devtools/check_metrics.py.
"""metric-family: every constructed family is registered; labels bounded.

The exposition-format validator (test_observability_tracing) parses
the full registry output — but only families created ON the registry
reach it. A ``Counter("kyverno_new_thing_total", ...)`` built ad hoc
in some module never renders through ``global_registry.exposition()``
and silently never gets scraped or validated. Two sub-checks:

- any instrument construction outside ``observability/metrics.py`` /
  ``analytics.py`` (``.counter("kyverno_...")`` / ``.gauge`` /
  ``.histogram`` / a direct ``Counter(...)``) must use a family name
  already registered by the MetricsRegistry constructor;
- label mappings passed to ``.inc()`` / ``.set()`` / ``.observe()``
  must be dict literals with CONSTANT string keys — a computed label
  KEY is unbounded key cardinality, the classic scrape-killer. (Label
  VALUES may be dynamic; value cardinality is a review concern the
  per-family label contracts document.)
"""

from __future__ import annotations

import ast
from typing import List

from .lintcore import Finding, LintContext

_FACTORY_ATTRS = ("counter", "gauge", "histogram")
_CTOR_NAMES = ("Counter", "Gauge", "Histogram")
_RECORD_ATTRS = ("inc", "set", "observe")
_EXEMPT = ("observability/metrics.py", "observability/analytics.py")


def _label_dict_arg(node: ast.Call):
    """The labels argument of a record call, if present: first dict
    positional or the labels= keyword."""
    for arg in node.args:
        if isinstance(arg, ast.Dict):
            return arg
    for kw in node.keywords:
        if kw.arg == "labels" and isinstance(kw.value, ast.Dict):
            return kw.value
    return None


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for sf in ctx.files:
        exempt = any(sf.rel == e or sf.rel.endswith("/" + e)
                     for e in _EXEMPT)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = None
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _FACTORY_ATTRS:
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    name = node.args[0].value
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in _CTOR_NAMES:
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    name = node.args[0].value
            if name is not None and not exempt \
                    and name.startswith("kyverno") \
                    and name not in ctx.metric_families:
                findings.append(Finding(
                    check="metric-family", file=sf.rel, line=node.lineno,
                    message=(f"metric family {name!r} constructed here is "
                             f"not registered on the MetricsRegistry — it "
                             f"will never reach /metrics or the "
                             f"exposition validator")))
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _RECORD_ATTRS:
                labels = _label_dict_arg(node)
                if labels is None:
                    continue
                for key in labels.keys:
                    if key is None:
                        findings.append(Finding(
                            check="metric-family", file=sf.rel,
                            line=node.lineno,
                            message=("label mapping uses **-expansion — "
                                     "label KEY set must be a bounded "
                                     "literal set")))
                    elif not (isinstance(key, ast.Constant)
                              and isinstance(key.value, str)):
                        findings.append(Finding(
                            check="metric-family", file=sf.rel,
                            line=node.lineno,
                            message=("computed label key in metric record "
                                     "call — label KEYS must be string "
                                     "literals (bounded key cardinality)")))
    return findings
