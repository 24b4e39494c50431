# Copied verbatim from kyverno_tpu/engine/selector.py.
"""Kubernetes label-selector evaluation.

Equivalent of metav1.LabelSelectorAsSelector + labels.Selector.Matches
as used by pkg/utils/match/labels.go CheckSelector. Supports
``matchLabels`` and ``matchExpressions`` with operators In, NotIn,
Exists, DoesNotExist. Wildcards in matchLabels keys/values are
expanded against the resource labels first
(pkg/engine/wildcards/wildcards.go ReplaceInSelector).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

from .wildcards import replace_in_selector


class SelectorError(Exception):
    pass


# k8s label syntax (validation.IsQualifiedName / IsValidLabelValue):
# key = [prefix "/"] name; prefix is a DNS-1123 subdomain (<=253);
# name is alphanumeric with -_. infix, <=63; value likewise, may be "".
_NAME_RE = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9._-]*[A-Za-z0-9])?$")
_DNS1123_RE = re.compile(r"^[a-z0-9]([a-z0-9-]*[a-z0-9])?(\.[a-z0-9]([a-z0-9-]*[a-z0-9])?)*$")


def _validate_label_key(key: str) -> None:
    parts = key.split("/")
    if len(parts) == 1:
        name = parts[0]
    elif len(parts) == 2:
        prefix, name = parts
        if not prefix or len(prefix) > 253 or not _DNS1123_RE.match(prefix):
            raise SelectorError(f"invalid label key prefix {prefix!r}")
    else:
        raise SelectorError(f"invalid label key {key!r}")
    if not name or len(name) > 63 or not _NAME_RE.match(name):
        raise SelectorError(f"invalid label key {key!r}")


def _validate_label_value(value: str) -> None:
    if value == "":
        return
    if len(value) > 63 or not _NAME_RE.match(value):
        raise SelectorError(f"invalid label value {value!r}")


def matches_selector(selector: Optional[Dict[str, Any]], labels: Dict[str, str]) -> bool:
    """Evaluate a LabelSelector dict against a label map.

    Raises SelectorError for malformed selectors (mirrors
    LabelSelectorAsSelector errors, which CheckSelector reports up).
    """
    if selector is None:
        return False
    labels = labels or {}
    match_labels = selector.get("matchLabels") or {}
    # LabelSelectorAsSelector validates syntax before matching; invalid
    # selectors must error (=> "failed to parse selector" match reason),
    # not silently evaluate.
    for k, v in match_labels.items():
        _validate_label_key(str(k))
        _validate_label_value(str(v))
    for expr in selector.get("matchExpressions") or []:
        _validate_label_key(str(expr.get("key") or ""))
        if expr.get("operator") in ("In", "NotIn"):
            for v in expr.get("values") or []:
                _validate_label_value(str(v))
    for k, v in match_labels.items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        key = expr.get("key")
        op = expr.get("operator")
        values = expr.get("values") or []
        if key is None or op is None:
            raise SelectorError(f"invalid match expression: {expr}")
        if op == "In":
            if not values:
                raise SelectorError("values must be specified for In operator")
            if labels.get(key) not in values:
                return False
        elif op == "NotIn":
            if not values:
                raise SelectorError("values must be specified for NotIn operator")
            if key in labels and labels[key] in values:
                return False
        elif op == "Exists":
            if values:
                raise SelectorError("values must not be specified for Exists operator")
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if values:
                raise SelectorError("values must not be specified for DoesNotExist operator")
            if key in labels:
                return False
        else:
            raise SelectorError(f"unknown operator {op!r}")
    return True


def check_selector(selector: Optional[Dict[str, Any]], actual: Dict[str, str]) -> bool:
    """Port of matchutils.CheckSelector (pkg/utils/match/labels.go):
    expands wildcards in matchLabels against the actual labels, then
    evaluates. Raises SelectorError on malformed selectors."""
    if selector is None:
        return False
    actual = actual or {}
    expanded = dict(selector)
    if selector.get("matchLabels"):
        ml = {str(k): str(v) for k, v in selector["matchLabels"].items()}
        expanded["matchLabels"] = replace_in_selector(ml, actual)
    return matches_selector(expanded, actual)
