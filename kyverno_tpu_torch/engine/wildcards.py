# Copied verbatim from kyverno_tpu/engine/wildcards.py.
"""Wildcard expansion in pattern metadata and selectors.

Re-implementation of pkg/engine/wildcards/wildcards.go: validation
patterns may use glob wildcards in `metadata.labels` /
`metadata.annotations` *keys*; before matching, those keys are
expanded against the keys actually present on the resource
(ExpandInMetadata). Label selectors get both keys and values expanded
(ReplaceInSelector), with unmatched wildcard characters replaced by
'0' since Kubernetes selectors reject them.

Unlike the Go code (which mutates the pattern map in place,
wildcards.go:80-86), we return a fresh map so compiled policies stay
immutable across evaluations.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..utils import wildcard
from . import anchor as anchorpkg


def replace_in_selector(match_labels: Dict[str, str], resource_labels: Dict[str, str]) -> Dict[str, str]:
    """Port of ReplaceInSelector (wildcards.go:14) for matchLabels."""
    result: Dict[str, str] = {}
    for k, v in match_labels.items():
        if wildcard.contains_wildcard(k) or wildcard.contains_wildcard(v):
            mk, mv = _expand_wildcards(k, v, resource_labels, match_value=True, replace=True)
            result[mk] = mv
        else:
            result[k] = v
    return result


def _expand_wildcards(
    k: str, v: str, resource_map: Dict[str, str], match_value: bool, replace: bool
) -> Tuple[str, str]:
    for k1, v1 in resource_map.items():
        if wildcard.match(k, k1):
            if not match_value:
                return k1, v1
            elif wildcard.match(v, v1):
                return k1, v1
    if replace:
        k = _replace_wildcard_chars(k)
        v = _replace_wildcard_chars(v)
    return k, v


def _replace_wildcard_chars(s: str) -> str:
    return s.replace("*", "0").replace("?", "0")


def expand_in_metadata(pattern_map: Dict[str, Any], resource_map: Dict[str, Any]) -> Dict[str, Any]:
    """Port of ExpandInMetadata (wildcards.go:62)."""
    meta_key, pattern_metadata = _get_pattern_value("metadata", pattern_map)
    if pattern_metadata is None or not isinstance(pattern_metadata, dict):
        return pattern_map
    resource_metadata = resource_map.get("metadata")
    if resource_metadata is None:
        return pattern_map

    metadata = dict(pattern_metadata)
    labels_key, labels = _expand_wildcards_in_tag("labels", pattern_metadata, resource_metadata)
    if labels is not None:
        metadata[labels_key] = labels
    annotations_key, annotations = _expand_wildcards_in_tag(
        "annotations", pattern_metadata, resource_metadata
    )
    if annotations is not None:
        metadata[annotations_key] = annotations
    result = dict(pattern_map)
    result[meta_key] = metadata
    return result


def _get_pattern_value(tag: str, pattern: Dict[str, Any]) -> Tuple[str, Any]:
    for k, v in pattern.items():
        if k == tag:
            return k, v
        a = anchorpkg.parse(k)
        if a is not None and a.key == tag:
            return k, v
    return "", None


def _expand_wildcards_in_tag(tag: str, pattern_metadata: Any, resource_metadata: Any):
    pattern_key, pattern_data = _get_value_as_string_map(tag, pattern_metadata)
    if pattern_data is None:
        return "", None
    _, resource_data = _get_value_as_string_map(tag, resource_metadata)
    if resource_data is None:
        return "", None
    return pattern_key, _replace_wildcards_in_map_keys(pattern_data, resource_data)


def _get_value_as_string_map(key: str, data: Any) -> Tuple[str, Optional[Dict[str, str]]]:
    if not isinstance(data, dict):
        return "", None
    pattern_key, val = _get_pattern_value(key, data)
    if val is None or not isinstance(val, dict):
        return "", None
    result: Dict[str, str] = {}
    for k, v in val.items():
        if not isinstance(v, str):
            return "", None  # Go would panic on the cast; treat as not-expandable
        result[k] = v
    return pattern_key, result


def _replace_wildcards_in_map_keys(
    pattern_data: Dict[str, str], resource_data: Dict[str, str]
) -> Dict[str, Any]:
    results: Dict[str, Any] = {}
    for k, v in pattern_data.items():
        if wildcard.contains_wildcard(k):
            a = anchorpkg.parse(k)
            if a is not None:
                match_k, _ = _expand_wildcards(a.key, v, resource_data, match_value=False, replace=False)
                results[anchorpkg.anchor_string(a.modifier, match_k)] = v
            else:
                match_k, _ = _expand_wildcards(k, v, resource_data, match_value=False, replace=False)
                results[match_k] = v
        else:
            results[k] = v
    return results
