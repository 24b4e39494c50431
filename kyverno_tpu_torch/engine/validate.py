# Copied verbatim from kyverno_tpu/engine/validate.py.
"""MatchPattern — the recursive validate-overlay tree matcher.

Re-implementation of pkg/engine/validate/validate.go:31-261. The walk
dispatches on the pattern element type (map / array / scalar), applies
anchor semantics two-phase per map (anchors first, then non-anchors
with nested-anchor keys front-loaded), and classifies the outcome:

- ``None``             — resource satisfies the pattern
- PatternError(skip=True)  — a conditional/global anchor did not apply,
  so the rule is *skipped* for this resource
- PatternError(skip=False) — genuine mismatch => rule fails

The fail/skip split (validate.go:36-53) plus the AnchorMap missing-key
bookkeeping are what make anchor semantics subtle; the TPU clause
compiler reproduces exactly this classification as masked reductions.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from . import anchor as anchorpkg
from . import pattern as patternpkg
from . import wildcards
from .anchor import AnchorMap, EngineError


class PatternError(EngineError):
    """Port of validate.PatternError (validate.go:15)."""

    def __init__(self, err: Optional[EngineError], path: str, skip: bool):
        super().__init__(err.message if err is not None else "")
        self.err = err
        self.path = path
        self.skip = skip

    def __repr__(self) -> str:
        return f"PatternError(skip={self.skip}, path={self.path!r}, msg={self.message!r})"


def _combine(errors: List[EngineError]) -> EngineError:
    # go.uber.org/multierr join: combined message separated by "; "
    return EngineError("; ".join(e.message for e in errors))


def match_pattern(resource: Any, pattern: Any) -> Optional[PatternError]:
    """Port of MatchPattern (validate.go:31). None means match."""
    ac = AnchorMap()
    elem_path, err = _validate_resource_element(resource, pattern, pattern, "/", ac)
    if err is not None:
        if anchorpkg.is_conditional_anchor_error(err) or anchorpkg.is_global_anchor_error(err):
            return PatternError(err, "", True)
        if anchorpkg.is_negation_anchor_error(err):
            return PatternError(err, elem_path, False)
        if ac.keys_are_missing():
            return PatternError(err, "", False)
        return PatternError(err, elem_path, False)
    return None


def _validate_resource_element(
    resource_element: Any,
    pattern_element: Any,
    origin_pattern: Any,
    path: str,
    ac: AnchorMap,
) -> Tuple[str, Optional[EngineError]]:
    # validate.go:71-114
    if isinstance(pattern_element, dict):
        if not isinstance(resource_element, dict):
            return path, EngineError(
                f"pattern and resource have different structures. Path: {path}. "
                f"Expected {type(pattern_element).__name__}, found {type(resource_element).__name__}"
            )
        ac.check_anchor_in_resource(pattern_element, resource_element)
        return _validate_map(resource_element, pattern_element, origin_pattern, path, ac)
    if isinstance(pattern_element, list):
        if not isinstance(resource_element, list):
            return path, EngineError(
                f"validation rule failed at path {path}, "
                "resource does not satisfy the expected overlay pattern"
            )
        return _validate_array(resource_element, pattern_element, origin_pattern, path, ac)
    if isinstance(pattern_element, (str, float, int, bool)) or pattern_element is None:
        if isinstance(resource_element, list):
            # scalar pattern vs array resource: every element must match
            for res in resource_element:
                if not patternpkg.validate(res, pattern_element):
                    return path, EngineError(
                        f"resource value '{res}' does not match '{pattern_element}' "
                        f"at path {path}"
                    )
            return "", None
        if not patternpkg.validate(resource_element, pattern_element):
            return path, EngineError(
                f"resource value '{resource_element}' does not match "
                f"'{pattern_element}' at path {path}"
            )
        return "", None
    return path, EngineError(f"failed at '{path}', pattern contains unknown type")


def _validate_map(
    resource_map: dict,
    pattern_map: dict,
    origin_pattern: Any,
    path: str,
    ac: AnchorMap,
) -> Tuple[str, Optional[EngineError]]:
    # validate.go:118-175
    pattern_map = wildcards.expand_in_metadata(pattern_map, resource_map)
    anchors, resources = anchorpkg.get_anchors_resources_from_map(pattern_map)

    # Phase 1: anchors, in sorted key order
    skip_errors: List[EngineError] = []
    apply_count = 0
    for key in sorted(anchors.keys()):
        handler_path, err = anchorpkg.handle_element(
            key, anchors[key], path, _validate_resource_element, resource_map, origin_pattern, ac
        )
        if err is not None:
            if anchorpkg.is_conditional_anchor_error(err) or anchorpkg.is_global_anchor_error(err):
                skip_errors.append(err)
                continue
            return handler_path, err
        apply_count += 1

    if apply_count == 0 and skip_errors:
        return path, PatternError(_combine(skip_errors), path, True)

    # Phase 2: non-anchor keys, keys with nested anchors (and globals) first
    for key in _sorted_nested_anchor_resource(resources):
        handler_path, err = anchorpkg.handle_element(
            key, resources[key], path, _validate_resource_element, resource_map, origin_pattern, ac
        )
        if err is not None:
            return handler_path, err
    return "", None


def _has_nested_anchors(pattern: Any) -> bool:
    # validate/utils.go hasNestedAnchors
    if isinstance(pattern, dict):
        for k in pattern:
            a = anchorpkg.parse(k)
            if (
                anchorpkg.is_condition(a)
                or anchorpkg.is_existence(a)
                or anchorpkg.is_equality(a)
                or anchorpkg.is_negation(a)
                or anchorpkg.is_global(a)
            ):
                return True
        return any(_has_nested_anchors(v) for v in pattern.values())
    if isinstance(pattern, list):
        return any(_has_nested_anchors(v) for v in pattern)
    return False


def _sorted_nested_anchor_resource(resources: dict) -> List[str]:
    # validate/utils.go getSortedNestedAnchorResource: stable sort, then
    # push-front keys that are global anchors or contain nested anchors
    front: List[str] = []
    back: List[str] = []
    for k in sorted(resources.keys()):
        if anchorpkg.is_global(anchorpkg.parse(k)) or _has_nested_anchors(resources[k]):
            front.insert(0, k)  # PushFront reverses relative order
        else:
            back.append(k)
    return front + back


def _validate_array(
    resource_array: list,
    pattern_array: list,
    origin_pattern: Any,
    path: str,
    ac: AnchorMap,
) -> Tuple[str, Optional[EngineError]]:
    # validate.go:177-228
    if len(pattern_array) == 0:
        return path, EngineError("pattern Array empty")

    first = pattern_array[0]
    if isinstance(first, dict):
        # maps in arrays: anchors affect the entire array
        return _validate_array_of_maps(resource_array, first, origin_pattern, path, ac)
    if isinstance(first, (str, float, int, bool)) or first is None:
        return _validate_resource_element(resource_array, first, origin_pattern, path, ac)

    # other types: positional match, resource must be at least as long
    if len(resource_array) < len(pattern_array):
        return "", EngineError(
            f"validate Array failed, array length mismatch, resource Array len is "
            f"{len(resource_array)} and pattern Array len is {len(pattern_array)}"
        )
    apply_count = 0
    skip_errors: List[EngineError] = []
    for i, pattern_element in enumerate(pattern_array):
        current_path = f"{path}{i}/"
        elem_path, err = _validate_resource_element(
            resource_array[i], pattern_element, origin_pattern, current_path, ac
        )
        if err is not None:
            if anchorpkg.is_conditional_anchor_error(err) or anchorpkg.is_global_anchor_error(err):
                skip_errors.append(err)
                continue
            return elem_path, err
        apply_count += 1
    if apply_count == 0 and skip_errors:
        return path, PatternError(_combine(skip_errors), path, True)
    return "", None


def _validate_array_of_maps(
    resource_map_array: list,
    pattern_map: dict,
    origin_pattern: Any,
    path: str,
    ac: AnchorMap,
) -> Tuple[str, Optional[EngineError]]:
    # validate.go:232-261
    apply_count = 0
    skip_errors: List[EngineError] = []
    for i, resource_element in enumerate(resource_map_array):
        current_path = f"{path}{i}/"
        return_path, err = _validate_resource_element(
            resource_element, pattern_map, origin_pattern, current_path, ac
        )
        if err is not None:
            if anchorpkg.is_conditional_anchor_error(err) or anchorpkg.is_global_anchor_error(err):
                skip_errors.append(err)
                continue
            return return_path, err
        apply_count += 1
    if apply_count == 0 and skip_errors:
        return path, PatternError(_combine(skip_errors), path, True)
    return "", None
