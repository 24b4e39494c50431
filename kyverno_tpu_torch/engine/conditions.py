# Copied verbatim from kyverno_tpu/engine/conditions.py.
"""Precondition / deny-condition evaluation with the 18 operators.

Re-implementation of pkg/engine/variables/operator/* and
pkg/engine/internal/preconditions.go. Conditions come as
``{any: [...], all: [...]}`` or a legacy flat list; each condition is
``{key, operator, value[, message]}`` where key and value undergo
variable substitution first (with the preconditions resolver that maps
unresolved variables to null).

Operator semantics (per the reference's per-operator files):

- Equals/NotEquals: type-directed; strings try Go-duration compare
  first, then k8s quantity, then wildcard match where the *value* is
  the glob pattern (equal.go:70-99).
- AllIn/AnyIn/AllNotIn/AnyNotIn (and deprecated In/NotIn): key scalars
  stringify; membership is wildcard-match in either direction; string
  values may be a JSON-encoded array or an InRange expression
  (anyin.go/allin.go).
- GreaterThan(OrEquals)/LessThan(OrEquals): numeric with coercion from
  durations, quantities, then float/int parsing, then semver
  (numeric.go).
- Duration*: deprecated duration comparisons where bare numbers count
  as seconds (duration.go, operator.go:85-140 parseDuration).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from ..utils import wildcard
from ..utils.duration import parse_duration
from ..utils.quantity import parse_quantity
from .context import Context
from .jmespath.semver import SemverError, Version
from .operator import Operator as PatternOp
from .operator import get_operator_from_string_pattern
from . import pattern as patternpkg
from .variables import precondition_resolver, substitute_all


def _go_sprint(v: Any) -> str:
    """fmt.Sprint for scalars."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return str(int(v)) if v == int(v) else repr(v)
    if v is None:
        return "<nil>"
    return str(v)


def _parse_op_duration(key: Any, value: Any) -> Optional[Tuple[int, int]]:
    """operator.go:85-140 parseDuration: at least one side must be a
    real duration string (and not "0"); the other may be a number of
    seconds."""
    key_d = parse_duration(key) if isinstance(key, str) and key != "0" else None
    val_d = parse_duration(value) if isinstance(value, str) and value != "0" else None
    if key_d is None and val_d is None:
        return None
    if key_d is None:
        if isinstance(key, bool) or not isinstance(key, (int, float)):
            return None
        key_d = int(key * 1_000_000_000)
    if val_d is None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return None
        val_d = int(value * 1_000_000_000)
    return key_d, val_d


# ---------------------------------------------------------------------------
# Equals


def _equals(key: Any, value: Any) -> bool:
    if isinstance(key, bool):
        return isinstance(value, bool) and key == value
    if isinstance(key, (int, float)):
        return _equals_number(float(key), value)
    if isinstance(key, str):
        return _equals_string(key, value)
    if isinstance(key, dict):
        return isinstance(value, dict) and key == value
    if isinstance(key, list):
        return isinstance(value, list) and key == value
    return False


def _equals_number(key: float, value: Any) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, (int, float)):
        return key == float(value)
    if isinstance(value, str):
        try:
            return float(value) == key
        except ValueError:
            return False
    return False


def _equals_string(key: str, value: Any) -> bool:
    # duration first (equal.go:71-75)
    durations = _parse_op_duration(key, value)
    if durations is not None:
        return durations[0] == durations[1]
    # quantity (equal.go:77-89)
    kq = parse_quantity(key)
    if kq is not None and isinstance(value, str):
        vq = parse_quantity(value)
        if vq is not None:
            return kq == vq
        return False
    if isinstance(value, str):
        return wildcard.match(value, key)  # value is the glob pattern
    return False


# ---------------------------------------------------------------------------
# set membership


def _wild_either(a: str, b: str) -> bool:
    return wildcard.match(a, b) or wildcard.match(b, a)


def _value_as_string_list(value: Any) -> Optional[List[str]]:
    """anyin.go:80-88: a string value that is VALID JSON must unmarshal
    as a string array (else invalid type => None); invalid JSON is a
    singleton literal."""
    if isinstance(value, list):
        return [_go_sprint(v) for v in value]
    if isinstance(value, str):
        try:
            # Go's json rejects NaN/Infinity literals; Python accepts
            # them by default, which would misclassify e.g. "Infinity"
            # as valid-JSON-but-not-array (None) instead of a singleton
            arr = json.loads(value, parse_constant=_reject_constant)
        except ValueError:
            return [value]
        if isinstance(arr, list) and all(isinstance(x, str) for x in arr):
            return arr
        return None
    return None


def _reject_constant(name: str):
    raise ValueError(f"invalid JSON constant {name}")


def _key_exists_in_array(key: str, value: Any) -> Optional[bool]:
    """anyin.go:61 anyKeyExistsInArray / allin.go allKeyExistsInArray.
    Returns None for an invalid value type (nil, map, JSON-but-not-
    string-array), which evaluates to False for BOTH the In and NotIn
    directions upstream (anynotin.go:44-50)."""
    if isinstance(value, list):
        return any(_wild_either(_go_sprint(v), key) for v in value)
    if isinstance(value, str):
        if wildcard.match(value, key):
            return True
        if get_operator_from_string_pattern(value) is PatternOp.IN_RANGE:
            return patternpkg.validate(key, value)
        arr = _value_as_string_list(value)
        if arr is None:
            return None  # valid JSON that is not a string array
        return any(key == v for v in arr)
    return None  # invalidType


def _set_in(keys: List[str], value: Any, mode: str) -> bool:
    """mode: any_in | all_in | any_not_in | all_not_in."""
    if isinstance(value, str):
        if len(keys) == 1 and keys[0] == value:
            return mode in ("any_in", "all_in")
        if get_operator_from_string_pattern(value) is PatternOp.IN_RANGE:
            if mode == "any_in":
                return any(patternpkg.validate(k, value) for k in keys)
            if mode == "all_in":
                return all(patternpkg.validate(k, value) for k in keys)
            not_range = value.replace("-", "!-", 1)
            if mode == "any_not_in":
                return any(patternpkg.validate(k, not_range) for k in keys)
            return all(patternpkg.validate(k, not_range) for k in keys)
        arr = _value_as_string_list(value)
        if arr is None:
            return False
        value = arr
    if isinstance(value, list):
        vals = [_go_sprint(v) for v in value]
        in_mask = [any(_wild_either(k, v) for v in vals) for k in keys]
        if mode == "any_in":
            return any(in_mask)
        if mode == "all_in":
            return all(in_mask)
        if mode == "any_not_in":
            return any(not b for b in in_mask)
        return all(not b for b in in_mask)
    return False


def _deprecated_in(key: Any, value: Any, not_in: bool) -> bool:
    """Deprecated In/NotIn (in.go): stricter than the AnyIn family —
    no InRange, no lenient singleton fallback for non-JSON strings,
    exact (non-wildcard) membership for list keys, and invalid types
    evaluate to false for BOTH In and NotIn."""
    if isinstance(key, bool) or isinstance(key, (int, float)):
        key = _go_sprint(key)
    if isinstance(key, str):
        # keyExistsInArray (in.go:60)
        if isinstance(value, list):
            exists = any(_wild_either(_go_sprint(v), key) for v in value)
            return (not exists) if not_in else exists
        if isinstance(value, str):
            if wildcard.match(value, key):
                return not not_in
            try:
                arr = json.loads(value)
            except ValueError:
                return False  # invalidType
            if not isinstance(arr, list) or not all(isinstance(x, str) for x in arr):
                return False  # invalidType
            exists = key in arr
            return (not exists) if not_in else exists
        return False  # invalidType
    if isinstance(key, list):
        keys = []
        for k in key:
            if not isinstance(k, str):
                return False  # in.go:35-40: non-string key elements
            keys.append(k)
        # setExistsInArray (in.go:108): exact membership, no wildcards
        if isinstance(value, list):
            vals = []
            for v in value:
                if not isinstance(v, str):
                    return False  # invalidType
                vals.append(v)
        elif isinstance(value, str):
            if len(keys) == 1 and keys[0] == value:
                return True  # quirk: early keyExists even for NotIn
            try:
                arr = json.loads(value)
            except ValueError:
                return False
            if not isinstance(arr, list) or not all(isinstance(x, str) for x in arr):
                return False
            vals = arr
        else:
            return False
        if not_in:
            return any(k not in set(vals) for k in keys)
        return all(k in set(vals) for k in keys)
    return False


def _membership(key: Any, value: Any, mode: str) -> bool:
    if isinstance(key, bool) or isinstance(key, (int, float)):
        key = _go_sprint(key)
    if isinstance(key, str):
        hit = _key_exists_in_array(key, value)
        if hit is None:
            return False  # invalid value type: false both ways
        if mode in ("any_in", "all_in"):
            return hit
        return not hit
    if isinstance(key, list):
        keys = [_go_sprint(k) for k in key]
        return _set_in(keys, value, mode)
    return False


# ---------------------------------------------------------------------------
# numeric


def _cmp(key: float, value: float, op: str) -> bool:
    if op == "GreaterThanOrEquals":
        return key >= value
    if op == "GreaterThan":
        return key > value
    if op == "LessThanOrEquals":
        return key <= value
    return key < value  # LessThan


def _numeric(key: Any, value: Any, op: str) -> bool:
    if isinstance(key, bool):
        return False
    if isinstance(key, (int, float)):
        return _numeric_number(float(key), value, op)
    if isinstance(key, str):
        # numeric.go:153-180: duration, quantity, float, int, semver
        durations = _parse_op_duration(key, value)
        if durations is not None:
            return _cmp(durations[0] / 1e9, durations[1] / 1e9, op)
        kq = parse_quantity(key)
        if kq is not None and isinstance(value, str):
            vq = parse_quantity(value)
            if vq is not None:
                c = -1 if kq < vq else (1 if kq > vq else 0)
                return _cmp(float(c), 0.0, op)
        try:
            return _numeric_number(float(key), value, op)
        except (ValueError, TypeError):
            pass
        try:
            kv = Version.parse(key)
            if isinstance(value, str):
                return _cmp_version(kv, Version.parse(value), op)
            return False
        except SemverError:
            return False
    return False


def _cmp_version(key: Version, value: Version, op: str) -> bool:
    if op == "GreaterThanOrEquals":
        return value <= key
    if op == "GreaterThan":
        return value < key
    if op == "LessThanOrEquals":
        return key <= value
    return key < value


def _numeric_number(key: float, value: Any, op: str) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, (int, float)):
        return _cmp(key, float(value), op)
    if isinstance(value, str):
        durations = _parse_op_duration(key, value)
        if durations is not None:
            return _cmp(durations[0] / 1e9, durations[1] / 1e9, op)
        try:
            return _cmp(key, float(value), op)
        except ValueError:
            return False
    return False


def _duration_op(key: Any, value: Any, op: str) -> bool:
    # duration.go: bare numbers are seconds
    def to_ns(v):
        if isinstance(v, str):
            d = parse_duration(v)
            if d is not None:
                return d
            return None
        if isinstance(v, bool):
            return None
        if isinstance(v, (int, float)):
            return int(v * 1e9)
        return None

    k, v = to_ns(key), to_ns(value)
    if k is None or v is None:
        return False
    base = {"DurationGreaterThanOrEquals": "GreaterThanOrEquals",
            "DurationGreaterThan": "GreaterThan",
            "DurationLessThanOrEquals": "LessThanOrEquals",
            "DurationLessThan": "LessThan"}[op]
    return _cmp(float(k), float(v), base)


# ---------------------------------------------------------------------------
# dispatch


def evaluate_condition_values(key: Any, operator: str, value: Any) -> bool:
    """Evaluate one condition with already-substituted key/value."""
    op = operator.lower()
    if op in ("equal", "equals"):
        return _equals(key, value)
    if op in ("notequal", "notequals"):
        # notequal.go:47-49: an unsupported key type (nil, etc.) is
        # false for NotEquals too, NOT the negation of Equals
        if key is None or not isinstance(key, (bool, int, float, str, dict, list)):
            return False
        return not _equals(key, value)
    if op == "in":
        return _deprecated_in(key, value, not_in=False)
    if op == "anyin":
        return _membership(key, value, "any_in")
    if op == "allin":
        return _membership(key, value, "all_in")
    if op == "notin":
        return _deprecated_in(key, value, not_in=True)
    if op == "anynotin":
        return _membership(key, value, "any_not_in")
    if op == "allnotin":
        return _membership(key, value, "all_not_in")
    if op in ("greaterthanorequals", "greaterthan", "lessthanorequals", "lessthan"):
        canon = {
            "greaterthanorequals": "GreaterThanOrEquals",
            "greaterthan": "GreaterThan",
            "lessthanorequals": "LessThanOrEquals",
            "lessthan": "LessThan",
        }[op]
        return _numeric(key, value, canon)
    if op.startswith("duration"):
        canon = {
            "durationgreaterthanorequals": "DurationGreaterThanOrEquals",
            "durationgreaterthan": "DurationGreaterThan",
            "durationlessthanorequals": "DurationLessThanOrEquals",
            "durationlessthan": "DurationLessThan",
        }.get(op)
        if canon is None:
            return False
        return _duration_op(key, value, canon)
    return False


def evaluate_condition(ctx: Optional[Context], condition: Dict[str, Any]) -> bool:
    """Substitute key/value then evaluate (internal/preconditions.go)."""
    key = substitute_all(ctx, condition.get("key"), precondition_resolver)
    value = substitute_all(ctx, condition.get("value"), precondition_resolver)
    return evaluate_condition_values(key, condition.get("operator", ""), value)


def evaluate_conditions(ctx: Optional[Context], conditions: Any) -> bool:
    """AnyAllConditions ({any:[], all:[]}) or a legacy flat list (ANDed).
    Returns True when the conditions pass (empty = pass)."""
    if conditions is None:
        return True
    if isinstance(conditions, list):
        # legacy flat list => all must pass; also handles a list of
        # any/all blocks (ANDed together, spec_types semantics)
        for item in conditions:
            if isinstance(item, dict) and ("any" in item or "all" in item):
                if not evaluate_conditions(ctx, item):
                    return False
            elif isinstance(item, dict):
                if not evaluate_condition(ctx, item):
                    return False
            else:
                return False
        return True
    if isinstance(conditions, dict):
        any_list = conditions.get("any") or []
        all_list = conditions.get("all") or []
        if any_list:
            if not any(evaluate_condition(ctx, c) for c in any_list):
                return False
        if all_list:
            if not all(evaluate_condition(ctx, c) for c in all_list):
                return False
        return True
    return False
