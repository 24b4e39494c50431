# Copied verbatim from kyverno_tpu/engine/pattern.py.
"""The scalar pattern language — leaf comparisons of the validate overlay.

Faithful re-implementation of the reference's
pkg/engine/pattern/pattern.go:26-323 (``pattern.Validate``):

- pattern type drives dispatch (bool/int/float/nil/map/string);
  arrays are not valid patterns.
- string patterns support ``|`` (OR) of ``&`` (AND) conditions, each
  condition carrying an optional operator prefix
  (kyverno_tpu.engine.operator) and range forms.
- operand comparison tries Go-duration compare first, then k8s
  quantity compare, then wildcard string compare (pattern.go:207-215).

Python notes: JSON/YAML give ``bool`` before ``int`` in isinstance
checks (bool subclasses int); Go's encoding/json turns all numbers
into float64, so both int and float paths must behave identically for
integral values — the reference handles this with its Trunc checks,
which we mirror.
"""

from __future__ import annotations

import math
import re
from typing import Any

from ..utils import wildcard
from ..utils.duration import parse_duration
from ..utils.quantity import parse_quantity
from .operator import (
    IN_RANGE_RE,
    NOT_IN_RANGE_RE,
    Operator,
    get_operator_from_string_pattern,
)


def validate(value: Any, pattern: Any) -> bool:
    """Port of pattern.Validate (pattern.go:26)."""
    if isinstance(pattern, bool):
        return _validate_bool(value, pattern)
    if isinstance(pattern, int):
        return _validate_int(value, pattern)
    if isinstance(pattern, float):
        return _validate_float(value, pattern)
    if pattern is None:
        return _validate_nil(value)
    if isinstance(pattern, dict):
        return isinstance(value, dict)  # existence only (pattern.go:141)
    if isinstance(pattern, str):
        return _validate_string_patterns(value, pattern)
    if isinstance(pattern, list):
        return False  # arrays are not supported as patterns (pattern.go:43)
    return False


def _validate_bool(value: Any, pattern: bool) -> bool:
    return isinstance(value, bool) and value == pattern


def _validate_int(value: Any, pattern: int) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, int):
        return value == pattern
    if isinstance(value, float):
        if value != math.trunc(value):
            return False
        return int(value) == pattern
    if isinstance(value, str):
        parsed = go_parse_int(value)
        return parsed is not None and parsed == pattern
    return False


# Go strconv.ParseInt(s, 10, 64) / ParseFloat(s, 64) grammars: no
# surrounding whitespace, no underscores (base-10), optional sign;
# floats allow decimal/exponent forms plus inf/nan spellings.
_GO_INT_RE = re.compile(r"^[+-]?\d+$")
_GO_FLOAT_RE = re.compile(r"^[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?$")
_GO_INF_NAN_RE = re.compile(r"^[+-]?(inf(inity)?|nan)$", re.IGNORECASE)


def go_parse_int(s: str):
    if not _GO_INT_RE.match(s):
        return None
    return int(s, 10)


def go_parse_float(s: str):
    if _GO_FLOAT_RE.match(s):
        return float(s)
    if _GO_INF_NAN_RE.match(s):
        return float(s.lower().replace("infinity", "inf"))
    return None


def _validate_float(value: Any, pattern: float) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, int):
        if pattern != math.trunc(pattern):
            return False
        return int(pattern) == value
    if isinstance(value, float):
        return value == pattern
    if isinstance(value, str):
        parsed = go_parse_float(value)
        return parsed is not None and parsed == pattern
    return False


def _validate_nil(value: Any) -> bool:
    # pattern.go:118-139
    if value is None:
        return True
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value == 0
    if isinstance(value, str):
        return value == ""
    return False


def _validate_string_patterns(value: Any, pattern: str) -> bool:
    # pattern.go:152-163
    if isinstance(value, str) and value == pattern:
        return True
    for condition in pattern.split("|"):
        condition = condition.strip(" ")
        if _check_and_conditions(value, condition):
            return True
    return False


def _check_and_conditions(value: Any, pattern: str) -> bool:
    # pattern.go:165-173
    for condition in pattern.split("&"):
        if not _validate_string_pattern(value, condition.strip(" ")):
            return False
    return True


def _validate_string_pattern(value: Any, pattern: str) -> bool:
    # pattern.go:175-197
    op = get_operator_from_string_pattern(pattern)
    if op is Operator.IN_RANGE:
        m = IN_RANGE_RE.match(pattern)
        if not m:
            return False
        return _validate_string_pattern(value, f">= {m.group(1)}") and _validate_string_pattern(
            value, f"<= {m.group(2)}"
        )
    if op is Operator.NOT_IN_RANGE:
        m = NOT_IN_RANGE_RE.match(pattern)
        if not m:
            return False
        return _validate_string_pattern(value, f"< {m.group(1)}") or _validate_string_pattern(
            value, f"> {m.group(2)}"
        )
    operand = pattern[len(op.value):].strip()
    return _validate_string(value, operand, op)


def _validate_string(value: Any, pattern: str, op: Operator) -> bool:
    # pattern.go:207-215 — duration first, then quantity, then string
    res = _compare_duration(value, pattern, op)
    if res is not None:
        return res
    res = _compare_quantity(value, pattern, op)
    if res is not None:
        return res
    return _compare_string(value, pattern, op)


def _convert_number_to_string(value: Any):
    # pattern.go:307-323 — nil => "0"; float64 => "%f" (6 decimals)
    if value is None:
        return "0"
    if isinstance(value, bool):
        return None  # Go: bool not handled => error
    if isinstance(value, str):
        return value
    if isinstance(value, float):
        return "%f" % value
    if isinstance(value, int):
        return str(value)
    return None


def _compare_duration(value: Any, pattern: str, op: Operator):
    # pattern.go:217-241; returns None when "not processed"
    p = parse_duration(pattern)
    if p is None:
        return None
    vs = _convert_number_to_string(value)
    if vs is None:
        return None
    v = parse_duration(vs)
    if v is None:
        return None
    if op is Operator.EQUAL:
        return v == p
    if op is Operator.NOT_EQUAL:
        return v != p
    if op is Operator.MORE:
        return v > p
    if op is Operator.LESS:
        return v < p
    if op is Operator.MORE_EQUAL:
        return v >= p
    if op is Operator.LESS_EQUAL:
        return v <= p
    return False  # range ops never reach here, mirror "return false, false"


def _compare_quantity(value: Any, pattern: str, op: Operator):
    # pattern.go:243-268; returns None when "not processed"
    p = parse_quantity(pattern)
    if p is None:
        return None
    vs = _convert_number_to_string(value)
    if vs is None:
        return None
    v = parse_quantity(vs)
    if v is None:
        return None
    if op is Operator.EQUAL:
        return v == p
    if op is Operator.NOT_EQUAL:
        return v != p
    if op is Operator.MORE:
        return v > p
    if op is Operator.LESS:
        return v < p
    if op is Operator.MORE_EQUAL:
        return v >= p
    if op is Operator.LESS_EQUAL:
        return v <= p
    return False


def go_format_float_e(v: float) -> str:
    """strconv.FormatFloat(v, 'E', -1, 64): minimal digits, E notation.

    e.g. 2.0 -> "2E+00", 1.5 -> "1.5E+00", 0.001 -> "1E-03".
    Non-finite values format like Go: "+Inf", "-Inf", "NaN".
    """
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    mant, exp = f"{v:.17E}".split("E")
    # shortest repr that round-trips, like Go's -1 precision
    for prec in range(0, 18):
        s = f"{v:.{prec}E}"
        if float(s) == v:
            mant, exp = s.split("E")
            break
    exp_i = int(exp)
    sign = "+" if exp_i >= 0 else "-"
    mant = mant.rstrip("0").rstrip(".") if "." in mant else mant
    return f"{mant}E{sign}{abs(exp_i):02d}"


def _compare_string(value: Any, pattern: str, op: Operator) -> bool:
    # pattern.go:270-305 — only Equal/NotEqual apply to strings
    if op not in (Operator.EQUAL, Operator.NOT_EQUAL):
        return False
    if isinstance(value, bool):
        s = "true" if value else "false"
    elif isinstance(value, float):
        s = go_format_float_e(value)
    elif isinstance(value, int):
        s = str(value)
    elif isinstance(value, str):
        s = value
    else:
        return False  # nil and everything else: "unexpected type"
    result = wildcard.match(pattern, s)
    return not result if op is Operator.NOT_EQUAL else result
