# Copied verbatim from kyverno_tpu/utils/duration.py.
"""Go ``time.ParseDuration`` semantics.

The reference compares durations in its scalar pattern language
(pkg/engine/pattern/pattern.go:217 compareDuration) and in the
precondition Duration* operators. Both rely on Go's duration grammar:

    [+-]? (number unit)+   with unit in {ns, us, "µs", "μs", ms, s, m, h}

A bare number without a unit is an error, except the literal "0".
Fractions are allowed ("1.5h"). The result is an int64 nanosecond
count; we return a Python int (unbounded) and ignore Go's overflow.
"""

from __future__ import annotations

from typing import Optional

_UNITS = {
    "ns": 1,
    "us": 1_000,
    "µs": 1_000,  # U+00B5 micro sign
    "μs": 1_000,  # U+03BC greek mu
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60_000_000_000,
    "h": 3_600_000_000_000,
}


def parse_duration(s: object) -> Optional[int]:
    """Parse a Go duration string to nanoseconds; None if invalid."""
    if not isinstance(s, str):
        return None
    orig = s
    neg = False
    if s and s[0] in "+-":
        neg = s[0] == "-"
        s = s[1:]
    if s == "0":
        return 0
    if not s:
        return None
    total = 0
    while s:
        # leading integer part
        i = 0
        while i < len(s) and s[i].isdigit():
            i += 1
        int_part = s[:i]
        s = s[i:]
        frac_part = ""
        if s.startswith("."):
            s = s[1:]
            j = 0
            while j < len(s) and s[j].isdigit():
                j += 1
            frac_part = s[:j]
            s = s[j:]
            if not int_part and not frac_part:
                return None
        elif not int_part:
            return None
        # unit: longest match first (2-char units before 1-char)
        unit = None
        for u in ("µs", "μs", "ns", "us", "ms", "h", "m", "s"):
            if s.startswith(u):
                unit = u
                break
        if unit is None:
            return None  # bare number like "300" is invalid (orig=%r) % orig
        s = s[len(unit):]
        scale = _UNITS[unit]
        v = int(int_part or "0") * scale
        if frac_part:
            # fractional nanoseconds truncate toward zero, like Go
            v += int(int(frac_part) * scale / (10 ** len(frac_part)))
        total += v
    return -total if neg else total
