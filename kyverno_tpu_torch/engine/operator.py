# Copied verbatim from kyverno_tpu/engine/operator.py.
"""Scalar-pattern operator parsing.

Semantics of the reference's pkg/engine/operator/operator.go:10-61:
operators are textual prefixes of a pattern string — ``>=``, ``<=``,
``>``, ``<``, ``!`` — plus two range forms recognized by regex:
``a-b`` (InRange) and ``a!-b`` (NotInRange). Absence of a prefix (or a
pattern shorter than 2 chars) means Equal. Prefix checks run before
the range regexes, so ``!10-20`` parses as NotEqual over "10-20".
"""

from __future__ import annotations

import re
from enum import Enum


class Operator(str, Enum):
    EQUAL = ""
    MORE_EQUAL = ">="
    LESS_EQUAL = "<="
    NOT_EQUAL = "!"
    MORE = ">"
    LESS = "<"
    IN_RANGE = "-"
    NOT_IN_RANGE = "!-"


# Mirrors operator.go:30-31 (note: the char class [-|+] includes '|').
IN_RANGE_RE = re.compile(r"^([-|+]?\d+(?:\.\d+)?[A-Za-z]*)-([-|+]?\d+(?:\.\d+)?[A-Za-z]*)$")
NOT_IN_RANGE_RE = re.compile(r"^([-|+]?\d+(?:\.\d+)?[A-Za-z]*)!-([-|+]?\d+(?:\.\d+)?[A-Za-z]*)$")


def get_operator_from_string_pattern(pattern: str) -> Operator:
    """Port of GetOperatorFromStringPattern (operator.go:35)."""
    if len(pattern) < 2:
        return Operator.EQUAL
    if pattern.startswith(">="):
        return Operator.MORE_EQUAL
    if pattern.startswith("<="):
        return Operator.LESS_EQUAL
    if pattern.startswith(">"):
        return Operator.MORE
    if pattern.startswith("<"):
        return Operator.LESS
    if pattern.startswith("!"):
        return Operator.NOT_EQUAL
    if NOT_IN_RANGE_RE.match(pattern):
        return Operator.NOT_IN_RANGE
    if IN_RANGE_RE.match(pattern):
        return Operator.IN_RANGE
    return Operator.EQUAL
