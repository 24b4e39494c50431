# Copied verbatim from kyverno_tpu/cel/errors.py.
"""CEL error model.

Runtime errors (no_such_field, no such overload, division by zero,
index out of range) are VALUES in CEL's semantics: `||`/`&&` and the
aggregate macros absorb them when the other operand determines the
result (cel-spec: logic operators are commutative and error-absorbing).
They are raised as CelError and caught at absorption points."""

from __future__ import annotations


class CelError(Exception):
    """Runtime evaluation error."""


class CelSyntaxError(CelError):
    """Parse-time error — expressions that fail to parse are compile
    errors, reported once at policy admission."""


def no_such_overload(op: str, *vals) -> CelError:
    types = ", ".join(type_name(v) for v in vals)
    return CelError(f"found no matching overload for '{op}' applied to ({types})")


def type_name(v) -> str:
    if v is None:
        return "null_type"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "double"
    if isinstance(v, str):
        return "string"
    if isinstance(v, bytes):
        return "bytes"
    if isinstance(v, list):
        return "list"
    if isinstance(v, dict):
        return "map"
    return type(v).__name__
