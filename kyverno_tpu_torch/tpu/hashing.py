# Copied verbatim from kyverno_tpu/tpu/hashing.py.
"""Deterministic 64-bit hashing for path/string interning.

Device programs compare strings as FNV-1a 64-bit hashes split into two
uint32 lanes (JAX x64 mode stays off). Collision probability across a
policy-set + snapshot vocabulary (~1e6 strings) is ~1e-7; canonical
hashes are additionally namespaced by a one-byte tag so value-space and
path-space hashes cannot alias each other.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF

# path segments are joined with an unlikely separator; array levels are
# the reserved segment "[]"
PATH_SEP = "\x1f"
ARRAY_SEG = "[]"


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def hash_str(s: str, tag: str = "") -> int:
    """Hash a string, optionally namespaced by a tag byte."""
    return fnv1a64((tag + s).encode("utf-8"))


def hash_path(segments: Iterable[str]) -> int:
    return hash_str(PATH_SEP.join(segments), tag="p")


def split32(h: int) -> Tuple[int, int]:
    """64-bit hash -> (hi, lo) uint32 lanes."""
    return (h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF


# canonical value-space hashes -------------------------------------------------
#
# Equality on device is exact via canonical-form hashes computed the
# same way on the encode side (resource values) and the compile side
# (pattern operands). Ordering comparisons use f32 lanes (approximate
# only in the final ulp; see flatten.py).


def canon_number(v) -> int:
    """Canonical hash for a Go-style number: integral floats collapse
    to their integer spelling so 2 == 2.0 holds."""
    if isinstance(v, bool):  # guard: bools are not numbers here
        raise TypeError("bool is not a number")
    if isinstance(v, int):
        return hash_str(str(v), tag="n")
    if math.isfinite(v) and v == int(v) and abs(v) < 2**63:
        return hash_str(str(int(v)), tag="n")
    return hash_str(repr(float(v)), tag="n")


def canon_quantity(fraction) -> int:
    """Canonical hash for a parsed k8s quantity (Fraction)."""
    return hash_str(f"{fraction.numerator}/{fraction.denominator}", tag="q")


def canon_duration(ns: int) -> int:
    """Canonical hash for a parsed Go duration (integer nanoseconds)."""
    return hash_str(str(int(ns)), tag="d")
