# Copied verbatim from kyverno_tpu/utils/quantity.py.
"""Kubernetes ``resource.Quantity`` parsing and comparison.

The reference compares quantities in the scalar pattern language
(pkg/engine/pattern/pattern.go:243 compareQuantity via
k8s.io/apimachinery ParseQuantity/Cmp). Grammar:

    quantity      = signedNumber suffix?
    suffix        = binarySI | decimalSI | decimalExponent
    binarySI      = Ki | Mi | Gi | Ti | Pi | Ei          (2^10k)
    decimalSI     = n | u | m | "" | k | M | G | T | P | E (10^3k)
    decimalExponent = (e|E) signedNumber

We parse to an exact ``fractions.Fraction`` so comparisons are exact
for mixed suffixes (1024Mi == 1Gi, 0.1 < 100m+eps, etc.).
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Optional

_QTY_RE = re.compile(
    r"^([+-]?(?:\d+(?:\.\d*)?|\.\d+))"
    r"(Ki|Mi|Gi|Ti|Pi|Ei|[eE][+-]?\d+|n|u|m|k|M|G|T|P|E)?$"
)

_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DECIMAL = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}


def parse_quantity(s: object) -> Optional[Fraction]:
    """Parse a quantity string to an exact Fraction; None if invalid."""
    if not isinstance(s, str):
        return None
    # no whitespace trimming: apiresource.ParseQuantity rejects it
    m = _QTY_RE.match(s)
    if not m:
        return None
    num_str, suffix = m.group(1), m.group(2)
    try:
        base = Fraction(num_str)
    except (ValueError, ZeroDivisionError):
        return None
    if suffix is None:
        return base
    if suffix in _BINARY:
        return base * _BINARY[suffix]
    if suffix in _DECIMAL:
        return base * _DECIMAL[suffix]
    # decimal exponent: e.g. "12e6"
    exp = int(suffix[1:])
    return base * (Fraction(10) ** exp if exp >= 0 else Fraction(1, 10 ** (-exp)))


def quantity_format(s: str) -> str:
    """Classify a quantity string's format like k8s does: "BinarySI",
    "DecimalExponent" or "DecimalSI"."""
    if any(s.endswith(x) for x in _BINARY):
        return "BinarySI"
    if "e" in s or "E" in s:
        return "DecimalExponent"
    return "DecimalSI"


_BIN_ORDER = [("Ei", 2**60), ("Pi", 2**50), ("Ti", 2**40), ("Gi", 2**30), ("Mi", 2**20), ("Ki", 2**10)]
_DEC_ORDER = [("E", 10**18), ("P", 10**15), ("T", 10**12), ("G", 10**9), ("M", 10**6), ("k", 10**3)]
_DEC_SUB = [("m", Fraction(1, 10**3)), ("u", Fraction(1, 10**6)), ("n", Fraction(1, 10**9))]


def format_quantity(value: Fraction, fmt: str = "DecimalSI") -> str:
    """Render a Fraction back to a canonical quantity string, like
    k8s Quantity.String(): largest suffix that keeps an integral
    mantissa (BinarySI falls back to decimal when not a 1024-multiple)."""
    if value == 0:
        return "0"
    sign = "-" if value < 0 else ""
    v = -value if value < 0 else value
    order = _BIN_ORDER if fmt == "BinarySI" else _DEC_ORDER
    for suffix, mult in order:
        q = v / mult
        if q.denominator == 1 and q.numerator >= 1:
            return f"{sign}{q.numerator}{suffix}"
    if v.denominator == 1:
        return f"{sign}{v.numerator}"
    for suffix, mult in _DEC_SUB:
        q = v / mult
        if q.denominator == 1:
            return f"{sign}{q.numerator}{suffix}"
    # non-integral in all suffixes: decimal with up to 9 fractional digits
    scaled = v * 10**9
    n = scaled.numerator // scaled.denominator
    s = f"{n / 10**9:.9f}".rstrip("0").rstrip(".")
    return sign + s
