# Copied verbatim from kyverno_tpu/engine/jmespath/semver.py.
"""Semver parsing and range evaluation.

Equivalent of blang/semver/v4 as used by the reference's
``semver_compare`` function (pkg/engine/jmespath/functions.go:984):
ranges are space-separated AND groups joined by ``||``; comparators
are ``=``/``==``/``!=``/``>``/``<``/``>=``/``<=`` with optional ``x``
/ ``*`` wildcard components ("1.2.x")."""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

_VER_RE = re.compile(
    r"^(\d+)\.(\d+)\.(\d+)(?:-([0-9A-Za-z.-]+))?(?:\+([0-9A-Za-z.-]+))?$"
)


class SemverError(ValueError):
    pass


class Version:
    __slots__ = ("major", "minor", "patch", "pre")

    def __init__(self, major: int, minor: int, patch: int, pre: Tuple = ()):
        self.major, self.minor, self.patch, self.pre = major, minor, patch, pre

    @classmethod
    def parse(cls, s: str) -> "Version":
        s = s.strip()
        if s.startswith("v"):
            s = s[1:]
        m = _VER_RE.match(s)
        if not m:
            raise SemverError(f"invalid semver {s!r}")
        pre: Tuple = ()
        if m.group(4):
            parts = []
            for p in m.group(4).split("."):
                parts.append(int(p) if p.isdigit() else p)
            pre = tuple(parts)
        return cls(int(m.group(1)), int(m.group(2)), int(m.group(3)), pre)

    def _key(self):
        # release > prerelease; numeric identifiers < alphanumeric
        pre_key: Tuple
        if not self.pre:
            pre_key = ((2,),)  # sorts after any prerelease tuple
        else:
            pre_key = tuple(
                (0, p, "") if isinstance(p, int) else (1, 0, p) for p in self.pre
            )
        return (self.major, self.minor, self.patch, pre_key)

    def __eq__(self, other):
        return self._key() == other._key()

    def __lt__(self, other):
        return self._key() < other._key()

    def __le__(self, other):
        return self == other or self < other


def _expand_wildcard(op: str, ver: str) -> List[Tuple[str, Version]]:
    """Turn comparators with x/*/X components into concrete bounds."""
    parts = ver.split(".")
    while len(parts) < 3:
        parts.append("x")
    wild_at: Optional[int] = None
    for i, p in enumerate(parts[:3]):
        if p.lower() in ("x", "*"):
            wild_at = i
            break
    if wild_at is None:
        return [(op, Version.parse(ver))]
    nums = [int(p) for p in parts[:wild_at]]
    if wild_at == 0:
        low = Version(0, 0, 0)
        return [] if op in ("=", "==", ">=", "<=") else [(op, low)]
    if wild_at == 1:
        low, high = Version(nums[0], 0, 0), Version(nums[0] + 1, 0, 0)
    else:
        low, high = Version(nums[0], nums[1], 0), Version(nums[0], nums[1] + 1, 0)
    if op in ("=", "=="):
        return [(">=", low), ("<", high)]
    if op == ">":
        return [(">=", high)]
    if op == ">=":
        return [(">=", low)]
    if op == "<":
        return [("<", low)]
    if op == "<=":
        return [("<", high)]
    if op == "!=":
        raise SemverError("!= with wildcard is not supported")
    raise SemverError(f"unknown operator {op!r}")


_COMP_RE = re.compile(r"^(>=|<=|==|!=|>|<|=)?\s*(.+)$")


def _check(version: Version, op: str, bound: Version) -> bool:
    if op in ("=", "=="):
        return version == bound
    if op == "!=":
        return not version == bound
    if op == ">":
        return bound < version
    if op == "<":
        return version < bound
    if op == ">=":
        return bound <= version
    return version <= bound  # <=


def match_range(version: str, range_expr: str) -> bool:
    """True if version satisfies the range expression."""
    v = Version.parse(version)
    for or_group in range_expr.split("||"):
        comparators = or_group.split()
        if not comparators:
            continue
        ok = True
        for comp in comparators:
            m = _COMP_RE.match(comp)
            if not m:
                raise SemverError(f"invalid comparator {comp!r}")
            op = m.group(1) or "="
            for sub_op, bound in _expand_wildcard(op, m.group(2)):
                if not _check(v, sub_op, bound):
                    ok = False
                    break
            if not ok:
                break
        if ok:
            return True
    return False
