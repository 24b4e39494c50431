# Copied verbatim from kyverno_tpu/utils/wildcard.py.
"""Glob wildcard matching.

Semantics of the reference's ext/wildcard/match.go (which delegates to
github.com/IGLOU-EU/go-wildcard v1.0.3): ``*`` matches any sequence of
characters (including empty), ``?`` matches exactly one character.
There are no character classes and no escape sequences. An empty
pattern matches only the empty string; the pattern ``"*"`` matches
everything (verified against ext/wildcard/match_test.go cases 1-37).
"""

from __future__ import annotations


def match(pattern: str, name: str) -> bool:
    """Report whether ``name`` matches the glob ``pattern``.

    Iterative two-pointer glob algorithm (O(n*m) worst case, O(n+m)
    typical) equivalent to the DP over pattern/text positions.
    """
    p_len, n_len = len(pattern), len(name)
    p = n = 0
    star_p = -1  # position of last '*' in pattern
    star_n = 0  # position in name when last '*' was seen
    while n < n_len:
        if p < p_len and (pattern[p] == "?" or pattern[p] == name[n]):
            p += 1
            n += 1
        elif p < p_len and pattern[p] == "*":
            star_p = p
            star_n = n
            p += 1
        elif star_p != -1:
            p = star_p + 1
            star_n += 1
            n = star_n
        else:
            return False
    while p < p_len and pattern[p] == "*":
        p += 1
    return p == p_len


def contains_wildcard(value: str) -> bool:
    """Mirror of ext/wildcard ContainsWildcard: has ``*`` or ``?``."""
    return "*" in value or "?" in value
