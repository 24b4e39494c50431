# Copied verbatim from kyverno_tpu/engine/jmespath/gotime.py.
"""Go time interop: reference layouts, RFC3339, Duration.String().

The reference's time functions (pkg/engine/jmespath/time.go) parse and
format with Go's reference-layout system ("2006-01-02T15:04:05Z07:00")
and render durations via time.Duration.String() ("1h30m0s", "1.5µs").
This module provides the equivalents on top of ``datetime``.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Optional

RFC3339 = "2006-01-02T15:04:05Z07:00"

# Go layout token -> strftime/strptime directive, longest first
_LAYOUT_TOKENS = [
    ("2006", "%Y"),
    ("January", "%B"),
    ("Jan", "%b"),
    ("Monday", "%A"),
    ("Mon", "%a"),
    ("15", "%H"),
    ("01", "%m"),
    ("02", "%d"),
    ("03", "%I"),
    ("04", "%M"),
    ("05", "%S"),
    ("06", "%y"),
    ("PM", "%p"),
    ("pm", "%p"),
    ("-07:00", "%z"),
    ("-0700", "%z"),
    ("-07", "%z"),
    ("Z07:00", "%z"),
    ("Z0700", "%z"),
    (".000000000", ".%f"),
    (".000000", ".%f"),
    (".000", ".%f"),
    (".999999999", ".%f"),
    (".999999", ".%f"),
    (".999", ".%f"),
    ("MST", "%Z"),
]


def layout_to_strftime(layout: str) -> str:
    out = []
    i = 0
    while i < len(layout):
        for tok, directive in _LAYOUT_TOKENS:
            if layout.startswith(tok, i):
                out.append(directive)
                i += len(tok)
                break
        else:
            c = layout[i]
            out.append("%%" if c == "%" else c)
            i += 1
    return "".join(out)


def parse_time(layout: str, value: str) -> _dt.datetime:
    """Parse per a Go layout; RFC3339 gets fast-path handling
    (including trailing 'Z' which strptime's %z handles via +00:00)."""
    if layout == RFC3339 or layout == "":
        v = value
        if v.endswith("Z"):
            v = v[:-1] + "+00:00"
        return _dt.datetime.fromisoformat(v)
    fmt = layout_to_strftime(layout)
    v = value
    if "Z07:00" in layout or "Z0700" in layout:
        if v.endswith("Z"):
            v = v[:-1] + "+0000"
    dt = _dt.datetime.strptime(v, fmt)
    return dt


def format_rfc3339(dt: _dt.datetime) -> str:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    s = dt.isoformat(timespec="seconds" if dt.microsecond == 0 else "microseconds")
    return s.replace("+00:00", "Z")


_NS = 1
_US = 1_000
_MS = 1_000_000
_SEC = 1_000_000_000


def _fmt_frac(value: int, scale: int) -> str:
    """integer part + trimmed fraction of value/scale."""
    whole, frac = divmod(value, scale)
    if frac == 0:
        return str(whole)
    frac_str = str(frac).rjust(len(str(scale)) - 1, "0").rstrip("0")
    return f"{whole}.{frac_str}"


def format_go_duration(ns: int) -> str:
    """time.Duration.String(): "0s", "1.5µs", "1h30m0s", "-2m0.5s"."""
    if ns == 0:
        return "0s"
    sign = "-" if ns < 0 else ""
    u = abs(ns)
    if u < _US:
        return f"{sign}{u}ns"
    if u < _MS:
        return f"{sign}{_fmt_frac(u, _US)}µs"
    if u < _SEC:
        return f"{sign}{_fmt_frac(u, _MS)}ms"
    secs, frac_ns = divmod(u, _SEC)
    mins, s = divmod(secs, 60)
    hours, m = divmod(mins, 60)
    s_str = _fmt_frac(s * _SEC + frac_ns, _SEC) + "s"
    out = s_str
    if mins > 0:
        out = f"{m}m" + out
    if hours > 0:
        out = f"{hours}h" + out
    return sign + out


_CRON_FIELDS = "{minute} {hour} {dom} {month} {dow}"


def time_to_cron(dt: _dt.datetime) -> str:
    return f"{dt.minute} {dt.hour} {dt.day} {dt.month} {dt.isoweekday() % 7}"
