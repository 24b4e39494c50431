# Copied verbatim from kyverno_tpu/utils/cron.py.
"""Five-field cron expression parsing + next-execution computation
(the reference uses github.com/adhocore/gronx via CleanupPolicy's
GetNextExecutionTime, api/kyverno/v2beta1/cleanup_policy_types.go:76).

Supported syntax: * , - / lists-ranges-steps per field
(minute hour day-of-month month day-of-week; dow 0-6, 0=Sunday).
Day-of-month and day-of-week combine with OR when both restricted,
matching Vixie cron.
"""

from __future__ import annotations

import calendar
import datetime as dt
from typing import List, Optional, Set


class CronError(Exception):
    pass


_FIELDS = [("minute", 0, 59), ("hour", 0, 23), ("dom", 1, 31),
           ("month", 1, 12), ("dow", 0, 6)]


def _parse_field(expr: str, lo: int, hi: int, name: str) -> Set[int]:
    out: Set[int] = set()
    for part in expr.split(","):
        part = part.strip()
        step = 1
        has_step = "/" in part
        if has_step:
            part, step_s = part.split("/", 1)
            try:
                step = int(step_s)
            except ValueError:
                raise CronError(f"invalid step in {name}: {step_s!r}")
            if step <= 0:
                raise CronError(f"invalid step in {name}: {step}")
        # dow accepts 7 as Sunday (gronx/Vixie); normalize after stepping
        field_hi = 7 if name == "dow" else hi
        if part in ("*", ""):
            rng = range(lo, hi + 1)
        elif "-" in part:
            a, b = part.split("-", 1)
            try:
                a_i, b_i = int(a), int(b)
            except ValueError:
                raise CronError(f"invalid range in {name}: {part!r}")
            if not (lo <= a_i <= field_hi and lo <= b_i <= field_hi and a_i <= b_i):
                raise CronError(f"range out of bounds in {name}: {part!r}")
            rng = range(a_i, b_i + 1)
        else:
            try:
                v = int(part)
            except ValueError:
                raise CronError(f"invalid value in {name}: {part!r}")
            if not (lo <= v <= field_hi):
                raise CronError(f"value out of bounds in {name}: {v}")
            # Vixie/gronx: "v/step" means range(v, hi+1, step), not {v}
            rng = range(v, field_hi + 1) if has_step else range(v, v + 1)
        vals = [x for i, x in enumerate(rng) if i % step == 0]
        if name == "dow":
            vals = [0 if x == 7 else x for x in vals]
        out.update(vals)
    if not out:
        raise CronError(f"empty {name} field")
    return out


class Cron:
    def __init__(self, expr: str):
        parts = expr.split()
        if len(parts) != 5:
            raise CronError(f"expected 5 fields, got {len(parts)}: {expr!r}")
        self.minute = _parse_field(parts[0], 0, 59, "minute")
        self.hour = _parse_field(parts[1], 0, 23, "hour")
        self.dom = _parse_field(parts[2], 1, 31, "dom")
        self.month = _parse_field(parts[3], 1, 12, "month")
        self.dow = _parse_field(parts[4], 0, 6, "dow")
        self._dom_star = parts[2] == "*"
        self._dow_star = parts[4] == "*"

    def _day_matches(self, d: dt.datetime) -> bool:
        dom_ok = d.day in self.dom
        dow_ok = ((d.weekday() + 1) % 7) in self.dow  # Monday=0 -> Sunday=0 scheme
        if self._dom_star and self._dow_star:
            return True
        if self._dom_star:
            return dow_ok
        if self._dow_star:
            return dom_ok
        return dom_ok or dow_ok  # Vixie OR semantics

    def matches(self, d: dt.datetime) -> bool:
        return (d.minute in self.minute and d.hour in self.hour
                and d.month in self.month and self._day_matches(d))

    def next_after(self, after: dt.datetime) -> dt.datetime:
        """First matching minute strictly after `after` (seconds dropped)."""
        d = after.replace(second=0, microsecond=0) + dt.timedelta(minutes=1)
        for _ in range(366 * 24 * 60):  # bounded search: one year
            if d.month not in self.month:
                # jump to the 1st of the next month
                year, month = d.year + (d.month == 12), d.month % 12 + 1
                d = d.replace(year=year, month=month, day=1, hour=0, minute=0)
                continue
            if not self._day_matches(d):
                d = (d + dt.timedelta(days=1)).replace(hour=0, minute=0)
                continue
            if d.hour not in self.hour:
                d = (d + dt.timedelta(hours=1)).replace(minute=0)
                continue
            if d.minute not in self.minute:
                d = d + dt.timedelta(minutes=1)
                continue
            return d
        raise CronError("no execution time found within a year")
