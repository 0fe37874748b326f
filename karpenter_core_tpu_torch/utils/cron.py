"""Minimal 5-field cron matcher for disruption-budget schedules.

Counterpart of ``karpenter_core_tpu/utils/cron.py``
(ref designs/disruption-controls.md + apis/v1beta1/nodepool.go:104-110:
upstream cronjob syntax, plus the @hourly/@daily/... macros; timezones
unsupported, matching the reference's validation pattern).

Only matching is needed: a budget with ``schedule`` + ``duration`` is
active at time t iff some schedule hit h satisfies h <= t < h + duration
— answered by scanning the minute-aligned instants of the trailing
duration window, since cron's resolution is one minute.
"""

from __future__ import annotations

import functools
import time
from typing import List, Optional, Tuple

_MACROS = {
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
    "@monthly": "0 0 1 * *",
    "@weekly": "0 0 * * 0",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@hourly": "0 * * * *",
}

_MONTH_NAMES = {
    name: i + 1
    for i, name in enumerate(
        ["jan", "feb", "mar", "apr", "may", "jun", "jul", "aug", "sep", "oct", "nov", "dec"]
    )
}
_DOW_NAMES = {name: i for i, name in enumerate(["sun", "mon", "tue", "wed", "thu", "fri", "sat"])}

# field index → (min, max, name table)
_FIELDS: List[Tuple[int, int, dict]] = [
    (0, 59, {}),  # minute
    (0, 23, {}),  # hour
    (1, 31, {}),  # day of month
    (1, 12, _MONTH_NAMES),  # month
    (0, 7, _DOW_NAMES),  # day of week (0 and 7 are Sunday)
]


class CronError(ValueError):
    pass


def _parse_value(token: str, lo: int, hi: int, names: dict) -> int:
    token = token.strip().lower()
    if token in names:
        return names[token]
    try:
        value = int(token)
    except ValueError:
        raise CronError(f"invalid cron value {token!r}")
    if not lo <= value <= hi:
        raise CronError(f"cron value {value} out of range [{lo},{hi}]")
    return value


def _parse_field(field: str, lo: int, hi: int, names: dict) -> frozenset:
    out = set()
    for part in field.split(","):
        part = part.strip()
        step = 1
        has_step = "/" in part
        if has_step:
            part, step_s = part.split("/", 1)
            step = _parse_value(step_s, 1, hi, {})
        if part == "*":
            start, end = lo, hi
        elif "-" in part:
            start_s, end_s = part.split("-", 1)
            start = _parse_value(start_s, lo, hi, names)
            end = _parse_value(end_s, lo, hi, names)
            if end < start:
                raise CronError(f"inverted cron range {part!r}")
        else:
            start = _parse_value(part, lo, hi, names)
            # robfig/cron (CronJob) semantics: "N/step" means N-max/step
            end = hi if has_step else start
        out.update(range(start, end + 1, step))
    if not out:
        raise CronError(f"empty cron field {field!r}")
    return frozenset(out)


class Schedule:
    """A parsed cron expression answering matches(timestamp)."""

    def __init__(self, expr: str):
        expr = expr.strip()
        expr = _MACROS.get(expr.lower(), expr)
        fields = expr.split()
        if len(fields) != 5:
            raise CronError(f"cron expression needs 5 fields, got {expr!r}")
        self.minute, self.hour, self.dom, self.month, dow = (
            _parse_field(f, lo, hi, names)
            for f, (lo, hi, names) in zip(fields, _FIELDS)
        )
        # 7 is an alias for Sunday
        self.dow = frozenset(0 if v == 7 else v for v in dow)
        # cron quirk: when BOTH day-of-month and day-of-week are
        # restricted, either matching suffices (vixie cron / CronJob)
        self.dom_restricted = self.dom != frozenset(range(1, 32))
        self.dow_restricted = self.dow != frozenset(range(0, 7))

    def _day_matches(self, t) -> bool:
        if t.tm_mon not in self.month:
            return False
        cron_dow = (t.tm_wday + 1) % 7  # tm_wday: Mon=0 → cron: Sun=0
        dom_ok = t.tm_mday in self.dom
        dow_ok = cron_dow in self.dow
        if self.dom_restricted and self.dow_restricted:
            # cron quirk: when BOTH fields are restricted, either suffices
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def matches(self, ts: float) -> bool:
        t = time.gmtime(ts)
        if t.tm_min not in self.minute or t.tm_hour not in self.hour:
            return False
        return self._day_matches(t)

    def last_hit(self, now: float, earliest: float) -> Optional[float]:
        """Most recent hit h with earliest < h <= now, or None. Scans
        whole days backwards — non-matching days cost O(1), so a long
        inactive window is days, not minutes, of work per check."""
        hours_desc = sorted(self.hour, reverse=True)
        mins_desc = sorted(self.minute, reverse=True)
        day_start = int(now) // 86400 * 86400
        while day_start + 86400 > earliest:
            t = time.gmtime(day_start)
            if self._day_matches(t):
                cap = now if day_start + 86400 > now else day_start + 86399
                for h in hours_desc:
                    if day_start + h * 3600 > cap:
                        continue
                    for m in mins_desc:
                        ts = day_start + h * 3600 + m * 60
                        if ts <= cap:
                            return ts if ts > earliest else None
            day_start -= 86400
        return None

    def active_within(self, now: float, duration: float) -> bool:
        """True iff a hit h exists with h <= now < h + duration."""
        if duration <= 0:
            return False
        return self.last_hit(now, now - duration) is not None


def parse(expr: str) -> Schedule:
    return Schedule(expr)


@functools.lru_cache(maxsize=256)
def _cached_schedule(expr: str) -> Schedule:
    """Budgets re-check their schedules every reconcile pass — parse once."""
    return Schedule(expr)


def budget_is_active(schedule: Optional[str], duration: Optional[float], now: float) -> bool:
    """Budget activity per the design: no schedule+duration = always
    active; otherwise active for ``duration`` after each schedule hit.
    A malformed schedule deactivates the budget (validation rejects it
    up front; this is the runtime backstop)."""
    if schedule is None and duration is None:
        return True
    if schedule is None or duration is None:
        # validation requires both-or-neither; treat half-set as always
        # active only when neither restricts (handled above), else inactive
        return False
    try:
        return _cached_schedule(schedule).active_within(now, duration)
    except CronError:
        return False
