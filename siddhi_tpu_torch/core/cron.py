"""Minimal quartz-style cron evaluator.

The reference uses the Quartz library for ``CronTrigger``/``CronWindowProcessor``;
here a small evaluator supports the common subset: 6 or 7 fields
(sec min hour day-of-month month day-of-week [year]) with ``*``, ``?``, ``*/n``,
``a-b``, and comma lists. Fire-time search is done in UTC.
"""

from __future__ import annotations

import calendar
import datetime as _dt
from typing import Optional


class CronParseError(ValueError):
    pass


_FIELD_RANGES = [(0, 59), (0, 59), (0, 23), (1, 31), (1, 12), (0, 7)]


def _parse_field(spec: str, lo: int, hi: int) -> Optional[set[int]]:
    """None = any (``*``/``?``)."""
    if spec in ("*", "?"):
        return None
    out: set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if part in ("*", ""):
                part = f"{lo}-{hi}"
        if "-" in part:
            a, b = part.split("-", 1)
            out.update(range(int(a), int(b) + 1, step))
        else:
            v = int(part)
            if step > 1:
                out.update(range(v, hi + 1, step))
            else:
                out.add(v)
    for v in out:
        if not (lo <= v <= hi + (1 if hi == 7 else 0)):
            raise CronParseError(f"cron field value {v} out of range [{lo},{hi}]")
    return out


class CronSchedule:
    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) == 5:               # classic cron: prepend seconds=0
            fields = ["0"] + fields
        if len(fields) not in (6, 7):
            raise CronParseError(f"cron expression needs 5-7 fields: {expr!r}")
        self.expr = expr
        (self.sec, self.minute, self.hour,
         self.dom, self.month, self.dow) = [
            _parse_field(f, lo, hi)
            for f, (lo, hi) in zip(fields[:6], _FIELD_RANGES)
        ]
        if self.dow is not None and 7 in self.dow:   # quartz: 7 == Sunday == 0
            self.dow = (self.dow - {7}) | {0}
        self.year = None
        if len(fields) == 7 and fields[6] not in ("*", "?"):
            self.year = {int(y) for y in fields[6].split(",")}

    def matches(self, dt: _dt.datetime) -> bool:
        dow = (dt.weekday() + 1) % 7       # python Mon=0 → cron Sun=0
        return (
            (self.sec is None or dt.second in self.sec)
            and (self.minute is None or dt.minute in self.minute)
            and (self.hour is None or dt.hour in self.hour)
            and (self.dom is None or dt.day in self.dom)
            and (self.month is None or dt.month in self.month)
            and (self.dow is None or dow in self.dow)
            and (self.year is None or dt.year in self.year)
        )

    def next_fire_after(self, epoch_ms: int, horizon_days: int = 366 * 2) -> Optional[int]:
        """Next fire time strictly after ``epoch_ms`` (returns epoch ms, UTC)."""
        dt = _dt.datetime.fromtimestamp(epoch_ms / 1000.0, tz=_dt.timezone.utc)
        dt = dt.replace(microsecond=0) + _dt.timedelta(seconds=1)
        end = dt + _dt.timedelta(days=horizon_days)
        while dt < end:
            if self.month is not None and dt.month not in self.month:
                nm = dt.month % 12 + 1
                ny = dt.year + (1 if nm == 1 else 0)
                dt = dt.replace(year=ny, month=nm, day=1, hour=0, minute=0, second=0)
                continue
            if (self.dom is not None and dt.day not in self.dom) or (
                self.dow is not None and (dt.weekday() + 1) % 7 not in self.dow
            ):
                dt = (dt + _dt.timedelta(days=1)).replace(hour=0, minute=0, second=0)
                continue
            if self.hour is not None and dt.hour not in self.hour:
                dt = (dt + _dt.timedelta(hours=1)).replace(minute=0, second=0)
                continue
            if self.minute is not None and dt.minute not in self.minute:
                dt = (dt + _dt.timedelta(minutes=1)).replace(second=0)
                continue
            if self.sec is not None and dt.second not in self.sec:
                dt = dt + _dt.timedelta(seconds=1)
                continue
            return int(dt.timestamp() * 1000)
        return None
