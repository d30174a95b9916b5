"""Output rate limiters.

Reference: ``core/query/output/ratelimit/`` — event/ (per-N-events), time/
(per-period), snapshot/ (periodic state snapshot). Time-driven limiters use the
deterministic Scheduler.
"""

from __future__ import annotations

from typing import Optional

from ..query_api import (
    EventOutputRate,
    OutputRateType,
    SnapshotOutputRate,
    TimeOutputRate,
)
from .event import EventType, StreamEvent


class PassThroughRateLimiter:
    def __init__(self):
        self.next = None

    def process(self, events: list[StreamEvent]) -> None:
        if self.next is not None and events:
            self.next.process(events)

    def snapshot_state(self) -> dict:
        return {}

    def restore_state(self, state: dict) -> None:
        pass


class EventRateLimiter(PassThroughRateLimiter):
    """``output [all|first|last] every N events``.

    With ``grouped`` (the query has a group-by), first/last behave PER KEY:
    first keeps a per-key occurrence counter — emit a key's first arrival,
    suppress its next N−1, then its next arrival emits again (reference
    ``FirstGroupByPerEventOutputRateLimiter`` — no global batch at all);
    last keeps the global N-event batch but emits every key's final row at
    the boundary in first-seen order
    (``LastGroupByPerEventOutputRateLimiter``'s LinkedHashMap)."""

    def __init__(self, n: int, mode: OutputRateType, grouped: bool = False):
        super().__init__()
        self.n = n
        self.mode = mode
        self.grouped = grouped
        self.counter = 0
        self.pending: list[StreamEvent] = []
        self.last: Optional[StreamEvent] = None
        self.key_counts: dict = {}
        self.last_by_key: dict = {}

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if self.mode == OutputRateType.FIRST and self.grouped:
                c = self.key_counts.get(ev.group_key)
                if c is None:
                    self.key_counts[ev.group_key] = 1
                    out.append(ev)
                elif c == self.n - 1:
                    del self.key_counts[ev.group_key]
                else:
                    self.key_counts[ev.group_key] = c + 1
                continue
            self.counter += 1
            if self.mode == OutputRateType.ALL:
                self.pending.append(ev)
                if self.counter == self.n:
                    out.extend(self.pending)
                    self.pending = []
                    self.counter = 0
            elif self.mode == OutputRateType.FIRST:
                if self.counter == 1:
                    out.append(ev)
                if self.counter == self.n:
                    self.counter = 0
            else:  # LAST
                if self.grouped:
                    self.last_by_key[ev.group_key] = ev
                else:
                    self.last = ev
                if self.counter == self.n:
                    if self.grouped:
                        out.extend(self.last_by_key.values())
                        self.last_by_key = {}
                    elif self.last is not None:
                        out.append(self.last)
                    self.last = None
                    self.counter = 0
        if self.next is not None and out:
            self.next.process(out)

    def snapshot_state(self) -> dict:
        enc = lambda e: (e.timestamp, list(e.data), e.type.value)  # noqa: E731
        return {"counter": self.counter,
                "pending": [enc(e) for e in self.pending],
                "last": enc(self.last) if self.last is not None else None,
                "key_counts": list(self.key_counts.items()),
                "last_by_key": [(k, enc(e))
                                for k, e in self.last_by_key.items()]}

    def restore_state(self, state: dict) -> None:
        self.counter = state["counter"]
        self.pending = [StreamEvent(t, d, EventType(ty)) for t, d, ty in state["pending"]]
        self.last = StreamEvent(*state["last"][:2], EventType(state["last"][2])) \
            if state.get("last") else None
        self.key_counts = {
            (tuple(k) if isinstance(k, list) else k): c
            for k, c in state.get("key_counts", [])}
        self.last_by_key = {}
        for k, (t, d, ty) in state.get("last_by_key", []):
            self.last_by_key[tuple(k) if isinstance(k, list) else k] = \
                StreamEvent(t, d, EventType(ty))


class TimeRateLimiter(PassThroughRateLimiter):
    """``output [all|first|last] every <time>`` — flush on scheduler ticks.
    Grouped first is a per-key SLIDING gate: a key emits when the period
    has elapsed since its own last emission (reference
    ``FirstGroupByPerTimeOutputRateLimiter`` tracks per-key output times);
    grouped last flushes every key's final row on the period timer
    (``LastGroupByPerTimeOutputRateLimiter``)."""

    def __init__(self, period_ms: int, mode: OutputRateType, app_context,
                 grouped: bool = False):
        super().__init__()
        self.period = period_ms
        self.mode = mode
        self.grouped = grouped
        self.app_context = app_context
        self.pending: list[StreamEvent] = []
        self.first_sent = False
        self.last: Optional[StreamEvent] = None
        self.window_end: Optional[int] = None
        self.key_out_time: dict = {}
        self.last_by_key: dict = {}

    def _arm(self, ts: int) -> None:
        if self.window_end is None:
            self.window_end = ts + self.period
            self.app_context.scheduler.notify_at(self.window_end, self._on_timer)

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            self._arm(ev.timestamp)
            if self.mode == OutputRateType.ALL:
                self.pending.append(ev)
            elif self.mode == OutputRateType.FIRST:
                if self.grouped:
                    now = self.app_context.current_time()
                    lo = self.key_out_time.get(ev.group_key)
                    if lo is None or lo + self.period <= now:
                        self.key_out_time[ev.group_key] = now
                        out.append(ev)
                elif not self.first_sent:
                    out.append(ev)
                    self.first_sent = True
            else:
                if self.grouped:
                    self.last_by_key[ev.group_key] = ev
                else:
                    self.last = ev
        if self.next is not None and out:
            self.next.process(out)

    def _on_timer(self, ts: int) -> None:
        out: list[StreamEvent] = []
        if self.mode == OutputRateType.ALL:
            out, self.pending = self.pending, []
        elif self.mode == OutputRateType.FIRST:
            self.first_sent = False
        else:
            if self.grouped:
                out = list(self.last_by_key.values())
                self.last_by_key = {}
            elif self.last is not None:
                out = [self.last]
            self.last = None
        self.window_end = ts + self.period
        self.app_context.scheduler.notify_at(self.window_end, self._on_timer)
        if self.next is not None and out:
            self.next.process(out)


class SnapshotRateLimiter(PassThroughRateLimiter):
    """``output snapshot every <time>`` — each period emits the latest
    output value; for group-by queries, EVERY group's latest row in
    first-seen order (reference ``WrappedSnapshotOutputRateLimiter``'s
    per-group snapshot limiters)."""

    def __init__(self, period_ms: int, app_context, grouped: bool = False):
        super().__init__()
        self.period = period_ms
        self.app_context = app_context
        self.grouped = grouped
        self.latest: Optional[StreamEvent] = None
        self.latest_by_key: dict = {}
        self.window_end: Optional[int] = None

    def process(self, events: list[StreamEvent]) -> None:
        for ev in events:
            if self.window_end is None:
                self.window_end = ev.timestamp + self.period
                self.app_context.scheduler.notify_at(self.window_end, self._on_timer)
            if ev.type == EventType.CURRENT:
                if self.grouped:
                    self.latest_by_key[ev.group_key] = ev
                else:
                    self.latest = ev

    def _on_timer(self, ts: int) -> None:
        out = []
        if self.grouped:
            out = [StreamEvent(ts, e.data, EventType.CURRENT)
                   for e in self.latest_by_key.values()]
        elif self.latest is not None:
            out = [StreamEvent(ts, self.latest.data, EventType.CURRENT)]
        self.window_end = ts + self.period
        self.app_context.scheduler.notify_at(self.window_end, self._on_timer)
        if self.next is not None and out:
            self.next.process(out)


def build_rate_limiter(output_rate, app_context, grouped: bool = False):
    if output_rate is None:
        return PassThroughRateLimiter()
    if isinstance(output_rate, EventOutputRate):
        return EventRateLimiter(output_rate.value, output_rate.type, grouped)
    if isinstance(output_rate, TimeOutputRate):
        return TimeRateLimiter(output_rate.value_ms, output_rate.type,
                               app_context, grouped)
    if isinstance(output_rate, SnapshotOutputRate):
        return SnapshotRateLimiter(output_rate.value_ms, app_context, grouped)
    raise ValueError(f"unknown output rate {output_rate!r}")
