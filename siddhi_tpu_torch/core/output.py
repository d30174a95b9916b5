"""Output callbacks: route selector output to streams, tables, windows, callbacks.

Reference: ``core/query/output/callback/`` — ``InsertIntoStreamCallback``,
``InsertIntoTableCallback``, ``Update/Delete/UpdateOrInsertTableCallback``.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..query_api import OutputEventsFor
from .event import Event, EventType, StreamEvent


def _allowed(ev: StreamEvent, events_for: OutputEventsFor) -> bool:
    if ev.type == EventType.CURRENT:
        return events_for in (OutputEventsFor.CURRENT_EVENTS, OutputEventsFor.ALL_EVENTS)
    if ev.type == EventType.EXPIRED:
        return events_for in (OutputEventsFor.EXPIRED_EVENTS, OutputEventsFor.ALL_EVENTS)
    return False


class InsertIntoStreamCallback:
    """Forwards selected events into a target junction as CURRENT events."""

    def __init__(self, junction, events_for: OutputEventsFor):
        self.junction = junction
        self.events_for = events_for

    def process(self, events: list[StreamEvent]) -> None:
        for ev in events:
            if _allowed(ev, self.events_for):
                self.junction.send_event(
                    StreamEvent(ev.timestamp, list(ev.data), EventType.CURRENT))


class InsertIntoWindowCallback:
    def __init__(self, window, events_for: OutputEventsFor):
        self.window = window
        self.events_for = events_for

    def process(self, events: list[StreamEvent]) -> None:
        for ev in events:
            if _allowed(ev, self.events_for):
                self.window.add(
                    StreamEvent(ev.timestamp, list(ev.data), EventType.CURRENT))


class InsertIntoTableCallback:
    def __init__(self, table, events_for: OutputEventsFor):
        self.table = table
        self.events_for = events_for

    def process(self, events: list[StreamEvent]) -> None:
        rows = [list(ev.data) for ev in events if _allowed(ev, self.events_for)]
        if rows:
            self.table.add(rows, events[-1].timestamp)


class DeleteTableCallback:
    def __init__(self, table, condition):
        self.table = table
        self.condition = condition

    def process(self, events: list[StreamEvent]) -> None:
        for ev in events:
            if ev.type == EventType.CURRENT:
                self.table.delete(self.condition, ev.data, ev.timestamp)


class UpdateTableCallback:
    def __init__(self, table, condition, setters):
        self.table = table
        self.condition = condition
        self.setters = setters

    def process(self, events: list[StreamEvent]) -> None:
        for ev in events:
            if ev.type == EventType.CURRENT:
                self.table.update(self.condition, ev.data, self.setters, ev.timestamp)


class UpdateOrInsertTableCallback:
    def __init__(self, table, condition, setters):
        self.table = table
        self.condition = condition
        self.setters = setters

    def process(self, events: list[StreamEvent]) -> None:
        for ev in events:
            if ev.type == EventType.CURRENT:
                self.table.update_or_add(self.condition, ev.data, self.setters,
                                         ev.timestamp)


class QueryCallbackAdapter:
    """Terminal: delivers chunks to a user QueryCallback as (ts, current, expired)."""

    def __init__(self):
        self.callbacks: list = []

    def process(self, events: list[StreamEvent]) -> None:
        if not self.callbacks:
            return
        currents = [Event(e.timestamp, e.data) for e in events
                    if e.type == EventType.CURRENT]
        expireds = [Event(e.timestamp, e.data, True) for e in events
                    if e.type == EventType.EXPIRED]
        ts = events[-1].timestamp if events else 0
        for cb in self.callbacks:
            cb.receive(ts, currents or None, expireds or None)


class FanoutProcessor:
    """Sends the selector output to multiple downstream consumers."""

    def __init__(self, targets: list):
        self.targets = targets

    def process(self, events: list[StreamEvent]) -> None:
        for t in self.targets:
            t.process(events)
