"""Triggers: inject events into a trigger stream at start / periodic / cron times.

Reference: ``core/trigger/`` — ``StartTrigger``, ``PeriodicTrigger``, ``CronTrigger``
(quartz replaced by ``core/cron.py``). A trigger stream has the single attribute
``triggered_time long``.
"""

from __future__ import annotations

from typing import Optional

from ..query_api.definition import DataType, StreamDefinition, TriggerDefinition
from .cron import CronSchedule
from .event import EventType, StreamEvent


def trigger_stream_definition(trigger_id: str) -> StreamDefinition:
    d = StreamDefinition(trigger_id)
    d.attribute("triggered_time", DataType.LONG)
    return d


class TriggerRuntime:
    def __init__(self, definition: TriggerDefinition, junction, app_context):
        self.definition = definition
        self.junction = junction
        self.app_context = app_context
        self.cron: Optional[CronSchedule] = (
            CronSchedule(definition.at_cron) if definition.at_cron else None
        )

    def start(self) -> None:
        now = self.app_context.current_time()
        if self.definition.at_start:
            self._fire(now)
        elif self.definition.at_every_ms is not None:
            self.app_context.scheduler.notify_at(
                now + self.definition.at_every_ms, self._on_periodic)
        elif self.cron is not None:
            nxt = self.cron.next_fire_after(now)
            if nxt is not None:
                self.app_context.scheduler.notify_at(nxt, self._on_cron)

    def _fire(self, ts: int) -> None:
        self.junction.send_event(StreamEvent(ts, [ts], EventType.CURRENT))

    def _on_periodic(self, ts: int) -> None:
        self._fire(ts)
        self.app_context.scheduler.notify_at(
            ts + self.definition.at_every_ms, self._on_periodic)

    def _on_cron(self, ts: int) -> None:
        self._fire(ts)
        nxt = self.cron.next_fire_after(ts)
        if nxt is not None:
            self.app_context.scheduler.notify_at(nxt, self._on_cron)
