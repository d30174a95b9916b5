"""Named windows: ``define window W (...) <handler>`` shared across queries.

Reference: ``core/window/Window.java`` — internal processor chain, publishes
events per its output event type, exposes ``find()`` for joins.
"""

from __future__ import annotations

from ..query_api.definition import OutputEventType, WindowDefinition
from .event import EventType, StreamEvent
from .processors import SinkProcessor


class NamedWindow:
    def __init__(self, definition: WindowDefinition, processor, app_context):
        self.definition = definition
        self.processor = processor          # a WindowProcessor chain head
        self.app_context = app_context
        self.subscribers: list = []         # junction-receiver-like objects
        processor.set_next(SinkProcessor(self._dispatch))

    def add(self, event: StreamEvent) -> None:
        self.processor.process([event])

    def _dispatch(self, events: list[StreamEvent]) -> None:
        # deliver the flush as ONE chunk, RESET events included: batch-type
        # named windows (lengthBatch/timeBatch/...) rely on downstream
        # selectors seeing chunk boundaries to collapse aggregated rows and
        # reset between batches (CustomJoinWindowTestCase
        # .testMultipleStreamsToWindow pins one row per flush)
        t = self.definition.output_event_type
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type == EventType.CURRENT and t == OutputEventType.EXPIRED_EVENTS:
                continue
            if ev.type == EventType.EXPIRED and t == OutputEventType.CURRENT_EVENTS:
                continue
            if ev.type in (EventType.CURRENT, EventType.EXPIRED,
                           EventType.RESET):
                out.append(StreamEvent(ev.timestamp, list(ev.data), ev.type))
        if not out:
            return
        for s in self.subscribers:
            if hasattr(s, "receive_chunk"):
                s.receive_chunk(list(out))
            else:
                for ev in out:
                    s.receive(ev)

    def subscribe(self, receiver) -> None:
        self.subscribers.append(receiver)

    def find_events(self) -> list[StreamEvent]:
        return self.processor.find_events()
