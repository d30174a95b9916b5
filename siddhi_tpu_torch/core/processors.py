"""Processor chain primitives: filter, stream functions.

Reference: ``core/query/processor/Processor.java`` (chain interface),
``filter/FilterProcessor.java``, ``stream/function/StreamFunctionProcessor.java``.
Chunks are plain ``list[StreamEvent]`` — the mutable linked-list cursor of the
reference (``ComplexEventChunk``) is unnecessary with immutable list passing.
"""

from __future__ import annotations

from typing import Callable, Optional

from .event import EventType, StreamEvent
from .executor import StreamFrame


class Processor:
    def __init__(self):
        self.next: Optional[Processor] = None

    def process(self, events: list[StreamEvent]) -> None:
        raise NotImplementedError

    def forward(self, events: list[StreamEvent]) -> None:
        if self.next is not None and events:
            self.next.process(events)

    def set_next(self, p: "Processor") -> "Processor":
        self.next = p
        return p


class FilterProcessor(Processor):
    """Drops events failing the condition (TIMER events always pass through)."""

    def __init__(self, condition: Callable):
        super().__init__()
        self.condition = condition

    def process(self, events: list[StreamEvent]) -> None:
        out = []
        for ev in events:
            if ev.type == EventType.TIMER or ev.type == EventType.RESET:
                out.append(ev)
                continue
            if bool(self.condition(StreamFrame(ev))):
                out.append(ev)
        if out:
            self.forward(out)


class StreamFunctionProcessor(Processor):
    """1→N event transform (extension point; reference ``StreamFunctionProcessor``).

    ``fn(event) -> list[list] | list | None`` — returns appended-attribute payloads.
    """

    def __init__(self, fn: Callable[[StreamEvent], object]):
        super().__init__()
        self.fn = fn

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type != EventType.CURRENT:
                out.append(ev)
                continue
            res = self.fn(ev)
            if res is None:
                continue
            if res and isinstance(res[0], (list, tuple)):
                for row in res:
                    out.append(StreamEvent(ev.timestamp, list(row), ev.type))
            else:
                out.append(StreamEvent(ev.timestamp, list(res), ev.type))
        if out:
            self.forward(out)


class SinkProcessor(Processor):
    """Chain terminator calling a function with the chunk."""

    def __init__(self, fn: Callable[[list[StreamEvent]], None]):
        super().__init__()
        self.fn = fn

    def process(self, events: list[StreamEvent]) -> None:
        self.fn(events)
