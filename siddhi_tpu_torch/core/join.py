"""Join engine.

Reference: ``core/query/input/stream/join/JoinProcessor.java`` — each side's
arrivals probe the opposite side's window buffer (``FindableProcessor.find``);
outer joins emit unmatched probes with a null side. EXPIRED events probe too,
producing EXPIRED joined events so downstream aggregations retract.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..query_api import EventTrigger, JoinType
from .event import EventType, JoinedEvent, StreamEvent
from .executor import JoinFrame
from .processors import Processor


class JoinSide(Processor):
    """Terminal processor of one side's chain; probes the other side."""

    def __init__(self, runtime: "JoinRuntime", is_left: bool):
        super().__init__()
        self.runtime = runtime
        self.is_left = is_left

    def process(self, events: list[StreamEvent]) -> None:
        self.runtime.on_side_events(self.is_left, events)


class JoinRuntime:
    def __init__(self, join_type: JoinType, trigger: EventTrigger,
                 condition_fn: Optional[Callable],
                 left_find: Callable[..., list[StreamEvent]],
                 right_find: Callable[..., list[StreamEvent]],
                 within_ms: Optional[int] = None):
        self.join_type = join_type
        self.trigger = trigger
        self.condition_fn = condition_fn
        self.left_find = left_find
        self.right_find = right_find
        self.within_ms = within_ms
        self.next = None    # selector

    def on_side_events(self, is_left: bool, events: list[StreamEvent]) -> None:
        out: list[JoinedEvent] = []
        for ev in events:
            if ev.type not in (EventType.CURRENT, EventType.EXPIRED):
                continue
            if is_left and self.trigger == EventTrigger.RIGHT:
                continue
            if (not is_left) and self.trigger == EventTrigger.LEFT:
                continue
            # the probe event is handed to the opposite side so table sides
            # can push an indexed lookup down instead of scanning
            # (reference: JoinProcessor + OperatorParser's IndexOperator)
            opposite = self.right_find(ev) if is_left else self.left_find(ev)
            matched = False
            for other in opposite:
                left_ev = ev if is_left else other
                right_ev = other if is_left else ev
                if self.within_ms is not None and \
                        abs(left_ev.timestamp - right_ev.timestamp) > self.within_ms:
                    continue
                frame = JoinFrame(left_ev, right_ev, ev.timestamp)
                if self.condition_fn is None or bool(self.condition_fn(frame)):
                    matched = True
                    out.append(JoinedEvent(ev.timestamp, left_ev, right_ev, ev.type))
            if not matched and self._emit_unmatched(is_left):
                left_ev = ev if is_left else None
                right_ev = None if is_left else ev
                out.append(JoinedEvent(ev.timestamp, left_ev, right_ev, ev.type))
        if out and self.next is not None:
            self.next.process(out)

    def _emit_unmatched(self, probe_is_left: bool) -> bool:
        if self.join_type == JoinType.FULL_OUTER_JOIN:
            return True
        if self.join_type == JoinType.LEFT_OUTER_JOIN and probe_is_left:
            return True
        if self.join_type == JoinType.RIGHT_OUTER_JOIN and not probe_is_left:
            return True
        return False
