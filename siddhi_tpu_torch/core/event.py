"""Event model.

Reference: ``io.siddhi.core.event`` — ``ComplexEvent.Type`` (``ComplexEvent.java:48``),
``StreamEvent``, ``StateEvent``, ``Event``. Redesigned: the interpreter uses one small
``StreamEvent`` class (list-of-values payload) and ``StateEvent`` (alias→events map) —
the pooled 3-array layout of the reference is replaced on the TPU path by columnar
SoA batches (``siddhi_tpu/tpu/batch.py``), so the host classes stay simple.
"""

from __future__ import annotations

import enum
from typing import Any, Optional


class EventType(enum.Enum):
    CURRENT = "current"
    EXPIRED = "expired"
    TIMER = "timer"
    RESET = "reset"


class StreamEvent:
    """A single event within the engine.

    ``group_key`` rides along on SELECTOR OUTPUT events of group-by queries
    (reference ``GroupedComplexEvent``): grouped first/last output rate
    limiters batch per key, not per event stream."""

    __slots__ = ("timestamp", "data", "type", "group_key", "flow_seq",
                 "trace")

    def __init__(self, timestamp: int, data: list, type: EventType = EventType.CURRENT):
        self.timestamp = timestamp
        self.data = data
        self.type = type
        self.group_key = None
        # WAL sequence number on flow-controlled ingress events (None
        # otherwise): the junction advances the stream's applied watermark
        # with it at delivery (siddhi_tpu/flow)
        self.flow_seq = None
        # sampled observability Trace riding an @async enqueue — the
        # delivery worker re-activates it (siddhi_tpu/observability);
        # synchronous paths propagate thread-locally and never stamp it
        self.trace = None

    def copy(self) -> "StreamEvent":
        # hot path (every window expiry clones): skip __init__ — field
        # assignment via __new__ is ~2x cheaper than re-running the
        # constructor, and the per-copy semantics (fresh group_key/flow_seq/
        # trace) are explicit here
        c = StreamEvent.__new__(StreamEvent)
        c.timestamp = self.timestamp
        c.data = list(self.data)
        c.type = self.type
        c.group_key = None
        c.flow_seq = None
        c.trace = None
        return c

    def __repr__(self) -> str:
        return f"StreamEvent({self.timestamp}, {self.data}, {self.type.name})"


class Event:
    """Public API event delivered to callbacks (reference ``event/Event.java``)."""

    __slots__ = ("timestamp", "data", "is_expired")

    def __init__(self, timestamp: int, data: list, is_expired: bool = False):
        self.timestamp = timestamp
        self.data = list(data)
        self.is_expired = is_expired

    def __repr__(self) -> str:
        flag = ", expired" if self.is_expired else ""
        return f"Event({self.timestamp}, {self.data}{flag})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Event)
            and self.timestamp == other.timestamp
            and self.data == other.data
            and self.is_expired == other.is_expired
        )


class StateEvent:
    """A partial/complete pattern match: alias → StreamEvent | list[StreamEvent].

    Reference ``event/state/StateEvent.java`` uses a positional StreamEvent[]; here a
    dict keyed by state alias (``e1``…) since the interpreter favors clarity; the TPU
    match tables use positional slots.
    """

    __slots__ = ("events", "first_timestamp", "timestamp", "meta")

    def __init__(self):
        self.events: dict[str, Any] = {}
        self.first_timestamp: Optional[int] = None
        self.timestamp: Optional[int] = None
        self.meta: dict[str, Any] = {}  # per-node scratch (logical flags, counts)

    def bind(self, alias: str, ev: StreamEvent, append: bool = False) -> None:
        if self.first_timestamp is None:
            self.first_timestamp = ev.timestamp
        self.timestamp = ev.timestamp
        if append:
            self.events.setdefault(alias, []).append(ev)
        else:
            self.events[alias] = ev

    def get(self, alias: str, index: Optional[int] = None) -> Optional[StreamEvent]:
        v = self.events.get(alias)
        if v is None:
            return None
        if isinstance(v, list):
            if index is None or index == -1:   # default / LAST
                return v[-1] if v else None
            return v[index] if index < len(v) else None
        return v

    def copy(self) -> "StateEvent":
        c = StateEvent()
        c.events = {
            k: (list(v) if isinstance(v, list) else v) for k, v in self.events.items()
        }
        c.first_timestamp = self.first_timestamp
        c.timestamp = self.timestamp
        c.meta = dict(self.meta)
        return c

    def __repr__(self) -> str:
        return f"StateEvent({self.events})"


class PatternEvent(StreamEvent):
    """Selector-bound event carrying a completed pattern match."""

    __slots__ = ("state_event",)

    def __init__(self, timestamp: int, state_event: StateEvent,
                 type: EventType = EventType.CURRENT):
        super().__init__(timestamp, [], type)
        self.state_event = state_event


class JoinedEvent(StreamEvent):
    """Selector-bound event carrying a joined (left, right) pair."""

    __slots__ = ("left", "right")

    def __init__(self, timestamp: int, left: Optional[StreamEvent],
                 right: Optional[StreamEvent], type: EventType = EventType.CURRENT):
        super().__init__(timestamp, [], type)
        self.left = left
        self.right = right
