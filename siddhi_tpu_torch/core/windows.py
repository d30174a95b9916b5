"""Window processors.

Reference: ``core/query/processor/stream/window/`` (30 types, 6,866 LoC). Each
window emits CURRENT events for arrivals and EXPIRED events for evictions — the
retraction protocol downstream aggregators rely on (see
``LengthWindowProcessor.java:106-140``). Time-driven windows use the deterministic
Scheduler (watermark timers) instead of wall-clock callbacks.

All windows implement ``snapshot_state``/``restore_state`` (checkpointing) and
``find_events`` (join support, the reference's ``FindableProcessor.find``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

from ..query_api.definition import DataType
from .event import EventType, StreamEvent
from .executor import RowFrame, StreamFrame
from .processors import Processor


class WindowProcessor(Processor):
    requires_scheduler = False

    def __init__(self):
        super().__init__()
        self.app_context = None
        self.element_id = None

    def setup(self, app_context, element_id: str) -> None:
        self.app_context = app_context
        self.element_id = element_id
        app_context.register_state(element_id, self)

    # join support: current window contents
    def find_events(self) -> list[StreamEvent]:
        return []

    def snapshot_state(self) -> dict:
        return {}

    def restore_state(self, state: dict) -> None:
        pass

    @staticmethod
    def _expired(ev: StreamEvent, ts: Optional[int] = None) -> StreamEvent:
        e = ev.copy()
        e.type = EventType.EXPIRED
        if ts is not None:
            e.timestamp = ts
        return e


# ---------------------------------------------------------------------------
# length / lengthBatch / batch
# ---------------------------------------------------------------------------

class LengthWindow(WindowProcessor):
    """Sliding count window (reference ``LengthWindowProcessor.java:81``).
    Buffer is op-log snapshotable (``SnapshotableStreamEventQueue`` analog)."""

    def __init__(self, length: int):
        super().__init__()
        from .snapshot import SnapshotableEventBuffer
        self.length = length
        self.buffer = SnapshotableEventBuffer()

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type != EventType.CURRENT:
                continue
            if len(self.buffer) >= self.length:
                oldest = self.buffer.popleft()
                out.append(self._expired(oldest, ev.timestamp))
            self.buffer.append(ev)
            out.append(ev)
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return list(self.buffer)

    def snapshot_state(self) -> dict:
        return {"buffer": self.buffer.capture()}

    def restore_state(self, state: dict) -> None:
        self.buffer.restore(state["buffer"])

    def reset_increment_baseline(self) -> None:
        self.buffer.begin_oplog()

    def incremental_snapshot_state(self) -> "Optional[dict]":
        ops = self.buffer.incremental_snapshot()
        return None if ops is None else {"ops": ops}

    def apply_increment(self, inc: dict) -> None:
        self.buffer.apply_ops(inc["ops"])


class LengthBatchWindow(WindowProcessor):
    """Tumbling count window: emits when N collected; previous batch expires."""

    def __init__(self, length: int):
        super().__init__()
        self.length = length
        self.pending: list[StreamEvent] = []
        self.last_batch: list[StreamEvent] = []

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type != EventType.CURRENT:
                continue
            self.pending.append(ev)
            if len(self.pending) >= self.length:
                ts = ev.timestamp
                for old in self.last_batch:
                    out.append(self._expired(old, ts))
                out.append(StreamEvent(ts, [], EventType.RESET))
                out.extend(self.pending)
                self.last_batch = self.pending
                self.pending = []
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return list(self.last_batch) + list(self.pending)

    def snapshot_state(self) -> dict:
        return {
            "pending": [(e.timestamp, list(e.data)) for e in self.pending],
            "last": [(e.timestamp, list(e.data)) for e in self.last_batch],
        }

    def restore_state(self, state: dict) -> None:
        self.pending = [StreamEvent(t, d) for t, d in state["pending"]]
        self.last_batch = [StreamEvent(t, d) for t, d in state["last"]]


class BatchWindow(WindowProcessor):
    """Per-chunk batch window (reference ``BatchWindowProcessor``)."""

    def __init__(self):
        super().__init__()
        self.last_batch: list[StreamEvent] = []

    def process(self, events: list[StreamEvent]) -> None:
        currents = [e for e in events if e.type == EventType.CURRENT]
        if not currents:
            return
        out: list[StreamEvent] = []
        ts = currents[-1].timestamp
        for old in self.last_batch:
            out.append(self._expired(old, ts))
        out.append(StreamEvent(ts, [], EventType.RESET))
        out.extend(currents)
        self.last_batch = currents
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return list(self.last_batch)

    def snapshot_state(self) -> dict:
        return {"last": [(e.timestamp, list(e.data)) for e in self.last_batch]}

    def restore_state(self, state: dict) -> None:
        self.last_batch = [StreamEvent(t, d) for t, d in state["last"]]


# ---------------------------------------------------------------------------
# time / timeBatch / timeLength / delay
# ---------------------------------------------------------------------------

class TimeWindow(WindowProcessor):
    """Sliding time window (reference ``TimeWindowProcessor.java:86``)."""

    requires_scheduler = True

    def __init__(self, duration_ms: int):
        super().__init__()
        from .snapshot import SnapshotableEventBuffer
        self.duration = duration_ms
        self.buffer = SnapshotableEventBuffer()

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type == EventType.TIMER:
                out.extend(self._expire(ev.timestamp))
                continue
            if ev.type != EventType.CURRENT:
                continue
            out.extend(self._expire(ev.timestamp))
            self.buffer.append(ev)
            out.append(ev)
            self.app_context.scheduler.notify_at(
                ev.timestamp + self.duration, self._on_timer)
        self.forward(out)

    def _expire(self, now: int) -> list[StreamEvent]:
        out = []
        while self.buffer and self.buffer[0].timestamp + self.duration <= now:
            out.append(self._expired(self.buffer.popleft(), now))
        return out

    def _on_timer(self, ts: int) -> None:
        self.process([StreamEvent(ts, [], EventType.TIMER)])

    def find_events(self) -> list[StreamEvent]:
        return list(self.buffer)

    def snapshot_state(self) -> dict:
        return {"buffer": self.buffer.capture()}

    def restore_state(self, state: dict) -> None:
        self.buffer.restore(state["buffer"])
        # re-arm expiry timers (fresh scheduler after restore)
        for e in self.buffer:
            self.app_context.scheduler.notify_at(
                e.timestamp + self.duration, self._on_timer)

    def reset_increment_baseline(self) -> None:
        self.buffer.begin_oplog()

    def incremental_snapshot_state(self) -> "Optional[dict]":
        ops = self.buffer.incremental_snapshot()
        return None if ops is None else {"ops": ops}

    def apply_increment(self, inc: dict) -> None:
        self.buffer.apply_ops(inc["ops"])
        # arm timers only for the newly appended events; survivors from the
        # base restore already have theirs
        for op in inc["ops"]:
            if op[0] == "a":
                self.app_context.scheduler.notify_at(
                    op[1] + self.duration, self._on_timer)


class TimeBatchWindow(WindowProcessor):
    """Tumbling time window."""

    requires_scheduler = True

    def __init__(self, duration_ms: int, start_time: Optional[int] = None):
        super().__init__()
        self.duration = duration_ms
        self.start_time = start_time
        self.pending: list[StreamEvent] = []
        self.last_batch: list[StreamEvent] = []
        self.boundary: Optional[int] = None

    def process(self, events: list[StreamEvent]) -> None:
        # per-flush forwards, same rationale as HoppingWindow.process: the
        # selector collapses each aggregated batch chunk to one row, so two
        # boundary flushes merged into one forward would lose a row
        for ev in events:
            if ev.type == EventType.TIMER:
                if self.boundary is not None and ev.timestamp >= self.boundary:
                    self.forward(self._flush(self.boundary))
                continue
            if ev.type != EventType.CURRENT:
                continue
            if self.boundary is None:
                base = self.start_time if self.start_time is not None else ev.timestamp
                self.boundary = base + self.duration
                self.app_context.scheduler.notify_at(self.boundary, self._on_timer)
            while ev.timestamp >= self.boundary:
                self.forward(self._flush(self.boundary))
            self.pending.append(ev)

    def _flush(self, ts: int) -> list[StreamEvent]:
        out: list[StreamEvent] = []
        if self.pending or self.last_batch:
            for old in self.last_batch:
                out.append(self._expired(old, ts))
            out.append(StreamEvent(ts, [], EventType.RESET))
            out.extend(self.pending)
            self.last_batch = self.pending
            self.pending = []
        self.boundary += self.duration
        self.app_context.scheduler.notify_at(self.boundary, self._on_timer)
        return out

    def _on_timer(self, ts: int) -> None:
        self.process([StreamEvent(ts, [], EventType.TIMER)])

    def find_events(self) -> list[StreamEvent]:
        return list(self.last_batch) + list(self.pending)

    def snapshot_state(self) -> dict:
        return {
            "pending": [(e.timestamp, list(e.data)) for e in self.pending],
            "last": [(e.timestamp, list(e.data)) for e in self.last_batch],
            "boundary": self.boundary,
        }

    def restore_state(self, state: dict) -> None:
        self.pending = [StreamEvent(t, d) for t, d in state["pending"]]
        self.last_batch = [StreamEvent(t, d) for t, d in state["last"]]
        self.boundary = state["boundary"]
        if self.boundary is not None:
            self.app_context.scheduler.notify_at(self.boundary, self._on_timer)


class TimeLengthWindow(WindowProcessor):
    """Sliding window bounded by both time and count."""

    requires_scheduler = True

    def __init__(self, duration_ms: int, length: int):
        super().__init__()
        self.duration = duration_ms
        self.length = length
        self.buffer: list[StreamEvent] = []

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type == EventType.TIMER:
                out.extend(self._expire(ev.timestamp))
                continue
            if ev.type != EventType.CURRENT:
                continue
            out.extend(self._expire(ev.timestamp))
            if len(self.buffer) >= self.length:
                out.append(self._expired(self.buffer.pop(0), ev.timestamp))
            self.buffer.append(ev)
            out.append(ev)
            self.app_context.scheduler.notify_at(
                ev.timestamp + self.duration, self._on_timer)
        self.forward(out)

    def _expire(self, now: int) -> list[StreamEvent]:
        out = []
        while self.buffer and self.buffer[0].timestamp + self.duration <= now:
            out.append(self._expired(self.buffer.pop(0), now))
        return out

    def _on_timer(self, ts: int) -> None:
        self.process([StreamEvent(ts, [], EventType.TIMER)])

    def find_events(self) -> list[StreamEvent]:
        return list(self.buffer)

    def snapshot_state(self) -> dict:
        return {"buffer": [(e.timestamp, list(e.data)) for e in self.buffer]}

    def restore_state(self, state: dict) -> None:
        self.buffer = [StreamEvent(t, d) for t, d in state["buffer"]]
        for e in self.buffer:
            self.app_context.scheduler.notify_at(
                e.timestamp + self.duration, self._on_timer)


class DelayWindow(WindowProcessor):
    """Events pass through after a fixed delay (reference ``DelayWindowProcessor``)."""

    requires_scheduler = True

    def __init__(self, delay_ms: int):
        super().__init__()
        self.delay = delay_ms
        self.held: list[StreamEvent] = []

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type == EventType.TIMER:
                while self.held and self.held[0].timestamp + self.delay <= ev.timestamp:
                    e = self.held.pop(0)
                    out.append(StreamEvent(ev.timestamp, e.data, EventType.CURRENT))
                continue
            if ev.type != EventType.CURRENT:
                continue
            self.held.append(ev)
            self.app_context.scheduler.notify_at(ev.timestamp + self.delay, self._on_timer)
        self.forward(out)

    def _on_timer(self, ts: int) -> None:
        self.process([StreamEvent(ts, [], EventType.TIMER)])

    def find_events(self) -> list[StreamEvent]:
        return list(self.held)

    def snapshot_state(self) -> dict:
        return {"held": [(e.timestamp, list(e.data)) for e in self.held]}

    def restore_state(self, state: dict) -> None:
        self.held = [StreamEvent(t, d) for t, d in state["held"]]
        for e in self.held:
            self.app_context.scheduler.notify_at(
                e.timestamp + self.delay, self._on_timer)


# ---------------------------------------------------------------------------
# externalTime / externalTimeBatch — event-time attribute driven
# ---------------------------------------------------------------------------

class ExternalTimeWindow(WindowProcessor):
    """Sliding window over an event-time attribute."""

    def __init__(self, ts_executor: Callable, duration_ms: int):
        super().__init__()
        self.ts_executor = ts_executor
        self.duration = duration_ms
        self.buffer: list[tuple[int, StreamEvent]] = []

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type != EventType.CURRENT:
                continue
            ets = int(self.ts_executor(StreamFrame(ev)))
            while self.buffer and self.buffer[0][0] + self.duration <= ets:
                out.append(self._expired(self.buffer.pop(0)[1], ev.timestamp))
            self.buffer.append((ets, ev))
            out.append(ev)
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return [e for _, e in self.buffer]

    def snapshot_state(self) -> dict:
        return {"buffer": [(ets, e.timestamp, list(e.data))
                           for ets, e in self.buffer]}

    def restore_state(self, state: dict) -> None:
        self.buffer = [(ets, StreamEvent(t, d)) for ets, t, d in state["buffer"]]


class ExternalTimeBatchWindow(WindowProcessor):
    """Tumbling window over an event-time attribute."""

    def __init__(self, ts_executor: Callable, duration_ms: int,
                 start_time: Optional[int] = None):
        super().__init__()
        self.ts_executor = ts_executor
        self.duration = duration_ms
        self.start_time = start_time
        self.boundary: Optional[int] = None
        self.pending: list[StreamEvent] = []
        self.last_batch: list[StreamEvent] = []

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type != EventType.CURRENT:
                continue
            ets = int(self.ts_executor(StreamFrame(ev)))
            if self.boundary is None:
                base = self.start_time if self.start_time is not None else ets
                self.boundary = base + self.duration
            while ets >= self.boundary:
                if self.pending or self.last_batch:
                    for old in self.last_batch:
                        out.append(self._expired(old, ev.timestamp))
                    out.append(StreamEvent(ev.timestamp, [], EventType.RESET))
                    out.extend(self.pending)
                    self.last_batch = self.pending
                    self.pending = []
                self.boundary += self.duration
            self.pending.append(ev)
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return list(self.last_batch) + list(self.pending)

    def snapshot_state(self) -> dict:
        return {"pending": [(e.timestamp, list(e.data)) for e in self.pending],
                "last": [(e.timestamp, list(e.data)) for e in self.last_batch],
                "boundary": self.boundary}

    def restore_state(self, state: dict) -> None:
        self.pending = [StreamEvent(t, d) for t, d in state["pending"]]
        self.last_batch = [StreamEvent(t, d) for t, d in state["last"]]
        self.boundary = state["boundary"]


# ---------------------------------------------------------------------------
# session
# ---------------------------------------------------------------------------

class SessionWindow(WindowProcessor):
    """Session window with gap; optional session key (reference
    ``SessionWindowProcessor``). Currents pass through; a session's events expire
    together when the gap elapses with no new arrival."""

    requires_scheduler = True

    def __init__(self, gap_ms: int, key_executor: Optional[Callable] = None,
                 allowed_latency_ms: int = 0):
        super().__init__()
        self.gap = gap_ms
        self.key_executor = key_executor
        self.allowed_latency = allowed_latency_ms
        self.sessions: dict = {}            # key -> {"events": [...], "last_ts": int}

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type == EventType.TIMER:
                out.extend(self._close_due(ev.timestamp))
                continue
            if ev.type != EventType.CURRENT:
                continue
            out.extend(self._close_due(ev.timestamp))
            key = self.key_executor(StreamFrame(ev)) if self.key_executor else None
            sess = self.sessions.setdefault(key, {"events": [], "last_ts": ev.timestamp})
            sess["events"].append(ev)
            sess["last_ts"] = ev.timestamp
            out.append(ev)
            self.app_context.scheduler.notify_at(
                ev.timestamp + self.gap + self.allowed_latency, self._on_timer)
        self.forward(out)

    def _close_due(self, now: int) -> list[StreamEvent]:
        out = []
        for key in list(self.sessions):
            sess = self.sessions[key]
            if sess["last_ts"] + self.gap + self.allowed_latency <= now:
                for e in sess["events"]:
                    out.append(self._expired(e, now))
                del self.sessions[key]
        return out

    def _on_timer(self, ts: int) -> None:
        self.process([StreamEvent(ts, [], EventType.TIMER)])

    def find_events(self) -> list[StreamEvent]:
        return [e for s in self.sessions.values() for e in s["events"]]

    def snapshot_state(self) -> dict:
        return {"sessions": {
            key: {"events": [(e.timestamp, list(e.data)) for e in s["events"]],
                  "last_ts": s["last_ts"]}
            for key, s in self.sessions.items()}}

    def restore_state(self, state: dict) -> None:
        self.sessions = {
            key: {"events": [StreamEvent(t, d) for t, d in s["events"]],
                  "last_ts": s["last_ts"]}
            for key, s in state["sessions"].items()}
        for s in self.sessions.values():
            self.app_context.scheduler.notify_at(
                s["last_ts"] + self.gap + self.allowed_latency, self._on_timer)


# ---------------------------------------------------------------------------
# sort / frequent / lossyFrequent
# ---------------------------------------------------------------------------

class SortWindow(WindowProcessor):
    """Keeps the top-N events by sort key; evicts the extreme (reference
    ``SortWindowProcessor``)."""

    def __init__(self, length: int, key_executors: list[Callable],
                 orders: list[str]):
        super().__init__()
        self.length = length
        self.key_executors = key_executors
        self.orders = orders  # 'asc' | 'desc' per key
        self.buffer: list[StreamEvent] = []

    def _sort_key(self, ev: StreamEvent):
        keys = []
        for fn, order in zip(self.key_executors, self.orders):
            v = fn(StreamFrame(ev))
            keys.append(_Reversed(v) if order == "desc" else v)
        return tuple(keys)

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type != EventType.CURRENT:
                continue
            self.buffer.append(ev)
            self.buffer.sort(key=self._sort_key)
            out.append(ev)
            if len(self.buffer) > self.length:
                evicted = self.buffer.pop()   # worst per sort order
                out.append(self._expired(evicted, ev.timestamp))
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return list(self.buffer)

    def snapshot_state(self) -> dict:
        return {"buffer": [(e.timestamp, list(e.data)) for e in self.buffer]}

    def restore_state(self, state: dict) -> None:
        self.buffer = [StreamEvent(t, d) for t, d in state["buffer"]]


class _Reversed:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


class FrequentWindow(WindowProcessor):
    """Misra-Gries frequent-items window (reference ``FrequentWindowProcessor``)."""

    def __init__(self, count: int, key_executors: Optional[list[Callable]] = None):
        super().__init__()
        self.count = count
        self.key_executors = key_executors
        self.counts: "OrderedDict" = OrderedDict()   # key -> [count, StreamEvent]

    def _key(self, ev: StreamEvent):
        if self.key_executors:
            return tuple(fn(StreamFrame(ev)) for fn in self.key_executors)
        return tuple(ev.data)

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type != EventType.CURRENT:
                continue
            key = self._key(ev)
            if key in self.counts:
                self.counts[key][0] += 1
                self.counts[key][1] = ev
                out.append(ev)
            elif len(self.counts) < self.count:
                self.counts[key] = [1, ev]
                out.append(ev)
            else:
                # decrement all; evict zeros — and if the pass freed a
                # slot, the NEW event takes it and emits (reference
                # FrequentWindowProcessor tentatively inserts, decrements
                # the old keys, and only drops the arrival when nothing
                # evicted)
                for k in list(self.counts):
                    self.counts[k][0] -= 1
                    if self.counts[k][0] <= 0:
                        out.append(self._expired(self.counts[k][1], ev.timestamp))
                        del self.counts[k]
                if len(self.counts) < self.count:
                    self.counts[key] = [1, ev]
                    out.append(ev)
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return [v[1] for v in self.counts.values()]

    def snapshot_state(self) -> dict:
        return {"counts": [
            (key, c, e.timestamp, list(e.data))
            for key, (c, e) in self.counts.items()]}

    def restore_state(self, state: dict) -> None:
        self.counts = OrderedDict(
            (tuple(key), [c, StreamEvent(t, d)])
            for key, c, t, d in state["counts"])


class LossyFrequentWindow(WindowProcessor):
    """Lossy-counting frequent-items window."""

    def __init__(self, support: float, error: Optional[float] = None,
                 key_executors: Optional[list[Callable]] = None):
        super().__init__()
        self.support = support
        self.error = error if error is not None else support / 10.0
        self.key_executors = key_executors
        self.total = 0
        self.counts: dict = {}   # key -> [freq, delta, StreamEvent]

    def _key(self, ev: StreamEvent):
        if self.key_executors:
            return tuple(fn(StreamFrame(ev)) for fn in self.key_executors)
        return tuple(ev.data)

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type != EventType.CURRENT:
                continue
            self.total += 1
            bucket = int(self.total * self.error) + 1
            key = self._key(ev)
            if key in self.counts:
                self.counts[key][0] += 1
                self.counts[key][2] = ev
            else:
                self.counts[key] = [1, bucket - 1, ev]
            entry = self.counts[key]
            if entry[0] + entry[1] >= self.total * self.support:
                out.append(ev)
            # periodic pruning
            for k in list(self.counts):
                f, d, e = self.counts[k]
                if f + d <= bucket - 1:
                    out.append(self._expired(e, ev.timestamp))
                    del self.counts[k]
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return [v[2] for v in self.counts.values()]

    def snapshot_state(self) -> dict:
        return {"total": self.total,
                "counts": [(key, f, dlt, e.timestamp, list(e.data))
                           for key, (f, dlt, e) in self.counts.items()]}

    def restore_state(self, state: dict) -> None:
        self.total = state["total"]
        self.counts = {tuple(key): [f, dlt, StreamEvent(t, d)]
                       for key, f, dlt, t, d in state["counts"]}


# ---------------------------------------------------------------------------
# hopping — time window emitted every hop
# ---------------------------------------------------------------------------

class HoppingWindow(WindowProcessor):
    """Fixed-length window emitted every hop interval (reference
    ``HopingWindowProcessor``)."""

    requires_scheduler = True

    def __init__(self, duration_ms: int, hop_ms: int):
        super().__init__()
        self.duration = duration_ms
        self.hop = hop_ms
        self.buffer: list[StreamEvent] = []
        self.last_batch: list[StreamEvent] = []
        self.boundary: Optional[int] = None

    def process(self, events: list[StreamEvent]) -> None:
        # each flush forwards as its OWN chunk: the selector collapses
        # aggregated batch chunks to one row per chunk (reference: every
        # scheduler fire delivers its own chunk), so merging two boundary
        # flushes into one forward would silently drop the first row
        for ev in events:
            if ev.type == EventType.TIMER:
                if self.boundary is not None and ev.timestamp >= self.boundary:
                    self.forward(self._hop_flush(self.boundary))
                continue
            if ev.type != EventType.CURRENT:
                continue
            if self.boundary is None:
                self.boundary = ev.timestamp + self.hop
                self.app_context.scheduler.notify_at(self.boundary, self._on_timer)
            while ev.timestamp >= self.boundary:
                self.forward(self._hop_flush(self.boundary))
            self.buffer.append(ev)

    def _hop_flush(self, ts: int) -> list[StreamEvent]:
        out: list[StreamEvent] = []
        # retain only events within the window length
        self.buffer = [e for e in self.buffer if e.timestamp + self.duration > ts]
        for old in self.last_batch:
            out.append(self._expired(old, ts))
        out.append(StreamEvent(ts, [], EventType.RESET))
        out.extend(StreamEvent(ts, e.data, EventType.CURRENT) for e in self.buffer)
        self.last_batch = list(self.buffer)
        self.boundary += self.hop
        self.app_context.scheduler.notify_at(self.boundary, self._on_timer)
        return out

    def _on_timer(self, ts: int) -> None:
        self.process([StreamEvent(ts, [], EventType.TIMER)])

    def find_events(self) -> list[StreamEvent]:
        return list(self.buffer)

    def snapshot_state(self) -> dict:
        return {"buffer": [(e.timestamp, list(e.data)) for e in self.buffer],
                "last": [(e.timestamp, list(e.data)) for e in self.last_batch],
                "boundary": self.boundary}

    def restore_state(self, state: dict) -> None:
        self.buffer = [StreamEvent(t, d) for t, d in state["buffer"]]
        self.last_batch = [StreamEvent(t, d) for t, d in state["last"]]
        self.boundary = state["boundary"]
        if self.boundary is not None:
            self.app_context.scheduler.notify_at(self.boundary, self._on_timer)


# ---------------------------------------------------------------------------
# expression windows — retain while expression holds
# ---------------------------------------------------------------------------

class ExpressionWindow(WindowProcessor):
    """Sliding window retaining events while a condition over the buffer holds
    (reference ``ExpressionWindowProcessor``). The expression sees per-event
    attributes plus ``count()``/``sum(x)``-style built-ins via the retain check
    callback supplied by the runtime builder."""

    def __init__(self, retain_check: Callable[[list[StreamEvent], StreamEvent], int]):
        super().__init__()
        # retain_check(buffer, newest) -> number of oldest events to evict
        self.retain_check = retain_check
        self.buffer: list[StreamEvent] = []

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type != EventType.CURRENT:
                continue
            self.buffer.append(ev)
            n_evict = self.retain_check(self.buffer, ev)
            for _ in range(n_evict):
                out.append(self._expired(self.buffer.pop(0), ev.timestamp))
            out.append(ev)
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return list(self.buffer)


class EmptyWindow(WindowProcessor):
    """Pass-through window (reference ``EmptyWindowProcessor``) — `#window()`."""

    def process(self, events: list[StreamEvent]) -> None:
        out = [e for e in events if e.type == EventType.CURRENT]
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return []


# ---------------------------------------------------------------------------
# cron window
# ---------------------------------------------------------------------------

class CronWindow(WindowProcessor):
    """Batch window flushed on cron schedule (reference ``CronWindowProcessor``).

    Uses the minimal cron evaluator in ``core/cron.py`` (quartz-style
    6/7-field expressions, second resolution).
    """

    requires_scheduler = True

    def __init__(self, cron_expr: str):
        super().__init__()
        from .cron import CronSchedule
        self.schedule = CronSchedule(cron_expr)
        self.pending: list[StreamEvent] = []
        self.last_batch: list[StreamEvent] = []
        self._armed = False

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type == EventType.TIMER:
                if self.pending or self.last_batch:
                    for old in self.last_batch:
                        out.append(self._expired(old, ev.timestamp))
                    out.append(StreamEvent(ev.timestamp, [], EventType.RESET))
                    out.extend(self.pending)
                    self.last_batch = self.pending
                    self.pending = []
                self._arm(ev.timestamp)
                continue
            if ev.type != EventType.CURRENT:
                continue
            if not self._armed:
                self._arm(ev.timestamp)
            self.pending.append(ev)
        self.forward(out)

    def _arm(self, now: int) -> None:
        nxt = self.schedule.next_fire_after(now)
        if nxt is not None:
            self.app_context.scheduler.notify_at(nxt, self._on_timer)
            self._armed = True

    def _on_timer(self, ts: int) -> None:
        self.process([StreamEvent(ts, [], EventType.TIMER)])

    def find_events(self) -> list[StreamEvent]:
        return list(self.last_batch) + list(self.pending)

    def snapshot_state(self) -> dict:
        return {"pending": [(e.timestamp, list(e.data)) for e in self.pending],
                "last": [(e.timestamp, list(e.data)) for e in self.last_batch],
                "armed": self._armed}

    def restore_state(self, state: dict) -> None:
        self.pending = [StreamEvent(t, d) for t, d in state["pending"]]
        self.last_batch = [StreamEvent(t, d) for t, d in state["last"]]
        self._armed = False
        if state.get("armed"):
            self._arm(self.app_context.current_time())
