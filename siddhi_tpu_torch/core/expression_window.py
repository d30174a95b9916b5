"""Expression windows: retain events while a condition over the buffer holds.

Reference: ``ExpressionWindowProcessor`` / ``ExpressionBatchWindowProcessor`` —
``#window.expression('count() <= 20')``, ``#window.expressionBatch('last.ts -
first.ts < 5000')``. The expression sees:

- bare attributes → the newest (just-arrived) event
- ``first.attr`` / ``last.attr`` → oldest / newest buffered event
- ``count()``, ``sum(x)``, ``avg(x)``, ``min(x)``, ``max(x)`` → over the buffer
- ``eventTimestamp(first)`` / ``eventTimestamp(last)`` → buffer boundary times

Sliding form: on arrival, evict oldest events until the expression holds.
Batch form: when the expression turns false, flush the buffered batch (expiring
the previous batch) and start fresh with the new event.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..query_api import AttributeFunction, DataType, Variable
from ..query_api.definition import StreamDefinition
from .event import EventType, StreamEvent
from .executor import ExecutorBuilder, VariableResolver
from .windows import WindowProcessor


class _BufferFrame:
    __slots__ = ("buffer", "newest")

    def __init__(self, buffer: list[StreamEvent], newest: StreamEvent):
        self.buffer = buffer
        self.newest = newest

    def timestamp(self) -> int:
        return self.newest.timestamp


class _AggCache:
    """Running aggregates over a FIFO buffer, resynced by identity against the
    buffer's endpoints: evictions pop from the front, appends extend the back,
    so each event's value is computed exactly once."""

    def __init__(self):
        from collections import deque
        self.entries = deque()          # (event, value) aligned with buffer
        self.sum = 0                    # int stays int; += float promotes
        self.nn = 0                     # non-null count
        self.minq = deque()             # monotonic (value, event)
        self.maxq = deque()

    def sync(self, buffer: list, valfn) -> None:
        ents = self.entries
        while ents and (not buffer or ents[0][0] is not buffer[0]):
            ev, v = ents.popleft()
            if v is not None:
                self.sum -= v
                self.nn -= 1
                if self.minq and self.minq[0][1] is ev:
                    self.minq.popleft()
                if self.maxq and self.maxq[0][1] is ev:
                    self.maxq.popleft()
        for i in range(len(ents), len(buffer)):
            ev = buffer[i]
            v = valfn(ev)
            ents.append((ev, v))
            if v is not None:
                self.sum += v
                self.nn += 1
                while self.minq and self.minq[-1][0] >= v:
                    self.minq.pop()
                self.minq.append((v, ev))
                while self.maxq and self.maxq[-1][0] <= v:
                    self.maxq.pop()
                self.maxq.append((v, ev))


class _BufferResolver(VariableResolver):
    def __init__(self, definition: StreamDefinition):
        self.definition = definition

    def resolve(self, var: Variable):
        d = self.definition
        if var.stream_id in ("first", "last"):
            pos = d.attribute_position(var.attribute)
            if var.stream_id == "first":
                return (lambda f: f.buffer[0].data[pos] if f.buffer else None), \
                    d.attributes[pos].type
            return (lambda f: f.buffer[-1].data[pos] if f.buffer else None), \
                d.attributes[pos].type
        pos = d.attribute_position(var.attribute)
        return (lambda f: f.newest.data[pos]), d.attributes[pos].type


def _build_buffer_fn(expr, definition: StreamDefinition, app_context) -> Callable:
    """Compile the window expression with buffer-aggregate function support."""
    resolver = _BufferResolver(definition)
    # set after the rewrite pass below; True when some aggregate's argument
    # references first./last./eventTimestamp — those change as the buffer
    # moves, so per-event values can't be cached at append time
    _agg_arg_buffer_dep = [False]

    def agg_builder(kind):
        def build(fns, types):
            # incremental per-window cache: the buffer is FIFO (append at the
            # back, evict from the front), so running sum/count plus monotonic
            # deques give O(1) amortized evaluation instead of re-walking the
            # whole buffer on every check (the reference keeps equivalent
            # incremental state in ExpressionWindowProcessor's per-attribute
            # executors)
            cache = _AggCache()

            def run(f: _BufferFrame):
                if kind == "count":
                    return len(f.buffer)
                if _agg_arg_buffer_dep[0]:
                    vals = [v for v in (fns[0](_BufferFrame(f.buffer, e))
                                        for e in f.buffer) if v is not None]
                    if not vals:
                        return None
                    if kind == "sum":
                        return sum(vals)
                    if kind == "avg":
                        return sum(vals) / len(vals)
                    return min(vals) if kind == "min" else max(vals)
                cache.sync(f.buffer,
                           lambda e: fns[0](_BufferFrame(f.buffer, e)))
                if cache.nn == 0:
                    return None
                if kind == "sum":
                    return cache.sum
                if kind == "avg":
                    return cache.sum / cache.nn
                if kind == "min":
                    return cache.minq[0][0]
                return cache.maxq[0][0]
            return run, DataType.DOUBLE if kind in ("avg",) else (
                types[0] if types else DataType.LONG)
        return build

    extra = {
        "count": agg_builder("count"),
        "sum": agg_builder("sum"),
        "avg": agg_builder("avg"),
        "min": agg_builder("min"),
        "max": agg_builder("max"),
    }

    # rewrite eventTimestamp(first|last) before building
    def rewrite(e):
        if isinstance(e, AttributeFunction) and e.name == "eventTimestamp" \
                and e.args and isinstance(e.args[0], Variable) \
                and e.args[0].attribute in ("first", "last"):
            which = e.args[0].attribute
            return _TimestampOf(which)
        for attr in ("left", "right", "expr"):
            sub = getattr(e, attr, None)
            if sub is not None and hasattr(sub, "__class__") and not isinstance(sub, (int, float, str)):
                new = rewrite(sub)
                if new is not sub:
                    setattr(e, attr, new)
        if isinstance(e, AttributeFunction):
            e.args = [rewrite(a) for a in e.args]
        return e

    expr = rewrite(expr)

    def _buffer_dep(e) -> bool:
        if isinstance(e, _TimestampOf):
            return True
        if isinstance(e, Variable) and e.stream_id in ("first", "last"):
            return True
        if isinstance(e, AttributeFunction) and e.namespace is None \
                and e.name in ("sum", "avg", "min", "max", "count"):
            return True  # nested aggregate: value moves with the buffer
        for attr in ("left", "right", "expr"):
            sub = getattr(e, attr, None)
            if sub is not None and not isinstance(sub, (int, float, str, bool)) \
                    and _buffer_dep(sub):
                return True
        if isinstance(e, AttributeFunction):
            return any(_buffer_dep(a) for a in e.args)
        return False

    def _scan_agg_args(e) -> None:
        if isinstance(e, AttributeFunction) and e.namespace is None \
                and e.name in ("sum", "avg", "min", "max"):
            if any(_buffer_dep(a) for a in e.args):
                _agg_arg_buffer_dep[0] = True
        for attr in ("left", "right", "expr"):
            sub = getattr(e, attr, None)
            if sub is not None and not isinstance(sub, (int, float, str, bool)):
                _scan_agg_args(sub)
        if isinstance(e, AttributeFunction):
            for a in e.args:
                _scan_agg_args(a)

    _scan_agg_args(expr)

    class _Builder(ExecutorBuilder):
        def build(self, e):
            if isinstance(e, _TimestampOf):
                if e.which == "first":
                    return (lambda f: f.buffer[0].timestamp if f.buffer else 0), \
                        DataType.LONG
                return (lambda f: f.buffer[-1].timestamp if f.buffer else 0), \
                    DataType.LONG
            return super().build(e)

    builder = _Builder(resolver, app_context, extra_functions=extra)
    fn, _ = builder.build(expr)
    return fn


class _TimestampOf:
    def __init__(self, which: str):
        self.which = which


class DynamicExpressionWindow(WindowProcessor):
    """Sliding: evict oldest until the expression holds."""

    def __init__(self, expr, definition: StreamDefinition, app_context):
        super().__init__()
        self.fn = _build_buffer_fn(expr, definition, app_context)
        self.buffer: list[StreamEvent] = []

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type != EventType.CURRENT:
                continue
            self.buffer.append(ev)
            while self.buffer and not bool(
                    self.fn(_BufferFrame(self.buffer, ev))):
                out.append(self._expired(self.buffer.pop(0), ev.timestamp))
            out.append(ev)
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return list(self.buffer)

    def snapshot_state(self) -> dict:
        return {"buffer": [(e.timestamp, list(e.data)) for e in self.buffer]}

    def restore_state(self, state: dict) -> None:
        self.buffer = [StreamEvent(t, d) for t, d in state["buffer"]]


class DynamicExpressionBatchWindow(WindowProcessor):
    """Batch: flush the collected batch when the expression turns false."""

    def __init__(self, expr, definition: StreamDefinition, app_context):
        super().__init__()
        self.fn = _build_buffer_fn(expr, definition, app_context)
        self.pending: list[StreamEvent] = []
        self.last_batch: list[StreamEvent] = []

    def process(self, events: list[StreamEvent]) -> None:
        out: list[StreamEvent] = []
        for ev in events:
            if ev.type != EventType.CURRENT:
                continue
            trial = self.pending + [ev]
            if self.pending and not bool(self.fn(_BufferFrame(trial, ev))):
                # flush current batch, start a new one with this event
                for old in self.last_batch:
                    out.append(self._expired(old, ev.timestamp))
                out.append(StreamEvent(ev.timestamp, [], EventType.RESET))
                out.extend(self.pending)
                self.last_batch = self.pending
                self.pending = [ev]
            else:
                self.pending.append(ev)
        self.forward(out)

    def find_events(self) -> list[StreamEvent]:
        return list(self.last_batch) + list(self.pending)

    def snapshot_state(self) -> dict:
        return {"pending": [(e.timestamp, list(e.data)) for e in self.pending],
                "last": [(e.timestamp, list(e.data)) for e in self.last_batch]}

    def restore_state(self, state: dict) -> None:
        self.pending = [StreamEvent(t, d) for t, d in state["pending"]]
        self.last_batch = [StreamEvent(t, d) for t, d in state["last"]]
