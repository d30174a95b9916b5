"""Stream junctions, input handlers, callbacks — the event bus.

Reference: ``core/stream/StreamJunction.java`` (pub/sub per stream, fault routing),
``stream/input/InputHandler.java``, ``stream/output/StreamCallback.java``,
``query/output/callback/QueryCallback.java``. The reference's optional LMAX
Disruptor async mode is replaced by the device path's micro-batching ingress; the
interpreter junction is synchronous and deterministic.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as np

from ..query_api.definition import AbstractDefinition
from .event import Event, EventType, StreamEvent

log = logging.getLogger("siddhi_tpu_torch.stream")


class OnErrorAction:
    LOG = "log"
    STREAM = "stream"
    STORE = "store"


class StreamJunction:
    """Per-stream event bus: receivers subscribe; publishers send.

    ``@async(buffer.size, workers, batch.size.max)`` on the stream definition
    switches the junction to asynchronous dispatch (the reference's Disruptor
    mode, ``StreamJunction.java:279-316``): ``send_event`` enqueues into an
    ``AsyncDispatcher`` and worker threads deliver under the app lock.
    """

    def __init__(self, definition: AbstractDefinition, app_context,
                 on_error_action: str = OnErrorAction.LOG):
        self.definition = definition
        self.app_context = app_context
        self.receivers: list = []          # objects with .receive(StreamEvent)
        self.on_error_action = on_error_action
        self.fault_junction: Optional["StreamJunction"] = None
        self.throughput = 0
        self.receiver_errors = 0           # every receiver failure counts —
        # multi-query fan-out faults must not collapse into one
        self.last_event_ts: Optional[int] = None   # newest delivered event
        # time — the watermark-lag gauge reads app clock minus this
        self.dispatcher = None             # AsyncDispatcher when @async
        self.flow = None                   # StreamFlow when @app:wal/@app:backpressure

    def subscribe(self, receiver) -> None:
        if receiver not in self.receivers:
            self.receivers.append(receiver)

    def unsubscribe(self, receiver) -> None:
        if receiver in self.receivers:
            self.receivers.remove(receiver)

    def enable_async(self, buffer_size: int = 1024, workers: int = 1,
                     batch_size_max: int = 64) -> None:
        from .async_junction import AsyncDispatcher
        self.dispatcher = AsyncDispatcher(
            self, self.app_context, buffer_size=buffer_size, workers=workers,
            batch_size_max=batch_size_max)

    def send_event(self, event: StreamEvent) -> None:
        if self.dispatcher is not None:
            # throughput counts at DELIVERY (worker, under the engine lock):
            # a bare += here would race between producer threads
            tracer = self.app_context.tracer
            if tracer is not None and event.trace is None:
                # the delivery worker is a different thread: the sampled
                # trace must ride the event across the queue (the handoff
                # mark becomes an ingress-queue span at delivery)
                event.trace = tracer.active
                if event.trace is not None:
                    event.trace.mark_handoff()
            self.dispatcher.enqueue(("event", event))
            return
        self.deliver_event(event)

    def send_events(self, events: list[StreamEvent]) -> None:
        """Deliver a chunk, preserving batch identity for chunk-aware receivers
        (``#window.batch()`` semantics depend on it)."""
        if not events:
            return
        if self.dispatcher is not None:
            tracer = self.app_context.tracer
            if tracer is not None and events[0].trace is None:
                events[0].trace = tracer.active
                if events[0].trace is not None:
                    events[0].trace.mark_handoff()
            self.dispatcher.enqueue(("chunk", events))
            return
        self.deliver_events(events)

    def _activate_trace(self, trace):
        """Re-activate a queue-carried trace on the delivery thread; returns
        True when a matching pop() is owed. The enqueue-to-delivery wait
        closes as an ``ingress-queue`` span (the handoff mark)."""
        tracer = self.app_context.tracer
        if tracer is None or trace is None or tracer.active is trace:
            return False
        trace.close_handoff(self.definition.id)
        tracer.push(trace)
        return True

    def deliver_event(self, event: StreamEvent) -> None:
        """Synchronous delivery into the receiver chain (worker entry point in
        async mode; delivery is serialized under the engine lock)."""
        self.throughput += 1
        self.last_event_ts = event.timestamp if self.last_event_ts is None \
            else max(self.last_event_ts, event.timestamp)
        pushed = self._activate_trace(event.trace)
        first_error = None
        try:
            for r in self.receivers:
                try:
                    r.receive(event)
                except Exception as e:  # noqa: BLE001 — per-receiver isolation:
                    # one faulty query must not starve the other subscribers
                    self._record_receiver_error(r, e)
                    if first_error is None:
                        first_error = e
        finally:
            if pushed:
                self.app_context.tracer.pop()
        if self.flow is not None and event.flow_seq is not None:
            # applied watermark advances under the engine lock: a quiesced
            # snapshot records a cut at a WAL record boundary
            self.flow.on_applied(event.flow_seq)
        if first_error is not None:
            # every failure was logged/counted above; the event routes to
            # fault handling ONCE — per-receiver routing would store/emit
            # the same event twice and duplicate it on replay
            self.handle_error(event, first_error)

    def rows_capable(self) -> bool:
        """True when every subscriber accepts raw row chunks — the columnar
        fast path can then skip per-event ``StreamEvent`` materialization
        entirely (measured ~35% of chunked-ingress wall time)."""
        return self.dispatcher is None and self.flow is None and \
            self.receivers and \
            all(hasattr(r, "receive_rows") for r in self.receivers)

    def deliver_rows(self, rows: list, timestamps) -> None:
        """Zero-wrap chunk delivery to rows-capable receivers (see
        ``rows_capable``). Caller transfers ownership of ``rows``."""
        self.throughput += len(rows)
        newest = max(timestamps)
        self.last_event_ts = newest if self.last_event_ts is None \
            else max(self.last_event_ts, newest)
        for r in self.receivers:
            try:
                r.receive_rows(rows, timestamps)
            except Exception as e:  # noqa: BLE001 — per-receiver isolation,
                # same contract as deliver_events; fault routing sees the
                # chunk as StreamEvents (rare path, built on demand)
                self._record_receiver_error(r, e)
                self.handle_error(
                    [StreamEvent(ts, list(row), EventType.CURRENT)
                     for row, ts in zip(rows, timestamps)], e)

    def columns_capable(self) -> bool:
        """True when every subscriber accepts whole columnar chunks — the
        zero-object edge then hands numpy columns end to end (source →
        junction → sink) with no per-event Python objects at all. Unlike
        ``rows_capable`` an empty receiver list IS capable: the chunk is
        counted and dropped, same as ``send_events`` to a bare junction."""
        return self.dispatcher is None and self.flow is None and \
            all(hasattr(r, "receive_columns") for r in self.receivers)

    def deliver_columns(self, cols: dict, ts: np.ndarray, n: int) -> None:
        """Zero-object chunk delivery to columns-capable receivers (see
        ``columns_capable``). ``cols`` maps attribute name → numpy column;
        receivers must not mutate them."""
        self.throughput += n
        newest = int(ts.max()) if n else 0
        self.last_event_ts = newest if self.last_event_ts is None \
            else max(self.last_event_ts, newest)
        for r in self.receivers:
            try:
                r.receive_columns(cols, ts, n)
            except Exception as e:  # noqa: BLE001 — per-receiver isolation,
                # same contract as deliver_rows; fault routing sees the
                # chunk as StreamEvents (failure path, built on demand)
                self._record_receiver_error(r, e)
                self.handle_error(self._columns_fault_events(cols, ts, n), e)

    def _columns_fault_events(self, cols: dict, ts, n: int) -> list:
        from .columns import columns_to_rows
        rows = columns_to_rows(cols, self.definition.attribute_names, n)
        return [StreamEvent(int(t), row, EventType.CURRENT)
                for row, t in zip(rows, np.asarray(ts).tolist())]

    def deliver_events(self, events: list[StreamEvent]) -> None:
        self.throughput += len(events)
        newest = max(e.timestamp for e in events)
        self.last_event_ts = newest if self.last_event_ts is None \
            else max(self.last_event_ts, newest)
        pushed = self._activate_trace(events[0].trace)
        failures = {}           # id(event|chunk) -> (target, first exception)
        try:
            for r in self.receivers:
                if hasattr(r, "receive_chunk"):
                    try:
                        r.receive_chunk(events)
                    except Exception as e:  # noqa: BLE001 — chunk receivers
                        # process the batch as one unit: the failure is
                        # attributed to the chunk, not an arbitrary member
                        self._record_receiver_error(r, e)
                        failures.setdefault(id(events), (events, e))
                else:
                    for ev in events:
                        try:
                            r.receive(ev)
                        except Exception as e:  # noqa: BLE001 — attribute the
                            # failure to the event that actually raised
                            self._record_receiver_error(r, e)
                            failures.setdefault(id(ev), (ev, e))
        finally:
            if pushed:
                self.app_context.tracer.pop()
        if self.flow is not None:
            seqs = [e.flow_seq for e in events if e.flow_seq is not None]
            if seqs:
                self.flow.on_applied(max(seqs))
        # one fault route per failed event (all failures counted above). A
        # chunk-level failure covers every member, so it supersedes any
        # per-event failures — routing both would store an event twice and
        # duplicate it on replay.
        if id(events) in failures:
            self.handle_error(events, failures[id(events)][1])
        else:
            for target, e in failures.values():
                self.handle_error(target, e)

    def _record_receiver_error(self, receiver, e: Exception) -> None:
        self.receiver_errors += 1
        log.error("receiver %s failed on stream '%s': %s",
                  type(receiver).__name__, self.definition.id, e)

    def handle_error(self, event, e: Exception) -> None:
        """Fault routing for one failed event — or a whole chunk when a
        chunk-aware receiver failed mid-batch (each member is routed)."""
        events = event if isinstance(event, list) else [event]
        if self.on_error_action == OnErrorAction.STREAM and self.fault_junction:
            for ev in events:
                # the fault definition declares _error OBJECT: carry the
                # exception itself (reference fault streams), not str(e)
                self.fault_junction.send_event(StreamEvent(
                    ev.timestamp, list(ev.data) + [e], ev.type))
            return
        if self.on_error_action == OnErrorAction.STORE:
            store = getattr(self.app_context.siddhi_context, "error_store", None)
            if store is not None:
                for ev in events:
                    store.save(self.app_context.name, self.definition.id,
                               ev, e, occurrence="before")
                return
        listener = self.app_context.exception_listener
        if listener is not None:
            listener(e)
        else:
            # LOG action (the default): record and continue — the event is
            # dropped, the app keeps running (reference OnErrorAction.LOG)
            log.error("error on stream '%s': %s", self.definition.id, e,
                      exc_info=True)


class InputHandler:
    """User-facing ingress for one stream (reference ``InputHandler.java``)."""

    def __init__(self, stream_id: str, junction: StreamJunction, app_context):
        self.stream_id = stream_id
        self.junction = junction
        self.app_context = app_context
        self.flow = None                # StreamFlow: WAL + admission gate

    def send(self, data, timestamp: Optional[int] = None) -> None:
        """Accepts ``[a, b, c]``, ``Event``, or ``list[Event]``."""
        tracer = self.app_context.tracer
        if tracer is None:
            self._send(data, timestamp)
            return
        tr = tracer.maybe_trace(self.stream_id)
        if tr is None:
            self._send(data, timestamp)
            return
        # sampled: the ingress span covers admission/WAL/dispatch; the
        # trace stays stack-active so synchronous downstream stages (query,
        # window, selector, sink) attach their spans without any plumbing
        n = len(data) if data and not isinstance(data, Event) \
            and isinstance(data[0], Event) else 1
        t0 = time.perf_counter_ns()
        tracer.push(tr)
        outcome = "error"
        try:
            outcome = self._send(data, timestamp) or "ok"
        finally:
            tracer.pop()
            tr.add_span("ingress", self.stream_id,
                        time.perf_counter_ns() - t0, n, outcome)

    def _send(self, data, timestamp: Optional[int] = None):
        if self.flow is not None and not self.flow.replaying:
            return self._send_flow(data, timestamp)
        if self.junction.dispatcher is not None:
            # async junction: producers only touch the queue mutex — the
            # watermark advances at DELIVERY time on the worker (under the
            # engine lock), so timers fire in processing order
            if isinstance(data, Event):
                self._check_arity(data.data)
                self.junction.send_event(
                    StreamEvent(data.timestamp, list(data.data),
                                EventType.CURRENT))
            elif data and isinstance(data[0], Event):
                for ev in data:
                    self._check_arity(ev.data)
                self.junction.send_events([
                    StreamEvent(ev.timestamp, list(ev.data), EventType.CURRENT)
                    for ev in data
                ])
            else:
                ts = timestamp if timestamp is not None \
                    else self.app_context.current_time()
                self._check_arity(data)
                self.junction.send_event(
                    StreamEvent(ts, list(data), EventType.CURRENT))
            return
        with self.app_context.root_lock:
            if isinstance(data, Event):
                self._send_one(data.timestamp, data.data)
            elif data and isinstance(data[0], Event):
                # watermark: only advance to the chunk's FIRST timestamp before
                # delivery — firing later timers first would reorder events
                # around window boundaries; the rest advances after the chunk
                self.app_context.advance_time(min(ev.timestamp for ev in data))
                for ev in data:
                    self._check_arity(ev.data)
                self.junction.send_events([
                    StreamEvent(ev.timestamp, list(ev.data), EventType.CURRENT)
                    for ev in data
                ])
                self.app_context.advance_time(max(ev.timestamp for ev in data))
            else:
                ts = timestamp if timestamp is not None else self.app_context.current_time()
                self._send_one(ts, list(data))

    def _send_flow(self, data, timestamp: Optional[int]) -> None:
        """Flow-controlled ingress: admission (overload policy) + WAL append
        ahead of delivery, then the vanilla dispatch semantics.

        The stream's flow lock is held from seq assignment through
        enqueue/delivery so WAL sequence order equals delivery order — a
        checkpoint watermark can then never cover a logged-but-undelivered
        lower seq (which recovery would skip, losing the event). Admission
        runs before the lock: BLOCK may sleep, and under the sync junction
        the lock order is root_lock → flow.lock everywhere."""
        chunk = False
        if isinstance(data, Event):
            rows, tss = [list(data.data)], [data.timestamp]
        elif data and isinstance(data[0], Event):
            rows = [list(ev.data) for ev in data]
            tss = [ev.timestamp for ev in data]
            chunk = True
        else:
            ts = timestamp if timestamp is not None \
                else self.app_context.current_time()
            rows, tss = [list(data)], [ts]
        for row in rows:
            self._check_arity(row)       # malformed rows must not hit the WAL
        if not self.flow.admit(len(rows)):
            # whole call shed by the gate; the ingress span records it
            return "shed"

        def build():
            events = [StreamEvent(ts, row, EventType.CURRENT)
                      for row, ts in zip(rows, tss)]
            seqs = self.flow.log(rows, tss)
            if seqs is not None:
                for ev, seq in zip(events, seqs):
                    ev.flow_seq = seq
            return events

        try:
            if self.junction.dispatcher is not None:
                with self.flow.lock:
                    events = build()
                    if chunk:
                        self.junction.send_events(events)
                    else:
                        self.junction.send_event(events[0])
                return
            with self.app_context.root_lock:
                with self.flow.lock:
                    events = build()
                    if chunk:
                        self.app_context.advance_time(
                            min(ev.timestamp for ev in events))
                        self.junction.send_events(events)
                        self.app_context.advance_time(
                            max(ev.timestamp for ev in events))
                    else:
                        self.app_context.advance_time(events[0].timestamp)
                        self.junction.send_event(events[0])
        finally:
            # the events are queued (depth_fn counts them) or delivery
            # failed: either way the admission reservation is done
            self.flow.release(len(rows))

    def send_rows(self, rows: list, timestamps) -> None:
        """Bulk ingress: one chunk of raw rows + per-row timestamps.

        The columnar fast path's preferred entry: the chunk reaches
        chunk-aware receivers (host/device bridges) as ONE micro-batch with
        no per-row ``Event`` wrapping. Semantics match a ``send`` of the
        equivalent ``Event`` list (watermark advances to the chunk minimum
        before delivery, to the maximum after)."""
        if not rows:
            return
        if len(rows) != len(timestamps):
            # zip would silently truncate on one path and desynchronize the
            # SoA stagers on the other — fail loudly instead
            raise ValueError(
                f"send_rows: {len(rows)} rows but {len(timestamps)} "
                f"timestamps")
        tracer = self.app_context.tracer
        if tracer is not None:
            # bulk ingress samples per CHUNK (one maybe_trace per call):
            # the columnar fast path must not pay per-row sampling checks
            tr = tracer.maybe_trace(self.stream_id)
            if tr is not None:
                t0 = time.perf_counter_ns()
                tracer.push(tr)
                try:
                    self._send_rows(rows, timestamps)
                finally:
                    tracer.pop()
                    tr.add_span("ingress", self.stream_id,
                                time.perf_counter_ns() - t0, len(rows))
                return
        self._send_rows(rows, timestamps)

    def _send_rows(self, rows: list, timestamps) -> None:
        if self.flow is not None and not self.flow.replaying:
            self._send([Event(ts, row) for row, ts in zip(rows, timestamps)])
            return
        arity = len(self.junction.definition.attributes)
        if any(len(r) != arity for r in rows):
            for row in rows:
                self._check_arity(row)         # raise with the full message
        if self.junction.rows_capable():
            # every subscriber is chunk-columnar: raw rows go straight into
            # the SoA stagers, no per-event StreamEvent materialization
            with self.app_context.root_lock:
                self.app_context.advance_time(min(timestamps))
                self.junction.deliver_rows(rows, timestamps)
                self.app_context.advance_time(max(timestamps))
            return
        events = [StreamEvent(ts, row, EventType.CURRENT)
                  for row, ts in zip(rows, timestamps)]
        if self.junction.dispatcher is not None:
            self.junction.send_events(events)
            return
        with self.app_context.root_lock:
            self.app_context.advance_time(
                min(ev.timestamp for ev in events))
            self.junction.send_events(events)
            self.app_context.advance_time(
                max(ev.timestamp for ev in events))

    def send_columns(self, cols: dict, timestamps=None,
                     count: Optional[int] = None) -> None:
        """Zero-object bulk ingress: one columnar chunk ({attribute name:
        numpy array | DictColumn}, optional int64 per-row timestamps).

        The preferred edge entry (columnar sources, the in-memory broker's
        rows chunks): when every subscriber is columns-capable the chunk
        reaches the SoA stagers with NO per-event Python objects at all;
        otherwise it degrades to the ``send_rows`` semantics. ``timestamps``
        None stamps the app's current time on every row."""
        from .columns import column_length
        n = count
        if n is None:
            n = int(len(timestamps)) if timestamps is not None else (
                column_length(next(iter(cols.values()))) if cols else 0)
        if n == 0:
            return
        names = self.junction.definition.attribute_names
        missing = [a for a in names if a not in cols]
        if missing:
            from .errors import SiddhiAppRuntimeError
            raise SiddhiAppRuntimeError(
                f"stream '{self.stream_id}': send_columns missing "
                f"column(s) {missing}")
        for name in names:
            if column_length(cols[name]) != n:
                raise ValueError(
                    f"send_columns: column '{name}' has "
                    f"{column_length(cols[name])} values but the chunk has "
                    f"{n} rows")
        if timestamps is None:
            ts = np.full(n, self.app_context.current_time(), dtype=np.int64)
        else:
            ts = np.asarray(timestamps, dtype=np.int64)
            if ts.shape[0] != n:
                raise ValueError(
                    f"send_columns: {n} rows but {ts.shape[0]} timestamps")
        tracer = self.app_context.tracer
        if tracer is not None:
            # chunk-level sampling, same policy as send_rows
            tr = tracer.maybe_trace(self.stream_id)
            if tr is not None:
                t0 = time.perf_counter_ns()
                tracer.push(tr)
                try:
                    self._send_columns(cols, ts, n)
                finally:
                    tracer.pop()
                    tr.add_span("ingress", self.stream_id,
                                time.perf_counter_ns() - t0, n)
                return
        self._send_columns(cols, ts, n)

    def _send_columns(self, cols: dict, ts: np.ndarray, n: int) -> None:
        j = self.junction
        if self.flow is None and j.dispatcher is None and \
                j.columns_capable():
            with self.app_context.root_lock:
                self.app_context.advance_time(int(ts.min()))
                j.deliver_columns(cols, ts, n)
                self.app_context.advance_time(int(ts.max()))
            return
        self._send_columns_fallback(cols, ts, n)

    def _send_columns_fallback(self, cols: dict, ts: np.ndarray,
                               n: int) -> None:
        """Non-columnar subscribers (or WAL/@async ingress): materialize
        rows once and take the ``send_rows`` path."""
        from .columns import columns_to_rows
        rows = columns_to_rows(cols, self.junction.definition.attribute_names,
                               n)
        self._send_rows(rows, ts.tolist())

    def _check_arity(self, data) -> None:
        defn = self.junction.definition
        if len(data) != len(defn.attributes):
            from .errors import SiddhiAppRuntimeError
            sig = ", ".join(f"{a.name} {a.type.value}" for a in defn.attributes)
            raise SiddhiAppRuntimeError(
                f"stream '{self.stream_id}' expects {len(defn.attributes)} "
                f"attributes ({sig}) but got {len(data)}: {data!r}")

    def _send_one(self, ts: int, data: list) -> None:
        self._check_arity(data)
        # watermark: advance clock & fire due timers before the event itself
        self.app_context.advance_time(ts)
        self.junction.send_event(StreamEvent(ts, data, EventType.CURRENT))


class StreamCallback:
    """Subscribe to a stream's output events (subclass or wrap a function)."""

    def __init__(self, fn: Optional[Callable[[list[Event]], None]] = None):
        self._fn = fn

    def receive(self, events: list[Event]) -> None:
        if self._fn:
            self._fn(events)

    # junction receiver adapter
    def receive_stream_event(self, event: StreamEvent) -> None:
        self.receive([Event(event.timestamp, event.data,
                            event.type == EventType.EXPIRED)])


class _StreamCallbackReceiver:
    """Adapts a StreamCallback to the junction receiver interface."""

    def __init__(self, callback: StreamCallback):
        self.callback = callback

    def receive(self, event: StreamEvent) -> None:
        if event.type in (EventType.CURRENT, EventType.EXPIRED):
            self.callback.receive_stream_event(event)


class RowsCallback:
    """Columns-capable stream subscription: ``fn(cols, ts, n)`` receives
    whole columnar chunks (zero per-event objects); per-event deliveries
    degrade to one synthesized chunk call. Subscribe via
    ``SiddhiAppRuntime.add_rows_callback``."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def receive_columns(self, cols: dict, ts, n: int) -> None:
        self._fn(cols, ts, n)

    def receive(self, event: StreamEvent) -> None:
        if event.type is not EventType.CURRENT:
            return
        names = getattr(self, "names", None) or [
            f"c{i}" for i in range(len(event.data))]
        cols = {nm: np.asarray([v], dtype=object)
                for nm, v in zip(names, event.data)}
        self._fn(cols, np.asarray([event.timestamp], np.int64), 1)


class QueryCallback:
    """Per-query callback: receive(timestamp, current_events, expired_events)."""

    def __init__(self, fn: Optional[Callable] = None):
        self._fn = fn

    def receive(self, timestamp: int, in_events: Optional[list[Event]],
                out_events: Optional[list[Event]]) -> None:
        if self._fn:
            self._fn(timestamp, in_events, out_events)
