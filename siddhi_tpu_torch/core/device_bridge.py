"""Device execution backend integration: per-query offload onto the card.

Port of the JAX package's ``core/device_bridge.py``: the compiled device path
plugs in as an execution backend for individual queries — the role the
reference reserves for its ``@Extension``/StreamProcessor plugin boundary.

Usage: annotate a query with ``@device`` (optionally ``@device(batch='4096')``).
The app builder tries the device compilers (``gpu/``: single-stream queries,
patterns and sequences, windowed stream joins); their steps launch the
hand-written kernels of ``csrc/`` on CUDA tensors and run the plain versions
on CPU tensors, on the engine's device (``SiddhiContext.device``). Events
route into a micro-batching bridge; device outputs flow back into the target
junction as CURRENT events. Batching semantics: outputs surface when a
micro-batch fills or on ``SiddhiAppRuntime.flush_device()`` (also invoked by
playback watermark advancement).

A query the compilers refuse is a refusal at build time: logged on the
``siddhi_tpu_torch.device`` logger with the compiler's reason, after which
the engine builds the query on the host interpreter
(``core/query_runtime.py``), as the reference does; under
``@device(strict='true')`` the ``DeviceCompileError`` itself raises. On the
card the query's kernel library is built and loaded then too: a failed
``nvcc`` or load raises ``DeviceCompileError`` whether or not the query is
strict, and is never a host fallback or a failed step.

Every bridge runtime is then wrapped by the app's resilience layer
(``resilience/device_guard.py``), as in the reference, unless
``@app:resilience(device.quarantine='false')``: a step that fails at
dispatch or at the fence replays its batch through the host interpreter at
the batch's own egress slot, and repeated failures quarantine the device
path until a cool-down probe re-promotes it. On the card only an injected
``ChaosFault`` replays so; any other failure of a step raises.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ..query_api import (
    InsertIntoStream,
    JoinInputStream,
    OutputEventsFor,
    Query,
    SingleInputStream,
    StateInputStream,
)
from ..query_api.annotation import find_annotation
from ..flow.adaptive_batch import AdaptiveFlushMixin
from .event import Event, EventType, StreamEvent

log = logging.getLogger("siddhi_tpu_torch.device")


class AsyncDeviceDriver:
    """Double-buffered async device pipeline: pack ∥ step ∥ emit.

    The analog of the reference's ``@async`` Disruptor mode for the device
    path (``StreamJunction.java:279-316``), rebuilt as a software pipeline.
    Three edges, one FIFO:

    - **pack** (producer, engine lock held): the junction thread packs events
      into the runtime's staging builder; emitted batches enter this driver's
      bounded ring (``depth``);
    - **dispatch** (worker): ``rt.dispatch(batch)`` enqueues the step's
      kernels on the CUDA stream and returns an UN-FENCED output token (the
      output tensors): a kernel launch returns while the card still
      computes, so dispatch is fire-and-forget;
    - **egress** (worker): ``rt.collect(token)`` fences (the decode's copy
      to the host is the only host sync on the path) and delivers rows
      under the engine lock.

    The runtime's state tensors are made on the producer's thread and
    stepped on the worker: the worker enqueues on the stream that was
    current on the producer's thread when the driver was built, so every
    step, copy and decode stays in one stream order.

    With ``window=2`` (double buffering) the worker keeps one dispatch in
    flight while fencing the previous token: the device computes batch N
    while the host decodes batch N−1 and the producer packs batch N+1.
    Tokens collect strictly FIFO, so a mid-pipeline device fault surfaces at
    its own egress slot — the DeviceGuard replays the failed batch's shadow
    there, after every earlier batch delivered, and can neither reorder nor
    double-emit a micro-batch. Without a guard
    (``device.quarantine='false'``), and on the card for a failure that is
    not an injected ``ChaosFault`` (the guard raises it and every later
    step of the query), the batch is logged as an ERROR and dropped
    (``batches_stepped`` still counts it).

    A latency-mode adaptive controller (``@app:adaptive(latency.target.ms)``)
    adds a **deadline flush**: when the pipeline idles with a partial batch
    staged longer than the controller's remaining latency budget, the worker
    flushes it — detection latency stays bounded by ~fill-wait + one step
    instead of waiting for capacity.
    """

    def __init__(self, rt, app_context, depth: int = 4, window: int = 2):
        import collections
        import threading
        self.rt = rt
        self.app_context = app_context
        self.depth = max(1, depth)
        # in-flight dispatch window: 2 = double buffering; runtimes whose
        # collect() reads live state (hopping drain) pin it to 1
        self.window = max(1, window) \
            if getattr(rt, "pipeline_safe", True) else 1
        self._q = collections.deque()            # packed, undispatched
        self._inflight = collections.deque()     # (batch, token, disp_s, err)
        self._cv = threading.Condition()
        self._busy = False          # dispatch/collect/delivery in flight
        self._paused = False
        self._stopped = False
        self.batches_stepped = 0
        self.deadline_flushes = 0
        self.step_seconds = 0.0          # cumulative dispatch+fence time
        self.pack_seconds = 0.0          # producer pack spans (from batches)
        self.busy_wall_seconds = 0.0     # wall the pipeline was processing
        self.starved_seconds = 0.0       # idle with a partial batch staging
        self._span_t0 = None
        # counter-check cadence under sustained load: on_drained normally
        # runs when the pipeline empties, but a saturated pipeline never
        # empties — force the bookkeeping every N collected batches (one
        # amortized fence per N steps) so overflow warnings still surface
        self.drain_check_every = 64
        self._since_drained = 0
        # the producer's CUDA stream: the worker enqueues on it
        dev = getattr(rt, "device", None)
        self._stream = None
        if dev is not None and dev.type == "cuda":
            import torch
            self._stream = torch.cuda.current_stream(dev)
        self._thread = threading.Thread(
            target=self._run, name="device-driver", daemon=True)
        self._thread.start()

    # -- producer side (engine lock held) ------------------------------------
    def submit(self, batch) -> None:
        from ..flow.backpressure import rlock_owned
        with self._cv:
            # backpressure without deadlock: a full queue waits briefly then
            # grows (bounded in practice by the wait). A producer holding
            # the engine lock (an InputHandler delivering) does not wait:
            # the worker's delivery needs that lock, so the wait could only
            # time out (``AsyncDispatcher.enqueue``'s rule)
            if len(self._q) >= self.depth \
                    and not rlock_owned(self.app_context.root_lock):
                self._cv.wait(timeout=0.2)
            self._q.append(batch)
            self._cv.notify_all()

    # -- introspection --------------------------------------------------------
    @property
    def pipeline_depth(self) -> int:
        """Batches in the driver: packed-but-undispatched + in flight."""
        return len(self._q) + len(self._inflight)

    def _wall_seconds(self) -> float:
        """Pipeline wall incl. the OPEN busy span — work counters grow per
        batch, so a gauge read mid-span (saturated pipelines may never
        drain) must see the matching wall or the ratios inflate unbounded."""
        wall = self.busy_wall_seconds + self.starved_seconds
        t0 = self._span_t0
        if t0 is not None:
            wall += max(0.0, time.perf_counter() - t0)
        return wall

    @property
    def overlap_efficiency(self) -> float:
        """(pack + step) work per unit of pipeline wall: 1.0 = serialized,
        2.0 = two equal phases perfectly hidden behind each other."""
        wall = self._wall_seconds()
        if wall <= 0.0:
            return 0.0
        return (self.pack_seconds + self.step_seconds) / wall

    @property
    def device_idle_frac(self) -> float:
        """Fraction of pipeline wall the device spent waiting on the host."""
        wall = self._wall_seconds()
        if wall <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.step_seconds / wall)

    # -- worker ---------------------------------------------------------------
    def _run(self) -> None:
        if self._stream is None:
            self._loop()
            return
        import torch
        with torch.cuda.stream(self._stream):
            self._loop()

    def _loop(self) -> None:
        while True:
            action, batch = self._next_action()
            if action == "stop":
                return
            if action == "dispatch":
                self._dispatch(batch)
            elif action == "collect":
                self._collect_oldest()
            elif action == "drained":
                self._run_drained_checks()
            else:                       # 'deadline'
                self._deadline_flush()

    def _run_drained_checks(self) -> None:
        """Deferred host-sync bookkeeping (counter checks read device scalars)
        — OUTSIDE the condition variable: producers blocked in submit()
        hold the engine lock, and a d2h fetch under _cv would freeze
        ingress for its whole round-trip."""
        self._since_drained = 0
        drained = getattr(self.rt, "on_drained", None)
        if drained is not None:
            try:
                drained()
            except Exception:   # noqa: BLE001 — bookkeeping must not kill
                # the sole device worker
                log.exception("on_drained failed")

    def _next_action(self):
        import time
        with self._cv:
            while True:
                if self._q and not self._paused \
                        and len(self._inflight) < self.window:
                    if self._span_t0 is None:
                        self._span_t0 = time.perf_counter()
                    self._busy = True
                    return "dispatch", self._q.popleft()
                if self._inflight:
                    # window full, paused, or queue empty: fence the oldest
                    # token (strict FIFO egress)
                    return "collect", None
                # pipeline drained: close the busy span, then idle-wait
                # (the drained bookkeeping runs in _run, outside this lock)
                if self._busy:
                    if self._span_t0 is not None:
                        self.busy_wall_seconds += \
                            time.perf_counter() - self._span_t0
                        self._span_t0 = None
                    self._busy = False
                    self._cv.notify_all()
                    return "drained", None
                if self._stopped:
                    return "stop", None
                wait_s = 0.5
                staging = self._builder_staging()
                if staging and not self._paused:
                    due_in = self._deadline_due_in_s()
                    if due_in is not None and due_in <= 0.0:
                        return "deadline", None
                    if due_in is not None:
                        wait_s = min(wait_s, max(due_in, 0.001))
                t0 = time.perf_counter()
                self._cv.wait(timeout=wait_s)
                if staging:
                    # the device sat idle while a partial batch staged — the
                    # starvation the overlap accounting must charge as wall
                    # (and, in latency mode, the deadline flush bounds)
                    self.starved_seconds += time.perf_counter() - t0

    def _builder_staging(self) -> bool:
        """Rows staged in the producer's builder while the worker idles —
        time spent here is device starvation, in any controller mode."""
        try:
            return len(self.rt.builder) > 0
        except Exception:   # noqa: BLE001 — advisory read without the lock
            return False

    def _deadline_ms(self):
        """Wall-clock flush deadline for partial batches, or None when no
        latency-mode controller is attached."""
        c = getattr(self.rt, "batch_controller", None)
        if c is None or getattr(c, "mode", "throughput") != "latency":
            return None
        if not self._builder_staging():
            return None
        return c.flush_deadline_ms

    def _deadline_due_in_s(self):
        deadline_ms = self._deadline_ms()
        if deadline_ms is None:
            return None
        t0 = getattr(self.rt.builder, "_pack_t0", None)
        if t0 is None:
            return None
        return deadline_ms / 1e3 - (time.perf_counter() - t0)

    def _deadline_flush(self) -> None:
        """Flush a partial batch whose staging age exceeded the latency
        budget (worker thread, takes the engine lock like any producer)."""
        with self.app_context.root_lock:
            due = self._deadline_due_in_s()
            if due is None or due > 0.0:
                return      # raced with a producer flush — nothing to do
            self.rt._count_flush("deadline")
            self.deadline_flushes += 1
            # the runtime's own flush: seal + emit + driver submit, so the
            # deadline path can never diverge from producer-side flushes
            self.rt.flush()

    def _dispatch(self, batch) -> None:
        import time
        self.pack_seconds += float(batch.get("pack_s", 0.0) or 0.0)
        t0 = time.perf_counter()
        err = None
        token = None
        try:
            token = self.rt.dispatch(batch)
        except Exception as e:  # noqa: BLE001 — without a DeviceGuard
            # installed, or a fault the guard does not replay on the card,
            # a dispatch failure must not kill the worker; the batch is
            # consumed (counted at its egress slot)
            log.exception("device dispatch failed")
            err = e
        disp_s = time.perf_counter() - t0
        with self._cv:
            self._inflight.append((batch, token, t0, disp_s, err))
            self._cv.notify_all()

    def _collect_oldest(self) -> None:
        import time
        with self._cv:
            batch, token, t_disp0, disp_s, err = self._inflight.popleft()
        t0 = time.perf_counter()
        rows = []
        ok = False
        try:
            if err is None:
                rows = self.rt.collect(token)
                ok = True
        except Exception:   # noqa: BLE001 — an async-dispatched step's
            # failure surfaces at the fence; the DeviceGuard has rerouted
            # the batch to the host path unless it is off, or the fault is
            # one it does not replay on the card
            log.exception("device step failed")
            rows = []
        fence_s = time.perf_counter() - t0
        dt = disp_s + fence_s
        self.step_seconds += dt
        self.batches_stepped += 1
        publish_s = 0.0
        if rows:
            tp0 = time.perf_counter()
            try:
                with self.app_context.root_lock:
                    # stamp outputs with the batch's own last event time —
                    # the producer-side _out_ts has already advanced to
                    # newer events by delivery time
                    self.rt.deliver(rows, batch.get("last_ts"))
            except Exception:   # noqa: BLE001 — a raising downstream
                # receiver must not kill the sole device worker, and the
                # probe below must still see this batch (FIFO trace groups)
                log.exception("device delivery failed")
            publish_s = time.perf_counter() - tp0
        try:
            # the probe must see EVERY consumed batch (success or not) or
            # its FIFO trace groups desynchronize; observed AFTER delivery
            # so the phase attribution covers the whole serial waterfall
            # (fill → pack → ring wait → dispatch → fence → publish)
            observe = getattr(self.rt, "observe_step", None)
            if observe is not None:
                t_emit = batch.get("_t_emit")
                queue_s = max(0.0, t_disp0 - t_emit) \
                    if t_emit is not None else 0.0
                queue_s += max(0.0, t0 - (t_disp0 + disp_s))
                observe(batch.get("count", 0), dt, device_path=ok, phases={
                    "fill_span_s": batch.get("pack_s", 0.0),
                    "pack_s": batch.get("pack_exec_s", 0.0),
                    "queue_s": queue_s,
                    "step_s": disp_s,
                    "fence_s": fence_s,
                    "publish_s": publish_s,
                    "cause": batch.get("_cause"),
                })
        except Exception:   # noqa: BLE001 — a raising observer must not
            # kill the sole device worker
            log.exception("step observer failed")
        self._since_drained += 1
        if self._since_drained >= self.drain_check_every:
            # sustained load never drains the pipeline: run the overflow
            # checks anyway (costs one fence per drain_check_every steps)
            self._run_drained_checks()
        with self._cv:
            self._cv.notify_all()

    # -- barriers --------------------------------------------------------------
    def quiesce(self, timeout: float = 60.0) -> bool:
        """Wait until the ring is empty and no dispatch, fence, or delivery
        is in flight. Must NOT be called while holding the engine lock (the
        worker's egress edge needs it)."""
        import time
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._q or self._inflight or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=min(remaining, 0.5))
        return True

    def snapshot_staged(self) -> list:
        """Queued-but-unstepped batches (numpy dicts) for checkpointing the
        receive-but-not-process gap. Call with the driver paused."""
        with self._cv:
            return list(self._q)

    def restore_staged(self, batches: list) -> None:
        with self._cv:
            self._q.clear()
            self._q.extend(batches)
            self._cv.notify_all()

    def flush_sync(self, cause=None) -> None:
        """Submit any partial batch and drain: device state reflects every
        event sent so far. Call without the engine lock. ``cause`` counts
        the flush and stamps the batch UNDER the lock — cause bookkeeping
        is single-slot, so it must not race producer-side flushes."""
        with self.app_context.root_lock:
            if len(self.rt.builder):
                if cause is not None:
                    self.rt._count_flush(cause)
                self.rt._seal()     # trace group closes WITH the emit,
                # under the lock producers pack under
                b = self.rt.builder.emit()
                b["_cause"] = self.rt._take_cause()
                self.submit(b)
        self.quiesce()

    def pause(self) -> None:
        """Freeze device-state mutation (snapshot walks read ``rt.state``).
        Waits for the whole in-flight cycle — step AND delivery — so a
        snapshot can't capture device state advanced past rows downstream
        hasn't seen. Must not be called holding the engine lock."""
        with self._cv:
            self._paused = True
            while self._busy:
                self._cv.wait(timeout=0.5)

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._paused = False
            self._cv.notify_all()
        self._thread.join(timeout=10.0)


class _DeviceRTBase(AdaptiveFlushMixin):
    """Shared packing→step dispatch for bridge runtimes: a full builder is
    either handed to the async driver (packing overlaps compute) or stepped
    synchronously.

    The step is two-phase: ``dispatch(batch)`` enqueues the step without
    fencing and returns its output tensors; ``collect(token)`` fences at the
    egress edge (the decode's copy to the host) and returns rows.
    ``process`` is one dispatch immediately collected — the synchronous
    path, and the shape the DeviceGuard wraps on both phases. Host-sync
    bookkeeping that would stall the pipeline (counter checks read device
    scalars) lives in ``on_drained``, which the driver calls whenever the
    pipeline empties and the sync path calls after every flush."""

    driver = None
    callback = None
    pipeline_safe = True    # False → the driver pins the window to 1

    def add_callback(self, fn):
        self.callback = fn

    def dispatch(self, batch):
        """Fire-and-forget device step: advances ``self.state`` and returns
        the un-fenced output tensors as the egress token."""
        self.state, out = self.compiled.step(self.state, batch)
        return out

    def collect(self, out):
        """Egress fence + decode for one dispatched step."""
        return self.compiled.decode_outputs(out)

    def process(self, batch):
        """Synchronous step + decode (async: worker thread, no engine lock —
        device state is worker-owned)."""
        return self.collect(self.dispatch(batch))

    def on_drained(self):
        """Called when the pipeline empties — the safe point for host-sync
        bookkeeping (device reads with nothing in flight)."""

    def deliver(self, rows, emit_ts=None):
        fn = self.callback
        if fn and rows:
            if getattr(getattr(fn, "__self__", None),
                       "_on_rows_accepts_ts", False):
                fn(rows, emit_ts)
            else:           # plain user callback: rows only
                fn(rows)

    def flush(self):
        if len(self.builder) == 0:
            return
        self._seal()            # trace group closes exactly at the emit
        b = self.builder.emit()
        b["_cause"] = self._take_cause()    # phase attribution keys the
        # deadline-queueing share off the flush cause riding the batch
        if self.driver is not None:
            self.driver.submit(b)
            return
        self.deliver(self._timed_process(b), b.get("last_ts"))
        self.on_drained()

    def finalize(self):
        """Terminal flush at shutdown (kernels that hold an open segment
        override this via the runtime's ``finalize``)."""


class _LimiterSink:
    """Terminal processor behind the bridge's host-side rate limiter."""

    def __init__(self, bridge: "DeviceQueryBridge"):
        self.bridge = bridge

    def process(self, events: list[StreamEvent]) -> None:
        self.bridge._emit(events)


class DeviceQueryBridge:
    """Junction subscriber feeding a compiled device query; outputs re-enter the
    engine through the query's output junction.

    Output rate limiting (``output [all|first|last] every ...`` /
    ``output snapshot``) runs host-side on the decoded device rows — the
    limiters are sequential post-selector processors in the reference
    (``query/output/ratelimit/OutputRateLimiter.java:43``) and their
    semantics don't depend on chunking, so the same host classes apply
    verbatim after device decode. Device-emitted events carry the batch
    timestamp, so time-driven limiters key off that (documented divergence
    from per-event host timestamps, consistent with the device path's
    output stamping)."""

    def __init__(self, kind: str, runtime, app_context, stream_ids: list[str],
                 output_junction, query_name: str, async_mode: bool = False,
                 output_rate=None, pipeline_window: int = 2):
        self.kind = kind                  # 'stream' | 'nfa' | 'join'
        self.runtime = runtime            # DeviceStreamRuntime | DeviceNFARuntime
        self.app_context = app_context
        self.stream_ids = stream_ids
        self.output_junction = output_junction
        self.query_name = query_name
        self.query_callbacks: list = []
        self.guard = None                   # DeviceGuard (resilience layer)
        self.probe = None                   # no observability probe yet
        self._on_rows_accepts_ts = True     # deliver() passes the batch ts
        runtime.add_callback(self._on_rows)
        self._out_ts = 0
        self.rate_limiter = None
        if output_rate is not None:
            from .ratelimit import build_rate_limiter
            self.rate_limiter = build_rate_limiter(output_rate, app_context)
            self.rate_limiter.next = _LimiterSink(self)
        self.driver = None
        if async_mode:
            self.driver = AsyncDeviceDriver(runtime, app_context,
                                            window=pipeline_window)
            runtime.driver = self.driver

    # -- junction receiver(s) -------------------------------------------------
    def receiver_for(self, stream_id: str):
        bridge = self

        class _R:
            def receive(self, event: StreamEvent) -> None:
                bridge.on_event(stream_id, event)

        if self.kind == "stream" and hasattr(self.runtime, "send_columns"):
            # single-stream device queries take columnar chunks straight
            # into the staging BatchBuilder (append_columns — bulk
            # slice-copy, no per-event appends): the last per-event hop on
            # the DCN-ingest → device path the mesh fabric forwards over.
            # Merged (nfa/join) builders stay per-event by design — their
            # probe/trace FIFO is stamped per interleaved stream event.
            class _ColsR(_R):
                def receive_rows(self, rows: list, timestamps) -> None:
                    bridge.on_rows_chunk(stream_id, rows, timestamps)

                def receive_columns(self, cols: dict, ts, n: int) -> None:
                    bridge.on_columns_chunk(stream_id, cols, ts, n)

            return _ColsR()
        return _R()

    def on_event(self, stream_id: str, event: StreamEvent) -> None:
        if event.type != EventType.CURRENT:
            return
        probe = self.probe
        if probe is not None and probe.tracer is not None:
            # register BEFORE packing: a capacity flush inside send() steps
            # the batch this event is part of, closing the span right away
            tr = probe.tracer.active
            if tr is not None:
                probe.pending.append((tr, time.perf_counter_ns()))
        self._out_ts = event.timestamp
        if self.kind == "stream":
            self.runtime.send(event.data, timestamp=event.timestamp)
        else:                       # 'nfa' | 'join': merged multi-stream batch
            self.runtime.send(stream_id, event.data, event.timestamp)

    def _register_chunk_trace(self) -> None:
        """One pending probe-trace entry per CHUNK (the fleet stager's
        convention) — a chunk's events share one journey, and per-event
        registration is exactly the hop this path exists to remove."""
        probe = self.probe
        if probe is not None and probe.tracer is not None:
            tr = probe.tracer.active
            if tr is not None:
                probe.pending.append((tr, time.perf_counter_ns()))

    def on_rows_chunk(self, stream_id: str, rows: list, timestamps) -> None:
        """Zero-wrap row-chunk ingress (``deliver_rows``): no StreamEvent
        materialization, one trace registration per chunk."""
        self._register_chunk_trace()
        send = self.runtime.send
        for row, ts in zip(rows, timestamps):
            send(row, timestamp=ts)
        if timestamps:
            self._out_ts = timestamps[-1]

    def on_columns_chunk(self, stream_id: str, cols: dict, ts,
                         n: int) -> None:
        """Zero-object columnar ingress (``deliver_columns``): the chunk
        bulk-slice-copies into the staging builder via
        ``BatchBuilder.append_columns`` — no per-event appends at all."""
        if n == 0:
            return
        self._register_chunk_trace()
        self.runtime.send_columns(cols, ts)
        self._out_ts = int(ts[-1])

    def flush(self, cause: str = "drain") -> None:
        if self.driver is not None:
            # async: submit the partial batch and drain the device queue.
            # Must not hold the engine lock here (the worker's delivery
            # needs it); the cause is counted inside flush_sync UNDER the
            # lock so concurrent producer/deadline flushes can't swap the
            # single-slot pending cause
            self.driver.flush_sync(cause)
            return
        with self.app_context.root_lock:
            if len(self.runtime.builder):
                self.runtime._count_flush(cause)
            self.runtime.flush()

    def finalize(self) -> None:
        """Shutdown barrier: emit what an open device segment still holds
        (timeBatch terminal bucket)."""
        self.flush(cause="final")
        fin = getattr(self.runtime, "finalize", None)
        if fin is not None:
            fin()
        if self.driver is not None:
            self.driver.flush_sync()

    def _on_rows(self, rows: list[list], emit_ts=None) -> None:
        # async delivery passes the source batch's last event time; the
        # producer-side _out_ts may already have advanced past it
        ts = self._out_ts if emit_ts is None else emit_ts
        events = [StreamEvent(ts, row, EventType.CURRENT) for row in rows]
        if self.rate_limiter is not None:
            self.rate_limiter.process(events)   # → _LimiterSink → _emit
        else:
            self._emit(events)

    def _emit(self, events: list[StreamEvent]) -> None:
        if not events:
            return
        if self.query_callbacks:
            ts = events[-1].timestamp
            evs = [Event(e.timestamp, e.data) for e in events]
            for cb in self.query_callbacks:
                cb.receive(ts, evs, None)
        if self.output_junction is None:
            return
        for e in events:
            self.output_junction.send_event(e)


def _input_single_streams(ist) -> list[SingleInputStream]:
    """Every SingleInputStream reachable from a query input (join sides,
    pattern/sequence stream elements) — for whole-surface audits."""
    out: list[SingleInputStream] = []
    if isinstance(ist, SingleInputStream):
        out.append(ist)
    elif isinstance(ist, JoinInputStream):
        out.extend([ist.left, ist.right])
    elif isinstance(ist, StateInputStream):
        out.extend(ist.single_streams())
    return out


def try_build_device_query(query: Query, app_context, stream_defs: dict,
                           get_junction, name: str) -> Optional[DeviceQueryBridge]:
    """Returns a bridge when the query opts in via @device AND compiles on the
    device path; None when it carries no ``@device``, or when the device
    compilers refuse it: that refusal is logged on
    ``siddhi_tpu_torch.device`` with the compiler's reason and the engine
    builds the query on the host interpreter, as in the reference. Under
    ``@device(strict='true')`` the refusal raises ``DeviceCompileError``.
    On the card a kernel library that fails to build or load raises its
    ``KernelLibraryError`` (a ``DeviceCompileError``), strict or not."""
    ann = find_annotation(query.annotations, "device")
    if ann is None:
        return None
    strict = (ann.get("strict") or "false").lower() == "true"
    batch = int(ann.get("batch") or 1024)
    slots = int(ann.get("slots") or 64)
    window_cap = int(ann.get("window") or 4096)
    # in-flight dispatch window of the async pipeline (2 = double
    # buffering; 1 = serialize dispatch/egress, for A/B comparison)
    pipeline_window = int(ann.get("pipeline") or 2)

    def _input_stream_ids(ist) -> list[str]:
        if isinstance(ist, SingleInputStream):
            return [ist.stream_id]
        if isinstance(ist, StateInputStream):
            return ist.stream_ids()
        if isinstance(ist, JoinInputStream):
            out = []
            for side in (ist.left, ist.right):
                sid = getattr(side, "stream_id", None)
                if sid is not None:
                    out.append(sid)
            return out
        return []

    # async packing/compute overlap: explicit @device(async='true'), or any
    # input stream annotated @async (the reference's Disruptor opt-in)
    async_mode = (ann.get("async") or "false").lower() == "true"
    if not async_mode:
        for sid in _input_stream_ids(query.input_stream):
            d = stream_defs.get(sid)
            if d is not None and \
                    find_annotation(d.annotations, "async") is not None:
                async_mode = True
                break

    from ..gpu.expr_compile import DeviceCompileError, KernelLibraryError

    device = app_context.siddhi_context.device

    target = None
    try:
        # ---- full Query-surface audit: anything the device compilers do not
        # model must raise DeviceCompileError here, never
        # silently drop semantics (reference surface: Query.java — selector
        # order-by/limit/offset QuerySelector.java:44, output_rate
        # OutputRateLimiter.java:43, fault/inner streams, events_for).
        sel = query.selector
        if sel is not None and (sel.order_by or sel.limit is not None
                                or sel.offset is not None):
            raise DeviceCompileError(
                "order by / limit / offset take the host path (device "
                "micro-batch chunking would change their per-chunk "
                "semantics)")
        if query.output_rate is not None:
            from ..query_api import EventOutputRate
            if not isinstance(query.output_rate, EventOutputRate):
                # time/snapshot limiters key off per-event output timestamps,
                # which device batching coarsens to the batch timestamp —
                # host fallback preserves exact semantics
                raise DeviceCompileError(
                    "time/snapshot output rate limiting takes the host path")
            if isinstance(query.input_stream, JoinInputStream):
                # host join selectors can feed EXPIRED events into the
                # limiter; the device join emits CURRENT rows only
                raise DeviceCompileError(
                    "output rate limiting on joins takes the host path")
            from ..query_api import OutputRateType
            if sel is not None and sel.group_by and \
                    query.output_rate.type in (OutputRateType.FIRST,
                                               OutputRateType.LAST):
                # grouped first/last emit PER KEY per batch (reference
                # FirstGroupByPerEventOutputRateLimiter); device rows do
                # not carry group keys through the limiter
                raise DeviceCompileError(
                    "group-by with first/last output rate limiting takes "
                    "the host path")
        if not isinstance(query.output_stream, InsertIntoStream):
            raise DeviceCompileError(
                "device path handles insert-into-stream outputs only")
        if query.output_stream.events_for != OutputEventsFor.CURRENT_EVENTS:
            raise DeviceCompileError(
                "insert into ... for expired/all events takes the host path "
                "(device kernels emit CURRENT rows only)")
        if query.output_stream.is_fault_stream:
            raise DeviceCompileError("fault-stream outputs take the host path")
        for s in _input_single_streams(query.input_stream):
            if s.is_fault_stream or s.is_inner_stream:
                raise DeviceCompileError(
                    "fault / partition-inner input streams take the host "
                    "path")
        tid = query.output_stream.target_id
        if tid in app_context.tables or tid in app_context.named_windows:
            raise DeviceCompileError(
                f"device path cannot target table/window '{tid}'")
        target = get_junction(tid, query.output_stream.is_inner_stream)
        ist = query.input_stream
        if isinstance(ist, SingleInputStream):
            from ..gpu.batch import BatchBuilder
            from ..gpu.query_compile import CompiledStreamQuery

            d = stream_defs.get(ist.stream_id)
            if d is None:
                raise DeviceCompileError(f"undefined stream '{ist.stream_id}'")
            compiled = CompiledStreamQuery(query, d, batch_capacity=batch,
                                           window_capacity=window_cap,
                                           device=device)
            if query.output_rate is not None and \
                    compiled.window_kind is not None:
                # host rate limiters count the window's EXPIRED events too
                # (selector → limiter → events_for filter); device kernels
                # emit CURRENT rows only, so the counts would diverge
                raise DeviceCompileError(
                    "output rate limiting on windowed queries takes the "
                    "host path")
            _load_kernel_library(compiled.plan, compiled.device)

            class _StreamRT(_DeviceRTBase):
                def __init__(self):
                    self.compiled = compiled
                    self.device = compiled.device
                    self.builder = BatchBuilder(compiled.schema, batch)
                    # drain steps run on the WORKER thread in async mode —
                    # they must not touch the producer's live builder
                    self._drain_builder = BatchBuilder(compiled.schema,
                                                       batch)
                    # hopping's collect() reads live state between steps:
                    # the driver pins its dispatch window to 1
                    self.pipeline_safe = compiled.window_kind != "hopping"
                    self.state = compiled.init_state()
                    # segment clock high-water: arrival ts, or the
                    # externalTimeBatch attribute column
                    self._tk_pos = (
                        d.attribute_position(compiled.time_key)
                        if compiled.time_key is not None else None)
                    self._last_clk = None

                def send(self, row, timestamp=0):
                    clk = timestamp if self._tk_pos is None \
                        else row[self._tk_pos]
                    if clk is not None:
                        self._last_clk = clk if self._last_clk is None \
                            else max(self._last_clk, clk)
                    self.builder.append(row, timestamp)
                    self._maybe_flush()

                def send_columns(self, cols, ts):
                    """Bulk columnar staging: the chunk slice-copies into
                    the builder (``append_columns``) across as many
                    micro-batches as it spans — flush causes and adaptive
                    thresholds behave exactly as per-event ``send``."""
                    import numpy as np
                    ts = np.asarray(ts, dtype=np.int64)
                    n = int(ts.shape[0])
                    if n == 0:
                        return
                    clk_col = ts if self._tk_pos is None else np.asarray(
                        cols[compiled.time_key].materialize()
                        if hasattr(cols[compiled.time_key], "materialize")
                        else cols[compiled.time_key])
                    try:
                        clk = clk_col.max()
                    except TypeError:    # object column with None values
                        vals = [v for v in clk_col if v is not None]
                        clk = max(vals) if vals else None
                    if clk is not None:
                        self._last_clk = clk if self._last_clk is None \
                            else max(self._last_clk, clk)
                    start = 0
                    while start < n:
                        take = self.builder.append_columns(cols, ts, start)
                        start += take
                        self._maybe_flush()
                        if take == 0 and len(self.builder):
                            # defensive: a full builder _maybe_flush did
                            # not drain (no controller, capacity race)
                            self.flush()

                def finalize(self):
                    """Force-close the open timeBatch bucket at shutdown: a
                    sentinel event two windows past the last segment-clock
                    value closes the terminal bucket the way the host's
                    boundary timer does (streams that stop sending must not
                    lose their last bucket). For
                    externalTimeBatch the sentinel carries the far-future
                    value in the time ATTRIBUTE (the kernel's clock). The
                    sentinel lands in its own far-future segment and never
                    emits. Sessions need no terminal flush on this path:
                    currents pass through per arrival."""
                    if self.compiled.window_kind != "timeBatch" or \
                            self._last_clk is None:
                        return
                    self.flush()
                    sentinel = self._last_clk + \
                        2 * max(int(self.compiled.window_ms), 1)
                    row = [None] * len(self.compiled.schema.names)
                    if self._tk_pos is not None:
                        row[self._tk_pos] = sentinel
                    # a guarded builder excludes the sentinel from its
                    # host-fallback shadow (it is bookkeeping, not an event)
                    append = getattr(self.builder, "append_sentinel",
                                     self.builder.append)
                    append(row, sentinel)
                    self.flush()

                def collect(self, out):
                    """Egress fence + decode. Hopping drains deferred
                    boundary flushes here with empty steps — the runtime is
                    pipeline-unsafe, so the state read is this step's own."""
                    rows = self.compiled.decode_outputs(out)
                    if self.compiled.window_kind == "hopping":
                        from ..gpu.runtime import drain_hop_boundaries
                        self.state = drain_hop_boundaries(
                            self.compiled, self.state, self._drain_builder,
                            lambda o: rows.extend(
                                self.compiled.decode_outputs(o)))
                    return rows

                def on_drained(self):
                    # counter checks read device state scalars — deferred to
                    # drain points so they never stall the pipeline
                    self._check_counters()

                def _check_counters(self):
                    # surface bounded-state overflow instead of silently
                    # diverging from the host semantics
                    for key, what in (("window_drops", "alive events evicted "
                                       "(raise @device(window='N'))"),
                                      ("ts_regressions", "out-of-order "
                                       "timestamps clamped"),
                                      ("group_collisions", "group-by keys "
                                       "collided in the dense table (raise "
                                       "@device key capacity)")):
                        c = self.state.get(key)
                        if c is None:
                            continue
                        c = int(c)
                        if c > getattr(self, f"_warned_{key}", 0):
                            log.warning("query '%s': %d %s", name, c, what)
                            setattr(self, f"_warned_{key}", c)

                def snapshot_state(self):
                    from ..gpu.batch import device_state_snapshot
                    return device_state_snapshot(self.state,
                                                 self.compiled.schema)

                def restore_state(self, st):
                    from ..gpu.batch import device_state_restore
                    from ..gpu.state_io import query_state_from_numpy
                    self.state = device_state_restore(
                        st, self.compiled.schema,
                        lambda tree: query_state_from_numpy(
                            self.compiled, tree, self.device))

            rt = _StreamRT()
            bridge = DeviceQueryBridge("stream", rt, app_context,
                                       [ist.stream_id], target, name,
                                       async_mode=async_mode,
                                       output_rate=query.output_rate,
                                       pipeline_window=pipeline_window)
            bridge.output_schema = ([s.name for s in compiled.specs],
                                    [s.dtype for s in compiled.specs])
        elif isinstance(ist, StateInputStream):
            from ..gpu.nfa import DeviceNFACompiler, DeviceNFARuntime, MergedBatchBuilder

            compiler = DeviceNFACompiler(query, stream_defs, slots, batch,
                                         device=device)
            _load_kernel_library(compiler.plan, compiler.device)

            class _NFART(DeviceNFARuntime):
                def __init__(self):
                    self.compiler = compiler
                    self.device = compiler.device
                    self.builder = MergedBatchBuilder(
                        compiler.merged, batch, stream_defs,
                        used_cols=compiler.used_cols)
                    # absent-start seeds arm their clock at the app's start
                    # time (host: seed placed at start() on the playback
                    # clock); one lane
                    self.state = compiler.init_state(
                        1, app_context.current_time())
                    self.callback = None
                    self.driver = None

            rt = _NFART()
            bridge = DeviceQueryBridge("nfa", rt, app_context,
                                       compiler.compiled.stream_ids, target,
                                       name, async_mode=async_mode,
                                       output_rate=query.output_rate,
                                       pipeline_window=pipeline_window)
            bridge.output_schema = ([n for n, _, _ in compiler.out_specs],
                                    [t for _, _, t in compiler.out_specs])
        elif isinstance(ist, JoinInputStream):
            from ..gpu.join_compile import CompiledJoinQuery
            from ..gpu.nfa import MergedBatchBuilder

            ring = int(ann.get("ring") or 1024)
            joined = int(ann.get("joined") or 2048)
            compiled = CompiledJoinQuery(
                query, dict(stream_defs), batch_capacity=batch,
                ring_capacity=ring, joined_capacity=joined, device=device)
            _load_kernel_library(compiled.plan, compiled.device)

            class _JoinRT(_DeviceRTBase):
                def __init__(self):
                    self.compiled = compiled
                    self.device = compiled.device
                    self.builder = MergedBatchBuilder(
                        compiled.merged, batch, dict(stream_defs))
                    self.state = compiled.init_state()
                    self._warned_drops = 0

                def send(self, stream_id, row, timestamp=0):
                    self.builder.append(stream_id, row, timestamp)
                    self._maybe_flush()

                def on_drained(self):
                    # drop counters live in device state: check at drain
                    # points (a device read would stall the pipeline
                    # per step)
                    drops = int(self.state["join_drops"]) + \
                        int(self.state["ring_drops"])
                    if drops > self._warned_drops:
                        log.warning(
                            "query '%s': %d joined rows/ring entries dropped "
                            "(raise @device(joined=/ring=))", name, drops)
                        self._warned_drops = drops

                def snapshot_state(self):
                    from ..gpu.batch import device_state_snapshot
                    return device_state_snapshot(self.state,
                                                 self.compiled.merged)

                def restore_state(self, st):
                    from ..gpu.batch import device_state_restore
                    from ..gpu.state_io import join_state_from_numpy
                    self.state = device_state_restore(
                        st, self.compiled.merged,
                        lambda tree: join_state_from_numpy(
                            self.compiled, tree, self.device))

            rt = _JoinRT()
            bridge = DeviceQueryBridge(
                "join", rt, app_context,
                [compiled.left_id, compiled.right_id], target, name,
                async_mode=async_mode, output_rate=query.output_rate,
                pipeline_window=pipeline_window)
            bridge.output_schema = ([o.name for o in compiled.out_specs],
                                    [o.dtype for o in compiled.out_specs])
        else:
            raise DeviceCompileError(
                "device path covers single-stream, pattern/sequence, and "
                "windowed stream-join inputs")
    except DeviceCompileError as e:
        # a kernel library that failed to build or load on the card raises
        # whether or not the query is strict: the host path would hide it
        if strict or isinstance(e, KernelLibraryError):
            raise
        log.info("query '%s' falls back to host path: %s", name, e)
        return None

    if app_context.adaptive_cfg is not None:
        # @app:adaptive: flush thresholds track observed rate/latency; the
        # query's own batch capacity caps the adjustable range
        from ..flow.adaptive_batch import AdaptiveBatchController
        cfg = dict(app_context.adaptive_cfg)
        cfg["max_batch"] = min(cfg.get("max_batch", batch), batch)
        cfg["min_batch"] = min(cfg.get("min_batch", 64), cfg["max_batch"])
        rt.batch_controller = AdaptiveBatchController(**cfg)
    bridge.batch_capacity = batch       # pad-ratio denominator (observability)
    app_context.register_state(f"device-{name}", _BridgeState(bridge))
    # device quarantine: a RUNTIME step failure (compile-time refusals fell
    # back above, a kernel library that failed to build or load raised)
    # reroutes the batch through the host interpreter, and repeated
    # failures circuit-break the device path itself
    resilience = getattr(app_context.runtime, "resilience", None)
    if resilience is not None:
        bridge.guard = resilience.guard_device(
            rt, query, name, dict(stream_defs), get_junction, bridge.kind)
        resilience.bind_bridge(bridge.guard, bridge)
    return bridge


def _load_kernel_library(plan, device) -> None:
    """On a CUDA device, builds (``nvcc``) and loads the kernel library of
    ``plan`` now, while the query is built, before its bridge starts (and
    runs the plan's ``prepare``, where it has one): a
    failure raises ``KernelLibraryError`` from ``try_build_device_query``,
    strict or not, and the app does not build. Falling back to the host
    interpreter would hide the kernel, and so would loading it lazily at
    the first step: the DeviceGuard would replay that failure on the host
    batch after batch."""
    if device.type != "cuda":
        return
    from ..gpu.expr_compile import KernelLibraryError
    try:
        plan._lib()
    except Exception as e:  # noqa: BLE001 — nvcc, dlopen and the layout
        # checks raise RuntimeError or OSError; any of them fails the build
        raise KernelLibraryError(
            f"the kernel library of {type(plan).__name__} did not build or "
            f"load: {e}") from e
    prepare = getattr(plan, "prepare", None)
    if prepare is not None:
        prepare(device)


class _BridgeState:
    """Snapshot adapter: the device state tensors are fetched to numpy."""

    def __init__(self, bridge: DeviceQueryBridge):
        self.bridge = bridge

    def snapshot_state(self):
        limiter = self.bridge.rate_limiter
        if self.bridge.driver is None:
            self.bridge.flush()
            st = self.bridge.runtime.snapshot_state()
            if limiter is None:
                return st
            return {"rt": st, "limiter": limiter.snapshot_state()}
        # async mode: SiddhiAppRuntime._pre_snapshot already flushed + paused
        # the driver (flushing here would deadlock — we hold root_lock and
        # the worker's delivery phase needs it). Events that raced in between
        # the pre-drain and this lock acquisition sit in the builder / driver
        # queue — checkpoint them as staged batches so the cut is consistent
        # with the host-side state walked under the same lock.
        st = {
            "rt": self.bridge.runtime.snapshot_state(),
            "staged": self.bridge.driver.snapshot_staged(),
            "builder": self.bridge.runtime.builder.snapshot(),
        }
        if limiter is not None:
            st["limiter"] = limiter.snapshot_state()
        return st

    def restore_state(self, state):
        if isinstance(state, dict) and "rt" in state:
            if self.bridge.rate_limiter is not None and "limiter" in state:
                self.bridge.rate_limiter.restore_state(state["limiter"])
            if "staged" not in state:       # sync-mode shape with a limiter
                self.bridge.runtime.restore_state(state["rt"])
                return
            # async-mode snapshot shape — also restorable into a runtime
            # whose async opt-in was removed: staged batches are stepped
            # synchronously instead of re-queued
            self.bridge.runtime.restore_state(state["rt"])
            self.bridge.runtime.builder.restore(state["builder"])
            if self.bridge.driver is not None:
                self.bridge.driver.restore_staged(state["staged"])
            else:
                rt = self.bridge.runtime
                for batch in state["staged"]:
                    rt.deliver(rt.process(batch), batch.get("last_ts"))
            return
        self.bridge.runtime.restore_state(state)
