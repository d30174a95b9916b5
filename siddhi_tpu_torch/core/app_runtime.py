"""SiddhiAppRuntime: build + lifecycle for one app, on three tiers.

Port of the JAX package's ``core/app_runtime.py`` (reference
``core/SiddhiAppRuntime.java`` / ``SiddhiAppRuntimeImpl.java``: start:449,
shutdown:552, persist:686, query:309; ``util/parser/SiddhiAppParser``). It
builds definitions, junctions (``@async``, ``@OnError``), tables, script
functions, named windows, triggers, ``define aggregation``
(``core/aggregation.py``, ``@device`` included), then the queries and
partitions in definition order, each on the first tier that takes it, as in
the reference: a ``@device`` query that the device compilers take steps on
the engine's device (``core/device_bridge.py``, ``SiddhiContext.device``);
under ``@app:host_batch`` (or a query's ``@host_batch``) a query whose plan
lowers in the compilers' host form, and a partition of blocked patterns,
run on the columnar host tier (``core/host_bridge.py``, on the CPU); every
other query, and every other partition, runs on the host interpreter
(``core/query_runtime.py``, ``core/partition.py``). Snapshots, persistence,
on-demand queries, the debugger, statistics and the playback clock are the
reference's. So is the IO tier: ``@source``/``@sink`` annotations wire
sources, sinks and their mappers (``core/io.py``; every sink behind the
publish pipeline of ``resilience/``), with the handler interception
managers of the engine context; and so is durable flow control (``flow/``:
``@app:wal``, ``@app:backpressure``, and ``@app:adaptive``, whose
controller the device and host bridges attach), and so is the resilience
layer (``resilience/``): every ``@device`` query behind a ``DeviceGuard``
that replays a failed step on the host (the columnar tier first) and
quarantines a failing device path, every columnar query behind a
``HostStepGuard``, ``@app:chaos`` fault injection and the
``@app:resilience`` settings. So is the observability subsystem
(``observability/``): ``@app:trace``, the always-on flight recorder
(``@app:flightrecorder``), ``@app:profile`` on ``torch.profiler``, the device
step probes and the phase attribution, wired after the build.

So is the multi-tenant fleet tier (``fleet/``): an ``@app:fleet`` app's
queries and pattern partitions join the engine's ``FleetManager`` shape
groups (one shared columnar plan per shape, cross-app lane batching, the
``FleetGuard`` and the SLO autopilot); a query with no fleet shape keeps
the solo tiers (device, columnar, interpreter), per query.
"""

from __future__ import annotations

import time
from typing import Optional

from ..compiler import parse_on_demand_query
from ..query_api import Partition, Query, SiddhiApp, Window
from ..query_api.annotation import find_annotation
from ..query_api.definition import DataType, StreamDefinition
from .context import SiddhiAppContext, SiddhiContext
from .errors import SiddhiAppCreationError
from .event import Event
from .extension import ScriptFunction
from .io import (
    SINK_MAPPERS,
    SINKS,
    SOURCE_MAPPERS,
    SOURCES,
    parse_io_annotations,
)
from .metrics import Level, StatisticsManager
from .named_window import NamedWindow
from .on_demand import OnDemandQueryRuntime
from .partition import PartitionRuntime
from .query_runtime import QueryRuntime, build_query_runtime, make_window_processor
from .scheduler import SystemTicker
from .snapshot import PersistenceManager, SnapshotService
from .stream import (
    InputHandler,
    OnErrorAction,
    QueryCallback,
    StreamCallback,
    StreamJunction,
    _StreamCallbackReceiver,
)
from .table import InMemoryTable
from .trigger import TriggerRuntime, trigger_stream_definition


class SiddhiAppRuntime:
    def __init__(self, app: SiddhiApp, siddhi_context: SiddhiContext,
                 playback: Optional[bool] = None, start_time: int = 0):
        self.app = app
        app_ann = find_annotation(app.annotations, "app")
        playback_ann = find_annotation(app.annotations, "playback")
        if playback is None:
            playback = playback_ann is not None or (
                app_ann is not None and app_ann.get("playback") == "true")
        # @app:playback(idle.time='...', increment='...') heartbeat: after
        # idle.time of wall silence the playback clock jumps by increment
        # (reference EventTimeBasedMillisTimestampGenerator)
        self._heartbeat_cfg = None
        if playback_ann is not None and playback_ann.get("idle.time"):
            from .aggregation import parse_retention
            idle = parse_retention(playback_ann.get("idle.time"))
            inc = parse_retention(playback_ann.get("increment") or "1 sec")
            self._heartbeat_cfg = (int(idle), int(inc))
        self.name = app.name()
        self.ctx = SiddhiAppContext(siddhi_context, self.name, playback, start_time)
        self.ctx.runtime = self
        self.ctx.statistics_manager = StatisticsManager(self.name)
        # @app(statistics='true'|'detail', statistics.reporter='log',
        # statistics.interval='30') — reference @app statistics wiring
        if app_ann is not None:
            stats = (app_ann.get("statistics") or "").lower()
            if stats in ("true", "basic"):
                self.ctx.statistics_manager.set_level(Level.BASIC)
            elif stats == "detail":
                self.ctx.statistics_manager.set_level(Level.DETAIL)
            reporter = app_ann.get("statistics.reporter")
            interval = app_ann.get("statistics.interval")
            if reporter or interval:
                try:
                    self.ctx.statistics_manager.configure_reporter(
                        reporter, float(interval) if interval else None)
                except ValueError as e:
                    raise SiddhiAppCreationError(str(e)) from None
        self.input_handlers: dict[str, InputHandler] = {}
        self.query_runtimes: dict[str, QueryRuntime] = {}
        self.partition_runtimes: list[PartitionRuntime] = []
        self.trigger_runtimes: list[TriggerRuntime] = []
        self.sources: list = []
        self.sinks: list = []
        self.device_bridges: list = []
        self.host_bridges: list = []    # columnar host fast-path queries
        self.fleet_bridges: list = []   # @app:fleet shared-lane members
        self._io_handlers: list[tuple[str, str]] = []   # (kind, element id)
        self._started = False
        self._ondemand_cache: dict[str, OnDemandQueryRuntime] = {}

        self.snapshot_service = SnapshotService(self.ctx)
        self.persistence = PersistenceManager(
            self.ctx, self.snapshot_service, siddhi_context.persistence_store)

        # @app:adaptive(...): device micro-batch flush thresholds adapt to
        # observed rate/latency — parsed before _build so device bridges can
        # attach controllers as they compile
        adaptive_ann = find_annotation(app.annotations, "adaptive")
        if adaptive_ann is not None:
            from ..flow.adaptive_batch import parse_adaptive_annotation
            self.ctx.adaptive_cfg = parse_adaptive_annotation(adaptive_ann)
        self.flow = None                # FlowSubsystem when @app:wal/@app:backpressure
        # observability BEFORE _build: the @app:trace tracer must exist on
        # the context while queries, sinks and device bridges compile their
        # instrumentation points
        from ..observability import ObservabilitySubsystem
        self.observability = ObservabilitySubsystem(self)
        # sink pipelines — built BEFORE _build so sinks wrap as the IO
        # compiles
        from ..resilience import ResilienceSubsystem
        self.resilience = ResilienceSubsystem(self)

        self._build()
        # gauges/probes over the finished surfaces (bridges, junctions,
        # sources) — after _build so every element exists
        self.observability.wire()

    # ------------------------------------------------------------------ build
    def _build(self) -> None:
        app, ctx = self.app, self.ctx
        # script functions
        for fd in app.function_definitions.values():
            ctx.script_functions[fd.id] = ScriptFunction(
                fd.id, fd.language, fd.return_type, fd.body)
        # tables
        for td in app.table_definitions.values():
            ctx.tables[td.id] = self._build_table(td)
        # streams + junctions (+ fault streams)
        for sd in app.stream_definitions.values():
            self._get_junction(sd.id, define=sd)
            # stream-level @async, or app-wide @app:async applying to every
            # defined stream (reference AsyncTestCase.asyncTest2)
            async_ann = find_annotation(sd.annotations, "async") \
                or find_annotation(app.annotations, "async")
            if async_ann is not None:
                # Disruptor-mode analog (StreamJunction.java:279-316):
                # producers enqueue, workers deliver under the engine lock
                self.ctx.stream_junctions[sd.id].enable_async(
                    buffer_size=int(async_ann.get("buffer.size") or 1024),
                    workers=int(async_ann.get("workers") or 1),
                    batch_size_max=int(async_ann.get("batch.size.max") or 64))
            onerror = find_annotation(sd.annotations, "OnError")
            if onerror is not None:
                action = (onerror.get("action") or "log").lower()
                junction = ctx.stream_junctions[sd.id]
                junction.on_error_action = action
                if action == OnErrorAction.STREAM:
                    fault_def = StreamDefinition("!" + sd.id)
                    for a in sd.attributes:
                        fault_def.attribute(a.name, a.type)
                    fault_def.attribute("_error", DataType.OBJECT)
                    fj = self._get_junction("!" + sd.id, define=fault_def)
                    junction.fault_junction = fj
        # named windows
        for wd in app.window_definitions.values():
            handler = wd.window_handler or Window(None, "length", [])
            proc = make_window_processor(handler, wd, ctx, f"window-{wd.id}")
            ctx.named_windows[wd.id] = NamedWindow(wd, proc, ctx)
        # triggers
        for td in app.trigger_definitions.values():
            sd = trigger_stream_definition(td.id)
            j = self._get_junction(td.id, define=sd)
            self.trigger_runtimes.append(TriggerRuntime(td, j, ctx))
        # aggregations (@device ones step on the engine's device)
        from .aggregation import AggregationRuntime
        for ad in app.aggregation_definitions.values():
            ctx.aggregations[ad.id] = AggregationRuntime(
                ad, ctx, self._stream_defs(),
                device=ctx.siddhi_context.device)
        # queries & partitions in definition order
        from .device_bridge import try_build_device_query
        from .host_bridge import (
            host_batch_config,
            try_build_host_partition,
            try_build_host_query,
        )
        host_cfg = host_batch_config(app.annotations)
        if host_cfg is not None:
            # the retained source travels with the config: process-backed
            # lane pools rebuild identical engines by re-parsing it
            host_cfg["source_text"] = getattr(app, "source_text", None)
        part_count = 0
        # @app:fleet: multi-tenant shared compilation — queries join the
        # engine-wide FleetManager's shape groups (one compiled program per
        # shape, cross-app lane batching); non-normalizing queries fall
        # through to the solo tiers below, per query
        from ..fleet import fleet_config
        try:
            fleet_cfg = fleet_config(app.annotations)
        except ValueError as e:     # malformed slo.class / numeric knob
            raise SiddhiAppCreationError(str(e)) from None
        fleet_mgr = ctx.siddhi_context.fleet() if fleet_cfg is not None \
            else None
        q_count = 0
        for element in app.execution_elements:
            if isinstance(element, Query):
                q_count += 1
                name = element.name() or f"query-{q_count}"
                # @device queries step on the device when they fit its
                # kernels' coverage; otherwise the host tiers build below
                bridge = try_build_device_query(
                    element, ctx, self._stream_defs(), self._get_junction, name)
                if bridge is not None:
                    self.device_bridges.append(bridge)
                    for sid in bridge.stream_ids:
                        self._get_junction(sid).subscribe(
                            bridge.receiver_for(sid))
                    self._fill_implicit(element, bridge)
                    continue
                # fleet tier: same-shape queries across tenant apps share
                # one compiled columnar program and step as lanes of one
                # batched step (solo tiers below when no fleet shape)
                if fleet_mgr is not None:
                    fbridge = fleet_mgr.enroll_query(
                        element, ctx, self._stream_defs(),
                        self._get_junction, name, fleet_cfg)
                    if fbridge is not None:
                        self.fleet_bridges.append(fbridge)
                        for sid in fbridge.stream_ids:
                            self._get_junction(sid).subscribe(
                                fbridge.receiver_for(sid))
                        self._fill_implicit(element, fbridge)
                        continue
                # columnar host fast path (middle tier): engages per query
                # when the plan lowers in the compilers' host form;
                # otherwise the scalar interpreter builds below — per
                # query, not per app
                hbridge = try_build_host_query(
                    element, ctx, self._stream_defs(), self._get_junction,
                    name, host_cfg)
                if hbridge is not None:
                    self.host_bridges.append(hbridge)
                    for sid in hbridge.stream_ids:
                        self._get_junction(sid).subscribe(
                            hbridge.receiver_for(sid))
                    self._fill_implicit(element, hbridge)
                    continue
                rt = build_query_runtime(
                    element, ctx, self._stream_defs(), self._get_junction, name)
                self.query_runtimes[name] = rt
                for sid, receiver in rt.subscriptions:
                    if sid in ctx.named_windows:
                        ctx.named_windows[sid].subscribe(receiver)
                    elif sid in ctx.aggregations:
                        raise SiddhiAppCreationError(
                            "aggregations are queried via joins/on-demand")
                    else:
                        self._get_junction(sid).subscribe(receiver)
                self._fill_implicit(element, rt)
            elif isinstance(element, Partition):
                q_count += 1
                part_count += 1
                name = f"partition-{q_count}"
                if host_cfg is not None:
                    # position among the app's partitions: the lane-pool
                    # child re-parses and indexes to the same block
                    host_cfg["part_index"] = part_count - 1
                if fleet_mgr is not None:
                    fbridges = fleet_mgr.enroll_partition(
                        element, ctx, self._stream_defs(),
                        self._get_junction, name, fleet_cfg)
                    if fbridges is not None:
                        for fb in fbridges:
                            self.fleet_bridges.append(fb)
                            for sid in fb.stream_ids:
                                self._get_junction(sid).subscribe(
                                    fb.receiver_for(sid))
                        continue
                if host_cfg is not None:
                    # lane-partitioned columnar NFA for pattern partitions:
                    # replaces the per-key interpreter cloning when EVERY
                    # query in the block lowers in the host form
                    hbridges = try_build_host_partition(
                        element, ctx, self._stream_defs(),
                        self._get_junction, name, host_cfg)
                    if hbridges is not None:
                        for hb in hbridges:
                            self.host_bridges.append(hb)
                            for sid in hb.stream_ids:
                                self._get_junction(sid).subscribe(
                                    hb.receiver_for(sid))
                        continue
                # otherwise every inner query runs on the interpreter,
                # @device ones too, as in the reference
                prt = PartitionRuntime(element, ctx, self._stream_defs(),
                                       lambda sid, inner=False: self._get_junction(sid),
                                       name)
                # pre-fill implicit defs for partition outputs
                prt.subscribe_all(lambda sid, inner=False: self._get_junction(sid))
                self.partition_runtimes.append(prt)
        # sources & sinks from stream annotations
        self._wire_io()
        # durable flow control (@app:wal / @app:backpressure) — after
        # junctions exist and @async dispatchers are configured
        wants_flow = find_annotation(app.annotations, "wal") is not None \
            or find_annotation(app.annotations, "backpressure") is not None
        if wants_flow:
            from ..flow import build_flow
            self.flow = build_flow(self)
        self._wire_gauges()

    def _build_table(self, td):
        ctx = self.ctx
        store_ann = find_annotation(td.annotations, "store")
        if store_ann is None:
            return InMemoryTable(td, ctx)
        store_type = store_ann.get("type")
        cls = ctx.siddhi_context.extensions.get(f"store:{store_type}")
        if cls is None:
            raise SiddhiAppCreationError(
                f"no store extension '{store_type}' for table '{td.id}'")
        table = cls(td, ctx)
        table.config_reader = ctx.config_reader("store", store_type)
        table.init(td, {e.key: e.value for e in store_ann.elements if e.key})
        rmgr = ctx.siddhi_context.record_table_handler_manager
        if rmgr is not None:
            th = rmgr.generate_record_table_handler()
            th.init(self.name, td)
            rmgr.register_record_table_handler(th.id, th)
            table.handler = th
            self._io_handlers.append(("table", th.id))
        cache_ann = store_ann.nested("cache")
        if cache_ann is None:
            return table
        from .table import CacheTable
        # the reference requires an explicit size and rejects unknown cache
        # keys (CacheTable config validation) — a silent 128/FIFO default
        # would mask config typos
        known = {"size", "cache.size", "policy", "cache.policy"}
        bad = [e.key for e in cache_ann.elements
               if e.key and e.key not in known]
        if bad:
            raise SiddhiAppCreationError(
                f"table '{td.id}': unrecognized @cache key(s) {bad}; known: "
                f"{sorted(known)}")
        size_s = cache_ann.get("size") or cache_ann.get("cache.size")
        if size_s is None:
            raise SiddhiAppCreationError(
                f"table '{td.id}': @cache requires a 'size'")
        try:
            size = int(size_s)
        except ValueError:
            raise SiddhiAppCreationError(
                f"table '{td.id}': @cache size '{size_s}' is not an "
                f"integer") from None
        if size < 1:
            raise SiddhiAppCreationError(
                f"table '{td.id}': @cache size must be >= 1, got {size}")
        try:
            table = CacheTable(
                td, ctx, backing=table, max_size=size,
                policy=(cache_ann.get("cache.policy")
                        or cache_ann.get("policy") or "FIFO"))
        except ValueError as e:    # e.g. unknown policy name
            raise SiddhiAppCreationError(f"table '{td.id}': {e}") from None
        table.preload()
        return table

    def _wire_gauges(self) -> None:
        """Buffered-events + memory gauges (reference BufferedEventsTracker /
        SiddhiMemoryUsageMetric): async queue depths and per-element retained
        size, device state included (the bytes of its tensors)."""
        sm = self.ctx.statistics_manager
        for sid, j in self.ctx.stream_junctions.items():
            if j.dispatcher is not None:
                sm.buffered_tracker(
                    f"stream.{sid}", lambda d=j.dispatcher: d.buffered_events)
        for b in self.device_bridges:
            if b.driver is not None:
                sm.buffered_tracker(
                    f"device.{b.query_name}",
                    lambda drv=b.driver: drv.pipeline_depth)
            # device state bytes: nbytes summed over the state tensors
            sm.memory_tracker(
                f"device.{b.query_name}",
                lambda rt=b.runtime: rt.state)
        for element_id, holder in self.ctx.state_registry.items():
            if not element_id.startswith("device-"):
                sm.memory_tracker(element_id, lambda h=holder: h)
        # flow-control gauges: wal_bytes / queue_depth / credits / shed_count
        if self.flow is not None:
            for sid, sf in self.flow.streams.items():
                if sf.wal is not None:
                    sm.gauge_tracker(f"flow.{sid}.wal_bytes",
                                     lambda w=sf.wal: w.wal_bytes)
                if sf.gate is not None:
                    sm.gauge_tracker(f"flow.{sid}.queue_depth",
                                     lambda g=sf.gate: g.depth)
                    sm.gauge_tracker(f"flow.{sid}.credits",
                                     lambda g=sf.gate: g.credits)
                sm.gauge_tracker(f"flow.{sid}.shed_count",
                                 lambda s=sf.stats: s.shed)
                sm.gauge_tracker(f"flow.{sid}.dropped_oldest",
                                 lambda s=sf.stats: s.dropped_oldest)
        for b in self.device_bridges:
            ctrl = getattr(b.runtime, "batch_controller", None)
            if ctrl is not None:
                sm.gauge_tracker(f"device.{b.query_name}.batch_size",
                                 lambda c=ctrl: c.current)
        # columnar host fast-path gauges: staged rows, events/batches routed
        # through the vectorized engine (the step-latency histogram registers
        # at bridge construction)
        for b in self.host_bridges:
            sm.buffered_tracker(f"host_batch.{b.query_name}",
                                lambda bb=b: len(bb.runtime.builder))
            sm.gauge_tracker(f"host_batch.{b.query_name}.events",
                             lambda bb=b: bb.events_in)
            sm.gauge_tracker(f"host_batch.{b.query_name}.batches",
                             lambda bb=b: bb.batches)
            ctrl = getattr(b.runtime, "batch_controller", None)
            if ctrl is not None:
                sm.gauge_tracker(f"host_batch.{b.query_name}.batch_size",
                                 lambda c=ctrl: c.current)
        # fleet gauges: staged rows visible per tenant (per-member ev/s,
        # lanes-per-step and shape-cache counters register at enroll time in
        # the FleetManager)
        for b in self.fleet_bridges:
            sm.buffered_tracker(f"fleet.{b.query_name}",
                                lambda bb=b: len(bb.group.stager))
        # edge-path gauges: transport bytes and parsed rows per source
        for src in self.sources:
            sid = getattr(getattr(src, "definition", None), "id", None)
            if sid is None:     # exotic Source subclass skipping init()
                continue
            if hasattr(src, "bytes_in"):
                sm.gauge_tracker(f"stream.{sid}.source_bytes_in",
                                 lambda s=src: s.bytes_in)
            mp = getattr(src, "mapper", None)
            if mp is not None and hasattr(mp, "rows_out"):
                sm.gauge_tracker(f"stream.{sid}.source_rows_out",
                                 lambda m=mp: m.rows_out)
                sm.gauge_tracker(f"stream.{sid}.source_rows_per_s",
                                 lambda m=mp: m.rows_per_s)
                sm.gauge_tracker(f"stream.{sid}.source_parse_errors",
                                 lambda m=mp: m.parse_errors)
        for sid, j in self.ctx.stream_junctions.items():
            sm.gauge_tracker(f"stream.{sid}.receiver_errors",
                             lambda jj=j: jj.receiver_errors)
        # resilience gauges: sink circuits (sink_retries / sink_dropped
        # register themselves as counters at wrap time), device quarantine
        # state, chaos counters
        for rs in self.resilience.sinks:
            sm.gauge_tracker(
                f"sink.{rs.stream_id}.{rs.ordinal}.circuit_state",
                lambda s=rs: s.breaker.state_code)
        for g in self.resilience.guards:
            sm.gauge_tracker(f"device.{g.query_name}.circuit_state",
                             lambda x=g: x.breaker.state_code)
            sm.gauge_tracker(f"device.{g.query_name}.fallback_events",
                             lambda x=g: x.fallback_events)
        # host-batch step containment (HostStepGuard): circuit + replay
        # evidence per columnar query, torn down with the host_batch.{q}
        # family on shutdown
        for g in self.resilience.host_guards:
            sm.gauge_tracker(f"host_batch.{g.query_name}.circuit_state",
                             lambda x=g: x.breaker.state_code)
            sm.gauge_tracker(f"host_batch.{g.query_name}.fallback_events",
                             lambda x=g: x.fallback_events)
        if self.resilience.chaos is not None:
            for key in self.resilience.chaos.counters:
                sm.gauge_tracker(
                    f"chaos.{key}",
                    lambda c=self.resilience.chaos, k=key: c.counters[k])

    def _stream_defs(self) -> dict:
        defs = dict(self.app.stream_definitions)
        for sid, j in self.ctx.stream_junctions.items():
            defs.setdefault(sid, j.definition)
        return defs

    def _get_junction(self, stream_id: str, inner: bool = False,
                      define: Optional[StreamDefinition] = None) -> StreamJunction:
        j = self.ctx.stream_junctions.get(stream_id)
        if j is None:
            d = define or self.app.stream_definitions.get(stream_id) \
                or StreamDefinition(stream_id)
            j = StreamJunction(d, self.ctx)
            self.ctx.stream_junctions[stream_id] = j
        elif define is not None and not j.definition.attributes:
            j.definition = define
        return j

    def _fill_implicit(self, query: Query, rt) -> None:
        """``rt`` is any runtime exposing ``output_schema`` (host query runtime
        or device bridge)."""
        from ..query_api import InsertIntoStream
        os = query.output_stream
        if isinstance(os, InsertIntoStream):
            j = self.ctx.stream_junctions.get(os.target_id)
            if j is not None and not j.definition.attributes:
                names, types = rt.output_schema
                d = StreamDefinition(os.target_id)
                for n, t in zip(names, types):
                    d.attribute(n, t)
                j.definition = d

    def _with_config(self, obj, namespace: str, name: str):
        # reference hands a ConfigReader into every extension init
        obj.config_reader = self.ctx.config_reader(namespace, name)
        return obj

    def _wire_io(self) -> None:
        ctx = self.ctx
        for sd in self.app.stream_definitions.values():
            sources, sinks = parse_io_annotations(sd)
            for s in sources:
                cls = SOURCES.get(s["type"]) or \
                    ctx.siddhi_context.extensions.get(f"source:{s['type']}")
                if cls is None:
                    raise SiddhiAppCreationError(f"unknown source type '{s['type']}'")
                mapper_cls = SOURCE_MAPPERS.get(s["map"]) or \
                    ctx.siddhi_context.extensions.get(f"sourceMapper:{s['map']}")
                if mapper_cls is None:
                    raise SiddhiAppCreationError(
                        f"unknown source mapper type '{s['map']}'")
                mapper = self._with_config(mapper_cls(), "sourceMapper", s["map"])
                mapper.init(sd, {**s["options"], **s.get("map_options", {})})
                src = self._with_config(cls(), "source", s["type"])
                handler = self._make_source_handler(sd.id, mapper, s["type"])
                src.init(sd, s["options"], mapper, handler)
                try:
                    src.retry_delays()    # malformed retry.delays fails the
                    # BUILD, not the first connect attempt at start
                except ValueError as e:
                    raise SiddhiAppCreationError(
                        f"source on stream '{sd.id}': bad retry.delays "
                        f"({e})") from None
                # connect retries abort promptly once shutdown starts
                src.shutdown_signal = self.resilience.shutdown_signal
                self.resilience.wrap_source_connect(src, sd.id)
                self.sources.append(src)
            for s in sinks:
                cls = SINKS.get(s["type"]) or \
                    ctx.siddhi_context.extensions.get(f"sink:{s['type']}")
                if cls is None:
                    raise SiddhiAppCreationError(f"unknown sink type '{s['type']}'")
                mapper_cls = SINK_MAPPERS.get(s["map"]) or \
                    ctx.siddhi_context.extensions.get(f"sinkMapper:{s['map']}")
                if mapper_cls is None:
                    raise SiddhiAppCreationError(
                        f"unknown sink mapper type '{s['map']}'")
                dist = s.get("distribution")
                if dist and dist["destinations"]:
                    from .io import (
                        BroadcastStrategy,
                        DistributedSink,
                        PartitionedStrategy,
                        RoundRobinStrategy,
                    )
                    subs = []
                    for dest_opts in dist["destinations"]:
                        mapper = self._with_config(
                            mapper_cls(), "sinkMapper", s["map"])
                        mapper.init(sd, {**s["options"], **s.get("map_options", {})})
                        sub = self._with_config(cls(), "sink", s["type"])
                        merged = {**s["options"], **dest_opts}
                        sub.init(sd, merged, mapper)
                        # per-destination pipeline: one endpoint failing must
                        # not take down its siblings
                        subs.append(self.resilience.wrap_sink(sub, sd, merged))
                    n = len(subs)
                    strat_name = (dist["strategy"] or "roundRobin").lower()
                    if strat_name == "partitioned":
                        key = dist.get("partitionKey")
                        if key is None:
                            raise SiddhiAppCreationError(
                                "partitioned @distribution needs partitionKey")
                        strat = PartitionedStrategy(
                            n, sd.attribute_position(key))
                    elif strat_name == "broadcast":
                        strat = BroadcastStrategy(n)
                    else:
                        strat = RoundRobinStrategy(n)
                    sink = DistributedSink(subs, strat)
                else:
                    mapper = self._with_config(
                        mapper_cls(), "sinkMapper", s["map"])
                    mapper.init(sd, {**s["options"], **s.get("map_options", {})})
                    sink = self._with_config(cls(), "sink", s["type"])
                    sink.init(sd, s["options"], mapper)
                    # the publish pipeline (on.error policy + circuit
                    # breaker) wraps every wired sink
                    sink = self.resilience.wrap_sink(sink, sd, s["options"])
                self.sinks.append(sink)
                smgr = ctx.siddhi_context.sink_handler_manager
                if smgr is not None:
                    sh = smgr.generate_sink_handler()
                    sh.init(self.name, sd, sink.on_event,
                            element_id=self.ctx.element_id(
                                f"{self.name}-{sd.id}-{type(sh).__name__}"))
                    smgr.register_sink_handler(sh.id, sh)
                    self._io_handlers.append(("sink", sh.id))
                    cb = StreamCallback(lambda events, h=sh: [
                        h.handle(e) for e in events])
                    self.add_callback(sd.id, cb)
                else:
                    # direct sink subscription: rows-capable sinks (mapper
                    # map_rows + sink publish_rows) accept whole columnar
                    # chunks — the zero-object egress; everything else
                    # keeps the per-event Event path
                    from .io import RowsSinkReceiver, SinkReceiver
                    recv = RowsSinkReceiver(sink) \
                        if getattr(sink, "rows_capable", False) \
                        else SinkReceiver(sink)
                    self._get_junction(sd.id).subscribe(recv)

    def _make_source_handler(self, stream_id: str, mapper, source_type: str):
        mgr = self.ctx.siddhi_context.source_handler_manager
        sh = None
        if mgr is not None:
            sh = mgr.generate_source_handler(source_type)
            sh.init(self.name, self.app.stream_definitions[stream_id],
                    element_id=self.ctx.element_id(
                        f"{self.name}-{stream_id}-{type(sh).__name__}"))
            mgr.register_source_handler(sh.id, sh)
            self._io_handlers.append(("source", sh.id))

        sm = self.ctx.statistics_manager
        parse_tracker = sm.latency_tracker(
            f"source.{stream_id}.ingress_parse") if sm is not None else None
        map_rows = getattr(mapper, "map_rows", None)

        def handler(payload):
            from .columns import RowsChunk
            ih = self.input_handler(stream_id)
            if isinstance(payload, RowsChunk):
                if sh is None:
                    # a columnar chunk forwards whole through the bulk
                    # ingress instead of exploding into per-event sends
                    # (in-memory broker rows path, socket rows frames)
                    ih.send_columns(payload.cols, payload.ts, payload.count)
                    return
                # interception installed: the SourceHandler contract is
                # per event — degrade the chunk to rows so a RowsChunk
                # payload still flows instead of crashing the mapper
                names = self.app.stream_definitions[stream_id] \
                    .attribute_names
                tss = payload.ts
                for i, row in enumerate(payload.rows(names)):
                    sh.send_event(
                        Event(int(tss[i]), row) if tss is not None
                        else row, ih)
                return
            if sh is None:
                if callable(map_rows) and isinstance(
                        payload, (bytes, bytearray, memoryview)):
                    t0 = time.perf_counter()
                    chunks = map_rows(payload)
                    dt = time.perf_counter() - t0
                    for ch in chunks:
                        if parse_tracker is not None and ch.count:
                            parse_tracker.record_seconds(
                                dt / max(len(chunks), 1), ch.count)
                        ih.send_columns(ch.cols, ch.ts, ch.count)
                    return
            for row in mapper.map(payload):
                if sh is not None:
                    sh.send_event(row, ih)
                else:
                    ih.send(row)
        # @app:chaos source faults reject the payload before ingress
        return self.resilience.wrap_source_handler(stream_id, handler)

    # -------------------------------------------------------------- public API
    def input_handler(self, stream_id: str) -> InputHandler:
        ih = self.input_handlers.get(stream_id)
        if ih is None:
            if stream_id not in self.ctx.stream_junctions:
                raise KeyError(f"stream '{stream_id}' is not defined")
            ih = InputHandler(stream_id, self.ctx.stream_junctions[stream_id], self.ctx)
            if self.flow is not None:
                self.flow.attach(ih)
            self.input_handlers[stream_id] = ih
        return ih

    # reference-style alias
    getInputHandler = input_handler

    def add_callback(self, stream_id: str, callback: StreamCallback) -> None:
        if stream_id not in self.ctx.stream_junctions:
            raise KeyError(f"stream '{stream_id}' is not defined")
        self.ctx.stream_junctions[stream_id].subscribe(
            _StreamCallbackReceiver(callback))

    def add_rows_callback(self, stream_id: str, fn) -> None:
        """Columns-capable subscription: ``fn(cols, ts, n)`` receives whole
        columnar chunks (zero per-event objects end to end when every other
        subscriber of the stream is also columns-capable)."""
        from .stream import RowsCallback
        j = self.ctx.stream_junctions.get(stream_id)
        if j is None:
            raise KeyError(f"stream '{stream_id}' is not defined")
        cb = RowsCallback(fn)
        cb.names = j.definition.attribute_names
        j.subscribe(cb)

    def remove_callback(self, callback: StreamCallback) -> None:
        """Detach a previously added stream callback (reference
        ``SiddhiAppRuntime.removeCallback``)."""
        for j in self.ctx.stream_junctions.values():
            for r in list(j.receivers):
                if isinstance(r, _StreamCallbackReceiver) \
                        and r.callback is callback:
                    j.unsubscribe(r)

    def remove_query_callback(self, callback: QueryCallback) -> None:
        for rt in self.query_runtimes.values():
            cbs = rt.callback_adapter.callbacks
            if callback in cbs:
                cbs.remove(callback)
        for bridge in (self.device_bridges + self.host_bridges
                       + self.fleet_bridges):
            if callback in bridge.query_callbacks:
                bridge.query_callbacks.remove(callback)

    def add_query_callback(self, query_name: str, callback: QueryCallback) -> None:
        rt = self.query_runtimes.get(query_name)
        if rt is not None:
            rt.add_callback(callback)
            return
        for bridge in (self.device_bridges + self.host_bridges
                       + self.fleet_bridges):
            if bridge.query_name == query_name:
                bridge.query_callbacks.append(callback)
                return
        for prt in self.partition_runtimes:
            for q in prt.partition_ast.queries:
                if q.name() == query_name:
                    prt.add_query_callback(query_name, callback)
                    return
        raise KeyError(f"no query named '{query_name}'")

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.resilience.on_start()
        for j in self.ctx.stream_junctions.values():
            if j.dispatcher is not None:
                j.dispatcher.start()
        for rt in self.query_runtimes.values():
            rt.start()
        for tr in self.trigger_runtimes:
            tr.start()
        if not getattr(self, "_defer_sources", False):
            for src in self.sources:
                src.connect_with_retry()
        self.observability.on_start()
        self.ctx.statistics_manager.start_reporting()
        if not self.ctx.timestamp_generator.playback:
            self.ctx.ticker = SystemTicker(self.ctx.scheduler)
            self.ctx.ticker.start()
        elif self._heartbeat_cfg is not None:
            from .scheduler import PlaybackHeartbeat
            self._heartbeat = PlaybackHeartbeat(self.ctx,
                                                *self._heartbeat_cfg)
            self._heartbeat.start()

    def shutdown(self) -> None:
        # signal first: WAIT backoffs and connect retries abort promptly
        # instead of riding out their delays
        self.resilience.on_shutdown()
        self.drain_async()           # deliver queued async events
        for b in self.device_bridges:
            b.finalize()             # drain + close open device segments
        for b in self.host_bridges:
            b.finalize()             # drain columnar host micro-batches
        for b in self.fleet_bridges:
            b.finalize()             # drain the shared fleet groups
        for j in self.ctx.stream_junctions.values():
            if j.dispatcher is not None:
                j.dispatcher.stop()
        for b in self.device_bridges:
            if b.driver is not None:
                b.driver.stop()
        for agg in self.ctx.aggregations.values():
            if getattr(agg, "persist_stores", None):
                agg.flush_persisted()    # drain write-behind rollups
        for src in self.sources:
            src.disconnect()
        for sink in self.sinks:
            sink.disconnect()
        sc = self.ctx.siddhi_context
        for kind, hid in self._io_handlers:
            mgr = {"source": sc.source_handler_manager,
                   "sink": sc.sink_handler_manager,
                   "table": sc.record_table_handler_manager}[kind]
            if mgr is not None:
                getattr(mgr, f"unregister_{'record_table' if kind == 'table' else kind}_handler")(hid)
        self._io_handlers = []
        if self.flow is not None:
            self.flow.close()
        # leave the fleet: this tenant's lanes detach from their shape
        # groups (shared plans stay cached for the next tenant), and its
        # metric families tear down through unregister() — a stopped tenant
        # app must not leak dead gauges into the engine-wide exposition
        sm = self.ctx.statistics_manager
        if self.fleet_bridges:
            self.ctx.siddhi_context.fleet().release_app(self.name)
            sm.unregister("fleet.")
            sm.unregister("slo.")   # the autopilot's compliance gauges ride
            # the tenant's lifecycle exactly like the fleet.* families
            self.fleet_bridges = []
        for b in self.host_bridges:
            sm.unregister(f"host_batch.{b.query_name}")
        self.observability.on_shutdown()
        self.ctx.statistics_manager.stop_reporting()
        if self.ctx.ticker is not None:
            self.ctx.ticker.stop()
        if getattr(self, "_heartbeat", None) is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        self._started = False

    def drain_async(self) -> None:
        """Quiesce async junction dispatchers (ThreadBarrier analog). Must be
        called WITHOUT holding root_lock."""
        for j in self.ctx.stream_junctions.values():
            if j.dispatcher is not None:
                j.dispatcher.quiesce()

    # -- time (playback) ------------------------------------------------------
    def advance_time(self, ts: int) -> None:
        """Advance the playback clock (fires due timers) without an event."""
        self.flush_device()
        self.flush_host()
        self.ctx.advance_time(ts)

    def flush_device(self) -> None:
        """Drain pending micro-batches of @device-offloaded queries."""
        for b in self.device_bridges:
            b.flush()

    def flush_host(self) -> None:
        """Drain pending micro-batches of columnar host fast-path queries
        and of the shared fleet groups this app's tenants stage into."""
        for b in self.host_bridges:
            b.flush()
        for b in self.fleet_bridges:
            b.flush()

    # -- snapshots ------------------------------------------------------------
    def _pre_snapshot(self) -> None:
        """Quiesce async machinery so state walks see a stable engine (the
        reference locks ThreadBarrier). Runs WITHOUT root_lock."""
        self.drain_async()
        self.flush_host()       # columnar bridges are synchronous: a plain
        # drain leaves no staged row for the state walk to miss
        for b in self.device_bridges:
            if b.driver is not None:
                b.driver.flush_sync()
                b.driver.pause()

    def _post_snapshot(self) -> None:
        for b in self.device_bridges:
            if b.driver is not None:
                b.driver.resume()

    def snapshot(self) -> bytes:
        self._pre_snapshot()
        try:
            return self.snapshot_service.full_snapshot()
        finally:
            self._post_snapshot()

    def restore(self, blob: bytes) -> None:
        # quiesce + pause async machinery: a device worker step in flight
        # would otherwise overwrite the freshly restored device state
        self._pre_snapshot()
        try:
            self.snapshot_service.restore(blob)
            self.persistence.invalidate_chain()
        finally:
            self._post_snapshot()

    def persist(self) -> str:
        self._pre_snapshot()
        try:
            revision = self.persistence.persist()
        finally:
            self._post_snapshot()
        if self.flow is not None:
            # the checkpoint is durable: WAL segments below its watermark
            # are acked and can be dropped
            self.flow.on_persisted()
        return revision

    def restore_revision(self, revision: str) -> None:
        self._pre_snapshot()
        try:
            self.persistence.restore_revision(revision)
        finally:
            self._post_snapshot()

    def restore_last_revision(self) -> Optional[str]:
        self._pre_snapshot()
        try:
            return self.persistence.restore_last_revision()
        finally:
            self._post_snapshot()

    def clear_all_revisions(self) -> None:
        self.persistence.clear_all_revisions()

    # -- error-store replay ---------------------------------------------------
    def replay_errors(self, stream_name: Optional[str] = None,
                      min_id: Optional[int] = None,
                      max_id: Optional[int] = None) -> dict:
        """Re-inject this app's stored failed events ('before' entries
        re-enter through the stream's ``InputHandler``). Returns
        ``{"replayed", "failed", "skipped"}``."""
        store = self.ctx.siddhi_context.error_store
        if store is None:
            raise ValueError("no error store configured")
        return store.replay(self, stream_name, min_id, max_id)

    # -- on-demand queries ----------------------------------------------------
    def query(self, text: str) -> list[Event]:
        rt = self._ondemand_cache.get(text)
        if rt is None:
            odq = parse_on_demand_query(text)
            rt = OnDemandQueryRuntime(odq, self.ctx)
            if len(self._ondemand_cache) > 100:
                self._ondemand_cache.clear()
            self._ondemand_cache[text] = rt
        return rt.execute()

    # -- debugger -------------------------------------------------------------
    def debug(self):
        """Start debugging: returns the SiddhiDebugger (reference
        ``SiddhiAppRuntime.debug():666``)."""
        from .debugger import SiddhiDebugger
        if getattr(self.ctx, "debugger", None) is None:
            self.ctx.debugger = SiddhiDebugger(self.ctx)
        self.start()
        return self.ctx.debugger

    # -- introspection (reference SiddhiAppRuntime getter surface) ----------
    @property
    def stream_definition_map(self) -> dict:
        # declared + inferred (output streams materialize junctions with
        # their inferred definitions — the reference's map includes both)
        return self._stream_defs()

    @property
    def table_definition_map(self) -> dict:
        return dict(self.app.table_definitions)

    @property
    def window_definition_map(self) -> dict:
        return dict(self.app.window_definitions)

    @property
    def aggregation_definition_map(self) -> dict:
        return dict(self.app.aggregation_definitions)

    @property
    def query_names(self) -> set:
        names = set(self.query_runtimes)
        names.update(b.query_name for b in self.device_bridges)
        names.update(b.query_name for b in self.host_bridges)
        names.update(b.query_name for b in self.fleet_bridges)
        return names

    @property
    def tables(self) -> list:
        return list(self.ctx.tables.values())

    @property
    def windows(self) -> list:
        return list(self.ctx.named_windows.values())

    @property
    def triggers(self) -> list:
        return list(self.trigger_runtimes)

    def table_input_handler(self, table_id: str):
        """Direct table ingress (reference ``getTableInputHandler``)."""
        table = self.ctx.tables.get(table_id)
        if table is None:
            raise KeyError(f"table '{table_id}' is not defined")
        return _TableInputHandler(table, self.ctx)

    def on_demand_query_output_attributes(self, text: str) -> list:
        """(name, DataType) pairs the on-demand query would emit (reference
        ``getOnDemandQueryOutputAttributes``)."""
        from .executor import ExecutorBuilder, RowResolver
        odq = parse_on_demand_query(text)
        sid = odq.input_store_id
        ctx = self.ctx
        if sid in ctx.tables:
            d = ctx.tables[sid].definition
        elif sid in ctx.named_windows:
            d = ctx.named_windows[sid].definition
        elif sid in ctx.aggregations:
            d = ctx.aggregations[sid].output_definition
        else:
            raise KeyError(f"store '{sid}' is not defined")
        names = d.attribute_names
        types = [d.attribute_type(n) for n in names]
        attrs = list(odq.selector.attributes)
        if odq.selector.select_all or not attrs:
            return list(zip(names, types))
        builder = ExecutorBuilder(RowResolver(names, types), ctx)
        out = []
        for oa in attrs:
            fn, t = builder.build(oa.expr)
            name = oa.name or getattr(oa.expr, "attribute", None) or "value"
            out.append((name, t))
        return out

    def set_purging_enabled(self, enabled: bool) -> None:
        """Toggle incremental-aggregation purging engine-wide (reference
        ``setPurgingEnabled``)."""
        for agg in self.ctx.aggregations.values():
            was = agg.purge_enabled
            agg.purge_enabled = enabled
            if enabled and not was and agg.purge_interval:
                agg._arm_purge()

    def start_without_sources(self) -> None:
        """Start everything but the transports (reference
        ``startWithoutSources`` — sources attach later via
        :meth:`start_sources`)."""
        self._defer_sources = True
        try:
            self.start()
        finally:
            self._defer_sources = False

    def start_sources(self) -> None:
        for src in self.sources:
            src.connect_with_retry()

    def set_statistics_level(self, level: Level) -> None:
        self.ctx.statistics_manager.set_level(level)

    def set_exception_listener(self, listener) -> None:
        self.ctx.exception_listener = listener


class _TableInputHandler:
    """Direct table ingress (reference ``TableInputHandler``): rows go into
    the table without a feeding stream/query."""

    def __init__(self, table, app_context):
        self.table = table
        self.app_context = app_context

    def send(self, rows, timestamp=None) -> None:
        # a bare row may be a list OR a tuple (mirrors InputHandler payloads)
        if rows and not isinstance(rows[0], (list, tuple)):
            rows = [rows]
        ts = timestamp if timestamp is not None \
            else self.app_context.current_time()
        with self.app_context.root_lock:
            self.table.add([list(r) for r in rows], ts)
