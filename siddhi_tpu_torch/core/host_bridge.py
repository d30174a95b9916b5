"""Columnar host fast-path: per-query vectorized micro-batch execution.

The port's copy of the JAX package's ``core/host_bridge.py``. The middle
execution tier between the compiled device path (``@device`` →
``core/device_bridge.py``) and the scalar interpreter: queries whose plans
fully lower in the compilers' host form (``gpu/host_exec.py``, torch on the
CPU) execute over SoA micro-batches — dictionary-encoded columns,
vectorized filters/aggregates/NFA stages — instead of one ``StreamEvent``
at a time. Queries that do not lower keep the scalar interpreter, **per
query, not per app**. The tier runs on the CPU whatever the engine's
device, as in the reference.

Engagement:
- ``@app:host_batch(batch='8192', lanes='16')`` enables the fast path for
  every eligible query (and ``partition with`` pattern block) in the app;
- a query-level ``@host_batch`` annotation opts in a single query
  (``strict='true'`` raises instead of falling back);
- ``SIDDHI_HOST_BATCH=1`` in the environment is the app-level switch for
  benchmarking without editing app text;
- the resilience layer builds these bridges programmatically as the
  DeviceGuard quarantine/shadow-replay engine (``build_host_fallback``), so
  degraded mode is no longer interpreter-speed.

Batching semantics (same contract as the device bridge): per-event sends
stage until the flush threshold; CHUNKED deliveries (``InputHandler.send``
with an ``Event`` list, ``send_rows``, @async dispatcher batches, WAL
replay) are each processed as one micro-batch and flushed at chunk end, so
chunk ingress sees outputs synchronously. ``SiddhiAppRuntime.flush_host()``
(also called on playback watermark advancement and shutdown) drains
partial batches. Outputs re-enter the engine as CURRENT events carrying
their PER-ROW timestamps (the match/arrival event time — unlike the device
bridge's batch-timestamp stamping, so downstream event-time windows keep
exact semantics).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

from ..query_api import (
    InsertIntoStream,
    OutputEventsFor,
    Query,
    SingleInputStream,
    StateInputStream,
    Variable,
)
from ..query_api.annotation import find_annotation
from ..flow.adaptive_batch import AdaptiveFlushMixin
from .event import Event, EventType, StreamEvent

log = logging.getLogger("siddhi_tpu_torch.host_batch")

_DEF_BATCH = 8192
_DEF_LANES = 16


def host_batch_config(app_annotations) -> Optional[dict]:
    """App-level opt-in (annotation or SIDDHI_HOST_BATCH=1) → config dict."""
    ann = find_annotation(app_annotations, "host_batch")
    if ann is None and os.environ.get("SIDDHI_HOST_BATCH", "") != "1":
        return None
    cfg = {"batch": _DEF_BATCH, "lanes": _DEF_LANES,
           "workers": int(os.environ.get("SIDDHI_HOST_WORKERS", "1")),
           "workers_mode": os.environ.get("SIDDHI_HOST_WORKERS_MODE",
                                          "thread")}
    if ann is not None:
        if ann.get("enable") and ann.get("enable").lower() == "false":
            return None
        if ann.get("batch"):
            cfg["batch"] = int(ann.get("batch"))
        if ann.get("lanes"):
            cfg["lanes"] = int(ann.get("lanes"))
        if ann.get("workers"):
            # parallel columnar host tier: shard the partitioned-NFA lane
            # space across N worker threads (exact per-lane parity kept)
            cfg["workers"] = int(ann.get("workers"))
        if ann.get("workers.mode"):
            # 'process' backs the shards with a procmesh lane pool (one
            # child process per shard — own GIL); byte-identical outputs
            cfg["workers_mode"] = ann.get("workers.mode")
    if cfg["workers_mode"] not in ("thread", "process"):
        raise ValueError(
            f"host_batch workers.mode '{cfg['workers_mode']}' is not "
            "thread|process")
    if os.environ.get("SIDDHI_PROCMESH_CHILD") == "1":
        # already inside a procmesh child: no recursive process pools
        cfg["workers_mode"] = "thread"
    return cfg


class _HostRTBase(AdaptiveFlushMixin):
    """Stage → step → deliver dispatch shared by the host runtimes.

    ``process(batch) -> (ts_list, rows)`` is implemented per engine; rows
    carry per-row event timestamps end to end."""

    callback = None
    driver = None               # host path is synchronous (no device queue)

    def add_callback(self, fn):
        self.callback = fn

    def deliver(self, out):
        fn = self.callback
        if fn is not None and out is not None and getattr(out, "n", 0):
            fn(out)

    def flush(self):
        if len(self.builder) == 0:
            return
        b = self.builder.emit()
        b["_cause"] = self._take_cause()
        self.deliver(self._timed_process(b))

    def finalize(self):
        self.flush()


class HostQueryBridge:
    """Junction subscriber feeding a columnar host runtime; outputs re-enter
    the engine through the query's output junction with per-row timestamps."""

    def __init__(self, kind: str, runtime, app_context, stream_ids: list[str],
                 output_junction, query_name: str):
        self.kind = kind              # 'host_stream' | 'host_nfa' | 'host_partition'
        self.runtime = runtime
        self.app_context = app_context
        self.stream_ids = stream_ids
        self.output_junction = output_junction
        self.query_name = query_name
        self.query_callbacks: list = []
        self.events_in = 0
        self.batches = 0
        runtime.add_callback(self._on_out)
        sm = app_context.statistics_manager
        self._step_tracker = (
            sm.latency_tracker(f"host_batch.{query_name}.step")
            if sm is not None else None)
        self._wrap_metrics()

    def _wrap_metrics(self):
        inner = self.runtime.process
        bridge = self

        def process(batch):
            t0 = time.perf_counter()
            try:
                return inner(batch)
            finally:
                bridge.batches += 1
                n = batch.get("count", 0)
                bridge.events_in += n
                tr = bridge._step_tracker
                if tr is not None:
                    tr.record_seconds(time.perf_counter() - t0)

        self.runtime.process = process

    # -- junction receivers ---------------------------------------------------
    def receiver_for(self, stream_id: str):
        bridge = self
        rt = self.runtime

        class _R:
            def receive(self, event: StreamEvent) -> None:
                if event.type is not EventType.CURRENT:
                    return
                rt.builder.append(stream_id, event.data, event.timestamp)
                rt._maybe_flush()

            def receive_chunk(self, events: list) -> None:
                # a delivered chunk IS a micro-batch: stage in bulk, flush at
                # chunk end so chunked ingress observes outputs synchronously
                if any(e.type is not EventType.CURRENT for e in events):
                    events = [e for e in events
                              if e.type is EventType.CURRENT]
                    if not events:
                        return
                rt.builder.append_events(stream_id, events)
                rt.flush()

            def receive_rows(self, rows: list, timestamps) -> None:
                # zero-wrap delivery (StreamJunction.deliver_rows): raw rows
                # straight into the SoA stager, one step per chunk
                rt.builder.append_rows(stream_id, rows, timestamps)
                rt.flush()

            def receive_columns(self, cols: dict, ts, n: int) -> None:
                # zero-object delivery (StreamJunction.deliver_columns):
                # the whole columnar chunk stages as-is — no per-row
                # Python anywhere between transport bytes and the step
                rt.builder.append_columns(stream_id, cols, ts)
                rt.flush()

        return _R()

    def flush(self, cause: str = "drain") -> None:
        if len(self.runtime.builder):
            self.runtime._count_flush(cause)
        self.runtime.flush()

    def finalize(self) -> None:
        self.flush(cause="final")
        self.runtime.finalize()

    # -- output ---------------------------------------------------------------
    def _on_out(self, out) -> None:
        """``out`` is a :class:`~siddhi_tpu_torch.core.columns.ColumnsOut`: the
        zero-object egress hands decoded columns straight to a
        columns-capable output junction (rows-capable sinks); everything
        else falls back to per-event materialization."""
        if out is None or not out.n:
            return
        oj = self.output_junction
        if not self.query_callbacks:
            if oj is None:
                return
            if oj.columns_capable():
                self._deliver_columns_out(out, oj)
                return
        self._deliver_events_out(out, oj)

    def _deliver_columns_out(self, out, oj) -> None:
        # zero-object egress: dictionary codes decode to value columns (one
        # vectorized take per string column), no Event/StreamEvent builds
        oj.deliver_columns(out.decoded(), np.asarray(out.ts, dtype=np.int64),
                           out.n)

    def _deliver_events_out(self, out, oj) -> None:
        ts_list, rows = out.ts_list(), out.rows()
        events = [StreamEvent(ts, row, EventType.CURRENT)
                  for ts, row in zip(ts_list, rows)]
        if not events:
            return
        if self.query_callbacks:
            evs = [Event(e.timestamp, e.data) for e in events]
            for cb in self.query_callbacks:
                cb.receive(events[-1].timestamp, evs, None)
        if oj is not None:
            oj.send_events(events)

    def report(self) -> dict:
        return {"query": self.query_name, "engine": "columnar",
                "kind": self.kind, "events": self.events_in,
                "batches": self.batches}


class _HostBridgeState:
    """Snapshot adapter (registered in the app state registry)."""

    def __init__(self, bridge: HostQueryBridge):
        self.bridge = bridge

    def snapshot_state(self):
        self.bridge.flush()
        return self.bridge.runtime.snapshot_state()

    def restore_state(self, state):
        self.bridge.runtime.restore_state(state)


# ---------------------------------------------------------------------------
# runtimes
# ---------------------------------------------------------------------------

def _audit_query_surface(query: Query, app_context, get_junction):
    """Shared lowering gate (mirrors the device bridge's full-surface audit):
    anything the columnar engine does not model must raise → scalar path."""
    from ..gpu.expr_compile import DeviceCompileError

    sel = query.selector
    if sel is not None and (sel.order_by or sel.limit is not None
                            or sel.offset is not None):
        raise DeviceCompileError(
            "order by / limit / offset keep the scalar interpreter")
    if query.output_rate is not None:
        raise DeviceCompileError(
            "output rate limiting keeps the scalar interpreter")
    if not isinstance(query.output_stream, InsertIntoStream):
        raise DeviceCompileError(
            "host fast path handles insert-into-stream outputs only")
    if query.output_stream.events_for != OutputEventsFor.CURRENT_EVENTS:
        raise DeviceCompileError(
            "expired/all-events outputs keep the scalar interpreter")
    if query.output_stream.is_fault_stream or \
            query.output_stream.is_inner_stream:
        raise DeviceCompileError(
            "fault/inner-stream outputs keep the scalar interpreter")
    from .device_bridge import _input_single_streams
    for s in _input_single_streams(query.input_stream):
        if s.is_fault_stream or s.is_inner_stream:
            raise DeviceCompileError(
                "fault/inner input streams keep the scalar interpreter")
    tid = query.output_stream.target_id
    if tid in app_context.tables or tid in app_context.named_windows:
        raise DeviceCompileError(
            f"host fast path cannot target table/window '{tid}'")
    return get_junction(tid, query.output_stream.is_inner_stream)


def _numpy_cols(cols: dict) -> dict:
    """An engine's output tensors as numpy columns, zero-copy (the
    egress's ``ColumnsOut`` decodes numpy)."""
    return {k: v.numpy() for k, v in cols.items()}


class _HostStreamRT(_HostRTBase):
    def __init__(self, compiled, hq, capacity: int):
        from ..gpu.host_exec import HostRowStager
        self.compiled = compiled
        self.hq = hq
        self.builder = HostRowStager(compiled.schema, None, capacity)
        self.state = hq.init_state()

    def process(self, b):
        from .columns import ColumnsOut
        self.state, res = self.hq.step(self.state, b["cols"], b["ts"])
        return ColumnsOut(res["ts"].numpy(), _numpy_cols(res["out"]),
                          int(res["ts"].shape[0]), self.hq.out_specs,
                          self.compiled.schema.dictionaries)

    def snapshot_state(self):
        return {"hq": self.hq.snapshot_state(self.state),
                "dict": self.compiled.schema.snapshot_dictionaries()}

    def restore_state(self, st):
        self.compiled.schema.restore_dictionaries(st.get("dict", {}))
        self.state = self.hq.restore_state(st["hq"])


class _HostNFART(_HostRTBase):
    def __init__(self, compiler, engine, stream_defs, capacity: int):
        from ..gpu.host_exec import HostRowStager
        self.compiler = compiler
        self.engine = engine
        self.builder = HostRowStager(compiler.merged, stream_defs, capacity,
                                     used_cols=compiler.used_cols)
        self.state = engine.init_state()

    def process(self, b):
        from .columns import ColumnsOut
        self.state, outs = self.engine.step(
            self.state, b["cols"], b["tag"], b["ts"])
        if not outs or outs["j"].numel() == 0:
            return None
        outs = _numpy_cols(outs)
        return ColumnsOut(outs["ts"], outs, int(outs["j"].size),
                          self.engine.out_specs,
                          self.compiler.merged.dictionaries)

    def snapshot_state(self):
        return self.engine.snapshot_state(self.state)

    def restore_state(self, st):
        self.state = self.engine.restore_state(st)


class _HostPartitionRT(_HostRTBase):
    def __init__(self, prt, stream_defs, capacity: int):
        from ..gpu.host_exec import HostRowStager
        self.prt = prt
        self.builder = HostRowStager(prt.compiler.merged, stream_defs,
                                     capacity,
                                     used_cols=prt.compiler.used_cols)

    def process(self, b):
        from .columns import ColumnsOut
        j, outs = self.prt.process(b)
        if not outs:
            return None
        outs = _numpy_cols(outs)
        return ColumnsOut(outs["ts"], outs, int(j.numel()),
                          self.prt.engine.out_specs,
                          self.prt.compiler.merged.dictionaries)

    def finalize(self):
        self.flush()
        self.prt.close()            # release the workers thread pool

    def snapshot_state(self):
        return self.prt.snapshot_state()

    def restore_state(self, st):
        self.prt.restore_state(st)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def _app_plan_key(query: Query, stream_defs: dict, kind: str):
    """Shape-and-constants key for the per-APP plan cache: two queries in
    one app that lower to the SAME program (identical shape AND identical
    constants/overrides on the same streams) share one compiled plan —
    state, stagers and junction wiring stay per query. Cross-app sharing is
    the fleet's job (per-tenant parameter slots); within one app the
    constants must match exactly, so the plan needs no slots."""
    try:
        from ..fleet.shape import normalize_query
        nq = normalize_query(query, stream_defs)
    except Exception:       # noqa: BLE001 — no shape → no dedupe, solo build
        return None
    if nq.kind != kind:
        return None
    try:
        return (nq.shape_key, tuple(nq.param_values),
                tuple(sorted(nq.overrides.items())), tuple(nq.stream_ids))
    except TypeError:       # unhashable constant — skip dedupe
        return None


def _app_plan_cache(app_context) -> dict:
    c = getattr(app_context, "_host_plan_cache", None)
    if c is None:
        c = app_context._host_plan_cache = {}
    return c


def _guard_host_bridge(bridge, query, app_context, stream_defs,
                       get_junction) -> None:
    """Containment for the columnar step (``resilience/fleet_guard.py``
    HostStepGuard): a failing micro-batch replays through the scalar
    interpreter and repeated failures quarantine the columnar path —
    the host-tier analog of the DeviceGuard wrap."""
    resilience = getattr(getattr(app_context, "runtime", None),
                         "resilience", None)
    if resilience is not None:
        resilience.guard_host(bridge, query, stream_defs, get_junction)


def try_build_host_query(query: Query, app_context, stream_defs: dict,
                         get_junction, name: str, cfg: Optional[dict],
                         guard: bool = True) -> Optional[HostQueryBridge]:
    """Columnar host bridge for one top-level query, or None → scalar path.

    Tried AFTER the device path (``@device`` wins when both apply): an
    app-level config (``cfg``) or a query-level ``@host_batch`` annotation
    opts in; ``strict='true'`` raises the lowering error instead of falling
    back."""
    from ..gpu.expr_compile import DeviceCompileError

    ann = find_annotation(query.annotations, "host_batch")
    if ann is None and cfg is None:
        return None
    strict = ann is not None and (ann.get("strict") or "").lower() == "true"
    batch = int((ann.get("batch") if ann is not None and ann.get("batch")
                 else (cfg or {}).get("batch", _DEF_BATCH)))
    try:
        target = _audit_query_surface(query, app_context, get_junction)
        ist = query.input_stream
        if isinstance(ist, SingleInputStream):
            from ..gpu.host_exec import HostStreamQuery
            from ..gpu.query_compile import CompiledStreamQuery
            d = stream_defs.get(ist.stream_id)
            if d is None:
                raise DeviceCompileError(
                    f"undefined stream '{ist.stream_id}'")
            pkey = _app_plan_key(query, stream_defs, "stream")
            cache = _app_plan_cache(app_context)
            shared = cache.get(pkey) if pkey is not None else None
            if shared is None:
                compiled = CompiledStreamQuery(query, d, host=True)
                hq = HostStreamQuery(compiled)
                if pkey is not None:
                    cache[pkey] = (compiled, hq)
            else:
                compiled, hq = shared
            rt = _HostStreamRT(compiled, hq, batch)
            bridge = HostQueryBridge("host_stream", rt, app_context,
                                     [ist.stream_id], target, name)
            bridge.output_schema = ([s.name for s in compiled.specs],
                                    [s.dtype for s in compiled.specs])
        elif isinstance(ist, StateInputStream):
            from ..gpu.host_exec import HostBlockNFA
            from ..gpu.nfa import DeviceNFACompiler
            pkey = _app_plan_key(query, stream_defs, "nfa")
            cache = _app_plan_cache(app_context)
            shared = cache.get(pkey) if pkey is not None else None
            if shared is None:
                compiler = DeviceNFACompiler(query, stream_defs, host=True)
                engine = HostBlockNFA(compiler)
                if pkey is not None:
                    cache[pkey] = (compiler, engine)
            else:
                compiler, engine = shared
            rt = _HostNFART(compiler, engine, stream_defs, batch)
            bridge = HostQueryBridge("host_nfa", rt, app_context,
                                     compiler.compiled.stream_ids, target,
                                     name)
            bridge.output_schema = ([n for n, _, _ in compiler.out_specs],
                                    [t for _, _, t in compiler.out_specs])
        else:
            raise DeviceCompileError(
                "joins keep the scalar interpreter on the host fast path")
    except DeviceCompileError as e:
        if strict:
            raise
        log.info("query '%s' keeps the scalar interpreter: %s", name, e)
        return None
    _attach_adaptive(rt, app_context, batch)
    app_context.register_state(f"host-{name}", _HostBridgeState(bridge))
    if guard:
        _guard_host_bridge(bridge, query, app_context, stream_defs,
                           get_junction)
    return bridge


def try_build_host_partition(partition_ast, app_context, stream_defs: dict,
                             get_junction, name: str,
                             cfg: dict) -> Optional[list[HostQueryBridge]]:
    """Columnar bridges for a ``partition with (key of Stream)`` block whose
    queries are ALL blocked-NFA-eligible patterns; None → the per-key
    interpreter ``PartitionRuntime``. All-or-nothing per partition: inner
    streams and mixed engines inside one partition would need cross-engine
    state the fallback contract does not cover."""
    from ..gpu.expr_compile import DeviceCompileError
    from ..gpu.host_exec import HostPartitionedNFA

    try:
        if len(partition_ast.partition_types) != 1:
            raise DeviceCompileError(
                "multi-stream partitions keep the per-key interpreter")
        pt = partition_ast.partition_types[0]
        if getattr(pt, "value_expr", None) is None or \
                not isinstance(pt.value_expr, Variable) or \
                pt.value_expr.stream_index is not None:
            raise DeviceCompileError(
                "range/expression partitions keep the per-key interpreter")
        key_attr = pt.value_expr.attribute
        bridges = []
        for i, q in enumerate(partition_ast.queries):
            qname = q.name() or f"{name}-query-{i}"
            target = _audit_query_surface(q, app_context, get_junction)
            ist = q.input_stream
            if not isinstance(ist, StateInputStream):
                raise DeviceCompileError(
                    "non-pattern partition queries keep the per-key "
                    "interpreter")
            source = None
            if cfg.get("source_text") is not None \
                    and cfg.get("part_index") is not None:
                # identity a lane-pool child needs to rebuild this exact
                # engine: re-parse the SAME text, pick the SAME query
                source = {"app_text": cfg["source_text"],
                          "part_index": cfg["part_index"],
                          "query_index": i,
                          "key_attr": key_attr}
            prt = HostPartitionedNFA(q, stream_defs, key_attr,
                                     num_partitions=cfg.get(
                                         "lanes", _DEF_LANES),
                                     workers=cfg.get("workers", 1),
                                     workers_mode=cfg.get("workers_mode",
                                                          "thread"),
                                     source=source)
            rt = _HostPartitionRT(prt, stream_defs,
                                  cfg.get("batch", _DEF_BATCH))
            bridge = HostQueryBridge(
                "host_partition", rt, app_context,
                prt.compiler.compiled.stream_ids, target, qname)
            bridge.output_schema = (
                [n for n, _, _ in prt.compiler.out_specs],
                [t for _, _, t in prt.compiler.out_specs])
            if target is not None and not target.definition.attributes:
                from ..query_api.definition import StreamDefinition
                d = StreamDefinition(q.output_stream.target_id)
                for n, t in zip(*bridge.output_schema):
                    d.attribute(n, t)
                target.definition = d
            bridges.append(bridge)
    except DeviceCompileError as e:
        log.info("partition '%s' keeps the per-key interpreter: %s", name, e)
        return None
    for bridge, q in zip(bridges, partition_ast.queries):
        _attach_adaptive(bridge.runtime, app_context, cfg.get("batch",
                                                              _DEF_BATCH))
        app_context.register_state(f"host-{bridge.query_name}",
                                   _HostBridgeState(bridge))
        _guard_host_bridge(bridge, q, app_context, stream_defs,
                           get_junction)
    return bridges


def _attach_adaptive(rt, app_context, batch: int) -> None:
    """@app:adaptive: the flow layer's AIMD controller picks the flush
    threshold for the columnar micro-batches too (same controller the
    device bridges use)."""
    if app_context.adaptive_cfg is None:
        return
    from ..flow.adaptive_batch import AdaptiveBatchController
    cfg = dict(app_context.adaptive_cfg)
    cfg["max_batch"] = min(cfg.get("max_batch", batch), batch)
    cfg["min_batch"] = min(cfg.get("min_batch", 64), cfg["max_batch"])
    rt.batch_controller = AdaptiveBatchController(**cfg)


# ---------------------------------------------------------------------------
# resilience fallback (DeviceGuard quarantine / shadow replay)
# ---------------------------------------------------------------------------

class HostFallbackRuntime:
    """QueryRuntime-shaped wrapper the DeviceGuard replays shadows into:
    exposes ``subscriptions`` receivers that stage rows columnar; the guard
    calls ``flush()`` after each replayed batch so outputs surface
    immediately. Falls out of ``build_host_fallback`` only when the query
    lowers — otherwise the guard keeps the scalar interpreter runtime."""

    def __init__(self, bridge: HostQueryBridge):
        self.bridge = bridge
        self.subscriptions = [(sid, bridge.receiver_for(sid))
                              for sid in bridge.stream_ids]
        self.callback_adapter = bridge      # .query_callbacks shared below

    def start(self) -> None:
        pass

    def flush(self) -> None:
        self.bridge.flush(cause="fallback")


def build_host_fallback(query: Query, app_context, stream_defs: dict,
                        get_junction, name: str) -> Optional[HostFallbackRuntime]:
    # guard=False: this bridge IS a guard's fallback engine (DeviceGuard
    # quarantine) — wrapping it in a HostStepGuard would nest containment
    bridge = try_build_host_query(query, app_context, stream_defs,
                                  get_junction, name,
                                  {"batch": _DEF_BATCH}, guard=False)
    if bridge is None:
        return None
    return HostFallbackRuntime(bridge)
