"""Query planner: AST → processor chains.

Reference: ``core/util/parser/`` — ``QueryParser.parse`` (QueryParser.java:90),
``SingleInputStreamParser`` (per-stream chains), ``StateInputStreamParser`` (NFA),
``JoinInputStreamParser``, ``SelectorParser``, ``OutputParser``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..query_api import (
    Constant,
    DataType,
    DeleteStream,
    EventTrigger,
    Filter,
    InsertIntoStream,
    JoinInputStream,
    OutputEventsFor,
    Query,
    ReturnStream,
    SingleInputStream,
    StateInputStream,
    StreamFunction,
    UpdateOrInsertStream,
    UpdateStream,
    Variable,
    Window,
)
from ..query_api.definition import StreamDefinition
from .event import EventType, StreamEvent
from .executor import (
    ExecutorBuilder,
    JoinResolver,
    StateResolver,
    StreamFrame,
    StreamResolver,
)
from .join import JoinRuntime, JoinSide
from .named_window import NamedWindow
from .output import (
    DeleteTableCallback,
    FanoutProcessor,
    InsertIntoStreamCallback,
    InsertIntoTableCallback,
    InsertIntoWindowCallback,
    QueryCallbackAdapter,
    UpdateOrInsertTableCallback,
    UpdateTableCallback,
)
from .pattern import CompiledPattern, PatternCompiler, PatternRuntime
from .processors import FilterProcessor, Processor, SinkProcessor
from .ratelimit import build_rate_limiter
from .selector import build_selector
from .table import compile_table_condition
from . import windows as W


class QueryBuildError(Exception):
    pass


def _within_bound(expr) -> int:
    """One bound of a two-arg aggregation-join ``within start, end``."""
    from .aggregation import parse_within_value
    from .errors import SiddhiAppRuntimeError
    try:
        return parse_within_value(getattr(expr, "value", None))
    except (ValueError, SiddhiAppRuntimeError) as e:
        raise QueryBuildError(str(e)) from None


# ---------------------------------------------------------------------------
# Window factory
# ---------------------------------------------------------------------------

def _const(p, what: str):
    if not isinstance(p, Constant):
        raise QueryBuildError(f"{what} expects constant parameter")
    return p.value


def make_window_processor(win: Window, definition: StreamDefinition,
                          app_context, query_ctx_id: str) -> W.WindowProcessor:
    """Instantiate a window processor from its AST node.

    Reference catalog: ``query/processor/stream/window/*WindowProcessor``.
    """
    name = win.name
    params = win.params
    builder = ExecutorBuilder(StreamResolver(definition), app_context)

    def executor(i):
        return builder.build(params[i])[0]

    if name == "length":
        proc = W.LengthWindow(int(_const(params[0], "length")))
    elif name == "lengthBatch":
        proc = W.LengthBatchWindow(int(_const(params[0], "lengthBatch")))
    elif name == "time":
        proc = W.TimeWindow(int(_const(params[0], "time")))
    elif name == "timeBatch":
        start = int(_const(params[1], "timeBatch")) if len(params) > 1 else None
        proc = W.TimeBatchWindow(int(_const(params[0], "timeBatch")), start)
    elif name == "timeLength":
        proc = W.TimeLengthWindow(int(_const(params[0], "timeLength")),
                                  int(_const(params[1], "timeLength")))
    elif name == "externalTime":
        proc = W.ExternalTimeWindow(executor(0), int(_const(params[1], "externalTime")))
    elif name == "externalTimeBatch":
        start = int(_const(params[2], "externalTimeBatch")) if len(params) > 2 else None
        proc = W.ExternalTimeBatchWindow(
            executor(0), int(_const(params[1], "externalTimeBatch")), start)
    elif name == "session":
        gap = int(_const(params[0], "session"))
        key_fn = executor(1) if len(params) > 1 else None
        latency = int(_const(params[2], "session")) if len(params) > 2 else 0
        proc = W.SessionWindow(gap, key_fn, latency)
    elif name == "batch":
        proc = W.BatchWindow()
    elif name == "delay":
        proc = W.DelayWindow(int(_const(params[0], "delay")))
    elif name == "sort":
        n = int(_const(params[0], "sort"))
        key_fns, orders = [], []
        i = 1
        while i < len(params):
            key_fns.append(builder.build(params[i])[0])
            i += 1
            if i < len(params) and isinstance(params[i], Constant) \
                    and str(params[i].value).lower() in ("asc", "desc"):
                orders.append(str(params[i].value).lower())
                i += 1
            else:
                orders.append("asc")
        proc = W.SortWindow(n, key_fns, orders)
    elif name == "frequent":
        n = int(_const(params[0], "frequent"))
        key_fns = [builder.build(p)[0] for p in params[1:]] or None
        proc = W.FrequentWindow(n, key_fns)
    elif name == "lossyFrequent":
        support = float(_const(params[0], "lossyFrequent"))
        error = float(_const(params[1], "lossyFrequent")) if len(params) > 1 and \
            isinstance(params[1], Constant) and not isinstance(params[1].value, str) else None
        key_start = 2 if error is not None else 1
        key_fns = [builder.build(p)[0] for p in params[key_start:]] or None
        proc = W.LossyFrequentWindow(support, error, key_fns)
    elif name in ("expression", "expressionBatch"):
        from ..compiler.parser import Parser
        from .expression_window import (
            DynamicExpressionBatchWindow,
            DynamicExpressionWindow,
        )
        expr_text = str(_const(params[0], name))
        expr_ast = Parser(expr_text).parse_expression()
        cls = DynamicExpressionWindow if name == "expression" \
            else DynamicExpressionBatchWindow
        proc = cls(expr_ast, definition, app_context)
    elif name == "cron":
        proc = W.CronWindow(str(_const(params[0], "cron")))
    elif name == "hopping":
        proc = W.HoppingWindow(int(_const(params[0], "hopping")),
                               int(_const(params[1], "hopping")))
    elif name == "":
        proc = W.EmptyWindow()
    else:
        # extension windows
        ext = app_context.siddhi_context.extensions.get(f"window:{name}")
        if ext is None:
            raise QueryBuildError(f"unknown window type '{name}'")
        proc = ext(params, definition, app_context)
    proc.setup(app_context, app_context.element_id(f"{query_ctx_id}-window-{name}"))
    return proc


# ---------------------------------------------------------------------------
# Stream function factory
# ---------------------------------------------------------------------------

def make_stream_function(sf: StreamFunction, definition: StreamDefinition,
                         app_context):
    """Returns (processor, output_definition)."""
    key = f"{sf.namespace}:{sf.name}" if sf.namespace else sf.name
    ext = app_context.siddhi_context.extensions.get(key)
    if ext is None or getattr(ext, "extension_kind", None) != "stream_function":
        raise QueryBuildError(f"unknown stream function '{key}'")
    inst = ext()
    builder = ExecutorBuilder(StreamResolver(definition), app_context)
    param_fns = [builder.build(p)[0] for p in sf.params]
    out_def = inst.init(definition, sf.params, param_fns)
    from .processors import StreamFunctionProcessor

    def fn(ev: StreamEvent):
        return inst.process(ev, [p(StreamFrame(ev)) for p in param_fns])

    return StreamFunctionProcessor(fn), out_def


# ---------------------------------------------------------------------------
# Single-stream chain
# ---------------------------------------------------------------------------

class StreamReceiver:
    """Junction subscriber feeding a query's processor chain."""

    def __init__(self, head: Processor):
        self.head = head

    def receive(self, event: StreamEvent) -> None:
        self.head.process([event])

    def receive_chunk(self, events: list[StreamEvent]) -> None:
        self.head.process(list(events))


class ObservedReceiver:
    """Outermost receiver wrapper: per-query end-to-end latency (the
    ``query.{name}`` histogram, reference ``LatencyTracker`` sites around
    ``StreamJunction`` delivery) plus the ``query`` trace span. One level
    check per event when statistics are OFF and no trace is active."""

    def __init__(self, inner, app_context, query_name: str,
                 metric_name: Optional[str] = None):
        from .metrics import Level
        self._off = Level.OFF
        self.inner = inner
        self.app_context = app_context
        self.query_name = query_name
        sm = app_context.statistics_manager      # None on bare contexts
        # metric_name caps cardinality: partition key instances share the
        # LOGICAL query's histogram (a per-key tracker per partition key
        # would grow without bound), while trace spans keep the full name
        self.tracker = sm.latency_tracker(
            f"query.{metric_name or query_name}") if sm is not None else None

    def _observing(self):
        ctx = self.app_context
        tracer = ctx.tracer
        tr = tracer.active if tracer is not None else None
        sm = ctx.statistics_manager
        return (sm is not None and sm.level is not self._off
                and self.tracker is not None), tr

    def receive(self, event: StreamEvent) -> None:
        track, tr = self._observing()
        if not track and tr is None:
            self.inner.receive(event)
            return
        t0 = time.perf_counter_ns()
        try:
            self.inner.receive(event)
        finally:
            dt = time.perf_counter_ns() - t0
            if track:
                # a sampled trace becomes the bucket's exemplar: the tail
                # links to a concrete journey
                self.tracker.record_seconds(
                    dt / 1e9,
                    exemplar=tr.trace_id if tr is not None else None)
            if tr is not None:
                tr.add_span("query", self.query_name, dt, 1)

    def receive_chunk(self, events: list[StreamEvent]) -> None:
        track, tr = self._observing()
        if not track and tr is None:
            self.inner.receive_chunk(events)
            return
        t0 = time.perf_counter_ns()
        try:
            self.inner.receive_chunk(events)
        finally:
            dt = time.perf_counter_ns() - t0
            if track:
                self.tracker.record_seconds(
                    dt / 1e9,
                    exemplar=tr.trace_id if tr is not None else None)
            if tr is not None:
                tr.add_span("query", self.query_name, dt, len(events))


class _StageProcessor(Processor):
    """Trace-only pass-through: when a sampled trace is active, times the
    chain from here down as one ``stage`` span (span durations nest, like
    a span tree)."""

    def __init__(self, app_context, stage: str, detail: str):
        super().__init__()
        self.app_context = app_context
        self.stage = stage
        self.detail = detail

    def process(self, events):
        tracer = self.app_context.tracer
        tr = tracer.active if tracer is not None else None
        if tr is None:
            self.forward(events)
            return
        t0 = time.perf_counter_ns()
        try:
            self.forward(events)
        finally:
            tr.add_span(self.stage, self.detail,
                        time.perf_counter_ns() - t0, len(events))


class _ChainHead(Processor):
    def process(self, events):
        self.forward(events)


# windows whose flush chunks are BATCHES for the selector (reference: the
# processors extending BatchingWindowProcessor; chunks carry isBatch=true)
BATCHING_WINDOWS = frozenset(
    {"batch", "lengthBatch", "timeBatch", "externalTimeBatch", "cron",
     "expressionBatch", "hopping"})


def build_single_chain(stream: SingleInputStream, definition: StreamDefinition,
                       app_context, query_id: str):
    """Build filter/window/function chain. Returns (head, tail, effective_def,
    window_processor_or_None)."""
    head = _ChainHead()
    tail: Processor = head
    eff_def = definition
    window_proc = None
    for h in stream.handlers:
        if isinstance(h, Filter):
            builder = ExecutorBuilder(StreamResolver(eff_def), app_context)
            cond, _ = builder.build(h.expr)
            tail = tail.set_next(FilterProcessor(cond))
        elif isinstance(h, Window):
            window_proc = make_window_processor(h, eff_def, app_context, query_id)
            if app_context.tracer is not None:
                tail = tail.set_next(_StageProcessor(
                    app_context, "window", h.name or "empty"))
            tail = tail.set_next(window_proc)
        elif isinstance(h, StreamFunction):
            proc, eff_def = make_stream_function(h, eff_def, app_context)
            tail = tail.set_next(proc)
    return head, tail, eff_def, window_proc


# ---------------------------------------------------------------------------
# QueryRuntime
# ---------------------------------------------------------------------------

class QueryRuntime:
    def __init__(self, query: Query, name: str):
        self.query = query
        self.name = name
        self.callback_adapter = QueryCallbackAdapter()
        self.subscriptions: list[tuple[str, object]] = []   # (stream_id, receiver)
        self.output_schema: tuple[list[str], list[DataType]] = ([], [])
        self.pattern_runtime: Optional[PatternRuntime] = None

    def add_callback(self, cb) -> None:
        self.callback_adapter.callbacks.append(cb)

    def start(self) -> None:
        if self.pattern_runtime is not None:
            self.pattern_runtime.start()


def build_query_runtime(query: Query, app_context, stream_defs: dict,
                        get_junction: Callable, name: str,
                        inner_defs: Optional[dict] = None,
                        metric_name: Optional[str] = None) -> QueryRuntime:
    """Construct a QueryRuntime. ``get_junction(stream_id, inner)`` resolves
    junctions (partition-local for inner streams). ``metric_name`` (default:
    ``name``) keys the latency histogram — partition key instances pass the
    logical query name so cardinality stays bounded."""
    rt = QueryRuntime(query, name)
    rt.metric_name = metric_name or name
    qid = name
    ist = query.input_stream

    def stream_def(sid: str, inner: bool) -> StreamDefinition:
        defs = inner_defs if inner and inner_defs is not None else stream_defs
        if sid in app_context.named_windows:
            return app_context.named_windows[sid].definition
        if sid not in defs:
            raise QueryBuildError(f"query '{name}': undefined stream '{sid}'")
        return defs[sid]

    # ---------------- input side -------------------------------------------
    if isinstance(ist, SingleInputStream):
        sid_eff = ("!" + ist.stream_id) if ist.is_fault_stream else ist.stream_id
        d = stream_def(sid_eff, ist.is_inner_stream)
        head, tail, eff_def, _ = build_single_chain(ist, d, app_context, qid)
        selector_builder = ExecutorBuilder(StreamResolver(eff_def), app_context)
        selector = build_selector(query.selector, selector_builder,
                                  eff_def.attribute_names,
                                  [a.type for a in eff_def.attributes],
                                  app_context.element_id(f"{qid}-selector"))
        # aggregated chunks from BATCHING windows collapse to one row per
        # flush (reference QuerySelector.process:81 — isBatch chunks);
        # reading FROM a named window inherits ITS window type's batching
        # (CustomJoinWindowTestCase.testMultipleStreamsToWindow pins one
        # collapsed row per lengthBatch named-window flush)
        selector.batching = any(
            isinstance(h, Window) and h.name in BATCHING_WINDOWS
            for h in ist.handlers)
        nw_src = app_context.named_windows.get(ist.stream_id)
        if nw_src is not None:
            wh = nw_src.definition.window_handler
            if wh is not None and getattr(wh, "name", None) in BATCHING_WINDOWS:
                selector.batching = True
        ef = getattr(query.output_stream, "events_for",
                     OutputEventsFor.CURRENT_EVENTS)
        selector.current_on = ef != OutputEventsFor.EXPIRED_EVENTS
        selector.expired_on = ef != OutputEventsFor.CURRENT_EVENTS
        app_context.register_state(selector.element_id, selector)
        if app_context.tracer is not None:
            tail = tail.set_next(_StageProcessor(app_context, "selector",
                                                 name))
        tail.set_next(_SelectorBridge(selector))
        from .debugger import DebuggedReceiver
        receiver = ObservedReceiver(
            DebuggedReceiver(StreamReceiver(head), name, app_context),
            app_context, name, rt.metric_name)
        rt.subscriptions.append((sid_eff, receiver))

    elif isinstance(ist, StateInputStream):
        defs_for_pattern = dict(stream_defs)
        compiler = PatternCompiler(ist, defs_for_pattern)
        compiled = compiler.compile()
        pattern_rt = PatternRuntime(
            compiled, app_context, app_context.element_id(f"{qid}-pattern"))
        rt.pattern_runtime = pattern_rt
        resolver = StateResolver(compiled.alias_defs)
        selector_builder = ExecutorBuilder(resolver, app_context)
        # pattern output schema: alias attributes referenced via select
        names, types = _selector_schema_from_alias(compiled)
        selector = build_selector(query.selector, selector_builder, names, types,
                                  app_context.element_id(f"{qid}-selector"))
        app_context.register_state(selector.element_id, selector)
        pattern_rt.next = selector
        from .debugger import DebuggedReceiver
        from .pattern import PatternStreamReceiver
        for sid in compiled.stream_ids:
            rt.subscriptions.append((sid, ObservedReceiver(
                DebuggedReceiver(PatternStreamReceiver(pattern_rt, sid),
                                 name, app_context),
                app_context, name, rt.metric_name)))

    elif isinstance(ist, JoinInputStream):
        selector = _build_join(ist, rt, app_context, stream_defs, stream_def,
                               query, qid)
    else:
        raise QueryBuildError(f"unsupported input stream {type(ist).__name__}")

    # ---------------- output side ------------------------------------------
    out_names = selector.output_names
    out_types = selector.output_types
    rt.output_schema = (out_names, out_types)

    limiter = build_rate_limiter(query.output_rate, app_context,
                                 grouped=bool(query.selector.group_by))
    app_context.register_state(app_context.element_id(f"{qid}-ratelimit"), limiter)
    selector.next = limiter

    targets: list = [rt.callback_adapter]
    from .debugger import DebuggedOutput
    os = query.output_stream
    if isinstance(os, InsertIntoStream):
        if os.target_id in app_context.tables:
            targets.append(InsertIntoTableCallback(
                app_context.tables[os.target_id], os.events_for))
        elif os.target_id in app_context.named_windows:
            targets.append(InsertIntoWindowCallback(
                app_context.named_windows[os.target_id], os.events_for))
        else:
            junction = get_junction(os.target_id, os.is_inner_stream)
            targets.append(InsertIntoStreamCallback(junction, os.events_for))
    elif isinstance(os, DeleteStream):
        table = app_context.get_table(os.target_id)
        cond = compile_table_condition(table, os.on_condition, out_names,
                                       out_types, app_context)
        targets.append(DeleteTableCallback(table, cond))
    elif isinstance(os, (UpdateStream, UpdateOrInsertStream)):
        table = app_context.get_table(os.target_id)
        cond = compile_table_condition(table, os.on_condition, out_names,
                                       out_types, app_context)
        setters = _build_setters(os.set_attributes, table, out_names, out_types,
                                 app_context)
        cls = UpdateTableCallback if isinstance(os, UpdateStream) \
            else UpdateOrInsertTableCallback
        targets.append(cls(table, cond, setters))
    elif isinstance(os, ReturnStream) or os is None:
        pass
    limiter.next = DebuggedOutput(FanoutProcessor(targets), name, app_context)
    return rt


class _SelectorBridge(Processor):
    def __init__(self, selector):
        super().__init__()
        self.selector = selector

    def process(self, events):
        self.selector.process(events)


def _selector_schema_from_alias(compiled: CompiledPattern):
    names: list[str] = []
    types: list[DataType] = []
    for alias, d in compiled.alias_defs.items():
        for a in d.attributes:
            if a.name not in names:
                names.append(a.name)
                types.append(a.type)
    return names, types


def _build_setters(set_attributes, table, out_names, out_types, app_context):
    from .table import TableMatchResolver
    resolver = TableMatchResolver(table.definition, out_names, out_types)
    builder = ExecutorBuilder(resolver, app_context)
    setters = []
    for sa in set_attributes:
        pos = table.definition.attribute_position(sa.table_variable.attribute)
        fn, _ = builder.build(sa.value_expr)
        setters.append((pos, fn))
    if not setters:
        # no SET clause: update every column from the matching event by name
        for i, n in enumerate(out_names):
            if n in table.definition.attribute_names:
                pos = table.definition.attribute_position(n)
                setters.append((pos, lambda f, i=i: f.out[i]))
    return setters


def _record_store_find(table, table_ref, table_is_left, on_condition, builder):
    """Push the join condition down to a record store (reference
    ``AbstractQueryableRecordTable.java:99``): the store receives a
    StoreExpression once plus per-probe parameter values and returns
    pre-filtered rows. None when the table isn't record-backed, the
    condition doesn't convert, or the store declines."""
    from .table import AbstractRecordTable, CacheTable, StoreExpression, \
        build_store_tree
    backing = table.backing if isinstance(table, CacheTable) else table
    if not isinstance(backing, AbstractRecordTable) or on_condition is None:
        return None
    tdef = table.definition
    table_ids = {table_ref, tdef.id}

    def classify(var):
        if var.stream_id in table_ids:
            if var.attribute not in tdef.attribute_names:
                return "bail"
            return ("attribute", var.attribute)
        if var.stream_id is None and var.attribute in tdef.attribute_names:
            return "bail"      # ambiguous bare ref: no pushdown, host decides
        return "param"

    def build_param(expr):
        try:
            fn, _ = builder.build(expr)
        except Exception:       # noqa: BLE001
            return None
        return fn

    node, params = build_store_tree(on_condition, classify, build_param)
    if node is None:
        return None
    compiled = backing.record_compile_condition(StoreExpression(node))
    if compiled is None:
        return None
    from .event import StreamEvent as _SE
    from .executor import JoinFrame as _JF

    def find(probe_ev, t=backing, left=table_is_left):
        frame = _JF(None, probe_ev, probe_ev.timestamp) if left \
            else _JF(probe_ev, None, probe_ev.timestamp)
        p = {name: fn(frame) for name, fn in params.items()}
        return [_SE(probe_ev.timestamp, r) for r in t.record_find(p, compiled)]

    return find


def _table_pushdown_find(table, table_ref, table_is_left, on_condition, builder):
    """Compile ``T.pk == <probe expr>`` into a point lookup fn(probe_ev),
    or None if the condition has no such conjunct (falls back to scan)."""
    if on_condition is None or not hasattr(table, "pk_lookup"):
        return None
    pk_positions = getattr(table, "pk_positions", [])
    if len(pk_positions) != 1:
        return None
    pk_name = table.definition.attributes[pk_positions[0]].name
    table_ids = {table_ref, table.definition.id}
    rhs = _find_join_pk_rhs(on_condition, table_ids, pk_name,
                            table.definition.attribute_names)
    if rhs is None:
        return None
    try:
        val_fn, _ = builder.build(rhs)
    except Exception:
        return None
    from .event import StreamEvent as _SE
    from .executor import JoinFrame as _JF

    def find(probe_ev, t=table, left=table_is_left):
        frame = _JF(None, probe_ev, probe_ev.timestamp) if left \
            else _JF(probe_ev, None, probe_ev.timestamp)
        return [_SE(probe_ev.timestamp, r) for r in t.pk_lookup(val_fn(frame))]

    return find


def _find_join_pk_rhs(expr, table_ids, pk_name, table_attr_names):
    from ..query_api import And, Compare, CompareOp, Variable
    if isinstance(expr, And):
        return _find_join_pk_rhs(expr.left, table_ids, pk_name, table_attr_names) \
            or _find_join_pk_rhs(expr.right, table_ids, pk_name, table_attr_names)
    if isinstance(expr, Compare) and expr.op == CompareOp.EQ:
        for a, b in ((expr.left, expr.right), (expr.right, expr.left)):
            if isinstance(a, Variable) and a.attribute == pk_name \
                    and a.stream_id in table_ids \
                    and not _expr_touches_table(b, table_ids, table_attr_names):
                return b
    return None


def _expr_touches_table(expr, table_ids, table_attr_names):
    from ..query_api import AttributeFunction, Expression, Variable
    if isinstance(expr, Variable):
        return expr.stream_id in table_ids or \
            (expr.stream_id is None and expr.attribute in table_attr_names)
    for attr in ("left", "right", "expr"):
        sub = getattr(expr, attr, None)
        if isinstance(sub, Expression) and \
                _expr_touches_table(sub, table_ids, table_attr_names):
            return True
    if isinstance(expr, AttributeFunction):
        return any(_expr_touches_table(a, table_ids, table_attr_names)
                   for a in expr.args)
    return False


def _build_join(ist: JoinInputStream, rt: QueryRuntime, app_context,
                stream_defs: dict, stream_def_fn, query: Query, qid: str):
    sides = {}
    for label, s in (("left", ist.left), ("right", ist.right)):
        sid = s.stream_id
        if sid in app_context.aggregations:
            agg = app_context.aggregations[sid]
            if ist.per is None:
                raise QueryBuildError(
                    "aggregation join needs `per '<granularity>'`")
            from ..query_api import Constant as _Const
            w = ist.within
            dynamic = not isinstance(ist.per, _Const) or (
                isinstance(w, tuple) and not all(
                    isinstance(x, _Const) for x in w)) or (
                w is not None and not isinstance(w, tuple)
                and not isinstance(w, _Const))
            if dynamic:
                # per/within read from the DRIVING event's attributes
                # (reference Aggregation1TestCase test6: `within i.startTime,
                # i.endTime per i.perValue`) — resolved per probe in the
                # post-pass below, once both sides' schemas exist
                sides[label] = {
                    "kind": "aggregation", "def": agg.output_definition,
                    "ref": s.ref(), "find": None, "stream": s, "agg": agg,
                    "dynamic": True,
                }
                continue
            from .errors import SiddhiAppRuntimeError
            try:
                duration = agg.duration_for(ist.per.value)
            except SiddhiAppRuntimeError as e:
                raise QueryBuildError(str(e)) from None
            start = end = None
            if isinstance(w, tuple):
                start, end = _within_bound(w[0]), _within_bound(w[1])
            elif w is not None:
                from .aggregation import parse_within_single
                try:
                    start, end = parse_within_single(getattr(w, "value", None))
                except (ValueError, SiddhiAppRuntimeError) as e:
                    raise QueryBuildError(str(e)) from None
            def agg_find(agg=agg, duration=duration, start=start, end=end):
                from .event import StreamEvent as _SE
                return [_SE(r[0], r) for r in agg.rows_for(duration, start, end)]
            sides[label] = {
                "kind": "aggregation", "def": agg.output_definition,
                "ref": s.ref(), "find": agg_find, "stream": s,
            }
        elif sid in app_context.tables:
            table = app_context.tables[sid]
            sides[label] = {
                "kind": "table", "def": table.definition, "ref": s.ref(),
                "find": (lambda t=table: t.all_events()), "stream": s,
            }
        elif sid in app_context.named_windows:
            nw = app_context.named_windows[sid]
            sides[label] = {
                "kind": "window", "def": nw.definition, "ref": s.ref(),
                "find": nw.find_events, "stream": s,
            }
        else:
            d = stream_def_fn(sid, s.is_inner_stream)
            head, tail, eff_def, win = build_single_chain(s, d, app_context, qid)
            if win is None:
                win = W.EmptyWindow()
                win.setup(app_context, app_context.element_id(f"{qid}-joinwin"))
                tail = tail.set_next(win)
            sides[label] = {
                "kind": "stream", "def": eff_def, "ref": s.ref(),
                "find": win.find_events, "stream": s, "head": head, "tail": tail,
            }

    resolver = JoinResolver(sides["left"]["ref"], sides["left"]["def"],
                            sides["right"]["ref"], sides["right"]["def"])
    builder = ExecutorBuilder(resolver, app_context)
    cond_fn = None
    if ist.on_condition is not None:
        cond_fn, _ = builder.build(ist.on_condition)

    # dynamic aggregation sides: compile per/within executors over the
    # joined frame (the probe event rides its own side; the aggregation side
    # of the frame stays None) and rebuild the rollup row-set per probe
    for label, is_left in (("left", True), ("right", False)):
        side = sides[label]
        if not side.get("dynamic"):
            continue
        from ..query_api import Constant as _Const
        from .aggregation import parse_within_single, parse_within_value
        from .errors import SiddhiAppRuntimeError
        from .event import StreamEvent as _SE
        from .executor import JoinFrame as _JF

        def _valfn(e):
            if isinstance(e, _Const):
                v = e.value
                return lambda fr, v=v: v
            fn, _t = builder.build(e)
            return fn

        agg = side["agg"]
        per_fn = _valfn(ist.per)
        w = ist.within
        if isinstance(w, tuple):
            w_fns = (_valfn(w[0]), _valfn(w[1]))
            w_single = None
        elif w is not None:
            w_fns = None
            w_single = _valfn(w)
        else:
            w_fns = w_single = None
        probe_is_left = not is_left     # the driving event is the other side

        def agg_find(probe_ev=None, agg=agg, per_fn=per_fn, w_fns=w_fns,
                     w_single=w_single, probe_is_left=probe_is_left):
            ts = probe_ev.timestamp if probe_ev is not None else 0
            fr = _JF(probe_ev if probe_is_left else None,
                     None if probe_is_left else probe_ev, ts)
            try:
                duration = agg.duration_for(per_fn(fr))
                if w_fns is not None:
                    start = parse_within_value(w_fns[0](fr))
                    end = parse_within_value(w_fns[1](fr))
                elif w_single is not None:
                    start, end = parse_within_single(w_single(fr))
                else:
                    start = end = None
            except ValueError as e:
                raise SiddhiAppRuntimeError(str(e)) from None
            return [_SE(r[0], r) for r in agg.rows_for(duration, start, end)]

        side["find"] = agg_find

    within_ms = None
    if ist.per is None and ist.within is not None:
        from ..query_api import Constant as _Const
        if isinstance(ist.within, tuple) or not isinstance(ist.within, _Const):
            raise QueryBuildError(
                "stream join `within` takes a single time constant "
                "(range/expression forms apply to aggregation joins with `per`)")
        within_ms = ist.within.value
    # finds take the probing event; table sides push a PK point-lookup down
    # (reference: OperatorParser.java:64 compiles `T.pk == probe.expr` into an
    # IndexOperator instead of an exhaustive scan)
    finds = {}
    for label, is_left in (("left", True), ("right", False)):
        side = sides[label]
        fn = None
        if side["kind"] == "table":
            table = app_context.tables[side["stream"].stream_id]
            fn = _table_pushdown_find(table, side["ref"], is_left,
                                      ist.on_condition, builder)
            if fn is None:
                fn = _record_store_find(table, side["ref"], is_left,
                                        ist.on_condition, builder)
            if fn is None:
                # scan fallback stamps rows with the probe's timestamp, same
                # as the pushdown path, so `within` sees consistent times
                fn = lambda probe_ev=None, t=table: t.all_events(  # noqa: E731
                    probe_ev.timestamp if probe_ev is not None else 0)
        if fn is None:
            if side.get("dynamic"):
                fn = side["find"]          # per-probe per/within resolution
            else:
                fn = lambda probe_ev=None, f=side["find"]: f()  # noqa: E731
        finds[label] = fn
    jr = JoinRuntime(ist.join_type, ist.trigger, cond_fn,
                     finds["left"], finds["right"], within_ms)

    # selector over the combined schema
    names = (sides["left"]["def"].attribute_names
             + [n for n in sides["right"]["def"].attribute_names
                if n not in sides["left"]["def"].attribute_names])
    types = []
    for n in names:
        d = sides["left"]["def"] if n in sides["left"]["def"].attribute_names \
            else sides["right"]["def"]
        types.append(d.attribute_type(n))
    selector = build_selector(query.selector, builder, names, types,
                              app_context.element_id(f"{qid}-selector"))
    app_context.register_state(selector.element_id, selector)
    jr.next = selector

    for label, is_left in (("left", True), ("right", False)):
        side = sides[label]
        if side["kind"] == "stream":
            from .debugger import DebuggedReceiver
            side["tail"].set_next(JoinSide(jr, is_left))
            rt.subscriptions.append((side["stream"].stream_id, ObservedReceiver(
                DebuggedReceiver(StreamReceiver(side["head"]), rt.name,
                                 app_context),
                app_context, rt.name,
                getattr(rt, "metric_name", rt.name))))
        elif side["kind"] == "window":
            nw = app_context.named_windows[side["stream"].stream_id]
            bridge = _ChainHead()
            bridge.set_next(JoinSide(jr, is_left))
            nw.subscribe(StreamReceiver(bridge))
        # table sides are passive: probed only
    return selector
