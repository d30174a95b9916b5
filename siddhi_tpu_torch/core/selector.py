"""QuerySelector: projection, aggregation, group-by, having, order-by/limit.

Reference: ``core/query/selector/QuerySelector.java`` (processGroupBy:207,
processInBatchGroupBy:315), ``GroupByKeyGenerator``, ``OrderByEventComparator``.
The reference's ThreadLocal group-by flow keys become explicit per-key aggregator
maps here (batch-synchronous, no thread-locals).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..query_api import (
    AttributeFunction,
    DataType,
    OrderByOrder,
    Selector,
)
from .aggregators import (
    AGGREGATOR_NAMES,
    Aggregator,
    aggregator_return_type,
    make_aggregator,
)
from .event import EventType, JoinedEvent, PatternEvent, StateEvent, StreamEvent
from .executor import ExecutorBuilder, JoinFrame, RowFrame, StateFrame, StreamFrame


class AttributeSpec:
    """One output column: stateless expression or stateful aggregation."""

    def __init__(self, name: str, dtype: DataType,
                 value_fn: Optional[Callable] = None,
                 agg_name: Optional[str] = None,
                 agg_arg_fn: Optional[Callable] = None,
                 agg_arg_type: Optional[DataType] = None,
                 agg_filter_fn: Optional[Callable] = None):
        self.name = name
        self.dtype = dtype
        self.value_fn = value_fn          # stateless path
        self.agg_name = agg_name          # stateful path
        self.agg_arg_fn = agg_arg_fn
        self.agg_arg_type = agg_arg_type
        self.agg_filter_fn = agg_filter_fn

    @property
    def is_aggregate(self) -> bool:
        return self.agg_name is not None


def make_frame(ev: StreamEvent):
    if isinstance(ev, PatternEvent):
        return StateFrame(ev.state_event)
    if isinstance(ev, JoinedEvent):
        return JoinFrame(ev.left, ev.right, ev.timestamp)
    return StreamFrame(ev)


class QuerySelector:
    def __init__(self, attributes: list[AttributeSpec],
                 group_by_fns: list[Callable],
                 having_fn: Optional[Callable],
                 order_by: list[tuple[int, OrderByOrder]],
                 limit: Optional[int], offset: Optional[int],
                 element_id: str = "selector"):
        self.attributes = attributes
        self.group_by_fns = group_by_fns
        self.having_fn = having_fn
        self.order_by = order_by            # (output position, order)
        self.limit = limit
        self.offset = offset
        self.element_id = element_id
        self.has_aggregates = any(a.is_aggregate for a in attributes)
        # batching-window upstream (lengthBatch/timeBatch/...): aggregated
        # chunks collapse to the LAST surviving row — last per key under
        # group-by (reference QuerySelector.processInBatchNoGroupBy:271 /
        # processInBatchGroupBy:315). Set by the query builder.
        self.batching = False
        # which event kinds the query OUTPUTS (``insert [all|expired]
        # events``) — the collapse's "last SURVIVING event" honors this
        # (reference currentOn/expiredOn gating inside the selector); the
        # per-event paths keep gating downstream in the output callback
        self.current_on = True
        self.expired_on = True
        # group key -> {attr index -> Aggregator}
        self.agg_states: dict[Any, dict[int, Aggregator]] = {}
        self.next = None                    # rate limiter / output callback

    @property
    def output_names(self) -> list[str]:
        return [a.name for a in self.attributes]

    @property
    def output_types(self) -> list[DataType]:
        return [a.dtype for a in self.attributes]

    def _group_key(self, frame) -> Any:
        if not self.group_by_fns:
            return None
        return tuple(fn(frame) for fn in self.group_by_fns)

    def _aggs_for(self, key: Any) -> dict[int, Aggregator]:
        aggs = self.agg_states.get(key)
        if aggs is None:
            aggs = {
                i: make_aggregator(a.agg_name, a.agg_arg_type)
                for i, a in enumerate(self.attributes)
                if a.is_aggregate
            }
            self.agg_states[key] = aggs
        return aggs

    def process(self, events: list[StreamEvent]) -> None:
        collapse = self.batching and (self.has_aggregates or
                                      bool(self.group_by_fns))
        out: list[StreamEvent] = []
        out_keys: list = []
        for ev in events:
            if ev.type == EventType.RESET:
                for aggs in self.agg_states.values():
                    for a in aggs.values():
                        a.reset()
                continue
            if ev.type == EventType.TIMER:
                continue
            frame = make_frame(ev)
            key = self._group_key(frame) if self.group_by_fns or \
                (self.has_aggregates or collapse) else None
            data: list = []
            aggs = self._aggs_for(key) if self.has_aggregates else {}
            for i, spec in enumerate(self.attributes):
                if spec.is_aggregate:
                    agg = aggs[i]
                    if spec.agg_filter_fn is None or bool(spec.agg_filter_fn(frame)):
                        v = spec.agg_arg_fn(frame) if spec.agg_arg_fn else None
                        if ev.type == EventType.CURRENT:
                            agg.add(v)
                        elif ev.type == EventType.EXPIRED:
                            agg.remove(v)
                    data.append(agg.value())
                else:
                    data.append(spec.value_fn(frame))
            if self.having_fn is not None:
                if not bool(self.having_fn(
                        HavingFrame(data, ev.timestamp, frame))):
                    continue
            oev = StreamEvent(ev.timestamp, data, ev.type)
            if self.group_by_fns:
                # reference GroupedComplexEvent: grouped first/last rate
                # limiters downstream batch per key
                oev.group_key = key
            out.append(oev)
            out_keys.append(key)
        if not out:
            return
        if collapse:
            # one row per batch chunk: the last surviving event (last per
            # key under group-by, first-seen key order — the reference's
            # LinkedHashMap). Surviving = passing the query's output-kind
            # gate, so `insert into` never collapses onto an expired row.
            pairs = [(ev, key) for ev, key in zip(out, out_keys)
                     if (ev.type == EventType.CURRENT and self.current_on)
                     or (ev.type == EventType.EXPIRED and self.expired_on)]
            if self.group_by_fns:
                last_by_key: dict = {}
                for ev, key in pairs:
                    last_by_key[key] = ev
                out = list(last_by_key.values())
            else:
                out = [pairs[-1][0]] if pairs else []
            if not out:
                return
        if self.order_by or self.limit is not None \
                or self.offset is not None:
            # the reference removes non-output event kinds INSIDE the
            # selector before order/limit (processNoGroupBy's gate) — a
            # mixed [expired..., current...] flush chunk must not have its
            # limit slots consumed by rows the query never outputs
            out = [ev for ev in out
                   if (ev.type == EventType.CURRENT and self.current_on)
                   or (ev.type == EventType.EXPIRED and self.expired_on)]
        out = self._order_limit(out)
        if self.next is not None and out:
            self.next.process(out)

    def _order_limit(self, events: list[StreamEvent]) -> list[StreamEvent]:
        if self.order_by:
            def keyf(ev):
                ks = []
                for pos, order in self.order_by:
                    v = ev.data[pos]
                    ks.append(_Rev(v) if order == OrderByOrder.DESC else v)
                return tuple(ks)
            events = sorted(events, key=keyf)
        if self.offset is not None:
            events = events[self.offset:]
        if self.limit is not None:
            events = events[: self.limit]
        return events

    # -- state ----------------------------------------------------------------
    def snapshot_state(self) -> dict:
        return {
            "aggs": {
                repr(key): {i: a.snapshot() for i, a in aggs.items()}
                for key, aggs in self.agg_states.items()
            },
            "keys": list(self.agg_states.keys()),
        }

    def restore_state(self, state: dict) -> None:
        self.agg_states = {}
        for key in state["keys"]:
            aggs = self._aggs_for(key)
            saved = state["aggs"][repr(key)]
            for i, a in aggs.items():
                a.restore(saved[i])


class HavingFrame:
    """Evaluation frame for having conditions: the projected output row
    (``.data`` — RowFrame protocol) plus the pre-projection input frame
    (``.src``) for input-attribute references."""
    __slots__ = ("data", "ts", "src")

    def __init__(self, data: list, ts: int, src):
        self.data = data
        self.ts = ts
        self.src = src

    def timestamp(self) -> int:
        return self.ts


class _HavingResolver:
    """Output aliases first (unprefixed), then the query's input resolver
    over ``frame.src`` (reference: having sees the whole meta event)."""

    def __init__(self, out_names, out_types, input_resolver):
        self.out_names = out_names
        self.out_types = out_types
        self.input_resolver = input_resolver

    def resolve(self, var):
        if var.stream_id is None and var.attribute in self.out_names:
            pos = self.out_names.index(var.attribute)
            return (lambda f: f.data[pos]), self.out_types[pos]
        fn, t = self.input_resolver.resolve(var)
        return (lambda f: fn(f.src)), t

    def encode_string(self, key, value):       # pragma: no cover - delegate
        return self.input_resolver.encode_string(key, value)


class _Rev:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        if self.v is None or other.v is None:
            return other.v is None
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


def build_selector(selector: Selector, builder: ExecutorBuilder,
                   input_names: list[str], input_types: list[DataType],
                   element_id: str = "selector") -> QuerySelector:
    """Compile a Selector AST into a QuerySelector using the given executor
    builder (whose resolver matches the query's input kind)."""
    from ..query_api import OutputAttribute, Variable

    attrs_ast = list(selector.attributes)
    if selector.select_all:
        attrs_ast = [
            OutputAttribute(None, Variable(attribute=n)) for n in input_names
        ]

    specs: list[AttributeSpec] = []
    for oa in attrs_ast:
        expr = oa.expr
        if isinstance(expr, AttributeFunction) and expr.namespace is None \
                and expr.name in AGGREGATOR_NAMES:
            if expr.args:
                arg_fn, arg_t = builder.build(expr.args[0])
            else:
                arg_fn, arg_t = (lambda f: None), None
            specs.append(AttributeSpec(
                oa.name, aggregator_return_type(expr.name, arg_t),
                agg_name=expr.name, agg_arg_fn=arg_fn, agg_arg_type=arg_t,
            ))
        else:
            fn, t = builder.build(expr)
            specs.append(AttributeSpec(oa.name, t, value_fn=fn))

    group_fns = [builder.build(v)[0] for v in selector.group_by]

    having_fn = None
    if selector.having is not None:
        # the reference's having executor sees BOTH the projected output
        # attributes and the query's input attributes (its output meta event
        # still wraps the input state — JoinTestCase.joinTest14 pins
        # `having orders.items == "item1"` over a join). Output aliases win
        # for unprefixed names; prefixed or unknown names resolve through
        # the query's own input resolver against the pre-projection frame.
        out_names = [s.name for s in specs]
        out_types = [s.dtype for s in specs]
        hb = ExecutorBuilder(
            _HavingResolver(out_names, out_types, builder.resolver),
            builder.context)
        having_fn, _ = hb.build(selector.having)

    order_by = []
    out_names = [s.name for s in specs]
    for ob in selector.order_by:
        if ob.variable.attribute not in out_names:
            raise ValueError(f"order by unknown output attribute '{ob.variable.attribute}'")
        order_by.append((out_names.index(ob.variable.attribute), ob.order))

    return QuerySelector(specs, group_fns, having_fn, order_by,
                         selector.limit, selector.offset, element_id)
