"""On-demand (store) queries: pull queries against tables / named windows.

Reference: ``core/query/OnDemandQueryRuntime`` + ``util/parser/OnDemandQueryParser``.
"""

from __future__ import annotations

from typing import Optional

from ..query_api import (
    AttributeFunction,
    OnDemandQuery,
    OnDemandQueryType,
    OutputAttribute,
    Variable,
)
from .aggregators import AGGREGATOR_NAMES, aggregator_return_type, make_aggregator
from .event import Event
from .executor import ExecutorBuilder, RowFrame, RowResolver
from .table import compile_table_condition, TableMatchFrame


class OnDemandQueryRuntime:
    def __init__(self, odq: OnDemandQuery, app_context):
        self.odq = odq
        self.app_context = app_context

    def execute(self) -> list[Event]:
        odq = self.odq
        ctx = self.app_context
        now = ctx.current_time()
        store_id = odq.input_store_id

        if odq.type == OnDemandQueryType.INSERT:
            target = odq.output_stream.target_id
            table = ctx.get_table(target)
            builder = ExecutorBuilder(RowResolver([], []), ctx)
            row = [builder.build(a.expr)[0](RowFrame([], now))
                   for a in odq.selector.attributes]
            table.add([row], now)
            return []

        # resolve rows from table or named window
        if store_id in ctx.tables:
            table = ctx.get_table(store_id)
            names = table.definition.attribute_names
            types = [a.type for a in table.definition.attributes]
            # the `on` may sit on the query or on its table action; no "matching
            # event" side exists in on-demand queries: all refs bind to rows
            on = odq.on_condition or getattr(odq.output_stream, "on_condition", None)
            cond = compile_table_condition(table, on, [], [], ctx)
            if odq.type == OnDemandQueryType.DELETE:
                if cond is not None:
                    table.delete(cond, [], now)
                else:
                    table.restore_state({"rows": []})
                return []
            if odq.type in (OnDemandQueryType.UPDATE, OnDemandQueryType.UPDATE_OR_INSERT):
                setters = []
                for sa in odq.output_stream.set_attributes:
                    pos = table.definition.attribute_position(sa.table_variable.attribute)
                    b = ExecutorBuilder(
                        RowResolver(names, types, table.definition.id), ctx)
                    fn, _ = b.build(sa.value_expr)
                    setters.append((pos, lambda f, fn=fn: fn(RowFrame(f.row or []))))
                if odq.type == OnDemandQueryType.UPDATE:
                    table.update(cond, [], setters, now)
                else:
                    table.update_or_add(cond, [], setters, now)
                return []
            # hand the compiled condition to the table: record stores push it
            # down (StoreExpression), in-memory tables use the PK fast path
            rows = [list(r) for r in table.find(cond, None, now)]
        elif store_id in ctx.named_windows:
            nw = ctx.named_windows[store_id]
            names = nw.definition.attribute_names
            types = [a.type for a in nw.definition.attributes]
            rows = [list(e.data) for e in nw.find_events()]
            if odq.on_condition is not None:
                b = ExecutorBuilder(RowResolver(names, types), ctx)
                fn, _ = b.build(odq.on_condition)
                rows = [r for r in rows if bool(fn(RowFrame(r, now)))]
        elif store_id in ctx.aggregations:
            return ctx.aggregations[store_id].on_demand_find(odq, now)
        else:
            raise KeyError(f"no table/window/aggregation '{store_id}'")

        return self._select(rows, names, types, now)

    # -- FIND projection with optional fold-style aggregation ----------------
    def _select(self, rows: list[list], names: list[str], types, now: int) -> list[Event]:
        sel = self.odq.selector
        builder = ExecutorBuilder(RowResolver(names, types), self.app_context)

        attrs = list(sel.attributes)
        if sel.select_all or not attrs:
            attrs = [OutputAttribute(None, Variable(attribute=n)) for n in names]

        has_agg = any(
            isinstance(a.expr, AttributeFunction) and a.expr.namespace is None
            and a.expr.name in AGGREGATOR_NAMES for a in attrs
        )
        group_fns = [builder.build(v)[0] for v in sel.group_by]

        if not has_agg:
            fns = [builder.build(a.expr)[0] for a in attrs]
            out = []
            for r in rows:
                frame = RowFrame(r, now)
                out.append(Event(now, [fn(frame) for fn in fns]))
            return self._post(out, attrs, now)

        # fold aggregation per group
        groups: dict = {}
        order: list = []
        for r in rows:
            frame = RowFrame(r, now)
            key = tuple(fn(frame) for fn in group_fns) if group_fns else None
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(r)

        # compile each attribute once; fold per group
        compiled = []
        for a in attrs:
            e = a.expr
            if isinstance(e, AttributeFunction) and e.namespace is None \
                    and e.name in AGGREGATOR_NAMES:
                arg_fn, arg_t = builder.build(e.args[0]) if e.args \
                    else ((lambda f: None), None)
                compiled.append(("agg", e.name, arg_fn, arg_t))
            else:
                compiled.append(("value", None, builder.build(e)[0], None))
        out = []
        for key in order:
            grows = groups[key]
            data = []
            for kind, agg_name, fn, arg_t in compiled:
                if kind == "agg":
                    agg = make_aggregator(agg_name, arg_t)
                    for r in grows:
                        agg.add(fn(RowFrame(r, now)))
                    data.append(agg.value())
                else:
                    data.append(fn(RowFrame(grows[-1], now)))
            out.append(Event(now, data))
        return self._post(out, attrs, now)

    def _post(self, events: list[Event], attrs, now: int) -> list[Event]:
        sel = self.odq.selector
        out_names = []
        for a in attrs:
            try:
                out_names.append(a.name)
            except ValueError:
                out_names.append(f"_c{len(out_names)}")
        if sel.having is not None:
            types = [None] * len(out_names)
            from ..query_api.definition import DataType
            b = ExecutorBuilder(
                RowResolver(out_names, [DataType.OBJECT] * len(out_names)),
                self.app_context)
            fn, _ = b.build(sel.having)
            events = [e for e in events if bool(fn(RowFrame(e.data, now)))]
        if sel.order_by:
            for ob in reversed(sel.order_by):
                pos = out_names.index(ob.variable.attribute)
                events.sort(key=lambda e: (e.data[pos] is None, e.data[pos]),
                            reverse=(ob.order.value == "desc"))
        if sel.offset:
            events = events[sel.offset:]
        if sel.limit is not None:
            events = events[: sel.limit]
        return events
