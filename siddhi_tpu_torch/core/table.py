"""Tables: in-memory storage with primary-key/index acceleration + record SPI.

Reference: ``core/table/`` — ``InMemoryTable.java``, ``holder/IndexEventHolder.java``
(primaryKeyData map + indexData TreeMaps), ``record/AbstractRecordTable.java``
(external store SPI), compiled conditions via ``util/collection/``. The
interpreter's "compiled condition" is a closure over (row, matching event) frames;
the PK fast path mirrors IndexOperator.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional

from ..query_api import (
    Compare,
    CompareOp,
    DataType,
    Expression,
    Variable,
)
from ..query_api.annotation import find_annotation
from ..query_api.definition import TableDefinition
from .event import Event, StreamEvent
from .executor import ExecutorBuilder, VariableResolver


def _pk_key(row: list, pk_positions: list[int]) -> Any:
    """Single-PK → scalar key, composite → tuple (shared by table + cache)."""
    if len(pk_positions) == 1:
        return row[pk_positions[0]]
    return tuple(row[p] for p in pk_positions)


class TableMatchFrame:
    """Frame pairing a table row with the matching (output) event."""

    __slots__ = ("row", "out", "ts")

    def __init__(self, row: Optional[list], out: Optional[list], ts: int = 0):
        self.row = row
        self.out = out
        self.ts = ts

    def timestamp(self) -> int:
        return self.ts


class TableMatchResolver(VariableResolver):
    """``T.attr`` → row side; bare/other → matching-event side."""

    def __init__(self, table_def: TableDefinition, out_names: list[str],
                 out_types: list[DataType], stream_ref: Optional[str] = None):
        self.table_def = table_def
        self.out_names = out_names
        self.out_types = out_types
        self.stream_ref = stream_ref

    def resolve(self, var: Variable):
        sid = var.stream_id
        if sid == self.table_def.id:
            pos = self.table_def.attribute_position(var.attribute)
            return (lambda f: None if f.row is None else f.row[pos]), \
                self.table_def.attributes[pos].type
        if sid is None and var.attribute not in self.out_names \
                and var.attribute in self.table_def.attribute_names:
            pos = self.table_def.attribute_position(var.attribute)
            return (lambda f: None if f.row is None else f.row[pos]), \
                self.table_def.attributes[pos].type
        if var.attribute in self.out_names:
            pos = self.out_names.index(var.attribute)
            return (lambda f: None if f.out is None else f.out[pos]), self.out_types[pos]
        raise KeyError(f"cannot resolve '{var.attribute}' in table condition")


class _RowDependentSet(Exception):
    """Probe signal: a set expression touched a table column."""


class _RaisingRow:
    """Row stand-in whose every column access raises — used to detect
    row-dependent set expressions before a record-store update."""

    def __init__(self, table_id: str):
        self._table_id = table_id

    def __getitem__(self, i):
        raise _RowDependentSet(self._table_id)


class StoreExpression:
    """Store-visitable condition tree (the analog of the reference's
    ``ExpressionBuilder``/``ExpressionVisitor`` output handed to record
    stores, ``table/record/ExpressionBuilder.java``). Nodes:

    - ``('attribute', name)`` — a table column
    - ``('constant', value)`` — a literal
    - ``('param', name)`` — a streaming-side value, resolved per lookup and
      passed in ``condition_params``
    - ``('compare', op, lhs, rhs)`` — op in ``== != < <= > >=``
    - ``('and'|'or', lhs, rhs)``, ``('not', sub)``
    - ``('math', op, lhs, rhs)`` — op in ``+ - * / %``

    Stores walk the tree with :meth:`visit` or translate it to their native
    query language (e.g. a SQL WHERE clause).
    """

    def __init__(self, node: tuple):
        self.node = node

    def visit(self, visitor) -> Any:
        """visitor: object with ``attribute(name)``, ``constant(value)``,
        ``param(name)``, ``compare(op, l, r)``, ``logical(op, l, r)``,
        ``negate(sub)``, ``math(op, l, r)`` — called bottom-up."""
        return _visit_store_expr(self.node, visitor)

    def __repr__(self):
        return f"StoreExpression({self.node!r})"


def _visit_store_expr(node: tuple, v) -> Any:
    kind = node[0]
    if kind == "attribute":
        return v.attribute(node[1])
    if kind == "constant":
        return v.constant(node[1])
    if kind == "param":
        return v.param(node[1])
    if kind == "compare":
        return v.compare(node[1], _visit_store_expr(node[2], v),
                         _visit_store_expr(node[3], v))
    if kind in ("and", "or"):
        return v.logical(kind, _visit_store_expr(node[1], v),
                         _visit_store_expr(node[2], v))
    if kind == "not":
        return v.negate(_visit_store_expr(node[1], v))
    if kind == "math":
        return v.math(node[1], _visit_store_expr(node[2], v),
                      _visit_store_expr(node[3], v))
    raise ValueError(f"unknown store-expression node {kind!r}")


class CompiledTableCondition:
    """condition fn + optional primary-key fast path + optional store-
    pushdown form."""

    def __init__(self, fn: Callable[[TableMatchFrame], bool],
                 pk_extractor: Optional[Callable[[list], Any]] = None,
                 store_expr: Optional[StoreExpression] = None,
                 param_fns: Optional[dict] = None):
        self.fn = fn
        self.pk_extractor = pk_extractor    # out_data -> pk value
        self.store_expr = store_expr        # pushdown tree (None: host-only)
        self.param_fns = param_fns or {}    # param name -> fn(frame) -> value
        self._store_compiled: dict = {}     # per-table compiled handle cache


class Table:
    """Base table API (reference ``table/Table.java``)."""

    def __init__(self, definition: TableDefinition, app_context):
        self.definition = definition
        self.app_context = app_context
        self.id = definition.id

    def add(self, rows: list[list], ts: int = 0) -> None:
        raise NotImplementedError

    def find(self, cond: Optional[CompiledTableCondition],
             out_data: Optional[list], ts: int = 0) -> list[list]:
        raise NotImplementedError

    def contains(self, cond: CompiledTableCondition, out_data: list, ts: int = 0) -> bool:
        return bool(self.find(cond, out_data, ts))

    def delete(self, cond: CompiledTableCondition, out_data: list, ts: int = 0) -> int:
        raise NotImplementedError

    def update(self, cond: CompiledTableCondition, out_data: list,
               setters: list[tuple[int, Callable]], ts: int = 0) -> int:
        raise NotImplementedError

    def update_or_add(self, cond: CompiledTableCondition, out_data: list,
                      setters: list[tuple[int, Callable]], ts: int = 0) -> None:
        raise NotImplementedError


class InMemoryTable(Table):
    def __init__(self, definition: TableDefinition, app_context):
        super().__init__(definition, app_context)
        self.rows: list[list] = []
        # @PrimaryKey('attr'[, 'attr2']) / @Index('attr')
        self.pk_positions: list[int] = []
        pk = find_annotation(definition.annotations, "PrimaryKey")
        if pk:
            self.pk_positions = [
                definition.attribute_position(v) for v in pk.indexed_values()
            ]
        self.pk_map: dict[Any, list] = {}
        self.index_positions: list[int] = []
        for idx_ann in definition.annotations:
            if idx_ann.name.lower() == "index":
                for v in idx_ann.indexed_values():
                    self.index_positions.append(definition.attribute_position(v))
        self.indexes: dict[int, dict[Any, list[list]]] = {
            p: {} for p in self.index_positions
        }
        app_context.register_state(f"table-{self.id}", self)

    # -- helpers --------------------------------------------------------------
    def _pk_of_row(self, row: list) -> Any:
        return _pk_key(row, self.pk_positions)

    def _index_add(self, row: list) -> None:
        for p in self.index_positions:
            self.indexes[p].setdefault(row[p], []).append(row)

    def _index_remove(self, row: list) -> None:
        for p in self.index_positions:
            lst = self.indexes[p].get(row[p])
            if lst and row in lst:
                lst.remove(row)

    # -- operations -----------------------------------------------------------
    def add(self, rows: list[list], ts: int = 0) -> None:
        for r in rows:
            row = list(r)
            if self.pk_positions:
                key = self._pk_of_row(row)
                if key in self.pk_map:
                    raise ValueError(
                        f"primary key violation on table '{self.id}': {key!r}")
                self.pk_map[key] = row
            self.rows.append(row)
            self._index_add(row)

    def _candidates(self, cond: Optional[CompiledTableCondition],
                    out_data: Optional[list]) -> list[list]:
        if cond is None:
            return self.rows
        if cond.pk_extractor is not None and self.pk_positions:
            key = cond.pk_extractor(out_data)
            row = self.pk_map.get(key)
            return [row] if row is not None else []
        return self.rows

    def find(self, cond, out_data, ts: int = 0) -> list[list]:
        if cond is None:
            return [list(r) for r in self.rows]
        return [
            list(r) for r in self._candidates(cond, out_data)
            if cond.fn(TableMatchFrame(r, out_data, ts))
        ]

    def delete(self, cond, out_data, ts: int = 0) -> int:
        victims = [
            r for r in self._candidates(cond, out_data)
            if cond.fn(TableMatchFrame(r, out_data, ts))
        ]
        for r in victims:
            self.rows.remove(r)
            self._index_remove(r)
            if self.pk_positions:
                self.pk_map.pop(self._pk_of_row(r), None)
        return len(victims)

    def update(self, cond, out_data, setters, ts: int = 0) -> int:
        n = 0
        for r in self._candidates(cond, out_data):
            if cond is None or cond.fn(TableMatchFrame(r, out_data, ts)):
                self._apply_set(r, out_data, setters, ts)
                n += 1
        return n

    def _apply_set(self, row: list, out_data: list, setters, ts: int) -> None:
        if self.pk_positions:
            old_key = self._pk_of_row(row)
        self._index_remove(row)
        for pos, value_fn in setters:
            row[pos] = value_fn(TableMatchFrame(row, out_data, ts))
        self._index_add(row)
        if self.pk_positions:
            new_key = self._pk_of_row(row)
            if new_key != old_key:
                self.pk_map.pop(old_key, None)
                self.pk_map[new_key] = row

    def update_or_add(self, cond, out_data, setters, ts: int = 0) -> None:
        if self.update(cond, out_data, setters, ts) == 0:
            # insert the matching event's payload (schema-aligned)
            self.add([list(out_data)], ts)

    def contains_value(self, value: Any) -> bool:
        """`expr in Table` — single-attribute membership (first column or PK)."""
        if self.pk_positions and len(self.pk_positions) == 1:
            return value in self.pk_map
        return any(value in r for r in self.rows)

    def pk_lookup(self, key: Any) -> list[list]:
        """Single-PK point lookup (reference ``IndexOperator`` fast path)."""
        row = self.pk_map.get(key)
        return [list(row)] if row is not None else []

    def all_events(self, ts: int = 0) -> list[StreamEvent]:
        return [StreamEvent(ts, list(r)) for r in self.rows]

    # -- state ----------------------------------------------------------------
    def snapshot_state(self) -> dict:
        return {"rows": [list(r) for r in self.rows]}

    def restore_state(self, state: dict) -> None:
        self.rows = []
        self.pk_map = {}
        self.indexes = {p: {} for p in self.index_positions}
        self.add(state["rows"])


class RecordTableHandler:
    """Optional interception stage around a record store's operations
    (reference ``table/record/RecordTableHandler.java:41`` — there each op
    routes through the handler with a RecordTableHandlerCallback; here the
    underlying op arrives as the ``do`` callable and the default forwards).

    Override the ops you care about (audit, caching, latency injection);
    always return ``do(...)``'s result (or a transformed one)."""

    def init(self, app_name: str, definition: TableDefinition) -> None:
        self.app_name = app_name
        self.definition = definition
        self.id = f"{app_name}-{definition.id}-{type(self).__name__}"

    def add(self, timestamp: int, rows: list[list], do) -> None:
        return do(rows)

    def find(self, timestamp: int, params: dict, compiled, do) -> list[list]:
        return do(params, compiled)

    def delete(self, timestamp: int, params: dict, compiled, do) -> int:
        return do(params, compiled)

    def update(self, timestamp: int, params: dict, values: dict,
               compiled, do) -> int:
        return do(params, values, compiled)


class RecordTableHandlerManager:
    """Reference ``RecordTableHandlerManager`` — factory + registry of
    :class:`RecordTableHandler` instances, installed via
    ``SiddhiManager.set_record_table_handler_manager``."""

    def __init__(self):
        self.registered: dict[str, RecordTableHandler] = {}

    def generate_record_table_handler(self) -> RecordTableHandler:
        raise NotImplementedError

    def register_record_table_handler(self, element_id: str,
                                      handler: RecordTableHandler) -> None:
        self.registered[element_id] = handler

    def unregister_record_table_handler(self, element_id: str) -> None:
        self.registered.pop(element_id, None)


class AbstractRecordTable(Table):
    """External store SPI (reference ``record/AbstractRecordTable.java:57``).

    Subclass and implement the ``record_*`` hooks to back a table with an
    external store; register via the extension registry under
    ``store:<type>``. Condition pushdown (the queryable-record analog,
    ``AbstractQueryableRecordTable.java:99``): when a lookup condition
    converts to a :class:`StoreExpression`, it is offered ONCE to
    :meth:`record_compile_condition`; a store returning a non-None handle
    receives it (plus per-lookup parameter values) in ``record_find`` and
    must return pre-filtered rows. Stores that return None — the default —
    fall back to the exhaustive scan with host-side filtering.
    """

    extension_kind = "store"

    def init(self, definition: TableDefinition, options: dict) -> None:
        pass

    def record_add(self, rows: list[list]) -> None:
        raise NotImplementedError

    def record_compile_condition(self, store_expr: StoreExpression):
        """Translate a condition to a store-native form (e.g. a SQL WHERE
        template). None (default) = no pushdown; exhaustive scan."""
        return None

    def record_find(self, condition_params: dict,
                    compiled_condition=None) -> list[list]:
        raise NotImplementedError

    def record_delete(self, condition_params: dict,
                      compiled_condition=None) -> int:
        raise NotImplementedError

    def record_update(self, condition_params: dict, values: dict,
                      compiled_condition=None) -> int:
        raise NotImplementedError

    def record_purge(self, column: str, cutoff) -> bool:
        """OPTIONAL: delete rows where ``column`` < ``cutoff``; return True
        when performed. Default False — persisted aggregations then bound
        their reads by retention instead of deleting store rows."""
        return False

    def record_replace(self, match_cols: list[str], rows: list[list]) -> bool:
        """OPTIONAL upsert: delete rows whose ``match_cols`` equal an
        incoming row's, then add ``rows``; return True when performed.
        Default False — callers append and readers apply last-wins, so the
        log grows with superseded versions until the store supports this."""
        return False

    # set by the app builder when a RecordTableHandlerManager is installed
    handler: "RecordTableHandler | None" = None

    def _find_records(self, params: dict, compiled, ts: int) -> list[list]:
        # no-pushdown scans call record_find with ONE argument, as before
        # handlers existed — store subclasses may omit the optional
        # compiled_condition parameter entirely
        def do(p, c):
            return self.record_find(p, c) if c is not None \
                else self.record_find(p)
        if self.handler is not None:
            return self.handler.find(ts, params, compiled, do)
        return do(params, compiled)

    def add(self, rows, ts: int = 0) -> None:
        if self.handler is not None:
            self.handler.add(ts, rows, self.record_add)
        else:
            self.record_add(rows)

    def all_events(self, ts: int = 0) -> list[StreamEvent]:
        return [StreamEvent(ts, list(r))
                for r in self._find_records({}, None, ts)]

    def _pushdown(self, cond) -> tuple:
        """(compiled_condition | None, params dict) for this lookup."""
        if cond is None or cond.store_expr is None:
            return None, {}
        key = id(self)
        if key not in cond._store_compiled:
            cond._store_compiled[key] = \
                self.record_compile_condition(cond.store_expr)
        return cond._store_compiled[key], cond.param_fns

    def _params(self, param_fns: dict, out_data, ts: int) -> dict:
        frame = TableMatchFrame(None, out_data, ts)
        return {name: fn(frame) for name, fn in param_fns.items()}

    def find(self, cond, out_data, ts: int = 0) -> list[list]:
        compiled, param_fns = self._pushdown(cond)
        if compiled is not None:
            # the store pre-filters; rows come back final
            return self._find_records(
                self._params(param_fns, out_data, ts), compiled, ts)
        rows = self._find_records({}, None, ts)
        if cond is None:
            return rows
        return [r for r in rows if cond.fn(TableMatchFrame(r, out_data, ts))]

    def delete(self, cond, out_data, ts: int = 0) -> int:
        compiled, param_fns = self._pushdown(cond)
        if compiled is not None:
            params = self._params(param_fns, out_data, ts)
            if self.handler is not None:
                return self.handler.delete(
                    ts, params, compiled,
                    lambda p, c: self.record_delete(p, c))
            return self.record_delete(params, compiled)
        raise NotImplementedError(
            f"store table '{self.id}': delete requires condition pushdown "
            f"(record_compile_condition returned None)")

    def update(self, cond, out_data, setters, ts: int = 0) -> int:
        compiled, param_fns = self._pushdown(cond)
        if compiled is not None:
            # set values are computed ONCE per operation — row-dependent set
            # expressions (e.g. `set T.a = T.b`) would need per-row
            # evaluation the record SPI can't express. Probe each setter
            # with a row that RAISES on column access (a None row would let
            # None-tolerant expressions slip through and silently corrupt
            # every matched row).
            values = {}
            for pos, value_fn in setters:
                name = self.definition.attributes[pos].name
                try:
                    # the successful probe's value IS the operation value —
                    # re-evaluating would run side-effecting extension
                    # functions twice per update
                    values[name] = value_fn(
                        TableMatchFrame(_RaisingRow(self.id), out_data, ts))
                    continue
                except _RowDependentSet:
                    raise NotImplementedError(
                        f"store table '{self.id}': set expression for "
                        f"'{name}' references table columns — per-row set "
                        f"expressions are not expressible through the "
                        f"record-store SPI") from None
                except Exception:       # noqa: BLE001 — unrelated probe
                    pass                # failure: let the real eval decide
                values[name] = value_fn(TableMatchFrame(None, out_data, ts))
            params = self._params(param_fns, out_data, ts)
            if self.handler is not None:
                return self.handler.update(
                    ts, params, values, compiled,
                    lambda p, v, c: self.record_update(p, v, c))
            return self.record_update(params, values, compiled)
        raise NotImplementedError(
            f"store table '{self.id}': update requires condition pushdown "
            f"(record_compile_condition returned None)")


class CacheTable(Table):
    """Bounded cache in front of a record store.

    Reference: ``table/CacheTable.java`` + policy subclasses
    ``CacheTable{FIFO,LRU,LFU}.java`` — configured via
    ``@store(..., @cache(size='100', cache.policy='LRU'))``. Write-through on
    mutations; primary-key ``find``s are served from the cache on hit; scan
    results are back-filled into the cache. When the whole store fits in the
    cache (``_complete``), scans are served from the cache too.
    """

    POLICIES = ("FIFO", "LRU", "LFU")

    def __init__(self, definition: TableDefinition, app_context, backing: Table,
                 max_size: int, policy: str = "FIFO"):
        super().__init__(definition, app_context)
        policy = policy.upper()
        if policy not in self.POLICIES:
            raise ValueError(f"unknown cache policy '{policy}' "
                             f"(expected one of {self.POLICIES})")
        self.backing = backing
        self.max_size = max(1, int(max_size))
        self.policy = policy
        self.pk_positions: list[int] = []
        pk = find_annotation(definition.annotations, "PrimaryKey")
        if pk:
            self.pk_positions = [
                definition.attribute_position(v) for v in pk.indexed_values()
            ]
        from collections import OrderedDict
        self._cache: "OrderedDict[Any, list]" = OrderedDict()
        self._freq: dict[Any, int] = {}
        self._complete = False      # cache mirrors the entire store
        self.cache_hits = 0
        app_context.register_state(f"table-cache-{self.id}", self)

    # -- policy bookkeeping ----------------------------------------------------
    def _key_of(self, row: list) -> Any:
        if self.pk_positions:
            return _pk_key(row, self.pk_positions)
        return tuple(row)

    def _touch(self, key: Any) -> None:
        if self.policy == "LRU":
            self._cache.move_to_end(key)
        elif self.policy == "LFU":
            self._freq[key] = self._freq.get(key, 0) + 1

    def _evict_one(self) -> None:
        if self.policy == "LFU":
            victim = min(self._cache, key=lambda k: self._freq.get(k, 0))
            self._cache.pop(victim)
            self._freq.pop(victim, None)
        else:   # FIFO and LRU both evict the head (LRU head = least recent)
            key, _ = self._cache.popitem(last=False)
            self._freq.pop(key, None)
        self._complete = False

    def _put(self, row: list) -> None:
        key = self._key_of(row)
        if key in self._cache:
            self._cache[key] = list(row)
            self._touch(key)
            return
        while len(self._cache) >= self.max_size:
            self._evict_one()
        self._cache[key] = list(row)
        if self.policy == "LFU":
            self._freq[key] = 1

    def _invalidate(self, row: list) -> None:
        key = self._key_of(row)
        self._cache.pop(key, None)
        self._freq.pop(key, None)
        # the row may still exist in the store with new values — the cache no
        # longer mirrors the store until the entry is re-fetched
        self._complete = False

    # -- table API (write-through) --------------------------------------------
    def add(self, rows: list[list], ts: int = 0) -> None:
        self.backing.add(rows, ts)
        fits = self._complete and \
            len(self._cache) + len(rows) <= self.max_size
        for r in rows:
            self._put(list(r))
        self._complete = fits

    def preload(self) -> None:
        """Load the store into the cache (reference preloads on connect)."""
        rows = self.backing.find(None, None)
        if len(rows) <= self.max_size:
            for r in rows:
                self._put(list(r))
            self._complete = True

    def find(self, cond: Optional[CompiledTableCondition],
             out_data: Optional[list], ts: int = 0) -> list[list]:
        if cond is None:
            if self._complete:
                return [list(r) for r in self._cache.values()]
            return self.backing.find(None, out_data, ts)
        if cond.pk_extractor is not None and len(self.pk_positions) >= 1:
            key = cond.pk_extractor(out_data)
            row = self._cache.get(key)
            if row is not None:
                self._touch(key)
                self.cache_hits += 1
                return [list(row)] if cond.fn(
                    TableMatchFrame(row, out_data, ts)) else []
        if self._complete:
            hits = [list(r) for r in self._cache.values()
                    if cond.fn(TableMatchFrame(r, out_data, ts))]
            for r in hits:
                self._touch(self._key_of(r))
            return hits
        rows = self.backing.find(cond, out_data, ts)
        for r in rows:
            self._put(list(r))
        return rows

    def delete(self, cond, out_data, ts: int = 0) -> int:
        victims = [r for r in self.backing.find(cond, out_data, ts)]
        n = self.backing.delete(cond, out_data, ts)
        for r in victims:
            self._invalidate(r)
        return n

    def update(self, cond, out_data, setters, ts: int = 0) -> int:
        before = self.backing.find(cond, out_data, ts)
        n = self.backing.update(cond, out_data, setters, ts)
        for r in before:
            self._invalidate(r)   # re-cached on next lookup with fresh values
        return n

    def update_or_add(self, cond, out_data, setters, ts: int = 0) -> None:
        if self.update(cond, out_data, setters, ts) == 0:
            self.add([list(out_data)], ts)

    def pk_lookup(self, key: Any) -> list[list]:
        row = self._cache.get(key)
        if row is not None:
            self._touch(key)
            self.cache_hits += 1
            return [list(row)]
        if self._complete:
            return []
        if hasattr(self.backing, "pk_lookup"):
            rows = self.backing.pk_lookup(key)
        else:
            pos = self.pk_positions[0] if len(self.pk_positions) == 1 else None
            rows = [r for r in self.backing.find(None, None)
                    if (r[pos] if pos is not None else None) == key] \
                if pos is not None else []
        for r in rows:
            self._put(list(r))
        return rows

    def contains_value(self, value: Any) -> bool:
        # single PK: membership = PK membership (InMemoryTable semantics)
        if len(self.pk_positions) == 1:
            if value in self._cache:
                self._touch(value)
                return True
            if self._complete:
                return False
            return bool(self.pk_lookup(value))
        # composite/no PK: any-column membership over the full row set
        rows = self._cache.values() if self._complete \
            else self.backing.find(None, None)
        return any(value in r for r in rows)

    def all_events(self, ts: int = 0) -> list[StreamEvent]:
        if self._complete:
            return [StreamEvent(ts, list(r)) for r in self._cache.values()]
        return [StreamEvent(ts, list(r)) for r in self.backing.find(None, None, ts)]

    # -- state ----------------------------------------------------------------
    # The cache is derived state: a restore invalidates it so lookups refetch
    # from the (authoritative) store.
    def snapshot_state(self) -> dict:
        return {}

    def restore_state(self, state: dict) -> None:
        self._cache.clear()
        self._freq.clear()
        self._complete = False


def build_store_tree(on_condition: Expression, classify, build_param):
    """AST → (StoreExpression node, param extractor fns) or (None, {}).

    ``classify(var)`` returns ``('attribute', name)`` for table columns,
    ``'param'`` for streaming-side refs, or ``'bail'`` when resolution is
    ambiguous; ``build_param(expr)`` returns an extractor fn or None. Any
    unconvertible sub-expression aborts the whole pushdown (the reference
    falls back to ExhaustiveCollectionExecutor there too)."""
    from ..query_api import (
        And as _And, Compare as _Compare, Constant as _Constant,
        MathExpr as _MathExpr, Minus as _Minus, Not as _Not, Or as _Or,
        Variable as _Variable,
    )
    from ..query_api.expression import CompareOp as _CmpOp, MathOp as _MathOp

    cmp_ops = {_CmpOp.EQ: "==", _CmpOp.NEQ: "!=", _CmpOp.LT: "<",
               _CmpOp.LE: "<=", _CmpOp.GT: ">", _CmpOp.GE: ">="}
    math_ops = {_MathOp.ADD: "+", _MathOp.SUB: "-", _MathOp.MUL: "*",
                _MathOp.DIV: "/", _MathOp.MOD: "%"}
    params: dict = {}
    counter = itertools.count()

    def walk(expr):
        if isinstance(expr, _Constant):
            return ("constant", expr.value)
        if isinstance(expr, _Variable):
            kind = classify(expr)
            if kind == "bail":
                return None
            if isinstance(kind, tuple) and kind[0] == "attribute":
                return kind
            # streaming-side value: becomes a per-lookup parameter
            val_fn = build_param(expr)
            if val_fn is None:
                return None
            name = f"p{next(counter)}"
            params[name] = val_fn
            return ("param", name)
        if isinstance(expr, _Compare):
            left, right = walk(expr.left), walk(expr.right)
            if left is None or right is None:
                return None
            return ("compare", cmp_ops[expr.op], left, right)
        if isinstance(expr, (_And, _Or)):
            left, right = walk(expr.left), walk(expr.right)
            if left is None or right is None:
                return None
            return ("and" if isinstance(expr, _And) else "or", left, right)
        if isinstance(expr, _Not):
            sub = walk(expr.expr)
            return None if sub is None else ("not", sub)
        if isinstance(expr, _MathExpr):
            left, right = walk(expr.left), walk(expr.right)
            if left is None or right is None:
                return None
            return ("math", math_ops[expr.op], left, right)
        if isinstance(expr, _Minus):
            sub = walk(expr.expr)
            return None if sub is None else \
                ("math", "-", ("constant", 0), sub)
        return None                 # functions / in-table / is-null etc.

    node = walk(on_condition)
    if node is None:
        return None, {}
    return node, params


def _build_store_expression(table_def, on_condition: Expression,
                            out_names: list[str], out_types: list[DataType],
                            app_context):
    """Table-lookup flavor: table refs by id/bare-name, params resolve
    against the matching event (TableMatchFrame)."""

    def classify(var):
        if var.stream_id == table_def.id or (
                var.stream_id is None
                and var.attribute not in out_names
                and var.attribute in table_def.attribute_names):
            if var.attribute not in table_def.attribute_names:
                return "bail"
            return ("attribute", var.attribute)
        return "param"

    def build_param(expr):
        ob = ExecutorBuilder(
            TableMatchResolver(table_def, out_names, out_types), app_context)
        try:
            val_fn, _ = ob.build(expr)
        except Exception:           # noqa: BLE001 — unresolvable → no pushdown
            return None
        return val_fn

    return build_store_tree(on_condition, classify, build_param)


def compile_table_condition(table: Table, on_condition: Optional[Expression],
                            out_names: list[str], out_types: list[DataType],
                            app_context) -> Optional[CompiledTableCondition]:
    if on_condition is None:
        return None
    resolver = TableMatchResolver(table.definition, out_names, out_types)
    builder = ExecutorBuilder(resolver, app_context)
    fn, _ = builder.build(on_condition)

    # store pushdown form (only meaningful for record tables, but cheap and
    # side-effect-free to build here for any table)
    store_expr = None
    param_fns: dict = {}
    record_backed = isinstance(table, AbstractRecordTable) or (
        isinstance(table, CacheTable)
        and isinstance(table.backing, AbstractRecordTable))
    if record_backed:
        node, param_fns = _build_store_expression(
            table.definition, on_condition, out_names, out_types, app_context)
        if node is not None:
            store_expr = StoreExpression(node)

    # PK fast path: `T.pk == <expr-over-out>` at top level of an AND chain.
    # A bare variable named like the PK only counts as the table side when the
    # resolver would NOT bind it to the matching event (out side wins there).
    pk_extractor = None
    if isinstance(table, (InMemoryTable, CacheTable)) and len(table.pk_positions) == 1:
        pk_pos = table.pk_positions[0]
        pk_name = table.definition.attributes[pk_pos].name
        allow_bare = pk_name not in out_names
        eq = _find_pk_equality(on_condition, table.id, pk_name, allow_bare)
        if eq is not None:
            out_builder = ExecutorBuilder(
                TableMatchResolver(table.definition, out_names, out_types),
                app_context)
            val_fn, _ = out_builder.build(eq)
            pk_extractor = lambda out: val_fn(TableMatchFrame(None, out))  # noqa: E731
    return CompiledTableCondition(fn, pk_extractor, store_expr, param_fns)


def _find_pk_equality(expr: Expression, table_id: str, pk_name: str,
                      allow_bare: bool = True):
    """Finds `T.pk == rhs` (rhs not referencing the table) in a top-level AND chain."""
    from ..query_api import And
    if isinstance(expr, And):
        return _find_pk_equality(expr.left, table_id, pk_name, allow_bare) or \
            _find_pk_equality(expr.right, table_id, pk_name, allow_bare)
    if isinstance(expr, Compare) and expr.op == CompareOp.EQ:
        for a, b in ((expr.left, expr.right), (expr.right, expr.left)):
            if isinstance(a, Variable) and a.attribute == pk_name and \
                    (a.stream_id == table_id
                     or (a.stream_id is None and allow_bare)) and \
                    not _references_table(b, table_id):
                return b
    return None


def _references_table(expr: Expression, table_id: str) -> bool:
    from ..query_api import And, AttributeFunction, MathExpr, Minus, Not, Or
    if isinstance(expr, Variable):
        return expr.stream_id == table_id
    for attr in ("left", "right", "expr"):
        sub = getattr(expr, attr, None)
        if isinstance(sub, Expression) and _references_table(sub, table_id):
            return True
    if isinstance(expr, AttributeFunction):
        return any(_references_table(a, table_id) for a in expr.args)
    return False
