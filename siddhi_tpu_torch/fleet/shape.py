"""Plan fingerprinting: normalize a lowered query into a shape key.

The multi-tenant premise (TiLT/CORE in PAPERS.md): thousands
of SiddhiApps per chip are mostly COPIES of a few query templates, differing
only in constants — thresholds, window sizes, symbols. This module turns a
query AST into

- a **shape key**: a stable fingerprint of everything that determines the
  compiled program — structure (handler chain / NFA stage graph), attribute
  names and dtypes, window KINDS, group-by keys, select list shape — with
  constants replaced by typed parameter placeholders;
- a **rewritten AST** where each hoistable ``Constant`` became a
  :class:`~siddhi_tpu_torch.gpu.expr_compile.ParamRef` slot, so the plan
  compiled from ANY tenant of the shape executes every other tenant given
  its bound parameter values;
- the tenant's **parameter values** (in slot order) and **runtime
  overrides** (window sizes / pattern ``within`` — runtime parameters of
  the columnar engine, not compile-time shapes).

Two queries with the same key share one compiled program per backend (the
fleet plan cache); same text ⇒ same key, differing constants ⇒ same key,
differing structure ⇒ different key. The port's tokens and keys equal the
JAX package's for the same query (``tests/test_torch_fleet.py``), since the
key indexes the shared cache and the mesh's placement.

What stays structural (differentiates shapes): attribute names/types, window
kinds, ``convert`` targets, sort/frequent/heavy-hitter window configs, count
state ``<m:n>`` bounds, aliases, group-by columns, output attribute names,
BOOL constants, and string constants outside a column comparison.
"""

from __future__ import annotations

import copy
import hashlib
from dataclasses import dataclass, field
from typing import Any, Optional

from ..query_api import (
    AbsentStreamStateElement,
    And,
    AttributeFunction,
    Compare,
    Constant,
    CountStateElement,
    EveryStateElement,
    Filter,
    IsNull,
    LogicalStateElement,
    MathExpr,
    Minus,
    NextStateElement,
    Not,
    Or,
    OutputAttribute,
    Query,
    SingleInputStream,
    StateInputStream,
    StreamStateElement,
    Variable,
    Window,
)
from ..query_api.definition import DataType
from ..gpu.expr_compile import ParamRef

_NUMERIC = (DataType.INT, DataType.LONG, DataType.FLOAT, DataType.DOUBLE)

# window kinds whose size parameters are runtime overrides of the columnar
# engine (state-dict parameters, not compile-time shapes): position → which
# override each constant parameter feeds
_WINDOW_OVERRIDES = {
    "length": {0: "window_n"},
    "time": {0: "window_ms"},
    "externalTime": {1: "window_ms"},
}


class FleetShapeError(Exception):
    """The query does not normalize into a fleet shape (solo path)."""


@dataclass
class ParamSpec:
    index: int
    type: DataType
    string: bool = False      # raw string value, dictionary-encoded at bind


@dataclass
class NormalizedQuery:
    shape_key: str
    kind: str                             # 'stream' | 'nfa' | 'partition'
    query: Query                          # rewritten AST (ParamRef slots)
    param_specs: list = field(default_factory=list)
    param_values: list = field(default_factory=list)
    overrides: dict = field(default_factory=dict)   # window_n/window_ms/within
    stream_ids: list = field(default_factory=list)  # canonical input order
    tokens: str = ""                      # readable canonical form (lint/debug)


class _Normalizer:
    def __init__(self, sid_order: list[str], stream_defs: dict):
        self.sid_index = {sid: i for i, sid in enumerate(sid_order)}
        self.stream_defs = stream_defs
        self.specs: list[ParamSpec] = []
        self.values: list[Any] = []
        self.tok: list[str] = []

    # -- parameter slots -----------------------------------------------------
    def _param(self, value, dtype: DataType, string: bool = False) -> ParamRef:
        idx = len(self.specs)
        self.specs.append(ParamSpec(idx, dtype, string))
        self.values.append(value)
        self.tok.append(f"?{idx}:{dtype.name}" + (":str" if string else ""))
        return ParamRef(idx, dtype)

    # -- expressions ---------------------------------------------------------
    def _var_token(self, v: Variable) -> str:
        sid = v.stream_id
        if sid is not None and sid in self.sid_index:
            sid = f"s{self.sid_index[sid]}"
        return f"v:{sid}:{v.attribute}:{v.stream_index}:{v.function_id}"

    def expr(self, e):
        """Rewritten expression; canonical tokens append to ``self.tok``."""
        if isinstance(e, Constant):
            if e.type in _NUMERIC:
                return self._param(e.value, e.type)
            # BOOL and out-of-comparison strings stay structural
            self.tok.append(f"c:{e.type.name}:{e.value!r}")
            return e
        if isinstance(e, Variable):
            self.tok.append(self._var_token(e))
            return e
        if isinstance(e, Compare):
            self.tok.append(f"(cmp {e.op.value}")
            left = self._cmp_side(e.left, e.right)
            right = self._cmp_side(e.right, e.left)
            self.tok.append(")")
            return Compare(left, e.op, right)
        if isinstance(e, And):
            self.tok.append("(and")
            out = And(self.expr(e.left), self.expr(e.right))
            self.tok.append(")")
            return out
        if isinstance(e, Or):
            self.tok.append("(or")
            out = Or(self.expr(e.left), self.expr(e.right))
            self.tok.append(")")
            return out
        if isinstance(e, Not):
            self.tok.append("(not")
            out = Not(self.expr(e.expr))
            self.tok.append(")")
            return out
        if isinstance(e, Minus):
            self.tok.append("(neg")
            out = Minus(self.expr(e.expr))
            self.tok.append(")")
            return out
        if isinstance(e, MathExpr):
            self.tok.append(f"(math {e.op.value}")
            out = MathExpr(self.expr(e.left), e.op, self.expr(e.right))
            self.tok.append(")")
            return out
        if isinstance(e, IsNull):
            self.tok.append(f"(isnull {e.stream_id}:{e.stream_index}")
            inner = self.expr(e.expr) if e.expr is not None else None
            self.tok.append(")")
            return IsNull(inner, e.stream_id, e.stream_index)
        if isinstance(e, AttributeFunction):
            name = f"{e.namespace}:{e.name}" if e.namespace else e.name
            self.tok.append(f"(fn {name}")
            if e.name in ("convert", "cast") and e.namespace is None:
                # the conversion target is the program's output dtype —
                # structural by definition
                args = [self.expr(e.args[0])] + list(e.args[1:])
                for a in e.args[1:]:
                    self.tok.append(f"c:{getattr(a, 'value', a)!r}")
            else:
                args = [self.expr(a) for a in e.args]
            self.tok.append(")")
            return AttributeFunction(e.namespace, e.name, args)
        raise FleetShapeError(
            f"expression {type(e).__name__} does not normalize")

    def _cmp_side(self, e, other):
        """One Compare side: a string constant against a string column
        hoists to a dictionary-encoded parameter slot."""
        if isinstance(e, Constant) and e.type == DataType.STRING \
                and isinstance(other, Variable):
            return self._param(e.value, DataType.STRING, string=True)
        return self.expr(e)

    # -- windows -------------------------------------------------------------
    def window(self, h: Window, overrides: dict) -> Window:
        self.tok.append(f"(win {h.name}")
        over = _WINDOW_OVERRIDES.get(h.name, {})
        for i, p in enumerate(h.params):
            if i in over and isinstance(p, Constant):
                # size → runtime parameter of the shape (columnar engine
                # reads it from the state dict; the plan keeps the first
                # tenant's constant for the device's static shapes)
                overrides[over[i]] = int(p.value)
                self.tok.append(f"?{over[i]}")
            elif isinstance(p, Constant):
                self.tok.append(f"c:{p.type.name}:{p.value!r}")
            elif isinstance(p, Variable):
                self.tok.append(self._var_token(p))
            else:
                raise FleetShapeError(
                    f"window '{h.name}' parameter {type(p).__name__} does "
                    f"not normalize")
        self.tok.append(")")
        return h

    # -- stream defs ---------------------------------------------------------
    def def_tokens(self, sid: str) -> None:
        d = self.stream_defs.get(sid)
        if d is None:
            raise FleetShapeError(f"undefined stream '{sid}'")
        cols = ",".join(f"{a.name}:{a.type.name}" for a in d.attributes)
        self.tok.append(f"(def s{self.sid_index[sid]} {cols})")


def _selector(nz: _Normalizer, query: Query) -> None:
    sel = query.selector
    nz.tok.append(f"(select all={sel.select_all}")
    for oa in sel.attributes:
        nz.tok.append(f"(out {oa.name}")
        oa.expr = nz.expr(oa.expr)
        nz.tok.append(")")
    if sel.group_by:
        nz.tok.append("(group")
        for gb in sel.group_by:
            nz.tok.append(nz._var_token(gb))
        nz.tok.append(")")
    if sel.having is not None:
        nz.tok.append("(having")
        sel.having = nz.expr(sel.having)
        nz.tok.append(")")
    if sel.order_by or sel.limit is not None or sel.offset is not None:
        raise FleetShapeError("order by / limit / offset do not normalize")
    if query.output_rate is not None:
        raise FleetShapeError("output rate limiting does not normalize")
    nz.tok.append(")")


def _within_ms(expr) -> Optional[int]:
    if expr is None:
        return None
    if isinstance(expr, Constant):
        return int(expr.value)
    raise FleetShapeError("non-constant within does not normalize")


def _state_walk(nz: _Normalizer, el, overrides: dict) -> None:
    if isinstance(el, NextStateElement):
        nz.tok.append("(next")
        _state_walk(nz, el.first, overrides)
        _state_walk(nz, el.next, overrides)
        nz.tok.append(f"w={_within_ms(el.within)})")
    elif isinstance(el, EveryStateElement):
        nz.tok.append("(every")
        _state_walk(nz, el.inner, overrides)
        nz.tok.append(f"w={_within_ms(el.within)})")
    elif isinstance(el, StreamStateElement):
        _single_stream(nz, el.stream)
        nz.tok.append(f"w={_within_ms(el.within)}")
    elif isinstance(el, CountStateElement):
        nz.tok.append(f"(count {el.min_count}:{el.max_count}")
        _state_walk(nz, el.stream, overrides)
        nz.tok.append(f"w={_within_ms(el.within)})")
    elif isinstance(el, LogicalStateElement):
        nz.tok.append(f"(logic {el.type.value}")
        _state_walk(nz, el.first, overrides)
        _state_walk(nz, el.second, overrides)
        nz.tok.append(f"w={_within_ms(el.within)})")
    elif isinstance(el, AbsentStreamStateElement):
        nz.tok.append(f"(absent for={el.waiting_time_ms}")
        _single_stream(nz, el.stream)
        nz.tok.append(f"w={_within_ms(el.within)})")
    else:
        raise FleetShapeError(
            f"state element {type(el).__name__} does not normalize")


def _single_stream(nz: _Normalizer, s: SingleInputStream) -> None:
    if s.is_fault_stream or s.is_inner_stream:
        raise FleetShapeError("fault/inner input streams do not normalize")
    alias = getattr(s, "alias", None)
    nz.tok.append(f"(st {alias} s{nz.sid_index[s.stream_id]}")
    for h in s.handlers:
        if isinstance(h, Filter):
            nz.tok.append("(filter")
            h.expr = nz.expr(h.expr)
            nz.tok.append(")")
        else:
            raise FleetShapeError(
                f"pattern stream handler {type(h).__name__} does not "
                f"normalize")
    nz.tok.append(")")


def _finish(nz: _Normalizer, kind: str, query: Query, overrides: dict,
            sid_order: list[str], prefix: str = "") -> NormalizedQuery:
    tokens = prefix + " ".join(nz.tok)
    digest = hashlib.sha256(tokens.encode()).hexdigest()[:20]
    return NormalizedQuery(
        shape_key=f"{kind}:{digest}", kind=kind, query=query,
        param_specs=nz.specs, param_values=nz.values, overrides=overrides,
        stream_ids=sid_order, tokens=tokens)


def normalize_query(query: Query, stream_defs: dict) -> NormalizedQuery:
    """Normalize a top-level query (single-stream or pattern/sequence).

    Returns the rewritten query + shape key; raises :class:`FleetShapeError`
    when the query has no fleet shape (joins, on-demand surfaces, exotic
    expressions) — the caller keeps the solo path."""
    ist = query.input_stream
    query = copy.deepcopy(query)
    overrides: dict = {}
    if isinstance(query.input_stream, SingleInputStream):
        ist = query.input_stream
        sid_order = [ist.stream_id]
        nz = _Normalizer(sid_order, stream_defs)
        nz.tok.append("(stream")
        nz.def_tokens(ist.stream_id)
        for h in ist.handlers:
            if isinstance(h, Filter):
                nz.tok.append("(filter")
                h.expr = nz.expr(h.expr)
                nz.tok.append(")")
            elif isinstance(h, Window):
                nz.window(h, overrides)
            else:
                raise FleetShapeError(
                    f"stream handler {type(h).__name__} does not normalize")
        _selector(nz, query)
        nz.tok.append(")")
        return _finish(nz, "stream", query, overrides, sid_order)
    if isinstance(query.input_stream, StateInputStream):
        ist = query.input_stream
        sid_order = ist.stream_ids()
        nz = _Normalizer(sid_order, stream_defs)
        nz.tok.append(f"(pattern {ist.type.value}")
        for sid in sid_order:
            nz.def_tokens(sid)
        overrides["within"] = _within_ms(ist.within)
        if overrides["within"] is None:
            del overrides["within"]
        else:
            nz.tok.append("?within")
        _state_walk(nz, ist.state, overrides)
        _selector(nz, query)
        nz.tok.append(")")
        return _finish(nz, "nfa", query, overrides, sid_order)
    raise FleetShapeError(
        f"input stream {type(query.input_stream).__name__} does not "
        f"normalize")


def normalize_partition_query(partition_ast, query: Query,
                              stream_defs: dict) -> NormalizedQuery:
    """Normalize one query of a ``partition with (key of Stream)`` block:
    the partition key attribute is part of the shape (it becomes the lane
    routing column and the injected per-key equality constraint)."""
    if len(partition_ast.partition_types) != 1:
        raise FleetShapeError("multi-stream partitions do not normalize")
    pt = partition_ast.partition_types[0]
    ve = getattr(pt, "value_expr", None)
    if ve is None or not isinstance(ve, Variable) \
            or ve.stream_index is not None:
        raise FleetShapeError("range/expression partitions do not normalize")
    if not isinstance(query.input_stream, StateInputStream):
        raise FleetShapeError(
            "non-pattern partition queries do not normalize")
    inner = normalize_query(query, stream_defs)
    tokens = f"(partition key={ve.attribute}) " + inner.tokens
    digest = hashlib.sha256(tokens.encode()).hexdigest()[:20]
    return NormalizedQuery(
        shape_key=f"partition:{digest}", kind="partition", query=inner.query,
        param_specs=inner.param_specs, param_values=inner.param_values,
        overrides=dict(inner.overrides, key_attr=ve.attribute),
        stream_ids=inner.stream_ids, tokens=tokens)
