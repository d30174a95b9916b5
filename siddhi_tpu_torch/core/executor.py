"""Expression executors (host interpreter).

Reference: ``io.siddhi.core.executor`` — the per-type executor matrix
(``executor/condition/compare/*`` ~17 classes per operator, ``executor/math/*``,
``executor/function/*``) collapses here into closures with build-time type
propagation. The same AST is separately compiled to jnp programs by
``siddhi_tpu/tpu/expr_compile.py``; this version is the semantic oracle.

An executor is ``fn(frame) -> value`` where ``frame`` resolves attribute references:
  - ``StreamFrame``  — single-stream queries
  - ``StateFrame``   — pattern/sequence queries (alias → bound events)
  - ``JoinFrame``    — two-sided joins
  - ``RowFrame``     — table rows / output events (having / order-by)
"""

from __future__ import annotations

import math
import time
import uuid as _uuid
from typing import Any, Callable, Optional

from ..query_api import (
    And,
    AttributeFunction,
    Compare,
    CompareOp,
    Constant,
    DataType,
    Expression,
    In,
    IsNull,
    MathExpr,
    MathOp,
    Minus,
    Not,
    Or,
    Variable,
)
from .event import StateEvent, StreamEvent


class ExecutorBuildError(Exception):
    pass


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

class StreamFrame:
    __slots__ = ("event",)

    def __init__(self, event: StreamEvent):
        self.event = event

    def timestamp(self) -> int:
        return self.event.timestamp


class RowFrame:
    """Positional row (table rows, selector output for having/order-by)."""
    __slots__ = ("data", "ts")

    def __init__(self, data: list, ts: int = 0):
        self.data = data
        self.ts = ts

    def timestamp(self) -> int:
        return self.ts


class StateFrame:
    __slots__ = ("state", "current_alias", "current_event")

    def __init__(self, state: StateEvent, current_alias: Optional[str] = None,
                 current_event: Optional[StreamEvent] = None):
        self.state = state
        self.current_alias = current_alias   # alias being evaluated right now
        self.current_event = current_event   # candidate event (not yet bound)

    def timestamp(self) -> int:
        if self.current_event is not None:
            return self.current_event.timestamp
        return self.state.timestamp or 0


class JoinFrame:
    __slots__ = ("left", "right", "ts")

    def __init__(self, left: Optional[StreamEvent], right: Optional[StreamEvent],
                 ts: int = 0):
        self.left = left
        self.right = right
        self.ts = ts

    def timestamp(self) -> int:
        return self.ts


# ---------------------------------------------------------------------------
# Variable resolution strategies
# ---------------------------------------------------------------------------

class VariableResolver:
    """Build-time resolution of a Variable to a frame accessor."""

    def resolve(self, var: Variable) -> tuple[Callable[[Any], Any], DataType]:
        raise NotImplementedError


class StreamResolver(VariableResolver):
    def __init__(self, definition):
        self.definition = definition

    def resolve(self, var: Variable):
        if var.stream_id is not None and var.stream_id != self.definition.id:
            # alias reference to this same stream is allowed
            pass
        pos = self.definition.attribute_position(var.attribute)
        dtype = self.definition.attributes[pos].type
        return (lambda f: f.event.data[pos]), dtype


class RowResolver(VariableResolver):
    """Resolve against a positional schema [(name, dtype), ...]."""

    def __init__(self, names: list[str], dtypes: list[DataType], table_id: Optional[str] = None):
        self.names = names
        self.dtypes = dtypes
        self.table_id = table_id

    def resolve(self, var: Variable):
        if var.attribute not in self.names:
            raise ExecutorBuildError(
                f"attribute '{var.attribute}' not found in {self.names}")
        pos = self.names.index(var.attribute)
        return (lambda f: f.data[pos]), self.dtypes[pos]


class StateResolver(VariableResolver):
    """Pattern context: ``e1.price``, ``e2[0].price``, bare ``price`` (current)."""

    def __init__(self, alias_defs: dict, default_alias: Optional[str] = None):
        self.alias_defs = alias_defs          # alias -> StreamDefinition
        self.default_alias = default_alias    # alias whose candidate is being tested

    def resolve(self, var: Variable):
        alias = var.stream_id
        if alias is None:
            # bare attribute: candidate event of the current state
            if self.default_alias is None:
                # fall back: unique attribute across alias defs
                owners = [
                    a for a, d in self.alias_defs.items()
                    if var.attribute in d.attribute_names
                ]
                if not owners:
                    raise ExecutorBuildError(f"cannot resolve '{var.attribute}'")
                alias = owners[0]
            else:
                alias = self.default_alias
        if alias not in self.alias_defs:
            raise ExecutorBuildError(f"unknown event reference '{alias}'")
        d = self.alias_defs[alias]
        pos = d.attribute_position(var.attribute)
        dtype = d.attributes[pos].type
        idx = var.stream_index

        def get(f: StateFrame, alias=alias, pos=pos, idx=idx):
            if f.current_alias == alias and f.current_event is not None and idx is None:
                return f.current_event.data[pos]
            ev = f.state.get(alias, idx)
            return None if ev is None else ev.data[pos]

        return get, dtype


class JoinResolver(VariableResolver):
    def __init__(self, left_ref: str, left_def, right_ref: str, right_def):
        self.left_ref = left_ref
        self.left_def = left_def
        self.right_ref = right_ref
        self.right_def = right_def

    def resolve(self, var: Variable):
        sid = var.stream_id
        if sid == self.left_ref:
            side, d = "left", self.left_def
        elif sid == self.right_ref:
            side, d = "right", self.right_def
        elif sid is None:
            in_l = var.attribute in self.left_def.attribute_names
            in_r = var.attribute in self.right_def.attribute_names
            if in_l and in_r:
                raise ExecutorBuildError(
                    f"ambiguous attribute '{var.attribute}' in join")
            if in_l:
                side, d = "left", self.left_def
            elif in_r:
                side, d = "right", self.right_def
            else:
                raise ExecutorBuildError(f"unknown attribute '{var.attribute}'")
        else:
            raise ExecutorBuildError(f"unknown stream reference '{sid}' in join")
        pos = d.attribute_position(var.attribute)
        dtype = d.attributes[pos].type

        if side == "left":
            return (lambda f: None if f.left is None else f.left.data[pos]), dtype
        return (lambda f: None if f.right is None else f.right.data[pos]), dtype


# ---------------------------------------------------------------------------
# Type promotion
# ---------------------------------------------------------------------------

_NUM_ORDER = [DataType.INT, DataType.LONG, DataType.FLOAT, DataType.DOUBLE]


def promote(a: DataType, b: DataType) -> DataType:
    if a in _NUM_ORDER and b in _NUM_ORDER:
        return _NUM_ORDER[max(_NUM_ORDER.index(a), _NUM_ORDER.index(b))]
    if a == b:
        return a
    return DataType.OBJECT


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------

class ExecutorBuilder:
    def __init__(self, resolver: VariableResolver, context=None,
                 extra_functions: Optional[dict] = None):
        self.resolver = resolver
        self.context = context                    # SiddhiAppContext (tables for `in`)
        self.extra_functions = extra_functions or {}

    def build(self, expr: Expression) -> tuple[Callable[[Any], Any], DataType]:
        if isinstance(expr, Constant):
            v = expr.value
            return (lambda f: v), expr.type
        if type(expr).__name__ == "ParamRef":
            # fleet parameter slot (normalized query ASTs): the scalar
            # interpreter never executes those plans — the tpu passes
            # re-compile predicates with slot support — but structural
            # compilers (PatternCompiler) walk the AST eagerly, so give
            # them a loud stub instead of a build failure
            def _no_scalar(f):
                raise ExecutorBuildError(
                    "fleet ParamRef has no scalar executor")
            return _no_scalar, expr.type
        if isinstance(expr, Variable):
            return self.resolver.resolve(expr)
        if isinstance(expr, And):
            lf, _ = self.build(expr.left)
            rf, _ = self.build(expr.right)
            return (lambda f: bool(lf(f)) and bool(rf(f))), DataType.BOOL
        if isinstance(expr, Or):
            lf, _ = self.build(expr.left)
            rf, _ = self.build(expr.right)
            return (lambda f: bool(lf(f)) or bool(rf(f))), DataType.BOOL
        if isinstance(expr, Not):
            f1, _ = self.build(expr.expr)
            return (lambda f: not bool(f1(f))), DataType.BOOL
        if isinstance(expr, Compare):
            return self._build_compare(expr)
        if isinstance(expr, MathExpr):
            return self._build_math(expr)
        if isinstance(expr, Minus):
            f1, t1 = self.build(expr.expr)
            return (lambda f: None if f1(f) is None else -f1(f)), t1
        if isinstance(expr, IsNull):
            return self._build_is_null(expr)
        if isinstance(expr, In):
            return self._build_in(expr)
        if isinstance(expr, AttributeFunction):
            return self._build_function(expr)
        raise ExecutorBuildError(f"unsupported expression {expr!r}")

    # -- comparisons ---------------------------------------------------------
    _NUMERIC = {DataType.INT, DataType.LONG, DataType.FLOAT, DataType.DOUBLE}

    def _build_compare(self, expr: Compare):
        lf, lt = self.build(expr.left)
        rf, rt = self.build(expr.right)
        op = expr.op
        # incompatible operand types fail at BUILD time (reference
        # StringCompareTestCase/BooleanCompareTestCase expect
        # SiddhiAppCreationException for e.g. double != string); unknown/
        # OBJECT types stay permissive
        if lt is not None and rt is not None and lt != rt:
            groups = (self._NUMERIC, {DataType.STRING}, {DataType.BOOL})
            lg = next((g for g in groups if lt in g), None)
            rg = next((g for g in groups if rt in g), None)
            if lg is not None and rg is not None and lg is not rg:
                raise ExecutorBuildError(
                    f"cannot compare {lt.value} with {rt.value} "
                    f"({expr.op.value})")

        def cmp(f):
            a, b = lf(f), rf(f)
            if a is None or b is None:
                return False
            if op == CompareOp.EQ:
                return a == b
            if op == CompareOp.NEQ:
                return a != b
            if op == CompareOp.LT:
                return a < b
            if op == CompareOp.LE:
                return a <= b
            if op == CompareOp.GT:
                return a > b
            return a >= b

        return cmp, DataType.BOOL

    # -- math ----------------------------------------------------------------
    def _build_math(self, expr: MathExpr):
        lf, lt = self.build(expr.left)
        rf, rt = self.build(expr.right)
        rtype = promote(lt, rt)
        op = expr.op
        int_result = rtype in (DataType.INT, DataType.LONG)

        def calc(f):
            a, b = lf(f), rf(f)
            if a is None or b is None:
                return None
            if op == MathOp.ADD:
                return a + b
            if op == MathOp.SUB:
                return a - b
            if op == MathOp.MUL:
                return a * b
            if op == MathOp.DIV:
                if int_result:
                    if b == 0:
                        return None
                    q = abs(a) // abs(b)           # Java truncation toward zero
                    return q if (a >= 0) == (b >= 0) else -q
                return a / b if b != 0 else (math.inf if a > 0 else -math.inf if a < 0 else math.nan)
            # MOD — Java semantics: result sign follows dividend
            if b == 0:
                return None if int_result else math.nan
            return math.fmod(a, b) if not int_result else int(math.fmod(a, b))

        return calc, rtype

    def _build_is_null(self, expr: IsNull):
        # `e1 is null` may parse as IsNull(Variable('e1')): resolve a bare name
        # that is actually a pattern alias or join side to the stream form
        sid, idx = expr.stream_id, expr.stream_index
        if sid is None and isinstance(expr.expr, Variable) \
                and expr.expr.stream_id is None:
            name = expr.expr.attribute
            if isinstance(self.resolver, StateResolver) and name in self.resolver.alias_defs:
                sid, idx = name, expr.expr.stream_index
            elif isinstance(self.resolver, JoinResolver) and name in (
                    self.resolver.left_ref, self.resolver.right_ref):
                sid, idx = name, None
        if sid is not None:
            if isinstance(self.resolver, JoinResolver):
                is_left = sid == self.resolver.left_ref

                def isnull_side(f, is_left=is_left):
                    return (f.left is None) if is_left else (f.right is None)

                return isnull_side, DataType.BOOL

            def isnull_stream(f, sid=sid, idx=idx):
                if isinstance(f, StateFrame):
                    return f.state.get(sid, idx) is None
                return False

            return isnull_stream, DataType.BOOL
        f1, _ = self.build(expr.expr)
        return (lambda f: f1(f) is None), DataType.BOOL

    def _build_in(self, expr: In):
        f1, _ = self.build(expr.expr)
        source_id = expr.source_id
        ctx = self.context
        if ctx is None:
            raise ExecutorBuildError("'in' requires app context with tables")

        def contains(f):
            table = ctx.get_table(source_id)
            return table.contains_value(f1(f))

        return contains, DataType.BOOL

    # -- functions -----------------------------------------------------------
    def _build_function(self, expr: AttributeFunction):
        name = expr.name
        key = f"{expr.namespace}:{name}" if expr.namespace else name
        args = [self.build(a) for a in expr.args]
        fns = [a[0] for a in args]
        types = [a[1] for a in args]

        # extension / user scalar functions
        if self.context is not None:
            ext = self.context.lookup_scalar_function(expr.namespace, name)
            if ext is not None:
                from .extension import validate_extension_args
                try:
                    validate_extension_args(type(ext), types)
                except TypeError as e:
                    raise ExecutorBuildError(str(e)) from None
                fn, rt = ext.bind(fns, types)
                return fn, rt
        if key in self.extra_functions:
            fn, rt = self.extra_functions[key](fns, types)
            return fn, rt

        builder = _BUILTIN_FUNCTIONS.get(name if expr.namespace is None else key)
        if builder is None:
            raise ExecutorBuildError(f"unknown function '{key}'")
        return builder(fns, types)


# ---------------------------------------------------------------------------
# Built-in scalar functions (reference: core/executor/function/, 20 built-ins)
# ---------------------------------------------------------------------------

def _fn_coalesce(fns, types):
    def run(f):
        for fn in fns:
            v = fn(f)
            if v is not None:
                return v
        return None
    return run, types[0] if types else DataType.OBJECT


_CONVERT_TYPES = {
    "string": DataType.STRING, "int": DataType.INT, "long": DataType.LONG,
    "float": DataType.FLOAT, "double": DataType.DOUBLE, "bool": DataType.BOOL,
}

_PY_CASTS = {
    DataType.STRING: str,
    DataType.INT: int,
    DataType.LONG: int,
    DataType.FLOAT: float,
    DataType.DOUBLE: float,
}


def _fn_convert(fns, types):
    if len(fns) != 2:
        raise ExecutorBuildError("convert(value, 'type') needs 2 args")
    target_fn = fns[1]
    target = _CONVERT_TYPES.get(str(target_fn(None)).lower() if _is_const(fns[1]) else "", None)

    def run(f):
        v = fns[0](f)
        t = target or _CONVERT_TYPES.get(str(fns[1](f)).lower())
        if v is None or t is None:
            return None
        try:
            if t == DataType.BOOL:
                if isinstance(v, str):
                    return v.lower() == "true"
                return bool(v)
            return _PY_CASTS[t](v)
        except (ValueError, TypeError):
            return None

    return run, target or DataType.OBJECT


def _is_const(fn) -> bool:
    try:
        fn(None)
        return True
    except Exception:
        return False


def _fn_cast(fns, types):
    return _fn_convert(fns, types)


def _fn_if_then_else(fns, types):
    if len(fns) != 3:
        raise ExecutorBuildError("ifThenElse(cond, a, b) needs 3 args")
    return (lambda f: fns[1](f) if bool(fns[0](f)) else fns[2](f)), promote(types[1], types[2])


def _fn_uuid(fns, types):
    return (lambda f: str(_uuid.uuid4())), DataType.STRING


def _fn_current_time_millis(fns, types):
    return (lambda f: int(time.time() * 1000)), DataType.LONG


def _fn_event_timestamp(fns, types):
    if fns:
        return fns[0], DataType.LONG
    return (lambda f: f.timestamp()), DataType.LONG


def _fn_maximum(fns, types):
    def run(f):
        vals = [fn(f) for fn in fns]
        vals = [v for v in vals if v is not None]
        return max(vals) if vals else None
    return run, types[0] if types else DataType.OBJECT


def _fn_minimum(fns, types):
    def run(f):
        vals = [fn(f) for fn in fns]
        vals = [v for v in vals if v is not None]
        return min(vals) if vals else None
    return run, types[0] if types else DataType.OBJECT


def _fn_instance_of(dtype: DataType, pytypes):
    def builder(fns, types):
        def run(f):
            v = fns[0](f)
            if dtype == DataType.BOOL:
                return isinstance(v, bool)
            if dtype in (DataType.INT, DataType.LONG):
                return isinstance(v, int) and not isinstance(v, bool)
            return isinstance(v, pytypes)
        return run, DataType.BOOL
    return builder


def _fn_create_set(fns, types):
    def run(f):
        s = set()
        v = fns[0](f)
        if v is not None:
            s.add(v)
        return s
    return run, DataType.OBJECT


def _fn_size_of_set(fns, types):
    return (lambda f: len(fns[0](f)) if fns[0](f) is not None else 0), DataType.INT


def _fn_default(fns, types):
    return (lambda f: fns[0](f) if fns[0](f) is not None else fns[1](f)), types[0]


def _fn_log(fns, types):
    import logging
    logger = logging.getLogger("siddhi_tpu.log")

    def run(f):
        vals = [fn(f) for fn in fns]
        logger.info(" ".join(str(v) for v in vals))
        return True
    return run, DataType.BOOL


_BUILTIN_FUNCTIONS: dict[str, Callable] = {
    "coalesce": _fn_coalesce,
    "convert": _fn_convert,
    "cast": _fn_cast,
    "ifThenElse": _fn_if_then_else,
    "UUID": _fn_uuid,
    "currentTimeMillis": _fn_current_time_millis,
    "eventTimestamp": _fn_event_timestamp,
    "maximum": _fn_maximum,
    "minimum": _fn_minimum,
    "instanceOfString": _fn_instance_of(DataType.STRING, str),
    "instanceOfInteger": _fn_instance_of(DataType.INT, int),
    "instanceOfLong": _fn_instance_of(DataType.LONG, int),
    "instanceOfFloat": _fn_instance_of(DataType.FLOAT, float),
    "instanceOfDouble": _fn_instance_of(DataType.DOUBLE, float),
    "instanceOfBoolean": _fn_instance_of(DataType.BOOL, bool),
    "createSet": _fn_create_set,
    "sizeOfSet": _fn_size_of_set,
    "default": _fn_default,
    "log": _fn_log,
}
