"""Expression AST → torch closure + typed postfix IR.

Port of the reference's ``tpu/expr_compile.py``. One build-time pass walks
the AST once and emits, from the same decision points, two forms of the same
program:

- a **torch closure** ``fn(env) -> tensor`` over column tensors: the plain
  version, run on any device; and
- a **typed postfix IR** (a list of ``(op, type, a, b)`` tuples) that the
  CUDA kernels (``csrc/nfa_block.cu``, ``csrc/nfa_scan.cu``) evaluate with
  one ``__device__`` interpreter (``csrc/expr_ir.cuh``), so one build of
  each kernel serves every app.

Semantics are the reference's (the JAX package on its device dtype policy):
typed compares with int-vs-float constant folding, and/or/not, ``+ - * / %``
with Java integer division, unary minus, ``ifThenElse``, ``convert/cast``,
``eventTimestamp``, ``maximum/minimum``, string equality as int32 dictionary
codes. Integer division and modulo by zero do not raise: they return what
XLA returns (``x / 0 == -1`` and ``x % 0 == x`` at the ``lax`` level, so
Java ``a / 0`` is ``-2`` for ``a != 0``, ``-1`` for ``a == 0`` and
``a % 0 == 0``). Float → int conversion saturates and maps NaN to 0 (XLA's
``convert``). Python-constant weak typing matches JAX: a float constant
against an f32 column compares in f32, and the IR types it as f32.

Env keys: ``ev_<merged col>`` (event columns), ``b<q>_<attr>`` (bound values
of earlier states) and ``__device__`` (the device constants are materialised
on). ``eventTimestamp()`` reads ``__ts__``, which the NFA steps do not
provide, as the reference's do not: inside a pattern it raises
``KeyError('__ts__')`` at the first step, in both packages. Single-stream
queries (``query_compile.py``) resolve bare attribute names through
``ColumnResolver`` and do put ``__ts__`` in the env; their kernel links
``OP_TS`` to the int64 timestamp column and bare names to column slots.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch

from ..query_api import (
    And,
    AttributeFunction,
    Compare,
    CompareOp,
    Constant,
    DataType,
    Expression,
    MathExpr,
    MathOp,
    Minus,
    Not,
    Or,
    Variable,
)
from .backend import policy_dtype


class DeviceCompileError(Exception):
    """Raised when an expression or pattern cannot run on the device path."""


class KernelLibraryError(DeviceCompileError):
    """A query's kernel library did not build or load on the card: raised
    when the query is built, strict or not, never a host fallback."""


class ColumnResolver:
    """Maps a Variable to a column key + dtype for one stream: bare
    attribute names (pattern compilers resolve prefixed keys instead)."""

    def __init__(self, schema):
        self.schema = schema

    def resolve(self, var: Variable) -> tuple[str, DataType]:
        d = self.schema.definition
        if var.attribute not in d.attribute_names:
            raise DeviceCompileError(f"unknown attribute '{var.attribute}'")
        return var.attribute, d.attribute_type(var.attribute)

    def encode_string(self, attr_key: str, value: str) -> int:
        dic = self.schema.dictionaries.get(attr_key)
        if dic is None:
            raise DeviceCompileError(f"no dictionary for '{attr_key}'")
        return dic.encode(value)


# --------------------------------------------------------------------------
# IR: op codes and static types (mirrored by `enum Op`/`enum Ty` in
# csrc/expr_ir.cuh; a test pins the two lists together)
# --------------------------------------------------------------------------

T_BOOL, T_I32, T_I64, T_F32 = 0, 1, 2, 3
TY_OF = {torch.bool: T_BOOL, torch.int32: T_I32, torch.int64: T_I64,
         torch.float32: T_F32}
DTYPE_OF = {v: k for k, v in TY_OF.items()}
MAXSTACK = 32                    # the interpreter's stack depth

OPS = ("EV", "BIND", "TS", "CONST", "CAST", "ADD", "SUB", "MUL", "DIV", "MOD",
       "NEG", "EQ", "NE", "LT", "LE", "GT", "GE", "AND", "OR", "NOT", "SELECT",
       "MAX", "MIN")
OP = {name: i + 1 for i, name in enumerate(OPS)}

_CMP_OP = {CompareOp.EQ: "EQ", CompareOp.NEQ: "NE", CompareOp.LT: "LT",
           CompareOp.LE: "LE", CompareOp.GT: "GT", CompareOp.GE: "GE"}
_CMP_FN = {"EQ": torch.eq, "NE": torch.ne, "LT": torch.lt, "LE": torch.le,
           "GT": torch.gt, "GE": torch.ge}

_NUM_ORDER = [DataType.INT, DataType.LONG, DataType.FLOAT, DataType.DOUBLE]
# implicit promotion order of the representations (bool < i32 < i64 < f32)
_TY_RANK = [T_BOOL, T_I32, T_I64, T_F32]


def promote(a: DataType, b: DataType) -> DataType:
    if a in _NUM_ORDER and b in _NUM_ORDER:
        return _NUM_ORDER[max(_NUM_ORDER.index(a), _NUM_ORDER.index(b))]
    if a == b:
        return a
    raise DeviceCompileError(f"cannot promote {a} and {b} on device")


def ir_type(t: DataType) -> int:
    return TY_OF[policy_dtype(t)]


def _cast_ir(ir: list, src: int, dst: int) -> list:
    return ir if src == dst else ir + [(OP["CAST"], dst, src, 0)]


def ir_result_type(ir: list) -> int:
    return ir[-1][1]


def cast_to(ir: list, ty: int) -> list:
    """The program with a cast of its result to ``ty`` appended (as is
    when it already has that type)."""
    return _cast_ir(ir, ir_result_type(ir), ty)


def const_bits(v, ty: int) -> int:
    """A constant as the kernel's 64-bit value slot."""
    if ty == T_BOOL:
        return int(bool(v))
    if ty == T_I32:
        return int(np.array(int(v) & 0xFFFFFFFF, np.uint32).view(np.int32))
    if ty == T_I64:
        return int(np.array(int(v) & 0xFFFFFFFFFFFFFFFF, np.uint64).view(np.int64))
    return int(np.float32(float(v)).view(np.uint32))


def link_ir(ir: list, operand) -> np.ndarray:
    """Encodes a program for the kernels' interpreter: ``operand(op, key)``
    resolves each EV/BIND/TS operand to ``(op, slot)``; constants become
    their 64-bit value slots. Returns ``[n, 4]`` int32 instructions;
    refuses a program deeper than the interpreter's stack."""
    rows, depth, peak = [], 0, 0
    for (op, ty, a, b) in ir:
        if op in (OP["EV"], OP["BIND"], OP["TS"]):
            op, a = operand(op, a)
        elif op == OP["CONST"]:
            bits = const_bits(a, ty) & 0xFFFFFFFFFFFFFFFF
            lo, hi = bits & 0xFFFFFFFF, bits >> 32
            a = lo - (1 << 32) if lo >= 1 << 31 else lo
            b = hi - (1 << 32) if hi >= 1 << 31 else hi
        if op in (OP["EV"], OP["BIND"], OP["TS"], OP["CONST"]):
            depth += 1
        elif op == OP["SELECT"]:
            depth -= 2
        elif op not in (OP["CAST"], OP["NEG"], OP["NOT"]):
            depth -= 1
        peak = max(peak, depth)
        rows.append((op, ty, int(a), int(b)))
    if peak > MAXSTACK:
        raise DeviceCompileError(
            f"expression needs a stack of {peak} (kernel limit {MAXSTACK})")
    return np.array(rows, dtype=np.int32).reshape(-1, 4)


_CMP_OPS = tuple(OP[n] for n in ("EQ", "NE", "LT", "LE", "GT", "GE"))


def clause_form(rows: np.ndarray, base: int):
    """A linked predicate (``rows`` at code offset ``base``) as a conjunction
    of comparisons between two operands (an event column, a bound value —
    a scan table field or a blocked candidate's binding — or a constant,
    each under at most one cast): two int4 words per clause,
    ``(compare op, compare type, x kind, x index)`` and ``(x cast, y kind,
    y index, y cast)``, a constant's index the code row that holds it, a
    cast ``src << 8 | dst`` or -1. None when the program has another shape.
    The kernels evaluate these without the interpreter, through
    ``expr_ir.cuh``'s clause decoder (``eval_clauses`` in the scan kernel,
    ``nfa_block.cu::prepare`` over ``clause_at``/``clause_operand``), with
    the same casts and compares."""
    stack = []
    for i, (op, ty, a, _) in enumerate(rows.tolist()):
        if op in (OP["EV"], OP["BIND"]):
            stack.append(("leaf", op, a, -1))
        elif op == OP["CONST"]:
            stack.append(("leaf", op, base + i, -1))
        elif op == OP["CAST"]:
            x = stack.pop()
            if x[0] != "leaf" or x[3] != -1:
                return None
            stack.append(("leaf", x[1], x[2], (a << 8) | ty))
        elif op in _CMP_OPS:
            y, x = stack.pop(), stack.pop()
            if x[0] != "leaf" or y[0] != "leaf":
                return None
            stack.append(("and", [(op, a, x, y)]))
        elif op == OP["AND"]:
            y, x = stack.pop(), stack.pop()
            if x[0] != "and" or y[0] != "and":
                return None
            stack.append(("and", x[1] + y[1]))
        else:
            return None
    if len(stack) != 1 or stack[0][0] != "and":
        return None
    words = []
    for op, cmp_ty, x, y in stack[0][1]:
        words += [(op, cmp_ty, x[1], x[2]), (x[3], y[1], y[2], y[3])]
    return np.array(words, dtype=np.int32).reshape(-1, 4)


# --------------------------------------------------------------------------
# closure helpers: XLA-exact conversions and integer division
# --------------------------------------------------------------------------

def as_tensor(x, env) -> torch.Tensor:
    """Python constants become tensors the way ``jnp.asarray`` makes them
    under x64 (int64 / float64 / bool), on the env's device. As 0-dim
    tensors they take the dtype of the other operand in an op, which is
    JAX's weak typing."""
    if isinstance(x, torch.Tensor):
        return x
    dev = env.get("__device__")
    if isinstance(x, bool):
        return torch.tensor(x, dtype=torch.bool, device=dev)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64, device=dev)
    return torch.tensor(float(x), dtype=torch.float64, device=dev)


def astype(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``.astype`` with XLA's conversion semantics: float → int truncates,
    saturates at the integer range and maps NaN to 0 (torch's own ``.to``
    leaves out-of-range values undefined)."""
    if x.dtype == dt:
        return x
    if x.is_floating_point() and dt != torch.bool and not dt.is_floating_point:
        info = torch.iinfo(dt)
        hi = float(2 ** (info.bits - 1))            # exact in f32 and f64
        r = torch.nan_to_num(torch.trunc(x), nan=0.0, posinf=hi, neginf=-hi)
        out = torch.clamp(r, -hi, hi).to(dt)
        return torch.where(r >= hi, torch.full_like(out, info.max), out)
    return x.to(dt)


def _xla_div_rem(a: torch.Tensor, b: torch.Tensor):
    """``lax.div``/``lax.rem`` on signed ints: truncating; ``x / 0 == -1``,
    ``x % 0 == x``, ``MIN / -1 == MIN``, ``MIN % -1 == 0``. Never raises."""
    a, b = torch.broadcast_tensors(a, b)
    zero = b == 0
    bs = torch.where(zero | ((a == torch.iinfo(a.dtype).min) & (b == -1)),
                     torch.ones_like(b), b)
    q = torch.div(a, bs, rounding_mode="trunc")
    r = torch.fmod(a, bs)
    return torch.where(zero, torch.full_like(q, -1), q), torch.where(zero, a, r)


def _floor_divide(a, b):
    """``jnp.floor_divide`` on signed ints."""
    q, r = _xla_div_rem(a, b)
    sel = (torch.sign(a) != torch.sign(b)) & (r != 0)
    return torch.where(sel, q - 1, q)


def _remainder(a, b):
    """``jnp.remainder`` on signed ints (a zero divisor acts as 1)."""
    b = torch.where(b == 0, torch.ones_like(b), b)
    _, t = _xla_div_rem(a, b)
    plus = ((t < 0) != (b < 0)) & (t != 0)
    return torch.where(plus, t + b, t)


def java_div(a, b):
    """Java integer division as the reference computes it:
    ``where((a >= 0) == (b >= 0), q, -q)`` with ``q = |a| // |b|``."""
    q = _floor_divide(torch.abs(a), torch.abs(b))
    return torch.where((a >= 0) == (b >= 0), q, -q)


def java_mod(a, b):
    """Java integer remainder: ``sign(a) * (|a| % |b|)``."""
    return torch.sign(a) * _remainder(torch.abs(a), torch.abs(b))


# --------------------------------------------------------------------------
# the compile pass
# --------------------------------------------------------------------------

def compile_expression(expr: Expression, resolver
                       ) -> tuple[Callable[[dict], torch.Tensor], DataType, list]:
    """Returns ``(fn(env) -> tensor, result DataType, postfix IR)``."""
    if isinstance(expr, Constant):
        if expr.type == DataType.STRING:
            raise DeviceCompileError(
                "bare string constant needs a comparison context for encoding")
        v = expr.value
        return (lambda env, v=v: v), expr.type, \
            [(OP["CONST"], ir_type(expr.type), v, 0)]

    if isinstance(expr, Variable):
        key, t = resolver.resolve(expr)
        op = OP["EV"] if key.startswith("ev_") else OP["BIND"]
        return (lambda env, key=key: env[key]), t, [(op, ir_type(t), key, 0)]

    if isinstance(expr, (And, Or)):
        lf, _, lir = compile_expression(expr.left, resolver)
        rf, _, rir = compile_expression(expr.right, resolver)
        name = "AND" if isinstance(expr, And) else "OR"
        tfn = torch.logical_and if name == "AND" else torch.logical_or
        ir = _cast_ir(lir, ir_result_type(lir), T_BOOL) + \
            _cast_ir(rir, ir_result_type(rir), T_BOOL) + \
            [(OP[name], T_BOOL, 0, 0)]
        return (lambda env: tfn(as_tensor(lf(env), env),
                                as_tensor(rf(env), env))), DataType.BOOL, ir

    if isinstance(expr, Not):
        f, _, sir = compile_expression(expr.expr, resolver)
        ir = _cast_ir(sir, ir_result_type(sir), T_BOOL) + \
            [(OP["NOT"], T_BOOL, 0, 0)]
        return (lambda env: torch.logical_not(as_tensor(f(env), env))), \
            DataType.BOOL, ir

    if isinstance(expr, Compare):
        return _compile_compare(expr, resolver)

    if isinstance(expr, MathExpr):
        return _compile_math(expr, resolver)

    if isinstance(expr, Minus):
        f, t, sir = compile_expression(expr.expr, resolver)
        if t == DataType.BOOL:
            raise DeviceCompileError("unary minus on a bool")
        return (lambda env: -f(env)), t, sir + [(OP["NEG"], ir_type(t), 0, 0)]

    if isinstance(expr, AttributeFunction):
        return _compile_function(expr, resolver)

    raise DeviceCompileError(
        f"expression {type(expr).__name__} not device-compilable")


def _compile_math(expr: MathExpr, resolver):
    lf, lt, lir = compile_expression(expr.left, resolver)
    rf, rt, rir = compile_expression(expr.right, resolver)
    _check_long_float_mix(lt, rt, expr.left, expr.right)
    rtype = promote(lt, rt)
    op = expr.op
    int_result = rtype in (DataType.INT, DataType.LONG)
    if rtype == DataType.BOOL and op not in (MathOp.ADD, MathOp.MUL):
        raise DeviceCompileError(f"{op} on bools")
    jdt = policy_dtype(rtype)
    ty = TY_OF[jdt]

    def run(env):
        # both operands pinned to the promoted type's policy dtype, as the
        # reference does (no f64 ever reaches the device)
        a = astype(as_tensor(lf(env), env), jdt)
        b = astype(as_tensor(rf(env), env), jdt)
        if op == MathOp.ADD:
            return a + b
        if op == MathOp.SUB:
            return a - b
        if op == MathOp.MUL:
            return a * b
        if op == MathOp.DIV:
            return java_div(a, b) if int_result else a / b
        return java_mod(a, b) if int_result else torch.fmod(a, b)

    name = {MathOp.ADD: "ADD", MathOp.SUB: "SUB", MathOp.MUL: "MUL",
            MathOp.DIV: "DIV", MathOp.MOD: "MOD"}[op]
    ir = _cast_ir(lir, ir_result_type(lir), ty) + \
        _cast_ir(rir, ir_result_type(rir), ty) + [(OP[name], ty, 0, 0)]
    return run, rtype, ir


_FLIP = {CompareOp.LT: CompareOp.GT, CompareOp.GT: CompareOp.LT,
         CompareOp.LE: CompareOp.GE, CompareOp.GE: CompareOp.LE,
         CompareOp.EQ: CompareOp.EQ, CompareOp.NEQ: CompareOp.NEQ}

_F32_EXACT_INT = 2 ** 24      # |v| ≤ 2^24 round-trips int↔float32 exactly


def _check_long_float_mix(lt: DataType, rt: DataType, left: Expression,
                          right: Expression) -> None:
    """LONG mixed with a non-constant FLOAT/DOUBLE casts the int64 side to
    f32, which misfires above 2^24 — refused, as the reference refuses it,
    unless the LONG side is a constant small enough to be exact in f32."""
    floats = (DataType.FLOAT, DataType.DOUBLE)
    for t, other_t, e in ((lt, rt, left), (rt, lt, right)):
        if t == DataType.LONG and other_t in floats:
            if isinstance(e, Constant) and abs(int(e.value)) <= _F32_EXACT_INT:
                continue
            raise DeviceCompileError(
                "long vs non-constant float loses exactness above 2^24 on "
                "device (f64 banned) — host path")


def _fold_int_vs_float_const(col_fn, col_ir: list, op: CompareOp, c: float):
    """``int_col OP float_const`` as an exact int64 comparison.

    For any integer a: a > c ⟺ a ≥ ⌊c⌋+1; a ≥ c ⟺ a ≥ ⌈c⌉; a < c ⟺ a ≤ ⌈c⌉-1;
    a ≤ c ⟺ a ≤ ⌊c⌋; a == c only possible when c is integral."""
    I64_MIN, I64_MAX = -(2 ** 63), 2 ** 63 - 1

    def const_bool(v: bool):
        def run(env):
            x = as_tensor(col_fn(env), env)
            return torch.full(x.shape, v, dtype=torch.bool, device=x.device)
        return run, [(OP["CONST"], T_BOOL, v, 0)]

    def cmp(name: str, bound: int):
        ir = _cast_ir(col_ir, ir_result_type(col_ir), T_I64) + \
            [(OP["CONST"], T_I64, bound, 0), (OP[name], T_BOOL, T_I64, 0)]
        fn = _CMP_FN[name]
        return (lambda env: fn(astype(as_tensor(col_fn(env), env), torch.int64),
                               bound)), ir

    # non-finite constants never reach floor/ceil — fold to the constant
    # truth value
    if not math.isfinite(c):
        if math.isnan(c):
            return const_bool(op == CompareOp.NEQ)
        if c > 0:       # +inf: only <, <=, != hold for any finite int
            return const_bool(
                op in (CompareOp.LT, CompareOp.LE, CompareOp.NEQ))
        return const_bool(op in (CompareOp.GT, CompareOp.GE, CompareOp.NEQ))

    def ge(bound: int):
        if bound > I64_MAX:
            return const_bool(False)
        if bound <= I64_MIN:
            return const_bool(True)
        return cmp("GE", bound)

    def le(bound: int):
        if bound >= I64_MAX:
            return const_bool(True)
        if bound < I64_MIN:
            return const_bool(False)
        return cmp("LE", bound)

    if op == CompareOp.GT:
        return ge(math.floor(c) + 1)
    if op == CompareOp.GE:
        return ge(math.ceil(c))
    if op == CompareOp.LT:
        return le(math.ceil(c) - 1)
    if op == CompareOp.LE:
        return le(math.floor(c))
    integral = float(c).is_integer() and I64_MIN <= c <= I64_MAX
    if not integral:
        return const_bool(op == CompareOp.NEQ)
    return cmp("EQ" if op == CompareOp.EQ else "NE", int(c))


def _compile_compare(expr: Compare, resolver):
    # string comparisons: only EQ/NEQ, via dictionary codes
    def side(e: Expression, other: Expression):
        if isinstance(e, Constant) and e.type == DataType.STRING:
            if not isinstance(other, Variable):
                raise DeviceCompileError("string constant must compare to a column")
            key, t = resolver.resolve(other)
            if t != DataType.STRING:
                raise DeviceCompileError("string constant vs non-string column")
            code = resolver.encode_string(key, e.value)
            return (lambda env, code=code: code), DataType.STRING, \
                [(OP["CONST"], T_I32, code, 0)]
        return compile_expression(e, resolver)

    lf, lt, lir = side(expr.left, expr.right)
    rf, rt, rir = side(expr.right, expr.left)
    if (lt == DataType.STRING) != (rt == DataType.STRING):
        raise DeviceCompileError("string vs non-string comparison")
    if lt == DataType.STRING and expr.op not in (CompareOp.EQ, CompareOp.NEQ):
        raise DeviceCompileError("string ordering not supported on device")
    op = expr.op

    # int column vs float CONSTANT: fold the constant into an exact int64
    # bound at compile time (casting the column to f32 misfires above 2^24)
    _INTS = (DataType.INT, DataType.LONG)
    if lt in _INTS and isinstance(expr.right, Constant) \
            and rt in (DataType.FLOAT, DataType.DOUBLE):
        fn, ir = _fold_int_vs_float_const(lf, lir, op,
                                          float(expr.right.value))
        return fn, DataType.BOOL, ir
    if rt in _INTS and isinstance(expr.left, Constant) \
            and lt in (DataType.FLOAT, DataType.DOUBLE):
        fn, ir = _fold_int_vs_float_const(rf, rir, _FLIP[op],
                                          float(expr.left.value))
        return fn, DataType.BOOL, ir

    # numeric compares: pin both sides to the promoted policy dtype so mixed
    # int64/float32 operands never promote to float64
    _check_long_float_mix(lt, rt, expr.left, expr.right)
    cmp_dt = policy_dtype(promote(lt, rt)) \
        if lt in _NUM_ORDER and rt in _NUM_ORDER and lt != rt else None
    name = _CMP_OP[op]
    tfn = _CMP_FN[name]

    def run(env):
        a, b = lf(env), rf(env)
        a, b = as_tensor(a, env), as_tensor(b, env)
        if cmp_dt is not None:
            a, b = astype(a, cmp_dt), astype(b, cmp_dt)
        return tfn(a, b)

    lty, rty = ir_result_type(lir), ir_result_type(rir)
    # common operand type: the promoted policy dtype, else (bool against a
    # number) the wider representation, as implicit promotion does
    cty = TY_OF[cmp_dt] if cmp_dt is not None else \
        _TY_RANK[max(_TY_RANK.index(lty), _TY_RANK.index(rty))]
    ir = _cast_ir(lir, lty, cty) + _cast_ir(rir, rty, cty) + \
        [(OP[name], T_BOOL, cty, 0)]
    return run, DataType.BOOL, ir


def _compile_function(expr: AttributeFunction, resolver):
    name = expr.name if expr.namespace is None else f"{expr.namespace}:{expr.name}"
    if name == "ifThenElse":
        c, _, cir = compile_expression(expr.args[0], resolver)
        a, ta, air = compile_expression(expr.args[1], resolver)
        b, tb, bir = compile_expression(expr.args[2], resolver)
        rt = promote(ta, tb)
        jdt = policy_dtype(rt)
        ty = TY_OF[jdt]

        def run(env):
            cond = astype(as_tensor(c(env), env), torch.bool)
            return torch.where(cond, astype(as_tensor(a(env), env), jdt),
                               astype(as_tensor(b(env), env), jdt))

        ir = _cast_ir(cir, ir_result_type(cir), T_BOOL) + \
            _cast_ir(air, ir_result_type(air), ty) + \
            _cast_ir(bir, ir_result_type(bir), ty) + \
            [(OP["SELECT"], ty, 0, 0)]
        return run, rt, ir
    if name in ("convert", "cast"):
        src, _, sir = compile_expression(expr.args[0], resolver)
        target = expr.args[1]
        if not isinstance(target, Constant):
            raise DeviceCompileError("convert target must be constant")
        tmap = {"int": DataType.INT, "long": DataType.LONG,
                "float": DataType.FLOAT, "double": DataType.DOUBLE,
                "bool": DataType.BOOL}
        if str(target.value).lower() not in tmap:
            raise DeviceCompileError(f"convert to {target.value!r} not on device")
        dt = tmap[str(target.value).lower()]
        jdt = policy_dtype(dt)
        return (lambda env: astype(as_tensor(src(env), env), jdt)), dt, \
            _cast_ir(sir, ir_result_type(sir), TY_OF[jdt])
    if name == "eventTimestamp" and not expr.args:
        return (lambda env: env["__ts__"]), DataType.LONG, \
            [(OP["TS"], T_I64, 0, 0)]
    if name in ("maximum", "minimum"):
        fns = [compile_expression(a, resolver) for a in expr.args]
        t = fns[0][1]
        for _, ti, _ in fns[1:]:
            t = promote(t, ti)
        jdt = policy_dtype(t)
        ty = TY_OF[jdt]
        is_max = name == "maximum"
        # NaN-propagating, as jnp.max/jnp.min over the stacked arguments
        red = torch.maximum if is_max else torch.minimum

        def run(env, fns=fns, jdt=jdt):
            vs = [astype(as_tensor(f(env), env), jdt) for f, _, _ in fns]
            return functools.reduce(red, torch.broadcast_tensors(*vs))

        ir = _cast_ir(fns[0][2], ir_result_type(fns[0][2]), ty)
        for _, _, fir in fns[1:]:
            ir = ir + _cast_ir(fir, ir_result_type(fir), ty) + \
                [(OP["MAX" if is_max else "MIN"], ty, 0, 0)]
        return run, t, ir
    raise DeviceCompileError(f"function '{name}' not device-compilable")
