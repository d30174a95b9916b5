"""The port's expression compiler against the JAX package's.

Each expression is compiled by both packages (from their own parsers) over
the same seeded numpy columns; the port's torch closure must give the JAX
closure's dtype and values exactly (NaN where NaN). The same expression's
kernel IR, linked as the CUDA kernel receives it, is evaluated by a numpy
model of the kernel's interpreter (``_run_ir`` below mirrors
``eval_prog`` in ``csrc/expr_ir.cuh``: int64 value slots, f32 as bits,
wrapping integer arithmetic, XLA division rules) and must agree too.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu.compiler import parse as jparse
from siddhi_tpu.tpu.batch import StringDictionary as JDict
from siddhi_tpu.tpu.expr_compile import DeviceCompileError as JCompileError
from siddhi_tpu.tpu.expr_compile import compile_expression as jcompile
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.gpu import nfa_block
from siddhi_tpu_torch.gpu.batch import StringDictionary as TDict
from siddhi_tpu_torch.gpu.expr_compile import (
    OP,
    OPS,
    DeviceCompileError,
    T_BOOL,
    T_F32,
    T_I32,
    T_I64,
    compile_expression as tcompile,
)
from siddhi_tpu_torch.gpu.nfa_block import link_program

ROOT = Path(__file__).resolve().parent.parent
SCHEMA = "define stream S (i int, j int, l long, f float, d double, s string, b bool);"
N = 64
I32_MIN, I32_MAX = -2**31, 2**31 - 1

EXPRS = [
    # Java integer division / modulo, zero divisors and INT_MIN included
    "i / j", "i % j", "l / j", "l % l", "i / 0", "i % 0", "j / i",
    # float arithmetic, mixed promotion
    "f / d", "f % d", "i + 1.5", "f + 0.1", "-f", "-i + j * 2", "l - i",
    "i * 1000000", "convert(i, 'double') / 3",
    # int column vs float constant: folded to exact int64 bounds
    "i > 2.5", "i <= -1.5", "l == 3.0", "i != 2.5", "3.5 < i", "i > 1e30",
    "l >= 1e300", "i == 2.0",
    # refused by both: long against a non-constant float (-c is Minus(c))
    "l >= -1e300", "l > f",
    # same-type and promoted compares, weak-typed constants
    "f > 50.1", "d <= 0.1", "f == d", "l > 5", "i < l", "b == true",
    # strings as dictionary codes
    "s == 'a'", "s != 'b'", "'c' == s",
    # logic
    "not (i > 0) or b and f > d", "i > 0 and not b",
    # functions
    "convert(f, 'int')", "cast(d * 10000000000.0, 'long')",
    "convert(i, 'bool')", "convert(b, 'int')", "convert(l, 'float')",
    "ifThenElse(i > j, f, d)", "ifThenElse(b, i, l)",
    "maximum(i, f, d)", "minimum(l, i)", "maximum(f, 2.0)",
    "eventTimestamp()", "eventTimestamp() - l",
]


class _Resolver:
    def __init__(self, types, dic):
        self.types = types
        self.dic = dic

    def resolve(self, var):
        return f"ev_{var.attribute}", self.types[var.attribute]

    def encode_string(self, key, value):
        return self.dic.encode(value)


def _columns(seed=0):
    rng = np.random.default_rng(seed)
    i = rng.integers(-5, 6, N).astype(np.int32)
    i[:4] = [I32_MIN, I32_MAX, -1, 0]
    j = rng.integers(-3, 4, N).astype(np.int32)
    j[:4] = [-1, 0, I32_MIN, 0]
    l = rng.integers(-7, 8, N).astype(np.int64)
    f = np.round(rng.uniform(-100, 100, N), 2).astype(np.float32)
    f[:3] = [np.nan, 3e9, -0.0]
    d = np.round(rng.uniform(-100, 100, N), 1).astype(np.float32)
    d[5] = 0.0
    s = rng.integers(0, 4, N).astype(np.int32)
    b = rng.integers(0, 2, N).astype(bool)
    ts = (10**12 + rng.integers(0, 10**6, N)).astype(np.int64)
    return {"i": i, "j": j, "l": l, "f": f, "d": d, "s": s, "b": b}, ts


def _compile_both(text):
    """Both compilers' results; ``None`` for each one that refuses."""
    app = f"{SCHEMA}\nfrom S select {text} as r insert into O;"
    jexpr = jparse(app).queries[0].selector.attributes[0].expr
    texpr = tparse(app).queries[0].selector.attributes[0].expr
    jd, td = JDict(), TDict()
    for v in ("a", "b", "c"):
        jd.encode(v)
        td.encode(v)
    jdefs = jparse(app).stream_definitions["S"]
    tdefs = tparse(app).stream_definitions["S"]
    jres = _Resolver({a.name: a.type for a in jdefs.attributes}, jd)
    tres = _Resolver({a.name: a.type for a in tdefs.attributes}, td)
    out = []
    for fn, expr, res, err in ((jcompile, jexpr, jres, JCompileError),
                               (tcompile, texpr, tres, DeviceCompileError)):
        try:
            out.append(fn(expr, res))
        except err:
            out.append(None)
    return out


# ---- a numpy model of the kernel's interpreter ---------------------------

def _f32(v):
    return (v & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _from_f32(x):
    return np.asarray(x, np.float32).view(np.uint32).astype(np.int64)


def _typed(v, ty):
    """Slot → numpy value of the slot's static type."""
    return {T_BOOL: lambda: v != 0, T_I32: lambda: v.astype(np.int32),
            T_I64: lambda: v, T_F32: lambda: _f32(v)}[ty]()


def _slot(x, ty):
    if ty == T_F32:
        return _from_f32(x)
    return np.asarray(x).astype(np.int64)


def _f2i(x, bits):
    hi = float(2 ** (bits - 1))
    r = np.trunc(np.nan_to_num(x.astype(np.float64), nan=0.0))
    r = np.clip(r, -hi, hi - 1)
    out = r.astype(np.int64)
    return np.where(x >= hi, 2 ** (bits - 1) - 1, np.where(x != x, 0, out))


def _cast(v, src, dst):
    if src == dst:
        return v
    if dst == T_BOOL:
        return (_f32(v) != 0) if src == T_F32 else (v != 0)
    if dst == T_I32:
        return _f2i(_f32(v), 32) if src == T_F32 else \
            v.astype(np.int32).astype(np.int64)
    if dst == T_I64:
        return _f2i(_f32(v), 64) if src == T_F32 else v
    return _from_f32(v.astype(np.float32))      # ints/bool → f32, RN


def _intdiv(a, b, dt):
    mn = np.iinfo(dt).min
    zero, ovf = b == 0, (a == mn) & (b == -1)
    bs = np.where(zero | ovf, 1, b).astype(dt)
    q = np.where(zero, -1, np.where(ovf, a, np.fix(a / bs).astype(dt)))
    r = np.where(zero, a, np.where(ovf, 0, np.fmod(a, bs)))
    return q.astype(dt), r.astype(dt)


def _java(op, a, b, dt):
    with np.errstate(all="ignore"):
        aa, ab = np.abs(a), np.abs(b)               # wraps at MIN
        q, r = _intdiv(aa, ab, dt)
        if op == OP["DIV"]:
            fq = np.where((np.sign(aa) != np.sign(ab)) & (r != 0), q - 1, q)
            return np.where((a >= 0) == (b >= 0), fq, -fq).astype(dt)
        bb = np.where(ab == 0, 1, ab).astype(dt)
        _, t = _intdiv(aa, bb, dt)
        t = np.where(((t < 0) != (bb < 0)) & (t != 0), t + bb, t).astype(dt)
        return (np.sign(a) * t).astype(dt)


def _arith(op, ty, a, b):
    if ty == T_F32:
        x, y = _f32(a), _f32(b)
        with np.errstate(all="ignore"):
            r = {OP["ADD"]: lambda: x + y, OP["SUB"]: lambda: x - y,
                 OP["MUL"]: lambda: x * y, OP["DIV"]: lambda: x / y,
                 OP["MOD"]: lambda: np.fmod(x, y),
                 OP["MAX"]: lambda: np.maximum(x, y),
                 OP["MIN"]: lambda: np.minimum(x, y)}[op]()
        return _from_f32(r)
    if ty == T_BOOL:
        return ((a | b) if op in (OP["ADD"], OP["MAX"]) else (a & b)) != 0
    dt = np.int32 if ty == T_I32 else np.int64
    x, y = a.astype(dt), b.astype(dt)
    with np.errstate(all="ignore"):
        if op in (OP["DIV"], OP["MOD"]):
            r = _java(op, x, y, dt)
        else:
            r = {OP["ADD"]: lambda: x + y, OP["SUB"]: lambda: x - y,
                 OP["MUL"]: lambda: x * y, OP["MAX"]: lambda: np.maximum(x, y),
                 OP["MIN"]: lambda: np.minimum(x, y)}[op]()
    return r.astype(np.int64)


_CMP = {OP["EQ"]: np.equal, OP["NE"]: np.not_equal, OP["LT"]: np.less,
        OP["LE"]: np.less_equal, OP["GT"]: np.greater,
        OP["GE"]: np.greater_equal}


def _run_ir(code, ev, ts):
    """Evaluates linked instructions ``[n, 4]`` the way the kernel does."""
    st = []
    for op, ty, a, b in code.tolist():
        if op == OP["EV"]:
            st.append(ev[a])
        elif op == OP["TS"]:
            st.append(ts)
        elif op == OP["CONST"]:
            bits = (b << 32) | (a & 0xFFFFFFFF)
            st.append(np.full(N, np.array(bits & (2**64 - 1), np.uint64)
                              .view(np.int64)))
        elif op == OP["CAST"]:
            st[-1] = _cast(st[-1], a, ty)
        elif op == OP["NEG"]:
            with np.errstate(all="ignore"):
                st[-1] = _from_f32(-_f32(st[-1])) if ty == T_F32 else \
                    _slot(-_typed(st[-1], ty), ty)
        elif op == OP["NOT"]:
            st[-1] = (st[-1] == 0).astype(np.int64)
        elif op in (OP["AND"], OP["OR"]):
            y = st.pop()
            fn = np.logical_and if op == OP["AND"] else np.logical_or
            st[-1] = fn(st[-1] != 0, y != 0).astype(np.int64)
        elif op in _CMP:
            y = st.pop()
            st[-1] = _CMP[op](_typed(st[-1], a), _typed(y, a)).astype(np.int64)
        elif op == OP["SELECT"]:
            y, x = st.pop(), st.pop()
            st[-1] = np.where(st[-1] != 0, x, y)
        else:
            y = st.pop()
            st[-1] = _arith(op, ty, st[-1], y)
    assert len(st) == 1
    return st[0]


@pytest.mark.parametrize("text", EXPRS)
def test_closure_and_ir_match_jax(text):
    jres, tres = _compile_both(text)
    assert (jres is None) == (tres is None), "refused by one compiler only"
    if jres is None:
        return
    (jfn, jt), (tfn, tt, ir) = jres, tres
    assert jt.name == tt.name
    cols, ts = _columns()
    jenv = {f"ev_{k}": jnp.asarray(v) for k, v in cols.items()}
    jenv["__ts__"] = jnp.asarray(ts)
    tenv = {f"ev_{k}": torch.from_numpy(v) for k, v in cols.items()}
    tenv["__ts__"] = torch.from_numpy(ts)
    tenv["__device__"] = torch.device("cpu")
    ref = np.broadcast_to(np.asarray(jax.device_get(jfn(jenv))), (N,))
    got = tfn(tenv)
    got = np.broadcast_to(got.numpy() if isinstance(got, torch.Tensor)
                          else np.asarray(got), (N,))
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)

    # the kernel's form: link as the kernel receives it, run the model
    slots = {k: i for i, k in enumerate(cols)}
    code = link_program(ir, slots, {})
    ev = [_slot(cols[k], {np.dtype(np.float32): T_F32,
                          np.dtype(np.int32): T_I32,
                          np.dtype(np.int64): T_I64,
                          np.dtype(bool): T_BOOL}[cols[k].dtype])
          for k in cols]
    res_ty = ir[-1][1]
    out = _typed(_run_ir(code, ev, ts), res_ty)
    np.testing.assert_array_equal(np.asarray(out).astype(ref.dtype), ref)


def test_division_by_zero_never_raises_and_matches_jax():
    # JAX on the CPU returns values here; torch would raise
    # ZeroDivisionError on a plain integer division — the port must not
    (jfn, _), (tfn, _, _) = _compile_both("i / j")
    a = np.array([7, 0, -7, I32_MIN, 5], np.int32)
    z = np.zeros(5, np.int32)
    tenv = {"ev_i": torch.from_numpy(a), "ev_j": torch.from_numpy(z),
            "__device__": torch.device("cpu")}
    got = tfn(tenv).numpy()
    ref = np.asarray(jfn({"ev_i": jnp.asarray(a), "ev_j": jnp.asarray(z)}))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [-2, -1, 2, 2, -2])
    (jfn, _), (tfn, _, _) = _compile_both("i % j")
    np.testing.assert_array_equal(tfn(tenv).numpy(), np.zeros(5, np.int32))


def test_string_constant_without_comparison_is_refused():
    assert _compile_both("'x'") == [None, None]


def test_kernel_source_agrees_with_the_python_constants():
    csrc = ROOT / "siddhi_tpu_torch" / "csrc"
    src = (csrc / "nfa_block.cu").read_text()
    # the IR's op and type enums live in the header both kernels include
    ir = (csrc / "expr_ir.cuh").read_text()
    assert '#include "expr_ir.cuh"' in src
    assert '#include "expr_ir.cuh"' in (csrc / "nfa_scan.cu").read_text()
    body = re.search(r"enum Op \{(.*?)\};", ir, re.S).group(1)
    names = [n.strip().split("=")[0].strip()[3:] for n in body.split(",")
             if n.strip()]
    assert names == list(OPS) and OP[OPS[0]] == 1
    ty = re.search(r"enum Ty \{(.*?)\};", ir, re.S).group(1)
    assert [int(x) for x in re.findall(r"= (\d+)", ty)] == \
        [T_BOOL, T_I32, T_I64, T_F32]
    for name in ("MAXCOL", "MAXB", "MAXOUT", "MAXSTACK"):
        m = re.search(rf"#define {name} (\d+)", src)
        assert int(m.group(1)) == getattr(nfa_block, name), name
