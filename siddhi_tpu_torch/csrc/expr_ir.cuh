// Typed postfix-IR evaluator shared by the port's CUDA kernels.
//
// Replaces, from the reference JAX package, tpu/expr_compile.py::
// compile_expression and helpers (B2): predicates and outputs are compiled
// by gpu/expr_compile.py into a typed postfix IR of (op, type, a, b) int4
// instructions, and every kernel (nfa_block.cu, nfa_scan.cu) runs them
// through eval_prog below, so one build serves every app and both kernels
// evaluate expressions through one code path.
//
// Values are int64 slots: bool 0/1, i32 sign-extended, i64 as is, f32 as
// its bit pattern in the low 32 bits. Integer arithmetic wraps; integer
// division/modulo reproduce XLA's values for a zero divisor; f32 arithmetic
// uses the _rn intrinsics (and the build passes --fmad=false) so rounding
// matches the plain version; float -> int conversion saturates, NaN -> 0.
// OP_TS (eventTimestamp()) is refused by the wrappers before any launch, as
// the reference's NFA steps raise KeyError('__ts__') for it.
//
// eval_fast runs the same programs with a four-value stack in registers.
// A predicate that is a conjunction of comparisons also has a clause form
// (gpu/expr_compile.py::clause_form); clause_at, clause_operand and
// eval_clauses below are its one reader.
//
// Also here: block_rank, the block-wide ordered rank (warp ballots + a
// prefix over warps) that the kernels compact and insert with,
// block_reduce, and warp_min / warp_max.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MAXSTACK
#define MAXSTACK 32
#endif

enum Op {
  OP_EV = 1, OP_BIND, OP_TS, OP_CONST, OP_CAST, OP_ADD, OP_SUB, OP_MUL,
  OP_DIV, OP_MOD, OP_NEG, OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE, OP_AND,
  OP_OR, OP_NOT, OP_SELECT, OP_MAX, OP_MIN
};
enum Ty { T_BOOL = 0, T_I32 = 1, T_I64 = 2, T_F32 = 3 };

struct Prog { int off; int len; };

// ---------------------------------------------------------------- values
// A value is an int64 slot: bool 0/1, i32 sign-extended, i64 as is, f32 as
// its bit pattern in the low 32 bits.

__device__ __forceinline__ float as_f(long long v) {
  return __int_as_float((int)(unsigned)(unsigned long long)v);
}
__device__ __forceinline__ long long from_f(float f) {
  return (long long)(unsigned)__float_as_int(f);
}
__device__ __forceinline__ long long from_i32(int v) { return (long long)v; }

__device__ __forceinline__ long long load_typed(const void* p, int ty, long long i) {
  switch (ty) {
    case T_BOOL: return ((const unsigned char*)p)[i] != 0;
    case T_I32: return from_i32(((const int*)p)[i]);
    case T_I64: return ((const long long*)p)[i];
    default: return (long long)(unsigned)((const unsigned*)p)[i];
  }
}

__device__ __forceinline__ void store_typed(void* p, int ty, long long i, long long v) {
  switch (ty) {
    case T_BOOL: ((unsigned char*)p)[i] = (unsigned char)(v != 0); break;
    case T_I32: ((int*)p)[i] = (int)v; break;
    case T_I64: ((long long*)p)[i] = v; break;
    default: ((unsigned*)p)[i] = (unsigned)(unsigned long long)v; break;
  }
}

__device__ __forceinline__ long long f2i_sat(float f, int bits) {
  // XLA convert: truncate, saturate at the integer range, NaN -> 0
  if (f != f) return 0;
  if (bits == 32) {
    if (f >= 2147483648.0f) return 2147483647LL;
    if (f <= -2147483648.0f) return -2147483647LL - 1;
    return (long long)(int)f;
  }
  if (f >= 9223372036854775808.0f) return 9223372036854775807LL;
  if (f <= -9223372036854775808.0f) return -9223372036854775807LL - 1;
  return (long long)f;
}

__device__ __forceinline__ long long cast_val(long long v, int src, int dst) {
  if (src == dst) return v;
  switch (dst) {
    case T_BOOL:
      return src == T_F32 ? (as_f(v) != 0.0f) : (v != 0);
    case T_I32:
      if (src == T_F32) return f2i_sat(as_f(v), 32);
      return from_i32((int)(unsigned)(unsigned long long)v);   // wraps
    case T_I64:
      if (src == T_F32) return f2i_sat(as_f(v), 64);
      return v;
    default:
      if (src == T_I64) return from_f(__ll2float_rn(v));
      return from_f(__int2float_rn((int)v));
  }
}

// ------------------------------------------------- integer division (XLA)
template <typename T, typename U>
struct IntOps {
  static __device__ __forceinline__ T tmin() { return (T)((U)1 << (sizeof(T) * 8 - 1)); }
  static __device__ __forceinline__ T xdiv(T a, T b) {
    if (b == 0) return (T)-1;
    if (a == tmin() && b == (T)-1) return a;
    return a / b;
  }
  static __device__ __forceinline__ T xrem(T a, T b) {
    if (b == 0) return a;
    if (a == tmin() && b == (T)-1) return 0;
    return a % b;
  }
  static __device__ __forceinline__ T sgn(T a) { return (T)((a > 0) - (a < 0)); }
  static __device__ __forceinline__ T wabs(T a) { return a < 0 ? (T)((U)0 - (U)a) : a; }
  static __device__ __forceinline__ T floordiv(T a, T b) {
    T q = xdiv(a, b);
    return (sgn(a) != sgn(b) && xrem(a, b) != 0) ? (T)((U)q - (U)1) : q;
  }
  static __device__ __forceinline__ T remainder(T a, T b) {
    if (b == 0) b = 1;
    T t = xrem(a, b);
    return (((t < 0) != (b < 0)) && t != 0) ? (T)((U)t + (U)b) : t;
  }
  static __device__ __forceinline__ T java_div(T a, T b) {
    T q = floordiv(wabs(a), wabs(b));
    return ((a >= 0) == (b >= 0)) ? q : (T)((U)0 - (U)q);
  }
  static __device__ __forceinline__ T java_mod(T a, T b) {
    return (T)((U)sgn(a) * (U)remainder(wabs(a), wabs(b)));
  }
};
typedef IntOps<int, unsigned> I32Ops;
typedef IntOps<long long, unsigned long long> I64Ops;

__device__ __forceinline__ long long arith(int op, int ty, long long a, long long b) {
  if (ty == T_F32) {
    float x = as_f(a), y = as_f(b);
    switch (op) {
      case OP_ADD: return from_f(__fadd_rn(x, y));
      case OP_SUB: return from_f(__fsub_rn(x, y));
      case OP_MUL: return from_f(__fmul_rn(x, y));
      case OP_DIV: return from_f(__fdiv_rn(x, y));
      case OP_MOD: return from_f(fmodf(x, y));
      case OP_MAX: return (x != x || y != y) ? from_f(__int_as_float(0x7fc00000)) : from_f(fmaxf(x, y));
      default: return (x != x || y != y) ? from_f(__int_as_float(0x7fc00000)) : from_f(fminf(x, y));
    }
  }
  if (ty == T_BOOL) {
    switch (op) {
      case OP_ADD: case OP_MAX: return (a | b) != 0;
      default: return (a & b) != 0;          // MUL, MIN
    }
  }
  if (ty == T_I32) {
    int x = (int)a, y = (int)b;
    switch (op) {
      case OP_ADD: return from_i32((int)((unsigned)x + (unsigned)y));
      case OP_SUB: return from_i32((int)((unsigned)x - (unsigned)y));
      case OP_MUL: return from_i32((int)((unsigned)x * (unsigned)y));
      case OP_DIV: return from_i32(I32Ops::java_div(x, y));
      case OP_MOD: return from_i32(I32Ops::java_mod(x, y));
      case OP_MAX: return x > y ? x : y;
      default: return x < y ? x : y;
    }
  }
  unsigned long long ux = (unsigned long long)a, uy = (unsigned long long)b;
  switch (op) {
    case OP_ADD: return (long long)(ux + uy);
    case OP_SUB: return (long long)(ux - uy);
    case OP_MUL: return (long long)(ux * uy);
    case OP_DIV: return I64Ops::java_div(a, b);
    case OP_MOD: return I64Ops::java_mod(a, b);
    case OP_MAX: return a > b ? a : b;
    default: return a < b ? a : b;
  }
}

__device__ __forceinline__ long long compare(int op, int ty, long long a, long long b) {
  if (ty == T_F32) {
    float x = as_f(a), y = as_f(b);
    switch (op) {
      case OP_EQ: return x == y;
      case OP_NE: return x != y;
      case OP_LT: return x < y;
      case OP_LE: return x <= y;
      case OP_GT: return x > y;
      default: return x >= y;
    }
  }
  switch (op) {
    case OP_EQ: return a == b;
    case OP_NE: return a != b;
    case OP_LT: return a < b;
    case OP_LE: return a <= b;
    case OP_GT: return a > b;
    default: return a >= b;
  }
}

// A constant's value slot, held in an instruction's last two words.
__device__ __forceinline__ long long const_of(const int4& in) {
  return (long long)(((unsigned long long)(unsigned)in.w << 32) |
                     (unsigned long long)(unsigned)in.z);
}

// Evaluates one program. ev(c) returns event column c's value slot and
// bind(k) the k-th bound value the program was linked against.
template <class EvF, class BindF>
__device__ __forceinline__ long long eval_prog(const int4* __restrict__ code,
                                               Prog p, EvF ev, BindF bind) {
  long long st[MAXSTACK];
  int sp = 0;
  for (int i = 0; i < p.len; ++i) {
    const int4 in = code[p.off + i];
    switch (in.x) {
      case OP_EV: st[sp++] = ev(in.z); break;
      case OP_BIND: st[sp++] = bind(in.z); break;
      case OP_TS: st[sp++] = 0; break;          // refused before launch
      case OP_CONST: st[sp++] = const_of(in); break;
      case OP_CAST: st[sp - 1] = cast_val(st[sp - 1], in.z, in.y); break;
      case OP_NEG:
        if (in.y == T_F32) st[sp - 1] = from_f(-as_f(st[sp - 1]));
        else if (in.y == T_I32) st[sp - 1] = from_i32((int)(0u - (unsigned)st[sp - 1]));
        else st[sp - 1] = (long long)(0ull - (unsigned long long)st[sp - 1]);
        break;
      case OP_NOT: st[sp - 1] = st[sp - 1] == 0; break;
      case OP_AND: --sp; st[sp - 1] = (st[sp - 1] != 0) & (st[sp] != 0); break;
      case OP_OR: --sp; st[sp - 1] = (st[sp - 1] != 0) | (st[sp] != 0); break;
      case OP_EQ: case OP_NE: case OP_LT: case OP_LE: case OP_GT: case OP_GE:
        --sp; st[sp - 1] = compare(in.x, in.z, st[sp - 1], st[sp]); break;
      case OP_SELECT:
        sp -= 2; st[sp - 1] = st[sp - 1] ? st[sp] : st[sp + 1]; break;
      default:   // ADD SUB MUL DIV MOD MAX MIN
        --sp; st[sp - 1] = arith(in.x, in.y, st[sp - 1], st[sp]); break;
    }
  }
  return st[0];
}

// eval_prog with the stack in four registers (top first), for programs
// that never hold more than four values; a deeper program is evaluated
// again by eval_prog (programs read their operands and nothing else, so
// the result is the same). The same operations in the same order as
// eval_prog, without its stack in local memory.
template <class EvF, class BindF>
__device__ __forceinline__ long long eval_fast(const int4* __restrict__ code,
                                               Prog p, EvF ev, BindF bind) {
  long long s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  int sp = 0;
  for (int i = 0; i < p.len; ++i) {
    const int4 in = code[p.off + i];
    switch (in.x) {
      case OP_EV: case OP_BIND: case OP_TS: case OP_CONST: {
        if (sp == 4) return eval_prog(code, p, ev, bind);
        long long v;
        if (in.x == OP_EV) v = ev(in.z);
        else if (in.x == OP_BIND) v = bind(in.z);
        else if (in.x == OP_TS) v = 0;           // refused before launch
        else v = const_of(in);
        s3 = s2; s2 = s1; s1 = s0; s0 = v; ++sp;
        break;
      }
      case OP_CAST: s0 = cast_val(s0, in.z, in.y); break;
      case OP_NEG:
        if (in.y == T_F32) s0 = from_f(-as_f(s0));
        else if (in.y == T_I32) s0 = from_i32((int)(0u - (unsigned)s0));
        else s0 = (long long)(0ull - (unsigned long long)s0);
        break;
      case OP_NOT: s0 = s0 == 0; break;
      case OP_SELECT:
        s0 = s2 ? s1 : s0; s1 = s3; sp -= 2;
        break;
      default: {
        long long r;
        if (in.x == OP_AND) r = (s1 != 0) & (s0 != 0);
        else if (in.x == OP_OR) r = (s1 != 0) | (s0 != 0);
        else if (in.x >= OP_EQ && in.x <= OP_GE) r = compare(in.x, in.z, s1, s0);
        else r = arith(in.x, in.y, s1, s0);     // ADD SUB MUL DIV MOD MAX MIN
        s0 = r; s1 = s2; s2 = s3; --sp;
      }
    }
  }
  return s0;
}

// ------------------------------------------------------------ clause form
// A predicate that is a conjunction of comparisons, as clause_form writes
// it: two int4 words a clause, (compare op, compare type, x kind, x index)
// and (x cast, y kind, y index, y cast). An operand is an event column
// (OP_EV), a bound value (OP_BIND) or a constant (OP_CONST, its index the
// code row that holds it); a cast is src << 8 | dst, or -1. The compares
// and casts are the program's.

struct Clause { int op, ty, xk, xi, xc, yk, yi, yc; };

__device__ __forceinline__ Clause clause_at(const int4* __restrict__ code, Prog p, int i) {
  const int4 w0 = code[p.off + 2 * i], w1 = code[p.off + 2 * i + 1];
  return Clause{w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
}

__device__ __forceinline__ long long cast_opt(long long v, int cast) {
  return cast >= 0 ? cast_val(v, cast >> 8, cast & 255) : v;
}

// An operand's value, cast: ev(c) gives event column c's value slot and
// bind(k) the k-th bound value.
template <class EvF, class BindF>
__device__ __forceinline__ long long clause_operand(const int4* __restrict__ code, int kind,
                                                    int idx, int cast, EvF ev, BindF bind) {
  const long long v = kind == OP_EV ? ev(idx) : kind == OP_BIND ? bind(idx)
                                                                : const_of(code[idx]);
  return cast_opt(v, cast);
}

// True when every clause of the clause-form program p holds, as the
// predicate's program would compute.
template <class EvF, class BindF>
__device__ __forceinline__ bool eval_clauses(const int4* __restrict__ code, Prog p, EvF ev,
                                             BindF bind) {
#pragma unroll 1
  for (int i = 0; i < p.len; ++i) {
    const Clause c = clause_at(code, p, i);
    if (!compare(c.op, c.ty, clause_operand(code, c.xk, c.xi, c.xc, ev, bind),
                 clause_operand(code, c.yk, c.yi, c.yc, ev, bind)))
      return false;
  }
  return true;
}

// -------------------------------------------------------- block helpers

// Exclusive rank of every set flag among flag[0..n) in order (-1 where
// unset); returns the number of set flags. Every thread of the block must
// call it; the block has NT threads (blockDim.x when NT is 0), a multiple
// of 32, and s_scan holds NT / 32 + 1 ints.
template <int NT = 0>
__device__ __forceinline__ int block_rank(const unsigned char* flag, int* rank,
                                          int n, int* s_scan) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = NT > 0 ? NT : (int)blockDim.x, nw = (nt + 31) >> 5;
  __syncthreads();
  if (tid == 0) s_scan[nw] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += nt) {
    const int i = base + tid;
    const int f = (i < n) ? (flag[i] != 0) : 0;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    const int pre = __popc(m & ((1u << lane) - 1u));
    if (lane == 0) s_scan[warp] = __popc(m);
    __syncthreads();
    int off = s_scan[nw];
    for (int w = 0; w < warp; ++w) off += s_scan[w];
    if (i < n) rank[i] = f ? off + pre : -1;
    __syncthreads();
    if (tid == 0) {
      int tot = 0;
      for (int w = 0; w < nw; ++w) tot += s_scan[w];
      s_scan[nw] += tot;
    }
    __syncthreads();
  }
  return s_scan[nw];
}

// Block-wide reduction of one value per thread under op (every thread gets
// the result; the reduction's order is fixed: within warps, then warps in
// order). s_buf holds one entry per warp.
template <typename T, class Op>
__device__ T block_reduce(T v, Op op, T* s_buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const int ws = blockDim.x < 32 ? (int)blockDim.x : 32;
  for (int d = 16; d > 0; d >>= 1) {
    const T u = __shfl_down_sync(0xffffffffu, v, d);
    if (lane + d < ws) v = op(v, u);
  }
  __syncthreads();
  if (lane == 0) s_buf[warp] = v;
  __syncthreads();
  T tot = s_buf[0];
  for (int w = 1; w < nw; ++w) tot = op(tot, s_buf[w]);
  __syncthreads();
  return tot;
}

// The minimum (maximum) of v over the 32 lanes of a full warp, to every lane.
__device__ __forceinline__ long long warp_min(long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  return v;
}
__device__ __forceinline__ long long warp_max(long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}
