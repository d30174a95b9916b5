// Shared by the single-stream query kernels (query_step.cu, query_walk.cu):
// the argument block QArgs (mirrored by gpu/query_step.py with ctypes), the
// block-wide scans and reductions, the step's first stage, the filter and
// the stable compaction of the accepted events (compact_batch), and the
// tile primitives of query_step.cu's device-wide passes (tile_scan,
// fold_tiles: reduce-then-scan over tiles of TILE positions, in an order
// fixed by the tile layout alone).
//
// Replaces, from the reference JAX package, the head of tpu/query_compile.py
// ::CompiledStreamQuery._make_step (filters, compact(), agg_stack(), the
// group and heavy-hitter key codes, the sort key).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXSTACK 32
#include "expr_ir.cuh"

#define QMAXCOL 32
#define QMAXSPEC 32
#define QMAXLANE 16
#define QMAXFILT 8
#define QMAXGK 8
#define FULL 0xffffffffu

enum {
  W_NONE = 0, W_LENGTH, W_TIME, W_TIMELENGTH, W_BATCH,
  W_LBATCH, W_TBATCH, W_SESSION, W_DELAY, W_HOPPING,
  W_SORT, W_FREQ, W_LOSSY
};
enum { S_VALUE = 0, S_COUNT, S_SUM, S_AVG, S_MIN, S_MAX, S_STD };
enum { KM_NARROW = 0, KM_WIDE1, KM_PAIR, KM_FNV };
enum { L_F = 0, L_I, L_S, L_M };

#define TS_NEG (-(1LL << 62))
#define TS_POS (1LL << 62)

struct QArgs {
  int B, N, M, K, LV, NB;          // M: scan length bound; LV/NB: sparse table
  int O;                           // output slots: B, or M (remainder windows)
  int wkind, grouped, key_mode, has_agg;
  int nfilt, ncol, nspec, ngk;
  int AF, AI, AS, AM, ntask;
  int has_wprog, has_having;
  int sort_kty, sort_desc;         // sort key type (T_*), descending order
  long long window_ms, hop_ms;
  long long skey_fill;             // sort key of an empty slot (slot bits)
  double hh_support, hh_error;
  int col_ty[QMAXCOL];
  int spec_kind[QMAXSPEC], spec_ty[QMAXSPEC], spec_lane[QMAXSPEC], spec_int[QMAXSPEC];
  int m_ty[QMAXLANE], m_min[QMAXLANE];
  long long m_ident[QMAXLANE];
  Prog filt[QMAXFILT];
  Prog proj[QMAXSPEC];
  Prog lane[4][QMAXLANE];
  Prog gk[QMAXGK];
  Prog wprog, having, skey;
  const int4* code;
  const void* col[QMAXCOL];
  const long long* ts;
  const unsigned char* valid;
  // state in (meaning by mode: tails | grouped [K] tables | running |
  // sort buffer | heavy-hitter table)
  const float* f_in; const float* fc_in; const long long* i_in;
  const float* s_in; const float* smean_in; const float* sm2_in; const float* scnt_in;
  const int* ones_in; const long long* cnt_in;
  const void* m_in[QMAXLANE];
  const long long* tts_in; const int* gkey_in;
  const long long* owner_in; const unsigned char* owned_in;
  const long long* last_ts_in; const long long* drops_in;
  const long long* regress_in; const long long* coll_in;
  const int* rc_in;                // rem_count | sort_n
  const long long* rts_in;         // rem_ts
  const long long* base_in;        // batch_base | hop_next
  const void* skeys_in;            // sort_keys
  const long long* hkeys_in; const long long* hcnt_in; const long long* hdelta_in;
  const float* runf_in; const long long* runi_in;
  const long long* runc_in; const long long* htot_in;
  const void* rp_in[QMAXSPEC];     // rem_proj_i | tail_proj_i
  // state out (fresh buffers)
  float* f_out; float* fc_out; long long* i_out;
  float* s_out; float* smean_out; float* sm2_out; float* scnt_out;
  int* ones_out; long long* cnt_out;
  void* m_out[QMAXLANE];
  long long* tts_out; int* gkey_out;
  long long* owner_out; unsigned char* owned_out;
  long long* last_ts_out; long long* drops_out;
  long long* regress_out; long long* coll_out;
  int* rc_out;
  long long* rts_out;
  long long* base_out;
  void* skeys_out;
  long long* hkeys_out; long long* hcnt_out; long long* hdelta_out;
  float* runf_out; long long* runi_out;
  long long* runc_out; long long* htot_out;
  void* rp_out[QMAXSPEC];
  // outputs ([O])
  void* out[QMAXSPEC];
  unsigned char* ovalid; long long* ots; int* ocount;
  // scratch
  int* misc;                        // [0] k, [1] scan length P, [2] remainder
                                    // r, [3] valid or released slots
  unsigned char* mask; int* rank;   // [B]
  int* ccnt;                        // [ceil(B / TN)] accepted events a CTA
  float* bf; long long* bi; float* bs; long long* bm;   // batch lanes [A, B]
  int* bones; long long* bpacked; int* bkey; long long* bwts;   // [B]
  long long* bkeyv;                 // [B] sort key slots
  long long* bv;                    // [nspec, B] value projections (hopping)
  int* lo; int* hi;                 // [O] output ranges [lo, hi] on the axis
  unsigned char* oflag;             // [O] validity before having
  long long* zt;                    // [M] the axis clock (monotonised)
  long long* zseg;                  // [M] segment ids
  int* firstidx; int* cnt; int* seg;   // [K]
  float* ckey;                      // [AS, K] (or [AS]) stdDev centres
  int* sorted; unsigned char* head; // [M]
  double* incf; long long* inci; long long* inco;   // [AF, M], [AI, M], [M]
  double* incs1; double* incs2;     // [AS, M]
  long long* mP; long long* mS;     // [AM, M]
  long long* mT;                    // [AM, 7 NB + LV NC] block and chunk tables
  int* pz;                          // [AF + 2 AS, 3] one-hot poison (grouped)
  int* gmat;                        // [nrow, K] per-row bucket counts (group-by)
  long long* tagg;                  // [1 + ntask, 4, ntile] tile aggregates
  int* tfl;                         // [1 + ntask, 4, ntile] their segment flags
  int* tpz;                         // [1 + ntask, 2, 3, ntile] tiles' poison
  long long* acc;                   // [4] step scalars of the passes
  int* hidx;                        // [hh_H] heavy hitters' key -> slot index
  unsigned* hfree;                  // [(N + 31) / 32] their free-slot bits
  int hh_H;                         // index positions: a power of two >= 2 N
  int hh_shared;                    // set by query_walk's host entry: the
                                    // table lives in shared memory
  int ntile;                        // tiles of TILE positions over M
  int nrow, gsub;                   // group-by sort: rows of gsub positions
  int npar;                         // fleet parameter columns having reads
  int par_col[QMAXCOL];             // their event column slots
  long long* pc;                    // [npar, B] their values, compacted
};

// ------------------------------------------------------------------ helpers

struct ColAt {
  const QArgs* a; int b;
  __device__ long long operator()(int c) const {
    return load_typed(a->col[c], a->col_ty[c], b);
  }
};
struct NoBindQ {
  __device__ long long operator()(int) const { return 0; }
};
struct OutAt {
  const long long* v;
  __device__ long long operator()(int k) const { return v[k]; }
};
// having's event reads: fleet parameter p at output slot b, compacted with
// the accepted events as the reference compacts its parameter columns
// (the having program links each parameter to its ordinal p)
struct ParAt {
  const QArgs* a; int b;
  __device__ long long operator()(int p) const {
    return a->pc[(long long)p * a->B + b];
  }
};

__device__ __forceinline__ long long eval_row(const QArgs& a, Prog p, int b) {
  return eval_prog(a.code, p, ColAt{&a, b}, NoBindQ{});
}

// min/max of two value slots of type ty; NaN propagates (jnp.minimum)
__device__ __forceinline__ long long red_slot(int ty, int is_min, long long x,
                                              long long y) {
  if (ty == T_F32) {
    const float fx = as_f(x), fy = as_f(y);
    if (fx != fx) return x;
    if (fy != fy) return y;
    return (is_min ? (fy < fx) : (fy > fx)) ? y : x;
  }
  return (is_min ? (y < x) : (y > x)) ? y : x;
}

__device__ __forceinline__ unsigned long long avalanche64(unsigned long long x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  x = x ^ (x >> 31);
  return x & 0x7FFFFFFFFFFFFFFFull;
}

__device__ __forceinline__ int bucket_of(const QArgs& a, long long packed) {
  unsigned long long u = (unsigned long long)packed;
  if (a.key_mode == KM_NARROW) u &= 0x7FFFFFFFFFFFFFFFull;
  else u = avalanche64(u);
  return (int)(u % (unsigned long long)a.K);
}

__device__ __forceinline__ float f32_of(double v) { return __double2float_rn(v); }

// Inclusive segmented scan over s in [0, P) of get(s) under op; a segment
// starts where head(s) is true (and at s = 0); put(s, v) receives each
// result. Every thread of the block calls it. s_val/s_flag hold 33 entries.
template <typename T, class Op, class Get, class Head, class Put>
__device__ void block_seg_scan(int P, Op op, Get get, Head head, Put put,
                               T* s_val, int* s_flag) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = (nt + 31) >> 5;
  T carry = T();
  for (int base = 0; base < P; base += nt) {
    const int s = base + tid;
    const bool in = s < P;
    T v = in ? get(s) : T();
    int f = in ? (s == 0 || head(s)) : 1;
    for (int d = 1; d < 32; d <<= 1) {
      const T vu = __shfl_up_sync(FULL, v, d);
      const int fu = __shfl_up_sync(FULL, f, d);
      if (lane >= d) {
        if (!f) v = op(vu, v);
        f |= fu;
      }
    }
    __syncthreads();
    if (lane == 31 || tid == nt - 1) { s_val[warp] = v; s_flag[warp] = f; }
    __syncthreads();
    if (warp == 0) {
      T wv = lane < nw ? s_val[lane] : T();
      int wf = lane < nw ? s_flag[lane] : 1;
      for (int d = 1; d < 32; d <<= 1) {
        const T vu = __shfl_up_sync(FULL, wv, d);
        const int fu = __shfl_up_sync(FULL, wf, d);
        if (lane >= d) {
          if (!wf) wv = op(vu, wv);
          wf |= fu;
        }
      }
      if (lane < nw) { s_val[lane] = wv; s_flag[lane] = wf; }
    }
    __syncthreads();
    if (warp > 0 && !f) { v = op(s_val[warp - 1], v); f = s_flag[warp - 1]; }
    if (base > 0 && !f) v = op(carry, v);
    if (in) put(s, v);
    __syncthreads();
    if (tid == nt - 1) s_val[32] = v;
    __syncthreads();
    carry = s_val[32];
    __syncthreads();
  }
}

struct AddOp {
  template <typename T> __device__ T operator()(T x, T y) const { return x + y; }
};
struct MaxI64 {
  __device__ long long operator()(long long x, long long y) const { return x > y ? x : y; }
};
struct MinI64 {
  __device__ long long operator()(long long x, long long y) const { return x < y ? x : y; }
};

// Block-wide sum of one value per thread (every thread gets the total).
template <typename T>
__device__ T block_sum(T v, T* s_buf) { return block_reduce<T>(v, AddOp(), s_buf); }
struct RedOp {
  int ty, is_min;
  __device__ long long operator()(long long x, long long y) const {
    return red_slot(ty, is_min, x, y);
  }
};

__device__ __forceinline__ bool remainder_kind(int w) {
  return w == W_LBATCH || w == W_TBATCH || w == W_SESSION || w == W_DELAY;
}

// --------------------------------------------------- stage 1: compaction
// Filters -> mask and stable rank; every accepted event b goes to slot
// rank_b (compact_event): its aggregate arguments to the batch lanes, its
// group or heavy-hitter key code, window clock and sort key to their
// scratch, its value projections to out[i] at voff + rank_b (to bv for
// hopping), its timestamp to ots (where the output axis is the batch's),
// the fleet parameter columns that having reads to pc.
// Slots past the accepted count k hold the reference's fills
// (compact_fill). compact_batch runs it in one CTA; query_step.cu runs the
// same three parts over a grid (q_mask, q_compact).

__device__ __forceinline__ bool accept_event(const QArgs& a, int b) {
  bool m = a.valid[b] != 0;
  for (int f = 0; f < a.nfilt; ++f)
    m = m && (eval_row(a, a.filt[f], b) != 0);
  return m;
}

__device__ void compact_event(const QArgs& a, int b, int r, int voff) {
  const int B = a.B;
  const bool hop = a.wkind == W_HOPPING;
  const bool direct_ts = !(remainder_kind(a.wkind) || hop);
  if (direct_ts) a.ots[r] = a.ts[b];
  for (int i = 0; i < a.nspec; ++i)
    if (a.spec_kind[i] == S_VALUE) {
      const long long v = eval_row(a, a.proj[i], b);
      if (hop) a.bv[(long long)i * B + r] = v;
      else store_typed(a.out[i], a.spec_ty[i], voff + r, v);
    }
  for (int l = 0; l < a.AF; ++l)
    a.bf[(long long)l * B + r] = as_f(eval_row(a, a.lane[L_F][l], b));
  for (int l = 0; l < a.AI; ++l)
    a.bi[(long long)l * B + r] = eval_row(a, a.lane[L_I][l], b);
  for (int l = 0; l < a.AS; ++l)
    a.bs[(long long)l * B + r] = as_f(eval_row(a, a.lane[L_S][l], b));
  for (int l = 0; l < a.AM; ++l)
    a.bm[(long long)l * B + r] = eval_row(a, a.lane[L_M][l], b);
  a.bones[r] = 1;
  for (int p = 0; p < a.npar; ++p) {
    const int c = a.par_col[p];
    a.pc[(long long)p * B + r] = load_typed(a.col[c], a.col_ty[c], b);
  }
  if (a.ngk > 0) {
    unsigned long long packed = (unsigned long long)eval_row(a, a.gk[0], b);
    if (a.key_mode == KM_PAIR) {
      packed = (packed << 32) |
               ((unsigned long long)eval_row(a, a.gk[1], b) & 0xFFFFFFFFull);
    } else if (a.key_mode == KM_FNV) {
      for (int g = 1; g < a.ngk; ++g)
        packed = packed * 0x100000001B3ull ^
                 (unsigned long long)eval_row(a, a.gk[g], b);
    }
    a.bpacked[r] = (long long)packed;
  }
  a.bwts[r] = a.has_wprog ? eval_row(a, a.wprog, b) : a.ts[b];
  if (a.wkind == W_SORT) {
    long long v = eval_row(a, a.skey, b);
    if (a.sort_desc) {
      // stored negated (ascending order is the sort order); the integer
      // minimum has no negation and is clamped one up first
      if (a.sort_kty == T_F32) {
        v = from_f(-as_f(v));
      } else if (a.sort_kty == T_I32) {
        const int x = (int)v;
        v = from_i32(x == INT32_MIN ? -(INT32_MIN + 1) : -x);
      } else {
        v = v == INT64_MIN ? -(INT64_MIN + 1) : -v;
      }
    }
    a.bkeyv[r] = v;
  }
}

__device__ void compact_fill(const QArgs& a, int s, int voff) {
  const int B = a.B;
  const bool hop = a.wkind == W_HOPPING;
  const bool direct_ts = !(remainder_kind(a.wkind) || hop);
  if (direct_ts) a.ots[s] = 0;
  for (int i = 0; i < a.nspec; ++i)
    if (a.spec_kind[i] == S_VALUE) {
      if (hop) a.bv[(long long)i * B + s] = 0;
      else store_typed(a.out[i], a.spec_ty[i], voff + s, 0);
    }
  for (int l = 0; l < a.AF; ++l) a.bf[(long long)l * B + s] = 0.0f;
  for (int l = 0; l < a.AI; ++l) a.bi[(long long)l * B + s] = 0;
  for (int l = 0; l < a.AS; ++l) a.bs[(long long)l * B + s] = 0.0f;
  for (int l = 0; l < a.AM; ++l) a.bm[(long long)l * B + s] = a.m_ident[l];
  a.bones[s] = 0;
  for (int p = 0; p < a.npar; ++p) a.pc[(long long)p * B + s] = 0;
  a.bpacked[s] = 0;
  a.bwts[s] = TS_POS;
  a.bkeyv[s] = a.skey_fill;
}

// Returns k; every thread of the block calls it.
__device__ int compact_batch(const QArgs& a, int voff, int* s_scan) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int B = a.B;
  for (int b = tid; b < B; b += nt) a.mask[b] = accept_event(a, b);
  const int k = block_rank<0>(a.mask, a.rank, B, s_scan);
  for (int b = tid; b < B; b += nt) {
    const int r = a.rank[b];
    if (r >= 0) compact_event(a, b, r, voff);
  }
  for (int s = k + tid; s < B; s += nt) compact_fill(a, s, voff);
  __syncthreads();
  return k;
}

// ------------------------------------------- tiles of the device-wide passes
// query_step.cu's passes run as grids over tiles of TILE positions, TN
// threads a CTA, IPT consecutive positions a thread. A scan over an axis
// longer than one tile is a reduce-then-scan: one pass writes every tile's
// aggregate, the next folds the aggregates of the tiles before its own
// (fold_tiles) and rescans its tile from that carry. Every association is
// fixed by the tile layout (a thread's items in order, the lanes of a warp,
// the warps of the CTA, the tiles in order), never by which CTA ran first,
// so float64 sums round alike in every run.

#define TN 256
#define IPT 8
#define TILE (TN * IPT)

// An element of a segmented scan: a value and its flags (SEG_FULL: it holds
// a value, an empty element is the identity; SEG_HEAD: a segment starts in
// it, so nothing before it reaches past it).
enum { SEG_HEAD = 1, SEG_FULL = 2 };
template <typename T> struct Seg { T v; int f; };

template <typename T, class Op>
__device__ __forceinline__ Seg<T> seg_join(Op op, Seg<T> x, Seg<T> y) {
  if (!(y.f & SEG_FULL)) return x;
  if (!(x.f & SEG_FULL) || (y.f & SEG_HEAD)) return Seg<T>{y.v, x.f | y.f};
  return Seg<T>{op(x.v, y.v), x.f | y.f};
}

template <typename T>
__device__ __forceinline__ Seg<T> seg_shfl_up(Seg<T> x, int d) {
  return Seg<T>{__shfl_up_sync(FULL, x.v, d), __shfl_up_sync(FULL, x.f, d)};
}
template <typename T>
__device__ __forceinline__ Seg<T> seg_shfl_down(Seg<T> x, int d) {
  return Seg<T>{__shfl_down_sync(FULL, x.v, d), __shfl_down_sync(FULL, x.f, d)};
}

// Inclusive segmented scan, in place, of the CTA's tile: it[i] is item
// threadIdx.x * IPT + i. Association: each thread's items in order, then the
// threads of a warp (shuffles), then the warps (one warp over their totals).
// Returns the tile's total to every thread. Every thread of the CTA calls
// it; s_v/s_f hold TN / 32 entries.
template <typename T, class Op>
__device__ Seg<T> tile_scan(Op op, Seg<T> (&it)[IPT], T* s_v, int* s_f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int i = 1; i < IPT; ++i) it[i] = seg_join(op, it[i - 1], it[i]);
  Seg<T> x = it[IPT - 1];
  for (int d = 1; d < 32; d <<= 1) {
    const Seg<T> u = seg_shfl_up(x, d);
    if (lane >= d) x = seg_join(op, u, x);
  }
  Seg<T> ex = seg_shfl_up(x, 1);
  if (lane == 0) ex = Seg<T>{T(), 0};
  if (lane == 31 || threadIdx.x == blockDim.x - 1) { s_v[warp] = x.v; s_f[warp] = x.f; }
  __syncthreads();
  if (warp == 0) {
    Seg<T> y = lane < nw ? Seg<T>{s_v[lane], s_f[lane]} : Seg<T>{T(), 0};
    for (int d = 1; d < 32; d <<= 1) {
      const Seg<T> u = seg_shfl_up(y, d);
      if (lane >= d) y = seg_join(op, u, y);
    }
    if (lane < nw) { s_v[lane] = y.v; s_f[lane] = y.f; }
  }
  __syncthreads();
  if (warp > 0) ex = seg_join(op, Seg<T>{s_v[warp - 1], s_f[warp - 1]}, ex);
#pragma unroll
  for (int i = 0; i < IPT; ++i) it[i] = seg_join(op, ex, it[i]);
  const Seg<T> tot{s_v[nw - 1], s_f[nw - 1]};
  __syncthreads();
  return tot;
}

// The join of tiles [0, t)'s aggregates (get(u) -> Seg<T> of tile u), in
// tile order: lane i of warp 0 joins a run of consecutive tiles, then the
// lanes join in order. Every thread of the CTA calls it and gets the result.
template <typename T, class Op, class Get>
__device__ Seg<T> fold_tiles(Op op, int t, Get get, T* s_v, int* s_f) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, ws = blockDim.x < 32 ? (int)blockDim.x : 32;
    const int per = (t + ws - 1) / ws;
    Seg<T> x{T(), 0};
    for (int u = lane * per; u < t && u < (lane + 1) * per; ++u) x = seg_join(op, x, get(u));
    for (int d = 1; d < 32; d <<= 1) {
      const Seg<T> y = seg_shfl_up(x, d);
      if (lane >= d) x = seg_join(op, y, x);
    }
    if (lane == ws - 1) { s_v[0] = x.v; s_f[0] = x.f; }
  }
  __syncthreads();
  const Seg<T> r{s_v[0], s_f[0]};
  __syncthreads();
  return r;
}
