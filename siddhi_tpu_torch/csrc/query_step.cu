// Single-stream query step kernel for Hopper (sm_90a).
//
// Replaces, from the reference JAX package:
//   - tpu/query_compile.py::CompiledStreamQuery._make_step (B5a: filter,
//     stable compaction, the sliding windows length/time/externalTime/
//     timeLength, batch(), windowed and unwindowed group-by, having, and
//     the sum/count/avg/min/max/stdDev aggregates; helpers _range_reduce,
//     _range_sums, _keyed_range_sums, _window_svars, _time_window_bounds,
//     _slide_tails, _materialize)
// and evaluates filters, projections, aggregate arguments, group keys and
// having through B2's IR (expr_ir.cuh; OP_TS is linked as a read of the
// int64 timestamp column, having reads the row's outputs as bindings).
//
// What it computes, per step over a batch of B events: the filter mask and
// its stable compaction (accepted event i -> slot rank_i, fills past the
// accepted count k, as the reference writes them); for sliding windows the
// concat axis z = [tail (N) | batch (B)], M = N + B, and per output slot
// b the range [lo_b, N + b] (length: the live tail; time: a binary search
// over the clamped event times; timeLength: both), sums and counts as
// prefix differences, min/max as exact range reductions, stdDev from
// float64 shifted moments; for group-by the bucket ids, the ownership map
// and collision count, and per-key sums over the range (windowed) or per-
// key prefixes plus the carried [K] tables (unwindowed: Kahan f32 sums,
// int64 sums and counts, min/max, Welford-merged f32 stdDev); the running
// aggregates; the outputs, the having mask and the new state.
//
// Design: three launches per step (two when nothing aggregates).
//   1. q_prep, one CTA: filters and block_rank compaction; the output
//      timestamps and value projections go straight to the outputs, the
//      aggregate arguments to batch lanes; bucket ids; the time-window
//      clamp (a max-scan), regressions, drops and range bounds; ownership
//      and collisions; for group-by a stable counting sort of the scan
//      positions by bucket (histogram, exclusive scan, then one warp
//      places positions in order with __match_any_sync), which replaces
//      the reference's [M, K] one-hot grids.
//   2. q_scan, one CTA per aggregate lane: an inclusive scan over the scan
//      positions (segmented by bucket when grouped): float32 lanes in
//      float64 (each prefix rounds to float32 once, as the plain version
//      does), int64 lanes and counts exactly, stdDev lanes as float64
//      (windowed) or float32-rounded (carried) shifted moments, min/max
//      lanes as block-of-32 prefix/suffix reductions plus a sparse table
//      over the blocks (exact range min/max for any [lo, j]).
//   3. q_emit, a grid over max(B, N, K): each output slot reads its range
//      from the scans (binary searches inside its bucket's segment when
//      grouped), materialises every output, evaluates having; the new
//      tails and per-key tables are written to fresh buffers (the input
//      state is read-only, as in the reference).
//
// What bounds it on the H100: bytes, in principle. A main-path step moves
// the batch columns, the tails it reads and writes, the outputs and the
// [K] tables: about 0.4-1.5 MB, well under a microsecond at 3.35 TB/s.
// This first version is bound instead by its single-CTA phases (the
// compaction, the counting sort's one-warp placement loop, one CTA per
// scanned lane) and three dependent launches: multi-CTA scans and a
// decoupled look-back compaction are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXSTACK 32
#include "expr_ir.cuh"

#define QMAXCOL 32
#define QMAXSPEC 32
#define QMAXLANE 16
#define QMAXFILT 8
#define QMAXGK 8
#define NT 1024
#define NT_EMIT 256
#define FULL 0xffffffffu

enum { W_NONE = 0, W_LENGTH, W_TIME, W_TIMELENGTH, W_BATCH };
enum { S_VALUE = 0, S_COUNT, S_SUM, S_AVG, S_MIN, S_MAX, S_STD };
enum { KM_NARROW = 0, KM_WIDE1, KM_PAIR, KM_FNV };
enum { L_F = 0, L_I, L_S, L_M };

#define TS_NEG (-(1LL << 62))
#define TS_POS (1LL << 62)

struct QArgs {
  int B, N, M, K, LV, NB;          // M: scan length bound; LV/NB: sparse table
  int wkind, grouped, key_mode, has_agg;
  int nfilt, ncol, nspec, ngk;
  int AF, AI, AS, AM, ntask;
  int has_wprog, has_having;
  long long window_ms;
  int col_ty[QMAXCOL];
  int spec_kind[QMAXSPEC], spec_ty[QMAXSPEC], spec_lane[QMAXSPEC], spec_int[QMAXSPEC];
  int m_ty[QMAXLANE], m_min[QMAXLANE];
  long long m_ident[QMAXLANE];
  Prog filt[QMAXFILT];
  Prog proj[QMAXSPEC];
  Prog lane[4][QMAXLANE];
  Prog gk[QMAXGK];
  Prog wprog, having;
  const int4* code;
  const void* col[QMAXCOL];
  const long long* ts;
  const unsigned char* valid;
  // state in (meaning by mode: sliding tails | grouped [K] tables | running)
  const float* f_in; const float* fc_in; const long long* i_in;
  const float* s_in; const float* smean_in; const float* sm2_in; const float* scnt_in;
  const int* ones_in; const long long* cnt_in;
  const void* m_in[QMAXLANE];
  const long long* tts_in; const int* gkey_in;
  const long long* owner_in; const unsigned char* owned_in;
  const long long* last_ts_in; const long long* drops_in;
  const long long* regress_in; const long long* coll_in;
  // state out (fresh buffers)
  float* f_out; float* fc_out; long long* i_out;
  float* s_out; float* smean_out; float* sm2_out; float* scnt_out;
  int* ones_out; long long* cnt_out;
  void* m_out[QMAXLANE];
  long long* tts_out; int* gkey_out;
  long long* owner_out; unsigned char* owned_out;
  long long* last_ts_out; long long* drops_out;
  long long* regress_out; long long* coll_out;
  // outputs
  void* out[QMAXSPEC];
  unsigned char* ovalid; long long* ots; int* ocount;
  // scratch
  int* misc;                        // [0] k, [1] scan length P
  unsigned char* mask; int* rank;   // [B]
  float* bf; long long* bi; float* bs; long long* bm;   // batch lanes [A, B]
  int* bones; long long* bpacked; int* bkey; long long* bwts; int* lo;   // [B]
  int* firstidx; int* cnt; int* seg; int* run;   // [K]
  float* ckey;                      // [AS, K] (or [AS]) stdDev centres
  int* sorted; unsigned char* head; // [M]
  double* incf; long long* inci; long long* inco;   // [AF, M], [AI, M], [M]
  double* incs1; double* incs2;     // [AS, M]
  long long* mP; long long* mS;     // [AM, M]
  long long* mT;                    // [AM, LV, NB]
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

// Block-wide sum of one value per thread (every thread gets the total).
template <typename T>
__device__ T block_sum(T v, T* s_buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(FULL, v, d);
  __syncthreads();
  if (lane == 0) s_buf[warp] = v;
  __syncthreads();
  T tot = 0;
  for (int w = 0; w < nw; ++w) tot += s_buf[w];
  __syncthreads();
  return tot;
}

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
struct RedOp {
  int ty, is_min;
  __device__ long long operator()(long long x, long long y) const {
    return red_slot(ty, is_min, x, y);
  }
};

// z-axis readers: position p of the concat [tail (N) | batch (B)] (sliding)
// or of the batch alone
__device__ __forceinline__ bool sliding(const QArgs& a) {
  return a.wkind == W_LENGTH || a.wkind == W_TIME || a.wkind == W_TIMELENGTH;
}
__device__ __forceinline__ float zf(const QArgs& a, int l, int p) {
  if (sliding(a) && p < a.N) return a.f_in[(long long)l * a.N + p];
  return a.bf[(long long)l * a.B + p - (sliding(a) ? a.N : 0)];
}
__device__ __forceinline__ long long zi(const QArgs& a, int l, int p) {
  if (sliding(a) && p < a.N) return a.i_in[(long long)l * a.N + p];
  return a.bi[(long long)l * a.B + p - (sliding(a) ? a.N : 0)];
}
__device__ __forceinline__ float zs(const QArgs& a, int l, int p) {
  if (sliding(a) && p < a.N) return a.s_in[(long long)l * a.N + p];
  return a.bs[(long long)l * a.B + p - (sliding(a) ? a.N : 0)];
}
__device__ __forceinline__ long long zm(const QArgs& a, int l, int p) {
  if (sliding(a) && p < a.N) return load_typed(a.m_in[l], a.m_ty[l], p);
  return a.bm[(long long)l * a.B + p - (sliding(a) ? a.N : 0)];
}
__device__ __forceinline__ int zo(const QArgs& a, int p) {
  if (sliding(a) && p < a.N) return a.ones_in[p];
  return a.bones[p - (sliding(a) ? a.N : 0)];
}
__device__ __forceinline__ long long zts(const QArgs& a, int p) {
  return p < a.N ? a.tts_in[p] : a.bwts[p - a.N];
}
__device__ __forceinline__ int zk(const QArgs& a, int p) {
  if (sliding(a) && p < a.N) return a.gkey_in[p];
  return a.bkey[p - (sliding(a) ? a.N : 0)];
}
// scan position s -> z position
__device__ __forceinline__ int zpos(const QArgs& a, int s) {
  return a.grouped ? a.sorted[s] : s;
}

// ------------------------------------------------------------ 1. q_prep

__device__ __forceinline__ int upper_bound_zts(const QArgs& a, long long x) {
  int lo = 0, hi = a.N + a.B;              // first position with zts > x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (zts(a, mid) <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(NT) q_prep(QArgs a) {
  __shared__ int s_scan[NT / 32 + 1];
  __shared__ long long s_buf[33];
  __shared__ int s_flag[33];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int B = a.B, N = a.N, K = a.K;

  // filters -> mask, stable rank
  for (int b = tid; b < B; b += nt) {
    bool m = a.valid[b] != 0;
    for (int f = 0; f < a.nfilt; ++f)
      m = m && (eval_row(a, a.filt[f], b) != 0);
    a.mask[b] = m;
  }
  const int k = block_rank<0>(a.mask, a.rank, B, s_scan);

  // compaction: accepted rows to their rank, fills past k
  for (int b = tid; b < B; b += nt) {
    const int r = a.rank[b];
    if (r < 0) continue;
    a.ots[r] = a.ts[b];
    for (int i = 0; i < a.nspec; ++i)
      if (a.spec_kind[i] == S_VALUE)
        store_typed(a.out[i], a.spec_ty[i], r, eval_row(a, a.proj[i], b));
    for (int l = 0; l < a.AF; ++l)
      a.bf[(long long)l * B + r] = as_f(eval_row(a, a.lane[L_F][l], b));
    for (int l = 0; l < a.AI; ++l)
      a.bi[(long long)l * B + r] = eval_row(a, a.lane[L_I][l], b);
    for (int l = 0; l < a.AS; ++l)
      a.bs[(long long)l * B + r] = as_f(eval_row(a, a.lane[L_S][l], b));
    for (int l = 0; l < a.AM; ++l)
      a.bm[(long long)l * B + r] = eval_row(a, a.lane[L_M][l], b);
    a.bones[r] = 1;
    if (a.grouped) {
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
    if (a.wkind == W_TIME || a.wkind == W_TIMELENGTH)
      a.bwts[r] = a.has_wprog ? eval_row(a, a.wprog, b) : a.ts[b];
  }
  for (int s = k + tid; s < B; s += nt) {
    a.ots[s] = 0;
    for (int i = 0; i < a.nspec; ++i)
      if (a.spec_kind[i] == S_VALUE) store_typed(a.out[i], a.spec_ty[i], s, 0);
    for (int l = 0; l < a.AF; ++l) a.bf[(long long)l * B + s] = 0.0f;
    for (int l = 0; l < a.AI; ++l) a.bi[(long long)l * B + s] = 0;
    for (int l = 0; l < a.AS; ++l) a.bs[(long long)l * B + s] = 0.0f;
    for (int l = 0; l < a.AM; ++l) a.bm[(long long)l * B + s] = a.m_ident[l];
    a.bones[s] = 0;
    a.bpacked[s] = 0;
    a.bwts[s] = TS_POS;
  }
  __syncthreads();
  if (a.grouped)
    for (int s = tid; s < B; s += nt) a.bkey[s] = bucket_of(a, a.bpacked[s]);
  if (tid == 0) {
    a.misc[0] = k;
    *a.ocount = a.wkind == W_BATCH ? 0 : k;
  }

  // sliding windows: range lower bounds (and the time clamp)
  if (a.wkind == W_LENGTH) {
    int nt_part = 0;
    for (int p = tid; p < N; p += nt) nt_part += a.ones_in[p];
    const long long n_tail = block_sum<long long>(nt_part, s_buf);
    for (int b = tid; b < B; b += nt) {
      const long long j = (long long)N + b;
      const long long l1 = j - N + 1, l2 = (long long)N - n_tail;
      a.lo[b] = (int)(l1 > l2 ? l1 : l2);
    }
  } else if (a.wkind == W_TIME || a.wkind == W_TIMELENGTH) {
    const long long last = *a.last_ts_in;
    long long regressed = 0;
    // mono = max(cummax(raw), last_ts) over the valid prefix; wts_s in place
    block_seg_scan<long long>(
        B, MaxI64(), [&](int s) { return s < k ? a.bwts[s] : TS_POS; },
        [](int) { return false; },
        [&](int s, long long v) {
          const long long mono = v > last ? v : last;
          if (s < k) {
            regressed += a.bwts[s] < mono;
            a.bwts[s] = mono;
          } else {
            a.bwts[s] = TS_POS;
          }
        },
        s_buf, s_flag);
    regressed = block_sum<long long>(regressed, s_buf);
    __syncthreads();
    const long long D = a.window_ms;
    const long long newest = zts(a, N + k - 1 > 0 ? N + k - 1 : 0);
    long long drops = 0;
    for (int p = tid; p < k; p += nt)
      if (zts(a, p) > newest - D) drops += zo(a, p);
    drops = block_sum<long long>(drops, s_buf);
    for (int b = tid; b < B; b += nt) {
      long long l = upper_bound_zts(a, a.bwts[b] - D);
      if (a.wkind == W_TIMELENGTH) {
        const long long l2 = (long long)b + 1;        // j - N + 1
        if (l2 > l) l = l2;
      }
      a.lo[b] = (int)l;
    }
    if (tid == 0) {
      *a.regress_out = *a.regress_in + regressed;
      *a.drops_out = *a.drops_in + (a.wkind == W_TIME ? drops : 0);
      long long nl = last;
      if (k > 0 && a.bwts[k - 1] > nl) nl = a.bwts[k - 1];
      *a.last_ts_out = nl;
    }
  }

  if (!a.grouped) {
    if (a.wkind == W_NONE && tid < a.AS) {       // running stdDev centres
      const int si = tid;
      a.ckey[si] = a.scnt_in[si] > 0.0f ? a.smean_in[si] : a.bs[(long long)si * B];
    }
    if (tid == 0) a.misc[1] = sliding(a) ? N + B : B;
    return;
  }

  // group-by: first valid occurrence per bucket, ownership, collisions
  for (int q = tid; q < K; q += nt) { a.firstidx[q] = 0x7fffffff; a.cnt[q] = 0; a.run[q] = 0; }
  __syncthreads();
  for (int b = tid; b < k; b += nt) atomicMin(&a.firstidx[a.bkey[b]], b);
  __syncthreads();
  for (int q = tid; q < K; q += nt) {
    const int fi = a.firstidx[q];
    const bool has = fi != 0x7fffffff;
    const bool owned = a.owned_in[q] != 0;
    a.owner_out[q] = owned ? a.owner_in[q] : (has ? a.bpacked[fi] : 0);
    a.owned_out[q] = owned || has;
    if (!sliding(a))
      for (int si = 0; si < a.AS; ++si) {
        const long long o = (long long)si * K + q;
        a.ckey[o] = a.scnt_in[o] > 0.0f ? a.smean_in[o]
                                        : (has ? a.bs[(long long)si * B + fi] : 0.0f);
      }
  }
  __syncthreads();
  long long coll = 0;
  for (int b = tid; b < k; b += nt) coll += a.bpacked[b] != a.owner_out[a.bkey[b]];
  coll = block_sum<long long>(coll, s_buf);
  if (tid == 0) *a.coll_out = *a.coll_in + coll;

  // stable counting sort of the scan positions by bucket
  const int P = sliding(a) ? N + B : k;
  if (tid == 0) a.misc[1] = P;
  for (int p = tid; p < P; p += nt) { atomicAdd(&a.cnt[zk(a, p)], 1); a.head[p] = 0; }
  __syncthreads();
  block_seg_scan<long long>(
      K, AddOp(), [&](int q) { return (long long)a.cnt[q]; },
      [](int) { return false; },
      [&](int q, long long v) { a.seg[q] = (int)(v - a.cnt[q]); }, s_buf, s_flag);
  __syncthreads();
  for (int q = tid; q < K; q += nt)
    if (a.cnt[q] > 0) a.head[a.seg[q]] = 1;
  if ((tid >> 5) == 0) {
    const int lane = tid & 31, ws = nt < 32 ? nt : 32;
    for (int base = 0; base < P; base += ws) {
      const int p = base + lane;
      const bool in = p < P;
      const int key = in ? zk(a, p) : -1;
      const unsigned peers = __match_any_sync(FULL, key);
      const int r = in ? a.run[key] + __popc(peers & ((1u << lane) - 1u)) : 0;
      __syncwarp();
      if (in) {
        a.sorted[a.seg[key] + r] = p;
        if (lane == __ffs(peers) - 1) a.run[key] += __popc(peers);
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------ 2. q_scan
// Tasks, by blockIdx.x: AF float lanes, AI int lanes, the ones lane, AS
// stdDev lanes, AM min/max lanes.

__global__ void __launch_bounds__(NT) q_scan(QArgs a) {
  __shared__ long long s_buf[33];
  __shared__ int s_flag[33];
  const int P = a.misc[1];
  const int M = a.M;
  const bool grp = a.grouped != 0;
  auto head = [&](int s) { return grp && a.head[s] != 0; };
  int t = blockIdx.x;
  if (t < a.AF) {
    const int l = t;
    block_seg_scan<double>(
        P, AddOp(), [&](int s) { return (double)zf(a, l, zpos(a, s)); }, head,
        [&](int s, double v) { a.incf[(long long)l * M + s] = v; },
        (double*)s_buf, s_flag);
    return;
  }
  t -= a.AF;
  if (t < a.AI) {
    const int l = t;
    block_seg_scan<long long>(
        P, AddOp(), [&](int s) { return zi(a, l, zpos(a, s)); }, head,
        [&](int s, long long v) { a.inci[(long long)l * M + s] = v; },
        s_buf, s_flag);
    return;
  }
  t -= a.AI;
  if (t == 0) {
    block_seg_scan<long long>(
        P, AddOp(), [&](int s) { return (long long)zo(a, zpos(a, s)); }, head,
        [&](int s, long long v) { a.inco[s] = v; }, s_buf, s_flag);
    return;
  }
  t -= 1;
  if (t < a.AS) {
    const int l = t;
    double* o1 = a.incs1 + (long long)l * M;
    double* o2 = a.incs2 + (long long)l * M;
    if (sliding(a) || a.wkind == W_BATCH) {
      // float64 shifted moments centred at the mean of the whole axis
      double sx = 0.0, so = 0.0;
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        const double occ = zo(a, p) > 0 ? 1.0 : 0.0;
        sx += (double)zs(a, l, p) * occ;
        so += occ;
      }
      sx = block_sum<double>(sx, (double*)s_buf);
      so = block_sum<double>(so, (double*)s_buf);
      const double c = sx / (so > 1.0 ? so : 1.0);
      block_seg_scan<double>(
          P, AddOp(),
          [&](int s) { return ((double)zs(a, l, s) - c) * (zo(a, s) > 0 ? 1.0 : 0.0); },
          head, [&](int s, double v) { o1[s] = v; }, (double*)s_buf, s_flag);
      block_seg_scan<double>(
          P, AddOp(),
          [&](int s) {
            const double d = ((double)zs(a, l, s) - c) * (zo(a, s) > 0 ? 1.0 : 0.0);
            return d * d;
          },
          head, [&](int s, double v) { o2[s] = v; }, (double*)s_buf, s_flag);
    } else {
      // float32 deviations from the carried centre (per key when grouped)
      auto dev = [&](int s) {
        const int p = zpos(a, s);
        const float c = grp ? a.ckey[(long long)l * a.K + a.bkey[p]] : a.ckey[l];
        const float occ = (float)a.bones[p];
        return __fmul_rn(__fsub_rn(a.bs[(long long)l * a.B + p], c), occ);
      };
      block_seg_scan<double>(
          P, AddOp(), [&](int s) { return (double)dev(s); }, head,
          [&](int s, double v) { o1[s] = v; }, (double*)s_buf, s_flag);
      block_seg_scan<double>(
          P, AddOp(),
          [&](int s) { const float d = dev(s); return (double)__fmul_rn(d, d); },
          head, [&](int s, double v) { o2[s] = v; }, (double*)s_buf, s_flag);
    }
    return;
  }
  t -= a.AS;
  if (t < a.AM) {
    const int l = t;
    const RedOp op{a.m_ty[l], a.m_min[l]};
    long long* Pm = a.mP + (long long)l * M;
    if (!(sliding(a) || a.wkind == W_BATCH)) {
      // prefix (per key when grouped) reductions
      block_seg_scan<long long>(
          P, op, [&](int s) { return zm(a, l, zpos(a, s)); }, head,
          [&](int s, long long v) { Pm[s] = v; }, s_buf, s_flag);
      return;
    }
    // exact range reductions: prefix and suffix within blocks of 32, and a
    // sparse table over the blocks' reductions
    long long* Sm = a.mS + (long long)l * M;
    long long* T = a.mT + (long long)l * a.LV * a.NB;
    block_seg_scan<long long>(
        P, op, [&](int s) { return zm(a, l, s); },
        [](int s) { return (s & 31) == 0; },
        [&](int s, long long v) { Pm[s] = v; }, s_buf, s_flag);
    block_seg_scan<long long>(
        P, op, [&](int r) { return zm(a, l, P - 1 - r); },
        [&](int r) { return ((P - 1 - r) & 31) == 31; },
        [&](int r, long long v) { Sm[P - 1 - r] = v; }, s_buf, s_flag);
    const int nb = (P + 31) >> 5;
    for (int q = threadIdx.x; q < nb; q += blockDim.x) {
      const int last = (q << 5) + 31 < P ? (q << 5) + 31 : P - 1;
      T[q] = Pm[last];
    }
    __syncthreads();
    for (int lv = 1, span = 1; lv < a.LV; ++lv, span <<= 1) {
      const long long* prev = T + (long long)(lv - 1) * a.NB;
      long long* cur = T + (long long)lv * a.NB;
      for (int q = threadIdx.x; q < nb; q += blockDim.x)
        cur[q] = q + span < nb ? op(prev[q], prev[q + span]) : prev[q];
      __syncthreads();
    }
  }
}

// ------------------------------------------------------------ 3. q_emit

// exact reduction of min/max lane l over z positions [lo, j] (the
// reference's sparse table, including its value for lo > j)
__device__ long long range_red(const QArgs& a, int l, int P, int lo, int j) {
  const RedOp op{a.m_ty[l], a.m_min[l]};
  if (lo > j) return op(zm(a, l, j), zm(a, l, lo < P - 1 ? lo : P - 1));
  const int qa = lo >> 5, qb = j >> 5;
  if (qa == qb) {
    long long r = zm(a, l, lo);
    for (int p = lo + 1; p <= j; ++p) r = op(r, zm(a, l, p));
    return r;
  }
  const long long M = a.M;
  long long r = op(a.mS[l * M + lo], a.mP[l * M + j]);
  if (qa + 1 <= qb - 1) {
    const int x = qa + 1, y = qb - 1;
    const int lv = 31 - __clz(y - x + 1);
    const long long* T = a.mT + ((long long)l * a.LV + lv) * a.NB;
    r = op(r, op(T[x], T[y - (1 << lv) + 1]));
  }
  return r;
}

// number of entries of sorted[s0, s0 + c) below x (strict) or at most x
__device__ __forceinline__ int count_below(const int* v, int c, int x, bool incl) {
  int lo = 0, hi = c;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (incl ? v[mid] <= x : v[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float f32_of(double v) { return __double2float_rn(v); }

__device__ void emit_row(const QArgs& a, int b, int k, int P) {
  const long long M = a.M;
  const bool sl = sliding(a);
  const int j = sl ? a.N + b : b;
  const int lo = sl ? a.lo[b] : 0;
  // scan index range [s0 + r_lo, s0 + r_hi) of this output
  int s0 = 0, r_hi = j + 1, r_lo = lo, key = 0;
  if (a.grouped) {
    key = a.bkey[b];
    s0 = a.seg[key];
    const int c = a.cnt[key];
    const int* v = a.sorted + s0;
    r_hi = count_below(v, c, j, true);
    r_lo = sl ? count_below(v, c, lo, false) : 0;
  }
  auto EXd = [&](const double* arr, int r) { return r == 0 ? 0.0 : arr[s0 + r - 1]; };
  auto EXi = [&](const long long* arr, int r) { return r == 0 ? 0LL : arr[s0 + r - 1]; };
  const bool carried = !sl && a.wkind != W_BATCH;    // running or grouped
  long long cnt = 0;
  if (a.has_agg) {
    if (a.grouped && !sl) cnt = r_hi + a.cnt_in[key];
    else cnt = EXi(a.inco, r_hi) - EXi(a.inco, r_lo) + (carried ? *a.cnt_in : 0);
  }
  long long ov[QMAXSPEC];
  for (int i = 0; i < a.nspec; ++i) {
    const int kind = a.spec_kind[i], l = a.spec_lane[i];
    long long v = 0;
    if (kind == S_VALUE) {
      v = load_typed(a.out[i], a.spec_ty[i], b);
      ov[i] = v;
      continue;
    }
    if (kind == S_COUNT) {
      v = cnt;
    } else if (kind == S_SUM || kind == S_AVG) {
      float fnum;
      long long inum = 0;
      if (a.spec_int[i]) {
        const long long* arr = a.inci + (long long)l * M;
        inum = EXi(arr, r_hi) - EXi(arr, r_lo);
        if (carried) inum += a.grouped ? a.i_in[(long long)l * a.K + key] : a.i_in[l];
        fnum = __ll2float_rn(inum);
      } else {
        const double* arr = a.incf + (long long)l * M;
        fnum = __fsub_rn(f32_of(EXd(arr, r_hi)), f32_of(EXd(arr, r_lo)));
        if (carried)
          fnum = __fadd_rn(fnum, a.grouped ? a.f_in[(long long)l * a.K + key] : a.f_in[l]);
      }
      if (kind == S_SUM) {
        v = a.spec_int[i] ? inum : from_f(fnum);
      } else {
        const float den = __ll2float_rn(cnt > 1 ? cnt : 1);
        v = from_f(__fdiv_rn(fnum, den));
      }
    } else if (kind == S_MIN || kind == S_MAX) {
      if (!carried) {
        v = range_red(a, l, P, lo, j);
      } else {
        const RedOp op{a.m_ty[l], a.m_min[l]};
        const long long* Pm = a.mP + (long long)l * M;
        const long long pre = a.grouped ? (r_hi > 0 ? Pm[s0 + r_hi - 1] : a.m_ident[l])
                                        : Pm[b];
        const long long car = load_typed(a.m_in[l], a.m_ty[l], a.grouped ? key : 0);
        v = op(pre, car);
      }
    } else {   // stdDev
      const double* c1 = a.incs1 + (long long)l * M;
      const double* c2 = a.incs2 + (long long)l * M;
      if (!carried) {
        const double n = (double)(cnt > 1 ? cnt : 1);
        const double s1 = EXd(c1, r_hi) - EXd(c1, r_lo);
        const double s2 = EXd(c2, r_hi) - EXd(c2, r_lo);
        const double m = s1 / n;
        double var = s2 / n - m * m;
        if (var < 0.0) var = 0.0;
        v = from_f(f32_of(sqrt(var)));
      } else {
        const long long o = a.grouped ? (long long)l * a.K + key : l;
        const float s1 = f32_of(EXd(c1, r_hi)), s2 = f32_of(EXd(c2, r_hi));
        const long long seen = a.grouped ? r_hi : EXi(a.inco, r_hi);
        const float nsc0 = __fadd_rn(a.scnt_in[o], __ll2float_rn(seen));
        const float nsc = nsc0 > 1.0f ? nsc0 : (nsc0 != nsc0 ? nsc0 : 1.0f);
        const float m = __fdiv_rn(s1, nsc);
        float var = __fsub_rn(__fdiv_rn(__fadd_rn(a.sm2_in[o], s2), nsc), __fmul_rn(m, m));
        if (var < 0.0f) var = 0.0f;
        v = from_f(__fsqrt_rn(var));
      }
    }
    store_typed(a.out[i], a.spec_ty[i], b, v);
    ov[i] = v;
  }
  bool ok = b < k;
  if (a.wkind == W_BATCH && a.has_agg) ok = ok && b == k - 1;
  if (a.has_having) ok = ok && eval_prog(a.code, a.having, NoBindQ{}, OutAt{ov}) != 0;
  a.ovalid[b] = ok;
  if (a.wkind == W_BATCH && ok) atomicAdd(a.ocount, 1);
}

__device__ __forceinline__ void kahan(float base, float comp, float add,
                                      float* nb, float* nc) {
  const float y = __fsub_rn(add, comp);
  const float t = __fadd_rn(base, y);
  *nb = t;
  *nc = __fsub_rn(__fsub_rn(t, base), y);
}

// new per-key tables (grouped; q < K) or running aggregates (q == 0)
__device__ void update_carried(const QArgs& a, int q, int k, int P) {
  const long long M = a.M;
  int s0 = 0, c = P;
  long long rows = k;
  if (a.grouped) { s0 = a.seg[q]; c = a.cnt[q]; rows = c; }
  const int X = a.grouped ? a.K : 1;
  const int qq = a.grouped ? q : 0;
  for (int l = 0; l < a.AF; ++l) {
    const long long o = (long long)l * X + qq;
    const float add = c > 0 ? f32_of(a.incf[l * M + s0 + c - 1]) : 0.0f;
    kahan(a.f_in[o], a.fc_in[o], add, &a.f_out[o], &a.fc_out[o]);
  }
  for (int l = 0; l < a.AI; ++l) {
    const long long o = (long long)l * X + qq;
    a.i_out[o] = a.i_in[o] + (c > 0 ? a.inci[l * M + s0 + c - 1] : 0);
  }
  a.cnt_out[qq] = a.cnt_in[qq] + rows;
  for (int l = 0; l < a.AM; ++l) {
    const RedOp op{a.m_ty[l], a.m_min[l]};
    const long long seg = c > 0 ? a.mP[l * M + s0 + c - 1] : a.m_ident[l];
    store_typed(a.m_out[l], a.m_ty[l], qq,
                op(load_typed(a.m_in[l], a.m_ty[l], qq), seg));
  }
  for (int l = 0; l < a.AS; ++l) {
    const long long o = (long long)l * X + qq;
    const float ck = a.ckey[o];
    const float add1 = c > 0 ? f32_of(a.incs1[l * M + s0 + c - 1]) : 0.0f;
    const float add2 = c > 0 ? f32_of(a.incs2[l * M + s0 + c - 1]) : 0.0f;
    const float n_new = __fadd_rn(a.scnt_in[o], __ll2float_rn(rows));
    const float n1 = n_new > 1.0f ? n_new : 1.0f;
    const float mean_new = __fadd_rn(ck, __fdiv_rn(add1, n1));
    const float dm = __fsub_rn(mean_new, ck);
    float m2 = __fsub_rn(__fadd_rn(a.sm2_in[o], add2), __fmul_rn(n1, __fmul_rn(dm, dm)));
    if (m2 < 0.0f) m2 = 0.0f;
    a.smean_out[o] = mean_new;
    a.sm2_out[o] = m2;
    a.scnt_out[o] = n_new;
  }
}

__global__ void __launch_bounds__(NT_EMIT) q_emit(QArgs a) {
  const int k = a.misc[0], P = a.misc[1];
  const int stride = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  for (int b = g; b < a.B; b += stride) emit_row(a, b, k, P);
  if (sliding(a)) {
    const int N = a.N;
    for (int t = g; t < N; t += stride) {
      const int p = k + t;
      for (int l = 0; l < a.AF; ++l) a.f_out[(long long)l * N + t] = zf(a, l, p);
      for (int l = 0; l < a.AI; ++l) a.i_out[(long long)l * N + t] = zi(a, l, p);
      for (int l = 0; l < a.AS; ++l) a.s_out[(long long)l * N + t] = zs(a, l, p);
      a.ones_out[t] = zo(a, p);
      for (int l = 0; l < a.AM; ++l) store_typed(a.m_out[l], a.m_ty[l], t, zm(a, l, p));
      if (a.wkind != W_LENGTH) a.tts_out[t] = zts(a, p);
      if (a.grouped) a.gkey_out[t] = zk(a, p);
    }
  } else if (a.grouped) {
    for (int q = g; q < a.K; q += stride) update_carried(a, q, k, P);
  } else if (a.wkind == W_NONE && g == 0) {
    update_carried(a, 0, k, P);
  }
}

// ------------------------------------------------------------ host entry

extern "C" int query_step_args_size(void) { return (int)sizeof(QArgs); }

// Launches one step on `stream`; *nlaunch receives the number of kernel
// launches made. Returns cudaGetLastError() after each launch (0 on
// success).
extern "C" int query_step(const QArgs* args, void* stream, int* nlaunch) {
  const QArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  *nlaunch = 0;
  q_prep<<<1, NT, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  if (a.ntask > 0) {
    q_scan<<<a.ntask, NT, 0, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    *nlaunch += 1;
  }
  int n = a.B > a.N ? a.B : a.N;
  if (a.K > n) n = a.K;
  int grid = (n + NT_EMIT - 1) / NT_EMIT;
  if (grid > 1024) grid = 1024;
  q_emit<<<grid, NT_EMIT, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  return 0;
}
