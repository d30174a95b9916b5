// Incremental-aggregation step kernel for Hopper (sm_90a).
//
// Replaces, from the reference JAX package, tpu/aggregation_compile.py::
// CompiledAggregation._make_step -> reduce_batch (B7): one staged micro-
// batch (valid = the prefix the runtime filled; stale values past it) and a
// host-computed [D, B] slab of bucket starts, one row per duration. For
// every duration d the reference masks the events by the filters (a
// rejected event's bucket becomes 2**62), lexsorts them by (bucket, last
// group column, ..., first group column) with ties in arrival order, splits
// runs where the bucket or any raw group column changes, and reduces each
// run with segment_sum / segment_min / segment_max over num_segments = B:
// count (int64), sum_ (int64 for INT/LONG sum/avg, f64 otherwise, count()
// sums f64 ones), sq_ (f64 squares), m_ (min/max in the argument's dtype,
// NaN-propagating, the identity for no events), last_ (a value projection
// at the run's last accepted position), g_ (the group columns at the run's
// leader), bucket and n_runs (accepted runs). Positions past the runs hold
// the reference's values for empty segments: leader = int64 max clipped to
// B - 1, last = int64 min clipped to 0, zero sums, the identity.
// Filters, arguments and projections run through B2's IR (expr_ir.cuh)
// over the event's columns; OP_TS (eventTimestamp()) is linked as the
// column slot of the bucketing clock.
//
// What bounds it on the H100: bytes. A step reads the referenced columns,
// the valid mask and the [D, B] slab once and writes the [D, B] lanes once
// (~1.2 MB for D = 6, B = 4096: ~0.4 us at 3.35 TB/s); its essential
// operations (a sort, ~B log2 B compares per duration, and one add per
// event, lane and duration) are ~0.4 M, nanoseconds at the card's rate.
// What the design spends instead is latency: the sorts' passes are a
// handful of block barriers each, and the f64 sums must add in sorted order
// one after the other (the reference's segment_sum order, for the same
// bits), so the longest run is a serial chain of dependent adds.
//
// Design: four launches on the caller's stream, nothing allocated.
//   1. a_eval, one thread per event: the mask (valid and every filter), each
//      select attribute's value (int64, f64 bits or the typed slot) and the
//      group keys as int64, into scratch; each runs once, not once per
//      duration.
//   2. a_gsort, one CTA: the lexsort's group-key part, once for every
//      duration. A stable LSD radix sort of the B event indices by the group
//      keys (sign bit flipped: signed order), the first column first, so the
//      last column is the most significant and arrival order breaks ties.
//      4-bit digits; a digit in which every key of the batch agrees (the
//      batch-wide AND and OR of the keys show it) is skipped, so small
//      dictionary codes cost two or three passes. A pass counts each
//      thread's contiguous chunk per digit, scans the counts (digit-major,
//      then thread) and scatters each event to its rank: stable.
//   3. a_bsort, one CTA per duration: the same sort, over the group order,
//      by the bucket (rejected events last, as 2**62 sorts): a stable sort
//      by the bucket of a sequence already stably sorted by the group keys
//      is the lexsort's order. It sorts the offset from the batch's
//      smallest bucket, so a few digits cover it; late events put buckets
//      out of arrival order and this sort is what orders them. Then, over
//      the sorted order: every accumulated lane written in sorted order
//      with the mask folded in (0 or the identity where rejected), the run
//      boundaries, each run's first position and the number of runs and of
//      accepted runs (n_runs), from one block scan over per-thread chunks.
//      Both sorts keep the sequence, its copy and the keys in shared memory
//      where B <= TILE; a larger B (to 16 tiles) runs the same passes over
//      device-memory scratch, with per-tile digit counts scanned into tile
//      offsets.
//   4. a_reduce, one thread per (d, run slot s < B, lane): walks run s over
//      its sorted lane, consecutive addresses, and accumulates the int64 and
//      f64 sums left to right from 0 (the reference's segment_sum order: the
//      same bits), the squares or min/max, or gathers last_ at the run's
//      last accepted position; one more thread per run slot writes count,
//      g_ and bucket at its leader. Slots past the runs write the empty-
//      segment values. The lanes of the longest run walk side by side.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXSTACK 32
#include "expr_ir.cuh"

#define AMAXCOL 32
#define AMAXG 8
#define AMAXSPEC 32
#define NT 256
#define NTS 512                   // threads of a sorting CTA
#define TILE 4096                 // positions one sorting pass counts at once
#define MAXTILE 16                // tiles of a sort: B <= 65,536
#define RB 16                     // bins of a 4-bit digit
#define TS_POS (1LL << 62)

enum { L_VALUE = 0, L_INT = 1, L_F64 = 2, L_F64SQ = 3, L_MIN = 4, L_MAX = 5 };

// Mirrored by gpu/aggregation_step.py (AArgs, ctypes);
// aggregation_step_args_size checks it.
struct AArgs {
  int B, D, ncol, G, S, has_filter;
  int col_ty[AMAXCOL];
  int g_col[AMAXG];                 // column slot of each group key
  int g_ty[AMAXG];                  // its type (the g_ output's)
  int lane[AMAXSPEC];               // L_*
  int vty[AMAXSPEC];                // the program's result type
  int ones[AMAXSPEC];               // count(): the lane sums 1.0
  Prog filt;                        // every filter, ANDed (has_filter)
  Prog prog[AMAXSPEC];
  const int4* code;
  const void* col[AMAXCOL];
  const long long* buckets;         // [D, B]
  const unsigned char* valid;       // [B]
  // scratch
  unsigned char* mask;              // [B]
  long long* sval;                  // [S, B]
  long long* gkey;                  // [G, B]
  int* gorder;                      // [B] events in group-key order
  int* order;                       // [D, B] sorted position -> event
  int* start;                       // [D, B] run -> first sorted position
  int* nseg;                        // [D] runs, accepted or not
  long long* ssv;                   // [S, D, B] lanes in sorted order
  unsigned long long* skey;         // [1 + D, B] sort keys (B > TILE)
  int* sbuf;                        // [1 + D, 2, B] sort sequences (B > TILE)
  // outputs
  long long* bucket;                // [D, B]
  long long* n_runs;                // [D]
  long long* count;                 // [D, B]
  void* o_main[AMAXSPEC];           // sum_ / m_ / last_, [D, B]
  void* o_sq[AMAXSPEC];             // sq_ (L_F64SQ), [D, B]
  void* o_g[AMAXG];                 // g_, [D, B]
};

__device__ __forceinline__ double as_d(long long v) { return __longlong_as_double(v); }
__device__ __forceinline__ long long from_d(double d) { return __double_as_longlong(d); }

__device__ __forceinline__ double to_double(long long v, int ty) {
  if (ty == T_F32) return (double)as_f(v);
  return __ll2double_rn(v);              // i32 slots are sign-extended
}

// The min/max identity of a typed slot: +inf / -inf, the integer range.
__device__ __forceinline__ long long mm_ident(int ty, bool is_min) {
  switch (ty) {
    case T_F32: return from_f(is_min ? __int_as_float(0x7f800000) : __int_as_float(0xff800000));
    case T_I32: return is_min ? 2147483647LL : -2147483648LL;
    case T_BOOL: return is_min ? 1 : 0;
    default: return is_min ? 9223372036854775807LL : -9223372036854775807LL - 1;
  }
}

// NaN-propagating min/max of two typed slots (segment_min / segment_max).
__device__ __forceinline__ long long mm_combine(long long acc, long long x, int ty, bool is_min) {
  if (ty == T_F32) {
    const float fa = as_f(acc), fx = as_f(x);
    if (fa != fa) return acc;
    if (fx != fx) return x;
    return (is_min ? fx < fa : fx > fa) ? x : acc;
  }
  return (is_min ? x < acc : x > acc) ? x : acc;
}

__device__ __forceinline__ long long segm_of(const AArgs& a, const long long* bk, int i) {
  return a.mask[i] ? bk[i] : TS_POS;
}

// int64 -> uint64 in the same order
__device__ __forceinline__ unsigned long long flip(long long v) {
  return (unsigned long long)v ^ (1ull << 63);
}

// ------------------------------------------------------------- 1. a_eval
__global__ void a_eval(const AArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  auto ev = [&](int c) { return load_typed(a.col[c], a.col_ty[c], i); };
  bool m = a.valid[i] != 0;
  if (a.has_filter && eval_prog(a.code, a.filt, ev, ev) == 0) m = false;
  a.mask[i] = m;
  for (int s = 0; s < a.S; ++s) {
    const int ln = a.lane[s];
    long long v;
    if (a.ones[s]) {
      v = from_d(1.0);
    } else {
      v = eval_prog(a.code, a.prog[s], ev, ev);
      if (ln == L_INT) v = cast_val(v, a.vty[s], T_I64);
      else if (ln == L_F64 || ln == L_F64SQ) v = from_d(to_double(v, a.vty[s]));
    }
    a.sval[(long long)s * a.B + i] = v;
  }
  for (int g = 0; g < a.G; ++g)
    a.gkey[(long long)g * a.B + i] = ev(a.g_col[g]);
}

// ------------------------------------------------------ the radix sort

// Shared memory of a sorting CTA besides the sequences and keys.
struct SortSmem {
  int cnt[RB * NTS];                // per (digit, thread) counts, then ranks
  int hist[MAXTILE * RB];           // per (tile, digit) counts, then offsets
  int lb[RB];                       // one tile's digit counts
  int wt[NTS / 32][RB / 2];         // per warp: digit-pair totals, then prefixes
  int tot[RB / 2];                  // the tile's digit-pair totals
  long long w[33];
  unsigned long long red[32];
};

// Exclusive prefix of one value per thread, in thread order; *total gets
// the block's sum. Every thread of the block calls it.
template <typename T>
__device__ T block_excl_scan(T v, T* s_w, T* total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = (nt + 31) >> 5;
  T x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();
  if (lane == 31 || tid == nt - 1) s_w[warp] = x;
  __syncthreads();
  T off = 0, tot = 0;
  for (int w = 0; w < nw; ++w) {
    if (w < warp) off += s_w[w];
    tot += s_w[w];
  }
  *total = tot;
  return off + x - v;
}

// Ranks one tile's digit counts: on entry cnt[r * nt + t] holds how many of
// thread t's events have digit r; on exit the rank of the first of them,
// base[r] plus the events of digit r in the threads before t, where base[r]
// is off[r] (the tile's offset of digit r) or, for off null, the tile's
// events of the digits before r. Each thread reads and writes its own
// column (no bank conflicts); the digits go through the block scan two to
// an int (16-bit halves: a tile holds at most TILE events). Every thread of
// the block calls it.
__device__ void rank_tile(SortSmem& sm, const int* off) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nw = (nt + 31) >> 5, NL = nt < 32 ? nt : 32;
  int v[RB / 2], x[RB / 2];
#pragma unroll
  for (int i = 0; i < RB / 2; ++i) {
    v[i] = sm.cnt[2 * i * nt + tid] | (sm.cnt[(2 * i + 1) * nt + tid] << 16);
    x[i] = v[i];
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int i = 0; i < RB / 2; ++i) {
      const int y = __shfl_up_sync(0xffffffffu, x[i], d);
      if (lane >= d) x[i] += y;
    }
  }
  __syncthreads();
  if (lane == NL - 1 || tid == nt - 1) {
#pragma unroll
    for (int i = 0; i < RB / 2; ++i) sm.wt[warp][i] = x[i];
  }
  __syncthreads();
  if (warp == 0) {
    for (int i = lane; i < RB / 2; i += NL) {
      int run = 0;
      for (int w = 0; w < nw; ++w) {
        const int c = sm.wt[w][i];
        sm.wt[w][i] = run;
        run += c;
      }
      sm.tot[i] = run;
    }
  }
  __syncthreads();
  int start = 0;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int i = r >> 1, sh = 16 * (r & 1);
    const int ex = ((sm.wt[warp][i] + x[i] - v[i]) >> sh) & 0xFFFF;
    sm.cnt[r * nt + tid] = (off ? off[r] : start) + ex;
    start += (sm.tot[i] >> sh) & 0xFFFF;
  }
}

// One stable counting pass: dst = src ordered by the 4-bit digit at `sh` of
// each event's key kv[src[p]], ties in src order. Thread t owns positions
// [t * E, t * E + E) of each tile; its counts per digit are ranked digit-
// major, then by thread (rank_tile). With several tiles each tile's counts
// are taken first and scanned (digit-major, then tile) into tile offsets.
// Every thread of the block calls it.
__device__ void radix_pass(const int* src, int* dst, int n, const unsigned long long* kv,
                           int sh, SortSmem& sm) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int E = (TILE + nt - 1) / nt;
  const int ntile = (n + TILE - 1) / TILE;
  auto digit = [&](int p) { return (int)((kv[src[p]] >> sh) & (RB - 1)); };
  if (ntile > 1) {
    for (int tl = 0; tl < ntile; ++tl) {
      for (int r = tid; r < RB; r += nt) sm.lb[r] = 0;
      __syncthreads();
      const int t1 = min(n, (tl + 1) * TILE);
      for (int p = tl * TILE + tid; p < t1; p += nt) atomicAdd(&sm.lb[digit(p)], 1);
      __syncthreads();
      for (int r = tid; r < RB; r += nt) sm.hist[tl * RB + r] = sm.lb[r];
      __syncthreads();
    }
    if (tid == 0) {
      int run = 0;
      for (int r = 0; r < RB; ++r)
        for (int tl = 0; tl < ntile; ++tl) {
          const int c = sm.hist[tl * RB + r];
          sm.hist[tl * RB + r] = run;
          run += c;
        }
    }
    __syncthreads();
  }
  for (int tl = 0; tl < ntile; ++tl) {
    const int t1 = min(n, (tl + 1) * TILE);
    const int p0 = min(t1, tl * TILE + tid * E), p1 = min(t1, p0 + E);
    for (int r = 0; r < RB; ++r) sm.cnt[r * nt + tid] = 0;
    for (int p = p0; p < p1; ++p) sm.cnt[digit(p) * nt + tid] += 1;
    rank_tile(sm, ntile > 1 ? sm.hist + tl * RB : nullptr);
    for (int p = p0; p < p1; ++p) dst[sm.cnt[digit(p) * nt + tid]++] = src[p];
    __syncthreads();
  }
}

struct OrU64 {
  __device__ unsigned long long operator()(unsigned long long x, unsigned long long y) const { return x | y; }
};
struct AndU64 {
  __device__ unsigned long long operator()(unsigned long long x, unsigned long long y) const { return x & y; }
};

// Sorts the sequence *x (n events) stably by kv[event], least significant
// digit first, skipping the digits in which every key agrees (or_ ^ and_
// has no bit there); *x ends up holding the result, *y the other buffer.
__device__ void radix_sort(int*& x, int*& y, int n, const unsigned long long* kv,
                           unsigned long long or_, unsigned long long and_, SortSmem& sm) {
  const unsigned long long diff = or_ ^ and_;
  for (int sh = 0; sh < 64; sh += 4) {
    if (((diff >> sh) & (RB - 1)) == 0) continue;
    radix_pass(x, y, n, kv, sh, sm);
    int* t = x;
    x = y;
    y = t;
  }
}

// The sequences and keys of sort `row` (0: the group keys, 1 + d: duration
// d): in dynamic shared memory where B <= TILE, else in device memory.
__device__ void sort_buffers(const AArgs& a, int row, unsigned long long*& kv, int*& x, int*& y) {
  const int B = a.B;
  if (B <= TILE) {
    extern __shared__ __align__(16) unsigned char s_dyn[];
    kv = (unsigned long long*)s_dyn;
    x = (int*)(kv + B);
    y = x + B;
  } else {
    kv = a.skey + (long long)row * B;
    x = a.sbuf + (long long)row * 2 * B;
    y = x + B;
  }
}

// ------------------------------------------------------------ 2. a_gsort
__global__ void __launch_bounds__(NTS) a_gsort(const AArgs a) {
  __shared__ SortSmem sm;
  const int B = a.B, tid = threadIdx.x, nt = blockDim.x;
  unsigned long long* kv;
  int *x, *y;
  sort_buffers(a, 0, kv, x, y);
  for (int p = tid; p < B; p += nt) x[p] = p;
  for (int g = 0; g < a.G; ++g) {
    unsigned long long o = 0, n = ~0ull;
    for (int i = tid; i < B; i += nt) {
      const unsigned long long u = flip(a.gkey[(long long)g * B + i]);
      kv[i] = u;
      o |= u;
      n &= u;
    }
    o = block_reduce(o, OrU64(), sm.red);
    n = block_reduce(n, AndU64(), sm.red);
    radix_sort(x, y, B, kv, o, n, sm);
  }
  for (int p = tid; p < B; p += nt) a.gorder[p] = x[p];
}

// ------------------------------------------------------------ 3. a_bsort
__global__ void __launch_bounds__(NTS) a_bsort(const AArgs a) {
  __shared__ SortSmem sm;
  __shared__ long long s_red[32];
  const int d = blockIdx.x, B = a.B, D = a.D, G = a.G, tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long row = (long long)d * B;
  const long long* bk = a.buckets + row;
  unsigned long long* kv;
  int *x, *y;
  sort_buffers(a, 1 + d, kv, x, y);
  // the key: the offset from the smallest bucket (2**62 for a rejected
  // event); rejected events take the smaller of their own offset and one
  // past the largest accepted one, which keeps the order and the digits few
  long long lo = TS_POS, hi = -9223372036854775807LL - 1;
  for (int i = tid; i < B; i += nt) {
    const long long s = segm_of(a, bk, i);
    lo = s < lo ? s : lo;
    if (a.mask[i]) hi = bk[i] > hi ? bk[i] : hi;
  }
  lo = block_reduce(lo, [](long long p, long long q) { return p < q ? p : q; }, s_red);
  hi = block_reduce(hi, [](long long p, long long q) { return p > q ? p : q; }, s_red);
  const unsigned long long ulo = flip(lo);
  unsigned long long rej = flip(TS_POS) - ulo;
  const unsigned long long past = flip(hi) - ulo;
  if (past != ~0ull && past + 1 < rej) rej = past + 1;
  unsigned long long o = 0, n = ~0ull;
  for (int i = tid; i < B; i += nt) {
    const unsigned long long u = a.mask[i] ? flip(bk[i]) - ulo : rej;
    kv[i] = u;
    o |= u;
    n &= u;
  }
  for (int p = tid; p < B; p += nt) x[p] = a.gorder[p];
  o = block_reduce(o, OrU64(), sm.red);
  n = block_reduce(n, AndU64(), sm.red);
  radix_sort(x, y, B, kv, o, n, sm);
  const int* ord = x;

  // the order, the accumulated lanes in sorted order (mask folded in)
  for (int p = tid; p < B; p += nt) a.order[row + p] = ord[p];
  for (int k = 0; k < a.S; ++k) {
    const int ln = a.lane[k];
    if (ln == L_VALUE) continue;
    const long long* v = a.sval + (long long)k * B;
    const long long id = (ln == L_MIN || ln == L_MAX) ? mm_ident(a.vty[k], ln == L_MIN) : 0;
    long long* out = a.ssv + ((long long)k * D + d) * B;
    for (int p = tid; p < B; p += nt) {
      const int i = ord[p];
      out[p] = a.mask[i] ? v[i] : id;
    }
  }

  // run bounds over the sorted order: thread t's positions [q0, q1); a run
  // starts where the key (the bucket) or a group key changes, and is
  // accepted where its key is below the rejected events' (its bucket below
  // 2**62)
  const int E2 = (B + nt - 1) / nt;
  const int q0 = min(B, tid * E2), q1 = min(B, q0 + E2);
  int* first = y;                     // the sort's spare buffer: run heads
  long long mine = 0;                 // runs | accepted runs << 32
  for (int p = q0; p < q1; ++p) {
    const int i = ord[p];
    bool f = p == 0;
    if (!f) {
      const int h = ord[p - 1];
      f = kv[h] != kv[i];
      for (int g = 0; g < G && !f; ++g)
        f = a.gkey[(long long)g * B + h] != a.gkey[(long long)g * B + i];
    }
    first[p] = f;
    if (f) mine += 1 + ((long long)(kv[i] < rej) << 32);
  }
  long long tot;
  const long long ex = block_excl_scan<long long>(mine, sm.w, &tot);
  int run = (int)(ex & 0xffffffffLL);
  for (int p = q0; p < q1; ++p)
    if (first[p]) a.start[row + run++] = p;
  if (tid == 0) {
    a.nseg[d] = (int)(tot & 0xffffffffLL);
    a.n_runs[d] = tot >> 32;
  }
}

// ----------------------------------------------------------- 4. a_reduce
// One thread per (d, run slot s < B, lane z): z < S reduces lane z of run
// s; z == S writes the run's bucket, count and group keys.
__global__ void a_reduce(const AArgs a) {
  const int d = blockIdx.y, k = blockIdx.z, B = a.B, D = a.D;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  const long long row = (long long)d * B, o = row + s;
  const int* ord = a.order + row;
  const long long* bk = a.buckets + row;
  const int nseg = a.nseg[d];
  int st = 0, en = 0, lead = B - 1, lastc = 0;
  long long cnt = 0;
  if (s < nseg) {
    st = a.start[row + s];
    en = s + 1 < nseg ? a.start[row + s + 1] : B;
    lead = st;
    if (segm_of(a, bk, ord[st]) < TS_POS) {   // accepted run
      lastc = en - 1;
      cnt = en - st;
    }
  }
  if (k == a.S) {
    a.bucket[o] = segm_of(a, bk, ord[lead]);
    a.count[o] = cnt;
    for (int g = 0; g < a.G; ++g)
      store_typed(a.o_g[g], a.g_ty[g], o, a.gkey[(long long)g * B + ord[lead]]);
    return;
  }
  const int ln = a.lane[k], ty = a.vty[k];
  const long long* v = a.ssv + ((long long)k * D + d) * B;   // sorted, masked
  if (ln == L_VALUE) {
    store_typed(a.o_main[k], ty, o, a.sval[(long long)k * B + ord[lastc]]);
  } else if (ln == L_INT) {
    unsigned long long acc = 0;                 // wraps as int64 does
#pragma unroll 8
    for (int p = st; p < en; ++p) acc += (unsigned long long)v[p];
    ((long long*)a.o_main[k])[o] = (long long)acc;
  } else if (ln == L_F64) {
    double acc = 0.0;
#pragma unroll 8
    for (int p = st; p < en; ++p) acc = __dadd_rn(acc, as_d(v[p]));
    ((double*)a.o_main[k])[o] = acc;
  } else if (ln == L_F64SQ) {
    double acc = 0.0, sq = 0.0;
#pragma unroll 8
    for (int p = st; p < en; ++p) {
      const double x = as_d(v[p]);
      acc = __dadd_rn(acc, x);
      sq = __dadd_rn(sq, __dmul_rn(x, x));
    }
    ((double*)a.o_main[k])[o] = acc;
    ((double*)a.o_sq[k])[o] = sq;
  } else {
    const bool is_min = ln == L_MIN;
    long long acc = mm_ident(ty, is_min);
#pragma unroll 8
    for (int p = st; p < en; ++p) acc = mm_combine(acc, v[p], ty, is_min);
    store_typed(a.o_main[k], ty, o, acc);
  }
}

// ------------------------------------------------------------ host entry

extern "C" int aggregation_step_args_size(void) { return (int)sizeof(AArgs); }

// Launches one step on `stream`; *nlaunch receives the number of kernel
// launches made. Returns cudaGetLastError() after each launch (0 on
// success).
extern "C" int aggregation_step(const AArgs* args, void* stream, int* nlaunch) {
  const AArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  *nlaunch = 0;
  const int nb = (a.B + NT - 1) / NT;
  // the sorts' sequences and keys: shared memory where B fits one tile
  const int dyn = a.B <= TILE ? a.B * (int)(sizeof(unsigned long long) + 2 * sizeof(int)) : 0;
  cudaError_t e = cudaSuccess;
  if (dyn > 0) {
    e = cudaFuncSetAttribute(a_gsort, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(a_bsort, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
  }
  a_eval<<<nb, NT, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  a_gsort<<<1, NTS, dyn, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  a_bsort<<<a.D, NTS, dyn, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  a_reduce<<<dim3(nb, a.D, a.S + 1), NT, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  return 0;
}
