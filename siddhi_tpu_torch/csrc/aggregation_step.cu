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
// The reference vmaps a full lexsort and six segment reductions over the D
// durations. Four launches here, all on the caller's stream, nothing
// allocated:
//   1. a_eval, one thread per event: the mask (valid and every filter), each
//      select attribute's value (int64, f64 bits or the typed slot) and the
//      group keys as int64, into scratch; each runs once, not once per
//      duration.
//   2. a_rank, D x ceil(B / 256) CTAs: each thread streams its duration's
//      composite keys (bucket or 2**62, then the group keys from the last)
//      through shared memory in tiles of 256 and counts the events ordered
//      before its own (ties broken by arrival index), then writes
//      order[d][rank] = i. O(D * B^2) comparisons, deterministic and
//      stable by construction; a radix or merge sort is later work.
//   3. a_bounds, one CTA per duration: run boundaries over the sorted
//      order, each run's first position (block_rank), the number of runs
//      and of accepted runs (n_runs).
//   4. a_reduce, one thread per (d, run slot s < B): walks run s in sorted
//      order and accumulates count, the int64 and f64 sums left to right
//      from 0 (the reference's segment_sum order: the same bits), the
//      squares and min/max; then gathers last_ at the run's last accepted
//      position and g_ / bucket at its leader. Slots past the runs write
//      the empty-segment values.
//
// What bounds it on the H100: bytes. A step reads the referenced columns,
// the valid mask and the [D, B] slab once and writes the [D, B] lanes once
// (~1.3 MB for D = 6, B = 4096 and six lanes: ~0.4 us at 3.35 TB/s); its
// essential operations (a comparison sort, ~B log2 B compares per duration,
// and one add per event, lane and duration) are ~0.5 M, nanoseconds at the
// card's rate. This first version spends its time elsewhere: the rank pass
// makes D * B^2 comparisons (~100 M at B = 4096), and a_reduce walks each
// run serially in one thread, so the longest run (up to B events for a
// coarse duration without group-by) sets the step's tail. Both are spread
// over D * B threads so every SM has work; the serial walk is what keeps
// the f64 sums in the reference's order.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXSTACK 32
#include "expr_ir.cuh"

#define AMAXCOL 32
#define AMAXG 8
#define AMAXSPEC 32
#define NT 256
#define NTB 1024
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
  int* order;                       // [D, B] sorted position -> event
  int* start;                       // [D, B] run -> first sorted position
  unsigned char* first;             // [D, B]
  int* rank;                        // [D, B] block_rank scratch
  int* nseg;                        // [D] runs, accepted or not
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

// ------------------------------------------------------------- 2. a_rank
__global__ void a_rank(const AArgs a) {
  __shared__ long long s_key[(AMAXG + 1) * NT];
  const int d = blockIdx.y, B = a.B, G = a.G, tid = threadIdx.x;
  const int nt = blockDim.x;                 // <= NT
  const int i = blockIdx.x * nt + tid;
  const long long* bk = a.buckets + (long long)d * B;
  // key k: 0 is the bucket (2**62 when rejected), k = 1..G the group keys
  // from the last to the first (the lexsort's significance)
  long long mine[AMAXG + 1];
  if (i < B) {
    mine[0] = segm_of(a, bk, i);
    for (int k = 1; k <= G; ++k) mine[k] = a.gkey[(long long)(G - k) * B + i];
  }
  int rank = 0;
  for (int base = 0; base < B; base += nt) {
    __syncthreads();
    const int j = base + tid;
    if (j < B) {
      s_key[tid] = segm_of(a, bk, j);
      for (int k = 1; k <= G; ++k) s_key[k * NT + tid] = a.gkey[(long long)(G - k) * B + j];
    }
    __syncthreads();
    if (i >= B) continue;
    const int n = B - base < nt ? B - base : nt;
    for (int t = 0; t < n; ++t) {
      int before = base + t < i;             // equal keys: arrival order
      for (int k = 0; k <= G; ++k) {
        const long long kj = s_key[k * NT + t];
        if (kj != mine[k]) { before = kj < mine[k]; break; }
      }
      rank += before;
    }
  }
  if (i < B) a.order[(long long)d * B + rank] = i;
}

// ----------------------------------------------------------- 3. a_bounds
__global__ void a_bounds(const AArgs a) {
  __shared__ int s_scan[NTB / 32 + 1];
  __shared__ long long s_red[NTB / 32];
  const int d = blockIdx.x, B = a.B, G = a.G, tid = threadIdx.x;
  const long long row = (long long)d * B;
  const int* ord = a.order + row;
  const long long* bk = a.buckets + row;
  unsigned char* first = a.first + row;
  long long acc_runs = 0;
  for (int p = tid; p < B; p += blockDim.x) {
    const int i = ord[p];
    const long long sg = segm_of(a, bk, i);
    bool f = p == 0;
    if (!f) {
      const int h = ord[p - 1];
      f = segm_of(a, bk, h) != sg;
      for (int g = 0; g < G && !f; ++g)
        f = a.gkey[(long long)g * B + h] != a.gkey[(long long)g * B + i];
    }
    first[p] = f;
    acc_runs += f && sg < TS_POS;
  }
  const int nseg = block_rank(first, a.rank + row, B, s_scan);
  for (int p = tid; p < B; p += blockDim.x)
    if (first[p]) a.start[row + a.rank[row + p]] = p;
  const long long nr = block_reduce(acc_runs, [](long long x, long long y) { return x + y; }, s_red);
  if (tid == 0) {
    a.nseg[d] = nseg;
    a.n_runs[d] = nr;
  }
}

// ----------------------------------------------------------- 4. a_reduce
__global__ void a_reduce(const AArgs a) {
  const int d = blockIdx.y, B = a.B, s = blockIdx.x * blockDim.x + threadIdx.x;
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
  a.bucket[o] = segm_of(a, bk, ord[lead]);
  a.count[o] = cnt;
  for (int k = 0; k < a.S; ++k) {
    const int ln = a.lane[k], ty = a.vty[k];
    const long long* v = a.sval + (long long)k * B;
    if (ln == L_VALUE) {
      store_typed(a.o_main[k], ty, o, v[ord[lastc]]);
    } else if (ln == L_INT) {
      unsigned long long acc = 0;                 // wraps as int64 does
      for (int p = st; p < en; ++p) {
        const int i = ord[p];
        if (a.mask[i]) acc += (unsigned long long)v[i];
      }
      ((long long*)a.o_main[k])[o] = (long long)acc;
    } else if (ln == L_F64 || ln == L_F64SQ) {
      double acc = 0.0, sq = 0.0;
      for (int p = st; p < en; ++p) {
        const int i = ord[p];
        const double x = a.mask[i] ? as_d(v[i]) : 0.0;
        acc = __dadd_rn(acc, x);
        sq = __dadd_rn(sq, __dmul_rn(x, x));
      }
      ((double*)a.o_main[k])[o] = acc;
      if (ln == L_F64SQ) ((double*)a.o_sq[k])[o] = sq;
    } else {
      const bool is_min = ln == L_MIN;
      const long long id = mm_ident(ty, is_min);
      long long acc = id;
      for (int p = st; p < en; ++p) {
        const int i = ord[p];
        acc = mm_combine(acc, a.mask[i] ? v[i] : id, ty, is_min);
      }
      store_typed(a.o_main[k], ty, o, acc);
    }
  }
  for (int g = 0; g < a.G; ++g)
    store_typed(a.o_g[g], a.g_ty[g], o, a.gkey[(long long)g * B + ord[lead]]);
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
  a_eval<<<nb, NT, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  a_rank<<<dim3(nb, a.D), NT, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  a_bounds<<<a.D, NTB, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  a_reduce<<<dim3(nb, a.D), NT, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  return 0;
}
