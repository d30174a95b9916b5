// Single-stream query step kernel for Hopper (sm_90a).
//
// Replaces, from the reference JAX package:
//   - tpu/query_compile.py::CompiledStreamQuery._make_step (B5a: filter,
//     stable compaction, the sliding windows length/time/externalTime/
//     timeLength, batch(), windowed and unwindowed group-by, having, and
//     the sum/count/avg/min/max/stdDev aggregates; helpers _range_reduce,
//     _range_sums, _keyed_range_sums, _window_svars, _time_window_bounds,
//     _slide_tails, _materialize)
//   - the tumbling half of B5b in the same file: lengthBatch
//     (_length_batch), timeBatch, externalTimeBatch and session
//     (_segmented_batch), delay (the step's delay branch) and hopping
//     (_hopping_flushes). sort, frequent and lossyFrequent are
//     query_walk.cu's.
// and evaluates filters, projections, aggregate arguments, group keys and
// having through B2's IR (expr_ir.cuh; OP_TS is linked as a read of the
// int64 timestamp column, having reads the row's outputs as bindings and
// a fleet parameter column as an event read at the output slot, from the
// parameter values compacted with the accepted events).
//
// What it computes, per step over a batch of B events: the filter mask and
// its stable compaction (query_common.cuh); the step's axis z: the tail
// and the batch, z = [tail (N) | batch (B)], for the sliding windows and
// hopping, the open remainder and the batch's accepted events compacted,
// z = [remainder (r) | accepted (k) | fills], for the tumbling windows, or
// the batch alone; and for every output slot o a range [lo_o, hi_o] of z:
//   - sliding: o = b, hi = N + b, lo the live tail (length), a binary
//     search over the clamped event times (time), or both (timeLength);
//   - lengthBatch: o over all M = N + B slots, lo = (o / N) * N;
//   - timeBatch/session: o over M, lo = the start of o's segment (bucket
//     id (t - base) // duration, or a break where the gap >= duration),
//     from a max-scan of segment heads over the monotonised clock;
//   - hopping: o = the f-th flush boundary t_f = b0 + f * hop of the step,
//     [lo, hi] = the events in (t_f - duration, t_f), two binary searches;
// sums and counts as prefix differences, min/max as exact range
// reductions, stdDev from float64 shifted moments; for group-by the bucket
// ids, the ownership map and collision count, and per-key sums over the
// range (windowed) or per-key prefixes plus the carried [K] tables
// (unwindowed: Kahan f32 sums, int64 sums and counts, min/max,
// Welford-merged f32 stdDev); the running aggregates; the outputs, the
// having mask and the new state (tails slide by k; a tumbling window keeps
// its open part, capped at the N newest, counting drops).
//
// Design: a step is a chain of launches on the stream, 4 to 10 by shape
// (QueryPlan.passes and .step_launches count them on the host; no launch
// waits on the host, and grids are sized for the worst case, M = N + B):
//   1. q_mask and q_compact, grids of TN events a CTA: the filters, then
//      the stable compaction of the accepted events (the output timestamps
//      and value projections go straight to the outputs, the aggregate
//      arguments to batch lanes); q_prep, one CTA: bucket ids; the sliding
//      windows' time clamp (a max-scan over B), regressions and drops;
//      hopping's flush scalars; ownership and collisions; the scalars the
//      grids read.
//   2. group-by only: a stable counting sort of the scan positions by
//      bucket over rows of gsub positions, one warp a row: q_gcount (per
//      row and bucket counts, equal keys merged by __match_any_sync),
//      q_gscan (one CTA: each bucket's rows' starts, the buckets' starts),
//      q_gplace (each row places its positions in order, 32 a round,
//      ranked by __match_any_sync). Replaces the reference's [M, K]
//      one-hot grids.
//   3. q_pass, 1 to 3 launches of a grid over (tile of TILE = 2048
//      positions, task): the axis task (the tumbling windows' monotonised
//      clock, segment ids and heads, each slot's range start and validity;
//      the sliding windows' and hopping's binary-searched range bounds) and
//      one task per aggregate lane: an inclusive scan over the scan
//      positions (segmented by bucket when grouped): float32 lanes in
//      float64 (each prefix rounds to float32 once, as the plain version
//      does), int64 lanes and counts exactly, stdDev lanes as float64
//      (windowed, centred at the axis mean) or float32-rounded (carried)
//      shifted moments, min/max lanes as prefix/suffix reductions within
//      blocks of 32, within chunks of 32 blocks and a sparse table over the
//      chunks (exact range min/max for any [lo, j]). Each scan is a
//      reduce-then-scan (query_common.cuh: tile aggregates, then a rescan
//      from the fold of the tiles before) whose order depends on the tile
//      layout alone. There are no tile-status words or tickets: every
//      tile aggregate is written by one pass before the next reads it, so
//      no scratch needs a reset but the counters q_prep zeroes and the
//      sort's count matrix (a memset on the stream).
//   4. q_emit, a grid over max(O, N, K): each output slot reads its range
//      from the scans (binary searches inside its bucket's segment when
//      grouped), materialises every output, evaluates having; the new
//      tails, remainders and per-key tables are written to fresh buffers
//      (the input state is read-only, as in the reference).
//
// What bounds it on the H100: bytes, in principle. A step moves the batch
// columns, the tails it reads and writes, the outputs and the [K] tables:
// about 0.4-8 MB, a few microseconds at 3.35 TB/s. This design spreads
// every M- and B-long pass over the card; what is left is the launches'
// chain (each a few microseconds of latency), the single-CTA parts over B
// or K (the time clamp, ownership, the buckets' starts), and the binary
// searches' dependent loads.

#include "query_common.cuh"

#define NT 1024
#define NT_EMIT 256

// int64 arithmetic that wraps, as XLA's does
__device__ __forceinline__ long long wadd(long long x, long long y) {
  return (long long)((unsigned long long)x + (unsigned long long)y);
}
__device__ __forceinline__ long long wmul(long long x, long long y) {
  return (long long)((unsigned long long)x * (unsigned long long)y);
}
// floor division (jnp's // on int64), d > 0
__device__ __forceinline__ long long floor_div(long long x, long long d) {
  long long q = x / d;
  if ((x % d != 0) && (x < 0)) --q;
  return q;
}

// z-axis readers: position p of the step's axis [tail | batch | fills];
// the tail is N slots (sliding, hopping), the remainder's r (tumbling) or
// nothing
__device__ __forceinline__ bool sliding(const QArgs& a) {
  return a.wkind == W_LENGTH || a.wkind == W_TIME || a.wkind == W_TIMELENGTH;
}
__device__ __forceinline__ int zsplit(const QArgs& a) {
  if (sliding(a) || a.wkind == W_HOPPING) return a.N;
  return remainder_kind(a.wkind) ? a.misc[2] : 0;
}
__device__ __forceinline__ float zf(const QArgs& a, int l, int p) {
  const int sp = zsplit(a), q = p - sp;
  if (q < 0) return a.f_in[(long long)l * a.N + p];
  return q < a.B ? a.bf[(long long)l * a.B + q] : 0.0f;
}
__device__ __forceinline__ long long zi(const QArgs& a, int l, int p) {
  const int sp = zsplit(a), q = p - sp;
  if (q < 0) return a.i_in[(long long)l * a.N + p];
  return q < a.B ? a.bi[(long long)l * a.B + q] : 0;
}
__device__ __forceinline__ float zs(const QArgs& a, int l, int p) {
  const int sp = zsplit(a), q = p - sp;
  if (q < 0) return a.s_in[(long long)l * a.N + p];
  return q < a.B ? a.bs[(long long)l * a.B + q] : 0.0f;
}
__device__ __forceinline__ long long zm(const QArgs& a, int l, int p) {
  const int sp = zsplit(a), q = p - sp;
  if (q < 0) return load_typed(a.m_in[l], a.m_ty[l], p);
  return q < a.B ? a.bm[(long long)l * a.B + q] : a.m_ident[l];
}
__device__ __forceinline__ int zo(const QArgs& a, int p) {
  const int sp = zsplit(a), q = p - sp;
  if (q < 0) return a.ones_in[p];
  return q < a.B ? a.bones[q] : 0;
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
__device__ __forceinline__ int lower_bound_zts(const QArgs& a, long long x) {
  int lo = 0, hi = a.N + a.B;              // first position with zts >= x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (zts(a, mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// step scalars the passes and q_emit read: acc[] (zeroed or set by q_prep)
enum { ACC_REG = 0, ACC_BASE, ACC_B0, ACC_NF };
#define MISC_NV 3     // misc[3]: valid (timeBatch, session) or released
                      // (delay) slots, counted by the passes

// The tumbling windows' raw clock over M = N + B slots ([remainder r |
// accepted k | fills]): the rows' own timestamps; fills sort after every
// real event.
__device__ __forceinline__ long long raw_clock(const QArgs& a, int p, int r, int total) {
  if (p < r) return a.rts_in[p];
  if (p < total) return a.bwts[p - r];
  return a.wkind == W_LBATCH ? 0 : TS_POS;
}

// hopping(D, H): the step's flush boundaries t_f = b0 + f * H (f < B; the
// first nf fire) on the axis [tail (N) | batch]; bwts holds the clamped
// batch clock. Boundaries past B fire on the next step. Each boundary's
// range is the pass grid's (axis_bounds).
__device__ void prep_hopping(const QArgs& a, int k, long long last,
                             long long* s_buf) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int B = a.B;
  const long long H = a.hop_ms, D = a.window_ms;
  const long long newest = k > 0 ? a.bwts[k - 1] : last;
  const bool armed = *a.base_in > TS_NEG;
  // unarmed: the tail is empty and the first real event sits at slot N
  const long long b0 = armed ? *a.base_in : wadd(a.bwts[0], H);
  const bool any = armed || k > 0;
  long long nf = (any && newest >= b0) ? (newest - b0) / H + 1 : 0;
  if (nf > B) nf = B;
  const long long live_cut = nf > 0 ? wadd(wadd(b0, wmul(nf - 1, H)), -D) : TS_NEG;
  long long drops = 0;                         // live slots pushed out
  for (int p = tid; p < k; p += nt)
    if (zts(a, p) > live_cut) drops += zo(a, p);
  drops = block_sum<long long>(drops, s_buf);
  if (tid == 0) {
    *a.base_out = nf > 0 ? wadd(b0, wmul(nf, H)) : (any ? b0 : TS_NEG);
    *a.drops_out = *a.drops_in + drops;
    a.misc[1] = a.N + B;
    a.acc[ACC_B0] = b0;
    a.acc[ACC_NF] = nf;
  }
}

// Stage 1 over a grid of TN events a CTA: q_mask evaluates the filters and
// counts each CTA's accepted events; q_compact ranks them (the counts of
// the CTAs before, then warp ballots) and writes each to its slot, the
// slots past k their fills (query_common.cuh: compact_event, compact_fill).
__global__ void __launch_bounds__(TN) q_mask(QArgs a) {
  __shared__ int s_buf[TN / 32 + 1];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool m = b < a.B && accept_event(a, b);
  if (b < a.B) a.mask[b] = m;
  const int c = block_sum<int>(m, s_buf);
  if (threadIdx.x == 0) a.ccnt[blockIdx.x] = c;
}

// the accepted count of the CTAs before CTA c (or all, c = n) of the n
// counts, by warp 0; every thread of the CTA calls it
__device__ int count_before(const QArgs& a, int c, int n, int* s_one) {
  if (threadIdx.x < 32) {
    int x = 0;
    for (int u = threadIdx.x; u < c && u < n; u += 32) x += a.ccnt[u];
    for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(FULL, x, d);
    if (threadIdx.x == 0) *s_one = x;
  }
  __syncthreads();
  const int r = *s_one;
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(TN) q_compact(QArgs a) {
  __shared__ int s_warp[TN / 32];
  __shared__ int s_one;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int voff = remainder_kind(a.wkind) ? *a.rc_in : 0;
  const int before = count_before(a, blockIdx.x, gridDim.x, &s_one);
  const int k = count_before(a, gridDim.x, gridDim.x, &s_one);
  const bool m = b < a.B && a.mask[b];
  const unsigned bal = __ballot_sync(FULL, m);
  if (lane == 0) s_warp[warp] = __popc(bal);
  __syncthreads();
  int r = before + __popc(bal & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) r += s_warp[w];
  if (m) compact_event(a, b, r, voff);
  if (b < a.B && b >= k) compact_fill(a, b, voff);
}

__global__ void __launch_bounds__(NT) q_prep(QArgs a) {
  __shared__ long long s_buf[33];
  __shared__ int s_flag[33];
  __shared__ int s_one;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int B = a.B, N = a.N, K = a.K;
  const bool rem = remainder_kind(a.wkind), hop = a.wkind == W_HOPPING;
  const int r0 = rem ? *a.rc_in : 0;
  const int nc = (B + TN - 1) / TN;
  const int k = count_before(a, nc, nc, &s_one);
  if (a.grouped)
    for (int s = tid; s < B; s += nt) a.bkey[s] = bucket_of(a, a.bpacked[s]);
  if (tid == 0) {
    a.misc[0] = k;
    a.misc[2] = r0;
    a.misc[MISC_NV] = 0;
    a.acc[ACC_REG] = 0;
    *a.ocount = (a.wkind == W_BATCH || hop) ? 0 : k;
  }
  if (rem) {
    // the tumbling windows' axis is the pass grid's (axis_remainder)
    if (tid == 0) {
      a.misc[1] = a.M;
      if (a.wkind == W_TBATCH) {
        // the first bucket starts at the axis' first clock value
        const int total = r0 + k;
        const long long base = *a.base_in > TS_NEG ? *a.base_in : raw_clock(a, 0, r0, total);
        a.acc[ACC_BASE] = base;
        *a.base_out = total > 0 ? base : *a.base_in;
      }
    }
    return;
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
  } else if (a.wkind == W_TIME || a.wkind == W_TIMELENGTH || hop) {
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
    if (tid == 0) {
      *a.regress_out = *a.regress_in + regressed;
      long long nl = last;
      if (k > 0 && a.bwts[k - 1] > nl) nl = a.bwts[k - 1];
      *a.last_ts_out = nl;
    }
    if (hop) {
      prep_hopping(a, k, last, s_buf);
      return;
    }
    // the ranges' lower bounds are the pass grid's (axis_bounds)
    const long long D = a.window_ms;
    const long long newest = zts(a, N + k - 1 > 0 ? N + k - 1 : 0);
    long long drops = 0;
    for (int p = tid; p < k; p += nt)
      if (zts(a, p) > newest - D) drops += zo(a, p);
    drops = block_sum<long long>(drops, s_buf);
    if (tid == 0) *a.drops_out = *a.drops_in + (a.wkind == W_TIME ? drops : 0);
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
  for (int q = tid; q < K; q += nt) a.firstidx[q] = 0x7fffffff;
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
  if (tid == 0) {
    *a.coll_out = *a.coll_in + coll;
    a.misc[1] = sliding(a) ? N + B : k;          // the scan positions P
  }
}

// ------------------------------------------- 2. the group-by's stable sort
// The scan positions [0, P) sorted stably by bucket (sorted[], with head[]
// marking each bucket's first): a counting sort over rows of gsub
// positions, one warp a row. q_gcount counts each row's positions per
// bucket into gmat[row, bucket] (zeroed on the stream first); q_gscan turns
// each bucket's column into the rows' exclusive starts, and the buckets'
// totals into their starts seg[] (an exclusive scan over K); q_gplace places
// each row's positions in order, 32 a round, equal buckets ranked by
// __match_any_sync. Replaces the reference's [M, K] one-hot grids.

__device__ __forceinline__ int sort_row(void) {
  return blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
}

__global__ void __launch_bounds__(TN) q_gcount(QArgs a) {
  const int P = a.misc[1], row = sort_row(), lane = threadIdx.x & 31;
  if (row >= a.nrow || row * a.gsub >= P) return;          // whole warps
  int* cnt = a.gmat + (long long)row * a.K;
  for (int i = 0; i < a.gsub; i += 32) {
    const int p = row * a.gsub + i + lane;
    const bool in = p < P;
    const int key = in ? zk(a, p) : -1;
    const unsigned peers = __match_any_sync(FULL, key);
    if (in && lane == __ffs(peers) - 1) atomicAdd(&cnt[key], __popc(peers));
  }
}

__global__ void __launch_bounds__(NT) q_gscan(QArgs a) {
  __shared__ long long s_buf[33];
  __shared__ int s_flag[33];
  const int K = a.K, P = a.misc[1];
  const int rows = (P + a.gsub - 1) / a.gsub;
  for (int q = threadIdx.x; q < K; q += blockDim.x) {
    int run = 0;
    for (int r0 = 0; r0 < rows; r0 += 8) {        // 8 loads in flight
      int n[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        n[i] = r0 + i < rows ? a.gmat[(long long)(r0 + i) * K + q] : 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (r0 + i < rows) a.gmat[(long long)(r0 + i) * K + q] = run;
        run += n[i];
      }
    }
    a.cnt[q] = run;
  }
  __syncthreads();
  block_seg_scan<long long>(
      K, AddOp(), [&](int q) { return (long long)a.cnt[q]; },
      [](int) { return false; },
      [&](int q, long long v) { a.seg[q] = (int)(v - a.cnt[q]); }, s_buf, s_flag);
}

__global__ void __launch_bounds__(TN) q_gplace(QArgs a) {
  const int P = a.misc[1], row = sort_row(), lane = threadIdx.x & 31;
  if (row >= a.nrow || row * a.gsub >= P) return;          // whole warps
  int* start = a.gmat + (long long)row * a.K;
  for (int i = 0; i < a.gsub; i += 32) {
    const int p = row * a.gsub + i + lane;
    const bool in = p < P;
    const int key = in ? zk(a, p) : -1;
    const unsigned peers = __match_any_sync(FULL, key);
    const int below = __popc(peers & ((1u << lane) - 1u));
    const int off = in ? start[key] + below : 0;
    if (in) {
      const int at = a.seg[key] + off;
      a.sorted[at] = p;
      a.head[at] = off == 0;
    }
    __syncwarp();
    if (in && lane == __ffs(peers) - 1) start[key] = off + __popc(peers);
    __syncwarp();
  }
}

// ------------------------------------------------------------ 3. q_pass
// The pass grid: blockIdx.x a tile of TILE positions, blockIdx.y a task:
// 0 the axis (the tumbling windows' clock, segments and validity; the
// sliding and hopping windows' range bounds), then the aggregate lanes: AF
// float sums, AI int sums, the ones lane, AS stdDev lanes, AM min/max
// lanes. Pass 1 writes tiles' aggregates, pass 2 (and 3) rescan from the
// fold of the tiles before them; CTAs past their task's axis exit.

struct Sm { long long* v; int* f; long long* blk; int* blkf; };

template <typename T>
__device__ __forceinline__ T* tslot(const QArgs& a, int task, int s) {
  return (T*)(a.tagg + ((long long)task * 4 + s) * a.ntile);
}
__device__ __forceinline__ int* tflag(const QArgs& a, int task, int s) {
  return a.tfl + ((long long)task * 4 + s) * a.ntile;
}
__device__ __forceinline__ int* tpoison(const QArgs& a, int task, int j) {
  return a.tpz + ((long long)task * 2 + j) * 3 * a.ntile;
}
template <typename T>
__device__ __forceinline__ Seg<T> tile_get(const QArgs& a, int task, int s, int u) {
  return Seg<T>{tslot<T>(a, task, s)[u], tflag(a, task, s)[u]};
}
template <typename T>
__device__ __forceinline__ void tile_put(const QArgs& a, int task, int s, int t, Seg<T> x) {
  if (threadIdx.x == 0) { tslot<T>(a, task, s)[t] = x.v; tflag(a, task, s)[t] = x.f; }
}

// the tumbling windows (lengthBatch, timeBatch, session, delay) over M:
// pass 1 the projections of the remainder's slots and the fills, and the
// raw clock's tile maxima (lengthBatch: everything, elementwise); pass 2 the
// monotonised clock zt (a max-scan) and the output timestamps, regressions,
// timeBatch's bucket ids, and the tiles' last segment heads; pass 3 each
// slot's range [lo, hi] (lo: a max-scan of segment heads) and validity.
__device__ void axis_remainder(const QArgs& a, int pass, int t, Sm sm) {
  const int M = a.M, N = a.N, w = a.wkind, tid = threadIdx.x, nt = blockDim.x;
  const int r = a.misc[2], total = r + a.misc[0];
  const long long ms = a.window_ms;
  const int t0 = t * TILE, p0 = t0 + tid * IPT;
  if (t0 >= M) return;
  if (pass == 1) {
    for (int i = 0; i < IPT; ++i) {
      const int p = t0 + i * nt + tid;
      if (p >= M || (p >= r && p < total)) continue;
      for (int s = 0; s < a.nspec; ++s)
        if (a.spec_kind[s] == S_VALUE)
          store_typed(a.out[s], a.spec_ty[s], p,
                      p < r ? load_typed(a.rp_in[s], a.spec_ty[s], p) : 0);
    }
    if (w == W_LBATCH) {
      const int full = total / N;
      for (int i = 0; i < IPT; ++i) {
        const int p = t0 + i * nt + tid;
        if (p >= M) break;
        const long long v = raw_clock(a, p, r, total);
        a.ots[p] = v;
        a.zt[p] = v;
        a.lo[p] = (p / N) * N;
        a.hi[p] = p;
        // an aggregated batch collapses to one row, its last slot
        a.oflag[p] = p < full * N && p < total && (!a.has_agg || p % N == N - 1);
      }
      return;
    }
    Seg<long long> it[IPT];
    for (int i = 0; i < IPT; ++i) {
      const int p = p0 + i;
      it[i] = p < M ? Seg<long long>{raw_clock(a, p, r, total), SEG_FULL}
                    : Seg<long long>{0, 0};
    }
    tile_put(a, 0, 0, t, tile_scan(MaxI64(), it, sm.v, sm.f));
    return;
  }
  if (w == W_LBATCH) return;
  if (pass == 2) {
    const Seg<long long> carry = fold_tiles<long long>(
        MaxI64(), t, [&](int u) { return tile_get<long long>(a, 0, 0, u); }, sm.v, sm.f);
    Seg<long long> it[IPT];
    long long raw[IPT];
    for (int i = 0; i < IPT; ++i) {
      const int p = p0 + i;
      raw[i] = p < M ? raw_clock(a, p, r, total) : 0;
      it[i] = p < M ? Seg<long long>{raw[i], SEG_FULL} : Seg<long long>{0, 0};
    }
    tile_scan(MaxI64(), it, sm.v, sm.f);
    long long regressed = 0;
    for (int i = 0; i < IPT; ++i) {
      const int p = p0 + i;
      if (p >= M) break;
      const long long z = seg_join(MaxI64(), carry, it[i]).v;
      a.zt[p] = z;
      a.ots[p] = w == W_DELAY ? wadd(z, ms) : raw[i];
      regressed += (z > raw[i]) && p < total;
    }
    regressed = block_sum<long long>(regressed, sm.v);
    if (tid == 0 && regressed)
      atomicAdd((unsigned long long*)&a.acc[ACC_REG], (unsigned long long)regressed);
    if (w == W_DELAY) return;
    __syncthreads();                             // the tile's zt
    // segment heads: a new bucket id (timeBatch), or a gap of at least the
    // parameter (session: exactly the parameter closes it)
    const long long base = a.acc[ACC_BASE];
    long long hmax = 0;
    for (int i = 0; i < IPT; ++i) {
      const int p = p0 + i;
      if (p >= M) break;
      const long long z = a.zt[p];
      const long long prev = p == 0 ? 0 : (p == t0 ? carry.v : a.zt[p - 1]);
      bool head;
      if (w == W_TBATCH) {
        const long long g = floor_div(z - base, ms);
        a.zseg[p] = g;
        head = p == 0 || g != floor_div(prev - base, ms);
      } else {
        head = p == 0 || z - prev >= ms;
      }
      if (head && p > hmax) hmax = p;
    }
    tile_put(a, 0, 1, t, Seg<long long>{block_reduce<long long>(hmax, MaxI64(), sm.v), SEG_FULL});
    return;
  }
  if (w == W_DELAY) {
    // released: at least the delay behind the newest event
    const long long newest = total > 0 ? a.zt[total - 1] : TS_NEG;
    int nrel = 0;
    for (int i = 0; i < IPT; ++i) {
      const int p = t0 + i * nt + tid;
      if (p >= M) break;
      const bool rel = p < total && wadd(a.zt[p], ms) <= newest;
      a.oflag[p] = rel;
      nrel += rel;
    }
    nrel = block_sum<int>(nrel, (int*)sm.v);
    if (tid == 0 && nrel) atomicAdd(&a.misc[MISC_NV], nrel);
    return;
  }
  // a slot's range starts at its segment's head: a max-scan of heads
  const Seg<long long> carry = fold_tiles<long long>(
      MaxI64(), t, [&](int u) { return tile_get<long long>(a, 0, 1, u); }, sm.v, sm.f);
  Seg<long long> h[IPT];
  for (int i = 0; i < IPT; ++i) {
    const int p = p0 + i;
    bool head = p == 0;
    if (p > 0 && p < M)
      head = w == W_TBATCH ? a.zseg[p] != a.zseg[p - 1] : a.zt[p] - a.zt[p - 1] >= ms;
    h[i] = p < M ? Seg<long long>{head ? p : 0, SEG_FULL} : Seg<long long>{0, 0};
  }
  tile_scan(MaxI64(), h, sm.v, sm.f);
  const long long seg_last = w == W_TBATCH ? a.zseg[total > 0 ? total - 1 : 0] : 0;
  int nvalid = 0;
  for (int i = 0; i < IPT; ++i) {
    const int p = p0 + i;
    if (p >= M) break;
    a.lo[p] = (int)seg_join(MaxI64(), carry, h[i]).v;
    a.hi[p] = p;
    bool ok;
    if (w == W_TBATCH) {
      // closed buckets emit; aggregated, one row per bucket (its last)
      ok = p < total && a.zseg[p] < seg_last;
      if (ok && a.has_agg)
        ok = p + 1 >= total || a.zseg[p + 1 < M ? p + 1 : M - 1] != a.zseg[p];
    } else {
      ok = p >= r && p < total;                  // currents pass once
    }
    a.oflag[p] = ok;
    nvalid += ok;
  }
  nvalid = block_sum<int>(nvalid, (int*)sm.v);
  if (tid == 0 && nvalid) atomicAdd(&a.misc[MISC_NV], nvalid);
}

// the sliding time windows' and hopping's range bounds, one output a
// thread, strided over the grid's tiles: binary searches over the axis
// clock, each a chain of dependent loads
__device__ void axis_bounds(const QArgs& a, int t) {
  for (int b = t * blockDim.x + threadIdx.x; b < a.B; b += gridDim.x * blockDim.x) {
    if (a.wkind == W_HOPPING) {
      const long long tf = wadd(a.acc[ACC_B0], wmul(b, a.hop_ms));
      const int l = upper_bound_zts(a, wadd(tf, -a.window_ms));
      int h = lower_bound_zts(a, tf) - 1;
      if (h < l - 1) h = l - 1;                  // empty bucket: zero range
      a.ots[b] = tf;
      a.lo[b] = l;
      a.hi[b] = h;
      a.oflag[b] = b < a.acc[ACC_NF];
    } else {
      long long l = upper_bound_zts(a, a.bwts[b] - a.window_ms);
      if (a.wkind == W_TIMELENGTH && (long long)b + 1 > l) l = (long long)b + 1;   // j - N + 1
      a.lo[b] = (int)l;
    }
  }
}

// The reference's unwindowed grouped sums and stdDev moments are one-hot
// products, onehot[m, key] * x[m]: a non-finite x[m] makes 0 * x[m] = NaN
// in every other key's column from position m on (and in its own too where
// the row is masked off, key -1). (Its windowed grouped sums are not: XLA
// folds their float one-hot product into a select.)
// For one lane over positions [0, X) pz[0..2] keeps the first non-finite
// position m0, its key k0, and the first non-finite position m1 of another
// key (INT_MAX when none): an output at position j of key kb is NaN iff
// (m0 <= j and k0 != kb) or m1 <= j (poisoned()). Each tile keeps the same
// three numbers over its own positions (tile_poison); fold_poison joins
// them in tile order.
__device__ __forceinline__ bool finite32(float f) {
  return (__float_as_uint(f) & 0x7f800000u) != 0x7f800000u;
}

template <class Get, class Key>
__device__ void tile_poison(const QArgs& a, int t, int X, Get get, Key key, int* z,
                            long long* s_buf) {
  long long f1 = 0x7fffffff, f2 = 0x7fffffff;
  for (int i = 0; i < IPT; ++i) {
    const int p = t * TILE + i * blockDim.x + threadIdx.x;
    if (p < X && p < f1 && !finite32(get(p))) f1 = p;
  }
  f1 = block_reduce<long long>(f1, MinI64(), s_buf);
  const int kf = f1 < X ? key((int)f1) : -1;
  for (int i = 0; i < IPT; ++i) {
    const int p = t * TILE + i * blockDim.x + threadIdx.x;
    if (p < X && p < f2 && !finite32(get(p)) && key(p) != kf) f2 = p;
  }
  f2 = block_reduce<long long>(f2, MinI64(), s_buf);
  if (threadIdx.x == 0) {
    z[t] = (int)f1;
    z[a.ntile + t] = kf;
    z[2 * a.ntile + t] = (int)f2;
  }
}

__device__ void fold_poison(const QArgs& a, int X, const int* z, int* pz) {
  int m0 = 0x7fffffff, k0 = -1, m1 = 0x7fffffff;
  for (int u = 0; u * TILE < X; ++u) {
    const int f1 = z[u], kf = z[a.ntile + u], f2 = z[2 * a.ntile + u];
    if (m0 == 0x7fffffff) {
      if (f1 != 0x7fffffff) { m0 = f1; k0 = kf; m1 = f2; }
    } else {
      const int c = kf != k0 ? f1 : f2;
      if (c < m1) m1 = c;
    }
  }
  pz[0] = m0;
  pz[1] = k0;
  pz[2] = m1;
}

__device__ __forceinline__ bool poisoned(const QArgs& a, int pl, int j, int key) {
  const int* z = a.pz + 3 * pl;
  return (z[0] <= j && z[1] != key) || z[2] <= j;
}
#define ANY_POS 0x7ffffffe            // poisoned() at any position
#define F32_NAN __int_as_float(0x7fc00000)

// One lane's inclusive scan over the scan positions [0, P) (segmented by
// bucket when grouped), in slot s of its task: pass 1 writes the tile's
// aggregate, pass 2 rescans the tile from the fold of the tiles before it
// and put()s every position (pass 3 has nothing to do). The CTA's tile
// starts below P.
template <typename T, class Op, class Get, class Put>
__device__ void lane_scan(const QArgs& a, int pass, int t, int task, int s, int P, Op op,
                          Get get, Put put, Sm sm) {
  if (pass > 2) return;
  const int p0 = t * TILE + threadIdx.x * IPT;
  const bool grp = a.grouped != 0;
  Seg<T> it[IPT];
  for (int i = 0; i < IPT; ++i) {
    const int q = p0 + i;
    it[i] = q < P ? Seg<T>{get(q), SEG_FULL | ((grp && a.head[q]) ? SEG_HEAD : 0)}
                  : Seg<T>{T(), 0};
  }
  const Seg<T> tot = tile_scan(op, it, (T*)sm.v, sm.f);
  if (pass == 1) {
    tile_put(a, task, s, t, tot);
    return;
  }
  const Seg<T> carry = fold_tiles<T>(
      op, t, [&](int u) { return tile_get<T>(a, task, s, u); }, (T*)sm.v, sm.f);
  for (int i = 0; i < IPT; ++i) {
    const int q = p0 + i;
    if (q < P) put(q, seg_join(op, carry, it[i]).v);
  }
}

// A min/max lane's range tables over [0, P) (pass 1): the prefix (mP) and
// suffix (mS) of every position within its block of 32; per block, within
// its chunk of 32 blocks, the prefix from the chunk's start (PB), the
// suffix to its end (SB) and a sparse table of 5 levels (TL, level 0 the
// blocks' reductions); the chunks' reductions, level 0 of the sparse table
// over chunks (T2, whose levels pass 2 builds). Four threads hold a block
// (IPT = 8), two warps a tile's two chunks.
__device__ __forceinline__ long long* mtab(const QArgs& a, int l) {
  const long long NB = a.NB, NC = (a.NB + 31) >> 5;
  return a.mT + (long long)l * (7 * NB + a.LV * NC);
}

__device__ void minmax_tables(const QArgs& a, int l, int t, int P, Sm sm) {
  const RedOp op{a.m_ty[l], a.m_min[l]};
  const long long M = a.M;
  const int NB = a.NB, lane = threadIdx.x & 31, g = lane & 3;
  long long* T = mtab(a, l);
  const int p0 = t * TILE + threadIdx.x * IPT;
  Seg<long long> v[IPT], pre[IPT], suf[IPT];
  for (int i = 0; i < IPT; ++i) {
    const int p = p0 + i;
    v[i] = p < P ? Seg<long long>{zm(a, l, p), SEG_FULL} : Seg<long long>{0, 0};
  }
  pre[0] = v[0];
  for (int i = 1; i < IPT; ++i) pre[i] = seg_join(op, pre[i - 1], v[i]);
  suf[IPT - 1] = v[IPT - 1];
  for (int i = IPT - 2; i >= 0; --i) suf[i] = seg_join(op, v[i], suf[i + 1]);
  Seg<long long> inc = pre[IPT - 1], sinc = pre[IPT - 1];
  for (int d = 1; d < 4; d <<= 1) {
    const Seg<long long> u = seg_shfl_up(inc, d), w = seg_shfl_down(sinc, d);
    if (g >= d) inc = seg_join(op, u, inc);
    if (g + d < 4) sinc = seg_join(op, sinc, w);
  }
  Seg<long long> ex = seg_shfl_up(inc, 1), sx = seg_shfl_down(sinc, 1);
  if (g == 0) ex = Seg<long long>{0, 0};
  if (g == 3) sx = Seg<long long>{0, 0};
  for (int i = 0; i < IPT; ++i) {
    const int p = p0 + i;
    if (p >= P) break;
    a.mP[l * M + p] = seg_join(op, ex, pre[i]).v;
    a.mS[l * M + p] = seg_join(op, suf[i], sx).v;
  }
  if (g == 3) { sm.blk[threadIdx.x >> 2] = inc.v; sm.blkf[threadIdx.x >> 2] = inc.f; }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp < TILE / 1024) {
    const int c = t * (TILE / 1024) + warp, b = c * 32 + lane;
    const Seg<long long> x{sm.blk[warp * 32 + lane], sm.blkf[warp * 32 + lane]};
    Seg<long long> pb = x, sb = x, cur = x;
    for (int d = 1; d < 32; d <<= 1) {
      const Seg<long long> u = seg_shfl_up(pb, d), w = seg_shfl_down(sb, d);
      if (lane >= d) pb = seg_join(op, u, pb);
      if (lane + d < 32) sb = seg_join(op, sb, w);
    }
    const bool full = (x.f & SEG_FULL) != 0;
    if (full) {
      T[b] = pb.v;
      T[NB + b] = sb.v;
      T[2 * NB + b] = x.v;
    }
    for (int lv = 1; lv < 5; ++lv) {
      const Seg<long long> u = seg_shfl_down(cur, 1 << (lv - 1));
      if (lane + (1 << (lv - 1)) < 32) cur = seg_join(op, cur, u);
      if (full) T[(long long)(2 + lv) * NB + b] = cur.v;
    }
    if (lane == 31 && (pb.f & SEG_FULL)) T[7LL * NB + c] = pb.v;
  }
}

// the sparse table over chunks (levels 1 ..), by one CTA
__device__ void minmax_chunks(const QArgs& a, int l, int P) {
  const RedOp op{a.m_ty[l], a.m_min[l]};
  const int nc = (((P + 31) >> 5) + 31) >> 5, NC = (a.NB + 31) >> 5;
  long long* T2 = mtab(a, l) + 7LL * a.NB;
  for (int lv = 1, span = 1; lv < a.LV; ++lv, span <<= 1) {
    const long long* prev = T2 + (long long)(lv - 1) * NC;
    long long* cur = T2 + (long long)lv * NC;
    for (int q = threadIdx.x; q < nc; q += blockDim.x)
      cur[q] = q + span < nc ? op(prev[q], prev[q + span]) : prev[q];
    __syncthreads();
  }
}

// The aggregate lanes' passes (task l of the lanes, tile t).
__device__ void lane_pass(const QArgs& a, int pass, int t, int l, Sm sm) {
  const int P = a.misc[1], M = a.M, task = 1 + l;
  const bool grp = a.grouped != 0, in = t * TILE < P;
  if (l < a.AF) {
    if (grp && a.wkind == W_NONE) {
      if (pass == 1 && in)
        tile_poison(a, t, P, [&](int p) { return zf(a, l, p); },
                    [&](int p) { return zk(a, p); }, tpoison(a, task, 0), sm.v);
      if (pass == 2 && t == 0 && threadIdx.x == 0)
        fold_poison(a, P, tpoison(a, task, 0), a.pz + 3 * l);
    }
    if (in)
      lane_scan<double>(
          a, pass, t, task, 0, P, AddOp(), [&](int s) { return (double)zf(a, l, zpos(a, s)); },
          [&](int s, double v) { a.incf[(long long)l * M + s] = v; }, sm);
    return;
  }
  l -= a.AF;
  if (l < a.AI) {
    if (in)
      lane_scan<long long>(
          a, pass, t, task, 0, P, AddOp(), [&](int s) { return zi(a, l, zpos(a, s)); },
          [&](int s, long long v) { a.inci[(long long)l * M + s] = v; }, sm);
    return;
  }
  l -= a.AI;
  if (l == 0) {
    if (in)
      lane_scan<long long>(
          a, pass, t, task, 0, P, AddOp(), [&](int s) { return (long long)zo(a, zpos(a, s)); },
          [&](int s, long long v) { a.inco[s] = v; }, sm);
    return;
  }
  l -= 1;
  if (l < a.AS) {
    double* o1 = a.incs1 + (long long)l * M;
    double* o2 = a.incs2 + (long long)l * M;
    if (a.wkind != W_NONE) {
      // float64 shifted moments centred at the mean of the whole axis:
      // pass 1 the tiles' sums, pass 2 the centre and the tiles' moments,
      // pass 3 the moments' scans
      if (!in) return;
      const int p0 = t * TILE + threadIdx.x * IPT;
      Seg<double> x[IPT], y[IPT];
      if (pass == 1) {
        for (int i = 0; i < IPT; ++i) {
          const int p = p0 + i;
          const double occ = p < P && zo(a, p) > 0 ? 1.0 : 0.0;
          x[i] = p < P ? Seg<double>{(double)zs(a, l, p) * occ, SEG_FULL} : Seg<double>{0.0, 0};
          y[i] = p < P ? Seg<double>{occ, SEG_FULL} : Seg<double>{0.0, 0};
        }
        tile_put(a, task, 0, t, tile_scan(AddOp(), x, (double*)sm.v, sm.f));
        tile_put(a, task, 1, t, tile_scan(AddOp(), y, (double*)sm.v, sm.f));
        return;
      }
      const int ntp = (P + TILE - 1) / TILE;
      const double sx = fold_tiles<double>(
          AddOp(), ntp, [&](int u) { return tile_get<double>(a, task, 0, u); },
          (double*)sm.v, sm.f).v;
      const double so = fold_tiles<double>(
          AddOp(), ntp, [&](int u) { return tile_get<double>(a, task, 1, u); },
          (double*)sm.v, sm.f).v;
      const double c = sx / (so > 1.0 ? so : 1.0);
      for (int i = 0; i < IPT; ++i) {
        const int p = p0 + i;
        const double d = p < P ? ((double)zs(a, l, p) - c) * (zo(a, p) > 0 ? 1.0 : 0.0) : 0.0;
        x[i] = p < P ? Seg<double>{d, SEG_FULL} : Seg<double>{0.0, 0};
        y[i] = p < P ? Seg<double>{d * d, SEG_FULL} : Seg<double>{0.0, 0};
      }
      const Seg<double> t1 = tile_scan(AddOp(), x, (double*)sm.v, sm.f);
      const Seg<double> t2 = tile_scan(AddOp(), y, (double*)sm.v, sm.f);
      if (pass == 2) {
        tile_put(a, task, 2, t, t1);
        tile_put(a, task, 3, t, t2);
        return;
      }
      const Seg<double> c1 = fold_tiles<double>(
          AddOp(), t, [&](int u) { return tile_get<double>(a, task, 2, u); }, (double*)sm.v, sm.f);
      const Seg<double> c2 = fold_tiles<double>(
          AddOp(), t, [&](int u) { return tile_get<double>(a, task, 3, u); }, (double*)sm.v, sm.f);
      for (int i = 0; i < IPT; ++i) {
        const int p = p0 + i;
        if (p >= P) break;
        o1[p] = seg_join(AddOp(), c1, x[i]).v;
        o2[p] = seg_join(AddOp(), c2, y[i]).v;
      }
      return;
    }
    // float32 deviations from the carried centre (per key when grouped)
    auto dev = [&](int s) {
      const int p = zpos(a, s);
      const float c = grp ? a.ckey[(long long)l * a.K + a.bkey[p]] : a.ckey[l];
      const float occ = (float)a.bones[p];
      return __fmul_rn(__fsub_rn(a.bs[(long long)l * a.B + p], c), occ);
    };
    if (grp) {
      // the reference's deviations over all B rows: (x - c) * 0 for the
      // masked-off ones, whose one-hot row is empty (key -1)
      const int k = a.misc[0];
      auto d_at = [&](int p) {
        const float c = a.ckey[(long long)l * a.K + a.bkey[p]];
        return __fmul_rn(__fsub_rn(a.bs[(long long)l * a.B + p], c), (float)a.bones[p]);
      };
      auto key = [&](int p) { return p < k ? a.bkey[p] : -1; };
      if (pass == 1 && t * TILE < a.B) {
        tile_poison(a, t, a.B, d_at, key, tpoison(a, task, 0), sm.v);
        tile_poison(a, t, a.B, [&](int p) { const float d = d_at(p); return __fmul_rn(d, d); },
                    key, tpoison(a, task, 1), sm.v);
      }
      if (pass == 2 && t == 0 && threadIdx.x == 0) {
        fold_poison(a, a.B, tpoison(a, task, 0), a.pz + 3 * (a.AF + 2 * l));
        fold_poison(a, a.B, tpoison(a, task, 1), a.pz + 3 * (a.AF + 2 * l + 1));
      }
    }
    if (!in) return;
    lane_scan<double>(
        a, pass, t, task, 0, P, AddOp(), [&](int s) { return (double)dev(s); },
        [&](int s, double v) { o1[s] = v; }, sm);
    lane_scan<double>(
        a, pass, t, task, 1, P, AddOp(),
        [&](int s) { const float d = dev(s); return (double)__fmul_rn(d, d); },
        [&](int s, double v) { o2[s] = v; }, sm);
    return;
  }
  l -= a.AS;
  if (l < a.AM) {
    const RedOp op{a.m_ty[l], a.m_min[l]};
    if (a.wkind == W_NONE) {
      // prefix (per key when grouped) reductions
      if (in)
        lane_scan<long long>(
            a, pass, t, task, 0, P, op, [&](int s) { return zm(a, l, zpos(a, s)); },
            [&](int s, long long v) { a.mP[(long long)l * M + s] = v; }, sm);
      return;
    }
    // exact range reductions (range_red)
    if (pass == 1 && in) minmax_tables(a, l, t, P, sm);
    if (pass == 2 && t == 0) minmax_chunks(a, l, P);
  }
}

template <int pass>
__global__ void __launch_bounds__(TN) q_pass(QArgs a) {
  __shared__ long long s_v[TN / 32 + 1];
  __shared__ int s_f[TN / 32 + 1];
  __shared__ long long s_blk[TILE / 32];
  __shared__ int s_blkf[TILE / 32];
  const Sm sm{s_v, s_f, s_blk, s_blkf};
  const int t = blockIdx.x;
  if (blockIdx.y > 0) {
    lane_pass(a, pass, t, blockIdx.y - 1, sm);
  } else if (remainder_kind(a.wkind)) {
    axis_remainder(a, pass, t, sm);
  } else if (pass == 1 && (a.wkind == W_TIME || a.wkind == W_TIMELENGTH ||
                           a.wkind == W_HOPPING)) {
    axis_bounds(a, t);
  }
}

// ------------------------------------------------------------ 3. q_emit

// exact reduction of min/max lane l over the blocks x .. y (x <= y) from
// minmax_tables' tables: within one chunk a prefix, a suffix or two
// overlapping sparse-table entries; across chunks the first's suffix, the
// last's prefix and two entries of the chunks' sparse table between them
__device__ long long block_range(const QArgs& a, int l, int x, int y) {
  const RedOp op{a.m_ty[l], a.m_min[l]};
  const long long NB = a.NB, NC = (a.NB + 31) >> 5;
  const long long* T = mtab(a, l);
  const int ca = x >> 5, cb = y >> 5;
  if (ca == cb) {
    if ((x & 31) == 0) return T[y];
    if ((y & 31) == 31) return T[NB + x];
    const int lv = 31 - __clz(y - x + 1);          // < 5: at most 30 blocks
    const long long* L = T + (2 + lv) * NB;
    return op(L[x], L[y - (1 << lv) + 1]);
  }
  long long r = op(T[NB + x], T[y]);
  if (cb - ca >= 2) {
    const int cx = ca + 1, cy = cb - 1;
    const int lv = 31 - __clz(cy - cx + 1);
    const long long* T2 = T + 7 * NB + lv * NC;
    r = op(r, op(T2[cx], T2[cy - (1 << lv) + 1]));
  }
  return r;
}

// exact reduction of min/max lane l over z positions [lo, j] (the
// reference's sparse table, including its value for lo > j, where a
// negative j indexes from the end)
__device__ long long range_red(const QArgs& a, int l, int P, int lo, int j) {
  const RedOp op{a.m_ty[l], a.m_min[l]};
  if (lo > j)
    return op(zm(a, l, j < 0 ? j + P : j), zm(a, l, lo < P - 1 ? lo : P - 1));
  const int qa = lo >> 5, qb = j >> 5;
  if (qa == qb) {
    long long r = zm(a, l, lo);
    for (int p = lo + 1; p <= j; ++p) r = op(r, zm(a, l, p));
    return r;
  }
  const long long M = a.M;
  long long r = op(a.mS[l * M + lo], a.mP[l * M + j]);
  if (qb - qa >= 2) r = op(r, block_range(a, l, qa + 1, qb - 1));
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

__device__ void emit_row(const QArgs& a, int b, int k, int P) {
  const long long M = a.M;
  const bool sl = sliding(a), hop = a.wkind == W_HOPPING;
  const bool ranged = hop || remainder_kind(a.wkind);
  const int j = ranged ? a.hi[b] : (sl ? a.N + b : b);
  const int lo = (ranged || sl) ? a.lo[b] : 0;
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
  const bool carried = a.wkind == W_NONE;    // running or grouped
  long long cnt = 0;
  if (a.wkind == W_LBATCH) cnt = j % a.N + 1;
  else if (a.has_agg) {
    if (a.grouped && !sl) cnt = r_hi + a.cnt_in[key];
    else cnt = EXi(a.inco, r_hi) - EXi(a.inco, r_lo) + (carried ? *a.cnt_in : 0);
  }
  long long ov[QMAXSPEC];
  for (int i = 0; i < a.nspec; ++i) {
    const int kind = a.spec_kind[i], l = a.spec_lane[i];
    long long v = 0;
    if (kind == S_VALUE) {
      if (hop) {
        // a collapsed row's non-aggregate columns read the bucket's last
        // event (the reference clips hi into the axis)
        const int h = j < 0 ? 0 : (j < a.N + a.B ? j : a.N + a.B - 1);
        v = h < a.N ? load_typed(a.rp_in[i], a.spec_ty[i], h)
                    : a.bv[(long long)i * a.B + h - a.N];
        store_typed(a.out[i], a.spec_ty[i], b, v);
      } else {
        v = load_typed(a.out[i], a.spec_ty[i], b);
      }
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
        if (a.grouped && carried && poisoned(a, l, j, key)) fnum = F32_NAN;
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
        float s1 = f32_of(EXd(c1, r_hi)), s2 = f32_of(EXd(c2, r_hi));
        if (a.grouped && poisoned(a, a.AF + 2 * l, j, key)) s1 = F32_NAN;
        if (a.grouped && poisoned(a, a.AF + 2 * l + 1, j, key)) s2 = F32_NAN;
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
  bool ok;
  if (ranged) {
    ok = a.oflag[b] != 0;
    if (hop) ok = ok && cnt > 0;             // empty buckets emit nothing
  } else {
    ok = b < k;
    if (a.wkind == W_BATCH && a.has_agg) ok = ok && b == k - 1;
  }
  // the count is taken before having, as the reference takes it
  if ((a.wkind == W_BATCH || hop) && ok) atomicAdd(a.ocount, 1);
  if (a.has_having) ok = ok && eval_prog(a.code, a.having, ParAt{&a, b}, OutAt{ov}) != 0;
  a.ovalid[b] = ok;
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
    float add = c > 0 ? f32_of(a.incf[l * M + s0 + c - 1]) : 0.0f;
    if (a.grouped && poisoned(a, l, ANY_POS, q)) add = F32_NAN;
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
    float add1 = c > 0 ? f32_of(a.incs1[l * M + s0 + c - 1]) : 0.0f;
    float add2 = c > 0 ? f32_of(a.incs2[l * M + s0 + c - 1]) : 0.0f;
    if (a.grouped && poisoned(a, a.AF + 2 * l, ANY_POS, q)) add1 = F32_NAN;
    if (a.grouped && poisoned(a, a.AF + 2 * l + 1, ANY_POS, q)) add2 = F32_NAN;
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

// The tumbling windows' open remainder: rem_n slots of the axis from start,
// capped at the N newest (the rest counted as drops); the counters and the
// output count (write: by one thread).
__device__ void remainder_split(const QArgs& a, bool write, int* start, int* rem_n) {
  const int N = a.N, w = a.wkind, total = a.misc[2] + a.misc[0];
  int count, n, open = 0;
  if (w == W_LBATCH) {
    const int full = total / N;
    n = total - full * N;
    *start = full * N;
    count = full * N;
  } else {
    if (w == W_DELAY) {
      count = a.misc[MISC_NV];                    // released
      open = total - count;
    } else {
      count = a.misc[MISC_NV];                    // valid slots
      open = total > 0 ? total - a.lo[total - 1] : 0;   // the last segment
    }
    n = open < N ? open : N;
    *start = total - n > 0 ? total - n : 0;
  }
  *rem_n = n;
  if (!write) return;
  *a.rc_out = n;
  *a.ocount = count;
  if (w != W_LBATCH) {
    *a.drops_out = *a.drops_in + (open - n);
    *a.regress_out = *a.regress_in + a.acc[ACC_REG];
  }
}

__global__ void __launch_bounds__(NT_EMIT) q_emit(QArgs a) {
  const int k = a.misc[0], P = a.misc[1];
  const int stride = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = a.N;
  for (int b = g; b < a.O; b += stride) emit_row(a, b, k, P);
  if (sliding(a) || a.wkind == W_HOPPING) {
    // the tails slide by k
    for (int t = g; t < N; t += stride) {
      const int p = k + t;
      for (int l = 0; l < a.AF; ++l) a.f_out[(long long)l * N + t] = zf(a, l, p);
      for (int l = 0; l < a.AI; ++l) a.i_out[(long long)l * N + t] = zi(a, l, p);
      for (int l = 0; l < a.AS; ++l) a.s_out[(long long)l * N + t] = zs(a, l, p);
      a.ones_out[t] = zo(a, p);
      for (int l = 0; l < a.AM; ++l) store_typed(a.m_out[l], a.m_ty[l], t, zm(a, l, p));
      if (a.wkind != W_LENGTH) a.tts_out[t] = zts(a, p);
      if (a.grouped) a.gkey_out[t] = zk(a, p);
      if (a.wkind == W_HOPPING)
        for (int i = 0; i < a.nspec; ++i)
          if (a.spec_kind[i] == S_VALUE)
            store_typed(a.rp_out[i], a.spec_ty[i], t,
                        p < N ? load_typed(a.rp_in[i], a.spec_ty[i], p)
                              : a.bv[(long long)i * a.B + p - N]);
    }
  } else if (remainder_kind(a.wkind)) {
    // the open remainder: rem_n slots of the axis from start (the rest
    // zero, or the min/max identity), and its clock
    int start, rem_n;
    remainder_split(a, g == 0, &start, &rem_n);
    for (int t = g; t < N; t += stride) {
      a.rts_out[t] = t < rem_n ? a.zt[start + t] : 0;
      const bool keep = t < rem_n;
      const int p = start + t;
      for (int l = 0; l < a.AF; ++l) a.f_out[(long long)l * N + t] = keep ? zf(a, l, p) : 0.0f;
      for (int l = 0; l < a.AI; ++l) a.i_out[(long long)l * N + t] = keep ? zi(a, l, p) : 0;
      for (int l = 0; l < a.AS; ++l) a.s_out[(long long)l * N + t] = keep ? zs(a, l, p) : 0.0f;
      if (a.ones_out != nullptr) a.ones_out[t] = keep ? zo(a, p) : 0;
      for (int l = 0; l < a.AM; ++l)
        store_typed(a.m_out[l], a.m_ty[l], t, keep ? zm(a, l, p) : a.m_ident[l]);
      for (int i = 0; i < a.nspec; ++i)
        if (a.spec_kind[i] == S_VALUE)
          store_typed(a.rp_out[i], a.spec_ty[i], t,
                      keep ? load_typed(a.out[i], a.spec_ty[i], p) : 0);
    }
  } else if (a.grouped) {
    for (int q = g; q < a.K; q += stride) update_carried(a, q, k, P);
  } else if (a.wkind == W_NONE && g == 0) {
    update_carried(a, 0, k, P);
  }
}

// ------------------------------------------------------------ host entry

extern "C" int query_step_args_size(void) { return (int)sizeof(QArgs); }
extern "C" int query_step_tile(void) { return TILE; }

// Passes of the pass grid a step runs (QueryPlan.passes mirrors it): the
// lanes' reduce-then-scan takes 2 (3 with a windowed stdDev's centre), the
// tumbling clock's segments 3 (lengthBatch 1), the range bounds 1.
static int pass_count(const QArgs& a) {
  const int w = a.wkind;
  int n = 0;
  if (a.ntask > 0) n = (a.AS > 0 && w != W_NONE) ? 3 : 2;
  if (w == W_TBATCH || w == W_SESSION || w == W_DELAY) n = 3;
  if ((w == W_LBATCH || w == W_TIME || w == W_TIMELENGTH || w == W_HOPPING) && n < 1) n = 1;
  return n;
}

// Launches one step on `stream`; *nlaunch receives the number of kernel
// launches made (the count matrix's memset is not one). Returns
// cudaGetLastError() after each launch (0 on success).
extern "C" int query_step(const QArgs* args, void* stream, int* nlaunch) {
  const QArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  *nlaunch = 0;
#define LAUNCHED()                               \
  do {                                           \
    e = cudaGetLastError();                      \
    if (e != cudaSuccess) return (int)e;         \
    *nlaunch += 1;                               \
  } while (0)
  const int nc = (a.B + TN - 1) / TN;
  q_mask<<<nc, TN, 0, st>>>(a);
  LAUNCHED();
  q_compact<<<nc, TN, 0, st>>>(a);
  LAUNCHED();
  q_prep<<<1, NT, 0, st>>>(a);
  LAUNCHED();
  if (a.grouped) {
    const int g = (a.nrow + TN / 32 - 1) / (TN / 32);
    e = cudaMemsetAsync(a.gmat, 0, (size_t)a.nrow * a.K * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    q_gcount<<<g, TN, 0, st>>>(a);
    LAUNCHED();
    q_gscan<<<1, NT, 0, st>>>(a);
    LAUNCHED();
    q_gplace<<<g, TN, 0, st>>>(a);
    LAUNCHED();
  }
  const int np = pass_count(a);
  const dim3 pgrid(a.ntile, 1 + a.ntask);
  if (np >= 1) {
    q_pass<1><<<pgrid, TN, 0, st>>>(a);
    LAUNCHED();
  }
  if (np >= 2) {
    q_pass<2><<<pgrid, TN, 0, st>>>(a);
    LAUNCHED();
  }
  if (np >= 3) {
    q_pass<3><<<pgrid, TN, 0, st>>>(a);
    LAUNCHED();
  }
  int n = a.O > a.N ? a.O : a.N;
  if (a.K > n) n = a.K;
  int grid = (n + NT_EMIT - 1) / NT_EMIT;
  if (grid > 1024) grid = 1024;
  q_emit<<<grid, NT_EMIT, 0, st>>>(a);
  LAUNCHED();
#undef LAUNCHED
  return 0;
}
