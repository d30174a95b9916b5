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
// int64 timestamp column, having reads the row's outputs as bindings).
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
// Design: three launches per step (two when nothing aggregates).
//   1. q_prep, one CTA: compaction (the output timestamps and value
//      projections go straight to the outputs, the aggregate arguments to
//      batch lanes); bucket ids; the time clamp (a max-scan), regressions,
//      drops and range bounds; for the tumbling windows the axis clock,
//      segment ids and starts, each slot's validity and the carried
//      remainder; for hopping the flush boundaries and their ranges;
//      ownership and collisions; for group-by a stable counting sort of
//      the scan positions by bucket (histogram, exclusive scan, then one
//      warp places positions in order with __match_any_sync), which
//      replaces the reference's [M, K] one-hot grids.
//   2. q_scan, one CTA per aggregate lane: an inclusive scan over the scan
//      positions (segmented by bucket when grouped): float32 lanes in
//      float64 (each prefix rounds to float32 once, as the plain version
//      does), int64 lanes and counts exactly, stdDev lanes as float64
//      (windowed) or float32-rounded (carried) shifted moments, min/max
//      lanes as block-of-32 prefix/suffix reductions plus a sparse table
//      over the blocks (exact range min/max for any [lo, j]).
//   3. q_emit, a grid over max(O, N, K): each output slot reads its range
//      from the scans (binary searches inside its bucket's segment when
//      grouped), materialises every output, evaluates having; the new
//      tails, remainders and per-key tables are written to fresh buffers
//      (the input state is read-only, as in the reference).
//
// What bounds it on the H100: bytes, in principle. A step moves the batch
// columns, the tails it reads and writes, the outputs and the [K] tables:
// about 0.4-4 MB, around a microsecond at 3.35 TB/s. This first version is
// bound instead by its single-CTA phases (the compaction, the counting
// sort's one-warp placement loop, the tumbling windows' axis scans, one CTA
// per scanned lane) and three dependent launches: multi-CTA scans and a
// decoupled look-back compaction are later work.

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

// The tumbling windows (lengthBatch, timeBatch, session, delay): the axis
// clock over M = N + B slots ([remainder r | accepted k | fills]), each
// slot's range and validity, the output timestamps, the carried remainder
// clock and the counters. The batch's value projections already sit at
// [r, r + k) of the outputs.
__device__ void prep_remainder(const QArgs& a, int k, int r, long long* s_buf,
                               int* s_flag) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = a.N, M = a.M, w = a.wkind;
  const int total = r + k;
  const long long ms = a.window_ms;
  for (int p = tid; p < M; p += nt) {
    if (p >= r && p < total) continue;
    for (int i = 0; i < a.nspec; ++i)
      if (a.spec_kind[i] == S_VALUE)
        store_typed(a.out[i], a.spec_ty[i], p,
                    p < r ? load_typed(a.rp_in[i], a.spec_ty[i], p) : 0);
  }
  // the clock: raw (the rows' own timestamps) and monotonised (zt); fills
  // sort after every real event
  auto raw = [&](int p) -> long long {
    if (p < r) return a.rts_in[p];
    if (p < total) return a.bwts[p - r];
    return w == W_LBATCH ? 0 : TS_POS;
  };
  long long regressed = 0;
  if (w == W_LBATCH) {
    for (int p = tid; p < M; p += nt) {
      const long long v = raw(p);
      a.ots[p] = v;
      a.zt[p] = v;
    }
  } else {
    block_seg_scan<long long>(
        M, MaxI64(), raw, [](int) { return false; },
        [&](int p, long long v) {
          const long long x = raw(p);
          a.ots[p] = w == W_DELAY ? wadd(v, ms) : x;
          a.zt[p] = v;
          regressed += (v > x) && p < total;
        },
        s_buf, s_flag);
    regressed = block_sum<long long>(regressed, s_buf);
  }
  __syncthreads();

  int rem_n, start, count;
  long long drops = 0;
  if (w == W_LBATCH) {
    const int full = total / N;
    for (int p = tid; p < M; p += nt) {
      a.lo[p] = (p / N) * N;
      a.hi[p] = p;
      // an aggregated batch collapses to one row, its last slot
      a.oflag[p] = p < full * N && p < total && (!a.has_agg || p % N == N - 1);
    }
    rem_n = total - full * N;
    start = full * N;
    count = full * N;
  } else if (w == W_DELAY) {
    const long long newest = total > 0 ? a.zt[total - 1] : TS_NEG;
    int nrel = 0;
    for (int p = tid; p < M; p += nt) {
      const bool rel = p < total && wadd(a.zt[p], ms) <= newest;
      a.oflag[p] = rel;
      nrel += rel;
    }
    nrel = block_sum<int>(nrel, (int*)s_buf);
    rem_n = total - nrel < N ? total - nrel : N;
    drops = total - nrel - rem_n;
    start = total - rem_n > 0 ? total - rem_n : 0;
    count = nrel;
  } else {                                       // timeBatch, session
    long long base = 0;
    if (w == W_TBATCH) {
      base = *a.base_in > TS_NEG ? *a.base_in : a.zt[0];
      for (int p = tid; p < M; p += nt) a.zseg[p] = floor_div(a.zt[p] - base, ms);
    } else {
      // a gap of exactly the parameter closes the session
      block_seg_scan<long long>(
          M, AddOp(),
          [&](int p) { return (long long)(p > 0 && a.zt[p] - a.zt[p - 1] >= ms); },
          [](int) { return false; }, [&](int p, long long v) { a.zseg[p] = v; },
          s_buf, s_flag);
    }
    __syncthreads();
    const int last = total - 1 < 0 ? 0 : (total - 1 < M ? total - 1 : M - 1);
    const long long seg_last = a.zseg[last];
    int open = 0, nvalid = 0;
    for (int p = tid; p < M; p += nt) {
      bool ok;
      if (w == W_TBATCH) {
        // closed buckets emit; aggregated, one row per bucket (its last)
        ok = p < total && a.zseg[p] < seg_last;
        if (ok && a.has_agg)
          ok = p + 1 >= total || a.zseg[p + 1 < M ? p + 1 : M - 1] != a.zseg[p];
      } else {
        ok = p >= r && p < total;                // currents pass once
      }
      a.oflag[p] = ok;
      a.hi[p] = p;
      nvalid += ok;
      open += p < total && a.zseg[p] == seg_last;
    }
    // a slot's range starts at its segment's head: a max-scan of heads
    block_seg_scan<long long>(
        M, MaxI64(),
        [&](int p) { return (long long)((p == 0 || a.zseg[p] != a.zseg[p - 1]) ? p : 0); },
        [](int) { return false; }, [&](int p, long long v) { a.lo[p] = (int)v; },
        s_buf, s_flag);
    open = block_sum<int>(open, (int*)s_buf);
    count = block_sum<int>(nvalid, (int*)s_buf);
    rem_n = open < N ? open : N;
    drops = open - rem_n;
    start = total - rem_n > 0 ? total - rem_n : 0;
    if (tid == 0 && w == W_TBATCH) *a.base_out = total > 0 ? base : *a.base_in;
  }
  __syncthreads();
  // the carried remainder's clock (monotonised, raw for lengthBatch)
  for (int t = tid; t < N; t += nt) a.rts_out[t] = t < rem_n ? a.zt[start + t] : 0;
  if (tid == 0) {
    *a.rc_out = rem_n;
    a.misc[1] = M;
    a.misc[3] = start;
    a.misc[4] = rem_n;
    *a.ocount = count;
    if (w != W_LBATCH) {
      *a.drops_out = *a.drops_in + drops;
      *a.regress_out = *a.regress_in + regressed;
    }
  }
}

// hopping(D, H): the step's flush boundaries t_f = b0 + f * H (f < B) and
// their buckets (t_f - D, t_f) on the axis [tail (N) | batch]; bwts holds
// the clamped batch clock. Boundaries past B fire on the next step.
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
  for (int f = tid; f < B; f += nt) {
    const long long t = wadd(b0, wmul(f, H));
    const int l = upper_bound_zts(a, wadd(t, -D));
    int h = lower_bound_zts(a, t) - 1;
    if (h < l - 1) h = l - 1;                  // empty bucket: zero range
    a.ots[f] = t;
    a.lo[f] = l;
    a.hi[f] = h;
    a.oflag[f] = f < nf;
  }
  const long long live_cut = nf > 0 ? wadd(wadd(b0, wmul(nf - 1, H)), -D) : TS_NEG;
  long long drops = 0;                         // live slots pushed out
  for (int p = tid; p < k; p += nt)
    if (zts(a, p) > live_cut) drops += zo(a, p);
  drops = block_sum<long long>(drops, s_buf);
  if (tid == 0) {
    *a.base_out = nf > 0 ? wadd(b0, wmul(nf, H)) : (any ? b0 : TS_NEG);
    *a.drops_out = *a.drops_in + drops;
    a.misc[1] = a.N + B;
  }
}

__global__ void __launch_bounds__(NT) q_prep(QArgs a) {
  __shared__ int s_scan[NT / 32 + 1];
  __shared__ long long s_buf[33];
  __shared__ int s_flag[33];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int B = a.B, N = a.N, K = a.K;
  const bool rem = remainder_kind(a.wkind), hop = a.wkind == W_HOPPING;
  const int r0 = rem ? *a.rc_in : 0;
  const int k = compact_batch(a, r0, s_scan);
  if (a.grouped)
    for (int s = tid; s < B; s += nt) a.bkey[s] = bucket_of(a, a.bpacked[s]);
  if (tid == 0) {
    a.misc[0] = k;
    a.misc[2] = r0;
    *a.ocount = (a.wkind == W_BATCH || hop) ? 0 : k;
  }
  if (rem) {
    prep_remainder(a, k, r0, s_buf, s_flag);
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

// The reference's unwindowed grouped sums and stdDev moments are one-hot
// products, onehot[m, key] * x[m]: a non-finite x[m] makes 0 * x[m] = NaN
// in every other key's column from position m on (and in its own too where
// the row is masked off, key -1). (Its windowed grouped sums are not: XLA
// folds their float one-hot product into a select.)
// For one lane over positions [0, X) this keeps, in pz[0..2], the first
// non-finite position m0, its key k0, and the first non-finite position m1
// of another key (INT_MAX when none): an output at position j of key kb is
// NaN iff (m0 <= j and k0 != kb) or m1 <= j (poisoned()).
__device__ __forceinline__ bool finite32(float f) {
  return (__float_as_uint(f) & 0x7f800000u) != 0x7f800000u;
}

template <class Get, class Key>
__device__ void find_poison(int X, Get get, Key key, int* pz, long long* s_buf) {
  long long m0 = 0x7fffffff;
  for (int p = threadIdx.x; p < X; p += blockDim.x)
    if (!finite32(get(p))) { m0 = p; break; }
  m0 = block_reduce<long long>(m0, MinI64(), s_buf);
  const int k0 = m0 < X ? key((int)m0) : -1;
  long long m1 = 0x7fffffff;
  for (int p = threadIdx.x; p < X; p += blockDim.x)
    if (!finite32(get(p)) && key(p) != k0) { m1 = p; break; }
  m1 = block_reduce<long long>(m1, MinI64(), s_buf);
  if (threadIdx.x == 0) { pz[0] = (int)m0; pz[1] = k0; pz[2] = (int)m1; }
}

__device__ __forceinline__ bool poisoned(const QArgs& a, int pl, int j, int key) {
  const int* z = a.pz + 3 * pl;
  return (z[0] <= j && z[1] != key) || z[2] <= j;
}
#define ANY_POS 0x7ffffffe            // poisoned() at any position
#define F32_NAN __int_as_float(0x7fc00000)
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
    if (grp && a.wkind == W_NONE)
      find_poison(P, [&](int p) { return zf(a, l, p); },
                  [&](int p) { return zk(a, p); }, a.pz + 3 * l, s_buf);
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
    if (a.wkind != W_NONE) {
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
      if (grp) {
        // the reference's deviations over all B rows: (x - c) * 0 for the
        // masked-off ones, whose one-hot row is empty (key -1)
        const int k = a.misc[0];
        auto d_at = [&](int p) {
          const float c = a.ckey[(long long)l * a.K + a.bkey[p]];
          return __fmul_rn(__fsub_rn(a.bs[(long long)l * a.B + p], c), (float)a.bones[p]);
        };
        auto key = [&](int p) { return p < k ? a.bkey[p] : -1; };
        find_poison(a.B, d_at, key, a.pz + 3 * (a.AF + 2 * l), s_buf);
        find_poison(a.B, [&](int p) { const float d = d_at(p); return __fmul_rn(d, d); },
                    key, a.pz + 3 * (a.AF + 2 * l + 1), s_buf);
      }
    }
    return;
  }
  t -= a.AS;
  if (t < a.AM) {
    const int l = t;
    const RedOp op{a.m_ty[l], a.m_min[l]};
    long long* Pm = a.mP + (long long)l * M;
    if (a.wkind == W_NONE) {
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
  if (a.has_having) ok = ok && eval_prog(a.code, a.having, NoBindQ{}, OutAt{ov}) != 0;
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
    // zero, or the min/max identity)
    const int start = a.misc[3], rem_n = a.misc[4];
    for (int t = g; t < N; t += stride) {
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
  int n = a.O > a.N ? a.O : a.N;
  if (a.K > n) n = a.K;
  int grid = (n + NT_EMIT - 1) / NT_EMIT;
  if (grid > 1024) grid = 1024;
  q_emit<<<grid, NT_EMIT, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  return 0;
}
