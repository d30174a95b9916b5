// Scan-walked query windows for Hopper (sm_90a): sort, frequent and
// lossyFrequent.
//
// Replaces, from the reference JAX package, the scan-walked half of B5b in
// tpu/query_compile.py: CompiledStreamQuery._make_step's sort and heavy-
// hitter branches and their lax.scan bodies _sort_window (a top-N buffer
// kept sorted, walked per event) and _heavy_hitters (a Misra-Gries or
// lossy-counting key/counter table, walked per event), with the filter,
// compaction and argument programs of query_common.cuh.
//
// What it computes, per step over a batch of B events, in the events'
// order (each event's result depends on the table its predecessors left):
//   - sort: each event emits the aggregates over the buffer's n occupied
//     slots plus itself (float32 sums accumulated in float64 and rounded
//     once; int64 sums; min/max; count n + 1; a float32 stdDev centred at
//     the float32 mean, as the reference computes it), then, if accepted,
//     inserts at min(upper_bound(keys, key), n) and slot N - 1 falls off;
//   - frequent: the first occupied slot holding the key counts up, else
//     the first free slot takes it, else every count drops by one and the
//     slots reaching zero are evicted (their last values retracted from the
//     running sums) and the arrival takes the first of them; a row is
//     emitted with the running sums after its own add;
//   - lossyFrequent: as frequent without the decrement; a miss on a full
//     table is dropped (counted); an entry emits when f + delta >= total *
//     support (float64), and after the emission every entry with f + delta
//     <= bucket - 1 is pruned, its post-update values retracted.
// Unaccepted slots past the accepted count see the table unchanged and
// repeat the outputs of the first of them.
//
// Design: one launch per step, one CTA of NTW threads; the loop over the
// batch's events runs inside the kernel, since each event reads the table
// its predecessor left. The state's input buffers are read once and left
// as they were; the step writes fresh output buffers.
//   - sort: per event the block makes one pass over the N buffer slots in
//     device memory with block-wide reductions, and shifts the tail up for
//     the insert.
//   - frequent / lossyFrequent: the table (keys, counts, deltas) lives in
//     dynamic shared memory for the step (C = 4096 lossy: 96 KB), with a
//     key -> slot index (open addressing over 2 C or more positions, built
//     in parallel, the lowest slot of a key winning as the reference's
//     argmax does) and a free-slot bitmap with a cursor at the lowest free
//     slot; a table too large for shared memory stays in device memory
//     (the output buffers and the wrapper's scratch), same code. Warp 0
//     walks the events alone: a lookup is a few probes under one ballot,
//     an insert takes the cursor and a ballot over the bitmap finds the
//     next free slot, and only the touched slot's value lanes are written.
//     The block joins it, behind a barrier, only for passes over every
//     slot: the index build, the lossy prune where the bucket number
//     floor(total * error) + 1 changes (after a prune at bucket b every
//     entry has f + delta >= b, and neither a hit nor an insert can lower
//     that, so between changes no entry qualifies; the step's first event
//     and the touched slot are still checked), and frequent's decrement-
//     all. A pass's retractions are summed in f64 across the block in a
//     fixed order, rounded once and subtracted, as before.
//
// What bounds it on the H100: the serial dependence from event to event.
// Its work is one key lookup and one row per event, plus one visit of each
// slot per bucket change or decrement-all, and the bytes of the batch and
// the table (a few hundred KB a step): microseconds at the card's rates.
// The walk costs a lookup's latency in shared memory per event, the rest
// of the card idles; the sort walk still spends a few block barriers per
// event.

#include "query_common.cuh"

#define NTW 512

// x <= y for value slots of type ty (a sort key comparison)
// A key slot in XLA's total order (the reference's searchsorted): for f32,
// -0 equals +0 and every NaN sorts after +inf; integers as they are.
__device__ __forceinline__ long long total_key(int ty, long long v) {
  if (ty != T_F32) return v;
  unsigned u = (unsigned)(unsigned long long)v;
  const float f = __int_as_float((int)u);
  if (f == 0.0f) u = 0u;
  else if (f != f) u = 0x7fc00000u;
  const int i = (int)u;
  return (long long)(i < 0 ? i ^ 0x7fffffff : i);
}

// Materialises row b's outputs from its aggregates; returns its validity
// after having (``ok`` is the validity before it). Not inlined: it carries
// the having program's interpreter, and the walks stay small.
__device__ __noinline__ bool put_row(const QArgs& a, int b, long long cnt, const float* sf,
                        const long long* si, const long long* sm, const float* sd,
                        bool ok) {
  long long ov[QMAXSPEC];
  for (int i = 0; i < a.nspec; ++i) {
    const int kind = a.spec_kind[i], l = a.spec_lane[i];
    long long v;
    if (kind == S_VALUE) {           // read back only for having
      ov[i] = a.has_having ? load_typed(a.out[i], a.spec_ty[i], b) : 0;
      continue;
    }
    if (kind == S_COUNT) {
      v = cnt;
    } else if (kind == S_SUM || kind == S_AVG) {
      const float fnum = a.spec_int[i] ? __ll2float_rn(si[l]) : sf[l];
      if (kind == S_SUM) v = a.spec_int[i] ? si[l] : from_f(fnum);
      else v = from_f(__fdiv_rn(fnum, __ll2float_rn(cnt > 1 ? cnt : 1)));
    } else if (kind == S_MIN || kind == S_MAX) {
      v = sm[l];
    } else {
      v = from_f(sd[l]);
    }
    store_typed(a.out[i], a.spec_ty[i], b, v);
    ov[i] = v;
  }
  if (a.has_having) ok = ok && eval_prog(a.code, a.having, ParAt{&a, b}, OutAt{ov}) != 0;
  a.ovalid[b] = ok;
  return ok;
}

// Rows past the first unaccepted slot `from` repeat its outputs.
__device__ void repeat_rows(const QArgs& a, int from) {
  for (int b = from + 1 + threadIdx.x; b < a.B; b += blockDim.x) {
    for (int i = 0; i < a.nspec; ++i)
      if (a.spec_kind[i] != S_VALUE)
        store_typed(a.out[i], a.spec_ty[i], b, load_typed(a.out[i], a.spec_ty[i], from));
    a.ovalid[b] = a.ovalid[from];
  }
}

// row[off + i] = row[off + i - 1] for pos < i < N, in place: chunks of the
// block's width from the top down, each read before any write lands.
__device__ void shift_up(void* row, int ty, long long off, int pos, int N) {
  for (int c0 = N - 1; c0 > pos; c0 -= blockDim.x) {
    const int i = c0 - (int)threadIdx.x;
    const bool in = i > pos;
    const long long v = in ? load_typed(row, ty, off + i - 1) : 0;
    __syncthreads();
    if (in) store_typed(row, ty, off + i, v);
    __syncthreads();
  }
}

// ------------------------------------------------------------------ sort

__device__ void walk_sort(const QArgs& a, int k, double* s_d, long long* s_l) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = a.N, B = a.B, kty = a.sort_kty;
  for (int i = tid; i < N; i += nt) {
    store_typed(a.skeys_out, kty, i, load_typed(a.skeys_in, kty, i));
    for (int l = 0; l < a.AF; ++l) a.f_out[(long long)l * N + i] = a.f_in[(long long)l * N + i];
    for (int l = 0; l < a.AI; ++l) a.i_out[(long long)l * N + i] = a.i_in[(long long)l * N + i];
    for (int l = 0; l < a.AS; ++l) a.s_out[(long long)l * N + i] = a.s_in[(long long)l * N + i];
    for (int l = 0; l < a.AM; ++l)
      store_typed(a.m_out[l], a.m_ty[l], i, load_typed(a.m_in[l], a.m_ty[l], i));
  }
  __syncthreads();
  int n = *a.rc_in;
  float sf[QMAXLANE], sd[QMAXLANE];
  long long si[QMAXLANE], sm[QMAXLANE];
  const int last = k < B ? k : B - 1;
  for (int b = 0; b <= last; ++b) {
    // outputs first: the buffer's n slots plus the arriving event
    for (int l = 0; l < a.AF; ++l) {
      double part = 0.0;
      for (int i = tid; i < n; i += nt) part += (double)a.f_out[(long long)l * N + i];
      sf[l] = f32_of(block_sum<double>(part, s_d) + (double)a.bf[(long long)l * B + b]);
    }
    for (int l = 0; l < a.AI; ++l) {
      long long part = 0;
      for (int i = tid; i < n; i += nt) part += a.i_out[(long long)l * N + i];
      si[l] = block_sum<long long>(part, s_l) + a.bi[(long long)l * B + b];
    }
    for (int l = 0; l < a.AM; ++l) {
      const RedOp op{a.m_ty[l], a.m_min[l]};
      long long part = a.m_ident[l];
      for (int i = tid; i < n; i += nt) part = op(part, load_typed(a.m_out[l], a.m_ty[l], i));
      sm[l] = op(block_reduce<long long>(part, op, s_l), a.bm[(long long)l * B + b]);
    }
    const long long cnt = n + 1;
    const float nf = __ll2float_rn(cnt);
    for (int l = 0; l < a.AS; ++l) {
      const float* v = a.s_out + (long long)l * N;
      const float x = a.bs[(long long)l * B + b];
      double part = 0.0;
      for (int i = tid; i < n; i += nt) part += (double)v[i];
      const float c = __fdiv_rn(f32_of(block_sum<double>(part, s_d) + (double)x), nf);
      double p1 = 0.0, p2 = 0.0;
      for (int i = tid; i < n; i += nt) {
        const float d = __fsub_rn(v[i], c);
        p1 += (double)d;
        p2 += (double)__fmul_rn(d, d);
      }
      const double t1 = block_sum<double>(p1, s_d), t2 = block_sum<double>(p2, s_d);
      const float dx = __fsub_rn(x, c);
      const float s1 = __fdiv_rn(f32_of(t1 + (double)dx), nf);
      const float s2 = __fdiv_rn(f32_of(t2 + (double)__fmul_rn(dx, dx)), nf);
      float var = __fsub_rn(s2, __fmul_rn(s1, s1));
      if (var < 0.0f) var = 0.0f;
      sd[l] = __fsqrt_rn(var);
    }
    if (tid == 0) put_row(a, b, cnt, sf, si, sm, sd, b < k);
    if (b >= k) break;
    // then the insert, stable after equal keys, clamped to the occupied
    // prefix (a key equal to the empty sentinel stays in a non-full buffer;
    // in a full one, pos == N evicts the arrival itself)
    // jnp.searchsorted(side="right") as the reference runs it: bit_length(N)
    // halvings of [0, N) in total order, left where the key sorts strictly
    // before the probed slot (NaN keys leave the buffer out of order, and
    // the search lands where that search lands)
    const long long key = a.bkeyv[b];
    const long long tk = total_key(kty, key);
    int lo = 0, hi = N;
    for (int lv = 32 - __clz(N); lv > 0; --lv) {
      const int mid = (lo + hi) >> 1;
      if (tk < total_key(kty, load_typed(a.skeys_out, kty, mid))) hi = mid; else lo = mid;
    }
    const int pos = hi < n ? hi : n;
    if (pos < N) {
      shift_up(a.skeys_out, kty, 0, pos, N);
      for (int l = 0; l < a.AF; ++l) shift_up(a.f_out, T_F32, (long long)l * N, pos, N);
      for (int l = 0; l < a.AI; ++l) shift_up(a.i_out, T_I64, (long long)l * N, pos, N);
      for (int l = 0; l < a.AS; ++l) shift_up(a.s_out, T_F32, (long long)l * N, pos, N);
      for (int l = 0; l < a.AM; ++l) shift_up(a.m_out[l], a.m_ty[l], 0, pos, N);
      if (tid == 0) {
        store_typed(a.skeys_out, kty, pos, key);
        for (int l = 0; l < a.AF; ++l) a.f_out[(long long)l * N + pos] = a.bf[(long long)l * B + b];
        for (int l = 0; l < a.AI; ++l) a.i_out[(long long)l * N + pos] = a.bi[(long long)l * B + b];
        for (int l = 0; l < a.AS; ++l) a.s_out[(long long)l * N + pos] = a.bs[(long long)l * B + b];
        for (int l = 0; l < a.AM; ++l)
          store_typed(a.m_out[l], a.m_ty[l], pos, a.bm[(long long)l * B + b]);
      }
    }
    n = n + 1 < N ? n + 1 : N;
    __syncthreads();
  }
  __syncthreads();
  if (k < B) repeat_rows(a, k);
  if (tid == 0) *a.rc_out = n;
}
// ---------------------------------------------------------- heavy hitters

// (first, second) packed as two non-negative 32-bit fields
__device__ __forceinline__ long long pack2(int hi, int lo) {
  return ((long long)hi << 32) | (unsigned)lo;
}
struct MinSum {   // min of the high field, sum of the low field
  __device__ long long operator()(long long x, long long y) const {
    const int h = (int)(x >> 32) < (int)(y >> 32) ? (int)(x >> 32) : (int)(y >> 32);
    return pack2(h, (int)(unsigned)x + (int)(unsigned)y);
  }
};

// The table the walk updates: per slot its key, count and (lossy) delta; a
// key -> slot index (open addressing, linear probing, H a power of two >=
// 2 C, -1 where empty) and one bit per free slot. In shared memory, or in
// device memory where it does not fit (the state's output buffers and the
// wrapper's scratch).
struct HTab {
  long long* key;
  long long* cnt;
  long long* del;
  int* idx;
  unsigned* fw;
  int C, H, nw;
};

// SH: the table in shared memory (the pointers derive from the dynamic
// shared array, so the compiler addresses it as shared memory).
template <bool SH>
__device__ __forceinline__ HTab hh_table(const QArgs& a) {
  HTab t;
  t.C = a.N;
  t.H = a.hh_H;
  t.nw = (a.N + 31) >> 5;
  if (SH) {
    extern __shared__ __align__(16) unsigned char s_dyn[];
    long long* p = (long long*)s_dyn;
    const bool lossy = a.wkind == W_LOSSY;
    t.key = p;
    t.cnt = p + t.C;
    t.del = lossy ? p + 2 * (long long)t.C : nullptr;
    t.idx = (int*)(p + (lossy ? 3 : 2) * (long long)t.C);
    t.fw = (unsigned*)(t.idx + t.H);
  } else {
    t.key = a.hkeys_out;
    t.cnt = a.hcnt_out;
    t.del = a.hdelta_out;
    t.idx = a.hidx;
    t.fw = a.hfree;
  }
  return t;
}

// Every 64 bits of the key code take part (two-key codes are pack2'd).
__device__ __forceinline__ unsigned hh_hash(long long k) {
  return (unsigned)avalanche64((unsigned long long)k);
}

// Rebuilds the index over the occupied slots (count > 0) and the free bits
// over the others; a key held by two slots is indexed at the lower one, the
// one the reference's argmax over hits picks. Returns whether some key is
// held twice (a restored state may hold one; the walk never makes one).
// Every thread of the block calls it.
__device__ __forceinline__ bool hh_index(const HTab& t, int* s_flag) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const unsigned mask = (unsigned)t.H - 1u;
  for (int p = tid; p < t.H; p += nt) t.idx[p] = -1;
  for (int w = tid; w < t.nw; w += nt) t.fw[w] = 0u;
  if (tid == 0) *s_flag = 0;
  __syncthreads();
  for (int s = tid; s < t.C; s += nt) {
    if (t.cnt[s] <= 0) {
      atomicOr(&t.fw[s >> 5], 1u << (s & 31));
      continue;
    }
    const long long k = t.key[s];
    for (unsigned p = hh_hash(k) & mask;; p = (p + 1) & mask) {
      const int e = atomicCAS(&t.idx[p], -1, s);
      if (e < 0) break;
      if (t.key[e] == k) {
        atomicMin(&t.idx[p], s);
        *s_flag = 1;
        break;
      }
    }
  }
  __syncthreads();
  return *s_flag != 0;
}

// The walking warp's table operations. Each lane resolves its own event of
// the chunk (NL events staged at a time, lane j holding event b0 + j).

// The slot holding key k (hash h), or -1: linear probing from h.
__device__ __forceinline__ int hh_find(const HTab& t, long long k, unsigned h) {
  const unsigned mask = (unsigned)t.H - 1u;
  for (unsigned p = h & mask;; p = (p + 1) & mask) {
    const int e = t.idx[p];
    if (e < 0) return -1;
    if (t.key[e] == k) return e;
  }
}

// Enters slot s under a key of hash h, absent from the index (lanes may
// enter at once).
__device__ __forceinline__ void hh_enter(const HTab& t, unsigned h, int s) {
  const unsigned mask = (unsigned)t.H - 1u;
  for (unsigned p = h & mask;; p = (p + 1) & mask)
    if (atomicCAS(&t.idx[p], -1, s) < 0) return;
}

// The lowest free slots at or after `from`, up to NL of them, into
// s_free[0..n) in order; returns n. Every lane of the warp calls it.
__device__ int hh_free_list(const HTab& t, int from, int* s_free, int lane, int NL) {
  int got = 0;
  for (int w0 = from >> 5; w0 < t.nw && got < NL; w0 += NL) {
    const int w = w0 + lane;
    unsigned bits = lane < NL && w < t.nw ? t.fw[w] : 0u;
    if (w == (from >> 5)) bits &= ~0u << (from & 31);
    const int c = __popc(bits);
    int x = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += y;
    }
    for (int at = got + x - c; bits && at < NL; ++at) {
      s_free[at] = (w << 5) + __ffs(bits) - 1;
      bits &= bits - 1u;
    }
    got += __shfl_sync(FULL, x, NL - 1);
  }
  __syncwarp();
  return got < NL ? got : NL;
}

enum { P_NONE = 0, P_DONE, P_PRUNE, P_DEC };

// One chunk of NL events as warp 0 resolved it, lane j for event b0 + j:
// the key code, the slot its lookup found (-1: absent), the latest earlier
// lane with the same key (-1: none), the slot the walk gave it (-1: none)
// and whether that was a free slot still to enter the index; the free
// slots listed for the chunk's inserts.
struct HhChunk {
  long long key[32];
  int r[32], p[32], slot[32], free[32];
  unsigned char ins[32];
  // each event's row: the running sums, count and emission after its add
  float rowf[QMAXLANE][32];
  long long rowi[QMAXLANE][32];
  long long rowc[32];
  unsigned char rowe[32];
};

// frequent and lossyFrequent. Warp 0 prepares each chunk of NL events
// (lane j for event b0 + j): its key codes and hashes, every lane's slot
// as the index gives it at the chunk's start (all lanes probing at once),
// a link from each event to the latest earlier event of the chunk with the
// same key (a match over the lanes), and a list of the lowest free slots.
// Lane 0 then walks the chunk's events alone: within a chunk the table
// changes only by the chunk's own inserts, taken from the list in order and
// entered into the index and the free bits when the chunk ends, so an
// event's slot is its lookup's, else its linked event's, else the next
// listed one, read from shared memory, with no warp-wide step per event.
// Lane 0 writes nothing to device memory either (a store there costs the
// walk about a hundred cycles): the events' rows and the values each event
// leaves in its slot wait in shared memory, and the warp writes them out,
// coalesced, when the chunk ends (the values also before a pass, which
// reads them; of two events of a chunk in one slot, the later's).
// The block joins for a pass over every slot (the index build, a lossy
// prune where the bucket changed, a decrement-all), announced through
// s_cmd / s_beta; after a pass the rest of the chunk is prepared again.
// The walk records each event's running sums, count and emission (scratch
// incf / inci / inco / oflag); the block materialises the rows from them
// after the walk.
template <bool SH>
__device__ __forceinline__ void walk_hh(const QArgs& a, int k, double* s_d,
                                        long long* s_l, int* s_cmd, long long* s_beta,
                                        int* s_flag, float* s_vf, long long* s_vi,
                                        HhChunk* ch, float* s_rf, long long* s_ri,
                                        float* s_tf, long long* s_ti) {
  const HTab t = hh_table<SH>(a);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NL = nt < 32 ? nt : 32, lane = tid & 31;
  const bool walker = tid < NL;
  const int C = a.N, B = a.B;
  const bool lossy = a.wkind == W_LOSSY;
  for (int s = tid; s < C; s += nt) {
    t.key[s] = a.hkeys_in[s];
    t.cnt[s] = a.hcnt_in[s];
    if (lossy) t.del[s] = a.hdelta_in[s];
    for (int l = 0; l < a.AF; ++l) a.f_out[(long long)l * C + s] = a.f_in[(long long)l * C + s];
    for (int l = 0; l < a.AI; ++l) a.i_out[(long long)l * C + s] = a.i_in[(long long)l * C + s];
  }
  if (tid < 32) ch->ins[tid] = 0;
  __syncthreads();
  bool dup = hh_index(t, s_flag);
  // the running sums: lane 0's, in shared memory; the counters: lane 0's
  if (tid == 0) {
    for (int l = 0; l < a.AF; ++l) s_rf[l] = a.runf_in[l];
    for (int l = 0; l < a.AI; ++l) s_ri[l] = a.runi_in[l];
  }
  long long rcnt = *a.runc_in;
  long long total = lossy ? *a.htot_in : 0, drops = lossy ? *a.drops_in : 0;
  long long bucket = 0, prev = 0;
  long long kreg = 0;                   // lane j: event b0 + j's key code
  unsigned hreg = 0;                    // and its hash
  // the chunk's free list (none yet), how much of it lane 0 took, the
  // lowest slot that may be free
  int nfree = -1, taken = 0, from = 0;
  int emitted = 0, b = 0, b0 = 0, nev = 0, fe = C;
  int vlo = 0;                          // the chunk's events from here on have
                                        // slot values still to write out
  bool first = true, resume = false;
  const int last = k < B ? k : B - 1;

  auto vf = [&](int l) { return s_vf[l * 32 + (b - b0)]; };
  auto vi = [&](int l) { return s_vi[l * 32 + (b - b0)]; };
  // (warp) the chunk's inserts enter the index and leave the free bits
  auto flush = [&]() {
    if (lane < NL && ch->ins[lane]) {
      const int s = ch->slot[lane];
      hh_enter(t, hreg, s);
      atomicAnd(&t.fw[s >> 5], ~(1u << (s & 31)));
      ch->ins[lane] = 0;
    }
    __syncwarp();
  };
  // (warp) the events of lanes after `after`: lookups, links, free list
  auto resolve = [&](int after) {
    const bool mine = lane > after && lane < NL && b0 + lane < k;
    const int r = mine ? hh_find(t, kreg, hreg) : -1;
    const unsigned live = __ballot_sync(FULL, mine);
    const unsigned same = __match_any_sync(FULL, kreg) & live & ((1u << lane) - 1u);
    if (lane > after && lane < NL) {
      ch->r[lane] = r;
      ch->p[lane] = same ? 31 - __clz((int)same) : -1;
      ch->slot[lane] = -1;
    }
    nfree = hh_free_list(t, from, ch->free, lane, NL);
    taken = 0;
  };
  // (warp) the slot values of the chunk's events vlo .. upto, the latest
  // of each slot
  auto flush_vals = [&](int upto) {
    const bool in = lane >= vlo && lane <= upto && lane < NL;
    const int s = in ? ch->slot[lane] : -1;
    const unsigned same = __match_any_sync(FULL, s);
    if (s >= 0 && (same >> lane) == 1u) {
      for (int l = 0; l < a.AF; ++l) a.f_out[(long long)l * C + s] = s_vf[l * 32 + lane];
      for (int l = 0; l < a.AI; ++l) a.i_out[(long long)l * C + s] = s_vi[l * 32 + lane];
    }
    vlo = upto + 1;
  };
  // (warp) the chunk's rows, its first n events'
  auto flush_rows = [&](int n) {
    if (lane < n) {
      const int r = b0 + lane;
      for (int l = 0; l < a.AF; ++l) a.incf[(long long)l * B + r] = ch->rowf[l][lane];
      for (int l = 0; l < a.AI; ++l) a.inci[(long long)l * B + r] = ch->rowi[l][lane];
      a.inco[r] = ch->rowc[lane];
      a.oflag[r] = ch->rowe[lane];
    }
  };
  // (warp) the chunk ending at event b - 1 is written out
  auto close_chunk = [&]() {
    flush_vals(b - 1 - b0);
    flush_rows(b - b0);
  };
  // (warp) the next chunk, from event b
  auto stage = [&]() {
    if (b > 0) close_chunk();
    flush();
    if (taken < nfree) from = ch->free[taken];
    else if (nfree == NL) from = ch->free[NL - 1] + 1;
    else if (nfree >= 0) from = C;
    __syncwarp();
    b0 = b;
    vlo = 0;
    const int j = b + lane;
    const bool in = lane < NL && j < B;
    kreg = in ? __ldcg(a.bpacked + j) : 0;
    hreg = hh_hash(kreg);
    if (lane < NL) ch->key[lane] = kreg;
    for (int l = 0; l < a.AF; ++l)
      s_vf[l * 32 + lane] = in ? __ldcg(a.bf + (long long)l * B + j) : 0.0f;
    for (int l = 0; l < a.AI; ++l)
      s_vi[l * 32 + lane] = in ? __ldcg(a.bi + (long long)l * B + j) : 0;
    __syncwarp();
    resolve(-1);
  };
  // (lane 0, below) the arrival's add (emit: it counts in the sums),
  // recorded for its row
  auto add_row = [&](bool emit) {
    const int j = b - b0;
    rcnt += emit;
    emitted += emit;
#pragma unroll 1
    for (int l = 0; l < a.AF; ++l) {
      const float v = __fadd_rn(s_rf[l], emit ? vf(l) : 0.0f);
      s_rf[l] = v;
      ch->rowf[l][j] = v;
    }
#pragma unroll 1
    for (int l = 0; l < a.AI; ++l) {
      const long long v = s_ri[l] + (emit ? vi(l) : 0);
      s_ri[l] = v;
      ch->rowi[l][j] = v;
    }
    ch->rowc[j] = rcnt;
    ch->rowe[j] = emit;
  };
  // a pass's evicted values leave the sums
  auto retract = [&]() {
    for (int l = 0; l < a.AF; ++l) s_rf[l] = __fsub_rn(s_rf[l], s_tf[l]);
    for (int l = 0; l < a.AI; ++l) s_ri[l] -= s_ti[l];
    rcnt -= nev;
  };
  // the arrival takes slot idx (count c, delta d; ins: a free slot); its
  // values follow when the chunk's slot values are written out
  auto put_slot = [&](int idx, long long c, long long d, bool ins) {
    const int j = b - b0;
    t.cnt[idx] = c;
    if (lossy) t.del[idx] = d;
    t.key[idx] = ch->key[j];
    ch->slot[j] = idx;
    ch->ins[j] = ins;
    taken += ins;
  };
  // a hit on a key a restored state holds twice: the other slots count up
  auto count_dups = [&](int idx) {
    const long long key = t.key[idx];
    for (int s = 0; s < C; ++s)
      if (s != idx && t.cnt[s] > 0 && t.key[s] == key) t.cnt[s] += 1;
  };

  for (;;) {
    int cmd = P_NONE;
    if (walker) {
      if (resume) {                       // the event a pass interrupted
        if (lane == 0) {
          if (nev > 0) retract();
          if (!lossy) {                   // the arrival takes the first evicted
            if (nev > 0) put_slot(fe, 1, 0, true);
            add_row(nev > 0);
          }
        }
        __syncwarp();
        from = 0;
        flush();
        resolve(b - b0);
        resume = false;
        ++b;
      }
      while (cmd == P_NONE) {
        if (b > last) {
          cmd = P_DONE;
          break;
        }
        if (b == 0 || b == b0 + NL) stage();
        __syncwarp();
        if (lane == 0) {
          for (; b <= last && b < b0 + NL; ++b) {
            if (b >= k) {                 // the first unaccepted slot
              add_row(false);
              continue;
            }
            const int j = b - b0;
            const int r = ch->r[j], pv = ch->p[j];
            const int hit = r >= 0 ? r : (pv >= 0 ? ch->slot[pv] : -1);
            const bool has = hit >= 0, space = taken < nfree;
            if (!lossy) {
              if (!has && !space) {       // decrement-all, in a pass
                cmd = P_DEC;
                break;
              }
              const int idx = has ? hit : ch->free[taken];
              put_slot(idx, has ? t.cnt[idx] + 1 : 1, 0, !has);
              if (has && dup) count_dups(idx);
              add_row(true);
              continue;
            }
            total += 1;
            bucket = (long long)((double)total * a.hh_error) + 1;
            bool emit = false, low = false;
            if (has || space) {
              const int idx = has ? hit : ch->free[taken];
              const long long c = has ? t.cnt[idx] + 1 : 1;
              const long long d = has ? t.del[idx] : bucket - 1;
              emit = (double)(c + d) >= (double)total * a.hh_support;
              low = c + d <= bucket - 1;
              put_slot(idx, c, d, !has);
              if (has && dup) count_dups(idx);
            } else {
              drops += 1;
            }
            add_row(emit);
            // the prune, every entry with f + delta <= bucket - 1: after a
            // prune at this bucket every entry has f + delta >= bucket, a
            // hit raises f and an insert writes f + delta = bucket, so only
            // a new bucket, the step's first event (a restored table need
            // not hold that) or the touched slot itself can meet it
            const bool pass = first || bucket != prev || low;
            first = false;
            prev = bucket;
            if (pass) {
              cmd = P_PRUNE;
              break;
            }
          }
          if (cmd != P_NONE) {
            *s_cmd = cmd;
            *s_beta = bucket;
          }
        }
        __syncwarp();
        b = __shfl_sync(FULL, b, 0);
        taken = __shfl_sync(FULL, taken, 0);
        cmd = __shfl_sync(FULL, cmd, 0);
      }
      if (cmd == P_DONE) {
        close_chunk();
        if (lane == 0) *s_cmd = P_DONE;
      } else {                          // a pass reads the index and the values
        flush();
        flush_vals(b - b0);
        if (cmd == P_DEC) vlo = b - b0; // the interrupted arrival's slot comes
      }
    }
    __syncthreads();
    cmd = *s_cmd;
    if (cmd == P_DONE) break;
    resume = true;
    // ---- one visit of every slot: the prune at s_beta or the decrement-all
    const long long beta = *s_beta;
    int mine = 0, mfe = C;
    double pf[QMAXLANE];
    long long pi[QMAXLANE];
    for (int l = 0; l < a.AF; ++l) pf[l] = 0.0;
    for (int l = 0; l < a.AI; ++l) pi[l] = 0;
    for (int s = tid; s < C; s += nt) {
      long long c = t.cnt[s];
      if (c <= 0) continue;
      bool out;
      if (cmd == P_PRUNE) {
        out = c + t.del[s] <= beta - 1;
      } else {
        c -= 1;
        out = c == 0;
        t.cnt[s] = c;
      }
      if (!out) continue;
      t.cnt[s] = 0;
      if (s < mfe) mfe = s;
      ++mine;
      for (int l = 0; l < a.AF; ++l) pf[l] += (double)a.f_out[(long long)l * C + s];
      for (int l = 0; l < a.AI; ++l) pi[l] += a.i_out[(long long)l * C + s];
    }
    const long long got = block_reduce<long long>(pack2(mfe, mine), MinSum(), s_l);
    fe = (int)(got >> 32);
    nev = (int)(unsigned)got;
    if (nev > 0) {
      for (int l = 0; l < a.AF; ++l) {
        const float tf = f32_of(block_sum<double>(pf[l], s_d));
        if (tid == 0) s_tf[l] = tf;
      }
      for (int l = 0; l < a.AI; ++l) {
        const long long ti = block_sum<long long>(pi[l], s_l);
        if (tid == 0) s_ti[l] = ti;
      }
      dup = hh_index(t, s_flag);        // (its barriers publish s_tf / s_ti)
    }
  }
  // the rows, from what the walk recorded
  for (int r = tid; r <= last; r += nt) {
    float sf[QMAXLANE];
    long long si[QMAXLANE];
    for (int l = 0; l < a.AF; ++l) sf[l] = (float)a.incf[(long long)l * B + r];
    for (int l = 0; l < a.AI; ++l) si[l] = a.inci[(long long)l * B + r];
    put_row(a, r, a.inco[r], sf, si, nullptr, nullptr, a.oflag[r] != 0);
  }
  __syncthreads();
  if (k < B) repeat_rows(a, k);
  if (SH) {
    for (int s = tid; s < C; s += nt) {
      a.hkeys_out[s] = t.key[s];
      a.hcnt_out[s] = t.cnt[s];
      if (lossy) a.hdelta_out[s] = t.del[s];
    }
  }
  if (tid == 0) {
    for (int l = 0; l < a.AF; ++l) a.runf_out[l] = s_rf[l];
    for (int l = 0; l < a.AI; ++l) a.runi_out[l] = s_ri[l];
    *a.runc_out = rcnt;
    *a.ocount = emitted;
    if (lossy) {
      *a.htot_out = total;
      *a.drops_out = drops;
    }
  }
}

__global__ void __launch_bounds__(NTW) q_walk(QArgs a) {
  __shared__ int s_scan[NTW / 32 + 1];
  __shared__ double s_d[33];
  __shared__ long long s_l[33];
  __shared__ int s_cmd, s_flag;
  __shared__ long long s_beta;
  __shared__ float s_vf[QMAXLANE * 32], s_rf[QMAXLANE], s_tf[QMAXLANE];
  __shared__ long long s_vi[QMAXLANE * 32], s_ri[QMAXLANE], s_ti[QMAXLANE];
  __shared__ HhChunk s_ch;
  const int k = compact_batch(a, 0, s_scan);
  if (a.wkind == W_SORT) {
    if (threadIdx.x == 0) *a.ocount = k;
    walk_sort(a, k, s_d, s_l);
  } else if (a.hh_shared) {
    walk_hh<true>(a, k, s_d, s_l, &s_cmd, &s_beta, &s_flag, s_vf, s_vi, &s_ch, s_rf, s_ri,
                  s_tf, s_ti);
  } else {
    walk_hh<false>(a, k, s_d, s_l, &s_cmd, &s_beta, &s_flag, s_vf, s_vi, &s_ch, s_rf, s_ri,
                   s_tf, s_ti);
  }
}

// ------------------------------------------------------------ host entry

extern "C" int query_walk_args_size(void) { return (int)sizeof(QArgs); }

// Bytes of the heavy-hitter table in shared memory: keys, counts, (lossy)
// deltas, the index and the free bits.
static size_t hh_bytes(const QArgs& a) {
  const size_t C = (size_t)a.N;
  return C * 8 * (a.wkind == W_LOSSY ? 3 : 2) + (size_t)a.hh_H * 4 + (C + 31) / 32 * 4;
}

// Launches one step on `stream`; *nlaunch receives the number of kernel
// launches made. Returns the first CUDA error (0 on success). The heavy-
// hitter table goes to shared memory where it fits beside the kernel's own,
// else it stays in device memory.
extern "C" int query_walk(const QArgs* args, void* stream, int* nlaunch) {
  *nlaunch = 0;
  QArgs a = *args;
  size_t dyn = 0;
  if (a.wkind != W_SORT) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, q_walk);
    if (e != cudaSuccess) return (int)e;
    const size_t need = hh_bytes(a);
    a.hh_shared = need + fa.sharedSizeBytes <= (size_t)optin;
    if (a.hh_shared) {
      dyn = need;
      e = cudaFuncSetAttribute(q_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
      if (e != cudaSuccess) return (int)e;
    }
  }
  q_walk<<<1, NTW, dyn, (cudaStream_t)stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch = 1;
  return 0;
}
