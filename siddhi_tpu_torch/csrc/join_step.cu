// Windowed stream-stream join step kernel for Hopper (sm_90a).
//
// Replaces, from the reference JAX package, tpu/join_compile.py::
// CompiledJoinQuery.make_step -> step (B6, with _compact_side): one merged
// micro-batch of the two streams (tag 0 = left, 1 = right, valid = the
// prefix [0, nvalid)); every valid arrival probes the opposite side's ring
// (the last W arrivals, oldest first) and the older arrivals of the
// opposite side in the same batch; an outer join adds one unmatched row
// with the other side null; rows go out in the reference's order (probe,
// then ring slots 0..W-1, then batch positions ascending, then the
// unmatched row), the first J kept, the rest counted in join_drops; then
// each side's arrivals slide into its ring (concat + dynamic_slice(k): when
// a side's k > W the arrivals before k - W are lost uncounted, as in the
// reference), and live time-window entries pushed out are counted in
// ring_drops. Conditions and outputs run through B2's IR (expr_ir.cuh)
// over a pair environment: variable slot v is a left or right attribute,
// read from the probe's row when it is the probe's side and from the
// candidate's ring slot or batch row otherwise; OP_TS (eventTimestamp()) is
// linked as EV slot 0, the probe's timestamp.
//
// The reference builds [B, W] and [B, B] pair grids, a [B, W + B + 1] flat
// mask and a cumsum rank over it; none of them is built here. Four launches
// (five with a key index), all on the caller's stream, nothing allocated:
//   1. j_prep, one CTA: absolute timestamps, each side's exclusive arrival
//      counts and the batch position of its i-th arrival (ballot scans),
//      k per side and the newest valid timestamp.
//   1b. j_index, where the plan found a key (a top-level conjunct of the
//      condition that compares a left and a right BOOL, INT, LONG or string
//      attribute for equality): one CTA per index, four indexes (each side's
//      ring slots that ever held an arrival, each side's batch arrivals),
//      each a stable counting sort of the candidates by a hash of their key
//      into NB buckets: a histogram (shared atomics, the buckets kept in
//      shared memory), an exclusive scan of the buckets, and a scatter by
//      one warp in candidate order (__match_any_sync ranks the equal
//      buckets of 32 candidates), so each
//      bucket lists its ring slots and batch positions ascending. A ring CTA
//      also checks whether its live slots' expiry times are nondecreasing.
//   2. j_count, one warp per probe: walks the candidates in emission order,
//      tests liveness, within and the condition lane-parallel, and counts
//      matches with __ballot_sync/__popc (+1 for an unmatched outer row;
//      "matched" is taken before the J cut, as in the reference). With a
//      key index it walks only the probe's bucket: its ring slots from the
//      first live one (a binary search where the ring's expiry times are
//      nondecreasing, or for a length ring by opp_excl; else from the
//      first), then its batch positions below the probe. A candidate with
//      another key fails the equality, so the walk is the reference's
//      emission order restricted to the candidates that can match; the full
//      condition still decides each pair, so a hash collision costs time,
//      never a row.
//   3. j_scan, one CTA: the exclusive scan of the per-probe counts (row
//      offsets, deterministic: no atomics decide positions), count =
//      min(n_sel, J), join_drops and ring_drops.
//   4. j_emit: one warp per probe walks again and writes each selected pair
//      at offset + ballot rank where that is below J (the first J in
//      row-major order), evaluating the output programs there; one thread
//      per row in [count, J) writes the reference's masked-off row (probe
//      0 against ring slot 0, null false, valid false); one thread per ring
//      slot writes the slid rings to fresh buffers (the input state is
//      read-only).
//
// What bounds it on the H100: operations. Without an index a step tests
// about B * (W + B/2) pairs, each a few compares plus the condition's IR
// (~5-15 interpreted instructions): ~25-35 M pair tests for B = W = 4096,
// while the bytes are the rings, the batch and the J rows, a few MB (~1 us
// at 3.35 TB/s). With an index a probe tests only its bucket's live
// candidates (a few per probe for ~1,000 keys), and the step's device time
// goes to the index build (one warp's ordered scatter per index) and the
// launches. The condition is still interpreted per pair; compiling it and
// a single pass with a decoupled look-back are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXSTACK 32
#include "expr_ir.cuh"

#define JMAXVAR 32
#define JMAXOUT 32
#define NT 1024
#define NTW 256
#define FULL 0xffffffffu
#define TS_NEG (-(1LL << 62))
#define NBB 12                     // log2 of the buckets of a key index
#define NB (1 << NBB)
#define IDX_SMEM 12288             // candidates whose buckets j_index keeps in shared memory

enum { K_TIME = 0, K_LENGTH = 1 };

// Mirrored by gpu/join_step.py (JArgs, ctypes); join_step_args_size checks it.
struct JArgs {
  int B, W, J, nvalid;
  int lkind, rkind;                 // K_TIME / K_LENGTH per side
  long long lparam, rparam;         // window ms or length
  int has_within; long long within;
  int emit_left, emit_right, un_left, un_right;
  int nvar, has_cond, nout;
  int indexed;                      // walk the key index (keyp set)
  int var_side[JMAXVAR];            // 0 left, 1 right
  int var_ty[JMAXVAR];
  int out_ty[JMAXOUT];
  int out_null[JMAXOUT];            // bit 0: reads the left side, bit 1: right
  Prog cond;
  Prog keyp[2];                     // each side's equality operand
  Prog outp[JMAXOUT];
  const int4* code;
  const signed char* tag; const int* ts; const long long* ts_base;
  const void* col[JMAXVAR];         // batch column of each variable [B]
  const void* ring_in[JMAXVAR];     // its side's ring [W]
  void* ring_out[JMAXVAR];
  const long long* lts_in; const long long* rts_in;
  long long* lts_out; long long* rts_out;
  const long long* jd_in; const long long* rd_in;
  long long* jd_out; long long* rd_out;
  void* out[JMAXOUT]; unsigned char* onull[JMAXOUT];
  unsigned char* ovalid; long long* ots; long long* ocount;
  // scratch
  long long* tsa;                   // [B] absolute timestamps
  int* cl; int* cr;                 // [B] exclusive left / right arrival counts
  int* idx;                         // [2, B] batch position of a side's i-th arrival
  int* cnt; int* off;               // [B] rows per probe, their offsets
  int* misc;                        // [0] kl, [1] kr, [2] count, [3 + side] mono
  long long* now;                   // [1] newest valid timestamp
  // key index: index i = ring L, ring R, batch L, batch R
  int* istart;                      // [4, NB + 1] first item of each bucket
  int* items;                       // [2W + 2B] ring slots / batch positions
  int* ibkt;                        // [2W + 2B] each candidate's bucket (-1: none)
};

__device__ __forceinline__ long long wadd(long long x, long long y) {
  return (long long)((unsigned long long)x + (unsigned long long)y);
}
__device__ __forceinline__ int warp_width() {
  return blockDim.x < 32 ? (int)blockDim.x : 32;
}

// ------------------------------------------------------------ pair reads

struct ProbeTs {
  long long t;
  __device__ long long operator()(int) const { return t; }
};
// variable v of the pair (probe p of side ps, candidate c: a ring slot or a
// batch row)
struct PairVar {
  const JArgs* a; int p, ps; bool ring; int c;
  __device__ long long operator()(int v) const {
    if (a->var_side[v] == ps) return load_typed(a->col[v], a->var_ty[v], p);
    return ring ? load_typed(a->ring_in[v], a->var_ty[v], c)
                : load_typed(a->col[v], a->var_ty[v], c);
  }
};

struct Probe {
  int p, ps;          // position, side (0 left)
  long long t;        // timestamp
  int opp_excl;       // exclusive arrival count of the opposite side at p
  bool ok;            // valid and allowed to trigger
  bool un;            // an unmatched probe emits a row
};

__device__ __forceinline__ Probe probe_at(const JArgs& a, int p) {
  Probe q;
  q.p = p;
  q.ps = a.tag[p] == 0 ? 0 : 1;
  q.t = a.tsa[p];
  q.opp_excl = q.ps == 0 ? a.cr[p] : a.cl[p];
  q.ok = p < a.nvalid && (q.ps == 0 ? a.emit_left : a.emit_right);
  q.un = q.ps == 0 ? a.un_left : a.un_right;
  return q;
}

// Does candidate c (ring slot, or batch row c < p of the opposite tag) of
// probe q pair? Liveness, then within, then the condition.
__device__ bool pair_ok(const JArgs& a, const Probe& q, bool ring, int c) {
  const int os = 1 - q.ps;
  const int kind = os == 0 ? a.lkind : a.rkind;
  const long long par = os == 0 ? a.lparam : a.rparam;
  long long ct;
  if (ring) {
    ct = (os == 0 ? a.lts_in : a.rts_in)[c];
    if (!(ct > TS_NEG)) return false;
    if (kind == K_TIME) {
      if (!(wadd(ct, par) > q.t)) return false;
    } else if (!((long long)(a.W - 1 - c) + q.opp_excl < par)) {
      return false;
    }
  } else {
    ct = a.tsa[c];
    if (kind == K_TIME) {
      if (!(wadd(ct, par) > q.t)) return false;
    } else {
      const int ce = (os == 0 ? a.cl : a.cr)[c] + 1;
      if (!((long long)(q.opp_excl - ce) < par)) return false;
    }
  }
  if (a.has_within) {
    long long d = wadd(q.t, -ct);
    if (d < 0) d = wadd(0, -d);
    if (!(d <= a.within)) return false;
  }
  if (a.has_cond)
    return eval_fast(a.code, a.cond, ProbeTs{q.t}, PairVar{&a, q.p, q.ps, ring, c}) != 0;
  return true;
}

// ------------------------------------------------------------ key index

// side's equality operand over a candidate of that side: ring slot c, or
// batch row c
__device__ __forceinline__ long long key_of(const JArgs& a, int side, bool ring, int c) {
  return eval_fast(a.code, a.keyp[side], ProbeTs{0}, PairVar{&a, 0, 1 - side, ring, c});
}
__device__ __forceinline__ int bucket_of(long long k) {
  return (int)(((unsigned long long)k * 0x9E3779B97F4A7C15ull) >> (64 - NBB));
}
__device__ __forceinline__ const int* index_start(const JArgs& a, int i) {
  return a.istart + (long long)i * (NB + 1);
}
__device__ __forceinline__ int index_base(const JArgs& a, int i) {
  return i < 2 ? i * a.W : 2 * a.W + (i - 2) * a.B;
}

// Probe q's first live slot among the bucket's ring slots it[lo, hi)
// (ascending): a binary search where liveness is monotone in the slot (a
// length ring; a time ring whose live slots' expiry times are
// nondecreasing), else lo.
__device__ int first_live(const JArgs& a, const Probe& q, int os, const int* it,
                          int lo, int hi) {
  const int kind = os == 0 ? a.lkind : a.rkind;
  const long long par = os == 0 ? a.lparam : a.rparam;
  const long long* rts = os == 0 ? a.lts_in : a.rts_in;
  if (kind == K_TIME && !a.misc[3 + os]) return lo;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2, c = it[mid];
    const bool live = kind == K_TIME ? wadd(rts[c], par) > q.t
                                     : (long long)(a.W - 1 - c) + q.opp_excl < par;
    if (live) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// walk_pairs over the probe's key bucket: its ring slots from the first
// live one, then its batch positions below the probe, both ascending.
template <class Hit, class Stop>
__device__ int walk_bucket(const JArgs& a, const Probe& q, Hit hit, Stop stop) {
  const int ws = warp_width(), lane = threadIdx.x % ws;
  const unsigned below = (1u << lane) - 1u;
  const int os = 1 - q.ps;
  const int bk = bucket_of(key_of(a, q.ps, false, q.p));
  int n = 0;
  const int* st = index_start(a, os);
  const int* it = a.items + index_base(a, os);
  const int hi = st[bk + 1];
  for (int i0 = first_live(a, q, os, it, st[bk], hi); i0 < hi && !stop(n); i0 += ws) {
    const int i = i0 + lane;
    const int c = i < hi ? it[i] : 0;
    const bool ok = i < hi && pair_ok(a, q, true, c);
    const unsigned m = __ballot_sync(FULL, ok);
    if (ok) hit(n + __popc(m & below), true, c);
    n += __popc(m);
  }
  st = index_start(a, 2 + os);
  it = a.items + index_base(a, 2 + os);
  const int bhi = st[bk + 1];
  for (int i0 = st[bk]; i0 < bhi && it[i0] < q.p && !stop(n); i0 += ws) {
    const int i = i0 + lane;
    const int j = i < bhi ? it[i] : q.p;
    const bool ok = j < q.p && pair_ok(a, q, false, j);
    const unsigned m = __ballot_sync(FULL, ok);
    if (ok) hit(n + __popc(m & below), false, j);
    n += __popc(m);
  }
  return n;
}

// Walks probe q's candidates in emission order, one warp; calls
// hit(rank, ring, c) on the lane of every pair (rank = its index among the
// probe's pairs) and stops once stop(pairs so far) holds. Returns the
// number of pairs (every lane gets it).
template <class Hit, class Stop>
__device__ int walk_pairs(const JArgs& a, const Probe& q, Hit hit, Stop stop) {
  if (a.indexed) return walk_bucket(a, q, hit, stop);
  const int ws = warp_width(), lane = threadIdx.x % ws;
  const unsigned below = (1u << lane) - 1u;
  const int os = 1 - q.ps;
  int n = 0;
  for (int w0 = 0; w0 < a.W && !stop(n); w0 += ws) {
    const int w = w0 + lane;
    const bool ok = w < a.W && pair_ok(a, q, true, w);
    const unsigned m = __ballot_sync(FULL, ok);
    if (ok) hit(n + __popc(m & below), true, w);
    n += __popc(m);
  }
  for (int j0 = 0; j0 < q.p && !stop(n); j0 += ws) {
    const int j = j0 + lane;
    const bool ok = j < q.p && a.tag[j] == os && pair_ok(a, q, false, j);
    const unsigned m = __ballot_sync(FULL, ok);
    if (ok) hit(n + __popc(m & below), false, j);
    n += __popc(m);
  }
  return n;
}

// Writes output row r: probe p against candidate q of the reference's
// per-probe layout (q < W ring slot, W + j batch row j, W + B unmatched).
__device__ void write_row(const JArgs& a, int r, int p, int q, bool valid) {
  const int ps = a.tag[p] == 0 ? 0 : 1;
  const bool ring = q < a.W, un = q == a.W + a.B;
  int bq = q - a.W;
  bq = bq < 0 ? 0 : (bq > a.B - 1 ? a.B - 1 : bq);
  const PairVar pv{&a, p, ps, ring, ring ? q : bq};
  const long long t = a.tsa[p];
  for (int o = 0; o < a.nout; ++o) {
    store_typed(a.out[o], a.out_ty[o], r, eval_fast(a.code, a.outp[o], ProbeTs{t}, pv));
    const int nm = a.out_null[o];
    a.onull[o][r] = un && (((nm & 1) && ps == 1) || ((nm & 2) && ps == 0));
  }
  a.ots[r] = t;
  a.ovalid[r] = valid;
}

// ------------------------------------------------------------ block scans

// Exclusive count of flag over [0, n) at every position into excl; the
// position of the i-th set flag into idx[i]; returns the total. Every
// thread of the block calls it; s_scan holds NT / 32 + 1 ints.
template <class Flag>
__device__ int block_excl_count(int n, Flag flag, int* excl, int* idx, int* s_scan) {
  const int tid = threadIdx.x, ws = warp_width();
  const int lane = tid % ws, warp = tid / ws;
  const int nt = blockDim.x, nw = (nt + ws - 1) / ws;
  __syncthreads();
  if (tid == 0) s_scan[nw] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += nt) {
    const int i = base + tid;
    const int f = (i < n && flag(i)) ? 1 : 0;
    const unsigned m = __ballot_sync(FULL, f);
    const int pre = __popc(m & ((1u << lane) - 1u));
    if (lane == 0) s_scan[warp] = __popc(m);
    __syncthreads();
    int off = s_scan[nw];
    for (int w = 0; w < warp; ++w) off += s_scan[w];
    if (i < n) {
      excl[i] = off + pre;
      if (f) idx[off + pre] = i;
    }
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

struct AddL { __device__ long long operator()(long long x, long long y) const { return x + y; } };
struct MaxL { __device__ long long operator()(long long x, long long y) const { return x > y ? x : y; } };

// ------------------------------------------------------------ 1. j_prep

__global__ void __launch_bounds__(NT) j_prep(JArgs a) {
  __shared__ int s_scan[NT / 32 + 1];
  __shared__ long long s_buf[33];
  const int tid = threadIdx.x, nt = blockDim.x, B = a.B;
  const long long base = *a.ts_base;
  long long now = TS_NEG;
  for (int b = tid; b < B; b += nt) {
    const long long t = wadd(base, (long long)a.ts[b]);
    a.tsa[b] = t;
    if (b < a.nvalid && t > now) now = t;
  }
  const int kl = block_excl_count(
      B, [&](int b) { return b < a.nvalid && a.tag[b] == 0; }, a.cl, a.idx, s_scan);
  const int kr = block_excl_count(
      B, [&](int b) { return b < a.nvalid && a.tag[b] == 1; }, a.cr, a.idx + B, s_scan);
  now = block_reduce<long long>(now, MaxL(), s_buf);
  if (tid == 0) {
    a.misc[0] = kl;
    a.misc[1] = kr;
    *a.now = now;
  }
}

// ------------------------------------------------------------ 1b. j_index
// Block i builds index i (ring L, ring R, batch L, batch R): a stable
// counting sort of its candidates by bucket. Ring candidates are the slots
// that ever held an arrival (ts > TS_NEG: an empty slot never pairs), batch
// candidates the side's valid arrivals, each in position order. The
// buckets of up to IDX_SMEM candidates stay in shared memory for the
// scatter (16 bits each), more in device memory.

__global__ void __launch_bounds__(NT) j_index(JArgs a) {
  __shared__ int s_cur[NB];
  __shared__ unsigned short s_bkt[IDX_SMEM];
  __shared__ int s_w[NT / 32 + 1];
  const int tid = threadIdx.x, nt = blockDim.x, i = blockIdx.x;
  const bool ring = i < 2;
  const int side = i & 1;
  const int n = ring ? a.W : a.B;
  const bool small = n <= IDX_SMEM;
  const long long* rts = side == 0 ? a.lts_in : a.rts_in;
  int* bkt = a.ibkt + index_base(a, i);
  int* items = a.items + index_base(a, i);
  int* start = a.istart + (long long)i * (NB + 1);
  for (int b = tid; b < NB; b += nt) s_cur[b] = 0;
  __syncthreads();
  // histogram
  for (int e = tid; e < n; e += nt) {
    int b = -1;
    if (ring ? rts[e] > TS_NEG : (e < a.nvalid && a.tag[e] == side))
      b = bucket_of(key_of(a, side, ring, e));
    if (small) s_bkt[e] = (unsigned short)(b + 1);
    else bkt[e] = b;
    if (b >= 0) atomicAdd(&s_cur[b], 1);
  }
  // a time ring's live slots: contiguous, expiry times nondecreasing
  if (ring) {
    const long long par = side == 0 ? a.lparam : a.rparam;
    int mono = 1;
    for (int w = tid; w + 1 < a.W; w += nt) {
      const bool l0 = rts[w] > TS_NEG, l1 = rts[w + 1] > TS_NEG;
      if (l0 && (!l1 || wadd(rts[w], par) > wadd(rts[w + 1], par))) mono = 0;
    }
    mono = __syncthreads_and(mono);
    if (tid == 0) a.misc[3 + side] = mono;
  }
  __syncthreads();
  // exclusive scan of the buckets: NB / nt consecutive buckets a thread
  const int per = (NB + nt - 1) / nt, b0 = tid * per;
  int run = 0;
  for (int b = b0; b < b0 + per && b < NB; ++b) run += s_cur[b];
  const int ws = warp_width(), lane = tid % ws, warp = tid / ws;
  int x = run;
  for (int d = 1; d < ws; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == ws - 1 || tid == nt - 1) s_w[warp] = x;
  __syncthreads();
  int off = x - run;
  for (int w = 0; w < warp; ++w) off += s_w[w];
  for (int b = b0; b < b0 + per && b < NB; ++b) {
    const int c = s_cur[b];
    start[b] = off;
    s_cur[b] = off;
    off += c;
  }
  if (tid == nt - 1) start[NB] = off;
  __syncthreads();
  // the ordered scatter: one warp, ws candidates at a time
  if (warp != 0) return;
  const unsigned below = (1u << lane) - 1u;
  for (int e0 = 0; e0 < n; e0 += ws) {
    const int e = e0 + lane;
    const int b = e >= n ? -1 : (small ? (int)s_bkt[e] - 1 : bkt[e]);
    const unsigned peers = __match_any_sync(FULL, b);
    const int base = b >= 0 ? s_cur[b] : 0;
    __syncwarp();
    if (b >= 0) {
      items[base + __popc(peers & below)] = e;
      if ((peers >> lane) == 1u) s_cur[b] = base + __popc(peers);
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------ 2. j_count

__global__ void __launch_bounds__(NTW) j_count(JArgs a) {
  const int ws = warp_width();
  const int p = (int)((blockIdx.x * blockDim.x + threadIdx.x) / ws);
  if (p >= a.B) return;
  const Probe q = probe_at(a, p);
  int n = 0;
  if (q.ok)
    n = walk_pairs(a, q, [](int, bool, int) {}, [](int) { return false; });
  if (threadIdx.x % ws == 0) a.cnt[p] = n + ((q.ok && n == 0 && q.un) ? 1 : 0);
}

// ------------------------------------------------------------ 3. j_scan

__global__ void __launch_bounds__(NT) j_scan(JArgs a) {
  __shared__ long long s_buf[33];
  __shared__ long long s_carry;
  const int tid = threadIdx.x, nt = blockDim.x, B = a.B;
  const int ws = warp_width(), lane = tid % ws, warp = tid / ws;
  const int nw = (nt + ws - 1) / ws;
  if (tid == 0) s_carry = 0;
  __syncthreads();
  for (int base = 0; base < B; base += nt) {
    const int i = base + tid;
    long long v = i < B ? a.cnt[i] : 0;
    // inclusive warp scan, then the warps' totals in order
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(FULL, v, d);
      if (lane >= d) v += u;
    }
    if (lane == ws - 1) s_buf[warp] = v;
    __syncthreads();
    long long pre = s_carry;
    for (int w = 0; w < warp; ++w) pre += s_buf[w];
    if (i < B) a.off[i] = (int)(pre + v - a.cnt[i]);
    __syncthreads();
    if (tid == 0) {
      long long tot = 0;
      for (int w = 0; w < nw; ++w) tot += s_buf[w];
      s_carry += tot;
    }
    __syncthreads();
  }
  const long long n_sel = s_carry;
  // ring entries pushed out while still alive (time windows only)
  const long long now = *a.now;
  long long drops = 0;
  for (int side = 0; side < 2; ++side) {
    if ((side == 0 ? a.lkind : a.rkind) != K_TIME) continue;
    const long long* rts = side == 0 ? a.lts_in : a.rts_in;
    const long long par = side == 0 ? a.lparam : a.rparam;
    const int k = a.misc[side];
    for (int w = tid; w < a.W && w < k; w += nt)
      drops += rts[w] > TS_NEG && wadd(rts[w], par) > now;
  }
  drops = block_reduce<long long>(drops, AddL(), s_buf);
  if (tid == 0) {
    const int count = (int)(n_sel < a.J ? n_sel : a.J);
    a.misc[2] = count;
    *a.ocount = count;                 // int64, as the reference's sum
    *a.jd_out = *a.jd_in + (n_sel > a.J ? n_sel - a.J : 0);
    *a.rd_out = *a.rd_in + drops;
  }
}

// ------------------------------------------------------------ 4. j_emit
// Blocks [0, nprobe): one warp per probe; [nprobe, nprobe + nfill): one
// thread per output row (the masked-off rows); the rest: one thread per
// ring slot.

__global__ void __launch_bounds__(NTW) j_emit(JArgs a, int nprobe, int nfill) {
  const int blk = blockIdx.x;
  if (blk < nprobe) {
    const int ws = warp_width();
    const int p = (int)((blk * blockDim.x + threadIdx.x) / ws);
    if (p >= a.B) return;
    const int off = a.off[p];
    if (a.cnt[p] == 0 || off >= a.J) return;
    const Probe q = probe_at(a, p);
    const int J = a.J, W = a.W;
    const int n = walk_pairs(
        a, q,
        [&](int rank, bool ring, int c) {
          if (off + rank < J) write_row(a, off + rank, p, ring ? c : W + c, true);
        },
        [&](int seen) { return off + seen >= J; });
    if (n == 0 && threadIdx.x % ws == 0) write_row(a, off, p, W + a.B, true);
    return;
  }
  if (blk < nprobe + nfill) {
    const int r = (blk - nprobe) * blockDim.x + threadIdx.x;
    if (r < a.J && r >= a.misc[2]) write_row(a, r, 0, 0, false);
    return;
  }
  const int t = (blk - nprobe - nfill) * blockDim.x + threadIdx.x;
  if (t >= a.W) return;
  for (int side = 0; side < 2; ++side) {
    // new ring slot t = z[k + t] of z = [old ring (W) | the side's k arrivals]
    const int k = a.misc[side], src = k + t;
    const bool old = src < a.W;
    const int b = old ? 0 : a.idx[side * a.B + src - a.W];
    (side == 0 ? a.lts_out : a.rts_out)[t] =
        old ? (side == 0 ? a.lts_in : a.rts_in)[src] : a.tsa[b];
    for (int v = 0; v < a.nvar; ++v)
      if (a.var_side[v] == side)
        store_typed(a.ring_out[v], a.var_ty[v], t,
                    old ? load_typed(a.ring_in[v], a.var_ty[v], src)
                        : load_typed(a.col[v], a.var_ty[v], b));
  }
}

// ------------------------------------------------------------ host entry

extern "C" int join_step_args_size(void) { return (int)sizeof(JArgs); }

// Launches one step on `stream` (four launches, five with a key index);
// *nlaunch receives the number of kernel launches made. Returns cudaGetLastError() after each launch (0 on
// success).
extern "C" int join_step(const JArgs* args, void* stream, int* nlaunch) {
  const JArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  *nlaunch = 0;
  const int warps_per_block = NTW / 32;
  const int nprobe = (a.B + warps_per_block - 1) / warps_per_block;
  const int nfill = (a.J + NTW - 1) / NTW;
  const int nring = (a.W + NTW - 1) / NTW;
  j_prep<<<1, NT, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  if (a.indexed) {
    j_index<<<4, NT, 0, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    *nlaunch += 1;
  }
  j_count<<<nprobe, NTW, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  j_scan<<<1, NT, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  j_emit<<<nprobe + nfill + nring, NTW, 0, st>>>(a, nprobe, nfill);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch += 1;
  return 0;
}
