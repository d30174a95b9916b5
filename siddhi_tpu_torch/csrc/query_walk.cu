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
// batch's events runs inside the kernel. The table is the state's fresh
// output buffers (the input state is copied there first and left as it
// was), in global memory: per event the block makes one pass over the
// table (the C slots, or the N buffer slots) with block-wide reductions
// (first hit and first free slot, the evictions, the buffer sums) and a
// top-down shift for the sort insert.
//
// What bounds it on the H100: in principle the bytes of the batch and the
// table (a few hundred KB a step, well under a microsecond). This first
// version is bound by its serial walk: a handful of block barriers per event
// on one SM. A table in shared memory and a hashed key lookup are later
// work.

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
// after having (``ok`` is the validity before it).
__device__ bool put_row(const QArgs& a, int b, long long cnt, const float* sf,
                        const long long* si, const long long* sm, const float* sd,
                        bool ok) {
  long long ov[QMAXSPEC];
  for (int i = 0; i < a.nspec; ++i) {
    const int kind = a.spec_kind[i], l = a.spec_lane[i];
    long long v;
    if (kind == S_VALUE) {
      ov[i] = load_typed(a.out[i], a.spec_ty[i], b);
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
  if (a.has_having) ok = ok && eval_prog(a.code, a.having, NoBindQ{}, OutAt{ov}) != 0;
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
struct MinMin {   // component-wise min
  __device__ long long operator()(long long x, long long y) const {
    const int h = (int)(x >> 32) < (int)(y >> 32) ? (int)(x >> 32) : (int)(y >> 32);
    const int l = (int)(unsigned)x < (int)(unsigned)y ? (int)(unsigned)x : (int)(unsigned)y;
    return pack2(h, l);
  }
};
struct MinSum {   // min of the high field, sum of the low field
  __device__ long long operator()(long long x, long long y) const {
    const int h = (int)(x >> 32) < (int)(y >> 32) ? (int)(x >> 32) : (int)(y >> 32);
    return pack2(h, (int)(unsigned)x + (int)(unsigned)y);
  }
};

__device__ void walk_hh(const QArgs& a, int k, double* s_d, long long* s_l) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int C = a.N, B = a.B;
  const bool lossy = a.wkind == W_LOSSY;
  for (int s = tid; s < C; s += nt) {
    a.hkeys_out[s] = a.hkeys_in[s];
    a.hcnt_out[s] = a.hcnt_in[s];
    if (lossy) a.hdelta_out[s] = a.hdelta_in[s];
    for (int l = 0; l < a.AF; ++l) a.f_out[(long long)l * C + s] = a.f_in[(long long)l * C + s];
    for (int l = 0; l < a.AI; ++l) a.i_out[(long long)l * C + s] = a.i_in[(long long)l * C + s];
  }
  // the running sums and counters: thread 0's
  float rf[QMAXLANE];
  long long ri[QMAXLANE];
  for (int l = 0; l < a.AF; ++l) rf[l] = a.runf_in[l];
  for (int l = 0; l < a.AI; ++l) ri[l] = a.runi_in[l];
  long long rcnt = *a.runc_in;
  long long total = lossy ? *a.htot_in : 0, drops = lossy ? *a.drops_in : 0;
  int emitted = 0;
  __shared__ int s_emit;
  __syncthreads();
  const int last = k < B ? k : B - 1;
  for (int b = 0; b <= last; ++b) {
    const bool accept = b < k;
    bool has = false, ins = false;
    int idx = 0;
    long long bucket = 0;
    if (accept) {
      const long long key = a.bpacked[b];
      // the first occupied slot holding the key, the first free slot
      int fh = C, ff = C;
      for (int s = tid; s < C; s += nt) {
        if (a.hcnt_out[s] > 0) { if (a.hkeys_out[s] == key && s < fh) fh = s; }
        else if (s < ff) ff = s;
      }
      const long long got = block_reduce<long long>(pack2(fh, ff), MinMin(), s_l);
      fh = (int)(got >> 32);
      ff = (int)(unsigned)got;
      has = fh < C;
      const bool space = ff < C;
      ins = !has && space;
      idx = has ? fh : (space ? ff : 0);
      if (lossy) {
        total += 1;
        bucket = (long long)((double)total * a.hh_error) + 1;
        if (tid == 0) {
          bool emit = false;
          if (has || ins) {
            const long long ef = has ? a.hcnt_out[idx] + 1 : 1;
            const long long ed = ins ? bucket - 1 : a.hdelta_out[idx];
            emit = (double)(ef + ed) >= (double)total * a.hh_support;
            for (int l = 0; l < a.AF; ++l) a.f_out[(long long)l * C + idx] = a.bf[(long long)l * B + b];
            for (int l = 0; l < a.AI; ++l) a.i_out[(long long)l * C + idx] = a.bi[(long long)l * B + b];
            a.hkeys_out[idx] = key;
          } else {
            drops += 1;
          }
          s_emit = emit;
        }
        __syncthreads();
        // counts up, the arrival's slot, then the prune: every entry with
        // f + delta <= bucket - 1 (the one just updated included)
        int nev = 0;
        double pf[QMAXLANE];
        long long pi[QMAXLANE];
        for (int l = 0; l < a.AF; ++l) pf[l] = 0.0;
        for (int l = 0; l < a.AI; ++l) pi[l] = 0;
        for (int s = tid; s < C; s += nt) {
          long long c = a.hcnt_out[s], d = a.hdelta_out[s];
          if (has && c > 0 && a.hkeys_out[s] == key) c += 1;
          if (ins && s == idx) { c = 1; d = bucket - 1; }
          if (c > 0 && c + d <= bucket - 1) {
            c = 0;
            ++nev;
            for (int l = 0; l < a.AF; ++l) pf[l] += (double)a.f_out[(long long)l * C + s];
            for (int l = 0; l < a.AI; ++l) pi[l] += a.i_out[(long long)l * C + s];
          }
          a.hcnt_out[s] = c;
          a.hdelta_out[s] = d;
        }
        const bool emit = s_emit != 0;
        if (tid == 0) {
          for (int l = 0; l < a.AF; ++l) rf[l] = __fadd_rn(rf[l], emit ? a.bf[(long long)l * B + b] : 0.0f);
          for (int l = 0; l < a.AI; ++l) ri[l] += emit ? a.bi[(long long)l * B + b] : 0;
          rcnt += emit;
          emitted += emit;
          put_row(a, b, rcnt, rf, ri, nullptr, nullptr, emit);
        }
        nev = block_sum<int>(nev, (int*)s_l);
        if (nev > 0) {
          for (int l = 0; l < a.AF; ++l) {
            const float t = f32_of(block_sum<double>(pf[l], s_d));
            if (tid == 0) rf[l] = __fsub_rn(rf[l], t);
          }
          for (int l = 0; l < a.AI; ++l) {
            const long long t = block_sum<long long>(pi[l], s_l);
            if (tid == 0) ri[l] -= t;
          }
          rcnt -= nev;
        }
        __syncthreads();
        continue;
      }
      // frequent: counts up, the arrival's slot, or decrement-all
      const bool dec = !has && !space;
      int fe = C, nev = 0;
      double pf[QMAXLANE];
      long long pi[QMAXLANE];
      for (int l = 0; l < a.AF; ++l) pf[l] = 0.0;
      for (int l = 0; l < a.AI; ++l) pi[l] = 0;
      for (int s = tid; s < C; s += nt) {
        long long c = a.hcnt_out[s];
        if (has && c > 0 && a.hkeys_out[s] == key) c += 1;
        if (ins && s == idx) c = 1;
        if (dec && c > 0) {
          c -= 1;
          if (c == 0) {
            if (s < fe) fe = s;
            ++nev;
            for (int l = 0; l < a.AF; ++l) pf[l] += (double)a.f_out[(long long)l * C + s];
            for (int l = 0; l < a.AI; ++l) pi[l] += a.i_out[(long long)l * C + s];
          }
        }
        a.hcnt_out[s] = c;
      }
      if (dec) {
        const long long got = block_reduce<long long>(pack2(fe, nev), MinSum(), s_l);
        fe = (int)(got >> 32);
        nev = (int)(unsigned)got;
        if (nev > 0) {
          // the evicted keys' last values leave the sums before the add
          for (int l = 0; l < a.AF; ++l) {
            const float t = f32_of(block_sum<double>(pf[l], s_d));
            if (tid == 0) rf[l] = __fsub_rn(rf[l], t);
          }
          for (int l = 0; l < a.AI; ++l) {
            const long long t = block_sum<long long>(pi[l], s_l);
            if (tid == 0) ri[l] -= t;
          }
          rcnt -= nev;
          idx = fe;                   // the arrival takes the first of them
        }
      }
      __syncthreads();
      const bool emit = has || ins || nev > 0;
      if (tid == 0) {
        if (emit) {
          if (nev > 0) a.hcnt_out[idx] = 1;
          for (int l = 0; l < a.AF; ++l) a.f_out[(long long)l * C + idx] = a.bf[(long long)l * B + b];
          for (int l = 0; l < a.AI; ++l) a.i_out[(long long)l * C + idx] = a.bi[(long long)l * B + b];
          a.hkeys_out[idx] = key;
        }
        for (int l = 0; l < a.AF; ++l) rf[l] = __fadd_rn(rf[l], emit ? a.bf[(long long)l * B + b] : 0.0f);
        for (int l = 0; l < a.AI; ++l) ri[l] += emit ? a.bi[(long long)l * B + b] : 0;
        rcnt += emit;
        emitted += emit;
        put_row(a, b, rcnt, rf, ri, nullptr, nullptr, emit);
      }
      __syncthreads();
      continue;
    }
    // an unaccepted slot: nothing changes, its row shows the running sums
    if (tid == 0) {
      for (int l = 0; l < a.AF; ++l) rf[l] = __fadd_rn(rf[l], 0.0f);
      put_row(a, b, rcnt, rf, ri, nullptr, nullptr, false);
    }
  }
  __syncthreads();
  if (k < B) repeat_rows(a, k);
  if (tid == 0) {
    for (int l = 0; l < a.AF; ++l) a.runf_out[l] = rf[l];
    for (int l = 0; l < a.AI; ++l) a.runi_out[l] = ri[l];
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
  const int k = compact_batch(a, 0, s_scan);
  if (a.wkind == W_SORT) {
    if (threadIdx.x == 0) *a.ocount = k;
    walk_sort(a, k, s_d, s_l);
  } else {
    walk_hh(a, k, s_d, s_l);
  }
}

// ------------------------------------------------------------ host entry

extern "C" int query_walk_args_size(void) { return (int)sizeof(QArgs); }

// Launches one step on `stream`; *nlaunch receives the number of kernel
// launches made. Returns cudaGetLastError() (0 on success).
extern "C" int query_walk(const QArgs* args, void* stream, int* nlaunch) {
  *nlaunch = 0;
  q_walk<<<1, NTW, 0, (cudaStream_t)stream>>>(*args);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *nlaunch = 1;
  return 0;
}
