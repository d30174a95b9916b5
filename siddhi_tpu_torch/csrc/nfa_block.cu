// Blocked NFA stage kernel for Hopper (sm_90a).
//
// Replaces, from the reference JAX package:
//   - tpu/nfa_block.py::make_block_step   (B1: the blocked NFA step)
//   - tpu/expr_compile.py::compile_expression and helpers
//                                           (B2: predicate / output programs,
//                                            here a typed postfix IR run by
//                                            the __device__ interpreter of
//                                            expr_ir.cuh, shared with
//                                            nfa_scan.cu)
//   - tpu/partition.py:160-181             (B3: vmap over lanes, donated
//                                            state: here one CTA per lane,
//                                            tables updated in place)
//
// What it computes, per lane and per stage s = 1..S-1 (one launch each; the
// state-0 seed gate is folded into the s = 1 launch; S == 1 is one
// emit-only launch with s = 0):
//   candidates p = [C old table slots] ++ [creations entering stage s, in
//   born order]. For each candidate, the FIRST event j of the batch with
//     j < nvalid  &  tag[j] == stream(s)  &  ts[j]-first_p <= within
//     & ts[j]-last_p <= within(s)  &  pred_s(event j, bindings p)
//     & (pattern: j > born_p | sequence: vidx[j] == vb_p + 1)
//   advances it (adv, j*); j* = 0 when nothing matches (jnp.argmax of an
//   all-false column). The last stage writes ys (mask/j/ts/outputs at j*)
//   and counts matches; other stages write the creations of stage s+1,
//   compacted order-preservingly to K (drop-newest, counted) when a cap is
//   set. Survivors (exists & !adv & still inside the windows & for
//   sequences: no later event) pack keep-oldest into the C table slots,
//   overflow counted in drops.
//
// Design:
//   - grid = one CTA per lane (gridDim.x = L, the lane axis of B3), 512
//     threads. Nothing crosses lanes, so counters need no atomics.
//   - the CTA stages its lane's batch (ts as int64, tag, every used column)
//     and the old table of stage s in shared memory; survivors are written
//     back into the table in place after that copy (the analog of
//     donation). The [B, P] grid is never materialised.
//   - first-match search: one warp per candidate, its 32 lanes test 32
//     consecutive events and __ballot_sync/__ffs pick the first hit, so the
//     scan exits at the first matching chunk. The cheap mask terms are
//     tested before the predicate. Validity is a prefix, so vidx[j] =
//     min(j+1, nvalid) and a sequence candidate has exactly one event to
//     test (j = vb). ts is not assumed sorted.
//   - ordered compaction (creations to K, survivors to C) uses a block-wide
//     exclusive prefix count built from warp ballots.
//   - predicates and outputs run through the postfix IR interpreter of
//     expr_ir.cuh (static types bool/i32/i64/f32), so one build serves
//     every app.
//
// What bounds it on the H100: neither bytes nor arithmetic. A main-path
// step (64 lanes x 2048 events, C = 64, K = 320, 8 states) must move about
// 4.5 MB (1.7 MB of event columns, the tables read and written back, the
// ys), about 1.3 us at 3.35 TB/s, and its first-match tests are a similar
// ~1.3 us at the f32 rate. The real limits are the per-candidate serial
// search (a candidate that never matches scans the whole batch, each test
// an interpreted predicate), the S-1 dependent launches per step, and the
// grid: 64 CTAs occupy fewer than half of the 132 SMs. Fusing the stages
// into one launch, spreading a lane over several CTAs and specialising
// predicates by code generation are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXCOL 32
#define MAXB 32
#define MAXOUT 32
#define MAXSTACK 32
#include "expr_ir.cuh"

#define NTHREADS 512
#define NWARPS (NTHREADS / 32)
#define SMEM_LIMIT (227 * 1024)

// Event j's staged columns (column c at ev[c * B + j]) and a candidate's
// bindings (the k-th at bind[k * stride]), as eval_prog reads them.
struct EvAt {
  const long long* ev; int B; int j;
  __device__ long long operator()(int c) const { return ev[(long long)c * B + j]; }
};
struct BindAt {
  const long long* bind; int stride;
  __device__ long long operator()(int k) const { return bind[(long long)k * stride]; }
};
struct NoBind {
  __device__ long long operator()(int) const { return 0; }
};

// creation buffer fields (kernel-private layout, int64 values)
enum { F_EX = 0, F_BORN, F_VB, F_FIRST, F_LAST, F_BIND };


struct StageArgs {
  int L, B, C, s, last;
  int pc_in, pc_out, compact_out, seed_compact, K;
  int is_seq, has_within, has_ew, has_sw;
  long long within, sw;
  int sidx0, sidx;
  int ncol, nbind, nbind_out, nseed_bind, nout;
  int cre_cap, cre_nf;
  int col_ty[MAXCOL];
  int bind_ty[MAXB];
  int bout_kind[MAXB];
  int bout_idx[MAXB];
  int seed_col[MAXB];
  int out_ty[MAXOUT];
  Prog seed, pred;
  Prog out[MAXOUT];
  const void* col[MAXCOL];
  void* t_bind[MAXB];
  void* out_ptr[MAXOUT];
  const signed char* tag;
  const int* ts;
  const long long* ts_base;
  const int* nvalid;
  unsigned char* t_valid;
  long long* t_first;
  long long* t_last;
  long long* cre_in;
  long long* cre_out;
  long long* matches;
  long long* drops;
  const int4* code;
  unsigned char* y_mask;
  int* y_j;
  long long* y_ts;
};

__device__ long long block_max(long long v, long long* s_red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    long long u = __shfl_down_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  __syncthreads();
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  if (tid == 0) {
    long long m = s_red[0];
    for (int w = 1; w < NWARPS; ++w) m = s_red[w] > m ? s_red[w] : m;
    s_red[NWARPS] = m;
  }
  __syncthreads();
  return s_red[NWARPS];
}

// ------------------------------------------------------ shared memory plan

struct Smem {
  long long *ts, *ev, *tfirst, *tlast, *tbind, *red;
  int *j, *rank, *scan;
  signed char* tag;
  unsigned char *flag, *tvalid;
};

__host__ __device__ inline size_t carve(size_t* off, size_t bytes) {
  const size_t o = *off;
  *off += (bytes + 15) & ~(size_t)15;
  return o;
}

// Shared-memory layout of one stage; fills `sm` when given. Returns bytes.
__host__ __device__ inline size_t smem_layout(const StageArgs& a, Smem* sm,
                                              unsigned char* base) {
  const size_t P = (size_t)a.C + a.pc_in;
  const size_t NP = P > (size_t)a.B ? P : (size_t)a.B;
  const size_t L8 = sizeof(long long), I4 = sizeof(int);
  size_t off = 0;
  const size_t o_ts = carve(&off, L8 * a.B);
  const size_t o_ev = carve(&off, L8 * a.B * a.ncol);
  const size_t o_tfirst = carve(&off, L8 * a.C);
  const size_t o_tlast = carve(&off, L8 * a.C);
  const size_t o_tbind = carve(&off, L8 * a.C * a.nbind);
  const size_t o_red = carve(&off, L8 * (NWARPS + 1));
  const size_t o_j = carve(&off, I4 * NP);
  const size_t o_rank = carve(&off, I4 * NP);
  const size_t o_scan = carve(&off, I4 * (NWARPS + 1));
  const size_t o_tag = carve(&off, a.B);
  const size_t o_flag = carve(&off, NP);
  const size_t o_tvalid = carve(&off, a.C);
  if (sm) {
    sm->ts = (long long*)(base + o_ts);
    sm->ev = (long long*)(base + o_ev);
    sm->tfirst = (long long*)(base + o_tfirst);
    sm->tlast = (long long*)(base + o_tlast);
    sm->tbind = (long long*)(base + o_tbind);
    sm->red = (long long*)(base + o_red);
    sm->j = (int*)(base + o_j);
    sm->rank = (int*)(base + o_rank);
    sm->scan = (int*)(base + o_scan);
    sm->tag = (signed char*)(base + o_tag);
    sm->flag = base + o_flag;
    sm->tvalid = base + o_tvalid;
  }
  return off;
}

// ------------------------------------------------------------- the kernel

__global__ void __launch_bounds__(NTHREADS)
nfa_block_stage_kernel(const StageArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem sm;
  smem_layout(a, &sm, smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l = blockIdx.x;
  const int B = a.B, C = a.C;
  const long long lb = (long long)l * B;

  // ---- stage the lane's batch and (s >= 1) the old table of stage s
  const long long base_ts = a.ts_base[l];
  for (int j = tid; j < B; j += NTHREADS) {
    sm.ts[j] = base_ts + (long long)a.ts[lb + j];
    sm.tag[j] = a.tag[lb + j];
    for (int c = 0; c < a.ncol; ++c)
      sm.ev[(long long)c * B + j] = load_typed(a.col[c], a.col_ty[c], lb + j);
  }
  const long long lc = (long long)l * C;
  if (a.s >= 1) {
    for (int c = tid; c < C; c += NTHREADS) {
      sm.tvalid[c] = a.t_valid[lc + c];
      sm.tfirst[c] = a.t_first[lc + c];
      sm.tlast[c] = a.has_ew ? a.t_last[lc + c] : -1;
      for (int k = 0; k < a.nbind; ++k)
        sm.tbind[k * C + c] = load_typed(a.t_bind[k], a.bind_ty[k], lc + c);
    }
  }
  int nv = a.nvalid[l];
  nv = nv < 0 ? 0 : (nv > B ? B : nv);
  __syncthreads();
  long long tmax = -(1LL << 62);
  for (int j = tid; j < nv; j += NTHREADS) tmax = sm.ts[j] > tmax ? sm.ts[j] : tmax;
  const long long ts_last = block_max(tmax, sm.red);

  long long drop_add = 0;
  const int nf = a.cre_nf;
  const long long cap = a.cre_cap;

  // ---- seeds: the state-0 gate (S == 1 emits it; s == 1 turns it into
  //      the creations entering stage 1)
  if (a.s <= 1) {
    for (int j = tid; j < B; j += NTHREADS) {
      int g = (j < nv) && sm.tag[j] == a.sidx0;
      if (g && a.seed.len)
        g = eval_prog(a.code, a.seed, EvAt{sm.ev, B, j}, NoBind{}) != 0;
      sm.flag[j] = (unsigned char)g;
    }
    __syncthreads();
    if (a.s == 0) {
      const int n = block_rank<NTHREADS>(sm.flag, sm.rank, B, sm.scan);
      for (int j = tid; j < B; j += NTHREADS) {
        a.y_mask[lb + j] = sm.flag[j];
        a.y_j[lb + j] = j;
        a.y_ts[lb + j] = sm.ts[j];
        for (int o = 0; o < a.nout; ++o)
          store_typed(a.out_ptr[o], a.out_ty[o], lb + j,
                      eval_prog(a.code, a.out[o], EvAt{sm.ev, B, j}, NoBind{}));
      }
      if (tid == 0) a.matches[l] += n;
      return;
    }
    long long* ci = a.cre_in + (long long)l * nf * cap;
    if (!a.seed_compact) {
      for (int j = tid; j < B; j += NTHREADS) {
        ci[F_EX * cap + j] = sm.flag[j];
        ci[F_BORN * cap + j] = j;
        ci[F_VB * cap + j] = (j + 1 < nv) ? j + 1 : nv;
        ci[F_FIRST * cap + j] = sm.ts[j];
        ci[F_LAST * cap + j] = sm.ts[j];
        for (int k = 0; k < a.nseed_bind; ++k)
          ci[(F_BIND + k) * cap + j] = sm.ev[(long long)a.seed_col[k] * B + j];
      }
    } else {
      const int n = block_rank<NTHREADS>(sm.flag, sm.rank, B, sm.scan);
      const int K = a.K;
      for (int j = tid; j < B; j += NTHREADS) {
        const int r = sm.rank[j];
        if (r < 0 || r >= K) continue;
        ci[F_EX * cap + r] = 1;
        ci[F_BORN * cap + r] = j;
        ci[F_VB * cap + r] = (j + 1 < nv) ? j + 1 : nv;
        ci[F_FIRST * cap + r] = sm.ts[j];
        ci[F_LAST * cap + r] = sm.ts[j];
        for (int k = 0; k < a.nseed_bind; ++k)
          ci[(F_BIND + k) * cap + r] = sm.ev[(long long)a.seed_col[k] * B + j];
      }
      for (int r = (n < K ? n : K) + tid; r < K; r += NTHREADS) {
        ci[F_EX * cap + r] = 0;
        ci[F_BORN * cap + r] = 0;
        ci[F_VB * cap + r] = 0;
        ci[F_FIRST * cap + r] = -1;
        ci[F_LAST * cap + r] = -1;
        for (int k = 0; k < a.nseed_bind; ++k) ci[(F_BIND + k) * cap + r] = 0;
      }
      if (n > K) drop_add += n - K;
    }
    __syncthreads();
  }

  // ---- candidates: old slots, then creations in born order
  const int P = C + a.pc_in;
  const long long* ci = a.cre_in + (long long)l * nf * cap;
  for (int p = warp; p < P; p += NWARPS) {
    int ex, born, vb;
    long long first, last;
    const long long* bind;
    int bstride;
    if (p < C) {
      ex = sm.tvalid[p]; born = -1; vb = 0;
      first = sm.tfirst[p]; last = sm.tlast[p];
      bind = sm.tbind + p; bstride = C;
    } else {
      const int c = p - C;
      ex = ci[F_EX * cap + c] != 0; born = (int)ci[F_BORN * cap + c];
      vb = (int)ci[F_VB * cap + c];
      first = ci[F_FIRST * cap + c]; last = ci[F_LAST * cap + c];
      bind = ci + F_BIND * cap + c; bstride = (int)cap;
    }
    int adv = 0, jstar = 0;
    if (ex) {
      int lo, hi;                     // events [lo, hi) to test
      if (a.is_seq) { lo = vb; hi = (vb >= 0 && vb < nv) ? vb + 1 : vb; }
      else { lo = born + 1; hi = nv; }
      for (int b0 = lo; b0 < hi; b0 += 32) {
        const int j = b0 + lane;
        int ok = j < hi && sm.tag[j] == a.sidx;
        if (ok && a.has_within) ok = sm.ts[j] - first <= a.within;
        if (ok && a.has_sw) ok = sm.ts[j] - last <= a.sw;
        if (ok && a.pred.len)
          ok = eval_prog(a.code, a.pred, EvAt{sm.ev, B, j}, BindAt{bind, bstride}) != 0;
        const unsigned m = __ballot_sync(0xffffffffu, ok);
        if (m) { adv = 1; jstar = b0 + __ffs(m) - 1; break; }
      }
    }
    if (lane == 0) { sm.flag[p] = (unsigned char)adv; sm.j[p] = jstar; }
  }
  __syncthreads();

  if (a.last) {
    // ---- emission: ys over every candidate
    const long long ly = (long long)l * P;
    for (int p = tid; p < P; p += NTHREADS) {
      const int jstar = sm.j[p];
      a.y_mask[ly + p] = sm.flag[p];
      a.y_j[ly + p] = jstar;
      a.y_ts[ly + p] = sm.ts[jstar];
      const long long* bind = p < C ? sm.tbind + p : ci + F_BIND * cap + (p - C);
      const int bstride = p < C ? C : (int)cap;
      for (int o = 0; o < a.nout; ++o)
        store_typed(a.out_ptr[o], a.out_ty[o], ly + p,
                    eval_prog(a.code, a.out[o], EvAt{sm.ev, B, jstar},
                              BindAt{bind, bstride}));
    }
    const int n = block_rank<NTHREADS>(sm.flag, sm.rank, P, sm.scan);
    if (tid == 0) a.matches[l] += n;
  } else {
    // ---- creations entering stage s+1
    long long* co = a.cre_out + (long long)l * nf * cap;
    int n_adv = 0;
    if (a.compact_out) n_adv = block_rank<NTHREADS>(sm.flag, sm.rank, P, sm.scan);
    const int K = a.K;
    for (int p = tid; p < P; p += NTHREADS) {
      int slot = p;
      if (a.compact_out) {
        slot = sm.rank[p];
        if (slot < 0 || slot >= K) continue;
      }
      const int jstar = sm.j[p];
      const long long first = p < C ? sm.tfirst[p] : ci[F_FIRST * cap + (p - C)];
      co[F_EX * cap + slot] = sm.flag[p];
      co[F_BORN * cap + slot] = jstar;
      co[F_VB * cap + slot] = (jstar + 1 < nv) ? jstar + 1 : nv;
      co[F_FIRST * cap + slot] = first >= 0 ? first : sm.ts[jstar];
      co[F_LAST * cap + slot] = sm.ts[jstar];
      for (int k = 0; k < a.nbind_out; ++k) {
        long long v;
        if (a.bout_kind[k] == 0) {
          const int q = a.bout_idx[k];
          v = p < C ? sm.tbind[q * C + p] : ci[(F_BIND + q) * cap + (p - C)];
        } else {
          v = sm.ev[(long long)a.bout_idx[k] * B + jstar];
        }
        co[(F_BIND + k) * cap + slot] = v;
      }
    }
    if (a.compact_out) {
      for (int r = (n_adv < K ? n_adv : K) + tid; r < K; r += NTHREADS) {
        co[F_EX * cap + r] = 0;
        co[F_BORN * cap + r] = 0;
        co[F_VB * cap + r] = 0;
        co[F_FIRST * cap + r] = -1;
        co[F_LAST * cap + r] = -1;
        for (int k = 0; k < a.nbind_out; ++k) co[(F_BIND + k) * cap + r] = 0;
      }
      if (n_adv > K) drop_add += n_adv - K;
    }
  }
  __syncthreads();

  // ---- survivors → table s, keep-oldest into C slots
  for (int p = tid; p < P; p += NTHREADS) {
    int ex, vb;
    long long first, last;
    if (p < C) { ex = sm.tvalid[p]; vb = 0; first = sm.tfirst[p]; last = sm.tlast[p]; }
    else {
      const int c = p - C;
      ex = ci[F_EX * cap + c] != 0; vb = (int)ci[F_VB * cap + c];
      first = ci[F_FIRST * cap + c]; last = ci[F_LAST * cap + c];
    }
    int surv = ex && !sm.flag[p];
    if (surv && a.has_within) surv = ts_last - first <= a.within;
    if (surv && a.has_sw) surv = ts_last - last <= a.sw;
    if (surv && a.is_seq) surv = vb == nv;
    sm.flag[p] = (unsigned char)surv;      // each p is read and written by one thread
  }
  const int n_surv = block_rank<NTHREADS>(sm.flag, sm.rank, P, sm.scan);
  for (int p = tid; p < P; p += NTHREADS) {
    const int r = sm.rank[p];
    if (r < 0 || r >= C) continue;
    long long first, last;
    if (p < C) { first = sm.tfirst[p]; last = sm.tlast[p]; }
    else { first = ci[F_FIRST * cap + (p - C)]; last = ci[F_LAST * cap + (p - C)]; }
    a.t_valid[lc + r] = 1;
    a.t_first[lc + r] = first;
    if (a.has_ew) a.t_last[lc + r] = last;
    for (int k = 0; k < a.nbind; ++k) {
      const long long v = p < C ? sm.tbind[k * C + p] : ci[(F_BIND + k) * cap + (p - C)];
      store_typed(a.t_bind[k], a.bind_ty[k], lc + r, v);
    }
  }
  for (int r = (n_surv < C ? n_surv : C) + tid; r < C; r += NTHREADS) {
    a.t_valid[lc + r] = 0;
    a.t_first[lc + r] = -1;
    if (a.has_ew) a.t_last[lc + r] = -1;
    for (int k = 0; k < a.nbind; ++k) store_typed(a.t_bind[k], a.bind_ty[k], lc + r, 0);
  }
  if (n_surv > C) drop_add += n_surv - C;
  if (tid == 0 && drop_add) a.drops[l] += drop_add;
}

// ------------------------------------------------------------ C interface

extern "C" int nfa_block_args_size(void) { return (int)sizeof(StageArgs); }

// Launches one stage on `stream`. Returns cudaGetLastError() after the
// launch (0 on success), or -2 when the stage needs more shared memory
// than a block can have.
extern "C" int nfa_block_stage(const StageArgs* args, void* stream) {
  const size_t smem = smem_layout(*args, nullptr, nullptr);
  if (smem > SMEM_LIMIT) return -2;
  cudaError_t e = cudaFuncSetAttribute(
      nfa_block_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  nfa_block_stage_kernel<<<args->L, NTHREADS, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
