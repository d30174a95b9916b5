// Blocked NFA step kernel for Hopper (sm_90a): one launch per step.
//
// Replaces, from the reference JAX package:
//   - tpu/nfa_block.py::make_block_step   (B1: the blocked NFA step)
//   - tpu/expr_compile.py::compile_expression and helpers
//                                           (B2: predicate / output programs,
//                                            here a typed postfix IR run by
//                                            expr_ir.cuh, shared with
//                                            nfa_scan.cu)
//   - tpu/partition.py:160-181             (B3: vmap over lanes, donated
//                                            state: here one cluster of
//                                            CTAs per lane, tables updated
//                                            in place)
//
// What it computes, per lane: the state-0 seed gate, then the stages
// s = 1..S-1 in order (S == 1: the gate is the emission). At stage s the
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
//   overflow counted in drops. Every masked-off value (j* = 0, ts[0],
//   outputs from an empty slot's fill values) is the reference's.
//
// Design:
//   - ONE launch a step: the seed gate and all S-1 stages run in sequence
//     inside the lane's CTAs, a barrier between stages in place of a kernel
//     boundary. A lane is a cluster of CL = 2 CTAs of NT = 512 threads
//     (BlockPlan.CLUSTER), or one CTA where a cluster's plan does not fit in
//     shared memory: both stage the batch and run every phase but the search,
//     which they split; each reads the other's results (flags and j*, kept
//     per stage parity) from its shared memory after a cluster barrier, and
//     the global writes are split between them. Nothing crosses lanes, so
//     counters need no atomics.
//   - the descriptor (BlockDesc + one BlockStage a state), the linked
//     programs and the tables' device pointers are uploaded once per plan
//     (the pointers again only when the state's tensors change) and copied
//     into shared memory at launch; per step the host passes pointers.
//   - the lane's batch is staged once, with 16-byte cp.async copies of the
//     lines that cover each [B] row (ts deltas as int32, tag, every used
//     column in its own width); the old table of stage s+1 is prefetched the
//     same way while stage s searches (double-buffered). A batch too large
//     for shared memory (a large B with several columns) is read where it
//     lies, in the step's input tensors (MODE_BATCH_GLOBAL, the last layout
//     tried); the chunk summaries of the early exit stay in shared memory.
//   - the creations passed between stages stay in shared memory (two
//     buffers of the largest stage's creation count); where they do not fit
//     (no creation cap and a large B), the same kernel keeps them in a
//     global scratch the wrapper allocates once per (plan, L).
//   - first-match search: a warp takes the live candidates of its 32 slots
//     (a ballot skips empty ones); each lane loads its own slot's setup
//     (first, last, [lo, hi), bound values) and the warp then takes the
//     candidates in turn, the setup handed over by shuffles, testing 32
//     consecutive events a round (__ballot_sync/__ffs pick the first hit).
//     Exact early exit: once per step the kernel builds suffix minima of ts
//     over the valid events per chunk of 32; a candidate stops at the first
//     chunk b0 where sufmin[b0] - first > within (or, element-level,
//     sufmin[b0] - last > within(s)): no later event can pass the window
//     there, whether or not ts is sorted. The stage's predicate is resolved
//     once: a conjunction of at most two comparisons (its clause form, read
//     by expr_ir.cuh's decoder) runs from registers, bound values and
//     constants cast once; any other program runs through one out-of-line
//     copy of eval_fast, its code in shared memory.
//   - ordered compactions (creations to K, survivors to C) come from one
//     pass that ranks both flag sets at once: two warp ballots and one
//     cross-warp scan per 512 positions, one barrier each.
//   - the `// phase` comments after barriers mark where
//     tools/profile_nfa_step.py --phases puts clock64() probes in a copy.
//
// What bounds it on the H100: neither bytes nor arithmetic. A main-path
// step (64 lanes x 2048 events, C = 64, K = 320, 8 states) must move about
// 4.5 MB (the event columns, the tables read and written back, the ys),
// about 1.3 us at 3.35 TB/s; its first-match tests are a similar ~1.3 us
// at the f32 rate. The kernel is a chain of dependent phases inside each
// lane: staging, the seed gate, then per stage the search, the rank pass
// and the writes, about three barriers a stage, each a few microseconds of
// dependent shared-memory loads with few warps to hide them. The search of
// the first stages sets the time (~150 live candidates a lane at stage 1,
// each a few rounds); the rest is a floor of ~1.5-2 us a stage. Before this
// design the step was 7 launches (one per stage) and 311 us of device time
// (tools/profile_nfa_step.py --path main, on an NVIDIA H100 80GB HBM3 at
// 700.00 W); PERF.md holds this design's numbers, by the same
// tool, with the card's name and power limit beside them.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXCOL 32
#define MAXB 32
#define MAXOUT 32
#define MAXSTACK 32
#include "expr_ir.cuh"

#include <atomic>

static constexpr int NT = 512;           // threads a CTA
#define SMEM_LIMIT (227 * 1024)
#define FULLW 0xffffffffu
#define I64_MAX 0x7fffffffffffffffLL
#define TS_NONE (-(1LL << 62))

// mode bits, chosen by nfa_block_plan: creations in global scratch; one
// table buffer (no prefetch); the batch read where it lies, in global memory
// (not staged: a lane's batch of a few hundred KB sits in the L2)
#define MODE_CRE_GLOBAL 1
#define MODE_ONE_TABLE 2
#define MODE_BATCH_GLOBAL 4

// One state's stage (s = 0 is the seed gate; its entry is unused for S > 1).
struct BlockStage {
  int sidx, pc_in, compact_out, nbind;   // nbind: bindings carried AT s
  int nbind_out, tp_off, has_sw, pad_;   // tp_off: its table's pointers
  long long sw;
  Prog pred, cpred;                      // cpred: clause form (len 0: none)
  int pad2_[2];                          // 64 bytes: the descriptor copies by 16
};

// The plan's descriptor, followed in memory by S BlockStage entries.
struct BlockDesc {
  int S, B, C, K;                        // K = -1: no creation cap
  int is_seq, has_within, has_ew, seed_compact;
  long long within;
  int sidx0, ncol, nbind_max, nout;
  int cap, ncode, ntp, np;               // cap: creation slots; np: positions
  int col_ty[MAXCOL];
  int key_ty[MAXB];                      // binding k's type, for every stage
  int key_col[MAXB];                     // the column binding k is minted from
  int out_ty[MAXOUT];
  Prog seed, cseed;
  Prog out[MAXOUT];
};

struct BlockArgs {
  int L, mode, cluster, pad_;            // cluster: CTAs a lane (1 or 2)
  const unsigned char* desc;             // device copy of BlockDesc + stages
  const int4* code;
  void* const* tptr;                     // per stage: valid, first, last, binds
  unsigned char* scratch;                // MODE_CRE_GLOBAL: 2 buffers a lane
  const void* col[MAXCOL];
  const signed char* tag;
  const int* ts;
  const long long* ts_base;
  const int* nvalid;
  long long* matches;
  long long* drops;
  unsigned char* y_mask;
  int* y_j;
  long long* y_ts;
  void* out_ptr[MAXOUT];
};

// Byte offsets of the shared-memory plan (computed on the host).
struct Lay {
  int desc, code, tptr, ptrs, ts, tag, cmin, cmax, flag, jst, rk0, rk1, wb, cnt;
  int tab[2], cre[2];
  int col[MAXCOL];
  int tabo[3 + MAXB];                    // fields within a table buffer
  int creo[6];                           // fields within a creation buffer
  int tab_bytes, cre_bytes, nck;
};

// Pointers into the staged rows (each shifted by its source's alignment).
struct Ptrs {
  const int* ts;
  const signed char* tag;
  const unsigned char* col[MAXCOL];
  const unsigned char* tab[2][3 + MAXB];
  long long ts_last;
};

// ------------------------------------------------------ shared memory plan

__host__ __device__ inline int carve(int* off, long long bytes) {
  const int o = *off;
  *off += (int)((bytes + 15) & ~15LL);
  return o;
}

// a row of n bytes staged by 16-byte lines: room for the lines covering it
__host__ __device__ inline long long row_room(long long n) { return n + 32; }

__host__ __device__ inline int ty_size(int ty) {
  return ty == T_BOOL ? 1 : (ty == T_I64 ? 8 : 4);
}

__host__ __device__ inline int desc_head() { return (int)((sizeof(BlockDesc) + 15) & ~(size_t)15); }

__host__ __device__ inline int desc_bytes(int S) {
  return desc_head() + S * (int)sizeof(BlockStage);
}

__host__ __device__ inline const BlockStage* stages_of(const BlockDesc* d) {
  return (const BlockStage*)((const unsigned char*)d + desc_head());
}

// The plan for `d` under `mode` with `cl` CTAs a lane; returns its bytes.
__host__ __device__ inline int smem_layout(const BlockDesc& d, int mode, int cl, Lay* y) {
  const long long B = d.B, C = d.C, cap = d.cap;
  const int nw = NT / 32;
  int off = 0;
  // creation buffer fields: ex, born, vb, first, last, bindings
  int co = 0;
  y->creo[0] = carve(&co, cap);
  y->creo[1] = carve(&co, 4 * cap);
  y->creo[2] = carve(&co, 4 * cap);
  y->creo[3] = carve(&co, 8 * cap);
  y->creo[4] = carve(&co, d.has_ew ? 8 * cap : 0);
  y->creo[5] = carve(&co, 8 * cap * d.nbind_max);
  y->cre_bytes = co;
  // table buffer fields: valid, first, last, bindings
  int to = 0;
  y->tabo[0] = carve(&to, row_room(C));
  y->tabo[1] = carve(&to, row_room(8 * C));
  y->tabo[2] = carve(&to, d.has_ew ? row_room(8 * C) : 0);
  for (int k = 0; k < MAXB; ++k)
    y->tabo[3 + k] = k < d.nbind_max ? carve(&to, row_room(C * ty_size(d.key_ty[k]))) : to;
  y->tab_bytes = to;
  y->nck = (int)((B + 31) / 32);
  y->desc = carve(&off, desc_bytes(d.S));
  y->code = carve(&off, 16LL * d.ncode);
  y->tptr = carve(&off, 8LL * d.ntp);
  y->ptrs = carve(&off, sizeof(Ptrs));
  const bool staged = !(mode & MODE_BATCH_GLOBAL);
  y->ts = carve(&off, staged ? row_room(4 * B) : 0);
  y->tag = carve(&off, staged ? row_room(B) : 0);
  for (int c = 0; c < MAXCOL; ++c)
    y->col[c] = c < d.ncol && staged ? carve(&off, row_room(B * ty_size(d.col_ty[c]))) : off;
  y->cmin = carve(&off, 8LL * y->nck);
  y->cmax = carve(&off, 8LL * y->nck);
  y->tab[0] = carve(&off, d.S > 1 ? y->tab_bytes : 0);
  y->tab[1] = (mode & MODE_ONE_TABLE) ? y->tab[0] : carve(&off, d.S > 1 ? y->tab_bytes : 0);
  const bool in_smem = d.S > 1 && !(mode & MODE_CRE_GLOBAL);
  y->cre[0] = carve(&off, in_smem ? y->cre_bytes : 0);
  y->cre[1] = carve(&off, in_smem ? y->cre_bytes : 0);
  const int nfb = cl > 1 ? 2 : 1;         // a cluster's flags alternate by stage
  y->flag = carve(&off, (long long)nfb * d.np);
  y->jst = carve(&off, 4LL * nfb * d.np);
  y->rk0 = carve(&off, 4LL * d.np);
  y->rk1 = carve(&off, 4LL * d.np);
  y->wb = carve(&off, 8LL * nw * (d.nbind_max > 0 ? d.nbind_max : 1));
  y->cnt = carve(&off, 4LL * 2 * 2 * nw);
  return off;
}

// ------------------------------------------------------------- staging

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  const unsigned char* f = (const unsigned char*)src;
  unsigned char* t = (unsigned char*)dst;
  for (int i = 0; i < 16; ++i) t[i] = f[i];
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// A lane's cluster of CTAs (one CTA a lane where the cluster is 1): its
// rank, its barrier (release/acquire over the cluster's shared memory) and
// a CTA's view of another's shared memory.
__device__ __forceinline__ unsigned cluster_rank() {
#if defined(__CUDA_ARCH__)
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
#else
  return 0;
#endif
}
__device__ __forceinline__ void cluster_sync() {
#if defined(__CUDA_ARCH__)
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
#endif
}
template <class T>
__device__ __forceinline__ T* cluster_map(T* p, unsigned rank) {
#if defined(__CUDA_ARCH__)
  unsigned long long r;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(r) : "l"((unsigned long long)p), "r"(rank));
  return (T*)r;
#else
  return p;
#endif
}

// Starts copies of the 16-byte lines covering bytes [src, src + n) into dst
// (16-aligned shared memory, row_room(n) bytes); returns where src's first
// byte lands. A tensor's allocation is 512-byte granular, so the covering
// lines lie inside it.
__device__ __forceinline__ const unsigned char* stage_row(unsigned char* dst, const void* src,
                                                          long long n) {
  const uintptr_t a = (uintptr_t)src, w0 = a & ~(uintptr_t)15;
  const uintptr_t w1 = (a + (uintptr_t)n + 15) & ~(uintptr_t)15;
  const int nl = (int)((w1 - w0) >> 4);
  for (int i = threadIdx.x; i < nl; i += NT)
    cp_async16(dst + 16 * i, (const void*)(w0 + 16 * (uintptr_t)i));
  return dst + (a - w0);
}

// Starts the copies of lane l's rows of stage `st`'s table into `buf`;
// thread 0 records where each field lands in `out`.
__device__ void stage_table(const BlockDesc& d, const BlockStage& st, void* const* tptr,
                            const Lay& y, int l, unsigned char* buf,
                            const unsigned char** out) {
  const long long lc = (long long)l * d.C;
  void* const* tp = tptr + st.tp_off;
  const unsigned char* valid =
      stage_row(buf + y.tabo[0], (const unsigned char*)tp[0] + lc, d.C);
  const unsigned char* first =
      stage_row(buf + y.tabo[1], (const unsigned char*)tp[1] + 8 * lc, 8LL * d.C);
  const unsigned char* last =
      d.has_ew ? stage_row(buf + y.tabo[2], (const unsigned char*)tp[2] + 8 * lc, 8LL * d.C)
               : nullptr;
  if (threadIdx.x == 0) { out[0] = valid; out[1] = first; out[2] = last; }
  for (int k = 0; k < st.nbind; ++k) {
    const int sz = ty_size(d.key_ty[k]);
    const unsigned char* q = stage_row(buf + y.tabo[3 + k],
                                           (const unsigned char*)tp[3 + k] + sz * lc,
                                           (long long)sz * d.C);
    if (threadIdx.x == 0) out[3 + k] = q;
  }
}

// --------------------------------------------------------------- helpers

// A lane's creations, structure of arrays (binding k of entry c at
// bind[k * cap + c]).
struct Cre {
  unsigned char* ex;
  int *born, *vb;
  long long *first, *last, *bind;
  int cap;
  __device__ Cre(unsigned char* b, const Lay& y, int cap_)
      : ex(b + y.creo[0]), born((int*)(b + y.creo[1])), vb((int*)(b + y.creo[2])),
        first((long long*)(b + y.creo[3])), last((long long*)(b + y.creo[4])),
        bind((long long*)(b + y.creo[5])), cap(cap_) {}
  __device__ void fill(int r, int nb, bool ew) {
    ex[r] = 0; born[r] = 0; vb[r] = 0; first[r] = -1;
    if (ew) last[r] = -1;
    for (int k = 0; k < nb; ++k) bind[(long long)k * cap + r] = 0;
  }
};

// Ordered ranks of two flag sets over positions [0, n): r0[i] (r1[i]) is
// the number of set first (second) flags before i, -1 where unset; returns
// both totals to every thread. flags(i) gives (f0, f1) for position i, the
// positions of a thread being tid, tid + NT, ... (later passes read a rank
// in the thread that wrote it). One barrier per NT positions; cnt holds
// 4 * NT / 32 ints; the caller has a barrier since cnt's last use.
template <class F>
__device__ __forceinline__ int2 rank2(int n, F flags, int* r0, int* r1, int* cnt) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int c0 = 0, c1 = 0, par = 0;
  for (int base = 0; base < n; base += NT, par ^= 1) {
    const int i = base + tid;
    const int2 f = i < n ? flags(i) : make_int2(0, 0);
    const unsigned m0 = __ballot_sync(FULLW, f.x), m1 = __ballot_sync(FULLW, f.y);
    int* cw = cnt + par * 2 * NW;
    if (lane == 0) { cw[warp] = __popc(m0); cw[NW + warp] = __popc(m1); }
    __syncthreads();
    // an inclusive scan of the warps' counts across the lanes of every warp
    int a = lane < NW ? cw[lane] : 0, b = lane < NW ? cw[NW + lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int ua = __shfl_up_sync(FULLW, a, o), ub = __shfl_up_sync(FULLW, b, o);
      if (lane >= o) { a += ua; b += ub; }
    }
    const int e0 = warp ? __shfl_sync(FULLW, a, warp - 1) : 0;
    const int e1 = warp ? __shfl_sync(FULLW, b, warp - 1) : 0;
    const int t0 = __shfl_sync(FULLW, a, NW - 1), t1 = __shfl_sync(FULLW, b, NW - 1);
    if (i < n) {
      r0[i] = f.x ? c0 + e0 + __popc(m0 & lt) : -1;
      r1[i] = f.y ? c1 + e1 + __popc(m1 & lt) : -1;
    }
    c0 += t0; c1 += t1;
  }
  return make_int2(c0, c1);
}

struct NoBind {
  __device__ long long operator()(int) const { return 0; }
};
// bound values from a row of value slots (a warp's candidate)
struct RowBind {
  const long long* w;
  __device__ long long operator()(int k) const { return w[k]; }
};
// bound values of candidate p: its old table slot or its creation entry
struct CandBind {
  const unsigned char* const* tab;
  const int* key_ty;
  const long long* cbind;
  int cap, p, C;
  __device__ long long operator()(int k) const {
    return p < C ? load_typed(tab[3 + k], key_ty[k], p) : cbind[(long long)k * cap + (p - C)];
  }
};

// The interpreter for a program at event j over the staged columns. One
// copy per kind of bindings: not inlined, so the hot loops stay small.
template <class BindF>
__device__ __noinline__ long long eval_at(const int4* code, Prog p, const Ptrs* P,
                                          const int* col_ty, int j, BindF bind) {
  return eval_fast(code, p, [P, col_ty, j](int c) { return load_typed(P->col[c], col_ty[c], j); },
                   bind);
}

// A clause operand with what is fixed for a candidate resolved: an event
// column (its staged row and type, then the cast) or a value (a bound value
// or a constant, through expr_ir.cuh's clause_operand, already cast; the
// cast kept for a candidate's own bound value).
struct Opnd {
  const unsigned char* p;          // nullptr: the value v
  long long v;
  int ty, cast;
};

__device__ __forceinline__ long long opnd_at(const Opnd& o, int j) {
  return o.p ? cast_opt(load_typed(o.p, o.ty, j), o.cast) : o.v;
}

template <class BindF>
__device__ __forceinline__ Opnd opnd(const int4* code, int kind, int idx, int cast,
                                     const Ptrs& P, const BlockDesc& d, BindF bind) {
  if (kind == OP_EV) return Opnd{P.col[idx], 0, d.col_ty[idx], cast};
  return Opnd{nullptr, clause_operand(code, kind, idx, cast, NoBind{}, bind), T_I64, cast};
}

// A predicate in clause form of at most MAXPC clauses, resolved for one
// candidate and held in registers: the search tests an event with a load
// per event column and the compares. nc = 0: no predicate (true); nc = -1:
// no clause form that small (the interpreter runs it).
#define MAXPC 2
struct Pred {
  int nc;
  int op[MAXPC], cty[MAXPC];
  Opnd x[MAXPC], y[MAXPC];
  int xb[MAXPC], yb[MAXPC];        // the binding a bound operand reads (-1: none)
  __device__ __forceinline__ bool at(int j) const {
#pragma unroll
    for (int i = 0; i < MAXPC; ++i)
      if (i < nc && !compare(op[i], cty[i], opnd_at(x[i], j), opnd_at(y[i], j))) return false;
    return true;
  }
};

// Resolves program p (clause form cp) with the bound values bind gives.
template <class BindF>
__device__ __forceinline__ Pred prepare(const int4* code, Prog p, Prog cp, const Ptrs& P,
                                        const BlockDesc& d, BindF bind) {
  Pred r;
  r.nc = p.len == 0 ? 0 : (cp.len > 0 && cp.len <= MAXPC ? cp.len : -1);
#pragma unroll
  for (int i = 0; i < MAXPC; ++i) {
    r.op[i] = OP_EQ;
    r.cty[i] = T_I64;
    r.x[i] = r.y[i] = Opnd{nullptr, 0, T_I64, -1};
    r.xb[i] = r.yb[i] = -1;
    if (i < r.nc) {
      const Clause c = clause_at(code, cp, i);
      r.op[i] = c.op;
      r.cty[i] = c.ty;
      r.x[i] = opnd(code, c.xk, c.xi, c.xc, P, d, bind);
      r.y[i] = opnd(code, c.yk, c.yi, c.yc, P, d, bind);
      if (c.xk == OP_BIND) r.xb[i] = c.xi;
      if (c.yk == OP_BIND) r.yb[i] = c.yi;
    }
  }
  return r;
}

// Runs scan(holds), holds(j) the predicate at event j: the resolved clauses
// where pr has that form, else general(j), the interpreter. The seed gate
// and every stage's search take their test from here; each form gets its
// own instantiation of scan, so a loop holds only its own test.
template <class ScanF, class GenF>
__device__ __forceinline__ auto with_pred(const Pred& pr, ScanF scan, GenF general) {
  if (pr.nc >= 0) return scan([&](int j) { return pr.at(j); });
  return scan(general);
}

// A candidate's search setup, loaded by the lane that holds its slot and
// handed to the warp by shuffles (no chain of dependent loads a candidate).
struct Cand {
  long long first, lst, bv[2 * MAXPC];   // bv: its bound operands' values
  int lo, hi;                            // the events [lo, hi) it may take
};

__device__ __forceinline__ Cand shfl_cand(const Cand& c, int src) {
  Cand r;
  r.first = __shfl_sync(FULLW, c.first, src);
  r.lst = __shfl_sync(FULLW, c.lst, src);
  r.lo = __shfl_sync(FULLW, c.lo, src);
  r.hi = __shfl_sync(FULLW, c.hi, src);
#pragma unroll
  for (int i = 0; i < 2 * MAXPC; ++i) r.bv[i] = __shfl_sync(FULLW, c.bv[i], src);
  return r;
}

// ------------------------------------------------------------- the kernel

template <int CL>
__global__ void __launch_bounds__(NT, 1)
nfa_block_kernel(const __grid_constant__ BlockArgs a, const __grid_constant__ Lay y) {
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, l = blockIdx.x / CL;
  // with a cluster of CL CTAs a lane, each searches its share of the
  // candidates; the rest runs in every CTA, the global writes split
  const int crank = CL > 1 ? (int)cluster_rank() : 0;

  // ---- the descriptor, the programs and the table pointers
  {
    const BlockDesc* gd = (const BlockDesc*)a.desc;
    const int nd = desc_bytes(gd->S) / 16, nc = gd->ncode, ntp = gd->ntp;
    int4* dd = (int4*)(smem_raw + y.desc);
    for (int i = tid; i < nd; i += NT) dd[i] = ((const int4*)a.desc)[i];
    int4* cd = (int4*)(smem_raw + y.code);
    for (int i = tid; i < nc; i += NT) cd[i] = a.code[i];
    void** td = (void**)(smem_raw + y.tptr);
    for (int i = tid; i < ntp; i += NT) td[i] = a.tptr[i];
  }
  __syncthreads();                   // phase 0: descriptor
  const BlockDesc& d = *(const BlockDesc*)(smem_raw + y.desc);
  const BlockStage* st = stages_of(&d);
  const int4* code = (const int4*)(smem_raw + y.code);
  void* const* tptr = (void* const*)(smem_raw + y.tptr);
  Ptrs& P = *(Ptrs*)(smem_raw + y.ptrs);
  long long* cmin = (long long*)(smem_raw + y.cmin);
  long long* cmax = (long long*)(smem_raw + y.cmax);
  unsigned char* const flags = smem_raw + y.flag;
  int* const jsts = (int*)(smem_raw + y.jst);
  int* rk0 = (int*)(smem_raw + y.rk0);
  int* rk1 = (int*)(smem_raw + y.rk1);
  int* cnt = (int*)(smem_raw + y.cnt);
  const int B = d.B, C = d.C, S = d.S;
  const bool two_tables = !(a.mode & MODE_ONE_TABLE);
  const long long lb = (long long)l * B, lc = (long long)l * C;

  // ---- stage the lane's batch (and stage 1's table); MODE_BATCH_GLOBAL
  //      reads the batch from the step's input tensors instead
  if (a.mode & MODE_BATCH_GLOBAL) {
    if (tid == 0) {
      P.ts = a.ts + lb;
      P.tag = a.tag + lb;
      for (int c = 0; c < d.ncol; ++c)
        P.col[c] = (const unsigned char*)a.col[c] + ty_size(d.col_ty[c]) * lb;
    }
  } else {
    const unsigned char* q = stage_row(smem_raw + y.ts, a.ts + lb, 4LL * B);
    if (tid == 0) P.ts = (const int*)q;
    q = stage_row(smem_raw + y.tag, a.tag + lb, B);
    if (tid == 0) P.tag = (const signed char*)q;
    for (int c = 0; c < d.ncol; ++c) {
      const int sz = ty_size(d.col_ty[c]);
      q = stage_row(smem_raw + y.col[c], (const unsigned char*)a.col[c] + sz * lb,
                        (long long)sz * B);
      if (tid == 0) P.col[c] = q;
    }
  }
  if (S > 1 && two_tables) stage_table(d, st[1], tptr, y, l, smem_raw + y.tab[1], P.tab[1]);
  cp_async_commit();
  cp_async_wait_all();
  int nv = a.nvalid[l];
  nv = nv < 0 ? 0 : (nv > B ? B : nv);
  const long long base = a.ts_base[l];
  __syncthreads();                   // phase 1: batch staged
  const int* ts32 = P.ts;
  const signed char* tag = P.tag;
  auto tsj = [&](int j) { return base + (long long)ts32[j]; };
  auto evj = [&](int c, int j) { return load_typed(P.col[c], d.col_ty[c], j); };

  // ---- per chunk of 32 events: the minimum and maximum ts over the valid
  //      ones; then suffix minima over chunks and ts_last
  for (int k = warp; k < y.nck; k += NW) {
    const int j = 32 * k + lane;
    const bool v = j < nv;
    const long long t = v ? tsj(j) : 0;
    const long long mn = warp_min(v ? t : I64_MAX), mx = warp_max(v ? t : TS_NONE);
    if (lane == 0) { cmin[k] = mn; cmax[k] = mx; }
  }
  __syncthreads();
  if (warp == 0) {
    long long carry = I64_MAX, mx = TS_NONE;
    for (int g = ((y.nck - 1) / 32) * 32; g >= 0; g -= 32) {
      const int k = g + lane;
      long long v = k < y.nck ? cmin[k] : I64_MAX;
      const long long m = k < y.nck ? cmax[k] : TS_NONE;
      mx = m > mx ? m : mx;
      for (int o = 1; o < 32; o <<= 1) {
        const long long u = __shfl_down_sync(FULLW, v, o);
        if (lane + o < 32) v = u < v ? u : v;
      }
      v = carry < v ? carry : v;
      if (k < y.nck) cmin[k] = v;
      carry = __shfl_sync(FULLW, v, 0);
    }
    mx = warp_max(mx);
    if (lane == 0) P.ts_last = mx;
  }
  __syncthreads();                   // phase 2: suffix minima
  const long long ts_last = P.ts_last;

  long long match_add = 0, drop_add = 0;        // thread 0's
  const int cap = d.cap;
  auto cre_buf = [&](int b) {
    unsigned char* p = (a.mode & MODE_CRE_GLOBAL)
                           ? a.scratch + (((long long)l * CL + crank) * 2 + b) * y.cre_bytes
                           : smem_raw + y.cre[b];
    return Cre(p, y, cap);
  };
  const Pred seed = prepare(code, d.seed, d.cseed, P, d, NoBind{});
  auto gate = [&](int j) {
    return (j < nv) && tag[j] == d.sidx0 && with_pred(seed, [&](auto holds) {
      return holds(j);
    }, [&](int e) { return eval_at(code, d.seed, &P, d.col_ty, e, NoBind{}) != 0; });
  };

  // ---- S == 1: the seed gate is the emission
  if (S == 1) {
    const int2 n = rank2(B, [&](int j) { return make_int2(gate(j), 0); }, rk0, rk1, cnt);
    for (int j = tid + crank * NT; j < B; j += CL * NT) {
      a.y_mask[lb + j] = rk0[j] >= 0;
      a.y_j[lb + j] = j;
      a.y_ts[lb + j] = tsj(j);
      for (int o = 0; o < d.nout; ++o)
        store_typed(a.out_ptr[o], d.out_ty[o], lb + j,
                    eval_at(code, d.out[o], &P, d.col_ty, j, NoBind{}));
    }
    if (tid == 0 && crank == 0) a.matches[l] += n.x;
    return;
  }

  // ---- seeds: the creations entering stage 1 (buffer 1)
  {
    Cre co = cre_buf(1);
    const int nsb = st[1].nbind;
    auto put = [&](int r, int j, int ex) {
      co.ex[r] = (unsigned char)ex;
      co.born[r] = j;
      co.vb[r] = (j + 1 < nv) ? j + 1 : nv;
      co.first[r] = tsj(j);
      if (d.has_ew) co.last[r] = tsj(j);
      for (int k = 0; k < nsb; ++k) co.bind[(long long)k * cap + r] = evj(d.key_col[k], j);
    };
    if (!d.seed_compact) {
      for (int j = tid; j < B; j += NT) put(j, j, gate(j));
    } else {
      const int2 n = rank2(B, [&](int j) { return make_int2(gate(j), 0); }, rk0, rk1, cnt);
      const int K = d.K;
      for (int j = tid; j < B; j += NT) {
        const int r = rk0[j];
        if (r >= 0 && r < K) put(r, j, 1);
      }
      for (int r = (n.x < K ? n.x : K) + tid; r < K; r += NT) co.fill(r, nsb, d.has_ew);
      if (n.x > K) drop_add += n.x - K;
    }
  }
  if (!two_tables) stage_table(d, st[1], tptr, y, l, smem_raw + y.tab[0], P.tab[0]);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();                   // phase 3: seeds

  // ---- the stages
  long long* wb = (long long*)(smem_raw + y.wb) + warp * (d.nbind_max > 0 ? d.nbind_max : 1);
  for (int s = 1; s < S; ++s) {
    const BlockStage& sd = st[s];
    const bool last = s == S - 1;
    const int tb = two_tables ? (s & 1) : 0;
    const unsigned char* const* tab = P.tab[tb];
    Cre ci = cre_buf(s & 1);
    Cre co = cre_buf((s + 1) & 1);
    const int P_ = C + sd.pc_in, nb = sd.nbind;
    unsigned char* const flag = flags + (CL > 1 ? (s & 1) * d.np : 0);
    int* const jst = jsts + (CL > 1 ? (s & 1) * d.np : 0);
    if (two_tables && !last)           // the next stage's table, while this one runs
      stage_table(d, st[s + 1], tptr, y, l, smem_raw + y.tab[(s + 1) & 1],
                      P.tab[(s + 1) & 1]);
    cp_async_commit();

    auto first_of = [&](int p) {
      return p < C ? ((const long long*)tab[1])[p] : ci.first[p - C];
    };
    auto last_of = [&](int p) {
      if (!d.has_ew) return -1LL;
      return p < C ? ((const long long*)tab[2])[p] : ci.last[p - C];
    };
    auto bind_of = [&](int p, int k) {
      return p < C ? load_typed(tab[3 + k], d.key_ty[k], p)
                   : ci.bind[(long long)k * cap + (p - C)];
    };
    auto exists = [&](int p) { return p < C ? tab[0][p] != 0 : ci.ex[p - C] != 0; };

    // -- first-match search: warp w (of the cluster's CL * NW) takes the
    //    live candidates among slots w + CL * NW * lane (+ CL * NT ...),
    //    one at a time, 32 events a round; a chunk whose suffix minimum of
    //    ts lies outside the window ends it. The predicate is resolved once
    //    for the stage; a candidate fills in its bound values.
    const int sidx = sd.sidx, has_within = d.has_within, has_sw = sd.has_sw;
    const long long within = d.within, sw = sd.sw;
    const Pred pt = prepare(code, sd.pred, sd.cpred, P, d, NoBind{});
    for (int p0 = crank * NW + warp; p0 < P_; p0 += CL * NT) {
      const int pl = p0 + CL * NW * lane;
      const int ex = pl < P_ && exists(pl);
      unsigned m = __ballot_sync(FULLW, ex);
      if (pl < P_ && !ex) { flag[pl] = 0; jst[pl] = 0; }
      Cand c{};
      if (ex) {                         // each lane its own slot's candidate
        c.first = first_of(pl);
        c.lst = last_of(pl);
        const int born = pl < C ? -1 : ci.born[pl - C], vb = pl < C ? 0 : ci.vb[pl - C];
        if (d.is_seq) { c.lo = vb; c.hi = (vb >= 0 && vb < nv) ? vb + 1 : vb; }
        else { c.lo = born + 1; c.hi = nv; }
        if (c.lo < 0) c.lo = 0;
#pragma unroll
        for (int i = 0; i < MAXPC; ++i) {
          if (pt.xb[i] >= 0) c.bv[2 * i] = cast_opt(bind_of(pl, pt.xb[i]), pt.x[i].cast);
          if (pt.yb[i] >= 0) c.bv[2 * i + 1] = cast_opt(bind_of(pl, pt.yb[i]), pt.y[i].cast);
        }
      }
      while (m) {                       // then the warp takes them in turn
        const int i = __ffs(m) - 1;
        m &= m - 1;
        const int p = p0 + CL * NW * i;
        const Cand k = shfl_cand(c, i);
        Pred r = pt;
#pragma unroll
        for (int q = 0; q < MAXPC; ++q) {
          if (pt.xb[q] >= 0) r.x[q].v = k.bv[2 * q];
          if (pt.yb[q] >= 0) r.y[q].v = k.bv[2 * q + 1];
        }
        if (r.nc < 0) {                 // the interpreter reads a row of them
          __syncwarp();                 // the row's last reader is done
          if (lane < nb) wb[lane] = bind_of(p, lane);
          __syncwarp();
        }
        const int2 got = with_pred(r, [&](auto holds) {
          for (int b0 = k.lo & ~31; b0 < k.hi; b0 += 32) {
            const long long smin = cmin[b0 >> 5];   // no event from b0 on is earlier
            if ((has_within && smin - k.first > within) || (has_sw && smin - k.lst > sw)) break;
            const int j = b0 + lane;
            int ok = j >= k.lo && j < k.hi && tag[j] == sidx;
            if (ok && has_within) ok = tsj(j) - k.first <= within;
            if (ok && has_sw) ok = tsj(j) - k.lst <= sw;
            if (ok) ok = holds(j);
            const unsigned hit = __ballot_sync(FULLW, ok);
            if (hit) return make_int2(1, b0 + __ffs(hit) - 1);
          }
          return make_int2(0, 0);
        }, [&](int j) { return eval_at(code, sd.pred, &P, d.col_ty, j, RowBind{wb}) != 0; });
        if (lane == 0) { flag[p] = (unsigned char)got.x; jst[p] = got.y; }
      }
    }
    if (CL > 1) cluster_sync();
    else __syncthreads();            // phase 4 of stage s: search
    if (CL > 1) {                    // the other CTA's results, from its memory
      const unsigned other = crank ^ 1;
      const unsigned char* rflag = cluster_map(flag, other);
      const int* rjst = cluster_map(jst, other);
      for (int p = tid; p < P_; p += NT)
        if ((p % (CL * NW)) / NW != crank) { flag[p] = rflag[p]; jst[p] = rjst[p]; }
    }

    // -- ranks: advanced candidates (creations / matches), survivors
    const bool compact = sd.compact_out != 0;
    const int2 n = rank2(P_, [&](int p) {
      const int adv = flag[p];
      int surv = exists(p) && !adv;
      if (surv && d.has_within) surv = ts_last - first_of(p) <= d.within;
      if (surv && sd.has_sw) surv = ts_last - last_of(p) <= sd.sw;
      if (surv && d.is_seq) surv = (p < C ? 0 : ci.vb[p - C]) == nv;
      return make_int2(adv, surv);
    }, rk0, rk1, cnt);

    if (last) {
      // -- emission: ys over every candidate
      const long long ly = (long long)l * P_;
      for (int p = tid + crank * NT; p < P_; p += CL * NT) {
        const int jstar = jst[p];
        a.y_mask[ly + p] = flag[p];
        a.y_j[ly + p] = jstar;
        a.y_ts[ly + p] = tsj(jstar);
        const CandBind cb{tab, d.key_ty, ci.bind, cap, p, C};
        for (int o = 0; o < d.nout; ++o) {
          const Prog op = d.out[o];       // one operand: its value, as eval_fast
          const int4 in = code[op.off];
          const long long v = op.len == 1 && in.x == OP_BIND ? cb(in.z)
                            : op.len == 1 && in.x == OP_EV ? evj(in.z, jstar)
                            : eval_at(code, op, &P, d.col_ty, jstar, cb);
          store_typed(a.out_ptr[o], d.out_ty[o], ly + p, v);
        }
      }
      match_add += n.x;
    } else {
      // -- creations entering stage s+1
      const int K = d.K, nbo = sd.nbind_out;
      for (int p = tid; p < P_; p += NT) {
        const int slot = compact ? rk0[p] : p;
        if (slot < 0 || (compact && slot >= K)) continue;
        const int jstar = jst[p];
        const long long f = first_of(p);
        co.ex[slot] = flag[p];
        co.born[slot] = jstar;
        co.vb[slot] = (jstar + 1 < nv) ? jstar + 1 : nv;
        co.first[slot] = f >= 0 ? f : tsj(jstar);
        if (d.has_ew) co.last[slot] = tsj(jstar);
        for (int k = 0; k < nbo; ++k)
          co.bind[(long long)k * cap + slot] = k < nb ? bind_of(p, k) : evj(d.key_col[k], jstar);
      }
      if (compact) {
        for (int r = (n.x < K ? n.x : K) + tid; r < K; r += NT) co.fill(r, nbo, d.has_ew);
        if (n.x > K) drop_add += n.x - K;
      }
    }

    // -- survivors → table s, keep-oldest into C slots
    {
      void* const* tp = tptr + sd.tp_off;
      for (int p = tid + crank * NT; p < P_; p += CL * NT) {
        const int r = rk1[p];
        if (r < 0 || r >= C) continue;
        ((unsigned char*)tp[0])[lc + r] = 1;
        ((long long*)tp[1])[lc + r] = first_of(p);
        if (d.has_ew) ((long long*)tp[2])[lc + r] = last_of(p);
        for (int k = 0; k < nb; ++k) store_typed(tp[3 + k], d.key_ty[k], lc + r, bind_of(p, k));
      }
      for (int r = (n.y < C ? n.y : C) + tid + crank * NT; r < C; r += CL * NT) {
        ((unsigned char*)tp[0])[lc + r] = 0;
        ((long long*)tp[1])[lc + r] = -1;
        if (d.has_ew) ((long long*)tp[2])[lc + r] = -1;
        for (int k = 0; k < nb; ++k) store_typed(tp[3 + k], d.key_ty[k], lc + r, 0);
      }
      if (n.y > C) drop_add += n.y - C;
    }
    if (!two_tables && !last) {
      __syncthreads();                 // every read of the one table buffer is done
      stage_table(d, st[s + 1], tptr, y, l, smem_raw + y.tab[0], P.tab[0]);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();                 // phase 5 of stage s: ranks, writes
  }
  if (tid == 0 && crank == 0) {
    if (match_add) a.matches[l] += match_add;
    if (drop_add) a.drops[l] += drop_add;
  }
  if (CL > 1) cluster_sync();        // the other CTA may still read this one's flags
}

// ------------------------------------------------------------ C interface

extern "C" int nfa_block_desc_head(void) { return desc_head(); }
extern "C" int nfa_block_stage_size(void) { return (int)sizeof(BlockStage); }
extern "C" int nfa_block_args_size(void) { return (int)sizeof(BlockArgs); }
extern "C" int nfa_block_ptrs_size(void) { return (int)sizeof(Ptrs); }

// The layout mode for a plan (`desc`: BlockDesc + stages, host memory) with
// `cluster` CTAs a lane: with batch_global == 0, creations and two table
// buffers in shared memory where they fit, else creations in global scratch,
// else also one table buffer; with batch_global != 0, only the mode that also
// leaves the batch in global memory. The host tries every cluster size with
// batch_global == 0 first, so a plan that fits without it keeps its layout.
// Writes the mode and the scratch bytes a lane needs (0 when the creations
// stay in shared memory); returns 0, or -2 when no mode fits.
// gpu/nfa_block.py::block_layout mirrors this and smem_layout, and refuses a
// plan that fits no mode when it is built.
extern "C" int nfa_block_plan(const unsigned char* desc, int cluster, int batch_global,
                              int* mode, long long* scratch_per_lane) {
  const BlockDesc& d = *(const BlockDesc*)desc;
  const int modes[4] = {0, MODE_CRE_GLOBAL, MODE_CRE_GLOBAL | MODE_ONE_TABLE,
                        MODE_CRE_GLOBAL | MODE_ONE_TABLE | MODE_BATCH_GLOBAL};
  for (int i = batch_global ? 3 : 0; i < (batch_global ? 4 : 3); ++i) {
    Lay y;
    if (smem_layout(d, modes[i], cluster, &y) <= SMEM_LIMIT) {
      *mode = modes[i];
      *scratch_per_lane =
          (modes[i] & MODE_CRE_GLOBAL) && d.S > 1 ? 2LL * cluster * y.cre_bytes : 0;
      return 0;
    }
  }
  return -2;
}

template <int CL>
static int launch(const BlockArgs* args, const BlockDesc& d, void* stream) {
  // cudaFuncSetAttribute holds for the current device: the largest dynamic
  // shared memory a block may have is allowed once per device (a bit each)
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(nfa_block_kernel<CL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    allowed.fetch_or(bit, std::memory_order_acq_rel);
  }
  Lay y;
  const int smem = smem_layout(d, args->mode, CL, &y);
  if (smem > SMEM_LIMIT) return -2;
  if (CL == 1) {
    nfa_block_kernel<CL><<<args->L, NT, smem, (cudaStream_t)stream>>>(*args, y);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(args->L * CL);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = CL;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, nfa_block_kernel<CL>, *args, y);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// Launches one step on `stream` (`desc`: the host copy of the descriptor
// args->desc points to) with args->cluster CTAs a lane (2, or 1 where
// nfa_block_plan found no room for a cluster). Returns cudaGetLastError()
// after the launch (0 on success), or -2 when the mode's plan needs more
// shared memory than a block can have.
extern "C" int nfa_block_step(const BlockArgs* args, const unsigned char* desc, void* stream) {
  const BlockDesc& d = *(const BlockDesc*)desc;
  return args->cluster == 2 ? launch<2>(args, d, stream) : launch<1>(args, d, stream);
}
