// Per-event scan NFA step kernel for Hopper (sm_90a).
//
// Replaces, from the reference JAX package:
//   - tpu/nfa.py::DeviceNFACompiler._make_step -> step_event under lax.scan
//     (B4: the per-event NFA for count, logical and absent states,
//     sequences, group and mid-pattern `every`)
//   - tpu/partition.py:160-181 for that step (vmap over lanes, donated
//     state: here one warp per lane, tables updated in place)
// and evaluates predicates and outputs through B2's IR (expr_ir.cuh).
//
// What it computes, per lane: the reference's step_event for each of the B
// events of the lane's wire batch, in order, over the lane's slot tables
// (one C-slot table per state), in the reference's order within an event:
// within-expiry reclaims, the zero-min count pre-seed, seeds0, the expiry
// pre-pass over clocked states (ascending), the states S-1 .. 0 (absent
// kill/restart, logical states with their count-prev source and seeding,
// count extension, stream advance from pending[s] and from an eligible
// count predecessor, seeding at state 0), and the end-of-event clears
// (scope clones become visible; sequence strictness). It writes ys
// (mask/outputs/null masks at [l, b, row, c], ts at [l, b]); the wrapper
// zeroes the ys first, so masked-off positions hold zero, as in the
// reference.
//
// Design:
//   - grid = one warp (one CTA of 32 threads) per lane; lane t of the warp
//     owns slots t, t + 32, ... (at most MAXC / 32). The B-event loop runs
//     inside the kernel, so a step is one launch. The lane's tables live in
//     shared memory as int64 value slots for the whole batch and are
//     written back once at the end.
//   - every stage is a loop over a thread's own slots followed by
//     __syncwarp; counts and ranks (the reference's cumsum-rank insert into
//     free slots, drop-newest) come from __ballot_sync/__popc over the slot
//     chunks (an insert keeps its chunks' ballots in shared memory). An
//     insert stages every value of every
//     inserted partial before any target slot is written, so sources and
//     targets may share a table; no block barrier runs in the event loop.
//   - the reference specialises at trace time on each state's kind, logical
//     type, counts, waiting time, reseed target and referenced keys; here a
//     descriptor table (ScanDesc, built by gpu/nfa_scan.py::ScanPlan) is
//     read per state, so one build serves every app. The descriptor and the
//     linked IR are copied into shared memory at launch; no stage reads
//     either from device memory. Predicates are linked per environment
//     level (their BIND operands are table field indices); outputs read an
//     emission environment E[key][slot] that each emission site fills with
//     the reference's env for that site. A predicate that is a conjunction
//     of comparisons between event columns, table fields and constants also
//     comes in clause form (two words a comparison, ScanPlan's clause_form)
//     and is evaluated from it (expr_ir.cuh's eval_clauses, shared with
//     nfa_block.cu) without the interpreter's dispatch; every
//     other program runs through one non-inlined copy of the interpreter.
//   - skips: each state's occupancy (may it hold a valid slot?) is a bit in
//     a register, recomputed by ballot at every event for the states that
//     had one and set by every insert. A stage runs only where it can act:
//     its table (or its count predecessor's) is occupied and some branch is
//     live for this event (the tag's stream gates it and, for a predicate
//     that reads the event alone, that predicate holds: such predicates are
//     evaluated once per event, not once per slot). Inserts and emissions
//     with nothing to place return after their ballot. The reference's
//     order within an event is kept wherever a stage acts.
//   - the lane's event columns, tags and ts deltas are staged into shared
//     memory EV_CHUNK events at a time with cp.async, double-buffered: the
//     next chunk's loads are in flight while the walk runs.
//   - timestamps are int64 with -1 for "unset"; FLOAT/DOUBLE are f32.
//
// What bounds it on the H100: neither bytes nor arithmetic. The ys are the
// bulk of the bytes (for the scan main path, 64 lanes x 2048 events x 2 x
// 64 slots x (1 B mask + 16 B outputs) = 285 MB a step, ~0.09 ms at
// 3.35 TB/s, almost all of it the zeros the wrapper writes), but the kernel
// itself is a serial walk of B events per lane, one warp each, one warp
// on an SM: latency-bound, every stage a chain of dependent shared-memory
// loads, compares and warp votes with nothing to hide their latency (clock64
// probes on the scan main path: ~11 k cycles an event). Writing ys
// sparsely and specialising the step per app are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXSTACK 32
#include "expr_ir.cuh"

#define MAXS 16
#define MAXK 64
#define MAXF 128
#define MAXCOL 32
#define MAXOUT 32
#define MAXNULL 8
#define MAXC 256
#define NMASK 12
#define SMEM_LIMIT (227 * 1024)
#define WARP 32
#define NCH (MAXC / WARP)          // slot chunks of one lane's table
#define EV_CHUNK 32                // events staged at a time
#define FULLW 0xffffffffu
#define I64_MAX 0x7fffffffffffffffLL
#define I64_MIN (-I64_MAX - 1)

enum { S_STREAM = 0, S_COUNT, S_LOGICAL, S_ABSENT };
enum { L_NONE = 0, L_AND, L_OR };
enum { F_VALID = 0, F_FIRST, F_COUNT, F_CLOSED, F_ARRIVE, F_FRESH, F_DONE,
       F_ABSDEAD, F_KEY };
enum { K_PLAIN = 0, K_SIDE, K_SET, K_FIRST, K_LAST, K_OCC, K_OCCFLAG, K_HAS };

struct StDesc {
  int kind, ltype, nbr, has_wait;
  long long waiting;
  int min_count, max_count, reseed_to, clone_first;
  int br_stream[2], br_absent[2];
  int f_valid, f_first, f_count, f_closed, f_arrive, f_fresh;
  int f_done[2], f_absdead[2];
  int fbase, nf;
  Prog pred[2], pred_prev[2], pred_seed[2];
  Prog cpred[2], cprev[2], cseed[2];   // the same as clauses (len 0: none)
  int evonly;       // bit bi: pred[bi] reads no bound field; 2 + bi: pred_prev[bi]
  int pad_;
};

struct KeyDesc { int q, kind, ty, col, bi, occ; };
struct FDesc { int role, key, ty, bi; };

struct ScanDesc {
  int S, K, F, ncol, nout, C, maxnf;
  int is_seq, has_within, always_seed, every_end, preseeded;
  long long within;
  int col_ty[MAXCOL];
  int out_ty[MAXOUT];
  Prog out[MAXOUT];
  int out_nnull[MAXOUT];
  int out_null[MAXOUT][MAXNULL];
  StDesc st[MAXS];
  KeyDesc key[MAXK];
  FDesc f[MAXF];
  short fld[MAXS][MAXK];
};

struct ScanArgs {
  int L, B, ncode, pad_;
  const ScanDesc* d;
  const int4* code;
  const void* col[MAXCOL];
  const signed char* tag;
  const int* ts;
  const long long* ts_base;
  const int* nvalid;
  void* field[MAXF];
  long long* seeds;
  long long* drops;
  long long* matches;
  unsigned char* y_mask;
  long long* y_ts;
  void* y_out[MAXOUT];
  unsigned char* y_null[MAXOUT];
};

// ------------------------------------------------------ shared memory plan

// T: the tables, field-major; E: an emission's environment; stage: an
// insert's staged values; evv: the staged chunk's event columns as value
// slots, [EV_CHUNK][MAXCOL] (Ctx's copy points at the current event's row).
struct Sm {
  long long *T, *E, *stage, *evv;
  unsigned* bal;
  unsigned char *touched, *mask, *epres, *evbuf;
  ScanDesc* desc;
  int4* code;
};

__host__ __device__ inline size_t carve(size_t* off, size_t bytes) {
  const size_t o = *off;
  *off += (bytes + 15) & ~(size_t)15;
  return o;
}

__host__ __device__ inline int ty_size(int ty) {
  return ty == T_BOOL ? 1 : (ty == T_I64 ? 8 : 4);
}

// bytes of one staged chunk of stream i (columns, then ts, then tag): the
// chunk's words, widened to 4-byte boundaries on both sides
__host__ __device__ inline size_t ev_region(int sz) {
  return ((size_t)EV_CHUNK * sz + 8 + 15) & ~(size_t)15;
}

__host__ __device__ inline size_t ev_buffer(const ScanDesc& d) {
  size_t n = ev_region(4) + ev_region(1);
  for (int c = 0; c < d.ncol; ++c) n += ev_region(ty_size(d.col_ty[c]));
  return n;
}

__host__ __device__ inline size_t smem_layout(const ScanDesc& d, int ncode,
                                              Sm* sm, unsigned char* base) {
  const size_t C = d.C, L8 = sizeof(long long);
  size_t off = 0;
  const size_t oD = carve(&off, sizeof(ScanDesc));
  const size_t oCode = carve(&off, sizeof(int4) * (size_t)ncode);
  const size_t oT = carve(&off, L8 * d.F * C);
  const size_t oE = carve(&off, L8 * (d.K > 0 ? d.K : 1) * C);
  const size_t oS = carve(&off, L8 * d.maxnf * C);
  const size_t oV = carve(&off, L8 * EV_CHUNK * MAXCOL);
  const size_t oBal = carve(&off, sizeof(unsigned) * 2 * NCH);
  const size_t oTo = carve(&off, (size_t)d.S * C);
  const size_t oM = carve(&off, (size_t)NMASK * C);
  const size_t oP = carve(&off, MAXK);
  const size_t oEv = carve(&off, 2 * ev_buffer(d));
  if (sm) {
    sm->desc = (ScanDesc*)(base + oD);
    sm->code = (int4*)(base + oCode);
    sm->T = (long long*)(base + oT);
    sm->E = (long long*)(base + oE);
    sm->stage = (long long*)(base + oS);
    sm->evv = (long long*)(base + oV);
    sm->bal = (unsigned*)(base + oBal);
    sm->touched = base + oTo;
    sm->mask = base + oM;
    sm->epres = base + oP;
    sm->evbuf = base + oEv;
  }
  return off;
}

// ------------------------------------------------------- event staging

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
#else
  *(unsigned*)dst = *(const unsigned*)src;
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
// every group but the newest has landed (for this thread)
__device__ __forceinline__ void cp_async_wait_prev() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

// the global array and element size of staged stream i
struct EvStream { const unsigned char* p; int sz; };

__device__ __forceinline__ EvStream ev_stream(const ScanDesc& d, const ScanArgs& a,
                                              int i) {
  if (i < d.ncol) return {(const unsigned char*)a.col[i], ty_size(d.col_ty[i])};
  if (i == d.ncol) return {(const unsigned char*)a.ts, 4};
  return {(const unsigned char*)a.tag, 1};
}

// Starts the copies of lane l's events [b0, b1) into buffer buf: the 4-byte
// words that cover each stream's byte range (cp.async where the word lies
// wholly inside the array, bytes otherwise).
__device__ void stage_events(const ScanDesc& d, const ScanArgs& a, unsigned char* buf,
                             int l, int b0, int b1, int lane) {
  const long long n = (long long)a.L * a.B;
  for (int i = 0; i < d.ncol + 2; ++i) {
    const EvStream s = ev_stream(d, a, i);
    const long long tot = n * s.sz;
    const long long lo = ((long long)l * a.B + b0) * s.sz;
    const long long hi = ((long long)l * a.B + b1) * s.sz;
    const long long wlo = lo & ~3LL, whi = (hi + 3) & ~3LL;
    const bool aligned = ((uintptr_t)s.p & 3) == 0;
    for (long long w = wlo + 4 * lane; w < whi; w += 4 * WARP) {
      unsigned char* dst = buf + (w - wlo);
      if (aligned && w + 4 <= tot) {
        cp_async4(dst, s.p + w);
      } else {
        for (int k = 0; k < 4 && w + k < tot; ++k) dst[k] = s.p[w + k];
      }
    }
    buf += ev_region(s.sz);
  }
}

// offset of stream i's region in a staging buffer
__device__ __forceinline__ int ev_offset(const ScanDesc& d, const ScanArgs& a, int i) {
  int off = 0;
  for (int j = 0; j < i; ++j) off += (int)ev_region(ev_stream(d, a, j).sz);
  return off;
}

// the staged element of stream i (region offset off, element size sz) for
// event b of the chunk that starts at b0
__device__ __forceinline__ const unsigned char* staged(const unsigned char* buf, int off,
                                                       int sz, long long lb, int b0, int b) {
  return buf + off + (((lb + b0) * sz) & 3) + (long long)(b - b0) * sz;
}

// ------------------------------------------------------------ warp helpers

__device__ __forceinline__ unsigned lanemask_lt(int lane) { return (1u << lane) - 1u; }

// position of the r-th (0-based) set bit of m (m holds more than r)
__device__ __forceinline__ int nth_bit(unsigned m, int r) {
  int pos = 0;
  for (int w = 16; w > 0; w >>= 1) {
    const int n = __popc(m & ((1u << w) - 1u));
    if (r >= n) { r -= n; m >>= w; pos += w; }
  }
  return pos;
}

// One copy of the interpreter for every program of the kernel: the event's
// columns and a slot-major table X (a predicate's table fields, or an
// emission's environment) at slot c. Not inlined, so the event loop's code
// stays small enough for the instruction caches.
__device__ __noinline__ long long eval_slot(const int4* code, Prog p, const long long* ev,
                                            const long long* X, int C, int c) {
  return eval_fast(code, p, [ev](int k) { return ev[k]; },
                   [X, C, c](int k) { return X[(long long)k * C + c]; });
}

// The second half of an insert: each staged partial (inserted ballots
// bal[0, NCH), free ballots bal[NCH, 2 NCH)) into the free slot of its rank
// (the lowest free slots in slot order, the inserts in source-slot order),
// marked in touched when given.
__device__ __forceinline__ void place(const unsigned* bal, const long long* stage, long long* T,
                                   unsigned char* touched, int C, int fbase, int nf,
                                   int n_free, int lane) {
  const unsigned* fm = bal + NCH;
  const unsigned below = lanemask_lt(lane);
  int pre = 0;
#pragma unroll 1
  for (int c = lane; c < C; c += WARP) {
    const unsigned m = bal[c / WARP];
    int r = pre + __popc(m & below);
    pre += __popc(m);
    if (!((m >> lane) & 1u) || r >= n_free) continue;
    int k = 0;
    while (r >= __popc(fm[k])) r -= __popc(fm[k++]);
    const int tg = k * WARP + nth_bit(fm[k], r);
#pragma unroll 1
    for (int q = 0; q < nf; ++q)
      T[(long long)(fbase + q) * C + tg] = stage[(long long)q * C + c];
    if (touched) touched[tg] = 1;
  }
  __syncwarp();
}

// ------------------------------------------------------------ the context

struct Ctx {
  const ScanDesc& d;
  const ScanArgs& a;
  Sm sm;
  const int4* code;
  int C, nch, lane, l, b, B;
  long long ev_ts;
  int ev_tag, ev_ok;
  long long seeds, drops, nmatch;
  unsigned occ;          // bit s: state s may hold a valid slot
  unsigned clocked_m;    // bit s: state s is clocked (absent, or a waiting logical)
  long long first_min;   // at most every valid slot's first_ts that is >= 0
  bool fresh_dirty;      // a fresh flag may be set

  __device__ Ctx(const ScanDesc& d_, const ScanArgs& a_) : d(d_), a(a_) {}

  __device__ long long& T(int f, int c) { return sm.T[(long long)f * C + c]; }
  __device__ unsigned char* M(int i) { return sm.mask + (long long)i * C; }
  __device__ unsigned char* touched(int s) { return sm.touched + (long long)s * C; }

  // one stage: f(c) for each of this thread's slots, then a warp barrier
  template <class F>
  __device__ void each(F f) {
#pragma unroll 1
    for (int c = lane; c < C; c += WARP) f(c);
    __syncwarp();
  }

  __device__ int count(const unsigned char* m) {
    int n = 0;
    for (int j = 0; j < nch; ++j) {
      const int c = j * WARP + lane;
      n += __popc(__ballot_sync(FULLW, c < C && m[c]));
    }
    return n;
  }

  __device__ bool valid(int s, int c) { return T(d.st[s].f_valid, c) != 0; }
  __device__ bool has(int s) { return (occ >> s) & 1u; }

  __device__ bool any_valid(int s) {
    for (int j = 0; j < nch; ++j) {
      const int c = j * WARP + lane;
      if (__any_sync(FULLW, c < C && valid(s, c))) return true;
    }
    return false;
  }

  // a predicate linked at some level: BIND operands are table fields
  __device__ bool pred(Prog p, Prog cp, int c) {
    if (cp.len > 0) {
      const long long *ev = sm.evv, *X = sm.T;
      const int C_ = C;
      return eval_clauses(code, cp, [ev](int k) { return ev[k]; },
                          [X, C_, c](int k) { return X[(long long)k * C_ + c]; });
    }
    return p.len == 0 || eval_slot(code, p, sm.evv, sm.T, C, c) != 0;
  }

  __device__ bool gate(int stream) { return ev_ok && ev_tag == stream; }

  // may branch bi of st (its count-prev program when prev) match any slot on
  // this event? Its stream's gate and, for a program that reads the event
  // alone, the program itself, evaluated here once.
  __device__ bool live(const StDesc& st, int bi, bool prev) {
    if (!gate(st.br_stream[bi])) return false;
    if (!((st.evonly >> ((prev ? 2 : 0) + bi)) & 1)) return true;
    return prev ? pred(st.pred_prev[bi], st.cprev[bi], 0) : pred(st.pred[bi], st.cpred[bi], 0);
  }

  // gate && predicate at slot c, given live(st, bi, prev) = lv
  __device__ bool bpred(const StDesc& st, int bi, bool prev, bool lv, int c) {
    if (!lv) return false;
    if ((st.evonly >> ((prev ? 2 : 0) + bi)) & 1) return true;
    return prev ? pred(st.pred_prev[bi], st.cprev[bi], c) : pred(st.pred[bi], st.cpred[bi], c);
  }

  __device__ long long evkey(int k) { return sm.evv[d.key[k].col]; }

  // ---- insert: the reference's cumsum-rank scatter into free slots,
  // drop-newest. val(fd, i, v) gives a key/flag field's value for source
  // slot i (false: reset); ts_new(i) / cnt_new(i) the first_ts / count.
  // Inserted target slots are marked in touched[t] when mark is set.
  template <class ValF, class TsF, class CntF>
  __device__ void insert(int t, const unsigned char* ins, ValF val, TsF ts_new,
                         CntF cnt_new, bool mark) {
    // the chunks' ballots of inserted and free slots, in shared memory
    unsigned* im = sm.bal;
    unsigned* fm = sm.bal + NCH;
    int n_ins = 0, n_free = 0;
#pragma unroll 1
    for (int j = 0; j < nch; ++j) {
      const int c = j * WARP + lane;
      const unsigned m = __ballot_sync(FULLW, c < C && ins[c]);
      if (lane == 0) im[j] = m;
      n_ins += __popc(m);
    }
    if (n_ins == 0) return;
    const StDesc& st = d.st[t];
#pragma unroll 1
    for (int j = 0; j < nch; ++j) {
      const int c = j * WARP + lane;
      const unsigned m = __ballot_sync(FULLW, c < C && !valid(t, c));
      if (lane == 0) fm[j] = m;
      n_free += __popc(m);
    }
    if (n_ins > n_free) drops += n_ins - n_free;
    if (n_free == 0) return;
    occ |= 1u << t;
    if (st.f_fresh >= 0) fresh_dirty = true;
    __syncwarp();
    const unsigned below = lanemask_lt(lane);
    // stage every value of every inserted partial (rank r among the
    // inserted, kept while r < n_free)
    int pre = 0;
    long long fmin = I64_MAX;
#pragma unroll 1
    for (int c = lane; c < C; c += WARP) {
      const unsigned m = im[c / WARP];
      const int r = pre + __popc(m & below);
      pre += __popc(m);
      if (!((m >> lane) & 1u) || r >= n_free) continue;
#pragma unroll 1
      for (int q = 0; q < st.nf; ++q) {
        const FDesc& fd = d.f[st.fbase + q];
        long long v;
        switch (fd.role) {
          case F_VALID: v = 1; break;
          case F_FIRST:
            v = ts_new(c);
            if (v >= 0 && v < fmin) fmin = v;
            break;
          case F_COUNT: v = cnt_new(c); break;
          case F_CLOSED: v = 0; break;
          default:
            if (!val(fd, c, v)) v = fd.role == F_ARRIVE ? -1 : 0;
            v = cast_val(v, fd.ty, fd.ty);
        }
        sm.stage[(long long)q * C + c] = v;
      }
    }
    if (d.has_within) {
      fmin = warp_min(fmin);
      if (fmin < first_min) first_min = fmin;
    }
    __syncwarp();
    place(sm.bal, sm.stage, sm.T, mark ? touched(t) : nullptr, C, st.fbase, st.nf,
          n_free, lane);
  }

  // ---- emission into output row `row` for the slots in mask. env(k, c, v)
  // gives the site's environment value of key k (false: not in the env).
  template <class EnvF>
  __device__ void emit(int row, const unsigned char* mask, EnvF env) {
    const int n = count(mask);
    if (n == 0) return;
    each([&](int c) {
      if (!mask[c] && c != 0) return;
      for (int k = 0; k < d.K; ++k) {
        long long v = 0;
        const bool has = env(k, c, v);
        if (c == 0) sm.epres[k] = (unsigned char)has;
        if (mask[c]) sm.E[(long long)k * C + c] = has ? v : 0;
      }
    });
    each([&](int c) {
      if (!mask[c]) return;
      const long long idx = (((long long)l * B + b) * 2 + row) * C + c;
      a.y_mask[idx] = 1;
      for (int o = 0; o < d.nout; ++o) {
        const long long v = eval_slot(code, d.out[o], sm.evv, sm.E, C, c);
        store_typed(a.y_out[o], d.out_ty[o], idx, v);
        if (d.out_nnull[o]) {
          int nm = 0;
          for (int i = 0; i < d.out_nnull[o]; ++i) {
            const int k = d.out_null[o][i];
            if (!sm.epres[k] || sm.E[(long long)k * C + c] == 0) nm = 1;
          }
          a.y_null[o][idx] = (unsigned char)nm;
        }
      }
    });
    nmatch += n;
  }

  // key k's value in table s at slot c, if the table carries it
  __device__ bool tab(int s, int k, int c, long long& v) {
    const int f = d.fld[s][k];
    if (f < 0) return false;
    v = T(f, c);
    return true;
  }

  // the reference's side_bind: branch bi's event columns where m, else base
  __device__ bool side(int s, int bi, int k, bool m, long long base, long long& v) {
    const KeyDesc& kd = d.key[k];
    if (kd.q != s || kd.bi != bi || (kd.kind != K_SIDE && kd.kind != K_SET))
      return false;
    if (kd.kind == K_SET) v = (m || base != 0) ? 1 : 0;
    else v = m ? evkey(k) : base;
    return true;
  }

  __device__ bool clocked(int s) { return (clocked_m >> s) & 1u; }

  __device__ __forceinline__ void logical_state(int s, long long seeds0);
  __device__ __forceinline__ void stream_or_count(int s, long long seeds0, int count0_open_pre);
  __device__ __forceinline__ void seed_state0(long long seeds0, int count0_open_pre);
  __device__ __forceinline__ void event();
};

// ------------------------------------------------------- logical states

__device__ __forceinline__ void Ctx::logical_state(int s, long long seeds0) {
  const StDesc& st = d.st[s];
  const bool is_and = st.ltype == L_AND;
  // the present branches, then the absent ones, in branch order (scalars:
  // no array the compiler would keep in local memory); branch bi's match
  // mask is M(bi)
  const int ab0 = st.br_absent[0], ab1 = st.nbr > 1 ? st.br_absent[1] : 0;
  const int na = ab0 + ab1, np = st.nbr - na;
  const int pres0 = ab0 ? 1 : 0, pres1 = 1, abs0 = ab0 ? 0 : 1, abs1 = 1;
  unsigned char* bm0 = M(0);
  unsigned char* bm1 = M(1);
  unsigned char* adv = M(2);
  unsigned char* to = touched(s);
  bool lv0 = false, lv1 = false;
  if (has(s)) {
    lv0 = live(st, 0, false);
    lv1 = st.nbr > 1 && live(st, 1, false);
  }
  // an `and` without absent branches completes on its done flags: it runs
  // whenever its table may hold a slot
  const bool acts = has(s) && (lv0 || lv1 || (is_and && !na));
  const bool rearm = s == 0 && d.always_seed && (na > 0);
  if (acts) {
    each([&](int c) {
      for (int bi = 0; bi < st.nbr; ++bi)
        M(bi)[c] = valid(s, c) && bpred(st, bi, false, bi ? lv1 : lv0, c);
    });
    if (na) {
      each([&](int c) {
        const int y = M(abs0)[c] | (na > 1 ? M(abs1)[c] : 0);
        if (s == 0 && st.has_wait) {
          if (y) T(st.f_arrive, c) = ev_ts;
        } else if (st.ltype == L_OR) {
          if (M(abs0)[c]) T(st.f_absdead[abs0], c) = 1;
          if (na > 1 && M(abs1)[c]) T(st.f_absdead[abs1], c) = 1;
        } else if (y) {
          T(st.f_valid, c) = 0;
        }
        if (y) to[c] = 1;
        for (int bi = 0; bi < st.nbr; ++bi) M(bi)[c] = M(bi)[c] && !y;
      });
    }

    if (is_and && !na) {
      // both sides must arrive (any order); one event may satisfy both.
      // The bind is applied to the table first: values/adv_src are the
      // post-bind table.
      each([&](int c) {
        for (int bi = 0; bi < 2; ++bi) {
          const bool m = M(bi)[c];
          if (!m) continue;
          T(st.f_done[bi], c) = 1;
          for (int k = 0; k < d.K; ++k) {
            long long v;
            const int f = d.fld[s][k];
            if (f >= 0 && side(s, bi, k, true, T(f, c), v)) T(f, c) = v;
          }
        }
        const int comp = valid(s, c) && T(st.f_done[0], c) && T(st.f_done[1], c);
        adv[c] = (unsigned char)comp;
        if (comp) T(st.f_valid, c) = 0;
        if (bm0[c] || bm1[c]) to[c] = 1;
      });
      const int n_adv = count(adv);
      if (s == d.S - 1) {
        emit(0, adv, [&](int k, int c, long long& v) { return tab(s, k, c, v); });
      } else {
        insert(s + 1, adv,
               [&](const FDesc& fd, int i, long long& v) {
                 if (fd.role == F_ARRIVE && clocked(s + 1)) { v = ev_ts; return true; }
                 if (fd.role != F_KEY || d.key[fd.key].q > s) return false;
                 return tab(s, fd.key, i, v);
               },
               [&](int i) { const long long f = T(st.f_first, i); return f >= 0 ? f : ev_ts; },
               [](int) { return 0LL; }, true);
      }
      if (d.every_end == s) seeds += n_adv;
    } else if (is_and && st.has_wait) {
      // `X and not Y for t`: X binds and waits for the established
      // non-occurrence — unless already established, then X advances
      const int bi0 = pres0;
      each([&](int c) {
        const bool m0 = M(bi0)[c];
        const long long arr = T(st.f_arrive, c);
        adv[c] = (unsigned char)(m0 && valid(s, c) && arr >= 0 && ev_ts >= arr + st.waiting);
        if (m0) {
          T(st.f_done[bi0], c) = 1;
          for (int k = 0; k < d.K; ++k) {
            long long v;
            const int f = d.fld[s][k];
            if (f >= 0 && side(s, bi0, k, true, T(f, c), v)) T(f, c) = v;
          }
          to[c] = 1;
        }
      });
      const int n_adv = count(adv);
      // emission/insert read the post-bind table before the re-arm or kill
      if (n_adv) {
        if (s == d.S - 1) {
          emit(0, adv, [&](int k, int c, long long& v) { return tab(s, k, c, v); });
        } else {
          insert(s + 1, adv,
                 [&](const FDesc& fd, int i, long long& v) {
                   if (fd.role == F_ARRIVE && clocked(s + 1)) { v = ev_ts; return true; }
                   if (fd.role != F_KEY || d.key[fd.key].q > s) return false;
                   return tab(s, fd.key, i, v);
                 },
                 [&](int i) { const long long f = T(st.f_first, i); return f >= 0 ? f : ev_ts; },
                 [](int) { return 0LL; }, true);
        }
        each([&](int c) {
          if (!adv[c]) return;
          if (s == 0 && d.always_seed) {
            if (st.f_arrive >= 0) T(st.f_arrive, c) = ev_ts;
            T(st.f_first, c) = -1;
            for (int j = 0; j < st.nf; ++j) {
              const FDesc& fd = d.f[st.fbase + j];
              if (fd.role == F_DONE || fd.role == F_ABSDEAD ||
                  (fd.role == F_KEY && d.key[fd.key].q == 0))
                T(st.fbase + j, c) = 0;
            }
          } else {
            T(st.f_valid, c) = 0;
          }
        });
        if (d.every_end == s) seeds += n_adv;
      }
    } else {
      // OR — or `X and not Y` (a present match advances); values are the
      // pre-kill table with the matched side bound
      unsigned char* m1 = M(3);
      each([&](int c) {
        const int a0 = M(pres0)[c];
        const int a1 = np > 1 ? (M(pres1)[c] && !a0) : 0;
        m1[c] = (unsigned char)a1;
        adv[c] = (unsigned char)(a0 || a1);
        if (a0 || a1) to[c] = 1;
      });
      const int n_adv = count(adv);
      auto values = [&](int k, int i, long long& v) -> bool {
        if (side(s, pres0, k, M(pres0)[i] != 0, 0, v)) return true;
        if (np > 1 && side(s, pres1, k, m1[i] != 0, 0, v)) return true;
        if (d.key[k].q < s) return tab(s, k, i, v);
        return false;
      };
      if (n_adv) {
        if (s == d.S - 1) {
          emit(0, adv, [&](int k, int c, long long& v) {
            return values(k, c, v) || tab(s, k, c, v);
          });
        } else {
          insert(s + 1, adv,
                 [&](const FDesc& fd, int i, long long& v) {
                   if (fd.role == F_ARRIVE && clocked(s + 1)) { v = ev_ts; return true; }
                   if (fd.role != F_KEY) return false;
                   return values(fd.key, i, v);
                 },
                 [&](int i) { const long long f = T(st.f_first, i); return f >= 0 ? f : ev_ts; },
                 [](int) { return 0LL; }, true);
        }
        each([&](int c) {
          if (!adv[c]) return;
          if (rearm) {
            if (st.f_arrive >= 0) T(st.f_arrive, c) = ev_ts;
            T(st.f_first, c) = -1;
            for (int j = 0; j < st.nf; ++j) {
              const FDesc& fd = d.f[st.fbase + j];
              if (fd.role == F_DONE || fd.role == F_ABSDEAD ||
                  (fd.role == F_KEY && d.key[fd.key].q == 0))
                T(st.fbase + j, c) = 0;
            }
          } else {
            T(st.f_valid, c) = 0;
          }
        });
        if (d.every_end == s) seeds += n_adv;
      }
    }
  }

  // ---- eligible candidates from a min-reached PREV count
  if (s > 0 && d.st[s - 1].kind == S_COUNT && !st.has_wait && has(s - 1)) {
    const bool lp0 = live(st, 0, true), lp1 = st.nbr > 1 && live(st, 1, true);
    if (lp0 || lp1) {
      const StDesc& pv = d.st[s - 1];
      unsigned char* to_p = touched(s - 1);
      unsigned char* m1p = M(3);
      each([&](int c) {
        const int elig = valid(s - 1, c) && T(pv.f_count, c) >= pv.min_count;
        for (int bi = 0; bi < st.nbr; ++bi)
          M(bi)[c] = elig && bpred(st, bi, true, bi ? lp1 : lp0, c);
      });
      each([&](int c) {
        if (na) {
          const int kill = M(abs0)[c] | (na > 1 ? M(abs1)[c] : 0);
          if (kill) { T(pv.f_valid, c) = 0; to_p[c] = 1; }
          for (int bi = 0; bi < st.nbr; ++bi) M(bi)[c] = M(bi)[c] && !kill;
        }
        const int a0 = M(pres0)[c];
        const int a1 = np > 1 ? (M(pres1)[c] && !a0) : 0;
        m1p[c] = (unsigned char)a1;
        adv[c] = (unsigned char)(a0 || a1);
        if (a0 || a1) to_p[c] = 1;
      });
      auto valuesp = [&](int k, int i, long long& v) -> bool {
        if (side(s, pres0, k, M(pres0)[i] != 0, 0, v)) return true;
        if (np > 1 && side(s, pres1, k, m1p[i] != 0, 0, v)) return true;
        if (d.key[k].q < s) return tab(s - 1, k, i, v);
        return false;
      };
      if (count(adv)) {
        if (s == d.S - 1) {
          emit(1, adv, [&](int k, int c, long long& v) {
            return valuesp(k, c, v) || tab(s - 1, k, c, v);
          });
        } else {
          insert(s + 1, adv,
                 [&](const FDesc& fd, int i, long long& v) {
                   if (fd.role == F_ARRIVE && clocked(s + 1)) { v = ev_ts; return true; }
                   if (fd.role != F_KEY) return false;
                   return valuesp(fd.key, i, v);
                 },
                 [&](int i) { const long long f = T(pv.f_first, i); return f >= 0 ? f : ev_ts; },
                 [](int) { return 0LL; }, true);
        }
        each([&](int c) { if (adv[c]) T(pv.f_valid, c) = 0; });
      }
    }
  }

  // ---- seeding at a logical state 0 (absent-bearing logicals are
  // pre-seeded at init and re-armed in place instead)
  if (s == 0 && !na) {
    const bool seeds_ok = (d.always_seed && !is_and) ? true : seeds0 > 0;
    int can0 = 0, can1 = 0;         // can<bi>: branch bi seeds
    int taken = 0;
    for (int i = 0; i < np; ++i) {
      const int bi = i ? pres1 : pres0;
      const int g0 = gate(st.br_stream[bi]) && pred(st.pred_seed[bi], st.cseed[bi], 0);
      const int cc = is_and ? g0 : (g0 && !taken);
      taken |= cc;
      if (bi) can1 = cc && seeds_ok;
      else can0 = cc && seeds_ok;
    }
    const int can_any = taken && seeds_ok;
    if (!can_any) return;          // nothing seeds: no insert, no count
    unsigned char* ins = M(4);
    // seed_vals: the matched sides' event columns (zeros elsewhere)
    auto seedv = [&](int k, long long& v) -> bool {
      for (int i = 0; i < np; ++i)
        if (side(0, i ? pres1 : pres0, k, ((i ? pres1 : pres0) ? can1 : can0) != 0, 0, v))
          return true;
      return false;
    };
    if (is_and) {
      int seed_done = can_any;
      for (int i = 0; i < np; ++i) seed_done = seed_done && ((i ? pres1 : pres0) ? can1 : can0);
      const int ins_pend = can_any && !seed_done;
      each([&](int c) { ins[c] = (unsigned char)(c == 0 && seed_done); });
      if (d.S == 1) {
        emit(0, ins, [&](int k, int c, long long& v) {
          if (d.key[k].q != 0) return false;
          if (!seedv(k, v)) v = 0;
          return true;
        });
      } else {
        insert(1, ins,
               [&](const FDesc& fd, int i, long long& v) {
                 if (fd.role == F_ARRIVE && clocked(1)) { v = ev_ts; return true; }
                 if (fd.role != F_KEY) return false;
                 return seedv(fd.key, v);
               },
               [&](int) { return ev_ts; }, [](int) { return 0LL; }, true);
      }
      each([&](int c) { ins[c] = (unsigned char)(c == 0 && ins_pend); });
      insert(0, ins,
             [&](const FDesc& fd, int i, long long& v) {
               if (fd.role == F_DONE) { v = fd.bi ? can1 : can0; return true; }
               if (fd.role != F_KEY) return false;
               return seedv(fd.key, v);
             },
             [&](int) { return ev_ts; }, [](int) { return 1LL; }, true);
      if (d.every_end == 0) seeds += seed_done;
    } else {
      each([&](int c) { ins[c] = (unsigned char)(c == 0 && can_any); });
      auto orv = [&](int k, long long& v) -> bool {
        if (d.key[k].q != 0) return false;
        if (!seedv(k, v)) v = 0;
        return true;
      };
      if (d.S == 1) {
        emit(0, ins, [&](int k, int c, long long& v) { return orv(k, v); });
      } else {
        insert(1, ins,
               [&](const FDesc& fd, int i, long long& v) {
                 if (fd.role == F_ARRIVE && clocked(1)) { v = ev_ts; return true; }
                 if (fd.role != F_KEY) return false;
                 return orv(fd.key, v);
               },
               [&](int) { return ev_ts; }, [](int) { return 0LL; }, true);
      }
    }
    if (!d.always_seed || is_and) seeds -= can_any;
  }
}

// ------------------------------------------------- stream and count states

__device__ __forceinline__ void Ctx::stream_or_count(int s, long long seeds0, int count0_open_pre) {
  const StDesc& st = d.st[s];
  unsigned char* to = touched(s);
  if (st.kind == S_COUNT) {
    const bool lv = has(s) && live(st, 0, false);
    if (lv) {
      if (ev_ts >= 0 && ev_ts < first_min) first_min = ev_ts;   // an extension's first_ts
      unsigned char* fire = M(0);
      each([&](int c) {
        const int ext = valid(s, c) && !T(st.f_closed, c) && bpred(st, 0, false, lv, c);
        fire[c] = 0;
        if (!ext) return;
        const long long old = T(st.f_count, c);
        const long long nc = old + 1;
        T(st.f_count, c) = nc;
        if (old == 0 && T(st.f_first, c) < 0) T(st.f_first, c) = ev_ts;
        for (int j = 0; j < st.nf; ++j) {
          const FDesc& fd = d.f[st.fbase + j];
          if (fd.role != F_KEY) continue;
          const KeyDesc& kd = d.key[fd.key];
          if (kd.q != s) continue;
          long long& slot = T(st.fbase + j, c);
          switch (kd.kind) {
            case K_LAST: slot = evkey(fd.key); break;
            case K_FIRST: if (old == 0) slot = evkey(fd.key); break;
            case K_OCCFLAG: if (old == kd.occ) slot = 1; break;
            case K_OCC: if (old == kd.occ) slot = evkey(fd.key); break;
            case K_HAS: slot = 1; break;
            default: break;
          }
        }
        if (st.max_count != -1 && nc >= st.max_count) T(st.f_closed, c) = 1;
        to[c] = 1;
        fire[c] = (unsigned char)(s == d.S - 1 && nc >= st.min_count);
      });
      if (s == d.S - 1) {
        const int n_fire = count(fire);
        if (n_fire) {
          emit(0, fire, [&](int k, int c, long long& v) { return tab(s, k, c, v); });
          each([&](int c) { if (fire[c]) T(st.f_valid, c) = 0; });
          if (d.every_end == s) seeds += n_fire;
        }
      }
    }
  } else {
    unsigned char* cand[2] = {M(0), M(1)};
    const int has_prev = s > 0 && d.st[s - 1].kind == S_COUNT;
    const bool lv[2] = {has(s) && live(st, 0, false),
                        has_prev && has(s - 1) && live(st, 0, true)};
    if (lv[0] || lv[1]) {
      each([&](int c) {
        cand[0][c] = (unsigned char)(valid(s, c) && bpred(st, 0, false, lv[0], c) &&
                                     !(st.f_fresh >= 0 && T(st.f_fresh, c)));
        if (has_prev) {
          const StDesc& pv = d.st[s - 1];
          cand[1][c] = (unsigned char)(lv[1] && valid(s - 1, c) &&
                                       T(pv.f_count, c) >= pv.min_count &&
                                       bpred(st, 0, true, lv[1], c));
        }
      });
    }
    const int S = d.S;
    const int tgt_final_min0 = s + 1 == S - 1 && d.st[S - 1].kind == S_COUNT &&
                               d.st[S - 1].min_count == 0;
    for (int src_i = 0; src_i < 1 + has_prev; ++src_i) {
      if (!lv[src_i]) continue;       // no candidate: nothing advances
      const int lvl = s - src_i;
      const unsigned char* matched = cand[src_i];
      const int n_adv = count(matched);
      if (!n_adv) continue;
      unsigned char* to_l = touched(lvl);
      each([&](int c) { if (matched[c]) to_l[c] = 1; });
      // advanced values: the source's bound keys (q < s) + the new binding
      auto values = [&](int k, int i, long long& v) -> bool {
        if (d.key[k].q == s) { v = evkey(k); return true; }
        if (d.key[k].q < s) return tab(lvl, k, i, v);
        return false;
      };
      if (s == S - 1 || tgt_final_min0) {
        emit(src_i, matched, [&](int k, int c, long long& v) {
          if (tab(lvl, k, c, v)) return true;
          if (d.key[k].q == s) { v = evkey(k); return true; }
          if (d.key[k].q == S - 1) { v = 0; return true; }
          return false;
        });
        if (tgt_final_min0 && d.every_end == S - 1) seeds += n_adv;
      } else {
        insert(s + 1, matched,
               [&](const FDesc& fd, int i, long long& v) {
                 if (fd.role == F_ARRIVE && clocked(s + 1)) { v = ev_ts; return true; }
                 if (fd.role != F_KEY) return false;
                 return values(fd.key, i, v);
               },
               [&](int i) { const long long f = T(d.st[lvl].f_first, i); return f >= 0 ? f : ev_ts; },
               [](int) { return 0LL; }, true);
      }
      // kill advanced source slots
      each([&](int c) { if (matched[c]) T(d.st[lvl].f_valid, c) = 0; });
      // mid-pattern every: the scope-end advance re-places a clone at the
      // scope start, fresh until the next event
      const int r = d.st[lvl].reseed_to;
      if (r > 0) {
        insert(r, matched,
               [&](const FDesc& fd, int i, long long& v) {
                 if (fd.role == F_FRESH) { v = 1; return true; }
                 if (fd.role != F_KEY || d.key[fd.key].q >= r) return false;
                 return tab(lvl, fd.key, i, v);
               },
               [&](int i) { return d.st[r].clone_first ? T(d.st[lvl].f_first, i) : -1LL; },
               [](int) { return 0LL; }, false);
      }
      if (d.every_end == lvl) seeds += n_adv;
    }
  }
  if (s == 0 && !(st.kind == S_COUNT && st.min_count == 0))
    seed_state0(seeds0, count0_open_pre);
}

// seeding at a stream/count state 0
__device__ __forceinline__ void Ctx::seed_state0(long long seeds0, int count0_open_pre) {
  const StDesc& st = d.st[0];
  if (!gate(st.br_stream[0])) return;
  int can_seed = pred(st.pred_seed[0], st.cseed[0], 0);
  if (!d.always_seed) can_seed = can_seed && seeds0 > 0;
  if (st.kind == S_COUNT) can_seed = can_seed && !count0_open_pre;
  if (!can_seed) return;           // nothing seeds: no insert, no count
  // seed_vals: count state 0 seeds with its first occurrence bound
  auto seedv = [&](int k, long long& v) -> bool {
    const KeyDesc& kd = d.key[k];
    if (kd.q != 0) return false;
    switch (kd.kind) {
      case K_HAS: v = 1; break;
      case K_OCCFLAG: v = kd.occ == 0; break;
      case K_OCC: v = kd.occ == 0 ? evkey(k) : 0; break;
      default: v = evkey(k); break;
    }
    return true;
  };
  unsigned char* ins = M(4);
  each([&](int c) { ins[c] = (unsigned char)(c == 0); });
  const int S = d.S;
  if (st.kind == S_COUNT) {
    if (S == 1 && st.min_count <= 1) {
      emit(0, ins, [&](int k, int c, long long& v) {
        if (d.key[k].q != 0) return false;
        if (!seedv(k, v)) v = 0;
        return true;
      });
    } else {
      insert(0, ins,
             [&](const FDesc& fd, int i, long long& v) {
               if (fd.role != F_KEY) return false;
               return seedv(fd.key, v);
             },
             [&](int) { return ev_ts; }, [](int) { return 1LL; }, true);
    }
  } else {
    const int seed_final_min0 = S == 2 && d.st[1].kind == S_COUNT && d.st[1].min_count == 0;
    if (S == 1 || seed_final_min0) {
      emit(0, ins, [&](int k, int c, long long& v) {
        if (d.key[k].q == 0) return seedv(k, v);
        if (d.key[k].q == 1) { v = 0; return true; }
        return false;
      });
      if (seed_final_min0 && d.every_end == S - 1) seeds += can_seed;
    } else {
      insert(1, ins,
             [&](const FDesc& fd, int i, long long& v) {
               if (fd.role == F_ARRIVE && clocked(1)) { v = ev_ts; return true; }
               if (fd.role != F_KEY) return false;
               return seedv(fd.key, v);
             },
             [&](int) { return ev_ts; }, [](int) { return 0LL; }, true);
    }
  }
  if (!d.always_seed) seeds -= can_seed;
}

// ------------------------------------------------------------ one event

__device__ __forceinline__ void Ctx::event() {
  const int S = d.S;
  // occupancy: a bit may stay set after its table empties (a stage then
  // runs and finds nothing), never cleared while a slot is valid; every
  // 4th event clears the bits of the states that emptied
  if ((b & 3) == 0)
    for (int s = 0; s < S; ++s)
      if (has(s) && !any_valid(s)) occ &= ~(1u << s);

  // ---- within-expiry reclaims slots (one stage for every state where no
  // reclaim is counted). Nothing expires while every valid slot's first_ts
  // is at least ev_ts - within: first_min bounds them from below; each
  // pass recomputes it.
  const bool count_within = !d.always_seed && d.every_end >= 0;
  if (d.has_within && first_min < ev_ts - d.within) {
    long long fmin = I64_MAX;
    if (!count_within) {
      each([&](int c) {
        for (int s = 0; s < S; ++s) {
          if (!has(s)) continue;
          const long long f = T(d.st[s].f_first, c);
          if (f >= 0 && ev_ts - f > d.within) T(d.st[s].f_valid, c) = 0;
          else if (f >= 0 && valid(s, c) && f < fmin) fmin = f;
        }
      });
    } else {
      for (int s = 0; s < S; ++s) {
        if (!has(s)) continue;
        unsigned char* ex = M(0);
        each([&](int c) {
          const long long f = T(d.st[s].f_first, c);
          const int alive = !(f >= 0 && ev_ts - f > d.within);
          ex[c] = (unsigned char)(valid(s, c) && !alive);
          if (!alive) T(d.st[s].f_valid, c) = 0;
          else if (f >= 0 && valid(s, c) && f < fmin) fmin = f;
        });
        if (s <= d.every_end) seeds += count(ex);
      }
    }
    first_min = warp_min(fmin);
  }

  // ---- zero-min count scope start: a pre-seeded empty partial
  if (d.st[0].kind == S_COUNT && d.st[0].min_count == 0) {
    int has_open = 0;
    if (has(0)) {
      unsigned char* op = M(0);
      each([&](int c) { op[c] = valid(0, c) && !T(d.st[0].f_closed, c); });
      has_open = count(op) > 0;
    }
    const int want = ev_ok && !has_open && (d.always_seed || seeds > 0);
    if (want) {
      unsigned char* ins = M(4);
      each([&](int c) { ins[c] = (unsigned char)(c == 0); });
      insert(0, ins, [](const FDesc&, int, long long&) { return false; },
             [](int) { return -1LL; }, [](int) { return 0LL; }, true);
    }
    if (!d.always_seed) seeds -= want;
  }
  const long long seeds0 = seeds;

  // ---- expiry pre-pass over clocked states, ascending
  for (unsigned m = clocked_m; m; m &= m - 1) {
    const int s = __ffs(m) - 1;
    if (!has(s) || !ev_ok) continue;
    const StDesc& st = d.st[s];
    unsigned char* adv = M(2);
    each([&](int c) {
      const long long arr = T(st.f_arrive, c);
      int e = valid(s, c) && arr >= 0 && ev_ts >= arr + st.waiting;
      if (st.kind == S_LOGICAL) {
        for (int bi = 0; bi < st.nbr; ++bi) {
          if (st.ltype == L_AND && !st.br_absent[bi]) e = e && T(st.f_done[bi], c);
          if (st.ltype == L_OR && st.br_absent[bi]) e = e && !T(st.f_absdead[bi], c);
        }
      }
      adv[c] = (unsigned char)e;
      if (e) touched(s)[c] = 1;
    });
    const int n_adv = count(adv);
    if (!n_adv) continue;
    // emission / insert read the table before this pre-pass changes it
    if (s == S - 1) {
      emit(0, adv, [&](int k, int c, long long& v) { return tab(s, k, c, v); });
    } else {
      insert(s + 1, adv,
             [&](const FDesc& fd, int i, long long& v) {
               if (fd.role == F_ARRIVE && clocked(s + 1)) {
                 v = T(st.f_arrive, i) + st.waiting;
                 return true;
               }
               if (fd.role != F_KEY || d.key[fd.key].q > s) return false;
               return tab(s, fd.key, i, v);
             },
             [&](int i) { const long long f = T(st.f_first, i); return f >= 0 ? f : ev_ts; },
             [](int) { return 0LL; }, true);
    }
    each([&](int c) {
      if (!adv[c]) return;
      if (s == 0 && d.always_seed) {
        // re-arm the start seed at the established boundary
        T(st.f_arrive, c) += st.waiting;
        T(st.f_first, c) = -1;
        for (int j = 0; j < st.nf; ++j) {
          const FDesc& fd = d.f[st.fbase + j];
          if (fd.role == F_DONE || fd.role == F_ABSDEAD ||
              (fd.role == F_KEY && d.key[fd.key].q == 0))
            T(st.fbase + j, c) = 0;
        }
      } else {
        T(st.f_valid, c) = 0;
      }
    });
    if (d.every_end == s) seeds += n_adv;
  }

  // openness of a state-0 count before this event's extensions
  int count0_open_pre = 0;
  if (d.st[0].kind == S_COUNT && has(0)) {
    unsigned char* op = M(0);
    each([&](int c) { op[c] = valid(0, c) && !T(d.st[0].f_closed, c); });
    count0_open_pre = count(op) > 0;
  }

  // ---- the states, last to first
  for (int s = S - 1; s >= 0; --s) {
    const StDesc& st = d.st[s];
    if (st.kind == S_ABSENT) {
      if (!has(s) || !live(st, 0, false)) continue;
      each([&](int c) {
        const int kill = valid(s, c) && bpred(st, 0, false, true, c);
        if (!kill) return;
        if (s == 0) T(st.f_arrive, c) = ev_ts;
        else T(st.f_valid, c) = 0;
        touched(s)[c] = 1;
      });
    } else if (st.kind == S_LOGICAL) {
      logical_state(s, seeds0);
    } else {
      stream_or_count(s, seeds0, count0_open_pre);
    }
  }

  // ---- end of event: scope clones become visible; sequence strictness
  // (touched is all zero between events)
  if (fresh_dirty) {
    each([&](int c) {
      for (int s = 0; s < S; ++s)
        if (d.st[s].f_fresh >= 0) T(d.st[s].f_fresh, c) = 0;
    });
    fresh_dirty = false;
  }
  if (d.is_seq) {
    each([&](int c) {
      for (int s = 0; s < S; ++s) {
        if (ev_ok && has(s) && !touched(s)[c]) T(d.st[s].f_valid, c) = 0;
        touched(s)[c] = 0;
      }
    });
  }
}

// ------------------------------------------------------------- the kernel

__global__ void __launch_bounds__(WARP, 1) nfa_scan_step_kernel(const __grid_constant__ ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm sm;
  smem_layout(*a.d, a.ncode, &sm, smem_raw);
  const int lane = threadIdx.x;
  // the descriptor and the linked programs, into shared memory
  {
    const unsigned* src = (const unsigned*)a.d;
    unsigned* dst = (unsigned*)sm.desc;
    for (int i = lane; i < (int)(sizeof(ScanDesc) / 4); i += WARP) dst[i] = src[i];
    for (int i = lane; i < a.ncode; i += WARP) sm.code[i] = a.code[i];
    __syncwarp();
  }
  const ScanDesc& d = *sm.desc;
  Ctx x(d, a);
  x.sm = sm;
  x.code = sm.code;
  const int C = d.C, l = blockIdx.x, B = a.B;
  x.C = C; x.l = l; x.B = B; x.lane = lane;
  x.nch = (C + WARP - 1) / WARP;
  const long long lc = (long long)l * C;

  // ---- the lane's tables and counters
  x.each([&](int c) {
    for (int f = 0; f < d.F; ++f) x.T(f, c) = load_typed(a.field[f], d.f[f].ty, lc + c);
    if (d.is_seq)
      for (int s = 0; s < d.S; ++s) x.touched(s)[c] = 0;
  });
  x.seeds = a.seeds[l];
  x.drops = a.drops[l];
  x.nmatch = a.matches[l];
  x.occ = 0;
  x.clocked_m = 0;
  for (int s = 0; s < d.S; ++s) {
    if (x.any_valid(s)) x.occ |= 1u << s;
    const StDesc& st = d.st[s];
    if (st.kind == S_ABSENT || (st.kind == S_LOGICAL && st.has_wait)) x.clocked_m |= 1u << s;
  }
  x.fresh_dirty = true;
  x.first_min = I64_MIN;             // unknown: the first within pass computes it
  const int nv = a.nvalid[l];
  const long long base = a.ts_base[l];

  // ---- the events, EV_CHUNK at a time, the next chunk's copies in flight
  static_assert(EV_CHUNK == WARP, "one staged event per thread");
  static_assert(MAXCOL <= WARP, "one event column per thread");
  const size_t evb = ev_buffer(d);
  const long long lb = (long long)l * B;
  const int ts_off = ev_offset(d, a, d.ncol), tag_off = ev_offset(d, a, d.ncol + 1);
  const int col_ty = lane < d.ncol ? d.col_ty[lane] : T_I32;
  const int col_sz = ty_size(col_ty), col_off = ev_offset(d, a, lane < d.ncol ? lane : 0);
  const int nchunk = (B + EV_CHUNK - 1) / EV_CHUNK;
  if (nchunk > 0) stage_events(d, a, sm.evbuf, l, 0, B < EV_CHUNK ? B : EV_CHUNK, lane);
  cp_async_commit();
  for (int k = 0; k < nchunk; ++k) {
    const int b0 = k * EV_CHUNK;
    const int b1 = b0 + EV_CHUNK < B ? b0 + EV_CHUNK : B;
    if (k + 1 < nchunk) {
      const int n0 = b1, n1 = n0 + EV_CHUNK < B ? n0 + EV_CHUNK : B;
      stage_events(d, a, sm.evbuf + ((k + 1) & 1) * evb, l, n0, n1, lane);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncwarp();
    const unsigned char* buf = sm.evbuf + (k & 1) * evb;
    const int* ts_p = (const int*)staged(buf, ts_off, 4, lb, b0, b0);
    const signed char* tag_p = (const signed char*)staged(buf, tag_off, 1, lb, b0, b0);
    if (b0 + lane < b1) a.y_ts[lb + b0 + lane] = base + (long long)ts_p[lane];
    // the chunk's columns as value slots, one row of MAXCOL per event
    // (thread c converts column c)
    if (lane < d.ncol)
      for (int b = b0; b < b1; ++b)
        sm.evv[(b - b0) * MAXCOL + lane] =
            load_typed(staged(buf, col_off, col_sz, lb, b0, b), col_ty, 0);
    __syncwarp();
    for (int b = b0; b < b1; ++b) {
      x.b = b;
      // ---- the event (every thread reads the same values). A barrier
      // between events: an event whose stages all skip has none of its own.
      __syncwarp();
      x.sm.evv = sm.evv + (b - b0) * MAXCOL;
      x.ev_ts = base + (long long)ts_p[b - b0];
      x.ev_tag = tag_p[b - b0];
      x.ev_ok = b < nv;
      x.event();
    }
    __syncwarp();          // the buffer is refilled next iteration
  }

  // ---- write the tables and counters back
  x.each([&](int c) {
    for (int f = 0; f < d.F; ++f) store_typed(a.field[f], d.f[f].ty, lc + c, x.T(f, c));
  });
  if (lane == 0) {
    a.seeds[l] = x.seeds;
    a.drops[l] = x.drops;
    a.matches[l] = x.nmatch;
  }
}

// ------------------------------------------------------------ C interface

extern "C" int nfa_scan_desc_size(void) { return (int)sizeof(ScanDesc); }
extern "C" int nfa_scan_args_size(void) { return (int)sizeof(ScanArgs); }

// Launches one step on `stream`: L CTAs of one warp each. Returns
// cudaGetLastError() after the launch (0 on success), -2 when a lane needs
// more shared memory than a block can have, -3 when C is out of range.
extern "C" int nfa_scan_step(const ScanArgs* args, const ScanDesc* host_desc,
                             void* stream) {
  const ScanDesc& d = *host_desc;
  if (d.C < 1 || d.C > MAXC) return -3;
  const size_t smem = smem_layout(d, args->ncode, nullptr, nullptr);
  if (smem > SMEM_LIMIT) return -2;
  cudaError_t e = cudaFuncSetAttribute(
      nfa_scan_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  nfa_scan_step_kernel<<<args->L, WARP, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
