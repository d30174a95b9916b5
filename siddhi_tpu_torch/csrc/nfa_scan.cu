// Per-event scan NFA step kernel for Hopper (sm_90a).
//
// Replaces, from the reference JAX package:
//   - tpu/nfa.py::DeviceNFACompiler._make_step -> step_event under lax.scan
//     (B4: the per-event NFA for count, logical and absent states,
//     sequences, group and mid-pattern `every`)
//   - tpu/partition.py:160-181 for that step (vmap over lanes, donated
//     state: here one CTA per lane, tables updated in place)
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
//   - grid = one CTA per lane; thread c owns slot c (blockDim.x = C rounded
//     up to a warp). The B-event loop runs inside the kernel, so a step is
//     one launch. The lane's tables live in shared memory as int64 value
//     slots for the whole batch and are written back once at the end.
//   - the reference specialises at trace time on each state's kind, logical
//     type, counts, waiting time, reseed target and referenced keys; here a
//     descriptor table (ScanDesc, built by gpu/nfa_scan.py::ScanPlan) is
//     read per state, so one build serves every app. Predicates are linked
//     per environment level (their BIND operands are table field indices);
//     outputs read an emission environment E[key][slot] that each emission
//     site fills with the reference's env for that site.
//   - every stage is a loop over slots followed by __syncthreads; counts and
//     ranks (the reference's cumsum-rank insert into free slots, drop-newest)
//     use block_rank's warp ballots. An insert stages every value of every
//     inserted partial before any target slot is written, so sources and
//     targets may share a table.
//   - timestamps are int64 with -1 for "unset"; FLOAT/DOUBLE are f32.
//
// What bounds it on the H100: neither bytes nor arithmetic. The ys are the
// bulk of the bytes (for the scan main path, 64 lanes x 2048 events x 2 x
// 64 slots x (1 B mask + 16 B outputs) = 285 MB a step, ~0.09 ms at
// 3.35 TB/s, almost all of it the zeros the wrapper writes), but the kernel
// itself is a serial walk of B events per lane with tens of block-wide
// barriers per event, on L CTAs of C threads: latency-bound. Spreading a
// lane's states over warps, writing ys sparsely and specialising the step
// per app are later work.

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
  int L, B;
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

struct Sm {
  long long *T, *E, *stage, *evv;
  int *rank0, *rank1, *sor, *scan;
  unsigned char *touched, *mask, *epres;
};

__host__ __device__ inline size_t carve(size_t* off, size_t bytes) {
  const size_t o = *off;
  *off += (bytes + 15) & ~(size_t)15;
  return o;
}

__host__ __device__ inline size_t smem_layout(const ScanDesc& d, Sm* sm,
                                              unsigned char* base) {
  const size_t C = d.C, L8 = sizeof(long long), I4 = sizeof(int);
  size_t off = 0;
  const size_t oT = carve(&off, L8 * d.F * C);
  const size_t oE = carve(&off, L8 * (d.K > 0 ? d.K : 1) * C);
  const size_t oS = carve(&off, L8 * d.maxnf * C);
  const size_t oV = carve(&off, L8 * MAXCOL);
  const size_t oR0 = carve(&off, I4 * C);
  const size_t oR1 = carve(&off, I4 * C);
  const size_t oSor = carve(&off, I4 * C);
  const size_t oScan = carve(&off, I4 * (MAXC / 32 + 1));
  const size_t oTo = carve(&off, (size_t)d.S * C);
  const size_t oM = carve(&off, (size_t)NMASK * C);
  const size_t oP = carve(&off, MAXK);
  if (sm) {
    sm->T = (long long*)(base + oT);
    sm->E = (long long*)(base + oE);
    sm->stage = (long long*)(base + oS);
    sm->evv = (long long*)(base + oV);
    sm->rank0 = (int*)(base + oR0);
    sm->rank1 = (int*)(base + oR1);
    sm->sor = (int*)(base + oSor);
    sm->scan = (int*)(base + oScan);
    sm->touched = base + oTo;
    sm->mask = base + oM;
    sm->epres = base + oP;
  }
  return off;
}

// ------------------------------------------------------------ the context

struct Ctx {
  const ScanDesc& d;
  const ScanArgs& a;
  Sm sm;
  int C, l, b, B;
  long long ev_ts;
  int ev_tag, ev_ok;
  long long seeds, drops, nmatch;

  __device__ Ctx(const ScanDesc& d_, const ScanArgs& a_) : d(d_), a(a_) {}

  __device__ long long& T(int f, int c) { return sm.T[(long long)f * C + c]; }
  __device__ unsigned char* M(int i) { return sm.mask + (long long)i * C; }
  __device__ unsigned char* touched(int s) { return sm.touched + (long long)s * C; }

  // one stage: f(c) for every slot, then a block barrier
  template <class F>
  __device__ void each(F f) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) f(c);
    __syncthreads();
  }

  __device__ int count(const unsigned char* m) {
    return block_rank(m, sm.rank0, C, sm.scan);
  }

  __device__ bool valid(int s, int c) { return T(d.st[s].f_valid, c) != 0; }

  // a predicate linked at some level: BIND operands are table fields
  __device__ bool pred(Prog p, int c) {
    if (p.len == 0) return true;
    long long* Tp = sm.T;
    const long long* ev = sm.evv;
    const int C_ = C;
    return eval_prog(a.code, p, [ev](int k) { return ev[k]; },
                     [Tp, C_, c](int f) { return Tp[(long long)f * C_ + c]; }) != 0;
  }

  __device__ bool gate(int stream) { return ev_ok && ev_tag == stream; }

  __device__ long long evkey(int k) { return sm.evv[d.key[k].col]; }

  // ---- insert: the reference's cumsum-rank scatter into free slots,
  // drop-newest. val(fd, i, v) gives a key/flag field's value for source
  // slot i (false: reset); ts_new(i) / cnt_new(i) the first_ts / count.
  // Inserted target slots are marked in touched[t] when mark is set.
  template <class ValF, class TsF, class CntF>
  __device__ void insert(int t, const unsigned char* ins, ValF val, TsF ts_new,
                         CntF cnt_new, bool mark) {
    const StDesc& st = d.st[t];
    unsigned char* fr = M(NMASK - 1);
    unsigned char* okm = M(NMASK - 2);
    each([&](int c) { fr[c] = !valid(t, c); });
    const int n_free = block_rank(fr, sm.rank0, C, sm.scan);
    const int n_ins = block_rank(ins, sm.rank1, C, sm.scan);
    each([&](int c) {
      if (fr[c]) sm.sor[sm.rank0[c]] = c;
      const int ok = ins[c] && sm.rank1[c] < n_free;
      okm[c] = (unsigned char)ok;
      if (!ok) return;
      for (int j = 0; j < st.nf; ++j) {
        const int f = st.fbase + j;
        const FDesc& fd = d.f[f];
        long long v;
        switch (fd.role) {
          case F_VALID: v = 1; break;
          case F_FIRST: v = ts_new(c); break;
          case F_COUNT: v = cnt_new(c); break;
          case F_CLOSED: v = 0; break;
          default:
            if (!val(fd, c, v)) v = fd.role == F_ARRIVE ? -1 : 0;
            v = cast_val(v, fd.ty, fd.ty);
        }
        sm.stage[(long long)j * C + c] = v;
      }
    });
    each([&](int c) {
      if (!okm[c]) return;
      const int tg = sm.sor[sm.rank1[c]];
      for (int j = 0; j < st.nf; ++j)
        T(st.fbase + j, tg) = sm.stage[(long long)j * C + c];
      if (mark) touched(t)[tg] = 1;
    });
    if (n_ins > n_free) drops += n_ins - n_free;
  }

  // ---- emission into output row `row` for the slots in mask. env(k, c, v)
  // gives the site's environment value of key k (false: not in the env).
  template <class EnvF>
  __device__ void emit(int row, const unsigned char* mask, EnvF env) {
    each([&](int c) {
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
      const long long* E = sm.E;
      const long long* ev = sm.evv;
      const int C_ = C;
      for (int o = 0; o < d.nout; ++o) {
        const long long v = eval_prog(
            a.code, d.out[o], [ev](int k) { return ev[k]; },
            [E, C_, c](int k) { return E[(long long)k * C_ + c]; });
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
    nmatch += count(mask);
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

  __device__ bool clocked(int s) {
    return d.st[s].kind == S_ABSENT || (d.st[s].kind == S_LOGICAL && d.st[s].has_wait);
  }

  __device__ void logical_state(int s, long long seeds0);
  __device__ void stream_or_count(int s, long long seeds0, int count0_open_pre);
  __device__ void seed_state0(long long seeds0, int count0_open_pre);
};

// ------------------------------------------------------- logical states

__device__ void Ctx::logical_state(int s, long long seeds0) {
  const StDesc& st = d.st[s];
  const bool is_and = st.ltype == L_AND;
  int pres[2], np = 0, abs_[2], na = 0;
  for (int bi = 0; bi < st.nbr; ++bi) {
    if (st.br_absent[bi]) abs_[na++] = bi;
    else pres[np++] = bi;
  }
  unsigned char* bm0 = M(0);
  unsigned char* bm1 = M(1);
  unsigned char* bm[2] = {bm0, bm1};
  unsigned char* adv = M(2);
  unsigned char* to = touched(s);
  each([&](int c) {
    for (int bi = 0; bi < st.nbr; ++bi)
      bm[bi][c] = valid(s, c) && gate(st.br_stream[bi]) && pred(st.pred[bi], c);
  });
  if (na) {
    each([&](int c) {
      int y = 0;
      for (int i = 0; i < na; ++i) y |= bm[abs_[i]][c];
      if (s == 0 && st.has_wait) {
        if (y) T(st.f_arrive, c) = ev_ts;
      } else if (st.ltype == L_OR) {
        for (int i = 0; i < na; ++i)
          if (bm[abs_[i]][c]) T(st.f_absdead[abs_[i]], c) = 1;
      } else if (y) {
        T(st.f_valid, c) = 0;
      }
      if (y) to[c] = 1;
      for (int bi = 0; bi < st.nbr; ++bi) bm[bi][c] = bm[bi][c] && !y;
    });
  }

  const bool rearm = s == 0 && d.always_seed && (na > 0);
  if (is_and && !na) {
    // both sides must arrive (any order); one event may satisfy both.
    // The bind is applied to the table first: values/adv_src are the
    // post-bind table.
    each([&](int c) {
      for (int bi = 0; bi < 2; ++bi) {
        const bool m = bm[bi][c];
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
    const int bi0 = pres[0];
    each([&](int c) {
      const bool m0 = bm[bi0][c];
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
  } else {
    // OR — or `X and not Y` (a present match advances); values are the
    // pre-kill table with the matched side bound
    unsigned char* m1 = M(3);
    each([&](int c) {
      const int a0 = bm[pres[0]][c];
      const int a1 = np > 1 ? (bm[pres[1]][c] && !a0) : 0;
      m1[c] = (unsigned char)a1;
      adv[c] = (unsigned char)(a0 || a1);
      if (a0 || a1) to[c] = 1;
    });
    const int n_adv = count(adv);
    auto values = [&](int k, int i, long long& v) -> bool {
      if (side(s, pres[0], k, bm[pres[0]][i] != 0, 0, v)) return true;
      if (np > 1 && side(s, pres[1], k, m1[i] != 0, 0, v)) return true;
      if (d.key[k].q < s) return tab(s, k, i, v);
      return false;
    };
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

  // ---- eligible candidates from a min-reached PREV count
  if (s > 0 && d.st[s - 1].kind == S_COUNT && !st.has_wait) {
    const StDesc& pv = d.st[s - 1];
    unsigned char* to_p = touched(s - 1);
    unsigned char* m1p = M(3);
    each([&](int c) {
      const int elig = valid(s - 1, c) && T(pv.f_count, c) >= pv.min_count;
      for (int bi = 0; bi < st.nbr; ++bi)
        bm[bi][c] = elig && gate(st.br_stream[bi]) && pred(st.pred_prev[bi], c);
    });
    each([&](int c) {
      if (na) {
        int kill = 0;
        for (int i = 0; i < na; ++i) kill |= bm[abs_[i]][c];
        if (kill) { T(pv.f_valid, c) = 0; to_p[c] = 1; }
        for (int bi = 0; bi < st.nbr; ++bi) bm[bi][c] = bm[bi][c] && !kill;
      }
      const int a0 = bm[pres[0]][c];
      const int a1 = np > 1 ? (bm[pres[1]][c] && !a0) : 0;
      m1p[c] = (unsigned char)a1;
      adv[c] = (unsigned char)(a0 || a1);
      if (a0 || a1) to_p[c] = 1;
    });
    auto valuesp = [&](int k, int i, long long& v) -> bool {
      if (side(s, pres[0], k, bm[pres[0]][i] != 0, 0, v)) return true;
      if (np > 1 && side(s, pres[1], k, m1p[i] != 0, 0, v)) return true;
      if (d.key[k].q < s) return tab(s - 1, k, i, v);
      return false;
    };
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

  // ---- seeding at a logical state 0 (absent-bearing logicals are
  // pre-seeded at init and re-armed in place instead)
  if (s == 0 && !na) {
    const bool seeds_ok = (d.always_seed && !is_and) ? true : seeds0 > 0;
    int cans[2] = {0, 0};
    int taken = 0;
    for (int i = 0; i < np; ++i) {
      const int bi = pres[i];
      const int g0 = gate(st.br_stream[bi]) && pred(st.pred_seed[bi], 0);
      const int cc = is_and ? g0 : (g0 && !taken);
      taken |= cc;
      cans[bi] = cc && seeds_ok;
    }
    const int can_any = taken && seeds_ok;
    unsigned char* ins = M(4);
    // seed_vals: the matched sides' event columns (zeros elsewhere)
    auto seedv = [&](int k, long long& v) -> bool {
      for (int i = 0; i < np; ++i)
        if (side(0, pres[i], k, cans[pres[i]] != 0, 0, v)) return true;
      return false;
    };
    if (is_and) {
      int seed_done = can_any;
      for (int i = 0; i < np; ++i) seed_done = seed_done && cans[pres[i]];
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
               if (fd.role == F_DONE) { v = cans[fd.bi]; return true; }
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

__device__ void Ctx::stream_or_count(int s, long long seeds0, int count0_open_pre) {
  const StDesc& st = d.st[s];
  unsigned char* to = touched(s);
  const int g = gate(st.br_stream[0]);
  if (st.kind == S_COUNT) {
    unsigned char* fire = M(0);
    each([&](int c) {
      const int ext = valid(s, c) && !T(st.f_closed, c) && g && pred(st.pred[0], c);
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
      emit(0, fire, [&](int k, int c, long long& v) { return tab(s, k, c, v); });
      const int n_fire = count(fire);
      each([&](int c) { if (fire[c]) T(st.f_valid, c) = 0; });
      if (d.every_end == s) seeds += n_fire;
    }
  } else {
    unsigned char* cand[2] = {M(0), M(1)};
    const int has_prev = s > 0 && d.st[s - 1].kind == S_COUNT;
    each([&](int c) {
      cand[0][c] = (unsigned char)(valid(s, c) && g && pred(st.pred[0], c) &&
                                   !(st.f_fresh >= 0 && T(st.f_fresh, c)));
      if (has_prev) {
        const StDesc& pv = d.st[s - 1];
        cand[1][c] = (unsigned char)(valid(s - 1, c) &&
                                     T(pv.f_count, c) >= pv.min_count && g &&
                                     pred(st.pred_prev[0], c));
      }
    });
    const int S = d.S;
    const int tgt_final_min0 = s + 1 == S - 1 && d.st[S - 1].kind == S_COUNT &&
                               d.st[S - 1].min_count == 0;
    for (int src_i = 0; src_i < 1 + has_prev; ++src_i) {
      const int lvl = s - src_i;
      const unsigned char* matched = cand[src_i];
      unsigned char* to_l = touched(lvl);
      each([&](int c) { if (matched[c]) to_l[c] = 1; });
      const int n_adv = count(matched);
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
__device__ void Ctx::seed_state0(long long seeds0, int count0_open_pre) {
  const StDesc& st = d.st[0];
  int can_seed = gate(st.br_stream[0]) && pred(st.pred_seed[0], 0);
  if (!d.always_seed) can_seed = can_seed && seeds0 > 0;
  if (st.kind == S_COUNT) can_seed = can_seed && !count0_open_pre;
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
  each([&](int c) { ins[c] = (unsigned char)(c == 0 && can_seed); });
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

// ------------------------------------------------------------- the kernel

__global__ void __launch_bounds__(MAXC) nfa_scan_step_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ScanDesc& d = *a.d;
  Ctx x(d, a);
  smem_layout(d, &x.sm, smem_raw);
  const int C = d.C, l = blockIdx.x, B = a.B;
  x.C = C; x.l = l; x.B = B;
  const long long lc = (long long)l * C;
  const int tid = threadIdx.x;

  // ---- the lane's tables and counters
  x.each([&](int c) {
    for (int f = 0; f < d.F; ++f) x.T(f, c) = load_typed(a.field[f], d.f[f].ty, lc + c);
  });
  x.seeds = a.seeds[l];
  x.drops = a.drops[l];
  x.nmatch = a.matches[l];
  int nv = a.nvalid[l];
  const long long base = a.ts_base[l];

  for (int b = 0; b < B; ++b) {
    x.b = b;
    // ---- the event (every thread reads the same values)
    for (int c = tid; c < d.ncol; c += blockDim.x)
      x.sm.evv[c] = load_typed(a.col[c], d.col_ty[c], (long long)l * B + b);
    __syncthreads();
    x.ev_ts = base + (long long)a.ts[(long long)l * B + b];
    x.ev_tag = a.tag[(long long)l * B + b];
    x.ev_ok = b < nv;
    if (tid == 0) a.y_ts[(long long)l * B + b] = x.ev_ts;
    const int S = d.S;
    x.each([&](int c) { for (int s = 0; s < S; ++s) x.touched(s)[c] = 0; });

    // ---- within-expiry reclaims slots
    if (d.has_within) {
      for (int s = 0; s < S; ++s) {
        unsigned char* ex = x.M(0);
        x.each([&](int c) {
          const long long f = x.T(d.st[s].f_first, c);
          const int alive = !(f >= 0 && x.ev_ts - f > d.within);
          ex[c] = (unsigned char)(x.valid(s, c) && !alive);
          if (!alive) x.T(d.st[s].f_valid, c) = 0;
        });
        if (!d.always_seed && d.every_end >= 0 && s <= d.every_end)
          x.seeds += x.count(ex);
      }
    }

    // ---- zero-min count scope start: a pre-seeded empty partial
    if (d.st[0].kind == S_COUNT && d.st[0].min_count == 0) {
      unsigned char* op = x.M(0);
      x.each([&](int c) { op[c] = x.valid(0, c) && !x.T(d.st[0].f_closed, c); });
      const int has_open = x.count(op) > 0;
      const int want = x.ev_ok && !has_open && (d.always_seed || x.seeds > 0);
      unsigned char* ins = x.M(4);
      x.each([&](int c) { ins[c] = (unsigned char)(c == 0 && want); });
      x.insert(0, ins, [](const FDesc&, int, long long&) { return false; },
               [](int) { return -1LL; }, [](int) { return 0LL; }, true);
      if (!d.always_seed) x.seeds -= want;
    }
    const long long seeds0 = x.seeds;

    // ---- expiry pre-pass over clocked states, ascending
    for (int s = 0; s < S; ++s) {
      if (!x.clocked(s)) continue;
      const StDesc& st = d.st[s];
      unsigned char* adv = x.M(2);
      x.each([&](int c) {
        const long long arr = x.T(st.f_arrive, c);
        int e = x.valid(s, c) && x.ev_ok && arr >= 0 && x.ev_ts >= arr + st.waiting;
        if (st.kind == S_LOGICAL) {
          for (int bi = 0; bi < st.nbr; ++bi) {
            if (st.ltype == L_AND && !st.br_absent[bi]) e = e && x.T(st.f_done[bi], c);
            if (st.ltype == L_OR && st.br_absent[bi]) e = e && !x.T(st.f_absdead[bi], c);
          }
        }
        adv[c] = (unsigned char)e;
        if (e) x.touched(s)[c] = 1;
      });
      const int n_adv = x.count(adv);
      // emission / insert read the table before this pre-pass changes it
      if (s == S - 1) {
        x.emit(0, adv, [&](int k, int c, long long& v) { return x.tab(s, k, c, v); });
      } else {
        x.insert(s + 1, adv,
                 [&](const FDesc& fd, int i, long long& v) {
                   if (fd.role == F_ARRIVE && x.clocked(s + 1)) {
                     v = x.T(st.f_arrive, i) + st.waiting;
                     return true;
                   }
                   if (fd.role != F_KEY || d.key[fd.key].q > s) return false;
                   return x.tab(s, fd.key, i, v);
                 },
                 [&](int i) { const long long f = x.T(st.f_first, i); return f >= 0 ? f : x.ev_ts; },
                 [](int) { return 0LL; }, true);
      }
      x.each([&](int c) {
        if (!adv[c]) return;
        if (s == 0 && d.always_seed) {
          // re-arm the start seed at the established boundary
          x.T(st.f_arrive, c) += st.waiting;
          x.T(st.f_first, c) = -1;
          for (int j = 0; j < st.nf; ++j) {
            const FDesc& fd = d.f[st.fbase + j];
            if (fd.role == F_DONE || fd.role == F_ABSDEAD ||
                (fd.role == F_KEY && d.key[fd.key].q == 0))
              x.T(st.fbase + j, c) = 0;
          }
        } else {
          x.T(st.f_valid, c) = 0;
        }
      });
      if (d.every_end == s) x.seeds += n_adv;
    }

    // openness of a state-0 count before this event's extensions
    int count0_open_pre = 0;
    if (d.st[0].kind == S_COUNT) {
      unsigned char* op = x.M(0);
      x.each([&](int c) { op[c] = x.valid(0, c) && !x.T(d.st[0].f_closed, c); });
      count0_open_pre = x.count(op) > 0;
    }

    // ---- the states, last to first
    for (int s = S - 1; s >= 0; --s) {
      const StDesc& st = d.st[s];
      if (st.kind == S_ABSENT) {
        const int g = x.gate(st.br_stream[0]);
        x.each([&](int c) {
          const int kill = x.valid(s, c) && g && x.pred(st.pred[0], c);
          if (!kill) return;
          if (s == 0) x.T(st.f_arrive, c) = x.ev_ts;
          else x.T(st.f_valid, c) = 0;
          x.touched(s)[c] = 1;
        });
      } else if (st.kind == S_LOGICAL) {
        x.logical_state(s, seeds0);
      } else {
        x.stream_or_count(s, seeds0, count0_open_pre);
      }
    }

    // ---- end of event: scope clones become visible; sequence strictness
    x.each([&](int c) {
      for (int s = 0; s < S; ++s) {
        if (d.st[s].f_fresh >= 0) x.T(d.st[s].f_fresh, c) = 0;
        if (d.is_seq && x.ev_ok && !x.touched(s)[c]) x.T(d.st[s].f_valid, c) = 0;
      }
    });
  }

  // ---- write the tables and counters back
  x.each([&](int c) {
    for (int f = 0; f < d.F; ++f) store_typed(a.field[f], d.f[f].ty, lc + c, x.T(f, c));
  });
  if (tid == 0) {
    a.seeds[l] = x.seeds;
    a.drops[l] = x.drops;
    a.matches[l] = x.nmatch;
  }
}

// ------------------------------------------------------------ C interface

extern "C" int nfa_scan_desc_size(void) { return (int)sizeof(ScanDesc); }
extern "C" int nfa_scan_args_size(void) { return (int)sizeof(ScanArgs); }

// Launches one step on `stream`: L CTAs of C threads (rounded up to a
// warp). Returns cudaGetLastError() after the launch (0 on success), -2 when
// a lane needs more shared memory than a block can have, -3 when C is out of
// range.
extern "C" int nfa_scan_step(const ScanArgs* args, const ScanDesc* host_desc,
                             void* stream) {
  const ScanDesc& d = *host_desc;
  if (d.C < 1 || d.C > MAXC) return -3;
  const size_t smem = smem_layout(d, nullptr, nullptr);
  if (smem > SMEM_LIMIT) return -2;
  cudaError_t e = cudaFuncSetAttribute(
      nfa_scan_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nt = ((d.C + 31) / 32) * 32;
  nfa_scan_step_kernel<<<args->L, nt, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
