"""Blocked NFA step: batch-level parallel pattern matching, lane-batched.

Port of the reference's ``tpu/nfa_block.py`` (and of the lane batching in
``tpu/partition.py:160-181``). For a linear chain of stream states whose
first state carries ``every``, a partial at state ``s`` advances on the
FIRST later event matching state ``s``'s predicate, so one batch resolves in
S sequential stages instead of B sequential events:

  stage s: cond[j, p] = valid[j] & tag[j] == stream(s) & within_ok[j, p]
                        & (j > born_p | sequence: vidx[j] == vb_p + 1)
                        & pred_s(event_j, bindings_p)
           j*(p) = first j with cond[j, p], 0 if none

Two forms of the step live here:

- ``block_step_plain``: a torch translation of the reference step over
  ``[L, ...]`` tensors (the lane axis replaces ``vmap``). It materialises the
  ``[L, B, P]`` grid like the reference does, runs on any device, and is what
  the CPU tests hold against the JAX package and what ``chip_smoke.py``
  holds the kernel against.
- ``BlockPlan.step_cuda``: the wrapper of the hand-written kernel
  ``csrc/nfa_block.cu`` (one launch per step: the seed gate and every
  stage in one cluster of CTAs per lane; no grid materialised, tables
  updated in place).

``make_block_step`` dispatches on where the tensors lie: CPU tensors run the
plain version, CUDA tensors launch the kernel or raise.

Capacity semantics (the reference's): per-batch creations are exact unless
``creation_cap`` K is set, which compacts each stage's creations to K
(order-preserving, drop-newest, counted in ``drops``); tables truncate to C
slots keep-oldest at batch boundaries, overflow counted in ``drops``.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from .dtypes import TORCH
from .expr_compile import (
    DTYPE_OF,
    OP,
    T_BOOL,
    T_I64,
    TY_OF,
    MAXSTACK,
    DeviceCompileError,
    as_tensor,
    astype,
    clause_form,
    link_ir,
)

if TYPE_CHECKING:
    from .nfa import DeviceNFACompiler

# limits of the kernel's argument block (csrc/nfa_block.cu #defines)
MAXCOL = 32
MAXB = 32
MAXOUT = 32
_TS_NONE = -(2 ** 62)
# the kernel's block and its shared-memory layout modes (csrc/nfa_block.cu)
NT = 512
SMEM_LIMIT = 227 * 1024
MODE_CRE_GLOBAL, MODE_ONE_TABLE, MODE_BATCH_GLOBAL = 1, 2, 4
MODES = (0, MODE_CRE_GLOBAL, MODE_CRE_GLOBAL | MODE_ONE_TABLE,
         MODE_CRE_GLOBAL | MODE_ONE_TABLE | MODE_BATCH_GLOBAL)
_PTRS_BYTES = 8 * (2 + MAXCOL + 2 * (3 + MAXB) + 1)   # sizeof(struct Ptrs)


def blocked_eligible(nfa: "DeviceNFACompiler") -> bool:
    """True when the pattern fits the blocked kernel's shape: a chain of
    stream states whose first state carries ``every`` (always-seed)."""
    return all(s.kind == "stream" for s in nfa.states) \
        and nfa.states[0].ends_every


def block_init_state(nfa: "DeviceNFACompiler", lanes: int = 1) -> dict:
    """``[lanes, C]`` tables for states 1..S-1 (seeds enter state 1; state 0
    holds nothing for stream chains) + per-lane counters, on ``nfa.device``.

    Invariant: table slots are packed in creation order (oldest first)."""
    C, dev = nfa.C, nfa.device
    has_ew = any(st.within_ms is not None for st in nfa.states)
    tables = {}
    for s in range(1, nfa.S):
        fields = {
            "valid": torch.zeros((lanes, C), dtype=torch.bool, device=dev),
            "first_ts": torch.full((lanes, C), -1, dtype=torch.int64, device=dev),
        }
        if has_ew:
            # time of the binding that brought the partial here (element-
            # level `within` measures gaps between consecutive elements)
            fields["last_ts"] = torch.full((lanes, C), -1, dtype=torch.int64,
                                           device=dev)
        for (q, key, t) in sorted(nfa.referenced):
            if q < s:
                fields[key] = torch.zeros((lanes, C), dtype=TORCH[t], device=dev)
        tables[f"t{s}"] = fields
    return {
        "tables": tables,
        "matches": torch.zeros(lanes, dtype=torch.int64, device=dev),
        "drops": torch.zeros(lanes, dtype=torch.int64, device=dev),
    }


def _binding_keys(nfa, s: int) -> list:
    """Referenced bound-value keys carried by a partial AT state s."""
    return [key for (q, key, t) in sorted(nfa.referenced) if q < s]


def _key_dtype(nfa, key: str) -> torch.dtype:
    for (q, k, t) in nfa.referenced:
        if k == key:
            return TORCH[t]
    raise KeyError(key)


def _key_col(nfa, key: str) -> str:
    """Merged column a binding key ``b{q}_{attr}`` is minted from."""
    q_str, attr = key[1:].split("_", 1)
    sid = nfa.compiled.alias_defs[nfa.states[int(q_str)].alias].id
    return nfa.merged.col_key(sid, attr)


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def block_step_plain(nfa: "DeviceNFACompiler", state, cols, tag, ts, ts_base,
                     nvalid, work: Optional[dict] = None):
    """The reference step over ``[L, ...]`` tensors; returns ``(state, ys)``
    with new state tensors (the input state is not modified).

    ``work``, when given, accumulates what this batch's data needs of a
    first-match search: ``cells`` (candidate × event tests up to each
    candidate's first hit) and ``ops`` (those tests' elementwise operations,
    predicate instructions included) — the measurement's lower bound."""
    C, S = nfa.C, nfa.S
    L, B = tag.shape
    dev = tag.device
    states = nfa.states
    within = nfa.within
    is_seq = nfa.is_sequence
    K = nfa.creation_cap
    has_ew = any(st.within_ms is not None for st in states)
    i32, i64 = torch.int32, torch.int64

    def new_binding_cols(s: int, idx=None):
        """Bindings minted when state ``s`` consumes an event: b{s}_attr."""
        out = {}
        for (q, key, t) in sorted(nfa.referenced):
            if q == s:
                col = cols[_key_col(nfa, key)].to(TORCH[t])
                out[key] = col if idx is None else col.gather(1, idx)
        return out

    tables = dict(state["tables"])
    matches = state["matches"]
    drops = state["drops"]

    jidx = torch.arange(B, dtype=i32, device=dev).expand(L, B)
    # wire format: int32 ts deltas + per-batch base, prefix validity
    ts = ts_base[:, None].to(i64) + ts.to(i64)
    valid = jidx < nvalid[:, None]
    ev_env = {f"ev_{k}": v for k, v in cols.items()}
    n_valid = valid.sum(1, dtype=i32)
    vidx = torch.cumsum(valid.to(i32), 1, dtype=i32)      # 1-based at valids
    ts_last = torch.where(valid, ts, torch.full_like(ts, _TS_NONE)).amax(1)

    # ---- seeds: state-0 predicate over the raw batch ----------------------
    st0 = states[0]
    gate0 = valid & (tag == st0.stream_idx)
    if st0.predicate is not None:
        env = dict(ev_env, __device__=dev)
        gate0 = gate0 & torch.broadcast_to(
            astype(as_tensor(st0.predicate(env), env), torch.bool), (L, B))

    if S == 1:
        # single-state every-pattern: each matching event IS a match
        out = {"mask": gate0, "j": jidx.contiguous(), "ts": ts}
        emit_env = dict(ev_env, __device__=dev)
        emit_env.update(new_binding_cols(0))
        for (name, fn, t) in nfa.out_specs:
            out[name] = torch.broadcast_to(
                astype(as_tensor(fn(emit_env), emit_env), TORCH[t]),
                (L, B)).contiguous()
        new_state = {"tables": tables, "drops": drops,
                     "matches": matches + gate0.sum(1, dtype=i64)}
        return new_state, out

    def scatter(vals, tgt, keep, n, fill):
        """``full(n, fill).at[tgt].set(where(keep, vals, fill), mode="drop")``
        along dim 1: slot ``n`` is the discard slot."""
        base = torch.full((L, n + 1), fill, dtype=vals.dtype, device=dev)
        src = torch.where(keep, vals, torch.full_like(vals, fill))
        return base.scatter_(1, tgt, src)[:, :n]

    def compact(cre):
        """Order-preserving compaction of a creations dict to K slots;
        returns (creations, n_dropped). Identity when no budget is set."""
        ex = cre["exists"]
        n = ex.shape[1]
        if K is None or n <= K:
            return cre, torch.zeros(L, dtype=i64, device=dev)
        rank = torch.cumsum(ex.to(i32), 1, dtype=i32) - 1
        tgt = torch.where(ex & (rank < K), rank, K).to(i64)
        out = {
            "exists": scatter(ex, tgt, ex, K, False),
            "born": scatter(cre["born"], tgt, ex, K, 0),
            "vb": scatter(cre["vb"], tgt, ex, K, 0),
            "first_ts": scatter(cre["first_ts"], tgt, ex, K, -1),
            "bind": {k: scatter(v, tgt, ex, K, 0)
                     for k, v in cre["bind"].items()},
        }
        if "last_ts" in cre:
            out["last_ts"] = scatter(cre["last_ts"], tgt, ex, K, -1)
        dropped = torch.clamp(ex.sum(1, dtype=i64) - K, min=0)
        return out, dropped

    # creations entering state 1
    cre0 = {
        "exists": gate0,
        "born": jidx,                                  # batch position
        "vb": vidx,                                    # vidx[born]
        "first_ts": ts,
        "bind": new_binding_cols(0),                   # b0_* [L, B]
    }
    if has_ew:
        cre0["last_ts"] = ts
    creations, dropped = compact(cre0)
    drops = drops + dropped

    ys = None
    for s in range(1, S):
        st = states[s]
        tbl = tables[f"t{s}"]
        Pc = creations["exists"].shape[1]
        P = C + Pc

        # candidate arrays: old slots first, then creations (born order)
        cand_exists = torch.cat([tbl["valid"], creations["exists"]], 1)
        cand_born = torch.cat([torch.full((L, C), -1, dtype=i32, device=dev),
                               creations["born"]], 1)
        cand_vb = torch.cat([torch.zeros((L, C), dtype=i32, device=dev),
                             creations["vb"]], 1)
        cand_first = torch.cat([tbl["first_ts"], creations["first_ts"]], 1)
        cand_last = torch.cat([tbl["last_ts"], creations["last_ts"]], 1) \
            if has_ew else None
        cand_bind = {}
        for key in _binding_keys(nfa, s):
            dt = _key_dtype(nfa, key)
            new = creations["bind"].get(key)
            if new is None:
                new = torch.zeros((L, Pc), dtype=dt, device=dev)
            cand_bind[key] = torch.cat([tbl[key].to(dt), new.to(dt)], 1)

        # ---- the [L, B, P] grid -------------------------------------------
        gate = valid & (tag == st.stream_idx)              # [L, B]
        grid = gate[:, :, None] & cand_exists[:, None, :]
        if st.predicate is not None:
            env = {k: v[:, :, None] for k, v in ev_env.items()}
            env.update({k: v[:, None, :] for k, v in cand_bind.items()})
            env["__device__"] = dev
            pred = astype(as_tensor(st.predicate(env), env), torch.bool)
            grid = grid & torch.broadcast_to(pred, (L, B, P))
        if within is not None:
            grid = grid & ((ts[:, :, None] - cand_first[:, None, :]) <= within)
        if st.within_ms is not None:
            # element-level: the gap since the PREVIOUS element's bind
            grid = grid & ((ts[:, :, None] - cand_last[:, None, :])
                           <= st.within_ms)
        if is_seq:
            grid = grid & (vidx[:, :, None] == cand_vb[:, None, :] + 1)
        else:
            grid = grid & (jidx[:, :, None] > cand_born[:, None, :])

        adv = grid.any(1)                                  # [L, P]
        # first true j; 0 on an all-false column, as jnp.argmax gives
        jstar = torch.argmax(grid.to(torch.uint8), 1).to(i32)
        if work is not None:
            _count_work(work, nfa, s, cand_exists, adv, jstar, cand_born,
                        cand_vb, nvalid)
        jl = jstar.to(i64)
        ts_j = ts.gather(1, jl)

        if s == S - 1:
            # ---- emission -----------------------------------------------
            ys = {"mask": adv, "j": jstar, "ts": ts_j}
            emit_env = {k: v.gather(1, jl) for k, v in ev_env.items()}
            emit_env.update(cand_bind)
            emit_env.update(new_binding_cols(s, jl))
            emit_env["__device__"] = dev
            for (name, fn, t) in nfa.out_specs:
                ys[name] = torch.broadcast_to(
                    astype(as_tensor(fn(emit_env), emit_env), TORCH[t]),
                    (L, P)).contiguous()
            matches = matches + adv.sum(1, dtype=i64)
        else:
            # ---- creations for state s+1 --------------------------------
            nbind = {key: cand_bind[key] for key in _binding_keys(nfa, s + 1)
                     if key in cand_bind}
            nbind.update(new_binding_cols(s, jl))
            cre_n = {
                "exists": adv,
                "born": jstar,
                "vb": vidx.gather(1, jl),
                "first_ts": torch.where(cand_first >= 0, cand_first, ts_j),
                "bind": nbind,
            }
            if has_ew:
                cre_n["last_ts"] = ts_j
            creations, dropped = compact(cre_n)
            drops = drops + dropped

        # ---- survivors → new table s (truncate to C, keep-oldest) ---------
        surv = cand_exists & ~adv
        if within is not None:
            surv = surv & ((ts_last[:, None] - cand_first) <= within)
        if st.within_ms is not None:
            # a lapsed element window can never match again — prune
            surv = surv & ((ts_last[:, None] - cand_last) <= st.within_ms)
        if is_seq:
            # strict continuity: survive only if no valid event followed
            surv = surv & (cand_vb == n_valid[:, None])
        rank = torch.cumsum(surv.to(i32), 1, dtype=i32) - 1
        tgt = torch.where(surv & (rank < C), rank, C).to(i64)
        ntbl = {
            "valid": scatter(surv, tgt, surv, C, False),
            "first_ts": scatter(cand_first, tgt, surv, C, -1),
        }
        if has_ew:
            ntbl["last_ts"] = scatter(cand_last, tgt, surv, C, -1)
        for key in _binding_keys(nfa, s):
            ntbl[key] = scatter(cand_bind[key], tgt, surv, C, 0)
        tables[f"t{s}"] = ntbl
        drops = drops + torch.clamp(surv.sum(1, dtype=i64) - C, min=0)

    return {"tables": tables, "matches": matches, "drops": drops}, ys


def _count_work(work, nfa, s, exists, adv, jstar, born, vb, nvalid):
    nv = torch.clamp(nvalid.to(torch.int64), 0, nfa.B)[:, None]
    if nfa.is_sequence:
        tested = ((vb >= 0) & (vb.to(torch.int64) < nv)).to(torch.int64)
    else:
        lo = born.to(torch.int64) + 1
        tested = torch.where(adv, jstar.to(torch.int64) - lo + 1,
                             torch.clamp(nv - lo, min=0))
    cells = int((tested * exists).sum())
    st = nfa.states[s]
    per_cell = 2 + 2 * (nfa.within is not None) + 2 * (st.within_ms is not None) \
        + len(st.predicate_ir or ())
    work["cells"] = work.get("cells", 0) + cells
    work["ops"] = work.get("ops", 0) + cells * per_cell


# --------------------------------------------------------------------------
# the kernel wrapper
# --------------------------------------------------------------------------

class _Prog(ctypes.Structure):
    _fields_ = [("off", ctypes.c_int), ("len", ctypes.c_int)]


class BlockStage(ctypes.Structure):
    """Mirror of ``struct BlockStage`` in ``csrc/nfa_block.cu``."""
    _fields_ = [
        *[(n, ctypes.c_int) for n in (
            "sidx", "pc_in", "compact_out", "nbind", "nbind_out", "tp_off",
            "has_sw", "pad_")],
        ("sw", ctypes.c_longlong),
        ("pred", _Prog), ("cpred", _Prog),
        ("pad2_", ctypes.c_int * 2),
    ]


class BlockDesc(ctypes.Structure):
    """Mirror of ``struct BlockDesc`` in ``csrc/nfa_block.cu`` (followed in
    the uploaded descriptor by one ``BlockStage`` per state)."""
    _fields_ = [
        *[(n, ctypes.c_int) for n in (
            "S", "B", "C", "K", "is_seq", "has_within", "has_ew",
            "seed_compact")],
        ("within", ctypes.c_longlong),
        *[(n, ctypes.c_int) for n in (
            "sidx0", "ncol", "nbind_max", "nout", "cap", "ncode", "ntp",
            "np")],
        ("col_ty", ctypes.c_int * MAXCOL),
        ("key_ty", ctypes.c_int * MAXB),
        ("key_col", ctypes.c_int * MAXB),
        ("out_ty", ctypes.c_int * MAXOUT),
        ("seed", _Prog), ("cseed", _Prog),
        ("out", _Prog * MAXOUT),
    ]


class BlockArgs(ctypes.Structure):
    """Mirror of ``struct BlockArgs`` in ``csrc/nfa_block.cu``: one step's
    pointers."""
    _fields_ = [
        *[(n, ctypes.c_int) for n in ("L", "mode", "cluster", "pad_")],
        *[(n, ctypes.c_void_p) for n in ("desc", "code", "tptr", "scratch")],
        ("col", ctypes.c_void_p * MAXCOL),
        *[(n, ctypes.c_void_p) for n in (
            "tag", "ts", "ts_base", "nvalid", "matches", "drops", "y_mask",
            "y_j", "y_ts")],
        ("out_ptr", ctypes.c_void_p * MAXOUT),
    ]


def _desc_head() -> int:
    return (ctypes.sizeof(BlockDesc) + 15) & ~15


def smem_layout(d: "BlockDesc", mode: int, cl: int) -> tuple[int, int]:
    """(shared-memory bytes a CTA needs, bytes of one creation buffer) for
    descriptor ``d`` under layout ``mode`` with ``cl`` CTAs a lane: the
    kernel's ``smem_layout``, region by region."""
    def carve(n):
        return (n + 15) & ~15

    def room(n):                        # a row staged by 16-byte lines
        return n + 32

    def size(ty):
        return 1 if ty == T_BOOL else (8 if ty == T_I64 else 4)
    B, C, cap, nb = d.B, d.C, d.cap, d.nbind_max
    cre = (carve(cap) + 2 * carve(4 * cap) + carve(8 * cap)
           + carve(8 * cap if d.has_ew else 0) + carve(8 * cap * nb))
    tab = (carve(room(C)) + carve(room(8 * C))
           + carve(room(8 * C) if d.has_ew else 0)
           + sum(carve(room(C * size(d.key_ty[k]))) for k in range(nb)))
    off = (carve(_desc_head() + d.S * ctypes.sizeof(BlockStage))
           + carve(16 * d.ncode) + carve(8 * d.ntp) + carve(_PTRS_BYTES))
    if not mode & MODE_BATCH_GLOBAL:
        off += carve(room(4 * B)) + carve(room(B)) + sum(
            carve(room(B * size(d.col_ty[c]))) for c in range(d.ncol))
    off += 2 * carve(8 * ((B + 31) // 32))            # cmin, cmax
    tabs = 1 if mode & MODE_ONE_TABLE else 2
    off += tabs * carve(tab if d.S > 1 else 0)
    if d.S > 1 and not mode & MODE_CRE_GLOBAL:
        off += 2 * carve(cre)
    nfb = 2 if cl > 1 else 1
    off += (carve(nfb * d.np) + carve(4 * nfb * d.np) + 2 * carve(4 * d.np)
            + carve(8 * (NT // 32) * max(nb, 1)) + carve(4 * 2 * 2 * (NT // 32)))
    return off, cre


def block_layout(d: "BlockDesc", clusters: tuple):
    """(CTAs a lane, layout mode, global scratch bytes a lane) of the first
    plan that fits in a block's shared memory, in the kernel's order
    (``nfa_block_plan``): each of ``clusters`` with the batch staged (modes
    0, 1, 3), then each with the batch left in global memory (mode 7), so a
    plan that fits without that mode keeps its layout; None where none
    fits."""
    for modes in (MODES[:-1], MODES[-1:]):
        for cl in clusters:
            for mode in modes:
                need, cre = smem_layout(d, mode, cl)
                if need <= SMEM_LIMIT:
                    scratch = 2 * cl * cre \
                        if mode & MODE_CRE_GLOBAL and d.S > 1 else 0
                    return cl, mode, scratch
    return None


def link_program(ir: list, col_slot: dict, bind_slot: dict,
                 ev_alias: Optional[dict] = None) -> np.ndarray:
    """Resolves a pattern program's env keys to kernel slots: ``ev_<col>``
    → event column slot, a binding key → candidate binding index, or
    (``ev_alias``) a binding minted by the matched event itself → its event
    column slot."""
    ev_alias = ev_alias or {}

    def operand(op, a):
        if op == OP["EV"]:
            return op, col_slot[a[3:]]
        if op == OP["BIND"]:
            if a in ev_alias:
                return OP["EV"], ev_alias[a]
            if a in bind_slot:
                return op, bind_slot[a]
            raise DeviceCompileError(
                f"'{a}' is not bound when this program runs")
        return op, a

    return link_ir(ir, operand)


class BlockPlan:
    """The compiled plan's kernel side: linked programs, the descriptor the
    kernel reads (uploaded once per device) and the launch wrapper. One
    launch a step; ``launches`` counts kernel launches.

    The global scratch of a layout that keeps its creations there is
    allocated once per (device, lanes, stream) and reused by every launch
    on that stream, so lane ranges stepped on streams of their own (a split
    ``PartitionedNFARuntime``) never share it."""

    launches = 0          # class-wide: every launch of the step kernel
    LAUNCHES = 1          # launches a step
    CLUSTER = 2           # CTAs a lane where their plan fits, else one

    def __init__(self, nfa: "DeviceNFACompiler"):
        self.nfa = nfa
        C, S, B, K = nfa.C, nfa.S, nfa.B, nfa.creation_cap
        self.col_keys = nfa.kernel_columns()
        self.col_ty = [TY_OF[TORCH[nfa.column_type(k)]] for k in self.col_keys]
        col_slot = {k: i for i, k in enumerate(self.col_keys)}
        if len(self.col_keys) > MAXCOL:
            raise DeviceCompileError(f"more than {MAXCOL} event columns")
        self.has_ew = any(st.within_ms is not None for st in nfa.states)

        # creation sizes entering each stage (static, as the reference's)
        self.pc = {}
        n = B
        for s in range(1, S):
            self.pc[s] = n if K is None or n <= K else K
            n = C + self.pc[s]
        self.seed_compact = K is not None and B > K
        self.keys = {s: _binding_keys(nfa, s) for s in range(S + 1)}
        # keys[s] is a prefix of keys[s+1] (sorted by state), so binding k
        # is the same key at every stage that carries it
        nbind_max = max(len(self.keys[s]) for s in range(S))
        if nbind_max > MAXB:
            raise DeviceCompileError(f"more than {MAXB} bound values")

        progs = []
        # eventTimestamp() reads `__ts__`, which the reference's step env
        # lacks: it raises KeyError at its first step, and so does this one
        self.link_error = None

        def add(ir, bind_slot, ev_alias=None):
            if ir is None:
                return (0, 0)
            if any(op == OP["TS"] for (op, _, _, _) in ir):
                self.link_error = KeyError("__ts__")
            code = link_program(ir, col_slot, bind_slot, ev_alias)
            off = sum(len(p) for p in progs)
            progs.append(code)
            return (off, len(code))

        def add_clauses(prog):
            """The clause form of a linked predicate, (0, 0) if it has none."""
            off, n = prog
            if not n:
                return (0, 0)
            words = clause_form(progs[-1], off)
            if words is None:
                return (0, 0)
            coff = sum(len(p) for p in progs)
            progs.append(words)
            return (coff, len(words) // 2)

        minted = {}          # binding key → event column slot at its state
        for (q, key, t) in nfa.referenced:
            minted.setdefault(q, {})[key] = col_slot[_key_col(nfa, key)]
        self.seed = add(nfa.states[0].predicate_ir, {})
        self.cseed = add_clauses(self.seed)
        self.stages = {}
        last = S - 1
        for s in range(1 if S > 1 else 0, S):
            bslot = {k: i for i, k in enumerate(self.keys[s])}
            info = {"pred": add(nfa.states[s].predicate_ir, bslot) if s else (0, 0)}
            info["cpred"] = add_clauses(info["pred"])
            if s == last:
                info["out"] = [add(ir, bslot, minted.get(s, {}))
                               for ir in nfa.out_irs]
            self.stages[s] = info
        if len(nfa.out_irs) > MAXOUT:
            raise DeviceCompileError(f"more than {MAXOUT} outputs")
        self.out_ty = [TY_OF[TORCH[t]] for (_, _, t) in nfa.out_specs]
        self.code_host = np.concatenate(progs) if progs else \
            np.zeros((1, 4), np.int32)

        # the descriptor: BlockDesc, then one BlockStage per state
        d = BlockDesc()
        d.S, d.B, d.C, d.K = S, B, C, -1 if K is None else K
        d.is_seq = int(nfa.is_sequence)
        d.has_within = int(nfa.within is not None)
        d.within = nfa.within or 0
        d.has_ew = int(self.has_ew)
        d.seed_compact = int(self.seed_compact)
        d.sidx0 = nfa.states[0].stream_idx
        d.ncol = len(self.col_keys)
        for i, ty in enumerate(self.col_ty):
            d.col_ty[i] = ty
        d.nbind_max = nbind_max
        for k, key in enumerate(self.keys[S - 1]):
            d.key_ty[k] = TY_OF[_key_dtype(nfa, key)]
            q = int(key[1:].split("_", 1)[0])
            d.key_col[k] = minted[q][key]
        d.nout = len(nfa.out_irs)
        for i, (off, n) in enumerate(self.stages[last]["out"]):
            d.out[i] = _Prog(off, n)
            d.out_ty[i] = self.out_ty[i]
        d.seed, d.cseed = _Prog(*self.seed), _Prog(*self.cseed)
        d.cap = max(self.pc.values()) if S > 1 else 0
        d.np = max([B] + [C + n for n in self.pc.values()])
        d.ncode = len(self.code_host)
        stages = (BlockStage * S)()
        tp = 0
        for s in range(1, S):
            st, info = stages[s], self.stages[s]
            st.sidx = nfa.states[s].stream_idx
            st.pc_in = self.pc[s]
            st.compact_out = int(s < last and K is not None and C + self.pc[s] > K)
            st.nbind = len(self.keys[s])
            st.nbind_out = len(self.keys[s + 1]) if s < last else 0
            st.tp_off = tp
            tp += 3 + st.nbind            # valid, first_ts, last_ts, bindings
            sw = nfa.states[s].within_ms
            st.has_sw, st.sw = int(sw is not None), sw or 0
            st.pred, st.cpred = _Prog(*info["pred"]), _Prog(*info["cpred"])
        d.ntp = tp
        self.desc = d
        # the kernel's layout, mirrored here so that a plan no layout fits is
        # refused when it is built, on every device, not at its first step
        if self.layout_mirror is None:
            need, _ = smem_layout(d, MODES[-1], 1)
            raise DeviceCompileError(
                f"blocked kernel: a lane needs {need} B of shared memory with "
                f"its batch and creations in global memory, more than a "
                f"block has ({SMEM_LIMIT} B); lower lane_batch or "
                f"slot_capacity, or set creation_cap")
        blob = bytes(d).ljust(_desc_head(), b"\0") + bytes(stages)
        self.desc_host = ctypes.create_string_buffer(blob, len(blob))
        self._desc_np = np.frombuffer(blob, dtype=np.uint8).copy()
        # the state's leaves in the kernel's order (counters, then per stage
        # the table fields the pointer table lists) with their checks
        self._leaf_specs = [("matches", torch.int64, False),
                            ("drops", torch.int64, False)]
        for s in range(1, S):
            fields = [("valid", torch.bool), ("first_ts", torch.int64),
                      ("last_ts", torch.int64 if self.has_ew else None)]
            fields += [(key, _key_dtype(nfa, key)) for key in self.keys[s]]
            self._leaf_specs += [(f"t{s}.{k}", dt, True) for k, dt in fields]
        self._out_groups = {}    # output dtype → [(index, name)]
        for o, (name, _, t) in enumerate(nfa.out_specs):
            self._out_groups.setdefault(TORCH[t], []).append((o, name))
        self._out_groups = list(self._out_groups.items())
        self._dev = {}           # device → (descriptor, code) uploaded
        self._state = {}         # (device, stream) → (checked leaves, pointers)
        self._args = {}          # (device, L, stream) → BlockArgs template
        self._layout = None      # layout()
        self._checked = False

    @property
    def layout_mirror(self):
        """The layout the kernel takes (``layout``), computed in Python:
        (CTAs a lane, layout mode, global scratch bytes a lane), None where
        no layout fits."""
        return block_layout(self.desc, (self.CLUSTER, 1))

    # -- kernel side ---------------------------------------------------------
    def _on(self, dev):
        got = self._dev.get(dev)
        if got is None:
            got = (torch.from_numpy(self._desc_np).to(dev),
                   torch.from_numpy(self.code_host).to(dev))
            self._dev[dev] = got
        return got

    def _lib(self):
        from ._build import load
        lib = load("nfa_block")
        if not self._checked:
            lib.nfa_block_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p]
            lib.nfa_block_step.restype = ctypes.c_int
            lib.nfa_block_plan.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
            lib.nfa_block_plan.restype = ctypes.c_int
            for fn, size in ((lib.nfa_block_desc_head, _desc_head()),
                             (lib.nfa_block_stage_size,
                              ctypes.sizeof(BlockStage)),
                             (lib.nfa_block_args_size,
                              ctypes.sizeof(BlockArgs)),
                             (lib.nfa_block_ptrs_size, _PTRS_BYTES)):
                fn.restype = ctypes.c_int
                if fn() != size:
                    raise RuntimeError(
                        f"{fn.__name__}: the layout differs between "
                        f"nfa_block.cu ({fn()} B) and the ctypes mirror "
                        f"({size} B)")
            self._checked = True
        return lib

    def layout(self, lib) -> tuple:
        """(CTAs a lane, layout mode, global scratch bytes a lane) the
        kernel takes: ``CLUSTER`` CTAs a lane where their plan fits in
        shared memory, else one (a cluster doubles the per-candidate
        flags); creations in shared memory where they fit, the batch in
        global memory only where nothing else fits. Asks the kernel's own
        ``nfa_block_plan``, which must agree with ``layout_mirror``."""
        if self._layout is None:
            got = None
            for cl, bg in ((cl, bg) for bg in (0, 1)
                           for cl in (self.CLUSTER, 1)):
                mode, scratch = ctypes.c_int(), ctypes.c_longlong()
                if lib.nfa_block_plan(self.desc_host, cl, bg,
                                      ctypes.byref(mode),
                                      ctypes.byref(scratch)) == 0:
                    got = (cl, mode.value, scratch.value)
                    break
            if got != self.layout_mirror:
                raise RuntimeError(
                    f"nfa_block: the kernel's layout {got} differs from the "
                    f"Python mirror's {self.layout_mirror}")
            self._layout = got
        return self._layout

    def _state_leaves(self, state) -> list:
        """matches, drops, then per stage valid, first_ts, last_ts (None
        without element-level within) and the bindings."""
        leaves = [state["matches"], state["drops"]]
        tables = state["tables"]
        for s in range(1, self.nfa.S):
            tbl = tables[f"t{s}"]
            leaves += [tbl["valid"], tbl["first_ts"],
                       tbl["last_ts"] if self.has_ew else None]
            leaves += [tbl[key] for key in self.keys[s]]
        return leaves

    def _state_on(self, state, L: int, dev, stream):
        """Checks the state's leaves and uploads the tables' pointers (per
        stage: valid, first_ts, last_ts, bindings); both again only when
        the leaves are other tensors than the last step's (a step updates
        them in place). Returns (matches, drops, pointer table)."""
        leaves = self._state_leaves(state)
        got = self._state.get((dev, stream))
        if got is None or len(got[0]) != len(leaves) or \
                any(a is not b for a, b in zip(leaves, got[0])):
            C = self.nfa.C
            for t, (name, dt, per_slot) in zip(leaves, self._leaf_specs):
                if dt is not None:
                    _need(t, name, dt, (L, C) if per_slot else (L,), dev)
            ptrs = [0 if t is None else t.data_ptr() for t in leaves[2:]]
            got = (leaves, torch.tensor(ptrs or [0], dtype=torch.int64).to(dev))
            self._state[(dev, stream)] = got
        elif leaves[0].shape[0] != L:
            raise ValueError(f"state has {leaves[0].shape[0]} lanes, the "
                             f"batch {L}")
        return leaves[0], leaves[1], got[1]

    def _check_batch(self, cols, tag, ts, ts_base, nvalid):
        nfa = self.nfa
        dev = tag.device
        L, B = tag.shape
        if L < 1 or B != nfa.B:
            raise ValueError(f"batch must be [L >= 1, {nfa.B}], got {tuple(tag.shape)}")
        _need(tag, "tag", torch.int8, (L, B), dev)
        _need(ts, "ts", torch.int32, (L, B), dev)
        _need(ts_base, "ts_base", torch.int64, (L,), dev)
        _need(nvalid, "nvalid", torch.int32, (L,), dev)
        for k, ty in zip(self.col_keys, self.col_ty):
            if k not in cols:
                raise ValueError(f"missing event column '{k}'")
            _need(cols[k], f"cols[{k!r}]", DTYPE_OF[ty], (L, B), dev)

    def launch(self, lib, state, cols, tag, ts, ts_base, nvalid, stream):
        """One launch of the step kernel of ``lib`` on ``stream`` (checks
        the batch and the state first); ``state`` is updated in place.
        Returns (state, ys)."""
        self._check_batch(cols, tag, ts, ts_base, nvalid)
        nfa = self.nfa
        dev = tag.device
        L, B = tag.shape
        matches, drops, tptr = self._state_on(state, L, dev, stream)
        tmpl = self._args.get((dev, L, stream))
        if tmpl is None:
            cl, mode, per_lane = self.layout(lib)
            desc, code = self._on(dev)
            tmpl = BlockArgs()
            tmpl.L, tmpl.mode, tmpl.cluster = L, mode, cl
            tmpl.desc, tmpl.code = desc.data_ptr(), code.data_ptr()
            if per_lane:         # kept alive by the plan with the template
                scratch = torch.empty(L * per_lane, dtype=torch.uint8,
                                      device=dev)
                tmpl.scratch = scratch.data_ptr()
                tmpl._scratch = scratch
            self._args[(dev, L, stream)] = tmpl
        a = BlockArgs.from_buffer_copy(tmpl)
        a.tptr = tptr.data_ptr()
        for c, k in enumerate(self.col_keys):
            a.col[c] = cols[k].data_ptr()
        a.tag, a.ts = tag.data_ptr(), ts.data_ptr()
        a.ts_base, a.nvalid = ts_base.data_ptr(), nvalid.data_ptr()
        a.matches, a.drops = matches.data_ptr(), drops.data_ptr()
        P = B if nfa.S == 1 else nfa.C + self.pc[nfa.S - 1]
        ys = {"mask": torch.empty((L, P), dtype=torch.bool, device=dev),
              "j": torch.empty((L, P), dtype=torch.int32, device=dev),
              "ts": torch.empty((L, P), dtype=torch.int64, device=dev)}
        a.y_mask, a.y_j = ys["mask"].data_ptr(), ys["j"].data_ptr()
        a.y_ts = ys["ts"].data_ptr()
        for dt, outs in self._out_groups:     # one allocation per dtype
            block = torch.empty((len(outs), L, P), dtype=dt, device=dev)
            for (o, name), t in zip(outs, block.unbind(0)):
                ys[name] = t
                a.out_ptr[o] = t.data_ptr()
        rc = lib.nfa_block_step(ctypes.addressof(a), self.desc_host, stream)
        if rc != 0:
            why = ("needs more shared memory than a block has" if rc == -2
                   else f"CUDA error {rc}")
            raise RuntimeError(f"nfa_block launch failed: {why}")
        return state, ys

    def step_cuda(self, state, cols, tag, ts, ts_base, nvalid):
        """Launches the step kernel once (the seed gate and every stage, one
        cluster of CTAs per lane) on the current stream. ``state`` is
        updated in place and returned with the ys."""
        if tag.device.type != "cuda":
            raise ValueError("step_cuda takes CUDA tensors")
        if self.link_error is not None:
            raise self.link_error
        lib = self._lib()
        stream = torch.cuda.current_stream(tag.device).cuda_stream
        out = self.launch(lib, state, cols, tag, ts, ts_base, nvalid, stream)
        BlockPlan.launches += 1
        return out


def _need(t, name, dtype, shape, dev):
    if not isinstance(t, torch.Tensor) or t.device != dev:
        raise ValueError(f"{name} must be a tensor on {dev}")
    if t.dtype != dtype or t.shape != shape:
        raise ValueError(f"{name} must be {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def make_block_step(nfa: "DeviceNFACompiler"):
    """Returns ``step(state, cols, tag, ts, ts_base, nvalid) -> (state, ys)``
    over ``[L, ...]`` tensors in the wire format (int32 ts deltas + int64
    base per lane, prefix validity ``nvalid`` per lane).

    ys: ``{"mask": [L, P] bool, "j": [L, P] i32 (match event index),
    "ts": [L, P] i64, <out-name>: [L, P]}`` with ``P = C + creations
    entering the last stage`` (``B`` when S == 1).

    CPU tensors take the plain version; CUDA tensors launch the kernel (the
    state is updated in place) or raise."""
    plan = nfa.plan

    def step(state, cols, tag, ts, ts_base, nvalid):
        kind = tag.device.type
        if kind == "cuda":
            return plan.step_cuda(state, cols, tag, ts, ts_base, nvalid)
        if kind == "cpu":
            return block_step_plain(nfa, state, cols, tag, ts, ts_base, nvalid)
        raise ValueError(f"no nfa_block step for device type {kind!r}")

    step.plan = plan
    return step


def decode_block_outputs(nfa: "DeviceNFACompiler", ys) -> list[list]:
    """One lane's ys → host rows, ordered by match event (j), then
    candidate rank."""
    ys = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in ys.items()}
    mask = ys["mask"]
    if not mask.any():
        return []
    idx = np.nonzero(mask)[0]
    j = ys["j"][idx]
    order = np.argsort(j, kind="stable")
    idx = idx[order]
    from .nfa import _decode_scalar
    rows = []
    for p in idx:
        rows.append([_decode_scalar(nfa, name, ys[name][p], t)
                     for (name, _, t) in nfa.out_specs])
    return rows
