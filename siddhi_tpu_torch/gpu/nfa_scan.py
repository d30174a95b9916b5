"""Per-event scan NFA step: count, logical and absent states, lane-batched.

Port of the per-event step of the reference's ``tpu/nfa.py``
(``DeviceNFACompiler._make_step`` → ``step_event`` under ``lax.scan``, and
the lane ``vmap`` of ``tpu/partition.py``). Every shape the blocked kernel
does not take runs here: ``<m:n>`` count states, logical ``and``/``or``,
absent ``not X for t``, sequences, group and mid-pattern ``every``. Each
event updates every state's C-slot table in the reference's order:

  within-expiry reclaims → zero-min count pre-seed → ``seeds0`` → expiry
  pre-pass over clocked states (ascending) → states S-1 … 0 (absent
  kill/restart, logical states with count-prev eligibility and logical
  seeding, count extension, stream advance from pending[s] and from an
  eligible count prev, seeding at state 0) → end-of-event clears (scope
  clones become visible; sequence strictness kills untouched partials).

Two forms of the step live here:

- ``scan_step_plain``: the torch translation of ``step_event`` over
  ``[L, C]`` tables with an explicit loop over the B events of the batch.
  It runs on any device; the CPU tests hold it against the JAX package and
  ``chip_smoke.py`` holds the kernel against it.
- ``ScanPlan.step_cuda``: the wrapper of the hand-written kernel
  ``csrc/nfa_scan.cu`` (one launch per step, one CTA per lane, the event
  loop inside the kernel, tables updated in place).

``make_scan_step`` dispatches on where the tensors lie: CPU tensors run the
plain version, CUDA tensors launch the kernel or raise.

State: ``{"pending": {"p{s}": {leaf: [L, C]}}, "seeds": [L], "drops": [L],
"matches": [L]}`` — the reference's tree with a lane dim in front. ys:
``{"mask": [L, B, 2, C], "ts": [L, B], <out>: [L, B, 2, C],
"null__<out>": [L, B, 2, C]}``; row 0 of the ``2`` axis holds emissions from
a state's own table, row 1 those from an eligible count predecessor.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import numpy as np
import torch

from .dtypes import TORCH
from .expr_compile import (
    DTYPE_OF,
    OP,
    TY_OF,
    DeviceCompileError,
    T_BOOL,
    T_I64,
    as_tensor,
    astype,
    clause_form,
)

if TYPE_CHECKING:
    from .nfa import DeviceNFACompiler

i32, i64 = torch.int32, torch.int64


def _clocked(st) -> bool:
    """State whose slots carry a non-occurrence clock."""
    return st.kind == "absent" or (
        st.kind == "logical" and st.waiting_ms is not None)


def scan_init_state(nfa: "DeviceNFACompiler", lanes: int = 1,
                    start_ts: int = 0) -> dict:
    """``[lanes, C]`` slot tables for every state + per-lane counters, on
    ``nfa.device``. ``-1`` marks an unset ``first_ts``/``arrive_ts``."""
    C, dev = nfa.C, nfa.device

    def zeros(dt):
        return torch.zeros((lanes, C), dtype=dt, device=dev)

    def unset():
        return torch.full((lanes, C), -1, dtype=i64, device=dev)

    pend = {}
    for s, st in enumerate(nfa.states):
        fields = {"valid": zeros(torch.bool), "first_ts": unset()}
        if st.kind == "count":
            fields["count"] = zeros(i32)
            fields["closed"] = zeros(torch.bool)
        if st.kind == "logical" and st.logical_type == "and":
            for bi in range(len(st.branches)):
                fields[f"done{bi}"] = zeros(torch.bool)
        if st.kind == "logical" and st.logical_type == "or":
            # `X or not Y [for t]`: Y's arrival kills only the absent
            # alternative, not the partial
            for bi, br in enumerate(st.branches):
                if br.is_absent:
                    fields[f"absdead{bi}"] = zeros(torch.bool)
        if _clocked(st):
            fields["arrive_ts"] = unset()
        if s in nfa.reseed_targets:
            # clones placed by a scope-end advance, invisible until the
            # next event (host `_created` skip)
            fields["fresh"] = zeros(torch.bool)
        for (q, key, t) in sorted(nfa.referenced):
            if q < s or (q == s and st.kind in ("count", "logical")):
                fields[key] = zeros(TORCH[t])
        if s == 0 and nfa.preseeded:
            # the host places ONE partial at start(); its non-occurrence
            # clock starts at the runtime start time
            fields["valid"][:, 0] = True
            if "arrive_ts" in fields:
                fields["arrive_ts"][:, 0] = start_ts
        pend[f"p{s}"] = fields
    return {
        "pending": pend,
        "seeds": torch.full((lanes,), 0 if nfa.preseeded else 1, dtype=i64,
                            device=dev),
        "drops": torch.zeros(lanes, dtype=i64, device=dev),
        "matches": torch.zeros(lanes, dtype=i64, device=dev),
    }


def _key_col(nfa, key: str) -> str:
    """Merged event column a bound key is minted from."""
    from .nfa import _NFAResolver
    return _NFAResolver(nfa, None)._bound_to_merged(key)


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def scan_step_plain(nfa: "DeviceNFACompiler", state, cols, tag, ts, ts_base,
                    nvalid):
    """The reference's scan step over ``[L, ...]`` tensors; returns
    ``(state, ys)`` with new tensors (the input state is not modified)."""
    C, S = nfa.C, nfa.S
    L, B = tag.shape
    dev = tag.device
    states = nfa.states
    within = nfa.within
    is_seq = nfa.is_sequence
    always_seed = states[0].ends_every
    every_end = nfa.every_end
    out_specs = nfa.out_specs
    out_null_deps = nfa.out_null_deps
    referenced = sorted(nfa.referenced)
    n_out = len(out_specs)
    alias_col = {}
    for st in states:
        for br in st.branches:
            alias_col[br.alias] = nfa.compiled.alias_defs[br.alias].id

    def Z(dt=torch.bool):
        return torch.zeros((L, C), dtype=dt, device=dev)

    def BC(x):
        return torch.broadcast_to(x, (L, C))

    def col0(m):
        """``zeros(C).at[0].set(m)`` per lane (m is [L, 1])."""
        out = Z()
        out[:, :1] = m
        return out

    def cnt(m):
        return m.sum(1, keepdim=True, dtype=i64)

    def pred_of(br, env):
        if br.predicate is None:
            return torch.ones((L, C), dtype=torch.bool, device=dev)
        return BC(astype(as_tensor(br.predicate(env), env), torch.bool))

    def pred0_of(br, env):
        """A predicate over the event alone ([L, 1])."""
        if br.predicate is None:
            return torch.ones((L, 1), dtype=torch.bool, device=dev)
        return torch.broadcast_to(
            astype(as_tensor(br.predicate(env), env), torch.bool), (L, 1))

    def bound_keys_for(level: int):
        st = states[level]
        return [key for (q, key, t) in referenced
                if q < level or (q == level and st.kind == "count")]

    arange_c = torch.arange(C, dtype=i64, device=dev).expand(L, C)

    def insert(slots: dict, ins_mask, values: dict, ts_new, counts_new=None):
        """Scatter candidates (ins_mask over [L, C]) into free slots by
        rank, drop-newest. Returns (new_slots, n_dropped [L, 1],
        inserted mask over the target slots)."""
        free = ~slots["valid"]
        free_rank = torch.cumsum(free.to(i32), 1, dtype=i32) - 1
        ins_rank = torch.cumsum(ins_mask.to(i32), 1, dtype=i32) - 1
        n_free = cnt(free)
        n_ins = cnt(ins_mask)
        slot_of_rank = torch.zeros((L, C + 1), dtype=i64, device=dev)
        slot_of_rank.scatter_(1, torch.where(free, free_rank.to(i64),
                                             torch.full_like(arange_c, C)),
                              arange_c)
        ok = ins_mask & (ins_rank.to(i64) < n_free)
        tgt = torch.where(
            ok, slot_of_rank.gather(1, ins_rank.clamp(0, C - 1).to(i64)),
            torch.full_like(arange_c, C))

        def put(field, vals, fill):
            ext = torch.cat([field, field[:, :1]], 1)
            src = torch.where(ok, BC(vals).to(field.dtype),
                              torch.full_like(field, fill))
            return ext.scatter(1, tgt, src)[:, :C]

        new = dict(slots)
        new["valid"] = put(slots["valid"], torch.ones_like(ok), False)
        new["first_ts"] = put(slots["first_ts"], ts_new, -1)
        if "count" in slots:
            cnew = counts_new if counts_new is not None else \
                torch.ones((L, C), dtype=i32, device=dev)
            new["count"] = put(slots["count"], cnew, 0)
            new["closed"] = put(slots["closed"], Z(), False)
        # every field is written for inserted slots: either the provided
        # value or a reset — a freed slot must not leak stale bound values
        # or done flags into the partial that reuses it
        for key in slots:
            if key in ("valid", "first_ts", "count", "closed"):
                continue
            reset = -1 if key == "arrive_ts" else 0
            arr = values.get(key)
            if arr is None:
                arr = torch.full_like(slots[key], reset)
            new[key] = put(slots[key], arr, reset)
        dropped = torch.clamp(n_ins - n_free, min=0)
        inserted = put(Z(), ok, False)
        return new, dropped, inserted

    pend = {k: dict(v) for k, v in state["pending"].items()}
    seeds = state["seeds"][:, None]
    drops = state["drops"][:, None]
    n_match = state["matches"][:, None]
    ts64 = ts_base[:, None].to(i64) + ts.to(i64)
    valid_all = torch.arange(B, dtype=i32, device=dev)[None, :] < nvalid[:, None]
    ys_mask, ys_cols, ys_nulls = [], [[] for _ in out_specs], \
        [[] for _ in out_specs]

    for b in range(B):
        ev_cols = {k: v[:, b:b + 1] for k, v in cols.items()}
        ev_ts = ts64[:, b:b + 1]
        ev_tag = tag[:, b:b + 1]
        ev_ok = valid_all[:, b:b + 1]
        ev_env = {f"ev_{k}": v for k, v in ev_cols.items()}
        ev_env["__device__"] = dev

        def ev_col(alias, attr, t):
            mk = nfa.merged.col_key(alias_col[alias], attr)
            return BC(ev_cols[mk].to(TORCH[t]))

        # within-expiry reclaims slots
        if within is not None:
            for s in range(S):
                slots = dict(pend[f"p{s}"])
                has_first = slots["first_ts"] >= 0
                alive = ~(has_first & (ev_ts - slots["first_ts"] > within))
                if not always_seed and every_end is not None \
                        and s <= every_end:
                    # an expired in-scope instance re-initializes the
                    # `every` scope start: its seed returns, usable by THIS
                    # event
                    seeds = seeds + cnt(slots["valid"] & ~alive)
                slots["valid"] = slots["valid"] & alive
                pend[f"p{s}"] = slots

        # zero-min count scope start: a pre-seeded EMPTY partial (count=0,
        # no first-bind time) whenever a seed is available and no instance
        # is open
        if states[0].kind == "count" and states[0].min_count == 0:
            p0 = pend["p0"]
            has_open = (p0["valid"] & ~p0["closed"]).any(1, keepdim=True)
            want = ev_ok & ~has_open
            if not always_seed:
                want = want & (seeds > 0)
            new0, dropped0, replenish_ins = insert(
                p0, col0(want), {}, torch.full((L, C), -1, dtype=i64,
                                               device=dev), Z(i32))
            pend["p0"] = new0
            drops = drops + dropped0
            if not always_seed:
                seeds = seeds - want.to(i64)
        else:
            replenish_ins = None

        # seeds available to THIS event (replenishments from this event's
        # completions become usable on the next one; expiry returns above
        # are visible)
        seeds0 = seeds

        out_mask = torch.zeros((L, 2, C), dtype=torch.bool, device=dev)
        out_cols = [torch.zeros((L, 2, C), dtype=TORCH[t], device=dev)
                    for (_, _, t) in out_specs]
        out_nulls = [torch.zeros((L, 2, C), dtype=torch.bool, device=dev)
                     if out_null_deps[oi] else None for oi in range(n_out)]
        touched = {s: Z() for s in range(S)}
        if replenish_ins is not None:
            # a partial placed this event is exempt from sequence strict
            # kill until the NEXT event (host `_created` set)
            touched[0] = touched[0] | replenish_ins

        def emit_rows(n_match, mask, row, emit_env):
            """Accumulate matched slots into output row `row`."""
            out_mask[:, row] = out_mask[:, row] | mask
            emit_env = dict(emit_env, __device__=dev)
            for oi, (_, fn, t) in enumerate(out_specs):
                val = BC(astype(as_tensor(fn(emit_env), emit_env),
                                out_cols[oi].dtype))
                out_cols[oi][:, row] = torch.where(mask, val,
                                                   out_cols[oi][:, row])
                if out_null_deps[oi]:
                    nm = Z()
                    for (q, flag) in sorted(out_null_deps[oi]):
                        got = emit_env.get(flag)
                        if got is None:      # flag not carried → unbound
                            nm = torch.ones_like(nm)
                        else:
                            nm = nm | ~BC(got)
                    out_nulls[oi][:, row] = torch.where(
                        mask, nm, out_nulls[oi][:, row])
            return n_match + cnt(mask)

        # ---- expiry pre-pass (absent + logical-`for` states), ascending:
        # host timers fire before the event is delivered
        for s in [i for i, stx in enumerate(states) if _clocked(stx)]:
            st = states[s]
            slots = pend[f"p{s}"]
            estab = slots["valid"] & ev_ok & (slots["arrive_ts"] >= 0) & \
                (ev_ts >= slots["arrive_ts"] + st.waiting_ms)
            adv = estab
            if st.kind == "logical" and st.logical_type == "and":
                # AND: advance only partials whose present side bound
                for bi, br in enumerate(st.branches):
                    if not br.is_absent:
                        adv = adv & slots[f"done{bi}"]
            elif st.kind == "logical":
                # OR: established non-occurrence completes the state unless
                # the forbidden event spoiled the wait
                for bi, br in enumerate(st.branches):
                    if br.is_absent:
                        adv = adv & ~slots[f"absdead{bi}"]
            ns = dict(slots)
            if s == 0 and always_seed:
                # re-arm the start seed: clock jumps to the established
                # boundary, binding state resets
                ns["arrive_ts"] = torch.where(
                    adv, slots["arrive_ts"] + st.waiting_ms,
                    slots["arrive_ts"])
                ns["first_ts"] = torch.where(adv, torch.full_like(
                    slots["first_ts"], -1), slots["first_ts"])
                for key in list(ns):
                    if key.startswith(("done", "absdead", "b0")):
                        ns[key] = torch.where(adv, torch.zeros_like(ns[key]),
                                              ns[key])
            else:
                ns["valid"] = ns["valid"] & ~adv
            pend[f"p{s}"] = ns
            touched[s] = touched[s] | adv
            n_adv = cnt(adv)
            if s == S - 1:
                emit_env = dict(ev_env)
                for (q, key, t) in referenced:
                    if key in slots:
                        emit_env[key] = slots[key]
                n_match = emit_rows(n_match, adv, 0, emit_env)
            else:
                values = {key: slots[key] for (q, key, t) in referenced
                          if key in slots and q <= s}
                if _clocked(states[s + 1]):
                    # the successor's clock starts at THIS state's
                    # established expiry time
                    values["arrive_ts"] = slots["arrive_ts"] + st.waiting_ms
                new_tgt, dropped, inserted = insert(
                    pend[f"p{s + 1}"], adv, values,
                    torch.where(slots["first_ts"] >= 0, slots["first_ts"],
                                BC(ev_ts)), Z(i32))
                pend[f"p{s + 1}"] = new_tgt
                touched[s + 1] = touched[s + 1] | inserted
                drops = drops + dropped
            if every_end == s:
                seeds = seeds + n_adv

        def env_for(level: int):
            env = dict(ev_env)
            env.update({key: pend[f"p{level}"][key]
                        for key in bound_keys_for(level)
                        if key in pend[f"p{level}"]})
            return env

        def side_bind(st, s, values, bi, mask, into=None):
            """Masked bind of branch bi's event columns into values."""
            br = st.branches[bi]
            for (q, key, t) in referenced:
                if q == s and key.startswith(f"b{s}x{bi}_"):
                    base = into[key] if into is not None else Z(TORCH[t])
                    if key == f"b{s}x{bi}__set":
                        values[key] = mask | base
                        continue
                    attr = key[len(f"b{s}x{bi}_"):]
                    values[key] = torch.where(mask, ev_col(br.alias, attr, t),
                                              base)

        def rearm0(ns, advance):
            """Reseed a pre-placed start slot in place."""
            if "arrive_ts" in ns:
                ns["arrive_ts"] = torch.where(advance, BC(ev_ts),
                                              ns["arrive_ts"])
            ns["first_ts"] = torch.where(
                advance, torch.full_like(ns["first_ts"], -1), ns["first_ts"])
            for key in list(ns):
                if key.startswith(("done", "absdead", "b0")):
                    ns[key] = torch.where(advance, torch.zeros_like(ns[key]),
                                          ns[key])

        def logical_state(s, st, seeds, drops, n_match):
            pres = [bi for bi, br in enumerate(st.branches)
                    if not br.is_absent]
            absent_bis = [bi for bi, br in enumerate(st.branches)
                          if br.is_absent]
            slots = pend[f"p{s}"]
            env = env_for(s)
            bm = []
            for br in st.branches:
                g = ev_ok & (ev_tag == br.stream_idx)
                bm.append(slots["valid"] & g & pred_of(br, env))
            if absent_bis:
                ymatch = Z()
                for bi in absent_bis:
                    ymatch = ymatch | bm[bi]
                ns = dict(slots)
                if s == 0 and st.waiting_ms is not None:
                    # start-state `X and/or not Y for t`: the forbidden
                    # event RESTARTS the wait; bindings are kept
                    ns["arrive_ts"] = torch.where(ymatch, BC(ev_ts),
                                                  slots["arrive_ts"])
                elif st.logical_type == "or":
                    # `X or not Y [for t]`: Y kills only the absent
                    # alternative
                    for bi in absent_bis:
                        ns[f"absdead{bi}"] = ns[f"absdead{bi}"] | bm[bi]
                else:
                    # `X and not Y`: Y's arrival kills the partial
                    ns["valid"] = ns["valid"] & ~ymatch
                pend[f"p{s}"] = ns
                touched[s] = touched[s] | ymatch
                bm = [m & ~ymatch for m in bm]
                slots = pend[f"p{s}"]

            if st.logical_type == "and" and not absent_bis:
                # both sides must arrive (any order); ONE event may satisfy
                # both
                m0, m1 = bm[0], bm[1]
                ns = dict(slots)
                for bi, ap in ((0, m0), (1, m1)):
                    ns[f"done{bi}"] = ns[f"done{bi}"] | ap
                    side_bind(st, s, ns, bi, ap, into=ns)
                complete = ns["valid"] & ns["done0"] & ns["done1"]
                ns["valid"] = ns["valid"] & ~complete
                touched[s] = touched[s] | m0 | m1
                pend[f"p{s}"] = ns
                advance, adv_src = complete, ns
                values = {key: ns[key] for (q, key, t) in referenced
                          if key in ns and q <= s}
            elif st.logical_type == "and" and st.waiting_ms is not None:
                # `X and not Y for t`: X binds and waits for the established
                # non-occurrence — unless already established
                bi0 = pres[0]
                m0 = bm[bi0]
                estab_now = slots["valid"] & (slots["arrive_ts"] >= 0) & \
                    (ev_ts >= slots["arrive_ts"] + st.waiting_ms)
                advance = m0 & estab_now
                ns = dict(slots)
                ns[f"done{bi0}"] = ns[f"done{bi0}"] | m0
                side_bind(st, s, ns, bi0, m0, into=ns)
                touched[s] = touched[s] | m0
                adv_src = dict(ns)          # post-bind, pre-reset
                values = {key: adv_src[key] for (q, key, t) in referenced
                          if key in adv_src and q <= s}
                if s == 0 and always_seed:
                    rearm0(ns, advance)
                else:
                    ns["valid"] = ns["valid"] & ~advance
                pend[f"p{s}"] = ns
            else:
                # OR — or `X and not Y` (present match advances)
                m0 = bm[pres[0]]
                m1 = (bm[pres[1]] & ~m0) if len(pres) > 1 else Z()
                advance = m0 | m1
                touched[s] = touched[s] | advance
                ns = dict(slots)
                if s == 0 and always_seed and absent_bis:
                    rearm0(ns, advance)
                else:
                    ns["valid"] = ns["valid"] & ~advance
                pend[f"p{s}"] = ns
                adv_src = slots
                values = {key: slots[key] for (q, key, t) in referenced
                          if key in slots and q < s}
                side_bind(st, s, values, pres[0], m0)
                if len(pres) > 1:
                    side_bind(st, s, values, pres[1], m1)

            first_ts_new = torch.where(adv_src["first_ts"] >= 0,
                                       adv_src["first_ts"], BC(ev_ts))
            n_adv = cnt(advance)
            if s == S - 1:
                emit_env = dict(ev_env)
                for (q, key, t) in referenced:
                    if key in values:
                        emit_env[key] = values[key]
                    elif key in adv_src:
                        emit_env[key] = adv_src[key]
                n_match = emit_rows(n_match, advance, 0, emit_env)
            else:
                if _clocked(states[s + 1]):
                    values["arrive_ts"] = BC(ev_ts)
                new_tgt, dropped, inserted = insert(
                    pend[f"p{s + 1}"], advance, values, first_ts_new, Z(i32))
                pend[f"p{s + 1}"] = new_tgt
                touched[s + 1] = touched[s + 1] | inserted
                drops = drops + dropped
            if every_end == s:
                seeds = seeds + n_adv

            # ---- eligible candidates from a min-reached PREV count
            # (immediate-advance shapes only — gated at compile time)
            if s > 0 and states[s - 1].kind == "count" and \
                    st.waiting_ms is None:
                prev = pend[f"p{s - 1}"]
                env_p = env_for(s - 1)
                elig = prev["valid"] & (
                    prev["count"] >= states[s - 1].min_count)
                bmp = []
                for br in st.branches:
                    g = ev_ok & (ev_tag == br.stream_idx)
                    bmp.append(elig & g & pred_of(br, env_p))
                if absent_bis:
                    # `X and not Y`: Y kills the shared partial
                    killp = Z()
                    for bi in absent_bis:
                        killp = killp | bmp[bi]
                    np1 = dict(prev)
                    np1["valid"] = np1["valid"] & ~killp
                    pend[f"p{s - 1}"] = np1
                    touched[s - 1] = touched[s - 1] | killp
                    bmp = [m & ~killp for m in bmp]
                    prev = np1
                m0p = bmp[pres[0]]
                m1p = (bmp[pres[1]] & ~m0p) if len(pres) > 1 else Z()
                advp = m0p | m1p
                touched[s - 1] = touched[s - 1] | advp
                np2 = dict(pend[f"p{s - 1}"])
                np2["valid"] = np2["valid"] & ~advp
                pend[f"p{s - 1}"] = np2
                valuesp = {key: prev[key] for (q, key, t) in referenced
                           if key in prev and q < s}
                side_bind(st, s, valuesp, pres[0], m0p)
                if len(pres) > 1:
                    side_bind(st, s, valuesp, pres[1], m1p)
                first_p = torch.where(prev["first_ts"] >= 0,
                                      prev["first_ts"], BC(ev_ts))
                if s == S - 1:
                    emit_env = dict(ev_env)
                    for (q, key, t) in referenced:
                        if key in valuesp:
                            emit_env[key] = valuesp[key]
                        elif key in prev:
                            emit_env[key] = prev[key]
                    n_match = emit_rows(n_match, advp, 1, emit_env)
                else:
                    if _clocked(states[s + 1]):
                        valuesp["arrive_ts"] = BC(ev_ts)
                    new_tgt, dropped, inserted = insert(
                        pend[f"p{s + 1}"], advp, valuesp, first_p, Z(i32))
                    pend[f"p{s + 1}"] = new_tgt
                    touched[s + 1] = touched[s + 1] | inserted
                    drops = drops + dropped

            # ---- seeding at a logical state 0 (absent-bearing logicals are
            # PRE-seeded at init and re-armed in place instead)
            if s == 0 and not absent_bis:
                # AND seeds linger half-bound, so `every` must NOT seed on
                # each event — gate on the seed counter; OR consumes its seed
                # immediately, so always_seed is safe
                is_and0 = st.logical_type == "and"
                seeds_ok = torch.ones_like(ev_ok) \
                    if (always_seed and not is_and0) else seeds0 > 0
                cans = {}
                taken = torch.zeros_like(ev_ok)
                for bi in pres:
                    br = st.branches[bi]
                    g0 = ev_ok & (ev_tag == br.stream_idx)
                    p0 = pred0_of(br, ev_env)
                    if st.logical_type == "and":
                        c = g0 & p0         # one event may bind BOTH sides
                    else:
                        c = g0 & p0 & ~taken    # OR: first side wins
                    taken = taken | c
                    cans[bi] = c & seeds_ok
                can_any = taken & seeds_ok
                if st.logical_type == "and":
                    seed_vals = {}
                    for bi in pres:
                        seed_vals[f"done{bi}"] = BC(cans[bi])
                        side_bind(st, s, seed_vals, bi, BC(cans[bi]))
                    # one event satisfying BOTH sides completes the state on
                    # the spot
                    seed_done = can_any
                    for bi in pres:
                        seed_done = seed_done & cans[bi]
                    ins_pend = can_any & ~seed_done
                    if S == 1:
                        emit_env = dict(ev_env)
                        for (q, key, t) in referenced:
                            if q == 0:
                                emit_env[key] = seed_vals.get(key, Z(TORCH[t]))
                        n_match = emit_rows(n_match, col0(seed_done), 0,
                                            emit_env)
                    else:
                        cvals = {key: seed_vals[key] for key in seed_vals
                                 if not key.startswith("done")}
                        if _clocked(states[1]):
                            cvals["arrive_ts"] = BC(ev_ts)
                        newc, droppedc, insertedc = insert(
                            pend["p1"], col0(seed_done), cvals, BC(ev_ts),
                            Z(i32))
                        pend["p1"] = newc
                        touched[1] = touched[1] | insertedc
                        drops = drops + droppedc
                    new0, dropped, inserted = insert(
                        pend["p0"], col0(ins_pend), seed_vals, BC(ev_ts))
                    pend["p0"] = new0
                    touched[0] = touched[0] | inserted
                    drops = drops + dropped
                    if every_end == 0:
                        # same-event scope completion replenishes `every`
                        seeds = seeds + seed_done.to(i64)
                else:    # OR seed completes the state immediately
                    seed_vals = {key: Z(TORCH[t])
                                 for (q, key, t) in referenced if q == 0}
                    for bi in pres:
                        side_bind(st, s, seed_vals, bi, BC(cans[bi]),
                                  into=seed_vals)
                    if S == 1:
                        emit_env = dict(ev_env)
                        for (q, key, t) in referenced:
                            if q == 0:
                                emit_env[key] = seed_vals[key]
                        n_match = emit_rows(n_match, col0(can_any), 0,
                                            emit_env)
                    else:
                        if _clocked(states[1]):
                            seed_vals["arrive_ts"] = BC(ev_ts)
                        new1, dropped, inserted = insert(
                            pend["p1"], col0(can_any), seed_vals, BC(ev_ts),
                            Z(i32))
                        pend["p1"] = new1
                        touched[1] = touched[1] | inserted
                        drops = drops + dropped
                if not always_seed or is_and0:
                    seeds = seeds - can_any.to(i64)
            return seeds, drops, n_match

        # openness of a state-0 count BEFORE this event's extensions, fires
        # and advances: a slot this event consumes frees its scope seed on
        # the NEXT event only
        count0_open_pre = None
        if states[0].kind == "count":
            p0pre = pend["p0"]
            count0_open_pre = (p0pre["valid"] & ~p0pre["closed"]).any(
                1, keepdim=True)

        for s in range(S - 1, -1, -1):
            st = states[s]
            if st.kind == "absent":
                # expiry ran in the pre-pass; the forbidden event kills
                # still-waiting partials — except on a START state, where
                # it RESTARTS the wait
                br = st.branches[0]
                g = ev_ok & (ev_tag == br.stream_idx)
                cur = pend[f"p{s}"]
                kill = cur["valid"] & g & pred_of(br, env_for(s))
                ns = dict(cur)
                if s == 0:
                    ns["arrive_ts"] = torch.where(kill, BC(ev_ts),
                                                  cur["arrive_ts"])
                else:
                    ns["valid"] = ns["valid"] & ~kill
                pend[f"p{s}"] = ns
                touched[s] = touched[s] | kill
                continue
            if st.kind == "logical":
                seeds, drops, n_match = logical_state(s, st, seeds, drops,
                                                      n_match)
                continue
            gate = ev_ok & (ev_tag == st.stream_idx)
            # ---- candidate source A: pending[s]
            slots = pend[f"p{s}"]
            pred = pred_of(st.branches[0], env_for(s))
            if st.kind == "count":
                ext = slots["valid"] & ~slots["closed"] & pred & gate
                first_ext = ext & (slots["count"] == 0)
                new_slots = dict(slots)
                new_slots["count"] = slots["count"] + ext.to(i32)
                # a pre-seeded empty partial has no first-bind time until its
                # first occurrence
                new_slots["first_ts"] = torch.where(
                    first_ext & (slots["first_ts"] < 0), BC(ev_ts),
                    slots["first_ts"])
                # bound values: last on every extension, first only on the
                # 0→1 transition, e[k] at occurrence k
                for (q, key, t) in referenced:
                    if q != s:
                        continue
                    if key.startswith(f"b{s}#last#"):
                        v = ev_col(st.alias, key[len(f"b{s}#last#"):], t)
                        new_slots[key] = torch.where(ext, v, slots[key])
                    elif key.startswith(f"b{s}#first#"):
                        v = ev_col(st.alias, key[len(f"b{s}#first#"):], t)
                        new_slots[key] = torch.where(first_ext, v, slots[key])
                    elif key.startswith(f"b{s}#occ"):
                        rest = key[len(f"b{s}#occ"):]
                        if rest.endswith("flag") and "#" not in rest:
                            hit = ext & (slots["count"] == int(rest[:-4]))
                            new_slots[key] = slots[key] | hit
                        else:
                            kstr, attr = rest.split("#", 1)
                            hit = ext & (slots["count"] == int(kstr))
                            new_slots[key] = torch.where(
                                hit, ev_col(st.alias, attr, t), slots[key])
                    elif key == f"b{s}#has":
                        new_slots[key] = slots[key] | ext
                if st.max_count != -1:
                    new_slots["closed"] = new_slots["closed"] | (
                        new_slots["count"] >= st.max_count)
                if s == S - 1:
                    # final count: emit ONCE at min-reach and consume
                    fire = ext & (new_slots["count"] >= st.min_count)
                    emit_env = dict(ev_env)
                    for (q, key, t) in referenced:
                        if key in new_slots:
                            emit_env[key] = new_slots[key]
                    n_match = emit_rows(n_match, fire, 0, emit_env)
                    new_slots["valid"] = new_slots["valid"] & ~fire
                    if every_end == s:
                        seeds = seeds + cnt(fire)
                pend[f"p{s}"] = new_slots
                touched[s] = touched[s] | ext
            else:
                # stream state: sources = pending[s] and (if prev is count)
                # its eligible slots; freshly re-placed scope clones are
                # invisible this event
                cand = slots["valid"] & pred & gate
                if "fresh" in slots:
                    cand = cand & ~slots["fresh"]
                sources = [(s, cand)]
                if s > 0 and states[s - 1].kind == "count":
                    prev = pend[f"p{s - 1}"]
                    pred_p = pred_of(st.branches[0], env_for(s - 1))
                    elig = prev["valid"] & (
                        prev["count"] >= states[s - 1].min_count)
                    sources.append((s - 1, elig & pred_p & gate))

                for src_i, (lvl, matched) in enumerate(sources):
                    src = pend[f"p{lvl}"]
                    touched[lvl] = touched[lvl] | matched
                    # advanced values: all bound cols + the new binding
                    values = {}
                    for (q, key, t) in referenced:
                        if key in src and q < s:
                            values[key] = src[key]
                    for (q, key, t) in referenced:
                        if q == s:
                            values[key] = ev_col(st.alias,
                                                 key[len(f"b{s}_"):], t)
                    first_ts_new = torch.where(
                        src["first_ts"] >= 0, src["first_ts"], BC(ev_ts))
                    # a zero-min FINAL count target completes at ARRIVAL
                    tgt_final_min0 = (
                        s + 1 == S - 1 and states[S - 1].kind == "count"
                        and states[S - 1].min_count == 0)
                    if s == S - 1 or tgt_final_min0:
                        emit_env = dict(ev_env)
                        for (q, key, t) in referenced:
                            if key in src:
                                emit_env[key] = src[key]
                            elif q == s:
                                emit_env[key] = values[key]
                            elif q == S - 1:   # unreached count: NULL
                                emit_env[key] = Z(TORCH[t])
                        n_match = emit_rows(n_match, matched, src_i,
                                            emit_env)
                        n_adv = cnt(matched)
                        if tgt_final_min0 and every_end == S - 1:
                            seeds = seeds + n_adv
                    else:
                        # a count target starts with 0 occurrences; an
                        # absent target's non-occurrence clock starts now
                        if _clocked(states[s + 1]):
                            values["arrive_ts"] = BC(ev_ts)
                        new_tgt, dropped, inserted = insert(
                            pend[f"p{s + 1}"], matched, values, first_ts_new,
                            Z(i32))
                        pend[f"p{s + 1}"] = new_tgt
                        touched[s + 1] = touched[s + 1] | inserted
                        drops = drops + dropped
                        n_adv = cnt(matched)
                    # kill advanced source slots
                    src_new = dict(pend[f"p{lvl}"])
                    src_new["valid"] = src_new["valid"] & ~matched
                    pend[f"p{lvl}"] = src_new
                    # mid-pattern every: the scope-end advance re-places a
                    # clone at the scope start (pre-scope bindings kept,
                    # fresh until the next event)
                    r = states[lvl].reseed_to
                    if r not in (None, 0):
                        cvals = {key: src[key] for (q, key, t) in referenced
                                 if key in src and q < r}
                        cvals["fresh"] = torch.ones((L, C), dtype=torch.bool,
                                                    device=dev)
                        ts_clone = src["first_ts"] if any(
                            states[q].kind != "absent" for q in range(r)) \
                            else torch.full((L, C), -1, dtype=i64, device=dev)
                        newr, droppedr, _ = insert(
                            pend[f"p{r}"], matched, cvals, ts_clone, Z(i32))
                        pend[f"p{r}"] = newr
                        drops = drops + droppedr
                    # every-scope completion replenishes seeds
                    if every_end == lvl:
                        seeds = seeds + n_adv

            # ---- seeding at state 0 (zero-min count states are seeded by
            # the empty-partial pre-pass instead)
            if s == 0 and not (st.kind == "count" and st.min_count == 0):
                can_seed = gate & pred0_of(st.branches[0], ev_env)
                if not always_seed:
                    can_seed = can_seed & (seeds0 > 0)
                if st.kind == "count":
                    # a count scope re-seeds only when its active instance
                    # closed or advanced, not per event
                    can_seed = can_seed & ~count0_open_pre
                seed_vals = {}
                for (q, key, t) in referenced:
                    if q != 0:
                        continue
                    if key == "b0#has":
                        # count state 0 seeds with its first occurrence
                        # already bound
                        seed_vals[key] = torch.ones((L, C), dtype=torch.bool,
                                                    device=dev)
                        continue
                    if key.startswith("b0#occ"):
                        # seed binds occurrence 0 only
                        rest = key[len("b0#occ"):]
                        if rest.endswith("flag") and "#" not in rest:
                            seed_vals[key] = torch.full(
                                (L, C), rest[:-4] == "0", dtype=torch.bool,
                                device=dev)
                            continue
                        kstr, attr = rest.split("#", 1)
                        if kstr != "0":
                            seed_vals[key] = Z(TORCH[t])
                            continue
                    elif key.startswith(("b0#first#", "b0#last#")):
                        attr = key.split("#", 2)[2]
                    else:
                        attr = key[len("b0_"):]
                    seed_vals[key] = ev_col(st.alias, attr, t)
                ins_mask = col0(can_seed)
                if st.kind == "count":
                    if S == 1 and st.min_count <= 1:
                        # single count state with min ≤ 1: the seed's first
                        # occurrence already reaches min — emit and consume
                        emit_env = dict(ev_env)
                        for (q, key, t) in referenced:
                            if q == 0:
                                emit_env[key] = seed_vals.get(key, Z(TORCH[t]))
                        n_match = emit_rows(n_match, ins_mask, 0, emit_env)
                    else:
                        new0, dropped, inserted = insert(
                            pend["p0"], ins_mask, seed_vals, BC(ev_ts),
                            torch.ones((L, C), dtype=i32, device=dev))
                        pend["p0"] = new0
                        touched[0] = touched[0] | inserted
                        drops = drops + dropped
                else:
                    seed_final_min0 = (
                        S == 2 and states[1].kind == "count"
                        and states[1].min_count == 0)
                    if S == 1 or seed_final_min0:
                        # single-state pattern — or a seed arriving at a
                        # zero-min FINAL count: immediate match
                        emit_env = dict(ev_env)
                        for (q, key, t) in referenced:
                            if q == 0:
                                emit_env[key] = seed_vals[key]
                            elif q == 1:        # unreached count: NULL
                                emit_env[key] = Z(TORCH[t])
                        n_match = emit_rows(n_match, ins_mask, 0, emit_env)
                        if seed_final_min0 and every_end == S - 1:
                            seeds = seeds + can_seed.to(i64)
                    else:
                        if _clocked(states[1]):
                            seed_vals["arrive_ts"] = BC(ev_ts)
                        new1, dropped, inserted = insert(
                            pend["p1"], ins_mask, seed_vals, BC(ev_ts),
                            Z(i32))
                        pend["p1"] = new1
                        touched[1] = touched[1] | inserted
                        drops = drops + dropped
                if not always_seed:
                    seeds = seeds - can_seed.to(i64)

        # scope clones become visible from the next event on
        for r in nfa.reseed_targets:
            slots_r = dict(pend[f"p{r}"])
            slots_r["fresh"] = Z()
            pend[f"p{r}"] = slots_r

        # sequence strictness: untouched partials die on any event
        if is_seq:
            for s in range(S):
                slots = dict(pend[f"p{s}"])
                slots["valid"] = slots["valid"] & torch.where(
                    ev_ok, touched[s], slots["valid"])
                pend[f"p{s}"] = slots

        ys_mask.append(out_mask)
        for oi in range(n_out):
            ys_cols[oi].append(out_cols[oi])
            if out_nulls[oi] is not None:
                ys_nulls[oi].append(out_nulls[oi])

    new_state = {"pending": pend, "seeds": seeds[:, 0], "drops": drops[:, 0],
                 "matches": n_match[:, 0]}
    ys = {"mask": torch.stack(ys_mask, 1), "ts": ts64}
    for oi, (name, _, t) in enumerate(out_specs):
        ys[name] = torch.stack(ys_cols[oi], 1)
        if out_null_deps[oi]:
            ys[f"null__{name}"] = torch.stack(ys_nulls[oi], 1)
    return new_state, ys


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def decode_scan_outputs(nfa: "DeviceNFACompiler", ys) -> list[list]:
    """ys (one lane's ``[B, 2, C]`` or all lanes' ``[L, B, 2, C]``) → host
    rows in ``(lane, b, src, c)`` order, as the reference's ``argwhere``.
    Hits are found where the tensors lie; only their values are copied to
    the host. ``null__<out>`` masks decode to ``None``."""
    from .nfa import _decode_scalar
    mask = ys["mask"]
    if not isinstance(mask, torch.Tensor):
        ys = {k: torch.as_tensor(np.asarray(v)) for k, v in ys.items()}
        mask = ys["mask"]
    idx = torch.nonzero(mask, as_tuple=True)
    if idx[0].numel() == 0:
        return []
    vals, nulls = [], []
    for (name, _, t) in nfa.out_specs:
        vals.append(ys[name][idx].cpu().numpy())
        nm = ys.get(f"null__{name}")
        nulls.append(None if nm is None else nm[idx].cpu().numpy())
    rows = []
    for i in range(len(vals[0]) if vals else int(idx[0].numel())):
        row = []
        for oi, (name, _, t) in enumerate(nfa.out_specs):
            if nulls[oi] is not None and nulls[oi][i]:
                row.append(None)
            else:
                row.append(_decode_scalar(nfa, name, vals[oi][i], t))
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# the kernel wrapper
# --------------------------------------------------------------------------

# limits of the kernel's descriptor table (csrc/nfa_scan.cu #defines)
MAXS = 16
MAXK = 64
MAXF = 128
MAXCOL = 32
MAXOUT = 32
MAXNULL = 8
MAXC = 256
MAXSTACK = 32
NMASK = 12
SMEM_LIMIT = 227 * 1024
WARP = 32             # threads per lane (one warp)
EV_CHUNK = 32         # events staged into shared memory at a time

S_KIND = {"stream": 0, "count": 1, "logical": 2, "absent": 3}
L_TYPE = {None: 0, "and": 1, "or": 2}
(F_VALID, F_FIRST, F_COUNT, F_CLOSED, F_ARRIVE, F_FRESH, F_DONE, F_ABSDEAD,
 F_KEY) = range(9)
K_PLAIN, K_SIDE, K_SET, K_FIRST, K_LAST, K_OCC, K_OCCFLAG, K_HAS = range(8)
_ROLE = {"valid": F_VALID, "first_ts": F_FIRST, "count": F_COUNT,
         "closed": F_CLOSED, "arrive_ts": F_ARRIVE, "fresh": F_FRESH}


class _Prog(ctypes.Structure):
    _fields_ = [("off", ctypes.c_int), ("len", ctypes.c_int)]


class StDesc(ctypes.Structure):
    """Mirror of ``struct StDesc`` in ``csrc/nfa_scan.cu``."""
    _fields_ = [
        *[(n, ctypes.c_int) for n in ("kind", "ltype", "nbr", "has_wait")],
        ("waiting", ctypes.c_longlong),
        *[(n, ctypes.c_int) for n in ("min_count", "max_count", "reseed_to",
                                      "clone_first")],
        ("br_stream", ctypes.c_int * 2), ("br_absent", ctypes.c_int * 2),
        *[(n, ctypes.c_int) for n in ("f_valid", "f_first", "f_count",
                                      "f_closed", "f_arrive", "f_fresh")],
        ("f_done", ctypes.c_int * 2), ("f_absdead", ctypes.c_int * 2),
        ("fbase", ctypes.c_int), ("nf", ctypes.c_int),
        ("pred", _Prog * 2), ("pred_prev", _Prog * 2), ("pred_seed", _Prog * 2),
        ("cpred", _Prog * 2), ("cprev", _Prog * 2), ("cseed", _Prog * 2),
        ("evonly", ctypes.c_int), ("pad_", ctypes.c_int),
    ]


class KeyDesc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("q", "kind", "ty", "col", "bi",
                                            "occ")]


class FDesc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("role", "key", "ty", "bi")]


class ScanDesc(ctypes.Structure):
    """Mirror of ``struct ScanDesc`` in ``csrc/nfa_scan.cu``."""
    _fields_ = [
        *[(n, ctypes.c_int) for n in (
            "S", "K", "F", "ncol", "nout", "C", "maxnf", "is_seq",
            "has_within", "always_seed", "every_end", "preseeded")],
        ("within", ctypes.c_longlong),
        ("col_ty", ctypes.c_int * MAXCOL),
        ("out_ty", ctypes.c_int * MAXOUT),
        ("out", _Prog * MAXOUT),
        ("out_nnull", ctypes.c_int * MAXOUT),
        ("out_null", (ctypes.c_int * MAXNULL) * MAXOUT),
        ("st", StDesc * MAXS),
        ("key", KeyDesc * MAXK),
        ("f", FDesc * MAXF),
        ("fld", (ctypes.c_short * MAXK) * MAXS),
    ]


class ScanArgs(ctypes.Structure):
    """Mirror of ``struct ScanArgs`` in ``csrc/nfa_scan.cu``."""
    _fields_ = [
        ("L", ctypes.c_int), ("B", ctypes.c_int),
        ("ncode", ctypes.c_int), ("pad_", ctypes.c_int),
        ("d", ctypes.c_void_p), ("code", ctypes.c_void_p),
        ("col", ctypes.c_void_p * MAXCOL),
        *[(n, ctypes.c_void_p) for n in ("tag", "ts", "ts_base", "nvalid")],
        ("field", ctypes.c_void_p * MAXF),
        *[(n, ctypes.c_void_p) for n in ("seeds", "drops", "matches",
                                         "y_mask", "y_ts")],
        ("y_out", ctypes.c_void_p * MAXOUT),
        ("y_null", ctypes.c_void_p * MAXOUT),
    ]


def smem_bytes(d: ScanDesc, ncode: int) -> int:
    """Shared memory one lane needs (``smem_layout`` in the kernel): the
    descriptor, ``ncode`` linked IR words, the tables, the emission and
    staging space, an insert's ballots, the masks and two staged event
    chunks."""
    def carve(n):
        return (n + 15) & ~15

    def region(size):                       # ev_region
        return carve(EV_CHUNK * size + 8)
    size_of = {T_BOOL: 1, T_I64: 8}
    ev = region(4) + region(1) + sum(region(size_of.get(d.col_ty[c], 4))
                                     for c in range(d.ncol))
    C = d.C
    return (carve(ctypes.sizeof(ScanDesc)) + carve(16 * ncode)
            + carve(8 * d.F * C) + carve(8 * max(d.K, 1) * C)
            + carve(8 * d.maxnf * C) + carve(8 * EV_CHUNK * MAXCOL)
            + carve(4 * 2 * (MAXC // WARP)) + carve(d.S * C)
            + carve(NMASK * C) + carve(MAXK) + carve(2 * ev))


def _key_kind(q: int, key: str):
    """(kind, branch, occurrence) of a bound key."""
    body = key[len(f"b{q}"):]
    if body.startswith("x"):
        bi_str, attr = body[1:].split("_", 1)
        return (K_SET if attr == "_set" else K_SIDE), int(bi_str), 0
    if body == "#has":
        return K_HAS, 0, 0
    if body.startswith("#first#"):
        return K_FIRST, 0, 0
    if body.startswith("#last#"):
        return K_LAST, 0, 0
    if body.startswith("#occ"):
        rest = body[len("#occ"):]
        if rest.endswith("flag") and "#" not in rest:
            return K_OCCFLAG, 0, int(rest[:-4])
        return K_OCC, 0, int(rest.split("#", 1)[0])
    return K_PLAIN, 0, 0


class ScanPlan:
    """The compiled plan's kernel side: the descriptor table, linked
    programs and the launch wrapper. ``launches`` counts kernel launches.

    ``DeviceNFACompiler`` builds it at construction: apps over a descriptor
    limit (states, keys, fields, columns, outputs, slots, stack or shared
    memory) raise ``DeviceCompileError`` there, on every device, so the CPU
    and the card accept the same apps."""

    launches = 0          # class-wide: every launch of the scan kernel

    def __init__(self, nfa: "DeviceNFACompiler"):
        from .expr_compile import ir_result_type
        from .nfa import is_flag_key
        from .nfa_block import link_program
        self.nfa = nfa
        C, S = nfa.C, nfa.S
        states = nfa.states
        proto = scan_init_state_spec(nfa)
        self.keys = [key for (q, key, t) in sorted(nfa.referenced)]
        key_idx = {k: i for i, k in enumerate(self.keys)}
        key_ty = {key: t for (q, key, t) in nfa.referenced}
        key_q = {key: q for (q, key, t) in nfa.referenced}
        self.col_keys = nfa.kernel_columns()
        col_slot = {k: i for i, k in enumerate(self.col_keys)}
        self.col_ty = [TY_OF[TORCH[nfa.column_type(k)]] for k in self.col_keys]
        # fields: table by table, in the state tree's leaf order
        self.tables = []            # per state: {leaf name: global field}
        self.fields = []            # (state, leaf name, torch dtype)
        for s in range(S):
            tbl = {}
            for name, dt in proto[s]:
                tbl[name] = len(self.fields)
                self.fields.append((s, name, dt))
            self.tables.append(tbl)
        limits = [(S, MAXS, "states"), (len(self.keys), MAXK, "bound keys"),
                  (len(self.fields), MAXF, "table fields"),
                  (len(self.col_keys), MAXCOL, "event columns"),
                  (len(nfa.out_specs), MAXOUT, "outputs"),
                  (C, MAXC, "slots")]
        for n, cap, what in limits:
            if n > cap:
                raise DeviceCompileError(
                    f"scan kernel: {n} {what} (limit {cap})")

        d = ScanDesc()
        d.S, d.K, d.F = S, len(self.keys), len(self.fields)
        d.ncol, d.nout, d.C = len(self.col_keys), len(nfa.out_specs), C
        d.maxnf = max(len(t) for t in self.tables)
        d.is_seq = int(nfa.is_sequence)
        d.has_within = int(nfa.within is not None)
        d.within = nfa.within or 0
        d.always_seed = int(states[0].ends_every)
        d.every_end = -1 if nfa.every_end is None else nfa.every_end
        d.preseeded = int(nfa.preseeded)
        for i, ty in enumerate(self.col_ty):
            d.col_ty[i] = ty
        for k, key in enumerate(self.keys):
            q = key_q[key]
            kind, bi, occ = _key_kind(q, key)
            col = -1 if is_flag_key(q, key) else col_slot[_key_col(nfa, key)]
            ty = TY_OF[TORCH[key_ty[key]]]
            if col >= 0 and self.col_ty[col] != ty:
                raise DeviceCompileError(
                    f"bound key {key!r} differs in type from its column")
            d.key[k] = KeyDesc(q, kind, ty, col, bi, occ)
        for f, (s, name, dt) in enumerate(self.fields):
            if name in _ROLE:
                d.f[f] = FDesc(_ROLE[name], -1, TY_OF[dt], 0)
            elif name.startswith("done"):
                d.f[f] = FDesc(F_DONE, -1, TY_OF[dt], int(name[4:]))
            elif name.startswith("absdead"):
                d.f[f] = FDesc(F_ABSDEAD, -1, TY_OF[dt], int(name[7:]))
            else:
                d.f[f] = FDesc(F_KEY, key_idx[name], TY_OF[dt], 0)
        for s in range(S):
            for k in range(MAXK):
                d.fld[s][k] = -1
            for name, f in self.tables[s].items():
                if name in key_idx:
                    d.fld[s][key_idx[name]] = f

        progs = []
        self.link_error = None      # raised at the first step, as the
        # reference raises at its first step (trace time)

        def add(ir, bind_slot):
            if ir is None:
                return (0, 0)
            if ir_result_type(ir) != T_BOOL and bind_slot is not None:
                ir = ir + [(OP["CAST"], T_BOOL, ir_result_type(ir), 0)]
            return add_code(ir, bind_slot or {})

        def add_code(ir, bind_slot):
            if any(op == OP["TS"] for (op, _, _, _) in ir):
                self.link_error = self.link_error or KeyError("__ts__")
                return (0, 0)
            try:
                code = link_program(ir, col_slot, bind_slot)
            except DeviceCompileError as e:
                if "is not bound" not in str(e):
                    raise
                # the reference's env lacks the key: KeyError at its first step
                self.link_error = self.link_error or KeyError(str(e))
                return (0, 0)
            off = sum(len(p) for p in progs)
            progs.append(code)
            return (off, len(code))

        def env_slots(level: int) -> dict:
            """Keys of the reference's env_for(level), as table fields."""
            st = states[level]
            return {key: self.tables[level][key]
                    for (q, key, t) in sorted(nfa.referenced)
                    if (q < level or (q == level and st.kind == "count"))
                    and key in self.tables[level]}

        for s, st in enumerate(states):
            sd = d.st[s]
            sd.kind, sd.ltype = S_KIND[st.kind], L_TYPE[st.logical_type]
            sd.nbr = len(st.branches)
            sd.has_wait = int(st.waiting_ms is not None)
            sd.waiting = st.waiting_ms or 0
            sd.min_count, sd.max_count = st.min_count, st.max_count
            sd.reseed_to = -1 if st.reseed_to is None else st.reseed_to
            sd.clone_first = int(any(states[q].kind != "absent"
                                     for q in range(s)))
            tbl = self.tables[s]
            sd.f_valid, sd.f_first = tbl["valid"], tbl["first_ts"]
            for attr, name in (("f_count", "count"), ("f_closed", "closed"),
                               ("f_arrive", "arrive_ts"), ("f_fresh", "fresh")):
                setattr(sd, attr, tbl.get(name, -1))
            for bi in range(2):
                sd.f_done[bi] = tbl.get(f"done{bi}", -1)
                sd.f_absdead[bi] = tbl.get(f"absdead{bi}", -1)
            sd.fbase, sd.nf = min(tbl.values()), len(tbl)
            prev_count = s > 0 and states[s - 1].kind == "count"
            absent_bis = [bi for bi, br in enumerate(st.branches)
                          if br.is_absent]
            for bi, br in enumerate(st.branches):
                sd.br_stream[bi] = br.stream_idx
                sd.br_absent[bi] = int(br.is_absent)
                sd.pred[bi] = _Prog(*add(br.predicate_ir, env_slots(s)))
                if prev_count and (st.kind == "stream" or (
                        st.kind == "logical" and st.waiting_ms is None)):
                    sd.pred_prev[bi] = _Prog(*add(br.predicate_ir,
                                                  env_slots(s - 1)))
                seeds_here = s == 0 and (
                    st.kind in ("stream", "count") or
                    (st.kind == "logical" and not absent_bis))
                if seeds_here and not br.is_absent and not (
                        st.kind == "count" and st.min_count == 0):
                    sd.pred_seed[bi] = _Prog(*add(br.predicate_ir, {}))
        for o, ((name, _, t), ir) in enumerate(zip(nfa.out_specs, nfa.out_irs)):
            want = TY_OF[TORCH[t]]
            if ir_result_type(ir) != want:
                ir = ir + [(OP["CAST"], want, ir_result_type(ir), 0)]
            d.out[o] = _Prog(*add_code(ir, key_idx))
            d.out_ty[o] = want
            deps = sorted(nfa.out_null_deps[o])
            if len(deps) > MAXNULL:
                raise DeviceCompileError(
                    f"scan kernel: {len(deps)} null flags on one output "
                    f"(limit {MAXNULL})")
            d.out_nnull[o] = len(deps)
            for i, (_, flag) in enumerate(deps):
                d.out_null[o][i] = key_idx[flag]
        linked = np.concatenate(progs) if progs else np.zeros((0, 4), np.int32)
        for s in range(S):
            sd = d.st[s]
            for bit, p in enumerate((*sd.pred, *sd.pred_prev)):
                # a program that reads no table field: once per event
                if not (linked[p.off:p.off + p.len, 0] == OP["BIND"]).any():
                    sd.evonly |= 1 << bit
            for src, dst in ((sd.pred, sd.cpred), (sd.pred_prev, sd.cprev),
                             (sd.pred_seed, sd.cseed)):
                for bi in range(2):
                    words = clause_form(linked[src[bi].off:src[bi].off
                                               + src[bi].len], src[bi].off) \
                        if src[bi].len else None
                    if words is not None:
                        dst[bi] = _Prog(sum(len(c) for c in progs),
                                        len(words) // 2)
                        progs.append(words)
        self.code_host = np.concatenate(progs) if progs else \
            np.zeros((1, 4), np.int32)
        need = smem_bytes(d, len(self.code_host))
        if need > SMEM_LIMIT:
            raise DeviceCompileError(
                f"scan kernel: a lane needs {need} B of shared "
                f"memory (limit {SMEM_LIMIT})")
        self.desc = d
        self._dev = {}           # device → (desc bytes, code) uploaded
        self._checked = False

    # -- kernel side ---------------------------------------------------------
    def _on(self, dev):
        got = self._dev.get(dev)
        if got is None:
            raw = np.frombuffer(bytes(self.desc), dtype=np.uint8).copy()
            got = (torch.from_numpy(raw).to(dev),
                   torch.from_numpy(self.code_host).to(dev))
            self._dev[dev] = got
        return got

    def _lib(self):
        from ._build import load
        lib = load("nfa_scan")
        if not self._checked:
            lib.nfa_scan_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p]
            lib.nfa_scan_step.restype = ctypes.c_int
            lib.nfa_scan_desc_size.restype = ctypes.c_int
            lib.nfa_scan_args_size.restype = ctypes.c_int
            for fn, mirror in ((lib.nfa_scan_desc_size, ScanDesc),
                               (lib.nfa_scan_args_size, ScanArgs)):
                if fn() != ctypes.sizeof(mirror):
                    raise RuntimeError(
                        f"{mirror.__name__} layout differs between "
                        f"nfa_scan.cu ({fn()} B) and the ctypes mirror "
                        f"({ctypes.sizeof(mirror)} B)")
            self._checked = True
        return lib

    def _check(self, state, cols, tag, ts, ts_base, nvalid):
        nfa = self.nfa
        dev = tag.device
        L, B = tag.shape
        if L < 1 or B != nfa.B:
            raise ValueError(f"batch must be [L >= 1, {nfa.B}], got {tuple(tag.shape)}")

        def need(t, name, dtype, shape):
            if not isinstance(t, torch.Tensor) or t.device != dev:
                raise ValueError(f"{name} must be a tensor on {dev}")
            if t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {dtype} {shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

        need(tag, "tag", torch.int8, (L, B))
        need(ts, "ts", torch.int32, (L, B))
        need(ts_base, "ts_base", torch.int64, (L,))
        need(nvalid, "nvalid", torch.int32, (L,))
        for k, ty in zip(self.col_keys, self.col_ty):
            if k not in cols:
                raise ValueError(f"missing event column '{k}'")
            need(cols[k], f"cols[{k!r}]", DTYPE_OF[ty], (L, B))
        for k in ("seeds", "drops", "matches"):
            need(state[k], k, torch.int64, (L,))
        for (s, name, dt) in self.fields:
            need(state["pending"][f"p{s}"][name], f"p{s}.{name}", dt,
                 (L, nfa.C))

    def alloc_ys(self, L: int, dev) -> dict:
        """Zeroed ys for one step (masked-off positions hold zero)."""
        nfa = self.nfa
        shape = (L, nfa.B, 2, nfa.C)
        ys = {"mask": torch.zeros(shape, dtype=torch.bool, device=dev),
              "ts": torch.empty((L, nfa.B), dtype=i64, device=dev)}
        for o, (name, _, t) in enumerate(nfa.out_specs):
            ys[name] = torch.zeros(shape, dtype=TORCH[t], device=dev)
            if nfa.out_null_deps[o]:
                ys[f"null__{name}"] = torch.zeros(shape, dtype=torch.bool,
                                                  device=dev)
        return ys

    def args(self, state, cols, tag, ts, ts_base, nvalid, ys, desc_ptr,
             code_ptr) -> ScanArgs:
        """The kernel's argument block over these tensors."""
        nfa = self.nfa
        a = ScanArgs()
        a.L, a.B = tag.shape
        a.ncode = len(self.code_host)
        a.d, a.code = desc_ptr, code_ptr
        for c, k in enumerate(self.col_keys):
            a.col[c] = cols[k].data_ptr()
        a.tag, a.ts = tag.data_ptr(), ts.data_ptr()
        a.ts_base, a.nvalid = ts_base.data_ptr(), nvalid.data_ptr()
        for f, (s, name, _) in enumerate(self.fields):
            a.field[f] = state["pending"][f"p{s}"][name].data_ptr()
        a.seeds = state["seeds"].data_ptr()
        a.drops = state["drops"].data_ptr()
        a.matches = state["matches"].data_ptr()
        a.y_mask, a.y_ts = ys["mask"].data_ptr(), ys["ts"].data_ptr()
        for o, (name, _, _) in enumerate(nfa.out_specs):
            a.y_out[o] = ys[name].data_ptr()
            if nfa.out_null_deps[o]:
                a.y_null[o] = ys[f"null__{name}"].data_ptr()
        return a

    def step_cuda(self, state, cols, tag, ts, ts_base, nvalid):
        """Launches the scan kernel once (one warp per lane) on the current
        stream. ``state`` is updated in place and returned with the ys."""
        if tag.device.type != "cuda":
            raise ValueError("step_cuda takes CUDA tensors")
        self._check(state, cols, tag, ts, ts_base, nvalid)
        if self.link_error is not None:
            raise self.link_error
        lib = self._lib()
        dev = tag.device
        desc, code = self._on(dev)
        ys = self.alloc_ys(tag.shape[0], dev)
        a = self.args(state, cols, tag, ts, ts_base, nvalid, ys,
                      desc.data_ptr(), code.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nfa_scan_step(ctypes.addressof(a), ctypes.addressof(self.desc),
                               stream)
        if rc != 0:
            why = {-2: "needs more shared memory than a block has",
                   -3: "slot capacity out of range"}.get(rc, f"CUDA error {rc}")
            raise RuntimeError(f"nfa_scan launch failed: {why}")
        ScanPlan.launches += 1
        return state, ys


def scan_init_state_spec(nfa) -> list:
    """Per state, the table's ``(leaf name, dtype)`` in ``scan_init_state``
    order (the kernel's field order)."""
    probe = scan_init_state(nfa, 1)
    return [[(k, v.dtype) for k, v in probe["pending"][f"p{s}"].items()]
            for s in range(nfa.S)]


def make_scan_step(nfa: "DeviceNFACompiler"):
    """Returns ``step(state, cols, tag, ts, ts_base, nvalid) -> (state, ys)``
    over ``[L, ...]`` tensors in the wire format. CPU tensors take the plain
    version; CUDA tensors launch the kernel (the state is updated in place)
    or raise."""
    plan = nfa.plan

    def step(state, cols, tag, ts, ts_base, nvalid):
        kind = tag.device.type
        if kind == "cuda":
            return plan.step_cuda(state, cols, tag, ts, ts_base, nvalid)
        if kind == "cpu":
            return scan_step_plain(nfa, state, cols, tag, ts, ts_base, nvalid)
        raise ValueError(f"no nfa_scan step for device type {kind!r}")

    step.plan = plan
    return step
