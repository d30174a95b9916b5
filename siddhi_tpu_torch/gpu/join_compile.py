"""Compiled stream-stream joins on the card: validation, state, the plain
step, decode and the runtime.

Port of the reference's ``tpu/join_compile.py``. One step processes a merged
micro-batch of the two streams (tag 0 = left, 1 = right; the wire of
``nfa.MergedBatchBuilder``): every valid arrival probes the opposite side's
window, held as a ring of its last ``W`` arrivals (timestamp-sorted), and
the older arrivals of the opposite side in the same batch; an outer join
adds one row with the other side null for a probe that matched nothing.
Rows come out in the reference's emission order: probe order, then window
insertion order (ring oldest → newest, then the batch ascending), then the
unmatched row, capped at ``joined_capacity`` with the overflow counted
(``join_drops``; the newest rows are dropped). Time windows hold an entry
while ``ts + D > probe ts``, length windows by arrival rank; a live
time-window entry pushed out of a full ring is counted (``ring_drops``).

``join_step_plain`` is the reference's step in plain torch, grids and all
(``[B, W]`` probe × ring, ``[B, B]`` probe × older arrivals, ``[B, 1]``
unmatched, a row-major compaction into ``J``); it runs on any device and is
what the CPU runs. On the card the step is ``csrc/join_step.cu`` through
``join_step.JoinPlan`` (``CompiledJoinQuery.plan``), which never builds
those grids. ``device`` follows ``backend.resolve_device``: the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..compiler import parse as _parse
from ..query_api import (
    EventTrigger,
    JoinInputStream,
    JoinType,
    Query,
    Variable,
    Window,
)
from ..query_api.definition import DataType, StreamDefinition
from .backend import resolve_device
from .batch import device_state_restore, device_state_snapshot
from .dtypes import TORCH
from .expr_compile import DeviceCompileError, as_tensor, astype, compile_expression
from .nfa import MergedBatchBuilder, MergedBatchSchema

_TS_NEG = -(2 ** 62)


class _JoinResolver:
    """Maps condition/output Variables to L_/R_ env keys and records which
    sides an expression touches (outer-join null propagation)."""

    def __init__(self, cq: "CompiledJoinQuery"):
        self.cq = cq
        self.sides_touched: set[str] = set()

    def resolve(self, var: Variable) -> tuple[str, DataType]:
        cq = self.cq
        sid = var.stream_id
        if sid == cq.left_ref:
            side = "L"
        elif sid == cq.right_ref:
            side = "R"
        elif sid is None:
            in_l = var.attribute in cq.left_def.attribute_names
            in_r = var.attribute in cq.right_def.attribute_names
            if in_l and in_r:
                raise DeviceCompileError(
                    f"ambiguous attribute '{var.attribute}' (both join sides)")
            if not (in_l or in_r):
                raise DeviceCompileError(f"unknown attribute '{var.attribute}'")
            side = "L" if in_l else "R"
        else:
            raise DeviceCompileError(f"unknown stream reference '{sid}'")
        d = cq.left_def if side == "L" else cq.right_def
        if var.attribute not in d.attribute_names:
            raise DeviceCompileError(
                f"'{var.attribute}' not an attribute of the "
                f"{'left' if side == 'L' else 'right'} side")
        self.sides_touched.add(side)
        self.cq.referenced.add((side, var.attribute))
        return f"{side}_{var.attribute}", d.attribute_type(var.attribute)

    def encode_string(self, key: str, value: str) -> int:
        side, attr = key.split("_", 1)
        sid = self.cq.left_id if side == "L" else self.cq.right_id
        dic = self.cq.merged.dictionaries.get(self.cq.merged.col_key(sid, attr))
        if dic is None:
            raise DeviceCompileError(f"no dictionary for '{key}'")
        return dic.encode(value)


def _window_spec(w: Optional[Window], side: str) -> tuple[str, int]:
    """Returns (kind, param): ('time', ms) or ('length', n)."""
    if w is None:
        raise DeviceCompileError(
            f"{side} side needs a window for the device join path")

    def cparam(idx):
        if len(w.params) <= idx or not hasattr(w.params[idx], "value"):
            raise DeviceCompileError(
                f"window '{w.name}' needs a constant parameter")
        return int(w.params[idx].value)
    if w.namespace is None and w.name == "time":
        return "time", cparam(0)
    if w.namespace is None and w.name == "length":
        return "length", cparam(0)
    raise DeviceCompileError(
        f"window '{w.name}' has no device join kernel (host path)")


@dataclass
class _Out:
    name: str
    fn: Callable            # torch closure over the pair env
    dtype: DataType
    sides: frozenset        # {"L", "R"}: the sides the expression reads
    ir: list                # the same program as postfix IR


class CompiledJoinQuery:
    """Compiles a windowed stream-stream join query to a
    ``(state, cols, tag, ts, ts_base, nvalid) -> (state, out)`` step.

    Refuses (``DeviceCompileError``, the reference's messages): table/window/
    aggregation sides, self-joins, aggregating or group-by selectors,
    ``select *``, non-time/length windows, filters on the join inputs; and
    (``join_step.JoinPlan``) what exceeds the kernel's limits, on every
    device."""

    def __init__(self, query: Query, stream_defs: dict[str, StreamDefinition],
                 batch_capacity: int = 512, ring_capacity: int = 1024,
                 joined_capacity: int = 2048, device=None):
        ist = query.input_stream
        if not isinstance(ist, JoinInputStream):
            raise DeviceCompileError("not a join query")
        self.query = query
        self.B = batch_capacity
        self.W = ring_capacity
        self.J = joined_capacity

        left, right = ist.left, ist.right
        if left.stream_id not in stream_defs or \
                right.stream_id not in stream_defs:
            raise DeviceCompileError(
                "join sides must be streams (tables/windows/aggregations "
                "take the host path)")
        if left.stream_id == right.stream_id:
            raise DeviceCompileError("self-joins take the host path")
        for side in (left, right):
            for h in side.handlers:
                if not isinstance(h, Window):
                    raise DeviceCompileError(
                        "filters/stream functions on join inputs take the "
                        "host path")
        self.left_id, self.right_id = left.stream_id, right.stream_id
        self.left_ref, self.right_ref = left.ref(), right.ref()
        self.left_def = stream_defs[left.stream_id]
        self.right_def = stream_defs[right.stream_id]
        self.lkind, self.lparam = _window_spec(left.window, "left")
        self.rkind, self.rparam = _window_spec(right.window, "right")
        if self.lkind == "length" and self.lparam > ring_capacity:
            raise DeviceCompileError("left length window exceeds ring capacity")
        if self.rkind == "length" and self.rparam > ring_capacity:
            raise DeviceCompileError("right length window exceeds ring capacity")

        self.join_type = ist.join_type
        self.trigger = ist.trigger
        self.within_ms: Optional[int] = None
        if ist.within is not None:
            if not hasattr(ist.within, "value"):
                raise DeviceCompileError("join within must be a constant")
            self.within_ms = int(ist.within.value)

        self.merged = MergedBatchSchema(
            stream_defs, [self.left_id, self.right_id])
        self.referenced: set[tuple[str, str]] = set()   # (side, attr)

        # condition
        self.cond_fn: Optional[Callable] = None
        self.cond_type: Optional[DataType] = None
        self.cond_ir: Optional[list] = None
        if ist.on_condition is not None:
            resolver = _JoinResolver(self)
            self.cond_fn, self.cond_type, self.cond_ir = compile_expression(
                ist.on_condition, resolver)

        # selector: projections only (aggregates/group-by → host)
        sel = query.selector
        if sel.group_by or sel.having is not None:
            raise DeviceCompileError(
                "join with group-by/having takes the host path (retraction "
                "semantics)")
        attrs = sel.attributes
        if sel.select_all or not attrs:
            raise DeviceCompileError("join select * takes the host path")
        self.out_specs: list[_Out] = []
        for oa in attrs:
            resolver = _JoinResolver(self)
            # aggregates raise here too (expr_compile rejects them)
            fn, t, ir = compile_expression(oa.expr, resolver)
            self.out_specs.append(
                _Out(oa.name, fn, t, frozenset(resolver.sides_touched), ir))

        from .join_step import JoinPlan
        self.plan = JoinPlan(self)        # kernel limits refuse here
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ state
    def _ring_keys(self, side: str) -> list[tuple[str, str, DataType]]:
        """(state_key, merged_col_key, dtype) for every referenced attr."""
        d = self.left_def if side == "L" else self.right_def
        sid = self.left_id if side == "L" else self.right_id
        out = []
        for (s, attr) in sorted(self.referenced):
            if s == side:
                out.append((f"{side.lower()}r_{attr}",
                            self.merged.col_key(sid, attr),
                            d.attribute_type(attr)))
        return out

    def init_state(self, device=None) -> dict:
        dev = self.device if device is None else torch.device(device)
        W = self.W
        st = {
            "lr_ts": torch.full((W,), _TS_NEG, dtype=torch.int64, device=dev),
            "rr_ts": torch.full((W,), _TS_NEG, dtype=torch.int64, device=dev),
            "join_drops": torch.zeros((), dtype=torch.int64, device=dev),
            "ring_drops": torch.zeros((), dtype=torch.int64, device=dev),
        }
        for side in ("L", "R"):
            for (skey, _, t) in self._ring_keys(side):
                st[skey] = torch.zeros((W,), dtype=TORCH[t], device=dev)
        return st

    @property
    def col_keys(self) -> list[str]:
        """The merged batch columns the step reads (left side first)."""
        return [mk for side in ("L", "R") for (_, mk, _) in self._ring_keys(side)]

    # -------------------------------------------------------------- execution
    def batch_tensors(self, batch: dict, device=None):
        """``MergedBatchBuilder.emit()`` output → ``(cols, tag, ts, ts_base,
        nvalid)``: the columns the step reads, int8 tags, int32 ts deltas
        and the int64 0-d base on ``device`` (default: the query's), and the
        valid prefix length as an int."""
        dev = self.device if device is None else torch.device(device)

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        cols = {k: t(batch["cols"][k]) for k in self.col_keys}
        return (cols, t(batch["tag"]), t(batch["ts"]),
                torch.tensor(int(batch["ts_base"]), dtype=torch.int64,
                             device=dev), int(batch["count"]))

    def step(self, state, batch: dict):
        """One step where the state lies: the kernel for CUDA tensors, the
        plain version for CPU tensors. Returns ``(new state, out)``; the
        input state is left as it was."""
        dev = state["lr_ts"].device
        return self.step_tensors(state, *self.batch_tensors(batch, dev))

    def step_tensors(self, state, cols, tag, ts, ts_base, nvalid):
        kind = ts.device.type
        if kind == "cuda":
            return self.plan.step_cuda(state, cols, tag, ts, ts_base, nvalid)
        if kind == "cpu":
            return join_step_plain(self, state, cols, tag, ts, ts_base, nvalid)
        raise ValueError(f"no join step for device type {kind!r}")

    def decode_outputs(self, out) -> list[list]:
        """Valid output rows, in order, as Python values: STRING outputs
        through the merged schema's one shared dictionary, outer-join nulls
        as None."""
        idx = np.nonzero(out["valid"].cpu().numpy())[0]
        shared = next(iter(self.merged.dictionaries.values()), None)
        columns = []
        for o in self.out_specs:
            vals = out["out"][o.name].cpu().numpy()[idx].tolist()
            nulls = out["null"][o.name].cpu().numpy()[idx].tolist()
            if o.dtype == DataType.STRING and shared is not None:
                col = [None if n else shared.decode(v)
                       for v, n in zip(vals, nulls)]
            elif any(nulls):
                col = [None if n else v for v, n in zip(vals, nulls)]
            else:
                col = vals
            columns.append(col)
        return [list(r) for r in zip(*columns)]


def _compact_side(vals, mask, B, fill=0):
    """Stable compaction of one side's batch values to the front."""
    out = torch.full((B,), fill, dtype=vals.dtype, device=vals.device)
    rank = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    out[rank[mask].long()] = vals[mask]
    return out


def join_step_plain(cq: CompiledJoinQuery, state: dict, cols: dict,
                    tag: torch.Tensor, ts: torch.Tensor,
                    ts_base: torch.Tensor, nvalid: int):
    """The reference's join step in plain torch, on any device: ``(state,
    cols [B], tag int8 [B], ts int32 deltas [B], ts_base int64 0-d, nvalid)
    -> (new state, out)`` with ``out = {"out": {name: [J]}, "null": {name:
    bool [J]}, "valid": bool [J], "ts": int64 [J], "count": int64}``; rows
    past ``count`` hold probe 0 against ring slot 0, as the reference's
    do. The input state is not modified."""
    B, W, J = cq.B, cq.W, cq.J
    dev = ts.device
    i32, i64 = torch.int32, torch.int64
    lmap = {skey.split("_", 1)[1]: mk for (skey, mk, _) in cq._ring_keys("L")}
    rmap = {skey.split("_", 1)[1]: mk for (skey, mk, _) in cq._ring_keys("R")}
    emit_left = cq.trigger in (EventTrigger.ALL, EventTrigger.LEFT)
    emit_right = cq.trigger in (EventTrigger.ALL, EventTrigger.RIGHT)
    un_left = cq.join_type in (JoinType.LEFT_OUTER_JOIN, JoinType.FULL_OUTER_JOIN)
    un_right = cq.join_type in (JoinType.RIGHT_OUTER_JOIN,
                                JoinType.FULL_OUTER_JOIN)
    lkind, lparam, rkind, rparam = cq.lkind, cq.lparam, cq.rkind, cq.rparam
    within_ms = cq.within_ms
    L = W + B + 1      # per-probe layout: ring | in-batch | unmatched

    def flag(v: bool):
        return torch.tensor(v, device=dev)

    ts = ts_base.to(i64) + ts.to(i64)
    ar = torch.arange(B, device=dev)
    valid = ar < nvalid
    is_l = (tag == 0) & valid
    is_r = (tag == 1) & valid
    probe_ok = valid & torch.where(tag == 0, flag(emit_left), flag(emit_right))
    cl_excl = torch.cumsum(is_l.to(i32), 0, dtype=i32) - is_l.to(i32)
    cr_excl = torch.cumsum(is_r.to(i32), 0, dtype=i32) - is_r.to(i32)

    def cond(env, shape):
        return torch.broadcast_to(as_tensor(cq.cond_fn(env), env), shape)

    # ---------- segment 1: probe × opposite ring  [B, W]
    probe_left = tag == 0
    pl = probe_left[:, None]
    lr_ts, rr_ts = state["lr_ts"], state["rr_ts"]
    tsc = ts[:, None]
    age = (W - 1 - torch.arange(W, device=dev))[None, :]
    if rkind == "time":
        r_alive = (rr_ts > _TS_NEG)[None, :] & (rr_ts[None, :] + rparam > tsc)
    else:   # length: ring slot w holds the (W-w)-th newest; alive iff its
        # age-from-newest + in-batch same-side arrivals < N
        r_alive = (rr_ts > _TS_NEG)[None, :] & (age + cr_excl[:, None] < rparam)
    if lkind == "time":
        l_alive = (lr_ts > _TS_NEG)[None, :] & (lr_ts[None, :] + lparam > tsc)
    else:
        l_alive = (lr_ts > _TS_NEG)[None, :] & (age + cl_excl[:, None] < lparam)
    ring_alive = torch.where(pl, r_alive, l_alive)

    env1 = {"__device__": dev}
    for attr, mk in lmap.items():
        env1[f"L_{attr}"] = torch.where(pl, cols[mk][:, None],
                                        state[f"lr_{attr}"][None, :])
    for attr, mk in rmap.items():
        env1[f"R_{attr}"] = torch.where(pl, state[f"rr_{attr}"][None, :],
                                        cols[mk][:, None])
    env1["__lts__"] = torch.where(pl, tsc, lr_ts[None, :])
    env1["__rts__"] = torch.where(pl, rr_ts[None, :], tsc)
    env1["__ts__"] = tsc.expand(B, W)
    g_ring = probe_ok[:, None] & ring_alive
    if within_ms is not None:
        g_ring &= (env1["__lts__"] - env1["__rts__"]).abs() <= within_ms
    if cq.cond_fn is not None:
        g_ring &= cond(env1, (B, W))

    # ---------- segment 2: probe × older in-batch opposite  [B, B]
    j_older = ar[None, :] < ar[:, None]
    opp = tag[None, :] == (1 - tag[:, None])
    base = probe_ok[:, None] & valid[None, :] & j_older & opp
    # liveness of the older event j in its window at probe time
    if rkind == "time":
        r_in = ts[None, :] + rparam > tsc
    else:
        r_in = (cr_excl[:, None] - (cr_excl + is_r.to(i32))[None, :]) < rparam
    if lkind == "time":
        l_in = ts[None, :] + lparam > tsc
    else:
        l_in = (cl_excl[:, None] - (cl_excl + is_l.to(i32))[None, :]) < lparam
    in_window = torch.where(pl, r_in, l_in)

    env2 = {"__device__": dev}
    for attr, mk in lmap.items():
        env2[f"L_{attr}"] = torch.where(pl, cols[mk][:, None], cols[mk][None, :])
    for attr, mk in rmap.items():
        env2[f"R_{attr}"] = torch.where(pl, cols[mk][None, :], cols[mk][:, None])
    env2["__lts__"] = torch.where(pl, tsc, ts[None, :])
    env2["__rts__"] = torch.where(pl, ts[None, :], tsc)
    env2["__ts__"] = tsc.expand(B, B)
    g_new = base & in_window
    if within_ms is not None:
        g_new &= (env2["__lts__"] - env2["__rts__"]).abs() <= within_ms
    if cq.cond_fn is not None:
        g_new &= cond(env2, (B, B))

    # ---------- segment 3: unmatched probes (outer joins)
    matched = g_ring.any(1) | g_new.any(1)
    unmatched_ok = torch.where(probe_left, flag(un_left), flag(un_right))
    g_un = (probe_ok & ~matched & unmatched_ok)[:, None]

    # ---------- compaction in emission order: the first J selected cells
    flat = torch.cat([g_ring, g_new, g_un], 1).reshape(-1)
    n_sel = flat.sum(dtype=i64)
    picked = torch.nonzero(flat).flatten()[:J]
    sel = torch.zeros(J, dtype=i64, device=dev)
    sel[:picked.numel()] = picked
    out_valid = torch.arange(J, device=dev) < picked.numel()
    p_sel = sel // L
    q_sel = sel % L

    # ---------- gather joined values  [J]
    probeL = tag[p_sel] == 0
    from_ring = q_sel < W
    is_un = q_sel == (W + B)
    rq = q_sel.clamp(0, W - 1)
    bq = (q_sel - W).clamp(0, B - 1)
    env = {"__device__": dev}
    for attr, mk in lmap.items():
        env[f"L_{attr}"] = torch.where(
            probeL, cols[mk][p_sel],
            torch.where(from_ring, state[f"lr_{attr}"][rq], cols[mk][bq]))
    for attr, mk in rmap.items():
        env[f"R_{attr}"] = torch.where(
            probeL, torch.where(from_ring, state[f"rr_{attr}"][rq], cols[mk][bq]),
            cols[mk][p_sel])
    env["__ts__"] = ts[p_sel]

    lnull = is_un & ~probeL     # probe from the right: left side null
    rnull = is_un & probeL
    out_cols, null_cols = {}, {}
    for o in cq.out_specs:
        v = torch.broadcast_to(as_tensor(o.fn(env), env), (J,))
        out_cols[o.name] = astype(v, TORCH[o.dtype]).contiguous()
        nmask = torch.zeros(J, dtype=torch.bool, device=dev)
        if "L" in o.sides:
            nmask |= lnull
        if "R" in o.sides:
            nmask |= rnull
        null_cols[o.name] = nmask

    # ---------- ring update (after probing): append + keep the last W
    def slide(ring, batch_vals, side_mask, k_side, fill=0):
        z = torch.cat([ring, _compact_side(batch_vals, side_mask, B, fill)])
        return z[k_side:k_side + W].clone()

    kl = int(is_l.sum())
    kr = int(is_r.sum())
    new_state = dict(state)
    # overflow accounting: ring entries pushed out while still alive (time
    # windows only: an evicted length-window slot has already expired)
    now = torch.where(valid, ts, torch.full_like(ts, _TS_NEG)).max()
    ring_drops = state["ring_drops"]
    warange = torch.arange(W, device=dev)
    for (ts_key, kind, param, k_side) in (
            ("lr_ts", lkind, lparam, kl), ("rr_ts", rkind, rparam, kr)):
        if kind != "time":
            continue
        old_ts = state[ts_key]
        alive_now = (old_ts > _TS_NEG) & (old_ts + param > now)
        ring_drops = ring_drops + ((warange < k_side) & alive_now).sum(dtype=i64)
    new_state["ring_drops"] = ring_drops
    new_state["lr_ts"] = slide(state["lr_ts"], ts, is_l, kl, fill=_TS_NEG)
    new_state["rr_ts"] = slide(state["rr_ts"], ts, is_r, kr, fill=_TS_NEG)
    for attr, mk in lmap.items():
        new_state[f"lr_{attr}"] = slide(state[f"lr_{attr}"], cols[mk], is_l, kl)
    for attr, mk in rmap.items():
        new_state[f"rr_{attr}"] = slide(state[f"rr_{attr}"], cols[mk], is_r, kr)
    new_state["join_drops"] = state["join_drops"] + torch.clamp(n_sel - J, min=0)

    out = {"out": out_cols, "null": null_cols, "valid": out_valid,
           "ts": env["__ts__"], "count": torch.clamp(n_sel, max=J)}
    return new_state, out


class DeviceJoinRuntime:
    """Micro-batching front end over a compiled join: rows go in with
    ``send``, a full batch (or ``flush``) runs one step, decoded rows go to
    the callback. ``device`` follows ``backend.resolve_device``."""

    def __init__(self, app_or_text, batch_capacity: int = 256,
                 ring_capacity: int = 1024, joined_capacity: int = 2048,
                 query_index: int = 0, device=None):
        app = _parse(app_or_text) if isinstance(app_or_text, str) else app_or_text
        query = app.queries[query_index]
        self.compiler = CompiledJoinQuery(
            query, dict(app.stream_definitions), batch_capacity,
            ring_capacity, joined_capacity, device=device)
        self.device = self.compiler.device
        self.builder = MergedBatchBuilder(
            self.compiler.merged, batch_capacity, dict(app.stream_definitions),
            used_cols=set(self.compiler.col_keys))
        self.state = self.compiler.init_state()
        self.callback: Optional[Callable[[list[list]], None]] = None

    def add_callback(self, fn) -> None:
        self.callback = fn

    def send(self, stream_id: str, row: list, timestamp: int) -> None:
        self.builder.append(stream_id, row, timestamp)
        if self.builder.full:
            self.flush()

    def flush(self, decode: bool = True):
        if len(self.builder) == 0:
            return None
        batch = self.builder.emit()
        self.state, out = self.compiler.step(self.state, batch)
        if decode:
            rows = self.compiler.decode_outputs(out)
            if self.callback is not None and rows:
                self.callback(rows)
            return rows
        return out

    @property
    def drop_count(self) -> int:
        return int(self.state["join_drops"])

    @property
    def ring_drop_count(self) -> int:
        return int(self.state["ring_drops"])

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def snapshot_state(self) -> dict:
        return device_state_snapshot(self.state, self.compiler.merged)

    def restore_state(self, state) -> None:
        from .state_io import join_state_from_numpy
        self.state = device_state_restore(
            state, self.compiler.merged,
            lambda tree: join_state_from_numpy(self.compiler, tree, self.device))
