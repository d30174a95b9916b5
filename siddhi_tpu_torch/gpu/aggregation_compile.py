"""Device incremental aggregation on the card: the sec…year rollup cascade
as batched segmented reductions.

Port of the reference's ``tpu/aggregation_compile.py``. One step takes a
staged micro-batch and a host-computed ``[D, B]`` slab of bucket starts (one
row per duration; months and years are calendar-irregular, so the host does
the bucket math, ``bucket_slab``) and returns, per duration, one partial row
per (bucket, group key) run: the accepted events sorted by (bucket, last
group column, …, first group column, arrival), split where the bucket or
any raw group column changes, and reduced per run. ``AggregationRuntime``
(``core/aggregation.py``) merges the partial rows into its bucket stores
(``iter_partials``, ``merge_partial_into_state``).

Lanes per duration, each ``[D, B]`` (``n_runs`` is ``[D]``): ``bucket``,
``count`` (int64), ``sum_<n>`` (int64 for INT/LONG sum/avg, f64 otherwise;
``count()`` sums f64 ones), ``sq_<n>`` (f64, stdDev), ``m_<n>`` (min/max in
the argument's dtype, the reduce identity where a run has none), ``last_<n>``
(a value projection at the run's last accepted event) and ``g_<col>`` (the
group column at the run's leader). Positions past ``n_runs`` hold what the
reference's hold: the rejected events' runs (bucket ``2**62``, count 0,
zero sums, the min/max identity), then empty segments (leader clipped to
B - 1, last to 0). Float sums add in sorted order from 0.0, as the
reference's ``segment_sum`` does, so every lane is bitwise the reference's.

``aggregation_step_plain`` is the step in plain torch; it runs on any device
and is what the CPU runs. On the card the step is
``csrc/aggregation_step.cu`` through ``aggregation_step.AggPlan``
(``CompiledAggregation.plan``). ``device`` follows
``backend.resolve_device``: the card unless the caller asks for the CPU.

Aggregator coverage: sum / count / avg / min / max / stdDev (mergeable
partials). distinctCount and set-valued aggregators are not losslessly
mergeable from device lanes and raise ``DeviceCompileError``: the runtime
keeps them on the host interpreter. Device columns encode None as 0
(``BatchSchema.encode_value``), so missing numerics aggregate as 0 where the
host skips them, as in the reference.
"""

from __future__ import annotations

import bisect
from typing import Callable

import numpy as np
import torch

from ..query_api import AttributeFunction, Filter, Variable
from ..query_api.definition import DataType, StreamDefinition
from .backend import reduce_identity, resolve_device
from .batch import BatchSchema
from .expr_compile import (ColumnResolver, DeviceCompileError, as_tensor,
                           compile_expression)

_TS_POS = 2 ** 62
_DEVICE_AGGS = {"sum", "count", "avg", "min", "max", "stdDev"}
_I64 = torch.iinfo(torch.int64)


class CompiledAggregation:
    """Compiles an ``AggregationDefinition`` to a per-batch partial reducer.
    The caller (``AggregationRuntime``) stages rows, computes the ``[D, B]``
    bucket-start slab host-side, and merges the returned partial rows into
    its bucket stores with :func:`merge_partial_into_state`.

    Refuses (``DeviceCompileError``, the reference's messages) input
    handlers other than filters, computed group keys, keys that are not
    string/int/long, non-numeric or missing aggregate arguments and
    non-mergeable aggregators; and (``aggregation_step.AggPlan``) what
    exceeds the kernel's limits, on every device."""

    def __init__(self, definition, input_def: StreamDefinition,
                 batch_capacity: int = 1024, device=None):
        self.definition = definition
        self.input_def = input_def
        self.B = batch_capacity
        self.schema = BatchSchema(input_def)
        resolver = ColumnResolver(self.schema)

        stream = definition.basic_single_input_stream
        self.filter_fns: list[Callable] = []
        self.filter_irs: list[list] = []
        for h in stream.handlers:
            if isinstance(h, Filter):
                fn, _, ir = compile_expression(h.expr, resolver)
                self.filter_fns.append(fn)
                self.filter_irs.append(ir)
            else:
                raise DeviceCompileError(
                    "aggregation input handlers beyond filters take the "
                    "host path")

        # group-by columns: raw per-event values gathered at run leaders so
        # the host reconstructs exact key tuples (no hashed buckets to invert)
        self.group_cols: list[tuple[str, DataType]] = []
        for gb in definition.selector.group_by:
            if not isinstance(gb, Variable):
                raise DeviceCompileError(
                    "computed group-by keys take the host path")
            key, kt = resolver.resolve(gb)
            if kt not in (DataType.STRING, DataType.INT, DataType.LONG):
                raise DeviceCompileError(
                    "aggregation group key must be string/int on device")
            self.group_cols.append((key, kt))

        # attr specs mirror AggregationRuntime's: (name, kind, fn, agg_name);
        # spec_irs[i] is spec i's program as postfix IR (None for count())
        self.specs: list[dict] = []
        self.spec_irs: list = []
        for oa in definition.selector.attributes:
            e = oa.expr
            if isinstance(e, AttributeFunction) and e.namespace is None \
                    and e.name in _DEVICE_AGGS:
                arg_fn, arg_t, arg_ir = (None, DataType.LONG, None)
                if e.args:
                    arg_fn, arg_t, arg_ir = compile_expression(e.args[0],
                                                               resolver)
                    if arg_t not in (DataType.INT, DataType.LONG,
                                     DataType.FLOAT, DataType.DOUBLE):
                        raise DeviceCompileError(
                            f"{e.name}() over non-numeric arguments needs "
                            f"the host path")
                elif e.name != "count":
                    raise DeviceCompileError(f"{e.name}() needs an argument")
                self.specs.append({"name": oa.name, "kind": e.name,
                                   "fn": arg_fn, "arg_t": arg_t})
                self.spec_irs.append(arg_ir)
            elif isinstance(e, AttributeFunction) and e.namespace is None:
                raise DeviceCompileError(
                    f"aggregator '{e.name}' has no mergeable device lanes")
            else:
                fn, t, ir = compile_expression(e, resolver)
                src = e.attribute if isinstance(e, Variable) \
                    and t == DataType.STRING else None
                self.specs.append({"name": oa.name, "kind": "value",
                                   "fn": fn, "dtype": t, "src": src})
                self.spec_irs.append(ir)

        self.D = len(definition.durations)
        from .aggregation_step import AggPlan
        self.plan = AggPlan(self)          # kernel limits refuse here
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ step
    def tensors(self, cols: dict, ts, buckets, valid, device=None):
        """Host staging → ``(cols, ts, buckets, valid)`` tensors on
        ``device`` (default: the aggregation's): the columns the step reads,
        int64 ts ``[B]``, int64 buckets ``[D, B]``, bool valid ``[B]``."""
        dev = self.device if device is None else torch.device(device)

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        return ({k: t(cols[k]) for k in self.plan.col_names}, t(ts),
                t(buckets), t(valid))

    def step(self, cols: dict, ts, buckets, valid) -> dict:
        """Runs one step where the aggregation's tensors lie and returns the
        partial tables as host numpy: the kernel on the card (one
        device-to-host copy of the one buffer every lane lies in), the plain
        version on the CPU."""
        args = self.tensors(cols, ts, buckets, valid)
        kind = args[1].device.type
        if kind == "cuda":
            _, buf = self.plan.step_cuda(*args)
            return self.plan.unpack(buf.cpu().numpy())
        if kind == "cpu":
            return {k: v.numpy() for k, v in
                    aggregation_step_plain(self, *args).items()}
        raise ValueError(f"no aggregation step for device type {kind!r}")

    # ------------------------------------------------- host-side bucket math
    def bucket_slab(self, ts: np.ndarray) -> np.ndarray:
        """[D, B] bucket starts for the definition's durations (vectorized
        host calendar math; mirrors ``aggregation.bucket_start`` exactly)."""
        from ..core.aggregation import _MS
        from ..query_api.definition import TimePeriodDuration as TPD

        rows = []
        for d in self.definition.durations:
            if d in _MS:
                ms = _MS[d]
                rows.append(ts - ts % ms)
            else:
                unit = "M" if d == TPD.MONTHS else "Y"
                dt = ts.astype("datetime64[ms]").astype(f"datetime64[{unit}]")
                rows.append(dt.astype("datetime64[ms]").astype(np.int64))
        return np.stack(rows)

    def iter_partials(self, fetched: dict):
        """Yields (duration_index, bucket_ts, key_tuple, partial_row dicts)
        from a fetched step output, in sorted-bucket order: the reference's
        rows and Python types. Each lane's first ``n_runs`` values come to
        Python in one ``tolist`` (the reference converts them one by one)."""
        for di in range(self.D):
            n = int(fetched["n_runs"][di])

            def lane(key, src=None):
                if key not in fetched:
                    return [None] * n
                vals = fetched[key][di][:n].tolist()
                if src is None:
                    return vals
                decode = self.schema.dictionaries[src].decode
                return [decode(v) for v in vals]

            keys = [None] * n
            if self.group_cols:
                keys = list(zip(*[
                    lane(f"g_{name}", name if t == DataType.STRING else None)
                    for name, t in self.group_cols]))
            counts = lane("count")
            cols = []
            for s in self.specs:
                nm = s["name"]
                if s["kind"] == "value":
                    cols.append((nm, lane(f"last_{nm}", s.get("src")), None))
                else:
                    # int64 sum lanes stay integral (exact merge)
                    cols.append((nm, None, list(zip(
                        counts, lane(f"sum_{nm}"), lane(f"sq_{nm}"),
                        lane(f"m_{nm}")))))
            for r, (bucket, key) in enumerate(zip(lane("bucket"), keys)):
                row = {}
                for nm, value, part in cols:
                    if part is None:
                        row[nm] = value[r]
                    else:
                        p = part[r]
                        row[nm] = {"n": p[0], "sum": p[1], "sq": p[2],
                                   "m": p[3]}
                yield di, bucket, key, row


def lane_kind(spec: dict) -> str:
    """How a spec's lane accumulates: ``value`` (a projection), ``int``
    (int64 sum), ``f64`` (f64 sum; count() sums ones), ``f64sq`` (f64 sum
    and sum of squares, stdDev), ``min`` or ``max``."""
    kind = spec["kind"]
    if kind in ("value", "min", "max"):
        return kind
    if kind in ("sum", "avg") and spec["arg_t"] in (DataType.INT, DataType.LONG):
        return "int"
    return "f64sq" if kind == "stdDev" else "f64"


def aggregation_step_plain(ca: CompiledAggregation, cols: dict,
                           ts: torch.Tensor, buckets: torch.Tensor,
                           valid: torch.Tensor) -> dict:
    """The reference's ``reduce_batch`` in plain torch, on any device:
    ``cols {name: [B]}``, ``ts`` int64 [B] (the bucketing clock),
    ``buckets`` int64 [D, B], ``valid`` bool [B] → the partial tables.

    The stable lexsort is successive stable sorts from the least significant
    key (the first group column) to the most (the bucket); float sums walk
    every run position by position from 0.0 (the reference's order: the
    same bits; ``index_add_`` on the card adds in no fixed order)."""
    dev = ts.device
    B, D = ca.B, ca.D
    i64, f64 = torch.int64, torch.float64
    env = dict(cols)
    env["__ts__"] = ts
    env["__device__"] = dev
    mask = valid
    for fn in ca.filter_fns:
        mask = torch.logical_and(mask, as_tensor(fn(env), env))
    gkeys = [env[name].to(i64) for name, _t in ca.group_cols]

    pos = torch.arange(B, device=dev)
    segm = torch.where(mask[None, :], buckets, torch.tensor(_TS_POS, device=dev))
    order = pos.expand(D, B)
    for k in [*gkeys, None]:
        kk = segm.gather(1, order) if k is None else k[order]
        order = order.gather(1, torch.sort(kk, dim=1, stable=True).indices)
    sseg = segm.gather(1, order)
    first = torch.ones((D, B), dtype=torch.bool, device=dev)
    first[:, 1:] = sseg[:, 1:] != sseg[:, :-1]
    for gk in gkeys:
        sg = gk[order]
        first[:, 1:] |= sg[:, 1:] != sg[:, :-1]
    rid = torch.cumsum(first.to(i64), 1) - 1
    accepted = sseg < _TS_POS
    posd = pos.expand(D, B)
    leader = torch.full((D, B), _I64.max, dtype=i64, device=dev).scatter_reduce(
        1, rid, posd, "amin")
    last = torch.full((D, B), _I64.min, dtype=i64, device=dev).scatter_reduce(
        1, rid, torch.where(accepted, posd, -1), "amax")
    leader_c = leader.clamp(0, B - 1)
    last_c = last.clamp(0, B - 1)
    seg_len = torch.zeros((D, B), dtype=i64, device=dev).scatter_add_(
        1, rid, torch.ones_like(rid))

    out = {"bucket": sseg.gather(1, leader_c),
           "n_runs": (first & accepted).sum(1)}
    out["count"] = torch.zeros((D, B), dtype=i64, device=dev).scatter_add_(
        1, rid, accepted.to(i64))

    f64_lanes: dict[str, torch.Tensor] = {}     # out key → sorted values
    for s in ca.specs:
        nm, lk = s["name"], lane_kind(s)
        if lk == "value":
            out[f"last_{nm}"] = s["fn"](env)[order].gather(1, last_c)
            continue
        if lk in ("min", "max"):
            raw = s["fn"](env)
            ident = reduce_identity(raw.dtype, lk == "min")
            mv = torch.where(mask, raw, torch.tensor(ident, dtype=raw.dtype,
                                                     device=dev))[order]
            m = torch.full((D, B), ident, dtype=raw.dtype, device=dev)
            m = m.scatter_reduce(1, rid, mv, "amin" if lk == "min" else "amax")
            if raw.dtype.is_floating_point:    # NaN wins, in any order
                nan = torch.zeros((D, B), dtype=i64, device=dev).scatter_add_(
                    1, rid, torch.isnan(mv).to(i64))
                m = torch.where(nan > 0, torch.tensor(float("nan"), dtype=m.dtype,
                                                      device=dev), m)
            out[f"m_{nm}"] = m
            continue
        if lk == "int":
            av = torch.where(mask, s["fn"](env).to(i64), 0)[order]
            out[f"sum_{nm}"] = torch.zeros((D, B), dtype=i64,
                                           device=dev).scatter_add_(1, rid, av)
            continue
        if s["kind"] == "count":
            v = torch.ones(B, dtype=f64, device=dev)
        else:
            v = s["fn"](env).to(f64)
        av = torch.where(mask, v, 0.0)[order]
        f64_lanes[f"sum_{nm}"] = av
        if lk == "f64sq":
            f64_lanes[f"sq_{nm}"] = av * av
    if f64_lanes:
        out.update(_walk_sums(f64_lanes, leader_c, seg_len))
    for name, _t in ca.group_cols:
        out[f"g_{name}"] = env[name][order].gather(1, leader_c)
    return out


def _walk_sums(lanes: dict, start: torch.Tensor, seg_len: torch.Tensor) -> dict:
    """Per-run f64 sums of sorted ``[D, B]`` lanes, left to right from 0.0:
    step k adds every run's k-th value (runs are contiguous from
    ``start``), one step per position of the longest run."""
    keys = list(lanes)
    vals = torch.stack([lanes[k] for k in keys])          # [L, D, B]
    L, D, B = vals.shape
    acc = torch.zeros_like(vals)
    for k in range(int(seg_len.max()) if seg_len.numel() else 0):
        p = (start + k).clamp(max=B - 1).expand(L, D, B)
        acc = torch.where(k < seg_len, acc + vals.gather(2, p), acc)
    return dict(zip(keys, acc.unbind(0)))


def merge_partial_into_state(state: dict, specs: list[dict],
                             row: dict) -> None:
    """Merges one device partial row into a host bucket state
    (``{"aggs": {name: Aggregator}, "values": {...}}``). Buckets never
    retract (purge drops whole buckets), so extremes merge as single-value
    inserts and moment aggregators merge additively."""
    for s in specs:
        nm = s["name"]
        if s["kind"] == "value":
            state["values"][nm] = row[nm]
            continue
        agg = state["aggs"][nm]
        p = row[nm]
        kind = s["kind"]
        if kind in ("sum", "avg"):
            total = p["sum"]
            if kind == "sum" and getattr(agg, "is_int", False):
                total = int(round(total))
            agg.total += total
            agg.count += p["n"]
        elif kind == "count":
            agg.count += p["n"]
        elif kind in ("min", "max"):
            if p["n"] > 0:
                bisect.insort(agg.values, p["m"])
        elif kind == "stdDev":
            agg.n += p["n"]
            agg.sum += p["sum"]
            agg.sumsq += p["sq"]
