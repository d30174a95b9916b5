"""Compiled single-stream queries: filter → window → aggregate.

Port of the reference's ``tpu/query_compile.py`` (``CompiledStreamQuery``,
B5 in ``ROADMAP.md``) for every window the reference puts on the device:
no window, ``#window()``, the sliding ``length``, ``time``,
``externalTime`` and ``timeLength``, ``batch()``, the tumbling
``lengthBatch``, ``timeBatch``, ``externalTimeBatch``, ``session`` and
``delay``, ``hopping``, and the scan-walked ``sort``, ``frequent`` and
``lossyFrequent``; with filters, projections, group-by, ``having`` and the
sum/count/avg/min/max/stdDev aggregates, and the reference's refusals and
their messages.

The state tree, its leaf names and dtypes, the wire batch and the outputs
are the reference's, so a state carries between the two packages
(``state_io.query_state_from_numpy``). Two forms of the step:

- ``stream_step_plain``: the torch translation of the reference's jitted
  step. It runs on any device; the CPU tests hold it against the JAX
  package and ``chip_smoke.py`` holds the kernels against it on the card.
- ``query_step.QueryPlan.step_cuda``: the wrapper of the hand-written
  kernels, ``csrc/query_step.cu`` (every window but the scan-walked three)
  and ``csrc/query_walk.cu`` (``sort``, ``frequent``, ``lossyFrequent``).

``CompiledStreamQuery.step`` dispatches on the device: CPU tensors run the
plain version, CUDA tensors launch the kernel or raise.

Output axis: ``[B]`` (one slot per batch event) for no window, the sliding
windows, ``batch()`` and the scan-walked windows; ``[N + B]`` (remainder and
batch) for ``lengthBatch``, ``timeBatch``, ``session`` and ``delay``; ``[B]``
flush slots for ``hopping``.

Numeric policy (``dtypes.py``): integer sums/avgs accumulate exactly in
int64, float aggregates in float32 with Kahan compensation on carried
bases. Float32 prefix sums (and the scan-walked windows' buffer sums) are
accumulated in float64 and rounded to float32 once, so the kernels and the
plain version round the same values whatever their summation order;
against the reference (whose f32 sums round at every addition) they agree
to within a few ulps of the sum of |x| read. Windowed stdDev works in
float64 as the reference does; ``sort``'s stdDev in float32, as there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..query_api import (
    AttributeFunction,
    Constant,
    Filter,
    Minus,
    OutputAttribute,
    Query,
    SingleInputStream,
    Variable,
    Window,
)
from ..query_api.definition import DataType, StreamDefinition
from .backend import avalanche, reduce_identity, resolve_device
from .batch import BatchSchema
from .dtypes import TORCH
from .expr_compile import (
    ColumnResolver,
    DeviceCompileError,
    as_tensor,
    astype,
    compile_expression,
)
from .transfer import to_device, to_host

# event-time sentinels bounding every real timestamp (keep searchsorted input
# sorted: empty tail slots sit at the front, batch padding at the back)
TS_NEG = -(2 ** 62)
TS_POS = 2 ** 62

FACC = torch.float32     # float accumulator (dtype policy)
IACC = torch.int64       # exact integer accumulator

SLIDING = ("length", "time", "timeLength")
# tumbling windows: the step's axis is [open remainder (N) | batch (B)]
REMAINDER = ("lengthBatch", "timeBatch", "session", "delay")
# windows whose state carries the tail_* aggregate lanes
TAILED = SLIDING + ("lengthBatch", "timeBatch", "session", "hopping")
# windows walked event by event over a carried table
WALKED = ("sort", "frequent", "lossyFrequent")


def _scalar_type(e) -> Optional[str]:
    """The Python type a bare (or negated) constant's closure returns, which
    the reference's step cannot take (it reads ``.dtype``/``.astype`` of
    it); None for any other expression."""
    while isinstance(e, Minus):
        e = e.expr
    return type(e.value).__name__ if isinstance(e, Constant) else None


@dataclass
class _Spec:
    name: str           # output name
    kind: str           # 'value' | 'sum' | 'count' | 'avg' | 'min' | 'max' | 'stdDev'
    fn: Optional[Callable] = None      # projection or aggregate-arg program
    dtype: DataType = DataType.DOUBLE
    source_attr: Optional[str] = None  # raw column name for string decode
    acc_int: bool = False              # accumulate exactly in int64
    ir: Optional[list] = None          # the same program as postfix IR


def _kahan_add(base, comp, add):
    """One compensated accumulation step: returns (new_base, new_comp)."""
    y = add - comp
    t = base + y
    return t, (t - base) - y


class _OutputResolver:
    """Resolves ``having`` variables against the select list's output names."""

    def __init__(self, specs: list[_Spec], schema: BatchSchema):
        self.specs = {s.name: s for s in specs}
        self.schema = schema
        self.param_types: dict = {}      # fleet parameters having reads

    def param_key(self, p) -> str:
        self.param_types[p.key] = p.type
        return p.key

    def resolve(self, var: Variable) -> tuple[str, DataType]:
        s = self.specs.get(var.attribute)
        if s is None:
            raise DeviceCompileError(
                f"having references '{var.attribute}', not an output "
                f"attribute")
        return s.name, s.dtype

    def encode_string(self, key: str, value: str) -> int:
        s = self.specs[key]
        if s.source_attr and s.source_attr in self.schema.dictionaries:
            return self.schema.dictionaries[s.source_attr].encode(value)
        raise DeviceCompileError(f"no dictionary for having key '{key}'")


class CompiledStreamQuery:
    """Compiles a supported Query AST to a (state, batch) -> (state, out)
    step. Raises DeviceCompileError for shapes the device path doesn't
    cover, with the reference's messages, and for what exceeds a kernel's
    limits (``query_step.QueryPlan``).

    ``device`` follows ``backend.resolve_device``: the card unless the
    caller asks for the CPU.

    ``host=True`` (the reference's ``backend="numpy"``): the SAME lowering
    pass (handler walk, spec build, refusals and their messages) emits the
    closures for the columnar host tier (``host_exec.HostStreamQuery``),
    under the full-width host policy and with no IR. It builds no kernel
    plan, so no kernel limit refuses it, and has no device (``device`` is
    None): that tier runs on the CPU whether or not a card is present."""

    def __init__(self, query: Query, definition: StreamDefinition,
                 batch_capacity: int = 4096, group_capacity: int = 1024,
                 window_capacity: int = 4096, device=None,
                 host: bool = False):
        ist = query.input_stream
        if not isinstance(ist, SingleInputStream):
            raise DeviceCompileError("device path covers single-stream queries")
        self.query = query
        self.definition = definition
        self.B = batch_capacity
        self.K = group_capacity
        self.host = host
        self.schema = BatchSchema(definition)
        resolver = ColumnResolver(self.schema, host=host)
        self.resolver = resolver
        # fleet parameter columns (``__fleet_p{i}`` → DataType) the programs
        # read: per-row columns the caller injects with the batch
        self.param_types = resolver.param_types

        # handlers: filters + at most one window
        self.filter_fns: list[Callable] = []
        self.filter_irs: list[list] = []
        self.window_kind: Optional[str] = None
        self.window_name: Optional[str] = None
        self.window_n = 0
        self.window_ms = 0
        self.time_key: Optional[str] = None     # externalTime ts column
        self.hop_ms = 0
        self.sort_key: Optional[str] = None
        self.sort_key_type: Optional[DataType] = None
        self.sort_desc = False
        self.hh_keys: list[str] = []
        self.lossy_support = 0.0
        self.lossy_error = 0.0
        for h in ist.handlers:
            if isinstance(h, Filter):
                fn, _, ir = compile_expression(h.expr, resolver)
                self.filter_fns.append(fn)
                self.filter_irs.append(ir)
            elif isinstance(h, Window):
                if self.window_kind is not None:
                    raise DeviceCompileError("multiple windows not supported")
                self._parse_window(h, resolver, definition, window_capacity)
            else:
                raise DeviceCompileError("stream functions not on device path")

        # group-by: one or more key columns (string codes / ints), mixed into
        # a single bucket id modulo K
        self.group_keys: list[str] = []
        self.group_key_types: list[DataType] = []
        for gb in (query.selector.group_by or []):
            key, kt = resolver.resolve(gb)
            if kt not in (DataType.STRING, DataType.INT, DataType.LONG):
                raise DeviceCompileError("group key must be string/int")
            self.group_keys.append(key)
            self.group_key_types.append(kt)
        if self.group_keys and self.window_kind in (
                "lengthBatch", "timeBatch", "session", "batch", "sort",
                "hopping", "frequent", "lossyFrequent"):
            raise DeviceCompileError(
                f"group-by with {self.window_kind} windows takes the host "
                f"path")

        # select list
        self.specs: list[_Spec] = []
        sel = query.selector
        attrs = sel.attributes
        if sel.select_all or not attrs:
            attrs = [OutputAttribute(None, Variable(attribute=n))
                     for n in definition.attribute_names]
        const_value, const_arg = [], []
        for oa in attrs:
            e = oa.expr
            if isinstance(e, AttributeFunction) and e.namespace is None \
                    and e.name in ("sum", "count", "avg", "min", "max",
                                   "distinctCount", "stdDev"):
                if e.args and _scalar_type(e.args[0]):
                    const_arg.append(_scalar_type(e.args[0]))
                if e.name == "distinctCount":
                    raise DeviceCompileError(
                        "aggregator 'distinctCount' needs the host path")
                arg_fn, at, arg_ir = (None, DataType.LONG, None)
                if e.args:
                    arg_fn, at, arg_ir = compile_expression(e.args[0], resolver)
                    if at not in (DataType.INT, DataType.LONG,
                                  DataType.FLOAT, DataType.DOUBLE):
                        raise DeviceCompileError(
                            f"{e.name}() over non-numeric arguments needs "
                            f"the host path")
                elif e.name != "count":
                    raise DeviceCompileError(f"{e.name}() needs an argument")
                int_arg = at in (DataType.INT, DataType.LONG)
                if e.name == "count":
                    dt = DataType.LONG
                elif e.name in ("avg", "stdDev"):
                    dt = DataType.DOUBLE
                elif e.name in ("min", "max"):
                    dt = at          # reference: min/max keep the arg type
                else:
                    dt = DataType.LONG if int_arg else DataType.DOUBLE
                self.specs.append(_Spec(oa.name, e.name, arg_fn, dt,
                                        acc_int=int_arg and
                                        e.name in ("sum", "avg"), ir=arg_ir))
            else:
                fn, t, ir = compile_expression(e, resolver)
                if _scalar_type(e):
                    const_value.append(_scalar_type(e))
                src = e.attribute if isinstance(e, Variable) and t == DataType.STRING \
                    else None
                self.specs.append(_Spec(oa.name, "value", fn, t, src, ir=ir))

        self.value_idx = [i for i, s in enumerate(self.specs) if s.kind == "value"]
        # aggregate lanes: counts ride the ones/cnts axis; sums/avgs split
        # into an exact-int stack and a float stack; min/max keep individual
        # policy-dtype lanes; stdDev lanes carry raw float values
        self.iagg_idx = [i for i, s in enumerate(self.specs)
                         if s.kind in ("sum", "avg") and s.acc_int]
        self.fagg_idx = [i for i, s in enumerate(self.specs)
                         if s.kind in ("sum", "avg") and not s.acc_int]
        self.magg_idx = [i for i, s in enumerate(self.specs)
                         if s.kind in ("min", "max")]
        self.sagg_idx = [i for i, s in enumerate(self.specs)
                         if s.kind == "stdDev"]
        self.agg_idx = [i for i, s in enumerate(self.specs) if s.kind != "value"]
        if self.group_keys and self.window_kind is not None and \
                (self.magg_idx or self.sagg_idx):
            raise DeviceCompileError(
                "group-by with windowed min/max/stdDev takes the host path")
        if self.window_kind == "delay" and (self.agg_idx or self.group_keys):
            raise DeviceCompileError(
                "aggregates/group-by over a delay window take the host path")
        if self.window_kind in ("frequent", "lossyFrequent") and \
                (self.magg_idx or self.sagg_idx):
            raise DeviceCompileError(
                f"min/max/stdDev over {self.window_kind} windows take the "
                f"host path")
        if self.window_kind == "hopping" and not self.agg_idx:
            raise DeviceCompileError(
                "hopping without aggregates takes the host path")

        # having: post-filter over materialized output columns
        self.having_fn: Optional[Callable] = None
        self.having_ir: Optional[list] = None
        # fleet parameter columns having reads (keys of ``param_types``)
        self.having_params: set[str] = set()
        if query.selector.having is not None:
            hres = _OutputResolver(self.specs, self.schema)
            hres.host = host
            self.having_fn, _, self.having_ir = compile_expression(
                query.selector.having, hres)
            self.having_params = set(hres.param_types)
            self.param_types.update(hres.param_types)

        # a constant projection or aggregate argument: the reference's step
        # fails on the Python scalar (projections first); so does the port's,
        # on every device
        self.step_error: Optional[str] = None
        if const_value or const_arg:
            attr = "dtype" if const_value else "astype"
            self.step_error = f"'{(const_value or const_arg)[0]}' object " \
                f"has no attribute '{attr}'"

        if host:
            self.plan = self.device = None
            return
        from .query_step import make_plan
        self.plan = make_plan(self)       # kernel limits refuse here
        self.device = resolve_device(device)

    def _parse_window(self, h: Window, resolver, definition, window_capacity):
        """The reference's window parse (every kind it knows, so refusals
        and their messages match), recording ``window_kind``/``window_name``."""
        def const_param(idx: int) -> int:
            if len(h.params) <= idx or not hasattr(h.params[idx], "value"):
                raise DeviceCompileError(
                    f"window '{h.name}' needs a constant parameter "
                    f"at position {idx}")
            return int(h.params[idx].value)

        self.window_name = h.name or None
        if h.name in ("length", "lengthBatch"):
            self.window_kind = h.name
            self.window_n = const_param(0)
        elif h.name == "time":
            # sliding event-time window; the device clock IS event time
            self.window_kind = "time"
            self.window_ms = const_param(0)
            self.window_n = window_capacity
        elif h.name == "externalTime":
            if len(h.params) != 2 or not isinstance(h.params[0], Variable):
                raise DeviceCompileError(
                    "externalTime needs (timestamp attribute, duration)")
            key, kt = resolver.resolve(h.params[0])
            if kt not in (DataType.LONG, DataType.INT):
                raise DeviceCompileError(
                    "externalTime attribute must be long/int")
            self.window_kind = "time"
            self.time_key = key
            self.window_ms = const_param(1)
            self.window_n = window_capacity
        elif h.name == "timeBatch":
            if len(h.params) > 1:
                raise DeviceCompileError(
                    "timeBatch start-time parameter takes the host path")
            self.window_kind = "timeBatch"
            self.window_ms = const_param(0)
            self.window_n = window_capacity
        elif h.name == "externalTimeBatch":
            if len(h.params) != 2 or not isinstance(h.params[0], Variable):
                raise DeviceCompileError(
                    "externalTimeBatch start-time/timeout take the host path")
            key, kt = resolver.resolve(h.params[0])
            if kt not in (DataType.LONG, DataType.INT):
                raise DeviceCompileError(
                    "externalTimeBatch attribute must be long/int")
            self.window_kind = "timeBatch"
            self.time_key = key
            self.window_ms = const_param(1)
            self.window_n = window_capacity
        elif h.name == "timeLength":
            # sliding window bounded by BOTH time and count
            self.window_kind = "timeLength"
            self.window_ms = const_param(0)
            self.window_n = const_param(1)
        elif h.name == "delay":
            self.window_kind = "delay"
            self.window_ms = const_param(0)
            self.window_n = window_capacity
        elif h.name == "session":
            if len(h.params) > 1:
                raise DeviceCompileError(
                    "session key / allowedLatency take the host path")
            self.window_kind = "session"
            self.window_ms = const_param(0)
            self.window_n = window_capacity
        elif h.name == "batch":
            # per-chunk tumbling window: the device batch IS the chunk
            if h.params:
                raise DeviceCompileError("batch(length) takes the host path")
            self.window_kind = "batch"
        elif h.name == "":
            # #window() pass-through: never expires, compiles as no-window
            pass
        elif h.name == "sort":
            if len(h.params) < 2 or not isinstance(h.params[1], Variable):
                raise DeviceCompileError("sort window needs (N, key attribute)")
            if len(h.params) > 3:
                raise DeviceCompileError("multi-key sort takes the host path")
            order = "asc"
            if len(h.params) == 3:
                v = getattr(h.params[2], "value", None)
                if not isinstance(v, str) or v.lower() not in ("asc", "desc"):
                    raise DeviceCompileError("sort order must be 'asc'|'desc'")
                order = v.lower()
            skey, skt = resolver.resolve(h.params[1])
            if skt not in (DataType.INT, DataType.LONG, DataType.FLOAT,
                           DataType.DOUBLE):
                raise DeviceCompileError(
                    "sort key must be numeric on device (string "
                    "collation takes the host path)")
            self.window_kind = "sort"
            self.window_n = const_param(0)
            self.sort_key, self.sort_key_type = skey, skt
            self.sort_desc = order == "desc"
        elif h.name in ("frequent", "lossyFrequent"):
            def fconst(idx: int) -> float:
                if len(h.params) <= idx or not hasattr(h.params[idx], "value"):
                    raise DeviceCompileError(
                        f"window '{h.name}' needs a constant "
                        f"parameter at position {idx}")
                return float(h.params[idx].value)

            if h.name == "frequent":
                cap = const_param(0)
                if cap < 1:
                    raise DeviceCompileError(
                        "frequent window count must be >= 1")
                key_params = list(h.params[1:])
            else:
                self.lossy_support = fconst(0)
                nxt = 1
                if len(h.params) > 1 and isinstance(h.params[1], Constant) \
                        and not isinstance(h.params[1].value, str):
                    self.lossy_error = fconst(1)
                    nxt = 2
                else:
                    self.lossy_error = self.lossy_support / 10.0
                if self.lossy_error <= 0:
                    raise DeviceCompileError(
                        "lossyFrequent error bound must be positive")
                # the host dict is unbounded; honour the window capacity
                cap = min(65536, max(int(1.0 / self.lossy_error) + 64,
                                     window_capacity))
                key_params = list(h.params[nxt:])
            if not key_params:
                key_params = [Variable(attribute=a.name)
                              for a in definition.attributes]
            if len(key_params) > 2:
                raise DeviceCompileError(
                    f"{h.name} with >2 key attributes takes the host path")
            for kp in key_params:
                if not isinstance(kp, Variable):
                    raise DeviceCompileError(f"{h.name} key must be an attribute")
                kk, kt = resolver.resolve(kp)
                allowed = (DataType.STRING, DataType.INT) \
                    if len(key_params) == 2 \
                    else (DataType.STRING, DataType.INT, DataType.LONG)
                if kt not in allowed:
                    raise DeviceCompileError(
                        f"{h.name} key '{kk}' type takes the host path")
                self.hh_keys.append(kk)
            self.window_kind = h.name
            self.window_n = cap
        elif h.name == "hopping":
            self.window_kind = "hopping"
            self.window_ms = const_param(0)
            self.hop_ms = const_param(1)
            if self.hop_ms <= 0 or self.window_ms <= 0:
                raise DeviceCompileError(
                    "hopping needs positive duration and hop")
            self.window_n = window_capacity
        else:
            raise DeviceCompileError(
                f"window '{h.name}' has no device kernel yet")

    def _mdtype(self, i: int) -> torch.dtype:
        return TORCH[self.specs[i].dtype]

    # ------------------------------------------------------------------ state
    def init_state(self, device=None) -> dict:
        """The reference's initial state tree, on ``device`` (default: the
        compiled query's)."""
        dev = self.device if device is None else torch.device(device)
        N = max(self.window_n, 1)
        AF, AI = len(self.fagg_idx), len(self.iagg_idx)
        AS = len(self.sagg_idx)
        K = self.K
        kind = self.window_kind

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        def full(shape, v, dt):
            return torch.full(shape, v, dtype=dt, device=dev)

        def m_lanes(prefix, shape):
            for i in self.magg_idx:
                dt = self._mdtype(i)
                state[f"{prefix}{i}"] = full(
                    shape, reduce_identity(dt, self.specs[i].kind == "min"), dt)

        def proj_lanes(prefix):
            for i in self.value_idx:
                state[f"{prefix}{i}"] = z((N,), TORCH[self.specs[i].dtype])

        state: dict[str, Any] = {}
        if kind in TAILED:
            state["tail_fvals"] = z((AF, N), FACC)
            state["tail_ivals"] = z((AI, N), IACC)
            state["tail_svals"] = z((AS, N), FACC)
            state["tail_ones"] = z((N,), torch.int32)
            m_lanes("tail_m", (N,))
        if kind in ("time", "timeLength"):
            # sentinel = long-expired; keeps the concat ts array sorted
            state["tail_ts"] = full((N,), TS_NEG, torch.int64)
            state["window_drops"] = z((), torch.int64)
            state["last_ts"] = full((), TS_NEG, torch.int64)
            state["ts_regressions"] = z((), torch.int64)
        if kind in REMAINDER:
            state["rem_count"] = z((), torch.int32)
            state["rem_ts"] = z((N,), torch.int64)
            proj_lanes("rem_proj_")
        if kind == "timeBatch":
            state["batch_base"] = full((), TS_NEG, torch.int64)
        if kind in ("timeBatch", "session", "delay"):
            state["window_drops"] = z((), torch.int64)
            state["ts_regressions"] = z((), torch.int64)
        if kind == "hopping":
            state["tail_ts"] = full((N,), TS_NEG, torch.int64)
            state["hop_next"] = full((), TS_NEG, torch.int64)
            state["window_drops"] = z((), torch.int64)
            state["last_ts"] = full((), TS_NEG, torch.int64)
            state["ts_regressions"] = z((), torch.int64)
            proj_lanes("tail_proj_")
        if kind in ("frequent", "lossyFrequent"):
            C = N
            state["hh_keys"] = z((C,), torch.int64)
            state["hh_counts"] = z((C,), torch.int64)
            state["hh_fvals"] = z((AF, C), FACC)
            state["hh_ivals"] = z((AI, C), IACC)
            state["hh_run_f"] = z((AF,), FACC)
            state["hh_run_i"] = z((AI,), IACC)
            state["hh_run_cnt"] = z((), torch.int64)
            if kind == "lossyFrequent":
                state["hh_delta"] = z((C,), torch.int64)
                state["hh_total"] = z((), torch.int64)
                state["window_drops"] = z((), torch.int64)
        if kind == "sort":
            kdt = TORCH[self.sort_key_type]
            # empty slots sort after every real key (desc keys are stored
            # negated, so ascending order IS the sort order)
            state["sort_keys"] = full((N,), reduce_identity(kdt, True), kdt)
            state["sort_n"] = z((), torch.int32)
            state["sort_fvals"] = z((AF, N), FACC)
            state["sort_ivals"] = z((AI, N), IACC)
            state["sort_svals"] = z((AS, N), FACC)
            m_lanes("sort_m", (N,))
        if self.group_keys and kind in TAILED:
            # windowed group-by carries no per-key sums: only the bucket id
            # per tail slot and the collision-ownership map persist
            state["tail_gkey"] = z((N,), torch.int32)
            state["key_owner"] = z((K,), torch.int64)
            state["key_owned"] = z((K,), torch.bool)
            state["group_collisions"] = z((), torch.int64)
        elif self.group_keys:
            state["key_fsums"] = z((AF, K), FACC)
            state["key_fcomp"] = z((AF, K), FACC)
            state["key_isums"] = z((AI, K), IACC)
            state["key_counts"] = z((K,), torch.int64)
            state["key_owner"] = z((K,), torch.int64)
            state["key_owned"] = z((K,), torch.bool)
            state["group_collisions"] = z((), torch.int64)
            for i in self.magg_idx:
                dt = self._mdtype(i)
                state[f"key_m{i}"] = full(
                    (K,), reduce_identity(dt, self.specs[i].kind == "min"), dt)
            state["key_smean"] = z((AS, K), FACC)
            state["key_sm2"] = z((AS, K), FACC)
            state["key_scnt"] = z((AS, K), FACC)
        if kind is None and not self.group_keys:
            state["run_fsums"] = z((AF,), FACC)
            state["run_fcomp"] = z((AF,), FACC)
            state["run_isums"] = z((AI,), IACC)
            state["run_count"] = z((), torch.int64)
            for i in self.magg_idx:
                dt = self._mdtype(i)
                state[f"run_m{i}"] = full(
                    (), reduce_identity(dt, self.specs[i].kind == "min"), dt)
            state["run_smean"] = z((AS,), FACC)
            state["run_sm2"] = z((AS,), FACC)
            state["run_scnt"] = z((AS,), FACC)
        return state

    def column_type(self, key: str) -> DataType:
        """A step column's type: a stream attribute's, or a fleet
        parameter's."""
        t = self.param_types.get(key)
        return t if t is not None else self.definition.attribute_type(key)

    # -------------------------------------------------------------- execution
    def batch_tensors(self, batch: dict, device=None):
        """``BatchBuilder.emit()`` output (numpy) → ``(cols, ts, valid)``
        tensors on ``device`` (default: the compiled query's)."""
        dev = self.device if device is None else torch.device(device)
        names = list(batch["cols"])
        parts = [batch["cols"][k] for k in names] + [batch["ts"],
                                                      batch["valid"]]
        if any(isinstance(x, torch.Tensor) for x in parts):
            moved = [x.to(dev) if isinstance(x, torch.Tensor) else
                     torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in parts]
        else:                           # one copy (``gpu/transfer.py``)
            moved = to_device(parts, dev)
        return dict(zip(names, moved)), moved[-2], moved[-1]

    def step(self, state, batch: dict):
        """batch: output of ``BatchBuilder.emit()``; returns (state, out).
        The step runs where the state lies: the plain version for CPU
        tensors, the kernel for CUDA tensors (the input state is consumed,
        as the reference donates it)."""
        dev = next(iter(state.values())).device if state else self.device
        cols, ts, valid = self.batch_tensors(batch, dev)
        return self.step_tensors(state, cols, ts, valid)

    def step_tensors(self, state, cols, ts, valid):
        kind = ts.device.type
        if kind == "cuda":
            return self.plan.step_cuda(state, cols, ts, valid)
        if kind == "cpu":
            return stream_step_plain(self, state, cols, ts, valid)
        raise ValueError(f"no query step for device type {kind!r}")

    def decode_outputs(self, out) -> list[list]:
        """Valid output rows, in order, as Python values (strings decoded
        through the dictionary)."""
        valid, *cols = to_host([out["valid"]] + [out["out"][s.name]
                                                 for s in self.specs])
        idx = np.nonzero(valid)[0]
        columns = []
        for s, col in zip(self.specs, cols):
            col = col[idx]
            if s.dtype == DataType.STRING and s.source_attr:
                dic = self.schema.dictionaries[s.source_attr]
                columns.append([dic.decode(c) for c in col.tolist()])
            else:
                columns.append(col.tolist())
        return [list(r) for r in zip(*columns)] if columns else []


# ---------------------------------------------------------------------------
# the plain step
# ---------------------------------------------------------------------------

def _cumsum(z: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sums along ``dim``: float32 accumulated in float64
    and rounded once per prefix (see the module docstring), integers
    exactly in int64."""
    if z.dtype == torch.float32:
        return torch.cumsum(z.double(), dim).float()
    return torch.cumsum(z.to(torch.int64), dim)


def _sq(x: torch.Tensor) -> torch.Tensor:
    """``x ** 2`` as the reference lowers it: one multiply."""
    return x * x


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64: torch's
    float32 ``sqrt`` on the CPU can be an ulp off)."""
    return torch.sqrt(x.double()).float()


def _fsum(z: torch.Tensor, dim: int) -> torch.Tensor:
    """Totals along ``dim`` under the same rule as ``_cumsum``."""
    if z.dtype == torch.float32:
        return z.double().sum(dim).float()
    return z.to(torch.int64).sum(dim)


def _range_sums(z, lo, j):
    """Sums of z [A, M] over inclusive ranges [lo, j] (leading-zero prefix
    difference)."""
    A = z.shape[0]
    if not A:
        return torch.zeros((0, j.shape[0]), dtype=z.dtype, device=z.device)
    cs = torch.cat([torch.zeros((A, 1), dtype=z.dtype, device=z.device),
                    _cumsum(z, 1).to(z.dtype)], 1)
    return cs[:, j + 1] - cs[:, lo]


def _range_reduce(z, lo, j, is_min: bool):
    """min/max of ``z`` over inclusive ranges [lo_b, j_b]: the reference's
    log-doubling sparse table, including its value for an empty range
    (``lo > j``: the reduction of ``z[j]`` and ``z[min(lo, M-1)]``)."""
    M = z.shape[0]
    red = torch.minimum if is_min else torch.maximum
    ident = reduce_identity(z.dtype, is_min)
    tables = [z]
    span = 1
    while span < M:
        prev = tables[-1]
        shifted = torch.cat([torch.full((min(span, M),), ident, dtype=z.dtype,
                                        device=z.device), prev[:M - span]])
        tables.append(red(prev, shifted))
        span *= 2
    T = torch.stack(tables)                              # [KK, M]
    m = torch.clamp(j - lo + 1, min=1)
    kk = torch.floor(torch.log2(m.double())).long()      # floor(log2 m), exact
    p2 = torch.ones_like(kk) << kk
    return red(T[kk, j], T[kk, torch.clamp(lo + p2 - 1, 0, M - 1)])


def _window_svars(z_s, zo, lo, j, cnts, B):
    """stdDev over inclusive ranges: shifted second moments centred at the
    mean of the concat axis, in float64."""
    AS = z_s.shape[0]
    dev = z_s.device
    if not AS:
        return torch.zeros((0, B), dtype=FACC, device=dev)
    occ = (zo > 0).double()
    out = torch.zeros((AS, B), dtype=FACC, device=dev)
    n = torch.clamp(cnts.double(), min=1.0)
    zero = torch.zeros(1, dtype=torch.float64, device=dev)
    for si in range(AS):
        raw = z_s[si].double()
        c = (raw * occ).sum() / torch.clamp(occ.sum(), min=1.0)
        d = (raw - c) * occ
        cs1 = torch.cat([zero, torch.cumsum(d, 0)])
        cs2 = torch.cat([zero, torch.cumsum(d * d, 0)])
        s1 = cs1[j + 1] - cs1[lo]
        s2 = cs2[j + 1] - cs2[lo]
        var = torch.clamp(s2 / n - _sq(s1 / n), min=0.0)
        out[si] = torch.sqrt(var).float()
    return out


def _materialize(specs, value_idx, fagg_idx, iagg_idx, sagg_idx,
                 proj, sums_f, sums_i, cnts, mins, svars):
    outputs = {}
    for i in value_idx:
        outputs[specs[i].name] = proj[i]
    fpos = {i: p for p, i in enumerate(fagg_idx)}
    ipos = {i: p for p, i in enumerate(iagg_idx)}
    spos = {i: p for p, i in enumerate(sagg_idx)}
    for i, s in enumerate(specs):
        if s.kind == "value":
            continue
        if s.kind == "count":
            outputs[s.name] = cnts
        elif s.kind == "sum":
            outputs[s.name] = sums_i[ipos[i]] if s.acc_int else sums_f[fpos[i]]
        elif s.kind in ("min", "max"):
            outputs[s.name] = mins[i]
        elif s.kind == "stdDev":
            outputs[s.name] = svars[spos[i]]
        else:  # avg (always emitted as double → policy float)
            num = sums_i[ipos[i]].to(FACC) if s.acc_int \
                else sums_f[fpos[i]]
            outputs[s.name] = num / torch.clamp(cnts, min=1).to(FACC)
    return outputs


def group_bucket(q: CompiledStreamQuery, k64: list[torch.Tensor]):
    """Bucket id [n] (int32) + exact packed key [n] (int64) for the group-by
    key columns: a single narrow key (dictionary code / int) mod K directly,
    wider combinations through the splitmix64 finalizer."""
    K = q.K
    narrow = all(t in (DataType.STRING, DataType.INT)
                 for t in q.group_key_types)
    if len(k64) == 1:
        packed = k64[0]
        if narrow:
            return ((packed & 0x7FFFFFFFFFFFFFFF) % K).to(torch.int32), packed
        return (avalanche(packed) % K).to(torch.int32), packed
    if len(k64) == 2 and narrow:
        packed = (k64[0] << 32) | (k64[1] & 0xFFFFFFFF)
    else:
        packed = k64[0]
        for kx in k64[1:]:
            packed = packed * 0x100000001B3 ^ kx
    return (avalanche(packed) % K).to(torch.int32), packed


def stream_step_plain(q: CompiledStreamQuery, state: dict, cols: dict,
                      ts: torch.Tensor, valid: torch.Tensor):
    """One step of the compiled query in plain torch, on any device:
    ``(state, cols [B], ts int64 [B], valid bool [B]) -> (new state, out)``
    with ``out = {"out": {name: [O]}, "valid": bool [O], "ts": int64 [O],
    "count": int32}`` over the window's output axis (``O`` = B, or N + B for
    the tumbling windows; see the module docstring). The input state is not
    modified."""
    if q.step_error is not None:
        raise AttributeError(q.step_error)
    B = q.B
    dev = ts.device
    specs = q.specs
    value_idx, fagg_idx, iagg_idx = q.value_idx, q.fagg_idx, q.iagg_idx
    magg_idx, sagg_idx = q.magg_idx, q.sagg_idx
    window_kind, N = q.window_kind, max(q.window_n, 1)
    K = q.K
    m_ismin = {i: specs[i].kind == "min" for i in magg_idx}
    m_ident = {i: reduce_identity(q._mdtype(i), m_ismin[i]) for i in magg_idx}
    i32, i64 = torch.int32, torch.int64

    env = dict(cols)
    env["__ts__"] = ts
    env["__device__"] = dev
    mask = valid
    for fn in q.filter_fns:
        mask = torch.logical_and(mask, as_tensor(fn(env), env))
    mask = mask.expand(B)
    k = int(mask.sum())
    ar = torch.arange(B, device=dev)

    def full_b(x, dt=None):
        x = as_tensor(x, env)
        if dt is not None:
            x = astype(x, dt)
        return x.expand(B) if x.dim() == 0 else x

    def compact(x, fill=0):
        """Stable compaction: accepted event i → slot rank_i, the rest hold
        ``fill``."""
        out = torch.full((B,), fill, dtype=x.dtype, device=dev)
        out[:k] = x[mask]
        return out

    cts = compact(ts)
    proj_c = {i: compact(full_b(specs[i].fn(env), TORCH[specs[i].dtype]))
              for i in value_idx}

    def make_keys():
        k64 = [compact(cols[gk].to(i64)) for gk in q.group_keys]
        return group_bucket(q, k64)

    def agg_stack(idx, dt):
        rows = [compact(full_b(specs[i].fn(env), dt)) for i in idx]
        return torch.stack(rows) if rows else \
            torch.zeros((0, B), dtype=dt, device=dev)

    av_f = agg_stack(fagg_idx, FACC)
    av_i = agg_stack(iagg_idx, IACC)
    av_s = agg_stack(sagg_idx, FACC)          # raw values
    av_m = {i: compact(full_b(specs[i].fn(env), q._mdtype(i)), m_ident[i])
            for i in magg_idx}
    ones_c = compact(mask.to(i32))
    out_valid = ar < k

    # fleet per-tenant parameter columns (injected by the caller, not part
    # of the schema): compacted so having programs over hoisted constants
    # stay row-aligned with the output columns, as the reference compacts
    # them
    pcols = {kk: compact(cols[kk]) for kk in cols
             if kk.startswith("__fleet_p")}

    def finish(new_state, sums_f, sums_i, cnts, mins, svars,
               ovalid=out_valid, count=None, ots=cts, proj=proj_c,
               params=True):
        out = _materialize(specs, value_idx, fagg_idx, iagg_idx, sagg_idx,
                           proj, sums_f, sums_i, cnts, mins, svars)
        if q.having_fn is not None:
            henv = {**pcols, **out} if params and pcols else out
            hv = as_tensor(q.having_fn({**henv, "__device__": dev}), env)
            ovalid = ovalid & hv.expand(ovalid.shape)
        cnt = torch.tensor(k if count is None else count, dtype=i32,
                           device=dev)
        return new_state, {"out": out, "valid": ovalid, "ts": ots,
                           "count": cnt}

    lanes = (av_f, av_i, av_s, av_m, ones_c, proj_c)
    if window_kind in REMAINDER:
        wcol = cols[q.time_key].to(i64) if q.time_key else ts
        return _remainder_step(q, state, k, lanes, cts, compact(wcol, TS_POS),
                               m_ismin, finish)
    if window_kind == "hopping":
        return _hopping_step(q, state, k, lanes, compact(ts, TS_POS),
                             m_ismin, finish)
    if window_kind == "sort":
        kdt = TORCH[q.sort_key_type]
        kv = full_b(cols[q.sort_key], kdt)
        if q.sort_desc:
            # stored negated: ascending order IS the sort order; the integer
            # minimum has no negation, so it is clamped one up first
            if not kdt.is_floating_point:
                lowest = torch.iinfo(kdt).min
                kv = torch.where(kv == lowest, lowest + 1, kv)
            kv = -kv
        return finish(*_sort_walk(q, state, k, compact(kv, reduce_identity(
            kdt, True)), av_f, av_i, av_s, av_m, m_ismin, m_ident))
    if window_kind in ("frequent", "lossyFrequent"):
        k64 = [compact(cols[kk].to(i64)) for kk in q.hh_keys]
        kcode = (k64[0] << 32) | (k64[1] & 0xFFFFFFFF) if len(k64) == 2 \
            else k64[0]
        new_state, emit, sums_f, sums_i, cnts = _heavy_hitters(
            q, state, k, kcode, av_f, av_i)
        ovalid = out_valid & emit
        return finish(new_state, sums_f, sums_i, cnts, {},
                      torch.zeros((0, B), dtype=FACC, device=dev),
                      ovalid=ovalid, count=int(ovalid.sum()))

    def slide(new, z_f, z_i, z_s, zo, zm):
        new["tail_fvals"] = z_f[:, k:k + N]
        new["tail_ivals"] = z_i[:, k:k + N]
        new["tail_svals"] = z_s[:, k:k + N]
        new["tail_ones"] = zo[k:k + N]
        for i, zz in zm.items():
            new[f"tail_m{i}"] = zz[k:k + N]

    if window_kind in SLIDING:
        z_f = torch.cat([state["tail_fvals"], av_f], 1)
        z_i = torch.cat([state["tail_ivals"], av_i], 1)
        z_s = torch.cat([state["tail_svals"], av_s], 1)
        zo = torch.cat([state["tail_ones"], ones_c])
        zm = {i: torch.cat([state[f"tail_m{i}"], av_m[i]]) for i in magg_idx}
        j = ar + N
        new_state = dict(state)
        if window_kind == "length":
            n_tail = int(state["tail_ones"].sum())
            lo = torch.clamp(j - N + 1, min=N - n_tail)
        else:
            wcol = cols[q.time_key].to(i64) if q.time_key else ts
            wts = compact(wcol, TS_POS)
            raw = torch.where(out_valid, wts, TS_POS)
            mono = torch.maximum(torch.cummax(raw, 0).values, state["last_ts"])
            regressed = (out_valid & (raw < mono)).sum()
            wts_s = torch.where(out_valid, mono, TS_POS)
            zts = torch.cat([state["tail_ts"], wts_s])
            D = q.window_ms
            lo = torch.searchsorted(zts, wts_s - D, right=True)
            newest = zts[max(N + k - 1, 0)]
            sliced = torch.arange(N + B, device=dev) < k
            drops = torch.where(sliced & (zts > newest - D), zo, 0).sum()
            new_state["tail_ts"] = zts[k:k + N]
            new_state["window_drops"] = state["window_drops"] + drops
            if k > 0:
                new_state["last_ts"] = torch.maximum(state["last_ts"],
                                                     mono[k - 1])
            new_state["ts_regressions"] = state["ts_regressions"] + regressed
            if window_kind == "timeLength":
                # the live range is also bounded by the newest window_n
                # events; that eviction is the window's own semantics
                lo = torch.maximum(lo, j - N + 1)
                new_state["window_drops"] = state["window_drops"]
        slide(new_state, z_f, z_i, z_s, zo, zm)
        if q.group_keys:
            keys_b, packed = make_keys()
            zk = torch.cat([state["tail_gkey"], keys_b])
            sums_f = _keyed_range_sums(z_f, zk, K, lo, j, keys_b)
            sums_i = _keyed_range_sums(z_i, zk, K, lo, j, keys_b)
            cnts = _keyed_range_sums(zo.to(i64)[None], zk, K, lo, j,
                                     keys_b)[0]
            new_state["tail_gkey"] = zk[k:k + N]
            _collisions(state, new_state, keys_b, packed, out_valid, K)
            return finish(new_state, sums_f, sums_i, cnts, {},
                          torch.zeros((0, B), dtype=FACC, device=dev))
        sums_f = _range_sums(z_f, lo, j)
        sums_i = _range_sums(z_i, lo, j)
        cso = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                         torch.cumsum(zo.to(i64), 0)])
        cnts = cso[j + 1] - cso[lo]
        mins = {i: _range_reduce(zm[i], lo, j, m_ismin[i]) for i in magg_idx}
        svars = _window_svars(z_s, zo, lo, j, cnts, B)
        return finish(new_state, sums_f, sums_i, cnts, mins, svars)

    if window_kind == "batch":
        # the accepted sub-batch IS the chunk; with aggregates it collapses
        # to one row, the last accepted slot
        lo0 = torch.zeros(B, dtype=i64, device=dev)
        sums_f = _range_sums(av_f, lo0, ar)
        sums_i = _range_sums(av_i, lo0, ar)
        cnts = torch.cumsum(ones_c.to(i64), 0)
        mins = {i: _range_reduce(av_m[i], lo0, ar, m_ismin[i])
                for i in magg_idx}
        svars = _window_svars(av_s, ones_c, lo0, ar, cnts, B)
        ovalid = out_valid
        if q.agg_idx:
            ovalid = ovalid & (ar == k - 1)
        return finish(state, sums_f, sums_i, cnts, mins, svars,
                      ovalid=ovalid, count=int(ovalid.sum()))

    if q.group_keys:
        return finish(*_grouped(q, state, make_keys(), out_valid, av_f, av_i,
                                av_s, av_m, m_ismin, m_ident))

    # running aggregates, no window/grouping
    new_state = dict(state)
    sums_f = _cumsum(av_f, 1) + state["run_fsums"][:, None]
    sums_i = _cumsum(av_i, 1) + state["run_isums"][:, None]
    cnts = torch.cumsum(ones_c.to(i64), 0) + state["run_count"]
    nf, nc = _kahan_add(state["run_fsums"], state["run_fcomp"], _fsum(av_f, 1))
    new_state.update({"run_fsums": nf, "run_fcomp": nc,
                      "run_isums": state["run_isums"] + _fsum(av_i, 1),
                      "run_count": state["run_count"] + ones_c.to(i64).sum()})
    mins = {}
    for i in magg_idx:
        pre = (torch.cummin if m_ismin[i] else torch.cummax)(av_m[i], 0).values
        red = torch.minimum if m_ismin[i] else torch.maximum
        mins[i] = red(pre, state[f"run_m{i}"])
        new_state[f"run_m{i}"] = mins[i][-1]
    AS = len(sagg_idx)
    svars = torch.zeros((AS, B), dtype=FACC, device=dev)
    smean, sm2, scnt = (state["run_smean"].clone(), state["run_sm2"].clone(),
                        state["run_scnt"].clone())
    for si in range(AS):
        # centre at the carried mean; on the very first events use the first
        # accepted value (0-centring cancels catastrophically)
        c = torch.where(state["run_scnt"][si] > 0, state["run_smean"][si],
                        av_s[si][0])
        occ = ones_c.to(FACC)
        d = (av_s[si] - c) * occ
        s1 = _cumsum(d, 0)
        s2 = _cumsum(d * d, 0)
        nsc = state["run_scnt"][si] + _cumsum(occ, 0)
        var = torch.clamp(
            (state["run_sm2"][si] + s2) / torch.clamp(nsc, min=1.0)
            - _sq(s1 / torch.clamp(nsc, min=1.0)), min=0.0)
        svars[si] = _sqrt32(var)
        n_new = state["run_scnt"][si] + _fsum(occ, 0)
        mean_new = c + s1[-1] / torch.clamp(n_new, min=1.0)
        m2_new = state["run_sm2"][si] + s2[-1] - \
            torch.clamp(n_new, min=1.0) * _sq(mean_new - c)
        smean[si], sm2[si], scnt[si] = mean_new, torch.clamp(m2_new, min=0.0), n_new
    new_state.update({"run_smean": smean, "run_sm2": sm2, "run_scnt": scnt})
    return finish(new_state, sums_f, sums_i, cnts, mins, svars)


def _pad_slice(row, start: int, n: int):
    """``row[..., start:start + n]``, zero-padded past the end (the
    reference pads its slab so a slice start past ``M - n`` never clamps
    back into emitted slots)."""
    pad = torch.zeros(row.shape[:-1] + (n,), dtype=row.dtype, device=row.device)
    return torch.cat([row, pad], -1)[..., start:start + n]


def _remainder_step(q, state, k, lanes, cts, cts_pos, m_ismin, finish):
    """``lengthBatch``, ``timeBatch``/``externalTimeBatch``, ``session`` and
    ``delay``: the open remainder (first ``r`` of N) and the batch's
    accepted events, compacted into one axis of M = N + B slots; outputs
    over every slot, the open part carried to the next step."""
    av_f, av_i, av_s, av_m, ones_c, proj_c = lanes
    kind, B, N = q.window_kind, q.B, max(q.window_n, 1)
    dev = cts.device
    i64 = torch.int64
    M = N + B
    r = int(state["rem_count"])
    total = r + k
    j2 = torch.arange(M, device=dev)
    has_agg = bool(q.agg_idx)

    def zc(x_rem, x_batch, fill=0):
        out = torch.full(x_rem.shape[:-1] + (M,), fill, dtype=x_rem.dtype,
                         device=dev)
        out[..., :r] = x_rem[..., :r]
        out[..., r:r + k] = x_batch[..., :k]
        return out

    zproj = {i: zc(state[f"rem_proj_{i}"], proj_c[i]) for i in q.value_idx}
    new_state = dict(state)

    def carry(rem_n: int, start: int, zts_keep, tails=None):
        """The new remainder: ``rem_n`` slots from ``start`` (the rest
        zero, or the min/max identity)."""
        keep = torch.arange(N, device=dev) < rem_n
        new_state["rem_count"] = torch.tensor(rem_n, dtype=torch.int32,
                                              device=dev)
        new_state["rem_ts"] = torch.where(keep, _pad_slice(zts_keep, start, N),
                                          0)
        for i, z in zproj.items():
            new_state[f"rem_proj_{i}"] = torch.where(
                keep, _pad_slice(z, start, N), 0)
        if tails is None:
            return
        z_f, z_i, z_s, zo, zm = tails
        new_state["tail_fvals"] = torch.where(keep, _pad_slice(z_f, start, N), 0)
        new_state["tail_ivals"] = torch.where(keep, _pad_slice(z_i, start, N), 0)
        new_state["tail_svals"] = torch.where(keep, _pad_slice(z_s, start, N), 0)
        new_state["tail_ones"] = torch.where(keep, _pad_slice(zo, start, N), 0)
        for i, z in zm.items():
            new_state[f"tail_m{i}"] = torch.where(
                keep, _pad_slice(z, start, N),
                reduce_identity(z.dtype, m_ismin[i]))

    if kind == "delay":
        # pass-through after a fixed delay: hold rows until the newest
        # arrival passes held_ts + delay; rows carry ts = held_ts + delay
        zts_raw = zc(state["rem_ts"], cts, TS_POS)
        zts = torch.cummax(zts_raw, 0).values
        regressions = ((zts > zts_raw) & (j2 < total)).sum()
        newest = zts[min(max(total - 1, 0), M - 1)] if total > 0 else \
            torch.tensor(TS_NEG, dtype=i64, device=dev)
        release = (j2 < total) & (zts + q.window_ms <= newest)
        n_rel = int(release.sum())
        rem_n = min(total - n_rel, N)
        new_state["window_drops"] = state["window_drops"] + \
            (total - n_rel - rem_n)
        new_state["ts_regressions"] = state["ts_regressions"] + regressions
        carry(rem_n, max(total - rem_n, 0), zts)
        # the reference's delay step hands having the outputs alone
        return finish(new_state, None, None, None, {}, None, ovalid=release,
                      count=n_rel, ots=zts + q.window_ms, proj=zproj,
                      params=False)

    z_f = zc(state["tail_fvals"], av_f)
    z_i = zc(state["tail_ivals"], av_i)
    z_s = zc(state["tail_svals"], av_s)
    zm = {i: zc(state[f"tail_m{i}"], av_m[i],
                reduce_identity(av_m[i].dtype, m_ismin[i])) for i in q.magg_idx}
    zo = zc(state["tail_ones"], ones_c)
    tails = (z_f, z_i, z_s, zo, zm)

    if kind == "lengthBatch":
        zts = zc(state["rem_ts"], cts)
        lo = torch.div(j2, N, rounding_mode="floor") * N
        cnts = j2 % N + 1
        full = total // N
        ovalid = (j2 < full * N) & (j2 < total)
        if has_agg:
            # an aggregated batch collapses to one row, its last slot
            ovalid = ovalid & (j2 % N == N - 1)
        carry(total - full * N, full * N, zts, tails)
        count = full * N
    else:
        # padding slots carry +inf timestamps; out-of-order arrivals are
        # clamped to the running max (counted)
        zts = zc(state["rem_ts"], cts_pos, TS_POS)
        zts_m = torch.cummax(zts, 0).values
        regressions = ((zts_m > zts) & (j2 < total)).sum()
        last_idx = min(max(total - 1, 0), M - 1)
        if kind == "timeBatch":
            armed = bool(state["batch_base"] > TS_NEG)
            base = state["batch_base"] if armed else zts_m[0]
            seg = torch.div(zts_m - base, q.window_ms, rounding_mode="floor")
            ovalid = (j2 < total) & (seg < seg[last_idx])
            if has_agg:
                nxt = torch.clamp(j2 + 1, 0, M - 1)
                ovalid = ovalid & ((j2 + 1 >= total) | (seg[nxt] != seg))
            if total > 0:
                new_state["batch_base"] = base.clone()
        else:                                   # session
            prev = torch.cat([zts_m[:1], zts_m[:-1]])
            # a gap of exactly the parameter closes the session
            brk = (zts_m - prev) >= q.window_ms
            brk[0] = False
            seg = torch.cumsum(brk.to(i64), 0)
            ovalid = (j2 >= r) & (j2 < total)  # currents pass through once
        open_count = int(((j2 < total) & (seg == seg[last_idx])).sum())
        rem_n = min(open_count, N)
        new_state["window_drops"] = state["window_drops"] + (open_count - rem_n)
        new_state["ts_regressions"] = state["ts_regressions"] + regressions
        # the carried clock is the monotonised one; rows keep their own
        carry(rem_n, max(total - rem_n, 0), zts_m, tails)
        lo = torch.searchsorted(seg, seg, right=False)
        count = int(ovalid.sum())
        cnts = None
    sums_f = _range_sums(z_f, lo, j2)
    sums_i = _range_sums(z_i, lo, j2)
    if cnts is None:
        cso = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                         torch.cumsum(zo.to(i64), 0)])
        cnts = cso[j2 + 1] - cso[lo]
    mins = {i: _range_reduce(zm[i], lo, j2, m_ismin[i]) for i in q.magg_idx}
    svars = _window_svars(z_s, zo, lo, j2, cnts, M)
    return finish(new_state, sums_f, sums_i, cnts, mins, svars, ovalid=ovalid,
                  count=count, ots=zts, proj=zproj)


def _hopping_step(q, state, k, lanes, wts, m_ismin, finish):
    """``hopping(D, H)``: every H ms one row over the events of the last D
    ms before the boundary. The f-th flush slot of the step (F = B) reads
    its bucket (t_f - D, t_f) as range reductions over [tail (N) | batch];
    boundaries past F fire on the next step (``hop_next`` advances only by
    the processed count), empty buckets emit nothing."""
    av_f, av_i, av_s, av_m, ones_c, proj_c = lanes
    B, N, D, H = q.B, max(q.window_n, 1), q.window_ms, q.hop_ms
    dev = wts.device
    i64 = torch.int64
    F = B
    ar = torch.arange(B, device=dev)
    valid = ar < k
    raw = torch.where(valid, wts, TS_POS)
    mono = torch.maximum(torch.cummax(raw, 0).values, state["last_ts"])
    regressed = (valid & (raw < mono)).sum()
    wts_s = torch.where(valid, mono, TS_POS)
    zts = torch.cat([state["tail_ts"], wts_s])
    zo = torch.cat([state["tail_ones"], ones_c])
    z_f = torch.cat([state["tail_fvals"], av_f], 1)
    z_i = torch.cat([state["tail_ivals"], av_i], 1)
    z_s = torch.cat([state["tail_svals"], av_s], 1)
    zm = {i: torch.cat([state[f"tail_m{i}"], av_m[i]]) for i in q.magg_idx}
    zproj = {i: torch.cat([state[f"tail_proj_{i}"], proj_c[i]])
             for i in q.value_idx}

    newest = zts[N + k - 1] if k > 0 else state["last_ts"]
    armed = bool(state["hop_next"] > TS_NEG)
    # unarmed: the tail is empty and the first real event sits at slot N
    b0 = state["hop_next"] if armed else zts[N] + H
    has_any = armed or k > 0
    n_flush = int(torch.div(newest - b0, H, rounding_mode="floor")) + 1 \
        if has_any and bool(newest >= b0) else 0
    n_flush = min(n_flush, F)
    f = torch.arange(F, device=dev)
    t_f = b0 + f.to(i64) * H
    lo = torch.searchsorted(zts, t_f - D, right=True)
    hi = torch.searchsorted(zts, t_f, right=False) - 1
    hi = torch.maximum(hi, lo - 1)              # empty bucket: zero range
    sums_f = _range_sums(z_f, lo, hi)
    sums_i = _range_sums(z_i, lo, hi)
    cso = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                     torch.cumsum(zo.to(i64), 0)])
    cnts = cso[hi + 1] - cso[lo]
    mins = {i: _range_reduce(zm[i], lo, hi, m_ismin[i]) for i in q.magg_idx}
    svars = _window_svars(z_s, zo, lo, hi, cnts, F)
    # a collapsed row's non-aggregate columns read the bucket's last event
    proj = {i: z[torch.clamp(hi, 0, N + B - 1)] for i, z in zproj.items()}
    ovalid = (f < n_flush) & (cnts > 0)

    live_cut = b0 + (n_flush - 1) * H - D if n_flush > 0 else \
        torch.tensor(TS_NEG, dtype=i64, device=dev)
    sliced = torch.arange(N + B, device=dev) < k   # pushed out by the slide
    drops = torch.where(sliced & (zts > live_cut), zo, 0).sum()
    new_state = dict(state)
    new_state.update({
        "tail_fvals": z_f[:, k:k + N], "tail_ivals": z_i[:, k:k + N],
        "tail_svals": z_s[:, k:k + N], "tail_ones": zo[k:k + N],
        "tail_ts": zts[k:k + N],
        "hop_next": (b0 + n_flush * H) if n_flush > 0 else
        (b0 if has_any else torch.tensor(TS_NEG, dtype=i64, device=dev)),
        "window_drops": state["window_drops"] + drops,
        "last_ts": torch.maximum(state["last_ts"], newest),
        "ts_regressions": state["ts_regressions"] + regressed,
    })
    for i, z in zm.items():
        new_state[f"tail_m{i}"] = z[k:k + N]
    for i, z in zproj.items():
        new_state[f"tail_proj_{i}"] = z[k:k + N]
    return finish(new_state, sums_f, sums_i, cnts, mins, svars, ovalid=ovalid,
                  count=int(ovalid.sum()), ots=t_f, proj=proj)


def _sum32(x: torch.Tensor, extra) -> torch.Tensor:
    """float32 ``sum(x) + extra`` accumulated in float64, rounded once."""
    return (x.double().sum(-1) + extra.double()).float()


def _total_order(x: torch.Tensor) -> torch.Tensor:
    """int64 keys in XLA's total order of ``x``: for floats -0 equals +0 and
    every NaN sorts after +inf (the order of the reference's
    ``searchsorted``); integers keep their values."""
    if not x.is_floating_point():
        return x.to(torch.int64)
    bits = torch.where(x == 0, torch.zeros_like(x), x).view(torch.int32)
    bits = torch.where(torch.isnan(x), 0x7FC00000, bits).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _search_right(keys: list, key: int) -> int:
    """``jnp.searchsorted(keys, key, side="right")`` as the reference runs it
    (total-order keys): ``bit_length(N)`` halvings of ``[0, N)``, going left
    where ``key`` sorts strictly before the probed slot. On a buffer that NaN
    keys leave out of order it lands where that search lands."""
    lo, hi = 0, len(keys)
    for _ in range(len(keys).bit_length()):
        mid = (lo + hi) // 2
        if key < keys[mid]:
            hi = mid
        else:
            lo = mid
    return hi


def _sort_walk(q, state, k, skey, av_f, av_i, av_s, av_m, m_ismin, m_ident):
    """``sort(N, key[, order])``: a carried buffer of the N best keys, kept
    sorted, with aligned aggregate lanes, walked event by event. Each event
    first emits the aggregates over the buffer plus itself (the row still
    includes the value about to be evicted), then, if accepted, inserts at
    ``min(searchsorted(keys, key, right), n)`` (stable after equal keys;
    ``_search_right``)
    and slot N - 1 falls off. Events past the accepted count emit over the
    buffer plus their fill values."""
    B, N = q.B, max(q.window_n, 1)
    dev = skey.device
    keys = state["sort_keys"].clone()
    n = int(state["sort_n"])
    lanes = {"f": state["sort_fvals"].clone(), "i": state["sort_ivals"].clone(),
             "s": state["sort_svals"].clone()}
    for i in q.magg_idx:
        lanes[f"m{i}"] = state[f"sort_m{i}"].clone()
    AF, AI, AS = av_f.shape[0], av_i.shape[0], av_s.shape[0]
    sums_f = torch.zeros((AF, B), dtype=FACC, device=dev)
    sums_i = torch.zeros((AI, B), dtype=IACC, device=dev)
    svars = torch.zeros((AS, B), dtype=FACC, device=dev)
    cnts = torch.zeros(B, dtype=torch.int64, device=dev)
    mins = {i: torch.zeros(B, dtype=av_m[i].dtype, device=dev)
            for i in q.magg_idx}

    def emit(b):
        """The outputs of event b over the buffer (first n slots) + b."""
        sums_f[:, b] = _sum32(lanes["f"][:, :n], av_f[:, b])
        sums_i[:, b] = lanes["i"][:, :n].sum(1) + av_i[:, b]
        cnt = n + 1
        cnts[b] = cnt
        for i in q.magg_idx:
            red = torch.amin if m_ismin[i] else torch.amax
            both = torch.cat([lanes[f"m{i}"][:n], av_m[i][b:b + 1]])
            mins[i][b] = red(both)
        nf = torch.tensor(float(cnt), dtype=FACC, device=dev)
        for si in range(AS):
            v, x = lanes["s"][si, :n], av_s[si, b]
            c = _sum32(v, x) / nf
            d, dx = v - c, x - c
            s1 = _sum32(d, dx) / nf
            s2 = _sum32(d * d, dx * dx) / nf
            svars[si, b] = _sqrt32(torch.clamp(s2 - s1 * s1, min=0.0))

    def insert(row, pos, v):
        if pos < N:
            row[..., pos + 1:] = row[..., pos:N - 1].clone()
            row[..., pos] = v

    korder = _total_order(skey).tolist()
    for b in range(k):
        emit(b)
        pos = min(_search_right(_total_order(keys).tolist(), korder[b]), n)
        insert(keys, pos, skey[b])
        insert(lanes["f"], pos, av_f[:, b])
        insert(lanes["i"], pos, av_i[:, b])
        insert(lanes["s"], pos, av_s[:, b])
        for i in q.magg_idx:
            insert(lanes[f"m{i}"], pos, av_m[i][b])
        n = min(n + 1, N)
    if k < B:
        # every unaccepted slot sees the same buffer and the same fills
        emit(k)
        for t in (sums_f, sums_i, svars, cnts, *mins.values()):
            t[..., k + 1:] = t[..., k:k + 1].clone()
    new_state = dict(state)
    new_state.update({"sort_keys": keys,
                      "sort_n": torch.tensor(n, dtype=torch.int32, device=dev),
                      "sort_fvals": lanes["f"], "sort_ivals": lanes["i"],
                      "sort_svals": lanes["s"]})
    for i in q.magg_idx:
        new_state[f"sort_m{i}"] = lanes[f"m{i}"]
    return new_state, sums_f, sums_i, cnts, mins, svars


def _first(x: torch.Tensor) -> int:
    """Index of the first true entry (0 when none, as argmax gives)."""
    return int(torch.argmax(x.to(torch.int8)))


def _heavy_hitters(q, state, k, kcode, av_f, av_i):
    """``frequent`` (Misra-Gries) and ``lossyFrequent`` (lossy counting): a
    carried [C]-slot key/counter table walked event by event. An emitted
    event adds its values to the running aggregates; an eviction or prune
    retracts the evicted key's last values. ``frequent`` retracts before
    the arrival adds (its row sees the post-eviction sums); the lossy
    window emits first and prunes after, retracting the post-update lanes.
    A slot is chosen as the first hit, else the first free slot."""
    lossy = q.window_kind == "lossyFrequent"
    B = q.B
    dev = kcode.device
    keys, counts = state["hh_keys"].clone(), state["hh_counts"].clone()
    f, iv = state["hh_fvals"].clone(), state["hh_ivals"].clone()
    run_f, run_i = state["hh_run_f"].clone(), state["hh_run_i"].clone()
    run_cnt = int(state["hh_run_cnt"])
    if lossy:
        delta = state["hh_delta"].clone()
        total, drops = int(state["hh_total"]), int(state["window_drops"])
    AF, AI = av_f.shape[0], av_i.shape[0]
    emit_out = torch.zeros(B, dtype=torch.bool, device=dev)
    ys_f = torch.zeros((AF, B), dtype=FACC, device=dev)
    ys_i = torch.zeros((AI, B), dtype=IACC, device=dev)
    ys_c = torch.zeros(B, dtype=torch.int64, device=dev)
    zero_f = torch.zeros(AF, dtype=FACC, device=dev)
    zero_i = torch.zeros(AI, dtype=IACC, device=dev)
    for b in range(min(k + 1, B)):
        accept = b < k
        vf, vi = av_f[:, b], av_i[:, b]
        evicted = None
        emit = False
        if accept:
            key = kcode[b]
            occ = counts > 0
            hit = occ & (keys == key)
            has, has_space = bool(hit.any()), bool((~occ).any())
            insert = not has and has_space
            idx = _first(hit) if has else _first(~occ)
            upd = has or insert
            if has:
                counts = torch.where(hit, counts + 1, counts)
            if insert:
                counts[idx] = 1
            if not lossy:
                emit = upd
                if not has and not has_space:       # decrement-all
                    dec = torch.clamp(counts - 1, min=0)
                    evicted = occ & (dec == 0)
                    counts = torch.where(occ, dec, counts)
                    if bool(evicted.any()):
                        idx = _first(evicted)
                        counts[idx] = 1
                        upd = emit = True
            else:
                total += 1
                bucket = int(float(total) * q.lossy_error) + 1
                if not has and not has_space:
                    drops += 1
                if insert:
                    delta[idx] = bucket - 1
                emit = upd and float(int(counts[idx]) + int(delta[idx])) \
                    >= float(total) * q.lossy_support
                # prune after the emission decision: every entry with
                # f + delta <= bucket - 1, the one just updated included
                low = (counts + delta) <= bucket - 1
                evicted = occ & low
                if upd:
                    evicted[idx] = low[idx]
                counts = torch.where(evicted, 0, counts)
        old_f, old_i = f, iv
        if accept and upd:
            f, iv = f.clone(), iv.clone()
            f[:, idx], iv[:, idx] = vf, vi
            keys[idx] = kcode[b]
        n_ev = 0 if evicted is None else int(evicted.sum())

        def retract(lf, li):
            if evicted is None:
                return zero_f, zero_i
            return (torch.where(evicted, lf, 0.0).double().sum(1).float(),
                    torch.where(evicted, li, 0).sum(1))

        add_f = vf if emit else zero_f
        add_i = vi if emit else zero_i
        if not lossy:
            rf, ri = retract(old_f, old_i)
            run_f = (run_f - rf) + add_f
            run_i = (run_i - ri) + add_i
            run_cnt = run_cnt - n_ev + int(emit)
            ys_f[:, b], ys_i[:, b], ys_c[b] = run_f, run_i, run_cnt
        else:
            run_f = run_f + add_f
            run_i = run_i + add_i
            run_cnt += int(emit)
            ys_f[:, b], ys_i[:, b], ys_c[b] = run_f, run_i, run_cnt
            rf, ri = retract(f, iv)
            run_f = run_f - rf
            run_i = run_i - ri
            run_cnt -= n_ev
        emit_out[b] = emit
    if k + 1 < B:
        # every later slot sees the same sums (nothing is accepted there)
        for t in (ys_f, ys_i, ys_c):
            t[..., k + 1:] = t[..., k:k + 1].clone()
    new_state = dict(state)
    new_state.update({"hh_keys": keys, "hh_counts": counts, "hh_fvals": f,
                      "hh_ivals": iv, "hh_run_f": run_f, "hh_run_i": run_i,
                      "hh_run_cnt": torch.tensor(run_cnt, dtype=torch.int64,
                                                 device=dev)})
    if lossy:
        new_state.update({
            "hh_delta": delta,
            "hh_total": torch.tensor(total, dtype=torch.int64, device=dev),
            "window_drops": torch.tensor(drops, dtype=torch.int64, device=dev)})
    return new_state, emit_out, ys_f, ys_i, ys_c


def _keyed_range_sums(z, zk, K, lo, j, keys_b):
    """Per-key sums of z [A, M] over inclusive ranges [lo, j]: one-hot
    [M, K] prefix grid per lane; output b reads its own bucket column at
    both range bounds. The grid selects rather than multiplies: XLA folds
    the reference's ``one_hot(zk) * z`` into a select, so a non-finite
    value stays in its own key's sums (the unwindowed ``_grouped``'s
    products do not fold, and poison every key)."""
    A = z.shape[0]
    if not A:
        return torch.zeros((0, j.shape[0]), dtype=z.dtype, device=z.device)
    oh = F.one_hot(zk.long(), K).bool()                       # [M, K]
    kb = keys_b.long()
    zero = torch.zeros((1, K), dtype=z.dtype, device=z.device)
    outs = []
    for a in range(A):
        grid = torch.where(oh, z[a][:, None], torch.zeros((), dtype=z.dtype,
                                                          device=z.device))
        cs = torch.cat([zero, _cumsum(grid, 0).to(z.dtype)])
        outs.append(cs[j + 1, kb] - cs[lo, kb])
    return torch.stack(outs)


def _collisions(state, new_state, keys, packed, out_valid, K):
    """Bucket ownership: a bucket's owner is its carried claimant or, if
    unowned, the first valid claimant of this batch; a valid event whose
    packed key differs from its bucket's owner is a collision (counted)."""
    onehot = F.one_hot(keys.long(), K).to(torch.int32) * \
        out_valid[:, None].to(torch.int32)
    first_occ = (torch.cumsum(onehot, 0) == 1) & onehot.bool()
    batch_first = torch.where(first_occ, packed[:, None], 0).sum(0)
    owned = state["key_owned"]
    claimed = torch.where(owned, state["key_owner"], batch_first)
    coll = out_valid & (packed != claimed[keys.long()])
    new_state["key_owner"] = claimed
    new_state["key_owned"] = owned | first_occ.any(0)
    new_state["group_collisions"] = state["group_collisions"] + \
        coll.to(torch.int64).sum()
    return onehot, first_occ


def _grouped(q, state, keys_packed, out_valid, av_f, av_i, av_s, av_m,
             m_ismin, m_ident):
    """Unwindowed group-by: per-event per-key prefixes within the batch
    plus the carried dense per-key tables."""
    keys, packed = keys_packed
    K, B = q.K, q.B
    dev = keys.device
    kl = keys.long()
    new_state = dict(state)
    onehot, first_occ = _collisions(state, new_state, keys, packed,
                                    out_valid, K)                # [B, K]

    def per_key(av, base):
        if not av.shape[0]:
            return (torch.zeros((0, B), dtype=av.dtype, device=dev),
                    torch.zeros((0, K), dtype=av.dtype, device=dev))
        contrib = onehot[None].to(av.dtype) * av[:, :, None]   # [A, B, K]
        ccum = _cumsum(contrib, 1).to(av.dtype)
        per_ev = torch.take_along_dim(
            ccum, kl[None, :, None].expand(av.shape[0], B, 1), 2)[:, :, 0] \
            + base[:, kl]
        return per_ev, _fsum(contrib, 1).to(av.dtype)

    sums_f, add_f = per_key(av_f, state["key_fsums"])
    sums_i, add_i = per_key(av_i, state["key_isums"])
    ocum = torch.cumsum(onehot, 0)
    cnts = ocum[torch.arange(B, device=dev), kl].to(torch.int64) + \
        state["key_counts"][kl]
    nf, nc = _kahan_add(state["key_fsums"], state["key_fcomp"], add_f)
    new_state.update({"key_fsums": nf, "key_fcomp": nc,
                      "key_isums": state["key_isums"] + add_i,
                      "key_counts": state["key_counts"]
                      + onehot.sum(0).to(torch.int64)})

    # min/max per key: cumulative reduction over one-hot grids
    mins = {}
    for i in q.magg_idx:
        grid = torch.where(onehot.bool(), av_m[i][:, None],
                           torch.tensor(m_ident[i], dtype=av_m[i].dtype,
                                        device=dev))
        g = (torch.cummin if m_ismin[i] else torch.cummax)(grid, 0).values
        red = torch.minimum if m_ismin[i] else torch.maximum
        per_ev = g[torch.arange(B, device=dev), kl]
        mins[i] = red(per_ev, state[f"key_m{i}"][kl])
        new_state[f"key_m{i}"] = red(state[f"key_m{i}"], g[-1])

    # stdDev per key: shifted moments centred at the key's carried mean
    # (Welford merged at batch granularity)
    AS = len(q.sagg_idx)
    svars = torch.zeros((AS, B), dtype=FACC, device=dev)
    smean, sm2, scnt = (state["key_smean"].clone(), state["key_sm2"].clone(),
                        state["key_scnt"].clone())
    rows = torch.arange(B, device=dev)
    for si in range(AS):
        firstval = torch.where(first_occ, av_s[si][:, None], 0.0).sum(0)
        c_key = torch.where(state["key_scnt"][si] > 0,
                            state["key_smean"][si], firstval)       # [K]
        c_ev = c_key[kl]
        d = (av_s[si] - c_ev) * onehot.sum(1).to(FACC)
        d2 = d * d
        cs1 = _cumsum(onehot.to(FACC) * d[:, None], 0)
        cs2 = _cumsum(onehot.to(FACC) * d2[:, None], 0)
        s1, s2 = cs1[rows, kl], cs2[rows, kl]
        m2p = state["key_sm2"][si][kl]
        nsc = state["key_scnt"][si][kl] + ocum[rows, kl].to(FACC)
        var = torch.clamp(
            (m2p + s2) / torch.clamp(nsc, min=1.0)
            - _sq(s1 / torch.clamp(nsc, min=1.0)), min=0.0)
        svars[si] = _sqrt32(var)
        add1, add2 = cs1[-1], cs2[-1]
        addn = onehot.sum(0).to(FACC)
        n_new = state["key_scnt"][si] + addn
        mean_new = c_key + add1 / torch.clamp(n_new, min=1.0)
        m2_new = state["key_sm2"][si] + add2 - \
            torch.clamp(n_new, min=1.0) * _sq(mean_new - c_key)
        smean[si], sm2[si], scnt[si] = mean_new, torch.clamp(m2_new, min=0.0), n_new
    new_state.update({"key_smean": smean, "key_sm2": sm2, "key_scnt": scnt})
    return new_state, sums_f, sums_i, cnts, mins, svars
