"""Compiled NFA on the card: wire batches, the device plan, decode, runtime.

Port of the reference's ``tpu/nfa.py``. The compile pass is the
reference's: flatten the state tree (``core/pattern.py``), validate it
against what the device kernels implement (the same checks, with the same
messages, so exactly the same apps raise ``DeviceCompileError``), lower each
state's filter and each output to a torch closure plus kernel IR
(``expr_compile``), and record the bound values later states and outputs
reference, with the null-validity flags of ``e[k]`` occurrences, OR sides,
absent branches and zero-min counts. Two step shapes:

- a chain of stream states whose first state carries ``every`` takes the
  blocked kernel (``nfa_block``);
- every other shape (count, logical, absent states, sequences, group and
  mid-pattern ``every``) takes the per-event scan (``nfa_scan``).

Wire format (unchanged from the reference): ``{"cols": {key: [B]}, "tag":
int8 [B], "ts": int32 [B] deltas, "ts_base": int64, "count": int}``, with
validity the prefix ``[0, count)``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.pattern import CompiledPattern, PatternCompiler
from ..flow.adaptive_batch import AdaptiveFlushMixin
from ..query_api import Query, StateInputStream, Variable
from ..query_api.definition import DataType, StreamDefinition
from .backend import resolve_device
from .batch import StringDictionary
from .dtypes import NP as _NP
from .expr_compile import (
    OP,
    T_BOOL,
    DeviceCompileError,
    as_tensor,
    compile_expression,
    ir_result_type,
)

# Highest statically-referenced occurrence index `e[k]` a count state carries
# on device (each referenced k costs one bound column + set flag per slot);
# larger indexes take the host path, as in the reference.
_MAX_OCC_INDEX = 15


def _occ_flag(q: int, k: int) -> str:
    """Bound flag for occurrence k of count state q ("flag" appended to the
    digits with no '#', so it can't collide with a value key's '#attr')."""
    return f"b{q}#occ{k}flag"


def _has_flag(q: int) -> str:
    """"at least one occurrence" flag for a zero-min count state."""
    return f"b{q}#has"


# ---------------------------------------------------------------------------
# merged multi-stream batches
# ---------------------------------------------------------------------------

class MergedBatchSchema:
    """Union columns over the pattern's streams + a stream tag per event."""

    def __init__(self, stream_defs: dict[str, StreamDefinition], stream_ids: list[str]):
        self.stream_ids = stream_ids
        self.stream_index = {sid: i for i, sid in enumerate(stream_ids)}
        self.columns: dict[str, DataType] = {}       # "s{i}_{attr}" -> dtype
        # ONE dictionary shared by every string column: cross-column equality
        # (`e2.sym == e1.sym` across streams) must compare comparable codes
        shared = StringDictionary()
        self.dictionaries: dict[str, StringDictionary] = {}
        for i, sid in enumerate(stream_ids):
            d = stream_defs[sid]
            for a in d.attributes:
                key = f"s{i}_{a.name}"
                self.columns[key] = a.type
                if a.type == DataType.STRING:
                    self.dictionaries[key] = shared

    def col_key(self, stream_id: str, attr: str) -> str:
        return f"s{self.stream_index[stream_id]}_{attr}"

    def snapshot_dictionaries(self) -> dict:
        from .batch import snapshot_dictionaries
        return snapshot_dictionaries(self.dictionaries)

    def restore_dictionaries(self, snap: dict) -> None:
        from .batch import restore_dictionaries
        restore_dictionaries(self.dictionaries, snap)


class MergedBatchBuilder:
    """Stages events and emits device micro-batches in the wire format.

    Only columns in ``used_cols`` (those the compiled program reads) are
    staged; timestamps travel as int32 deltas against the batch minimum;
    validity is the prefix ``[0, count)``. Values past ``count`` are stale
    leftovers of earlier batches, exactly as in the reference."""

    def __init__(self, schema: MergedBatchSchema, capacity: int,
                 stream_defs: dict[str, StreamDefinition],
                 used_cols: Optional[set] = None):
        self.schema = schema
        self.capacity = capacity
        self.stream_defs = stream_defs
        keys = schema.columns.keys() if used_cols is None \
            else [k for k in schema.columns if k in used_cols]
        self._cols = {
            key: np.zeros(capacity, dtype=_NP[schema.columns[key]])
            for key in keys
        }
        self._tag = np.zeros(capacity, dtype=np.int8)
        self._ts = np.zeros(capacity, dtype=np.int64)
        self._n = 0
        self.ts_clamped = 0        # events whose in-batch ts delta overflowed
        # wall clock of the first append since the last emit: the flush
        # deadline's start (a restore re-arms it)
        self._pack_t0 = None

    def __len__(self):
        return self._n

    @property
    def full(self) -> bool:
        return self._n >= self.capacity

    def append(self, stream_id: str, row: list, ts: int) -> None:
        i = self._n
        if self._pack_t0 is None:
            self._pack_t0 = time.perf_counter()
        si = self.schema.stream_index[stream_id]
        d = self.stream_defs[stream_id]
        for a, v in zip(d.attributes, row):
            key = f"s{si}_{a.name}"
            col = self._cols.get(key)
            if col is None:
                continue               # column unused by the compiled program
            if a.type == DataType.STRING:
                v = self.schema.dictionaries[key].encode(v)
            col[i] = 0 if v is None else v
        self._tag[i] = si
        self._ts[i] = ts
        self._n += 1

    def append_many(self, stream_id: str, attr_cols: dict, ts,
                    start: int = 0) -> int:
        """Bulk-append pre-encoded column arrays (string columns already
        dictionary codes). Copies rows ``[start, start+take)`` where
        ``take`` fits the remaining capacity; returns ``take``."""
        n_rows = len(ts) - start
        take = min(n_rows, self.capacity - self._n)
        if take <= 0:
            return 0
        if self._pack_t0 is None:
            self._pack_t0 = time.perf_counter()
        i = self._n
        si = self.schema.stream_index[stream_id]
        d = self.stream_defs[stream_id]
        for a in d.attributes:
            key = f"s{si}_{a.name}"
            col = self._cols.get(key)
            src = attr_cols.get(a.name)
            if col is None or src is None:
                continue
            col[i:i + take] = src[start:start + take]
        self._tag[i:i + take] = si
        self._ts[i:i + take] = np.asarray(ts)[start:start + take]
        self._n += take
        return take

    def emit(self) -> dict:
        """The wire batch plus the reference's bookkeeping keys: the last
        event's ts (``last_ts``, the engine stamps outputs with it), the
        pack span since the first append (``pack_s``), the copy's own time
        (``pack_exec_s``) and the emit instant (``_t_emit``)."""
        t_emit0 = time.perf_counter()
        n = self._n
        base = int(self._ts[:n].min()) if n else 0
        deltas = self._ts - base
        deltas[n:] = 0
        if n and deltas[:n].max() > 2**31 - 1:
            # an in-batch event-time span over ~24.8 days: clamp + count
            self.ts_clamped += int(np.sum(deltas[:n] > 2**31 - 1))
            log = __import__("logging").getLogger("siddhi_tpu_torch.device")
            log.warning("batch ts span exceeds int32 ms; %d clamped",
                        self.ts_clamped)
            np.clip(deltas, 0, 2**31 - 1, out=deltas)
        out = {
            "cols": {k: v.copy() for k, v in self._cols.items()},
            "tag": self._tag.copy(),
            "ts": deltas.astype(np.int32),
            "ts_base": np.int64(base),
            "count": n,
            "last_ts": int(self._ts[n - 1]) if n else 0,
            "pack_s": (t_emit0 - self._pack_t0
                       if self._pack_t0 is not None else 0.0),
        }
        t_emit = time.perf_counter()
        out["pack_exec_s"] = t_emit - t_emit0
        out["_t_emit"] = t_emit
        self._n = 0
        self._pack_t0 = None
        return out

    def snapshot(self) -> dict:
        """Staged but unemitted rows (a checkpoint between two steps)."""
        n = self._n
        return {
            "cols": {k: v[:n].copy() for k, v in self._cols.items()},
            "tag": self._tag[:n].copy(),
            "ts": self._ts[:n].copy(),
            "n": n,
        }

    def restore(self, snap: dict) -> None:
        n = snap["n"]
        self._n = n
        for k, v in snap["cols"].items():
            self._cols[k][:n] = v
        self._tag[:n] = snap["tag"]
        self._ts[:n] = snap["ts"]
        if n:                   # restored rows re-arm the flush deadline
            self._pack_t0 = time.perf_counter()


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

@dataclass
class _DevBranch:
    stream_idx: int
    alias: str
    predicate: Optional[Callable] = None   # torch closure fn(env) -> bool
    predicate_ir: Optional[list] = None    # the same program as kernel IR
    is_absent: bool = False


@dataclass
class _DevState:
    index: int
    kind: str                    # 'stream' | 'count' | 'logical' | 'absent'
    branches: "list[_DevBranch]"
    logical_type: Optional[str] = None     # 'and' | 'or'
    waiting_ms: Optional[int] = None       # absent `for`
    min_count: int = 1
    max_count: int = 1
    ends_every: bool = False     # reseed scope [0..index]
    within_ms: Optional[int] = None        # element-level within
    reseed_to: Optional[int] = None        # every-scope start this state ends

    # single-branch conveniences (stream/count states)
    @property
    def stream_idx(self) -> int:
        return self.branches[0].stream_idx

    @property
    def alias(self) -> str:
        return self.branches[0].alias

    @property
    def predicate(self):
        return self.branches[0].predicate

    @property
    def predicate_ir(self):
        return self.branches[0].predicate_ir


class _NFAResolver:
    """Resolves Variables inside predicates/output of the device NFA.

    Namespace env keys:
      ``ev_{attr-key}``    — candidate event value (merged column key)
      ``b{q}_{attr}``      — bound value of prior state q
      ``b{q}x{bi}_{attr}`` — bound value of branch bi of logical state q
      ``b{q}#first#{attr}`` / ``b{q}#last#{attr}`` / ``b{q}#occ{k}#{attr}``
                           — count-state variants
    """

    def __init__(self, nfa: "DeviceNFACompiler", current_state: Optional[int],
                 current_alias: Optional[str] = None):
        self.nfa = nfa
        self.current = current_state
        self.current_alias = current_alias
        self.touched: list = []        # (state, variant) bound refs resolved
        # the columnar host tier's closures (host policy, no IR)
        self.host = getattr(nfa, "host", False)

    def resolve(self, var: Variable) -> tuple[str, DataType]:
        nfa = self.nfa
        alias = var.stream_id
        cur = nfa.states[self.current] if self.current is not None else None
        cur_aliases = [b.alias for b in cur.branches] if cur is not None else []
        if alias is None or (cur is not None and alias in cur_aliases):
            # candidate-event reference: the state currently being matched.
            # A logical branch predicate only sees its own event — sibling
            # references need the host path (unbound-side semantics).
            if cur is None:
                raise DeviceCompileError("bare attribute outside a state context")
            a = alias or self.current_alias or cur.branches[0].alias
            if self.current_alias is not None and a != self.current_alias:
                raise DeviceCompileError(
                    "sibling alias reference inside a logical state needs "
                    "the host path")
            sid = nfa.compiled.alias_defs[a].id
            key = nfa.merged.col_key(sid, var.attribute)
            if var.attribute not in nfa.compiled.alias_defs[a].attribute_names:
                raise DeviceCompileError(f"unknown attribute '{var.attribute}'")
            nfa.used_ev_cols.add(key)
            return f"ev_{key}", nfa.merged.columns[key]
        if alias not in nfa.alias_branch:
            raise DeviceCompileError(f"unknown alias '{alias}'")
        q, bi = nfa.alias_branch[alias]
        d = nfa.compiled.alias_defs[alias]
        if var.attribute not in d.attribute_names:
            raise DeviceCompileError(f"unknown attribute '{var.attribute}'")
        t = d.attribute_type(var.attribute)
        from ..query_api.expression import LAST_INDEX
        if nfa.states[q].kind == "count":
            # count variants use '#' separators — '#' cannot occur in an
            # attribute identifier, so names like "occupancy" or "last_x"
            # can never collide with the variant markers
            if var.stream_index == 0:
                variant = f"b{q}#first#{var.attribute}"
            elif var.stream_index in (None, LAST_INDEX):
                variant = f"b{q}#last#{var.attribute}"
            else:
                # e2[k]: one bound column per statically-referenced
                # occurrence index, plus a set flag for NULL when the count
                # never reached k+1
                k = var.stream_index
                if not isinstance(k, int) or k < 0 or k > _MAX_OCC_INDEX:
                    raise DeviceCompileError(
                        f"count e[k] index {k!r} out of device range "
                        f"(0..{_MAX_OCC_INDEX})")
                variant = f"b{q}#occ{k}#{var.attribute}"
                nfa.referenced.add((q, _occ_flag(q, k), DataType.BOOL))
        elif nfa.states[q].kind == "logical":
            variant = f"b{q}x{bi}_{var.attribute}"
        else:
            if var.stream_index not in (None, 0, LAST_INDEX):
                raise DeviceCompileError("e[k] indexing needs host path")
            variant = f"b{q}_{var.attribute}"
        nfa.referenced.add((q, variant, t))
        self.touched.append((q, variant))
        return variant, t

    def param_key(self, p) -> str:
        # fleet per-tenant parameter slots ride the event-column namespace
        # (every cols entry is ev_-prefixed in the step env); they are
        # injected at step time, never staged, so they are not used_ev_cols:
        # the kernel plans read them as event columns (``param_cols``)
        self.nfa.param_cols[p.key] = p.type
        return f"ev_{p.key}"

    def encode_string(self, key: str, value: str) -> int:
        mk = key[3:] if key.startswith("ev_") else self._bound_to_merged(key)
        dic = self.nfa.merged.dictionaries.get(mk)
        if dic is None:
            raise DeviceCompileError(f"no dictionary for '{key}'")
        return dic.encode(value)

    def _bound_to_merged(self, key: str) -> str:
        # b{q}x{bi}_{attr} | b{q}_{attr} | b{q}#first|last|occ{k}#{attr}
        body = key[1:]
        if "#" in body:                             # count variant
            q_str, rest = body.split("#", 1)
            if rest.startswith("first#"):
                rest = rest[len("first#"):]
            elif rest.startswith("last#"):
                rest = rest[len("last#"):]
            elif rest.startswith("occ"):            # occ{k}#{attr}
                rest = rest.split("#", 1)[1]
            alias = self.nfa.states[int(q_str)].alias
            sid = self.nfa.compiled.alias_defs[alias].id
            return self.nfa.merged.col_key(sid, rest)
        q_str, rest = body.split("_", 1)
        if "x" in q_str:
            q_part, bi_part = q_str.split("x")
            alias = self.nfa.states[int(q_part)].branches[int(bi_part)].alias
        else:
            alias = self.nfa.states[int(q_str)].alias
        sid = self.nfa.compiled.alias_defs[alias].id
        return self.nfa.merged.col_key(sid, rest)


def _null_strict(e) -> bool:
    """True if a NULL input anywhere makes the whole expression falsy —
    i.e. the expression is built only of comparisons/math/AND over
    variables and constants (host executors propagate null through math
    and evaluate null comparisons/conjunctions to false)."""
    from ..query_api.expression import (
        And,
        Compare,
        Constant,
        MathExpr,
        Minus,
        Variable,
    )
    if isinstance(e, (Variable, Constant)):
        return True
    if isinstance(e, (Compare, And, MathExpr)):
        return _null_strict(e.left) and _null_strict(e.right)
    if isinstance(e, Minus):
        return _null_strict(e.expr)
    return False


def is_flag_key(q: int, key: str) -> bool:
    """Synthetic null-tracking flags (no merged column behind them)."""
    return key.endswith("__set") or key == _has_flag(q) or \
        (key.startswith(f"b{q}#occ") and key.endswith("flag")
         and "#" not in key[len(f"b{q}#occ"):])


class DeviceNFACompiler:
    """Device plan for a pattern/sequence query.

    ``device`` follows ``backend.resolve_device``: the card unless the
    caller passes ``"cpu"``; with no card and no explicit ``"cpu"`` the
    constructor raises.

    ``host=True`` (the reference's ``backend="numpy"``) compiles the SAME
    plan (states, predicates, output programs) for the columnar host tier
    (``host_exec.HostBlockNFA``): host-policy closures, no IR, no kernel
    plan and no device. That tier covers the blocked shape only; any other
    raises the reference's message."""

    def __init__(self, query: Query, stream_defs: dict[str, StreamDefinition],
                 slot_capacity: int = 64, batch_capacity: int = 1024,
                 creation_cap: Optional[int] = None, device=None,
                 host: bool = False):
        self.host = host
        self.device = None if host else resolve_device(device)
        ist = query.input_stream
        if not isinstance(ist, StateInputStream):
            raise DeviceCompileError("not a pattern/sequence query")
        self.query = query
        self.C = slot_capacity
        self.B = batch_capacity
        self.compiled: CompiledPattern = PatternCompiler(ist, stream_defs).compile()
        self.is_sequence = self.compiled.is_sequence
        self.within = self.compiled.within_ms
        self.merged = MergedBatchSchema(stream_defs, self.compiled.stream_ids)
        self.stream_defs = stream_defs

        # validate + lower nodes (the reference's checks, in its order)
        self.states: list[_DevState] = []
        self.alias_branch: dict[str, tuple[int, int]] = {}   # alias → (state, branch)
        self.referenced: set[tuple[int, str, DataType]] = set()
        nodes = self.compiled.nodes
        has_element_within = any(n.within_ms is not None for n in nodes)
        for node in nodes:
            if node.kind not in ("stream", "count", "logical", "absent"):
                raise DeviceCompileError(
                    f"'{node.kind}' states need the host path")
            if node.reseed_to not in (None, 0) and node.kind != "stream":
                # mid-pattern scope-end reseeds are implemented only at the
                # stream-state advance site
                raise DeviceCompileError(
                    "mid-pattern `every` ending at a non-stream state needs "
                    "the host path")
            if node.kind == "logical" and node.waiting_time_ms is not None \
                    and self.is_sequence:
                raise DeviceCompileError(
                    "`and/or not X for t` in sequences needs the host path")
            if node.kind == "absent" and node.waiting_time_ms is None:
                raise DeviceCompileError(
                    "absent without `for` needs the host path")
            if node.kind in ("logical", "absent") and node.index > 0 \
                    and nodes[node.index - 1].kind == "count":
                # the count-prev eligibility source exists only for
                # immediate-advance logical shapes: `X and not Y` without
                # `for`, or a pure OR
                has_absent = any(b.is_absent for b in node.branches)
                lt = node.logical_type.value if node.logical_type else None
                immediate = (
                    node.kind == "logical"
                    and node.waiting_time_ms is None
                    and ((lt == "and" and has_absent)
                         or (lt == "or" and not has_absent)))
                if not immediate:
                    raise DeviceCompileError(
                        "logical/absent after a count state needs the host "
                        "path")
            if node.kind == "count" and node.index > 0 \
                    and nodes[node.index - 1].kind == "count":
                # only the stream-state advance path pulls eligible partials
                # out of a count table
                raise DeviceCompileError(
                    "count directly after a count state needs the host path")
            if node.kind == "absent" and self.is_sequence:
                raise DeviceCompileError(
                    "absent in sequences needs the host path")
            branches = [
                _DevBranch(stream_idx=self.merged.stream_index[b.stream_id],
                           alias=b.alias, is_absent=b.is_absent)
                for b in node.branches
            ]
            self.states.append(_DevState(
                index=node.index, kind=node.kind, branches=branches,
                logical_type=(node.logical_type.value
                              if node.logical_type is not None else None),
                waiting_ms=node.waiting_time_ms,
                min_count=node.min_count, max_count=node.max_count,
                ends_every=node.reseed_to == 0,
                within_ms=node.within_ms,
                reseed_to=node.reseed_to,
            ))
            for bi, b in enumerate(node.branches):
                self.alias_branch[b.alias] = (node.index, bi)
        final = self.states[-1]
        if final.kind == "count" and len(self.states) >= 2 \
                and self.states[-2].kind in ("logical", "absent") \
                and final.min_count == 0:
            # zero-min final counts emit at ARRIVAL; only the stream-advance
            # and seed paths implement that emit
            raise DeviceCompileError(
                "logical/absent into a zero-min final count needs the host "
                "path")

        self.S = len(self.states)
        self.always_seed = self.states[0].ends_every
        # group-every: scope end j > 0 → seeds replenished on state j advance
        self.every_end = next(
            (s.index for s in self.states if s.ends_every), None)
        if self.is_sequence and self.every_end not in (None, 0):
            raise DeviceCompileError(
                "group `every` scopes in sequences need the host path")
        # mid-pattern `every` scopes [r..k], r > 0: the scope-end advance
        # re-places a clone at p{r} (scope bindings cleared) that becomes
        # visible on the NEXT event (host `_created` skip)
        self.reseed_targets = sorted({st.reseed_to for st in self.states
                                      if st.reseed_to not in (None, 0)})
        for r in self.reseed_targets:
            if self.states[r].kind != "stream":
                raise DeviceCompileError(
                    "mid-pattern `every` starting at a non-stream state "
                    "needs the host path")
        if self.is_sequence and self.reseed_targets:
            raise DeviceCompileError(
                "mid-pattern `every` in sequences needs the host path")
        s0 = self.states[0]
        # absent-start / `X and-or not Y`-start patterns carry a PRE-PLACED
        # seed slot whose non-occurrence clock begins at the runtime start
        self.preseeded = s0.kind == "absent" or (
            s0.kind == "logical" and any(b.is_absent for b in s0.branches))
        if self.preseeded and self.every_end not in (None, 0):
            raise DeviceCompileError(
                "group `every` over an absent-start scope needs the host "
                "path")

        # compile predicates (after the alias map is ready) from the ASTs
        self.used_ev_cols: set[str] = set()
        # fleet parameter columns the programs read (``__fleet_p{i}`` →
        # DataType): injected per row with the batch, never staged
        self.param_cols: dict[str, DataType] = {}
        self._compile_predicates(ist)
        self._compile_output(query)
        # merged columns the compiled program actually reads — the builders
        # stage and transfer only these
        resolver = _NFAResolver(self, None)
        self.used_cols = set(self.used_ev_cols)
        for (q, key, t) in self.referenced:
            if not is_flag_key(q, key):
                self.used_cols.add(resolver._bound_to_merged(key))
        # kernel selection: stream-state chains with `every` take the blocked
        # kernel; count/logical/absent states use the per-event scan
        from .nfa_block import blocked_eligible
        self.blocked = blocked_eligible(self)
        # blocked-kernel creation budget: compacts per-batch creations to K
        # entries, capping every stage at C+K candidates (drops counted)
        self.creation_cap = creation_cap
        if has_element_within and not self.blocked:
            # the scan kernel's tables don't carry last-bind times
            raise DeviceCompileError(
                "element-level within outside stream-chain patterns needs "
                "the host path")
        if host:
            # the columnar host tier executes the plan eagerly with dynamic
            # shapes; it only covers the blocked shape
            if not self.blocked:
                raise DeviceCompileError(
                    "count/logical/absent states have no columnar host "
                    "kernel — scalar interpreter path")
            self.plan = None
            return
        # the kernel's plan (linked programs, descriptor tables): an app over
        # one of its limits is refused here, on every device, where callers
        # catch DeviceCompileError, and never at a later step
        if self.blocked:
            from .nfa_block import BlockPlan
            self.plan = BlockPlan(self)
        else:
            from .nfa_scan import ScanPlan
            self.plan = ScanPlan(self)

    def _compile_predicates(self, ist: StateInputStream) -> None:
        from ..query_api import (
            AbsentStreamStateElement,
            And,
            CountStateElement,
            EveryStateElement,
            Filter,
            LogicalStateElement,
            NextStateElement,
            StreamStateElement,
        )
        filters: list[list[Any]] = []     # per node, per branch

        def _filter_of(stream):
            ast = None
            for h in stream.handlers:
                if isinstance(h, Filter):
                    ast = h.expr if ast is None else And(ast, h.expr)
                else:           # windows / stream functions inside a pattern
                    raise DeviceCompileError(
                        f"pattern stream handler "
                        f"{type(h).__name__} needs the host path")
            return ast

        def walk(el):
            if isinstance(el, NextStateElement):
                walk(el.first)
                walk(el.next)
            elif isinstance(el, EveryStateElement):
                walk(el.inner)
            elif isinstance(el, StreamStateElement):
                filters.append([_filter_of(el.stream)])
            elif isinstance(el, CountStateElement):
                filters.append([_filter_of(el.stream.stream)])
            elif isinstance(el, LogicalStateElement):
                filters.append([_filter_of(sub.stream)
                                for sub in (el.first, el.second)])
            elif isinstance(el, AbsentStreamStateElement):
                filters.append([_filter_of(el.stream)])
            else:
                raise DeviceCompileError(
                    f"{type(el).__name__} needs the host path")

        walk(ist.state)
        assert len(filters) == self.S
        for s, asts in zip(self.states, filters):
            assert len(asts) == len(s.branches)
            for b, ast in zip(s.branches, asts):
                if ast is None:
                    continue
                resolver = _NFAResolver(self, s.index, b.alias)
                fn, _, ir = compile_expression(ast, resolver)
                b.predicate, b.predicate_ir = self._guard_predicate(
                    ast, fn, ir, resolver.touched)

    def _guard_predicate(self, ast, fn, ir, touched):
        """Null-guard a predicate whose refs may be unbound at eval time.

        The host evaluates comparisons over NULL to false; the device
        carries ZEROS in unbound slot fields, so a null-strict predicate is
        ANDed with per-slot "bound" flags instead (zero-min count bindings,
        ``e[k]`` occurrences). Shapes where NULL does not simply poison the
        result over such refs — and refs whose flags aren't carried (OR /
        absent sides) — fall back to the host path."""
        flags: set[tuple[int, str]] = set()
        for (q, key) in touched:
            st = self.states[q]
            if key.startswith(f"b{q}x"):
                bi = int(key[len(f"b{q}x"):].split("_", 1)[0])
                if st.logical_type == "or" or st.branches[bi].is_absent:
                    raise DeviceCompileError(
                        "predicate referencing an OR/absent side needs the "
                        "host path")
            elif key.startswith(f"b{q}#occ"):
                k = int(key[len(f"b{q}#occ"):].split("#", 1)[0])
                flags.add((q, _occ_flag(q, k)))
            elif st.kind == "absent":
                raise DeviceCompileError(
                    "predicate referencing an absent alias needs the host "
                    "path")
            elif st.kind == "count" and st.min_count == 0:
                flags.add((q, _has_flag(q)))
        if not flags:
            return fn, ir
        if not _null_strict(ast):
            raise DeviceCompileError(
                "non-null-strict predicate over possibly-unbound bindings "
                "needs the host path")
        for (q, flag) in flags:
            self.referenced.add((q, flag, DataType.BOOL))
        guard_keys = tuple(sorted(flag for (_, flag) in flags))

        def guarded(env, _fn=fn, _keys=guard_keys):
            r = as_tensor(_fn(env), env)
            for fkey in _keys:
                r = r & env[fkey]
            return r

        if ir is None:                  # a host compile builds no IR
            return guarded, None
        # the IR form: the program's result (as bool) ANDed with each flag
        gir = list(ir)
        if ir_result_type(gir) != T_BOOL:
            gir.append((OP["CAST"], T_BOOL, ir_result_type(gir), 0))
        for fkey in guard_keys:
            gir += [(OP["BIND"], T_BOOL, fkey, 0), (OP["AND"], T_BOOL, 0, 0)]
        return guarded, gir

    def _compile_output(self, query: Query) -> None:
        sel = query.selector
        attrs = sel.attributes
        if sel.select_all or not attrs:
            raise DeviceCompileError("pattern select * needs the host path")
        self.out_specs: list[tuple[str, Callable, DataType]] = []
        self.out_irs: list[list] = []
        final = self.S - 1
        # logical/absent finals emit from slot-bound values (possibly with no
        # candidate event at all), so bare/candidate references must not bind
        out_ctx = final if self.states[final].kind == "stream" else None
        # per-output null dependencies: an output referencing an OR state's
        # unmatched side / an absent branch / a zero-min count's bindings is
        # NULL when that side never bound — a carried boolean flag travels
        # with the partial
        self.out_null_deps: list[set] = []
        for oa in attrs:
            resolver = _NFAResolver(self, out_ctx)
            fn, t, ir = compile_expression(oa.expr, resolver)
            deps = set()
            for (q, key) in resolver.touched:
                if key.startswith(f"b{q}x"):        # logical branch binding
                    bi = int(key[len(f"b{q}x"):].split("_", 1)[0])
                    st = self.states[q]
                    if st.logical_type == "or" or st.branches[bi].is_absent:
                        deps.add((q, f"b{q}x{bi}__set"))
                elif key.startswith(f"b{q}#occ"):
                    # e[k] is NULL when the count never reached k+1
                    k = int(key[len(f"b{q}#occ"):].split("#", 1)[0])
                    deps.add((q, _occ_flag(q, k)))
                elif self.states[q].kind == "count" \
                        and self.states[q].min_count == 0:
                    deps.add((q, _has_flag(q)))
            self.out_specs.append((oa.name, fn, t))
            self.out_irs.append(ir)
            self.out_null_deps.append(deps)
        for deps in self.out_null_deps:
            for (q, flag) in deps:
                self.referenced.add((q, flag, DataType.BOOL))

    def kernel_columns(self) -> list:
        """The event columns a kernel plan reads, in slot order: the staged
        columns the programs use, then the fleet parameter columns."""
        return sorted(self.used_cols) + sorted(self.param_cols)

    def column_type(self, key: str) -> DataType:
        t = self.param_cols.get(key)
        return t if t is not None else self.merged.columns[key]

    # ------------------------------------------------------------------ state
    def init_state(self, lanes: int = 1, start_ts: int = 0) -> dict:
        """Fresh ``[lanes, ...]``-stacked state on the plan's device.
        ``start_ts`` arms an absent-start pattern's pre-placed seed clock."""
        if self.blocked:
            from .nfa_block import block_init_state
            return block_init_state(self, lanes)
        from .nfa_scan import scan_init_state
        return scan_init_state(self, lanes, start_ts)

    # ------------------------------------------------------------------- step
    def make_step(self):
        """Lane-batched step ``(state, cols, tag, ts, ts_base, nvalid) ->
        (state, ys)`` over ``[L, ...]`` tensors in the wire format. On CUDA
        tensors it launches the shape's kernel and updates ``state`` in
        place; on CPU tensors it runs the plain version."""
        if self.blocked:
            from .nfa_block import make_block_step
            return make_block_step(self)
        from .nfa_scan import make_scan_step
        return make_scan_step(self)

    def step(self, state, batch: dict):
        """One-lane convenience over a ``MergedBatchBuilder.emit()`` batch:
        ``state`` carries a lane dim of 1; ``ys`` is returned for that lane."""
        if getattr(self, "_step", None) is None:
            self._step = self.make_step()
        dev = self.device
        cols = {k: torch.from_numpy(np.asarray(v)[None]).to(dev)
                for k, v in batch["cols"].items()}
        tag = torch.from_numpy(np.asarray(batch["tag"])[None]).to(dev)
        ts = torch.from_numpy(np.asarray(batch["ts"])[None]).to(dev)
        base = torch.tensor([int(batch["ts_base"])], dtype=torch.int64,
                            device=dev)
        nvalid = torch.tensor([int(batch["count"])], dtype=torch.int32,
                              device=dev)
        state, ys = self._step(state, cols, tag, ts, base, nvalid)
        return state, {k: v[0] for k, v in ys.items()}

    def decode_outputs(self, ys) -> list[list]:
        """One lane's ys → host rows in the reference's order."""
        if self.blocked:
            from .nfa_block import decode_block_outputs
            return decode_block_outputs(self, ys)
        from .nfa_scan import decode_scan_outputs
        return decode_scan_outputs(self, ys)


def _decode_scalar(nfa: DeviceNFACompiler, name: str, v, t: DataType):
    if t == DataType.STRING:
        # outputs referencing string columns share the merged dictionaries
        for dic in nfa.merged.dictionaries.values():
            s = dic.decode(int(v))
            if s is not None:
                return s
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


class DeviceNFARuntime(AdaptiveFlushMixin):
    """Micro-batching front end over a compiled NFA (one lane).

    ``device`` is the card unless the caller passes ``"cpu"`` (the plain
    version); with no card and no explicit ``"cpu"`` the constructor
    raises."""

    driver = None           # AsyncDeviceDriver when an engine bridge is async

    def __init__(self, app_or_text, slot_capacity: int = 64,
                 batch_capacity: int = 1024, query_index: int = 0,
                 start_time: int = 0, device=None):
        from ..compiler import parse as _parse
        app = _parse(app_or_text) if isinstance(app_or_text, str) else app_or_text
        query = app.queries[query_index]
        self.compiler = DeviceNFACompiler(
            query, dict(app.stream_definitions), slot_capacity, batch_capacity,
            device=device)
        self.device = self.compiler.device
        self.builder = MergedBatchBuilder(
            self.compiler.merged, batch_capacity, dict(app.stream_definitions),
            used_cols=self.compiler.used_cols)
        # absent-start patterns arm their non-occurrence clock at the
        # runtime start time
        self.state = self.compiler.init_state(1, start_time)
        self.callback: Optional[Callable[[list[list]], None]] = None

    def add_callback(self, fn) -> None:
        self.callback = fn

    def send(self, stream_id: str, row: list, timestamp: int) -> None:
        self.builder.append(stream_id, row, timestamp)
        self._maybe_flush()

    def dispatch(self, batch: dict):
        """Launches one step (the state advances in place on the card) and
        returns its un-decoded ys."""
        self.state, ys = self.compiler.step(self.state, batch)
        return ys

    def collect(self, ys) -> list[list]:
        """Decodes one dispatched step's ys (the copy to the host fences)."""
        return self.compiler.decode_outputs(ys)

    def process(self, batch: dict) -> list[list]:
        """Synchronous step + decode."""
        return self.collect(self.dispatch(batch))

    def deliver(self, rows: list[list], emit_ts=None) -> None:
        fn = self.callback
        if fn is not None and rows:
            if getattr(getattr(fn, "__self__", None),
                       "_on_rows_accepts_ts", False):
                fn(rows, emit_ts)
            else:           # plain user callback: rows only
                fn(rows)

    def flush(self, decode: bool = True):
        if len(self.builder) == 0:
            return None
        self._seal()
        batch = self.builder.emit()
        batch["_cause"] = self._take_cause()
        if self.driver is not None:         # the engine's async pipeline
            self.driver.submit(batch)
            return None
        if decode:
            rows = self._timed_process(batch)
            self.deliver(rows)
            return rows
        self.state, ys = self.compiler.step(self.state, batch)
        return ys

    @property
    def match_count(self) -> int:
        return int(self.state["matches"].sum())

    @property
    def drop_count(self) -> int:
        return int(self.state["drops"].sum())

    def snapshot_state(self) -> dict:
        """Checkpoint of the device state and its string dictionary, in the
        JAX package's shape: ``{"device": numpy tree with [C] leaves and
        scalar counters, "dict": {column: values}}``. Rows staged in the
        builder are not in it (``builder.snapshot()`` holds them)."""
        from .batch import device_state_snapshot
        return device_state_snapshot(self.state, self.compiler.merged,
                                     single_lane=True)

    def restore_state(self, snap) -> None:
        """Restores a ``snapshot_state`` checkpoint: the port's, or the JAX
        package's ``DeviceNFARuntime.snapshot_state()`` (numpy leaves, the
        same tree). Every leaf of ``init_state`` must be there with its
        dtype and its one-lane shape."""
        from .batch import device_state_restore
        from .state_io import nfa_state_from_numpy
        self.state = device_state_restore(
            snap, self.compiler.merged,
            lambda tree: nfa_state_from_numpy(self.compiler, tree,
                                              self.device))
