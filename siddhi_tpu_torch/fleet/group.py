"""FleetGroup: cross-app lane batching over one shared compiled plan.

Tenant-id is just another partition key (CORE's shared-automaton insight,
PAPERS.md 2111.04635): same-shape queries from different apps stage into ONE
SoA micro-batch — each row tagged with its member id — and execute through
one stepped program per flush:

- **batched lanes** (stateless stream shapes — filters/projections/having):
  the whole merged batch evaluates in one vectorized step; per-tenant
  constants are per-row parameter columns gathered from the member table,
  outputs demultiplex back to each tenant's junction by member id;
- **sliced lanes** (stateful shapes — windows/aggregates, blocked NFAs,
  partitioned patterns): one step iterates member segments of the merged
  batch (stable-sorted, so per-tenant event order is preserved) against
  per-tenant state and parameter bindings — compilation, staging,
  dictionary encoding and flush scheduling are shared; state is strictly
  per tenant.

Isolation: every member owns its state (window tails, NFA tables, lane
states) and snapshot/restores independently. String dictionaries are shared
per group (codes must be comparable across lanes); they are append-only, so
a member restore treats the dictionary monotonically — it never shrinks the
shared table under other tenants.

The port's copy of the JAX package's ``fleet/group.py``. Groups step on the
columnar host tier (``gpu/host_exec.py``: torch on the CPU over the
compilers' ``host=True`` plans, as the reference steps numpy); numpy stays
only where that tier keeps it, in the stager (``FleetStager`` over
``HostRowStager``) and the decode. An emitted window becomes CPU tensors
(``_torch_batch``) before the guard's sweep and the stepped program; member
ids, parameter tables and segments are tensors. A member's snapshot has
the reference's tree with numpy leaves (``gpu/state_io.py``:
``host_tree_to_numpy``/``host_tree_from_numpy``), so a tenant snapshotted in
one package resumes in the other.

A group step runs with Python's collector deferred
(``gpu/host_exec.py::collector_deferred``): a full collection the step's
decode would set off (hundreds of ms on a busy host, over the heap of a
process that holds torch) runs after it, at the next window's staging, so
the SLO controller reads it as fill wait and shrinks the window, as the
reference's does, instead of blaming the step and splitting the group.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np

import torch

from ..core.event import Event, EventType, StreamEvent
from ..gpu.dtypes import TORCH_HOST
from ..gpu.host_exec import (
    HostRowStager,
    collector_deferred,
    decode_columns,
    one_intraop_thread,
)
from ..gpu.state_io import host_tree_from_numpy, host_tree_to_numpy
from ..query_api.definition import DataType

log = logging.getLogger("siddhi_tpu_torch.fleet")


# ---------------------------------------------------------------------------
# small state helpers
# ---------------------------------------------------------------------------

def copy_state_tree(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, dict):
        return {k: copy_state_tree(x) for k, x in v.items()}
    if isinstance(v, list):
        return [copy_state_tree(x) for x in v]
    return v


def restore_dicts_monotonic(dictionaries: dict, snap: dict) -> None:
    """Per-tenant dictionary restore against a SHARED table.

    Dictionary codes are append-only and stable, so a snapshot's value list
    is a prefix of any later state of the same table. Restoring one tenant
    must not shrink the shared table under the others: apply the snapshot
    only when it EXTENDS the current table (fresh process), skip when the
    current table is already a superset, and log a conflict otherwise
    (mixing snapshots from different fleet generations)."""
    for name, values in snap.items():
        d = dictionaries.get(name)
        if d is None:
            continue
        cur = d.snapshot()
        if len(values) > len(cur) and cur == values[:len(cur)]:
            d.restore(values)          # extends the live table (fresh process)
        elif values != cur[:len(values)]:
            # conflicting generation: NEVER rewrite the shared table under
            # live co-tenants (their state carries codes of the live table);
            # this tenant's restore proceeds against the live codes and the
            # conflict is loud — restore whole-fleet checkpoints from one
            # generation when reviving a fresh process
            log.warning("fleet dictionary snapshot for '%s' conflicts with "
                        "the live shared table; keeping the live table "
                        "(mixing snapshot generations across tenants?)",
                        name)


def _param_dtype(spec) -> torch.dtype:
    if spec.string:
        return TORCH_HOST[DataType.STRING]
    return TORCH_HOST[spec.type]


def bind_param_values(specs, values, dictionaries) -> list:
    """Tenant constants → Python scalars cast through the plan dtypes (the
    host policy, ``TORCH_HOST``); strings encode to codes against the
    group's shared dictionary."""
    out = []
    for spec, v in zip(specs, values):
        if spec.string:
            dic = None
            for d in dictionaries.values():
                dic = d
                break
            if dic is None:
                raise ValueError(
                    "string parameter with no dictionary column in the plan")
            out.append(int(dic.encode(v)))
        else:
            out.append(torch.tensor(0 if v is None else v,
                                    dtype=_param_dtype(spec)).item())
    return out


def _torch_batch(b: dict) -> dict:
    """An emitted window (the stager's numpy columns) as CPU tensors."""
    def t(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.ascontiguousarray(x))
    out = dict(b)
    out["cols"] = {k: t(v) for k, v in b["cols"].items()}
    out["tag"] = t(b["tag"])
    out["ts"] = t(b["ts"])
    return out


def member_counts(mids: torch.Tensor) -> tuple[list, list]:
    """The member ids present in ``mids`` (ascending) and their row counts:
    ``np.unique(mids, return_counts=True)`` over small non-negative ids,
    by one ``bincount`` (``torch.unique`` sorts, which costs far more at a
    window's width)."""
    if mids.numel() == 0:
        return [], []
    c = torch.bincount(mids)
    present = torch.nonzero(c).flatten()
    return present.tolist(), c[present].tolist()


def segment_starts(sorted_mid: torch.Tensor) -> list:
    """Bounds of the equal runs of a sorted member-id column:
    ``[0, ..., n]`` (``np.r_[0, nonzero(diff) + 1, n]``)."""
    n = sorted_mid.numel()
    if n == 0:
        return [0, 0]
    cut = torch.nonzero(sorted_mid[1:] != sorted_mid[:-1]).flatten() + 1
    return [0] + cut.tolist() + [n]


# ---------------------------------------------------------------------------
# staging: the shared stager + member-id lane column
# ---------------------------------------------------------------------------

class FleetStager(HostRowStager):
    """HostRowStager that tags every staged row with its member id."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._mid: list[int] = []

    def stage_event(self, mid: int, sid: str, data, ts: int) -> None:
        self.append(sid, data, ts)
        self._mid.append(mid)

    def stage_events(self, mid: int, sid: str, events: list) -> None:
        self.append_events(sid, events)
        self._mid.extend([mid] * len(events))

    def stage_rows(self, mid: int, sid: str, rows: list, timestamps) -> None:
        self.append_rows(sid, rows, timestamps)
        self._mid.extend([mid] * len(rows))

    def stage_columns(self, mid: int, sid: str, cols: dict, ts) -> None:
        # _mid tracks arrival order for BOTH representations (ensure_rows
        # preserves order), so the member-id column stays aligned
        n = int(np.asarray(ts).shape[0])
        self.append_columns(sid, cols, ts)
        self._mid.extend([mid] * n)

    def emit(self) -> dict:
        b = super().emit()
        b["mid"] = torch.tensor(self._mid, dtype=torch.int64)
        self._mid = []
        return b


# ---------------------------------------------------------------------------
# members
# ---------------------------------------------------------------------------

class FleetMember:
    def __init__(self, mid: int, tenant: str, query_name: str, app_context,
                 output_junction, params: list, overrides: dict,
                 local_sids: list):
        self.mid = mid
        self.tenant = tenant
        self.query_name = query_name
        self.app_context = app_context
        self.output_junction = output_junction
        self.params = params
        self.overrides = overrides
        self.local_sids = local_sids
        self.group = None              # owning FleetGroup (re-pointed by
        # FleetGroup.split — receivers route through it, so a moved member
        # stages into its NEW group without re-subscribing junctions)
        self.slo = None                # TenantSLO when @app:fleet(slo.*)
        self.state: Any = None
        self.prt = None                # partition kind runtime
        self.bridge: Optional["FleetQueryBridge"] = None
        self.events_in = 0
        self.batches = 0
        self.attached_at = time.monotonic()
        # guard surface (resilience/fleet_guard.py): an ejected member's
        # rows bypass the shared stager and step solo; weight/max_lag drive
        # the fair-share window quotas; chaos is the member app's injector
        # (fleet.fault.p targets its OWN lanes)
        self.ejected = False
        self.weight = 1.0
        self.max_lag = 0               # 0 = unlimited
        self.chaos = None
        self.lane = None               # TenantLane once guarded
        # sampled traces whose events are staged in the shared (or solo)
        # window: (Trace, stage perf_counter_ns); the step drains them with
        # a 'fleet' span — the X-Ray handoff across the shared-lane hop
        self.trace_pending: deque = deque()
        # solo-ladder build context (scalar escalation needs the original
        # query AST + the app's junction resolver)
        self.query = None
        self.solo_stream_defs = None
        self.get_junction = None

    @property
    def ev_per_s(self) -> float:
        dt = time.monotonic() - self.attached_at
        return self.events_in / dt if dt > 0 else 0.0


class FleetQueryBridge:
    """The app-facing face of one fleet member: junction receivers in, demuxed
    outputs back to the member's own output junction. Mirrors the host-bridge
    surface (``query_name`` / ``stream_ids`` / ``flush`` / ``finalize`` /
    ``query_callbacks`` / ``report``) so the app runtime treats fleet and
    solo columnar queries uniformly."""

    kind = "fleet"

    def __init__(self, group: "FleetGroup", member: FleetMember):
        self.group = group
        self.member = member
        member.bridge = self
        self.query_name = member.query_name
        self.stream_ids = list(member.local_sids)
        self.query_callbacks: list = []
        self.output_schema = group.output_schema

    # -- junction receivers ----------------------------------------------
    def receiver_for(self, stream_id: str):
        member = self.member
        # gsid is the group-canonical id at this position — identical in
        # any split sibling (siblings are built from the same canonical
        # args), so routing through member.group stays valid after a split
        gsid = self.group.sids[member.local_sids.index(stream_id)]

        class _R:
            def receive(self, event: StreamEvent) -> None:
                if event.type is not EventType.CURRENT:
                    return
                member.group.stage_event(member, gsid, event.data,
                                         event.timestamp)

            def receive_chunk(self, events: list) -> None:
                if any(e.type is not EventType.CURRENT for e in events):
                    events = [e for e in events
                              if e.type is EventType.CURRENT]
                    if not events:
                        return
                member.group.stage_events(member, gsid, events)

            def receive_rows(self, rows: list, timestamps) -> None:
                member.group.stage_rows(member, gsid, rows, timestamps)

            def receive_columns(self, cols: dict, ts, n: int) -> None:
                member.group.stage_columns(member, gsid, cols, ts, n)

        return _R()

    # -- drain ------------------------------------------------------------
    def flush(self, cause: str = "drain") -> None:
        self.group.flush(cause)
        self.group._drain_guard(self.member)

    def finalize(self) -> None:
        self.group.flush("final")
        self.group._drain_guard(self.member)

    # -- demuxed output ---------------------------------------------------
    def deliver(self, ts_list: list, rows: list) -> None:
        if not rows:
            return
        events = [StreamEvent(ts, row, EventType.CURRENT)
                  for ts, row in zip(ts_list, rows)]
        if self.query_callbacks:
            evs = [Event(e.timestamp, e.data) for e in events]
            for cb in self.query_callbacks:
                cb.receive(events[-1].timestamp, evs, None)
        if self.member.output_junction is not None:
            self.member.output_junction.send_events(events)

    def report(self) -> dict:
        out = {"query": self.query_name, "engine": "fleet",
               "kind": self.group.kind, "shape": self.group.shape_key,
               "mode": self.group.mode, "events": self.member.events_in,
               "batches": self.member.batches,
               "members": len(self.group.members)}
        if self.member.lane is not None:
            out["guard"] = self.member.lane.report()
        return out


class FleetMemberState:
    """Per-tenant snapshot adapter (registered in the member app's state
    registry): flushes the GROUP (staged rows of any tenant resolve before
    the state walk), then snapshots only this member's state plus the shared
    dictionary tables its codes decode through."""

    def __init__(self, member: FleetMember):
        self.member = member

    @property
    def group(self) -> "FleetGroup":
        # resolved through the member so a split-moved tenant snapshots
        # against its CURRENT group
        return self.member.group

    def snapshot_state(self):
        self.group.flush("snapshot")
        return {"state": copy_state_tree(self.group.member_state(self.member)),
                "dict": self.group.snapshot_dictionaries()}

    def restore_state(self, snap):
        self.group.flush("restore")
        restore_dicts_monotonic(self.group.dictionaries,
                                snap.get("dict", {}))
        self.group.restore_member_state(self.member,
                                        copy_state_tree(snap["state"]))


# ---------------------------------------------------------------------------
# the group
# ---------------------------------------------------------------------------

class GroupFlight:
    """Flight-recorder fan-out for group-scoped control-plane transitions
    (AIMD window resizes, group flush-cause flips): the shared window is
    every tenant's latency policy, so the transition lands on EVERY
    member app's timeline — a group has no app (and no recorder) of its
    own."""

    def __init__(self, group: "FleetGroup"):
        self.group = group

    def _recorders(self):
        # callers (AIMD observe, SLO evaluation) run lock-free while
        # enroll/split mutate the members dict under the group lock — a
        # torn read costs one retry, never a dropped timeline entry
        members = []
        for _ in range(4):
            try:
                members = list(self.group.members.values())
                break
            except RuntimeError:
                continue
        seen = set()
        for m in members:
            fl = getattr(m.app_context, "flight", None)
            if fl is not None and id(fl) not in seen:
                seen.add(id(fl))
                yield fl

    def record(self, category, kind, site="", detail=None,
               trace_id=None) -> None:
        for fl in self._recorders():
            fl.record(category, kind, site, detail, trace_id)

    def record_transition(self, category, kind, site="", detail=None,
                          trace_id=None) -> None:
        for fl in self._recorders():
            fl.record_transition(category, kind, site, detail, trace_id)


class FleetGroup:
    """All tenants of one shape on the columnar backend: shared plan, shared
    stager, one stepped program per flush."""

    def __init__(self, shape_key: str, kind: str, plan, cfg: dict,
                 sids: list, stream_defs: dict, param_specs: list):
        self.shape_key = shape_key
        self.kind = kind              # 'stream' | 'nfa' | 'partition'
        self.plan = plan
        self.cfg = cfg
        self.sids = list(sids)        # canonical (builder tenant) stream ids
        self.param_specs = param_specs
        self.capacity = int(cfg.get("batch", 8192))
        self.members: dict[int, FleetMember] = {}
        self._next_mid = 0
        self._luts = None             # param LUT cache (membership-keyed)
        self._lock = threading.RLock()
        self.steps = 0
        self.lanes_last_step = 0
        self.events_in = 0
        self.flush_causes: dict[str, int] = {}
        self._stream_defs = dict(stream_defs or {})
        self.guard = None             # FleetGuard (resilience/fleet_guard.py)
        self.batch_controller = None  # @app:adaptive AIMD window sizing
        self.slo = None               # SLOController (@app:fleet slo.* keys)
        self.slo_window = None        # autopilot's flush-window cap
        self._window_t0 = None        # first-stage wall clock (fill span)
        if kind == "stream":
            self.schema = plan.compiled.schema
            self.stager = FleetStager(self.schema, None, self.capacity)
            # stateless shapes take the fully-batched lane path (one
            # vectorized step across every tenant's rows)
            self.mode = "batched" if plan.stateless else "sliced"
            self.output_schema = ([s.name for s in plan.compiled.specs],
                                  [s.dtype for s in plan.compiled.specs])
        else:
            self.schema = plan.compiler.merged
            self.stager = FleetStager(self.schema, dict(stream_defs),
                                      self.capacity,
                                      used_cols=plan.compiler.used_cols)
            self.mode = "sliced"
            self.output_schema = (
                [n for n, _, _ in plan.compiler.out_specs],
                [t for _, _, t in plan.compiler.out_specs])

    # -- dictionaries ------------------------------------------------------
    @property
    def dictionaries(self) -> dict:
        return self.schema.dictionaries

    def snapshot_dictionaries(self) -> dict:
        return self.schema.snapshot_dictionaries()

    # -- membership --------------------------------------------------------
    def add_member(self, tenant: str, query_name: str, app_context,
                   output_junction, param_values: list, overrides: dict,
                   local_sids: list) -> FleetMember:
        with self._lock:
            mid = self._next_mid
            self._next_mid += 1
            params = bind_param_values(self.param_specs, param_values,
                                       self.dictionaries)
            m = FleetMember(mid, tenant, query_name, app_context,
                            output_junction, params, overrides, local_sids)
            m.group = self
            m.state = self._init_member_state(m)
            self.members[mid] = m
            self._luts = None
            if self.guard is not None:
                self.guard.attach(m)
            return m

    def remove_member(self, member: FleetMember) -> int:
        """Drains the group, detaches the member; returns members left."""
        with self._lock:
            self.flush("member-leave")
            self.members.pop(member.mid, None)
            if self.guard is not None:
                self.guard.detach(member)
            if self.slo is not None:
                self.slo.detach(member)
            self._luts = None
            return len(self.members)

    def split(self, move: list) -> "FleetGroup":
        """Halve the blast radius of one shared step: the ``move`` members
        leave for a sibling group stepping the SAME cached plan (no
        recompile, same shared dictionaries — codes stay comparable), with
        their state, guard lanes (breaker/counters intact) and fair-share
        knobs carried over. The SLO autopilot's split actuator calls this
        via :meth:`FleetManager.split_group` when the step phase owns a
        violated budget; caller holds ``self._lock``."""
        self.flush("split")
        sibling = FleetGroup(self.shape_key, self.kind, self.plan, self.cfg,
                             self.sids, self._stream_defs, self.param_specs)
        if self.guard is not None:
            from ..resilience.fleet_guard import FleetGuard
            sibling.guard = FleetGuard(sibling, self.cfg)
        c = self.batch_controller
        if c is not None:
            from ..flow.adaptive_batch import AdaptiveBatchController
            sibling.batch_controller = AdaptiveBatchController(
                min_batch=c.min_batch, max_batch=c.max_batch,
                target_ms=c.target_ms, initial=c.current,
                latency_target_ms=c.latency_target_ms)
            sibling.batch_controller.flight = GroupFlight(sibling)
            sibling.batch_controller.site = f"{c.site}#split"
        sibling.slo_window = self.slo_window
        for m in move:
            if self.members.pop(m.mid, None) is None:
                continue
            lane = None
            if self.guard is not None:
                lane = self.guard.lanes.pop(m.mid, None)
            m.mid = sibling._next_mid
            sibling._next_mid += 1
            sibling.members[m.mid] = m
            m.group = sibling
            if m.bridge is not None:
                m.bridge.group = sibling
            if sibling.guard is not None:
                if lane is not None:
                    sibling.guard.adopt(m, lane)
                else:
                    sibling.guard.attach(m)
        self._luts = None
        return sibling

    def _init_member_state(self, m: FleetMember):
        ov = m.overrides
        if self.kind == "stream":
            st = self.plan.hq.init_state()
            for k in ("window_n", "window_ms"):
                if k in ov:
                    st[k] = ov[k]
            return st
        if self.kind == "nfa":
            st = self.plan.engine.init_state()
            if "within" in ov:
                st["within"] = ov["within"]
            return st
        # partition: a per-member lane runtime over the SHARED engine
        from ..gpu.host_exec import HostPartitionedNFA
        m.prt = HostPartitionedNFA(
            None, self.plan.stream_defs, self.plan.key_attr,
            num_partitions=int(self.cfg.get("lanes", 16)),
            compiler=self.plan.compiler, engine=self.plan.engine)
        if "within" in ov:
            for st in m.prt.lane_states:
                st["within"] = ov["within"]
        return None

    # -- per-member state (snapshot isolation) -----------------------------
    def member_state(self, m: FleetMember):
        """The member's state tree with numpy leaves (the reference's)."""
        if self.kind == "partition":
            return m.prt.snapshot_state()
        if self.kind == "nfa":
            return host_tree_to_numpy({"tables": m.state["tables"],
                                       "matches": m.state["matches"]})
        return host_tree_to_numpy(m.state)

    def restore_member_state(self, m: FleetMember, state) -> None:
        ov = m.overrides
        if self.kind == "partition":
            m.prt.restore_state(state)
            if "within" in ov:
                for st in m.prt.lane_states:
                    st["within"] = ov["within"]
            return
        if self.kind == "nfa":
            st = {"tables": host_tree_from_numpy(state["tables"]),
                  "matches": int(state["matches"])}
            if "within" in ov:
                st["within"] = ov["within"]
            m.state = st
            return
        st = host_tree_from_numpy(dict(state))
        for k in ("window_n", "window_ms"):
            if k in ov:
                st[k] = ov[k]
        m.state = st

    # -- staging -----------------------------------------------------------
    # each staging entry drains the guard's deferred scalar replays AFTER
    # releasing the group lock (they acquire the member app's root_lock —
    # taking it under the group lock would invert the snapshot walk's
    # root_lock → group._lock order), and gives the SLO autopilot its
    # (rate-limited) evaluation slot at the same lock-free point

    def _note_window_t0(self) -> None:
        """First stage into an empty window stamps the fill-span clock —
        the evidence the autopilot's fill_wait attribution reads. Only
        armed groups pay the perf_counter call."""
        if self.slo is not None and self._window_t0 is None:
            self._window_t0 = time.perf_counter()

    # NOTE on the per-method `m.group is not self` checks: the unlocked one
    # is the fast path; the SECOND check inside the lock closes the race
    # with split() — a stager that lost it would otherwise use the
    # member's NEW sibling mid against THIS group's stager, aliasing a
    # remaining tenant's lane (params, quota, output junction). The moved
    # flag re-dispatches after the lock drops (old→sibling lock nesting is
    # avoided entirely).

    def stage_event(self, m: FleetMember, gsid: str, data, ts: int) -> None:
        if m.group is not self:      # split moved the member mid-flight
            return m.group.stage_event(m, gsid, data, ts)
        moved = False
        try:
            with self._lock:
                if m.group is not self:
                    moved = True     # split won the lock first: re-route
                elif self.guard is not None and m.ejected:
                    self._register_trace(m)
                    self.guard.solo_stage(m, gsid, [data], [ts])
                elif self.guard is not None and \
                        self.guard.admit(m, gsid, [data]) == 0:
                    # shed/diverted BEFORE staging: no trace handoff —
                    # the event never reaches the shared step
                    pass
                else:
                    self._register_trace(m)
                    self._note_window_t0()
                    self.stager.stage_event(m.mid, gsid, data, ts)
                    self._post_stage(m)
        finally:
            self._drain_guard(m)
            self._drain_slo()
        if moved:
            m.group.stage_event(m, gsid, data, ts)

    def stage_events(self, m: FleetMember, gsid: str, events: list) -> None:
        if m.group is not self:
            return m.group.stage_events(m, gsid, events)
        moved = False
        try:
            with self._lock:
                g = self.guard
                if m.group is not self:
                    moved = True
                elif g is not None and m.ejected:
                    self._register_trace(m)
                    g.solo_stage(m, gsid, [e.data for e in events],
                                 [e.timestamp for e in events])
                else:
                    k = g.admit(m, gsid, [e.data for e in events]) \
                        if g is not None else len(events)
                    if k > 0:
                        if k < len(events):
                            events = events[:k]
                        self._register_trace(m)
                        self._note_window_t0()
                        self.stager.stage_events(m.mid, gsid, events)
                        self._post_stage(m)
        finally:
            self._drain_guard(m)
            self._drain_slo()
        if moved:
            m.group.stage_events(m, gsid, events)

    def stage_rows(self, m: FleetMember, gsid: str, rows,
                   timestamps) -> None:
        if m.group is not self:
            return m.group.stage_rows(m, gsid, rows, timestamps)
        moved = False
        try:
            with self._lock:
                g = self.guard
                if m.group is not self:
                    moved = True
                elif g is not None and m.ejected:
                    self._register_trace(m)
                    g.solo_stage(m, gsid, rows, timestamps)
                else:
                    k = g.admit(m, gsid, rows) if g is not None \
                        else len(rows)
                    if k > 0:
                        if k < len(rows):
                            rows = rows[:k]
                            timestamps = timestamps[:k]
                        self._register_trace(m)
                        self._note_window_t0()
                        self.stager.stage_rows(m.mid, gsid, rows,
                                               timestamps)
                        self._post_stage(m)
        finally:
            self._drain_guard(m)
            self._drain_slo()
        if moved:
            m.group.stage_rows(m, gsid, rows, timestamps)

    def stage_columns(self, m: FleetMember, gsid: str, cols: dict, ts,
                      n: int) -> None:
        """Zero-object staging of one columnar chunk: quota/dict-cap
        admission runs on the columns (``FleetGuard.admit_columns``), the
        shared stager keeps the chunk whole. Only an ejected member's
        chunks materialize rows (the solo tier replays per row), and the
        guard's pre-step shadow materializes once per window."""
        if m.group is not self:
            return m.group.stage_columns(m, gsid, cols, ts, n)
        ts = np.asarray(ts, dtype=np.int64)
        moved = False
        try:
            with self._lock:
                g = self.guard
                if m.group is not self:
                    moved = True
                elif g is not None and m.ejected:
                    self._register_trace(m)
                    from ..core.columns import columns_to_rows
                    d = self.stream_defs_for(gsid)
                    g.solo_stage(m, gsid,
                                 columns_to_rows(
                                     cols, d.attribute_names, n),
                                 ts.tolist())
                else:
                    k = g.admit_columns(m, gsid, cols, n) \
                        if g is not None else n
                    if k > 0:
                        if k < n:
                            cols = {kk: v[:k] for kk, v in cols.items()}
                            ts = ts[:k]
                        self._register_trace(m)
                        self._note_window_t0()
                        self.stager.stage_columns(m.mid, gsid, cols, ts)
                        self._post_stage(m)
        finally:
            self._drain_guard(m)
            self._drain_slo()
        if moved:
            m.group.stage_columns(m, gsid, cols, ts, n)

    def _drain_guard(self, m: FleetMember) -> None:
        g = self.guard
        if g is not None:
            g.drain_deferred(m.app_context)

    def _drain_slo(self) -> None:
        """The autopilot's evaluation slot: runs with NO lock held (same
        contract as the deferred scalar replays), so an actuation may take
        ``manager._lock → group._lock`` in the enrollment order."""
        s = self.slo
        if s is not None:
            s.maybe_evaluate()

    # -- trace handoff across the shared-lane hop --------------------------
    def _register_trace(self, m: FleetMember) -> None:
        """A sampled trace active on the staging thread rides the member's
        pending list until the shared (or solo) step closes its span —
        the fleet analog of the device probe's trace groups."""
        tracer = m.app_context.tracer
        if tracer is None:
            return
        tr = tracer.active
        if tr is not None:
            m.trace_pending.append((tr, time.perf_counter_ns()))

    def _drain_traces(self, m: FleetMember, n: int,
                      outcome: str = "ok") -> None:
        if not m.trace_pending:
            return
        now = time.perf_counter_ns()
        while True:
            try:
                tr, t0 = m.trace_pending.popleft()
            except IndexError:
                break
            tr.add_span("fleet", m.query_name, now - t0, batch_size=n,
                        outcome=outcome)

    def _drain_all_traces(self, n: int, outcome: str = "ok") -> None:
        for m in self.members.values():
            if not m.ejected:
                self._drain_traces(m, n, outcome)

    def _post_stage(self, m: FleetMember) -> None:
        if self.stager.full:
            self._step("full")
            return
        c = self.batch_controller
        if c is not None and len(self.stager) >= c.current:
            self._step("adaptive")
            return
        sw = self.slo_window
        if sw is not None and len(self.stager) >= sw:
            self._step("slo")
            return
        g = self.guard
        if g is not None and g.fair_share_flush_due(m):
            self._step("fair_share")

    def effective_window(self) -> int:
        """The flush window fair-share quotas divide: the static capacity
        capped by the adaptive AIMD threshold (when a controller is
        attached) and by the SLO autopilot's window cap (when armed)."""
        w = self.capacity
        c = self.batch_controller
        if c is not None:
            w = min(w, c.current)
        if self.slo_window is not None:
            w = min(w, self.slo_window)
        return w

    def make_stager(self):
        """A PRIVATE stager over the group's shared schema (same dictionary
        tables, so codes stay comparable) — the guard's solo tier stages
        an ejected tenant's rows here."""
        if self.kind == "stream":
            return HostRowStager(self.schema, None, self.capacity)
        return HostRowStager(self.schema, dict(self._stream_defs),
                             self.capacity,
                             used_cols=self.plan.compiler.used_cols)

    def stream_defs_for(self, gsid: str):
        d = self._stream_defs.get(gsid)
        if d is None and self.kind == "stream":
            return self.schema.definition
        return d

    def flush(self, cause: str = "drain") -> None:
        with self._lock:
            if len(self.stager):
                self._step(cause)
            g = self.guard
            if g is not None:
                for m in list(self.members.values()):
                    lane = g.lanes.get(m.mid)
                    if lane is None:
                        continue
                    if m.ejected or (lane.solo_stager is not None
                                     and len(lane.solo_stager)):
                        g.flush_solo(m, lane, cause)

    # -- the stepped program ----------------------------------------------
    def _param_luts(self) -> list:
        """Member-id → value lookup tables, one per parameter slot — cached
        (membership changes only under the group lock, which invalidates)."""
        luts = self._luts
        if luts is None:
            width = max(self._next_mid, 1)
            luts = []
            for i, spec in enumerate(self.param_specs):
                lut = torch.zeros(width, dtype=_param_dtype(spec))
                for m in self.members.values():
                    lut[m.mid] = m.params[i]
                luts.append(lut)
            self._luts = luts
        return luts

    def _param_cols_for(self, mids: torch.Tensor) -> dict:
        """Per-row parameter columns: value table gathered by member id."""
        if not self.param_specs:
            return {}
        return {f"__fleet_p{spec.index}": lut[mids]
                for spec, lut in zip(self.param_specs, self._param_luts())}

    def _inject_member_params(self, cols: dict, m: FleetMember,
                              n: int) -> None:
        for spec, val in zip(self.param_specs, m.params):
            cols[f"__fleet_p{spec.index}"] = torch.full(
                (n,), val, dtype=_param_dtype(spec))

    def _step(self, cause: str) -> None:
        # fill span: first-stage → flush wall clock of this window (read
        # and reset up front so swept windows clear it too)
        t_flush = time.perf_counter()
        fill_span = t_flush - self._window_t0 \
            if self._window_t0 is not None else 0.0
        self._window_t0 = None
        g = self.guard
        b = g.emit(self.stager) if g is not None else self.stager.emit()
        b = _torch_batch(b)
        mids = b["mid"]
        if g is not None:
            with one_intraop_thread():
                b, mids = g.sweep_nonfinite(b, mids)
        n = b["count"]
        if n == 0:
            if g is not None:
                g.on_window_reset()
            # the whole window was swept/diverted: pending traces still
            # close (outcome says so) instead of bleeding into a later step
            self._drain_all_traces(0, outcome="swept")
            return
        self.steps += 1
        self.events_in += n
        self.flush_causes[cause] = self.flush_causes.get(cause, 0) + 1
        t0 = time.perf_counter()
        with one_intraop_thread(), collector_deferred():
            if self.mode == "batched":
                if g is not None:
                    g.step_batched(b, mids)
                else:
                    self._run_batched(b, mids)
            else:
                self._step_sliced(b, mids)
        dt = time.perf_counter() - t0
        c = self.batch_controller
        if c is not None:
            c.observe(n, dt)
        s = self.slo
        if s is not None:
            # the autopilot's windowed evidence: fill span + step time per
            # shared window (decisions read interval snapshots of these)
            s.on_step(n, fill_span, dt)
        # every in-group member's pending traces close with a 'fleet' span
        # once the shared step consumed the window they staged into
        self._drain_all_traces(n)

    def _run_batched(self, b: dict, mids: torch.Tensor) -> None:
        self._deliver_batched(self._compute_batched(b, mids))

    def _compute_batched(self, b: dict, mids: torch.Tensor) -> list:
        """One vectorized step over every tenant's rows at once (stateless
        stream shapes): per-tenant constants ride as gathered per-row
        parameter columns; outputs demux by member id. Returns the demuxed
        deliveries ``[(member, ts_list, rows)]`` WITHOUT delivering — the
        guard wraps only this compute phase, so a downstream receiver
        raising during delivery is never mistaken for a tenant-lane fault
        (which would replay already-delivered rows)."""
        cols = dict(b["cols"])
        cols.update(self._param_cols_for(mids))
        _st, res = self.plan.hq.step({}, cols, b["ts"])
        involved, counts = member_counts(mids)
        self.lanes_last_step = len(involved)
        for mid, cnt in zip(involved, counts):
            m = self.members.get(int(mid))
            if m is not None:
                m.events_in += int(cnt)
                m.batches += 1
        j = res.get("j")
        if j is None or j.numel() == 0:
            return []
        ts_list, rows = self.plan.hq.decode(res)       # batched decode
        out_mid = mids[j]
        order = torch.sort(out_mid, stable=True).indices
        sorted_mid = out_mid[order]
        starts = segment_starts(sorted_mid)
        order = order.tolist()
        sorted_mid = sorted_mid.tolist()
        deliveries = []
        for si in range(len(starts) - 1):
            lo, hi = starts[si], starts[si + 1]
            if lo == hi:
                continue
            m = self.members.get(int(sorted_mid[lo]))
            if m is None or m.bridge is None:
                continue              # member left with rows in flight
            idx = order[lo:hi]
            deliveries.append((m, [ts_list[i] for i in idx],
                               [rows[i] for i in idx]))
        return deliveries

    @staticmethod
    def _deliver_batched(deliveries: list) -> None:
        for m, ts_list, rows in deliveries:
            m.bridge.deliver(ts_list, rows)

    def _step_sliced(self, b: dict, mids: torch.Tensor) -> None:
        """One step iterating member lanes of the merged batch (stateful
        shapes): stable member segments preserve per-tenant event order.
        Under a guard each segment runs contained — the faulting segment IS
        the culprit, co-tenants' segments are untouched."""
        g = self.guard
        if g is not None:
            g.begin_sliced_step(mids)
        try:
            order = torch.sort(mids, stable=True).indices
            sorted_mid = mids[order]
            starts = segment_starts(sorted_mid)
            lanes = 0
            cols_all = b["cols"]
            for si in range(len(starts) - 1):
                lo, hi = starts[si], starts[si + 1]
                if lo == hi:
                    continue
                m = self.members.get(int(sorted_mid[lo]))
                if m is None:
                    continue
                lanes += 1
                idx = order[lo:hi]
                cols_m = {k: v[idx] for k, v in cols_all.items()}
                self._inject_member_params(cols_m, m, idx.numel())
                ts_m = b["ts"][idx]
                tag_m = b["tag"][idx]
                if g is not None:
                    g.step_segment(m, cols_m, tag_m, ts_m)
                else:
                    self._run_segment(m, cols_m, tag_m, ts_m)
            self.lanes_last_step = lanes
        finally:
            if g is not None:
                g.end_sliced_step()

    def _run_segment(self, m: FleetMember, cols_m: dict, tag_m,
                     ts_m) -> None:
        self._deliver_segment(m, self._compute_segment(m, cols_m, tag_m,
                                                       ts_m))

    def _compute_segment(self, m: FleetMember, cols_m: dict, tag_m,
                         ts_m):
        """One member's slice of the batch through the shared program
        against its own state — also the guard's solo-tier execution path
        (a private stager feeds the same call with the member alone).
        Returns ``(ts_list, rows)`` WITHOUT delivering: the guard wraps
        only this state-advancing compute, so a downstream receiver
        raising during delivery cannot be mistaken for a tenant-lane fault
        (which would double-count the already-advanced state)."""
        nseg = ts_m.numel() if isinstance(ts_m, torch.Tensor) else ts_m.size
        if self.kind == "stream":
            m.state, res = self.plan.hq.step(m.state, cols_m, ts_m)
            ts_list, rows = self.plan.hq.decode(res)
            m.events_in += nseg
            m.batches += 1
            return ts_list, rows
        if self.kind == "nfa":
            m.state, outs = self.plan.engine.step(
                m.state, cols_m, tag_m, ts_m)
            m.events_in += nseg
            m.batches += 1
            if outs and outs["j"].numel():
                rows = decode_columns(self.plan.engine.out_specs, outs,
                                      self.dictionaries)
                return outs["ts"].tolist(), rows
            return [], []
        # partition
        _j, outs = m.prt.process(
            {"cols": cols_m, "ts": ts_m, "count": nseg})
        m.events_in += nseg
        m.batches += 1
        if outs:
            return outs["ts"].tolist(), m.prt.decode(outs)
        return [], []

    @staticmethod
    def _deliver_segment(m: FleetMember, out) -> None:
        ts_list, rows = out
        if rows and m.bridge is not None:
            m.bridge.deliver(ts_list, rows)

    def report(self) -> dict:
        with self._lock:
            out = {"shape": self.shape_key, "kind": self.kind,
                   "mode": self.mode, "members": len(self.members),
                   "steps": self.steps, "events": self.events_in,
                   "lanes_last_step": self.lanes_last_step,
                   "staged": len(self.stager),
                   "flush_causes": dict(self.flush_causes)}
            if self.guard is not None:
                out["guard"] = self.guard.report()
            if self.batch_controller is not None:
                out["adaptive"] = self.batch_controller.report()
            if self.slo is not None:
                out["slo"] = self.slo.report()
            return out
