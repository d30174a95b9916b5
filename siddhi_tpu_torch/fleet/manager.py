"""FleetManager: cross-app enrollment, the shared plan cache, metrics.

One FleetManager per
:class:`~siddhi_tpu_torch.core.context.SiddhiContext` (i.e.
per SiddhiManager): ``@app:fleet`` apps enroll their queries here at build
time. Enrollment normalizes the query (``shape.py``), resolves the shape's
compiled plan through the plan cache (one compile per shape per backend),
and joins the shape's
:class:`~siddhi_tpu_torch.fleet.group.FleetGroup` as a new
tenant lane. Anything that does not normalize or lower falls back PER QUERY
to the existing solo paths (device / columnar host / scalar interpreter) —
one exotic tenant never poisons the fleet.

The port's copy of the JAX package's ``fleet/manager.py``. The shared
columnar plans are the compilers' ``host=True`` form (the reference's
``backend="numpy"``), stepped on the CPU whatever the engine's device; the
shared device plan of a shape (``device_plan``) is ``CompiledStreamQuery``
or ``DeviceNFACompiler`` on the engine's device: the Hopper kernels on the
card, their plain versions for ``SiddhiManager(device="cpu")``. Per-tenant
constants reach either as ``__fleet_p{i}`` columns.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from ..query_api import Query, SingleInputStream, StateInputStream
from ..query_api.annotation import find_annotation
from ..gpu.expr_compile import DeviceCompileError
from .cache import PlanCache
from .group import FleetGroup, FleetMemberState, FleetQueryBridge
from .shape import (
    FleetShapeError,
    NormalizedQuery,
    normalize_partition_query,
    normalize_query,
)

log = logging.getLogger("siddhi_tpu_torch.fleet")

_DEF_BATCH = 8192
_DEF_LANES = 16


def fleet_config(app_annotations) -> Optional[dict]:
    """App-level opt-in (``@app:fleet`` or SIDDHI_FLEET=1) → config dict.

    Guard/fair-share surface: ``weight`` and ``max_lag_events`` are
    PER-TENANT knobs (this app's lanes); ``guard``, ``guard.threshold``,
    ``guard.cooldown.ms``, ``guard.readmit.batches``, ``harden`` and
    ``dict.cap`` configure the shape group's FleetGuard and are taken from
    the group's FIRST enrolling tenant.

    SLO surface (the autopilot, :mod:`siddhi_tpu_torch.observability.slo`):
    ``slo.p99.ms`` and ``slo.class`` ('premium'|'standard'|'besteffort')
    are PER-TENANT declarations; ``slo.interval.ms``, ``slo.cooldown.ms``,
    ``slo.window.min`` and ``slo.dominance`` tune the group's controller
    (first enrolling tenant, like the guard knobs). Raises ValueError on a
    malformed class (the app build wraps it)."""
    ann = find_annotation(app_annotations, "fleet")
    if ann is None and os.environ.get("SIDDHI_FLEET", "") != "1":
        return None
    cfg = {"batch": _DEF_BATCH, "lanes": _DEF_LANES}
    if ann is not None:
        if ann.get("enable") and ann.get("enable").lower() == "false":
            return None
        if ann.get("batch"):
            cfg["batch"] = int(ann.get("batch"))
        if ann.get("lanes"):
            cfg["lanes"] = int(ann.get("lanes"))
        if ann.get("cache"):
            cfg["cache"] = int(ann.get("cache"))
        if ann.get("weight"):
            cfg["weight"] = float(ann.get("weight"))
        if ann.get("max_lag_events"):
            cfg["max_lag_events"] = int(ann.get("max_lag_events"))
        if ann.get("guard"):
            cfg["guard"] = ann.get("guard").lower() != "false"
        if ann.get("guard.threshold"):
            cfg["guard_threshold"] = int(ann.get("guard.threshold"))
        if ann.get("guard.cooldown.ms"):
            cfg["guard_cooldown_s"] = \
                float(ann.get("guard.cooldown.ms")) / 1000.0
        if ann.get("guard.readmit.batches"):
            cfg["guard_readmit_batches"] = \
                int(ann.get("guard.readmit.batches"))
        if ann.get("harden"):
            cfg["harden"] = ann.get("harden").lower() != "false"
        if ann.get("dict.cap"):
            cfg["dict_cap"] = int(ann.get("dict.cap"))
        from ..observability.slo import parse_slo_fleet_keys
        parse_slo_fleet_keys(ann, cfg)
    return cfg


class _StreamPlan:
    """Shared columnar plan for a single-stream shape."""

    def __init__(self, normalized: NormalizedQuery, stream_defs: dict):
        from ..gpu.host_exec import HostStreamQuery
        from ..gpu.query_compile import CompiledStreamQuery
        ist = normalized.query.input_stream
        d = stream_defs.get(ist.stream_id)
        if d is None:
            raise DeviceCompileError(f"undefined stream '{ist.stream_id}'")
        self.compiled = CompiledStreamQuery(normalized.query, d, host=True)
        self.hq = HostStreamQuery(self.compiled)
        self.stateless = self.hq.init_state() == {}


class _NFAPlan:
    """Shared columnar plan for a pattern/sequence shape."""

    def __init__(self, normalized: NormalizedQuery, stream_defs: dict):
        from ..gpu.host_exec import HostBlockNFA
        from ..gpu.nfa import DeviceNFACompiler
        self.compiler = DeviceNFACompiler(normalized.query, dict(stream_defs),
                                          host=True)
        self.engine = HostBlockNFA(self.compiler)


class _PartitionPlan:
    """Shared columnar plan for a partitioned-pattern shape (key equality
    injected, so lane-local NFA semantics are per key)."""

    def __init__(self, normalized: NormalizedQuery, stream_defs: dict):
        from ..gpu.host_exec import HostBlockNFA
        from ..gpu.nfa import DeviceNFACompiler
        from ..gpu.partition import _inject_key_equality
        self.key_attr = normalized.overrides["key_attr"]
        query = _inject_key_equality(normalized.query, self.key_attr)
        self.compiler = DeviceNFACompiler(query, dict(stream_defs),
                                          host=True)
        if len(self.compiler.merged.stream_ids) != 1:
            raise DeviceCompileError(
                "partitioned fleet shapes cover single-stream patterns")
        self.engine = HostBlockNFA(self.compiler)
        self.stream_defs = dict(stream_defs)


_FALLBACK_LOG_CAP = 100

# Bounded reason taxonomy for the Prometheus counter family
# ``siddhi_tpu_fleet_fallbacks_total{reason=...}``: the free-text reasons
# kept in ``fallback_reasons`` embed exception text (unbounded label
# cardinality), so the exposition buckets them into a fixed vocabulary.
FALLBACK_REASON_SLUGS = ("no_fleet_shape", "shape_does_not_lower", "other")


def _fallback_slug(reason: str) -> str:
    if reason.startswith("no fleet shape"):
        return "no_fleet_shape"
    if reason.startswith("shape does not lower"):
        return "shape_does_not_lower"
    return "other"


class FleetManager:
    """``device`` is the engine's (``SiddhiContext.device``): where
    ``device_plan`` builds the shared device programs."""

    def __init__(self, cache_size: int = 256, device=None):
        self.device = device
        self.plan_cache = PlanCache(cache_size)
        self.groups: dict[str, FleetGroup] = {}
        # SLO-autopilot split siblings: same shape_key as a primary group,
        # tracked separately so new tenants keep joining the primary while
        # split-off lanes live out their own group lifecycle
        self.split_groups: list[FleetGroup] = []
        self._lock = threading.RLock()
        self.fallbacks = 0
        self.enrolled = 0
        # solo-fallback evidence: fleets must not degrade
        # silently — every enrollment that kept the solo path is counted
        # and its reason kept for GET /siddhi-apps/{name}/fleet
        self.fallback_reasons: list[dict] = []
        self.fallback_counts: dict[str, int] = {
            slug: 0 for slug in FALLBACK_REASON_SLUGS}

    def _note_fallback(self, app: str, name: str, reason: str) -> None:
        self.fallbacks += 1
        self.fallback_counts[_fallback_slug(reason)] += 1
        self.fallback_reasons.append(
            {"app": app, "query": name, "reason": reason})
        del self.fallback_reasons[:-_FALLBACK_LOG_CAP]

    # ------------------------------------------------------------------ enroll
    def enroll_query(self, query: Query, app_context, stream_defs: dict,
                     get_junction, name: str,
                     cfg: dict) -> Optional[FleetQueryBridge]:
        """Fleet bridge for one top-level query, or None → solo paths."""
        if "cache" in cfg:
            # a tenant annotation may only GROW the engine-wide cache —
            # shrinking it would let one app evict co-tenants' cached plans
            # (operators resize downward via manager.fleet.plan_cache)
            self.plan_cache.max_entries = max(self.plan_cache.max_entries,
                                              int(cfg["cache"]))
        try:
            normalized = normalize_query(query, stream_defs)
        except FleetShapeError as e:
            self._note_fallback(app_context.name, name,
                                f"no fleet shape: {e}")
            log.info("query '%s' keeps the solo path (no fleet shape): %s",
                     name, e)
            return None
        return self._join(normalized, query, app_context, stream_defs,
                          get_junction, name, cfg)

    def enroll_partition(self, partition_ast, app_context, stream_defs: dict,
                         get_junction, name: str,
                         cfg: dict) -> Optional[list]:
        """Fleet bridges for a ``partition with`` block of pattern queries —
        all-or-nothing per block (mirrors the solo columnar partition
        contract); None → the per-key interpreter / solo columnar path."""
        if "cache" in cfg:
            # a tenant annotation may only GROW the engine-wide cache —
            # shrinking it would let one app evict co-tenants' cached plans
            # (operators resize downward via manager.fleet.plan_cache)
            self.plan_cache.max_entries = max(self.plan_cache.max_entries,
                                              int(cfg["cache"]))
        plans = []
        try:
            for i, q in enumerate(partition_ast.queries):
                qname = q.name() or f"{name}-query-{i}"
                normalized = normalize_partition_query(partition_ast, q,
                                                       stream_defs)
                plans.append((normalized, q, qname))
        except FleetShapeError as e:
            self._note_fallback(app_context.name, name,
                                f"no fleet shape: {e}")
            log.info("partition '%s' keeps the solo path (no fleet shape): "
                     "%s", name, e)
            return None
        bridges = []
        for normalized, q, qname in plans:
            bridge = self._join(normalized, q, app_context, stream_defs,
                                get_junction, qname, cfg)
            if bridge is None:
                for b in bridges:      # roll back partial joins
                    self.release_member(b)
                return None
            bridges.append(bridge)
        return bridges

    def _join(self, normalized: NormalizedQuery, query: Query, app_context,
              stream_defs: dict, get_junction, name: str,
              cfg: dict) -> Optional[FleetQueryBridge]:
        from ..core.host_bridge import _audit_query_surface
        try:
            target = _audit_query_surface(query, app_context, get_junction)
            with self._lock:
                group = self.groups.get(normalized.shape_key)
                if group is None:
                    entry = self.plan_cache.get(
                        normalized.shape_key, "numpy",
                        lambda: self._build_plan(normalized, stream_defs))
                    group = FleetGroup(
                        normalized.shape_key, normalized.kind, entry.plan,
                        cfg, normalized.stream_ids, stream_defs,
                        normalized.param_specs)
                    if cfg.get("guard", True):
                        from ..resilience.fleet_guard import FleetGuard
                        group.guard = FleetGuard(group, cfg)
                    if app_context.adaptive_cfg is not None:
                        # @app:adaptive of the first enrolling tenant sizes
                        # the group's shared flush window (AIMD); fair-share
                        # quotas divide whatever window it picks
                        from ..flow.adaptive_batch import \
                            AdaptiveBatchController
                        acfg = dict(app_context.adaptive_cfg)
                        acfg["max_batch"] = min(
                            acfg.get("max_batch", group.capacity),
                            group.capacity)
                        acfg["min_batch"] = min(acfg.get("min_batch", 64),
                                                acfg["max_batch"])
                        group.batch_controller = \
                            AdaptiveBatchController(**acfg)
                        # group-window resizes are every tenant's story:
                        # fan the flight-recorder hook out to all members
                        from .group import GroupFlight
                        group.batch_controller.flight = GroupFlight(group)
                        group.batch_controller.site = \
                            f"fleet:{normalized.shape_key[:40]}"
                    self.groups[normalized.shape_key] = group
                    self.plan_cache.pin(normalized.shape_key, "numpy")
                else:
                    self.plan_cache.get(
                        normalized.shape_key, "numpy",
                        lambda: group.plan)        # count the shape-cache hit
        except DeviceCompileError as e:
            self._note_fallback(app_context.name, name,
                                f"shape does not lower: {e}")
            log.info("query '%s' keeps the solo path (shape does not "
                     "lower): %s", name, e)
            return None
        # local_sids are THIS tenant's stream ids in canonical walk order;
        # receiver_for maps them positionally onto the group's canonical
        # (builder tenant) ids — positions align because both tenants walked
        # the same shape
        member = group.add_member(
            app_context.name, name, app_context, target,
            normalized.param_values, normalized.overrides,
            list(normalized.stream_ids))
        # guard surface: fair-share knobs are per tenant; the member's own
        # app chaos injector targets its own lanes (fleet.fault.p), and the
        # scalar-escalation ladder needs the original query + junctions
        member.weight = float(cfg.get("weight", 1.0))
        member.max_lag = int(cfg.get("max_lag_events", 0))
        runtime = getattr(app_context, "runtime", None)
        resilience = getattr(runtime, "resilience", None)
        member.chaos = getattr(resilience, "chaos", None)
        member.query = query
        member.solo_stream_defs = dict(stream_defs)
        member.get_junction = get_junction
        bridge = FleetQueryBridge(group, member)
        app_context.register_state(f"fleet-{name}",
                                   FleetMemberState(member))
        # SLO autopilot: a declared budget/class arms the group's closed
        # loop (first tenant's slo.* controller knobs, like the guard's)
        if "slo_p99_ms" in cfg or "slo_class" in cfg:
            from ..observability.slo import SLOController, TenantSLO
            with self._lock:
                if group.slo is None:
                    group.slo = SLOController(group, self, cfg)
                slo = TenantSLO(member, cfg.get("slo_p99_ms"),
                                cfg.get("slo_class", "standard"))
                group.slo.attach(member, slo)
            self._register_slo_metrics(app_context, member)
        self._register_metrics(app_context, group, member)
        self.enrolled += 1
        return bridge

    def _build_plan(self, normalized: NormalizedQuery, stream_defs: dict):
        if normalized.kind == "stream":
            return _StreamPlan(normalized, stream_defs)
        if normalized.kind == "nfa":
            return _NFAPlan(normalized, stream_defs)
        return _PartitionPlan(normalized, stream_defs)

    # -------------------------------------------------------------- device tier
    def device_plan(self, normalized: NormalizedQuery, stream_defs: dict):
        """Shared DEVICE program for a shape — same cache, the reference's
        backend label 'jax'. N homogeneous tenants cost one compile (one
        kernel plan on the engine's device: the Hopper kernels on the card,
        their plain versions on the CPU); per-tenant constants are injected
        as ``__fleet_p*`` batch columns, which each kernel reads as event
        columns (a plan over a kernel's column limit is refused here, with
        ``DeviceCompileError``)."""
        dev = self.device

        def build():
            if normalized.kind == "stream":
                from ..gpu.query_compile import CompiledStreamQuery
                ist = normalized.query.input_stream
                return CompiledStreamQuery(normalized.query,
                                           stream_defs[ist.stream_id],
                                           device=dev)
            from ..gpu.nfa import DeviceNFACompiler
            query = normalized.query
            if normalized.kind == "partition":
                from ..gpu.partition import _inject_key_equality
                query = _inject_key_equality(
                    query, normalized.overrides["key_attr"])
            return DeviceNFACompiler(query, dict(stream_defs), device=dev)

        return self.plan_cache.get(normalized.shape_key, "jax", build).plan

    # ------------------------------------------------------------------ split
    def split_group(self, group: FleetGroup,
                    move: list) -> Optional[FleetGroup]:
        """The SLO autopilot's split actuator: move ``move`` members into a
        sibling group over the same cached plan (lock order matches
        enrollment: ``manager._lock → group._lock``). The sibling gets its
        own controller when any moved lane declared an SLO; moved lanes
        keep their TenantSLO objects."""
        with self._lock:
            with group._lock:
                movable = [m for m in move if m.mid in group.members]
                if not movable or len(movable) >= len(group.members):
                    return None
                sibling = group.split(movable)
            self.split_groups.append(sibling)
            slo = group.slo
            if slo is not None:
                moved = [(m, m.slo) for m in movable
                         if getattr(m, "slo", None) is not None]
                for m, _t in moved:
                    slo.detach(m)
                if moved:
                    from ..observability.slo import SLOController
                    sibling.slo = SLOController(sibling, self, slo.cfg)
                    for m, t in moved:
                        sibling.slo.attach(m, t)
            log.info("fleet group '%s' split: %d lane(s) moved to a "
                     "sibling (%d stay)", group.shape_key[:60],
                     len(movable), len(group.members))
            return sibling

    # ---------------------------------------------------------------- teardown
    def release_member(self, bridge: FleetQueryBridge) -> None:
        group = bridge.group
        with self._lock:
            left = group.remove_member(bridge.member)
            if left == 0:
                if self.groups.get(group.shape_key) is group:
                    self.groups.pop(group.shape_key, None)
                    self.plan_cache.unpin(group.shape_key, "numpy")
                elif group in self.split_groups:
                    self.split_groups.remove(group)

    def release_app(self, app_name: str) -> int:
        """Detach every member of one tenant app (app shutdown); the shared
        plans stay cached (unpinned when their group empties) for the next
        tenant of the shape. Returns members released."""
        released = 0
        with self._lock:
            for group in list(self.groups.values()) + list(self.split_groups):
                for m in [m for m in group.members.values()
                          if m.app_context.name == app_name]:
                    self.release_member(m.bridge)
                    released += 1
        return released

    # ----------------------------------------------------------------- metrics
    def _register_metrics(self, app_context, group: FleetGroup,
                          member) -> None:
        sm = app_context.statistics_manager
        if sm is None:
            return
        q = member.query_name
        sm.gauge_tracker(f"fleet.{q}.events", lambda m=member: m.events_in)
        sm.gauge_tracker(f"fleet.{q}.batches", lambda m=member: m.batches)
        sm.gauge_tracker(f"fleet.{q}.ev_per_s", lambda m=member: m.ev_per_s)
        sm.gauge_tracker(f"fleet.{q}.lanes_per_step",
                         lambda g=group: g.lanes_last_step)
        sm.gauge_tracker(f"fleet.{q}.group_members",
                         lambda g=group: len(g.members))
        # shape-cache counters surface per app so one tenant's scrape sees
        # fleet-wide compile amortization
        sm.gauge_tracker("fleet.shape_cache.hits",
                         lambda c=self.plan_cache: c.hits)
        sm.gauge_tracker("fleet.shape_cache.misses",
                         lambda c=self.plan_cache: c.misses)
        sm.gauge_tracker("fleet.shape_cache.evictions",
                         lambda c=self.plan_cache: c.evictions)
        # solo-fallback evidence: fleets must not degrade silently
        sm.gauge_tracker("fleet.solo_fallbacks", lambda s=self: s.fallbacks)
        # bounded reason taxonomy:
        # renders as siddhi_tpu_fleet_fallbacks_total{reason=...} — the
        # slug vocabulary is fixed, so label cardinality stays bounded
        for slug in FALLBACK_REASON_SLUGS:
            sm.gauge_tracker(f"fleet.fallbacks.{slug}",
                             lambda s=self, g=slug: s.fallback_counts[g])
        # guard families (fleet.tenant.*): ejection/readmit/shed evidence
        # per tenant lane — torn down with the rest of the fleet.* family
        # on app shutdown (StatisticsManager.unregister("fleet."))
        lane = member.lane
        if lane is not None:
            sm.gauge_tracker(f"fleet.tenant.{q}.ejections",
                             lambda x=lane: x.ejections)
            sm.gauge_tracker(f"fleet.tenant.{q}.readmissions",
                             lambda x=lane: x.readmissions)
            sm.gauge_tracker(f"fleet.tenant.{q}.shed",
                             lambda x=lane: x.shed)
            sm.gauge_tracker(f"fleet.tenant.{q}.poisoned",
                             lambda x=lane: x.poisoned)
            sm.gauge_tracker(f"fleet.tenant.{q}.solo_batches",
                             lambda x=lane: x.solo_batches)
            sm.gauge_tracker(f"fleet.tenant.{q}.circuit_state",
                             lambda x=lane: x.breaker.state_code)
            sm.gauge_tracker(f"fleet.tenant.{q}.arrival_evps",
                             lambda x=lane: x.arrival_evps)

    def _register_slo_metrics(self, app_context, member) -> None:
        """``slo.*`` compliance gauges on the member app (rendered as
        ``siddhi_tpu_slo_*{app,query}`` families; torn down with the
        app's ``slo.`` prefix on shutdown). Gauges read through
        ``member.group`` so a split keeps them live."""
        sm = app_context.statistics_manager
        if sm is None:
            return
        q = member.query_name

        def _slo(mm=member):
            return mm.slo

        sm.gauge_tracker(f"slo.{q}.p99_budget_ms",
                         lambda: (_slo().p99_budget_ms or 0.0))
        sm.gauge_tracker(f"slo.{q}.p99_window_ms",
                         lambda: round(_slo().last_p99_ms, 3))
        sm.gauge_tracker(f"slo.{q}.compliant",
                         lambda: 1 if _slo().compliant else 0)
        sm.gauge_tracker(f"slo.{q}.class_code", lambda: _slo().class_code)
        sm.gauge_tracker(f"slo.{q}.shed_hold",
                         lambda: 1 if _slo().shed_hold else 0)
        sm.gauge_tracker(
            f"slo.{q}.decisions_total",
            lambda m=member: m.group.slo.decisions
            if m.group is not None and m.group.slo is not None else 0)

    def mesh_evidence(self) -> dict:
        """Aggregate fleet-tier pressure for the mesh placement scorer
        (the JAX package's ``mesh/``, still to port): events/lane-packing
        plus the guard and SLO
        evidence (sheds, ejections, violated budgets) that mark a
        struggling host. Group/member walks are snapshotted under the
        manager lock; per-member reads are tolerant of concurrent
        enrollment (the ``_snap`` discipline of the SLO controller)."""
        with self._lock:
            groups = list(self.groups.values()) + list(self.split_groups)
        events = sheds = ejections = violations = 0
        lanes_per_step = []
        for g in groups:
            events += g.events_in
            if g.lanes_last_step:
                lanes_per_step.append(g.lanes_last_step)
            for m in list(g.members.values()):
                lane = m.lane
                if lane is not None:
                    sheds += lane.shed
                    ejections += lane.ejections
                slo = getattr(m, "slo", None)
                if slo is not None and not slo.compliant:
                    violations += 1
        return {
            "fleet_groups": len(groups),
            "events_in": events,
            "lanes_per_step": (sum(lanes_per_step) / len(lanes_per_step)
                               if lanes_per_step else 0.0),
            "sheds": sheds,
            "ejections": ejections,
            "slo_violations": violations,
            "compiled_programs": self.plan_cache.stats()["size"],
        }

    def stats(self) -> dict:
        with self._lock:
            groups = {k: g.report() for k, g in self.groups.items()}
            for i, g in enumerate(self.split_groups):
                groups[f"{g.shape_key}#split{i}"] = g.report()
            return {"cache": self.plan_cache.stats(),
                    "groups": groups,
                    "members": sum(len(g.members)
                                   for g in list(self.groups.values())
                                   + self.split_groups),
                    "enrolled": self.enrolled,
                    "fallbacks": self.fallbacks,
                    "fallback_counts": dict(self.fallback_counts),
                    "fallback_reasons": list(self.fallback_reasons)}
