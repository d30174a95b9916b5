"""MeshPlan / PlacementPolicy: who runs where, decided by shape.

The mesh's unit of placement is the TENANT (one SiddhiApp); its slot is a
``(host, lane-group, device)`` triple — the host that owns its runtime, the
shape lane-group (its queries' fleet shape fingerprints, which decide WHICH
of the host's FleetGroups its lanes join) and the accelerator device bound
to that host. Placement is **locality-aware by shape fingerprint**
(``fleet/shape.py``): same-shape tenants co-locate into the same host's
FleetGroup, so each host compiles the fewest programs and steps the widest
lane batches (the fleet's economics — N tenants of one shape cost 1 compile
and execute as lanes of one program — only pay off when the N tenants
actually land on one host).

Scoring is evidence-fed: a :class:`PlacementPolicy` consults the per-host
evidence dict the fabric aggregates from ``fleet.*``/``slo.*`` gauges and
the flight recorder (load EMA, eject/shed pressure, SLO violations) so a
struggling host stops attracting tenants before it saturates — the
Hazelcast-Jet lesson (PAPERS.md 2103.10169): move load *before* the node
saturates, not after.

Plans are DATA (compare, diff, recompute): elasticity is
``recompute(current, tenants, hosts)`` — sticky for tenants whose slot
survives, minimal moves for the rest — and the diff of two plans IS the
bulk-adoption work list a host join/leave triggers.

The port's copy of the JAX package's ``mesh/plan.py``: the fingerprint is
the port's own parser and fleet shape normalizer (keys equal to the
reference's), and a host's ``device`` is a CUDA ordinal.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["TenantSpec", "HostSlot", "MeshSlot", "MeshPlan",
           "PlacementPolicy", "shape_fingerprint"]


def shape_fingerprint(app_text_or_parsed, stream_defs: Optional[dict] = None,
                      ) -> tuple:
    """The tenant's placement key: the tuple of its queries' fleet shape
    fingerprints in definition order. Queries with no fleet shape (joins,
    exotic expressions) contribute a ``solo:`` digest of their text — they
    still cluster identical copies, they just never share a program."""
    from ..compiler import parse as _parse
    from ..fleet.shape import (FleetShapeError, normalize_partition_query,
                               normalize_query)
    from ..query_api import Query

    app = _parse(app_text_or_parsed) \
        if isinstance(app_text_or_parsed, str) else app_text_or_parsed
    defs = dict(stream_defs or app.stream_definitions)
    keys = []
    for el in app.execution_elements:
        if isinstance(el, Query):
            try:
                keys.append(normalize_query(el, defs).shape_key)
            except FleetShapeError:
                keys.append(_solo_key(el))
        elif hasattr(el, "queries"):          # partition block
            for q in el.queries:
                try:
                    keys.append(
                        normalize_partition_query(el, q, defs).shape_key)
                except FleetShapeError:
                    keys.append(_solo_key(q))
    return tuple(keys)


def _solo_key(query) -> str:
    digest = hashlib.sha256(repr(query).encode()).hexdigest()[:20]
    return f"solo:{digest}"


@dataclass
class TenantSpec:
    """One tenant as the placement layer sees it."""

    tenant_id: str                      # == the SiddhiApp name
    app_text: str
    shapes: tuple = ()                  # shape_fingerprint() of the app
    weight: float = 1.0                 # fair-share weight (capacity units)

    @property
    def primary_shape(self) -> str:
        return self.shapes[0] if self.shapes else "solo:empty"


@dataclass
class HostSlot:
    """One host of the mesh: capacity in tenant slots plus its device
    binding (the CUDA ordinal this host's engine runs on; ``None`` on the
    CPU). Metadata only: placement never reads it."""

    host: int
    capacity: int
    device: Optional[int] = None


@dataclass(frozen=True)
class MeshSlot:
    """A tenant's assigned ``(host, lane-group, device)`` slot."""

    host: int
    shape: str                          # the lane-group key on that host
    device: Optional[int] = None


@dataclass
class MeshPlan:
    """Assignment of the tenant population to mesh slots (pure data)."""

    assignment: dict = field(default_factory=dict)   # tenant_id -> MeshSlot
    epoch: int = 0
    policy: str = "locality"

    def host_of(self, tenant_id: str) -> Optional[int]:
        slot = self.assignment.get(tenant_id)
        return slot.host if slot is not None else None

    def tenants_of(self, host: int) -> list:
        return sorted(t for t, s in self.assignment.items()
                      if s.host == host)

    def tenants_per_host(self, hosts: list) -> dict:
        return {h.host: len(self.tenants_of(h.host)) for h in hosts}

    def shapes_per_host(self, hosts: list) -> dict:
        """How many DISTINCT shapes each host must compile under this plan —
        the placement-quality number the locality policy minimizes."""
        out: dict = {}
        for h in hosts:
            shapes = {s.shape for t, s in self.assignment.items()
                      if s.host == h.host}
            out[h.host] = len(shapes)
        return out

    def diff(self, other: "MeshPlan") -> list:
        """Moves to turn ``self`` into ``other``:
        ``[(tenant_id, src_host|None, dst_host)]`` — the bulk-adoption work
        list of an elasticity event."""
        moves = []
        for t, slot in other.assignment.items():
            cur = self.assignment.get(t)
            if cur is None or cur.host != slot.host:
                moves.append((t, cur.host if cur else None, slot.host))
        return moves

    def report(self) -> dict:
        hosts: dict = {}
        for t, s in self.assignment.items():
            hosts.setdefault(s.host, []).append(t)
        return {"epoch": self.epoch, "policy": self.policy,
                "tenants": len(self.assignment),
                "hosts": {str(h): sorted(ts) for h, ts in hosts.items()}}


class PlacementPolicy:
    """Shape-locality placement with evidence-fed capacity scoring.

    ``kind='locality'`` (the default): tenants group by primary shape,
    shapes place largest-population first, and each shape's tenants pack
    onto the fewest hosts — preferring hosts that already hold the shape —
    so per-host compiled-program counts stay near (shapes ÷ hosts) and
    FleetGroups step wide. ``kind='random'`` is the control arm the bench
    compares against (seeded shuffle, round-robin over free slots).
    """

    def __init__(self, kind: str = "locality", seed: int = 17):
        if kind not in ("locality", "random"):
            raise ValueError(f"unknown placement policy '{kind}'")
        self.kind = kind
        self.seed = seed

    # -- scoring -------------------------------------------------------------
    @staticmethod
    def _pressure(ev: Optional[dict]) -> float:
        """Evidence → a load penalty in tenant-slot units. ``load_share``
        is the host's share of recently routed rows; ejections/sheds and
        SLO violations (flight-recorder and guard evidence) push the score
        down further so a struggling host stops attracting placements."""
        if not ev:
            return 0.0
        return (4.0 * float(ev.get("load_share", 0.0))
                + 1.0 * min(4, int(ev.get("ejections", 0)))
                + 0.5 * min(4, int(ev.get("slo_violations", 0)))
                + 0.25 * min(4, int(ev.get("sheds", 0)))
                # process-mode only (inproc hosts report no restarts): a
                # worker that has been respawned recently is a worse home
                # — every restart re-pays compile and replay cost
                + 0.5 * min(4, int(ev.get("restarts", 0))))

    def _score(self, host: HostSlot, free: int, has_shape: bool,
               evidence: Optional[dict]) -> tuple:
        # sort key (descending): shape locality first, then free capacity
        # net of evidence pressure, host index as the deterministic tie-break
        ev = (evidence or {}).get(host.host)
        return (1 if has_shape else 0,
                free - self._pressure(ev),
                -host.host)

    # -- placement -----------------------------------------------------------
    def place(self, tenants: list, hosts: list,
              evidence: Optional[dict] = None,
              sticky: Optional[MeshPlan] = None,
              max_keep_per_host: Optional[int] = None) -> MeshPlan:
        """Compute a plan. With ``sticky`` (the current plan), tenants whose
        host survives with capacity keep their slot — elasticity recomputes
        move only what must move. ``max_keep_per_host`` caps the PER-HOST
        fill of this whole recompute at the balanced target (a host join
        passes ⌈tenants ÷ hosts⌉: without a cap on PLACEMENT too, sticky
        retention — and shape locality pulling the overflow right back —
        would leave the newcomer empty)."""
        if not hosts:
            raise ValueError("cannot place tenants on an empty mesh")
        by_host_shapes: dict = {h.host: set() for h in hosts}
        used: dict = {h.host: 0 for h in hosts}
        cap: dict = {h.host: h.capacity if max_keep_per_host is None
                     else min(h.capacity, max_keep_per_host)
                     for h in hosts}
        assignment: dict = {}
        device_of = {h.host: h.device for h in hosts}

        pending = list(tenants)
        if sticky is not None:
            kept = []
            for t in pending:
                slot = sticky.assignment.get(t.tenant_id)
                keep_cap = cap.get(slot.host) if slot is not None else None
                if slot is not None and keep_cap is not None \
                        and used[slot.host] < keep_cap:
                    assignment[t.tenant_id] = MeshSlot(
                        slot.host, t.primary_shape, device_of[slot.host])
                    used[slot.host] += 1
                    by_host_shapes[slot.host].add(t.primary_shape)
                else:
                    kept.append(t)
            pending = kept

        if self.kind == "random":
            rng = random.Random(self.seed)
            order = list(pending)
            rng.shuffle(order)
            hosts_ring = [h.host for h in hosts]
            i = 0
            for t in order:
                for _ in range(len(hosts_ring)):
                    h = hosts_ring[i % len(hosts_ring)]
                    i += 1
                    if used[h] < cap[h]:
                        assignment[t.tenant_id] = MeshSlot(
                            h, t.primary_shape, device_of[h])
                        used[h] += 1
                        by_host_shapes[h].add(t.primary_shape)
                        break
                else:
                    raise ValueError("mesh capacity exhausted")
            return MeshPlan(assignment,
                            epoch=(sticky.epoch + 1 if sticky else 0),
                            policy=self.kind)

        # locality: largest shape populations place first so the big
        # fleets get contiguous hosts before the tail fragments them
        by_shape: dict = {}
        for t in pending:
            by_shape.setdefault(t.primary_shape, []).append(t)
        for shape in sorted(by_shape,
                            key=lambda s: (-len(by_shape[s]), s)):
            for t in by_shape[shape]:
                candidates = [h for h in hosts if used[h.host] < cap[h.host]]
                if not candidates:
                    raise ValueError("mesh capacity exhausted")
                best = max(candidates, key=lambda h: self._score(
                    h, cap[h.host] - used[h.host],
                    shape in by_host_shapes[h.host], evidence))
                assignment[t.tenant_id] = MeshSlot(
                    best.host, shape, device_of[best.host])
                used[best.host] += 1
                by_host_shapes[best.host].add(shape)
        return MeshPlan(assignment,
                        epoch=(sticky.epoch + 1 if sticky else 0),
                        policy=self.kind)

    def recompute(self, current: MeshPlan, tenants: list,
                  hosts: list, evidence: Optional[dict] = None,
                  balance: bool = False) -> MeshPlan:
        """Elasticity entry point: re-place against the NEW host set,
        keeping every slot that survives (host still in the mesh, capacity
        still available). With ``balance=True`` each host retains at most
        the balanced target ⌈tenants ÷ hosts⌉ — the overflow re-places, so
        a freshly joined host adopts its share. The caller applies
        ``current.diff(new)``."""
        max_keep = None
        if balance and hosts and tenants:
            max_keep = -(-len(tenants) // len(hosts))
        return self.place(tenants, hosts, evidence, sticky=current,
                          max_keep_per_host=max_keep)
