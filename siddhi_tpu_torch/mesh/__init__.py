"""Mesh fabric: tenant placement & live migration across engine shards.

Fuses the two halves that existed separately — single-process fleet lanes
(shared compilation, lane batching, FleetGuard, the SLO autopilot) and DCN
lane-groups with failover — into one placement layer:

- :mod:`plan` — :class:`MeshPlan` / :class:`PlacementPolicy`: tenants get
  ``(host, lane-group, device)`` slots, locality-aware by shape
  fingerprint, with evidence-fed capacity scoring;
- :mod:`fabric` — :class:`MeshFabric`: host shards, exactly-once ingress
  routing, live tenant migration over the snapshot-store/adoption
  machinery, host join/leave elasticity, the SLO autopilot's cross-host
  ``mesh_replace`` rung;
- :mod:`rebalancer` — :class:`MeshRebalancer`: one move per decision,
  recorded with its evidence before actuating.

``MeshConfig(mode='process')`` swaps the in-process host shards for REAL
OS processes (:mod:`siddhi_tpu_torch.procmesh`): each host is its own
interpreter behind a control socket, supervised with heartbeats and
backoff-paced restarts — the same fabric ladder, byte-compatible, with
actual SIGKILL chaos instead of simulated kills; ``durable=True`` adds
the parent's journal.

The port's copy of the JAX package's ``mesh`` package: each host is a
``SiddhiManager`` on the fabric's device (the card by default, host ``i``
on ``cuda:(i mod device_count())``; ``device="cpu"`` for the plain
versions), in the fabric's process or in a worker process of its own.
"""

from .fabric import MeshChaosFault, MeshConfig, MeshFabric, MeshHost
from .plan import (
    HostSlot,
    MeshPlan,
    MeshSlot,
    PlacementPolicy,
    TenantSpec,
    shape_fingerprint,
)
from .rebalancer import MeshRebalancer

__all__ = [
    "HostSlot",
    "MeshChaosFault",
    "MeshConfig",
    "MeshFabric",
    "MeshHost",
    "MeshPlan",
    "MeshRebalancer",
    "MeshSlot",
    "PlacementPolicy",
    "TenantSpec",
    "shape_fingerprint",
]
