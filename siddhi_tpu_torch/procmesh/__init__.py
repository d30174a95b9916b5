"""procmesh — process-per-host mesh runtime.

The port's copy of the JAX package's ``procmesh/``. Each mesh host runs as
its OWN OS process (its own interpreter, GIL and, on the card, its own
CUDA context); ``MeshFabric`` becomes a control plane over length-prefixed
sockets. ``MeshConfig(mode='process')`` arms it; the fabric's placement/
migration/rebalance/``mesh_replace`` ladder is byte-compatible with the
in-process mode, and a SIGKILLed child recovers through the SAME
``kill_host``/``recover_tenant`` path the simulated chaos tests exercise.

Layers:

- :mod:`.protocol` — the frame wire (kind u8 · len u32 · crc32 · seq ·
  json+body) plus the deadline discipline every read arms, wire chaos and
  the workers' runfiles;
- :mod:`.worker` — the child entrypoint: SiddhiManager (on the worker's
  device) + FleetManager + optional DCN worker behind one control socket,
  seq-deduped ingest and a cursored output outbox for exactly-once under
  lost acks;
- :mod:`.supervisor` — spawns/monitors/restarts workers, each with its
  device (PeerHealth heartbeats, exponential backoff with a windowed
  give-up budget);
- :mod:`.journal` — the durable control plane: a CRC-framed mutation
  journal (intent logged BEFORE actuation) + checkpoint/compaction, so a
  SIGKILLed *parent* restarts, re-adopts still-live workers via their
  runfiles and resolves in-flight migrations to exactly one owner;
- :mod:`.host` — the fabric-side ``MeshHost``/runtime duck types;
- :mod:`.parentmain` — a killable durable parent for chaos runs;
- :mod:`.lanepool` — ``@app:host_batch(workers.mode='process')``:
  lane-shard children for the columnar host tier.
"""

from __future__ import annotations

from .host import ProcMeshHost, RuntimeProxy, WorkerClient
from .journal import FabricJournal
from .lanepool import LanePoolError, ProcessLanePool
from .protocol import (
    CONNECT_TIMEOUT_S,
    IO_TIMEOUT_S,
    READY_TIMEOUT_S,
    WorkerDown,
    WorkerOpError,
)
from .supervisor import ProcMeshSupervisor, SupervisorConfig, WorkerSpawnError

__all__ = [
    "CONNECT_TIMEOUT_S",
    "IO_TIMEOUT_S",
    "READY_TIMEOUT_S",
    "FabricJournal",
    "LanePoolError",
    "ProcMeshHost",
    "ProcMeshSupervisor",
    "ProcessLanePool",
    "RuntimeProxy",
    "SupervisorConfig",
    "WorkerClient",
    "WorkerDown",
    "WorkerOpError",
    "WorkerSpawnError",
]
