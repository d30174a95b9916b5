"""procmesh — process-backed execution for the host tiers.

The port's copy of the part of the JAX package's ``procmesh/`` that the
columnar host tier needs:

- :mod:`.protocol` — the frame wire (kind u8 · len u32 · crc32 · seq ·
  json+body) and the deadline discipline every read arms;
- :mod:`.lanepool` — ``@app:host_batch(workers.mode='process')``:
  lane-shard children for the columnar host tier.

The process-per-host mesh runtime (hosts, journal, supervisor, workers)
comes with distribution (``ROADMAP.md`` §A item 8).
"""

from __future__ import annotations

from .lanepool import LanePoolError, ProcessLanePool

__all__ = ["LanePoolError", "ProcessLanePool"]
