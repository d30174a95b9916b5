"""Query-fleet subsystem: multi-tenant shared compilation + cross-app lane
batching — the port's copy of the JAX package's ``fleet/``.

- :mod:`.shape` — plan fingerprinting: query AST → shape key with constants
  hoisted to per-tenant parameter slots;
- :mod:`.cache` — the shared plan cache (one compiled program per shape per
  backend, LRU over unpinned entries);
- :mod:`.group` — FleetGroup: same-shape tenants batched into extra lanes of
  one stepped columnar program, strict output demux and per-tenant state;
- :mod:`.manager` — FleetManager on the SiddhiManager context: ``@app:fleet``
  enrollment, admission/eviction, ``fleet.*`` metrics, per-query solo
  fallback.
"""

from .cache import PlanCache
from .group import FleetGroup, FleetQueryBridge
from .manager import FleetManager, fleet_config
from .shape import (
    FleetShapeError,
    NormalizedQuery,
    normalize_partition_query,
    normalize_query,
)

__all__ = [
    "FleetGroup",
    "FleetManager",
    "FleetQueryBridge",
    "FleetShapeError",
    "NormalizedQuery",
    "PlanCache",
    "fleet_config",
    "normalize_partition_query",
    "normalize_query",
]
