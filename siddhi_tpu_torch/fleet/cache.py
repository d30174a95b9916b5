"""Shared plan cache: one compiled program per (shape key, backend).

The backend labels are the JAX package's slot names, kept so
``stats()["per_backend"]`` (and ``service.py``'s ``fleet`` endpoint) read
alike in both packages: ``"numpy"`` labels the columnar host plans (here the
compilers' ``host=True`` form, torch on the CPU) and ``"jax"`` the shared
device plans (here ``CompiledStreamQuery``/``DeviceNFACompiler`` on the
engine's device: the Hopper kernels, or their plain versions on the CPU).
The label names the reference's slot; the plan is the port's.

Admission is build-through (``get`` compiles on miss via the caller's
builder), eviction is LRU over UNPINNED entries — a live :class:`FleetGroup`
pins its plan so eviction can never pull a program out from under running
tenants. Failed builds are negative-cached (per shape+backend) so a fleet of
non-lowerable tenants pays ONE compile attempt, not N.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class PlanEntry:
    key: str
    backend: str
    plan: Any
    hits: int = 0
    pins: int = 0
    stamp: int = 0


class PlanCache:
    def __init__(self, max_entries: int = 256):
        self.max_entries = max(1, int(max_entries))
        self._entries: dict[tuple[str, str], PlanEntry] = {}
        self._failed: dict[tuple[str, str], str] = {}
        self._lock = threading.RLock()
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str, backend: str,
            builder: Callable[[], Any]) -> PlanEntry:
        """Cached entry for (key, backend), building on miss. Re-raises the
        builder's exception (and negative-caches it keyed by message)."""
        ck = (key, backend)
        with self._lock:
            e = self._entries.get(ck)
            if e is not None:
                self._clock += 1
                e.stamp = self._clock
                e.hits += 1
                self.hits += 1
                return e
            failed = self._failed.get(ck)
            if failed is not None:
                from ..gpu.expr_compile import DeviceCompileError
                raise DeviceCompileError(failed)
        # compile OUTSIDE the lock (device jit traces can be slow)
        try:
            plan = builder()
        except Exception as ex:
            with self._lock:
                if len(self._failed) > 1024:
                    self._failed.clear()
                self._failed[ck] = str(ex)
            raise
        with self._lock:
            e = self._entries.get(ck)
            if e is not None:           # racing builder lost: count the hit
                e.hits += 1
                self.hits += 1
                return e
            self.misses += 1
            self._clock += 1
            e = PlanEntry(key, backend, plan, stamp=self._clock)
            self._entries[ck] = e
            self._evict_locked(keep=e)
            return e

    def pin(self, key: str, backend: str) -> None:
        with self._lock:
            e = self._entries.get((key, backend))
            if e is not None:
                e.pins += 1

    def unpin(self, key: str, backend: str) -> None:
        with self._lock:
            e = self._entries.get((key, backend))
            if e is not None and e.pins > 0:
                e.pins -= 1

    def _evict_locked(self, keep: Optional[PlanEntry] = None) -> None:
        # `keep` is the entry being admitted right now — its caller has not
        # had the chance to pin it yet, so it is never the victim
        while len(self._entries) > self.max_entries:
            victims = sorted(
                (e for e in self._entries.values()
                 if e.pins == 0 and e is not keep),
                key=lambda e: e.stamp)
            if not victims:
                return              # everything pinned: over-admit, no evict
            v = victims[0]
            del self._entries[(v.key, v.backend)]
            self.evictions += 1

    def entry(self, key: str, backend: str) -> Optional[PlanEntry]:
        with self._lock:
            return self._entries.get((key, backend))

    def stats(self) -> dict:
        with self._lock:
            per_backend: dict[str, int] = {}
            for (_k, b) in self._entries:
                per_backend[b] = per_backend.get(b, 0) + 1
            return {"size": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "max_entries": self.max_entries,
                    "per_backend": per_backend,
                    "failed": len(self._failed)}
