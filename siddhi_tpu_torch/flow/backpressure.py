"""Credit-based admission control between ingress and the engine.

The port's copy of the JAX package's ``flow/backpressure.py``.

The reference's only overload story is the Disruptor ring's blocking wait
(``StreamJunction.java:279``); Hazelcast Jet-style engines make bounded
queues + an explicit overload policy a first-class knob. Here admission is
credit-based: a stream has ``capacity`` credits; every queued-but-undelivered
event holds one, and :class:`CreditGate` decides what happens when an
ingress call finds no free credits:

- ``BLOCK``   — the producer waits for credits (lossless; external producers
  only — in-engine producers never pass through the gate, so the engine
  cannot deadlock itself);
- ``DROP_OLDEST`` — evict the oldest queued event(s) to make room (keeps the
  newest ``capacity`` events; bounded staleness);
- ``SHED``    — drop the incoming event(s) and count them (bounded latency).

The gate reads queue depth through ``depth_fn`` (the async junction's
dispatcher queue when ``@async`` is on; a sync junction delivers inline so
depth is 0 and the gate is a no-op) and evicts through ``evict_fn``.
Admission is a reservation: credits taken by :meth:`CreditGate.admit` are
held until the producer's :meth:`CreditGate.release` after the events are
actually queued, so concurrent producers racing through the admit→enqueue
window cannot over-admit past ``capacity``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# BLOCK-policy producers poll for credits: the drain side runs under the
# engine lock, which the producer must never wait on while holding anything
_POLL_S = 0.001


def rlock_owned(lock) -> bool:
    """True when the calling thread may hold ``lock`` (an ``RLock``).
    ``RLock._is_owned`` is CPython-private; if absent, assume ownership so
    callers never block while possibly holding the lock the drain path
    needs. Shared by :class:`CreditGate` and ``AsyncDispatcher.enqueue`` —
    the two admission points that must not deadlock an in-engine producer."""
    if lock is None:
        return False
    is_owned = getattr(lock, "_is_owned", None)
    return True if is_owned is None else bool(is_owned())


class OverloadPolicy:
    BLOCK = "block"
    DROP_OLDEST = "drop_oldest"
    SHED = "shed"
    ALL = (BLOCK, DROP_OLDEST, SHED)

    @classmethod
    def parse(cls, s: Optional[str]) -> str:
        p = (s or cls.BLOCK).strip().lower().replace("-", "_")
        if p not in cls.ALL:
            raise ValueError(
                f"unknown overload policy '{s}' (known: {list(cls.ALL)})")
        return p


class FlowStats:
    """Per-stream admission counters (read by the StatisticsManager gauges)."""

    __slots__ = ("accepted", "shed", "dropped_oldest", "forced", "blocked_ns")

    def __init__(self):
        self.accepted = 0          # events admitted into the engine
        self.shed = 0              # incoming events dropped (SHED)
        self.dropped_oldest = 0    # queued events evicted (DROP_OLDEST)
        self.forced = 0            # BLOCK waits that hit max_wait and forced in
        self.blocked_ns = 0        # cumulative producer wait time


class CreditGate:
    """Admission control over a downstream bounded queue."""

    def __init__(self, capacity: int, policy: str,
                 depth_fn: Callable[[], int],
                 evict_fn: Optional[Callable[[], Optional[int]]] = None,
                 stats: Optional[FlowStats] = None,
                 max_wait_s: Optional[float] = None,
                 lock_owned_fn: Optional[Callable[[], bool]] = None):
        self.capacity = max(1, int(capacity))
        self.policy = OverloadPolicy.parse(policy)
        self.depth_fn = depth_fn
        self.evict_fn = evict_fn
        self.stats = stats or FlowStats()
        self.max_wait_s = max_wait_s
        # returns True when the CALLER may hold the engine root lock that
        # the drain path needs — such a producer must never wait (the same
        # deadlock shape AsyncDispatcher.enqueue guards against)
        self.lock_owned_fn = lock_owned_fn
        # admitted-but-not-yet-queued credits: admit() reserves under _lock,
        # release() frees once the events are in the queue (depth_fn covers
        # them from then on). Without the reservation two producers racing
        # through the admit→enqueue window both read the same depth and
        # over-admit past capacity.
        self._lock = threading.Lock()
        self._reserved = 0

    @property
    def depth(self) -> int:
        try:
            return int(self.depth_fn())
        except Exception:       # noqa: BLE001 — a dead gauge reads 0
            return 0

    @property
    def credits(self) -> int:
        return max(0, self.capacity - self.depth - self._reserved)

    def admit(self, n: int = 1) -> bool:
        """Apply the overload policy for ``n`` incoming events; returns False
        when the incoming events must be dropped (SHED). An admitted producer
        MUST call :meth:`release` once its events are queued (or on error)."""
        # a chunk larger than the whole queue can never fit; admit it once
        # there is any headroom rather than never
        need = min(n, self.capacity)
        with self._lock:
            if self.depth + self._reserved + need <= self.capacity:
                self._reserved += need
                self.stats.accepted += n
                return True
            if self.policy == OverloadPolicy.SHED:
                self.stats.shed += n
                return False
            if self.policy == OverloadPolicy.DROP_OLDEST:
                while self.depth + self._reserved + need > self.capacity \
                        and self.evict_fn:
                    dropped = self.evict_fn()
                    if dropped is None:
                        break            # queue empty: depth is held elsewhere
                    self.stats.dropped_oldest += dropped
                self._reserved += need
                self.stats.accepted += n
                return True
        # BLOCK: wait for the consumer to free credits. The wait polls
        # OUTSIDE _lock so waiting producers cannot starve quick admits.
        t0 = time.monotonic()
        while True:
            with self._lock:
                if self.depth + self._reserved + need <= self.capacity:
                    self._reserved += need
                    break
                if self.lock_owned_fn is not None and self.lock_owned_fn():
                    # in-engine producer (query inserting into this stream
                    # mid-delivery): waiting here would deadlock the drain —
                    # force in and count it, never block
                    self.stats.forced += 1
                    self._reserved += need
                    break
                if self.max_wait_s is not None \
                        and time.monotonic() - t0 > self.max_wait_s:
                    self.stats.forced += 1  # never drop under BLOCK: force in
                    self._reserved += need
                    break
            time.sleep(_POLL_S)
        self.stats.blocked_ns += int((time.monotonic() - t0) * 1e9)
        self.stats.accepted += n
        return True

    def release(self, n: int = 1) -> None:
        """Free the reservation taken by a successful :meth:`admit` — call
        after the ``n`` events are enqueued (depth_fn counts them now) or
        when delivery failed."""
        with self._lock:
            self._reserved = max(0, self._reserved - min(n, self.capacity))
