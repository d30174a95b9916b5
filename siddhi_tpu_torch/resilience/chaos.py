"""Seeded fault injection: the test substrate for the resilience layer.

The port's copy of the JAX package's ``resilience/chaos.py``. The
``dcn.*`` fields are parsed as the reference parses them; nothing in the
port calls their sites yet (the distribution tier, ``ROADMAP.md`` §A item
8). ``fleet.fault.p`` targets a tenant's own lanes of its fleet group
(``resilience/fleet_guard.py``).

``@app:chaos(seed='42', source.fail.p='0.05', sink.fail.p='0.05',
device.fail.p='0.05', connect.fail.p='0', latency.ms='0')`` (or a
programmatically constructed :class:`ChaosInjector`) wraps the three
failure-prone surfaces:

- **sources** — mapped payloads are rejected at ingress with
  :class:`ChaosFault` *before* the stream accepts them, so an injected
  source fault never counts against delivery guarantees;
- **sinks** — publish attempts raise ``ConnectionUnavailableError`` (the
  retryable transport failure the ``on.error`` policies handle), and
  ``connect.fail.p`` fails source ``connect()`` calls to exercise
  ``connect_with_retry``;
- **device steps** — compiled micro-batch steps raise :class:`ChaosFault`,
  driving the device guard's host fallback and quarantine (``latency.ms``
  applies here too, so slow-device scenarios are testable);
- **fleet group steps** — ``fleet.fault.p`` faults the owning tenant's
  lanes of a shared fleet batch (the injector is app-scoped, so the blast
  targets exactly one tenant), driving the FleetGuard's bisection
  containment, ejection and re-admission;
- **DCN frames** — ``dcn.drop.p`` drops a forwarded frame's ack on the
  sender side (the frame may have applied — exercising retry + receiver
  dedup), ``dcn.kill.p`` kills the serving connection before the frame
  applies (the peer looks crashed mid-frame), and ``dcn.delay.ms`` delays
  the receiver's ack (exercising the ack-recv deadline).

Determinism: each injection site owns a ``random.Random`` seeded from
``(seed, site)`` — the fault pattern for a site depends only on its own call
sequence, never on thread interleaving at other sites. Fault probabilities
are plain attributes and may be mutated mid-run (tests heal a component by
zeroing its probability).
"""

from __future__ import annotations

import random
import time
import zlib
from typing import Optional


class ChaosFault(Exception):
    """An injected (non-transport) failure."""


class ChaosInjector:
    def __init__(self, seed: int = 0, source_fail_p: float = 0.0,
                 sink_fail_p: float = 0.0, device_fail_p: float = 0.0,
                 connect_fail_p: float = 0.0, latency_ms: float = 0.0,
                 dcn_drop_p: float = 0.0, dcn_kill_p: float = 0.0,
                 dcn_delay_ms: float = 0.0, fleet_fault_p: float = 0.0):
        self.seed = int(seed)
        self.source_fail_p = float(source_fail_p)
        self.sink_fail_p = float(sink_fail_p)
        self.device_fail_p = float(device_fail_p)
        self.connect_fail_p = float(connect_fail_p)
        self.latency_ms = float(latency_ms)
        self.dcn_drop_p = float(dcn_drop_p)
        self.dcn_kill_p = float(dcn_kill_p)
        self.dcn_delay_ms = float(dcn_delay_ms)
        self.fleet_fault_p = float(fleet_fault_p)
        self._rngs: dict[str, random.Random] = {}
        self.counters = {"source_faults": 0, "sink_faults": 0,
                         "device_faults": 0, "connect_faults": 0,
                         "dcn_drops": 0, "dcn_kills": 0, "fleet_faults": 0}

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = random.Random((self.seed << 32) ^ zlib.crc32(site.encode()))
            self._rngs[site] = rng
        return rng

    def _roll(self, site: str, p: float) -> bool:
        if p <= 0.0:
            return False
        return self._rng(site).random() < p

    def _latency(self, site: str) -> None:
        if self.latency_ms > 0:
            time.sleep(self.latency_ms / 1000.0 * self._rng(site).random())

    # -- injection points ----------------------------------------------------
    def on_source(self, site: str) -> None:
        """Raises ChaosFault to reject a source payload at ingress."""
        self._latency(site)
        if self._roll(site, self.source_fail_p):
            self.counters["source_faults"] += 1
            raise ChaosFault(f"chaos: source fault injected at {site}")

    def on_sink(self, site: str) -> None:
        """Raises the retryable transport error ahead of a publish attempt."""
        from ..core.io import ConnectionUnavailableError
        self._latency(site)
        if self._roll(site, self.sink_fail_p):
            self.counters["sink_faults"] += 1
            raise ConnectionUnavailableError(
                f"chaos: sink fault injected at {site}")

    def on_device(self, site: str) -> None:
        """Raises ChaosFault ahead of a device micro-batch step.
        ``latency.ms`` injects bounded random delay here too (unlike the
        original source/sink-only coverage), so slow-device scenarios are
        testable at the same site."""
        self._latency(site)
        if self._roll(site, self.device_fail_p):
            self.counters["device_faults"] += 1
            raise ChaosFault(f"chaos: device fault injected at {site}")

    def roll_fleet(self, site: str) -> bool:
        """One roll of ``fleet.fault.p`` ahead of a shared fleet-group step.
        The injector is app-scoped, so a hit faults the OWNING tenant's
        lanes of the shared batch — the FleetGuard rolls ONCE per group step
        and keeps the verdict across its bisection replays, so containment
        observes a consistent fault."""
        if self._roll(site, self.fleet_fault_p):
            self.counters["fleet_faults"] += 1
            return True
        return False

    def on_connect(self, site: str) -> None:
        from ..core.io import ConnectionUnavailableError
        if self._roll(site, self.connect_fail_p):
            self.counters["connect_faults"] += 1
            raise ConnectionUnavailableError(
                f"chaos: connect fault injected at {site}")

    # -- DCN fault sites (drop frame / kill peer / delay ack) ----------------
    def on_dcn_send(self, site: str) -> None:
        """Sender side, AFTER the frame hit the wire: raising here models a
        lost ack — the frame may have applied, so the retry must dedup."""
        if self._roll(site, self.dcn_drop_p):
            self.counters["dcn_drops"] += 1
            raise ChaosFault(f"chaos: dcn ack dropped at {site}")

    def on_dcn_serve(self, site: str) -> None:
        """Receiver side, BEFORE the frame applies: raising here kills the
        serving connection mid-frame (peer looks crashed; sender retries)."""
        if self._roll(site, self.dcn_kill_p):
            self.counters["dcn_kills"] += 1
            raise ChaosFault(f"chaos: dcn peer killed at {site}")

    def on_dcn_ack(self, site: str) -> None:
        """Receiver side, before the ack goes out: bounded random delay
        exercising the sender's ack-recv deadline."""
        if self.dcn_delay_ms > 0:
            time.sleep(self.dcn_delay_ms / 1000.0 * self._rng(site).random())

    def report(self) -> dict:
        return {
            "seed": self.seed,
            "probabilities": {
                "source": self.source_fail_p, "sink": self.sink_fail_p,
                "device": self.device_fail_p, "connect": self.connect_fail_p,
                "dcn_drop": self.dcn_drop_p, "dcn_kill": self.dcn_kill_p,
                "dcn_delay_ms": self.dcn_delay_ms,
                "fleet": self.fleet_fault_p,
            },
            "counters": dict(self.counters),
        }


def parse_chaos_annotation(ann) -> Optional[ChaosInjector]:
    """``@app:chaos(...)`` → injector (None when the annotation is absent)."""
    if ann is None:
        return None
    return ChaosInjector(
        seed=int(ann.get("seed") or 0),
        source_fail_p=float(ann.get("source.fail.p") or 0.0),
        sink_fail_p=float(ann.get("sink.fail.p") or 0.0),
        device_fail_p=float(ann.get("device.fail.p") or 0.0),
        connect_fail_p=float(ann.get("connect.fail.p") or 0.0),
        latency_ms=float(ann.get("latency.ms") or 0.0),
        dcn_drop_p=float(ann.get("dcn.drop.p") or 0.0),
        dcn_kill_p=float(ann.get("dcn.kill.p") or 0.0),
        dcn_delay_ms=float(ann.get("dcn.delay.ms") or 0.0),
        fleet_fault_p=float(ann.get("fleet.fault.p") or 0.0),
    )
