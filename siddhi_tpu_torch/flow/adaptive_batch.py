"""Flush hooks of the device runtimes.

The port's copy of ``AdaptiveFlushMixin`` from the reference's
``flow/adaptive_batch.py`` (that module imports no JAX, but the port keeps
its own copies): flush on the builder's hard capacity or the adaptive
controller's soft threshold, seal the observability probe's trace group at
each emit, and time the synchronous step for the controller and probe. The
controller and probe themselves are not ported yet; with neither attached
the hooks reduce to a capacity flush and a plain ``process`` call.
"""

from __future__ import annotations

import time
from typing import Optional


class AdaptiveFlushMixin:
    """Device-runtime hooks shared by the port's runtimes (the NFA runtime in
    ``gpu/nfa.py``):
    flush when the builder hits its hard capacity OR the controller's soft
    threshold, and feed sync-path step timings to the controller. Expects the
    host class to provide ``builder`` (with ``full`` and ``__len__``),
    ``flush()`` and ``process(batch)``."""

    batch_controller = None     # AdaptiveBatchController via @app:adaptive
    step_observer = None        # DeviceStepProbe.on_step (observability)
    step_sealer = None          # DeviceStepProbe.seal — closes the probe's
    # open trace group when a batch is emitted (FIFO group-per-batch)
    flush_causes = None         # probe's flush-cause counter dict
    flight = None               # FlightRecorder (observability wiring)
    flight_site = ""
    _pending_cause = None       # cause of the flush whose emit comes next

    def _count_flush(self, cause: str) -> None:
        fc = self.flush_causes
        if fc is not None:
            fc[cause] = fc.get(cause, 0) + 1
        # the emitted batch inherits this cause (phase attribution keys the
        # deadline-queueing share off it)
        self._pending_cause = cause
        f = self.flight
        if f is not None:
            # transition-recorded: only a CHANGE of flush cause lands on the
            # flight timeline (capacity→deadline is the story; ten thousand
            # capacity flushes are not)
            f.record_transition("flow", f"flush:{cause}",
                                site=self.flight_site)

    def _take_cause(self):
        c = self._pending_cause
        self._pending_cause = None
        return c

    def _maybe_flush(self) -> None:
        """Flush on the hard capacity OR the adaptive soft threshold (jitted
        shapes stay static at capacity; only the fill level changes)."""
        c = self.batch_controller
        if self.builder.full:
            self._count_flush("capacity")
            self.flush()
        elif c is not None and len(self.builder) >= c.current:
            self._count_flush("adaptive")
            self.flush()

    def _seal(self) -> None:
        """Close the probe's open trace group — call immediately before
        ``builder.emit()`` (every flush implementation does), so trace
        groups pair 1:1 with emitted batches."""
        s = self.step_sealer
        if s is not None:
            s()

    def observe_step(self, n_events: int, latency_s: float,
                     device_path: bool = True,
                     phases: Optional[dict] = None) -> None:
        """Feed one stepped batch's latency to the adaptive controller and
        the observability step probe (the async driver reports its own step
        timing through this hook). ``device_path=False`` marks a step whose
        work the resilience layer rerouted to the host interpreter — the
        controller must not tune on it, but the probe still drains its
        trace group. ``phases`` carries the batch's measured waterfall
        segments (X-Ray phase attribution)."""
        c = self.batch_controller
        if c is not None and device_path:
            c.observe(n_events, latency_s)
        obs = self.step_observer
        if obs is not None:
            obs(n_events, latency_s, device_path, phases=phases)

    def _timed_process(self, batch: dict):
        """Sync-path step, timed for the controller/probe with the
        dispatch/fence split measured separately (the ``device_step`` /
        ``egress_fence`` phases; on the sync path there is no ring wait,
        so ``ingress_queue`` is the emit→dispatch gap alone)."""
        if self.batch_controller is None and self.step_observer is None:
            return self.process(batch)
        cause = batch.get("_cause")
        if getattr(self, "dispatch", None) is None:
            # host-tier runtime (no two-phase step): the whole step is one
            # serial host_exec segment
            t0 = time.perf_counter()
            try:
                rows = self.process(batch)
            except BaseException:
                self.observe_step(batch.get("count", 0),
                                  time.perf_counter() - t0,
                                  device_path=False)
                raise
            dt = time.perf_counter() - t0
            self.observe_step(batch.get("count", 0), dt, phases={
                "fill_span_s": batch.get("pack_s", 0.0),
                "pack_s": batch.get("pack_exec_s", 0.0),
                "host_s": dt, "cause": cause})
            return rows
        t0 = time.perf_counter()
        try:
            token = self.dispatch(batch)
            t1 = time.perf_counter()
            rows = self.collect(token)
        except BaseException:
            # a raising step still consumed its batch: the probe must pop
            # this batch's trace group or every later device span would be
            # attributed one batch off, forever
            self.observe_step(batch.get("count", 0),
                              time.perf_counter() - t0, device_path=False)
            raise
        t2 = time.perf_counter()
        t_emit = batch.get("_t_emit")
        self.observe_step(batch.get("count", 0), t2 - t0, phases={
            "fill_span_s": batch.get("pack_s", 0.0),
            "pack_s": batch.get("pack_exec_s", 0.0),
            "queue_s": max(0.0, t0 - t_emit) if t_emit is not None else 0.0,
            "step_s": t1 - t0,
            "fence_s": t2 - t1,
            "cause": cause,
        })
        return rows
