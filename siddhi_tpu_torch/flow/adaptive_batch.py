"""Adaptive device micro-batching: batch size from observed rate + latency.

The port's copy of the JAX package's ``flow/adaptive_batch.py``. The
controller adapts batch granularity to the observed arrival rate instead of
a hand-tuned constant (TiLT, PAPERS.md). It runs AIMD over the *flush
threshold* (a soft fill target <= the builder's static capacity, so the
kernels' shapes never change):

- every stepped batch reports ``observe(n_events, latency_s)``;
- if the recent p99 step latency exceeds the target, the threshold halves
  (multiplicative decrease — drain the pipeline fast under overload);
- if p99 sits comfortably under the target (< half) and batches are actually
  filling to the threshold, it grows additively (slow start toward device
  efficiency);
- adjustments are rate-limited by a cooldown so one outlier can't thrash
  the operating point.

The chosen size is exported as the ``batch_size`` gauge and read by the
device bridges' flush check (:class:`AdaptiveFlushMixin`). A flush
*deadline* rides along: the suggested maximum time a partial batch may wait
before being flushed, derived from the latency target and the observed
arrival rate.

**Latency mode** (``@app:adaptive(latency.target.ms='50')``): instead of
tuning the threshold for device efficiency under a step-time budget, the
controller targets end-to-end *detection* latency. An event admitted into a
deadline-flush window of W events at arrival rate λ waits up to ``W/λ`` for
the window to close and then one device step — so the controller sizes W so
that predicted p99 (fill wait + observed p99 step) stays under the target,
and the async driver (``core/device_bridge.py``) enforces the remaining
budget as a wall-clock deadline flush on partial batches
(``flush_deadline_ms``): a tail bounded by about two step times instead of
the wait for a throughput-sized window to fill.

The observability subsystem sets the ``flight`` hook (the flight recorder);
the ``ceiling`` hook (the SLO autopilot) belongs to the fleet tier, which the
port does not have yet, and stays ``None``.
"""

from __future__ import annotations

import collections
import time
from typing import Optional


class AdaptiveBatchController:
    """AIMD controller over the device flush threshold."""

    def __init__(self, min_batch: int = 64, max_batch: int = 8192,
                 target_ms: float = 25.0, initial: Optional[int] = None,
                 history: int = 64, cooldown: int = 4,
                 latency_target_ms: Optional[float] = None):
        if min_batch < 1 or max_batch < min_batch:
            raise ValueError(
                f"bad adaptive batch bounds [{min_batch}, {max_batch}]")
        self.min_batch = int(min_batch)
        self.max_batch = int(max_batch)
        self.latency_target_ms = (float(latency_target_ms)
                                  if latency_target_ms else None)
        self.mode = "latency" if self.latency_target_ms else "throughput"
        if self.mode == "latency":
            # the detection budget splits between window fill-wait and one
            # device step: give the step half by default
            target_ms = min(float(target_ms), self.latency_target_ms / 2.0)
        self.target_ms = float(target_ms)
        self.current = min(self.max_batch,
                           max(self.min_batch,
                               int(initial) if initial else self.min_batch))
        # flight recorder hook: AIMD resizes are control-plane transitions
        # (set post-construction by the observability wiring)
        self.flight = None
        self.site = ""
        # externally imposed hard cap on the threshold (the SLO autopilot's
        # shrink actuator): AIMD may roam below it, never above — the two
        # control loops must not fight over the same knob
        self.ceiling: Optional[int] = None
        self._lat_ms: collections.deque = collections.deque(maxlen=history)
        self._cooldown = max(1, int(cooldown))
        self._since_adjust = 0
        self.rate_evps = 0.0            # EMA of step PROCESSING rate
        # EMA of the ARRIVAL rate: events per wall-clock between observe()
        # calls. Distinct from rate_evps (events per step latency, i.e.
        # device capacity) — fill-wait prediction must use how fast events
        # actually arrive, or a fast device makes every window look cheap
        self.arrival_evps = 0.0
        self._last_observe_t = None
        self.observations = 0
        self.adjustments = 0

    # -- feedback --------------------------------------------------------------
    def observe(self, n_events: int, latency_s: float,
                arrival_evps: Optional[float] = None) -> int:
        """Report one stepped batch; returns the (possibly new) threshold.
        ``arrival_evps`` pins the arrival-rate estimate for callers whose
        feed is not paced like real traffic (the bench's convergence loop
        steps pre-packed windows back-to-back — its wall clock measures
        device capacity, not arrivals) and suspends the internal wall-clock
        estimator for this observation."""
        self.observations += 1
        lat_ms = max(0.0, float(latency_s) * 1e3)
        self._lat_ms.append(lat_ms)
        if latency_s > 0 and n_events > 0:
            inst = n_events / latency_s
            self.rate_evps = inst if self.rate_evps == 0.0 \
                else 0.8 * self.rate_evps + 0.2 * inst
        if arrival_evps is not None:
            self.arrival_evps = float(arrival_evps)
            self._last_observe_t = None
        else:
            now = time.perf_counter()
            if self._last_observe_t is not None and n_events > 0 \
                    and now > self._last_observe_t:
                # at steady state (no queue growth) events observed per
                # batch over the wall between batches IS the arrival rate
                inst_arr = n_events / (now - self._last_observe_t)
                self.arrival_evps = inst_arr if self.arrival_evps == 0.0 \
                    else 0.8 * self.arrival_evps + 0.2 * inst_arr
            self._last_observe_t = now
        self._since_adjust += 1
        if self._since_adjust < self._cooldown:
            return self.current
        # one AIMD ladder, two operating targets: latency mode compares the
        # END-TO-END prediction (fill wait at the arrival rate + one step at
        # observed p99) against the detection budget; throughput mode
        # compares step p99 against the step-time target
        if self.mode == "latency":
            metric, budget = self.predicted_p99_ms, self.latency_target_ms
        else:
            metric, budget = self.p99_ms, self.target_ms
        if metric > budget:
            nxt = max(self.min_batch, self.current // 2)
        elif metric < budget * 0.5 and n_events >= self.current:
            # only grow when batches actually fill the threshold — growing
            # on a trickle would just add queueing delay
            nxt = min(self.max_batch,
                      self.current + max(self.min_batch // 2, 1))
        else:
            return self.current
        if self.ceiling is not None:
            nxt = min(nxt, self.ceiling)
        if nxt != self.current:
            old, self.current = self.current, nxt
            self.adjustments += 1
            f = self.flight
            if f is not None:
                f.record("flow", "aimd_resize", site=self.site,
                         detail={"from": old, "to": nxt,
                                 "metric_ms": round(metric, 3),
                                 "budget_ms": round(budget, 3)})
        self._since_adjust = 0
        return self.current

    # -- external cap (SLO autopilot) ------------------------------------------
    def impose_ceiling(self, n: int) -> None:
        """Cap the threshold from outside (clamping the current operating
        point immediately). The imposer records its own decision; the
        clamp itself also lands on the flight timeline as an aimd_resize
        so the knob's history stays complete."""
        n = max(self.min_batch, int(n))
        self.ceiling = n
        if self.current > n:
            old, self.current = self.current, n
            self.adjustments += 1
            f = self.flight
            if f is not None:
                f.record("flow", "aimd_resize", site=self.site,
                         detail={"from": old, "to": n, "cap": "slo"})

    def lift_ceiling(self) -> None:
        self.ceiling = None

    # -- readouts --------------------------------------------------------------
    @property
    def p99_ms(self) -> float:
        if not self._lat_ms:
            return 0.0
        xs = sorted(self._lat_ms)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

    @property
    def fill_wait_ms(self) -> float:
        """Time a window of ``current`` events takes to fill at the observed
        ARRIVAL rate — the queueing half of detection latency. Falls back to
        the processing rate before the second batch has timed an interval."""
        rate = self.arrival_evps or self.rate_evps
        if rate <= 0.0:
            return 0.0
        return self.current / rate * 1e3

    @property
    def predicted_p99_ms(self) -> float:
        """Predicted p99 detection latency at the current operating point:
        window fill wait plus one step at observed p99."""
        return self.fill_wait_ms + self.p99_ms

    @property
    def flush_deadline_ms(self) -> float:
        """How long a partial batch may wait before a deadline flush: the
        latency budget left after one step at current p99, floored so the
        deadline never collapses to busy-flushing. In latency mode the
        budget is the end-to-end target; the async driver enforces this as
        a wall-clock flush on partial batches."""
        budget = self.latency_target_ms if self.mode == "latency" \
            else self.target_ms
        return max(1.0, budget - self.p99_ms)

    def report(self) -> dict:
        out = {
            "batch_size": self.current,
            "min": self.min_batch,
            "max": self.max_batch,
            "mode": self.mode,
            "target_ms": self.target_ms,
            "p99_ms": round(self.p99_ms, 3),
            "rate_evps": round(self.rate_evps),
            "flush_deadline_ms": round(self.flush_deadline_ms, 3),
            "observations": self.observations,
            "adjustments": self.adjustments,
        }
        if self.ceiling is not None:
            out["ceiling"] = self.ceiling
        if self.mode == "latency":
            out["latency_target_ms"] = self.latency_target_ms
            out["arrival_evps"] = round(self.arrival_evps)
            out["predicted_p99_ms"] = round(self.predicted_p99_ms, 3)
        return out


class AdaptiveFlushMixin:
    """Device-runtime hooks shared by every bridge runtime (stream/join
    bridges in ``core/device_bridge.py``, the NFA runtime in ``gpu/nfa.py``):
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
        """Flush on the hard capacity OR the adaptive soft threshold (kernel
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


def parse_adaptive_annotation(ann) -> dict:
    """``@app:adaptive(target.ms='25', min='64', initial='256')`` → config
    kwargs for :class:`AdaptiveBatchController` (``max`` defaults to each
    query's own batch capacity at attach time).
    ``@app:adaptive(latency.target.ms='50')`` selects latency mode: the
    flush window is sized from an end-to-end p99 detection-latency target
    and partial batches deadline-flush against the remaining budget."""
    cfg = {}
    if ann.get("target.ms"):
        cfg["target_ms"] = float(ann.get("target.ms"))
    lat = ann.get("latency.target.ms") or ann.get("latency_target_ms")
    if lat:
        cfg["latency_target_ms"] = float(lat)
    if ann.get("min"):
        cfg["min_batch"] = int(ann.get("min"))
    if ann.get("max"):
        cfg["max_batch"] = int(ann.get("max"))
    if ann.get("initial"):
        cfg["initial"] = int(ann.get("initial"))
    return cfg
