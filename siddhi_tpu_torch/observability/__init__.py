"""End-to-end observability: pipeline tracing, percentile latency,
Prometheus exposition, device-path profiling, and the X-Ray layer:
detection-latency attribution, cross-host trace stitching, and an
always-on engine flight recorder.

The port's copy of the JAX package's ``observability/__init__.py``, with one
deliberate difference: ``profiler.py`` runs on ``torch.profiler`` (with NVTX
ranges on the card) where the JAX package's runs on ``jax.profiler``.

The flow and resilience layers fill the statistics SPI with gauges and
counters; this package closes the gaps:

- **tracing** (``tracing.py``) — ``@app:trace(sample='1/N')`` opens a span
  chain at ingress; spans carry waterfall start offsets and classify into
  X-Ray phases; sampled contexts stitch across DCN hops
  (``GET /siddhi-apps/{name}/trace``, ``?limit=`` / ``?stream=``);
- **phase attribution** (``phases.py``) — always-on per-query per-phase
  ``LogHistogram``s whose means reconcile against the end-to-end mean by
  construction (``GET /siddhi-apps/{name}/latency``, bench
  ``latency_breakdown``);
- **percentile latency** (``histogram.py``) — log-bucketed histograms
  (p50/p90/p99/p99.9) with OpenMetrics exemplar capture;
- **exposition** (``prometheus.py``) — ``GET /metrics`` renders every
  tracker as stable ``siddhi_tpu_*`` families, tail buckets carrying
  ``trace_id`` exemplars when sampled;
- **SLO autopilot** (``slo.py``) — per-tenant SLO classes on
  ``@app:fleet`` groups, a closed loop from the phase evidence to the
  fleet's actuators (shed / shrink the window / split / eject), every
  decision on the flight recorder first (``GET /siddhi-apps/{name}/slo``,
  ``siddhi_tpu_slo_*`` gauges);
- **flight recorder** (``flight_recorder.py``) — a bounded ring of
  control-plane transitions (AIMD resizes, flush-cause flips, breaker
  state, quarantine/ejection, SLO decisions, takeover/rejoin), dumped to
  JSON on fault, served at ``GET /siddhi-apps/{name}/flightrecorder``
  and tailable incrementally via ``?since_ns=``;
- **device profiling** (``profiler.py`` + the step probe below).

Apps without ``@app:trace`` / ``@app:profile`` pay one ``is None`` check
per hot-path event; phase attribution and the flight recorder are
per-batch / per-transition, never per-event.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Optional

from ..query_api.annotation import find_annotation
from .flight_recorder import FlightRecorder, parse_flightrecorder_annotation
from .histogram import LogHistogram
from .phases import PHASES, PhaseBreakdown, phase_of_stage
from .profiler import DeviceProfiler, parse_profile_annotation
from .prometheus import CONTENT_TYPE, render
from .tracing import (
    PipelineTracer,
    Span,
    Trace,
    TraceContext,
    parse_trace_annotation,
)

from .slo import GroupEvidence, SLOController, TenantSLO
log = logging.getLogger("siddhi_tpu_torch.observability")

__all__ = [
    "CONTENT_TYPE", "DeviceProfiler", "DeviceStepProbe", "FLUSH_CAUSES",
    "FlightRecorder", "GroupEvidence", "LogHistogram",
    "ObservabilitySubsystem", "PHASES", "PhaseBreakdown", "PipelineTracer",
    "SLOController", "Span", "TenantSLO", "Trace", "TraceContext",
    "parse_flightrecorder_annotation", "parse_profile_annotation",
    "parse_trace_annotation", "phase_of_stage", "render",
]

# every flush site reports one of these causes; registered as counters even
# when still zero so dashboards see the full breakdown ("deadline" = the
# async driver's latency-mode wall-clock flush of a partial batch)
FLUSH_CAUSES = ("capacity", "adaptive", "deadline", "drain", "final")


class DeviceStepProbe:
    """Per-bridge device-path accounting, fed by ``observe_step`` on both
    the sync flush path and the async driver. ``compile_*`` keeps the JAX
    package's name and meaning, the first step's wall time; on the card the
    kernel library is built (``nvcc``) and loaded when the query is built, so
    there it is the first launch, not a compile."""

    # sealed groups beyond this are stale (emit sites the probe does not
    # seal, e.g. shutdown finalize) — close their spans rather than grow
    MAX_GROUPS = 128

    def __init__(self, query_name: str, capacity: int, latency_tracker,
                 tracer: Optional[PipelineTracer],
                 phase_breakdown: Optional[PhaseBreakdown] = None,
                 flight: Optional[FlightRecorder] = None):
        self.query_name = query_name
        self.capacity = max(1, int(capacity))
        self.latency_tracker = latency_tracker
        self.tracer = tracer
        self.phases = phase_breakdown
        self.flight = flight
        self.driver = None      # AsyncDeviceDriver when the bridge pipelines
        self.steps = 0
        self.events = 0
        self.busy_seconds = 0.0
        self.compile_count = 0
        self.compile_seconds = 0.0
        self.flush_causes: dict[str, int] = {}
        # (trace, arrival perf_counter_ns) registered at packing time into
        # the OPEN group; seal() closes the group when its batch is emitted
        # (stamping the seal instant — the fill-wait span's far edge), so
        # steps pop groups FIFO — matching the FIFO batch queue — and a
        # step never claims traces packed into a later batch. The engine
        # thread appends/seals, the device worker pops — deque ops are
        # GIL-atomic.
        self.pending: deque = deque()
        self._groups: deque = deque()

    def seal(self) -> None:
        """Close the open trace group — call when a batch is emitted (even
        an untraced one: group order must mirror batch order)."""
        if self.tracer is None:
            return
        group, self.pending = self.pending, deque()
        self._groups.append((group, time.perf_counter_ns()))
        while len(self._groups) > self.MAX_GROUPS:
            stale, _seal_ns = self._groups.popleft()
            for tr, t0 in stale:
                tr.add_span("device", self.query_name,
                            time.perf_counter_ns() - t0, 0, outcome="lost")

    def on_step(self, n_events: int, latency_s: float,
                device_path: bool = True,
                phases: Optional[dict] = None) -> None:
        """One consumed batch. ``phases`` (async driver / sync flush)
        carries the measured serial segments of this batch's waterfall:
        ``{"fill_span_s", "pack_s", "queue_s", "step_s", "fence_s",
        "publish_s", "cause"}`` — recorded event-weighted into the
        per-phase histograms."""
        if device_path:
            self.steps += 1
            self.events += int(n_events)
            self.busy_seconds += latency_s
            if self.steps == 1:
                self.compile_count = 1
                self.compile_seconds = latency_s
        # a host-fallback step (device_path=False) still consumed its batch:
        # drain its trace group so spans close and nothing accumulates
        # during a quarantine
        group, seal_ns = [], None
        if self.tracer is not None:
            now = time.perf_counter_ns()
            if self._groups:
                group, seal_ns = self._groups.popleft()
            else:
                # unsealed emit site: drain the open set entry-by-entry —
                # popleft is GIL-atomic, so a concurrent engine-thread
                # append is either fully drained here or left for the next
                # step, never lost (a whole-deque swap on this worker
                # thread could drop a racing append)
                while True:
                    try:
                        group.append(self.pending.popleft())
                    except IndexError:
                        break
            outcome = "ok" if device_path else "fallback"
            for tr, t0 in group:
                # the waterfall pair: fill-wait (arrival → seal) then the
                # device step itself
                edge = seal_ns if seal_ns is not None else now
                if edge > t0:
                    tr.add_span("fill-wait", self.query_name, edge - t0,
                                batch_size=int(n_events),
                                start_offset_ns=t0 - tr._t0_ns)
                tr.add_span("device", self.query_name, now - t0,
                            batch_size=int(n_events), outcome=outcome)
        exemplar = group[0][0].trace_id if group else None
        if device_path:
            self.latency_tracker.record_seconds(latency_s, exemplar=exemplar)
            if self.phases is not None and phases is not None:
                self.phases.record_batch(
                    int(n_events), fill_span_s=phases.get("fill_span_s", 0.0),
                    pack_s=phases.get("pack_s", 0.0),
                    queue_s=phases.get("queue_s", 0.0),
                    step_s=phases.get("step_s", 0.0),
                    fence_s=phases.get("fence_s", 0.0),
                    publish_s=phases.get("publish_s", 0.0),
                    host_s=phases.get("host_s", 0.0),
                    cause=phases.get("cause"), exemplar=exemplar)
        if self.flight is not None:
            # control-plane cross-reference, transition-deduped per site: a
            # quarantine-long fallback storm is ONE timeline entry at onset
            # (with the provoking batch's trace id), not one per batch —
            # the ok↔fallback flip is the recorded transition
            if device_path:
                self.flight.record_transition("device", "step_ok",
                                              site=self.query_name)
            else:
                self.flight.record_transition(
                    "device", "fallback_step", site=self.query_name,
                    detail={"events": int(n_events)}, trace_id=exemplar)

    @property
    def pad_ratio(self) -> float:
        """Padding waste: fraction of stepped batch slots that held no
        event (0.0 = perfectly full batches)."""
        if self.steps == 0:
            return 0.0
        return 1.0 - self.events / (self.steps * self.capacity)

    # -- pipeline health (async double-buffered driver) ----------------------
    # all three read the driver's counters so the pack/step overlap win is
    # visible OUTSIDE the bench, as siddhi_tpu_device_* families; a bridge
    # without a driver (sync mode) reports the serialized identity values
    @property
    def pipeline_depth(self) -> int:
        """Micro-batches inside the driver ring (staged + in flight)."""
        d = self.driver
        return d.pipeline_depth if d is not None else 0

    @property
    def overlap_efficiency(self) -> float:
        """(pack + step) work per unit of pipeline wall: ~2.0 when a
        2-deep ring fully hides packing behind device compute, 1.0 when
        the phases serialize (always 1.0 on the sync path)."""
        d = self.driver
        return d.overlap_efficiency if d is not None \
            else (1.0 if self.steps else 0.0)

    @property
    def device_idle_frac(self) -> float:
        """Fraction of pipeline wall the device waited on the host."""
        d = self.driver
        return d.device_idle_frac if d is not None else 0.0


class ObservabilitySubsystem:
    """One app's observability wiring. Constructed BEFORE the runtime
    builds (so the tracer exists when queries/sinks compile); ``wire()``
    runs after the build to register gauges over the finished surfaces."""

    def __init__(self, runtime):
        self.runtime = runtime
        anns = runtime.app.annotations
        from ..core.errors import SiddhiAppCreationError
        trace_ann = find_annotation(anns, "trace")
        self.tracer: Optional[PipelineTracer] = None
        if trace_ann is not None:
            try:
                self.tracer = parse_trace_annotation(trace_ann)
            except ValueError as e:
                raise SiddhiAppCreationError(str(e)) from None
        runtime.ctx.tracer = self.tracer
        # the flight recorder is ALWAYS on (bounded ring, per-transition
        # cost); @app:flightrecorder(ring=, dir=) tunes capacity/fault dumps
        try:
            self.flight = parse_flightrecorder_annotation(
                find_annotation(anns, "flightrecorder"), runtime.name)
        except ValueError as e:
            raise SiddhiAppCreationError(str(e)) from None
        runtime.ctx.flight = self.flight
        profile_ann = find_annotation(anns, "profile")
        self.profiler: Optional[DeviceProfiler] = None
        if profile_ann is not None:
            self.profiler = parse_profile_annotation(
                profile_ann, runtime.ctx.siddhi_context.device, runtime.name)
        self.probes: list[DeviceStepProbe] = []

    # -- post-build wiring -----------------------------------------------------
    def wire(self) -> None:
        rt = self.runtime
        sm = rt.ctx.statistics_manager
        ctx = rt.ctx

        # stream surfaces: delivered-event counters + event-time watermark
        # lag (app clock minus the stream's newest delivered timestamp)
        for sid, j in ctx.stream_junctions.items():
            sm.gauge_tracker(f"stream.{sid}.events_total",
                             lambda jj=j: jj.throughput)
            sm.gauge_tracker(
                f"stream.{sid}.watermark_lag_seconds",
                lambda jj=j, c=ctx: 0.0 if jj.last_event_ts is None
                else max(0.0, (c.current_time() - jj.last_event_ts) / 1e3))

        # source transports: cumulative connect attempts per stream (a
        # minimal Source subclass may never have called init — skip those)
        def _src_sid(s):
            d = getattr(s, "definition", None)
            return d.id if d is not None else None

        for sid in {_src_sid(s) for s in rt.sources} - {None}:
            sm.gauge_tracker(
                f"source.{sid}.connect_attempts_total",
                lambda s_id=sid, r=rt: sum(
                    s.connect_attempts for s in r.sources
                    if _src_sid(s) == s_id))

        # resilience control plane → flight recorder: every breaker
        # transition lands on the timeline (sinks now; device guards below)
        resilience = getattr(rt, "resilience", None)
        if resilience is not None:
            for s in resilience.sinks:
                s.breaker.listener = self.flight.breaker_listener(
                    "breaker", f"sink:{s.stream_id}[{s.ordinal}]")
            for g in resilience.guards:
                g.flight = self.flight
                g.breaker.listener = self.flight.breaker_listener(
                    "breaker", f"device:{g.query_name}")
            for g in resilience.host_guards:
                g.flight = self.flight
                g.breaker.listener = self.flight.breaker_listener(
                    "breaker", f"host_batch:{g.query_name}")

        # device bridges: step histogram + kernel/compile/pad/flush probes
        for bridge in rt.device_bridges:
            q = bridge.query_name
            breakdown = PhaseBreakdown(
                # segments share one family (bounded phase label); the
                # end-to-end sum gets its own family so sum-over-phases
                # dashboard queries don't double-count
                lambda ph, qq=q: sm.latency_tracker(
                    f"detection.{qq}.end_to_end" if ph == "end_to_end"
                    else f"phase.{qq}.{ph}"))
            probe = DeviceStepProbe(
                q, getattr(bridge, "batch_capacity", 1),
                sm.latency_tracker(f"device.{q}.step"),
                self.tracer, phase_breakdown=breakdown, flight=self.flight)
            self.probes.append(probe)
            bridge.probe = probe
            probe.driver = bridge.driver
            bridge.runtime.step_observer = probe.on_step
            bridge.runtime.step_sealer = probe.seal
            bridge.runtime.flush_causes = probe.flush_causes
            # flow control plane → flight recorder: flush-cause flips and
            # AIMD resizes are the decisions behind every queueing tail
            bridge.runtime.flight = self.flight
            bridge.runtime.flight_site = q
            ctrl = getattr(bridge.runtime, "batch_controller", None)
            if ctrl is not None:
                ctrl.flight = self.flight
                ctrl.site = q
            sm.gauge_tracker(f"device.{q}.steps_total",
                             lambda p=probe: p.steps)
            sm.gauge_tracker(f"device.{q}.busy_seconds_total",
                             lambda p=probe: p.busy_seconds)
            sm.gauge_tracker(f"device.{q}.compile_count",
                             lambda p=probe: p.compile_count)
            sm.gauge_tracker(f"device.{q}.compile_seconds",
                             lambda p=probe: p.compile_seconds)
            sm.gauge_tracker(f"device.{q}.pad_ratio",
                             lambda p=probe: round(p.pad_ratio, 4))
            # pipeline-health gauges: the pack/step overlap win measured by
            # the bench, continuously visible in the exposition
            sm.gauge_tracker(f"device.{q}.pipeline_depth",
                             lambda p=probe: p.pipeline_depth)
            sm.gauge_tracker(f"device.{q}.overlap_efficiency",
                             lambda p=probe: round(p.overlap_efficiency, 4))
            sm.gauge_tracker(f"device.{q}.device_idle_frac",
                             lambda p=probe: round(p.device_idle_frac, 4))
            for cause in FLUSH_CAUSES:
                sm.gauge_tracker(
                    f"device.{q}.flush_{cause}_total",
                    lambda p=probe, c=cause: p.flush_causes.get(c, 0))
            if self.profiler is not None:
                self.profiler.install(bridge)

        # columnar host bridges: their step latency doubles as the
        # host_exec phase (same histogram object registered under the
        # phase key — one set of samples, two views)
        for hb in getattr(rt, "host_bridges", []):
            hq = hb.query_name
            tracker = sm.latency.get(f"host_batch.{hq}.step")
            if tracker is not None:
                with sm._lock:
                    sm.latency.setdefault(f"phase.{hq}.host_exec", tracker)
            ctrl = getattr(hb.runtime, "batch_controller", None)
            if ctrl is not None:
                ctrl.flight = self.flight
                ctrl.site = hq

        # fleet lanes: AIMD resizes of the SHARED group window land on this
        # member app's timeline too (the group has no app of its own)
        for fb in getattr(rt, "fleet_bridges", []):
            ctrl = getattr(fb.group, "batch_controller", None)
            if ctrl is not None and getattr(ctrl, "flight", None) is None:
                ctrl.flight = self.flight
                ctrl.site = f"fleet:{fb.member.query_name}"

    # -- lifecycle -------------------------------------------------------------
    def on_start(self) -> None:
        if self.profiler is not None:
            self.profiler.start()

    def on_shutdown(self) -> None:
        if self.profiler is not None:
            self.profiler.stop()

    # -- introspection ---------------------------------------------------------
    def trace_export(self, limit: Optional[int] = None,
                     stream: Optional[str] = None) -> dict:
        if self.tracer is None:
            return {"enabled": False, "traces": []}
        return {"enabled": True, **self.tracer.report(),
                "traces": self.tracer.export(limit, stream=stream)}

    def flight_export(self, category: Optional[str] = None,
                      limit: Optional[int] = None,
                      since_ns: Optional[int] = None) -> dict:
        return {"enabled": True, **self.flight.report(),
                "entries": self.flight.export(category, limit, since_ns)}

    def latency_report(self) -> dict:
        """``GET /siddhi-apps/{name}/latency``: per-query end-to-end
        percentiles, the per-phase breakdown, and the reconciliation line
        (phase means must sum to the end-to-end mean — see
        :class:`~siddhi_tpu_torch.observability.phases.PhaseBreakdown`)."""
        sm = self.runtime.ctx.statistics_manager
        snap = sm.snapshot_trackers()["latency"]
        out: dict = {"queries": {}}
        by_probe = {p.query_name: p for p in self.probes}
        phase_queries: dict[str, dict] = {}
        for key, tracker in snap.items():
            parts = key.split(".")
            if parts[0] == "phase" and len(parts) >= 3:
                phase_queries.setdefault(parts[1], {})[
                    ".".join(parts[2:])] = tracker
        for q, probe in by_probe.items():
            if probe.phases is not None:
                out["queries"][q] = probe.phases.report()
        for q, phases in phase_queries.items():
            if q in out["queries"]:
                continue
            # host tier / interpreter: phases recorded without a probe
            rep = {"phases": {ph: t.percentiles_ms()
                              for ph, t in phases.items() if t.count}}
            e2e = phases.get("end_to_end")
            if e2e is not None and e2e.count:
                rep["end_to_end"] = e2e.percentiles_ms()
            out["queries"][q] = rep
        for key, tracker in snap.items():
            # interpreter queries: the per-query end-to-end histogram IS
            # the host_exec phase (one serial segment)
            if key.startswith("query.") and tracker.count:
                q = key[len("query."):]
                entry = out["queries"].setdefault(q, {})
                entry.setdefault("end_to_end", tracker.percentiles_ms())
                entry.setdefault("phases", {}).setdefault(
                    "host_exec", tracker.percentiles_ms())
        return out
