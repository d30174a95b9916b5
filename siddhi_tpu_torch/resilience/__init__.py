"""End-to-end fault handling: sink retry/circuit-breaking, error-store
replay, device-path quarantine, and seeded fault injection.

The port's copy of the JAX package's ``resilience/__init__.py``. The flow
package (``siddhi_tpu_torch/flow``: WAL + replay + backpressure) makes the
*ingress* durable; this package covers everything downstream of a junction:

- **egress** — every wired sink is wrapped in a
  :class:`~siddhi_tpu_torch.resilience.sink_pipeline.ResilientSink` publish
  pipeline (``on.error`` policy + per-sink circuit breaker);
- **device** — every ``@device`` bridge runtime gets a
  :class:`~siddhi_tpu_torch.resilience.device_guard.DeviceGuard` (runtime failures
  reroute the failed batch through the host — the columnar host engine when
  the query lowers there, else the interpreter; repeated failures
  quarantine the device path until a cool-down probe re-promotes it);
- **fleet** — every ``@app:fleet`` shape group gets a
  :class:`~siddhi_tpu_torch.resilience.fleet_guard.FleetGuard` (per-tenant
  containment, ejection to the solo tier, re-admission, input hardening,
  fair share);
- **host batch** — every columnar host bridge gets a
  :class:`~siddhi_tpu_torch.resilience.fleet_guard.HostStepGuard` (a failed
  micro-batch replays on the scalar interpreter; repeated failures
  quarantine the columnar path);
- **control plane** — stored failures replay through
  :meth:`~siddhi_tpu_torch.core.errors.ErrorStore.replay`, exposed as service
  endpoints (``GET .../error-store``, ``POST .../error-store/replay``);
- **test substrate** — ``@app:chaos`` wires a deterministic seeded
  :class:`~siddhi_tpu_torch.resilience.chaos.ChaosInjector` across sources,
  sinks, and device steps.

Defaults are applied to every app; ``@app:resilience(...)`` tunes them:

    @app:resilience(sink.on.error='log', sink.circuit.threshold='5',
                    sink.circuit.cooldown.ms='30000',
                    device.quarantine='true', device.circuit.threshold='3',
                    device.circuit.cooldown.ms='30000',
                    host.quarantine='true', host.circuit.threshold='3',
                    host.circuit.cooldown.ms='30000')
"""

from __future__ import annotations

import logging
import threading

from ..query_api.annotation import find_annotation
from .chaos import ChaosFault, ChaosInjector, parse_chaos_annotation
from .circuit import CircuitBreaker, CircuitState
from .dcn_guard import (
    DCNGuard,
    DCNGuardConfig,
    LaneGroupSnapshotStore,
    PeerHealth,
    SpillQueue,
)
from .device_guard import DeviceGuard
from .fleet_guard import FleetGuard, HostStepGuard
from .sink_pipeline import OnErrorPolicy, ResilientSink, parse_sink_policy

log = logging.getLogger("siddhi_tpu_torch.resilience")

__all__ = [
    "ChaosFault", "ChaosInjector", "CircuitBreaker", "CircuitState",
    "DCNGuard", "DCNGuardConfig", "DeviceGuard", "FleetGuard",
    "HostStepGuard", "LaneGroupSnapshotStore", "OnErrorPolicy",
    "PeerHealth", "ResilienceSubsystem", "ResilientSink", "SpillQueue",
    "parse_chaos_annotation", "parse_sink_policy",
]


class ResilienceSubsystem:
    """One app's fault-handling wiring (built by ``SiddhiAppRuntime`` before
    ``_build`` so sink wrapping and device guards attach as IO compiles)."""

    def __init__(self, runtime):
        self.runtime = runtime
        anns = runtime.app.annotations
        self.chaos = parse_chaos_annotation(find_annotation(anns, "chaos"))
        res_ann = find_annotation(anns, "resilience")
        self.sink_defaults = {}
        self.device_threshold = 3
        self.device_cooldown_s = 30.0
        self.device_quarantine = True
        if res_ann is not None:
            for key in ("on.error", "retry.count", "retry.delay.ms",
                        "wait.base.ms", "wait.cap.ms", "circuit.threshold",
                        "circuit.cooldown.ms"):
                v = res_ann.get("sink." + key)
                if v is not None:
                    self.sink_defaults[key] = v
            if res_ann.get("device.circuit.threshold"):
                self.device_threshold = int(
                    res_ann.get("device.circuit.threshold"))
            if res_ann.get("device.circuit.cooldown.ms"):
                self.device_cooldown_s = float(
                    res_ann.get("device.circuit.cooldown.ms")) / 1000.0
            self.device_quarantine = (
                res_ann.get("device.quarantine") or "true").lower() != "false"
        self.host_threshold = 3
        self.host_cooldown_s = 30.0
        self.host_quarantine = True
        if res_ann is not None:
            if res_ann.get("host.circuit.threshold"):
                self.host_threshold = int(
                    res_ann.get("host.circuit.threshold"))
            if res_ann.get("host.circuit.cooldown.ms"):
                self.host_cooldown_s = float(
                    res_ann.get("host.circuit.cooldown.ms")) / 1000.0
            self.host_quarantine = (
                res_ann.get("host.quarantine") or "true").lower() != "false"
        self.sinks: list[ResilientSink] = []
        self.guards: list[DeviceGuard] = []
        self.host_guards: list[HostStepGuard] = []
        self.shutdown_signal = threading.Event()
        self._sink_ordinals: dict[str, int] = {}

    # -- sink egress ---------------------------------------------------------
    def wrap_sink(self, sink, stream_def, options: dict) -> ResilientSink:
        from ..core.errors import SiddhiAppCreationError
        sid = stream_def.id
        ordinal = self._sink_ordinals.get(sid, 0)
        self._sink_ordinals[sid] = ordinal + 1
        try:
            cfg = parse_sink_policy(options, self.sink_defaults)
        except ValueError as e:
            raise SiddhiAppCreationError(
                f"sink on stream '{sid}': {e}") from None
        ctx = self.runtime.ctx
        if "on.error" not in options and "on.error" not in self.sink_defaults:
            # no explicit policy anywhere: inherit the stream's @OnError
            # action, preserving the pre-wrapping behavior where a raising
            # publish escalated into the junction's fault handling
            j = ctx.stream_junctions.get(sid)
            inherited = getattr(j, "on_error_action", None)
            if inherited in (OnErrorPolicy.STORE, OnErrorPolicy.STREAM):
                cfg["policy"] = inherited

        def fault_junction():
            # lookup only, never create: a junction materialized at fault
            # time could have no receivers anyway (subscriptions happen at
            # build), and inserting into stream_junctions from a delivery
            # thread would race iterations of that dict
            j = ctx.stream_junctions.get(sid)
            if j is not None and j.fault_junction is not None:
                return j.fault_junction
            return ctx.stream_junctions.get("!" + sid)

        wrapped = ResilientSink(
            sink, sid, ordinal, cfg, self.runtime.name,
            error_store_fn=lambda: ctx.siddhi_context.error_store,
            fault_junction_fn=fault_junction,
            chaos=self.chaos,
            shutdown_signal=self.shutdown_signal,
            stats=ctx.statistics_manager,
            listener_fn=lambda: ctx.exception_listener,
            tracer=ctx.tracer)
        self.sinks.append(wrapped)
        return wrapped

    def sinks_for(self, stream_id: str) -> list[ResilientSink]:
        return [s for s in self.sinks if s.stream_id == stream_id]

    # -- device quarantine ---------------------------------------------------
    def guard_device(self, rt, query, query_name: str, stream_defs: dict,
                     get_junction, kind: str):
        """Install a DeviceGuard over a freshly built bridge runtime (called
        from ``try_build_device_query``). Returns the guard, or None when
        quarantine is disabled for the app."""
        if not self.device_quarantine:
            return None
        device = getattr(rt, "device", None)
        guard = DeviceGuard(
            query, query_name, self.runtime.ctx, stream_defs, get_junction,
            kind, failure_threshold=self.device_threshold,
            cooldown_s=self.device_cooldown_s, chaos=self.chaos,
            # on the card only injected faults replay on the host
            replay_only_chaos=device is not None and device.type == "cuda")
        guard.install(rt)
        self.guards.append(guard)
        return guard

    def bind_bridge(self, guard, bridge) -> None:
        """Late-bind the bridge so fallback outputs reach its query
        callbacks (the bridge is constructed after the runtime)."""
        if guard is not None:
            guard.bridge = bridge

    # -- host-batch containment ----------------------------------------------
    def guard_host(self, bridge, query, stream_defs: dict, get_junction):
        """Install a HostStepGuard over a freshly built columnar host
        bridge (called from ``try_build_host_query`` /
        ``try_build_host_partition``): a failing micro-batch replays through
        the scalar interpreter, repeated failures quarantine the columnar
        path. Returns the guard, or None when disabled."""
        if not self.host_quarantine:
            return None
        guard = HostStepGuard(
            bridge, query, self.runtime.ctx, stream_defs, get_junction,
            failure_threshold=self.host_threshold,
            cooldown_s=self.host_cooldown_s)
        guard.install()
        self.host_guards.append(guard)
        return guard

    # -- sources (chaos only: retry/jitter lives on Source itself) -----------
    def wrap_source_handler(self, stream_id: str, handler):
        if self.chaos is None:
            return handler
        chaos, site = self.chaos, f"source:{self.runtime.name}/{stream_id}"

        def guarded(payload):
            try:
                chaos.on_source(site)
            except ChaosFault as e:
                # the payload is rejected BEFORE ingress and the fault stays
                # inside this app: a leaking ChaosFault would abort delivery
                # to a shared broker topic's OTHER subscribers and surface
                # as a publish failure in the (chaos-free) upstream app
                log.info("%s: %s", site, e)
                return
            handler(payload)
        return guarded

    def wrap_source_connect(self, source, stream_id: str) -> None:
        if self.chaos is None or self.chaos.connect_fail_p <= 0:
            return
        chaos, site = self.chaos, f"connect:{self.runtime.name}/{stream_id}"
        inner = source.connect

        def guarded_connect():
            chaos.on_connect(site)
            inner()
        source.connect = guarded_connect

    # -- lifecycle -----------------------------------------------------------
    def on_start(self) -> None:
        self.shutdown_signal.clear()

    def on_shutdown(self) -> None:
        """Flips the shutdown signal FIRST so WAIT backoffs and source
        connect retries abort promptly."""
        self.shutdown_signal.set()

    # -- introspection -------------------------------------------------------
    def report(self) -> dict:
        out = {
            "sinks": [s.report() for s in self.sinks],
            "device": [g.report() for g in self.guards],
            "host_batch": [g.report() for g in self.host_guards],
        }
        if self.chaos is not None:
            out["chaos"] = self.chaos.report()
        return out
