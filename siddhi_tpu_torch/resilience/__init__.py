"""Sink egress fault handling: the publish pipeline and its circuit breaker.

The port's copy of the sink and source half of the JAX package's
``resilience/__init__.py``: every wired sink is wrapped in a
:class:`~siddhi_tpu_torch.resilience.sink_pipeline.ResilientSink` publish
pipeline (``on.error`` policy + per-sink circuit breaker), and every wired
source gets the app's ``shutdown_signal`` so connect retries stop when the
app shuts down. Stored sink failures replay through
:meth:`~siddhi_tpu_torch.core.errors.ErrorStore.replay`.

Not ported yet (``ROADMAP.md`` §A4): the reference guards every ``@device``
query by default with a ``DeviceGuard`` (a failed step replays its batch on
the host interpreter; repeated failures quarantine the device path), and the
port does not: its bridges keep ``guard = None``, and a failed step is
logged and its batch dropped. ``guard_device``, ``bind_bridge`` and
``guard_host``, the ``@app:chaos`` fault injector and the
``@app:resilience`` defaults wait for that tier; the engine refuses
``@app:chaos`` and ``@app:resilience`` by name until then.
"""

from __future__ import annotations

import threading

from .circuit import CircuitBreaker, CircuitState
from .sink_pipeline import OnErrorPolicy, ResilientSink, parse_sink_policy

__all__ = [
    "CircuitBreaker", "CircuitState", "OnErrorPolicy", "ResilienceSubsystem",
    "ResilientSink", "parse_sink_policy",
]


class ResilienceSubsystem:
    """One app's sink and source fault-handling wiring (built by
    ``SiddhiAppRuntime`` before ``_build`` so sinks wrap as the IO
    compiles)."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.sinks: list[ResilientSink] = []
        self.shutdown_signal = threading.Event()
        self._sink_ordinals: dict[str, int] = {}

    # -- sink egress ---------------------------------------------------------
    def wrap_sink(self, sink, stream_def, options: dict) -> ResilientSink:
        from ..core.errors import SiddhiAppCreationError
        sid = stream_def.id
        ordinal = self._sink_ordinals.get(sid, 0)
        self._sink_ordinals[sid] = ordinal + 1
        try:
            cfg = parse_sink_policy(options)
        except ValueError as e:
            raise SiddhiAppCreationError(
                f"sink on stream '{sid}': {e}") from None
        ctx = self.runtime.ctx
        if "on.error" not in options:
            # no explicit policy: inherit the stream's @OnError
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
            shutdown_signal=self.shutdown_signal,
            stats=ctx.statistics_manager,
            listener_fn=lambda: ctx.exception_listener,
            tracer=ctx.tracer)
        self.sinks.append(wrapped)
        return wrapped

    def sinks_for(self, stream_id: str) -> list[ResilientSink]:
        return [s for s in self.sinks if s.stream_id == stream_id]

    # -- sources (retry/jitter lives on Source itself) -----------------------
    def wrap_source_handler(self, stream_id: str, handler):
        """The reference wraps the handler with ``@app:chaos`` source
        faults; with no injector the handler is returned unchanged."""
        return handler

    def wrap_source_connect(self, source, stream_id: str) -> None:
        """The reference wraps ``connect`` with ``@app:chaos`` connect
        faults; with no injector there is nothing to wrap."""

    # -- lifecycle -----------------------------------------------------------
    def on_start(self) -> None:
        self.shutdown_signal.clear()

    def on_shutdown(self) -> None:
        """Flips the shutdown signal FIRST so WAIT backoffs and source
        connect retries abort promptly."""
        self.shutdown_signal.set()

    # -- introspection -------------------------------------------------------
    def report(self) -> dict:
        return {"sinks": [s.report() for s in self.sinks]}
