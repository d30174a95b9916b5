"""Step containment for the shared-execution host tiers.

The port's copy of the part of the JAX package's
``resilience/fleet_guard.py`` that the columnar host tier needs: the scalar
escalation the containment ladders share (``build_scalar_escalation``,
``replay_rows_scalar``) and :class:`HostStepGuard`, the host-batch tier's
containment — the per-query analog of
:class:`~siddhi_tpu_torch.resilience.device_guard.DeviceGuard`, one tier
down: a failing columnar micro-batch replays its raw rows through a lazily
built scalar interpreter runtime (zero loss), and repeated failures
quarantine the columnar path behind a circuit breaker.

``FleetGuard``, ``TenantLane`` and ``PolicyEviction`` guard the fleet's
shared lanes and come with the fleet (``ROADMAP.md`` §A item 5).
"""

from __future__ import annotations

import logging
import threading

from .circuit import CircuitBreaker, CircuitState

log = logging.getLogger("siddhi_tpu_torch.resilience")


def build_scalar_escalation(query, app_context, stream_defs: dict,
                            get_junction, name: str, shared_callbacks,
                            site: str):
    """The ladder's bottom, shared by the fleet's guard and HostStepGuard: a
    scalar interpreter runtime for ``query``, its callback list aliased to
    the guarded bridge's so registered query callbacks see escalated
    outputs too. Returns None when even this build fails (the caller
    counts the rows as lost). root_lock FIRST — building registers state
    holders the snapshot walk iterates under the same lock."""
    with app_context.root_lock:
        try:
            from ..core.query_runtime import build_query_runtime
            rt = build_query_runtime(query, app_context, stream_defs,
                                     get_junction, name)
            if shared_callbacks is not None:
                rt.callback_adapter.callbacks = shared_callbacks
            rt.start()
            return rt
        except Exception:  # noqa: BLE001 — the ladder ran out: count the
            # rows as lost rather than killing co-tenant delivery
            log.exception("%s: scalar escalation build failed", site)
            return None


def replay_rows_scalar(rt, sid_of_si, shadow_rows, shadow_ts, root_lock,
                       site: str) -> tuple:
    """Replay raw ``(si, row)`` shadow rows through a scalar runtime's
    subscriptions in order; returns ``(delivered, lost)``. Each row is
    contained individually — a poison row that makes even the scalar
    interpreter raise is counted lost and the LATER rows still deliver
    (aborting mid-loop would silently drop the whole tail and leak the
    exception back into ingress)."""
    from ..core.event import EventType, StreamEvent
    delivered = lost = 0
    with root_lock:
        for (si, row), ts in zip(shadow_rows, shadow_ts):
            ev = StreamEvent(ts, list(row), EventType.CURRENT)
            lsid = sid_of_si(si)
            try:
                for rsid, receiver in rt.subscriptions:
                    if rsid == lsid:
                        receiver.receive(ev)
            except Exception:  # noqa: BLE001 — the ladder's last rung: a
                # row even the scalar interpreter rejects is counted lost
                lost += 1
                continue
            delivered += 1
    if lost:
        log.warning("%s: %d poison row(s) rejected by the scalar "
                    "interpreter during replay (counted lost)", site, lost)
    return delivered, lost


# ---------------------------------------------------------------------------
# host-batch tier containment (the third shared-execution step entry point)
# ---------------------------------------------------------------------------

class HostStepGuard:
    """Containment for the columnar host tier (``core/host_bridge.py``): a
    failing micro-batch step replays its raw rows through a lazily built
    scalar interpreter runtime (zero loss), and repeated failures quarantine
    the columnar path behind a circuit breaker — the per-query analog of
    DeviceGuard, one tier down. Installed by ``ResilienceSubsystem.
    guard_host`` over every host-batch bridge."""

    def __init__(self, bridge, query, app_context, stream_defs: dict,
                 get_junction, failure_threshold: int = 3,
                 cooldown_s: float = 30.0):
        self.bridge = bridge
        self.query = query
        self.app_context = app_context
        self.stream_defs = dict(stream_defs)
        self.get_junction = get_junction
        self.breaker = CircuitBreaker(failure_threshold, cooldown_s)
        self.query_name = bridge.query_name
        self._site = f"host_batch:{app_context.name}/{bridge.query_name}"
        self.flight = None          # FlightRecorder (observability wiring)
        self.failures = 0
        self.fallback_events = 0
        self.lost_events = 0
        self._fb_runtime = None
        self._fb_lock = threading.Lock()

    def install(self) -> None:
        rt = self.bridge.runtime
        inner_flush = rt.flush
        guard = self

        def flush():
            builder = rt.builder
            if len(builder) == 0:
                return inner_flush()
            # shallow shadow: pointer copies only (row lists OR whole
            # column chunks — builder.shadow() keeps the columnar staging
            # zero-object; rows materialize only on the failure path)
            if not guard.breaker.allow():
                # columnar path quarantined: drain straight to the scalar
                # interpreter without touching the failing engine
                shadow = builder.shadow()
                builder.clear()
                guard._fallback(shadow, quarantined=True)
                return None
            shadow = builder.shadow()
            try:
                out = inner_flush()
            except Exception as e:  # noqa: BLE001 — quarantine boundary:
                # the failed micro-batch reroutes to the scalar path
                guard.failures += 1
                was_open = guard.breaker.state == CircuitState.OPEN
                guard.breaker.record_failure()
                log.warning("%s: columnar step failed (%d consecutive, "
                            "circuit %s): %s", guard._site,
                            guard.breaker.consecutive_failures,
                            guard.breaker.state, e, exc_info=True)
                fl = guard.flight
                if fl is not None:
                    fl.record("host", "step_failed", site=guard.query_name,
                              detail={"error":
                                      f"{type(e).__name__}: {e}"[:200]})
                    if not was_open and \
                            guard.breaker.state == CircuitState.OPEN:
                        fl.record("host", "quarantined",
                                  site=guard.query_name)
                        fl.on_fault("host_quarantine",
                                    site=guard.query_name)
                # an EMIT-time failure (encode of a poison row) leaves the
                # rows staged (the stager resets only on success) — clear
                # them, or every later flush would fail again and re-replay
                # the same shadow, duplicating outputs
                builder.clear()
                guard._fallback(shadow)
                return None
            guard.breaker.record_success()
            return out

        rt.flush = flush

    def _fallback(self, shadow: dict, quarantined: bool = False) -> None:
        rows, tss = self.bridge.runtime.builder.shadow_rows(shadow)
        if not rows:
            return
        rt = self._fallback_runtime()
        if rt is None:
            self.lost_events += len(rows)
            return
        sids = self.bridge.stream_ids
        delivered, lost = replay_rows_scalar(
            rt, lambda si: sids[si] if si < len(sids) else sids[0],
            rows, tss, self.app_context.root_lock, self._site)
        self.fallback_events += delivered
        self.lost_events += lost
        log.info("%s: %d event(s) rerouted through the scalar "
                 "interpreter%s", self._site, delivered,
                 " (columnar quarantined)" if quarantined else "")

    def _fallback_runtime(self):
        if getattr(self.bridge, "kind", "") == "host_partition":
            # a partition-block pattern replayed through a plain scalar
            # runtime would match ACROSS keys — wrong results are worse
            # than counted loss, so the ladder stops here
            return None
        with self.app_context.root_lock:
            with self._fb_lock:
                if self._fb_runtime is None:
                    self._fb_runtime = build_scalar_escalation(
                        self.query, self.app_context, self.stream_defs,
                        self.get_junction, f"{self.query_name}__hostfb",
                        self.bridge.query_callbacks, self._site)
                return self._fb_runtime

    def report(self) -> dict:
        return {
            "query": self.query_name,
            "circuit": self.breaker.state,
            "failures": self.failures,
            "fallback_events": self.fallback_events,
            "lost_events": self.lost_events,
        }
