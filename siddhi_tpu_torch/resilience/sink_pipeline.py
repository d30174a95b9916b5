"""Resilient sink publish pipeline.

The port's copy of the JAX package's ``resilience/sink_pipeline.py``.

Reference: ``core/stream/output/sink/Sink.java`` — ``connectWithRetry``,
``onError`` dispatch over ``on.error=WAIT|RETRY|STREAM|STORE|LOG``. Every
wired sink is wrapped; the policy comes from the ``@sink`` annotation's
``on.error`` option (default LOG), tunables ride alongside it:

    @sink(type='...', on.error='retry(3)',
          retry.delay.ms='10', wait.base.ms='100', wait.cap.ms='10000',
          circuit.threshold='5', circuit.cooldown.ms='30000', ...)

Policies (applied per event, after the per-sink circuit breaker):

- ``wait``   — capped exponential backoff + jitter on
  ``ConnectionUnavailableError``, retrying until success or app shutdown
  (backpressure: the delivery thread blocks). Non-transport errors are not
  retried (a deterministic mapper bug would wedge the stream) — they fall
  through to the escalation chain.
- ``retry`` / ``retry(n)`` — up to ``n`` bounded attempts with a short
  fixed delay, then escalate.
- ``stream`` — route the failed event to the stream's fault junction
  (``!stream``), event data + the exception object.
- ``store``  — save to the engine's :class:`~siddhi_tpu_torch.core.errors.ErrorStore`
  with ``occurrence='sink'`` for later replay.
- ``log``    — log and drop (the default; counted in ``sink_dropped``).

Escalation chain (RETRY exhaustion, circuit-open fail-fast, non-retryable
errors under WAIT): error store if one is configured, else the fault
junction if the stream has one, else log+drop. The chain never re-raises
into the delivery path — replaying a stored *sink* failure goes back through
the sink alone, so downstream queries never see a duplicate.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional

from ..core.metrics import CounterTracker, Level
from .circuit import CircuitBreaker
from .chaos import ChaosInjector

log = logging.getLogger("siddhi_tpu_torch.resilience")


class OnErrorPolicy:
    LOG = "log"
    WAIT = "wait"
    RETRY = "retry"
    STREAM = "stream"
    STORE = "store"


def parse_sink_policy(options: dict, defaults: Optional[dict] = None) -> dict:
    """``@sink`` options → policy config dict (annotation values are strings)."""
    d = defaults or {}
    raw = (options.get("on.error") or d.get("on.error") or "log").lower()
    retry_count = int(options.get("retry.count") or d.get("retry.count") or 3)
    if raw.startswith("retry(") and raw.endswith(")"):
        retry_count = int(raw[len("retry("):-1])
        raw = OnErrorPolicy.RETRY
    if raw not in (OnErrorPolicy.LOG, OnErrorPolicy.WAIT, OnErrorPolicy.RETRY,
                   OnErrorPolicy.STREAM, OnErrorPolicy.STORE):
        raise ValueError(
            f"unknown on.error policy '{raw}' "
            f"(known: log, wait, retry, retry(n), stream, store)")
    return {
        "policy": raw,
        "retry_count": retry_count,
        "retry_delay_s": float(options.get("retry.delay.ms")
                               or d.get("retry.delay.ms") or 10) / 1000.0,
        "wait_base_s": float(options.get("wait.base.ms")
                             or d.get("wait.base.ms") or 100) / 1000.0,
        "wait_cap_s": float(options.get("wait.cap.ms")
                            or d.get("wait.cap.ms") or 10000) / 1000.0,
        "circuit_threshold": int(options.get("circuit.threshold")
                                 or d.get("circuit.threshold") or 5),
        "circuit_cooldown_s": float(options.get("circuit.cooldown.ms")
                                    or d.get("circuit.cooldown.ms")
                                    or 30000) / 1000.0,
    }


class ResilientSink:
    """Wraps one wired sink with the on.error pipeline + circuit breaker.

    Delegates the transport SPI (connect/disconnect/attribute access) to the
    wrapped sink, so it drops into every place a bare ``Sink`` is used —
    including as a ``DistributedSink`` destination."""

    def __init__(self, inner, stream_id: str, ordinal: int, cfg: dict,
                 app_name: str,
                 error_store_fn: Callable[[], object],
                 fault_junction_fn: Optional[Callable[[], object]] = None,
                 chaos: Optional[ChaosInjector] = None,
                 shutdown_signal: Optional[threading.Event] = None,
                 stats=None,
                 listener_fn: Optional[Callable[[], object]] = None,
                 tracer=None):
        self._listener_fn = listener_fn or (lambda: None)
        self.inner = inner
        self.stream_id = stream_id
        self.ordinal = ordinal
        self.policy = cfg["policy"]
        self.cfg = cfg
        self.app_name = app_name
        self._error_store_fn = error_store_fn
        self._fault_junction_fn = fault_junction_fn
        self.chaos = chaos
        self._shutdown = shutdown_signal or threading.Event()
        self.breaker = CircuitBreaker(cfg["circuit_threshold"],
                                      cfg["circuit_cooldown_s"])
        self._site = f"sink:{app_name}/{stream_id}[{ordinal}]"
        base = f"sink.{stream_id}.{ordinal}"
        make = stats.counter_tracker if stats is not None else CounterTracker
        self._retry_counter = make(f"{base}.sink_retries")
        self._dropped_counter = make(f"{base}.sink_dropped")
        self._stats = stats
        self._latency = stats.latency_tracker(base) \
            if stats is not None else None
        self.tracer = tracer            # PipelineTracer when @app:trace
        self.published = 0
        self.stored = 0
        self.routed_to_fault = 0

    @property
    def retries(self) -> int:
        return self._retry_counter.count

    @property
    def dropped(self) -> int:
        return self._dropped_counter.count

    # -- transport SPI delegation --------------------------------------------
    def connect(self) -> None:
        self.inner.connect()

    def disconnect(self) -> None:
        self.inner.disconnect()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # -- publish pipeline ----------------------------------------------------
    def on_event(self, event) -> str:
        """Publish through the policy pipeline. Returns the outcome —
        'published' | 'stored' | 'fault' | 'dropped' — so error-store replay
        can judge THIS call without racing other threads' counters."""
        tr = self.tracer.active if self.tracer is not None else None
        track = self._latency is not None and self._stats.level is not Level.OFF
        if tr is None and not track:
            return self._publish(event)
        t0 = time.perf_counter_ns()
        outcome = "error"
        try:
            outcome = self._publish(event)
            return outcome
        finally:
            dt = time.perf_counter_ns() - t0
            if track:
                # publish latency includes retries/backoff — that IS the
                # egress cost the pipeline imposed on this event; a sampled
                # trace becomes the bucket's exemplar
                self._latency.record_seconds(
                    dt / 1e9,
                    exemplar=tr.trace_id if tr is not None else None)
            if tr is not None:
                tr.add_span("sink", self._site, dt, 1, outcome)

    # -- columnar chunk pipeline ---------------------------------------------
    @property
    def rows_capable(self) -> bool:
        return bool(getattr(self.inner, "rows_capable", False))

    def on_columns(self, cols: dict, ts, n: int) -> str:
        """Chunk-level publish: the whole columnar chunk goes through the
        retry/circuit pipeline intact (ONE policy decision per chunk, zero
        per-event objects on the happy path); only a partial or exhausted
        failure falls back to per-event replay, which re-applies the full
        per-event on.error semantics to exactly the unpublished tail."""
        tr = self.tracer.active if self.tracer is not None else None
        track = self._latency is not None and \
            self._stats.level is not Level.OFF
        if tr is None and not track:
            return self._publish_columns(cols, ts, n)
        t0 = time.perf_counter_ns()
        outcome = "error"
        try:
            outcome = self._publish_columns(cols, ts, n)
            return outcome
        finally:
            dt = time.perf_counter_ns() - t0
            if track:
                self._latency.record_seconds(
                    dt / 1e9, n,
                    exemplar=tr.trace_id if tr is not None else None)
            if tr is not None:
                tr.add_span("sink", self._site, dt, n, outcome)

    def _attempt_columns(self, cols, ts, n, start: int) -> None:
        if self.chaos is not None:
            self.chaos.on_sink(self._site)
        if start:
            self.inner.on_columns({k: v[start:] for k, v in cols.items()},
                                  ts[start:], n - start)
        else:
            self.inner.on_columns(cols, ts, n)

    def _publish_columns(self, cols, ts, n: int) -> str:
        from ..core.io import ConnectionUnavailableError, PartialPublishError
        start = 0
        wait = self.policy == OnErrorPolicy.WAIT
        attempts = self.cfg["retry_count"] \
            if self.policy == OnErrorPolicy.RETRY else 1
        attempt = 0
        while True:
            if not self.breaker.allow():
                if not wait or self._shutdown.is_set():
                    # circuit fail-fast: the remaining rows take the
                    # per-event pipeline (store/fault/drop accounting)
                    return self._replay_rows(cols, ts, n, start)
                self._sleep(min(self.breaker.remaining_cooldown()
                                or self.cfg["wait_base_s"],
                                self.cfg["wait_cap_s"]))
                continue
            try:
                self._attempt_columns(cols, ts, n, start)
            except PartialPublishError as e:
                # partial failure: the published prefix must NOT replay —
                # only the tail falls back to the per-event pipeline
                self.breaker.record_failure()
                done = max(0, min(int(e.published), n - start))
                self.published += done
                start += done
                self._retry_counter.inc()
                return self._replay_rows(cols, ts, n, start,
                                         e.cause or e)
            except ConnectionUnavailableError as e:
                self.breaker.record_failure()
                self._retry_counter.inc()
                attempt += 1
                if wait:
                    if self._shutdown.is_set():
                        return self._replay_rows(cols, ts, n, start, e)
                    delay = min(self.cfg["wait_cap_s"],
                                self.cfg["wait_base_s"]
                                * (2 ** (attempt - 1)))
                    delay *= 0.5 + random.random() * 0.5
                    self._sleep(delay)
                    continue
                if attempt < attempts:
                    if self._shutdown.wait(self.cfg["retry_delay_s"]):
                        return self._replay_rows(cols, ts, n, start, e)
                    continue
                return self._replay_rows(cols, ts, n, start, e)
            except Exception as e:  # noqa: BLE001 — policy dispatch point
                self.breaker.record_failure()
                if self.policy == OnErrorPolicy.RETRY \
                        and attempt + 1 < attempts:
                    attempt += 1
                    self._retry_counter.inc()
                    if self._shutdown.wait(self.cfg["retry_delay_s"]):
                        return self._replay_rows(cols, ts, n, start, e)
                    continue
                return self._replay_rows(cols, ts, n, start, e)
            self.breaker.record_success()
            self.published += n - start
            return "published"

    def _replay_rows(self, cols, ts, n: int, start: int,
                     err: Optional[Exception] = None) -> str:
        """Per-event fallback for the unpublished tail of a chunk: each row
        re-enters ``on_event`` so the configured per-event policy (retry /
        store / fault-stream / drop) applies individually — chunk-exactly-
        once: the published prefix never replays."""
        from ..core.columns import columns_to_rows
        from ..core.event import Event
        import numpy as np
        if start >= n:
            return "published"
        names = [a.name for a in self.inner.definition.attributes]
        tail = {k: v[start:] for k, v in cols.items()}
        rows = columns_to_rows(tail, names, n - start)
        tss = np.asarray(ts[start:]).tolist()
        log.warning("%s: chunk publish degraded to per-event replay for "
                    "%d of %d row(s)%s", self._site, n - start, n,
                    f" ({err})" if err else "")
        worst = "published"
        for row, t in zip(rows, tss):
            outcome = self.on_event(Event(int(t), row))
            if outcome != "published":
                worst = outcome
        return worst

    def _publish(self, event) -> str:
        if self.policy == OnErrorPolicy.WAIT:
            # WAIT means wait: an open circuit is slept out inside the loop,
            # never escalated — the policy's contract is lossless egress
            return self._publish_wait(event)
        if not self.breaker.allow():
            return self._escalate(event, ConnectionRefusedByCircuit(
                f"circuit open for {self._site} "
                f"({self.breaker.remaining_cooldown():.1f}s cool-down left)"))
        if self.policy == OnErrorPolicy.RETRY:
            return self._publish_retry(event, self.cfg["retry_count"])
        return self._publish_once(event)

    def _attempt(self, event) -> None:
        if self.chaos is not None:
            self.chaos.on_sink(self._site)
        self.inner.on_event(event)

    def _publish_once(self, event) -> str:
        try:
            self._attempt(event)
        except Exception as e:  # noqa: BLE001 — policy dispatch point
            self.breaker.record_failure()
            return self._dispatch_failure(event, e)
        self.breaker.record_success()
        self.published += 1
        return "published"

    def _publish_retry(self, event, attempts: int) -> str:
        last: Optional[Exception] = None
        for i in range(max(1, attempts)):
            try:
                self._attempt(event)
            except Exception as e:  # noqa: BLE001 — bounded retry loop
                self.breaker.record_failure()
                last = e
                if i + 1 < attempts:
                    self._retry_counter.inc()
                    if self._shutdown.wait(self.cfg["retry_delay_s"]):
                        break
                    if not self.breaker.allow():
                        break            # circuit tripped mid-loop
                continue
            self.breaker.record_success()
            self.published += 1
            return "published"
        log.warning("%s: %d attempt(s) failed, escalating: %s",
                    self._site, attempts, last)
        return self._escalate(event, last)

    def _publish_wait(self, event) -> str:
        from ..core.io import ConnectionUnavailableError
        attempt = 0
        while True:
            # shutdown does NOT skip the publish attempt: drain_async hands
            # queued events to a possibly healthy transport — each gets one
            # try, and only a FAILED try escalates (store-preferred) instead
            # of riding out further backoff
            shutting_down = self._shutdown.is_set()
            if not self.breaker.allow():
                if shutting_down:
                    return self._escalate(event, ConnectionRefusedByCircuit(
                        f"{self._site}: circuit open at shutdown"))
                # circuit open: WAIT means wait — sleep out (a slice of) the
                # cool-down instead of dropping
                self._sleep(min(self.breaker.remaining_cooldown() or
                                self.cfg["wait_base_s"],
                                self.cfg["wait_cap_s"]))
                continue
            try:
                self._attempt(event)
            except ConnectionUnavailableError as e:
                self.breaker.record_failure()
                self._retry_counter.inc()
                attempt += 1
                if shutting_down or self._shutdown.is_set():
                    return self._escalate(event, e)
                delay = min(self.cfg["wait_cap_s"],
                            self.cfg["wait_base_s"] * (2 ** (attempt - 1)))
                delay *= 0.5 + random.random() * 0.5    # decorrelating jitter
                log.warning("%s: transport unavailable (attempt %d), "
                            "retrying in %.3fs: %s", self._site, attempt,
                            delay, e)
                self._sleep(delay)
                continue
            except Exception as e:  # noqa: BLE001 — non-retryable under WAIT
                self.breaker.record_failure()
                return self._escalate(event, e)
            self.breaker.record_success()
            self.published += 1
            return "published"

    def _sleep(self, seconds: float) -> None:
        # interruptible by shutdown; Event.wait returns early when set
        self._shutdown.wait(max(seconds, 0.0))

    # -- failure routing -----------------------------------------------------
    def _dispatch_failure(self, event, e: Exception) -> str:
        if self.policy == OnErrorPolicy.STREAM:
            if self._to_fault_stream(event, e):
                return "fault"
            return self._drop(event, e)
        if self.policy == OnErrorPolicy.STORE:
            if self._to_store(event, e):
                return "stored"
            return self._drop(event, e)
        return self._drop(event, e)     # LOG

    def _escalate(self, event, e: Optional[Exception]) -> str:
        """RETRY exhaustion / circuit fail-fast / WAIT non-retryable: prefer
        the replayable store, then the fault stream, then log+drop."""
        e = e or RuntimeError(f"{self._site}: publish failed")
        if self.policy == OnErrorPolicy.STREAM:
            # an explicit STREAM policy keeps its routing on escalation
            if self._to_fault_stream(event, e):
                return "fault"
        if self._to_store(event, e):
            return "stored"
        if self._to_fault_stream(event, e):
            return "fault"
        return self._drop(event, e)

    def _to_store(self, event, e: Exception) -> bool:
        store = self._error_store_fn()
        if store is None:
            return False
        # the ordinal pins replay to THIS sink — siblings already published
        store.save(self.app_name, self.stream_id, event, e,
                   occurrence="sink", sink_ordinal=self.ordinal)
        self.stored += 1
        log.info("%s: event stored for replay (%s)", self._site, e)
        return True

    def _to_fault_stream(self, event, e: Exception) -> bool:
        if self._fault_junction_fn is None:
            return False
        fj = self._fault_junction_fn()
        if fj is None or not fj.receivers:
            # a fault junction nobody consumes is not routing, it's a silent
            # drop — fall through so escalation reaches log+drop accounting
            return False
        from ..core.event import EventType, StreamEvent
        fj.send_event(StreamEvent(
            getattr(event, "timestamp", 0),
            list(getattr(event, "data", [])) + [e], EventType.CURRENT))
        self.routed_to_fault += 1
        return True

    def _drop(self, event, e: Exception) -> str:
        self._dropped_counter.inc()
        listener = self._listener_fn()
        if listener is not None:
            # apps observing failures via set_exception_listener keep
            # seeing sink errors, as they did before the pipeline wrapped
            # every sink (junction handle_error semantics)
            listener(e)
        else:
            log.error("%s: dropping event %s: %s", self._site,
                      getattr(event, "data", event), e)
        return "dropped"

    # -- introspection -------------------------------------------------------
    def report(self) -> dict:
        return {
            "stream": self.stream_id,
            "ordinal": self.ordinal,
            "policy": self.policy,
            "circuit": self.breaker.state,
            "published": self.published,
            "retries": self.retries,
            "dropped": self.dropped,
            "stored": self.stored,
            "routed_to_fault": self.routed_to_fault,
        }


class ConnectionRefusedByCircuit(Exception):
    """Publish short-circuited by an OPEN breaker (no attempt was made)."""
