"""Statistics: throughput / latency / memory / buffered-events trackers with
runtime on/off levels and pluggable reporters.

Reference: ``core/util/statistics/`` SPI (``ThroughputTracker``,
``LatencyTracker``, ``MemoryUsageTracker``, ``BufferedEventsTracker``,
``StatisticsManager``) + ``metrics/`` Dropwizard impl
(``SiddhiStatisticsManager.java:35``, ``Level.java`` OFF/BASIC/DETAIL,
``memory/SiddhiMemoryUsageMetric.java`` — an object-graph walker; here
``sys.getsizeof``-based with a fast path for device state, where the honest
figure is the bytes of the tensors: ``torch.Tensor.nbytes``, read without a
copy to the host).

Latency trackers are log-bucketed histograms
(:mod:`siddhi_tpu_torch.observability.histogram`) — p50/p90/p99/p99.9, not just
the average — taken/closed with explicit tokens so concurrent or
re-entrant measurements on one tracker can't mis-pair
(``t = tracker.start(); ...; tracker.stop(t)``).

Reporters: ``@app(statistics='true')`` enables BASIC; @app elements
``statistics.reporter`` ('log' | 'console' | registered name) and
``statistics.interval`` (seconds) configure periodic emission — the analog
of the reference's Dropwizard reporter wiring. Machine scraping goes
through :mod:`siddhi_tpu_torch.observability.prometheus` instead
(``GET /siddhi-apps/{name}/metrics``).
"""

from __future__ import annotations

import enum
import logging
import sys
import threading
import time
from typing import Callable, Optional

from ..observability.histogram import LogHistogram

log = logging.getLogger("siddhi_tpu_torch.metrics")


class Level(enum.Enum):
    OFF = 0
    BASIC = 1
    DETAIL = 2


class ThroughputTracker:
    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def event_in(self, n: int = 1) -> None:
        self.count += n


class LatencyTracker:
    """Latency distribution over one site (histogram-backed).

    Token API: ``t = tracker.start(); ...; tracker.stop(t)`` — tokens are
    plain ``perf_counter_ns`` values, so overlapping measurements from any
    number of threads pair correctly."""

    def __init__(self, name: str):
        self.name = name
        self.hist = LogHistogram()

    def start(self) -> int:
        return time.perf_counter_ns()

    def stop(self, token: int) -> int:
        """Close a measurement opened by :meth:`start`; returns the ns."""
        dt_ns = time.perf_counter_ns() - token
        self.hist.record(dt_ns / 1e9)
        return dt_ns

    def record_seconds(self, seconds: float, n: int = 1,
                       exemplar=None) -> None:
        """Record an externally-timed sample (device step durations);
        ``n`` event-weights batch segments, ``exemplar`` stamps a sampled
        trace id onto the bucket for OpenMetrics exemplar exposition."""
        self.hist.record(seconds, n, exemplar=exemplar)

    # -- readouts --------------------------------------------------------------
    @property
    def count(self) -> int:
        return self.hist.count

    @property
    def total_ns(self) -> int:
        return int(self.hist.sum * 1e9)

    @property
    def avg_ms(self) -> float:
        c = self.hist.count
        return (self.hist.sum / c) * 1e3 if c else 0.0

    def percentiles_ms(self) -> dict:
        s = self.hist.snapshot()
        return {"count": s["count"], "avg_ms": s["avg"] * 1e3,
                "p50_ms": s["p50"] * 1e3, "p90_ms": s["p90"] * 1e3,
                "p99_ms": s["p99"] * 1e3, "p999_ms": s["p999"] * 1e3,
                "max_ms": s["max"] * 1e3}


class _GaugeErrorMixin:
    """A dead gauge reads 0 — but COUNTED and logged once, never silently
    (a zero that is really a failure must be distinguishable)."""

    on_error: Optional[Callable[[], None]] = None
    _error_logged = False

    def _gauge_failed(self, e: Exception):
        if self.on_error is not None:
            self.on_error()
        if not self._error_logged:
            self._error_logged = True
            log.warning("gauge '%s' failed (reads 0 from now on a failure): "
                        "%s", self.name, e)
        return 0


class BufferedEventsTracker(_GaugeErrorMixin):
    """Gauge over a queue-depth callable (reference
    ``BufferedEventsTracker.java`` / ``StreamJunction.getBufferedEvents:359``
    — async junction ring occupancy)."""

    def __init__(self, name: str, depth_fn: Callable[[], int],
                 on_error: Optional[Callable[[], None]] = None):
        self.name = name
        self._depth_fn = depth_fn
        self.on_error = on_error

    @property
    def buffered(self) -> int:
        try:
            return int(self._depth_fn())
        except Exception as e:  # noqa: BLE001 — counted dead-gauge read
            return self._gauge_failed(e)


# shared back-references every element holds — following them would charge
# the whole application graph to each element's gauge (and re-count it per
# element)
_SHARED_ATTRS = frozenset({
    "app_context", "siddhi_context", "ctx", "runtime", "scheduler",
    "next", "callback", "callbacks", "query_callbacks",
})


def _deep_size(obj, seen: set, depth: int = 0) -> int:
    """Retained-size estimate (reference SiddhiMemoryUsageMetric walks the
    object graph). Device arrays report their on-device byte size."""
    if depth > 6 or id(obj) in seen:
        return 0
    seen.add(id(obj))
    nbytes = getattr(obj, "nbytes", None)
    if nbytes is not None and isinstance(nbytes, int):
        return nbytes                          # numpy array / torch tensor
    size = sys.getsizeof(obj, 0)
    if isinstance(obj, dict):
        for k, v in obj.items():
            size += _deep_size(k, seen, depth + 1)
            size += _deep_size(v, seen, depth + 1)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            size += _deep_size(v, seen, depth + 1)
    elif hasattr(obj, "__dict__"):
        pruned = {k: v for k, v in obj.__dict__.items()
                  if k not in _SHARED_ATTRS}
        size += _deep_size(pruned, seen, depth + 1)
    return size


class MemoryUsageTracker(_GaugeErrorMixin):
    """Gauge over a state-holder (reference
    ``memory/SiddhiMemoryUsageMetric.java``'s object-graph walker)."""

    def __init__(self, name: str, target_fn: Callable[[], object],
                 on_error: Optional[Callable[[], None]] = None):
        self.name = name
        self._target_fn = target_fn
        self.on_error = on_error

    @property
    def bytes(self) -> int:
        try:
            return _deep_size(self._target_fn(), set())
        except Exception as e:  # noqa: BLE001 — counted dead-gauge read
            return self._gauge_failed(e)


class CounterTracker:
    """Monotonic counter (vs the sampled :class:`GaugeTracker`) — the
    resilience layer's ``sink_retries`` / ``sink_dropped`` / chaos fault
    counts, incremented at the failure site and reported alongside gauges."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def inc(self, n: int = 1) -> None:
        self.count += n


class GaugeTracker(_GaugeErrorMixin):
    """Generic numeric gauge over a callable — the flow subsystem's
    wal_bytes / queue_depth / credits / shed_count / batch_size readouts
    (counterpart of the reference's Dropwizard ``Gauge`` registrations)."""

    def __init__(self, name: str, value_fn: Callable[[], float],
                 on_error: Optional[Callable[[], None]] = None):
        self.name = name
        self._value_fn = value_fn
        self.on_error = on_error

    @property
    def value(self):
        try:
            return self._value_fn()
        except Exception as e:  # noqa: BLE001 — counted dead-gauge read
            return self._gauge_failed(e)


class Reporter:
    """Reporter SPI: receives the report dict every interval."""

    def report(self, data: dict) -> None:
        raise NotImplementedError


class LogReporter(Reporter):
    def report(self, data: dict) -> None:
        log.info("statistics %s: %s", data.get("app"), data)


class ConsoleReporter(Reporter):
    def report(self, data: dict) -> None:
        print(f"[statistics] {data}")


REPORTERS: dict[str, type] = {"log": LogReporter, "console": ConsoleReporter}


class StatisticsManager:
    def __init__(self, app_name: str):
        self.app_name = app_name
        self.level = Level.OFF
        self.throughput: dict[str, ThroughputTracker] = {}
        self.latency: dict[str, LatencyTracker] = {}
        self.buffered: dict[str, BufferedEventsTracker] = {}
        self.memory: dict[str, MemoryUsageTracker] = {}
        self.gauges: dict[str, GaugeTracker] = {}
        self.counters: dict[str, CounterTracker] = {}
        self.reporter: Optional[Reporter] = None
        self.report_interval_s: float = 60.0
        self._timer: Optional[threading.Timer] = None
        self._reporting = False
        self._generation = 0        # invalidates stale tick re-arms
        self._lock = threading.Lock()
        # failed gauge reads land here (and log once per gauge) so a dead
        # gauge is distinguishable from a true zero
        self.gauge_errors = CounterTracker("app.gauge_errors")
        self.counters["app.gauge_errors"] = self.gauge_errors

    # registration runs at deploy time while the reporter timer may already
    # be iterating — every mutation of the tracker dicts takes the lock,
    # and report()/exposition snapshot under it
    def throughput_tracker(self, name: str) -> ThroughputTracker:
        with self._lock:
            return self.throughput.setdefault(name, ThroughputTracker(name))

    def latency_tracker(self, name: str) -> LatencyTracker:
        with self._lock:
            return self.latency.setdefault(name, LatencyTracker(name))

    def buffered_tracker(self, name: str, depth_fn) -> BufferedEventsTracker:
        with self._lock:
            return self.buffered.setdefault(
                name, BufferedEventsTracker(name, depth_fn,
                                            self.gauge_errors.inc))

    def memory_tracker(self, name: str, target_fn) -> MemoryUsageTracker:
        with self._lock:
            return self.memory.setdefault(
                name, MemoryUsageTracker(name, target_fn,
                                         self.gauge_errors.inc))

    def gauge_tracker(self, name: str, value_fn) -> GaugeTracker:
        with self._lock:
            return self.gauges.setdefault(
                name, GaugeTracker(name, value_fn, self.gauge_errors.inc))

    def counter_tracker(self, name: str) -> CounterTracker:
        with self._lock:
            return self.counters.setdefault(name, CounterTracker(name))

    def unregister(self, prefix: str) -> int:
        """Remove every tracker whose registration key starts with
        ``prefix`` (a component tearing down — e.g. a DCN worker closing or
        a released lane group — must not leave dead gauges behind to read 0
        forever); returns the number removed."""
        removed = 0
        with self._lock:
            for d in (self.throughput, self.latency, self.buffered,
                      self.memory, self.gauges, self.counters):
                for k in [k for k in d if k.startswith(prefix)]:
                    del d[k]
                    removed += 1
        return removed

    def snapshot_trackers(self) -> dict:
        """Point-in-time shallow copies of every tracker dict — iterate
        these, not the live dicts, so deploy-time registration can't mutate
        mid-walk (values are evaluated OUTSIDE the lock: memory walkers and
        gauges may be slow or re-entrant)."""
        with self._lock:
            return {
                "throughput": dict(self.throughput),
                "latency": dict(self.latency),
                "buffered": dict(self.buffered),
                "memory": dict(self.memory),
                "gauges": dict(self.gauges),
                "counters": dict(self.counters),
            }

    def set_level(self, level: Level) -> None:
        self.level = level

    # -- reporter wiring ------------------------------------------------------
    def configure_reporter(self, name: Optional[str],
                           interval_s: Optional[float] = None) -> None:
        if name:
            cls = REPORTERS.get(name.lower())
            if cls is None:
                raise ValueError(
                    f"unknown statistics reporter '{name}' "
                    f"(known: {sorted(REPORTERS)})")
            self.reporter = cls()
        if interval_s is not None:
            self.report_interval_s = float(interval_s)

    def start_reporting(self) -> None:
        if self.reporter is None:
            return
        with self._lock:
            if self._timer is not None:     # chain already armed — checked
                return                      # under the lock: two concurrent
            # starts must not arm two chains
            self._reporting = True
            self._generation += 1
            gen = self._generation

        def tick():
            if self.level != Level.OFF and self.reporter is not None:
                try:
                    self.reporter.report(self.report())
                except Exception:       # noqa: BLE001
                    log.exception("statistics reporter failed")
            with self._lock:
                # a stop racing an in-flight tick would otherwise cancel the
                # already-fired timer while this re-arm keeps the chain
                # alive; the generation check keeps a stale tick from
                # re-arming alongside a chain started AFTER that stop
                if not self._reporting or self._generation != gen:
                    return
                self._timer = threading.Timer(self.report_interval_s, tick)
                self._timer.daemon = True
                self._timer.start()

        with self._lock:
            if not self._reporting or self._generation != gen:
                return                      # stopped before the first arm
            self._timer = threading.Timer(self.report_interval_s, tick)
            self._timer.daemon = True
            self._timer.start()

    def stop_reporting(self) -> None:
        with self._lock:
            self._reporting = False
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def report(self) -> dict:
        snap = self.snapshot_trackers()
        data = {
            "app": self.app_name,
            "level": self.level.name,
            "throughput": {k: v.count for k, v in snap["throughput"].items()},
            "latency_avg_ms": {k: v.avg_ms
                               for k, v in snap["latency"].items()},
            "buffered_events": {k: v.buffered
                                for k, v in snap["buffered"].items()},
        }
        if snap["latency"]:
            data["latency"] = {k: v.percentiles_ms()
                               for k, v in snap["latency"].items()}
        if snap["gauges"]:
            data["gauges"] = {k: v.value for k, v in snap["gauges"].items()}
        counters = {k: v.count for k, v in snap["counters"].items()
                    if v.count or k != "app.gauge_errors"}
        if counters:
            data["counters"] = counters
        if self.level == Level.DETAIL:
            data["memory_bytes"] = {k: v.bytes
                                    for k, v in snap["memory"].items()}
        return data
