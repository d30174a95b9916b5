"""Log-bucketed latency histogram: percentiles for the statistics SPI.

The reference's Dropwizard ``Timer`` keeps an exponentially-decaying
reservoir; here a fixed geometric bucket ladder (Hazelcast Jet's
"99.99th percentile" argument, arXiv:2103.10169: tail latency is the
product, averages are the wrong statistic for a streaming engine) —
O(1) lock-held time per sample, mergeable, and directly renderable as a
Prometheus histogram (the cumulative ``le`` ladder IS the bucket array).

Bucket ``i`` covers ``(min_value * growth**(i-1), min_value * growth**i]``;
with the default quarter-octave growth (``2**0.25 ≈ 1.19``) any reported
percentile is within ~19% of the true sample quantile, over a range of
1µs .. ~1.6h in 128 buckets.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

# quarter-octave ladder: 128 buckets cover 1e-6 s .. ~6000 s
DEFAULT_MIN = 1e-6
DEFAULT_GROWTH = 2.0 ** 0.25
DEFAULT_BUCKETS = 128


class LogHistogram:
    """Thread-safe geometric-bucket histogram over positive float samples
    (seconds by convention)."""

    def __init__(self, min_value: float = DEFAULT_MIN,
                 growth: float = DEFAULT_GROWTH,
                 num_buckets: int = DEFAULT_BUCKETS):
        if min_value <= 0 or growth <= 1.0 or num_buckets < 2:
            raise ValueError(
                f"bad histogram shape (min={min_value}, growth={growth}, "
                f"buckets={num_buckets})")
        self.min_value = float(min_value)
        self.growth = float(growth)
        self._log_growth = math.log(growth)
        # counts[i] guards (bounds[i-1], bounds[i]]; counts[-1] is overflow
        self._bounds = [min_value * growth ** i for i in range(num_buckets)]
        self._counts = [0] * (num_buckets + 1)
        # bucket index -> (trace_id, value, unix_ts); None until the first
        # exemplar so untraced apps allocate nothing
        self._exemplars: Optional[dict] = None
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _index(self, value: float) -> int:
        if value <= self.min_value:
            return 0
        i = int(math.ceil(math.log(value / self.min_value) / self._log_growth))
        return min(i, len(self._bounds))       # len(_bounds) == overflow slot

    def record(self, value: float, n: int = 1, exemplar=None) -> None:
        """Record ``n`` samples of ``value`` (event-weighted batch segments
        record their per-event average once with the batch's event count).
        ``exemplar`` links a trace id to the bucket the sample landed in —
        stored lazily, so untraced apps pay nothing and the exposition is
        byte-identical until the first exemplar arrives."""
        v = float(value)
        if v < 0.0 or v != v:                  # negative / NaN: clamp out
            v = 0.0
        if n < 1:
            return
        i = self._index(v)
        with self._lock:
            self._counts[i] += n
            self.count += n
            self.sum += v * n
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = {}
                # one exemplar per bucket (the newest) — bounded by the
                # bucket count, per the OpenMetrics le-bucket exemplar model
                self._exemplars[i] = (str(exemplar), v, time.time())

    # -- readouts --------------------------------------------------------------
    def _percentile_of(self, counts, count: int, q: float,
                       cap: Optional[float]) -> float:
        """Percentile over an arbitrary counts array sharing this ladder's
        bucket bounds (``cap`` bounds the overflow-bucket answer)."""
        if count == 0:
            return 0.0
        rank = max(1, math.ceil(q * count))
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                if i >= len(self._bounds):          # overflow bucket
                    return cap if cap is not None else self._bounds[-1]
                return min(self._bounds[i],
                           cap if cap is not None else self._bounds[i])
        return cap or 0.0                           # unreachable

    def percentile(self, q: float) -> float:
        """Upper bucket bound at quantile ``q`` in [0, 1] (0.0 when empty).
        Conservative: the true sample quantile is ≤ the returned value and
        > returned/growth."""
        with self._lock:
            return self._percentile_of(self._counts, self.count, q, self.max)

    # -- interval snapshots (the control-plane view) ---------------------------
    def checkpoint(self) -> tuple:
        """Opaque cursor over the current bucket state. Feed it back to
        :meth:`since` for a WINDOWED snapshot — cumulative-since-start
        percentiles flatten out as history accumulates and cannot drive a
        control loop (a ten-minute-old tail masks the last 200ms)."""
        with self._lock:
            return (list(self._counts), self.count, self.sum)

    def since(self, chk: tuple) -> dict:
        """Percentile snapshot over the samples recorded AFTER ``chk`` was
        taken — the interval view the SLO controller samples. Returns the
        same shape as :meth:`snapshot` minus min/max (not tracked per
        interval; p-values are upper bucket bounds, so they stay
        conservative)."""
        prev_counts, prev_count, prev_sum = chk
        with self._lock:
            d_counts = [c - p for c, p in zip(self._counts, prev_counts)]
            d_count = self.count - prev_count
            d_sum = self.sum - prev_sum
            if d_count <= 0:
                return {"count": 0, "sum": 0.0, "avg": 0.0, "p50": 0.0,
                        "p90": 0.0, "p99": 0.0}
            return {
                "count": d_count,
                "sum": d_sum,
                "avg": d_sum / d_count,
                "p50": self._percentile_of(d_counts, d_count, 0.50, self.max),
                "p90": self._percentile_of(d_counts, d_count, 0.90, self.max),
                "p99": self._percentile_of(d_counts, d_count, 0.99, self.max),
            }

    # -- serializable state (federation over the procmesh control wire) --------
    def state(self) -> dict:
        """One consistent, JSON-safe dump of the full histogram: ladder
        shape + raw (non-cumulative) bucket counts, trimmed past the last
        occupied slot. Two states on the same ladder merge by summing
        counts — the fixed geometric bounds are the merge invariant."""
        with self._lock:
            last = -1
            for i, c in enumerate(self._counts):
                if c:
                    last = i
            return {
                "min_value": self.min_value,
                "growth": self.growth,
                "num_buckets": len(self._bounds),
                "counts": self._counts[:last + 1],
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
            }

    def _check_ladder(self, state: dict) -> None:
        if (abs(state["min_value"] - self.min_value) > 1e-12
                or abs(state["growth"] - self.growth) > 1e-12
                or state["num_buckets"] != len(self._bounds)):
            raise ValueError(
                f"histogram ladder mismatch: cannot merge "
                f"(min={state['min_value']}, growth={state['growth']}, "
                f"buckets={state['num_buckets']}) into "
                f"(min={self.min_value}, growth={self.growth}, "
                f"buckets={len(self._bounds)})")

    def merge_state(self, state: dict) -> None:
        """Fold a :meth:`state` dump into this histogram by summing bucket
        counts. Raises ``ValueError`` on a ladder mismatch — merging
        across different bucket bounds would silently misbucket."""
        self._check_ladder(state)
        counts = state["counts"]
        if len(counts) > len(self._counts):
            raise ValueError("histogram state has more counts than ladder")
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += int(c)
            self.count += int(state["count"])
            self.sum += float(state["sum"])
            smin, smax = state.get("min"), state.get("max")
            if smin is not None:
                self.min = smin if self.min is None else min(self.min, smin)
            if smax is not None:
                self.max = smax if self.max is None else max(self.max, smax)

    @classmethod
    def merge(cls, states) -> "LogHistogram":
        """Build one histogram from an iterable of :meth:`state` dumps
        (empty iterable → empty histogram on the default ladder). All
        states must share one ladder."""
        out = None
        for st in states:
            if out is None:
                out = cls(st["min_value"], st["growth"], st["num_buckets"])
            out.merge_state(st)
        return out if out is not None else cls()

    def export(self) -> tuple[list[tuple[float, int]], int, float]:
        """One consistent ``(buckets, count, sum)`` read under the lock —
        exposition must not read buckets and count separately, or a
        concurrent :meth:`record` renders ``_count`` != the ``+Inf``
        bucket (a malformed Prometheus histogram)."""
        with self._lock:
            last = 0
            for i, c in enumerate(self._counts[:-1]):
                if c:
                    last = i
            out, cum = [], 0
            for i in range(last + 1):
                cum += self._counts[i]
                out.append((self._bounds[i], cum))
            return out, self.count, self.sum

    def exemplars(self) -> dict:
        """``le_bound -> (trace_id, value, unix_ts)`` for buckets holding an
        exemplar (empty when tracing never stamped one). The overflow
        bucket's exemplar reports under ``+Inf`` (math.inf key)."""
        with self._lock:
            if not self._exemplars:
                return {}
            out = {}
            for i, ex in self._exemplars.items():
                le = self._bounds[i] if i < len(self._bounds) \
                    else math.inf
                out[le] = ex
            return out

    def buckets(self) -> list[tuple[float, int]]:
        """Cumulative ``(le_bound, count)`` pairs, trimmed past the last
        occupied bucket (callers append the implicit ``+Inf == count``
        themselves; for exposition use :meth:`export`)."""
        return self.export()[0]

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.sum
            mn, mx = self.min, self.max
        if count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "avg": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0,
                    "p999": 0.0}
        return {
            "count": count,
            "sum": total,
            "min": mn,
            "max": mx,
            "avg": total / count,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
            "p999": self.percentile(0.999),
        }
