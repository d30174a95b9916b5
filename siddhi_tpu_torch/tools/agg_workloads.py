"""The incremental-aggregation workloads at full width: the configurations
``chip_smoke.py``'s ``agg_main`` phase drives and
``tools/profile_agg_step.py`` profiles, their seeded event streams, the two
feeds (``AggregationRuntime.receive`` per event, and bulk staging through
``BatchBuilder.append_columns`` + ``_flush_device``), and a numpy group-by
of the whole stream that the final rows are held to.

(g) ``trade_rollup``: the Siddhi 5.1 Query Guide's incremental-aggregation
example (``TradeAggregation``: per symbol, avg and sum of the price, every
sec ... year, aggregated by the event's ``timestamp``): 1,000 symbols
Zipf(1.1), price U(1, 100), volume U{1..999}, ``timestamp`` = base + i ms,
minus U{0..999} ms on 1 % of events (late trades that reopen closed second
buckets across batches). D = 6.
(h) ``sensor_rollup``: a building-monitoring rollup with a filter, an int
and a string group key, min/max/avg/stdDev/count, every sec ... hour by
``ts``: 64 rooms x 16 devices uniform, temp U(-60, 40) (about 10 % fail
``temp > -50.0``), ``ts`` = base + i ms. D = 3.

Both stage ``@device(batch='4096')`` micro-batches: 2,000,000 events are
489 steps.
"""

from __future__ import annotations

import numpy as np

BASE_TS = 1_700_000_000_000            # 2023-11-14 22:13:20 UTC
BATCH = 4096

AGG_MAIN = {
    "trade_rollup": dict(agg="TradeAggregation", app="""
define stream TradeStream (symbol string, price double, volume long,
                           timestamp long);
@device(batch='4096')
define aggregation TradeAggregation
  from TradeStream
  select symbol, avg(price) as avgPrice, sum(price) as total
    group by symbol
    aggregate by timestamp every sec ... year;
"""),
    "sensor_rollup": dict(agg="SensorAggregation", app="""
define stream SensorStream (roomNo int, deviceId string, temp double, ts long);
@device(batch='4096')
define aggregation SensorAggregation
  from SensorStream[temp > -50.0]
  select roomNo, deviceId, min(temp) as minTemp, max(temp) as maxTemp,
         avg(temp) as avgTemp, stdDev(temp) as sdTemp, count() as n
    group by roomNo, deviceId
    aggregate by ts every sec ... hour;
"""),
}


class AggContext:
    """The app context an ``AggregationRuntime`` needs outside an engine."""

    def __init__(self):
        self.stream_junctions = {}
        self.states = {}

    def register_state(self, key, holder):
        self.states[key] = holder

    def current_time(self):
        return 0

    def lookup_scalar_function(self, namespace, name):
        return None


def build_runtime(name: str, device=None):
    """The configuration's ``AggregationRuntime`` (``device`` as
    ``backend.resolve_device``: the card unless the caller asks for the
    CPU)."""
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.core.aggregation import AggregationRuntime
    cfg = AGG_MAIN[name]
    app = parse(cfg["app"])
    return AggregationRuntime(app.aggregation_definitions[cfg["agg"]],
                              AggContext(), dict(app.stream_definitions),
                              device=device)


def agg_events(name: str, n: int, seed: int) -> dict:
    """The configuration's stream: ``{attr: [n]}`` (strings as Python
    names, DOUBLE as float64) and ``arrival`` (the events' own
    timestamps, base + i ms)."""
    rng = np.random.default_rng(seed)
    arrival = BASE_TS + np.arange(n, dtype=np.int64)
    if name == "trade_rollup":
        ranks = np.arange(1, 1001, dtype=np.float64)
        p = ranks ** -1.1
        syms = np.array([f"S{k:04d}" for k in range(1000)])
        ts = arrival.copy()
        late = rng.random(n) < 0.01
        ts[late] -= rng.integers(0, 1000, int(late.sum()))
        return {"symbol": syms[rng.choice(1000, n, p=p / p.sum())],
                "price": rng.uniform(1, 100, n),
                "volume": rng.integers(1, 1000, n).astype(np.int64),
                "timestamp": ts, "arrival": arrival}
    devs = np.array([f"dev{k:02d}" for k in range(16)])
    return {"roomNo": rng.integers(0, 64, n).astype(np.int32),
            "deviceId": devs[rng.integers(0, 16, n)],
            "temp": rng.uniform(-60, 40, n), "ts": arrival.copy(),
            "arrival": arrival}


def feed_events(rt, ev: dict, stop: int | None = None) -> None:
    """Every event through ``rt.receive(StreamEvent)``, as a stream junction
    delivers them."""
    from siddhi_tpu_torch.core.event import StreamEvent
    names = rt.input_def.attribute_names
    n = len(ev["arrival"]) if stop is None else min(stop, len(ev["arrival"]))
    cols = [ev[a][:n].tolist() for a in names]
    for ts, row in zip(ev["arrival"][:n].tolist(), zip(*cols)):
        rt.receive(StreamEvent(ts, list(row)))


def feed_columns(rt, ev: dict, stop: int | None = None) -> None:
    """Bulk staging: ``append_columns`` into the runtime's batch builder and
    ``_flush_device`` per full batch (the rest waits for the next read)."""
    names = rt.input_def.attribute_names
    n = len(ev["arrival"]) if stop is None else min(stop, len(ev["arrival"]))
    pos = rt.definition.aggregate_attribute
    clock = ev[pos][:n] if pos is not None else ev["arrival"][:n]
    cols = {a: ev[a][:n] for a in names}
    b = rt._dev_builder
    start = 0
    while start < n:
        start += b.append_columns(cols, clock, start)
        if b.full:
            rt._flush_device()


def _bucket(ts: np.ndarray, duration: str) -> np.ndarray:
    ms = {"seconds": 1000, "minutes": 60_000, "hours": 3_600_000,
          "days": 86_400_000}
    if duration in ms:
        return ts - ts % ms[duration]
    unit = "M" if duration == "months" else "Y"
    return ts.astype("datetime64[ms]").astype(f"datetime64[{unit}]") \
        .astype("datetime64[ms]").astype(np.int64)


def numpy_rollup(name: str, ev: dict) -> dict:
    """The expected rollup of the whole stream, per duration: ``{(bucket,
    key...): {"n", "sum", "sumsq", "min", "max"}}`` over the float column
    as sent (float64) and, for min/max, as the f32 wire carries it."""
    if name == "trade_rollup":
        durations = ("seconds", "minutes", "hours", "days", "months", "years")
        keep = np.ones(len(ev["arrival"]), bool)
        clock, keys, x = ev["timestamp"], [ev["symbol"]], ev["price"]
    else:
        durations = ("seconds", "minutes", "hours")
        keep = ev["temp"].astype(np.float32) > np.float32(-50.0)
        clock, keys, x = ev["ts"], [ev["roomNo"], ev["deviceId"]], ev["temp"]
    clock, x = clock[keep], x[keep]
    keys = [k[keep] for k in keys]
    x32 = x.astype(np.float32).astype(np.float64)
    codes = [np.unique(k, return_inverse=True) for k in keys]
    out = {}
    for d in durations:
        b = _bucket(clock, d)
        order = np.lexsort([inv for _, inv in codes][::-1] + [b])
        sb = b[order]
        sk = [inv[order] for _, inv in codes]
        cut = np.flatnonzero((np.diff(sb) != 0) |
                             np.any([np.diff(k) != 0 for k in sk], axis=0)) + 1
        starts = np.concatenate([[0], cut])
        xs, x32s = x[order], x32[order]
        n = np.diff(np.concatenate([starts, [len(order)]]))
        stats = {"n": n, "sum": np.add.reduceat(xs, starts),
                 "sumsq": np.add.reduceat(xs * xs, starts),
                 "min": np.minimum.reduceat(x32s, starts),
                 "max": np.maximum.reduceat(x32s, starts)}
        table = {}
        for r, s in enumerate(starts.tolist()):
            key = (int(sb[s]), *[u[k[s]].item() for (u, _), k in zip(codes, sk)])
            table[key] = {k: v[r].item() for k, v in stats.items()}
        out[d] = table
    return out


def check_rows(name: str, rt, want: dict, rel: float = 1e-4) -> dict:
    """Holds the runtime's ``rows_for`` of every duration to
    ``numpy_rollup``: the same (bucket, key) set; counts exact (``n`` where
    it is selected, else the aggregator's count); min/max exact against the
    f32 wire; avg, sum and stdDev within ``rel`` (and as absolute) of the
    float64 stream: the f32 wire's tolerance. Returns counts per duration;
    raises AssertionError on the first difference."""
    import math
    summary = {}
    for d in rt.definition.durations:
        table = want[d.value]
        rows = rt.rows_for(d)
        assert len(rows) == len(table), (d.value, len(rows), len(table))
        store = rt.stores[d]
        for row in rows:
            if name == "trade_rollup":
                bs, sym, avg, total = row
                key = (bs, sym)
                n = store[bs][(sym,)]["aggs"]["avgPrice"].count
                got = {"n": n, "avg": avg, "sum": total}
            else:
                bs, room, dev, lo, hi, avg, sd, n = row
                key = (bs, room, dev)
                got = {"n": n, "min": lo, "max": hi, "avg": avg, "sd": sd}
            w = table.get(key)
            assert w is not None, (d.value, "unexpected row", row)
            assert got["n"] == w["n"], (d.value, key, got["n"], w["n"])
            exp = {"avg": w["sum"] / w["n"], "sum": w["sum"],
                   "min": w["min"], "max": w["max"],
                   "sd": math.sqrt(max(w["sumsq"] / w["n"] -
                                       (w["sum"] / w["n"]) ** 2, 0.0))}
            for k, v in got.items():
                if k == "n":
                    continue
                if k in ("min", "max"):
                    assert v == exp[k], (d.value, key, k, v, exp[k])
                else:
                    assert math.isclose(v, exp[k], rel_tol=rel, abs_tol=rel), \
                        (d.value, key, k, v, exp[k])
        summary[d.value] = len(rows)
    return summary
