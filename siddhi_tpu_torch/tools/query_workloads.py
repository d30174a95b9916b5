"""The single-stream query workloads at full width: the configurations
``chip_smoke.py``'s ``query_main`` phase drives and
``tools/profile_query_step.py`` profiles, their seeded event streams, and
the feed loop both time (``BatchBuilder.append_columns`` → ``process``).

(a) ``grouped_length``: the repo's device sample
(``samples/device_offload.py``) at the reference's default capacities.
(b) ``time_minmax_std``: an ungrouped 10 s time window with min/max/stdDev,
about 50,000 live events in a 65,536-slot window.
(c) ``time_batch``: the Siddhi 5.1 Query Guide's ``timeBatch`` example (an
average per 10 s batch) with the reference's device aggregates; an open
bucket of up to ~50,000 events carried across steps, outputs over 69,632
slots, one collapsed row per closed bucket.
(d) ``lossy_frequent``: the Siddhi Query Guide's ``lossyFrequent`` fraud
example, 50,000 card numbers Zipf(1.1) (the top card holds ~14 % of the
events, so it emits steadily; prunes run every 100 events), table C = 4096.
"""

from __future__ import annotations

import numpy as np

QUERY_MAIN = {
    # the repo's device sample (samples/device_offload.py) at the
    # reference's default capacities
    "grouped_length": dict(app="""
define stream Ticks (sym string, price double, vol long);
from Ticks[price > 10.0]#window.length(4096)
select sym, sum(price) as total, sum(vol) as vsum, count() as n, avg(price) as ap
group by sym insert into Stats;
""", stream="Ticks", batch_capacity=4096, group_capacity=1024),
    "time_minmax_std": dict(app="""
define stream S (dev string, v double);
from S[v > 0.0]#window.time(10 sec)
select avg(v) as av, min(v) as mn, max(v) as mx, stdDev(v) as sd, count() as n
insert into O;
""", stream="S", batch_capacity=4096, window_capacity=65536),
    # the Query Guide's timeBatch example with the device aggregates
    "time_batch": dict(app="""
define stream S (v double, n long);
from S[v > 0.0]#window.timeBatch(10 sec)
select avg(v) as av, min(v) as lo, max(v) as hi, stdDev(v) as sd,
       sum(n) as tn, count() as c
insert into O;
""", stream="S", batch_capacity=4096, window_capacity=65536),
    # the Query Guide's lossyFrequent fraud example
    "lossy_frequent": dict(app="""
define stream Purchase (cardNo string, price double);
from Purchase[price >= 30.0]#window.lossyFrequent(0.1, 0.01, cardNo)
select cardNo, sum(price) as total, count() as n
insert into PotentialFraud;
""", stream="Purchase", batch_capacity=4096),
}


def _zipf(rng, keys: int, n: int, prefix: str) -> np.ndarray:
    p = 1.0 / np.arange(1, keys + 1) ** 1.1
    names = np.array([f"{prefix}{k}" for k in range(keys)])
    return names[rng.choice(keys, n, p=p / p.sum())]


def query_events(name: str, n: int, seed: int):
    """(a): 1,000 symbols drawn Zipf(1.1), price U(0, 100), vol U{0..999},
    ts +1 ms per event; (b): 256 devices, v U(0, 100), ts increments 0 ms
    (p = 0.8) or 1 ms (p = 0.2); (c): v U(-10, 100), n U{0..999}, ts as
    (b); (d): 50,000 card numbers Zipf(1.1), price U(0, 100), ts +1 ms per
    event."""
    rng = np.random.default_rng(seed)
    if name == "grouped_length":
        cols = {"sym": _zipf(rng, 1000, n, "sym"),
                "price": rng.uniform(0, 100, n),
                "vol": rng.integers(0, 1000, n)}
        ts = 1_000_000 + np.arange(n, dtype=np.int64)
    elif name == "time_minmax_std":
        cols = {"dev": np.array([f"dev{k}" for k in range(256)])[
            rng.integers(0, 256, n)], "v": rng.uniform(0, 100, n)}
        ts = 1_000_000 + np.cumsum(rng.random(n) < 0.2).astype(np.int64)
    elif name == "time_batch":
        cols = {"v": rng.uniform(-10, 100, n), "n": rng.integers(0, 1000, n)}
        ts = 1_000_000 + np.cumsum(rng.random(n) < 0.2).astype(np.int64)
    else:
        cols = {"cardNo": _zipf(rng, 50_000, n, "card"),
                "price": rng.uniform(0, 100, n)}
        ts = 1_000_000 + np.arange(n, dtype=np.int64)
    return cols, ts


def feed_query(rt, cols, ts) -> list:
    """``BatchBuilder.append_columns`` → ``process`` (step + decode) per full
    batch, then the last partial batch."""
    rows, start, n = [], 0, len(ts)
    while start < n:
        start += rt.builder.append_columns(cols, ts, start)
        if rt.builder.full or start >= n:
            rows.extend(rt.process(rt.builder.emit()))
    return rows
