"""The single-stream query workloads at full width: the two configurations
``chip_smoke.py``'s ``query_main`` phase drives and
``tools/profile_query_step.py`` profiles, their seeded event streams, and
the feed loop both time (``BatchBuilder.append_columns`` → ``process``).

(a) ``grouped_length``: the repo's device sample
(``samples/device_offload.py``) at the reference's default capacities.
(b) ``time_minmax_std``: an ungrouped 10 s time window with min/max/stdDev,
about 50,000 live events in a 65,536-slot window.
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
}


def query_events(name: str, n: int, seed: int):
    """(a): 1,000 symbols drawn Zipf(1.1), price U(0, 100), vol U{0..999},
    ts +1 ms per event; (b): 256 devices, v U(0, 100), ts increments 0 ms
    (p = 0.8) or 1 ms (p = 0.2)."""
    rng = np.random.default_rng(seed)
    if name == "grouped_length":
        p = 1.0 / np.arange(1, 1001) ** 1.1
        sym = np.array([f"sym{k}" for k in range(1000)])[
            rng.choice(1000, n, p=p / p.sum())]
        cols = {"sym": sym, "price": rng.uniform(0, 100, n),
                "vol": rng.integers(0, 1000, n)}
        ts = 1_000_000 + np.arange(n, dtype=np.int64)
    else:
        cols = {"dev": np.array([f"dev{k}" for k in range(256)])[
            rng.integers(0, 256, n)], "v": rng.uniform(0, 100, n)}
        ts = 1_000_000 + np.cumsum(rng.random(n) < 0.2).astype(np.int64)
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
