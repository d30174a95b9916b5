"""The stream-stream join workloads at full width: the configurations
``chip_smoke.py``'s ``join_main`` phase drives and
``tools/profile_join_step.py`` profiles, their seeded event streams, the
feed loop both time (``MergedBatchBuilder.append_many`` per same-stream run
→ ``flush``), and a direct nested-loop join in numpy that the first steps'
rows are held to.

(e) ``market_join``: the reference's BASELINE config #4 shape and the join
of ``tests/test_tpu_join.py`` (bids against cheaper asks of the same
symbol over 2 s / 3 s sliding windows); Bid/Ask 50/50 at random, +1 ms per
event, 1,000 symbols uniform, prices U(1, 100): ~1,000 live bids and
~1,500 live asks, ~0.6 rows per event.
(f) ``sensor_outer_join``: a left outer join that enriches each
temperature reading with the regulators last seen in its room (length
windows of 2,048 readings and 256 regulator states); 90 % Temp, 10 % Reg,
+1 ms per event, 1,024 rooms uniform, 64 device names: most readings find
no regulator and emit one row with nulls.

Both run B = 4096, ring capacity W = 4096, joined capacity J = 16,384.
"""

from __future__ import annotations

import numpy as np

CAPS = dict(batch_capacity=4096, ring_capacity=4096, joined_capacity=16384)

JOIN_MAIN = {
    "market_join": dict(app="""
define stream Bid (sym string, price double);
define stream Ask (sym string, price double);
from Bid#window.time(2000) join Ask#window.time(3000)
  on Bid.sym == Ask.sym and Ask.price < Bid.price
select Bid.sym as s, Bid.price as bp, Ask.price as ap
insert into O;
""", **CAPS),
    "sensor_outer_join": dict(app="""
define stream Temp (room int, temp double);
define stream Reg (room int, dev string, active bool);
from Temp#window.length(2048) as T left outer join Reg#window.length(256) as R
  on T.room == R.room
select T.room as room, T.temp as temp, R.dev as dev, R.active as active
insert into O;
""", **CAPS),
}


class JoinEvents:
    """One seeded event stream: ``tag`` (0 = the join's left stream) per
    event in arrival order, and per stream its attribute columns and
    timestamps in its own arrival order (strings as Python names)."""

    def __init__(self, streams: tuple, tag, cols: dict, ts: dict):
        self.streams = streams          # (left id, right id)
        self.tag = tag
        self.cols = cols                # stream id → {attr: [n_side]}
        self.ts = ts                    # stream id → int64 [n_side]

    def runs(self, n: int | None = None):
        """(stream id, lo, hi): maximal same-stream runs of the first ``n``
        events, as index ranges into that stream's columns."""
        tag = self.tag if n is None else self.tag[:n]
        if not len(tag):
            return []
        cut = np.flatnonzero(np.diff(tag)) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [len(tag)]])
        seen = np.concatenate([[0], np.cumsum(tag == 1)])   # right events before i
        out = []
        for s, e in zip(starts.tolist(), ends.tolist()):
            side = int(tag[s])
            lo = int(seen[s]) if side else s - int(seen[s])
            out.append((self.streams[side], lo, lo + e - s))
        return out


def join_events(name: str, n: int, seed: int) -> JoinEvents:
    """(e): Bid/Ask 50/50, 1,000 symbols uniform, price U(1, 100); (f):
    Temp 90 %, Reg 10 %, room U{0..1023}, temp U(10, 40), 64 device names,
    active p = 0.5; both +1 ms per event from t = 1,000,000."""
    rng = np.random.default_rng(seed)
    ts_all = 1_000_000 + np.arange(n, dtype=np.int64)
    if name == "market_join":
        tag = (rng.random(n) < 0.5).astype(np.int8)
        syms = np.array([f"S{k:04d}" for k in range(1000)])
        streams = ("Bid", "Ask")
        cols = {}
        for side, sid in enumerate(streams):
            m = int((tag == side).sum())
            cols[sid] = {"sym": syms[rng.integers(0, 1000, m)],
                         "price": rng.uniform(1, 100, m)}
    else:
        tag = (rng.random(n) < 0.1).astype(np.int8)
        streams = ("Temp", "Reg")
        nt, nr = int((tag == 0).sum()), int((tag == 1).sum())
        devs = np.array([f"dev{k:02d}" for k in range(64)])
        cols = {"Temp": {"room": rng.integers(0, 1024, nt).astype(np.int32),
                         "temp": rng.uniform(10, 40, nt)},
                "Reg": {"room": rng.integers(0, 1024, nr).astype(np.int32),
                        "dev": devs[rng.integers(0, 64, nr)],
                        "active": rng.random(nr) < 0.5}}
    ts = {sid: ts_all[tag == side] for side, sid in enumerate(streams)}
    return JoinEvents(streams, tag, cols, ts)


def encode(rt, ev: JoinEvents) -> dict:
    """The streams' columns in the wire's types (dictionary codes for
    strings, through the runtime's one shared dictionary)."""
    from siddhi_tpu_torch.gpu.dtypes import NP
    from siddhi_tpu_torch.query_api.definition import DataType
    merged = rt.compiler.merged
    out = {}
    for sid in ev.streams:
        d = rt.builder.stream_defs[sid]
        out[sid] = {}
        for a in d.attributes:
            v = ev.cols[sid][a.name]
            if a.type == DataType.STRING:
                key = merged.col_key(sid, a.name)
                v = merged.dictionaries[key].encode_array(v)
            out[sid][a.name] = np.ascontiguousarray(v, dtype=NP[a.type])
    return out


def feed_join(rt, ev: JoinEvents, n: int | None = None):
    """Encodes the strings, appends each same-stream run with
    ``append_many`` and flushes every full batch (step + decode), then the
    last partial one. Returns the rows and the row count of each step."""
    cols = encode(rt, ev)
    b = rt.builder
    rows, per_step = [], []

    def step():
        got = rt.flush()
        if got is not None:
            rows.extend(got)
            per_step.append(len(got))

    for sid, lo, hi in ev.runs(n):
        c = {k: v[lo:hi] for k, v in cols[sid].items()}
        t = ev.ts[sid][lo:hi]
        start = 0
        while start < hi - lo:
            start += b.append_many(sid, c, t, start)
            if b.full:
                step()
    step()
    return rows, per_step


def reference_rows(name: str, ev: JoinEvents, n: int) -> list:
    """The rows of the first ``n`` events by a direct nested-loop join in
    numpy: every arrival probes the opposite stream's window as it stands
    (time: earlier arrivals with ts + D > its ts; length: the N latest
    earlier arrivals) and emits its matches in arrival order; (f)'s
    unmatched readings emit one row with nulls. Values in the device's
    types (float32 prices and temperatures)."""
    order = {sid: np.cumsum(ev.tag[:n] == side) - 1
             for side, sid in enumerate(ev.streams)}
    rows = []
    if name == "market_join":
        price = {s: ev.cols[s]["price"].astype(np.float32) for s in ev.streams}
        sym, ts = ev.cols, ev.ts
        for i in range(n):
            side = int(ev.tag[i])
            me, other = ev.streams[side], ev.streams[1 - side]
            k = int(order[me][i])
            m = int(order[other][i]) + 1          # earlier opposite arrivals
            t = ts[me][k]
            D = 2000 if other == "Bid" else 3000
            lo = int(np.searchsorted(ts[other][:m], t - D, side="right"))
            cand = np.arange(lo, m)
            ok = sym[other]["sym"][cand] == sym[me]["sym"][k]
            if side == 0:       # a bid against cheaper asks
                ok &= price[other][cand] < price[me][k]
            else:               # an ask against dearer bids
                ok &= price[me][k] < price[other][cand]
            for j in cand[ok].tolist():
                b, a = (k, j) if side == 0 else (j, k)
                rows.append([str(sym["Bid"]["sym"][b]),
                             float(price["Bid"][b]), float(price["Ask"][a])])
        return rows
    temp = ev.cols["Temp"]["temp"].astype(np.float32)
    troom, rroom = ev.cols["Temp"]["room"], ev.cols["Reg"]["room"]
    dev, act = ev.cols["Reg"]["dev"], ev.cols["Reg"]["active"]
    for i in range(n):
        side = int(ev.tag[i])
        if side == 0:
            k = int(order["Temp"][i])
            m = int(order["Reg"][i]) + 1
            cand = np.arange(max(m - 256, 0), m)
            hit = cand[rroom[cand] == troom[k]].tolist()
            for j in hit:
                rows.append([int(troom[k]), float(temp[k]), str(dev[j]),
                             bool(act[j])])
            if not hit:
                rows.append([int(troom[k]), float(temp[k]), None, None])
        else:
            k = int(order["Reg"][i])
            m = int(order["Temp"][i]) + 1
            cand = np.arange(max(m - 2048, 0), m)
            for j in cand[troom[cand] == rroom[k]].tolist():
                rows.append([int(troom[j]), float(temp[j]), str(dev[k]),
                             bool(act[k])])
    return rows
