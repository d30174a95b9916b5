"""The port's engine device tier against the JAX package's engine, family by
family.

The same app text and the same seeded events go through
``siddhi_tpu.SiddhiManager`` (JAX on the CPU, as ``tests/test_device_pipeline.py``
runs it) and ``siddhi_tpu_torch.SiddhiManager(device="cpu")``: every query is
``@device(strict='true')``, fed through ``InputHandler.send`` (per event) or
``send_columns``. The output stream's callback sees ``(timestamp, data)``
sequences that must be equal in order: bitwise for the blocked and scan NFA,
the join and the aggregation (read with ``rt.query``); float32 query sums,
avgs and stdDev within the tolerances of ``tests/test_torch_query_shapes.py``
(``assert_rows_close`` of ``tests/test_torch_runtime.py``). Also: the async
driver against the synchronous path and its in-flight window of 1 against
2, ``output last every 3 events`` on decoded device rows, and the reference
bridge's state and dictionaries carried into the port bridge's runtime
through ``gpu/state_io`` (blocked chain, grouped length window).
"""

import jax
import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from test_torch_runtime import _Fed, assert_rows_close

OUT = "Out"


# ------------------------------------------------------------------ events

def f32(x) -> list:
    """float32-representable Python floats: both engines carry DOUBLE as
    float32 on the device."""
    return np.asarray(x, dtype=np.float32).astype(np.float64).tolist()


def stream_events(seed: int, n: int, streams: dict, gap: int = 7,
                  t0: int = 1000):
    """``n`` events ``(stream id, row, ts)``: each stream drawn with its
    weight, its row by its generator, ts rising by 0..gap ms."""
    rng = np.random.default_rng(seed)
    ids = list(streams)
    w = np.array([streams[s][0] for s in ids], dtype=np.float64)
    pick = rng.choice(len(ids), n, p=w / w.sum())
    ts = t0 + np.cumsum(rng.integers(0, gap + 1, n))
    return [(ids[k], streams[ids[k]][1](rng), int(t))
            for k, t in zip(pick.tolist(), ts.tolist())]


def _dev_v(keys: int, lo: float = 0.0, hi: float = 100.0):
    return lambda rng: [f"d{int(rng.integers(keys))}",
                        f32(rng.uniform(lo, hi))]


def _v(lo: float = 0.0, hi: float = 100.0):
    return lambda rng: [f32(rng.uniform(lo, hi))]


# ------------------------------------------------------------------ engines

def ref_manager():
    return siddhi_tpu.SiddhiManager()


def port_manager():
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def start(manager, app: str, start_time: int = 0, out: str = OUT):
    """A started playback runtime whose ``out`` stream rows collect in
    ``rt.got`` as ``(timestamp, data)``."""
    rt = manager.create_siddhi_app_runtime(app, playback=True,
                                           start_time=start_time)
    rt.got = []
    cb = type(manager).__module__.split(".")[0]
    cls = siddhi_tpu_torch.StreamCallback if cb == "siddhi_tpu_torch" \
        else siddhi_tpu.StreamCallback
    rt.add_callback(out, cls(lambda evs: rt.got.extend(
        (e.timestamp, list(e.data)) for e in evs)))
    rt.start()
    return rt


def send(rt, events) -> None:
    for sid, row, ts in events:
        rt.input_handler(sid).send(list(row), timestamp=ts)


def send_columns(rt, sid: str, names: list, events, chunk: int = 50) -> None:
    """The events (one stream) as columnar chunks of ``chunk`` rows (string
    columns as object arrays, as both engines' builders take them)."""
    for lo in range(0, len(events), chunk):
        part = events[lo:lo + chunk]
        cols = {}
        for i, a in enumerate(names):
            vals = [r[i] for _, r, _ in part]
            cols[a] = np.array(vals, dtype=object
                               if isinstance(vals[0], str) else None)
        ts = np.array([t for _, _, t in part], dtype=np.int64)
        rt.input_handler(sid).send_columns(cols, ts)


def run(manager, app: str, events, start_time: int = 0, columns=None,
        finish: str = "flush"):
    """Drives one engine; ``columns=(sid, names)`` feeds ``send_columns``;
    ``finish`` is ``"flush"`` (``flush_device``) or ``"shutdown"``."""
    rt = start(manager, app, start_time)
    if columns is None:
        send(rt, events)
    else:
        send_columns(rt, *columns, events)
    if finish == "flush":
        rt.flush_device()
    got = rt.got
    manager.shutdown()
    return got, rt


def both(app: str, events, **kw):
    ref, _ = run(ref_manager(), app, events, **kw)
    got, prt = run(port_manager(), app, events, **kw)
    return ref, got, prt


def assert_query_rows(prt, ref, got, fed) -> None:
    """Timestamps equal in order; values by the query tolerance classes."""
    assert [t for t, _ in ref] == [t for t, _ in got]
    assert_rows_close(prt.device_bridges[0].runtime.compiled,
                      [r for _, r in ref], [r for _, r in got], fed.scale)


def port_query(app: str, events, **kw):
    """The port engine on a single-stream query with its tolerance scale
    (``_Fed`` over the bridge runtime's steps)."""
    m = port_manager()
    rt = start(m, app, kw.pop("start_time", 0))
    fed = _Fed(rt.device_bridges[0].runtime)
    columns = kw.pop("columns", None)
    if columns is None:
        send(rt, events)
    else:
        send_columns(rt, *columns, events)
    if kw.pop("finish", "flush") == "flush":
        rt.flush_device()
    got = rt.got
    rt.rows_before_shutdown = len(got)
    m.shutdown()
    return got, rt, fed


# ------------------------------------------------------------ NFA families

CHAIN = """
define stream S (dev string, v double);
@device(batch='64', slots='16', strict='true')
from every e1=S[v > 70.0] -> e2=S[v > e1.v] -> e3=S[v > e2.v] within 300
select e1.dev as dev, e1.v as v1, e2.v as v2, e3.v as v3
insert into Out;
"""

SCAN_APPS = {
    # count <2:4> between two stream states
    "count": ("""
define stream A (v double);
define stream B (v double);
@device(batch='64', slots='16', strict='true')
from every e1=A[v > 50.0] -> e2=B[v > e1.v]<2:4> -> e3=A[v < e1.v]
within 400
select e1.v as a, e3.v as c insert into Out;
""", {"A": (1, _v()), "B": (1, _v())}, 0),
    # the scan app of chip_smoke.py without its partition: `and`, a count
    "and": ("""
define stream Temp (dev string, v double);
define stream Reg (dev string, action string);
@device(batch='64', slots='16', strict='true')
from every e1=Temp[v > 90.0] -> e2=Temp[v > e1.v] and e3=Reg[action == 'on']
  -> e4=Temp[v > e2.v]<2:4> -> e5=Temp[v < e1.v] within 4000
select e1.dev as dev, e1.v as v1, e3.action as a, e5.v as v5 insert into Out;
""", {"Temp": (9, _dev_v(4, 60.0, 100.0)),
      "Reg": (1, lambda rng: [f"d{int(rng.integers(4))}",
                              ["on", "off"][int(rng.integers(2))]])}, 0),
    # absent start: the seed's clock arms at the app's start time
    "absent_start": ("""
define stream A (v double);
define stream B (v double);
@device(batch='64', slots='16', strict='true')
from every not A[v > 80.0] for 100 milliseconds -> e2=B[v > 50.0]
select e2.v as v2 insert into Out;
""", {"A": (3, _v()), "B": (2, _v())}, 1000),
}


def test_blocked_chain_matches_reference():
    events = stream_events(1, 3000, {"S": (1, _dev_v(8, 40.0, 100.0))})
    ref, got, prt = both(CHAIN, events)
    assert prt.device_bridges[0].runtime.compiler.blocked
    assert len(ref) > 20
    assert got == ref


@pytest.mark.parametrize("name", sorted(SCAN_APPS))
def test_scan_pattern_matches_reference(name):
    app, streams, t0 = SCAN_APPS[name]
    # events begin 10 ms after the start time, inside the absent window
    events = stream_events(2, 1500, streams, t0=t0 + 10)
    ref, got, prt = both(app, events, start_time=t0)
    assert not prt.device_bridges[0].runtime.compiler.blocked
    assert ref
    assert got == ref


def test_absent_start_arms_at_the_start_time():
    """An app started later arms the absent seed later: the first
    occurrence of B, inside the first 100 ms, matches only when the app
    started early enough (the reference's behaviour, held by both)."""
    app = SCAN_APPS["absent_start"][0]
    events = [("B", [60.0], 1050), ("B", [70.0], 1150)]
    for t0 in (0, 1000):
        ref, got, _ = both(app, events, start_time=t0)
        assert got == ref
    early, _, _ = both(app, events, start_time=0)
    late, _, _ = both(app, events, start_time=1000)
    assert early != late


# ---------------------------------------------------------- query families

TICKS = "define stream Ticks (sym string, price double, vol long);\n"


def _tick(keys: int = 6):
    return lambda rng: [f"s{int(rng.integers(keys))}",
                        f32(rng.uniform(0, 100)), int(rng.integers(1000))]


QUERIES = {
    # grouped sliding length window, through send_columns
    "grouped_length": (TICKS + """
@device(batch='64', strict='true')
from Ticks[price > 10.0]#window.length(128)
select sym, sum(price) as total, sum(vol) as vs, count() as n, avg(price) as ap
group by sym insert into Out;
""", {"Ticks": (1, _tick())}, ("Ticks", ["sym", "price", "vol"]), "flush"),
    # sliding time window, min/max/stdDev, per event
    "time_window": ("""
define stream S (dev string, v double);
@device(batch='64', window='512', strict='true')
from S[v > 0.0]#window.time(200)
select avg(v) as av, min(v) as mn, max(v) as mx, stdDev(v) as sd, count() as n
insert into Out;
""", {"S": (1, _dev_v(4))}, None, "flush"),
    # timeBatch: the open bucket closes at shutdown (the bridge's sentinel)
    "time_batch": ("""
define stream S (v double, n long);
@device(batch='64', window='512', strict='true')
from S[v > 0.0]#window.timeBatch(250)
select avg(v) as av, min(v) as lo, max(v) as hi, sum(n) as tn, count() as c
insert into Out;
""", {"S": (1, lambda rng: [f32(rng.uniform(-10, 100)),
                            int(rng.integers(1000))])},
        ("S", ["v", "n"]), "shutdown"),
    # lossyFrequent, walked
    "lossy_frequent": ("""
define stream Purchase (cardNo string, price double);
@device(batch='64', strict='true')
from Purchase[price >= 30.0]#window.lossyFrequent(0.1, 0.01, cardNo)
select cardNo, sum(price) as total, count() as n
insert into Out;
""", {"Purchase": (1, lambda rng: [f"c{int(rng.zipf(1.5)) % 200}",
                                   f32(rng.uniform(0, 100))])},
        ("Purchase", ["cardNo", "price"]), "flush"),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_family_matches_reference(name):
    app, streams, columns, finish = QUERIES[name]
    events = stream_events(3, 1200, streams)
    ref, _ = run(ref_manager(), app, events, columns=columns, finish=finish)
    got, prt, fed = port_query(app, events, columns=columns, finish=finish)
    assert ref
    assert_query_rows(prt, ref, got, fed)
    if name == "time_batch":
        # the open bucket came out at shutdown
        assert len(got) == prt.rows_before_shutdown + 1


# ------------------------------------------------------------------- join

JOIN = """
define stream Bid (sym string, price double);
define stream Ask (sym string, price double);
@device(batch='64', ring='128', joined='1024', strict='true')
from Bid#window.time(200) join Ask#window.time(300)
  on Bid.sym == Ask.sym and Ask.price < Bid.price
select Bid.sym as s, Bid.price as bp, Ask.price as ap
insert into Out;
"""


def test_join_matches_reference():
    streams = {"Bid": (1, _dev_v(10)), "Ask": (1, _dev_v(10))}
    events = stream_events(4, 1500, streams)
    ref, got, _ = both(JOIN, events)
    assert len(ref) > 50
    assert got == ref


# ------------------------------------------------------------ aggregation

AGG = """
define stream Trade (symbol string, price double, volume long, ts long);
@device(batch='64')
define aggregation TradeAgg
  from Trade
  select symbol, avg(price) as ap, sum(price) as total, count() as n
    group by symbol
    aggregate by ts every sec ... hour;
"""
AGG_QUERIES = [
    "from TradeAgg within 0L, 99999999999999L per 'seconds' "
    "select symbol, ap, total, n",
    "from TradeAgg within 0L, 99999999999999L per 'minutes' "
    "select symbol, ap, total, n",
]


def _agg_events(n: int, seed: int):
    rng = np.random.default_rng(seed)
    t = 1_700_000_000_000 + np.cumsum(rng.integers(0, 200, n))
    late = rng.random(n) < 0.05
    own = t - np.where(late, rng.integers(0, 3000, n), 0)
    return [("Trade", [f"S{int(rng.integers(5))}", f32(rng.uniform(1, 100)),
                       int(rng.integers(1, 1000)), int(o)], int(a))
            for a, o in zip(t.tolist(), own.tolist())]


def test_device_aggregation_read_with_query_matches_reference():
    events = _agg_events(1500, 5)
    outs = []
    for manager in (ref_manager(), port_manager()):
        rt = manager.create_siddhi_app_runtime(AGG, playback=True)
        rt.start()
        send(rt, events)
        outs.append([[(e.timestamp, list(e.data)) for e in rt.query(q)]
                     for q in AGG_QUERIES])
        agg = rt.ctx.aggregations["TradeAgg"]
        manager.shutdown()
    assert agg._dev is not None, "the port's rollup took the device path"
    ref, got = outs
    assert all(ref)
    assert got == ref


# --------------------------------------------------- driver, rate limiting

def _async(app: str, window: str = "2") -> str:
    return app.replace("strict='true'",
                       f"strict='true', async='true', pipeline='{window}'")


def test_async_driver_matches_sync_and_reference():
    events = stream_events(6, 3000, {"S": (1, _dev_v(8, 40.0, 100.0))})
    ref, _ = run(ref_manager(), _async(CHAIN), events)
    sync, _ = run(port_manager(), CHAIN, events)
    got, prt = run(port_manager(), _async(CHAIN), events)
    drv = prt.device_bridges[0].driver
    assert drv is not None and drv.window == 2
    assert drv.batches_stepped == -(-len(events) // 64)
    assert got == sync == ref
    assert ref


def test_async_scan_matches_sync():
    app, streams, t0 = SCAN_APPS["and"]
    events = stream_events(7, 800, streams)
    sync, _ = run(port_manager(), app, events)
    got, _ = run(port_manager(), _async(app), events)
    assert sync and got == sync


def test_pipeline_window_one_matches_two():
    app, streams, columns, _ = QUERIES["grouped_length"]
    events = stream_events(8, 600, streams)
    one, rt1 = run(port_manager(), _async(app, "1"), events, columns=columns)
    two, rt2 = run(port_manager(), _async(app, "2"), events, columns=columns)
    sync, _ = run(port_manager(), app, events, columns=columns)
    assert rt1.device_bridges[0].driver.window == 1
    assert rt2.device_bridges[0].driver.window == 2
    assert one and one == two == sync


RATE = """
define stream S (dev string, v double);
@device(batch='64', strict='true')
from S[v > 50.0]
select dev, v
output last every 3 events
insert into Out;
"""


def test_output_rate_limiting_on_device_rows():
    events = stream_events(9, 700, {"S": (1, _dev_v(4))})
    ref, got, prt = both(RATE, events)
    assert prt.device_bridges[0].rate_limiter is not None
    passing = [r for _, r, _ in events if r[1] > 50.0]
    assert len(got) == len(passing) // 3
    assert [r for _, r in got] == passing[2::3][:len(got)]
    assert got == ref


# ------------------------------------------------ state carried across

def _carry(app: str, events, cut: int, columns=None):
    """Feeds the reference engine ``events[:cut]``, loads its bridge's state
    (``jax.device_get``) and dictionaries into a fresh port engine's bridge
    runtime, then feeds both the rest: returns both engines' rows after the
    cut and the port runtime."""
    rm, pm = ref_manager(), port_manager()
    rrt, prt = start(rm, app), start(pm, app)

    def feed(rt, part):
        if columns is None:
            send(rt, part)
        else:
            send_columns(rt, *columns, part)

    feed(rrt, events[:cut])
    rrt.flush_device()
    rrt.got.clear()
    rb, pb = rrt.device_bridges[0].runtime, prt.device_bridges[0].runtime
    owner = rb.compiler.merged if hasattr(rb, "compiler") \
        else rb.compiled.schema
    tree = jax.device_get(rb.state)
    pb.restore_state({"device": tree, "dict": owner.snapshot_dictionaries()})
    feed(rrt, events[cut:])
    feed(prt, events[cut:])
    rrt.flush_device()
    prt.flush_device()
    rm.shutdown()
    pm.shutdown()
    return rrt.got, prt.got, prt


def test_blocked_state_carried_from_reference():
    events = stream_events(10, 3000, {"S": (1, _dev_v(8, 40.0, 100.0))})
    ref, got, _ = _carry(CHAIN, events, 1600)
    assert ref
    assert got == ref


def test_query_state_carried_from_reference():
    from test_torch_query_shapes import carried_scale
    app, streams, columns, _ = QUERIES["grouped_length"]
    events = stream_events(11, 800, streams)
    rm, pm = ref_manager(), port_manager()
    rrt, prt = start(rm, app), start(pm, app)
    send_columns(rrt, *columns, events[:448])
    rrt.flush_device()
    rrt.got.clear()
    rb, pb = rrt.device_bridges[0].runtime, prt.device_bridges[0].runtime
    pb.restore_state({"device": jax.device_get(rb.state),
                      "dict": rb.compiled.schema.snapshot_dictionaries()})
    fed = _Fed(pb, carried_scale(pb.compiled, pb.state))
    send_columns(rrt, *columns, events[448:])
    send_columns(prt, *columns, events[448:])
    rrt.flush_device()
    prt.flush_device()
    rm.shutdown()
    pm.shutdown()
    assert rrt.got
    assert_query_rows(prt, rrt.got, prt.got, fed)
