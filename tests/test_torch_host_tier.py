"""The port engine's host interpreter tier and its wiring, on the CPU.

Each app runs on ``siddhi_tpu.SiddhiManager()`` (JAX on the CPU) and on
``siddhi_tpu_torch.SiddhiManager(device="cpu")`` with the same seeded
events; rows are held equal in order, timestamps included (a device query's
float32 sums within the query tolerances of
``tests/test_torch_query_shapes.py``), and both engines must build device
bridges for exactly the same queries:

- ``iot_mixed`` (``tools/engine_workloads.py``, ``chip_smoke.py``'s
  ``engine_host`` phase) at a small size, synchronous and with ``@async``
  on ``Raw``: interpreter queries feed device queries and read their
  output in one engine;
- the non-strict fallback (logged on ``siddhi_tpu_torch.device``) and the
  strict refusal (``DeviceCompileError``);
- a partition with an inner ``@device`` query: the interpreter only;
- named windows read by a query, by a join and by ``rt.query``;
- ``define trigger`` (``start``, ``at every``, cron) under
  ``advance_time``;
- ``debug()`` with a breakpoint;
- ``snapshot``/``restore`` and ``persist``/``restore_last_revision`` cut
  mid-stream in an app with interpreter windows, a pattern and a
  partition;
- a query-level ``@host_batch`` builds a columnar host bridge for that
  query on both engines (it was refused before the columnar host tier).
"""

import logging
import pickle

import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
from siddhi_tpu_torch.tools import engine_workloads as ew

from test_torch_device_bridge import port_manager, ref_manager
from test_torch_engine import _walk_leaves
from test_torch_runtime import _Fed, assert_rows_close


def pkg_of(manager):
    return siddhi_tpu_torch if isinstance(
        manager, siddhi_tpu_torch.SiddhiManager) else siddhi_tpu


def bridges(rt) -> list:
    return sorted(b.query_name for b in rt.device_bridges)


def started(manager, app: str, outs, start_time: int = 0):
    """A started playback runtime whose ``outs`` streams collect in
    ``rt.got[stream]`` as ``(ts, data)``."""
    rt = manager.create_siddhi_app_runtime(app, playback=True,
                                           start_time=start_time)
    cb = pkg_of(manager).StreamCallback
    rt.got = {s: [] for s in outs}
    for s in outs:
        rt.add_callback(s, cb(lambda evs, rows=rt.got[s]: rows.extend(
            (e.timestamp, list(e.data)) for e in evs)))
    rt.start()
    return rt


def send(rt, events) -> None:
    for sid, row, ts in events:
        rt.input_handler(sid).send(list(row), timestamp=ts)


# ---------------------------------------------------------------- iot_mixed

SMALL = dict(chain_batch=64, slots=16, stats_batch=128, stats_window=256,
             top_batch=256)
N_IOT = 3000


def run_iot(manager, app: str, ev, fed: bool = False):
    rt = manager.create_siddhi_app_runtime(app, playback=True)
    got = ew.collect_outputs(rt, pkg_of(manager).StreamCallback)
    rt.start()
    probe = None
    if fed:
        stats = next(b for b in rt.device_bridges if b.query_name == "stats")
        probe = _Fed(stats.runtime)
    ew.feed_iot(rt, ev)
    rt.drain_async()
    rt.flush_device()
    errors = sum(j.receiver_errors for j in rt.ctx.stream_junctions.values())
    manager.shutdown()
    return got, rt, probe, errors


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_iot_mixed_matches_reference(mode, caplog):
    app = ew.iot_mixed_app(**SMALL, raw_async=mode == "async")
    ev = ew.IotEvents(N_IOT, seed=5)
    with caplog.at_level(logging.INFO, logger="siddhi_tpu_torch.device"):
        got, prt, fed, errors = run_iot(port_manager(), app, ev, fed=True)
    ref, rrt, _, _ = run_iot(ref_manager(), app, ev)
    assert bridges(prt) == bridges(rrt) == ["chain", "stats"]
    assert sorted(prt.query_runtimes) == ["alert_rate", "clean", "top"]
    assert len(prt.partition_runtimes) == 1 and errors == 0
    assert all(b.runtime.device.type == "cpu" for b in prt.device_bridges)
    assert "falls back to host path" in caplog.text and "'top'" in caplog.text
    for s in ("Alerts", "AlertRate", "Top", "RoomPeak"):
        assert got[s] == ref[s], s
        assert got[s], f"{s} emitted nothing"
    stats = next(b for b in prt.device_bridges if b.query_name == "stats")
    assert [t for t, _ in got["Stats"]] == [t for t, _ in ref["Stats"]]
    assert_rows_close(stats.runtime.compiled, [r for _, r in ref["Stats"]],
                      [r for _, r in got["Stats"]], fed.scale)
    if mode == "async":
        assert prt.ctx.stream_junctions["Raw"].dispatcher is not None


def test_iot_mixed_async_equals_sync():
    ev = ew.IotEvents(N_IOT, seed=6)
    sync, _, _, _ = run_iot(port_manager(), ew.iot_mixed_app(**SMALL), ev)
    asyn, _, _, _ = run_iot(port_manager(),
                            ew.iot_mixed_app(**SMALL, raw_async=True), ev)
    assert sync == asyn


# ----------------------------------------------------- fallback, refusals

S = "define stream S (v double);\n"
ORDERED = ("from S[v > 1.0]#window.length(3) select v order by v desc "
           "insert into O;\n")


def test_non_strict_refusal_falls_back_to_the_interpreter(caplog):
    app = S + "@info(name='q') @device(batch='16')\n" + ORDERED
    events = [("S", [float(v)], 1000 + i)
              for i, v in enumerate([3, 0.5, 7, 2, 9, 4])]
    with caplog.at_level(logging.INFO, logger="siddhi_tpu_torch.device"):
        prt = started(port_manager(), app, ["O"])
    rec = [r for r in caplog.records if r.name == "siddhi_tpu_torch.device"]
    assert rec and "order by" in rec[0].getMessage()
    rrt = started(ref_manager(), app, ["O"])
    send(prt, events)
    send(rrt, events)
    assert bridges(prt) == bridges(rrt) == []
    assert list(prt.query_runtimes) == ["q"]
    assert prt.got == rrt.got and prt.got


def test_strict_refusal_raises():
    app = S + "@device(batch='16', strict='true')\n" + ORDERED
    with pytest.raises(DeviceCompileError, match="order by"):
        port_manager().create_siddhi_app_runtime(app, playback=True)


def test_query_host_batch_is_refused():
    """No longer refused: a query-level ``@host_batch`` builds a columnar
    host bridge named 'q' on both engines, beside an interpreter query,
    with equal rows."""
    app = S + "@info(name='q') @host_batch(batch='4')\n" \
        "from S[v > 1.0] select v, v * 2.0 as w insert into O;\n" + ORDERED
    events = [("S", [float(v)], 1000 + i)
              for i, v in enumerate([3, 0.5, 7, 2, 9, 4, 6])]
    prt = started(port_manager(), app, ["O"])
    rrt = started(ref_manager(), app, ["O"])
    for rt in (prt, rrt):
        assert [(b.kind, b.query_name) for b in rt.host_bridges] == \
            [("host_stream", "q")]
        assert list(rt.query_runtimes) == ["query-2"]
        send(rt, events)
        rt.flush_host()
    assert prt.got == rrt.got and prt.got


# ---------------------------------------------------------------- partition

def test_partition_with_inner_device_query_runs_on_the_interpreter():
    app = """
define stream T (dev string, v double);
partition with (dev of T) begin
  @info(name='inner') @device(batch='16', strict='true')
  from T#window.length(3) select dev, sum(v) as total insert into O;
  @info(name='chain') @device(batch='16', slots='8')
  from every e1=T[v > 50.0] -> e2=T[v > e1.v] select e1.v as a, e2.v as b
  insert into P;
end;
"""
    rng = np.random.default_rng(3)
    events = [("T", [f"d{int(rng.integers(4))}",
                     round(float(rng.uniform(0, 100)), 3)], 1000 + i)
              for i in range(400)]
    out = {}
    for name, m in (("ref", ref_manager()), ("port", port_manager())):
        rt = started(m, app, ["O", "P"])
        send(rt, events)
        rt.flush_device()
        m.shutdown()
        out[name] = rt
    assert out["port"].device_bridges == [] == out["ref"].device_bridges
    assert len(out["port"].partition_runtimes) == 1
    assert out["port"].got == out["ref"].got
    assert out["port"].got["O"] and out["port"].got["P"]


# ------------------------------------------------------------ named windows

WINDOW_APP = """
define stream Trades (sym string, price double);
define stream Checks (sym string);
define window Recent (sym string, price double) length(4) output all events;
@info(name='feed') from Trades insert into Recent;
@info(name='reader') from Recent select sym, sum(price) as total
insert all events into Sums;
@info(name='joiner') from Checks join Recent on Checks.sym == Recent.sym
select Checks.sym as sym, Recent.price as price insert into Joined;
"""


def test_named_window_read_by_query_join_and_on_demand():
    trades = [("Trades", [s, p], 1000 + i * 10) for i, (s, p) in enumerate(
        [("a", 1.5), ("b", 2.0), ("a", 3.0), ("c", 4.0), ("b", 5.0),
         ("a", 6.5)])]
    checks = [("Checks", ["a"], 1100), ("Checks", ["b"], 1110)]
    out, reads = {}, {}
    for name, m in (("ref", ref_manager()), ("port", port_manager())):
        rt = started(m, WINDOW_APP, ["Sums", "Joined"])
        send(rt, trades + checks)
        reads[name] = [list(e.data) for e in rt.query(
            "from Recent on price > 2.0 select sym, price")]
        assert [w.definition.id for w in rt.windows] == ["Recent"]
        m.shutdown()
        out[name] = rt.got
        assert bridges(rt) == []
    assert out["port"] == out["ref"]
    assert reads["port"] == reads["ref"] and reads["port"]
    assert out["port"]["Sums"] and out["port"]["Joined"]


# ----------------------------------------------------------------- triggers

TRIGGER_APP = """
define trigger Boot at 'start';
define trigger Tick at every 500 milliseconds;
define trigger Cron at '*/2 * * * * ?';
from Boot select triggered_time insert into BootOut;
from Tick select triggered_time insert into TickOut;
from Cron select triggered_time insert into CronOut;
"""


def test_triggers_fire_under_advance_time():
    outs = ["BootOut", "TickOut", "CronOut"]
    got = {}
    for name, m in (("ref", ref_manager()), ("port", port_manager())):
        rt = started(m, TRIGGER_APP, outs, start_time=10_000)
        for t in range(10_250, 16_001, 250):
            rt.advance_time(t)
        assert len(rt.triggers) == 3
        m.shutdown()
        got[name] = rt.got
        assert bridges(rt) == []
    assert got["port"] == got["ref"]
    assert got["port"]["BootOut"] == [(10_000, [10_000])]
    assert len(got["port"]["TickOut"]) == 12
    assert [t for t, _ in got["port"]["CronOut"]] == [12_000, 14_000, 16_000]


# ----------------------------------------------------------------- debugger

def test_debug_breakpoint_steps_like_the_reference():
    app = ("define stream S (v double);\n@info(name='q') "
           "from S[v > 1.0] select v * 2.0 as w insert into O;\n")
    seen = {}
    for name, m in (("ref", ref_manager()), ("port", port_manager())):
        pkg = pkg_of(m)
        mod = __import__(f"{pkg.__name__}.core.debugger",
                         fromlist=["SiddhiDebugger"])
        rt = m.create_siddhi_app_runtime(app, playback=True)
        out = []
        rt.add_callback("O", pkg.StreamCallback(
            lambda evs, out=out: out.extend(list(e.data) for e in evs)))
        dbg = rt.debug()
        hits = []

        def on_hit(event, query, terminal, debugger, hits=hits):
            hits.append((query, terminal.name, event.timestamp,
                         list(event.data)))
            debugger.next()

        dbg.set_debugger_callback(on_hit)
        dbg.acquire_break_point("q", mod.QueryTerminal.IN)
        for i, v in enumerate([0.5, 3.0, 4.0]):
            rt.input_handler("S").send([v], timestamp=1000 + i)
        m.shutdown()
        seen[name] = (hits, out)
        assert bridges(rt) == []
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] and seen["port"][1] == [[6.0], [8.0]]


# ---------------------------------------------------------------- snapshots

SNAP_APP = """
@app:name('HostSnap')
define stream T (dev string, v double);
@info(name='avg') from T#window.length(5) select dev, avg(v) as a
group by dev insert into Avgs;
@info(name='batch') from T#window.lengthBatch(7) select count() as n,
max(v) as mx insert into Batches;
@info(name='rise') from every e1=T[v > 60.0] -> e2=T[dev == e1.dev and v > e1.v]
within 200 select e1.dev as dev, e1.v as a, e2.v as b insert into Rises;
partition with (dev of T) begin
  @info(name='per_dev') from T#window.time(100) select dev, count() as c,
  sum(v) as s insert into PerDev;
end;
"""
SNAP_OUTS = ["Avgs", "Batches", "Rises", "PerDev"]


def snap_events(n: int = 600):
    rng = np.random.default_rng(11)
    ts = 1000 + np.cumsum(rng.integers(1, 9, n))
    return [("T", [f"d{int(rng.integers(5))}",
                   round(float(rng.uniform(0, 100)), 3)], int(t))
            for t in ts]


def uninterrupted(manager, events):
    rt = started(manager, SNAP_APP, SNAP_OUTS)
    send(rt, events)
    manager.shutdown()
    assert bridges(rt) == []
    return rt.got


def resumed(manager_fn, events, cut: int, how: str):
    m1 = manager_fn()
    store = None
    if how == "persist":
        store = pkg_of(m1).InMemoryPersistenceStore()
        m1.set_persistence_store(store)
    rt1 = started(m1, SNAP_APP, SNAP_OUTS)
    send(rt1, events[:cut])
    if how == "snapshot":
        blob = rt1.snapshot()
    else:
        rev = rt1.persist()
        blob = store.load("HostSnap", rev)
    m1.shutdown()
    m2 = manager_fn()
    if store is not None:
        m2.set_persistence_store(store)
    rt2 = started(m2, SNAP_APP, SNAP_OUTS)
    if how == "snapshot":
        rt2.restore(blob)
    else:
        assert rt2.restore_last_revision() == rev
    send(rt2, events[cut:])
    m2.shutdown()
    return {s: rt1.got[s] + rt2.got[s] for s in SNAP_OUTS}, blob


@pytest.mark.parametrize("how", ["snapshot", "persist"])
def test_host_state_resumes_mid_stream(how):
    events = snap_events()
    want = uninterrupted(port_manager(), events)
    assert all(want[s] for s in SNAP_OUTS)
    assert want == uninterrupted(ref_manager(), events)
    got, blob = resumed(port_manager, events, 333, how)
    assert got == want
    ref, _ = resumed(ref_manager, events, 333, how)
    assert got == ref
    leaves = _walk_leaves(pickle.loads(blob), [])
    assert not any(isinstance(x, torch.Tensor) for x in leaves)
