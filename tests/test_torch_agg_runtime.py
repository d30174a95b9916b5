"""The port's ``AggregationRuntime`` against the reference's, end to end,
on the CPU.

Both runtimes are built on the same duck-typed app context (no engine: the
runtime needs only ``register_state``, ``current_time``, the stream
junctions, the scalar-function lookup and, for ``@store``, the store
extensions and a config reader) and fed the same events through
``receive(StreamEvent)``. With ``@device`` the reference reduces through its
JAX ``CompiledAggregation`` and the port through its own on the CPU (the
plain step): ``rows_for`` must give the same rows in the same order, bitwise.
The apps and event generators are those of ``tests/test_tpu_aggregation.py``
and the ``@device`` cases of ``tests/test_aggregation_corpus.py``. The
port's device path is also held to the port's host path within the
reference test's ``rel=1e-4`` (DOUBLE rides the f32 wire on the device).
"""

import copy
from types import SimpleNamespace

import pytest
import torch

from siddhi_tpu.compiler import parse as jparse
from siddhi_tpu.compiler import parse_on_demand_query as jodq
from siddhi_tpu.core.aggregation import AggregationRuntime as JRuntime
from siddhi_tpu.core.event import StreamEvent as JEvent
from siddhi_tpu.query_api.definition import TimePeriodDuration as JTPD
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.compiler import parse_on_demand_query as todq
from siddhi_tpu_torch.core.aggregation import AggregationRuntime as TRuntime
from siddhi_tpu_torch.core.event import StreamEvent as TEvent
from siddhi_tpu_torch.gpu.aggregation_step import AggPlan
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
from siddhi_tpu_torch.query_api.definition import TimePeriodDuration as TTPD

from test_aggregation_corpus import OOO_APP, OOO_ROWS
from test_tpu_aggregation import BASE, SELECT, _apps, _events

WIDE = "within 0L, 9999999999999L"


class MemStore:
    """A duck-typed ``@store`` extension: an append log of rows."""

    def __init__(self, table_def, app_context):
        self.rows = []

    def init(self, table_def, options):
        self.options = options

    def record_replace(self, keys, rows):
        return False

    def record_add(self, rows):
        self.rows.extend(list(r) for r in rows)

    def record_find(self, condition):
        return list(self.rows)

    def record_purge(self, column, cutoff):
        self.rows = [r for r in self.rows if int(r[0]) >= cutoff]


class Ctx:
    """The app context both runtimes need, and nothing more."""

    def __init__(self, now=0):
        self.stream_junctions = {}
        self.states = {}
        self.now = now
        self.siddhi_context = SimpleNamespace(
            extensions={"store:mem": MemStore})

    def register_state(self, key, holder):
        self.states[key] = holder

    def current_time(self):
        return self.now

    def lookup_scalar_function(self, namespace, name):
        return None

    def config_reader(self, kind, name):
        return {}


def build(pkg: str, text: str, name: str, device="cpu", ctx=None):
    parse, RT = (jparse, JRuntime) if pkg == "jax" else (tparse, TRuntime)
    app = parse(text)
    kw = {} if pkg == "jax" else {"device": device}
    return RT(app.aggregation_definitions[name], ctx or Ctx(),
              dict(app.stream_definitions), **kw)


def feed(rt, events):
    Ev = JEvent if isinstance(rt, JRuntime) else TEvent
    for ts, row in events:
        rt.receive(Ev(ts, list(row)))


def durations(rt):
    TPD = JTPD if isinstance(rt, JRuntime) else TTPD
    return [TPD(d.value) for d in rt.definition.durations]


def all_rows(rt) -> dict:
    return {d.value: rt.rows_for(d) for d in durations(rt)}


def assert_rows_close(h, d):
    """The reference test's check: sorted rows, floats within rel 1e-4."""
    h, d = sorted(map(tuple, h)), sorted(map(tuple, d))
    assert len(h) == len(d), (len(h), len(d))
    for rh, rd in zip(h, d):
        for a, b in zip(rh, rd):
            if isinstance(a, float):
                assert b == pytest.approx(a, rel=1e-4, abs=1e-4), (rh, rd)
            else:
                assert a == b, (rh, rd)


def _dev_app(body=BASE, batch="16"):
    return _apps(body=body)[1].replace("batch='16'", f"batch='{batch}'")


_FILTER_NO_GROUP = """
define stream S (sym string, price double, vol long);
define aggregation AGGNAME
from S[vol > 20]
select sum(price) as total, count() as c, max(price) as hi
aggregate every sec...min;
"""
_EXTERNAL_TS = """
define stream S (sym string, price double, ets long);
define aggregation AGGNAME
from S
select sym, sum(price) as total, count() as c
group by sym
aggregate by ets every sec...min;
"""
_DISTINCT = """
define stream S (sym string, price double, vol long);
define aggregation AGGNAME
from S
select sym, distinctCount(vol) as dc
group by sym
aggregate every sec;
"""


def _external_events():
    import random
    rng = random.Random(34)
    events, ets = [], 1_700_000_000_000
    for i in range(70):
        ets += rng.randrange(900)
        events.append((1000 + i, [rng.choice("ab"), round(rng.uniform(1, 9), 2),
                                  ets]))
    return events


def _ooo_events():
    return [(1000 + i, list(r)) for i, r in enumerate(OOO_ROWS)]


# name → (app text, aggregation name, events): the reference tests' apps
CASES = {
    "base": (_dev_app(), "AggD", _events(120, 31, spread_ms=60_000)),
    "small_batches": (_dev_app(batch="4"), "AggD", _events(90, 32, spread_ms=700)),
    "filter_no_group": (_dev_app(_FILTER_NO_GROUP), "AggD", _events(80, 33)),
    "external_ts": (_dev_app(_EXTERNAL_TS), "AggD", _external_events()),
    "corpus_out_of_order": (OOO_APP.replace(
        "define aggregation", "@device(batch='4')\ndefine aggregation"),
        "stockAggregation", _ooo_events()),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rows_match_the_reference_device_runtime(name):
    text, agg, events = CASES[name]
    j, t = build("jax", text, agg), build("torch", text, agg)
    assert j._dev is not None and t._dev is not None
    feed(j, events)
    feed(t, events)
    assert all_rows(t) == all_rows(j)


@pytest.mark.parametrize("per", ["seconds", "minutes", "hours", "days",
                                 "months", "years"])
def test_device_path_matches_the_port_host_path(per):
    host, dev = _apps()
    events = _events(120, 31, spread_ms=60_000)
    h, d = build("torch", host, "AggH"), build("torch", dev, "AggD")
    assert h._dev is None and d._dev is not None
    feed(h, events)
    feed(d, events)
    assert_rows_close(h.rows_for(TTPD(per)), d.rows_for(TTPD(per)))


@pytest.mark.parametrize("query", [
    f"from AggD {WIDE} per 'seconds' {SELECT}",
    f"from AggD {WIDE} per 'minutes' select AGG_TIMESTAMP, sym, total, c",
    "from AggD within '2023-11-** **:**:**' per 'hours' "
    "select AGG_TIMESTAMP, sym, hi",
    f"from AggD on c > 1 {WIDE} per 'days' select sym, total, sd",
])
def test_on_demand_find_matches_the_reference(query):
    text = _dev_app()
    events = _events(120, 31, spread_ms=60_000)
    j, t = build("jax", text, "AggD"), build("torch", text, "AggD")
    feed(j, events)
    feed(t, events)
    want = [(e.timestamp, e.data) for e in j.on_demand_find(jodq(query), 5)]
    got = [(e.timestamp, e.data) for e in t.on_demand_find(todq(query), 5)]
    assert got == want and got


def test_corpus_minute_and_second_granularity():
    text, agg, events = CASES["corpus_out_of_order"]
    t = build("torch", text, agg)
    feed(t, events)
    q = "from stockAggregation within 0L, 1543664151000L per '{}'"
    mins = sorted(e.data for e in t.on_demand_find(todq(q.format("minutes")), 0))
    assert [(r[1], r[2]) for r in mins] == [("IBM", 1500.0), ("WSO2", 650.0)]
    secs = {(e.data[0], e.data[1]): e.data[2] for e in
            t.on_demand_find(todq(q.format("seconds")), 0)}
    assert len(secs) == 7
    assert secs[(1496289950000, "IBM")] == pytest.approx(900.0)
    assert secs[(1496289950000, "WSO2")] == pytest.approx(50.0)


def test_snapshot_roundtrip():
    """A restored runtime goes on as the one it was taken from, value for
    value (the snapshot flushes the staged events, so both batch the rest
    alike); the order of keys within a new bucket may differ, since the
    snapshot carries no string dictionary (as in the reference) and the
    device sorts keys by their codes. Against one run over the whole stream,
    whose batches fall elsewhere, float sums merge in another order: the
    reference test's tolerance."""
    text = _dev_app()
    events = _events(60, 35)
    a = build("torch", text, "AggD")
    feed(a, events[:40])
    b = build("torch", text, "AggD")
    b.restore_state(copy.deepcopy(a.snapshot_state()))
    feed(a, events[40:])
    feed(b, events[40:])
    for d in durations(a):
        assert sorted(b.rows_for(d)) == sorted(a.rows_for(d))
    whole = build("torch", text, "AggD")
    feed(whole, events)
    for d in durations(whole):
        assert_rows_close(whole.rows_for(d), b.rows_for(d))


def test_resume_a_reference_runtime_stopped_mid_stream():
    """The reference's ``snapshot_state()`` restores into the port; the port
    then takes the rest of the stream and ends with the reference's rows."""
    text = _dev_app()
    events = _events(120, 31, spread_ms=60_000)
    j = build("jax", text, "AggD")
    feed(j, events[:70])
    snap = copy.deepcopy(j.snapshot_state())
    feed(j, events[70:])
    t = build("torch", text, "AggD")
    t.restore_state(snap)
    feed(t, events[70:])
    assert all_rows(t) == all_rows(j)


def test_store_write_behind_and_read_through_match_the_reference():
    text = _dev_app().replace("@device(", "@store(type='mem')\n@device(")
    events = _events(120, 31, spread_ms=60_000)
    j, t = build("jax", text, "AggD"), build("torch", text, "AggD")
    assert t.persist_stores and t._dev is not None
    feed(j, events)
    feed(t, events)
    j.flush_persisted()
    t.flush_persisted()
    for dj, dt in zip(durations(j), durations(t)):
        assert t.persist_stores[dt].rows == j.persist_stores[dj].rows
    # a fresh runtime over the same stores reads the history back
    j2, t2 = build("jax", text, "AggD"), build("torch", text, "AggD")
    for dj, dt in zip(durations(j), durations(t)):
        j2.persist_stores[dj].rows = list(j.persist_stores[dj].rows)
        t2.persist_stores[dt].rows = list(t.persist_stores[dt].rows)
    assert all_rows(t2) == all_rows(j2) == all_rows(j)


def test_purge_matches_the_reference():
    text = _dev_app()
    base = 1_700_000_000_000
    events = [(base, ["a", 1.0, 5]), (base + 10_000_000, ["a", 2.0, 6])]
    j, t = build("jax", text, "AggD"), build("torch", text, "AggD")
    feed(j, events)
    feed(t, events)
    removed = t.purge(now=base + 10_000_000)
    assert removed == j.purge(now=base + 10_000_000) and removed >= 1
    assert all_rows(t) == all_rows(j)
    assert len(t.rows_for(TTPD.SECONDS)) == 1


def test_distinct_count_falls_back_to_the_host_path():
    text = _dev_app(_DISTINCT)
    events = _events(50, 36)
    j, t = build("jax", text, "AggD"), build("torch", text, "AggD")
    assert j._dev is None and t._dev is None
    feed(j, events)
    feed(t, events)
    assert all_rows(t) == all_rows(j)


def test_strict_raises():
    text = _dev_app(_DISTINCT).replace("batch='16'", "strict='true'")
    with pytest.raises(DeviceCompileError, match="distinctCount"):
        build("torch", text, "AggD")


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    text = _dev_app()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build("torch", text, "AggD", device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build("torch", text, "AggD", device="cuda")
    t = build("torch", text, "AggD", device="cpu")
    assert t._dev.device.type == "cpu"
    before = AggPlan.launches
    feed(t, _events(40, 37))
    t.rows_for(TTPD.SECONDS)
    assert AggPlan.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only; the step runs the plain
    version because the tensors lie on the CPU."""
    t = build("torch", _dev_app(), "AggD", device="cpu")
    ca = t._dev
    feed(t, _events(5, 38))
    batch = t._dev_builder.emit()
    slab = ca.bucket_slab(batch["ts"])
    with pytest.raises(ValueError, match="CUDA"):
        ca.plan.step_cuda(*ca.tensors(batch["cols"], batch["ts"], slab,
                                      batch["valid"]))
    before = AggPlan.launches
    out = ca.step(batch["cols"], batch["ts"], slab, batch["valid"])
    assert AggPlan.launches == before
    assert int(out["count"][0].sum()) == 5
