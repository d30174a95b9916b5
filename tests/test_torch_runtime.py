"""The port's ``DeviceStreamRuntime`` against the JAX package's, whole path.

Rows come out of ``send``/``flush`` and the callback on both sides, from the
same rows and timestamps: the device parity apps of ``tests/test_tpu_query.py``
(sliding, tumbling, hopping, sort and heavy-hitter windows, batch(),
group-by, having, min/max/stdDev), and the differential-fuzz generator of
``tests/test_device_fuzz.py`` over every window it draws, with fixed
seeds. Rows must match in number and order; every value exactly, except
float32 sums/avgs and stdDev, held to the tolerances stated in
``test_torch_query_shapes.py`` (``2**-20`` of a sum of |x| that bounds
every prefix either runtime reads, ``next_scale`` over the port's steps;
an avg's limit divided by its row's count; stdDev ``1e-5`` relative plus ``1e-4``, or the cancellation
bound, float32 or float64 by where the moments are kept, when the window
holds fewer than 4 events). Also: a snapshot roundtrip, resuming the
port from the JAX runtime's mid-stream state (one case per window kind),
hopping's boundary drain, and the entry points' device rule.
"""

import random

import numpy as np
import pytest
import torch

from siddhi_tpu.tpu import DeviceStreamRuntime as JRuntime
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError as TError
from siddhi_tpu_torch.gpu.runtime import DeviceStreamRuntime as TRuntime
from siddhi_tpu_torch.gpu.state_io import query_state_from_numpy, state_to_numpy

from test_torch_query_shapes import (
    Scale,
    carried_scale,
    check_close,
    next_scale,
    tolerance_kinds,
)

SPB = "define stream S (sym string, price double, vol long);\n"


def _rows(n, seed):
    rng = random.Random(seed)
    return [[rng.choice("abcdef"), round(rng.uniform(0, 100), 2),
             rng.randrange(1000)] for _ in range(n)]


def _kv_rows(n, seed, keys, hi, flt=False):
    rng = random.Random(seed)
    return [[rng.choice(keys), round(rng.uniform(0, hi), 2) if flt
             else rng.randrange(hi)] for _ in range(n)]


def _bursty(n, seed, gap=40):
    rng, ts, out = random.Random(seed), 1000, []
    for _ in range(n):
        ts += rng.choice([0, 1, 1, 2, 5, gap])
        out.append(ts)
    return out


def _ts_rows(n, seed, spread_ms):
    """``tests/test_tpu_query.py::_ts_rows``: rows and timestamps with gaps
    up to ``spread_ms``."""
    rng, ts, rows, tss = random.Random(seed), 1000, [], []
    for _ in range(n):
        ts += rng.randrange(spread_ms)
        rows.append([rng.choice("ab"), round(rng.uniform(0, 50), 2),
                     rng.randrange(100)])
        tss.append(ts)
    return rows, tss


def _vol_ts_rows(n, seed):
    """vol doubles as a monotone external clock."""
    rng, ts, vol, rows, tss = random.Random(seed), 1000, 100, [], []
    for _ in range(n):
        ts += rng.randrange(120)
        vol += rng.randrange(30)
        rows.append([rng.choice("ab"), round(rng.uniform(0, 50), 2), vol])
        tss.append(ts)
    return rows, tss


def _ets_rows(n, seed):
    rng = random.Random(seed)
    ets = _bursty(n, seed + 1)
    return [[rng.choice("pq"), rng.randrange(50), t] for t in ets], ets


# name → (app, rows, timestamps or None for 1000 + i, runtime kwargs)
PARITY = {
    "filter_length": (SPB + """
from S[price > 50.0 and vol < 900]#window.length(10)
select sym, sum(vol) as total, count() as c, avg(price) as ap insert into O;""",
                      _rows(300, 1), None, {"batch_capacity": 64}),
    "filter_length_small": (SPB + """
from S[price > 50.0 and vol < 900]#window.length(10)
select sym, sum(vol) as total, count() as c, avg(price) as ap insert into O;""",
                            _rows(200, 2), None, {"batch_capacity": 17}),
    "minmax_length": (SPB + """
from S[price > 10.0]#window.length(7)
select sym, min(price) as lo, max(price) as hi, max(vol) as mv insert into O;""",
                      _rows(400, 41), None, {"batch_capacity": 32}),
    "minmax_time": (SPB + """
from S#window.time(50) select min(price) as lo, max(vol) as hi insert into O;""",
                    _rows(300, 42), None, {"batch_capacity": 64}),
    "stddev_window": (SPB + """
from S#window.length(10) select stdDev(price) as sd, avg(price) as ap
insert into O;""", _rows(300, 44), None, {"batch_capacity": 32}),
    "stddev_running": (SPB + """
from S select stdDev(price) as sd insert into O;""", _rows(400, 45), None,
                       {"batch_capacity": 64}),
    "stddev_group_by": (SPB + """
from S select sym, stdDev(price) as sd group by sym insert into O;""",
                        _rows(300, 46), None, {"batch_capacity": 32}),
    "minmax_group_by": (SPB + """
from S select sym, min(price) as lo, max(vol) as hi group by sym insert into O;""",
                        _rows(300, 47), None, {"batch_capacity": 32}),
    "minmax_running": (SPB + """
from S select min(price) as lo, max(vol) as hi insert into O;""",
                       _rows(300, 48), None, {"batch_capacity": 64}),
    "multi_key_group_by": (SPB + """
from S select sym, vol, sum(price) as t, count() as c group by sym, vol
insert into O;""", [[r[0], r[1], r[2] % 5] for r in _rows(250, 49)], None,
                           {"batch_capacity": 32, "group_capacity": 4096}),
    "having": (SPB + """
from S#window.length(5) select sym, sum(price) as t having t > 150.0
insert into O;""", _rows(300, 50), None, {"batch_capacity": 32}),
    "having_group_by": (SPB + """
from S select sym, count() as c group by sym having c > 10 insert into O;""",
                        _rows(200, 51), None, {"batch_capacity": 32}),
    "long_group_keys": ("""
define stream S (k long, v long);
from S select k, sum(v) as t group by k insert into O;""",
                        [[1, 10], [4294967297, 5], [1, 10], [4294967297, 5]],
                        None, {"batch_capacity": 8}),
    "group_by_length": ("""
define stream S (k string, v long);
from S#window.length(10) select k, sum(v) as t, count() as c, avg(v) as a
group by k insert into O;""", _kv_rows(300, 60, "abc", 100), None,
                        {"batch_capacity": 16}),
    "group_by_length_small": ("""
define stream S (k string, v long);
from S#window.length(10) select k, sum(v) as t, count() as c, avg(v) as a
group by k insert into O;""", _kv_rows(150, 61, "abcde", 100), None,
                              {"batch_capacity": 3}),
    "group_by_time": ("""
define stream S (k string, v long);
from S#window.time(25) select k, sum(v) as t, count() as c group by k
insert into O;""", _kv_rows(200, 62, "ab", 50), None, {"batch_capacity": 16}),
    "group_by_filter_having": ("""
define stream S (k string, v long);
from S[v > 20]#window.length(8) select k, sum(v) as t group by k
having t > 300 insert into O;""", _kv_rows(250, 63, "abcd", 100), None,
                               {"batch_capacity": 16}),
    "group_by_double_sum": ("""
define stream S (k string, v double);
from S#window.length(6) select k, sum(v) as t, avg(v) as a group by k
insert into O;""", _kv_rows(120, 64, "ab", 10, flt=True), None,
                            {"batch_capacity": 8}),
    "time_window": ("""
define stream S (sym string, v long);
from S#window.time(100) select sym, sum(v) as s, count() as c, avg(v) as a
insert into O;""", _kv_rows(400, 6, "abc", 100), _bursty(400, 7),
                    {"batch_capacity": 32}),
    "time_window_filter": ("""
define stream S (sym string, v long);
from S[v > 20]#window.time(60) select sym, sum(v) as s, count() as c
insert into O;""", _kv_rows(300, 8, "xy", 100), _bursty(300, 9),
                           {"batch_capacity": 13}),
    "external_time": ("""
define stream S (sym string, v long, ets long);
from S#window.externalTime(ets, 80) select sym, sum(v) as s, count() as c
insert into O;""", _ets_rows(300, 10)[0], _ets_rows(300, 10)[1],
                      {"batch_capacity": 29}),
    "external_time_out_of_order": ("""
define stream S (v long, ets long);
from S#window.externalTime(ets, 80) select sum(v) as s, count() as c
insert into O;""", [[1, 1000], [1, 1100], [2, 1050], [3, 1120]],
                                   [1000, 1100, 1050, 1120],
                                   {"batch_capacity": 4}),
    "time_drops": ("""
define stream S (v long);
from S#window.time(1000000) select sum(v) as s insert into O;""",
                   [[1]] * 64, None, {"batch_capacity": 8, "window_capacity": 8}),
    "time_length": (SPB + """
from S#window.timeLength(1 sec, 5)
select sym, sum(price) as total, count() as c, min(price) as lo insert into O;""",
                    _rows(120, 13), _bursty(120, 14, 400),
                    {"batch_capacity": 64, "window_capacity": 5}),
    "batch_chunks": ("""
define stream S (v long);
from S#window.batch() select sum(v) as s, count() as c insert into O;""",
                     [[i] for i in range(40)], None, {"batch_capacity": 8}),
    "length_batch": (SPB + """
from S[price > 10.0]#window.lengthBatch(5)
select sum(price) as total, count() as c, max(vol) as hv insert into O;""",
                     _rows(200, 70), None, {"batch_capacity": 16}),
    "length_batch_values": (SPB + """
from S#window.lengthBatch(7) select sym, vol insert into O;""",
                            _rows(100, 71), None, {"batch_capacity": 4}),
    "time_batch": (SPB + """
from S#window.timeBatch(1 sec)
select sym, sum(price) as total, count() as c, avg(price) as ap,
       min(price) as lo insert into O;""", *_ts_rows(120, 5, 400),
                   {"batch_capacity": 32}),
    "time_batch_sparse": (SPB + """
from S#window.timeBatch(1 sec)
select sym, sum(price) as total, count() as c, avg(price) as ap,
       min(price) as lo insert into O;""", *_ts_rows(40, 7, 3000),
                          {"batch_capacity": 8}),
    "external_time_batch": (SPB + """
from S#window.externalTimeBatch(vol, 50)
select sym, sum(price) as total, count() as c insert into O;""",
                            *_vol_ts_rows(100, 11), {"batch_capacity": 16}),
    "session": (SPB + """
from S#window.session(1 sec)
select sym, sum(price) as total, count() as c, max(vol) as hv insert into O;""",
                *_ts_rows(120, 8, 400), {"batch_capacity": 32}),
    "delay": (SPB + """
from S#window.delay(500) select sym, price insert into O;""",
              *_ts_rows(100, 15, 400), {"batch_capacity": 8}),
    "hopping": (SPB + """
from S#window.hopping(1 sec, 400)
select sym, sum(price) as total, count() as c, max(price) as hi
insert into O;""", *_ts_rows(100, 24, 500), {"batch_capacity": 16}),
    "hopping_sparse": (SPB + """
from S#window.hopping(1 sec, 400)
select sym, sum(price) as total, count() as c, max(price) as hi
insert into O;""", *_ts_rows(30, 26, 4000), {"batch_capacity": 4}),
    "sort": (SPB + """
from S#window.sort(5, price)
select sym, sum(price) as total, count() as c, min(price) as lo,
       stdDev(price) as sd insert into O;""", *_ts_rows(100, 21, 50),
             {"batch_capacity": 16}),
    "sort_desc": (SPB + """
from S#window.sort(4, vol, 'desc')
select sym, sum(vol) as total, max(vol) as hi, avg(price) as ap
insert into O;""", *_ts_rows(90, 23, 50), {"batch_capacity": 8}),
    "frequent": ("""
define stream S (sym string, v long);
from S#window.frequent(4, sym)
select sym, v, sum(v) as s, count() as c, avg(v) as a insert into O;""",
                 _kv_rows(200, 41, "abcdefgh", 100), None,
                 {"batch_capacity": 32}),
    "frequent_two_key": ("""
define stream S (sym string, v int);
from S#window.frequent(3, sym, v) select sym, v, count() as c insert into O;""",
                         [[r[0], r[1] % 3] for r in _kv_rows(120, 43, "ab", 3)],
                         None, {"batch_capacity": 16}),
    "lossy_frequent": ("""
define stream S (sym string, v long);
from S#window.lossyFrequent(0.3, 0.05, sym)
select sym, v, sum(v) as s, count() as c insert into O;""",
                       _kv_rows(200, 44, "abcdefgh", 100), None,
                       {"batch_capacity": 32}),
    "lossy_frequent_default_error": ("""
define stream S (sym string, v long);
from S#window.lossyFrequent(0.25, sym) select sym, sum(v) as s insert into O;""",
                                     _kv_rows(120, 45, "abcd", 100), None,
                                     {"batch_capacity": 8}),
}


def _feed(rt, rows, tss):
    got = []
    rt.add_callback(got.extend)
    for i, r in enumerate(rows):
        rt.send(list(r), timestamp=tss[i] if tss else 1000 + i)
    rt.flush()
    return got


class _Fed:
    """The tolerance scale of what a port runtime's steps read
    (``next_scale`` over every step it takes from here on), from
    ``start`` (the state it resumed from, for running sums)."""

    def __init__(self, trt, start: Scale | None = None):
        self.scale = start or Scale()
        q, step = trt.compiled, trt.compiled.step_tensors

        def counted(state, cols, ts, valid):
            self.scale = next_scale(q, self.scale, state, cols, ts, valid)
            return step(state, cols, ts, valid)

        q.step_tensors = counted


def assert_rows_close(compiled, ref, got, sc: Scale):
    """Rows in the same order, each column held to the tolerance class of
    its output (``test_torch_query_shapes.check_close``)."""
    assert len(ref) == len(got), (len(ref), len(got))
    n = len(compiled.specs)
    assert all(len(r) == n for r in ref + got)
    if not ref:
        return
    kinds = tolerance_kinds(compiled)
    cnt = next((i for i, s in enumerate(compiled.specs)
                if s.kind == "count"), None)
    counts = None if cnt is None else np.array([r[cnt] for r in ref])
    for i, s in enumerate(compiled.specs):
        check_close(f"column {s.name}", np.array([r[i] for r in ref]),
                    np.array([r[i] for r in got]), kinds[s.name], sc, counts)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_runtime_rows_match_reference(name):
    app, rows, tss, kw = PARITY[name]
    ref = _feed(JRuntime(app, **kw), rows, tss)
    trt = TRuntime(app, device="cpu", **kw)
    fed = _Fed(trt)
    got = _feed(trt, rows, tss)
    assert_rows_close(trt.compiled, ref, got, fed.scale)
    assert ref, "the case emits rows"


# ------------------------------------------------------------ the fuzz

WINDOWS = [
    "", "#window.length({n})", "#window.lengthBatch({n})",
    "#window.time({ms})", "#window.timeBatch({ms})",
    "#window.timeLength({ms}, {n})", "#window.session({ms})",
    "#window.sort({n}, v)", "#window.sort({n}, v, 'desc')",
    "#window.hopping({ms}, {hop})", "#window.frequent({n}, sym)",
    "#window.lossyFrequent(0.3, 0.08, sym)",
]
AGG_SETS = [
    "sum(v) as s, count() as c",
    "sum(v) as s, avg(v) as a",
    "min(v) as mn, max(v) as mx, count() as c",
    "sum(p) as sp, stdDev(p) as sd",
    "count() as c",
]
FILTERS = ["", "[v > 20]", "[p < 75.0]", "[v > 10 and p > 5.0]"]


def _shape(rng):
    """``tests/test_device_fuzz.py::_shape``: the same draws and the same
    adjustments for shapes the device leaves to the host."""
    win = rng.choice(WINDOWS).format(
        n=rng.choice([2, 3, 5, 8]), ms=rng.choice([40, 90, 200]),
        hop=rng.choice([20, 50]))
    aggs = rng.choice(AGG_SETS)
    filt = rng.choice(FILTERS)
    if "hopping" in win and "sym" in aggs:
        aggs = "sum(v) as s, count() as c"
    if ("sort" in win or "frequent" in win) and ("min(" in aggs
                                                 or "stdDev" in aggs):
        aggs = "sum(v) as s, count() as c"
    sel = f"sym, {aggs}" if "Batch" not in win and "hopping" not in win \
        else aggs
    return f"""
    define stream S (sym string, p double, v long);
    from S{filt}{win}
    select {sel}
    insert into O;
    """


def _events(rng, n):
    ts, out = 1000, []
    for _ in range(n):
        ts += rng.choice([1, 2, 5, 30, 120])
        out.append(([rng.choice("abcd"), round(rng.uniform(0, 100), 2),
                     rng.randrange(100)], ts))
    return out


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_slice_windows_match_reference(seed):
    rng = random.Random(1000 + seed)
    app = _shape(rng)
    events = _events(rng, rng.choice([40, 90]))
    cap = rng.choice([4, 8, 16, 64])
    rows = [r for r, _ in events]
    tss = [t for _, t in events]
    ref = _feed(JRuntime(app, batch_capacity=cap), rows, tss)
    trt = TRuntime(app, batch_capacity=cap, device="cpu")
    fed = _Fed(trt)
    assert_rows_close(trt.compiled, ref, _feed(trt, rows, tss), fed.scale)


# ------------------------------------------------------------- checkpoints

def test_snapshot_roundtrip():
    app = """
    define stream S (v long);
    from S#window.length(4) select sum(v) as s insert into O;
    """
    rt = TRuntime(app, batch_capacity=4, device="cpu")
    for i, v in enumerate([1, 2, 3, 4]):
        rt.send([v], timestamp=i)
    rt.flush()
    snap = rt.snapshot_state()
    assert isinstance(snap["device"]["tail_ivals"], np.ndarray)
    rt2 = TRuntime(app, batch_capacity=4, device="cpu")
    got = []
    rt2.add_callback(got.extend)
    rt2.restore_state(snap)
    for i, v in enumerate([5, 6]):
        rt2.send([v], timestamp=10 + i)
    rt2.flush()
    # window [1,2,3,4] → +5 (evict 1) = 14 → +6 (evict 2) = 18
    assert [r[0] for r in got] == [14, 18]


@pytest.mark.parametrize("name", [
    "group_by_time", "stddev_group_by", "minmax_time", "time_length",
    "length_batch", "time_batch", "external_time_batch", "session", "delay",
    "hopping", "sort", "frequent", "lossy_frequent_default_error"])
def test_resume_from_reference_state(name):
    """Stop the JAX runtime mid-stream, carry its state and dictionary into
    the port, and finish there: the rows after the cut match the JAX
    runtime's own."""
    app, rows, tss, kw = PARITY[name]
    tss = tss or [1000 + i for i in range(len(rows))]
    cut = len(rows) // 2
    jrt = JRuntime(app, **kw)
    for r, t in zip(rows[:cut], tss[:cut]):
        jrt.send(list(r), timestamp=t)
    jrt.flush()
    snap = jrt.snapshot_state()
    want = []
    jrt.add_callback(want.extend)
    trt = TRuntime(app, device="cpu", **kw)
    trt.restore_state({"device": {k: np.asarray(v)
                                  for k, v in snap["device"].items()},
                       "dict": snap["dict"]})
    fed = _Fed(trt, carried_scale(trt.compiled, trt.state))
    got = []
    trt.add_callback(got.extend)
    for r, t in zip(rows[cut:], tss[cut:]):
        jrt.send(list(r), timestamp=t)
        trt.send(list(r), timestamp=t)
    jrt.flush()
    trt.flush()
    assert want
    assert_rows_close(trt.compiled, want, got, fed.scale)


def test_query_state_carrier_checks_leaves():
    app, _, _, kw = PARITY["minmax_time"]
    trt = TRuntime(app, device="cpu", **kw)
    tree = state_to_numpy(trt.state)
    back = query_state_from_numpy(trt.compiled, tree, "cpu")
    assert all(torch.equal(back[k], trt.state[k]) for k in tree)
    tree.pop("last_ts")
    with pytest.raises(ValueError, match="last_ts"):
        query_state_from_numpy(trt.compiled, tree, "cpu")


def test_hopping_drains_boundaries():
    """A gap spanning more hop boundaries than one step's B flush slots:
    ``flush`` steps empty batches until the next boundary is in the
    future, and the rows match the JAX runtime's."""
    app = SPB + """
    from S#window.hopping(100, 10) select sum(price) as t, count() as c
    insert into O;"""
    rows = _rows(12, 90)
    tss = [1000, 1001, 1003, 1004, 1200, 1201, 1205, 2000, 2001, 2002,
           2003, 2500]
    ref = _feed(JRuntime(app, batch_capacity=4), rows, tss)
    trt = TRuntime(app, batch_capacity=4, device="cpu")
    steps = []
    step = trt.compiled.step_tensors
    trt.compiled.step_tensors = lambda *a: steps.append(1) or step(*a)
    fed = _Fed(trt)
    got = _feed(trt, rows, tss)
    assert len(steps) > 3 * len(rows) // 4       # drain steps ran
    assert int(trt.state["hop_next"]) > int(trt.state["last_ts"])
    assert_rows_close(trt.compiled, ref, got, fed.scale)
    assert len(got) > 2 * len(rows)      # several flushes per event


def test_entry_points_default_to_the_card():
    app = PARITY["having"][0]
    if torch.cuda.is_available():
        assert TRuntime(app).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TRuntime(app)
    lb = SPB + "from S#window.lengthBatch(3) select sum(vol) as s insert into O;"
    assert TRuntime(lb, device="cpu").compiled.window_kind == "lengthBatch"
    with pytest.raises(TError, match="has no device kernel yet"):
        TRuntime(SPB + "from S#window.cron('*/2 * * * * ?') select sum(vol) "
                       "as s insert into O;", device="cpu")


def test_batch_builder_matches_reference():
    """Rows, columnar chunks, staged snapshots: the port's builder emits the
    reference's batch (keys, columns, stale values past the count)."""
    from siddhi_tpu.compiler import parse as jparse
    from siddhi_tpu.tpu.batch import BatchBuilder as JBuilder
    from siddhi_tpu.tpu.batch import BatchSchema as JSchema
    from siddhi_tpu_torch.compiler import parse as tparse
    from siddhi_tpu_torch.gpu.batch import BatchBuilder, BatchSchema
    text = "define stream S (sym string, price double, vol long, ok bool);"
    jb = JBuilder(JSchema(jparse(text).stream_definitions["S"]), 8)
    tb = BatchBuilder(BatchSchema(tparse(text).stream_definitions["S"]), 8)
    rows = [["a", 1.5, 7, True], [None, 2.5, 8, False], ["b", 3.5, 9, True]]
    chunk = {"sym": np.array(["b", "c", None, "a", "d"], dtype=object),
             "price": np.arange(5, dtype=np.float32),
             "vol": np.arange(5, dtype=np.int64),
             "ok": np.array([1, 0, 1, 0, 1], bool)}
    for b in (jb, tb):
        b.append_rows(rows, [10, 11, 12])
        assert b.append_columns(chunk, np.arange(20, 25), start=1) == 4
    snaps = [b.snapshot() for b in (jb, tb)]
    for k in ("sym", "price", "vol", "ok"):
        assert (snaps[0]["cols"][k] == snaps[1]["cols"][k]).all()
    want, got = jb.emit(), tb.emit()
    assert set(want) == set(got)
    for k in ("count", "last_ts"):
        assert want[k] == got[k]
    for k in ("ts", "valid"):
        assert (want[k] == got[k]).all()
    for k, col in want["cols"].items():
        assert col.dtype == got["cols"][k].dtype and (col == got["cols"][k]).all()
    tb.restore(snaps[1])
    assert len(tb) == 7 and (tb.emit()["cols"]["vol"] == want["cols"]["vol"]).all()
