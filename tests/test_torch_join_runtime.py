"""The port's ``DeviceJoinRuntime`` end to end against the JAX package's.

The same events go through both runtimes (``send`` → micro-batch → step →
``decode_outputs``); the decoded rows must be equal, in order, and so must
the drop counters. The apps are those of ``tests/test_tpu_join.py`` (its
BASELINE config #4 time join and the length, outer, unidirectional,
within and mixed joins, with their seeds and capacities) and the generator
of ``tests/test_join_fuzz.py`` (random two-sided shapes × random streams,
its 18 seeds). Also here: a snapshot roundtrip, resuming a JAX runtime
stopped mid-stream in the port (``join_state_from_numpy`` through
``restore_state``), and the entry points' device rule.
"""

import random

import jax
import numpy as np
import pytest
import torch

from siddhi_tpu.tpu.join_compile import DeviceJoinRuntime as JRuntime
from siddhi_tpu_torch.gpu.join_compile import CompiledJoinQuery
from siddhi_tpu_torch.gpu.join_compile import DeviceJoinRuntime as TRuntime
from siddhi_tpu_torch.gpu.join_step import JoinPlan
from siddhi_tpu_torch.gpu.state_io import join_state_from_numpy

from test_join_fuzz import _events, _shape
from test_tpu_join import APP_TIME_JOIN, gen_two_sided

_LR = """
define stream L (k string, v long);
define stream R (k string, v long);
"""


def _lr_events(seed, n, keys, gap):
    rng = random.Random(seed)
    return [(rng.choice(["L", "R"]), [rng.choice(keys), i], 1000 + i * gap)
            for i in range(n)]


# name → (app, events, runtime capacities): the apps of test_tpu_join.py
APPS = {
    "time_join": (APP_TIME_JOIN, gen_two_sided(150, 31), {}),
    "time_join_batch_boundaries": (APP_TIME_JOIN,
                                   gen_two_sided(200, 32, gap=30),
                                   {"batch_capacity": 16}),
    "length": (_LR + """
from L#window.length(3) join R#window.length(5) on L.k == R.k
select L.v as lv, R.v as rv insert into O;""", _lr_events(33, 120, "ab", 10), {}),
    "left_outer": (_LR + """
from L#window.time(500) left outer join R#window.time(500) on L.k == R.k
select L.v as lv, R.v as rv insert into O;""", _lr_events(34, 100, "abcd", 60),
                   {}),
    "full_outer": (_LR + """
from L#window.length(2) full outer join R#window.length(2) on L.k == R.k
select L.v as lv, R.v as rv insert into O;""", _lr_events(35, 80, "ab", 10), {}),
    "unidirectional": (_LR + """
from L#window.length(4) unidirectional join R#window.length(4) on L.k == R.k
select L.v as lv, R.v as rv insert into O;""", _lr_events(36, 80, "ab", 10), {}),
    "within": (_LR + """
from L#window.time(5000) join R#window.time(5000) on L.k == R.k
  within 300
select L.v as lv, R.v as rv insert into O;""", _lr_events(37, 100, "ab", 90), {}),
    "mixed": (_LR + """
from L#window.time(800) join R#window.length(3) on L.k == R.k
select L.v as lv, R.v as rv insert into O;""", _lr_events(38, 120, "abc", 70), {}),
}
CAPS = {"batch_capacity": 32, "ring_capacity": 64, "joined_capacity": 512}


def _run(cls, app, events, **kw):
    rt = cls(app, **kw)
    rows = []
    rt.add_callback(rows.extend)
    for sid, row, ts in events:
        rt.send(sid, list(row), ts)
    rt.flush()
    return rows, rt.drop_count, rt.ring_drop_count


@pytest.mark.parametrize("name", sorted(APPS))
def test_rows_match_the_reference_runtime(name):
    app, events, caps = APPS[name]
    kw = {**CAPS, **caps}
    want = _run(JRuntime, app, events, **kw)
    got = _run(TRuntime, app, events, device="cpu", **kw)
    assert want[0], "the app joins nothing"
    assert got == want


@pytest.mark.parametrize("seed", range(18))
def test_fuzz_rows_match_the_reference_runtime(seed):
    rng = random.Random(6000 + seed)
    app = _shape(rng)
    events = _events(rng, rng.choice([25, 50]))
    kw = {"batch_capacity": rng.choice([8, 16]), "ring_capacity": 128,
          "joined_capacity": 2048}
    want = _run(JRuntime, app, events, **kw)
    got = _run(TRuntime, app, events, device="cpu", **kw)
    assert got == want


def test_snapshot_roundtrip():
    """Ring state and the string dictionary survive a snapshot into a fresh
    runtime; the rows are the uninterrupted run's."""
    evs = gen_two_sided(60, 39)
    kw = {"batch_capacity": 16, "ring_capacity": 64, "joined_capacity": 256,
          "device": "cpu"}
    whole = _run(TRuntime, APP_TIME_JOIN, evs, **kw)[0]
    rt1 = TRuntime(APP_TIME_JOIN, **kw)
    rows = []
    rt1.add_callback(rows.extend)
    for sid, row, ts in evs[:30]:
        rt1.send(sid, row, ts)
    rt1.flush()
    snap = rt1.snapshot_state()
    rt2 = TRuntime(APP_TIME_JOIN, **kw)
    rt2.restore_state(snap)
    rt2.add_callback(rows.extend)
    for sid, row, ts in evs[30:]:
        rt2.send(sid, row, ts)
    rt2.flush()
    assert rows == whole
    assert set(snap["device"]) == set(rt2.compiler.init_state())


def test_resume_a_reference_runtime_stopped_mid_stream():
    """The JAX runtime's state (numpy leaves, 0-d counters included) and
    dictionary carry into the port, which emits the rest of the rows."""
    app, events, _ = APPS["left_outer"]
    kw = {**CAPS, "batch_capacity": 16}
    whole = _run(JRuntime, app, events, **kw)[0]
    jrt = JRuntime(app, **kw)
    rows = []
    jrt.add_callback(rows.extend)
    for sid, row, ts in events[:57]:
        jrt.send(sid, row, ts)
    jrt.flush()
    trt = TRuntime(app, device="cpu", **kw)
    trt.restore_state(jrt.snapshot_state())
    trt.add_callback(rows.extend)
    for sid, row, ts in events[57:]:
        trt.send(sid, row, ts)
    trt.flush()
    assert rows == whole
    # the tree check: every leaf of init_state, dtypes and shapes
    tree = {k: np.asarray(v) for k, v in jax.device_get(jrt.state).items()}
    join_state_from_numpy(trt.compiler, tree, "cpu")
    with pytest.raises(ValueError, match="join_drops"):
        join_state_from_numpy(trt.compiler, {k: v for k, v in tree.items()
                                             if k != "join_drops"}, "cpu")
    with pytest.raises(ValueError, match="ring_drops"):
        join_state_from_numpy(trt.compiler, {**tree, "ring_drops":
                                             np.zeros(1, np.int64)}, "cpu")


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TRuntime(APP_TIME_JOIN)
    with pytest.raises(RuntimeError, match="CUDA"):
        TRuntime(APP_TIME_JOIN, device="cuda")
    rt = TRuntime(APP_TIME_JOIN, device="cpu")
    assert rt.device.type == "cpu" and rt.state["lr_ts"].device.type == "cpu"


def test_kernel_wrapper_refuses_cpu_tensors():
    rt = TRuntime(APP_TIME_JOIN, batch_capacity=8, ring_capacity=16,
                  joined_capacity=32, device="cpu")
    cq: CompiledJoinQuery = rt.compiler
    for sid, row, ts in gen_two_sided(8, 1):
        rt.builder.append(sid, row, ts)
    args = cq.batch_tensors(rt.builder.emit())
    before = JoinPlan.launches
    with pytest.raises(ValueError, match="CUDA"):
        cq.plan.step_cuda(rt.state, *args)
    # the dispatching step runs the plain version for CPU tensors
    state, out = cq.step_tensors(rt.state, *args)
    assert out["valid"].shape == (32,) and JoinPlan.launches == before
