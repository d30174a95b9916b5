"""The port's ``DeviceNFARuntime`` end to end against the JAX package's.

Every case of the reference pattern corpus (``tests/test_pattern_corpus.py``
``CASES``, imported, not copied) is compiled by both packages'
``DeviceNFACompiler``: they must refuse exactly the same cases. Every case
both accept (half of them here, the other half in
``test_torch_nfa_corpus_b.py``) runs through both ``DeviceNFARuntime``s the
way the corpus's
``_run_device`` drives the reference (``slot_capacity=32,
batch_capacity=32, start_time=START``); the decoded rows must be identical,
in order, and the match and drop counts equal.

A partitioned two-stream scan app (a stream state, a logical ``and``, a
count ``<2:4>`` and a stream state) runs through both
``PartitionedNFARuntime``s step by step, and a resume case hands the JAX
runtime's scan state to the port mid-stream through ``state_io``.
"""

import jax
import numpy as np
import pytest

from siddhi_tpu.compiler import parse as jparse
from siddhi_tpu.tpu.expr_compile import DeviceCompileError as JError
from siddhi_tpu.tpu.nfa import DeviceNFACompiler as JCompiler
from siddhi_tpu.tpu.nfa import DeviceNFARuntime as JRuntime
from siddhi_tpu.tpu.partition import PartitionedNFARuntime as JPartitioned
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError as TError
from siddhi_tpu_torch.gpu.nfa import DeviceNFACompiler as TCompiler
from siddhi_tpu_torch.gpu.nfa import DeviceNFARuntime as TRuntime
from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime as TPartitioned
from siddhi_tpu_torch.gpu.state_io import state_from_numpy, state_to_numpy
from test_pattern_corpus import CASES, START

# the scan main path's app (chip_smoke.py phase `scan_main`)
SCAN_APP = """
define stream Temp (dev string, v double);
define stream Reg (dev string, action string);
partition with (dev of Temp, dev of Reg)
begin
from every e1=Temp[v > 90.0] -> e2=Temp[v > e1.v] and e3=Reg[action == 'on']
  -> e4=Temp[v > e2.v]<2:4> -> e5=Temp[v < e1.v] within 4000
select e1.dev as dev, e1.v as v1, e3.action as a, e5.v as v5 insert into Alerts;
end;
"""


def _compiles(mod_parse, compiler, err, app, **kw):
    a = mod_parse(app)
    try:
        compiler(a.queries[0], dict(a.stream_definitions), 8, 8, **kw)
        return True
    except err:
        return False


def test_port_refuses_exactly_the_corpus_cases_the_reference_refuses():
    ok = 0
    for p in CASES:
        app = p.values[0]
        j = _compiles(jparse, JCompiler, JError, app)
        t = _compiles(tparse, TCompiler, TError, app, device="cpu")
        assert j == t, p.id
        ok += t
    # the reference's own floor (test_pattern_corpus.test_device_compilable_floor)
    assert ok >= 104


def _drive(rt, seq):
    rows = []
    rt.add_callback(rows.extend)
    ts = START
    for entry in seq:
        sid, row = entry[0], entry[1]
        ts += entry[2] if len(entry) > 2 else 100
        rt.send(sid, list(row), ts)
    rt.flush()
    return rows


def device_cases(half: int):
    """Every other device-compilable corpus case (``half`` 0 or 1): the two
    halves run from two files so each stays short on one test worker."""
    out = []
    for p in CASES:
        app, seq, expect, end, no_device = p.values
        if _compiles(jparse, JCompiler, JError, app):
            out.append(pytest.param(app, seq, id=p.id))
    return out[half::2]


def check_runtime_rows(app, seq):
    jrt = JRuntime(app, slot_capacity=32, batch_capacity=32, start_time=START)
    trt = TRuntime(app, slot_capacity=32, batch_capacity=32, start_time=START,
                   device="cpu")
    jrows, trows = _drive(jrt, seq), _drive(trt, seq)
    assert trows == jrows
    assert trt.match_count == jrt.match_count
    assert trt.drop_count == jrt.drop_count


@pytest.mark.parametrize("app,seq", device_cases(0))
def test_runtime_rows_match_jax(app, seq):
    check_runtime_rows(app, seq)


def scan_events(n: int, n_keys: int, seed: int):
    """The scan main path's traffic: 90 % Temp (v ~ U(0, 100)), 10 % Reg
    (action on/off), keys uniform, ts increments U{0, 1, 2} ms."""
    rng = np.random.default_rng(seed)
    keys = np.array([f"dev{k}" for k in range(n_keys)])
    dev = keys[rng.integers(0, n_keys, n)]
    is_temp = rng.random(n) < 0.9
    v = np.round(rng.uniform(0.0, 100.0, n), 3)
    action = np.where(rng.random(n) < 0.5, "on", "off")
    ts = 1_000_000 + np.cumsum(rng.integers(0, 3, n))
    return dev, is_temp, v, action, ts


def _feed(rt, dev, is_temp, v, action, ts, lo, hi, chunk):
    """Runs of consecutive same-stream events go through ``send_many``."""
    rows = []
    i = lo
    while i < hi:
        j = i
        while j < hi and j - i < chunk and is_temp[j] == is_temp[i]:
            j += 1
        sl = slice(i, j)
        if is_temp[i]:
            r = rt.send_many("Temp", {"dev": dev[sl], "v": v[sl]}, ts[sl],
                             decode=True)
        else:
            r = rt.send_many("Reg", {"dev": dev[sl], "action": action[sl]},
                             ts[sl], decode=True)
        rows.extend(r)
        i = j
    return rows


def _jax_state(rt):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(rt.state))


def _assert_same_state(jrt, trt):
    assert jrt.match_count == trt.match_count
    assert jrt.drop_count == trt.drop_count
    ref, got = _jax_state(jrt), state_to_numpy(trt.state)

    def eq(a, b, path):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                eq(a[k], b[k], f"{path}.{k}")
            else:
                assert a[k].dtype == b[k].dtype, (path, k)
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{path}.{k}")
    eq(ref, got, "state")


KW = dict(num_partitions=4, key_attr="dev", slot_capacity=16, lane_batch=64)


def test_partitioned_scan_app_matches_jax_step_by_step():
    jrt = JPartitioned(SCAN_APP, mesh=None, **KW)
    trt = TPartitioned(SCAN_APP, device="cpu", **KW)
    assert not trt.compiler.blocked
    assert [s.kind for s in trt.compiler.states] == \
        ["stream", "logical", "count", "stream"]
    ev = scan_events(3000, 16, seed=4)
    for lo in range(0, 3000, 300):
        jr = _feed(jrt, *ev, lo, lo + 300, 50)
        tr = _feed(trt, *ev, lo, lo + 300, 50)
        assert tr == jr
        _assert_same_state(jrt, trt)
    assert trt.flush(decode=True) == jrt.flush(decode=True)
    _assert_same_state(jrt, trt)
    assert trt.match_count > 0


def test_port_resumes_from_jax_mid_stream_scan_state():
    jrt = JPartitioned(SCAN_APP, mesh=None, **KW)
    ev = scan_events(3000, 16, seed=8)
    _feed(jrt, *ev, 0, 1500, 40)
    jrt.flush()
    # hand the JAX runtime's scan state and dictionaries to a fresh port
    # runtime
    trt = TPartitioned(SCAN_APP, device="cpu", **KW)
    trt.state = state_from_numpy(_jax_state(jrt), "cpu")
    trt.compiler.merged.restore_dictionaries(
        jrt.compiler.merged.snapshot_dictionaries())
    _assert_same_state(jrt, trt)
    jr = _feed(jrt, *ev, 1500, 3000, 40)
    tr = _feed(trt, *ev, 1500, 3000, 40)
    assert tr == jr
    assert trt.flush(decode=True) == jrt.flush(decode=True)
    _assert_same_state(jrt, trt)
    assert trt.match_count > 0


def test_single_lane_runtime_resumes_from_jax_state():
    # DeviceNFARuntime's state is one lane: the JAX tree's [C] leaves and
    # scalar counters gain a lane dim of 1 on the way in
    app = """
define stream A (v double); define stream B (v double);
from every e1=A[v > 20.0]<1:3> -> e2=B[v > e1[0].v] or e3=A[v < 5.0]
select e1[0].v as a, e1[1].v as a1, e2.v as b, e3.v as c insert into O;
"""
    rng = np.random.default_rng(2)
    seq = [("A" if rng.random() < 0.6 else "B", [float(rng.integers(0, 100))])
           for _ in range(120)]
    jrt = JRuntime(app, slot_capacity=8, batch_capacity=16)
    jrows = _drive(jrt, seq[:60])
    trt = TRuntime(app, slot_capacity=8, batch_capacity=16, device="cpu")
    trt.state = state_from_numpy(_jax_state(jrt), "cpu", single_lane=True)
    trt.compiler.merged.restore_dictionaries(
        jrt.compiler.merged.snapshot_dictionaries())
    rest = [(sid, row, 100) for sid, row in seq[60:]]
    j2, t2 = _drive(jrt, rest), _drive(trt, rest)
    assert t2 == j2 and len(jrows) + len(j2) > 0
    back = state_to_numpy(trt.state, single_lane=True)
    ref = _jax_state(jrt)
    for s, tbl in ref["pending"].items():
        for k, v in tbl.items():
            np.testing.assert_array_equal(back["pending"][s][k], v)
    for k in ("seeds", "drops", "matches"):
        assert back[k].shape == () and back[k] == ref[k]
