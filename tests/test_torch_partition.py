"""The port's ``PartitionedNFARuntime`` end to end against the JAX package's.

Both runtimes take the same seeded events through their public entry points
(``send_many``/``send``/``flush``); after every call the decoded rows must
be identical and in the same order, ``match_count``/``drop_count`` equal,
and every state leaf exactly equal. The port runs its plain version on the
CPU (``device="cpu"``); the JAX package runs on the CPU as its own tests run
it.
"""

import random

import jax
import numpy as np
import pytest

from siddhi_tpu.tpu.partition import PartitionedNFARuntime as JRuntime
from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime as TRuntime
from siddhi_tpu_torch.gpu.state_io import state_from_numpy, state_to_numpy

START = 1_000_000


def bench_app(n_states: int = 8, seed_threshold: float = 90.0) -> str:
    """``bench.py::make_app`` — the main path's 8-state rising chain."""
    states = " -> ".join(
        f"e{i}=S[v > e{i-1}.v]" if i > 1 else f"e1=S[v > {seed_threshold}]"
        for i in range(1, n_states + 1))
    sel = ", ".join(f"e{i}.v as v{i}" for i in range(1, n_states + 1))
    return f"""
define stream S (dev string, v double);
partition with (dev of S)
begin
from every {states} within 4000
select {sel} insert into Alerts;
end;
"""


def bench_events(n: int, n_keys: int, seed: int):
    """``bench.py::gen_events``'s distribution from a numpy seed."""
    rng = np.random.default_rng(seed)
    dev = np.array([f"dev{k}" for k in rng.integers(0, n_keys, n)])
    v = np.round(rng.uniform(0.0, 100.0, n), 3)
    return dev, v, START + np.arange(n, dtype=np.int64)


def _jax_state(rt):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(rt.state))


def _assert_same(jrt, trt):
    assert jrt.match_count == trt.match_count
    assert jrt.drop_count == trt.drop_count
    ref, got = _jax_state(jrt), state_to_numpy(trt.state)
    assert ref.keys() == got.keys()
    for k in ("matches", "drops"):
        np.testing.assert_array_equal(got[k], ref[k])
    for s, tbl in ref["tables"].items():
        assert tbl.keys() == got["tables"][s].keys()
        for leaf, a in tbl.items():
            b = got["tables"][s][leaf]
            assert a.dtype == b.dtype, (s, leaf)
            np.testing.assert_array_equal(b, a, err_msg=f"{s}.{leaf}")


def _pair(app, **kw):
    return (JRuntime(app, mesh=None, **kw),
            TRuntime(app, device="cpu", **kw))


BENCH_KW = dict(num_partitions=8, key_attr="dev", slot_capacity=16,
                lane_batch=64, creation_cap=32)


@pytest.mark.parametrize("seed_threshold", [90.0, 40.0],
                         ids=["bench-app", "bench-app-hot-seed"])
def test_reduced_bench_app_matches_jax(seed_threshold):
    # 90.0 is the bench app itself; 40.0 seeds more chains so rows, drops
    # and the creation cap all get exercised at this small size
    jrt, trt = _pair(bench_app(8, seed_threshold), **BENCH_KW)
    dev, v, ts = bench_events(2000, 32, seed=5)
    for lo in range(0, len(ts), 400):
        sl = slice(lo, lo + 400)
        jr = jrt.send_many("S", {"dev": dev[sl], "v": v[sl]}, ts[sl],
                           decode=True)
        tr = trt.send_many("S", {"dev": dev[sl], "v": v[sl]}, ts[sl],
                           decode=True)
        assert tr == jr
        _assert_same(jrt, trt)
    assert trt.flush(decode=True) == jrt.flush(decode=True)
    _assert_same(jrt, trt)
    if seed_threshold < 90.0:
        assert trt.match_count > 0 and trt.drop_count > 0


def _shape(rng):
    n_states = rng.choice([2, 3, 3, 4, 6])
    parts = []
    for i in range(1, n_states + 1):
        if i == 1:
            pred = f"[v > {rng.randrange(40, 80)}]"
        else:
            pred = rng.choice([
                f"[v > e{i-1}.v]", f"[v < e{i-1}.v]",
                f"[v > {rng.randrange(10, 50)}]",
                f"[v + e1.v > {rng.randrange(60, 120)}]",
            ])
        parts.append(f"e{i}=S{pred}")
    within = f" within {rng.choice([500, 1500, 4000])}" \
        if rng.random() < 0.6 else ""
    sel = ", ".join(f"e{i}.v as v{i}" for i in range(1, n_states + 1))
    return f"""
define stream S (dev string, v long);
partition with (dev of S)
begin
from every {' -> '.join(parts)}{within}
select {sel}, e1.dev as d insert into Alerts;
end;
"""


@pytest.mark.parametrize("seed", range(12))
def test_partitioned_sweep_matches_jax(seed):
    rng = random.Random(9000 + seed)
    app = _shape(rng)
    kw = dict(num_partitions=rng.choice([2, 4, 8]), key_attr="dev",
              slot_capacity=rng.choice([4, 8, 32]),
              lane_batch=rng.choice([16, 32]),
              creation_cap=rng.choice([None, 12]))
    jrt, trt = _pair(app, **kw)
    n_keys = rng.choice([2, 5, 9])
    ts, events = START, []
    for _ in range(rng.choice([150, 300])):
        ts += rng.choice([20, 50, 50, 400])
        events.append((f"d{rng.randrange(n_keys)}", rng.randrange(100), ts))
    jrows, trows = [], []
    jrt.callback, trt.callback = jrows.extend, trows.extend
    if seed % 2:                           # per-event entry point
        for i, (d, v, t) in enumerate(events):
            jrt.send("S", [d, v], t)
            trt.send("S", [d, v], t)
            if i % 50 == 49:
                assert trows == jrows
                _assert_same(jrt, trt)
    else:                                  # bulk entry point
        for lo in range(0, len(events), 70):
            chunk = events[lo:lo + 70]
            cols = {"dev": np.array([e[0] for e in chunk]),
                    "v": np.array([e[1] for e in chunk], np.int64)}
            tss = np.array([e[2] for e in chunk], np.int64)
            jrt.send_many("S", cols, tss)
            trt.send_many("S", cols, tss)
            assert trows == jrows
            _assert_same(jrt, trt)
    jrt.flush()
    trt.flush()
    assert trows == jrows, app
    _assert_same(jrt, trt)


def test_port_resumes_from_jax_mid_stream_state():
    app = bench_app(8, 40.0)
    jrt = JRuntime(app, mesh=None, **BENCH_KW)
    dev, v, ts = bench_events(1600, 32, seed=9)
    half = 800
    jrt.send_many("S", {"dev": dev[:half], "v": v[:half]}, ts[:half])
    jrt.flush()
    # hand the JAX runtime's state and dictionaries to a fresh port runtime
    trt = TRuntime(app, device="cpu", **BENCH_KW)
    trt.state = state_from_numpy(_jax_state(jrt), "cpu")
    trt.compiler.merged.restore_dictionaries(
        jrt.compiler.merged.snapshot_dictionaries())
    _assert_same(jrt, trt)
    for lo in range(half, len(ts), 400):
        sl = slice(lo, lo + 400)
        jr = jrt.send_many("S", {"dev": dev[sl], "v": v[sl]}, ts[sl],
                           decode=True)
        tr = trt.send_many("S", {"dev": dev[sl], "v": v[sl]}, ts[sl],
                           decode=True)
        assert tr == jr
        _assert_same(jrt, trt)
    assert trt.flush(decode=True) == jrt.flush(decode=True)
    _assert_same(jrt, trt)
    assert trt.match_count > 0


def test_partition_columns_equals_the_reference():
    # the bulk route's front half: per-lane views, lane order, arrival order
    dev, v, ts = bench_events(3000, 50, 8)
    jrt, trt = _pair(bench_app(), **BENCH_KW)
    a = jrt.partition_columns("S", {"dev": dev, "v": v}, ts)
    b = trt.partition_columns("S", {"dev": dev, "v": v}, ts)
    assert len(a[0]) == len(b[0]) == BENCH_KW["num_partitions"]
    for (jc, jt), (tc, tt) in zip(zip(*a), zip(*b)):
        assert jt.tobytes() == tt.tobytes()
        assert jc.keys() == tc.keys()
        for k in jc:
            assert jc[k].dtype == tc[k].dtype
            assert jc[k].tobytes() == tc[k].tobytes(), k
