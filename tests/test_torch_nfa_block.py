"""The port's blocked NFA step against the JAX package's, step by step.

The same seeded wire batches (numpy) go through the JAX step (``vmap`` of
``make_block_step`` over lanes, on the CPU as the JAX package's own tests
run it) and through the port's lane-batched plain version on the CPU. Every
state leaf, both counters and every ``ys`` entry (mask, j, ts and outputs,
masked-off positions included) must be exactly equal, the f32 outputs
computed by arithmetic too (the same f32 operations in the same order).
Batches carry stale values past ``count`` and, in some steps, an empty
lane.

``test_kernel_matches_plain_on_card`` holds the CUDA kernel against the plain
version on the same shapes; it needs a card and skips elsewhere.
"""

import jax
import numpy as np
import pytest
import torch

from siddhi_tpu.compiler import parse as jparse
from siddhi_tpu.tpu.nfa import DeviceNFACompiler as JCompiler
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.gpu.nfa import DeviceNFACompiler as TCompiler
from siddhi_tpu_torch.gpu.nfa_block import BlockPlan, block_step_plain
from siddhi_tpu_torch.gpu.state_io import state_from_numpy, state_to_numpy


APPS = {
    "chain2": ("""
define stream S (v double);
from every e1=S[v > 50.0] -> e2=S[v > e1.v]
select e1.v as a, e2.v as b insert into O;
""", ()),
    "chain3_within": ("""
define stream S (sym string, v double);
from every e1=S[v > 20.0] -> e2=S[sym == e1.sym and v > e1.v]
  -> e3=S[v > e2.v] within 600
select e1.sym as s, e1.v as a, e2.v as b, e3.v - e1.v as d insert into O;
""", ("d",)),
    "chain8": ("""
define stream S (dev string, v double);
from every e1=S[v > 60.0] -> e2=S[v > e1.v and dev == e1.dev]
  -> e3=S[v > e2.v] -> e4=S[v > e3.v] -> e5=S[v > e4.v]
  -> e6=S[v > e5.v] -> e7=S[v > e6.v] -> e8=S[v > e7.v] within 4000
select e1.v as v1, e4.v as v4, e8.v as v8 insert into O;
""", ()),
    "element_within": ("""
define stream S (v double);
from every e1=S[v > 10.0] -> e2=S[v > e1.v] within 300 milliseconds
  -> e3=S[v > e2.v]
select e1.v as a, e2.v as b, e3.v as c insert into O;
""", ()),
    "single": ("""
define stream S (v double, n int);
from every e1=S[v > 30.0]
select e1.v as a, e1.v * 2.5 as b, e1.n + 1 as c insert into O;
""", ("b",)),
    "two_stream": ("""
define stream S1 (sym string, p double);
define stream S2 (sym string, p double);
from every e1=S1[p > 20.0] -> e2=S2[sym == e1.sym and p > e1.p] within 5000
select e1.sym as s, e1.p as p1, e2.p as p2 insert into O;
""", ()),
    "intdiv": ("""
define stream S (x int, y int);
from every e1=S[x > 0] -> e2=S[x / y == e1.x % y or y == 0]
select e1.x as a, e2.x / e2.y as q, e2.x % e1.y as r,
       e1.x / 0 as z insert into O;
""", ()),
}

SEQ = """
define stream S (v double);
from every e1=S[v > 10.0], e2=S[v > e1.v]
select e1.v as a, e2.v as b insert into O;
"""

CASES = [
    # (app, B, C, K, lanes)
    ("chain2", 16, 8, None, 3),
    ("chain2", 64, 16, 24, 2),
    ("chain3_within", 16, 8, None, 3),
    ("chain3_within", 64, 16, 24, 3),
    ("chain8", 64, 16, 24, 2),
    ("chain8", 16, 8, None, 2),
    ("element_within", 64, 8, 24, 3),
    ("single", 16, 8, None, 3),
    ("two_stream", 64, 16, None, 3),
    ("intdiv", 16, 8, 24, 3),
]


def _compilers(app, B, C, K):
    japp, tapp = jparse(app), tparse(app)
    jc = JCompiler(japp.queries[0], dict(japp.stream_definitions), C, B,
                   creation_cap=K)
    tc = TCompiler(tapp.queries[0], dict(tapp.stream_definitions), C, B,
                   creation_cap=K, device="cpu")
    assert jc.blocked and tc.blocked
    assert jc.used_cols == tc.used_cols
    return jc, tc


def _column(rng, t: str, n: int):
    if t in ("FLOAT", "DOUBLE"):
        return np.round(rng.uniform(0, 100, n), 1).astype(np.float32)
    if t == "STRING":
        return rng.integers(1, 4, n).astype(np.int32)
    if t == "INT":
        return rng.integers(-3, 9, n).astype(np.int32)
    if t == "LONG":
        return rng.integers(-3, 9, n).astype(np.int64)
    return rng.integers(0, 2, n).astype(bool)


def make_batch(rng, comp, lanes: int, empty_lane: bool):
    """One seeded wire batch [lanes, B]; values past count are stale noise."""
    B = comp.B
    n_streams = len(comp.merged.stream_ids)
    cols = {k: np.stack([_column(rng, comp.merged.columns[k].name, B)
                         for _ in range(lanes)])
            for k in sorted(comp.used_cols)}
    tag = rng.integers(0, n_streams, (lanes, B)).astype(np.int8)
    ts = np.cumsum(rng.integers(0, 60, (lanes, B)), 1).astype(np.int32)
    ts_base = rng.integers(10**6, 2 * 10**6, lanes).astype(np.int64)
    counts = rng.integers(B // 2, B + 1, lanes).astype(np.int32)
    if empty_lane:
        counts[rng.integers(0, lanes)] = 0
    return cols, tag, ts, ts_base, counts


def _assert_tree_equal(ref, got):
    """Every leaf bitwise equal (NaN equal to NaN), arithmetic outputs
    included."""
    assert set(ref) == set(got)
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_tree_equal(ref[k], got[k])
            continue
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=k)


def _jax_lane_state(jc, lanes):
    single = jc.init_state()
    return jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x)[None],
                                  (lanes,) + np.shape(x)).copy(), single)


def _run_parity(name, B, C, K, lanes, steps=4, seed=0):
    app = APPS[name][0]
    jc, tc = _compilers(app, B, C, K)
    jstep = jax.jit(jax.vmap(jc.make_step()))
    tstep = tc.make_step()
    jstate = _jax_lane_state(jc, lanes)
    tstate = tc.init_state(lanes)
    _assert_tree_equal(jstate, state_to_numpy(tstate))
    rng = np.random.default_rng(seed)
    advanced = 0
    for i in range(steps):
        cols, tag, ts, base, counts = make_batch(rng, tc, lanes,
                                                 empty_lane=(i % 2 == 1))
        jstate, jys = jstep(jstate, cols, tag, ts, base, counts)
        tstate, tys = tstep(tstate, {k: torch.from_numpy(v) for k, v in cols.items()},
                            torch.from_numpy(tag), torch.from_numpy(ts),
                            torch.from_numpy(base), torch.from_numpy(counts))
        jstate = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
        _assert_tree_equal(jstate, state_to_numpy(tstate))
        _assert_tree_equal(jax.tree_util.tree_map(np.asarray, jys),
                           state_to_numpy(tys))
        advanced += int(np.asarray(jys["mask"]).sum())
    return advanced, int(np.sum(jstate["drops"]))


@pytest.mark.parametrize("name,B,C,K,lanes", CASES,
                         ids=[f"{c[0]}-B{c[1]}-C{c[2]}-K{c[3]}" for c in CASES])
def test_block_step_matches_jax(name, B, C, K, lanes):
    advanced, _ = _run_parity(name, B, C, K, lanes)
    if name != "chain8":        # 8 rising states rarely complete at this size
        assert advanced > 0, "the case must emit matches to mean anything"


def test_capacity_pressure_counts_drops_like_jax():
    # tiny tables and cap: both drop paths (creations over K, survivors
    # over C) fire, and the counters must still agree leaf for leaf
    _, drops = _run_parity("chain2", 64, 8, 24, 2, steps=5, seed=7)
    assert drops > 0


def test_sequence_one_lane_steps_match_jax():
    japp, tapp = jparse(SEQ), tparse(SEQ)
    jc = JCompiler(japp.queries[0], dict(japp.stream_definitions), 8, 16)
    tc = TCompiler(tapp.queries[0], dict(tapp.stream_definitions), 8, 16,
                   device="cpu")
    jstate, tstate = jc.init_state(), tc.init_state(1)
    rng = np.random.default_rng(3)
    emitted = 0
    for i in range(6):
        cols, tag, ts, base, counts = make_batch(rng, tc, 1, empty_lane=i == 3)
        batch = {"cols": {k: v[0] for k, v in cols.items()}, "tag": tag[0],
                 "ts": ts[0], "ts_base": base[0], "count": int(counts[0])}
        jstate, jys = jc.step(jstate, batch)
        tstate, tys = tc.step(tstate, batch)
        jnp_state = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
        tnp_state = state_to_numpy(tstate)
        _assert_tree_equal(
            jnp_state, jax.tree_util.tree_map(lambda x: x[0], tnp_state))
        _assert_tree_equal(jax.tree_util.tree_map(np.asarray, jys),
                           state_to_numpy(tys))
        assert jc.decode_outputs(jys) == tc.decode_outputs(tys)
        emitted += len(tc.decode_outputs(tys))
    assert emitted > 0


def test_linked_programs_cover_every_stage():
    # the kernel plan links every predicate/output program without error and
    # maps the bindings minted by the final state onto event columns
    app, _ = APPS["chain3_within"]
    _, tc = _compilers(app, 16, 8, None)
    plan = BlockPlan(tc)
    assert set(plan.stages) == {1, 2}
    assert plan.pc == {1: 16, 2: 24}
    assert len(plan.stages[2]["out"]) == len(tc.out_specs)
    assert plan.code_host.shape[1] == 4 and len(plan.code_host) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,C,K,lanes", CASES,
                         ids=[f"{c[0]}-B{c[1]}-C{c[2]}-K{c[3]}" for c in CASES])
def test_kernel_matches_plain_on_card(name, B, C, K, lanes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    app = APPS[name][0]
    tapp = tparse(app)
    tc = TCompiler(tapp.queries[0], dict(tapp.stream_definitions), C, B,
                   creation_cap=K, device="cuda")
    step = tc.make_step()
    state = tc.init_state(lanes)
    rng = np.random.default_rng(11)
    for i in range(4):
        wire = make_batch(rng, tc, lanes, empty_lane=(i % 2 == 1))
        cols = {k: torch.from_numpy(v).cuda() for k, v in wire[0].items()}
        rest = [torch.from_numpy(a).cuda() for a in wire[1:]]
        ref_state, ref_ys = block_step_plain(
            tc, state_from_numpy(state_to_numpy(state), "cuda"), cols, *rest)
        state, ys = step(state, cols, *rest)
        torch.cuda.synchronize()
        _assert_tree_equal(state_to_numpy(ref_state), state_to_numpy(state))
        _assert_tree_equal(state_to_numpy(ref_ys), state_to_numpy(ys))


TS_APPS = {
    "blocked": """
define stream S (v double);
from every e1=S[v > 1.0] -> e2=S[v > e1.v and eventTimestamp() > 0]
select e1.v as a, eventTimestamp() as t insert into O;
""",
    "scan": """
define stream S (v double);
from every e1=S[v > 1.0] -> e2=S[v > e1.v]<1:2> -> e3=S[eventTimestamp() > 0]
select e1.v as a, eventTimestamp() as t insert into O;
""",
}


@pytest.mark.parametrize("shape", sorted(TS_APPS))
def test_event_timestamp_in_a_pattern_raises_as_in_the_reference(shape):
    # neither package's NFA step env carries `__ts__`: eventTimestamp()
    # inside a pattern compiles, then raises KeyError at the first step —
    # in the reference (at trace time) and in the port, for both shapes
    app = TS_APPS[shape]
    japp, tapp = jparse(app), tparse(app)
    jc = JCompiler(japp.queries[0], dict(japp.stream_definitions), 8, 16)
    tc = TCompiler(tapp.queries[0], dict(tapp.stream_definitions), 8, 16,
                   device="cpu")
    assert jc.blocked == tc.blocked == (shape == "blocked")
    batch = {"cols": {"s0_v": np.array([2.0, 3.0] + [0.0] * 14, np.float32)},
             "tag": np.zeros(16, np.int8),
             "ts": np.array([0, 100] + [0] * 14, np.int32),
             "ts_base": np.int64(5000), "count": 2}
    with pytest.raises(KeyError, match="__ts__"):
        jc.step(jc.init_state(), batch)
    with pytest.raises(KeyError, match="__ts__"):
        tc.step(tc.init_state(1), batch)
