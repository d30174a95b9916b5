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
version on the same shapes; it needs a card and skips elsewhere. The cases
reach what the kernel's early exit and memory layout depend on: timestamps
that are not sorted, ``ts - first == within`` exactly, element-level windows
that lapse mid-batch, creations too large for shared memory, and a 1-lane
sequence at B = 2048.
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
APPS["sequence"] = (SEQ, ())

CASES = [
    # (app, B, C, K, lanes, ts): ts as in TS_MODES
    ("chain2", 16, 8, None, 3, "cumsum"),
    ("chain2", 64, 16, 24, 2, "cumsum"),
    ("chain3_within", 16, 8, None, 3, "cumsum"),
    ("chain3_within", 64, 16, 24, 3, "cumsum"),
    ("chain8", 64, 16, 24, 2, "cumsum"),
    ("chain8", 16, 8, None, 2, "cumsum"),
    ("element_within", 64, 8, 24, 3, "cumsum"),
    ("single", 16, 8, None, 3, "cumsum"),
    ("two_stream", 64, 16, None, 3, "cumsum"),
    ("intdiv", 16, 8, 24, 3, "cumsum"),
    # ts not sorted: an event falls back inside `within` after the window
    # lapsed (a search that stops at the first lapse would miss it)
    ("chain3_within", 128, 16, 48, 3, "sawtooth"),
    # an element-level window that lapses mid-batch, sorted and not
    ("element_within", 256, 16, 48, 3, "cumsum"),
    ("element_within", 256, 16, 48, 3, "sawtooth"),
    # ts on a grid of 50: ts - first == within (600, 300) exactly, on
    # matching events too
    ("chain3_within", 64, 16, 24, 3, "grid"),
    ("element_within", 128, 8, None, 3, "grid"),
    # no creation cap at a large B: the kernel keeps its creations in
    # global scratch
    ("chain8", 2048, 8, None, 1, "cumsum"),
    # a 1-lane sequence at B = 2048
    ("sequence", 2048, 16, None, 1, "cumsum"),
    # C = 1024 and no cap: too large for a cluster's plan, one CTA a lane
    ("chain8", 2048, 1024, None, 1, "cumsum"),
]
CASE_IDS = [f"{c[0]}-B{c[1]}-C{c[2]}-K{c[3]}"
            + (f"-{c[5]}" if c[5] != "cumsum" else "") for c in CASES]


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


def _ts_sawtooth(rng, lanes: int, B: int):
    """Not sorted: 32-event teeth rising 40 an event over a base rising 100
    a tooth, so a window that lapsed within a tooth reopens at the next."""
    j = np.arange(B)
    return (j % 32) * 40 + (j // 32) * 100 + rng.integers(0, 3, (lanes, B))


TS_MODES = {
    "cumsum": lambda rng, lanes, B: np.cumsum(rng.integers(0, 60, (lanes, B)), 1),
    "sawtooth": _ts_sawtooth,
    "grid": lambda rng, lanes, B: 50 * np.cumsum(rng.integers(0, 3, (lanes, B)), 1),
}


def make_batch(rng, comp, lanes: int, empty_lane: bool, ts: str = "cumsum"):
    """One seeded wire batch [lanes, B]; values past count are stale noise.
    ``ts`` names the timestamps' shape (``TS_MODES``)."""
    B = comp.B
    n_streams = len(comp.merged.stream_ids)
    cols = {k: np.stack([_column(rng, comp.merged.columns[k].name, B)
                         for _ in range(lanes)])
            for k in sorted(comp.used_cols)}
    tag = rng.integers(0, n_streams, (lanes, B)).astype(np.int8)
    ts = TS_MODES[ts](rng, lanes, B).astype(np.int32)
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


def _run_parity(name, B, C, K, lanes, steps=4, seed=0, ts="cumsum"):
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
        cols, tag, tss, base, counts = make_batch(
            rng, tc, lanes, empty_lane=lanes > 1 and i % 2 == 1, ts=ts)
        jstate, jys = jstep(jstate, cols, tag, tss, base, counts)
        tstate, tys = tstep(tstate, {k: torch.from_numpy(v) for k, v in cols.items()},
                            torch.from_numpy(tag), torch.from_numpy(tss),
                            torch.from_numpy(base), torch.from_numpy(counts))
        jstate = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
        _assert_tree_equal(jstate, state_to_numpy(tstate))
        _assert_tree_equal(jax.tree_util.tree_map(np.asarray, jys),
                           state_to_numpy(tys))
        advanced += int(np.asarray(jys["mask"]).sum())
    return advanced, int(np.sum(jstate["drops"]))


@pytest.mark.parametrize("name,B,C,K,lanes,ts", CASES, ids=CASE_IDS)
def test_block_step_matches_jax(name, B, C, K, lanes, ts):
    advanced, _ = _run_parity(name, B, C, K, lanes, ts=ts)
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
@pytest.mark.parametrize("name,B,C,K,lanes,ts", CASES, ids=CASE_IDS)
def test_kernel_matches_plain_on_card(name, B, C, K, lanes, ts):
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
        wire = make_batch(rng, tc, lanes, empty_lane=lanes > 1 and i % 2 == 1,
                          ts=ts)
        cols = {k: torch.from_numpy(v).cuda() for k, v in wire[0].items()}
        rest = [torch.from_numpy(a).cuda() for a in wire[1:]]
        ref_state, ref_ys = block_step_plain(
            tc, state_from_numpy(state_to_numpy(state), "cuda"), cols, *rest)
        state, ys = step(state, cols, *rest)
        torch.cuda.synchronize()
        _assert_tree_equal(state_to_numpy(ref_state), state_to_numpy(state))
        _assert_tree_equal(state_to_numpy(ref_ys), state_to_numpy(ys))
    cl, mode, _ = tc.plan.layout(tc.plan._lib())
    # creations this large leave shared memory for the kernel's scratch; a
    # plan this large leaves the cluster for one CTA a lane
    assert bool(mode & 1) == (name == "chain8" and B == 2048 and K is None)
    assert (cl == 1) == (name == "chain8" and C == 1024)


WIDE4 = """
define stream S (dev string, v float, n int, w float);
from every e1=S[v > 60.0 and n > 0] -> e2=S[v > e1.v and dev == e1.dev]
  -> e3=S[w > e2.v and n >= e1.n] within 4000
select e1.dev as d, e1.v as a, e2.v as b, e3.w as c, e3.n as k insert into O;
"""


def _partitioned(app: str) -> str:
    head, query = app.strip().split("\n", 1)
    return f"{head}\npartition with (dev of S)\nbegin\n{query}\nend;\n"


def test_block_limits_refuse_at_construction():
    from siddhi_tpu.tpu.nfa import DeviceNFARuntime as JNFARuntime
    from siddhi_tpu.tpu.partition import PartitionedNFARuntime as JPRuntime
    from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
    from siddhi_tpu_torch.gpu.nfa import DeviceNFARuntime as TNFARuntime
    from siddhi_tpu_torch.gpu.nfa_block import MODE_BATCH_GLOBAL
    from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime as TPRuntime

    def compiler(app, B, C, K):
        tapp = tparse(app)
        return TCompiler(tapp.queries[0], dict(tapp.stream_definitions), C, B,
                         creation_cap=K, device="cpu")

    # the Python mirror of the kernel's plan: (CTAs a lane, mode, scratch)
    main = TPRuntime(_partitioned(APPS["chain8"][0]), num_partitions=64,
                     key_attr="dev", slot_capacity=64, lane_batch=2048,
                     creation_cap=320, device="cpu")
    assert main.compiler.plan.layout_mirror == (2, 0, 0)
    assert compiler(APPS["chain8"][0], 2048, 8, None).plan.layout_mirror[:2] \
        == (2, 1)
    assert compiler(APPS["chain8"][0], 2048, 1024, None).plan.layout_mirror[:2] \
        == (1, 3)
    # B = 16,384 with four 32-bit columns: the batch cannot be staged, the
    # kernel reads it from global memory; accepted everywhere
    wide = compiler(WIDE4, 16384, 64, 256)
    assert len(wide.plan.col_keys) == 4
    cl, mode, _ = wide.plan.layout_mirror
    assert cl == 1 and mode & MODE_BATCH_GLOBAL
    TNFARuntime(WIDE4, slot_capacity=64, batch_capacity=16384, device="cpu")
    TPRuntime(_partitioned(WIDE4), num_partitions=2, key_attr="dev",
              slot_capacity=64, lane_batch=16384, creation_cap=256,
              device="cpu")
    # B = 32,768 fits no mode: refused when built, on every device
    with pytest.raises(DeviceCompileError, match="blocked kernel"):
        compiler(WIDE4, 32768, 64, 256)
    with pytest.raises(DeviceCompileError, match="blocked kernel"):
        TNFARuntime(WIDE4, slot_capacity=64, batch_capacity=32768,
                    device="cpu")
    with pytest.raises(DeviceCompileError, match="blocked kernel"):
        TPRuntime(_partitioned(WIDE4), num_partitions=2, key_attr="dev",
                  slot_capacity=64, lane_batch=32768, creation_cap=256,
                  device="cpu")
    # the reference accepts all of these
    japp = jparse(WIDE4)
    for B in (16384, 32768):
        JCompiler(japp.queries[0], dict(japp.stream_definitions), 64, B,
                  creation_cap=256)
    JNFARuntime(WIDE4, slot_capacity=64, batch_capacity=32768)
    JPRuntime(_partitioned(WIDE4), num_partitions=2, key_attr="dev",
              slot_capacity=64, lane_batch=32768, creation_cap=256,
              mesh=None)


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
