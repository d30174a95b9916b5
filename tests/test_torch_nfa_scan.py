"""The port's per-event scan NFA step against the JAX package's, step by step.

The same seeded wire batches (numpy) go through the JAX step (``vmap`` of
``DeviceNFACompiler.make_step`` over lanes, jitted on the CPU as the JAX
package's own tests run it) and through the port's lane-batched
``scan_step_plain`` on the CPU. Every state leaf (``pending``, ``seeds``,
``drops``, ``matches``) and every ``ys`` entry (mask, ts, outputs and null
masks, masked-off positions included) must be exactly equal, the f32
outputs computed by arithmetic too (the same f32 operations in the same
order). Batches carry stale values past ``count`` and, in odd steps, an
empty lane.

``test_kernel_matches_plain_on_card`` holds the CUDA kernel against the plain
version on the same shapes; it needs a card and skips elsewhere.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from siddhi_tpu.compiler import parse as jparse
from siddhi_tpu.tpu.expr_compile import DeviceCompileError as JError
from siddhi_tpu.tpu.nfa import DeviceNFACompiler as JCompiler
from siddhi_tpu.tpu.partition import PartitionedNFARuntime as JPartitioned
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError as TError
from siddhi_tpu_torch.gpu.nfa import DeviceNFACompiler as TCompiler
from siddhi_tpu_torch.gpu.nfa import DeviceNFARuntime as TRuntime
from siddhi_tpu_torch.gpu import nfa_scan
from siddhi_tpu_torch.gpu.nfa_scan import ScanPlan, scan_step_plain
from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime as TPartitioned
from siddhi_tpu_torch.gpu.state_io import state_from_numpy, state_to_numpy
from test_torch_scan_shapes import AB, APPS, CASES, IDS

ROOT = Path(__file__).resolve().parent.parent


def _compilers(app, B, C):
    japp, tapp = jparse(app), tparse(app)
    jc = JCompiler(japp.queries[0], dict(japp.stream_definitions), C, B)
    tc = TCompiler(tapp.queries[0], dict(tapp.stream_definitions), C, B,
                   device="cpu")
    assert not jc.blocked and not tc.blocked
    assert jc.used_cols == tc.used_cols
    assert {(q, k, t.name) for (q, k, t) in jc.referenced} == \
        {(q, k, t.name) for (q, k, t) in tc.referenced}
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


def make_batch(rng, comp, lanes: int, empty_lane: bool, ts_step: int = 60,
               base=None):
    """One seeded wire batch [lanes, B]; values past count are stale noise.
    ``base`` pins every lane's ts base (else random per lane)."""
    B = comp.B
    n_streams = len(comp.merged.stream_ids)
    cols = {k: np.stack([_column(rng, comp.merged.columns[k].name, B)
                         for _ in range(lanes)])
            for k in sorted(comp.used_cols)}
    tag = rng.integers(0, n_streams, (lanes, B)).astype(np.int8)
    ts = np.cumsum(rng.integers(0, ts_step, (lanes, B)), 1).astype(np.int32)
    if base is None:
        ts_base = rng.integers(10**6, 2 * 10**6, lanes).astype(np.int64)
    else:
        ts_base = np.full(lanes, base, np.int64)
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


def _jax_lane_state(jc, lanes, start_ts=0):
    single = jc.init_state(start_ts)
    return jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x)[None],
                                  (lanes,) + np.shape(x)).copy(), single)


def _torch_args(cols, tag, ts, base, counts, dev="cpu"):
    return ({k: torch.from_numpy(v).to(dev) for k, v in cols.items()},
            *(torch.from_numpy(a).to(dev) for a in (tag, ts, base, counts)))


def _run_parity(name, B, C, lanes, ts_step, base, steps=4, seed=0):
    app = APPS[name][0]
    jc, tc = _compilers(app, B, C)
    start = 0 if base is not None else 1_000_000
    jstep = jax.jit(jax.vmap(jc.make_step()))
    jstate = _jax_lane_state(jc, lanes, start)
    tstate = tc.init_state(lanes, start)
    _assert_tree_equal(jstate, state_to_numpy(tstate))
    rng = np.random.default_rng(seed)
    emitted = 0
    for i in range(steps):
        wire = make_batch(rng, tc, lanes, empty_lane=(i % 2 == 1),
                          ts_step=ts_step, base=base)
        jstate, jys = jstep(jstate, *wire)
        tstate, tys = scan_step_plain(tc, tstate, *_torch_args(*wire))
        jstate = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
        _assert_tree_equal(jstate, state_to_numpy(tstate))
        jys = jax.tree_util.tree_map(np.asarray, jys)
        _assert_tree_equal(jys, state_to_numpy(tys))
        # decoded rows, lane by lane, in the reference's order
        for lane in range(lanes):
            assert tc.decode_outputs({k: v[lane] for k, v in tys.items()}) \
                == jc.decode_outputs({k: v[lane] for k, v in jys.items()})
        emitted += int(jys["mask"].sum())
    return emitted, int(np.sum(jstate["drops"]))


@pytest.mark.parametrize("name,B,C,lanes,ts_step,base", CASES, ids=IDS)
def test_scan_step_matches_jax(name, B, C, lanes, ts_step, base):
    emitted, drops = _run_parity(name, B, C, lanes, ts_step, base)
    assert emitted > 0, "the case must emit matches to mean anything"
    if C == 4:
        assert drops > 0, "the overflow case must drop"


def test_all_lanes_decode_in_lane_order():
    # decode over the whole [L, B, 2, C] grid equals the lane-by-lane decode
    app, _ = APPS["or_mid"]
    _, tc = _compilers(app, 16, 8)
    rng = np.random.default_rng(5)
    state = tc.init_state(3)
    rows_all, rows_lanes = [], []
    for i in range(3):
        wire = make_batch(rng, tc, 3, empty_lane=i == 1)
        state, ys = scan_step_plain(tc, state, *_torch_args(*wire))
        rows_all += tc.decode_outputs(ys)
        for lane in range(3):
            rows_lanes += tc.decode_outputs({k: v[lane] for k, v in ys.items()})
    assert rows_all == rows_lanes and len(rows_all) > 0
    assert any(v is None for r in rows_all for v in r)     # OR sides: NULL


REFUSED = [
    # absent without `for` (followed-by semantics) stays on host
    """define stream A (v long); define stream B (v long); define stream C (v long);
    from e1=A -> not B -> e3=C select e3.v as v insert into O;""",
    # sibling alias reference inside a logical state
    """define stream A (v long); define stream B (v long); define stream C (v long);
    from e1=A -> e2=B and e3=C[v > e2.v] select e1.v as v insert into O;""",
    # absent states inside sequences
    """define stream A (v long); define stream B (v long); define stream C (v long);
    from every e1=A, not B for 1 sec, e3=C select e1.v as v insert into O;""",
    # non-null-strict predicate over a possibly-unbound binding
    """define stream A (v long); define stream B (v long);
    from e1=A<0:5> -> e2=B[v > e1[0].v or v < 0]
    select e2.v as v insert into O;""",
    # back-to-back counts
    """define stream A (v long); define stream B (v long);
    from e1=A<1:2> -> e2=B<1:3>
    select e1[0].v as a, e2[0].v as b insert into O;""",
    # e[k] beyond the device range
    """define stream A (v long); define stream B (v long);
    from e1=A<1:20> -> e2=B select e1[16].v as a insert into O;""",
    # element-level within on a scan shape
    """define stream A (v long); define stream B (v long);
    from e1=A<1:2> -> e2=B within 1 sec -> e3=A select e2.v as a insert into O;""",
]


def test_port_refuses_exactly_what_the_reference_refuses():
    for app in REFUSED:
        japp, tapp = jparse(app), tparse(app)
        with pytest.raises(JError):
            JCompiler(japp.queries[0], dict(japp.stream_definitions), 8, 8)
        with pytest.raises(TError):
            TCompiler(tapp.queries[0], dict(tapp.stream_definitions), 8, 8,
                      device="cpu")
    # absent states under a partition are refused by both
    app = """
define stream S (dev string, v double);
partition with (dev of S)
begin
from every e1=S[v > 50.0] -> not S[v > 90.0] for 1 sec -> e3=S[v > 10.0]
select e1.v as a insert into O;
end;
"""
    with pytest.raises(JError):
        JPartitioned(app, num_partitions=2, key_attr="dev")
    with pytest.raises(TError):
        TPartitioned(app, num_partitions=2, key_attr="dev", device="cpu")


def test_scan_plan_links_every_program():
    # the kernel plan links every predicate (at each level it runs at) and
    # output program, and lays out every state table
    app, _ = APPS["count_mid"]
    _, tc = _compilers(app, 16, 8)
    plan = ScanPlan(tc)
    assert plan.code_host.shape[1] == 4 and len(plan.code_host) > 0
    assert len(plan.tables) == tc.S
    for s, st in enumerate(tc.states):
        assert set(plan.tables[s]) == set(tc.init_state(1)["pending"][f"p{s}"])


def test_kernel_source_agrees_with_the_python_constants():
    src = (ROOT / "siddhi_tpu_torch" / "csrc" / "nfa_scan.cu").read_text()
    for name in ("MAXS", "MAXK", "MAXF", "MAXCOL", "MAXOUT", "MAXNULL",
                 "MAXC", "MAXSTACK", "NMASK"):
        m = re.search(rf"#define {name} (\d+)", src)
        assert int(m.group(1)) == getattr(nfa_scan, name), name
    m = re.search(r"#define SMEM_LIMIT \((\d+) \* 1024\)", src)
    assert int(m.group(1)) * 1024 == nfa_scan.SMEM_LIMIT
    enums = re.findall(r"enum \{(.*?)\};", src, re.S)

    def names(body):
        return [n.strip().split("=")[0].strip() for n in body.split(",")
                if n.strip()]
    assert names(enums[0]) == ["S_STREAM", "S_COUNT", "S_LOGICAL", "S_ABSENT"]
    assert list(nfa_scan.S_KIND.values()) == [0, 1, 2, 3]
    assert names(enums[2]) == ["F_VALID", "F_FIRST", "F_COUNT", "F_CLOSED",
                               "F_ARRIVE", "F_FRESH", "F_DONE", "F_ABSDEAD",
                               "F_KEY"]
    assert [getattr(nfa_scan, n) for n in names(enums[2])] == list(range(9))
    assert [getattr(nfa_scan, n) for n in names(enums[3])] == list(range(8))


def test_kernel_wrapper_refuses_cpu_tensors_and_limits():
    app, _ = APPS["or_mid"]
    _, tc = _compilers(app, 16, 8)
    step = tc.make_step()
    wire = make_batch(np.random.default_rng(1), tc, 2, empty_lane=False)
    state = tc.init_state(2)
    with pytest.raises(ValueError, match="CUDA"):
        step.plan.step_cuda(state, *_torch_args(*wire))
    # the dispatching step runs the plain version for CPU tensors
    before = ScanPlan.launches
    _, ys = step(state, *_torch_args(*wire))
    assert ys["mask"].shape == (2, 16, 2, 8)
    assert ScanPlan.launches == before


# an app over a kernel limit (here C = MAXC + 1 slots, which the reference
# accepts) is refused where each entry point is built, on every device
OVER_LIMIT = [
    lambda app, C: TCompiler(tparse(app).queries[0],
                             dict(tparse(app).stream_definitions), C, 16,
                             device="cpu"),
    lambda app, C: TRuntime(app, slot_capacity=C, batch_capacity=16,
                            device="cpu"),
    lambda app, C: TPartitioned(
        AB + "partition with (sym of A, sym of B) begin"
        + app[len(AB):] + "end;", num_partitions=2, key_attr="sym",
        slot_capacity=C, lane_batch=16, device="cpu"),
]


@pytest.mark.parametrize("build", OVER_LIMIT,
                         ids=["compiler", "runtime", "partitioned"])
def test_scan_limits_refuse_at_construction(build):
    app, _ = APPS["or_mid"]
    build(app, nfa_scan.MAXC)                  # at the limit: accepted
    with pytest.raises(TError, match="slots"):
        build(app, nfa_scan.MAXC + 1)
    japp = jparse(app)                         # the reference accepts it
    JCompiler(japp.queries[0], dict(japp.stream_definitions),
              nfa_scan.MAXC + 1, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,C,lanes,ts_step,base", CASES, ids=IDS)
def test_kernel_matches_plain_on_card(name, B, C, lanes, ts_step, base):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    app = APPS[name][0]
    tapp = tparse(app)
    tc = TCompiler(tapp.queries[0], dict(tapp.stream_definitions), C, B,
                   device="cuda")
    step = tc.make_step()
    start = 0 if base is not None else 1_000_000
    state = tc.init_state(lanes, start)
    rng = np.random.default_rng(11)
    for i in range(4):
        wire = make_batch(rng, tc, lanes, empty_lane=(i % 2 == 1),
                          ts_step=ts_step, base=base)
        args = _torch_args(*wire, dev="cuda")
        ref_state, ref_ys = scan_step_plain(
            tc, state_from_numpy(state_to_numpy(state), "cuda"), *args)
        state, ys = step(state, *args)
        torch.cuda.synchronize()
        _assert_tree_equal(state_to_numpy(ref_state), state_to_numpy(state))
        _assert_tree_equal(state_to_numpy(ref_ys), state_to_numpy(ys))
