"""The fleet's parameter columns on the card: the query kernel
(``csrc/query_step.cu``, ``having`` over a parameter included) and the
blocked NFA kernel (``csrc/nfa_block.cu``) read the ``__fleet_p{i}``
columns of a shape's shared device plan (``FleetManager.device_plan``) as
their plain versions do, step by step, state and outputs. Port-only
imports: it runs on the card's machine, where JAX is missing
(``python -m pytest tests/test_torch_fleet_card.py -m cuda``); every case
skips where no CUDA device is present (the kernels have no CPU mode).
"""

import random

import numpy as np
import pytest
import torch

import siddhi_tpu_torch
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.fleet.shape import normalize_partition_query as tnorm_part
from siddhi_tpu_torch.fleet.shape import normalize_query as tnorm
from siddhi_tpu_torch.gpu.batch import columns_from_rows as tcolumns
from siddhi_tpu_torch.gpu.state_io import state_to_numpy

STREAM = "define stream S (sym string, v double, n long);\n"

STREAM_SHAPES = {
    "filter_string": "from S[v > 30.0 and sym == 'a'] select sym, v, n "
                     "insert into Out;",
    "projection": "from S[v * 2.0 + 1.0 > 100.0] select v * 3.0 as x, n "
                  "insert into Out;",
    "group_having": "from S select sym, sum(n) as s, count() as c "
                    "group by sym having s > 500 insert into Out;",
    "window_having": "from S#window.length(8) select sym, max(v) as mx "
                     "having mx > 50.0 and mx < 99.0 insert into Out;",
    "running_having": "from S select count() as c, max(n) as mx "
                      "having mx > 900 insert into Out;",
    "sort_having": "from S#window.sort(4, v) select sym, max(n) as mx "
                   "having mx > 700 insert into Out;",
}

CHAIN = STREAM + """partition with (sym of S) begin from every
e1=S[v > 90.0] -> e2=S[v > e1.v + 1.5] within 4000 select e1.v as a,
e2.v as b insert into Out; end;"""


def _rows(n, seed):
    rng = random.Random(seed)
    rows, ts, t = [], [], 1_000_000
    for _ in range(n):
        rows.append(["abc"[rng.randrange(3)], round(rng.uniform(0, 100), 2),
                     rng.randrange(1000)])
        t += rng.randrange(1, 30)
        ts.append(t)
    return rows, ts


def _params(nq, tenants, rng, dictionary):
    out = []
    for t in range(tenants):
        vals = []
        for spec, val in zip(nq.param_specs, nq.param_values):
            if spec.string:
                vals.append(dictionary.encode(["a", "b", "c"][t % 3]))
            elif spec.type.name in ("FLOAT", "DOUBLE"):
                vals.append(np.float32(val + rng.uniform(-20, 20)))
            elif spec.type.name == "INT":
                vals.append(np.int32(val + rng.integers(-200, 200)))
            else:
                vals.append(np.int64(val + rng.integers(-200, 200)))
        out.append(vals)
    return out


def _dtype(spec):
    if spec.string:
        return np.int32
    return {"FLOAT": np.float32, "DOUBLE": np.float32, "INT": np.int32,
            "LONG": np.int64}[spec.type.name]


def _with_params(batch, nq, mids, params):
    cols = dict(batch["cols"])
    for i, spec in enumerate(nq.param_specs):
        lut = np.array([p[i] for p in params], dtype=_dtype(spec))
        cols[f"__fleet_p{spec.index}"] = lut[mids]
    return {**batch, "cols": cols}


def _tree_equal(ref, got, what):
    assert set(ref) == set(got), what
    for k in ref:
        if isinstance(ref[k], dict):
            _tree_equal(ref[k], got[k], f"{what}.{k}")
            continue
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}.{k}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(STREAM_SHAPES))
def test_query_kernel_reads_param_columns_as_its_plain_version(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from siddhi_tpu_torch.gpu.query_compile import stream_step_plain
    text = STREAM + STREAM_SHAPES[shape]
    app = tparse(text)
    defs = dict(app.stream_definitions)
    m = siddhi_tpu_torch.SiddhiManager()
    nq = tnorm(app.queries[0], defs)
    q = m.fleet.device_plan(nq, defs)
    rows, ts = _rows(3 * 256, seed=3)
    params = _params(nq, 16, np.random.default_rng(2),
                            q.schema.dictionaries["sym"])
    rng = np.random.default_rng(4)
    state = q.init_state()
    for step in range(3):
        part = slice(step * 256, (step + 1) * 256)
        b = _with_params(tcolumns(q.schema, rows[part], ts[part],
                                  capacity=q.B), nq,
                         rng.integers(0, 16, q.B), params)
        cols, tts, valid = q.batch_tensors(b)
        ref_state, ref = stream_step_plain(q, state, cols, tts, valid)
        state, out = q.step_tensors(state, cols, tts, valid)
        torch.cuda.synchronize()
        _tree_equal(state_to_numpy(ref_state), state_to_numpy(state), "st")
        ro, go = state_to_numpy(ref), state_to_numpy(out)
        np.testing.assert_array_equal(go["valid"], ro["valid"])
        v = ro["valid"]
        for name in ro["out"]:
            np.testing.assert_array_equal(go["out"][name][v],
                                          ro["out"][name][v])
    m.shutdown()


@pytest.mark.cuda
def test_blocked_kernel_reads_param_columns_as_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from siddhi_tpu_torch.gpu.nfa_block import block_step_plain
    from siddhi_tpu_torch.gpu.state_io import state_from_numpy
    app = tparse(CHAIN)
    defs = dict(app.stream_definitions)
    part = app.partitions[0]
    m = siddhi_tpu_torch.SiddhiManager()
    nq = tnorm_part(part, part.queries[0], defs)
    tc = m.fleet.device_plan(nq, defs)
    lanes, B = 4, tc.B
    rng = np.random.default_rng(9)
    step = tc.make_step()
    state = tc.init_state(lanes)
    for i in range(3):
        cols = {"s0_sym": rng.integers(1, 4, (lanes, B)).astype(np.int32),
                "s0_v": np.round(rng.uniform(0, 100, (lanes, B)),
                                 1).astype(np.float32)}
        cols = {k: v for k, v in cols.items() if k in tc.used_cols}
        for spec in nq.param_specs:
            lo, hi = (80, 95) if spec.index == 0 else (0, 3)
            cols[f"__fleet_p{spec.index}"] = rng.uniform(
                lo, hi, (lanes, B)).astype(np.float32)
        cols = {k: torch.from_numpy(v).cuda() for k, v in cols.items()}
        rest = [torch.from_numpy(a).cuda() for a in (
            np.zeros((lanes, B), np.int8),
            np.cumsum(rng.integers(0, 60, (lanes, B)), 1).astype(np.int32),
            rng.integers(10**6, 2 * 10**6, lanes).astype(np.int64),
            np.full(lanes, B, np.int32))]
        ref_state, ref_ys = block_step_plain(
            tc, state_from_numpy(state_to_numpy(state), "cuda"), cols, *rest)
        state, ys = step(state, cols, *rest)
        torch.cuda.synchronize()
        _tree_equal(state_to_numpy(ref_state), state_to_numpy(state), "st")
        _tree_equal(state_to_numpy(ref_ys), state_to_numpy(ys), "ys")
    m.shutdown()
