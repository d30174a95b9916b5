"""The port's single-stream query step against the JAX package, step by step.

Every case of ``test_torch_query_shapes.py`` runs the same seeded wire
batches (stale values past each batch's count) through the reference's
``CompiledStreamQuery`` (jitted on the CPU, as ``tests/test_tpu_query.py``
runs it) and the port's ``stream_step_plain``; after every step every state
leaf and every output position (masked-off positions included) is held to
the tolerances stated in ``test_torch_query_shapes.py``: exact except float32
sums/avgs and Kahan/Welford leaves (``2**-20`` of a sum of |x| that
bounds every prefix either side reads, each side carrying its own state:
``next_scale``; an avg's limit divided by its row's count) and stdDev. Also here: the port refuses exactly what the reference refuses
(same message) at construction, and compiles one small query per tumbling,
hopping and scan-walked window with its kernel plan linked;
``avalanche`` is the reference's splitmix64 bit for bit; and a step's
batch and outputs, moved through one buffer each way (``gpu/transfer.py``),
are the arrays they were, exactly.
"""

import jax
import numpy as np
import pytest
import torch

from siddhi_tpu.compiler import parse as jparse
from siddhi_tpu.tpu.backend import avalanche as javalanche
from siddhi_tpu.tpu.expr_compile import DeviceCompileError as JError
from siddhi_tpu.tpu.query_compile import CompiledStreamQuery as JQuery
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.gpu.backend import avalanche
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError as TError
from siddhi_tpu_torch.gpu.query_compile import (
    CompiledStreamQuery as TQuery,
    stream_step_plain,
)
from siddhi_tpu_torch.gpu.state_io import state_to_numpy
from siddhi_tpu_torch.gpu.transfer import to_device, to_host

from test_torch_query_shapes import (
    ACCEPTED,
    CASES,
    IDS,
    QUERIES,
    REFUSED,
    STAGED,
    STEP_RAISES,
    STEPS,
    Scale,
    Wire,
    app_text,
    compare,
    compile_port,
    next_scale,
    refusal_wire,
    wire_for,
)
from test_torch_query_shapes import REFUSAL_SCHEMA as S


def _jax_query(name: str, B: int) -> JQuery:
    app = jparse(app_text(name))
    return JQuery(app.queries[0], app.stream_definitions["S"], B,
                  **QUERIES[name][1])


def _out_numpy(out) -> dict:
    return {"out": {k: np.asarray(v) for k, v in out["out"].items()},
            "valid": np.asarray(out["valid"]), "ts": np.asarray(out["ts"]),
            "count": np.asarray(out["count"])}


@pytest.mark.parametrize("name,B", CASES, ids=IDS)
def test_step_matches_reference(name, B):
    jq, tq = _jax_query(name, B), compile_port(name, B, "cpu")
    jstate, tstate = jq.init_state(), tq.init_state()
    wire, fed = wire_for(name, B), Scale()
    for step in range(STEPS):
        batch = wire.batch(step)
        jstate, jout = jq.step(jstate, batch)
        cols, ts, valid = tq.batch_tensors(batch)
        fed = next_scale(tq, fed, tstate, cols, ts, valid)
        tstate, tout = stream_step_plain(tq, tstate, cols, ts, valid)
        compare(tq, fed, {k: np.asarray(v) for k, v in
                           jax.device_get(jstate).items()},
                state_to_numpy(tstate), _out_numpy(jax.device_get(jout)),
                _out_numpy(state_to_numpy(tout)))


# ----------------------------------------------------------------- refusals

def _build(pkg, text):
    parse, Q = (jparse, JQuery) if pkg == "jax" else (tparse, TQuery)
    app = parse(S + text)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return Q(app.queries[0], app.stream_definitions["S"], 8, **kw)


@pytest.mark.parametrize("text", REFUSED)
def test_refuses_what_the_reference_refuses(text):
    with pytest.raises(JError) as je:
        _build("jax", text)
    with pytest.raises(TError) as te:
        _build("torch", text)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("text", STEP_RAISES)
def test_constant_projection_raises_at_the_step_as_in_the_reference(text):
    jq, tq = _build("jax", text), _build("torch", text)
    batch = refusal_wire(8)
    with pytest.raises(AttributeError) as je:
        jq.step(jq.init_state(), batch)
    with pytest.raises(AttributeError) as te:
        tq.step(tq.init_state(), batch)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("window", sorted(STAGED))
def test_slice_windows_compile_and_link(window):
    text = f"from S{STAGED[window]} insert into O;"
    jq = _build("jax", text)
    q = _build("torch", text)
    assert q.plan.link_error is None
    assert q.window_kind == jq.window_kind
    assert q.window_name == window


@pytest.mark.parametrize("text", ACCEPTED)
def test_accepts_what_the_slice_covers(text):
    _build("jax", text)
    q = _build("torch", text)
    assert q.plan.link_error is None


def test_avalanche_bit_for_bit():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.integers(-2 ** 63, 2 ** 63 - 1, 4096, dtype=np.int64),
        rng.integers(-5, 5, 64).astype(np.int64),
        np.array([0, -1, 1, -2 ** 63, 2 ** 63 - 1], np.int64)])
    want = javalanche(x, np)
    got = avalanche(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and (got == want).all()


# ---------------------------------------------------- one copy each way

@pytest.mark.parametrize("shapes", [
    [(np.int32, (7,)), (np.float32, (7,)), (np.int64, (7,)), (np.bool_, (7,))],
    [(np.bool_, (5,)), (np.float64, (3, 5)), (np.int64, ()),
     (np.float32, (0,)), (np.uint8, (9,)), (np.int16, (3,))],
], ids=["batch_layout", "mixed"])
def test_transfer_round_trip_is_exact(shapes):
    rng = np.random.default_rng(5)
    arrays = [np.asarray((rng.standard_normal(sh) * 1e3).astype(dt)
                         if dt != np.bool_ else rng.random(sh) > 0.5)
              for dt, sh in shapes]
    moved = to_device(arrays, torch.device("cpu"))
    for a, t in zip(arrays, moved):
        assert t.dtype == torch.from_numpy(a).dtype and tuple(t.shape) == a.shape
        assert np.array_equal(t.numpy(), a)
        assert t.numel() == 0 or t.data_ptr() % 16 == 0
    back = to_host(moved + [torch.arange(12).reshape(3, 4).t()])
    for a, h in zip(arrays + [np.arange(12).reshape(3, 4).T], back):
        assert h.dtype == a.dtype and h.shape == a.shape
        assert np.array_equal(h, a)


@pytest.mark.parametrize("name,B", CASES[:6], ids=IDS[:6])
def test_one_copy_batch_and_decode_match_per_tensor_copies(name, B):
    tq = compile_port(name, B, "cpu")
    state, wire = tq.init_state(), wire_for(name, B)
    for step in range(3):
        batch = wire.batch(step)
        cols, ts, valid = tq.batch_tensors(batch)
        for k, v in batch["cols"].items():
            assert np.array_equal(cols[k].numpy(), v)
        assert np.array_equal(ts.numpy(), batch["ts"])
        assert np.array_equal(valid.numpy(), batch["valid"])
        state, out = stream_step_plain(tq, state, cols, ts, valid)
        idx = np.nonzero(out["valid"].numpy())[0]
        want = [list(r) for r in zip(*[
            [tq.schema.dictionaries[s.source_attr].decode(c) for c in
             out["out"][s.name].numpy()[idx].tolist()]
            if s.dtype.name == "STRING" and s.source_attr else
            out["out"][s.name].numpy()[idx].tolist() for s in tq.specs])]
        assert tq.decode_outputs(out) == want
