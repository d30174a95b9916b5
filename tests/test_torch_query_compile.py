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
hopping and scan-walked window with its kernel plan linked; and
``avalanche`` is the reference's splitmix64 bit for bit.
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
