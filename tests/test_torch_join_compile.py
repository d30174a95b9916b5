"""The port's stream-stream join step against the JAX package, step by step.

Every shape of ``test_torch_join_shapes.py`` runs the same seeded merged
wire batches (stale tags and values past each batch's valid prefix, one
side empty in some steps, an empty and a full batch) through the
reference's ``CompiledJoinQuery`` (jitted on the CPU, as
``tests/test_tpu_join.py`` runs it) and the port's ``join_step_plain``;
after every step every state leaf (rings, ring timestamps, ``join_drops``,
``ring_drops``), every output position (masked-off rows included), the
null masks, ``valid``, ``ts`` and ``count`` must be equal (no tolerance:
see that module). Also here: the port refuses exactly what the reference
refuses, with its message, and the kernel's limits refuse at construction
where the reference accepts.
"""

import jax
import numpy as np
import pytest

from siddhi_tpu.compiler import parse as jparse
from siddhi_tpu.tpu.expr_compile import DeviceCompileError as JError
from siddhi_tpu.tpu.join_compile import CompiledJoinQuery as JJoin
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError as TError
from siddhi_tpu_torch.gpu.join_compile import CompiledJoinQuery as TJoin
from siddhi_tpu_torch.gpu.join_compile import join_step_plain
from siddhi_tpu_torch.gpu.state_io import state_to_numpy

from test_torch_join_shapes import (
    JOINS,
    LIMITS,
    REFUSAL_CAPS,
    REFUSAL_SCHEMA,
    REFUSED,
    STEPS,
    app_text,
    compare,
    compile_port,
    out_numpy,
    wire_for,
)


def _jax_join(name: str) -> JJoin:
    _, B, W, J = JOINS[name]
    app = jparse(app_text(name))
    return JJoin(app.queries[0], dict(app.stream_definitions), B, W, J)


@pytest.mark.parametrize("name", sorted(JOINS))
def test_step_matches_reference(name):
    jq, tq = _jax_join(name), compile_port(name, "cpu")
    jstate, tstate = jq.init_state(), tq.init_state()
    wire = wire_for(name)
    for step in range(STEPS):
        batch = wire.batch(step)
        jstate, jout = jq.step(jstate, batch)
        tstate, tout = join_step_plain(tq, tstate, *tq.batch_tensors(batch))
        compare({k: np.asarray(v) for k, v in jax.device_get(jstate).items()},
                state_to_numpy(tstate), out_numpy(jax.device_get(jout)),
                out_numpy(state_to_numpy(tout)))
    drops = int(tstate["join_drops"]), int(tstate["ring_drops"])
    if name == "join_overflow":
        assert drops[0] > 0
    if name == "ring_overflow":
        assert drops[1] > 0


def _build(pkg, text, B, W, J):
    parse, Q = (jparse, JJoin) if pkg == "jax" else (tparse, TJoin)
    app = parse(text)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return Q(app.queries[0], dict(app.stream_definitions), B, W, J, **kw)


@pytest.mark.parametrize("text", REFUSED)
def test_refuses_what_the_reference_refuses(text):
    """The same exception class (by name: each package has its own
    ``DeviceCompileError``) and message. A window parameter or ``within``
    that is not a constant raises TypeError in both: every expression has a
    ``value`` (a static method), so the reference's constant check passes
    and ``int()`` of it fails."""
    with pytest.raises((JError, TypeError)) as je:
        _build("jax", REFUSAL_SCHEMA + text, *REFUSAL_CAPS)
    with pytest.raises((TError, TypeError)) as te:
        _build("torch", REFUSAL_SCHEMA + text, *REFUSAL_CAPS)
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("i", range(len(LIMITS)))
def test_limits_refuse_at_construction_where_the_reference_accepts(i):
    text, B, W, J = LIMITS[i]
    _build("jax", text, B, W, J)
    with pytest.raises(TError, match="^join kernel: "):
        _build("torch", text, B, W, J)
