"""The port's incremental-aggregation step against the JAX package's, on
the CPU.

Every shape of ``tests/test_torch_agg_shapes.py`` runs through the JAX
package's ``CompiledAggregation.step`` and the port's (``device="cpu"``, so
``aggregation_step_plain``) on the same seeded batches; after every step
every key, every ``[D, B]`` position and ``n_runs`` must be equal, bitwise
(no tolerance: see that module). Also here: both packages compute the same
bucket slab, the port refuses exactly what the reference refuses with its
message, and the kernel's limits refuse at construction where the reference
accepts.
"""

import jax
import numpy as np
import pytest

from siddhi_tpu.compiler import parse as jparse
from siddhi_tpu.tpu.aggregation_compile import CompiledAggregation as JAgg
from siddhi_tpu.tpu.expr_compile import DeviceCompileError as JError
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.gpu.aggregation_compile import CompiledAggregation as TAgg
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError as TError

from test_torch_agg_shapes import (
    AGGS,
    LIMITS,
    REFUSAL_B,
    REFUSED,
    SCHEMA,
    STEPS,
    app_text,
    compare,
    compile_port,
    definition,
    wire_for,
)


def _jax_agg(name: str) -> JAgg:
    d, sdef = definition(jparse, app_text(name))
    return JAgg(d, sdef, AGGS[name][1])


@pytest.mark.parametrize("name", sorted(AGGS))
def test_step_matches_reference(name):
    ja, ta = _jax_agg(name), compile_port(name, "cpu")
    assert [s["name"] for s in ta.specs] == [s["name"] for s in ja.specs]
    assert [(s["kind"], s.get("src")) for s in ta.specs] == \
        [(s["kind"], s.get("src")) for s in ja.specs]
    assert [(n, t.value) for n, t in ta.group_cols] == \
        [(n, t.value) for n, t in ja.group_cols] and ta.D == ja.D
    wire = wire_for(name)
    for step in range(STEPS):
        b = wire.batch(step)
        slab = ta.bucket_slab(b["ts"])
        np.testing.assert_array_equal(slab, ja.bucket_slab(b["ts"]))
        ref = {k: np.asarray(v) for k, v in
               jax.device_get(ja.step(b["cols"], b["ts"], slab, b["valid"])).items()}
        got = ta.step(b["cols"], b["ts"], slab, b["valid"])
        compare(ref, got)
        # the decoded partial rows, as the runtime reads them (by repr:
        # NaN sums and extremes compare equal)
        assert repr(list(ta.iter_partials(got))) == \
            repr(list(ja.iter_partials(ref)))


def _build(pkg, text, B):
    parse, A = (jparse, JAgg) if pkg == "jax" else (tparse, TAgg)
    d, sdef = definition(parse, text)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return A(d, sdef, B, **kw)


@pytest.mark.parametrize("text", REFUSED)
def test_refuses_what_the_reference_refuses(text):
    full = SCHEMA + "define aggregation A " + text
    with pytest.raises(JError) as je:
        _build("jax", full, REFUSAL_B)
    with pytest.raises(TError) as te:
        _build("torch", full, REFUSAL_B)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("i", range(len(LIMITS)))
def test_limits_refuse_at_construction_where_the_reference_accepts(i):
    text, B = LIMITS[i]
    _build("jax", text, B)
    with pytest.raises(TError, match="^aggregation kernel: "):
        _build("torch", text, B)
