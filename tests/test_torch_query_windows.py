"""The tumbling, hopping and scan-walked query windows of the port against
the JAX package, step by step.

Every case of ``WINDOW_CASES`` in ``test_torch_query_shapes.py`` (one or
more per window: ``lengthBatch`` at batch capacity below N, ``timeBatch``
with gaps spanning several buckets and an open bucket over its capacity,
out-of-order ``externalTimeBatch``, ``session`` with gaps of exactly its
parameter and over its capacity, ``delay`` with overflow drops, ``hopping``
with more boundaries than flush slots, ``sort`` descending over an int key
holding the integer minimum and over a long key equal to the empty
sentinel, ``frequent`` with decrement-all evicting several keys and with a
two-key code, ``lossyFrequent`` with and without an explicit error) feeds
the same seeded wire batches to the reference's ``CompiledStreamQuery``
(jitted on the CPU) and the port's ``stream_step_plain``, and holds every
state leaf and every output position (masked-off ones included) to the
tolerances stated in ``test_torch_query_shapes.py`` after each of
``STEPS + 1`` steps, so the remainder, bucket, hop, buffer or table
carries. ``test_lossy_full_table_drops`` starts both from one full,
unprunable table (a lossy table sized from the error bound fills only
under adversarial streams), so misses are dropped and counted;
``test_walk_from_a_carried_table_matches_reference`` starts both from the
carried tables of ``CARRIED`` (one that the step's first prune empties, one
nearly full of pinned keys, and the table the JAX walk left after
``RESUME_AFTER`` steps, carried into the port through
``gpu/state_io.py``). Sizes stay
small (N <= 32, B <= 64, C <= 16, except the lossy tables, which the
reference sizes at 64 + 1/error slots).
"""

import jax
import numpy as np
import pytest
import torch

from siddhi_tpu.compiler import parse as jparse
from siddhi_tpu.tpu.query_compile import CompiledStreamQuery as JQuery
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.gpu.query_compile import (
    CompiledStreamQuery as TQuery,
    stream_step_plain,
)
from siddhi_tpu_torch.gpu.state_io import query_state_from_numpy, state_to_numpy

from test_torch_query_shapes import (
    CARRIED,
    QUERIES,
    RESUME_AFTER,
    SCHEMA,
    STEPS,
    WINDOW_CASES,
    WINDOW_IDS,
    Scale,
    app_text,
    carried_scale,
    compare,
    compile_port,
    fill_carried,
    next_scale,
    wire_for,
)


def _out_numpy(out) -> dict:
    return {"out": {k: np.asarray(v) for k, v in out["out"].items()},
            "valid": np.asarray(out["valid"]), "ts": np.asarray(out["ts"]),
            "count": np.asarray(out["count"])}


def _run(jq, tq, jstate, tstate, batches, fed):
    """Steps both packages over ``batches``; returns the valid rows."""
    rows = 0
    for batch in batches:
        jstate, jout = jq.step(jstate, batch)
        cols, ts, valid = tq.batch_tensors(batch)
        fed = next_scale(tq, fed, tstate, cols, ts, valid)
        tstate, tout = stream_step_plain(tq, tstate, cols, ts, valid)
        compare(tq, fed, {k: np.asarray(v) for k, v in
                          jax.device_get(jstate).items()},
                state_to_numpy(tstate), _out_numpy(jax.device_get(jout)),
                _out_numpy(state_to_numpy(tout)))
        rows += int(tout["valid"].sum())
    return jstate, tstate, rows


@pytest.mark.parametrize("name,B", WINDOW_CASES, ids=WINDOW_IDS)
def test_window_step_matches_reference(name, B):
    app = jparse(app_text(name))
    jq = JQuery(app.queries[0], app.stream_definitions["S"], B,
                **QUERIES[name][1])
    tq = compile_port(name, B, "cpu")
    wire = wire_for(name, B)
    _run(jq, tq, jq.init_state(), tq.init_state(),
         [wire.batch(step) for step in range(STEPS + 1)], Scale())


def test_lossy_full_table_drops():
    text = SCHEMA + """
from S#window.lossyFrequent(0.05, 0.5, vol)
select vol, count() as c, sum(price) as t insert into O;"""
    B = 32
    japp, tapp = jparse(text), tparse(text)
    jq = JQuery(japp.queries[0], japp.stream_definitions["S"], B)
    tq = TQuery(tapp.queries[0], tapp.stream_definitions["S"], B,
                device="cpu")
    C = tq.window_n
    tree = {k: np.asarray(v) for k, v in jax.device_get(jq.init_state()).items()}
    # a full table of keys 0..C-1, every count high enough never to prune
    tree["hh_keys"] = np.arange(C, dtype=np.int64)
    tree["hh_counts"] = np.full(C, 1000, np.int64)
    tree["hh_fvals"] = np.full((1, C), 0.5, np.float32)
    wire = wire_for("lossy", B)
    batches = [wire.batch(step) for step in range(4)]
    for b in batches:        # half the keys hit the table, half miss
        b["cols"]["vol"] = np.where(np.arange(B) % 2 == 0,
                                    b["cols"]["vol"] % C,
                                    C + b["cols"]["vol"]).astype(np.int64)
    tstate = query_state_from_numpy(tq, tree, "cpu")
    jstate = {k: jax.numpy.asarray(v) for k, v in tree.items()}
    _, tstate, rows = _run(jq, tq, jstate, tstate, batches,
                           carried_scale(tq, tstate))
    drops = int(tstate["window_drops"])
    assert drops > 0 and rows > 0
    assert int((tstate["hh_counts"] > 0).sum()) == C


@pytest.mark.parametrize("label", sorted(CARRIED))
def test_walk_from_a_carried_table_matches_reference(label):
    name, B = CARRIED[label]
    app = jparse(app_text(name))
    jq = JQuery(app.queries[0], app.stream_definitions["S"], B,
                **QUERIES[name][1])
    tq = compile_port(name, B, "cpu")
    wire = wire_for(name, B)
    batches = [wire.batch(step) for step in range(STEPS + 1)]
    jstate = jq.init_state()
    if label == "lossy_resumed":
        for batch in batches[:RESUME_AFTER]:
            jstate, _ = jq.step(jstate, batch)
        batches = batches[RESUME_AFTER:]
        tree = {k: np.asarray(v) for k, v in jax.device_get(jstate).items()}
        assert (tree["hh_counts"] > 0).sum() > 0
    else:
        tree = fill_carried(label, {k: np.array(v) for k, v in
                                    jax.device_get(jstate).items()})
        jstate = {k: jax.numpy.asarray(v) for k, v in tree.items()}
    tstate = query_state_from_numpy(tq, tree, "cpu")
    C = tq.window_n
    if label == "lossy_prune_empties":
        # the first event is dropped and its prune leaves no carried key
        jstate1, tstate1, _ = _run(jq, tq, jstate, tstate, batches[:1],
                                   carried_scale(tq, tstate))
        assert int(tstate1["window_drops"]) == 1
        occ = tstate1["hh_counts"] > 0
        assert not (tstate1["hh_keys"][occ] >= 10**6).any() and occ.any()
        _run(jq, tq, jstate1, tstate1, batches[1:], carried_scale(tq, tstate1))
        return
    _, tstate, rows = _run(jq, tq, jstate, tstate, batches,
                           carried_scale(tq, tstate))
    if label == "lossy_pinned_near_full":
        assert int(tstate["window_drops"]) > 0 and rows > 0
        assert int((tstate["hh_counts"] >= 1000).sum()) == C - 12
        assert int(tstate["hh_total"]) // 100 >= 3     # bucket changes
