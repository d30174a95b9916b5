"""Snapshots of the port's NFA runtime against the JAX package's.

``MergedBatchBuilder.snapshot``/``restore`` hold the staged rows of a
batch; ``DeviceNFARuntime.snapshot_state``/``restore_state`` hold the
device state and its string dictionary in the JAX package's shape (numpy
leaves, ``[C]`` tables, scalar counters). A JAX ``DeviceNFARuntime``
stopped mid-stream, with rows staged in its builder, resumes in the port
(plain version on the CPU) and gives the reference's rows, counters and
final state; the port resumes from its own snapshot just as well.
"""

import jax
import numpy as np
import pytest

from siddhi_tpu.tpu.nfa import DeviceNFARuntime as JRuntime
from siddhi_tpu.tpu.nfa import MergedBatchBuilder as JBuilder
from siddhi_tpu_torch.gpu.nfa import DeviceNFARuntime as TRuntime
from siddhi_tpu_torch.gpu.nfa import MergedBatchBuilder as TBuilder
from siddhi_tpu_torch.gpu.state_io import state_to_numpy

APPS = {
    "blocked": """
define stream S (dev string, v double);
from every e1=S[v > 60.0] -> e2=S[v > e1.v and dev == e1.dev]
  -> e3=S[v > e2.v] within 400
select e1.dev as d, e1.v as a, e2.v as b, e3.v as c insert into Alerts;
""",
    "scan": """
define stream Temp (dev string, v double);
define stream Reg (dev string, action string);
from every e1=Temp[v > 80.0] -> e2=Temp[v > e1.v] and e3=Reg[action == 'on']
  -> e4=Temp[v > e2.v]<1:3> -> e5=Temp[v < e1.v] within 2000
select e1.dev as dev, e1.v as v1, e3.action as a, e5.v as v5 insert into Alerts;
""",
}
SLOTS, BATCH = 16, 64


def _events(name: str, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dev = f"d{rng.integers(0, 5)}"
        v = float(np.round(rng.uniform(0, 100), 2))
        if name == "scan" and rng.random() < 0.2:
            out.append(("Reg", [dev, "on" if rng.random() < 0.5 else "off"],
                        1000 + 7 * i))
        else:
            out.append(("Temp" if name == "scan" else "S", [dev, v],
                        1000 + 7 * i))
    return out


def _runtime(cls, name, **kw):
    rt = cls(APPS[name], slot_capacity=SLOTS, batch_capacity=BATCH, **kw)
    rows = []
    rt.add_callback(rows.extend)
    return rt, rows


def _feed(rt, events) -> None:
    for sid, row, ts in events:
        rt.send(sid, row, ts)


def _jax_tree(rt) -> dict:
    return jax.tree_util.tree_map(np.asarray, jax.device_get(rt.state))


def _assert_same_tree(a: dict, b: dict, at: str = "") -> None:
    assert a.keys() == b.keys(), at
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_tree(a[k], b[k], f"{at}{k}.")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, f"{at}{k}"
            np.testing.assert_array_equal(y, x, err_msg=f"{at}{k}")


def test_builder_snapshot_restore_equals_the_reference():
    jrt, _ = _runtime(JRuntime, "scan")
    trt, _ = _runtime(TRuntime, "scan", device="cpu")
    builders = []
    for rt, cls in ((jrt, JBuilder), (trt, TBuilder)):
        b = cls(rt.compiler.merged, BATCH, rt.builder.stream_defs,
                used_cols=rt.compiler.used_cols)
        _feed_builder(b, _events("scan", 23, 4))
        builders.append((cls, rt, b))
    snaps = [b.snapshot() for _, _, b in builders]
    assert snaps[0]["n"] == snaps[1]["n"] == 23
    assert snaps[0]["cols"].keys() == snaps[1]["cols"].keys()
    for k in ("tag", "ts"):
        assert snaps[0][k].tobytes() == snaps[1][k].tobytes()
    for k in snaps[0]["cols"]:
        assert snaps[0]["cols"][k].tobytes() == snaps[1]["cols"][k].tobytes()
    emits = []
    for (cls, rt, _), snap in zip(builders, snaps):
        fresh = cls(rt.compiler.merged, BATCH, rt.builder.stream_defs,
                    used_cols=rt.compiler.used_cols)
        fresh.restore(snap)
        assert len(fresh) == 23 and fresh._pack_t0 is not None
        _feed_builder(fresh, _events("scan", 5, 9))
        emits.append(fresh.emit())
    a, b = emits
    assert a["count"] == b["count"] == 28
    assert int(a["ts_base"]) == int(b["ts_base"])
    for k in ("tag", "ts"):
        assert a[k].tobytes() == b[k].tobytes()
    for k in a["cols"]:
        assert a["cols"][k].tobytes() == b["cols"][k].tobytes()


def _feed_builder(b, events) -> None:
    for sid, row, ts in events:
        b.append(sid, row, ts)


@pytest.mark.parametrize("name", sorted(APPS))
def test_jax_snapshot_resumes_in_the_port(name):
    events = _events(name, 1500, 21)
    cut = 700 + BATCH // 3                    # rows staged in the builder
    jrt, jrows = _runtime(JRuntime, name)
    _feed(jrt, events[:cut])
    snap, bsnap = jrt.snapshot_state(), jrt.builder.snapshot()
    assert bsnap["n"] == cut % BATCH
    trt, trows = _runtime(TRuntime, name, device="cpu")
    assert trt.compiler.blocked == (name == "blocked")
    trt.restore_state(snap)
    trt.builder.restore(bsnap)
    before = len(jrows)
    for rt in (jrt, trt):
        _feed(rt, events[cut:])
        rt.flush()
    assert trows == jrows[before:]
    assert len(jrows) > before > 0
    assert trt.match_count == jrt.match_count
    assert trt.drop_count == jrt.drop_count
    _assert_same_tree(_jax_tree(jrt), state_to_numpy(trt.state,
                                                     single_lane=True))
    # the resumed runtime decodes strings through the restored dictionary
    assert trt.compiler.merged.snapshot_dictionaries() == \
        jrt.compiler.merged.snapshot_dictionaries()


@pytest.mark.parametrize("name", sorted(APPS))
def test_port_snapshot_round_trip(name):
    events = _events(name, 1200, 33)
    cut = 500 + BATCH // 2
    whole, wrows = _runtime(TRuntime, name, device="cpu")
    _feed(whole, events)
    whole.flush()
    first, rows = _runtime(TRuntime, name, device="cpu")
    _feed(first, events[:cut])
    snap, bsnap = first.snapshot_state(), first.builder.snapshot()
    # the JAX package's shape: [C] tables and scalar counters
    assert np.asarray(snap["device"]["matches"]).shape == ()
    second, rows2 = _runtime(TRuntime, name, device="cpu")
    second.restore_state(snap)
    second.builder.restore(bsnap)
    _feed(second, events[cut:])
    second.flush()
    assert rows + rows2 == wrows and wrows
    assert (second.match_count, second.drop_count) == \
        (whole.match_count, whole.drop_count)
    _assert_same_tree(state_to_numpy(whole.state), state_to_numpy(second.state))


def test_restore_state_refuses_a_tree_of_another_shape():
    trt, _ = _runtime(TRuntime, "blocked", device="cpu")
    snap = trt.snapshot_state()
    del snap["device"]["drops"]
    with pytest.raises(ValueError, match="drops"):
        trt.restore_state(snap)
    snap = trt.snapshot_state()
    snap["device"]["tables"]["t1"]["first_ts"] = np.zeros(SLOTS + 1, np.int64)
    with pytest.raises(ValueError, match="first_ts"):
        trt.restore_state(snap)
