"""The port's lane split over several devices against one device and the
JAX package's ``PartitionedNFARuntime``.

``PartitionedNFARuntime(devices=[...])`` splits the lanes into contiguous
equal ranges, one a device, each stepped on its own state. Here every device
is the CPU (``["cpu"] * n``, the plain versions), so the split runs its
ranges one after the other: state leaves (the ranges concatenated along the
lane axis), counters and rows in order must equal one device's, bitwise,
and both must equal the reference's runtime with no mesh and with a mesh of
``n`` of the test run's virtual devices. Lanes not divisible by the device
count are refused at construction, as the reference refuses them.
``dryrun_multichip`` splits its lanes the same way. On the card
``tests/test_torch_dcn_card.py`` holds the split to the plain version.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from siddhi_tpu.tpu.partition import PartitionedNFARuntime as RefRuntime
from siddhi_tpu_torch import entry as tentry
from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
from siddhi_tpu_torch.gpu.state_io import state_from_numpy, state_to_numpy

CHAIN_APP = """
define stream S (dev string, v double);
partition with (dev of S)
begin
from every e1=S[v > 80.0] -> e2=S[v > e1.v] -> e3=S[v > e2.v] within 400
select e1.dev as d, e1.v as v1, e2.v as v2, e3.v as v3 insert into Alerts;
end;
"""

# not blocked: a count state takes the per-event scan (B4)
SCAN_APP = """
define stream S (dev string, v double);
partition with (dev of S)
begin
from every e1=S[v > 70.0] -> e2=S[v > e1.v]<2:3> -> e3=S[v < e1.v]
select e1.dev as d, e1.v as v1, e3.v as v3 insert into Alerts;
end;
"""

LANES = 8
WIDTHS = dict(num_partitions=LANES, key_attr="dev", slot_capacity=8,
              lane_batch=32)


def events(n: int, seed: int, keys: int = 24):
    rng = np.random.default_rng(seed)
    dev = np.array([f"dev{k}" for k in range(keys)])[
        rng.integers(0, keys, n)]
    v = np.round(rng.uniform(0.0, 100.0, n), 2)
    return dev, v, 1000 + np.arange(n, dtype=np.int64)


def run_port(app: str, ev, chunk: int = 97, **kw):
    rt = PartitionedNFARuntime(app, **WIDTHS, **kw)
    dev, v, ts = ev
    rows = []
    for lo in range(0, len(ts), chunk):
        sl = slice(lo, lo + chunk)
        rows.extend(rt.send_many("S", {"dev": dev[sl], "v": v[sl]}, ts[sl],
                                 decode=True))
    rows.extend(rt.flush(decode=True))
    return rt, rows


def run_ref(app: str, ev, chunk: int = 97, mesh=None):
    rt = RefRuntime(app, **WIDTHS, mesh=mesh)
    dev, v, ts = ev
    rows = []
    for lo in range(0, len(ts), chunk):
        sl = slice(lo, lo + chunk)
        rows.extend(rt.send_many("S", {"dev": dev[sl], "v": v[sl]}, ts[sl],
                                 decode=True))
    rows.extend(rt.flush(decode=True))
    return rt, rows


def same_tree(ref, got, at=""):
    assert ref.keys() == got.keys(), at
    for k in ref:
        if isinstance(ref[k], dict):
            same_tree(ref[k], got[k], f"{at}{k}.")
        else:
            a, b = np.asarray(ref[k]), np.asarray(got[k])
            assert a.dtype == b.dtype and a.shape == b.shape, f"{at}{k}"
            np.testing.assert_array_equal(b, a, err_msg=f"{at}{k}")


def ref_state(rt) -> dict:
    return jax.tree_util.tree_map(np.asarray, jax.device_get(rt.state))


@pytest.mark.parametrize("app", [CHAIN_APP, SCAN_APP], ids=["chain", "scan"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_split_equals_one_device_and_the_reference(app, n):
    ev = events(1500, seed=20 + n)
    one, one_rows = run_port(app, ev, device="cpu")
    split, rows = run_port(app, ev, devices=["cpu"] * n)
    assert split.compiler.blocked == (app is CHAIN_APP)
    assert split.ranges == [(i * LANES // n, (i + 1) * LANES // n)
                            for i in range(n)]
    assert rows == one_rows and len(rows) > 0
    same_tree(state_to_numpy(one.state), state_to_numpy(split.state))
    assert split.match_count == one.match_count == len(rows)
    assert split.drop_count == one.drop_count
    ref, ref_rows = run_ref(app, ev)
    assert ref_rows == rows
    same_tree(ref_state(ref), state_to_numpy(split.state))
    # the reference's own split: a mesh of n of the virtual devices
    mesh = Mesh(np.array(jax.devices()[:n]), ("p",))
    mref, mrows = run_ref(app, ev, mesh=mesh)
    assert mrows == rows
    same_tree(ref_state(mref), state_to_numpy(split.state))


def test_split_per_event_send_and_callback():
    ev = events(600, seed=5)
    dev, v, ts = ev
    got = {}
    for n in (1, 2):
        rt = PartitionedNFARuntime(CHAIN_APP, **WIDTHS, devices=["cpu"] * n)
        rows = []
        rt.callback = rows.extend
        for d, x, t in zip(dev, v, ts):
            rt.send("S", [str(d), float(x)], int(t))
        rt.flush()
        got[n] = (rows, state_to_numpy(rt.state))
    assert got[1][0] == got[2][0] and got[1][0]
    same_tree(got[1][1], got[2][1])


def test_split_state_setter_places_each_range():
    """A [P, ...] state set on a split runtime lands range by range on its
    devices; stepping on from it equals one device stepping on from it."""
    ev = events(1200, seed=8)
    half = tuple(a[:600] for a in ev)
    rest = tuple(a[600:] for a in ev)
    src, _ = run_port(CHAIN_APP, half, device="cpu")
    snap = state_to_numpy(src.state)
    out = []
    for kw in (dict(device="cpu"), dict(devices=["cpu"] * 4)):
        rt = PartitionedNFARuntime(CHAIN_APP, **WIDTHS, **kw)
        rt.compiler.merged.restore_dictionaries(
            src.compiler.merged.snapshot_dictionaries())
        rt.state = state_from_numpy(snap, "cpu")
        dev, v, ts = rest
        rows = rt.send_many("S", {"dev": dev, "v": v}, ts, decode=True)
        rows += rt.flush(decode=True)
        out.append((rows, state_to_numpy(rt.state)))
    assert out[0][0] == out[1][0]
    same_tree(out[0][1], out[1][1])
    same_tree(snap, state_to_numpy(src.state))


@pytest.mark.parametrize("lanes,n", [(8, 3), (6, 4), (3, 2)])
def test_lanes_not_divisible_by_the_devices_are_refused(lanes, n):
    kw = dict(WIDTHS, num_partitions=lanes)
    with pytest.raises(ValueError, match="divisible by"):
        RefRuntime(CHAIN_APP, **kw,
                   mesh=Mesh(np.array(jax.devices()[:n]), ("p",)))
    with pytest.raises(ValueError, match="divisible by"):
        PartitionedNFARuntime(CHAIN_APP, **kw, devices=["cpu"] * n)


def test_device_and_devices_together_are_refused():
    with pytest.raises(ValueError, match="not both"):
        PartitionedNFARuntime(CHAIN_APP, **WIDTHS, device="cpu",
                              devices=["cpu", "cpu"])


def test_native_ingress_over_the_split():
    from siddhi_tpu_torch.native import native_available
    if not native_available():
        pytest.skip("no g++: the native ingress cannot build here")
    dev, v, ts = events(1500, seed=11)
    csv = "".join(f"{d},{x},{t}\n" for d, x, t in zip(dev, v, ts)).encode()
    out = []
    for kw in (dict(device="cpu"), dict(devices=["cpu"] * 2)):
        rt = PartitionedNFARuntime(CHAIN_APP, **WIDTHS, **kw)
        rt.enable_native_ingress()
        rows = rt.ingest_csv(csv, ts_last=True, decode=True)
        rows += rt.flush_native(decode=True)
        out.append((rows, state_to_numpy(rt.state)))
    assert out[0][0] == out[1][0] and out[0][0]
    same_tree(out[0][1], out[1][1])


def test_dryrun_multichip_splits_its_lanes():
    out = tentry.dryrun_multichip(2, devices=["cpu"] * 2)
    assert out["matches"] == out["expected"] == 4 == len(out["rows"])
    assert out["devices"] == ["cpu", "cpu"]
    four = tentry.dryrun_multichip(4, devices=["cpu"] * 4)
    assert four["matches"] == four["expected"] == 8 == len(four["rows"])

