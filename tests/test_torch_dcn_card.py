"""The lane split and the DCN shard tier on the card, held to the plain
versions on the CPU: ``PartitionedNFARuntime(devices=["cuda:0"] * n)``
(the blocked chain and the scan), two ``DCNWorker``s on loopback stepping
the blocked NFA, and a group snapshot of a CPU worker restored onto the
card. Port-only imports: it runs on the card's machine, where JAX is
missing (``python -m pytest tests/test_torch_dcn_card.py -m cuda``); every
case skips where no CUDA device is present (the kernels have no CPU mode).
"""

import socket

import numpy as np
import pytest
import torch

from siddhi_tpu_torch.gpu.dcn import DCNWorker, LaneTopology
from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
from siddhi_tpu_torch.gpu.state_io import state_leaves, state_to_numpy
from siddhi_tpu_torch.resilience.dcn_guard import LaneGroupSnapshotStore

CHAIN_APP = """
define stream S (dev string, v double);
partition with (dev of S)
begin
from every e1=S[v > 80.0] -> e2=S[v > e1.v] -> e3=S[v > e2.v] within 400
select e1.dev as d, e1.v as v1, e2.v as v2, e3.v as v3 insert into Alerts;
end;
"""

SCAN_APP = """
define stream S (dev string, v double);
partition with (dev of S)
begin
from every e1=S[v > 70.0] -> e2=S[v > e1.v]<2:3> -> e3=S[v < e1.v]
select e1.dev as d, e1.v as v1, e3.v as v3 insert into Alerts;
end;
"""

DCN_APP = """
define stream S (dev string, v double);
partition with (dev of S)
begin
from every e1=S[v > 50.0] -> e2=S[v > e1.v]
select e1.v as v1, e2.v as v2 insert into Alerts;
end;
"""


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _events(n: int, seed: int, keys: int = 40):
    rng = np.random.default_rng(seed)
    dev = np.array([f"dev{k}" for k in range(keys)])[
        rng.integers(0, keys, n)]
    return dev, np.round(rng.uniform(0.0, 100.0, n), 2), \
        1000 + np.arange(n, dtype=np.int64)


def _run_split(app: str, ev, **kw):
    rt = PartitionedNFARuntime(app, num_partitions=8, key_attr="dev",
                               slot_capacity=8, lane_batch=64, **kw)
    dev, v, ts = ev
    rows = []
    for lo in range(0, len(ts), 301):
        sl = slice(lo, lo + 301)
        rows += rt.send_many("S", {"dev": dev[sl], "v": v[sl]}, ts[sl],
                             decode=True)
    rows += rt.flush(decode=True)
    rt.block_until_ready()
    return rt, rows


def _same_tree(ref, got, at=""):
    assert ref.keys() == got.keys(), at
    for k in ref:
        if isinstance(ref[k], dict):
            _same_tree(ref[k], got[k], f"{at}{k}.")
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=at + k)


def _same_leaves(ref: list, got: list):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)


def _port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.cuda
@pytest.mark.parametrize("app", [CHAIN_APP, SCAN_APP], ids=["chain", "scan"])
def test_split_on_the_card_equals_the_plain_version(app):
    _card()
    ev = _events(4000, seed=3)
    ref, ref_rows = _run_split(app, ev, device="cpu")
    assert ref_rows
    for n in (1, 2, 4):
        rt, rows = _run_split(app, ev, devices=["cuda:0"] * n)
        assert rows == ref_rows
        _same_tree(state_to_numpy(ref.state), state_to_numpy(rt.state))


def _pair(device: str, events, rows):
    p0, p1 = _port(), _port()
    w1 = DCNWorker(1, LaneTopology(16, 2), DCN_APP, "dev", port=p1,
                   peers={0: ("127.0.0.1", p0)}, on_rows=rows[1].extend,
                   device=device)
    w0 = DCNWorker(0, LaneTopology(16, 2), DCN_APP, "dev", port=p0,
                   peers={1: ("127.0.0.1", p1)}, on_rows=rows[0].extend,
                   device=device)
    try:
        for i in range(0, len(events[2]), 250):
            w0.ingest([[str(d), float(x)] for d, x in
                       zip(events[0][i:i + 250], events[1][i:i + 250])],
                      [int(t) for t in events[2][i:i + 250]])
        w0.flush()
        w1.flush()
        return [state_leaves(w.rt.state) for w in (w0, w1)]
    finally:
        w0.close()
        w1.close()


@pytest.mark.cuda
def test_workers_on_the_card_equal_the_plain_version():
    _card()
    ev = _events(3000, seed=4)
    plain_rows, card_rows = ([], []), ([], [])
    plain = _pair("cpu", ev, plain_rows)
    card = _pair("cuda", ev, card_rows)
    assert card_rows == plain_rows and plain_rows[0] and plain_rows[1]
    for a, b in zip(plain, card):
        _same_leaves(a, b)


@pytest.mark.cuda
def test_cpu_group_snapshot_restores_onto_the_card(tmp_path):
    _card()
    dev, v, ts = _events(1600, seed=5)
    rows = [[str(d), float(x)] for d, x in zip(dev, v)]
    tss = [int(t) for t in ts]
    store = LaneGroupSnapshotStore(str(tmp_path))
    out = {}
    saver = DCNWorker(0, LaneTopology(8, 1), DCN_APP, "dev", port=0,
                      peers={}, snapshot_store=store, device="cpu")
    try:
        saver.ingest(rows[:1000], tss[:1000])
        saver.snapshot()
        got = []
        loader = DCNWorker(0, LaneTopology(8, 1), DCN_APP, "dev", port=0,
                           peers={}, snapshot_store=store, restore=True,
                           on_rows=got.extend, device="cuda")
        try:
            assert loader.rt.state["matches"].device.type == "cuda"
            _same_leaves(state_leaves(saver.rt.state),
                         state_leaves(loader.rt.state))
            saver.on_rows = None
            ref = []
            saver.rt.callback = ref.extend
            for w in (saver, loader):
                w.ingest(rows[1000:], tss[1000:])
                w.flush()
            out = (ref, got)
            _same_leaves(state_leaves(saver.rt.state),
                         state_leaves(loader.rt.state))
        finally:
            loader.close()
    finally:
        saver.close()
    assert out[0] == out[1] and out[0]
