"""The port's DCN shard tier (``gpu/dcn.py``, ``resilience/dcn_guard.py``)
against the JAX package's.

- ``LaneTopology`` places 10,000 keys exactly as the reference's does;
- a port worker in a spawned child process serves host 1 while host 0
  routes every event (the counterpart of the reference's
  ``test_dcn::test_two_process_dcn_ingest_routing``), and a port child
  SIGKILLed mid-ingest and restarted loses and duplicates nothing (the
  counterpart of ``test_dcn_resilience::test_kill_peer_soak_exactly_once``):
  both held to the port's host interpreter;
- a lane-group snapshot saved by the reference's ``DCNWorker`` restores in
  the port's, and the reverse: leaves, dictionaries and dedup tables equal,
  and the next 200 events give equal rows and state;
- ``scripts/check_socket_timeouts.py``'s ``check_file``, loaded as data,
  finds nothing in the port's DCN modules;
Every worker here runs with ``device="cpu"``;
``tests/test_torch_dcn_card.py`` holds workers on the card to these.
"""

import importlib.util
import os
import socket
import struct
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from siddhi_tpu.resilience.dcn_guard import \
    LaneGroupSnapshotStore as RefStore
from siddhi_tpu.tpu.dcn import DCNWorker as RefWorker
from siddhi_tpu.tpu.dcn import LaneTopology as RefTopology
from siddhi_tpu_torch import SiddhiManager, StreamCallback
from siddhi_tpu_torch.gpu.dcn import (
    K_FLUSH,
    K_FLUSHED,
    DCNIngestClient,
    DCNWorker,
    LaneTopology,
    recv_msg,
    send_msg,
)
from siddhi_tpu_torch.gpu.state_io import state_leaves
from siddhi_tpu_torch.resilience.dcn_guard import (
    PEER_HEALTHY,
    DCNGuardConfig,
    LaneGroupSnapshotStore,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

APP = """
define stream S (dev string, v double);
partition with (dev of S)
begin
from every e1=S[v > 50.0] -> e2=S[v > e1.v]
select e1.v as v1, e2.v as v2 insert into Alerts;
end;
"""


def _events(n=600, keys=12, seed=21):
    rng = np.random.default_rng(seed)
    return [([f"dev{int(rng.integers(keys))}",
              round(float(rng.uniform(0.0, 100.0)), 2)], 1000 + i)
            for i in range(n)]


def _oracle(events) -> int:
    """The port's host interpreter over the same events."""
    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(APP, playback=True)
    host = []
    rt.add_callback("Alerts", StreamCallback(lambda evs: host.extend(evs)))
    rt.start()
    ih = rt.input_handler("S")
    for row, ts in events:
        ih.send(list(row), timestamp=ts)
    m.shutdown()
    return len(host)


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _flush_peer(port: int) -> int:
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        send_msg(s, K_FLUSH)
        reply = recv_msg(s, timeout=60)
        assert reply and reply[0] == K_FLUSHED
        return struct.unpack(">q", reply[1])[0]
    finally:
        s.close()


# -- topology -----------------------------------------------------------------
@pytest.mark.parametrize("lanes,hosts", [(8, 2), (64, 2), (64, 4), (255, 5)])
def test_lane_topology_equals_the_reference(lanes, hosts):
    ref, port = RefTopology(lanes, hosts), LaneTopology(lanes, hosts)
    rng = np.random.default_rng(lanes + hosts)
    keys = [f"dev{k}" for k in range(5000)] + \
        [int(x) for x in rng.integers(-2**40, 2**40, 4000)] + \
        [float(x) for x in rng.normal(0, 1e6, 995)] + \
        [None, True, False, "", "é"]
    assert len(keys) == 10_000
    for k in keys:
        lane = port.lane_of(k)
        assert lane == ref.lane_of(k)
        assert port.group_of(lane) == ref.group_of(lane)
        assert port.host_of(k) == ref.host_of(k)
        assert port.local_lane(lane) == ref.local_lane(lane)
    for g in range(hosts):
        assert port.lanes_of_group(g) == ref.lanes_of_group(g)
    with pytest.raises(ValueError):
        LaneTopology(9, 2)


# -- two processes ------------------------------------------------------------
CHILD = """
import sys, os, time
sys.path.insert(0, {repo!r})
from siddhi_tpu_torch.gpu.dcn import DCNWorker, LaneTopology
from siddhi_tpu_torch.resilience.dcn_guard import LaneGroupSnapshotStore
store = {store!r}
w = DCNWorker(1, LaneTopology(8, 2), {app!r}, "dev", port={port},
              peers={{0: ("127.0.0.1", {parent_port})}}, device="cpu",
              epoch={epoch},
              snapshot_store=LaneGroupSnapshotStore(store) if store else None,
              restore={restore}, snapshot_every_frames=1 if store else None)
open({ready!r} + ".tmp", "w").write(str(w.port))
os.replace({ready!r} + ".tmp", {ready!r})
w._stop.wait(timeout=300)
"""


def _spawn_child(tmp_path, tag: str, port: int = 0, parent_port: int = 0,
                 store: str = "", epoch: int = 0, restore: bool = False):
    """A port DCN worker as host 1 in a child process (it imports only the
    port); returns (process, its port)."""
    ready = str(tmp_path / f"{tag}.port")
    src = CHILD.format(repo=REPO, store=store, app=APP, port=port,
                       parent_port=parent_port, epoch=epoch,
                       restore=restore, ready=ready)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", src], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=open(str(tmp_path / f"{tag}.err"), "w"))
    deadline = time.monotonic() + 120
    while not os.path.exists(ready):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            raise AssertionError(
                f"child worker never came up: "
                f"{open(str(tmp_path / f'{tag}.err')).read()[-2000:]}")
        time.sleep(0.05)
    return proc, int(open(ready).read())


def _stop(proc) -> None:
    if proc is not None and proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def test_two_process_dcn_ingest_routing(tmp_path):
    proc, child_port = _spawn_child(tmp_path, "h1")
    w0 = None
    try:
        w0 = DCNWorker(0, LaneTopology(8, 2), APP, "dev", port=0,
                       peers={1: ("127.0.0.1", child_port)}, device="cpu")
        events = _events()
        # everything enters at host 0; peer-owned rows cross the socket
        w0.ingest([r for r, _ in events], [t for _, t in events])
        w0.flush()
        assert w0.forwarded > 0, "no cross-host traffic"
        peer_matches = _flush_peer(child_port)
        total = w0.match_count + peer_matches
        assert total == _oracle(events), (w0.match_count, peer_matches)
        assert peer_matches > 0 and w0.match_count > 0
    finally:
        if w0 is not None:
            w0.close()
        _stop(proc)


def test_kill_peer_soak_exactly_once(tmp_path):
    """Host 1 SIGKILLed mid-ingest: frames spill; restarted from its
    snapshots with a higher epoch, it takes the backlog in order. Totals
    equal the interpreter's: nothing lost, nothing twice."""
    store_dir = str(tmp_path / "snaps")
    os.makedirs(store_dir)
    p0, p1 = _free_port(), _free_port()
    proc, _ = _spawn_child(tmp_path, "a", p1, p0, store_dir, 0, False)
    proc2 = w0 = None
    try:
        cfg = DCNGuardConfig(retry_max=2, retry_base_s=0.01,
                             retry_cap_s=0.05, failure_threshold=2,
                             down_cooldown_s=0.05, probe_timeout_s=2.0,
                             spill_capacity_frames=1024)
        w0 = DCNWorker(0, LaneTopology(8, 2), APP, "dev", port=p0,
                       peers={1: ("127.0.0.1", p1)}, guard_config=cfg,
                       io_timeout_s=5.0, connect_timeout_s=2.0,
                       device="cpu")
        events = _events(400, seed=29)
        chunks = [events[i:i + 40] for i in range(0, len(events), 40)]
        for i, chunk in enumerate(chunks):
            if i == 4:
                proc.kill()                       # SIGKILL mid-ingest
                proc.wait(timeout=30)
            w0.ingest([r for r, _ in chunk], [t for _, t in chunk])
        q = w0.guard.spill(1)
        assert q.spilled_frames > 0, "the kill never produced a spill"
        proc2, _ = _spawn_child(tmp_path, "b", p1, p0, store_dir, 1, True)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            w0.guard.heartbeat_once()
            if w0.guard.peer_state(1) == PEER_HEALTHY and q.empty:
                break
            time.sleep(0.1)
        assert q.empty, "spill backlog never drained after restart"
        w0.flush()
        total = w0.match_count + _flush_peer(p1)
        assert total == _oracle(events), (
            total, q.spilled_frames, q.replayed_frames)
    finally:
        if w0 is not None:
            w0.close()
        _stop(proc)
        _stop(proc2)


# -- snapshots across the packages --------------------------------------------
def _ref_leaves(state) -> list:
    return [np.asarray(x) for x in
            jax.tree_util.tree_leaves(jax.device_get(state))]


def _fed(worker, events: list) -> None:
    """Half the events through a ``DCNIngestClient`` (sender 255: a dedup
    mark), the rest through ``ingest``."""
    client = DCNIngestClient(worker.port, "sd", group=0)
    try:
        half = len(events) // 2
        for i in range(0, half, 50):
            chunk = events[i:i + 50]
            client.send([r for r, _ in chunk], [t for _, t in chunk])
    finally:
        client.close()
    rest = events[half:]
    worker.ingest([r for r, _ in rest], [t for _, t in rest])


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_group_snapshot_crosses_the_packages(tmp_path, direction):
    events = _events(800, keys=40, seed=7)
    head, tail = events[:600], events[600:]
    topo = dict(peers={}, slot_capacity=16, lane_batch=64)
    saver_cls, loader_cls = (RefWorker, DCNWorker) \
        if direction == "reference_to_port" else (DCNWorker, RefWorker)
    store_cls = {RefWorker: RefStore, DCNWorker: LaneGroupSnapshotStore}
    kw = {RefWorker: {}, DCNWorker: {"device": "cpu"}}
    topo_cls = {RefWorker: RefTopology, DCNWorker: LaneTopology}
    root = str(tmp_path / "snaps")

    def worker(cls, rows, restore=False):
        return cls(0, topo_cls[cls](8, 1), APP, "dev", port=0,
                   on_rows=rows.extend,
                   snapshot_store=store_cls[cls](root), restore=restore,
                   **topo, **kw[cls])

    saved_rows, loaded_rows = [], []
    saver = worker(saver_cls, saved_rows)
    loader = None
    try:
        _fed(saver, head)
        revs = saver.snapshot()
        assert revs == {0: 0}
        loader = worker(loader_cls, loaded_rows, restore=True)
        leaves = {RefWorker: lambda w: _ref_leaves(w.rt.state),
                  DCNWorker: lambda w: state_leaves(w.rt.state)}
        a, b = leaves[saver_cls](saver), leaves[loader_cls](loader)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        assert saver.rt.compiler.merged.snapshot_dictionaries() == \
            loader.rt.compiler.merged.snapshot_dictionaries()
        assert saver._dedup == loader._dedup and saver._dedup[0][255][1] > 0
        n_saved = len(saved_rows)
        for w in (saver, loader):
            w.ingest([r for r, _ in tail], [t for _, t in tail])
            w.flush()
        assert saved_rows[n_saved:] == loaded_rows
        assert len(loaded_rows) > 0
        a, b = leaves[saver_cls](saver), leaves[loader_cls](loader)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert saver.match_count == loader.match_count
    finally:
        saver.close()
        if loader is not None:
            loader.close()


def test_snapshot_leaf_order_is_the_reference_flatten_order():
    """``state_leaves`` walks a state exactly as ``jax.tree_util`` does
    (keys sorted, nested dicts depth first), ``t10`` before ``t2``."""
    from siddhi_tpu_torch.gpu.state_io import state_from_leaves
    tree = {"tables": {f"t{s}": {"valid": torch.full((2, 3), s > 5),
                                 "first_ts": torch.full((2, 3), s),
                                 "b": torch.full((2, 3), float(s))}
                       for s in range(1, 12)},
            "matches": torch.arange(2), "drops": torch.zeros(2)}
    ref = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), tree))
    got = state_leaves(tree)
    assert len(ref) == len(got)
    for x, y in zip(ref, got):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    back = state_from_leaves(tree, got, "cpu")
    assert list(back) == list(tree)
    assert list(back["tables"]) == list(tree["tables"])
    assert all(torch.equal(back["tables"][k][f], tree["tables"][k][f])
               for k in tree["tables"] for f in tree["tables"][k])
    with pytest.raises(ValueError, match="leaves"):
        state_from_leaves(tree, got[:-1], "cpu")
    bad = list(got)
    bad[0] = bad[0].astype(np.int32)
    with pytest.raises(ValueError, match="expected"):
        state_from_leaves(tree, bad, "cpu")


# -- the wiring that reaches the worker ---------------------------------------
def test_transit_metrics_and_chaos_reach_the_port_worker():
    """A sampled ingest's context rides the frame into host 1's ``dcn``
    hop span and its ``dcn.self.transit`` histogram (the ``dcn_transit``
    phase); ``register_metrics`` renders the ``siddhi_tpu_dcn_*`` families
    through the port's Prometheus exposition; the chaos sites of the send
    and the serve path count on the port's injector."""
    from siddhi_tpu_torch.core.metrics import StatisticsManager
    from siddhi_tpu_torch.observability.prometheus import render
    from siddhi_tpu_torch.observability.tracing import PipelineTracer
    from siddhi_tpu_torch.resilience.chaos import ChaosInjector
    p0, p1 = _free_port(), _free_port()
    tr0, tr1 = PipelineTracer(sample_n=1), PipelineTracer(sample_n=1)
    chaos = ChaosInjector(seed=3, dcn_drop_p=0.3)
    sm = StatisticsManager("DcnApp")
    w1 = DCNWorker(1, LaneTopology(8, 2), APP, "dev", port=p1,
                   peers={0: ("127.0.0.1", p0)}, tracer=tr1, device="cpu")
    w0 = DCNWorker(0, LaneTopology(8, 2), APP, "dev", port=p0,
                   peers={1: ("127.0.0.1", p1)}, tracer=tr0, chaos=chaos,
                   guard_config=DCNGuardConfig(retry_max=20,
                                               retry_base_s=0.001,
                                               retry_cap_s=0.005,
                                               failure_threshold=100),
                   device="cpu")
    try:
        w1.register_metrics(sm)
        events = _events(300, seed=9)
        for i in range(0, len(events), 20):
            chunk = events[i:i + 20]
            w0.ingest([r for r, _ in chunk], [t for _, t in chunk])
        assert chaos.counters["dcn_drops"] > 0 and w1.dup_frames > 0
        assert w1._transit_tracker.count > 0
        hops = [s for t in tr1.export() for s in t["spans"]
                if s["stage"] == "dcn"]
        assert hops and all(s["phase"] == "dcn_transit" for s in hops)
        text = render([sm])
        assert 'siddhi_tpu_dcn_peer_state{app="DcnApp",peer="0"}' in text
        assert "siddhi_tpu_dcn_received_rows_total" in text
        w0.flush()
        w1.flush()
        assert w0.match_count + w1.match_count == _oracle(events)
    finally:
        w0.close()
        w1.close()
    assert "siddhi_tpu_dcn_" not in render([sm])


# -- lint ---------------------------------------------------------------------
def test_socket_timeout_lint_finds_nothing_in_the_port():
    spec = importlib.util.spec_from_file_location(
        "check_socket_timeouts",
        os.path.join(REPO, "scripts", "check_socket_timeouts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for rel in ("gpu/dcn.py", "resilience/dcn_guard.py"):
        path = os.path.join(REPO, "siddhi_tpu_torch", rel)
        assert mod.check_file(path) == [], rel


def test_worker_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DCNWorker(0, LaneTopology(8, 1), APP, "dev", port=0, peers={})

