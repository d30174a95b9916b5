"""The port's durable flow control against the JAX package's.

- WAL byte parity: the same events and stream definitions give segment files
  byte-identical to the reference's (names and bytes, rotation included),
  through ``WriteAheadLog`` alone and through the engine; either package
  reopens the other's log (torn tail included) and replays the same records.
- Cross-package recovery: a revision persisted by the reference's engine,
  plus the WAL it wrote after it, recovers in the port (``recover``) to
  rows equal to the reference's straight run.
- Kill-and-replay exactly-once with a ``@device`` chain on the CPU, cut at
  multiples of the chain's batch: the crashed-and-recovered run, stitched,
  equals the straight run and the reference's.
- The backpressure policies: ``CreditGate`` fed the same admit/release
  sequence keeps the reference's stats, and through the engine a stalled
  ``@async`` consumer sheds, drops and blocks as the reference's does.
- ``AdaptiveBatchController`` fed the same ``observe(n, latency,
  arrival_evps=...)`` sequence from a numpy seed reaches the reference's
  thresholds after every call, in both modes; in the engine its latency
  mode deadline-flushes a partial batch in the async driver. The adaptive
  runs' rows are held to the reference's static run, and in throughput
  mode to the reference's adaptive run too.

Every comparison is exact except the adaptive runs' grouped float32 sums:
where batches fall changes how they round (a CPU run shows it), so they are
held to ``test_torch_query_shapes.py``'s limits (``assert_rows_close`` under
the larger of the port runs' ``next_scale``: the static run's, which
batches as the reference's static run does, and the adaptive run's); their
counts and keys are exact.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.flow import adaptive_batch as ref_adaptive
from siddhi_tpu.flow import backpressure as ref_bp
from siddhi_tpu.flow import wal as ref_wal
from siddhi_tpu_torch.flow import adaptive_batch as port_adaptive
from siddhi_tpu_torch.flow import backpressure as port_bp
from siddhi_tpu_torch.flow import wal as port_wal

from test_torch_query_shapes import Scale
from test_torch_runtime import _Fed, assert_rows_close

PKGS = {"ref": siddhi_tpu, "port": siddhi_tpu_torch}


def manager(side: str, store_dir=None):
    m = siddhi_tpu_torch.SiddhiManager(device="cpu") if side == "port" \
        else siddhi_tpu.SiddhiManager()
    if store_dir is not None:
        m.set_persistence_store(
            PKGS[side].core.FileSystemPersistenceStore(str(store_dir)))
    return m


def tree(root) -> dict:
    """``{relative path: bytes}`` of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# ----------------------------------------------------------- WAL parity

def wal_rows(seed: int, n: int) -> list:
    """Rows of every wire type (``s i l f d b``), nulls among them."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        row = [f"k{rng.integers(50)}", int(rng.integers(-9, 9)),
               int(rng.integers(1 << 40)), float(np.float32(rng.normal())),
               float(rng.normal()), bool(rng.random() < 0.5)]
        for j in range(6):
            if rng.random() < 0.05:
                row[j] = None
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wal_segments_byte_identical(seed, tmp_path):
    rows = wal_rows(seed, 300)
    rng = np.random.default_rng(seed + 10)
    calls, i = [], 0
    while i < len(rows):                 # one record per ingress call
        k = int(rng.integers(1, 20))
        calls.append((rows[i:i + k], list(range(1000 + i, 1000 + i + k))))
        i += k
    for side, mod in (("ref", ref_wal), ("port", port_wal)):
        w = mod.WriteAheadLog(str(tmp_path / side), "App", "S", "silfdb",
                              segment_bytes=2048)
        for r, t in calls:
            w.append(r, t)
        w.close()
    ref, port = tree(tmp_path / "ref"), tree(tmp_path / "port")
    assert len(ref) > 2 and port == ref


def test_each_reopens_the_others_log_with_a_torn_tail(tmp_path):
    rows = wal_rows(5, 60)
    w = ref_wal.WriteAheadLog(str(tmp_path / "a"), "App", "S", "silfdb",
                              segment_bytes=1024)
    for lo in range(0, 60, 6):
        w.append(rows[lo:lo + 6], list(range(lo, lo + 6)))
    w.close()
    seg = sorted(tree(tmp_path / "a"))[-1]
    with open(tmp_path / "a" / seg, "ab") as f:
        f.write(b"\x00\x00\x01\x00torn")          # a record cut short
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    got = {}
    for side, mod, d in (("ref", ref_wal, "a"), ("port", port_wal, "b")):
        w = mod.WriteAheadLog(str(tmp_path / d), "App", "S", "silfdb",
                              segment_bytes=1024)
        got[side] = (w.next_seq, list(w.replay(17)))
        w.append([rows[0]], [99])
        w.close()
    assert got["port"] == got["ref"] and got["port"][0] == 61
    assert tree(tmp_path / "a") == tree(tmp_path / "b")


WAL_APP = """
@app:name('walApp')
@app:wal(dir='{wal}', segment.bytes='512', fsync='false')
@app:backpressure(capacity='64', policy='block')
define stream S (dev string, v double, k long, ok bool);
from S[v > 50.0] select dev, v, k insert into Out;
"""


def test_engine_wal_byte_identical(tmp_path):
    rows = [[f"d{i % 7}", float(i * 3 % 101), i, i % 2 == 0]
            for i in range(120)]
    for side, pkg in PKGS.items():
        m = manager(side)
        rt = m.create_siddhi_app_runtime(
            WAL_APP.format(wal=tmp_path / side), playback=True)
        rt.start()
        ih = rt.input_handler("S")
        for i in range(0, 60):
            ih.send(rows[i], timestamp=1000 + i)
        for lo in range(60, 120, 20):            # chunks: one record each
            ih.send([pkg.Event(1000 + i, rows[i])
                     for i in range(lo, lo + 20)])
        stats = rt.flow.stats_report()
        m.shutdown()
        if side == "ref":
            ref_stats = stats
    assert stats == ref_stats
    ref, port = tree(tmp_path / "ref"), tree(tmp_path / "port")
    assert len(ref) > 2 and port == ref


# ------------------------------------------------------------ recovery

CHAIN_APP = """
@app:name('durable')
@app:wal(dir='{wal}', fsync='false')
define stream S (dev string, v double);
@info(name='chain') @device(batch='32', slots='16', strict='true')
from every e1=S[v > 90.0] -> e2=S[v > e1.v] -> e3=S[v > e2.v] within 400
select e1.v as v1, e2.v as v2, e3.v as v3 insert into Alerts;
@info(name='hot')
from S[v > 80.0]#window.length(8) select dev, max(v) as peak, count() as n
insert into Hot;
"""
HOST_APP = """
@app:name('durable')
@app:wal(dir='{wal}', fsync='false')
define stream S (dev string, v double);
@info(name='hot')
from S[v > 80.0]#window.length(8) select dev, max(v) as peak, count() as n
insert into Hot;
"""
OUTS = ("Alerts", "Hot")


def feed_events(n: int, seed: int = 11) -> list:
    rng = np.random.default_rng(seed)
    v = np.round(rng.uniform(0, 100, n), 2)
    for k in range(0, n, 23):                      # rising ramps above 90
        v[k:k + 4] = 91.0 + np.arange(min(4, n - k)) * 2.0
    return [([f"d{rng.integers(4)}", float(v[i])], 1000 + 7 * i)
            for i in range(n)]


def start(side, app, store_dir):
    m = manager(side, store_dir)
    rt = m.create_siddhi_app_runtime(app, playback=True)
    got = {s: [] for s in OUTS if s in rt.ctx.stream_junctions}
    for s, rows in got.items():
        rt.add_callback(s, PKGS[side].StreamCallback(
            lambda evs, rows=rows: rows.extend(
                (e.timestamp, tuple(e.data)) for e in evs)))
    rt.start()
    return m, rt, got


def send(rt, events) -> None:
    ih = rt.input_handler("S")
    for row, ts in events:
        ih.send(list(row), timestamp=ts)


def straight(side, app_fmt, tmp_path, events) -> dict:
    m, rt, got = start(side, app_fmt.format(wal=tmp_path / f"{side}-s-wal"),
                       tmp_path / f"{side}-s-store")
    send(rt, events)
    rt.flush_device()
    m.shutdown()
    return got


def crash_then_recover(first, second, app_fmt, tmp_path, events,
                       persist_at, kill_at):
    """``first`` runs to ``kill_at`` with a persist at ``persist_at`` and is
    abandoned (no shutdown, no flush); ``second`` recovers from its store and
    WAL and takes the rest. Returns the stitched rows and the report."""
    wal, store = tmp_path / "wal", tmp_path / "store"
    app = app_fmt.format(wal=wal)
    m1, rt1, got1 = start(first, app, store)
    send(rt1, events[:persist_at])
    rt1.persist()
    at_persist = {s: len(r) for s, r in got1.items()}
    send(rt1, events[persist_at:kill_at])
    # crash: rt1 is abandoned
    m2, rt2, got2 = start(second, app, store)
    report = PKGS[second].recover(rt2) if second == "port" \
        else siddhi_tpu.flow.recover(rt2)
    send(rt2, events[kill_at:])
    rt2.flush_device()
    m2.shutdown()
    stitched = {s: got1[s][:at_persist[s]] + got2[s] for s in got2}
    return stitched, report


@pytest.mark.parametrize("app", ["host", "device"])
def test_reference_revision_and_wal_recover_in_the_port(app, tmp_path):
    app_fmt = HOST_APP if app == "host" else CHAIN_APP
    events = feed_events(320)
    want = straight("ref", app_fmt, tmp_path, events)
    got, report = crash_then_recover("ref", "port", app_fmt, tmp_path,
                                     events, persist_at=96, kill_at=224)
    assert report["replayed"] == {"S": 128}
    assert report["watermarks"] == {"S": 224}
    assert all(want.values()) and got == want


def test_kill_replay_device_chain_exactly_once(tmp_path):
    """Cuts at multiples of the chain's batch (32): the crashed and the
    straight run step the same batches."""
    events = feed_events(384, seed=3)
    want = straight("port", CHAIN_APP, tmp_path, events)
    ref = straight("ref", CHAIN_APP, tmp_path, events)
    got, report = crash_then_recover("port", "port", CHAIN_APP,
                                     tmp_path, events, persist_at=128,
                                     kill_at=288)
    assert report["replayed"] == {"S": 160}
    assert report["watermarks"] == {"S": 288}
    assert want["Alerts"] and got == want == ref


def test_wal_shrinks_after_persist(tmp_path):
    m, rt, _ = start("port", WAL_APP.format(wal=tmp_path / "w"),
                     tmp_path / "store")
    send_rows = [[f"d{i % 3}", float(i), i, True] for i in range(200)]
    for i, r in enumerate(send_rows):
        rt.input_handler("S").send(r, timestamp=1000 + i)
    sf = rt.flow.streams["S"]
    before = sf.wal.wal_bytes
    rt.persist()
    assert sf.wal.wal_bytes < before
    gauges = rt.ctx.statistics_manager.report()["gauges"]
    assert gauges["flow.S.wal_bytes"] == sf.wal.wal_bytes
    assert gauges["flow.S.shed_count"] == 0
    m.shutdown()


# --------------------------------------------------------- backpressure

@pytest.mark.parametrize("policy", ["block", "drop_oldest", "shed"])
def test_credit_gate_matches_reference(policy):
    """The same admit/release sequence against a queue that drains in bursts;
    BLOCK waits at most ``max_wait_s`` then forces admission."""
    trails = []
    for mod in (ref_bp, port_bp):
        depth = [0]

        def evict():
            if depth[0] == 0:
                return None
            depth[0] -= 1
            return 1

        gate = mod.CreditGate(8, mod.OverloadPolicy.parse(policy),
                              depth_fn=lambda: depth[0], evict_fn=evict,
                              max_wait_s=0.002)
        trail = []
        rng = np.random.default_rng(4)
        for _ in range(60):
            n = int(rng.integers(1, 4))
            ok = gate.admit(n)
            if ok:
                depth[0] += n
                gate.release(n)
            if rng.random() < 0.2:
                depth[0] = max(0, depth[0] - int(rng.integers(1, 6)))
            trail.append((ok, depth[0], gate.credits, gate.depth))
        s = gate.stats
        trails.append((trail, s.accepted, s.shed, s.dropped_oldest,
                       s.blocked_forced if hasattr(s, "blocked_forced")
                       else None))
    assert trails[0] == trails[1]


BP_APP = """
@app:name('bp')
@app:backpressure(capacity='16', policy='{policy}', block.timeout='0.01')
@async(buffer.size='1024')
define stream S (v long);
from S select v insert into Out;
"""


@pytest.mark.parametrize("policy", ["block", "drop_oldest", "shed"])
def test_backpressure_policy_on_a_stalled_consumer(policy):
    """The consumer blocks until 40 events have been sent: SHED drops the
    newest past 16 queued, DROP_OLDEST keeps the newest, BLOCK forces
    admission after its timeout and loses nothing."""
    out = {}
    for side, pkg in PKGS.items():
        m = manager(side)
        rt = m.create_siddhi_app_runtime(BP_APP.format(policy=policy),
                                         playback=True)
        gate = threading.Event()
        got = []

        def slow(evs, got=got, gate=gate):
            gate.wait(5.0)
            got.extend(e.data[0] for e in evs)

        rt.add_callback("Out", pkg.StreamCallback(slow))
        rt.start()
        ih = rt.input_handler("S")
        for i in range(40):
            ih.send([i], timestamp=1000 + i)
        gate.set()
        rt.drain_async()
        st = rt.flow.streams["S"].stats
        out[side] = (st.accepted + st.shed, st.shed > 0,
                     st.dropped_oldest > 0, len(got) + st.shed
                     + st.dropped_oldest)
        m.shutdown()
    assert out["port"] == out["ref"]
    total, shed, dropped, accounted = out["port"]
    assert accounted == 40
    assert (shed, dropped) == {"block": (False, False),
                               "drop_oldest": (False, True),
                               "shed": (True, False)}[policy]


# ---------------------------------------------------------- adaptive

@pytest.mark.parametrize("mode", ["throughput", "latency"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_controller_matches_reference(mode, seed):
    kw = dict(min_batch=64, max_batch=4096, initial=512, cooldown=3)
    if mode == "latency":
        kw["latency_target_ms"] = 50.0
    ctrls = [mod.AdaptiveBatchController(**kw)
             for mod in (ref_adaptive, port_adaptive)]
    rng = np.random.default_rng(seed)
    changed = 0
    for _ in range(400):
        n = int(rng.choice([64, 512, 4096, int(rng.integers(1, 5000))]))
        lat = float(rng.lognormal(np.log(0.02), 1.0))
        arr = float(rng.uniform(1e3, 1e6))
        outs = [c.observe(n, lat, arrival_evps=arr) for c in ctrls]
        assert outs[0] == outs[1]
        reps = [c.report() for c in ctrls]
        assert reps[0] == reps[1]
        assert ctrls[0].flush_deadline_ms == ctrls[1].flush_deadline_ms
        assert ctrls[0].predicted_p99_ms == ctrls[1].predicted_p99_ms
        changed = ctrls[1].adjustments
    assert changed > 0


def test_adaptive_annotation_matches_reference():
    from siddhi_tpu.compiler import parse as ref_parse
    from siddhi_tpu_torch.compiler import parse as port_parse
    from siddhi_tpu.query_api.annotation import find_annotation as rf
    from siddhi_tpu_torch.query_api.annotation import find_annotation as pf
    text = ("@app:adaptive(latency.target.ms='50', min='256', max='2048', "
            "initial='512', target.ms='10')\ndefine stream S (v int);\n"
            "from S select v insert into O;\n")
    ref = ref_adaptive.parse_adaptive_annotation(
        rf(ref_parse(text).annotations, "adaptive"))
    port = port_adaptive.parse_adaptive_annotation(
        pf(port_parse(text).annotations, "adaptive"))
    assert port == ref and port["latency_target_ms"] == 50.0


ADAPTIVE_APP = """
@app:name('edge')
{adaptive}
define stream S (dev string, v double);
@info(name='stats') @device(batch='256', window='256', strict='true'{async_})
from S#window.length(256) select dev, sum(v) as total, count() as n
group by dev insert into Stats;
"""


def run_adaptive(side, adaptive: str, async_: bool, n: int = 1500,
                 idle: float = 0.0):
    m = manager(side)
    app = ADAPTIVE_APP.format(adaptive=adaptive,
                              async_=", async='true'" if async_ else "")
    rt = m.create_siddhi_app_runtime(app, playback=True)
    got = []
    rt.add_callback("Stats", PKGS[side].StreamCallback(
        lambda evs: got.extend((e.timestamp, list(e.data)) for e in evs)))
    rt.start()
    rng = np.random.default_rng(9)
    ih = rt.input_handler("S")
    b = rt.device_bridges[0]
    fed = _Fed(b.runtime) if side == "port" else None
    for i in range(n):
        ih.send([f"d{rng.integers(16)}", float(np.round(rng.uniform(0, 100),
                                                        3))],
                timestamp=1000 + i)
    if idle:
        t0 = time.monotonic()
        while b.driver.deadline_flushes == 0 \
                and time.monotonic() - t0 < idle:
            time.sleep(0.01)
    rt.flush_device()
    if b.driver is not None:
        b.driver.flush_sync()
    ctrl = b.runtime.batch_controller
    gauges = rt.ctx.statistics_manager.report()["gauges"]
    info = dict(
        report=None if ctrl is None else ctrl.report(),
        current=None if ctrl is None else ctrl.current,
        gauge=gauges.get("device.stats.batch_size"),
        deadline=0 if b.driver is None else b.driver.deadline_flushes,
        fed=fed, compiled=b.runtime.compiled)
    m.shutdown()
    return got, info


def same_rows(info, static_info, got, static) -> None:
    """Values of two runs of the stats query that batch differently (an
    output row carries its batch's timestamp, so timestamps differ), under
    the larger of the two port runs' scales."""
    a, b = static_info["fed"].scale, info["fed"].scale
    sc = Scale(np.maximum(a.s1, b.s1), np.maximum(a.sm, b.sm),
               np.maximum(a.s2, b.s2))
    assert_rows_close(info["compiled"], [d for _, d in static],
                      [d for _, d in got], sc)


def test_adaptive_sync_rows_equal_a_static_run():
    """Throughput mode on the synchronous path: the threshold moves, and
    the rows are the reference's static run's (counts exact, sums within
    the limits) and the reference's adaptive run's (the same batches, so
    the same limits)."""
    adaptive = "@app:adaptive(target.ms='0.001', min='16', initial='32')"
    ref_static, _ = run_adaptive("ref", "", False)
    static, static_info = run_adaptive("port", "", False)
    got, info = run_adaptive("port", adaptive, False)
    ref, ref_info = run_adaptive("ref", adaptive, False)
    assert info["report"]["observations"] > 0
    assert info["report"]["adjustments"] > 0
    assert info["current"] == ref_info["current"]
    assert info["gauge"] == info["current"]
    same_rows(static_info, static_info, static, ref_static)
    same_rows(info, static_info, got, ref_static)
    same_rows(info, info, got, ref)


def test_adaptive_latency_mode_deadline_flush():
    """Latency mode through the async driver: a partial batch left staged
    past the deadline is flushed by the worker; the rows stay the
    reference's static run's."""
    adaptive = "@app:adaptive(latency.target.ms='20', min='16')"
    ref_static, _ = run_adaptive("ref", "", True, n=300)
    static, static_info = run_adaptive("port", "", True, n=300)
    got, info = run_adaptive("port", adaptive, True, n=300, idle=60.0)
    assert info["deadline"] >= 1
    assert info["report"]["observations"] > 0
    assert info["report"]["mode"] == "latency"
    assert info["gauge"] == info["current"]
    same_rows(static_info, static_info, static, ref_static)
    same_rows(info, static_info, got, ref_static)
