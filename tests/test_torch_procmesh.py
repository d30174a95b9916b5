"""The port's process mesh (``siddhi_tpu_torch.procmesh``) against the JAX
package's (``siddhi_tpu.procmesh``), on the CPU, on the same seeded input.

- a fabric journal written by either package replays to the same
  checkpoint and tail in the other, its segments the same bytes, a torn
  tail truncated the same way;
- ``WireChaos`` makes the same per-site decisions for a seed (the frames
  it passes, drops, corrupts and doubles, its counters);
- frames, runfiles, per-op deadlines and an ingest chunk's header and SoA
  body are the same bytes, and each package reads the other's frames;
- the procmesh sections of the reference's guard-coverage lint
  (``scripts/check_guard_coverage.py``, loaded as data: the supervisor's
  record-before-actuate and the gray-failure ladder) hold for the port;
- a worker asked for a card it lacks fails its boot with
  ``WorkerSpawnError`` and leaves no process; a process fabric without a
  device raises where there is no card before it spawns anything; a
  worker on the CPU reports its device, boot time and (no) kernel builds;
- a two-host process fabric of each package carries a small-width
  ``@device`` chain tenant (the blocked NFA) and a grouped ``length``
  tenant (the query step) through the moves and the kill and recovery of
  ``mesh_workloads.run_kill_recover``: each tenant's rows equal in order,
  the chain's exactly, the grouped float32 sums within
  ``tests/test_torch_query_shapes.py``'s tolerances, and the port's rows
  equal its solo run's.
"""

import importlib.util
import inspect
import json
import os
import random
import re
import socket
import textwrap

import numpy as np
import pytest
import torch

import siddhi_tpu.mesh as jmesh
import siddhi_tpu.procmesh.host as jhost
import siddhi_tpu.procmesh.journal as jjournal
import siddhi_tpu.procmesh.protocol as jproto
import siddhi_tpu_torch.mesh as tmesh
import siddhi_tpu_torch.procmesh.host as thost
import siddhi_tpu_torch.procmesh.journal as tjournal
import siddhi_tpu_torch.procmesh.protocol as tproto
from siddhi_tpu_torch.procmesh import WorkerSpawnError
from siddhi_tpu_torch.procmesh import supervisor as tsup
from siddhi_tpu_torch.tools import mesh_workloads as mw

import test_torch_mesh as tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOURNALS = {"ref": jjournal, "port": tjournal}
PROTOCOLS = {"ref": jproto, "port": tproto}


# ---------------------------------------------------------------- journal

def _records(seed: int) -> list:
    """A seeded mix of the fabric's record kinds."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(20, 40))):
        t = f"t{int(rng.integers(0, 4))}"
        kind = ["deploy", "cursor", "delivered", "migrate_intent",
                "migrate_commit", "worker_restart"][int(rng.integers(0, 6))]
        fields = {"tenant": t, "applied": int(rng.integers(0, 100)),
                  "epoch": int(rng.integers(0, 3)),
                  "outputs": [[0, i, "Out", 1000 + i,
                               [f"d{i}", float(rng.random())]]]}
        out.append((kind, fields))
    return out


def _write(mod, jdir: str, records: list, ckpt_at: int) -> None:
    j = mod.FabricJournal(jdir, segment_bytes=512)
    for n, (kind, fields) in enumerate(records):
        if n == ckpt_at:
            j.checkpoint({"next_gid": n, "tenants": {}, "workers": {}})
        j.append(kind, **fields)
    j.close()


def _segments(jdir: str) -> dict:
    out = {}
    for name in sorted(os.listdir(jdir)):
        with open(os.path.join(jdir, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_journal_replays_across_the_packages(tmp_path, seed, writer,
                                             reader):
    records = _records(seed)
    ckpt_at = len(records) // 2
    for name in ("ref", "port"):
        _write(JOURNALS[name], str(tmp_path / name), records, ckpt_at)
    assert _segments(str(tmp_path / "ref")) == \
        _segments(str(tmp_path / "port"))
    jdir = str(tmp_path / writer)
    # a torn tail on the writer's active segment: both readers truncate it
    last = sorted(os.listdir(jdir))[-1]
    with open(os.path.join(jdir, last), "ab") as f:
        f.write(b"\x00\x00\x01torn")
    j = JOURNALS[reader].FabricJournal(jdir, segment_bytes=512)
    got = j.replay()
    assert j.position()["lsn"] == len(records) + 1   # the checkpoint counts
    j.close()
    want = JOURNALS[writer].FabricJournal(str(tmp_path / "ref"),
                                          segment_bytes=512).replay()
    assert got == want
    assert got[0] == {"next_gid": ckpt_at, "tenants": {}, "workers": {}}
    assert [r["k"] for r in got[1]] == [k for k, _ in records[ckpt_at:]]


def test_merge_journal_folds_the_same_state():
    recs = [dict(k=k, lsn=n + 1, **f)
            for n, (k, f) in enumerate(_records(5))]
    recs = [dict(r, src=0, dst=1, gid=n, host=n % 2, app_text="x",
                 idx=n, worker=n % 2, attempt_ages_s=[0.5])
            for n, r in enumerate(recs)]
    assert tmesh.MeshFabric._merge_journal(None, recs) == \
        jmesh.MeshFabric._merge_journal(None, recs)


# ------------------------------------------------------------- wire chaos

CHAOS = [dict(dup_p=0.4), dict(corrupt_p=0.3), dict(drop_send_p=0.3),
         dict(drop_recv_p=0.5), dict(delay_p=0.5),
         dict(dup_p=0.2, corrupt_p=0.2, drop_send_p=0.2, drop_recv_p=0.2,
              fault_budget=5),
         dict(dup_p=0.5, ops={"ingest"})]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kw", CHAOS, ids=[
    "dup", "corrupt", "drop_send", "drop_recv", "delay", "mixed_budget",
    "ops"])
def test_wire_chaos_decides_as_the_reference(seed, kw):
    rng = random.Random(seed)
    frames = [(rng.choice(["ingest", "snapshot", "metrics"]),
               bytes(rng.randrange(256) for _ in range(rng.randrange(
                   20, 60)))) for _ in range(60)]
    out = {}
    for name, proto in PROTOCOLS.items():
        c = proto.WireChaos(seed=seed, delay_ms=0.0, **kw)
        sent = [c.on_send(site, frame, 13) for site, frame in frames]
        recv = [c.on_recv(site) for site, _ in frames]
        out[name] = (sent, recv, c.report())
    assert out["port"] == out["ref"]


# ------------------------------------------------- frames, runfiles, ops

def _frame_bytes(proto, frames: list) -> bytes:
    a, b = socket.socketpair()
    try:
        a.settimeout(2.0)
        b.settimeout(2.0)
        for kind, header, body in frames:
            proto.send_frame(a, kind, header, body)
        a.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return buf
            buf += chunk
    finally:
        a.close()
        b.close()


def _seeded_frames(seed: int) -> list:
    rng = random.Random(seed)
    return [(rng.choice([1, 2, 3]),
             {"op": rng.choice(["ingest", "deploy", "ping"]),
              "tenant": f"t{rng.randrange(9)}", "seq": rng.randrange(1000),
              "rows": [[f"d{i}", rng.random()] for i in range(3)]},
             bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40))))
            for _ in range(12)]


@pytest.mark.parametrize("seed", [0, 1])
def test_frames_are_the_reference_bytes_and_read_across(seed):
    frames = _seeded_frames(seed)
    wire = {n: _frame_bytes(p, frames) for n, p in PROTOCOLS.items()}
    assert wire["port"] == wire["ref"]
    for writer, reader in (("ref", "port"), ("port", "ref")):
        a, b = socket.socketpair()
        try:
            a.sendall(wire[writer])
            a.shutdown(socket.SHUT_WR)
            got = []
            while True:
                r = PROTOCOLS[reader].recv_frame(b, timeout=2.0)
                if r is None:
                    break
                got.append(r)
        finally:
            a.close()
            b.close()
        assert got == [(k, h, body) for k, h, body in frames]


def test_runfiles_are_the_reference_bytes(tmp_path):
    for name, proto in PROTOCOLS.items():
        proto.write_runfile(str(tmp_path / name), 3, 40123, 777, "ab12cd")
    paths = {n: tmp_path / n / "w3.run" for n in PROTOCOLS}
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    for writer, reader in (("ref", "port"), ("port", "ref")):
        assert PROTOCOLS[reader].read_runfile(str(tmp_path / writer), 3) == \
            {"index": 3, "port": 40123, "pid": 777, "nonce": "ab12cd"}
        assert PROTOCOLS[reader].read_runfile(str(tmp_path / writer), 4) \
            is None


def test_op_deadlines_and_hedging_equal_the_reference(monkeypatch):
    monkeypatch.delenv("SIDDHI_PROCMESH_IO_TIMEOUT_S", raising=False)
    ops = sorted(set(jproto.OP_BUDGET_SCALE) | {"stop", "boot_dcn"})
    for op in ops:
        for klass in (None, "premium", "standard", "besteffort"):
            for base in (None, 4.0):
                assert tproto.op_deadline_s(op, klass, base) == \
                    jproto.op_deadline_s(op, klass, base)
    assert thost.HEDGE_SAFE_OPS == jhost.HEDGE_SAFE_OPS
    for text in ("@app:fleet(slo.class='premium')", "define stream S (v "
                 "double);", None):
        assert thost.slo_class_of(text) == jhost.slo_class_of(text)


class _Capture:
    """A worker client that records each call and replies as an ingest
    that applied nothing."""

    def __init__(self):
        self.calls = []

    def base_timeout_s(self):
        return 30.0

    def call(self, op, header=None, body=b"", timeout=None):
        self.calls.append((op, json.dumps(header, sort_keys=True), body,
                           timeout))
        return {"applied": True, "events": []}, b""


@pytest.mark.parametrize("rows", [
    [["d1", 1.5], ["d2", 2.5]],
    [["s1", 10.25, 7], ["s2", 11.0, 9], [None, 3.0, 1]],
    [["d1", 1.5], ["d2", "x"]],                   # mixed: rides JSON
    [[True, 3], [False, 4]]])
def test_ingest_chunk_is_the_reference_bytes(rows):
    ts = [1000 + i for i in range(len(rows))]
    calls = {}
    for name, mod in (("ref", jhost), ("port", thost)):
        cap = _Capture()
        proxy = mod.RuntimeProxy(cap, "t0", slo_class="premium")
        assert proxy.send_chunk(4, "S", rows, ts, trace="00ff") is True
        calls[name] = cap.calls
    assert calls["port"] == calls["ref"]
    assert thost._soa_types(rows) == jhost._soa_types(rows)


# ----------------------------------- the procmesh sections of the lint

def _lint_sections() -> str:
    """Sections 6 to 8 of the reference's guard-coverage lint (the
    supervisor's decision paths, the journal intent, the gray-failure
    ladder), as text, their imports pointed at the port."""
    src = open(os.path.join(REPO, "scripts", "check_guard_coverage.py")).read()
    start = src.rindex("\n", 0,
                       src.index("# 6) procmesh supervisor decision")) + 1
    end = src.index("\n", src.index("MeshFabric.drain_host records before "
                                    "the placement fence"))
    end = src.index("\n\n", end)
    body = textwrap.dedent(src[start:end])
    assert body.count("from siddhi_tpu.procmesh import") == 2
    return body.replace("from siddhi_tpu.procmesh import",
                        "from siddhi_tpu_torch.procmesh import")


def test_guard_coverage_procmesh_sections_hold_for_the_port():
    spec = importlib.util.spec_from_file_location(
        "check_guard_coverage_procmesh",
        os.path.join(REPO, "scripts", "check_guard_coverage.py"))
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    results = []

    def check(name, ok, detail=""):
        results.append((name, bool(ok), detail))

    def port_journal_intent():
        src = inspect.getsource(lint.journal_intent_sites).replace(
            "from siddhi_tpu.", "from siddhi_tpu_torch.")
        ns = {"inspect": inspect}
        exec(src, ns)
        return lint.check_journal_intent(ns["journal_intent_sites"]())

    from siddhi_tpu_torch.mesh import fabric as fab_mod
    exec(compile(_lint_sections(), "check_guard_coverage[procmesh]", "exec"),
         {"inspect": inspect, "re": re, "check": check,
          "fab_mod": fab_mod, "check_journal_intent": port_journal_intent})
    assert len(results) >= 10
    assert all(ok for _, ok, _ in results), results


# --------------------------------------------------- devices and spawns

def test_worker_without_its_card_fails_its_boot(tmp_path, monkeypatch):
    """A worker asked for a card the machine lacks raises before its
    handshake: the spawn fails, every sibling goes with it, nothing runs
    on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    procs = []
    orig = tsup.ProcMeshSupervisor._spawn

    def spawn(sup, h):
        orig(sup, h)
        procs.append(h.proc)

    monkeypatch.setattr(tsup.ProcMeshSupervisor, "_spawn", spawn)
    with pytest.raises(WorkerSpawnError, match="never reached READY"):
        tmesh.MeshFabric(2, str(tmp_path / "m"),
                         tmesh.MeshConfig(mode="process"), device="cuda:0")
    assert len(procs) == 2
    assert all(p.poll() is not None for p in procs)
    assert all(p.args[p.args.index("--device") + 1] == "cuda:0"
               for p in procs)


def test_process_fabric_without_a_device_raises_before_spawning(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(tsup.ProcMeshSupervisor, "_spawn",
                        lambda sup, h: spawned.append(h.index))
    for cfg in (dict(mode="process"), dict(mode="process", durable=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.MeshFabric(2, str(tmp_path / str(len(cfg))),
                             tmesh.MeshConfig(**cfg))
    assert spawned == []


def test_workers_get_the_hosts_devices(monkeypatch, tmp_path):
    """Host i's worker runs on ``cuda:(i mod count)`` where the fabric
    names no device, on the fabric's device where it does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    seen = {}

    class Stop(Exception):
        pass

    def init(sup, n, config=None, flight=None, playback=True, journal=None,
             worker_state=None, devices=None):
        seen["devices"] = devices
        raise Stop

    monkeypatch.setattr(tsup.ProcMeshSupervisor, "__init__", init)
    for device, want in ((None, ["cuda:0", "cuda:1", "cuda:0"]),
                         ("cuda:1", ["cuda:1"] * 3), ("cpu", ["cpu"] * 3)):
        with pytest.raises(Stop):
            tmesh.MeshFabric(3, str(tmp_path / str(device)),
                             tmesh.MeshConfig(mode="process"), device=device)
        assert seen["devices"] == want


def test_worker_on_the_cpu_reports_device_and_boot(tmp_path):
    fab = tmesh.MeshFabric(1, str(tmp_path / "m"),
                           tmesh.MeshConfig(mode="process"), device="cpu")
    try:
        w = fab.report()["supervisor"]["workers"][0]
        h = fab.supervisor.handles[0]
        assert (w["device"], w["build_seconds"]) == ("cpu", {})
        assert 0.0 < w["boot_s"] < 120.0
        assert h.proc.args[h.proc.args.index("--device") + 1] == "cpu"
        assert fab.hosts[0].device is None
    finally:
        fab.close()
    assert h.proc.poll() is not None


# ------------------------------------------- device tenants, both packages

def test_device_tenants_through_process_fabrics_equal_the_reference(
        tmp_path):
    """Both packages' process fabrics (the reference's workers on JAX's
    CPU, the port's with ``--device cpu``), restarts off, through
    ``run_kill_recover``: the tenants moved onto one host, that worker
    SIGKILLed, chunks spilled, each tenant recovered onto the other worker
    from its last revision."""
    apps, feeds, chunks = tm._inputs()
    out = {}
    cfg = dict(mode="process", capacity_per_host=4, snapshot_every_chunks=1,
               auto_restart=False, heartbeat_interval_s=0.2)
    for name, fab in (
            ("ref", lambda: jmesh.MeshFabric(2, str(tmp_path / "ref"),
                                             jmesh.MeshConfig(**cfg))),
            ("port", lambda: tmesh.MeshFabric(2, str(tmp_path / "port"),
                                              tmesh.MeshConfig(**cfg),
                                              device="cpu"))):
        fab = fab()
        try:
            out[name] = mw.run_kill_recover(fab, apps, feeds, chunks,
                                            list(tm.TENANTS), 3, 2)
            fab.flush()
            rep = out[name]["report"]
            assert sorted(out[name]["orphans"]) == sorted(tm.TENANTS)
            assert rep["recoveries"] == 2 and rep["dup_chunks"] == 0
            assert out[name]["spilled"] == 2 * len(tm.TENANTS)
            assert rep["mode"] == "process"
        finally:
            fab.close()
    assert out["port"]["recovered_on"] == out["ref"]["recovered_on"]
    tm._hold(out["ref"]["rows"], out["port"]["rows"], apps, feeds, chunks)
