"""The port's mesh fabric (``siddhi_tpu_torch.mesh``) against the JAX
package's (``siddhi_tpu.mesh``), on the CPU.

- ``shape_fingerprint`` gives the reference's keys over ``tests/test_mesh.py``'s
  tenant texts, the reference bench's mesh tenants (whose port copies in
  ``siddhi_tpu_torch/tools/mesh_workloads.py`` give the same texts) and the
  samples' apps;
- ``PlacementPolicy.place`` and ``recompute`` (locality, seeded random, a
  balanced recompute after a host joins, evidence pressure) give the same
  assignments;
- a two-host fabric of each package carries a small-width ``@device`` chain
  tenant (the blocked NFA) and a grouped ``length`` tenant (the query step)
  through one migration, and through one kill and recover: each tenant's
  rows equal in order, the chain's exactly, the grouped float32 sums within
  ``tests/test_torch_query_shapes.py``'s tolerances (the scale of what the
  port's solo run of the tenant stepped); the port's rows also equal its
  solo run's exactly;
- ``MeshFabric`` without a device raises where there is no card, and never
  falls back; ``MeshConfig`` holds to the reference's rules in both
  packages (``durable`` needs ``mode='process'``, an unknown mode raises,
  ``mode='process', durable=True`` builds);
- the mesh section of the reference's guard-coverage lint
  (``scripts/check_guard_coverage.py``), loaded as data, holds for the
  port's fabric and rebalancer;
- ``rising_events`` (the main path's matching stream) gives matches through
  the plain ``PartitionedNFARuntime`` at 8 lanes, the JAX package's rows.
"""

import importlib.util
import inspect
import os
import re
import textwrap

import pytest
import torch

import siddhi_tpu.mesh as jmesh
import siddhi_tpu_torch
import siddhi_tpu_torch.mesh as tmesh
from siddhi_tpu_torch.tools import mesh_workloads as mw
from siddhi_tpu_torch.tools.engine_workloads import rising_events
from test_torch_runtime import _Fed, assert_rows_close

import test_mesh as ref_suite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, path: str):
    """A script of the repo as a module (its top level only runs)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH = _load("bench_mesh_texts", os.path.join(REPO, "bench.py"))
SHAPES_LINT = _load("check_fleet_shapes_mesh",
                    os.path.join(REPO, "scripts", "check_fleet_shapes.py"))
FLEET_ANN = "@app:fleet(batch='8192', lanes='24')\n"


# ------------------------------------------------------- shape fingerprints

def _corpus(name: str) -> list:
    if name == "test_mesh":
        return [ref_suite._rule_app(i, shape) for i in range(8)
                for shape in range(4)] + [
            ref_suite._windowed_app(i) for i in range(3)] + [
            "@app(name='x')\ndefine stream S (v double);\n"
            "from S select v order by v limit 3 insert into O;"]
    if name == "bench":
        return [BENCH._mesh_shape_app(i, i % 8, FLEET_ANN)
                for i in range(16)] + [
            BENCH._mesh_kleene_app(i, FLEET_ANN) for i in range(8)]
    return [text for _, text in SHAPES_LINT._sample_corpus_texts()]


def _key(fingerprint, text):
    try:
        return fingerprint(text)
    except Exception as e:        # noqa: BLE001 — the outcome is compared
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("corpus", ["test_mesh", "bench", "samples"])
def test_shape_fingerprint_equals_the_reference(corpus):
    texts = _corpus(corpus)
    assert texts
    ref = [_key(jmesh.shape_fingerprint, t) for t in texts]
    got = [_key(tmesh.shape_fingerprint, t) for t in texts]
    assert got == ref
    assert any(isinstance(k, tuple) and k and k[0] != "raises"
               for k in got)


def test_bench_mesh_tenants_are_the_reference_bench_texts():
    for i in range(16):
        assert mw.mesh_shape_app(i, i % 8, FLEET_ANN) == \
            BENCH._mesh_shape_app(i, i % 8, FLEET_ANN)
        assert mw.mesh_kleene_app(i, FLEET_ANN) == \
            BENCH._mesh_kleene_app(i, FLEET_ANN)


# ----------------------------------------------------------------- placement

def _plan_of(pkg, kind: str):
    """A placement round of package ``pkg``'s plan module: 24 tenants of
    the bench's 8 shapes on 3 hosts, a host joining (balanced recompute), a
    host leaving, and a placement under evidence pressure."""
    tenants = [pkg.TenantSpec(f"t{i}", "", shapes=(
        tuple(jmesh.shape_fingerprint(BENCH._mesh_shape_app(
            i, i % 8, FLEET_ANN))))) for i in range(24)]
    hosts = [pkg.HostSlot(h, 10) for h in range(3)]
    pol = pkg.PlacementPolicy(kind, seed=5)
    plan = pol.place(tenants, hosts)
    joined = pol.recompute(plan, tenants, hosts + [pkg.HostSlot(3, 10)],
                           balance=True)
    left = pol.recompute(joined, tenants, hosts[1:] + [pkg.HostSlot(3, 10)])
    pressed = pol.place(tenants[:6], hosts[:2], {
        0: {"load_share": 0.9, "ejections": 2, "slo_violations": 1},
        1: {"load_share": 0.1}})
    return [{t: (s.host, s.shape, s.device) for t, s in p.assignment.items()}
            for p in (plan, joined, left, pressed)] + [
        plan.diff(joined), joined.diff(left), joined.report()]


@pytest.mark.parametrize("kind", ["locality", "random"])
def test_placement_and_recompute_equal_the_reference(kind):
    assert _plan_of(tmesh, kind) == _plan_of(jmesh, kind)


# ------------------------------------------- device tenants through a fabric

N_EVENTS = 512
CHUNK = 64
WIDTHS = dict(batch=64, slots=16)
TENANTS = ("mesh-chain-0", "mesh-gl-0")


def _inputs():
    apps = {t: mw.tenant_app(t, **WIDTHS) for t in TENANTS}
    feeds = {t: mw.tenant_feed(t, N_EVENTS, 42) for t in TENANTS}
    chunks = {t: mw.tenant_chunks(feeds[t], CHUNK) for t in TENANTS}
    return apps, feeds, chunks


def _port_solo(app: str, tid: str, feed, chunks):
    """The tenant alone on the port's CPU engine: its rows and, for the
    grouped window, the tolerance scale of what it stepped."""
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(app, playback=True)
    rows = []
    rt.add_callback(mw.tenant_out(tid), siddhi_tpu_torch.StreamCallback(
        lambda evs: rows.extend((e.timestamp, list(e.data)) for e in evs)))
    drt = rt.device_bridges[0].runtime
    fed = _Fed(drt) if hasattr(drt, "compiled") else None
    rt.start()
    for c, t in chunks:
        rt.input_handler(feed[0]).send_rows(c, t)
    rt.flush_device()
    m.shutdown()
    return rows, fed, drt


def _hold(ref: dict, got: dict, apps, feeds, chunks) -> None:
    for t in TENANTS:
        solo, fed, drt = _port_solo(apps[t], t, feeds[t], chunks[t])
        assert got[t] == solo, t
        assert got[t], t
        if fed is None:
            assert got[t] == ref[t], t
        else:
            assert [ts for ts, _ in got[t]] == [ts for ts, _ in ref[t]]
            assert_rows_close(drt.compiled, [r for _, r in ref[t]],
                              [r for _, r in got[t]], fed.scale)


def test_device_tenants_through_a_migration(tmp_path):
    apps, feeds, chunks = _inputs()
    out = {}
    for name, fab in (
            ("ref", jmesh.MeshFabric(2, str(tmp_path / "ref"),
                                     jmesh.MeshConfig(capacity_per_host=4))),
            ("port", tmesh.MeshFabric(2, str(tmp_path / "port"),
                                      tmesh.MeshConfig(capacity_per_host=4),
                                      device="cpu"))):
        try:
            out[name] = mw.run_migration(fab, apps, feeds, chunks, 4,
                                         list(TENANTS))
            rep = out[name]["report"]
            assert rep["migrations"] == 2 and rep["dup_chunks"] == 0
            for t, (src, dst) in out[name]["moved"].items():
                assert src != dst
        finally:
            fab.close()
    assert out["port"]["moved"] == out["ref"]["moved"]
    _hold(out["ref"]["rows"], out["port"]["rows"], apps, feeds, chunks)


def test_device_tenants_through_a_kill_and_recover(tmp_path):
    apps, feeds, chunks = _inputs()
    out = {}
    cfg = dict(capacity_per_host=4, snapshot_every_chunks=1)
    for name, fab in (
            ("ref", jmesh.MeshFabric(2, str(tmp_path / "ref"),
                                     jmesh.MeshConfig(**cfg))),
            ("port", tmesh.MeshFabric(2, str(tmp_path / "port"),
                                      tmesh.MeshConfig(**cfg),
                                      device="cpu"))):
        try:
            out[name] = mw.run_kill_recover(fab, apps, feeds, chunks,
                                            list(TENANTS), 3, 2)
            rep = out[name]["report"]
            assert sorted(out[name]["orphans"]) == sorted(TENANTS)
            assert rep["recoveries"] == 2 and rep["dup_chunks"] == 0
            assert out[name]["spilled"] == 2 * len(TENANTS)
        finally:
            fab.close()
    assert out["port"]["recovered_on"] == out["ref"]["recovered_on"]
    _hold(out["ref"]["rows"], out["port"]["rows"], apps, feeds, chunks)


def test_a_restored_tenant_lands_on_its_new_host_manager_device(tmp_path):
    """A migrated tenant's device state is rebuilt on the destination host's
    engine device (the card of its ordinal; here both hosts' CPU)."""
    apps, feeds, chunks = _inputs()
    fab = tmesh.MeshFabric(2, str(tmp_path / "m"),
                           tmesh.MeshConfig(capacity_per_host=4),
                           device="cpu")
    try:
        mw.run_migration(fab, apps, feeds, chunks, 2, ["mesh-chain-0"])
        st = fab.tenants["mesh-chain-0"]
        host = fab.hosts[st.host]
        rt = host.runtimes["mesh-chain-0"]
        leaves = [v for v in rt.device_bridges[0].runtime.state.values()
                  if isinstance(v, torch.Tensor)]
        assert leaves and all(x.device == host.manager.device
                              for x in leaves)
        assert host.manager.device.type == "cpu"
        assert all(h.device is None for h in fab.hosts.values())
    finally:
        fab.close()


# ------------------------------------------------------ devices and refusals

def test_fabric_without_a_device_raises_where_there_is_no_card(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.MeshFabric(2, str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.MeshFabric(1, str(tmp_path / "m2"), devices=[0])
    assert tmesh.MeshFabric._probe_devices(3) == [None] * 3
    fab = tmesh.MeshFabric(2, str(tmp_path / "m3"), device="cpu")
    try:
        assert [h.manager.device.type for h in fab.hosts.values()] == \
            ["cpu", "cpu"]
        fab.add_host()
        assert fab.hosts[2].manager.device.type == "cpu"
    finally:
        fab.close()


def test_host_ordinals_follow_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.MeshFabric._probe_devices(5) == [0, 1, 0, 1, 0]
    assert tmesh.MeshFabric._probe_devices(3, "cuda:1") == [1, 1, 1]
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert tmesh.MeshFabric._probe_devices(2, "cuda") == [1, 1]
    assert tmesh.MeshFabric._probe_devices(2, "cpu") == [None, None]


@pytest.mark.parametrize("kw,raises", [
    (dict(durable=True), "requires mode='process'"),
    (dict(mode="inproc", durable=True), "requires mode='process'"),
    (dict(mode="rdma"), "is not inproc|process"),
    (dict(mode="thread", durable=True), "is not inproc|process"),
    (dict(mode="process"), None),
    (dict(mode="process", durable=True), None),
    (dict(), None)])
def test_mesh_config_holds_to_the_reference_rules(kw, raises):
    """Both packages' ``MeshConfig`` accept and refuse the same settings,
    with the same message."""
    for mesh in (jmesh, tmesh):
        if raises is None:
            cfg = mesh.MeshConfig(**kw)
            assert (cfg.mode, cfg.durable) == \
                (kw.get("mode", "inproc"), kw.get("durable", False))
        else:
            with pytest.raises(ValueError, match=re.escape(raises)):
                mesh.MeshConfig(**kw)


# ------------------------------------------------- guard coverage (the mesh)

def _lint_mesh_section() -> str:
    """The mesh section of the reference's guard-coverage lint, as text,
    its imports pointed at the port."""
    src = open(os.path.join(REPO, "scripts", "check_guard_coverage.py")).read()
    start = src.rindex("\n", 0, src.index("# 5) mesh decision paths")) + 1
    end = src.rindex("\n", 0,
                     src.index("# 6) procmesh supervisor decision paths")) + 1
    body = textwrap.dedent(src[start:end])
    assert body.count("from siddhi_tpu.mesh import") == 2
    return body.replace("from siddhi_tpu.mesh import",
                        "from siddhi_tpu_torch.mesh import")


def test_guard_coverage_mesh_section_holds_for_the_port():
    results = []

    def check(name, ok, detail=""):
        results.append((name, bool(ok), detail))

    exec(compile(_lint_mesh_section(), "check_guard_coverage[mesh]", "exec"),
         {"inspect": inspect, "re": re, "check": check})
    assert len(results) == 5
    assert all(ok for _, ok, _ in results), results
    # the same checks fail on a fabric that moves state before recording
    from siddhi_tpu_torch.mesh import fabric
    src = inspect.getsource(fabric.MeshFabric._migrate_reserved)
    assert src.find("self._record_move(") < src.find("st.migrating = True")


# ------------------------------------------------------ the matching stream

MATCH_WIDTHS = dict(num_partitions=8, key_attr="dev", slot_capacity=64,
                    lane_batch=2048, creation_cap=320)


def test_rising_events_match_through_the_plain_partitioned_runtime():
    from siddhi_tpu.tpu.partition import PartitionedNFARuntime as JRuntime

    from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
    from siddhi_tpu_torch.tools.engine_workloads import chain_text
    states, sel = chain_text("S")
    app = ("define stream S (dev string, v double);\n"
           "partition with (dev of S)\nbegin\n"
           f"from every {states} within 4000\nselect {sel} insert into "
           "Alerts;\nend;\n")
    dev, v, ts = rising_events(16384, 42)
    rows = {}
    for name, rt in (("port", PartitionedNFARuntime(app, device="cpu",
                                                    **MATCH_WIDTHS)),
                     ("ref", JRuntime(app, **MATCH_WIDTHS))):
        rows[name] = rt.send_many("S", {"dev": dev, "v": v}, ts,
                                  decode=True)
        rows[name] += rt.flush(decode=True)
        assert rt.match_count == len(rows[name])
    assert rows["port"] == rows["ref"]
    assert len(rows["port"]) > 0
    for r in rows["port"]:
        assert r[0] > 90.0 and all(a < b for a, b in zip(r, r[1:]))
