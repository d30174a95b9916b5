"""A fleet group's step runs with Python's collector deferred
(``gpu/host_exec.py::collector_deferred``), against the JAX package's
fleet: the collector is off inside the step and back on after it, and the
tenants' rows, their order and their nulls stay the reference's.
"""

import gc
import threading

import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.gpu.host_exec import collector_deferred

STREAM = "define stream S (dev string, v double, n long);\n"


def tenant(i: int) -> str:
    return (f"@app(name='t{i}')\n@app:fleet(batch='64')\n{STREAM}"
            f"@info(name='rule') from S[v > {40.0 + 5 * i}] "
            f"select dev, v, n insert into Alerts;")


def chunks():
    rows = [[f"d{k % 5}", None if k % 17 == 0 else float(k % 97), k]
            for k in range(300)]
    return [(rows[i:i + 23], list(range(1000 + i, 1000 + i + len(
        rows[i:i + 23])))) for i in range(0, len(rows), 23)]


def run(pkg, manager, watch=None):
    apps, got = [], []
    for i in range(3):
        rt = manager.create_siddhi_app_runtime(tenant(i), playback=True)
        out = []
        rt.add_callback("Alerts", pkg.StreamCallback(
            lambda evs, out=out: out.extend(
                (e.timestamp, list(e.data)) for e in evs)))
        rt.start()
        apps.append(rt)
        got.append(out)
    if watch is not None:
        watch(apps[0].fleet_bridges[0].member.group)
    for rows, tss in chunks():
        for rt in apps:
            rt.input_handler("S").send_rows([list(r) for r in rows], tss)
    for rt in apps:
        rt.flush_host()
    return got


def test_group_step_defers_the_collector_and_gives_the_reference_rows():
    seen = []

    def watch(group):
        hq = group.plan.hq
        step = hq.step

        def watched(*a, **k):
            seen.append(gc.isenabled())
            return step(*a, **k)
        hq.step = watched

    assert gc.isenabled()
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    try:
        got = run(siddhi_tpu_torch, m, watch)
    finally:
        m.shutdown()
    assert seen and not any(seen) and gc.isenabled()
    r = siddhi_tpu.SiddhiManager()
    try:
        ref = run(siddhi_tpu, r)
    finally:
        r.shutdown()
    assert got == ref and all(got)


@pytest.mark.parametrize("was_on", [True, False])
def test_collector_deferred_restores_the_collector(was_on):
    before = gc.isenabled()
    try:
        (gc.enable if was_on else gc.disable)()
        with collector_deferred():
            assert not gc.isenabled()
            with collector_deferred():
                assert not gc.isenabled()
            assert not gc.isenabled()
        assert gc.isenabled() == was_on
        # concurrent bodies: the collector stays off until the last leaves
        inside, release = threading.Event(), threading.Event()

        def body():
            with collector_deferred():
                inside.set()
                release.wait(10)

        t = threading.Thread(target=body)
        with collector_deferred():
            t.start()
            assert inside.wait(10)
        assert not gc.isenabled()
        release.set()
        t.join(10)
        assert gc.isenabled() == was_on
    finally:
        (gc.enable if before else gc.disable)()
