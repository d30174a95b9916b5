"""The process mesh with ``@device`` tenants on the card, held to the same
fabric on the CPU: two worker processes, each with its own CUDA context on
``cuda:0``, carry a grouped ``length`` tenant (``csrc/query_step.cu``) and
a blocked-NFA chain tenant (``csrc/nfa_block.cu``) at small widths through
a migration of the grouped tenant and a SIGKILL of the chain tenant's
child (the supervisor restarts it, the fabric restores the tenant from
its last revision onto the new child and replays its spill). Every
tenant's rows equal, in order, the same script with ``MeshFabric(...,
device="cpu")`` (the chain's exactly, the grouped float32 sums within
``tests/test_torch_query_shapes.py``'s tolerances); both kernels step in
the children (their device step probes, scraped over the control
socket). Port-only imports: it runs on the card's machine, where JAX is
missing (``python -m pytest tests/test_torch_procmesh_card.py -m cuda``);
it skips where no CUDA device is present (the kernels have no CPU mode).
"""

import time

import numpy as np
import pytest
import torch

from siddhi_tpu_torch.mesh import MeshConfig, MeshFabric
from siddhi_tpu_torch.tools import mesh_workloads as mw
from test_torch_query_shapes import check_close, tolerance_kinds

import test_torch_mesh_card as mesh_card

N_EVENTS = 2048
CHUNK = 128
WIDTHS = dict(batch=128, slots=16)
TENANTS = ("mesh-gl-0", "mesh-chain-0")


def _run(root: str, device, apps, feeds, chunks) -> tuple:
    """The script on a two-child process fabric: the grouped tenant moves
    after a third of the rounds, the chain tenant's child is killed after
    two thirds, two rounds spill, the script waits for the recovery and
    sends the rest. Returns the rows, the report and the children's
    steps by kernel."""
    # the degrade rung (a child's op p99 against its peer's) is off: two
    # children of different tenants differ by more than its factor on the
    # card, and a drain would move tenants the script does not move
    fab = MeshFabric(2, root, MeshConfig(mode="process", capacity_per_host=4,
                                         snapshot_every_chunks=1,
                                         heartbeat_interval_s=0.2,
                                         degrade_factor=0.0),
                     device=device)
    steps = {}

    def scrape():
        for i, host in fab.hosts.items():
            if host.alive:
                pid = fab.supervisor.handles[i].pid
                for name, v in host.scrape_metrics().items():
                    if name.endswith(".steps_total"):
                        steps[(pid, name.split(".")[0])] = int(v)

    try:
        assert [h.device for h in fab.supervisor.handles.values()] == \
            [device or "cuda:0"] * 2
        rows = mw.deploy_tenants(fab, apps)
        rounds = len(chunks[TENANTS[0]])
        for k in range(rounds):
            if k == rounds // 3:
                scrape()
                assert fab.migrate(TENANTS[0],
                                   mw.other_host(fab, TENANTS[0]))
            if k == 2 * rounds // 3:
                scrape()
                victim = fab.tenants[TENANTS[1]].host
                pid = fab.supervisor.handles[victim].pid
                orphans = fab.kill_host(victim)
                assert TENANTS[1] in orphans
            if k == 2 * rounds // 3 + 2:
                deadline = time.monotonic() + 120
                while not (fab.hosts[victim].alive
                           and all(t in fab.hosts[victim].runtimes
                                   for t in orphans)
                           and not fab.report()["spill_backlog"]):
                    assert time.monotonic() < deadline, "no recovery"
                    time.sleep(0.05)
                assert fab.supervisor.handles[victim].pid != pid
            mw.send_round(fab, feeds, chunks, k)
        fab.flush()
        scrape()
        rep = fab.report()
        rep["orphans"] = orphans
    finally:
        fab.close()
    by_kernel = {"chain": 0, "grouped_length": 0}
    for (_, t), n in steps.items():
        by_kernel[mw.DEVICE_TENANTS[t]] += n
    return rows, rep, by_kernel


@pytest.mark.cuda
def test_device_tenants_in_worker_processes_on_the_card_as_on_the_cpu(
        tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    apps = {t: mw.tenant_app(t, statistics=True, **WIDTHS) for t in TENANTS}
    feeds = {t: mw.tenant_feed(t, N_EVENTS, 7) for t in TENANTS}
    chunks = {t: mw.tenant_chunks(feeds[t], CHUNK) for t in TENANTS}
    out = {}
    for device in ("cpu", None):
        rows, rep, steps = _run(str(tmp_path / str(device)), device, apps,
                                feeds, chunks)
        assert rep["migrations"] == 1
        assert rep["recoveries"] == len(rep["orphans"]) >= 1
        assert rep["dup_chunks"] == 0
        batches = N_EVENTS // WIDTHS["batch"]
        assert steps == {"chain": batches, "grouped_length": batches}, steps
        out[device] = rows
    cpu, card = out["cpu"], out[None]
    chain, grouped = TENANTS[1], TENANTS[0]
    assert card[chain] and card[chain] == cpu[chain]
    solo, q, sc = mesh_card._solo_scale(apps[grouped], grouped,
                                        feeds[grouped], chunks[grouped])
    assert solo == cpu[grouped]
    assert [x for x, _ in card[grouped]] == [x for x, _ in cpu[grouped]]
    kinds = tolerance_kinds(q)
    cnt = next(i for i, s in enumerate(q.specs) if s.kind == "count")
    counts = np.array([r[cnt] for _, r in cpu[grouped]])
    for i, s in enumerate(q.specs):
        check_close(f"{grouped}: {s.name}",
                    np.array([r[i] for _, r in cpu[grouped]]),
                    np.array([r[i] for _, r in card[grouped]]),
                    kinds[s.name], sc, counts)
