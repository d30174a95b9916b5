"""The mesh fabric with ``@device`` tenants on the card, held to the same
script on the CPU: two in-process hosts on ``cuda:0`` carry two blocked-NFA
chain tenants (``csrc/nfa_block.cu``) and two grouped ``length`` tenants
(``csrc/query_step.cu``) at small widths through a migration of one of each
kind; every tenant's rows equal, in order, the same script with
``MeshFabric(..., device="cpu")`` (the chain's exactly, the grouped float32
sums within ``tests/test_torch_query_shapes.py``'s tolerances) and both
kernels launch. Port-only imports: it runs on the card's machine, where JAX
is missing (``python -m pytest tests/test_torch_mesh_card.py -m cuda``);
every case skips where no CUDA device is present (the kernels have no CPU
mode).
"""

import numpy as np
import pytest
import torch

from siddhi_tpu_torch import SiddhiManager, StreamCallback
from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
from siddhi_tpu_torch.gpu.query_step import QueryPlan
from siddhi_tpu_torch.mesh import MeshConfig, MeshFabric
from siddhi_tpu_torch.tools import mesh_workloads as mw
from test_torch_query_shapes import (Scale, check_close, next_scale,
                                     tolerance_kinds)

N_EVENTS = 2048
CHUNK = 128
WIDTHS = dict(batch=128, slots=16)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _solo_scale(app: str, tid: str, feed, chunks):
    """The grouped tenant alone on the CPU engine: its rows, its compiled
    query and the tolerance scale of every step it took."""
    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(app, playback=True)
    rows = []
    rt.add_callback(mw.tenant_out(tid), StreamCallback(
        lambda evs: rows.extend((e.timestamp, list(e.data)) for e in evs)))
    q = rt.device_bridges[0].runtime.compiled
    step, sc = q.step_tensors, [Scale()]

    def scaled(state, cols, ts, valid):
        sc[0] = next_scale(q, sc[0], state, cols, ts, valid)
        return step(state, cols, ts, valid)

    q.step_tensors = scaled
    rt.start()
    for c, ts in chunks:
        rt.input_handler(feed[0]).send_rows(c, ts)
    rt.flush_device()
    m.shutdown()
    return rows, q, sc[0]


@pytest.mark.cuda
def test_device_tenants_migrate_on_the_card_as_on_the_cpu(tmp_path):
    _card()
    tenants = list(mw.DEVICE_TENANTS)
    apps = {t: mw.tenant_app(t, **WIDTHS) for t in tenants}
    feeds = {t: mw.tenant_feed(t, N_EVENTS, 7) for t in tenants}
    chunks = {t: mw.tenant_chunks(feeds[t], CHUNK) for t in tenants}
    movers = ["mesh-gl-0", "mesh-chain-0"]
    out = {}
    for device in ("cpu", None):
        fab = MeshFabric(2, str(tmp_path / str(device)),
                         MeshConfig(capacity_per_host=4), device=device)
        before = (BlockPlan.launches, QueryPlan.launches)
        try:
            out[device] = mw.run_migration(fab, apps, feeds, chunks,
                                           len(chunks[tenants[0]]) // 2,
                                           movers)
            assert all(h.manager.device.type == ("cpu" if device else "cuda")
                       for h in fab.hosts.values())
        finally:
            fab.close()
        launched = (BlockPlan.launches - before[0],
                    QueryPlan.launches - before[1])
        if device is None:
            assert launched[0] > 0 and launched[1] > 0, launched
        else:
            assert launched == (0, 0), launched
        rep = out[device]["report"]
        assert rep["migrations"] == 2 and rep["dup_chunks"] == 0
    cpu, card = out["cpu"]["rows"], out[None]["rows"]
    for t in tenants:
        assert card[t], t
        if mw.DEVICE_TENANTS[t] == "chain":
            assert card[t] == cpu[t], t
            continue
        solo, q, sc = _solo_scale(apps[t], t, feeds[t], chunks[t])
        assert solo == cpu[t], t
        assert [x for x, _ in card[t]] == [x for x, _ in cpu[t]], t
        kinds = tolerance_kinds(q)
        cnt = next(i for i, s in enumerate(q.specs) if s.kind == "count")
        counts = np.array([r[cnt] for _, r in cpu[t]])
        for i, s in enumerate(q.specs):
            check_close(f"{t}: {s.name}", np.array([r[i] for _, r in cpu[t]]),
                        np.array([r[i] for _, r in card[t]]), kinds[s.name],
                        sc, counts)
