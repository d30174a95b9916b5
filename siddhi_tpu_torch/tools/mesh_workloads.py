"""The mesh workloads: the JAX package bench's mesh tenants and feeder, and
the device tenants of ``chip_smoke.py``'s ``mesh`` phase.

- ``mesh_shape_app`` / ``mesh_kleene_app`` / ``mesh_feed_all``: copies of
  the reference bench's ``_mesh_shape_app``, ``_mesh_kleene_app`` and
  ``_mesh_feed_all`` (``bench.py``, its mesh scenario): fleet tenants of
  ``shapes`` structural shapes (filter conjuncts and select width vary,
  thresholds are per-tenant constants), the Kleene rising chain, and the
  per-host feeder threads that drive every tenant's chunks through
  ``MeshFabric.send``;
- ``DEVICE_TENANTS``: the ``@device`` tenants, two of
  ``engine_config("grouped_length")`` (B5a, ``csrc/query_step.cu``) and two
  of ``engine_config("chain")`` (B1, ``csrc/nfa_block.cu``) at the engine
  phase's widths, each under its own ``@app(name=...)``; ``tenant_feed``
  gives a tenant's rows (the grouped window's ``query_events``, the chain's
  ``rising_events``), ``tenant_chunks`` cuts them for ``MeshFabric.send``
  and ``solo_rows`` runs one tenant alone on one manager.
"""

from __future__ import annotations

import re
import threading
import time

from .engine_workloads import engine_config, rising_events
from .fleet_workloads import gen_events  # noqa: F401 — the placement feed

MESH_HOSTS = 2                 # hosts of the placement scenario (one card)
MESH_PLACE_TENANTS = 1024      # the reference bench's population
MESH_SHAPES = 8
MESH_PLACE_FEED = 256          # events of the placement feed
MESH_CHUNK = 64                # events a send in the placement scenario

# tenant id → its engine configuration (the kernel it steps)
DEVICE_TENANTS = {"mesh-gl-0": "grouped_length",
                  "mesh-gl-1": "grouped_length",
                  "mesh-chain-0": "chain",
                  "mesh-chain-1": "chain"}


def mesh_shape_app(i: int, shape: int, ann: str) -> str:
    """Tenant i of structural shape ``shape``: filter conjunct count and
    select-list length are STRUCTURAL (different fleet fingerprints), the
    thresholds stay per-tenant constants (hoisted to params — tenants of
    one shape still share one compiled program)."""
    terms = " and ".join(
        [f"v > {80.0 + i % 8}"] + [f"v < {200.0 + j}"
                                   for j in range(shape % 4)])
    sel = ", ".join(["dev", "v"] + [f"v * {1.5 + j} as x{j}"
                                    for j in range(shape // 4 + 1)])
    return (f"@app(name='mtenant-{i}')\n{ann}"
            f"define stream S (dev string, v double);\n"
            f"@info(name='rule')\n"
            f"from S[{terms}] select {sel} insert into Alerts;\n")


def mesh_kleene_app(i: int, ann: str) -> str:
    """Tenant i's Kleene anomaly rule: the rising chain over the
    partitioned synthetic IoT stream, sized for the fleet tier."""
    return (f"@app(name='kleene-{i}')\n{ann}"
            f"define stream S (dev string, v double);\n"
            f"partition with (dev of S)\nbegin\n"
            f"from every e1=S[v > {90.0 + (i % 8) * 0.25}] -> e2=S[v > e1.v]"
            f" -> e3=S[v > e2.v] within 4000\n"
            f"select e1.v as v1, e2.v as v2, e3.v as v3 insert into Alerts;"
            f"\nend;\n")


def mesh_feed_all(fabric, tenant_ids, rows, tss, chunk) -> float:
    """Per-host feeder threads drive every tenant's chunks through the
    fabric ingress (each host's tenants fed from one thread — the
    per-host DCN-ingest model). Returns wall seconds."""
    by_host: dict = {}
    for t in tenant_ids:
        by_host.setdefault(fabric.tenants[t].host, []).append(t)

    def feed(tids):
        for s in range(0, len(rows), chunk):
            c = rows[s:s + chunk]
            t = tss[s:s + chunk]
            for tid in tids:
                fabric.send(tid, "S", c, t)

    t0 = time.perf_counter()
    ths = [threading.Thread(target=feed, args=(tids,))
           for tids in by_host.values()]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    fabric.flush()
    return time.perf_counter() - t0


def tenant_app(tenant_id: str, batch: int | None = None,
               slots: int | None = None, statistics: bool = False) -> str:
    """A device tenant's app: its engine configuration's, named; ``batch``
    and ``slots`` replace its ``@device`` widths (a rehearsal's small
    sizes); ``statistics`` turns on the app's trackers (the device step
    probe's ``device.<query>.steps_total`` gauge, which a worker process's
    ``metrics`` op ships)."""
    app = engine_config(DEVICE_TENANTS[tenant_id])["app"]
    if batch is not None:
        app = re.sub(r"batch='\d+'", f"batch='{batch}'", app)
    if slots is not None:
        app = re.sub(r"slots='\d+'", f"slots='{slots}'", app)
    stats = ", statistics='true'" if statistics else ""
    return f"@app(name='{tenant_id}'{stats})\n" + app


def tenant_feed(tenant_id: str, n: int, seed: int) -> tuple:
    """``(stream id, rows, timestamps)`` of a device tenant's ``n`` events,
    seeded by the tenant's index: the grouped window takes
    ``query_events("grouped_length", ...)`` (Zipf symbols, price, volume),
    the chain ``rising_events`` (the bench's stream with rising runs)."""
    from .query_workloads import query_events
    seed = seed + int(tenant_id.rsplit("-", 1)[1])
    if DEVICE_TENANTS[tenant_id] == "chain":
        dev, v, ts = rising_events(n, seed)
        return "S", [list(r) for r in zip(dev.tolist(), v.tolist())], \
            ts.tolist()
    cols, ts = query_events("grouped_length", n, seed)
    return "Ticks", [list(r) for r in zip(cols["sym"].tolist(),
                                          cols["price"].tolist(),
                                          cols["vol"].tolist())], ts.tolist()


def tenant_chunks(feed: tuple, chunk: int, lo: int = 0,
                  hi: int | None = None) -> list:
    """``(rows, timestamps)`` chunks of events ``lo:hi`` of a feed."""
    _, rows, tss = feed
    hi = len(rows) if hi is None else hi
    return [(rows[a:min(a + chunk, hi)], tss[a:min(a + chunk, hi)])
            for a in range(lo, hi, chunk)]


def tenant_out(tenant_id: str) -> str:
    return engine_config(DEVICE_TENANTS[tenant_id])["out"]


def tenant_counters(rt) -> dict:
    """A device tenant's kernel counters: the NFA's matches and drops, the
    grouped window's group collisions."""
    drt = rt.device_bridges[0].runtime
    if hasattr(drt, "drop_count"):
        return {"matches": drt.match_count, "drops": drt.drop_count}
    c = drt.state.get("group_collisions")
    return {"group_collisions": 0 if c is None else int(c)}


def solo_rows(manager, tenant_id: str, feed: tuple, chunks: list,
              app: str | None = None) -> dict:
    """One device tenant alone on ``manager`` (its ``app``, by default
    ``tenant_app``'s), fed ``chunks`` through ``send_rows`` as the fabric
    applies them: ``{"rows": [(ts, data)], "counters", "seconds"}`` (the
    runtime shut down)."""
    from ..core.stream import StreamCallback
    rt = manager.create_siddhi_app_runtime(app or tenant_app(tenant_id),
                                           playback=True)
    rows: list = []
    rt.add_callback(tenant_out(tenant_id), StreamCallback(
        lambda evs: rows.extend((e.timestamp, list(e.data)) for e in evs)))
    rt.start()
    ih = rt.input_handler(feed[0])
    t0 = time.perf_counter()
    for c, t in chunks:
        ih.send_rows(c, t)
    rt.flush_device()
    seconds = time.perf_counter() - t0
    counters = tenant_counters(rt)
    rt.shutdown()
    return {"rows": rows, "counters": counters, "seconds": seconds}


# ------------------------------------------------ the device tenants' scripts
#
# Each drives a fabric of either package (only the fabric's public surface:
# add_tenants, add_callback, send, migrate, kill_host, recover_tenant) and
# returns every tenant's rows as (timestamp, data), in order.

def deploy_tenants(fab, apps: dict) -> dict:
    """Places and deploys ``apps`` (tenant id → app text) and collects each
    tenant's output rows through a callback that survives its moves."""
    fab.add_tenants([apps[t] for t in apps])
    rows = {t: [] for t in apps}
    for t in apps:
        fab.add_callback(t, tenant_out(t), lambda evs, r=rows[t]: r.extend(
            (e.timestamp, list(e.data)) for e in evs))
    return rows


def other_host(fab, tenant_id: str) -> int:
    """The first live host that does not own the tenant."""
    own = fab.tenants[tenant_id].host
    return next(h for h in sorted(fab.hosts)
                if h != own and fab.hosts[h].alive)


def flush_devices(fab) -> None:
    """Steps every live tenant's partial device batch (``MeshFabric.flush``
    drains the host tiers only). A tenant in a worker process (process
    mode) has no such op: its batches step as they fill, so a script over
    a process fabric cuts every feed on its tenants' batch boundaries."""
    for h in fab.hosts.values():
        if h.alive:
            for rt in list(h.runtimes.values()):
                if not getattr(rt, "procmesh_proxy", False):
                    rt.flush_device()


def send_round(fab, feeds: dict, chunks: dict, k: int) -> None:
    """Chunk ``k`` of every tenant, tenant by tenant."""
    for t, cs in chunks.items():
        rows, tss = cs[k]
        fab.send(t, feeds[t][0], rows, tss)


def run_migration(fab, apps: dict, feeds: dict, chunks: dict, at: int,
                  movers: list) -> dict:
    """Every tenant's chunks in rounds; before round ``at`` the main thread
    migrates each of ``movers`` to the other host. ``send_s`` is the time
    inside ``fab.send``, the moves out of it; ``prefix[k]`` each tenant's
    row count after round ``k``."""
    rows = deploy_tenants(fab, apps)
    rounds = len(next(iter(chunks.values())))
    send_s = move_s = 0.0
    moved, prefix = {}, []
    for k in range(rounds):
        if k == at:
            t0 = time.perf_counter()
            for t in movers:
                src, dst = fab.tenants[t].host, other_host(fab, t)
                fab.migrate(t, dst, reason="script")
                moved[t] = (src, fab.tenants[t].host)
            move_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        send_round(fab, feeds, chunks, k)
        send_s += time.perf_counter() - t0
        prefix.append({t: len(r) for t, r in rows.items()})
    t0 = time.perf_counter()
    flush_devices(fab)
    send_s += time.perf_counter() - t0
    return {"rows": rows, "send_s": send_s, "move_s": move_s,
            "moved": moved, "prefix": prefix, "report": fab.report()}


def run_live_migration(fab, apps: dict, feeds: dict, chunks: dict,
                       movers: list) -> dict:
    """A feeder thread sends every tenant's chunks while the main thread,
    once half the rounds are in, migrates each of ``movers`` to the other
    host. A failure in either thread raises here."""
    rows = deploy_tenants(fab, apps)
    rounds = len(next(iter(chunks.values())))
    half = threading.Event()
    errors: list = []

    def feeder():
        try:
            for k in range(rounds):
                if k == rounds // 2:
                    half.set()
                send_round(fab, feeds, chunks, k)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            errors.append(e)
        finally:
            half.set()

    t0 = time.perf_counter()
    th = threading.Thread(target=feeder, name="mesh-feeder")
    th.start()
    moved = {}
    try:
        half.wait()
        for t in movers:
            src, dst = fab.tenants[t].host, other_host(fab, t)
            fab.migrate(t, dst, reason="script")
            moved[t] = (src, fab.tenants[t].host)
    finally:
        th.join()
    if errors:
        raise errors[0]
    flush_devices(fab)
    return {"rows": rows, "wall_s": time.perf_counter() - t0,
            "moved": moved, "report": fab.report()}


def run_kill_recover(fab, apps: dict, feeds: dict, chunks: dict,
                     victims: list, kill_at: int, spill: int) -> dict:
    """``victims`` (one tenant of each kernel) are first moved onto one
    host and the others off it; after ``kill_at`` rounds that host is
    killed, ``spill`` rounds go in (the orphans' chunks spill), each orphan
    is recovered onto a live host from its last revision (its spill
    replayed), then the rest of the rounds."""
    rows = deploy_tenants(fab, apps)
    target = fab.tenants[victims[0]].host
    for t in apps:
        own = fab.tenants[t].host
        if (t in victims) != (own == target):
            fab.migrate(t, target if t in victims else other_host(fab, t),
                        reason="script")
    if sorted(fab.hosts[target].runtimes) != sorted(victims):
        raise RuntimeError(f"host {target} holds "
                           f"{sorted(fab.hosts[target].runtimes)}, not "
                           f"{sorted(victims)}")
    rounds = len(next(iter(chunks.values())))
    for k in range(kill_at):
        send_round(fab, feeds, chunks, k)
    orphans = fab.kill_host(target)
    spilled = fab.spilled_chunks
    for k in range(kill_at, kill_at + spill):
        send_round(fab, feeds, chunks, k)
    spilled = fab.spilled_chunks - spilled
    recovered = {t: fab.recover_tenant(t) for t in orphans}
    for k in range(kill_at + spill, rounds):
        send_round(fab, feeds, chunks, k)
    flush_devices(fab)
    return {"rows": rows, "killed": target, "orphans": orphans,
            "recovered_on": recovered, "spilled": spilled,
            "report": fab.report()}


def mesh_counters(fab) -> dict:
    """Every deployed tenant's kernel counters (``tenant_counters``)."""
    out = {}
    for h in fab.hosts.values():
        if h.alive:
            for t, rt in h.runtimes.items():
                out[t] = tenant_counters(rt)
    return out
