"""The multi-tenant fleet workloads at full width: the JAX package's own
fleet scenarios of its ``bench.py`` (the tenant templates at
``bench.py:1091-1116``, the feed and chunking of ``_run_tenant_fleet`` at
``:1119-1188``, the SLO storm of ``child_slo`` at ``:1304-1430`` with its
sizes at ``:94-130``), which ``chip_smoke.py``'s ``engine_fleet`` phase
drives on the port, and the helpers that run a tenant population through a
``SiddhiManager`` and step a shape's shared device plan over batches that
interleave every tenant's rows with per-row parameter columns.

- (a) the rule fleet: 16 tenants of ``tenant_rule_app`` under
  ``@app:fleet(batch='8192', lanes='24')``, 12,000 events fed in
  per-tenant chunks of 16 through ``send_rows``;
- (b) the pattern fleet: 16 tenants of ``tenant_pattern_app`` (a 3-state
  rising chain by ``dev``, a per-tenant ``within``), 4,000 events;
- (d) the SLO storm: 16 tenants, 24,000 events, chunks of 32, one
  best-effort burster at 10× its share, a 100 ms premium budget, an
  opening window of 65,536.

Events are the reference bench's ``gen_events``: 256 device ids, values
U(0, 100) to three decimals, +1 ms an event, from ``seed``.
"""

from __future__ import annotations

import random
import time

import numpy as np

TENANTS = 16
TENANT_FEED = 12_000
TENANT_CHUNK = 16
FLEET_BATCH = 8192
HOST_LANES = 24
FLEET_PATTERN_FEED = 4_000
N_DEVICES_KEYS = 256
SLO_TENANTS = 16
SLO_FEED = 24_000
SLO_CHUNK = 32
SLO_BURST = 10
SLO_BUDGET_MS = 100.0
SLO_BATCH = 65_536

FLEET_ANN = f"@app:fleet(batch='{FLEET_BATCH}', lanes='{HOST_LANES}')\n"
SOLO_ANN = f"@app:host_batch(batch='{FLEET_BATCH}', lanes='{HOST_LANES}')\n"


def gen_events(n: int, seed: int = 42) -> list:
    """``(dev, v, ts)`` per event: the reference bench's synthetic IoT
    stream."""
    rng = random.Random(seed)
    return [(f"dev{rng.randrange(N_DEVICES_KEYS)}",
             round(rng.uniform(0.0, 100.0), 3), 1_000_000 + i)
            for i in range(n)]


def tenant_rule_app(i: int, ann: str) -> str:
    """Tenant i's alert rule: one shape for every tenant, per-tenant
    constants (threshold, device, scale)."""
    return f"""
@app(name='tenant-{i}')
{ann}define stream S (dev string, v double);
@info(name='rule')
from S[v > {85.0 + (i % 8) * 0.25} and dev == 'dev{i % 32}']
select dev, v, v * {1.0 + i * 0.001} as score insert into Alerts;
"""


def tenant_having_app(i: int, ann: str) -> str:
    """Tenant i's rule whose ``having`` reads a hoisted constant (the
    threshold of its score)."""
    return f"""
@app(name='htenant-{i}')
{ann}define stream S (dev string, v double);
@info(name='rule')
from S[dev == 'dev{i % 32}']
select dev, v, v * 2.0 as w having w > {150.0 + i * 1.5} insert into Alerts;
"""


def tenant_pattern_app(i: int, ann: str) -> str:
    """Tenant i's copy of the bench pattern: a 3-state rising chain,
    partitioned by device, with a per-tenant ``within``."""
    return f"""
@app(name='ptenant-{i}')
{ann}define stream S (dev string, v double);
partition with (dev of S)
begin
from every e1=S[v > {90.0 + (i % 8) * 0.25}] -> e2=S[v > e1.v]
    -> e3=S[v > e2.v] within {4000 + 250 * (i % 4)}
select e1.v as v1, e2.v as v2, e3.v as v3 insert into Alerts;
end;
"""


def slo_class(i: int, tenants: int = SLO_TENANTS) -> str:
    if i < tenants // 4:
        return "premium"
    if i >= tenants - max(2, tenants // 4):
        return "besteffort"
    return "standard"


def slo_ann(i: int, tenants: int = SLO_TENANTS,
            batch: int = SLO_BATCH) -> str:
    k = slo_class(i, tenants)
    budget = f", slo.p99.ms='{SLO_BUDGET_MS}'" if k == "premium" else ""
    return (f"@app:fleet(batch='{batch}', lanes='{HOST_LANES}', "
            f"slo.class='{k}'{budget}, slo.interval.ms='2', "
            f"slo.cooldown.ms='100', slo.window.min='256')\n")


def run_tenants(manager, texts: list, feed: list, chunk: int,
                poison: dict | None = None) -> dict:
    """Every tenant app of ``texts`` on ``manager`` over the shared feed,
    per-tenant chunk deliveries through ``send_rows`` (each tenant its own
    row copies); ``poison`` maps a tenant to a function that rewrites its
    chunk. Returns each tenant's ``Alerts`` rows in order, the runtimes and
    the wall seconds of the feed and the drain."""
    from siddhi_tpu_torch import StreamCallback
    rows = [[d, v] for d, v, _ in feed]
    tss = [t for _, _, t in feed]
    apps, got = [], []
    for text in texts:
        rt = manager.create_siddhi_app_runtime(text, playback=True)
        out = []
        rt.add_callback("Alerts", StreamCallback(
            lambda evs, out=out: out.extend(tuple(e.data) for e in evs)))
        rt.start()
        apps.append(rt)
        got.append(out)
    ihs = [rt.input_handler("S") for rt in apps]
    t0 = time.perf_counter()
    for s in range(0, len(feed), chunk):
        c, t = rows[s:s + chunk], tss[s:s + chunk]
        for j, ih in enumerate(ihs):
            part = [list(r) for r in c]
            if poison is not None and j in poison:
                part = poison[j](s, part)
            ih.send_rows(part, list(t))
    for rt in apps:
        rt.flush_host()
    return {"rows": got, "apps": apps, "wall": time.perf_counter() - t0}


def tenant_params(nq, plan_dictionary, index: int) -> list:
    """Tenant ``index``'s bound constants in the device plan's dtypes
    (strings as codes of the plan's dictionary)."""
    out = []
    for spec, val in zip(nq.param_specs, nq.param_values):
        if spec.string:
            out.append(np.int32(plan_dictionary.encode(val)))
        elif spec.type.name in ("FLOAT", "DOUBLE"):
            out.append(np.float32(val))
        elif spec.type.name == "INT":
            out.append(np.int32(val))
        else:
            out.append(np.int64(val))
    return out


def param_dtype(spec):
    if spec.string:
        return np.int32
    return {"FLOAT": np.float32, "DOUBLE": np.float32, "INT": np.int32,
            "LONG": np.int64}[spec.type.name]


def interleaved_rule_batches(plan, nq, params: list, feed: list):
    """The rule fleet's rows of every tenant, interleaved event by event
    (tenant order within an event), as ``BatchBuilder.emit()`` batches of
    the shared plan's width with per-row ``__fleet_p{i}`` columns
    gathered by tenant. Yields ``(batch, tenant ids [B])``."""
    from siddhi_tpu_torch.gpu.batch import BatchBuilder
    T = len(params)
    luts = [np.array([p[i] for p in params], dtype=param_dtype(spec))
            for i, spec in enumerate(nq.param_specs)]
    rows = [[d, v] for d, v, _ in feed for _t in range(T)]
    tss = [t for _, _, t in feed for _t in range(T)]
    mids_all = np.tile(np.arange(T), len(feed))
    B = plan.B
    for s in range(0, len(rows), B):
        b = BatchBuilder(plan.schema, B)
        b.append_rows(rows[s:s + B], tss[s:s + B])
        batch = b.emit()
        mids = np.zeros(B, np.int64)
        n = min(B, len(rows) - s)
        mids[:n] = mids_all[s:s + n]
        cols = dict(batch["cols"])
        for spec, lut in zip(nq.param_specs, luts):
            cols[f"__fleet_p{spec.index}"] = lut[mids]
        yield {**batch, "cols": cols}, mids


def pattern_lane_batches(comp, nq, params: list, feed: list, lanes: int,
                         steps: int):
    """The pattern fleet's rows for the shared blocked plan: one lane per
    (tenant, device-hash lane), so a lane holds one tenant's events of a
    few devices in order (the plan's key equality keeps devices apart, as
    the host group's lanes do), ``steps`` wire batches of ``[T × lanes,
    B]`` with per-row ``__fleet_p{i}`` columns. Yields ``(cols, tag, ts,
    ts_base, counts)`` as numpy arrays."""
    T = len(params)
    L = T * lanes
    B = comp.B
    dic = comp.merged.dictionaries
    key_col = next(k for k in comp.used_cols if k.endswith("_dev"))
    v_col = next(k for k in comp.used_cols if k.endswith("_v"))
    dev_codes = np.array([dic[key_col].encode(d) for d, _, _ in feed],
                         np.int32)
    vs = np.array([v for _, v, _ in feed], np.float32)
    ts = np.array([t for _, _, t in feed], np.int64)
    lane_of_event = dev_codes % lanes
    per_lane = [np.flatnonzero(lane_of_event == k) for k in range(lanes)]
    cut = [np.array_split(idx, steps) for idx in per_lane]
    for step in range(steps):
        cols = {key_col: np.zeros((L, B), np.int32),
                v_col: np.zeros((L, B), np.float32)}
        for i, spec in enumerate(nq.param_specs):
            cols[f"__fleet_p{spec.index}"] = np.zeros(
                (L, B), param_dtype(spec))
        tsd = np.zeros((L, B), np.int32)
        base = np.zeros(L, np.int64)
        counts = np.zeros(L, np.int32)
        for t in range(T):
            for k in range(lanes):
                lane = t * lanes + k
                idx = cut[k][step]
                if len(idx) > B:
                    raise ValueError(f"lane {lane}: {len(idx)} events > B")
                n = len(idx)
                counts[lane] = n
                cols[key_col][lane, :n] = dev_codes[idx]
                cols[v_col][lane, :n] = vs[idx]
                for i, spec in enumerate(nq.param_specs):
                    cols[f"__fleet_p{spec.index}"][lane, :] = params[t][i]
                if n:
                    base[lane] = ts[idx[0]]
                    tsd[lane, :n] = ts[idx] - ts[idx[0]]
        yield cols, np.zeros((L, B), np.int8), tsd, base, counts
