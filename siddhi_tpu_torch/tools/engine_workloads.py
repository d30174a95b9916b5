"""The engine workloads: each device path's configuration at full width as a
SiddhiQL app built by ``SiddhiManager`` (``@device(strict='true')``), the
same port runtime class to drive directly, and their feeds.

``chip_smoke.py``'s ``engine`` phase drives each through the engine
(``create_siddhi_app_runtime(app, playback=True)`` → ``InputHandler`` →
junction → ``DeviceQueryBridge`` → kernel → ``StreamCallback``) and the
direct runtime with the same events, and holds the two against each other.

- ``chain`` (B1): the main path's 8-state rising chain without its
  partition (one lane), ``batch='2048', slots='64'``, ``bench.py``'s
  traffic, fed per event through ``InputHandler.send``;
- ``scan`` (B4): the scan path's two-stream app without its partition,
  ``batch='2048', slots='64'``, fed per event;
- ``grouped_length`` (B5a), ``time_batch`` and ``lossy_frequent`` (B5b):
  ``tools/query_workloads.py``'s (a), (c) and (d) at their capacities, fed
  through ``InputHandler.send_columns`` in chunks of ``COLUMN_CHUNK``
  events (a multiple of the batch, so both sides encode the same slices);
- ``market_join`` (B6): ``tools/join_workloads.py``'s (e), fed per event;
- ``trade_rollup`` (B7): ``tools/agg_workloads.py``'s (g) as a ``define
  aggregation`` with ``@device``, fed through ``send_columns`` (the
  aggregation takes events one by one from its junction), its rows read
  with ``rt.query`` per duration.

The direct runtimes take the same events one by one (``send`` /
``receive``) or as the same column slices (``append_columns``), so string
codes and micro-batch boundaries are the engine's own.

``iot_mixed`` (``chip_smoke.py``'s ``engine_host`` phase) is per-device IoT
telemetry in which the host interpreter and the kernels share one engine:
an interpreter filter cleans ``Raw`` into ``S``; ``chain`` (B1) and
``stats`` (B5a) step on the device and read ``S``; ``alert_rate`` (an
interpreter time window) reads the chain's ``Alerts``; ``top`` asks for the
device but its ``order by``/``limit`` send it to the interpreter; a
partition by room keeps a per-room peak. 256 devices, 16 rooms, ``v``
uniform on [0, 100) to 3 decimals with 1 % error readings of -1.0 that
``clean`` drops, ``ts`` rising by 1 ms an event, fed per event through
``InputHandler.send``.
"""

from __future__ import annotations

import numpy as np

COLUMN_CHUNK = 65536          # events per send_columns call
BIG_TS = 99_999_999_999_999   # the on-demand window's end: every bucket

N_KEYS = 256


def chain_app(n_states: int = 8, device: str = "") -> str:
    states = " -> ".join(
        f"e{i}=S[v > e{i-1}.v]" if i > 1 else "e1=S[v > 90.0]"
        for i in range(1, n_states + 1))
    sel = ", ".join(f"e{i}.v as v{i}" for i in range(1, n_states + 1))
    return f"""
define stream S (dev string, v double);
{device}
from every {states} within 4000
select {sel} insert into Alerts;
"""


SCAN_BODY = """
define stream Temp (dev string, v double);
define stream Reg (dev string, action string);
{device}
from every e1=Temp[v > 90.0] -> e2=Temp[v > e1.v] and e3=Reg[action == 'on']
  -> e4=Temp[v > e2.v]<2:4> -> e5=Temp[v < e1.v] within 4000
select e1.dev as dev, e1.v as v1, e3.action as a, e5.v as v5 insert into Alerts;
"""

NFA_DEVICE = "@device(batch='2048', slots='64', strict='true')"


def _with_device(app: str, ann: str) -> str:
    """``ann`` before the app's one ``from``."""
    head, sep, tail = app.partition("\nfrom ")
    return f"{head}\n{ann}{sep}{tail}"


def engine_config(name: str) -> dict:
    """``{"app", "out", "kind", "batch"}`` plus what the direct runtime
    needs."""
    from . import agg_workloads as aw
    from .join_workloads import CAPS, JOIN_MAIN
    from .query_workloads import QUERY_MAIN
    if name == "chain":
        return dict(app=chain_app(device=NFA_DEVICE), out="Alerts",
                    kind="nfa", batch=2048, slots=64)
    if name == "scan":
        return dict(app=SCAN_BODY.format(device=NFA_DEVICE), out="Alerts",
                    kind="nfa", batch=2048, slots=64)
    if name in QUERY_MAIN:
        cfg = dict(QUERY_MAIN[name])
        app = cfg.pop("app")
        stream = cfg.pop("stream")
        B = cfg["batch_capacity"]
        ann = f"@device(batch='{B}'"
        if "window_capacity" in cfg:
            ann += f", window='{cfg['window_capacity']}'"
        ann += ", strict='true')"
        out = app.split("insert into ")[1].split(";")[0].strip()
        return dict(app=_with_device(app, ann), out=out, kind="query",
                    batch=B, stream=stream, direct=cfg)
    if name in JOIN_MAIN:
        app = JOIN_MAIN[name]["app"]
        ann = (f"@device(batch='{CAPS['batch_capacity']}', "
               f"ring='{CAPS['ring_capacity']}', "
               f"joined='{CAPS['joined_capacity']}', strict='true')")
        return dict(app=_with_device(app, ann), out="O", kind="join",
                    batch=CAPS["batch_capacity"], direct=dict(CAPS))
    if name in aw.AGG_MAIN:
        return dict(app=aw.AGG_MAIN[name]["app"], out=None, kind="agg",
                    batch=aw.BATCH, agg=aw.AGG_MAIN[name]["agg"])
    raise KeyError(name)


ENGINE_APPS = ["chain", "scan", "grouped_length", "time_batch",
               "lossy_frequent", "market_join", "trade_rollup"]


class EngineEvents:
    """One app's seeded events: ``n`` of them, per event as ``(stream id,
    row, ts)`` (``per_event``) and, for single-stream apps, as columns
    (``cols``, ``ts``)."""

    def __init__(self, name: str, n: int, seed: int):
        self.name = name
        self.n = n
        self.cols = self.ts = None
        self.stream = None
        self._events = None
        self._make(seed)

    def _make(self, seed: int) -> None:
        from . import agg_workloads as aw
        from .join_workloads import JOIN_MAIN, join_events
        from .query_workloads import QUERY_MAIN, query_events
        name, n = self.name, self.n
        rng = np.random.default_rng(seed)
        if name == "chain":
            # bench.py's distribution, as chip_smoke.py's gen_events
            names = np.array([f"dev{k}" for k in range(N_KEYS)])
            dev = names[rng.integers(0, N_KEYS, n)]
            v = np.round(rng.uniform(0.0, 100.0, n), 3)
            ts = 1_000_000 + np.arange(n, dtype=np.int64)
            self._events = ("S", None, dev.tolist(), v.tolist(), ts.tolist())
        elif name == "scan":
            # chip_smoke.py's scan_events
            keys = np.array([f"dev{k}" for k in range(N_KEYS)])
            dev = keys[rng.integers(0, N_KEYS, n)]
            is_temp = rng.random(n) < 0.9
            v = np.round(rng.uniform(0.0, 100.0, n), 3)
            action = np.where(rng.random(n) < 0.5, "on", "off")
            ts = 1_000_000 + np.cumsum(rng.integers(0, 3, n))
            sids = np.where(is_temp, "Temp", "Reg")
            second = np.where(is_temp, v.astype(object), action.astype(object))
            self._events = ("*", sids.tolist(), dev.tolist(), second.tolist(),
                            ts.tolist())
        elif name in QUERY_MAIN:
            self.cols, self.ts = query_events(name, n, seed)
            self.stream = QUERY_MAIN[name]["stream"]
        elif name in JOIN_MAIN:
            ev = join_events(name, n, seed)
            sids, rows, tss = [], [], []
            names = {sid: list(ev.cols[sid]) for sid in ev.streams}
            for sid, lo, hi in ev.runs():
                cols = [ev.cols[sid][a][lo:hi].tolist() for a in names[sid]]
                sids.extend([sid] * (hi - lo))
                rows.extend(list(r) for r in zip(*cols))
                tss.extend(ev.ts[sid][lo:hi].tolist())
            self._events = ("rows", sids, rows, tss)
        elif name in aw.AGG_MAIN:
            ev = aw.agg_events(name, n, seed)
            self.stream = "TradeStream" if name == "trade_rollup" \
                else "SensorStream"
            self.ts = ev.pop("arrival")
            self.cols = ev
        else:
            raise KeyError(name)

    def per_event(self, lo: int = 0, hi: int | None = None):
        """``(stream id, row, ts)`` for events ``lo:hi``."""
        hi = self.n if hi is None else min(hi, self.n)
        ev = self._events
        if ev is None:                  # single-stream columns
            names = list(self.cols)
            cols = [self.cols[a][lo:hi].tolist() for a in names]
            for row, t in zip(zip(*cols), self.ts[lo:hi].tolist()):
                yield self.stream, list(row), t
            return
        if ev[0] == "S":
            _, _, dev, v, ts = ev
            for i in range(lo, hi):
                yield "S", [dev[i], v[i]], ts[i]
        elif ev[0] == "*":
            _, sids, dev, second, ts = ev
            for i in range(lo, hi):
                yield sids[i], [dev[i], second[i]], ts[i]
        else:
            _, sids, rows, ts = ev
            for i in range(lo, hi):
                yield sids[i], rows[i], ts[i]


def feed_engine(rt, ev: EngineEvents, lo: int = 0,
                hi: int | None = None) -> None:
    """Events ``lo:hi`` into an engine runtime: per event through
    ``InputHandler.send``, or as ``send_columns`` chunks where the app
    takes columns (single-stream queries and the aggregation)."""
    hi = ev.n if hi is None else min(hi, ev.n)
    if ev.cols is not None:
        ih = rt.input_handler(ev.stream)
        for a in range(lo, hi, COLUMN_CHUNK):
            b = min(a + COLUMN_CHUNK, hi)
            ih.send_columns({k: c[a:b] for k, c in ev.cols.items()},
                            ev.ts[a:b])
        return
    handlers = {}
    for sid, row, ts in ev.per_event(lo, hi):
        ih = handlers.get(sid)
        if ih is None:
            ih = handlers[sid] = rt.input_handler(sid)
        ih.send(row, timestamp=ts)


def direct_runtime(name: str, device="cuda"):
    """The port runtime class the engine's bridge wraps, built on its own
    from the same app text and capacities."""
    cfg = engine_config(name)
    kind = cfg["kind"]
    if kind == "nfa":
        from ..gpu.nfa import DeviceNFARuntime
        return DeviceNFARuntime(cfg["app"], slot_capacity=cfg["slots"],
                                batch_capacity=cfg["batch"], device=device)
    if kind == "query":
        from ..gpu.runtime import DeviceStreamRuntime
        return DeviceStreamRuntime(cfg["app"], device=device, **cfg["direct"])
    if kind == "join":
        from ..gpu.join_compile import DeviceJoinRuntime
        return DeviceJoinRuntime(cfg["app"], device=device, **cfg["direct"])
    from . import agg_workloads as aw
    return aw.build_runtime(name, device=device)


def feed_direct(drt, ev: EngineEvents, name: str) -> list:
    """Every event into the direct runtime as the engine hands them on
    (``send`` per event; ``append_columns`` over the same slices; the
    aggregation's ``receive`` per event), then the last partial batch.
    Returns the rows (none for the aggregation)."""
    kind = engine_config(name)["kind"]
    if kind == "agg":
        from ..core.event import StreamEvent
        for _, row, ts in ev.per_event():
            drt.receive(StreamEvent(ts, row))
        drt._flush_device()
        return []
    rows: list = []
    drt.add_callback(rows.extend)
    if kind == "query":
        for a in range(0, ev.n, COLUMN_CHUNK):
            b = min(a + COLUMN_CHUNK, ev.n)
            cols = {k: c[a:b] for k, c in ev.cols.items()}
            ts, start = ev.ts[a:b], 0
            while start < b - a:
                start += drt.builder.append_columns(cols, ts, start)
                if drt.builder.full:
                    drt.flush()
        drt.flush()
        return rows
    for sid, row, ts in ev.per_event():
        drt.send(sid, row, ts)
    drt.flush()
    return rows


def on_demand_texts(name: str, attrs: list[str]) -> list[str]:
    """The aggregation's on-demand reads of ``attrs``, one per duration."""
    from ..compiler import parse
    from . import agg_workloads as aw
    cfg = aw.AGG_MAIN[name]
    d = parse(cfg["app"]).aggregation_definitions[cfg["agg"]]
    sel = ", ".join(attrs)
    return [f"from {cfg['agg']} within 0L, {BIG_TS}L per '{du.value}' "
            f"select {sel}" for du in d.durations]


# ------------------------------------------------------------ iot_mixed

IOT_DEVICES = 256
IOT_ROOMS = 16
IOT_ERROR_SHARE = 0.01
IOT_OUTS = ["Alerts", "Stats", "AlertRate", "Top", "RoomPeak"]


def iot_mixed_app(chain_batch: int = 2048, slots: int = 64,
                  stats_batch: int = 4096, stats_window: int = 4096,
                  top_batch: int = 4096, raw_async: bool = False) -> str:
    """The mixed app at the engine's full widths by default; smaller
    capacities for a run on the CPU. ``raw_async`` puts ``@async`` on
    ``Raw``."""
    states = " -> ".join(
        f"e{i}=S[v > e{i-1}.v]" if i > 1 else "e1=S[v > 90.0]"
        for i in range(1, 9))
    sel = ", ".join(f"e{i}.v as v{i}" for i in range(1, 9))
    raw = "@async(buffer.size='1024')\n" if raw_async else ""
    return f"""
{raw}define stream Raw (dev string, room int, v double);
@info(name='clean')
from Raw[v >= 0.0] select dev, v insert into S;
@info(name='chain') @device(batch='{chain_batch}', slots='{slots}', strict='true')
from every {states} within 4000
select {sel} insert into Alerts;
@info(name='stats') @device(batch='{stats_batch}', window='{stats_window}', strict='true')
from S#window.length({stats_window}) select dev, sum(v) as total, count() as n
group by dev insert into Stats;
@info(name='alert_rate')
from Alerts#window.time(10 sec) select count() as alerts insert into AlertRate;
@info(name='top') @device(batch='{top_batch}')
from Raw#window.lengthBatch({top_batch}) select dev, max(v) as peak group by dev
order by peak desc limit 8 insert into Top;
partition with (room of Raw) begin
  @info(name='room_peak') from Raw#window.length(64) select room, max(v) as peak
  insert into RoomPeak;
end;
"""


class IotEvents:
    """``n`` seeded ``Raw`` events: ``dev`` (256 devices), ``room`` (16),
    ``v`` and ``ts`` as lists, in order."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        names = np.array([f"dev{k}" for k in range(IOT_DEVICES)])
        self.n = n
        self.dev = names[rng.integers(0, IOT_DEVICES, n)].tolist()
        self.room = rng.integers(0, IOT_ROOMS, n).tolist()
        v = np.round(rng.uniform(0.0, 100.0, n), 3)
        v[rng.random(n) < IOT_ERROR_SHARE] = -1.0
        self.v = v.tolist()
        self.ts = (1_000_000 + np.arange(n, dtype=np.int64)).tolist()


def feed_iot(rt, ev: IotEvents, lo: int = 0, hi: int | None = None) -> None:
    """Events ``lo:hi`` into ``Raw``, one ``InputHandler.send`` each."""
    hi = ev.n if hi is None else min(hi, ev.n)
    ih = rt.input_handler("Raw")
    dev, room, v, ts = ev.dev, ev.room, ev.v, ev.ts
    for i in range(lo, hi):
        ih.send([dev[i], room[i], v[i]], timestamp=ts[i])


def collect_outputs(rt, callback_cls) -> dict:
    """``{stream: [(ts, data), ...]}`` for every output stream of
    ``iot_mixed``, filled by ``callback_cls`` (the engine's
    ``StreamCallback``)."""
    got = {s: [] for s in IOT_OUTS}
    for s in IOT_OUTS:
        rt.add_callback(s, callback_cls(lambda evs, rows=got[s]: rows.extend(
            (e.timestamp, list(e.data)) for e in evs)))
    return got
