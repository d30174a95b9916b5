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

``iot_durable`` and ``iot_adaptive_edge`` (``chip_smoke.py``'s
``engine_io`` phase) take ``iot_mixed``'s events through the IO and flow
tiers: ``iot_durable`` reads ``Raw`` from an in-memory source fed
``RowsChunk``s of ``IO_CHUNK`` events, logs it to a write-ahead log behind
a blocking credit gate, runs the chain (B1) and the grouped
``length(4096)`` (B5a) on the device, publishes their rows through an
in-memory ``json`` and ``passThrough`` sink, and counts the alerts in an
interpreter time window; ``iot_adaptive_edge`` reads the same events as CSV
lines from a file source (the native parse into ``send_columns``) into the
grouped ``length(4096)`` on the async driver, with a latency-mode
``@app:adaptive`` controller setting its flush threshold.

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


def chain_text(stream: str, n_states: int = 8) -> tuple[str, str]:
    """The rising chain's states (``e1=S[v > 90.0] -> e2=S[v > e1.v] ->
    ...``) over ``stream`` and its select list (``e1.v as v1, ...``)."""
    states = " -> ".join(
        f"e{i}={stream}[v > e{i-1}.v]" if i > 1 else f"e1={stream}[v > 90.0]"
        for i in range(1, n_states + 1))
    return states, ", ".join(f"e{i}.v as v{i}"
                             for i in range(1, n_states + 1))


def chain_app(n_states: int = 8, device: str = "") -> str:
    states, sel = chain_text("S", n_states)
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
    states, sel = chain_text("S")
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


# ------------------------------------------------------------ engine_io

IO_EVENTS = 262_144           # 64 chunks of IO_CHUNK
IO_CHUNK = 4096               # events per RowsChunk on the source's topic
IO_SINKS = ("Alerts", "Stats")
IO_TAIL = 100                 # events of the CSV file's last read


def iot_durable_app(wal_dir: str, tag: str, chain_batch: int = 2048,
                    slots: int = 64, stats_batch: int = 4096,
                    stats_window: int = 4096, capacity: int = 16384,
                    segment_bytes: int = 1 << 20) -> str:
    """``iot_durable`` at the engine's full widths by default (WAL segments
    of 1 MiB, the WAL's default). ``tag`` names the transport topics
    (``iot-raw-<tag>``, ``iot-alerts-<tag>``, ``iot-stats-<tag>``), so an
    abandoned runtime's source never sees a later runtime's feed."""
    states, sel = chain_text("Raw")
    alerts = ", ".join(f"v{i} double" for i in range(1, 9))
    return f"""
@app:name('iot_durable')
@app:wal(dir='{wal_dir}', fsync='false', streams='Raw', segment.bytes='{segment_bytes}')
@app:backpressure(capacity='{capacity}', policy='block', streams='Raw')
@source(type='inMemory', topic='iot-raw-{tag}', @map(type='passThrough'))
define stream Raw (dev string, room int, v double);
@sink(type='inMemory', topic='iot-alerts-{tag}', @map(type='json'))
define stream Alerts ({alerts});
@sink(type='inMemory', topic='iot-stats-{tag}', @map(type='passThrough'))
define stream Stats (dev string, total double, n long);
@info(name='chain') @device(batch='{chain_batch}', slots='{slots}', strict='true')
from every {states} within 4000
select {sel} insert into Alerts;
@info(name='stats') @device(batch='{stats_batch}', window='{stats_window}', strict='true')
from Raw[v >= 0.0]#window.length({stats_window})
select dev, sum(v) as total, count() as n group by dev insert into Stats;
@info(name='alert_rate')
from Alerts#window.time(10 sec) select count() as alerts insert into AlertRate;
"""


def iot_adaptive_edge_app(csv_path: str, chunk_bytes: int,
                          adaptive: bool = True, batch: int = 4096,
                          window: int = 4096) -> str:
    """``iot_adaptive_edge``: the file source reads ``csv_path`` in reads of
    ``chunk_bytes``; a latency-mode controller with a 50 ms detection
    budget, starting at its floor of 256 events, sets the grouped
    ``length(4096)``'s flush threshold. Without ``adaptive``, the same app
    at its static batch (the run that checks it)."""
    ann = "@app:adaptive(latency.target.ms='50', min='256')" \
        if adaptive else ""
    return f"""
@app:name('iot_adaptive_edge')
{ann}
@source(type='file', file='{csv_path}', chunk.bytes='{chunk_bytes}',
        @map(type='csv', ts.last='true'))
define stream Raw (dev string, room int, v double);
@info(name='stats') @device(batch='{batch}', window='{window}', strict='true', async='true')
from Raw[v >= 0.0]#window.length({window})
select dev, sum(v) as total, count() as n group by dev insert into Stats;
"""


def iot_chunks(ev: IotEvents, lo: int, hi: int, chunk: int = IO_CHUNK):
    """Events ``lo:hi`` as ``RowsChunk``s of ``chunk`` events."""
    from ..core.columns import RowsChunk
    dev = np.array(ev.dev, dtype=object)
    room = np.array(ev.room, dtype=np.int32)
    v = np.array(ev.v, dtype=np.float64)
    ts = np.array(ev.ts, dtype=np.int64)
    for a in range(lo, hi, chunk):
        b = min(a + chunk, hi)
        yield RowsChunk({"dev": dev[a:b], "room": room[a:b], "v": v[a:b]},
                        ts[a:b], b - a)


def iot_csv(ev: IotEvents) -> tuple[bytes, int]:
    """The events as CSV lines ``dev,room,v,ts`` and the byte length of all
    but the last ``IO_TAIL`` lines: a file source reading that many bytes at
    a time takes the tail in a read of its own, so the feed ends with a
    batch shorter than any flush threshold."""
    lines = [f"{d},{r},{v!r},{t}\n" for d, r, v, t in
             zip(ev.dev, ev.room, ev.v, ev.ts)]
    head = sum(len(x) for x in lines[:-IO_TAIL])
    return "".join(lines).encode(), head


def collect_sinks(broker, tag: str) -> tuple[dict, list]:
    """``{stream: [payload, ...]}`` of ``iot_durable``'s sink topics under
    ``tag`` (a ``json`` payload as its string, a ``passThrough`` event as
    ``(ts, data)``), and the unsubscribe calls."""
    got = {s: [] for s in IO_SINKS}
    unsubs = []
    for s in IO_SINKS:
        def take(p, rows=got[s]):
            rows.append(p if isinstance(p, str)
                        else (p.timestamp, list(p.data)))
        unsubs.append(broker.subscribe(f"iot-{s.lower()}-{tag}", take))
    return got, unsubs
