"""The port's IO tier against the JAX package's, on the same apps and inputs.

Every test runs one app, or one mapper, through both engines —
``siddhi_tpu.SiddhiManager()`` and ``siddhi_tpu_torch.SiddhiManager(
device="cpu")`` — with the same seeded inputs, and holds what the port's
callbacks, transports and counters saw equal to the reference's: the source
and sink mappers both ways, the in-memory broker, the file and socket
sources (torn tails, the tail cap, ``format='rows'`` frames), a
``RowsChunk`` through ``send_columns``, rows-capable sinks, distributed
sinks, the sink pipeline's ``on.error`` policies and circuit breaker, and
the source and sink handler managers. Every comparison is exact: the IO
tier moves values, it computes none.
"""

import socket
import struct
import time

import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core import io as port_io

from siddhi_tpu.core import io as ref_io

PKGS = {"ref": siddhi_tpu, "port": siddhi_tpu_torch}
IO = {"ref": ref_io, "port": port_io}


def manager(side: str):
    if side == "port":
        return siddhi_tpu_torch.SiddhiManager(device="cpu")
    return siddhi_tpu.SiddhiManager()


def norm(p):
    """A transport payload of either package as plain data."""
    if hasattr(p, "cols") and hasattr(p, "count"):        # RowsChunk
        return ("chunk", {k: np.asarray(v).tolist() for k, v in p.cols.items()},
                None if p.ts is None else np.asarray(p.ts).tolist(), p.count)
    if hasattr(p, "data") and hasattr(p, "timestamp"):    # Event
        return ("event", p.timestamp, list(p.data), bool(p.is_expired))
    return p


def both(run) -> dict:
    """``run(side, pkg, manager)`` on both engines (each manager shut down
    after, each broker reset) → ``{side: result}``."""
    out = {}
    for side, pkg in PKGS.items():
        m = manager(side)
        try:
            out[side] = run(side, pkg, m)
        finally:
            m.shutdown()
            pkg.InMemoryBroker.reset()
    return out


def rows_of(rt, pkg, stream: str) -> list:
    got = []
    rt.add_callback(stream, pkg.StreamCallback(lambda evs: got.extend(
        (e.timestamp, list(e.data)) for e in evs)))
    return got


def events(n: int, seed: int = 5) -> list:
    """``(dev string, v double, k long, ts)`` rows with nulls."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dev = None if rng.random() < 0.05 else f"dev{rng.integers(12)}"
        v = None if rng.random() < 0.05 else round(float(rng.uniform(0, 100)), 3)
        out.append((dev, v, int(rng.integers(1000)), 1_000 + i))
    return out


def csv_bytes(rows) -> bytes:
    return "".join(f"{'' if d is None else d},{'' if v is None else v},{k},{t}\n"
                   for d, v, k, t in rows).encode()


# ----------------------------------------------------------------- mappers

DEF = "define stream S (dev string, v double, k long, ok bool);"


def stream_def(pkg):
    return pkg.parse(DEF + "\nfrom S select * insert into O;") \
        .stream_definitions["S"]


SOURCE_PAYLOADS = {
    "passThrough": [["a", 1.5, 3, True], [["b", 2.0, 4, False],
                                           ["c", None, 5, True]]],
    "json": ['{"event": {"dev": "a", "v": 1.5, "k": 3, "ok": true}}',
             '[{"dev": "b", "v": 2.0, "k": 4, "ok": false}, '
             '{"event": {"dev": "c", "k": 5}}]'],
    "csv": [b"a,1.5,3,true\nb,,4,0\n,2.5,7,1\n"],
    "jsonLines": ['{"event": {"dev": "a", "v": 1.5, "k": 3, "ok": true}}',
                  '[{"dev": "b", "v": null, "k": 4, "ok": false}]'],
}
ROWS_PAYLOADS = {
    "csv": SOURCE_PAYLOADS["csv"],
    "jsonLines": [b'{"event": {"dev": "a", "v": 1.5, "k": 3, "ok": true}}\n'
                  b'not json\n'
                  b'{"dev": "b", "v": null, "k": 4, "ok": false}\n'],
}


@pytest.mark.parametrize("kind", sorted(SOURCE_PAYLOADS))
def test_source_mapper_map(kind):
    out = {}
    for side, pkg in PKGS.items():
        m = IO[side].SOURCE_MAPPERS[kind]()
        m.init(stream_def(pkg), {})
        out[side] = [[norm(r) for r in m.map(p)]
                     for p in SOURCE_PAYLOADS[kind]]
    assert out["port"] == out["ref"] and out["port"][0]


@pytest.mark.parametrize("kind", ["csv", "jsonLines"])
def test_source_mapper_map_rows(kind):
    out = {}
    for side, pkg in PKGS.items():
        m = IO[side].SOURCE_MAPPERS[kind]()
        m.init(stream_def(pkg), {})
        chunks = [c for p in ROWS_PAYLOADS[kind] for c in m.map_rows(p)]
        names = stream_def(pkg).attribute_names
        out[side] = [(c.rows(names), None if c.ts is None else c.ts.tolist())
                     for c in chunks] + [m.rows_out, m.parse_errors]
    assert out["port"] == out["ref"] and out["port"][0][0]


def test_csv_mapper_ts_last_both_paths():
    rows = events(40)
    out = {}
    for side, pkg in PKGS.items():
        d = pkg.parse("define stream S (dev string, v double, k long);\n"
                      "from S select * insert into O;").stream_definitions["S"]
        m = IO[side].CsvSourceMapper()
        m.init(d, {"ts.last": "true"})
        per_event = [norm(e) for e in m.map(csv_bytes(rows))]
        chunk, = m.map_rows(csv_bytes(rows))
        out[side] = (per_event, chunk.rows(d.attribute_names),
                     chunk.ts.tolist())
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 40


SINK_KINDS = ["passThrough", "json", "text"]


@pytest.mark.parametrize("kind", SINK_KINDS)
def test_sink_mapper_map_and_map_rows(kind):
    out = {}
    for side, pkg in PKGS.items():
        m = IO[side].SINK_MAPPERS[kind]()
        m.init(stream_def(pkg), {})
        ev = pkg.Event(7, ["a", 1.5, 3, True])
        cols = {"dev": np.array(["a", None], dtype=object),
                "v": np.array([1.5, 2.0]), "k": np.array([3, 4]),
                "ok": np.array([True, False])}
        out[side] = (norm(m.map(ev)),
                     norm(m.map_rows(cols, np.array([7, 8]), 2)))
    assert out["port"] == out["ref"]


# ------------------------------------------------------------------ broker

def test_broker_is_the_ports_own():
    got = {"ref": [], "port": []}
    unsubs = [IO[s].InMemoryBroker.subscribe("own", got[s].append)
              for s in PKGS]
    try:
        port_io.InMemoryBroker.publish("own", 1)
        ref_io.InMemoryBroker.publish("own", 2)
        assert got == {"ref": [2], "port": [1]}
        unsubs[1]()
        port_io.InMemoryBroker.publish("own", 3)
        assert got["port"] == [1]
    finally:
        unsubs[0]()
        port_io.InMemoryBroker.reset()
    assert siddhi_tpu_torch.InMemoryBroker is port_io.InMemoryBroker


# ---------------------------------------------------------- file / socket

CSV_APP = """
@source(type='file', file='{path}', @map(type='csv', ts.last='true'))
define stream S (dev string, v double, k long);
from S[v > 50.0] select dev, v, k insert into Out;
"""


def test_file_source_end_to_end(tmp_path):
    path = tmp_path / "in.csv"
    rows = events(3000, seed=9)
    path.write_bytes(csv_bytes(rows))

    def run(side, pkg, m):
        rt = m.create_siddhi_app_runtime(CSV_APP.format(path=path),
                                         playback=True)
        got = rows_of(rt, pkg, "Out")
        rt.start()
        assert rt.sources[0].wait_drained(30.0)
        src = rt.sources[0]
        return got, src.bytes_in, src.mapper.rows_out, src.mapper.parse_errors

    out = both(run)
    assert out["port"] == out["ref"]
    got, nbytes, rows_out, errors = out["port"]
    assert got and nbytes == path.stat().st_size
    assert rows_out == 3000 and errors == 0


@pytest.mark.parametrize("seed", [1, 2])
def test_torn_reads_give_the_per_event_rows(seed):
    """Every chunking of the same bytes (pieces of 1 to 97 bytes, empty
    reads among them) gives the rows of one whole feed."""
    rows = events(400, seed=seed)
    data = csv_bytes(rows)
    rng = np.random.default_rng(seed)
    cuts, pos = [], 0
    while pos < len(data):
        step = int(rng.integers(0, 98))
        cuts.append(data[pos:pos + step])
        pos += step

    def run(side, pkg, m, pieces):
        rt = m.create_siddhi_app_runtime(
            CSV_APP.format(path="/nonexistent"), playback=True)
        got = rows_of(rt, pkg, "Out")
        rt.start_without_sources()
        src = rt.sources[0]
        for p in pieces:
            src.feed(p)
        src.finish()
        return got

    whole = both(lambda s, p, m: run(s, p, m, [data]))
    torn = both(lambda s, p, m: run(s, p, m, cuts))
    assert whole["port"] == whole["ref"] == torn["port"] == torn["ref"]
    assert whole["port"]


def test_line_source_tail_cap():
    out = {}
    for side, pkg in PKGS.items():
        src = IO[side].LineSource()
        d = stream_def(pkg)
        m = IO[side].CsvSourceMapper()
        m.init(d, {})
        seen = []
        src.init(d, {"max.line.bytes": "64"}, m, seen.append)
        src.feed(b"x" * 100)                 # no newline past the cap
        src.feed(b"a,1.5,3,true\nb,2.5,4,fa")
        src.feed(b"lse\n")
        out[side] = (src.dropped_bytes, src.bytes_in, seen)
    assert out["port"] == out["ref"]
    assert out["port"][0] == 100 and len(out["port"][2]) == 2


SOCKET_APP = """
@source(type='socket', port='0', format='{fmt}'{mapper})
define stream S (dev string, v double, k long);
from S[v > 50.0] select dev, v, k insert into Out;
"""


def _send_socket(port: int, payload: bytes) -> None:
    with socket.create_connection(("127.0.0.1", port), timeout=5.0) as c:
        c.sendall(payload)


def _wait(cond, timeout: float = 10.0) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("fmt", ["lines", "rows"])
def test_socket_source(fmt):
    rows = events(500, seed=3)
    if fmt == "lines":
        payload = csv_bytes(rows)
        mapper = ", @map(type='csv', ts.last='true')"
    else:
        from siddhi_tpu_torch.gpu.dcn import pack_rows
        frames = []
        for lo in range(0, len(rows), 128):
            part = rows[lo:lo + 128]
            body = pack_rows("sdl", [list(r[:3]) for r in part],
                             [r[3] for r in part])
            frames.append(struct.pack(">I", len(body)) + body)
        payload = b"".join(frames)
        mapper = ""
    want = sum(1 for r in rows if r[1] is not None and r[1] > 50.0)

    def run(side, pkg, m):
        rt = m.create_siddhi_app_runtime(
            SOCKET_APP.format(fmt=fmt, mapper=mapper), playback=True)
        got = rows_of(rt, pkg, "Out")
        rt.start()
        src = rt.sources[0]
        _send_socket(src.port, payload)
        assert _wait(lambda: len(got) >= want)
        return got, src.bytes_in

    out = both(run)
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == want


# ------------------------------------------- RowsChunk and rows-capable sinks

CHUNK_APP = """
@source(type='inMemory', topic='{topic}', @map(type='passThrough'))
define stream S (dev string, v double, k long);
@sink(type='inMemory', topic='{topic}-out', @map(type='{sink}'))
define stream Out (dev string, v double, k long);
from S[v > 50.0] select dev, v, k insert into Out;
"""


def chunk_of(pkg, rows):
    cols = {"dev": np.array([r[0] for r in rows], dtype=object),
            "v": np.array([0.0 if r[1] is None else r[1] for r in rows]),
            "k": np.array([r[2] for r in rows], dtype=np.int64)}
    return pkg.core.columns.RowsChunk(cols, np.array([r[3] for r in rows]),
                                      len(rows))


@pytest.mark.parametrize("sink", ["passThrough", "json"])
def test_rows_chunk_through_send_columns_and_rows_sinks(sink):
    """A ``RowsChunk`` published to the source's topic goes whole through
    ``send_columns``; the rows-capable sink publishes whole chunks."""
    rows = events(600, seed=4)

    def run(side, pkg, m):
        topic = f"chunk-{sink}"
        rt = m.create_siddhi_app_runtime(
            CHUNK_APP.format(topic=topic, sink=sink), playback=True)
        got = rows_of(rt, pkg, "Out")
        sent = []
        unsub = pkg.InMemoryBroker.subscribe(f"{topic}-out", sent.append)
        rt.start()
        ih = rt.input_handler("S")
        calls = []
        inner = ih.send_columns
        ih.send_columns = lambda *a, **k: (calls.append(a[2] if len(a) > 2
                                                        else None),
                                           inner(*a, **k))[1]
        for lo in range(0, 600, 200):
            pkg.InMemoryBroker.publish(topic, chunk_of(pkg, rows[lo:lo + 200]))
        unsub()
        return got, calls, [norm(p) for p in sent]

    out = both(run)
    assert out["port"] == out["ref"]
    got, calls, sent = out["port"]
    assert calls == [200, 200, 200]
    assert got and sent


@pytest.mark.parametrize("sink", ["passThrough", "json", "text"])
def test_rows_sink_publishes_whole_chunks(sink):
    rows = events(300, seed=8)
    app = (f"@sink(type='inMemory', topic='rs-{sink}', "
           f"@map(type='{sink}'))\n"
           "define stream S (dev string, v double, k long);\n")

    def run(side, pkg, m):
        rt = m.create_siddhi_app_runtime(app, playback=True)
        sent = []
        unsub = pkg.InMemoryBroker.subscribe(f"rs-{sink}", sent.append)
        rt.start()
        for lo in range(0, 300, 100):
            ch = chunk_of(pkg, rows[lo:lo + 100])
            rt.input_handler("S").send_columns(ch.cols, ch.ts, ch.count)
        unsub()
        return [norm(p) for p in sent], rt.resilience.sinks[0].published

    out = both(run)
    assert out["port"] == out["ref"]
    sent, published = out["port"]
    assert len(sent) == 3 and published == 300
    if sink == "passThrough":
        assert [p[0] for p in sent] == ["chunk"] * 3
    else:
        assert [p.count("\n") for p in sent] == [99] * 3


def test_chunk_degrades_per_event_under_a_source_handler():
    rows = events(50, seed=6)

    def run(side, pkg, m):
        class H(pkg.SourceHandler):
            def send_event(self, row, input_handler):
                input_handler.send(row)

        class Mgr(pkg.SourceHandlerManager):
            def generate_source_handler(self, source_type):
                return H()

        m.set_source_handler_manager(Mgr())
        rt = m.create_siddhi_app_runtime(
            CHUNK_APP.format(topic="deg", sink="passThrough"), playback=True)
        got = rows_of(rt, pkg, "Out")
        rt.start()
        pkg.InMemoryBroker.publish("deg", chunk_of(pkg, rows))
        return got

    out = both(run)
    assert out["port"] == out["ref"] and out["port"]


# -------------------------------------------------------- distributed sinks

DIST_APP = """
define stream S (sym string, v int);
@sink(type='inMemory', @map(type='passThrough'),
      @distribution(strategy='{strategy}'{key},
                    @destination(topic='{t}0'), @destination(topic='{t}1'),
                    @destination(topic='{t}2')))
define stream Out (sym string, v int);
from S select sym, v insert into Out;
"""


@pytest.mark.parametrize("strategy", ["roundRobin", "partitioned",
                                      "broadcast"])
def test_distributed_sink(strategy):
    key = ", partitionKey='sym'" if strategy == "partitioned" else ""

    def run(side, pkg, m):
        t = f"dist-{strategy}-"
        rt = m.create_siddhi_app_runtime(
            DIST_APP.format(strategy=strategy, key=key, t=t), playback=True)
        got = {i: [] for i in range(3)}
        unsubs = [pkg.InMemoryBroker.subscribe(
            f"{t}{i}", lambda p, i=i: got[i].append(list(p.data)))
            for i in range(3)]
        rt.start()
        for i in range(12):
            rt.input_handler("S").send([f"s{i % 5}", i], timestamp=100 + i)
        for u in unsubs:
            u()
        return got

    out = both(run)
    assert out["port"] == out["ref"]
    counts = [len(v) for v in out["port"].values()]
    assert sum(counts) == (36 if strategy == "broadcast" else 12)


# ------------------------------------------------------------ sink pipeline

POLICY_APP = """
define stream S (v int);
{onerror}
@sink(type='flaky', topic='x', fail.n='{fail}', on.error='{policy}',
      retry.delay.ms='1', wait.base.ms='1', wait.cap.ms='4',
      circuit.threshold='{threshold}', circuit.cooldown.ms='50',
      @map(type='passThrough'))
define stream O (v int);
from S select v insert into O;
"""


def flaky_sink(side):
    io = IO[side]

    class Flaky(io.Sink):
        published: list = []

        def init(self, definition, options, mapper):
            super().init(definition, options, mapper)
            self.fail = int(options.get("fail.n") or 0)

        def publish(self, payload):
            if self.fail > 0:
                self.fail -= 1
                raise io.ConnectionUnavailableError("transport down")
            Flaky.published.append(list(payload.data))

    Flaky.published = []
    return Flaky


POLICIES = {
    "retry-ok": ("retry(3)", 2, 5, ""),
    "retry-exhausted-store": ("retry(2)", 3, 5, ""),
    "wait": ("wait", 3, 5, ""),
    "log": ("log", 2, 5, ""),
    "stream": ("stream", 2, 5, "@OnError(action='stream')"),
    "store": ("store", 2, 5, ""),
    "circuit": ("log", 4, 2, ""),
}


@pytest.mark.parametrize("case", sorted(POLICIES))
def test_sink_pipeline_policy(case):
    policy, fail, threshold, onerror = POLICIES[case]
    stream_app = POLICY_APP.format(onerror=onerror, fail=fail, policy=policy,
                                   threshold=threshold)
    if onerror:
        stream_app = stream_app.replace(
            "define stream O (v int);",
            "@OnError(action='stream')\ndefine stream O (v int);", 1) \
            .replace(onerror + "\n@sink", "@sink", 1) + \
            "from !O select v insert into Faults;\n"

    def run(side, pkg, m):
        flaky = flaky_sink(side)
        m.set_extension("sink:flaky", flaky)
        store = pkg.core.errors.ErrorStore() if case.endswith("store") \
            else None
        if store is not None:
            m.set_error_store(store)
        rt = m.create_siddhi_app_runtime(stream_app, playback=True)
        faults = rows_of(rt, pkg, "Faults") if onerror else []
        rt.start()
        for i in range(4):
            rt.input_handler("S").send([i], timestamp=10 + i)
        rs = rt.resilience.sinks[0]
        rep = rs.report()
        stored = [(e.stream_name, e.occurrence, e.sink_ordinal)
                  for e in store.load(rt.name)] if store is not None else []
        return (flaky.published, rep, faults, stored,
                rs.breaker.open_count)

    out = both(run)
    assert out["port"] == out["ref"]
    published, rep, faults, stored, opened = out["port"]
    assert rep["published"] == len(published)
    if case == "circuit":
        assert opened >= 1


def test_bad_sink_policy_is_refused_at_build():
    """A bad ``on.error`` value is refused at build, on both engines."""
    app = POLICY_APP.format(onerror="", fail=0, policy="sometimes",
                            threshold=5)
    for side in PKGS:
        m = manager(side)
        m.set_extension("sink:flaky", flaky_sink(side))
        with pytest.raises(Exception, match="on.error"):
            m.create_siddhi_app_runtime(app, playback=True)
        m.shutdown()


def test_circuit_breaker_matches_reference():
    from siddhi_tpu.resilience.circuit import CircuitBreaker as Ref
    from siddhi_tpu_torch.resilience.circuit import CircuitBreaker as Port
    t = [0.0]
    trails = []
    for cls in (Ref, Port):
        t[0] = 0.0
        b = cls(3, 10.0, clock=lambda: t[0])
        trail = []
        for step, ok in enumerate([False, True, False, False, False, None,
                                   None, False, None, True, True]):
            t[0] = step * 4.0
            allowed = b.allow()
            if ok is True and allowed:
                b.record_success()
            elif ok is False and allowed:
                b.record_failure()
            trail.append((allowed, b.state, b.consecutive_failures,
                          b.open_count, b.state_code))
        trails.append(trail)
    assert trails[0] == trails[1]


# ---------------------------------------------------------- handler managers

HANDLER_APP = """
@source(type='inMemory', topic='h-in', @map(type='passThrough'))
define stream S (sym string, v double);
@sink(type='inMemory', topic='h-out', @map(type='passThrough'))
define stream O (sym string, v double);
from S[v > 1.0] select sym, v insert into O;
"""


def test_handler_managers_intercept_and_unregister():
    def run(side, pkg, m):
        audit = []

        class Src(pkg.SourceHandler):
            def send_event(self, row, input_handler):
                audit.append(("in", list(row)))
                if row[1] >= 0:
                    input_handler.send(row)

        class Snk(pkg.SinkHandler):
            def handle(self, event):
                audit.append(("out", list(event.data)))
                if event.data[0] != "drop":
                    self.callback(event)

        class SrcMgr(pkg.SourceHandlerManager):
            def generate_source_handler(self, source_type):
                return Src()

        class SnkMgr(pkg.SinkHandlerManager):
            def generate_sink_handler(self):
                return Snk()

        src_mgr, snk_mgr = SrcMgr(), SnkMgr()
        m.set_source_handler_manager(src_mgr)
        m.set_sink_handler_manager(snk_mgr)
        rt = m.create_siddhi_app_runtime(HANDLER_APP, playback=True)
        sent = []
        unsub = pkg.InMemoryBroker.subscribe("h-out",
                                             lambda p: sent.append(norm(p)))
        rt.start()
        for row in [["a", 2.0], ["b", -1.0], ["drop", 3.0], ["c", 0.5],
                    ["d", 5.0]]:
            pkg.InMemoryBroker.publish("h-in", row)
        ids = (sorted(src_mgr.registered), sorted(snk_mgr.registered))
        unsub()
        m.shutdown()
        return audit, [s[2] for s in sent], len(ids[0]), len(ids[1]), \
            (src_mgr.registered, snk_mgr.registered)

    out = both(run)
    assert out["port"][:4] == out["ref"][:4]
    audit, sent, n_src, n_snk, regs = out["port"]
    assert sent == [["a", 2.0], ["d", 5.0]]
    assert (n_src, n_snk) == (1, 1) and regs == ({}, {})


def test_source_and_sink_gauges():
    def run(side, pkg, m):
        rt = m.create_siddhi_app_runtime(
            CHUNK_APP.format(topic="g", sink="json"), playback=True)
        rt.start()
        pkg.InMemoryBroker.publish("g", chunk_of(pkg, events(20)))
        gauges = rt.ctx.statistics_manager.report()["gauges"]
        return {k: v for k, v in gauges.items()
                if k.startswith(("sink.", "stream.S.source"))}

    out = both(run)
    assert out["port"] == out["ref"]
    assert out["port"]["sink.Out.0.circuit_state"] == 0


def test_start_without_sources_defers_connect():
    def run(side, pkg, m):
        rt = m.create_siddhi_app_runtime(
            CHUNK_APP.format(topic="defer", sink="passThrough"),
            playback=True)
        got = rows_of(rt, pkg, "Out")
        rt.start_without_sources()
        pkg.InMemoryBroker.publish("defer", ["x", 60.0, 1])   # no source yet
        rt.start_sources()
        pkg.InMemoryBroker.publish("defer", ["y", 70.0, 2])
        return [d for _, d in got]

    out = both(run)
    assert out["port"] == out["ref"] == [["y", 70.0, 2]]
