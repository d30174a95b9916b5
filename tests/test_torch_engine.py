"""The port's engine: samples, snapshots, refusals, the device rule.

- The JAX package's samples (``samples/*.py``: their app text read from the
  files, their driver loops replayed) run on ``siddhi_tpu_torch.
  SiddhiManager(device="cpu")`` and give the reference engine's output:
  the two device samples (``device_pattern``, ``device_offload``) on the
  device tier, the others on the host interpreter; ``interception_handlers``
  through the IO tier, with the port's source and sink handler managers;
  ``columnar_edge`` through the file source, the columnar host tier
  (``@app:host_batch``) and the ``inMemory`` sink.
- ``snapshot``/``restore`` and ``persist``/``restore_last_revision``
  mid-stream, in sync and async mode: cut where every bridge's builder is
  empty, the port resumed in a fresh engine equals its uninterrupted run,
  timestamps included; cut mid-batch (the snapshot flushes the partial
  batch, so output timestamps move), it equals the reference engine cut at
  the same event. A blob holds numpy arrays and no ``torch.Tensor``.
- The tiers it once refused (sources, sinks, the WAL, backpressure,
  adaptive batching, chaos and resilience, the columnar host tier, the
  fleet) build and give the reference engine's rows;
  a strict ``@device`` query the compilers refuse raises
  ``DeviceCompileError``, as in the reference.
- ``SiddhiManager()`` runs on the card, and without one it raises.
- Device state is sized by its tensors' bytes, never copied to the host
  (meta tensors, which have no data); the kernels' build is one at a time
  across threads.
"""

import ast
import pickle
import random
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError

from test_torch_device_bridge import (
    CHAIN,
    QUERIES,
    _Fed,
    _dev_v,
    assert_query_rows,
    port_manager,
    ref_manager,
    send,
    send_columns,
    start,
    stream_events,
)

ROOT = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------------ samples

def _template(node: ast.JoinedStr) -> str:
    """An f-string as a ``str.format`` template: its fields by name."""
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            parts.append(v.value.replace("{", "{{").replace("}", "}}"))
        else:
            parts.append("{" + ast.unparse(v.value) + "}")
    return "".join(parts)


def sample_app(name: str) -> str:
    """The ``APP`` text of ``samples/<name>.py`` (an f-string's as a
    ``str.format`` template), or the app text its
    ``create_siddhi_app_runtime`` call is given (read as data: the sample
    imports the JAX package)."""
    tree = ast.parse((ROOT / "samples" / f"{name}.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "APP":
            if isinstance(node.value, ast.JoinedStr):
                return _template(node.value)
            return ast.literal_eval(node.value)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "create_siddhi_app_runtime":
            return ast.literal_eval(node.args[0])
    raise KeyError(name)


def _pattern_events():
    return [("S", [v], 1000 + i * 100)
            for i, v in enumerate([11.0, 5.0, 12.0, 13.0, 2.0, 14.0])]


def _offload_events():
    rng = random.Random(7)
    return [("Ticks", [rng.choice(["a", "b"]), round(rng.uniform(0, 100), 2)],
             1000 + i) for i in range(256)]


def _rows(stream: str, rows, t0: int = 1000, step: int = 100):
    return lambda: [(stream, list(r), t0 + i * step)
                    for i, r in enumerate(rows)]


def _pkg(manager):
    return siddhi_tpu_torch if isinstance(
        manager, siddhi_tpu_torch.SiddhiManager) else siddhi_tpu


def _again(manager):
    """A second engine of ``manager``'s package."""
    return port_manager() if _pkg(manager) is siddhi_tpu_torch \
        else ref_manager()


def _timestamps(stream: str, rows):
    return lambda: [(stream, list(r), t) for r, t in rows]


def drive_join_and_table(manager, app):
    rt = start(manager, app, out="Valued")
    rt.ctx.tables["Prices"].add([["a", 10.0], ["b", 2.5]])
    send(rt, [("Orders", ["a", 3], 1000), ("Orders", ["b", 4], 1100)])
    manager.shutdown()
    return rt.got, rt


def drive_persistence(manager, app):
    store = _pkg(manager).InMemoryPersistenceStore()
    manager.set_persistence_store(store)
    r1 = start(manager, app, out="O")
    send(r1, [("S", [v], 1000 + i) for i, v in enumerate([10, 20, 30])])
    r1.persist()
    manager.shutdown()
    m2 = _again(manager)
    m2.set_persistence_store(store)
    r2 = start(m2, app, out="O")
    r2.restore_last_revision()
    send(r2, [("S", [40], 2000)])
    assert r2.got[-1][1] == [100]
    m2.shutdown()
    return r1.got + r2.got, r2


def drive_extension(manager, app):
    pkg = _pkg(manager)
    base = pkg.core.ScalarFunctionExtension
    double = pkg.query_api.DataType.DOUBLE

    class Fahrenheit(base):
        return_type = double

        def execute(self, args):
            return args[0] * 9.0 / 5.0 + 32.0

    manager.set_extension("custom:fahrenheit", Fahrenheit)
    rt = start(manager, app, out="OutStream")
    send(rt, [("TempStream", ["r1", 100.0], 1000)])
    manager.shutdown()
    return rt.got, rt


def drive_async_ingestion(manager, app):
    """Four producer threads without playback: the rows' order and
    running sums depend on the interleaving, so the count and the final
    total are compared."""
    rt = manager.create_siddhi_app_runtime(app)
    got = []
    rt.add_callback("O", _pkg(manager).StreamCallback(
        lambda evs: got.extend(list(e.data) for e in evs)))
    rt.start()
    handler = rt.input_handler("S")

    def producer(tid):
        for i in range(500):
            handler.send([tid, i])

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rt.drain_async()
    manager.shutdown()
    assert rt.ctx.stream_junctions["S"].dispatcher is not None
    return [len(got), max(r[1] for r in got),
            sorted({r[0] for r in got})], rt


def drive_perf_filter(manager, app):
    """The throughput loop at 2 rounds of 2,000 events."""
    rt = start(manager, app, out="Out")
    handler = rt.input_handler("StockStream")
    rng = random.Random(1)
    rows = [["s" + str(rng.randrange(100)), rng.uniform(0, 100), 10]
            for _ in range(2000)]
    sent = 0
    while sent < 4000:
        for i, r in enumerate(rows):
            handler.send(r, timestamp=sent + i)
        sent += len(rows)
    manager.shutdown()
    return rt.got, rt


def drive_incremental_aggregation(manager, app):
    rt = manager.create_siddhi_app_runtime(app, playback=True)
    rt.start()
    send(rt, [("Trades", ["a", 10.0], 1_000), ("Trades", ["a", 20.0], 1_400),
              ("Trades", ["a", 30.0], 62_000)])
    rows = rt.query("from TradeAgg within 0L, 120000L per 'seconds' "
                    "select AGG_TIMESTAMP, sym, avgPrice, n")
    manager.shutdown()
    return [list(e.data) for e in rows], rt


def drive_interception_handlers(manager, app):
    """The sample's audit handlers on ``manager``'s package: every source
    row and sink event they saw, and the payloads the transport got."""
    pkg = _pkg(manager)
    audit = []

    class AuditSourceHandler(pkg.SourceHandler):
        def send_event(self, row, input_handler):
            audit.append(("source", self.definition.id, list(row)))
            input_handler.send(row)

    class AuditSinkHandler(pkg.SinkHandler):
        def handle(self, event):
            audit.append(("sink", self.definition.id, list(event.data)))
            self.callback(event)

    class AuditSourceManager(pkg.SourceHandlerManager):
        def generate_source_handler(self, source_type):
            return AuditSourceHandler()

    class AuditSinkManager(pkg.SinkHandlerManager):
        def generate_sink_handler(self):
            return AuditSinkHandler()

    manager.set_source_handler_manager(AuditSourceManager())
    manager.set_sink_handler_manager(AuditSinkManager())
    rt = manager.create_siddhi_app_runtime(app, playback=True)
    received = []
    unsub = pkg.InMemoryBroker.subscribe("alerts", received.append)
    rt.add_callback("HighPrice", pkg.StreamCallback(lambda evs: None))
    rt.start()
    for row in [["WSO2", 55.6], ["IBM", 40.0], ["GOOG", 120.0]]:
        pkg.InMemoryBroker.publish("ticks", row)
    unsub()
    manager.shutdown()
    return audit + [("transport", list(p.data)) for p in received], rt


def drive_columnar_edge(manager, app):
    """The sample's ticks as a CSV file through the file source, the
    columnar filter and the ``inMemory`` sink: the published chunks'
    rows."""
    import tempfile
    pkg = _pkg(manager)
    path = Path(tempfile.mkdtemp()) / "ticks.csv"
    path.write_text("".join(
        f"{sym},{price},{vol},{1000 + i * 100}\n" for i, (sym, price, vol)
        in enumerate([("WSO2", 55.6, 100), ("IBM", 40.0, 50),
                      ("GOOG", 120.0, 30), ("WSO2", 57.1, 20),
                      ("IBM", 75.0, 10)])))
    published = []
    unsub = pkg.InMemoryBroker.subscribe(
        "high-price",
        lambda chunk: published.extend(chunk.rows(["symbol", "price"])))
    rt = manager.create_siddhi_app_runtime(app.format(csv_path=path),
                                           playback=True)
    rt.start()
    rt.sources[0].wait_drained(10.0)
    rt.flush_host()
    assert [b.query_name for b in rt.host_bridges] == ["filterQuery"]
    unsub()
    manager.shutdown()
    return published, rt


# name → (output stream, events) for a sample whose loop only sends, or its
# replayed driver loop
SAMPLES = {
    "device_pattern": ("Rising", _pattern_events),
    "device_offload": ("Stats", _offload_events),
    "simple_filter": ("HighPriceStream", _rows(
        "StockStream", [("WSO2", 55.6, 100), ("IBM", 40.0, 50),
                        ("GOOG", 120.0, 30)])),
    "time_window": ("AvgTempStream", _timestamps(
        "TempStream", [(["r1", 20.0], 1_000), (["r1", 24.0], 4_000),
                       (["r1", 28.0], 12_000)])),
    "pattern_detect": ("SpikeStream", _timestamps(
        "TempStream", [(["r1", 31.0], 1_000), (["r2", 33.0], 2_000),
                       (["r1", 35.0], 3_000), (["r2", 36.0], 4_000)])),
    "partition": ("AlertStream", _rows(
        "LoginStream", [("alice", False), ("bob", False), ("alice", False),
                        ("bob", True), ("alice", False), ("bob", False),
                        ("bob", False)], step=10)),
    "join_and_table": drive_join_and_table,
    "persistence": drive_persistence,
    "extension": drive_extension,
    "async_ingestion": drive_async_ingestion,
    "perf_filter": drive_perf_filter,
    "incremental_aggregation": drive_incremental_aggregation,
    "interception_handlers": drive_interception_handlers,
    "columnar_edge": drive_columnar_edge,
}
DEVICE_SAMPLES = {"device_pattern", "device_offload"}


def run_sample(manager, name: str):
    """The sample's driver loop on ``manager``: rows of its output stream as
    ``(timestamp, data)`` (or what its driver returns), the runtime, and the
    tolerance record of a device query sample."""
    entry = SAMPLES[name]
    if callable(entry):
        got, rt = entry(manager, sample_app(name))
        return got, rt, None
    out, events = entry
    rt = start(manager, sample_app(name), out=out)
    port = isinstance(manager, siddhi_tpu_torch.SiddhiManager)
    fed = _Fed(rt.device_bridges[0].runtime) \
        if port and rt.device_bridges \
        and hasattr(rt.device_bridges[0].runtime, "compiled") else None
    send(rt, events())
    rt.flush_device()
    manager.shutdown()
    return rt.got, rt, fed


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_sample_runs_on_the_port(name):
    ref, _, _ = run_sample(ref_manager(), name)
    got, prt, fed = run_sample(port_manager(), name)
    assert ref
    # device samples step on the device tier, the others on the interpreter
    assert bool(prt.device_bridges) == (name in DEVICE_SAMPLES)
    if fed is None:             # the pattern and the host tier: exact
        assert got == ref
    else:                       # grouped f32 sums: the query tolerances
        assert_query_rows(prt, ref, got, fed)


# ---------------------------------------------------------------- snapshots

# the chain and the grouped length window, both into Out
SNAP_APP = "@app:name('Snap')\n" + CHAIN + QUERIES["grouped_length"][0]
TICK_COLS = ("Ticks", ["sym", "price", "vol"])


def _snap_events():
    chain = stream_events(12, 1280, {"S": (1, _dev_v(8, 40.0, 100.0))})
    ticks = stream_events(13, 640, QUERIES["grouped_length"][1])
    return chain, ticks


def _feed(rt, chain, ticks) -> None:
    send(rt, chain)
    send_columns(rt, *TICK_COLS, ticks)


def _async(app: str) -> str:
    return app.replace("strict='true'", "strict='true', async='true'")


def _walk_leaves(x, out: list) -> list:
    if isinstance(x, dict):
        for v in x.values():
            _walk_leaves(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _walk_leaves(v, out)
    else:
        out.append(x)
    return out


def _resumed(app: str, chain, ticks, cut_chain: int, cut_ticks: int,
             how: str, manager_cls):
    """Feeds the cut's prefix, snapshots (``how``: ``snapshot`` or
    ``persist``), resumes in a fresh engine and feeds the rest; returns the
    rows of both halves and the blob."""
    store = None
    m1 = manager_cls()
    if how == "persist":
        store = (siddhi_tpu_torch if isinstance(m1, siddhi_tpu_torch.SiddhiManager)
                 else siddhi_tpu).InMemoryPersistenceStore()
        m1.set_persistence_store(store)
    rt1 = start(m1, app)
    _feed(rt1, chain[:cut_chain], ticks[:cut_ticks])
    if how == "snapshot":
        blob = rt1.snapshot()
    else:
        rev = rt1.persist()
        blob = store.load("Snap", rev)
    m1.shutdown()
    m2 = manager_cls()
    if store is not None:
        m2.set_persistence_store(store)
    rt2 = start(m2, app)
    if how == "snapshot":
        rt2.restore(blob)
    else:
        assert rt2.restore_last_revision() == rev
    _feed(rt2, chain[cut_chain:], ticks[cut_ticks:])
    rt2.flush_device()
    m2.shutdown()
    return rt1.got + rt2.got, blob


def _uninterrupted(app: str, chain, ticks):
    m = port_manager()
    rt = start(m, app)
    _feed(rt, chain, ticks)
    rt.flush_device()
    m.shutdown()
    return rt.got


@pytest.mark.parametrize("how", ["snapshot", "persist"])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_resume_at_a_batch_boundary_equals_uninterrupted(mode, how):
    app = SNAP_APP if mode == "sync" else _async(SNAP_APP)
    chain, ticks = _snap_events()
    want = _uninterrupted(app, chain, ticks)
    got, blob = _resumed(app, chain, ticks, 640, 320, how, port_manager)
    # per query (the chain's rows have 4 values, the window's 5): the two
    # halves interleave the queries' rows in another order
    for width in (4, 5):
        mine = [x for x in got if len(x[1]) == width]
        assert mine, "both queries emitted"
        assert mine == [x for x in want if len(x[1]) == width]
    leaves = _walk_leaves(pickle.loads(blob), [])
    assert not any(isinstance(x, torch.Tensor) for x in leaves)
    assert any(isinstance(x, np.ndarray) for x in leaves)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_resume_mid_batch_matches_reference(mode):
    app = "@app:name('Snap')\n" + (CHAIN if mode == "sync" else _async(CHAIN))
    chain, _ = _snap_events()
    ref, _ = _resumed(app, chain, [], 700, 0, "snapshot", ref_manager)
    got, _ = _resumed(app, chain, [], 700, 0, "snapshot", port_manager)
    assert ref
    assert got == ref


# ------------------------------------------------------------ ported tiers

S = "define stream S (v double);\n"
Q = "@device(batch='16')\nfrom S[v > 1.0] select v insert into O;\n"


# the tiers this engine has, which it refused before: each app builds on
# both engines, and a few events give the same rows (``{wal}`` is a fresh
# directory per engine)
PORTED = {
    "source": "@source(type='inMemory', topic='{topic}', "
              "@map(type='passThrough'))\n" + S + Q,
    "sink": "@sink(type='inMemory', topic='{topic}', "
            "@map(type='passThrough'))\ndefine stream O (v double);\n"
            + S + Q,
    "wal": "@app:wal(dir='{wal}')\n" + S + Q,
    "backpressure": "@app:backpressure(capacity='8')\n" + S + Q,
    "adaptive": "@app:adaptive(target.ms='25')\n" + S + Q,
    "chaos": "@app:chaos(seed='1', device.fail.p='0.5')\n" + S + Q,
    "resilience": "@app:resilience(device.quarantine='false')\n" + S + Q,
    "trace": "@app:trace(sample='1/1')\n" + S + Q,
    "flightrecorder": "@app:flightrecorder(ring='64')\n" + S + Q,
    "profile": "@app:profile(enable='true')\n" + S + Q,
    # a device query and a columnar host query side by side
    "host_batch": "@app:host_batch(workers='2')\n" + S + Q
                  + "from S[v > 2.0] select v insert into O;\n",
    # a device query and a fleet member side by side
    "fleet": "@app:fleet(batch='4')\n" + S + Q
             + "from S[v > 2.0] select v insert into O;\n",
}


def run_ported_tier(manager, app: str, topic: str) -> list:
    """Five events into ``S`` (through the broker where ``S`` has a
    source) → the rows of ``O`` and of the transport where ``O`` has a
    sink."""
    pkg = _pkg(manager)
    rt = start(manager, app, out="O")
    sent = []
    unsub = pkg.InMemoryBroker.subscribe(
        f"{topic}-out", lambda p: sent.append(list(p.data)))
    for i, v in enumerate([0.5, 2.0, 3.5, 1.0, 4.0]):
        if "@source" in app:
            pkg.InMemoryBroker.publish(topic, [v])
        else:
            rt.input_handler("S").send([v], timestamp=1000 + i)
    rt.flush_device()
    unsub()
    manager.shutdown()
    return [d for _, d in rt.got] + sent


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_tier_builds(name, tmp_path):
    outs = []
    for make in (ref_manager, port_manager):
        topic = f"tier-{name}-{make.__name__}"
        app = PORTED[name].format(
            topic=topic if name == "source" else f"{topic}-out",
            wal=tmp_path / make.__name__)
        outs.append(run_ported_tier(make(), app, topic))
    ref, got = outs
    assert ref and got == ref


def test_strict_refusal_raises_device_compile_error():
    app = S + ("@device(batch='16', strict='true')\nfrom S[v > 1.0] select v "
               "order by v insert into O;\n")
    with pytest.raises(DeviceCompileError, match="order by"):
        port_manager().create_siddhi_app_runtime(app, playback=True)
    from siddhi_tpu.tpu.expr_compile import DeviceCompileError as RefError
    with pytest.raises(RefError, match="order by"):
        ref_manager().create_siddhi_app_runtime(app, playback=True)


def test_manager_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        siddhi_tpu_torch.SiddhiManager()
    with pytest.raises(RuntimeError, match="CUDA"):
        siddhi_tpu_torch.SiddhiManager(device="cuda")
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(CHAIN, playback=True)
    comp = rt.device_bridges[0].runtime.compiler
    assert m.device.type == "cpu" and comp.device.type == "cpu"
    assert rt.device_bridges[0].runtime.state["matches"].device.type == "cpu"


# ---------------------------------------------------------- state, builds

def test_device_state_sized_by_bytes_without_a_host_copy():
    """``_deep_size`` reads ``Tensor.nbytes``: meta tensors have no data, so
    any copy to the host would raise."""
    from siddhi_tpu_torch.core.metrics import StatisticsManager, _deep_size
    state = {"tables": {"t0": {"ts": torch.empty((1, 64), dtype=torch.int64,
                                                 device="meta"),
                               "v": torch.empty((1, 64), device="meta")}},
             "matches": torch.empty(1, dtype=torch.int64, device="meta")}
    leaf = state["tables"]["t0"]["ts"]
    assert _deep_size(leaf, set()) == leaf.nbytes == 512
    tensors = 512 + 256 + 8
    size = _deep_size(state, set())
    assert tensors < size < tensors + 4096
    sm = StatisticsManager("x")
    assert sm.memory_tracker("device.q", lambda: state).bytes == size


def test_engine_wires_device_state_gauge():
    m = port_manager()
    rt = start(m, CHAIN)
    send(rt, stream_events(14, 200, {"S": (1, _dev_v(8, 40.0, 100.0))}))
    st = rt.device_bridges[0].runtime.state
    nbytes = sum(x.nbytes for x in _walk_leaves(st, []))
    got = rt.ctx.statistics_manager.memory["device.query-1"].bytes
    assert nbytes < got < nbytes + 8192
    m.shutdown()


def test_kernel_build_is_one_at_a_time(monkeypatch):
    """Threads that reach a kernel's first launch together build it once."""
    from siddhi_tpu_torch.gpu import _build
    calls, active, most = [], [0], [0]

    def start_build(stem):
        active[0] += 1
        most[0] = max(most[0], active[0])
        calls.append(stem)
        time.sleep(0.05)
        return stem

    def finish(stem, started):
        active[0] -= 1
        return f"lib:{started}"

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_start", start_build)
    monkeypatch.setattr(_build, "_finish", finish)
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(
        _build.load("nfa_block"))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == ["nfa_block"] and most[0] == 1
    assert libs == ["lib:nfa_block"] * 4


@pytest.mark.cuda
def test_cuda_state_sized_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA state tensors")
    m = siddhi_tpu_torch.SiddhiManager()
    rt = start(m, CHAIN)
    st = rt.device_bridges[0].runtime.state
    leaves = _walk_leaves(st, [])
    assert all(x.device.type == "cuda" for x in leaves)
    got = rt.ctx.statistics_manager.memory["device.query-1"].bytes
    assert sum(x.nbytes for x in leaves) < got
    m.shutdown()
