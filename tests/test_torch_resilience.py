"""The port's resilience tier against the JAX package's, on the CPU.

The same app text and the same seeded events go through
``siddhi_tpu.SiddhiManager`` (JAX on the CPU) and
``siddhi_tpu_torch.SiddhiManager(device="cpu")`` with ``@app:chaos`` and
``@app:resilience``:

- ``ChaosInjector``'s faults, site by site, and the parsed
  ``@app:chaos``/``@app:resilience`` fields are the same in both packages;
- guarded runs (every ``@device`` query has a ``DeviceGuard`` by default)
  of a stateless filter, a 3-state chain and a grouped ``length`` window,
  sync and async, under ``device.fail.p`` 0.25 and 1.0, give the
  reference's rows in order, timestamps included, and its guard reports,
  ``fallback_engine`` included: both guards replay on the columnar host
  engine first (the filter and the chain; the grouped window does not
  lower there and replays on the interpreter). Every value compared is
  exact: the inputs are float32-representable and the windows sum longs, so
  no tolerance applies;
- a fault at the fence (the runtime's ``collect`` raising on its k-th
  call), the quarantine's short-circuit and its half-open probe, a failed
  ``timeBatch`` step (whose finalize sentinel is no event and never
  replays), columnar chunks (``send_columns``: the lazy shadow replays
  exactly the slice each batch took), ``append_many`` batches (counted as
  lost), query callbacks and the gauges, each in both packages;
- a kernel library that fails to build or load raises
  ``KernelLibraryError`` (a ``DeviceCompileError``) when the query is built,
  strict or not: never the host interpreter, never a step the guard replays;
- on the card (``replay_only_chaos``) a step that fails with anything but an
  injected ``ChaosFault`` is not replayed: it raises, as does every later
  step of the query, without a launch;
- the columnar host tier's ``HostStepGuard``: a failed micro-batch replays
  on the interpreter with no event lost, and ``host.circuit.threshold``
  failures quarantine the columnar path, each in both packages.
"""

import importlib.util
import logging

import numpy as np
import pytest
import torch

import siddhi_tpu_torch
import siddhi_tpu_torch.core.device_bridge as port_bridge
from siddhi_tpu_torch.gpu.expr_compile import (
    DeviceCompileError,
    KernelLibraryError,
)
from siddhi_tpu_torch.resilience.chaos import ChaosInjector as PortChaos
from siddhi_tpu_torch.resilience.chaos import (
    parse_chaos_annotation as port_parse,
)
from siddhi_tpu_torch.resilience.circuit import CircuitState

# where JAX is not installed only the ``cuda``-marked test can run
# (``-m cuda``), and the reference is not imported
if importlib.util.find_spec("jax") is not None:
    import siddhi_tpu
    import siddhi_tpu.core.device_bridge as ref_bridge
    from siddhi_tpu.resilience.chaos import ChaosInjector as RefChaos
    from siddhi_tpu.resilience.chaos import (
        parse_chaos_annotation as ref_parse,
    )

    from test_torch_device_bridge import (
        _dev_v,
        port_manager,
        ref_manager,
        send,
        send_columns,
        start,
        stream_events,
    )

    MANAGERS = {"ref": ref_manager, "port": port_manager}
    BRIDGES = {"ref": ref_bridge, "port": port_bridge}


@pytest.fixture(autouse=True)
def _quiet_guard_logs(caplog):
    """A guarded step failure logs its traceback at WARNING; hundreds of
    them would flood the report."""
    for name in ("siddhi_tpu.resilience", "siddhi_tpu_torch.resilience"):
        logging.getLogger(name).setLevel(logging.ERROR)
    yield
    for name in ("siddhi_tpu.resilience", "siddhi_tpu_torch.resilience"):
        logging.getLogger(name).setLevel(logging.NOTSET)


def _guard_report(rt) -> list:
    return [g.report() for g in rt.resilience.guards]


# ------------------------------------------------------------------ chaos

SITES = ["source:App/S", "sink:App/O[0]", "device:App/query-1",
         "connect:App/S"]


def _faults(inj, site: str, n: int) -> list:
    """The injector's verdicts at ``site`` over ``n`` calls (1 = fault)."""
    hook = {"source": inj.on_source, "sink": inj.on_sink,
            "device": inj.on_device, "connect": inj.on_connect}[
        site.split(":")[0]]
    out = []
    for _ in range(n):
        try:
            hook(site)
            out.append(0)
        except Exception:   # noqa: BLE001 — ChaosFault or the transport
            # error, the injector's verdict either way
            out.append(1)
    return out


@pytest.mark.parametrize("seed", [0, 16, 12345])
def test_chaos_faults_per_site_equal_the_reference(seed):
    kw = dict(seed=seed, source_fail_p=0.1, sink_fail_p=0.3,
              device_fail_p=0.05, connect_fail_p=0.5)
    ref, port = RefChaos(**kw), PortChaos(**kw)
    for site in SITES:
        got = _faults(port, site, 400)
        assert got == _faults(ref, site, 400)
        assert 0 < sum(got) < 400
    # interleaving sites does not move a site's own sequence
    a, b = PortChaos(**kw), PortChaos(**kw)
    for _ in range(50):
        for site in SITES:
            _faults(a, site, 1)
    assert [_faults(a, s, 100) for s in SITES] == \
        [(_faults(b, s, 150))[50:] for s in SITES]
    assert port.report() == ref.report()


ANNOTATED = {
    "defaults": "",
    "chaos": "@app:chaos(seed='7', source.fail.p='0.05', sink.fail.p='0.1', "
             "device.fail.p='0.2', connect.fail.p='0.3', latency.ms='0', "
             "dcn.drop.p='0.1', dcn.kill.p='0.2', dcn.delay.ms='3', "
             "fleet.fault.p='0.4')\n",
    "resilience": "@app:resilience(sink.on.error='wait', "
                  "sink.retry.count='4', sink.wait.base.ms='2', "
                  "sink.circuit.threshold='5', "
                  "sink.circuit.cooldown.ms='900', "
                  "device.quarantine='true', device.circuit.threshold='7', "
                  "device.circuit.cooldown.ms='1234', "
                  "host.circuit.threshold='2', "
                  "host.circuit.cooldown.ms='50', host.quarantine='false')\n",
    "optout": "@app:resilience(device.quarantine='false')\n",
}

# the ``host.*`` keys tune the reference's HostStepGuard, which the port
# has not yet (ROADMAP.md §A item 4): it ignores them
FIELDS = ("sink_defaults", "device_threshold", "device_cooldown_s",
          "device_quarantine")


@pytest.mark.parametrize("name", sorted(ANNOTATED))
def test_annotation_fields_equal_the_reference(name):
    app = ANNOTATED[name] + FILTER.format(batch=16, extra="")
    subs = []
    for make in (ref_manager, port_manager):
        rt = make().create_siddhi_app_runtime(app, playback=True)
        subs.append(rt.resilience)
    ref, port = subs
    for f in FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert (port.chaos is None) == (ref.chaos is None)
    if ref.chaos is not None:
        assert port.chaos.report() == ref.chaos.report()
    assert len(port.guards) == len(ref.guards) == \
        (0 if name == "optout" else 1)
    assert port.host_guards == []
    ann = siddhi_tpu_torch.compiler.parse(app).annotations
    (chaos_ann,) = [a for a in ann if a.name == "chaos"] or [None]
    parsed = port_parse(chaos_ann)
    ref_ann = siddhi_tpu.compiler.parse(app).annotations
    ref_parsed = ref_parse(([a for a in ref_ann if a.name == "chaos"]
                            or [None])[0])
    assert (parsed is None) == (ref_parsed is None)
    if parsed is not None:
        assert vars(parsed).keys() == vars(ref_parsed).keys()
        assert {k: v for k, v in vars(parsed).items() if k != "_rngs"} == \
            {k: v for k, v in vars(ref_parsed).items() if k != "_rngs"}


def test_sink_defaults_reach_the_sink_policy():
    """``@app:resilience(sink.*)`` defaults reach every sink's policy."""
    app = ("@app:resilience(sink.on.error='retry', sink.retry.count='4')\n"
           "define stream S (v int);\n"
           "@sink(type='inMemory', topic='rs-defaults', "
           "@map(type='passThrough'))\n"
           "define stream O (v int);\n"
           "from S select v insert into O;\n")
    cfgs = []
    for make in (ref_manager, port_manager):
        rt = make().create_siddhi_app_runtime(app, playback=True)
        (sink,) = rt.resilience.sinks
        cfgs.append(sink.report())
    assert cfgs[1] == cfgs[0]
    assert cfgs[1]["policy"] == "retry"


# --------------------------------------------------------- guarded runs

FILTER = """
define stream S (dev string, v double);
@device(batch='{batch}', strict='true'{extra})
from S[v > 50.0] select dev, v insert into Out;
"""

CHAIN3 = """
define stream S (dev string, v double);
@device(batch='{batch}', slots='16', strict='true'{extra})
from every e1=S[v > 70.0] -> e2=S[v > e1.v] -> e3=S[v > e2.v] within 300
select e1.dev as dev, e1.v as v1, e2.v as v2, e3.v as v3
insert into Out;
"""

GROUPED = """
define stream S (dev string, v double, k long);
@device(batch='{batch}', strict='true'{extra})
from S#window.length(24)
select dev, count() as n, sum(k) as total
group by dev insert into Out;
"""

SHAPES = {
    "filter": (FILTER, lambda rng: _dev_v(6)(rng)),
    "chain": (CHAIN3, lambda rng: _dev_v(4, 40.0, 100.0)(rng)),
    "grouped": (GROUPED, lambda rng: _dev_v(5)(rng)
                + [int(rng.integers(-50, 1000))]),
}


def _chaos(p: float, seed: int = 16, threshold: int = 3) -> str:
    return (f"@app:name('Guarded')\n@app:chaos(seed='{seed}', "
            f"device.fail.p='{p}')\n@app:resilience("
            f"device.circuit.threshold='{threshold}')\n")


def guarded_run(make, app: str, events, columns=None, fence_fault=None):
    """``(rows, guard reports, chaos counters)`` of one run; with
    ``fence_fault = k`` the guarded runtime's inner ``collect`` (the fence)
    raises on its k-th call."""
    m = make()
    rt = start(m, app)
    if fence_fault is not None:
        _fence_fault(rt.device_bridges[0].guard, fence_fault)
    if columns is None:
        send(rt, events)
    else:
        send_columns(rt, "S", columns, events, chunk=37)
    rt.flush_device()
    out = (rt.got, _guard_report(rt),
           dict(rt.resilience.chaos.counters) if rt.resilience.chaos
           else None)
    m.shutdown()
    return out, rt


def _events(shape: str, n: int = 600, seed: int = 5):
    return stream_events(seed, n, {"S": (1, SHAPES[shape][1])}, gap=9)


# the engine each shape's guard replays on: the columnar host engine where
# the query lowers there (a grouped window does not)
FALLBACK_ENGINE = {"filter": "columnar", "chain": "columnar",
                   "grouped": "scalar"}


@pytest.mark.parametrize("p", [0.25, 1.0])
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_guarded_run_equals_the_reference(shape, mode, p):
    extra = ", async='true'" if mode == "async" else ""
    app = _chaos(p) + SHAPES[shape][0].format(batch=32, extra=extra)
    events = _events(shape)
    (ref, ref_rep, ref_chaos), _ = guarded_run(ref_manager, app, events)
    (got, rep, chaos), prt = guarded_run(port_manager, app, events)
    assert got == ref
    assert rep == ref_rep
    assert chaos == ref_chaos
    (guard,) = rep
    assert guard["failures"] == chaos["device_faults"] > 0
    assert guard["lost_events"] == 0
    if p == 1.0:
        # every batch replayed, the circuit open after the third
        assert guard["fallback_events"] == len(events)
        assert guard["circuit"] == CircuitState.OPEN
    assert guard["fallback_engine"] == FALLBACK_ENGINE[shape]


def test_stateful_fallback_state_starts_at_the_fault():
    """The reference's parity caveat, in both packages: the host fallback
    owns its own state, so a windowed query's guarded rows are the
    reference's guarded rows, not a clean run's."""
    events = _events("grouped")
    app = _chaos(0.25) + GROUPED.format(batch=32, extra="")
    (ref, _, _), _ = guarded_run(ref_manager, app, events)
    (got, _, _), _ = guarded_run(port_manager, app, events)
    (clean, _, _), _ = guarded_run(port_manager, GROUPED.format(
        batch=32, extra=""), events)
    assert got == ref
    assert got != clean
    assert len(got) == len(clean)


def test_stateless_guarded_run_equals_a_clean_run():
    """A filter keeps no state, so its guarded rows are a clean run's, in
    order: the replay runs at the failed batch's own FIFO slot (the replay
    stamps each row with its event's time, the device the batch's last)."""
    events = _events("filter")
    for extra in ("", ", async='true'"):
        app = _chaos(0.25, threshold=1000) + FILTER.format(batch=16,
                                                           extra=extra)
        (got, _, _), _ = guarded_run(port_manager, app, events)
        (clean, _, _), _ = guarded_run(port_manager, FILTER.format(
            batch=16, extra=extra), events)
        assert [r for _, r in got] == [r for _, r in clean]


def _fence_fault(guard, k: int) -> None:
    """The inner ``collect`` that ``guard`` fences through raises on its
    k-th call (the guard installed ``rt.collect`` as a call of its own
    ``collect`` with the runtime's, read at each call)."""
    outer = guard.collect
    calls = [0]

    def collect(inner_collect, token):
        def inner(t):
            calls[0] += 1
            if calls[0] == k:
                raise RuntimeError("fault at the fence")
            return inner_collect(t)
        return outer(inner, token)
    guard.collect = collect


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_fault_at_the_fence_replays_in_order(mode):
    extra = ", async='true'" if mode == "async" else ""
    app = "@app:name('Fence')\n" + FILTER.format(batch=16, extra=extra)
    events = _events("filter", 300)
    (ref, ref_rep, _), _ = guarded_run(ref_manager, app, events,
                                       fence_fault=3)
    (got, rep, _), _ = guarded_run(port_manager, app, events, fence_fault=3)
    assert got == ref
    assert rep == ref_rep
    assert rep[0]["failures"] == 1
    assert 0 < rep[0]["fallback_events"] <= 16
    (clean, _, _), _ = guarded_run(port_manager, FILTER.format(
        batch=16, extra=extra), events)
    assert [r for _, r in got] == [r for _, r in clean]


def _count_dispatches(monkeypatch) -> dict:
    counts = {}
    for name, mod in BRIDGES.items():
        inner = mod._DeviceRTBase.dispatch
        counts[name] = 0

        def dispatch(self, batch, inner=inner, name=name):
            counts[name] += 1
            return inner(self, batch)
        monkeypatch.setattr(mod._DeviceRTBase, "dispatch", dispatch)
    return counts


def test_quarantine_short_circuits_then_the_probe_repromotes(monkeypatch):
    import time
    counts = _count_dispatches(monkeypatch)
    app = ("@app:name('Q')\n@app:chaos(seed='3', device.fail.p='1.0')\n"
           "@app:resilience(device.circuit.threshold='2', "
           "device.circuit.cooldown.ms='40')\n"
           + FILTER.format(batch=2, extra=""))
    events = [("S", ["d1", 60.0 + i], 1000 + i) for i in range(12)]
    runs = {}
    for name, make in MANAGERS.items():
        m = make()
        rt = start(m, app)
        guard = rt.device_bridges[0].guard
        send(rt, events[:4])        # two failing batches → OPEN
        assert guard.breaker.state == CircuitState.OPEN
        before = counts[name]
        send(rt, events[4:8])       # two batches while OPEN
        assert counts[name] == before     # no inner dispatch while OPEN
        assert guard.failures == 2 and guard.fallback_events == 8
        rt.resilience.chaos.device_fail_p = 0.0
        time.sleep(0.06)
        send(rt, events[8:])        # the probe, then the device again
        assert counts[name] == before + 2
        assert guard.breaker.state == CircuitState.CLOSED
        assert guard.fallback_events == 8
        runs[name] = (rt.got, _guard_report(rt))
        m.shutdown()
    assert runs["port"] == runs["ref"]
    assert sorted(r[1] for _, r in runs["port"][0]) == \
        [60.0 + i for i in range(12)]


TIME_BATCH = """
@app:name('TB')
@app:chaos(seed='2', device.fail.p='1.0')
define stream S (dev string, v double);
@device(batch='16', strict='true')
from S#window.timeBatch(100) select count() as n, max(v) as top
insert into Out;
"""


def test_failed_time_batch_step_replays_no_sentinel():
    """The ``timeBatch`` finalize sentinel is staged through
    ``append_sentinel``: it is bookkeeping, so a failed step's replay and
    its ``fallback_events`` hold the real events only (the sentinel goes
    in at shutdown, to close the open bucket)."""
    events = [("S", ["d1", float(i)], 1000 + 7 * i) for i in range(40)]
    outs = {}
    for name, make in MANAGERS.items():
        m = make()
        rt = start(m, TIME_BATCH)
        send(rt, events)
        rt.flush_device()
        m.shutdown()    # finalize: the sentinel closes the last bucket
        outs[name] = (rt.got, _guard_report(rt))
    assert outs["port"] == outs["ref"]
    (guard,) = outs["port"][1]
    assert guard["failures"] > 0
    assert guard["fallback_events"] == len(events)
    assert sum(r[0] for _, r in outs["port"][0]) <= len(events)


def test_columnar_chunks_replay_the_slice_each_batch_took():
    """``send_columns`` chunks of 37 rows over batches of 16: the lazy
    shadow keeps each batch's slices and replays exactly those rows."""
    events = _events("filter", 400)
    for extra in ("", ", async='true'"):
        app = _chaos(0.25, threshold=1000) + FILTER.format(batch=16,
                                                           extra=extra)
        (ref, ref_rep, _), _ = guarded_run(ref_manager, app, events,
                                           columns=["dev", "v"])
        (got, rep, _), _ = guarded_run(port_manager, app, events,
                                       columns=["dev", "v"])
        assert got == ref
        assert rep == ref_rep
        assert rep[0]["failures"] > 0 and rep[0]["lost_events"] == 0
        (clean, _, _), _ = guarded_run(port_manager, FILTER.format(
            batch=16, extra=extra), events)
        assert [r for _, r in got] == [r for _, r in clean]


def test_append_many_batches_count_as_lost():
    """A batch packed through ``append_many`` (bulk, pre-encoded) has no
    row shadow: a failed step counts its events as lost."""
    app = ("@app:name('Bulk')\n@app:chaos(seed='1', device.fail.p='1.0')\n"
           + CHAIN3.format(batch=64, extra=""))
    reps = {}
    for name, make in MANAGERS.items():
        m = make()
        rt = start(m, app)
        bridge = rt.device_bridges[0]
        builder = bridge.runtime.builder
        # pre-encoded columns (a string column would be its codes)
        builder.append_many("S", {"v": np.array([71.0, 72.0, 73.0],
                                                 dtype=np.float32)},
                            np.array([1000, 1001, 1002], dtype=np.int64))
        send(rt, [("S", ["d1", 74.0], 1003)])
        rt.flush_device()
        reps[name] = (_guard_report(rt), rt.got)
        m.shutdown()
    assert reps["port"] == reps["ref"]
    (guard,), got = reps["port"]
    assert guard["failures"] == 1
    assert guard["lost_events"] == 4 and guard["fallback_events"] == 0
    assert got == []


def test_fallback_rows_reach_query_callbacks():
    app = ("@app:name('QC')\n@app:chaos(seed='3', device.fail.p='1.0')\n"
           + FILTER.format(batch=4, extra=""))
    seen = {}
    for name, make in MANAGERS.items():
        pkg = siddhi_tpu if name == "ref" else siddhi_tpu_torch
        m = make()
        rt = start(m, app)
        got = []
        rt.add_query_callback("query-1", pkg.QueryCallback(
            lambda ts, ins, outs: got.extend(list(e.data) for e in ins)))
        send(rt, [("S", ["d1", 40.0 + 5 * i], 1000 + i) for i in range(8)])
        seen[name] = got
        m.shutdown()
    assert seen["port"] == seen["ref"] == \
        [["d1", 55.0], ["d1", 60.0], ["d1", 65.0], ["d1", 70.0],
         ["d1", 75.0]]


# ------------------------------------------------- columnar step guard

HOST_FILTER = """
@app:name('HostGuarded')
@app:host_batch(batch='{batch}')
{resilience}
define stream S (dev string, v double);
@info(name='q') from S[v > 50.0] select dev, v insert into Out;
"""


def host_guarded_run(make, app: str, events, broken: set, chunk: int):
    """``(rows, HostStepGuard reports)`` of ``events`` sent in chunks of
    ``chunk`` rows, the columnar step raising at the steps in ``broken``
    (0-based)."""
    m = make()
    rt = start(m, app)
    hq = rt.host_bridges[0].runtime.hq
    inner, calls = hq.step, [0]

    def step(*a, **k):
        calls[0] += 1
        if calls[0] - 1 in broken:
            raise RuntimeError("columnar step failed")
        return inner(*a, **k)

    hq.step = step
    for lo in range(0, len(events), chunk):
        part = events[lo:lo + chunk]
        rt.input_handler("S").send_rows([list(r) for _, r, _ in part],
                                        [t for _, _, t in part])
    rt.flush_host()
    out = (rt.got, [g.report() for g in rt.resilience.host_guards])
    m.shutdown()
    return out


def test_host_step_guard_replays_a_failed_micro_batch():
    """A columnar micro-batch whose step fails replays on the scalar
    interpreter, in both packages: no event lost, the rows a clean run's in
    order, the guard reports equal."""
    events = _events("filter", n=400)
    app = HOST_FILTER.format(batch=64, resilience="")
    ref = host_guarded_run(ref_manager, app, events, {1, 4}, 40)
    got = host_guarded_run(port_manager, app, events, {1, 4}, 40)
    clean = host_guarded_run(port_manager, app, events, set(), 40)
    assert got == ref
    (rep,) = got[1]
    assert rep["failures"] == 2 and rep["lost_events"] == 0
    assert rep["fallback_events"] == 80
    assert rep["circuit"] == CircuitState.CLOSED
    assert got[0] == clean[0]


def test_host_step_guard_quarantines_under_the_host_keys():
    """``host.circuit.threshold`` failures in a row open the columnar
    path's circuit: later micro-batches drain to the interpreter without a
    step, in both packages, and no event is lost; ``host.quarantine=
    'false'`` installs no guard."""
    events = _events("filter", n=300)
    res = ("@app:resilience(host.circuit.threshold='2', "
           "host.circuit.cooldown.ms='60000')")
    app = HOST_FILTER.format(batch=16, resilience=res)
    every = set(range(100))
    ref = host_guarded_run(ref_manager, app, events, every, 30)
    got = host_guarded_run(port_manager, app, events, every, 30)
    assert got == ref
    (rep,) = got[1]
    assert rep["circuit"] == CircuitState.OPEN
    assert rep["failures"] == 2 and rep["lost_events"] == 0
    assert rep["fallback_events"] == len(events)
    assert [r for _, r in got[0]] == [r for _, r, _ in events if r[1] > 50.0]
    off = HOST_FILTER.format(
        batch=16, resilience="@app:resilience(host.quarantine='false')")
    rt = port_manager().create_siddhi_app_runtime(off, playback=True)
    assert rt.host_bridges and not rt.resilience.host_guards
    rt.shutdown()


def test_gauges_equal_the_reference():
    app = _chaos(0.5, threshold=1000) + FILTER.format(batch=8, extra="")
    events = _events("filter", 200)
    gauges = {}
    for name, make in MANAGERS.items():
        m = make()
        rt = start(m, app)
        send(rt, events)
        rt.flush_device()
        sm = rt.ctx.statistics_manager
        gauges[name] = {k: sm.gauges[k].value for k in sm.gauges
                        if k.startswith(("device.query-1.circuit_state",
                                         "device.query-1.fallback_events",
                                         "chaos."))}
        m.shutdown()
    assert gauges["port"] == gauges["ref"]
    assert gauges["port"]["device.query-1.fallback_events"] > 0
    assert gauges["port"]["chaos.device_faults"] > 0
    assert len(gauges["port"]) == 2 + 7


# ---------------------------------------------- kernel build and load

class _FailingPlan:
    def _lib(self):
        raise OSError("cannot open shared object file")


def test_a_failed_kernel_load_is_a_refusal():
    with pytest.raises(KernelLibraryError, match="did not build or load"):
        port_bridge._load_kernel_library(_FailingPlan(),
                                         torch.device("cuda"))
    assert issubclass(KernelLibraryError, DeviceCompileError)
    # the plain versions on the CPU load no library
    port_bridge._load_kernel_library(_FailingPlan(), torch.device("cpu"))


def test_a_refused_kernel_load_builds_on_the_host(monkeypatch):
    """The engine loads the library before the guard wraps the runtime,
    and a library that fails to load never builds on the host: the app
    raises ``KernelLibraryError`` under ``strict='true'`` and without it,
    while a compiler refusal of a non-strict query still builds there."""
    def refuse(plan, device):
        raise KernelLibraryError(
            "the kernel library did not build or load: test")
    monkeypatch.setattr(port_bridge, "_load_kernel_library", refuse)
    app = _chaos(1.0) + FILTER.format(batch=8, extra="")
    loose = app.replace("strict='true'", "strict='false'")
    for text in (app, loose):
        with pytest.raises(KernelLibraryError, match="did not build or load"):
            port_manager().create_siddhi_app_runtime(text, playback=True)
    # output rate limiting on a window: a compiler refusal, before the load
    refused = loose.replace(
        "from S[v > 50.0] select dev, v insert",
        "from S[v > 50.0]#window.length(3) select dev, v "
        "output last every 2 events insert")
    m = port_manager()
    rt = start(m, refused)
    assert rt.device_bridges == [] and rt.resilience.guards == []
    m.shutdown()


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("where", ["dispatch", "fence"])
def test_a_kernel_fault_on_the_card_is_not_replayed(where, mode, caplog):
    """On the card (``replay_only_chaos``, set here on a CPU runtime) a step
    that fails with anything but an injected ``ChaosFault`` is counted,
    logged as an ERROR and raised, never replayed on the host; every later
    step raises ``DeviceFault`` without reaching the runtime (a batch
    already dispatched when the fault surfaced is not delivered either),
    and the circuit stays CLOSED (an OPEN one would replay them all)."""
    from siddhi_tpu_torch.resilience.device_guard import DeviceFault
    extra = ", async='true'" if mode == "async" else ""
    m = port_manager()
    rt = start(m, FILTER.format(batch=4, extra=extra))
    (bridge,) = rt.device_bridges
    guard = bridge.guard
    guard.replay_only_chaos = True
    runtime = bridge.runtime
    inner = {"dispatch": runtime.dispatch, "collect": runtime.collect}
    steps = [0]
    # the guard installed rt.dispatch/rt.collect as calls of its own
    # dispatch/collect with the runtime's inner step, read at each call
    outer = getattr(guard, where if where == "dispatch" else "collect")

    def failing(inner_step, arg):
        def step(a):
            steps[0] += 1
            if steps[0] == 2:
                raise RuntimeError("illegal memory access")
            return inner_step(a)
        return outer(step, arg)
    setattr(guard, "dispatch" if where == "dispatch" else "collect",
            failing)
    del inner
    raised = []
    events = [("S", ["d1", 60.0 + i], 1000 + i) for i in range(16)]
    with caplog.at_level(logging.ERROR):
        for ev in events:
            try:
                send(rt, [ev])
            except Exception as e:  # noqa: BLE001 — the sync path raises
                # to the sender unless the junction takes it
                raised.append(e)
        try:
            rt.flush_device()
        except Exception as e:  # noqa: BLE001 — same
            raised.append(e)
    rep = guard.report()
    assert rep["failures"] >= 1
    assert rep["fallback_events"] == 0 and rep["lost_events"] == 0
    assert rep["circuit"] == CircuitState.CLOSED
    assert isinstance(guard.fault, RuntimeError)
    assert guard.fault.args == ("illegal memory access",)
    # the first batch delivered from the card, no later one from anywhere
    assert [r for _, r in rt.got] == [["d1", 60.0 + i] for i in range(4)]
    # later steps never reach the runtime
    assert steps[0] == 2
    assert any("not replayed on the host" in r.getMessage()
               for r in caplog.records)
    with pytest.raises(DeviceFault, match="failed earlier"):
        guard.dispatch(lambda b: None, {"count": 1})
    m.shutdown()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA card: the kernel libraries build "
                           "and load only there")
def test_kernel_load_failure_on_the_card_is_never_replayed(monkeypatch):
    """On the card, a library that fails to load raises when the query is
    built, strict or not: no query runs on the interpreter in its place
    and no step ever reaches the guard. A library that loads makes a
    guarded bridge, replaying only injected faults, whose step launches
    the kernel."""
    import siddhi_tpu_torch.gpu._build as build
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    app = FILTER.format(batch=8, extra="")

    def run(text):
        m = siddhi_tpu_torch.SiddhiManager()
        rt = m.create_siddhi_app_runtime(text, playback=True)
        got = []
        rt.add_callback("Out", siddhi_tpu_torch.StreamCallback(
            lambda evs: got.extend(list(e.data) for e in evs)))
        rt.start()
        for i in range(8):
            rt.input_handler("S").send(["d1", 60.0 + i], timestamp=1000 + i)
        rt.flush_device()
        m.shutdown()
        return rt, got

    before = QueryPlan.launches
    rt, got = run(app)
    assert rt.device_bridges[0].guard is not None
    assert rt.device_bridges[0].guard.report()["failures"] == 0
    assert rt.device_bridges[0].guard.replay_only_chaos
    assert QueryPlan.launches > before
    assert got == [["d1", 60.0 + i] for i in range(8)]

    def fail(stem):
        raise OSError(f"lib{stem}: cannot open shared object file")
    monkeypatch.setattr(build, "load", fail)
    before = QueryPlan.launches
    for text in (app, app.replace("strict='true'", "strict='false'")):
        with pytest.raises(KernelLibraryError,
                           match="did not build or load"):
            siddhi_tpu_torch.SiddhiManager().create_siddhi_app_runtime(
                text, playback=True)
    assert QueryPlan.launches == before
