"""The JAX package's behavioural suites, run on the port's host interpreter.

The reference suites are imported as data, never edited:

- every case of ``test_window_corpus.CASES`` and ``test_pattern_corpus.CASES``
  runs on both engines, ``siddhi_tpu.SiddhiManager()`` and
  ``siddhi_tpu_torch.SiddhiManager(device="cpu")``, driven the way the
  corpus drives the reference (playback clock, the corpus's gaps and
  ``advance_time``). The callbacks' rows, current and expired, must be
  equal in order, timestamps included, and the port's must meet the
  corpus's own expectation (its counts, or its rows);
- the ``test_*`` functions of the function suites (``SUITES``) are called
  with the reference's public names (``SiddhiManager``, ``StreamCallback``,
  ``QueryCallback``, ``Event``, ``SiddhiAppCreationError``) bound to the
  port's, in the suite's module and on the ``siddhi_tpu`` package, for the
  duration of the call: the reference's own assertions judge the port, the
  function-local imports included;
- ``NEEDS_UNPORTED`` lists, by id, the suite functions whose app needs a
  tier the port does not have yet, with that tier; the port must still
  refuse them at build time with "not ported yet" naming the tier.

``test_torch_host_corpus_device.py`` runs both corpora again with a
non-strict ``@device`` on every query.
"""

import importlib
import inspect

import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError

import test_pattern_corpus as pattern_corpus
import test_window_corpus as window_corpus


class PortManager(siddhi_tpu_torch.SiddhiManager):
    """The port's engine on the CPU (the kernels' plain versions), built the
    way the suites build the reference's: with no argument. ``built``
    counts the engines made, so a test can show the port ran."""

    built = 0

    def __init__(self, device="cpu"):
        super().__init__(device=device)
        PortManager.built += 1


# the reference's public names → the port's
BINDINGS = {
    "SiddhiManager": PortManager,
    "StreamCallback": siddhi_tpu_torch.StreamCallback,
    "QueryCallback": siddhi_tpu_torch.QueryCallback,
    "Event": siddhi_tpu_torch.Event,
    "SiddhiAppCreationError": SiddhiAppCreationError,
}


# ----------------------------------------------------------------- corpora

def run_window_case(manager_cls, pkg, app: str, sends, end: int = 0,
                    start: int = 1000):
    """``test_window_corpus.run_case`` on ``manager_cls``: every call of the
    query callback on ``q`` as ``(ts, current rows, expired rows)``."""
    m = manager_cls()
    rt = m.create_siddhi_app_runtime(app, playback=True, start_time=start)
    calls = []

    class _CB(pkg.QueryCallback):
        def receive(self, ts, current, expired):
            calls.append((ts, [list(e.data) for e in current or []],
                          [list(e.data) for e in expired or []]))

    rt.add_query_callback("q", _CB())
    rt.start()
    ts = start
    for sid, row, gap in sends:
        ts += gap
        rt.input_handler(sid).send(list(row), timestamp=ts)
    if end:
        rt.advance_time(ts + end)
    m.shutdown()
    return calls, rt


def run_pattern_case(manager_cls, pkg, app: str, seq, end: int = 0):
    """``test_pattern_corpus._run_host`` on ``manager_cls``: the output
    stream's events as ``(ts, data, expired)``."""
    start = pattern_corpus.START
    m = manager_cls()
    rt = m.create_siddhi_app_runtime(app, playback=True, start_time=start)
    rows = []
    out = "OutputStream" if "OutputStream" in app else "StockQuote"
    rt.add_callback(out, pkg.StreamCallback(lambda evs: rows.extend(
        (e.timestamp, list(e.data), e.is_expired) for e in evs)))
    rt.start()
    ts = start
    for entry in seq:
        sid, row = entry[0], entry[1]
        ts += entry[2] if len(entry) > 2 else 100
        rt.input_handler(sid).send(list(row), timestamp=ts)
    if end:
        rt.advance_time(ts + end)
    m.shutdown()
    return rows, rt


def by_id(cases) -> dict:
    """A corpus's ``pytest.param`` values by case id."""
    return {p.id: p.values for p in cases}


WINDOW_CASES = by_id(window_corpus.CASES)
PATTERN_CASES = by_id(pattern_corpus.CASES)


@pytest.mark.parametrize("cid", list(WINDOW_CASES))
def test_window_corpus_case(cid):
    app, sends, n_in, n_remove, end = WINDOW_CASES[cid]
    ref, _ = run_window_case(siddhi_tpu.SiddhiManager, siddhi_tpu, app,
                             sends, end)
    got, prt = run_window_case(PortManager, siddhi_tpu_torch, app, sends,
                               end)
    assert not prt.device_bridges
    assert got == ref
    assert sum(len(c) for _, c, _ in got) == n_in
    assert sum(len(x) for _, _, x in got) == n_remove


@pytest.mark.parametrize("cid", list(PATTERN_CASES))
def test_pattern_corpus_case(cid):
    app, seq, expect, end, _ = PATTERN_CASES[cid]
    ref, _ = run_pattern_case(siddhi_tpu.SiddhiManager, siddhi_tpu, app,
                              seq, end)
    got, prt = run_pattern_case(PortManager, siddhi_tpu_torch, app, seq, end)
    assert not prt.device_bridges
    assert got == ref
    rows = [r for _, r, _ in got]
    if isinstance(expect, int):
        assert len(rows) == expect
    else:
        assert pattern_corpus._rows_match(rows, expect), rows


# ----------------------------------------------------------- function suites

SUITES = ["test_partition_corpus", "test_join_corpus", "test_filter_query",
          "test_sequence", "test_ratelimit_corpus", "test_executor_corpus",
          "test_windows", "test_pattern", "test_join", "test_table",
          "test_window_corpus", "test_pattern_corpus"]

# run above case by case, or about the JAX package's device compiler only
NOT_SUITE_FUNCTIONS = {
    ("test_window_corpus", "test_window_corpus_counts"),
    ("test_pattern_corpus", "test_reference_corpus"),
    ("test_pattern_corpus", "test_device_compilable_floor"),
}

# suite function id → the tier its app needs, which the port refuses
NEEDS_UNPORTED: dict[str, str] = {}


def _param_sets(fn) -> list:
    """``(id suffix, kwargs)`` for each case of ``fn``'s ``parametrize``
    mark (the suites stack none), or ``("", {})`` without one."""
    marks = [m for m in getattr(fn, "pytestmark", [])
             if m.name == "parametrize"]
    if not marks:
        return [("", {})]
    (mark,) = marks
    names, values = mark.args[0], mark.args[1]
    names = [n.strip() for n in names.split(",")] \
        if isinstance(names, str) else list(names)
    out = []
    for i, v in enumerate(values):
        vid = None
        if hasattr(v, "values") and hasattr(v, "marks"):   # pytest.param
            vid, v = v.id, v.values
        elif len(names) == 1:
            v = (v,)
        if vid is None:
            vid = "-".join(str(x) if isinstance(x, (int, float, str, bool))
                           else f"{names[k]}{i}" for k, x in enumerate(v))
        out.append((f"[{vid}]", dict(zip(names, v))))
    return out


def suite_functions() -> list:
    out = []
    for modname in SUITES:
        mod = importlib.import_module(modname)
        for name, fn in vars(mod).items():
            if not name.startswith("test_") or not inspect.isfunction(fn) \
                    or (modname, name) in NOT_SUITE_FUNCTIONS:
                continue
            for suffix, kwargs in _param_sets(fn):
                fid = f"{modname}::{name}{suffix}"
                out.append(pytest.param(modname, name, kwargs, id=fid))
    return out


SUITE_FUNCTIONS = suite_functions()


def bind_port_names(monkeypatch, mod) -> None:
    """The reference's public names → the port's, in ``mod`` and on the
    ``siddhi_tpu`` package (function-local imports read the package)."""
    for name, obj in BINDINGS.items():
        if name in vars(mod):
            monkeypatch.setattr(mod, name, obj)
        monkeypatch.setattr(siddhi_tpu, name, obj, raising=False)
    monkeypatch.setattr(siddhi_tpu.core.errors, "SiddhiAppCreationError",
                        SiddhiAppCreationError)


def call_suite_function(mod, fn, kwargs: dict) -> None:
    """Calls ``fn`` with ``kwargs``; the suites' one fixture, ``manager``,
    is the port's manager (shut down after)."""
    manager = None
    for p in inspect.signature(fn).parameters:
        if p in kwargs:
            continue
        if p != "manager":
            raise AssertionError(f"{mod.__name__}.{fn.__name__}: fixture "
                                 f"'{p}' has no port counterpart here")
        manager = PortManager()
        kwargs = dict(kwargs, manager=manager)
    try:
        fn(**kwargs)
    finally:
        if manager is not None:
            manager.shutdown()


@pytest.mark.parametrize("modname,fname,kwargs", SUITE_FUNCTIONS)
def test_reference_suite_function_on_the_port(modname, fname, kwargs,
                                              request, monkeypatch):
    mod = importlib.import_module(modname)
    fn = getattr(mod, fname)
    bind_port_names(monkeypatch, mod)
    fid = request.node.callspec.id
    tier = NEEDS_UNPORTED.get(fid)
    built = PortManager.built
    if tier is None:
        call_suite_function(mod, fn, kwargs)
        assert PortManager.built > built, "the function built no port engine"
        return
    with pytest.raises(SiddhiAppCreationError, match="not ported yet") as e:
        call_suite_function(mod, fn, kwargs)
    assert tier in str(e.value)


def test_suites_are_all_collected():
    """Every suite contributes functions; the unported list names only
    collected ids."""
    mods = {p.values[0] for p in SUITE_FUNCTIONS}
    assert mods == set(SUITES)
    ids = {p.id for p in SUITE_FUNCTIONS}
    assert set(NEEDS_UNPORTED) <= ids
    assert len(SUITE_FUNCTIONS) > 120
