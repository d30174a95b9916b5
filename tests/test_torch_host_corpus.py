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
  function-local imports included. The IO, flow and sink-pipeline modules
  (``PORTED_MODULES``) are bound the same way, name by name: every name the
  port's module defines replaces the reference's in the reference's module
  and in the suite's, and a test double the suite derives from one of those
  classes (a ``Sink``, a ``SourceHandler``) is rebased onto the port's
  class for the call. ``SUITE_ONLY`` picks, for a suite that also tests
  tiers outside this set, the functions it contributes;
- ``NEEDS_UNPORTED`` lists, by id, the suite functions whose app needs a
  tier the port does not have yet, with that tier; the port must still
  refuse them at build time with "not ported yet" naming the tier.
  ``NEEDS_MODULE`` lists the functions that drive a JAX-package module the
  port has no counterpart of yet (``siddhi_tpu/service.py``); the port must
  still lack it.

``test_torch_host_corpus_device.py`` runs both corpora again with a
non-strict ``@device`` on every query.
"""

import importlib
import importlib.util
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

# the reference's module → the port's, bound name by name (every public
# name the port's module defines, where the reference's defines it too)
PORTED_MODULES = {
    "siddhi_tpu.core.debugger": "siddhi_tpu_torch.core.debugger",
    "siddhi_tpu.core.event": "siddhi_tpu_torch.core.event",
    "siddhi_tpu.core.io": "siddhi_tpu_torch.core.io",
    "siddhi_tpu.core.snapshot": "siddhi_tpu_torch.core.snapshot",
    "siddhi_tpu.core.table": "siddhi_tpu_torch.core.table",
    "siddhi_tpu.flow": "siddhi_tpu_torch.flow",
    "siddhi_tpu.flow.adaptive_batch": "siddhi_tpu_torch.flow.adaptive_batch",
    "siddhi_tpu.flow.backpressure": "siddhi_tpu_torch.flow.backpressure",
    "siddhi_tpu.flow.records": "siddhi_tpu_torch.flow.records",
    "siddhi_tpu.flow.recovery": "siddhi_tpu_torch.flow.recovery",
    "siddhi_tpu.flow.wal": "siddhi_tpu_torch.flow.wal",
    "siddhi_tpu.resilience.circuit": "siddhi_tpu_torch.resilience.circuit",
    "siddhi_tpu.resilience.sink_pipeline":
        "siddhi_tpu_torch.resilience.sink_pipeline",
    "siddhi_tpu.tpu.dcn": "siddhi_tpu_torch.gpu.dcn",
    "siddhi_tpu.tpu.expr_compile": "siddhi_tpu_torch.gpu.expr_compile",
}

def ported_names() -> list:
    """``(reference module, name, port object)`` for every bound name."""
    out = []
    for ref_name, port_name in PORTED_MODULES.items():
        ref = importlib.import_module(ref_name)
        port = importlib.import_module(port_name)
        for name, obj in vars(port).items():
            if name.startswith("_") or not hasattr(ref, name) \
                    or inspect.ismodule(obj) \
                    or not getattr(obj, "__module__", "").startswith(
                        "siddhi_tpu_torch."):
                continue
            out.append((ref, name, obj))
    return out


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
          "test_window_corpus", "test_pattern_corpus", "test_handlers",
          "test_flow", "test_integration", "test_edge_rows",
          "test_resilience"]

# suites that also test tiers outside the port's → the functions they
# contribute: the IO tier and the sink pipeline (the rest of
# test_edge_rows holds the columnar host tier, the fleet and the JAX
# package's own parsers and lints; the rest of test_resilience the device
# guard, chaos and the service)
SUITE_ONLY = {
    "test_edge_rows": {
        "test_source_chunk_boundary_parity_fuzz",
        "test_file_source_end_to_end", "test_socket_source_lines",
        "test_socket_source_rows_frames", "test_unpack_columns_round_trip",
        "test_rows_chunk_crosses_broker_intact",
        "test_resilient_sink_chunk_retry",
        "test_resilient_sink_partial_falls_back_per_event",
        "test_parallel_tier_worker_parity",
        "test_parallel_tier_snapshot_restore_mid_stream",
        "test_fleet_stage_columns_parity",
        "test_rows_chunk_with_source_handler_manager",
        "test_line_source_tail_cap", "test_json_lines_mapper_rows",
        "test_send_columns_fallback_paths", "test_send_columns_validation"},
    "test_resilience": {
        "test_circuit_breaker_transitions",
        "test_circuit_success_resets_consecutive_failures",
        "test_wait_policy_retries_until_success",
        "test_wait_policy_does_not_retry_deterministic_bugs",
        "test_retry_policy_bounded_then_escalates_to_store",
        "test_retry_policy_succeeds_within_bounds",
        "test_stream_policy_routes_to_fault_junction",
        "test_log_policy_drops_and_counts", "test_bad_on_error_policy_rejected",
        "test_sink_replay_targets_only_the_failed_sink",
        "test_multi_receiver_failure_stores_event_once",
        "test_sink_circuit_opens_then_half_open_probe_recovers",
        "test_wait_policy_waits_out_open_circuit",
        "test_stream_policy_without_consumer_escalates_to_drop",
        "test_wait_policy_aborts_on_shutdown",
        "test_on_error_store_replay_downstream_sees_event_once",
        "test_replay_id_range", "test_replay_while_still_failing_restores_entry",
        "test_file_error_store_survives_restart",
        "test_error_store_service_endpoints",
        "test_fault_event_carries_exception_object",
        "test_every_receiver_failure_is_counted",
        "test_chunk_failure_attributed_to_failing_event",
        "test_connect_with_retry_configurable_delays_and_jitter",
        "test_connect_with_retry_aborts_on_shutdown",
        "test_device_failure_falls_back_to_host_no_loss",
        "test_device_quarantine_repromotes_after_cooldown",
        "test_device_quarantine_parity_vs_host",
        "test_device_quarantine_optout",
        "test_device_fallback_reaches_query_callbacks",
        "test_sink_replay_that_drops_counts_as_failed",
        "test_sink_without_policy_inherits_stream_on_error",
        "test_sink_drop_notifies_exception_listener",
        "test_negative_retry_delays_rejected_at_build",
        "test_bad_retry_delays_rejected_at_build",
        "test_chaos_smoke_no_event_loss", "test_chaos_soak_no_event_loss",
        "test_chaos_source_fault_contained_in_app"},
}

# run above case by case, or about the JAX package's device compiler only
NOT_SUITE_FUNCTIONS = {
    ("test_window_corpus", "test_window_corpus_counts"),
    ("test_pattern_corpus", "test_reference_corpus"),
    ("test_pattern_corpus", "test_device_compilable_floor"),
}

# suite function id → the tier its app needs, which the port refuses
NEEDS_UNPORTED: dict[str, str] = {
    **{f"test_edge_rows::{name}": "the columnar host tier" for name in (
        "test_source_chunk_boundary_parity_fuzz",
        "test_file_source_end_to_end", "test_socket_source_lines",
        "test_socket_source_rows_frames",
        "test_rows_chunk_crosses_broker_intact",
        "test_resilient_sink_chunk_retry",
        "test_resilient_sink_partial_falls_back_per_event",
        "test_parallel_tier_worker_parity",
        "test_parallel_tier_snapshot_restore_mid_stream",
        "test_json_lines_mapper_rows", "test_send_columns_fallback_paths",
        "test_send_columns_validation")},
    "test_edge_rows::test_fleet_stage_columns_parity":
        "the multi-tenant fleet tier",
    "test_resilience::test_device_failure_falls_back_to_host_no_loss":
        "the resilience subsystem",
    "test_resilience::test_device_quarantine_repromotes_after_cooldown":
        "the resilience subsystem",
    "test_resilience::test_device_quarantine_parity_vs_host":
        "the resilience subsystem",
    "test_resilience::test_device_quarantine_optout":
        "the resilience subsystem",
    "test_resilience::test_device_fallback_reaches_query_callbacks":
        "the resilience subsystem",
    "test_resilience::test_chaos_smoke_no_event_loss":
        "the resilience subsystem",
    "test_resilience::test_chaos_soak_no_event_loss":
        "the resilience subsystem",
    "test_resilience::test_chaos_source_fault_contained_in_app":
        "the resilience subsystem",
}

# suite function id → the JAX-package module it drives, which the port does
# not have yet (the port must still lack it)
NEEDS_MODULE: dict[str, str] = {
    "test_flow::test_service_flow_endpoints": "service",
    "test_resilience::test_error_store_service_endpoints": "service",
}


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
        only = SUITE_ONLY.get(modname)
        for name, fn in vars(mod).items():
            if not name.startswith("test_") or not inspect.isfunction(fn) \
                    or (modname, name) in NOT_SUITE_FUNCTIONS \
                    or (only is not None and name not in only):
                continue
            for suffix, kwargs in _param_sets(fn):
                fid = f"{modname}::{name}{suffix}"
                out.append(pytest.param(modname, name, kwargs, id=fid))
    return out


SUITE_FUNCTIONS = suite_functions()


def bind_port_names(monkeypatch, mod, request) -> set:
    """The reference's public names → the port's, in ``mod`` and on the
    ``siddhi_tpu`` package (function-local imports read the package), and
    every name of ``PORTED_MODULES`` in the reference's module and in
    ``mod``; ``mod``'s own classes derived from a bound class are rebased
    onto the port's. Returns the names of ``mod`` now bound to the port."""
    bound = set()
    for name, obj in BINDINGS.items():
        if name in vars(mod):
            monkeypatch.setattr(mod, name, obj)
            bound.add(name)
        monkeypatch.setattr(siddhi_tpu, name, obj, raising=False)
    monkeypatch.setattr(siddhi_tpu.core.errors, "SiddhiAppCreationError",
                        SiddhiAppCreationError)
    port_of = {}                # id(reference object) → the port's
    for ref, name, obj in ported_names():
        port_of[id(getattr(ref, name))] = obj
        monkeypatch.setattr(ref, name, obj)
    for name, val in list(vars(mod).items()):
        if name in bound:
            continue
        if id(val) in port_of:
            monkeypatch.setattr(mod, name, port_of[id(val)])
            bound.add(name)
        elif inspect.isclass(val) and val.__module__ == mod.__name__ \
                and any(id(b) in port_of for b in val.__bases__):
            # rebased here and back at teardown (``monkeypatch`` would
            # delete ``__bases__`` at undo: it is not in the class dict)
            old = val.__bases__
            val.__bases__ = tuple(port_of.get(id(b), b) for b in old)
            request.addfinalizer(
                lambda c=val, b=old: setattr(c, "__bases__", b))
            bound.add(name)
    # function-local imports from the reference's modules get the port's
    return bound | {name for _, name, _ in ported_names()}


def autouse_fixtures(mod) -> list:
    """The plain functions of ``mod``'s own autouse fixtures."""
    out = []
    for val in vars(mod).values():
        marker = getattr(val, "_fixture_function_marker", None)
        if marker is not None and marker.autouse:
            out.append(val.__wrapped__)
    return out


def call_suite_function(mod, fn, kwargs: dict, tmp_path, caplog) -> None:
    """Calls ``fn`` with ``kwargs``; of the suites' fixtures, ``manager`` is
    the port's manager (shut down after, and the port's broker reset, as
    the suites' fixture does), ``tmp_path`` and ``caplog`` the caller's;
    ``mod``'s autouse fixtures run around the call."""
    manager = None
    fixtures = {"tmp_path": tmp_path, "caplog": caplog}
    for p in inspect.signature(fn).parameters:
        if p in kwargs:
            continue
        if p in fixtures:
            kwargs = dict(kwargs, **{p: fixtures[p]})
            continue
        if p != "manager":
            raise AssertionError(f"{mod.__name__}.{fn.__name__}: fixture "
                                 f"'{p}' has no port counterpart here")
        manager = PortManager()
        kwargs = dict(kwargs, manager=manager)
    gens = []
    for fixture in autouse_fixtures(mod):
        g = fixture()
        if inspect.isgenerator(g):
            next(g)
            gens.append(g)
    try:
        fn(**kwargs)
    finally:
        if manager is not None:
            manager.shutdown()
        siddhi_tpu_torch.InMemoryBroker.reset()
        for g in gens:
            next(g, None)


def names_used(fn) -> set:
    """Global names ``fn``'s code reads, its nested functions' included."""
    out, stack = set(), [fn.__code__]
    while stack:
        code = stack.pop()
        out.update(code.co_names)
        stack.extend(c for c in code.co_consts if inspect.iscode(c))
    return out


@pytest.mark.parametrize("modname,fname,kwargs", SUITE_FUNCTIONS)
def test_reference_suite_function_on_the_port(modname, fname, kwargs,
                                              request, monkeypatch, tmp_path,
                                              caplog):
    mod = importlib.import_module(modname)
    fn = getattr(mod, fname)
    fid = request.node.callspec.id
    missing = NEEDS_MODULE.get(fid)
    if missing is not None:
        assert importlib.util.find_spec(f"siddhi_tpu.{missing}") is not None
        assert importlib.util.find_spec(
            f"siddhi_tpu_torch.{missing}") is None
        return
    bound = bind_port_names(monkeypatch, mod, request)
    tier = NEEDS_UNPORTED.get(fid)
    built = PortManager.built
    if tier is None:
        call_suite_function(mod, fn, kwargs, tmp_path, caplog)
        # an engine function builds the port's engine; a unit function
        # calls a class or function bound to the port's
        assert PortManager.built > built or names_used(fn) & bound, \
            "the function ran nothing of the port"
        return
    with pytest.raises(SiddhiAppCreationError, match="not ported yet") as e:
        call_suite_function(mod, fn, kwargs, tmp_path, caplog)
    assert tier in str(e.value)


def test_suites_are_all_collected():
    """Every suite contributes functions; the unported list names only
    collected ids."""
    mods = {p.values[0] for p in SUITE_FUNCTIONS}
    assert mods == set(SUITES)
    ids = {p.id for p in SUITE_FUNCTIONS}
    assert set(NEEDS_UNPORTED) <= ids
    assert set(NEEDS_MODULE) <= ids
    for modname, only in SUITE_ONLY.items():
        assert only <= set(vars(importlib.import_module(modname)))
    assert len(SUITE_FUNCTIONS) > 120
