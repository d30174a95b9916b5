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
  function-local imports included. The IO, flow, sink-pipeline,
  observability, service, doc-generator, columnar host, fleet, mesh and
process-mesh modules
  (``PORTED_MODULES``; for a suite, ``SUITE_MODULES`` too) are
  bound the same way, name by name: every name the
  port's module defines replaces the reference's in the reference's module
  and in the suite's, and a test double the suite derives from one of those
  classes (a ``Sink``, a ``SourceHandler``) is rebased onto the port's
  class for the call. The suite's own fixtures (``manager``, ``rt``) are
  called as pytest would, and pytest's ``tmp_path``, ``caplog`` and
  ``monkeypatch`` are the caller's. A service the suite builds without a
  manager builds the port's on the CPU. ``SUITE_ONLY`` picks, for a suite that
  also tests tiers outside this set, the functions it contributes; a
  function the suite marks ``slow`` or ``skipif`` keeps the mark;
  ``COLUMNAR`` lists the functions that drive the columnar host tier, and
  each must reach the port's (a host bridge, a stager, or an
  ``@app:host_batch`` config read);
- ``NEEDS_MODULE`` lists the functions that drive a JAX-package module the
  port has no counterpart of yet, with its tier; the port must still lack
  it (none is left since the DCN guard came with distribution);
- ``DCNWorker`` is bound to ``PortDCNWorker``, the port's worker on the CPU
  unless a device is asked for, as ``SiddhiManager`` is bound to
  ``PortManager``; ``MeshFabric`` to ``PortMeshFabric``, the port's fabric
  with every host on the CPU: in process mode each host is a worker
  process of the port's on the CPU, and ``PortSpawns`` shows that every
  function that built such a fabric spawned the port's worker
  (``python -m siddhi_tpu_torch.procmesh.worker ... --device cpu``); the
  workers a function spawned are killed after it (by process, and by the
  runfiles under its ``tmp_path``), so none outlives it.

The process mesh's suites (``PROCMESH_SUITES``) run in
``test_torch_host_corpus_procmesh.py``, through this harness, so that
``--dist loadfile`` gives them a worker of their own.
``test_torch_host_corpus_device.py`` runs both corpora again with a
non-strict ``@device`` on every query.
"""

import importlib
import importlib.util
import inspect
import json
import os
import signal
import sys

import pytest

import siddhi_tpu
import siddhi_tpu_torch
import siddhi_tpu_torch.gpu.dcn
import siddhi_tpu_torch.mesh
import siddhi_tpu_torch.procmesh.supervisor as port_supervisor
import siddhi_tpu_torch.service as port_service
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError

import test_pattern_corpus as pattern_corpus
import test_window_corpus as window_corpus


class PortManager(siddhi_tpu_torch.SiddhiManager):
    """The port's engine on the CPU (the kernels' plain versions), built the
    way the suites build the reference's: with no argument. ``built``
    counts the engines made, so a test can show the port ran."""

    built = 0

    def __init__(self, device=None):
        super().__init__(device=device or "cpu")
        PortManager.built += 1


class PortDCNWorker(siddhi_tpu_torch.gpu.dcn.DCNWorker):
    """The port's DCN worker with its shards on the CPU (the kernels' plain
    versions), built the way the suites build the reference's: with no
    device. ``built`` counts the workers made, so a test can show that the
    port's worker served it."""

    built = 0

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device=device or "cpu", **kwargs)
        PortDCNWorker.built += 1


class PortMeshFabric(siddhi_tpu_torch.mesh.MeshFabric):
    """The port's mesh fabric with every host's engine on the CPU (the
    kernels' plain versions), built the way the suites build the
    reference's: with no device. ``built`` counts the fabrics made, so a
    test can show that the port's fabric served it."""

    built = 0
    process_built = 0           # of them in mode='process'

    def __init__(self, *args, device=None, **kwargs):
        cfg = kwargs.get("config", args[2] if len(args) > 2 else None)
        if cfg is not None and cfg.mode == "process":
            PortMeshFabric.process_built += 1
        super().__init__(*args, device=device or "cpu", **kwargs)
        PortMeshFabric.built += 1


class PortSpawns:
    """While open, records every worker the port's supervisor spawns (its
    command line and process); ``close`` kills those still alive, and the
    workers whose runfiles lie under ``root``, as the reference's
    ``tests/test_parent_recovery.py::_kill_leftover_workers`` does."""

    def __init__(self, monkeypatch, root):
        self.root = str(root)
        self.cmds: list = []
        self.procs: list = []
        orig = port_supervisor.ProcMeshSupervisor._spawn
        spawns = self

        def spawn(sup, h):
            orig(sup, h)
            spawns.cmds.append(list(h.proc.args))
            spawns.procs.append(h.proc)

        monkeypatch.setattr(port_supervisor.ProcMeshSupervisor, "_spawn",
                            spawn)

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=10)
        kill_leftover_workers(self.root)


def kill_leftover_workers(root: str) -> list:
    """SIGKILLs every worker whose runfile (``<dir>/run/w<i>.run``)
    survives anywhere under ``root``; returns their pids."""
    killed = []
    for dirpath, _dirs, files in os.walk(root):
        if os.path.basename(dirpath) != "run":
            continue
        for name in sorted(files):
            if not name.endswith(".run"):
                continue
            try:
                with open(os.path.join(dirpath, name),
                          encoding="utf-8") as f:
                    pid = int(json.load(f)["pid"])
                os.kill(pid, signal.SIGKILL)
                killed.append(pid)
            except (OSError, ValueError, KeyError):
                continue
    return killed


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
    "siddhi_tpu.core.aggregation": "siddhi_tpu_torch.core.aggregation",
    "siddhi_tpu.core.columns": "siddhi_tpu_torch.core.columns",
    "siddhi_tpu.core.config": "siddhi_tpu_torch.core.config",
    "siddhi_tpu.core.debugger": "siddhi_tpu_torch.core.debugger",
    "siddhi_tpu.core.event": "siddhi_tpu_torch.core.event",
    "siddhi_tpu.core.extension": "siddhi_tpu_torch.core.extension",
    "siddhi_tpu.core.host_bridge": "siddhi_tpu_torch.core.host_bridge",
    "siddhi_tpu.core.io": "siddhi_tpu_torch.core.io",
    "siddhi_tpu.core.metrics": "siddhi_tpu_torch.core.metrics",
    "siddhi_tpu.core.snapshot": "siddhi_tpu_torch.core.snapshot",
    "siddhi_tpu.core.table": "siddhi_tpu_torch.core.table",
    "siddhi_tpu.doc_gen": "siddhi_tpu_torch.doc_gen",
    "siddhi_tpu.flow": "siddhi_tpu_torch.flow",
    "siddhi_tpu.flow.adaptive_batch": "siddhi_tpu_torch.flow.adaptive_batch",
    "siddhi_tpu.flow.backpressure": "siddhi_tpu_torch.flow.backpressure",
    "siddhi_tpu.flow.records": "siddhi_tpu_torch.flow.records",
    "siddhi_tpu.flow.recovery": "siddhi_tpu_torch.flow.recovery",
    "siddhi_tpu.flow.wal": "siddhi_tpu_torch.flow.wal",
    "siddhi_tpu.mesh": "siddhi_tpu_torch.mesh",
    "siddhi_tpu.mesh.fabric": "siddhi_tpu_torch.mesh.fabric",
    "siddhi_tpu.mesh.plan": "siddhi_tpu_torch.mesh.plan",
    "siddhi_tpu.mesh.rebalancer": "siddhi_tpu_torch.mesh.rebalancer",
    "siddhi_tpu.fleet": "siddhi_tpu_torch.fleet",
    "siddhi_tpu.fleet.cache": "siddhi_tpu_torch.fleet.cache",
    "siddhi_tpu.fleet.group": "siddhi_tpu_torch.fleet.group",
    "siddhi_tpu.fleet.manager": "siddhi_tpu_torch.fleet.manager",
    "siddhi_tpu.fleet.shape": "siddhi_tpu_torch.fleet.shape",
    "siddhi_tpu.query_api.definition": "siddhi_tpu_torch.query_api.definition",
    "siddhi_tpu.observability": "siddhi_tpu_torch.observability",
    "siddhi_tpu.observability.flight_recorder":
        "siddhi_tpu_torch.observability.flight_recorder",
    "siddhi_tpu.observability.histogram":
        "siddhi_tpu_torch.observability.histogram",
    "siddhi_tpu.observability.phases": "siddhi_tpu_torch.observability.phases",
    "siddhi_tpu.observability.profiler":
        "siddhi_tpu_torch.observability.profiler",
    "siddhi_tpu.observability.prometheus":
        "siddhi_tpu_torch.observability.prometheus",
    "siddhi_tpu.observability.slo": "siddhi_tpu_torch.observability.slo",
    "siddhi_tpu.observability.tracing":
        "siddhi_tpu_torch.observability.tracing",
    "siddhi_tpu.procmesh": "siddhi_tpu_torch.procmesh",
    "siddhi_tpu.procmesh.host": "siddhi_tpu_torch.procmesh.host",
    "siddhi_tpu.procmesh.journal": "siddhi_tpu_torch.procmesh.journal",
    "siddhi_tpu.procmesh.lanepool": "siddhi_tpu_torch.procmesh.lanepool",
    "siddhi_tpu.procmesh.parentmain": "siddhi_tpu_torch.procmesh.parentmain",
    "siddhi_tpu.procmesh.protocol": "siddhi_tpu_torch.procmesh.protocol",
    "siddhi_tpu.procmesh.supervisor": "siddhi_tpu_torch.procmesh.supervisor",
    "siddhi_tpu.procmesh.worker": "siddhi_tpu_torch.procmesh.worker",
    "siddhi_tpu.resilience": "siddhi_tpu_torch.resilience",
    "siddhi_tpu.resilience.chaos": "siddhi_tpu_torch.resilience.chaos",
    "siddhi_tpu.resilience.circuit": "siddhi_tpu_torch.resilience.circuit",
    "siddhi_tpu.resilience.dcn_guard":
        "siddhi_tpu_torch.resilience.dcn_guard",
    "siddhi_tpu.resilience.device_guard":
        "siddhi_tpu_torch.resilience.device_guard",
    "siddhi_tpu.resilience.fleet_guard":
        "siddhi_tpu_torch.resilience.fleet_guard",
    "siddhi_tpu.resilience.sink_pipeline":
        "siddhi_tpu_torch.resilience.sink_pipeline",
    "siddhi_tpu.service": "siddhi_tpu_torch.service",
    "siddhi_tpu.tpu.batch": "siddhi_tpu_torch.gpu.batch",
    "siddhi_tpu.tpu.dcn": "siddhi_tpu_torch.gpu.dcn",
    "siddhi_tpu.tpu.expr_compile": "siddhi_tpu_torch.gpu.expr_compile",
    "siddhi_tpu.tpu.host_exec": "siddhi_tpu_torch.gpu.host_exec",
}

# a bound name whose port object is the harness's subclass of the port's
PORT_CLASSES = {("siddhi_tpu.tpu.dcn", "DCNWorker"): PortDCNWorker,
                ("siddhi_tpu.mesh", "MeshFabric"): PortMeshFabric,
                ("siddhi_tpu.mesh.fabric", "MeshFabric"): PortMeshFabric}

# the module-level registries of a bound module that a suite fills: bound
# too, so what the suite registers reaches the port's classes
REGISTRIES = {"siddhi_tpu.core.metrics": ("REPORTERS",)}

# bound for one suite only, on top of PORTED_MODULES: test_fleet parses its
# tenants' texts and normalizes their queries for the shared device plans
# (function-local imports of the parser and the query API)
SUITE_MODULES = {
    "test_fleet": {"siddhi_tpu.compiler": "siddhi_tpu_torch.compiler",
                   "siddhi_tpu.query_api": "siddhi_tpu_torch.query_api"},
}

# a reference module a suite imports whole inside a function and then
# monkeypatches (``import siddhi_tpu.procmesh.host as host_mod``): for that
# suite the module itself is the port's, in ``sys.modules`` and on its
# package, for the call
SUITE_ALIASES = {"test_gray_failure": ("siddhi_tpu.procmesh.host",)}


def ported_names(suite: str = "") -> list:
    """``(reference module, name, port object)`` for every bound name (and
    for those ``suite`` binds on top)."""
    out = []
    for ref_name, port_name in {**PORTED_MODULES,
                                **SUITE_MODULES.get(suite, {})}.items():
        ref = importlib.import_module(ref_name)
        port = importlib.import_module(port_name)
        for name, obj in vars(port).items():
            if name.startswith("_") or not hasattr(ref, name) \
                    or inspect.ismodule(obj) \
                    or not getattr(obj, "__module__", "").startswith(
                        "siddhi_tpu_torch."):
                continue
            out.append((ref, name, PORT_CLASSES.get((ref_name, name), obj)))
        out.extend((ref, name, getattr(port, name))
                   for name in REGISTRIES.get(ref_name, ()))
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
          "test_resilience", "test_management", "test_on_demand_corpus",
          "test_aggregation_purge", "test_persisted_aggregation",
          "test_incremental_persistence", "test_cache_table",
          "test_record_pushdown", "test_config", "test_metrics",
          "test_torn_fuzz", "test_bridge_fuzz", "test_device_pipeline",
          "test_observability", "test_xray", "test_service_and_docs",
          "test_host_batch", "test_fleet_guard",
          "test_fleet", "test_slo", "test_dcn", "test_dcn_resilience",
          "test_mesh"]

# the process mesh's suites (test_torch_host_corpus_procmesh.py runs them)
PROCMESH_SUITES = ["test_procmesh", "test_federation", "test_gray_failure",
                   "test_parent_recovery"]

# suites that also test tiers outside the port's → the functions they
# contribute: the IO tier, the sink pipeline, the columnar host tier and
# the fleet (the rest of test_edge_rows holds the JAX package's own parsers
# and lints; the rest of test_resilience the JAX package's except-clause
# lint)
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
        "test_send_columns_fallback_paths", "test_send_columns_validation",
        "test_zero_objects_on_rows_path",
        "test_stager_mixed_rows_and_columns_order"},
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
        "test_chaos_injector_deterministic",
        "test_chaos_smoke_no_event_loss", "test_chaos_soak_no_event_loss",
        "test_chaos_source_fault_contained_in_app"},
}

# run above case by case, or driving only the JAX package's own code
NOT_SUITE_FUNCTIONS = {
    ("test_window_corpus", "test_window_corpus_counts"),
    ("test_pattern_corpus", "test_reference_corpus"),
    ("test_pattern_corpus", "test_device_compilable_floor"),
    # runs the JAX package's bench.py in a subprocess
    ("test_device_pipeline", "test_bench_survives_sigkilled_phase"),
    # runs the JAX package's scripts/check_bench_regression.py
    ("test_device_pipeline",
     "test_device_latency_guard_tolerates_partial_reports"),
    # spawns the JAX package's own DCN worker as host 1
    # (tests/test_torch_dcn.py::test_two_process_dcn_ingest_routing spawns
    # the port's)
    ("test_dcn", "test_two_process_dcn_ingest_routing"),
    # SIGKILLs and restarts the JAX package's own DCN worker process
    # (tests/test_torch_dcn.py::test_kill_peer_soak_exactly_once does it to
    # the port's)
    ("test_dcn_resilience", "test_kill_peer_soak_exactly_once"),
    # run the JAX package's scripts/check_socket_timeouts.py over its sources
    # and on its own offender file (tests/test_torch_dcn.py::
    # test_socket_timeout_lint_finds_nothing_in_the_port loads the script
    # as data and checks the port's DCN modules with it)
    ("test_dcn_resilience", "test_check_socket_timeouts_lint_passes"),
    ("test_dcn_resilience",
     "test_check_socket_timeouts_lint_catches_offenders"),
    # run the JAX package's scripts/check_metric_names.py over its render
    ("test_observability", "test_check_metric_names_lint_passes"),
    # the JAX package's metric-name lint on literal exposition text
    ("test_observability", "test_check_metric_names_catches_offenders"),
    ("test_xray", "test_metric_lint_catches_exemplar_and_cardinality_offenders"),
    # runs the JAX package's scripts/check_span_coverage.py over its sources
    ("test_xray", "test_check_span_coverage_lint_passes"),
    # the extension's metadata is built at import from the JAX package's
    # DataType, which no binding reaches and the port's validator refuses
    # (tests/test_torch_observability.py holds the port's validator)
    ("test_service_and_docs", "test_validate_extension_args"),
    ("test_service_and_docs", "test_build_time_validation_in_query"),
    # runs the JAX package's scripts/check_fleet_shapes.py over its
    # normalizer (tests/test_torch_fleet.py holds the port's keys equal to
    # the JAX package's over the lint's corpus and the samples, and the
    # lint's three properties on the port)
    ("test_fleet", "test_fleet_shape_lint_passes"),
    # builds the JAX package's wire batch and calls its jitted step
    # (tests/test_torch_fleet.py steps the port's device plan with 2 and 16
    # tenants' parameter columns against it)
    ("test_fleet", "test_device_plan_executes_with_param_columns"),
    # runs the JAX package's scripts/check_guard_coverage.py over its
    # sources (tests/test_torch_fleet.py checks the port's fleet sections:
    # the group's guard and the autopilot's record-before-actuate)
    ("test_fleet_guard", "test_guard_coverage_lint_passes"),
    # runs the JAX package's scripts/check_guard_coverage.py over its
    # sources (tests/test_torch_mesh.py loads its mesh section as data and
    # applies its checks to the port's fabric and rebalancer)
    ("test_mesh", "test_guard_coverage_includes_mesh_paths"),
    # runs the JAX package's parentmain as a real parent process, SIGKILLed
    # at each SIDDHI_CRASH_AT site (tests/test_torch_parent_recovery.py::
    # test_parent_sigkill_chaos runs the same CHAOS_SITES against the
    # port's parentmain with --device cpu)
    ("test_parent_recovery", "test_parent_sigkill_chaos"),
    # run the JAX package's scripts/check_guard_coverage.py journal-intent
    # check over its fabric and supervisor (tests/test_torch_parent_
    # recovery.py loads the script as data and applies check_journal_intent
    # to the port's fabric and supervisor sites, and to broken copies)
    ("test_parent_recovery", "test_journal_intent_lint_passes"),
    ("test_parent_recovery", "test_journal_intent_lint_catches_offenders"),
}

# suite functions that drive the columnar host tier (its apps carry
# @app:host_batch or a query's @host_batch, or they build its stager)
COLUMNAR: set = {
    *(f"test_edge_rows::{name}" for name in (
        "test_source_chunk_boundary_parity_fuzz",
        "test_file_source_end_to_end", "test_socket_source_lines",
        "test_socket_source_rows_frames",
        "test_rows_chunk_crosses_broker_intact",
        "test_resilient_sink_chunk_retry",
        "test_resilient_sink_partial_falls_back_per_event",
        "test_parallel_tier_worker_parity",
        "test_parallel_tier_snapshot_restore_mid_stream",
        "test_json_lines_mapper_rows", "test_send_columns_fallback_paths",
        "test_send_columns_validation", "test_zero_objects_on_rows_path",
        "test_stager_mixed_rows_and_columns_order",
        "test_fleet_stage_columns_parity")),
    "test_xray::test_observability_overhead_pin_on_columnar_micro_corpus",
    "test_procmesh::test_lane_pool_parity_and_snapshot",
    "test_procmesh::test_lane_pool_rejects_bad_mode",
    *(f"test_fleet_guard::{name}" for name in (
        "test_host_step_guard_replays_failed_batch_through_scalar",
        "test_host_step_guard_quarantines_after_threshold",
        "test_host_guard_emit_failure_does_not_duplicate")),
}

# suite functions that use the fabric class only for its static journal
# fold (``MeshFabric._merge_journal``), the port's while bound: they build
# no fabric
FABRIC_FOLD_ONLY = {
    f"test_parent_recovery::{name}" for name in (
        "test_merge_journal_cursor_and_delivery",
        "test_merge_journal_migration_intent_and_commit",
        "test_merge_journal_undeploy_and_workers",
        "test_merge_journal_checkpoint_seeds_fold")}

# suite function id → the JAX-package module it drives, which the port does
# not have yet (the port must still lack it), and the tier it comes with
NEEDS_MODULE: dict[str, tuple] = {}


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


def suite_functions(suites=SUITES) -> list:
    """A case per function and parameter set of ``suites``; a function the
    suite marks ``slow`` or ``skipif`` keeps the mark."""
    out = []
    for modname in suites:
        mod = importlib.import_module(modname)
        only = SUITE_ONLY.get(modname)
        for name, fn in vars(mod).items():
            if not name.startswith("test_") or not inspect.isfunction(fn) \
                    or (modname, name) in NOT_SUITE_FUNCTIONS \
                    or (only is not None and name not in only):
                continue
            kept = [m for m in getattr(fn, "pytestmark", [])
                    if m.name in ("slow", "skipif")]
            for suffix, kwargs in _param_sets(fn):
                fid = f"{modname}::{name}{suffix}"
                out.append(pytest.param(modname, name, kwargs, id=fid,
                                        marks=kept))
    return out


SUITE_FUNCTIONS = suite_functions()


def bind_port_names(monkeypatch, mod, request) -> set:
    """The reference's public names → the port's, in ``mod`` and on the
    ``siddhi_tpu`` package (function-local imports read the package), and
    every name of ``PORTED_MODULES`` (and of ``mod``'s ``SUITE_MODULES``)
    in the reference's module and in ``mod``; ``mod``'s own classes derived from a bound class are rebased
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
    suite = mod.__name__
    for ref, name, obj in ported_names(suite):
        port_of[id(getattr(ref, name))] = obj
        monkeypatch.setattr(ref, name, obj)
    for ref_name in SUITE_ALIASES.get(suite, ()):
        port_mod = importlib.import_module(PORTED_MODULES[ref_name])
        pkg_name, _, leaf = ref_name.rpartition(".")
        monkeypatch.setitem(sys.modules, ref_name, port_mod)
        monkeypatch.setattr(importlib.import_module(pkg_name), leaf,
                            port_mod)
    # a service that builds its own manager builds the port's on the CPU
    monkeypatch.setattr(port_service, "SiddhiManager", PortManager)
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
    return bound | {name for _, name, _ in ported_names(suite)}


def own_fixtures(mod) -> tuple[dict, list]:
    """The plain functions of ``mod``'s own fixtures: by name, and the
    autouse ones."""
    named, autouse = {}, []
    for name, val in vars(mod).items():
        marker = getattr(val, "_fixture_function_marker", None)
        if marker is None:
            continue
        if marker.autouse:
            autouse.append(val.__wrapped__)
        else:
            named[marker.name or name] = val.__wrapped__
    return named, autouse


def call_suite_function(mod, fn, kwargs: dict, fixtures: dict) -> None:
    """Calls ``fn`` with ``kwargs``. Its other parameters are pytest's
    fixtures in ``fixtures`` (the caller's ``tmp_path``, ``caplog``,
    ``monkeypatch``) or ``mod``'s own fixtures of that name (``manager``,
    ``rt``; with the port's names bound they build the port's engine), set
    up before the call and torn down after it in reverse order, as pytest
    does; ``mod``'s autouse fixtures come first. The port's broker is
    reset after the call."""
    named, autouse = own_fixtures(mod)
    gens = []

    def setup(fixture, given: dict):
        args = dict(given)
        for p in inspect.signature(fixture).parameters:
            if p in args:
                continue
            if p in fixtures:
                args[p] = fixtures[p]
            elif p in named:
                args[p] = setup(named[p], {})
            else:
                raise AssertionError(
                    f"{mod.__name__}.{fn.__name__}: fixture '{p}' has no "
                    f"port counterpart here")
        if fixture is fn:
            return args
        value = fixture(**args)
        if inspect.isgenerator(value):
            gens.append(value)
            value = next(value)
        return value

    try:
        for fixture in autouse:
            setup(fixture, {})
        args = setup(fn, kwargs)
        fn(**args)
    finally:
        for g in reversed(gens):
            next(g, None)
        siddhi_tpu_torch.InMemoryBroker.reset()


class ColumnarReach:
    """Counts, while open, what the functions of ``COLUMNAR`` must reach of
    the port's columnar host tier: its bridges and stagers built, and the
    ``@app:host_batch`` configs it read (a config that raises counts)."""

    def __init__(self, monkeypatch):
        from siddhi_tpu_torch.core import host_bridge
        from siddhi_tpu_torch.gpu import host_exec
        self.n = 0
        reach = self

        def counted(orig, is_config=False):
            def wrapper(*a, **k):
                try:
                    out = orig(*a, **k)
                except Exception:
                    reach.n += 1
                    raise
                if not is_config or out is not None:
                    reach.n += 1
                return out
            return wrapper

        monkeypatch.setattr(host_bridge.HostQueryBridge, "__init__",
                            counted(host_bridge.HostQueryBridge.__init__))
        monkeypatch.setattr(host_exec.HostRowStager, "__init__",
                            counted(host_exec.HostRowStager.__init__))
        monkeypatch.setattr(host_bridge, "host_batch_config",
                            counted(host_bridge.host_batch_config, True))


def names_used(fn) -> set:
    """Global names ``fn``'s code reads, its nested functions' included,
    and those of the helper functions of its module that it calls."""
    out, stack, seen = set(), [fn.__code__], set()
    mod = vars(inspect.getmodule(fn))
    while stack:
        code = stack.pop()
        if code in seen:
            continue
        seen.add(code)
        out.update(code.co_names)
        stack.extend(c for c in code.co_consts if inspect.iscode(c))
        stack.extend(mod[n].__code__ for n in code.co_names
                     if inspect.isfunction(mod.get(n))
                     and mod[n].__module__ == fn.__module__)
    return out


def run_suite_function(modname, fname, kwargs, request, monkeypatch,
                       tmp_path, caplog) -> None:
    """Calls the suite function with the port's names bound, and holds
    what it ran to the port (the module docstring)."""
    mod = importlib.import_module(modname)
    fn = getattr(mod, fname)
    fid = request.node.callspec.id
    missing, _tier = NEEDS_MODULE.get(fid, (None, None))
    if missing is not None:
        assert importlib.util.find_spec(f"siddhi_tpu.{missing}") is not None
        assert importlib.util.find_spec(
            f"siddhi_tpu_torch.{missing}") is None
        return
    bound = bind_port_names(monkeypatch, mod, request)
    if fid in FABRIC_FOLD_ONLY:
        assert vars(mod)["MeshFabric"] is PortMeshFabric
    built, workers = PortManager.built, PortDCNWorker.built
    fabrics = PortMeshFabric.built
    process_fabrics = PortMeshFabric.process_built
    fixtures = {"tmp_path": tmp_path, "caplog": caplog,
                "monkeypatch": monkeypatch}
    reach = ColumnarReach(monkeypatch) if fid in COLUMNAR else None
    spawns = PortSpawns(monkeypatch, tmp_path)
    try:
        call_suite_function(mod, fn, kwargs, fixtures)
    finally:
        spawns.close()
    # an engine function builds the port's engine (or the port's mesh
    # fabric, whose hosts are the port's engines, through a fixture); a
    # unit function calls a class or function bound to the port's
    assert PortManager.built > built or PortMeshFabric.built > fabrics \
        or names_used(fn) & bound, "the function ran nothing of the port"
    if reach is not None:
        assert reach.n, "the function never reached the port's columnar " \
            "host tier"
    if "DCNWorker" in names_used(fn):
        assert PortDCNWorker.built > workers, \
            "the function built no DCN worker of the port's"
    if fid in FABRIC_FOLD_ONLY:
        assert vars(mod)["MeshFabric"] is PortMeshFabric
    elif "MeshFabric" in names_used(fn):
        assert PortMeshFabric.built > fabrics, \
            "the function built no mesh fabric of the port's"
    if PortMeshFabric.process_built > process_fabrics:
        # a process-mode fabric's hosts are the port's workers, on the CPU
        assert spawns.cmds, "the process-mode fabric spawned no worker"
        for cmd in spawns.cmds:
            assert cmd[1:3] == ["-m", "siddhi_tpu_torch.procmesh.worker"], \
                cmd
            assert cmd[cmd.index("--device") + 1] == "cpu", cmd


@pytest.mark.parametrize("modname,fname,kwargs", SUITE_FUNCTIONS)
def test_reference_suite_function_on_the_port(modname, fname, kwargs,
                                              request, monkeypatch, tmp_path,
                                              caplog):
    run_suite_function(modname, fname, kwargs, request, monkeypatch,
                       tmp_path, caplog)


def test_suites_are_all_collected():
    """Every suite contributes functions; the lists name only collected
    ids."""
    mods = {p.values[0] for p in SUITE_FUNCTIONS}
    assert mods == set(SUITES)
    ids = {p.id for p in SUITE_FUNCTIONS}
    procmesh_ids = {p.id for p in suite_functions(PROCMESH_SUITES)}
    assert COLUMNAR <= ids | procmesh_ids
    assert FABRIC_FOLD_ONLY <= procmesh_ids
    assert set(NEEDS_MODULE) <= ids
    for modname, only in SUITE_ONLY.items():
        assert only <= set(vars(importlib.import_module(modname)))
    assert len(SUITE_FUNCTIONS) > 120
