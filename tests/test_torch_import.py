"""The port stands alone: no JAX, no ``siddhi_tpu``, no quiet CPU fallback."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from siddhi_tpu_torch.gpu.nfa import DeviceNFACompiler
from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime

ROOT = Path(__file__).resolve().parent.parent
APP = """
define stream S (dev string, v double);
partition with (dev of S)
begin
from every e1=S[v > 90.0] -> e2=S[v > e1.v] within 4000
select e1.v as v1, e2.v as v2 insert into Alerts;
end;
"""


def _forbidden(name: str) -> bool:
    # `siddhi_tpu_torch` starts with `siddhi_tpu`: match the exact package
    return name == "jax" or name.startswith("jax.") or name == "jaxlib" \
        or name.startswith("jaxlib.") or name == "siddhi_tpu" \
        or name.startswith("siddhi_tpu.")


def test_import_loads_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import siddhi_tpu_torch\n"
        "import siddhi_tpu_torch.gpu.partition, siddhi_tpu_torch.gpu.state_io\n"
        "import siddhi_tpu_torch.gpu._build, siddhi_tpu_torch.gpu.transfer\n"
        "import siddhi_tpu_torch.gpu.join_compile, siddhi_tpu_torch.gpu.join_step\n"
        "import siddhi_tpu_torch.tools.join_workloads\n"
        "import siddhi_tpu_torch.core.errors, siddhi_tpu_torch.core.event\n"
        "import siddhi_tpu_torch.core.aggregators, siddhi_tpu_torch.core.executor\n"
        "import siddhi_tpu_torch.core.extension, siddhi_tpu_torch.core.aggregation\n"
        "import siddhi_tpu_torch.gpu.aggregation_compile\n"
        "import siddhi_tpu_torch.gpu.aggregation_step\n"
        "import siddhi_tpu_torch.tools.agg_workloads\n"
        "from siddhi_tpu_torch.core.aggregation import AggregationRuntime\n"
        "from siddhi_tpu_torch.gpu import CompiledAggregation\n"
        "import siddhi_tpu_torch.native, siddhi_tpu_torch.core.columns\n"
        "import siddhi_tpu_torch.entry\n"
        "import siddhi_tpu_torch.core.app_runtime, siddhi_tpu_torch.core.manager\n"
        "import siddhi_tpu_torch.core.device_bridge\n"
        "import siddhi_tpu_torch.core.processors, siddhi_tpu_torch.core.output\n"
        "import siddhi_tpu_torch.core.cron, siddhi_tpu_torch.core.windows\n"
        "import siddhi_tpu_torch.core.expression_window\n"
        "import siddhi_tpu_torch.core.selector, siddhi_tpu_torch.core.join\n"
        "import siddhi_tpu_torch.core.pattern, siddhi_tpu_torch.core.debugger\n"
        "import siddhi_tpu_torch.core.named_window\n"
        "import siddhi_tpu_torch.core.query_runtime\n"
        "import siddhi_tpu_torch.core.partition, siddhi_tpu_torch.core.trigger\n"
        "import siddhi_tpu_torch.tools.engine_workloads\n"
        "import siddhi_tpu_torch.tools.edge_first_steps\n"
        "import siddhi_tpu_torch.core.io, siddhi_tpu_torch.gpu.dcn\n"
        "import siddhi_tpu_torch.resilience\n"
        "import siddhi_tpu_torch.resilience.circuit\n"
        "import siddhi_tpu_torch.resilience.chaos\n"
        "import siddhi_tpu_torch.resilience.device_guard\n"
        "from siddhi_tpu_torch.resilience import ChaosInjector, DeviceGuard\n"
        "import siddhi_tpu_torch.resilience.sink_pipeline\n"
        "import siddhi_tpu_torch.flow, siddhi_tpu_torch.flow.wal\n"
        "import siddhi_tpu_torch.flow.records, siddhi_tpu_torch.flow.recovery\n"
        "import siddhi_tpu_torch.flow.backpressure\n"
        "import siddhi_tpu_torch.flow.adaptive_batch\n"
        "import siddhi_tpu_torch.observability\n"
        "import siddhi_tpu_torch.observability.profiler\n"
        "import siddhi_tpu_torch.observability.prometheus\n"
        "import siddhi_tpu_torch.observability.flight_recorder\n"
        "import siddhi_tpu_torch.observability.tracing\n"
        "import siddhi_tpu_torch.observability.phases\n"
        "import siddhi_tpu_torch.service, siddhi_tpu_torch.doc_gen\n"
        "import siddhi_tpu_torch.gpu.host_exec\n"
        "import siddhi_tpu_torch.core.host_bridge\n"
        "import siddhi_tpu_torch.procmesh, siddhi_tpu_torch.procmesh.protocol\n"
        "import siddhi_tpu_torch.procmesh.lanepool\n"
        "import siddhi_tpu_torch.resilience.fleet_guard\n"
        "from siddhi_tpu_torch.resilience import HostStepGuard\n"
        "from siddhi_tpu_torch.resilience import FleetGuard\n"
        "import siddhi_tpu_torch.fleet, siddhi_tpu_torch.fleet.shape\n"
        "import siddhi_tpu_torch.fleet.cache, siddhi_tpu_torch.fleet.group\n"
        "import siddhi_tpu_torch.fleet.manager\n"
        "import siddhi_tpu_torch.observability.slo\n"
        "from siddhi_tpu_torch.observability import SLOController\n"
        "from siddhi_tpu_torch.observability import ObservabilitySubsystem\n"
        "from siddhi_tpu_torch.service import SiddhiService\n"
        "from siddhi_tpu_torch import SiddhiManager, StreamCallback\n"
        "from siddhi_tpu_torch import InMemoryBroker, recover\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert "siddhi_tpu_torch" in out
    bad = [m for m in out if _forbidden(m)]
    assert bad == [], bad


def test_dcn_tier_imports_neither_jax_nor_the_reference():
    """The DCN shard tier alone (the worker, the topology, the guard)."""
    code = ("import siddhi_tpu_torch.gpu.dcn, "
            "siddhi_tpu_torch.resilience.dcn_guard, sys\n"
            "assert 'jax' not in sys.modules and not any("
            "m.split('.')[0] == 'siddhi_tpu' for m in sys.modules)\n"
            "from siddhi_tpu_torch.gpu.dcn import DCNWorker, LaneTopology\n"
            "from siddhi_tpu_torch.resilience import LaneGroupSnapshotStore\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert "siddhi_tpu_torch.resilience.dcn_guard" in out
    assert [m for m in out if _forbidden(m)] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_source_scan_finds_no_jax_or_reference_import():
    files = sorted((ROOT / "siddhi_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if _forbidden(m)]
    assert bad == [], bad


def test_lane_pool_child_imports_neither_jax_nor_the_reference(capfd):
    """A process lane child (``@app:host_batch(workers.mode='process')``)
    rebuilds its engine from the app text: every module it imports, as
    ``-X importtime`` lists them, is neither JAX nor the JAX package, and
    it is given no card."""
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.gpu.host_exec import HostPartitionedNFA
    from siddhi_tpu_torch.procmesh.lanepool import ProcessLanePool
    app = parse(APP)
    prt = HostPartitionedNFA(app.partitions[0].queries[0],
                             dict(app.stream_definitions), "dev",
                             num_partitions=2)
    source = {"app_text": APP, "part_index": 0, "query_index": 0,
              "key_attr": "dev"}
    pool = ProcessLanePool(source, 2, 2, [prt.engine.snapshot_state(s)
                                          for s in prt.lane_states],
                           env={"PYTHONPROFILEIMPORTTIME": "1"})
    try:
        assert pool.match_count() == 0
        assert pool.report()["alive"] == 2
    finally:
        pool.close()
    err = capfd.readouterr().err
    mods = [line.rsplit("|", 1)[-1].strip() for line in err.splitlines()
            if line.startswith("import time:")]
    assert "siddhi_tpu_torch.gpu.host_exec" in mods
    assert "siddhi_tpu_torch.procmesh.lanepool" in mods
    bad = sorted({m for m in mods if _forbidden(m)})
    assert bad == [], bad


def test_lane_pool_child_is_given_no_card(monkeypatch):
    from siddhi_tpu_torch.procmesh import lanepool
    seen = {}

    def popen(args, **kw):
        seen.update(kw["env"])
        raise OSError("not spawned")

    monkeypatch.setattr(lanepool.subprocess, "Popen", popen)
    with pytest.raises(OSError):
        lanepool.ProcessLanePool({}, 2, 2, [None, None])
    assert seen["CUDA_VISIBLE_DEVICES"] == ""
    assert seen["OMP_NUM_THREADS"] == "1"
    assert seen["SIDDHI_PROCMESH_CHILD"] == "1"


def test_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PartitionedNFARuntime(APP, num_partitions=2, key_attr="dev")
    with pytest.raises(RuntimeError, match="CUDA"):
        PartitionedNFARuntime(APP, num_partitions=2, key_attr="dev",
                              device="cuda")
    from siddhi_tpu_torch.compiler import parse
    app = parse(APP)
    q = app.partitions[0].queries[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceNFACompiler(q, dict(app.stream_definitions), 8, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        PartitionedNFARuntime(APP, num_partitions=2, key_attr="dev",
                              devices=["cuda:0", "cuda:0"])
    # explicit CPU is the plain version, and says so by its device
    rt = PartitionedNFARuntime(APP, num_partitions=2, key_attr="dev",
                               device="cpu")
    assert rt.device.type == "cpu"
    # the service builds its own manager on the card unless asked otherwise
    from siddhi_tpu_torch.service import SiddhiService
    with pytest.raises(RuntimeError, match="CUDA"):
        SiddhiService()
    svc = SiddhiService(device="cpu")
    assert svc.manager.device.type == "cpu"
    svc.start()
    svc.stop()


def test_kernel_wrapper_refuses_cpu_tensors():
    rt = PartitionedNFARuntime(APP, num_partitions=2, key_attr="dev",
                               lane_batch=16, device="cpu")
    plan = rt.vstep.plan
    cols = {"s0_v": torch.zeros((2, 16), dtype=torch.float32),
            "s0_dev": torch.zeros((2, 16), dtype=torch.int32)}
    args = (cols, torch.zeros((2, 16), dtype=torch.int8),
            torch.zeros((2, 16), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        plan.step_cuda(rt.state, *args)
    # the dispatching step runs the plain version for CPU tensors
    state, ys = rt.vstep(rt.state, *args)
    assert ys["mask"].shape == (2, rt.compiler.C + 16)
    assert not np.asarray(ys["mask"]).any()
    assert plan.launches == 0
