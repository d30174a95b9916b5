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
        "from siddhi_tpu_torch import SiddhiManager, StreamCallback\n"
        "from siddhi_tpu_torch import InMemoryBroker, recover\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert "siddhi_tpu_torch" in out
    bad = [m for m in out if _forbidden(m)]
    assert bad == [], bad


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
    # explicit CPU is the plain version, and says so by its device
    rt = PartitionedNFARuntime(APP, num_partitions=2, key_attr="dev",
                               device="cpu")
    assert rt.device.type == "cpu"


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
