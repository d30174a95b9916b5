"""Where the first controller-timed steps of ``iot_adaptive_edge`` go, on
one card.

    python3 siddhi_tpu_torch/tools/edge_first_steps.py [--runs 4]
        [--seed 42] [--switch-interval-ms MS]

Builds the kernels, runs ``chip_smoke.py``'s edge app once as a warm-up on
other events, then ``--runs`` times unfrozen (each from a collected heap),
as ``chip_smoke.py``'s ``engine_io`` phase runs it. For each run one JSON
line: the controller's adjustments and batch size, the median
controller-timed step, the full collections, the producer's seconds, and
for each of the first four steps its dispatch and collect (the latency the
controller observes), the producer's time beside it, and the time of the
query step's host functions in it (``batch_tensors``, ``_check``, ``_on``,
``launch``, ``decode_outputs``, on the device-driver thread). Then the
card's name and power limit. ``--switch-interval-ms`` sets the
interpreter's switch interval for the runs. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FUNCS = {"QueryPlan": ("_on", "_check", "launch"),
         "CompiledStreamQuery": ("batch_tensors", "decode_outputs")}


def timed_functions(rec: list) -> None:
    """Wraps ``FUNCS`` so each call appends ``(name, t0, t1, thread)``."""
    from siddhi_tpu_torch.gpu.query_compile import CompiledStreamQuery
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    for cls in (QueryPlan, CompiledStreamQuery):
        for name in FUNCS[cls.__name__]:
            fn = getattr(cls, name)

            def w(*a, _fn=fn, _name=name, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    rec.append((_name, t0, time.perf_counter(),
                                threading.current_thread().name))
            setattr(cls, name, w)


def first_steps(trace, rec: list, n: int = 4) -> list:
    out = []
    for d, c in zip(trace.disp[:n], trace.coll[:n]):
        lo, hi = d[0], c[1]
        fns = {}
        for name, t0, t1, th in rec:
            if th == "device-driver" and t0 >= lo and t1 <= hi:
                fns[name] = fns.get(name, 0.0) + 1e3 * (t1 - t0)
        out.append({
            "ms": 1e3 * ((d[1] - d[0]) + (c[1] - c[0])),
            "dispatch_ms": 1e3 * (d[1] - d[0]),
            "collect_ms": 1e3 * (c[1] - c[0]),
            "producer_ms": 1e3 * sum(max(0.0, min(hi, p[1]) - max(lo, p[0]))
                                     for p in trace.prod),
            "functions_ms": fns})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--switch-interval-ms", type=float, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("edge_first_steps: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from siddhi_tpu_torch.tools.guard_cost import load_chip_smoke
    cs = load_chip_smoke()
    card = cs.phase_device()
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.tools import engine_workloads as ew
    rec, traces = [], []

    class Trace(cs.StallTrace):
        def __init__(self, rt):
            super().__init__(rt)
            traces.append(self)

    cs.StallTrace = Trace
    timed_functions(rec)
    scratch = cs.io_scratch()
    ev = ew.IotEvents(ew.IO_EVENTS, args.seed)
    csv_bytes, head = ew.iot_csv(ev)
    csv = os.path.join(scratch, "iot.csv")
    with open(csv, "wb") as f:
        f.write(csv_bytes)
    warm_bytes, warm_head = ew.iot_csv(ew.IotEvents(cs.IO_EDGE_WARM,
                                                    args.seed + 7))
    warm = os.path.join(scratch, "iot_warm.csv")
    with open(warm, "wb") as f:
        f.write(warm_bytes)
    cs.io_edge_run(SiddhiManager(), warm, warm_head, True, True)
    if args.switch_interval_ms is not None:
        sys.setswitchinterval(args.switch_interval_ms / 1e3)
    for run in range(args.runs):
        rec.clear()
        traces.clear()
        gc.collect()
        out = cs.io_edge_run(SiddhiManager(), csv, head, True, True)
        st = out["stalls"]
        print(json.dumps({
            "run": run, "adjustments": out["report"]["adjustments"],
            "batch_size": out["report"]["batch_size"],
            "step_ms_median": st["step_ms_median"],
            "full_collections": st["gc_pauses"].get("2"),
            "producer_s": st["producer_s"],
            "first_steps": first_steps(traces[0], rec),
            "switch_interval_s": sys.getswitchinterval()}), flush=True)
    shutil.rmtree(scratch, ignore_errors=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
