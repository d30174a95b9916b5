#!/usr/bin/env python3
"""Where an incremental-aggregation step spends its time on the card.

    python3 siddhi_tpu_torch/tools/profile_agg_step.py [--steps 40]

Runs each ``agg_main`` configuration (``tools/agg_workloads.py``: the trade
rollup and the sensor rollup) through ``AggregationRuntime`` (bulk staging
through ``append_columns`` + ``_flush_device``) for ``--steps`` full
batches under ``torch.profiler`` and prints one JSON line per
configuration: device time per kernel name (``a_eval``, ``a_rank``,
``a_bounds``, ``a_reduce``, copies, the rest), the wall time of the window,
the device's busy share of it (device time summed over kernels and copies,
divided by wall time; 1 - busy is the idle share), and the host clock split
over the layers of a flush (``append_columns``, ``emit``, ``bucket_slab``,
the step call with its copies both ways, and the merge of the partial rows
into the bucket stores, ``iter_partials`` and ``merge``). Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNELS = ("a_eval", "a_rank", "a_bounds", "a_reduce")


def profile(name: str, steps: int, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    import siddhi_tpu_torch.gpu.aggregation_compile as agc
    from siddhi_tpu_torch.tools import agg_workloads as aw
    warm = 3
    ev = aw.agg_events(name, (steps + warm) * aw.BATCH, seed)
    rt = aw.build_runtime(name, device="cuda")
    ca = rt._dev
    host = {}

    def timed(label, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[label] = host.get(label, 0.0) + (time.perf_counter() - t) * 1e3
        return run

    def timed_gen(label, fn):
        def run(*a, **k):
            t = time.perf_counter()
            for item in fn(*a, **k):
                host[label] = host.get(label, 0.0) + (time.perf_counter() - t) * 1e3
                yield item
                t = time.perf_counter()
            host[label] = host.get(label, 0.0) + (time.perf_counter() - t) * 1e3
        return run

    # the warm-up batches run before the window; the profiler starts once
    # they are through
    aw.feed_columns(rt, ev, warm * aw.BATCH)
    torch.cuda.synchronize()
    b = rt._dev_builder
    b.append_columns = timed("append_columns_ms", b.append_columns)
    b.emit = timed("emit_ms", b.emit)
    ca.bucket_slab = timed("bucket_slab_ms", ca.bucket_slab)
    ca.step = timed("step_call_ms", ca.step)
    ca.iter_partials = timed_gen("iter_partials_ms", ca.iter_partials)
    merge = agc.merge_partial_into_state
    agc.merge_partial_into_state = timed("merge_ms", merge)
    rest = {a: ev[a][warm * aw.BATCH:] for a in ev}
    try:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            aw.feed_columns(rt, rest)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        agc.merge_partial_into_state = merge
    per = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us <= 0:
            continue
        key = e.key
        for k in KERNELS:
            if k in key:
                key = k
        if "emcpy" in key or "Memcpy" in key:
            key = "copies"
        elif key not in KERNELS:
            key = "other"
        d = per.setdefault(key, {"device_ms": 0.0, "calls": 0})
        d["device_ms"] += dev_us / 1e3
        d["calls"] += e.count
    busy_ms = sum(d["device_ms"] for d in per.values())
    for d in per.values():
        d["us_per_call"] = d["device_ms"] * 1e3 / max(d["calls"], 1)
    return {"config": name, "steps": steps, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3) if busy_ms else None,
            "kernels": per, "host": host}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_agg_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from siddhi_tpu_torch.tools.agg_workloads import AGG_MAIN
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    for name in AGG_MAIN:
        print(json.dumps(profile(name, args.steps, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
