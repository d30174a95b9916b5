#!/usr/bin/env python3
"""Where a stream-stream join step spends its time on the card.

    python3 siddhi_tpu_torch/tools/profile_join_step.py [--steps 40]

Runs each ``join_main`` configuration (``tools/join_workloads.py``: the
market join and the sensor outer join) through ``DeviceJoinRuntime`` for
``--steps`` full batches under ``torch.profiler`` and prints one JSON line
per configuration: device time per kernel name (``j_prep``, ``j_index``,
``j_count``, ``j_scan``, ``j_emit``, copies, the rest), the wall time of the window, the
device's busy share of it (device time summed over kernels and copies,
divided by wall time; 1 - busy is the idle share), and the host clock split
over the layers of the feed (``append_many``, ``emit``, the step call with
its host-to-device copies, ``decode_outputs``; the decode holds the wait
for the step). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNELS = ("j_prep", "j_index", "j_count", "j_scan", "j_emit")


def profile(name: str, steps: int, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from siddhi_tpu_torch.gpu.join_compile import DeviceJoinRuntime
    from siddhi_tpu_torch.tools import join_workloads as jw
    cfg = dict(jw.JOIN_MAIN[name])
    app = cfg.pop("app")
    B = cfg["batch_capacity"]
    n = (steps + 3) * B
    ev = jw.join_events(name, n, seed)
    rt = DeviceJoinRuntime(app, device="cuda", **cfg)
    host = {}

    def timed(label, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[label] = host.get(label, 0.0) + (time.perf_counter() - t) * 1e3
        return run

    # the warm-up's 3 batches run before the window (the whole stream is
    # fed; the profiler starts once they are through)
    seen = {"steps": 0}
    window = {}
    flush = rt.flush

    def counted_flush(*a, **k):
        got = flush(*a, **k)
        seen["steps"] += got is not None
        if seen["steps"] == 3 and "prof" not in window:
            torch.cuda.synchronize()
            window["prof"] = tprofile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["prof"].__enter__()
            host.clear()
            window["t0"] = time.perf_counter()
        return got

    rt.flush = counted_flush
    rt.builder.append_many = timed("append_many_ms", rt.builder.append_many)
    rt.builder.emit = timed("emit_ms", rt.builder.emit)
    rt.compiler.step = timed("step_call_ms", rt.compiler.step)
    rt.compiler.decode_outputs = timed("decode_ms", rt.compiler.decode_outputs)
    jw.feed_join(rt, ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - window["t0"]
    prof = window["prof"]
    prof.__exit__(None, None, None)
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
    return {"config": name, "steps": seen["steps"] - 3, "wall_ms": wall * 1e3,
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
        print("profile_join_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from siddhi_tpu_torch.tools.join_workloads import JOIN_MAIN
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    for name in JOIN_MAIN:
        print(json.dumps(profile(name, args.steps, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
