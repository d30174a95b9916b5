#!/usr/bin/env python3
"""Where a single-stream query step spends its time on the card.

    python3 siddhi_tpu_torch/tools/profile_query_step.py [--steps 40]
        [--root ROOT]

Runs each ``query_main`` configuration (``tools/query_workloads.py``: the grouped
length window of the device sample, the 10 s time window with
min/max/stdDev, the 10 s timeBatch and the lossyFrequent fraud query)
through ``DeviceStreamRuntime`` for ``--steps`` full batches under
``torch.profiler`` and prints one JSON line per configuration: device time
per kernel name (``KERNELS``: ``query_step.cu``'s ``q_mask``,
``q_compact``, ``q_prep``, the
group-by sort's ``q_gcount``/``q_gscan``/``q_gplace``, the pass grid's
``q_pass<1..3>``, ``q_emit``, and ``q_walk``, earlier designs' ``q_scan``;
memsets, copies, the rest) with its time per step, the query kernels' device
time per step, the wall time of the window, the device's busy share of it
(device time summed over kernels and copies, divided by wall time; 1 - busy
is the idle share), and the host clock split over the layers of the feed
(``append_columns``, ``emit``, the step call with its host-to-device copies,
``decode_outputs``).

``--root`` imports ``siddhi_tpu_torch`` from ROOT (this checkout by default,
or another commit's package unpacked there with ``git archive``), so two
commits' kernels run on the same inputs: run A, B, B, A in one call on one
card. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNELS = ("q_mask", "q_compact", "q_prep", "q_gcount", "q_gscan", "q_gplace",
           "q_pass<1>", "q_pass<2>", "q_pass<3>", "q_scan", "q_emit", "q_walk")


def profile(name: str, steps: int, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from siddhi_tpu_torch.gpu.runtime import DeviceStreamRuntime
    from siddhi_tpu_torch.tools import query_workloads as qw
    cfg = dict(qw.QUERY_MAIN[name])
    app = cfg.pop("app")
    cfg.pop("stream")
    B = cfg["batch_capacity"]
    cols, ts = qw.query_events(name, (steps + 3) * B, seed)
    rt = DeviceStreamRuntime(app, device="cuda", **cfg)
    warm = {k: v[:3 * B] for k, v in cols.items()}
    qw.feed_query(rt, warm, ts[:3 * B])
    rest = {k: v[3 * B:] for k, v in cols.items()}
    host = {}

    def timed(label, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[label] = host.get(label, 0.0) + (time.perf_counter() - t) * 1e3
        return run

    rt.builder.append_columns = timed("append_columns_ms", rt.builder.append_columns)
    rt.builder.emit = timed("emit_ms", rt.builder.emit)
    rt.compiled.step = timed("step_call_ms", rt.compiled.step)
    rt.compiled.decode_outputs = timed("decode_ms", rt.compiled.decode_outputs)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        qw.feed_query(rt, rest, ts[3 * B:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us <= 0:
            continue
        key = ev.key
        for k in KERNELS:
            if k in key:
                key = k
                break
        if "emcpy" in key or "Memcpy" in key:
            key = "copies"
        elif "emset" in key or "Memset" in key:
            key = "memsets"
        elif key not in KERNELS:
            key = "other"
        d = per.setdefault(key, {"device_ms": 0.0, "calls": 0})
        d["device_ms"] += dev_us / 1e3
        d["calls"] += ev.count
    busy_ms = sum(d["device_ms"] for d in per.values())
    for d in per.values():
        d["us_per_call"] = d["device_ms"] * 1e3 / max(d["calls"], 1)
        d["us_per_step"] = d["device_ms"] * 1e3 / steps
    kernel_us = sum(per[k]["device_ms"] for k in KERNELS if k in per) * 1e3 / steps
    return {"config": name, "steps": steps, "wall_ms": wall * 1e3,
            "kernel_us_per_step": kernel_us,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3) if busy_ms else None,
            "kernels": per, "host": host}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_query_step: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import siddhi_tpu_torch
    pkg = os.path.dirname(os.path.abspath(siddhi_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    from siddhi_tpu_torch.tools.query_workloads import QUERY_MAIN
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    for name in QUERY_MAIN:
        out = profile(name, args.steps, args.seed)
        out["root"] = root
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
