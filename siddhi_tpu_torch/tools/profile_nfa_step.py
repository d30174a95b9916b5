#!/usr/bin/env python3
"""Where a pattern (NFA) step spends its time on the card.

    python3 siddhi_tpu_torch/tools/profile_nfa_step.py --path scan|main
        [--steps 20] [--root ROOT]

Runs one of ``chip_smoke.py``'s NFA paths at full width through
``PartitionedNFARuntime`` (``--path main``: the 8-state rising chain, the
blocked kernel ``csrc/nfa_block.cu``, B1; ``--path scan``: the two-stream
pattern with a logical ``and`` and a count, the scan kernel
``csrc/nfa_scan.cu``, B4), fed as ``chip_smoke.py`` feeds it
(``send_many`` per chunk or per same-stream run, decoding every step), and
profiles ``--steps`` steps under ``torch.profiler``; the window opens
between two ``send_many`` calls once 3 warm-up steps are through.
Prints the card's name and power limit, then one JSON line: device time
per kernel name (the NFA kernel, the ys zeroing and other PyTorch kernels,
copies), the kernel's device time per step without its wrapper's host work,
the wall time of the window, the device's busy share of it (device time
summed over kernels and copies, divided by wall time; 1 - busy is the idle
share), and the host clock split over the layers of the feed: routing
(``send_many`` less the flushes it triggers), ``emit`` (the lanes' wire
batches), the host-to-device copy of the wire, the step call (the kernel
wrapper: checks, ys allocation, launch) and the decode of the step's rows
(it holds the wait for the step).

``--root`` imports ``siddhi_tpu_torch`` from ROOT (this checkout by default,
or another commit's package unpacked there with ``git archive``), so two
commits' kernels run on the same inputs: run A, B, B, A in one call on one
card. The workloads are this checkout's ``chip_smoke.py``. Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNELS = {"main": "nfa_block_stage_kernel", "scan": "nfa_scan_step_kernel"}
WARMUP = 3


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile(path: str, steps: int, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
    cs = _chip_smoke()
    if path == "main":
        rt = PartitionedNFARuntime(cs.bench_app(), device="cuda", **cs.MAIN)
    else:
        rt = PartitionedNFARuntime(cs.SCAN_APP, device="cuda", **cs.SCAN_MAIN)
    host: dict = {}
    depth = {"send_many": 0}
    seen = {"steps": 0}
    window: dict = {}

    def add(label, ms):
        host[label] = host.get(label, 0.0) + ms

    def timed(label, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                add(label, (time.perf_counter() - t) * 1e3)
        return run

    send_many, flush = rt.send_many, rt.flush

    def timed_send_many(*a, **k):
        depth["send_many"] += 1
        try:
            return timed("send_many_ms", send_many)(*a, **k)
        finally:
            depth["send_many"] -= 1
            # the window opens between two calls, after the warm-up steps:
            # no timer is running while the profiler starts
            if seen["steps"] >= WARMUP and "prof" not in window:
                torch.cuda.synchronize()
                window["prof"] = tprofile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                window["prof"].__enter__()
                host.clear()
                window["s0"] = seen["steps"]
                window["t0"] = time.perf_counter()

    def timed_flush(*a, **k):
        label = "flush_in_send_many_ms" if depth["send_many"] else "flush_ms"
        return timed(label, flush)(*a, **k)

    vstep = rt.vstep

    def counted_step(*a):
        seen["steps"] += 1
        return timed("step_call_ms", vstep)(*a)

    rt.send_many = timed_send_many
    rt.flush = timed_flush
    rt.vstep = counted_step
    rt._wire = timed("h2d_ms", rt._wire)
    rt._step_and_decode = timed("step_and_decode_ms", rt._step_and_decode)
    for b in rt.builders:
        b.emit = timed("emit_ms", b.emit)

    def stop() -> bool:
        return "s0" in window and seen["steps"] - window["s0"] >= steps

    if path == "main":
        dev, v, ts = cs.gen_events((WARMUP + steps + 4) * 160_000, seed)
        for lo in range(0, len(ts), cs.CHUNK):
            if stop():
                break
            sl = slice(lo, lo + cs.CHUNK)
            rt.send_many("S", {"dev": dev[sl], "v": v[sl]}, ts[sl], decode=True)
    else:
        ev = cs.scan_events((WARMUP + steps + 4) * 160_000, seed)
        cs.feed_scan(rt, ev, stop=stop)
    torch.cuda.synchronize()
    if "prof" not in window:
        raise RuntimeError(f"only {seen['steps']} steps: no profiled window")
    wall = time.perf_counter() - window["t0"]
    prof = window["prof"]
    prof.__exit__(None, None, None)
    n = seen["steps"] - window["s0"]
    per = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us <= 0:
            continue
        key = e.key
        if KERNELS[path] in key:
            key = KERNELS[path]
        elif "emcpy" in key or "Memcpy" in key:
            key = "copies"
        elif "emset" in key or "fill" in key.lower():
            key = "fills (ys zeroing)"
        else:
            key = "other: " + key[:60]
        d = per.setdefault(key, {"device_ms": 0.0, "calls": 0})
        d["device_ms"] += dev_us / 1e3
        d["calls"] += e.count
    busy_ms = sum(d["device_ms"] for d in per.values())
    for d in per.values():
        d["us_per_call"] = d["device_ms"] * 1e3 / max(d["calls"], 1)
    k = per.get(KERNELS[path], {"device_ms": 0.0, "calls": 0})
    inner = host.get("flush_in_send_many_ms", 0.0)
    split = {
        "routing_ms": host.get("send_many_ms", 0.0) - inner,
        "emit_ms": host.get("emit_ms", 0.0),
        "h2d_ms": host.get("h2d_ms", 0.0),
        "step_call_ms": host.get("step_call_ms", 0.0),
        "decode_ms": host.get("step_and_decode_ms", 0.0)
        - host.get("h2d_ms", 0.0) - host.get("step_call_ms", 0.0),
    }
    return {"path": path, "kernel": KERNELS[path], "steps": n,
            "kernel_device_us_per_step": k["device_ms"] * 1e3 / max(n, 1),
            "kernel_launches": k["calls"], "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3) if busy_ms else None,
            "kernels": per, "host": split, "host_raw": host}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("scan", "main"), required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_nfa_step: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import siddhi_tpu_torch
    pkg = os.path.dirname(os.path.abspath(siddhi_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    out = profile(args.path, args.steps, args.seed)
    out["root"] = root
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
