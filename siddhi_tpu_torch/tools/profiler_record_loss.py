"""How many kernel records a ``torch.profiler`` capture keeps as its process
ages, on the card.

    python3 siddhi_tpu_torch/tools/profiler_record_loss.py [--age 150]
        [--every 20] [--margin 1.0]

Every ``--every`` seconds, up to ``--age``, one capture (CPU and CUDA
activity, ``--margin`` seconds of idle capture before and after) holds
three ``record_function`` ranges, each around one small kernel; the line
printed gives the process's age, the kernel records the exported trace
kept (of 3) and each kept record's start after its range's, in ms. Between
captures the card runs a small kernel every 50 ms. At the end: the host's
clock against CUDA events over the whole run, and how far the host's
realtime clock moved against its monotonic clock. Kineto drops a record
whose timestamp falls outside its capture window; run with
``KINETO_LOG_LEVEL=1`` to see its "Out-of-range" count.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def capture(x, margin: float, path: str) -> tuple[int, list]:
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
    prof.start()
    time.sleep(margin)
    for i in range(3):
        with record_function(f"probe{i}"):
            x * 1.0001
        torch.cuda.synchronize()
        time.sleep(0.01)
    time.sleep(margin)
    prof.stop()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted(e["ts"] for e in events
                    if str(e.get("name", "")).startswith("probe")
                    and e.get("cat") == "user_annotation")
    kernels = sorted(e["ts"] for e in events if e.get("cat") == "kernel")
    return len(kernels), [round((k - r) / 1e3, 3)
                          for r, k in zip(ranges, kernels)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--age", type=float, default=150.0)
    ap.add_argument("--every", type=float, default=20.0)
    ap.add_argument("--margin", type=float, default=1.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    x = torch.ones(1 << 16, device="cuda")
    path = os.path.join(tempfile.mkdtemp(prefix="record-loss-"), "t.json")
    wall_offset = time.time_ns() - time.monotonic_ns()
    e0 = torch.cuda.Event(enable_timing=True)
    e0.record()
    t0 = time.perf_counter()
    while True:
        age = time.perf_counter() - t0
        kept, offsets = capture(x, args.margin, path)
        print(json.dumps({"age_s": round(age, 1), "kernels_kept": kept,
                          "of": 3, "offsets_ms": offsets}), flush=True)
        if age >= args.age:
            break
        until = time.perf_counter() + args.every
        while time.perf_counter() < until:
            x = x * 1.0
            torch.cuda.synchronize()
            time.sleep(0.05)
    e1 = torch.cuda.Event(enable_timing=True)
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({
        "host_ms": host_ms, "cuda_events_ms": e0.elapsed_time(e1),
        "realtime_moved_ms": (time.time_ns() - time.monotonic_ns()
                              - wall_offset) / 1e6}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
