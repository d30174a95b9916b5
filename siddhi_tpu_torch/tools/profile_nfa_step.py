#!/usr/bin/env python3
"""Where a pattern (NFA) step spends its time on the card.

    python3 siddhi_tpu_torch/tools/profile_nfa_step.py --path scan|main
        [--steps 20] [--root ROOT] [--phases]

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
card. The workloads are this checkout's ``chip_smoke.py``. The blocked
kernel's device time is summed over every kernel whose name holds
``nfa_block`` (one launch a step; older builds launched one a stage).
``--phases`` (``--path main``, this checkout)
runs a copy of ``csrc/nfa_block.cu`` built with a ``clock64()`` probe
after each barrier marked ``// phase`` in the source: thread 0 of each CTA
adds the cycles since its last probe to a device array, read back after
the window; it prints the mean CTA's cycles per step in each phase (and
per stage), and the same at the card's maximum SM clock in µs. The probes
add an atomic a phase, so the window's kernel time is slightly longer than
without them. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNELS = {"main": "nfa_block", "scan": "nfa_scan_step_kernel"}
WARMUP = 3
PHASES = ("descriptor", "batch staged", "suffix minima", "seeds")
STAGE_PHASES = ("search", "ranks and writes")
NSLOT = 64
PROBE = """
__device__ unsigned long long nfa_phase_cycles[%d];
#define NFA_PHASE(slot) do { if (threadIdx.x == 0) { const long long t_ = clock64(); \\
  atomicAdd(&nfa_phase_cycles[slot], (unsigned long long)(t_ - pt_)); pt_ = t_; } } while (0)
""" % NSLOT
READ = """
extern "C" int nfa_block_phases(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, nfa_phase_cycles, sizeof(nfa_phase_cycles));
  static unsigned long long zero[%d];
  if (e == cudaSuccess && reset)
    e = cudaMemcpyToSymbol(nfa_phase_cycles, zero, sizeof(zero));
  return (int)e;
}
""" % NSLOT


def phase_lib():
    """Builds the probed copy of ``csrc/nfa_block.cu`` (see ``--phases``)
    and returns it loaded."""
    from siddhi_tpu_torch.gpu import _build
    with open(os.path.join(_build.CSRC, "nfa_block.cu")) as f:
        src = f.read()
    src = src.replace('#include "expr_ir.cuh"', '#include "%s"' % os.path.join(
        _build.CSRC, "expr_ir.cuh"))
    src = src.replace("#define SMEM_LIMIT", PROBE + "#define SMEM_LIMIT", 1)
    src, n0 = re.subn(r"(l = blockIdx\.x[^;]*;)", r"\1\n  long long pt_ = clock64();",
                      src, count=1)
    src, n1 = re.subn(r"__syncthreads\(\);\s*// phase (\d) of stage s:[^\n]*",
                      r"__syncthreads(); NFA_PHASE(%d + %d * (s - 1) + (\1 - %d));"
                      % (len(PHASES), len(STAGE_PHASES), len(PHASES)), src)
    src, n2 = re.subn(r"__syncthreads\(\);\s*// phase (\d):[^\n]*",
                      r"__syncthreads(); NFA_PHASE(\1);", src)
    if (n0, n1, n2) != (1, len(STAGE_PHASES), len(PHASES)):
        raise RuntimeError(f"phase markers not found: {n0} {n1} {n2}")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, "nfa_block_phases.cu")
    so = os.path.join(_build.BUILD_DIR, "libnfa_block_phases.so")
    with open(cu, "w") as f:
        f.write(src + READ)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for the probed copy:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(so)
    lib.nfa_block_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nfa_block_phases.restype = ctypes.c_int
    return lib


def read_phases(lib, reset: bool) -> list:
    buf = (ctypes.c_ulonglong * NSLOT)()
    rc = lib.nfa_block_phases(ctypes.addressof(buf), int(reset))
    if rc != 0:
        raise RuntimeError(f"reading the phase counters: CUDA error {rc}")
    return list(buf)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile(path: str, steps: int, seed: int, phases=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
    cs = _chip_smoke()
    if phases is not None:
        from siddhi_tpu_torch.gpu import _build
        _build.load = lambda stem, load=_build.load: \
            phases if stem == "nfa_block" else load(stem)
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
                if phases is not None:
                    read_phases(phases, reset=True)
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
    split_phases = None
    if phases is not None:
        cycles = read_phases(phases, reset=False)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        mhz = float(smi.stdout.strip().splitlines()[0])
        per = rt.P * max(n, 1)
        names = list(PHASES) + [f"stage {s} {p}" for s in range(1, rt.compiler.S)
                                for p in STAGE_PHASES]
        split_phases = {"sm_clock_max_mhz": mhz, "per_lane_step": {
            name: {"cycles": cycles[i] / per, "us_at_max_clock": cycles[i] / per / mhz}
            for i, name in enumerate(names)}}
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
            "kernels": per, "host": split, "host_raw": host,
            "phases": split_phases}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("scan", "main"), required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--phases", action="store_true")
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
    if args.phases and (args.path != "main" or root != REPO):
        print("profile_nfa_step: --phases probes this checkout's blocked "
              "kernel (--path main, no --root)", file=sys.stderr)
        return 2
    out = profile(args.path, args.steps, args.seed,
                  phase_lib() if args.phases else None)
    out["root"] = root
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
