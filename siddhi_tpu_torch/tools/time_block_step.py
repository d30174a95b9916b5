"""Times the blocked kernel's main-path step for one checkout of this repo.

    python3 siddhi_tpu_torch/tools/time_block_step.py ROOT

Imports ``siddhi_tpu_torch`` from ROOT (this checkout, or another commit's
``siddhi_tpu_torch/`` unpacked under ROOT with ``git archive``), so ROOT's
``csrc/nfa_block.cu`` is built and launched. It drives ``chip_smoke.py``'s
main path (the 8-state bench app under ``partition with (dev of S)``: 64
lanes, lane batch 2048, C = 64, K = 320, 2,000,000 events from seed 42)
5 times, each through a fresh ``PartitionedNFARuntime`` after one
untimed warm-up, and times every step's launches with CUDA events. It prints
one JSON line: the root, the card, the median and range of the step times
over all runs, each run's median, the launches and the wall time.

To compare two checkouts, run it for each in alternation (A, B, B, A) in one
call on one card; both get the same inputs. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPS = 5
SEED = 42


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import siddhi_tpu_torch
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
    pkg = os.path.dirname(os.path.abspath(siddhi_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    cs = _chip_smoke()
    dev, v, ts = cs.gen_events(2_000_000, SEED)

    def run(n: int) -> tuple[list, float]:
        rt = PartitionedNFARuntime(cs.bench_app(), device="cuda", **cs.MAIN)
        kernel_step, marks = rt.vstep, []

        def timed(state, *a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = kernel_step(state, *a)
            e1.record()
            marks.append((e0, e1))
            return out

        rt.vstep = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.feed(rt, dev[:n], v[:n], ts[:n])
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in marks], time.perf_counter() - t0

    run(cs.CHUNK)                              # build and warm-up, untimed
    BlockPlan.launches = 0
    runs = [run(len(ts)) for _ in range(REPS)]
    steps = [ms for r, _ in runs for ms in r]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "root": root, "card": card.strip().splitlines()[0] if card else None,
        "step_ms_median": float(np.median(steps)),
        "step_ms_min": float(np.min(steps)), "step_ms_max": float(np.max(steps)),
        "run_medians_ms": [float(np.median(r)) for r, _ in runs],
        "steps": len(steps), "launches": BlockPlan.launches,
        "wall_s": [w for _, w in runs]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
