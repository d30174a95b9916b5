"""Where the fleet's noisy-neighbour storm spends its time, on the CPU.

    python3 siddhi_tpu_torch/tools/storm_probe.py [--runs 3] [--busy 5]
        [--ballast 0] [--budget-ms 150]

Runs the storm of the reference's ``tests/test_slo.py::_run_storm`` on the
port's engine (``SiddhiManager(device="cpu")``): 8 ``@app:fleet`` tenants of
one filter rule (two premium with a p99 budget, the last a best-effort
burster at 10× its share), 40,000 rows in chunks of 32 through
``send_rows``, an opening window of 65,536. For each run it prints one JSON
line: the wall seconds, the controller's decisions, the converged p99 the
test asserts (the evidence window since the last decision) and its phases,
each group step's seconds by window size (median, p99, max), and Python's
collector: collections and seconds per generation (``gc.callbacks``).

``--busy N`` starts N busy processes of its own beside the runs (torch
sort and matmul loops on torch's default intra-op pool), as other test
workers running torch load the machine, and stops them at the end.
``--ballast N`` keeps N tracked objects alive before the runs, standing in
for the heap of a test worker that has imported more than the port (every
collection of the oldest generation walks them).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STREAM = "define stream S (dev string, v double);\n"
BUSY = ("import time, torch\n"
        "a = torch.randn(256, 256)\n"
        "while True:\n"
        "    (torch.randn(200000).sort().values * 2).cumsum(0)\n"
        "    a = a @ a.T / 256\n")


def tenant_app(i: int, klass: str, budget_ms: float | None) -> str:
    budget = f", slo.p99.ms='{budget_ms}'" if budget_ms is not None else ""
    return (f"@app(name='t{i}')\n"
            f"@app:fleet(batch='65536', slo.class='{klass}'{budget}, "
            f"slo.interval.ms='0', slo.cooldown.ms='20', "
            f"slo.window.min='256')\n{STREAM}"
            f"@info(name='rule') from S[v > {85.0 + (i % 8) * 0.2}] "
            f"select dev, v insert into Alerts;")


def storm(budget_ms: float, tenants: int = 8, feed: int = 40_000,
          chunk: int = 32, burst: int = 10) -> dict:
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.fleet import group as fleet_group
    steps: dict = {}
    step = fleet_group.FleetGroup._step

    def timed(self, cause):
        t0 = time.perf_counter()
        step(self, cause)
        steps.setdefault(self.effective_window(), []).append(
            time.perf_counter() - t0)

    fleet_group.FleetGroup._step = timed
    gcs = {g: [0, 0.0] for g in range(3)}
    t_gc = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            g = gcs[info["generation"]]
            g[0] += 1
            g[1] += time.perf_counter() - t_gc[0]

    gc.callbacks.append(on_gc)
    m = SiddhiManager(device="cpu")
    try:
        rng = random.Random(3)
        rows = [[f"d{rng.randrange(16)}", round(rng.uniform(0.0, 100.0), 2)]
                for _ in range(feed)]
        tss = list(range(1_000_000, 1_000_000 + feed))
        apps = []
        for i in range(tenants):
            klass = "premium" if i < 2 else \
                "besteffort" if i >= tenants - 2 else "standard"
            rt = m.create_siddhi_app_runtime(
                tenant_app(i, klass, budget_ms if klass == "premium"
                           else None), playback=True)
            rt.add_callback("Alerts", StreamCallback(lambda evs: None))
            rt.start()
            apps.append(rt)
        ihs = [rt.input_handler("S") for rt in apps]
        t0 = time.perf_counter()
        for s in range(0, feed, chunk):
            for j, ih in enumerate(ihs):
                for _ in range(burst if j == tenants - 1 else 1):
                    ih.send_rows([list(r) for r in rows[s:s + chunk]],
                                 tss[s:s + chunk])
        for rt in apps:
            rt.flush_host()
        wall = time.perf_counter() - t0
        ctrl = apps[0].fleet_bridges[0].member.group.slo
        quiet = ctrl.evidence.window()
        return {
            "wall_s": wall,
            "decisions": [d["actuator"] for d in ctrl.decision_log],
            "p99_ms": quiet["end_to_end"]["p99"] * 1e3,
            "phases_p99_ms": {k: quiet[k]["p99"] * 1e3
                              for k in ("fill_wait", "step")},
            "steps_ms": {str(w): {"n": len(v),
                                  "median": float(np.median(v)) * 1e3,
                                  "p99": float(np.percentile(v, 99)) * 1e3,
                                  "max": float(max(v)) * 1e3}
                         for w, v in sorted(steps.items())},
            "gc": {str(g): {"collections": n, "seconds": s}
                   for g, (n, s) in gcs.items()},
        }
    finally:
        gc.callbacks.remove(on_gc)
        fleet_group.FleetGroup._step = step
        m.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--busy", type=int, default=0)
    ap.add_argument("--ballast", type=int, default=0)
    ap.add_argument("--budget-ms", type=float, default=150.0)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    busy = [subprocess.Popen([sys.executable, "-c", BUSY], env=env)
            for _ in range(args.busy)]
    ballast = [[i, str(i)] for i in range(args.ballast)]
    try:
        for run in range(args.runs):
            out = storm(args.budget_ms)
            print(json.dumps({"run": run, "busy": args.busy,
                              "tracked_objects": len(gc.get_objects()),
                              "ballast": len(ballast), **out}), flush=True)
    finally:
        for p in busy:
            p.kill()
            p.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
