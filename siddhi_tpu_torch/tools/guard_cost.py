"""What the default device guard costs, and why async ``AlertRate`` rows
differ from a sync run's, on one card.

    python3 siddhi_tpu_torch/tools/guard_cost.py [--seed 42]
        [--events 262144] [--host-events 262144] [--alert-events 65536]
        [--parts shadow,host,alert_rate]

Three parts, each printing one JSON line; then the card's name and power
limit. Needs a CUDA card.

- ``shadow``: ``chip_smoke.py``'s engine apps ``chain`` (per-event ``send``
  into the blocked NFA) and ``grouped_length`` (``send_columns`` into the
  query step) through the engine, guarded (the default) and unguarded
  (``@app:resilience(device.quarantine='false')``); the chain also guarded
  with the shadow's per-event append in the JAX package's form (``*args``
  and a ``list(row)`` copy) and with no copy (the caller's row kept). Each
  form runs twice, in the order given and then back, each run from a
  collected heap; events/s of each, rows equal.
- ``host``: ``iot_mixed`` (``chip_smoke.py``'s ``engine_host`` app) through
  the card engine guarded and unguarded, in the order guarded, unguarded,
  unguarded, guarded; events/s of each, rows equal.
- ``alert_rate``: for two seeds, ``iot_mixed`` with ``async='true'`` on the
  card without faults (``@app:chaos(device.fail.p='0')``) and with
  ``chip_smoke.py``'s 5 % faults, against the CPU engine sync and async
  under the same chaos settings: each run's ``Alerts`` against the CPU
  sync run's, its ``AlertRate`` rows against the plain time window over
  its own alerts' arrival clock (``chip_smoke.alert_rate_rows``), and how
  many ``AlertRate`` rows differ from the CPU sync run's.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

OFF = "@app:resilience(device.quarantine='false')\n"


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def shadow_append(form: str):
    """Patches ``_ShadowBuilder`` so that a new shadow appends rows as
    ``form`` says: ``no_copy`` keeps the caller's row object, and
    ``reference_form`` is the JAX package's ``append(*args)`` with a
    ``list(row)`` copy; returns the undo."""
    from siddhi_tpu_torch.resilience.device_guard import _ShadowBuilder
    init = _ShadowBuilder.__init__

    def no_copy(self, sid, row, ts):
        self._inner_append(sid, row, ts)
        self._rows.append((sid, row, ts))

    def reference_form(self, *args):
        self._inner.append(*args)
        if self._merged:
            sid, row, ts = args
        else:
            (row, ts), sid = args, None
        self._rows.append((sid, list(row), ts))

    def patched(self, inner, merged):
        init(self, inner, merged)
        if not merged:
            raise TypeError("the shadow forms are measured on merged "
                            "builders (the per-event chain)")
        fn = no_copy if form == "no_copy" else reference_form
        self.append = fn.__get__(self)

    _ShadowBuilder.__init__ = patched
    return lambda: setattr(_ShadowBuilder, "__init__", init)


def part_shadow(cs, seed: int, n_events: int) -> dict:
    import numpy as np
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.tools import engine_workloads as ew
    out = {"part": "shadow", "events": n_events}
    for name in ("chain", "grouped_length"):
        cfg = ew.engine_config(name)
        ev = ew.EngineEvents(name, n_events, seed)
        # the shadow forms differ on the per-event path only
        forms = ["reference_form", "no_copy"] if name == "chain" else []
        order = ["guarded", *forms, "unguarded"]
        rates = {label: [] for label in order}
        rows = {}
        for label in order + order[::-1]:
            app = OFF + cfg["app"] if label == "unguarded" else cfg["app"]
            undo = shadow_append(label) if label in forms else None
            try:
                m = SiddhiManager()
                rt, _ = cs.engine_runtime(m, dict(cfg, app=app))
                gc.collect()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ew.feed_engine(rt, ev)
                rt.flush_device()
                torch.cuda.synchronize()
                rates[label].append(ev.n / (time.perf_counter() - t0))
                rows.setdefault(label, list(rt.got))
                reps = cs.guard_reports(rt)
                m.shutdown()
            finally:
                if undo is not None:
                    undo()
            if any(r["failures"] or r["fallback_events"]
                   for r in reps.values()):
                cs.fail(f"guard_cost shadow {name}: a guard fell back: {reps}")
        if any(r != rows["unguarded"] for r in rows.values()):
            cs.fail(f"guard_cost shadow {name}: the runs' rows differ")
        mean = {k: float(np.mean(v)) for k, v in rates.items()}
        out[name] = {"events_per_s": rates, **{
            f"{k}_over_unguarded": mean[k] / mean["unguarded"]
            for k in order[:-1]}}
    cs.emit(out)
    return out


def part_host(cs, seed: int, n_events: int) -> dict:
    import numpy as np
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.tools import engine_workloads as ew
    app = ew.iot_mixed_app()
    ev = ew.IotEvents(n_events, seed)
    m = SiddhiManager()                 # warm-up: the first launches
    warm = m.create_siddhi_app_runtime(app, playback=True)
    warm.start()
    ew.feed_iot(warm, ev, 0, 8192)
    warm.flush_device()
    m.shutdown()
    rates = {"guarded": [], "unguarded": []}
    rows = {}
    for label in ("guarded", "unguarded", "unguarded", "guarded"):
        gc.collect()
        run = cs.host_engine_run(
            SiddhiManager(), app if label == "guarded" else OFF + app, ev,
            card=True)
        torch.cuda.synchronize()
        rates[label].append(ev.n / run["wall"])
        rows.setdefault(label, run["rows"])
        guards = [b.guard for b in run["rt"].device_bridges]
        if (label == "guarded") != all(g is not None for g in guards):
            cs.fail(f"guard_cost host: {label} run's guards are {guards}")
        if run["errors"]:
            cs.fail(f"guard_cost host: {run['errors']} receiver errors")
    if rows["guarded"] != rows["unguarded"]:
        cs.fail("guard_cost host: the guarded run's rows differ from the "
                "unguarded run's")
    out = {"part": "host", "app": "iot_mixed", "events": ev.n,
           "events_per_s": rates,
           "guarded_over_unguarded": float(np.mean(rates["guarded"])
                                           / np.mean(rates["unguarded"]))}
    cs.emit(out)
    return out


def part_alert_rate(cs, seeds: list, n_events: int) -> dict:
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.tools import engine_workloads as ew
    out = {"part": "alert_rate", "events": n_events, "seeds": {}}
    for seed in seeds:
        ev = ew.IotEvents(n_events, seed)
        per = {}
        for p in ("0", "0.05"):
            chaos = (f"@app:chaos(seed='16', device.fail.p='{p}')\n"
                     "@app:resilience(device.circuit.threshold='1000')\n")
            sync_app = chaos + ew.iot_mixed_app()
            async_app = sync_app.replace("strict='true'",
                                         "strict='true', async='true'")
            runs = {}
            for label, text, card in (("cpu_sync", sync_app, False),
                                      ("cpu_async", async_app, False),
                                      ("card_async", async_app, True)):
                if label == "cpu_async" and p != "0":
                    continue
                manager = SiddhiManager() if card else \
                    SiddhiManager(device="cpu")
                runs[label] = cs.host_engine_run(manager, text, ev, card=card,
                                                 hook=cs.AlertClock)
            base = runs["cpu_sync"]["rows"]
            res = {}
            for label, run in runs.items():
                rows = run["rows"]["AlertRate"]
                res[label] = {
                    "alerts": len(run["rows"]["Alerts"]),
                    "alerts_equal_to_cpu_sync":
                        run["rows"]["Alerts"] == base["Alerts"],
                    "alert_rate_rows": len(rows),
                    "alert_rate_equal_to_its_schedule":
                        rows == cs.alert_rate_rows(run["hook"].arrivals),
                    "alert_rate_rows_differing_from_cpu_sync": sum(
                        a != b for a, b in zip(rows, base["AlertRate"])),
                    "failures": sum(g.failures for g in
                                    run["rt"].resilience.guards),
                    "wall_s": run["wall"]}
                if not (res[label]["alerts_equal_to_cpu_sync"]
                        and res[label]["alert_rate_equal_to_its_schedule"]):
                    cs.fail(f"guard_cost alert_rate seed {seed} p {p} "
                            f"{label}: {res[label]}")
            per[f"fail_p_{p}"] = res
        out["seeds"][str(seed)] = per
    cs.emit(out)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--events", type=int, default=262_144)
    ap.add_argument("--host-events", type=int, default=262_144)
    ap.add_argument("--alert-events", type=int, default=65_536)
    ap.add_argument("--parts", default="shadow,host,alert_rate",
                    help="comma-separated parts to run")
    args = ap.parse_args()
    parts = args.parts.split(",")
    sys.path.insert(0, REPO)
    import logging
    cs = load_chip_smoke()
    cs.phase_device()
    # each injected fault logs its traceback as a WARNING
    logging.getLogger("siddhi_tpu_torch.resilience").setLevel(logging.ERROR)
    if "shadow" in parts:
        part_shadow(cs, args.seed, args.events)
    if "host" in parts:
        part_host(cs, args.seed, args.host_events)
    if "alert_rate" in parts:
        part_alert_rate(cs, [args.seed, args.seed + 3], args.alert_events)
    print(cs.smi(), flush=True)


if __name__ == "__main__":
    main()
