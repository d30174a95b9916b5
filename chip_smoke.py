#!/usr/bin/env python3
"""Runs the port's main path on one NVIDIA card and checks it.

    python3 chip_smoke.py [--seed 42] [--events 2000000]

Phases, one JSON line each:
  1. device  — the card, CUDA, and the build of every CUDA source
               (``siddhi_tpu_torch/csrc``, one nvcc per source, in parallel).
  2. shapes  — the blocked-NFA kernel against its plain PyTorch version on
               the card across pattern shapes (2/3/8 states, stream and
               element ``within``, creation cap set and unset, a sequence
               through 1-lane ``DeviceNFACompiler`` steps, S == 1, two
               streams, an empty lane, integer division by zero). State
               leaves, counters and ys must be exactly equal.
  3. main    — the main path at full width: the bench app (8-state rising
               chain under ``partition with (dev of S)``, 64 lanes, lane
               batch 2048, C = 64, K = 320, 256 keys) fed through
               ``send_many``/``flush(decode=True)``. A timed run gives
               events/s and the kernel's step time; a checked run holds every
               step's state leaves, decoded rows, match and drop counts
               against the plain version stepped on the card from the same
               state.
  4. scan_shapes — the per-event scan kernel against its plain PyTorch
               version on the card: every shape of
               ``tests/test_torch_scan_shapes.py`` (count, logical, absent,
               every scopes, sequences, within, strings, overflow) lane-
               batched, then every device-compilable case of the pattern
               corpus (``tests/test_pattern_corpus.py``, read as data)
               through ``DeviceNFARuntime`` on the card; every step exactly
               equal. ``eventTimestamp()`` in a pattern raises KeyError on
               the card for both shapes, as in the reference.
  5. scan_main — the scan shape at full width: a partitioned two-stream
               app (a stream state, a logical ``and``, a count ``<2:4>``, a
               stream state; 64 lanes, lane batch 2048, C = 64, 256 keys)
               fed 2,000,000 events through ``send_many``/``flush(decode=
               True)``. A timed run gives events/s and the kernel's step
               time; a checked run holds the first steps (state leaves,
               counters, ys, decoded rows) against the plain version on the
               card.
  6. query_shapes — the single-stream query kernels against their plain
               PyTorch version on the card: every case of
               ``tests/test_torch_query_shapes.py`` (each sliding window kind,
               batch(), running and grouped aggregates, having, min/max,
               stdDev, eventTimestamp(), out-of-order externalTime, group
               collisions; lengthBatch, timeBatch, externalTimeBatch,
               session, delay and hopping through ``query_step.cu``, sort,
               frequent and lossyFrequent through ``query_walk.cu``, and
               wider windows whose kernel passes span several blocks), 5
               steps each, state leaves and every output position held to
               that file's tolerances; the reference's refusals refuse on
               the card and one small query per new window compiles there.
  7. query_main — four configurations at full width through
               ``DeviceStreamRuntime`` (``BatchBuilder.append_columns`` →
               step → ``decode_outputs``), ``QUERY_EVENTS`` events each:
               (a) the repo's device sample, a grouped sliding length window
               (4096 rows, 1,000 Zipf(1.1) symbols, K = 1024); (b) an
               ungrouped 10 s sliding time window with min/max/stdDev
               (window capacity 65536, ~50,000 live events); (c) a 10 s
               timeBatch with avg/min/max/stdDev/sum/count (an open bucket
               of ~50,000 events, outputs over 69,632 slots); (d) the
               lossyFrequent fraud query (50,000 Zipf(1.1) card numbers,
               table C = 4096, through ``query_walk.cu``); all are defined
               in ``siddhi_tpu_torch/tools/query_workloads.py``. A timed run
               gives events/s and, by CUDA events, the kernels' time per
               step (around their launch call) and the step call's (the
               wrapper's host work included); a checked run holds every step
               (the first 2 for (d), whose plain version walks the events in
               Python) against the plain version on the card, with the float
               limits computed per step from the state and batch it reads
               (``step_scale``), and prints each output's largest error and
               its largest share of its limit; (c)'s rows are also held to a
               numpy computation of every closed bucket, (d)'s to the
               frequency bound of lossy counting.
  8. join_shapes — the stream-stream join kernel (``csrc/join_step.cu``)
               against its plain PyTorch version on the card: every shape of
               ``tests/test_torch_join_shapes.py`` (time, length and mixed
               windows; inner, left, right and full outer joins;
               unidirectional; within; every column type; eventTimestamp();
               integer division by zero; J and time-ring overflow; k > W;
               empty sides and batches), 6 steps each, every state leaf and
               output position bitwise equal; the reference's refusals and
               the kernel's limits refuse on the card.
  9. join_main — two configurations at full width through
               ``DeviceJoinRuntime`` (``MergedBatchBuilder.append_many`` per
               same-stream run → ``flush``: step + decode), 2,000,000 events
               each, B = W = 4096, J = 16,384, defined in
               ``siddhi_tpu_torch/tools/join_workloads.py``: (e) the
               reference's BASELINE config #4 market join (bids against
               cheaper asks of the same symbol, 2 s / 3 s time windows) and
               (f) a left outer join of sensor readings with the last 256
               regulator states (length windows, nulls, strings, bools). A
               timed run gives events/s and, by CUDA events, the kernel's
               time per step (around ``lib.join_step``) and the step call's;
               a checked run holds every step (state leaves, every output
               position, count, drops) bitwise against the plain version on
               the card; the first 2 steps' rows are held to a direct
               nested-loop join in numpy; 0 join and ring drops.
 10. agg_shapes — the incremental-aggregation kernel
               (``csrc/aggregation_step.cu``) against its plain PyTorch
               version on the card: every shape of
               ``tests/test_torch_agg_shapes.py`` (each duration, months and
               years across the calendar, no group-by, string, int + string
               and LONG keys, filters, every aggregator over INT, LONG,
               FLOAT, DOUBLE and a computed argument, value projections,
               eventTimestamp(), aggregate by an attribute, NaN and ±inf, a
               run of B events, stale padding), 5 steps each, every key and
               [D, B] position bitwise; the reference's refusals and the
               kernel's limits refuse on the card.
 11. agg_main — two configurations at full width through
               ``AggregationRuntime``, 2,000,000 events each, B = 4096,
               defined in ``siddhi_tpu_torch/tools/agg_workloads.py``: (g)
               the Query Guide's trade rollup (1,000 Zipf(1.1) symbols, avg
               and sum every sec ... year, 1 % late trades) and (h) a
               filtered sensor rollup (64 rooms x 16 devices, min, max, avg,
               stdDev and count every sec ... hour). A timed run stages
               through ``append_columns`` + ``_flush_device`` and gives
               events/s and, by CUDA events, the kernel's time per step
               (around ``lib.aggregation_step``) and the step call's; a
               checked run feeds every event through ``receive`` and holds
               every step bitwise against the plain version on the card;
               the final ``rows_for`` of every duration is held to a numpy
               group-by of the 2,000,000 events (counts exact, min/max
               exact against the f32 wire, the float lanes within the
               reference test's rel 1e-4).
Then the card's name and power limit (nvidia-smi), the ``kernels`` line and,
last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line. Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores

SHAPES = {
    "chain2": """
define stream S (v double);
from every e1=S[v > 50.0] -> e2=S[v > e1.v]
select e1.v as a, e2.v as b insert into O;
""",
    "chain3_within": """
define stream S (sym string, v double);
from every e1=S[v > 20.0] -> e2=S[sym == e1.sym and v > e1.v]
  -> e3=S[v > e2.v] within 600
select e1.sym as s, e1.v as a, e2.v as b, e3.v - e1.v as d insert into O;
""",
    "chain8": """
define stream S (dev string, v double);
from every e1=S[v > 60.0] -> e2=S[v > e1.v and dev == e1.dev]
  -> e3=S[v > e2.v] -> e4=S[v > e3.v] -> e5=S[v > e4.v]
  -> e6=S[v > e5.v] -> e7=S[v > e6.v] -> e8=S[v > e7.v] within 4000
select e1.v as v1, e4.v as v4, e8.v as v8 insert into O;
""",
    "element_within": """
define stream S (v double);
from every e1=S[v > 10.0] -> e2=S[v > e1.v] within 300 milliseconds
  -> e3=S[v > e2.v]
select e1.v as a, e2.v as b, e3.v as c insert into O;
""",
    "single": """
define stream S (v double, n int);
from every e1=S[v > 30.0]
select e1.v as a, e1.v * 2.5 as b, e1.n + 1 as c insert into O;
""",
    "two_stream": """
define stream S1 (sym string, p double);
define stream S2 (sym string, p double);
from every e1=S1[p > 20.0] -> e2=S2[sym == e1.sym and p > e1.p] within 5000
select e1.sym as s, e1.p as p1, e2.p as p2 insert into O;
""",
    "intdiv": """
define stream S (x int, y int);
from every e1=S[x > 0] -> e2=S[x / y == e1.x % y or y == 0]
select e1.x as a, e2.x / e2.y as q, e2.x % e1.y as r,
       e1.x / 0 as z insert into O;
""",
    "sequence": """
define stream S (v double);
from every e1=S[v > 10.0], e2=S[v > e1.v]
select e1.v as a, e2.v as b insert into O;
""",
}

# (shape, lane batch B, slots C, creation cap K, lanes)
SHAPE_CASES = [
    ("chain2", 64, 16, None, 4), ("chain2", 256, 16, 24, 8),
    ("chain3_within", 128, 16, None, 8), ("chain3_within", 512, 32, 96, 8),
    ("chain8", 2048, 64, 320, 8), ("chain8", 64, 8, None, 4),
    ("element_within", 256, 16, 48, 8), ("single", 512, 8, None, 8),
    ("two_stream", 256, 16, None, 8), ("intdiv", 128, 16, 32, 8),
    ("sequence", 64, 8, None, 1), ("sequence", 256, 16, 24, 1),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- comparing

def flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def compare(ref: dict, got: dict) -> tuple[bool, float, str]:
    """Exact comparison of two trees of tensors (NaN equals NaN). Returns
    (equal, max abs error over numeric leaves, first differing leaf)."""
    import torch
    r, g = dict(flatten(ref)), dict(flatten(got))
    if r.keys() != g.keys():
        return False, float("inf"), f"leaves {sorted(r.keys() ^ g.keys())}"
    worst, bad = 0.0, ""
    for name in sorted(r):
        a, b = r[name], g[name]
        if a.dtype != b.dtype or a.shape != b.shape:
            return False, float("inf"), f"{name}: {a.dtype}{tuple(a.shape)} vs " \
                f"{b.dtype}{tuple(b.shape)}"
        if a.dtype == torch.bool:
            same = a == b
            err = float((a != b).any())
        else:
            a64, b64 = a.double(), b.double()
            both_nan = torch.isnan(a64) & torch.isnan(b64)
            same = (a == b) | both_nan
            diff = torch.where(both_nan, torch.zeros_like(a64), (a64 - b64).abs())
            err = float(diff.nan_to_num(nan=float("inf")).max()) if diff.numel() else 0.0
        worst = max(worst, err)
        if not bool(same.all()) and not bad:
            bad = name
    return not bad, worst, bad


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


# ---------------------------------------------------------------- batches

def make_batch(rng, comp, lanes: int, empty_lane: bool, ts_step: int = 60,
               base=None):
    """A seeded wire batch [lanes, B]; stale noise past each lane's count.
    ``base`` pins every lane's ts base (else random per lane)."""
    B = comp.B
    cols = {}
    for k in sorted(comp.used_cols):
        t = comp.merged.columns[k].name
        if t in ("FLOAT", "DOUBLE"):
            c = np.round(rng.uniform(0, 100, (lanes, B)), 1).astype(np.float32)
        elif t == "STRING":
            c = rng.integers(1, 4, (lanes, B)).astype(np.int32)
        elif t == "INT":
            c = rng.integers(-3, 9, (lanes, B)).astype(np.int32)
        elif t == "LONG":
            c = rng.integers(-3, 9, (lanes, B)).astype(np.int64)
        else:
            c = rng.integers(0, 2, (lanes, B)).astype(bool)
        cols[k] = c
    tag = rng.integers(0, len(comp.merged.stream_ids), (lanes, B)).astype(np.int8)
    ts = np.cumsum(rng.integers(0, ts_step, (lanes, B)), 1).astype(np.int32)
    base = rng.integers(10**6, 2 * 10**6, lanes).astype(np.int64) \
        if base is None else np.full(lanes, base, np.int64)
    counts = rng.integers(B // 2, B + 1, lanes).astype(np.int32)
    if empty_lane:
        counts[rng.integers(0, lanes)] = 0
    return cols, tag, ts, base, counts


# ---------------------------------------------------------------- phases

def phase_device():
    import torch
    from siddhi_tpu_torch.gpu import _build
    card = smi()
    t0 = time.perf_counter()
    _build.build_all(_build.sources())
    out = {"phase": "device", "card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "build_s": round(time.perf_counter() - t0, 3),
           "nvcc_s": {k: round(v, 3) for k, v in _build.build_seconds.items()}}
    emit(out)
    return card


def phase_shapes(seed: int) -> float:
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.gpu.nfa import DeviceNFACompiler
    from siddhi_tpu_torch.gpu.nfa_block import block_step_plain
    rng = np.random.default_rng(seed)
    worst, cases = 0.0, []
    for name, B, C, K, lanes in SHAPE_CASES:
        app = parse(SHAPES[name])
        comp = DeviceNFACompiler(app.queries[0], dict(app.stream_definitions),
                                 C, B, creation_cap=K, device="cuda")
        state = comp.init_state(lanes)
        step = comp.make_step()
        emitted = 0
        for i in range(4):
            cols, tag, ts, base, counts = make_batch(
                rng, comp, lanes, empty_lane=lanes > 1 and i % 2 == 1)
            dev = {k: torch.from_numpy(v).cuda() for k, v in cols.items()}
            rest = [torch.from_numpy(a).cuda() for a in (tag, ts, base, counts)]
            ref_state, ref_ys = block_step_plain(comp, clone(state), dev, *rest)
            if name == "sequence":           # through the 1-lane entry point
                state, ys = comp.step(state, {
                    "cols": {k: v[0] for k, v in cols.items()}, "tag": tag[0],
                    "ts": ts[0], "ts_base": base[0], "count": int(counts[0])})
                ys = {k: v[None] for k, v in ys.items()}
            else:
                state, ys = step(state, dev, *rest)
            torch.cuda.synchronize()
            ok1, e1, bad1 = compare(ref_state, state)
            ok2, e2, bad2 = compare(ref_ys, ys)
            worst = max(worst, e1, e2)
            if not (ok1 and ok2):
                fail(f"shape {name} B={B} C={C} K={K} step {i}: kernel differs "
                     f"from the plain version at {bad1 or bad2}")
            emitted += int(ref_ys["mask"].sum())
        cases.append({"shape": name, "B": B, "C": C, "K": K, "lanes": lanes,
                      "advanced": emitted, "drops": int(state["drops"].sum()),
                      "equal": True})
    emit({"phase": "shapes", "cases": cases, "max_abs_err": worst})
    return worst


def bench_app(n_states: int = 8) -> str:
    states = " -> ".join(
        f"e{i}=S[v > e{i-1}.v]" if i > 1 else "e1=S[v > 90.0]"
        for i in range(1, n_states + 1))
    sel = ", ".join(f"e{i}.v as v{i}" for i in range(1, n_states + 1))
    return f"""
define stream S (dev string, v double);
partition with (dev of S)
begin
from every {states} within 4000
select {sel} insert into Alerts;
end;
"""


MAIN = dict(num_partitions=64, key_attr="dev", slot_capacity=64,
            lane_batch=2048, creation_cap=320)
N_KEYS = 256
CHUNK = 16384        # events per send_many call: ~256 per lane keeps steps full


def gen_events(n: int, seed: int):
    """``bench.py::gen_events``'s distribution: v uniform [0, 100) to 3
    decimals, one of 256 device keys, ts = 1,000,000 + i."""
    rng = np.random.default_rng(seed)
    names = np.array([f"dev{k}" for k in range(N_KEYS)])
    dev = names[rng.integers(0, N_KEYS, n)]
    v = np.round(rng.uniform(0.0, 100.0, n), 3)
    return dev, v, 1_000_000 + np.arange(n, dtype=np.int64)


def feed(rt, dev, v, ts) -> list:
    rows = []
    for lo in range(0, len(ts), CHUNK):
        sl = slice(lo, lo + CHUNK)
        rows.extend(rt.send_many("S", {"dev": dev[sl], "v": v[sl]}, ts[sl],
                                 decode=True))
    rows.extend(rt.flush(decode=True))
    return rows


def step_bytes(cols, tag, ts, base, counts, state_before, ys) -> int:
    """Bytes one step must move: each input read once, each output written
    once (state tables and counters are read and written)."""
    n = sum(c.numel() * c.element_size() for c in cols.values())
    n += sum(t.numel() * t.element_size() for t in (tag, ts, base, counts))
    n += 2 * sum(t.numel() * t.element_size() for _, t in flatten(state_before))
    n += sum(t.numel() * t.element_size() for t in ys.values())
    return n


def phase_main(seed: int, n_events: int):
    import torch
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan, block_step_plain
    from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
    dev, v, ts = gen_events(n_events, seed)

    # ---- timed run: the entry points alone, the kernel step timed by events
    rt = PartitionedNFARuntime(bench_app(), device="cuda", **MAIN)
    kernel_step = rt.vstep
    marks = []

    def timed(state, *args):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = kernel_step(state, *args)
        e1.record()
        marks.append((e0, e1, args[4]))
        return out

    rt.vstep = timed
    feed(rt, dev[:CHUNK], v[:CHUNK], ts[:CHUNK])        # warm-up (untimed)
    rt = PartitionedNFARuntime(bench_app(), device="cuda", **MAIN)
    kernel_step = rt.vstep
    rt.vstep = timed
    marks.clear()
    torch.cuda.synchronize()
    BlockPlan.launches = 0                     # counts from here: main path
    t0 = time.perf_counter()
    rows = feed(rt, dev, v, ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = BlockPlan.launches
    steps = len(marks)
    step_ms = [a.elapsed_time(b) for a, b, _ in marks]
    fill = [int(n.sum()) for _, _, n in marks]
    timed_rows, timed_matches, timed_drops = rows, rt.match_count, rt.drop_count
    if launches != steps * (rt.compiler.S - 1) or launches == 0:
        fail(f"main path: {launches} kernel launches over {steps} steps")

    # ---- checked run: every step against the plain version on the card
    rt = PartitionedNFARuntime(bench_app(), device="cuda", **MAIN)
    kernel_step = rt.vstep
    comp = rt.compiler
    plain_rows, plain_ms, worst, work, nbytes = [], [], 0.0, {}, []

    def checked(state, cols, tag, ts_, base, counts):
        before = clone(state)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        w = {}
        e0.record()
        ref_state, ref_ys = block_step_plain(comp, before, cols, tag, ts_,
                                             base, counts, work=w)
        e1.record()
        state, ys = kernel_step(state, cols, tag, ts_, base, counts)
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
        for k, x in w.items():
            work[k] = work.get(k, 0) + x
        nbytes.append(step_bytes(cols, tag, ts_, base, counts, before, ys))
        nonlocal worst
        ok1, e_1, bad1 = compare(ref_state, state)
        ok2, e_2, bad2 = compare(ref_ys, ys)
        worst = max(worst, e_1, e_2)
        if not (ok1 and ok2):
            fail(f"main path step {len(plain_ms)}: kernel differs from the "
                 f"plain version at {bad1 or bad2}")
        host = {k: x.cpu().numpy() for k, x in ref_ys.items()}
        for lane in range(rt.P):
            plain_rows.extend(comp.decode_outputs(
                {k: x[lane] for k, x in host.items()}))
        return state, ys

    rt.vstep = checked
    rows = feed(rt, dev, v, ts)
    if rows != plain_rows:
        fail("main path: decoded rows differ from the plain version's")
    if rows != timed_rows or rt.match_count != timed_matches \
            or rt.drop_count != timed_drops:
        fail("main path: the checked run differs from the timed run")
    if rt.match_count != len(rows):
        fail(f"main path: match_count {rt.match_count} != {len(rows)} rows")
    for r in rows:
        if len(r) != 8 or not all(np.isfinite(x) for x in r) or \
                not (r[0] > 90.0 and all(a < b for a, b in zip(r, r[1:]))):
            fail(f"main path: row breaks the rising-chain contract: {r}")

    med = float(np.median(step_ms))
    pmed = float(np.median(plain_ms))
    mean_bytes = float(np.mean(nbytes))
    ops_per_step = work.get("ops", 0) / max(len(plain_ms), 1)
    bound_bytes_ms = mean_bytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops_per_step / F32_OPS_PER_S * 1e3
    out = {
        "phase": "main", "events": int(n_events), "steps": steps,
        "events_per_s": n_events / wall, "wall_s": wall,
        "kernel_step_ms_median": med, "kernel_step_ms_all": step_ms,
        "plain_step_ms_median": pmed,
        "launches_per_step": launches / steps, "launches": launches,
        "matches": timed_matches, "drops": timed_drops, "rows": len(rows),
        "mean_lane_fill": float(np.mean(fill)) / (MAIN["num_partitions"] *
                                                  MAIN["lane_batch"]),
        "bytes_per_step": mean_bytes, "search_cells_per_step":
            work.get("cells", 0) / max(len(plain_ms), 1),
        "ops_per_step": ops_per_step,
        "bound_ms_bytes": bound_bytes_ms, "bound_ms_ops": bound_ops_ms,
        "max_abs_err": worst, "checked_steps": len(plain_ms),
    }
    emit(out)
    return out


# ---------------------------------------------------------- the scan shape

def scan_shapes_module():
    """``tests/test_torch_scan_shapes.py``: the scan apps and cases the CPU
    tests run (it imports the port, not the JAX package)."""
    import importlib.util
    path = os.path.join(REPO, "tests", "test_torch_scan_shapes.py")
    spec = importlib.util.spec_from_file_location("test_torch_scan_shapes",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corpus_data() -> dict:
    """The data region of ``tests/test_pattern_corpus.py`` (app texts and
    the ``CASES`` list; no imports), executed on its own: the file imports
    the JAX package, which this script never imports."""
    import types

    class _Param:
        @staticmethod
        def param(*values, id=None):
            return types.SimpleNamespace(values=values, id=id)

    with open(os.path.join(REPO, "tests", "test_pattern_corpus.py")) as f:
        src = f.read()
    start = src.index('S2 = """')
    end = src.index("def test_every_zero_min_count_alone")
    ns = {"pytest": _Param}
    exec(src[start:end], ns)
    return ns


def checking_step(comp, state_err: list):
    """The compiled step, held against its plain version on every call
    (same inputs, plain first on a copy of the state)."""
    import torch
    from siddhi_tpu_torch.gpu.nfa_block import block_step_plain
    from siddhi_tpu_torch.gpu.nfa_scan import scan_step_plain
    kstep = comp.make_step()
    plain = block_step_plain if comp.blocked else scan_step_plain

    def step(state, *args):
        ref_state, ref_ys = plain(comp, clone(state), *args)
        state, ys = kstep(state, *args)
        torch.cuda.synchronize()
        ok1, e1, bad1 = compare(ref_state, state)
        ok2, e2, bad2 = compare(ref_ys, ys)
        state_err.append(max(e1, e2))
        if not (ok1 and ok2):
            raise AssertionError(f"kernel differs from the plain version at "
                                 f"{bad1 or bad2}")
        return state, ys
    step.plan = kstep.plan
    return step


TS_APPS = {
    "blocked": """
define stream S (v double);
from every e1=S[v > 1.0] -> e2=S[v > e1.v and eventTimestamp() > 0]
select e1.v as a insert into O;
""",
    "scan": """
define stream S (v double);
from every e1=S[v > 1.0] -> e2=S[v > e1.v]<1:2> -> e3=S[eventTimestamp() > 0]
select e1.v as a insert into O;
""",
}


def phase_scan_shapes(seed: int) -> float:
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
    from siddhi_tpu_torch.gpu.nfa import DeviceNFACompiler, DeviceNFARuntime
    rng = np.random.default_rng(seed)
    errs: list = []
    # ---- the CPU tests' shapes, lane-batched, 4 steps each
    shapes = scan_shapes_module()
    cases = []
    for name, B, C, lanes, ts_step, base in shapes.CASES:
        app = parse(shapes.APPS[name][0])
        comp = DeviceNFACompiler(app.queries[0], dict(app.stream_definitions),
                                 C, B, device="cuda")
        if comp.blocked:
            fail(f"scan shape {name} compiled to the blocked kernel")
        step = checking_step(comp, errs)
        state = comp.init_state(lanes, 0 if base is not None else 1_000_000)
        emitted = 0
        for i in range(4):
            cols, tag, ts, tb, counts = make_batch(
                rng, comp, lanes, i % 2 == 1, ts_step, base)
            dev = {k: torch.from_numpy(v).cuda() for k, v in cols.items()}
            rest = [torch.from_numpy(a).cuda() for a in (tag, ts, tb, counts)]
            try:
                state, ys = step(state, dev, *rest)
            except AssertionError as e:
                fail(f"scan shape {name} B={B} C={C} step {i}: {e}")
            emitted += int(ys["mask"].sum())
        cases.append({"shape": name, "B": B, "C": C, "lanes": lanes,
                      "emitted": emitted, "drops": int(state["drops"].sum()),
                      "equal": True})
    # ---- the pattern corpus through DeviceNFARuntime on the card
    corpus = corpus_data()
    start = 900                       # test_pattern_corpus.START
    n_scan = n_block = rows = steps = 0
    for p in corpus["CASES"]:
        app, seq = p.values[0], p.values[1]
        try:
            rt = DeviceNFARuntime(app, slot_capacity=32, batch_capacity=32,
                                  start_time=start, device="cuda")
        except DeviceCompileError:
            continue
        n0 = len(errs)
        rt.compiler._step = checking_step(rt.compiler, errs)
        out: list = []
        rt.add_callback(out.extend)
        ts = start
        try:
            for entry in seq:
                ts += entry[2] if len(entry) > 2 else 100
                rt.send(entry[0], list(entry[1]), ts)
            rt.flush()
        except AssertionError as e:
            fail(f"corpus case {p.id}: {e}")
        n_block += rt.compiler.blocked
        n_scan += not rt.compiler.blocked
        rows += len(out)
        steps += len(errs) - n0
    # ---- eventTimestamp() in a pattern: KeyError('__ts__') at the first
    # step, for both shapes, as the reference raises
    for shape, text in TS_APPS.items():
        app = parse(text)
        comp = DeviceNFACompiler(app.queries[0], dict(app.stream_definitions),
                                 8, 16, device="cuda")
        batch = {"cols": {"s0_v": np.array([2.0, 3.0] + [0.0] * 14,
                                           np.float32)},
                 "tag": np.zeros(16, np.int8),
                 "ts": np.array([0, 100] + [0] * 14, np.int32),
                 "ts_base": np.int64(5000), "count": 2}
        try:
            comp.step(comp.init_state(1), batch)
            fail(f"eventTimestamp() in a {shape} pattern did not raise")
        except KeyError as e:
            if "__ts__" not in str(e):
                fail(f"eventTimestamp() in a {shape} pattern: {e!r}")
    worst = max(errs) if errs else 0.0
    emit({"phase": "scan_shapes", "cases": cases,
          "corpus": {"scan_cases": n_scan, "blocked_cases": n_block,
                     "steps_checked": steps, "rows": rows, "equal": True},
          "event_timestamp_raises": True, "max_abs_err": worst})
    return worst


SCAN_APP = """
define stream Temp (dev string, v double);
define stream Reg (dev string, action string);
partition with (dev of Temp, dev of Reg)
begin
from every e1=Temp[v > 90.0] -> e2=Temp[v > e1.v] and e3=Reg[action == 'on']
  -> e4=Temp[v > e2.v]<2:4> -> e5=Temp[v < e1.v] within 4000
select e1.dev as dev, e1.v as v1, e3.action as a, e5.v as v5 insert into Alerts;
end;
"""
SCAN_MAIN = dict(num_partitions=64, key_attr="dev", slot_capacity=64,
                 lane_batch=2048)
SCAN_EVENTS = 2_000_000
SCAN_CHECK_STEPS = 2     # full-width steps held against the plain version


def scan_events(n: int, seed: int):
    """The scan path's traffic: 90 % Temp with v ~ U(0, 100), 10 % Reg with
    action on/off at 50 % each, keys uniform over 256, ts increments
    U{0, 1, 2} ms."""
    rng = np.random.default_rng(seed)
    keys = np.array([f"dev{k}" for k in range(N_KEYS)])
    dev = keys[rng.integers(0, N_KEYS, n)]
    is_temp = rng.random(n) < 0.9
    v = np.round(rng.uniform(0.0, 100.0, n), 3)
    action = np.where(rng.random(n) < 0.5, "on", "off")
    ts = 1_000_000 + np.cumsum(rng.integers(0, 3, n))
    return dev, is_temp, v, action, ts


def feed_scan(rt, ev, stop=None) -> list:
    """Runs of consecutive same-stream events through ``send_many``, then
    ``flush(decode=True)``; ``stop()`` ends the feed early."""
    dev, is_temp, v, action, ts = ev
    # run boundaries: where the stream changes
    cut = np.flatnonzero(is_temp[1:] != is_temp[:-1]) + 1
    lo_all = np.concatenate([[0], cut])
    hi_all = np.concatenate([cut, [len(ts)]])
    rows: list = []
    for lo, hi in zip(lo_all, hi_all):
        if stop is not None and stop():
            return rows
        sl = slice(int(lo), int(hi))
        if is_temp[lo]:
            rows.extend(rt.send_many("Temp", {"dev": dev[sl], "v": v[sl]},
                                     ts[sl], decode=True))
        else:
            rows.extend(rt.send_many("Reg", {"dev": dev[sl],
                                             "action": action[sl]},
                                     ts[sl], decode=True))
    rows.extend(rt.flush(decode=True))
    return rows


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in flatten(tree))


def scan_ops(plan, L: int, B: int) -> int:
    """Operations one step does on these inputs, at the least: for every
    event, lane and slot, each state's mask arithmetic (~10 elementwise
    operations) and its linked predicate programs."""
    d = plan.desc
    per_slot = 0
    for s in range(d.S):
        st = d.st[s]
        per_slot += 10 + sum(st.pred[i].len + st.pred_prev[i].len
                             for i in range(st.nbr))
    return L * B * d.C * per_slot


def phase_scan_main(seed: int, n_events: int):
    import torch
    from siddhi_tpu_torch.gpu.nfa_scan import ScanPlan, scan_step_plain
    from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
    ev = scan_events(n_events, seed)

    # ---- warm-up (builds, first launch) on a throwaway runtime
    rt = PartitionedNFARuntime(SCAN_APP, device="cuda", **SCAN_MAIN)
    if rt.compiler.blocked or [s.kind for s in rt.compiler.states] != \
            ["stream", "logical", "count", "stream"]:
        fail("scan_main: the app does not compile to the 4-state scan shape")
    feed_scan(rt, tuple(x[:CHUNK] for x in ev))
    torch.cuda.synchronize()

    # ---- timed run: the entry points alone, the kernel step timed by events
    rt = PartitionedNFARuntime(SCAN_APP, device="cuda", **SCAN_MAIN)
    kernel_step = rt.vstep
    marks, step_rows = [], []
    shapes = {}

    def timed(state, *args):
        if not shapes:
            shapes["wire"] = sum(t.numel() * t.element_size()
                                 for t in [*args[0].values(), *args[1:]])
            shapes["state"] = tree_bytes(state)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = kernel_step(state, *args)
        e1.record()
        marks.append((e0, e1, args[4]))
        shapes["ys"] = tree_bytes(out[1])
        return out

    step_and_decode = rt._step_and_decode

    def per_step_rows(*args):
        r = step_and_decode(*args)
        step_rows.append(list(r))
        return r

    rt.vstep = timed
    rt._step_and_decode = per_step_rows
    torch.cuda.synchronize()
    ScanPlan.launches = 0                       # counts from here: main path
    t0 = time.perf_counter()
    rows = feed_scan(rt, ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ScanPlan.launches
    steps = len(marks)
    step_ms = [a.elapsed_time(b) for a, b, _ in marks]
    fill = [int(n.sum()) for _, _, n in marks]
    matches, drops = rt.match_count, rt.drop_count
    if launches != steps or launches == 0:
        fail(f"scan_main: {launches} kernel launches over {steps} steps")
    if matches != len(rows) or matches == 0:
        fail(f"scan_main: match_count {matches}, {len(rows)} rows")
    for r in rows:
        if len(r) != 4 or not isinstance(r[0], str) or r[2] != "on" or \
                not (np.isfinite(r[1]) and np.isfinite(r[3])) or \
                not (r[1] > 90.0 and r[3] < r[1]):
            fail(f"scan_main: row breaks the pattern's contract: {r}")

    # ---- checked run: the first steps against the plain version on the card
    rt = PartitionedNFARuntime(SCAN_APP, device="cuda", **SCAN_MAIN)
    comp = rt.compiler
    kernel_step = rt.vstep
    plain_ms, worst, checked_rows = [], 0.0, []

    def checked(state, cols, tag, ts_, base, counts):
        nonlocal worst
        if len(plain_ms) >= SCAN_CHECK_STEPS:
            return kernel_step(state, cols, tag, ts_, base, counts)
        before = clone(state)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        ref_state, ref_ys = scan_step_plain(comp, before, cols, tag, ts_,
                                            base, counts)
        e1.record()
        state, ys = kernel_step(state, cols, tag, ts_, base, counts)
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
        ok1, e_1, bad1 = compare(ref_state, state)
        ok2, e_2, bad2 = compare(ref_ys, ys)
        worst = max(worst, e_1, e_2)
        if not (ok1 and ok2):
            fail(f"scan_main step {len(plain_ms)}: kernel differs from the "
                 f"plain version at {bad1 or bad2}")
        got, want = comp.decode_outputs(ys), comp.decode_outputs(ref_ys)
        if got != want:
            fail(f"scan_main step {len(plain_ms)}: decoded rows differ")
        checked_rows.append(got)
        return state, ys

    rt.vstep = checked
    feed_scan(rt, ev, stop=lambda: len(plain_ms) >= SCAN_CHECK_STEPS)
    if len(plain_ms) < min(SCAN_CHECK_STEPS, steps):
        fail(f"scan_main: only {len(plain_ms)} steps checked")
    if checked_rows != step_rows[:len(checked_rows)]:
        fail("scan_main: the checked run's rows differ from the timed run's")

    L, B = SCAN_MAIN["num_partitions"], SCAN_MAIN["lane_batch"]
    nbytes = shapes["wire"] + 2 * shapes["state"] + shapes["ys"]
    ops = scan_ops(kernel_step.plan, L, B)
    out = {
        "phase": "scan_main", "events": int(n_events), "steps": steps,
        "events_per_s": n_events / wall, "wall_s": wall,
        "kernel_step_ms_median": float(np.median(step_ms)),
        "kernel_step_ms_min": float(np.min(step_ms)),
        "kernel_step_ms_max": float(np.max(step_ms)),
        "kernel_step_ms_all": step_ms,
        "plain_step_ms_median": float(np.median(plain_ms)),
        "plain_step_ms_all": plain_ms, "plain_device": "cuda",
        "checked_steps": len(plain_ms), "launches": launches,
        "matches": matches, "drops": drops, "rows": len(rows),
        "send_many_calls": 1 + int(np.count_nonzero(ev[1][1:] != ev[1][:-1])),
        "mean_lane_fill": float(np.mean(fill)) / (L * B),
        "bytes_per_step": nbytes, "ys_bytes_per_step": shapes["ys"],
        "wire_bytes_per_step": shapes["wire"],
        "state_bytes": shapes["state"], "ops_per_step": ops,
        "bound_ms_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_ms_ops": ops / F32_OPS_PER_S * 1e3,
        "max_abs_err": worst,
    }
    emit(out)
    return out


# ------------------------------------------------- single-stream queries

def query_shapes_module():
    """``tests/test_torch_query_shapes.py``: the query cases, refusal lists
    and tolerances of the CPU tests (it imports the port, not the JAX
    package)."""
    import importlib.util
    path = os.path.join(REPO, "tests", "test_torch_query_shapes.py")
    spec = importlib.util.spec_from_file_location("test_torch_query_shapes",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_query_shapes() -> float:
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
    from siddhi_tpu_torch.gpu.query_compile import (CompiledStreamQuery,
                                                    stream_step_plain)
    from siddhi_tpu_torch.gpu.state_io import state_to_numpy
    sh = query_shapes_module()
    t_phase = time.perf_counter()
    worst, cases = 0.0, []
    for name, B in sh.CASES + sh.WINDOW_CASES + sh.CARD_CASES:
        q = sh.compile_port(name, B, "cuda")
        state = q.init_state()
        wire = sh.wire_for(name, B)
        rows = 0
        for step in range(sh.STEPS):
            cols, ts, valid = q.batch_tensors(wire.batch(step))
            scale = sh.step_scale(q, state, cols, ts, valid)
            ref_state, ref_out = stream_step_plain(q, state, cols, ts, valid)
            state, out = q.step_tensors(state, cols, ts, valid)
            torch.cuda.synchronize()
            try:
                err = sh.compare(q, scale, state_to_numpy(ref_state),
                                 state_to_numpy(state),
                                 state_to_numpy(ref_out), state_to_numpy(out))
            except AssertionError as e:
                fail(f"query shape {name} B={B} step {step}: kernel differs "
                     f"from the plain version: {str(e)[:400]}")
            worst = max(worst, err)
            rows += int(out["valid"].sum())
        cases.append({"query": name, "B": B, "kernel": q.plan.LIB,
                      "rows": rows})

    def build(text):
        app = parse(sh.REFUSAL_SCHEMA + text)
        return CompiledStreamQuery(app.queries[0], app.stream_definitions["S"],
                                   8, device="cuda")

    for text in sh.REFUSED:
        try:
            build(text)
            fail(f"the card accepted a query the reference refuses: {text}")
        except DeviceCompileError:
            pass
    for text in sh.STEP_RAISES:
        q = build(text)
        try:
            q.step(q.init_state(), sh.refusal_wire(8))
            fail(f"a constant projection ran on the card: {text}")
        except AttributeError:
            pass
    for window, body in sh.STAGED.items():
        if build(f"from S{body} insert into O;").plan.link_error is not None:
            fail(f"window '{window}': the kernel plan does not link")
    for text in sh.ACCEPTED:
        build(text)
    emit({"phase": "query_shapes", "cases": cases, "refused": len(sh.REFUSED),
          "step_raises": len(sh.STEP_RAISES),
          "windows_compiled": len(sh.STAGED), "accepted": len(sh.ACCEPTED),
          "max_abs_err": worst, "phase_s": time.perf_counter() - t_phase})
    return worst


QUERY_EVENTS = 2_000_000          # events per query_main configuration
# full-width steps held against the plain version (None: every step); the
# heavy hitters' plain version walks each event in Python
QUERY_CHECK_STEPS = {"lossy_frequent": 2}


def query_step_bytes(state, new_state, cols, ts, valid, out) -> int:
    """Bytes one step must move: the columns it reads, the state leaves it
    reads and the ones it writes anew, the outputs."""
    n = sum(t.numel() * t.element_size() for t in (*cols.values(), ts, valid))
    n += sum(t.numel() * t.element_size() for t in state.values())
    n += sum(t.numel() * t.element_size() for k, t in new_state.items()
             if t is not state[k])
    n += sum(t.numel() * t.element_size() for t in
             (*out["out"].values(), out["valid"], out["ts"]))
    return n


def query_step_ops(q) -> int:
    """Operations one step does at the least: every event runs its filter and
    argument programs; every scanned lane adds once per position of its axis;
    every output slot materialises its specs (a few operations each) and,
    grouped or time-windowed, binary-searches its range (log2 of the axis)."""
    a = q.plan.args
    prog = sum(p.len for p in a.filt[:a.nfilt]) + \
        sum(a.lane[c][l].len for c, n in enumerate((a.AF, a.AI, a.AS, a.AM))
            for l in range(n)) + \
        sum(a.proj[i].len for i in range(a.nspec)) + a.having.len
    if q.plan.LIB == "query_walk":
        # every event looks its key up in the table and the lossy window's
        # prune visits every slot: two passes over the C slots per event
        return q.B * prog + q.B * 2 * a.N + q.B * 4 * a.nspec
    lanes = a.AF + a.AI + 1 + 2 * a.AS + 2 * a.AM if a.has_agg else 0
    search = int(np.log2(max(a.M, 2))) * (2 if a.grouped else 1)
    return q.B * prog + a.M * lanes + a.O * (4 * a.nspec + search)


def time_batch_reference(cols, ts) -> list:
    """(c)'s rows from numpy alone: the accepted events (v > 0 in float32)
    bucketed by (ts - first ts) // 10 s; every bucket but the open last one
    gives [avg, min, max, stdDev, sum(n), count]."""
    v = cols["v"].astype(np.float32)
    acc = v > 0
    va, na, ta = v[acc].astype(np.float64), cols["n"][acc], ts[acc]
    seg = (ta - ta[0]) // 10_000
    out = []
    for b in np.unique(seg)[:-1]:
        m = seg == b
        x = va[m]
        out.append([float(x.mean()), float(x.min()), float(x.max()),
                    float(x.std()), int(na[m].sum()), int(m.sum())])
    return out


def check_query_rows(name: str, rows: list, cols, ts) -> dict:
    """Each configuration's rows against what the query promises (and, for
    (c) and (d), against numpy)."""
    extra = {}
    if name == "time_batch":
        want = time_batch_reference(cols, ts)
        if len(rows) != len(want):
            fail(f"query_main {name}: {len(rows)} rows, numpy gives {len(want)}")
        for r, w in zip(rows, want):
            if r[4:] != w[4:] or r[1] != w[1] or r[2] != w[2] or \
                    abs(r[0] - w[0]) > 1e-4 * max(1.0, abs(w[0])) or \
                    abs(r[3] - w[3]) > 1e-3:
                fail(f"query_main {name}: row {r} differs from numpy's {w}")
        extra["numpy_buckets"] = len(want)
        return extra
    if name == "lossy_frequent":
        cards, price = cols["cardNo"], cols["price"].astype(np.float32)
        acc = cards[price >= 30.0]
        uniq, cnt = np.unique(acc, return_counts=True)
        share = cnt / len(acc)
        top = uniq[np.argmax(cnt)]
        # a key emits only if its count in the prefix read so far is at
        # least (support - error) of it: once the prefix is long, only the
        # top card (~14 %) qualifies, every other card holds under 9 %
        late = {r[0] for r in rows[len(rows) // 2:]}
        if late != {top} or np.sort(share)[-2] >= 0.09:
            fail(f"query_main {name}: the late rows name {sorted(late)[:5]} "
                 f"(top card {top}, shares {np.sort(share)[-2:]})")
        # the reference retracts every pruned entry's last event, emitted
        # or not, so the running sum and count may fall below zero
        for r in rows:
            if not (isinstance(r[0], str) and np.isfinite(r[1])
                    and isinstance(r[2], int)):
                fail(f"query_main {name}: row breaks the query's contract: {r}")
        extra.update(emitted_cards=len({r[0] for r in rows}),
                     top_card_share=float(share.max()))
        return extra
    for r in rows:
        if name == "grouped_length":
            ok = isinstance(r[0], str) and 1 <= r[3] <= 4096 and \
                np.isfinite(r[1]) and r[1] >= 0 and 0 <= r[2] and \
                abs(r[4] - r[1] / r[3]) <= 1e-3 * max(1.0, r[4])
        else:
            ok = 1 <= r[4] <= 65536 and r[1] - 1e-3 <= r[0] <= r[2] + 1e-3 \
                and r[3] >= 0 and 0 <= r[1] and r[2] < 100
        if not ok:
            fail(f"query_main {name}: row breaks the query's contract: {r}")
    return extra


def phase_query_main(name: str, seed: int) -> dict:
    import torch
    from siddhi_tpu_torch.gpu.query_compile import stream_step_plain
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    from siddhi_tpu_torch.gpu.query_walk import WalkPlan
    from siddhi_tpu_torch.gpu.runtime import DeviceStreamRuntime
    from siddhi_tpu_torch.gpu.state_io import state_to_numpy
    from siddhi_tpu_torch.tools.query_workloads import (QUERY_MAIN,
                                                        feed_query,
                                                        query_events)
    sh = query_shapes_module()
    t_phase = time.perf_counter()
    cfg = dict(QUERY_MAIN[name])
    app = cfg.pop("app")
    cfg.pop("stream")
    cols, ts = query_events(name, QUERY_EVENTS, seed)

    # warm-up: build, first launches
    rt = DeviceStreamRuntime(app, device="cuda", **cfg)
    feed_query(rt, {k: v[:3 * rt.compiled.B] for k, v in cols.items()},
               ts[:3 * rt.compiled.B])
    torch.cuda.synchronize()

    # ---- timed run: the entry points alone; CUDA events around the step
    # call (the wrapper's host work included) and around the kernels'
    # launch call alone (``lib.query_step``: the kernels' own time)
    rt = DeviceStreamRuntime(app, device="cuda", **cfg)
    q = rt.compiled
    kstep = q.step_tensors
    marks, kmarks, shapes = [], [], {}

    def event_pair():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def timed(state, c, t, v):
        e0, e1 = event_pair()
        e0.record()
        new, out = kstep(state, c, t, v)
        e1.record()
        marks.append((e0, e1))
        if not shapes:
            shapes["bytes"] = query_step_bytes(state, new, c, t, v, out)
        return new, out

    plan = type(q.plan)
    lib = q.plan._lib()
    entry = getattr(lib, plan.LIB)

    class TimedLib:
        def __getattr__(self, attr):
            if attr != plan.LIB:
                return getattr(lib, attr)

            def call(*a):
                e0, e1 = event_pair()
                e0.record()
                rc = entry(*a)
                e1.record()
                kmarks.append((e0, e1))
                return rc
            return call

    timed_lib = TimedLib()
    q.plan._lib = lambda: timed_lib
    q.step_tensors = timed
    torch.cuda.synchronize()
    QueryPlan.launches = WalkPlan.launches = 0   # counts from here: main path
    t0 = time.perf_counter()
    rows = feed_query(rt, cols, ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = plan.launches
    other = QueryPlan.launches + WalkPlan.launches - launches
    steps = len(marks)
    call_ms = [a.elapsed_time(b) for a, b in marks]
    step_ms = [a.elapsed_time(b) for a, b in kmarks]
    if len(kmarks) != steps:
        fail(f"query_main {name}: {len(kmarks)} kernel calls over {steps} steps")
    per_step = 1 if plan is WalkPlan else (3 if q.agg_idx else 2)
    if launches != steps * per_step or launches == 0 or other:
        fail(f"query_main {name}: {launches} {plan.LIB} launches over {steps} "
             f"steps ({other} of the other query kernel)")
    drops = int(rt.state["window_drops"]) if "window_drops" in rt.state else 0
    coll = rt.group_collision_count
    if (drops and name != "lossy_frequent") or coll:
        fail(f"query_main {name}: {drops} window drops, {coll} collisions")
    extra = check_query_rows(name, rows, cols, ts)

    # ---- checked run: every step against the plain version on the card
    rt = DeviceStreamRuntime(app, device="cuda", **cfg)
    q = rt.compiled
    kstep = q.step_tensors
    plain_ms, worst, equal_steps = [], 0.0, 0
    limits, fsum_limit = {}, []
    check_steps = QUERY_CHECK_STEPS.get(name)

    def checked(state, c, t, v):
        nonlocal worst, equal_steps
        if check_steps is not None and len(plain_ms) >= check_steps:
            return kstep(state, c, t, v)
        e0, e1 = event_pair()
        e0.record()
        ref_state, ref_out = stream_step_plain(q, state, c, t, v)
        e1.record()
        new, out = kstep(state, c, t, v)
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
        scale = sh.step_scale(q, state, c, t, v)
        fsum_limit.append(2.0 ** -20 * (1.0 + scale.top("s1")))
        try:
            err = sh.compare(q, scale, state_to_numpy(ref_state),
                             state_to_numpy(new), state_to_numpy(ref_out),
                             state_to_numpy(out), limits)
        except AssertionError as e:
            fail(f"query_main {name} step {len(plain_ms)}: kernel differs "
                 f"from the plain version: {str(e)[:400]}")
        worst = max(worst, err)
        equal_steps += err == 0.0
        return new, out

    q.step_tensors = checked
    rows2 = feed_query(rt, cols, ts)
    if rows2 != rows:
        fail(f"query_main {name}: the checked run's rows differ from the "
             f"timed run's")
    ops = query_step_ops(q)
    out = {
        "phase": "query_main", "config": name, "kernel": plan.LIB,
        "events": QUERY_EVENTS,
        "steps": steps, "events_per_s": QUERY_EVENTS / wall, "wall_s": wall,
        "launches": launches, "launches_per_step": launches / steps,
        "kernel_step_ms_median": float(np.median(step_ms)),
        "kernel_step_ms_min": float(np.min(step_ms)),
        "kernel_step_ms_max": float(np.max(step_ms)),
        "step_call_ms_median": float(np.median(call_ms)),
        "plain_step_ms_median": float(np.median(plain_ms)),
        "plain_device": "cuda", "checked_steps": len(plain_ms),
        "bitwise_equal_steps": equal_steps,
        "rows": len(rows), "window_drops": drops, "group_collisions": coll,
        "bytes_per_step": shapes["bytes"], "ops_per_step": ops,
        "bound_ms_bytes": shapes["bytes"] / HBM_BYTES_PER_S * 1e3,
        "bound_ms_ops": ops / F32_OPS_PER_S * 1e3,
        "max_abs_err": worst, "errors_by_output": limits,
        "fsum_limit_min": float(np.min(fsum_limit)),
        "fsum_limit_max": float(np.max(fsum_limit)),
        "phase_s": time.perf_counter() - t_phase, **extra,
    }
    emit(out)
    return out


QUERY_ENTRIES = [
    # (name, source, replaced TPU kernel, also replaced, configurations)
    ("query_step", "query_step.cu", "siddhi_tpu/tpu/query_compile.py:608",
     ["siddhi_tpu/tpu/expr_compile.py:121"],
     ("grouped_length", "time_minmax_std")),
    ("query_step_tumbling", "query_step.cu",
     "siddhi_tpu/tpu/query_compile.py:1316",
     ["siddhi_tpu/tpu/query_compile.py:1235",
      "siddhi_tpu/tpu/query_compile.py:872",
      "siddhi_tpu/tpu/query_compile.py:1554", "siddhi_tpu/tpu/runtime.py:21"],
     ("time_batch",)),
    ("query_walk", "query_walk.cu", "siddhi_tpu/tpu/query_compile.py:1648",
     ["siddhi_tpu/tpu/query_compile.py:1447"], ("lossy_frequent",)),
]


def query_kernel_entries(q_outs: list, shapes_err: float) -> list:
    """The ``kernels`` line's query entries: B5a (times and bound of the
    sample's configuration (a), (b) beside it under ``configs``), the
    tumbling family of B5b ((c)) and the scan-walked kernel ((d))."""
    by = {o["config"]: o for o in q_outs}
    entries = []
    for name, src, replaces, also, configs in QUERY_ENTRIES:
        outs = [by[c] for c in configs]
        a = outs[0]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "also_replaces": also,
            "launches": sum(o["launches"] for o in outs),
            "max_abs_err": max([shapes_err] + [o["max_abs_err"] for o in outs]),
            "ms": a["kernel_step_ms_median"],
            "plain_ms": a["plain_step_ms_median"],
            "bound_ms": max(a["bound_ms_bytes"], a["bound_ms_ops"]),
            "bound_by": "bytes" if a["bound_ms_bytes"] >= a["bound_ms_ops"]
            else "operations",
            "library_ms": None,
            "unit": f"one query_main step of {a['config']}: CUDA events "
                    f"around the kernels' launch call "
                    f"({a['launches_per_step']:g} launches)",
            "step_call_ms": a["step_call_ms_median"],
            "parity": "exact except f32 sums/avgs and stdDev (stated "
                      "tolerance)",
            "configs": {o["config"]: {k: o[k] for k in (
                "kernel_step_ms_median", "step_call_ms_median",
                "plain_step_ms_median", "launches", "checked_steps",
                "bound_ms_bytes", "bound_ms_ops", "max_abs_err")}
                for o in outs},
        })
    return entries


# --------------------------------------------------- stream-stream joins

def join_shapes_module():
    """``tests/test_torch_join_shapes.py``: the join shapes, wire, refusals
    and exact comparison of the CPU tests (it imports the port only)."""
    import importlib.util
    path = os.path.join(REPO, "tests", "test_torch_join_shapes.py")
    spec = importlib.util.spec_from_file_location("test_torch_join_shapes",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_join_shapes() -> None:
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
    from siddhi_tpu_torch.gpu.join_compile import (CompiledJoinQuery,
                                                   join_step_plain)
    from siddhi_tpu_torch.gpu.state_io import state_to_numpy
    sh = join_shapes_module()
    t_phase = time.perf_counter()
    cases = []
    for name in sorted(sh.JOINS):
        cq = sh.compile_port(name, "cuda")
        state = cq.init_state()
        wire = sh.wire_for(name)
        rows = 0
        for step in range(sh.STEPS):
            args = cq.batch_tensors(wire.batch(step))
            ref_state, ref_out = join_step_plain(cq, state, *args)
            state, out = cq.plan.step_cuda(state, *args)
            torch.cuda.synchronize()
            try:
                sh.compare(state_to_numpy(ref_state), state_to_numpy(state),
                           sh.out_numpy(state_to_numpy(ref_out)),
                           sh.out_numpy(state_to_numpy(out)))
            except AssertionError as e:
                fail(f"join shape {name} step {step}: kernel differs from "
                     f"the plain version: {str(e)[:400]}")
            rows += int(out["count"])
        cases.append({"join": name, "B": cq.B, "W": cq.W, "J": cq.J,
                      "rows": rows, "join_drops": int(state["join_drops"]),
                      "ring_drops": int(state["ring_drops"])})

    def build(text, B, W, J):
        app = parse(text)
        return CompiledJoinQuery(app.queries[0], dict(app.stream_definitions),
                                 B, W, J, device="cuda")

    for text in sh.REFUSED:
        try:
            build(sh.REFUSAL_SCHEMA + text, *sh.REFUSAL_CAPS)
            fail(f"the card accepted a join the reference refuses: {text}")
        except (DeviceCompileError, TypeError):
            pass
    for text, B, W, J in sh.LIMITS:
        try:
            build(text, B, W, J)
            fail(f"the card accepted a join over the kernel's limits: {text}")
        except DeviceCompileError as e:
            if not str(e).startswith("join kernel: "):
                fail(f"a join over the kernel's limits refused as {e}")
    emit({"phase": "join_shapes", "cases": cases, "refused": len(sh.REFUSED),
          "limits": len(sh.LIMITS), "max_abs_err": 0.0,
          "phase_s": time.perf_counter() - t_phase})


def join_step_bytes(state, new_state, cols, tag, ts, ts_base, out) -> int:
    """Bytes one step must move: the columns, tags and ts it reads, the old
    state it reads and the new state it writes, the J output rows."""
    def nb(ts_):
        return sum(t.numel() * t.element_size() for t in ts_)
    return nb((*cols.values(), tag, ts, ts_base)) + nb(state.values()) + \
        nb(new_state.values()) + nb((*out["out"].values(), *out["null"].values(),
                                     out["valid"], out["ts"], out["count"]))


def join_step_ops(cq, state, tag, ts, ts_base, nvalid: int, count: int) -> int:
    """Operations this step's data needs at the least: the condition's
    program and a window/within compare on every live candidate pair (a
    probe against the opposite side's entries alive at its time, in the ring
    and earlier in the batch), and the output programs on every row
    written. Dead ring slots cost nothing here: the rings are sorted by
    arrival, so a kernel could skip them by a binary search."""
    import torch
    a = cq.plan.args
    B, W = cq.B, cq.W
    per_pair = (a.cond.len if a.has_cond else 0) + 2
    per_row = sum(a.outp[o].len for o in range(a.nout)) + 2
    t = ts_base + ts.to(torch.int64)
    valid = torch.arange(B, device=ts.device) < nvalid
    emits = (bool(a.emit_left), bool(a.emit_right))
    live = 0
    for side in (0, 1):
        if not emits[side]:
            continue
        other = 1 - side
        probes = valid & (tag == side)
        opp = valid & (tag == other)
        before = (torch.cumsum(opp.to(torch.int64), 0) - opp.to(torch.int64))[probes]
        tp = t[probes]
        ring = state["lr_ts" if other == 0 else "rr_ts"]
        kind = a.lkind if other == 0 else a.rkind
        par = a.lparam if other == 0 else a.rparam
        if kind == 0:           # time: ring and batch entries with ts + D > t
            n_ring = W - torch.searchsorted(ring, tp - par, right=True)
            opp_ts = t[opp]
            n_batch = before - torch.searchsorted(opp_ts, tp - par, right=True)
        else:                   # length: the N newest arrivals before the probe
            filled = int((ring > -(2 ** 62)).sum())
            n_ring = torch.clamp(torch.clamp(par - before, min=0), max=filled)
            n_batch = torch.clamp(before, max=par)
        live += int(n_ring.clamp(min=0).sum()) + int(n_batch.clamp(min=0).sum())
    return live * per_pair + count * per_row


def phase_join_main(name: str, seed: int) -> dict:
    import torch
    from siddhi_tpu_torch.gpu.join_compile import (DeviceJoinRuntime,
                                                   join_step_plain)
    from siddhi_tpu_torch.gpu.join_step import JoinPlan
    from siddhi_tpu_torch.gpu.state_io import state_to_numpy
    from siddhi_tpu_torch.tools.join_workloads import (JOIN_MAIN, feed_join,
                                                       join_events,
                                                       reference_rows)
    sh = join_shapes_module()
    t_phase = time.perf_counter()
    cfg = dict(JOIN_MAIN[name])
    app = cfg.pop("app")
    B = cfg["batch_capacity"]
    ev = join_events(name, JOIN_EVENTS, seed)

    # warm-up: build, first launches
    rt = DeviceJoinRuntime(app, device="cuda", **cfg)
    feed_join(rt, ev, 3 * B)
    torch.cuda.synchronize()

    def event_pair():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    # ---- timed run: the entry points alone; CUDA events around the step
    # call (the wrapper's host work included) and around the kernels'
    # launch call alone (``lib.join_step``)
    rt = DeviceJoinRuntime(app, device="cuda", **cfg)
    cq = rt.compiler
    kstep = cq.step_tensors
    marks, kmarks = [], []

    def timed(*a):
        e0, e1 = event_pair()
        e0.record()
        got = kstep(*a)
        e1.record()
        marks.append((e0, e1))
        return got

    lib = cq.plan._lib()

    class TimedLib:
        def __getattr__(self, attr):
            if attr != "join_step":
                return getattr(lib, attr)

            def call(*a):
                e0, e1 = event_pair()
                e0.record()
                rc = lib.join_step(*a)
                e1.record()
                kmarks.append((e0, e1))
                return rc
            return call

    timed_lib = TimedLib()
    cq.plan._lib = lambda: timed_lib
    cq.step_tensors = timed
    torch.cuda.synchronize()
    JoinPlan.launches = 0                     # counts from here: main path
    t0 = time.perf_counter()
    rows, per_step = feed_join(rt, ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = JoinPlan.launches
    steps = len(marks)
    if launches != 4 * steps or launches == 0 or len(kmarks) != steps:
        fail(f"join_main {name}: {launches} join_step launches, "
             f"{len(kmarks)} kernel calls over {steps} steps")
    jd, rd = rt.drop_count, rt.ring_drop_count
    if jd or rd:
        fail(f"join_main {name}: {jd} join drops, {rd} ring drops")
    step_ms = [a.elapsed_time(b) for a, b in kmarks]
    call_ms = [a.elapsed_time(b) for a, b in marks]

    # the first 2 steps' rows against a nested-loop join in numpy
    want = reference_rows(name, ev, 2 * B)
    n2 = sum(per_step[:2])
    if rows[:n2] != want:
        bad = next((i for i, (x, y) in enumerate(zip(rows[:n2], want))
                    if x != y), min(n2, len(want)))
        fail(f"join_main {name}: the first 2 steps give {n2} rows, numpy "
             f"{len(want)}; first difference at row {bad}")

    # ---- checked run: every step bitwise against the plain version on the
    # card, from the same state; the bound from each step's own inputs
    rt = DeviceJoinRuntime(app, device="cuda", **cfg)
    cq = rt.compiler
    kstep = cq.step_tensors
    plain_ms, bytes_, ops = [], [], []

    def checked(state, cols, tag, ts, ts_base, nvalid):
        e0, e1 = event_pair()
        e0.record()
        ref_state, ref_out = join_step_plain(cq, state, cols, tag, ts,
                                             ts_base, nvalid)
        e1.record()
        new, out = kstep(state, cols, tag, ts, ts_base, nvalid)
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
        try:
            sh.compare(state_to_numpy(ref_state), state_to_numpy(new),
                       sh.out_numpy(state_to_numpy(ref_out)),
                       sh.out_numpy(state_to_numpy(out)))
        except AssertionError as e:
            fail(f"join_main {name} step {len(plain_ms)}: kernel differs "
                 f"from the plain version: {str(e)[:400]}")
        bytes_.append(join_step_bytes(state, new, cols, tag, ts, ts_base, out))
        ops.append(join_step_ops(cq, state, tag, ts, ts_base, nvalid,
                                 int(out["count"])))
        return new, out

    cq.step_tensors = checked
    rows2, _ = feed_join(rt, ev)
    if rows2 != rows:
        fail(f"join_main {name}: the checked run's rows differ from the "
             f"timed run's")
    b_ms = [b / HBM_BYTES_PER_S * 1e3 for b in bytes_]
    o_ms = [o / F32_OPS_PER_S * 1e3 for o in ops]
    out = {
        "phase": "join_main", "config": name, "kernel": "join_step",
        "events": JOIN_EVENTS, "steps": steps,
        "events_per_s": JOIN_EVENTS / wall, "wall_s": wall,
        "launches": launches, "launches_per_step": launches / steps,
        "kernel_step_ms_median": float(np.median(step_ms)),
        "kernel_step_ms_min": float(np.min(step_ms)),
        "kernel_step_ms_max": float(np.max(step_ms)),
        "step_call_ms_median": float(np.median(call_ms)),
        "plain_step_ms_median": float(np.median(plain_ms)),
        "plain_device": "cuda", "checked_steps": len(plain_ms),
        "checked": "every step", "bitwise_equal_steps": len(plain_ms),
        "rows": len(rows), "rows_per_step_median": float(np.median(per_step)),
        "numpy_rows_checked": n2, "join_drops": jd, "ring_drops": rd,
        "bytes_per_step_median": float(np.median(bytes_)),
        "ops_per_step_median": float(np.median(ops)),
        "bound_ms_bytes": float(np.median(b_ms)),
        "bound_ms_ops": float(np.median(o_ms)),
        "max_abs_err": 0.0, "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


JOIN_EVENTS = 2_000_000           # events per join_main configuration


def join_kernel_entry(j_outs: list) -> dict:
    """The ``kernels`` line's join entry: times and bound of (e), (f)
    beside it under ``configs``; launches over both main-path runs."""
    e = j_outs[0]
    return {
        "name": "join_step",
        "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/join_step.cu",
        "replaces": "siddhi_tpu/tpu/join_compile.py:224",
        "also_replaces": ["siddhi_tpu/tpu/join_compile.py:474"],
        "launches": sum(o["launches"] for o in j_outs),
        "max_abs_err": 0.0,
        "ms": e["kernel_step_ms_median"],
        "plain_ms": e["plain_step_ms_median"],
        "bound_ms": max(e["bound_ms_bytes"], e["bound_ms_ops"]),
        "bound_by": "bytes" if e["bound_ms_bytes"] >= e["bound_ms_ops"]
        else "operations",
        "library_ms": None,
        "unit": f"one join_main step of {e['config']}: CUDA events around "
                f"the kernels' launch call (4 launches)",
        "step_call_ms": e["step_call_ms_median"],
        "parity": "exact",
        "configs": {o["config"]: {k: o[k] for k in (
            "kernel_step_ms_median", "step_call_ms_median",
            "plain_step_ms_median", "launches", "checked_steps",
            "bound_ms_bytes", "bound_ms_ops", "events_per_s", "rows")}
            for o in j_outs},
    }


# ------------------------------------------------------------ aggregation

def agg_shapes_module():
    """``tests/test_torch_agg_shapes.py``: the aggregation shapes, wire,
    refusals and exact comparison of the CPU tests (it imports the port
    only)."""
    import importlib.util
    path = os.path.join(REPO, "tests", "test_torch_agg_shapes.py")
    spec = importlib.util.spec_from_file_location("test_torch_agg_shapes",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_agg_shapes() -> None:
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.gpu.aggregation_compile import (
        CompiledAggregation, aggregation_step_plain)
    from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
    sh = agg_shapes_module()
    t_phase = time.perf_counter()
    cases = []
    for name in sorted(sh.AGGS):
        ca = sh.compile_port(name, "cuda")
        wire = sh.wire_for(name)
        runs = 0
        for step in range(sh.STEPS):
            args = sh.step_inputs(ca, wire.batch(step))
            ref = aggregation_step_plain(ca, *args)
            got, _ = ca.plan.step_cuda(*args)
            torch.cuda.synchronize()
            same, _, bad = compare(ref, got)
            if not same:
                fail(f"aggregation shape {name} step {step}: kernel differs "
                     f"from the plain version at {bad}")
            runs += int(got["n_runs"].sum())
        cases.append({"agg": name, "B": ca.B, "D": ca.D, "partial_rows": runs})

    def build(text, B):
        d, sdef = sh.definition(parse, text)
        return CompiledAggregation(d, sdef, B, device="cuda")

    for text in sh.REFUSED:
        try:
            build(sh.SCHEMA + "define aggregation A " + text, sh.REFUSAL_B)
            fail(f"the card accepted a definition the reference refuses: {text}")
        except DeviceCompileError:
            pass
    for text, B in sh.LIMITS:
        try:
            build(text, B)
            fail(f"the card accepted a definition over the kernel's limits: "
                 f"{text[:80]}")
        except DeviceCompileError as e:
            if not str(e).startswith("aggregation kernel: "):
                fail(f"a definition over the kernel's limits refused as {e}")
    emit({"phase": "agg_shapes", "cases": cases, "refused": len(sh.REFUSED),
          "limits": len(sh.LIMITS), "max_abs_err": 0.0,
          "phase_s": time.perf_counter() - t_phase})


AGG_EVENTS = 2_000_000            # events per agg_main configuration


def agg_step_bytes(ca, cols, ts, buckets, valid) -> int:
    """Bytes one step must move: the columns it reads, the clock where a
    program reads it, the valid mask and the [D, B] slab once, and every
    output lane once."""
    nb = sum(t.numel() * t.element_size() for t in (*cols.values(), buckets,
                                                    valid))
    if ca.plan.ts_slot is not None:
        nb += ts.numel() * ts.element_size()
    return nb + ca.plan.out_bytes


def agg_step_ops(ca, n_accepted: int) -> int:
    """Operations this step's data needs at the least: a comparison sort of
    the B events per duration (B * ceil(log2 B) compares), one combine per
    accepted event, duration and accumulating lane (three for a stdDev lane:
    add, square, add), and the filter and argument programs once per
    event."""
    import math
    from siddhi_tpu_torch.gpu.aggregation_step import LANE
    a = ca.plan.args
    B, D = ca.B, ca.D
    combines = {LANE["int"]: 1, LANE["f64"]: 1, LANE["f64sq"]: 3,
                LANE["min"]: 1, LANE["max"]: 1}
    lanes = sum(combines.get(a.lane[k], 0) for k in range(a.S))
    progs = (a.filt.len if a.has_filter else 0) + \
        sum(a.prog[k].len for k in range(a.S))
    return D * B * max(1, math.ceil(math.log2(B))) + \
        D * n_accepted * lanes + B * progs


def phase_agg_main(name: str, seed: int) -> dict:
    import torch
    from siddhi_tpu_torch.gpu.aggregation_compile import aggregation_step_plain
    from siddhi_tpu_torch.gpu.aggregation_step import AggPlan
    from siddhi_tpu_torch.tools import agg_workloads as aw
    t_phase = time.perf_counter()
    ev = aw.agg_events(name, AGG_EVENTS, seed)
    want = aw.numpy_rollup(name, ev)

    def all_rows(rt):
        return {d.value: rt.rows_for(d) for d in rt.definition.durations}

    # warm-up: build, first launches
    rt = aw.build_runtime(name, device="cuda")
    aw.feed_columns(rt, ev, 3 * aw.BATCH)
    all_rows(rt)
    torch.cuda.synchronize()

    def event_pair():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    # ---- timed run: bulk staging (append_columns + _flush_device) and the
    # final reads; CUDA events around the step call (copies both ways and
    # the wrapper's host work included) and around the kernels' launch call
    # alone (``lib.aggregation_step``)
    rt = aw.build_runtime(name, device="cuda")
    ca = rt._dev
    kstep = ca.step
    marks, kmarks = [], []

    def timed(*a):
        e0, e1 = event_pair()
        e0.record()
        got = kstep(*a)
        e1.record()
        marks.append((e0, e1))
        return got

    lib = ca.plan._lib()

    class TimedLib:
        def __getattr__(self, attr):
            if attr != "aggregation_step":
                return getattr(lib, attr)

            def call(*a):
                e0, e1 = event_pair()
                e0.record()
                rc = lib.aggregation_step(*a)
                e1.record()
                kmarks.append((e0, e1))
                return rc
            return call

    timed_lib = TimedLib()
    ca.plan._lib = lambda: timed_lib
    ca.step = timed
    torch.cuda.synchronize()
    AggPlan.launches = 0                      # counts from here: main path
    t0 = time.perf_counter()
    aw.feed_columns(rt, ev)
    rows = all_rows(rt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = AggPlan.launches
    steps = len(marks)
    if launches != 4 * steps or launches == 0 or len(kmarks) != steps:
        fail(f"agg_main {name}: {launches} aggregation_step launches, "
             f"{len(kmarks)} kernel calls over {steps} steps")
    step_ms = [a.elapsed_time(b) for a, b in kmarks]
    call_ms = [a.elapsed_time(b) for a, b in marks]

    # ---- checked run: every event through receive(); every step bitwise
    # against the plain version on the card, from the same tensors; the
    # bound from each step's own inputs
    rt2 = aw.build_runtime(name, device="cuda")
    ca2 = rt2._dev
    plain_ms, bytes_, ops, partial = [], [], [], []

    def checked(cols, ts, buckets, valid):
        args = ca2.tensors(cols, ts, buckets, valid)
        e0, e1 = event_pair()
        e0.record()
        ref = aggregation_step_plain(ca2, *args)
        e1.record()
        out, buf = ca2.plan.step_cuda(*args)
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
        same, _, bad = compare(ref, out)
        if not same:
            fail(f"agg_main {name} step {len(plain_ms)}: kernel differs from "
                 f"the plain version at {bad}")
        bytes_.append(agg_step_bytes(ca2, *args))
        ops.append(agg_step_ops(ca2, int(out["count"][0].sum())))
        partial.append(int(out["n_runs"].sum()))
        return ca2.plan.unpack(buf.cpu().numpy())

    ca2.step = checked
    t1 = time.perf_counter()
    aw.feed_events(rt2, ev)
    rows2 = all_rows(rt2)
    wall2 = time.perf_counter() - t1
    for d in rows:
        if sorted(rows2[d]) != sorted(rows[d]):
            fail(f"agg_main {name}: {d} rows of the receive() run differ from "
                 f"the bulk-staged run's")
    try:
        counts = aw.check_rows(name, rt2, want)
    except AssertionError as e:
        fail(f"agg_main {name}: rows differ from the numpy group-by: "
             f"{str(e)[:400]}")
    b_ms = [b / HBM_BYTES_PER_S * 1e3 for b in bytes_]
    o_ms = [o / F32_OPS_PER_S * 1e3 for o in ops]
    out = {
        "phase": "agg_main", "config": name, "kernel": "aggregation_step",
        "events": AGG_EVENTS, "steps": steps, "D": ca.D, "B": ca.B,
        "events_per_s": AGG_EVENTS / wall, "wall_s": wall,
        "receive_events_per_s": AGG_EVENTS / wall2,
        "launches": launches, "launches_per_step": launches / steps,
        "kernel_step_ms_median": float(np.median(step_ms)),
        "kernel_step_ms_min": float(np.min(step_ms)),
        "kernel_step_ms_max": float(np.max(step_ms)),
        "step_call_ms_median": float(np.median(call_ms)),
        "plain_step_ms_median": float(np.median(plain_ms)),
        "plain_device": "cuda", "checked_steps": len(plain_ms),
        "checked": "every step", "bitwise_equal_steps": len(plain_ms),
        "partial_rows_per_step_median": float(np.median(partial)),
        "rows_per_duration": counts, "numpy_groupby": "every row",
        "bytes_per_step_median": float(np.median(bytes_)),
        "ops_per_step_median": float(np.median(ops)),
        "bound_ms_bytes": float(np.median(b_ms)),
        "bound_ms_ops": float(np.median(o_ms)),
        "max_abs_err": 0.0, "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


def agg_kernel_entry(a_outs: list) -> dict:
    """The ``kernels`` line's aggregation entry: times and bound of (g),
    (h) beside it under ``configs``; launches over both main-path runs."""
    e = a_outs[0]
    return {
        "name": "aggregation_step",
        "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/aggregation_step.cu",
        "replaces": "siddhi_tpu/tpu/aggregation_compile.py:129",
        "launches": sum(o["launches"] for o in a_outs),
        "max_abs_err": 0.0,
        "ms": e["kernel_step_ms_median"],
        "plain_ms": e["plain_step_ms_median"],
        "bound_ms": max(e["bound_ms_bytes"], e["bound_ms_ops"]),
        "bound_by": "bytes" if e["bound_ms_bytes"] >= e["bound_ms_ops"]
        else "operations",
        "library_ms": None,
        "unit": f"one agg_main step of {e['config']}: CUDA events around "
                f"the kernels' launch call (4 launches)",
        "step_call_ms": e["step_call_ms_median"],
        "parity": "exact",
        "configs": {o["config"]: {k: o[k] for k in (
            "kernel_step_ms_median", "step_call_ms_median",
            "plain_step_ms_median", "launches", "checked_steps",
            "bound_ms_bytes", "bound_ms_ops", "events_per_s",
            "partial_rows_per_step_median")}
            for o in a_outs},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--events", type=int, default=2_000_000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    from siddhi_tpu_torch.tools.agg_workloads import AGG_MAIN
    from siddhi_tpu_torch.tools.join_workloads import JOIN_MAIN
    from siddhi_tpu_torch.tools.query_workloads import QUERY_MAIN
    card = phase_device()
    shape_err = phase_shapes(args.seed)
    main_out = phase_main(args.seed, args.events)
    scan_err = phase_scan_shapes(args.seed)
    scan_out = phase_scan_main(args.seed, SCAN_EVENTS)
    query_err = phase_query_shapes()
    q_outs = [phase_query_main(name, args.seed) for name in QUERY_MAIN]
    phase_join_shapes()
    j_outs = [phase_join_main(name, args.seed) for name in JOIN_MAIN]
    phase_agg_shapes()
    a_outs = [phase_agg_main(name, args.seed) for name in AGG_MAIN]
    bound = max(main_out["bound_ms_bytes"], main_out["bound_ms_ops"])
    scan_bound = max(scan_out["bound_ms_bytes"], scan_out["bound_ms_ops"])
    kernels = [{
        "name": "nfa_block_stage",
        "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_block.cu",
        "replaces": "siddhi_tpu/tpu/nfa_block.py:110",
        "also_replaces": ["siddhi_tpu/tpu/expr_compile.py:121",
                          "siddhi_tpu/tpu/partition.py:160"],
        "launches": main_out["launches"],
        "max_abs_err": max(shape_err, main_out["max_abs_err"]),
        "ms": main_out["kernel_step_ms_median"],
        "plain_ms": main_out["plain_step_ms_median"],
        "bound_ms": bound,
        "bound_by": "bytes" if main_out["bound_ms_bytes"] >= main_out["bound_ms_ops"]
        else "operations",
        "library_ms": None,
        "unit": "one main-path step (S-1 = 7 launches)",
        "parity": "exact",
    }, {
        "name": "nfa_scan_step",
        "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_scan.cu",
        "replaces": "siddhi_tpu/tpu/nfa.py:829",
        "also_replaces": ["siddhi_tpu/tpu/partition.py:160"],
        "launches": scan_out["launches"],
        "max_abs_err": max(scan_err, scan_out["max_abs_err"]),
        "ms": scan_out["kernel_step_ms_median"],
        "plain_ms": scan_out["plain_step_ms_median"],
        "bound_ms": scan_bound,
        "bound_by": "bytes" if scan_out["bound_ms_bytes"] >= scan_out["bound_ms_ops"]
        else "operations",
        "library_ms": None,
        "unit": "one scan_main step (1 launch, ys zeroed in it)",
        "parity": "exact",
        "checked_steps": scan_out["checked_steps"],
    }, *query_kernel_entries(q_outs, query_err), join_kernel_entry(j_outs),
        agg_kernel_entry(a_outs)]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
