"""The incremental-aggregation shapes, wire batches and refusals shared by
the aggregation tests.

``tests/test_torch_agg_compile.py`` runs every shape through the JAX
package's ``CompiledAggregation.step`` and the port's; ``chip_smoke.py``
(phase ``agg_shapes``) and the ``cuda``-marked tests below run the kernel
(``csrc/aggregation_step.cu``) against the plain version on the card. This
module imports only the port, never the JAX package, so the chip script can
load it where JAX is not installed (``python -m pytest
tests/test_torch_agg_shapes.py -m cuda`` runs the kernel cases there).

Tolerance: none. Every key of the step's tree, every ``[D, B]`` position
(the rejected runs' and the empty segments' past ``n_runs`` too) and
``n_runs`` must be equal, NaN equal to NaN: the f64 sums add in the same
sorted order from 0.0 on every side, and min/max and the gathers are exact.
"""

import numpy as np
import pytest
import torch

from siddhi_tpu_torch.compiler import parse
from siddhi_tpu_torch.gpu.aggregation_compile import (CompiledAggregation,
                                                      aggregation_step_plain)
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError

SCHEMA = ("define stream S (sym string, dev string, room int, price double, "
          "vol long, qty int, f float, ets long);\n")

# 2023-12-31 23:58:00 UTC: months and years roll over within the first steps
BASE_TS = 1_704_067_080_000

# name → (definition body after "define aggregation A", B, ts step range ms)
AGGS = {
    "all_durations": ("""
from S select sym, sum(price) as t, count() as c, avg(price) as ap,
  min(price) as lo, max(price) as hi, stdDev(price) as sd
group by sym aggregate every sec...year;""", 64, (0, 4_000_000)),
    "months_years": ("""
from S select sym, sum(vol) as t, count() as c, max(qty) as hi
group by sym aggregate every month...year;""", 32, (0, 20 * 86_400_000)),
    "no_group": ("""
from S select sum(price) as t, count() as c, avg(vol) as av, min(f) as lo
aggregate every sec...min;""", 64, (0, 700)),
    "string_key": ("""
from S select sym, sum(price) as t, count() as c
group by sym aggregate every sec...hour;""", 64, (0, 200)),
    "int_string_keys": ("""
from S select room, dev, avg(price) as ap, min(price) as lo,
  max(price) as hi, stdDev(price) as sd, count() as n
group by room, dev aggregate every sec...hour;""", 64, (0, 300)),
    "long_key": ("""
from S select vol, sum(qty) as t, avg(f) as af, count() as c
group by vol aggregate every sec...min;""", 48, (0, 500)),
    "filter_rejects": ("""
from S[price > 20.0 and qty != 0] select sym, sum(price) as t, count() as c,
  max(vol) as hi
group by sym aggregate every sec...day;""", 64, (0, 900)),
    "two_filters": ("""
from S[qty > 0][room < 3] select room, sum(vol) as t, count() as c
group by room aggregate every sec...min;""", 32, (0, 900)),
    "arg_types": ("""
from S select sym,
  sum(qty) as si, sum(vol) as sl, sum(f) as sf, sum(price) as sd,
  avg(qty) as ai, avg(vol) as al, avg(f) as af, avg(price) as ad,
  min(qty) as ni, min(vol) as nl, min(f) as nf, min(price) as nd,
  max(qty) as xi, max(vol) as xl, max(f) as xf, max(price) as xd,
  stdDev(qty) as di, stdDev(vol) as dl, stdDev(f) as df, stdDev(price) as dd,
  sum(price * qty) as pv, count(vol) as cv
group by sym aggregate every sec...min;""", 64, (0, 400)),
    "value_projection": ("""
from S select sym, price, price * qty as pq, qty > 2 as big, dev,
  sum(price) as t
group by sym aggregate every sec...min;""", 64, (0, 300)),
    "event_ts": ("""
from S[eventTimestamp() % 3 != 0] select sym, eventTimestamp() % 1000 as ems,
  max(eventTimestamp()) as last_ts, sum(eventTimestamp() % 7) as s7
group by sym aggregate every sec...min;""", 64, (0, 400)),
    "aggregate_by": ("""
from S select sym, sum(price) as t, count() as c, eventTimestamp() % 100 as e
group by sym aggregate by ets every sec...hour;""", 64, (0, 50)),
    "nonfinite": ("""
from S select sym, sum(price) as t, avg(f) as af, min(price) as lo,
  max(price) as hi, min(f) as flo, stdDev(price) as sd
group by sym aggregate every sec...min;""", 64, (0, 300)),
    "long_run": ("""
from S select sum(price) as t, count() as c, stdDev(price) as sd,
  min(price) as lo, sum(vol) as sv
aggregate every sec...year;""", 512, (0, 3)),
    "count_only": ("""
from S select count() as n group by dev aggregate every sec;""", 16, (0, 400)),
}
STEPS = 5
# the valid prefix per step: a random count, then full, then empty
COUNT_RULE = ("random", "full", "random", "empty", "random")

# definitions the reference refuses (DeviceCompileError): the port refuses
# them with its class and the same message
REFUSED = [
    "from S#window.length(5) select sum(price) as t aggregate every sec;",
    "from S#log() select sum(price) as t aggregate every sec;",
    "from S select sym, sum(price) as t group by price aggregate every sec;",
    "from S select sum(sym) as t aggregate every sec;",
    "from S select sum(price > 2.0) as t aggregate every sec;",
    "from S select sum() as t aggregate every sec;",
    "from S select min() as t aggregate every sec;",
    "from S select sym, distinctCount(vol) as d group by sym "
    "aggregate every sec;",
    "from S select maxForever(price) as m aggregate every sec;",
    "from S select eventTimestamp() as e aggregate every sec;",
    "from S[zz > 1] select sum(price) as t aggregate every sec;",
    "from S select sum(zz) as t aggregate every sec;",
    "from S[sym > 'a'] select sum(price) as t aggregate every sec;",
    "from S select sum(vol * price) as t aggregate every sec;",
]
REFUSAL_B = 16

# definitions the reference accepts and the kernel's limits refuse, at
# construction, on every device: (schema + definition, B)
_WIDE = ", ".join(f"a{i} int" for i in range(33))
_KEYS = ", ".join(f"k{i}" for i in range(9))
_DEEP = "v" + " + (v" * 33 + ")" * 33
LIMITS = [
    (f"define stream W ({_WIDE});\ndefine aggregation A from W["
     + " + ".join(f"a{i}" for i in range(33)) + " > 0] "
     "select count() as c aggregate every sec;", 16),
    ("define stream W (" + ", ".join(f"k{i} int" for i in range(9))
     + ", v double);\ndefine aggregation A from W select sum(v) as t "
     f"group by {_KEYS} aggregate every sec;", 16),
    ("define stream W (v double);\ndefine aggregation A from W select "
     + ", ".join(f"sum(v) as s{i}" for i in range(33))
     + " aggregate every sec;", 16),
    ("define stream W (v long);\ndefine aggregation A from W select "
     f"sum({_DEEP}) as t aggregate every sec;", 16),
    (SCHEMA + "define aggregation A from S select sum(price) as t "
     "aggregate every sec;", (1 << 16) + 1),
    (SCHEMA + "define aggregation A from S select sum(price) as t "
     "aggregate every sec;", 0),
]


def app_text(name: str) -> str:
    return SCHEMA + "define aggregation A " + AGGS[name][0]


def definition(parse_fn, text: str):
    app = parse_fn(text)
    d = app.aggregation_definitions["A"]
    sid = d.basic_single_input_stream.stream_id
    return d, app.stream_definitions[sid]


def compile_port(name: str, device) -> CompiledAggregation:
    d, sdef = definition(parse, app_text(name))
    return CompiledAggregation(d, sdef, AGGS[name][1], device=device)


class AggWire:
    """Seeded staged batches (``BatchBuilder.emit()`` layout) over
    ``SCHEMA``: a valid prefix by ``COUNT_RULE``, stale values past it,
    timestamps rising by the shape's step range from ``BASE_TS`` (so the
    calendar rolls over), and the bucketing clock: ``ts``, or the ``ets``
    column (out of order) for ``aggregate by ets``."""

    def __init__(self, name: str, seed: int = 7):
        self.name = name
        self.B = AGGS[name][1]
        self.lo, self.hi = AGGS[name][2]
        self.rng = np.random.default_rng(seed)
        self.ts = BASE_TS

    def batch(self, step: int) -> dict:
        rng, B = self.rng, self.B
        rule = COUNT_RULE[step % len(COUNT_RULE)]
        count = B if rule == "full" else 0 if rule == "empty" else \
            int(rng.integers(1, B))
        price = np.round(rng.uniform(0, 50, B), 2).astype(np.float32)
        f = np.round(rng.uniform(-5, 5, B), 1).astype(np.float32)
        if self.name == "nonfinite":
            for arr in (price, f):
                k = rng.integers(0, B, 6)
                arr[k[:2]] = np.nan
                arr[k[2:4]] = np.inf
                arr[k[4:]] = -np.inf
        ts = self.ts + np.cumsum(rng.integers(self.lo, self.hi + 1, B))
        cols = {
            "sym": rng.integers(1, 5, B).astype(np.int32),
            "dev": rng.integers(1, 4, B).astype(np.int32),
            "room": rng.integers(0, 4, B).astype(np.int32),
            "price": price,
            "vol": rng.integers(-3, 9, B).astype(np.int64) * 1_000_000_007,
            "qty": rng.integers(-2, 6, B).astype(np.int32),
            "f": f,
            "ets": (ts - rng.integers(0, 5_000, B)).astype(np.int64),
        }
        if count:
            self.ts = int(ts[count - 1])
        clock = cols["ets"] if self.name == "aggregate_by" else ts
        return {"cols": cols, "ts": clock.astype(np.int64),
                "valid": np.arange(B) < count, "count": count}


def wire_for(name: str) -> AggWire:
    return AggWire(name)


def _same(tag, ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.dtype == got.dtype and ref.shape == got.shape, \
        (tag, ref.dtype, got.dtype, ref.shape, got.shape)
    same = ref == got
    if ref.dtype.kind == "f":
        same |= np.isnan(ref) & np.isnan(got)
    assert same.all(), (tag, np.argwhere(~same)[:8].tolist(),
                        ref[~same][:8], got[~same][:8])


def compare(ref: dict, got: dict):
    """Exact comparison of two step outputs (numpy trees)."""
    assert set(ref) == set(got), set(ref) ^ set(got)
    for k in sorted(ref):
        _same(k, ref[k], got[k])


def as_numpy(out: dict) -> dict:
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def step_inputs(ca: CompiledAggregation, batch: dict, device=None):
    """A wire batch → the step's tensors (the slab from ``bucket_slab``)."""
    return ca.tensors(batch["cols"], batch["ts"], ca.bucket_slab(batch["ts"]),
                      batch["valid"], device)


@pytest.mark.parametrize("name", sorted(AGGS))
def test_every_definition_links_its_kernel_programs(name):
    ca = compile_port(name, "cpu")
    a = ca.plan.args
    assert a.S == len(ca.specs) and a.G == len(ca.group_cols)
    assert a.has_filter == bool(ca.filter_irs)
    assert ca.plan.code_host.shape[1] == 4


@pytest.mark.parametrize("name", sorted(AGGS))
def test_plain_step_matches_a_python_groupby(name):
    """The first ``n_runs`` rows of each duration are the accepted events
    grouped by (bucket, key) in the reference's order: count and int64 sums
    exact, f64 sums within 1e-9 of math.fsum's, min/max exact; the rows
    past ``n_runs`` carry no accepted event."""
    import math
    ca = compile_port(name, "cpu")
    wire = wire_for(name)
    for step in range(STEPS):
        batch = wire.batch(step)
        cols, ts, buckets, valid = step_inputs(ca, batch)
        out = as_numpy(aggregation_step_plain(ca, cols, ts, buckets, valid))
        env = {**cols, "__ts__": ts, "__device__": ts.device}
        mask = valid.clone()
        for fn in ca.filter_fns:
            mask &= torch.as_tensor(fn(env)).bool()
        mask = mask.numpy()
        keys = [cols[n].numpy() for n, _ in ca.group_cols]
        for d in range(ca.D):
            groups: dict = {}
            for i in np.flatnonzero(mask):
                k = (int(buckets[d, i]), *[int(kc[i]) for kc in keys[::-1]])
                groups.setdefault(k, []).append(i)
            n = int(out["n_runs"][d])
            assert n == len(groups)
            assert out["count"][d, n:].sum() == 0
            for r, k in enumerate(sorted(groups)):
                idx = groups[k]
                assert out["bucket"][d, r] == k[0]
                assert out["count"][d, r] == len(idx)
                for g, (gname, _t) in enumerate(ca.group_cols):
                    assert out[f"g_{gname}"][d, r] == cols[gname][idx[0]]
                for s in ca.specs:
                    nm, kind = s["name"], s["kind"]
                    if kind in ("value", "count"):
                        continue
                    v = s["fn"](env).numpy()[idx]
                    if kind in ("min", "max"):
                        want = (np.nan if np.isnan(v).any() else
                                (v.min() if kind == "min" else v.max()))
                        _same(f"m_{nm}", np.array(want, v.dtype),
                              out[f"m_{nm}"][d, r])
                    elif out[f"sum_{nm}"].dtype == np.int64:
                        assert out[f"sum_{nm}"][d, r] == int(v.astype(np.int64).sum())
                    elif np.isfinite(v).all():
                        want = math.fsum(v.astype(np.float64))
                        assert out[f"sum_{nm}"][d, r] == pytest.approx(
                            want, rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("name", sorted(AGGS))
def test_plain_step_outputs_follow_the_layout(name):
    """Keys, dtypes and shapes are the kernel layout's; ``step`` on the CPU
    returns numpy equal to the plain tensors."""
    ca = compile_port(name, "cpu")
    wire = wire_for(name)
    batch = wire.batch(0)
    out = aggregation_step_plain(ca, *step_inputs(ca, batch))
    layout = {k: (dt, shape) for k, dt, shape, _, _ in ca.plan.layout}
    assert set(out) == set(layout)
    for k, v in out.items():
        assert (v.dtype, tuple(v.shape)) == (layout[k][0], layout[k][1]), k
    compare(as_numpy(out), ca.step(batch["cols"], batch["ts"],
                                   ca.bucket_slab(batch["ts"]), batch["valid"]))


def test_long_run_is_one_run_of_b_events():
    ca = compile_port("long_run", "cpu")
    wire = wire_for("long_run")
    wire.batch(0)
    batch = wire.batch(1)                       # full: B events
    out = as_numpy(aggregation_step_plain(ca, *step_inputs(ca, batch)))
    years = ca.D - 1
    assert out["n_runs"][years] == 1 and out["count"][years, 0] == ca.B


@pytest.mark.parametrize("text", REFUSED)
def test_refusals_raise_device_compile_error(text):
    d, sdef = definition(parse, SCHEMA + "define aggregation A " + text)
    with pytest.raises(DeviceCompileError):
        CompiledAggregation(d, sdef, REFUSAL_B, device="cpu")


@pytest.mark.parametrize("i", range(len(LIMITS)))
def test_kernel_limits_refuse_at_construction(i):
    text, B = LIMITS[i]
    d, sdef = definition(parse, text)
    with pytest.raises(DeviceCompileError, match="^aggregation kernel: "):
        CompiledAggregation(d, sdef, B, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(AGGS))
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ca = compile_port(name, "cuda")
    wire = wire_for(name)
    for step in range(STEPS):
        args = step_inputs(ca, wire.batch(step))
        ref = aggregation_step_plain(ca, *args)
        got, _ = ca.plan.step_cuda(*args)
        torch.cuda.synchronize()
        compare(as_numpy(ref), as_numpy(got))
