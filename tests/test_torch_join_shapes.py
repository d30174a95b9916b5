"""The stream-stream join shapes, wire batches and refusals shared by the
join tests.

``tests/test_torch_join_compile.py`` runs every shape through the JAX
package's ``CompiledJoinQuery`` and the port's ``join_step_plain``;
``chip_smoke.py`` (phase ``join_shapes``) and the ``cuda``-marked tests
below run the kernel (``csrc/join_step.cu``) against the plain version on
the card. This module imports only the port, never the JAX package, so the
chip script can load it where JAX is not installed (``python -m pytest
tests/test_torch_join_shapes.py -m cuda`` runs the kernel cases there).

Tolerance: none. Every state leaf (both rings, their timestamps, the 0-d
``join_drops`` and ``ring_drops``), every output position (the masked-off
rows past ``count`` too, which hold probe 0 against ring slot 0), the null
masks, ``valid``, ``ts`` and ``count`` must be equal, NaN equal to NaN: no
shape's output applies a math function, and every float operation the
outputs and conditions make (f32 add, multiply, compare) is correctly
rounded on both sides.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from siddhi_tpu_torch.compiler import parse
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
from siddhi_tpu_torch.gpu.join_compile import CompiledJoinQuery, join_step_plain
from siddhi_tpu_torch.gpu.join_step import NB
from siddhi_tpu_torch.gpu.state_io import state_from_numpy, state_to_numpy

SCHEMA = """
define stream L (k string, v long, x double, n int, f float, b bool);
define stream R (k string, v long, x double, n int, f float, b bool);
"""

# name → (query, B, W, J)
JOINS = {
    "time_time": ("""
from L#window.time(40) join R#window.time(60)
  on L.k == R.k and R.x < L.x
select L.k as k, L.x as lx, R.x as rx, L.v + R.v as vs insert into O;""",
                  16, 32, 256),
    "length_length": ("""
from L#window.length(5) join R#window.length(3) on L.k == R.k
select L.v as lv, R.v as rv, R.n * L.n as nn insert into O;""", 16, 8, 256),
    "mixed": ("""
from L#window.time(50) join R#window.length(4) on L.n == R.n
select L.x as lx, R.f as rf, R.b as rb insert into O;""", 16, 16, 256),
    "mixed_swapped": ("""
from L#window.length(6) as a join R#window.time(30) as b
  on a.k == b.k and a.v < b.v
select a.v as av, b.v as bv, b.k as bk insert into O;""", 5, 8, 64),
    "left_outer": ("""
from L#window.time(30) left outer join R#window.time(30) on L.k == R.k
select L.v as lv, R.v as rv, R.k as rk, R.b as rb insert into O;""",
                   16, 32, 256),
    "right_outer": ("""
from L#window.length(3) right outer join R#window.length(2)
  on L.k == R.k and L.f > R.f
select L.k as lk, L.f as lf, R.f as rf, R.n as rn insert into O;""",
                    16, 8, 256),
    "full_outer": ("""
from L#window.length(3) full outer join R#window.time(25)
  on L.k == R.k and L.b
select L.v as lv, R.v as rv, L.x + R.x as sx insert into O;""", 16, 16, 256),
    "uni_left": ("""
from L#window.length(4) unidirectional join R#window.length(4) on L.k == R.k
select L.v as lv, R.v as rv insert into O;""", 16, 8, 256),
    "uni_right_outer": ("""
from L#window.time(45) full outer join R#window.time(45) unidirectional
  on L.k == R.k
select L.n as ln, R.n as rn, R.k as rk insert into O;""", 16, 32, 256),
    "within": ("""
from L#window.time(500) join R#window.time(500) on L.k == R.k within 12
select L.v as lv, R.v as rv insert into O;""", 16, 64, 512),
    "types": ("""
from L#window.length(4) join R#window.length(4) on L.n == R.v and R.b != L.b
select L.k as k, L.n as n, L.v as v, L.f as f, R.x as x, R.b as b,
       L.f * 2.0 as f2, R.n > L.n as gt, R.k == 'b' as rb insert into O;""",
              16, 8, 256),
    "event_ts": ("""
from L#window.time(60) join R#window.time(60)
  on L.k == R.k and eventTimestamp() % 3 == 0
select eventTimestamp() as et, L.v as lv, R.v as rv insert into O;""",
                 16, 32, 256),
    "div_zero": ("""
from L#window.length(3) join R#window.length(3) on L.k != R.k
select L.v / R.n as q, L.n % R.n as m, R.x / L.x as fq insert into O;""",
                 16, 8, 256),
    "no_condition": ("""
from L#window.length(2) join R#window.length(2)
select L.v as lv, R.v as rv, 1 as one, 2.5 as h insert into O;""", 8, 4, 64),
    "string_const": ("""
from L#window.time(40) left outer join R#window.length(5)
  on L.k == R.k and R.k != 'b'
select R.k as rk, L.k as lk, L.b and R.b as both insert into O;""",
                     16, 16, 256),
    # capacity pressure: joined rows past J (join_drops), a time ring too
    # small for its live entries (ring_drops), more arrivals of a side in
    # one batch than ring slots (k > W: the oldest arrivals are lost
    # uncounted, as in the reference)
    "join_overflow": ("""
from L#window.length(8) join R#window.length(8) on L.b == R.b
select L.v as lv, R.v as rv insert into O;""", 16, 8, 12),
    "ring_overflow": ("""
from L#window.time(1000) join R#window.time(1000) on L.k == R.k
select L.v as lv, R.v as rv insert into O;""", 32, 4, 512),
    "k_gt_w_length": ("""
from L#window.length(3) full outer join R#window.length(2) on L.n == R.n
select L.v as lv, R.v as rv insert into O;""", 16, 4, 256),
    "wide_batch": ("""
from L#window.time(80) join R#window.time(80) on L.k == R.k and L.x > R.x
select L.x as lx, R.x as rx, R.v - L.v as dv insert into O;""", 64, 96, 2048),
    # the key index (csrc/join_step.cu j_index): an equality conjunct on
    # INT, LONG, BOOL or string attributes, keys drawn from KEY_POOL (many
    # keys to one bucket) by WIRE_OPTIONS
    "key_int": ("""
from L#window.time(40) join R#window.length(6) on L.n == R.n
select L.n as ln, R.n as rn, L.v as lv, R.v as rv insert into O;""",
                16, 32, 256),
    "key_long": ("""
from L#window.length(7) left outer join R#window.time(50) on L.v == R.v
select L.v as lv, R.v as rv, R.k as rk insert into O;""", 16, 32, 256),
    "key_bool": ("""
from L#window.time(30) full outer join R#window.time(30)
  on L.b == R.b and L.x > R.x
select L.b as lb, R.b as rb, L.x as lx, R.x as rx insert into O;""",
                 16, 32, 512),
    "key_string": ("""
from L#window.length(5) join R#window.length(5) on L.k == R.k
select L.k as lk, R.k as rk, L.n + R.n as nn insert into O;""", 16, 16, 256),
    "key_second": ("""
from L#window.time(40) join R#window.time(40) on L.x < R.x + 20.0 and L.v == R.n
select L.v as lv, R.n as rn, L.x as lx, R.x as rx insert into O;""",
                   16, 32, 256),
    "key_under_or": ("""
from L#window.time(40) join R#window.time(40) on L.k == R.k or L.v < R.v
select L.v as lv, R.v as rv insert into O;""", 16, 32, 512),
    "key_decreasing": ("""
from L#window.time(30) join R#window.time(45) on L.n == R.n
select L.n as ln, R.v as rv, eventTimestamp() as et insert into O;""",
                       16, 32, 256),
    "key_overflow": ("""
from L#window.length(8) join R#window.length(8) on L.n == R.n
select L.v as lv, R.v as rv insert into O;""", 16, 8, 10),
}
STEPS = 6
# the share of right-side events per step (one side empty at steps 1, 2)
RIGHT_SHARE = (0.5, 0.0, 1.0, 0.5, 0.2, 0.8)

# queries the reference refuses: the port refuses them with its exception
# and message (DeviceCompileError; TypeError for a window parameter or a
# within that is not a constant, as in the reference)
REFUSAL_SCHEMA = SCHEMA + "define stream S (v long);\n" \
    "define table T (k string, v long);\n"
REFUSED = [
    "from S select v insert into O;",
    "from L#window.time(10) join T on L.k == T.k select L.v as v insert into O;",
    "from L#window.time(10) as a join L#window.time(10) as b on a.k == b.k "
    "select a.v as av insert into O;",
    "from L[v > 1]#window.time(10) join R#window.time(10) on L.k == R.k "
    "select L.v as lv insert into O;",
    "from L join R#window.time(100) on L.k == R.k select L.v as lv insert into O;",
    "from L#window.time(100) join R on L.k == R.k select L.v as lv insert into O;",
    "from L#window.lengthBatch(5) join R#window.time(10) on L.k == R.k "
    "select L.v as lv insert into O;",
    "from L#window.length(v) join R#window.time(10) on L.k == R.k "
    "select L.v as lv insert into O;",
    "from L#window.length(100) join R#window.time(10) on L.k == R.k "
    "select L.v as lv insert into O;",
    "from L#window.time(10) join R#window.length(65) on L.k == R.k "
    "select L.v as lv insert into O;",
    "from L#window.time(10) join R#window.time(10) on L.k == R.k within L.v "
    "select L.v as lv insert into O;",
    "from L#window.time(10) join R#window.time(10) on L.k == R.k within 5, 10 "
    "select L.v as lv insert into O;",
    "from L#window.time(10) join R#window.time(10) on L.k == R.k "
    "select L.k as k, count() as c group by L.k insert into O;",
    "from L#window.time(10) join R#window.time(10) on L.k == R.k "
    "select L.v as lv having lv > 1 insert into O;",
    "from L#window.time(10) join R#window.time(10) on L.k == R.k "
    "select * insert into O;",
    "from L#window.time(10) join R#window.time(10) on L.k == R.k "
    "select L.k as k, sum(R.v) as t insert into O;",
    "from L#window.time(10) join R#window.time(10) on k == R.k "
    "select L.v as lv insert into O;",
    "from L#window.time(10) join R#window.time(10) on L.zz == R.k "
    "select L.v as lv insert into O;",
    "from L#window.time(10) join R#window.time(10) on zz == R.k "
    "select L.v as lv insert into O;",
    "from L#window.time(10) join R#window.time(10) on Q.k == R.k "
    "select L.v as lv insert into O;",
    "from L#window.time(10) join R#window.time(10) on L.k == R.k "
    "select v as v insert into O;",
    "from L#window.time(10) join R#window.time(10) on L.k == 'a' "
    "select L.k + 1 as x insert into O;",
]
REFUSAL_CAPS = (8, 64, 128)         # B, W, J of the refusal cases

# joins the reference accepts and the kernel's limits refuse, at
# construction, on every device: (schema + query, B, W, J)
_WIDE = ", ".join(f"a{i} int" for i in range(17))
LIMITS = [
    (f"define stream P ({_WIDE}); define stream Q (k int);\n"
     "from P#window.length(2) join Q#window.length(2) on "
     + " and ".join(f"P.a{i} == Q.k" for i in range(17))
     + " select Q.k as k insert into O;", 8, 8, 8),
    (SCHEMA + "from L#window.length(2) join R#window.length(2) on L.k == R.k "
     "select " + ", ".join(f"L.v + {i} as o{i}" for i in range(33))
     + " insert into O;", 8, 8, 8),
    (SCHEMA + "from L#window.length(2) join R#window.length(2) on L.k == R.k "
     "select " + "(L.v + " * 34 + "R.v" + ")" * 34 + " as deep insert into O;",
     8, 8, 8),
    (SCHEMA + "from L#window.length(2) join R#window.length(2) on L.k == R.k "
     "select L.v as lv insert into O;", 32768, 65536, 8),
    (SCHEMA + "from L#window.length(2) join R#window.length(2) on L.v "
     "select L.v as lv insert into O;", 8, 8, 8),
    ("define stream L (ts long, v long); define stream R (ts long, v long);\n"
     "from L#window.length(2) join R#window.length(2) on L.ts == R.ts "
     "select L.v as lv insert into O;", 8, 8, 8),
]


def app_text(name: str) -> str:
    return SCHEMA + JOINS[name][0]


def compile_port(name: str, device) -> CompiledJoinQuery:
    text, B, W, J = JOINS[name]
    app = parse(SCHEMA + text)
    return CompiledJoinQuery(app.queries[0], dict(app.stream_definitions),
                             B, W, J, device=device)


def index_bucket(key: int) -> int:
    """The key index's bucket of an int64 key (``bucket_of`` in
    ``csrc/join_step.cu``)."""
    shift = 64 - (NB.bit_length() - 1)
    return ((key * 0x9E3779B97F4A7C15) & (2 ** 64 - 1)) >> shift


def _colliding_keys(buckets: int = 3, per: int = 4) -> list[int]:
    """The smallest positive ints that fill ``buckets`` buckets of the key
    index with ``per`` distinct keys each."""
    seen: dict[int, list[int]] = {}
    full = []
    k = 0
    while len(full) < buckets:
        k += 1
        got = seen.setdefault(index_bucket(k), [])
        got.append(k)
        if len(got) == per:
            full.append(got)
    return sorted(x for keys in full for x in keys)


KEY_POOL = _colliding_keys()
# JoinWire options of the cases that need them
WIRE_OPTIONS = {"key_int": {"keys": KEY_POOL}, "key_long": {"keys": KEY_POOL},
                "key_string": {"keys": KEY_POOL},
                "key_second": {"keys": KEY_POOL},
                "key_overflow": {"keys": KEY_POOL[:4]},
                "key_decreasing": {"keys": KEY_POOL, "decreasing": True}}


class JoinWire:
    """Seeded merged wire batches (``MergedBatchBuilder.emit()`` layout)
    over ``SCHEMA``: a random valid prefix (empty at step 3, full at step
    4), tags by ``RIGHT_SHARE``, ts deltas of 0-9 ms, and stale values
    (tags and columns) past the prefix. ``keys``: the k, v and n columns
    draw from these values instead; ``decreasing``: each batch's valid
    timestamps run backwards (negative deltas from the first)."""

    def __init__(self, seed: int, B: int, keys=None, decreasing=False):
        self.rng = np.random.default_rng(seed)
        self.B = B
        self.ts = 10_000
        self.keys = None if keys is None else np.asarray(keys, np.int64)
        self.decreasing = decreasing

    def batch(self, step: int) -> dict:
        rng, B = self.rng, self.B
        count = 0 if step == 3 and B > 4 else \
            B if step == 4 else int(rng.integers(B // 2, B + 1))
        share = RIGHT_SHARE[step % len(RIGHT_SHARE)]
        tag = (rng.random(B) < share).astype(np.int8)
        tag[count:] = rng.integers(0, 2, B - count)
        deltas = np.cumsum(rng.choice([0, 0, 1, 2, 3, 9], size=B))
        deltas[count:] = 0
        cols = {}
        for s in (0, 1):
            cols[f"s{s}_k"] = rng.integers(1, 5, B).astype(np.int32)
            cols[f"s{s}_v"] = rng.integers(-3, 10, B).astype(np.int64)
            cols[f"s{s}_x"] = np.round(rng.uniform(0, 50, B), 1).astype(np.float32)
            cols[f"s{s}_n"] = rng.integers(-2, 6, B).astype(np.int32)
            cols[f"s{s}_f"] = np.round(rng.uniform(-5, 5, B), 2).astype(np.float32)
            cols[f"s{s}_b"] = rng.random(B) < 0.5
        if self.keys is not None:
            for s in (0, 1):
                for c, dt in (("k", np.int32), ("v", np.int64), ("n", np.int32)):
                    cols[f"s{s}_{c}"] = rng.choice(self.keys, B).astype(dt)
        if self.decreasing and count:
            deltas[:count] = deltas[count - 1] - deltas[:count]
        base = self.ts
        if count:
            self.ts = base + int(deltas[count - 1]) + int(rng.integers(0, 20))
        return {"cols": cols, "tag": tag, "ts": deltas.astype(np.int32),
                "ts_base": np.int64(base), "count": count}


def wire_for(name: str) -> JoinWire:
    return JoinWire(11, JOINS[name][1], **WIRE_OPTIONS.get(name, {}))


def out_numpy(out) -> dict:
    """An output tree (tensors or arrays) as numpy."""
    return {"out": {k: np.asarray(v) for k, v in out["out"].items()},
            "null": {k: np.asarray(v) for k, v in out["null"].items()},
            "valid": np.asarray(out["valid"]), "ts": np.asarray(out["ts"]),
            "count": np.asarray(out["count"])}


def _same(tag, ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.dtype == got.dtype and ref.shape == got.shape, \
        (tag, ref.dtype, got.dtype, ref.shape, got.shape)
    same = ref == got
    if ref.dtype.kind == "f":
        same |= np.isnan(ref) & np.isnan(got)
    assert same.all(), (tag, np.flatnonzero(~same)[:8], ref.ravel()[:16],
                        got.ravel()[:16])


def compare(ref_state: dict, got_state: dict, ref_out: dict, got_out: dict):
    """Exact comparison of a step's state and outputs (numpy trees)."""
    assert set(ref_state) == set(got_state), set(ref_state) ^ set(got_state)
    for k in sorted(ref_state):
        _same(f"state.{k}", ref_state[k], got_state[k])
    assert set(ref_out["out"]) == set(got_out["out"])
    for k in ref_out["out"]:
        _same(f"out.{k}", ref_out["out"][k], got_out["out"][k])
        _same(f"null.{k}", ref_out["null"][k], got_out["null"][k])
    for k in ("valid", "ts", "count"):
        _same(k, ref_out[k], got_out[k])


def _build(text, B=8, W=64, J=128, device="cpu"):
    app = parse(text)
    return CompiledJoinQuery(app.queries[0], dict(app.stream_definitions),
                             B, W, J, device=device)


@pytest.mark.parametrize("name", sorted(JOINS))
def test_every_join_links_its_kernel_programs(name):
    cq = compile_port(name, "cpu")
    a = cq.plan.args
    assert a.nout == len(cq.out_specs) and a.has_cond == (cq.cond_ir is not None)
    assert cq.plan.code_host.shape[1] == 4


@pytest.mark.parametrize("name", sorted(JOINS))
def test_plain_step_keeps_its_invariants(name):
    """Rows are the valid prefix, ts are the probes', state leaves keep
    their shapes and dtypes, and the input state is left as it was."""
    cq = compile_port(name, "cpu")
    state = cq.init_state()
    wire = wire_for(name)
    for step in range(STEPS):
        before = state_to_numpy(state)
        new, out = join_step_plain(cq, state, *cq.batch_tensors(wire.batch(step)))
        after = state_to_numpy(state)
        for k in before:
            _same(f"input {k}", before[k], after[k])
        n = int(out["count"])
        assert out["valid"][:n].all() and not out["valid"][n:].any()
        for k, v in cq.init_state().items():
            assert new[k].dtype == v.dtype and new[k].shape == v.shape
        state = new


# the cases whose condition has no equality conjunct the index can take
UNINDEXED = {"div_zero", "no_condition", "key_under_or"}


@pytest.mark.parametrize("name", sorted(JOINS))
def test_plan_indexes_every_equality_conjunct(name):
    """A top-level ``L.a == R.b`` over BOOL, INT, LONG or string codes
    gives the plan its key programs (one per side); ``or`` at the top, a
    float or a missing equality walks every candidate."""
    cq = compile_port(name, "cpu")
    a = cq.plan.args
    assert cq.plan.indexed == (name not in UNINDEXED)
    assert a.indexed == cq.plan.indexed
    for side in (0, 1):
        assert (a.keyp[side].len > 0) == cq.plan.indexed


def test_key_pool_collides_in_the_kernel_index():
    src = (Path(__file__).resolve().parent.parent / "siddhi_tpu_torch" /
           "csrc" / "join_step.cu").read_text()
    nbb = int(re.search(r"#define NBB (\d+)", src).group(1))
    assert NB == 1 << nbb
    buckets = [index_bucket(k) for k in KEY_POOL]
    assert len(set(buckets)) * 4 == len(KEY_POOL) == len(set(KEY_POOL))


@pytest.mark.parametrize("i", range(len(LIMITS)))
def test_kernel_limits_refuse_at_construction(i):
    text, B, W, J = LIMITS[i]
    with pytest.raises(DeviceCompileError, match="^join kernel: "):
        _build(text, B, W, J)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(JOINS))
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cq = compile_port(name, "cuda")
    state = cq.init_state()
    wire = wire_for(name)
    for step in range(STEPS):
        args = cq.batch_tensors(wire.batch(step))
        ref_state, ref_out = join_step_plain(
            cq, state_from_numpy(state_to_numpy(state), "cuda"), *args)
        state, out = cq.plan.step_cuda(state, *args)
        torch.cuda.synchronize()
        compare(state_to_numpy(ref_state), state_to_numpy(state),
                out_numpy(state_to_numpy(ref_out)),
                out_numpy(state_to_numpy(out)))
