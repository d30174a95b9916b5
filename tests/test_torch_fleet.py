"""The port's fleet tier held against the JAX package's, from seeds.

- the shape normalizer (``fleet/shape.py``): tokens, keys, parameter values
  and overrides equal the reference's for every query of the shape lint's
  corpus (``scripts/check_fleet_shapes.py``, read as data) and of every app
  text in ``samples/``; the lint's three properties hold on the port;
- ``ParamRef``: the closures agree with the reference's
  ``compile_expression`` on the host and device forms, and the device form's
  IR reads a parameter as an event column (``OP_EV``) that the query and NFA
  kernel plans link to a column slot;
- the shared device plan (``FleetManager.device_plan``) on ``device="cpu"``
  (the kernels' plain versions), stepped with 2 and 16 tenants' per-row
  parameter columns, equals the reference's jitted plan on the CPU, state
  and outputs, ``having`` over a parameter included; a plan that the
  parameters push over a kernel's column limit is refused when built;
- a tenant's snapshot (``FleetMemberState``) carries both ways between the
  packages (``gpu/state_io.py``);
- the per-app plan cache keys on the shape and constants, as the
  reference's (``core/host_bridge.py::_app_plan_key``);
- the fleet sections of the reference's guard-coverage lint, on the port.

``tests/test_torch_fleet_card.py`` holds the Hopper kernels against their
plain versions with parameter columns (port-only imports, so it runs where
JAX is missing).
"""

import importlib.util
import os
import random

import jax
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.compiler import parse as jparse
from siddhi_tpu.fleet.shape import FleetShapeError as JShapeError
from siddhi_tpu.fleet.shape import normalize_partition_query as jnorm_part
from siddhi_tpu.fleet.shape import normalize_query as jnorm
from siddhi_tpu.query_api import Partition as JPartition
from siddhi_tpu.query_api import Query as JQueryAst
from siddhi_tpu.tpu.batch import columns_from_rows as jcolumns
from siddhi_tpu.tpu.expr_compile import ColumnResolver as JResolver
from siddhi_tpu.tpu.expr_compile import compile_expression as jcompile
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.fleet.shape import FleetShapeError as TShapeError
from siddhi_tpu_torch.fleet.shape import normalize_partition_query as tnorm_part
from siddhi_tpu_torch.fleet.shape import normalize_query as tnorm
from siddhi_tpu_torch.gpu.batch import columns_from_rows as tcolumns
from siddhi_tpu_torch.gpu.expr_compile import OP, ColumnResolver, \
    DeviceCompileError, compile_expression
from siddhi_tpu_torch.gpu.state_io import state_to_numpy
from siddhi_tpu_torch.query_api import Partition as TPartition
from siddhi_tpu_torch.query_api import Query as TQueryAst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint():
    """The JAX package's shape lint, as data (its corpus and its sample
    walk; nothing of it runs here)."""
    spec = importlib.util.spec_from_file_location(
        "check_fleet_shapes", os.path.join(REPO, "scripts",
                                           "check_fleet_shapes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LINT = _lint()
STRUCTURES = LINT.CORPUS + LINT.PARTITION
SAMPLES = LINT._sample_corpus_texts()
STREAM = "define stream S (sym string, v double, n long);\n"


# ------------------------------------------------------------- shape keys

def _normalized(text: str, pkg: str) -> list:
    """Every execution element's normalization (or its refusal) in one
    package: ``(kind, key, tokens, params, overrides, stream ids)``."""
    if pkg == "jax":
        parse, norm, norm_part, err, Q, P = (jparse, jnorm, jnorm_part,
                                             JShapeError, JQueryAst,
                                             JPartition)
    else:
        parse, norm, norm_part, err, Q, P = (tparse, tnorm, tnorm_part,
                                             TShapeError, TQueryAst,
                                             TPartition)
    app = parse(text)
    defs = dict(app.stream_definitions)
    out = []
    for el in app.execution_elements:
        if isinstance(el, Q):
            todo = [lambda el=el: norm(el, defs)]
        elif isinstance(el, P):
            todo = [lambda q=q, el=el: norm_part(el, q, defs)
                    for q in el.queries]
        else:
            continue
        for f in todo:
            try:
                nq = f()
            except err as e:
                out.append(("refused", str(e)))
                continue
            out.append((nq.kind, nq.shape_key, nq.tokens,
                        [(s.index, s.type.name, s.string)
                         for s in nq.param_specs],
                        list(nq.param_values), dict(nq.overrides),
                        list(nq.stream_ids)))
    return out


@pytest.mark.parametrize("name", [n for n, _ in STRUCTURES])
def test_shape_keys_equal_the_reference_on_the_lint_corpus(name):
    variants = dict(STRUCTURES)[name]
    for text in variants:
        got, ref = _normalized(text, "torch"), _normalized(text, "jax")
        assert got == ref
        assert all(g[0] != "refused" for g in got)


@pytest.mark.parametrize("fn", sorted({fn for fn, _ in SAMPLES}))
def test_shape_keys_equal_the_reference_on_the_samples(fn):
    texts = [t for f, t in SAMPLES if f == fn]
    checked = 0
    for text in texts:
        try:
            ref = _normalized(text, "jax")
        except Exception:       # noqa: BLE001 — as the lint: a sample the
            # reference's parser refuses (extensions, ...) is not a shape
            continue
        assert _normalized(text, "torch") == ref
        checked += 1
    assert checked or not texts


def _port_keys(text: str) -> list:
    return [g[1] if g[0] != "refused" else None
            for g in _normalized(text, "torch")]


def test_the_lints_three_properties_hold_on_the_port():
    """Determinism, constant invariance and structure sensitivity over the
    lint's corpus, and determinism over the samples, on the port's
    normalizer."""
    key_of = {}
    for name, variants in STRUCTURES:
        keys = set()
        for text in variants:
            k1, k2 = _port_keys(text), _port_keys(text)
            assert k1 == k2, name
            assert None not in k1, name
            keys.update(k1)
        assert len(keys) == 1, (name, keys)
        key_of[name] = keys.pop()
    assert len(set(key_of.values())) == len(key_of)
    for fn, text in SAMPLES:
        try:
            k1 = _port_keys(text)
        except Exception:       # noqa: BLE001
            continue
        assert k1 == _port_keys(text), fn


# --------------------------------------------------------------- ParamRef

EXPRS = [
    "v > 30.0", "v * 2.0 + 1.0 > 77.5", "n % 7 == 3 and v < 60.0",
    "sym == 'b' or n > 500", "not (v >= 12.5)", "-v + 40.0 > 0.0",
]


def _compiled_param_exprs(text, pkg, host):
    """The filter of ``from S[<text>]`` with its constants hoisted, compiled
    by one package's compile_expression on one form."""
    parse, norm = (jparse, jnorm) if pkg == "jax" else (tparse, tnorm)
    app = parse(STREAM + f"from S[{text}] select v insert into Out;")
    defs = dict(app.stream_definitions)
    nq = norm(app.queries[0], defs)
    from siddhi_tpu.tpu.batch import BatchSchema as JSchema
    from siddhi_tpu_torch.gpu.batch import BatchSchema as TSchema
    if pkg == "jax":
        schema = JSchema(defs["S"])
        res = JResolver(schema, np if host else None)
        fn, t = jcompile(nq.query.input_stream.handlers[0].expr, res)
        return fn, t, None, nq, schema
    schema = TSchema(defs["S"])
    res = ColumnResolver(schema, host=host)
    fn, t, ir = compile_expression(nq.query.input_stream.handlers[0].expr,
                                   res)
    return fn, t, ir, nq, schema


def _env(schema, nq, n, seed, host):
    rng = np.random.default_rng(seed)
    fdt = np.float64 if host else np.float32
    idt = np.int64
    syms = ["a", "b", "c"]
    env = {"sym": np.array([schema.dictionaries["sym"].encode(s)
                            for s in rng.choice(syms, n)], np.int32),
           "v": np.round(rng.uniform(0, 100, n), 2).astype(fdt),
           "n": rng.integers(0, 1000, n).astype(idt)}
    for spec, val in zip(nq.param_specs, nq.param_values):
        if spec.string:
            col = np.full(n, schema.dictionaries["sym"].encode(val), np.int32)
        elif spec.type.name in ("FLOAT", "DOUBLE"):
            # per-row values: each row its own tenant's constant
            col = (val + rng.integers(-2, 3, n)).astype(fdt)
        elif spec.type.name == "INT":
            col = (val + rng.integers(-2, 3, n)).astype(
                np.int64 if host else np.int32)
        else:
            col = (val + rng.integers(-2, 3, n)).astype(idt)
        env[f"__fleet_p{spec.index}"] = col
    return env


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
@pytest.mark.parametrize("text", EXPRS)
def test_param_closures_match_the_reference(text, host):
    jfn, jt, _, jnq, jschema = _compiled_param_exprs(text, "jax", host)
    tfn, tt, ir, tnq, tschema = _compiled_param_exprs(text, "torch", host)
    assert tt.name == jt.name
    assert jnq.param_values == tnq.param_values and jnq.param_specs
    jenv = _env(jschema, jnq, 257, 3, host)
    tenv = _env(tschema, tnq, 257, 3, host)
    want = np.asarray(jfn(jenv))
    got = tfn({k: torch.from_numpy(v) for k, v in tenv.items()})
    np.testing.assert_array_equal(np.asarray(got), want)
    if host:
        assert ir is None
    else:
        pkeys = {f"__fleet_p{s.index}" for s in tnq.param_specs}
        evs = {a for (op, _, a, _) in ir if op == OP["EV"]}
        assert pkeys <= evs
        assert not {a for (op, _, a, _) in ir if op == OP["BIND"]} & pkeys


def test_param_columns_link_to_kernel_column_slots():
    """A single-stream query's ``__fleet_p{i}`` and an NFA's
    ``ev___fleet_p{i}`` are event columns of the kernels' plans, typed as
    the parameter."""
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    app = tparse(STREAM + "from S[v > 30.0 and n > 7] select sym, v * 2.0 "
                 "as x, n insert into Out;")
    defs = dict(app.stream_definitions)
    q = m.fleet.device_plan(tnorm(app.queries[0], defs), defs)
    assert {"__fleet_p0", "__fleet_p1", "__fleet_p2"} <= set(q.plan.col_keys)
    assert q.column_type("__fleet_p1").name == "INT"
    app = tparse(STREAM + "partition with (sym of S) begin from every "
                 "e1=S[v > 90.0] -> e2=S[v > e1.v] within 4000 select e1.v "
                 "as a, e2.v as b insert into Out; end;")
    defs = dict(app.stream_definitions)
    part = app.partitions[0]
    nfa = m.fleet.device_plan(tnorm_part(part, part.queries[0], defs), defs)
    assert nfa.param_cols == {"__fleet_p0": nfa.column_type("__fleet_p0")}
    assert "__fleet_p0" in nfa.plan.col_keys
    assert "__fleet_p0" not in nfa.used_cols     # never staged
    m.shutdown()


# ------------------------------------------------ shared device plans (CPU)

STREAM_SHAPES = {
    "filter_string": "from S[v > 30.0 and sym == 'a'] select sym, v, n "
                     "insert into Out;",
    "projection": "from S[v * 2.0 + 1.0 > 100.0] select v * 3.0 as x, n "
                  "insert into Out;",
    "group_having": "from S select sym, sum(n) as s, count() as c "
                    "group by sym having s > 500 insert into Out;",
    "window_having": "from S#window.length(8) select sym, max(v) as mx "
                     "having mx > 50.0 and mx < 99.0 insert into Out;",
    "running_having": "from S select count() as c, max(n) as mx "
                      "having mx > 900 insert into Out;",
    "sort_having": "from S#window.sort(4, v) select sym, max(n) as mx "
                   "having mx > 700 insert into Out;",
}


def _tenant_params(nq, tenants, rng, dictionary):
    """Each tenant's bound constants (device dtypes), spread around the
    shape's own; strings as codes of the shared dictionary."""
    out = []
    for t in range(tenants):
        vals = []
        for spec, val in zip(nq.param_specs, nq.param_values):
            if spec.string:
                vals.append(dictionary.encode(["a", "b", "c"][t % 3]))
            elif spec.type.name in ("FLOAT", "DOUBLE"):
                vals.append(np.float32(val + rng.uniform(-20, 20)))
            elif spec.type.name == "INT":
                vals.append(np.int32(val + rng.integers(-200, 200)))
            else:
                vals.append(np.int64(val + rng.integers(-200, 200)))
        out.append(vals)
    return out


def _rows(n, seed):
    rng = random.Random(seed)
    rows, ts, t = [], [], 1_000_000
    for _ in range(n):
        rows.append([f"{'abc'[rng.randrange(3)]}", round(rng.uniform(0, 100),
                                                         2),
                     rng.randrange(1000)])
        t += rng.randrange(1, 30)
        ts.append(t)
    return rows, ts


def _param_dtype(spec):
    if spec.string:
        return np.int32
    return {"FLOAT": np.float32, "DOUBLE": np.float32, "INT": np.int32,
            "LONG": np.int64}[spec.type.name]


def _with_params(batch, nq, mids, params):
    """The batch with per-row ``__fleet_p{i}`` columns gathered by tenant
    (rows past the count carry tenant 0's)."""
    cols = dict(batch["cols"])
    for i, spec in enumerate(nq.param_specs):
        lut = np.array([p[i] for p in params], dtype=_param_dtype(spec))
        cols[f"__fleet_p{spec.index}"] = lut[mids]
    return {**batch, "cols": cols}


def _tree_equal(ref, got, what):
    assert set(ref) == set(got), what
    for k in ref:
        if isinstance(ref[k], dict):
            _tree_equal(ref[k], got[k], f"{what}.{k}")
            continue
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}.{k}")


@pytest.mark.parametrize("tenants", [2, 16])
@pytest.mark.parametrize("shape", list(STREAM_SHAPES))
def test_stream_device_plan_with_param_columns_matches_reference(shape,
                                                                 tenants):
    text = STREAM + STREAM_SHAPES[shape]
    japp, tapp = jparse(text), tparse(text)
    jdefs, tdefs = dict(japp.stream_definitions), dict(tapp.stream_definitions)
    jm, tm = siddhi_tpu.SiddhiManager(), \
        siddhi_tpu_torch.SiddhiManager(device="cpu")
    try:
        jnq = jnorm(japp.queries[0], jdefs)
        tnq = tnorm(tapp.queries[0], tdefs)
        jq = jm.fleet.device_plan(jnq, jdefs)
        tq = tm.fleet.device_plan(tnq, tdefs)
        # the same cache entry for every tenant of the shape
        assert tm.fleet.device_plan(tnq, tdefs) is tq
        assert tm.fleet.stats()["cache"]["per_backend"] == {"jax": 1}
        rng = np.random.default_rng(tenants)
        rows, ts = _rows(3 * 256, seed=tenants)
        B = tq.B
        jstate, tstate = jq.init_state(), tq.init_state()
        for step in range(3):
            part = slice(step * 256, (step + 1) * 256)
            jb = jcolumns(jq.schema, rows[part], ts[part], capacity=B)
            tb = tcolumns(tq.schema, rows[part], ts[part], capacity=B)
            if step == 0:
                jp = _tenant_params(jnq, tenants, np.random.default_rng(1),
                                    jq.schema.dictionaries["sym"])
                tp = _tenant_params(tnq, tenants, np.random.default_rng(1),
                                    tq.schema.dictionaries["sym"])
                assert [list(map(float, p)) for p in jp] == \
                    [list(map(float, p)) for p in tp]
            mids = rng.integers(0, tenants, B)
            jstate, jout = jq.step(jstate, _with_params(jb, jnq, mids, jp))
            tstate, tout = tq.step(tstate, _with_params(tb, tnq, mids, tp))
            jstate = {k: np.asarray(v) for k, v in
                      jax.device_get(jstate).items()}
            _tree_equal(jstate, state_to_numpy(tstate), f"state{step}")
            jo = jax.device_get(jout)
            to = state_to_numpy(tout)
            np.testing.assert_array_equal(to["valid"], np.asarray(jo["valid"]))
            np.testing.assert_array_equal(to["count"], np.asarray(jo["count"]))
            v = np.asarray(jo["valid"])
            np.testing.assert_array_equal(to["ts"][v], np.asarray(jo["ts"])[v])
            for name, col in jo["out"].items():
                np.testing.assert_array_equal(to["out"][name][v],
                                              np.asarray(col)[v], err_msg=name)
            assert tq.decode_outputs(tout) == jq.decode_outputs(jout)
    finally:
        jm.shutdown()
        tm.shutdown()


def test_having_over_a_parameter_reads_each_rows_own_tenant():
    """Two tenants whose ``having`` constants differ: each accepted row is
    judged against its own tenant's value, as per-tenant solo runs judge
    it."""
    text = STREAM + STREAM_SHAPES["window_having"]
    tapp = tparse(text)
    defs = dict(tapp.stream_definitions)
    tm = siddhi_tpu_torch.SiddhiManager(device="cpu")
    nq = tnorm(tapp.queries[0], defs)
    q = tm.fleet.device_plan(nq, defs)
    rows, ts = _rows(200, seed=5)
    b = tcolumns(q.schema, rows, ts, capacity=q.B)
    mids = np.arange(q.B) % 2
    params = [[np.float32(40.0), np.float32(99.0)],
              [np.float32(70.0), np.float32(95.0)]]
    _st, out = q.step(q.init_state(), _with_params(b, nq, mids, params))
    o = state_to_numpy(out)
    mx = o["out"]["mx"]
    lo = np.where(mids == 0, 40.0, 70.0)
    hi = np.where(mids == 0, 99.0, 95.0)
    want = (np.arange(q.B) < 200) & (mx > lo) & (mx < hi)
    np.testing.assert_array_equal(o["valid"], want)
    assert want.any() and (want != ((np.arange(q.B) < 200) & (mx > 40.0)
                                    & (mx < 99.0))).any()
    tm.shutdown()


NFA_SHAPES = {
    "partitioned_chain": STREAM + "partition with (sym of S) begin from every "
    "e1=S[v > 90.0] -> e2=S[v > e1.v + 1.5] within 4000 select e1.v as a, "
    "e2.v as b insert into Out; end;",
    "count_scan": STREAM + "from every e1=S[v > 80.0] -> e2=S[v > e1.v]<2:3> "
    "select e1.v as a, e2[0].v as b insert into Out;",
}


def _nfa_plans(name):
    text = NFA_SHAPES[name]
    out = []
    for pkg, parse, norm, norm_part, mgr in (
            ("jax", jparse, jnorm, jnorm_part, siddhi_tpu.SiddhiManager()),
            ("torch", tparse, tnorm, tnorm_part,
             siddhi_tpu_torch.SiddhiManager(device="cpu"))):
        app = parse(text)
        defs = dict(app.stream_definitions)
        if app.partitions:
            part = app.partitions[0]
            nq = norm_part(part, part.queries[0], defs)
        else:
            nq = norm(app.queries[0], defs)
        out.append((mgr, nq, mgr.fleet.device_plan(nq, defs)))
    return out


@pytest.mark.parametrize("tenants", [2, 16])
@pytest.mark.parametrize("name", list(NFA_SHAPES))
def test_nfa_device_plan_with_param_columns_matches_reference(name, tenants):
    (jm, jnq, jc), (tm, tnq, tc) = _nfa_plans(name)
    try:
        assert jc.blocked == tc.blocked == (name == "partitioned_chain")
        lanes, B = 2, tc.B
        rng = np.random.default_rng(tenants + 7)
        jstep = jax.jit(jax.vmap(jc.make_step()))
        tstep = tc.make_step()
        jstate = jax.tree_util.tree_map(
            lambda x: np.broadcast_to(np.asarray(x)[None],
                                      (lanes,) + np.shape(x)).copy(),
            jc.init_state())
        tstate = tc.init_state(lanes)
        params = [np.float32(jnq.param_values[i] + rng.uniform(-8, 8))
                  for i in range(len(jnq.param_specs))
                  for _ in range(tenants)]
        params = np.array(params, np.float32).reshape(
            len(jnq.param_specs), tenants)
        matched = 0
        for step in range(3):
            cols = {}
            for k in sorted(tc.used_cols):
                t = tc.merged.columns[k].name
                if t == "STRING":
                    cols[k] = rng.integers(1, 4, (lanes, B)).astype(np.int32)
                elif t in ("FLOAT", "DOUBLE"):
                    cols[k] = np.round(rng.uniform(0, 100, (lanes, B)),
                                       1).astype(np.float32)
                else:
                    cols[k] = rng.integers(0, 1000, (lanes, B)).astype(np.int64)
            mids = rng.integers(0, tenants, (lanes, B))
            for i, spec in enumerate(tnq.param_specs):
                cols[f"__fleet_p{spec.index}"] = params[i][mids]
            tag = np.zeros((lanes, B), np.int8)
            tss = np.cumsum(rng.integers(0, 60, (lanes, B)), 1).astype(
                np.int32)
            base = rng.integers(10**6, 2 * 10**6, lanes).astype(np.int64)
            counts = rng.integers(B // 2, B + 1, lanes).astype(np.int32)
            jstate, jys = jstep(jstate, cols, tag, tss, base, counts)
            tstate, tys = tstep(
                tstate, {k: torch.from_numpy(v) for k, v in cols.items()},
                torch.from_numpy(tag), torch.from_numpy(tss),
                torch.from_numpy(base), torch.from_numpy(counts))
            jstate = jax.tree_util.tree_map(np.asarray,
                                            jax.device_get(jstate))
            _tree_equal(jstate, state_to_numpy(tstate), f"state{step}")
            _tree_equal(jax.tree_util.tree_map(np.asarray, jys),
                        state_to_numpy(tys), f"ys{step}")
            matched += int(np.sum(jstate["matches"]))
        assert matched > 0
    finally:
        jm.shutdown()
        tm.shutdown()


def test_parameters_over_a_kernels_column_limit_are_refused_when_built():
    """Sixteen columns and sixteen hoisted constants pass the query and
    blocked-NFA kernels' limits of event columns: the fleet's device plan is
    refused when built, where the query without slots compiles."""
    attrs = ", ".join(f"a{i} double" for i in range(16))
    sdef = f"define stream W (k string, {attrs});\n"
    cond = " and ".join(f"a{i} > {i}.5" for i in range(16))
    app = tparse(sdef + f"from W[{cond}] select k insert into Out;")
    defs = dict(app.stream_definitions)
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    from siddhi_tpu_torch.gpu.query_compile import CompiledStreamQuery
    CompiledStreamQuery(app.queries[0], defs["W"], device="cpu")
    nq = tnorm(app.queries[0], defs)
    assert len(nq.param_specs) == 16
    with pytest.raises(DeviceCompileError, match="event columns"):
        m.fleet.device_plan(nq, defs)
    assert m.fleet.stats()["cache"]["failed"] == 1
    conds = " and ".join(f"a{i} > e1.a{i} + {i}.5" for i in range(16))
    papp = tparse(sdef + "partition with (k of W) begin from every "
                  f"e1=W[a0 > 1.0] -> e2=W[{conds}] select e1.a0 as x "
                  "insert into Out; end;")
    pdefs = dict(papp.stream_definitions)
    part = papp.partitions[0]
    from siddhi_tpu_torch.gpu.nfa import DeviceNFACompiler
    from siddhi_tpu_torch.gpu.partition import _inject_key_equality
    DeviceNFACompiler(_inject_key_equality(part.queries[0], "k"), pdefs,
                      device="cpu")
    pnq = tnorm_part(part, part.queries[0], pdefs)
    with pytest.raises(DeviceCompileError, match="event columns"):
        m.fleet.device_plan(pnq, pdefs)
    m.shutdown()


def test_having_parameter_over_a_tumbling_window_is_refused_by_name():
    """The reference's plan cannot run a ``having`` parameter over a window
    whose output rows are not the batch's accepted events (its compacted
    parameter column does not broadcast against them); the query kernel's
    plan refuses it by name when built."""
    app = tparse(STREAM + "from S#window.lengthBatch(4) select sum(n) as s "
                 "having s > 100 insert into Out;")
    defs = dict(app.stream_definitions)
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    with pytest.raises(DeviceCompileError, match="lengthBatch"):
        m.fleet.device_plan(tnorm(app.queries[0], defs), defs)
    m.shutdown()


# --------------------------------------------------------------- snapshots

FLEET = "@app:fleet(batch='64', lanes='4')\n"


def _tenant(pkg_mgr, name, body):
    rt = pkg_mgr.create_siddhi_app_runtime(
        f"@app(name='{name}')\n" + FLEET + STREAM + body, playback=True)
    rows = []
    cb = (siddhi_tpu_torch if isinstance(pkg_mgr,
                                         siddhi_tpu_torch.SiddhiManager)
          else siddhi_tpu).StreamCallback
    rt.add_callback("Out", cb(lambda evs: rows.extend(list(e.data)
                                                      for e in evs)))
    rt.start()
    return rt, rows


SNAP_BODIES = {
    "window": "@info(name='q') from S#window.length(7) select sym, sum(n) "
              "as s, max(v) as mx insert into Out;",
    "pattern": "@info(name='q') from every e1=S[v > 70.0] -> e2=S[v > e1.v] "
               "within 400 select e1.v as a, e2.v as b insert into Out;",
    "partition": "partition with (sym of S) begin @info(name='q') from "
                 "every e1=S[v > 60.0] -> e2=S[v > e1.v] within 300 select "
                 "e1.v as a, e2.v as b insert into Out; end;",
}


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("body", list(SNAP_BODIES))
def test_tenant_snapshot_resumes_in_the_other_package(body, direction):
    rows, ts = _rows(300, seed=11)
    jm = siddhi_tpu.SiddhiManager()
    tm = siddhi_tpu_torch.SiddhiManager(device="cpu")
    try:
        src_m, dst_m = (jm, tm) if direction == "jax_to_torch" else (tm, jm)
        src, src_rows = _tenant(src_m, "src", SNAP_BODIES[body])
        dst, dst_rows = _tenant(dst_m, "dst", SNAP_BODIES[body])
        for r, t in zip(rows[:150], ts[:150]):
            src.input_handler("S").send(list(r), timestamp=t)
        src.flush_host()
        (key,) = [k for k in src.ctx.state_registry if k.startswith("fleet-")]
        snap = src.ctx.state_registry[key].snapshot_state()
        dst.ctx.state_registry[key].restore_state(snap)
        src_rows.clear()
        for r, t in zip(rows[150:], ts[150:]):
            src.input_handler("S").send(list(r), timestamp=t)
            dst.input_handler("S").send(list(r), timestamp=t)
        src.flush_host()
        dst.flush_host()
        assert dst_rows == src_rows
        assert src_rows, "the resumed half must emit to mean anything"
    finally:
        jm.shutdown()
        tm.shutdown()


# ------------------------------------------------------ per-app plan cache

def test_queries_spelled_differently_share_one_plan_in_an_app():
    """Two queries of one app that differ only in spelling (parentheses,
    aliases written out), with the same shape and constants, share one
    columnar plan, as in the reference (``_app_plan_key``)."""
    text = ("@app:host_batch(batch='64')\n" + STREAM +
            "from S[v > 10.0] select sym, v insert into O1;\n"
            "from S[(v > 10.0)] select sym as sym, v as v insert into O2;\n"
            "from S[v > 20.0] select sym, v insert into O3;\n")
    for pkg in (siddhi_tpu, siddhi_tpu_torch):
        m = pkg.SiddhiManager() if pkg is siddhi_tpu else \
            pkg.SiddhiManager(device="cpu")
        rt = m.create_siddhi_app_runtime(text, playback=True)
        assert len(rt.host_bridges) == 3
        assert len(rt.ctx._host_plan_cache) == 2, pkg.__name__
        hq = [b.runtime.hq for b in rt.host_bridges]
        assert hq[0] is hq[1] and hq[2] is not hq[0]
        m.shutdown()


# ------------------------------------------------- guard coverage (fleet)

def test_fleet_groups_step_through_their_guard_and_decisions_record_first():
    """The fleet sections of the reference's guard-coverage lint, on the
    port: a group built for an ``@app:fleet`` tenant carries a
    ``FleetGuard`` its step consults, and every SLO actuator is reached
    only through ``SLOController._actuate``, which records the decision
    before dispatching (a synthetic actuation lands on the tenant's
    flight recorder)."""
    import inspect
    import re

    from siddhi_tpu_torch.fleet import group as group_mod
    from siddhi_tpu_torch.observability import slo as slo_mod
    from siddhi_tpu_torch.resilience.fleet_guard import FleetGuard

    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt, _rows_ = _tenant(m, "g0", "@info(name='q') from S[v > 5.0] select "
                         "v insert into Out;")
    group = rt.fleet_bridges[0].group
    assert isinstance(group.guard, FleetGuard)
    src = inspect.getsource(group_mod.FleetGroup._step)
    assert "self.guard" in src and "g.step_batched" in src
    assert "g.step_segment" in inspect.getsource(
        group_mod.FleetGroup._step_sliced)
    ctrl_src = inspect.getsource(slo_mod.SLOController)
    act = inspect.getsource(slo_mod.SLOController._actuate)
    assert act.index("record") < act.index("_act_")
    direct = [m_ for m_ in re.finditer(r"self\._act_\w+\(", ctrl_src)]
    assert all(act.find(d.group(0)) >= 0 for d in direct)
    m.shutdown()
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(
        "@app(name='s0')\n@app:fleet(batch='64', slo.p99.ms='50', "
        "slo.class='premium')\n" + STREAM + "@info(name='q') from S[v > 5.0] "
        "select v insert into Out;", playback=True)
    rt.start()
    ctrl = rt.fleet_bridges[0].group.slo
    ctrl._actuate({"actuator": "shrink_window", "guilty_phase": "fill_wait",
                   "p99_ms": 99.0, "budget_ms": 50.0, "from": 64, "to": 32})
    kinds = [e.get("kind") for e in rt.ctx.flight.export(category="slo")]
    assert any(str(k).startswith("decision:") for k in kinds), kinds
    m.shutdown()
