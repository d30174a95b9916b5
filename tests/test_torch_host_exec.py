"""The port's columnar host engine against the JAX package's, on the CPU.

The same seeded events (numpy) stage through each package's own
``HostRowStager`` and step through the reference's ``tpu/host_exec.py``
(compilers with ``backend="numpy"``) and the port's ``gpu/host_exec.py``
(compilers with ``host=True``, torch on the CPU), batch by batch: every
state leaf and every output column, and the decoded rows in order, must
agree. Integers, booleans and dictionary codes are exact; float64 values
within a relative tolerance of 1e-12 (``RTOL``; both engines sum in the
same order, so in practice they are equal).

Cases: the five templates of the reference's ``test_host_batch`` fuzz,
``having``, two group keys, a string binding, a sequence, a partitioned
batch straddle, an empty and a one-event batch, integer division by zero,
LONG against a non-constant DOUBLE (refused on the device, lowered on the
host), a plan over a kernel limit that the host form accepts, a
snapshot restored mid-stream, and the count/logical/absent refusal with
the reference's message.
"""

import numpy as np
import pytest
import torch

from siddhi_tpu.compiler import parse as ref_parse
from siddhi_tpu.tpu import host_exec as ref_he
from siddhi_tpu.tpu.nfa import DeviceNFACompiler as RefNFA
from siddhi_tpu.tpu.query_compile import CompiledStreamQuery as RefQuery

from siddhi_tpu_torch.compiler import parse as port_parse
from siddhi_tpu_torch.gpu import host_exec as port_he
from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
from siddhi_tpu_torch.gpu.nfa import DeviceNFACompiler as PortNFA
from siddhi_tpu_torch.gpu.query_compile import CompiledStreamQuery as PortQuery
from siddhi_tpu_torch.gpu.state_io import host_tree_to_numpy

RTOL = 1e-12
STREAM = "define stream S (sym string, v double, n long);\n"

# tests/test_host_batch.py's _FUZZ_TEMPLATES, formatted
FUZZ = [
    "from S[v > 41.7] select sym, v, n insert into Out;",
    "from S[v > 63.2] select sym, sum(v) as s, count() as c "
    "group by sym insert into Out;",
    "from S#window.length(17) select v, sum(v) as s, min(v) as mn "
    "insert into Out;",
    "from S#window.time(300) select v, count() as c, max(v) as mx "
    "insert into Out;",
    "from every e1=S[v > 55.0] -> e2=S[v > e1.v] within 900 "
    "select e1.v as a, e2.v as b insert into Out;",
]


def events(n: int, seed: int, syms: int = 5, step: int = 7) -> list:
    """``n`` rows ``([sym, v, n], ts)``: ``v`` to three places, rising
    timestamps."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, syms, n)
    v = np.round(rng.uniform(0.0, 100.0, n), 3)
    k = rng.integers(0, 1000, n)
    ts = 1_000_000 + np.cumsum(rng.integers(1, step, n))
    return [([f"s{int(a)}", float(b), int(c)], int(t))
            for a, b, c, t in zip(sym, v, k, ts)]


def leaves_equal(ref, got, at: str = "") -> None:
    """The reference's state or output tree against the port's: the same
    keys and shapes, ints and bools exact, floats within ``RTOL``."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(ref) == set(got), at
        for k in ref:
            leaves_equal(ref[k], got[k], f"{at}/{k}")
        return
    if isinstance(ref, (int, float, bool)) and not isinstance(
            got, (np.ndarray, torch.Tensor)):
        assert ref == got, at
        return
    r, g = np.asarray(ref), np.asarray(got)
    assert r.shape == g.shape, (at, r.shape, g.shape)
    assert r.dtype == g.dtype, (at, r.dtype, g.dtype)
    if np.issubdtype(r.dtype, np.floating):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=0, err_msg=at)
    else:
        np.testing.assert_array_equal(g, r, err_msg=at)


class Pair:
    """One query compiled by both packages for their host engines."""

    def __init__(self, text: str, partition_key: str | None = None):
        self.ref_app, self.port_app = ref_parse(text), port_parse(text)
        rq, pq = self._query(self.ref_app), self._query(self.port_app)
        rdefs = dict(self.ref_app.stream_definitions)
        pdefs = dict(self.port_app.stream_definitions)
        self.partitioned = partition_key is not None
        if self.partitioned:
            self.ref = ref_he.HostPartitionedNFA(rq, rdefs, partition_key,
                                                 num_partitions=4)
            self.port = port_he.HostPartitionedNFA(pq, pdefs, partition_key,
                                                   num_partitions=4)
            self.ref_schema = self.ref.compiler.merged
            self.port_schema = self.port.compiler.merged
            self.stagers = (
                ref_he.HostRowStager(self.ref_schema, rdefs, 1 << 20,
                                     self.ref.compiler.used_cols),
                port_he.HostRowStager(self.port_schema, pdefs, 1 << 20,
                                      self.port.compiler.used_cols))
            return
        self.nfa = not hasattr(rq.input_stream, "stream_id")
        if self.nfa:
            rc = RefNFA(rq, rdefs, backend="numpy")
            pc = PortNFA(pq, pdefs, host=True)
            self.ref, self.port = ref_he.HostBlockNFA(rc), \
                port_he.HostBlockNFA(pc)
            self.stagers = (
                ref_he.HostRowStager(rc.merged, rdefs, 1 << 20, rc.used_cols),
                port_he.HostRowStager(pc.merged, pdefs, 1 << 20,
                                      pc.used_cols))
        else:
            rc = RefQuery(rq, rdefs["S"], backend="numpy")
            pc = PortQuery(pq, pdefs["S"], host=True)
            self.ref, self.port = ref_he.HostStreamQuery(rc), \
                port_he.HostStreamQuery(pc)
            self.stagers = (ref_he.HostRowStager(rc.schema, None, 1 << 20),
                            port_he.HostRowStager(pc.schema, None, 1 << 20))
        self.ref_state = self.ref.init_state()
        self.port_state = self.port.init_state()
        leaves_equal(self.ref_state, host_tree_to_numpy(self.port_state))

    @staticmethod
    def _query(app):
        if app.partitions:
            return app.partitions[0].queries[0]
        return app.execution_elements[0]

    def step(self, chunk: list) -> tuple[list, list]:
        """One batch through both engines: their decoded rows (with
        timestamps), after holding state and outputs equal."""
        for stager in self.stagers:
            for row, ts in chunk:
                stager.append("S", list(row), ts)
        rb, pb = (s.emit() for s in self.stagers)
        leaves_equal(rb["cols"], pb["cols"], "staged")
        if self.partitioned:
            rj, rout = self.ref.process(rb)
            pj, pout = self.port.process(pb)
            leaves_equal(rout, host_tree_to_numpy(pout), "outs")
            for lane, (r, g) in enumerate(zip(self.ref.lane_states,
                                              self.port.lane_states)):
                leaves_equal(r, host_tree_to_numpy(g), f"lane {lane}")
            return self.ref.decode(rout), self.port.decode(pout)
        if self.nfa:
            self.ref_state, rout = self.ref.step(
                self.ref_state, rb["cols"], rb["tag"], rb["ts"])
            self.port_state, pout = self.port.step(
                self.port_state, pb["cols"], pb["tag"], pb["ts"])
            leaves_equal(rout, host_tree_to_numpy(pout), "outs")
            leaves_equal(self.ref_state, host_tree_to_numpy(self.port_state),
                         "state")
            specs = self.ref.out_specs
            return (list(zip(rout["ts"].tolist(), ref_he.decode_columns(
                specs, rout, self.ref.nfa.merged.dictionaries))),
                list(zip(pout["ts"].tolist(), port_he.decode_columns(
                    self.port.out_specs, pout,
                    self.port.nfa.merged.dictionaries))))
        self.ref_state, rres = self.ref.step(self.ref_state, rb["cols"],
                                             rb["ts"])
        self.port_state, pres = self.port.step(self.port_state, pb["cols"],
                                               pb["ts"])
        leaves_equal(rres, host_tree_to_numpy(pres), "outs")
        leaves_equal(self.ref_state, host_tree_to_numpy(self.port_state),
                     "state")
        return (list(zip(*self.ref.decode(rres))),
                list(zip(*self.port.decode(pres))))

    def run(self, evs: list, chunk: int) -> list:
        out = []
        for lo in range(0, len(evs), chunk):
            ref_rows, port_rows = self.step(evs[lo:lo + chunk])
            assert port_rows == ref_rows
            out.extend(port_rows)
        return out


@pytest.mark.parametrize("i", range(len(FUZZ)))
@pytest.mark.parametrize("chunk", [1, 37, 400])
def test_fuzz_template(i, chunk):
    pair = Pair(STREAM + FUZZ[i])
    rows = pair.run(events(400 if chunk > 1 else 120, seed=10 + i), chunk)
    assert rows


CASES = {
    "having": "from S#window.length(20) select sym, sum(v) as s "
              "having s > 800.0 insert into Out;",
    "two_group_keys": "from S select sym, n, sum(v) as s, count() as c, "
                      "min(v) as mn group by sym, n insert into Out;",
    "running": "from S select sym, sum(v) as s, count() as c, avg(n) as a, "
               "min(v) as mn, max(n) as mx insert into Out;",
    "string_binding": "from every e1=S[v > 70.0] -> "
                      "e2=S[sym == e1.sym and v > e1.v] within 400 "
                      "select e1.sym as k, e1.v as a, e2.v as b "
                      "insert into Out;",
    "sequence": "from every e1=S[v > 60.0], e2=S[v > e1.v] "
                "select e1.v as a, e2.v as b insert into Out;",
    "chain3": "from every e1=S[v > 75.0] -> e2=S[v > e1.v] -> "
              "e3=S[v > e2.v] within 200 "
              "select e1.v as a, e2.v as b, e3.v as c insert into Out;",
    "div_by_zero": "from S select n / (n - n) as q, n % (n - n) as r, "
                   "n / 7 as d, v / 0.0 as f insert into Out;",
    "long_vs_double": "from S[n > v] select n, v, n * v as p "
                      "insert into Out;",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case(name):
    pair = Pair(STREAM + CASES[name])
    rows = pair.run(events(300, seed=len(name), syms=3), 41)
    assert rows


def test_integer_division_by_zero_gives_numpys_zero():
    pair = Pair(STREAM + CASES["div_by_zero"])
    rows = pair.run(events(20, seed=3), 20)
    assert {r[0] for _, r in rows} == {0} and {r[1] for _, r in rows} == {0}


def test_long_against_a_double_column_lowers_only_on_the_host():
    app = port_parse(STREAM + CASES["long_vs_double"])
    q, d = app.execution_elements[0], app.stream_definitions["S"]
    with pytest.raises(DeviceCompileError, match="2\\^24"):
        PortQuery(q, d, device="cpu")
    assert PortQuery(q, d, host=True).plan is None


def test_a_plan_over_a_kernel_limit_lowers_on_the_host():
    outs = ", ".join(f"v + {i}.0 as o{i}" for i in range(33))
    text = STREAM + f"from S[v > 20.0] select {outs} insert into Out;"
    app = port_parse(text)
    with pytest.raises(DeviceCompileError, match="33 outputs"):
        PortQuery(app.execution_elements[0], app.stream_definitions["S"],
                  device="cpu")
    pair = Pair(text)
    assert pair.run(events(200, seed=8), 64)


@pytest.mark.parametrize("chunk", [1, 3, 11, 64])
def test_partitioned_batch_straddle(chunk):
    text = STREAM + """
        partition with (sym of S)
        begin
        from every e1=S[v > 50.0] -> e2=S[v > e1.v]
        within 500
        select e1.sym as k, e1.v as a, e2.v as b insert into Out;
        end;
    """
    pair = Pair(text, partition_key="sym")
    rows = pair.run(events(240, seed=12, syms=2), chunk)
    assert rows
    assert pair.port.match_count == pair.ref.match_count == len(rows)


@pytest.mark.parametrize("name", ["running", "chain3", "having"])
def test_empty_and_one_event_batches(name):
    pair = Pair(STREAM + CASES[name])
    evs = events(60, seed=21)
    assert pair.step([]) == ([], [])
    pair.run(evs[:1], 1)
    assert pair.step([]) == ([], [])
    pair.run(evs[1:], 7)


@pytest.mark.parametrize("name", ["two_group_keys", "chain3"])
def test_snapshot_restored_mid_stream(name):
    """A snapshot of the port's engine cut mid-stream resumes in a fresh
    engine, and the continuation equals the reference's uninterrupted run
    (the snapshot's leaves are the reference's: numpy)."""
    evs = events(300, seed=31, syms=4)
    pair = Pair(STREAM + CASES[name])
    ref_rows = pair.run(evs, 50)
    first = Pair(STREAM + CASES[name])
    got = first.run(evs[:150], 50)
    snap = first.port.snapshot_state(first.port_state)
    assert not [x for x in _walk(snap) if isinstance(x, torch.Tensor)]
    second = Pair(STREAM + CASES[name])
    second.port_state = second.port.restore_state(snap)
    second.ref_state = first.ref_state
    if hasattr(second.ref, "nfa"):
        second.ref.nfa.merged.restore_dictionaries(
            first.ref.nfa.merged.snapshot_dictionaries())
    got += second.run(evs[150:], 50)
    assert got == ref_rows


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    else:
        yield tree


@pytest.mark.parametrize("pattern", [
    "from every e1=S[v > 50.0] -> e2=S[v > e1.v]<2:3> "
    "select e1.v as a insert into Out;",
    "from every e1=S[v > 50.0] -> (e2=S[v > 90.0] or e3=S[v < 5.0]) "
    "select e1.v as a insert into Out;",
    "from every e1=S[v > 50.0] -> not S[v > 90.0] for 1 sec "
    "select e1.v as a insert into Out;",
])
def test_non_blocked_shapes_are_refused_with_the_reference_message(pattern):
    rapp, papp = ref_parse(STREAM + pattern), port_parse(STREAM + pattern)
    with pytest.raises(Exception) as ref:
        RefNFA(rapp.execution_elements[0],
               dict(rapp.stream_definitions), backend="numpy")
    with pytest.raises(DeviceCompileError) as got:
        PortNFA(papp.execution_elements[0], dict(papp.stream_definitions),
                host=True)
    assert str(got.value) == str(ref.value) == (
        "count/logical/absent states have no columnar host kernel — "
        "scalar interpreter path")


def test_host_plans_hold_no_device_and_no_kernel_plan():
    papp = port_parse(STREAM + FUZZ[4])
    c = PortNFA(papp.execution_elements[0], dict(papp.stream_definitions),
                host=True)
    assert c.device is None and c.plan is None
    assert all(b.predicate_ir is None for s in c.states for b in s.branches)
    q = PortQuery(port_parse(STREAM + FUZZ[1]).execution_elements[0],
                  papp.stream_definitions["S"], host=True)
    assert q.device is None and q.plan is None
    assert all(ir is None for ir in q.filter_irs)
    with pytest.raises(DeviceCompileError, match="host-form"):
        port_he.HostStreamQuery(PortQuery(
            port_parse(STREAM + FUZZ[1]).execution_elements[0],
            papp.stream_definitions["S"], device="cpu"))
