"""The scan-shape apps and lane-batched cases shared by the scan tests.

``tests/test_torch_nfa_scan.py`` runs every case through the JAX package and
the port; ``chip_smoke.py`` runs the same cases on the card. This module
imports only the port, never the JAX package, so the chip script can load it
where JAX is not installed.

``test_every_shape_takes_the_scan_kernel`` checks each app on its own: the
port compiles it to the scan shape, and its kernel plan (descriptor table and
linked programs) fits the kernel's limits.
"""

import pytest

from siddhi_tpu_torch.compiler import parse
from siddhi_tpu_torch.gpu.nfa import DeviceNFACompiler
from siddhi_tpu_torch.gpu.expr_compile import OP
from siddhi_tpu_torch.gpu.nfa_scan import ScanPlan, clause_form

AB = """
define stream A (sym string, v double, n int);
define stream B (sym string, v double, n int);
"""

# name → (app, outputs computed by f32 arithmetic)
APPS = {
    # ---- count states
    "count_mid": (AB + """
from every e1=A[v > 50.0] -> e2=B[v > e1.v]<2:4> -> e3=A[v < e1.v]
select e1.v as a, e2[0].v as b0, e2[1].v as b1, e2[3].v as b3,
       e2[last].v as bl, e3.v as c insert into O;
""", ()),
    "count_zero_min_first": (AB + """
from every e1=A[v > 30.0]<0:3> -> e2=B[v > 50.0]
select e1[0].v as a, e1[1].n as an, e2.v as b insert into O;
""", ()),
    "count_final": (AB + """
from every e1=A[v > 60.0] -> e2=B[v > 30.0]<2:3>
select e1.v as a, e2[0].v as b, e2[1].v + e1.v as c insert into O;
""", ("c",)),
    "count_final_zero_min": (AB + """
from every e1=A[v > 60.0] -> e2=B[v > 50.0]<0:2>
select e1.v as a, e2[0].v as b insert into O;
""", ()),
    "count_first_guarded": (AB + """
from e1=A[v > 20.0]<1:3> -> e2=B[v > e1[1].v]
select e1[0].v as a, e1[1].v as a1, e2.v as b insert into O;
""", ()),
    # ---- logical states
    "and_first": (AB + """
from every e1=A[v > 40.0] and e2=B[v > 40.0] -> e3=A[v > 80.0]
select e1.v as a, e2.v as b, e3.v as c insert into O;
""", ()),
    "or_mid": (AB + """
from every e1=A[v > 70.0] -> e2=A[v > e1.v] or e3=B[v > 50.0]
  -> e4=B[v < 30.0]
select e1.v as a, e2.v as b, e3.v as c, e4.v as d insert into O;
""", ()),
    "and_mid_final": (AB + """
from every e1=A[v > 50.0] -> e2=A[v > e1.v] and e3=B[v > 60.0]
select e1.v as a, e2.v as b, e3.v as c insert into O;
""", ()),
    "and_not": (AB + """
from every e1=A[v > 60.0] -> e2=B[v > 50.0] and not A[v < 10.0]
  -> e3=B[v > 80.0]
select e1.v as a, e2.v as b, e3.v as c insert into O;
""", ()),
    "or_not_for": (AB + """
from every e1=A[v > 60.0] -> e2=B[v > 80.0] or not A[v > 95.0] for 150 milliseconds
  -> e3=B[v > 20.0]
select e1.v as a, e2.v as b, e3.v as c insert into O;
""", ()),
    "and_not_for": (AB + """
from every e1=A[v > 50.0] -> e2=B[v > 50.0] and not A[v > 97.0] for 100 milliseconds
  -> e3=A[v > 20.0]
select e1.v as a, e2.v as b, e3.v as c insert into O;
""", ()),
    "count_then_or": (AB + """
from every e1=A[v > 40.0]<1:3> -> e2=B[v > 70.0] or e3=A[v < 5.0]
select e1[0].v as a, e2.v as b, e3.v as c insert into O;
""", ()),
    "logical_start_absent": (AB + """
from e1=A[v > 80.0] and not B[v > 90.0] for 100 milliseconds -> e3=B[v > 10.0]
select e1.v as a, e3.v as c insert into O;
""", ()),
    # ---- absent states
    "absent_mid": (AB + """
from every e1=A[v > 50.0] -> not B[v > 80.0] for 100 milliseconds
  -> e3=A[v > e1.v]
select e1.v as a, e3.v as c insert into O;
""", ()),
    "absent_final": (AB + """
from every e1=A[v > 80.0] -> not B[v > 50.0] for 120 milliseconds
select e1.v as a, e1.n as n insert into O;
""", ()),
    "absent_chain": (AB + """
from every e1=A[v > 50.0] -> not B[v > 90.0] for 60 milliseconds
  -> not A[v > 95.0] for 60 milliseconds -> e4=B[v > 10.0]
select e1.v as a, e4.v as d insert into O;
""", ()),
    "absent_start": (AB + """
from not A[v > 90.0] for 100 milliseconds -> e2=B[v > 50.0]
select e2.v as b insert into O;
""", ()),
    "absent_start_every": (AB + """
from every not A[v > 80.0] for 100 milliseconds -> e2=B[v > 50.0]
select e2.v as b insert into O;
""", ()),
    # ---- every scopes
    "group_every": (AB + """
from every (e1=A[v > 50.0] -> e2=B[v > e1.v]) -> e3=A[v > 90.0]
select e1.v as a, e2.v as b, e3.v as c insert into O;
""", ()),
    "mid_every": (AB + """
from e4=A[v > 90.0] -> every (e1=A[v > 20.0] -> e3=B[v > e1.v])
select e4.v as d, e1.v as a, e3.v as c insert into O;
""", ()),
    # ---- sequences
    "sequence_count": (AB + """
from every e1=A[v > 20.0], e2=B[v > 10.0]<1:3>, e3=A[v > 30.0]
select e1.v as a, e2[0].v as b, e3.v as c insert into O;
""", ()),
    "sequence_every": (AB + """
from every e1=A[v > 10.0], e2=A[v > e1.v]<1:2>
select e1.v as a, e2[0].v as b, e2[1].v as b1 insert into O;
""", ()),
    # ---- within, strings, arithmetic
    "within_count": (AB + """
from every e1=A[v > 30.0] -> e2=B[v > e1.v]<1:2> -> e3=A[v > 20.0]
  within 100 milliseconds
select e1.v as a, e2[0].v as b, e3.v as c insert into O;
""", ()),
    # ---- skips: a long run of B events that no live state reads
    "skip_run": (AB + """
from every e1=A[v > 30.0] -> e2=A[v > e1.v]<1:2> -> e3=B[v > 90.0]
  within 150 milliseconds
select e1.v as a, e2[0].v as b, e3.v as c insert into O;
""", ()),
    "string_eq": (AB + """
from every e1=A[sym == 'x' and v > 30.0] -> e2=B[sym == e1.sym]<1:2>
  -> e3=B[v > 40.0]
select e1.sym as s, e2[0].sym as s2, e3.n * e1.n as p, e3.v / e1.v as q
insert into O;
""", ("q",)),
}

# (app, B, C, lanes, ts step max, ts base)
CASES = [
    ("count_mid", 24, 8, 3, 60, None),
    ("count_zero_min_first", 16, 8, 3, 60, None),
    ("count_final", 16, 8, 3, 60, None),
    ("count_final_zero_min", 16, 8, 3, 60, None),
    ("count_first_guarded", 16, 8, 2, 60, None),
    ("and_first", 16, 8, 3, 60, None),
    ("or_mid", 16, 8, 3, 60, None),
    ("and_mid_final", 16, 8, 2, 60, None),
    ("and_not", 16, 8, 3, 60, None),
    ("or_not_for", 24, 8, 3, 60, None),
    ("and_not_for", 24, 8, 3, 60, None),
    ("count_then_or", 16, 8, 2, 60, None),
    ("logical_start_absent", 24, 8, 3, 60, None),
    ("absent_mid", 24, 8, 3, 60, None),
    ("absent_final", 24, 8, 3, 60, None),
    ("absent_chain", 24, 8, 3, 40, None),
    ("absent_start", 16, 8, 3, 60, None),
    ("absent_start_every", 24, 8, 3, 60, None),
    ("group_every", 16, 8, 3, 60, None),
    ("mid_every", 16, 8, 3, 60, None),
    ("sequence_count", 16, 8, 3, 60, None),
    ("sequence_every", 16, 8, 3, 60, None),
    ("within_count", 24, 8, 3, 30, 0),     # ts from 0: the -1 sentinels
    ("string_eq", 16, 8, 3, 60, None),
    ("count_mid", 32, 4, 2, 60, None),     # slot-capacity overflow
    ("count_mid", 32, 256, 2, 60, None),   # 8 slots a thread of the warp
    ("or_mid", 24, 33, 2, 60, None),       # slots not a multiple of 32
    ("skip_run", 64, 16, 2, 30, None),     # TAG_RUN: most events skip
    ("within_count", 32, 8, 1, 30, 0),     # one lane, empty at odd steps
]
IDS = [f"{c[0]}-B{c[1]}-C{c[2]}" for c in CASES]

# apps whose batches carry a long run of one stream: from a quarter of the
# way into each lane's batch, every event's tag is this stream's
TAG_RUN = {"skip_run": 1}


def shape_batch(name: str, wire: tuple) -> tuple:
    """A seeded wire batch ``(cols, tag, ts, ts_base, counts)`` of app
    ``name`` with its ``TAG_RUN`` applied (other apps: unchanged)."""
    if name not in TAG_RUN:
        return wire
    cols, tag, ts, ts_base, counts = wire
    tag = tag.copy()
    tag[:, tag.shape[1] // 4:] = TAG_RUN[name]
    return cols, tag, ts, ts_base, counts



@pytest.mark.parametrize("name", sorted(APPS))
def test_every_shape_takes_the_scan_kernel(name):
    app = parse(APPS[name][0])
    comp = DeviceNFACompiler(app.queries[0], dict(app.stream_definitions),
                             8, 16, device="cpu")
    assert not comp.blocked
    assert isinstance(comp.plan, ScanPlan) and comp.plan.link_error is None
    assert {s for s, _, _ in comp.plan.fields} == set(range(comp.S))


def test_plan_marks_the_programs_that_read_the_event_alone():
    """``evonly`` bit bi (2 + bi for the count-prev program) is set exactly
    where the linked predicate reads no table field: the kernel evaluates
    those once per event instead of once per slot."""
    app = parse(APPS["or_mid"][0])
    comp = DeviceNFACompiler(app.queries[0], dict(app.stream_definitions),
                             8, 16, device="cpu")
    plan = comp.plan
    bind = OP["BIND"]
    for s in range(comp.S):
        st = plan.desc.st[s]
        for bit, p in enumerate((*st.pred, *st.pred_prev)):
            reads = (plan.code_host[p.off:p.off + p.len, 0] == bind).any()
            assert bool(st.evonly >> bit & 1) == (not reads), (s, bit)
    # e1=A[v > 70.0] reads the event; e2=A[v > e1.v] reads its table
    assert plan.desc.st[0].evonly & 1 and not plan.desc.st[1].evonly & 1


def _postfix(rows, base):
    """The clause words decoded back to one postfix program per clause:
    [x (cast), y (cast), compare] with the constant rows resolved."""
    out = []
    for w0, w1 in zip(rows[0::2].tolist(), rows[1::2].tolist()):
        op, cmp_ty, xk, xi = w0
        xc, yk, yi, yc = w1
        prog = []
        for kind, idx, cast in ((xk, xi, xc), (yk, yi, yc)):
            prog.append((kind, "const", idx - base) if kind == OP["CONST"]
                        else (kind, idx))
            if cast >= 0:
                prog.append(("cast", cast >> 8, cast & 255))
        out.append(prog + [(op, cmp_ty)])
    return out


@pytest.mark.parametrize("name", sorted(APPS))
def test_clause_form_is_the_predicate_conjunction(name):
    """Where a predicate has a clause form, its clauses are exactly the
    program's comparisons (operands, casts, constants) joined by ``and``;
    a program with any other operation has none."""
    app = parse(APPS[name][0])
    comp = DeviceNFACompiler(app.queries[0], dict(app.stream_definitions),
                             8, 16, device="cpu")
    plan, code = comp.plan, comp.plan.code_host
    for s in range(comp.S):
        st = plan.desc.st[s]
        for irs, cls in ((st.pred, st.cpred), (st.pred_prev, st.cprev),
                         (st.pred_seed, st.cseed)):
            for bi in range(2):
                ir, cl = irs[bi], cls[bi]
                rows = code[ir.off:ir.off + ir.len]
                ops = set(rows[:, 0].tolist())
                simple = ops <= {OP[n] for n in ("EV", "BIND", "CONST",
                                                 "CAST", "AND", "EQ", "NE",
                                                 "LT", "LE", "GT", "GE")}
                if cl.len == 0:
                    assert ir.len == 0 or not simple or \
                        clause_form(rows, ir.off) is None
                    continue
                words = code[cl.off:cl.off + 2 * cl.len]
                n_cmp = sum(op in {OP[n] for n in ("EQ", "NE", "LT", "LE",
                                                   "GT", "GE")}
                            for op in rows[:, 0].tolist())
                assert simple and cl.len == n_cmp
                for prog in _postfix(words, ir.off):
                    for ins in prog:
                        if ins[0] == OP["CONST"]:
                            assert rows[ins[2], 0] == OP["CONST"]
                        elif ins[0] in (OP["EV"], OP["BIND"]):
                            assert ((rows[:, 0] == ins[0])
                                    & (rows[:, 2] == ins[1])).any()
