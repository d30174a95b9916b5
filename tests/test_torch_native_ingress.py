"""The port's native C++ ingress against the JAX package's.

``siddhi_tpu_torch/native`` is a copy of ``siddhi_tpu/native`` with the same
C ABI. The cases of ``tests/test_native_ingress.py`` run here against the
port's ``NativeIngress``; then the same seeded CSV bytes (malformed lines,
``\\r\\n``, empty fields, partial tails, bool spellings, every column type)
go through both libraries and every emitted lane, dictionary code, lane
length, parse-error count and consumed offset must be identical. Through
``PartitionedNFARuntime`` the port's native route gives the reference's
wire feed bit for bit, and stepped (the port's plain version on the CPU
against the JAX ``vstep``) the same rows and state leaves.
"""

import random
import time

import jax
import numpy as np
import pytest

from siddhi_tpu.native import NativeIngress as JIngress
from siddhi_tpu.tpu.partition import PartitionedNFARuntime as JRuntime
from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime as TRuntime
from siddhi_tpu_torch.gpu.partition import _hash_key
from siddhi_tpu_torch.gpu.state_io import state_to_numpy
from siddhi_tpu_torch.native import NativeIngress, native_available

pytestmark = pytest.mark.skipif(
    not native_available(), reason="no C++ toolchain (g++) on this host")


# ---------------------------------------------- tests/test_native_ingress.py

def test_csv_basic_types():
    ing = NativeIngress("sdlib", key_col=-1, n_lanes=1, capacity=16)
    data = b"dev1,3.5,42,7,true\ndev2,-1.25,-9,0,false\n"
    consumed = ing.ingest_csv(data, base_ts=100)
    assert consumed == len(data)
    assert ing.lane_len(0) == 2
    b = ing.emit_lane(0)
    assert b["count"] == 2
    assert ing.decode(int(b["cols"][0][0])) == "dev1"
    assert ing.decode(int(b["cols"][0][1])) == "dev2"
    assert b["cols"][1][0] == 3.5 and b["cols"][1][1] == -1.25
    assert b["cols"][2][0] == 42 and b["cols"][2][1] == -9
    assert b["cols"][3][0] == 7 and b["cols"][3][1] == 0
    assert b["cols"][4][0] == 1 and b["cols"][4][1] == 0
    assert list(b["ts"][:2]) == [100, 101]
    assert b["valid"][:2].all() and not b["valid"][2:].any()


def test_ts_last_column():
    ing = NativeIngress("sd", key_col=-1, n_lanes=1, capacity=8)
    ing.ingest_csv(b"a,1.0,5000\nb,2.0,6000\n", ts_last=True)
    b = ing.emit_lane(0)
    assert list(b["ts"][:2]) == [5000, 6000]


def test_lane_routing_matches_python_crc32():
    ing = NativeIngress("sd", key_col=0, n_lanes=64, capacity=128)
    keys = [f"dev{i}" for i in range(500)] + ["", "unicode-éé"]
    for k in keys:
        assert ing.lane_of(k) == _hash_key(k) % 64, k


def test_lane_routing_on_ingest():
    ing = NativeIngress("sd", key_col=0, n_lanes=4, capacity=64)
    rows = [(f"dev{i}", float(i)) for i in range(40)]
    data = "".join(f"{k},{v}\n" for k, v in rows).encode()
    assert ing.ingest_csv(data) == len(data)
    per_lane = {ln: ing.lane_len(ln) for ln in range(4)}
    expect = {ln: 0 for ln in range(4)}
    for k, _ in rows:
        expect[_hash_key(k) % 4] += 1
    assert per_lane == expect
    b = ing.emit_lane(0)
    for i in range(b["count"]):
        k = ing.decode(int(b["cols"][0][i]))
        assert _hash_key(k) % 4 == 0
        assert b["cols"][1][i] == float(k[3:])


def test_backpressure_partial_consume():
    ing = NativeIngress("sd", key_col=-1, n_lanes=1, capacity=3)
    data = b"a,1\nb,2\nc,3\nd,4\ne,5\n"
    consumed = ing.ingest_csv(data)
    assert consumed == len(b"a,1\nb,2\nc,3\n")
    assert ing.lane_len(0) == 3
    ing.emit_lane(0)
    rest = data[consumed:]
    assert ing.ingest_csv(rest) == len(rest)
    b = ing.emit_lane(0)
    assert b["count"] == 2
    assert ing.decode(int(b["cols"][0][0])) == "d"


def test_malformed_lines_counted_not_fatal():
    ing = NativeIngress("sd", key_col=-1, n_lanes=1, capacity=8)
    data = b"a,1.5\nbad_line\nb,not_a_number\nc,2.5\n"
    assert ing.ingest_csv(data) == len(data)
    assert ing.parse_errors == 2
    b = ing.emit_lane(0)
    assert b["count"] == 2
    assert ing.decode(int(b["cols"][0][1])) == "c"


def test_partial_tail_framing():
    ing = NativeIngress("sd", key_col=-1, n_lanes=1, capacity=8)
    consumed = ing.ingest_csv(b"a,1\nb,2", final=False)
    assert consumed == len(b"a,1\n")
    assert ing.lane_len(0) == 1
    assert ing.ingest_csv(b"b,2\n", final=True) == 4
    assert ing.lane_len(0) == 2


def test_dict_shared_and_stable():
    ing = NativeIngress("ss", key_col=-1, n_lanes=1, capacity=8)
    c1 = ing.encode("hello")
    c2 = ing.encode("world")
    assert ing.encode("hello") == c1
    assert ing.decode(c1) == "hello" and ing.decode(c2) == "world"
    assert ing.decode(0) is None
    ing.ingest_csv(b"hello,world\n")
    b = ing.emit_lane(0)
    assert int(b["cols"][0][0]) == c1 and int(b["cols"][1][0]) == c2


def test_empty_fields_become_none_zero():
    ing = NativeIngress("sd", key_col=-1, n_lanes=1, capacity=8)
    ing.ingest_csv(b",\n")
    b = ing.emit_lane(0)
    assert b["count"] == 1
    assert int(b["cols"][0][0]) == 0 and b["cols"][1][0] == 0.0


def test_throughput_smoke():
    # not a benchmark: the bulk path takes 100k rows in well under 2 s
    ing = NativeIngress("sd", key_col=0, n_lanes=16, capacity=100_000)
    rows = "".join(f"dev{i % 50},{i * 0.5}\n" for i in range(100_000)).encode()
    t0 = time.perf_counter()
    assert ing.ingest_csv(rows) == len(rows)
    dt = time.perf_counter() - t0
    assert sum(ing.lane_len(i) for i in range(16)) == 100_000
    assert dt < 2.0


APP2 = """
define stream S (dev string, v double);
from every e1=S[v > 50.0] -> e2=S[v > e1.v] within 4000
select e1.dev as dev, e1.v as v1, e2.v as v2 insert into Alerts;
"""


def _events(n: int, keys: int, seed: int) -> list:
    rng = random.Random(seed)
    return [(f"dev{rng.randrange(keys)}", round(rng.uniform(0, 100), 3),
             1000 + i) for i in range(n)]


def _csv(events) -> bytes:
    return "".join(f"{d},{v},{t}\n" for d, v, t in events).encode()


def test_partitioned_nfa_native_csv_parity():
    """C++ CSV ingress → the port's partitioned NFA matches its Python
    send() path exactly (same matches, drops and rows)."""
    events = _events(3000, 20, 7)
    kw = dict(num_partitions=8, key_attr="dev", slot_capacity=32,
              lane_batch=64, device="cpu")
    rt_py = TRuntime(APP2, **kw)
    for dev, v, ts in events:
        rt_py.send("S", [dev, v], ts)
    rt_py.flush(decode=True)

    rt_c = TRuntime(APP2, **kw)
    rt_c.enable_native_ingress()
    rows_c = rt_c.ingest_csv(_csv(events), ts_last=True, decode=True)
    rows_c += rt_c.flush_native(decode=True) or []
    assert rt_c.match_count == rt_py.match_count > 0
    assert rt_c.drop_count == rt_py.drop_count
    assert len(rows_c) == rt_c.match_count
    for r in rows_c:
        assert r[0].startswith("dev") and r[2] > r[1] > 50.0


@pytest.mark.parametrize("call", ["send", "send_many"])
def test_host_sends_refused_with_native_ingress(call):
    rt = TRuntime(APP2, num_partitions=2, key_attr="dev", slot_capacity=8,
                  lane_batch=16, device="cpu")
    rt.enable_native_ingress()
    with pytest.raises(RuntimeError, match="native ingress"):
        if call == "send":
            rt.send("S", ["d1", 60.0], 1000)
        else:
            rt.send_many("S", {"dev": np.array(["d1"]),
                               "v": np.array([60.0])}, [1000])


def test_enable_native_ingress_refuses_without_a_toolchain(monkeypatch):
    import siddhi_tpu_torch.native as native
    rt = TRuntime(APP2, num_partitions=2, key_attr="dev", device="cpu")
    monkeypatch.setattr(native, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        rt.enable_native_ingress()


def test_native_ingress_refuses_multi_stream_patterns():
    app = """
define stream A (dev string, v double);
define stream B (dev string, v double);
from every e1=A[v > 50.0] -> e2=B[v > e1.v]
select e1.v as a, e2.v as b insert into O;
"""
    rt = TRuntime(app, num_partitions=2, key_attr="dev", device="cpu")
    with pytest.raises(ValueError, match="single-stream"):
        rt.enable_native_ingress()


# ------------------------------------------- byte parity with the reference

FIELDS = {
    "s": lambda r: r.choice(["", "a", "dev7", "x,y", "é", "k" * 70]),
    "i": lambda r: r.choice(["", "0", "-12", "2147483647", "12x", "7"]),
    "l": lambda r: r.choice(["", "-9", "9007199254740993", "1e3", "42"]),
    "f": lambda r: r.choice(["", "3.5", "-0.25", "1e-3", "nan", "inf",
                             "abc", "1.000000119"]),
    "d": lambda r: r.choice(["", "2.5", "0.1", "-1e308", "1e-310", "3.x"]),
    "b": lambda r: r.choice(["", "true", "TRUE", "True", "1", "0", "false",
                             "yes"]),
}


def _noisy_csv(types: str, n: int, seed: int, ts_last: bool) -> bytes:
    """Seeded CSV lines over ``types`` with malformed lines (wrong field
    counts, bad numbers, too-long fields), ``\\r\\n`` endings, empty lines
    and fields, and no newline after the last line."""
    rng = random.Random(seed)
    lines = []
    for i in range(n):
        fields = [FIELDS[t](rng) for t in types]
        if ts_last:
            fields.append(rng.choice([str(1000 + i), str(1000 + i),
                                      "", "12q"]))
        k = rng.random()
        if k < 0.05:
            fields = fields[:-1]
        elif k < 0.08:
            fields.append("extra")
        elif k < 0.10:
            lines.append("")
        end = "\r\n" if rng.random() < 0.3 else "\n"
        lines.append(",".join(fields) + end)
    return "".join(lines).rstrip("\r\n").encode()


def _drain(ing, wide: bool) -> list:
    return [(ln, ing.lane_len(ln), ing.emit_lane(ln, wide=wide))
            for ln in range(ing.n_lanes)]


def _same_emits(a: list, b: list) -> None:
    assert len(a) == len(b)
    for (la, na, ea), (lb, nb, eb) in zip(a, b):
        assert (la, na, ea["count"]) == (lb, nb, eb["count"])
        for k in ("ts", "tag", "valid"):
            assert ea[k].dtype == eb[k].dtype
            assert ea[k].tobytes() == eb[k].tobytes(), k
        for ca, cb in zip(ea["cols"], eb["cols"]):
            assert ca.dtype == cb.dtype
            assert ca.tobytes() == cb.tobytes()


@pytest.mark.parametrize("types,key_col,lanes,cap,ts_last", [
    ("sifldb", 0, 4, 16, False),
    ("sifldb", 0, 8, 64, True),
    ("dbsl", 2, 3, 5, True),
    ("ss", -1, 1, 1000, False),
])
def test_byte_parity_with_the_reference(types, key_col, lanes, cap, ts_last):
    data = _noisy_csv(types, 400, seed=len(types) * 31 + cap, ts_last=ts_last)
    ings = [cls(types, key_col=key_col, n_lanes=lanes, capacity=cap)
            for cls in (JIngress, NativeIngress)]
    for ing in ings:              # pre-assigned codes, as the runtime replays
        assert ing.encode("dev7") == 1
    offsets = [[], []]
    pos, rounds = 0, 0
    while pos < len(data):
        rounds += 1
        got = [ing.ingest_csv(data, base_ts=500, ts_last=ts_last,
                              final=rounds % 3 == 0, offset=pos)
               for ing in ings]
        assert got[0] == got[1]
        offsets[0].append(got[0])
        assert [i.parse_errors for i in ings[:1]] == \
            [i.parse_errors for i in ings[1:]]
        wide = rounds % 2 == 0
        _same_emits(_drain(ings[0], wide), _drain(ings[1], wide))
        pos += got[0]
    assert ings[0].parse_errors == ings[1].parse_errors > 0
    assert ings[0].dict_size() == ings[1].dict_size() > 2
    for code in range(ings[0].dict_size() + 2):
        assert ings[0].decode(code) == ings[1].decode(code)
    assert rounds > 1


# ----------------------------------------------- the partitioned wire feed

BENCH_APP = """
define stream S (dev string, v double);
partition with (dev of S)
begin
from every e1=S[v > 60.0] -> e2=S[v > e1.v] -> e3=S[v > e2.v] within 4000
select e1.dev as d, e1.v as v1, e2.v as v2, e3.v as v3 insert into Alerts;
end;
"""
KW = dict(num_partitions=8, key_attr="dev", slot_capacity=16, lane_batch=64,
          creation_cap=24)


def _pair():
    j = JRuntime(BENCH_APP, mesh=None, **KW)
    t = TRuntime(BENCH_APP, device="cpu", **KW)
    for rt in (j, t):
        rt.enable_native_ingress()
    return j, t


def test_wire_feed_equals_the_reference_bit_for_bit():
    events = _events(1500, 40, 3)
    data = _csv(events)
    j, t = _pair()
    pos, feeds = 0, 0
    while pos < len(data):
        # a few lines per call or many, so that lanes fill mid-ingest
        end = min(len(data), pos + (700 if feeds % 2 else 9000))
        got = [rt._ning.ingest_csv(data[:end], ts_last=True, offset=pos,
                                   final=end == len(data))
               for rt in (j, t)]
        assert got[0] == got[1]
        pos += got[0]
        a, b = j.emit_native_feed(), t.emit_native_feed()
        assert a.keys() == b.keys() and a["cols"].keys() == b["cols"].keys()
        for k in a["cols"]:
            assert a["cols"][k].dtype == b["cols"][k].dtype
            assert a["cols"][k].tobytes() == b["cols"][k].tobytes(), k
        for k in ("tag", "ts", "ts_base", "counts"):
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes(), k
        assert a["count"] == b["count"]
        feeds += 1
    assert feeds > 3


def _assert_same_state(jrt, trt) -> None:
    ref = jax.tree_util.tree_map(np.asarray, jax.device_get(jrt.state))
    got = state_to_numpy(trt.state)

    def walk(a, b, at=""):
        assert a.keys() == b.keys(), at
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{at}{k}.")
            else:
                assert a[k].dtype == b[k].dtype, f"{at}{k}"
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{at}{k}")
    walk(ref, got)


def test_stepped_native_route_equals_the_reference():
    events = _events(2500, 30, 11)
    data = _csv(events)
    j, t = _pair()
    rows = [rt.ingest_csv(data, ts_last=True, decode=True) for rt in (j, t)]
    assert rows[0] == rows[1]
    _assert_same_state(j, t)
    tail = [rt.flush_native(decode=True) for rt in (j, t)]
    assert tail[0] == tail[1]
    assert j.match_count == t.match_count > 0
    assert j.drop_count == t.drop_count
    assert len(rows[1]) + len(tail[1]) == t.match_count
    _assert_same_state(j, t)
    # the shared dictionary decodes the codes the C++ dictionary minted
    assert {r[0] for r in rows[1] + tail[1]} <= {d for d, _, _ in events}
