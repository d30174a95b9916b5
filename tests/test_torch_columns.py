"""The port's ``core/columns.py`` against the JAX package's.

Each public function and class runs on the same inputs in both packages and
must give the same values, dtypes and counts: ``type_chars``,
``DictColumn``, ``encode_dict_column``, ``column_length``,
``column_tolist``, ``columns_to_rows``, ``RowsChunk``, ``ColumnsOut``,
``CsvColumnParser`` (its native and its Python parser) and
``unpack_columns``. Then the port's own contracts: a dictionary ``restore``
drops ``encode_dict_column``'s cached translation, ``append_columns`` takes
``DictColumn`` chunks as it takes str arrays, and the parser never hides a
native build that fails behind its Python path.
"""

import numpy as np
import pytest

import siddhi_tpu.native as jnative
import siddhi_tpu_torch.native as tnative
from siddhi_tpu.compiler import parse as jparse
from siddhi_tpu.core import columns as J
from siddhi_tpu.tpu.batch import StringDictionary as JDict
from siddhi_tpu.tpu.dcn import pack_rows
from siddhi_tpu_torch.compiler import parse as tparse
from siddhi_tpu_torch.core import columns as T
from siddhi_tpu_torch.gpu.batch import BatchBuilder, BatchSchema
from siddhi_tpu_torch.gpu.batch import StringDictionary as TDict

STREAM = """
define stream S (sym string, n int, big long, p float, q double, ok bool,
                 note string);
"""


def _defs(text=STREAM):
    return (jparse(text).stream_definitions["S"],
            tparse(text).stream_definitions["S"])


def _same_col(a, b) -> None:
    if isinstance(a, J.DictColumn):
        assert isinstance(b, T.DictColumn)
        assert a.codes.dtype == b.codes.dtype
        assert a.codes.tobytes() == b.codes.tobytes()
        assert list(a.values) == list(b.values)
        assert a.tolist() == b.tolist()
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype
    if a.dtype == object:
        assert a.tolist() == b.tolist()
    else:
        assert a.tobytes() == b.tobytes()


def _same_chunks(ja, tb) -> None:
    assert len(ja) == len(tb)
    for a, b in zip(ja, tb):
        assert a.count == b.count and len(a) == len(b)
        assert a.cols.keys() == b.cols.keys()
        for k in a.cols:
            _same_col(a.cols[k], b.cols[k])
        if a.ts is None:
            assert b.ts is None
        else:
            assert a.ts.dtype == b.ts.dtype
            assert a.ts.tobytes() == b.ts.tobytes()
        names = list(a.cols)
        assert a.rows(names) == b.rows(names)
        assert repr(a) == repr(b)


def test_type_chars_and_refusals():
    jd, td = _defs()
    assert T.type_chars(td) == J.type_chars(jd) == "sllddbs"
    text = "define stream S (o object);"
    jo, to = _defs(text)
    for fn, d in ((J.type_chars, jo), (T.type_chars, to)):
        with pytest.raises(TypeError, match="columnar edge"):
            fn(d)


def test_dict_column_and_column_helpers():
    values = [None, "a", "b", "c"]
    codes = np.array([1, 0, 3, 2, 2, 1])
    j, t = J.DictColumn(codes, values), T.DictColumn(codes, values)
    assert len(j) == len(t) == 6
    _same_col(j, t)
    _same_col(j[1:4], t[1:4])
    assert j[1:4].source is j and t[1:4].source is t
    assert j.materialize().tolist() == t.materialize().tolist()
    arr = np.array([1.5, 2.5])
    lst = ["x", None, "y"]
    for col in (j, arr, lst):
        tcol = t if col is j else col
        assert T.column_length(tcol) == J.column_length(col)
        assert T.column_tolist(tcol) == J.column_tolist(col)
    cols_j = {"k": j, "v": np.arange(6) * 0.5}
    cols_t = {"k": t, "v": np.arange(6) * 0.5}
    assert T.columns_to_rows(cols_t, ["v", "k"], 6) == \
        J.columns_to_rows(cols_j, ["v", "k"], 6)
    assert T.columns_to_rows(cols_t, ["k"], 0) == []


def test_encode_dict_column_translates_like_the_reference():
    values = [None, "x", "y", "z"]
    codes = np.array([3, 1, 0, 2, 3])
    jd, td = JDict(), TDict()
    for d in (jd, td):                      # codes the engine already holds
        d.encode("y")
    jc, tc = J.DictColumn(codes, values), T.DictColumn(codes, values)
    a, b = J.encode_dict_column(jc, jd), T.encode_dict_column(tc, td)
    assert a.dtype == b.dtype and a.tolist() == b.tolist()
    # the shared value table grows: the cached translation extends
    values.append("w")
    jc2 = J.DictColumn(np.array([4, 1]), values, source=jc)
    tc2 = T.DictColumn(np.array([4, 1]), values, source=tc)
    a, b = J.encode_dict_column(jc2, jd), T.encode_dict_column(tc2, td)
    assert a.tolist() == b.tolist()
    assert td._values == jd._values


def test_encode_dict_column_cache_dropped_after_a_restore():
    values = [None, "x", "y"]
    col = T.DictColumn(np.array([1, 2, 1]), values)
    d = TDict()
    assert T.encode_dict_column(col, d).tolist() == [1, 2, 1]
    gen = d.generation
    d.restore(["y", "x"])                   # remaps values to codes in place
    assert d.generation == gen + 1
    assert T.encode_dict_column(col, d).tolist() == [2, 1, 2]
    assert [d.decode(c) for c in (2, 1, 2)] == ["x", "y", "x"]


def test_string_dictionary_add_in_sequence():
    d = TDict()
    d.add(1, "a")
    d.add(2, "b")
    assert d.encode("b") == 2 and d.decode(1) == "a" and len(d) == 3
    with pytest.raises(ValueError, match="out-of-sequence"):
        d.add(5, "c")


def test_rows_chunk_and_columns_out():
    ts = np.array([5, 6, 7])
    cols = {"a": np.array([1, 2, 3]), "b": ["u", None, "w"]}
    for chunk in (T.RowsChunk(cols, ts), T.RowsChunk(cols),
                  T.RowsChunk(cols, None, 2)):
        ref = J.RowsChunk(cols, None if chunk.ts is None else ts,
                          2 if chunk.count == 2 else None)
        assert (chunk.count, repr(chunk)) == (ref.count, repr(ref))
        assert chunk.rows(["b", "a"]) == ref.rows(["b", "a"])
    from siddhi_tpu.query_api.definition import DataType as JT
    from siddhi_tpu_torch.query_api.definition import DataType as TT
    jd, td = JDict(), TDict()
    for d in (jd, td):
        for s in ("p", "q"):
            d.encode(s)
    raw = {"s": np.array([2, 0, 1], np.int32), "x": np.array([0.5, 1.5, 2.5])}
    jo = J.ColumnsOut(ts, raw, 3, [("s", None, JT.STRING), ("x", None, JT.DOUBLE)],
                      {"s0_s": jd})
    to = T.ColumnsOut(ts, raw, 3, [("s", None, TT.STRING), ("x", None, TT.DOUBLE)],
                      {"s0_s": td})
    assert to.rows() == jo.rows() == [["q", 0.5], [None, 1.5], ["p", 2.5]]
    for k in ("s", "x"):
        assert to.decoded()[k].tolist() == jo.decoded()[k].tolist()
    assert to.ts_list() == jo.ts_list()


def _csv_payload() -> bytes:
    rng = np.random.default_rng(5)
    lines = []
    for i in range(300):
        sym = ["", "AAPL", "MSFT", "x y"][rng.integers(0, 4)]
        n = ["", "-3", "17", "9x"][rng.integers(0, 4)]
        ok = ["true", "TRUE", "1", "0", "no", ""][rng.integers(0, 6)]
        p = ["1.5", "", "-2.25", "1e-3"][rng.integers(0, 4)]
        fields = [sym, n, str(2 ** 40 + i), p, "0.1", ok, "n%d" % (i % 7),
                  str(1000 + i)]
        if rng.random() < 0.05:
            fields = fields[:-2]
        lines.append(",".join(fields) + ("\r\n" if i % 4 == 0 else "\n"))
    return "".join(lines).encode()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("ts_last,capacity", [(True, 64), (False, 4096)])
def test_csv_parser_equals_the_reference(monkeypatch, native, ts_last,
                                         capacity):
    if native and not tnative.native_available():
        pytest.skip("no C++ toolchain (g++) on this host")
    payload = _csv_payload()
    if not ts_last:                       # no trailing ts field: drop it
        payload = b"".join(line.rsplit(b",", 1)[0] + b"\n"
                           for line in payload.splitlines())
    if not native:
        monkeypatch.setattr(jnative, "native_available", lambda: False)
        monkeypatch.setattr(tnative, "native_available", lambda: False)
    jd, td = _defs()
    jp = J.CsvColumnParser(jd, ts_last=ts_last, capacity=capacity)
    tp = T.CsvColumnParser(td, ts_last=ts_last, capacity=capacity)
    assert jp.ingress == tp.ingress == ("native" if native else "python")
    half = payload.rindex(b"\n", 0, len(payload) // 2) + 1
    for part in (payload[:half], payload[half:]):
        _same_chunks(jp.parse(part), tp.parse(part))
    assert jp.parse_errors == tp.parse_errors > 0
    assert jp.rows_out == tp.rows_out > 0
    assert jp.bytes_in == tp.bytes_in == len(payload)


def test_csv_parser_raises_where_the_native_build_fails(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("native ingress: g++ failed")
    monkeypatch.setattr(tnative, "native_available", lambda: True)
    monkeypatch.setattr(tnative, "NativeIngress", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        T.CsvColumnParser(_defs()[1])


def test_unpack_columns_equals_the_reference():
    rows = [["a", 1, 2 ** 40, 0.5, 2.5, True, None],
            [None, -7, None, None, -1.0, False, "z"],
            ["é", 0, 3, 1.25, 0.0, None, ""]]
    payload = pack_rows("silfdbs", rows, [10, 20, 30])
    jc, jts, jn, jt = J.unpack_columns(payload)
    tc, tts, tn, tt = T.unpack_columns(payload)
    assert (jn, jt) == (tn, tt) == (3, "silfdbs")
    assert jts.tobytes() == tts.tobytes()
    assert jc.keys() == tc.keys()
    for k in jc:
        _same_col(jc[k], tc[k])


def test_append_columns_takes_dict_columns():
    text = "define stream S (sym string, v double, tag string);"
    schema = BatchSchema(tparse(text).stream_definitions["S"])
    values = [None, "b", "a", "c"]
    codes = np.array([1, 2, 0, 3, 1, 2, 2])
    v = np.arange(7) * 1.5
    ts = np.arange(7) + 100
    strs = np.array(values, dtype=object)[codes]
    out = []
    for sym, tag in ((T.DictColumn(codes, values), T.DictColumn(codes[::-1], values)),
                     (strs, strs[::-1])):
        schema = BatchSchema(tparse(text).stream_definitions["S"])
        dic = schema.dictionaries["sym"]
        b = BatchBuilder(schema, 4)
        got = []
        pos = 0
        cols = {"sym": sym, "v": v, "tag": tag}
        while pos < len(ts):
            pos += b.append_columns(cols, ts, start=pos)
            e = b.emit()
            n = e["count"]
            got.append((n, [dic.decode(c) for c in e["cols"]["sym"][:n]],
                        [dic.decode(c) for c in e["cols"]["tag"][:n]],
                        e["cols"]["v"][:n].tolist(), e["ts"][:n].tolist()))
        out.append(got)
    assert out[0] == out[1]
    assert [r[1] for r in out[0]][0] == ["b", "a", None, "c"]
