"""Columnar chunk payloads and parsers for the columnar edge.

The port's copy of the JAX package's ``core/columns.py``: the vocabulary
that lets chunks of events cross the edge as columns, not rows.

- :class:`RowsChunk` — the columnar transport payload (one dict of numpy
  columns + an int64 timestamp column);
- :class:`DictColumn` — a dictionary-encoded string column (int32 codes +
  a shared append-only value table) with cached code translation into an
  engine ``StringDictionary`` (``gpu/batch.py``), so strings cross the edge
  as integers (``BatchBuilder.append_columns`` takes it);
- :class:`CsvColumnParser` — raw CSV line bytes → columns, through the
  ``native/ingress.cpp`` C ABI where a C++ toolchain exists (parse,
  dictionary-encode and SoA staging all native), else in Python;
- :class:`ColumnsOut` — a query's columnar output chunk (decoded lazily;
  rows materialize only when a consumer needs per-event shape);
- ``unpack_columns`` — the ``pack_rows`` SoA wire format decoded straight
  into columns.

None of the hot functions here construct per-event objects; rows
materialize only in explicit fallback helpers.
"""

from __future__ import annotations

import struct
import time
from typing import Any, Optional

import numpy as np

from ..query_api.definition import DataType, StreamDefinition

# host-side CSV type chars → numpy host policy (NP_HOST): INT/LONG parse as
# int64, FLOAT/DOUBLE as float64 (full precision — the native path uses the
# wide emit, sp_emit_lane_wide), STRING dictionary-encodes, BOOL is uint8
TYPE_CHARS = {
    DataType.STRING: "s",
    DataType.INT: "l",
    DataType.LONG: "l",
    DataType.FLOAT: "d",
    DataType.DOUBLE: "d",
    DataType.BOOL: "b",
}

_CHAR_NP = {"s": np.int32, "l": np.int64, "d": np.float64, "b": np.bool_}


def type_chars(definition: StreamDefinition) -> str:
    """Per-attribute parse type chars for a stream definition."""
    chars = []
    for a in definition.attributes:
        c = TYPE_CHARS.get(a.type)
        if c is None:
            raise TypeError(
                f"attribute '{a.name}': {a.type.value} columns cannot cross "
                f"the columnar edge (host-only)")
        chars.append(c)
    return "".join(chars)


class DictColumn:
    """Dictionary-encoded string column: int32 ``codes`` into an append-only
    ``values`` table (index 0 = None). ``source`` identifies the table owner
    (e.g. the parser) so translations into engine dictionaries cache there.
    """

    __slots__ = ("codes", "values", "source")

    def __init__(self, codes: np.ndarray, values: list, source: Any = None):
        self.codes = np.asarray(codes, dtype=np.int32)
        self.values = values
        self.source = source if source is not None else self

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    def __getitem__(self, item) -> "DictColumn":
        return DictColumn(self.codes[item], self.values, self.source)

    def materialize(self) -> np.ndarray:
        """→ object array of the decoded values (None for code 0)."""
        table = np.empty(len(self.values), dtype=object)
        table[:] = self.values
        return table[np.clip(self.codes, 0, len(self.values) - 1)]

    def tolist(self) -> list:
        vals = self.values
        return [vals[c] for c in self.codes.tolist()]


def encode_dict_column(col: DictColumn, dictionary) -> np.ndarray:
    """Translate a :class:`DictColumn`'s codes into ``dictionary`` codes via
    a cached per-(source, dictionary) translation table — one ``np.take``
    per chunk, no per-row Python."""
    src = col.source
    cache = getattr(src, "_dict_trans", None)
    if cache is None:
        cache = {}
        try:
            src._dict_trans = cache
        except AttributeError:      # pragma: no cover — frozen source
            pass
    key = id(dictionary)
    gen = getattr(dictionary, "generation", 0)
    got = cache.get(key)
    trans = got[1] if got is not None and got[0] == gen else None
    # a dictionary RESTORE remaps values→codes in place (generation bump):
    # a cached translation would then silently emit the old codes, so a
    # generation mismatch drops the cache wholesale
    nv = len(col.values)
    if trans is None or trans.shape[0] < nv:
        old = 0 if trans is None else trans.shape[0]
        ext = np.empty(nv, dtype=np.int32)
        if old:
            ext[:old] = trans
        for i in range(old, nv):
            ext[i] = dictionary.encode(col.values[i])
        trans = ext
        cache[key] = (gen, trans)
    return trans[np.clip(col.codes, 0, nv - 1)]


def column_length(col) -> int:
    if isinstance(col, DictColumn):
        return len(col)
    if isinstance(col, np.ndarray):
        return int(col.shape[0])
    return len(col)


def column_tolist(col) -> list:
    if isinstance(col, DictColumn):
        return col.tolist()
    if isinstance(col, np.ndarray):
        return col.tolist()
    return list(col)


def columns_to_rows(cols: dict, names: list, n: int) -> list[list]:
    """Materialize per-event row lists from a columns dict — the explicit
    fallback for non-columnar consumers (NOT the hot path)."""
    if n == 0:
        return []
    py = [column_tolist(cols[name]) for name in names]
    return [list(r) for r in zip(*py)]


class RowsChunk:
    """One columnar transport chunk: ``cols`` maps attribute name →
    numpy array / :class:`DictColumn`; ``ts`` is int64 per-row event time
    (None → the engine stamps ingestion time at ``send_columns``)."""

    __slots__ = ("cols", "ts", "count")

    def __init__(self, cols: dict, ts: Optional[np.ndarray] = None,
                 count: Optional[int] = None):
        self.cols = cols
        self.ts = None if ts is None else np.asarray(ts, dtype=np.int64)
        if count is None:
            count = int(self.ts.shape[0]) if self.ts is not None \
                else (column_length(next(iter(cols.values()))) if cols else 0)
        self.count = count

    def __len__(self) -> int:
        return self.count

    def rows(self, names: list) -> list[list]:
        return columns_to_rows(self.cols, names, self.count)

    def __repr__(self) -> str:
        return f"RowsChunk({self.count} rows x {len(self.cols)} cols)"


class ColumnsOut:
    """A query's columnar output chunk: raw plan columns (strings still
    dictionary codes) + the specs/dictionaries that decode them. Decoding
    and row materialization are lazy — the zero-object egress hands
    ``decoded()`` columns to rows-capable sinks and never builds rows."""

    __slots__ = ("ts", "cols", "n", "specs", "dictionaries",
                 "_decoded", "_rows")

    def __init__(self, ts: np.ndarray, cols: dict, n: int, specs: list,
                 dictionaries: dict):
        self.ts = ts
        self.cols = cols
        self.n = n
        self.specs = specs              # [(name, fn, DataType)]
        self.dictionaries = dictionaries
        self._decoded = None
        self._rows = None

    def decoded(self) -> dict:
        """{name: numpy column} with dictionary codes decoded to value
        object arrays — the payload ``StreamJunction.deliver_columns``
        carries to rows-capable receivers."""
        if self._decoded is None:
            out = {}
            table = None
            for dic in self.dictionaries.values():
                table = dic
                break
            for (name, _fn, t) in self.specs:
                v = self.cols[name]
                if t == DataType.STRING and table is not None:
                    vals = np.empty(len(table._values), dtype=object)
                    vals[:] = table._values
                    codes = np.clip(np.asarray(v, np.int64), 0,
                                    len(vals) - 1)
                    out[name] = vals[codes]
                else:
                    out[name] = np.asarray(v)
            self._decoded = out
        return self._decoded

    def rows(self) -> list[list]:
        if self._rows is None:
            from ..gpu.host_exec import decode_columns
            self._rows = decode_columns(self.specs, self.cols,
                                        self.dictionaries)
        return self._rows

    def ts_list(self) -> list:
        return np.asarray(self.ts).tolist()


def _py_bool(field: bytes) -> bool:
    return field.lower() == b"true" or field == b"1"


class CsvColumnParser:
    """Raw CSV line bytes → :class:`RowsChunk` list.

    Native path (``native/ingress.cpp`` via ctypes): parse, dictionary
    encode and SoA staging run in C++; Python only wraps the emitted numpy
    arrays (wide emit — doubles keep float64 for interpreter parity).
    The Python parser runs only where no toolchain exists
    (``native_available()`` is False): same column layout, same
    malformed-line accounting, built from per-line splits.

    ``ts_last=True`` reads a trailing int64 event-time field per line
    (the bench corpus / DCN convention); otherwise ``ts`` is None and the
    engine stamps arrival time.
    """

    def __init__(self, definition: StreamDefinition, ts_last: bool = False,
                 capacity: int = 65536):
        self.definition = definition
        self.types = type_chars(definition)
        self.names = definition.attribute_names
        self.ts_last = ts_last
        self.capacity = int(capacity)
        self.rows_out = 0
        self.bytes_in = 0
        self.parse_seconds = 0.0
        self._t_first = None
        self._py_errors = 0
        self._ning = None
        self._values: list = [None]     # native dict mirror (code 0 = None)
        self.ingress = "python"
        from ..native import NativeIngress, native_available
        if native_available():
            # where a toolchain exists a failed build raises: the Python
            # parser is for hosts without one, never a quiet fallback
            self._ning = NativeIngress(self.types, key_col=-1, n_lanes=1,
                                       capacity=self.capacity)
            self.ingress = "native"

    @property
    def parse_errors(self) -> int:
        if self._ning is not None:
            return int(self._ning.parse_errors) + self._py_errors
        return self._py_errors

    @property
    def rows_per_s(self) -> float:
        return self.rows_out / self.parse_seconds if self.parse_seconds \
            else 0.0

    def parse(self, payload: bytes) -> list[RowsChunk]:
        """Whole lines only (the caller frames torn tails); returns the
        parsed chunks (several when a payload overflows one staging
        buffer)."""
        t0 = time.perf_counter()
        self.bytes_in += len(payload)
        if self._ning is not None:
            chunks = self._parse_native(payload)
        else:
            chunks = self._parse_python(payload)
        self.parse_seconds += time.perf_counter() - t0
        for ch in chunks:
            self.rows_out += ch.count
        return chunks

    # -- native ------------------------------------------------------------
    def _sync_values(self) -> None:
        ning = self._ning
        ds = int(ning.dict_size())
        vals = self._values
        while len(vals) < ds:
            vals.append(ning.decode(len(vals)))

    def _parse_native(self, payload: bytes) -> list[RowsChunk]:
        ning = self._ning
        chunks: list[RowsChunk] = []
        pos, total = 0, len(payload)
        while pos < total:
            consumed = ning.ingest_csv(payload, ts_last=self.ts_last,
                                       final=True, offset=pos)
            pos += consumed
            n = int(ning.lane_len(0))
            if n == 0:
                if consumed == 0:
                    break               # nothing staged, nothing consumed
                continue
            b = ning.emit_lane(0, wide=True)
            self._sync_values()
            cols: dict[str, Any] = {}
            for i, (name, t) in enumerate(zip(self.names, self.types)):
                arr = b["cols"][i][:n]
                if t == "s":
                    cols[name] = DictColumn(arr, self._values, source=self)
                else:
                    cols[name] = arr
            chunks.append(RowsChunk(
                cols, b["ts"][:n] if self.ts_last else None, n))
        return chunks

    # -- pure python -------------------------------------------------------
    def _parse_python(self, payload: bytes) -> list[RowsChunk]:
        names, types = self.names, self.types
        ncols = len(types)
        expected = ncols + (1 if self.ts_last else 0)
        raw_cols: list[list] = [[] for _ in range(ncols)]
        tss: list[int] = []
        for line in payload.split(b"\n"):
            if line.endswith(b"\r"):
                line = line[:-1]
            if not line:
                continue
            fields = line.split(b",")
            if len(fields) != expected:
                self._py_errors += 1
                continue
            try:
                vals = []
                for f, t in zip(fields, types):
                    if t == "s":
                        vals.append(f.decode() if f else None)
                    elif not f:
                        vals.append(0 if t != "d" else 0.0)
                    elif t == "d":
                        vals.append(float(f))
                    elif t == "l":
                        vals.append(int(f))
                    else:                   # 'b'
                        vals.append(_py_bool(f))
                ts = int(fields[ncols]) if self.ts_last else 0
            except ValueError:
                self._py_errors += 1
                continue
            for c, v in zip(raw_cols, vals):
                c.append(v)
            tss.append(ts)
        n = len(tss)
        if n == 0:
            return []
        cols: dict[str, Any] = {}
        for name, t, vals in zip(names, types, raw_cols):
            if t == "s":
                arr = np.empty(n, dtype=object)
                arr[:] = vals
                cols[name] = arr
            else:
                cols[name] = np.asarray(vals, dtype=_CHAR_NP[t])
        out = [RowsChunk(cols, np.asarray(tss, np.int64)
                         if self.ts_last else None, n)]
        return out


# ---------------------------------------------------------------------------
# pack_rows wire format → columns (the JAX package's tpu/dcn.py layout)
# ---------------------------------------------------------------------------

_NUM_DT = {"f": ">f4", "d": ">f8", "i": ">i4", "l": ">i8", "b": ">u1"}


def unpack_columns(payload: bytes) -> tuple[dict, np.ndarray, int, str]:
    """Decode one ``pack_rows`` SoA payload straight into
    positional columns: returns ``({index: column}, ts, n, types)``. Numeric
    columns are zero-copy ``np.frombuffer`` views converted to host dtypes;
    string columns decode through their offset table."""
    n, ncols = struct.unpack_from(">IB", payload, 0)
    off = 5
    types = payload[off:off + ncols].decode("ascii")
    off += ncols
    ts = np.frombuffer(payload, dtype=">i8", count=n, offset=off) \
        .astype(np.int64)
    off += 8 * n
    cols: dict[int, Any] = {}
    for ci, t in enumerate(types):
        nulls = np.frombuffer(payload, dtype=np.uint8, count=n, offset=off) \
            .astype(bool)
        off += n
        if t == "s":
            offs = np.frombuffer(payload, dtype=">u4", count=n + 1,
                                 offset=off).astype(np.int64)
            off += 4 * (n + 1)
            blob = payload[off:off + int(offs[-1])]
            off += int(offs[-1])
            vals = np.empty(n, dtype=object)
            for i in range(n):          # string decode is inherently per-row
                vals[i] = None if nulls[i] \
                    else blob[offs[i]:offs[i + 1]].decode()
            cols[ci] = vals
        else:
            arr = np.frombuffer(payload, dtype=_NUM_DT[t], count=n,
                                offset=off)
            off += arr.dtype.itemsize * n
            host = arr.astype(_CHAR_NP["d" if t in ("f", "d") else
                                       ("l" if t in ("i", "l") else "b")])
            if nulls.any():
                host = host.copy()
                host[nulls] = 0
            cols[ci] = host
    return cols, ts, int(n), types
