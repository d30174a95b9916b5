"""Host staging for device batches: string dictionaries, the single-stream
schema and batch builder, and device-state checkpoints.

Port of the reference's ``tpu/batch.py``: strings are dictionary-encoded to
int32 codes on the host (code 0 = None), so string equality on the card is
an int32 compare; rows pack into fixed-capacity numpy columns (one per
attribute, dtype per ``dtypes.NP``) plus an int64 timestamp column and a
validity mask. Numpy staging, unchanged; the step moves the columns to the
device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..query_api.definition import DataType, StreamDefinition


class StringDictionary:
    """Host-side string→code dictionary (per attribute).

    Code 0 is reserved for None/unknown so device comparisons against missing
    values are always false for real codes.
    """

    def __init__(self):
        self._codes: dict[str, int] = {}
        self._values: list[Optional[str]] = [None]
        # sorted lookup cache for encode_array (rebuilt when values grow)
        self._cache_len = 0
        self._sorted_vals = None
        self._sorted_codes = None
        # bumped by every in-place restore(): translation caches keyed on it
        # (core/columns.py::encode_dict_column) drop what they hold, since
        # append-only growth keeps cached prefixes valid and a restore does
        # not
        self.generation = 0

    def encode(self, s: Optional[str]) -> int:
        if s is None:
            return 0
        c = self._codes.get(s)
        if c is None:
            c = len(self._values)
            self._codes[s] = c
            self._values.append(s)
        return c

    def decode(self, code: int) -> Optional[str]:
        if 0 <= code < len(self._values):
            return self._values[code]
        return None

    def add(self, code: int, value: str) -> None:
        """Registers an externally minted (code, value) pair: the entries the
        native ingress dictionary assigned. Codes must arrive in sequence."""
        if code != len(self._values):
            raise ValueError(
                f"out-of-sequence dictionary code {code} (next is "
                f"{len(self._values)})")
        self._codes[value] = code
        self._values.append(value)

    def __len__(self) -> int:
        return len(self._values)

    def encode_array(self, values) -> np.ndarray:
        """Vectorized encode of a string array via a sorted lookup cache:
        ``searchsorted`` against the known values, with only UNSEEN values
        taking the Python ``encode`` path."""
        arr = np.asarray(values)
        nulls = None
        if arr.dtype == object:
            # None must stay code 0 (encode()'s null semantics) — astype("U")
            # would mint a real code for the literal string 'None'
            if any(x is None for x in arr.flat):
                nulls = np.array([x is None for x in arr.flat],
                                 dtype=bool).reshape(arr.shape)
                arr = np.where(nulls, "", arr).astype("U")
            else:
                arr = arr.astype("U")
        sv, sc = self._sorted_lookup()
        pos = np.searchsorted(sv, arr)
        posc = np.clip(pos, 0, max(sv.size - 1, 0))
        hit = (sv[posc] == arr) if sv.size else np.zeros(arr.shape, bool)
        miss = ~hit if nulls is None else (~hit & ~nulls)
        if miss.any():
            for u in np.unique(arr[miss]):
                self.encode(str(u))
            sv, sc = self._sorted_lookup()
            pos = np.searchsorted(sv, arr)
            posc = np.clip(pos, 0, sv.size - 1)
        codes = sc[posc]
        if nulls is not None:
            codes = np.where(nulls, np.int32(0), codes)
        return codes

    def _sorted_lookup(self):
        if self._cache_len != len(self._values):
            known = np.array(self._values[1:], dtype="U")
            order = np.argsort(known)
            self._sorted_vals = known[order]
            self._sorted_codes = (order + 1).astype(np.int32)
            self._cache_len = len(self._values)
        return self._sorted_vals, self._sorted_codes

    def snapshot(self) -> list:
        """Code-ordered value table (code 0 = None elided)."""
        return list(self._values[1:])

    def restore(self, values: list) -> None:
        self._values = [None] + list(values)
        self._codes = {v: i + 1 for i, v in enumerate(values)}
        self._cache_len = 0          # sorted lookup rebuilt on next encode
        self.generation += 1         # external translation caches drop


def snapshot_dictionaries(dictionaries: dict) -> dict:
    """Serializes a column→dictionary map, emitting each shared dictionary
    object once (under its first column name)."""
    out, seen = {}, set()
    for name, d in dictionaries.items():
        if id(d) in seen:
            continue
        seen.add(id(d))
        out[name] = d.snapshot()
    return out


def restore_dictionaries(dictionaries: dict, snap: dict) -> None:
    """Restores in place; sharing structure comes from the live schema, so
    each snapshotted table lands in every column that shares it."""
    for name, values in snap.items():
        d = dictionaries.get(name)
        if d is not None:
            d.restore(values)


def device_state_snapshot(state: dict, dict_owner,
                          single_lane: bool = False) -> dict:
    """Device-runtime checkpoint: the state tree fetched to numpy (its lane
    dim of 1 dropped when ``single_lane``) plus the string dictionary that
    decodes its codes. ``dict_owner`` is any object with
    ``snapshot_dictionaries()``/``restore_dictionaries()``."""
    from .state_io import state_to_numpy
    return {"device": state_to_numpy(state, single_lane),
            "dict": dict_owner.snapshot_dictionaries()}


def device_state_restore(snap, dict_owner, load) -> dict:
    """Inverse of ``device_state_snapshot`` (a bare numpy tree is accepted
    too, as the reference accepts its pre-dictionary shape): restores the
    dictionaries and returns ``load(numpy tree)``, the state on the
    device."""
    if isinstance(snap, dict) and "device" in snap:
        dict_owner.restore_dictionaries(snap.get("dict", {}))
        snap = snap["device"]
    return load(snap)


@dataclass
class BatchSchema:
    """Column layout for one stream."""

    definition: StreamDefinition
    dictionaries: dict[str, StringDictionary] = field(default_factory=dict)

    def __post_init__(self):
        # one shared dictionary: codes comparable across string columns
        shared = None
        for a in self.definition.attributes:
            if a.type == DataType.STRING:
                if shared is None:
                    shared = self.dictionaries.get(a.name) or StringDictionary()
                self.dictionaries.setdefault(a.name, shared)

    @property
    def names(self) -> list[str]:
        return self.definition.attribute_names

    def np_dtype(self, name: str) -> np.dtype:
        t = self.definition.attribute_type(name)
        if t == DataType.OBJECT:
            raise TypeError(
                f"attribute '{name}': OBJECT attributes are host-only and cannot "
                "enter the device path")
        from .dtypes import NP
        return np.dtype(NP[t])

    def encode_value(self, name: str, v: Any):
        enc = self.encoders.get(name)
        if enc is not None:                    # string column
            return enc(v)
        if v is None:
            return 0
        return v

    @property
    def encoders(self) -> dict:
        """Per-attribute string encoders, resolved once per schema."""
        e = self.__dict__.get("_encoders")
        if e is None:
            e = self.__dict__["_encoders"] = {
                a.name: self.dictionaries[a.name].encode
                for a in self.definition.attributes
                if a.type == DataType.STRING}
        return e

    def snapshot_dictionaries(self) -> dict:
        return snapshot_dictionaries(self.dictionaries)

    def restore_dictionaries(self, snap: dict) -> None:
        restore_dictionaries(self.dictionaries, snap)


class BatchBuilder:
    """Accumulates rows into numpy staging buffers; emits padded micro-batches.

    Values past ``count`` in an emitted batch are stale leftovers of earlier
    batches, exactly as in the reference."""

    def __init__(self, schema: BatchSchema, capacity: int):
        self.schema = schema
        self.capacity = capacity
        self._cols = {
            n: np.zeros(capacity, dtype=schema.np_dtype(n)) for n in schema.names
        }
        self._ts = np.zeros(capacity, dtype=np.int64)
        self._n = 0
        # wall clock of the first append since the last emit (``pack_s``)
        self._pack_t0 = None

    def __len__(self) -> int:
        return self._n

    @property
    def full(self) -> bool:
        return self._n >= self.capacity

    def append(self, row: list, ts: int) -> None:
        if self._n >= self.capacity:
            raise OverflowError("micro-batch full; call emit() first")
        i = self._n
        if self._pack_t0 is None:
            self._pack_t0 = time.perf_counter()
        for name, v in zip(self.schema.names, row):
            self._cols[name][i] = self.schema.encode_value(name, v)
        self._ts[i] = ts
        self._n += 1

    def append_rows(self, rows: list[list], ts_list) -> None:
        for row, ts in zip(rows, ts_list):
            self.append(row, ts)

    def append_columns(self, cols: dict, ts, start: int = 0) -> int:
        """Bulk slice-copy of a columnar chunk (``{name: numpy array |
        DictColumn}``; string columns as arrays of str, encoded through the
        dictionary, or as ``DictColumn`` codes, translated through a cached
        table) into the staging buffers, starting at row ``start`` of the
        chunk; returns how many rows fit (the caller emits and resumes past
        them)."""
        ts = np.asarray(ts, dtype=np.int64)
        n = int(ts.shape[0]) - start
        if n <= 0:
            return 0
        take = min(n, self.capacity - self._n)
        if take <= 0:
            return 0
        if self._pack_t0 is None:
            self._pack_t0 = time.perf_counter()
        i = self._n
        from ..core.columns import DictColumn, encode_dict_column
        for name in self.schema.names:
            col = cols[name]
            dst = self._cols[name]
            if isinstance(col, DictColumn):
                dic = self.schema.dictionaries.get(name)
                part = col[start:start + take]
                dst[i:i + take] = encode_dict_column(part, dic) \
                    if dic is not None else part.codes
                continue
            arr = col[start:start + take]
            if not isinstance(arr, np.ndarray) or arr.dtype == object \
                    or arr.dtype.kind == "U":
                enc = self.schema.dictionaries.get(name)
                if enc is not None:
                    dst[i:i + take] = enc.encode_array(
                        np.asarray(arr, dtype=object))
                else:
                    dst[i:i + take] = [
                        self.schema.encode_value(name, v) for v in arr]
            else:
                dst[i:i + take] = arr
        self._ts[i:i + take] = ts[start:start + take]
        self._n += take
        return take

    def emit(self) -> dict:
        """Returns ``{'cols': {name: np[capacity]}, 'ts', 'valid', 'count',
        'last_ts', 'pack_s', 'pack_exec_s', '_t_emit'}`` (the reference's
        keys: the pack span since the first append, the copy's own time and
        the emit instant) and resets. Arrays are padded to capacity."""
        t_emit0 = time.perf_counter()
        valid = np.zeros(self.capacity, dtype=bool)
        valid[: self._n] = True
        out = {
            "cols": {n: self._cols[n].copy() for n in self.schema.names},
            "ts": self._ts.copy(),
            "valid": valid,
            "count": self._n,
            "last_ts": int(self._ts[self._n - 1]) if self._n else 0,
            "pack_s": (t_emit0 - self._pack_t0
                       if self._pack_t0 is not None else 0.0),
        }
        t_emit = time.perf_counter()
        out["pack_exec_s"] = t_emit - t_emit0
        out["_t_emit"] = t_emit
        self._n = 0
        self._pack_t0 = None
        return out

    def snapshot(self) -> dict:
        """Staged-but-unemitted rows."""
        n = self._n
        return {
            "cols": {k: v[:n].copy() for k, v in self._cols.items()},
            "ts": self._ts[:n].copy(),
            "n": n,
        }

    def restore(self, snap: dict) -> None:
        n = snap["n"]
        self._n = n
        for k, v in snap["cols"].items():
            self._cols[k][:n] = v
        self._ts[:n] = snap["ts"]
        if n:                   # restored rows re-arm the pack clock
            self._pack_t0 = time.perf_counter()


def columns_from_rows(schema: BatchSchema, rows: list[list],
                      ts_list: list[int], capacity: Optional[int] = None) -> dict:
    """One-shot convenience: rows → padded column batch."""
    cap = capacity or len(rows)
    b = BatchBuilder(schema, cap)
    b.append_rows(rows, ts_list)
    return b.emit()
