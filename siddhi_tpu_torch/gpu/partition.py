"""Partitioned execution: per-key NFA state on L lanes of one GPU.

Port of the reference's ``tpu/partition.py`` for one device (``mesh=None``).
Keys hash to L partition lanes; each lane owns fixed-capacity match tables.
Events are routed on the host to their lane's sub-batch; on the card the
lane axis is the kernel's grid (one CTA per lane), so nothing crosses lanes.
Both step shapes run here: the blocked chain (``nfa_block``) and the
per-event scan (``nfa_scan``); absent states are refused under a partition,
as the reference refuses them.
Native CSV ingress and lanes spread over several GPUs are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..compiler import parse as _parse
from .backend import resolve_device
from .expr_compile import DeviceCompileError
from .nfa import DeviceNFACompiler, MergedBatchBuilder


def _hash_key(v) -> int:
    import zlib
    # stable across processes (hash() randomization would break resumed
    # checkpoints whose lane assignment must match)
    return zlib.crc32(str(v).encode()) & 0x7FFFFFFF


def _inject_key_equality(query, key_attr: str):
    """Per-KEY pattern semantics on shared lanes.

    A lane owns every key hashing to it, so the lane-local NFA sees several
    keys' events interleaved. Every state after the first carries an
    implicit ``key == e1.key`` filter, so a partial only advances on its own
    key's events. Sequences (strict continuity is per key) and patterns
    whose first state binds no alias take the host path.
    """
    import copy

    from ..query_api import (
        Compare,
        CompareOp,
        CountStateElement,
        EveryStateElement,
        Filter,
        LogicalStateElement,
        NextStateElement,
        StateInputStream,
        StateInputStreamType,
        StreamStateElement,
        Variable,
    )

    ist = query.input_stream
    if not isinstance(ist, StateInputStream):
        return query
    if ist.type == StateInputStreamType.SEQUENCE:
        raise DeviceCompileError(
            "partitioned sequences need per-key strictness (host path)")
    query = copy.deepcopy(query)
    ist = query.input_stream

    elements: list = []

    def walk(el):
        if isinstance(el, NextStateElement):
            walk(el.first)
            walk(el.next)
        elif isinstance(el, EveryStateElement):
            walk(el.inner)
        elif isinstance(el, (StreamStateElement, CountStateElement,
                             LogicalStateElement)):
            elements.append(el)
        else:
            raise DeviceCompileError(
                f"partitioned {type(el).__name__} needs the host path")

    walk(ist.state)
    first = elements[0]
    if isinstance(first, LogicalStateElement):
        raise DeviceCompileError(
            "partitioned pattern starting with a logical state needs the "
            "host path")
    stream0 = first.stream if isinstance(first, StreamStateElement) \
        else first.stream.stream
    anchor = stream0.alias
    if anchor is None:
        raise DeviceCompileError(
            "partitioned pattern needs an alias on its first state")

    def constrain(stream):
        stream.handlers.append(Filter(Compare(
            Variable(key_attr), CompareOp.EQ,
            Variable(key_attr, stream_id=anchor))))

    for el in elements[1:]:
        if isinstance(el, StreamStateElement):
            constrain(el.stream)
        elif isinstance(el, CountStateElement):
            constrain(el.stream.stream)
        else:                       # logical: both branches
            for sub in (el.first, el.second):
                constrain(sub.stream)
    return query


class PartitionedNFARuntime:
    """L-lane partitioned pattern matching on one device.

    ``partition with (<key> of <stream>)`` over a pattern query: every lane
    runs the compiled NFA independently on its key subset. ``device`` is the
    card unless the caller passes ``"cpu"`` (the plain version); with no card
    and no explicit ``"cpu"`` the constructor raises.
    """

    def __init__(self, app_or_text, num_partitions: int,
                 key_attr: str,
                 slot_capacity: int = 32,
                 lane_batch: int = 256,
                 query_index: int = 0,
                 creation_cap: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        app = _parse(app_or_text) if isinstance(app_or_text, str) else app_or_text
        # partition queries may live inside a `partition with` block
        if app.queries:
            query = app.queries[query_index]
        else:
            query = app.partitions[0].queries[query_index]
        self.P = num_partitions
        self.key_attr = key_attr
        self.lane_batch = lane_batch
        query = _inject_key_equality(query, key_attr)
        self.compiler = DeviceNFACompiler(
            query, dict(app.stream_definitions), slot_capacity, lane_batch,
            creation_cap=creation_cap, device=self.device)
        self.stream_defs = dict(app.stream_definitions)
        self.builders = [
            MergedBatchBuilder(self.compiler.merged, lane_batch,
                               self.stream_defs,
                               used_cols=self.compiler.used_cols)
            for _ in range(num_partitions)
        ]
        # lane-batched step over [P, ...] state and batches; on the card it
        # updates the state in place (the analog of the reference's donation)
        self.vstep = self.compiler.make_step()
        self.state = self.init_state()
        self.callback: Optional[Callable[[list[list]], None]] = None

    def init_state(self) -> dict:
        """Fresh [P, ...]-stacked lane state."""
        return self.compiler.init_state(self.P)

    def lane_of(self, key) -> int:
        return _hash_key(key) % self.P

    def send(self, stream_id: str, row: list, timestamp: int) -> None:
        d = self.stream_defs[stream_id]
        key = row[d.attribute_position(self.key_attr)]
        b = self.builders[self.lane_of(key)]
        b.append(stream_id, row, timestamp)
        if b.full:
            self.flush()

    def encode_columns(self, stream_id: str, cols: dict) -> dict:
        """Dictionary-encode string columns on their DISTINCT values."""
        from ..query_api.definition import DataType
        d = self.stream_defs[stream_id]
        si = self.compiler.merged.stream_index[stream_id]
        enc = {}
        for a in d.attributes:
            v = cols.get(a.name)
            if v is None:
                continue
            if a.type == DataType.STRING:
                dic = self.compiler.merged.dictionaries[f"s{si}_{a.name}"]
                enc[a.name] = dic.encode_array(v)
            else:
                enc[a.name] = np.asarray(v)
        return enc

    def route_lanes(self, keys) -> np.ndarray:
        """Vectorized key→lane routing: crc32 runs once per DISTINCT key,
        cached in a sorted lookup (searchsorted per batch)."""
        arr = np.asarray(keys)
        if arr.dtype == object:
            arr = arr.astype("U")
        sv = getattr(self, "_route_vals", None)
        if sv is None:
            sv = np.array([], dtype=arr.dtype)
            self._route_vals, self._route_lanes = sv, np.array([], np.int32)
        pos = np.searchsorted(sv, arr)
        posc = np.clip(pos, 0, max(sv.size - 1, 0))
        hit = (sv[posc] == arr) if sv.size else np.zeros(arr.shape, bool)
        if not hit.all():
            fresh = np.unique(arr[~hit])
            fresh_lanes = np.fromiter(
                ((_hash_key(str(u)) % self.P) for u in fresh),
                dtype=np.int32, count=len(fresh))
            allv = np.concatenate([sv, fresh])
            lanes_all = np.concatenate([self._route_lanes, fresh_lanes])
            order = np.argsort(allv, kind="stable")
            self._route_vals = allv[order]
            self._route_lanes = lanes_all[order]
            sv = self._route_vals
            pos = np.searchsorted(sv, arr)
            posc = np.clip(pos, 0, sv.size - 1)
        return self._route_lanes[posc]

    def _lanes_for(self, stream_id: str, cols: dict, enc: dict) -> np.ndarray:
        """Lane array for a bulk send: string keys route via their already-
        computed dictionary codes (one code→lane table lookup), other key
        types via the sorted route cache."""
        from ..query_api.definition import DataType
        d = self.stream_defs[stream_id]
        if d.attribute_type(self.key_attr) == DataType.STRING and \
                self.key_attr in enc:
            si = self.compiler.merged.stream_index[stream_id]
            dic = self.compiler.merged.dictionaries[f"s{si}_{self.key_attr}"]
            tbl = getattr(self, "_lane_by_code", None)
            if tbl is None:
                tbl = np.zeros(1, np.int32)
            if len(tbl) < len(dic):
                ext = np.fromiter(
                    ((_hash_key(dic.decode(c)) % self.P)
                     for c in range(len(tbl), len(dic))),
                    dtype=np.int32, count=len(dic) - len(tbl))
                tbl = np.concatenate([tbl, ext])
                self._lane_by_code = tbl
            return tbl[enc[self.key_attr]]
        return self.route_lanes(cols[self.key_attr])

    def send_many(self, stream_id: str, cols: dict, timestamps,
                  decode: bool = False):
        """Bulk ingest: encode strings per distinct value, order all rows by
        lane with ONE stable argsort, bulk-copy each non-empty lane's rows
        into its wire builder in lane order, flushing as lanes fill.
        ``cols`` maps attribute name to an array of values."""
        ts = np.asarray(timestamps, dtype=np.int64)
        enc = self.encode_columns(stream_id, cols)
        lanes = self._lanes_for(stream_id, cols, enc)
        order = np.argsort(lanes, kind="stable")
        bounds = np.searchsorted(lanes[order], np.arange(self.P + 1))
        enc = {k: v[order] for k, v in enc.items()}
        ts = ts[order]
        out: list = []
        for lane in np.flatnonzero(bounds[1:] > bounds[:-1]):
            lo, hi = int(bounds[lane]), int(bounds[lane + 1])
            b = self.builders[lane]
            pos = lo
            while pos < hi:
                pos += b.append_many(stream_id, enc, ts[:hi], start=pos)
                if b.full:
                    r = self.flush(decode=decode)
                    if decode and r:
                        out.extend(r)
        return out if decode else None

    def flush(self, decode: bool = False):
        # a registered callback implies decode (rows found by an auto-flush
        # on a filled lane must reach it)
        decode = decode or self.callback is not None
        if all(len(b) == 0 for b in self.builders):
            return [] if decode else None
        batches = [b.emit() for b in self.builders]
        cols = {
            k: np.stack([bt["cols"][k] for bt in batches])
            for k in batches[0]["cols"]
        }
        tag = np.stack([bt["tag"] for bt in batches])
        ts = np.stack([bt["ts"] for bt in batches])
        ts_base = np.array([bt["ts_base"] for bt in batches], dtype=np.int64)
        counts = np.array([bt["count"] for bt in batches], dtype=np.int32)
        return self._step_and_decode(cols, tag, ts, ts_base, counts, decode)

    def _wire(self, cols, tag, ts, ts_base, counts) -> tuple:
        """Host wire arrays → the step's device tensors."""
        dev = self.device

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.pin_memory().to(dev, non_blocking=True) \
                if dev.type == "cuda" else t
        return ({k: put(v) for k, v in cols.items()}, put(tag), put(ts),
                put(ts_base), put(counts))

    def _step_and_decode(self, cols, tag, ts, ts_base, counts, decode: bool):
        self.state, ys = self.vstep(self.state, *self._wire(
            cols, tag, ts, ts_base, counts))
        if not decode:
            return ys
        if self.compiler.blocked:
            host = {k: v.cpu().numpy() for k, v in ys.items()}
            rows = []
            for lane in range(self.P):
                rows.extend(self.compiler.decode_outputs(
                    {k: v[lane] for k, v in host.items()}))
        else:
            # scan ys: hits found where the ys lie, rows in (lane, b, src, c)
            # order — the reference's lane-by-lane argwhere order
            rows = self.compiler.decode_outputs(ys)
        if self.callback is not None and rows:
            self.callback(rows)
        return rows

    @property
    def match_count(self) -> int:
        return int(self.state["matches"].sum())

    @property
    def drop_count(self) -> int:
        return int(self.state["drops"].sum())
