"""Partitioned execution: per-key NFA state on L lanes of one or more GPUs.

Port of the reference's ``tpu/partition.py``. Keys hash to L partition
lanes; each lane owns fixed-capacity match tables. Events are routed on the
host to their lane's sub-batch; on the card the lane axis is the kernel's
grid (one CTA or cluster per lane), so nothing crosses lanes. Both step
shapes run here: the blocked chain (``nfa_block``) and the per-event scan
(``nfa_scan``); absent states are refused under a partition, as the
reference refuses them.

The reference spreads the lane axis over a mesh (``mesh=``: ``shard_map``
over ``P(axis)``, contiguous lane blocks, a donated sharded state). Here
``devices=`` does the same: the lanes split into contiguous equal ranges,
one a device (a device may repeat), each with its own state, its own CUDA
stream and its own launch a step. Routing and batching are those of one
device, so every step sees the same batches, and the rows come out in lane
order; ``state`` reads the ranges concatenated along the lane axis. L not
divisible by the number of devices is refused at construction, as the
reference's ``device_put`` of the sharded state refuses it.

Two ingress routes feed the lanes: ``send``/``send_many`` route rows on the
host in Python (``partition_columns``), and the native route
(``enable_native_ingress`` → ``ingest_csv``/``emit_native_feed``) parses raw
CSV bytes, routes them by crc32 and packs the lanes in C++
(``native/ingress.cpp``).
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


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` → ``cuda:<current>``), so two
    names of one card compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class PartitionedNFARuntime:
    """L-lane partitioned pattern matching on one or more devices.

    ``partition with (<key> of <stream>)`` over a pattern query: every lane
    runs the compiled NFA independently on its key subset. ``device`` is the
    card unless the caller passes ``"cpu"`` (the plain version); with no card
    and no explicit ``"cpu"`` the constructor raises. ``devices`` (instead of
    ``device``) splits the lanes into contiguous equal ranges, one a device
    in the order given; a device may repeat (each range keeps its own
    stream).
    """

    def __init__(self, app_or_text, num_partitions: int,
                 key_attr: str,
                 slot_capacity: int = 32,
                 lane_batch: int = 256,
                 query_index: int = 0,
                 creation_cap: Optional[int] = None,
                 device=None,
                 devices=None):
        if devices is None:
            devs = [resolve_device(device)]
        else:
            if device is not None:
                raise ValueError("pass device= or devices=, not both")
            devs = [_indexed(resolve_device(d)) for d in devices]
            if not devs:
                raise ValueError("devices= names no device")
            if num_partitions % len(devs):
                raise ValueError(
                    f"{num_partitions} lanes are not divisible by "
                    f"{len(devs)} devices (each device takes an equal "
                    f"contiguous range)")
        self.device = devs[0]
        self.devices = devs
        n = num_partitions // len(devs)
        self.ranges = [(i * n, (i + 1) * n) for i in range(len(devs))]
        # a range of a split steps on a stream of its own, so the ranges of
        # one card run side by side and none waits on another's launch
        self._streams = [
            torch.cuda.Stream(d) if len(devs) > 1 and d.type == "cuda"
            else None for d in devs]
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
        # lane-batched step over [L, ...] state and batches (a range's, in
        # a split); on the card it updates the state in place (the analog of
        # the reference's donation)
        self.vstep = self.compiler.make_step()
        self._states: list = [None] * len(devs)
        self.state = self.init_state()
        self.callback: Optional[Callable[[list[list]], None]] = None

    def init_state(self) -> dict:
        """Fresh [P, ...]-stacked lane state (on the first device)."""
        return self.compiler.init_state(self.P)

    @property
    def state(self) -> dict:
        """The [P, ...] lane state; in a split, the ranges' states
        concatenated along the lane axis on the first device (a copy)."""
        if len(self._states) == 1:
            return self._states[0]
        return _tree_cat(self._states, self.device)

    @state.setter
    def state(self, tree: dict) -> None:
        """Takes a [P, ...] lane state; a split copies each range's lanes
        onto its device."""
        if len(self._states) == 1:
            self._states[0] = tree
            return
        self._states = [_tree_slice(tree, lo, hi, dev)
                        for (lo, hi), dev in zip(self.ranges, self.devices)]

    def lane_of(self, key) -> int:
        return _hash_key(key) % self.P

    # -- native (C++) CSV ingress ------------------------------------------
    def enable_native_ingress(self) -> None:
        """Routes raw CSV bytes through the C++ loader (no Python in the
        per-event loop): parse → dict-encode → crc32 lane routing → SoA
        pack. Single-input-stream patterns only."""
        from ..native import NativeIngress, native_available
        from ..query_api.definition import DataType

        if not native_available():
            raise RuntimeError("native ingress unavailable (no g++)")
        if len(self.compiler.merged.stream_ids) != 1:
            raise ValueError("native CSV ingress supports single-stream patterns")
        sid = self.compiler.merged.stream_ids[0]
        d = self.stream_defs[sid]
        chars = {DataType.STRING: "s", DataType.INT: "i", DataType.LONG: "l",
                 DataType.FLOAT: "f", DataType.DOUBLE: "d", DataType.BOOL: "b"}
        types = "".join(chars[a.type] for a in d.attributes)
        self._ning = NativeIngress(
            types, key_col=d.attribute_position(self.key_attr),
            n_lanes=self.P, capacity=self.lane_batch)
        # replay already-assigned codes (compile-time string constants) so
        # the native dictionary assigns identical codes from here on
        self._shared_dict = next(
            iter(self.compiler.merged.dictionaries.values()), None)
        if self._shared_dict is not None:
            for code in range(1, len(self._shared_dict)):
                self._ning.encode(self._shared_dict.decode(code))
        self._col_keys = [f"s0_{a.name}" for a in d.attributes]
        self._bool_cols = [a.type == DataType.BOOL for a in d.attributes]

    def ingest_csv(self, data: bytes, base_ts: int = 0, ts_last: bool = False,
                   decode: bool = False) -> list:
        """Feeds raw CSV bytes end to end; steps the lanes each time one
        fills."""
        decode = decode or self.callback is not None
        rows: list = []
        pos, n = 0, len(data)
        while pos < n:
            pos += self._ning.ingest_csv(
                data, base_ts=base_ts, ts_last=ts_last, offset=pos)
            if pos < n:  # a lane filled: step the lanes and resume
                out = self.flush_native(decode=decode)
                if decode and out:
                    rows.extend(out)
        return rows

    def emit_native_feed(self) -> dict:
        """Drains every native lane into one stacked [P, ...] wire feed
        (cols/tag/ts/ts_base/counts/count) without stepping: the packing
        half of ``flush_native``."""
        batches = [self._ning.emit_lane(ln) for ln in range(self.P)]
        used = self.compiler.used_cols
        cols = {}
        for ci, key in enumerate(self._col_keys):
            if key not in used:
                continue
            stacked = np.stack([bt["cols"][ci] for bt in batches])
            if self._bool_cols[ci]:
                stacked = stacked.astype(bool)
            cols[key] = stacked
        tag = np.stack([bt["tag"] for bt in batches]).astype(np.int8)
        # the wire's int32 deltas from the C++ int64 lane timestamps
        ts64 = np.stack([bt["ts"] for bt in batches])
        counts = np.array([bt["count"] for bt in batches], dtype=np.int32)
        base = np.array(
            [int(t[:n].min()) if n else 0 for t, n in zip(ts64, counts)],
            dtype=np.int64)
        deltas = ts64 - base[:, None]
        over = int(np.sum(deltas > 2**31 - 1))
        if over:
            # MergedBatchBuilder.emit's policy: clamp and count, loudly
            self.ts_clamped = getattr(self, "ts_clamped", 0) + over
            import logging
            logging.getLogger("siddhi_tpu_torch.device").warning(
                "native lane ts span exceeds int32 ms; %d clamped",
                self.ts_clamped)
        ts = np.clip(deltas, 0, 2**31 - 1).astype(np.int32)
        return {"cols": cols, "tag": tag, "ts": ts, "ts_base": base,
                "counts": counts, "count": int(counts.sum())}

    def flush_native(self, decode: bool = False):
        """Steps the lanes over what the native ingress has staged (nothing
        when every lane is empty)."""
        decode = decode or self.callback is not None
        if all(self._ning.lane_len(ln) == 0 for ln in range(self.P)):
            return [] if decode else None
        b = self.emit_native_feed()
        if decode:
            self._sync_dict_from_native()
        return self._step_and_decode(b["cols"], b["tag"], b["ts"],
                                     b["ts_base"], b["counts"], decode)

    def _sync_dict_from_native(self) -> None:
        # pull the strings the C++ dictionary minted during ingest into the
        # shared dictionary, so decode_outputs can render them
        d = self._shared_dict
        if d is None:
            return
        for code in range(len(d), self._ning.dict_size()):
            d.add(code, self._ning.decode(code))

    def _refuse_with_native(self, call: str) -> None:
        if getattr(self, "_ning", None) is not None:
            # a host append would mint dictionary codes the C++ dictionary
            # does not know, corrupting decode: one ingress owns the codes
            raise RuntimeError(
                f"native ingress enabled: use ingest_csv(), not {call}()")

    # -- host (Python) ingress ---------------------------------------------
    def send(self, stream_id: str, row: list, timestamp: int) -> None:
        self._refuse_with_native("send")
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

    def _route(self, stream_id: str, cols: dict, timestamps):
        """The bulk ingest's front half, shared by ``partition_columns`` and
        ``send_many``: encode strings per distinct value and order all rows
        by lane with ONE stable argsort. Returns the encoded columns and
        timestamps in lane order and each lane's bounds in them."""
        ts = np.asarray(timestamps, dtype=np.int64)
        enc = self.encode_columns(stream_id, cols)
        lanes = self._lanes_for(stream_id, cols, enc)
        order = np.argsort(lanes, kind="stable")
        bounds = np.searchsorted(lanes[order], np.arange(self.P + 1))
        return {k: v[order] for k, v in enc.items()}, ts[order], bounds

    def partition_columns(self, stream_id: str, cols: dict, timestamps):
        """Per-lane column and timestamp views of a bulk send (lane order;
        within a lane, arrival order)."""
        enc, ts, bounds = self._route(stream_id, cols, timestamps)
        lane_cols, lane_ts = [], []
        for lane in range(self.P):
            lo, hi = int(bounds[lane]), int(bounds[lane + 1])
            lane_cols.append({k: v[lo:hi] for k, v in enc.items()})
            lane_ts.append(ts[lo:hi])
        return lane_cols, lane_ts

    def send_many(self, stream_id: str, cols: dict, timestamps,
                  decode: bool = False):
        """Bulk ingest: route with ``_route`` (``partition_columns``' front
        half), bulk-copy each non-empty lane's rows into its wire builder
        in lane order, flushing as lanes fill. ``cols`` maps attribute name
        to an array of values."""
        self._refuse_with_native("send_many")
        enc, ts, bounds = self._route(stream_id, cols, timestamps)
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

    def _wire(self, cols, tag, ts, ts_base, counts, dev) -> tuple:
        """Host wire arrays → the step's tensors on ``dev`` (copied on the
        current stream)."""

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.pin_memory().to(dev, non_blocking=True) \
                if dev.type == "cuda" else t
        return ({k: put(v) for k, v in cols.items()}, put(tag), put(ts),
                put(ts_base), put(counts))

    def _step_ranges(self, cols, tag, ts, ts_base, counts) -> list:
        """Steps every range over its lanes of one [P, ...] wire batch;
        returns each range's ys, in lane order. A range on the card runs on
        its own stream, which first waits for the device's current stream
        (where its state was written); the current stream then waits for
        every range, so what reads the state or ys after this sees the
        step's results."""
        if len(self.ranges) == 1:
            self._states[0], ys = self.vstep(self._states[0], *self._wire(
                cols, tag, ts, ts_base, counts, self.device))
            return [ys]
        parts = []
        for i, ((lo, hi), dev, stream) in enumerate(
                zip(self.ranges, self.devices, self._streams)):
            wire = ({k: v[lo:hi] for k, v in cols.items()}, tag[lo:hi],
                    ts[lo:hi], ts_base[lo:hi], counts[lo:hi])
            if stream is None:
                self._states[i], ys = self.vstep(
                    self._states[i], *self._wire(*wire, dev))
            else:
                with torch.cuda.device(dev):
                    stream.wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.stream(stream):
                        self._states[i], ys = self.vstep(
                            self._states[i], *self._wire(*wire, dev))
            parts.append(ys)
        for dev, stream in zip(self.devices, self._streams):
            if stream is not None:
                torch.cuda.current_stream(dev).wait_stream(stream)
        return parts

    def _step_and_decode(self, cols, tag, ts, ts_base, counts, decode: bool):
        parts = self._step_ranges(cols, tag, ts, ts_base, counts)
        if not decode:
            return parts[0] if len(parts) == 1 else \
                _tree_cat(parts, self.device)
        rows = []
        for ys in parts:
            if self.compiler.blocked:
                host = {k: v.cpu().numpy() for k, v in ys.items()}
                for lane in range(host["mask"].shape[0]):
                    rows.extend(self.compiler.decode_outputs(
                        {k: v[lane] for k, v in host.items()}))
            else:
                # scan ys: hits found where the ys lie, rows in (lane, b,
                # src, c) order — the reference's lane-by-lane argwhere
                # order
                rows.extend(self.compiler.decode_outputs(ys))
        if self.callback is not None and rows:
            self.callback(rows)
        return rows

    @property
    def match_count(self) -> int:
        return sum(int(st["matches"].sum()) for st in self._states)

    @property
    def drop_count(self) -> int:
        return sum(int(st["drops"].sum()) for st in self._states)

    def block_until_ready(self) -> None:
        """Waits for every step queued on the lanes' devices."""
        for dev in {st["matches"].device for st in self._states}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def _tree_cat(trees: list, dev) -> dict:
    """Lane-stacked trees → one tree, concatenated along the lane axis on
    ``dev``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_cat([t[k] for t in trees], dev) for k in first}
    return torch.cat([t.to(dev) for t in trees])


def _tree_slice(tree, lo: int, hi: int, dev) -> dict:
    """Lanes ``[lo, hi)`` of a lane-stacked tree, copied onto ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree_slice(v, lo, hi, dev) for k, v in tree.items()}
    return tree[lo:hi].to(dev, copy=True).contiguous()
