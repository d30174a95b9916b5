"""Multi-host distributed execution: DCN ingest routing + per-shard egress.

The port's copy of the JAX package's ``tpu/dcn.py``: the framing, the row
codec, :class:`LaneTopology`, :class:`DCNWorker` and
:class:`DCNIngestClient`, with their retry, dedup, spill, takeover and
rejoin logic unchanged. Frames and snapshot files are byte-compatible with
the JAX package's. Two deliberate differences:

- **The device.** ``DCNWorker(..., device=None)`` steps its shards on the
  card unless the caller passes ``"cpu"`` (the kernels' plain versions),
  with no fallback: each owned lane group is a
  :class:`~siddhi_tpu_torch.gpu.partition.PartitionedNFARuntime` on that
  device, so every shard steps the blocked NFA (or the scan) on the card.
- **Snapshot leaves.** A group snapshot holds the shard's state as numpy
  leaves in ``jax.tree_util``'s order (``gpu/state_io.py``:
  ``state_leaves``/``state_from_leaves``), the JAX package's dtypes and
  shapes, so a revision written by either package restores in the other.

SURVEY §2.3 maps the reference's only distributed machinery — multi-endpoint
sinks (``util/transport/MultiClientDistributedSink.java``) — to "DCN for
multi-host ingest/egress; per-shard output streams". The design:

- **Sharding model**: the partition-lane axis is the unit of placement. A
  GLOBAL lane space of ``num_lanes`` is split into contiguous groups; group
  ``g``'s HOME host is host ``g``, but ownership is a live mapping
  (:attr:`LaneTopology.owner`) so a survivor can adopt a dead host's group
  (failover) and hand it back on recovery. Keys hash to global lanes with
  the same crc32 as single-host mode, so a cluster resize is a lane-group
  remap, not a rehash.
- **Ingest (DCN)**: every host accepts events; rows whose lane group belongs
  to a peer are forwarded over the data-center network (sockets here; the
  same framing applies to any transport). Forwarding is batched — rows are
  framed in bulk wire batches, never per-event — because cross-host hops are
  the latency budget's biggest item.
- **Egress (per-shard output streams)**: each host emits ONLY its own lanes'
  matches (the reference's partitioned ``@distribution`` strategy); a
  consumer that needs a total order merges on timestamp downstream, exactly
  like the reference's distributed sinks leave ordering to the endpoints.
- **In-pod vs cross-pod**: within a host, a shard's lanes may split over
  several cards (``PartitionedNFARuntime(devices=)``, no host involvement).
  DCN carries only (a) mis-routed ingest rows and (b) egress rows — NFA
  state never crosses hosts (keys are lane-affine).

**Fault tolerance** (the DISTRIBUTED.md "Failure / elasticity" row; policy
lives in :mod:`siddhi_tpu_torch.resilience.dcn_guard`):

- every DCN socket carries a deadline (connect, send, ack-recv, idle serve
  loop) — a wedged peer becomes a *detected* failure, never a hang;
- ``K_ROWS`` frames carry ``(sender, group, epoch, seq)``; the receiver
  dedups per (group, sender) so a retried frame after a lost ack stays
  exactly-once, across sender restarts (the epoch) and across failover (the
  dedup table travels with the group's snapshot);
- ``_forward`` retries with capped backoff, dropping the cached peer socket
  on any error so the next attempt reconnects; exhausted retries spill the
  frame into the group's bounded :class:`~siddhi_tpu_torch.resilience.
  dcn_guard.SpillQueue` for in-order replay on recovery;
- heartbeats (``K_PING``/``K_PONG``) drive the per-peer
  healthy→suspect→down→probing detector; past the takeover deadline a
  designated survivor adopts the dead host's lane group from the latest
  snapshot revision (global-lane-keyed), re-points :class:`LaneTopology`,
  announces ``K_OWNER``, and replays the spill; a returning host re-joins
  via ``K_ADOPT`` — the same handoff in reverse.

The wire format is the binary SoA row frame below — the same
structure-of-arrays layout the C++ ingress packer stages lane buffers in
(``native/ingress.cpp``): one dense typed array per column plus a null
bitmap, strings as offsets+blob (dictionary codes deliberately do NOT cross
hosts — each host's dictionary is local, so strings travel raw and re-encode
on arrival). Versus JSON frames this is both smaller (see
``tests/test_dcn.py::test_soa_wire_format_roundtrip_and_size``) and
zero-parse on the numeric columns.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..observability.tracing import TraceContext
from ..resilience.chaos import ChaosFault
from ..resilience.dcn_guard import (
    PEER_DOWN,
    DCNGuard,
    DCNGuardConfig,
    LaneGroupSnapshotStore,
)
from .backend import resolve_device
from .partition import PartitionedNFARuntime, _hash_key
from .state_io import state_from_leaves, state_leaf_count, state_leaves

log = logging.getLogger("siddhi_tpu_torch.dcn")

# frame: 1-byte kind + u32 payload length + payload
_HDR = struct.Struct(">BI")
K_ROWS, K_ACK, K_FLUSH, K_FLUSHED = 1, 2, 3, 4
K_PING, K_PONG, K_OWNER, K_ADOPT = 5, 6, 7, 8

# K_ROWS payload prefix: sender host, lane group, sender epoch (incarnation),
# per-(sender→group) sequence number. Epoch lets a restarted sender's fresh
# seq space supersede its dead incarnation's; seq drives receiver dedup.
# After the prefix: a u16-counted block of sampled TraceContexts (X-Ray
# cross-host stitching — baked into the frame bytes, so a context survives
# retry, spill replay and failover with the rows it describes), then the
# SoA row body.
_ROWS_HDR = struct.Struct(">BBIQ")
_CTX_COUNT = struct.Struct(">H")


def _pack_ctxs(ctxs: list) -> bytes:
    if not ctxs:
        return _CTX_COUNT.pack(0)
    return _CTX_COUNT.pack(len(ctxs)) + b"".join(c.pack() for c in ctxs)


def _unpack_ctxs(payload: bytes, offset: int) -> tuple[list, int]:
    """Parse the trace-context block; returns (contexts, body_offset).

    Sanity-bounds the declared count against the payload size so a frame
    from an incompatible peer (pre-X-Ray wire format — mixed-version
    meshes are unsupported, as with every prior framing change) fails as
    a DETECTED connection error instead of decoding garbage rows."""
    (n,) = _CTX_COUNT.unpack_from(payload, offset)
    offset += _CTX_COUNT.size
    if offset + n * TraceContext.size > len(payload):
        raise ConnectionError(
            f"K_ROWS trace-context block claims {n} contexts past the "
            f"frame end (incompatible peer wire format?)")
    ctxs = []
    for _ in range(n):
        ctxs.append(TraceContext.unpack_from(payload, offset))
        offset += TraceContext.size
    return ctxs, offset
# K_OWNER / K_ADOPT payloads
_OWNER_FMT = struct.Struct(">BB")        # (group, owner host)
_ADOPT_FMT = struct.Struct(">B")         # (group,)

# every DCN call path carries a deadline (scripts/check_socket_timeouts.py's
# check finds no blocking socket op without one in this file)
CONNECT_TIMEOUT_S = 5.0
IO_TIMEOUT_S = 10.0

# column type chars (shared vocabulary with native/ingress.cpp's schema
# string): i=i32 l=i64 f=f32 d=f64 b=bool s=string
_NUM_DT = {"i": ">i4", "l": ">i8", "f": ">f4", "d": ">f8", "b": ">u1"}


def send_msg(sock: socket.socket, kind: int, payload: bytes = b"") -> None:
    sock.sendall(_HDR.pack(kind, len(payload)) + payload)


def recv_msg(sock: socket.socket, timeout: float = IO_TIMEOUT_S):
    """Returns (kind, payload), or None on a cleanly closed connection.

    Always arms a deadline: ``socket.timeout`` raised at a frame boundary
    means *idle* (callers may poll); a timeout or close mid-frame raises
    ``ConnectionError`` — the stream is desynced and must be dropped."""
    sock.settimeout(timeout)
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    kind, n = _HDR.unpack(hdr)
    payload = _recv_exact(sock, n) if n else b""
    if payload is None:
        raise ConnectionError("connection closed mid-frame")
    return (kind, payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    if sock.gettimeout() is None:
        # every blocking recv in this package must carry a deadline
        # (scripts/check_socket_timeouts.py pins the same invariant in CI)
        raise ValueError("blocking recv on a socket without a timeout")
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if buf:
                # a half-read frame can never resync — surface a broken
                # connection, not an idle timeout
                raise ConnectionError(
                    "connection timed out mid-frame") from None
            raise
        if not chunk:
            if buf:
                raise ConnectionError("connection closed mid-frame")
            return None
        buf += chunk
    return buf


def pack_rows(types: str, rows: list, timestamps: list) -> bytes:
    """Rows → self-describing SoA payload.

    Layout: ``u32 n · u8 n_cols · n_cols type chars · i64 ts[n]`` then per
    column ``u8 nulls[n]`` + (numeric: dense big-endian array | string:
    ``u32 offs[n+1]`` + utf-8 blob). Same SoA shape as the C++ lane
    buffers; byte order fixed big-endian for cross-host portability."""
    n = len(rows)
    parts = [struct.pack(">IB", n, len(types)), types.encode("ascii")]
    parts.append(np.asarray(timestamps, dtype=">i8").tobytes())
    cols = list(zip(*rows)) if n else [() for _ in types]
    for t, col in zip(types, cols):
        nulls = np.fromiter((v is None for v in col), np.uint8, count=n)
        parts.append(nulls.tobytes())
        if t == "s":
            blobs = [b"" if v is None else str(v).encode() for v in col]
            offs = np.zeros(n + 1, dtype=">u4")
            if n:
                np.cumsum([len(b) for b in blobs], out=offs[1:])
            parts.append(offs.tobytes())
            parts.append(b"".join(blobs))
        else:
            arr = np.array([0 if v is None else v for v in col],
                           dtype=_NUM_DT[t])
            parts.append(arr.tobytes())
    return b"".join(parts)


def pack_columns(types: str, cols: list, timestamps) -> bytes:
    """Columns → the SAME self-describing SoA payload as :func:`pack_rows`,
    built WITHOUT materializing per-event row lists (the bulk forwarding
    path: a :class:`~siddhi_tpu_torch.core.columns.RowsChunk` ships straight
    from its numpy columns into wire bytes — byte-identical layout, pinned by
    tests against ``pack_rows`` on the same data). ``cols`` is positional
    (one entry per type char): numeric columns as numpy arrays (object
    arrays may carry None → null bit + zero), string columns as object
    arrays/lists of ``str | None``."""
    ts = np.asarray(timestamps, dtype=np.int64)
    n = int(ts.shape[0])
    parts = [struct.pack(">IB", n, len(types)), types.encode("ascii"),
             ts.astype(">i8").tobytes()]
    for t, col in zip(types, cols):
        if t == "s":
            vals = col if isinstance(col, np.ndarray) \
                else np.asarray(col, dtype=object)
            nulls = np.fromiter((v is None for v in vals), np.uint8,
                                count=n)
            parts.append(nulls.tobytes())
            blobs = [b"" if v is None else str(v).encode() for v in vals]
            offs = np.zeros(n + 1, dtype=">u4")
            if n:
                np.cumsum([len(b) for b in blobs], out=offs[1:])
            parts.append(offs.tobytes())
            parts.append(b"".join(blobs))
        else:
            arr = np.asarray(col)
            if arr.dtype == object:
                nulls = np.fromiter((v is None for v in arr), np.uint8,
                                    count=n)
                arr = np.array([0 if v is None else v for v in arr],
                               dtype=_NUM_DT[t])
            else:
                nulls = np.zeros(n, dtype=np.uint8)
                arr = arr.astype(_NUM_DT[t], copy=False)
            parts.append(nulls.tobytes())
            parts.append(arr.tobytes())
    return b"".join(parts)


def unpack_rows(payload: bytes) -> tuple[list, list]:
    """Inverse of :func:`pack_rows`; returns (rows, timestamps)."""
    n, n_cols = struct.unpack_from(">IB", payload, 0)
    pos = 5
    types = payload[pos: pos + n_cols].decode("ascii")
    pos += n_cols
    ts = np.frombuffer(payload, dtype=">i8", count=n, offset=pos)
    pos += 8 * n
    cols = []
    for t in types:
        nulls = np.frombuffer(payload, dtype=np.uint8, count=n, offset=pos)
        pos += n
        if t == "s":
            offs = np.frombuffer(payload, dtype=">u4", count=n + 1,
                                 offset=pos)
            pos += 4 * (n + 1)
            blob = payload[pos: pos + int(offs[-1])]
            pos += int(offs[-1])
            col = [None if nulls[i] else
                   blob[int(offs[i]): int(offs[i + 1])].decode()
                   for i in range(n)]
        else:
            arr = np.frombuffer(payload, dtype=_NUM_DT[t], count=n,
                                offset=pos)
            pos += arr.itemsize * n
            if t == "b":
                col = [None if nulls[i] else bool(arr[i]) for i in range(n)]
            elif t in ("i", "l"):
                col = [None if nulls[i] else int(arr[i]) for i in range(n)]
            else:
                col = [None if nulls[i] else float(arr[i]) for i in range(n)]
        cols.append(col)
    rows = [[c[i] for c in cols] for i in range(n)]
    return rows, [int(x) for x in ts]


class LaneTopology:
    """Global lane space split into contiguous per-host groups.

    Group ``g``'s HOME host is host ``g`` (the identity the snapshot store
    and dedup tables key on); :attr:`owner` is the LIVE assignment, re-pointed
    by failover (:meth:`reassign`). ``local_lane`` stays a plain modulo —
    the contiguous-regroup property that makes any host able to restore any
    group's snapshot."""

    def __init__(self, num_lanes: int, num_hosts: int,
                 owner: Optional[dict] = None):
        if num_lanes % num_hosts:
            raise ValueError("num_lanes must divide evenly across hosts")
        if not 1 <= num_hosts <= 255:
            # host/group indices travel as one wire byte (_ROWS_HDR)
            raise ValueError("num_hosts must be in [1, 255]")
        self.num_lanes = num_lanes
        self.num_hosts = num_hosts
        self.lanes_per_host = num_lanes // num_hosts
        self.owner = (dict(owner) if owner is not None
                      else {g: g for g in range(num_hosts)})

    def lane_of(self, key) -> int:
        return _hash_key(key) % self.num_lanes

    def group_of(self, global_lane: int) -> int:
        return global_lane // self.lanes_per_host

    def host_of(self, key) -> int:
        return self.owner[self.group_of(self.lane_of(key))]

    def local_lane(self, global_lane: int) -> int:
        return global_lane % self.lanes_per_host

    def lanes_of_group(self, group: int) -> range:
        return range(group * self.lanes_per_host,
                     (group + 1) * self.lanes_per_host)

    def groups_owned_by(self, host: int) -> list:
        return sorted(g for g, o in self.owner.items() if o == host)

    def reassign(self, group: int, host: int) -> None:
        if group not in self.owner or not 0 <= host < self.num_hosts:
            raise ValueError(f"bad lane-group reassign {group}->{host}")
        self.owner[group] = host


class DCNWorker:
    """One host's engine shard: owns lane group(s), serves a DCN ingest
    port, forwards mis-routed rows to peers, emits its own lanes' matches.

    ``peers``: host index → (addr, port) for every OTHER worker. The worker
    both listens (for forwarded rows) and dials out (to forward). Rows
    forwarded to a peer are batched per ``ingest`` call per lane group —
    the DCN hop is framed in bulk, never per event.

    Fault tolerance rides on the attached :class:`DCNGuard` (heartbeats,
    retry budget, spill policy, takeover deadline — see
    :class:`~siddhi_tpu_torch.resilience.dcn_guard.DCNGuardConfig`).
    ``epoch`` is this worker's incarnation number: a restarted host passes
    a HIGHER epoch so its fresh sequence space supersedes the dead one's in
    peer dedup tables. With a ``snapshot_store``, ``restore=True`` reloads the
    latest revision of every owned group at startup, and
    ``snapshot_every_frames=N`` persists owned groups after every N applied
    peer frames (before the ack, so an acked frame is durable at N=1).
    ``device`` is the card unless the caller passes ``"cpu"``; every shard
    the worker builds or adopts lives there.
    """

    def __init__(self, host_index: int, topology: LaneTopology,
                 app_text, key_attr: str, port: int,
                 peers: dict, stream_id: str = "S",
                 slot_capacity: int = 32, lane_batch: int = 256,
                 on_rows: Optional[Callable] = None, *,
                 epoch: Optional[int] = None,
                 chaos=None,
                 guard_config: Optional[DCNGuardConfig] = None,
                 snapshot_store: Optional[LaneGroupSnapshotStore] = None,
                 restore: bool = False,
                 snapshot_every_frames: Optional[int] = None,
                 connect_timeout_s: float = CONNECT_TIMEOUT_S,
                 io_timeout_s: float = IO_TIMEOUT_S,
                 clock=time.monotonic,
                 tracer=None, flight=None, device=None):
        self.host_index = host_index
        self.device = resolve_device(device)
        self.topo = topology
        self.key_attr = key_attr
        self.stream_id = stream_id
        self.peers = dict(peers)
        self.on_rows = on_rows
        # X-Ray: a PipelineTracer samples ingest calls and stitches across
        # hosts (its mesh host index pins the trace-id namespace); a
        # FlightRecorder logs takeover/rejoin control-plane transitions
        self.tracer = tracer
        if tracer is not None and tracer.host is None:
            tracer.host = host_index
        self.flight = flight
        # incarnation number: a restarted sender MUST come back with a
        # higher epoch or peers' dedup tables (which persist in snapshots)
        # silently discard its fresh seq space as retries. With a store the
        # epoch derives automatically; without one, pass it explicitly on
        # restart.
        if epoch is None:
            epoch = (snapshot_store.next_epoch(host_index)
                     if snapshot_store is not None else 0)
        self.epoch = int(epoch)
        self.chaos = chaos
        self.snapshot_store = snapshot_store
        self.snapshot_every_frames = snapshot_every_frames
        self.connect_timeout_s = connect_timeout_s
        self.io_timeout_s = io_timeout_s

        from ..compiler import parse as _parse
        self._app = _parse(app_text) if isinstance(app_text, str) \
            else app_text
        self.slot_capacity = slot_capacity
        self.lane_batch = lane_batch
        self.stream_defs = dict(self._app.stream_definitions)
        self._key_pos = self.stream_defs[stream_id].attribute_position(
            key_attr)
        from ..query_api.definition import DataType
        chars = {DataType.STRING: "s", DataType.INT: "i",
                 DataType.LONG: "l", DataType.FLOAT: "f",
                 DataType.DOUBLE: "d", DataType.BOOL: "b"}
        self._types = "".join(
            chars[a.type]
            for a in self.stream_defs[stream_id].attributes)

        # one lock serializes every engine mutation: local ingest, rows
        # frames arriving on concurrent peer connections, the flush barrier,
        # ownership changes, dedup marks, and snapshot export
        self._engine_lock = threading.Lock()
        # per-group send locks keep the (sender→group) seq stream ordered;
        # per-host socket locks keep request/reply exchanges on a shared
        # data socket from interleaving. Lock order: group → host; the
        # engine lock is never held across either.
        self._group_locks = {g: threading.Lock()
                             for g in range(topology.num_hosts)}
        self._sock_locks = {h: threading.Lock()
                            for h in range(topology.num_hosts)}
        self._hb_locks = {h: threading.Lock()
                          for h in range(topology.num_hosts)}

        # engine shards: one PartitionedNFARuntime per OWNED lane group
        # (normally just the home group; failover adds adopted ones)
        self._shards: dict = {}
        for g in topology.groups_owned_by(host_index):
            self._shards[g] = self._build_shard()
        self.rt = self._shards.get(host_index)   # home shard, if owned

        self.forwarded = 0            # rows ACKED by (or re-owned from) peers
        self.forward_chunk_rows = 0   # rows forwarded via the bulk SoA path
        self.received = 0             # rows accepted from peers
        self.dup_frames = 0           # retried frames deduped by seq
        self.frame_errors = 0         # serve-side engine failures (no ack)
        self.takeovers = 0            # lane groups adopted from dead peers
        self.rejoins = 0              # lane groups handed back on recovery
        self.snapshots = 0            # snapshot() completions
        self._frames_applied: dict = {}   # group → applied frame count
        self._next_seq: dict = {}     # group → last assigned seq
        self._dedup: dict = {}        # group → {sender: (epoch, seq)}
        self._peer_socks: dict = {}
        self._hb_socks: dict = {}
        self._ever_connected: set = set()
        self._sm = None               # StatisticsManager, when registered
        self._transit_tracker = None  # dcn_transit phase histogram (ditto)

        self.guard = DCNGuard(self, guard_config, clock=clock)

        if restore and snapshot_store is not None:
            with self._engine_lock:
                for g, shard in self._shards.items():
                    snap = snapshot_store.latest(g)
                    if snap is not None:
                        self._restore_shard_state(g, shard, snap)
                        self._merge_dedup_locked(g, snap)

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(8)
        self._srv.settimeout(0.5)     # accept() wakes to observe shutdown
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._conns: set = set()
        self._serve_threads: list = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        # LAST: the heartbeat thread must only observe a fully built worker
        self.guard.start_if_configured()

    def _build_shard(self) -> PartitionedNFARuntime:
        rt = PartitionedNFARuntime(
            self._app, num_partitions=self.topo.lanes_per_host,
            key_attr=self.key_attr, slot_capacity=self.slot_capacity,
            lane_batch=self.lane_batch, device=self.device)
        if self.on_rows is not None:
            rt.callback = self.on_rows
        return rt

    # -- local + DCN ingest ---------------------------------------------------
    def ingest(self, rows: list, timestamps: list) -> None:
        """Accepts arbitrary rows; applies locally-owned ones, forwards the
        rest in ONE frame per destination lane group (acked — see
        ``_forward``; peer-down frames spill for in-order replay). With a
        tracer attached, every Nth call opens a trace whose context rides
        the outgoing frames — the receiving host re-activates it, so one
        trace id spans the mesh."""
        tr = self.tracer.maybe_trace(self.stream_id) \
            if self.tracer is not None else None
        t_ing0 = time.perf_counter_ns() if tr is not None else 0
        key_pos = self._key_pos
        by_group: dict = {}
        # a locally-owned group with a spill backlog (takeover window) must
        # NOT apply fresh rows directly — older spilled rows would be
        # overtaken. Those rows take the forward path, which drains the
        # backlog in order before applying.
        backlogged = set(self.guard.backlogged_groups())
        with self._engine_lock:
            for row, ts in zip(rows, timestamps):
                lane = self.topo.lane_of(row[key_pos])
                g = self.topo.group_of(lane)
                if g in self._shards and g not in backlogged:
                    self._apply_locked(g, lane, row, ts)
                else:
                    r, t = by_group.setdefault(g, ([], []))
                    r.append(row)
                    t.append(ts)
        if tr is not None:
            tr.add_span("ingress", self.stream_id,
                        time.perf_counter_ns() - t_ing0, len(rows))
        for g, (prows, pts) in by_group.items():
            # framing errors (malformed row data) raise to the caller,
            # exactly like a malformed row on the local-apply path — only
            # POST-framing failures are swallowed, because by then the
            # frame is guaranteed parked in the spill queue
            body = pack_rows(self._types, prows, pts)
            ctxs = [self.tracer.context_of(tr)] if tr is not None else []
            t_fwd0 = time.perf_counter_ns() if tr is not None else 0
            try:
                acked = self._forward(g, body, len(prows), ctxs)
            except Exception:   # noqa: BLE001 — logged; the frame is
                # already parked in the spill queue by _forward, and one
                # group's failure must not drop the REMAINING groups' rows
                log.exception("host %d: forward to group %d failed",
                              self.host_index, g)
                continue
            finally:
                if tr is not None:
                    # the sender-side half of the hop: frame build + send +
                    # ack wait (or the spill decision) for this lane group
                    tr.add_span("dcn", f"h{self.host_index}->g{g}",
                                time.perf_counter_ns() - t_fwd0, len(prows))
            if acked:
                # count under the lock, and only rows actually acked —
                # spilled/failed frames are counted by the spill queue
                with self._engine_lock:
                    self.forwarded += acked

    # -- bulk SoA ingest (RowsChunk → wire, no per-row framing) --------------
    def _lanes_of_column(self, key_col, n: int) -> np.ndarray:
        """Vectorized global-lane assignment for a key COLUMN: crc32 runs
        once per DISTINCT key (``np.unique`` + gather) instead of once per
        row — same lane function as :meth:`LaneTopology.lane_of`."""
        vals = key_col.materialize() if hasattr(key_col, "materialize") \
            else key_col
        if not isinstance(vals, np.ndarray):
            vals = np.asarray(vals, dtype=object)
        try:
            su = vals.astype("U")
        except (TypeError, ValueError):     # None/mixed: slow-path stringify
            su = np.array([str(v) for v in vals], dtype="U")
        uniq, inv = np.unique(su, return_inverse=True)
        # ONE source of truth for the hash: _hash_key (gpu/partition.py) —
        # str(np.str_) round-trips, so _hash_key(u) == _hash_key(value)
        lanes_u = np.fromiter(
            ((_hash_key(u) % self.topo.num_lanes) for u in uniq),
            np.int64, count=uniq.size)
        return lanes_u[inv]

    def ingest_chunk(self, chunk) -> None:
        """Bulk SoA ingest of one :class:`~siddhi_tpu_torch.core.columns.
        RowsChunk`: lanes compute vectorized over the key column, the
        locally-owned slice applies under the engine lock, and each remote
        lane group's slice ships as ONE frame packed straight from the
        columns (:func:`pack_columns` — no per-event row lists, no
        re-framing per send). Delivery rides the same ``_forward``
        retry/dedup/spill machinery as :meth:`ingest`, so exactly-once is
        unchanged; rows acked through this path count in
        ``forward_chunk_rows`` (the ``dcn.forward.rows`` metric) — the
        DCN-ingest saturation fix of ROADMAP item 3."""
        from ..core.columns import column_tolist
        names = [a.name for a in self.stream_defs[self.stream_id].attributes]
        n = chunk.count
        if n == 0:
            return
        ts = np.asarray(chunk.ts, dtype=np.int64)
        tr = self.tracer.maybe_trace(self.stream_id) \
            if self.tracer is not None else None
        t_ing0 = time.perf_counter_ns() if tr is not None else 0
        lanes = self._lanes_of_column(chunk.cols[names[self._key_pos]], n)
        groups = lanes // self.topo.lanes_per_host
        backlogged = set(self.guard.backlogged_groups())
        present = np.unique(groups)
        remote: list = []
        with self._engine_lock:
            for g in present.tolist():
                g = int(g)
                mask = groups == g
                if g in self._shards and g not in backlogged:
                    # local slice: apply in chunk order (per-key order is
                    # per-lane order — the boolean mask preserves it)
                    idx = np.nonzero(mask)[0]
                    py = [column_tolist(chunk.cols[nm][idx])
                          for nm in names]
                    for j, i in enumerate(idx.tolist()):
                        self._apply_locked(g, int(lanes[i]),
                                           [c[j] for c in py], int(ts[i]))
                else:
                    remote.append((g, mask))
        if tr is not None:
            tr.add_span("ingress", self.stream_id,
                        time.perf_counter_ns() - t_ing0, n)
        for g, mask in remote:
            # dictionary codes do not cross hosts: DictColumns materialize
            # to raw strings for the wire (the receiver re-encodes locally)
            sub = [c.materialize() if hasattr(c, "materialize") else c
                   for c in (chunk.cols[nm][mask] for nm in names)]
            body = pack_columns(self._types, sub, ts[mask])
            k = int(np.count_nonzero(mask))
            ctxs = [self.tracer.context_of(tr)] if tr is not None else []
            t_fwd0 = time.perf_counter_ns() if tr is not None else 0
            try:
                acked = self._forward(g, body, k, ctxs)
            except Exception:   # noqa: BLE001 — parked in the spill queue
                log.exception("host %d: bulk forward to group %d failed",
                              self.host_index, g)
                continue
            finally:
                if tr is not None:
                    tr.add_span("dcn", f"h{self.host_index}->g{g}",
                                time.perf_counter_ns() - t_fwd0, k)
            if acked:
                with self._engine_lock:
                    self.forwarded += acked
                    self.forward_chunk_rows += acked

    def _apply_locked(self, group: int, lane: int, row: list,
                      ts: int) -> None:
        # local-lane routing reuses the single-host runtime: global lane →
        # local lane is a contiguous remap, and the runtime's own crc32 lane
        # assignment is replaced by explicit placement. Callers hold
        # ``_engine_lock``.
        shard = self._shards[group]
        b = shard.builders[self.topo.local_lane(lane)]
        b.append(self.stream_id, row, ts)
        if b.full:
            shard.flush(decode=self.on_rows is not None)

    def _forward(self, group: int, body: bytes, n: int,
                 ctxs: Optional[list] = None) -> int:
        """Deliver one lane group's pre-packed rows; returns rows acked by
        the remote owner (0 when spilled, failed, or applied locally after
        an ownership change mid-flight). ``ctxs`` (sampled TraceContexts)
        bake into the frame bytes — retries, spill replay and failover all
        resend the SAME frame, so the contexts travel with the rows."""
        spill_q = self.guard.spill(group)
        if self.guard.must_spill(group):
            # BLOCK-policy admission wait happens OUTSIDE the group lock so
            # a replay drain can free space (bounded; then forced in)
            spill_q.wait_for_space(self._stop)
        with self._group_locks[group]:
            seq = self._next_seq.get(group, 0) + 1
            self._next_seq[group] = seq
            frame = _ROWS_HDR.pack(self.host_index, group, self.epoch,
                                   seq) + _pack_ctxs(ctxs or []) + body
            if not spill_q.empty:
                # a backlog exists for a group WE now own (takeover window):
                # drain it before this frame applies, or the locally-applied
                # higher seq would make monotone dedup drop every older
                # spilled frame on replay
                with self._engine_lock:
                    owner = self.topo.owner[group]
                if owner == self.host_index:
                    try:
                        self._drain_spill_group_locked(group)
                    except Exception:
                        # park the fresh frame before surfacing, like the
                        # send path below — it must never simply vanish
                        spill_q.append(frame, n)
                        raise
            if self.guard.must_spill(group):
                spill_q.append(frame, n)
                return 0
            try:
                outcome = self._send_frame(group, frame)
            except Exception:
                # never lose a framed batch to an unexpected error: park it
                # in the spill queue (the sweep replays it) and surface
                spill_q.append(frame, n)
                raise
            if outcome == "acked":
                return n
            if outcome == "local":
                return 0
            spill_q.append(frame, n)
            return 0

    def _send_frame(self, group: int, frame: bytes) -> str:
        """One frame through the retry/redirect machine. Returns ``acked``
        (remote owner applied or deduped it), ``local`` (ownership moved to
        this host mid-flight; applied through the same dedup path), or
        ``failed`` (retry budget exhausted — caller spills). Any send/ack
        error closes and evicts the cached peer socket so the next attempt
        reconnects instead of reusing a broken connection."""
        attempts = 0
        redirects = 0
        while True:
            with self._engine_lock:
                owner = self.topo.owner[group]
            if owner == self.host_index:
                try:
                    self._apply_frame_locally(frame)
                    return "local"
                except ConnectionError:
                    # ownership said local but the shard is gone (stale
                    # K_OWNER flip mid-handoff) — spill, don't lose
                    return "failed"
            site = f"dcn:{self.host_index}->{owner}"
            try:
                with self._sock_locks[owner]:
                    s = self._peer_sock_locked(owner)
                    send_msg(s, K_ROWS, frame)
                    if self.chaos is not None:
                        self.chaos.on_dcn_send(site)    # simulated lost ack
                    reply = recv_msg(s, timeout=self.io_timeout_s)
                if reply is None:
                    raise ConnectionError(f"peer {owner}: closed before ack")
                kind, payload = reply
                if kind == K_ACK:
                    self.guard.on_send_ok(owner)
                    return "acked"
                if kind == K_OWNER:
                    g, new_owner = _OWNER_FMT.unpack(payload)
                    with self._engine_lock:
                        self.topo.reassign(g, new_owner)
                    self.guard.count(owner, "redirects")
                    redirects += 1
                    if redirects > self.topo.num_hosts:
                        raise ConnectionError(
                            f"group {group}: ownership redirect loop")
                    continue          # re-send the SAME frame to the owner
                raise ConnectionError(
                    f"peer {owner}: unexpected reply kind {kind}")
            except (OSError, ConnectionError, ChaosFault,
                    ValueError, struct.error) as e:
                # ValueError/struct.error: a malformed control reply
                # (short K_OWNER payload, out-of-range owner byte) is peer
                # misbehavior — retry/spill like any transport fault
                self._drop_peer_sock(owner)
                self.guard.on_send_error(owner)
                attempts += 1
                if attempts >= self.guard.config.retry_max:
                    log.warning(
                        "host %d: frame to group %d (peer %d) failed after "
                        "%d attempts: %s", self.host_index, group, owner,
                        attempts, e)
                    return "failed"
                self.guard.count(owner, "retries")
                if self._stop.wait(self.guard.backoff_s(attempts - 1)):
                    return "failed"

    def _decode_frame_body(self, body: bytes):
        """K_ROWS body → ``(rows, tss, lanes)``: null-FAITHFUL row decode
        (:func:`unpack_rows` rebuilds ``None`` from the null bits — a
        columns decode would substitute 0 and, worse, recompute a null
        KEY's lane from the substituted value, diverging from the lane
        the sender routed by) with lanes vectorized once per DISTINCT key
        over the faithful values (``astype('U')`` renders ``None`` as
        ``'None'`` — exactly ``_hash_key``'s ``str()``)."""
        rows, tss = unpack_rows(body)
        n = len(rows)
        if n == 0:
            return [], [], np.zeros(0, dtype=np.int64)
        keys = np.empty(n, dtype=object)
        kp = self._key_pos
        for i, row in enumerate(rows):
            keys[i] = row[kp]
        return rows, tss, self._lanes_of_column(keys, n)

    def _apply_frame_locally(self, frame: bytes) -> int:
        """Apply a framed K_ROWS payload to a locally-owned shard through
        the SAME dedup path a remote receiver uses (takeover replay and
        ownership changes mid-send land here)."""
        sender, group, epoch, seq = _ROWS_HDR.unpack_from(frame)
        ctxs, body_off = _unpack_ctxs(frame, _ROWS_HDR.size)
        rows, tss, lanes = self._decode_frame_body(frame[body_off:])
        with self._engine_lock:
            if group not in self._shards:
                raise ConnectionError(
                    f"group {group} not owned here (owner "
                    f"{self.topo.owner.get(group)})")
            if self._is_dup_locked(group, sender, epoch, seq):
                self.dup_frames += 1
                return 0
            for i, (row, ts) in enumerate(zip(rows, tss)):
                self._apply_locked(group, int(lanes[i]), row, ts)
            self._mark_locked(group, sender, epoch, seq)
            # locally re-owned rows count as forwarded ("delivered to the
            # group's owner — us"), keeping the row totals reconcilable
            # across a takeover's spill replay
            self.forwarded += len(rows)
        self._adopt_ctxs(ctxs, sender, group, len(rows))
        return len(rows)

    def _adopt_ctxs(self, ctxs: list, sender: int, group: int,
                    n_rows: int) -> None:
        """Re-activate sampled trace contexts that rode an APPLIED frame:
        each stitches into this host's ring under its original trace id
        with a ``dcn`` hop span (send wall-clock → apply wall-clock, so
        retry and spill-replay delay count as transit — loopback/NTP skew
        is the documented error bar). Dup frames never reach here —
        exactly-once applies to spans too."""
        if not ctxs:
            return
        now_unix = time.time_ns()
        for ctx in ctxs:
            hop_ns = max(0, now_unix - ctx.sent_unix_ns)
            if self.tracer is not None:
                tr = self.tracer.adopt(ctx)
                tr.add_span("dcn", f"h{ctx.origin_host}->h{self.host_index}",
                            hop_ns, batch_size=n_rows)
            if self._transit_tracker is not None:
                self._transit_tracker.record_seconds(
                    hop_ns / 1e9, exemplar=ctx.trace_id)

    # -- dedup (exactly-once across retries, restarts, and failover) ----------
    def _is_dup_locked(self, group: int, sender: int, epoch: int,
                       seq: int) -> bool:
        cur = self._dedup.get(group, {}).get(sender)
        if cur is None:
            return False
        cepoch, cseq = cur
        return epoch < cepoch or (epoch == cepoch and seq <= cseq)

    def _mark_locked(self, group: int, sender: int, epoch: int,
                     seq: int) -> None:
        self._dedup.setdefault(group, {})[sender] = (epoch, seq)

    # -- peer sockets ---------------------------------------------------------
    def _peer_sock_locked(self, host: int) -> socket.socket:
        """Cached data socket to ``host`` (caller holds its sock lock)."""
        s = self._peer_socks.get(host)
        if s is None:
            addr, port = self.peers[host]
            s = socket.create_connection((addr, port),
                                         timeout=self.connect_timeout_s)
            s.settimeout(self.io_timeout_s)
            self._peer_socks[host] = s
            if host in self._ever_connected:
                self.guard.count(host, "reconnects")
            self._ever_connected.add(host)
        return s

    def _drop_peer_sock(self, host: int) -> None:
        """Close + evict the cached socket so the next attempt reconnects
        (a broken connection must never be reused)."""
        with self._sock_locks[host]:
            s = self._peer_socks.pop(host, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def ping_peer(self, peer: int) -> bool:
        """One heartbeat probe on the dedicated heartbeat connection (data
        exchanges never wait behind a probe and vice versa)."""
        timeout = self.guard.config.probe_timeout_s
        with self._hb_locks[peer]:
            s = self._hb_socks.get(peer)
            try:
                if s is None:
                    addr, port = self.peers[peer]
                    s = socket.create_connection((addr, port),
                                                 timeout=timeout)
                    s.settimeout(timeout)
                    self._hb_socks[peer] = s
                send_msg(s, K_PING)
                reply = recv_msg(s, timeout=timeout)
                if reply is not None and reply[0] == K_PONG:
                    return True
                raise ConnectionError(f"peer {peer}: bad heartbeat reply")
            except (OSError, ConnectionError):
                s = self._hb_socks.pop(peer, None)
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                return False

    def _control_exchange(self, host: int, kind: int, payload: bytes,
                          timeout: Optional[float] = None
                          ) -> Optional[tuple]:
        """Best-effort request/reply on the data socket (K_OWNER/K_ADOPT)."""
        try:
            with self._sock_locks[host]:
                s = self._peer_sock_locked(host)
                send_msg(s, kind, payload)
                return recv_msg(s, timeout=timeout or self.io_timeout_s)
        except (OSError, ConnectionError) as e:
            self._drop_peer_sock(host)
            log.warning("host %d: control frame %d to peer %d failed: %s",
                        self.host_index, kind, host, e)
            return None

    def _announce_owner(self, group: int, owner: int) -> None:
        payload = _OWNER_FMT.pack(group, owner)
        for peer in self.peers:
            if self.guard.peer_state(peer) != PEER_DOWN:
                self._control_exchange(peer, K_OWNER, payload)

    # -- spill replay ---------------------------------------------------------
    def replay_spill(self, group: int) -> int:
        """Drain the group's spill queue in order (recovery, takeover, or
        the heartbeat backlog sweep). Stops at the first frame that fails
        again (pushed back intact); returns rows acked by the remote
        owner."""
        with self._group_locks[group]:
            acked_rows = self._drain_spill_group_locked(group)
        if acked_rows:
            with self._engine_lock:
                self.forwarded += acked_rows
        return acked_rows

    def _drain_spill_group_locked(self, group: int) -> int:
        """Replay the backlog in order; caller holds the group lock."""
        q = self.guard.spill(group)
        acked_rows = 0
        while True:
            item = q.pop_front()
            if item is None:
                break
            frame, n = item
            try:
                outcome = self._send_frame(group, frame)
            except Exception:
                # an unexpected engine/transport error must not lose the
                # popped frame — restore it before surfacing
                q.push_front(item)
                raise
            if outcome == "failed":
                q.push_front(item)
                break
            q.mark_replayed(n)
            if outcome == "acked":
                acked_rows += n
        return acked_rows

    # -- failover: takeover / hand-back ---------------------------------------
    def is_designated_survivor(self, dead: int) -> bool:
        """Deterministic survivor election: the lowest-indexed host not
        currently DOWN adopts. Every survivor evaluates the same rule, but
        from its LOCAL failure-detector view — a network partition that
        splits those views can elect two survivors (dual adoption). This
        layer deliberately stops at deadline-based election; deployments
        that must exclude split-brain put a lease/coordinator in front of
        ``take_over`` (see DISTRIBUTED.md)."""
        alive = [self.host_index] + [
            p for p in self.peers
            if p != dead and self.guard.peer_state(p) != PEER_DOWN]
        return self.host_index == min(alive)

    def take_over(self, group: int, refresh: bool = False) -> bool:
        """Adopt a lane group: restore its latest snapshot revision (state
        pytree keyed by global lane ids + the group's dedup table), re-point
        the topology, announce ownership, and replay any spilled frames —
        which now apply locally through the same dedup path.

        ``refresh=True`` (the K_ADOPT hand-back path) re-restores even when
        the group is already held: a restarted home host may have rebuilt
        its home shard from a PRE-handoff revision at startup, and keeping
        that state would drop every row the survivor applied since."""
        if group in self._shards and not refresh:
            return False          # cheap unlocked pre-check; re-checked below
        # the slow work — snapshot-store disk read, shard construction
        # (plan and kernel load), state restore — runs on a PRIVATE shard
        # with no lock
        # held: holding _engine_lock here would stall every ingest/serve
        # thread past their ack deadlines and churn the whole cluster
        snap = (self.snapshot_store.latest(group)
                if self.snapshot_store is not None else None)
        shard = self._build_shard()
        if snap is not None:
            self._restore_shard_state(group, shard, snap)
        with self._engine_lock:
            existing = self._shards.get(group)
            if existing is not None and not refresh:
                return False      # raced another adopter
            if existing is not None and snap is None:
                return False      # nothing to re-restore from: keep state
            if existing is not None:
                # the replaced shard's rows are gone — loud, not silent. A
                # host that may have been failed over should restart with a
                # STANDBY owner map (home group pointed at the survivor) so
                # nothing lands here before the hand-back (DISTRIBUTED.md)
                log.warning(
                    "host %d: re-restoring group %d discards a live shard "
                    "(match_count=%d) in favor of the handed-back revision",
                    self.host_index, group, existing.match_count)
            if snap is not None:
                self._merge_dedup_locked(group, snap)
            self._shards[group] = shard
            if group == self.host_index:
                self.rt = shard
            self.topo.reassign(group, self.host_index)
            self.takeovers += 1
        if self.flight is not None:
            self.flight.record("dcn", "takeover", site=f"group{group}",
                               detail={"refresh": refresh,
                                       "host": self.host_index})
        log.info("host %d: took over lane group %d", self.host_index, group)
        # announce off the caller (usually the heartbeat thread): serial
        # request/reply to every peer at io_timeout each would stall
        # failure detection of OTHER peers. An uninformed peer keeps
        # sending to the dead host, spills, and the sweep replays here.
        threading.Thread(target=self._announce_owner,
                         args=(group, self.host_index), daemon=True).start()
        self.replay_spill(group)
        return True

    def release_group(self, group: int) -> bool:
        """Hand an adopted group back to its recovered home host: snapshot
        the adopted state (new revision), drop the shard, re-point the
        topology, and drive the returning host's restore with ``K_ADOPT`` —
        the takeover handoff in reverse."""
        home = group
        with self._engine_lock:
            shard = self._shards.get(group)
            if shard is None or group == self.host_index:
                return False
            shard.flush(decode=self.on_rows is not None)
            if self.snapshot_store is not None:
                self._save_group_locked(group, shard)
            del self._shards[group]
            self.topo.reassign(group, home)
        if self.flight is not None:
            self.flight.record("dcn", "rejoin", site=f"group{group}",
                               detail={"home": home,
                                       "host": self.host_index})
        log.info("host %d: released lane group %d back to host %d",
                 self.host_index, group, home)
        # no K_OWNER broadcast here: home's own take_over announces once the
        # restore is done. In the handoff window a frame for this group can
        # bounce between redirects; the sender's redirect bound turns that
        # into a retry/spill (replayed once ownership settles), never a loss.
        # Two K_ADOPT attempts: the first may hit the cached pre-crash
        # socket (it gets dropped), the second dials the recovered host
        # fresh. The home host acks only AFTER its restore completes —
        # which includes a shard rebuild (plan and kernel load) — so this
        # exchange
        # gets a much longer deadline than a data frame; a rollback on a
        # handoff that was merely slow would leave both hosts owning the
        # group.
        adopt_timeout = max(60.0, self.io_timeout_s)
        for _ in range(2):
            reply = self._control_exchange(home, K_ADOPT,
                                           _ADOPT_FMT.pack(group),
                                           timeout=adopt_timeout)
            if reply is not None and reply[0] == K_ACK:
                self.rejoins += 1
                return True
        # unconfirmed handoff must not strand the group: re-adopt from the
        # revision saved above (no loss — nothing applied here since), and
        # trip the peer's detector so the probe cycle re-drives the
        # hand-back instead of leaving it half-done forever
        log.warning("host %d: K_ADOPT handoff of group %d to host %d "
                    "failed; re-adopting and re-marking the peer down",
                    self.host_index, group, home)
        self.take_over(group, refresh=True)
        self.guard.health(home).trip()
        return False

    # -- snapshots (global-lane-keyed lane-group state) -----------------------
    def snapshot(self) -> dict:
        """Flush + persist every owned group's state; returns
        ``{group: revision}``. The saved revision carries the group's dedup
        table so exactly-once survives a restore."""
        if self.snapshot_store is None:
            raise ValueError("no snapshot store configured")
        revs = {}
        with self._engine_lock:
            for g, shard in self._shards.items():
                shard.flush(decode=self.on_rows is not None)
                revs[g] = self._save_group_locked(g, shard)
            self.snapshots += 1
        return revs

    def _save_group_locked(self, group: int,
                           shard: PartitionedNFARuntime) -> int:
        leaves = state_leaves(shard.state)
        return self.snapshot_store.save(
            group, list(self.topo.lanes_of_group(group)), leaves,
            self._dedup.get(group, {}),
            dicts=shard.compiler.merged.snapshot_dictionaries())

    def _restore_shard_state(self, group: int,
                             shard: PartitionedNFARuntime,
                             snap: dict) -> None:
        """State + dictionaries onto a PRIVATE (unpublished) shard — no
        lock needed; the dedup merge happens separately under the lock.
        The leaves land on the shard's device."""
        proto = shard.state
        saved = snap["leaves"]
        n = state_leaf_count(proto)
        if len(saved) != n:
            raise ValueError(
                f"group {group} snapshot has {len(saved)} leaves, "
                f"runtime expects {n} (app/config mismatch)")
        shard.state = state_from_leaves(proto, saved, shard.device)
        # state slots store dictionary CODES: the dictionary must restore
        # with them or key-equality filters compare garbage in a fresh
        # process (the device_state_snapshot contract, per lane group)
        shard.compiler.merged.restore_dictionaries(snap.get("dicts", {}))

    def _merge_dedup_locked(self, group: int, snap: dict) -> None:
        merged = self._dedup.setdefault(group, {})
        for sender, mark in snap["dedup"].items():
            cur = merged.get(sender)
            if cur is None or mark > cur:
                merged[sender] = mark

    def _maybe_snapshot(self, group: int, due: bool) -> None:
        """Per-frame durability persists ONLY the group the frame applied
        to — ack latency must not scale with the number of adopted groups."""
        if not due or self.snapshot_store is None:
            return
        with self._engine_lock:
            shard = self._shards.get(group)
            if shard is not None:
                shard.flush(decode=self.on_rows is not None)
                self._save_group_locked(group, shard)
                self.snapshots += 1

    # -- DCN server side ------------------------------------------------------
    def _accept_loop(self) -> None:
        try:
            self._srv.settimeout(0.5)  # accept() wakes to observe shutdown
        except OSError:
            return                     # closed before the loop started
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue              # periodic shutdown check
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            # prune finished threads: a flapping peer reconnects constantly
            # and the list must not grow for the worker's lifetime
            self._serve_threads = [x for x in self._serve_threads
                                   if x.is_alive()]
            self._serve_threads.append(t)
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        conn.settimeout(self.io_timeout_s)
        self._conns.add(conn)
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_msg(conn, timeout=self.io_timeout_s)
                except socket.timeout:
                    continue          # idle between frames; re-check stop
                except (OSError, ConnectionError):
                    return
                if msg is None:
                    return
                kind, payload = msg
                try:
                    if kind == K_ROWS:
                        self._handle_rows(conn, payload)
                    elif kind == K_PING:
                        send_msg(conn, K_PONG)
                    elif kind == K_OWNER:
                        g, owner = _OWNER_FMT.unpack(payload)
                        with self._engine_lock:
                            self.topo.reassign(g, owner)
                        send_msg(conn, K_ACK)
                    elif kind == K_ADOPT:
                        (g,) = _ADOPT_FMT.unpack(payload)
                        self.take_over(g, refresh=True)
                        send_msg(conn, K_ACK)
                    elif kind == K_FLUSH:
                        self.flush()
                        send_msg(conn, K_FLUSHED,
                                 struct.pack(">q", self.match_count))
                except ChaosFault:
                    return            # injected peer kill: die without ack
                except (OSError, ConnectionError):
                    return
                except Exception:     # noqa: BLE001 — counted + logged:
                    # an engine failure mid-frame must not kill the serve
                    # thread silently; no ack goes out, so the sender
                    # retries/spills (see _handle_rows on frame atomicity)
                    self.frame_errors += 1
                    log.exception("host %d: serve failed on frame kind %d",
                                  self.host_index, kind)
                    return
        finally:
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle_rows(self, conn: socket.socket, payload: bytes) -> None:
        # Frame atomicity caveat: rows apply before the dedup mark, with no
        # rollback — an engine exception MID-frame (counted in
        # frame_errors) leaves head rows applied and unmarked, so a retry
        # could re-apply them. Append-path failures are deterministic (a
        # poison frame fails identically on retry, no double apply); only a
        # transient device-step failure mid-frame can break exactly-once,
        # and WAL-grade frame atomicity is the flow layer's job, not the
        # transport's.
        sender, group, epoch, seq = _ROWS_HDR.unpack_from(payload)
        site = f"dcn:serve:{self.host_index}"
        if self.chaos is not None:
            self.chaos.on_dcn_serve(site)   # kill-peer site: abort, no ack
        ctxs, body_off = _unpack_ctxs(payload, _ROWS_HDR.size)
        rows, tss, lanes = self._decode_frame_body(payload[body_off:])
        redirect = None
        due = False
        applied = False
        with self._engine_lock:
            if group not in self._shards:
                redirect = self.topo.owner[group]
            elif self._is_dup_locked(group, sender, epoch, seq):
                # the retry of a frame whose ack was lost: exactly-once
                # means ack again, apply nothing
                self.dup_frames += 1
            else:
                for i, (row, ts) in enumerate(zip(rows, tss)):
                    self.received += 1
                    self._apply_locked(group, int(lanes[i]), row, ts)
                self._mark_locked(group, sender, epoch, seq)
                applied = True
                # the durability cadence is PER GROUP: a global counter
                # with interleaved senders could systematically skip one
                # group's snapshots (unbounded loss instead of <= N-1
                # frames)
                c = self._frames_applied.get(group, 0) + 1
                self._frames_applied[group] = c
                n = self.snapshot_every_frames
                due = bool(n) and c % n == 0
        if applied:
            # adopt ONLY on an actual apply — a deduped retry must not
            # double-stamp hop spans
            self._adopt_ctxs(ctxs, sender, group, len(rows))
        if redirect is not None:
            # stale routing at the sender: point it at the current owner;
            # it re-sends the SAME frame there, so dedup state stays with
            # the lane group and nothing applies twice
            send_msg(conn, K_OWNER, _OWNER_FMT.pack(group, redirect))
            return
        # durability before the ack: at snapshot_every_frames=1 an acked
        # frame is guaranteed restorable
        self._maybe_snapshot(group, due)
        if self.chaos is not None:
            self.chaos.on_dcn_ack(site)     # ack-delay site
        send_msg(conn, K_ACK)

    def flush(self) -> None:
        with self._engine_lock:
            for shard in self._shards.values():
                shard.flush(decode=self.on_rows is not None)

    @property
    def match_count(self) -> int:
        with self._engine_lock:
            return sum(rt.match_count for rt in self._shards.values())

    # -- observability --------------------------------------------------------
    def report(self) -> dict:
        """Service-facing state (GET /siddhi-apps/{name}/dcn)."""
        with self._engine_lock:
            owner = {str(g): o for g, o in self.topo.owner.items()}
            owned = sorted(self._shards)
        return {
            "host": self.host_index, "epoch": self.epoch,
            "topology": {"num_lanes": self.topo.num_lanes,
                         "num_hosts": self.topo.num_hosts,
                         "lanes_per_host": self.topo.lanes_per_host,
                         "owner": owner},
            "owned_groups": owned,
            "forwarded_rows": self.forwarded,
            "forward_chunk_rows": self.forward_chunk_rows,
            "received_rows": self.received,
            "dup_frames": self.dup_frames,
            "takeovers": self.takeovers,
            "rejoins": self.rejoins,
            "snapshots": self.snapshots,
            "match_count": self.match_count,
            **self.guard.report(),
        }

    def register_metrics(self, sm) -> None:
        """Expose peer/spill/failover state as ``dcn.*`` trackers so the
        Prometheus exposition renders ``siddhi_tpu_dcn_*`` families (label
        ``peer`` = host or lane-group index, ``self`` for worker-level)."""
        guard = self.guard
        for peer in self.peers:
            sm.gauge_tracker(f"dcn.{peer}.peer_state",
                             lambda p=peer: guard.health(p).state_code)
            for key in ("pings", "ping_failures", "retries", "reconnects",
                        "redirects"):
                sm.gauge_tracker(
                    f"dcn.{peer}.{key}_total",
                    lambda p=peer, k=key: guard.peer_counters[p][k])
        # every group, INCLUDING the home one: a standby restart (home
        # group owned by the survivor) spills home-group frames too, and
        # that backlog must not be a metrics blind spot
        for g in range(self.topo.num_hosts):
            sm.gauge_tracker(f"dcn.{g}.spill_depth",
                             lambda gg=g: len(guard.spill(gg)))
            sm.gauge_tracker(
                f"dcn.{g}.spilled_frames_total",
                lambda gg=g: guard.spill(gg).spilled_frames)
            sm.gauge_tracker(
                f"dcn.{g}.spill_replayed_frames_total",
                lambda gg=g: guard.spill(gg).replayed_frames)
            sm.gauge_tracker(
                f"dcn.{g}.spill_dropped_frames_total",
                lambda gg=g: (guard.spill(gg).dropped_oldest_frames
                              + guard.spill(gg).shed_frames))
        sm.gauge_tracker("dcn.self.forwarded_rows_total",
                         lambda: self.forwarded)
        # the bulk SoA path: rows that shipped as whole RowsChunk frames
        # (ingest_chunk → pack_columns) — the ingest-saturation evidence
        sm.gauge_tracker("dcn.forward.rows_total",
                         lambda: self.forward_chunk_rows)
        sm.gauge_tracker("dcn.self.received_rows_total",
                         lambda: self.received)
        sm.gauge_tracker("dcn.self.dup_frames_total",
                         lambda: self.dup_frames)
        sm.gauge_tracker("dcn.self.takeovers_total", lambda: self.takeovers)
        sm.gauge_tracker("dcn.self.rejoins_total", lambda: self.rejoins)
        sm.gauge_tracker("dcn.self.snapshots_total", lambda: self.snapshots)
        sm.gauge_tracker("dcn.self.owned_groups",
                         lambda: len(self._shards))
        # the dcn_transit phase histogram: cross-host hop time (send
        # wall-clock → apply) for frames carrying sampled trace contexts
        self._transit_tracker = sm.latency_tracker("dcn.self.transit")
        self._sm = sm

    def close(self) -> None:
        self._stop.set()
        self.guard.stop()
        try:
            self._srv.close()
        except OSError:
            pass
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass
        for socks in (self._peer_socks, self._hb_socks):
            for s in list(socks.values()):
                try:
                    s.close()
                except OSError:
                    pass
        self._accept_thread.join(timeout=5)
        for t in self._serve_threads:
            t.join(timeout=1)
        if self._sm is not None:
            self._sm.unregister("dcn.")
            self._sm = None


class DCNIngestClient:
    """External bulk-ingest feeder for one DCNWorker's data port — the
    worker-owned ingest path of the procmesh runtime: a parent process (or
    a bench feeder) frames rows as ``K_ROWS`` straight into a child's DCN
    data plane, never touching the control socket.

    Speaks the exact peer wire: ``(sender, group, epoch, seq)`` prefix,
    empty trace-context block, :func:`pack_rows` SoA body. The receiver's
    per-``(sender→group)`` dedup table makes a retried frame (lost ack)
    idempotent, so the client retries with ONE reconnect per send — the
    same discipline as the peer forwarding machine, minus redirects (an
    external feeder targets one worker that owns its groups).

    ``sender`` defaults to 255: host indices are small dense ints, so the
    top of the u8 space is free for external feeders (two feeders into one
    group need distinct sender ids or their seq spaces collide)."""

    EXTERNAL_SENDER = 255

    def __init__(self, port: int, types: str, *, sender: int = 255,
                 group: int = 0, epoch: int = 0,
                 connect_timeout_s: float = CONNECT_TIMEOUT_S,
                 io_timeout_s: float = IO_TIMEOUT_S):
        self.port = int(port)
        self.types = types
        self.sender = int(sender)
        self.group = int(group)
        self.epoch = int(epoch)
        self.connect_timeout_s = connect_timeout_s
        self.io_timeout_s = io_timeout_s
        self.seq = 0
        self.sent_rows = 0
        self.retries = 0
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _socket(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(("127.0.0.1", self.port),
                                         timeout=self.connect_timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _exchange(self, kind: int, payload: bytes):
        """One framed request/reply with a single reconnect retry (every
        frame kind here is idempotent: K_ROWS dedups by seq, K_FLUSH is a
        barrier)."""
        for attempt in (0, 1):
            try:
                s = self._socket()
                send_msg(s, kind, payload)
                reply = recv_msg(s, timeout=self.io_timeout_s)
                if reply is None:
                    raise ConnectionError("worker closed before ack")
                return reply
            except (OSError, ConnectionError):
                self._drop()
                if attempt:
                    raise
                self.retries += 1

    def send(self, rows: list, timestamps: list) -> None:
        """Ship one seq-stamped chunk; returns once the worker ACKED it
        (applied or deduped — either way it is durable per the worker's
        snapshot cadence)."""
        with self._lock:
            self.seq += 1
            frame = (_ROWS_HDR.pack(self.sender, self.group, self.epoch,
                                    self.seq)
                     + _pack_ctxs([])
                     + pack_rows(self.types, rows, timestamps))
            kind, _ = self._exchange(K_ROWS, frame)
            if kind != K_ACK:
                raise ConnectionError(
                    f"expected K_ACK for seq {self.seq}, got kind {kind}")
            self.sent_rows += len(rows)

    def flush(self) -> int:
        """Flush barrier: the worker drains staged lanes; returns its
        match_count."""
        with self._lock:
            kind, payload = self._exchange(K_FLUSH, b"")
            if kind != K_FLUSHED:
                raise ConnectionError(
                    f"expected K_FLUSHED, got kind {kind}")
            return struct.unpack(">q", payload)[0]

    def close(self) -> None:
        with self._lock:
            self._drop()
