"""procmesh control-socket wire format.

The port's copy of the JAX package's ``procmesh/protocol.py``, the same
bytes on the wire: the lane pool (``lanepool.py``) and the process mesh
(``worker.py``, ``host.py``, ``supervisor.py``) speak it. One frame per
control operation, the DCN tier's length-prefixed framing
(``gpu/dcn.py``'s ``>BI`` header) widened with integrity fields — a JSON
header + optional binary body instead of fixed structs — control ops are
low-rate and schema-rich (deploy carries app text, snapshot/restore
carry state blobs, ingest carries row chunks), so the header stays
readable while blobs stay raw:

``frame  := kind u8 · length u32 · crc32 u32 · seq u32 · payload``
``payload:= hdr_len u32 · json header · body bytes``

Kinds: ``F_REQ`` (supervisor/fabric → worker), ``F_RES`` (success reply),
``F_ERR`` (structured failure reply — the op raised; the connection stays
usable). Every request carries ``{"op": ...}``; replies echo nothing (the
protocol is strictly one-in-flight per connection, so responses pair by
order).

Gray-failure hardening: ``crc32`` covers the payload — a
mismatch means the stream is corrupt and can never resync, so the
receiver raises ``ConnectionError`` (the client drops the connection and
idempotent ops retry over a fresh one). ``seq`` is a per-connection
per-direction monotone counter — a frame whose seq is ≤ the last one
seen is a duplicate delivery and is dropped silently (the receiver reads
the next frame). Both faults are injectable deterministically through
:class:`WireChaos`; detections count in :data:`WIRE_COUNTERS`.

Deadline discipline: every blocking read arms a socket timeout first —
``_recv_exact`` refuses a timeout-less socket outright, the invariant
the JAX package's ``scripts/check_socket_timeouts.py`` pins (the port's
``tests/test_torch_dcn.py`` applies it to this package). A timeout
at a frame boundary means *idle* (pollers continue); a timeout or close
mid-frame means the stream can never resync and raises
``ConnectionError``. Deadlines are no longer module constants: they
resolve through :func:`io_timeout_s` / :func:`connect_timeout_s`
(explicit override > ``SIDDHI_PROCMESH_IO_TIMEOUT_S`` /
``SIDDHI_PROCMESH_CONNECT_TIMEOUT_S`` env > default), and per-op
budgets derive from the tenant's SLO class via :func:`op_deadline_s`.

Ingest rows ride either JSON (``enc='json'``, any row shape) or the DCN
SoA wire (``enc='soa'`` — :func:`~siddhi_tpu_torch.gpu.dcn.pack_rows` bytes in
the body, the worker-owned bulk hand-off decoded by ``unpack_rows`` on
the child), chosen per chunk by whether a types string covers the rows.
An ingest header may additionally carry ``trace`` — a hex-packed
:class:`~siddhi_tpu_torch.observability.tracing.TraceContext` the child adopts
only on actual apply (seq dedup ⇒ exactly-once spans).

Observability federation: the ``metrics`` op reply ships FULL
tracker state — ``gauges`` (floats), ``counters`` (ints), ``latency``
(serialized :meth:`LogHistogram.state` dumps, mergeable by summing
counts on the fixed quarter-octave ladder) — plus a ``unix_ns`` scrape
stamp; ``ping`` replies and the ``PROCMESH_READY`` hello carry
``unix_ns`` so the supervisor can estimate each shard's wall-clock
offset; ``flight`` replies carry a ``traces`` tail of grown trace
journeys for parent-side stitching.
"""

from __future__ import annotations

import json
import os
import random
import socket
import struct
import time
import weakref
import zlib
from typing import Optional

_HDR = struct.Struct(">BIII")   # kind + payload length + crc32 + seq
_JLEN = struct.Struct(">I")     # json header length inside the payload

F_REQ, F_RES, F_ERR = 1, 2, 3

CONNECT_TIMEOUT_S = 5.0
# ops include deploys (parse + plan compile + kernel load on the child) and
# chunk-cadence snapshots; generous next to the DCN data-plane deadline
IO_TIMEOUT_S = 30.0
# child boot = interpreter + siddhi_tpu_torch import (torch) + socket bind,
# under fork-storm contention on a saturated machine
READY_TIMEOUT_S = 120.0

MAX_FRAME = 256 * 1024 * 1024   # desync guard: one tenant snapshot tops out
# far below this; a larger length prefix means a corrupt stream


def io_timeout_s(override: Optional[float] = None) -> float:
    """Control-op IO deadline: explicit override (``MeshConfig``) >
    ``SIDDHI_PROCMESH_IO_TIMEOUT_S`` env > module default."""
    if override is not None:
        return float(override)
    env = os.environ.get("SIDDHI_PROCMESH_IO_TIMEOUT_S")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return IO_TIMEOUT_S


def connect_timeout_s(override: Optional[float] = None) -> float:
    """Dial deadline: explicit override > env > module default."""
    if override is not None:
        return float(override)
    env = os.environ.get("SIDDHI_PROCMESH_CONNECT_TIMEOUT_S")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return CONNECT_TIMEOUT_S


# Per-op deadline budgets as multiples of the base IO deadline: data-plane
# and read-only ops get tight budgets (they are hedge-safe and retried),
# deploys/restores get room (parse + plan compile on the child). A
# tenant's SLO class scales the whole budget — premium tenants would
# rather fail over fast than wait out a generous deadline, besteffort
# tenants prefer patience over churn.
OP_BUDGET_SCALE = {
    "ping": 0.25,
    "ingest": 0.5, "resync": 0.5, "flight": 0.5,
    "metrics": 0.5, "evidence": 0.5, "subscribe": 0.5,
    "snapshot": 1.0, "flush": 1.0, "undeploy": 1.0,
    "deploy": 2.0, "restore": 2.0,
}
SLO_CLASS_SCALE = {"premium": 0.5, "standard": 1.0, "besteffort": 1.5}


def op_deadline_s(op: str, slo_class: Optional[str] = None,
                  base_s: Optional[float] = None) -> float:
    """Per-op deadline budget: ``base × op-class scale × SLO-class scale``
    (replaces the one-size ``IO_TIMEOUT_S`` on proxy ops)."""
    base = io_timeout_s(base_s)
    return (base * OP_BUDGET_SCALE.get(op, 1.0)
            * SLO_CLASS_SCALE.get(slo_class or "standard", 1.0))


def runfile_path(run_dir: str, index: int) -> str:
    return os.path.join(run_dir, f"w{index}.run")


def write_runfile(run_dir: str, index: int, port: int, pid: int,
                  nonce: str) -> None:
    """Persist a worker's boot identity (atomic rename, fsynced): the
    handshake artifact a restarted supervisor scans to re-adopt live
    shards. Written by the child before it prints ``PROCMESH_READY``."""
    os.makedirs(run_dir, exist_ok=True)
    path = runfile_path(run_dir, index)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"index": index, "port": port, "pid": pid,
                   "nonce": nonce}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_runfile(run_dir: str, index: int) -> Optional[dict]:
    """Load one worker's runfile; None when absent or unreadable (a torn
    tmp never lands on the final name — ``os.replace`` is atomic)."""
    try:
        with open(runfile_path(run_dir, index), encoding="utf-8") as f:
            rf = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(rf, dict) or "port" not in rf or "pid" not in rf:
        return None
    return rf


def child_env(base: Optional[dict] = None) -> dict:
    """Spawn env for a worker/lane child: the parent may have found
    ``siddhi_tpu_torch`` via a ``sys.path`` insert (script-style embedding) that a
    fresh interpreter won't repeat, so prepend the package's parent dir to
    PYTHONPATH."""
    env = dict(os.environ if base is None else base)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parts = [pkg_root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                          if p and p != pkg_root]
    env["PYTHONPATH"] = os.pathsep.join(parts)
    return env


class WorkerDown(ConnectionError):
    """The worker's control socket is gone (crash, SIGKILL, stop): the op
    did not complete and the caller must spill/retry through recovery."""


class WorkerOpError(RuntimeError):
    """The worker executed the op and reports a structured failure (the
    connection itself is fine)."""


# ---------------------------------------------------------------------------
# wire integrity: per-connection frame seqs + detection counters

# Per-socket monotone frame counters, one per direction. Keyed weakly on
# the socket object so a dropped connection (the one recovery path for a
# corrupt stream) resets both streams for free.
_SEND_SEQ: "weakref.WeakKeyDictionary[socket.socket, int]" = \
    weakref.WeakKeyDictionary()
_RECV_SEQ: "weakref.WeakKeyDictionary[socket.socket, int]" = \
    weakref.WeakKeyDictionary()

# Process-wide detections (receiver side). A worker surfaces its copy in
# ``ping``/``evidence`` replies; the parent's copy feeds bench evidence.
WIRE_COUNTERS = {"crc_rejected": 0, "dup_frames_dropped": 0}


def wire_counters() -> dict:
    return dict(WIRE_COUNTERS)


class WireChaos:
    """Deterministic wire-level fault interposer.

    Seeded per-site exactly like :class:`~siddhi_tpu_torch.resilience.chaos
    .ChaosInjector` — ``Random((seed << 32) ^ crc32(site))`` — so a
    given (seed, site) pair replays the same fault schedule regardless
    of unrelated traffic. Sites are op names (``ingest``, ``snapshot``;
    replies roll on the same op site via :func:`request`).

    Faults, all injected in the PARENT process (children never install
    an interposer):

    - ``delay_p`` / ``delay_ms``: hold the frame before sending;
    - ``drop_send_p``: one-direction partition parent→worker — the
      request never leaves, the caller times out against its budget;
    - ``drop_recv_p``: one-direction partition worker→parent — the reply
      is consumed off the wire then discarded, surfacing as
      ``socket.timeout`` (the caller must treat the connection as
      desynced, exactly like a real lost reply);
    - ``corrupt_p``: flip one payload byte AFTER the CRC is computed —
      the receiver's CRC check must reject the frame;
    - ``dup_p``: send the frame twice — the receiver's seq dedup must
      drop the second copy.

    ``ops`` (a set) restricts faults to those op sites; ``fault_budget``
    caps total injected faults (deterministic single-fault tests).
    Mutable mid-run, like ``ChaosInjector``.
    """

    def __init__(self, seed: int = 0, delay_ms: float = 0.0,
                 delay_p: float = 0.0, drop_send_p: float = 0.0,
                 drop_recv_p: float = 0.0, corrupt_p: float = 0.0,
                 dup_p: float = 0.0, ops: Optional[set] = None,
                 fault_budget: Optional[int] = None):
        self.seed = int(seed)
        self.delay_ms = float(delay_ms)
        self.delay_p = float(delay_p)
        self.drop_send_p = float(drop_send_p)
        self.drop_recv_p = float(drop_recv_p)
        self.corrupt_p = float(corrupt_p)
        self.dup_p = float(dup_p)
        self.ops = set(ops) if ops is not None else None
        self.fault_budget = fault_budget
        self._rngs: dict = {}
        self.counters = {"delayed": 0, "dropped_send": 0,
                         "dropped_recv": 0, "corrupted": 0,
                         "duplicated": 0}

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(
                (self.seed << 32) ^ zlib.crc32(site.encode()))
        return rng

    def _roll(self, site: str, p: float) -> bool:
        if p <= 0.0:
            return False
        return self._rng(site).random() < p

    def _take(self, kind: str) -> bool:
        """Consume one unit of fault budget; False when exhausted."""
        if self.fault_budget is not None:
            if self.fault_budget <= 0:
                return False
            self.fault_budget -= 1
        self.counters[kind] += 1
        return True

    def _applies(self, site: str) -> bool:
        return self.ops is None or site in self.ops

    def on_send(self, site: str, frame: bytes,
                payload_off: int) -> Optional[bytes]:
        """Transform an outbound frame; None means partitioned (dropped
        on the floor — the caller's deadline does the detecting)."""
        if not self._applies(site):
            return frame
        if self._roll(site, self.delay_p) and self._take("delayed"):
            time.sleep(self.delay_ms / 1000.0)
        if self._roll(site, self.drop_send_p) and self._take("dropped_send"):
            return None
        if self._roll(site, self.corrupt_p) and self._take("corrupted"):
            # flip a payload byte AFTER the CRC was stamped: the receiver
            # must detect this, never deliver it
            i = payload_off + self._rng(site).randrange(
                max(len(frame) - payload_off, 1))
            i = min(i, len(frame) - 1)
            frame = frame[:i] + bytes([frame[i] ^ 0xFF]) + frame[i + 1:]
        if self._roll(site, self.dup_p) and self._take("duplicated"):
            frame = frame + frame    # same seq twice: dedup must drop one
        return frame

    def on_recv(self, site: str) -> bool:
        """True → discard the just-received reply (worker→parent
        partition); the caller sees a timeout."""
        if not self._applies(site):
            return False
        return self._roll(site, self.drop_recv_p) \
            and self._take("dropped_recv")

    def report(self) -> dict:
        return {"seed": self.seed,
                "probabilities": {"delay": self.delay_p,
                                  "drop_send": self.drop_send_p,
                                  "drop_recv": self.drop_recv_p,
                                  "corrupt": self.corrupt_p,
                                  "dup": self.dup_p},
                "counters": dict(self.counters)}


_WIRE_CHAOS: Optional[WireChaos] = None


def install_wire_chaos(chaos: Optional[WireChaos]) -> Optional[WireChaos]:
    """Install (or clear, with None) the process-wide interposer; returns
    the previous one so tests can restore it in a finally."""
    global _WIRE_CHAOS
    prev, _WIRE_CHAOS = _WIRE_CHAOS, chaos
    return prev


def send_frame(sock: socket.socket, kind: int, header: dict,
               body: bytes = b"", site: Optional[str] = None) -> None:
    j = json.dumps(header, separators=(",", ":")).encode()
    payload = _JLEN.pack(len(j)) + j + body
    seq = (_SEND_SEQ.get(sock, 0) + 1) & 0xFFFFFFFF
    _SEND_SEQ[sock] = seq
    frame = _HDR.pack(kind, len(payload), zlib.crc32(payload), seq) + payload
    chaos = _WIRE_CHAOS
    if chaos is not None:
        out = chaos.on_send(site or f"k{kind}", frame, _HDR.size)
        if out is None:
            return              # partitioned: never hits the wire
        frame = out
    sock.sendall(frame)


def recv_frame(sock: socket.socket, timeout: Optional[float] = None,
               site: Optional[str] = None):
    """Returns ``(kind, header, body)`` or None on a cleanly closed
    connection. Arms the deadline; idle timeouts surface as
    ``socket.timeout`` only at a frame boundary. Verifies the payload
    CRC (mismatch ⇒ the stream is corrupt ⇒ ``ConnectionError``) and
    drops duplicate frames (seq ≤ last seen) silently."""
    sock.settimeout(io_timeout_s() if timeout is None else timeout)
    while True:
        hdr = _recv_exact(sock, _HDR.size)
        if hdr is None:
            return None
        kind, n, crc, seq = _HDR.unpack(hdr)
        if n > MAX_FRAME:
            raise ConnectionError(f"oversized frame ({n} bytes): desynced")
        payload = _recv_exact(sock, n) if n else b""
        if payload is None or len(payload) < _JLEN.size:
            raise ConnectionError("connection closed mid-frame")
        if zlib.crc32(payload) != crc:
            WIRE_COUNTERS["crc_rejected"] += 1
            raise ConnectionError(
                "frame crc mismatch: corrupt stream, cannot resync")
        last = _RECV_SEQ.get(sock, 0)
        if seq <= last:
            # duplicate delivery: drop and read the next frame — the
            # one-in-flight pairing stays intact
            WIRE_COUNTERS["dup_frames_dropped"] += 1
            continue
        _RECV_SEQ[sock] = seq
        chaos = _WIRE_CHAOS
        if chaos is not None and kind != F_REQ \
                and chaos.on_recv(site or "recv"):
            # reply partitioned worker→parent: to the caller this IS a
            # lost reply — surface the same way (deadline expiry)
            raise socket.timeout("wire chaos: reply partitioned")
        (jn,) = _JLEN.unpack_from(payload, 0)
        header = json.loads(payload[_JLEN.size:_JLEN.size + jn].decode())
        return kind, header, payload[_JLEN.size + jn:]


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    if sock.gettimeout() is None:
        # every blocking recv in this package must carry a deadline
        # (the socket-timeout lint pins the same invariant)
        raise ValueError("blocking recv on a socket without a timeout")
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if buf:
                # a half-read frame can never resync
                raise ConnectionError(
                    "connection timed out mid-frame") from None
            raise
        if not chunk:
            if buf:
                raise ConnectionError("connection closed mid-frame")
            return None
        buf += chunk
    return buf


def request(sock: socket.socket, op: str, header: Optional[dict] = None,
            body: bytes = b"", timeout: Optional[float] = None):
    """One synchronous control op: send ``F_REQ``, block for the paired
    reply. Returns ``(header, body)``; raises :class:`WorkerOpError` on an
    ``F_ERR`` reply and :class:`WorkerDown` when the socket dies.

    The op's deadline is scoped to the op: the socket's prior timeout is
    restored on every exit path, so a generous snapshot budget never
    becomes the next op's idle deadline."""
    h = dict(header or ())
    h["op"] = op
    if timeout is None:
        timeout = io_timeout_s()
    try:
        prev = sock.gettimeout()
    except OSError:
        prev = None
    try:
        send_frame(sock, F_REQ, h, body, site=op)
        res = recv_frame(sock, timeout=timeout, site=op)
    except socket.timeout as e:
        raise WorkerDown(f"worker op '{op}' timed out") from e
    except (OSError, ConnectionError) as e:
        raise WorkerDown(f"worker op '{op}' failed: {e}") from e
    finally:
        if prev is not None:
            try:
                sock.settimeout(prev)
            except OSError:
                pass            # socket already dead: nothing to restore
    if res is None:
        raise WorkerDown(f"worker closed during op '{op}'")
    kind, rh, rbody = res
    if kind == F_ERR:
        raise WorkerOpError(rh.get("error", "worker op failed"))
    if kind != F_RES:
        raise WorkerDown(f"unexpected frame kind {kind} for op '{op}'")
    return rh, rbody


def connect(port: int, timeout: Optional[float] = None,
            io_timeout: Optional[float] = None) -> socket.socket:
    """Dial a worker's control port (loopback only — procmesh children are
    co-resident by construction) with connect + IO deadlines armed. A
    refused/unreachable dial means the process is gone: ``WorkerDown``."""
    timeout = connect_timeout_s(timeout)
    try:
        sock = socket.create_connection(
            ("127.0.0.1", port), timeout=timeout)
    except (OSError, socket.timeout) as e:
        raise WorkerDown(f"worker port {port} unreachable: {e}") from e
    sock.settimeout(io_timeout_s(io_timeout))
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass                        # best-effort: control ops are small
    return sock
