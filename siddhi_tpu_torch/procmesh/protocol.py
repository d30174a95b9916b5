"""procmesh control-socket wire format.

The port's copy of the JAX package's ``procmesh/protocol.py``, cut to what
the lane pool (``lanepool.py``) uses: the frames, their deadlines and the
child's environment. One frame per control operation — a JSON header and
an optional binary body:

``frame  := kind u8 · length u32 · crc32 u32 · seq u32 · payload``
``payload:= hdr_len u32 · json header · body bytes``

Kinds: ``F_REQ`` (parent → child), ``F_RES`` (success reply), ``F_ERR``
(structured failure reply — the op raised; the connection stays usable).
Every request carries ``{"op": ...}``; the protocol is strictly
one-in-flight per connection, so responses pair by order.

``crc32`` covers the payload — a mismatch means the stream is corrupt and
can never resync, so the receiver raises ``ConnectionError``. ``seq`` is a
per-connection per-direction monotone counter — a frame whose seq is ≤
the last one seen is a duplicate delivery and is dropped silently.

Deadline discipline: every blocking read arms a socket timeout first —
``_recv_exact`` refuses a timeout-less socket outright. A timeout at a
frame boundary means *idle*; a timeout or close mid-frame means the stream
can never resync and raises ``ConnectionError``. Deadlines resolve through
:func:`io_timeout_s` / :func:`connect_timeout_s` (explicit override >
``SIDDHI_PROCMESH_IO_TIMEOUT_S`` / ``SIDDHI_PROCMESH_CONNECT_TIMEOUT_S``
env > default).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import weakref
import zlib
from typing import Optional

_HDR = struct.Struct(">BIII")   # kind + payload length + crc32 + seq
_JLEN = struct.Struct(">I")     # json header length inside the payload

F_REQ, F_RES, F_ERR = 1, 2, 3

CONNECT_TIMEOUT_S = 5.0
IO_TIMEOUT_S = 30.0
# child boot = interpreter + package import + socket bind, under fork-storm
# contention on a saturated machine
READY_TIMEOUT_S = 120.0

MAX_FRAME = 256 * 1024 * 1024   # desync guard: a larger length prefix
# means a corrupt stream


def io_timeout_s(override: Optional[float] = None) -> float:
    """Control-op IO deadline: explicit override >
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


def child_env(base: Optional[dict] = None) -> dict:
    """Spawn env for a lane child: the parent may have found
    ``siddhi_tpu_torch`` via a ``sys.path`` insert (script-style embedding)
    that a fresh interpreter won't repeat, so prepend the package's parent
    dir to PYTHONPATH."""
    env = dict(os.environ if base is None else base)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parts = [pkg_root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                          if p and p != pkg_root]
    env["PYTHONPATH"] = os.pathsep.join(parts)
    return env


class WorkerDown(ConnectionError):
    """The child's control socket is gone (crash, SIGKILL, stop): the op
    did not complete."""


class WorkerOpError(RuntimeError):
    """The child executed the op and reports a structured failure (the
    connection itself is fine)."""


# Per-socket monotone frame counters, one per direction, keyed weakly on
# the socket object so a dropped connection resets both streams for free.
_SEND_SEQ: "weakref.WeakKeyDictionary[socket.socket, int]" = \
    weakref.WeakKeyDictionary()
_RECV_SEQ: "weakref.WeakKeyDictionary[socket.socket, int]" = \
    weakref.WeakKeyDictionary()

# process-wide detections (receiver side)
WIRE_COUNTERS = {"crc_rejected": 0, "dup_frames_dropped": 0}


def send_frame(sock: socket.socket, kind: int, header: dict,
               body: bytes = b"") -> None:
    j = json.dumps(header, separators=(",", ":")).encode()
    payload = _JLEN.pack(len(j)) + j + body
    seq = (_SEND_SEQ.get(sock, 0) + 1) & 0xFFFFFFFF
    _SEND_SEQ[sock] = seq
    sock.sendall(_HDR.pack(kind, len(payload), zlib.crc32(payload), seq)
                 + payload)


def recv_frame(sock: socket.socket, timeout: Optional[float] = None):
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
        (jn,) = _JLEN.unpack_from(payload, 0)
        header = json.loads(payload[_JLEN.size:_JLEN.size + jn].decode())
        return kind, header, payload[_JLEN.size + jn:]


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    if sock.gettimeout() is None:
        # every blocking recv in this package must carry a deadline
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


def connect(port: int, timeout: Optional[float] = None,
            io_timeout: Optional[float] = None) -> socket.socket:
    """Dial a child's control port (loopback only — lane children are
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
