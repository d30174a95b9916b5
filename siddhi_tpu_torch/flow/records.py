"""CRC'd record framing shared by the durability logs.

The port's copy of the JAX package's ``flow/records.py``: the framing of
the per-stream data WAL (:class:`~siddhi_tpu_torch.flow.wal.WriteAheadLog`),
byte for byte the JAX package's, so either package reads the other's
segments. Each record is::

    u32 payload_len | u32 crc32(first_seq_be8 + payload) | u64 first_seq | payload

The CRC makes torn tails (crash mid-write) detectable; the ``first_seq``
field carries whatever monotone counter the log owns (WAL event sequence,
journal LSN). Segment naming, rotation and truncation policy stay with the
callers — this module owns only the byte framing and the scan discipline:
a scan stops at the first record whose payload is cut short or fails its
CRC, and reports the byte offset of the last intact record so the owner
can truncate the torn tail (active segment) or refuse to read past
corruption (sealed segment).
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, Tuple

REC_HDR = struct.Struct(">IIQ")      # payload_len, crc32, first_seq
_SEQ = struct.Struct(">Q")


def _crc(payload: bytes, first_seq: int) -> int:
    # the CRC covers first_seq too: a bit-flip in the seq field would
    # otherwise replay a perfectly intact payload under the wrong sequence
    # number — silent reordering, worse than a detected torn record
    return zlib.crc32(payload, zlib.crc32(_SEQ.pack(first_seq)))


def pack_record(payload: bytes, first_seq: int) -> bytes:
    """Frame one payload: header + bytes, ready to append to a segment."""
    return REC_HDR.pack(len(payload), _crc(payload, first_seq), first_seq) \
        + payload


class RecordScan:
    """Iterate the intact prefix of a segment buffer.

    Yields ``(first_seq, payload)`` per intact record and stops silently at
    the first torn/corrupt one. After (or during) iteration ``good_end`` is
    the byte offset just past the last intact record — the truncation point
    for crash-tail recovery — and ``torn`` reports whether the buffer held
    trailing bytes that did not survive the CRC/length check.
    """

    def __init__(self, buf: bytes):
        self.buf = buf
        self.good_end = 0

    def __iter__(self) -> Iterator[Tuple[int, bytes]]:
        buf, pos = self.buf, 0
        while pos + REC_HDR.size <= len(buf):
            n, crc, first = REC_HDR.unpack_from(buf, pos)
            end = pos + REC_HDR.size + n
            if end > len(buf):
                return                   # torn: header written, payload cut
            payload = buf[pos + REC_HDR.size: end]
            if _crc(payload, first) != crc:
                return                   # torn or corrupt mid-record
            self.good_end = pos = end
            yield first, payload

    @property
    def torn(self) -> bool:
        return self.good_end < len(self.buf)


def scan_file(path: str) -> RecordScan:
    """Read a whole segment and return its scanner (segments are bounded by
    the owners' rotation policy, so a full read stays small)."""
    with open(path, "rb") as f:
        return RecordScan(f.read())
