"""Per-stream segmented write-ahead log.

Durability layer of the flow subsystem: every event accepted by a
flow-controlled ``InputHandler`` is appended here — with a monotonically
increasing sequence number — *before* it enters the engine, so a crash
between checkpoints loses nothing (``recovery.py`` replays the suffix above
the checkpoint's watermark).

The port's copy of the JAX package's ``flow/wal.py``: its segments are
byte-identical to the JAX package's for the same events and stream
definitions, so either package replays the other's log.

Record format reuses the SoA row framing (``gpu/dcn.py`` —
``pack_rows``/``unpack_rows``): one record per ingress call, so replay
preserves the original send granularity (chunk-aware ``#window.batch()``
semantics survive recovery). Each record is::

    u32 payload_len | u32 crc32(payload) | u64 first_seq | payload

where ``payload`` is the SoA block (``n`` rows + timestamps; the record's
sequence range is ``first_seq .. first_seq+n-1``). The CRC makes torn tails
(crash mid-write) detectable: on open, the active segment is truncated back
to its last intact record.

Segments are append-only files named by their first sequence number
(``%020d.wal``); the log rotates at ``segment_bytes`` and
:meth:`WriteAheadLog.truncate_through` drops whole segments once a
checkpoint's watermark covers them (acked-segment truncation).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Iterator, Optional

from ..query_api.definition import DataType
from .records import REC_HDR as _REC_HDR
from .records import pack_record, scan_file

log = logging.getLogger("siddhi_tpu_torch.flow.wal")

_SEG_FMT = "%020d.wal"

# shared column-type vocabulary with gpu/dcn.py and native/ingress.cpp
_TYPE_CHARS = {
    DataType.STRING: "s", DataType.INT: "i", DataType.LONG: "l",
    DataType.FLOAT: "f", DataType.DOUBLE: "d", DataType.BOOL: "b",
}


def stream_wire_types(definition) -> str:
    """Column type string for a stream definition; OBJECT attributes have no
    wire representation and cannot be WAL-logged."""
    chars = []
    for a in definition.attributes:
        c = _TYPE_CHARS.get(a.type)
        if c is None:
            raise ValueError(
                f"stream '{definition.id}': attribute '{a.name}' has type "
                f"{a.type.value}, which cannot be written to a WAL")
        chars.append(c)
    return "".join(chars)


def _pack(types: str, rows: list, timestamps: list) -> bytes:
    from ..gpu.dcn import pack_rows
    return pack_rows(types, rows, timestamps)


def _unpack(payload: bytes):
    from ..gpu.dcn import unpack_rows
    return unpack_rows(payload)


class WriteAheadLog:
    """Append-only segmented log for one stream of one app."""

    def __init__(self, base_dir: str, app_name: str, stream_id: str,
                 types: str, segment_bytes: int = 1 << 20,
                 fsync: bool = False):
        self.dir = os.path.join(base_dir, app_name, stream_id)
        os.makedirs(self.dir, exist_ok=True)
        self.types = types
        self.segment_bytes = max(_REC_HDR.size, int(segment_bytes))
        self.fsync = fsync
        self._lock = threading.Lock()
        self._fh = None                  # active segment file handle
        self._active: Optional[str] = None
        self._active_size = 0
        self.next_seq = 1
        self.records_appended = 0
        self._recover_tail()

    # -- open / crash-tail recovery -------------------------------------------
    def _segments(self) -> list[str]:
        return sorted(f for f in os.listdir(self.dir) if f.endswith(".wal"))

    def _recover_tail(self) -> None:
        """Scan the newest segment for the last intact record; truncate any
        torn tail and position ``next_seq`` after the highest logged seq."""
        segs = self._segments()
        if not segs:
            return
        path = os.path.join(self.dir, segs[-1])
        last_seq = None
        scan = scan_file(path)
        for first, payload in scan:
            rows, _ = _unpack(payload)
            last_seq = first + len(rows) - 1
        if scan.torn:
            log.warning("wal %s: truncating torn tail (%d -> %d bytes)",
                        path, len(scan.buf), scan.good_end)
            with open(path, "r+b") as f:
                f.truncate(scan.good_end)
        if last_seq is not None:
            self.next_seq = last_seq + 1
        else:
            # empty/fully-torn segment: the filename records the intended seq
            self.next_seq = int(segs[-1].split(".")[0])

    # -- append ----------------------------------------------------------------
    def _roll(self) -> None:
        if self._fh is not None:
            self._fh.close()
        self._active = _SEG_FMT % self.next_seq
        self._fh = open(os.path.join(self.dir, self._active), "ab")
        self._active_size = self._fh.tell()

    def append(self, rows: list, timestamps: list) -> int:
        """Logs one ingress call; returns the first sequence number assigned
        (the record covers ``first .. first+len(rows)-1``)."""
        with self._lock:
            if self._fh is None or self._active_size >= self.segment_bytes:
                self._roll()
            first = self.next_seq
            payload = _pack(self.types, rows, timestamps)
            self._fh.write(pack_record(payload, first))
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._active_size += _REC_HDR.size + len(payload)
            self.next_seq = first + len(rows)
            self.records_appended += 1
            return first

    def reserve_through(self, seq: int) -> None:
        """Ensure future appends are numbered strictly above ``seq`` — called
        after a checkpoint restore so a fresh/relocated WAL dir cannot assign
        seqs at or below the restored watermark (replay would skip them)."""
        with self._lock:
            if seq >= self.next_seq:
                self.next_seq = seq + 1

    # -- replay ----------------------------------------------------------------
    def replay_records(self, from_seq: int = 1) -> Iterator[tuple]:
        """Yields ``(rows, timestamps, first_seq)`` per intact record with any
        sequence number >= ``from_seq``, trimming rows below it. Stops at the
        first torn/corrupt record of a segment (crash tail)."""
        segs = self._segments()
        for i, name in enumerate(segs):
            # whole segment below the watermark: the successor's first seq
            # bounds every seq in this one
            if i + 1 < len(segs) and int(segs[i + 1].split(".")[0]) <= from_seq:
                continue
            scan = scan_file(os.path.join(self.dir, name))
            for first, payload in scan:
                rows, tss = _unpack(payload)
                if first + len(rows) - 1 < from_seq:
                    continue
                if first < from_seq:     # record straddles the watermark
                    skip = from_seq - first
                    rows, tss, first = rows[skip:], tss[skip:], from_seq
                yield rows, tss, first
            if scan.torn:
                self._warn_replay_stop(name, scan.good_end, i, len(segs))
                return

    def _warn_replay_stop(self, seg: str, pos: int, idx: int,
                          n_segs: int) -> None:
        """A torn record in the ACTIVE segment is a normal crash tail (the
        writer truncates it on reopen); anywhere else it is mid-log corruption
        and replay stops to preserve sequence contiguity — say so loudly,
        since every later intact record is being dropped with it."""
        later = n_segs - idx - 1
        log.warning(
            "wal %s: torn/corrupt record at byte %d — replay stopped%s",
            os.path.join(self.dir, seg), pos,
            f"; {later} later segment(s) skipped" if later else "")

    def replay(self, from_seq: int = 1) -> Iterator[tuple]:
        """Flat per-event view: yields ``(seq, row, ts)``."""
        for rows, tss, first in self.replay_records(from_seq):
            for i, (row, ts) in enumerate(zip(rows, tss)):
                yield first + i, row, ts

    # -- truncation ------------------------------------------------------------
    def truncate_through(self, seq: int) -> int:
        """Drops segments entirely covered by ``seq`` (every record's last
        sequence number <= seq). The active segment is never deleted.
        Returns the number of segments removed."""
        with self._lock:
            segs = self._segments()
            removed = 0
            for i, name in enumerate(segs):
                last_of_seg = (int(segs[i + 1].split(".")[0]) - 1
                               if i + 1 < len(segs) else None)
                if last_of_seg is None or last_of_seg > seq:
                    break
                if name == self._active:
                    break
                os.remove(os.path.join(self.dir, name))
                removed += 1
            return removed

    # -- introspection ---------------------------------------------------------
    @property
    def wal_bytes(self) -> int:
        total = 0
        try:
            for name in self._segments():
                total += os.path.getsize(os.path.join(self.dir, name))
        except OSError:
            pass
        return total

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
