"""Fabric control-plane journal: the parent's durable memory.

The port's copy of the JAX package's ``procmesh/journal.py``: the same
records in the same bytes, so a journal written by either package replays
in the other. The supervisor makes worker death a bounded event; this
module does the same for the *parent*. Every control-plane mutation —
tenant deploy/undeploy, migration intent → commit, recovery decisions, per-tenant apply/delivery cursors,
worker restart attempts — is appended here *before* (intents) or
immediately after (progress cursors) it actuates, so a SIGKILLed
supervisor process can be restarted and replayed back to a consistent
view of the mesh (``MeshFabric`` resume path: re-adopt live workers,
snapshot-restore dead ones).

The byte layer is the flow WAL's segment/CRC format
(:mod:`siddhi_tpu_torch.flow.records` — ``u32 len | u32 crc | u64 lsn |
payload``), with JSON payloads instead of SoA rows: control mutations are
low-rate and schema-rich. Segments are named by first LSN
(``%020d.jnl``); a :meth:`checkpoint` rolls a fresh segment, writes the
full compacted state as its first record and drops every earlier segment
(acked-segment truncation — the checkpoint covers them). On open, the
active segment's torn tail is truncated back to the last intact record,
the same crash-tail discipline as the WAL.

Record payloads are ``{"k": kind, ...fields}``. :meth:`replay` returns
the newest checkpoint state (if any) plus every intact record after it,
in LSN order; semantic replay ordering (intent-without-commit resolution,
cursor merging) belongs to the fabric.

This module also owns :func:`crash_point`, the ``SIDDHI_CRASH_AT`` chaos
hook: parent-kill tests set ``SIDDHI_CRASH_AT=<site>[:N]`` and the parent
SIGKILLs *itself* the Nth time that site is reached — placed at every
journal/actuate boundary so recovery is provably correct on both sides of
each write.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
from typing import Iterator, Optional, Tuple

from ..flow.records import REC_HDR, pack_record, scan_file

log = logging.getLogger("siddhi_tpu_torch.procmesh.journal")

_SEG_FMT = "%020d.jnl"
CKPT_KIND = "ckpt"

# -- SIDDHI_CRASH_AT -----------------------------------------------------------

_crash_hits: dict = {}
_crash_lock = threading.Lock()


def crash_point(site: str) -> None:
    """Chaos hook: if ``SIDDHI_CRASH_AT=<site>[:N]`` names this site,
    SIGKILL the current process the Nth time it is reached (default first).
    A no-op unless armed — the production cost is one getenv."""
    spec = os.environ.get("SIDDHI_CRASH_AT")
    if not spec:
        return
    want, _, nth = spec.partition(":")
    if want != site:
        return
    with _crash_lock:
        hits = _crash_hits.get(site, 0) + 1
        _crash_hits[site] = hits
    if hits >= int(nth or 1):
        log.warning("SIDDHI_CRASH_AT: killing self at site %r (hit %d)",
                    site, hits)
        os.kill(os.getpid(), signal.SIGKILL)


class FabricJournal:
    """Append-only segmented journal of fabric control-plane records."""

    def __init__(self, base_dir: str, segment_bytes: int = 256 * 1024,
                 fsync: bool = False):
        self.dir = base_dir
        os.makedirs(self.dir, exist_ok=True)
        self.segment_bytes = max(64, int(segment_bytes))
        self.fsync = fsync
        self._lock = threading.Lock()
        self._fh = None
        self._active: Optional[str] = None
        self._active_size = 0
        self.next_lsn = 1
        self.records_appended = 0
        self.records_since_ckpt = 0
        self._recover_tail()

    # -- open / crash-tail recovery -------------------------------------------
    def _segments(self) -> list:
        return sorted(f for f in os.listdir(self.dir) if f.endswith(".jnl"))

    def _recover_tail(self) -> None:
        segs = self._segments()
        if not segs:
            return
        path = os.path.join(self.dir, segs[-1])
        last_lsn = None
        scan = scan_file(path)
        for lsn, _payload in scan:
            last_lsn = lsn
        if scan.torn:
            log.warning("journal %s: truncating torn tail (%d -> %d bytes)",
                        path, len(scan.buf), scan.good_end)
            with open(path, "r+b") as f:
                f.truncate(scan.good_end)
        self.next_lsn = (last_lsn + 1 if last_lsn is not None
                         else int(segs[-1].split(".")[0]))

    # -- append ----------------------------------------------------------------
    def _roll_locked(self) -> None:
        if self._fh is not None:
            self._fh.close()
        self._active = _SEG_FMT % self.next_lsn
        self._fh = open(os.path.join(self.dir, self._active), "ab")
        self._active_size = self._fh.tell()

    def _write_locked(self, rec: dict) -> int:
        if self._fh is None or self._active_size >= self.segment_bytes:
            self._roll_locked()
        lsn = self.next_lsn
        payload = json.dumps(rec, separators=(",", ":")).encode()
        self._fh.write(pack_record(payload, lsn))
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self._active_size += REC_HDR.size + len(payload)
        self.next_lsn = lsn + 1
        self.records_appended += 1
        return lsn

    def append(self, kind: str, **fields) -> int:
        """Durably log one control-plane record; returns its LSN. The
        record is flushed to the OS before return, so a SIGKILL after
        ``append`` never loses it (fsync is opt-in for media-crash
        durability)."""
        rec = {"k": kind}
        rec.update(fields)
        with self._lock:
            lsn = self._write_locked(rec)
            self.records_since_ckpt += 1
        # "journaled but not actuated" is the canonical chaos window: the
        # hook fires AFTER the record is durable, BEFORE the caller acts
        crash_point("journal." + kind)
        return lsn

    # -- checkpoint + truncation -----------------------------------------------
    def checkpoint(self, state: dict) -> int:
        """Write a full compacted state record into a FRESH segment and drop
        every earlier segment — replay afterwards starts from this record."""
        with self._lock:
            self._roll_locked()
            lsn = self._write_locked({"k": CKPT_KIND, "state": state})
            # every earlier segment (including the one just sealed) is now
            # covered by the checkpoint record
            for name in self._segments():
                if name != self._active:
                    os.remove(os.path.join(self.dir, name))
            self.records_since_ckpt = 0
        crash_point("journal.checkpoint")
        return lsn

    # -- replay ----------------------------------------------------------------
    def _iter_records(self) -> Iterator[Tuple[int, dict]]:
        segs = self._segments()
        for i, name in enumerate(segs):
            scan = scan_file(os.path.join(self.dir, name))
            for lsn, payload in scan:
                yield lsn, json.loads(payload.decode())
            if scan.torn:
                # torn tail of the ACTIVE segment is a normal crash tail;
                # anywhere else is mid-log corruption — stop either way to
                # preserve LSN contiguity
                later = len(segs) - i - 1
                log.warning(
                    "journal %s: torn/corrupt record at byte %d — replay "
                    "stopped%s", os.path.join(self.dir, name), scan.good_end,
                    f"; {later} later segment(s) skipped" if later else "")
                return

    def replay(self) -> Tuple[Optional[dict], list]:
        """Returns ``(checkpoint_state, tail)``: the newest intact
        checkpoint's state (or None) and every record after it, each as
        ``{"lsn": ..., "k": ..., ...fields}`` in LSN order."""
        state, tail = None, []
        for lsn, rec in self._iter_records():
            if rec.get("k") == CKPT_KIND:
                state, tail = rec.get("state"), []
                continue
            rec = dict(rec)
            rec["lsn"] = lsn
            tail.append(rec)
        return state, tail

    # -- introspection ---------------------------------------------------------
    def position(self) -> dict:
        with self._lock:
            segs = self._segments()
            total = 0
            for name in segs:
                try:
                    total += os.path.getsize(os.path.join(self.dir, name))
                except OSError:
                    pass
            return {"lsn": self.next_lsn - 1, "segments": len(segs),
                    "bytes": total,
                    "records_since_checkpoint": self.records_since_ckpt}

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
