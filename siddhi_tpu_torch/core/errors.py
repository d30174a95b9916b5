"""Exception types + replayable error store.

Reference: ``core/exception/`` (23 typed exceptions) and
``util/error/handler/store/ErrorStore.java`` — failed events persisted for
replay. Entries are occurrence-aware: ``'before'`` marks a stream-processing
failure (replay re-injects through the stream's ``InputHandler``), ``'sink'``
marks an egress failure (replay goes back through the stream's resilient
sink pipeline only, so downstream queries never see a duplicate).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass
from typing import Any, Iterable, Optional

log = logging.getLogger("siddhi_tpu.errors")


class SiddhiAppCreationError(Exception):
    pass


class SiddhiAppRuntimeError(Exception):
    pass


class DefinitionNotExistError(SiddhiAppCreationError):
    pass


class QueryableRecordTableError(SiddhiAppRuntimeError):
    pass


class CannotRestoreStateError(SiddhiAppRuntimeError):
    pass


@dataclass
class ErrorEntry:
    id: int
    timestamp: int                  # save time (ms)
    app_name: str
    stream_name: str
    event_data: Any
    error: str
    occurrence: str = "before"      # 'before' (stream) | 'sink' (egress)
    event_timestamp: int = 0        # the failed event's own timestamp
    sink_ordinal: int = -1          # which of the stream's sinks failed
    # (-1 = not a sink failure / unknown: replay targets every sink)


class ErrorStore:
    """In-memory error store (reference ``ErrorStore`` abstract,
    saveEntry:160) with occurrence-aware, id-ranged replay.

    Mutations are lock-protected: delivery threads ``save`` while the
    service thread replays/discards. ``replay`` never holds the lock while
    re-injecting (delivery may re-enter ``save``)."""

    def __init__(self, capacity: int = 10000):
        self.capacity = capacity
        self.entries: list[ErrorEntry] = []
        self._next_id = 1
        self._lock = threading.RLock()

    def save(self, app_name: str, stream_name: str, event, error: Exception,
             occurrence: str = "before", sink_ordinal: int = -1) -> ErrorEntry:
        with self._lock:
            entry = ErrorEntry(
                id=self._next_id,
                timestamp=int(time.time() * 1000),
                app_name=app_name,
                stream_name=stream_name,
                event_data=list(getattr(event, "data", []) or []),
                error=repr(error),
                occurrence=occurrence,
                event_timestamp=int(getattr(event, "timestamp", 0) or 0),
                sink_ordinal=sink_ordinal,
            )
            self._next_id += 1
            self.entries.append(entry)
            if len(self.entries) > self.capacity:
                self.entries.pop(0)
            return entry

    def load(self, app_name: str, stream_name: Optional[str] = None,
             min_id: Optional[int] = None,
             max_id: Optional[int] = None) -> list[ErrorEntry]:
        with self._lock:
            return [
                e for e in self.entries
                if e.app_name == app_name
                and (stream_name is None or e.stream_name == stream_name)
                and (min_id is None or e.id >= min_id)
                and (max_id is None or e.id <= max_id)
            ]

    def discard(self, entry_id: int) -> None:
        self.discard_many([entry_id])

    def discard_many(self, entry_ids: Iterable[int]) -> None:
        ids = set(entry_ids)
        with self._lock:
            self.entries = [e for e in self.entries if e.id not in ids]

    # -- replay ---------------------------------------------------------------
    def replay(self, runtime, stream_name: Optional[str] = None,
               min_id: Optional[int] = None,
               max_id: Optional[int] = None) -> dict:
        """Re-inject stored entries for ``runtime``'s app.

        ``occurrence='before'`` entries go through the stream's
        ``InputHandler`` (the full delivery chain runs again — a failure that
        persists re-stores the event under a new id). ``occurrence='sink'``
        entries re-publish through the stream's resilient sink pipeline(s)
        only. Returns ``{"replayed", "failed", "skipped"}`` counts; replayed
        entries are discarded."""
        report = {"replayed": 0, "failed": 0, "skipped": 0}
        replayed_ids = []
        for entry in self.load(runtime.name, stream_name, min_id, max_id):
            try:
                if entry.occurrence == "sink":
                    outcome = self._replay_sink(runtime, entry)
                    if outcome is None:
                        report["skipped"] += 1
                        continue
                    if outcome == "dropped":
                        # publish failed and the pipeline dropped it: keep
                        # the entry — discarding would lose the event while
                        # the report claims success
                        report["failed"] += 1
                        continue
                    if outcome == "stored":
                        # the pipeline re-stored it under a NEW id: discard
                        # this (superseded) entry but report the failure so
                        # a replay-until-clean loop can converge
                        replayed_ids.append(entry.id)
                        report["failed"] += 1
                        continue
                    # 'published' / 'fault' (explicitly routed): success
                else:
                    ih = runtime.input_handler(entry.stream_name)
                    flow = getattr(ih, "flow", None)
                    if flow is not None:
                        # replay bypasses the admission gate + WAL exactly
                        # like WAL recovery does (StreamFlow.replaying): a
                        # lossy overload policy silently shedding the
                        # re-injected event would discard it from the store
                        # while reporting success
                        prev = flow.replaying
                        flow.replaying = True
                        try:
                            ih.send(list(entry.event_data),
                                    timestamp=entry.event_timestamp or None)
                        finally:
                            flow.replaying = prev
                    else:
                        ih.send(list(entry.event_data),
                                timestamp=entry.event_timestamp or None)
            except Exception as e:  # noqa: BLE001 — a failed replay keeps
                # its entry; the caller inspects the report and retries
                log.warning("replay of error entry %d (%s/%s) failed: %s",
                            entry.id, entry.app_name, entry.stream_name, e)
                report["failed"] += 1
                continue
            replayed_ids.append(entry.id)
            report["replayed"] += 1
        # one batch discard: FileErrorStore compacts its file once, not per
        # entry (replaying N entries must not rewrite the file N times);
        # a no-op replay must not touch the file at all
        if replayed_ids:
            self.discard_many(replayed_ids)
        return report

    @staticmethod
    def _replay_sink(runtime, entry: ErrorEntry) -> Optional[str]:
        """Re-publish one sink entry; returns the pipeline outcome (per
        call, so concurrent live traffic can't skew the verdict) or None
        when no matching sink exists (skip)."""
        resilience = getattr(runtime, "resilience", None)
        if resilience is None:
            return None
        # target ONLY the sink that failed — siblings already published this
        # event; a -1 ordinal (legacy entry) falls back to every sink
        sinks = [s for s in resilience.sinks_for(entry.stream_name)
                 if entry.sink_ordinal < 0 or s.ordinal == entry.sink_ordinal]
        if not sinks:
            return None
        from .event import Event
        ev = Event(entry.event_timestamp, list(entry.event_data))
        worst = "published"
        rank = {"published": 0, "fault": 1, "stored": 2, "dropped": 3}
        for s in sinks:
            outcome = s.on_event(ev) or "published"
            if rank.get(outcome, 3) > rank[worst]:
                worst = outcome
        return worst


class FileErrorStore(ErrorStore):
    """JSON-lines file-backed store: entries survive restarts.

    Install engine-wide via ``SiddhiManager.set_error_store(
    FileErrorStore(path))``. Saves append one line; discards compact the
    file. Event data must be wire-representable — values that don't survive
    ``json.dumps`` are stored via ``repr`` and come back as strings."""

    def __init__(self, path: str, capacity: int = 10000):
        super().__init__(capacity)
        self.path = path
        self._file_lines = 0        # lines on disk (entries + stale lines)
        self._fh = None             # persistent append handle (WAL pattern)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._load_file()

    def _load_file(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    self.entries.append(ErrorEntry(**json.loads(line)))
                except (ValueError, TypeError) as e:
                    log.warning("error store %s: skipping corrupt line (%s)",
                                self.path, e)
        if self.entries:
            self._next_id = max(e.id for e in self.entries) + 1
        self._file_lines = len(self.entries)
        if len(self.entries) > self.capacity:
            # capacity applies to the FILE too: keep the newest entries
            self.entries = self.entries[-self.capacity:]
            self._rewrite()

    def save(self, app_name: str, stream_name: str, event, error: Exception,
             occurrence: str = "before", sink_ordinal: int = -1) -> ErrorEntry:
        with self._lock:
            entry = super().save(app_name, stream_name, event, error,
                                 occurrence, sink_ordinal)
            # append always (O(1) on the delivery thread, persistent handle
            # — the WAL pattern); in-memory evictions leave stale lines
            # behind, compacted once the file doubles past capacity —
            # amortized, never per-save
            if self._fh is None:
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(json.dumps(asdict(entry), default=repr) + "\n")
            self._fh.flush()
            self._file_lines += 1
            if self._file_lines > 2 * self.capacity:
                self._rewrite()
            return entry

    def discard_many(self, entry_ids) -> None:
        ids = set(entry_ids)
        if not ids:
            return
        with self._lock:
            super().discard_many(ids)
            self._rewrite()

    def _rewrite(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for e in self.entries:
                    f.write(json.dumps(asdict(e), default=repr) + "\n")
            os.replace(tmp, self.path)
            self._file_lines = len(self.entries)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
