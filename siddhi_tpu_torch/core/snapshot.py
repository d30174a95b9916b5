"""Snapshot service & persistence stores — checkpoint/restore.

Reference: ``core/util/snapshot/SnapshotService.java`` (fullSnapshot:90,
incrementalSnapshot:189, restore:333), ``util/snapshot/IncrementalSnapshot.java``,
``util/persistence/`` (in-memory + filesystem stores, incremental variants,
revisions), op-log window buffers
``event/stream/holder/SnapshotableStreamEventQueue.java:37``.
Design: every stateful element registered in ``app_context.state_registry``
exposes ``snapshot_state() -> dict`` / ``restore_state(dict)``; a full snapshot is
the pickled map of all of them, taken under the app's root lock (the reference's
ThreadBarrier quiesce). Incremental snapshots record, per element, either an
op-log since the last snapshot (elements exposing ``incremental_snapshot_state``
/ ``apply_increment``), a skip marker (state digest unchanged), or a fresh full
state. A revision chain is [base, inc, inc, ...] with periodic full baselines.
Device runtimes take part through the same protocol: their state tensors are
fetched to numpy arrays (``gpu/state_io.py``), so a blob holds no tensor and
restores on another device.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading
import time
from typing import Any, Optional

from .event import StreamEvent


class SnapshotableEventBuffer:
    """Event buffer with operation-log snapshotting.

    Reference: ``SnapshotableStreamEventQueue.java:37`` — windows buffer events
    here; a full snapshot captures the whole buffer and starts a fresh op-log;
    an incremental snapshot returns only the operations since the previous
    snapshot. If the op-log outgrows the buffer, it is abandoned and the next
    incremental snapshot falls back to a full capture (same as the reference's
    forceFullSnapshot).
    """

    def __init__(self, max_oplog: int = 4096):
        self.items: list[StreamEvent] = []
        self._oplog: list[tuple] = []
        self._baseline = False           # a snapshot exists to diff against
        self.max_oplog = max_oplog

    # -- list-ish API used by windows -----------------------------------------
    def append(self, ev: StreamEvent) -> None:
        self.items.append(ev)
        self._record(("a", ev.timestamp, list(ev.data), ev.type))

    def popleft(self) -> StreamEvent:
        ev = self.items.pop(0)
        self._record(("p",))
        return ev

    def clear(self) -> None:
        self.items = []
        self._record(("c",))

    def __len__(self) -> int:
        return len(self.items)

    def __iter__(self):
        return iter(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def _record(self, op: tuple) -> None:
        if not self._baseline:
            return
        self._oplog.append(op)
        if len(self._oplog) > self.max_oplog:
            self._oplog = []
            self._baseline = False       # force full on next snapshot

    # -- snapshot protocol -----------------------------------------------------
    def capture(self) -> list[tuple]:
        """Pure full capture — does NOT touch the op-log (plain snapshots
        must not disturb an in-flight incremental chain)."""
        return [(e.timestamp, list(e.data), e.type) for e in self.items]

    def begin_oplog(self) -> None:
        """Start a fresh op-log: the current contents are the new baseline."""
        self._oplog = []
        self._baseline = True

    def full_snapshot(self) -> list[tuple]:
        self.begin_oplog()
        return self.capture()

    def incremental_snapshot(self) -> Optional[list[tuple]]:
        """Ops since last snapshot, or None if a full capture is needed."""
        if not self._baseline:
            return None
        ops, self._oplog = self._oplog, []
        return ops

    def restore(self, base: list[tuple]) -> None:
        self.items = [StreamEvent(ts, list(d), t) for ts, d, t in base]
        self._oplog = []
        self._baseline = True

    def apply_ops(self, ops: list[tuple]) -> None:
        for op in ops:
            if op[0] == "a":
                self.items.append(StreamEvent(op[1], list(op[2]), op[3]))
            elif op[0] == "p":
                self.items.pop(0)
            elif op[0] == "c":
                self.items = []


class SnapshotService:
    def __init__(self, app_context):
        self.app_context = app_context
        self._digests: dict[str, bytes] = {}    # element -> last state digest

    # -- collection ------------------------------------------------------------
    # collect_* return plain dicts (one pickle at the persist layer); the
    # plain-full path is PURE — it must not disturb an incremental chain.
    def collect_full(self, update_baseline: bool = False) -> dict:
        with self.app_context.root_lock:
            states = {}
            if update_baseline:
                self._digests = {}
            for element_id, holder in self.app_context.state_registry.items():
                state = holder.snapshot_state()
                states[element_id] = state
                if update_baseline:
                    self._digests[element_id] = self._digest(state)
                    if hasattr(holder, "reset_increment_baseline"):
                        holder.reset_increment_baseline()
            return {
                "app": self.app_context.name,
                "states": states,
                "time": self.app_context.current_time(),
            }

    def collect_incremental(self) -> dict:
        with self.app_context.root_lock:
            states: dict[str, tuple] = {}
            for element_id, holder in self.app_context.state_registry.items():
                if hasattr(holder, "incremental_snapshot_state"):
                    inc = holder.incremental_snapshot_state()
                    if inc is not None:
                        states[element_id] = ("inc", inc)
                        continue
                    states[element_id] = ("full", holder.snapshot_state())
                    if hasattr(holder, "reset_increment_baseline"):
                        holder.reset_increment_baseline()
                    continue
                state = holder.snapshot_state()
                digest = self._digest(state)
                if self._digests.get(element_id) == digest:
                    states[element_id] = ("skip",)
                else:
                    states[element_id] = ("full", state)
                    self._digests[element_id] = digest
            return {
                "app": self.app_context.name,
                "states": states,
                "time": self.app_context.current_time(),
            }

    @staticmethod
    def _digest(state: Any) -> bytes:
        return hashlib.sha1(
            pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)).digest()

    # -- public API ------------------------------------------------------------
    def full_snapshot(self, update_baseline: bool = False) -> bytes:
        return pickle.dumps(self.collect_full(update_baseline))

    def incremental_snapshot(self) -> bytes:
        """Delta since the previous snapshot in the current revision chain
        (reference ``SnapshotService.incrementalSnapshot:189``)."""
        data = self.collect_incremental()
        data["type"] = "increment"
        return pickle.dumps(data)

    def restore(self, blob: bytes) -> None:
        data = pickle.loads(blob)
        if data.get("type") == "increment":
            raise ValueError(
                "cannot restore an increment alone; restore its chain")
        with self.app_context.root_lock:
            # pre-restore digests would otherwise mark unchanged-looking
            # elements as ('skip',) against a baseline that no longer exists
            self._digests = {}
            for element_id, state in data["states"].items():
                holder = self.app_context.state_registry.get(element_id)
                if holder is not None:
                    holder.restore_state(state)
            if self.app_context.timestamp_generator.playback:
                self.app_context.timestamp_generator.advance(data.get("time", 0))

    def restore_chain(self, blobs: list[bytes]) -> None:
        """Restore [base, inc, inc, ...] in order."""
        if not blobs:
            return
        self.restore(blobs[0])
        last = pickle.loads(blobs[0])
        with self.app_context.root_lock:
            for blob in blobs[1:]:
                last = pickle.loads(blob)
                for element_id, entry in last["states"].items():
                    holder = self.app_context.state_registry.get(element_id)
                    if holder is None:
                        continue
                    kind = entry[0]
                    if kind == "skip":
                        continue
                    if kind == "full":
                        holder.restore_state(entry[1])
                    elif kind == "inc":
                        holder.apply_increment(entry[1])
            if self.app_context.timestamp_generator.playback:
                self.app_context.timestamp_generator.advance(last.get("time", 0))


class PersistenceStore:
    def save(self, app_name: str, revision: str, blob: bytes) -> None:
        raise NotImplementedError

    def load(self, app_name: str, revision: str) -> Optional[bytes]:
        raise NotImplementedError

    def last_revision(self, app_name: str) -> Optional[str]:
        raise NotImplementedError

    def clear_all_revisions(self, app_name: str) -> None:
        raise NotImplementedError


class InMemoryPersistenceStore(PersistenceStore):
    def __init__(self):
        self._store: dict[str, dict[str, bytes]] = {}

    def save(self, app_name, revision, blob):
        self._store.setdefault(app_name, {})[revision] = blob

    def load(self, app_name, revision):
        return self._store.get(app_name, {}).get(revision)

    def last_revision(self, app_name):
        revs = self._store.get(app_name)
        if not revs:
            return None
        return sorted(revs)[-1]

    def clear_all_revisions(self, app_name):
        self._store.pop(app_name, None)


class FileSystemPersistenceStore(PersistenceStore):
    def __init__(self, base_dir: str):
        self.base_dir = base_dir

    def _dir(self, app_name: str) -> str:
        d = os.path.join(self.base_dir, app_name)
        os.makedirs(d, exist_ok=True)
        return d

    def save(self, app_name, revision, blob):
        with open(os.path.join(self._dir(app_name), revision), "wb") as f:
            f.write(blob)

    def load(self, app_name, revision):
        path = os.path.join(self._dir(app_name), revision)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def last_revision(self, app_name):
        files = sorted(os.listdir(self._dir(app_name)))
        return files[-1] if files else None

    def clear_all_revisions(self, app_name):
        d = self._dir(app_name)
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))


class IncrementalPersistenceStore(InMemoryPersistenceStore):
    """In-memory store for incremental revision chains (reference
    ``util/persistence/IncrementalPersistenceStore.java``). Marker class: a
    PersistenceManager writes increments (with periodic full baselines) when
    the configured store sets ``incremental = True``."""

    incremental = True


class IncrementalFileSystemPersistenceStore(FileSystemPersistenceStore):
    """Filesystem store for incremental revision chains (reference
    ``IncrementalFileSystemPersistenceStore.java:37``)."""

    incremental = True


class PersistenceManager:
    """persist()/restoreRevision()/restoreLastRevision() façade.

    With an incremental store, every ``base_interval``-th persist writes a full
    baseline; others write deltas chained by a ``parent`` pointer (reference:
    periodic full baselines in ``AsyncIncrementalSnapshotPersistor`` flow)."""

    def __init__(self, app_context, snapshot_service: SnapshotService,
                 store: Optional[PersistenceStore]):
        self.app_context = app_context
        self.snapshot_service = snapshot_service
        self.store = store
        self._counter = 0
        self.base_interval = 5
        self._since_base = 0
        self._last_revision: Optional[str] = None

    def persist(self) -> str:
        if self.store is None:
            raise RuntimeError("no persistence store configured")
        self._counter += 1
        revision = f"{int(time.time() * 1000)}_{self._counter:06d}"
        if getattr(self.store, "incremental", False):
            is_base = self._last_revision is None or \
                self._since_base >= self.base_interval
            if is_base:
                data = self.snapshot_service.collect_full(update_baseline=True)
                data["parent"] = None
                self._since_base = 0
            else:
                data = self.snapshot_service.collect_incremental()
                data["type"] = "increment"
                data["parent"] = self._last_revision
                self._since_base += 1
            blob = pickle.dumps(data)
            self._last_revision = revision
        else:
            blob = self.snapshot_service.full_snapshot()
        self.store.save(self.app_context.name, revision, blob)
        return revision

    def invalidate_chain(self) -> None:
        """After any restore, the live state no longer continues the persisted
        chain — the next persist must write a fresh base."""
        self._last_revision = None
        self._since_base = 0

    def restore_revision(self, revision: str) -> None:
        blob = self.store.load(self.app_context.name, revision)
        if blob is None:
            raise KeyError(f"no revision {revision!r}")
        data = pickle.loads(blob)
        if data.get("type") != "increment":
            self.snapshot_service.restore(blob)
            self.invalidate_chain()
            return
        # walk parents back to the base, then apply base→...→revision
        chain = [blob]
        while data.get("type") == "increment":
            parent = data.get("parent")
            if parent is None:
                raise KeyError(f"broken increment chain at {revision!r}")
            blob = self.store.load(self.app_context.name, parent)
            if blob is None:
                raise KeyError(f"missing parent revision {parent!r}")
            chain.insert(0, blob)
            data = pickle.loads(blob)
        self.snapshot_service.restore_chain(chain)
        self.invalidate_chain()

    def restore_last_revision(self) -> Optional[str]:
        rev = self.store.last_revision(self.app_context.name)
        if rev is not None:
            self.restore_revision(rev)
        return rev

    def clear_all_revisions(self) -> None:
        self.store.clear_all_revisions(self.app_context.name)
