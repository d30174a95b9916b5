"""Crash recovery: checkpoint restore + WAL suffix replay.

The port's copy of the JAX package's ``flow/recovery.py``. The revision may
come from either package's engine (``core/snapshot.py`` reads the JAX
package's revisions), and the WAL from either package's ``flow/wal.py``.

The exactly-once-per-event contract: a checkpoint records, alongside every
element's state, the per-stream *applied watermark* (highest WAL sequence
number delivered into the engine — ``_FlowState`` in ``__init__.py``). After
a crash, :func:`recover` restores the latest persisted revision and replays
only the WAL records above that watermark, so each logged event affects
engine state exactly once relative to the restored cut: events at or below
the watermark are already inside the checkpoint; events above it were lost
with the process and come back from the log.

Usage (a fresh process after a crash)::

    m = SiddhiManager()                            # the card
    m.set_persistence_store(FileSystemPersistenceStore(dir))
    rt = m.create_siddhi_app_runtime(app_text)     # same @app:wal app
    rt.start()
    report = recover(rt)                           # restore + replay
    # ... resume sources / keep sending

With no persisted revision (crash before the first ``persist()``) the whole
WAL replays from sequence 1 against the app's initial state — the same
contract, with an empty checkpoint.
"""

from __future__ import annotations

from typing import Optional


def recover(runtime, revision: Optional[str] = None) -> dict:
    """Restore ``revision`` (default: the latest persisted one, if any), then
    replay each stream's WAL suffix above the restored watermark. Returns a
    report ``{"revision", "replayed": {stream: n}, "watermarks": {...}}``.

    The runtime must have been built from an ``@app:wal`` app (it owns the
    WAL handles and watermark state). Attached sources are paused and async
    queues drained for the duration, so source traffic cannot interleave
    with replay (queued events are delivered — and watermarked — before the
    restore, which turns them into replayed events); callers must still hold
    off direct ``InputHandler.send`` traffic until recover returns.
    """
    flow = getattr(runtime, "flow", None)
    if flow is None:
        from ..core.errors import SiddhiAppRuntimeError
        raise SiddhiAppRuntimeError(
            f"app '{runtime.name}' has no flow subsystem (@app:wal) "
            f"to recover from")
    for src in getattr(runtime, "sources", []):
        src.pause()
    try:
        runtime.drain_async()
        restored = None
        if revision is not None:
            runtime.restore_revision(revision)
            restored = revision
        elif runtime.persistence.store is not None:
            restored = runtime.restore_last_revision()
        replayed = flow.replay()
        # replayed events may sit in device micro-batch builders / async
        # queues; surface them the same way a watermark advance would
        runtime.flush_device()
        runtime.drain_async()
    finally:
        for src in getattr(runtime, "sources", []):
            src.resume()
    return {
        "revision": restored,
        "replayed": replayed,
        "watermarks": {sid: sf.seq_applied
                       for sid, sf in flow.streams.items()},
    }
