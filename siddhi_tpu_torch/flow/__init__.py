"""Durable flow control: WAL-backed ingress, credit-based backpressure,
crash recovery, adaptive device micro-batching.

The port's copy of the JAX package's ``flow/`` package (``__init__``,
``wal``, ``records``, ``recovery``, ``backpressure``, ``adaptive_batch``).

Opt-in per app through ``@app``-namespaced annotations (parsed like every
other ``@app:...`` form):

- ``@app:wal(dir='...', segment.bytes='1048576', fsync='false',
  streams='S,T')`` — every event accepted by an ``InputHandler`` of the
  listed streams (default: all defined streams with wire-representable
  types) is sequence-numbered and appended to a segmented write-ahead log
  (``wal.py``) before delivery. Checkpoints record the per-stream applied
  watermark; ``recovery.recover`` restores the latest revision and replays
  the WAL suffix for exactly-once-per-event effect; acked segments truncate
  after each successful ``persist()``.
- ``@app:backpressure(capacity='1024', policy='block|drop_oldest|shed',
  streams='...')`` — credit-based admission between producers and the
  stream's junction/``AsyncDispatcher`` (``backpressure.py``). Lossy
  policies stay lossy across recovery: SHED events are never logged, and an
  event evicted by DROP_OLDEST after logging is gone from replay too once
  any later event is delivered (the watermark passes its seq) — pair BLOCK
  with the WAL for the lossless guarantee.
- ``@app:adaptive(target.ms='25', min='64')`` — device micro-batch flush
  thresholds adapt to observed rate/latency (``adaptive_batch.py``) instead
  of the static ``@device(batch=...)`` fill.

Apps without these annotations are untouched: ``SiddhiAppRuntime.flow`` is
None and every hot path checks one attribute.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..query_api.annotation import find_annotation
from .adaptive_batch import AdaptiveBatchController, parse_adaptive_annotation
from .backpressure import CreditGate, FlowStats, OverloadPolicy, rlock_owned
from .wal import WriteAheadLog, stream_wire_types

log = logging.getLogger("siddhi_tpu_torch.flow")

__all__ = [
    "AdaptiveBatchController", "CreditGate", "FlowStats",
    "FlowSubsystem", "OverloadPolicy", "StreamFlow", "WriteAheadLog",
    "build_flow", "parse_adaptive_annotation", "recover",
    "stream_wire_types",
]


class StreamFlow:
    """Per-stream ingress flow state: seq assignment + WAL + admission gate.

    ``seq_applied`` is the durability watermark: the highest sequence number
    whose event has been DELIVERED into the receiver chain (updated by the
    junction under the engine lock, so a quiesced snapshot records a
    consistent cut)."""

    def __init__(self, stream_id: str, junction,
                 wal: Optional[WriteAheadLog] = None,
                 gate: Optional[CreditGate] = None,
                 stats: Optional[FlowStats] = None):
        self.stream_id = stream_id
        self.junction = junction
        self.wal = wal
        self.gate = gate
        self.stats = stats or (gate.stats if gate is not None else FlowStats())
        self.seq_applied = 0
        self.replaying = False
        # held from seq assignment through enqueue/delivery, so WAL sequence
        # order equals delivery order: without it a checkpoint watermark
        # could cover a logged-but-undelivered lower seq, losing that event
        # on recovery. Admission (which may BLOCK) runs outside this lock.
        self.lock = threading.Lock()

    # -- producer side (InputHandler) -----------------------------------------
    def admit(self, n: int) -> bool:
        """Overload policy for ``n`` incoming events; False means shed.
        May block (BLOCK policy) — callers must not hold :attr:`lock`.
        A True return holds a credit reservation: call :meth:`release`
        once the events are enqueued (or delivery failed)."""
        if self.gate is not None:
            return self.gate.admit(n)
        self.stats.accepted += n
        return True

    def release(self, n: int) -> None:
        """Free the reservation of a successful :meth:`admit`."""
        if self.gate is not None:
            self.gate.release(n)

    def log(self, rows: list, tss: list):
        """WAL append; returns the assigned seq range (None when no WAL).
        Call under :attr:`lock`, immediately before enqueue/delivery."""
        if self.wal is None:
            return None
        first = self.wal.append(rows, tss)
        return range(first, first + len(rows))

    # -- delivery side (StreamJunction, under root_lock) ----------------------
    def on_applied(self, seq: int) -> None:
        if seq > self.seq_applied:
            self.seq_applied = seq


class _FlowState:
    """Snapshot holder: the per-stream applied watermarks ride in every
    checkpoint, so recovery knows where WAL replay starts."""

    def __init__(self, subsystem: "FlowSubsystem"):
        self.subsystem = subsystem

    def snapshot_state(self) -> dict:
        wm = {sid: sf.seq_applied
              for sid, sf in self.subsystem.streams.items()}
        # remember the last checkpointed cut for acked-segment truncation
        self.subsystem.last_checkpoint_wm = dict(wm)
        return {"watermarks": wm}

    def restore_state(self, state: dict) -> None:
        for sid, wm in (state.get("watermarks") or {}).items():
            sf = self.subsystem.streams.get(sid)
            if sf is not None:
                sf.seq_applied = int(wm)
                if sf.wal is not None:
                    # a fresh/relocated WAL dir restarts numbering at 1 —
                    # seqs at or below the restored watermark would be
                    # invisible to replay forever, so jump past it
                    sf.wal.reserve_through(sf.seq_applied)


def _csv(value: Optional[str]) -> Optional[list[str]]:
    if not value:
        return None
    return [s.strip() for s in value.split(",") if s.strip()]


class FlowSubsystem:
    """One app's flow-control wiring (built by ``SiddhiAppRuntime``)."""

    def __init__(self, runtime, wal_ann, bp_ann):
        self.runtime = runtime
        self.ctx = runtime.ctx
        self.streams: dict[str, StreamFlow] = {}
        self.last_checkpoint_wm: dict[str, int] = {}
        from ..core.errors import SiddhiAppCreationError

        defined = list(runtime.app.stream_definitions)

        wal_streams: dict[str, WriteAheadLog] = {}
        if wal_ann is not None:
            base_dir = wal_ann.get("dir")
            if not base_dir:
                raise SiddhiAppCreationError("@app:wal requires a 'dir'")
            seg_bytes = int(wal_ann.get("segment.bytes") or (1 << 20))
            fsync = (wal_ann.get("fsync") or "false").lower() == "true"
            listed = _csv(wal_ann.get("streams"))
            for sid in (listed or defined):
                sd = runtime.app.stream_definitions.get(sid)
                if sd is None:
                    raise SiddhiAppCreationError(
                        f"@app:wal streams: unknown stream '{sid}'")
                try:
                    types = stream_wire_types(sd)
                except ValueError as e:
                    if listed is not None:   # explicitly requested: hard error
                        raise SiddhiAppCreationError(str(e)) from None
                    log.info("wal skips stream '%s': %s", sid, e)
                    continue
                wal_streams[sid] = WriteAheadLog(
                    base_dir, runtime.name, sid, types,
                    segment_bytes=seg_bytes, fsync=fsync)

        gate_cfg = None
        if bp_ann is not None:
            gate_cfg = {
                "capacity": int(bp_ann.get("capacity")
                                or bp_ann.get("buffer.size") or 1024),
                "policy": OverloadPolicy.parse(bp_ann.get("policy")),
                "streams": _csv(bp_ann.get("streams")),
            }
            max_wait = bp_ann.get("block.timeout")
            gate_cfg["max_wait_s"] = float(max_wait) if max_wait else None
            for sid in gate_cfg["streams"] or []:
                if sid not in runtime.app.stream_definitions:
                    raise SiddhiAppCreationError(
                        f"@app:backpressure streams: unknown stream '{sid}'")

        for sid in defined:
            wal = wal_streams.get(sid)
            gate = None
            if gate_cfg is not None and (gate_cfg["streams"] is None
                                         or sid in gate_cfg["streams"]):
                junction = self.ctx.stream_junctions[sid]
                gate = CreditGate(
                    gate_cfg["capacity"], gate_cfg["policy"],
                    depth_fn=self._depth_fn(junction),
                    evict_fn=self._evict_fn(junction),
                    max_wait_s=gate_cfg["max_wait_s"],
                    lock_owned_fn=self._root_owned_fn(self.ctx))
            if wal is None and gate is None:
                continue
            junction = self.ctx.stream_junctions[sid]
            sf = StreamFlow(sid, junction, wal=wal, gate=gate)
            junction.flow = sf
            self.streams[sid] = sf

        self.ctx.register_state("flow-ingress", _FlowState(self))
        # input handlers created before the subsystem existed (sources wired
        # during _build) pick up their StreamFlow here
        for ih in runtime.input_handlers.values():
            self.attach(ih)

    @staticmethod
    def _depth_fn(junction):
        def depth():
            # credits are counted in EVENTS: a ('chunk', [...]) queue item
            # holds many, so item-count depth would overrun the bound
            d = junction.dispatcher
            return d.buffered_event_count if d is not None else 0
        return depth

    @staticmethod
    def _root_owned_fn(ctx):
        def owned():
            return rlock_owned(getattr(ctx, "root_lock", None))
        return owned

    @staticmethod
    def _evict_fn(junction):
        def evict():
            d = junction.dispatcher
            if d is None:
                return None
            item = d.drop_oldest()
            if item is None:
                return None
            return len(item[1]) if item[0] == "chunk" else 1
        return evict

    # -- runtime hooks ---------------------------------------------------------
    def attach(self, input_handler) -> None:
        input_handler.flow = self.streams.get(input_handler.stream_id)

    def on_persisted(self) -> None:
        """Acked-segment truncation: drop WAL segments fully covered by the
        watermark recorded in the checkpoint that was just persisted."""
        for sid, wm in self.last_checkpoint_wm.items():
            sf = self.streams.get(sid)
            if sf is not None and sf.wal is not None and wm > 0:
                sf.wal.truncate_through(wm)

    def close(self) -> None:
        for sf in self.streams.values():
            if sf.wal is not None:
                sf.wal.close()

    # -- recovery replay -------------------------------------------------------
    def replay(self) -> dict[str, int]:
        """Replays, per stream, every WAL record above the applied watermark
        straight into the junction (synchronous delivery — deterministic and
        chunk-preserving; the async dispatcher is bypassed during replay).
        Returns the per-stream replayed-event counts."""
        from ..core.event import EventType, StreamEvent

        counts: dict[str, int] = {}
        for sid, sf in self.streams.items():
            if sf.wal is None:
                continue
            n = 0
            sf.replaying = True
            try:
                for rows, tss, first in sf.wal.replay_records(
                        sf.seq_applied + 1):
                    events = []
                    for i, (row, ts) in enumerate(zip(rows, tss)):
                        ev = StreamEvent(ts, list(row), EventType.CURRENT)
                        ev.flow_seq = first + i
                        events.append(ev)
                    with self.ctx.root_lock:
                        if len(events) == 1:
                            self.ctx.advance_time(events[0].timestamp)
                            sf.junction.deliver_event(events[0])
                        else:
                            # chunk watermark semantics match InputHandler's
                            self.ctx.advance_time(
                                min(e.timestamp for e in events))
                            sf.junction.deliver_events(events)
                            self.ctx.advance_time(
                                max(e.timestamp for e in events))
                    n += len(events)
            finally:
                sf.replaying = False
            counts[sid] = n
        return counts

    # -- introspection ---------------------------------------------------------
    def stats_report(self) -> dict:
        streams = {}
        for sid, sf in self.streams.items():
            entry = {
                "watermark": sf.seq_applied,
                "accepted": sf.stats.accepted,
                "shed": sf.stats.shed,
                "dropped_oldest": sf.stats.dropped_oldest,
            }
            if sf.wal is not None:
                entry["wal_bytes"] = sf.wal.wal_bytes
                entry["next_seq"] = sf.wal.next_seq
            if sf.gate is not None:
                entry["queue_depth"] = sf.gate.depth
                entry["credits"] = sf.gate.credits
                entry["policy"] = sf.gate.policy
            streams[sid] = entry
        return {"enabled": True, "streams": streams}


def build_flow(runtime) -> Optional[FlowSubsystem]:
    """Builds the subsystem when the app opts in; None otherwise."""
    anns = runtime.app.annotations
    wal_ann = find_annotation(anns, "wal")
    bp_ann = find_annotation(anns, "backpressure")
    if wal_ann is None and bp_ann is None:
        return None
    return FlowSubsystem(runtime, wal_ann, bp_ann)


from .recovery import recover  # noqa: E402  (re-export; avoids import cycle)
