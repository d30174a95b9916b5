"""Async event dispatch: the Disruptor-mode analog for stream junctions.

Reference: ``StreamJunction.startProcessing`` (``stream/StreamJunction.java:279-316``)
spins up an LMAX Disruptor ring buffer when a stream is annotated
``@async(buffer.size='..', workers='..', batch.size.max='..')``; producers
publish into the ring and worker threads drain it into the receiver chain.

Redesign: the engine is batch-synchronous — processors are not
locked individually; instead ONE app-level lock (``SiddhiAppContext.root_lock``)
guards all host engine state, and the async dispatcher decouples *producers*
from *delivery*:

- ``send()`` enqueues into a bounded buffer and returns (multi-threaded
  producers are safe — enqueue is under a queue mutex, not the engine lock);
- worker threads drain events in ``batch.size.max`` chunks and deliver them
  under ``root_lock`` (single-writer engine semantics preserved);
- backpressure: a full buffer blocks the producer briefly; if the buffer stays
  full (e.g. the producer itself holds ``root_lock``, so draining can't
  progress) the put *grows the queue* instead of deadlocking and counts the
  overflow — the gauge surfaces sizing problems, the engine never wedges;
- ``quiesce()`` waits for empty-queue + idle-workers: the ``ThreadBarrier``
  analog used by snapshot/persist and shutdown.

Delivery holds the engine lock, so with ``workers > 1`` host-side processing
is still serialized (the win is producer decoupling); device-offloaded queries
additionally overlap packing with device compute via ``AsyncDeviceDriver``
(``device_bridge.py``), where the expensive step runs *outside* the lock.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Optional

from ..flow.backpressure import rlock_owned

log = logging.getLogger("siddhi_tpu_torch.async")

# how long a producer waits on a full buffer before growing it instead
# (deadlock-proof backpressure: the producer may hold root_lock, which the
# drain path needs)
_FULL_WAIT_S = 0.2


class AsyncDispatcher:
    """Bounded multi-producer buffer + worker threads for one junction."""

    def __init__(self, junction, app_context, buffer_size: int = 1024,
                 workers: int = 1, batch_size_max: int = 64):
        self.junction = junction
        self.app_context = app_context
        self.buffer_size = max(1, buffer_size)
        self.workers = max(1, workers)
        self.batch_size_max = max(1, batch_size_max)

        self._q: collections.deque = collections.deque()
        self._n_events = 0                  # EVENTS queued (items may be chunks)
        self._cv = threading.Condition()
        self._busy = 0                      # workers currently delivering
        self._stopped = False
        self._started = False
        self._threads: list[threading.Thread] = []

        # observability (BufferedEventsTracker analog,
        # ``StreamJunction.getBufferedEvents:359``)
        self.total_enqueued = 0
        self.high_water = 0
        self.soft_overflows = 0             # puts that grew past buffer_size

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        with self._cv:          # idempotent under concurrent first sends
            if self._started:
                return
            self._started = True
        for i in range(self.workers):
            t = threading.Thread(
                target=self._run, name=f"async-{self.junction.definition.id}-{i}",
                daemon=True)
            self._threads.append(t)
            t.start()

    def stop(self) -> None:
        """Drain, then stop workers (reference shuts the disruptor down after
        a final drain)."""
        if not self._started:
            return
        self.quiesce()
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        self._started = False
        self._stopped = False

    # -- producer side -------------------------------------------------------
    @property
    def buffered_events(self) -> int:
        return len(self._q)

    @property
    def buffered_event_count(self) -> int:
        """Queued EVENTS (a ('chunk', [...]) item holds many) — the credit
        gate's depth unit (``flow/backpressure.py`` counts credits in events,
        so item-count depth would overrun the bound by the chunk size)."""
        return self._n_events

    @staticmethod
    def _item_size(item) -> int:
        return len(item[1]) if item[0] == "chunk" else 1

    def enqueue(self, item) -> None:
        """item: ('event', StreamEvent) | ('chunk', list[StreamEvent]).

        Backpressure: a producer that does NOT hold the app root lock blocks
        until space frees — ``@async(buffer.size)`` is a HARD bound for
        external producers. A producer holding root_lock (a
        query inserting into an async stream mid-delivery) must not block —
        the drain path needs that lock — so it grows the buffer and counts
        the overrun in ``soft_overflows`` instead (the reference's blocking
        ring buffer simply deadlocks in this shape)."""
        if not self._started:
            self.start()
        root = getattr(self.app_context, "root_lock", None)
        may_block = root is None or not rlock_owned(root)
        with self._cv:
            while len(self._q) >= self.buffer_size:
                if may_block and not self._stopped:
                    self._cv.wait(timeout=_FULL_WAIT_S)
                    continue
                self.soft_overflows += 1
                break
            self._q.append(item)
            self._n_events += self._item_size(item)
            self.total_enqueued += 1
            if len(self._q) > self.high_water:
                self.high_water = len(self._q)
            self._cv.notify()

    def drop_oldest(self):
        """Evict and return the oldest queued item (``('event', ev)`` /
        ``('chunk', [evs])``), or None when the queue is empty — the
        DROP_OLDEST overload policy's hook (``flow/backpressure.py``)."""
        with self._cv:
            if not self._q:
                return None
            item = self._q.popleft()
            self._n_events -= self._item_size(item)
            self._cv.notify_all()       # wake producers blocked on full
            return item

    # -- worker side ---------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stopped:
                    self._cv.wait(timeout=0.5)
                if self._stopped and not self._q:
                    return
                batch = []
                while self._q and len(batch) < self.batch_size_max:
                    batch.append(self._q.popleft())
                self._busy += 1
                self._cv.notify_all()       # wake producers blocked on full
            try:
                self._deliver(batch)
            except Exception:  # noqa: BLE001 — junction isolates per-receiver;
                # anything escaping here is a bug, but a worker must survive
                log.exception("async delivery failed on stream '%s'",
                              self.junction.definition.id)
            finally:
                with self._cv:
                    # credits free only when delivery COMPLETES: an in-flight
                    # batch still counts against the gate's bound, or the
                    # gate would over-admit by workers * batch_size_max
                    self._n_events -= sum(self._item_size(i) for i in batch)
                    self._busy -= 1
                    self._cv.notify_all()   # wake quiesce() waiters

    def _deliver(self, batch: list) -> None:
        with self.app_context.root_lock:
            for kind, payload in batch:
                if kind == "chunk":
                    # watermark to the chunk's first timestamp before delivery,
                    # the rest after (InputHandler chunk-send semantics)
                    self.app_context.advance_time(
                        min(ev.timestamp for ev in payload))
                    self.junction.deliver_events(payload)
                    self.app_context.advance_time(
                        max(ev.timestamp for ev in payload))
                else:
                    self.app_context.advance_time(payload.timestamp)
                    self.junction.deliver_event(payload)

    # -- barrier (ThreadBarrier analog) --------------------------------------
    def quiesce(self, timeout: float = 30.0) -> bool:
        """Block until the buffer is empty and all workers are idle. Called by
        snapshot/persist (the reference quiesces ingress with ThreadBarrier
        before walking state) and by shutdown."""
        import time
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._q or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=min(remaining, 0.5))
        return True
