"""Time machinery: clocks, timers, TIMER event injection.

Reference: ``core/util/Scheduler.java`` (notifyAt/sendTimerEvents),
``util/timestamp/TimestampGeneratorImpl.java`` (playback event-time clock with idle
heartbeat). Redesigned watermark-style: in playback mode the clock only advances via
event timestamps (or explicit ``advance_time``); due timers fire deterministically
*before* the event that advanced time is processed — no wall-clock callbacks, no
sleeps, matching the batch-synchronous device design where TIMER rows are injected
into micro-batches.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Optional


class TimestampGenerator:
    """Engine clock. ``playback=True`` → event-time; else wall clock (ms)."""

    def __init__(self, playback: bool = False, start_time: int = 0,
                 idle_timeout_ms: int = 0):
        self.playback = playback
        self._current = start_time
        self.idle_timeout_ms = idle_timeout_ms
        # wall time of the last clock advance — read by PlaybackHeartbeat
        self.last_advance_wall = time.time() * 1000

    def current_time(self) -> int:
        if self.playback:
            return self._current
        return int(time.time() * 1000)

    def advance(self, ts: int) -> None:
        self.last_advance_wall = time.time() * 1000
        if ts > self._current:
            self._current = ts


class Scheduler:
    """Deterministic timer service.

    Processors call ``notify_at(ts, callback)``; ``fire_until(now)`` pops and runs
    every due timer in timestamp order. The app runtime calls ``fire_until`` each
    time the clock advances (event arrival in playback mode; a background ticker in
    system-time mode).
    """

    def __init__(self, clock: TimestampGenerator):
        self.clock = clock
        self._heap: list[tuple[int, int, Callable[[int], None]]] = []
        self._counter = itertools.count()
        self._lock = threading.RLock()

    def notify_at(self, ts: int, callback: Callable[[int], None]) -> None:
        with self._lock:
            heapq.heappush(self._heap, (ts, next(self._counter), callback))

    def fire_until(self, now: int) -> None:
        """Run all timers with fire-time <= now (in order)."""
        while True:
            with self._lock:
                if not self._heap or self._heap[0][0] > now:
                    return
                ts, _, cb = heapq.heappop(self._heap)
            cb(ts)

    def has_pending(self) -> bool:
        return bool(self._heap)

    def next_fire_time(self) -> Optional[int]:
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def clear(self) -> None:
        with self._lock:
            self._heap.clear()


class PlaybackHeartbeat:
    """``@app:playback(idle.time='...', increment='...')`` — after
    ``idle.time`` of WALL-clock silence on the ingress, the playback clock
    jumps forward by ``increment`` and due timers fire (reference
    ``util/timestamp/EventTimeBasedMillisTimestampGenerator``'s heartbeat).
    The one deliberate wall-clock element in playback mode: everything else
    stays event-time deterministic."""

    def __init__(self, app_context, idle_ms: int, increment_ms: int):
        self.app_context = app_context
        self.idle_ms = idle_ms
        self.increment_ms = increment_ms
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(max(self.idle_ms / 2000.0, 0.005))
            clock = self.app_context.timestamp_generator
            if (time.time() * 1000) - clock.last_advance_wall < self.idle_ms:
                continue
            with self.app_context.root_lock:
                self.app_context.advance_time(
                    clock.current_time() + self.increment_ms)

    def stop(self) -> None:
        self._stop.set()


class SystemTicker:
    """Background thread firing scheduler timers in wall-clock mode.

    Only started when the app runs with a system clock (playback off); playback apps
    are fully deterministic and never spawn threads.
    """

    def __init__(self, scheduler: Scheduler, resolution_ms: int = 10):
        self.scheduler = scheduler
        self.resolution = resolution_ms / 1000.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.scheduler.fire_until(self.scheduler.clock.current_time())
            self._stop.wait(self.resolution)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None
