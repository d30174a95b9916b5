"""Circuit breaker of the sink publish pipeline.

The port's copy of the JAX package's ``resilience/circuit.py``, where it is
shared by sink egress, the device-path quarantine and the DCN peer-health
detector; the port has the sink pipeline only so far.

Classic three-state machine (Nygard; the reference engine's ``Sink.java``
connect/retry loop plays the same role implicitly): CLOSED counts consecutive
failures; after ``failure_threshold`` the circuit OPENs and every attempt is
short-circuited for ``cooldown_s``; the first attempt after the cool-down runs
as a HALF_OPEN probe — success re-closes, failure re-opens and restarts the
cool-down. State transitions are lock-protected: sink publishes may race the
device worker and the service thread.
"""

from __future__ import annotations

import threading
import time


class CircuitState:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    # numeric codes for gauges: a time series must not carry strings
    CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("circuit failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.state = CircuitState.CLOSED
        self.consecutive_failures = 0
        self.opened_at: float | None = None
        self.open_count = 0               # times the circuit tripped
        # flight-recorder hook: called (old_state, new_state) OUTSIDE the
        # lock on every transition; must never raise (it is wrapped anyway)
        self.listener = None
        self._lock = threading.Lock()

    def _notify(self, old: str, new: str) -> None:
        fn = self.listener
        if fn is None or old == new:
            return
        try:
            fn(old, new)
        except Exception:   # noqa: BLE001 — observability must never take
            # the guarded path down
            pass

    @property
    def state_code(self) -> int:
        return CircuitState.CODES[self.state]

    @property
    def suspect(self) -> bool:
        """CLOSED but accumulating failures — the DCN peer detector's
        *suspect* phase between healthy and down."""
        with self._lock:
            return (self.state == CircuitState.CLOSED
                    and self.consecutive_failures > 0)

    def trip(self) -> None:
        """Force OPEN immediately (an unambiguous hard failure — e.g. a
        peer's process is known dead — should not wait out the threshold)."""
        with self._lock:
            old = self.state
            if self.state != CircuitState.OPEN:
                self.open_count += 1
            self.state = CircuitState.OPEN
            self.consecutive_failures = max(self.consecutive_failures,
                                            self.failure_threshold)
            self.opened_at = self.clock()
        self._notify(old, CircuitState.OPEN)

    def allow(self) -> bool:
        """True when an attempt may proceed. An OPEN circuit past its
        cool-down flips to HALF_OPEN and admits exactly the probe call."""
        with self._lock:
            if self.state == CircuitState.CLOSED:
                return True
            if self.state == CircuitState.OPEN:
                if self.opened_at is not None and \
                        self.clock() - self.opened_at >= self.cooldown_s:
                    self.state = CircuitState.HALF_OPEN
                else:
                    return False
            else:
                # HALF_OPEN: one probe is already in flight; further
                # attempts wait for its verdict
                return False
        self._notify(CircuitState.OPEN, CircuitState.HALF_OPEN)
        return True

    def record_success(self) -> None:
        with self._lock:
            old = self.state
            self.consecutive_failures = 0
            self.state = CircuitState.CLOSED
            self.opened_at = None
        self._notify(old, CircuitState.CLOSED)

    def record_failure(self) -> None:
        old = None
        with self._lock:
            self.consecutive_failures += 1
            if self.state == CircuitState.HALF_OPEN or \
                    self.consecutive_failures >= self.failure_threshold:
                old = self.state
                if self.state != CircuitState.OPEN:
                    self.open_count += 1
                self.state = CircuitState.OPEN
                self.opened_at = self.clock()
        if old is not None:
            self._notify(old, CircuitState.OPEN)

    def remaining_cooldown(self) -> float:
        with self._lock:
            if self.state != CircuitState.OPEN or self.opened_at is None:
                return 0.0
            return max(0.0, self.cooldown_s - (self.clock() - self.opened_at))


class RestartBackoff:
    """Exponential restart pacing with a windowed give-up budget — the
    supervisor side of crash recovery (``procmesh/supervisor.py``).

    Each restart attempt inside the sliding window doubles the delay from
    ``base_s`` up to ``max_s``; once ``max_restarts`` attempts land inside
    ``window_s`` the budget is exhausted and :meth:`next_delay` returns
    None — a crash-looping child must become a visible give-up decision,
    not an infinite respawn storm. A child that stays up long enough for
    its attempts to age out of the window earns its budget back
    (:meth:`note_stable` resets it immediately on positive evidence)."""

    def __init__(self, base_s: float = 0.25, max_s: float = 8.0,
                 window_s: float = 60.0, max_restarts: int = 5,
                 clock=time.monotonic):
        if max_restarts < 1:
            raise ValueError("restart max_restarts must be >= 1")
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.window_s = float(window_s)
        self.max_restarts = int(max_restarts)
        self.clock = clock
        self.history: list = []         # attempt times inside the window
        self._lock = threading.Lock()

    def next_delay(self):
        """Delay (seconds) to pause before the next restart attempt, or
        None when the windowed budget is exhausted (give up)."""
        with self._lock:
            now = self.clock()
            self.history = [t for t in self.history
                            if now - t <= self.window_s]
            if len(self.history) >= self.max_restarts:
                return None
            delay = min(self.max_s, self.base_s * (2 ** len(self.history)))
            self.history.append(now)
            return delay

    def note_stable(self) -> None:
        with self._lock:
            self.history.clear()

    def attempt_ages_s(self) -> list:
        """Age (seconds) of each attempt still inside the window — the
        journal-portable form of the budget (monotonic clocks don't
        survive a process restart, relative ages do)."""
        with self._lock:
            now = self.clock()
            return [now - t for t in self.history
                    if now - t <= self.window_s]

    def seed_attempt_ages(self, ages_s) -> None:
        """Re-seed the window from journaled attempt ages: a restarted
        supervisor must not hand a crash-looping child a fresh give-up
        budget just because the parent died with it."""
        with self._lock:
            now = self.clock()
            self.history = sorted(
                now - float(a) for a in ages_s
                if 0.0 <= float(a) <= self.window_s)

    def report(self) -> dict:
        with self._lock:
            return {"attempts_in_window": len(self.history),
                    "max_restarts": self.max_restarts,
                    "window_s": self.window_s}
