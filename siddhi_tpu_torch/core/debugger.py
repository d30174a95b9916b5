"""Debugger: breakpoints at query IN/OUT terminals with step/play control.

Reference: ``core/debugger/SiddhiDebugger.java:36`` (acquireBreakPoint:95,
checkBreakPoint:133, next:182, play:190) + ``SiddhiDebuggerCallback``. The
reference blocks the sender thread on a lock; this engine is batch-synchronous
and single-threaded per send, so the callback runs inline and the returned
command (``NEXT`` — break again at the next terminal, ``PLAY`` — run until the
next explicitly acquired breakpoint) drives stepping deterministically.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

from .event import Event, EventType, StreamEvent


class QueryTerminal(enum.Enum):
    IN = "in"
    OUT = "out"


class SiddhiDebugger:
    NEXT = "next"
    PLAY = "play"

    def __init__(self, app_context):
        self.app_context = app_context
        self._breakpoints: set[tuple[str, QueryTerminal]] = set()
        self._callback: Optional[Callable] = None
        self._step_mode = False

    # -- reference API ---------------------------------------------------------
    def acquire_break_point(self, query_name: str, terminal: QueryTerminal) -> None:
        self._breakpoints.add((query_name, terminal))

    def release_break_point(self, query_name: str, terminal: QueryTerminal) -> None:
        self._breakpoints.discard((query_name, terminal))

    def release_all_break_points(self) -> None:
        self._breakpoints.clear()
        self._step_mode = False

    def set_debugger_callback(self, callback: Callable) -> None:
        """callback(event: Event, query_name: str, terminal: QueryTerminal,
        debugger) -> 'next' | 'play' | None."""
        self._callback = callback

    def next(self) -> None:
        self._step_mode = True

    def play(self) -> None:
        self._step_mode = False

    # -- engine hook -----------------------------------------------------------
    def check_break_point(self, query_name: str, terminal: QueryTerminal,
                          event: StreamEvent) -> None:
        if self._callback is None:
            return
        if self._step_mode or (query_name, terminal) in self._breakpoints:
            cmd = self._callback(
                Event(event.timestamp, list(event.data),
                      event.type == EventType.EXPIRED),
                query_name, terminal, self)
            if cmd == self.NEXT:
                self._step_mode = True
            elif cmd == self.PLAY:
                self._step_mode = False

    def get_query_state(self, query_name: str) -> dict:
        """Inspect the registered state of a query's elements (windows,
        selectors, pattern tables) by element-id prefix."""
        out = {}
        for element_id, holder in self.app_context.state_registry.items():
            # element ids are '{query}-{kind}[-{seq}]' — prefix match, so
            # 'q1' doesn't also pick up 'q10-...'
            if element_id == query_name or \
                    element_id.startswith(query_name + "-") or \
                    element_id == "device-" + query_name:
                try:
                    out[element_id] = holder.snapshot_state()
                except Exception:  # noqa: BLE001 — best-effort inspection
                    pass
        return out


class DebuggedReceiver:
    """Wraps a query's junction receiver with the IN-terminal check."""

    def __init__(self, inner, query_name: str, app_context):
        self.inner = inner
        self.query_name = query_name
        self.app_context = app_context

    def receive(self, event: StreamEvent) -> None:
        dbg = getattr(self.app_context, "debugger", None)
        if dbg is not None and event.type == EventType.CURRENT:
            dbg.check_break_point(self.query_name, QueryTerminal.IN, event)
        self.inner.receive(event)

    def receive_chunk(self, events: list[StreamEvent]) -> None:
        dbg = getattr(self.app_context, "debugger", None)
        if dbg is not None:
            for ev in events:
                if ev.type == EventType.CURRENT:
                    dbg.check_break_point(self.query_name, QueryTerminal.IN, ev)
        if hasattr(self.inner, "receive_chunk"):
            self.inner.receive_chunk(events)
        else:
            for ev in events:
                self.inner.receive(ev)


class DebuggedOutput:
    """Sits before the query's output fanout for the OUT-terminal check."""

    def __init__(self, inner, query_name: str, app_context):
        self.inner = inner
        self.query_name = query_name
        self.app_context = app_context

    def process(self, events: list[StreamEvent]) -> None:
        dbg = getattr(self.app_context, "debugger", None)
        if dbg is not None:
            for ev in events:
                # RESET markers (and window-internal TIMER rows) are engine
                # protocol, not output events — a stepping user sees only
                # CURRENT/EXPIRED, like the reference OUT terminal
                if ev.type in (EventType.CURRENT, EventType.EXPIRED):
                    dbg.check_break_point(self.query_name, QueryTerminal.OUT, ev)
        self.inner.process(events)
