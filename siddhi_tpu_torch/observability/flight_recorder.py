"""Engine flight recorder: a bounded, always-on ring of control-plane
transitions.

The port's copy of the JAX package's ``observability/flight_recorder.py``.

Spans record *data-plane* time; this ring records *decisions* — the AIMD
controller resizing a flush window, a flush cause flipping to ``deadline``,
a circuit breaker opening, a tenant ejecting from its fleet group, a DCN
survivor taking over a lane group. When a device round shows p99 latency
"dominated by deadline-flush queueing", the flight recorder is what lets
the claim be read off a timeline instead of reconstructed from logs.

Design constraints (this runs on EVERY app, armed by default):

- **lock-cheap**: entries are tuples appended to a ``deque(maxlen=N)`` —
  one GIL-atomic append per transition, no lock, no allocation beyond the
  tuple; steady-state memory is bounded by the ring capacity plus a
  per-site last-kind map bounded by the number of sites;
- **transition-oriented**: hot repeating events (capacity flushes,
  fair-share sheds) record only when their kind CHANGES per site
  (:meth:`record_transition`), so a saturated pipeline cannot evict the
  interesting entries;
- **trace cross-referenced**: a transition provoked by a traced batch
  carries the trace id, linking the control-plane timeline to the exact
  data-plane journey that triggered it;
- **dump on fault**: quarantine/ejection/escalation calls
  :meth:`on_fault`; with ``@app:flightrecorder(dir='...')`` (or the
  ``SIDDHI_FLIGHT_DIR`` env var) the ring dumps to a timestamped JSON
  file so post-mortems survive the process.

Served at ``GET /siddhi-apps/{name}/flightrecorder`` (``?category=`` /
``?limit=`` / ``?since_ns=`` filters). Entries carry a per-recorder
strictly-increasing ``t_ns`` wall-clock nanosecond stamp, so ``since_ns``
is a loss-free tail cursor: pass the largest ``t_ns`` seen and only newer
transitions come back — the SLO controller and external pollers tail the
bounded ring incrementally instead of re-reading it.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time
from collections import deque
from typing import Optional

log = logging.getLogger("siddhi_tpu_torch.observability")

# entry tuple layout (kept positional — one tuple per transition);
# _T is wall-clock NANOSECONDS, strictly increasing per recorder (the
# since_ns cursor contract)
_T, _SEQ, _CAT, _KIND, _SITE, _DETAIL, _TRACE = range(7)


class FlightRecorder:
    """One app's control-plane ring."""

    CATEGORIES = ("flow", "breaker", "device", "fleet", "host", "dcn",
                  "slo", "mesh", "procmesh")

    def __init__(self, capacity: int = 2048,
                 dump_dir: Optional[str] = None, app_name: str = ""):
        if capacity < 1:
            raise ValueError(f"bad flight recorder capacity {capacity}")
        self.ring: deque = deque(maxlen=capacity)
        self.app_name = app_name
        self.dump_dir = dump_dir
        self.dumps = 0
        self.recorded = 0
        self._seq = itertools.count()
        self._last_kind: dict = {}      # (category, site) -> kind
        self._last_t_ns = 0             # monotonic-bump cursor state

    # -- recording (hot-path safe) --------------------------------------------
    def record(self, category: str, kind: str, site: str = "",
               detail=None, trace_id=None) -> None:
        """Append one transition. Never raises, never blocks: tuple build +
        deque append under the GIL. The stored nanosecond stamp is bumped
        past the previous entry's, so ``t_ns`` is a usable tail cursor
        (best-effort under concurrent recorders racing the bump — ``seq``
        stays strict regardless)."""
        self.recorded += 1
        t_ns = time.time_ns()
        if t_ns <= self._last_t_ns:
            t_ns = self._last_t_ns + 1
        self._last_t_ns = t_ns
        self.ring.append((t_ns, next(self._seq), category, kind,
                          site, detail, trace_id))

    def record_transition(self, category: str, kind: str, site: str = "",
                          detail=None, trace_id=None) -> bool:
        """Record only when ``kind`` differs from the site's previous kind —
        the dedupe that keeps repeating hot events (every capacity flush,
        every shed) from flooding the ring. Returns True when recorded."""
        key = (category, site)
        if self._last_kind.get(key) == kind:
            return False
        self._last_kind[key] = kind
        self.record(category, kind, site, detail, trace_id)
        return True

    def breaker_listener(self, category: str, site: str):
        """A :class:`~siddhi_tpu_torch.resilience.circuit.CircuitBreaker`
        ``listener`` recording every state transition for this site."""
        def on_transition(old: str, new: str) -> None:
            self.record(category, f"circuit:{new}", site,
                        detail={"from": old})
        return on_transition

    def absorb(self, entries: list, site_prefix: str = "",
               offset_ns: Optional[int] = None) -> int:
        """Merge EXPORTED entries from another recorder into this ring —
        the procmesh fabric forwarding a child worker's transitions into
        the parent's timeline. Sites gain ``site_prefix`` (``h3:``) so a
        merged timeline still attributes decisions to the host process
        that made them.

        Without ``offset_ns`` stamps are re-minted at absorb time (arrival
        order, child timing lost). With ``offset_ns`` — the child clock's
        estimated lead over ours — each entry keeps its ORIGINAL stamp
        corrected into the parent clock domain, so the merged timeline is
        causally ordered across processes; stamps still bump strictly past
        the previous entry (the ``t_ns`` cursor contract survives)."""
        n = 0
        for e in entries:
            try:
                self.recorded += 1
                if offset_ns is None:
                    t_ns = time.time_ns()
                else:
                    t_ns = int(e.get("t_ns", 0)) - int(offset_ns)
                if t_ns <= self._last_t_ns:
                    t_ns = self._last_t_ns + 1
                self._last_t_ns = t_ns
                self.ring.append((t_ns, next(self._seq),
                                  e.get("category", "procmesh"),
                                  e.get("kind", ""),
                                  f"{site_prefix}{e.get('site', '')}",
                                  e.get("detail"),
                                  e.get("trace_id")))
                n += 1
            except Exception:   # noqa: BLE001 — observability must never
                # take the forwarding path down
                continue
        return n

    # -- fault dump ------------------------------------------------------------
    def on_fault(self, reason: str, site: str = "") -> Optional[str]:
        """Quarantine/ejection/escalation hook: dump the ring to JSON when a
        dump dir is configured (else no-op beyond a debug log). Returns the
        dump path, if written."""
        if self.dump_dir is None:
            return None
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            self.dumps += 1
            name = f"flight_{self.app_name or 'app'}_" \
                   f"{int(time.time() * 1e3)}_{self.dumps}.json"
            path = os.path.join(self.dump_dir, name)
            with open(path, "w") as f:
                json.dump({"app": self.app_name, "reason": reason,
                           "site": site, "dumped_at": time.time(),
                           "entries": self.export()}, f)
            return path
        except OSError as e:
            log.warning("flight recorder dump failed: %s", e)
            return None

    # -- export ----------------------------------------------------------------
    def export(self, category: Optional[str] = None,
               limit: Optional[int] = None,
               since_ns: Optional[int] = None) -> list[dict]:
        """Exported entries, oldest first. ``since_ns`` tails the ring
        incrementally: only entries with ``t_ns`` strictly greater come
        back (pass the largest ``t_ns`` of the previous page)."""
        entries = list(self.ring)
        if since_ns is not None:
            entries = [e for e in entries if e[_T] > since_ns]
        if category is not None:
            entries = [e for e in entries if e[_CAT] == category]
        if limit is not None:
            entries = entries[-limit:] if limit > 0 else []
        out = []
        for e in entries:
            d = {"t": e[_T] / 1e9, "t_ns": e[_T], "seq": e[_SEQ],
                 "category": e[_CAT], "kind": e[_KIND], "site": e[_SITE]}
            if e[_DETAIL] is not None:
                d["detail"] = e[_DETAIL]
            if e[_TRACE] is not None:
                d["trace_id"] = e[_TRACE]
            out.append(d)
        return out

    def report(self) -> dict:
        return {"capacity": self.ring.maxlen, "retained": len(self.ring),
                "recorded": self.recorded, "dumps": self.dumps,
                "dump_dir": self.dump_dir}


def parse_flightrecorder_annotation(ann, app_name: str) -> FlightRecorder:
    """``@app:flightrecorder(ring='2048', dir='/tmp/flight')`` → recorder.
    Absent annotation still gets a default recorder (always-on); the env
    var ``SIDDHI_FLIGHT_DIR`` arms fault dumps fleet-wide."""
    ring = 2048
    dump_dir = os.environ.get("SIDDHI_FLIGHT_DIR") or None
    if ann is not None:
        ring = int(ann.get("ring") or ring)
        dump_dir = ann.get("dir") or dump_dir
    return FlightRecorder(capacity=ring, dump_dir=dump_dir,
                          app_name=app_name)
