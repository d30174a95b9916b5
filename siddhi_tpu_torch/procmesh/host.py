"""Fabric-side adapters for process-backed mesh hosts.

:class:`ProcMeshHost` duck-types the in-process ``MeshHost`` surface the
fabric dispatches against (``deploy``/``undeploy``/``evidence``/
``free_slots``/``kill``/``close``), and :class:`RuntimeProxy` duck-types
the slice of ``SiddhiAppRuntime`` the fabric's apply/snapshot/restore
path touches — so ``MeshFabric``'s placement/migration/rebalance ladder
runs unchanged in either mode, byte-compatible by construction.

The proxy's delivery contract differs from the in-process runtime in ONE
deliberate way: output events are buffered on the worker (cursored
outbox) and the fabric dispatches them parent-side only AFTER the chunk
is durable — so a child SIGKILLed between apply and ack re-applies from
the restored pre-chunk state and every output is delivered exactly once
(see ``worker.py``).

The port's copy of the JAX package's ``procmesh/host.py``: an ingest
chunk packs with the port's ``gpu/dcn.py::pack_rows`` (the same SoA wire),
and a host's ``device`` is the CUDA ordinal its worker's engine steps on
(``None`` for a worker on the CPU).
"""

from __future__ import annotations

import re
import socket
import threading
import time
from typing import Callable, Optional

from .protocol import (
    WorkerDown,
    connect,
    connect_timeout_s,
    io_timeout_s,
    op_deadline_s,
    request,
)

# The hedge allowlist: ONLY ops that are idempotent BY WIRE
# CONTRACT may race a second attempt — ingest dedups by seq, resync/flush
# reconcile by cursor, snapshot/metrics/evidence/flight/ping are reads.
# deploy/undeploy/restore/subscribe and every lifecycle op stay out: their
# idempotence is by-tenant convention, not by sequence number, and a
# hedged lifecycle op racing a migration would be a correctness bug.
# the guard-coverage lint (scripts/check_guard_coverage.py) pins this set
# structurally.
HEDGE_SAFE_OPS = frozenset({
    "ingest", "snapshot", "metrics", "evidence", "ping", "resync", "flight",
})

_SLO_CLASS_RE = re.compile(r"slo\.class\s*=\s*'([A-Za-z]+)'")


def slo_class_of(app_text: Optional[str]) -> Optional[str]:
    """The tenant's SLO class from its ``@app:fleet(... slo.class='…')``
    annotation (None → standard budgets). A regex, not a parse: deadline
    derivation must not cost a grammar pass per deploy."""
    m = _SLO_CLASS_RE.search(app_text or "")
    return m.group(1) if m else None


def _soa_types(rows: list) -> Optional[str]:
    """Derive a DCN ``pack_rows`` types string when every value fits the
    SoA wire (bool before int: bool is an int subclass)."""
    if not rows:
        return None
    width = len(rows[0])
    kinds = []
    for c in range(width):
        k = None
        for r in rows:
            if len(r) != width:
                return None
            v = r[c]
            if v is None:
                continue
            if isinstance(v, bool):
                t = "b"
            elif isinstance(v, int):
                t = "l"
            elif isinstance(v, float):
                t = "d"
            elif isinstance(v, str):
                t = "s"
            else:
                return None
            if k is None:
                k = t
            elif k != t:
                return None
        kinds.append(k or "l")      # all-null column: any numeric lane
    return "".join(kinds)


class WorkerClient:
    """One persistent control connection to a worker, ops serialized under
    a lock (the control plane is low-rate; feeder threads of one host
    serialize here exactly like the per-host DCN ingest model). A dead
    socket reconnects ONCE per op — every procmesh op is idempotent
    (deploys dedup by tenant, ingests dedup by seq, restores re-restore
    the same revision), so the retry is the lost-ack recovery path, not a
    double-apply risk.

    Deadline-budgeted hedging: an op in :data:`HEDGE_SAFE_OPS`
    spends only ``hedge_fraction`` of its budget on the first attempt —
    once that elapses, the (possibly desynced) connection is dropped and
    a SECOND attempt goes out over a fresh connection with the remaining
    budget. Exactly-once is pinned by the ops' own dedup (seq for ingest,
    read-only for the rest); ops outside the allowlist structurally never
    get a shortened first deadline. ``observer(op, seconds, ok)`` fires
    once per user-level call with the final outcome — the supervisor's
    per-op latency evidence."""

    def __init__(self, port_fn: Callable[[], Optional[int]],
                 io_timeout_s: Optional[float] = None,
                 connect_timeout_s: Optional[float] = None,
                 hedge_fraction: Optional[float] = 0.45,
                 observer: Optional[Callable[[str, float, bool],
                                             None]] = None):
        self._port_fn = port_fn
        self._io_timeout_s = io_timeout_s       # None → env/module default
        self._connect_timeout_s = connect_timeout_s
        self.hedge_fraction = hedge_fraction    # None disables hedging
        self.observer = observer
        self.hedge_attempts = 0
        self.hedge_wins = 0
        self._sock = None
        self._lock = threading.Lock()

    def base_timeout_s(self) -> float:
        """The resolved base IO deadline (config > env > default)."""
        return io_timeout_s(self._io_timeout_s)

    def _socket(self):
        if self._sock is None:
            port = self._port_fn()
            if port is None:
                raise WorkerDown("worker has no live control port")
            self._sock = connect(port, timeout=connect_timeout_s(
                self._connect_timeout_s), io_timeout=self.base_timeout_s())
        return self._sock

    def drop(self) -> None:
        with self._lock:
            self._drop_locked()

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def call(self, op: str, header: Optional[dict] = None,
             body: bytes = b"", timeout: Optional[float] = None):
        budget = timeout if timeout else self.base_timeout_s()
        # the structural hedge gate: only allowlisted (wire-idempotent)
        # ops ever get a shortened first deadline
        hedged = self.hedge_fraction is not None and op in HEDGE_SAFE_OPS
        first = budget * self.hedge_fraction if hedged else budget
        t0 = time.monotonic()
        ok = False
        try:
            with self._lock:
                try:
                    rv = request(self._socket(), op, header, body,
                                 timeout=first)
                    ok = True
                    return rv
                except WorkerDown as e:
                    # stale connection (worker restarted, idle RST) or a
                    # burned hedge fraction: one fresh-connection attempt
                    # with the remaining budget, then the op's own
                    # idempotence carries it
                    self._drop_locked()
                    hedge = hedged and isinstance(e.__cause__,
                                                  socket.timeout)
                    if hedge:
                        self.hedge_attempts += 1
                    remaining = max(budget - (time.monotonic() - t0), 0.05)
                    try:
                        rv = request(self._socket(), op, header, body,
                                     timeout=remaining)
                    except WorkerDown:
                        self._drop_locked()
                        raise
                    if hedge:
                        self.hedge_wins += 1
                    ok = True
                    return rv
        finally:
            if self.observer is not None:
                try:
                    self.observer(op, time.monotonic() - t0, ok)
                except Exception:   # noqa: BLE001 — evidence must never
                    pass            # fail the op it describes


class RuntimeProxy:
    """The fabric's handle to one tenant runtime living in a worker
    process — the ``SiddhiAppRuntime`` surface ``_apply_locked`` /
    ``_save_tenant_locked`` / ``_restore_on`` dispatch against."""

    procmesh_proxy = True

    def __init__(self, client: WorkerClient, tenant_id: str,
                 slo_class: Optional[str] = None):
        self.client = client
        self.tenant_id = tenant_id
        # the tenant's SLO class scales every per-op deadline budget
        #: premium fails over fast, besteffort waits longer
        self.slo_class = slo_class
        self.callbacks: dict = {}       # stream_id -> [StreamCallback]
        self.delivered = -1             # highest outbox idx dispatched
        self._pending: list = []        # undispatched (idx, sid, ts, row)
        # durable-fabric wiring (mesh/fabric.py journal): outbox indices
        # are namespaced by the tenant's dedup epoch so a restored
        # incarnation's fresh idx space never collides in idempotent sinks
        self.out_epoch = 0
        self.raw_hooks: list = []       # fn([(epoch, idx, sid, ts, row)...])
        self.on_delivered = None        # fn(highest_idx) — journal cursor

    def _deadline(self, op: str) -> float:
        """Per-op deadline budget: op class × SLO class × the client's
        resolved base (MeshConfig > env > default)."""
        return op_deadline_s(op, self.slo_class,
                             self.client.base_timeout_s())

    # -- ingest / outputs ----------------------------------------------------
    def send_chunk(self, seq: int, stream_id: str, rows: list,
                   ts: list, trace: Optional[str] = None) -> bool:
        """Ship one seq-stamped chunk; reply events buffer until the
        fabric confirms durability and calls :meth:`deliver_pending`.
        ``trace`` is a hex-packed TraceContext riding the header — the
        child adopts it only on actual apply (seq dedup), so a lost-ack
        retry carries the SAME context and never doubles a span."""
        from ..gpu.dcn import pack_rows
        h = {"tenant": self.tenant_id, "stream": stream_id, "seq": seq,
             "ack": self.delivered}
        if trace is not None:
            h["trace"] = trace
        types = _soa_types(rows)
        if types is not None:
            h["enc"] = "soa"
            rh, _ = self.client.call(
                "ingest", h, body=pack_rows(types, rows, ts),
                timeout=self._deadline("ingest"))
        else:
            h["rows"], h["ts"] = rows, ts
            rh, _ = self.client.call("ingest", h,
                                     timeout=self._deadline("ingest"))
        self._buffer(rh.get("events", ()))
        return bool(rh.get("applied"))

    def _buffer(self, events) -> None:
        seen = {e[0] for e in self._pending}
        for e in events:
            idx = e[0]
            if idx > self.delivered and idx not in seen:
                self._pending.append(tuple(e))

    def deliver_pending(self) -> None:
        """Dispatch buffered worker outputs to the parent-side callbacks,
        grouped into per-stream runs (order preserved). Raw hooks (durable
        sinks) see every entry with its ``(epoch, idx)`` identity FIRST —
        delivery is at-least-once across a parent crash (the window between
        dispatch and the journaled cursor re-ships), so sinks dedup by that
        pair."""
        from ..core.event import Event
        from .journal import crash_point
        pending, self._pending = sorted(self._pending), []
        if not pending:
            return
        for hook in self.raw_hooks:
            hook([(self.out_epoch, e[0], e[1], e[2], e[3]) for e in pending])
        i = 0
        while i < len(pending):
            sid = pending[i][1]
            j = i
            while j < len(pending) and pending[j][1] == sid:
                j += 1
            evs = [Event(e[2], e[3]) for e in pending[i:j]]
            for cb in self.callbacks.get(sid, ()):
                cb.receive(evs)
            self.delivered = max(self.delivered, pending[j - 1][0])
            i = j
        # delivered-but-not-journaled chaos window: a crash here re-ships
        # the batch on recovery (resync/staged replay) — sinks dedup
        crash_point("deliver.dispatched")
        if self.on_delivered is not None:
            self.on_delivered(self.delivered)

    def pending_outputs(self) -> list:
        """Undispatched outbox entries (journal-checkpoint form): the
        cursor record persists them so a dead-worker recovery can replay
        outputs the old incarnation emitted but the parent never
        dispatched."""
        return [list(e) for e in sorted(self._pending)]

    def resync(self, ack: int) -> dict:
        """Parent-recovery reconciliation against a re-adopted live worker
        (see ``worker.op_resync``): prunes the child outbox through the
        journaled delivery cursor ``ack``, buffers the undelivered tail,
        and returns the child's authoritative applied mark."""
        rh, _ = self.client.call("resync", {"tenant": self.tenant_id,
                                            "ack": ack},
                                 timeout=self._deadline("resync"))
        if rh.get("present"):
            self.delivered = max(self.delivered, int(ack))
            self._buffer(rh.get("events", ()))
        return rh

    def subscribe(self, stream_id: str) -> None:
        """Arm child-side output capture for a stream WITHOUT attaching a
        parent callback (raw-hook sinks read the outbox identity instead
        of events). Idempotent on both sides."""
        if stream_id not in self.callbacks:
            self.callbacks.setdefault(stream_id, [])
            self.client.call("subscribe", {"tenant": self.tenant_id,
                                           "stream": stream_id})

    # -- the runtime surface the fabric touches ------------------------------
    def add_callback(self, stream_id: str, callback) -> None:
        first = stream_id not in self.callbacks
        self.callbacks.setdefault(stream_id, []).append(callback)
        if first:
            self.client.call("subscribe", {"tenant": self.tenant_id,
                                           "stream": stream_id})

    def flush_host(self) -> None:
        rh, _ = self.client.call("flush", {"tenant": self.tenant_id,
                                           "ack": self.delivered},
                                 timeout=self._deadline("flush"))
        self._buffer(rh.get("events", ()))

    def snapshot(self) -> bytes:
        _, blob = self.client.call("snapshot", {"tenant": self.tenant_id},
                                   timeout=self._deadline("snapshot"))
        return blob

    def restore(self, blob: bytes, applied: int = 0) -> None:
        self.client.call("restore", {"tenant": self.tenant_id,
                                     "applied": applied}, body=blob,
                         timeout=self._deadline("restore"))

    def shutdown(self) -> None:     # parity with SiddhiAppRuntime.shutdown
        self.client.call("undeploy", {"tenant": self.tenant_id},
                         timeout=self._deadline("undeploy"))


class ProcMeshHost:
    """One process-backed engine shard, byte-compatible with ``MeshHost``
    for the fabric's dispatch surface. The OS process itself belongs to
    the supervisor (``handle``); this object is the fabric's view."""

    def __init__(self, handle, capacity: int, device: Optional[int] = None,
                 playback: bool = True):
        self.handle = handle            # supervisor's ProcWorkerHandle
        self.index = handle.index
        self.capacity = capacity
        self.device = device
        self.playback = playback
        self.runtimes: dict = {}        # tenant_id -> RuntimeProxy
        self.rows_in = 0
        self.reserved = 0
        self.alive = True
        # degrade-drain flag: a draining host serves its
        # current tenants but takes no new placements
        self.draining = False
        self._specs: dict = {}          # tenant_id -> TenantSpec (redeploy)
        self._sm = None
        self._scrape_cache: dict = {}
        self._scrape_counters: dict = {}
        self._scrape_latency: dict = {}     # name -> LogHistogram state
        self._scrape_t: Optional[float] = None  # monotonic of last GOOD scrape
        self._scrape_t0 = time.monotonic()
        self._last_child_evidence: dict = {}

    @property
    def client(self) -> WorkerClient:
        return self.handle.client

    @property
    def free_slots(self) -> int:
        return self.capacity - len(self.runtimes) - self.reserved

    @property
    def slot(self):
        from ..mesh.plan import HostSlot
        return HostSlot(self.index, self.capacity, self.device)

    # -- tenant lifecycle ----------------------------------------------------
    def deploy(self, spec) -> RuntimeProxy:
        klass = slo_class_of(spec.app_text)
        self.client.call("deploy", {"tenant": spec.tenant_id,
                                    "app_text": spec.app_text,
                                    "playback": self.playback},
                         timeout=max(op_deadline_s(
                             "deploy", klass,
                             self.client.base_timeout_s()), 60.0))
        proxy = RuntimeProxy(self.client, spec.tenant_id, slo_class=klass)
        self.runtimes[spec.tenant_id] = proxy
        self._specs[spec.tenant_id] = spec
        return proxy

    def adopt_runtime(self, spec) -> RuntimeProxy:
        """Attach a proxy to a tenant the worker ALREADY hosts (parent
        recovery re-adoption): no deploy op — the shard keeps its engine
        state; the caller reconciles cursors via :meth:`RuntimeProxy.
        resync`."""
        proxy = RuntimeProxy(self.client, spec.tenant_id,
                             slo_class=slo_class_of(spec.app_text))
        self.runtimes[spec.tenant_id] = proxy
        self._specs[spec.tenant_id] = spec
        return proxy

    def undeploy(self, tenant_id: str) -> None:
        rt = self.runtimes.pop(tenant_id, None)
        self._specs.pop(tenant_id, None)
        if rt is not None:
            rt.shutdown()

    def compiled_programs(self) -> int:
        try:
            rh, _ = self.client.call("evidence")
            return int(rh["evidence"].get("compiled_programs", 0))
        except WorkerDown:
            return 0

    def evidence(self) -> dict:
        """Parent-side routing view merged with the child's fleet-tier
        scrape; a freshly dead child serves the last good scrape so an
        evidence walk racing a crash never takes the control plane down."""
        try:
            rh, _ = self.client.call("evidence")
            self._last_child_evidence = dict(rh["evidence"])
        except WorkerDown:
            pass
        child = dict(self._last_child_evidence)
        child.pop("tenants", None)
        child.pop("rows_in", None)
        return {
            "host": self.index, "device": self.device,
            "alive": self.alive,
            "tenants": len(self.runtimes),
            "capacity": self.capacity,
            "rows_in": self.rows_in,
            "mode": "process",
            # restart churn feeds placement/rebalance scoring: a
            # respawned worker is a worse home until it proves stable
            "restarts": self.handle.restarts,
            **child,
        }

    # -- child metric aggregation -------------------------------------------
    def scrape_metrics(self) -> dict:
        """Pull the child's full tracker state over the control wire. On
        ``WorkerDown`` the last good scrape is KEPT but its age keeps
        growing (:meth:`scrape_age_s`) — the federation layer expires
        families past the staleness ceiling instead of rendering dead
        values as live (the staleness fix)."""
        try:
            rh, _ = self.client.call("metrics")
            self._scrape_cache = dict(rh.get("gauges", {}))
            self._scrape_counters = dict(rh.get("counters", {}))
            self._scrape_latency = dict(rh.get("latency", {}))
            self._scrape_t = time.monotonic()
        except WorkerDown:
            pass                        # keep the last scrape; age grows
        return self._scrape_cache

    def scrape_age_s(self) -> float:
        """Seconds since the last SUCCESSFUL child scrape (since host
        creation when none ever landed) — the exported freshness signal:
        a dead or gave-up worker's age grows without bound, and the
        federated exposition drops its families past the ceiling."""
        return time.monotonic() - (self._scrape_t if self._scrape_t
                                   is not None else self._scrape_t0)

    def counter_states(self) -> dict:
        return dict(self._scrape_counters)

    def latency_states(self) -> dict:
        """Last scraped ``{tenant.name: LogHistogram state}`` — the raw
        material the fabric merges into per-worker and fabric-level
        families."""
        return dict(self._scrape_latency)

    def register_child_metrics(self, sm) -> int:
        """(Re-)register the child's scraped gauge families under
        ``mesh.h{i}.child.*``. Idempotent by unregister-first, so a
        restarted child's fresh families replace the old generation —
        never leak beside it (tests/test_metrics.py pins the teardown).
        ``scrape_age_s`` rides the same prefix, so the freshness gauge
        tears down with the host."""
        self._sm = sm
        sm.unregister(f"mesh.h{self.index}.child.")
        names = sorted(self.scrape_metrics())
        for name in names:
            sm.gauge_tracker(
                f"mesh.h{self.index}.child.{name}",
                lambda name=name: self._scrape_cache.get(name, 0.0))
        sm.gauge_tracker(f"mesh.h{self.index}.child.scrape_age_s",
                         self.scrape_age_s)
        return len(names)

    def unregister_child_metrics(self) -> None:
        if self._sm is not None:
            self._sm.unregister(f"mesh.h{self.index}.child.")

    # -- flight-recorder forwarding -----------------------------------------
    def forward_flight(self, flight, tracer=None) -> int:
        """Absorb the child runtimes' control-plane transitions into the
        fabric's ring (site-prefixed ``h{i}:``), tailing by the ring's
        loss-free ``since_ns`` cursor. Child stamps are corrected by the
        supervisor's clock-offset estimate so the merged timeline is
        causally ordered; trace journeys riding the tail stitch into
        ``tracer`` (span-identity dedup — idempotent)."""
        try:
            rh, _ = self.client.call(
                "flight", {"since_ns": self.handle.flight_cursor})
        except WorkerDown:
            return 0
        entries = rh.get("entries", [])
        offset_ns = int(getattr(self.handle, "clock_offset_ns", 0))
        if entries:
            self.handle.flight_cursor = max(e["t_ns"] for e in entries)
        if tracer is not None:
            for tj in rh.get("traces", ()):
                try:
                    tracer.stitch(int(tj.get("origin_host", 0)),
                                  int(tj.get("trace_id", 0)),
                                  tj.get("spans", ()),
                                  offset_ns=offset_ns,
                                  stream=tj.get("stream", "procmesh"))
                except Exception:   # noqa: BLE001 — stitching must never
                    continue        # take the sync path down
        return flight.absorb(entries, site_prefix=f"h{self.index}:",
                             offset_ns=offset_ns)

    # -- crash / teardown ----------------------------------------------------
    def kill(self) -> None:
        """REAL host SIGKILL: the supervisor nukes the child process; the
        proxies die with it (state recovers from the parent's snapshot
        store, exactly like the simulated in-process kill)."""
        self.handle.kill()
        self.drop_runtimes()

    def drop_runtimes(self) -> None:
        self.runtimes.clear()
        self._specs.clear()
        self.client.drop()

    def close(self) -> None:
        self.alive = False
        self.unregister_child_metrics()
        try:
            self.client.call("stop", timeout=5.0)
        except WorkerDown:
            pass
        self.handle.reap(timeout=5.0)
        self.runtimes.clear()
        self._specs.clear()
