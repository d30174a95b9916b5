"""Pipeline tracing: sampled per-event span chains across engine stages.

The port's copy of the JAX package's ``observability/tracing.py``, whole:
:class:`TraceContext` included, although the DCN hop that carries it comes
with distribution (``ROADMAP.md`` §A item 8).

``@app:trace(sample='1/16', ring='2048')`` arms a per-app
:class:`PipelineTracer`. Every Nth ``InputHandler.send`` (or WAL-admitted
flow ingress) opens a :class:`Trace`; as the event moves junction → query
runtime → window/NFA processor → device micro-batch → selector → sink
pipeline, each stage appends a :class:`Span` with its wall-time, batch
size, and outcome. Completed chains sit in a bounded ring, exported as
JSON by ``GET /siddhi-apps/{name}/trace``.

Spans are a **waterfall**, not just durations: every span carries a
``start_offset_ns`` from trace ingress, and every stage name classifies
into one of the X-Ray *phases* (:data:`siddhi_tpu_torch.observability.phases.
PHASES`) so a trace answers "where did the latency go" the same way the
always-on per-phase histograms do.

Propagation is thread-local: host-path processing is synchronous under
the engine lock, so the stack-scoped "active trace" rides the call chain
for free (TiLT-style per-operator attribution, arXiv:2301.12030, without
threading a context argument through every processor). The two async
hops carry it explicitly — ``@async`` junction events are stamped with
``StreamEvent.trace`` at enqueue (plus a handoff mark so the queue wait
becomes an ``ingress-queue`` span at delivery) and re-activated on the
worker, and device bridges register pending traces at packing time,
closing their ``device`` span when the micro-batch steps.

**Cross-host stitching**: a sampled trace serializes to a
:class:`TraceContext` (trace id, origin host, ingress wall-clock, send
wall-clock) that rides ``K_ROWS`` frames through the DCN worker — baked
into the frame bytes, it survives retry/dedup, spill replay, and
lane-group failover for free — and :meth:`PipelineTracer.adopt`
re-activates it on the receiving host, so one trace id spans the whole
mesh with a ``dcn`` hop span. Offsets of adopted spans anchor to the
ORIGIN ingress wall-clock (cross-host ``perf_counter`` values are not
comparable; loopback/NTP-grade skew is the documented error bar).
"""

from __future__ import annotations

import itertools
import struct
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

from .phases import phase_of_stage


class Span:
    __slots__ = ("stage", "name", "start_offset_ns", "duration_ns",
                 "batch_size", "outcome")

    def __init__(self, stage: str, name: str, duration_ns: int,
                 batch_size: int = 1, outcome: str = "ok",
                 start_offset_ns: int = 0):
        self.stage = stage
        self.name = name
        self.duration_ns = max(0, int(duration_ns))
        self.start_offset_ns = max(0, int(start_offset_ns))
        self.batch_size = batch_size
        self.outcome = outcome

    def to_dict(self) -> dict:
        return {"stage": self.stage, "name": self.name,
                "phase": phase_of_stage(self.stage),
                "start_offset_ms": self.start_offset_ns / 1e6,
                "duration_ms": self.duration_ns / 1e6,
                "batch_size": self.batch_size, "outcome": self.outcome}


class Trace:
    """One sampled event's journey: an append-only span chain."""

    __slots__ = ("trace_id", "stream", "started_at", "host", "origin_host",
                 "spans", "_t0_ns", "_handoff_ns")

    def __init__(self, trace_id: int, stream: str,
                 host: Optional[int] = None,
                 origin_host: Optional[int] = None,
                 t0_ns: Optional[int] = None,
                 started_at: Optional[float] = None):
        self.trace_id = trace_id
        self.stream = stream
        self.started_at = time.time() if started_at is None else started_at
        self.host = host                  # host recording spans (None: local)
        self.origin_host = origin_host    # ingress host for adopted traces
        self.spans: list[Span] = []
        # perf-counter anchor of trace ingress: add_span derives each span's
        # waterfall start offset from it (adopted traces back-date it to the
        # origin's ingress wall-clock)
        self._t0_ns = time.perf_counter_ns() if t0_ns is None else t0_ns
        self._handoff_ns: Optional[int] = None

    def add_span(self, stage: str, name: str, duration_ns: int,
                 batch_size: int = 1, outcome: str = "ok",
                 start_offset_ns: Optional[int] = None) -> None:
        # list.append is atomic under the GIL; spans may arrive from the
        # engine thread and a device worker. The default start offset
        # back-dates from "now - duration" — callers time spans with
        # perf_counter_ns around the work, so this is exact.
        if start_offset_ns is None:
            start_offset_ns = \
                time.perf_counter_ns() - int(duration_ns) - self._t0_ns
        self.spans.append(Span(stage, name, duration_ns, batch_size, outcome,
                               start_offset_ns))

    # -- async handoff ---------------------------------------------------------
    def mark_handoff(self) -> None:
        """Stamp the enqueue instant of an @async hop; the delivery worker
        turns it into an ``ingress-queue`` span on re-activation."""
        self._handoff_ns = time.perf_counter_ns()

    def close_handoff(self, name: str) -> None:
        h = self._handoff_ns
        if h is None:
            return
        self._handoff_ns = None
        now = time.perf_counter_ns()
        self.add_span("queue", name, now - h,
                      start_offset_ns=h - self._t0_ns)

    def stages(self) -> set:
        return {s.stage for s in self.spans}

    def spans_wire(self) -> list:
        """Raw-nanosecond, JSON-safe span dump for cross-PROCESS shipping
        (the procmesh flight tail) — :meth:`to_dict` renders milliseconds
        for humans; the stitch side needs exact ns for dedup identity."""
        return [{"stage": s.stage, "name": s.name,
                 "start_offset_ns": s.start_offset_ns,
                 "duration_ns": s.duration_ns,
                 "batch_size": s.batch_size, "outcome": s.outcome}
                for s in self.spans]

    def to_dict(self) -> dict:
        out = {"trace_id": self.trace_id, "stream": self.stream,
               "started_at": self.started_at,
               "spans": [s.to_dict() for s in self.spans]}
        if self.host is not None:
            out["host"] = self.host
        if self.origin_host is not None:
            out["origin_host"] = self.origin_host
        return out


# wire format of one trace context on a K_ROWS frame:
# (trace_id u64, origin_host u8, ingress_unix_ns i64, sent_unix_ns i64)
_CTX_FMT = struct.Struct(">QBqq")


class TraceContext:
    """Serializable cross-host trace handle riding a DCN frame."""

    __slots__ = ("trace_id", "origin_host", "ingress_unix_ns",
                 "sent_unix_ns")

    def __init__(self, trace_id: int, origin_host: int,
                 ingress_unix_ns: int, sent_unix_ns: int):
        self.trace_id = trace_id
        self.origin_host = origin_host
        self.ingress_unix_ns = ingress_unix_ns
        self.sent_unix_ns = sent_unix_ns

    def pack(self) -> bytes:
        return _CTX_FMT.pack(self.trace_id & (2 ** 64 - 1),
                             self.origin_host & 0xFF,
                             self.ingress_unix_ns, self.sent_unix_ns)

    @classmethod
    def unpack_from(cls, buf: bytes, offset: int = 0) -> "TraceContext":
        return cls(*_CTX_FMT.unpack_from(buf, offset))

    size = _CTX_FMT.size


class PipelineTracer:
    """Per-app sampler + span ring + thread-local active-trace stack."""

    def __init__(self, sample_n: int = 16, ring_size: int = 2048,
                 host: Optional[int] = None):
        if sample_n < 1 or ring_size < 1:
            raise ValueError(
                f"bad trace config (sample=1/{sample_n}, ring={ring_size})")
        self.sample_n = sample_n
        self.host = host            # mesh host index (DCN workers set it)
        self.ring: deque = deque(maxlen=ring_size)
        self._seq = itertools.count()
        self._ids = itertools.count(1)
        self._tl = threading.local()
        # adopted foreign traces by (origin_host, trace_id): a frame retried
        # after a lost ack dedups at the engine layer and never re-adopts,
        # but spill replay across a takeover may deliver contexts for a
        # trace this host already holds — those must stitch into ONE trace
        self._adopted: OrderedDict = OrderedDict()
        self._adopted_cap = ring_size

    # -- sampling --------------------------------------------------------------
    def maybe_trace(self, stream_id: str) -> Optional[Trace]:
        """Every Nth call opens a trace (and retains it in the ring)."""
        if next(self._seq) % self.sample_n != 0:
            return None
        tid = next(self._ids)
        if self.host is not None:
            # disambiguate ids across mesh hosts: each host mints in its own
            # high-bits namespace, so a stitched trace id names ONE journey
            tid |= (self.host + 1) << 48
        tr = Trace(tid, stream_id, host=self.host, origin_host=self.host)
        if self.host is not None:
            # local journeys are stitch targets too: a spill-replayed frame
            # applied locally after a takeover re-activates its context on
            # the ORIGIN host — the hop span must land on the same trace
            self._register_adopted((self.host, tid), tr)
        self.ring.append(tr)
        return tr

    # -- cross-host stitching --------------------------------------------------
    def context_of(self, trace: Trace) -> TraceContext:
        """Serialize a local trace for a DCN hop (send time stamped NOW —
        frame build time; the receiver's hop span therefore includes retry
        and spill-replay delay, which is the honest transit cost)."""
        now_unix = time.time_ns()
        ingress_unix = now_unix - (time.perf_counter_ns() - trace._t0_ns)
        return TraceContext(trace.trace_id,
                            trace.origin_host if trace.origin_host is not None
                            else (self.host or 0),
                            ingress_unix, now_unix)

    def adopt(self, ctx: TraceContext) -> Trace:
        """Re-activate a foreign trace context on this host: reuse the
        already-adopted trace for (origin, id) or open one anchored to the
        ORIGIN ingress wall-clock, retained in this host's ring."""
        key = (ctx.origin_host, ctx.trace_id)
        tr = self._adopted.get(key)
        if tr is not None:
            return tr
        now_unix = time.time_ns()
        age_ns = max(0, now_unix - ctx.ingress_unix_ns)
        tr = Trace(ctx.trace_id, "dcn", host=self.host,
                   origin_host=ctx.origin_host,
                   t0_ns=time.perf_counter_ns() - age_ns,
                   started_at=ctx.ingress_unix_ns / 1e9)
        self._register_adopted(key, tr)
        self.ring.append(tr)
        return tr

    def stitch(self, origin_host: int, trace_id: int, spans: list,
               offset_ns: int = 0, stream: str = "procmesh") -> Trace:
        """Fold spans shipped from another PROCESS (a procmesh child's
        :meth:`Trace.spans_wire` tail) into the trace holding
        ``(origin, id)`` here — the parent-side half of cross-process
        stitching. ``offset_ns`` is the shipper's wall-clock LEAD over ours
        (the supervisor's per-worker estimate): child offsets anchor to the
        origin ingress via the child's clock, so subtracting the lead makes
        the merged waterfall causally ordered. Dedup is by span identity
        ``(stage, name, corrected offset, duration)`` — re-shipped tails
        are idempotent. Journeys whose local trace was evicted (or that a
        restarted parent never held) get a fresh stitch target."""
        key = (origin_host, trace_id)
        tr = self._adopted.get(key)
        if tr is None:
            tr = Trace(trace_id, stream, host=self.host,
                       origin_host=origin_host)
            self._register_adopted(key, tr)
            self.ring.append(tr)
        seen = {(s.stage, s.name, s.start_offset_ns, s.duration_ns)
                for s in tr.spans}
        for s in spans:
            off = max(0, int(s.get("start_offset_ns", 0)) - int(offset_ns))
            ident = (s.get("stage", ""), s.get("name", ""), off,
                     int(s.get("duration_ns", 0)))
            if ident in seen:
                continue
            seen.add(ident)
            tr.add_span(ident[0], ident[1], ident[3],
                        batch_size=int(s.get("batch_size", 1)),
                        outcome=s.get("outcome", "ok"),
                        start_offset_ns=off)
        return tr

    def _register_adopted(self, key, tr: Trace) -> None:
        self._adopted[key] = tr
        while len(self._adopted) > self._adopted_cap:
            self._adopted.popitem(last=False)

    # -- thread-local propagation ----------------------------------------------
    @property
    def active(self) -> Optional[Trace]:
        stack = getattr(self._tl, "stack", None)
        return stack[-1] if stack else None

    def push(self, trace: Trace) -> None:
        stack = getattr(self._tl, "stack", None)
        if stack is None:
            stack = self._tl.stack = []
        stack.append(trace)

    def pop(self) -> None:
        stack = getattr(self._tl, "stack", None)
        if stack:
            stack.pop()

    # -- export ----------------------------------------------------------------
    def export(self, limit: Optional[int] = None,
               stream: Optional[str] = None) -> list[dict]:
        traces = list(self.ring)
        if stream is not None:
            traces = [t for t in traces if t.stream == stream]
        if limit is not None:               # newest `limit` (0 → none:
            traces = traces[-limit:] if limit > 0 else []   # -0 slices ALL)
        return [t.to_dict() for t in traces]

    def report(self) -> dict:
        return {"sample": f"1/{self.sample_n}",
                "ring_capacity": self.ring.maxlen,
                "retained": len(self.ring)}


def parse_trace_annotation(ann) -> PipelineTracer:
    """``@app:trace(sample='1/16', ring='2048')`` → tracer. ``sample``
    accepts ``1/N`` or a bare ``N`` (both mean one-in-N)."""
    raw = (ann.get("sample") or "1/16").strip()
    if "/" in raw:
        num, _, den = raw.partition("/")
        if num.strip() != "1":
            raise ValueError(
                f"@app:trace sample must be '1/N', got '{raw}'")
        n = int(den)
    else:
        n = int(raw)
    ring = int(ann.get("ring") or 2048)
    return PipelineTracer(sample_n=n, ring_size=ring)
