"""procmesh host worker: one engine shard as its own OS process.

``python -m siddhi_tpu_torch.procmesh.worker --index N --device D`` boots
an isolated ``SiddhiManager(device=D)`` (so its own FleetManager → its own
shared-plan cache → its own GIL and, on the card, its own CUDA context)
and serves the procmesh control socket. The supervisor reads the
``PROCMESH_READY <hello>`` handshake line from stdout, then the fabric
drives everything over :mod:`~siddhi_tpu_torch.procmesh.protocol` frames.

The port's copy of the JAX package's ``procmesh/worker.py``. ``D`` is
``cpu`` (the kernels' plain versions) or ``cuda[:N]`` (the default): a
worker asked for a card it lacks raises before its handshake, so the
supervisor's spawn fails (``WorkerSpawnError``) and nothing carries on on
the CPU. A worker on the card opens its context and loads the kernel
libraries at boot, before the handshake, so its first ``deploy``/
``ingest`` op pays no context creation inside the op's deadline. Nothing
but the handshake reaches stdout: the worker points its stdout at stderr
while it boots (a library's warning or build log would otherwise break
the handshake, or fill a pipe nobody reads after it).

Exactly-once discipline (the fabric side is
``mesh/fabric.py._apply_locked``):

- every ingest op carries the tenant's monotone chunk ``seq``; the worker
  keeps its own applied mark and DEDUPS retried ops (a lost ack must not
  double-apply — the ``K_ROWS`` receiver discipline applied to control
  ops);
- output events land in a per-tenant cursored outbox; every reply ships
  the entries past the client's acked cursor, so a retried op re-delivers
  the same events with the same indices and the parent dedups by cursor —
  lost-ack retries are idempotent for outputs too;
- the parent delivers outputs only AFTER the chunk is durable in its
  snapshot store, so a child killed between apply and ack re-applies the
  chunk from the restored pre-chunk state and emits exactly once.

Every socket read in the serve loop arms a deadline
(the JAX package's ``scripts/check_socket_timeouts.py`` pins the
invariant); idle timeouts
re-check the stop flag, the DCN worker's serve pattern.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import sys
import threading
import time

from .protocol import (
    F_ERR,
    F_REQ,
    F_RES,
    io_timeout_s,
    recv_frame,
    send_frame,
    wire_counters,
)

log = logging.getLogger("siddhi_tpu_torch.procmesh.worker")

_ACCEPT_POLL_S = 0.5


class _Tenant:
    """Worker-side state of one deployed tenant: the runtime, the ingest
    dedup mark, and the cursored output outbox."""

    __slots__ = ("rt", "applied", "out", "out_next", "subs")

    def __init__(self, rt):
        self.rt = rt
        self.applied = 0        # last applied chunk seq (op dedup mark)
        self.out = []           # [(idx, stream_id, ts, row), ...] retained
        self.out_next = 0       # next outbox index to assign
        self.subs = set()       # streams with capture armed (subscribe dedup)


class WorkerServer:
    """The child-process engine shard behind one control socket."""

    def __init__(self, index: int, playback: bool = True, device="cuda"):
        from ..core.manager import SiddhiManager
        self.index = index
        self.playback = playback
        from ..observability.flight_recorder import FlightRecorder
        self.manager = SiddhiManager(device=device)
        self.device = self.manager.device
        if self.device.type == "cuda":
            warm_card(self.device)
        # the shard's own control-plane timeline (deploy/restore/drain):
        # the parent tails it through op_flight and absorbs it into the
        # fabric's ring under the ``h{i}:`` site prefix
        self.flight = FlightRecorder(app_name=f"procmesh-w{index}")
        self.tenants: dict = {}            # tenant_id -> _Tenant
        self.rows_in = 0
        self.escalations: list = []        # SLO mesh_replace decisions
        # trace-journey shipping cursors: (tenant, (origin, trace_id)) ->
        # spans already shipped on an op_flight tail, so re-polls ship only
        # span growth (bounded: evicted oldest-first past the cap)
        from collections import OrderedDict
        self._trace_shipped: "OrderedDict" = OrderedDict()
        self._trace_shipped_cap = 4096
        self.dcn = None                    # optional worker-owned DCNWorker
        # boot identity: a restarted supervisor re-adopts a live worker only
        # if pid AND nonce match its runfile (pid reuse cannot spoof a shard)
        self.nonce = os.urandom(8).hex()
        self.started = time.monotonic()
        # gray-failure chaos hook: when armed (op_wedge or the
        # SIDDHI_PROCMESH_WEDGE_S env at boot), every SUBSTANTIVE op
        # stalls this many seconds BEFORE taking the dispatch lock — so
        # heartbeat pings keep answering while real work times out: the
        # alive-yet-wedged gray failure, as a real process
        try:
            self._wedge_s = float(
                os.environ.get("SIDDHI_PROCMESH_WEDGE_S", 0) or 0)
        except ValueError:
            self._wedge_s = 0.0
        self._lock = threading.RLock()     # all op handling (control rate)
        self._stop = threading.Event()
        self._listener = None
        self._threads: list = []
        self.port = None

    # -- lifecycle -----------------------------------------------------------
    def bind(self, port: int = 0) -> int:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(8)
        srv.settimeout(_ACCEPT_POLL_S)     # accept() re-checks stop
        self._listener = srv
        self.port = srv.getsockname()[1]
        return self.port

    def serve_forever(self) -> None:
        self._listener.settimeout(_ACCEPT_POLL_S)  # accept re-checks stop
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name=f"procmesh-w{self.index}-conn",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._shutdown()

    def _shutdown(self) -> None:
        with self._lock:
            if self.dcn is not None:
                try:
                    self.dcn.close()
                except Exception:   # noqa: BLE001 — exiting anyway
                    pass
                self.dcn = None
            self.manager.shutdown()
            self.tenants.clear()
        try:
            self._listener.close()
        except OSError:
            pass

    # -- serve loop ----------------------------------------------------------
    def _serve(self, conn: socket.socket) -> None:
        conn.settimeout(io_timeout_s())
        try:
            while not self._stop.is_set():
                try:
                    frame = recv_frame(conn, timeout=_ACCEPT_POLL_S)
                except socket.timeout:
                    continue          # idle between frames; re-check stop
                except (OSError, ConnectionError):
                    return
                if frame is None:
                    return
                kind, header, body = frame
                if kind != F_REQ:
                    return            # protocol violation: drop the conn
                op = header.get("op", "")
                try:
                    rh, rbody = self._dispatch(op, header, body)
                    send_frame(conn, F_RES, rh, rbody)
                except Exception as e:   # noqa: BLE001 — one op's failure
                    # is a structured reply, not a dead control plane
                    log.exception("procmesh worker %d: op '%s' failed",
                                  self.index, op)
                    try:
                        send_frame(conn, F_ERR,
                                   {"error": f"{type(e).__name__}: {e}"})
                    except OSError:
                        return
                if op == "stop":
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, op: str, h: dict, body: bytes):
        fn = getattr(self, f"op_{op}", None)
        if fn is None:
            raise ValueError(f"unknown procmesh op '{op}'")
        if self._wedge_s > 0 and op not in ("ping", "wedge", "stop"):
            # stall OUTSIDE the dispatch lock: a wedge that held the lock
            # would also stall pings and read as a plain crash — the whole
            # point is heartbeats stay green while work times out
            time.sleep(self._wedge_s)
        with self._lock:
            return fn(h, body)

    # -- tenant helpers ------------------------------------------------------
    def _tenant(self, h: dict) -> _Tenant:
        t = self.tenants.get(h["tenant"])
        if t is None:
            raise KeyError(f"tenant '{h['tenant']}' not deployed")
        return t

    def _arm_slo_hook(self, rt) -> None:
        """Worker-side half of the fabric's cross-host SLO rung: the
        controller's ``mesh_replace`` decision lands in the escalation
        outbox the supervisor drains with each heartbeat."""
        for b in getattr(rt, "fleet_bridges", []):
            group = b.member.group
            if group is not None and group.slo is not None:
                group.slo.mesh_hook = self._escalate

    def _escalate(self, decision: dict) -> bool:
        self.escalations.append({
            k: v for k, v in decision.items()
            if isinstance(v, (str, int, float, bool, type(None)))})
        return True

    def _prune_out(self, t: _Tenant, ack: int) -> None:
        if ack >= 0 and t.out and t.out[0][0] <= ack:
            t.out = [e for e in t.out if e[0] > ack]

    def _out_tail(self, t: _Tenant, ack: int) -> list:
        self._prune_out(t, ack)
        return [list(e) for e in t.out]

    # -- ops -----------------------------------------------------------------
    def op_ping(self, h: dict, body: bytes):
        esc, self.escalations = self.escalations, []
        return {"pid": os.getpid(),
                "nonce": self.nonce,
                "index": self.index,
                "uptime_s": time.monotonic() - self.started,
                "tenants": len(self.tenants),
                "rows_in": self.rows_in,
                # the shard's wall-clock at reply build: the supervisor
                # estimates this process's clock offset from the request
                # RTT midpoint (refreshed on every adoption/restart)
                "unix_ns": time.time_ns(),
                # receiver-side wire-integrity detections (crc_rejected /
                # dup_frames_dropped): the exactly-once evidence the
                # chaos gauntlet reads back
                "wire": wire_counters(),
                "escalations": esc}, b""

    def op_wedge(self, h: dict, body: bytes):
        """Chaos op: arm (or clear, with 0) the gray-failure stall — every
        subsequent substantive op sleeps ``stall_s`` before dispatch while
        pings keep answering. The bench gauntlet and tests wedge a LIVE
        worker mid-run with this; production never calls it."""
        self._wedge_s = float(h.get("stall_s", 0) or 0)
        self.flight.record("procmesh", "chaos:wedge", f"w{self.index}",
                           detail={"stall_s": self._wedge_s})
        return {"stall_s": self._wedge_s}, b""

    def op_deploy(self, h: dict, body: bytes):
        tid = h["tenant"]
        if tid in self.tenants:
            return {"deployed": False}, b""      # idempotent retry
        rt = self.manager.create_siddhi_app_runtime(
            h["app_text"], playback=h.get("playback", self.playback))
        rt.start()
        self.tenants[tid] = _Tenant(rt)
        self._arm_slo_hook(rt)
        self.flight.record("procmesh", "deploy", f"w{self.index}",
                           detail={"tenant": tid})
        return {"deployed": True}, b""

    def op_undeploy(self, h: dict, body: bytes):
        t = self.tenants.pop(h["tenant"], None)
        if t is not None:
            t.rt.shutdown()
            self.manager.runtimes.pop(h["tenant"], None)
            self.flight.record("procmesh", "undeploy", f"w{self.index}",
                               detail={"tenant": h["tenant"]})
        return {"undeployed": t is not None}, b""

    def op_subscribe(self, h: dict, body: bytes):
        """Arm output capture for one stream: emissions append to the
        tenant's cursored outbox (idempotent per stream)."""
        from ..core.stream import StreamCallback
        t = self._tenant(h)
        sid = h["stream"]
        if sid in t.subs:
            # a restarted parent re-subscribes blindly; a second capture
            # would double-append every emission to the outbox
            return {}, b""
        t.subs.add(sid)

        def capture(evs, t=t, sid=sid):
            for e in evs:
                t.out.append((t.out_next, sid, e.timestamp, list(e.data)))
                t.out_next += 1
        t.rt.add_callback(sid, StreamCallback(capture))
        return {}, b""

    def op_ingest(self, h: dict, body: bytes):
        """Apply one seq-stamped chunk through the dedup mark. The reply
        carries the outbox tail past the client's ``ack`` cursor — dup ops
        (lost-ack retries) re-ship the same events, apply nothing.

        A sampled TraceContext may ride the header (hex-packed). Adoption
        happens ONLY inside the apply branch — the ``K_ROWS`` discipline:
        a lost-ack retry dedups on ``seq`` and never re-adopts, so spans
        stay exactly-once alongside the rows."""
        t = self._tenant(h)
        seq = int(h["seq"])
        applied = False
        if seq > t.applied:
            if h.get("enc") == "soa":
                from ..gpu.dcn import unpack_rows
                rows, tss = unpack_rows(body)
            else:
                rows, tss = h["rows"], h["ts"]
            rows = [list(r) for r in rows]
            tss = list(tss)
            self._apply_traced(t, h, rows, tss)
            t.applied = seq
            self.rows_in += len(rows)
            applied = True
        return {"applied": applied,
                "events": self._out_tail(t, int(h.get("ack", -1)))}, b""

    def _apply_traced(self, t: _Tenant, h: dict, rows: list,
                      tss: list) -> None:
        """Deliver an applied chunk, stitching a trace-context header into
        the tenant tracer's ring: the adopted trace gets a ``procmesh``
        transit span (dispatch wall-clock → apply, so retry delay counts as
        transit) and is ACTIVE while the engine runs, so device/sink spans
        land on the same journey. The transit also records into the
        ``phase.{stream}.procmesh_transit`` histogram — scraped by the
        parent through op_metrics for the federated breakdown."""
        ih = t.rt.input_handler(h["stream"])
        tracer = getattr(t.rt.ctx, "tracer", None)
        ctx_hex = h.get("trace")
        if tracer is None and ctx_hex:
            # the parent fabric samples traces even for tenant apps that
            # carry no @app:trace of their own — install an adopt-only
            # tracer (host=None: it never mints shippable local journeys;
            # the huge sample keeps the untraced send_rows path quiet)
            from ..observability.tracing import PipelineTracer
            tracer = t.rt.ctx.tracer = PipelineTracer(
                sample_n=1 << 20, ring_size=256, host=None)
        if tracer is None or not ctx_hex:
            ih.send_rows(rows, tss)
            return
        from ..observability.tracing import TraceContext
        try:
            ctx = TraceContext.unpack_from(bytes.fromhex(ctx_hex))
        except Exception:   # noqa: BLE001 — a malformed trace header
            ih.send_rows(rows, tss)       # must never drop the rows
            return
        now_unix = time.time_ns()
        transit_ns = max(0, now_unix - ctx.sent_unix_ns)
        tr = tracer.adopt(ctx)
        tr.add_span("procmesh", f"transit:w{self.index}", transit_ns,
                    batch_size=len(rows),
                    start_offset_ns=max(
                        0, ctx.sent_unix_ns - ctx.ingress_unix_ns))
        sm = t.rt.ctx.statistics_manager
        sm.latency_tracker(
            f"phase.{h['stream']}.procmesh_transit").record_seconds(
            transit_ns / 1e9, n=len(rows), exemplar=ctx.trace_id)
        # bypass send_rows' own sampler (it would mint a SIBLING trace and
        # split the journey) — same traced-ingress idiom, adopted trace
        t0 = time.perf_counter_ns()
        tracer.push(tr)
        try:
            ih._send_rows(rows, tss)
        finally:
            tracer.pop()
            tr.add_span("ingress", h["stream"],
                        time.perf_counter_ns() - t0, len(rows))

    def op_resync(self, h: dict, body: bytes):
        """Parent-recovery reconciliation: a restarted supervisor re-adopts
        this LIVE shard without restore. The reply carries the authoritative
        child-side applied mark (>= anything the parent journaled) plus the
        outbox tail past the journaled delivery cursor ``ack`` — entries the
        old parent delivered but never acked re-ship with their original
        indices, so idempotent sinks dedup them byte-exactly."""
        t = self.tenants.get(h["tenant"])
        if t is None:
            return {"present": False}, b""
        return {"present": True, "applied": t.applied,
                "events": self._out_tail(t, int(h.get("ack", -1)))}, b""

    def op_flush(self, h: dict, body: bytes):
        t = self._tenant(h)
        t.rt.flush_host()
        return {"events": self._out_tail(t, int(h.get("ack", -1)))}, b""

    def op_snapshot(self, h: dict, body: bytes):
        t = self._tenant(h)
        return {"applied": t.applied}, t.rt.snapshot()

    def op_restore(self, h: dict, body: bytes):
        """Restore the tenant from parent-store state bytes; the header's
        ``applied`` mark re-seeds the ingest dedup window (re-restore from
        the same revision is idempotent — the ``K_ADOPT`` discipline)."""
        t = self._tenant(h)
        t.rt.restore(body)
        t.applied = int(h.get("applied", 0))
        self._arm_slo_hook(t.rt)
        self.flight.record("procmesh", "restore", f"w{self.index}",
                           detail={"tenant": h["tenant"],
                                   "applied": t.applied})
        return {}, b""

    def op_evidence(self, h: dict, body: bytes):
        return {"evidence": {
            "tenants": len(self.tenants),
            "rows_in": self.rows_in,
            "pid": os.getpid(),
            "wire": wire_counters(),
            "compiled_programs":
                self.manager.fleet.plan_cache.stats()["size"],
            **self.manager.fleet.mesh_evidence(),
        }}, b""

    def op_metrics(self, h: dict, body: bytes):
        """Scrape every deployed runtime's trackers (name-spaced by
        tenant) for parent-side aggregation — the child's families never
        register in the parent's StatisticsManager directly, so a dead
        child can never leak zombie gauges there.

        Beyond the original gauge floats, the reply ships counters and
        FULL latency-histogram states (:meth:`LogHistogram.state` — fixed
        quarter-octave ladder, so the parent merges by summing counts):
        the federation plane's raw material. ``unix_ns`` stamps the scrape
        for parent-side freshness accounting."""
        gauges, counters, latency = {}, {}, {}
        for tid, t in self.tenants.items():
            sm = t.rt.ctx.statistics_manager
            snap = sm.snapshot_trackers()
            for name, tr in snap.get("gauges", {}).items():
                try:
                    gauges[f"{tid}.{name}"] = float(tr.value)
                except Exception:   # noqa: BLE001 — one bad gauge must not
                    continue        # take the scrape down
            for name, tr in snap.get("counters", {}).items():
                try:
                    counters[f"{tid}.{name}"] = int(tr.count)
                except Exception:   # noqa: BLE001
                    continue
            for name, tr in snap.get("latency", {}).items():
                hist = getattr(tr, "hist", None)
                if hist is None:
                    continue
                try:
                    latency[f"{tid}.{name}"] = hist.state()
                except Exception:   # noqa: BLE001
                    continue
        return {"gauges": gauges, "counters": counters,
                "latency": latency, "unix_ns": time.time_ns()}, b""

    def op_flight(self, h: dict, body: bytes):
        """Tail every runtime's flight-recorder ring past ``since_ns`` —
        the parent absorbs the entries into the fabric's ring (forwarding,
        not draining: the child keeps its own ring for local dumps)."""
        since = h.get("since_ns")
        entries = list(self.flight.export(since_ns=since))
        for tid, t in self.tenants.items():
            fl = getattr(t.rt.ctx, "flight", None)
            if fl is None:
                continue
            for e in fl.export(since_ns=since):
                e["tenant"] = tid
                entries.append(e)
        entries.sort(key=lambda e: e["t_ns"])
        return {"entries": entries, "traces": self._trace_tail()}, b""

    def _trace_tail(self) -> list:
        """Adopted-trace journeys that GREW since the last poll: each item
        ships only the new spans past the per-trace cursor, so the parent's
        stitch is append-only (and idempotent regardless — the parent
        dedups by span identity, so an overlap can never double a span)."""
        out = []
        for tid, t in self.tenants.items():
            tracer = getattr(t.rt.ctx, "tracer", None)
            if tracer is None:
                continue
            for key, tr in list(tracer._adopted.items()):
                spans = tr.spans_wire()
                cur = self._trace_shipped.get((tid, key), 0)
                if len(spans) <= cur:
                    continue
                out.append({"origin_host": key[0], "trace_id": key[1],
                            "stream": tr.stream, "tenant": tid,
                            "spans": spans[cur:]})
                self._trace_shipped[(tid, key)] = len(spans)
                self._trace_shipped.move_to_end((tid, key))
        while len(self._trace_shipped) > self._trace_shipped_cap:
            self._trace_shipped.popitem(last=False)
        return out

    def op_boot_dcn(self, h: dict, body: bytes):
        """Boot the worker-owned DCN data plane: a DCNWorker bound to its
        own ephemeral port, every lane group owned by this shard — bulk
        SoA ingest (``ingest_chunk``/``K_ROWS``) lands in the child
        without touching the control socket."""
        if self.dcn is not None:
            return {"port": self.dcn.port}, b""     # idempotent retry
        from ..gpu.dcn import DCNWorker, LaneTopology
        # single-owner topology: this shard owns every lane group (the
        # DCNWorker serves from __init__ — ephemeral port, no peers)
        topo = LaneTopology(int(h["num_lanes"]), 1)
        self.dcn = DCNWorker(
            0, topo, h["app_text"], h["key_attr"], 0, {},
            stream_id=h.get("stream_id", "S"),
            lane_batch=int(h.get("lane_batch", 256)), device=self.device)
        return {"port": self.dcn.port}, b""

    def op_dcn_report(self, h: dict, body: bytes):
        if self.dcn is None:
            return {"report": None}, b""
        return {"report": {"matches": self.dcn.match_count,
                           "port": self.dcn.port}}, b""

    def op_drain(self, h: dict, body: bytes):
        for t in self.tenants.values():
            t.rt.flush_host()
        return {}, b""

    def op_stop(self, h: dict, body: bytes):
        self._stop.set()
        return {}, b""


def warm_card(device) -> None:
    """Open the worker's CUDA context and load every kernel library before
    the handshake (a card the machine lacks raises here). The libraries
    come from the hashed build cache (``gpu/_build.py``): a parent that
    built them before spawning makes this a load."""
    import torch
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    from ..gpu import _build
    _build.build_all(_build.sources())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="procmesh host worker")
    ap.add_argument("--index", type=int, required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--playback", default="1")
    ap.add_argument("--rundir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu, or cuda[:N] (the default; raises without "
                         "a card)")
    args = ap.parse_args(argv)
    # the handshake owns stdout: everything else the process writes there
    # (a library's warning, a build log) goes to stderr instead
    sys.stdout.flush()
    ready = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    # restart-storm test hook: a worker that can never boot exercises the
    # supervisor's backoff/give-up ladder with a real dying process
    if os.environ.get("SIDDHI_PROCMESH_CRASH_ON_BOOT") == "1":
        print("PROCMESH_CRASH", file=ready, flush=True)
        return 3
    srv = WorkerServer(args.index, playback=args.playback == "1",
                       device=args.device)
    port = srv.bind(args.port)
    if args.rundir:
        # the runfile must be durable BEFORE the ready handshake: once the
        # parent proceeds, a parent crash + restart must find this shard
        from .protocol import write_runfile
        write_runfile(args.rundir, args.index, port, os.getpid(), srv.nonce)
    from ..gpu import _build
    hello = {"port": port, "pid": os.getpid(), "nonce": srv.nonce,
             # wall-clock at hello: the supervisor's first (coarse) clock-
             # offset estimate for this shard, refined by ping RTT later
             "unix_ns": time.time_ns(),
             # nvcc seconds per kernel source at boot (0.0: reused from the
             # build cache; empty on the CPU)
             "build_seconds": dict(_build.build_seconds)}
    print(f"PROCMESH_READY {json.dumps(hello)}", file=ready, flush=True)
    ready.close()
    srv.serve_forever()
    if args.rundir:
        # clean stop: a restarted supervisor must not dial a retired shard
        from .protocol import runfile_path
        try:
            os.remove(runfile_path(args.rundir, args.index))
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
