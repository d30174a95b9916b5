"""procmesh supervisor: spawns host workers, heartbeats them, restarts
crashed children, and replays the fabric's recovery path against REAL
SIGKILLed processes.

Each worker is one OS process (``python -m siddhi_tpu_torch.procmesh.worker``)
handshaking its control port over stdout. Liveness detection runs two
signals through the existing resilience machinery:

- ``Popen.poll()`` — the process exited: unambiguous hard evidence, the
  peer detector :meth:`~siddhi_tpu_torch.resilience.dcn_guard.PeerHealth.trip`
  path (no waiting out a failure threshold);
- heartbeat pings over the control socket — a hung-but-running child
  accumulates failures through the same ``PeerHealth``/CircuitBreaker
  ladder the DCN guard uses for peers (healthy → suspect → down).

Restarts pace through :class:`~siddhi_tpu_torch.resilience.circuit.
RestartBackoff` (exponential, windowed give-up budget — a crash loop
becomes a recorded ``decision:give_up``, never a respawn storm). Every
supervisor decision lands on the flight recorder BEFORE the actuation
(``scripts/check_guard_coverage.py`` pins restart/give-up the same way it
pins the rebalancer), and heartbeat replies carry the workers' SLO
``mesh_replace`` escalations back to the fabric — the cross-host rung
works across process boundaries.

The port's copy of the JAX package's ``procmesh/supervisor.py``. Each
worker gets a device (``devices``: ``cpu`` or ``cuda:N``, the card by
default) and is spawned as ``python -m siddhi_tpu_torch.procmesh.worker
--device D`` through ``subprocess.Popen`` (fork plus exec: safe in a
parent that already holds a CUDA context; the child opens its own). A
worker that cannot reach its device fails its handshake, and the
supervisor raises ``WorkerSpawnError`` (the siblings it spawned with it
are killed).
Each handle keeps its boot time (spawn to ``PROCMESH_READY``, ``boot_s``)
and the kernel build seconds its worker reported (``build_seconds``).
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from ..observability.flight_recorder import FlightRecorder
from ..observability.histogram import LogHistogram
from ..resilience.circuit import RestartBackoff
from ..resilience.dcn_guard import PeerHealth
from .host import ProcMeshHost, WorkerClient
from .protocol import (
    READY_TIMEOUT_S,
    WorkerDown,
    WorkerOpError,
    child_env,
    connect,
    read_runfile,
    request,
)

log = logging.getLogger("siddhi_tpu_torch.procmesh")


class WorkerSpawnError(RuntimeError):
    """A child process failed to reach its PROCMESH_READY handshake."""


class SupervisorConfig:
    """Supervisor knobs (kwargs-style; everything has a default)."""

    def __init__(self, heartbeat_interval_s: float = 0.5,
                 failure_threshold: int = 2,
                 down_cooldown_s: float = 0.5,
                 ready_timeout_s: float = READY_TIMEOUT_S,
                 restart_base_s: float = 0.25,
                 restart_max_s: float = 8.0,
                 restart_window_s: float = 60.0,
                 restart_max: int = 5,
                 auto_restart: bool = True,
                 env: Optional[dict] = None,
                 run_dir: Optional[str] = None,
                 io_timeout_s: Optional[float] = None,
                 connect_timeout_s: Optional[float] = None,
                 hedge_fraction: Optional[float] = 0.45,
                 wedge_threshold: int = 3,
                 degrade_factor: float = 4.0,
                 degrade_floor_s: float = 0.05,
                 degrade_min_samples: int = 16):
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.failure_threshold = int(failure_threshold)
        self.down_cooldown_s = float(down_cooldown_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self.restart_base_s = float(restart_base_s)
        self.restart_max_s = float(restart_max_s)
        self.restart_window_s = float(restart_window_s)
        self.restart_max = int(restart_max)
        self.auto_restart = bool(auto_restart)
        self.env = dict(env or {})
        # workers persist runfiles here at handshake; a restarted
        # supervisor scans them to re-adopt live shards (parent recovery)
        self.run_dir = run_dir
        # gray-failure surface: base control-op deadline
        # (None = SIDDHI_PROCMESH_IO_TIMEOUT_S env or the module default),
        # the hedge fraction for idempotent ops (None disables hedging),
        # and the latency-evidence ladder knobs — wedge_threshold
        # consecutive substantive-op timeouts while heartbeats succeed ⇒
        # *wedged*; a windowed op p99 above degrade_factor × the fleet
        # median (and above degrade_floor_s, with degrade_min_samples in
        # the window) ⇒ *degraded*. degrade_factor <= 0 disables the rung.
        self.io_timeout_s = io_timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.hedge_fraction = hedge_fraction
        self.wedge_threshold = int(wedge_threshold)
        self.degrade_factor = float(degrade_factor)
        self.degrade_floor_s = float(degrade_floor_s)
        self.degrade_min_samples = int(degrade_min_samples)


class ProcWorkerHandle:
    """Supervisor-side state of one child: the process, its live control
    port, the peer-health detector, and the restart budget."""

    def __init__(self, index: int, cfg: SupervisorConfig):
        self.index = index
        self.cfg = cfg
        self.device = "cuda"            # the worker's engine device
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.pid: Optional[int] = None
        self.nonce: Optional[str] = None
        # re-adopted across a parent restart: not our Popen child — liveness
        # and kills go through os.kill on the runfile pid instead
        self.adopted = False
        self.restarts = 0
        self.kills = 0
        self.gave_up = False
        self.health = PeerHealth(cfg.failure_threshold,
                                 cfg.down_cooldown_s)
        self.backoff = RestartBackoff(cfg.restart_base_s, cfg.restart_max_s,
                                      cfg.restart_window_s, cfg.restart_max)
        self.client = WorkerClient(lambda: self.port,
                                   io_timeout_s=cfg.io_timeout_s,
                                   connect_timeout_s=cfg.connect_timeout_s,
                                   hedge_fraction=cfg.hedge_fraction,
                                   observer=self.note_op)
        # latency EVIDENCE: every control op the fabric sends
        # through this handle's client lands in a per-op LogHistogram;
        # heartbeat RTTs get their own (a 1.9s heartbeat is no longer the
        # same evidence as a 1ms one). op_timeouts counts CONSECUTIVE
        # substantive-op failures — the wedge detector's input.
        self.hb_hist = LogHistogram()
        self.op_hist: dict = {}
        self.op_lat = LogHistogram()    # all non-ping ops merged
        self.lat_chk = None             # windowed-p99 cursor (degrade rung)
        self.op_timeouts = 0
        self.flight_cursor = 0          # child flight-ring tail (since_ns)
        # estimated wall-clock LEAD of the child over this process
        # (child_unix_ns - parent_unix_ns), from the ready hello and
        # refined by ping RTT midpoints — the federation layer uses it to
        # causally order merged flight timelines and stitched trace spans
        self.clock_offset_ns = 0
        self.spawned_at: Optional[float] = None   # monotonic, at Popen
        self.boot_s: Optional[float] = None       # spawn → READY, last boot
        self.build_seconds: dict = {}             # the worker's hello

    def note_op(self, op: str, seconds: float, ok: bool) -> None:
        """WorkerClient observer: one record per user-level call, with the
        final outcome. A failed op still records the budget it burned —
        a timed-out op IS tail-latency evidence."""
        if op == "ping":
            return                  # heartbeats have their own histogram
        hist = self.op_hist.get(op)
        if hist is None:
            hist = self.op_hist[op] = LogHistogram()
        hist.record(seconds)
        self.op_lat.record(seconds)
        self.op_timeouts = 0 if ok else self.op_timeouts + 1

    @property
    def alive(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is None
        if self.adopted and self.pid:
            try:
                os.kill(self.pid, 0)
                return True
            except OSError:
                return False
        return False

    def kill(self) -> None:
        """REAL SIGKILL — the chaos sites the in-process fabric simulates
        become an actual dead process here."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.kills += 1
            # the signal lands asynchronously: reap the child here, so that
            # ``alive`` reads False once kill returns (a worker on its way
            # out by itself, torch still shutting down, would otherwise poll
            # as running after the supervisor gave up on it)
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
        elif self.adopted and self.pid:
            try:
                os.kill(self.pid, signal.SIGKILL)
                self.kills += 1
            except OSError:
                pass                    # already gone
        self.port = None
        self.client.drop()
        self.health.trip()

    def reap(self, timeout: float = 5.0) -> None:
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=timeout)
        elif self.adopted and self.pid:
            # not our child: init reaps the orphan — poll until it is gone
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                try:
                    os.kill(self.pid, 0)
                except OSError:
                    return
                time.sleep(0.05)


class ProcMeshSupervisor:
    """Spawns and shepherds one worker process per mesh host."""

    def __init__(self, num_workers: int,
                 config: Optional[SupervisorConfig] = None,
                 flight: Optional[FlightRecorder] = None,
                 playback: bool = True,
                 journal=None,
                 worker_state: Optional[dict] = None,
                 devices: Optional[list] = None):
        self.cfg = config or SupervisorConfig()
        self.flight = flight or FlightRecorder(app_name="procmesh")
        self.playback = playback
        # durable control plane (parent recovery): restart/give-up
        # decisions journal BEFORE they actuate, so a restarted parent
        # re-seeds each worker's give-up budget instead of resetting it
        self.journal = journal
        self.handles = {i: ProcWorkerHandle(i, self.cfg)
                        for i in range(num_workers)}
        for i, dev in enumerate(devices or ()):
            if i in self.handles:
                self.handles[i].device = str(dev)
        # fabric wiring: death/recovery callbacks + the SLO escalation
        # relay (heartbeat replies carry worker-side mesh_replace asks)
        self.on_failed: Optional[Callable[[int], None]] = None
        self.on_restarted: Optional[Callable[[int], None]] = None
        self.on_gave_up: Optional[Callable[[int], None]] = None
        self.on_escalation: Optional[Callable[[dict], None]] = None
        # gray-failure actuator wiring: the fabric drains a
        # degraded worker's tenants away / re-admits a recovered one
        self.on_degraded: Optional[Callable[[int], None]] = None
        self.on_undegraded: Optional[Callable[[int], None]] = None
        self._sm = None
        self._stop = threading.Event()
        self._monitor = None
        self._lock = threading.RLock()
        for h in self.handles.values():
            st = (worker_state or {}).get(h.index) \
                or (worker_state or {}).get(str(h.index))
            if st:
                h.restarts = int(st.get("restarts", 0))
                h.backoff.seed_attempt_ages(st.get("attempt_ages_s", ()))
                if st.get("gave_up"):
                    h.gave_up = True
        # adopt-or-spawn: a live shard from a previous parent incarnation
        # (runfile pid+nonce verified over its control socket) is re-adopted
        # in place; everything else forks fresh. Fork everything first, then
        # collect handshakes (boot cost is import-dominated; overlapping
        # hides it).
        spawned = []
        for h in self.handles.values():
            if h.gave_up:
                continue                # the budget died with the old parent
            if self.cfg.run_dir and self._adopt(h):
                continue
            self._spawn(h)
            spawned.append(h)
        try:
            for h in spawned:
                self._await_ready(h)
        except WorkerSpawnError:
            # one child failed its boot (a missing card fails every one):
            # the siblings already spawned go with it, no orphans
            for h in spawned:
                h.kill()
                h.reap()
            raise

    # -- spawning ------------------------------------------------------------
    def _spawn(self, h: ProcWorkerHandle) -> None:
        env = child_env()
        env["SIDDHI_PROCMESH_CHILD"] = "1"      # no recursive pools
        env.update(self.cfg.env)
        cmd = [sys.executable, "-m", "siddhi_tpu_torch.procmesh.worker",
               "--index", str(h.index),
               "--playback", "1" if self.playback else "0",
               "--device", h.device]
        if self.cfg.run_dir:
            cmd += ["--rundir", self.cfg.run_dir]
        h.spawned_at = time.monotonic()
        h.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=None, env=env)
        h.adopted = False
        h.pid = h.proc.pid
        h.port = None

    def _adopt(self, h: ProcWorkerHandle) -> bool:
        """Try to re-adopt a live worker left behind by a dead parent: dial
        the runfile's port and verify the shard's identity (pid AND boot
        nonce — a reused port or pid cannot spoof it). No restore, no
        respawn: the shard keeps its engine state and outbox."""
        rf = read_runfile(self.cfg.run_dir, h.index)
        if rf is None:
            return False
        try:
            sock = connect(int(rf["port"]))
            try:
                rh, _ = request(sock, "ping")
            finally:
                sock.close()
        except (WorkerDown, WorkerOpError, OSError):
            return False
        if (rh.get("pid") != rf.get("pid")
                or rh.get("nonce") != rf.get("nonce")
                or rh.get("index") != h.index):
            return False
        h.proc = None
        h.clock_offset_ns = 0           # refreshed below over the client
        h.adopted = True
        h.port = int(rf["port"])
        h.pid = int(rf["pid"])
        h.nonce = rf.get("nonce")
        h.health.record_success()
        self._refresh_clock(h)          # re-adoption refreshes the offset
        self.flight.record("procmesh", "worker_readopt",
                           site=f"worker:{h.index}",
                           detail={"pid": h.pid, "port": h.port,
                                   "clock_offset_ns": h.clock_offset_ns})
        return True

    def _refresh_clock(self, h: ProcWorkerHandle) -> None:
        """RTT-midpoint clock-offset estimate over one ping: the child's
        reply stamp minus the midpoint of our send/receive wall-clocks.
        Loopback RTTs are sub-millisecond, so the estimate's error bar is
        RTT/2 — documented in DISTRIBUTED.md as the causal-ordering
        caveat. Best-effort: a failed ping keeps the previous estimate."""
        try:
            t0 = time.time_ns()
            rh, _ = h.client.call("ping", timeout=5.0)
            t1 = time.time_ns()
        except WorkerDown:
            return
        child_ns = rh.get("unix_ns")
        if child_ns is not None:
            h.clock_offset_ns = int(child_ns) - (t0 + t1) // 2

    def _await_ready(self, h: ProcWorkerHandle) -> None:
        import json as _json
        line_box: list = []

        def read_line():
            line_box.append(h.proc.stdout.readline())

        t = threading.Thread(target=read_line, daemon=True)
        t.start()
        t.join(self.cfg.ready_timeout_s)
        line = line_box[0].decode() if line_box else ""
        if not line.startswith("PROCMESH_READY"):
            rc = h.proc.poll()
            h.kill()
            raise WorkerSpawnError(
                f"worker {h.index} never reached READY "
                f"(rc={rc}, line={line!r})")
        hello = _json.loads(line.split(None, 1)[1])
        h.boot_s = time.monotonic() - h.spawned_at
        h.build_seconds = dict(hello.get("build_seconds") or {})
        h.port = int(hello["port"])
        h.pid = int(hello["pid"])
        h.nonce = hello.get("nonce")
        if hello.get("unix_ns") is not None:
            # coarse handshake estimate (biased by the stdout read delay);
            # the RTT-midpoint refresh below tightens it
            h.clock_offset_ns = int(hello["unix_ns"]) - time.time_ns()
        h.health.record_success()
        self._refresh_clock(h)

    # -- fabric host construction -------------------------------------------
    def host(self, index: int, capacity: int,
             device: Optional[int] = None) -> ProcMeshHost:
        return ProcMeshHost(self.handles[index], capacity, device=device,
                            playback=self.playback)

    # -- liveness / restart --------------------------------------------------
    def start_monitor(self) -> None:
        if self._monitor is not None:
            return
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="procmesh-supervisor",
            daemon=True)
        self._monitor.start()

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            for h in list(self.handles.values()):
                if self._stop.is_set():
                    return
                if h.gave_up:
                    continue
                try:
                    self._check(h)
                except Exception:   # noqa: BLE001 — one worker's turmoil
                    # must never take the monitor down
                    log.exception("procmesh: monitor check of worker %d "
                                  "failed", h.index)
            try:
                self._evaluate_degrade()
            except Exception:       # noqa: BLE001
                log.exception("procmesh: degrade evaluation failed")
            self._stop.wait(self.cfg.heartbeat_interval_s)

    def _check(self, h: ProcWorkerHandle) -> None:
        if not h.alive:
            self._on_death(h, cause="exit")
            return
        if not h.health.allow_probe():
            return
        try:
            t0 = time.time_ns()
            rh, _ = h.client.call("ping", timeout=self.cfg.down_cooldown_s
                                  + self.cfg.heartbeat_interval_s)
            t1 = time.time_ns()
        except WorkerDown:
            h.health.record_failure()
            if h.health.state == "down":
                self._on_death(h, cause="heartbeat")
            return
        h.health.record_success()
        rtt_s = (t1 - t0) / 1e9
        h.hb_hist.record(rtt_s)         # RTT is health EVIDENCE, not a bool
        if self._sm is not None:
            self._sm.latency_tracker(
                f"procmesh.w{h.index}.heartbeat").record_seconds(rtt_s)
        if rh.get("unix_ns") is not None:
            # every heartbeat refreshes the RTT-midpoint offset estimate
            h.clock_offset_ns = int(rh["unix_ns"]) - (t0 + t1) // 2
        if rh.get("uptime_s", 0) > self.cfg.restart_window_s:
            h.backoff.note_stable()     # a stable child earns its budget back
        for decision in rh.get("escalations", ()):
            if self.on_escalation is not None:
                self.on_escalation(decision)
        if (h.op_timeouts >= self.cfg.wedge_threshold
                and not h.health.wedged):
            # the gray signature: THIS heartbeat just succeeded while
            # substantive ops keep timing out — the worker is wedged
            self._on_wedged(h)

    def _on_wedged(self, h: ProcWorkerHandle) -> None:
        """Classify a heartbeat-OK-but-ops-timing-out worker as *wedged*
        and treat it as down (kill + backoff-paced restart). EVIDENCE
        FIRST: the classification, with the op-latency tails that earned
        it, is on the ring before the worker is condemned."""
        with self._lock:
            if h.gave_up or h.health.wedged:
                return
            self.flight.record(
                "procmesh", "decision:worker_wedged",
                site=f"worker:{h.index}",
                detail={"op_timeouts": h.op_timeouts,
                        "heartbeat_p99_s": h.hb_hist.percentile(0.99),
                        "op_p99_s": {op: hs.percentile(0.99)
                                     for op, hs in h.op_hist.items()}})
            h.health.mark_wedged()
        self._on_death(h, cause="wedged")

    def _evaluate_degrade(self) -> None:
        """Fleet-relative tail-outlier detection: each sweep closes one
        window over every worker's merged op histogram; a worker whose
        windowed p99 exceeds ``degrade_factor`` × the median of its PEERS'
        p99s (above an absolute floor) goes *degraded* and the fabric
        drains it. Recovery (half the trip threshold — hysteresis) clears
        the rung and re-admits the worker for placement."""
        cfg = self.cfg
        if cfg.degrade_factor <= 0:
            return
        wins = {}
        for h in self.handles.values():
            if h.gave_up or h.health.wedged or not h.alive:
                continue
            chk, h.lat_chk = h.lat_chk, h.op_lat.checkpoint()
            if chk is None:
                continue
            win = h.op_lat.since(chk)
            if win["count"] >= cfg.degrade_min_samples:
                wins[h.index] = win
        for idx, win in wins.items():
            others = sorted(w["p99"] for j, w in wins.items() if j != idx)
            if not others:
                continue            # fleet-relative needs a fleet
            med = others[len(others) // 2]
            trip = max(cfg.degrade_floor_s, cfg.degrade_factor * med)
            h = self.handles[idx]
            if win["p99"] > trip and not h.health.degraded:
                with self._lock:
                    if h.health.degraded:
                        continue
                    self.flight.record(
                        "procmesh", "decision:worker_degraded",
                        site=f"worker:{idx}",
                        detail={"p99_s": win["p99"],
                                "peer_median_p99_s": med,
                                "window_count": win["count"],
                                "factor": cfg.degrade_factor})
                    h.health.mark_degraded()
                if self.on_degraded is not None:
                    self.on_degraded(idx)
            elif h.health.degraded and win["p99"] <= trip / 2.0:
                with self._lock:
                    self.flight.record(
                        "procmesh", "worker_undegraded",
                        site=f"worker:{idx}",
                        detail={"p99_s": win["p99"],
                                "peer_median_p99_s": med})
                    h.health.clear_degraded()
                if self.on_undegraded is not None:
                    self.on_undegraded(idx)

    def _on_death(self, h: ProcWorkerHandle, cause: str) -> None:
        with self._lock:
            if h.gave_up:
                return
            # EVIDENCE FIRST: the failure is on the ring before any
            # teardown or restart moves state
            self.flight.record(
                "procmesh", "worker_down", site=f"worker:{h.index}",
                detail={"cause": cause, "pid": h.pid,
                        "rc": h.proc.poll() if h.proc else None})
            h.health.trip()
            h.port = None
            h.client.drop()
            if self.on_failed is not None:
                self.on_failed(h.index)
            if self.cfg.auto_restart:
                self.restart(h.index)

    def restart(self, index: int) -> bool:
        """Backoff-paced restart of one worker. The decision (with its
        delay and budget evidence) hits the ring BEFORE the spawn; a
        spent budget records ``decision:give_up`` instead and the worker
        stays down for an operator."""
        h = self.handles[index]
        with self._lock:
            delay = h.backoff.next_delay()
            if delay is None:
                self.flight.record(
                    "procmesh", "decision:give_up",
                    site=f"worker:{index}",
                    detail={"restarts": h.restarts,
                            **h.backoff.report()})
                self._journal("worker_gave_up", worker=index,
                              restarts=h.restarts)
                h.gave_up = True
                if self._sm is not None:
                    # a permanently-down worker's families go with it —
                    # no zombie gauges behind a give-up
                    self._sm.unregister(f"procmesh.w{index}.")
                if self.on_gave_up is not None:
                    self.on_gave_up(index)
                return False
            self.flight.record(
                "procmesh", "decision:restart_worker",
                site=f"worker:{index}",
                detail={"delay_s": delay, "restarts": h.restarts,
                        **h.backoff.report()})
            # journal the consumed attempt BEFORE the spawn: a parent
            # crash mid-restart must not refund the give-up budget
            self._journal("worker_restart", worker=index,
                          attempt_ages_s=h.backoff.attempt_ages_s())
            if delay:
                self._stop.wait(delay)
            h.kill()                    # no half-dead twins
            h.reap()
            # the respawn starts with a clean gray slate: the evidence
            # that condemned the old incarnation must not condemn the new
            h.health.clear_wedged()
            h.health.clear_degraded()
            h.op_timeouts = 0
            self._spawn(h)
            try:
                self._await_ready(h)
            except WorkerSpawnError:
                log.warning("procmesh: worker %d respawn failed", index)
                return self.restart(index)      # burn budget, maybe give up
            h.restarts += 1
            h.client.drop()
            if self.on_restarted is not None:
                self.on_restarted(index)
            return True

    def _journal(self, kind: str, **fields) -> None:
        if self.journal is not None:
            self.journal.append(kind, **fields)

    def worker_state(self) -> dict:
        """Journal-checkpoint form of the fleet's restart ledger."""
        return {h.index: {"restarts": h.restarts, "gave_up": h.gave_up,
                          "attempt_ages_s": h.backoff.attempt_ages_s()}
                for h in self.handles.values()}

    def kill_worker(self, index: int) -> Optional[int]:
        """Operator/chaos SIGKILL (recorded): returns the killed pid. The
        monitor (or an explicit :meth:`restart`) drives recovery."""
        h = self.handles[index]
        pid = h.pid
        self.flight.record("procmesh", "decision:kill_worker",
                           site=f"worker:{index}", detail={"pid": pid})
        h.kill()
        return pid

    # -- observability -------------------------------------------------------
    def register_metrics(self, sm) -> None:
        """``procmesh.w{i}.*`` + ``procmesh.self.*`` families; worker
        stop/give-up and supervisor shutdown unregister their prefixes
        (tests/test_metrics.py pins the teardown)."""
        self._sm = sm
        for h in self.handles.values():
            i = h.index
            sm.gauge_tracker(f"procmesh.w{i}.alive",
                             lambda h=h: 1 if h.alive else 0)
            sm.gauge_tracker(f"procmesh.w{i}.pid",
                             lambda h=h: h.pid or 0)
            sm.gauge_tracker(f"procmesh.w{i}.restarts_total",
                             lambda h=h: h.restarts)
            sm.gauge_tracker(f"procmesh.w{i}.kills_total",
                             lambda h=h: h.kills)
            sm.gauge_tracker(f"procmesh.w{i}.peer_state_code",
                             lambda h=h: h.health.state_code)
            sm.gauge_tracker(f"procmesh.w{i}.downtime_s",
                             lambda h=h: h.health.downtime_s())
            sm.gauge_tracker(f"procmesh.w{i}.last_downtime_s",
                             lambda h=h: h.health.last_downtime_s)
            sm.gauge_tracker(f"procmesh.w{i}.clock_offset_ns",
                             lambda h=h: h.clock_offset_ns)
            sm.gauge_tracker(f"procmesh.w{i}.op_timeouts",
                             lambda h=h: h.op_timeouts)
            sm.gauge_tracker(f"procmesh.w{i}.wedges_total",
                             lambda h=h: h.health.wedge_count)
            sm.gauge_tracker(f"procmesh.w{i}.degrades_total",
                             lambda h=h: h.health.degrade_count)
            sm.gauge_tracker(f"procmesh.w{i}.hedge_attempts_total",
                             lambda h=h: h.client.hedge_attempts)
            sm.gauge_tracker(f"procmesh.w{i}.hedge_wins_total",
                             lambda h=h: h.client.hedge_wins)
            # heartbeat RTT as a real histogram family —
            # siddhi_tpu_procmesh_heartbeat_seconds{worker="w{i}"};
            # _check records into it on every successful ping
            sm.latency_tracker(f"procmesh.w{i}.heartbeat")
        sm.gauge_tracker("procmesh.self.workers",
                         lambda: sum(1 for h in self.handles.values()
                                     if h.alive))
        sm.gauge_tracker("procmesh.self.restarts_total",
                         lambda: sum(h.restarts
                                     for h in self.handles.values()))
        sm.gauge_tracker("procmesh.self.gave_up",
                         lambda: sum(1 for h in self.handles.values()
                                     if h.gave_up))

    def report(self) -> dict:
        return {"workers": {
            h.index: {"alive": h.alive, "pid": h.pid, "port": h.port,
                      "restarts": h.restarts, "kills": h.kills,
                      "gave_up": h.gave_up, "adopted": h.adopted,
                      "device": h.device, "boot_s": h.boot_s,
                      "build_seconds": dict(h.build_seconds),
                      "op_timeouts": h.op_timeouts,
                      "heartbeat": h.hb_hist.snapshot(),
                      "op_p99_s": {op: hs.percentile(0.99)
                                   for op, hs in h.op_hist.items()},
                      "hedge_attempts": h.client.hedge_attempts,
                      "hedge_wins": h.client.hedge_wins,
                      **h.health.report()}
            for h in self.handles.values()}}

    # -- teardown ------------------------------------------------------------
    def shutdown(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        for h in self.handles.values():
            try:
                h.client.call("stop", timeout=2.0)
            except WorkerDown:
                pass
            h.client.drop()
        for h in self.handles.values():
            if h.proc is not None and h.proc.poll() is None:
                h.proc.terminate()
            elif h.adopted:
                # give the stop op a moment to land (the shard removes its
                # runfile on a clean exit) before escalating to SIGKILL
                deadline = time.monotonic() + 2.0
                while h.alive and time.monotonic() < deadline:
                    time.sleep(0.05)
                if h.alive:
                    h.kill()
        for h in self.handles.values():
            h.reap()
        if self._sm is not None:
            self._sm.unregister("procmesh.")
            self._sm = None
