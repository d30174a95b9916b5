"""MeshFabric: the placement & live-migration layer fusing fleet lanes
with DCN lane-groups.

The fleet tier is the single-host tenant fleet (shared compilation, lane
batching, blast-radius isolation, the SLO autopilot) and the DCN tier
multi-host lane-group failover — but neither composes them: a tenant runs
wherever its app happens to deploy. The fabric closes that gap:

- **hosts** — each :class:`MeshHost` is one engine shard: its own
  ``SiddhiManager`` (so its own FleetManager → its own plan cache → the
  compiled-programs-per-host number placement minimizes) bound to one
  accelerator device of the mesh;
- **placement** — a :class:`~siddhi_tpu_torch.mesh.plan.PlacementPolicy` assigns
  every tenant a ``(host, lane-group, device)`` slot, locality-aware by
  shape fingerprint with capacity scoring fed by ``fleet.*``/``slo.*``
  evidence and the flight recorder (``plan.py``);
- **ingress routing** — :meth:`send` routes per-tenant row chunks to the
  owning host with per-tenant ``(epoch, seq)`` stamps and a monotone
  applied-mark — the receiver-side dedup that makes retries, migration
  replays and kill-recovery exactly-once (the ``K_ROWS`` discipline of
  ``gpu/dcn.py``, applied to tenants instead of lane groups);
- **live migration** — :meth:`migrate` moves a tenant between hosts under
  sustained ingest: fresh chunks spill (bounded, in order — the
  :class:`~siddhi_tpu_torch.resilience.dcn_guard.SpillQueue`), the source host
  flushes + snapshots the tenant (the per-tenant snapshot/restore,
  carried as whole-app state bytes), the revision lands in the
  :class:`~siddhi_tpu_torch.resilience.dcn_guard.LaneGroupSnapshotStore` (keyed
  by the tenant's global id, dedup mark inside — durable before the
  hand-off, exactly like a lane-group takeover), the target host restores
  and ACKs the adoption (lost acks retry, the ``K_ADOPT`` discipline),
  ownership re-points, and the spill replays in order through the same
  dedup'd apply path. Zero loss, zero duplication, per-tenant oracle
  byte-identical — pinned by tests/test_mesh.py under chaos;
- **elasticity** — :meth:`add_host` / :meth:`remove_host` recompute the
  plan (sticky: surviving slots keep their tenants) and apply the diff as
  bulk migrations; :meth:`kill_host` + :meth:`recover_tenant` are the
  crash path (restore from the latest revision + spill replay — with
  ``snapshot_every_chunks=1`` an applied chunk is durable before its send
  returns, the ``snapshot_every_frames=1`` DCN contract);
- **the cross-host SLO rung** — an armed group's
  :class:`~siddhi_tpu_torch.observability.slo.SLOController` gets a
  ``mesh_hook``: when its in-process ladder is exhausted it decides
  ``mesh_replace`` (recorded with evidence BEFORE dispatch, like every
  actuator) and the fabric re-places the violating tenant on the
  least-loaded host — the autopilot's cross-host actuator.

Every fabric decision path records to the flight recorder(s) BEFORE
actuating (``scripts/check_guard_coverage.py`` pins it for the rebalancer
the same way it pins the SLO controller).

**Order caveat**: a migration inserts a flush boundary, and the fleet
tier's NFA match ORDER is flush-cadence-dependent (a pre-existing
property of every flush — adaptive resize, SLO shrink, drain). The match
MULTISET is exact (zero loss, zero duplication, pinned); stateless
shapes are byte-identical including order.

**Dictionary caveat** (the DCN layer's "codes do not cross hosts" rule,
inherited): a migrated tenant's state restores its string-dictionary
tables monotonically into the destination group
(:func:`~siddhi_tpu_torch.fleet.group.restore_dicts_monotonic`). Destination
tables that EXTEND or match the snapshot's restore exactly; a conflicting
generation (same values minted in a different order on the target host)
keeps the live table and logs loudly — co-locate same-shape tenants over
one multiplexed feed (the locality policy's job) and the tables agree.

**The port's copy** of the JAX package's ``mesh/fabric.py``. Every host's
``SiddhiManager`` runs on the fabric's ``device``: by default the card,
host ``i`` on ``cuda:(i mod device_count())`` (no card raises, as every
entry point of the port does, and never falls back); ``device="cpu"``
builds every host on the CPU (the kernels' plain versions). In
``MeshConfig(mode='process')`` each host is a worker process
(``procmesh/``) whose engine runs on that same device: the supervisor
spawns worker ``i`` with ``--device cuda:(i mod device_count())`` or the
fabric's ``device``. A tenant moves between hosts as its app snapshot,
whose device state is numpy, restored onto the destination host's
device.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from ..observability.flight_recorder import FlightRecorder
from ..resilience.dcn_guard import LaneGroupSnapshotStore, SpillQueue
from .plan import HostSlot, MeshPlan, PlacementPolicy, TenantSpec, \
    shape_fingerprint

log = logging.getLogger("siddhi_tpu_torch.mesh")

_DEF_CAPACITY = 256            # tenant slots per host
_DEF_SPILL_FRAMES = 4096
_ADOPT_RETRY_MAX = 3


class MeshChaosFault(Exception):
    """Raised by an armed chaos hook at a named fabric site."""


class MeshConfig:
    """Fabric knobs (kwargs-style; everything has a default)."""

    def __init__(self, capacity_per_host: int = _DEF_CAPACITY,
                 policy: str = "locality", seed: int = 17,
                 snapshot_every_chunks: Optional[int] = None,
                 spill_capacity_frames: int = _DEF_SPILL_FRAMES,
                 spill_policy: str = "block",
                 adopt_retry_max: int = _ADOPT_RETRY_MAX,
                 playback: bool = True,
                 mode: str = "inproc",
                 heartbeat_interval_s: float = 0.5,
                 worker_failure_threshold: int = 2,
                 restart_max: int = 5,
                 restart_base_s: float = 0.25,
                 restart_window_s: float = 60.0,
                 auto_restart: bool = True,
                 worker_env: Optional[dict] = None,
                 durable: bool = False,
                 journal_fsync: bool = False,
                 journal_checkpoint_every: int = 256,
                 trace_sample: Optional[int] = None,
                 trace_ring: int = 2048,
                 metrics_stale_after_s: float = 10.0,
                 io_timeout_s: Optional[float] = None,
                 connect_timeout_s: Optional[float] = None,
                 hedge_fraction: float = 0.45,
                 wedge_threshold: int = 3,
                 degrade_factor: float = 4.0,
                 degrade_floor_s: float = 0.05,
                 degrade_min_samples: int = 16,
                 drain_on_degrade: bool = True):
        if mode not in ("inproc", "process"):
            raise ValueError(f"mesh mode '{mode}' is not inproc|process")
        if durable and mode != "process":
            raise ValueError("durable=True requires mode='process' (the "
                             "fabric journal recovers real worker processes)")
        if trace_sample is not None and int(trace_sample) < 1:
            raise ValueError(f"bad trace_sample {trace_sample} (need >= 1)")
        self.capacity_per_host = int(capacity_per_host)
        self.policy = policy
        self.seed = seed
        # mode='process': every host is its OWN OS process (procmesh) —
        # same fabric ladder, dispatched over the control socket
        self.mode = mode
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.worker_failure_threshold = int(worker_failure_threshold)
        self.restart_max = int(restart_max)
        self.restart_base_s = float(restart_base_s)
        self.restart_window_s = float(restart_window_s)
        self.auto_restart = bool(auto_restart)
        self.worker_env = dict(worker_env or {})
        # None = snapshot only at migration/shutdown; N = persist the
        # tenant after every N applied chunks BEFORE the send returns (the
        # DCN snapshot_every_frames durability cadence: at 1, kill-recovery
        # is exactly-once; at None the loss bound is the chunks since the
        # last revision)
        self.snapshot_every_chunks = snapshot_every_chunks
        self.spill_capacity_frames = int(spill_capacity_frames)
        self.spill_policy = spill_policy
        self.adopt_retry_max = int(adopt_retry_max)
        self.playback = playback
        # durable control plane: every fabric mutation journals its intent
        # BEFORE actuating, so a SIGKILLed PARENT recovers — live workers
        # re-adopt without restore, dead ones restore from snapshots
        self.durable = bool(durable)
        self.journal_fsync = bool(journal_fsync)
        self.journal_checkpoint_every = int(journal_checkpoint_every)
        # cross-process trace stitching: 1-in-N ingress sampling on the
        # fabric's send path; sampled contexts ride the ingest op header
        # and the child's journey ships back on the flight tail. None =
        # tracing off (the default — sampling costs one counter per send)
        self.trace_sample = (int(trace_sample)
                             if trace_sample is not None else None)
        self.trace_ring = int(trace_ring)
        # federation freshness ceiling: a worker whose last good scrape is
        # older than this renders NO federated families (zombie expiry)
        self.metrics_stale_after_s = float(metrics_stale_after_s)
        # gray-failure surface (process mode): control-socket deadline base
        # (None = protocol default / SIDDHI_PROCMESH_IO_TIMEOUT_S env),
        # hedged-retry trigger fraction for idempotent ops, and the
        # latency-evidence ladder — N consecutive op timeouts while
        # heartbeats stay green = wedged (treated as down), a windowed op
        # p99 above degrade_factor x the fleet-median p99 (floored at
        # degrade_floor_s) = degraded, which drains the host's tenants
        # away when drain_on_degrade is set
        self.io_timeout_s = (float(io_timeout_s)
                             if io_timeout_s is not None else None)
        self.connect_timeout_s = (float(connect_timeout_s)
                                  if connect_timeout_s is not None else None)
        self.hedge_fraction = float(hedge_fraction)
        self.wedge_threshold = int(wedge_threshold)
        self.degrade_factor = float(degrade_factor)
        self.degrade_floor_s = float(degrade_floor_s)
        self.degrade_min_samples = int(degrade_min_samples)
        self.drain_on_degrade = bool(drain_on_degrade)


class MeshHost:
    """One engine shard of the mesh: an isolated ``SiddhiManager`` (own
    FleetManager → own shared-plan cache) bound to one device ordinal.
    ``engine_device`` is the manager's device (``SiddhiManager(device=)``:
    ``None`` is the card and raises without one); ``device`` the ordinal
    the plan records."""

    def __init__(self, index: int, capacity: int,
                 device: Optional[int] = None, playback: bool = True,
                 engine_device=None):
        from ..core.manager import SiddhiManager
        self.index = index
        self.capacity = capacity
        self.device = device
        self.playback = playback
        self.manager = SiddhiManager(device=engine_device)
        self.runtimes: dict = {}        # tenant_id -> app runtime
        self.rows_in = 0                # routed rows (load evidence)
        self.reserved = 0               # in-flight adoption slots (capacity
        # admission is check-then-deploy; the reservation closes the race
        # between concurrent movers targeting the same destination)
        self.alive = True
        self.draining = False           # degrade drain: no NEW placements

    @property
    def free_slots(self) -> int:
        return self.capacity - len(self.runtimes) - self.reserved

    @property
    def slot(self) -> HostSlot:
        return HostSlot(self.index, self.capacity, self.device)

    def deploy(self, spec: TenantSpec):
        rt = self.manager.create_siddhi_app_runtime(
            spec.app_text, playback=self.playback)
        rt.start()
        self.runtimes[spec.tenant_id] = rt
        return rt

    def undeploy(self, tenant_id: str) -> None:
        rt = self.runtimes.pop(tenant_id, None)
        if rt is not None:
            rt.shutdown()
            self.manager.runtimes.pop(tenant_id, None)

    def compiled_programs(self) -> int:
        return self.manager.fleet.plan_cache.stats()["size"]

    def evidence(self) -> dict:
        """The capacity-scoring/rebalancing evidence for this host — the
        fleet tier's aggregate (:meth:`FleetManager.mesh_evidence`:
        events, lane packing, guard shed/eject pressure, violated SLO
        budgets) plus the host's own routing load. The same numbers the
        ``mesh.*`` metric families export."""
        return {
            "host": self.index, "device": self.device,
            "alive": self.alive,
            "tenants": len(self.runtimes),
            "capacity": self.capacity,
            "rows_in": self.rows_in,
            **self.manager.fleet.mesh_evidence(),
        }

    def kill(self) -> None:
        """Simulated SIGKILL: runtimes are DISCARDED, no flush, no
        hand-off — process memory is gone (``ProcMeshHost.kill`` is the
        real-process twin of this surface)."""
        self.runtimes.clear()
        # the manager registry too: a later close() must not "flush"
        # runtimes whose process memory this kill simulates losing
        self.manager.runtimes.clear()

    def close(self) -> None:
        self.alive = False
        self.manager.shutdown()
        self.runtimes.clear()


class _TenantState:
    """Fabric-side runtime state of one tenant: routing, the exactly-once
    seq/applied marks, and the migration spill queue."""

    __slots__ = ("spec", "gid", "host", "lock", "migrate_lock", "seq",
                 "applied", "spill", "migrating", "callbacks", "epoch",
                 "raw_hooks", "raw_streams")

    def __init__(self, spec: TenantSpec, gid: int, host: int, cfg: MeshConfig):
        self.spec = spec
        self.gid = gid                  # global tenant id → snapshot store key
        self.host = host                # LIVE owner (plan is the target)
        self.lock = threading.RLock()
        # admission guard for migrate(): one in-flight move per tenant —
        # a second mover (operator + rebalancer + SLO escalation can race)
        # must bounce, not interleave snapshot/undeploy/adopt
        self.migrate_lock = threading.Lock()
        self.seq = 0                    # last assigned chunk seq
        self.applied = 0                # last APPLIED chunk seq (dedup mark)
        self.epoch = 0                  # bumped per restore-from-revision
        self.spill = SpillQueue(cfg.spill_capacity_frames, cfg.spill_policy)
        self.migrating = False
        self.callbacks: list = []       # (stream_id, fn) — re-attached on move
        # durable sinks: fn([(epoch, idx, sid, ts, row), ...]) — re-armed
        # on every proxy (re)creation, replayed across a parent crash
        self.raw_hooks: list = []
        self.raw_streams: set = set()   # streams captured for raw hooks


class MeshFabric:
    """The mesh control plane: hosts, the plan, ingress routing, live
    migration, elasticity. One fabric per mesh. ``device`` is every host
    engine's device (the module docstring); ``devices`` the ordinals the
    plan records, probed by default."""

    def __init__(self, num_hosts: int, store_root: str,
                 config: Optional[MeshConfig] = None,
                 devices: Optional[list] = None, device=None):
        self.cfg = config or MeshConfig()
        self.device = device
        if devices is None:
            devices = self._probe_devices(num_hosts, device)
        # the fabric's own control-plane ring (created before the hosts:
        # process-mode supervision records its spawn/restart decisions
        # here); migration decisions ALSO fan out to the involved tenant
        # apps' recorders (their operators read their own timelines)
        self.flight = FlightRecorder(app_name="mesh")
        # fabric-side tracer (host=0: ids mint in the parent namespace and
        # local journeys register as stitch targets, so child spans coming
        # back on the flight tail land on the SAME trace object)
        self.tracer = None
        if self.cfg.trace_sample is not None:
            from ..observability.tracing import PipelineTracer
            self.tracer = PipelineTracer(sample_n=self.cfg.trace_sample,
                                         ring_size=self.cfg.trace_ring,
                                         host=0)
        # durable control plane: the journal replays BEFORE anything is
        # spawned — worker give-up budgets and tenant ownership come out
        # of it, and the supervisor's adopt-or-spawn pass consumes them
        self.journal = None
        self._recovery: dict = {}       # parent-recovery stats (report())
        self._staged_outputs: dict = {}  # tid -> journaled undelivered rows
        self._resync_tids: list = []    # re-adopted tenants to re-snapshot
        jstate = None
        t0 = time.monotonic()
        if self.cfg.durable:
            from ..procmesh.journal import FabricJournal
            self.journal = FabricJournal(
                os.path.join(store_root, "journal"),
                fsync=self.cfg.journal_fsync)
            ckpt, tail = self.journal.replay()
            if ckpt is not None or tail:
                jstate = self._merge_journal(ckpt, tail)
        self.supervisor = None
        if self.cfg.mode == "process":
            # procmesh: one OS process per host, the fabric ladder
            # dispatching over control sockets (lazy import — inproc
            # meshes never pay the subprocess machinery)
            from ..procmesh.supervisor import (
                ProcMeshSupervisor,
                SupervisorConfig,
            )
            self.supervisor = ProcMeshSupervisor(
                num_hosts,
                SupervisorConfig(
                    heartbeat_interval_s=self.cfg.heartbeat_interval_s,
                    failure_threshold=self.cfg.worker_failure_threshold,
                    restart_base_s=self.cfg.restart_base_s,
                    restart_window_s=self.cfg.restart_window_s,
                    restart_max=self.cfg.restart_max,
                    auto_restart=self.cfg.auto_restart,
                    env=self.cfg.worker_env,
                    run_dir=(os.path.join(store_root, "run")
                             if self.cfg.durable else None),
                    io_timeout_s=self.cfg.io_timeout_s,
                    connect_timeout_s=self.cfg.connect_timeout_s,
                    hedge_fraction=self.cfg.hedge_fraction,
                    wedge_threshold=self.cfg.wedge_threshold,
                    degrade_factor=self.cfg.degrade_factor,
                    degrade_floor_s=self.cfg.degrade_floor_s,
                    degrade_min_samples=self.cfg.degrade_min_samples),
                flight=self.flight, playback=self.cfg.playback,
                journal=self.journal,
                worker_state=(jstate or {}).get("workers"),
                devices=self._worker_devices(devices, num_hosts))
            self.supervisor.on_failed = self.host_failed
            self.supervisor.on_restarted = self.host_restarted
            self.supervisor.on_escalation = self._slo_escalate
            self.supervisor.on_degraded = self.host_degraded
            self.supervisor.on_undegraded = self.host_undegraded
            self.hosts: dict = {
                i: self.supervisor.host(
                    i, self.cfg.capacity_per_host,
                    device=(devices[i] if i < len(devices) else None))
                for i in range(num_hosts)}
        else:
            self.hosts = {}
            for i in range(num_hosts):
                dev = devices[i] if i < len(devices) else None
                self.hosts[i] = MeshHost(
                    i, self.cfg.capacity_per_host, device=dev,
                    playback=self.cfg.playback,
                    engine_device=self._engine_device(dev))
        self.store = LaneGroupSnapshotStore(store_root)
        self.policy = PlacementPolicy(self.cfg.policy, self.cfg.seed)
        self.plan = MeshPlan(policy=self.cfg.policy)
        self.tenants: dict = {}         # tenant_id -> _TenantState
        self._next_gid = 0
        self._lock = threading.RLock()  # hosts/plan/tenants maps
        self.migrations = 0
        self.migration_failures = 0
        self.recoveries = 0
        self.drains = 0                 # degrade-triggered host drains
        self.spilled_chunks = 0
        self.shed_chunks = 0            # spill overflow the policy DROPPED
        self.replayed_chunks = 0
        self.dup_chunks = 0
        self.plan_recomputes = 0
        self.chaos: Optional[Callable[[str], None]] = None  # test hook
        self._sm = None
        # windowed-load marks: rows_in at the last PLACEMENT-consuming
        # evidence read (cumulative shares would let an hour-old burst
        # repel placements forever)
        self._ev_last_rows: dict = {}
        if jstate is not None and jstate.get("tenants"):
            self._recover_parent(jstate, t0)
        if self.journal is not None:
            # recovery (or a clean boot) compacts the inherited tail away:
            # the next parent crash replays from this checkpoint
            self._journal_checkpoint()
        # liveness monitoring starts LAST: a death callback must never
        # observe a half-built fabric
        if self.supervisor is not None:
            self.supervisor.start_monitor()

    @staticmethod
    def _probe_devices(n: int, device=None) -> list:
        """Best-effort device binding: host i steps on CUDA ordinal ``i mod
        device_count()`` (every host on the one card ``device`` names,
        where it names one). Without a card, or for a fabric on the CPU,
        the binding stays None — placement and migration are
        device-agnostic."""
        try:
            import torch
            dev = None if device is None else torch.device(device)
            if (dev is not None and dev.type != "cuda") \
                    or not torch.cuda.is_available():
                return [None] * n
            if dev is not None:
                return [dev.index if dev.index is not None
                        else torch.cuda.current_device()] * n
            count = torch.cuda.device_count()
            return [i % count for i in range(n)]
        except Exception:   # noqa: BLE001 — metadata only, never fatal
            return [None] * n

    def _worker_devices(self, ordinals: list, n: int) -> list:
        """Each worker process's engine device, as ``--device`` takes it:
        the host's engine device (:meth:`_engine_device`), which raises
        here, before anything is spawned, where there is no card."""
        from ..gpu.backend import resolve_device
        out = []
        for i in range(n):
            dev = self._engine_device(ordinals[i] if i < len(ordinals)
                                      else None)
            out.append(str(resolve_device(dev) if dev is None else dev))
        return out

    def _engine_device(self, ordinal: Optional[int]):
        """A host engine's device: the fabric's, else the card of the
        host's ordinal (``None`` without one: the manager then raises)."""
        if self.device is not None:
            return self.device
        return None if ordinal is None else f"cuda:{ordinal}"

    def _site(self, site: str) -> None:
        if self.chaos is not None:
            self.chaos(site)

    def _crash(self, site: str) -> None:
        """``SIDDHI_CRASH_AT`` hook at an actuate boundary (armed for
        durable fabrics only — the journal is what makes a SIGKILL here
        recoverable; the journal-side boundaries fire inside
        :meth:`FabricJournal.append` itself)."""
        if self.journal is not None:
            from ..procmesh.journal import crash_point
            crash_point(site)

    def _journal(self, kind: str, **fields) -> int:
        if self.journal is None:
            return -1
        return self.journal.append(kind, **fields)

    def _wire_proxy(self, st: "_TenantState", rt) -> None:
        """Arm a (re)created worker proxy's durability taps: the epoch its
        outbox indices are namespaced under, the raw sink hooks, and the
        delivery-cursor journal callback (``delivered`` records are what a
        recovering parent reconciles child outboxes against)."""
        if self.journal is None or not getattr(rt, "procmesh_proxy", False):
            return
        rt.out_epoch = st.epoch
        rt.raw_hooks = list(st.raw_hooks)
        for sid in sorted(st.raw_streams):
            rt.subscribe(sid)           # idempotent on the child
        tid = st.spec.tenant_id
        rt.on_delivered = lambda idx, tid=tid, rt=rt: self._journal(
            "delivered", tenant=tid, epoch=rt.out_epoch, idx=idx)

    # -- deployment ----------------------------------------------------------
    def add_tenants(self, app_texts: list) -> MeshPlan:
        """Place + deploy a tenant population (placement sees the WHOLE
        batch, so shape locality packs globally). Tenant id = app name."""
        from ..compiler import parse as _parse
        specs = []
        with self._lock:
            for text in app_texts:
                app = _parse(text)
                tid = app.name()
                if tid in self.tenants:
                    raise ValueError(f"tenant '{tid}' already deployed")
                specs.append(TenantSpec(tid, text,
                                        shapes=shape_fingerprint(app)))
            all_specs = [t.spec for t in self.tenants.values()] + specs
            new_plan = self.policy.recompute(
                self.plan, all_specs,
                [h.slot for h in self.hosts.values() if h.alive],
                self.evidence(window=True))
            for spec in specs:
                host = new_plan.host_of(spec.tenant_id)
                st = _TenantState(spec, self._next_gid, host, self.cfg)
                self._next_gid += 1
                # INTENT FIRST: the deploy is in the journal before any
                # worker sees it — a parent crash in the gap re-resolves
                # to a (re)deploy on recovery, never a ghost tenant
                self._journal("deploy", tenant=spec.tenant_id, gid=st.gid,
                              host=host, app_text=spec.app_text)
                self.tenants[spec.tenant_id] = st
                rt = self.hosts[host].deploy(spec)
                self._crash("deploy.actuated")
                self._wire_proxy(st, rt)
                self._arm_slo_hook(rt)
            self.plan = new_plan
        return new_plan

    def remove_tenant(self, tenant_id: str) -> bool:
        """Undeploy one tenant fabric-wide (journaled before the worker
        op, so a recovering parent never resurrects it)."""
        with self._lock:
            st = self.tenants.get(tenant_id)
            if st is None:
                return False
            self._journal("undeploy", tenant=tenant_id)
            host = self.hosts.get(st.host)
            if host is not None and tenant_id in host.runtimes:
                host.undeploy(tenant_id)
            del self.tenants[tenant_id]
            self.plan.assignment.pop(tenant_id, None)
        return True

    def add_callback(self, tenant_id: str, stream_id: str, fn) -> None:
        """Attach an output callback that SURVIVES migration (re-attached
        on every deploy of the tenant)."""
        from ..core.stream import StreamCallback
        st = self.tenants[tenant_id]
        with st.lock:
            st.callbacks.append((stream_id, fn))
            rt = self.hosts[st.host].runtimes.get(tenant_id)
            if rt is not None:
                rt.add_callback(stream_id, StreamCallback(fn))

    def add_output_hook(self, tenant_id: str, fn, streams=()) -> None:
        """Durable-sink tap (process mode): ``fn`` receives raw outbox
        batches ``[(epoch, idx, sid, ts, row), ...]`` BEFORE the
        event-callback dispatch; ``streams`` names the output streams to
        capture (child-side capture arms per stream). Delivery is
        at-least-once across a parent crash (the dispatched-but-uncursored
        window re-ships on recovery) — sinks dedup by the ``(epoch,
        idx)`` identity, which is unique per emission across restores
        (``epoch`` bumps per incarnation)."""
        st = self.tenants[tenant_id]
        with st.lock:
            st.raw_hooks.append(fn)
            st.raw_streams.update(streams)
            rt = self.hosts[st.host].runtimes.get(tenant_id)
            if rt is not None and getattr(rt, "procmesh_proxy", False):
                rt.raw_hooks.append(fn)
                for sid in streams:
                    rt.subscribe(sid)

    def _reattach(self, rt, st: _TenantState) -> None:
        from ..core.stream import StreamCallback
        for stream_id, fn in st.callbacks:
            rt.add_callback(stream_id, StreamCallback(fn))

    def _arm_slo_hook(self, rt) -> None:
        """Give every SLO controller among this tenant's groups the
        cross-host rung: when its in-process ladder is exhausted it can
        decide ``mesh_replace`` and the fabric re-places the tenant.
        Takes the runtime DIRECTLY — during a migration the tenant's
        ``host`` field still points at the source until adoption
        completes, so a lookup through it would arm nothing."""
        for b in getattr(rt, "fleet_bridges", []):
            group = b.member.group
            if group is not None and group.slo is not None:
                group.slo.mesh_hook = self._slo_escalate

    def _slo_escalate(self, decision: dict) -> bool:
        """The SLO controller's ``mesh_replace`` actuator (its decision is
        already on the member's flight ring — the controller records before
        dispatching). Runs the move on a background thread: the evaluation
        slot rides tenant ingress and must never block on a migration."""
        tid = decision.get("tenant")
        st = self.tenants.get(tid)
        if st is None:
            return False
        dst = self._least_loaded_host(exclude=st.host)
        if dst is None:
            return False
        threading.Thread(
            target=self._migrate_logged, args=(tid, dst),
            kwargs={"reason": "slo:mesh_replace", "decided": decision},
            daemon=True).start()
        return True

    def _migrate_logged(self, tid: str, dst: int, **kw) -> None:
        try:
            self.migrate(tid, dst, **kw)
        except Exception:   # noqa: BLE001 — logged; the autopilot retries
            log.exception("mesh: slo-escalated migration of '%s' failed", tid)

    def _least_loaded_host(self, exclude: Optional[int] = None
                           ) -> Optional[int]:
        cands = [h for h in self.hosts.values()
                 if h.alive and h.index != exclude and h.free_slots > 0
                 and not getattr(h, "draining", False)]
        if not cands:
            return None
        # occupancy first (cumulative rows_in would bias against any host
        # that absorbed traffic once, forever), routed load as tie-break
        return min(cands, key=lambda h: (len(h.runtimes) + h.reserved,
                                         h.rows_in, h.index)).index

    # -- ingress routing (exactly-once) --------------------------------------
    def send(self, tenant_id: str, stream_id: str, rows: list,
             timestamps) -> None:
        """Route one per-tenant chunk to its owning host. Chunks get a
        per-tenant monotone seq; the apply path dedups (seq <= applied →
        already applied, ack again, apply nothing) so migration replays and
        kill-recovery replays stay exactly-once. A migrating (or
        dead-hosted) tenant's chunks spill in order — bounded by the
        spill policy: ``block`` (default) waits up to the queue's bounded
        window with NO tenant lock held (the replay drain needs it — the
        DCN ``_forward`` discipline), then force-admits (counted);
        ``shed``/``drop_oldest`` trade loss for memory, every dropped
        chunk counted in ``shed_chunks``/the queue's counters — loss is a
        visible policy choice, never silent."""
        j = self.journal
        if j is not None and \
                j.records_since_ckpt >= self.cfg.journal_checkpoint_every:
            # amortized compaction on the ingest path (no locks held):
            # replay cost after a parent crash stays bounded
            self._journal_checkpoint()
        st = self.tenants[tenant_id]
        host = self.hosts.get(st.host)
        if st.migrating or host is None or not host.alive:
            # cheap racy pre-check — the locked decision below is
            # authoritative; a miss costs one forced admit, counted
            st.spill.wait_for_space()
        with st.lock:
            st.seq += 1
            seq = st.seq
            host = self.hosts.get(st.host)
            # "runtime missing" covers the process-mode restart window: a
            # respawned worker is alive but EMPTY until recover_tenant
            # restores the tenant — its chunks spill like a dead host's
            if st.migrating or host is None or not host.alive \
                    or st.spec.tenant_id not in host.runtimes:
                self._spill_locked(st, seq, stream_id, rows, timestamps)
                return
            try:
                # 1-in-N ingress sampling happens HERE, on the direct-apply
                # path only: a spilled chunk replays without a context (its
                # trace simply records no dispatch), and the replay/recovery
                # applies never re-sample — exactly-once spans ride on the
                # seq dedup downstream
                tr = (self.tracer.maybe_trace(stream_id)
                      if self.tracer is not None else None)
                self._apply_locked(st, seq, stream_id, rows, timestamps,
                                   trace=tr)
            except ConnectionError:
                # the worker process died under this very chunk (procmesh
                # WorkerDown is a ConnectionError): the chunk spills and
                # the recovery replay applies it through the dedup mark
                self._spill_locked(st, seq, stream_id, rows, timestamps)

    def _spill_locked(self, st: "_TenantState", seq: int, stream_id: str,
                      rows: list, timestamps) -> None:
        if st.spill.append((seq, stream_id, rows, list(timestamps)),
                           len(rows)):
            self.spilled_chunks += 1
        else:
            self.shed_chunks += 1        # policy chose to drop: counted

    def _apply_locked(self, st: _TenantState, seq: int, stream_id: str,
                      rows: list, timestamps, trace=None) -> bool:
        """Apply one chunk under the tenant lock through the dedup mark;
        returns True when the chunk actually applied. With a snapshot
        cadence armed, the tenant persists BEFORE the ack (return) — the
        acked-chunk-is-durable contract kill-recovery leans on. ``trace``
        (a fabric-tracer Trace) rides the ingest header as a packed
        context; the child adopts it only on actual apply."""
        if seq <= st.applied:
            self.dup_chunks += 1
            return False                 # replay of an applied chunk: dedup
        host = self.hosts[st.host]
        rt = host.runtimes[st.spec.tenant_id]
        if getattr(rt, "procmesh_proxy", False):
            # process mode: the chunk crosses the control socket (child
            # dedups by seq — the retried-op side of exactly-once) and its
            # OUTPUT events come back buffered; they dispatch parent-side
            # only after the durability step below, so a child SIGKILLed
            # between apply and ack re-applies from the restored pre-chunk
            # state and every output is delivered exactly once
            trace_hex = None
            if trace is not None and self.tracer is not None:
                trace_hex = self.tracer.context_of(trace).pack().hex()
            t0 = time.perf_counter_ns()
            rt.send_chunk(seq, stream_id, [list(r) for r in rows],
                          list(timestamps), trace=trace_hex)
            if trace is not None:
                # the parent-side dispatch span: socket round-trip to the
                # child's applied ack (the child's own transit span covers
                # dispatch wall-clock → apply, including retry delay)
                trace.add_span("procmesh", f"dispatch:h{st.host}",
                               time.perf_counter_ns() - t0, len(rows))
            # applied on the child, not yet cursored in the journal: a
            # parent crash here re-adopts the live child and takes ITS
            # applied mark as authoritative (resync)
            self._crash("ingest.applied")
            host.rows_in += len(rows)
            prev, st.applied = st.applied, seq
            n = self.cfg.snapshot_every_chunks
            if n and seq % n == 0:
                try:
                    self._save_tenant_locked(st, rt)
                except Exception:
                    # not durable: the applied mark rolls back so the
                    # spill/recovery replay re-applies this chunk
                    st.applied = prev
                    raise
            rt.deliver_pending()
            return True
        rt.input_handler(stream_id).send_rows(
            [list(r) for r in rows], list(timestamps))
        host.rows_in += len(rows)
        st.applied = seq
        n = self.cfg.snapshot_every_chunks
        if n and seq % n == 0:
            self._save_tenant_locked(st, rt)
        return True

    def _save_tenant_locked(self, st: _TenantState, rt) -> int:
        """Persist the tenant's state bytes (flushed first — staged fleet
        rows resolve before the walk) as a snapshot-store blob revision
        keyed by its global id, with the applied mark riding the
        revision's dedup table — restore resumes the exactly-once window
        exactly."""
        rt.flush_host()
        rev = self.store.save_blob(st.gid, rt.snapshot(),
                                   {0: (st.epoch, st.applied)})
        if getattr(rt, "procmesh_proxy", False):
            # cursor AFTER the revision landed, BEFORE delivery: a parent
            # crash in either gap recovers — the journaled undelivered
            # outputs are the only copy once the child dies, so they ride
            # the cursor record (staged replay re-ships them)
            if self.journal is not None:
                self._journal("cursor", tenant=st.spec.tenant_id,
                              applied=st.applied, epoch=st.epoch,
                              outputs=[[rt.out_epoch] + e
                                       for e in rt.pending_outputs()])
            # flush-resolved outputs buffered on the proxy are covered by
            # the revision that just landed — deliver before any teardown
            # (migration undeploys the source right after saving)
            rt.deliver_pending()
        return rev

    # -- live migration ------------------------------------------------------
    def migrate(self, tenant_id: str, dst: int, reason: str = "operator",
                decided: Optional[dict] = None) -> bool:
        """Move one tenant between hosts under sustained ingest. The
        decision (with its evidence) hits the flight recorder(s) BEFORE any
        state moves; the data path is spill → flush+snapshot → revision
        durable → restore on dst → adoption ack (retried) → owner re-point
        → in-order spill replay through the dedup'd apply. One in-flight
        move per tenant: a concurrent mover (operator, rebalancer, SLO
        escalation) returns False instead of interleaving."""
        st = self.tenants[tenant_id]
        if not st.migrate_lock.acquire(blocking=False):
            log.info("mesh: migration of '%s' already in flight", tenant_id)
            return False
        try:
            return self._migrate_admitted(st, tenant_id, dst, reason,
                                          decided)
        finally:
            st.migrate_lock.release()

    def _migrate_admitted(self, st: "_TenantState", tenant_id: str,
                          dst: int, reason: str,
                          decided: Optional[dict]) -> bool:
        with self._lock:
            src = st.host
            dst_host = self.hosts.get(dst)
            if dst_host is None or not dst_host.alive:
                raise ValueError(f"mesh host {dst} is not alive")
            if src == dst:
                return False
            if dst_host.free_slots <= 0:
                raise ValueError(f"mesh host {dst} is at capacity")
            # RESERVE the slot under the lock: concurrent movers of
            # DIFFERENT tenants to the same destination must not both
            # pass a check-then-deploy capacity test
            dst_host.reserved += 1
        try:
            return self._migrate_reserved(st, tenant_id, src, dst, reason,
                                          decided)
        finally:
            with self._lock:
                dst_host.reserved = max(0, dst_host.reserved - 1)

    def _migrate_reserved(self, st: "_TenantState", tenant_id: str,
                          src: int, dst: int, reason: str,
                          decided: Optional[dict]) -> bool:
        # EVIDENCE FIRST: the decision lands on the fabric ring and the
        # tenant's own app timeline before the knob moves
        self._record_move(tenant_id, src, dst, reason, decided)
        src_rt = self.hosts[src].runtimes.get(tenant_id)
        try:
            # intent → committed two-record protocol: a parent crash
            # anywhere between these resolves to exactly one owner (src —
            # recovery scrubs any half-adopted dst copy and restores from
            # the pre-undeploy revision)
            self._journal("migrate_intent", tenant=tenant_id, src=src,
                          dst=dst)
            with st.lock:
                st.migrating = True      # fresh chunks spill from here on
            self._site("mesh.migrate.freeze")
            # quiesce + snapshot on the source (senders spill, not block)
            if src_rt is not None:
                self._save_tenant_migration(st, src_rt)
            self._site("mesh.migrate.snapshot")
            if src_rt is not None:
                self.hosts[src].undeploy(tenant_id)
            self._site("mesh.migrate.src_down")
            self._adopt(st, dst)
            self._crash("migrate.adopted")
            with st.lock:
                st.host = dst
                # the dst child is a fresh incarnation whose outbox indices
                # restart at 0: without an epoch bump its outputs would
                # collide with the pre-move (epoch, idx) identities and an
                # idempotent sink would drop them as duplicates
                st.epoch += 1
                new_rt = self.hosts[dst].runtimes.get(tenant_id)
                if new_rt is not None:
                    self._wire_proxy(st, new_rt)
                slot = self.plan.assignment.get(tenant_id)
                if slot is not None:
                    from .plan import MeshSlot
                    self.plan.assignment[tenant_id] = MeshSlot(
                        dst, slot.shape, self.hosts[dst].device)
                self._journal("migrate_commit", tenant=tenant_id, dst=dst,
                              applied=st.applied, epoch=st.epoch)
                st.migrating = False
                self._replay_spill_locked(st)
            self.migrations += 1
            self.flight.record("mesh", "migrated", site=f"tenant:{tenant_id}",
                               detail={"src": src, "dst": dst})
            return True
        except Exception:
            self.migration_failures += 1
            raise

    def _save_tenant_migration(self, st: _TenantState, rt) -> int:
        with st.lock:
            return self._save_tenant_locked(st, rt)

    def _adopt(self, st: _TenantState, dst: int) -> None:
        """Deploy + restore the tenant on ``dst`` from its latest revision
        and confirm the adoption. A lost ack retries against the SAME
        restored runtime — the restore is idempotent (re-restore from the
        same revision) and the seq dedup makes the replay side safe, the
        ``K_ADOPT`` two-attempt discipline."""
        last_err = None
        for attempt in range(self.cfg.adopt_retry_max):
            try:
                self._restore_on(st, dst)
                self._site("mesh.migrate.adopt_ack")   # lost-ack chaos site
                return
            except MeshChaosFault as e:
                last_err = e            # ack lost: retry the hand-off
                continue
        raise last_err if last_err is not None else \
            RuntimeError("adoption failed")

    def _restore_on(self, st: _TenantState, dst: int) -> None:
        tid = st.spec.tenant_id
        host = self.hosts[dst]
        rt = host.runtimes.get(tid)
        if rt is None:
            rt = host.deploy(st.spec)
            self._reattach(rt, st)
        snap = self.store.latest_blob(st.gid)
        if snap is not None:
            mark = snap["dedup"].get(0)
            if getattr(rt, "procmesh_proxy", False):
                # the worker's ingest dedup mark rides the restore op so
                # the child resumes the exactly-once window exactly
                rt.restore(snap["blob"],
                           applied=int(mark[1]) if mark else 0)
            else:
                rt.restore(snap["blob"])
            if mark is not None:
                # the saved mark never LOWERS the live incarnation (a
                # recovery's bump must survive restoring a pre-bump mark)
                st.epoch = max(st.epoch, int(mark[0]))
                st.applied = int(mark[1])
        self._wire_proxy(st, rt)
        self._arm_slo_hook(rt)

    def _replay_spill_locked(self, st: _TenantState) -> None:
        """Drain the tenant's spill in order through the dedup'd apply —
        chunks the source applied before the snapshot dedup away, the rest
        apply on the new owner exactly once."""
        while True:
            item = st.spill.pop_front()
            if item is None:
                return
            (seq, sid, rows, tss), n = item
            try:
                self._apply_locked(st, seq, sid, rows, tss)
            except Exception:
                st.spill.push_front(item)   # never lose a popped chunk
                raise
            st.spill.mark_replayed(n)
            self.replayed_chunks += 1

    def _record_move(self, tenant_id: str, src: int, dst: int, reason: str,
                     decided: Optional[dict]) -> None:
        detail = {"tenant": tenant_id, "src": src, "dst": dst,
                  "reason": reason}
        if decided:
            detail["decided_by"] = {
                k: v for k, v in decided.items()
                if isinstance(v, (str, int, float, bool, type(None)))}
        self.flight.record("mesh", "decision:migrate_tenant",
                           site=f"tenant:{tenant_id}", detail=detail)
        rt = self.hosts[src].runtimes.get(tenant_id) \
            if src in self.hosts else None
        fl = getattr(getattr(rt, "ctx", None), "flight", None)
        if fl is not None:
            fl.record("mesh", "decision:migrate_tenant",
                      site=f"tenant:{tenant_id}", detail=detail)

    # -- crash / recovery ----------------------------------------------------
    def kill_host(self, host: int) -> list:
        """Host SIGKILL: its runtimes are DISCARDED (no flush, no
        hand-off). In-process mode simulates the loss
        (:meth:`MeshHost.kill`); process mode delivers an ACTUAL signal 9
        to the worker (:meth:`ProcMeshHost.kill`) — same fabric path
        either way. Its tenants' fresh chunks spill until recovery;
        returns the orphaned tenant ids."""
        with self._lock:
            h = self.hosts.get(host)
            if h is None:
                return []
            h.alive = False
            orphans = sorted(h.runtimes)
            # EVIDENCE FIRST: the kill is on the ring before the signal
            self.flight.record("mesh", "host_killed", site=f"host:{host}",
                               detail={"tenants": orphans,
                                       "mode": self.cfg.mode})
            h.kill()                     # state is gone, like the process
            return orphans

    def host_failed(self, index: int) -> list:
        """Supervisor death callback (process mode): the worker's proxies
        are stale the instant the process dies — drop them so no caller
        dispatches into a dead incarnation. Tenants spill until recovery;
        returns the orphaned tenant ids."""
        with self._lock:
            h = self.hosts.get(index)
            if h is None:
                return []
            h.alive = False
            orphans = sorted(h.runtimes)
            self.flight.record("mesh", "host_failed", site=f"host:{index}",
                               detail={"tenants": orphans})
            if hasattr(h, "drop_runtimes"):
                h.drop_runtimes()
            else:
                h.kill()
            return orphans

    def host_degraded(self, index: int) -> None:
        """Supervisor degrade callback (latency-evidence ladder): the
        worker answers, but its windowed op p99 is a fleet-relative
        outlier. Proactive containment, not execution: mark the host
        draining (no NEW placements land on it) and migrate its tenants
        away. Runs the moves on a background thread — the monitor sweep
        that classified the outlier must never block on a migration
        (the ``_slo_escalate`` discipline)."""
        if not self.cfg.drain_on_degrade:
            return
        threading.Thread(target=self.drain_host, args=(index,),
                         kwargs={"reason": "degraded"}, daemon=True).start()

    def host_undegraded(self, index: int) -> None:
        """Degrade recovery (hysteresis rung): the host takes NEW
        placements again. Tenants already moved off stay where they
        are — re-spreading is the rebalancer's call, not the ladder's."""
        with self._lock:
            h = self.hosts.get(index)
            if h is None or not getattr(h, "draining", False):
                return
            h.draining = False
            self.flight.record("mesh", "host_undrained",
                               site=f"host:{index}")

    def drain_host(self, index: int, reason: str = "operator") -> int:
        """Drain actuator: record the decision, fence the host from new
        placements, then migrate every tenant it owns to the least-loaded
        non-draining peer. EVIDENCE FIRST — the ``decision:drain_host``
        entry is on the ring BEFORE ``draining`` flips and before any
        tenant moves (the ``mesh_replace`` record-before-actuate
        discipline). Returns the number of tenants moved."""
        with self._lock:
            h = self.hosts.get(index)
            if h is None or not h.alive:
                return 0
            tenants = sorted(h.runtimes)
            self.flight.record("mesh", "decision:drain_host",
                               site=f"host:{index}",
                               detail={"reason": reason,
                                       "tenants": tenants})
            h.draining = True
            self.drains += 1
        moved = 0
        for tid in tenants:
            st = self.tenants.get(tid)
            if st is None or st.host != index:
                continue
            dst = self._least_loaded_host(exclude=index)
            if dst is None:
                # nowhere to put it — the tenant stays; the fence still
                # keeps NEW work off the sick host, which is the point
                log.warning("mesh: drain of host %d has no destination "
                            "for '%s'", index, tid)
                continue
            try:
                self.migrate(tid, dst, reason=f"drain:{reason}")
                moved += 1
            except Exception:   # noqa: BLE001 — best-effort drain; the
                # tenant stays on the draining host, still served
                log.exception("mesh: drain migration of '%s' off host %d "
                              "failed", tid, index)
        return moved

    def host_restarted(self, index: int) -> int:
        """Supervisor restart callback: the respawned worker is ALIVE and
        EMPTY — replay the fabric's own recovery ladder
        (:meth:`recover_tenant`) for every tenant the dead incarnation
        owned, exactly like the simulated-chaos tests drive it by hand.
        Returns the number of tenants recovered."""
        with self._lock:
            h = self.hosts.get(index)
            if h is None:
                return 0
            h.alive = True
            # a fresh incarnation starts clean: whatever latency evidence
            # condemned the old process died with it
            h.draining = False
            self.flight.record("mesh", "host_restarted",
                               site=f"host:{index}")
            if self._sm is not None and hasattr(h, "register_child_metrics"):
                # fresh incarnation → fresh child gauge families (the old
                # generation's were torn down with the process)
                h.register_child_metrics(self._sm)
            orphans = [tid for tid, st in self.tenants.items()
                       if st.host == index
                       and tid not in h.runtimes
                       and not st.migrating]
        recovered = 0
        for tid in orphans:
            try:
                # back onto the respawned (empty) worker: its state
                # restores from the snapshot store, its spill replays
                self.recover_tenant(tid, index)
                recovered += 1
            except Exception:   # noqa: BLE001 — best-effort heal; the
                # tenant keeps spilling and an operator recover still works
                log.exception("mesh: auto-recovery of '%s' after worker %d "
                              "restart failed", tid, index)
        return recovered

    def recover_tenant(self, tenant_id: str,
                       dst: Optional[int] = None) -> int:
        """Re-place one orphaned tenant from its latest snapshot revision
        (restore → dedup mark resumes → spill replays in order). With
        ``snapshot_every_chunks=1`` this is exactly-once; at a looser
        cadence the loss bound is the chunks applied since the last
        revision (the DCN ``<= N-1`` frames contract). Shares the
        per-tenant admission lock with :meth:`migrate` — a recovery
        racing an in-flight move of the same tenant waits for it to
        finish or unwind instead of interleaving restores."""
        st = self.tenants[tenant_id]
        with st.migrate_lock:
            return self._recover_admitted(st, tenant_id, dst)

    def _recover_admitted(self, st: "_TenantState", tenant_id: str,
                          dst: Optional[int]) -> int:
        if dst is None:
            dst = self._least_loaded_host(exclude=st.host)
        if dst is None:
            raise ValueError("no live host with capacity to recover onto")
        self.flight.record("mesh", "decision:recover_tenant",
                           site=f"tenant:{tenant_id}",
                           detail={"dst": dst, "from": st.host})
        self._journal("recover", tenant=tenant_id, dst=dst)
        with st.lock:
            self._restore_on(st, dst)
            # incarnation bump AFTER the restore (which re-reads the saved
            # mark — bumping first would be silently overwritten and the
            # counter would never advance); the next snapshot persists it
            st.epoch += 1
            st.host = dst
            st.migrating = False
            slot = self.plan.assignment.get(tenant_id)
            if slot is not None:
                from .plan import MeshSlot
                self.plan.assignment[tenant_id] = MeshSlot(
                    dst, slot.shape, self.hosts[dst].device)
            rt = self.hosts[dst].runtimes.get(tenant_id)
            if rt is not None:
                self._wire_proxy(st, rt)    # fresh incarnation, fresh epoch
            self._journal("cursor", tenant=tenant_id, applied=st.applied,
                          epoch=st.epoch)
            self._replay_spill_locked(st)
        self.recoveries += 1
        return dst

    # -- parent recovery (durable control plane) -----------------------------
    @staticmethod
    def _merge_journal(ckpt: Optional[dict], tail: list) -> dict:
        """Fold a checkpoint plus its journal tail into the recovered
        control-plane state: ``{next_gid, tenants, workers, records}``.
        Per-tenant: ``host`` (owner), ``applied``/``epoch`` (the
        exactly-once window), ``delivered`` (the ``(epoch, idx)`` delivery
        high-water), ``outputs`` (journaled undelivered outbox entries —
        the only copy once a child dies) and ``intent`` (an uncommitted
        migration, resolved to the src owner)."""
        state = {"next_gid": 0, "tenants": {}, "workers": {}, "records": 0}
        if ckpt:
            state["next_gid"] = int(ckpt.get("next_gid", 0))
            for tid, t in (ckpt.get("tenants") or {}).items():
                state["tenants"][tid] = dict(t)
            for w, s in (ckpt.get("workers") or {}).items():
                state["workers"][int(w)] = dict(s)
        ts = state["tenants"]
        for rec in tail:
            state["records"] += 1
            k = rec.get("k")
            if k == "deploy":
                ts[rec["tenant"]] = {
                    "app_text": rec["app_text"], "gid": int(rec["gid"]),
                    "host": int(rec["host"]), "applied": 0, "epoch": 0,
                    "delivered": [-1, -1], "outputs": [], "intent": None}
                state["next_gid"] = max(state["next_gid"],
                                        int(rec["gid"]) + 1)
            elif k == "undeploy":
                ts.pop(rec["tenant"], None)
            elif k == "cursor":
                t = ts.get(rec["tenant"])
                if t is not None:
                    t["applied"] = int(rec["applied"])
                    t["epoch"] = int(rec["epoch"])
                    if "outputs" in rec:
                        t["outputs"] = rec["outputs"]
            elif k == "delivered":
                t = ts.get(rec["tenant"])
                if t is not None:
                    cur = tuple(int(x) for x in
                                (t.get("delivered") or (-1, -1)))
                    new = (int(rec["epoch"]), int(rec["idx"]))
                    if new > cur:
                        t["delivered"] = list(new)
            elif k == "migrate_intent":
                t = ts.get(rec["tenant"])
                if t is not None:
                    t["intent"] = {"src": int(rec["src"]),
                                   "dst": int(rec["dst"])}
            elif k == "migrate_commit":
                t = ts.get(rec["tenant"])
                if t is not None:
                    t["host"] = int(rec["dst"])
                    t["applied"] = int(rec.get("applied", t["applied"]))
                    t["epoch"] = int(rec.get("epoch", t["epoch"]))
                    t["intent"] = None
            elif k == "recover":
                t = ts.get(rec["tenant"])
                if t is not None:
                    t["host"] = int(rec["dst"])
            elif k == "worker_restart":
                w = state["workers"].setdefault(
                    int(rec["worker"]),
                    {"restarts": 0, "gave_up": False, "attempt_ages_s": []})
                w["restarts"] = int(w.get("restarts", 0)) + 1
                w["attempt_ages_s"] = list(rec.get("attempt_ages_s", ()))
            elif k == "worker_gave_up":
                w = state["workers"].setdefault(
                    int(rec["worker"]),
                    {"restarts": 0, "gave_up": False, "attempt_ages_s": []})
                w["gave_up"] = True
        return state

    def _recover_parent(self, state: dict, t0: float) -> None:
        """Rebuild the control plane after a PARENT crash (the journal's
        raison d'être): workers the supervisor re-adopted keep their live
        tenants WITHOUT restore — a resync op reconciles their outbox
        cursor against the journaled delivery cursor and their applied
        mark is authoritative; tenants on dead/respawned workers flow
        through the existing snapshot-restore + spill-replay ladder, with
        journaled-but-undelivered outputs staged for
        :meth:`resume_output_delivery`."""
        from ..compiler import parse as _parse
        sup = self.supervisor
        stats = {
            "readopted_workers": sum(
                1 for h in sup.handles.values() if h.adopted),
            "restored_workers": sum(
                1 for h in sup.handles.values()
                if not h.adopted and not h.gave_up),
            "readopted_tenants": 0, "restored_tenants": 0,
            "journal_records_replayed": int(state.get("records", 0)),
            "recover_s": 0.0,
        }
        # EVIDENCE FIRST: the recovery decision is on the ring before any
        # worker op moves state
        self.flight.record(
            "procmesh", "decision:parent_recovery", site="fabric",
            detail={"tenants": len(state.get("tenants", {})),
                    **{k: stats[k] for k in (
                        "readopted_workers", "restored_workers",
                        "journal_records_replayed")}})
        self._next_gid = max(self._next_gid, int(state.get("next_gid", 0)))
        for tid, t in sorted(state.get("tenants", {}).items()):
            try:
                if self._recover_tenant_record(tid, t, _parse):
                    stats["readopted_tenants"] += 1
                else:
                    stats["restored_tenants"] += 1
            except Exception:   # noqa: BLE001 — one tenant's turmoil must
                # not strand the rest of the fleet in __init__
                log.exception("mesh: parent recovery of tenant '%s' failed",
                              tid)
        stats["recover_s"] = round(time.monotonic() - t0, 6)
        self._recovery = stats
        self.flight.record("procmesh", "parent_recovered", site="fabric",
                           detail=dict(stats))

    def _recover_tenant_record(self, tid: str, t: dict, _parse) -> bool:
        """Recover ONE journaled tenant; True when re-adopted live (no
        restore), False when restored from the snapshot store."""
        from .plan import MeshSlot
        spec = TenantSpec(tid, t["app_text"],
                          shapes=shape_fingerprint(_parse(t["app_text"])))
        st = _TenantState(spec, int(t["gid"]), int(t["host"]), self.cfg)
        st.applied = int(t.get("applied", 0))
        st.epoch = int(t.get("epoch", 0))
        st.seq = st.applied             # the feeder resumes from applied
        self.tenants[tid] = st
        delivered = tuple(int(x) for x in (t.get("delivered") or (-1, -1)))
        intent = t.get("intent")
        if intent:
            # intent without commit: the move never happened — exactly one
            # owner (src); scrub any half-adopted dst copy first
            st.host = int(intent["src"])
            self._scrub_dst_copy(spec, int(intent["dst"]))
        host = self.hosts.get(st.host)
        readopted = False
        if host is not None and \
                getattr(getattr(host, "handle", None), "adopted", False):
            readopted = self._readopt_tenant(st, host, delivered)
        if not readopted:
            # dead, respawned-empty, or journaled-but-never-actuated: the
            # existing restore ladder (snapshot store + dedup mark + epoch
            # bump so the fresh incarnation's outbox indices never collide)
            dst = st.host if (host is not None and host.alive
                              and not getattr(getattr(host, "handle", None),
                                              "gave_up", False)) \
                else self._least_loaded_host(exclude=st.host)
            if dst is None:
                raise ValueError(f"no live host to restore '{tid}' onto")
            with st.lock:
                self._restore_on(st, dst)
                st.epoch += 1
                st.host = dst
                st.seq = st.applied
                rt = self.hosts[dst].runtimes.get(tid)
                if rt is not None:
                    self._wire_proxy(st, rt)
                self._journal("cursor", tenant=tid, applied=st.applied,
                              epoch=st.epoch)
            # the dead child's outbox died with it: the journaled
            # undelivered outputs are the only copy — stage past the
            # delivery high-water for resume_output_delivery()
            staged = [list(o) for o in t.get("outputs", ())
                      if (int(o[0]), int(o[1])) > delivered]
            if staged:
                self._staged_outputs[tid] = staged
            self.recoveries += 1
        self.plan.assignment[tid] = MeshSlot(
            st.host, spec.primary_shape,
            getattr(self.hosts.get(st.host), "device", None))
        return readopted

    def _readopt_tenant(self, st: "_TenantState", host,
                        delivered: tuple) -> bool:
        """Re-adopt a live child's tenant without restore: attach a fresh
        proxy, resync its outbox against the journaled delivery cursor,
        and take the child's applied mark as authoritative (it may have
        applied chunks whose journal cursor never landed)."""
        tid = st.spec.tenant_id
        ack = delivered[1] if delivered[0] == st.epoch else -1
        rt = host.adopt_runtime(st.spec)
        try:
            rh = rt.resync(ack)
        except (ConnectionError, RuntimeError):
            rh = {"present": False}
        if not rh.get("present"):
            # the child does not host it (a deploy journaled but never
            # actuated, or an undeploy raced the crash): fall through to
            # the restore path, which (re)deploys fresh
            host.runtimes.pop(tid, None)
            host._specs.pop(tid, None)
            return False
        st.applied = max(st.applied, int(rh.get("applied", 0)))
        st.seq = st.applied
        self._wire_proxy(st, rt)
        # the snapshot store may trail the child's live applied mark —
        # re-snapshot once delivery hooks are back (resume_output_delivery)
        self._resync_tids.append(tid)
        self.flight.record("procmesh", "tenant_readopt",
                           site=f"tenant:{tid}",
                           detail={"host": host.index,
                                   "applied": st.applied, "ack": ack})
        return True

    def _scrub_dst_copy(self, spec: TenantSpec, dst: int) -> None:
        """Uncommitted-migration cleanup: if the move's target child is
        live (re-adopted) and holds a half-adopted copy, undeploy it — the
        journal says the move never committed, so src is the one owner."""
        h = self.hosts.get(dst)
        if h is None or not getattr(getattr(h, "handle", None),
                                    "adopted", False):
            return
        try:
            h.adopt_runtime(spec)
            h.undeploy(spec.tenant_id)   # tolerant child op: no-op if absent
        except (ConnectionError, RuntimeError):
            log.warning("mesh: could not scrub half-adopted copy of '%s' "
                        "on host %d", spec.tenant_id, dst)

    def resume_output_delivery(self) -> dict:
        """Second half of parent recovery, called once the caller has
        re-attached its callbacks and output hooks (a fresh parent process
        has none at construction): replays journal-staged outputs from
        dead incarnations (at-least-once — sinks dedup by ``(epoch,
        idx)``), then re-snapshots re-adopted tenants so the store catches
        up to the child's authoritative applied mark (their resync'd
        outbox tails dispatch through the normal delivery path here)."""
        from ..core.event import Event
        out = {"replayed_outputs": 0, "resnapshotted": 0}
        staged, self._staged_outputs = self._staged_outputs, {}
        for tid in sorted(staged):
            st = self.tenants.get(tid)
            entries = staged[tid]
            if st is None or not entries:
                continue
            with st.lock:
                for hook in st.raw_hooks:
                    hook([tuple(e) for e in entries])
                i = 0
                while i < len(entries):
                    sid = entries[i][2]
                    j = i
                    while j < len(entries) and entries[j][2] == sid:
                        j += 1
                    evs = [Event(e[3], e[4]) for e in entries[i:j]]
                    for cb_sid, fn in st.callbacks:
                        if cb_sid == sid:
                            fn(evs)
                    i = j
                last = entries[-1]
                self._journal("delivered", tenant=tid,
                              epoch=int(last[0]), idx=int(last[1]))
                out["replayed_outputs"] += len(entries)
        resync, self._resync_tids = self._resync_tids, []
        for tid in resync:
            st = self.tenants.get(tid)
            if st is None:
                continue
            with st.lock:
                rt = self.hosts[st.host].runtimes.get(tid)
                if rt is not None:
                    self._save_tenant_locked(st, rt)
                    out["resnapshotted"] += 1
        return out

    def _journal_checkpoint(self) -> None:
        """Fold the whole control plane into one ``ckpt`` record and
        truncate the acked segments behind it (the journal's compaction
        contract — replay cost stays bounded by
        ``journal_checkpoint_every``)."""
        if self.journal is None:
            return
        with self._lock:
            tenants = {}
            for tid, st in self.tenants.items():
                h = self.hosts.get(st.host)
                rt = h.runtimes.get(tid) if h is not None else None
                rec = {"app_text": st.spec.app_text, "gid": st.gid,
                       "host": st.host, "applied": st.applied,
                       "epoch": st.epoch, "intent": None,
                       "delivered": [st.epoch, -1], "outputs": []}
                if rt is not None and getattr(rt, "procmesh_proxy", False):
                    rec["delivered"] = [rt.out_epoch, rt.delivered]
                    rec["outputs"] = [[rt.out_epoch] + e
                                      for e in rt.pending_outputs()]
                staged = self._staged_outputs.get(tid)
                if staged:
                    # recovered-but-not-yet-replayed outputs must survive
                    # another crash: carry them (pre-filtered, so a reset
                    # high-water replays exactly this set)
                    rec["delivered"] = [-1, -1]
                    rec["outputs"] = [list(o) for o in staged]
                # a checkpoint racing a live migration journals the
                # still-src owner with no intent: a crash before the
                # commit record rolls the move back (restore on src)
                tenants[tid] = rec
            state = {"next_gid": self._next_gid, "tenants": tenants,
                     "workers": (self.supervisor.worker_state()
                                 if self.supervisor is not None else {})}
        self.journal.checkpoint(state)

    # -- elasticity ----------------------------------------------------------
    def add_host(self, capacity: Optional[int] = None) -> int:
        """Host join: a new shard enters, the plan recomputes (sticky), and
        the diff applies as bulk migrations onto the newcomer."""
        if self.supervisor is not None:
            # the process fleet is sized at boot (the supervisor owns the
            # worker population); growing it live is a follow-up
            raise ValueError(
                "process-mode mesh has a fixed worker fleet; size it at "
                "MeshFabric construction")
        with self._lock:
            idx = (max(self.hosts) + 1) if self.hosts else 0
            dev = self._probe_devices(idx + 1, self.device)[-1]
            self.hosts[idx] = MeshHost(
                idx, capacity or self.cfg.capacity_per_host, device=dev,
                playback=self.cfg.playback,
                engine_device=self._engine_device(dev))
            if self._sm is not None:      # metrics track elasticity live
                self._register_host_metrics(self._sm, self.hosts[idx])
        self.flight.record("mesh", "host_join", site=f"host:{idx}")
        # balanced recompute: without the retain cap, sticky slots would
        # leave the newcomer empty — a join must trigger bulk adoption
        self._apply_recompute(balance=True)
        return idx

    def remove_host(self, host: int) -> int:
        """Graceful host leave: recompute the plan without it and bulk-
        migrate its tenants out (each move is a full live migration —
        spill/snapshot/restore/replay), then close the shard. Returns the
        number of tenants moved."""
        if self.supervisor is not None:
            raise ValueError(
                "process-mode mesh has a fixed worker fleet; size it at "
                "MeshFabric construction")
        with self._lock:
            h = self.hosts.get(host)
            if h is None:
                return 0
            h.alive = False              # placement stops targeting it
        self.flight.record("mesh", "host_leave", site=f"host:{host}")
        moved = self._apply_recompute()
        with self._lock:
            self.hosts[host].close()
            del self.hosts[host]
            if self._sm is not None:      # no zombie gauges on a closed
                self._sm.unregister(f"mesh.h{host}.")   # MeshHost closure
        return moved

    def _apply_recompute(self, balance: bool = False) -> int:
        """Plan recompute + bulk adoption: every move in the diff runs as a
        live migration (the decision trail names the elasticity event)."""
        with self._lock:
            specs = [t.spec for t in self.tenants.values()]
            slots = [h.slot for h in self.hosts.values() if h.alive]
            new_plan = self.policy.recompute(self.plan, specs, slots,
                                             self.evidence(window=True),
                                             balance=balance)
            moves = self.plan.diff(new_plan)
            self.plan_recomputes += 1
        moved = 0
        for tid, _src, dst in moves:
            st = self.tenants[tid]
            if st.host == dst:
                continue
            src_host = self.hosts.get(st.host)
            if src_host is not None and tid in src_host.runtimes:
                # the source runtime is INTACT (a draining host counts —
                # alive=False only stops placement): a full live migration
                # flushes + snapshots the current state. Routing by
                # aliveness here would silently restore a graceful
                # leaver's tenants from STALE revisions — duplicates for
                # every stateful shape.
                self.migrate(tid, dst, reason="elasticity")
            else:
                self.recover_tenant(tid, dst)   # process truly gone
            moved += 1
        with self._lock:
            self.plan = new_plan
        return moved

    # -- evidence / introspection --------------------------------------------
    def evidence(self, window: bool = False) -> dict:
        """Per-host evidence map (the placement scorer's and rebalancer's
        input). ``load_share`` is each live host's share of rows routed
        SINCE the last placement-consuming read (``window=True`` advances
        the marks — placement/recompute callers pass it; plain reads like
        ``GET /mesh`` observe the same window without consuming it). A
        cumulative lifetime share would let an hour-old burst repel new
        placements forever."""
        with self._lock:
            hosts = list(self.hosts.values())
            deltas = {h.index: max(0, h.rows_in
                                   - self._ev_last_rows.get(h.index, 0))
                      for h in hosts}
            if window:
                for h in hosts:
                    self._ev_last_rows[h.index] = h.rows_in
        total = sum(d for h, d in deltas.items()
                    if self.hosts.get(h) is not None
                    and self.hosts[h].alive) or 1
        out = {}
        for h in hosts:
            ev = h.evidence() if h.alive else {
                "host": h.index, "alive": False, "tenants": 0,
                "rows_in": h.rows_in}
            ev["load_share"] = deltas[h.index] / total if h.alive else 0.0
            out[h.index] = ev
        return out

    def flush(self) -> None:
        for h in self.hosts.values():
            if not h.alive:
                continue
            for rt in list(h.runtimes.values()):
                rt.flush_host()
                if getattr(rt, "procmesh_proxy", False):
                    # a flush resolves staged rows into outputs — the
                    # buffered outbox tail dispatches now
                    rt.deliver_pending()

    def sync_children(self) -> dict:
        """Process-mode observability pull: scrape every live worker's
        full tracker state (gauges + counters + latency histograms) and
        absorb its flight-ring tail into the fabric's timeline
        (site-prefixed ``h{i}:``, child stamps clock-offset-corrected).
        Trace journeys riding the tail stitch into the fabric tracer.
        Inproc hosts share the parent recorder already — this is a no-op
        for them."""
        out = {"scraped": 0, "forwarded": 0}
        for h in list(self.hosts.values()):
            if not h.alive or not hasattr(h, "forward_flight"):
                continue
            out["scraped"] += len(h.scrape_metrics())
            out["forwarded"] += h.forward_flight(self.flight,
                                                 tracer=self.tracer)
        return out

    # -- observability federation --------------------------------------------
    def _federated_hosts(self) -> list:
        """Process-backed hosts whose scrape is FRESH enough to render:
        dead, gave-up, or stale-scrape workers are excluded, so their
        families age out of the exposition instead of rendering zombie
        values; a re-adopted/restarted worker re-enters under the same
        ``h{i}`` label on its first good scrape."""
        out = []
        for h in list(self.hosts.values()):
            if not hasattr(h, "latency_states"):
                continue
            handle = getattr(h, "handle", None)
            if not h.alive or (handle is not None and handle.gave_up):
                continue
            if h.scrape_age_s() > self.cfg.metrics_stale_after_s:
                continue
            out.append(h)
        return out

    @staticmethod
    def _phase_of_key(key: str) -> Optional[str]:
        """Scraped latency key → phase name, for keys on the X-Ray phase
        vocabulary (``{tenant}.phase.{query}.{phase}`` plus the
        ``end_to_end`` distribution); None for other latency sites."""
        from ..observability.phases import PHASES
        parts = key.split(".")
        leaf = parts[-1]
        if "phase" in parts[:-1] and leaf in PHASES:
            return leaf
        if "detection" in parts[:-1] and leaf == "end_to_end":
            return "end_to_end"
        return None

    def collect_federated(self, families: dict,
                          app: Optional[str] = None) -> None:
        """Prometheus ``render`` collector hook: per-worker federated
        families (``worker="h{i}"``) plus the fabric-level merge
        (``worker="fabric"``) — bounded worker-label cardinality (host
        count + one), histogram merges exact on the shared ladder."""
        from ..observability.prometheus import collect_scraped
        app = app or "mesh"
        fabric_lat: list = []
        fabric_ctr: list = []
        for h in self._federated_hosts():
            lat, ctr = h.latency_states(), h.counter_states()
            collect_scraped(families, app, f"h{h.index}",
                            lat.items(), ctr.items())
            fabric_lat.extend(lat.items())
            fabric_ctr.extend(ctr.items())
        if fabric_lat or fabric_ctr:
            collect_scraped(families, app, "fabric", fabric_lat, fabric_ctr)

    def federation(self) -> dict:
        """``GET /mesh/latency``: the federated latency breakdown as JSON
        — per worker (scrape age, staleness, per-phase p50/p99) plus the
        fabric-level merge. Scrapes first, so one call is one consistent
        pull of every live worker."""
        if self.supervisor is not None:
            self.sync_children()
        workers: dict = {}
        merged_states: dict = {}        # phase -> [state, ...]
        for h in list(self.hosts.values()):
            if not hasattr(h, "latency_states"):
                continue
            handle = getattr(h, "handle", None)
            age = h.scrape_age_s()
            stale = (not h.alive
                     or (handle is not None and handle.gave_up)
                     or age > self.cfg.metrics_stale_after_s)
            entry = {"scrape_age_s": round(age, 3), "stale": stale,
                     "alive": bool(h.alive), "phases": {}}
            if not stale:
                by_phase: dict = {}
                for key, state in h.latency_states().items():
                    phase = self._phase_of_key(key)
                    if phase is None:
                        continue
                    by_phase.setdefault(phase, []).append(state)
                for phase, states in by_phase.items():
                    entry["phases"][phase] = self._phase_stats(states)
                    merged_states.setdefault(phase, []).extend(states)
            workers[f"h{h.index}"] = entry
        return {
            "workers": workers,
            "merged": {phase: self._phase_stats(states)
                       for phase, states in merged_states.items()},
            "stale_after_s": self.cfg.metrics_stale_after_s,
            "clock_offsets_ns": (
                {f"h{i}": h.clock_offset_ns
                 for i, h in self.supervisor.handles.items()}
                if self.supervisor is not None else {}),
        }

    @staticmethod
    def _phase_stats(states: list) -> dict:
        from ..observability.histogram import LogHistogram
        hist = LogHistogram.merge(states)
        snap = hist.snapshot()
        return {"count": snap["count"],
                "p50_ms": round(snap["p50"] * 1e3, 6),
                "p99_ms": round(snap["p99"] * 1e3, 6),
                "avg_ms": round(snap["avg"] * 1e3, 6)}

    def report(self) -> dict:
        """Service-facing state (``GET /mesh``)."""
        if self.supervisor is not None:
            self.sync_children()        # fold worker timelines in first
        with self._lock:
            backlog = {t: len(st.spill) for t, st in self.tenants.items()
                       if len(st.spill)}
            return {
                "mode": self.cfg.mode,
                "supervisor": (self.supervisor.report()
                               if self.supervisor is not None else None),
                "hosts": self.evidence(),
                "plan": self.plan.report(),
                "tenants": len(self.tenants),
                "migrations": self.migrations,
                "migration_failures": self.migration_failures,
                "recoveries": self.recoveries,
                "drains": self.drains,
                "draining_hosts": sorted(
                    h.index for h in self.hosts.values()
                    if getattr(h, "draining", False)),
                "plan_recomputes": self.plan_recomputes,
                "spilled_chunks": self.spilled_chunks,
                "shed_chunks": self.shed_chunks,
                "replayed_chunks": self.replayed_chunks,
                "dup_chunks": self.dup_chunks,
                "spill_backlog": backlog,
                "journal": (self.journal.position()
                            if self.journal is not None else None),
                "recovery": (self._recovery or None),
                "decisions": [e for e in self.flight.export(category="mesh")
                              if e["kind"].startswith("decision:")][-16:],
            }

    def register_metrics(self, sm) -> None:
        """Expose fabric state as ``mesh.*`` trackers → the
        ``siddhi_tpu_mesh_*`` Prometheus families (label ``host`` = host
        index, ``self`` for fabric-level; lint-pinned by
        ``scripts/check_metric_names.py``). Host leave/rejoin cycles tear
        the families down through ``sm.unregister('mesh.')`` — pinned in
        tests/test_metrics.py so dead gauges never leak — as are the
        elasticity edges: a host joining AFTER registration gets its
        ``mesh.h{i}.*`` gauges on arrival, a removed host's are
        unregistered with it (no permanent blind spots or zombie gauges
        across an elasticity event)."""
        for h in list(self.hosts.values()):
            self._register_host_metrics(sm, h)
        sm.gauge_tracker("mesh.self.hosts",
                         lambda: sum(1 for h in self.hosts.values()
                                     if h.alive))
        sm.gauge_tracker("mesh.self.tenants", lambda: len(self.tenants))
        sm.gauge_tracker("mesh.self.plan_epoch", lambda: self.plan.epoch)
        sm.gauge_tracker("mesh.self.migrations_total",
                         lambda: self.migrations)
        sm.gauge_tracker("mesh.self.migration_failures_total",
                         lambda: self.migration_failures)
        sm.gauge_tracker("mesh.self.recoveries_total",
                         lambda: self.recoveries)
        sm.gauge_tracker("mesh.self.drains_total",
                         lambda: self.drains)
        sm.gauge_tracker("mesh.self.draining_hosts",
                         lambda: sum(1 for h in self.hosts.values()
                                     if getattr(h, "draining", False)))
        sm.gauge_tracker("mesh.self.spilled_chunks_total",
                         lambda: self.spilled_chunks)
        sm.gauge_tracker("mesh.self.shed_chunks_total",
                         lambda: self.shed_chunks)
        sm.gauge_tracker("mesh.self.replayed_chunks_total",
                         lambda: self.replayed_chunks)
        sm.gauge_tracker("mesh.self.dup_chunks_total",
                         lambda: self.dup_chunks)
        sm.gauge_tracker("mesh.self.spill_backlog_chunks",
                         lambda: sum(len(st.spill)
                                     for st in self.tenants.values()))
        sm.gauge_tracker("mesh.self.process_mode",
                         lambda: 1 if self.cfg.mode == "process" else 0)
        if self.supervisor is not None:
            # procmesh.w{i}.* / procmesh.self.* + the per-child scraped
            # families (mesh.h{i}.child.*) — torn down with their worker
            self.supervisor.register_metrics(sm)
            for h in list(self.hosts.values()):
                if hasattr(h, "register_child_metrics"):
                    h.register_child_metrics(sm)
        if self.journal is not None:
            # parent-recovery outcome + journal position → the
            # siddhi_tpu_procmesh_*{worker="recovery"} families
            for k in ("readopted_workers", "restored_workers",
                      "readopted_tenants", "restored_tenants",
                      "journal_records_replayed"):
                sm.gauge_tracker(f"procmesh.recovery.{k}",
                                 lambda k=k: int(self._recovery.get(k, 0)))
            sm.gauge_tracker(
                "procmesh.recovery.recover_s",
                lambda: float(self._recovery.get("recover_s", 0.0)))
            sm.gauge_tracker(
                "procmesh.recovery.journal_lsn",
                lambda: (self.journal.position()["lsn"]
                         if self.journal is not None else 0))
        self._sm = sm

    @staticmethod
    def _register_host_metrics(sm, h: MeshHost) -> None:
        hi = h.index
        sm.gauge_tracker(f"mesh.h{hi}.tenants",
                         lambda h=h: len(h.runtimes))
        sm.gauge_tracker(f"mesh.h{hi}.rows_in_total",
                         lambda h=h: h.rows_in)
        sm.gauge_tracker(f"mesh.h{hi}.compiled_programs",
                         lambda h=h: h.compiled_programs()
                         if h.alive else 0)
        sm.gauge_tracker(f"mesh.h{hi}.alive",
                         lambda h=h: 1 if h.alive else 0)

    def close(self) -> None:
        if self._sm is not None:
            self._sm.unregister("mesh.")
            if self.supervisor is not None or self.journal is not None:
                self._sm.unregister("procmesh.")
            self._sm = None
        if self.journal is not None:
            # final compaction while the workers still answer ops: a clean
            # restart replays one ckpt record instead of the whole tail
            try:
                self._journal_checkpoint()
            except Exception:   # noqa: BLE001 — teardown must not wedge on
                # a dead worker mid-checkpoint
                log.exception("mesh: final journal checkpoint failed")
        if self.supervisor is not None:
            # monitor first: a restart racing the teardown would respawn
            # workers the loop below is stopping
            self.supervisor.shutdown()
        for h in list(self.hosts.values()):
            h.close()
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        self.hosts.clear()
        self.tenants.clear()
