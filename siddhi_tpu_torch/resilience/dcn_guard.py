"""Multi-host fault tolerance for the DCN shard layer.

The port's copy of the JAX package's ``resilience/dcn_guard.py``, with only
imports, logger names and docstrings changed: the snapshot files it writes
are the JAX package's, byte for byte.

DISTRIBUTED.md's "Failure / elasticity" row, implemented. The transport
(`gpu/dcn.py`) stays a thin framed-socket layer; everything that makes a
peer failure a *bounded, first-class path* (Hazelcast Jet's tail-latency
prerequisite, PAPERS.md arXiv 2103.10169) lives here:

- :class:`PeerHealth` — per-peer failure detector reusing
  :class:`~siddhi_tpu_torch.resilience.circuit.CircuitBreaker`:
  ``healthy → suspect → down → probing``. CLOSED with zero consecutive
  failures is *healthy*, CLOSED with some is *suspect*, OPEN is *down*
  (``down_since`` feeds the takeover deadline), HALF_OPEN is *probing*
  (exactly one heartbeat probe admitted per cool-down).
- :class:`SpillQueue` — bounded, ordered per-lane-group buffer of framed
  ``K_ROWS`` payloads that absorbs frames while a peer is down and replays
  them in order on recovery. Overflow follows the
  :class:`~siddhi_tpu_torch.flow.backpressure.OverloadPolicy` surface
  (``block``/``drop_oldest``/``shed``), every outcome counted. ``block``
  never drops: the producer waits (outside any engine/group lock) up to
  ``spill_max_wait_s``, then the frame is forced in and counted.
- :class:`LaneGroupSnapshotStore` — snapshot revisions keyed by GLOBAL lane
  ids (the contiguous-regroup property DISTRIBUTED.md guarantees), so a
  survivor can adopt a dead host's lane group and a returning host can
  re-join via the same handoff in reverse.
- :class:`DCNGuard` — the controller: heartbeat loop (``K_PING``/``K_PONG``
  on a background thread), retry/backoff bookkeeping, spill admission, and
  failover orchestration (takeover past the deadline, hand-back + spill
  replay on recovery).

Elastic shard takeover as the scalability primitive follows the
cloud-native pattern-detection framework (PAPERS.md arXiv 2401.09960).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..flow.backpressure import OverloadPolicy
from .circuit import CircuitBreaker, CircuitState

log = logging.getLogger("siddhi_tpu_torch.resilience.dcn")

PEER_HEALTHY = "healthy"
PEER_SUSPECT = "suspect"
PEER_PROBING = "probing"
PEER_DOWN = "down"
# gray-failure rungs: latency EVIDENCE, not liveness evidence.
# *degraded* — alive and correct but a fleet-relative tail outlier; the
# fabric proactively drains tenants off it. *wedged* — heartbeats answer
# while substantive ops time out; operationally DOWN (a heartbeat proves
# the event loop breathes, not that work completes).
PEER_DEGRADED = "degraded"
PEER_WEDGED = "wedged"

# numeric codes for the peer_state gauge (a time series must not carry
# strings — same convention as CircuitState.CODES)
PEER_STATE_CODES = {PEER_HEALTHY: 0, PEER_SUSPECT: 1, PEER_PROBING: 2,
                    PEER_DOWN: 3, PEER_DEGRADED: 4, PEER_WEDGED: 5}

PEER_COUNTER_KEYS = ("pings", "ping_failures", "retries", "reconnects",
                     "redirects")


class PeerHealth:
    """Per-peer failure detector over a :class:`CircuitBreaker`.

    The breaker's three states map onto the four liveness states: CLOSED
    splits into *healthy* (no consecutive failures) and *suspect* (some,
    below the threshold); OPEN is *down*; HALF_OPEN is *probing*.
    ``down_since`` is pinned at the first OPEN transition and survives
    failed probes (a re-opened breaker resets ``opened_at``, which would
    otherwise push the takeover deadline out on every probe).

    Two latency-evidence overlays extend the ladder: *wedged*
    (:meth:`mark_wedged` — heartbeats OK, substantive ops timing out)
    outranks everything but a hard OPEN and is treated as down by every
    caller (:meth:`is_down`); *degraded* (:meth:`mark_degraded` — a
    fleet-relative p99 outlier) shows below probing and triggers a
    proactive drain, but the peer keeps serving. Both flags are FED by
    the supervisor's per-op histograms — the breaker alone cannot see a
    gray failure because heartbeat successes keep it CLOSED.
    """

    def __init__(self, failure_threshold: int = 3,
                 down_cooldown_s: float = 1.0, clock=time.monotonic):
        self.breaker = CircuitBreaker(failure_threshold, down_cooldown_s,
                                      clock=clock)
        self.clock = clock
        self.down_since: Optional[float] = None
        self.last_downtime_s = 0.0      # length of the last CLOSED outage
        self.wedged = False             # gray overlay: ops stall, pings OK
        self.degraded = False           # gray overlay: fleet p99 outlier
        self.wedge_count = 0            # lifetime wedge declarations
        self.degrade_count = 0          # lifetime degrade declarations

    @property
    def state(self) -> str:
        st = self.breaker.state
        if st == CircuitState.OPEN:
            return PEER_DOWN
        if self.wedged:
            return PEER_WEDGED
        if st == CircuitState.HALF_OPEN:
            return PEER_PROBING
        if self.degraded:
            return PEER_DEGRADED
        return PEER_SUSPECT if self.breaker.suspect else PEER_HEALTHY

    def is_down(self) -> bool:
        """Operationally down: hard-down OR wedged — a wedged peer must
        not be trusted with work even though its heartbeats answer."""
        return self.state in (PEER_DOWN, PEER_WEDGED)

    def mark_wedged(self) -> None:
        """Declare gray-down on latency evidence: heartbeats succeed while
        substantive ops time out. Pins ``down_since`` (the outage clock
        starts at DETECTION, not at the eventual kill) — cleared only by
        :meth:`clear_wedged` after a restart heals the worker."""
        if not self.wedged:
            self.wedge_count += 1
        self.wedged = True
        if self.down_since is None:
            self.down_since = self.clock()

    def clear_wedged(self) -> None:
        self.wedged = False

    def mark_degraded(self) -> None:
        if not self.degraded:
            self.degrade_count += 1
        self.degraded = True

    def clear_degraded(self) -> None:
        self.degraded = False

    @property
    def state_code(self) -> int:
        return PEER_STATE_CODES[self.state]

    def allow_probe(self) -> bool:
        """True when a heartbeat may go out (healthy/suspect always; down
        only once per cool-down, as the HALF_OPEN probe)."""
        return self.breaker.allow()

    def record_success(self) -> None:
        if self.wedged:
            # heartbeat successes are exactly the gray-failure signature:
            # they must neither close the breaker's view of the outage
            # nor stop the downtime clock — only clear_wedged() does
            return
        if self.down_since is not None:
            # close the outage, keeping its length: the restart-latency
            # evidence outlives the recovery that ends it
            self.last_downtime_s = max(0.0, self.clock() - self.down_since)
        self.breaker.record_success()
        self.down_since = None

    def record_failure(self) -> None:
        self.breaker.record_failure()
        if self.breaker.state == CircuitState.OPEN and \
                self.down_since is None:
            self.down_since = self.clock()

    def trip(self) -> None:
        """Declare the peer down NOW on unambiguous hard evidence (e.g. a
        hand-back exchange failed right after a successful probe) — the
        probe cycle then re-drives recovery instead of waiting out the
        failure threshold."""
        self.breaker.trip()
        if self.down_since is None:
            self.down_since = self.clock()

    def downtime_s(self) -> float:
        """Seconds since the FIRST down transition of this outage (0 when
        not down) — the DCN takeover deadline's clock, and the procmesh
        supervisor's restart-latency evidence (how long a worker's tenants
        were orphaned before the respawn healed them)."""
        if self.down_since is None:
            return 0.0
        return max(0.0, self.clock() - self.down_since)

    def report(self) -> dict:
        return {"state": self.state, "state_code": self.state_code,
                "consecutive_failures": self.breaker.consecutive_failures,
                "open_count": self.breaker.open_count,
                "down_since": self.down_since,
                "downtime_s": self.downtime_s(),
                "last_downtime_s": self.last_downtime_s,
                "wedged": self.wedged, "degraded": self.degraded,
                "wedge_count": self.wedge_count,
                "degrade_count": self.degrade_count}


class SpillQueue:
    """Bounded, ordered buffer of framed rows for ONE lane group.

    Ordering matters: receiver-side dedup is monotone in the per-sender
    sequence number, so frames must replay in the order they were framed.
    Appends go right, a replay that fails part-way restores its frame with
    :meth:`push_front` — order is never shuffled.
    """

    def __init__(self, capacity: int, policy: str,
                 max_wait_s: float = 5.0):
        self.capacity = max(1, int(capacity))
        self.policy = OverloadPolicy.parse(policy)
        self.max_wait_s = max_wait_s
        self._q: collections.deque = collections.deque()
        self._cond = threading.Condition()
        # outcome counters (frames / rows)
        self.spilled_frames = 0
        self.spilled_rows = 0
        self.dropped_oldest_frames = 0
        self.dropped_oldest_rows = 0
        self.shed_frames = 0
        self.shed_rows = 0
        self.forced = 0
        self.replayed_frames = 0
        self.replayed_rows = 0

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def empty(self) -> bool:
        return len(self) == 0

    def wait_for_space(self, shutdown: Optional[threading.Event] = None,
                       ) -> None:
        """BLOCK-policy admission wait. Called with NO locks held (a
        producer blocking under the group send lock would deadlock the
        replay drain). Bounded by ``max_wait_s``; on expiry the next
        :meth:`append` forces the frame in rather than dropping (the
        flow-layer never-drop-under-block contract)."""
        if self.policy != OverloadPolicy.BLOCK:
            return
        deadline = time.monotonic() + self.max_wait_s
        with self._cond:
            while len(self._q) >= self.capacity:
                if shutdown is not None and shutdown.is_set():
                    return
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                self._cond.wait(min(left, 0.05))

    def append(self, frame: bytes, n_rows: int) -> bool:
        """Apply the overload policy; returns False when the frame was shed.
        Under BLOCK the frame is always admitted — a full queue here means
        the bounded wait expired (or the caller could not wait), counted in
        ``forced``."""
        with self._cond:
            if len(self._q) >= self.capacity:
                if self.policy == OverloadPolicy.SHED:
                    self.shed_frames += 1
                    self.shed_rows += n_rows
                    return False
                if self.policy == OverloadPolicy.DROP_OLDEST:
                    while len(self._q) >= self.capacity:
                        _, old_rows = self._q.popleft()
                        self.dropped_oldest_frames += 1
                        self.dropped_oldest_rows += old_rows
                else:                       # BLOCK past its bounded wait
                    self.forced += 1
            self._q.append((frame, n_rows))
            self.spilled_frames += 1
            self.spilled_rows += n_rows
            return True

    def pop_front(self):
        """Next (frame, n_rows) to replay, or None. Frees a BLOCK waiter."""
        with self._cond:
            if not self._q:
                return None
            item = self._q.popleft()
            self._cond.notify_all()
            return item

    def push_front(self, item) -> None:
        """Restore a frame whose replay failed (keeps order intact)."""
        with self._cond:
            self._q.appendleft(item)

    def mark_replayed(self, n_rows: int) -> None:
        self.replayed_frames += 1
        self.replayed_rows += n_rows

    def report(self) -> dict:
        return {"depth": len(self), "capacity": self.capacity,
                "policy": self.policy,
                "spilled_frames": self.spilled_frames,
                "spilled_rows": self.spilled_rows,
                "replayed_frames": self.replayed_frames,
                "replayed_rows": self.replayed_rows,
                "dropped_oldest_frames": self.dropped_oldest_frames,
                "dropped_oldest_rows": self.dropped_oldest_rows,
                "shed_frames": self.shed_frames,
                "shed_rows": self.shed_rows,
                "forced": self.forced}


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss (on
    POSIX the rename lives in the directory's own data). Platforms that
    cannot open directories (Windows) skip silently — rename durability is
    filesystem-provided there."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class LaneGroupSnapshotStore:
    """Filesystem store of lane-group state revisions keyed by GLOBAL lane
    ids.

    Layout: ``root/group_<g>/rev_<%08d>.npz`` — state pytree leaves in
    flatten order (``leaf_000`` …) plus a JSON ``meta`` entry carrying the
    global lane ids, the group's receiver-side dedup table
    (``{sender: [epoch, seq]}``), and the shard's string dictionaries
    (state slots store dictionary CODES; codes without the dictionary are
    meaningless in a fresh process — what
    ``batch.device_state_snapshot`` pins for single-host checkpoints).
    Because lane state is self-contained and lanes re-group contiguously,
    ANY host can restore a group's revision — that is the failover
    primitive. Writes are tmp+fsync+rename+dir-fsync: tmp+rename alone
    keeps readers from seeing a TORN revision but not from losing the
    revision entirely after power loss (the rename can hit disk before the
    data, or never), so both writers fsync the tmp file before
    ``os.replace`` and the parent directory after it.
    """

    def __init__(self, root: str, keep_revisions: int = 2):
        self.root = root
        # only latest() is ever read; older revisions are pruned after
        # each save (at snapshot_every_frames=1 the store would otherwise
        # grow by a full state-size per acked frame)
        self.keep_revisions = max(1, int(keep_revisions))
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _group_dir(self, group: int) -> str:
        return os.path.join(self.root, f"group_{group}")

    def _revisions(self, group: int) -> list:
        d = self._group_dir(group)
        if not os.path.isdir(d):
            return []
        return sorted(n for n in os.listdir(d)
                      if n.startswith("rev_") and n.endswith(".npz"))

    def save(self, group: int, global_lanes: list, leaves: list,
             dedup: dict, dicts: Optional[dict] = None) -> int:
        """Persist one group's state; returns the new revision number."""
        with self._lock:
            revs = self._revisions(group)
            rev = (int(revs[-1][4:-4]) + 1) if revs else 0
            d = self._group_dir(group)
            os.makedirs(d, exist_ok=True)
            meta = json.dumps({
                "group": group,
                "global_lanes": [int(x) for x in global_lanes],
                "dedup": {str(s): [int(e), int(q)]
                          for s, (e, q) in dedup.items()},
                "dicts": dicts or {},
                "revision": rev,
            })
            arrays = {f"leaf_{i:03d}": np.asarray(leaf)
                      for i, leaf in enumerate(leaves)}
            path = os.path.join(d, f"rev_{rev:08d}.npz")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, meta=np.frombuffer(meta.encode(), np.uint8),
                         **arrays)
                f.flush()
                os.fsync(f.fileno())    # data durable BEFORE the rename
            os.replace(tmp, path)
            _fsync_dir(d)               # ... and the rename itself durable
            for stale in self._revisions(group)[:-self.keep_revisions]:
                try:
                    os.remove(os.path.join(d, stale))
                except OSError:
                    log.warning("could not prune snapshot revision %s/%s",
                                d, stale)
            return rev

    def save_blob(self, group: int, blob: bytes, dedup: dict) -> int:
        """Opaque state-bytes revision (the mesh fabric's per-tenant app
        snapshots ride here, keyed by global tenant id): one uint8 leaf
        under the SAME revision/tmp+fsync+rename/pruning discipline as
        lane-group pytrees — an acked revision is durable before the
        hand-off that depends on it."""
        return self.save(group, [group],
                         [np.frombuffer(blob, dtype=np.uint8)], dedup)

    def latest_blob(self, group: int) -> Optional[dict]:
        """Newest :meth:`save_blob` revision as ``{blob, dedup,
        revision}``, or None."""
        snap = self.latest(group)
        if snap is None:
            return None
        return {"blob": np.asarray(snap["leaves"][0],
                                   dtype=np.uint8).tobytes(),
                "dedup": snap["dedup"], "revision": snap["revision"]}

    def next_epoch(self, host: int) -> int:
        """Monotone per-host incarnation counter (0 on first call). A
        worker constructed without an explicit epoch draws one here, so a
        restart can never silently reuse a dead incarnation's sequence
        space (peer dedup tables would discard every fresh frame)."""
        with self._lock:
            path = os.path.join(self.root, f"host_{host}.epoch")
            try:
                with open(path, encoding="utf-8") as f:
                    epoch = int(f.read().strip()) + 1
            except (OSError, ValueError):
                epoch = 0
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(str(epoch))
                f.flush()
                os.fsync(f.fileno())    # an epoch lost to power loss would
                # resurrect a dead incarnation's sequence space (peer dedup
                # would then discard every fresh frame)
            os.replace(tmp, path)
            _fsync_dir(self.root)
            return epoch

    def latest(self, group: int) -> Optional[dict]:
        """Newest *readable* revision for ``group`` as ``{leaves,
        global_lanes, dedup, revision}``, or None when the group has never
        snapshotted. A torn/corrupt newest revision (a crash mid-rename, a
        scribbled block) falls back to the previous intact one — losing one
        snapshot interval is recoverable, refusing to restore is not."""
        with self._lock:
            meta = leaves = None
            for name in reversed(self._revisions(group)):
                path = os.path.join(self._group_dir(group), name)
                try:
                    with np.load(path) as z:
                        meta = json.loads(bytes(z["meta"]).decode())
                        # numeric sort: lexicographic would interleave
                        # leaf_1000 between leaf_100 and leaf_101 and
                        # silently scramble the pytree on restore
                        keys = sorted(
                            (k for k in z.files if k.startswith("leaf_")),
                            key=lambda k: int(k[5:]))
                        if not keys:
                            # every writer stores >= 1 leaf: a zip with
                            # none had a member name scribbled (zipfile
                            # only CRCs member *data*)
                            raise ValueError("snapshot has no leaf arrays")
                        leaves = [z[k] for k in keys]
                    break
                except Exception:   # noqa: BLE001 — zipfile/npz/json raise a
                    # zoo of types for a torn file; all mean "try the
                    # previous revision"
                    log.warning("snapshot %s unreadable — falling back to "
                                "previous revision", path)
                    meta = leaves = None
            if meta is None:
                return None
        return {"leaves": leaves,
                "global_lanes": meta["global_lanes"],
                "dedup": {int(s): (int(e), int(q))
                          for s, (e, q) in meta["dedup"].items()},
                "dicts": meta.get("dicts", {}),
                "revision": meta["revision"]}


@dataclass
class DCNGuardConfig:
    """Fault-tolerance knobs for one
    :class:`~siddhi_tpu_torch.gpu.dcn.DCNWorker`.

    ``heartbeat_interval_s=None`` disables the background thread (tests
    drive :meth:`DCNGuard.heartbeat_once` deterministically);
    ``takeover_deadline_s=None`` disables automatic failover."""

    heartbeat_interval_s: Optional[float] = None
    probe_timeout_s: float = 2.0
    failure_threshold: int = 3          # consecutive failures → DOWN
    down_cooldown_s: float = 1.0        # DOWN → one PROBING ping per cooldown
    takeover_deadline_s: Optional[float] = None
    retry_max: int = 3                  # send attempts per frame
    retry_base_s: float = 0.02          # capped exponential backoff
    retry_cap_s: float = 0.5
    spill_capacity_frames: int = 256
    spill_policy: str = OverloadPolicy.BLOCK
    spill_max_wait_s: float = 5.0


class DCNGuard:
    """Peer health + spill + failover controller for one DCN worker.

    The worker owns the transport (sockets, framing, the engine lock); the
    guard owns the *decisions*: is this peer sendable, does this frame spill,
    when does a probe go out, when does a survivor adopt a dead host's lane
    group, and when does a recovered host get it back. Heartbeats and
    failover run on the guard's background thread (or a test's explicit
    :meth:`heartbeat_once` calls)."""

    def __init__(self, worker, config: Optional[DCNGuardConfig] = None,
                 clock=time.monotonic):
        self.worker = worker
        self.config = config or DCNGuardConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self._health: dict = {}
        self._spill: dict = {}
        self._adopting: set = set()      # groups with a takeover in flight
        # per-peer transport counters (dict-of-dicts so report() is one walk)
        self.peer_counters: dict = {p: dict.fromkeys(PEER_COUNTER_KEYS, 0)
                                    for p in worker.peers}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # held while an async backlog sweep is in flight (overlap guard)
        self._sweeping = threading.Lock()
        # NOT auto-started: the worker calls start_if_configured() as the
        # LAST step of its own __init__ — an early tick would race
        # half-constructed worker state (e.g. self.guard not yet bound)

    # -- accessors -----------------------------------------------------------
    def health(self, peer: int) -> PeerHealth:
        with self._lock:
            h = self._health.get(peer)
            if h is None:
                h = self._health[peer] = PeerHealth(
                    self.config.failure_threshold,
                    self.config.down_cooldown_s, clock=self.clock)
            return h

    def spill(self, group: int) -> SpillQueue:
        with self._lock:
            q = self._spill.get(group)
            if q is None:
                q = self._spill[group] = SpillQueue(
                    self.config.spill_capacity_frames,
                    self.config.spill_policy,
                    self.config.spill_max_wait_s)
            return q

    def peer_state(self, peer: int) -> str:
        return self.health(peer).state

    def count(self, peer: int, key: str, n: int = 1) -> None:
        with self._lock:
            self.peer_counters.setdefault(
                peer, dict.fromkeys(PEER_COUNTER_KEYS, 0))[key] += n

    # -- send-path hooks -----------------------------------------------------
    def on_send_ok(self, peer: int) -> None:
        self.health(peer).record_success()

    def on_send_error(self, peer: int) -> None:
        self.health(peer).record_failure()

    def must_spill(self, group: int) -> bool:
        """A frame for ``group`` must spill when the owning peer is down or
        a backlog already exists (in-order delivery: frame N+1 must never
        overtake a spilled frame N — receiver dedup is monotone)."""
        owner = self.worker.topo.owner[group]
        if owner == self.worker.host_index:
            return False
        if not self.spill(group).empty:
            return True
        return self.peer_state(owner) == PEER_DOWN

    def backoff_s(self, attempt: int) -> float:
        return min(self.config.retry_cap_s,
                   self.config.retry_base_s * (2 ** attempt))

    # -- heartbeat / failover loop -------------------------------------------
    def start_if_configured(self) -> None:
        if self.config.heartbeat_interval_s is not None:
            self.start()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        interval = self.config.heartbeat_interval_s or 1.0
        while not self._stop.wait(interval):
            try:
                self.heartbeat_once(sweep_async=True)
            except Exception:       # noqa: BLE001 — keep-alive: the loop
                log.exception("dcn heartbeat tick failed")  # must survive

    def heartbeat_once(self, sweep_async: bool = False) -> None:
        """One detector tick: probe every peer the breaker admits, run the
        takeover-deadline check, then sweep spill backlogs. Deterministic —
        tests call it directly with a fake clock instead of running the
        background thread. The background loop passes ``sweep_async=True``:
        a replay can block for retry_max × io_timeout against a wedged
        owner, and that stall must not delay the NEXT tick's probes."""
        now = self.clock()
        peers = list(self.worker.peers)
        # probe admitted peers CONCURRENTLY: a serial loop would let one
        # wedged peer (blocking until probe_timeout_s) delay detection,
        # takeover checks, and the sweep for every other peer
        results: dict = {}
        threads = []
        for peer in peers:
            if self.health(peer).allow_probe():
                self.count(peer, "pings")

                def probe(p=peer):
                    results[p] = self.worker.ping_peer(p)

                t = threading.Thread(target=probe, daemon=True)
                threads.append(t)
                t.start()
        for t in threads:
            t.join()
        for peer in peers:
            h = self.health(peer)
            if peer in results:
                was_down = h.down_since is not None
                if results[peer]:
                    h.record_success()
                    if was_down:
                        self._on_peer_recovered(peer, async_=sweep_async)
                else:
                    self.count(peer, "ping_failures")
                    h.record_failure()
            self._check_takeover(peer, h, now, async_=sweep_async)
        # backlog sweep: replay whenever a group's CURRENT owner is
        # reachable. Peer-recovery detection alone strands backlogs in two
        # shapes: the group was adopted by a survivor (its original host
        # never returns), or an in-flight data-path retry succeeded and
        # cleared down_since before any probe observed the outage.
        if sweep_async:
            if self._sweeping.acquire(blocking=False):
                threading.Thread(target=self._sweep_then_release,
                                 daemon=True).start()
        else:
            self._sweep_backlogs()

    def _sweep_backlogs(self) -> None:
        for group in self.backlogged_groups():
            owner = self.worker.topo.owner[group]
            if owner == self.worker.host_index \
                    or self.peer_state(owner) != PEER_DOWN:
                self.worker.replay_spill(group)

    def _sweep_then_release(self) -> None:
        try:
            self._sweep_backlogs()
        except Exception:       # noqa: BLE001 — keep-alive: logged, the
            log.exception("dcn backlog sweep failed")   # next tick retries
        finally:
            self._sweeping.release()

    def _check_takeover(self, peer: int, h: PeerHealth, now: float,
                        async_: bool = False) -> None:
        deadline = self.config.takeover_deadline_s
        if deadline is None or h.state != PEER_DOWN or h.down_since is None:
            return
        if now - h.down_since < deadline:
            return
        if not self.worker.is_designated_survivor(peer):
            return
        for group in self.worker.topo.groups_owned_by(peer):
            if async_:
                # a takeover is the slowest guard action of all (disk
                # restore + shard jit compile + spill replay) — on the
                # background loop it must not stall other peers' probes
                self._spawn_takeover(group)
            else:
                self.worker.take_over(group)

    def _spawn_takeover(self, group: int) -> None:
        with self._lock:
            if group in self._adopting:
                return                # already in flight; ticks keep firing
            self._adopting.add(group)

        def run():
            try:
                self.worker.take_over(group)
            except Exception:   # noqa: BLE001 — logged; the next tick's
                log.exception("takeover of group %d failed", group)  # retry
            finally:
                with self._lock:
                    self._adopting.discard(group)

        threading.Thread(target=run, daemon=True).start()

    def _on_peer_recovered(self, peer: int, async_: bool = False) -> None:
        """A down peer answered a probe: hand back any lane groups we
        adopted from it (snapshot → reassign → K_ADOPT, the takeover in
        reverse). Its backlog drains in the same tick's sweep. From the
        background loop the hand-back runs on its own thread — the K_ADOPT
        exchange waits out the home host's restore (up to the extended
        adopt deadline) and must not stall other peers' probes."""
        # group g homes on host g, so the only group to hand back to a
        # recovered peer is its own index
        if peer in self.worker.topo.groups_owned_by(self.worker.host_index):
            if async_:
                threading.Thread(target=self.worker.release_group,
                                 args=(peer,), daemon=True).start()
            else:
                self.worker.release_group(peer)

    def backlogged_groups(self) -> list:
        with self._lock:
            return sorted(g for g, q in self._spill.items() if not q.empty)

    # -- introspection -------------------------------------------------------
    def report(self) -> dict:
        with self._lock:
            peers = {
                str(p): {**self._health[p].report(),
                         **self.peer_counters.get(p, {})}
                for p in self._health
            }
            spill = {str(g): q.report() for g, q in self._spill.items()}
        return {"peers": peers, "spill": spill,
                "config": {
                    "heartbeat_interval_s":
                        self.config.heartbeat_interval_s,
                    "failure_threshold": self.config.failure_threshold,
                    "down_cooldown_s": self.config.down_cooldown_s,
                    "takeover_deadline_s": self.config.takeover_deadline_s,
                    "retry_max": self.config.retry_max,
                    "spill_policy": self.config.spill_policy,
                    "spill_capacity_frames":
                        self.config.spill_capacity_frames,
                }}
