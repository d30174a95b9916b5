"""FleetGuard: per-tenant blast-radius isolation for shared-lane execution.

Fleet groups make thousands of tenants step as lanes of ONE compiled
program — and one shared blast radius: a poison input or injected fault in
any tenant's lane would fail the whole group's batch, and a hot tenant
could starve every co-batched neighbor. This module makes tenant failure a bounded,
first-class path, mirroring what :class:`~siddhi_tpu_torch.resilience.
device_guard.DeviceGuard` does for the device tier:

- **Containment** — every
  :class:`~siddhi_tpu_torch.fleet.group.FleetGroup` step
  runs through the guard. Sliced (stateful) shapes execute per-member
  segments, so the faulting segment identifies the culprit directly;
  batched (stateless) shapes bisect the merged batch over member-id subsets
  until the culprit lane(s) isolate. Innocent tenants' rows replay through
  the shared program exactly once (no loss, no dupes, per-tenant order
  preserved); the culprit **ejects to its solo tier**.

- **The solo tier** — an ejected tenant keeps the SHARED columnar plan but
  steps it alone: a private stager feeds the same per-member execution the
  group uses (``FleetGroup._run_segment``), against the member's own state.
  State never leaves ``member.state``/``member.prt`` and dictionaries stay
  the group's shared tables, so ejection costs no recompile and
  re-admission needs no code translation. A solo step that ITSELF faults
  escalates down the existing ladder to the scalar interpreter
  (fresh-state caveat, same contract as DeviceGuard's quarantine).

- **Re-admission** — a per-tenant
  :class:`~siddhi_tpu_torch.resilience.circuit.CircuitBreaker` (threshold → eject, cool-down → probe): after
  ``guard.readmit.batches`` clean solo batches AND the breaker's cool-down,
  the tenant re-joins the group as a half-open probe; a clean group step
  re-closes the circuit, another fault re-ejects with a fresh cool-down.

- **Input hardening** — per-tenant staging validation so bad bytes never
  reach the shared program: dictionary growth caps at stage time (a
  blow-up tenant cannot balloon the SHARED string tables), dtype-mismatch
  diagnosis when a batch fails to encode (only the offending tenant's rows
  divert), and a vectorized non-finite sweep over the emitted float
  columns (NaN/Inf param rows divert to the tenant's error path).

- **Fair share** — per-tenant weighted credits over the group's flush
  window (``@app:fleet(weight='2', max_lag_events='1000')``): a tenant at
  its ``max_lag_events`` quota sheds its own overflow (counted, never a
  co-tenant's), and a firehose that fills its weighted share of the window
  while others wait triggers an early ``fair_share`` flush so idle tenants
  keep their latency. Per-tenant arrival EMAs feed the sizing and the
  ``fleet.tenant.*`` gauges.

The device backend's two-phase dispatch/collect pipeline keeps its own
containment through :class:`DeviceGuard`; the host-batch tier has
:class:`HostStepGuard` below.

The port's copy of the JAX package's ``resilience/fleet_guard.py``. A
group's emitted window reaches the guard as CPU tensors (``fleet/group.py``:
``_torch_batch``), so the non-finite sweep, the chaos roll and the
bisection run as torch ops; numpy stays on the staging side (the columnar
admission's distinct-string pass over a tenant's input columns, the encode
diagnosis).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..fleet.group import member_counts
from .chaos import ChaosFault
from .circuit import CircuitBreaker, CircuitState

log = logging.getLogger("siddhi_tpu_torch.resilience")

_DEF_THRESHOLD = 1          # confirmed culprit faults before ejection
_DEF_COOLDOWN_S = 2.0       # breaker cool-down before a re-admission probe
_DEF_READMIT_BATCHES = 3    # clean solo batches required to re-admit
_DEF_DICT_CAP = 65536       # per-tenant distinct new strings


class PolicyEviction(Exception):
    """Marker 'fault' carried as the eject reason when the SLO autopilot
    (not a lane fault) ejects a tenant to its solo tier — never raised."""


def build_scalar_escalation(query, app_context, stream_defs: dict,
                            get_junction, name: str, shared_callbacks,
                            site: str):
    """The ladder's bottom, shared by FleetGuard and HostStepGuard: a
    scalar interpreter runtime for ``query``, its callback list aliased to
    the guarded bridge's so registered query callbacks see escalated
    outputs too. Returns None when even this build fails (the caller
    counts the rows as lost). root_lock FIRST — building registers state
    holders the snapshot walk iterates under the same lock."""
    with app_context.root_lock:
        try:
            from ..core.query_runtime import build_query_runtime
            rt = build_query_runtime(query, app_context, stream_defs,
                                     get_junction, name)
            if shared_callbacks is not None:
                rt.callback_adapter.callbacks = shared_callbacks
            rt.start()
            return rt
        except Exception:  # noqa: BLE001 — the ladder ran out: count the
            # rows as lost rather than killing co-tenant delivery
            log.exception("%s: scalar escalation build failed", site)
            return None


def replay_rows_scalar(rt, sid_of_si, shadow_rows, shadow_ts, root_lock,
                       site: str) -> tuple:
    """Replay raw ``(si, row)`` shadow rows through a scalar runtime's
    subscriptions in order; returns ``(delivered, lost)``. Each row is
    contained individually — a poison row that makes even the scalar
    interpreter raise is counted lost and the LATER rows still deliver
    (aborting mid-loop would silently drop the whole tail and leak the
    exception back into ingress)."""
    from ..core.event import EventType, StreamEvent
    delivered = lost = 0
    with root_lock:
        for (si, row), ts in zip(shadow_rows, shadow_ts):
            ev = StreamEvent(ts, list(row), EventType.CURRENT)
            lsid = sid_of_si(si)
            try:
                for rsid, receiver in rt.subscriptions:
                    if rsid == lsid:
                        receiver.receive(ev)
            except Exception:  # noqa: BLE001 — the ladder's last rung: a
                # row even the scalar interpreter rejects is counted lost
                lost += 1
                continue
            delivered += 1
    if lost:
        log.warning("%s: %d poison row(s) rejected by the scalar "
                    "interpreter during replay (counted lost)", site, lost)
    return delivered, lost


class TenantLane:
    """Per-member guard state: the tenant's circuit breaker, containment
    counters, fair-share window accounting and (when ejected) its solo
    stager + scalar escalation runtime."""

    def __init__(self, member, threshold: int, cooldown_s: float):
        self.member = member
        self.breaker = CircuitBreaker(threshold, cooldown_s)
        self.ejections = 0
        self.readmissions = 0
        self.shed = 0               # fair-share overflow rows dropped
        self.poisoned = 0           # hardened-away rows (non-finite/dtype/dict)
        self.lost = 0               # rows no tier could execute
        self.solo_batches = 0       # clean solo batches since ejection
        self.solo_events = 0
        self.eject_reason: Optional[str] = None
        self.policy_hold = False    # SLO-autopilot ejection: auto-readmit
        # is suspended until the controller releases the hold
        self.policy_quota: Optional[int] = None   # SLO-autopilot hard
        # per-window admit cap: unlike max_lag (which steps the group to
        # open a new window — backpressure, no loss), excess over this
        # quota SHEDS even when the engine could keep up, so a noisy
        # neighbour's burst cannot buy itself extra shared steps
        self.escalated = False      # scalar tier reached (one-way; set
        # synchronously at the escalation decision — the runtime itself
        # builds lazily on the deferred replay path)
        self.new_strings = 0        # distinct strings this tenant minted
        self.billed_strings: set = set()   # already counted (staged rows
        # don't reach the shared dictionary until the emit, so without this
        # the same pending string would bill the tenant once per chunk);
        # bounded by the cap — billing stops once the tenant is capped
        self.dict_capped = False
        self.staged_window = 0      # rows staged since the last group step
        self.arrival_evps = 0.0     # EMA of this tenant's arrival rate
        self._last_stage_t: Optional[float] = None
        # solo tier (built at ejection)
        self.solo_stager = None
        self.scalar_rt = None       # scalar interpreter escalation
        self.scalar_receivers = None

    @property
    def ejected(self) -> bool:
        return self.member.ejected

    def observe_arrival(self, n: int) -> None:
        now = time.monotonic()
        if self._last_stage_t is not None and now > self._last_stage_t:
            inst = n / (now - self._last_stage_t)
            self.arrival_evps = inst if self.arrival_evps == 0.0 \
                else 0.8 * self.arrival_evps + 0.2 * inst
        self._last_stage_t = now

    def report(self) -> dict:
        return {
            "tenant": self.member.tenant,
            "query": self.member.query_name,
            "ejected": self.ejected,
            "eject_reason": self.eject_reason,
            "policy_hold": self.policy_hold,
            "policy_quota": self.policy_quota,
            "circuit": self.breaker.state,
            "ejections": self.ejections,
            "readmissions": self.readmissions,
            "shed": self.shed,
            "poisoned": self.poisoned,
            "lost": self.lost,
            "solo_batches": self.solo_batches,
            "solo_engine": ("scalar" if self.escalated
                            else "columnar") if self.ejected else None,
            "arrival_evps": round(self.arrival_evps, 1),
        }


class FleetGuard:
    """Wraps one FleetGroup's staging and stepping with per-tenant
    containment, hardening and fair-share control."""

    def __init__(self, group, cfg: dict):
        self.group = group
        self.threshold = int(cfg.get("guard_threshold", _DEF_THRESHOLD))
        self.cooldown_s = float(cfg.get("guard_cooldown_s", _DEF_COOLDOWN_S))
        self.readmit_batches = int(cfg.get("guard_readmit_batches",
                                           _DEF_READMIT_BATCHES))
        self.harden = bool(cfg.get("harden", True))
        self.dict_cap = int(cfg.get("dict_cap", _DEF_DICT_CAP))
        self.lanes: dict[int, TenantLane] = {}
        self.containments = 0       # contained group-step faults
        self.bisect_runs = 0        # subset replays during containment
        self._site = f"fleet:{group.shape_key}"
        self._shadow = None         # raw (si,row),ts,mid of the emitted batch
        self._shadow_lazy = None    # columnar capture (chunks, mid, stager)
        self._faulted: set[int] = set()   # chaos-faulted mids, current step
        # scalar replays DEFERRED out of the group lock: executing them
        # inline would acquire the culprit app's root_lock while holding
        # FleetGroup._lock — the reverse of the snapshot walk's
        # root_lock → group._lock order (ABBA deadlock). Items drain from
        # the owning app's OWN call paths (stage/flush), where the thread
        # holds at most that same app's root lock (re-entrant, no
        # cross-app coupling).
        self._deferred_scalar: list = []

    # -- membership ---------------------------------------------------------
    def attach(self, member) -> TenantLane:
        lane = TenantLane(member, self.threshold, self.cooldown_s)
        self.lanes[member.mid] = lane
        member.lane = lane
        fl = self._flight(member)
        if fl is not None:
            # the tenant's circuit transitions land on ITS app's timeline
            lane.breaker.listener = fl.breaker_listener(
                "breaker", f"fleet:{member.query_name}")
        return lane

    @staticmethod
    def _flight(member):
        return getattr(member.app_context, "flight", None)

    def _record_shed(self, member, lane: TenantLane) -> None:
        fl = self._flight(member)
        if fl is not None:
            # transition-recorded: a sustained shed storm is ONE timeline
            # entry per onset, not one per chunk
            fl.record_transition(
                "fleet", "shed", site=f"fleet:{member.query_name}",
                detail={"tenant": member.tenant, "shed_total": lane.shed})

    def adopt(self, member, lane: TenantLane) -> None:
        """Re-register an EXISTING lane under this guard (FleetGroup.split
        moves members between sibling groups; their breakers, shed/poison
        counters and solo tiers must survive the move)."""
        self.lanes[member.mid] = lane
        member.lane = lane

    def detach(self, member) -> None:
        self.lanes.pop(member.mid, None)

    # -- policy ejection (the SLO autopilot's actuator surface) -------------
    def policy_eject(self, member, reason: str) -> bool:
        """Controller-driven ejection to the solo tier — same mechanics as
        a fault ejection (private stager over the shared plan, state
        continuity) but with the auto-readmit path held until
        :meth:`policy_readmit` releases it. Caller holds the group lock."""
        lane = self.lanes.get(member.mid)
        if lane is None or member.ejected:
            return False
        lane.policy_hold = True
        self._eject(member, lane, PolicyEviction(reason))
        return True

    def policy_readmit(self, member) -> bool:
        """Release a policy hold and re-join the group immediately (state
        stepped solo through the shared plan, so re-entry needs no
        translation). Escalated lanes stay solo — the scalar tier owns
        their state (same one-way contract as fault escalation)."""
        lane = self.lanes.get(member.mid)
        if lane is None or not lane.policy_hold:
            return False
        lane.policy_hold = False
        if lane.escalated:
            return False
        if member.ejected:
            # drain the solo tier first (may itself auto-readmit now that
            # the hold is released — don't double-count that)
            self.flush_solo(member, lane, cause="policy-readmit")
        if member.ejected:
            member.ejected = False
            lane.readmissions += 1
            lane.eject_reason = None
            fl = self._flight(member)
            if fl is not None:
                fl.record("fleet", "readmitted",
                          site=f"fleet:{member.query_name}",
                          detail={"tenant": member.tenant, "policy": True})
        return True

    # -- staging: fair share + dictionary caps ------------------------------
    def admit(self, member, gsid: str, rows: list) -> int:
        """Stage-time gate for ``len(rows)`` incoming rows of one tenant:
        returns how many LEADING rows may stage (0..n). A tenant past its
        ``max_lag_events`` quota sheds its own tail (counted against the
        tenant only — the co-tenants' window is untouched); a tenant past
        its dictionary growth cap diverts the whole chunk before it can
        balloon the shared string tables. Runs under the group lock."""
        lane = self.lanes.get(member.mid)
        if lane is None:
            return len(rows)
        k = self._admit_quota(member, lane, len(rows))
        if k == 0:
            return 0
        if self.harden and not self._admit_dictionary(lane, gsid, rows[:k]):
            lane.poisoned += k
            return 0
        lane.staged_window += k
        return k

    def admit_columns(self, member, gsid: str, cols: dict, n: int) -> int:
        """Columnar twin of :meth:`admit`: quota on counts, dictionary
        growth metered over the chunk's string columns (distinct values via
        one vectorized pass per column) — the zero-object staging path
        keeps the full fair-share/dict-cap semantics."""
        lane = self.lanes.get(member.mid)
        if lane is None:
            return n
        k = self._admit_quota(member, lane, n)
        if k == 0:
            return 0
        if self.harden and \
                not self._admit_dictionary_columns(lane, gsid, cols, k):
            lane.poisoned += k
            return 0
        lane.staged_window += k
        return k

    def _admit_quota(self, member, lane, n: int) -> int:
        """max_lag fair-share quota: how many LEADING rows may stage."""
        k = n
        lane.observe_arrival(n)
        pq = lane.policy_quota
        if pq is not None:
            # SLO-autopilot shed: hard cap per flush window, no
            # step-to-open-a-new-window escape — the overflow drops
            allowed = pq - lane.staged_window
            if allowed <= 0:
                lane.shed += k
                self._record_shed(member, lane)
                return 0
            if allowed < k:
                lane.shed += k - allowed
                k = allowed
                self._record_shed(member, lane)
        if member.max_lag:
            fl = self._flight(member)
            allowed = member.max_lag - lane.staged_window
            if allowed <= 0 and len(self.group.stager):
                # quota exhausted for this window: STEP the group to open a
                # new one before shedding — the step itself is the
                # backpressure; shedding a lone tenant's traffic while the
                # engine sits idle would silently drop most of its stream
                self.group._step("quota")
                allowed = member.max_lag - lane.staged_window
            if allowed <= 0:
                # shed only the rows still in play (k, not n — the policy
                # quota above may already have shed and counted a prefix)
                lane.shed += k
                self._record_shed(member, lane)
                return 0
            if allowed < k:
                lane.shed += k - allowed
                k = allowed
                self._record_shed(member, lane)
            elif fl is not None:
                # the shed↔flowing flip is the recorded transition (the
                # device probe's step_ok/fallback pattern): without it a
                # second shed onset after recovery would dedupe away
                fl.record_transition("fleet", "flowing",
                                     site=f"fleet:{member.query_name}")
        return k

    def _admit_dictionary(self, lane: TenantLane, gsid: str,
                          rows: list) -> bool:
        """Per-tenant dictionary growth cap: count the distinct NEW strings a
        tenant's rows would mint in the SHARED tables; past the cap the
        tenant's rows divert before they can balloon co-tenants' memory."""
        scols = self._string_cols(gsid)
        if not scols:
            return True
        fresh = 0
        for pos, _name, dic in scols:
            # per-chunk distinct set first: a chunk re-sending the same few
            # symbols costs len(distinct) lookups, not len(rows). Malformed
            # rows (short, non-string in a string column) pass HERE — the
            # emit-time _diagnose_encode diverts them per row; this walk
            # only meters genuine new strings
            distinct = {r[pos] for r in rows
                        if pos < len(r) and isinstance(r[pos], str)}
            billed = self._bill_distinct(lane, dic, distinct)
            if billed is None:
                return False
            fresh += billed
        return self._close_billing(lane, fresh)

    def _admit_dictionary_columns(self, lane: TenantLane, gsid: str,
                                  cols: dict, k: int) -> bool:
        """Columnar twin of :meth:`_admit_dictionary`: distinct NEW strings
        metered per string column via one vectorized unique pass (codes for
        DictColumns — no per-row Python on the admit path)."""
        scols = self._string_cols(gsid)
        if not scols:
            return True
        from ..core.columns import DictColumn
        fresh = 0
        for _pos, name, dic in scols:
            col = cols.get(name)
            if col is None:
                continue
            if isinstance(col, DictColumn):
                codes = np.unique(col.codes[:k]).tolist()
                distinct = {col.values[c] for c in codes
                            if 0 <= c < len(col.values)}
            else:
                arr = col[:k] if isinstance(col, np.ndarray) \
                    else np.asarray(col[:k], dtype=object)
                vals = arr.tolist() if arr.dtype == object \
                    else np.unique(arr).tolist()
                distinct = set(vals)
            distinct = {v for v in distinct if isinstance(v, str)}
            billed = self._bill_distinct(lane, dic, distinct)
            if billed is None:
                return False
            fresh += billed
        return self._close_billing(lane, fresh)

    def _bill_distinct(self, lane: TenantLane, dic, distinct) -> \
            Optional[int]:
        """Bill a chunk's distinct strings against one shared table;
        None → the tenant is past its cap (divert the chunk)."""
        known = dic._codes
        fresh = 0
        for v in distinct:
            if v in known or v in lane.billed_strings:
                continue
            if lane.dict_capped:
                # past the cap: divert, but stop billing — the billed
                # set stays bounded by cap + one chunk, it must not
                # absorb the blow-up tenant's endless fresh strings
                return None
            lane.billed_strings.add(v)
            fresh += 1
        return fresh

    def _close_billing(self, lane: TenantLane, fresh: int) -> bool:
        if fresh == 0:
            return True
        lane.new_strings += fresh
        if lane.new_strings > self.dict_cap:
            if not lane.dict_capped:
                lane.dict_capped = True
                log.warning("%s: tenant '%s' exceeded its dictionary growth "
                            "cap (%d distinct strings); diverting its rows "
                            "with new strings", self._site,
                            lane.member.tenant, self.dict_cap)
            return False
        return True

    def _string_cols(self, gsid: str):
        """[(row position, attribute name, shared dictionary)] for
        ``gsid``'s string attrs."""
        group = self.group
        cache = getattr(self, "_scols_cache", None)
        if cache is None:
            cache = self._scols_cache = {}
        got = cache.get(gsid)
        if got is None:
            from ..query_api.definition import DataType
            schema = group.schema
            merged = getattr(schema, "stream_index", None) is not None
            si = schema.stream_index[gsid] if merged else 0
            d = group.stream_defs_for(gsid)
            got = []
            for pos, a in enumerate(d.attributes):
                if a.type != DataType.STRING:
                    continue
                key = f"s{si}_{a.name}" if merged else a.name
                dic = schema.dictionaries.get(key)
                if dic is not None:
                    got.append((pos, a.name, dic))
            cache[gsid] = got
        return got

    def fair_share_flush_due(self, member) -> bool:
        """True when ``member`` MONOPOLIZES the flush window while at least
        one co-tenant is waiting behind it — the group flushes early
        (``fair_share`` cause) so a firehose cannot hold idle tenants'
        latency hostage to the whole window. The trigger is the tenant's
        weighted share floored at half the window: balanced tenants
        crossing small per-tenant quotas together must NOT fragment the
        batch (their aggregate hits capacity at the same point anyway) —
        only a lane dominating the window alone trips this."""
        lane = self.lanes.get(member.mid)
        if lane is None:
            return False
        group = self.group
        window = group.effective_window()
        total_w = sum(m.weight for m in group.members.values()
                      if not m.ejected) or 1.0
        quota = max(1, int(window * member.weight / total_w))
        if lane.staged_window < max(quota, window // 2):
            return False
        # alone in the window: let it fill to capacity (no one is waiting)
        return any(l.staged_window > 0 and mid != member.mid
                   for mid, l in self.lanes.items())

    def on_window_reset(self) -> None:
        for lane in self.lanes.values():
            lane.staged_window = 0

    # -- the guarded step ---------------------------------------------------
    def capture_shadow(self, stager) -> None:
        """Stash the raw rows of the batch about to emit (the analog of
        DeviceGuard's _ShadowBuilder): a contained fault replays exactly
        these rows — culprit rows through the solo tier, innocents through
        the shared program. Columnar-staged chunks are captured as LAZY
        pointer copies (:meth:`_shadow_tuple` materializes rows only when
        a fault / non-finite sweep actually consumes the shadow — the
        happy path stays zero-object)."""
        if stager._col_chunks:
            self._shadow = None
            self._shadow_lazy = (list(stager._col_chunks),
                                 list(stager._mid), stager)
            return
        self._shadow_lazy = None
        self._shadow = (list(stager._rows), list(stager._ts),
                        list(stager._mid))

    def _shadow_tuple(self):
        """(rows, ts, mid) of the captured shadow, materializing a lazy
        columnar capture on first use; None when nothing is captured."""
        if self._shadow is None and self._shadow_lazy is not None:
            chunks, mids, stager = self._shadow_lazy
            rows, tss = stager.shadow_rows({"chunks": chunks})
            self._shadow = (rows, tss, mids)
            self._shadow_lazy = None
        return self._shadow

    def _clear_shadow(self) -> None:
        self._shadow = None
        self._shadow_lazy = None

    def emit(self, stager) -> dict:
        """``stager.emit()`` with dtype-mismatch diagnosis: a batch that
        fails to ENCODE is walked per tenant row against the stream defs and
        only the offending tenant's rows divert (HostRowStager.emit resets
        its buffers only on success, so the raw rows survive the failure).
        If the diagnosed batch STILL fails (a value that passes the type
        checks but not the encode — e.g. an out-of-int64-range int), the
        salvage pass isolates per member so one tenant's poison can never
        wedge the shared stager for the whole group."""
        self.capture_shadow(stager)
        try:
            return stager.emit()
        except Exception:  # noqa: BLE001 — containment boundary: diagnose
            # and divert the poison rows, the clean tenants' batch proceeds
            self._diagnose_encode(stager)
            try:
                return stager.emit()
            except Exception:  # noqa: BLE001 — same boundary, last rung
                return self._emit_salvage(stager)

    def _emit_salvage(self, stager) -> dict:
        """Per-member emit isolation: trial-encode each tenant's rows
        alone, keep the members whose sub-batches encode, divert (and
        count) the rest. The stager is ALWAYS left empty — an encode
        failure must never leave poison staged, or every later flush
        re-raises and the whole group wedges."""
        stager.ensure_rows()    # a failed columnar emit left chunks staged
        rows = list(stager._rows)
        tss = list(stager._ts)
        mids = list(stager._mid)
        stager._rows, stager._ts, stager._mid = [], [], []
        merged = getattr(self.group.schema, "stream_index", None) is not None
        sids = self.group.sids
        for mid in sorted(set(mids)):
            mine = [(sr, ts) for sr, ts, m in zip(rows, tss, mids)
                    if m == mid]
            trial = self.group.make_stager()
            for (si, row), ts in mine:
                trial.append(sids[si] if merged else sids[0], row, ts)
            try:
                trial.emit()
            except Exception:  # noqa: BLE001 — this member's rows are the
                # poison: divert them, the other tenants' rows re-stage
                lane = self.lanes.get(mid)
                if lane is not None:
                    lane.poisoned += len(mine)
                log.warning("%s: diverting %d unencodable row(s) of tenant "
                            "mid=%d (salvage pass)", self._site, len(mine),
                            mid)
                continue
            for (si, row), ts in mine:
                stager.append(sids[si] if merged else sids[0], row, ts)
                stager._mid.append(mid)
        self.capture_shadow(stager)
        return stager.emit()

    def _diagnose_encode(self, stager) -> None:
        from ..query_api.definition import DataType
        stager.ensure_rows()    # a failed columnar emit left chunks staged
        group = self.group
        schema = group.schema
        merged = getattr(schema, "stream_index", None) is not None
        sids = stager._sids if merged else [schema.definition.id]
        keep_rows, keep_ts, keep_mid = [], [], []
        for (si, row), ts, mid in zip(stager._rows, stager._ts, stager._mid):
            d = group.stream_defs_for(sids[si]) if merged \
                else schema.definition
            ok = len(row) >= len(d.attributes)
            if ok:
                for pos, a in enumerate(d.attributes):
                    v = row[pos]
                    if v is None:
                        continue
                    if a.type == DataType.STRING:
                        if not isinstance(v, str):
                            ok = False
                            break
                    elif isinstance(v, str) or not isinstance(
                            v, (int, float, np.number, bool)):
                        ok = False
                        break
            if ok:
                keep_rows.append((si, row))
                keep_ts.append(ts)
                keep_mid.append(mid)
            else:
                lane = self.lanes.get(mid)
                if lane is not None:
                    lane.poisoned += 1
                log.warning("%s: diverting a dtype-poisoned row of tenant "
                            "mid=%d", self._site, mid)
        stager._rows = keep_rows
        stager._ts = keep_ts
        stager._mid = keep_mid
        self.capture_shadow(stager)

    def sweep_nonfinite(self, b: dict, mids: torch.Tensor):
        """Vectorized non-finite sweep over the emitted float columns: rows
        carrying NaN/Inf divert to their tenant's error path before the
        shared program sees them. Returns the (possibly filtered)
        ``(batch, mids)``."""
        if not self.harden or b["count"] == 0:
            return b, mids
        bad = None
        for col in b["cols"].values():
            if col.is_floating_point():
                nf = ~torch.isfinite(col)
                if bool(nf.any()):
                    bad = nf if bad is None else (bad | nf)
        if bad is None or not bool(bad.any()):
            return b, mids
        for mid, n_bad in zip(*member_counts(mids[bad])):
            lane = self.lanes.get(int(mid))
            if lane is not None:
                lane.poisoned += n_bad
            log.warning("%s: diverting %d non-finite row(s) of tenant "
                        "mid=%d", self._site, n_bad, mid)
        keep = ~bad
        nb = {"cols": {k: v[keep] for k, v in b["cols"].items()},
              "tag": b["tag"][keep], "ts": b["ts"][keep],
              "count": int(keep.sum()),
              "last_ts": b["last_ts"]}
        sh = self._shadow_tuple()
        if sh is not None:
            rows, ts, smid = sh
            kl = keep.tolist()
            self._shadow = (
                [r for r, k in zip(rows, kl) if k],
                [t for t, k in zip(ts, kl) if k],
                [m for m, k in zip(smid, kl) if k])
        return nb, mids[keep]

    def _chaos_roll(self, mids: torch.Tensor) -> set:
        """Per-step chaos roll: each tenant's own ``@app:chaos
        (fleet.fault.p=…)`` injector targets that tenant's lanes (the
        app-scoped fault stays inside the app — co-tenant isolation is
        exactly what the guard must then prove). Rolled ONCE per group step
        so bisection replays observe a consistent fault."""
        faulted: set[int] = set()
        for mid in member_counts(mids)[0]:
            m = self.group.members.get(int(mid))
            if m is None or m.chaos is None:
                continue
            site = f"fleet:{m.tenant}/{m.query_name}"
            m.chaos._latency(site)
            if m.chaos.roll_fleet(site):
                faulted.add(int(mid))
        return faulted

    def step_batched(self, b: dict, mids: torch.Tensor) -> None:
        """Containment wraps only the COMPUTE phase (state + demux);
        delivery runs outside it, so a downstream receiver raising during
        delivery propagates like the unguarded path instead of being
        mistaken for a tenant-lane fault (re-running compute after a
        delivery fault would double-emit already-delivered tenants)."""
        group = self.group
        self._faulted = self._chaos_roll(mids)
        self.on_window_reset()
        try:
            try:
                if self._faulted:
                    raise ChaosFault(
                        f"chaos: fleet fault injected at {self._site} "
                        f"(mids {sorted(self._faulted)})")
                deliveries = group._compute_batched(b, mids)
            except Exception as e:  # noqa: BLE001 — containment boundary
                self._contain_batched(b, mids, e)
            else:
                self._note_success(member_counts(mids)[0])
                group._deliver_batched(deliveries)
        finally:
            self._clear_shadow()
            self._faulted = set()

    def _contain_batched(self, b: dict, mids: torch.Tensor,
                         err: Exception) -> None:
        """Bisect the merged batch over member-id subsets: innocent subsets
        deliver exactly once through the shared program, single-member
        failing subsets identify culprits (which eject and replay solo)."""
        self.containments += 1
        group = self.group
        culprits: list[int] = []
        deliveries: list = []

        def run_subset(subset: list) -> None:
            if any(mid in self._faulted for mid in subset):
                raise ChaosFault("chaos: fleet fault (bisect replay)")
            mask = torch.isin(mids, torch.tensor(subset, dtype=mids.dtype))
            sub = {"cols": {k: v[mask] for k, v in b["cols"].items()},
                   "tag": b["tag"][mask], "ts": b["ts"][mask],
                   "count": int(mask.sum()), "last_ts": b["last_ts"]}
            self.bisect_runs += 1
            deliveries.extend(group._compute_batched(sub, mids[mask]))

        def bisect(subset: list) -> None:
            if len(subset) == 1:
                culprits.append(subset[0])
                return
            half = len(subset) // 2
            for part in (subset[:half], subset[half:]):
                if not part:
                    continue
                try:
                    run_subset(part)
                except Exception:  # noqa: BLE001 — keep narrowing
                    bisect(part)

        involved = member_counts(mids)[0]
        if len(involved) == 1:
            culprits = involved
        else:
            bisect(involved)
        innocents = [mid for mid in involved if mid not in culprits]
        self._note_success(innocents)
        log.warning("%s: contained a shared-step fault to tenant lane(s) "
                    "%s (%d innocent lane(s) replayed): %s", self._site,
                    culprits, len(innocents), err)
        for mid in culprits:
            self._record_fault(int(mid), err)
        # innocents' outputs deliver OUTSIDE containment, after the
        # culprits' solo replays queued at their own slot
        group._deliver_batched(deliveries)

    def step_segment(self, m, cols_m: dict, tag_m, ts_m) -> None:
        """One member's sliced segment under containment: the faulting
        segment IS the culprit (no bisection needed) and earlier/later
        members' segments are untouched. Only the state-advancing compute
        is contained; delivery faults propagate like the unguarded path."""
        if m.mid in self._faulted:
            self.containments += 1
            self._record_fault(m.mid, ChaosFault(
                f"chaos: fleet fault injected at {self._site}"))
            return
        try:
            out = self.group._compute_segment(m, cols_m, tag_m, ts_m)
        except Exception as e:  # noqa: BLE001 — containment boundary
            self.containments += 1
            log.warning("%s: contained a sliced-step fault to tenant '%s'",
                        self._site, m.tenant)
            self._record_fault(m.mid, e)
            return
        lane = self.lanes.get(m.mid)
        if lane is not None and \
                lane.breaker.state != CircuitState.CLOSED:
            lane.breaker.record_success()
        self.group._deliver_segment(m, out)

    def begin_sliced_step(self, mids: torch.Tensor) -> None:
        self._faulted = self._chaos_roll(mids)
        self.on_window_reset()

    def end_sliced_step(self) -> None:
        self._clear_shadow()
        self._faulted = set()

    def _note_success(self, mids) -> None:
        for mid in mids:
            lane = self.lanes.get(int(mid))
            if lane is not None and \
                    lane.breaker.state != CircuitState.CLOSED:
                lane.breaker.record_success()

    # -- fault → eject ------------------------------------------------------
    def _record_fault(self, mid: int, err: Exception) -> None:
        m = self.group.members.get(mid)
        lane = self.lanes.get(mid)
        if m is None or lane is None:
            return
        lane.breaker.record_failure()
        if lane.breaker.state == CircuitState.OPEN and not m.ejected:
            self._eject(m, lane, err)
        # the failed batch's rows for this tenant replay through its solo
        # tier AT THIS POINT in the stream — after every earlier batch, so
        # per-tenant order is preserved
        self._replay_shadow(m, lane)

    def _eject(self, m, lane: TenantLane, err: Exception) -> None:
        group = self.group
        lane.ejections += 1
        lane.solo_batches = 0
        lane.eject_reason = f"{type(err).__name__}: {err}"
        m.ejected = True
        if lane.solo_stager is None:
            lane.solo_stager = group.make_stager()
        log.warning("%s: tenant '%s' (query '%s') ejected to its solo tier "
                    "after %d consecutive fault(s): %s", self._site,
                    m.tenant, m.query_name,
                    lane.breaker.consecutive_failures, err)
        fl = self._flight(m)
        if fl is not None:
            fl.record("fleet", "ejected", site=f"fleet:{m.query_name}",
                      detail={"tenant": m.tenant,
                              "reason": lane.eject_reason[:200]})
            fl.on_fault("fleet_ejection", site=f"fleet:{m.query_name}")

    def _replay_shadow(self, m, lane: TenantLane) -> None:
        sh = self._shadow_tuple()
        if sh is None:
            return
        rows, tss, smid = sh
        mine = [(si_row, ts) for si_row, ts, mid in zip(rows, tss, smid)
                if mid == m.mid]
        if not mine:
            return
        if not m.ejected:
            # breaker below threshold: replay through the solo path anyway
            # (state continuity holds — solo steps the member's own state
            # through the shared plan), the tenant stays in the group
            if lane.solo_stager is None:
                lane.solo_stager = self.group.make_stager()
        stager = lane.solo_stager
        merged = getattr(self.group.schema, "stream_index", None) is not None
        sids = self.group.sids
        for (si, row), ts in mine:
            stager.append(sids[si] if merged else sids[0], row, ts)
        self.flush_solo(m, lane, cause="containment")

    # -- the solo tier ------------------------------------------------------
    def solo_stage(self, m, gsid: str, rows: list, timestamps) -> None:
        """Ejected-tenant ingress: rows stage into the member's PRIVATE
        stager (shared schema/dictionaries, so state and codes stay
        group-compatible) and step alone at the group's flush points."""
        lane = self.lanes.get(m.mid)
        if lane is None:
            return
        lane.observe_arrival(len(rows))
        if lane.solo_stager is None:
            lane.solo_stager = self.group.make_stager()
        lane.solo_stager.append_rows(gsid, rows, timestamps)
        if lane.solo_stager.full:
            self.flush_solo(m, lane, cause="capacity")

    def flush_solo(self, m, lane: TenantLane, cause: str = "drain") -> None:
        stager = lane.solo_stager
        if stager is None or len(stager) == 0:
            self._maybe_readmit(m, lane)
            return
        shadow = (list(stager._rows), list(stager._ts))
        try:
            b = stager.emit()
        except Exception:  # noqa: BLE001 — poison reached the solo stager
            lane.escalated = True
            self._scalar_replay(m, lane, shadow)
            stager._rows, stager._ts = [], []
            if hasattr(stager, "_mid"):
                stager._mid = []
            self.group._drain_traces(m, 0, outcome="scalar")
            return
        if b["count"] == 0:
            return
        n = b["count"]
        if lane.escalated:
            # already escalated: the scalar interpreter is the tier
            self._scalar_replay(m, lane, shadow)
            self._after_solo_batch(m, lane, n)
            return
        from ..fleet.group import _torch_batch
        from ..gpu.host_exec import one_intraop_thread
        b = _torch_batch(b)
        cols = dict(b["cols"])
        self.group._inject_member_params(cols, m, n)
        try:
            with one_intraop_thread():
                self.group._run_segment(m, cols, b["tag"], b["ts"])
        except Exception as e:  # noqa: BLE001 — escalate down the ladder:
            # the shared columnar plan faults for this tenant even alone,
            # so the scalar interpreter takes over (fresh state, same
            # caveat as DeviceGuard's quarantine parity note)
            log.warning("%s: tenant '%s' solo columnar step failed (%s); "
                        "escalating to the scalar interpreter", self._site,
                        m.tenant, e)
            lane.escalated = True
            self._scalar_replay(m, lane, shadow)
        self._after_solo_batch(m, lane, n)

    def _after_solo_batch(self, m, lane: TenantLane, n: int) -> None:
        lane.solo_events += n
        lane.solo_batches += 1
        # pending sampled traces close with a solo-tier span (the X-Ray
        # handoff contract: every hop stamps its span, fallback included)
        self.group._drain_traces(m, n, outcome="solo")
        self._maybe_readmit(m, lane)

    def _maybe_readmit(self, m, lane: TenantLane) -> None:
        if not m.ejected or lane.solo_batches < self.readmit_batches:
            return
        if lane.policy_hold:
            # the SLO autopilot ejected this lane deliberately: it comes
            # back when the controller releases the hold, not on the
            # fault-recovery clock
            return
        if lane.escalated:
            # the ladder's bottom is one-way: the scalar interpreter owns
            # its OWN state, so member.state stopped seeing events at the
            # escalation point — re-admitting would resurrect that stale
            # state into the group. The tenant stays scalar-solo (visible
            # as solo_engine='scalar' in the guard report) until redeployed.
            return
        if not lane.breaker.allow():        # cool-down still running
            return
        # half-open probe: back into the group; a clean group step
        # re-closes the circuit, a fault re-ejects with a fresh cool-down.
        # State carried over in place (member.state/member.prt stepped solo
        # through the shared plan) — the snapshot path is
        # FleetGroup.snapshot via member_state/restore_member_state.
        m.ejected = False
        lane.readmissions += 1
        lane.eject_reason = None
        log.info("%s: tenant '%s' re-admitted to the fleet group after %d "
                 "clean solo batches", self._site, m.tenant,
                 lane.solo_batches)
        fl = self._flight(m)
        if fl is not None:
            fl.record("fleet", "readmitted", site=f"fleet:{m.query_name}",
                      detail={"tenant": m.tenant,
                              "clean_solo_batches": lane.solo_batches})

    def _scalar_replay(self, m, lane: TenantLane, shadow) -> None:
        """Queue the shadow for scalar replay — NEVER executed under the
        group lock (see ``_deferred_scalar``). FIFO per guard, so a
        tenant's replays stay ordered relative to each other."""
        self._deferred_scalar.append((m, lane, shadow))

    def drain_deferred(self, app_context) -> None:
        """Run the queued scalar replays belonging to ``app_context`` —
        called by the group AFTER releasing its lock, from call paths of
        that same app (its ingress or its bridge flush), so the root_lock
        acquisition nests only within the app's own lock."""
        if not self._deferred_scalar:
            return
        keep, mine = [], []
        for item in self._deferred_scalar:
            (mine if item[0].app_context is app_context
             else keep).append(item)
        self._deferred_scalar = keep
        for m, lane, shadow in mine:
            self._scalar_replay_now(m, lane, shadow)

    def _scalar_replay_now(self, m, lane: TenantLane, shadow) -> None:
        rt = self._scalar_runtime(m, lane)
        if rt is None:
            lane.lost += len(shadow[0])
            return
        local = m.local_sids
        delivered, lost = replay_rows_scalar(
            rt, lambda si: local[si] if si < len(local) else local[0],
            shadow[0], shadow[1], m.app_context.root_lock,
            f"{self._site}/{m.tenant}")
        lane.solo_events += delivered
        lane.lost += lost

    def _scalar_runtime(self, m, lane: TenantLane):
        if lane.scalar_rt is not None:
            return lane.scalar_rt
        if m.query is None:
            return None
        rt = build_scalar_escalation(
            m.query, m.app_context, m.solo_stream_defs, m.get_junction,
            f"{m.query_name}__fleetfb",
            m.bridge.query_callbacks if m.bridge is not None else None,
            f"{self._site}/{m.tenant}")
        if rt is None:
            return None
        lane.scalar_rt = rt
        lane.scalar_receivers = rt.subscriptions
        return rt

    # -- introspection ------------------------------------------------------
    def report(self) -> dict:
        return {
            "threshold": self.threshold,
            "cooldown_s": self.cooldown_s,
            "readmit_batches": self.readmit_batches,
            "harden": self.harden,
            "containments": self.containments,
            "bisect_runs": self.bisect_runs,
            "ejected": sorted(l.member.tenant for l in self.lanes.values()
                              if l.ejected),
            "tenants": [l.report() for l in self.lanes.values()],
        }


# ---------------------------------------------------------------------------
# host-batch tier containment (the third shared-execution step entry point)
# ---------------------------------------------------------------------------

class HostStepGuard:
    """Containment for the columnar host tier (``core/host_bridge.py``): a
    failing micro-batch step replays its raw rows through a lazily built
    scalar interpreter runtime (zero loss), and repeated failures quarantine
    the columnar path behind a circuit breaker — the per-query analog of
    DeviceGuard, one tier down. Installed by ``ResilienceSubsystem.
    guard_host`` over every host-batch bridge."""

    def __init__(self, bridge, query, app_context, stream_defs: dict,
                 get_junction, failure_threshold: int = 3,
                 cooldown_s: float = 30.0):
        self.bridge = bridge
        self.query = query
        self.app_context = app_context
        self.stream_defs = dict(stream_defs)
        self.get_junction = get_junction
        self.breaker = CircuitBreaker(failure_threshold, cooldown_s)
        self.query_name = bridge.query_name
        self._site = f"host_batch:{app_context.name}/{bridge.query_name}"
        self.flight = None          # FlightRecorder (observability wiring)
        self.failures = 0
        self.fallback_events = 0
        self.lost_events = 0
        self._fb_runtime = None
        self._fb_lock = threading.Lock()

    def install(self) -> None:
        rt = self.bridge.runtime
        inner_flush = rt.flush
        guard = self

        def flush():
            builder = rt.builder
            if len(builder) == 0:
                return inner_flush()
            # shallow shadow: pointer copies only (row lists OR whole
            # column chunks — builder.shadow() keeps the columnar staging
            # zero-object; rows materialize only on the failure path)
            if not guard.breaker.allow():
                # columnar path quarantined: drain straight to the scalar
                # interpreter without touching the failing engine
                shadow = builder.shadow()
                builder.clear()
                guard._fallback(shadow, quarantined=True)
                return None
            shadow = builder.shadow()
            try:
                out = inner_flush()
            except Exception as e:  # noqa: BLE001 — quarantine boundary:
                # the failed micro-batch reroutes to the scalar path
                guard.failures += 1
                was_open = guard.breaker.state == CircuitState.OPEN
                guard.breaker.record_failure()
                log.warning("%s: columnar step failed (%d consecutive, "
                            "circuit %s): %s", guard._site,
                            guard.breaker.consecutive_failures,
                            guard.breaker.state, e, exc_info=True)
                fl = guard.flight
                if fl is not None:
                    fl.record("host", "step_failed", site=guard.query_name,
                              detail={"error":
                                      f"{type(e).__name__}: {e}"[:200]})
                    if not was_open and \
                            guard.breaker.state == CircuitState.OPEN:
                        fl.record("host", "quarantined",
                                  site=guard.query_name)
                        fl.on_fault("host_quarantine",
                                    site=guard.query_name)
                # an EMIT-time failure (encode of a poison row) leaves the
                # rows staged (the stager resets only on success) — clear
                # them, or every later flush would fail again and re-replay
                # the same shadow, duplicating outputs
                builder.clear()
                guard._fallback(shadow)
                return None
            guard.breaker.record_success()
            return out

        rt.flush = flush

    def _fallback(self, shadow: dict, quarantined: bool = False) -> None:
        rows, tss = self.bridge.runtime.builder.shadow_rows(shadow)
        if not rows:
            return
        rt = self._fallback_runtime()
        if rt is None:
            self.lost_events += len(rows)
            return
        sids = self.bridge.stream_ids
        delivered, lost = replay_rows_scalar(
            rt, lambda si: sids[si] if si < len(sids) else sids[0],
            rows, tss, self.app_context.root_lock, self._site)
        self.fallback_events += delivered
        self.lost_events += lost
        log.info("%s: %d event(s) rerouted through the scalar "
                 "interpreter%s", self._site, delivered,
                 " (columnar quarantined)" if quarantined else "")

    def _fallback_runtime(self):
        if getattr(self.bridge, "kind", "") == "host_partition":
            # a partition-block pattern replayed through a plain scalar
            # runtime would match ACROSS keys — wrong results are worse
            # than counted loss, so the ladder stops here
            return None
        with self.app_context.root_lock:
            with self._fb_lock:
                if self._fb_runtime is None:
                    self._fb_runtime = build_scalar_escalation(
                        self.query, self.app_context, self.stream_defs,
                        self.get_junction, f"{self.query_name}__hostfb",
                        self.bridge.query_callbacks, self._site)
                return self._fb_runtime

    def report(self) -> dict:
        return {
            "query": self.query_name,
            "circuit": self.breaker.state,
            "failures": self.failures,
            "fallback_events": self.fallback_events,
            "lost_events": self.lost_events,
        }
