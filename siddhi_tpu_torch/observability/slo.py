"""SLO autopilot: close the loop from X-Ray phase attribution to the
control plane.

The port's copy of the JAX package's ``observability/slo.py``. The phase
attribution makes every micro-batch's latency legible — measured phases
that reconcile against end-to-end, per-tenant arrival EMAs, an always-on
flight recorder — and the fleet tier has the actuators: AIMD window sizing,
fair-share shedding, eject/readmit. This module connects observation to
actuation, for the shared-lane fleet tier where most tenants live:

- **SLO classes** — tenants declare ``@app:fleet(slo.p99.ms='50',
  slo.class='premium'|'standard'|'besteffort')``. The budget is an
  end-to-end p99 detection-latency target for the tenant's shared window;
  the class orders who absorbs pain when budgets and capacity conflict
  (2401.09960's policy-driven elasticity: best-effort absorbs, premium is
  protected).

- **Windowed evidence** — the controller samples *interval* snapshots of
  the group's phase histograms (:meth:`LogHistogram.since`): cumulative-
  since-start percentiles flatten as history accumulates and cannot drive
  control. Each evaluation reads the p99 of the window since the last
  decision, names the guilty phase (``fill_wait`` vs the step — which is
  ``host_exec`` on the columnar tier, ``device_step`` on the device
  tier), and moves exactly one knob.

- **The actuator ladder** — fill-wait dominating with a noisy best-effort
  neighbour dominating arrivals → *shed* the neighbour (tighten its
  fair-share quota through the existing FleetGuard admit path: its own
  overflow drops, co-tenants untouched); fill-wait dominating otherwise →
  *shrink* the flush window (capping the AIMD controller so the two
  loops cannot fight); the step dominating with multiple lanes → *split*
  the fleet group (:meth:`FleetGroup.split` — half the lanes per step);
  a shed-held neighbour still sinking the budget → *eject* it to the solo
  tier via the FleetGuard policy path. Recovery walks the same ladder in
  reverse (readmit → restore quotas → grow the window), each step gated
  by a longer cooldown than the tightening side — the hysteresis that
  keeps actuators from fighting.

- **Every decision is evidence first** — each actuation records the
  guilty phase, measured p99 vs the declared budget, and the chosen
  actuator (with its from→to effect) to EVERY member app's flight
  recorder *before* moving the knob. ``scripts/check_guard_coverage.py``
  pins this structurally: actuators are reachable only through
  :meth:`SLOController._actuate`, which records before it dispatches.

Compliance is exported as ``siddhi_tpu_slo_*`` gauges and served at
``GET /siddhi-apps/{name}/slo``; the chaos soak
(tests/test_slo.py + bench ``--slo-child``) proves a 10×-share burst
tenant leaves premium p99 in budget while best-effort absorbs the
shedding.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

from .histogram import LogHistogram

log = logging.getLogger("siddhi_tpu_torch.observability")

CLASSES = ("besteffort", "standard", "premium")
CLASS_CODES = {"besteffort": 0, "standard": 1, "premium": 2}

# controller defaults (overridable via @app:fleet slo.* keys of the
# group's first enrolling tenant)
_DEF_INTERVAL_MS = 250.0     # min wall-clock between evaluations
_DEF_COOLDOWN_MS = 1000.0    # min wall-clock between actuations (tighten)
_DEF_WINDOW_MIN = 256        # the shrink ladder's floor
_DEF_DOMINANCE = 0.25        # arrival share that marks a noisy neighbour
_RELAX_FACTOR = 4.0          # relax cooldown = tighten cooldown × this
_BAD_WINDOW_TTL = 64.0       # cooldowns before a violated window size is
# forgiven (load profiles drift; a ceiling must not outlive its evidence)
_MAX_BACKOFF = 64.0


class TenantSLO:
    """One tenant lane's declared SLO + live compliance readout (the
    ``siddhi_tpu_slo_*`` gauge surface reads these fields)."""

    def __init__(self, member, p99_budget_ms: Optional[float],
                 slo_class: str = "standard"):
        if slo_class not in CLASSES:
            raise ValueError(
                f"unknown slo.class '{slo_class}' (known: {CLASSES})")
        self.member = member
        self.p99_budget_ms = p99_budget_ms
        self.slo_class = slo_class
        self.class_code = CLASS_CODES[slo_class]
        self.compliant = True
        self.last_p99_ms = 0.0      # windowed p99 at the last evaluation
        self.shed_hold = False      # quota tightened by the controller
        self.policy_ejected = False

    def report(self) -> dict:
        return {
            "query": self.member.query_name,
            "tenant": self.member.tenant,
            "class": self.slo_class,
            "p99_budget_ms": self.p99_budget_ms,
            "p99_window_ms": round(self.last_p99_ms, 3),
            "compliant": self.compliant,
            "shed_hold": self.shed_hold,
            "policy_ejected": self.policy_ejected,
        }


class GroupEvidence:
    """Per-group windowed phase attribution for the shared flush window.

    Every stepped window records its two serial segments — the fill span's
    per-event average (span/2, the phases.py convention) and the step
    itself — plus their sum as end-to-end, into always-on
    :class:`LogHistogram` ladders. :meth:`window` reads the interval since
    the last :meth:`advance` — the windowed view a control loop needs.
    """

    PHASES = ("fill_wait", "step", "end_to_end")

    def __init__(self):
        self.hist = {p: LogHistogram() for p in self.PHASES}
        self._chk = {p: h.checkpoint() for p, h in self.hist.items()}
        self.steps = 0

    def observe(self, n: int, fill_span_s: float, step_s: float) -> None:
        if n <= 0:
            return
        self.steps += 1
        fill_avg = max(0.0, fill_span_s) / 2.0
        step_s = max(0.0, step_s)
        self.hist["fill_wait"].record(fill_avg, n)
        self.hist["step"].record(step_s, n)
        self.hist["end_to_end"].record(fill_avg + step_s, n)

    def window(self) -> dict:
        """Interval snapshot per phase since the last :meth:`advance`
        (does NOT advance — an evaluation that declines to act keeps
        accumulating the same window)."""
        return {p: h.since(self._chk[p]) for p, h in self.hist.items()}

    def advance(self) -> None:
        self._chk = {p: h.checkpoint() for p, h in self.hist.items()}

    def report(self) -> dict:
        return {p: h.snapshot() for p, h in self.hist.items()}


class SLOController:
    """One fleet group's closed loop: windowed evidence in, one actuator
    move out, every decision on the flight recorder first.

    Evaluations are driven from the group's staging paths AFTER the group
    lock is released (the ``_drain_guard`` pattern), so actuation can take
    ``manager._lock → group._lock`` in the enrollment order without
    inversion. ``interval_ms`` rate-limits the evaluation itself to one
    wall-clock probe per chunk in the common case.
    """

    def __init__(self, group, manager, cfg: dict):
        self.group = group
        self.manager = manager
        self.cfg = dict(cfg)
        self.interval_s = float(cfg.get("slo_interval_ms",
                                        _DEF_INTERVAL_MS)) / 1e3
        self.cooldown_s = float(cfg.get("slo_cooldown_ms",
                                        _DEF_COOLDOWN_MS)) / 1e3
        self.window_min = int(cfg.get("slo_window_min", _DEF_WINDOW_MIN))
        self.dominance = float(cfg.get("slo_dominance", _DEF_DOMINANCE))
        self.evidence = GroupEvidence()
        self.tenants: dict = {}          # FleetMember -> TenantSLO
        self.relax_evals = int(cfg.get("slo_relax_evals", 3))
        self.decisions = 0
        self.evaluations = 0
        self.last_guilty: Optional[str] = None
        self._compliant_evals = 0        # consecutive in-budget evaluations
        # hysteresis memory: a window size that violated recently is a
        # ceiling the grow rung must stay strictly under (forgotten after
        # _BAD_WINDOW_TTL cooldowns — load changes), and relaxes that get
        # punished by a fresh violation back off exponentially
        self._bad_window: Optional[int] = None
        self._bad_window_t = 0.0
        self._relax_backoff = 1.0
        self._last_relax_action_t = 0.0
        self._relax_ok = True
        self.decision_log: deque = deque(maxlen=64)
        # the cross-host rung (the mesh fabric arms it):
        # a MeshFabric sets this to its escalation callback, and the
        # exhausted ladder gains a final actuator — re-place the violating
        # tenant on another host's group (the JAX package's mesh fabric;
        # the port's comes with distribution)
        self.mesh_hook = None
        self._last_eval_t = 0.0
        self._last_act_t = 0.0           # tighten-side cooldown
        self._last_relax_t = 0.0         # relax-side cooldown (longer)
        self._lock = threading.Lock()    # one evaluator at a time
        from ..fleet.group import GroupFlight
        self.flight = GroupFlight(group)
        self._site = f"slo:{group.shape_key[:40]}"

    # -- membership ---------------------------------------------------------
    def attach(self, member, slo: TenantSLO) -> None:
        self.tenants[member] = slo
        member.slo = slo

    def detach(self, member) -> None:
        self.tenants.pop(member, None)

    # -- evidence (called under the group lock — cheap, histogram-locked) ----
    def on_step(self, n: int, fill_span_s: float, step_s: float) -> None:
        self.evidence.observe(n, fill_span_s, step_s)

    # -- the loop -----------------------------------------------------------
    def maybe_evaluate(self, force: bool = False) -> Optional[dict]:
        """Rate-limited entry point (one monotonic read per call when the
        interval has not elapsed). Runs OUTSIDE the group lock."""
        now = time.monotonic()
        if not force and now - self._last_eval_t < self.interval_s:
            return None
        if not self._lock.acquire(blocking=False):
            return None                  # another thread is evaluating
        try:
            self._last_eval_t = now
            return self._evaluate(now, force)
        except Exception:  # noqa: BLE001 — the control loop rides every
            # tenant's ingress path: a controller bug must degrade to "no
            # decision", never abort a healthy send()
            log.exception("%s: evaluation failed", self._site)
            return None
        finally:
            self._lock.release()

    @staticmethod
    def _snap(view) -> list:
        """Tolerant copy of a concurrently-mutated dict view: evaluation
        holds NO engine lock (by design — see maybe_evaluate), so
        enrollment/removal can resize ``group.members``/``tenants``
        mid-iteration. A torn read costs one retry, never an error."""
        for _ in range(4):
            try:
                return list(view)
            except RuntimeError:
                continue
        return []

    def _evaluate(self, now: float, force: bool) -> Optional[dict]:
        win = self.evidence.window()
        if win["end_to_end"]["count"] == 0:
            return None                  # no stepped window yet: no evidence
        self.evaluations += 1
        p99_ms = win["end_to_end"]["p99"] * 1e3
        violated = None
        for slo in sorted(self._snap(self.tenants.values()),
                          key=lambda t: -t.class_code):
            if slo.p99_budget_ms is None:
                continue
            slo.last_p99_ms = p99_ms     # shared window = shared latency
            over = p99_ms > slo.p99_budget_ms
            slo.compliant = not over
            # the compliance flip is its own timeline entry (deduped per
            # tenant site), so recoveries are as legible as violations
            self.flight.record_transition(
                "slo", "violating" if over else "in_budget",
                site=f"slo:{slo.member.query_name}",
                detail={"p99_ms": round(p99_ms, 3),
                        "budget_ms": slo.p99_budget_ms})
            if over and violated is None:
                violated = slo           # highest class first: its budget
                # picks the actuator (premium pain outranks best-effort)
        if violated is None:
            self._compliant_evals += 1
            decision = self._relax_decision(win, now)
        else:
            self._compliant_evals = 0
            # remember the operating point that failed: the grow rung may
            # not walk back INTO it while the memory is fresh
            self._bad_window = self.group.effective_window()
            self._bad_window_t = now
            if now - self._last_relax_action_t <= \
                    self.cooldown_s * _RELAX_FACTOR * 2:
                # this violation punishes a recent relax: back off the
                # relax side exponentially so probing gets rarer, not
                # periodic (the grow→violate→shrink flap killer)
                self._relax_backoff = min(self._relax_backoff * 2,
                                          _MAX_BACKOFF)
                self._relax_ok = False
            decision = self._tighten_decision(violated, win, p99_ms, now)
        if decision is None:
            return None
        self._actuate(decision)
        self.evidence.advance()          # the next window judges the move
        return decision

    # -- decision procedure --------------------------------------------------
    def _guilty_phase(self, win: dict) -> str:
        """The phase that owns the tail of this window. ``step`` reads as
        ``host_exec`` on the columnar tier / ``device_step`` on device."""
        return "fill_wait" if win["fill_wait"]["p99"] >= win["step"]["p99"] \
            else "step"

    def _besteffort_lanes(self) -> list:
        return [(m, t) for m, t in self._snap(self.tenants.items())
                if t.slo_class == "besteffort"]

    def _dominant_neighbour(self, exclude_held: bool = True):
        """The best-effort tenant whose arrival rate dominates the group's
        mix (> ``dominance`` share and > 3× its weighted fair share) — the
        noisy neighbour the shed actuator targets."""
        group = self.group
        lanes = [(m, m.lane) for m in self._snap(group.members.values())
                 if m.lane is not None and not m.ejected]
        total = sum(l.arrival_evps for _, l in lanes)
        if total <= 0.0:
            return None
        total_w = sum(m.weight for m, _ in lanes) or 1.0
        best = None
        for m, t in self._besteffort_lanes():
            if m.ejected or m.lane is None:
                continue
            if exclude_held and t.shed_hold:
                continue
            share = m.lane.arrival_evps / total
            fair = m.weight / total_w
            if share > max(self.dominance, 3.0 * fair) and \
                    (best is None or share > best[2]):
                best = (m, t, share)
        return best

    def _tighten_decision(self, slo: TenantSLO, win: dict, p99_ms: float,
                          now: float) -> Optional[dict]:
        if now - self._last_act_t < self.cooldown_s:
            return None                  # actuator cooldown: hysteresis
        guilty = self._guilty_phase(win)
        self.last_guilty = guilty
        base = {"guilty_phase": guilty, "p99_ms": round(p99_ms, 3),
                "budget_ms": slo.p99_budget_ms,
                "tenant": slo.member.tenant,
                "query": slo.member.query_name,
                "window_events": win["end_to_end"]["count"]}
        window = self.group.effective_window()
        noisy = self._dominant_neighbour()
        if noisy is not None:
            # the noisy neighbour IS the cause: shed its overflow through
            # the fair-share admit path before punishing everyone's window
            m, t, share = noisy
            return {"actuator": "shed_besteffort", "member": m,
                    **base, "arrival_share": round(share, 3)}
        if guilty == "step" and not self._split_exhausted():
            return {"actuator": "split_group", **base,
                    "members": len(self.group.members)}
        if window > self.window_min:
            return {"actuator": "shrink_window", **base,
                    "from": window,
                    "to": max(self.window_min, window // 2)}
        held = [(m, t) for m, t in self._besteffort_lanes()
                if t.shed_hold and not t.policy_ejected]
        if held:
            # shed quota was not enough: the solo tier takes the neighbour
            m, t = held[0]
            return {"actuator": "eject_besteffort", "member": m, **base}
        if self.mesh_hook is not None:
            # the in-process ladder ran out but the mesh can still move
            # load: re-place the violating tenant on another host's group
            return {"actuator": "mesh_replace", **base}
        # the ladder ran out — record it (an operator reading the timeline
        # must see the controller is at its limits, not asleep)
        return {"actuator": "exhausted", **base}

    def _split_exhausted(self) -> bool:
        active = [m for m in self._snap(self.group.members.values())
                  if not m.ejected]
        return len(active) < 2

    def _min_budget_ms(self) -> Optional[float]:
        budgets = [t.p99_budget_ms
                   for t in self._snap(self.tenants.values())
                   if t.p99_budget_ms is not None]
        return min(budgets) if budgets else None

    def _relax_decision(self, win: dict, now: float) -> Optional[dict]:
        """In budget: walk the ladder back one rung — readmit
        policy-ejected lanes, then restore shed quotas, then grow the
        window toward capacity. Relaxing is deliberately harder than
        tightening: it needs ``relax_evals`` CONSECUTIVE compliant
        evaluations, a longer cooldown, AND (for the window) feed-forward
        headroom — doubling the window doubles the fill wait, so the
        predicted p99 at the doubled window must still clear the
        strictest budget with margin. Without these gates the loop flaps:
        grow → violate → shrink → grow."""
        if self._compliant_evals < self.relax_evals:
            return None
        if now - self._last_relax_t < \
                self.cooldown_s * _RELAX_FACTOR * self._relax_backoff:
            return None
        base = {"guilty_phase": None, "p99_ms": None, "budget_ms": None}
        budget = self._min_budget_ms()
        fill_p99_ms = win["fill_wait"]["p99"] * 1e3
        step_p99_ms = win["step"]["p99"] * 1e3
        headroom = budget is None or \
            2.0 * fill_p99_ms + step_p99_ms <= budget * 0.8
        for m, t in self._besteffort_lanes():
            if t.policy_ejected and headroom:
                lane = m.lane
                if lane is not None and lane.escalated:
                    # the scalar tier owns this lane's state one-way (the
                    # guard will refuse the readmit): stop proposing it,
                    # or this rung blocks the rest of the ladder forever
                    t.policy_ejected = False
                    continue
                return {"actuator": "readmit_besteffort", "member": m,
                        **base}
        for m, t in self._besteffort_lanes():
            # restoring a shed neighbour re-admits its full burst: demand
            # the same doubled-load headroom the window grow needs
            if t.shed_hold and headroom:
                return {"actuator": "restore_shed", "member": m, **base}
        group = self.group
        if group.slo_window is not None and headroom:
            cur = group.slo_window
            to = min(group.capacity, cur * 2)
            if self._bad_window is not None and to >= self._bad_window \
                    and now - self._bad_window_t <= \
                    self.cooldown_s * _BAD_WINDOW_TTL:
                return None     # that size violated recently: stay under it
            return {"actuator": "grow_window", **base,
                    "from": cur, "to": to}
        return None

    # -- actuation (decision recorded BEFORE the knob moves) -----------------
    _TIGHTENERS = ("shrink_window", "shed_besteffort", "split_group",
                   "eject_besteffort", "mesh_replace", "exhausted")

    def _actuate(self, decision: dict) -> None:
        """THE single actuation gate: records the decision with its
        evidence to every member app's flight recorder, THEN dispatches.
        ``scripts/check_guard_coverage.py`` pins (a) record-before-
        dispatch here and (b) that no ``_act_*`` method is called from
        anywhere else."""
        self._record_decision(decision)
        actuator = decision["actuator"]
        if actuator == "exhausted":
            pass                          # evidence-only entry, no knob
        else:
            getattr(self, f"_act_{actuator}")(decision)
        now = time.monotonic()
        self._last_relax_t = now
        # every move (either direction) restarts the sustained-compliance
        # count: the next relax rung must be earned against the NEW
        # operating point
        self._compliant_evals = 0
        if actuator in self._TIGHTENERS:
            self._last_act_t = now
        else:
            self._last_relax_action_t = now
            if self._relax_ok:
                # the previous relax survived unpunished: decay the backoff
                self._relax_backoff = max(1.0, self._relax_backoff / 2)
            self._relax_ok = True

    def _record_decision(self, decision: dict) -> None:
        self.decisions += 1
        detail = {k: (v.query_name if k == "member" else v)
                  for k, v in decision.items()}
        self.flight.record("slo", f"decision:{decision['actuator']}",
                           site=self._site, detail=detail)
        self.decision_log.append({"t": time.time(), **detail})
        log.info("%s: decision %s (%s)", self._site, decision["actuator"],
                 detail)

    def _act_shrink_window(self, decision: dict) -> None:
        group = self.group
        to = decision["to"]
        with group._lock:
            group.slo_window = to
            ctrl = group.batch_controller
            if ctrl is not None:
                ctrl.impose_ceiling(to)   # AIMD must not fight the cap

    def _act_grow_window(self, decision: dict) -> None:
        group = self.group
        to = decision["to"]
        with group._lock:
            ctrl = group.batch_controller
            if to >= group.capacity:
                group.slo_window = None
                if ctrl is not None:
                    ctrl.lift_ceiling()
            else:
                group.slo_window = to
                if ctrl is not None:
                    ctrl.impose_ceiling(to)

    def _act_shed_besteffort(self, decision: dict) -> None:
        """Cap the neighbour at its weighted fair share of the flush
        window through the guard's admit path (``TenantLane.policy_quota``
        — a HARD per-window cap: the burst's overflow sheds, counted on
        the noisy lane only, instead of buying extra shared steps)."""
        group = self.group
        m = decision["member"]
        t = self.tenants.get(m)
        with group._lock:
            lane = m.lane
            if lane is None:
                return
            total_w = sum(x.weight for x in group.members.values()
                          if not x.ejected) or 1.0
            quota = max(1, int(group.effective_window()
                               * m.weight / total_w))
            lane.policy_quota = quota if lane.policy_quota is None \
                else min(lane.policy_quota, quota)
            if t is not None:
                t.shed_hold = True

    def _act_restore_shed(self, decision: dict) -> None:
        group = self.group
        m = decision["member"]
        t = self.tenants.get(m)
        with group._lock:
            if m.lane is not None:
                m.lane.policy_quota = None
            if t is not None:
                t.shed_hold = False

    def _act_split_group(self, decision: dict) -> None:
        """Halve the lanes per shared step: the lower classes (and within
        a class, the hotter lanes) move to a sibling group stepping the
        same cached plan."""
        group = self.group
        active = [m for m in self._snap(group.members.values())
                  if not m.ejected]
        if len(active) < 2:
            return
        def rank(m):
            t = self.tenants.get(m)
            code = t.class_code if t is not None else CLASS_CODES["standard"]
            arr = m.lane.arrival_evps if m.lane is not None else 0.0
            return (code, -arr)
        active.sort(key=rank)
        move = active[:max(1, len(active) // 2)]
        if len(move) >= len(group.members):
            move = move[:-1]
        self.manager.split_group(group, move)

    def _act_eject_besteffort(self, decision: dict) -> None:
        group = self.group
        m = decision["member"]
        t = self.tenants.get(m)
        with group._lock:
            if group.guard is not None and group.guard.policy_eject(
                    m, "slo: best-effort neighbour over shared budget"):
                if t is not None:
                    t.policy_ejected = True

    def _act_mesh_replace(self, decision: dict) -> None:
        """The cross-host rung: hand the decision (already on the flight
        ring — :meth:`_actuate` recorded it before dispatching here) to
        the mesh fabric, which re-places the violating tenant on the
        least-loaded host. The fabric runs the migration on its own
        thread — the evaluation slot rides tenant ingress and must never
        block on a cross-host move."""
        hook = self.mesh_hook
        if hook is not None:
            hook(decision)

    def _act_readmit_besteffort(self, decision: dict) -> None:
        group = self.group
        m = decision["member"]
        t = self.tenants.get(m)
        with group._lock:
            if group.guard is None:
                return
            ok = group.guard.policy_readmit(m)
            if t is not None and (ok or not m.ejected
                                  or (m.lane is not None
                                      and m.lane.escalated)):
                # clear the flag whenever the lane is back in the group OR
                # permanently out of the controller's hands (escalated) —
                # a sticky flag would pin the relax ladder on this rung
                t.policy_ejected = False

    # -- introspection -------------------------------------------------------
    def report(self) -> dict:
        return {
            "group": self.group.shape_key,
            "window": self.group.effective_window(),
            "slo_window": self.group.slo_window,
            "window_min": self.window_min,
            "interval_ms": self.interval_s * 1e3,
            "cooldown_ms": self.cooldown_s * 1e3,
            "decisions": self.decisions,
            "evaluations": self.evaluations,
            "last_guilty": self.last_guilty,
            "evidence": self.evidence.report(),
            "tenants": [t.report()
                        for t in self._snap(self.tenants.values())],
            "recent_decisions": list(self.decision_log),
        }


def parse_slo_fleet_keys(ann, cfg: dict) -> None:
    """``@app:fleet(slo.p99.ms=, slo.class=, slo.interval.ms=,
    slo.cooldown.ms=, slo.window.min=, slo.dominance=)`` → cfg keys.
    Raises ValueError on a malformed class/number (the app build wraps it
    into a SiddhiAppCreationError)."""
    if ann.get("slo.p99.ms"):
        cfg["slo_p99_ms"] = float(ann.get("slo.p99.ms"))
    klass = ann.get("slo.class")
    if klass:
        klass = klass.lower()
        if klass not in CLASSES:
            raise ValueError(
                f"unknown slo.class '{klass}' (known: {CLASSES})")
        cfg["slo_class"] = klass
    if ann.get("slo.interval.ms"):
        cfg["slo_interval_ms"] = float(ann.get("slo.interval.ms"))
    if ann.get("slo.cooldown.ms"):
        cfg["slo_cooldown_ms"] = float(ann.get("slo.cooldown.ms"))
    if ann.get("slo.window.min"):
        cfg["slo_window_min"] = int(ann.get("slo.window.min"))
    if ann.get("slo.dominance"):
        cfg["slo_dominance"] = float(ann.get("slo.dominance"))
