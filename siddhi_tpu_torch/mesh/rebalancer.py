"""MeshRebalancer: one cross-host move per decision, evidence first.

The fabric's closed loop: watch the per-host evidence the fabric
aggregates (routed-row load shares, fleet guard eject/shed pressure, SLO
compliance — ``MeshFabric.evidence()``), and when one host's load share
runs past the imbalance ratio, propose exactly ONE tenant move toward the
least-loaded host — the Hazelcast-Jet discipline (PAPERS.md 2103.10169):
move load *before* the hot host saturates, one bounded step at a time, so
the control loop can judge each move before the next.

Decision hygiene is the ``observability/slo.py`` contract, pinned by the
same lint (``scripts/check_guard_coverage.py``): every actuator is
reachable ONLY through :meth:`_actuate`, which records the decision — the
hot host, its measured share vs the threshold, the chosen tenant and
destination — to the fabric's flight recorder (and the moved tenant's own
app timeline, via ``MeshFabric.migrate``) BEFORE the move runs. Cooldown
between moves is the hysteresis that keeps the loop from thrashing
tenants back and forth.

The port's copy of the JAX package's ``mesh/rebalancer.py`` (the logger's
name is the port's).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

log = logging.getLogger("siddhi_tpu_torch.mesh")

_DEF_INTERVAL_S = 1.0         # min wall-clock between evaluations
_DEF_COOLDOWN_S = 5.0         # min wall-clock between moves
_DEF_IMBALANCE = 2.0          # hot = load share > imbalance × fair share


class MeshRebalancer:
    """One fabric's rebalancing loop. Drive :meth:`evaluate` explicitly
    (tests, bench, an operator cron) or :meth:`start` the background
    thread."""

    def __init__(self, fabric, interval_s: float = _DEF_INTERVAL_S,
                 cooldown_s: float = _DEF_COOLDOWN_S,
                 imbalance: float = _DEF_IMBALANCE,
                 min_rows: int = 1024):
        self.fabric = fabric
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.imbalance = float(imbalance)
        self.min_rows = int(min_rows)   # ignore cold meshes (no evidence)
        self.decisions = 0
        self.evaluations = 0
        self.decision_log: deque = deque(maxlen=64)
        self._last_rows: dict = {}      # host -> rows_in at last evaluation
        self._last_eval_t = 0.0
        self._last_act_t = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the loop -------------------------------------------------------------
    def evaluate(self, force: bool = False) -> Optional[dict]:
        """One decision step: windowed load deltas per host, at most one
        proposed move. Never raises into the caller — a rebalancer bug
        must degrade to "no decision"."""
        now = time.monotonic()
        if not force and now - self._last_eval_t < self.interval_s:
            return None
        if not self._lock.acquire(blocking=False):
            return None
        try:
            self._last_eval_t = now
            return self._evaluate(now, force)
        except Exception:   # noqa: BLE001 — keep-alive, like the SLO loop
            log.exception("mesh rebalancer evaluation failed")
            return None
        finally:
            self._lock.release()

    def _evaluate(self, now: float, force: bool) -> Optional[dict]:
        ev = self.fabric.evidence()
        live = {h: e for h, e in ev.items() if e.get("alive")}
        if len(live) < 2:
            return None
        self.evaluations += 1
        # windowed load: routed rows since the last evaluation (cumulative
        # counters flatten exactly like cumulative percentiles would)
        deltas = {}
        for h, e in live.items():
            cur = int(e.get("rows_in", 0))
            deltas[h] = max(0, cur - self._last_rows.get(h, 0))
            self._last_rows[h] = cur
        total = sum(deltas.values())
        if total < self.min_rows:
            return None                  # cold window: no evidence, no move
        if not force and now - self._last_act_t < self.cooldown_s:
            return None                  # actuator cooldown: hysteresis
        fair = 1.0 / len(live)
        hot = max(live, key=lambda h: deltas[h])
        share = deltas[hot] / total
        # the threshold must stay satisfiable: on a 2-host mesh
        # imbalance×fair reaches 1.0 and a share can never exceed it —
        # clamp below 1 so total one-host concentration always triggers
        if share <= min(self.imbalance * fair, 0.95):
            return None
        dst = self._target(live, deltas, exclude=hot)
        if dst is None:
            return None
        tenant = self._pick_tenant(hot, dst)
        if tenant is None:
            return None
        decision = {"actuator": "migrate_tenant", "tenant": tenant,
                    "src": hot, "dst": dst,
                    "load_share": round(share, 3),
                    "threshold": round(self.imbalance * fair, 3),
                    "window_rows": total,
                    "src_pressure": {
                        k: live[hot].get(k, 0)
                        for k in ("ejections", "sheds", "slo_violations")}}
        self._actuate(decision)
        return decision

    def _target(self, live: dict, deltas: dict,
                exclude: int) -> Optional[int]:
        cands = [h for h, e in live.items()
                 if h != exclude
                 and e.get("tenants", 0) < e.get("capacity", 0)]
        if not cands:
            return None
        # process mode: a recently-respawned worker ranks behind a stable
        # one at equal load (inproc hosts report no restarts — no change)
        return min(cands, key=lambda h: (deltas[h],
                                         live[h].get("restarts", 0),
                                         live[h].get("tenants", 0), h))

    def _pick_tenant(self, hot: int, dst: int) -> Optional[str]:
        """The move that costs locality least: prefer a tenant whose shape
        the destination already compiles (its lanes join an existing
        FleetGroup — no new program), smallest first so one decision stays
        a bounded step."""
        fabric = self.fabric
        host = fabric.hosts.get(hot)
        if host is None or not host.runtimes:
            return None
        dst_shapes = {s.shape for t, s in fabric.plan.assignment.items()
                      if s.host == dst}
        cands = []
        for tid in host.runtimes:
            st = fabric.tenants.get(tid)
            if st is None or st.migrating:
                continue
            shape = st.spec.primary_shape
            cands.append((0 if shape in dst_shapes else 1, tid))
        if not cands:
            return None
        return min(cands)[1]

    # -- actuation (decision recorded BEFORE the knob moves) ------------------
    def _actuate(self, decision: dict) -> None:
        """THE single actuation gate (the ``SLOController._actuate``
        contract, pinned by ``scripts/check_guard_coverage.py``): record
        the decision with its evidence, THEN dispatch."""
        self._record_decision(decision)
        getattr(self, f"_act_{decision['actuator']}")(decision)
        self._last_act_t = time.monotonic()

    def _record_decision(self, decision: dict) -> None:
        self.decisions += 1
        self.fabric.flight.record(
            "mesh", f"decision:{decision['actuator']}",
            site=f"rebalance:h{decision.get('src')}", detail=dict(decision))
        self.decision_log.append({"t": time.time(), **decision})
        log.info("mesh rebalancer: %s (%s)", decision["actuator"], decision)

    def _act_migrate_tenant(self, decision: dict) -> None:
        self.fabric.migrate(decision["tenant"], decision["dst"],
                            reason="rebalance", decided=decision)

    # -- background loop ------------------------------------------------------
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
        while not self._stop.wait(self.interval_s):
            self.evaluate()

    def report(self) -> dict:
        return {"decisions": self.decisions,
                "evaluations": self.evaluations,
                "interval_s": self.interval_s,
                "cooldown_s": self.cooldown_s,
                "imbalance": self.imbalance,
                "recent_decisions": list(self.decision_log)}
