"""Detection-latency attribution: per-query per-phase histograms.

The port's copy of the JAX package's ``observability/phases.py``. Every
phase is timed on the host clock, ``device_step`` and ``egress_fence``
included: the end-to-end sample is the sum of the serial wall segments, so
the phases reconcile with it by construction, which a device-clock interval
overlapping those segments would break. The card's own time goes to the
profiler's trace (``profiler.py``).

A p99 detection latency "dominated by deadline-flush queueing" is a
claim that nothing in an engine without this module could *prove*. This module is the evidence substrate (TiLT's per-operator
time attribution, arXiv:2301.12030; Hazelcast Jet's queueing-vs-processing
split, arXiv:2103.10169): every micro-batch's journey is cut into serial
waterfall segments, each recorded event-weighted into an always-on
:class:`~siddhi_tpu_torch.observability.histogram.LogHistogram`, so phase means
SUM to the end-to-end mean by construction and the per-phase p99s say
where a tail came from.

Phases (one vocabulary for span classification, the ``phase.*`` latency
trackers, and the bench ``latency_breakdown`` line):

- ``ingress_parse`` — transport bytes → columns at the edge (CSV/SoA
  parse + dictionary encode in a columnar source, PR 11);
- ``ingress_queue`` — waiting in an @async junction buffer or the device
  driver's staged/in-flight ring;
- ``fill_wait``     — waiting for a micro-batch window to fill (recorded
  as the per-event AVERAGE wait, span/2, under the uniform-arrival
  approximation — the only non-measured segment);
- ``pack``          — SoA staging/emit of the batch;
- ``device_step``   — the dispatch (the step's kernels enqueued on the
  CUDA stream; the plain version's whole step on the CPU);
- ``egress_fence``  — the egress sync + decode (the copy of the outputs to
  the host is the fence);
- ``host_exec``     — host-tier execution (interpreter, columnar,
  fleet lanes, shadow replays);
- ``sink_publish``  — delivery/publish downstream of the step;
- ``dcn_transit``   — the cross-host hop (send wall-clock → apply);
- ``procmesh_transit`` — the parent→child control-socket hop in a
  process-per-host fabric (dispatch wall-clock → child apply, including
  any lost-ack retry delay).
"""

from __future__ import annotations

from typing import Optional

PHASES = ("ingress_parse", "ingress_queue", "fill_wait", "pack",
          "device_step", "egress_fence", "host_exec", "sink_publish",
          "dcn_transit", "procmesh_transit")

# span stage → phase (unknown stages are host work by default: every
# host-side processor span nests inside the query chain)
_STAGE_PHASE = {
    "parse": "ingress_parse",
    "queue": "ingress_queue",
    "fill-wait": "fill_wait",
    "pack": "pack",
    "device": "device_step",
    "fence": "egress_fence",
    "ingress": "host_exec",
    "query": "host_exec",
    "fleet": "host_exec",
    "sink": "sink_publish",
    "dcn": "dcn_transit",
    "procmesh": "procmesh_transit",
}


def phase_of_stage(stage: str) -> str:
    return _STAGE_PHASE.get(stage, "host_exec")


class PhaseBreakdown:
    """One query's per-phase latency attribution.

    ``record_batch`` takes the measured serial segments of one stepped
    micro-batch (seconds) and records each event-weighted; the end-to-end
    sample is the SUM of the segments, so
    ``sum(phase means) == end_to_end mean`` exactly and any drift in a
    report indicates a measurement bug, not an accounting choice.
    ``fill_span_s`` is the full first-append→seal window; its per-event
    average (span/2) is what both fill_wait and end_to_end see.
    """

    def __init__(self, make_tracker):
        """``make_tracker(name)`` → a LatencyTracker-like with
        ``record_seconds(seconds, n=1, exemplar=None)``."""
        self.trackers = {p: make_tracker(p) for p in PHASES}
        self.end_to_end = make_tracker("end_to_end")
        # queueing attributable to flush policy, split by flush cause —
        # the "deadline-flush queueing share" field reads from these
        self.wait_sum_by_cause: dict[str, float] = {}
        self.e2e_sum = 0.0

    def record_batch(self, n: int, fill_span_s: float = 0.0,
                     pack_s: float = 0.0, queue_s: float = 0.0,
                     step_s: float = 0.0, fence_s: float = 0.0,
                     publish_s: float = 0.0, host_s: float = 0.0,
                     parse_s: float = 0.0,
                     cause: Optional[str] = None,
                     exemplar=None) -> None:
        if n <= 0:
            return
        fill_avg = max(0.0, fill_span_s) / 2.0
        segs = (("ingress_parse", parse_s), ("fill_wait", fill_avg),
                ("pack", pack_s),
                ("ingress_queue", queue_s), ("device_step", step_s),
                ("egress_fence", fence_s), ("sink_publish", publish_s),
                ("host_exec", host_s))
        total = 0.0
        for phase, v in segs:
            if v > 0.0:
                self.trackers[phase].record_seconds(v, n, exemplar=exemplar)
                total += v
        self.end_to_end.record_seconds(total, n, exemplar=exemplar)
        self.e2e_sum += total * n
        if cause is not None:
            self.wait_sum_by_cause[cause] = \
                self.wait_sum_by_cause.get(cause, 0.0) + fill_avg * n

    # -- readouts --------------------------------------------------------------
    def queueing_share(self, cause: str = "deadline") -> float:
        """Fraction of total end-to-end latency spent as fill-wait on
        batches flushed for ``cause`` — the field that proves (or refutes)
        "p99 dominated by deadline-flush queueing"."""
        if self.e2e_sum <= 0.0:
            return 0.0
        return self.wait_sum_by_cause.get(cause, 0.0) / self.e2e_sum

    def report(self) -> dict:
        e2e = self.end_to_end.percentiles_ms()
        phases = {p: t.percentiles_ms()
                  for p, t in self.trackers.items() if t.count}
        # reconciliation from SUMS over the e2e event count, not from the
        # per-phase means: a segment absent on some batches (sink_publish
        # records only when a batch produced rows) has a conditional mean,
        # and summing conditional means would overstate the decomposition.
        # Σ(phase sums) == Σ(e2e samples) by construction, so this ratio is
        # exactly 1.0 unless a measurement bug slips in.
        total_events = self.end_to_end.count
        mean_sum = (sum(t.hist.sum for t in self.trackers.values())
                    / total_events * 1e3) if total_events else 0.0
        out = {
            "end_to_end": e2e,
            "phases": phases,
            "phase_mean_sum_ms": round(mean_sum, 6),
            "end_to_end_mean_ms": round(e2e["avg_ms"], 6),
            "deadline_flush_queueing_share":
                round(self.queueing_share("deadline"), 6),
            "queueing_share_by_cause": {
                c: (round(s / self.e2e_sum, 6) if self.e2e_sum else 0.0)
                for c, s in self.wait_sum_by_cause.items()},
        }
        if e2e["avg_ms"] > 0.0:
            out["reconciliation_ratio"] = round(mean_sum / e2e["avg_ms"], 6)
        return out
