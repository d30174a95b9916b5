"""Prometheus 0.0.4 text exposition over the statistics SPI.

The port's copy of the JAX package's ``observability/prometheus.py``: the
family names and labels are the JAX package's, exactly (its wire format).

Maps every tracker registered in a :class:`StatisticsManager` to a stable
``siddhi_tpu_*`` family with ``app`` / ``stream`` / ``query`` labels. The
dotted registration keys follow the repo-wide convention
``<scope>.<entity>[.<ordinal>].<field>`` (``flow.S.wal_bytes``,
``sink.O.0.sink_retries``, ``device.q1.batch_size``); the scope becomes the
label name, the field the metric suffix. Latency trackers render as real
histograms — cumulative ``le`` bucket lines plus ``_sum``/``_count`` — so
p99 is derivable by any scraper.

The JAX package's ``scripts/check_metric_names.py`` lints the rendered output (snake_case,
prefix, sample uniqueness); keep the mapping here total — an unknown key
falls back to a sanitized literal rather than being dropped.
"""

from __future__ import annotations

import math
import re
from typing import Iterable, Optional

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# exemplars are an OpenMetrics feature: strict Prometheus-0.0.4 parsers
# reject a trailing `# {...}` on a sample line, so the exemplar-bearing
# exposition is served ONLY when the scraper negotiates OpenMetrics via
# Accept (and then carries the required `# EOF` terminator). The default
# 0.0.4 exposition never contains exemplars — byte-identical to pre-X-Ray.
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"

_SCOPE_LABEL = {"stream": "stream", "flow": "stream", "device": "query",
                "query": "query", "partition": "query", "source": "stream",
                "dcn": "peer", "host_batch": "query", "detection": "query",
                "slo": "query", "mesh": "host", "procmesh": "worker"}
_SAN = re.compile(r"[^a-z0-9_]+")


def _sanitize(name: str) -> str:
    s = _SAN.sub("_", name.lower()).strip("_")
    return re.sub(r"__+", "_", s) or "unnamed"


def _split_key(key: str) -> tuple[str, dict, Optional[str]]:
    """Registration key → (scope, labels, field)."""
    parts = key.split(".")
    scope = parts[0]
    if scope == "phase" and len(parts) >= 3:
        # phase.{query}.{phase_name}: the X-Ray per-phase histograms — the
        # phase becomes a bounded label on ONE family, not a name suffix
        return scope, {"query": parts[1],
                       "phase": _sanitize(".".join(parts[2:]))}, None
    if scope == "sink" and len(parts) >= 3:
        field = ".".join(parts[3:]) or None
        return scope, {"stream": parts[1], "ordinal": parts[2]}, field
    if scope == "fleet" and len(parts) >= 2:
        # fleet.tenant.{q}.<field> — the FleetGuard per-lane families;
        # fleet.shape_cache.* / fleet.solo_fallbacks are engine-wide (no
        # query label); fleet.{q}.<field> are the per-member lane gauges
        if parts[1] == "tenant" and len(parts) >= 4:
            return scope, {"query": parts[2]}, \
                "tenant." + ".".join(parts[3:])
        if parts[1] == "fallbacks" and len(parts) >= 3:
            # fleet.fallbacks.{reason}: the solo-fallback counter family,
            # keyed by the BOUNDED reason taxonomy (fleet/manager.py) —
            # one family, reason as label, never a per-reason name
            return scope, {"reason": _sanitize(".".join(parts[2:]))}, \
                "fallbacks_total"
        if parts[1] in ("shape_cache", "solo_fallbacks"):
            return scope, {}, ".".join(parts[1:])
        field = ".".join(parts[2:]) or None
        return scope, {"query": parts[1]}, field
    if scope in _SCOPE_LABEL and len(parts) >= 2:
        field = ".".join(parts[2:]) or None
        return scope, {_SCOPE_LABEL[scope]: parts[1]}, field
    if scope in ("chaos", "app") and len(parts) >= 2:
        return scope, {}, ".".join(parts[1:])
    return scope, {}, None


def _metric_name(scope: str, field: Optional[str], suffix: str = "") -> str:
    field = _sanitize(field) if field else ""
    if scope == "app":                       # app-scoped: field stands alone
        base = field or "app"
    elif not field:
        base = _sanitize(scope)
    elif field.startswith(scope + "_"):      # 'sink.O.0.sink_retries'
        base = field
    else:
        base = f"{_sanitize(scope)}_{field}"
    if suffix and not base.endswith(suffix):
        base += suffix
    return f"siddhi_tpu_{base}"


_LATENCY_FAMILIES = {
    "query": "siddhi_tpu_query_latency_seconds",
    "sink": "siddhi_tpu_sink_publish_latency_seconds",
    "device": "siddhi_tpu_device_step_latency_seconds",
    # the X-Ray split: segments in ONE family keyed by a bounded phase
    # label, the end-to-end distribution in its OWN family — putting the
    # sum alongside its parts would double every
    # sum-over-phases aggregation
    "phase": "siddhi_tpu_phase_latency_seconds",
    "detection": "siddhi_tpu_detection_latency_seconds",
}


def _latency_family(scope: str, labels: dict, field: Optional[str],
                    key: str) -> str:
    """Family name for one latency tracker key. Labeled scopes
    (``_SCOPE_LABEL``: mesh/slo/procmesh) fold the per-instance segment
    into a LABEL, so ``procmesh.w0.heartbeat`` renders ONE
    ``siddhi_tpu_procmesh_heartbeat_seconds{worker="w0"}`` family instead
    of a per-worker name (unbounded-family lint discipline). Everything
    else keeps the fixed-family table / sanitized-key fallback."""
    name = _LATENCY_FAMILIES.get(scope)
    if name is not None:
        return name
    if scope in _SCOPE_LABEL and labels and field:
        return _metric_name(scope, field, "_seconds")
    return f"siddhi_tpu_{_sanitize(key)}_latency_seconds"


def _escape(value) -> str:
    return str(value).replace("\\", "\\\\").replace("\n", "\\n") \
                     .replace('"', '\\"')


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return f"{float(v):.10g}"


class _Family:
    def __init__(self, name: str, mtype: str, help_text: str):
        self.name = name
        self.type = mtype
        self.help = help_text
        # (suffix, labels, val, exemplar_text)
        self.samples: list[tuple[str, str, str, str]] = []

    def add(self, labels: dict, value, suffix: str = "",
            exemplar=None) -> None:
        ex = ""
        if exemplar is not None:
            # OpenMetrics exemplar syntax on a bucket sample:
            #   ... <count> # {trace_id="<id>"} <value> <unix_ts>
            tid, v, ts = exemplar
            ex = f' # {{trace_id="{_escape(tid)}"}} {v:.9g} {ts:.3f}'
        self.samples.append(
            (suffix, _fmt_labels(labels), _fmt_value(value), ex))


def _collect(sm, families: dict, with_exemplars: bool = False) -> None:
    """Append one app's samples into the shared family map."""
    from ..core.metrics import Level

    def fam(name: str, mtype: str, help_text: str) -> _Family:
        f = families.get(name)
        if f is None:
            f = families[name] = _Family(name, mtype, help_text)
        return f

    app = {"app": sm.app_name}
    snap = sm.snapshot_trackers()

    for key, tracker in snap["throughput"].items():
        scope, labels, field = _split_key(key)
        name = _metric_name(scope, field or "events", "_total")
        fam(name, "counter", f"events through {scope}").add(
            {**app, **labels}, tracker.count)

    for key, tracker in snap["counters"].items():
        scope, labels, field = _split_key(key)
        name = _metric_name(scope, field, "_total")
        fam(name, "counter", f"{scope} counter").add(
            {**app, **labels}, tracker.count)

    for key, tracker in snap["buffered"].items():
        scope, labels, _ = _split_key(key)
        fam("siddhi_tpu_buffered_events", "gauge",
            "queued events/batches awaiting delivery").add(
            {**app, "kind": scope, **labels}, tracker.buffered)

    for key, tracker in snap["gauges"].items():
        scope, labels, field = _split_key(key)
        v = tracker.value
        try:
            v = float(v)
        except (TypeError, ValueError):
            continue                          # non-numeric gauge: not a sample
        if field and field.endswith("_total"):
            fam(_metric_name(scope, field), "counter",
                f"{scope} cumulative count").add({**app, **labels}, v)
        else:
            fam(_metric_name(scope, field), "gauge", f"{scope} gauge").add(
                {**app, **labels}, v)

    # the retained-size walker is expensive — scrape it only at DETAIL,
    # matching the report() gating
    if sm.level == Level.DETAIL:
        for key, tracker in snap["memory"].items():
            fam("siddhi_tpu_memory_bytes", "gauge",
                "retained bytes per element (device state: tensor bytes)").add(
                {**app, "element": key}, tracker.bytes)

    for key, tracker in snap["latency"].items():
        scope, labels, field = _split_key(key)
        name = _latency_family(scope, labels, field, key)
        f = fam(name, "histogram", f"{scope} latency distribution (seconds)")
        buckets, count, total = tracker.hist.export()   # one atomic read
        # OpenMetrics exemplars: a tail bucket links to the concrete trace
        # that landed in it. Only present when the scrape negotiated
        # OpenMetrics AND a sampled trace stamped one — the 0.0.4
        # exposition stays byte-identical to before in all cases.
        exemplars = tracker.hist.exemplars() if with_exemplars else {}
        for le, cum in buckets:
            f.add({**app, **labels, "le": f"{le:.6g}"}, cum, "_bucket",
                  exemplar=exemplars.get(le))
        f.add({**app, **labels, "le": "+Inf"}, count, "_bucket",
              exemplar=exemplars.get(math.inf))
        f.add({**app, **labels}, total, "_sum")
        f.add({**app, **labels}, count, "_count")


def collect_scraped(families: dict, app: str, worker: str,
                    latency_items: Iterable, counter_items: Iterable) -> None:
    """Append one SCRAPED tracker-state set (a procmesh worker's
    ``metrics``-op reply, tenant-prefixed keys) into a shared family map
    under a ``worker`` label — the federation half of :func:`render`.

    The tenant prefix is STRIPPED before the key maps through
    :func:`_split_key`: per-tenant label cardinality is unbounded and the
    metric lint forbids a ``tenant`` label, so states from different
    tenants that land on the same ``(family, labels)`` MERGE — histogram
    states by bucket-count summing (the fixed ladder makes that exact),
    counters by addition. ``latency_items`` yields ``(key, state)`` pairs
    (:meth:`LogHistogram.state` dumps), ``counter_items`` yields
    ``(key, int)`` pairs; both may carry the same key more than once
    (fabric-level merges feed every worker's items through one call)."""
    from .histogram import LogHistogram

    def fam(name: str, mtype: str, help_text: str) -> _Family:
        f = families.get(name)
        if f is None:
            f = families[name] = _Family(name, mtype, help_text)
        return f

    base = {"app": app, "worker": worker}
    merged: dict = {}               # (name, label_items) -> LogHistogram
    for key, state in latency_items:
        rest = key.split(".", 1)[-1]            # strip the tenant prefix
        scope, labels, field = _split_key(rest)
        name = _latency_family(scope, labels, field, rest)
        ident = (name, tuple(sorted({**base, **labels}.items())))
        hist = merged.get(ident)
        try:
            if hist is None:
                merged[ident] = LogHistogram.merge([state])
            else:
                hist.merge_state(state)
        except (ValueError, KeyError, TypeError):
            continue                # ladder mismatch / malformed: skip
    for (name, label_items), hist in merged.items():
        labels = dict(label_items)
        f = fam(name, "histogram",
                "federated latency distribution (seconds) by worker")
        buckets, count, total = hist.export()
        for le, cum in buckets:
            f.add({**labels, "le": f"{le:.6g}"}, cum, "_bucket")
        f.add({**labels, "le": "+Inf"}, count, "_bucket")
        f.add({**labels}, total, "_sum")
        f.add({**labels}, count, "_count")

    ctr_merged: dict = {}
    for key, v in counter_items:
        rest = key.split(".", 1)[-1]
        scope, labels, field = _split_key(rest)
        name = _metric_name(scope, field, "_total")
        ident = (name, tuple(sorted({**base, **labels}.items())), scope)
        ctr_merged[ident] = ctr_merged.get(ident, 0) + int(v)
    for (name, label_items, scope), v in ctr_merged.items():
        fam(name, "counter", f"federated {scope} counter by worker").add(
            dict(label_items), v)


def render(managers: Iterable, with_exemplars: bool = False,
           collectors: Iterable = ()) -> str:
    """Prometheus text for one or more apps' StatisticsManagers.
    ``with_exemplars=True`` renders the OpenMetrics-flavored exposition
    (trace-id exemplars on ``le`` buckets; serve it under
    :data:`OPENMETRICS_CONTENT_TYPE` with a trailing ``# EOF``).
    ``collectors`` are callables receiving the shared family map — the
    procmesh fabric's federated exposition hooks in here, so one scrape
    renders parent families AND per-worker/merged child families."""
    families: dict[str, _Family] = {}
    for sm in managers:
        _collect(sm, families, with_exemplars)
    for collector in collectors:
        collector(families)
    lines: list[str] = []
    for name in sorted(families):
        f = families[name]
        lines.append(f"# HELP {f.name} {f.help}")
        lines.append(f"# TYPE {f.name} {f.type}")
        for suffix, labels, value, exemplar in f.samples:
            lines.append(f"{f.name}{suffix}{labels} {value}{exemplar}")
    return "\n".join(lines) + ("\n" if lines else "")
