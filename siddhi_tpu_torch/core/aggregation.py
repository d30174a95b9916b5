"""Incremental aggregations: multi-duration rollup cascade.

Port of the reference's ``core/aggregation.py`` (``AggregationRuntime``,
reference ``core/aggregation/``: ``AggregationRuntime.java``,
``IncrementalExecutor.java``, per-duration stores, on-demand ``within ...
per ...`` retrieval). Buckets are keyed dicts of running aggregator states
per duration; rollups bucket the event timestamp directly into every
requested duration. ``@device`` definitions stage events into columnar
micro-batches and reduce them with ``gpu/aggregation_compile.py`` (kernel
``csrc/aggregation_step.cu`` on the card); the partial rows merge here at
bucket granularity. A definition the device compiler refuses stays on the
host interpreter unless ``@device(strict='true')``, as in the reference.
``device`` follows ``gpu.backend.resolve_device``: the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Optional

from ..query_api import (
    AttributeFunction,
    OnDemandQuery,
    OutputAttribute,
    Variable,
)
from ..query_api.definition import AggregationDefinition, TimePeriodDuration
from .aggregators import AGGREGATOR_NAMES, aggregator_return_type, make_aggregator
from .errors import SiddhiAppRuntimeError
from .event import Event, EventType, StreamEvent
from .executor import ExecutorBuilder, StreamFrame, StreamResolver

_MS = {
    TimePeriodDuration.SECONDS: 1000,
    TimePeriodDuration.MINUTES: 60_000,
    TimePeriodDuration.HOURS: 3_600_000,
    TimePeriodDuration.DAYS: 86_400_000,
}


def parse_within_value(v) -> int:
    """One bound of a two-arg ``within start, end``: epoch-ms int or a fully
    specified date string 'YYYY-MM-DD HH:MM:SS[ +HH:MM]' (no wildcards)."""
    if isinstance(v, (int, float)):
        return int(v)
    if isinstance(v, str):
        if "*" in v:
            raise SiddhiAppRuntimeError(
                f"wildcards are only valid in single-value within: {v!r}")
        return _date_ms(v)
    raise SiddhiAppRuntimeError("within bound must be a constant timestamp or date string")


def parse_within_single(v) -> tuple[Optional[int], Optional[int]]:
    """Single-arg ``within``: a wildcard pattern covers its whole period
    (reference: ``aggregation/AggregationRuntime.java`` within handling —
    '2017-06-** **:**:**' means all of June 2017). Returns [start, end)."""
    if isinstance(v, (int, float)):
        return int(v), None
    if not isinstance(v, str):
        raise SiddhiAppRuntimeError("within bound must be a constant timestamp or date string")
    text, tz = _split_tz(v.strip())
    try:
        date_part, time_part = text.split()
        y_s, mo_s, d_s = date_part.split("-")
        h_s, mi_s, s_s = time_part.split(":")
    except ValueError:
        raise SiddhiAppRuntimeError(f"cannot parse within bound {v!r}") from None
    if "*" in y_s:
        return None, None  # every year: unbounded
    fields = [mo_s, d_s, h_s, mi_s, s_s]
    mins = [1, 1, 0, 0, 0]
    wild = ["*" in f for f in fields]
    first = wild.index(True) if any(wild) else 5
    if not all(wild[first:]):
        raise SiddhiAppRuntimeError(
            f"within wildcards must be a contiguous suffix: {v!r}")
    vals = [int(f) if not w else m for f, w, m in zip(fields, wild, mins)]
    y = int(y_s)
    start_dt = _dt.datetime(y, vals[0], vals[1], vals[2], vals[3], vals[4], tzinfo=tz)
    if first == 0:
        end_dt = _dt.datetime(y + 1, 1, 1, tzinfo=tz)
    elif first == 1:
        end_dt = (_dt.datetime(y + 1, 1, 1, tzinfo=tz) if vals[0] == 12
                  else _dt.datetime(y, vals[0] + 1, 1, tzinfo=tz))
    else:
        unit = {2: _dt.timedelta(days=1), 3: _dt.timedelta(hours=1),
                4: _dt.timedelta(minutes=1), 5: _dt.timedelta(seconds=1)}[first]
        end_dt = start_dt + unit
    return int(start_dt.timestamp() * 1000), int(end_dt.timestamp() * 1000)


def _split_tz(text: str):
    # trailing ' +HH:MM' / ' -HH:MM' timezone offset; default UTC
    if len(text) > 6 and text[-6] in "+-" and text[-3] == ":" and text[-7] == " ":
        sign = -1 if text[-6] == "-" else 1
        h, m = int(text[-5:-3]), int(text[-2:])
        return text[:-7], _dt.timezone(sign * _dt.timedelta(hours=h, minutes=m))
    return text, _dt.timezone.utc


def _date_ms(text: str) -> int:
    text, tz = _split_tz(text.strip())
    dt = _dt.datetime.strptime(text, "%Y-%m-%d %H:%M:%S").replace(tzinfo=tz)
    return int(dt.timestamp() * 1000)


_PURGE_DEFAULT_RETENTION: dict[TimePeriodDuration, Optional[int]] = {
    # reference IncrementalDataPurger defaults: sec 120s, min 24h, hours 30d,
    # days 1 year, months/years never purged
    TimePeriodDuration.SECONDS: 120_000,
    TimePeriodDuration.MINUTES: 86_400_000,
    TimePeriodDuration.HOURS: 30 * 86_400_000,
    TimePeriodDuration.DAYS: 365 * 86_400_000,
    TimePeriodDuration.MONTHS: None,
    TimePeriodDuration.YEARS: None,
}

def parse_retention(text: str) -> Optional[int]:
    """'120 sec' / '24 hours' / '1 year' → ms; 'all' → None (keep forever).
    Units shared with the SiddhiQL time-literal table."""
    from ..compiler.tokenizer import TIME_UNITS
    text = text.strip().lower()
    if text == "all":
        return None
    parts = text.split()
    try:
        if len(parts) == 2:
            return int(float(parts[0]) * TIME_UNITS[parts[1]])
        return int(text)   # bare ms
    except (ValueError, KeyError):
        raise SiddhiAppRuntimeError(
            f"cannot parse retention/interval {text!r}") from None


def bucket_start(ts: int, duration: TimePeriodDuration) -> int:
    if duration in _MS:
        return ts - ts % _MS[duration]
    dt = _dt.datetime.fromtimestamp(ts / 1000.0, tz=_dt.timezone.utc)
    if duration == TimePeriodDuration.MONTHS:
        dt = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    else:  # YEARS
        dt = dt.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
    return int(dt.timestamp() * 1000)


def _to_jsonable(v):
    """Tagged-JSON encode for aggregator state (Counter/set/tuple carry
    type tags; everything else must already be a JSON scalar/list/dict)."""
    from collections import Counter
    if isinstance(v, Counter):
        return {"__counter__": [[_to_jsonable(k), n] for k, n in v.items()]}
    if isinstance(v, (set, frozenset)):
        return {"__set__": [_to_jsonable(x) for x in sorted(v, key=repr)]}
    if isinstance(v, tuple):
        return {"__tuple__": [_to_jsonable(x) for x in v]}
    if isinstance(v, list):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, dict):
        if all(isinstance(k, str) for k in v):
            return {k: _to_jsonable(x) for k, x in v.items()}
        return {"__map__": [[_to_jsonable(k), _to_jsonable(x)]
                            for k, x in v.items()]}
    return v


def _from_jsonable(v):
    from collections import Counter
    if isinstance(v, dict):
        if "__counter__" in v and len(v) == 1:
            c = Counter()
            for k, n in v["__counter__"]:
                c[_hashable(_from_jsonable(k))] = n
            return c
        if "__set__" in v and len(v) == 1:
            return {_hashable(_from_jsonable(x)) for x in v["__set__"]}
        if "__tuple__" in v and len(v) == 1:
            return tuple(_from_jsonable(x) for x in v["__tuple__"])
        if "__map__" in v and len(v) == 1:
            return {_hashable(_from_jsonable(k)): _from_jsonable(x)
                    for k, x in v["__map__"]}
        return {k: _from_jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    return v


def _hashable(v):
    return tuple(v) if isinstance(v, list) else v


class AggregationRuntime:
    def __init__(self, definition: AggregationDefinition, app_context,
                 stream_defs: dict, device=None):
        self.definition = definition
        self.app_context = app_context
        stream = definition.basic_single_input_stream
        sid = stream.stream_id
        if sid not in stream_defs:
            raise KeyError(f"aggregation '{definition.id}': undefined stream '{sid}'")
        self.input_def = stream_defs[sid]
        builder = ExecutorBuilder(StreamResolver(self.input_def), app_context)

        # timestamp executor
        if definition.aggregate_attribute is not None:
            self.ts_fn, _ = builder.build(
                Variable(attribute=definition.aggregate_attribute))
        else:
            self.ts_fn = None

        # selector decomposition
        self.group_fns = [builder.build(v)[0] for v in definition.selector.group_by]
        self.attr_specs = []     # (name, kind, fn, agg_name, dtype)
        for oa in definition.selector.attributes:
            e = oa.expr
            if isinstance(e, AttributeFunction) and e.namespace is None \
                    and e.name in AGGREGATOR_NAMES:
                arg_fn, arg_t = builder.build(e.args[0]) if e.args else ((lambda f: None), None)
                self.attr_specs.append(
                    (oa.name, "agg", arg_fn, e.name,
                     aggregator_return_type(e.name, arg_t), arg_t))
            else:
                fn, t = builder.build(e)
                self.attr_specs.append((oa.name, "value", fn, None, t, t))

        # duration -> {bucket_start -> {group_key -> state}}
        # state = {"aggs": {name: Aggregator}, "values": {name: last value}}
        self.stores: dict[TimePeriodDuration, dict[int, dict[Any, dict]]] = {
            d: {} for d in definition.durations
        }
        app_context.register_state(f"aggregation-{definition.id}", self)

        # @store(type='X'): persisted incremental aggregation (reference
        # ``aggregation/persistedaggregation/`` + CudStreamProcessorQueueManager
        # .java:29 — completed buckets are written behind to one store table
        # per duration; reads merge store rows with live in-memory buckets,
        # so rollups survive restart). Store rows are an append-log of
        # [bucket_ts, key_repr, pickled-state]; readers take the newest
        # version of each (bucket, key) — out-of-order reopenings simply
        # append a fresher version.
        from ..query_api.annotation import find_annotation as _find_ann
        store_ann = _find_ann(definition.annotations, "store")
        self.persist_stores: dict[TimePeriodDuration, Any] = {}
        self._dirty: dict[TimePeriodDuration, set[int]] = {
            d: set() for d in definition.durations}
        self._max_bucket: dict[TimePeriodDuration, Optional[int]] = {
            d: None for d in definition.durations}
        if store_ann is not None:
            stype = store_ann.get("type")
            cls = app_context.siddhi_context.extensions.get(f"store:{stype}")
            if cls is None:
                raise SiddhiAppRuntimeError(
                    f"aggregation '{definition.id}': no store extension "
                    f"'{stype}'")
            from ..query_api.definition import DataType, TableDefinition
            opts = {e.key: e.value for e in store_ann.elements if e.key}
            for d in definition.durations:
                td = TableDefinition(f"{definition.id}_{d.value.upper()}")
                td.attribute("AGG_TIMESTAMP", DataType.LONG)
                td.attribute("KEY", DataType.STRING)
                td.attribute("STATE", DataType.STRING)
                t = cls(td, app_context)
                # same contract as the @store table path: a ConfigReader is
                # handed to every store extension before init
                t.config_reader = app_context.config_reader("store", stype)
                t.init(td, opts)
                self.persist_stores[d] = t

        # subscribe via a junction receiver
        junction = app_context.stream_junctions.get(sid)
        if junction is not None:
            junction.subscribe(self)

        # honor filters on the input stream
        from ..query_api import Filter as _F
        self.filter_fn = None
        for h in stream.handlers:
            if isinstance(h, _F):
                self.filter_fn, _ = builder.build(h.expr)

        # @purge(enable='true', interval='15 min',
        #        @retentionPeriod(sec='120 sec', min='24 hours', ...))
        # (reference: aggregation/IncrementalDataPurger.java)
        from ..query_api.annotation import find_annotation
        purge_ann = find_annotation(definition.annotations, "purge")
        self.purge_enabled = purge_ann is not None and \
            (purge_ann.get("enable") or "true").lower() == "true"
        self.purge_interval = parse_retention(
            (purge_ann.get("interval") if purge_ann else None) or "15 min")
        if self.purge_enabled and self.purge_interval is None:
            raise SiddhiAppRuntimeError(
                "@purge interval must be a time value ('all' is only valid "
                "inside @retentionPeriod)")
        self.retention: dict[TimePeriodDuration, Optional[int]] = \
            dict(_PURGE_DEFAULT_RETENTION)
        rp = purge_ann.nested("retentionPeriod") if purge_ann else None
        if rp is not None:
            keymap = {
                "sec": TimePeriodDuration.SECONDS,
                "min": TimePeriodDuration.MINUTES,
                "hours": TimePeriodDuration.HOURS,
                "days": TimePeriodDuration.DAYS,
                "months": TimePeriodDuration.MONTHS,
                "years": TimePeriodDuration.YEARS,
            }
            for e in rp.elements:
                if e.key is None:
                    continue
                d = keymap.get(e.key.lower())
                if d is None:
                    raise SiddhiAppRuntimeError(
                        f"unknown retentionPeriod key '{e.key}'")
                self.retention[d] = parse_retention(e.value)
        if self.purge_enabled:
            self._arm_purge()

        # -- @device: compile the sec…year rollup to batched segmented
        # reductions (gpu/aggregation_compile.py; reference cascade:
        # aggregation/IncrementalExecutor.java:113-164). Events stage into a
        # columnar micro-batch; the device reduces per-(bucket, key) partials
        # which merge here at bucket granularity. Host fallback on any
        # unsupported shape unless @device(strict='true').
        dev_ann = _find_ann(definition.annotations, "device")
        self._dev = None
        self._dev_builder = None
        if dev_ann is not None:
            from ..gpu.aggregation_compile import CompiledAggregation
            from ..gpu.batch import BatchBuilder
            from ..gpu.expr_compile import DeviceCompileError
            try:
                cap = int(dev_ann.get("batch") or 1024)
                self._dev = CompiledAggregation(definition, self.input_def,
                                                cap, device=device)
                self._dev_builder = BatchBuilder(self._dev.schema, cap)
                self._dev_ts_pos = (
                    self.input_def.attribute_position(
                        definition.aggregate_attribute)
                    if definition.aggregate_attribute is not None else None)
            except DeviceCompileError as e:
                if (dev_ann.get("strict") or "").lower() == "true":
                    raise
                import logging
                logging.getLogger("siddhi_tpu_torch.device").info(
                    "aggregation '%s' stays on the host path: %s",
                    definition.id, e)

    # -- junction receiver ----------------------------------------------------
    def receive(self, event: StreamEvent) -> None:
        if event.type != EventType.CURRENT:
            return
        if self._dev is not None:
            # device mode: stage the raw row; the kernel applies the filter
            # and the bucketing clock column is read positionally
            ts = int(event.data[self._dev_ts_pos]) \
                if self._dev_ts_pos is not None else event.timestamp
            self._dev_builder.append(event.data, ts)
            if self._dev_builder.full:
                self._flush_device()
            return
        frame = StreamFrame(event)
        if self.filter_fn is not None and not bool(self.filter_fn(frame)):
            return
        ts = int(self.ts_fn(frame)) if self.ts_fn is not None else event.timestamp
        key = tuple(fn(frame) for fn in self.group_fns) if self.group_fns else None
        for duration, buckets in self.stores.items():
            bs = bucket_start(ts, duration)
            if self.persist_stores:
                prev_max = self._max_bucket[duration]
                if prev_max is None or bs > prev_max:
                    self._max_bucket[duration] = bs
                    # write-behind: buckets older than the new one completed
                    self._flush_duration(duration, up_to_exclusive=bs)
                self._dirty[duration].add(bs)
            bucket = buckets.setdefault(bs, {})
            state = bucket.get(key)
            if state is None and self.persist_stores:
                # read-through: a bucket reopening after restart/purge must
                # resume from its persisted state — a fresh zero state would
                # clobber the history on the next flush (last-wins append-log)
                state = self._load_persisted_state(duration, bs, key)
                if state is not None:
                    bucket[key] = state
            if state is None:
                state = {
                    "aggs": {
                        name: make_aggregator(agg_name, arg_t)
                        for name, kind, fn, agg_name, rt, arg_t in self.attr_specs
                        if kind == "agg"
                    },
                    "values": {},
                }
                bucket[key] = state
            for name, kind, fn, agg_name, rt, arg_t in self.attr_specs:
                if kind == "agg":
                    state["aggs"][name].add(fn(frame))
                else:
                    state["values"][name] = fn(frame)

    # -- device flush ---------------------------------------------------------
    def _flush_device(self) -> None:
        """Runs the staged micro-batch through the device reducer and merges
        the per-(bucket, key) partials into the bucket stores (including the
        persisted-store write-behind bookkeeping receive() does per event)."""
        if self._dev_builder is None or len(self._dev_builder) == 0:
            return
        from ..gpu.aggregation_compile import merge_partial_into_state
        batch = self._dev_builder.emit()
        slab = self._dev.bucket_slab(batch["ts"])
        fetched = self._dev.step(batch["cols"], batch["ts"], slab,
                                 batch["valid"])
        durations = self.definition.durations
        for di, bs, key, row in self._dev.iter_partials(fetched):
            duration = durations[di]
            buckets = self.stores[duration]
            if self.persist_stores:
                prev_max = self._max_bucket[duration]
                if prev_max is None or bs > prev_max:
                    self._max_bucket[duration] = bs
                    self._flush_duration(duration, up_to_exclusive=bs)
                self._dirty[duration].add(bs)
            bucket = buckets.setdefault(bs, {})
            state = bucket.get(key)
            if state is None and self.persist_stores:
                state = self._load_persisted_state(duration, bs, key)
                if state is not None:
                    bucket[key] = state
            if state is None:
                state = {
                    "aggs": {
                        name: make_aggregator(agg_name, arg_t)
                        for name, kind, fn, agg_name, rt, arg_t
                        in self.attr_specs if kind == "agg"
                    },
                    "values": {},
                }
                bucket[key] = state
            merge_partial_into_state(state, self._dev.specs, row)

    # -- purging --------------------------------------------------------------
    def _arm_purge(self) -> None:
        self.app_context.scheduler.notify_at(
            self.app_context.current_time() + self.purge_interval,
            self._on_purge)

    def _on_purge(self, fire_ts: int) -> None:
        self.purge(fire_ts)
        self.app_context.scheduler.notify_at(
            fire_ts + self.purge_interval, self._on_purge)

    def purge(self, now: Optional[int] = None) -> int:
        """Drop buckets older than the per-duration retention; returns the
        number of buckets removed. The bucket covering `now` is never purged."""
        if now is None:
            now = self.app_context.current_time()
        self._flush_device()          # staged events may reopen old buckets
        removed = 0
        for duration, buckets in self.stores.items():
            ret = self.retention.get(duration)
            if ret is None:
                continue
            if self.persist_stores:
                # a dirty bucket deleted here would be lost from BOTH memory
                # and the store — flush write-behinds before purging
                self._flush_duration(duration)
            cutoff = now - ret
            keep = bucket_start(now, duration)
            for bs in [b for b in buckets if b < cutoff and b != keep]:
                del buckets[bs]
                removed += 1
            store = self.persist_stores.get(duration)
            if store is not None:
                # delete persisted rows past retention when the store can;
                # reads are bounded by the retention cutoff either way
                # (_persisted_rows), so retention semantics match the
                # non-persisted path
                store.record_purge("AGG_TIMESTAMP", min(cutoff, keep))
        return removed

    # -- persisted store I/O ---------------------------------------------------
    @staticmethod
    def _encode_state(key, state: dict) -> str:
        """Typed JSON, NOT pickle: an external store holds data, not code —
        restore must never execute store contents, and the rows stay
        readable by external tools."""
        import json
        payload = {
            "key": _to_jsonable(key),
            "aggs": {n: _to_jsonable(a.snapshot())
                     for n, a in state["aggs"].items()},
            "values": {k: _to_jsonable(v)
                       for k, v in state["values"].items()},
        }
        return json.dumps(payload, separators=(",", ":"))

    def _decode_state(self, blob: str) -> tuple:
        import json
        payload = json.loads(blob)
        state = {
            "aggs": {
                name: make_aggregator(agg_name, arg_t)
                for name, kind, fn, agg_name, rt, arg_t in self.attr_specs
                if kind == "agg"
            },
            "values": {k: _from_jsonable(v)
                       for k, v in payload["values"].items()},
        }
        for n, a in state["aggs"].items():
            a.restore(_from_jsonable(payload["aggs"][n]))
        return _from_jsonable(payload["key"]), state

    def _flush_duration(self, duration, up_to_exclusive=None) -> None:
        store = self.persist_stores.get(duration)
        if store is None:
            return
        dirty = self._dirty[duration]
        buckets = self.stores[duration]
        rows = []
        for bs in sorted(dirty):
            if up_to_exclusive is not None and bs >= up_to_exclusive:
                continue
            for key, state in buckets.get(bs, {}).items():
                rows.append([bs, repr(key), self._encode_state(key, state)])
            dirty.discard(bs)
        if rows:
            # upsert when the store supports it; else append (readers apply
            # last-wins, and the log keeps superseded versions)
            if not store.record_replace(["AGG_TIMESTAMP", "KEY"], rows):
                store.record_add(rows)

    def flush_persisted(self) -> None:
        """Flush every dirty bucket — shutdown/persist barrier (the reference
        drains its CUD queue)."""
        self._flush_device()
        for duration in self.persist_stores:
            self._flush_duration(duration)

    def _load_persisted_state(self, duration, bs: int, key):
        """Newest persisted state for one (bucket, key), or None."""
        store = self.persist_stores.get(duration)
        if store is None:
            return None
        key_repr = repr(key)
        blob = None
        for row_bs, row_key, row_blob in store.record_find({}):
            if int(row_bs) == bs and row_key == key_repr:
                blob = row_blob                 # append order: last wins
        if blob is None:
            return None
        _, state = self._decode_state(blob)
        return state

    def _persisted_rows(self, duration, start=None, end=None) -> dict:
        """{(bucket_ts, key_repr): (key, state)} — newest version wins.
        Bounds filter and last-wins dedup happen BEFORE unpickling, so a
        bounded query doesn't pay for the whole append-log history."""
        store = self.persist_stores.get(duration)
        if store is None:
            return {}
        if self.purge_enabled:
            # retention bounds the merge even when the store can't delete:
            # out-of-retention rows must not resurface through the store
            # (parity with the non-persisted path)
            ret = self.retention.get(duration)
            if ret is not None:
                cut = self.app_context.current_time() - ret
                start = cut if start is None else max(start, cut)
        latest: dict = {}
        for bs, key_repr, blob in store.record_find({}):
            bs = int(bs)
            if start is not None and bs < start:
                continue
            if end is not None and bs >= end:
                continue
            latest[(bs, key_repr)] = blob       # append order: last wins
        out: dict = {}
        for k, blob in latest.items():
            key, state = self._decode_state(blob)
            out[k] = (key, state)
        return out

    # -- retrieval ------------------------------------------------------------
    @property
    def output_names(self) -> list[str]:
        return ["AGG_TIMESTAMP"] + [s[0] for s in self.attr_specs]

    @property
    def output_definition(self):
        from ..query_api.definition import DataType, StreamDefinition
        d = StreamDefinition(self.definition.id)
        d.attribute("AGG_TIMESTAMP", DataType.LONG)
        for name, kind, fn, agg_name, rt, arg_t in self.attr_specs:
            d.attribute(name, rt if rt is not None else DataType.OBJECT)
        return d

    def duration_for(self, per_value: str):
        per = str(per_value).lower().rstrip("s")
        dur_map = {
            "second": TimePeriodDuration.SECONDS, "sec": TimePeriodDuration.SECONDS,
            "minute": TimePeriodDuration.MINUTES, "min": TimePeriodDuration.MINUTES,
            "hour": TimePeriodDuration.HOURS, "day": TimePeriodDuration.DAYS,
            "month": TimePeriodDuration.MONTHS, "year": TimePeriodDuration.YEARS,
        }
        from .errors import SiddhiAppRuntimeError
        if per not in dur_map:
            raise SiddhiAppRuntimeError(
                f"unknown aggregation granularity '{per_value}'")
        d = dur_map[per]
        if d not in self.stores:
            raise SiddhiAppRuntimeError(
                f"aggregation '{self.definition.id}' lacks duration '{d.value}' "
                f"(defined: {[x.value for x in self.stores]})")
        return d

    def rows_for(self, duration: TimePeriodDuration,
                 start: Optional[int] = None, end: Optional[int] = None) -> list[list]:
        self._flush_device()          # reads see every staged event
        buckets = self.stores.get(duration)
        if buckets is None:
            from .errors import SiddhiAppRuntimeError
            raise SiddhiAppRuntimeError(
                f"aggregation '{self.definition.id}' has no duration {duration}")
        # persisted mode: older rollups live in the store; live in-memory
        # buckets overlay them (they're strictly newer)
        merged: dict[int, dict[Any, dict]] = {}
        if self.persist_stores:
            for (bs, _krepr), (key, state) in \
                    self._persisted_rows(duration, start, end).items():
                merged.setdefault(bs, {})[key] = state
        for bs, bucket in buckets.items():
            for key, state in bucket.items():
                merged.setdefault(bs, {})[key] = state
        rows = []
        for bs in sorted(merged):
            if start is not None and bs < start:
                continue
            if end is not None and bs >= end:
                continue
            for key, state in merged[bs].items():
                row = [bs]
                for name, kind, fn, agg_name, rt, arg_t in self.attr_specs:
                    if kind == "agg":
                        row.append(state["aggs"][name].value())
                    else:
                        row.append(state["values"].get(name))
                rows.append(row)
        return rows

    def on_demand_find(self, odq: OnDemandQuery, now: int) -> list[Event]:
        # `within t1 [, t2] per 'duration'`
        duration = self.definition.durations[0]
        if odq.per is not None:
            duration = self.duration_for(odq.per.value)
        start = end = None
        if odq.within:
            vals = [v.value for v in odq.within]
            if len(vals) > 1:
                start, end = parse_within_value(vals[0]), parse_within_value(vals[1])
            else:
                start, end = parse_within_single(vals[0])
        rows = self.rows_for(duration, start, end)

        names = self.output_names
        from .executor import RowFrame, RowResolver
        from ..query_api.definition import DataType
        types = [DataType.LONG] + [s[4] for s in self.attr_specs]
        builder = ExecutorBuilder(RowResolver(names, types), self.app_context)
        if odq.on_condition is not None:
            cond, _ = builder.build(odq.on_condition)
            rows = [r for r in rows if bool(cond(RowFrame(r, now)))]
        attrs = list(odq.selector.attributes)
        if odq.selector.select_all or not attrs:
            return [Event(now, list(r)) for r in rows]
        out = []
        for r in rows:
            frame = RowFrame(r, now)
            out.append(Event(now, [builder.build(a.expr)[0](frame) for a in attrs]))
        return out

    # -- state ----------------------------------------------------------------
    def snapshot_state(self) -> dict:
        self._flush_device()          # checkpoint covers staged events
        enc = {}
        for duration, buckets in self.stores.items():
            enc[duration.value] = {
                bs: {
                    repr(key): {
                        "aggs": {n: a.snapshot() for n, a in st["aggs"].items()},
                        "values": dict(st["values"]),
                        "_key": key,
                    }
                    for key, st in bucket.items()
                }
                for bs, bucket in buckets.items()
            }
        return enc

    def restore_state(self, state: dict) -> None:
        if self._dev_builder is not None and len(self._dev_builder):
            self._dev_builder.emit()          # restore replaces staged rows
        for duration in self.stores:
            self.stores[duration] = {}
            for bs, bucket in state.get(duration.value, {}).items():
                dst = self.stores[duration].setdefault(int(bs), {})
                for _, st in bucket.items():
                    key = st["_key"]
                    new_state = {
                        "aggs": {
                            name: make_aggregator(agg_name, arg_t)
                            for name, kind, fn, agg_name, rt, arg_t in self.attr_specs
                            if kind == "agg"
                        },
                        "values": dict(st["values"]),
                    }
                    for n, a in new_state["aggs"].items():
                        a.restore(st["aggs"][n])
                    dst[key] = new_state
