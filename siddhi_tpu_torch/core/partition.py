"""Partitions: per-key cloned query state.

Reference: ``core/partition/`` — ``PartitionRuntimeImpl``, ``PartitionStreamReceiver``
(key eval & dispatch :82-117), value & range partition executors. Each distinct key
lazily instantiates the inner queries (their windows/aggregators/patterns are
per-key state); inner ``#streams`` are partition-local. The engine runs every
partition here, on the host interpreter, ``@device`` inner queries included;
the device's lane layout of the same per-key instances is
``gpu/partition.py``, driven directly (``PartitionedNFARuntime``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..query_api import Partition, PartitionType, SingleInputStream, StateInputStream, JoinInputStream
from .event import StreamEvent
from .executor import ExecutorBuilder, StreamFrame, StreamResolver
from .query_runtime import QueryRuntime, build_query_runtime
from .stream import StreamJunction


class PartitionKeyExecutor:
    """value partition: expr; range partition: first matching label."""

    def __init__(self, value_fn: Optional[Callable] = None,
                 ranges: Optional[list[tuple[str, Callable]]] = None):
        self.value_fn = value_fn
        self.ranges = ranges or []

    def key_of(self, ev: StreamEvent) -> Optional[Any]:
        if self.value_fn is not None:
            return self.value_fn(StreamFrame(ev))
        for label, cond in self.ranges:
            if bool(cond(StreamFrame(ev))):
                return label
        return None    # no range matched → event dropped (reference behavior)


class PartitionInstance:
    """All inner query runtimes for one partition key."""

    def __init__(self, key: Any, partition: "PartitionRuntime"):
        self.key = key
        self.p = partition
        app_context = partition.app_context
        self.inner_junctions: dict[str, StreamJunction] = {}
        self.inner_defs: dict = {}
        self.query_runtimes: list[QueryRuntime] = []
        # receivers per outer stream id
        self.receivers: dict[str, list] = {}

        # two passes: infer inner stream defs from inner-inserting queries
        for i, q in enumerate(partition.partition_ast.queries):
            name = q.name() or f"{partition.name}-query-{i}"
            rt = build_query_runtime(
                q, app_context, partition.stream_defs,
                self._get_junction, f"{name}-k{key}", inner_defs=self.inner_defs,
                metric_name=name)   # one histogram per LOGICAL query: a
            # tracker per partition key would grow without bound
            self.query_runtimes.append(rt)
            for sid, receiver in rt.subscriptions:
                ist = q.input_stream
                inner = getattr(ist, "is_inner_stream", False) if \
                    isinstance(ist, SingleInputStream) else False
                if inner:
                    self._get_junction(sid, True).subscribe(receiver)
                else:
                    self.receivers.setdefault(sid, []).append(receiver)
            rt.start()
            # register query callbacks attached at partition level
            for cb in partition.query_callbacks.get(q.name(), []):
                rt.add_callback(cb)
            # fill implicit schema of inner target streams
            from ..query_api import InsertIntoStream
            os_ = q.output_stream
            if isinstance(os_, InsertIntoStream) and os_.is_inner_stream:
                d = self.inner_defs.get(os_.target_id)
                j = self.inner_junctions.get(os_.target_id)
                target_def = d if d is not None else (j.definition if j else None)
                if target_def is not None and not target_def.attributes:
                    names, dtypes = rt.output_schema
                    for n, t in zip(names, dtypes):
                        target_def.attribute(n, t)
                    self.inner_defs[os_.target_id] = target_def
            # fill implicit schema of global target streams
            if isinstance(os_, InsertIntoStream) and not os_.is_inner_stream:
                j = partition.get_outer_junction(os_.target_id)
                if not j.definition.attributes:
                    from ..query_api.definition import StreamDefinition
                    names, dtypes = rt.output_schema
                    d = StreamDefinition(os_.target_id)
                    for n, t in zip(names, dtypes):
                        d.attribute(n, t)
                    j.definition = d

    def _get_junction(self, stream_id: str, inner: bool) -> StreamJunction:
        if not inner:
            return self.p.get_outer_junction(stream_id)
        j = self.inner_junctions.get(stream_id)
        if j is None:
            d = self.inner_defs.get(stream_id)
            if d is None:
                from ..query_api.definition import StreamDefinition
                d = StreamDefinition(stream_id)
                self.inner_defs[stream_id] = d
            j = StreamJunction(d, self.p.app_context)
            self.inner_junctions[stream_id] = j
        return j

    def send(self, stream_id: str, event: StreamEvent) -> None:
        for r in self.receivers.get(stream_id, []):
            r.receive(event)


class PartitionStreamReceiver:
    def __init__(self, partition: "PartitionRuntime", stream_id: str,
                 key_executor: Optional[PartitionKeyExecutor]):
        self.partition = partition
        self.stream_id = stream_id
        self.key_executor = key_executor

    def receive(self, event: StreamEvent) -> None:
        if self.key_executor is None:
            # non-partitioned stream inside partition: broadcast to all instances
            for inst in self.partition.instances.values():
                inst.send(self.stream_id, event)
            return
        key = self.key_executor.key_of(event)
        if key is None:
            return
        inst = self.partition.get_instance(key)
        inst.send(self.stream_id, event)


class PartitionRuntime:
    def __init__(self, partition_ast: Partition, app_context, stream_defs: dict,
                 get_junction: Callable, name: str):
        self.partition_ast = partition_ast
        self.app_context = app_context
        self.stream_defs = stream_defs
        self.get_outer_junction = lambda sid, inner=False: get_junction(sid, False)
        self.name = name
        self.instances: dict[Any, PartitionInstance] = {}
        self.key_executors: dict[str, PartitionKeyExecutor] = {}
        self.query_callbacks: dict[str, list] = {}
        app_context.register_state(f"partition-{name}", self)

        for pt in partition_ast.partition_types:
            d = stream_defs[pt.stream_id]
            builder = ExecutorBuilder(StreamResolver(d), app_context)
            if pt.value_expr is not None:
                fn, _ = builder.build(pt.value_expr)
                self.key_executors[pt.stream_id] = PartitionKeyExecutor(value_fn=fn)
            else:
                ranges = [(r.partition_key, builder.build(r.condition)[0])
                          for r in pt.ranges]
                self.key_executors[pt.stream_id] = PartitionKeyExecutor(ranges=ranges)

        # pre-create global junctions for non-inner insert targets so callbacks
        # can attach before the first key instance materializes
        from ..query_api import InsertIntoStream
        for q in partition_ast.queries:
            os_ = q.output_stream
            if isinstance(os_, InsertIntoStream) and not os_.is_inner_stream:
                self.get_outer_junction(os_.target_id)

        # subscribe to every outer stream the inner queries consume
        self.consumed: set[str] = set()
        for q in partition_ast.queries:
            ist = q.input_stream
            if isinstance(ist, SingleInputStream):
                if not ist.is_inner_stream:
                    self.consumed.add(ist.stream_id)
            elif isinstance(ist, StateInputStream):
                self.consumed.update(ist.stream_ids())
            elif isinstance(ist, JoinInputStream):
                for s in (ist.left, ist.right):
                    if not s.is_inner_stream:
                        self.consumed.add(s.stream_id)

    def subscribe_all(self, get_junction: Callable) -> None:
        for sid in self.consumed:
            if sid in self.app_context.tables or sid in self.app_context.named_windows:
                continue
            ke = self.key_executors.get(sid)
            get_junction(sid, False).subscribe(
                PartitionStreamReceiver(self, sid, ke))

    def get_instance(self, key: Any) -> PartitionInstance:
        inst = self.instances.get(key)
        if inst is None:
            inst = PartitionInstance(key, self)
            self.instances[key] = inst
        return inst

    def add_query_callback(self, query_name: str, cb) -> None:
        self.query_callbacks.setdefault(query_name, []).append(cb)
        for inst in self.instances.values():
            for i, q in enumerate(self.partition_ast.queries):
                if q.name() == query_name:
                    inst.query_runtimes[i].add_callback(cb)

    # purge support (reference: @purge annotation) — drop idle keys
    def purge(self, keys: list[Any]) -> None:
        for k in keys:
            self.instances.pop(k, None)

    def snapshot_state(self) -> dict:
        return {"keys": list(self.instances.keys())}

    def restore_state(self, state: dict) -> None:
        for k in state["keys"]:
            self.get_instance(k)
