"""Device stream runtime: micro-batching front end over a compiled query.

Port of the reference's ``tpu/runtime.py`` (``DeviceStreamRuntime``): host
rows accumulate in a staging buffer; when a micro-batch fills (or
``flush()`` is called) one step runs (on the card through
``csrc/query_step.cu`` or ``csrc/query_walk.cu``, or the plain version with
``device="cpu"``) and decoded rows go to the callback. A ``hopping`` window
fires at most B boundaries a step; ``flush`` and ``collect`` step empty
batches until the next boundary lies in the future
(``drain_hop_boundaries``), so a runtime that pipelines steps keeps one in
flight for it (``pipeline_safe``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..compiler import parse as _parse
from .batch import BatchBuilder, device_state_restore, device_state_snapshot
from .query_compile import TS_NEG, CompiledStreamQuery
from .state_io import query_state_from_numpy


def drain_hop_boundaries(compiled, state, drain_builder, on_out):
    """Steps empty batches while the next hop boundary lies at or before the
    newest event (a time gap can span more boundaries than one step's B
    flush slots), handing each step's outputs to ``on_out``; returns the
    advanced state. One host read of ``hop_next``/``last_ts`` per step."""
    while True:
        hop_next, last_ts = (int(v) for v in torch.stack(
            [state["hop_next"], state["last_ts"]]).tolist())
        if hop_next <= TS_NEG or hop_next > last_ts:
            return state
        state, out = compiled.step(state, drain_builder.emit())
        on_out(out)


class DeviceStreamRuntime:
    """``device`` follows ``backend.resolve_device``: the card unless the
    caller passes ``device="cpu"``."""

    def __init__(self, app_or_text, batch_capacity: int = 4096,
                 group_capacity: int = 1024, query_index: int = 0,
                 window_capacity: int = 4096, device=None):
        app = _parse(app_or_text) if isinstance(app_or_text, str) else app_or_text
        queries = app.queries
        if not queries:
            raise ValueError("no queries in app")
        query = queries[query_index]
        sid = query.input_stream.stream_id
        if sid not in app.stream_definitions:
            raise KeyError(f"stream '{sid}' not defined")
        self.definition = app.stream_definitions[sid]
        self.compiled = CompiledStreamQuery(
            query, self.definition, batch_capacity, group_capacity,
            window_capacity, device=device)
        self.device = self.compiled.device
        self.builder = BatchBuilder(self.compiled.schema, batch_capacity)
        self.state = self.compiled.init_state()
        self.callback: Optional[Callable[[list[list]], None]] = None
        self._pending_out = []
        # hopping reads the dispatched step's state inside collect(): a
        # pipeline keeps exactly one step in flight for it
        self.pipeline_safe = self.compiled.window_kind != "hopping"
        # the empty batches of the drain (the live builder may already hold
        # the next batch's rows when collect() runs)
        self._drain_builder = BatchBuilder(self.compiled.schema,
                                           batch_capacity)

    def add_callback(self, fn: Callable[[list[list]], None]) -> None:
        self.callback = fn

    def send(self, row: list, timestamp: int = 0) -> None:
        self.builder.append(row, timestamp)
        if self.builder.full:
            self.flush()

    def flush(self, decode: bool = True) -> None:
        if len(self.builder):
            self._deliver(self.dispatch(self.builder.emit()), decode)
        if self.compiled.window_kind == "hopping":
            self.state = drain_hop_boundaries(
                self.compiled, self.state, self._drain_builder,
                lambda out: self._deliver(out, decode))

    # -- two-phase step -------------------------------------------------------
    def dispatch(self, batch: dict):
        """Runs one step without waiting for the card; the returned output
        tree is the token ``collect`` decodes."""
        self.state, out = self.compiled.step(self.state, batch)
        return out

    def collect(self, out) -> list[list]:
        """Decodes one dispatched step (the copy to the host waits for it);
        a hopping window drains its deferred boundaries here."""
        rows = self.compiled.decode_outputs(out)
        if self.compiled.window_kind == "hopping":
            self.state = drain_hop_boundaries(
                self.compiled, self.state, self._drain_builder,
                lambda o: rows.extend(self.compiled.decode_outputs(o)))
        return rows

    def process(self, batch: dict) -> list[list]:
        return self.collect(self.dispatch(batch))

    def _deliver(self, out, decode: bool) -> None:
        if decode:
            rows = self.compiled.decode_outputs(out)
            if self.callback is not None and rows:
                self.callback(rows)
        else:
            self._pending_out.append(out)

    @property
    def group_collision_count(self) -> int:
        """Events whose group landed in a bucket owned by a different key
        (more than K groups, or a hash collision). Non-zero means those
        events' group aggregates are unreliable: widen ``group_capacity``."""
        c = self.state.get("group_collisions")
        return int(c) if c is not None else 0

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- checkpointing: the state tree + the string dictionary ----------------
    def snapshot_state(self) -> dict:
        return device_state_snapshot(self.state, self.compiled.schema)

    def restore_state(self, state) -> None:
        self.state = device_state_restore(
            state, self.compiled.schema,
            lambda tree: query_state_from_numpy(self.compiled, tree,
                                                self.device))
