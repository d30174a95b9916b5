"""Device-path quarantine: a circuit breaker over the card's execution path.

The port's copy of the JAX package's ``resilience/device_guard.py``
(``DeviceGuard``; ``HostStepGuard`` comes with the columnar host tier,
``ROADMAP.md`` §A item 4). Two deliberate differences:

- the host fallback is the scalar interpreter alone
  (``report()["fallback_engine"]`` is ``"scalar"``), where the reference
  tries its columnar host engine first (lifted by ``ROADMAP.md`` §A item 4);
- on the card (``replay_only_chaos``) only an injected ``ChaosFault``
  replays on the host. Any other failure of a step is a fault of a kernel
  or of the card: it counts in ``failures``, logs an ERROR and raises, and
  every later step of the query raises ``DeviceFault`` without touching the
  card. A replay would hide the kernel, and a CUDA fault that poisons the
  context cannot heal, so no probe could re-promote it (lifted when the
  port can tell a transient step failure from a broken kernel,
  ``ROADMAP.md`` §C).

A compile-time failure already falls back to the host interpreter
(``DeviceCompileError`` in ``core/device_bridge.py``); this module covers the
*runtime* gap: a device step that crashes mid-stream used to log and drop its
whole micro-batch. The guard wraps every bridge runtime's ``process``:

- each submitted batch carries a host-side **shadow** of its raw rows
  (``_ShadowBuilder`` wraps the bridge's batch builder);
- a failing step records a breaker failure and replays the shadow through a
  lazily-built host interpreter runtime for the same query (the reference's
  CPU ``QueryRuntime`` role), so no event is lost;
- after ``device.circuit.threshold`` consecutive failures the device path is
  **quarantined** — steps short-circuit straight to the host fallback without
  touching the device — and after ``device.circuit.cooldown.ms`` the next
  batch runs as a half-open probe that re-promotes the device path on
  success.

Parity caveat (documented in DISTRIBUTED.md): the host fallback runtime owns
its own state, so fallback output is exact for stateless queries (filters,
projections); for windowed/pattern/join queries the fallback preserves the
events but its state starts from the quarantine point.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from .chaos import ChaosFault, ChaosInjector
from .circuit import CircuitBreaker, CircuitState

log = logging.getLogger("siddhi_tpu_torch.resilience")


class DeviceFault(RuntimeError):
    """A guarded query on the card whose kernel step failed with something
    other than an injected ``ChaosFault``: every later step raises this."""


class _ShadowCols:
    """Lazy shadow of one columnar chunk slice: the raw column references
    (numpy slices are views — cheap) materialize to replayable rows ONLY
    when a fault actually consumes the shadow (the FleetGuard
    ``admit_columns`` discipline — the zero-object path must not pay a
    per-row Python tax for a replay that almost never happens)."""

    __slots__ = ("cols", "ts", "names")

    def __init__(self, cols: dict, ts, names: list):
        self.cols = cols
        self.ts = ts
        self.names = names

    def rows(self) -> list:
        from ..core.columns import columns_to_rows
        n = int(self.ts.shape[0])
        return [(None, row, int(t)) for row, t in zip(
            columns_to_rows(self.cols, self.names, n), self.ts.tolist())]


class _ShadowBuilder:
    """Batch-builder proxy retaining the raw rows of the batch being packed,
    so a failed device step can replay exactly those events on the host.

    Wraps both builder shapes: ``BatchBuilder.append(row, ts)`` (single
    stream) and ``MergedBatchBuilder.append(stream_id, row, ts)``, plus the
    columnar chunk path (``append_columns`` — shadowed as lazy column
    slices, materialized only on fault). The bulk pre-encoded path
    (``append_many``) has no row-level shadow — batches that used it are
    marked incomplete and a failed step can only count, not replay, them."""

    def __init__(self, inner, merged: bool):
        self._inner = inner
        self._merged = merged
        self._rows: list = []           # (stream_id | None, row, ts)
        self._incomplete = False
        # the per-event path: the builder's own shape, one call, no *args
        self._inner_append = inner.append
        self.append = self._append_merged if merged else self._append_single

    def __len__(self):
        return len(self._inner)

    @property
    def full(self):
        return self._inner.full

    # The shadow keeps a tuple copy of each row where the reference keeps a
    # list: the same snapshot, but a tuple of atoms is one the collector
    # stops tracking, and a list would be walked by every collection until
    # its batch emits.
    def _append_single(self, row, ts) -> None:
        self._inner_append(row, ts)     # may raise OverflowError — first
        self._rows.append((None, tuple(row), ts))

    def _append_merged(self, sid, row, ts) -> None:
        self._inner_append(sid, row, ts)
        self._rows.append((sid, tuple(row), ts))

    def append_rows(self, rows, ts_list) -> None:
        if self._merged:
            # MergedBatchBuilder has no bulk row API; mirroring one here
            # would desynchronize the shadow
            raise TypeError("append_rows is single-stream only")
        for row, ts in zip(rows, ts_list):
            self.append(row, ts)

    def append_sentinel(self, row, ts) -> None:
        """Device-only bookkeeping row (e.g. the timeBatch finalize
        sentinel): packed into the batch but excluded from the host-fallback
        shadow — it is not an event and must never replay."""
        self._inner.append(row, ts)
        self._rows.append(None)

    def append_columns(self, cols: dict, ts, start: int = 0) -> int:
        """Columnar chunk staging WITH a (lazy) shadow: the inner builder
        takes what fits, the shadow keeps references to exactly that slice.
        Without this override ``__getattr__`` would route straight to the
        inner builder and silently leave the shadow missing rows — a failed
        step would then replay a PARTIAL batch."""
        import numpy as np
        ts = np.asarray(ts, dtype=np.int64)
        take = self._inner.append_columns(cols, ts, start)
        if take:
            sl = slice(start, start + take)
            self._rows.append(_ShadowCols(
                {n: cols[n][sl] for n in self._inner.schema.names},
                ts[sl], self._inner.schema.names))
        return take

    def append_many(self, *args, **kwargs):
        self._incomplete = True
        return self._inner.append_many(*args, **kwargs)

    def emit(self) -> dict:
        batch = self._inner.emit()
        batch["_shadow_rows"] = None if self._incomplete else self._rows
        self._rows = []
        self._incomplete = False
        return batch

    def snapshot(self):
        return self._inner.snapshot()

    def restore(self, snap) -> None:
        self._inner.restore(snap)
        # restored staged rows have no shadow — don't mismatch rows to events
        self._rows = []
        self._incomplete = len(self._inner) > 0

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _GuardToken:
    """In-flight pipeline slot: the inner runtime's un-fenced output token
    plus everything needed to replay the batch on the host if the step turns
    out to have failed. Tokens travel the async driver's FIFO ring, so a
    failed batch's host replay runs at its own egress slot — after every
    earlier batch delivered, before every later one — which is what makes a
    mid-pipeline fault unable to reorder or double-emit a micro-batch."""

    __slots__ = ("inner", "shadow", "batch", "failed", "quarantined", "seq")

    def __init__(self, inner, shadow, batch, failed=False, quarantined=False,
                 seq=0):
        self.inner = inner
        self.shadow = shadow
        self.batch = batch
        self.failed = failed
        self.quarantined = quarantined
        self.seq = seq                  # the guard's dispatch count


class DeviceGuard:
    """Wraps one device bridge runtime with failure capture + quarantine.

    The wrap is two-phase, matching the pipelined runtime API: ``dispatch``
    captures the batch's host shadow and fires the inner step (fire-and-
    forget — an asynchronously dispatched step's failure may only surface at
    the fence), ``collect`` fences and, on failure, replays the shadow
    through the host fallback at the token's own FIFO egress slot. The
    synchronous path (``rt.process``) goes through the same two wrapped
    phases back-to-back."""

    def __init__(self, query, query_name: str, app_context, stream_defs: dict,
                 get_junction: Callable, kind: str,
                 failure_threshold: int = 3, cooldown_s: float = 30.0,
                 chaos: Optional[ChaosInjector] = None,
                 replay_only_chaos: bool = False):
        self.query = query
        self.query_name = query_name
        self.app_context = app_context
        self.stream_defs = dict(stream_defs)
        self.get_junction = get_junction
        self.kind = kind
        self.breaker = CircuitBreaker(failure_threshold, cooldown_s)
        self.chaos = chaos
        # True on the card: see the module docstring
        self.replay_only_chaos = replay_only_chaos
        self.fault = None               # the first unreplayable failure
        self._fault_seq = None          # ... and its batch's dispatch count
        self._seq = 0
        self._site = f"device:{app_context.name}/{query_name}"
        self.failures = 0
        self.fallback_events = 0        # events replayed through the host
        self.lost_events = 0            # shadow-less batches (bulk ingress)
        self.bridge = None              # set by guard_device for callbacks
        self.flight = None              # FlightRecorder: stays None until
        # the observability tier (ROADMAP.md §A item 3)
        self._last_step_fell_back = False
        self._fb_runtime = None
        self._fb_engine = None          # 'scalar' once built
        self._fb_lock = threading.Lock()

    # -- installation --------------------------------------------------------
    def install(self, rt) -> None:
        """Wrap ``rt.dispatch``/``rt.collect`` and ``rt.builder`` in place
        (instance attributes shadow the methods). Both execution paths go
        through the wrapped pair: the async driver calls dispatch/collect
        directly; the sync path's ``rt.process`` is defined as
        ``collect(dispatch(batch))`` and resolves the instance attributes."""
        rt.builder = _ShadowBuilder(rt.builder, merged=self.kind != "stream")
        inner_dispatch = rt.dispatch
        inner_collect = rt.collect
        rt.dispatch = lambda batch: self.dispatch(inner_dispatch, batch)
        rt.collect = lambda token: self.collect(inner_collect, token)
        # failed/quarantined steps time the HOST replay, not the device —
        # feeding those samples to the adaptive batch controller would tune
        # it on latencies unrelated to device performance. The observability
        # probe must still see the step (device_path=False) or its pending
        # trace groups would pile up for the whole quarantine.
        inner_observe = getattr(rt, "observe_step", None)
        if inner_observe is not None:
            def observe(n_events, latency_s, device_path=True, phases=None):
                inner_observe(
                    n_events, latency_s,
                    device_path=device_path and not self._last_step_fell_back,
                    phases=phases)
            rt.observe_step = observe

    # -- two-phase step ------------------------------------------------------
    def dispatch(self, inner_dispatch, batch: dict) -> _GuardToken:
        """Fire the inner step; failures (chaos injection, jit trace errors,
        an open circuit) do NOT raise — they ride the returned token to its
        FIFO egress slot, where the host replay happens in order. On the
        card only an injected ``ChaosFault`` does; any other failure
        raises (``_raise_unreplayable``)."""
        shadow = batch.pop("_shadow_rows", None)
        self._seq += 1
        seq = self._seq
        self._raise_if_faulted(seq)
        if not self.breaker.allow():
            return _GuardToken(None, shadow, batch,
                               failed=True, quarantined=True, seq=seq)
        try:
            if self.chaos is not None:
                self.chaos.on_device(self._site)
            inner = inner_dispatch(batch)
        except Exception as e:  # noqa: BLE001 — quarantine boundary: the
            # failed batch reroutes to the host path, the app keeps running
            self._raise_unreplayable(e, seq)
            self._record_failure(e)
            return _GuardToken(None, shadow, batch, failed=True, seq=seq)
        return _GuardToken(inner, shadow, batch, seq=seq)

    def collect(self, inner_collect, token: _GuardToken) -> list:
        """Egress edge: fence the inner token (an async-dispatched step's
        failure surfaces HERE, not at dispatch) and replay the shadow on
        failure. Called strictly FIFO by the driver — earlier batches have
        already delivered, so replay cannot reorder."""
        # a batch after a faulted one delivers nothing, even one that was
        # dispatched before the fault surfaced at the earlier batch's fence
        self._raise_if_faulted(token.seq)
        if token.failed:
            self._last_step_fell_back = True
            self._host_fallback(token.shadow, token.batch,
                                quarantined=token.quarantined)
            return []
        try:
            rows = inner_collect(token.inner)
        except Exception as e:  # noqa: BLE001 — same quarantine boundary,
            # one pipeline stage later
            self._raise_unreplayable(e, token.seq)
            self._record_failure(e)
            self._last_step_fell_back = True
            self._host_fallback(token.shadow, token.batch)
            return []
        self.breaker.record_success()
        self._last_step_fell_back = False
        return rows

    def _raise_if_faulted(self, seq: int) -> None:
        if self.fault is not None and seq > self._fault_seq:
            raise DeviceFault(f"{self._site}: the device step failed "
                              f"earlier: {self.fault!r}") from self.fault

    def _raise_unreplayable(self, e: Exception, seq: int) -> None:
        """On the card, re-raise every failure but an injected one, and
        remember it: the query's later steps raise without a launch, and
        the breaker is left alone, since an OPEN circuit would replay them
        all on the host."""
        if not self.replay_only_chaos or isinstance(e, ChaosFault):
            return
        self.failures += 1
        if self.fault is None:
            self.fault, self._fault_seq = e, seq
        log.error("%s: device step failed on the card; not replayed on the "
                  "host: %s", self._site, e, exc_info=True)
        raise e

    def _record_failure(self, e: Exception) -> None:
        self.failures += 1
        was_open = self.breaker.state == CircuitState.OPEN
        self.breaker.record_failure()
        log.warning("%s: device step failed (%d consecutive, circuit %s)"
                    ": %s", self._site,
                    self.breaker.consecutive_failures,
                    self.breaker.state, e, exc_info=True)
        fl = self.flight
        if fl is not None:
            fl.record("device", "step_failed", site=self.query_name,
                      detail={"error": f"{type(e).__name__}: {e}"[:200]})
            if not was_open and self.breaker.state == CircuitState.OPEN:
                # quarantine engaged: dump the control-plane timeline so the
                # post-mortem ships with the fault
                fl.record("device", "quarantined", site=self.query_name)
                fl.on_fault("device_quarantine", site=self.query_name)

    # -- host fallback -------------------------------------------------------
    def _fallback_runtime(self):
        # root_lock FIRST (consistent with the sync delivery path, where it
        # is already held): building registers state holders in
        # app_context.state_registry, which the snapshot walk iterates under
        # the same lock — an unlocked build from the async worker would race
        # it. _fb_lock then serializes the build itself.
        with self.app_context.root_lock:
            with self._fb_lock:
                if self._fb_runtime is None:
                    # the reference builds its columnar host engine first
                    # (core/host_bridge.py, vectorized micro-batches) and
                    # takes this scalar interpreter only when that build
                    # fails; the port has no columnar host tier until
                    # ROADMAP.md §A item 4, so it always takes this branch
                    from ..core.query_runtime import build_query_runtime
                    self._fb_runtime = build_query_runtime(
                        self.query, self.app_context, self.stream_defs,
                        self.get_junction, f"{self.query_name}__hostfb")
                    self._fb_engine = "scalar"
                    if self.bridge is not None:
                        # SHARE the bridge's query-callback list: callbacks
                        # registered on the device query (now or later) see
                        # fallback outputs too, not just on-device ones
                        self._fb_runtime.callback_adapter.callbacks = \
                            self.bridge.query_callbacks
                    self._fb_runtime.start()
                return self._fb_runtime

    def _host_fallback(self, shadow, batch: dict,
                       quarantined: bool = False) -> None:
        if shadow is None:
            n = int(batch.get("count", 0))
            self.lost_events += n
            log.error("%s: no host shadow for a failed batch of %d events "
                      "(bulk-ingress batches cannot be replayed)",
                      self._site, n)
            return
        # None markers are append_sentinel() bookkeeping rows, not events;
        # _ShadowCols markers are lazy columnar slices — they materialize
        # to rows HERE, on the fault path only
        expanded: list = []
        for s in shadow:
            if s is None:
                continue
            if isinstance(s, _ShadowCols):
                expanded.extend(s.rows())
            else:
                expanded.append(s)
        shadow = expanded
        if not shadow:
            return
        rt = self._fallback_runtime()
        receivers = rt.subscriptions        # [(stream_id, receiver)]
        from ..core.event import EventType, StreamEvent
        delivered = 0
        with self.app_context.root_lock:
            for sid, row, ts in shadow:
                ev = StreamEvent(ts, list(row), EventType.CURRENT)
                for rsid, receiver in receivers:
                    if sid is None or rsid == sid:
                        receiver.receive(ev)
                delivered += 1
        self.fallback_events += delivered
        log.info("%s: %d event(s) rerouted through the host path%s",
                 self._site, delivered,
                 " (device quarantined)" if quarantined else "")

    # -- introspection -------------------------------------------------------
    def report(self) -> dict:
        return {
            "query": self.query_name,
            "circuit": self.breaker.state,
            "failures": self.failures,
            "fallback_events": self.fallback_events,
            "lost_events": self.lost_events,
            # which engine replays shadows: 'scalar' in the port (the
            # reference may say 'columnar'); None until the first fallback
            "fallback_engine": self._fb_engine,
        }
