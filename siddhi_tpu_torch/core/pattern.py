"""NFA pattern & sequence engine (host interpreter).

Reference: ``core/query/input/stream/state/`` — ``StreamPreStateProcessor`` (pending
partial-match lists, ``processAndReturn:364``), ``StreamPostStateProcessor`` (NFA
advance), ``LogicalPreStateProcessor`` (and/or), ``CountPreStateProcessor`` (<m:n>),
``AbsentStreamPreStateProcessor`` (scheduler-driven non-occurrence), plus the
``every`` re-seeding protocol (``addEveryState``). Redesigned: the state-element tree
compiles to a flat list of ``StateNode``s; partial matches are ``StateEvent``s held
in per-node pending lists; events are applied to nodes in reverse order so one event
cannot advance a single partial through two states. The device compiler
(``gpu/nfa.py``) consumes the same flat node list (``PatternCompiler``) and
re-walks the filter ASTs itself; ``PatternRuntime`` is the host interpreter
that runs a pattern query the engine does not put on the device.

Semantics notes (matching the reference):
- PATTERN = skip-till-any-match between states; SEQUENCE = strict continuity (any
  event on the pattern's streams that cannot extend a partial kills it).
- ``every`` scope re-seeds when its last node advances, cloning the advancing
  partial minus the scope's own bindings.
- ``<m:n>`` counting accumulates in place; at ``min`` occurrences the same partial
  becomes eligible at the successor node (shared reference, not a copy).
- ``within`` drops partials whose candidate event is too late vs. the first bound
  event (stream-level) or the previous element's bind time (element-level).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..query_api import (
    AbsentStreamStateElement,
    CountStateElement,
    EveryStateElement,
    LogicalStateElement,
    LogicalType,
    NextStateElement,
    StateElement,
    StateInputStream,
    StateInputStreamType,
    StreamStateElement,
)
from .event import EventType, PatternEvent, StateEvent, StreamEvent
from .executor import ExecutorBuilder, StateFrame, StateResolver


@dataclass
class Branch:
    stream_id: str
    alias: str
    filter_fn: Optional[Callable] = None     # built after alias map known
    is_absent: bool = False


@dataclass
class StateNode:
    index: int
    kind: str                                 # 'stream' | 'logical' | 'count' | 'absent'
    branches: list[Branch] = field(default_factory=list)
    logical_type: Optional[LogicalType] = None
    min_count: int = 1
    max_count: int = 1                        # -1 = unbounded
    waiting_time_ms: Optional[int] = None     # absent `for`
    within_ms: Optional[int] = None           # element-level within
    reseed_to: Optional[int] = None           # every-scope start (on this node's advance)
    reseed_aliases: list[str] = field(default_factory=list)   # aliases to clear on reseed

    @property
    def is_count(self) -> bool:
        return self.kind == "count"


class PatternCompiler:
    """State-element tree → flat StateNode list + alias→definition map."""

    def __init__(self, state_stream: StateInputStream, stream_defs: dict):
        self.state_stream = state_stream
        self.stream_defs = stream_defs
        self.nodes: list[StateNode] = []
        self.alias_defs: dict[str, Any] = {}
        self.alias_is_list: dict[str, bool] = {}
        self._auto = itertools.count()
        self._filters: list[tuple[Branch, Any]] = []   # (branch, filter AST)

    def compile(self) -> "CompiledPattern":
        self._flatten(self.state_stream.state)
        # build filter executors now that every alias is known
        for branch, filter_ast in self._filters:
            if filter_ast is None:
                continue
            resolver = StateResolver(self.alias_defs, default_alias=branch.alias)
            builder = ExecutorBuilder(resolver)
            branch.filter_fn, _ = builder.build(filter_ast)
        within = None
        if self.state_stream.within is not None:
            within = self.state_stream.within.value
        return CompiledPattern(
            nodes=self.nodes,
            alias_defs=self.alias_defs,
            alias_is_list=self.alias_is_list,
            within_ms=within,
            is_sequence=self.state_stream.type == StateInputStreamType.SEQUENCE,
        )

    # -- flattening -----------------------------------------------------------
    def _flatten(self, el: StateElement) -> tuple[int, int]:
        """Returns (first_node_index, last_node_index) of the flattened element."""
        if isinstance(el, NextStateElement):
            first, _ = self._flatten(el.first)
            _, last = self._flatten(el.next)
            return first, last
        if isinstance(el, EveryStateElement):
            start = len(self.nodes)
            first, last = self._flatten(el.inner)
            node = self.nodes[last]
            node.reseed_to = first
            node.reseed_aliases = [
                b.alias for n in self.nodes[first:last + 1] for b in n.branches
            ]
            if el.within is not None:
                for n in self.nodes[first:last + 1]:
                    n.within_ms = el.within.value
            return first, last
        if isinstance(el, StreamStateElement):
            node = self._new_node("stream")
            node.branches.append(self._branch(el.stream))
            if el.within is not None:
                node.within_ms = el.within.value
            return node.index, node.index
        if isinstance(el, CountStateElement):
            node = self._new_node("count")
            node.branches.append(self._branch(el.stream.stream))
            node.min_count = el.min_count
            node.max_count = el.max_count
            self.alias_is_list[node.branches[0].alias] = True
            if el.within is not None:
                node.within_ms = el.within.value
            return node.index, node.index
        if isinstance(el, LogicalStateElement):
            node = self._new_node("logical")
            node.logical_type = el.type
            for sub in (el.first, el.second):
                if isinstance(sub, AbsentStreamStateElement):
                    b = self._branch(sub.stream)
                    b.is_absent = True
                    node.branches.append(b)
                    if sub.waiting_time_ms is not None:
                        node.waiting_time_ms = sub.waiting_time_ms
                else:
                    node.branches.append(self._branch(sub.stream))
            if el.within is not None:
                node.within_ms = el.within.value
            return node.index, node.index
        if isinstance(el, AbsentStreamStateElement):
            node = self._new_node("absent")
            b = self._branch(el.stream)
            b.is_absent = True
            node.branches.append(b)
            node.waiting_time_ms = el.waiting_time_ms
            if el.within is not None:
                node.within_ms = el.within.value
            return node.index, node.index
        raise ValueError(f"unsupported state element {el!r}")

    def _new_node(self, kind: str) -> StateNode:
        node = StateNode(index=len(self.nodes), kind=kind)
        self.nodes.append(node)
        return node

    def _branch(self, stream) -> Branch:
        sid = stream.stream_id
        if sid not in self.stream_defs:
            raise KeyError(f"pattern references undefined stream '{sid}'")
        alias = stream.alias or f"${next(self._auto)}"
        if alias in self.alias_defs and stream.alias is not None:
            raise ValueError(f"duplicate pattern alias '{alias}'")
        self.alias_defs[alias] = self.stream_defs[sid]
        filter_ast = None
        from ..query_api import And as _And, Filter as _F
        for h in stream.handlers:
            if isinstance(h, _F):
                filter_ast = h.expr if filter_ast is None else _And(filter_ast, h.expr)
            else:
                # loud, not silent: windows / stream functions on pattern
                # stream elements aren't modelled by this NFA (reference
                # allows them via SingleInputStreamParser.java:83)
                raise ValueError(
                    f"pattern stream '{sid}': handler {type(h).__name__} "
                    f"is not supported inside pattern/sequence elements")
        b = Branch(stream_id=sid, alias=alias)
        self._filters.append((b, filter_ast))
        return b


@dataclass
class CompiledPattern:
    nodes: list[StateNode]
    alias_defs: dict[str, Any]
    alias_is_list: dict[str, bool]
    within_ms: Optional[int]
    is_sequence: bool

    @property
    def stream_ids(self) -> list[str]:
        seen, out = set(), []
        for n in self.nodes:
            for b in n.branches:
                if b.stream_id not in seen:
                    seen.add(b.stream_id)
                    out.append(b.stream_id)
        return out


class PatternRuntime:
    """Executes a CompiledPattern; emits PatternEvents to ``self.next``."""

    def __init__(self, compiled: CompiledPattern, app_context, element_id: str):
        self.c = compiled
        self.app_context = app_context
        self.element_id = element_id
        self.pending: list[list[StateEvent]] = [[] for _ in compiled.nodes]
        self.next = None      # selector
        self.started = False
        self._created: set[int] = set()   # ids of partials placed this event
        app_context.register_state(element_id, self)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self.started:
            return
        self.started = True
        seed = StateEvent()
        self._place(0, seed, self.app_context.current_time())

    def _place(self, node_idx: int, p: StateEvent, now: int) -> None:
        """Put a partial at a node, handling absent timers and zero-min counts."""
        if node_idx >= len(self.c.nodes):
            self._emit(p, now)
            return
        node = self.c.nodes[node_idx]
        self.pending[node_idx].append(p)
        self._created.add(id(p))
        if node.kind in ("absent", "logical") and \
                node.waiting_time_ms is not None:
            # absent nodes AND logical nodes with an `... for t` side start
            # their non-occurrence clock on arrival at the state
            arrival_key = f"absent_arrival_{node.index}"
            p.meta[arrival_key] = now
            fire_at = now + node.waiting_time_ms
            self.app_context.scheduler.notify_at(
                fire_at, lambda ts, ni=node_idx, pp=p: self._absent_timer(ni, pp, ts))
        if node.is_count and node.min_count == 0:
            if node_idx == len(self.c.nodes) - 1:
                # final zero-min count: a partial ARRIVING here with earlier
                # bindings is already complete (reference emits immediately
                # with the count empty; SequenceTestCase.testQuery3). A bare
                # seed stays pending — emitting it would recurse through the
                # every-reseed forever with no event driving it.
                if p.events:
                    self._emit_from(node, p, now)
                    self._remove_everywhere(p)
                return
            # zero occurrences allowed: immediately eligible at the successor
            self._make_eligible(node_idx, p, now)

    def _make_eligible(self, count_idx: int, p: StateEvent, now: int) -> None:
        nxt = count_idx + 1
        if nxt >= len(self.c.nodes):
            # count node is final: emission happens on min-reach (handled in step)
            return
        if p not in self.pending[nxt]:
            self.pending[nxt].append(p)     # shared reference, per reference semantics
        node = self.c.nodes[nxt]
        if node.kind in ("absent", "logical") and \
                node.waiting_time_ms is not None:
            arrival_key = f"absent_arrival_{node.index}"
            if arrival_key not in p.meta:
                p.meta[arrival_key] = now
                self.app_context.scheduler.notify_at(
                    now + node.waiting_time_ms,
                    lambda ts, ni=nxt, pp=p: self._absent_timer(ni, pp, ts))

    # -- event handling -------------------------------------------------------
    def receive(self, event: StreamEvent, stream_id: str) -> None:
        if event.type != EventType.CURRENT:
            return
        if not self.started:
            self.start()
        touched: set[int] = set()
        self._created = set()
        created = self._created
        matched_any = False

        for i in range(len(self.c.nodes) - 1, -1, -1):
            node = self.c.nodes[i]
            listens = [b for b in node.branches if b.stream_id == stream_id]
            if not listens:
                continue
            for p in list(self.pending[i]):
                if id(p) in created:
                    continue
                if self._expired_partial(node, p, event.timestamp):
                    self._remove_everywhere(p)
                    # an `every` scope whose instance expired re-initializes
                    # its start state, and the CURRENT event may consume the
                    # fresh seed (reference StreamPreStateProcessor expiry +
                    # init; WithinPatternTestCase.testQuery4)
                    reseeded = self._reseed_on_expiry(i, p, event.timestamp)
                    if reseeded is not None:
                        seed, start = reseeded
                        # start < i is revisited by the reverse loop; a seed
                        # landing AT i must be offered this event explicitly
                        # (the loop iterates a snapshot of pending[i])
                        if start == i and seed in self.pending[start]:
                            slist = [b for b in self.c.nodes[start].branches
                                     if b.stream_id == stream_id]
                            if slist:
                                self._try_match(start, self.c.nodes[start],
                                                slist, seed, event, touched,
                                                created)
                    continue
                res = self._try_match(i, node, listens, p, event, touched, created)
                matched_any = matched_any or res

        if self.c.is_sequence:
            self._enforce_strict(stream_id, event, touched, created)

    def _reseed_on_expiry(self, i: int, p: StateEvent, now: int):
        """Re-seed the `every` scope after its pending instance expired or
        was strict-killed at node i. The scope is [reseed_to .. j] of an
        every end-node: ENCLOSING (reseed_to ≤ i ≤ j) or — when the partial
        had already advanced PAST the scope before dying — the nearest
        preceding end-node j < i (fuzz regression: `every e1=A[..]<1:3> ->
        e2=B[..]` killed at e2 by `within` never re-seeded, losing every
        later chain). Returns the new seed."""
        ends = [j for j in range(i, len(self.c.nodes))
                if self.c.nodes[j].reseed_to is not None
                and self.c.nodes[j].reseed_to <= i]
        if not ends:
            ends = [j for j in range(i - 1, -1, -1)
                    if self.c.nodes[j].reseed_to is not None][:1]
        for j in ends:
            node_j = self.c.nodes[j]
            start = node_j.reseed_to
            # another live instance of the scope → nothing to re-seed
            if any(self.pending[k] for k in range(start, j + 1)):
                return None
            seed = self._build_seed(node_j, p)
            self._place(start, seed, now)
            # unlike completion re-seeds, an expiry re-seed is visible to
            # the event being processed (the reference re-inits the start
            # state during expiry, before matching)
            self._created.discard(id(seed))
            return seed, start
        return None

    def _expired_partial(self, node: StateNode, p: StateEvent, ts: int) -> bool:
        w = self.c.within_ms
        if w is not None and p.first_timestamp is not None and ts - p.first_timestamp > w:
            return True
        if node.within_ms is not None and p.timestamp is not None \
                and ts - p.timestamp > node.within_ms:
            return True
        return False

    def _try_match(self, i: int, node: StateNode, branches: list[Branch],
                   p: StateEvent, event: StreamEvent,
                   touched: set[int], created: set[int]) -> bool:
        now = event.timestamp
        matched = False
        for b in branches:
            frame = StateFrame(p, current_alias=b.alias, current_event=event)
            ok = True
            if b.filter_fn is not None:
                ok = bool(b.filter_fn(frame))
            if not ok:
                continue
            matched = True
            touched.add(id(p))
            if b.is_absent:
                if node.index == 0 and node.kind == "logical" \
                        and node.waiting_time_ms is not None:
                    # start-state `X and/or not Y for t`: the forbidden event
                    # RESTARTS the wait (reference keeps start states live;
                    # LogicalAbsentPatternTestCase.testQueryAbsent8_2/10)
                    arrival_key = f"absent_arrival_{node.index}"
                    p.meta[arrival_key] = now
                    p.meta.pop(f"logical_established_{i}", None)
                    self.app_context.scheduler.notify_at(
                        now + node.waiting_time_ms,
                        lambda ts, ni=i, pp=p: self._absent_timer(ni, pp, ts))
                    return True
                if node.kind == "logical" \
                        and node.logical_type == LogicalType.OR:
                    # `... or not Y for t`: Y's arrival only kills the
                    # ABSENT alternative — the present side can still match
                    # later (reference LogicalAbsentPatternTestCase
                    # testQueryAbsent15)
                    p.meta[f"logical_absent_dead_{i}"] = True
                    return True
                if node.index == 0 and node.kind == "absent" \
                        and node.waiting_time_ms is not None:
                    # start-state absent: the forbidden event RESTARTS the
                    # wait instead of killing the pattern (reference
                    # AbsentStreamPreStateProcessor keeps start states live;
                    # AbsentPatternTestCase.testQueryAbsent6/8)
                    arrival_key = f"absent_arrival_{node.index}"
                    p.meta[arrival_key] = now
                    self.app_context.scheduler.notify_at(
                        now + node.waiting_time_ms,
                        lambda ts, ni=i, pp=p: self._absent_timer(ni, pp, ts))
                    return True
                # the forbidden event arrived → kill the partial
                self._remove_everywhere(p)
                return True
            if node.kind == "stream":
                # an open count node the partial is leaving completes its
                # `every` scope now (the scope's reseed lives on the count
                # node; consumption is its completion —
                # SequenceTestCase.testQuery4 shape)
                prev_reseed = None
                if i > 0:
                    prev = self.c.nodes[i - 1]
                    if prev.is_count and prev.reseed_to is not None \
                            and p in self.pending[i - 1]:
                        prev_reseed = prev
                # consume from EVERY node (count partials are shared into the
                # successor's pending via _make_eligible — advancing must
                # consume the count instance too, reference
                # CountPatternTestCase.testQuery2)
                self._remove_everywhere(p)
                adv = p.copy()
                adv.bind(b.alias, event)
                if prev_reseed is not None:
                    self._do_reseed(prev_reseed, p, now)
                self._advance(node, adv, now)
            elif node.kind == "count":
                p.bind(b.alias, event, append=True)
                cnt = len(p.events[b.alias])
                if cnt >= node.min_count:
                    if i == len(self.c.nodes) - 1:
                        # final count node: emit ONCE at min-count and
                        # consume (reference CountPatternTestCase.testQuery13
                        # — further extensions do not re-emit)
                        self._emit_from(node, p, now)
                        self._remove_everywhere(p)
                        return True
                    self._make_eligible(i, p, now)
                if node.max_count != -1 and cnt >= node.max_count:
                    if p in self.pending[i]:
                        self.pending[i].remove(p)
                    # a maxed-out count node ends its own `every` scope: the
                    # scope restarts while the closed partial waits at the
                    # successor (SequenceTestCase.testQuery6: `every e1?`)
                    if node.reseed_to is not None:
                        self._do_reseed(node, p, now)
            elif node.kind == "logical":
                other = [x for x in node.branches if x is not b]
                p.bind(b.alias, event)
                sides = p.meta.setdefault(f"logical_{i}", set())
                sides.add(b.alias)
                need_both = node.logical_type == LogicalType.AND
                if need_both:
                    # ONE event can satisfy both AND sides (the reference's
                    # two pre-state processors each receive it;
                    # LogicalPatternTestCase.testQuery5)
                    for ob in other:
                        # b is a listening branch, so b.stream_id IS the
                        # current event's stream
                        if ob.is_absent or ob.alias in sides or \
                                ob.stream_id != b.stream_id:
                            continue
                        oframe = StateFrame(p, current_alias=ob.alias,
                                            current_event=event)
                        if ob.filter_fn is None or bool(ob.filter_fn(oframe)):
                            p.bind(ob.alias, event)
                            sides.add(ob.alias)
                absent_other = other and other[0].is_absent
                done = (not need_both) or absent_other or all(
                    x.alias in sides for x in node.branches if not x.is_absent
                )
                if done and not absent_other:
                    self.pending[i].remove(p)
                    adv = p.copy()
                    adv.meta.pop(f"logical_{i}", None)
                    self._advance(node, adv, now)
                elif done and absent_other:
                    # `X or not Y for t`: X advances immediately (first of
                    # the two alternatives wins). `X and not Y [for t]`:
                    # advance if no timer is required, or if the
                    # non-occurrence was already established; otherwise the
                    # timer decides later.
                    established = p.meta.get(f"logical_established_{i}")
                    if node.logical_type == LogicalType.OR \
                            or node.waiting_time_ms is None \
                            or established is not None:
                        self.pending[i].remove(p)
                        adv = p.copy()
                        adv.meta.pop(f"logical_{i}", None)
                        adv.meta.pop(f"logical_established_{i}", None)
                        self._advance(node, adv, now)
            break
        return matched

    def _advance(self, node: StateNode, p: StateEvent, now: int) -> None:
        self._do_reseed(node, p, now)
        nxt = node.index + 1
        if nxt >= len(self.c.nodes):
            self._emit(p, now)
        else:
            self._place(nxt, p, now)

    def _emit_from(self, node: StateNode, p: StateEvent, now: int) -> None:
        """Emit a completed match from a final count node (partial keeps going)."""
        self._do_reseed(node, p, now)
        self._emit(p.copy(), now)

    def _build_seed(self, node: StateNode, p: StateEvent) -> StateEvent:
        """Clone ``p`` minus the `every` scope's own bindings, recomputing
        timestamps from the surviving (pre-scope) bindings."""
        seed = p.copy()
        for alias in node.reseed_aliases:
            seed.events.pop(alias, None)
        seed.meta.clear()
        ts_list = []
        for v in seed.events.values():
            if isinstance(v, list):
                ts_list.extend(e.timestamp for e in v)
            elif v is not None:
                ts_list.append(v.timestamp)
        seed.first_timestamp = min(ts_list) if ts_list else None
        seed.timestamp = max(ts_list) if ts_list else None
        return seed

    def _do_reseed(self, node: StateNode, p: StateEvent, now: int) -> None:
        if node.reseed_to is None:
            return
        self._place(node.reseed_to, self._build_seed(node, p), now)

    def _emit(self, p: StateEvent, now: int) -> None:
        self._remove_everywhere(p)
        if self.next is not None:
            self.next.process([PatternEvent(now, p)])

    def _remove_everywhere(self, p: StateEvent) -> None:
        for lst in self.pending:
            if p in lst:
                lst.remove(p)

    def _absent_timer(self, node_idx: int, p: StateEvent, ts: int) -> None:
        node = self.c.nodes[node_idx]
        if p not in self.pending[node_idx]:
            return                       # already killed or advanced
        arrival = p.meta.get(f"absent_arrival_{node.index}")
        if arrival is None:
            return
        if node.kind == "absent":
            if ts < arrival + node.waiting_time_ms:
                return                   # stale timer: the wait was restarted
            # non-occurrence established → advance
            self.pending[node_idx].remove(p)
            adv = p.copy()
            adv.meta.pop(f"absent_arrival_{node.index}", None)
            self._advance(node, adv, ts)
        elif node.kind == "logical":
            if ts < arrival + node.waiting_time_ms:
                return                   # stale timer (wait was restarted)
            if p.meta.get(f"logical_absent_dead_{node_idx}"):
                return                   # forbidden event spoiled the wait
            sides = p.meta.get(f"logical_{node_idx}", set())
            required = [b.alias for b in node.branches if not b.is_absent]
            if node.logical_type == LogicalType.OR \
                    or all(a in sides for a in required):
                # OR: established non-occurrence completes the state with
                # the present side unbound (null). AND: complete iff the
                # present side already matched.
                self.pending[node_idx].remove(p)
                adv = p.copy()
                adv.meta.pop(f"logical_{node_idx}", None)
                adv.meta.pop(f"logical_established_{node_idx}", None)
                self._advance(node, adv, ts)
            else:
                # AND, X not yet bound: remember the establishment so a
                # later X advances immediately
                p.meta[f"logical_established_{node_idx}"] = ts

    # -- sequence strictness --------------------------------------------------
    def _enforce_strict(self, stream_id: str, event: StreamEvent,
                        touched: set[int], created: set[int]) -> None:
        seen: set[int] = set()
        for i, lst in enumerate(self.pending):
            node = self.c.nodes[i]
            for p in list(lst):
                pid = id(p)
                if pid in seen:
                    continue            # shared count/eligible partial:
                seen.add(pid)           # judge it once, at its lowest node
                if pid in touched or pid in created:
                    continue
                if not p.events:
                    # start seed: with `every`, seeds persist (retry at every
                    # position); without, the failed first attempt dies
                    has_every = any(n.reseed_to == 0 for n in self.c.nodes)
                    if has_every:
                        continue
                self._remove_everywhere(p)
                # strict continuity killed an `every` instance mid-scope: the
                # scope restarts and the fresh attempt may consume THIS very
                # event (reference SequenceTestCase.testQuery6 — the killing
                # event seeds the next instance)
                reseeded = self._reseed_on_expiry(i, p, event.timestamp)
                if reseeded is not None:
                    seed, start = reseeded
                    if seed in self.pending[start]:
                        snode = self.c.nodes[start]
                        listens = [b for b in snode.branches
                                   if b.stream_id == stream_id]
                        if listens:
                            self._try_match(start, snode, listens, seed,
                                            event, touched, created)

    # -- snapshot -------------------------------------------------------------
    def snapshot_state(self) -> dict:
        def enc_ev(e: StreamEvent):
            return (e.timestamp, list(e.data))

        def enc_state(p: StateEvent):
            return {
                "events": {
                    k: ([enc_ev(x) for x in v] if isinstance(v, list) else enc_ev(v))
                    for k, v in p.events.items()
                },
                "first": p.first_timestamp,
                "ts": p.timestamp,
                "meta": {k: (list(v) if isinstance(v, set) else v)
                         for k, v in p.meta.items()},
            }

        return {
            "pending": [[enc_state(p) for p in lst] for lst in self.pending],
            "started": self.started,
        }

    def restore_state(self, state: dict) -> None:
        def dec_ev(t):
            return StreamEvent(t[0], t[1])

        def dec_state(d) -> StateEvent:
            p = StateEvent()
            p.events = {
                k: ([dec_ev(x) for x in v] if v and isinstance(v[0], (list, tuple)) and
                    self.c.alias_is_list.get(k) else
                    ([dec_ev(x) for x in v] if self.c.alias_is_list.get(k) else dec_ev(v)))
                for k, v in d["events"].items()
            }
            p.first_timestamp = d["first"]
            p.timestamp = d["ts"]
            p.meta = {k: (set(v) if isinstance(v, list) and k.startswith("logical") else v)
                      for k, v in d["meta"].items()}
            return p

        self.pending = [[dec_state(p) for p in lst] for lst in state["pending"]]
        self.started = state["started"]
        # re-arm absent-state non-occurrence timers (fresh scheduler)
        for node_idx, lst in enumerate(self.pending):
            node = self.c.nodes[node_idx]
            if node.waiting_time_ms is None:
                continue
            for partial in lst:
                arrival = partial.meta.get(f"absent_arrival_{node.index}")
                if arrival is not None:
                    self.app_context.scheduler.notify_at(
                        arrival + node.waiting_time_ms,
                        lambda ts, ni=node_idx, pp=partial: self._absent_timer(
                            ni, pp, ts))


class PatternStreamReceiver:
    """Junction subscriber forwarding one stream's events into the runtime."""

    def __init__(self, runtime: PatternRuntime, stream_id: str):
        self.runtime = runtime
        self.stream_id = stream_id

    def receive(self, event: StreamEvent) -> None:
        self.runtime.receive(event, self.stream_id)
