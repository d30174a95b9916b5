"""Columnar host execution engine: the compile plans, run as torch on the CPU.

The port of the JAX package's ``tpu/host_exec.py``: the middle execution
tier (device ≻ **columnar host** ≻ scalar interpreter). It executes the
SAME lowered plans the device compilers produce (``CompiledStreamQuery``
specs/filters, ``DeviceNFACompiler`` blocked-NFA states/predicates — both
compiled with ``host=True``) over SoA micro-batches, eagerly, with
*dynamic* shapes:

- no padding, no static slot capacities: tables hold exactly the live
  partials, grids are ``[events, live_candidates]``;
- no capacity drops: unlike the device kernels (bounded tables, drop
  counters), the host engine matches the scalar interpreter **exactly** —
  it is the engine behind DeviceGuard's quarantine/shadow-replay fallback,
  where parity with the interpreter is the contract;
- the full-width host policy (``dtypes.TORCH_HOST``: int64, float64) —
  interpreter-exact, no f32 tolerance band.

Where the reference runs numpy, this engine runs torch tensors on the CPU,
whether or not a card is present: the compiled closures are torch closures,
and the tier is host code by design (it never moves onto the card). Numpy
stays where the reference's staging hands in numpy columns
(:class:`HostRowStager`, :func:`decode_columns`); the executors take those
columns zero-copy (``torch.from_numpy``) and their snapshots are numpy, as
the reference's are. Sorts are stable where the reference's are, and
integer division by zero gives numpy's 0 (``expr_compile.host_java_div``).

Null policy (shared with the device path): columns encode ``None`` as
0/code-0. Queries relying on SQL-ish null comparison semantics keep the
scalar interpreter.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..query_api.definition import DataType
from .backend import avalanche, reduce_identity
from .dtypes import NP_HOST, TORCH_HOST
from .expr_compile import DeviceCompileError, as_tensor
from .state_io import host_tree_from_numpy, host_tree_to_numpy

_TS_NEG = -(2 ** 62)
_I64 = torch.int64
_F64 = torch.float64


# ---------------------------------------------------------------------------
# shared small kernels (torch ports of the query_compile helpers)
# ---------------------------------------------------------------------------

_one_lock = threading.Lock()
_one_depth = 0
_one_saved = 1


@contextlib.contextmanager
def one_intraop_thread():
    """Runs the body with one intra-op thread, as numpy runs the
    reference's host tier: a window's ops are a few tens of thousands of
    elements, where a pool of threads costs more than it saves, and under
    other busy processes far more (a fleet's storm stepped 40× slower on 8
    threads beside five busy cores). Process-wide while any body runs
    (``torch.set_num_threads``); nested and concurrent bodies share one
    count, and the last to leave restores the setting."""
    global _one_depth, _one_saved
    with _one_lock:
        if _one_depth == 0:
            _one_saved = torch.get_num_threads()
            if _one_saved != 1:
                torch.set_num_threads(1)
        _one_depth += 1
    try:
        yield
    finally:
        with _one_lock:
            _one_depth -= 1
            if _one_depth == 0 and _one_saved != 1:
                torch.set_num_threads(_one_saved)


_gc_lock = threading.Lock()
_gc_depth = 0
_gc_was_on = False


@contextlib.contextmanager
def collector_deferred():
    """Runs the body with Python's cyclic collector off, and turns it back
    on (if it was on) when the last concurrent body leaves: a collection
    the body's allocations would set off runs after it instead."""
    global _gc_depth, _gc_was_on
    with _gc_lock:
        if _gc_depth == 0:
            _gc_was_on = gc.isenabled()
            gc.disable()
        _gc_depth += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_depth -= 1
            if _gc_depth == 0 and _gc_was_on:
                gc.enable()


def _t(x) -> torch.Tensor:
    """A staged numpy column (or a tensor) as a CPU tensor, zero-copy."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _full(x, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``np.broadcast_to(np.asarray(x), (n,)).astype(dtype)``: a closure's
    result (a tensor or a Python constant) as ``n`` values of ``dtype``."""
    x = as_tensor(x, {})
    return torch.broadcast_to(x, (n,)).to(dtype).contiguous()


def _ident(dtype: torch.dtype, is_min: bool) -> torch.Tensor:
    return torch.tensor(reduce_identity(dtype, is_min), dtype=dtype)


def _range_reduce(z: torch.Tensor, lo: torch.Tensor, j: torch.Tensor,
                  is_min: bool) -> torch.Tensor:
    """min/max of ``z`` over inclusive ranges [lo_b, j_b] — the same
    log-doubling sparse table as ``query_compile._range_reduce``, eager."""
    M = z.shape[0]
    if M == 0 or j.numel() == 0:
        return torch.empty((j.numel(),), dtype=z.dtype)
    red = torch.minimum if is_min else torch.maximum
    ident = reduce_identity(z.dtype, is_min)
    tables = [z]
    span = 1
    while span < M:
        prev = tables[-1]
        shifted = torch.cat(
            [torch.full((min(span, M),), ident, dtype=z.dtype),
             prev[:M - span]])
        tables.append(red(prev, shifted))
        span *= 2
    T = torch.stack(tables)                            # [KK, M]
    m = torch.clamp(j - lo + 1, min=1).to(_I64)
    kk = (torch.frexp(m.to(_F64))[1] - 1).to(_I64)     # floor(log2 m), exact
    p2 = torch.ones_like(kk) << kk
    return red(T[kk, j], T[kk, torch.clamp(lo + p2 - 1, 0, M - 1)])


def _segment_starts(sorted_gid: torch.Tensor) -> torch.Tensor:
    if sorted_gid.numel() == 0:
        return torch.zeros((0,), dtype=torch.bool)
    return torch.cat([torch.ones(1, dtype=torch.bool),
                      sorted_gid[1:] != sorted_gid[:-1]])


def _accumulate(v: torch.Tensor, is_min: bool) -> torch.Tensor:
    """``np.minimum.accumulate`` / ``np.maximum.accumulate`` (NaN
    propagates, as there)."""
    if v.numel() == 0:
        return v
    return (torch.cummin if is_min else torch.cummax)(v, 0).values


# ---------------------------------------------------------------------------
# row staging: host rows → SoA micro-batch (dynamic length, host dtypes)
# ---------------------------------------------------------------------------

class HostRowStager:
    """Accumulates raw rows; emits a dynamic-length SoA batch in host dtypes.

    The host analog of ``MergedBatchBuilder``: same dictionary encoding (per
    distinct value via ``StringDictionary.encode_array``), no padding, no ts
    delta compression (absolute int64 — there is no wire to save). Handles
    both the single-stream and merged multi-stream (tagged) layouts.
    """

    def __init__(self, schema, stream_defs: dict, capacity: int,
                 used_cols: Optional[set] = None):
        # schema: MergedBatchSchema (has .stream_index/.columns/.col_key) or
        # BatchSchema (single stream, bare attribute keys)
        self.schema = schema
        self.stream_defs = stream_defs
        self.capacity = capacity
        self.used_cols = used_cols
        self.merged = hasattr(schema, "stream_index")
        self._rows: list = []          # (stream_idx, row)
        self._ts: list = []
        # zero-object staging: whole column chunks (si, cols, ts, n) — the
        # stager holds EITHER row entries OR column chunks, never both
        # (mixing materializes in arrival order, see append_columns /
        # ensure_rows), so guards that walk _rows stay correct
        self._col_chunks: list = []
        self._cn = 0
        if self.merged:
            self._sids = list(schema.stream_index)

    def __len__(self) -> int:
        return len(self._ts) + self._cn

    @property
    def full(self) -> bool:
        return len(self) >= self.capacity

    def append(self, stream_id: str, row: list, ts: int) -> None:
        if self._col_chunks:
            self.ensure_rows()
        si = self.schema.stream_index[stream_id] if self.merged else 0
        self._rows.append((si, row))
        self._ts.append(ts)

    def append_events(self, stream_id: str, events: list) -> None:
        """Bulk-append StreamEvents (chunked junction delivery)."""
        if self._col_chunks:
            self.ensure_rows()
        si = self.schema.stream_index[stream_id] if self.merged else 0
        self._rows.extend((si, ev.data) for ev in events)
        self._ts.extend(ev.timestamp for ev in events)

    def append_rows(self, stream_id: str, rows: list, timestamps) -> None:
        """Bulk-append raw rows (zero-wrap ``deliver_rows`` path)."""
        if self._col_chunks:
            self.ensure_rows()
        si = self.schema.stream_index[stream_id] if self.merged else 0
        self._rows.extend((si, r) for r in rows)
        self._ts.extend(timestamps)

    def append_columns(self, stream_id: str, cols: dict, ts) -> None:
        """Zero-object staging: one columnar chunk ({attr: numpy array |
        DictColumn}, int64 ts) goes in whole — no per-row Python objects.
        A chunk arriving while per-row entries are staged materializes
        immediately so arrival order is preserved."""
        ts = np.asarray(ts, dtype=np.int64)
        n = int(ts.shape[0])
        if n == 0:
            return
        si = self.schema.stream_index[stream_id] if self.merged else 0
        if self._rows:
            from ..core.columns import columns_to_rows
            d = self.stream_defs[stream_id] if self.merged \
                else self.schema.definition
            self._rows.extend(
                (si, r) for r in columns_to_rows(
                    cols, d.attribute_names, n))
            self._ts.extend(ts.tolist())
            return
        self._col_chunks.append((si, cols, ts, n))
        self._cn += n

    def ensure_rows(self) -> None:
        """Materialize pending column chunks into per-row entries (guards /
        snapshots / mixed staging need the row view; NOT the hot path)."""
        if not self._col_chunks:
            return
        from ..core.columns import columns_to_rows
        chunks, self._col_chunks = self._col_chunks, []
        self._cn = 0
        sids = self._sids if self.merged else [self.schema.definition.id]
        pre_rows: list = []
        pre_ts: list = []
        for si, cols, ts, n in chunks:
            d = self.stream_defs[sids[si]] if self.merged \
                else self.schema.definition
            pre_rows.extend(
                (si, r) for r in columns_to_rows(cols, d.attribute_names, n))
            pre_ts.extend(ts.tolist())
        # chunks only accumulate while no row entries are staged, so they
        # strictly precede whatever _rows currently holds
        self._rows = pre_rows + self._rows
        self._ts = pre_ts + self._ts

    def shadow(self) -> dict:
        """Cheap pre-emit capture for guards (pointer copies only); feed to
        :meth:`shadow_rows` to materialize on the failure path."""
        if self._col_chunks:
            return {"chunks": list(self._col_chunks)}
        return {"rows": list(self._rows), "ts": list(self._ts)}

    def shadow_rows(self, shadow: dict) -> tuple[list, list]:
        """(rows as (si, row), ts) of a :meth:`shadow` capture."""
        if "chunks" not in shadow:
            return shadow.get("rows", []), shadow.get("ts", [])
        from ..core.columns import columns_to_rows
        sids = self._sids if self.merged else [self.schema.definition.id]
        rows: list = []
        tss: list = []
        for si, cols, ts, n in shadow["chunks"]:
            d = self.stream_defs[sids[si]] if self.merged \
                else self.schema.definition
            rows.extend(
                (si, r) for r in columns_to_rows(cols, d.attribute_names, n))
            tss.extend(ts.tolist())
        return rows, tss

    def clear(self) -> None:
        self._rows = []
        self._ts = []
        self._col_chunks = []
        self._cn = 0

    def _col_key(self, si: int, attr: str) -> str:
        return f"s{si}_{attr}" if self.merged else attr

    def _dictionary(self, si: int, attr: str):
        return self.schema.dictionaries.get(self._col_key(si, attr))

    def _convert_column(self, col, si: int, attr, n: int) -> np.ndarray:
        """One staged chunk column → the engine's host dtype (strings
        dictionary-encode: cached code translation for DictColumns, one
        vectorized encode for value arrays)."""
        from ..core.columns import DictColumn, encode_dict_column
        if attr.type == DataType.STRING:
            dic = self._dictionary(si, attr.name)
            if isinstance(col, DictColumn):
                enc = encode_dict_column(col, dic)
            else:
                arr = col if isinstance(col, np.ndarray) \
                    else np.asarray(col, dtype=object)
                enc = dic.encode_array(arr)
            out = enc.astype(np.int32, copy=False)
        else:
            arr = np.asarray(col)
            if arr.dtype == object:
                dt = NP_HOST[attr.type]
                arr = np.asarray([0 if v is None else v for v in arr],
                                 dtype=dt)
            out = arr.astype(NP_HOST[attr.type], copy=False)
        if out.shape[0] != n:
            raise ValueError(
                f"column '{attr.name}': {out.shape[0]} values in a chunk "
                f"of {n} rows")
        return out

    def _emit_columns(self) -> dict:
        """Columnar fast-path emit: staged chunks concatenate straight into
        the SoA micro-batch — zero per-row Python, and ONE dtype/dictionary
        conversion per column however many (fine-grained) chunks staged.
        Chunks reset only on success (guards re-drive a failed emit)."""
        from ..core.columns import DictColumn
        chunks = self._col_chunks
        n = self._cn
        sids = self._sids if self.merged else [self.schema.definition.id]
        ts = np.empty(n, dtype=np.int64)
        tag = np.zeros(n, dtype=np.int8)
        # pass 1: gather per-key raw pieces (+ offsets) and stamp ts/tag
        pieces: dict[str, list] = {}
        attr_of: dict[str, tuple] = {}
        off = 0
        for si, ccols, cts, cn in chunks:
            ts[off:off + cn] = cts
            if si:
                tag[off:off + cn] = si
            d = self.stream_defs[sids[si]] if self.merged \
                else self.schema.definition
            for a in d.attributes:
                key = self._col_key(si, a.name)
                if self.used_cols is not None and key not in self.used_cols:
                    continue
                col = ccols[a.name]
                cl = len(col) if isinstance(col, DictColumn) \
                    else np.shape(col)[0] if isinstance(col, np.ndarray) \
                    else len(col)
                if cl != cn:
                    raise ValueError(
                        f"column '{a.name}': {cl} values in a chunk of "
                        f"{cn} rows")
                pieces.setdefault(key, []).append((off, cn, col))
                attr_of[key] = (si, a)
            off += cn
        # pass 2: one conversion per key — concat raw pieces first when
        # they share a representation, then encode/astype once
        cols: dict[str, np.ndarray] = {}
        for key, parts in pieces.items():
            si, a = attr_of[key]
            covered = sum(cn for _o, cn, _c in parts)
            raw = [c for _o, _cn, c in parts]
            if covered == n:
                conv = self._convert_pieces(raw, si, a, n)
                if conv is not None:
                    cols[key] = conv
                    continue
            # sparse (multi-stream: this stream absent from some chunks)
            # or mixed representations: piecewise into a zeroed column
            full = None
            for o, cn, c in parts:
                conv = self._convert_column(c, si, a, cn)
                if full is None:
                    full = cols[key] = np.zeros(n, conv.dtype)
                full[o:o + cn] = conv
        # streams absent from every chunk still get zero-filled columns
        # (same contract as the row path: predicates read every used column)
        for si, sid in enumerate(sids):
            d = self.stream_defs[sid] if self.merged \
                else self.schema.definition
            for a in d.attributes:
                key = self._col_key(si, a.name)
                if self.used_cols is not None and key not in self.used_cols:
                    continue
                if key not in cols:
                    cols[key] = np.zeros(n, NP_HOST[a.type])
        out = {"cols": cols, "tag": tag, "ts": ts, "count": n,
               "last_ts": int(ts[-1]) if n else 0}
        self._col_chunks = []
        self._cn = 0
        return out

    def _convert_pieces(self, raw: list, si: int, attr,
                        n: int) -> Optional[np.ndarray]:
        """Contiguous same-representation pieces → ONE converted column;
        None when representations mix (caller converts piecewise)."""
        from ..core.columns import DictColumn
        first = raw[0]
        if isinstance(first, DictColumn):
            if not all(isinstance(c, DictColumn)
                       and c.values is first.values for c in raw):
                return None
            joined = DictColumn(
                first.codes if len(raw) == 1
                else np.concatenate([c.codes for c in raw]),
                first.values, source=first.source)
            return self._convert_column(joined, si, attr, n)
        if not all(isinstance(c, np.ndarray) and not isinstance(
                c, DictColumn) for c in raw):
            return None
        joined = first if len(raw) == 1 else np.concatenate(raw)
        return self._convert_column(joined, si, attr, n)

    def emit(self) -> dict:
        """→ {"cols": {key: np[n] host-dtype}, "tag": int8[n], "ts": int64[n],
        "count": n, "last_ts": int}. Resets the stager."""
        if self._col_chunks:
            return self._emit_columns()
        n = len(self._ts)
        ts = np.asarray(self._ts, dtype=np.int64)
        tag = np.zeros(n, dtype=np.int8)
        cols: dict[str, np.ndarray] = {}
        sids = self._sids if self.merged else [self.schema.definition.id]
        single = len(sids) == 1
        for si, sid in enumerate(sids):
            d = self.stream_defs[sid] if self.merged else self.schema.definition
            if self.merged and not single:
                idx = np.fromiter((i for i, (s, _) in enumerate(self._rows)
                                   if s == si), dtype=np.int64)
                if si:
                    tag[idx] = si
                rows = [self._rows[i][1] for i in idx]
            else:
                idx = None
                rows = [r for _, r in self._rows]
            # NOTE: a stream with zero rows in this batch still gets its
            # zero-filled columns below — predicates read every used column
            # even when the chunk carried only the OTHER stream's events
            for pos, a in enumerate(d.attributes):
                key = self._col_key(si, a.name)
                if self.used_cols is not None and key not in self.used_cols:
                    continue
                vals = [r[pos] for r in rows]
                if a.type == DataType.STRING:
                    dic = self._dictionary(si, a.name)
                    enc = dic.encode_array(np.asarray(vals, dtype=object)) \
                        if vals else np.zeros(0, np.int32)
                    col_vals = enc.astype(np.int32)
                else:
                    dt = NP_HOST[a.type]
                    col_vals = np.asarray(
                        [0 if v is None else v for v in vals], dtype=dt)
                if idx is None:
                    cols[key] = col_vals
                else:
                    full = cols.get(key)
                    if full is None:
                        full = cols[key] = np.zeros(n, col_vals.dtype)
                    full[idx] = col_vals
        out = {"cols": cols, "tag": tag, "ts": ts, "count": n,
               "last_ts": int(ts[-1]) if n else 0}
        self._rows = []
        self._ts = []
        return out

    def snapshot(self) -> dict:
        self.ensure_rows()      # snapshots carry the row view
        return {"rows": [(s, list(r)) for s, r in self._rows],
                "ts": list(self._ts)}

    def restore(self, snap: dict) -> None:
        self._rows = [(s, list(r)) for s, r in snap["rows"]]
        self._ts = list(snap["ts"])
        self._col_chunks = []
        self._cn = 0


# ---------------------------------------------------------------------------
# vectorized output decode (codes → strings, tensors → Python scalars)
# ---------------------------------------------------------------------------

def decode_columns(out_specs, cols: dict, dictionaries: dict) -> list[list]:
    """{name: column[n]} (numpy arrays or CPU tensors) → host rows, with
    dictionary-encoded strings decoded. ``tolist()`` converts whole columns
    at once, replacing a per-row/per-value decode loop on this path."""
    py_cols = []
    for (name, _fn, t) in out_specs:
        v = cols[name]
        if t == DataType.STRING:
            table = None
            for dic in dictionaries.values():
                table = dic
                break
            if table is not None:
                vals = np.asarray(table._values, dtype=object)
                codes = np.clip(np.asarray(v, np.int64), 0, len(vals) - 1)
                py_cols.append(vals[codes].tolist())
            else:                                      # pragma: no cover
                py_cols.append(np.asarray(v).tolist())
        else:
            py_cols.append(np.asarray(v).tolist())
    return [list(r) for r in zip(*py_cols)]


# ---------------------------------------------------------------------------
# blocked NFA, eager execution (dynamic shapes, no capacity drops)
# ---------------------------------------------------------------------------

class HostBlockNFA:
    """Eager executor for the blocked NFA plan (``nfa_block.py`` stage
    semantics) with dynamic tables. Stateless w.r.t. lanes: the caller holds
    one ``state`` per lane and passes it through ``step``."""

    def __init__(self, nfa):
        if not getattr(nfa, "host", False):
            raise DeviceCompileError("HostBlockNFA needs a host-form plan")
        if not nfa.blocked:
            raise DeviceCompileError(
                "count/logical/absent states have no columnar host kernel")
        self.nfa = nfa
        self.S = nfa.S
        self.states = nfa.states
        self.within = nfa.within
        self.is_seq = nfa.is_sequence
        self.referenced = sorted(nfa.referenced)
        self.out_specs = nfa.out_specs
        self.has_ew = any(st.within_ms is not None for st in nfa.states)
        self.single_stream = len(nfa.merged.stream_ids) == 1
        self._key_dtype = {}
        for (q, key, t) in self.referenced:
            self._key_dtype[key] = TORCH_HOST[t]
        # merged column each binding key reads from, resolved once
        from .nfa import _NFAResolver
        res = _NFAResolver(nfa, None)
        self._bind_src = {key: res._bound_to_merged(key)
                          for (q, key, t) in self.referenced}
        # bindings carried by a partial AT state s live in TWO dtype-grouped
        # 2-D slabs ([rows, m] float64 + int64) instead of per-key arrays —
        # concat/compress/gather are O(1) calls per stage rather than
        # O(#bindings) (the per-batch call count is what bounds this path,
        # not element throughput). Precomputed per stage:
        #   _stage_rows[s]: key → ('f'|'i', row)
        #   _stage_carry[s]: rows of stage s-1's slabs carried into stage s
        #   _stage_mint[s]:  (group, row, src column) minted at state s-1
        self._stage_rows: list = [None] * self.S
        self._stage_carry: list = [None] * self.S
        self._stage_mint: list = [None] * self.S
        for s in range(1, self.S):
            keys = [key for (q, key, t) in self.referenced if q < s]
            rows = {}
            nf = ni = 0
            for key in keys:
                if self._key_dtype[key].is_floating_point:
                    rows[key] = ("f", nf)
                    nf += 1
                else:
                    rows[key] = ("i", ni)
                    ni += 1
            self._stage_rows[s] = (rows, nf, ni)
            if s > 1:
                prev = self._stage_rows[s - 1][0]
                carry_f = [None] * nf
                carry_i = [None] * ni
                mint = []
                for key, (grp, row) in rows.items():
                    if key in prev:
                        pg, pr = prev[key]
                        (carry_f if grp == "f" else carry_i)[row] = pr
                    else:
                        mint.append((grp, row, self._bind_src[key]))
                self._stage_carry[s] = (carry_f, carry_i)
                self._stage_mint[s] = mint
        # seed bindings (q == 0) for stage 1, and final-state mints for emit
        self._seed_keys = [(key, self._bind_src[key])
                           for (q, key, t) in self.referenced if q == 0]
        self._final_mint = [(key, self._bind_src[key])
                            for (q, key, t) in self.referenced
                            if q == self.S - 1]

    # -- state -----------------------------------------------------------
    def init_state(self) -> dict:
        tables = {}
        for s in range(1, self.S):
            _rows, nf, ni = self._stage_rows[s]
            fields = {"first_ts": torch.zeros(0, dtype=_I64),
                      "bf": torch.zeros((nf, 0), dtype=_F64),
                      "bi": torch.zeros((ni, 0), dtype=_I64)}
            if self.has_ew:
                fields["last_ts"] = torch.zeros(0, dtype=_I64)
            tables[f"t{s}"] = fields
        return {"tables": tables, "matches": 0}

    def _slab_env(self, s: int, bf, bi) -> dict:
        """Binding env views over the dtype slabs for stage ``s``'s
        predicate ({key: [1, m] row view})."""
        rows, _nf, _ni = self._stage_rows[s]
        return {key: (bf if grp == "f" else bi)[row][None, :]
                for key, (grp, row) in rows.items()}

    def _seed_slabs(self, cols: dict, idx) -> tuple:
        """Stage-1 binding slabs for seeds created at state 0."""
        _rows, nf, ni = self._stage_rows[1] if self.S > 1 else ({}, 0, 0)
        bf = torch.empty((nf, idx.numel()), dtype=_F64)
        bi = torch.empty((ni, idx.numel()), dtype=_I64)
        rows = self._stage_rows[1][0] if self.S > 1 else {}
        for key, src in self._seed_keys:
            grp, row = rows[key]
            (bf if grp == "f" else bi)[row] = cols[src][idx]
        return bf, bi

    def _empty_creations(self, s: int) -> dict:
        _rows, nf, ni = self._stage_rows[s]
        cre = {"born": torch.zeros(0, dtype=_I64),
               "vb": torch.zeros(0, dtype=_I64),
               "first_ts": torch.zeros(0, dtype=_I64),
               "bf": torch.zeros((nf, 0), dtype=_F64),
               "bi": torch.zeros((ni, 0), dtype=_I64)}
        if self.has_ew:
            cre["last_ts"] = torch.zeros(0, dtype=_I64)
        return cre

    # -- step ------------------------------------------------------------
    def step(self, state: dict, cols: dict, tag, ts) -> tuple[dict, dict]:
        """One micro-batch through all S stages. Returns (state, matches)
        where matches = {"j": [M] event index, "ts": [M], <out>: [M]}."""
        cols = {k: _t(v) for k, v in cols.items()}
        return self._step(state, cols, None if tag is None else _t(tag),
                          _t(ts))

    def _step(self, state: dict, cols: dict, tag, ts) -> tuple[dict, dict]:
        n = ts.shape[0]
        # per-tenant override (shared plans): `within N` is a runtime
        # parameter of the shape, carried in the state dict
        within = state.get("within", self.within)
        tables = state["tables"]
        ev_env = {f"ev_{k}": v for k, v in cols.items()}
        jidx = torch.arange(n, dtype=_I64)
        vidx = jidx + 1
        ts_last = int(ts[-1]) if n else _TS_NEG

        def gate_idx(st):
            if self.single_stream:
                return jidx
            return torch.nonzero(tag == st.stream_idx).flatten()

        # ---- seeds -----------------------------------------------------
        st0 = self.states[0]
        g0 = gate_idx(st0)
        if st0.predicate is not None:
            env0 = {k: v[g0] for k, v in ev_env.items()}
            p0 = _full(st0.predicate(env0), g0.numel(), torch.bool)
            seed = g0[p0]
        else:
            seed = g0

        empty = {"j": torch.zeros(0, dtype=_I64),
                 "ts": torch.zeros(0, dtype=_I64)}
        for (name, _fn, t) in self.out_specs:
            empty[name] = torch.zeros(0, dtype=TORCH_HOST[t])

        if self.S == 1:
            # single-state every-pattern: each matching event IS a match
            if seed.numel() == 0:
                return state, empty
            emit_env = {k: v[seed] for k, v in ev_env.items()}
            emit_env.update({key: cols[src][seed]
                             for key, src in self._seed_keys})
            out = {"j": seed, "ts": ts[seed]}
            for (name, fn, t) in self.out_specs:
                out[name] = _full(fn(emit_env), seed.numel(), TORCH_HOST[t])
            return {**state, "tables": tables,
                    "matches": state["matches"] + int(seed.numel())}, out

        seed_bf, seed_bi = self._seed_slabs(cols, seed)
        cre = {
            "born": seed,
            "vb": vidx[seed],
            "first_ts": ts[seed],
            "bf": seed_bf, "bi": seed_bi,
        }
        if self.has_ew:
            cre["last_ts"] = ts[seed]

        matches = state["matches"]
        out = empty
        new_tables = {}
        for s in range(1, self.S):
            st = self.states[s]
            tbl = tables[f"t{s}"]
            n_old = tbl["first_ts"].shape[0]
            n_new = cre["born"].shape[0]
            m = n_old + n_new
            if m == 0:
                # no candidates at this state: nothing advances, the empty
                # table carries, and downstream stages only see creations
                new_tables[f"t{s}"] = tbl
                if s < self.S - 1:
                    cre = self._empty_creations(s + 1)
                continue
            if n_old:
                cand_born = torch.cat(
                    [torch.full((n_old,), -1, dtype=_I64), cre["born"]])
                cand_first = torch.cat([tbl["first_ts"], cre["first_ts"]])
                cand_bf = torch.cat([tbl["bf"], cre["bf"]], dim=1)
                cand_bi = torch.cat([tbl["bi"], cre["bi"]], dim=1)
                cand_vb = torch.cat(
                    [torch.zeros(n_old, dtype=_I64), cre["vb"]]) \
                    if self.is_seq else None
                cand_last = torch.cat(
                    [tbl["last_ts"], cre["last_ts"]]) if self.has_ew \
                    else None
            else:
                cand_born = cre["born"]
                cand_first = cre["first_ts"]
                cand_bf, cand_bi = cre["bf"], cre["bi"]
                cand_vb = cre["vb"] if self.is_seq else None
                cand_last = cre.get("last_ts") if self.has_ew else None

            gi = gate_idx(st)                      # global event indices
            g = gi.numel()
            whole = gi is jidx                     # single-stream fast path
            ts_g = ts if whole else ts[gi]
            if g == 0:
                grid = torch.zeros((0, m), dtype=torch.bool)
            else:
                if st.predicate is not None:
                    env = {k: v[:, None] for k, v in ev_env.items()} \
                        if whole \
                        else {k: v[gi][:, None] for k, v in ev_env.items()}
                    env.update(self._slab_env(s, cand_bf, cand_bi))
                    grid = torch.broadcast_to(
                        as_tensor(st.predicate(env), {}), (g, m))
                else:
                    grid = torch.ones((g, m), dtype=torch.bool)
                if within is not None:
                    grid = grid & ((ts_g[:, None] - cand_first[None, :])
                                   <= within)
                if st.within_ms is not None:
                    grid = grid & ((ts_g[:, None] - cand_last[None, :])
                                   <= st.within_ms)
                if self.is_seq:
                    vidx_g = vidx if whole else vidx[gi]
                    grid = grid & (vidx_g[:, None]
                                   == cand_vb[None, :] + 1)
                else:
                    jidx_g = jidx if whole else jidx[gi]
                    grid = grid & (jidx_g[:, None] > cand_born[None, :])

            adv = grid.any(dim=0)                  # [m]
            adv_idx = torch.nonzero(adv).flatten()
            # first advancing event per candidate (argmax: the first max)
            jstar = gi[grid[:, adv_idx].to(torch.uint8).argmax(dim=0)] \
                if adv_idx.numel() else torch.zeros(0, dtype=_I64)

            if s == self.S - 1:
                if adv_idx.numel():
                    emit_env = {k: v[jstar] for k, v in ev_env.items()}
                    rows, _nf, _ni = self._stage_rows[s]
                    for key, (grp, row) in rows.items():
                        emit_env[key] = (cand_bf if grp == "f"
                                         else cand_bi)[row][adv_idx]
                    for key, src in self._final_mint:
                        emit_env[key] = cols[src][jstar]
                    out = {"j": jstar, "ts": ts[jstar]}
                    for (name, fn, t) in self.out_specs:
                        out[name] = _full(fn(emit_env), adv_idx.numel(),
                                          TORCH_HOST[t])
                    matches += int(adv_idx.numel())
            else:
                carry_f, carry_i = self._stage_carry[s + 1]
                _rows, nf, ni = self._stage_rows[s + 1]
                nbf = torch.empty((nf, adv_idx.numel()), dtype=_F64)
                nbi = torch.empty((ni, adv_idx.numel()), dtype=_I64)
                for row, pr in enumerate(carry_f):
                    if pr is not None:
                        nbf[row] = cand_bf[pr][adv_idx]
                for row, pr in enumerate(carry_i):
                    if pr is not None:
                        nbi[row] = cand_bi[pr][adv_idx]
                for grp, row, src in self._stage_mint[s + 1]:
                    (nbf if grp == "f" else nbi)[row] = cols[src][jstar]
                cre = {
                    "born": jstar,
                    "vb": vidx[jstar],
                    "first_ts": cand_first[adv_idx],
                    "bf": nbf, "bi": nbi,
                }
                if self.has_ew:
                    cre["last_ts"] = ts[jstar]

            # survivors (no capacity truncation on the host)
            surv = ~adv
            if within is not None and n:
                surv &= (ts_last - cand_first) <= within
            if st.within_ms is not None and n:
                surv &= (ts_last - cand_last) <= st.within_ms
            if self.is_seq:
                n_valid = int(vidx[-1]) if n else 0
                surv &= cand_vb == n_valid
            sidx = torch.nonzero(surv).flatten()
            ntbl = {"first_ts": cand_first[sidx],
                    "bf": cand_bf[:, sidx], "bi": cand_bi[:, sidx]}
            if self.has_ew:
                ntbl["last_ts"] = cand_last[sidx]
            new_tables[f"t{s}"] = ntbl

        return {**state, "tables": new_tables, "matches": matches}, out

    # -- snapshots -------------------------------------------------------
    def snapshot_state(self, state: dict) -> dict:
        """The reference's snapshot: numpy leaves, the match count and the
        dictionaries."""
        return {"tables": host_tree_to_numpy(state["tables"]),
                "matches": state["matches"],
                "dict": self.nfa.merged.snapshot_dictionaries()}

    def restore_state(self, snap: dict) -> dict:
        self.nfa.merged.restore_dictionaries(snap.get("dict", {}))
        return {"tables": host_tree_from_numpy(snap["tables"]),
                "matches": snap["matches"]}


class HostPartitionedNFA:
    """Lane-partitioned blocked NFA on the host tier.

    The host analog of ``gpu/partition.py``'s ``PartitionedNFARuntime``:
    per-KEY pattern semantics via the same ``_inject_key_equality`` rewrite,
    keys spread over P lanes (block-diagonal grids — an event only meets
    partials of keys sharing its lane), one dynamic-table state per lane.

    ``workers > 1`` shards the LANE SPACE across a persistent thread pool
    (``@app:host_batch(workers=N)``): each worker steps a contiguous lane
    shard against the shared read-only sorted batch view, per-lane states
    stay exclusively owned, and the emit merges shard outputs in lane order
    before the stable by-event sort — byte-identical to the sequential
    loop, so interpreter parity is preserved per lane. Torch releases the
    GIL inside its operators, which is where the step time goes.
    """

    def __init__(self, query, stream_defs: dict, key_attr: str,
                 num_partitions: int = 32, query_index: int = 0,
                 compiler=None, engine=None, workers: int = 1,
                 workers_mode: str = "thread", source=None):
        # a prebuilt (compiler, engine) pair shares ONE compiled plan across
        # runtimes — the caller already injected the key-equality rewrite;
        # otherwise compile from the query AST
        if compiler is None:
            from .nfa import DeviceNFACompiler
            from .partition import _inject_key_equality
            query = _inject_key_equality(query, key_attr)
            compiler = DeviceNFACompiler(query, dict(stream_defs), host=True)
        self.compiler = compiler
        if len(self.compiler.merged.stream_ids) != 1:
            raise DeviceCompileError(
                "partitioned columnar host path covers single-stream "
                "patterns")
        self.engine = engine if engine is not None \
            else HostBlockNFA(self.compiler)
        self.P = max(1, int(num_partitions))
        self.key_attr = key_attr
        sid = self.compiler.merged.stream_ids[0]
        self.key_col = self.compiler.merged.col_key(sid, key_attr)
        d = stream_defs[sid]
        self.key_is_string = d.attribute_type(key_attr) == DataType.STRING
        self.lane_states = [self.engine.init_state() for _ in range(self.P)]
        self.workers = max(1, int(workers))
        self.workers_mode = workers_mode
        # child-rebuild identity for mode='process' (app source + the
        # partition/query position; host_bridge supplies it)
        self._source = source
        self._pool = None
        self._proc_pool = None          # ProcessLanePool, spawned lazily
        # process-backed lane shards (procmesh lanepool): children spawn
        # on the FIRST batch — a deployed-but-idle app must not pay worker
        # boot. Shard count stays `workers` and the merge order is the
        # thread path's, so outputs stay byte-identical.
        self._proc_armed = (self.workers > 1 and workers_mode == "process"
                            and source is not None)
        if self.workers > 1 and not self._proc_armed:
            import os
            from concurrent.futures import ThreadPoolExecutor
            # pool capped at the machine's cores: threads beyond the core
            # count only contend — shard count stays `workers`, so the
            # OUTPUT is identical whatever the pool size
            self._pool = ThreadPoolExecutor(
                max_workers=min(self.workers, os.cpu_count() or 1),
                thread_name_prefix="host-nfa")

    @property
    def match_count(self) -> int:
        if self._proc_pool is not None:
            return self._proc_pool.match_count()
        return sum(st["matches"] for st in self.lane_states)

    def _lane_pool(self):
        """The process lane pool, spawned on first use — seeded with the
        CURRENT parent lane snapshots so a restore that landed before the
        first batch carries over."""
        if self._proc_pool is None:
            from ..procmesh.lanepool import ProcessLanePool
            self._proc_pool = ProcessLanePool(
                self._source, self.P, self.workers,
                [self.engine.snapshot_state(st) for st in self.lane_states])
        return self._proc_pool

    def close(self) -> None:
        """Shut the worker pool down (bridge finalize / app shutdown):
        pool threads are non-daemon and would otherwise outlive the
        runtime. Late flushes after close() fall back to the sequential
        loop — identical outputs either way (the process pool first syncs
        its lane states back so nothing is lost)."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        ppool, self._proc_pool = self._proc_pool, None
        if ppool is not None:
            try:
                self.lane_states = [self.engine.restore_state(s)
                                    for s in ppool.snapshot_lanes()]
            except Exception:   # noqa: BLE001 — children already gone:
                pass            # parent states stay the last known good
            self._proc_armed = False
            ppool.close()

    def lanes_of(self, key_codes: torch.Tensor) -> torch.Tensor:
        if self.key_is_string:
            # dictionary codes are dense small ints — direct modulo spreads
            return (key_codes.to(_I64) % self.P).to(torch.int32)
        return (avalanche(key_codes.to(_I64)) % self.P).to(torch.int32)

    def _run_lanes(self, lane_lo: int, lane_hi: int, bounds, cols_sorted,
                   ts_sorted, order) -> list:
        """Step one contiguous lane shard (per-shard stager view: slices of
        the shared sorted batch). Lane states are exclusively owned by
        their shard, so this is thread-safe without locks."""
        outs = []
        for lane in range(lane_lo, lane_hi):
            lo, hi = int(bounds[lane]), int(bounds[lane + 1])
            if lo == hi:
                continue
            lcols = {k: v[lo:hi] for k, v in cols_sorted.items()}
            self.lane_states[lane], m = self.engine.step(
                self.lane_states[lane], lcols, None, ts_sorted[lo:hi])
            if m and m["j"].numel():
                # lane-local j → global event position (pre-sort order)
                m = dict(m)
                m["j"] = order[lo + m["j"]]
                outs.append(m)
        return outs

    def process(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """One SoA batch (HostRowStager.emit shape) through every lane.
        Returns (global_j, outs) with outs columns ordered by match event."""
        n = batch["count"]
        if n == 0:
            return torch.zeros(0, dtype=_I64), {}
        cols = {k: _t(v) for k, v in batch["cols"].items()}
        ts = _t(batch["ts"])
        key_codes = cols[self.key_col]
        lanes = self.lanes_of(key_codes)
        order = torch.sort(lanes, stable=True).indices
        lanes_sorted = lanes[order]
        bounds = torch.searchsorted(
            lanes_sorted, torch.arange(self.P + 1, dtype=torch.int32))
        cols_sorted = {k: v[order] for k, v in cols.items()}
        ts_sorted = ts[order]
        if self._proc_armed and self.P >= 2:
            # process-backed shards: ship each child its slice of the
            # lane-sorted batch; children return shard-relative match
            # positions the pool maps through `order` — same merge, same
            # stable sort, byte-identical outputs
            outs = self._lane_pool().step(bounds, cols_sorted, ts_sorted,
                                          order)
        elif self._pool is not None and self.P >= 2:
            # lane-space sharding: W contiguous shards step concurrently;
            # merge keeps lane order so the by-event sort below is
            # byte-identical to the sequential loop
            W = min(self.workers, self.P)
            cuts = [self.P * w // W for w in range(W + 1)]
            futs = [self._pool.submit(self._run_lanes, cuts[w], cuts[w + 1],
                                      bounds, cols_sorted, ts_sorted, order)
                    for w in range(W)]
            outs = [m for f in futs for m in f.result()]
        else:
            outs = self._run_lanes(0, self.P, bounds, cols_sorted,
                                   ts_sorted, order)
        if not outs:
            return torch.zeros(0, dtype=_I64), {}
        j = torch.cat([m["j"] for m in outs])
        osort = torch.sort(j, stable=True).indices
        merged = {k: torch.cat([m[k] for m in outs])[osort]
                  for k in outs[0]}
        return merged["j"], merged

    def decode(self, outs: dict) -> list[list]:
        if not outs:
            return []
        return decode_columns(self.engine.out_specs, outs,
                              self.compiler.merged.dictionaries)

    # -- snapshots -------------------------------------------------------
    def snapshot_state(self) -> dict:
        if self._proc_pool is not None:
            # the shard owners hold the live states
            return {"lanes": self._proc_pool.snapshot_lanes()}
        return {"lanes": [self.engine.snapshot_state(st)
                          for st in self.lane_states]}

    def restore_state(self, snap: dict) -> None:
        self.lane_states = [self.engine.restore_state(s)
                            for s in snap["lanes"]]
        if self._proc_pool is not None:
            self._proc_pool.restore_lanes(snap["lanes"])


# ---------------------------------------------------------------------------
# compiled single-stream queries, eager execution
# ---------------------------------------------------------------------------

_HOST_WINDOWS = (None, "length", "time")


class HostStreamQuery:
    """Eager executor over a ``CompiledStreamQuery`` plan (compiled with
    ``host=True``).

    Coverage (everything else raises ``DeviceCompileError`` → the caller
    keeps that query on the scalar interpreter, per query):
    filters + projections; running sum/count/avg/min/max; group-by (exact
    keys, no hashed buckets → no collision caveat) without a window; sliding
    ``length``/``time``/``externalTime`` windows with sum/count/avg/min/max;
    ``having``. Outputs are CURRENT rows per accepted event, interpreter
    semantics (aggregates reflect the window AFTER the event's arrival and
    expiry at its timestamp)."""

    def __init__(self, compiled):
        if not getattr(compiled, "host", False):
            raise DeviceCompileError("HostStreamQuery needs a host-form plan")
        c = compiled
        self.c = c
        if c.window_kind not in _HOST_WINDOWS:
            raise DeviceCompileError(
                f"window '{c.window_kind}' has no columnar host kernel")
        self.has_agg = bool(c.agg_idx)
        if c.sagg_idx:
            raise DeviceCompileError(
                "stdDev keeps the scalar interpreter on the host fast path")
        if c.group_keys and c.window_kind is not None and self.has_agg:
            raise DeviceCompileError(
                "windowed group-by keeps the scalar interpreter on the "
                "host fast path")
        self.windowed = c.window_kind is not None and self.has_agg
        self.N = c.window_n
        self.W = c.window_ms
        self.time_key = c.time_key
        # aggregate lanes: (spec_idx, fn, acc dtype)
        self.flanes = [(i, c.specs[i].fn) for i in c.fagg_idx]
        self.ilanes = [(i, c.specs[i].fn) for i in c.iagg_idx]
        self.mlanes = [(i, c.specs[i].fn, c.specs[i].kind == "min",
                        TORCH_HOST[c.specs[i].dtype]) for i in c.magg_idx]
        self.out_specs = [(s.name, s.fn, s.dtype) for s in c.specs]

    # -- state -----------------------------------------------------------
    def init_state(self) -> dict:
        st: dict[str, Any] = {}
        if self.windowed:
            st["tail_ts"] = torch.zeros(0, dtype=_I64)
            st["tail_f"] = torch.zeros((len(self.flanes), 0), dtype=_F64)
            st["tail_i"] = torch.zeros((len(self.ilanes), 0), dtype=_I64)
            st["tail_m"] = {i: torch.zeros(0, dtype=dt)
                            for (i, _f, _m, dt) in self.mlanes}
            st["ts_regressions"] = 0
        elif self.c.group_keys:
            st["key_slots"] = {}          # exact key tuple → slot
            st["key_f"] = torch.zeros((len(self.flanes), 0), dtype=_F64)
            st["key_i"] = torch.zeros((len(self.ilanes), 0), dtype=_I64)
            st["key_cnt"] = torch.zeros(0, dtype=_I64)
            st["key_m"] = {i: torch.zeros(0, dtype=dt)
                           for (i, _f, _m, dt) in self.mlanes}
        elif self.has_agg:
            st["run_f"] = torch.zeros(len(self.flanes), dtype=_F64)
            st["run_i"] = torch.zeros(len(self.ilanes), dtype=_I64)
            st["run_cnt"] = 0
            st["run_m"] = {i: _ident(dt, m)
                           for (i, _f, m, dt) in self.mlanes}
        return st

    # -- step ------------------------------------------------------------
    def step(self, state: dict, cols: dict, ts) -> tuple[dict, dict]:
        """→ (state, {"ts": [k], "out": {name: [k]}, "j": [k] row index})
        for accepted events."""
        cols = {k: _t(v) for k, v in cols.items()}
        ts = _t(ts)
        cols["__ts__"] = ts
        n = ts.shape[0]
        mask = torch.ones(n, dtype=torch.bool)
        for fn in self.c.filter_fns:
            mask &= torch.broadcast_to(as_tensor(fn(cols), {}), (n,))
        k = int(mask.sum())
        if k == n:                       # nothing rejected: no compaction
            ccols, cts = cols, ts
            keep = torch.arange(n, dtype=_I64)
        else:
            keep = torch.nonzero(mask).flatten()
            ccols = {kk: v[keep] for kk, v in cols.items()}
            cts = ts[keep]
        out: dict[str, torch.Tensor] = {}
        specs = self.c.specs
        for i in self.c.value_idx:
            dt = TORCH_HOST[specs[i].dtype]
            out[specs[i].name] = _full(specs[i].fn(ccols), k, dt) \
                if k else torch.zeros(0, dtype=dt)
        if self.has_agg:
            # externalTime reads the window clock from a column; the
            # plain time window uses arrival timestamps
            wts = ccols[self.time_key].to(_I64) \
                if self.time_key is not None else cts
            state = self._aggregate(state, ccols, cts, wts, k, out)
        hv = self.c.having_fn
        if hv is not None and k:
            # fleet param slots are visible to the having program too
            # (hoisted constants in `having` clauses): compacted per-row
            # param columns merge under the output columns
            hv_env = out
            pkeys = [kk for kk in ccols if kk.startswith("__fleet_p")]
            if pkeys:
                hv_env = {**{kk: ccols[kk] for kk in pkeys}, **out}
            hmask = _full(hv(hv_env), k, torch.bool)
            out = {nm: v[hmask] for nm, v in out.items()}
            cts = cts[hmask]
            keep = keep[hmask]
        return state, {"ts": cts, "out": out, "j": keep}

    # -- aggregation paths ----------------------------------------------
    def _args(self, lanes, ccols, k, dt):
        if not lanes or k == 0:
            return torch.zeros((len(lanes), k), dtype=dt)
        return torch.stack([_full(fn(ccols), k, dt) for (_i, fn) in lanes])

    def _aggregate(self, state, ccols, cts, wts, k, out) -> dict:
        c = self.c
        av_f = self._args(self.flanes, ccols, k, _F64)
        av_i = self._args(self.ilanes, ccols, k, _I64)
        av_m = {i: (_full(fn(ccols), k, dt) if k
                    else torch.zeros(0, dtype=dt))
                for (i, fn, _m, dt) in self.mlanes}

        if self.windowed:
            return self._window_agg(state, av_f, av_i, av_m, wts, k, out)
        if c.group_keys:
            return self._group_agg(state, av_f, av_i, av_m, ccols, k, out)

        # running, no grouping
        sums_f = torch.cumsum(av_f, dim=1) + state["run_f"][:, None]
        sums_i = torch.cumsum(av_i, dim=1) + state["run_i"][:, None]
        cnts = torch.arange(1, k + 1, dtype=_I64) + state["run_cnt"]
        new = dict(state)
        if k:
            new["run_f"] = sums_f[:, -1].clone()
            new["run_i"] = sums_i[:, -1].clone()
            new["run_cnt"] = int(cnts[-1])
        mins = {}
        new_m = dict(state["run_m"])
        for (i, _fn, is_min, dt) in self.mlanes:
            red = torch.minimum if is_min else torch.maximum
            mins[i] = red(_accumulate(av_m[i], is_min), state["run_m"][i])
            if k:
                new_m[i] = mins[i][-1].clone()
        new["run_m"] = new_m
        self._materialize(out, sums_f, sums_i, cnts, mins, k)
        return new

    def _window_agg(self, state, av_f, av_i, av_m, wts, k, out) -> dict:
        c = self.c
        # per-tenant overrides (shared plans): window sizes are runtime
        # parameters of the shape, carried in the state dict
        N = state.get("window_n", self.N)
        W = state.get("window_ms", self.W)
        z_ts_raw = torch.cat([state["tail_ts"], wts])
        z_ts = _accumulate(z_ts_raw, False)
        regress = int((z_ts != z_ts_raw).sum())
        z_f = torch.cat([state["tail_f"], av_f], dim=1)
        z_i = torch.cat([state["tail_i"], av_i], dim=1)
        z_m = {i: torch.cat([state["tail_m"][i], av_m[i]])
               for i in state["tail_m"]}
        n_tail = state["tail_ts"].shape[0]
        j = n_tail + torch.arange(k, dtype=_I64)
        if c.window_kind == "length":
            lo = torch.clamp(j - N + 1, min=0)
            keep_from = max(z_ts.shape[0] - N, 0)
        else:       # sliding time window: live iff ts > now - W
            lo = torch.searchsorted(z_ts, z_ts[j] - W, right=True) \
                if k else torch.zeros(0, dtype=_I64)
            newest = int(z_ts[-1]) if z_ts.numel() else _TS_NEG
            keep_from = int(torch.searchsorted(
                z_ts, torch.tensor([newest - W], dtype=_I64), right=True))
        cs_f = torch.cat(
            [torch.zeros((z_f.shape[0], 1), dtype=_F64),
             torch.cumsum(z_f, dim=1)], dim=1)
        cs_i = torch.cat(
            [torch.zeros((z_i.shape[0], 1), dtype=_I64),
             torch.cumsum(z_i, dim=1)], dim=1)
        sums_f = cs_f[:, j + 1] - cs_f[:, lo]
        sums_i = cs_i[:, j + 1] - cs_i[:, lo]
        cnts = (j - lo + 1).to(_I64)
        mins = {i: _range_reduce(z_m[i], lo, j, is_min)
                for (i, _fn, is_min, dt) in self.mlanes}
        new = dict(state)
        new["tail_ts"] = z_ts[keep_from:]
        new["tail_f"] = z_f[:, keep_from:]
        new["tail_i"] = z_i[:, keep_from:]
        new["tail_m"] = {i: v[keep_from:] for i, v in z_m.items()}
        new["ts_regressions"] = state["ts_regressions"] + regress
        self._materialize(out, sums_f, sums_i, cnts, mins, k)
        return new

    def _group_agg(self, state, av_f, av_i, av_m, ccols, k, out) -> dict:
        c = self.c
        if k == 0:
            self._materialize(out, av_f, av_i,
                              torch.zeros(0, dtype=_I64), {}, 0)
            return state
        kcols = [ccols[gk].to(_I64) for gk in c.group_keys]
        stackk = torch.stack(kcols, dim=1)             # [k, nk]
        # lexicographically sorted unique rows, as np.unique(axis=0)
        ukeys, gid = torch.unique(stackk, dim=0, return_inverse=True)
        # exact key tuple → carried slot (python loop over UNIQUE keys only)
        slots = state["key_slots"]
        lane_f, lane_i = state["key_f"], state["key_i"]
        lane_cnt, lane_m = state["key_cnt"], dict(state["key_m"])
        slot_of = []
        grow = 0
        for row in ukeys.tolist():
            tup = tuple(row)
            sl = slots.get(tup)
            if sl is None:
                sl = slots[tup] = len(slots)
                grow += 1
            slot_of.append(sl)
        slot_of = torch.tensor(slot_of, dtype=_I64)
        if grow:
            lane_f = torch.cat(
                [lane_f, torch.zeros((lane_f.shape[0], grow), dtype=_F64)],
                dim=1)
            lane_i = torch.cat(
                [lane_i, torch.zeros((lane_i.shape[0], grow), dtype=_I64)],
                dim=1)
            lane_cnt = torch.cat([lane_cnt, torch.zeros(grow, dtype=_I64)])
            for (i, _fn, is_min, dt) in self.mlanes:
                lane_m[i] = torch.cat(
                    [lane_m[i], _ident(dt, is_min).expand(grow)])
        ev_slot = slot_of[gid]                         # [k]
        order = torch.sort(ev_slot, stable=True).indices
        s_sorted = ev_slot[order]
        starts = _segment_starts(s_sorted)
        start_pos = torch.nonzero(starts).flatten()
        seg_len = torch.diff(torch.cat(
            [start_pos, torch.tensor([k], dtype=_I64)]))
        seg_slot = s_sorted[start_pos]

        def seg_cumsum(vals):                          # [A, k] sorted axis
            if vals.shape[0] == 0:
                return vals
            cs = torch.cumsum(vals, dim=1)
            base = cs[:, start_pos] - vals[:, start_pos]
            return cs - torch.repeat_interleave(base, seg_len, dim=1)

        within_f = seg_cumsum(av_f[:, order])
        within_i = seg_cumsum(av_i[:, order])
        ones = torch.ones(k, dtype=_I64)
        within_c = seg_cumsum(ones[None, :])[0]
        sums_f = torch.empty_like(within_f)
        sums_i = torch.empty_like(within_i)
        cnts = torch.empty(k, dtype=_I64)
        sums_f[:, order] = within_f + lane_f[:, s_sorted]
        sums_i[:, order] = within_i + lane_i[:, s_sorted]
        cnts[order] = within_c + lane_cnt[s_sorted]
        mins = {}
        ends = start_pos + seg_len - 1
        for (i, _fn, is_min, dt) in self.mlanes:
            red = torch.minimum if is_min else torch.maximum
            v_sorted = av_m[i][order]
            accs = torch.empty(k, dtype=dt)
            for p, ln in zip(start_pos.tolist(), seg_len.tolist()):
                accs[p:p + ln] = red(
                    _accumulate(v_sorted[p:p + ln], is_min),
                    lane_m[i][s_sorted[p]])
            vv = torch.empty(k, dtype=dt)
            vv[order] = accs
            mins[i] = vv
            upd = lane_m[i].clone()
            upd[seg_slot] = accs[ends]
            lane_m[i] = upd
        # carried updates: segment totals land on their slots
        lane_f = lane_f.clone()
        lane_i = lane_i.clone()
        lane_cnt = lane_cnt.clone()
        lane_f[:, seg_slot] += within_f[:, ends]
        lane_i[:, seg_slot] += within_i[:, ends]
        lane_cnt[seg_slot] += within_c[ends]
        new = dict(state)
        new["key_f"], new["key_i"] = lane_f, lane_i
        new["key_cnt"], new["key_m"] = lane_cnt, lane_m
        self._materialize(out, sums_f, sums_i, cnts, mins, k)
        return new

    def _materialize(self, out, sums_f, sums_i, cnts, mins, k) -> None:
        specs = self.c.specs
        for li, (i, _fn) in enumerate(self.flanes):
            s = specs[i]
            v = sums_f[li] if k else torch.zeros(0, dtype=_F64)
            if s.kind == "avg":
                v = v / torch.clamp(cnts, min=1)
            out[s.name] = v.to(TORCH_HOST[s.dtype])
        for li, (i, _fn) in enumerate(self.ilanes):
            s = specs[i]
            v = sums_i[li] if k else torch.zeros(0, dtype=_I64)
            if s.kind == "avg":
                v = v.to(_F64) / torch.clamp(cnts, min=1)
            out[s.name] = v.to(TORCH_HOST[s.dtype])
        for i, s in enumerate(specs):
            if s.kind == "count":
                out[s.name] = cnts.to(_I64)
        for (i, _fn, _m, dt) in self.mlanes:
            out[specs[i].name] = (mins[i] if k
                                  else torch.zeros(0, dtype=dt)) \
                .to(TORCH_HOST[specs[i].dtype])

    # -- snapshots -------------------------------------------------------
    def snapshot_state(self, state: dict) -> dict:
        """The state with numpy leaves (the reference's form)."""
        return host_tree_to_numpy(state)

    def restore_state(self, snap: dict) -> dict:
        return host_tree_from_numpy(snap)

    def decode(self, res: dict) -> tuple[list[int], list[list]]:
        cols = res["out"]
        rows = decode_columns(
            [(s.name, s.fn, s.dtype) for s in self.c.specs], cols,
            self.c.schema.dictionaries)
        return np.asarray(res["ts"]).tolist(), rows
