"""Kernel side of the single-stream query step: ``csrc/query_step.cu``
(every window but the scan-walked ones) and, through ``query_walk.WalkPlan``,
``csrc/query_walk.cu``; both share the argument block of
``csrc/query_common.cuh``.

``QueryPlan`` is built by ``CompiledStreamQuery`` at construction
(``make_plan``): it links the query's programs (filters, projections,
aggregate arguments, group and heavy-hitter keys, the sort key, the
externalTime column, having) into the IR the kernels' interpreter runs
(``csrc/expr_ir.cuh``; a fleet parameter ``__fleet_p{i}`` is one more
event column, and one that ``having`` reads is compacted with the
accepted events into ``QArgs.pc`` and read at the output slot), fills the
kernels' argument block (``QArgs``,
mirrored here with ctypes) and refuses, with ``DeviceCompileError``, a query
over a kernel limit (columns, outputs, lanes, filters, group keys, stack
depth, sizes), on every device, so the CPU and the card accept the same
queries.

``step_cuda`` launches the kernel on the current stream (``query_step.cu``:
``step_launches`` a step, 4 to 10 by shape: the filter and the compaction
over a grid, the rest of the batch's work in one CTA, the group-by's three
sort launches, 1 to 3 passes of the tile grid, the emit;
``query_walk.cu``: one; each plan class counts its own in ``launches``) and
returns the new state (fresh tensors for every leaf the step changes; the
input state is left as it was) and the outputs, over the window's output
axis.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .dtypes import TORCH
from .backend import reduce_identity
from .expr_compile import (OP, TY_OF, DeviceCompileError, cast_to,
                           const_bits, link_ir)
from .query_compile import REMAINDER, TAILED, WALKED, CompiledStreamQuery

QMAXCOL, QMAXSPEC, QMAXLANE, QMAXFILT, QMAXGK = 32, 32, 16, 8, 8
MAX_ROWS = 1 << 26          # largest window_capacity + batch_capacity
MAX_K = 1 << 24             # largest group_capacity
TN = 256                    # threads a CTA of query_step.cu's grids
TILE = 2048                 # positions a tile of the pass grid (query_step.cu)
SORT_ROUNDS = 4             # rounds of 32 positions a row of the group sort
SORT_CELLS = 1 << 22        # most cells of its [rows, K] count matrix

W_KIND = {None: 0, "length": 1, "time": 2, "timeLength": 3, "batch": 4,
          "lengthBatch": 5, "timeBatch": 6, "session": 7, "delay": 8,
          "hopping": 9, "sort": 10, "frequent": 11, "lossyFrequent": 12}
S_KIND = {"value": 0, "count": 1, "sum": 2, "avg": 3, "min": 4, "max": 5,
          "stdDev": 6}
KM_NARROW, KM_WIDE1, KM_PAIR, KM_FNV = range(4)
L_F, L_I, L_S, L_M = range(4)

c_int, c_ll, c_vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


class _Prog(ctypes.Structure):
    _fields_ = [("off", c_int), ("len", c_int)]


_STATE = ("f", "fc", "i", "s", "smean", "sm2", "scnt", "ones", "cnt")
_STATE2 = ("tts", "gkey", "owner", "owned", "last_ts", "drops", "regress",
           "coll")
_STATE3 = ("rc", "rts", "base", "skeys", "hkeys", "hcnt", "hdelta", "runf",
           "runi", "runc", "htot")
_SCRATCH = ("misc", "mask", "rank", "ccnt", "bf", "bi", "bs", "bm", "bones",
            "bpacked", "bkey", "bwts", "bkeyv", "bv", "lo", "hi", "oflag",
            "zt", "zseg", "firstidx", "cnt", "seg", "ckey", "sorted",
            "head", "incf", "inci", "inco", "incs1", "incs2", "mP", "mS", "mT",
            "pz", "gmat", "tagg", "tfl", "tpz", "acc", "hidx", "hfree")


def _ptrs(names, suffix):
    return [(n + suffix, c_vp) for n in names]


class QArgs(ctypes.Structure):
    _fields_ = [
        *[(n, c_int) for n in ("B", "N", "M", "K", "LV", "NB", "O", "wkind",
                               "grouped", "key_mode", "has_agg", "nfilt",
                               "ncol", "nspec", "ngk", "AF", "AI", "AS", "AM",
                               "ntask", "has_wprog", "has_having", "sort_kty",
                               "sort_desc")],
        ("window_ms", c_ll), ("hop_ms", c_ll), ("skey_fill", c_ll),
        ("hh_support", ctypes.c_double), ("hh_error", ctypes.c_double),
        ("col_ty", c_int * QMAXCOL),
        *[(n, c_int * QMAXSPEC) for n in ("spec_kind", "spec_ty", "spec_lane",
                                          "spec_int")],
        ("m_ty", c_int * QMAXLANE), ("m_min", c_int * QMAXLANE),
        ("m_ident", c_ll * QMAXLANE),
        ("filt", _Prog * QMAXFILT), ("proj", _Prog * QMAXSPEC),
        ("lane", (_Prog * QMAXLANE) * 4), ("gk", _Prog * QMAXGK),
        ("wprog", _Prog), ("having", _Prog), ("skey", _Prog),
        ("code", c_vp), ("col", c_vp * QMAXCOL), ("ts", c_vp), ("valid", c_vp),
        *_ptrs(_STATE, "_in"), ("m_in", c_vp * QMAXLANE),
        *_ptrs(_STATE2, "_in"), *_ptrs(_STATE3, "_in"),
        ("rp_in", c_vp * QMAXSPEC),
        *_ptrs(_STATE, "_out"), ("m_out", c_vp * QMAXLANE),
        *_ptrs(_STATE2, "_out"), *_ptrs(_STATE3, "_out"),
        ("rp_out", c_vp * QMAXSPEC),
        ("out", c_vp * QMAXSPEC), ("ovalid", c_vp), ("ots", c_vp),
        ("ocount", c_vp),
        *[(n, c_vp) for n in _SCRATCH],
        ("hh_H", c_int), ("hh_shared", c_int),
        ("ntile", c_int), ("nrow", c_int), ("gsub", c_int),
        ("npar", c_int), ("par_col", c_int * QMAXCOL), ("pc", c_vp),
    ]


def link_query_program(ir: list, slot: dict, ts_slot: int | None,
                       bind: bool = False,
                       params: dict | None = None) -> np.ndarray:
    """Resolves a query program's env keys to kernel slots: every variable
    key (bare attribute names, or output names for ``having``) →
    ``slot[key]`` (an event-column read, or an output binding when
    ``bind``); a fleet parameter read of ``having`` (an ``OP_EV`` key in
    ``params``) → its ordinal among the compacted parameter columns;
    ``eventTimestamp()`` → the int64 timestamp column. Raises KeyError for
    a key the step's env lacks, as the reference raises at its first
    step."""
    def operand(op, a):
        if op == OP["TS"]:
            if ts_slot is None:
                raise KeyError("__ts__")
            return OP["EV"], ts_slot
        if params is not None and op == OP["EV"] and a in params:
            return OP["EV"], params[a]
        if a not in slot:
            raise KeyError(a)
        return (OP["BIND"] if bind else OP["EV"]), slot[a]

    return link_ir(ir, operand)


def _var_ir(name: str, t) -> list:
    return [(OP["BIND"], TY_OF[TORCH[t]], name, 0)]


class QueryPlan:
    """Linked programs, the argument template and the launch wrapper of
    ``csrc/query_step.cu``. ``launches`` counts its kernel launches."""

    launches = 0          # class-wide: every launch of this plan's kernels
    LIB = "query_step"    # csrc/<LIB>.cu, entry point <LIB>(args, stream, n)
    WHAT = "query kernel"

    def __init__(self, q: CompiledStreamQuery):
        self.q = q
        specs = q.specs
        kind = q.window_kind
        N = max(q.window_n, 1) if kind not in (None, "batch") else 0
        M = N + q.B if kind in TAILED + REMAINDER else q.B
        limits = [(len(specs), QMAXSPEC, "outputs"),
                  (len(q.filter_irs), QMAXFILT, "filters"),
                  (len(q.group_keys), QMAXGK, "group keys"),
                  (M, MAX_ROWS, "window + batch rows"), (q.K, MAX_K, "groups")]
        for idx, what in ((q.fagg_idx, "float sums"), (q.iagg_idx, "int sums"),
                          (q.sagg_idx, "stdDev lanes"),
                          (q.magg_idx, "min/max lanes")):
            limits.append((len(idx), QMAXLANE, what))
        # event columns the programs read, then the timestamp column
        used = set()
        progs_ir = list(q.filter_irs) + [s.ir for s in specs if s.ir]
        for ir in progs_ir:
            used |= {a for (op, _, a, _) in ir if op in (OP["EV"], OP["BIND"])}
        used |= set(q.group_keys) | set(q.hh_keys)
        for key in (q.time_key, q.sort_key):
            if key:
                used.add(key)
        # fleet parameter columns that having reads: compacted with the
        # accepted events (``csrc/query_common.cuh``: ``pc``), read at the
        # output slot; only where an output slot is an accepted event's
        self.par_keys = sorted(q.having_params)
        used |= set(self.par_keys)
        if self.par_keys and kind in REMAINDER:
            raise DeviceCompileError(
                f"{self.WHAT}: having reads fleet parameter "
                f"'{self.par_keys[0]}' over a '{kind}' window, whose output "
                f"rows are not the batch's accepted events")
        self.col_keys = sorted(used)
        limits.append((len(self.col_keys) + 1, QMAXCOL, "event columns"))
        for n, cap, what in limits:
            if n > cap:
                raise DeviceCompileError(
                    f"{self.WHAT}: {n} {what} (limit {cap})")
        slot = {k: i for i, k in enumerate(self.col_keys)}
        ts_slot = len(self.col_keys)
        types = {k: q.column_type(k) for k in self.col_keys}
        self.col_ty = [TY_OF[TORCH[types[k]]] for k in self.col_keys] + \
            [TY_OF[torch.int64]]

        a = QArgs()
        self.args = a
        code: list[np.ndarray] = []
        self.link_error = None      # raised at the first step, as the
        # reference raises at its first step (trace time)

        def add(ir, ty=None, env=slot, tss=ts_slot, bind=False, params=None):
            if ty is not None:
                ir = cast_to(ir, ty)
            try:
                prog = link_query_program(ir, env, tss, bind, params)
            except KeyError as e:
                self.link_error = self.link_error or e
                return _Prog(0, 0)
            off = sum(len(c) for c in code)
            code.append(prog)
            return _Prog(off, len(prog))

        T_BOOL, T_I64, T_F32 = (TY_OF[torch.bool], TY_OF[torch.int64],
                                TY_OF[torch.float32])
        a.B, a.N, a.M, a.K = q.B, N, M, q.K
        a.O = M if kind in REMAINDER else q.B
        # min/max range tables: blocks of 32 positions, chunks of 32 blocks,
        # LV levels of the sparse table over chunks
        a.NB = (a.M + 31) // 32
        a.LV = max(((a.NB + 31) // 32).bit_length(), 1)
        a.ntile = -(-a.M // TILE)
        # the group-by sort's rows: SORT_ROUNDS rounds of 32 positions, more
        # where the [rows, K] count matrix would pass SORT_CELLS
        rounds = max(SORT_ROUNDS, -(-a.M * q.K // (32 * SORT_CELLS)))
        a.gsub = 32 * rounds
        a.nrow = -(-a.M // a.gsub)
        a.wkind = W_KIND[kind]
        a.grouped = int(bool(q.group_keys))
        a.has_agg = int(bool(q.agg_idx))
        a.window_ms, a.hop_ms = q.window_ms, q.hop_ms
        a.nfilt, a.ncol, a.nspec = len(q.filter_irs), ts_slot + 1, len(specs)
        for i, ty in enumerate(self.col_ty):
            a.col_ty[i] = ty
        for f, ir in enumerate(q.filter_irs):
            a.filt[f] = add(ir, T_BOOL)
        lanes = {L_F: q.fagg_idx, L_I: q.iagg_idx, L_S: q.sagg_idx,
                 L_M: q.magg_idx}
        lane_ty = {L_F: T_F32, L_I: T_I64, L_S: T_F32}
        lane_of = {}
        for cls, idx in lanes.items():
            for l, i in enumerate(idx):
                lane_of[i] = l
                ty = lane_ty.get(cls, TY_OF[TORCH[specs[i].dtype]])
                a.lane[cls][l] = add(specs[i].ir, ty)
        for m, i in enumerate(q.magg_idx):
            dt = TORCH[specs[i].dtype]
            is_min = specs[i].kind == "min"
            a.m_ty[m], a.m_min[m] = TY_OF[dt], int(is_min)
            a.m_ident[m] = const_bits(reduce_identity(dt, is_min), TY_OF[dt])
        a.AF, a.AI = len(q.fagg_idx), len(q.iagg_idx)
        a.AS, a.AM = len(q.sagg_idx), len(q.magg_idx)
        a.ntask = (a.AF + a.AI + 1 + a.AS + a.AM) if q.agg_idx else 0
        for i, s in enumerate(specs):
            a.spec_kind[i] = S_KIND[s.kind]
            a.spec_ty[i] = TY_OF[TORCH[s.dtype]]
            a.spec_int[i] = int(s.acc_int)
            a.spec_lane[i] = lane_of.get(i, 0)
            if s.kind == "value":
                a.proj[i] = add(s.ir, a.spec_ty[i])
        keys = q.group_keys or q.hh_keys
        if keys:
            a.ngk = len(keys)
            for g, key in enumerate(keys):
                a.gk[g] = add(_var_ir(key, types[key]), T_I64)
            if q.group_keys:
                narrow = all(t.name in ("STRING", "INT")
                             for t in q.group_key_types)
                a.key_mode = (KM_NARROW if narrow else KM_WIDE1) \
                    if a.ngk == 1 else \
                    (KM_PAIR if a.ngk == 2 and narrow else KM_FNV)
            else:               # a heavy-hitter code: (k0 << 32) | k1
                a.key_mode = KM_PAIR if a.ngk == 2 else KM_NARROW
        if q.time_key:
            a.has_wprog = 1
            a.wprog = add(_var_ir(q.time_key, types[q.time_key]), T_I64)
        if q.sort_key:
            kdt = TORCH[q.sort_key_type]
            a.sort_kty, a.sort_desc = TY_OF[kdt], int(q.sort_desc)
            a.skey = add(_var_ir(q.sort_key, q.sort_key_type), a.sort_kty)
            a.skey_fill = const_bits(reduce_identity(kdt, True), a.sort_kty)
        a.hh_support, a.hh_error = q.lossy_support, q.lossy_error
        if kind in ("frequent", "lossyFrequent"):
            a.hh_H = 1 << (2 * N - 1).bit_length()
        if q.having_ir is not None:
            a.has_having = 1
            out_slot = {s.name: i for i, s in enumerate(specs)}
            par_slot = {k: p for p, k in enumerate(self.par_keys)}
            a.having = add(cast_to(q.having_ir, T_BOOL), env=out_slot, tss=None,
                           bind=True, params=par_slot)
            a.npar = len(self.par_keys)
            for p, k in enumerate(self.par_keys):
                a.par_col[p] = slot[k]
        self.code_host = np.concatenate(code) if code else \
            np.zeros((1, 4), np.int32)
        self._dev = {}      # device → (argument template, code, scratch)
        self._proto = None  # the state's leaves (meta tensors)
        self._lib_checked = False

    def passes(self) -> int:
        """Launches of ``query_step.cu``'s pass grid a step makes (its
        ``pass_count``): the lanes' reduce-then-scan 2 (3 with a windowed
        stdDev, whose centre is the axis mean), the tumbling clock's
        segments 3 (lengthBatch 1), the time and hopping bounds 1."""
        a, kind = self.args, self.q.window_kind
        n = (3 if a.AS and kind is not None else 2) if a.ntask else 0
        if kind in ("timeBatch", "session", "delay"):
            n = 3
        if kind in ("lengthBatch", "time", "timeLength", "hopping"):
            n = max(n, 1)
        return n

    def step_launches(self) -> int:
        """Kernel launches of one step: q_mask, q_compact, q_prep, the
        group-by sort's three, the passes, q_emit (the sort's memset is not
        a launch)."""
        return 4 + 3 * self.args.grouped + self.passes()

    # -- kernel side ---------------------------------------------------------
    def _lib(self):
        from ._build import load
        lib = load(self.LIB)
        if not self._lib_checked:
            entry = getattr(lib, self.LIB)
            entry.argtypes = [c_vp, c_vp, c_vp]
            entry.restype = c_int
            size = getattr(lib, self.LIB + "_args_size")
            size.restype = c_int
            if size() != ctypes.sizeof(QArgs):
                raise RuntimeError(
                    f"QArgs layout differs between {self.LIB}.cu "
                    f"({size()} B) and the ctypes mirror "
                    f"({ctypes.sizeof(QArgs)} B)")
            tile = getattr(lib, self.LIB + "_tile", None)
            if tile is not None:
                tile.restype = c_int
                if tile() != TILE:
                    raise RuntimeError(f"{self.LIB}.cu tiles {tile()} positions, "
                                       f"the plan {TILE}")
            self._lib_checked = True
        return lib

    def _check(self, state, cols, ts, valid):
        q = self.q
        dev = ts.device

        def need(t, name, dtype, shape):
            if not isinstance(t, torch.Tensor) or t.device != dev:
                raise ValueError(f"{name} must be a tensor on {dev}")
            if t.dtype != dtype or tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

        need(ts, "ts", torch.int64, (q.B,))
        need(valid, "valid", torch.bool, (q.B,))
        for k in self.col_keys:
            if k not in cols:
                raise ValueError(f"missing column '{k}'")
            need(cols[k], f"cols[{k!r}]", TORCH[q.column_type(k)], (q.B,))
        if self._proto is None:
            self._proto = q.init_state(device="meta")
        proto = self._proto
        if set(state) != set(proto):
            raise ValueError(f"state leaves differ: "
                             f"{sorted(set(state) ^ set(proto))}")
        for k, p in proto.items():
            need(state[k], f"state[{k!r}]", p.dtype, p.shape)

    def prepare(self, dev) -> None:
        """The work of a first step that does not depend on its inputs: the
        argument template on ``dev`` and the state prototype the checks
        compare against. Called when the query is built, so the first step
        times like every other."""
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            # the template is keyed by the device the step's tensors report
            dev = torch.device("cuda", torch.cuda.current_device())
        self._on(dev)
        if self._proto is None:
            self._proto = self.q.init_state(device="meta")

    def step_cuda(self, state, cols, ts, valid):
        """Runs one step on the card (launches on the current stream)."""
        if ts.device.type != "cuda":
            raise ValueError("step_cuda takes CUDA tensors")
        self._check(state, cols, ts, valid)
        if self.q.step_error is not None:
            raise AttributeError(self.q.step_error)
        if self.link_error is not None:
            raise self.link_error
        return self.launch(self._lib(), state, cols, ts, valid,
                           torch.cuda.current_stream(ts.device).cuda_stream)

    def launch(self, lib, state, cols, ts, valid, stream):
        """Calls the library's entry point over these tensors (checked by
        ``step_cuda``) and counts the launches it made."""
        q, dev = self.q, ts.device
        a = QArgs.from_buffer_copy(self._on(dev))
        keep = []                                      # alive until launched

        def ptr(t):
            keep.append(t)
            return t.data_ptr()

        for c, k in enumerate(self.col_keys):
            a.col[c] = ptr(cols[k])
        a.col[len(self.col_keys)] = ptr(ts)
        a.ts, a.valid = ptr(ts), ptr(valid)

        new = dict(state)

        def fresh(leaf):
            new[leaf] = torch.empty_like(state[leaf])
            return ptr(state[leaf]), ptr(new[leaf])

        for field, leaf in self._state_names().items():
            if leaf in state:
                src, dst = fresh(leaf)
                setattr(a, field + "_in", src)
                setattr(a, field + "_out", dst)
        for m, i in enumerate(q.magg_idx):
            leaf = self._m_leaf(i)
            if leaf in state:                # batch(): nothing carried
                a.m_in[m], a.m_out[m] = fresh(leaf)
        prefix = self._proj_prefix()
        for i in q.value_idx:
            if prefix:
                a.rp_in[i], a.rp_out[i] = fresh(f"{prefix}{i}")

        O = a.O
        outs = {}
        for n, s in enumerate(q.specs):
            outs[s.name] = torch.empty(O, dtype=TORCH[s.dtype], device=dev)
            a.out[n] = ptr(outs[s.name])
        ovalid = torch.empty(O, dtype=torch.bool, device=dev)
        ots = torch.empty(O, dtype=torch.int64, device=dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        a.ovalid, a.ots, a.ocount = ptr(ovalid), ptr(ots), ptr(count)
        n = c_int(0)
        rc = getattr(lib, self.LIB)(ctypes.addressof(a), stream,
                                    ctypes.addressof(n))
        type(self).launches += n.value
        if rc != 0:
            raise RuntimeError(f"{self.LIB} launch failed: CUDA error {rc}")
        return new, {"out": outs, "valid": ovalid, "ts": ots, "count": count}

    def _on(self, dev) -> QArgs:
        """The argument template on ``dev``: the linked code and the scratch
        buffers, allocated once per device and reused by every step (the
        launches of consecutive steps are ordered on the stream)."""
        got = self._dev.get(dev)
        if got is None:
            code = torch.from_numpy(self.code_host).to(dev)
            scratch = self._scratch(dev)
            a = QArgs.from_buffer_copy(self.args)
            a.code = code.data_ptr()
            for name, t in scratch.items():
                setattr(a, name, t.data_ptr())
            got = self._dev[dev] = (a, code, scratch)
        return got[0]

    def _m_leaf(self, i: int) -> str:
        q = self.q
        if q.window_kind in TAILED:
            return f"tail_m{i}"
        if q.window_kind == "sort":
            return f"sort_m{i}"
        return f"key_m{i}" if q.group_keys else f"run_m{i}"

    def _proj_prefix(self) -> str | None:
        """The state leaves that carry value projections, per spec."""
        kind = self.q.window_kind
        if kind in REMAINDER:
            return "rem_proj_"
        return "tail_proj_" if kind == "hopping" else None

    def _state_names(self) -> dict:
        """Kernel pointer field → state leaf, by mode (a leaf the state lacks
        leaves its pointers null)."""
        q = self.q
        kind = q.window_kind
        if kind in TAILED or kind in REMAINDER:
            return {"f": "tail_fvals", "i": "tail_ivals", "s": "tail_svals",
                    "ones": "tail_ones", "tts": "tail_ts", "gkey": "tail_gkey",
                    "owner": "key_owner", "owned": "key_owned",
                    "last_ts": "last_ts", "drops": "window_drops",
                    "regress": "ts_regressions", "coll": "group_collisions",
                    "rc": "rem_count", "rts": "rem_ts",
                    "base": "hop_next" if kind == "hopping" else "batch_base"}
        if kind == "sort":
            return {"f": "sort_fvals", "i": "sort_ivals", "s": "sort_svals",
                    "rc": "sort_n", "skeys": "sort_keys"}
        if kind in ("frequent", "lossyFrequent"):
            return {"f": "hh_fvals", "i": "hh_ivals", "hkeys": "hh_keys",
                    "hcnt": "hh_counts", "hdelta": "hh_delta",
                    "runf": "hh_run_f", "runi": "hh_run_i",
                    "runc": "hh_run_cnt", "htot": "hh_total",
                    "drops": "window_drops"}
        if q.group_keys:
            return {"f": "key_fsums", "fc": "key_fcomp", "i": "key_isums",
                    "cnt": "key_counts", "smean": "key_smean",
                    "sm2": "key_sm2", "scnt": "key_scnt", "owner": "key_owner",
                    "owned": "key_owned", "coll": "group_collisions"}
        return {"f": "run_fsums", "fc": "run_fcomp", "i": "run_isums",
                "cnt": "run_count", "smean": "run_smean", "sm2": "run_sm2",
                "scnt": "run_scnt"}

    def _scratch(self, dev) -> dict:
        """Scratch tensors of a step (the kernels allocate nothing)."""
        q, a = self.q, self.args
        B, K, M, O = q.B, q.K, a.M, a.O
        i32, i64, f32, f64, u8 = (torch.int32, torch.int64, torch.float32,
                                  torch.float64, torch.uint8)
        grouped = bool(q.group_keys)
        Kx = K if grouped else 1
        Mg = M if grouped else 1
        Mr = M if q.window_kind in REMAINDER else 1
        Bh = a.nspec * B if q.window_kind == "hopping" else 1
        tasks = 1 + a.ntask                  # the pass grid's: axis, lanes

        def e(n, dt):
            return torch.empty(max(n, 1), dtype=dt, device=dev)

        return {
            "misc": e(8, i32), "mask": e(B, u8), "rank": e(B, i32),
            "ccnt": e(-(-B // TN), i32),
            "bf": e(a.AF * B, f32), "bi": e(a.AI * B, i64),
            "bs": e(a.AS * B, f32), "bm": e(a.AM * B, i64),
            "bones": e(B, i32), "bpacked": e(B, i64), "bkey": e(B, i32),
            "bwts": e(B, i64), "bkeyv": e(B, i64), "bv": e(Bh, i64),
            "lo": e(O, i32), "hi": e(O, i32), "oflag": e(O, u8),
            "zt": e(Mr, i64), "zseg": e(Mr, i64),
            "firstidx": e(Kx, i32), "cnt": e(Kx, i32), "seg": e(Kx, i32),
            "ckey": e(a.AS * Kx, f32),
            "sorted": e(Mg, i32), "head": e(Mg, u8),
            "incf": e(a.AF * M, f64), "inci": e(a.AI * M, i64),
            "inco": e(M, i64), "incs1": e(a.AS * M, f64),
            "incs2": e(a.AS * M, f64), "mP": e(a.AM * M, i64),
            "mS": e(a.AM * M, i64),
            "mT": e(a.AM * (7 * a.NB + a.LV * ((a.NB + 31) // 32)), i64),
            "pz": e(3 * (a.AF + 2 * a.AS), i32),
            "gmat": e(a.nrow * K if grouped else 0, i32),
            "tagg": e(tasks * 4 * a.ntile, i64), "tfl": e(tasks * 4 * a.ntile, i32),
            "tpz": e(tasks * 6 * a.ntile, i32), "acc": e(4, i64),
            "hidx": e(a.hh_H, i32), "hfree": e((a.N + 31) // 32 if a.hh_H else 0,
                                               i32),
            "pc": e(a.npar * B, i64),
        }


def make_plan(q: CompiledStreamQuery) -> QueryPlan:
    """The kernel plan of a compiled query: ``csrc/query_walk.cu`` for the
    scan-walked windows, ``csrc/query_step.cu`` for every other shape."""
    if q.window_kind in WALKED:
        from .query_walk import WalkPlan
        return WalkPlan(q)
    return QueryPlan(q)
