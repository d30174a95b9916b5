"""Kernel side of the incremental-aggregation step:
``csrc/aggregation_step.cu``.

``AggPlan`` is built by ``CompiledAggregation`` at construction: it links
the filters, every aggregate argument and every value projection into the
IR the kernel's interpreter runs (``csrc/expr_ir.cuh``) over the event
environment (variable slot c is one referenced column; ``eventTimestamp()``
reads the bucketing clock ``ts``), fills the kernel's argument block
(``AArgs``, mirrored here with ctypes) and refuses, with
``DeviceCompileError("aggregation kernel: ...")``, a definition over the
kernel's limits (columns, group keys, specs, stack depth, B), on every
device, so the CPU and the card accept the same definitions.

``step_cuda`` launches the kernel on the current stream (four launches a
step, counted in ``launches``) and returns the reference's output tree as
views into one device buffer, plus the buffer: one copy brings every lane
to the host (``unpack``). The plain version is
``aggregation_compile.aggregation_step_plain``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .dtypes import TORCH
from .expr_compile import OP, TY_OF, DeviceCompileError, cast_to, link_ir

AMAXCOL, AMAXG, AMAXSPEC = 32, 8, 32
MAX_B = 1 << 16             # events per step (the rank pass is O(D * B^2))
LANE = {"value": 0, "int": 1, "f64": 2, "f64sq": 3, "min": 4, "max": 5}

c_int, c_vp = ctypes.c_int, ctypes.c_void_p


class _Prog(ctypes.Structure):
    _fields_ = [("off", c_int), ("len", c_int)]


_SCRATCH = ("mask", "sval", "gkey", "order", "start", "first", "rank", "nseg")


class AArgs(ctypes.Structure):
    _fields_ = [
        *[(n, c_int) for n in ("B", "D", "ncol", "G", "S", "has_filter")],
        ("col_ty", c_int * AMAXCOL), ("g_col", c_int * AMAXG),
        ("g_ty", c_int * AMAXG), ("lane", c_int * AMAXSPEC),
        ("vty", c_int * AMAXSPEC), ("ones", c_int * AMAXSPEC),
        ("filt", _Prog), ("prog", _Prog * AMAXSPEC),
        ("code", c_vp), ("col", c_vp * AMAXCOL), ("buckets", c_vp),
        ("valid", c_vp),
        *[(n, c_vp) for n in _SCRATCH],
        ("bucket", c_vp), ("n_runs", c_vp), ("count", c_vp),
        ("o_main", c_vp * AMAXSPEC), ("o_sq", c_vp * AMAXSPEC),
        ("o_g", c_vp * AMAXG),
    ]


def _variables(ir) -> list[str]:
    return [a for (op, _, a, _) in ir or () if op in (OP["EV"], OP["BIND"])]


def _uses_ts(ir) -> bool:
    return any(op == OP["TS"] for (op, _, _, _) in ir or ())


class AggPlan:
    """Linked programs, the argument template, the output layout and the
    launch wrapper of ``csrc/aggregation_step.cu``. ``launches`` counts its
    kernel launches."""

    launches = 0          # class-wide: every launch of the aggregation kernels

    def __init__(self, ca):
        from .aggregation_compile import lane_kind
        self.ca = ca
        B, D = ca.B, ca.D
        progs = [*ca.filter_irs, *ca.spec_irs]
        used = {v for ir in progs for v in _variables(ir)}
        used |= {name for name, _t in ca.group_cols}
        # referenced columns in the stream's order; the clock after them
        self.col_names = [n for n in ca.schema.names if n in used]
        self.ts_slot = len(self.col_names) if any(map(_uses_ts, progs)) \
            else None
        ncol = len(self.col_names) + (self.ts_slot is not None)
        limits = [(ncol, AMAXCOL, "columns (the clock included)"),
                  (len(ca.group_cols), AMAXG, "group keys"),
                  (len(ca.specs), AMAXSPEC, "select attributes")]
        for n, cap, what in limits:
            if n > cap:
                raise DeviceCompileError(
                    f"aggregation kernel: {n} {what} (limit {cap})")
        if not 1 <= B <= MAX_B:
            raise DeviceCompileError(
                f"aggregation kernel: batch capacity {B} outside [1, {MAX_B}]")

        slot = {n: c for c, n in enumerate(self.col_names)}

        def operand(op, key):
            if op == OP["TS"]:
                return OP["EV"], self.ts_slot
            return OP["EV"], slot[key]

        code: list[np.ndarray] = []

        def add(ir, ty):
            try:
                prog = link_ir(cast_to(ir, ty), operand)
            except DeviceCompileError as e:
                raise DeviceCompileError(f"aggregation kernel: {e}") from None
            off = sum(len(c) for c in code)
            code.append(prog)
            return _Prog(off, len(prog))

        a = AArgs()
        self.args = a
        a.B, a.D, a.ncol = B, D, ncol
        a.G, a.S = len(ca.group_cols), len(ca.specs)
        types = ca.schema.definition
        for c, n in enumerate(self.col_names):
            a.col_ty[c] = TY_OF[TORCH[types.attribute_type(n)]]
        if self.ts_slot is not None:
            a.col_ty[self.ts_slot] = TY_OF[torch.int64]
        if ca.filter_irs:
            ir = []
            for i, f in enumerate(ca.filter_irs):
                ir += cast_to(f, TY_OF[torch.bool])
                if i:
                    ir.append((OP["AND"], TY_OF[torch.bool], 0, 0))
            a.has_filter = 1
            a.filt = add(ir, TY_OF[torch.bool])
        for g, (name, t) in enumerate(ca.group_cols):
            a.g_col[g] = slot[name]
            a.g_ty[g] = TY_OF[TORCH[t]]

        # the output tree: (key, dtype, shape), every lane [D, B]
        layout = [("bucket", torch.int64, (D, B)), ("n_runs", torch.int64, (D,)),
                  ("count", torch.int64, (D, B))]
        self.main_key: list[str] = []
        for k, (s, ir) in enumerate(zip(ca.specs, ca.spec_irs)):
            nm, lk = s["name"], lane_kind(s)
            a.lane[k] = LANE[lk]
            if lk == "value":
                dt = TORCH[s["dtype"]]
                key = f"last_{nm}"
            elif lk in ("min", "max"):
                dt = TORCH[s["arg_t"]]
                key = f"m_{nm}"
            else:
                dt = torch.int64 if lk == "int" else torch.float64
                key = f"sum_{nm}"
            self.main_key.append(key)
            layout.append((key, dt, (D, B)))
            if lk == "f64sq":
                layout.append((f"sq_{nm}", torch.float64, (D, B)))
            if s["kind"] == "count":        # count(...): sums ones
                a.ones[k] = 1
                a.vty[k] = TY_OF[torch.float32]
                continue
            a.vty[k] = TY_OF[dt] if lk in ("value", "min", "max") else \
                TY_OF[TORCH[s["arg_t"]]]
            a.prog[k] = add(ir, a.vty[k])
        for name, t in ca.group_cols:
            layout.append((f"g_{name}", TORCH[t], (D, B)))
        self.layout, off = [], 0
        for key, dt, shape in layout:
            nbytes = int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
            self.layout.append((key, dt, shape, off, nbytes))
            off += -(-nbytes // 8) * 8          # every lane 8-byte aligned
        self.out_bytes = off
        self.code_host = np.concatenate(code) if code else \
            np.zeros((1, 4), np.int32)
        self._dev = {}      # device → (argument template, code, scratch)
        self._lib_checked = False

    # -- outputs -------------------------------------------------------------
    def views(self, buf: torch.Tensor) -> dict:
        """The output tree as views into one uint8 buffer."""
        return {key: buf[off:off + n].view(dt).view(shape)
                for key, dt, shape, off, n in self.layout}

    def unpack(self, host: np.ndarray) -> dict:
        """The output tree as numpy views into the buffer fetched to host."""
        return {key: host[off:off + n].view(
                    torch.empty((), dtype=dt).numpy().dtype).reshape(shape)
                for key, dt, shape, off, n in self.layout}

    # -- kernel side ---------------------------------------------------------
    def _lib(self):
        from ._build import load
        lib = load("aggregation_step")
        if not self._lib_checked:
            lib.aggregation_step.argtypes = [c_vp, c_vp, c_vp]
            lib.aggregation_step.restype = c_int
            lib.aggregation_step_args_size.restype = c_int
            if lib.aggregation_step_args_size() != ctypes.sizeof(AArgs):
                raise RuntimeError(
                    f"AArgs layout differs between aggregation_step.cu "
                    f"({lib.aggregation_step_args_size()} B) and the ctypes "
                    f"mirror ({ctypes.sizeof(AArgs)} B)")
            self._lib_checked = True
        return lib

    def _check(self, cols, ts, buckets, valid):
        ca, dev = self.ca, ts.device

        def need(t, name, dtype, shape):
            if not isinstance(t, torch.Tensor) or t.device != dev:
                raise ValueError(f"{name} must be a tensor on {dev}")
            if t.dtype != dtype or tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

        need(ts, "ts", torch.int64, (ca.B,))
        need(buckets, "buckets", torch.int64, (ca.D, ca.B))
        need(valid, "valid", torch.bool, (ca.B,))
        types = ca.schema.definition
        for n in self.col_names:
            if n not in cols:
                raise ValueError(f"missing column '{n}'")
            need(cols[n], f"cols[{n!r}]", TORCH[types.attribute_type(n)],
                 (ca.B,))

    def step_cuda(self, cols, ts, buckets, valid):
        """Runs one step on the card (launches on the current stream);
        returns ``(output tree, the buffer it lies in)``."""
        if ts.device.type != "cuda":
            raise ValueError("step_cuda takes CUDA tensors")
        self._check(cols, ts, buckets, valid)
        return self.launch(self._lib(), cols, ts, buckets, valid,
                           torch.cuda.current_stream(ts.device).cuda_stream)

    def launch(self, lib, cols, ts, buckets, valid, stream):
        """Calls the library's entry point over these tensors (checked by
        ``step_cuda``) and counts the launches it made."""
        dev = ts.device
        a = AArgs.from_buffer_copy(self._on(dev))
        keep = [cols, ts, buckets, valid]             # alive until launched
        for c, n in enumerate(self.col_names):
            a.col[c] = cols[n].data_ptr()
        if self.ts_slot is not None:
            a.col[self.ts_slot] = ts.data_ptr()
        a.buckets, a.valid = buckets.data_ptr(), valid.data_ptr()
        buf = torch.empty(self.out_bytes, dtype=torch.uint8, device=dev)
        out = self.views(buf)
        keep.append(buf)
        a.bucket, a.n_runs = out["bucket"].data_ptr(), out["n_runs"].data_ptr()
        a.count = out["count"].data_ptr()
        for k, s in enumerate(self.ca.specs):
            a.o_main[k] = out[self.main_key[k]].data_ptr()
            if a.lane[k] == LANE["f64sq"]:
                a.o_sq[k] = out[f"sq_{s['name']}"].data_ptr()
        for g, (name, _t) in enumerate(self.ca.group_cols):
            a.o_g[g] = out[f"g_{name}"].data_ptr()
        n = c_int(0)
        rc = lib.aggregation_step(ctypes.addressof(a), stream,
                                  ctypes.addressof(n))
        type(self).launches += n.value
        if rc != 0:
            raise RuntimeError(f"aggregation_step launch failed: CUDA error {rc}")
        return out, buf

    def _on(self, dev) -> AArgs:
        """The argument template on ``dev``: the linked code and the scratch
        buffers, allocated once per device and reused by every step (the
        launches of consecutive steps are ordered on the stream)."""
        got = self._dev.get(dev)
        if got is None:
            ca = self.ca
            B, D = ca.B, ca.D
            S, G = max(len(ca.specs), 1), max(len(ca.group_cols), 1)
            code = torch.from_numpy(self.code_host).to(dev)
            i32, i64, u8 = torch.int32, torch.int64, torch.uint8
            scratch = {"mask": torch.empty(B, dtype=u8, device=dev),
                       "sval": torch.empty((S, B), dtype=i64, device=dev),
                       "gkey": torch.empty((G, B), dtype=i64, device=dev),
                       "order": torch.empty((D, B), dtype=i32, device=dev),
                       "start": torch.empty((D, B), dtype=i32, device=dev),
                       "first": torch.empty((D, B), dtype=u8, device=dev),
                       "rank": torch.empty((D, B), dtype=i32, device=dev),
                       "nseg": torch.empty(D, dtype=i32, device=dev)}
            a = AArgs.from_buffer_copy(self.args)
            a.code = code.data_ptr()
            for name, t in scratch.items():
                setattr(a, name, t.data_ptr())
            got = self._dev[dev] = (a, code, scratch)
        return got[0]
