"""Kernel side of the stream-stream join step: ``csrc/join_step.cu``.

``JoinPlan`` is built by ``CompiledJoinQuery`` at construction: it links the
``on`` condition and every output program into the IR the kernel's
interpreter runs (``csrc/expr_ir.cuh``) over a pair environment (variable
slot v is one referenced attribute of the left or right side; the kernel
reads it from the probe's row or from the candidate's ring slot or batch
row, by the probe's side; ``eventTimestamp()`` reads the probe's
timestamp), fills the kernel's argument block (``JArgs``, mirrored here
with ctypes) and refuses, with ``DeviceCompileError("join kernel: ...")``,
a join over the kernel's limits, on every device, so the CPU and the card
accept the same joins.

Where the condition has a top-level conjunct ``L.a == R.b`` over BOOL,
INT, LONG or string attributes (``key_conjunct``), the plan links each
side's operand as a key program and the kernel walks a key index: each
probe visits only the candidates in its key's hash bucket (``indexed``).
Other conditions (``or`` at the top, an equality between floats, no
condition) walk every candidate.

``step_cuda`` launches the kernel on the current stream (four launches a
step, five with the index, counted in ``launches``) and returns the new
state (fresh tensors for the rings and counters; the input state is left as
it was) and the reference's output tree over ``J`` rows. The plain version
is ``join_compile.join_step_plain``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..query_api.definition import DataType
from .dtypes import TORCH
from .expr_compile import OP, T_F32, TY_OF, DeviceCompileError, cast_to, link_ir

JMAXVAR, JMAXOUT = 32, 32
JMAXSIDE = 16               # referenced attributes per side
K_KIND = {"time": 0, "length": 1}
NB = 1 << 12                # buckets of a key index (csrc/join_step.cu NB)

c_int, c_ll, c_vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


class _Prog(ctypes.Structure):
    _fields_ = [("off", c_int), ("len", c_int)]


class JArgs(ctypes.Structure):
    _fields_ = [
        *[(n, c_int) for n in ("B", "W", "J", "nvalid", "lkind", "rkind")],
        ("lparam", c_ll), ("rparam", c_ll),
        ("has_within", c_int), ("within", c_ll),
        *[(n, c_int) for n in ("emit_left", "emit_right", "un_left",
                               "un_right", "nvar", "has_cond", "nout",
                               "indexed")],
        ("var_side", c_int * JMAXVAR), ("var_ty", c_int * JMAXVAR),
        ("out_ty", c_int * JMAXOUT), ("out_null", c_int * JMAXOUT),
        ("cond", _Prog), ("keyp", _Prog * 2), ("outp", _Prog * JMAXOUT),
        ("code", c_vp), ("tag", c_vp), ("ts", c_vp), ("ts_base", c_vp),
        ("col", c_vp * JMAXVAR), ("ring_in", c_vp * JMAXVAR),
        ("ring_out", c_vp * JMAXVAR),
        *[(n, c_vp) for n in ("lts_in", "rts_in", "lts_out", "rts_out",
                              "jd_in", "rd_in", "jd_out", "rd_out")],
        ("out", c_vp * JMAXOUT), ("onull", c_vp * JMAXOUT),
        *[(n, c_vp) for n in ("ovalid", "ots", "ocount", "tsa", "cl", "cr",
                              "idx", "cnt", "off", "misc", "now", "istart",
                              "items", "ibkt")],
    ]


def _tree(ir: list):
    """The postfix program as a tree: ``(instruction, [operand trees])``."""
    leaves = (OP["EV"], OP["BIND"], OP["TS"], OP["CONST"])
    unary = (OP["CAST"], OP["NEG"], OP["NOT"])
    stack = []
    for ins in ir:
        n = 0 if ins[0] in leaves else 1 if ins[0] in unary else \
            3 if ins[0] == OP["SELECT"] else 2
        kids = stack[len(stack) - n:]
        del stack[len(stack) - n:]
        stack.append((ins, kids))
    return stack[-1]


def _side_operand(node):
    """``(side, program)`` when the tree is one attribute of one side under
    integer casts only (BOOL, INT, LONG or a string code), else None."""
    ins, kids = node
    if ins[0] == OP["BIND"] and ins[1] != T_F32:
        return ins[2][0], [ins]
    if ins[0] == OP["CAST"] and T_F32 not in (ins[1], ins[2]):
        got = _side_operand(kids[0])
        return got and (got[0], got[1] + [ins])
    return None


def key_conjunct(cond_ir) -> tuple | None:
    """The first top-level conjunct of the condition that compares a left
    and a right attribute for equality outside floats, as ``(left program,
    right program)`` (each the attribute and its casts to the compared
    type), or None. Every row the condition accepts has equal keys."""
    if cond_ir is None:
        return None
    todo = [_tree(cond_ir)]
    while todo:
        ins, kids = todo.pop(0)
        if ins[0] == OP["AND"]:
            todo[:0] = kids
            continue
        if ins[0] != OP["EQ"] or ins[2] == T_F32:
            continue
        ops = [_side_operand(k) for k in kids]
        if None in ops or {side for side, _ in ops} != {"L", "R"}:
            continue
        prog = dict(ops)
        return prog["L"], prog["R"]
    return None


class JoinPlan:
    """Linked programs, the argument template and the launch wrapper of
    ``csrc/join_step.cu``. ``launches`` counts its kernel launches."""

    launches = 0          # class-wide: every launch of the join kernels

    def __init__(self, cq):
        self.cq = cq
        lkeys, rkeys = cq._ring_keys("L"), cq._ring_keys("R")
        self.vars = [("L", skey, mk, t) for (skey, mk, t) in lkeys] + \
            [("R", skey, mk, t) for (skey, mk, t) in rkeys]
        B, W, J = cq.B, cq.W, cq.J
        limits = [(len(lkeys), JMAXSIDE, "left columns"),
                  (len(rkeys), JMAXSIDE, "right columns"),
                  (len(cq.out_specs), JMAXOUT, "outputs")]
        for n, cap, what in limits:
            if n > cap:
                raise DeviceCompileError(f"join kernel: {n} {what} (limit {cap})")
        if min(B, W, J) < 1:
            raise DeviceCompileError(
                f"join kernel: capacities B={B}, W={W}, J={J} must be >= 1")
        if B * (W + B + 1) >= 2 ** 31 or J >= 2 ** 31:
            raise DeviceCompileError(
                f"join kernel: B * (W + B + 1) = {B * (W + B + 1)} and J = {J} "
                f"must stay below 2**31 (int32 row positions, as the "
                f"reference's flat grid index)")
        for side, skey, _, _ in self.vars:
            if skey in ("lr_ts", "rr_ts"):
                raise DeviceCompileError(
                    f"join kernel: a {'left' if side == 'L' else 'right'} "
                    f"attribute 'ts' would share the state leaf {skey!r} "
                    f"with the ring's timestamps")
        if cq.cond_ir is not None and cq.cond_type != DataType.BOOL:
            raise DeviceCompileError(
                f"join kernel: the condition is {cq.cond_type.name}, not BOOL")

        slot = {f"{side}_{skey.split('_', 1)[1]}": v
                for v, (side, skey, _, _) in enumerate(self.vars)}

        def operand(op, key):
            if op == OP["TS"]:
                return OP["EV"], 0               # the probe's timestamp
            return OP["BIND"], slot[key]

        a = JArgs()
        self.args = a
        code: list[np.ndarray] = []

        def add(ir, ty):
            try:
                prog = link_ir(cast_to(ir, ty), operand)
            except DeviceCompileError as e:
                raise DeviceCompileError(f"join kernel: {e}") from None
            off = sum(len(c) for c in code)
            code.append(prog)
            return _Prog(off, len(prog))

        a.B, a.W, a.J = B, W, J
        a.lkind, a.rkind = K_KIND[cq.lkind], K_KIND[cq.rkind]
        a.lparam, a.rparam = cq.lparam, cq.rparam
        a.has_within = int(cq.within_ms is not None)
        a.within = cq.within_ms or 0
        trig, jt = cq.trigger.name, cq.join_type.name
        a.emit_left = int(trig in ("ALL", "LEFT"))
        a.emit_right = int(trig in ("ALL", "RIGHT"))
        a.un_left = int(jt in ("LEFT_OUTER_JOIN", "FULL_OUTER_JOIN"))
        a.un_right = int(jt in ("RIGHT_OUTER_JOIN", "FULL_OUTER_JOIN"))
        a.nvar, a.nout = len(self.vars), len(cq.out_specs)
        for v, (side, _, _, t) in enumerate(self.vars):
            a.var_side[v] = 0 if side == "L" else 1
            a.var_ty[v] = TY_OF[TORCH[t]]
        if cq.cond_ir is not None:
            a.has_cond = 1
            a.cond = add(cq.cond_ir, TY_OF[torch.bool])
        keys = key_conjunct(cq.cond_ir)
        self.indexed = keys is not None
        if keys is not None:
            a.indexed = 1
            for side, prog in enumerate(keys):
                a.keyp[side] = add(prog, prog[-1][1])
        for o, spec in enumerate(cq.out_specs):
            a.out_ty[o] = TY_OF[TORCH[spec.dtype]]
            a.out_null[o] = ("L" in spec.sides) | (("R" in spec.sides) << 1)
            a.outp[o] = add(spec.ir, a.out_ty[o])
        self.code_host = np.concatenate(code) if code else \
            np.zeros((1, 4), np.int32)
        self._dev = {}      # device → (argument template, code, scratch)
        self._proto = None  # the state's leaves (meta tensors)
        self._lib_checked = False

    # -- kernel side ---------------------------------------------------------
    def _lib(self):
        from ._build import load
        lib = load("join_step")
        if not self._lib_checked:
            lib.join_step.argtypes = [c_vp, c_vp, c_vp]
            lib.join_step.restype = c_int
            lib.join_step_args_size.restype = c_int
            if lib.join_step_args_size() != ctypes.sizeof(JArgs):
                raise RuntimeError(
                    f"JArgs layout differs between join_step.cu "
                    f"({lib.join_step_args_size()} B) and the ctypes mirror "
                    f"({ctypes.sizeof(JArgs)} B)")
            self._lib_checked = True
        return lib

    def _check(self, state, cols, tag, ts, ts_base):
        cq, dev = self.cq, ts.device

        def need(t, name, dtype, shape):
            if not isinstance(t, torch.Tensor) or t.device != dev:
                raise ValueError(f"{name} must be a tensor on {dev}")
            if t.dtype != dtype or tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

        need(tag, "tag", torch.int8, (cq.B,))
        need(ts, "ts", torch.int32, (cq.B,))
        need(ts_base, "ts_base", torch.int64, ())
        for _, _, mk, t in self.vars:
            if mk not in cols:
                raise ValueError(f"missing column '{mk}'")
            need(cols[mk], f"cols[{mk!r}]", TORCH[t], (cq.B,))
        if self._proto is None:
            self._proto = cq.init_state(device="meta")
        proto = self._proto
        if set(state) != set(proto):
            raise ValueError(f"state leaves differ: "
                             f"{sorted(set(state) ^ set(proto))}")
        for k, p in proto.items():
            need(state[k], f"state[{k!r}]", p.dtype, p.shape)

    def step_cuda(self, state, cols, tag, ts, ts_base, nvalid: int):
        """Runs one step on the card (launches on the current stream)."""
        if ts.device.type != "cuda":
            raise ValueError("step_cuda takes CUDA tensors")
        self._check(state, cols, tag, ts, ts_base)
        return self.launch(self._lib(), state, cols, tag, ts, ts_base, nvalid,
                           torch.cuda.current_stream(ts.device).cuda_stream)

    def launch(self, lib, state, cols, tag, ts, ts_base, nvalid, stream):
        """Calls the library's entry point over these tensors (checked by
        ``step_cuda``) and counts the launches it made."""
        cq, dev = self.cq, ts.device
        if not 0 <= nvalid <= cq.B:
            raise ValueError(f"nvalid {nvalid} outside [0, {cq.B}]")
        a = JArgs.from_buffer_copy(self._on(dev))
        keep = []                                      # alive until launched

        def ptr(t):
            keep.append(t)
            return t.data_ptr()

        a.nvalid = nvalid
        a.tag, a.ts, a.ts_base = ptr(tag), ptr(ts), ptr(ts_base)
        new = dict(state)

        def fresh(leaf):
            new[leaf] = torch.empty_like(state[leaf])
            return ptr(state[leaf]), ptr(new[leaf])

        for v, (_, skey, mk, _) in enumerate(self.vars):
            a.col[v] = ptr(cols[mk])
            a.ring_in[v], a.ring_out[v] = fresh(skey)
        a.lts_in, a.lts_out = fresh("lr_ts")
        a.rts_in, a.rts_out = fresh("rr_ts")
        a.jd_in, a.jd_out = fresh("join_drops")
        a.rd_in, a.rd_out = fresh("ring_drops")

        J = cq.J
        outs, nulls = {}, {}
        for o, spec in enumerate(cq.out_specs):
            outs[spec.name] = torch.empty(J, dtype=TORCH[spec.dtype], device=dev)
            nulls[spec.name] = torch.empty(J, dtype=torch.bool, device=dev)
            a.out[o], a.onull[o] = ptr(outs[spec.name]), ptr(nulls[spec.name])
        ovalid = torch.empty(J, dtype=torch.bool, device=dev)
        ots = torch.empty(J, dtype=torch.int64, device=dev)
        count = torch.empty((), dtype=torch.int64, device=dev)
        a.ovalid, a.ots, a.ocount = ptr(ovalid), ptr(ots), ptr(count)
        n = c_int(0)
        rc = lib.join_step(ctypes.addressof(a), stream, ctypes.addressof(n))
        type(self).launches += n.value
        if rc != 0:
            raise RuntimeError(f"join_step launch failed: CUDA error {rc}")
        return new, {"out": outs, "null": nulls, "valid": ovalid, "ts": ots,
                     "count": count}

    def _on(self, dev) -> JArgs:
        """The argument template on ``dev``: the linked code and the scratch
        buffers, allocated once per device and reused by every step (the
        launches of consecutive steps are ordered on the stream)."""
        got = self._dev.get(dev)
        if got is None:
            B = self.cq.B
            code = torch.from_numpy(self.code_host).to(dev)
            i32 = dict(dtype=torch.int32, device=dev)
            scratch = {"tsa": torch.empty(B, dtype=torch.int64, device=dev),
                       "cl": torch.empty(B, **i32), "cr": torch.empty(B, **i32),
                       "idx": torch.empty(2 * B, **i32),
                       "cnt": torch.empty(B, **i32), "off": torch.empty(B, **i32),
                       "misc": torch.empty(8, **i32),
                       "now": torch.empty(1, dtype=torch.int64, device=dev)}
            if self.indexed:
                W = self.cq.W
                scratch.update(istart=torch.empty(4 * (NB + 1), **i32),
                               items=torch.empty(2 * (W + B), **i32),
                               ibkt=torch.empty(2 * (W + B), **i32))
            a = JArgs.from_buffer_copy(self.args)
            a.code = code.data_ptr()
            for name, t in scratch.items():
                setattr(a, name, t.data_ptr())
            got = self._dev[dev] = (a, code, scratch)
        return got[0]
