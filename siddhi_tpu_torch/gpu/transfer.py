"""A step's host↔device copies, one each way.

A step moves its batch columns to the device and its output columns back.
Copied one tensor at a time, each copy of pageable memory is a synchronous
call that releases the interpreter lock, and in an engine whose producer
thread packs the next batches meanwhile, each such release costs the device
worker up to a switch interval (``sys.getswitchinterval()``, 5 ms) to win the
lock back. So the arrays of one direction travel packed in one byte buffer:

- ``to_device``: the arrays are written into one host buffer (pinned on the
  card) and copied with one asynchronous call; the returned tensors are
  views of the device buffer.
- ``to_host``: the tensors are concatenated as bytes on their device and
  copied back with one call (the step's fence); the returned arrays are
  views of the host buffer.

On the way to the device each piece starts at a multiple of ``ALIGN``
bytes, so every view is aligned for its dtype and for the kernels' vector
loads.
"""

from __future__ import annotations

import numpy as np
import torch

ALIGN = 16

_TORCH_OF = {np.dtype(k): v for k, v in (
    (np.bool_, torch.bool), (np.uint8, torch.uint8), (np.int8, torch.int8),
    (np.int16, torch.int16), (np.int32, torch.int32),
    (np.int64, torch.int64), (np.float32, torch.float32),
    (np.float64, torch.float64))}
_NP_OF = {v: k for k, v in _TORCH_OF.items()}


def _offsets(nbytes: list[int]) -> tuple[list[int], int]:
    offs, end = [], 0
    for n in nbytes:
        offs.append(end)
        end += -(-n // ALIGN) * ALIGN
    return offs, max(end, ALIGN)


def to_device(arrays: list[np.ndarray], dev: torch.device) -> list:
    """``arrays`` as tensors on ``dev`` (same dtypes and shapes), through one
    host buffer and one copy; on the card the copy is asynchronous on the
    current stream, from pinned memory that the allocator keeps until the
    copy has run."""
    arrays = [np.asarray(a) for a in arrays]
    offs, total = _offsets([a.nbytes for a in arrays])
    host = torch.empty(total, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    buf = host.numpy()
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes].view(a.dtype).reshape(a.shape)[...] = a
    on = host.to(dev, non_blocking=True)
    return [_as(on[o:o + a.nbytes], _TORCH_OF[a.dtype], a.shape)
            for a, o in zip(arrays, offs)]


def _as(raw: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """A byte slice as ``dtype`` and ``shape``: each view op is a call that
    releases the interpreter lock, so the ones that change nothing are
    skipped (a step's columns are 1-D)."""
    t = raw if dtype == torch.uint8 else raw.view(dtype)
    return t if len(shape) == 1 else t.view(shape)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor, skipping the calls that change
    nothing (see ``_as``)."""
    if t.dim() != 1 or not t.is_contiguous():
        t = t.contiguous().reshape(-1)
    return t if t.dtype == torch.uint8 else t.view(torch.uint8)


def to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """``tensors`` (on one device) as numpy arrays, through one byte
    concatenation on their device and one copy to the host. The pieces go
    widest dtype first, so each starts aligned for its own dtype."""
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    flat = {i: _bytes(tensors[i]) for i in order}
    host = torch.cat([flat[i] for i in order]).cpu().numpy()
    out, o = [None] * len(tensors), 0
    for i in order:
        t, n = tensors[i], flat[i].numel()
        out[i] = host[o:o + n].view(_NP_OF[t.dtype]).reshape(t.shape)
        o += n
    return out
