"""Dtype policy lookup, device selection and shared kernel helpers.

The reference's ``tpu/backend.py`` made the array namespace a parameter
(jax.numpy on device, numpy on the columnar host tier). The port has one
namespace, torch, so what remains is the dtype policy lookup the expression
compiler uses (the device's, or with ``host`` the columnar host tier's
full-width one: that tier runs the same closures on CPU tensors), the rule
every entry point follows for its ``device`` argument, and the helpers the
query compiler shares (``avalanche``, ``reduce_identity``).
"""

from __future__ import annotations

import torch

from ..query_api.definition import DataType
from .dtypes import TORCH, TORCH_HOST


def policy_dtype(t: DataType, host: bool = False) -> torch.dtype:
    """Dtype for a declared attribute type: the device's (``dtypes.TORCH``)
    or, with ``host``, the columnar host tier's (``dtypes.TORCH_HOST``)."""
    return TORCH_HOST[t] if host else TORCH[t]


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.

    ``None`` means ``cuda``; with no card present that raises instead of
    falling back quietly. Pass ``device="cpu"`` for the plain version."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain version")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


# splitmix64 finalizer constants as two's-complement int64
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def avalanche(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over int64, bit for bit the reference's uint64
    version: spreads packed multi-key ids over buckets. Multiplication
    wraps in two's complement, so int64 gives uint64's low bits."""
    x = x.to(torch.int64)
    x = (x ^ _lshr(x, 30)) * _MIX1
    x = (x ^ _lshr(x, 27)) * _MIX2
    x = x ^ _lshr(x, 31)
    return x & 0x7FFFFFFFFFFFFFFF


def reduce_identity(dtype: torch.dtype, is_min: bool) -> float | int:
    """Reduction identity for a min/max lane of ``dtype``: +inf/-inf for
    floats, the integer range's max/min otherwise."""
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min
