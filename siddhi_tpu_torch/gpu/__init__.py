"""Device path on CUDA: compile plans, runtimes and the kernel wrappers.

Importing this package imports ``torch`` only; CUDA kernels build at first
CUDA use (``_build.py``).
"""

from .aggregation_compile import CompiledAggregation
from .join_compile import CompiledJoinQuery, DeviceJoinRuntime
from .query_compile import CompiledStreamQuery
from .runtime import DeviceStreamRuntime

__all__ = ["CompiledAggregation", "CompiledJoinQuery", "CompiledStreamQuery",
           "DeviceJoinRuntime", "DeviceStreamRuntime"]
