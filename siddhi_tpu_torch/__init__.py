"""siddhi_tpu_torch — the PyTorch/CUDA port of siddhi_tpu for NVIDIA Hopper.

The JAX package ``siddhi_tpu`` is the reference; this package reproduces its
device path on one H100: the same SiddhiQL apps, the same wire batches, the
same state leaves and the same output rows in the same order. Layout mirrors
the reference so every module has a findable counterpart:
``siddhi_tpu/tpu/<stem>.py`` → ``siddhi_tpu_torch/gpu/<stem>.py``; the
JAX-free layers it needs (``query_api``, ``compiler``, the engine's host
modules under ``core/``) are kept as copies under the same names.

This package imports ``torch`` and never ``jax`` or ``siddhi_tpu``. CUDA
kernels (``csrc/``) are compiled with ``nvcc`` at first CUDA use, and the
native CSV ingress (``native/``) with ``g++`` at first use, never on
import. ``entry.py`` holds the entry points ``entry()`` and
``dryrun_multichip(n)`` (the partitioned lanes split over ``n`` devices).
``gpu/dcn.py`` and ``resilience/dcn_guard.py`` are the DCN shard tier:
lane groups over hosts, each shard stepping on the card.

The engine: ``SiddhiManager(device=None)`` → ``create_siddhi_app_runtime``
→ ``input_handler(...).send(...)`` / ``StreamCallback`` (``core/``), on two
tiers: a ``@device`` query the device compilers take steps on the kernels;
every other query, partitions, named windows and triggers run on the host
interpreter, as in the reference. ``device=None`` is the card;
``device="cpu"`` runs the kernels' plain versions. Sources and sinks
(``@source``/``@sink``, ``core/io.py``, behind the sink pipeline of
``resilience/``) feed and drain the engine, and ``flow/`` holds the
write-ahead log, credit backpressure, crash recovery (``recover``) and the
adaptive micro-batch controller.
"""

__version__ = "0.1.0"

from . import query_api
from .compiler import SiddhiCompiler, parse, parse_on_demand_query, parse_query
from .core import (
    ErrorEntry,
    ErrorStore,
    Event,
    FileErrorStore,
    FileSystemPersistenceStore,
    IncrementalFileSystemPersistenceStore,
    IncrementalPersistenceStore,
    InMemoryBroker,
    InMemoryConfigManager,
    InMemoryPersistenceStore,
    InputHandler,
    Level,
    QueryCallback,
    RecordTableHandler,
    RecordTableHandlerManager,
    SiddhiAppRuntime,
    SiddhiManager,
    SinkHandler,
    SinkHandlerManager,
    SourceHandler,
    SourceHandlerManager,
    StreamCallback,
    YAMLConfigManager,
    extension,
)
from .flow import recover

__all__ = [
    "ErrorEntry", "ErrorStore", "Event", "FileErrorStore",
    "FileSystemPersistenceStore", "IncrementalFileSystemPersistenceStore",
    "IncrementalPersistenceStore", "InMemoryBroker", "InMemoryConfigManager",
    "InMemoryPersistenceStore", "InputHandler", "Level", "QueryCallback",
    "RecordTableHandler", "RecordTableHandlerManager", "SiddhiAppRuntime",
    "SiddhiManager", "SinkHandler", "SinkHandlerManager", "SourceHandler",
    "SourceHandlerManager", "StreamCallback", "YAMLConfigManager",
    "extension", "recover", "SiddhiCompiler", "parse",
    "parse_on_demand_query", "parse_query", "query_api",
]
