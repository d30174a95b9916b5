"""The port's engine and its host-side layers.

The engine has two tiers. ``SiddhiManager`` (``manager.py``) builds a
``SiddhiAppRuntime`` (``app_runtime.py``) whose ``@device`` queries run
through ``DeviceQueryBridge`` (``device_bridge.py``) on the hand-written
kernels, and whose other queries, partitions, named windows and triggers
run on the host interpreter: the query planner (``query_runtime.py``) with
its processors, windows, selectors, joins, pattern runtime and output
callbacks (``processors``, ``windows``, ``expression_window``,
``selector``, ``join``, ``pattern``, ``output``), ``partition.py``,
``named_window.py``, ``trigger.py`` (on ``cron.py``) and the debugger
(``debugger.py``). These, and the junctions, input handlers and callbacks
(``stream.py``, ``async_junction.py``), context and clock (``context.py``,
``scheduler.py``), snapshots (``snapshot.py``), statistics
(``metrics.py``), rate limiters (``ratelimit.py``), tables and on-demand
queries (``table.py``, ``on_demand.py``), configuration (``config.py``),
the incremental-aggregation runtime (``aggregation.AggregationRuntime``)
and the host closure they stand on (``aggregators``, ``event``,
``errors``, ``executor``, ``extension``) are copies of the JAX package's
modules. Also here: ``columns``, the columnar edge's chunks and CSV
parser, and the IO tier (``io.py``: the in-memory broker, sources, sinks,
their mappers and the handler interception SPIs), also a copy.
"""

from .app_runtime import SiddhiAppRuntime
from .config import ConfigManager, ConfigReader, InMemoryConfigManager, YAMLConfigManager
from .errors import ErrorEntry, ErrorStore, FileErrorStore
from .event import Event, EventType, StateEvent, StreamEvent
from .extension import ScalarFunctionExtension, StreamFunctionExtension, extension
from .io import (
    InMemoryBroker,
    SinkHandler,
    SinkHandlerManager,
    SourceHandler,
    SourceHandlerManager,
)
from .manager import SiddhiManager
from .metrics import Level
from .snapshot import (
    FileSystemPersistenceStore,
    IncrementalFileSystemPersistenceStore,
    IncrementalPersistenceStore,
    InMemoryPersistenceStore,
    PersistenceStore,
    SnapshotableEventBuffer,
)
from .stream import InputHandler, QueryCallback, StreamCallback
from .table import RecordTableHandler, RecordTableHandlerManager
