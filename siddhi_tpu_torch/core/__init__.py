"""The port's engine and its host-side layers.

The engine's device tier: ``SiddhiManager`` (``manager.py``) builds a
``SiddhiAppRuntime`` (``app_runtime.py``) whose ``@device`` queries run
through ``DeviceQueryBridge`` (``device_bridge.py``) on the hand-written
kernels; junctions, input handlers and callbacks (``stream.py``,
``async_junction.py``), context and clock (``context.py``, ``scheduler.py``),
snapshots (``snapshot.py``), statistics (``metrics.py``), rate limiters
(``ratelimit.py``), tables and on-demand queries (``table.py``,
``on_demand.py``) and configuration (``config.py``) are copies of the JAX
package's modules. Also here: the flattening half of ``pattern.py`` the
device compilers share, the incremental-aggregation runtime
(``aggregation.AggregationRuntime``) with the host closure it stands on
(``aggregators``, ``event``, ``errors``, ``executor``, ``extension``), and
``columns``, the columnar edge's chunks and CSV parser.
"""

from .app_runtime import SiddhiAppRuntime
from .config import ConfigManager, ConfigReader, InMemoryConfigManager, YAMLConfigManager
from .errors import ErrorEntry, ErrorStore, FileErrorStore
from .event import Event, EventType, StateEvent, StreamEvent
from .extension import ScalarFunctionExtension, StreamFunctionExtension, extension
from .manager import SiddhiManager
from .metrics import Level
from .snapshot import (
    FileSystemPersistenceStore,
    IncrementalFileSystemPersistenceStore,
    IncrementalPersistenceStore,
    InMemoryPersistenceStore,
    PersistenceStore,
)
from .stream import InputHandler, QueryCallback, StreamCallback
from .table import RecordTableHandler, RecordTableHandlerManager
