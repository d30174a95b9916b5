"""Engine / app / query contexts.

Reference: ``core/config/SiddhiContext.java``, ``SiddhiAppContext.java``,
``SiddhiQueryContext.java``. Holds the clock, scheduler, shared services, extension
registry, and the state registry used by snapshotting. The reference's ThreadLocal
partition flow keys become an explicit ``partition_key`` pushed/popped around
partitioned execution (single-threaded deterministic interpreter).

The port's engine context also carries the ``device`` every device runtime of
the engine runs on (``gpu.backend.resolve_device``: the card unless the caller
asks for the CPU), and the engine's multi-tenant fleet (``fleet()``: one
``fleet.FleetManager`` per engine, whose shared device plans are built on
that device).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from .scheduler import Scheduler, SystemTicker, TimestampGenerator


class SiddhiContext:
    """Engine-level shared context (one per SiddhiManager).

    ``device`` goes through ``gpu.backend.resolve_device``: ``None`` is the
    card, and with no card that raises; ``"cpu"`` runs the plain versions."""

    def __init__(self, device=None):
        from ..gpu.backend import resolve_device
        self.device = resolve_device(device)
        self.extensions: dict[str, Any] = {}        # "ns:name" -> class
        self.persistence_store = None
        self.config_manager = None
        self.attributes: dict[str, Any] = {}
        # handler interception SPIs (reference SiddhiContext source/sink/
        # record-table handler manager slots)
        self.source_handler_manager = None
        self.sink_handler_manager = None
        self.record_table_handler_manager = None
        # multi-tenant shared compilation (siddhi_tpu_torch/fleet/): one
        # manager per engine so @app:fleet apps share plans and lane-batch
        # cross-app
        self.fleet_manager = None

    def fleet(self):
        """The engine's FleetManager, created on first use."""
        if self.fleet_manager is None:
            from ..fleet import FleetManager
            self.fleet_manager = FleetManager(device=self.device)
        return self.fleet_manager


class SiddhiAppContext:
    def __init__(self, siddhi_context: SiddhiContext, name: str,
                 playback: bool = False, start_time: int = 0):
        self.siddhi_context = siddhi_context
        self.name = name
        self.playback = playback
        self.timestamp_generator = TimestampGenerator(playback, start_time)
        self.scheduler = Scheduler(self.timestamp_generator)
        self.ticker: Optional[SystemTicker] = None
        self.root_lock = threading.RLock()          # whole-app barrier (snapshot)

        # stateful services (populated by the runtime builder)
        self.tables: dict[str, Any] = {}
        self.named_windows: dict[str, Any] = {}
        self.aggregations: dict[str, Any] = {}
        self.stream_junctions: dict[str, Any] = {}
        self.script_functions: dict[str, Any] = {}

        # snapshotting: element_id -> object with snapshot_state()/restore_state()
        self.state_registry: dict[str, Any] = {}
        self._element_counter = 0

        self.adaptive_cfg: Optional[dict] = None    # @app:adaptive(...) kwargs
        self.exception_listener: Optional[Callable[[Exception], None]] = None
        self.debugger = None
        self.runtime = None                         # back-ref set by SiddhiAppRuntime
        self.statistics_manager = None
        self.tracer = None          # PipelineTracer when @app:trace (hot
        # paths gate on one attribute, like flow/debugger)
        self.flight = None          # FlightRecorder (always set for built
        # apps; None only on bare contexts) — control-plane transition ring

    # -- ids -----------------------------------------------------------------
    def element_id(self, prefix: str) -> str:
        self._element_counter += 1
        return f"{prefix}-{self._element_counter}"

    def register_state(self, element_id: str, holder: Any) -> str:
        self.state_registry[element_id] = holder
        return element_id

    # -- time ----------------------------------------------------------------
    def current_time(self) -> int:
        return self.timestamp_generator.current_time()

    def advance_time(self, ts: int) -> None:
        """Advance the playback clock and fire due timers (watermark semantics)."""
        if self.timestamp_generator.playback:
            self.timestamp_generator.advance(ts)
        self.scheduler.fire_until(self.timestamp_generator.current_time())

    # -- config --------------------------------------------------------------
    def config_reader(self, namespace: str, name: str):
        """Per-extension ConfigReader (reference injects one into every init)."""
        from .config import ConfigReader
        cm = self.siddhi_context.config_manager
        if cm is None:
            return ConfigReader({})
        return cm.generate_config_reader(namespace, name)

    # -- lookups -------------------------------------------------------------
    def get_table(self, table_id: str):
        t = self.tables.get(table_id)
        if t is None:
            raise KeyError(f"no table '{table_id}' defined")
        return t

    def lookup_scalar_function(self, namespace: Optional[str], name: str):
        key = f"{namespace}:{name}" if namespace else name
        if key in self.script_functions:
            return self.script_functions[key]
        cls = self.siddhi_context.extensions.get(key)
        if cls is not None and getattr(cls, "extension_kind", None) == "function":
            return cls()
        return None
