"""SiddhiManager: engine façade.

Port of the JAX package's ``core/manager.py`` (reference
``core/SiddhiManager.java`` — extension registry, persistence store, app
lifecycle, ``createSiddhiAppRuntime`` (parse → build)). ``device`` is where
the engine's device runtimes run: the card unless the caller asks for the
CPU (``gpu.backend.resolve_device``; with no card, ``None`` raises).
"""

from __future__ import annotations

from typing import Optional, Union

from ..compiler import parse as _parse, update_variables
from ..query_api import SiddhiApp
from .app_runtime import SiddhiAppRuntime
from .context import SiddhiContext
from .errors import ErrorStore
from .extension import GLOBAL_EXTENSIONS
from .snapshot import PersistenceStore


class SiddhiManager:
    def __init__(self, device=None):
        self.context = SiddhiContext(device)
        self.context.extensions.update(GLOBAL_EXTENSIONS)
        self.context.error_store = ErrorStore()
        self.runtimes: dict[str, SiddhiAppRuntime] = {}

    @property
    def device(self):
        return self.context.device

    def _parse(self, app: Union[str, SiddhiApp],
               env: Optional[dict] = None) -> SiddhiApp:
        if isinstance(app, str):
            app = _parse(update_variables(
                app, env, self.context.config_manager) if "${" in app else app)
        return app

    def create_siddhi_app_runtime(
            self, app: Union[str, SiddhiApp],
            playback: Optional[bool] = None,
            start_time: int = 0,
            env: Optional[dict] = None) -> SiddhiAppRuntime:
        runtime = SiddhiAppRuntime(self._parse(app, env), self.context,
                                   playback, start_time)
        self.runtimes[runtime.name] = runtime
        return runtime

    # reference-style alias
    createSiddhiAppRuntime = create_siddhi_app_runtime

    def create_sandbox_siddhi_app_runtime(
            self, app: Union[str, SiddhiApp],
            playback: Optional[bool] = None,
            start_time: int = 0) -> SiddhiAppRuntime:
        """Runs the app WITHOUT its external sources/sinks/stores (reference
        ``SiddhiManager.createSandboxSiddhiAppRuntime:105`` — non-inMemory
        @source/@sink annotations and every @store are stripped, so the app
        can be driven by input handlers/callbacks in isolation)."""
        app = self._parse(app)
        for sd in app.stream_definitions.values():
            sd.annotations = [
                a for a in sd.annotations
                if a.name.lower() not in ("source", "sink")
                or (a.get("type") or "").lower() == "inmemory"]
        for td in app.table_definitions.values():
            td.annotations = [a for a in td.annotations
                              if a.name.lower() != "store"]
        return self.create_siddhi_app_runtime(app, playback, start_time)

    createSandboxSiddhiAppRuntime = create_sandbox_siddhi_app_runtime

    def validate_siddhi_app(self, app: Union[str, SiddhiApp]) -> None:
        """Full validation: parse + build the runtime, then discard it
        (reference ``SiddhiManager.validateSiddhiApp:145`` does exactly
        this — creation IS the validator). Raises on any invalid app."""
        runtime = SiddhiAppRuntime(self._parse(app), self.context,
                                   playback=True)
        runtime.shutdown()

    validateSiddhiApp = validate_siddhi_app

    # -- engine-level attribute map (reference get/setAttributes) -----------
    def get_attributes(self) -> dict:
        return self.context.attributes

    def set_attribute(self, key: str, value) -> None:
        self.context.attributes[key] = value

    def get_extensions(self) -> dict:
        return dict(self.context.extensions)

    def remove_extension(self, name: str) -> None:
        self.context.extensions.pop(name, None)

    def set_extension(self, name: str, cls: type) -> None:
        self.context.extensions[name] = cls

    def set_error_store(self, store) -> None:
        """Reference ``SiddhiManager.setErrorStore`` — replayable store for
        events that failed with ``@OnError(action='store')``."""
        self.context.error_store = store

    def replay_errors(self, app_name: str, stream_name: Optional[str] = None,
                      min_id: Optional[int] = None,
                      max_id: Optional[int] = None) -> dict:
        """Re-inject stored failed events for one app through its
        ``InputHandler``s. Returns the replay report."""
        rt = self.runtimes.get(app_name)
        if rt is None:
            raise KeyError(f"no app '{app_name}' running")
        return rt.replay_errors(stream_name, min_id, max_id)

    # -- engine-wide persistence (reference persist()/restoreLastState()) ---
    def persist(self) -> dict:
        """Persist every running app; returns {app name: revision}."""
        return {name: rt.persist() for name, rt in self.runtimes.items()}

    def restore_last_state(self) -> None:
        for rt in self.runtimes.values():
            rt.restore_last_revision()

    restoreLastState = restore_last_state

    def set_config_manager(self, config_manager) -> None:
        """Reference ``SiddhiManager.setConfigManager`` (ConfigManager SPI)."""
        self.context.config_manager = config_manager

    def set_source_handler_manager(self, manager) -> None:
        """Reference ``SiddhiManager.setSourceHandlerManager`` — every source
        wired after this routes mapped rows through a generated
        :class:`~siddhi_tpu_torch.core.io.SourceHandler`."""
        self.context.source_handler_manager = manager

    def set_sink_handler_manager(self, manager) -> None:
        """Reference ``SiddhiManager.setSinkHandlerManager``."""
        self.context.sink_handler_manager = manager

    def set_record_table_handler_manager(self, manager) -> None:
        """Reference ``SiddhiManager.setRecordTableHandlerManager`` — every
        record-store table built after this routes its ops through a
        generated :class:`~siddhi_tpu_torch.core.table.RecordTableHandler`."""
        self.context.record_table_handler_manager = manager

    def set_persistence_store(self, store: PersistenceStore) -> None:
        self.context.persistence_store = store
        for rt in self.runtimes.values():
            rt.persistence.store = store

    def get_siddhi_app_runtime(self, name: str) -> Optional[SiddhiAppRuntime]:
        return self.runtimes.get(name)

    def shutdown(self) -> None:
        for rt in self.runtimes.values():
            rt.shutdown()
        self.runtimes.clear()
