"""Config system: ConfigManager SPI + in-memory and YAML implementations.

Reference: ``core/util/config/`` — ``ConfigManager.java`` (SPI),
``ConfigReader.java`` (per-extension scoped reads, injected into every
extension ``init``), ``InMemoryConfigManager.java``, ``YAMLConfigManager.java:40``
(+ ``model/RootConfiguration``). YAML shape (both accepted):

    properties:
      partitionById: "true"
    extensions:
      - extension:
          namespace: source
          name: http
          properties:
            default.port: "9763"

or a flat map ``source.http.default.port: "9763"`` under ``properties``.
"""

from __future__ import annotations

from typing import Any, Optional


def _scalar_str(v: Any) -> str:
    """YAML-style strings: bare ``true``/``false``/``null``, not Python reprs —
    every manager yields the same value types for the same config."""
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    return str(v)


class ConfigReader:
    """Scoped view of config for one extension: keys under ``<ns>.<name>.``.

    Handed to sources/sinks/stores/mappers as ``self.config_reader`` before
    ``init`` runs (reference injects it as an ``init`` argument).
    """

    def __init__(self, configs: Optional[dict] = None):
        self._configs = dict(configs or {})

    def read_config(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._configs.get(key, default)

    def get_all_configs(self) -> dict:
        return dict(self._configs)

    # reference-style alias
    readConfig = read_config


class ConfigManager:
    """SPI (reference ``ConfigManager.java``)."""

    def generate_config_reader(self, namespace: str, name: str) -> ConfigReader:
        return ConfigReader({})

    def extract_system_configs(self, name: str) -> dict:
        return {}

    def extract_property(self, name: str) -> Optional[str]:
        return None


class InMemoryConfigManager(ConfigManager):
    """Reference ``InMemoryConfigManager.java`` — maps handed in directly.

    ``configs`` keys are fully qualified ``<namespace>.<name>.<key>``;
    ``system_configs`` maps a system name to its properties dict.
    """

    def __init__(self, configs: Optional[dict] = None,
                 system_configs: Optional[dict] = None):
        self.configs = {str(k): _scalar_str(v) for k, v in (configs or {}).items()}
        self.system_configs = dict(system_configs or {})

    def generate_config_reader(self, namespace: str, name: str) -> ConfigReader:
        prefix = f"{namespace}.{name}."
        return ConfigReader({
            k[len(prefix):]: v for k, v in self.configs.items()
            if k.startswith(prefix)
        })

    def extract_system_configs(self, name: str) -> dict:
        return dict(self.system_configs.get(name, {}))

    def extract_property(self, name: str) -> Optional[str]:
        return self.configs.get(name)


class YAMLConfigManager(InMemoryConfigManager):
    """Reference ``YAMLConfigManager.java:40`` — YAML text/file → config maps."""

    def __init__(self, yaml_content: Optional[str] = None,
                 path: Optional[str] = None):
        if (yaml_content is None) == (path is None):
            raise ValueError("provide exactly one of yaml_content / path")
        try:
            import yaml
        except ImportError as e:                      # pragma: no cover
            raise RuntimeError("pyyaml is required for YAMLConfigManager") from e
        if path is not None:
            with open(path, "r", encoding="utf-8") as f:
                root = yaml.safe_load(f) or {}
        else:
            root = yaml.safe_load(yaml_content) or {}
        if not isinstance(root, dict):
            raise ValueError("root of config YAML must be a mapping")

        configs: dict[str, Any] = {}
        for k, v in (root.get("properties") or {}).items():
            configs[str(k)] = _scalar_str(v)
        for item in root.get("extensions") or []:
            ext = item.get("extension") if isinstance(item, dict) else None
            if not isinstance(ext, dict):
                raise ValueError(f"malformed extensions entry: {item!r}")
            ns, name = ext.get("namespace", ""), ext.get("name", "")
            for pk, pv in (ext.get("properties") or {}).items():
                configs[f"{ns}.{name}.{pk}" if ns else f"{name}.{pk}"] = \
                    _scalar_str(pv)
        system_configs = {
            str(k): dict(v) for k, v in (root.get("refs") or {}).items()
            if isinstance(v, dict)
        }
        super().__init__(configs, system_configs)
