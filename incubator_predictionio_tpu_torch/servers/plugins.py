"""Server plugin SPI.

The port's own copy of incubator_predictionio_tpu/servers/plugins.py,
its imports pointed at this package.

Parity: EventServerPlugin (data/.../api/EventServerPlugin.scala:21-33 —
``inputBlockers`` veto events synchronously, ``inputSniffers`` observe
asynchronously) and EngineServerPlugin (core/.../workflow/
EngineServerPlugin.scala:24-40 — ``outputBlockers`` rewrite/veto
predictions, ``outputSniffers`` observe). The reference loads plugins via
JVM ServiceLoader; here registration is explicit (or importable via the
``PIO_PLUGINS`` env var: comma-separated ``module:attr`` entries).
"""

from __future__ import annotations

import dataclasses
import importlib
import logging
import os
from typing import Any, Dict, List, Optional

from incubator_predictionio_tpu_torch.data.event import Event

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class EventInfo:
    """EventServerPlugin.scala EventInfo."""

    app_id: int
    channel_id: Optional[int]
    event: Event


class EventServerPlugin:
    """Subclass and set ``input_blocker=True`` to veto (raise) or
    ``input_sniffer=True`` to observe."""

    input_blocker = False
    input_sniffer = False

    def process(self, event_info: EventInfo, context: "PluginContext") -> None:
        raise NotImplementedError

    def handle_rest(self, path: str, params: Dict[str, Any]) -> Any:
        """GET /plugins/... passthrough (EventServer.scala:462-520)."""
        return {"message": "plugin has no REST handler"}


class EngineServerPlugin:
    output_blocker = False
    output_sniffer = False

    def process(self, engine_variant: str, query: Any, prediction: Any,
                context: "PluginContext") -> Any:
        """Blockers return the (possibly rewritten) prediction."""
        raise NotImplementedError

    def handle_rest(self, path: str, params: Dict[str, Any]) -> Any:
        return {"message": "plugin has no REST handler"}


class PluginContext:
    """EventServerPluginContext / EngineServerPluginContext."""

    def __init__(self, plugins: Optional[List[Any]] = None,
                 params: Optional[Dict[str, Any]] = None):
        self.plugins: List[Any] = list(plugins or [])
        self.params: Dict[str, Any] = dict(params or {})
        self.plugins.extend(_load_env_plugins())

    # -- event-server side --------------------------------------------------
    @property
    def input_blockers(self) -> Dict[str, EventServerPlugin]:
        return {
            type(p).__name__: p for p in self.plugins
            if getattr(p, "input_blocker", False)
        }

    @property
    def input_sniffers(self) -> Dict[str, EventServerPlugin]:
        return {
            type(p).__name__: p for p in self.plugins
            if getattr(p, "input_sniffer", False)
        }

    # -- engine-server side -------------------------------------------------
    @property
    def output_blockers(self) -> Dict[str, EngineServerPlugin]:
        return {
            type(p).__name__: p for p in self.plugins
            if getattr(p, "output_blocker", False)
        }

    @property
    def output_sniffers(self) -> Dict[str, EngineServerPlugin]:
        return {
            type(p).__name__: p for p in self.plugins
            if getattr(p, "output_sniffer", False)
        }

    def plugin(self, name: str) -> Optional[Any]:
        for p in self.plugins:
            if type(p).__name__ == name:
                return p
        return None


def _load_env_plugins() -> List[Any]:
    """PIO_PLUGINS=pkg.mod:PluginClass,other.mod:Other — the explicit
    replacement for ServiceLoader classpath scanning."""
    spec = os.environ.get("PIO_PLUGINS", "")
    out: List[Any] = []
    for entry in filter(None, (s.strip() for s in spec.split(","))):
        try:
            module_name, _, attr = entry.partition(":")
            cls = getattr(importlib.import_module(module_name), attr)
            out.append(cls())
        except Exception:
            logger.exception("failed to load plugin %r", entry)
    return out
