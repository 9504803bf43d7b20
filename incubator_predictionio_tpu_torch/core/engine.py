"""Engine — the serving half of the DASE composition (port of
incubator_predictionio_tpu/core/engine.py; reference
controller/Engine.scala). The Engine holds class maps for the algorithm and
serving slots and instantiates components through :func:`doer`; the data
source and preparator slots come with training.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from incubator_predictionio_tpu_torch.core.base import (
    Algorithm,
    EmptyParams,
    Serving,
    doer,
)
from incubator_predictionio_tpu_torch.core.params import EngineParams


def _as_class_map(spec: Any) -> Dict[str, type]:
    """Accept a single class or a name→class dict."""
    if isinstance(spec, dict):
        return dict(spec)
    return {"": spec}


def _select(class_map: Dict[str, type], name: str, slot: str) -> type:
    if name in class_map:
        return class_map[name]
    if name == "" and len(class_map) == 1:
        return next(iter(class_map.values()))
    raise ValueError(
        f"{slot} has no component named {name!r} (registered: {sorted(class_map)})"
    )


class Engine:
    """The DASE engine's serving slots (controller/Engine.scala:83)."""

    def __init__(self, algorithm_class_map: Any, serving_class_map: Any):
        self.algorithm_class_map = _as_class_map(algorithm_class_map)
        self.serving_class_map = _as_class_map(serving_class_map)

    def components(self, engine_params: EngineParams
                   ) -> Tuple[List[Algorithm], Serving]:
        """Instantiate the algorithms and the serving component once."""
        algorithms = [
            doer(_select(self.algorithm_class_map, name, "algorithm"), params)
            for name, params in (engine_params.algorithm_params_list
                                 or [("", EmptyParams())])
        ]
        serv_name, serv_params = engine_params.serving_params
        serving = doer(
            _select(self.serving_class_map, serv_name, "serving"), serv_params)
        return algorithms, serving


class EngineFactory:
    """controller/EngineFactory.scala — subclass and implement ``apply``."""

    def apply(self) -> Engine:
        raise NotImplementedError
