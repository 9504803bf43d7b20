"""EngineParams and WorkflowParams (port of incubator_predictionio_tpu/core/
params.py; reference controller/EngineParams.scala and
workflow/WorkflowParams.scala). EngineParams holds the named
(component-name, params) pair of every DASE slot: names select entries of
the Engine's class maps, and ``""`` selects the single registered
component. ``to_jsonable`` is the form ``best.json`` and the stored
evaluation results carry; ``EngineParamsGenerator`` holds the candidates
``pio eval`` scores.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from incubator_predictionio_tpu_torch.core.base import EmptyParams, Params
from incubator_predictionio_tpu_torch.utils import json_codec


@dataclasses.dataclass
class EngineParams:
    data_source_params: Tuple[str, Params] = ("", EmptyParams())
    preparator_params: Tuple[str, Params] = ("", EmptyParams())
    algorithm_params_list: List[Tuple[str, Params]] = dataclasses.field(
        default_factory=list
    )
    serving_params: Tuple[str, Params] = ("", EmptyParams())

    def to_jsonable(self) -> Dict[str, Any]:
        """The camelCase form of JAX params.py:48-58 (``best.json``)."""
        def comp(pair: Tuple[str, Params]) -> Dict[str, Any]:
            return {"name": pair[0],
                    "params": json_codec.to_jsonable(pair[1])}

        return {
            "dataSourceParams": comp(self.data_source_params),
            "preparatorParams": comp(self.preparator_params),
            "algorithmParamsList": [comp(ap)
                                    for ap in self.algorithm_params_list],
            "servingParams": comp(self.serving_params),
        }


class EngineParamsGenerator:
    """Holder of candidate EngineParams lists for tuning
    (controller/EngineParamsGenerator.scala). Subclass and set
    ``engine_params_list``."""

    engine_params_list: List[EngineParams] = []


@dataclasses.dataclass
class WorkflowParams:
    """The training run controls ``Engine.train`` and
    ``CoreWorkflow.run_train`` read (workflow/WorkflowParams.scala)."""

    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    #: the run's batch label, stored with its engine instance
    batch: str = ""
    #: stored with the engine instance; "seed" seeds the run's context
    runtime_conf: Dict[str, str] = dataclasses.field(default_factory=dict)
