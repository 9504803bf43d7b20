"""EngineParams and WorkflowParams (port of incubator_predictionio_tpu/core/
params.py; reference controller/EngineParams.scala and
workflow/WorkflowParams.scala). EngineParams holds the named
(component-name, params) pair of every DASE slot: names select entries of
the Engine's class maps, and ``""`` selects the single registered
component.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from incubator_predictionio_tpu_torch.core.base import EmptyParams, Params


@dataclasses.dataclass
class EngineParams:
    data_source_params: Tuple[str, Params] = ("", EmptyParams())
    preparator_params: Tuple[str, Params] = ("", EmptyParams())
    algorithm_params_list: List[Tuple[str, Params]] = dataclasses.field(
        default_factory=list
    )
    serving_params: Tuple[str, Params] = ("", EmptyParams())


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
