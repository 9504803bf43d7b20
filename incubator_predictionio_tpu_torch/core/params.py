"""EngineParams: the named (component-name, params) pair of every serving
slot (port of incubator_predictionio_tpu/core/params.py; reference
controller/EngineParams.scala). Names select entries of the Engine's class
maps; ``""`` selects the single registered component.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from incubator_predictionio_tpu_torch.core.base import EmptyParams, Params


@dataclasses.dataclass
class EngineParams:
    algorithm_params_list: List[Tuple[str, Params]] = dataclasses.field(
        default_factory=list
    )
    serving_params: Tuple[str, Params] = ("", EmptyParams())
