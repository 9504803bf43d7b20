"""RuntimeContext — what every DASE component receives (the reference's
SparkContext; incubator_predictionio_tpu/parallel/context.py carries a JAX
mesh). Here it carries the one device the engine runs on, a seed, and the
walls of the training run's phases. There is no mesh yet: multi-device
comes later.
"""

from __future__ import annotations

from typing import Dict

import torch

from incubator_predictionio_tpu_torch.runtime import default_device


class RuntimeContext:
    def __init__(self, device=None, seed: int = 0):
        #: CUDA unless the caller asks for another device (runtime.py)
        self.device: torch.device = default_device(device)
        self.seed = seed
        #: seconds per phase of the last ``Engine.train`` ("read",
        #: "prepare", "train.algo<i>", and what the algorithms add)
        self.timings: Dict[str, float] = {}

    def __repr__(self) -> str:
        return f"RuntimeContext(device={self.device}, seed={self.seed})"
