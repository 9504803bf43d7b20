"""RuntimeContext — what every DASE component receives (the reference's
SparkContext; incubator_predictionio_tpu/parallel/context.py carries a JAX
mesh). Here it carries the one device the engine runs on and a seed. There is no mesh yet: multi-device comes later.
"""

from __future__ import annotations

import torch

from incubator_predictionio_tpu_torch.runtime import default_device


class RuntimeContext:
    def __init__(self, device=None, seed: int = 0):
        #: CUDA unless the caller asks for another device (runtime.py)
        self.device: torch.device = default_device(device)
        self.seed = seed

    def __repr__(self) -> str:
        return f"RuntimeContext(device={self.device}, seed={self.seed})"
