"""Weights carried across: an ``ALSModel`` of this package from the numpy
fields of the JAX package's ``ALSModel``
(incubator_predictionio_tpu/models/recommendation/engine.py:347), so both
packages serve from the same factors.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.models.recommendation.engine import (
    ALSModel,
)
from incubator_predictionio_tpu_torch.runtime import default_device


def als_model_from_numpy(
    user_factors: np.ndarray,            # [U, K]
    item_factors: np.ndarray,            # [I, K]
    user_ids: Sequence[str],             # entity id of each factor row
    item_ids: Sequence[str],
    item_years: Optional[Mapping[str, int]] = None,
    item_categories: Optional[Mapping[str, Tuple[str, ...]]] = None,
    user_seen: Optional[Mapping[int, np.ndarray]] = None,
    device=None,
) -> ALSModel:
    """The factors as f32 tensors on ``device`` (CUDA by default), the
    ids as BiMaps in row order, the seen lists as sorted int32 arrays."""
    dev = default_device(device)
    uf = np.ascontiguousarray(user_factors, np.float32)
    vf = np.ascontiguousarray(item_factors, np.float32)
    if uf.ndim != 2 or vf.ndim != 2 or uf.shape[1] != vf.shape[1]:
        raise ValueError(f"factor shapes {uf.shape} and {vf.shape} differ "
                         "in rank")
    if len(user_ids) != uf.shape[0] or len(item_ids) != vf.shape[0]:
        raise ValueError("one id per factor row is required")
    seen: Dict[int, np.ndarray] = {
        int(u): np.sort(np.asarray(ids, np.int32))
        for u, ids in (user_seen or {}).items()
    }
    return ALSModel(
        user_factors=torch.from_numpy(uf).to(dev),
        item_factors=torch.from_numpy(vf).to(dev),
        user_bimap=BiMap({str(u): i for i, u in enumerate(user_ids)}),
        item_bimap=BiMap({str(t): i for i, t in enumerate(item_ids)}),
        item_years=dict(item_years or {}),
        item_categories={k: tuple(v)
                         for k, v in (item_categories or {}).items()},
        user_seen=seen,
    )
