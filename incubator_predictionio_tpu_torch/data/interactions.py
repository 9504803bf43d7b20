"""Columnar training triples: the port's own copy of ``Interactions``
(incubator_predictionio_tpu/data/storage/base.py:237-261). The id tables
are plain lists of ``str``; the event store's zero-copy id views come with
the storage slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Interactions:
    """Pre-indexed (entity, target, value) triples in first-seen id order:
    ``user_ids[user_idx[k]]`` is the entity id of triple ``k``."""

    user_idx: np.ndarray      # int32 [nnz], index into user_ids
    item_idx: np.ndarray      # int32 [nnz], index into item_ids
    values: np.ndarray        # float32 [nnz]
    user_ids: Sequence[str]   # distinct entity ids
    item_ids: Sequence[str]   # distinct target entity ids

    def __len__(self) -> int:
        return int(self.user_idx.shape[0])
