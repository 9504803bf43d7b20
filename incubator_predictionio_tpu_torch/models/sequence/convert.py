"""Weights carried across from numpy: the fields of the JAX package's
``TransformerWeights`` (incubator_predictionio_tpu/ops/transformer.py:43),
as numpy arrays, become this package's ``TransformerWeights``, and with
the item ids a ``SeqRecModel``, so both packages serve (or train) from one
set of weights: the JAX PRNG and torch's generators draw different numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.models.sequence.engine import (
    SeqRecModel,
)
from incubator_predictionio_tpu_torch.ops.transformer import (
    TransformerWeights,
)
from incubator_predictionio_tpu_torch.runtime import default_device

FIELDS = tuple(f.name for f in dataclasses.fields(TransformerWeights))


def transformer_weights_from_numpy(fields: Mapping[str, np.ndarray],
                                   device=None) -> TransformerWeights:
    """Every field as a contiguous f32 tensor on ``device`` (CUDA by
    default); the per-layer fields keep their stacked [N, ...] layout."""
    dev = default_device(device)
    missing = set(FIELDS) - set(fields)
    if missing:
        raise ValueError(f"missing weight fields: {sorted(missing)}")
    w = TransformerWeights(**{
        f: torch.from_numpy(np.array(fields[f], np.float32)).to(dev)
        for f in FIELDS})
    d = w.item_emb.shape[1]
    n = w.wq.shape[0]
    if w.pos_emb.shape[1] != d or w.wq.shape != (n, d, d) \
            or w.w_up.shape[:2] != (n, d) or w.lnf_scale.shape != (d,):
        raise ValueError("weight shapes do not agree on d_model and layers")
    return w


def seqrec_model_from_numpy(fields: Mapping[str, np.ndarray],
                            item_ids: Sequence[str], n_heads: int,
                            max_len: int, final_loss: float = float("nan"),
                            device=None) -> SeqRecModel:
    """A ``SeqRecModel`` whose token ``i + 1`` is ``item_ids[i]`` (token 0 is
    PAD); ``max_len`` as the preparator's (the scoring window is
    ``max_len - 1``)."""
    w = transformer_weights_from_numpy(fields, device)
    if w.item_emb.shape[0] != len(item_ids) + 1:
        raise ValueError(f"item_emb has {w.item_emb.shape[0]} rows for "
                         f"{len(item_ids)} items + PAD")
    if w.pos_emb.shape[0] < max_len - 1:
        raise ValueError(f"pos_emb has {w.pos_emb.shape[0]} rows for a "
                         f"window of {max_len - 1}")
    if w.item_emb.shape[1] % n_heads:
        raise ValueError(f"d_model {w.item_emb.shape[1]} not divisible by "
                         f"{n_heads} heads")
    return SeqRecModel(
        weights=w,
        item_bimap=BiMap({str(t): i for i, t in enumerate(item_ids)}),
        n_heads=n_heads, max_len=max_len, final_loss=final_loss)
