"""Multinomial logistic regression: the port of incubator_predictionio_tpu/
ops/logreg.py, the classification template's second algorithm (the
reference's add-algorithm template pairs NaiveBayes with a second MLlib
model, examples/scala-parallel-classification/add-algorithm/).

The JAX package runs ``optax.adam`` inside one ``lax.scan`` over
full-batch gradients; no Pallas kernel stands behind it. Here the same
steps run as a loop of PyTorch calls on the features' device: the loss
written out (the mean softmax cross-entropy plus ``l2·Σ weights²``, the
bias not penalised) and ``torch.optim.Adam`` at optax's defaults (β 0.9 /
0.999, ε 1e-8 outside the root), whose update is optax's. Adam's own
``weight_decay`` stays 0: it would add ``l2·w`` to the bias's gradient
too, where the reference adds ``2·l2·w`` to the weights' alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class LogRegModel:
    weights: Any   # [D, C]
    bias: Any      # [C]


def logreg_fit(
    features: torch.Tensor,   # [N, D] f32
    labels: torch.Tensor,     # [N] int
    n_classes: int,
    steps: int = 300,
    learning_rate: float = 0.1,
    l2: float = 1e-4,
) -> LogRegModel:
    """``steps`` full-batch Adam steps from zero weights, on the features'
    device."""
    d = features.shape[1]
    dev = features.device
    weights = torch.zeros((d, n_classes), dtype=torch.float32, device=dev,
                          requires_grad=True)
    bias = torch.zeros((n_classes,), dtype=torch.float32, device=dev,
                       requires_grad=True)
    target = labels.long()
    opt = torch.optim.Adam([weights, bias], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        opt.zero_grad(set_to_none=False)
        logits = features @ weights + bias
        loss = (torch.nn.functional.cross_entropy(logits, target)
                + l2 * torch.sum(weights ** 2))
        loss.backward()
        opt.step()
    return LogRegModel(weights=weights.detach(), bias=bias.detach())


def logreg_predict(model: LogRegModel, features: torch.Tensor) -> torch.Tensor:
    return torch.argmax(features @ model.weights + model.bias, dim=-1)


def logreg_proba(model: LogRegModel, features: torch.Tensor) -> torch.Tensor:
    return torch.softmax(features @ model.weights + model.bias, dim=-1)


def logreg_accuracy(model: LogRegModel, features: np.ndarray,
                    labels: np.ndarray) -> float:
    x = torch.as_tensor(np.asarray(features, np.float32),
                        device=model.weights.device)
    pred = logreg_predict(model, x).cpu().numpy()
    return float((pred == np.asarray(labels)).mean())
