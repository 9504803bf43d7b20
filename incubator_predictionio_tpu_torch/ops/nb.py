"""Multinomial Naive Bayes: the port of incubator_predictionio_tpu/ops/nb.py,
the MLlib NaiveBayes replacement of the classification template
(examples/scala-parallel-classification/add-algorithm/src/main/scala/
NaiveBayesAlgorithm.scala).

The fit is one product ``one_hotᵀ · X`` of class sums on the features'
device; a prediction is one product and an argmax. No Pallas kernel
stands behind either in the JAX package (XLA computes them), so here they
are PyTorch calls on the tensors' device, in f32 as there. ``argmax``
takes the first maximum in both packages, so a tie goes to the lowest
class id.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class NaiveBayesModel:
    """log-prior pi [C] and log-likelihood theta [C, D] (MLlib layout)."""

    pi: Any
    theta: Any


def nb_fit(
    features: torch.Tensor,   # [N, D] non-negative counts/values
    labels: torch.Tensor,     # [N] int in [0, n_classes)
    n_classes: int,
    lambda_: float = 1.0,
) -> NaiveBayesModel:
    """Multinomial NB with Laplace smoothing (MLlib semantics), on the
    features' device."""
    n, d = features.shape
    one_hot = torch.nn.functional.one_hot(
        labels.long(), n_classes).to(features.dtype)          # [N, C]
    class_counts = one_hot.sum(dim=0)                         # [C]
    total = torch.tensor(n + n_classes * lambda_, dtype=features.dtype,
                         device=features.device)
    pi = torch.log(class_counts + lambda_) - torch.log(total)
    feature_sums = one_hot.T @ features                       # [C, D]
    theta = torch.log(feature_sums + lambda_) - torch.log(
        feature_sums.sum(dim=1, keepdim=True) + d * lambda_)
    return NaiveBayesModel(pi=pi, theta=theta)


def nb_log_scores(model: NaiveBayesModel,
                  features: torch.Tensor) -> torch.Tensor:
    """[B, D] → [B, C] joint log-scores."""
    return features @ model.theta.T + model.pi[None, :]


def nb_predict(model: NaiveBayesModel, features: torch.Tensor) -> torch.Tensor:
    """[B, D] → [B] predicted class ids (the first maximum)."""
    return torch.argmax(nb_log_scores(model, features), dim=-1)


def nb_accuracy(model: NaiveBayesModel, features: np.ndarray,
                labels: np.ndarray) -> float:
    x = torch.as_tensor(np.asarray(features, np.float32),
                        device=model.theta.device)
    pred = nb_predict(model, x).cpu().numpy()
    return float((pred == np.asarray(labels)).mean())
