"""Regression engine: labeled feature vectors → linear models on the card.
The port of incubator_predictionio_tpu/models/regression/engine.py
(:86-134 the data source's two reads, :177-231 the algorithms, :234-246
the metric).

Reference parity (examples/experimental/scala-parallel-regression/
Run.scala and scala-local-regression/Run.scala):

- The data source reads labeled points: from a text file of ``label f0
  f1 ...`` rows (the examples' lr_data.txt, ``filepath``), or else from
  the event store as entity properties (``label`` and ``features``).
  ``read_eval`` splits them into ``eval_k`` folds, the parallel example's
  ``MLUtils.kFold`` (Run.scala:63).
- Two algorithms under one engine: ``linear`` (the exact normal-equation
  solve, the local example's path) and ``sgd`` (LinearRegressionWithSGD's
  numIterations / stepSize contract), both in ``ops/linreg.py``.
- ``AverageServing`` combines them (the parallel example's
  LAverageServing), and predictions are plain doubles on the wire.
- ``MeanSquareError`` (controller.MeanSquareError in both examples), lower
  being better.

A model's weights live on ``ctx.device`` (CUDA unless the caller asks for
the CPU) and a prediction is one device call (``linreg_predict``), as in
the JAX package; a model decoded from a blob is put on the device once,
in ``prepare_model``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, List, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch.core.base import (
    Algorithm,
    AverageServing,
    DataSource,
    Params,
    Preparator,
)
from incubator_predictionio_tpu_torch.core.engine import Engine, EngineFactory
from incubator_predictionio_tpu_torch.core.metrics import AverageMetric
from incubator_predictionio_tpu_torch.data.store import EventStore
from incubator_predictionio_tpu_torch.ops.linreg import (
    linreg_fit,
    linreg_fit_sgd,
    linreg_predict,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Query:
    __camel_case__ = True

    features: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class LabeledPoint:
    label: float
    features: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    __camel_case__ = True

    app_name: str = ""
    #: optional ``label f0 f1 ...`` text file (the reference examples'
    #: lr_data.txt format); when set, the event store is not consulted
    filepath: str = ""
    entity_type: str = "point"
    label_attr: str = "label"
    features_attr: str = "features"
    eval_k: int = 0
    seed: int = 9527


@dataclasses.dataclass
class TrainingData:
    labeled_points: List[LabeledPoint]

    def sanity_check(self) -> None:
        if not self.labeled_points:
            raise ValueError("TrainingData has no labeled points")


@dataclasses.dataclass(frozen=True)
class EvalInfo:
    fold: int


class RegressionDataSource(DataSource):
    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def _read_points(self) -> List[LabeledPoint]:
        if self.params.filepath:
            points = []
            with open(self.params.filepath) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    points.append(LabeledPoint(
                        label=float(parts[0]),
                        features=tuple(float(v) for v in parts[1:]),
                    ))
            return points
        props = EventStore.aggregate_properties(
            app_name=self.params.app_name,
            entity_type=self.params.entity_type,
            required=[self.params.label_attr, self.params.features_attr],
        )
        points = []
        for _entity, pm in sorted(props.items()):
            features = pm.get(self.params.features_attr, list)
            points.append(LabeledPoint(
                label=pm.get(self.params.label_attr, float),
                features=tuple(float(v) for v in features),
            ))
        return points

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        return TrainingData(self._read_points())

    def read_eval(self, ctx: RuntimeContext):
        from incubator_predictionio_tpu_torch.e2 import split_data

        if self.params.eval_k <= 0:
            return []
        points = self._read_points()
        return [
            (TrainingData(train), EvalInfo(fold), qa)
            for train, fold, qa in split_data(
                self.params.eval_k, points,
                lambda p: (Query(features=p.features), p.label),
            )
        ]


@dataclasses.dataclass
class PreparedData:
    features: np.ndarray   # [N, K] f32
    labels: np.ndarray     # [N] f32


class RegressionPreparator(Preparator):
    """Points → dense arrays (IdentityPreparator's role; the columnar form
    is what the device takes)."""

    def prepare(self, ctx: RuntimeContext, td: TrainingData) -> PreparedData:
        return PreparedData(
            features=np.array([p.features for p in td.labeled_points],
                              np.float32),
            labels=np.array([p.label for p in td.labeled_points],
                            np.float32),
        )


@dataclasses.dataclass(frozen=True)
class LinearAlgorithmParams(Params):
    __camel_case__ = True

    l2: float = 0.0


@dataclasses.dataclass
class RegressionModel:
    weights: Any  # [K+1] tensor on the device, intercept last


class _LinearModelAlgorithm(Algorithm):
    """What both algorithms share: a regression model is its weight vector,
    however it was fit."""

    query_class_ = Query

    def prepare_model(self, ctx: RuntimeContext,
                      model: RegressionModel) -> RegressionModel:
        return RegressionModel(weights=torch.as_tensor(model.weights).to(
            device=ctx.device, dtype=torch.float32))

    def predict(self, model: RegressionModel, query: Query) -> float:
        w = model.weights
        x = torch.tensor([query.features], dtype=torch.float32,
                         device=w.device)
        return float(linreg_predict(w, x)[0])


def _train_arrays(ctx: RuntimeContext, pd: PreparedData):
    return (torch.as_tensor(pd.features, device=ctx.device),
            torch.as_tensor(pd.labels, device=ctx.device))


class LinearAlgorithm(_LinearModelAlgorithm):
    """Exact normal-equation ridge solve (the local example's
    nak LinearRegression.regress path → ops.linreg.linreg_fit)."""

    params_class = LinearAlgorithmParams

    def __init__(self, params: LinearAlgorithmParams =
                 LinearAlgorithmParams()):
        super().__init__(params)

    def train(self, ctx: RuntimeContext, pd: PreparedData) -> RegressionModel:
        return RegressionModel(weights=linreg_fit(
            *_train_arrays(ctx, pd), l2=self.params.l2))


@dataclasses.dataclass(frozen=True)
class SGDAlgorithmParams(Params):
    __camel_case__ = True

    num_iterations: int = 200
    step_size: float = 0.1
    l2: float = 0.0


class SGDAlgorithm(_LinearModelAlgorithm):
    """Gradient-descent fit (LinearRegressionWithSGD's contract —
    Run.scala AlgorithmParams(numIterations, stepSize))."""

    params_class = SGDAlgorithmParams

    def __init__(self, params: SGDAlgorithmParams = SGDAlgorithmParams()):
        super().__init__(params)

    def train(self, ctx: RuntimeContext, pd: PreparedData) -> RegressionModel:
        return RegressionModel(weights=linreg_fit_sgd(
            *_train_arrays(ctx, pd),
            steps=self.params.num_iterations,
            step_size=self.params.step_size,
            l2=self.params.l2))


class MeanSquareError(AverageMetric):
    """controller.MeanSquareError (both reference regression examples'
    evaluator)."""

    def header(self) -> str:
        return "MSE"

    def calculate_qpa(self, q: Query, p: float, a: float) -> float:
        return (p - a) ** 2

    def compare(self, left: float, right: float) -> int:
        # lower MSE is better
        return (left < right) - (left > right)


class RegressionEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            RegressionDataSource,
            RegressionPreparator,
            {"linear": LinearAlgorithm, "sgd": SGDAlgorithm},
            AverageServing,
        )
