"""Classification engine: entity attributes → naive Bayes and logistic
regression on the card. The port of incubator_predictionio_tpu/models/
classification/engine.py (:86-121 the data source, :130-144 the label
index, :159-236 the algorithms, :239-244 the metric).

Reference parity (examples/scala-parallel-classification/add-algorithm/):

- The data source aggregates ``user`` entity properties requiring
  ``plan, attr0, attr1, attr2`` (DataSource.scala:46-71) into
  LabeledPoints; the attribute names are configurable (the
  custom-attributes variant reads ``featureA..D``). ``read_eval`` splits
  them into ``eval_k`` folds (``e2.split_data``).
- ``Query(features)`` / ``PredictedResult(label)`` (Engine.scala:23-31).
- Two algorithms under one engine ("naive" and "logreg"), the
  add-algorithm variant's engine.json shape, served by ``FirstServing``.
- ``AccuracyMetric``: the share of exact labels, for ``pio eval``.

Each model's tensors live on ``ctx.device`` (CUDA unless the caller asks
for the CPU); a prediction is one device call (``nb_predict``,
``logreg_predict``), as in the JAX package. A model decoded from a blob
(host numpy) is put on the device once, in ``prepare_model``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, List, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    FirstServing,
    Params,
    Preparator,
)
from incubator_predictionio_tpu_torch.core.engine import Engine, EngineFactory
from incubator_predictionio_tpu_torch.core.metrics import AverageMetric
from incubator_predictionio_tpu_torch.data.store import EventStore
from incubator_predictionio_tpu_torch.ops.logreg import (
    LogRegModel,
    logreg_fit,
    logreg_predict,
)
from incubator_predictionio_tpu_torch.ops.nb import (
    NaiveBayesModel,
    nb_fit,
    nb_predict,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Query:
    __camel_case__ = True

    features: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    __camel_case__ = True

    label: float


@dataclasses.dataclass(frozen=True)
class LabeledPoint:
    label: float
    features: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    __camel_case__ = True

    app_name: str
    entity_type: str = "user"
    label_attr: str = "plan"
    attrs: Tuple[str, ...] = ("attr0", "attr1", "attr2")
    eval_k: int = 0


@dataclasses.dataclass
class TrainingData:
    labeled_points: List[LabeledPoint]

    def sanity_check(self) -> None:
        if not self.labeled_points:
            raise ValueError("TrainingData has no labeled points")


@dataclasses.dataclass(frozen=True)
class EvalInfo:
    fold: int


class ClassificationDataSource(DataSource):
    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def _read_points(self) -> List[LabeledPoint]:
        required = [self.params.label_attr, *self.params.attrs]
        props = EventStore.aggregate_properties(
            app_name=self.params.app_name,
            entity_type=self.params.entity_type,
            required=required,
        )
        return [
            LabeledPoint(
                label=pm.get(self.params.label_attr, float),
                features=tuple(pm.get(a, float) for a in self.params.attrs),
            )
            for _entity, pm in sorted(props.items())
        ]

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
    features: np.ndarray       # [N, D] f32
    labels: np.ndarray         # [N] int32 class ids
    label_values: Tuple[float, ...]  # class id -> original label value


class ClassificationPreparator(Preparator):
    """Labels (arbitrary doubles in the reference) index to dense class ids
    for the device; the map rides in the model to translate back."""

    def prepare(self, ctx: RuntimeContext, td: TrainingData) -> PreparedData:
        values = sorted({p.label for p in td.labeled_points})
        index = {v: i for i, v in enumerate(values)}
        return PreparedData(
            features=np.array([p.features for p in td.labeled_points],
                              np.float32),
            labels=np.array([index[p.label] for p in td.labeled_points],
                            np.int32),
            label_values=tuple(values),
        )


def _put(t, device) -> torch.Tensor:
    return torch.as_tensor(t).to(device=device, dtype=torch.float32)


def _query_row(query: Query, device) -> torch.Tensor:
    return torch.tensor([query.features], dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class NaiveBayesAlgorithmParams(Params):
    __camel_case__ = True  # accepts {"lambda": ...}

    lambda_: float = 1.0


@dataclasses.dataclass
class NBModel:
    nb: Any
    label_values: Tuple[float, ...]


class NaiveBayesAlgorithm(Algorithm):
    """NaiveBayesAlgorithm.scala of the template → ops.nb."""

    params_class = NaiveBayesAlgorithmParams
    query_class_ = Query

    def __init__(self, params: NaiveBayesAlgorithmParams =
                 NaiveBayesAlgorithmParams()):
        super().__init__(params)

    def train(self, ctx: RuntimeContext, pd: PreparedData) -> NBModel:
        model = nb_fit(
            torch.as_tensor(pd.features, device=ctx.device),
            torch.as_tensor(pd.labels, device=ctx.device),
            n_classes=len(pd.label_values), lambda_=self.params.lambda_,
        )
        return NBModel(nb=model, label_values=pd.label_values)

    def prepare_model(self, ctx: RuntimeContext, model: NBModel) -> NBModel:
        return dataclasses.replace(model, nb=NaiveBayesModel(
            pi=_put(model.nb.pi, ctx.device),
            theta=_put(model.nb.theta, ctx.device)))

    def predict(self, model: NBModel, query: Query) -> PredictedResult:
        cls = int(nb_predict(
            model.nb, _query_row(query, model.nb.theta.device))[0])
        return PredictedResult(label=model.label_values[cls])


@dataclasses.dataclass(frozen=True)
class LogRegAlgorithmParams(Params):
    __camel_case__ = True

    steps: int = 300
    learning_rate: float = 0.1
    l2: float = 1e-4


@dataclasses.dataclass
class LogRegModelWrap:
    lr: Any
    label_values: Tuple[float, ...]


class LogRegAlgorithm(Algorithm):
    """The add-algorithm second model → ops.logreg (Adam steps)."""

    params_class = LogRegAlgorithmParams
    query_class_ = Query

    def __init__(self, params: LogRegAlgorithmParams =
                 LogRegAlgorithmParams()):
        super().__init__(params)

    def train(self, ctx: RuntimeContext, pd: PreparedData) -> LogRegModelWrap:
        model = logreg_fit(
            torch.as_tensor(pd.features, device=ctx.device),
            torch.as_tensor(pd.labels, device=ctx.device),
            n_classes=len(pd.label_values),
            steps=self.params.steps,
            learning_rate=self.params.learning_rate,
            l2=self.params.l2,
        )
        return LogRegModelWrap(lr=model, label_values=pd.label_values)

    def prepare_model(self, ctx: RuntimeContext,
                      model: LogRegModelWrap) -> LogRegModelWrap:
        return dataclasses.replace(model, lr=LogRegModel(
            weights=_put(model.lr.weights, ctx.device),
            bias=_put(model.lr.bias, ctx.device)))

    def predict(self, model: LogRegModelWrap,
                query: Query) -> PredictedResult:
        cls = int(logreg_predict(
            model.lr, _query_row(query, model.lr.weights.device))[0])
        return PredictedResult(label=model.label_values[cls])


class AccuracyMetric(AverageMetric):
    """The template's evaluation metric (the reference's evaluation variant
    scores exact-label accuracy)."""

    def calculate_qpa(self, q: Query, p: PredictedResult, a: float) -> float:
        return 1.0 if p.label == a else 0.0


class ClassificationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            ClassificationDataSource,
            ClassificationPreparator,
            {"naive": NaiveBayesAlgorithm, "logreg": LogRegAlgorithm},
            FirstServing,
        )
