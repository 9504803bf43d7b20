"""Evaluation DSL + MetricEvaluator: the port's own copy of
incubator_predictionio_tpu/core/evaluation.py (reference
controller/{Evaluation,Deployment}.scala and MetricEvaluator.scala).

An ``Evaluation`` binds an engine with a metric set; ``MetricEvaluator``
scores every candidate ``EngineParams``, keeps the best by the primary
metric's ordering (the first of equal scores wins), and writes the
winner's params to ``best.json`` when it has an ``output_path``
(MetricEvaluator.saveEngineJson:193). The one-liner, HTML and JSON
renderings are what ``CoreWorkflow.run_evaluation`` stores with the
evaluation instance.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, List, Optional, Sequence, Tuple

from incubator_predictionio_tpu_torch.core.base import Evaluator
from incubator_predictionio_tpu_torch.core.metrics import Metric, ZeroMetric
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.utils import json_codec

logger = logging.getLogger(__name__)


class Deployment:
    """controller/Deployment.scala:29-56 — holds the engine singleton."""

    def __init__(self) -> None:
        self._engine: Any = None

    @property
    def engine(self) -> Any:
        if self._engine is None:
            raise RuntimeError("Engine not assigned")
        return self._engine

    @engine.setter
    def engine(self, value: Any) -> None:
        if self._engine is not None:
            raise RuntimeError("Engine can be assigned only once")
        self._engine = value


class Evaluation(Deployment):
    """controller/Evaluation.scala:34-125.

    Assign either ``engine_metric = (engine, metric)`` or
    ``engine_metrics = (engine, primary_metric, [other_metrics])`` or a fully
    custom ``engine_evaluator = (engine, evaluator)``.
    """

    def __init__(self) -> None:
        super().__init__()
        self._evaluator: Optional[Evaluator] = None

    @property
    def evaluator(self) -> Evaluator:
        if self._evaluator is None:
            raise RuntimeError(
                "Evaluator not assigned — set engine_metric/engine_metrics first"
            )
        return self._evaluator

    @property
    def engine_evaluator(self) -> Tuple[Any, Evaluator]:
        return (self.engine, self.evaluator)

    @engine_evaluator.setter
    def engine_evaluator(self, value: Tuple[Any, Evaluator]) -> None:
        self.engine, self._evaluator = value[0], value[1]

    @property
    def engine_metric(self) -> Tuple[Any, Metric]:
        raise NotImplementedError("write-only (Evaluation.scala:98)")

    @engine_metric.setter
    def engine_metric(self, value: Tuple[Any, Metric]) -> None:
        self.engine, self._evaluator = value[0], MetricEvaluator(value[1])

    @property
    def engine_metrics(self) -> Tuple[Any, Metric, List[Metric]]:
        raise NotImplementedError("write-only (Evaluation.scala:110)")

    @engine_metrics.setter
    def engine_metrics(self, value: Tuple[Any, Metric, List[Metric]]) -> None:
        self.engine, self._evaluator = (
            value[0],
            MetricEvaluator(value[1], list(value[2])),
        )


@dataclasses.dataclass
class MetricScores:
    """MetricEvaluator.scala:48 — primary + other scores for one candidate."""

    score: Any
    other_scores: List[Any]


@dataclasses.dataclass
class MetricEvaluatorResult:
    """MetricEvaluator.scala:55-130."""

    best_score: MetricScores
    best_engine_params: EngineParams
    best_idx: int
    metric_header: str
    other_metric_headers: List[str]
    engine_params_scores: List[Tuple[EngineParams, MetricScores]]

    def to_one_liner(self) -> str:
        return (f"[{self.best_score.score}] "
                f"{json.dumps(self.best_engine_params.to_jsonable())[:120]}")

    def to_jsonable(self) -> dict:
        return {
            "bestScore": json_codec.to_jsonable(self.best_score),
            "bestEngineParams": self.best_engine_params.to_jsonable(),
            "bestIdx": self.best_idx,
            "metricHeader": self.metric_header,
            "otherMetricHeaders": self.other_metric_headers,
            "engineParamsScores": [
                {"engineParams": ep.to_jsonable(),
                 "score": json_codec.to_jsonable(ms)}
                for ep, ms in self.engine_params_scores
            ],
        }

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{ms.score}</td><td>{ms.other_scores}</td>"
            f"<td><pre>{json.dumps(ep.to_jsonable(), indent=2)}</pre></td></tr>"
            for ep, ms in self.engine_params_scores
        )
        return (
            f"<h3>Metric: {self.metric_header}</h3>"
            f"<p>Best score: {self.best_score.score} (candidate #{self.best_idx})</p>"
            f"<table border=1><tr><th>{self.metric_header}</th>"
            f"<th>{self.other_metric_headers}</th><th>Engine params</th></tr>"
            f"{rows}</table>"
        )


class MetricEvaluator(Evaluator):
    """Scores every EngineParams candidate (MetricEvaluator.scala:185-263)."""

    def __init__(
        self,
        metric: Optional[Metric] = None,
        other_metrics: Optional[Sequence[Metric]] = None,
        output_path: Optional[str] = None,
    ):
        super().__init__()
        self.metric = metric or ZeroMetric()
        self.other_metrics = list(other_metrics or [])
        self.output_path = output_path

    def evaluate(
        self,
        ctx: RuntimeContext,
        evaluation: Any,
        engine_eval_data_set: Sequence[Tuple[EngineParams, Any]],
        params: Any = None,
    ) -> MetricEvaluatorResult:
        if not engine_eval_data_set:
            raise ValueError(
                "MetricEvaluator needs at least one EngineParams candidate "
                "(engine_eval_data_set is empty)"
            )
        scores: List[Tuple[EngineParams, MetricScores]] = []
        for engine_params, eval_data in engine_eval_data_set:
            ms = MetricScores(
                score=self.metric.calculate(ctx, eval_data),
                other_scores=[
                    m.calculate(ctx, eval_data) for m in self.other_metrics
                ],
            )
            logger.info("MetricEvaluator: %s -> %s", engine_params, ms.score)
            scores.append((engine_params, ms))

        best_idx = 0
        for i in range(1, len(scores)):
            if self.metric.compare(scores[i][1].score,
                                   scores[best_idx][1].score) > 0:
                best_idx = i
        best_params, best_score = scores[best_idx]

        result = MetricEvaluatorResult(
            best_score=best_score,
            best_engine_params=best_params,
            best_idx=best_idx,
            metric_header=self.metric.header(),
            other_metric_headers=[m.header() for m in self.other_metrics],
            engine_params_scores=scores,
        )
        if self.output_path:
            # best.json (MetricEvaluator.saveEngineJson:193)
            with open(self.output_path, "w") as f:
                json.dump(best_params.to_jsonable(), f, indent=2)
            logger.info("Writing best variant params to disk (%s)...",
                        self.output_path)
        return result
