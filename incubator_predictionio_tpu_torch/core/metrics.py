"""The Metric family for evaluation scoring: the port's own copy of
incubator_predictionio_tpu/core/metrics.py (reference
controller/Metric.scala:39-269). A metric scores the full evaluation output
``[(eval_info, [(query, prediction, actual)])]``; the statistical bases
are AverageMetric:99, OptionAverageMetric:124, StdevMetric:151,
OptionStdevMetric:179, SumMetric:205, ZeroMetric:234 and QPAMetric:259.
"""

from __future__ import annotations

import math
from typing import Any, Generic, List, Optional, Sequence, Tuple, TypeVar

from incubator_predictionio_tpu_torch.core.base import EI, A, P, Q
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

R = TypeVar("R")

EvalDataSet = Sequence[Tuple[Any, Sequence[Tuple[Any, Any, Any]]]]


class Metric(Generic[EI, Q, P, A, R]):
    """Base metric (Metric.scala:39). Higher ``compare`` wins."""

    def header(self) -> str:
        return type(self).__name__

    def calculate(self, ctx: RuntimeContext, eval_data_set: EvalDataSet) -> R:
        raise NotImplementedError

    def compare(self, r0: R, r1: R) -> int:
        """Ordering (Metric.scala:52): >0 if r0 better than r1."""
        if r0 == r1:
            return 0
        return 1 if r0 > r1 else -1  # type: ignore[operator]


class QPAMetric(Metric[EI, Q, P, A, R]):
    """Per-(Q,P,A) scoring hook (Metric.scala:259)."""

    def calculate_qpa(self, q: Q, p: P, a: A) -> R:
        raise NotImplementedError


def _all_scores(metric: "QPAMetric", eval_data_set: EvalDataSet) -> List[Any]:
    return [
        metric.calculate_qpa(q, p, a)
        for _info, qpas in eval_data_set
        for q, p, a in qpas
    ]


def _present(scores: List[Optional[float]]) -> List[float]:
    return [s for s in scores if s is not None]


class AverageMetric(QPAMetric[EI, Q, P, A, float]):
    """Mean of per-tuple scores across all eval sets (Metric.scala:99)."""

    def calculate(self, ctx: RuntimeContext, eval_data_set: EvalDataSet) -> float:
        scores = _all_scores(self, eval_data_set)
        return sum(scores) / len(scores) if scores else float("nan")


class OptionAverageMetric(QPAMetric[EI, Q, P, A, float]):
    """Mean ignoring None scores (Metric.scala:124)."""

    def calculate(self, ctx: RuntimeContext, eval_data_set: EvalDataSet) -> float:
        scores = _present(_all_scores(self, eval_data_set))
        return sum(scores) / len(scores) if scores else float("nan")


def _stdev(scores: List[float]) -> float:
    if not scores:
        return float("nan")
    mean = sum(scores) / len(scores)
    return math.sqrt(sum((s - mean) ** 2 for s in scores) / len(scores))


class StdevMetric(QPAMetric[EI, Q, P, A, float]):
    """Population stdev of scores (Metric.scala:151)."""

    def calculate(self, ctx: RuntimeContext, eval_data_set: EvalDataSet) -> float:
        return _stdev(_all_scores(self, eval_data_set))


class OptionStdevMetric(QPAMetric[EI, Q, P, A, float]):
    """Stdev ignoring None (Metric.scala:179)."""

    def calculate(self, ctx: RuntimeContext, eval_data_set: EvalDataSet) -> float:
        return _stdev(_present(_all_scores(self, eval_data_set)))


class SumMetric(QPAMetric[EI, Q, P, A, float]):
    """Sum of scores (Metric.scala:205)."""

    def calculate(self, ctx: RuntimeContext, eval_data_set: EvalDataSet) -> float:
        return sum(_all_scores(self, eval_data_set))


class ZeroMetric(Metric[EI, Q, P, A, float]):
    """Always 0 — placeholder (Metric.scala:234)."""

    def calculate(self, ctx: RuntimeContext, eval_data_set: EvalDataSet) -> float:
        return 0.0
