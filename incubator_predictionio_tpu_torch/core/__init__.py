"""The DASE abstraction: typed base contracts and the Engine controller,
exported as incubator_predictionio_tpu/core/__init__.py exports them
(reference layers L3 and L4 of SURVEY.md §1)."""

from incubator_predictionio_tpu_torch.core.base import (
    Algorithm,
    AverageServing,
    DataSource,
    EmptyParams,
    FirstServing,
    IdentityPreparator,
    Params,
    Preparator,
    SanityCheck,
    Serving,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    doer,
    params_class_of,
)
from incubator_predictionio_tpu_torch.core.engine import Engine, EngineFactory
from incubator_predictionio_tpu_torch.core.evaluation import (
    Evaluation,
    MetricEvaluator,
    MetricScores,
)
from incubator_predictionio_tpu_torch.core.metrics import (
    AverageMetric,
    Metric,
    OptionAverageMetric,
    OptionStdevMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
)
from incubator_predictionio_tpu_torch.core.params import (
    EngineParams,
    WorkflowParams,
)
from incubator_predictionio_tpu_torch.core.persistent_model import (
    LocalFileSystemPersistentModel,
    PersistentModel,
)

__all__ = [
    "Algorithm", "DataSource", "EmptyParams", "Params", "Preparator",
    "IdentityPreparator", "SanityCheck", "Serving", "FirstServing",
    "AverageServing", "StopAfterReadInterruption",
    "StopAfterPrepareInterruption", "doer", "params_class_of",
    "EngineParams", "WorkflowParams", "Engine", "EngineFactory",
    "Metric", "AverageMetric", "OptionAverageMetric", "StdevMetric",
    "OptionStdevMetric", "SumMetric", "ZeroMetric",
    "Evaluation", "MetricEvaluator", "MetricScores",
    "PersistentModel", "LocalFileSystemPersistentModel",
]
