"""Classification template (NaiveBayes + LogisticRegression): the port of
incubator_predictionio_tpu/models/classification/. An ``engine.json``
naming the JAX package's factory
(``incubator_predictionio_tpu.models.classification:ClassificationEngine``)
resolves to this one by name (``workflow.checkpoint.port_module``).

Parity: examples/scala-parallel-classification/ (add-algorithm and
custom-attributes variants).
"""

from incubator_predictionio_tpu_torch.models.classification.engine import (
    ClassificationDataSource,
    ClassificationEngine,
    ClassificationPreparator,
    DataSourceParams,
    FirstServing,
    LabeledPoint,
    LogRegAlgorithm,
    LogRegAlgorithmParams,
    NaiveBayesAlgorithm,
    NaiveBayesAlgorithmParams,
    PredictedResult,
    Query,
    TrainingData,
)

__all__ = [
    "ClassificationDataSource", "ClassificationEngine",
    "ClassificationPreparator", "DataSourceParams", "FirstServing",
    "LabeledPoint", "LogRegAlgorithm", "LogRegAlgorithmParams",
    "NaiveBayesAlgorithm", "NaiveBayesAlgorithmParams", "PredictedResult",
    "Query", "TrainingData",
]
