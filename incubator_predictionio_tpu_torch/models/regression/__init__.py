"""Regression template (ridge and SGD linear models under
``AverageServing``): the port of incubator_predictionio_tpu/models/
regression/. An ``engine.json`` naming the JAX package's factory
(``incubator_predictionio_tpu.models.regression:RegressionEngine``)
resolves to this one by name (``workflow.checkpoint.port_module``)."""

from incubator_predictionio_tpu_torch.models.regression.engine import (
    DataSourceParams,
    LinearAlgorithmParams,
    MeanSquareError,
    Query,
    RegressionEngine,
    SGDAlgorithmParams,
)

__all__ = [
    "DataSourceParams", "LinearAlgorithmParams", "MeanSquareError",
    "Query", "RegressionEngine", "SGDAlgorithmParams",
]
