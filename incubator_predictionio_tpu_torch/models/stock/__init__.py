"""Stock backtesting template (the scala-stock experimental template): the
port of incubator_predictionio_tpu/models/stock/. An ``engine.json``
naming the JAX package's factory
(``incubator_predictionio_tpu.models.stock:StockEngine``) resolves to this
one by name (``workflow.checkpoint.port_module``)."""

from incubator_predictionio_tpu_torch.models.stock.engine import (
    BacktestingEvaluator,
    BacktestingParams,
    DataSourceParams,
    MomentumStrategyParams,
    Prediction,
    Query,
    RegressionStrategyParams,
    StockEngine,
)

__all__ = [
    "BacktestingEvaluator", "BacktestingParams", "DataSourceParams",
    "MomentumStrategyParams", "Prediction", "Query",
    "RegressionStrategyParams", "StockEngine",
]
