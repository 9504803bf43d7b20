"""E-commerce recommendation template (implicit ALS + serve-time business
rules): the port of incubator_predictionio_tpu/models/ecommerce/. An
``engine.json`` names its factory as
``incubator_predictionio_tpu_torch.models.ecommerce:ECommerceEngine`` (or
by the JAX package's name, which the CLI maps to this module).
"""

from incubator_predictionio_tpu_torch.models.ecommerce.engine import (
    DataSourceParams,
    ECommAlgorithmParams,
    ECommerceEngine,
    ItemScore,
    PredictedResult,
    Query,
)

__all__ = [
    "DataSourceParams", "ECommAlgorithmParams", "ECommerceEngine",
    "ItemScore", "PredictedResult", "Query",
]
