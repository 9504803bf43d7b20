"""Similar-product template (implicit-feedback ALS, item-to-item queries):
the port of incubator_predictionio_tpu/models/similarproduct/. The
recommended-user variant lives in ``.recommended_user``. An
``engine.json`` naming the JAX package's factory
(``incubator_predictionio_tpu.models.similarproduct:SimilarProductEngine``)
resolves to this one by name (``workflow.checkpoint.port_module``)."""

from incubator_predictionio_tpu_torch.models.similarproduct.engine import (
    ALSAlgorithmParams,
    DataSourceParams,
    ItemScore,
    PredictedResult,
    Query,
    SimilarProductEngine,
)
from incubator_predictionio_tpu_torch.models.similarproduct.recommended_user import (
    RecommendedUserEngine,
)

__all__ = [
    "ALSAlgorithmParams", "DataSourceParams", "ItemScore", "PredictedResult",
    "Query", "SimilarProductEngine", "RecommendedUserEngine",
]
