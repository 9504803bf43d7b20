"""Friend-recommendation template (keyword similarity, the random
baseline, SimRank): the port of incubator_predictionio_tpu/models/
friendrecommendation/. An ``engine.json`` naming the JAX package's
factory (``incubator_predictionio_tpu.models.friendrecommendation:
FriendRecommendationEngine``) resolves to this one by name
(``workflow.checkpoint.port_module``)."""

from incubator_predictionio_tpu_torch.models.friendrecommendation.engine import (
    DataSourceParams,
    FriendRecommendationEngine,
    KeywordSimilarityAlgoParams,
    Prediction,
    Query,
    SimRankAlgoParams,
)

__all__ = [
    "DataSourceParams", "FriendRecommendationEngine",
    "KeywordSimilarityAlgoParams", "Prediction", "Query",
    "SimRankAlgoParams",
]
