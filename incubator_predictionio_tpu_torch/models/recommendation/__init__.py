"""Recommendation template (explicit-rating ALS): the port of
incubator_predictionio_tpu/models/recommendation/. An ``engine.json`` names
its factory as ``incubator_predictionio_tpu_torch.models.recommendation:
RecommendationEngine``."""

from incubator_predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModel,
    DataSourceParams,
    ItemScore,
    PredictedResult,
    Query,
    Rating,
    RecommendationDataSource,
    RecommendationEngine,
    RecommendationPreparator,
    RecommendationServing,
    TrainingData,
)

__all__ = [
    "ALSAlgorithm", "ALSAlgorithmParams", "ALSModel", "DataSourceParams",
    "ItemScore", "PredictedResult", "Query", "Rating",
    "RecommendationDataSource", "RecommendationEngine",
    "RecommendationPreparator", "RecommendationServing", "TrainingData",
]
