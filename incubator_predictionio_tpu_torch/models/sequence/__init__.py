"""Session-based sequence recommendation (next-item transformer)."""

from incubator_predictionio_tpu_torch.models.sequence.engine import (
    PredictedResult,
    Query,
    SeqRecAlgorithm,
    SeqRecAlgorithmParams,
    SequenceDataSource,
    SequenceEngine,
    SequencePreparator,
)

__all__ = [
    "PredictedResult",
    "Query",
    "SeqRecAlgorithm",
    "SeqRecAlgorithmParams",
    "SequenceDataSource",
    "SequenceEngine",
    "SequencePreparator",
]
