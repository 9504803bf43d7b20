"""e2 — standalone engine-building library (reference: e2/ module): the
port's own copy of incubator_predictionio_tpu/e2/, numpy only.

Parity: CategoricalNaiveBayes (e2/.../engine/CategoricalNaiveBayes.scala),
MarkovChain (e2/.../engine/MarkovChain.scala), BinaryVectorizer
(e2/.../engine/BinaryVectorizer.scala), CrossValidation
(e2/.../evaluation/CrossValidation.scala).
"""

from incubator_predictionio_tpu_torch.e2.engine import (
    BinaryVectorizer,
    CategoricalNaiveBayes,
    CategoricalNaiveBayesModel,
    LabeledPoint,
    MarkovChain,
    MarkovChainModel,
)
from incubator_predictionio_tpu_torch.e2.evaluation import split_data

__all__ = [
    "BinaryVectorizer", "CategoricalNaiveBayes", "CategoricalNaiveBayesModel",
    "LabeledPoint", "MarkovChain", "MarkovChainModel", "split_data",
]
