"""k-fold cross-validation splitter (the port's own copy of
incubator_predictionio_tpu/e2/evaluation.py).

Parity: e2/.../evaluation/CrossValidation.scala:36-60 — splits data into k
folds, yielding (training set, eval info, (query, actual) pairs) tuples in
the shape ``DataSource.read_eval`` expects.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, TypeVar

D = TypeVar("D")
Q = TypeVar("Q")
A = TypeVar("A")


def split_data(
    k: int,
    data: Sequence[D],
    make_qa: Callable[[D], Tuple[Q, A]],
) -> List[Tuple[List[D], int, List[Tuple[Q, A]]]]:
    """Returns k tuples (train_fold, fold_index, [(query, actual)]).

    Fold membership is ``index % k`` (the reference uses zipWithIndex % k,
    CrossValidation.scala:44) so splits are deterministic.
    """
    if k <= 1:
        raise ValueError("k must be >= 2")
    out = []
    for fold in range(k):
        train = [d for i, d in enumerate(data) if i % k != fold]
        test = [d for i, d in enumerate(data) if i % k == fold]
        out.append((train, fold, [make_qa(d) for d in test]))
    return out
