"""e2 engine-building blocks (the port's own copy of
incubator_predictionio_tpu/e2/engine.py).

- :class:`CategoricalNaiveBayes` — NB over string-feature LabeledPoints
  (e2/.../engine/CategoricalNaiveBayes.scala:30-160: ``train`` → model with
  ``log_score`` (optional default for unseen feature values) and ``predict``).
- :class:`MarkovChain` — top-N transition model on a sparse count matrix
  (e2/.../engine/MarkovChain.scala:33-90).
- :class:`BinaryVectorizer` — (field, value) pairs → binary feature vectors
  (e2/.../engine/BinaryVectorizer.scala:37-60) feeding the classifiers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LabeledPoint:
    """e2 LabeledPoint: a string label + string feature values."""

    label: str
    features: Tuple[str, ...]

    def __post_init__(self) -> None:
        if isinstance(self.features, list):
            object.__setattr__(self, "features", tuple(self.features))


@dataclasses.dataclass
class CategoricalNaiveBayesModel:
    """priors: label → log P(label); likelihoods: label → per-position
    {value → log P(value | label, position)} (CategoricalNaiveBayes.scala:88)."""

    priors: Dict[str, float]
    likelihoods: Dict[str, List[Dict[str, float]]]

    def log_score(
        self,
        point: LabeledPoint,
        default_likelihood: Callable[[Sequence[float]], float] = lambda _: float("-inf"),
    ) -> Optional[float]:
        """Joint log-score of a point under its label
        (CategoricalNaiveBayes.scala logScore:102-138). Unseen feature values
        go through ``default_likelihood`` (given the position's seen
        log-likelihoods); the default −inf matches the reference."""
        if point.label not in self.priors:
            return None
        like = self.likelihoods[point.label]
        if len(point.features) != len(like):
            raise ValueError(
                f"point has {len(point.features)} features, model expects {len(like)}"
            )
        score = self.priors[point.label]
        for position, value in enumerate(point.features):
            table = like[position]
            if value in table:
                score += table[value]
            else:
                score += default_likelihood(list(table.values()))
        return score

    def predict(self, features: Sequence[str]) -> str:
        """Most-likely label (CategoricalNaiveBayes.scala predict:141-158).

        When every label scores −inf (all feature values unseen), the first
        label still wins — the reference sorts and takes the head."""
        scored = [
            (label, self.log_score(LabeledPoint(label, tuple(features))))
            for label in self.priors
        ]
        return max(scored, key=lambda t: t[1])[0]


class CategoricalNaiveBayes:
    @staticmethod
    def train(points: Iterable[LabeledPoint]) -> CategoricalNaiveBayesModel:
        """CategoricalNaiveBayes.train:30-86."""
        points = list(points)
        if not points:
            raise ValueError("No training points")
        n_features = len(points[0].features)
        label_counts: Dict[str, int] = {}
        value_counts: Dict[str, List[Dict[str, int]]] = {}
        for p in points:
            if len(p.features) != n_features:
                raise ValueError("Inconsistent feature arity")
            label_counts[p.label] = label_counts.get(p.label, 0) + 1
            tables = value_counts.setdefault(
                p.label, [dict() for _ in range(n_features)]
            )
            for position, value in enumerate(p.features):
                tables[position][value] = tables[position].get(value, 0) + 1
        total = len(points)
        priors = {
            label: math.log(count / total)
            for label, count in label_counts.items()
        }
        likelihoods = {
            label: [
                {v: math.log(c / label_counts[label]) for v, c in table.items()}
                for table in tables
            ]
            for label, tables in value_counts.items()
        }
        return CategoricalNaiveBayesModel(priors, likelihoods)


@dataclasses.dataclass
class MarkovChainModel:
    """Per-state top-N transitions (MarkovChain.scala MarkovChainModel:60-90)."""

    transitions: Dict[int, List[Tuple[int, float]]]
    n: int

    def predict(self, current_states: Sequence[int]) -> List[int]:
        """Most probable next state for each current state
        (MarkovChain.scala predict:71)."""
        out = []
        for s in current_states:
            candidates = self.transitions.get(s, [])
            out.append(candidates[0][0] if candidates else -1)
        return out

    def top_n(self, state: int) -> List[Tuple[int, float]]:
        return self.transitions.get(state, [])


class MarkovChain:
    @staticmethod
    def train(
        rows: Sequence[int],
        cols: Sequence[int],
        counts: Sequence[float],
        top_n: int,
    ) -> MarkovChainModel:
        """Row-normalize a sparse transition-count matrix and keep the top-N
        next states per state (MarkovChain.train:33-58)."""
        sums: Dict[int, float] = {}
        for r, c in zip(rows, counts):
            sums[int(r)] = sums.get(int(r), 0.0) + float(c)
        per_state: Dict[int, List[Tuple[int, float]]] = {}
        for r, c, n in zip(rows, cols, counts):
            r = int(r)
            per_state.setdefault(r, []).append((int(c), float(n) / sums[r]))
        transitions = {
            r: sorted(lst, key=lambda t: -t[1])[:top_n]
            for r, lst in per_state.items()
        }
        return MarkovChainModel(transitions, top_n)


class BinaryVectorizer:
    """(field, value) → one-hot index map (BinaryVectorizer.scala:37-60)."""

    def __init__(self, index: Dict[Tuple[str, str], int]):
        self.index = dict(index)
        self.n = len(self.index)

    @classmethod
    def fit(cls, pairs: Iterable[Tuple[str, str]]) -> "BinaryVectorizer":
        distinct = dict.fromkeys(tuple(p) for p in pairs)
        return cls({p: i for i, p in enumerate(distinct)})

    def transform(self, properties: Dict[str, str]) -> np.ndarray:
        """BinaryVectorizer.toBinary: set 1.0 at each known (field, value)."""
        out = np.zeros(self.n, np.float32)
        for field, value in properties.items():
            idx = self.index.get((field, str(value)))
            if idx is not None:
                out[idx] = 1.0
        return out

    def transform_batch(
        self, rows: Sequence[Dict[str, str]]
    ) -> np.ndarray:
        return np.stack([self.transform(r) for r in rows]) if rows else \
            np.zeros((0, self.n), np.float32)
