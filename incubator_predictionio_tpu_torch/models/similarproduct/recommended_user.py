"""Recommended-user engine: user→user recommendations from follow events.

Port of incubator_predictionio_tpu/models/similarproduct/
recommended_user.py, the similarproduct family's ``recommended-user``
variant (examples/scala-parallel-similarproduct/recommended-user/): it
learns user-to-user affinity from ``follow`` events and answers "who
should these users follow next".

Reference parity:

- ``Query(users, num, whiteList?, blackList?)`` /
  ``PredictedResult(similarUserScores)`` (Engine.scala:22-36).
- The data source reads ``user follow user`` events (DataSource.scala:
  52-60).
- ALSAlgorithm trains implicit ALS on the follower × followed matrix with
  ONE shared user index for both sides (ALSAlgorithm.scala:74-76); the
  model keeps the followed-side factors (``m.productFeatures``, :120),
  unit-normalized on the card once at train time.
- Predict scores every user by the SUM of cosine similarities to the
  query users' vectors — one product of the table with
  ``Σ normed[query]`` through the score+top-k kernel
  (``ops/topk.score_and_top_k``), with the candidate mask (never the
  query users, then white/blacklists) as its ``allowed_mask`` — and keeps
  the positive scores (ALSAlgorithm.scala:127-185).

Not ported: the host mirror of small models (``ops/host_serving``, left
out on purpose: every query takes the kernel).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    FirstServing,
    Params,
    Preparator,
    SanityCheck,
)
from incubator_predictionio_tpu_torch.core.engine import Engine, EngineFactory
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.data.interactions import Interactions
from incubator_predictionio_tpu_torch.data.store import EventStore
from incubator_predictionio_tpu_torch.ops import als
from incubator_predictionio_tpu_torch.ops.topk import score_and_top_k
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Query:
    __camel_case__ = True

    users: Tuple[str, ...]
    num: int
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class SimilarUserScore:
    __camel_case__ = True

    user: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    __camel_case__ = True

    similar_user_scores: Tuple[SimilarUserScore, ...]


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    __camel_case__ = True

    app_name: str
    channel_name: Optional[str] = None


@dataclasses.dataclass
class TrainingData(SanityCheck):
    #: columnar follower→followed scan (both sides are users)
    follows: Interactions

    def __len__(self) -> int:
        return len(self.follows)

    def sanity_check(self) -> None:
        if not len(self):
            raise ValueError("TrainingData has no follow events")


class RecommendedUserDataSource(DataSource):
    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        follows = EventStore.interactions(
            app_name=self.params.app_name,
            channel_name=self.params.channel_name,
            entity_type="user",
            target_entity_type="user",
            event_names=("follow",),
            event_values={"follow": 1.0},
        )
        return TrainingData(follows=follows)


@dataclasses.dataclass
class PreparedData:
    followers: np.ndarray     # [nnz] int32, shared user index
    followed: np.ndarray      # [nnz] int32, shared user index
    weights: np.ndarray       # [nnz] f32
    user_bimap: BiMap         # ONE id space for both matrix sides


class RecommendedUserPreparator(Preparator):
    def prepare(self, ctx: RuntimeContext, td: TrainingData) -> PreparedData:
        """Merge the scan's follower / followed id tables into the one
        shared user index the reference uses for both ALS sides
        (ALSAlgorithm.scala:74-76): followers first, in scan order."""
        inter = td.follows
        mapping: Dict[str, int] = {}
        for uid in inter.user_ids:
            mapping.setdefault(uid, len(mapping))
        for uid in inter.item_ids:
            mapping.setdefault(uid, len(mapping))
        follower_remap = np.asarray(
            [mapping[u] for u in inter.user_ids], np.int32)
        followed_remap = np.asarray(
            [mapping[u] for u in inter.item_ids], np.int32)
        return PreparedData(
            followers=follower_remap[inter.user_idx],
            followed=followed_remap[inter.item_idx],
            weights=inter.values.astype(np.float32),
            user_bimap=BiMap(mapping),
        )


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    __camel_case__ = True

    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: Optional[int] = None


@dataclasses.dataclass
class RecommendedUserModel:
    #: followed-side factors, L2-normalized rows (cosine = dot)
    user_features: Any
    user_bimap: BiMap


class RecommendedUserAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams
    query_class_ = Query

    def __init__(self, params: ALSAlgorithmParams):
        super().__init__(params)

    def train(self, ctx: RuntimeContext,
              pd: PreparedData) -> RecommendedUserModel:
        """Implicit ALS (α 1) on ``ctx.device`` over the shared index;
        the followed side's factors, unit rows (a zero row stays 0)."""
        n = len(pd.user_bimap)
        seed = self.params.seed if self.params.seed is not None else ctx.seed
        state = als.als_train_implicit(
            pd.followers, pd.followed, pd.weights, n_users=n, n_items=n,
            rank=self.params.rank, iterations=self.params.num_iterations,
            l2=self.params.lambda_, seed=seed, device=ctx.device,
            stats=ctx.timings)
        feats = state.item_factors
        norms = torch.linalg.norm(feats, dim=1, keepdim=True)
        feats = torch.where(norms > 0, feats / torch.clamp(norms, min=1e-30),
                            torch.zeros_like(feats))
        return RecommendedUserModel(user_features=feats,
                                    user_bimap=pd.user_bimap)

    def prepare_model(self, ctx: RuntimeContext, model: RecommendedUserModel
                      ) -> RecommendedUserModel:
        """Put the table on ``ctx.device``, as contiguous f32."""
        return dataclasses.replace(
            model, user_features=torch.as_tensor(model.user_features).to(
                device=ctx.device, dtype=torch.float32).contiguous())

    def _candidate_mask(self, model: RecommendedUserModel, query: Query,
                        query_idx) -> np.ndarray:
        """Never the query users; then the white and black lists
        (ALSAlgorithm.scala isCandidateSimilarUser)."""
        n = len(model.user_bimap)
        mask = np.ones(n, bool)
        mask[np.asarray(query_idx, np.int64)] = False
        if query.white_list is not None:
            allowed = np.zeros(n, bool)
            for u in query.white_list:
                idx = model.user_bimap.get(u)
                if idx is not None:
                    allowed[idx] = True
            mask &= allowed
        if query.black_list:
            for u in query.black_list:
                idx = model.user_bimap.get(u)
                if idx is not None:
                    mask[idx] = False
        return mask

    def predict(self, model: RecommendedUserModel,
                query: Query) -> PredictedResult:
        query_idx = [
            model.user_bimap[u] for u in query.users
            if u in model.user_bimap
        ]
        k = min(query.num, len(model.user_bimap))
        if not query_idx or k <= 0:
            logger.info("no feature vectors for query users %s", query.users)
            return PredictedResult(similar_user_scores=())
        feats = model.user_features
        qvec = feats[torch.as_tensor(query_idx, dtype=torch.long,
                                     device=feats.device)].sum(0)
        mask = self._candidate_mask(model, query, query_idx)
        packed = score_and_top_k(qvec, feats, k,
                                 allowed_mask=torch.from_numpy(mask))
        packed = packed.cpu().numpy()
        inv = model.user_bimap.inverse
        out = []
        for s, i in zip(packed[0].tolist(), packed[1].astype(np.int64)):
            if s <= 0:  # the reference keeps strictly positive scores
                continue
            out.append(SimilarUserScore(user=inv[int(i)], score=float(s)))
        return PredictedResult(similar_user_scores=tuple(out))


class RecommendedUserEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            RecommendedUserDataSource,
            RecommendedUserPreparator,
            {"als": RecommendedUserAlgorithm},
            FirstServing,
        )
