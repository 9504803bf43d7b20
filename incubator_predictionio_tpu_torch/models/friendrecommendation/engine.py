"""Friend-recommendation engine (the KDD-2012 scenario): the port of
incubator_predictionio_tpu/models/friendrecommendation/engine.py (:90-131
the data source, :134-222 the keyword and random algorithms, :242-277
SimRank).

Reference parity (examples/experimental/scala-local-friend-recommendation
and scala-parallel-friend-recommendation): given ``Query(user, item)``,
predict an acceptance ``confidence`` and a boolean ``acceptance``.

- ``keyword``: the sparse dot product of the user's and the item's
  keyword → weight maps against a weight and threshold pair
  (KeywordSimilarityAlgorithm.scala: findKeywordSimilarity; the reference
  ships weight 1, threshold 1).
- ``random``: the RandomAlgorithm baseline (RandomModel.scala), a uniform
  confidence from numpy's generator seeded by the crc32 of (seed, user,
  item), so its answers equal the JAX package's.
- ``simrank``: the parallel variant's graph similarity
  (DeltaSimRankRDD.scala), computed exactly by dense products on the card
  (``ops/simrank.py``) over the ``follow`` / ``action`` edges. Its
  [N, N] matrix comes back to the host, and answers read it there, as in
  the JAX package; a query's ``item`` that names no item node falls back
  to the user node of that id.

The data lives in the event store: ``$set`` on user and item entities
carrying a ``keywords`` map of term → weight (or a bare list, weight 1.0
each), and directed ``follow`` (user → user) and ``action`` (user → item)
events forming the SimRank graph.

At ``ops/simrank.MAX_NODES`` (16,384 nodes) the model's matrix is 1 GiB of
f32, above SQLite's default blob limit of 10⁹ bytes: such a model stores
on the memory or ``localfs`` model store, in either package.
"""

from __future__ import annotations

import dataclasses
import logging
import zlib
from typing import Dict, List, Tuple

import numpy as np

from incubator_predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    FirstServing,
    IdentityPreparator,
    Params,
)
from incubator_predictionio_tpu_torch.core.engine import Engine, EngineFactory
from incubator_predictionio_tpu_torch.data.store import EventStore
from incubator_predictionio_tpu_torch.ops.simrank import simrank
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Query:
    __camel_case__ = True

    user: str
    item: str


@dataclasses.dataclass(frozen=True)
class Prediction:
    __camel_case__ = True

    confidence: float
    acceptance: bool


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    __camel_case__ = True

    app_name: str
    user_entity: str = "user"
    item_entity: str = "item"
    keywords_attr: str = "keywords"
    #: directed graph edges for simrank: (entity → target) event names
    edge_events: Tuple[str, ...] = ("follow", "action")


@dataclasses.dataclass
class TrainingData:
    user_keywords: Dict[str, Dict[str, float]]
    item_keywords: Dict[str, Dict[str, float]]
    #: directed edges over the combined user+item node space, keyed
    #: "<entity_type>:<entity_id>"
    edges: List[Tuple[str, str]]
    #: the entity-type names the edges were keyed with (query resolution
    #: must use the same prefixes)
    user_entity: str = "user"
    item_entity: str = "item"

    def sanity_check(self) -> None:
        if not self.user_keywords and not self.edges:
            raise ValueError("TrainingData has no keywords and no edges")


class FriendRecommendationDataSource(DataSource):
    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def _keywords(self, entity_type: str) -> Dict[str, Dict[str, float]]:
        props = EventStore.aggregate_properties(
            app_name=self.params.app_name, entity_type=entity_type,
            required=[self.params.keywords_attr])
        out: Dict[str, Dict[str, float]] = {}
        for entity, pm in props.items():
            # opt, not get: an explicit null keywords value means "no
            # keywords", not a DataMapError aborting the whole train
            kw = pm.opt(self.params.keywords_attr)
            if isinstance(kw, dict):
                # weighted form (the KDD-cup data's keyword → weight map)
                out[entity] = {
                    str(k): float(v) for k, v in kw.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)
                }
            elif isinstance(kw, (list, tuple)):
                # bare keyword list: uniform weight 1.0
                out[entity] = {str(k): 1.0 for k in kw}
            else:
                out[entity] = {}
        return out

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        edges: List[Tuple[str, str]] = []
        for ev in EventStore.find(
                app_name=self.params.app_name,
                event_names=self.params.edge_events):
            if ev.target_entity_id:
                edges.append((f"{ev.entity_type}:{ev.entity_id}",
                              f"{ev.target_entity_type}:{ev.target_entity_id}"))
        return TrainingData(
            user_keywords=self._keywords(self.params.user_entity),
            item_keywords=self._keywords(self.params.item_entity),
            edges=edges,
            user_entity=self.params.user_entity,
            item_entity=self.params.item_entity,
        )


@dataclasses.dataclass(frozen=True)
class KeywordSimilarityAlgoParams(Params):
    __camel_case__ = True

    #: the reference's (untrained) defaults
    #: (KeywordSimilarityAlgorithm.scala:36-37)
    sim_weight: float = 1.0
    sim_threshold: float = 1.0


@dataclasses.dataclass
class KeywordSimilarityModel:
    user_keywords: Dict[str, Dict[str, float]]
    item_keywords: Dict[str, Dict[str, float]]
    sim_weight: float
    sim_threshold: float


class KeywordSimilarityAlgorithm(Algorithm):
    params_class = KeywordSimilarityAlgoParams
    query_class_ = Query

    def __init__(self, params: KeywordSimilarityAlgoParams =
                 KeywordSimilarityAlgoParams()):
        super().__init__(params)

    def train(self, ctx: RuntimeContext,
              td: TrainingData) -> KeywordSimilarityModel:
        return KeywordSimilarityModel(
            user_keywords=td.user_keywords,
            item_keywords=td.item_keywords,
            sim_weight=self.params.sim_weight,
            sim_threshold=self.params.sim_threshold,
        )

    def predict(self, model: KeywordSimilarityModel,
                query: Query) -> Prediction:
        u = model.user_keywords.get(query.user)
        i = model.item_keywords.get(query.item)
        confidence = 0.0
        if u and i:
            # findKeywordSimilarity: Σ w_u(t) · w_i(t)
            small, big = (u, i) if len(u) <= len(i) else (i, u)
            confidence = sum(w * big.get(t, 0.0) for t, w in small.items())
        return Prediction(
            confidence=confidence,
            acceptance=confidence * model.sim_weight
            >= model.sim_threshold,
        )


@dataclasses.dataclass(frozen=True)
class RandomAlgoParams(Params):
    __camel_case__ = True

    seed: int = 3
    acceptance_threshold: float = 0.5


@dataclasses.dataclass
class RandomModel:
    seed: int
    threshold: float


class RandomAlgorithm(Algorithm):
    """The baseline (RandomAlgorithm.scala / RandomModel.scala): a seeded
    uniform confidence, deterministic per (user, item)."""

    params_class = RandomAlgoParams
    query_class_ = Query

    def __init__(self, params: RandomAlgoParams = RandomAlgoParams()):
        super().__init__(params)

    def train(self, ctx: RuntimeContext, td: TrainingData) -> RandomModel:
        return RandomModel(seed=self.params.seed,
                           threshold=self.params.acceptance_threshold)

    def predict(self, model: RandomModel, query: Query) -> Prediction:
        # stable across processes: Python's str hash is salted per
        # interpreter, which would break the seeded-determinism contract
        key = f"{model.seed}\x00{query.user}\x00{query.item}".encode()
        rng = np.random.default_rng(zlib.crc32(key))
        confidence = float(rng.random())
        return Prediction(confidence=confidence,
                          acceptance=confidence >= model.threshold)


@dataclasses.dataclass(frozen=True)
class SimRankAlgoParams(Params):
    __camel_case__ = True

    decay: float = 0.8          # DeltaSimRankRDD.scala:31
    iterations: int = 7
    acceptance_threshold: float = 0.01


@dataclasses.dataclass
class SimRankModel:
    similarities: np.ndarray    # [N, N] f32, host
    node_index: Dict[str, int]
    threshold: float
    user_entity: str = "user"
    item_entity: str = "item"


class SimRankAlgorithm(Algorithm):
    params_class = SimRankAlgoParams
    query_class_ = Query

    def __init__(self, params: SimRankAlgoParams = SimRankAlgoParams()):
        super().__init__(params)

    def train(self, ctx: RuntimeContext, td: TrainingData) -> SimRankModel:
        nodes = sorted({n for e in td.edges for n in e})
        index = {n: k for k, n in enumerate(nodes)}
        if not nodes:
            return SimRankModel(
                similarities=np.zeros((0, 0), np.float32),
                node_index={}, threshold=self.params.acceptance_threshold,
                user_entity=td.user_entity, item_entity=td.item_entity)
        src = np.array([index[a] for a, _ in td.edges], np.int64)
        dst = np.array([index[b] for _, b in td.edges], np.int64)
        sims = simrank(src, dst, len(nodes), decay=self.params.decay,
                       iterations=self.params.iterations, device=ctx.device)
        return SimRankModel(similarities=sims, node_index=index,
                            threshold=self.params.acceptance_threshold,
                            user_entity=td.user_entity,
                            item_entity=td.item_entity)

    def predict(self, model: SimRankModel, query: Query) -> Prediction:
        a = model.node_index.get(f"{model.user_entity}:{query.user}")
        b = model.node_index.get(f"{model.item_entity}:{query.item}")
        if b is None:
            b = model.node_index.get(f"{model.user_entity}:{query.item}")
        confidence = 0.0
        if a is not None and b is not None:
            confidence = float(model.similarities[a, b])
        return Prediction(confidence=confidence,
                          acceptance=confidence >= model.threshold)


class FriendRecommendationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            FriendRecommendationDataSource,
            IdentityPreparator,
            {
                "keyword": KeywordSimilarityAlgorithm,
                "random": RandomAlgorithm,
                "simrank": SimRankAlgorithm,
            },
            FirstServing,
        )
