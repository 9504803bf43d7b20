"""Similar-product engine: implicit ALS factors on the card, item-to-item
cosine ranking through the score+top-k kernel.

Port of incubator_predictionio_tpu/models/similarproduct/engine.py
(:69-180 the data source and preparator, :213-358 training, the MIPS
index and deploy, :360-438 the speed overlay, :440-566 serving, :568-636
DIMSUM). Reference parity (examples/scala-parallel-similarproduct/multi/):

- ``Query(items, num, categories?, whiteList?, blackList?)`` /
  ``PredictedResult(itemScores)`` (Engine.scala:23-38).
- The data source reads weighted ``view`` / ``like`` user→item events in
  columnar form plus the items' ``$set`` categories; the preparator sums
  the weights of repeated (user, item) pairs.
- ``SimilarProductAlgorithm`` trains implicit ALS (``ops/als.
  als_train_implicit``: every bucket on the fused kernel with the shared
  YᵀY) and keeps unit-normalized item factors, so cosine ranking is an
  inner product. A query is the normalized mean of its items' vectors,
  scored against the whole table by ``ops/topk.score_and_top_k`` (the
  score+top-k kernel, or the two-stage MIPS route where an index serves
  the table): filtered queries with an item mask, plain ones with the
  query items' rows (and their virtual ids) as a padded exclusion list.
- A second ``pio train`` continues from the stored unit-norm item factors
  (``ops/retrain.als_retrain(implicit=True)``), seeding the item side
  only: the user half-sweep recovers the scale in its first sweep.
- The speed overlay folds new items in on the item side
  (``key_side="target"``): a brand-new item's row is one implicit solve
  of its events against the frozen user factors, normalized. Its
  ``index_sink`` publishes each fold-in into the MIPS index the moment it
  publishes: a known item's row re-quantized, a new item under a virtual
  id that ``predict`` resolves back to its key.
- ``DIMSUMAlgorithm`` (the similarproduct-dimsum variant) keeps each
  item's exact top-N cosine neighbours (``ops/dimsum.py``) and sums their
  similarities over the query items on the host, as the JAX package does.

Where the port differs on purpose (ROADMAP fact 5): a failed MIPS build
raises, where the JAX package logs it and serves exhaustively, and the
host mirror of small models (``ops/host_serving``) is not ported, so
every query takes the kernel. Not ported: mesh-sharded training
(``placement_for_ctx`` / ``als_train_placed``, ROADMAP.md Queue 1 item
9); the port's context carries no mesh to ask for it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Tuple

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
from incubator_predictionio_tpu_torch.ops import als, mips, retrain
from incubator_predictionio_tpu_torch.ops.topk import (
    pad_exclude,
    score_and_top_k,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Query:
    __camel_case__ = True

    items: Tuple[str, ...]
    num: int
    categories: Optional[Tuple[str, ...]] = None
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class ItemScore:
    __camel_case__ = True

    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    __camel_case__ = True

    item_scores: Tuple[ItemScore, ...]


@dataclasses.dataclass(frozen=True)
class ViewEvent:
    user: str
    item: str
    weight: float


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    __camel_case__ = True

    app_name: str
    channel_name: Optional[str] = None
    #: event name -> implicit weight (the multi variant weighs likes > views)
    event_weights: Tuple[Tuple[str, float], ...] = (("view", 1.0),
                                                    ("like", 3.0))


@dataclasses.dataclass
class TrainingData(SanityCheck):
    views: Optional[List[ViewEvent]] = None   # hand-built fixtures
    item_categories: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    interactions: Optional[Interactions] = None  # the columnar scan

    def __len__(self) -> int:
        if self.interactions is not None:
            return len(self.interactions)
        return len(self.views or [])

    def sanity_check(self) -> None:
        if not len(self):
            raise ValueError("TrainingData has no view events")


class SimilarProductDataSource(DataSource):
    """Weighted user→item events of ``app_name`` (``event_weights``) and
    the items' ``$set`` categories (JAX :116-140)."""

    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        weights = dict(self.params.event_weights)
        inter = EventStore.interactions(
            app_name=self.params.app_name,
            channel_name=self.params.channel_name,
            entity_type="user",
            target_entity_type="item",
            event_names=tuple(weights),
            event_values={k: float(v) for k, v in weights.items()},
        )
        props = EventStore.aggregate_properties(
            app_name=self.params.app_name,
            channel_name=self.params.channel_name,
            entity_type="item",
        )
        cats = {
            item: tuple(str(c) for c in (pm.opt("categories", list) or ()))
            for item, pm in props.items()
        }
        return TrainingData(interactions=inter, item_categories=cats)


@dataclasses.dataclass
class PreparedData:
    users: np.ndarray
    items: np.ndarray
    weights: np.ndarray
    user_bimap: BiMap
    item_bimap: BiMap
    item_categories: Dict[str, Tuple[str, ...]]


class SimilarProductPreparator(Preparator):
    def prepare(self, ctx: RuntimeContext, td: TrainingData) -> PreparedData:
        if td.interactions is not None:
            return self._prepare_columnar(td)
        user_bimap = BiMap.string_int(v.user for v in td.views)
        item_bimap = BiMap.string_int(v.item for v in td.views)
        # repeated (user, item) weights add: repeated views add confidence
        agg: Dict[Tuple[int, int], float] = {}
        for v in td.views:
            key = (user_bimap[v.user], item_bimap[v.item])
            agg[key] = agg.get(key, 0.0) + v.weight
        coo = np.array([(u, i, w) for (u, i), w in agg.items()],
                       np.float64).reshape(-1, 3)
        return PreparedData(
            users=coo[:, 0].astype(np.int32),
            items=coo[:, 1].astype(np.int32),
            weights=coo[:, 2].astype(np.float32),
            user_bimap=user_bimap,
            item_bimap=item_bimap,
            item_categories=td.item_categories,
        )

    def _prepare_columnar(self, td: TrainingData) -> PreparedData:
        """Vectorized weight summation over the columnar scan: repeated
        events of a (user, item) pair sum their weights, in f64."""
        inter = td.interactions
        n_items = max(len(inter.item_ids), 1)
        keys = inter.user_idx.astype(np.int64) * n_items \
            + inter.item_idx.astype(np.int64)
        uniq, inverse = np.unique(keys, return_inverse=True)
        sums = np.zeros(len(uniq), np.float64)
        np.add.at(sums, inverse, inter.values.astype(np.float64))
        return PreparedData(
            users=(uniq // n_items).astype(np.int32),
            items=(uniq % n_items).astype(np.int32),
            weights=sums.astype(np.float32),
            user_bimap=BiMap({u: i for i, u in enumerate(inter.user_ids)}),
            item_bimap=BiMap({t: i for i, t in enumerate(inter.item_ids)}),
            item_categories=td.item_categories,
        )


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    __camel_case__ = True

    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None


@dataclasses.dataclass
class SimilarProductModel:
    #: unit-normalized item factors [I, K] — cosine becomes a dot product
    item_factors_norm: Any
    item_bimap: BiMap
    item_categories: Dict[str, Tuple[str, ...]]
    #: frozen user factors + index for the speed layer's item-side
    #: fold-in; None on a checkpoint that has none (no overlay then)
    user_factors: Any = None
    user_bimap: Optional[BiMap] = None


def _unit_rows(factors: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(factors, dim=1, keepdim=True)
    return factors / torch.clamp(norm, min=1e-9)


def _put(t, device) -> torch.Tensor:
    return torch.as_tensor(t).to(device=device,
                                 dtype=torch.float32).contiguous()


class SimilarProductAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams
    query_class_ = Query

    def __init__(self, params: ALSAlgorithmParams = ALSAlgorithmParams()):
        super().__init__(params)

    def _seed(self, ctx: RuntimeContext) -> int:
        return self.params.seed if self.params.seed is not None else ctx.seed

    def train(self, ctx: RuntimeContext,
              pd: PreparedData) -> SimilarProductModel:
        """Implicit ALS on ``ctx.device`` (JAX :213-257), the item
        factors unit-normalized, then the MIPS index where it applies."""
        state = als.als_train_implicit(
            pd.users, pd.items, pd.weights,
            n_users=len(pd.user_bimap), n_items=len(pd.item_bimap),
            rank=self.params.rank, iterations=self.params.num_iterations,
            l2=self.params.lambda_, alpha=self.params.alpha,
            seed=self._seed(ctx), device=ctx.device, stats=ctx.timings)
        return self._assemble_model(pd, state)

    def _assemble_model(self, pd: PreparedData,
                        state: als.ALSState) -> SimilarProductModel:
        model = SimilarProductModel(
            item_factors_norm=_unit_rows(state.item_factors),
            item_bimap=pd.item_bimap,
            item_categories=pd.item_categories,
            user_factors=state.user_factors,
            user_bimap=pd.user_bimap,
        )
        self._refresh_mips_index(model)
        return model

    def _refresh_mips_index(self, model: SimilarProductModel) -> None:
        """Two-stage MIPS index over the unit-normalized serving table
        (JAX :259-278), gated by ``PIO_SERVE_MIPS`` and the auto floor.
        Always a full build: normalization rescales every row each
        retrain, so there is no O(delta) splice. Unlike the JAX package,
        which logs a failed build and serves exhaustively, a failure
        raises (ROADMAP fact 5)."""
        n_items = len(model.item_bimap)
        if mips.build_enabled(n_items):
            mips.build_index(model.item_factors_norm, n_items,
                             seed=self.params.seed or 0, probe_recall=True,
                             engine="similarproduct")

    def train_with_previous(self, ctx: RuntimeContext, pd: PreparedData,
                            prev_model: Any) -> SimilarProductModel:
        """Continuation retrain (JAX :280-340): the stored model keeps
        only the unit-normalized item factors, so they seed the item side
        and the user side starts fresh. Another rank, or an item id space
        that is no longer a prefix, trains fresh. No prep plan is kept,
        as in the recommendation engine: each ``pio train`` is a new
        process."""
        prev_items = (prev_model.item_factors_norm
                      if isinstance(prev_model, SimilarProductModel)
                      else None)
        if (prev_items is None or prev_items.ndim != 2
                or prev_items.shape[1] != self.params.rank
                or not prev_model.item_bimap.is_index_prefix_of(
                    pd.item_bimap)):
            return self.train(ctx, pd)
        stats: Dict[str, Any] = {}
        state = retrain.als_retrain(
            pd.users, pd.items, pd.weights,
            n_users=len(pd.user_bimap), n_items=len(pd.item_bimap),
            rank=self.params.rank, iterations=self.params.num_iterations,
            l2=self.params.lambda_, alpha=self.params.alpha,
            seed=self._seed(ctx), implicit=True,
            prev_state=als.ALSState(
                user_factors=np.zeros((0, self.params.rank), np.float32),
                item_factors=prev_items),
            stats=stats, device=ctx.device)
        logger.info("similarproduct continuation retrain: %s sweeps "
                    "(mode=%s)", stats.get("sweeps_used"), stats.get("mode"))
        return self._assemble_model(pd, state)

    def prepare_model(self, ctx: RuntimeContext,
                      model: SimilarProductModel) -> SimilarProductModel:
        """Put the tables on ``ctx.device``, as contiguous f32. A model
        trained in this process keeps its MIPS index (adopted onto the put
        table, JAX :342-358); a restored one gets a new build."""
        prev_table = model.item_factors_norm
        model = dataclasses.replace(
            model, item_factors_norm=_put(prev_table, ctx.device),
            user_factors=(None if model.user_factors is None
                          else _put(model.user_factors, ctx.device)))
        if mips.adopt_index(prev_table, model.item_factors_norm) is None:
            self._refresh_mips_index(model)
        return model

    def make_speed_overlay(self, model: SimilarProductModel, app_name,
                           channel_name, data_source_params=None):
        """Item-side fold-in (JAX :360-438): a new (or dirty) item's row
        is solved from its weighted events against the frozen user
        factors, implicit, then unit-normalized. Its ``index_sink``
        publishes every fold-in into the serving table's MIPS index
        (``mips.publish_rows``) when one is registered: known rows are
        re-quantized and scored exactly from the tail, new items ride the
        tail under virtual ids that ``predict`` maps back to their keys.
        A model without user factors gets no overlay. The user table goes
        to the solver as the device tensor it is."""
        if (app_name is None or model.user_factors is None
                or model.user_bimap is None):
            return None
        from incubator_predictionio_tpu_torch.speed.overlay import (
            SpeedOverlay,
            SpeedOverlayConfig,
        )

        weights = dict(getattr(data_source_params, "event_weights", ())
                       or (("view", 1.0), ("like", 3.0)))

        def normalize(vec: np.ndarray) -> np.ndarray:
            return vec / max(float(np.linalg.norm(vec)), 1e-9)

        item_bimap = model.item_bimap
        serving_table = model.item_factors_norm
        #: virtual tail id <-> item key for published items the base
        #: bimap has never seen; the by-key side excludes a query item's
        #: own tail entry
        virtual_ids = self._mips_virtual_ids = {}
        virtual_by_key = self._mips_virtual_by_key = {}

        def index_sink(keys, vecs):
            if mips.index_for(serving_table) is None:
                return
            rows = [item_bimap.get(k, -1) for k in keys]
            gids = mips.publish_rows(serving_table, np.stack(vecs),
                                     rows=rows)
            if gids is not None:
                for key, row, gid in zip(keys, rows, gids):
                    if row < 0:
                        virtual_ids[int(gid)] = key
                        virtual_by_key[key] = int(gid)

        return SpeedOverlay(
            SpeedOverlayConfig(
                app_name=app_name, channel_name=channel_name,
                engine="similarproduct",
                entity_type="user", target_entity_type="item",
                event_names=tuple(weights),
                event_values={k: float(v) for k, v in weights.items()},
                key_side="target",
                l2=self.params.lambda_, implicit=True,
                alpha=self.params.alpha,
                transform=normalize,
            ),
            other_factors=model.user_factors,
            other_index=model.user_bimap,
            key_index=model.item_bimap,
            index_sink=index_sink,
        )

    def _allowed_mask(self, model, query: Query) -> np.ndarray:
        """Categories, white and black lists, and the query items
        themselves (always excluded, ALSAlgorithm.scala) as one [I] mask."""
        n = len(model.item_bimap)
        mask = np.ones(n, bool)
        if query.categories:
            wanted = set(query.categories)
            for item, idx in model.item_bimap.items():
                if not wanted.intersection(model.item_categories.get(item, ())):
                    mask[idx] = False
        if query.white_list:
            allowed = {
                model.item_bimap[i] for i in query.white_list
                if i in model.item_bimap
            }
            for idx in range(n):
                if idx not in allowed:
                    mask[idx] = False
        if query.black_list:
            for item in query.black_list:
                idx = model.item_bimap.get(item)
                if idx is not None:
                    mask[idx] = False
        for item in query.items:
            idx = model.item_bimap.get(item)
            if idx is not None:
                mask[idx] = False
        return mask

    def warmup(self, model: SimilarProductModel, max_batch: int = 1) -> None:
        """One real predict: the serving path's first launch at deploy."""
        first = next(iter(model.item_bimap), None)
        if first is not None:
            self.predict(model, Query(items=(str(first),), num=10))

    def _query_vector(self, model: SimilarProductModel,
                      query: Query) -> Optional[torch.Tensor]:
        """The query's unit vector on the table's device: the mean of its
        known items' rows and of the overlay's folded vectors for the
        rest, normalized; None when no query item is known to either."""
        ov = self.speed_overlay
        indices: List[int] = []
        extra_vecs: List[np.ndarray] = []
        for item in query.items:
            vec = ov.lookup(item) if ov is not None else None
            if vec is not None:
                extra_vecs.append(np.asarray(vec, np.float32))
            elif item in model.item_bimap:
                indices.append(model.item_bimap[item])
        if not indices and not extra_vecs:
            return None
        factors = model.item_factors_norm
        if indices:
            qv = factors[torch.as_tensor(indices, dtype=torch.long,
                                         device=factors.device)].sum(0)
        else:
            qv = torch.zeros(factors.shape[1], dtype=torch.float32,
                             device=factors.device)
        if extra_vecs:
            qv = qv + torch.from_numpy(
                np.sum(extra_vecs, axis=0, dtype=np.float32)).to(
                    factors.device)
        qv = qv / (len(indices) + len(extra_vecs))
        return qv / torch.clamp(torch.linalg.norm(qv), min=1e-9)

    def predict(self, model: SimilarProductModel,
                query: Query) -> PredictedResult:
        """Cosine top-``num`` of the query vector (JAX :466-566) through
        ``score_and_top_k``: a filtered query with its item mask; a plain
        one with the query items' rows and virtual ids as the exclusion
        list, so a registered MIPS index can serve it."""
        qv = self._query_vector(model, query)
        k = min(query.num, len(model.item_bimap))
        if qv is None or k <= 0:
            return PredictedResult(item_scores=())
        factors = model.item_factors_norm
        if query.categories or query.white_list or query.black_list:
            packed = score_and_top_k(
                qv, factors, k=k,
                allowed_mask=torch.from_numpy(
                    self._allowed_mask(model, query)))
        else:
            virtual_by_key = getattr(self, "_mips_virtual_by_key",
                                     None) or {}
            seen = [model.item_bimap[i] for i in query.items
                    if i in model.item_bimap]
            seen += [virtual_by_key[i] for i in query.items
                     if i in virtual_by_key]
            packed = score_and_top_k(
                qv, factors, k=k, exclude=pad_exclude(seen, factors.device))
        packed = packed.cpu().numpy()
        inv = model.item_bimap.inverse
        n_known = len(model.item_bimap)
        virtual_ids = getattr(self, "_mips_virtual_ids", None) or {}
        out = []
        for s, i in zip(packed[0].tolist(), packed[1].astype(np.int64)):
            if s <= -1e37:
                continue
            # ids past the base bimap are overlay-published new items
            # served from the index's exact tail
            item = inv[int(i)] if int(i) < n_known \
                else virtual_ids.get(int(i))
            if item is not None:
                out.append(ItemScore(item=item, score=float(s)))
        return PredictedResult(item_scores=tuple(out))


@dataclasses.dataclass(frozen=True)
class DIMSUMAlgorithmParams(Params):
    __camel_case__ = True

    #: minimum cosine similarity kept (columnSimilarities(threshold))
    threshold: float = 0.1
    #: neighbors stored per item — the model is [I, topN], not [I, I]
    top_n: int = 100


@dataclasses.dataclass
class DIMSUMModel:
    sim_scores: np.ndarray    # [I, T] f32, 0 where absent
    sim_indices: np.ndarray   # [I, T] int32
    item_bimap: BiMap
    item_categories: Dict[str, Tuple[str, ...]]


class DIMSUMAlgorithm(Algorithm):
    """Exact item-item cosine similarity (the similarproduct-dimsum
    variant, DIMSUMAlgorithm.scala:118-145; JAX :568-636): the Gram on
    ``ctx.device`` (``ops/dimsum.py``), the model each item's top-N
    neighbours. Prediction sums similarity over the query items on the
    host (indexScores groupBy-sum, :168)."""

    params_class = DIMSUMAlgorithmParams
    query_class_ = Query

    def __init__(self,
                 params: DIMSUMAlgorithmParams = DIMSUMAlgorithmParams()):
        super().__init__(params)

    def train(self, ctx: RuntimeContext, pd: PreparedData) -> DIMSUMModel:
        from incubator_predictionio_tpu_torch.ops.dimsum import (
            column_cosine_topk,
        )

        scores, indices = column_cosine_topk(
            pd.users, pd.items, pd.weights, n_items=len(pd.item_bimap),
            threshold=self.params.threshold, top_n=self.params.top_n,
            device=ctx.device)
        return DIMSUMModel(sim_scores=scores, sim_indices=indices,
                           item_bimap=pd.item_bimap,
                           item_categories=pd.item_categories)

    # filters are the ALS variant's (same Query contract)
    _allowed_mask = SimilarProductAlgorithm._allowed_mask

    def predict(self, model: DIMSUMModel, query: Query) -> PredictedResult:
        indices = [
            model.item_bimap[i] for i in query.items if i in model.item_bimap
        ]
        if not indices:
            return PredictedResult(item_scores=())
        n = len(model.item_bimap)
        acc = np.zeros(n, np.float32)
        for qi in indices:
            np.add.at(acc, model.sim_indices[qi], model.sim_scores[qi])
        acc[~self._allowed_mask(model, query)] = 0.0
        k = min(query.num, n)
        top = np.argsort(-acc, kind="stable")[:k]
        inv = model.item_bimap.inverse
        return PredictedResult(item_scores=tuple(
            ItemScore(item=inv[int(i)], score=float(acc[i]))
            for i in top if acc[i] > 0.0
        ))


class SimilarProductEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            SimilarProductDataSource,
            SimilarProductPreparator,
            {"als": SimilarProductAlgorithm, "dimsum": DIMSUMAlgorithm},
            FirstServing,
        )
