"""The e-commerce recommendation engine: implicit ALS on the card, serving
with business rules and the speed layer's implicit fold-in.

Port of incubator_predictionio_tpu/models/ecommerce/engine.py. Reference
parity (examples/scala-parallel-ecommercerecommendation/
train-with-rate-event + adjust-score + weighted-items variants):

- ``Query(user, num, categories?, whiteList?, blackList?)`` /
  ``PredictedResult(itemScores)`` (Engine.scala:23-38).
- The data source reads weighted ``view``/``buy``/``rate`` user→item
  events in columnar form, and the items' ``$set`` categories; the
  preparator sums the weights of repeated (user, item) pairs.
- ECommAlgorithm trains implicit ALS (``ops/als.als_train_implicit``:
  every bucket on the fused kernel with the shared YᵀY) and continues
  from the last instance on a second ``pio train``
  (``ops/retrain.als_retrain(implicit=True)``). At serve time it drops
  *unavailable items* (the ``constraint`` entity's ``unavailableItems``),
  weighs ``weightedItems``, and filters seen items, black/whitelists and
  categories.
- A user's scores come from, in order: the speed overlay's folded-in
  vector (the exact implicit fold-in of the user's events since
  training), the model's row, the mean of the user's recent views'
  factors (ECommAlgorithm.scala recentFeatures), item popularity.

Not ported: mesh-sharded training (``placement_for_ctx`` /
``als_train_placed``, ROADMAP.md Queue 1 item 9) and the host mirror of
small models (``ops/host_serving``, left out on purpose: on the card it
would hide the device path). The seen sets of training are read by the
columnar scan rather than one ``Event`` object per event; the sets are
the same.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    FirstServing,
    Params,
    Preparator,
)
from incubator_predictionio_tpu_torch.core.engine import Engine, EngineFactory
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.data.interactions import Interactions
from incubator_predictionio_tpu_torch.data.store import EventStore
from incubator_predictionio_tpu_torch.ops import als, retrain
from incubator_predictionio_tpu_torch.ops.topk import top_k_with_exclusions
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.speed.cache import (
    TTLCache,
    serve_cache_ttl,
    store_version,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Query:
    __camel_case__ = True

    user: str
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
class DataSourceParams(Params):
    __camel_case__ = True

    app_name: str
    channel_name: Optional[str] = None
    event_weights: Tuple[Tuple[str, float], ...] = (
        ("view", 1.0), ("buy", 4.0), ("rate", 2.0),
    )


@dataclasses.dataclass(frozen=True)
class Interaction:
    user: str
    item: str
    weight: float


@dataclasses.dataclass
class TrainingData:
    interactions: Optional[List[Interaction]] = None  # fixture form
    item_categories: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    columnar: Optional[Interactions] = None           # the store's scan

    def __len__(self) -> int:
        if self.columnar is not None:
            return len(self.columnar)
        return len(self.interactions or [])

    def sanity_check(self) -> None:
        if not len(self):
            raise ValueError("TrainingData has no user-item interactions")


class ECommerceDataSource(DataSource):
    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        weights = dict(self.params.event_weights)
        columnar = EventStore.interactions(
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
        return TrainingData(columnar=columnar, item_categories=cats)


@dataclasses.dataclass
class PreparedData:
    users: np.ndarray
    items: np.ndarray
    weights: np.ndarray
    user_bimap: BiMap
    item_bimap: BiMap
    item_categories: Dict[str, Tuple[str, ...]]


class ECommercePreparator(Preparator):
    def prepare(self, ctx: RuntimeContext, td: TrainingData) -> PreparedData:
        if td.columnar is not None:
            return self._prepare_columnar(td)
        user_bimap = BiMap.string_int(i.user for i in td.interactions)
        item_bimap = BiMap.string_int(i.item for i in td.interactions)
        agg: Dict[Tuple[int, int], float] = {}
        for i in td.interactions:
            key = (user_bimap[i.user], item_bimap[i.item])
            agg[key] = agg.get(key, 0.0) + i.weight
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
        inter = td.columnar
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
class ECommAlgorithmParams(Params):
    __camel_case__ = True

    app_name: str
    channel_name: Optional[str] = None
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None
    #: events counted as "seen" and excluded from results
    seen_events: Tuple[str, ...] = ("buy", "view")
    unseen_only: bool = True
    #: recent events used to build an unknown user's vector
    similar_events: Tuple[str, ...] = ("view",)
    num_recent_events: int = 10


@dataclasses.dataclass
class ECommModel:
    user_factors: Any
    item_factors: Any
    user_bimap: BiMap
    item_bimap: BiMap
    item_categories: Dict[str, Tuple[str, ...]]
    user_seen: Dict[int, Any]
    #: popularity ranks (interaction counts) for the cold fallback
    item_popularity: Any


class ECommAlgorithm(Algorithm):
    params_class = ECommAlgorithmParams
    query_class_ = Query

    def __init__(self, params: ECommAlgorithmParams):
        super().__init__(params)
        # bounded TTL micro-caches in front of the serve-time storage
        # reads (speed/cache.py): the recent-events read per user,
        # versioned by the overlay's per-user event version; the
        # constraint read one shared entry, versioned by the store's
        # write cursor
        ttl = serve_cache_ttl()
        self._recent_cache = TTLCache(maxsize=4096, ttl_s=ttl)
        self._constraint_cache = TTLCache(maxsize=4, ttl_s=ttl)

    def make_speed_overlay(self, model: ECommModel, app_name,
                           channel_name, data_source_params=None):
        """Implicit fold-in over the frozen item factors, the exact
        Hu-Koren-Volinsky row solve (α, plain λ, the shared YᵀY), with
        the training read's weighted events. The item table goes to the
        solver as the device tensor it is."""
        if app_name is None:
            return None
        from incubator_predictionio_tpu_torch.speed.overlay import (
            SpeedOverlay,
            SpeedOverlayConfig,
        )

        weights = dict(getattr(data_source_params, "event_weights", ())
                       or (("view", 1.0), ("buy", 4.0), ("rate", 2.0)))
        return SpeedOverlay(
            SpeedOverlayConfig(
                app_name=app_name, channel_name=channel_name,
                engine="ecommerce",
                entity_type="user", target_entity_type="item",
                event_names=tuple(weights),
                event_values={k: float(v) for k, v in weights.items()},
                key_side="entity",
                l2=self.params.lambda_, implicit=True,
                alpha=self.params.alpha,
            ),
            other_factors=model.item_factors,
            other_index=model.item_bimap,
            key_index=model.user_bimap,
        )

    def train(self, ctx: RuntimeContext, pd: PreparedData) -> ECommModel:
        """Implicit ALS on ``ctx.device`` (``ops/als.als_train_implicit``),
        seeded by the params' seed or else the context's."""
        seed = self.params.seed if self.params.seed is not None else ctx.seed
        state = als.als_train_implicit(
            pd.users, pd.items, pd.weights,
            n_users=len(pd.user_bimap), n_items=len(pd.item_bimap),
            rank=self.params.rank, iterations=self.params.num_iterations,
            l2=self.params.lambda_, alpha=self.params.alpha, seed=seed,
            device=ctx.device, stats=ctx.timings)
        return self._assemble_model(pd, state)

    def train_with_previous(
        self, ctx: RuntimeContext, pd: PreparedData, prev_model: Any
    ) -> ECommModel:
        """Continuation retrain (JAX :299-345): both factor tables seed
        from the previous model when both BiMaps are exact index prefixes
        of the new PreparedData's and the rank is unchanged; otherwise a
        fresh train. No prep plan is kept, as in the recommendation
        engine: each ``pio train`` is a new process."""
        uf = prev_model.user_factors if isinstance(prev_model,
                                                   ECommModel) else None
        ok = (uf is not None and uf.ndim == 2
              and uf.shape[1] == self.params.rank
              and prev_model.user_bimap.is_index_prefix_of(pd.user_bimap)
              and prev_model.item_bimap.is_index_prefix_of(pd.item_bimap))
        if not ok:
            return self.train(ctx, pd)
        seed = self.params.seed if self.params.seed is not None else ctx.seed
        stats: Dict[str, Any] = {}
        state = retrain.als_retrain(
            pd.users, pd.items, pd.weights,
            n_users=len(pd.user_bimap), n_items=len(pd.item_bimap),
            rank=self.params.rank, iterations=self.params.num_iterations,
            l2=self.params.lambda_, alpha=self.params.alpha, seed=seed,
            implicit=True,
            prev_state=als.ALSState(user_factors=prev_model.user_factors,
                                    item_factors=prev_model.item_factors),
            stats=stats, device=ctx.device)
        logger.info("ecommerce continuation retrain: %s sweeps (mode=%s)",
                    stats.get("sweeps_used"), stats.get("mode"))
        return self._assemble_model(pd, state)

    def _assemble_model(self, pd: PreparedData, state) -> ECommModel:
        """The model: factors, BiMaps, categories, each user's seen items
        (only ``seen_events`` make an item seen, so a viewed-but-unbought
        item stays recommendable under ``seen_events=("buy",)``) and the
        items' weight sums as popularity."""
        seen_raw = EventStore.interactions(
            app_name=self.params.app_name,
            channel_name=self.params.channel_name,
            entity_type="user", target_entity_type="item",
            event_names=tuple(self.params.seen_events),
            event_values={e: 1.0 for e in self.params.seen_events})
        u_map = np.asarray([pd.user_bimap.get(u, -1)
                            for u in seen_raw.user_ids] or [-1], np.int64)
        i_map = np.asarray([pd.item_bimap.get(i, -1)
                            for i in seen_raw.item_ids] or [-1], np.int64)
        su, si = u_map[seen_raw.user_idx], i_map[seen_raw.item_idx]
        keep = (su >= 0) & (si >= 0)
        pairs = np.unique(su[keep] * max(len(pd.item_bimap), 1) + si[keep])
        pu = pairs // max(len(pd.item_bimap), 1)
        pi = (pairs % max(len(pd.item_bimap), 1)).astype(np.int32)
        starts = np.flatnonzero(np.r_[True, pu[1:] != pu[:-1]]) \
            if len(pu) else np.empty(0, np.int64)
        user_seen = {int(u): s for u, s in
                     zip(pu[starts], np.split(pi, starts[1:]))}
        popularity = np.zeros(len(pd.item_bimap), np.float32)
        np.add.at(popularity, pd.items, pd.weights)
        return ECommModel(
            user_factors=state.user_factors,
            item_factors=state.item_factors,
            user_bimap=pd.user_bimap,
            item_bimap=pd.item_bimap,
            item_categories=pd.item_categories,
            user_seen=user_seen,
            item_popularity=popularity,
        )

    def prepare_model(self, ctx: RuntimeContext,
                      model: ECommModel) -> ECommModel:
        """Put the factors and the popularity on ``ctx.device``, as
        contiguous f32."""
        def put(t):
            return torch.as_tensor(t).to(
                device=ctx.device, dtype=torch.float32).contiguous()

        return dataclasses.replace(
            model, user_factors=put(model.user_factors),
            item_factors=put(model.item_factors),
            item_popularity=put(model.item_popularity))

    # -- serve-time constraints --------------------------------------------
    def _store_version(self):
        """The store's write cursor (speed/cache.py ``store_version``): a
        ``$set`` constraint flip lands on the very next query."""
        return store_version(self.params.app_name, self.params.channel_name)

    def _constraints(
        self, model: ECommModel
    ) -> Tuple[List[int], Optional[np.ndarray]]:
        """Constraint state through the TTL micro-cache: the storage
        aggregate runs once per write or TTL window."""
        return self._constraint_cache.get_or_load(
            "constraints", lambda: self._load_constraints(model),
            version=self._store_version())

    def _load_constraints(
        self, model: ECommModel
    ) -> Tuple[List[int], Optional[np.ndarray]]:
        """Re-read the ``constraint`` entities → (unavailable item
        indices, per-item weight multipliers or None).

        ``constraint/unavailableItems`` {items: [...]} drops items from
        results (ECommAlgorithm.scala predict), and
        ``constraint/weightedItems`` {weights: [{items: [...], weight: w}]}
        multiplies matching items' scores (weighted-items/
        ECommAlgorithm.scala:234-261; unlisted items weigh 1.0)."""
        try:
            props = EventStore.aggregate_properties(
                app_name=self.params.app_name,
                channel_name=self.params.channel_name,
                entity_type="constraint",
            )
        except Exception:
            logger.warning(
                "ecommerce: constraint lookup failed for app %r; "
                "serving without unavailable-item/weight constraints",
                self.params.app_name, exc_info=True,
            )
            return [], None
        unavailable: List[int] = []
        pm = props.get("unavailableItems")
        if pm is not None:
            names = pm.opt("items", list) or []
            unavailable = [
                model.item_bimap[n] for n in names if n in model.item_bimap
            ]
        weights: Optional[np.ndarray] = None
        wm = props.get("weightedItems")
        if wm is not None:
            # ops-authored data: one malformed group degrades to weight
            # 1.0, never a failed query
            groups = wm.opt("weights", list) or []
            weights = np.ones(len(model.item_bimap), np.float32)
            for group in groups:
                try:
                    w = float(group.get("weight", 1.0))
                    items = group.get("items", ())
                    if isinstance(items, str):
                        raise TypeError("items must be a list, not a string")
                    for name in items:
                        idx = model.item_bimap.get(name)
                        if idx is not None:
                            weights[idx] = w
                except Exception:
                    logger.warning(
                        "ecommerce: malformed weightedItems group %r "
                        "ignored", group, exc_info=True)
        return unavailable, weights

    def _user_version(self, user: str):
        """The micro-caches' version of a user's reads: the overlay's
        per-user event version when an overlay is attached (other users'
        writes do not invalidate), else the store's write cursor."""
        ov = self.speed_overlay
        return (("u", ov.key_version(user)) if ov is not None
                else ("s", self._store_version()))

    def _recent_items(self, model: ECommModel, user: str) -> List[int]:
        """Recent-event item indices of one user, via the micro-cache."""
        return self._recent_cache.get_or_load(
            ("recent", user),
            lambda: self._load_recent_items(model, user),
            version=self._user_version(user))

    def _seen_item_indices(self, model: ECommModel, user: str) -> List[int]:
        """Seen-item indices of a user read from the store (the overlay
        users: the model's seen sets miss what they did since training),
        via the micro-cache."""
        def load() -> List[int]:
            try:
                events = EventStore.find_by_entity(
                    app_name=self.params.app_name,
                    channel_name=self.params.channel_name,
                    entity_type="user",
                    entity_id=user,
                    event_names=list(self.params.seen_events),
                )
            except Exception:
                logger.warning(
                    "ecommerce: seen-event lookup failed for user %r; "
                    "serving without the seen filter", user, exc_info=True)
                return []
            out = set()
            for e in events:
                idx = (model.item_bimap.get(e.target_entity_id)
                       if e.target_entity_id else None)
                if idx is not None:
                    out.add(int(idx))
            return sorted(out)

        return self._recent_cache.get_or_load(
            ("seen", user), load, version=self._user_version(user))

    def _load_recent_items(self, model: ECommModel, user: str) -> List[int]:
        try:
            events = EventStore.find_by_entity(
                app_name=self.params.app_name,
                channel_name=self.params.channel_name,
                entity_type="user",
                entity_id=user,
                event_names=list(self.params.similar_events),
                limit=self.params.num_recent_events,
                latest=True,
            )
        except Exception:
            logger.warning(
                "ecommerce: recent-event lookup failed for app %r user %r; "
                "falling back to popularity ranking",
                self.params.app_name, user, exc_info=True,
            )
            return []
        out = []
        for e in events:
            if e.target_entity_id and e.target_entity_id in model.item_bimap:
                out.append(model.item_bimap[e.target_entity_id])
        return out

    def _allowed_mask(self, model: ECommModel, query: Query,
                      user_idx: Optional[int],
                      unavailable: Sequence[int]) -> np.ndarray:
        n = len(model.item_bimap)
        mask = np.ones(n, bool)
        for idx in unavailable:
            mask[idx] = False
        if query.categories:
            wanted = set(query.categories)
            cats = model.item_categories
            for item, idx in model.item_bimap.items():
                if not wanted.intersection(cats.get(item, ())):
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
        if self.params.unseen_only and user_idx is not None:
            seen = model.user_seen.get(user_idx)
            if seen is not None and len(seen):
                mask[np.asarray(seen)] = False
        return mask

    def warmup(self, model: ECommModel, max_batch: int = 1) -> None:
        """One real predict of a known user."""
        first = next(iter(model.user_bimap), None)
        if first is not None:
            self.predict(model, Query(user=str(first), num=10))

    def _user_vector(self, model: ECommModel, query: Query,
                    ov_vec: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        """The query vector of the scoring ladder, on the model's device:
        the overlay's vector, else the model's row, else the mean of the
        recent views' factors; None (popularity) when there is none."""
        factors = model.item_factors
        if ov_vec is not None:
            return torch.from_numpy(np.asarray(ov_vec, np.float32)).to(
                factors.device)
        user_idx = model.user_bimap.get(query.user)
        if user_idx is not None:
            return model.user_factors[user_idx]
        recent = self._recent_items(model, query.user)
        if recent:
            return factors[torch.as_tensor(
                recent, dtype=torch.long, device=factors.device)].mean(0)
        return None

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        user_idx = model.user_bimap.get(query.user)
        unavailable, weights = self._constraints(model)
        mask = self._allowed_mask(model, query, user_idx, unavailable)
        k = min(query.num, len(model.item_bimap))
        # speed layer first: the exact fold-in replaces both a stale base
        # row and the averaged recent views; a miss falls through to the
        # ladder base row → recent average → popularity
        ov = self.speed_overlay
        ov_vec = ov.lookup(query.user) if ov is not None else None
        if ov_vec is not None and self.params.unseen_only:
            # the train-time seen set misses what this user did since:
            # the freshly read seen filter applies on the overlay path
            for idx in self._seen_item_indices(model, query.user):
                mask[idx] = False
        factors = model.item_factors
        vec = self._user_vector(model, query, ov_vec)
        scores = (torch.as_tensor(model.item_popularity,
                                  device=factors.device)
                  if vec is None else factors @ vec)
        if weights is not None:
            scores = scores * torch.from_numpy(weights).to(factors.device)
        top_s, top_i = top_k_with_exclusions(
            scores, k=max(k, 0), allowed_mask=torch.from_numpy(mask))
        inv = model.item_bimap.inverse
        out = []
        for s, i in zip(top_s.cpu().tolist(), top_i.cpu().tolist()):
            if s <= -1e37:
                continue
            out.append(ItemScore(item=inv[int(i)], score=float(s)))
        return PredictedResult(item_scores=tuple(out))


class ECommerceEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            ECommerceDataSource,
            ECommercePreparator,
            {"ecomm": ECommAlgorithm},
            FirstServing,
        )
