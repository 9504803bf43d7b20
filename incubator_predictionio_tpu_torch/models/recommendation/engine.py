"""The recommendation engine: ratings → BiMap reindex → ALS training on the
card → every query scored against the whole catalogue by the score+top-k
kernel.

Port of incubator_predictionio_tpu/models/recommendation/engine.py
(:54-85 query model, :95-193 data source, :252-313 preparator, :333-494
ALS training, :496-919 serving and factory). Reference parity
(examples/scala-parallel-recommendation/custom-query/):
``Query(user, num, creationYear?)`` / ``PredictedResult(itemScores)``
(Engine.scala:23-28); ALSAlgorithm trains with (rank, numIterations,
lambda, seed) (ALSAlgorithm.scala:25-31); the model keeps String↔Int
BiMaps next to the factors (ALSModel.scala); serving returns the first
algorithm's result.

The data source reads rate and buy events from the event store in columnar
form (``EventStore.interactions``) and the items' ``$set`` properties
(``creationYear``, ``categories``); the preparator's latest-wins dedup of
repeated (user, item) pairs runs on the context's device
(``ops/sparse.latest_wins``), with the same kept rows as the JAX package's
``np.unique``.

A second ``pio train`` with equal params continues from the last
instance (``ALSAlgorithm.train_with_previous``, JAX :418-474): warm
factors where the previous id space is a prefix of the new one, the
early stop, and the plan reuse of ``ops/retrain.py``.

A deployed model serves with the speed layer's overlay
(``make_speed_overlay``, JAX :567-594): a user whose events reached the
log after training is folded in on the fused ALS kernel, and ``predict``
scores the folded vector first, through the score+top-k kernel.

Past the two-stage floor (``ops/mips.build_enabled``) the item table
carries a MIPS index (ops/mips.py; JAX :415, :456, :505-562): built after
``train``, spliced O(delta) after a continuation retrain whose stats name
the touched item rows (else rebuilt), adopted by ``prepare_model`` when
the deployed table is the trained one's value-identical copy (else built
from it). ``ops/topk`` then routes unfiltered queries through it. Unlike
the JAX package, which logs a failed build and serves on exhaustively, a
failed build raises here.

``pio eval`` reads k folds (``read_eval``, JAX :195-236, with ``eval_k``
above 0): each fold's queries ask the top ``eval_queries_num`` of each
user with a held-out rating, ``exclude_seen`` on, so they take ``predict``
one by one (JAX :733), each a score+top-k launch with the user's training
items excluded; ``PrecisionAtK`` scores them against the held-out items.

Not ported yet: the sharded trainer and the host-mirror serving of small
models. The host mirror is left out on
purpose: on the card it would hide the kernel for small models, and on
the CPU the plain version already is the path.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    Params,
    Preparator,
    SanityCheck,
    Serving,
)
from incubator_predictionio_tpu_torch.core.engine import Engine, EngineFactory
from incubator_predictionio_tpu_torch.core.metrics import OptionAverageMetric
from incubator_predictionio_tpu_torch.core.self_cleaning import (
    EventWindow,
    SelfCleaningDataSource,
)
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.data.interactions import Interactions
from incubator_predictionio_tpu_torch.data.store import EventStore
from incubator_predictionio_tpu_torch.ops import als, mips, retrain
from incubator_predictionio_tpu_torch.ops.sparse import latest_wins
from incubator_predictionio_tpu_torch.ops.topk import (
    batch_score_top_k,
    ladder_rungs,
    pad_exclude,
    score_and_top_k,
    score_user_and_top_k,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Query / result model (Engine.scala:23-28)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Query:
    __camel_case__ = True  # wire format parity: creationYear, excludeSeen

    user: str
    num: int
    creation_year: Optional[int] = None  # custom-query variant filter
    categories: Optional[Tuple[str, ...]] = None  # filter-by-category variant
    whitelist: Optional[Tuple[str, ...]] = None
    blacklist: Optional[Tuple[str, ...]] = None
    exclude_seen: bool = False  # drop items the user already interacted with


@dataclasses.dataclass(frozen=True)
class ItemScore:
    __camel_case__ = True

    item: str
    score: float
    creation_year: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    __camel_case__ = True  # serves {"itemScores": [...]} like the reference

    item_scores: Tuple[ItemScore, ...]


@dataclasses.dataclass(frozen=True)
class Rating:
    user: str
    item: str
    rating: float


# ---------------------------------------------------------------------------
# Training data and data source (DataSource.scala:55-90)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    __camel_case__ = True  # engine.json parity: appName, eventWindow...

    app_name: str
    channel_name: Optional[str] = None
    buy_rating: float = 4.0  # implicit weight of a "buy" event
    eval_k: int = 0          # >0 enables k-fold read_eval
    eval_queries_num: int = 10
    event_window: Optional[str] = None  # SelfCleaningDataSource duration


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """Training set in columnar form (``interactions``, what the event
    store's scan gives) or, for hand-built fixtures, a ``ratings`` list."""

    ratings: Optional[List[Rating]] = None
    item_years: Dict[str, int] = dataclasses.field(default_factory=dict)
    item_categories: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    interactions: Optional[Interactions] = None

    def __len__(self) -> int:
        if self.interactions is not None:
            return len(self.interactions)
        return len(self.ratings or [])

    def sanity_check(self) -> None:
        if not len(self):
            raise ValueError(
                "TrainingData has no ratings — ingest rate/buy events first")


class RecommendationDataSource(DataSource, SelfCleaningDataSource):
    """Rate and buy events of ``app_name`` from the event store (JAX
    engine.py:145-193): a rate event gives its ``rating`` property (events
    without a numeric one are skipped, DataSource.scala:66-72), a buy event
    ``buy_rating``; items' ``creationYear`` and ``categories`` come from
    their aggregated ``$set`` properties. With ``event_window`` the app's
    events are cleaned first (SelfCleaningDataSource)."""

    def __init__(self, params: DataSourceParams):
        super().__init__(params)
        self.app_name = params.app_name
        self.channel_name = params.channel_name
        self.event_window = (EventWindow(duration=params.event_window)
                             if params.event_window else None)

    def _read_interactions(self) -> Interactions:
        return EventStore.interactions(
            app_name=self.params.app_name,
            channel_name=self.params.channel_name,
            entity_type="user",
            target_entity_type="item",
            event_names=("rate", "buy"),
            value_prop="rating",
            event_values={"buy": self.params.buy_rating},
        )

    def _read_item_meta(self) -> Tuple[Dict[str, int],
                                       Dict[str, Tuple[str, ...]]]:
        props = EventStore.aggregate_properties(
            app_name=self.params.app_name,
            channel_name=self.params.channel_name,
            entity_type="item",
        )
        years, cats = {}, {}
        for item_id, pm in props.items():
            year = pm.opt("creationYear", int)
            if year is not None:
                years[item_id] = year
            categories = pm.opt("categories", list)
            if categories:
                cats[item_id] = tuple(str(c) for c in categories)
        return years, cats

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        if self.event_window is not None:
            self.clean_persisted_events()
        years, cats = self._read_item_meta()
        return TrainingData(interactions=self._read_interactions(),
                            item_years=years, item_categories=cats)

    def read_eval(self, ctx: RuntimeContext):
        """k folds of the columnar read (e2 CrossValidation; JAX :195-236):
        triple n is held out of fold ``n % k``. A fold's queries ask the
        top ``eval_queries_num`` of each user with held-out triples, in
        user-id order, ``exclude_seen`` on; the actual is the sorted set
        of that user's held-out items."""
        k = self.params.eval_k
        if k <= 0:
            return []
        td = self.read_training(ctx)
        inter = td.interactions
        nnz = len(inter)
        out = []
        for fold in range(k):
            mask = (np.arange(nnz) % k) != fold
            train_inter = Interactions(
                user_idx=inter.user_idx[mask], item_idx=inter.item_idx[mask],
                values=inter.values[mask], user_ids=inter.user_ids,
                item_ids=inter.item_ids)
            by_user: Dict[str, set] = {}
            for u, i in zip(inter.user_idx[~mask].tolist(),
                            inter.item_idx[~mask].tolist()):
                by_user.setdefault(inter.user_ids[u], set()).add(
                    inter.item_ids[i])
            qa = [(Query(user=user, num=self.params.eval_queries_num,
                         exclude_seen=True),
                   ActualResult(items=tuple(sorted(items))))
                  for user, items in sorted(by_user.items())]
            out.append((TrainingData(interactions=train_inter,
                                     item_years=td.item_years,
                                     item_categories=td.item_categories),
                        EvalInfo(fold=fold), qa))
        return out


@dataclasses.dataclass(frozen=True)
class EvalInfo:
    fold: int


@dataclasses.dataclass(frozen=True)
class ActualResult:
    items: Tuple[str, ...]


# ---------------------------------------------------------------------------
# Preparator (Preparator.scala — reindex to dense COO)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PreparedData:
    users: np.ndarray           # [nnz] int32
    items: np.ndarray           # [nnz] int32
    ratings: np.ndarray         # [nnz] float32
    user_bimap: BiMap
    item_bimap: BiMap
    item_years: Dict[str, int]
    item_categories: Dict[str, Tuple[str, ...]]


class RecommendationPreparator(Preparator):
    """BiMap reindex + COO assembly. Duplicate (user, item) pairs keep the
    latest occurrence (the newest rating), the template's convention."""

    def prepare(self, ctx: RuntimeContext, td: TrainingData) -> PreparedData:
        if td.interactions is not None:
            return self._prepare_columnar(td, ctx.device)
        user_bimap = BiMap.string_int(r.user for r in td.ratings)
        item_bimap = BiMap.string_int(r.item for r in td.ratings)
        latest: Dict[Tuple[int, int], float] = {}
        for r in td.ratings:
            latest[(user_bimap[r.user], item_bimap[r.item])] = r.rating
        coo = np.array(
            [(u, i, v) for (u, i), v in latest.items()], dtype=np.float64
        ).reshape(-1, 3)
        return PreparedData(
            users=coo[:, 0].astype(np.int32),
            items=coo[:, 1].astype(np.int32),
            ratings=coo[:, 2].astype(np.float32),
            user_bimap=user_bimap, item_bimap=item_bimap,
            item_years=td.item_years, item_categories=td.item_categories)

    @staticmethod
    def _prepare_columnar(td: TrainingData, device) -> PreparedData:
        """Vectorized reindex: the ids are already interned, so the BiMaps
        are table views; the latest-wins dedup runs on ``device``
        (``ops/sparse.latest_wins``: the last occurrence of each (user,
        item) pair, in scan order, which is event-time order)."""
        inter = td.interactions
        user_bimap = BiMap({u: i for i, u in enumerate(inter.user_ids)})
        item_bimap = BiMap({t: i for i, t in enumerate(inter.item_ids)})
        keep = latest_wins(inter.user_idx, inter.item_idx,
                           len(inter.item_ids), device)
        return PreparedData(
            users=inter.user_idx[keep], items=inter.item_idx[keep],
            ratings=inter.values[keep],
            user_bimap=user_bimap, item_bimap=item_bimap,
            item_years=td.item_years, item_categories=td.item_categories)


# ---------------------------------------------------------------------------
# ALS algorithm (ALSAlgorithm.scala:25-31 → ops/als.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    __camel_case__ = True  # engine.json parity: numIterations, lambda

    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: Optional[int] = None
    #: mixed-precision schedule: this many early sweeps gather from a bf16
    #: table before the f32 polish sweeps (ops/als.py ``_mixed_run``);
    #: 0 = all f32 (MLlib parity)
    bf16_sweeps: int = 0


@dataclasses.dataclass
class ALSModel:
    user_factors: torch.Tensor  # [U, K] f32
    item_factors: torch.Tensor  # [I, K] f32
    user_bimap: BiMap
    item_bimap: BiMap
    item_years: Dict[str, int]
    item_categories: Dict[str, Tuple[str, ...]]
    #: user index -> sorted np.ndarray of seen item indices (exclude_seen)
    user_seen: Dict[int, Any] = dataclasses.field(default_factory=dict)


class ALSAlgorithm(Algorithm):
    query_class_ = Query

    def __init__(self, params: ALSAlgorithmParams = ALSAlgorithmParams()):
        super().__init__(params)

    def train(self, ctx: RuntimeContext, pd: PreparedData) -> ALSModel:
        """ALS on ``ctx.device`` (ops/als.py ``als_train``), seeded by the
        params' seed or else the context's."""
        n_users, n_items = len(pd.user_bimap), len(pd.item_bimap)
        if n_users == 0 or n_items == 0:
            raise ValueError("No ratings to train on")
        seed = self.params.seed if self.params.seed is not None else ctx.seed
        state, _ = als.als_train(
            pd.users, pd.items, pd.ratings, n_users=n_users, n_items=n_items,
            rank=self.params.rank, iterations=self.params.num_iterations,
            l2=self.params.lambda_, seed=seed,
            bf16_sweeps=self.params.bf16_sweeps, device=ctx.device,
            stats=ctx.timings)
        model = self._assemble_model(pd, state)
        self._refresh_mips_index(model)
        return model

    def train_with_previous(self, ctx: RuntimeContext, pd: PreparedData,
                            prev_model: Any) -> ALSModel:
        """Continuation retrain (ops/retrain.py ``als_retrain``): seed from
        the previous model's factors when its id space is an exact prefix
        of this PreparedData's, and let the early stop turn the warm start
        into fewer sweeps; any incompatibility (another rank, a rebuilt
        index space, another model class) trains fresh. No prep plan is
        kept: each ``pio train`` is a new process, so one would never be
        reused, and at a 1% tail of ML-20M a reuse loses to a fresh build
        on the H100 (PERF.md §7). Without it the stats name no touched
        item rows, so a MIPS index after this retrain is a full build."""
        prev_state = self._continuation_seed(pd, prev_model)
        if prev_state is None:
            return self.train(ctx, pd)
        seed = self.params.seed if self.params.seed is not None else ctx.seed
        n_users, n_items = len(pd.user_bimap), len(pd.item_bimap)
        stats: Dict[str, Any] = {}
        t0 = time.perf_counter()
        state = retrain.als_retrain(
            pd.users, pd.items, pd.ratings, n_users, n_items,
            rank=self.params.rank, iterations=self.params.num_iterations,
            l2=self.params.lambda_, seed=seed,
            bf16_sweeps=self.params.bf16_sweeps, prev_state=prev_state,
            stats=stats, device=ctx.device)
        als._sync(state.user_factors.device)
        ctx.timings["als.prep"] = stats["prep_wall_s"]
        ctx.timings["als.sweeps"] = (time.perf_counter() - t0
                                     - stats["prep_wall_s"])
        logger.info(
            "ALS continuation retrain: %d users × %d items, rank %d, "
            "%s sweeps (mode=%s, delta=%.3e)", n_users, n_items,
            self.params.rank, stats.get("sweeps_used"), stats.get("mode"),
            stats.get("final_delta", float("nan")))
        model = self._assemble_model(pd, state)
        self._refresh_mips_index(model, prev_model=prev_model,
                                 retrain_stats=stats)
        return model

    def _continuation_seed(self, pd: PreparedData,
                           prev_model: Any) -> Optional[als.ALSState]:
        """The previous factors as an (ungrown) ALSState, host numpy or
        tensors as they came, or None when they cannot seed this run."""
        if not isinstance(prev_model, ALSModel):
            return None
        uf, vf = prev_model.user_factors, prev_model.item_factors
        if (uf.ndim != 2 or vf.ndim != 2 or uf.shape[1] != vf.shape[1]
                or uf.shape[1] != self.params.rank):
            return None
        if not (prev_model.user_bimap.is_index_prefix_of(pd.user_bimap)
                and prev_model.item_bimap.is_index_prefix_of(
                    pd.item_bimap)):
            return None
        return als.ALSState(user_factors=uf, item_factors=vf)

    @staticmethod
    def _assemble_model(pd: PreparedData, state: als.ALSState) -> ALSModel:
        """The model: factors, BiMaps, item metadata, and each user's
        sorted seen items (for ``exclude_seen``). One sort of packed
        (user, item) keys orders the pairs by user, then item."""
        n_items = max(len(pd.item_bimap), 1)
        keys = np.sort(np.asarray(pd.users, np.int64) * n_items
                       + np.asarray(pd.items, np.int64))
        users, items = keys // n_items, (keys % n_items).astype(np.int32)
        starts = np.flatnonzero(np.r_[True, users[1:] != users[:-1]]) \
            if len(users) else np.empty(0, np.int64)
        user_seen = {int(u): s for u, s in
                     zip(users[starts], np.split(items, starts[1:]))}
        return ALSModel(
            user_factors=state.user_factors, item_factors=state.item_factors,
            user_bimap=pd.user_bimap, item_bimap=pd.item_bimap,
            item_years=pd.item_years, item_categories=pd.item_categories,
            user_seen=user_seen)

    def prepare_model(self, ctx: RuntimeContext, model: ALSModel) -> ALSModel:
        """Put the factors on ``ctx.device``, as contiguous f32. A model
        trained in this process keeps its MIPS index (adopted onto the
        put table, JAX :505-526); a restored one gets a new build."""
        def put(t):
            return torch.as_tensor(t).to(
                device=ctx.device, dtype=torch.float32).contiguous()

        prev_table = model.item_factors
        model = dataclasses.replace(
            model, user_factors=put(model.user_factors),
            item_factors=put(model.item_factors))
        if mips.adopt_index(prev_table, model.item_factors) is None:
            self._refresh_mips_index(model)
        return model

    def _refresh_mips_index(self, model: ALSModel, prev_model=None,
                            retrain_stats=None) -> None:
        """Keep the two-stage MIPS index (ops/mips.py) riding the model's
        item table (JAX :528-562): an O(delta) splice after a continuation
        retrain whose stats carry ``touched_item_rows`` (the in-process
        plan reuse of ``ops/retrain.py``), a full build otherwise. Gated
        by ``PIO_SERVE_MIPS`` and the auto floor. An error raises."""
        n_items = len(model.item_bimap)
        if not mips.build_enabled(n_items):
            return
        if prev_model is not None and retrain_stats is not None:
            touched = retrain_stats.get("touched_item_rows")
            if touched is not None and mips.update_index(
                    prev_model.item_factors, model.item_factors,
                    n_items, touched) is not None:
                # the splice re-quantizes only the delta rows while a
                # retrain nudges every row: re-probe the recall
                mips.recall_probe(model.item_factors)
                return
        mips.build_index(model.item_factors, n_items,
                         seed=self.params.seed or 0, probe_recall=True,
                         engine="recommendation")

    # -- speed layer -------------------------------------------------------
    def make_speed_overlay(self, model: ALSModel, app_name, channel_name,
                           data_source_params=None):
        """Explicit fold-in over the frozen item factors, with the
        training read's event shape (``rate`` at its ``rating``, ``buy``
        at ``buy_rating``) and the trainer's ALS-WR ridge (λ·nnz). The
        item table goes to the solver as the device tensor it is."""
        if app_name is None:
            return None
        from incubator_predictionio_tpu_torch.speed.overlay import (
            SpeedOverlay,
            SpeedOverlayConfig,
        )

        buy_rating = float(getattr(data_source_params, "buy_rating", 4.0))
        return SpeedOverlay(
            SpeedOverlayConfig(
                app_name=app_name, channel_name=channel_name,
                engine="recommendation",
                entity_type="user", target_entity_type="item",
                event_names=("rate", "buy"), value_prop="rating",
                event_values={"buy": buy_rating},
                key_side="entity",
                l2=self.params.lambda_, reg_nnz=True, implicit=False,
            ),
            other_factors=model.item_factors,
            other_index=model.item_bimap,
            key_index=model.user_bimap,
        )

    # -- serving ----------------------------------------------------------
    def _allowed_mask(
        self, model: ALSModel, query: Query
    ) -> Optional[np.ndarray]:
        """Serve-time filters (custom-query creationYear; filter-by-category;
        white/blacklists) → boolean mask over item indices; seen-item
        exclusion is handled in predict."""
        n_items = len(model.item_bimap)
        mask = None

        def ensure() -> np.ndarray:
            nonlocal mask
            if mask is None:
                mask = np.ones(n_items, dtype=bool)
            return mask

        if query.creation_year is not None:
            m = ensure()
            for item, idx in model.item_bimap.items():
                if model.item_years.get(item) is None or \
                        model.item_years[item] < query.creation_year:
                    m[idx] = False
        if query.categories:
            m = ensure()
            wanted = set(query.categories)
            for item, idx in model.item_bimap.items():
                if not wanted.intersection(model.item_categories.get(item, ())):
                    m[idx] = False
        if query.whitelist:
            m = ensure()
            allowed = {
                model.item_bimap[i] for i in query.whitelist
                if i in model.item_bimap
            }
            for idx in range(n_items):
                if idx not in allowed:
                    m[idx] = False
        if query.blacklist:
            m = ensure()
            for item in query.blacklist:
                idx = model.item_bimap.get(item)
                if idx is not None:
                    m[idx] = False
        return mask

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        user_idx = model.user_bimap.get(query.user)
        # speed layer: a folded-in vector (a new user, or one with events
        # newer than the model) goes before the base row
        ov = self.speed_overlay
        ov_vec = ov.lookup(query.user) if ov is not None else None
        if user_idx is None and ov_vec is None:
            # unknown user → empty result (ALSAlgorithm.scala predict miss)
            return PredictedResult(item_scores=())
        k = min(query.num, len(model.item_bimap))
        if k <= 0:
            return PredictedResult(item_scores=())
        mask = self._allowed_mask(model, query)
        seen = None
        if query.exclude_seen and user_idx is not None:
            seen = model.user_seen.get(user_idx)
            if seen is not None and not len(seen):
                seen = None
        dev = model.item_factors.device
        exclude = None if seen is None else pad_exclude(seen, dev)
        allowed = None if mask is None else torch.from_numpy(mask)
        if ov_vec is not None:
            packed = score_and_top_k(
                torch.from_numpy(np.asarray(ov_vec, np.float32)).to(dev),
                model.item_factors, k=k, exclude=exclude,
                allowed_mask=allowed)
        else:
            packed = score_user_and_top_k(  # one dispatch, one fetch
                model.user_factors, model.item_factors, int(user_idx), k=k,
                exclude=exclude, allowed_mask=allowed)
        packed = packed.cpu().numpy()
        return self._pack_scores(model, packed[0],
                                 packed[1].astype(np.int64))

    def batch_predict(
        self, model: ALSModel, queries: Sequence[Tuple[int, Query]]
    ) -> List[Tuple[int, PredictedResult]]:
        """One [B, K]×[K, I] scoring + top-k for all unfiltered queries of
        known users; filtered queries, and users the speed overlay covers
        (their folded vector is fresher than the base row), go through
        ``predict`` one by one."""
        ov = self.speed_overlay
        plain = [
            (qx, q) for qx, q in queries
            if q.creation_year is None and not q.categories
            and not q.whitelist and not q.blacklist and not q.exclude_seen
            and model.user_bimap.get(q.user) is not None
            and (ov is None or not ov.covers(q.user))
        ]
        out: List[Tuple[int, PredictedResult]] = []
        if plain:
            k = min(max(q.num for _qx, q in plain), len(model.item_bimap))
            rows = [model.user_bimap[q.user] for _qx, q in plain]
            tops = self._score_plain_batch(model, rows, k)
            for (qx, q), (top_s, top_i) in zip(plain, tops):
                out.append((qx, self._pack_scores(
                    model, top_s[: q.num], top_i[: q.num])))
        handled = {qx for qx, _ in out}
        for qx, q in queries:
            if qx not in handled:
                out.append((qx, self.predict(model, q)))
        return out

    @staticmethod
    def _score_plain_batch(model: ALSModel, rows, k: int):
        """Per-row ``(top_s, top_i)`` numpy pairs of one batched dispatch —
        the one scoring call shared by ``batch_predict`` and
        ``batch_serve_json``, whose byte identity depends on it."""
        packed = batch_score_top_k(
            model.user_factors, model.item_factors, rows, k).cpu().numpy()
        return [(packed[0][b], packed[1][b].astype(np.int64))
                for b in range(len(rows))]

    def warmup(self, model: ALSModel, max_batch: int = 1) -> None:
        """Run the singleton path once, then the batched path at each
        power-of-two width up to ``max_batch``, with a real known user."""
        first = next(iter(model.user_bimap), None)
        if first is None:
            return
        q = Query(user=str(first), num=10)
        self.predict(model, q)
        for size in ladder_rungs(int(max_batch)) if max_batch > 0 else ():
            if size >= 2:
                self.batch_predict(model, [(i, q) for i in range(size)])

    def _pack_scores(self, model: ALSModel, scores, indices) -> PredictedResult:
        inv = model.item_bimap.inverse
        years = model.item_years
        packed = []
        for s, i in zip(scores, indices):
            if s > -1e37:  # drop masked-out fillers
                iid = inv[int(i)]
                packed.append(ItemScore(item=iid, score=float(s),
                                        creation_year=years.get(iid)))
        return PredictedResult(item_scores=tuple(packed))

    def batch_serve_json(self, model: ALSModel, docs) -> list:
        """Columnar fast path: plain ``{"user": ..., "num": ...}`` docs of
        known users render straight from the batched top-k arrays to
        response bytes, byte-identical to ``json.dumps(to_jsonable(...))``
        of the object path; any other doc, and a user the speed overlay
        covers, stays None."""
        get_row = model.user_bimap.get
        ov = self.speed_overlay
        plain = []  # (slot, row, num)
        for slot, d in enumerate(docs):
            if (type(d) is dict and len(d) == 2 and "user" in d
                    and "num" in d):
                u, num = d["user"], d["num"]
                if (isinstance(u, str) and isinstance(num, int)
                        and not isinstance(num, bool) and num > 0):
                    row = get_row(u)
                    # an overlay user's bytes must reflect the folded
                    # vector: the object path serves it
                    if row is not None and (ov is None
                                            or not ov.covers(u)):
                        plain.append((slot, row, num))
        out: list = [None] * len(docs)
        if not plain:
            return out
        k = min(max(num for _s, _r, num in plain), len(model.item_bimap))
        rows = [r for _s, r, _n in plain]
        tops = self._score_plain_batch(model, rows, k)
        inv = model.item_bimap.inverse
        years = model.item_years
        dumps = json.dumps
        isfinite = math.isfinite
        for (slot, _row, num), (top_s, top_i) in zip(plain, tops):
            parts = []
            ok = True
            for s, i in zip(top_s[:num].tolist(), top_i[:num].tolist()):
                if s > -1e37:
                    if not isfinite(s):
                        # json.dumps writes 'Infinity', repr 'inf': an
                        # overflowed score takes the object path instead
                        ok = False
                        break
                    iid = inv[i]
                    y = years.get(iid)
                    # json.dumps' default formatting: ', '/': ', float repr
                    parts.append('{"item": %s, "score": %s, '
                                 '"creationYear": %s}'
                                 % (dumps(iid), repr(s),
                                    "null" if y is None else repr(y)))
            if ok:
                out[slot] = ('{"itemScores": [' + ", ".join(parts)
                             + "]}").encode("utf-8")
        return out


# ---------------------------------------------------------------------------
# Serving + metrics + factory
# ---------------------------------------------------------------------------

class RecommendationServing(Serving):
    """First-algorithm serving (Serving.scala / LFirstServing)."""

    FIRST_PREDICTION_ONLY = True

    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        return predictions[0]


class PrecisionAtK(OptionAverageMetric):
    """Precision@K against held-out items (JAX :889-907): hits among the
    first ``k`` served items over ``k`` (returning fewer than ``k`` items
    does not raise the score); a query with no held-out items scores
    None and is left out of the mean."""

    def __init__(self, k: int = 10):
        super().__init__()
        self.k = k

    def header(self) -> str:
        return f"Precision@{self.k}"

    def calculate_qpa(self, q: Query, p: PredictedResult, a: ActualResult):
        if not a.items:
            return None
        actual = set(a.items)
        hits = sum(1 for s in p.item_scores[: self.k] if s.item in actual)
        return hits / self.k


class RecommendationEngine(EngineFactory):
    """EngineFactory (Engine.scala:30-40 of the template)."""

    def apply(self) -> Engine:
        return Engine(RecommendationDataSource, RecommendationPreparator,
                      {"als": ALSAlgorithm}, RecommendationServing)
