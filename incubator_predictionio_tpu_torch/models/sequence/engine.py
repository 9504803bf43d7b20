"""The sequence engine: sessions → next-item transformer (SASRec) trained on
the card → the next items for a session history.

Port of incubator_predictionio_tpu/models/sequence/engine.py. The wire
shape is the JAX package's: ``Query(user, num, recentItems?)`` →
``PredictedResult(itemScores)``. The data source reads each user's item
events from the event store, in event time; a query without
``recentItems`` is answered from the user's latest events in the store,
read through a TTL micro-cache (``speed/cache.py``) that a write to the
app invalidates. The model is ``ops/transformer.py``; a scoring window of
8,192 or more runs its attention through the flash kernel
(``ops/attention_kernels.py``).

``HitAtK`` scores next-item hits for evaluation. The JAX package's
defines only ``calculate_one``, so its ``AverageMetric.calculate`` raises;
here ``calculate_qpa`` is the same function, so the metric also scores a
whole evaluation output.

Not ported yet, raising where it is reached: ``seq_parallel`` ring /
ulysses (the multi-device slice).
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
    SanityCheck,
)
from incubator_predictionio_tpu_torch.core.engine import Engine, EngineFactory
from incubator_predictionio_tpu_torch.core.metrics import AverageMetric
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.data.store import EventStore
from incubator_predictionio_tpu_torch.ops.transformer import (
    TransformerWeights,
    sasrec_fit,
    sasrec_topk,
)
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
    #: explicit session history (most recent last); overrides the event store
    recent_items: Optional[Tuple[str, ...]] = None


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
    event_names: Tuple[str, ...] = ("view", "buy")
    #: sessions shorter than this are dropped (nothing to predict from)
    min_session_length: int = 2


@dataclasses.dataclass
class TrainingData(SanityCheck):
    #: per-user time-ordered item id sequences
    sessions: List[List[str]]

    def sanity_check(self) -> None:
        if not self.sessions:
            raise ValueError("TrainingData has no usable sessions")


class SequenceDataSource(DataSource):
    """Each user's ``event_names`` events on items, from the event store
    (JAX engine.py:85-108): one session per user, sorted by event time
    (a stable sort: equal times keep the store's order); sessions shorter
    than ``min_session_length`` are dropped."""

    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        events = EventStore.find(
            app_name=self.params.app_name,
            channel_name=self.params.channel_name,
            entity_type="user",
            target_entity_type="item",
            event_names=list(self.params.event_names),
        )
        per_user: Dict[str, List[Tuple[Any, str]]] = {}
        for e in events:
            if e.target_entity_id:
                per_user.setdefault(e.entity_id, []).append(
                    (e.event_time, e.target_entity_id))
        sessions = []
        for items in per_user.values():
            items.sort(key=lambda t: t[0])
            seq = [i for _, i in items]
            if len(seq) >= self.params.min_session_length:
                sessions.append(seq)
        return TrainingData(sessions=sessions)


@dataclasses.dataclass
class PreparedData:
    #: [N, max_len] int32, PAD(0)-left-padded, items indexed from 1
    sequences: np.ndarray
    item_bimap: BiMap


@dataclasses.dataclass(frozen=True)
class PreparatorParams(Params):
    __camel_case__ = True

    max_len: int = 64


class SequencePreparator(Preparator):
    def __init__(self, params: PreparatorParams = PreparatorParams()):
        super().__init__(params)

    def prepare(self, ctx: RuntimeContext, td: TrainingData) -> PreparedData:
        # index items from 1; 0 is the PAD token
        item_bimap = BiMap.string_int(i for s in td.sessions for i in s)
        max_len = self.params.max_len
        rows = np.zeros((len(td.sessions), max_len), np.int32)
        for r, seq in enumerate(td.sessions):
            idx = [item_bimap[i] + 1 for i in seq][-max_len:]
            rows[r, max_len - len(idx):] = idx
        return PreparedData(sequences=rows, item_bimap=item_bimap)


@dataclasses.dataclass(frozen=True)
class SeqRecAlgorithmParams(Params):
    __camel_case__ = True

    app_name: str
    channel_name: Optional[str] = None
    d_model: int = 64
    n_heads: int = 2
    n_layers: int = 2
    epochs: int = 20
    batch_size: int = 128
    learning_rate: float = 1e-3
    seed: Optional[int] = None
    #: sequence-parallel strategy for long sessions: none | ring | ulysses
    seq_parallel: str = "none"
    #: event types read to reconstruct a live session at serve time
    recent_events: Tuple[str, ...] = ("view", "buy")


@dataclasses.dataclass
class SeqRecModel:
    weights: TransformerWeights
    item_bimap: BiMap
    n_heads: int
    max_len: int
    final_loss: float
    #: the loss of every training step, [epochs, steps] (None: not trained
    #: here); not checkpointed, as the JAX package's model has no such field
    step_losses: Optional[np.ndarray] = None

    __checkpoint_skip__ = ("step_losses",)


class SeqRecAlgorithm(Algorithm):
    query_class_ = Query

    def __init__(self, params: SeqRecAlgorithmParams):
        super().__init__(params)
        # bounded TTL micro-cache in front of the per-query history read,
        # versioned by the store's write cursor: a new event misses at once
        self._history_cache = TTLCache(maxsize=4096, ttl_s=serve_cache_ttl())

    def _attn_fn(self):
        """Attention backend per ``params.seq_parallel``: None (routed by
        length on one device) for ``none``."""
        mode = self.params.seq_parallel
        if mode == "none":
            return None
        if mode not in ("ring", "ulysses"):
            raise ValueError(f"unknown seq_parallel mode: {mode!r}")
        raise NotImplementedError(
            f"seq_parallel={mode!r} comes with the port's multi-device slice "
            "(ROADMAP Queue 1 item 9)")

    def train(self, ctx: RuntimeContext, pd: PreparedData) -> SeqRecModel:
        seed = self.params.seed if self.params.seed is not None else ctx.seed
        stats: dict = {}
        weights, losses = sasrec_fit(
            pd.sequences,
            n_items=len(pd.item_bimap),  # token ids 1..n; fit adds PAD
            d_model=self.params.d_model,
            n_heads=self.params.n_heads,
            n_layers=self.params.n_layers,
            epochs=self.params.epochs,
            batch_size=self.params.batch_size,
            learning_rate=self.params.learning_rate,
            seed=seed,
            attn_fn=self._attn_fn(),
            device=ctx.device,
            stats=stats,
        )
        logger.info("sequence: trained %d sessions, loss %.4f → %.4f",
                    len(pd.sequences), losses[0], losses[-1])
        return SeqRecModel(
            weights=weights,
            item_bimap=pd.item_bimap,
            n_heads=self.params.n_heads,
            max_len=pd.sequences.shape[1],
            final_loss=float(losses[-1]),
            step_losses=stats["step_losses"],
        )

    def prepare_model(self, ctx: RuntimeContext,
                      model: SeqRecModel) -> SeqRecModel:
        """Put the weights on ``ctx.device``, as contiguous f32."""
        return dataclasses.replace(model, weights=model.weights.map(
            lambda t: torch.as_tensor(t).to(
                device=ctx.device, dtype=torch.float32).contiguous()))

    def _history(self, query: Query, model: SeqRecModel) -> List[int]:
        """Session history as model token ids, oldest first; unknown items
        are dropped. Without ``recent_items`` the user's latest
        ``recent_events`` come from the event store, through the TTL
        micro-cache."""
        if query.recent_items is not None:
            names: Sequence[str] = query.recent_items
        else:
            names = self._history_cache.get_or_load(
                query.user,
                lambda: self._load_history_names(query.user, model),
                version=store_version(self.params.app_name,
                                      self.params.channel_name))
        return [model.item_bimap[n] + 1 for n in names
                if n in model.item_bimap]

    def _load_history_names(self, user: str,
                            model: SeqRecModel) -> List[str]:
        """The user's latest ``max_len`` events of ``recent_events``, oldest
        first; a failed read is logged and gives no history."""
        try:
            events = list(EventStore.find_by_entity(
                app_name=self.params.app_name,
                channel_name=self.params.channel_name,
                entity_type="user",
                entity_id=user,
                event_names=list(self.params.recent_events),
                limit=model.max_len,
                latest=True,
            ))
        except Exception:
            logger.warning("sequence: recent-event lookup failed for user %r",
                           user, exc_info=True)
            events = []
        return [e.target_entity_id for e in reversed(events)
                if e.target_entity_id]

    def warmup(self, model: SeqRecModel, max_batch: int = 1) -> None:
        """Run the serving forward once, with a one-item history."""
        first = next(iter(model.item_bimap), None)
        if first is not None:
            self.predict(model, Query(user="__warmup__", num=10,
                                      recent_items=(str(first),)))

    def predict(self, model: SeqRecModel, query: Query) -> PredictedResult:
        hist = self._history(query, model)
        k = min(query.num, len(model.item_bimap))
        if not hist or k <= 0:
            return PredictedResult(item_scores=())
        # score at width max_len - 1, the width training ran at (the fit
        # shifts batch[:, :-1] → batch[:, 1:]), so every positional row used
        # here received gradients
        window = model.max_len - 1
        tokens = np.zeros((1, window), np.int32)
        hist = hist[-window:]
        tokens[0, window - len(hist):] = hist
        dev = model.weights.item_emb.device
        scores, ids = sasrec_topk(model.weights,
                                  torch.from_numpy(tokens).to(dev),
                                  model.n_heads, k=k)
        inv = model.item_bimap.inverse
        out = []
        for s, i in zip(scores[0].cpu().tolist(), ids[0].cpu().tolist()):
            if not np.isfinite(s) or i == 0:
                continue
            out.append(ItemScore(item=inv[i - 1], score=float(s)))
        return PredictedResult(item_scores=tuple(out))


class HitAtK(AverageMetric):
    """Next-item hit rate over held-out (query, actual) pairs (JAX
    :349-356): 1 when the actual item (a string, or an object with
    ``item``) is among the served items, else 0."""

    def calculate_one(self, query: Query, predicted: PredictedResult,
                      actual: Any) -> float:
        wanted = actual if isinstance(actual, str) else actual.item
        return 1.0 if any(s.item == wanted for s in predicted.item_scores) \
            else 0.0

    calculate_qpa = calculate_one


class SequenceEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(SequenceDataSource, SequencePreparator,
                      {"sasrec": SeqRecAlgorithm}, FirstServing)
