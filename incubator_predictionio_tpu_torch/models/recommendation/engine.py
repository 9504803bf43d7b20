"""The recommendation engine's serving half: ALS factors on the device,
every query scored against the whole catalogue by the score+top-k kernel.

Port of incubator_predictionio_tpu/models/recommendation/engine.py
(:54-85 query model, :333-919 algorithm, serving and factory). Reference
parity (examples/scala-parallel-recommendation/custom-query/):
``Query(user, num, creationYear?)`` / ``PredictedResult(itemScores)``
(Engine.scala:23-28); the model keeps String↔Int BiMaps next to the
factors (ALSModel.scala); serving returns the first algorithm's result.

Not ported yet: training (``train`` raises), the speed-layer overlay, the
host-mirror serving of small models, and the MIPS index. The host mirror
is left out on purpose: on the card it would hide the kernel for small
models, and on the CPU the plain version already is the path.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch.core.base import Algorithm, Params, Serving
from incubator_predictionio_tpu_torch.core.engine import Engine, EngineFactory
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.ops.topk import (
    batch_score_top_k,
    ladder_rungs,
    pad_exclude,
    score_user_and_top_k,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext


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


# ---------------------------------------------------------------------------
# ALS algorithm (ALSAlgorithm.scala:25-31)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    __camel_case__ = True  # engine.json parity: numIterations, lambda

    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: Optional[int] = None


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

    def train(self, ctx: RuntimeContext, pd: Any) -> ALSModel:
        raise NotImplementedError("ALS training is not ported yet")

    def prepare_model(self, ctx: RuntimeContext, model: ALSModel) -> ALSModel:
        """Put the factors on ``ctx.device``, as contiguous f32."""
        def put(t):
            return torch.as_tensor(t).to(
                device=ctx.device, dtype=torch.float32).contiguous()

        return dataclasses.replace(
            model, user_factors=put(model.user_factors),
            item_factors=put(model.item_factors))

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
        if user_idx is None:
            # unknown user → empty result (ALSAlgorithm.scala predict miss)
            return PredictedResult(item_scores=())
        k = min(query.num, len(model.item_bimap))
        if k <= 0:
            return PredictedResult(item_scores=())
        mask = self._allowed_mask(model, query)
        seen = None
        if query.exclude_seen:
            seen = model.user_seen.get(user_idx)
            if seen is not None and not len(seen):
                seen = None
        dev = model.item_factors.device
        packed = score_user_and_top_k(  # one dispatch, one fetch
            model.user_factors, model.item_factors, int(user_idx), k=k,
            exclude=None if seen is None else pad_exclude(seen, dev),
            allowed_mask=None if mask is None else torch.from_numpy(mask),
        ).cpu().numpy()
        return self._pack_scores(model, packed[0],
                                 packed[1].astype(np.int64))

    def batch_predict(
        self, model: ALSModel, queries: Sequence[Tuple[int, Query]]
    ) -> List[Tuple[int, PredictedResult]]:
        """One [B, K]×[K, I] scoring + top-k for all unfiltered queries of
        known users; filtered queries go through ``predict`` one by one."""
        plain = [
            (qx, q) for qx, q in queries
            if q.creation_year is None and not q.categories
            and not q.whitelist and not q.blacklist and not q.exclude_seen
            and model.user_bimap.get(q.user) is not None
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
        of the object path; any other doc stays None."""
        get_row = model.user_bimap.get
        plain = []  # (slot, row, num)
        for slot, d in enumerate(docs):
            if (type(d) is dict and len(d) == 2 and "user" in d
                    and "num" in d):
                u, num = d["user"], d["num"]
                if (isinstance(u, str) and isinstance(num, int)
                        and not isinstance(num, bool) and num > 0):
                    row = get_row(u)
                    if row is not None:
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
# Serving + factory
# ---------------------------------------------------------------------------

class RecommendationServing(Serving):
    """First-algorithm serving (Serving.scala / LFirstServing)."""

    FIRST_PREDICTION_ONLY = True

    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        return predictions[0]


class RecommendationEngine(EngineFactory):
    """EngineFactory (Engine.scala:30-40 of the template), serving slots."""

    def apply(self) -> Engine:
        return Engine({"als": ALSAlgorithm}, RecommendationServing)
