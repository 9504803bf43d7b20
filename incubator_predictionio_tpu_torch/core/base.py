"""Serving half of the DASE contracts: ``Params``, ``Algorithm`` and
``Serving`` (port of incubator_predictionio_tpu/core/base.py; reference
core/BaseAlgorithm.scala, core/BaseServing.scala and the controller
bases). Data sources, preparators and evaluators come with training.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Generic, List, Optional, Sequence, Tuple, Type, TypeVar

from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

Q = TypeVar("Q")    # query
P = TypeVar("P")    # predicted result
M = TypeVar("M")    # model


class Params:
    """Marker base for component parameter dataclasses
    (controller/Params.scala:32). Subclasses should be ``@dataclass``es."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    """controller/Params.scala EmptyParams."""


def doer(cls: Type[Any], params: Params) -> Any:
    """Instantiate a component: ctor(params) when the constructor takes a
    positional argument, else the no-argument ctor (AbstractDoer.scala)."""
    sig = inspect.signature(cls.__init__)
    positional = [
        p
        for name, p in list(sig.parameters.items())[1:]  # skip self
        if p.kind
        in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ]
    if positional:
        return cls(params)
    return cls()


class _Component:
    """Common base: stores params like the reference's ctor convention."""

    def __init__(self, params: Params = EmptyParams()):
        self.params = params


class Algorithm(_Component, Generic[M, Q, P]):
    """Answers queries from a trained model (core/BaseAlgorithm.scala).
    Models hold tensors on the serving device plus host-side index maps
    such as BiMap."""

    def train(self, ctx: RuntimeContext, prepared_data: Any) -> M:
        raise NotImplementedError

    def predict(self, model: M, query: Q) -> P:
        raise NotImplementedError

    def batch_predict(
        self, model: M, queries: Sequence[Tuple[int, Q]]
    ) -> List[Tuple[int, P]]:
        """Batch prediction (BaseAlgorithm.batchPredictBase). Default
        loops ``predict``; implementations override it with one batched
        device call."""
        return [(qx, self.predict(model, q)) for qx, q in queries]

    def batch_serve_json(self, model: M, docs: Sequence[Any]
                         ) -> Optional[List[Optional[bytes]]]:
        """Optional serving fast path: parsed query docs → response-body
        bytes, BYTE-IDENTICAL to ``json.dumps(to_jsonable(result))`` of a
        first-prediction serving, or None per doc the fast path cannot
        take. Return None when the algorithm has no such path."""
        return None

    def prepare_model(self, ctx: RuntimeContext, model: M) -> M:
        """Deploy-time hook: move a model's tensors to ``ctx.device``."""
        return model

    def warmup(self, model: M, max_batch: int = 1) -> None:
        """Deploy-time hook that runs the serving paths once per shape
        (optional, default no-op)."""

    @property
    def speed_overlay(self):
        """The speed layer is not ported: no overlay is ever attached."""
        return None

    #: Query dataclass the server extracts request bodies into (None:
    #: the algorithm takes the parsed JSON as it is)
    query_class_: Optional[type] = None

    @property
    def query_class(self) -> Optional[type]:
        return self.query_class_


class Serving(_Component, Generic[Q, P]):
    """Combines per-algorithm predictions into the served result
    (core/BaseServing.scala, controller/LServing.scala)."""

    #: declared capability: ``serve`` returns predictions[0] unchanged and
    #: ``supplement`` is the identity — the conditions under which the
    #: server may answer plain queries from ``batch_serve_json``.
    #: Subclasses that override either method must leave this False.
    FIRST_PREDICTION_ONLY = False

    def supplement(self, query: Q) -> Q:
        """Pre-process the query before algorithms see it."""
        return query

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        raise NotImplementedError
