"""The DASE contracts: ``Params``, ``DataSource``, ``Preparator``,
``Algorithm`` and ``Serving`` (port of incubator_predictionio_tpu/core/
base.py; reference core/Base{DataSource,Preparator,Algorithm,Serving}.scala
and the controller bases), and the ``Evaluator`` contract that
``core/evaluation.py``'s ``MetricEvaluator`` implements
(core/BaseEvaluator.scala).
"""

from __future__ import annotations

import abc
import dataclasses
import inspect
import typing
from typing import Any, Generic, List, Optional, Sequence, Tuple, Type, TypeVar

from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

TD = TypeVar("TD")  # training data
EI = TypeVar("EI")  # evaluation info
PD = TypeVar("PD")  # prepared data
A = TypeVar("A")    # actual result
Q = TypeVar("Q")    # query
P = TypeVar("P")    # predicted result
M = TypeVar("M")    # model
R = TypeVar("R")    # evaluator result


class Params:
    """Marker base for component parameter dataclasses
    (controller/Params.scala:32). Subclasses should be ``@dataclass``es."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    """controller/Params.scala EmptyParams."""


class SanityCheck(abc.ABC):
    """Data classes may implement this to take part in the train-time
    sanity check (core/SanityCheck.scala; Engine.scala:652-708)."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise if the data is invalid."""


class StopAfterReadInterruption(Exception):
    """Engine.scala:668 — raised when WorkflowParams.stop_after_read."""


class StopAfterPrepareInterruption(Exception):
    """Engine.scala:689 — raised when WorkflowParams.stop_after_prepare."""


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


def params_class_of(cls: Type[Any]) -> Optional[Type[Params]]:
    """The Params dataclass a component's constructor expects, if any.

    Resolution order: explicit ``params_class`` attribute, then the type
    annotation of the first constructor argument. Used by
    ``Engine.jvalue_to_engine_params`` to type engine.json params the way the
    reference recovers them from manifest class info
    (WorkflowUtils.extractParams, core/.../workflow/WorkflowUtils.scala:134).
    """
    explicit = getattr(cls, "params_class", None)
    if explicit is not None:
        return explicit
    try:
        hints = typing.get_type_hints(cls.__init__)
    except Exception:
        hints = {}
    sig = inspect.signature(cls.__init__)
    for name, p in list(sig.parameters.items())[1:]:
        if p.kind in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
        ):
            hint = hints.get(name)
            if isinstance(hint, type) and issubclass(hint, Params):
                return hint
            return None
    return None


class _Component:
    """Common base: stores params like the reference's ctor convention."""

    def __init__(self, params: Params = EmptyParams()):
        self.params = params


class DataSource(_Component, Generic[TD, EI, Q, A]):
    """Reads training and evaluation data (core/BaseDataSource.scala:43-54,
    controller/{P,L}DataSource.scala)."""

    def read_training(self, ctx: RuntimeContext) -> TD:
        raise NotImplementedError

    def read_eval(
        self, ctx: RuntimeContext
    ) -> List[Tuple[TD, EI, List[Tuple[Q, A]]]]:
        """(training set, eval info, (query, actual) pairs) per fold
        (PDataSource.readEval:55). Default: no eval data."""
        return []


class Preparator(_Component, Generic[TD, PD]):
    """Transforms training data into algorithm input
    (core/BasePreparator.scala:44, controller/{P,L}Preparator.scala)."""

    def prepare(self, ctx: RuntimeContext, training_data: TD) -> PD:
        raise NotImplementedError


class IdentityPreparator(Preparator[TD, TD]):
    """Pass-through (controller/IdentityPreparator.scala:34,59)."""

    def prepare(self, ctx: RuntimeContext, training_data: TD) -> TD:
        return training_data


class Algorithm(_Component, Generic[M, Q, P]):
    """Answers queries from a trained model (core/BaseAlgorithm.scala).
    Models hold tensors on the serving device plus host-side index maps
    such as BiMap."""

    def train(self, ctx: RuntimeContext, prepared_data: Any) -> M:
        raise NotImplementedError

    def train_with_previous(self, ctx: RuntimeContext, prepared_data: Any,
                            prev_model: Any) -> M:
        """Continuation-retrain hook: train with the previous run's model
        at hand as a warm start (ops/retrain.py). The default ignores
        ``prev_model`` and trains fresh. An implementation checks itself
        that the previous model can seed this one (rank, index-space
        prefix) and trains fresh where it cannot."""
        return self.train(ctx, prepared_data)

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

    def make_speed_overlay(self, model: M, app_name: Optional[str],
                           channel_name: Optional[str],
                           data_source_params: Any = None):
        """Speed-layer hook (``speed/``): a configured ``SpeedOverlay``
        over this model's frozen factors, or None (the default) when the
        algorithm has no fold-in. Called by the PredictionServer at
        deploy with the app and channel of the engine's data-source
        params (and those params, for event weights kept there). The
        overlay must use the event shape and regularization training
        used. The server owns its life cycle and attaches it with
        :meth:`attach_speed_overlay`."""
        return None

    def attach_speed_overlay(self, overlay) -> None:
        """Bind (or clear, with None) the overlay the predict paths
        consult before the base model."""
        self._speed_overlay = overlay

    @property
    def speed_overlay(self):
        return getattr(self, "_speed_overlay", None)

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


class FirstServing(Serving[Q, P]):
    """Serve the first algorithm's prediction (controller/LFirstServing.scala)."""

    FIRST_PREDICTION_ONLY = True

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class AverageServing(Serving[Q, float]):
    """Average numeric predictions (controller/LAverageServing.scala)."""

    def serve(self, query: Q, predictions: Sequence[float]) -> float:
        return sum(predictions) / len(predictions)


class Evaluator(_Component, Generic[EI, Q, P, A, R]):
    """Scores evaluation output (core/BaseEvaluator.scala:52): every
    candidate's ``[(eval_info, [(query, prediction, actual)])]``."""

    def evaluate(
        self,
        ctx: RuntimeContext,
        evaluation: Any,
        engine_eval_data_set: Sequence[
            Tuple[Any, Sequence[Tuple[EI, Sequence[Tuple[Q, P, A]]]]]
        ],
        params: Any,
    ) -> R:
        raise NotImplementedError
