"""Engine — the DASE composition and its training run (port of
incubator_predictionio_tpu/core/engine.py; reference
controller/Engine.scala:83-712). The Engine holds class maps for the data
source, preparator, algorithm and serving slots and instantiates components
through :func:`doer`. ``train`` is read → sanity → prepare → sanity →
per-algorithm train → sanity; ``eval`` trains on each fold of the data
source's ``read_eval`` and serves its queries (``batch_eval`` over a list
of candidates, what ``pio eval`` scores); ``components`` gives the server
its algorithms and serving component; ``prepare_deploy`` turns checkpointed
models into servable ones (Engine.scala:199-269);
``jvalue_to_engine_params`` reads an ``engine.json`` variant and
``engine_params_from_instance`` a stored engine instance into typed
``EngineParams`` (Engine.scala:357-470).
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from incubator_predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    EmptyParams,
    Params,
    Preparator,
    SanityCheck,
    Serving,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    doer,
    params_class_of,
)
from incubator_predictionio_tpu_torch.core.params import (
    EngineParams,
    WorkflowParams,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.utils import json_codec

logger = logging.getLogger(__name__)


def _as_class_map(spec: Any) -> Dict[str, type]:
    """Accept a single class or a name→class dict."""
    if isinstance(spec, dict):
        return dict(spec)
    return {"": spec}


def _select(class_map: Dict[str, type], name: str, slot: str) -> type:
    if name in class_map:
        return class_map[name]
    if name == "" and len(class_map) == 1:
        return next(iter(class_map.values()))
    raise ValueError(
        f"{slot} has no component named {name!r} (registered: {sorted(class_map)})"
    )


@contextlib.contextmanager
def _phase(ctx: RuntimeContext, name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ctx.timings[name] = time.perf_counter() - t0


def _sanity(obj: Any, skip: bool) -> None:
    if not skip and isinstance(obj, SanityCheck):
        obj.sanity_check()


class Engine:
    """The DASE engine (controller/Engine.scala:83)."""

    def __init__(self, data_source_class_map: Any, preparator_class_map: Any,
                 algorithm_class_map: Any, serving_class_map: Any):
        self.data_source_class_map = _as_class_map(data_source_class_map)
        self.preparator_class_map = _as_class_map(preparator_class_map)
        self.algorithm_class_map = _as_class_map(algorithm_class_map)
        self.serving_class_map = _as_class_map(serving_class_map)

    def _algorithms(self, engine_params: EngineParams) -> List[Algorithm]:
        return [
            doer(_select(self.algorithm_class_map, name, "algorithm"), params)
            for name, params in (engine_params.algorithm_params_list
                                 or [("", EmptyParams())])
        ]

    def components(self, engine_params: EngineParams
                   ) -> Tuple[List[Algorithm], Serving]:
        """Instantiate the algorithms and the serving component once (what
        the prediction server uses)."""
        serv_name, serv_params = engine_params.serving_params
        serving = doer(
            _select(self.serving_class_map, serv_name, "serving"), serv_params)
        return self._algorithms(engine_params), serving

    def _data_components(self, engine_params: EngineParams
                         ) -> Tuple[DataSource, Preparator]:
        ds_name, ds_params = engine_params.data_source_params
        prep_name, prep_params = engine_params.preparator_params
        return (doer(_select(self.data_source_class_map, ds_name,
                             "dataSource"), ds_params),
                doer(_select(self.preparator_class_map, prep_name,
                             "preparator"), prep_params))

    def train(self, ctx: RuntimeContext, engine_params: EngineParams,
              params: Optional[WorkflowParams] = None,
              prev_models: Optional[List[Any]] = None) -> List[Any]:
        """Read, prepare and train every algorithm → one model each
        (Engine.scala:625-712). The wall of each phase lands in
        ``ctx.timings`` (the JAX package's ``tracing.phase`` names).
        ``prev_models`` (aligned with the algorithm list) hands each
        algorithm its previous model through
        ``Algorithm.train_with_previous``, the continuation retrain."""
        params = params or WorkflowParams()
        ctx.timings.clear()
        data_source, preparator = self._data_components(engine_params)
        algorithms = self._algorithms(engine_params)
        logger.info("Engine.train: ds=%s prep=%s algos=%s",
                    type(data_source).__name__, type(preparator).__name__,
                    [type(a).__name__ for a in algorithms])

        with _phase(ctx, "read"):
            td = data_source.read_training(ctx)
        _sanity(td, params.skip_sanity_check)
        if params.stop_after_read:
            raise StopAfterReadInterruption()

        with _phase(ctx, "prepare"):
            pd = preparator.prepare(ctx, td)
        _sanity(pd, params.skip_sanity_check)
        if params.stop_after_prepare:
            raise StopAfterPrepareInterruption()

        models = []
        for i, algo in enumerate(algorithms):
            prev = (prev_models[i]
                    if prev_models is not None and i < len(prev_models)
                    else None)
            with _phase(ctx, f"train.algo{i}"):
                models.append(algo.train_with_previous(ctx, pd, prev)
                              if prev is not None else algo.train(ctx, pd))
        for model in models:
            _sanity(model, params.skip_sanity_check)
        return models

    # -- evaluation (Engine.scala:730-820; JAX engine.py:171-220) ----------
    def eval(self, ctx: RuntimeContext, engine_params: EngineParams,
             params: Optional[WorkflowParams] = None
             ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
        """``[(eval_info, [(query, served prediction, actual)])]``, one
        entry a fold of ``read_eval``: each fold's training set is
        prepared and trained on, its supplemented queries go through
        every algorithm's ``batch_predict``, the predictions are joined
        back by query index in algorithm order, and ``serve`` sees the
        original query (Engine.scala:805-808)."""
        data_source, preparator = self._data_components(engine_params)
        algo_list, serving = self.components(engine_params)
        out: List[Tuple[Any, List[Tuple[Any, Any, Any]]]] = []
        for td, eval_info, qa_pairs in data_source.read_eval(ctx):
            pd = preparator.prepare(ctx, td)
            models = [algo.train(ctx, pd) for algo in algo_list]
            qa_indexed = list(enumerate(qa_pairs))
            supplemented = [(qx, serving.supplement(q))
                            for qx, (q, _a) in qa_indexed]
            by_qx: Dict[int, List[Any]] = {qx: [] for qx, _ in supplemented}
            for algo, model in zip(algo_list, models):
                for qx, p in algo.batch_predict(model, supplemented):
                    by_qx[qx].append(p)
            qpa: List[Tuple[Any, Any, Any]] = []
            for qx, (q, a) in qa_indexed:
                if len(by_qx[qx]) != len(algo_list):
                    raise RuntimeError(
                        "Must have one prediction per algorithm")
                qpa.append((q, serving.serve(q, by_qx[qx]), a))
            out.append((eval_info, qpa))
        return out

    def batch_eval(self, ctx: RuntimeContext,
                   engine_params_list: Sequence[EngineParams],
                   params: Optional[WorkflowParams] = None
                   ) -> List[Tuple[EngineParams,
                                   List[Tuple[Any, List[Tuple[Any, Any,
                                                              Any]]]]]]:
        """BaseEngine.batchEval:82 — :meth:`eval` of every candidate."""
        return [(ep, self.eval(ctx, ep, params))
                for ep in engine_params_list]

    # -- deploy-time model restoration (Engine.scala:199-269) --------------
    def prepare_deploy(self, ctx: RuntimeContext, engine_params: EngineParams,
                       engine_instance_id: str, models: List[Any],
                       params: Optional[WorkflowParams] = None) -> List[Any]:
        """Turn checkpointed models into servable models on ``ctx.device``.

        Reference semantics: Unit models (non-serializable RDD models) are
        retrained at deploy (Engine.scala:211-233); PersistentModel
        manifests load through their companion loader (:241-255). Here a
        checkpointed model goes through its algorithm's ``prepare_model``
        (which puts its tensors on ``ctx.device``); a
        ``PersistentModelManifest`` loads through ``PersistentModel.load``
        first; and a ``RetrainMarker`` (the explicit form of the silent
        Unit model) trains the engine again."""
        from incubator_predictionio_tpu_torch.core.persistent_model import (
            PersistentModelManifest,
            RetrainMarker,
        )

        algo_list = self._algorithms(engine_params)
        if len(models) != len(algo_list):
            raise ValueError(
                f"{len(models)} models for {len(algo_list)} algorithms")
        if any(isinstance(m, RetrainMarker) for m in models):
            logger.info("Some models are retrain markers; retraining at "
                        "deploy.")
            trained = self.train(ctx, engine_params, params)
        else:
            trained = models
        out: List[Any] = []
        for algo, model in zip(algo_list, trained):
            if isinstance(model, PersistentModelManifest):
                model = model.load(algo.params, ctx)
            out.append(algo.prepare_model(ctx, model))
        return out

    # -- engine.json params extraction (Engine.scala:357-420) ---------------
    def jvalue_to_engine_params(self, variant: Dict[str, Any],
                                lenient: bool = True) -> EngineParams:
        """An ``engine.json`` variant → typed ``EngineParams``: each slot's
        ``params`` extracted into its component's Params class."""
        def one(slot: str, class_map: Dict[str, type],
                obj: Any) -> Tuple[str, Params]:
            if obj is None:
                return ("", EmptyParams())
            name = obj.get("name", "") if isinstance(obj, dict) else ""
            raw = obj.get("params", {}) if isinstance(obj, dict) else {}
            pcls = params_class_of(_select(class_map, name, slot))
            if pcls is None:
                return (name, EmptyParams() if not raw else raw)
            return (name, json_codec.extract(pcls, raw, lenient=lenient))

        return EngineParams(
            data_source_params=one("dataSource", self.data_source_class_map,
                                   variant.get("datasource")),
            preparator_params=one("preparator", self.preparator_class_map,
                                  variant.get("preparator")),
            algorithm_params_list=[
                one("algorithm", self.algorithm_class_map, spec)
                for spec in variant.get("algorithms") or ()],
            serving_params=one("serving", self.serving_class_map,
                               variant.get("serving")),
        )

    def engine_params_from_instance(self, instance: Any) -> EngineParams:
        """Typed ``EngineParams`` from a stored EngineInstance, whose slots
        hold ``json_codec.dumps`` of ``(name, params)``
        (Engine.engineInstanceToEngineParams, Engine.scala:422-470)."""
        def typed(slot: str, class_map: Dict[str, type], name: str,
                  params_obj: Any) -> Tuple[str, Params]:
            pcls = params_class_of(_select(class_map, name, slot))
            if pcls is None or not params_obj:
                return (name, EmptyParams())
            return (name, json_codec.extract(pcls, params_obj))

        def one(slot: str, class_map: Dict[str, type],
                raw: str) -> Tuple[str, Params]:
            if not raw:
                return ("", EmptyParams())
            return typed(slot, class_map, *json.loads(raw))

        return EngineParams(
            data_source_params=one("dataSource", self.data_source_class_map,
                                   instance.data_source_params),
            preparator_params=one("preparator", self.preparator_class_map,
                                  instance.preparator_params),
            algorithm_params_list=[
                typed("algorithm", self.algorithm_class_map, name, obj)
                for name, obj in json.loads(instance.algorithms_params
                                            or "[]")],
            serving_params=one("serving", self.serving_class_map,
                               instance.serving_params),
        )


class EngineFactory:
    """controller/EngineFactory.scala — subclass and implement ``apply``."""

    def apply(self) -> Engine:
        raise NotImplementedError

    def engine_params(self, variant: Dict[str, Any]) -> EngineParams:
        return self.apply().jvalue_to_engine_params(variant)
