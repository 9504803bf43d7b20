"""FastEvalEngine — batch evaluation with pipeline-prefix memoization:
the port's own copy of incubator_predictionio_tpu/core/fast_eval.py.

Parity: controller/FastEvalEngine.scala:46-346. When scoring many
EngineParams candidates, pipeline prefixes shared between candidates
(data source read → preparation → algorithm training → serving) are computed
once: a candidate differing only in serving params reuses the trained models;
one differing only in algorithm params reuses the prepared data, etc. Caches
are keyed on the serialized params prefix exactly like the reference's
``DataSourcePrefix`` / ``PreparatorPrefix`` / ``AlgorithmsPrefix`` /
``ServingPrefix`` case-class keys (FastEvalEngine.scala:60-130).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

from incubator_predictionio_tpu_torch.core.base import EmptyParams, doer
from incubator_predictionio_tpu_torch.core.engine import Engine, _select
from incubator_predictionio_tpu_torch.core.params import EngineParams, WorkflowParams
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.utils import json_codec
from incubator_predictionio_tpu_torch.utils.annotations import experimental

logger = logging.getLogger(__name__)


def _key(*parts: Any) -> str:
    return json.dumps([json_codec.to_jsonable(p) for p in parts], sort_keys=True)


@experimental
class FastEvalEngineWorkflow:
    """Holds the prefix caches for one batch_eval run
    (FastEvalEngine.scala:215-264)."""

    def __init__(self, engine: "FastEvalEngine", ctx: RuntimeContext,
                 params: Optional[WorkflowParams] = None):
        self.engine = engine
        self.ctx = ctx
        self.params = params or WorkflowParams()
        self.data_source_cache: Dict[str, Any] = {}
        self.preparator_cache: Dict[str, Any] = {}
        self.algorithms_cache: Dict[str, Any] = {}
        self.serving_cache: Dict[str, Any] = {}

    # each get_* returns per-eval-set lists, caching on the params prefix
    def get_eval_sets(self, ds_pair: Tuple[str, Any]) -> Any:
        k = _key(ds_pair)
        if k not in self.data_source_cache:
            name, p = ds_pair
            ds = doer(_select(self.engine.data_source_class_map, name, "dataSource"), p)
            self.data_source_cache[k] = ds.read_eval(self.ctx)
        return self.data_source_cache[k]

    def get_prepared(self, ds_pair, prep_pair) -> Any:
        k = _key(ds_pair, prep_pair)
        if k not in self.preparator_cache:
            name, p = prep_pair
            prep = doer(_select(self.engine.preparator_class_map, name, "preparator"), p)
            self.preparator_cache[k] = [
                (prep.prepare(self.ctx, td), info, qas)
                for td, info, qas in self.get_eval_sets(ds_pair)
            ]
        return self.preparator_cache[k]

    def get_models(self, ds_pair, prep_pair, algo_list) -> Any:
        k = _key(ds_pair, prep_pair, algo_list)
        if k not in self.algorithms_cache:
            algos = [
                doer(_select(self.engine.algorithm_class_map, name, "algorithm"), p)
                for name, p in algo_list
            ]
            self.algorithms_cache[k] = [
                ([a.train(self.ctx, pd) for a in algos], algos)
                for pd, _info, _qas in self.get_prepared(ds_pair, prep_pair)
            ]
        return self.algorithms_cache[k]

    def get_result(self, engine_params: EngineParams) -> Any:
        ds_pair = engine_params.data_source_params
        prep_pair = engine_params.preparator_params
        algo_list = engine_params.algorithm_params_list or [("", EmptyParams())]
        serv_pair = engine_params.serving_params
        k = _key(ds_pair, prep_pair, algo_list, serv_pair)
        if k not in self.serving_cache:
            name, p = serv_pair
            serving = doer(_select(self.engine.serving_class_map, name, "serving"), p)
            prepared = self.get_prepared(ds_pair, prep_pair)
            models_per_set = self.get_models(ds_pair, prep_pair, algo_list)
            out = []
            for (pd, info, qas), (models, algos) in zip(prepared, models_per_set):
                qa_indexed = list(enumerate(qas))
                supplemented = [(qx, serving.supplement(q)) for qx, (q, _a) in qa_indexed]
                by_qx: Dict[int, List[Any]] = {qx: [] for qx, _ in supplemented}
                for algo, model in zip(algos, models):
                    for qx, pred in algo.batch_predict(model, supplemented):
                        by_qx[qx].append(pred)
                qpa = [
                    (q, serving.serve(q, by_qx[qx]), a)
                    for qx, (q, a) in qa_indexed
                ]
                out.append((info, qpa))
            self.serving_cache[k] = out
        return self.serving_cache[k]


@experimental
class FastEvalEngine(Engine):
    """Engine whose batch_eval memoizes pipeline prefixes.

    Only for evaluation — ``train`` behaves exactly like Engine
    (FastEvalEngine.scala:292-310 throws on train; we allow it since the
    implementation is shared and correct).
    """

    def batch_eval(
        self,
        ctx: RuntimeContext,
        engine_params_list: Sequence[EngineParams],
        params: Optional[WorkflowParams] = None,
    ) -> List[Tuple[EngineParams, Any]]:
        workflow = FastEvalEngineWorkflow(self, ctx, params)
        return [(ep, workflow.get_result(ep)) for ep in engine_params_list]
