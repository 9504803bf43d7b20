"""CoreWorkflow — the training driver and the deploy-time model load: the
port of incubator_predictionio_tpu/workflow/workflow.py (``run_train``
:112, ``load_models`` :294; reference workflow/CoreWorkflow.scala:45-160).

``run_train``: register an INIT EngineInstance → TRAINING → build the
RuntimeContext → the continuation seed (the last COMPLETED instance's
models, :func:`_continuation_models`) → ``engine.train`` → checkpoint the
models into MODELDATA → mark COMPLETED (ABORTED on any error). The
instance keeps the engine params as the JAX package writes them
(``json_codec.dumps`` of each slot), so
``EngineInstances.get_latest_completed`` finds it for deploy, and the
run's phase walls (``ctx.timings``, ``continue_seed`` among them) in its
``runtime_conf``.

``load_models``: the instance's blob → models → ``Engine.prepare_deploy``
on the context's device.

``run_evaluation`` (JAX :323-441, EvaluationWorkflow.scala:30-43): register
an EVALUATING EvaluationInstance → ``engine.batch_eval`` → the evaluator →
store its one-liner, HTML and JSON → EVALCOMPLETED (EVALABORTED on any
error; a FakeWorkflow result, ``no_save``, stores no results).

Not ported: the multi-host pod branch of ``run_train`` and
``run_evaluation`` (ROADMAP Queue 1 item 9; the CLI refuses ``--hosts``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Any, List, Optional, Sequence, Tuple

from incubator_predictionio_tpu_torch.core.engine import Engine
from incubator_predictionio_tpu_torch.core.params import (
    EngineParams,
    WorkflowParams,
)
from incubator_predictionio_tpu_torch.data.storage import (
    EngineInstance,
    EvaluationInstance,
    Model,
    Storage,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.utils import json_codec
from incubator_predictionio_tpu_torch.utils.times import now_utc
from incubator_predictionio_tpu_torch.workflow import checkpoint

logger = logging.getLogger(__name__)


def _continuation_models(engine_params: EngineParams, engine_id: str,
                         engine_version: str,
                         engine_variant: str) -> Optional[List[Any]]:
    """The last COMPLETED run's models (decoded, arrays in host numpy),
    to seed the continuation retrain, or None where continuation is off
    (``PIO_RETRAIN_CONTINUE=0``) or does not apply (JAX workflow.py:45).

    Any difference in the stored data-source, preparator or algorithm
    params turns it off: a changed rank or λ makes the factors unusable,
    and a changed data spec rebuilds the id space the prefix mapping
    relies on. A model that fails to load degrades to a fresh train:
    continuation is an optimization, never a correctness dependency."""
    from incubator_predictionio_tpu_torch.ops.retrain import (
        continue_enabled,
    )

    if not continue_enabled():
        return None
    try:
        prev = Storage.get_meta_data_engine_instances().get_latest_completed(
            engine_id, engine_version, engine_variant)
        if prev is None:
            return None
        current = (json_codec.dumps(engine_params.data_source_params),
                   json_codec.dumps(engine_params.preparator_params),
                   json_codec.dumps(engine_params.algorithm_params_list))
        stored = (prev.data_source_params, prev.preparator_params,
                  prev.algorithms_params)
        if current != stored:
            logger.info("continuation disabled: engine params changed "
                        "since instance %s", prev.id)
            return None
        blob = Storage.get_model_data_models().get(prev.id)
        if blob is None:
            return None
        models = checkpoint.deserialize_models(blob.models)
        logger.info("continuation: seeding retrain from instance %s",
                    prev.id)
        return models
    except Exception:
        logger.exception("continuation model load failed; training fresh")
        return None


def make_runtime_context(workflow_params: Optional[WorkflowParams] = None,
                         device=None) -> RuntimeContext:
    """WorkflowContext.scala parity: the run's context on ``device`` (CUDA
    unless the caller asks for another), seeded by ``runtime_conf["seed"]``."""
    conf = dict((workflow_params.runtime_conf if workflow_params else {})
                or {})
    return RuntimeContext(device=device, seed=int(conf.get("seed", 0)))


class CoreWorkflow:
    TRAIN_STATUS_INIT = "INIT"
    TRAIN_STATUS_TRAINING = "TRAINING"
    TRAIN_STATUS_COMPLETED = "COMPLETED"
    TRAIN_STATUS_ABORTED = "ABORTED"
    EVAL_STATUS_EVALUATING = "EVALUATING"
    EVAL_STATUS_COMPLETED = "EVALCOMPLETED"
    EVAL_STATUS_ABORTED = "EVALABORTED"

    @staticmethod
    def run_train(
        engine: Engine,
        engine_params: EngineParams,
        engine_id: str = "default",
        engine_version: str = "NOT_VERSIONED",
        engine_variant: str = "default",
        engine_factory: str = "",
        params: Optional[WorkflowParams] = None,
        ctx: Optional[RuntimeContext] = None,
        env: Optional[dict] = None,
        prev_models: Optional[List[Any]] = None,
        device=None,
    ) -> str:
        """Train, checkpoint, register. Returns the engine instance id.
        ``ctx`` (or else a context on ``device``, CUDA by default) carries
        the device and, after the run, its phase walls: ``continue_seed``,
        ``read``, ``prepare``, ``train.algo<i>``, what the algorithms add,
        and ``checkpoint``.

        ``prev_models`` is the explicit continuation seam: those models
        seed the retrain directly, for a caller that holds (and vouches
        for) a compatible model, with no instance lookup and no params
        check. None, the normal path, loads the last COMPLETED instance's
        models behind ``PIO_RETRAIN_CONTINUE`` and the params check
        (:func:`_continuation_models`)."""
        params = params or WorkflowParams()
        ctx = ctx or make_runtime_context(params, device)
        train_start = now_utc()
        instances = Storage.get_meta_data_engine_instances()
        instance = EngineInstance(
            id="",
            status=CoreWorkflow.TRAIN_STATUS_INIT,
            start_time=train_start,
            end_time=now_utc(),
            engine_id=engine_id,
            engine_version=engine_version,
            engine_variant=engine_variant,
            engine_factory=engine_factory,
            batch=params.batch,
            env=dict(env or {}),
            runtime_conf=dict(params.runtime_conf),
            data_source_params=json_codec.dumps(
                engine_params.data_source_params),
            preparator_params=json_codec.dumps(
                engine_params.preparator_params),
            algorithms_params=json_codec.dumps(
                engine_params.algorithm_params_list),
            serving_params=json_codec.dumps(engine_params.serving_params),
        )
        instance_id = instances.insert(instance)
        instance = dataclasses.replace(instance, id=instance_id)
        logger.info("Training engine instance %s", instance_id)
        try:
            instances.update(dataclasses.replace(
                instance, status=CoreWorkflow.TRAIN_STATUS_TRAINING))
            t0 = time.perf_counter()
            if prev_models is None:
                prev_models = _continuation_models(
                    engine_params, engine_id, engine_version, engine_variant)
            seed_s = time.perf_counter() - t0
            models = engine.train(ctx, engine_params, params,
                                  prev_models=prev_models)
            ctx.timings["continue_seed"] = seed_s
            algo_params = [p for _n, p in engine_params.algorithm_params_list]
            t0 = time.perf_counter()
            blob = checkpoint.serialize_models(models, instance_id, ctx,
                                               algo_params=algo_params)
            Storage.get_model_data_models().insert(Model(instance_id, blob))
            ctx.timings["checkpoint"] = time.perf_counter() - t0
            instances.update(dataclasses.replace(
                instance,
                status=CoreWorkflow.TRAIN_STATUS_COMPLETED,
                end_time=now_utc(),
                runtime_conf={
                    **instance.runtime_conf,
                    **{f"phase.{name}_s": f"{secs:.6f}"
                       for name, secs in ctx.timings.items()}},
            ))
            logger.info("Training completed; engine instance %s saved (%d "
                        "bytes of models)", instance_id, len(blob))
        except Exception:
            instances.update(dataclasses.replace(
                instance, status=CoreWorkflow.TRAIN_STATUS_ABORTED,
                end_time=now_utc()))
            raise
        return instance_id

    @staticmethod
    def load_models(
        instance_id: str,
        engine: Optional[Engine] = None,
        engine_params: Optional[EngineParams] = None,
        ctx: Optional[RuntimeContext] = None,
        params: Optional[WorkflowParams] = None,
        device=None,
    ) -> List[Any]:
        """Restore the checkpointed models of an engine instance
        (CreateServer.scala:216-220 + Engine.prepareDeploy). With an engine
        and its params the models go through ``Engine.prepare_deploy`` on
        ``ctx`` (or a context on ``device``, CUDA by default); without,
        they come back as decoded, arrays in host numpy.

        The decoder resolves model classes from ALREADY-IMPORTED modules
        only (``checkpoint.resolve_loaded``): import the engine module
        first."""
        blob = Storage.get_model_data_models().get(instance_id)
        if blob is None:
            raise ValueError(
                f"No models stored for engine instance {instance_id}")
        models = checkpoint.deserialize_models(blob.models)
        if engine is not None and engine_params is not None:
            ctx = ctx or make_runtime_context(params, device)
            models = engine.prepare_deploy(ctx, engine_params, instance_id,
                                           models, params)
        return models

    @staticmethod
    def run_evaluation(
        evaluation: Any,
        engine_params_list: Sequence[EngineParams],
        evaluation_class: str = "",
        engine_params_generator_class: str = "",
        params: Optional[WorkflowParams] = None,
        ctx: Optional[RuntimeContext] = None,
        env: Optional[dict] = None,
        device=None,
    ) -> Tuple[str, Any]:
        """Evaluate every candidate on ``ctx`` (or a context on
        ``device``, CUDA by default) → (evaluation instance id, the
        evaluator's result)."""
        params = params or WorkflowParams()
        ctx = ctx or make_runtime_context(params, device)
        instances = Storage.get_meta_data_evaluation_instances()
        instance = EvaluationInstance(
            id="",
            status=CoreWorkflow.EVAL_STATUS_EVALUATING,
            start_time=now_utc(),
            end_time=now_utc(),
            evaluation_class=evaluation_class,
            engine_params_generator_class=engine_params_generator_class,
            batch=params.batch,
            env=dict(env or {}),
            runtime_conf=dict(params.runtime_conf),
        )
        instance_id = instances.insert(instance)
        instance = dataclasses.replace(instance, id=instance_id)
        try:
            eval_data = evaluation.engine.batch_eval(
                ctx, engine_params_list, params)
            result = evaluation.evaluator.evaluate(
                ctx, evaluation, eval_data, params)
            done = dataclasses.replace(
                instance, status=CoreWorkflow.EVAL_STATUS_COMPLETED,
                end_time=now_utc())
            if not getattr(result, "no_save", False):
                # a FakeWorkflow result is not persisted
                # (CoreWorkflow.scala:138-142 noSave branch)
                done = dataclasses.replace(
                    done,
                    evaluator_results=result.to_one_liner(),
                    evaluator_results_html=result.to_html(),
                    evaluator_results_json=json.dumps(result.to_jsonable()))
                logger.info("Evaluation %s completed: %s", instance_id,
                            result.to_one_liner())
            instances.update(done)
            return instance_id, result
        except Exception:
            logger.exception("Evaluation %s aborted", instance_id)
            instances.update(dataclasses.replace(
                instance, status=CoreWorkflow.EVAL_STATUS_ABORTED,
                end_time=now_utc()))
            raise
