"""CoreWorkflow — the training driver and the deploy-time model load: the
port of incubator_predictionio_tpu/workflow/workflow.py (``run_train``
:112, ``load_models`` :294; reference workflow/CoreWorkflow.scala:45-160).

``run_train``: register an INIT EngineInstance → TRAINING → build the
RuntimeContext → ``engine.train`` → checkpoint the models into MODELDATA
→ mark COMPLETED (ABORTED on any error). The instance keeps the engine
params as the JAX package writes them (``json_codec.dumps`` of each slot),
so ``EngineInstances.get_latest_completed`` finds it for deploy, and the
run's phase walls (``ctx.timings``) in its ``runtime_conf``.

``load_models``: the instance's blob → models → ``Engine.prepare_deploy``
on the context's device.

Not ported: the multi-host pod branch (ROADMAP Queue 1, multi-device),
``run_evaluation`` (Queue 1, evaluation) and the continuation retrain
(Queue 1 item 5): a second train with equal params trains from scratch
here, where the JAX package continues from the last COMPLETED instance by
default (``PIO_RETRAIN_CONTINUE``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, List, Optional

from incubator_predictionio_tpu_torch.core.engine import Engine
from incubator_predictionio_tpu_torch.core.params import (
    EngineParams,
    WorkflowParams,
)
from incubator_predictionio_tpu_torch.data.storage import (
    EngineInstance,
    Model,
    Storage,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.utils import json_codec
from incubator_predictionio_tpu_torch.utils.times import now_utc
from incubator_predictionio_tpu_torch.workflow import checkpoint

logger = logging.getLogger(__name__)


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
        the device and, after the run, its phase walls: ``read``,
        ``prepare``, ``train.algo<i>``, what the algorithms add, and
        ``checkpoint``."""
        if prev_models is not None:
            raise NotImplementedError(
                "continuation retrain (prev_models) is not ported yet: "
                "ROADMAP.md Queue 1 item 5")
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
            models = engine.train(ctx, engine_params, params)
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
