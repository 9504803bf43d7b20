"""PersistentModel — opt-in custom model persistence.

The port's own copy of incubator_predictionio_tpu/core/persistent_model.py,
its imports rewritten to this package. One change: a manifest's class path
is read as the checkpoint decoder reads a model class
(``workflow.checkpoint.resolve_loaded``) — from a module already imported,
a path under the JAX package naming this package's module of the same
name — so loading a manifest imports nothing.

Parity: controller/PersistentModel.scala:17-115 (``save(id, params, sc)`` +
companion loader) and LocalFileSystemPersistentModel.scala:17-77. The
workflow checkpoints a :class:`PersistentModelManifest` in place of the model
blob and ``Engine.prepare_deploy`` calls ``load`` at deploy, exactly like the
reference resolves the manifest reflectively
(WorkflowUtils.SparkWorkflowUtils.getPersistentModel:347-386).

``RetrainMarker`` is the explicit replacement for the reference's "Unit
model" class: a parallel model that cannot be serialized is stored as Unit
and silently retrained at deploy (Engine.scala:211-233, CoreWorkflow
stores ``()``). On TPU every model is a checkpointable pytree, so this path
exists only for engines that *choose* train-at-deploy semantics.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from pathlib import Path
from typing import Any, Optional

from incubator_predictionio_tpu_torch.core.base import Params
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext


class PersistentModel:
    """Models implementing this manage their own persistence."""

    def save(self, instance_id: str, params: Params, ctx: RuntimeContext) -> bool:
        """Persist; return False to fall back to default checkpointing
        (PersistentModel.scala:84-90)."""
        raise NotImplementedError

    @classmethod
    def load(cls, instance_id: str, params: Params, ctx: RuntimeContext) -> Any:
        """Companion loader (PersistentModelLoader.apply)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PersistentModelManifest:
    """Stored in the model blob in place of a PersistentModel
    (workflow/PersistentModelManifest in CoreWorkflow.scala)."""

    class_path: str
    instance_id: str

    def load(self, params: Params, ctx: RuntimeContext) -> Any:
        from incubator_predictionio_tpu_torch.workflow.checkpoint import (
            CheckpointError,
            resolve_loaded,
        )

        module_name, _, cls_name = self.class_path.rpartition(".")
        cls = resolve_loaded(module_name, cls_name, self.class_path)
        if not (isinstance(cls, type) and issubclass(cls, PersistentModel)):
            raise CheckpointError(
                f"{self.class_path!r} is not a PersistentModel")
        return cls.load(self.instance_id, params, ctx)


@dataclasses.dataclass(frozen=True)
class RetrainMarker:
    """Explicit train-at-deploy marker (reference: the silent Unit model)."""


def model_store_path(instance_id: str, name: str = "model") -> Path:
    base = Path(os.environ.get("PIO_HOME", "~/.pio_tpu")).expanduser() / "pmodels"
    base.mkdir(parents=True, exist_ok=True)
    return base / f"{name}-{instance_id}.pkl"


class LocalFileSystemPersistentModel(PersistentModel):
    """Ready-made local-FS persistence via pickle
    (LocalFileSystemPersistentModel.scala:17-77 uses Spark saveAsObjectFile;
    same contract, local file)."""

    def save(self, instance_id: str, params: Params, ctx: RuntimeContext) -> bool:
        with open(model_store_path(instance_id, type(self).__name__), "wb") as f:
            pickle.dump(self, f)
        return True

    @classmethod
    def load(cls, instance_id: str, params: Params, ctx: RuntimeContext) -> Any:
        with open(model_store_path(instance_id, cls.__name__), "rb") as f:
            return pickle.load(f)
