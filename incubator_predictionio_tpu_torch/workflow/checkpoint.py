"""Model checkpointing — model dataclasses of tensors → durable blobs: the
port of incubator_predictionio_tpu/workflow/checkpoint.py.

Replaces the reference's Kryo serialization of trained models into the
MODELDATA repository (CoreWorkflow.scala:76-81, CreateServer.scala:73-87
KryoInstantiator). Tensors are fetched to host numpy on save
(:func:`host_materialize`) and restored as numpy on load; they go back to
the device in ``Algorithm.prepare_model`` (``Engine.prepare_deploy``).

Format (version 2), byte for byte the JAX package's: a magic header +
**msgpack of a structural encoding** — plain JSON-ish values pass through,
numpy arrays and tensors become (dtype, shape, raw bytes) tags, and model
objects are encoded as dataclass-field maps reconstructed through their
constructors. Loading never executes embedded code: the decoder resolves
model classes only from modules that are ALREADY imported (no import side
effects; see :func:`resolve_loaded`) and refuses anything that is not a
dataclass. A blob without the version-2 header is refused: this package
never wrote the pickle format of version 1.

A blob of either package decodes in the other. A model class of this
package is written under the JAX package's module path
(``incubator_predictionio_tpu.<same module>:<class>``), and such a path is
read back as this package's module of the same name — as a string only:
the JAX package is never imported. The class path of a
:class:`PersistentModelManifest` follows the same rule. Fields a class lists in
``__checkpoint_skip__`` (ones its JAX counterpart does not have) are not
written and take their defaults on load.

The reference's three model classes (SURVEY.md §5 checkpoint/resume):
serializable models → stored as-is; RDD models → stored as Unit + silently
retrained at deploy; PersistentModel → custom save/load. Here: dataclass
models are storable, :class:`~...core.persistent_model.RetrainMarker`
makes the retrain path explicit, and PersistentModel keeps its contract.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from typing import Any, List, Optional

from incubator_predictionio_tpu_torch.core.persistent_model import (
    PersistentModel,
    PersistentModelManifest,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.utils.structcodec import StructCodec

logger = logging.getLogger(__name__)

_MAGIC_V2 = b"PIOCKPT2"
#: this package's module prefix, and the one its blobs carry (the JAX
#: package's)
_PORT_PREFIX = "incubator_predictionio_tpu_torch."
_JAX_PREFIX = "incubator_predictionio_tpu."
_FORMAT_VERSION = 2

#: structural tag key — a reserved dict key marking an encoded object
_TAG = "~pio~"


class CheckpointError(ValueError):
    """A model (or blob) outside the safe checkpoint format."""


# ---------------------------------------------------------------------------
# structural encode / decode — the shared codec (utils/structcodec.py, same
# core the remote-storage wire protocol uses) plus the dataclass tag
# ---------------------------------------------------------------------------

def blob_module(name: str) -> str:
    """The module name a blob carries for a module of this package: the
    JAX package's of the same name."""
    if name.startswith(_PORT_PREFIX):
        return _JAX_PREFIX + name[len(_PORT_PREFIX):]
    return name


def port_module(name: str) -> str:
    """The module of this package that a module name of the JAX package
    stands for, the same path under this package (found by name, never
    imported); any other name is itself. The inverse of
    :func:`blob_module`."""
    if (name + ".").startswith(_JAX_PREFIX):
        return _PORT_PREFIX[:-1] + name[len(_JAX_PREFIX) - 1:]
    return name


def _class_path(cls: type) -> str:
    """``module:qualname`` as blobs carry it (:func:`blob_module`)."""
    return f"{blob_module(cls.__module__)}:{cls.__qualname__}"


def _encode_ext(obj: Any, codec: Any) -> Any:
    # dataclass instances (the model nodes) — checked here so the
    # checkpoint error message stays domain-specific for everything else
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        skip = getattr(cls, "__checkpoint_skip__", ())
        fields = {
            f.name: codec.encode(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name not in skip
        }
        return {_TAG: "dc", "c": _class_path(cls), "f": fields}
    return NotImplemented


def _encode(obj: Any) -> Any:
    try:
        return _CODEC.encode(obj)
    except CheckpointError as e:
        raise CheckpointError(
            f"{e}: models must be dataclasses / pytrees of arrays and "
            "plain values (or implement PersistentModel for custom "
            "persistence)"
        ) from None


def resolve_loaded(mod_name: str, qual: str, path: str) -> Any:
    """``qual`` in the ALREADY-IMPORTED module ``mod_name``; a module under
    the JAX package names this package's module of the same name.

    The decoder never imports a module: importing runs the module's
    top-level code, which would let a tampered blob execute an arbitrary
    installed module as a side effect, and a JAX package path would load
    JAX. Engine model classes are always imported before models load
    (deploy resolves the engine factory first), so a sys.modules miss
    means a truly foreign blob, and it is refused. ``path`` names the
    class in the error."""
    mod = sys.modules.get(port_module(mod_name))
    if mod is None:
        raise CheckpointError(
            f"model class {path!r} lives in a module that is not "
            "imported; import your engine module before loading the "
            "checkpoint")
    try:
        obj: Any = mod
        for part in qual.split("."):
            obj = getattr(obj, part)
    except AttributeError as e:
        raise CheckpointError(f"cannot resolve model class {path!r}: {e}")
    return obj


def _resolve_dataclass(path: str) -> type:
    mod_name, _, qual = path.partition(":")
    cls = resolve_loaded(mod_name, qual, path)
    if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)):
        # the decoder only ever constructs dataclasses — anything else in
        # the class slot is a malformed (or malicious) blob
        raise CheckpointError(f"{path!r} is not a dataclass")
    return cls


def _decode_ext(tag: str, obj: dict, codec: Any) -> Any:
    if tag == "dc":
        cls = _resolve_dataclass(obj["c"])
        fields = {k: codec.decode(v) for k, v in obj["f"].items()}
        return cls(**fields)
    return NotImplemented


_CODEC = StructCodec(_TAG, CheckpointError, _encode_ext, _decode_ext)


def _decode(obj: Any) -> Any:
    return _CODEC.decode(obj)


# ---------------------------------------------------------------------------
# blob API
# ---------------------------------------------------------------------------

def dumps(obj: Any) -> bytes:
    """Encode a model pytree into a version-2 checkpoint blob."""
    import msgpack

    payload = msgpack.packb(
        {"version": _FORMAT_VERSION, "root": _encode(obj)},
        use_bin_type=True,
    )
    return _MAGIC_V2 + payload


def _same(obj: Any) -> Any:
    return obj


def loads(data: bytes) -> Any:
    """Decode a version-2 checkpoint blob; anything else is refused."""
    import msgpack

    if data[: len(_MAGIC_V2)] != _MAGIC_V2:
        raise CheckpointError(
            "not a version-2 model blob (no PIOCKPT2 header); retrain to "
            "checkpoint in the safe format")
    # every map and array passes through a Python hook (the identity), so
    # the interpreter can hand its lock to other threads during the decode:
    # without one, a model of ML-20M's users is a single C call holding it
    # for most of a second, which stalls a prediction server's dispatcher
    # through a POST /reload
    doc = msgpack.unpackb(
        data[len(_MAGIC_V2):], raw=False, strict_map_key=False,
        object_hook=_same, list_hook=_same)
    if doc.get("version") != _FORMAT_VERSION:
        raise CheckpointError(
            f"Unsupported model blob version {doc.get('version')}")
    return _decode(doc["root"])


def serialize_models(
    models: List[Any],
    instance_id: str,
    ctx: RuntimeContext,
    algo_params: Optional[List[Any]] = None,
) -> bytes:
    """Make the model list durable (Engine.makeSerializableModels:286 +
    CoreWorkflow kryo step). PersistentModels run their own ``save`` and are
    replaced by manifests; every other model is written with its tensors
    fetched to the host (:func:`host_materialize`)."""
    out: List[Any] = []
    algo_params = algo_params or [None] * len(models)
    for model, params in zip(models, algo_params):
        if isinstance(model, PersistentModel):
            cls = type(model)
            if model.save(instance_id, params, ctx):
                out.append(
                    PersistentModelManifest(
                        class_path=(f"{blob_module(cls.__module__)}."
                                    f"{cls.__qualname__}"),
                        instance_id=instance_id,
                    )
                )
                continue
            logger.info(
                "%s.save returned False; falling back to default "
                "checkpointing", cls.__name__,
            )
        out.append(host_materialize(model))
    return dumps(out)


def deserialize_models(data: bytes) -> List[Any]:
    models = loads(data)
    if not isinstance(models, list):
        raise CheckpointError("Model blob does not contain a model list")
    return models


def host_materialize(obj: Any) -> Any:
    """A copy of a model structure with every tensor found anywhere in it
    fetched to host numpy (its dtype kept).

    The walk mirrors the checkpoint encoder (``_encode_ext``): it recurses
    into dataclass fields, dicts, lists and tuples by hand; other values
    are shared, not copied."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # copy + setattr instead of dataclasses.replace: replace() refuses
        # init=False fields and re-runs __init__ (breaking on InitVars),
        # and object.__setattr__ also covers frozen dataclasses
        import copy

        new = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(
                new, f.name, host_materialize(getattr(obj, f.name)))
        return new
    if isinstance(obj, dict):
        return {k: host_materialize(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        # namedtuple: the constructor takes N positional args, not one
        # iterable (a plain tuple(<generator>) call would TypeError here)
        return type(obj)(*(host_materialize(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_materialize(v) for v in obj)
    return obj
