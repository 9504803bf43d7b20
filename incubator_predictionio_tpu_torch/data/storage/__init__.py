"""Storage registry — env-driven backend selection and DAO factory: the
port's own copy of incubator_predictionio_tpu/data/storage/__init__.py. It
registers ``memory``, ``sqlite``, ``localfs``, ``cpplog`` (the native
event log: events only, so metadata and models stay on sqlite, memory or
localfs, as in the JAX package), ``remote`` (the client of a shared
``pio storageserver``, ``remote.py`` and ``server.py``) and ``gcs`` (model
blobs in a GCS bucket).

Parity: data/.../storage/Storage.scala:117-407. Configuration comes from the
same env-var scheme as the reference:

- ``PIO_STORAGE_SOURCES_<NAME>_TYPE``  — backend type (memory | sqlite | localfs
  | cpplog | remote | gcs)
- ``PIO_STORAGE_SOURCES_<NAME>_<KEY>`` — backend properties (e.g. ``PATH``)
- ``PIO_STORAGE_REPOSITORIES_<REPO>_NAME`` / ``_SOURCE`` for
  ``<REPO>`` ∈ {METADATA, EVENTDATA, MODELDATA}

(Storage.scala:127-196 parses the same shapes.) Differences by design: backend
lookup goes through an explicit registry instead of JVM reflection on class
names (Storage.scala:286-303), and unset env falls back to a working
single-box default (SQLite under ``$PIO_HOME``) instead of erroring.
"""

from __future__ import annotations

import importlib
import os
import threading
from typing import Any, Dict, Optional, Type

from incubator_predictionio_tpu_torch.data.storage import base
from incubator_predictionio_tpu_torch.data.storage.base import (  # re-export
    AccessKey,
    AccessKeys,
    App,
    Apps,
    BaseStorageClient,
    Channel,
    Channels,
    EngineInstance,
    EngineInstances,
    EngineManifest,
    EngineManifests,
    EvaluationInstance,
    EvaluationInstances,
    Events,
    Model,
    Models,
    StorageClientConfig,
    StorageError,
    UNSET,
    is_valid_channel_name,
)

__all__ = [
    "AccessKey", "AccessKeys", "App", "Apps", "Channel", "Channels",
    "EngineInstance", "EngineInstances", "EngineManifest", "EngineManifests",
    "EvaluationInstance",
    "EvaluationInstances", "Events", "Model", "Models", "Storage", "is_valid_channel_name",
    "StorageClientConfig", "StorageError", "UNSET", "BaseStorageClient",
    "UnsupportedMethodError", "AmbiguousWriteError",
]

#: backend type name -> module path providing StorageClient + DATA_OBJECTS
_BACKENDS: Dict[str, str] = {
    "memory": "incubator_predictionio_tpu_torch.data.storage.memory",
    "sqlite": "incubator_predictionio_tpu_torch.data.storage.sqlite",
    "localfs": "incubator_predictionio_tpu_torch.data.storage.localfs",
    # native append-only event log (the HBase-driver role; events only)
    "cpplog": "incubator_predictionio_tpu_torch.data.storage.cpplog",
    # network client for a shared StorageServer (the multi-box topology —
    # the role PostgreSQL/HBase play for the reference)
    "remote": "incubator_predictionio_tpu_torch.data.storage.remote",
    # GCS bucket model-blob store (the HDFSModels role)
    "gcs": "incubator_predictionio_tpu_torch.data.storage.gcs",
}

MetaDataRepository = "METADATA"
EventDataRepository = "EVENTDATA"
ModelDataRepository = "MODELDATA"


class UnsupportedMethodError(StorageError):
    """An optional DAO capability this backend does not implement (e.g.
    columnar ``insert_interactions`` on a backend without a columnar
    write path). Crosses the remote-storage wire typed, so callers can
    cache the capability answer instead of retrying per request."""


class AmbiguousWriteError(StorageError):
    """A non-idempotent remote write whose response was lost AFTER the
    request hit the wire: the write may or may not have been applied.
    Raised instead of retrying (a retry could double-apply); callers must
    surface the ambiguity — falling back to a different write path would
    silently duplicate the data."""


def register_backend(type_name: str, module_path: str) -> None:
    """Register an external backend (replaces classpath reflection)."""
    _BACKENDS[type_name] = module_path


def pio_home() -> str:
    return os.environ.get("PIO_HOME", os.path.expanduser("~/.pio_tpu"))


class Storage:
    """Process-wide storage registry (the reference's ``Storage`` object)."""

    _lock = threading.RLock()
    _clients: Dict[str, Any] = {}
    _env: Optional[Dict[str, str]] = None

    # -- configuration -----------------------------------------------------
    @classmethod
    def configure(cls, env: Optional[Dict[str, str]] = None) -> None:
        """Install an explicit configuration (tests) or re-read os.environ."""
        with cls._lock:
            cls.close()
            cls._env = dict(env) if env is not None else None

    @classmethod
    def reset(cls) -> None:
        cls.configure(None)

    @classmethod
    def _environ(cls) -> Dict[str, str]:
        return cls._env if cls._env is not None else dict(os.environ)

    @classmethod
    def _source_keys(cls) -> list[str]:
        """Names of configured sources (Storage.scala:140 sourcesPrefix scan)."""
        env = cls._environ()
        keys = set()
        for k in env:
            if k.startswith("PIO_STORAGE_SOURCES_"):
                rest = k[len("PIO_STORAGE_SOURCES_"):]
                name = rest.split("_", 1)[0]
                if name:
                    keys.add(name)
        return sorted(keys)

    @classmethod
    def _source_config(cls, name: str) -> tuple[str, StorageClientConfig]:
        env = cls._environ()
        prefix = f"PIO_STORAGE_SOURCES_{name}_"
        props = {
            k[len(prefix):]: v for k, v in env.items() if k.startswith(prefix)
        }
        type_name = props.pop("TYPE", None)
        if type_name is None:
            raise StorageError(
                f"Storage source {name} has no PIO_STORAGE_SOURCES_{name}_TYPE"
            )
        config = StorageClientConfig(
            parallel=props.pop("PARALLEL", "false").lower() == "true",
            test=props.pop("TEST", "false").lower() == "true",
            properties=props,
        )
        return type_name, config

    @classmethod
    def repository(cls, repo: str) -> tuple[str, str]:
        """(namespace, source-name) for a repository, with single-box defaults."""
        env = cls._environ()
        name = env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_NAME")
        source = env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
        if name and source:
            return name, source
        if name or source:
            # Half-configured repository is a misconfiguration, not a
            # fall-through (Storage.scala errors on incomplete repo config).
            raise StorageError(
                f"Repository {repo} needs BOTH PIO_STORAGE_REPOSITORIES_{repo}"
                f"_NAME and _SOURCE (got NAME={name!r}, SOURCE={source!r})"
            )
        # Defaults: one SQLite source for everything (zero-config single box).
        return {
            MetaDataRepository: ("pio_meta", "DEFAULT"),
            EventDataRepository: ("pio_event", "DEFAULT"),
            ModelDataRepository: ("pio_model", "DEFAULT"),
        }[repo]

    # -- clients and DAOs --------------------------------------------------
    @classmethod
    def _get_client(cls, source_name: str) -> Any:
        with cls._lock:
            if source_name in cls._clients:
                return cls._clients[source_name]
            if source_name == "DEFAULT" and source_name not in cls._source_keys():
                type_name = "sqlite"
                config = StorageClientConfig(
                    properties={
                        "PATH": os.path.join(pio_home(), "store", "pio.db")
                    }
                )
            else:
                type_name, config = cls._source_config(source_name)
            module_path = _BACKENDS.get(type_name)
            if module_path is None:
                raise StorageError(
                    f"Unknown storage backend type {type_name!r} "
                    f"(known: {sorted(_BACKENDS)})"
                )
            module = importlib.import_module(module_path)
            client = module.StorageClient(config)
            cls._clients[source_name] = (client, module, config)
            return cls._clients[source_name]

    @classmethod
    def get_data_object(cls, repo: str, iface: str) -> Any:
        """DAO factory (Storage.scala getDataObject:276-303)."""
        namespace, source_name = cls.repository(repo)
        client, module, config = cls._get_client(source_name)
        dao_cls: Optional[Type[Any]] = module.DATA_OBJECTS.get(iface)
        if dao_cls is None:
            raise StorageError(
                f"Backend {module.__name__} does not implement {iface}"
            )
        return dao_cls(client, config, prefix=namespace + "_")

    # Typed accessors (Storage.scala:364-407)
    @classmethod
    def get_meta_data_apps(cls) -> Apps:
        return cls.get_data_object(MetaDataRepository, "Apps")

    @classmethod
    def get_meta_data_access_keys(cls) -> AccessKeys:
        return cls.get_data_object(MetaDataRepository, "AccessKeys")

    @classmethod
    def get_meta_data_channels(cls) -> Channels:
        return cls.get_data_object(MetaDataRepository, "Channels")

    @classmethod
    def get_meta_data_engine_instances(cls) -> EngineInstances:
        return cls.get_data_object(MetaDataRepository, "EngineInstances")

    @classmethod
    def get_meta_data_engine_manifests(cls) -> EngineManifests:
        return cls.get_data_object(MetaDataRepository, "EngineManifests")

    @classmethod
    def get_meta_data_evaluation_instances(cls) -> EvaluationInstances:
        return cls.get_data_object(MetaDataRepository, "EvaluationInstances")

    @classmethod
    def get_model_data_models(cls) -> Models:
        return cls.get_data_object(ModelDataRepository, "Models")

    @classmethod
    def get_events(cls) -> Events:
        """The event DAO (Storage.getLEvents/getPEvents:387-393 — the L/P
        split collapses on TPU; see base.Events docstring)."""
        return cls.get_data_object(EventDataRepository, "Events")

    @classmethod
    def verify_all_data_objects(cls) -> bool:
        """End-to-end config validation (Storage.verifyAllDataObjects:338-361)."""
        cls.get_meta_data_apps()
        cls.get_meta_data_access_keys()
        cls.get_meta_data_channels()
        cls.get_meta_data_engine_instances()
        cls.get_meta_data_engine_manifests()
        cls.get_meta_data_evaluation_instances()
        cls.get_model_data_models()
        events = cls.get_events()
        events.init(0)
        events.remove(0)
        return True

    @classmethod
    def close(cls) -> None:
        with cls._lock:
            for client, _module, _config in cls._clients.values():
                try:
                    client.close()
                except Exception:
                    pass
            cls._clients.clear()
