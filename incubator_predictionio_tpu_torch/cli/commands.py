"""CLI command implementations.

Parity: tools/.../console/Pio.scala:42-351 and tools/.../commands/
{App,AccessKey,Engine,Management,Export,Import}.scala — app/key/channel
CRUD, engine resolution from engine.json, train/eval/deploy drivers,
events export/import, end-to-end status validation.

The port's copy of incubator_predictionio_tpu/cli/commands.py, on the
port's storage. One difference: :func:`resolve_engine_factory` maps an
``engineFactory`` of the JAX package (``incubator_predictionio_tpu.models.
recommendation:RecommendationEngine``, as the README's ``engine.json``
names it) by name to the port's module of the same path, which it
imports instead; it never imports the JAX package. The factory string is
kept as written for :func:`engine_identity`, so the engine id does not
change. A factory the port has no counterpart of raises and names it.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import re
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Channel,
    Storage,
    is_valid_channel_name,
)

logger = logging.getLogger(__name__)


class CommandError(Exception):
    """User-facing command failure (exit code 1)."""


# ---------------------------------------------------------------------------
# app / accesskey / channel (commands/App.scala, commands/AccessKey.scala)
# ---------------------------------------------------------------------------

def app_new(name: str, app_id: int = 0, description: Optional[str] = None,
            access_key: str = "") -> Dict[str, Any]:
    apps = Storage.get_meta_data_apps()
    if apps.get_by_name(name) is not None:
        raise CommandError(f"App {name} already exists. Aborting.")
    new_id = apps.insert(App(app_id, name, description))
    if new_id is None:
        raise CommandError(f"Unable to create new app: {name}")
    Storage.get_events().init(new_id)
    key = Storage.get_meta_data_access_keys().insert(
        AccessKey(access_key, new_id, ())
    )
    if key is None:
        Storage.get_events().remove(new_id)
        apps.delete(new_id)
        raise CommandError(
            f"Unable to create new access key for app {name} "
            "(duplicate key?). Aborting."
        )
    print(f"Initialized Event Store for this app ID: {new_id}.")
    print("Created new app:")
    print(f"      Name: {name}")
    print(f"        ID: {new_id}")
    print(f"Access Key: {key}")
    return {"id": new_id, "name": name, "accessKey": key}


def app_list() -> List[Dict[str, Any]]:
    apps = sorted(Storage.get_meta_data_apps().get_all(), key=lambda a: a.name)
    keys = Storage.get_meta_data_access_keys()
    out = []
    print(f"{'Name':<20}|{'ID':>6}| Access Key(s)")
    for app in apps:
        app_keys = [k.key for k in keys.get_by_appid(app.id)]
        print(f"{app.name:<20}|{app.id:>6}| {', '.join(app_keys)}")
        out.append({"name": app.name, "id": app.id, "accessKeys": app_keys})
    print(f"Finished listing {len(apps)} app(s).")
    return out


def _get_app(name: str) -> App:
    app = Storage.get_meta_data_apps().get_by_name(name)
    if app is None:
        raise CommandError(f"App {name} does not exist. Aborting.")
    return app


def app_show(name: str) -> Dict[str, Any]:
    app = _get_app(name)
    keys = Storage.get_meta_data_access_keys().get_by_appid(app.id)
    channels = Storage.get_meta_data_channels().get_by_appid(app.id)
    print(f"    App Name: {app.name}")
    print(f"      App ID: {app.id}")
    print(f" Description: {app.description or ''}")
    for k in keys:
        allowed = "(all)" if not k.events else ", ".join(k.events)
        print(f"  Access Key: {k.key} | {allowed}")
    for c in channels:
        print(f"     Channel: {c.name} (ID {c.id})")
    return {
        "name": app.name, "id": app.id, "description": app.description,
        "accessKeys": [k.key for k in keys],
        "channels": [c.name for c in channels],
    }


def app_delete(name: str) -> None:
    app = _get_app(name)
    channels = Storage.get_meta_data_channels()
    events = Storage.get_events()
    for channel in channels.get_by_appid(app.id):
        events.remove(app.id, channel.id)
        channels.delete(channel.id)
    events.remove(app.id)
    keys = Storage.get_meta_data_access_keys()
    for key in keys.get_by_appid(app.id):
        keys.delete(key.key)
    Storage.get_meta_data_apps().delete(app.id)
    print(f"App successfully deleted: {name}")


def app_data_delete(name: str, channel: Optional[str] = None) -> None:
    app = _get_app(name)
    channel_id = None
    if channel is not None:
        matches = [
            c for c in Storage.get_meta_data_channels().get_by_appid(app.id)
            if c.name == channel
        ]
        if not matches:
            raise CommandError(f"Channel {channel} does not exist.")
        channel_id = matches[0].id
    events = Storage.get_events()
    events.remove(app.id, channel_id)
    events.init(app.id, channel_id)
    print(f"Deleted all data of app {name}"
          + (f" channel {channel}" if channel else ""))


def channel_new(app_name: str, channel_name: str) -> Dict[str, Any]:
    app = _get_app(app_name)
    if not is_valid_channel_name(channel_name):
        raise CommandError(f"Invalid channel name: {channel_name}.")
    channels = Storage.get_meta_data_channels()
    channel_id = channels.insert(Channel(0, channel_name, app.id))
    if channel_id is None:
        raise CommandError(
            f"Channel {channel_name} already exists for app {app_name}."
        )
    Storage.get_events().init(app.id, channel_id)
    print(f"Created new channel {channel_name} (ID {channel_id}) "
          f"for app {app_name}.")
    return {"id": channel_id, "name": channel_name, "appId": app.id}


def channel_delete(app_name: str, channel_name: str) -> None:
    app = _get_app(app_name)
    channels = Storage.get_meta_data_channels()
    matches = [
        c for c in channels.get_by_appid(app.id) if c.name == channel_name
    ]
    if not matches:
        raise CommandError(
            f"Channel {channel_name} does not exist for app {app_name}."
        )
    Storage.get_events().remove(app.id, matches[0].id)
    channels.delete(matches[0].id)
    print(f"Deleted channel {channel_name} of app {app_name}.")


def accesskey_new(app_name: str, key: str = "",
                  events: Tuple[str, ...] = ()) -> str:
    app = _get_app(app_name)
    new_key = Storage.get_meta_data_access_keys().insert(
        AccessKey(key, app.id, tuple(events))
    )
    if new_key is None:
        raise CommandError("Unable to create access key.")
    print(f"Created new access key: {new_key}")
    return new_key


def accesskey_list(app_name: Optional[str] = None) -> List[AccessKey]:
    keys_dao = Storage.get_meta_data_access_keys()
    if app_name is not None:
        keys = keys_dao.get_by_appid(_get_app(app_name).id)
    else:
        keys = keys_dao.get_all()
    for k in sorted(keys, key=lambda k: k.key):
        allowed = "(all)" if not k.events else ", ".join(k.events)
        print(f"{k.key} | app {k.appid} | {allowed}")
    print(f"Finished listing {len(keys)} access key(s).")
    return list(keys)


def accesskey_delete(key: str) -> None:
    if not Storage.get_meta_data_access_keys().delete(key):
        raise CommandError(f"Error deleting access key {key}.")
    print(f"Deleted access key {key}.")


# ---------------------------------------------------------------------------
# engine resolution (commands/Engine.scala + WorkflowUtils.getEngine)
# ---------------------------------------------------------------------------

def load_variant(engine_json: str = "engine.json") -> Dict[str, Any]:
    path = Path(engine_json)
    if not path.exists():
        raise CommandError(
            f"{engine_json} does not exist. Aborting. (Run from your engine "
            "template directory, or pass --variant.)"
        )
    with open(path) as f:
        return json.load(f)


def resolve_engine_factory(factory_path: str) -> Any:
    """Load the engine factory class/object from ``module:Attr`` or
    ``module.Attr`` (WorkflowUtils.getEngine:64 resolves Scala objects vs
    classes the same way), a JAX package module mapped to the port's
    (``workflow.checkpoint.port_module``)."""
    if ":" in factory_path:
        module_name, _, attr = factory_path.partition(":")
    else:
        module_name, _, attr = factory_path.rpartition(".")
    if not module_name:
        raise CommandError(f"Invalid engineFactory {factory_path!r}")
    from incubator_predictionio_tpu_torch.workflow.checkpoint import (
        port_module,
    )

    target = port_module(module_name)
    sys.path.insert(0, os.getcwd())
    try:
        module = importlib.import_module(target)
    except ImportError as e:
        if target != module_name:
            raise CommandError(
                f"engineFactory {factory_path!r} has no counterpart in the "
                f"PyTorch port (no module {target!r}): {e}") from e
        raise CommandError(
            f"Cannot import engine factory module {module_name!r}: {e}"
        ) from e
    finally:
        sys.path.pop(0)
    try:
        factory = getattr(module, attr)
    except AttributeError as e:
        raise CommandError(
            f"Module {target!r} has no attribute {attr!r}"
        ) from e
    return factory() if isinstance(factory, type) else factory


def engine_identity(engine_dir: str, engine_factory: str) -> str:
    """Engine identity = (engine directory, factory), like the reference's
    manifest id (commands/Engine.scala:123-156 derives it from the engine
    directory). Keying instances on the variant's own "id" field would
    collide across engines that all ship the default variant id — deploy
    would then pick another engine's latest instance; mixing in the factory
    also keeps two different engines sharing one directory apart. The ONE
    derivation used by build manifests and train/deploy instance lookups."""
    import hashlib

    abs_dir = str(Path(engine_dir).resolve())
    return hashlib.sha1(
        f"{abs_dir}\0{engine_factory}".encode()).hexdigest()[:16]


def engine_id_for_variant_path(variant_path: str,
                               variant: Dict[str, Any]) -> str:
    return engine_identity(str(Path(variant_path).resolve().parent),
                           variant.get("engineFactory", ""))


def engine_from_variant(variant: Dict[str, Any]):
    factory_path = variant.get("engineFactory")
    if not factory_path:
        raise CommandError("engine.json is missing 'engineFactory'.")
    factory = resolve_engine_factory(factory_path)
    engine = factory.apply()
    return engine, engine.jvalue_to_engine_params(variant)


# ---------------------------------------------------------------------------
# build / register (commands/Engine.scala:158-260, RegisterEngine.scala,
# commands/Template.scala)
# ---------------------------------------------------------------------------

def verify_template_min_version(engine_dir: str = ".") -> Optional[str]:
    """template.json min-version gate (commands/Template.scala:38-83).

    Returns a warning string when ``pio.required.version`` exceeds the
    running framework version; None otherwise (including no template.json —
    the reference warns separately but proceeds either way).
    """
    from incubator_predictionio_tpu_torch import __version__

    path = Path(engine_dir) / "template.json"
    if not path.exists():
        return None
    try:
        with open(path) as f:
            required = json.load(f).get("pio", {}).get("version", {}).get("min")
    except (json.JSONDecodeError, AttributeError):
        return None
    if not required:
        return None

    def _key(v: str) -> tuple:
        return tuple(int(p) for p in re.findall(r"\d+", v)[:3])

    if _key(str(required)) > _key(__version__):
        return (
            f"This engine template requires at least version {required}, "
            f"but you are running {__version__}. It may not work properly."
        )
    return None


def _manifest_for_engine_dir(engine_dir: str,
                             variant: Dict[str, Any]) -> "storage_base.EngineManifest":
    """manifest.json regeneration (commands/Engine.scala:123-156): the ID is
    derived from the engine directory, the version from a content hash of the
    variant (there is no JAR to fingerprint)."""
    import hashlib

    from incubator_predictionio_tpu_torch import __version__
    from incubator_predictionio_tpu_torch.data.storage import base as storage_base

    abs_dir = str(Path(engine_dir).resolve())
    digest = hashlib.sha1(
        json.dumps(variant, sort_keys=True).encode()
    ).hexdigest()[:16]
    files = sorted(
        str(p) for p in Path(engine_dir).glob("*.json")
        if p.name != "manifest.json"   # the output of this very build
    ) + sorted(str(p) for p in Path(engine_dir).glob("*.py"))
    return storage_base.EngineManifest(
        id=engine_identity(abs_dir, variant.get("engineFactory", "")),
        version=digest,
        name=Path(abs_dir).name,
        engine_factory=variant.get("engineFactory", ""),
        description=f"pio-torch {__version__} engine at {abs_dir}",
        files=tuple(files),
    )


def build(engine_dir: str = ".", engine_json: str = "engine.json") -> str:
    """``pio build`` (commands/Engine.scala:158-260). There is no sbt
    compile step: "building" validates the variant resolves to an importable
    factory, checks the template version gate, writes manifest.json, and
    registers the EngineManifest."""
    warning = verify_template_min_version(engine_dir)
    if warning:
        print(f"WARNING: {warning}")
    variant = load_variant(str(Path(engine_dir) / engine_json))
    # import + params extraction = the "compile" step
    _engine, engine_params = engine_from_variant(variant)
    n_algos = len(engine_params.algorithm_params_list) or 1
    print(f"Engine {variant.get('engineFactory')} is valid "
          f"({n_algos} algorithm(s) configured).")
    manifest = _manifest_for_engine_dir(engine_dir, variant)
    with open(Path(engine_dir) / "manifest.json", "w") as f:
        json.dump(
            {
                "id": manifest.id,
                "version": manifest.version,
                "name": manifest.name,
                "engineFactory": manifest.engine_factory,
                "description": manifest.description,
                "files": list(manifest.files),
            },
            f, indent=2,
        )
    Storage.get_meta_data_engine_manifests().update(manifest, upsert=True)
    print(f"Engine {manifest.id} {manifest.version} registered "
          f"({manifest.engine_factory}).")
    return manifest.id


def unregister(engine_dir: str = ".") -> None:
    """``pio unregister`` (RegisterEngine.unregisterEngine:58)."""
    path = Path(engine_dir) / "manifest.json"
    if not path.exists():
        raise CommandError(f"{path} does not exist. Nothing to unregister.")
    with open(path) as f:
        m = json.load(f)
    if Storage.get_meta_data_engine_manifests().delete(m["id"], m["version"]):
        print(f"Engine {m['id']} {m['version']} unregistered.")
    else:
        raise CommandError(
            f"Engine {m['id']} {m['version']} is not registered."
        )


# ---------------------------------------------------------------------------
# export / import (tools/.../export/EventsToFile.scala, imprt/FileToEvents.scala)
# ---------------------------------------------------------------------------

def _appid_or_name_to_name(appid_or_name: str) -> str:
    """The reference CLI accepts either an app ID or name for export/import
    (Console.scala export/import subcommands); the EventStore facade resolves
    names, so translate a numeric ID to its app name first."""
    if appid_or_name.isdigit():
        app = Storage.get_meta_data_apps().get(int(appid_or_name))
        if app is None:
            raise CommandError(f"App ID {appid_or_name} does not exist.")
        return app.name
    return appid_or_name


#: parquet schema: scalar event fields as columns, properties as a JSON
#: string column (the reference dumps a DataFrame of the Event case class —
#: EventsToFile.scala:44,88-93; a JSON property column keeps arbitrary
#: DataMap payloads schema-stable across rows)
_PARQUET_FIELDS = (
    "eventId", "event", "entityType", "entityId", "targetEntityType",
    "targetEntityId", "properties", "eventTime", "tags", "prId",
    "creationTime",
)


def export_events(app_name: str, output: str,
                  channel: Optional[str] = None,
                  format: str = "json") -> int:
    from incubator_predictionio_tpu_torch.data.store import EventStore

    app_name = _appid_or_name_to_name(app_name)
    found = EventStore.find(app_name=app_name, channel_name=channel)
    if format == "parquet":
        n = _export_parquet(found, output)
    elif format == "json":
        n = 0
        with open(output, "w") as f:
            for event in found:
                f.write(json.dumps(event.to_jsonable()) + "\n")
                n += 1
    else:
        raise CommandError(
            f"unknown export format {format!r} (json or parquet — "
            "EventsToFile.scala:44 parity)")
    print(f"Exported {n} events to {output}.")
    return n


def _export_parquet(events, output: str, batch_rows: int = 65536) -> int:
    """EventsToFile.scala:88-93's DataFrame.write.parquet role, streamed
    in bounded row batches."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:  # pragma: no cover - baked into the image
        raise CommandError(
            "parquet export needs pyarrow, which is not installed; "
            "use --format json") from e

    schema = pa.schema([
        (name, pa.list_(pa.string()) if name == "tags" else pa.string())
        for name in _PARQUET_FIELDS
    ])
    n = 0
    writer = pq.ParquetWriter(output, schema)
    try:
        batch = {name: [] for name in _PARQUET_FIELDS}
        for event in events:
            doc = event.to_jsonable()
            for name in _PARQUET_FIELDS:
                if name == "properties":
                    batch[name].append(json.dumps(doc.get(name, {})))
                elif name == "tags":
                    batch[name].append(doc.get(name, []))
                else:
                    batch[name].append(doc.get(name))
            n += 1
            if n % batch_rows == 0:
                writer.write_table(pa.table(batch, schema=schema))
                batch = {name: [] for name in _PARQUET_FIELDS}
        if batch[_PARQUET_FIELDS[0]] or n == 0:
            writer.write_table(pa.table(batch, schema=schema))
    finally:
        writer.close()
    return n


def _iter_import_file(input_path: str, format: str):
    """Yield (location, jsonable-event-dict) from a JSON-lines or parquet
    export file."""
    if format == "parquet":
        try:
            import pyarrow.parquet as pq
        except ImportError as e:  # pragma: no cover
            raise CommandError(
                "parquet import needs pyarrow, which is not installed"
            ) from e
        row_no = 0
        # stream row batches: a multi-million-row export never materializes
        # whole-file columns (mirrors the export side's bounded batching)
        for batch in pq.ParquetFile(input_path).iter_batches(65536):
            cols = batch.to_pydict()
            names = [n for n in _PARQUET_FIELDS if n in cols]
            for i in range(batch.num_rows):
                row_no += 1
                location = f"{input_path}:row {row_no}"
                doc = {}
                for name in names:
                    value = cols[name][i]
                    if value is None:
                        continue
                    if name == "properties":
                        try:
                            value = json.loads(value)
                        except ValueError as e:
                            raise CommandError(
                                f"{location}: invalid properties JSON: {e}"
                            ) from e
                    doc[name] = value
                yield location, doc
    else:
        with open(input_path) as f:
            for line_no, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError as e:
                    raise CommandError(
                        f"{input_path}:{line_no}: invalid event: {e}") from e
                yield f"{input_path}:{line_no}", doc


#: minimum batch size for the columnar import fast path (below it the
#: Python interning pass costs more than the per-event path saves)
_FAST_IMPORT_MIN = int(os.environ.get("PIO_IMPORT_FAST_MIN", "10000"))


def _as_uniform_interactions(events):
    """Events → (Interactions, entity_type, target_type, name, value_prop,
    times_ms) when the columnar bulk import is observably equivalent to
    per-event inserts, else None.

    The equivalence conditions live in ``base.uniform_interactions``,
    shared with the cpplog REST batch gate so the two cannot drift.
    Export round-trips carry eventIds (upsert semantics) and therefore
    never take this path; an explicit creationTime is screened by the
    caller (the parsed Event cannot tell it from the defaulted one)."""
    if len(events) < _FAST_IMPORT_MIN:
        return None  # interning overhead beats the win on small files
    from incubator_predictionio_tpu_torch.data.storage.base import (
        uniform_interactions,
    )

    return uniform_interactions(events)


def import_events(app_name: str, input_path: str,
                  channel: Optional[str] = None,
                  format: str = "json") -> int:
    from incubator_predictionio_tpu_torch.data.event import validate_event
    from incubator_predictionio_tpu_torch.data.storage import (
        base as storage_base,
    )
    from incubator_predictionio_tpu_torch.data.store import EventStore

    app_name = _appid_or_name_to_name(app_name)

    events = []
    # doc-level screen for the fast path: a parsed Event cannot tell an
    # explicit creationTime from the defaulted one, and creationTime is
    # exactly what the columnar renderer would rewrite
    plain_docs = True
    for location, doc in _iter_import_file(input_path, format):
        try:
            event = Event.from_jsonable(doc)
            validate_event(event)
            events.append(event)
        except ValueError as e:
            raise CommandError(f"{location}: invalid event: {e}") from e
        plain_docs = plain_docs and "creationTime" not in doc
    dao = Storage.get_events()
    fast = (
        _as_uniform_interactions(events)
        # only a backend with a NATIVE columnar import (cpplog): the base
        # version converts straight back to Events, paying twice
        if plain_docs and type(dao).import_interactions
        is not storage_base.Events.import_interactions else None)
    if fast is not None:
        from incubator_predictionio_tpu_torch.data.store import _resolve

        inter, etype, tetype, name, vprop, times = fast
        app_id, channel_id = _resolve(app_name, channel)
        n = dao.import_interactions(
            inter, app_id, channel_id, entity_type=etype,
            target_entity_type=tetype, event_name=name, value_prop=vprop,
            times=times)
        print(f"Imported {n} events (native columnar path).")
        return n
    EventStore.write(events, app_name=app_name, channel_name=channel)
    print(f"Imported {len(events)} events.")
    return len(events)


# ---------------------------------------------------------------------------
# status (commands/Management.scala:99-178)
# ---------------------------------------------------------------------------

def upgrade(appid_or_name: Optional[str] = None) -> List[Dict[str, Any]]:
    """Rewrite event stores in the current on-disk format — the store
    migration verb (the reference's HBase upgrade tool role,
    data/.../storage/hbase/upgrade/Upgrade.scala). Delegates to the
    backend's ``compact`` (cpplog: the live-record rewrite, dropping
    tombstoned records and giving bare-JSON records their sidecar; sqlite:
    VACUUM); backends without a migration (memory) are skipped. Covers the
    default channel plus every named channel of each selected app."""
    events = Storage.get_events()
    if not hasattr(events, "compact"):
        return []
    apps_dao = Storage.get_meta_data_apps()
    if appid_or_name is not None:
        apps = [_get_app(_appid_or_name_to_name(appid_or_name))]
    else:
        apps = apps_dao.get_all()
    results: List[Dict[str, Any]] = []
    for app in apps:
        channel_ids = [None] + [
            c.id for c in Storage.get_meta_data_channels().get_by_appid(
                app.id)
        ]
        for cid in channel_ids:
            stats = events.compact(app.id, cid)
            results.append({"app": app.name, "channel": cid or "default",
                            **stats})
    return results


def status() -> bool:
    from incubator_predictionio_tpu_torch import __version__

    print(f"PredictionIO on PyTorch {__version__}")
    print("Inspecting storage backend connections...")
    try:
        Storage.verify_all_data_objects()
        print("Storage: OK (metadata, event data, model data all verified)")
    except Exception as e:
        print(f"Storage: ERROR: {e}")
        return False
    import torch

    from incubator_predictionio_tpu_torch import runtime

    if runtime.requested_device() == "cpu":
        print(f"Compute: torch {torch.__version__} on the CPU "
              "(PIO_DEVICE=cpu)")
    elif not torch.cuda.is_available():
        print(f"Compute: ERROR: torch {torch.__version__} sees no CUDA "
              "device (set PIO_DEVICE=cpu to run on the CPU)")
        return False
    else:
        print(f"Compute: torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.device_count()} "
              f"device(s): {torch.cuda.get_device_name(0)}")
    print("Your system is all ready to go.")
    return True

