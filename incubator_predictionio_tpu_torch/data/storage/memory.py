"""In-memory storage backend — the test backend and default for unit work.

The port's own copy of incubator_predictionio_tpu/data/storage/memory.py,
its imports rewritten to this package.

The reference gains the same capability through JDBC-against-test-DBs plus
``StorageClientConfig.test`` (Storage.scala:62,78-81); here an explicit
in-memory backend keeps the conformance suite hermetic.

Repository namespaces (``PIO_STORAGE_REPOSITORIES_<REPO>_NAME``) isolate
tables exactly like the reference's namespaced HBase tables / JDBC table
prefixes: each DAO operates on the per-namespace table set for its prefix.
"""

from __future__ import annotations

import dataclasses
import threading
import uuid
from datetime import datetime
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

from incubator_predictionio_tpu_torch.data.event import Event, new_event_id, validate_event
from incubator_predictionio_tpu_torch.data.storage import base
from incubator_predictionio_tpu_torch.utils.times import to_millis, wall_millis
from incubator_predictionio_tpu_torch.data.storage.base import UNSET


class _Namespace:
    """One repository namespace's tables."""

    def __init__(self) -> None:
        # (app_id, channel_id) -> {event_id: Event}
        self.events: Dict[Tuple[int, Optional[int]], Dict[str, Event]] = {}
        # (app_id, channel_id) -> append-ordered write tail of
        # (Event, append_wall_ms) pairs (upserts append again — a new
        # write in the cross-backend order contract; the wall stamp is
        # the freshness-tracing anchor: event APPENDED, not event TIME).
        # Backs the speed layer's tail_cursor/read_interactions_since.
        self.event_tail: Dict[Tuple[int, Optional[int]], list] = {}
        # tail generation per table: bumped by remove() so stale cursors
        # are detected even after the table refills past the old count
        self.event_tail_gen: Dict[Tuple[int, Optional[int]], int] = {}
        self.apps: Dict[int, base.App] = {}
        self.access_keys: Dict[str, base.AccessKey] = {}
        self.channels: Dict[int, base.Channel] = {}
        self.engine_instances: Dict[str, base.EngineInstance] = {}
        self.engine_manifests: Dict[Tuple[str, str], base.EngineManifest] = {}
        self.evaluation_instances: Dict[str, base.EvaluationInstance] = {}
        self.models: Dict[str, base.Model] = {}
        self._next = 1

    def next_free_id(self, taken: Dict[int, Any]) -> int:
        while self._next in taken:
            self._next += 1
        out = self._next
        self._next += 1
        return out


class StorageClient(base.BaseStorageClient):
    """Holds all in-memory namespaces for one source."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        self.lock = threading.RLock()
        self.namespaces: Dict[str, _Namespace] = {}

    def ns(self, prefix: str) -> _Namespace:
        with self.lock:
            return self.namespaces.setdefault(prefix, _Namespace())

    def close(self) -> None:
        pass


def _match(
    e: Event,
    start_ms: Optional[int],
    until_ms: Optional[int],
    entity_type: Optional[str],
    entity_id: Optional[str],
    event_names: Optional[Sequence[str]],
    target_entity_type: Any,
    target_entity_id: Any,
) -> bool:
    # compare at MILLISECOND granularity — the durable backends store
    # epoch millis (sqlite event_time INTEGER, cpplog time_ms), so the
    # in-memory model must not discriminate at sub-ms precision they
    # cannot represent (order contract, base.py Events.find). Callers
    # pass the bounds pre-converted (hot path: the aggregator replays
    # through find()).
    if start_ms is not None or until_ms is not None:
        t = to_millis(e.event_time)
        if start_ms is not None and t < start_ms:
            return False
        if until_ms is not None and t >= until_ms:
            return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in event_names:
        return False
    if target_entity_type is not UNSET and e.target_entity_type != target_entity_type:
        return False
    if target_entity_id is not UNSET and e.target_entity_id != target_entity_id:
        return False
    return True


class _MemoryDAO:
    def __init__(self, client: StorageClient, config: base.StorageClientConfig,
                 prefix: str = ""):
        self.client = client
        self.t = client.ns(prefix)


class MemoryEvents(_MemoryDAO, base.Events):
    FAST_LOCAL = True  # dict index: EventServer ingests inline

    def _table(self, app_id: int, channel_id: Optional[int]) -> Dict[str, Event]:
        return self.t.events.setdefault((app_id, channel_id), {})

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self.client.lock:
            self._table(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self.client.lock:
            self.t.events.pop((app_id, channel_id), None)
            self.t.event_tail.pop((app_id, channel_id), None)
            key = (app_id, channel_id)
            self.t.event_tail_gen[key] = \
                self.t.event_tail_gen.get(key, 0) + 1
        return True

    def close(self) -> None:
        pass

    def _tail_tombstone(self, app_id: int, channel_id: Optional[int],
                        event_id: str) -> None:
        """Null out the newest tail occurrence of an event id (caller
        holds the client lock). Positions are PRESERVED — the tail
        cursor counts slots, so a tombstone must not shift it."""
        tail = self.t.event_tail.get((app_id, channel_id))
        if not tail:
            return
        for i in range(len(tail) - 1, -1, -1):
            entry = tail[i]
            if entry is not None and entry[0].event_id == event_id:
                tail[i] = None
                return

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        validate_event(event)
        with self.client.lock:
            eid = event.event_id or new_event_id()
            table = self._table(app_id, channel_id)
            # upsert moves the event to the END of insertion order — the
            # cross-backend tie-break contract for equal event times (an
            # upsert is a new write; cpplog's append-only log and
            # sqlite's REPLACE rowid both behave this way)
            if table.pop(eid, None) is not None:
                # the superseded write must not replay to tail readers
                self._tail_tombstone(app_id, channel_id, eid)
            table[eid] = event.with_id(eid)
            self.t.event_tail.setdefault((app_id, channel_id), []).append(
                (table[eid], wall_millis()))
        return eid

    # -- speed-layer tail cursor -------------------------------------------
    def tail_cursor(self, app_id: int,
                    channel_id: Optional[int] = None) -> int:
        with self.client.lock:
            key = (app_id, channel_id)
            gen = self.t.event_tail_gen.get(key, 0)
            return (gen << self.TAIL_GEN_SHIFT) | len(
                self.t.event_tail.get(key, ()))

    def read_interactions_since(
        self,
        cursor: int,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_names: Sequence[str] = ("rate",),
        value_prop: Optional[str] = None,
        event_values: Optional[Dict[str, float]] = None,
        default_value: float = 1.0,
    ):
        import numpy as np

        with self.client.lock:
            key = (app_id, channel_id)
            gen = self.t.event_tail_gen.get(key, 0)
            tail = self.t.event_tail.get(key, ())
            pos = len(tail)
            new_cursor = (gen << self.TAIL_GEN_SHIFT) | pos
            cur_gen = max(int(cursor), 0) >> self.TAIL_GEN_SHIFT
            cur_pos = max(int(cursor), 0) & (
                (1 << self.TAIL_GEN_SHIFT) - 1)
            if cur_gen != gen or cur_pos > pos:
                # log rewritten since the caller's cursor: empty tail +
                # reset — the caller resynchronizes from scratch
                return (base.Interactions(
                            user_idx=np.empty(0, np.int32),
                            item_idx=np.empty(0, np.int32),
                            values=np.empty(0, np.float32),
                            user_ids=[], item_ids=[]),
                        np.empty(0, np.int64), np.empty(0, np.int64),
                        new_cursor, True)
            rows = list(tail[cur_pos:pos])
        fixed = event_values or {}
        names = set(event_names)
        users: Dict[str, int] = {}
        items: Dict[str, int] = {}
        uidx: list = []
        iidx: list = []
        vals: list = []
        times: list = []
        appends: list = []
        for entry in rows:
            if entry is None:  # tombstoned (deleted/superseded) slot
                continue
            e, appended_ms = entry
            if (e.event not in names or e.entity_type != entity_type
                    or e.target_entity_type != target_entity_type
                    or e.target_entity_id is None):
                continue
            if e.event in fixed:
                v = fixed[e.event]
            elif value_prop is not None:
                raw = e.properties.to_jsonable().get(value_prop)
                if not isinstance(raw, (int, float)) or isinstance(raw, bool):
                    continue
                v = float(raw)
            else:
                v = default_value
            uidx.append(users.setdefault(e.entity_id, len(users)))
            iidx.append(items.setdefault(e.target_entity_id, len(items)))
            vals.append(v)
            times.append(to_millis(e.event_time))
            appends.append(appended_ms)
        inter = base.Interactions(
            user_idx=np.asarray(uidx, np.int32),
            item_idx=np.asarray(iidx, np.int32),
            values=np.asarray(vals, np.float32),
            user_ids=list(users),
            item_ids=list(items),
        )
        return (inter, np.asarray(times, np.int64),
                np.asarray(appends, np.int64), new_cursor, False)

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        with self.client.lock:
            return self._table(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        with self.client.lock:
            gone = self._table(app_id, channel_id).pop(
                event_id, None) is not None
            if gone:
                # deleted events must not replay through the speed
                # layer's tail read (cpplog's scans skip tombstones; the
                # in-memory model must match)
                self._tail_tombstone(app_id, channel_id, event_id)
            return gone

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        with self.client.lock:
            rows = list(self._table(app_id, channel_id).values())
        start_ms = None if start_time is None else to_millis(start_time)
        until_ms = None if until_time is None else to_millis(until_time)
        rows = [
            e for e in rows
            if _match(e, start_ms, until_ms, entity_type, entity_id,
                      event_names, target_entity_type, target_entity_id)
        ]
        # cross-backend order contract: (event_time AT MILLIS, insertion/
        # upsert order) — the stable sort keeps the table's insertion
        # order for equal-milli times (sub-ms differences are invisible
        # to the durable backends and must not order here either);
        # ``reversed`` is the exact reverse of the forward sequence (ties
        # included), matching the native log's backward walk and sqlite's
        # (event_time, rowid) DESC
        rows.sort(key=lambda e: to_millis(e.event_time))
        if reversed:
            rows = rows[::-1]
        if limit is not None and limit >= 0:
            rows = rows[:limit]
        return iter(rows)


class MemoryApps(_MemoryDAO, base.Apps):
    def insert(self, app: base.App) -> Optional[int]:
        with self.client.lock:
            if any(a.name == app.name for a in self.t.apps.values()):
                return None
            if app.id != 0:
                if app.id in self.t.apps:
                    return None
                app_id = app.id
            else:
                app_id = self.t.next_free_id(self.t.apps)
            self.t.apps[app_id] = base.App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> Optional[base.App]:
        with self.client.lock:
            return self.t.apps.get(app_id)

    def get_by_name(self, name: str) -> Optional[base.App]:
        with self.client.lock:
            return next(
                (a for a in self.t.apps.values() if a.name == name), None
            )

    def get_all(self) -> list[base.App]:
        with self.client.lock:
            return list(self.t.apps.values())

    def update(self, app: base.App) -> bool:
        with self.client.lock:
            if app.id not in self.t.apps:
                return False
            self.t.apps[app.id] = app
            return True

    def delete(self, app_id: int) -> bool:
        with self.client.lock:
            return self.t.apps.pop(app_id, None) is not None


class MemoryAccessKeys(_MemoryDAO, base.AccessKeys):
    def insert(self, k: base.AccessKey) -> Optional[str]:
        with self.client.lock:
            key = k.key or base.generate_access_key()
            if key in self.t.access_keys:
                return None
            self.t.access_keys[key] = base.AccessKey(key, k.appid, tuple(k.events))
            return key

    def get(self, key: str) -> Optional[base.AccessKey]:
        with self.client.lock:
            return self.t.access_keys.get(key)

    def get_all(self) -> list[base.AccessKey]:
        with self.client.lock:
            return list(self.t.access_keys.values())

    def get_by_appid(self, appid: int) -> list[base.AccessKey]:
        with self.client.lock:
            return [k for k in self.t.access_keys.values() if k.appid == appid]

    def update(self, k: base.AccessKey) -> bool:
        with self.client.lock:
            if k.key not in self.t.access_keys:
                return False
            self.t.access_keys[k.key] = k
            return True

    def delete(self, key: str) -> bool:
        with self.client.lock:
            return self.t.access_keys.pop(key, None) is not None


class MemoryChannels(_MemoryDAO, base.Channels):
    def insert(self, channel: base.Channel) -> Optional[int]:
        with self.client.lock:
            if any(
                c.appid == channel.appid and c.name == channel.name
                for c in self.t.channels.values()
            ):
                return None
            if channel.id != 0:
                if channel.id in self.t.channels:
                    return None
                cid = channel.id
            else:
                cid = self.t.next_free_id(self.t.channels)
            self.t.channels[cid] = base.Channel(cid, channel.name, channel.appid)
            return cid

    def get(self, channel_id: int) -> Optional[base.Channel]:
        with self.client.lock:
            return self.t.channels.get(channel_id)

    def get_by_appid(self, appid: int) -> list[base.Channel]:
        with self.client.lock:
            return [c for c in self.t.channels.values() if c.appid == appid]

    def delete(self, channel_id: int) -> bool:
        with self.client.lock:
            return self.t.channels.pop(channel_id, None) is not None


class MemoryEngineInstances(_MemoryDAO, base.EngineInstances):
    def insert(self, i: base.EngineInstance) -> str:
        with self.client.lock:
            iid = i.id or uuid.uuid4().hex
            self.t.engine_instances[iid] = (
                i if i.id else dataclasses.replace(i, id=iid)
            )
            return iid

    def get(self, instance_id: str) -> Optional[base.EngineInstance]:
        with self.client.lock:
            return self.t.engine_instances.get(instance_id)

    def get_all(self) -> list[base.EngineInstance]:
        with self.client.lock:
            return list(self.t.engine_instances.values())

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[base.EngineInstance]:
        with self.client.lock:
            rows = [
                i for i in self.t.engine_instances.values()
                if i.status == "COMPLETED"
                and i.engine_id == engine_id
                and i.engine_version == engine_version
                and i.engine_variant == engine_variant
            ]
        rows.sort(key=lambda i: i.start_time, reverse=True)
        return rows

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[base.EngineInstance]:
        rows = self.get_completed(engine_id, engine_version, engine_variant)
        return rows[0] if rows else None

    def update(self, i: base.EngineInstance) -> bool:
        with self.client.lock:
            if i.id not in self.t.engine_instances:
                return False
            self.t.engine_instances[i.id] = i
            return True

    def delete(self, instance_id: str) -> bool:
        with self.client.lock:
            return self.t.engine_instances.pop(instance_id, None) is not None


class MemoryEvaluationInstances(_MemoryDAO, base.EvaluationInstances):
    def insert(self, i: base.EvaluationInstance) -> str:
        with self.client.lock:
            iid = i.id or uuid.uuid4().hex
            self.t.evaluation_instances[iid] = (
                i if i.id else dataclasses.replace(i, id=iid)
            )
            return iid

    def get(self, instance_id: str) -> Optional[base.EvaluationInstance]:
        with self.client.lock:
            return self.t.evaluation_instances.get(instance_id)

    def get_all(self) -> list[base.EvaluationInstance]:
        with self.client.lock:
            return list(self.t.evaluation_instances.values())

    def get_completed(self) -> list[base.EvaluationInstance]:
        with self.client.lock:
            rows = [
                i for i in self.t.evaluation_instances.values()
                if i.status == "EVALCOMPLETED"
            ]
        rows.sort(key=lambda i: i.start_time, reverse=True)
        return rows

    def update(self, i: base.EvaluationInstance) -> bool:
        with self.client.lock:
            if i.id not in self.t.evaluation_instances:
                return False
            self.t.evaluation_instances[i.id] = i
            return True

    def delete(self, instance_id: str) -> bool:
        with self.client.lock:
            return self.t.evaluation_instances.pop(instance_id, None) is not None


class MemoryEngineManifests(_MemoryDAO, base.EngineManifests):
    def insert(self, m: base.EngineManifest) -> None:
        with self.client.lock:
            self.t.engine_manifests[(m.id, m.version)] = m

    def get(self, manifest_id: str, version: str) -> Optional[base.EngineManifest]:
        with self.client.lock:
            return self.t.engine_manifests.get((manifest_id, version))

    def get_all(self) -> list[base.EngineManifest]:
        with self.client.lock:
            return list(self.t.engine_manifests.values())

    def update(self, m: base.EngineManifest, upsert: bool = False) -> bool:
        with self.client.lock:
            if (m.id, m.version) not in self.t.engine_manifests and not upsert:
                return False
            self.t.engine_manifests[(m.id, m.version)] = m
            return True

    def delete(self, manifest_id: str, version: str) -> bool:
        with self.client.lock:
            return (
                self.t.engine_manifests.pop((manifest_id, version), None)
                is not None
            )


class MemoryModels(_MemoryDAO, base.Models):
    def insert(self, model: base.Model) -> None:
        with self.client.lock:
            self.t.models[model.id] = model

    def get(self, model_id: str) -> Optional[base.Model]:
        with self.client.lock:
            return self.t.models.get(model_id)

    def delete(self, model_id: str) -> None:
        with self.client.lock:
            self.t.models.pop(model_id, None)


#: DAO registry used by the Storage registry's lookup (the equivalent of the
#: reference's classname convention, Storage.scala:286-303).
DATA_OBJECTS = {
    "Events": MemoryEvents,
    "Apps": MemoryApps,
    "AccessKeys": MemoryAccessKeys,
    "Channels": MemoryChannels,
    "EngineInstances": MemoryEngineInstances,
    "EngineManifests": MemoryEngineManifests,
    "EvaluationInstances": MemoryEvaluationInstances,
    "Models": MemoryModels,
}
