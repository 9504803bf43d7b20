"""Engine-facing event store facade.

The port's own copy of incubator_predictionio_tpu/data/store.py, its imports
rewritten to this package.

Parity: data/.../store/{LEventStore,PEventStore,Common}.scala — resolves
human-facing app *names* (plus optional channel names) to internal IDs, then
delegates to the event DAO. The reference splits this facade into a local
(iterator) and a parallel (RDD) flavor; on TPU both collapse into one
iterator-based API whose output feeds ``parallel.ingest`` for device sharding
(see base.Events docstring for the rationale).
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

from incubator_predictionio_tpu_torch.data.datamap import PropertyMap
from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage import Storage, UNSET


class EventStoreError(Exception):
    pass


def _resolve(app_name: str, channel_name: Optional[str]) -> Tuple[int, Optional[int]]:
    """appName(+channelName) → (appId, channelId) (store/Common.scala:34-55)."""
    app = Storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise EventStoreError(
            f"Invalid app name {app_name}. Please use a valid app name."
        )
    if channel_name is None:
        return app.id, None
    channels = Storage.get_meta_data_channels().get_by_appid(app.id)
    for c in channels:
        if c.name == channel_name:
            return app.id, c.id
    raise EventStoreError(
        f"Invalid channel name {channel_name} for app {app_name}."
    )


class EventStore:
    """Query API used by DataSources (PEventStore.scala:35-130)."""

    @staticmethod
    def find(
        app_name: str,
        channel_name: Optional[str] = None,
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
        app_id, channel_id = _resolve(app_name, channel_name)
        return Storage.get_events().find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            limit=limit,
            reversed=reversed,
        )

    @staticmethod
    def find_by_entity(
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        limit: Optional[int] = None,
        latest: bool = True,
    ) -> Iterator[Event]:
        """LEventStore.findByEntity:61 — newest-first by default."""
        return EventStore.find(
            app_name=app_name,
            channel_name=channel_name,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            limit=limit,
            reversed=latest,
        )

    @staticmethod
    def interactions(
        app_name: str,
        channel_name: Optional[str] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_names: Sequence[str] = ("rate",),
        value_prop: Optional[str] = None,
        event_values: Optional[Dict[str, float]] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        default_value: float = 1.0,
        **backend_extras: Any,
    ):
        """Columnar training ingest (base.Events.scan_interactions): the
        TPU-native replacement for the reference's RDD event read
        (PEventStore.find → newAPIHadoopRDD) — streams matching events into
        pre-indexed COO arrays + id tables without per-event objects.

        ``backend_extras`` forwards backend-specific keywords (the cpplog
        backend accepts ``stats``/``shard_sink``/``use_cache``/
        ``seed_cache`` for the sharded-scan sub-metrics and the pipelined
        scan→prep path); passing one to a backend that lacks it raises
        TypeError — callers opting in know their backend."""
        app_id, channel_id = _resolve(app_name, channel_name)
        return Storage.get_events().scan_interactions(
            app_id=app_id,
            channel_id=channel_id,
            entity_type=entity_type,
            target_entity_type=target_entity_type,
            event_names=event_names,
            value_prop=value_prop,
            event_values=event_values,
            start_time=start_time,
            until_time=until_time,
            default_value=default_value,
            **backend_extras,
        )

    @staticmethod
    def tail_cursor(app_name: str, channel_name: Optional[str] = None) -> int:
        """Monotonic write cursor of the app's event log, or -1 when the
        backend has no cheap tail (base.Events.tail_cursor) — the speed
        layer's poll anchor."""
        app_id, channel_id = _resolve(app_name, channel_name)
        return Storage.get_events().tail_cursor(app_id, channel_id)

    @staticmethod
    def read_interactions_since(
        cursor: int,
        app_name: str,
        channel_name: Optional[str] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_names: Sequence[str] = ("rate",),
        value_prop: Optional[str] = None,
        event_values: Optional[Dict[str, float]] = None,
        default_value: float = 1.0,
    ):
        """Columnar scan of only the events written since ``cursor`` →
        (Interactions, times_ms, append_ms, new_cursor, reset). O(delta):
        the speed layer polls this to maintain its dirty set between
        retrains; ``append_ms`` carries each row's wall-clock APPEND
        stamp (the end-to-end freshness anchor, -1 when the backend
        cannot attribute one — base.Events.read_interactions_since);
        ``reset=True`` means the log was rewritten (compaction/drop) and
        everything derived from older cursors must be dropped."""
        app_id, channel_id = _resolve(app_name, channel_name)
        return Storage.get_events().read_interactions_since(
            cursor, app_id, channel_id,
            entity_type=entity_type,
            target_entity_type=target_entity_type,
            event_names=event_names,
            value_prop=value_prop,
            event_values=event_values,
            default_value=default_value,
        )

    @staticmethod
    def aggregate_properties(
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """PEventStore.aggregateProperties:99."""
        app_id, channel_id = _resolve(app_name, channel_name)
        return Storage.get_events().aggregate_properties(
            app_id=app_id,
            channel_id=channel_id,
            entity_type=entity_type,
            start_time=start_time,
            until_time=until_time,
            required=required,
        )

    @staticmethod
    def extract_entity_map(
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        required: Optional[Sequence[str]] = None,
    ):
        """Aggregated entity properties keyed by id AND a dense index
        (PEvents.extractEntityMap:136-160) — the form templates feed
        factor tables from."""
        from incubator_predictionio_tpu_torch.data.entity_map import EntityMap

        return EntityMap(EventStore.aggregate_properties(
            app_name=app_name, entity_type=entity_type,
            channel_name=channel_name, start_time=start_time,
            until_time=until_time, required=required,
        ))

    @staticmethod
    def write(
        events: Sequence[Event],
        app_name: str,
        channel_name: Optional[str] = None,
    ) -> list[str]:
        """Bulk insert (PEvents.write:184, used by `pio import`)."""
        app_id, channel_id = _resolve(app_name, channel_name)
        return Storage.get_events().insert_batch(
            list(events), app_id, channel_id)

    @staticmethod
    def delete(
        event_ids: Sequence[str],
        app_name: str,
        channel_name: Optional[str] = None,
    ) -> int:
        app_id, channel_id = _resolve(app_name, channel_name)
        dao = Storage.get_events()
        return sum(1 for eid in event_ids if dao.delete(eid, app_id, channel_id))
