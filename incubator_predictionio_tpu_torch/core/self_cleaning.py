"""SelfCleaningDataSource — sliding-window event-store compaction.

The port's own copy of incubator_predictionio_tpu/core/self_cleaning.py, its
imports rewritten to this package.

Parity: core/.../core/SelfCleaningDataSource.scala:76-325. A DataSource mixes
this in to keep its app's event data bounded: events older than
``EventWindow.duration`` are dropped, ``$set``/``$unset`` chains per entity
are compressed into single events, and exact duplicates are removed; the
cleaned set then *replaces* the persisted events (``wipe``, :209). The
reference implements L and P variants over LEvents/PEvents; here one
host-side pass covers both (see data.storage.base.Events).
"""

from __future__ import annotations

import dataclasses
import logging
import re
from datetime import datetime, timedelta
from typing import Iterable, List, Optional, Tuple

from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage import Storage
from incubator_predictionio_tpu_torch.utils.times import now_utc

logger = logging.getLogger(__name__)

_DURATION_RE = re.compile(
    r"^\s*(\d+)\s*(s|sec|second|seconds|m|min|minute|minutes|h|hour|hours|"
    r"d|day|days|w|week|weeks)?\s*$"
)
_UNIT_SECONDS = {
    None: 1, "s": 1, "sec": 1, "second": 1, "seconds": 1,
    "m": 60, "min": 60, "minute": 60, "minutes": 60,
    "h": 3600, "hour": 3600, "hours": 3600,
    "d": 86400, "day": 86400, "days": 86400,
    "w": 604800, "week": 604800, "weeks": 604800,
}


def parse_duration(spec: "str | int | float | timedelta") -> timedelta:
    """Parse ``"30 days"`` / ``"3600s"`` / seconds (scala Duration parity)."""
    if isinstance(spec, timedelta):
        return spec
    if isinstance(spec, (int, float)):
        return timedelta(seconds=spec)
    m = _DURATION_RE.match(spec)
    if not m:
        raise ValueError(f"Cannot parse duration {spec!r}")
    return timedelta(seconds=int(m.group(1)) * _UNIT_SECONDS[m.group(2)])


@dataclasses.dataclass(frozen=True)
class EventWindow:
    """SelfCleaningDataSource.scala:321 EventWindow."""

    duration: Optional[str] = None
    remove_duplicates: bool = False
    compress_properties: bool = False


def _dedup_key(e: Event) -> Tuple:
    # identity minus eventId/eventTime/creationTime — the reference's
    # removeDuplicates keys on the event recreated with times zeroed
    # (SelfCleaningDataSource.scala:128-152 recreateEvent) and keeps the
    # first occurrence's id and eventTime.
    return (
        e.event, e.entity_type, e.entity_id, e.target_entity_type,
        e.target_entity_id, e.properties, e.pr_id, e.tags,
    )


def compress_properties(events: Iterable[Event]) -> List[Event]:
    """Compress per-entity ``$set`` chains (compressPProperties:107-117):
    all ``$set`` events of one entity merge right-biased-by-time into a
    single ``$set`` carrying the chain's final property state, stamped with
    the latest event time. Everything else (incl. ``$unset``) passes through,
    matching the reference's ``isSetEvent`` filter."""
    set_chains: dict[Tuple[str, str], List[Event]] = {}
    out: List[Event] = []
    for e in sorted(events, key=lambda e: e.event_time):
        if e.event == "$set":
            set_chains.setdefault((e.entity_type, e.entity_id), []).append(e)
        else:
            out.append(e)
    for chain in set_chains.values():
        merged = DataMap()
        for e in chain:
            merged = merged + e.properties
        out.append(
            dataclasses.replace(chain[-1], properties=merged, event_id=None)
        )
    return sorted(out, key=lambda e: e.event_time)


class SelfCleaningDataSource:
    """Mixin for DataSources. Set ``app_name`` and ``event_window``; call
    :meth:`clean_persisted_events` at the start of ``read_training``
    (the reference calls it from readTraining/readEval wrappers,
    SelfCleaningDataSource.scala:269-301)."""

    app_name: str
    #: optional channel the DataSource reads — cleaning targets the same one
    channel_name: Optional[str] = None
    event_window: Optional[EventWindow] = None

    def _app_id(self) -> int:
        app = Storage.get_meta_data_apps().get_by_name(self.app_name)
        if app is None:
            raise ValueError(f"Invalid app name {self.app_name}")
        return app.id

    def _channel_id(self) -> Optional[int]:
        name = getattr(self, "channel_name", None)
        if not name:
            return None
        for c in Storage.get_meta_data_channels().get_by_appid(self._app_id()):
            if c.name == name:
                return c.id
        raise ValueError(
            f"Invalid channel name {name} for app {self.app_name}"
        )

    def get_cleaned_events(self, events: Iterable[Event]) -> List[Event]:
        """Pure transformation (cleanPEvents/compress/dedup)."""
        window = self.event_window
        rows = list(events)
        if window is None:
            return sorted(rows, key=lambda e: e.event_time)
        if window.duration is not None:
            cutoff = now_utc() - parse_duration(window.duration)
            rows = [e for e in rows if e.event_time >= cutoff]
        if window.compress_properties:
            rows = compress_properties(rows)
        if window.remove_duplicates:
            seen = set()
            unique = []
            for e in sorted(rows, key=lambda e: e.event_time):
                k = _dedup_key(e)
                if k not in seen:
                    seen.add(k)
                    unique.append(e)
            rows = unique
        return sorted(rows, key=lambda e: e.event_time)

    def clean_persisted_events(self, channel_id: Optional[int] = "__from_name__") -> int:
        """Clean + rewrite the persisted events (cleanPersistedPEvents:161,
        wipe:209) of the channel this DataSource reads (``channel_name``,
        default channel when unset). Returns the cleaned event count."""
        if self.event_window is None:
            return 0
        if channel_id == "__from_name__":
            channel_id = self._channel_id()
        app_id = self._app_id()
        dao = Storage.get_events()
        before = list(dao.find(app_id=app_id, channel_id=channel_id))
        cleaned = self.get_cleaned_events(before)
        logger.info(
            "SelfCleaningDataSource: %d events -> %d after cleaning",
            len(before), len(cleaned),
        )
        dao.remove(app_id, channel_id)
        dao.init(app_id, channel_id)
        for e in cleaned:
            dao.insert(e, app_id, channel_id)
        return len(cleaned)
