"""The Event record and its validation rules.

The port's own copy of incubator_predictionio_tpu/data/event.py, its imports
rewritten to this package.

Behavior parity with reference data/.../storage/Event.scala:42-167:
the immutable event record (name, entity, optional target entity, property
``DataMap``, event time, tags, prId, creation time) and the full reserved-name
validation matrix for ``$set`` / ``$unset`` / ``$delete`` and the ``pio_``
prefix.
"""

from __future__ import annotations

import dataclasses
import uuid
from datetime import datetime
from typing import Any, Optional, Sequence

from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.utils.times import (
    ensure_aware,
    format_iso8601,
    now_utc,
    parse_iso8601,
)

#: Reserved single-entity event names (Event.scala:83).
SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})

#: Built-in entity types allowed to carry the reserved prefix (Event.scala:146).
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})

#: Built-in properties (Event.scala:149 — currently empty).
BUILTIN_PROPERTIES: frozenset[str] = frozenset()


def is_reserved_prefix(name: str) -> bool:
    """True for names starting with ``$`` or ``pio_`` (Event.scala:77)."""
    return name.startswith("$") or name.startswith("pio_")


def is_special_event(name: str) -> bool:
    return name in SPECIAL_EVENTS


@dataclasses.dataclass(frozen=True)
class Event:
    """One event in the event store (Event.scala:42-53)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = dataclasses.field(default_factory=DataMap)
    event_time: datetime = dataclasses.field(default_factory=now_utc)
    tags: tuple[str, ...] = ()
    pr_id: Optional[str] = None
    creation_time: datetime = dataclasses.field(default_factory=now_utc)
    event_id: Optional[str] = None

    def __post_init__(self) -> None:
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))
        if isinstance(self.tags, list):
            object.__setattr__(self, "tags", tuple(self.tags))
        # Naive datetimes are interpreted as UTC (the reference's default
        # zone, Event.scala:70) so ordering comparisons never mix aware/naive.
        object.__setattr__(self, "event_time", ensure_aware(self.event_time))
        object.__setattr__(self, "creation_time", ensure_aware(self.creation_time))

    def with_id(self, event_id: str) -> "Event":
        return dataclasses.replace(self, event_id=event_id)

    # -- wire format (EventJson4sSupport semantics: data/.../storage/EventJson4sSupport.scala)
    def to_jsonable(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "eventId": self.event_id,
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "targetEntityType": self.target_entity_type,
            "targetEntityId": self.target_entity_id,
            "properties": self.properties.to_jsonable(),
            "eventTime": format_iso8601(self.event_time),
            "tags": list(self.tags),
            "prId": self.pr_id,
            "creationTime": format_iso8601(self.creation_time),
        }
        return {k: v for k, v in out.items() if v is not None}

    @classmethod
    def from_jsonable(cls, obj: dict[str, Any]) -> "Event":
        """Build (and validate field types of) an Event from API JSON."""
        if not isinstance(obj, dict):
            raise ValueError(f"Event requires a JSON object, got {obj!r}")

        def _opt_str(key: str) -> Optional[str]:
            v = obj.get(key)
            if v is not None and not isinstance(v, str):
                raise ValueError(f"field {key} must be a string, got {v!r}")
            return v

        event = obj.get("event")
        if not isinstance(event, str):
            raise ValueError("field event is required and must be a string")
        entity_type = obj.get("entityType")
        entity_id = obj.get("entityId")
        if not isinstance(entity_type, str) or not isinstance(entity_id, str):
            raise ValueError("fields entityType and entityId are required strings")

        properties = obj.get("properties")
        if properties is None:
            properties = {}
        if not isinstance(properties, dict):
            raise ValueError("field properties must be a JSON object")

        # Absent/null times default to receive time; malformed values (e.g.
        # empty strings) must fail loudly, as the reference's joda parser does.
        event_time = (
            parse_iso8601(obj["eventTime"])
            if obj.get("eventTime") is not None
            else now_utc()
        )
        creation_time = (
            parse_iso8601(obj["creationTime"])
            if obj.get("creationTime") is not None
            else now_utc()
        )
        tags = obj.get("tags") or []
        if not isinstance(tags, list) or not all(isinstance(t, str) for t in tags):
            raise ValueError("field tags must be an array of strings")

        return cls(
            event=event,
            entity_type=entity_type,
            entity_id=entity_id,
            target_entity_type=_opt_str("targetEntityType"),
            target_entity_id=_opt_str("targetEntityId"),
            properties=DataMap(properties),
            event_time=event_time,
            tags=tuple(tags),
            pr_id=_opt_str("prId"),
            creation_time=creation_time,
            event_id=_opt_str("eventId"),
        )


def new_event_id() -> str:
    """Generate a unique event ID (the reference derives one from the HBase
    row key, HBEventsUtil.RowKey:84-132; a UUID serves the same purpose)."""
    return uuid.uuid4().hex


class EventValidationError(ValueError):
    """Raised when an event violates the reserved-name/shape rules."""


def validate_event(e: Event) -> None:
    """Full validation matrix (Event.scala:112-143)."""

    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise EventValidationError(msg)

    check(bool(e.event), "event must not be empty.")
    check(bool(e.entity_type), "entityType must not be empty string.")
    check(bool(e.entity_id), "entityId must not be empty string.")
    check(e.target_entity_type != "", "targetEntityType must not be empty string")
    check(e.target_entity_id != "", "targetEntityId must not be empty string.")
    check(
        (e.target_entity_type is None) == (e.target_entity_id is None),
        "targetEntityType and targetEntityId must be specified together.",
    )
    check(
        not (e.event == "$unset" and e.properties.is_empty),
        "properties cannot be empty for $unset event",
    )
    check(
        not is_reserved_prefix(e.event) or is_special_event(e.event),
        f"{e.event} is not a supported reserved event name.",
    )
    check(
        not is_special_event(e.event)
        or (e.target_entity_type is None and e.target_entity_id is None),
        f"Reserved event {e.event} cannot have targetEntity",
    )
    check(
        not is_reserved_prefix(e.entity_type)
        or e.entity_type in BUILTIN_ENTITY_TYPES,
        f"The entityType {e.entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    if e.target_entity_type is not None:
        check(
            not is_reserved_prefix(e.target_entity_type)
            or e.target_entity_type in BUILTIN_ENTITY_TYPES,
            f"The targetEntityType {e.target_entity_type} is not allowed. "
            "'pio_' is a reserved name prefix.",
        )
    for k in e.properties.key_set:
        check(
            not is_reserved_prefix(k) or k in BUILTIN_PROPERTIES,
            f"The property {k} is not allowed. 'pio_' is a reserved name prefix.",
        )


def validate_events(events: Sequence[Event]) -> None:
    for e in events:
        validate_event(e)
