"""SegmentIO webhook connector.

The port's own copy of incubator_predictionio_tpu/data/webhooks/segmentio.py,
its imports pointed at this package.

Parity: data/.../webhooks/segmentio/SegmentIOConnector.scala:24-200 —
handles identify / track / alias / page / screen / group message types;
the event name is the message type, the entity is the user
(``userId`` falling back to ``anonymousId``), and the type-specific payload
lands in ``properties``.
"""

from __future__ import annotations

from typing import Any, Dict

from incubator_predictionio_tpu_torch.data.webhooks import ConnectorError, JsonConnector

_TYPE_PROPERTIES = {
    # message type -> fields copied into event properties
    "identify": ("traits",),
    "track": ("properties", "event"),
    "alias": ("previousId", "userId"),
    "page": ("name", "properties"),
    "screen": ("name", "properties"),
    "group": ("groupId", "traits"),
}


class SegmentIOConnector(JsonConnector):
    def to_event_json(self, data: Dict[str, Any]) -> Dict[str, Any]:
        if "version" not in data:
            raise ConnectorError("Failed to get segment.io API version.")
        msg_type = data.get("type")
        if msg_type not in _TYPE_PROPERTIES:
            raise ConnectorError(
                f"Cannot convert unknown type {msg_type} to event JSON."
            )
        user_id = data.get("userId") or data.get("anonymousId")
        if not user_id:
            raise ConnectorError(
                "there was no `userId` or `anonymousId` in the common fields."
            )
        properties: Dict[str, Any] = {}
        for field in _TYPE_PROPERTIES[msg_type]:
            if data.get(field) is not None:
                properties[field] = data[field]
        if data.get("context") is not None:
            properties["context"] = data["context"]
        event: Dict[str, Any] = {
            "event": msg_type,
            "entityType": "user",
            "entityId": user_id,
            "properties": properties,
        }
        if data.get("timestamp"):
            event["eventTime"] = data["timestamp"]
        return event
