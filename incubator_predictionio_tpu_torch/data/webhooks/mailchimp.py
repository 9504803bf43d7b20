"""MailChimp form-webhook connector.

The port's own copy of incubator_predictionio_tpu/data/webhooks/mailchimp.py,
its imports pointed at this package.

Parity: data/.../webhooks/mailchimp/MailChimpConnector.scala:33-280 —
handles subscribe / unsubscribe / profile / upemail / cleaned / campaign
form posts. MailChimp posts flat form data with bracketed keys
(``data[email]``, ``data[merges][FNAME]``); times use
``yyyy-MM-dd HH:mm:ss`` in UTC.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any, Dict

from incubator_predictionio_tpu_torch.data.webhooks import ConnectorError, FormConnector
from incubator_predictionio_tpu_torch.utils.times import format_iso8601


def _parse_time(s: str) -> str:
    dt = datetime.strptime(s, "%Y-%m-%d %H:%M:%S").replace(tzinfo=timezone.utc)
    return format_iso8601(dt)


def _nested(data: Dict[str, str], prefix: str) -> Dict[str, Any]:
    """Collect ``prefix[...]`` keys into a (possibly nested) dict."""
    out: Dict[str, Any] = {}
    for key, value in data.items():
        if not key.startswith(prefix + "["):
            continue
        path = key[len(prefix):]
        parts = [p[:-1] for p in path.split("[")[1:]]  # strip trailing ]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                # 'data[x]=1&data[x][y]=2' — scalar and nested share a path
                raise ConnectorError(
                    f"Conflicting form keys under '{prefix}[{p}]'"
                )
        node[parts[-1]] = value
    return out


class MailChimpConnector(FormConnector):
    _HANDLERS = {
        "subscribe": ("subscribe", "user", "email"),
        "unsubscribe": ("unsubscribe", "user", "email"),
        "profile": ("profile", "user", "email"),
        "upemail": ("upemail", "user", "new_email"),
        "cleaned": ("cleaned", "user", "email"),
        "campaign": ("campaign", "campaign", "id"),
    }

    def to_event_json(self, data: Dict[str, str]) -> Dict[str, Any]:
        msg_type = data.get("type")
        if msg_type is None:
            raise ConnectorError(
                "The field 'type' is required for MailChimp data."
            )
        if msg_type not in self._HANDLERS:
            raise ConnectorError(
                f"Cannot convert unknown MailChimp data type {msg_type} "
                "to event JSON"
            )
        event_name, entity_type, id_field = self._HANDLERS[msg_type]
        payload = _nested(data, "data")
        entity_id = payload.get(id_field)
        if entity_id is None:
            raise ConnectorError(
                f"The field 'data[{id_field}]' is required for MailChimp "
                f"{msg_type} data."
            )
        properties = {k: v for k, v in payload.items() if k != id_field}
        event: Dict[str, Any] = {
            "event": event_name,
            "entityType": entity_type,
            "entityId": entity_id,
            "properties": properties,
        }
        if data.get("fired_at"):
            try:
                event["eventTime"] = _parse_time(data["fired_at"])
            except ValueError as e:
                raise ConnectorError(f"Invalid fired_at: {e}") from e
        return event
