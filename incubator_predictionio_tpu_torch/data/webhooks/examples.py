"""Example webhook connectors — the connector-author documentation pair.

The port's own copy of incubator_predictionio_tpu/data/webhooks/examples.py,
its imports pointed at this package.

Parity: data/.../webhooks/examplejson/ExampleJsonConnector.scala and
exampleform/ExampleFormConnector.scala — the reference ships these as the
template for writing connectors, exercised by their own specs. Payload
shapes handled (same as the reference docstrings):

UserAction (json)::

    {"type": "userAction", "userId": "as34smg4", "event": "do_something",
     "context": {...}, "anotherProperty1": 100,
     "anotherProperty2": "optional1", "timestamp": "2015-01-02T00:30:12Z"}

UserActionItem (json) adds ``itemId`` and targets an item entity. The form
connector takes the same logical input flattened into form fields, with
``context[ip]``-style bracketed keys for the nested context object.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from incubator_predictionio_tpu_torch.data.webhooks import (
    ConnectorError,
    FormConnector,
    JsonConnector,
)


class ExampleJsonConnector(JsonConnector):
    """ExampleJsonConnector.scala:63-155."""

    def to_event_json(self, data: Dict[str, Any]) -> Dict[str, Any]:
        msg_type = data.get("type")
        if msg_type is None:
            raise ConnectorError("The field 'type' is required.")
        try:
            if msg_type == "userAction":
                return self._user_action(data)
            if msg_type == "userActionItem":
                return self._user_action_item(data)
        except ConnectorError:
            raise
        except Exception as exc:
            raise ConnectorError(
                f"Cannot convert {data} to event JSON. {exc}"
            ) from exc
        raise ConnectorError(
            f"Cannot convert unknown type '{msg_type}' to Event JSON."
        )

    @staticmethod
    def _require(data: Dict[str, Any], *names: str) -> None:
        for name in names:
            if name not in data:
                raise ConnectorError(f"The field '{name}' is required.")

    def _user_action(self, data: Dict[str, Any]) -> Dict[str, Any]:
        self._require(data, "userId", "event", "anotherProperty1", "timestamp")
        properties: Dict[str, Any] = {
            "anotherProperty1": int(data["anotherProperty1"]),
        }
        if data.get("context") is not None:
            properties["context"] = data["context"]
        if data.get("anotherProperty2") is not None:
            properties["anotherProperty2"] = data["anotherProperty2"]
        return {
            "event": data["event"],
            "entityType": "user",
            "entityId": data["userId"],
            "eventTime": data["timestamp"],
            "properties": properties,
        }

    def _user_action_item(self, data: Dict[str, Any]) -> Dict[str, Any]:
        self._require(data, "userId", "event", "itemId", "context", "timestamp")
        properties: Dict[str, Any] = {"context": data["context"]}
        if data.get("anotherPropertyA") is not None:
            properties["anotherPropertyA"] = float(data["anotherPropertyA"])
        if data.get("anotherPropertyB") is not None:
            properties["anotherPropertyB"] = bool(data["anotherPropertyB"])
        return {
            "event": data["event"],
            "entityType": "user",
            "entityId": data["userId"],
            "targetEntityType": "item",
            "targetEntityId": data["itemId"],
            "eventTime": data["timestamp"],
            "properties": properties,
        }


def _form_context(data: Dict[str, str], required: bool) -> Optional[Dict[str, Any]]:
    """Bracketed two-level form fields → nested context object
    (ExampleFormConnector.scala:80-127). When ``required``, all three
    context fields must be present (the reference's userActionItem path
    accesses each unconditionally, so a missing one raises)."""
    if not required and not any(k.startswith("context[") for k in data):
        return None
    if required:
        for field in ("context[ip]", "context[prop1]", "context[prop2]"):
            if field not in data:
                raise ConnectorError(f"The field '{field}' is required.")
    context: Dict[str, Any] = {}
    if "context[ip]" in data:
        context["ip"] = data["context[ip]"]
    if "context[prop1]" in data:
        context["prop1"] = float(data["context[prop1]"])
    if "context[prop2]" in data:
        context["prop2"] = data["context[prop2]"]
    return context


class ExampleFormConnector(FormConnector):
    """ExampleFormConnector.scala:54-127."""

    def to_event_json(self, data: Dict[str, str]) -> Dict[str, Any]:
        msg_type = data.get("type")
        if msg_type is None:
            raise ConnectorError("The field 'type' is required.")
        try:
            if msg_type == "userAction":
                return self._user_action(data)
            if msg_type == "userActionItem":
                return self._user_action_item(data)
        except ConnectorError:
            raise
        except Exception as exc:
            raise ConnectorError(
                f"Cannot convert {data} to event JSON. {exc}"
            ) from exc
        raise ConnectorError(
            f"Cannot convert unknown type {msg_type} to event JSON"
        )

    def _user_action(self, data: Dict[str, str]) -> Dict[str, Any]:
        properties: Dict[str, Any] = {
            "anotherProperty1": int(data["anotherProperty1"]),
        }
        context = _form_context(data, required=False)
        if context is not None:
            properties["context"] = context
        if "anotherProperty2" in data:
            properties["anotherProperty2"] = data["anotherProperty2"]
        return {
            "event": data["event"],
            "entityType": "user",
            "entityId": data["userId"],
            "eventTime": data["timestamp"],
            "properties": properties,
        }

    def _user_action_item(self, data: Dict[str, str]) -> Dict[str, Any]:
        properties: Dict[str, Any] = {"context": _form_context(data, required=True)}
        if "anotherPropertyA" in data:
            properties["anotherPropertyA"] = float(data["anotherPropertyA"])
        if "anotherPropertyB" in data:
            properties["anotherPropertyB"] = (
                data["anotherPropertyB"].lower() == "true"
            )
        return {
            "event": data["event"],
            "entityType": "user",
            "entityId": data["userId"],
            "targetEntityType": "item",
            "targetEntityId": data["itemId"],
            "eventTime": data["timestamp"],
            "properties": properties,
        }
