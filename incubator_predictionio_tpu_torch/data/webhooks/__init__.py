"""Webhooks framework — third-party payloads → Event JSON.

The port's own copy of incubator_predictionio_tpu/data/webhooks/__init__.py,
its imports pointed at this package.

Parity: data/.../webhooks/ — ``JsonConnector.toEventJson`` and
``FormConnector.toEventJson`` SPI (JsonConnector.scala:32,
FormConnector.scala:33), with the SegmentIO and MailChimp connectors and an
explicit registry replacing the reference's ``WebhooksConnectors`` object.
"""

from __future__ import annotations

import abc
from typing import Any, Dict


class ConnectorError(ValueError):
    """webhooks/ConnectorException.scala."""


class JsonConnector(abc.ABC):
    """Translates a JSON webhook payload to Event JSON (JsonConnector.scala:32)."""

    @abc.abstractmethod
    def to_event_json(self, data: Dict[str, Any]) -> Dict[str, Any]: ...


class FormConnector(abc.ABC):
    """Translates form-encoded webhook data to Event JSON (FormConnector.scala:33)."""

    @abc.abstractmethod
    def to_event_json(self, data: Dict[str, str]) -> Dict[str, Any]: ...


_JSON_CONNECTORS: Dict[str, JsonConnector] = {}
_FORM_CONNECTORS: Dict[str, FormConnector] = {}


def register_json_connector(name: str, connector: JsonConnector) -> None:
    _JSON_CONNECTORS[name] = connector


def register_form_connector(name: str, connector: FormConnector) -> None:
    _FORM_CONNECTORS[name] = connector


def json_connector(name: str) -> JsonConnector | None:
    _ensure_builtin()
    return _JSON_CONNECTORS.get(name)


def form_connector(name: str) -> FormConnector | None:
    _ensure_builtin()
    return _FORM_CONNECTORS.get(name)


_loaded = False


def _ensure_builtin() -> None:
    """Built-in connector registry (WebhooksConnectors.scala:29-34)."""
    global _loaded
    if _loaded:
        return
    from incubator_predictionio_tpu_torch.data.webhooks.segmentio import (
        SegmentIOConnector,
    )
    from incubator_predictionio_tpu_torch.data.webhooks.mailchimp import (
        MailChimpConnector,
    )

    _JSON_CONNECTORS.setdefault("segmentio", SegmentIOConnector())
    _FORM_CONNECTORS.setdefault("mailchimp", MailChimpConnector())
    _loaded = True
