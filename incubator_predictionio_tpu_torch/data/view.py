"""Batch views (deprecated) — predicate + aggregator views over event lists.

Parity: data/.../view/{LBatchView,PBatchView,DataView}.scala. The reference
deprecated these in favour of LEvents/LEventStore (``@deprecated("Use
LEvents …", "0.9.2")``, LBatchView.scala:31) but ships them; the same
capability here is a thin functional layer over an in-memory event sequence.
The reference's L (local Seq) / P (RDD) split collapses to one Python
sequence. The port's copy of incubator_predictionio_tpu/data/view.py.

``DataView.create`` in the reference builds a Spark DataFrame
(DataView.scala:39-60); ``data_view`` returns flat row dicts, the
tabular-analysis equivalent in a Spark-free runtime.
"""

from __future__ import annotations

import warnings
from datetime import datetime
from typing import Any, Callable, Dict, Iterable, List, Optional, TypeVar

from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.data.event import Event

T = TypeVar("T")

_DEPRECATION = "Batch views are deprecated; use Events DAO / EventStore instead."


def _predicate(
    start_time: Optional[datetime] = None,
    until_time: Optional[datetime] = None,
    entity_type: Optional[str] = None,
    event: Optional[str] = None,
) -> Callable[[Event], bool]:
    """ViewPredicates (LBatchView.scala:32-68): startTime is *exclusive* in
    the reference's predicate, untilTime exclusive-end."""
    def pred(e: Event) -> bool:
        if start_time is not None and e.event_time <= start_time:
            return False
        if until_time is not None and e.event_time >= until_time:
            return False
        if entity_type is not None and e.entity_type != entity_type:
            return False
        if event is not None and e.event != event:
            return False
        return True
    return pred


def data_map_aggregator() -> Callable[[Optional[DataMap], Event], Optional[DataMap]]:
    """ViewAggregators.getDataMapAggregator (LBatchView.scala:70-94):
    fold $set/$unset/$delete into an optional property map."""
    def agg(p: Optional[DataMap], e: Event) -> Optional[DataMap]:
        if e.event == "$set":
            return e.properties if p is None else p + e.properties
        if e.event == "$unset":
            return None if p is None else p - e.properties.key_set
        if e.event == "$delete":
            return None
        return p
    return agg


class BatchView:
    """LBatchView/PBatchView — filtered, aggregated views over events.

    (LBatchView.scala:96-160: ``events.filter(...)``, ``aggregateByEntityOrdered``.)
    """

    def __init__(self, events: Iterable[Event]):
        warnings.warn(_DEPRECATION, DeprecationWarning, stacklevel=2)
        self._events: List[Event] = sorted(events, key=lambda e: e.event_time)

    @property
    def events(self) -> List[Event]:
        return list(self._events)

    def filter(
        self,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        event: Optional[str] = None,
    ) -> List[Event]:
        pred = _predicate(start_time, until_time, entity_type, event)
        return [e for e in self._events if pred(e)]

    def aggregate_by_entity_ordered(
        self,
        init: Optional[T],
        op: Callable[[Optional[T], Event], Optional[T]],
        predicate: Optional[Callable[[Event], bool]] = None,
    ) -> Dict[str, Optional[T]]:
        """Fold events per entityId in event-time order
        (LBatchView.aggregateByEntityOrdered)."""
        out: Dict[str, Optional[T]] = {}
        for e in self._events:
            if predicate is not None and not predicate(e):
                continue
            out[e.entity_id] = op(out.get(e.entity_id, init), e)
        return out

    def aggregate_properties(
        self,
        entity_type: str,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
    ) -> Dict[str, DataMap]:
        """The canonical view: current property state per entity
        (LBatchView.scala:150-160)."""
        result = self.aggregate_by_entity_ordered(
            None,
            data_map_aggregator(),
            _predicate(start_time, until_time, entity_type=entity_type),
        )
        return {k: v for k, v in result.items() if v is not None}


def data_view(events: Iterable[Event]) -> List[Dict[str, Any]]:
    """Flat tabular rows from events (DataView.create, DataView.scala:39-60).

    One row per event: scalar columns plus flattened ``properties.<key>``
    columns — the schema the reference derives for its DataFrame.
    """
    warnings.warn(_DEPRECATION, DeprecationWarning, stacklevel=2)
    rows = []
    for e in events:
        row: Dict[str, Any] = {
            "eventId": e.event_id,
            "event": e.event,
            "entityType": e.entity_type,
            "entityId": e.entity_id,
            "targetEntityType": e.target_entity_type,
            "targetEntityId": e.target_entity_id,
            "eventTime": e.event_time,
            "prId": e.pr_id,
        }
        for k, v in e.properties.fields.items():
            row[f"properties.{k}"] = v
        rows.append(row)
    return rows
