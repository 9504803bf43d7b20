"""Replay of ``$set`` / ``$unset`` / ``$delete`` into entity property state.

The port's own copy of incubator_predictionio_tpu/data/aggregator.py, its
imports rewritten to this package.

Behavior parity with the reference's aggregators (data/.../storage/
LEventAggregator.scala:42-148 and PEventAggregator.scala:90-212): events are
ordered by event time; ``$set`` merges properties right-biased, ``$unset``
removes the named keys, ``$delete`` resets the entity to non-existent; other
event names do not affect property state. First/last updated times track only
the special events. An entity whose final state is "deleted" is filtered out.

The parallel (RDD ``aggregateByKey``) variant collapses here into the same
pure function: the TPU build does event aggregation on host (it is string /
dict work, not FLOPs) and only the *numeric* training data crosses to device.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Dict, Iterable, Optional

from incubator_predictionio_tpu_torch.data.datamap import DataMap, PropertyMap
from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.utils.times import to_millis

#: Event names that control aggregation (LEventAggregator.scala:92).
AGGREGATOR_EVENT_NAMES = ("$set", "$unset", "$delete")


@dataclasses.dataclass
class _Prop:
    dm: Optional[DataMap] = None
    first_updated: Optional[datetime] = None
    last_updated: Optional[datetime] = None


def _step(p: _Prop, e: Event) -> _Prop:
    if e.event == "$set":
        dm = e.properties if p.dm is None else p.dm + e.properties
    elif e.event == "$unset":
        dm = None if p.dm is None else p.dm - e.properties.key_set
    elif e.event == "$delete":
        dm = None
    else:
        return p
    first = e.event_time if p.first_updated is None else min(p.first_updated, e.event_time)
    last = e.event_time if p.last_updated is None else max(p.last_updated, e.event_time)
    return _Prop(dm=dm, first_updated=first, last_updated=last)


def _finish(p: _Prop) -> Optional[PropertyMap]:
    if p.dm is None:
        return None
    assert p.first_updated is not None and p.last_updated is not None
    return PropertyMap(
        p.dm.fields, first_updated=p.first_updated, last_updated=p.last_updated
    )


def aggregate_properties_single(events: Iterable[Event]) -> Optional[PropertyMap]:
    """Aggregate one entity's events (LEventAggregator.scala:68-90).

    The defensive sort runs at the ORDER CONTRACT's granularity — epoch
    MILLIS (base.Events.find docstring): durable backends store millis,
    so two events differing only at microsecond precision are a TIE that
    must replay in find/insertion order on every backend. Sorting by the
    raw datetime here once re-ordered such ties on the memory backend
    (which hands back original microseconds) and made the SAME $set
    sequence aggregate differently than on sqlite/cpplog — caught by the
    differential fuzz. Python's sort is stable, so on conforming
    (find-ordered) input this is a no-op."""
    p = _Prop()
    for e in sorted(events, key=lambda e: to_millis(e.event_time)):
        p = _step(p, e)
    return _finish(p)


def aggregate_properties(events: Iterable[Event]) -> Dict[str, PropertyMap]:
    """Aggregate events grouped by entityId (LEventAggregator.scala:42-62).

    Callers are expected to pre-filter to a single entityType (the event DAO
    query does this, LEvents.futureAggregateProperties).
    """
    by_entity: Dict[str, list[Event]] = {}
    for e in events:
        by_entity.setdefault(e.entity_id, []).append(e)
    out: Dict[str, PropertyMap] = {}
    for entity_id, group in by_entity.items():
        pm = aggregate_properties_single(group)
        if pm is not None:
            out[entity_id] = pm
    return out
