"""The port's deprecated batch views (``data/view.py``: ``BatchView`` and
``data_view``) against the JAX package's, on the cases of
tests/test_parity_fillers.py: each warns ``DeprecationWarning`` and gives
the JAX package's answer on the same events."""

from datetime import timedelta

import pytest

from incubator_predictionio_tpu.data import datamap as jdatamap
from incubator_predictionio_tpu.data import event as jevent
from incubator_predictionio_tpu.data import view as jview
from incubator_predictionio_tpu_torch.data import datamap as tdatamap
from incubator_predictionio_tpu_torch.data import event as tevent
from incubator_predictionio_tpu_torch.data import view as tview
from incubator_predictionio_tpu_torch.utils.times import parse_iso8601

T0 = parse_iso8601("2021-06-01T00:00:00Z")
PKGS = ((jdatamap, jevent, jview), (tdatamap, tevent, tview))


def _ev(pkg, name, eid, props=None, minutes=0, **kw):
    datamap, event, _view = pkg
    return event.Event(
        event=name, entity_type="user", entity_id=eid,
        properties=datamap.DataMap(props or {}),
        event_time=T0 + timedelta(minutes=minutes), **kw)


def _both(fn):
    """``fn(pkg)`` through the JAX package, then the port; each under a
    DeprecationWarning."""
    out = []
    for pkg in PKGS:
        with pytest.warns(DeprecationWarning):
            out.append(fn(pkg))
    return out


def test_batch_view_aggregate_properties_matches_jax():
    def run(pkg):
        view = pkg[2].BatchView([
            _ev(pkg, "$set", "u1", {"a": 1, "b": 2}, minutes=0),
            _ev(pkg, "$set", "u1", {"b": 3}, minutes=1),
            _ev(pkg, "$unset", "u1", {"a": 0}, minutes=2),
            _ev(pkg, "$set", "u2", {"x": 9}, minutes=0),
            _ev(pkg, "$delete", "u2", minutes=5),
            _ev(pkg, "rate", "u1", {"rating": 5}, minutes=3),
        ])
        return {k: v.fields for k, v in
                view.aggregate_properties("user").items()}

    ref, got = _both(run)
    assert got == ref == {"u1": {"b": 3}}   # $delete clears the entity


def test_batch_view_filter_start_time_exclusive_matches_jax():
    def run(pkg):
        view = pkg[2].BatchView([_ev(pkg, "rate", "u1", minutes=m)
                                 for m in (0, 1, 2)])
        # the start-time predicate is exclusive (LBatchView.scala:39-41)
        out = view.filter(start_time=T0,
                          until_time=T0 + timedelta(minutes=2))
        return [e.event_time for e in out]

    ref, got = _both(run)
    assert got == ref == [T0 + timedelta(minutes=1)]


def test_data_view_rows_match_jax():
    def run(pkg):
        return pkg[2].data_view([
            _ev(pkg, "rate", "u1", {"rating": 4}, target_entity_type="item",
                target_entity_id="i9"),
            _ev(pkg, "view", "u2", {"tags": ["a"]}, minutes=3)])

    ref, got = _both(run)
    assert got == ref
    assert got[0]["targetEntityId"] == "i9"
    assert got[0]["properties.rating"] == 4
