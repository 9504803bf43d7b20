"""The port's event storage (``data/storage/{memory,sqlite,cpplog}.py``,
``data/store.py``) against the JAX package's, on the same seeded events.

Each case builds one list of event specs from a numpy seed and inserts it
through each package's DAO of the same backend type; the reads must agree
exactly: ``scan_interactions`` (ids, triple order, values, the time window,
value resolution, and the generic Event-object scan that backends without a
columnar path take), ``find`` and ``find_by_entity`` (filters, newest
first, limit) and ``aggregate_properties``. Parametrised over the backends
both packages have, as tests/test_storage_conformance.py is.
"""

from datetime import timedelta

import numpy as np
import pytest

from incubator_predictionio_tpu.data.datamap import DataMap as JDataMap
from incubator_predictionio_tpu.data.event import Event as JEvent
from incubator_predictionio_tpu.data.storage import (
    StorageClientConfig as JConfig,
)
from incubator_predictionio_tpu.data.storage import base as jbase
from incubator_predictionio_tpu.data.storage import cpplog as jcpplog
from incubator_predictionio_tpu.data.storage import memory as jmemory
from incubator_predictionio_tpu.data.storage import sqlite as jsqlite
from incubator_predictionio_tpu.utils.times import parse_iso8601 as jparse
from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage import (
    StorageClientConfig,
    StorageError,
)
from incubator_predictionio_tpu_torch.data.storage import base as tbase
from incubator_predictionio_tpu_torch.data.storage import cpplog as tcpplog
from incubator_predictionio_tpu_torch.data.storage import memory as tmemory
from incubator_predictionio_tpu_torch.data.storage import sqlite as tsqlite
from incubator_predictionio_tpu_torch.utils.times import parse_iso8601

T0 = "2024-03-01T00:00:00Z"
USERS = ["alice", "bob", "éva", 'q"uote\\back', "u4", "u5"]
ITEMS = ["i1", "i2", "ïtem-√2", "i4", "i5", "i6", "i7"]
APP = 9


def _specs(seed: int, n: int = 160):
    """Event specs: (name, user, item or None, properties, minutes). Rate
    events carry a rating (sometimes none, sometimes a string), buys and
    views none; ``$set`` events on items carry properties; many events
    share a minute, so ties fall to the insertion order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = rng.choice(["rate", "rate", "rate", "buy", "view", "$set"])
        minute = int(rng.integers(0, 40))
        if kind == "$set":
            item = ITEMS[int(rng.integers(len(ITEMS)))]
            props = {"creationYear": int(rng.integers(1990, 2020))}
            if rng.random() < 0.5:
                props["categories"] = [f"c{int(c)}" for c in
                                       rng.integers(0, 4, 2)]
            out.append(("$set", item, None, props, minute))
            continue
        user = USERS[int(rng.integers(len(USERS)))]
        item = ITEMS[int(rng.integers(len(ITEMS)))]
        props = {}
        if kind == "rate":
            r = rng.random()
            if r < 0.8:
                props["rating"] = float(rng.integers(1, 11)) / 2
            elif r < 0.9:
                props["rating"] = "high"
        out.append((kind, user, item, props, minute))
    return out


def _events(specs, event_cls, datamap_cls, parse):
    t0 = parse(T0)
    out = []
    for name, ent, target, props, minute in specs:
        if name == "$set":
            out.append(event_cls(
                event=name, entity_type="item", entity_id=ent,
                properties=datamap_cls(props),
                event_time=t0 + timedelta(minutes=minute)))
        else:
            out.append(event_cls(
                event=name, entity_type="user", entity_id=ent,
                target_entity_type="item", target_entity_id=target,
                properties=datamap_cls(props),
                event_time=t0 + timedelta(minutes=minute)))
    return out


_BACKENDS = {"memory": (jmemory, tmemory), "sqlite": (jsqlite, tsqlite),
             "cpplog": (jcpplog, tcpplog)}


@pytest.fixture(params=sorted(_BACKENDS))
def pair(request, tmp_path):
    """(JAX Events DAO, the port's Events DAO), one backend type, each on
    its own fresh store (cpplog: a log directory of its own under
    ``tmp_path``)."""
    jmod, tmod = _BACKENDS[request.param]
    jpath = tpath = ":memory:"
    if request.param == "cpplog":
        jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jconf = JConfig(test=True, properties={"PATH": jpath})
    tconf = StorageClientConfig(test=True, properties={"PATH": tpath})
    jclient, tclient = jmod.StorageClient(jconf), tmod.StorageClient(tconf)
    jdao = jmod.DATA_OBJECTS["Events"](jclient, jconf, prefix="t_")
    tdao = tmod.DATA_OBJECTS["Events"](tclient, tconf, prefix="t_")
    jdao.init(APP)
    tdao.init(APP)
    yield jdao, tdao
    jclient.close()
    tclient.close()


def _fill(pair, seed, one_by_one=False):
    jdao, tdao = pair
    specs = _specs(seed)
    jev = _events(specs, JEvent, JDataMap, jparse)
    tev = _events(specs, Event, DataMap, parse_iso8601)
    if one_by_one:
        for je, te in zip(jev, tev):
            jdao.insert(je, APP)
            tdao.insert(te, APP)
    else:
        jdao.insert_batch(jev, APP)
        tdao.insert_batch(tev, APP)
    return specs


def _same_interactions(got, ref):
    assert list(got.user_ids) == list(ref.user_ids)
    assert list(got.item_ids) == list(ref.item_ids)
    for f in ("user_idx", "item_idx", "values"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _ev_key(e):
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, e.properties.to_jsonable(),
            e.event_time.isoformat())


SCANS = {
    "rate_and_buy": dict(event_names=("rate", "buy"), value_prop="rating",
                         event_values={"buy": 4.0}),
    "rate_only": dict(event_names=("rate",), value_prop="rating"),
    "views_default": dict(event_names=("view",), default_value=2.5),
    "nothing": dict(event_names=()),
    "window": dict(event_names=("rate", "buy"), value_prop="rating",
                   event_values={"buy": 3.0},
                   start_time=(10,), until_time=(30,)),
}


@pytest.mark.parametrize("scan", sorted(SCANS))
@pytest.mark.parametrize("seed", [0, 1])
def test_scan_interactions_matches_jax(pair, scan, seed):
    _fill(pair, seed)
    jdao, tdao = pair
    kw = dict(SCANS[scan])
    jkw, tkw = dict(kw), dict(kw)
    for key in ("start_time", "until_time"):
        if key in kw:
            (minute,) = kw[key]
            jkw[key] = jparse(T0) + timedelta(minutes=minute)
            tkw[key] = parse_iso8601(T0) + timedelta(minutes=minute)
    ref = jdao.scan_interactions(app_id=APP, **jkw)
    got = tdao.scan_interactions(app_id=APP, **tkw)
    _same_interactions(got, ref)
    # the generic scan over Event objects (the path of a backend without a
    # columnar one) gives the same in both packages
    gen_ref = jbase.Events.scan_interactions(jdao, app_id=APP, **jkw)
    gen_got = tbase.Events.scan_interactions(tdao, app_id=APP, **tkw)
    _same_interactions(gen_got, gen_ref)
    if scan == "rate_and_buy":
        assert len(got) > 50


def test_scan_interactions_of_unparsed_properties_match_jax(pair):
    """Events whose properties include a key too long for a columnar
    sidecar, and a rate without its value: the same triples."""
    jdao, tdao = pair
    long_key = "k" * 300
    rows = [("alice", "i1", 4.5, 0), ("éva", "ïtem-√2", 5.0, 1),
            ('q"uote\\back', "i1", None, 2), ("bob", "i2", 1.5, 2)]
    for dao, ev, dm, parse in ((jdao, JEvent, JDataMap, jparse),
                               (tdao, Event, DataMap, parse_iso8601)):
        for user, item, rating, minute in rows:
            props = {long_key: 1.0}
            if rating is not None:
                props["rating"] = rating
            dao.insert(ev(event="rate", entity_type="user", entity_id=user,
                          target_entity_type="item", target_entity_id=item,
                          properties=dm(props),
                          event_time=parse(T0) + timedelta(minutes=minute)),
                       APP)
    kw = dict(app_id=APP, event_names=("rate",), value_prop="rating")
    _same_interactions(tdao.scan_interactions(**kw),
                       jdao.scan_interactions(**kw))
    assert list(tdao.scan_interactions(**kw).user_ids) == [
        "alice", "éva", "bob"]


FINDS = {
    "all": dict(),
    "rates": dict(event_names=["rate"]),
    "views_and_buys_reversed": dict(event_names=["view", "buy"],
                                    reversed=True),
    "one_user": dict(entity_type="user", entity_id="éva"),
    "one_target": dict(target_entity_type="item", target_entity_id="i2"),
    "limit": dict(event_names=["rate"], limit=7),
    "reversed_limit": dict(reversed=True, limit=5),
}


@pytest.mark.parametrize("query", sorted(FINDS))
def test_find_matches_jax(pair, query):
    _fill(pair, 2, one_by_one=True)
    jdao, tdao = pair
    kw = FINDS[query]
    ref = [_ev_key(e) for e in jdao.find(app_id=APP, **kw)]
    got = [_ev_key(e) for e in tdao.find(app_id=APP, **kw)]
    assert got == ref
    assert ref


@pytest.mark.parametrize("limit", [None, 1, 3, 64])
@pytest.mark.parametrize("user", ["alice", "u5", "nobody"])
def test_find_by_entity_latest_matches_jax(pair, user, limit):
    """The sequence engine's history read: one user's view and buy events,
    newest first, cut at ``limit``."""
    _fill(pair, 3)
    jdao, tdao = pair
    kw = dict(app_id=APP, entity_type="user", entity_id=user,
              event_names=["view", "buy"], limit=limit, reversed=True)
    ref = [_ev_key(e) for e in jdao.find(**kw)]
    got = [_ev_key(e) for e in tdao.find(**kw)]
    assert got == ref
    times = [k[-1] for k in got]
    assert times == sorted(times, reverse=True)


@pytest.mark.parametrize("required", [None, ["creationYear"],
                                      ["categories"]])
def test_aggregate_properties_matches_jax(pair, required):
    _fill(pair, 4)
    jdao, tdao = pair
    ref = jdao.aggregate_properties(app_id=APP, entity_type="item",
                                    required=required)
    got = tdao.aggregate_properties(app_id=APP, entity_type="item",
                                    required=required)
    assert sorted(got) == sorted(ref)
    assert got
    for k in ref:
        assert got[k].to_jsonable() == ref[k].to_jsonable()
        assert got[k].first_updated == ref[k].first_updated
        assert got[k].last_updated == ref[k].last_updated


def test_import_interactions_round_trips_like_jax(pair):
    from incubator_predictionio_tpu.data.storage.base import (
        Interactions as JInteractions,
    )
    from incubator_predictionio_tpu_torch.data.interactions import (
        Interactions,
    )

    jdao, tdao = pair
    rng = np.random.default_rng(5)
    cols = dict(user_idx=rng.integers(0, 6, 300).astype(np.int32),
                item_idx=rng.integers(0, 7, 300).astype(np.int32),
                values=(rng.integers(1, 11, 300) / 2).astype(np.float32),
                user_ids=USERS, item_ids=ITEMS)
    jdao.import_interactions(JInteractions(**cols), APP,
                             base_time=jparse(T0))
    tdao.import_interactions(Interactions(**cols), APP,
                             base_time=parse_iso8601(T0))
    kw = dict(app_id=APP, event_names=("rate",), value_prop="rating")
    got = tdao.scan_interactions(**kw)
    _same_interactions(got, jdao.scan_interactions(**kw))
    ids_u = np.asarray([got.user_ids[i] for i in got.user_idx])
    np.testing.assert_array_equal(ids_u, np.asarray(USERS)[cols["user_idx"]])
    np.testing.assert_array_equal(got.values, cols["values"])


@pytest.mark.parametrize("kind", ["remote", "gcs"])
def test_unported_backends_raise_naming_the_queue(tmp_path, monkeypatch,
                                                  kind):
    from incubator_predictionio_tpu_torch.data.storage import Storage

    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    Storage.configure({"PIO_STORAGE_SOURCES_X_TYPE": kind,
                       "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "ev",
                       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "X"})
    try:
        with pytest.raises(StorageError, match="Queue 1, item 1.6b"):
            Storage.get_events()
    finally:
        Storage.reset()


@pytest.mark.parametrize("path", ["explicit", "pio_home"])
def test_cpplog_type_gives_the_ports_cpplog_events(tmp_path, monkeypatch,
                                                   path):
    """``TYPE=cpplog`` is the port's own ``CppLogEvents`` (never the JAX
    package's class), its log under ``PATH`` or ``$PIO_HOME/cpplog``; an
    event written through it reads back."""
    from incubator_predictionio_tpu_torch.data.storage import Storage

    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    env = {"PIO_STORAGE_SOURCES_LOG_TYPE": "cpplog",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "ev",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG"}
    where = tmp_path / "home" / "cpplog"
    if path == "explicit":
        where = tmp_path / "logs"
        env["PIO_STORAGE_SOURCES_LOG_PATH"] = str(where)
    Storage.configure(env)
    try:
        events = Storage.get_events()
        assert type(events) is tcpplog.CppLogEvents
        assert type(events).__module__ == \
            "incubator_predictionio_tpu_torch.data.storage.cpplog"
        assert events.init(APP)
        eid = events.insert(Event(
            event="rate", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i1",
            properties=DataMap({"rating": 4.0})), APP)
        assert events.get(eid, APP).entity_id == "u1"
        assert (where / f"ev_app{APP}_ch0.log").exists()
    finally:
        Storage.reset()
