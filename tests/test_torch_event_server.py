"""The port's event server against the JAX package's, on the CPU.

- Both servers, each on its own SQLite store (or with the events on a
  cpplog log of its own, where the group commit's counters show at
  ``GET /stats.json``), take the same seeded
  requests: auth (access key, Basic header, channels, allowed events),
  single events (create, get, delete, find), batches on every leg (the
  native body parse, the doc-level gate, the generic per-event path; the
  50-event cap), webhooks (JSON and form), stats and plugins. Status codes
  and bodies must match, event ids aside, and each store's ``find`` must
  return the same events.
- The native batch-body parser: the port's ``uniform_interactions_from_
  body`` against the JAX package's on the same random bodies (the JAX
  package's own differential, ``tests/test_event_server.py``): identical
  output or both decline; and a strict subset of the port's doc gate.
- The port takes each batch leg where the reference does, and a native
  library that cannot be built is an error, never a quiet ``json.loads``.
"""

import base64
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from incubator_predictionio_tpu.data.storage import (
    AccessKey as JAccessKey,
    App as JApp,
    Channel as JChannel,
    Storage as JStorage,
)
from incubator_predictionio_tpu.data.storage import base as jbase
from incubator_predictionio_tpu.servers.event_server import (
    EventServer as JEventServer,
    EventServerConfig as JEventServerConfig,
)
from incubator_predictionio_tpu_torch import native
from incubator_predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Channel,
    Storage,
)
from incubator_predictionio_tpu_torch.data.storage import base as tbase
from incubator_predictionio_tpu_torch.data.storage.cpplog import CppLogEvents
from incubator_predictionio_tpu_torch.servers.event_server import (
    EventServer,
    EventServerConfig,
)


def _sqlite_env(path, events_dir=None):
    """Everything on one SQLite file; with ``events_dir``, the events on a
    cpplog log there instead (metadata and models stay on SQLite)."""
    env = {"PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_SQL_PATH": str(path)}
    for repo, name in (("METADATA", "m"), ("EVENTDATA", "e"),
                       ("MODELDATA", "d")):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = name
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "SQL"
    if events_dir is not None:
        env["PIO_STORAGE_SOURCES_LOG_TYPE"] = "cpplog"
        env["PIO_STORAGE_SOURCES_LOG_PATH"] = str(events_dir)
        env["PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE"] = "LOG"
    return env


def _seed_app(storage, app_cls, key_cls, channel_cls):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "srv-app"))
    storage.get_events().init(app_id)
    keys = storage.get_meta_data_access_keys()
    keys.insert(key_cls("testkey", app_id))
    keys.insert(key_cls("limitedkey", app_id, ("rate",)))
    storage.get_meta_data_channels().insert(channel_cls(0, "mobile", app_id))
    return app_id


@pytest.fixture
def servers(tmp_path):
    """(JAX server, port server, app id), each on its own SQLite store."""
    yield from _servers(tmp_path, log=False)


@pytest.fixture
def log_servers(tmp_path):
    """The same, with each store's events on a cpplog log of its own
    (metadata on SQLite)."""
    yield from _servers(tmp_path, log=True)


def _servers(tmp_path, log):
    JStorage.reset()
    Storage.reset()
    JStorage.configure(_sqlite_env(tmp_path / "jax.db",
                                   tmp_path / "jax_log" if log else None))
    Storage.configure(_sqlite_env(tmp_path / "port.db",
                                  tmp_path / "port_log" if log else None))
    app_j = _seed_app(JStorage, JApp, JAccessKey, JChannel)
    app_t = _seed_app(Storage, App, AccessKey, Channel)
    assert app_j == app_t
    jsrv = JEventServer(JEventServerConfig(ip="127.0.0.1", port=0,
                                           stats=True))
    tsrv = EventServer(EventServerConfig(ip="127.0.0.1", port=0, stats=True))
    jsrv.test_port = jsrv.start_background()
    tsrv.test_port = tsrv.start_background()
    yield jsrv, tsrv, app_t
    jsrv.stop()
    tsrv.stop()
    JStorage.reset()
    Storage.reset()


def call(port, method, path, body=None, headers=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None
    req_headers = dict(headers or {})
    if body is not None:
        if isinstance(body, (dict, list)):
            data = json.dumps(body).encode()
            req_headers.setdefault("Content-Type", "application/json")
        else:
            data = body if isinstance(body, bytes) else body.encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=req_headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _no_ids(obj):
    """A response body with its event ids and clock readings masked."""
    if isinstance(obj, list):
        return [_no_ids(x) for x in obj]
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in ("eventId", "creationTime",
                                        "startTime", "until") else _no_ids(v))
                for k, v in obj.items()}
    return obj


def _both(servers, method, path, body=None, headers=None):
    """The same request to both servers: equal status and body, ids
    aside. Returns (JAX response, port response)."""
    jsrv, tsrv, _app = servers
    j = call(jsrv.test_port, method, path, body, headers)
    t = call(tsrv.test_port, method, path, body, headers)
    assert j[0] == t[0], (method, path, j, t)
    assert _no_ids(j[1]) == _no_ids(t[1]), (method, path, j, t)
    return j, t


def _stored(storage, app_id, channel_id=None):
    """Every event of an app, as JSON, without its id and creation time;
    without its event time too where the server stamped it (no eventTime
    on the wire: ids start with ``n``)."""
    out = []
    for e in storage.get_events().find(app_id=app_id, channel_id=channel_id):
        doc = e.to_jsonable()
        doc.pop("eventId")
        doc.pop("creationTime")
        if doc["entityId"].startswith("n"):
            doc.pop("eventTime")
        out.append(doc)
    return sorted(out, key=lambda d: (d["entityId"],
                                      d.get("targetEntityId") or "",
                                      d["event"], d.get("eventTime", "")))


def _same_stores(servers, channel_id=None):
    _j, _t, app_id = servers
    got_j = _stored(JStorage, app_id, channel_id)
    got_t = _stored(Storage, app_id, channel_id)
    assert got_j == got_t
    return got_t


def _rate(rng, k, timed=True, **extra):
    doc = {"event": "rate", "entityType": "user",
           "entityId": f"{'t' if timed else 'n'}u{int(rng.integers(0, 9))}",
           "targetEntityType": "item",
           "targetEntityId": f"i{int(rng.integers(0, 20))}",
           "properties": {"rating": float(rng.integers(1, 6))}}
    if timed:
        doc["eventTime"] = f"2024-03-0{1 + k % 9}T10:00:{k % 60:02d}.000Z"
    doc.update(extra)
    return doc


def test_alive_and_auth(servers):
    rng = np.random.default_rng(1)
    ev = _rate(rng, 0)
    _both(servers, "GET", "/")
    _both(servers, "POST", "/events.json", ev)                      # 401
    _both(servers, "POST", "/events.json?accessKey=wrong", ev)      # 401
    creds = base64.b64encode(b"testkey:").decode()
    (js, _), (ts, _) = _both(servers, "POST", "/events.json", ev,
                             {"Authorization": f"Basic {creds}"})
    assert js == ts == 201
    _both(servers, "POST", "/events.json", ev,
          {"Authorization": "Basic !!notbase64"})
    _both(servers, "POST", "/events.json?accessKey=testkey&channel=nope", ev)
    (js, _), _t = _both(servers, "POST",
                        "/events.json?accessKey=testkey&channel=mobile", ev)
    assert js == 201
    _both(servers, "POST", "/events.json?accessKey=limitedkey", ev)
    (js, _), _t = _both(servers, "POST", "/events.json?accessKey=limitedkey",
                        dict(ev, event="buy"))
    assert js == 403
    _both(servers, "GET", "/stats.json?accessKey=testkey")
    assert len(_same_stores(servers)) == 2
    assert len(_same_stores(servers, channel_id=1)) == 1


def test_single_event_create_get_delete_find(servers):
    jsrv, tsrv, _app = servers
    rng = np.random.default_rng(2)
    docs = [_rate(rng, k) for k in range(12)]
    docs.append({"event": "$set", "entityType": "item", "entityId": "ti3",
                 "properties": {"categories": ["c1", "c2"], "year": 1994},
                 "eventTime": "2024-02-02T00:00:00.000Z"})
    ids = []
    for doc in docs:
        (js, jb), (ts, tb) = _both(servers, "POST",
                                   "/events.json?accessKey=testkey", doc)
        assert js == ts == 201
        ids.append((jb["eventId"], tb["eventId"]))
    # malformed and invalid events: the reference's 400s
    for bad in ({"entityType": "user"}, dict(docs[0], event="$bogus"),
                dict(docs[0], eventTime="not-a-time"), [1, 2]):
        (js, _), _t = _both(servers, "POST", "/events.json?accessKey=testkey",
                            bad)
        assert js == 400
    _both(servers, "POST", "/events.json?accessKey=testkey", b"{not json")
    for jid, tid in ids[:3]:
        j = call(jsrv.test_port, "GET", f"/events/{jid}.json?accessKey=testkey")
        t = call(tsrv.test_port, "GET", f"/events/{tid}.json?accessKey=testkey")
        assert j[0] == t[0] == 200 and _no_ids(j[1]) == _no_ids(t[1])
        j = call(jsrv.test_port, "DELETE",
                 f"/events/{jid}.json?accessKey=testkey")
        t = call(tsrv.test_port, "DELETE",
                 f"/events/{tid}.json?accessKey=testkey")
        assert j == t == (200, {"message": "Found"})
        j = call(jsrv.test_port, "GET", f"/events/{jid}.json?accessKey=testkey")
        t = call(tsrv.test_port, "GET", f"/events/{tid}.json?accessKey=testkey")
        assert j == t and j[0] == 404
    for query in ("", "&entityType=user&entityId=tu3", "&event=rate&limit=5",
                  "&limit=-1&reversed=true", "&targetEntityType=item",
                  "&startTime=2024-03-03T00:00:00.000Z"
                  "&untilTime=2024-03-06T00:00:00.000Z",
                  "&entityId=nobody", "&limit=x", "&startTime=yesterday"):
        _both(servers, "GET", f"/events.json?accessKey=testkey{query}")
    assert len(_same_stores(servers)) == len(docs) - 3


@pytest.mark.parametrize("leg", ["native", "doc", "generic", "mixed",
                                 "refused"])
def test_batch_legs_answer_and_store_alike(servers, leg):
    """The same batches through both servers: the port takes its native and
    doc legs where the JAX package's SQLite store has no columnar insert
    and goes per event; the answers and the stored events agree."""
    rng = np.random.default_rng({"native": 3, "doc": 4, "generic": 5,
                                 "mixed": 6, "refused": 7}[leg])
    path = "/batch/events.json?accessKey=testkey"
    if leg == "native":
        bodies = [[_rate(rng, k, timed=False) for k in range(n)]
                  for n in (8, 20, 50)]
    elif leg == "doc":
        bodies = [[_rate(rng, k) for k in range(n)] for n in (8, 33)]
    elif leg == "generic":
        bodies = [[_rate(rng, k, tags=["a"]) for k in range(12)],
                  [_rate(rng, k) for k in range(7)]]
    elif leg == "mixed":
        body = [_rate(rng, k) for k in range(10)]
        body[2] = {"entityType": "user"}
        body[5] = dict(body[5], event="$bogus")
        body[7] = dict(body[7], event="buy")
        bodies = [body]
    else:
        bodies = [[_rate(rng, k) for k in range(51)], {"not": "a list"},
                  b"[{broken"]
        (js, _), _t = _both(servers, "POST",
                            "/batch/events.json?accessKey=limitedkey",
                            [_rate(rng, k, event="buy") for k in range(9)])
        assert js == 200
    for body in bodies:
        _both(servers, "POST", path, body)
    # the SDKs' plural spelling of the route
    _both(servers, "POST", "/batches/events.json?accessKey=testkey",
          [_rate(rng, k) for k in range(9)])
    (_js, jstats), (_ts, tstats) = _both(servers, "GET",
                                         "/stats.json?accessKey=testkey")
    if isinstance(Storage.get_events(), CppLogEvents):
        # the group commit's counters, where the JAX server shows them
        assert tstats["groupCommit"] == jstats["groupCommit"]
        if leg == "native":
            assert tstats["groupCommit"]["events"] == 78 + 9
    else:
        assert "groupCommit" not in tstats
    stored = _same_stores(servers)
    if leg == "native":
        assert len(stored) == 78 + 9


def test_webhooks_stats_plugins_and_routes(servers):
    payload = {"version": "2", "type": "track", "userId": "tseg-user",
               "event": "Signed Up", "properties": {"plan": "Pro"},
               "timestamp": "2020-02-02T02:02:02.000Z"}
    (js, _), _t = _both(servers, "POST",
                        "/webhooks/segmentio.json?accessKey=testkey", payload)
    assert js == 201
    _both(servers, "GET", "/webhooks/segmentio.json?accessKey=testkey")
    _both(servers, "POST", "/webhooks/nope.json?accessKey=testkey", payload)
    _both(servers, "GET", "/webhooks/nope.json?accessKey=testkey")
    _both(servers, "POST", "/webhooks/segmentio.json?accessKey=testkey",
          {"type": "track"})
    form = ("type=subscribe&fired_at=2009-03-26 21:35:57"
            "&data[id]=8a25ff1d98&data[list_id]=a6b5da1054"
            "&data[email]=tapi@mailchimp.com"
            "&data[merges][EMAIL]=tapi@mailchimp.com"
            "&data[merges][FNAME]=MailChimp")
    (js, _), _t = _both(
        servers, "POST", "/webhooks/mailchimp.form?accessKey=testkey",
        form.encode(),
        {"Content-Type": "application/x-www-form-urlencoded"})
    assert js == 201
    _both(servers, "GET", "/webhooks/mailchimp.form?accessKey=testkey")
    _both(servers, "POST", "/webhooks/example.form?accessKey=testkey",
          b"type=nothing", {"Content-Type": "application/x-www-form-urlencoded"})
    for path in ("/events.json?accessKey=testkey&entityId=tseg-user",
                 "/events.json?accessKey=testkey&entityId=tapi@mailchimp.com",
                 "/stats.json?accessKey=testkey", "/plugins.json",
                 "/plugins/Nope/x", "/nope.json"):
        _both(servers, "GET", path)
    _both(servers, "DELETE", "/events.json?accessKey=testkey")      # 405
    _both(servers, "POST", "/reload?accessKey=testkey")
    assert len(_same_stores(servers)) == 2


# -- the same requests with the events on cpplog ----------------------------

def test_alive_and_auth_on_cpplog(log_servers):
    test_alive_and_auth(log_servers)


def test_single_event_create_get_delete_find_on_cpplog(log_servers):
    test_single_event_create_get_delete_find(log_servers)


@pytest.mark.parametrize("leg", ["native", "doc", "generic", "mixed",
                                 "refused"])
def test_batch_legs_answer_and_store_alike_on_cpplog(log_servers, leg):
    test_batch_legs_answer_and_store_alike(log_servers, leg)


def test_webhooks_stats_plugins_and_routes_on_cpplog(log_servers):
    test_webhooks_stats_plugins_and_routes(log_servers)


def test_stats_off_and_metrics(tmp_path):
    Storage.reset()
    Storage.configure(_sqlite_env(tmp_path / "port.db"))
    _seed_app(Storage, App, AccessKey, Channel)
    srv = EventServer(EventServerConfig(ip="127.0.0.1", port=0))
    port = srv.start_background()
    try:
        status, body = call(port, "GET", "/stats.json?accessKey=testkey")
        assert status == 404 and "--stats" in body["message"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
            text = resp.read().decode()
        assert "pio_build_info{" in text and "torch_version=" in text
        assert "pio_ingest_events_total" in text or "pio_http" in text
    finally:
        srv.stop()
        Storage.reset()


# -- the batch legs the port takes ------------------------------------------

@pytest.fixture
def port_server(tmp_path):
    Storage.reset()
    Storage.configure(_sqlite_env(tmp_path / "port.db"))
    app_id = _seed_app(Storage, App, AccessKey, Channel)
    srv = EventServer(EventServerConfig(ip="127.0.0.1", port=0,
                                        max_batch=500))
    srv.test_port = srv.start_background()
    yield srv, app_id
    srv.stop()
    Storage.reset()


@pytest.mark.parametrize("case,leg", [
    ("uniform", "native"), ("event_time", "doc"), ("tags", "generic"),
    ("seven", "generic"), ("escaped", "doc"), ("long_number", "doc")])
def test_port_batch_leg(port_server, monkeypatch, case, leg):
    """Which leg a body takes: the native parse from 8 uniform events up,
    the doc gate for what the native parser declines, the generic path for
    what both decline; the stored events are the wire's either way."""
    srv, app_id = port_server
    taken = []
    native_fn = tbase.uniform_interactions_from_body
    docs_fn = tbase.uniform_interactions_from_docs

    def by_body(body, max_n):
        got = native_fn(body, max_n)
        taken.append("native" if got is not None else "declined")
        return got

    def by_docs(docs):
        got = docs_fn(docs)
        taken.append("doc" if got is not None else "generic")
        return got

    monkeypatch.setattr(tbase, "uniform_interactions_from_body", by_body)
    monkeypatch.setattr(tbase, "uniform_interactions_from_docs", by_docs)
    rng = np.random.default_rng(8)
    n = 7 if case == "seven" else 40
    docs = [_rate(rng, k, timed=case == "event_time") for k in range(n)]
    if case == "tags":
        docs = [dict(d, tags=[]) for d in docs]
    if case == "escaped":
        docs[3]["entityId"] = 'nu"quoted"'
    if case == "long_number":
        docs[5]["properties"]["rating"] = float(np.float32(0.1))
    status, body = call(srv.test_port, "POST",
                        "/batch/events.json?accessKey=testkey", docs)
    assert status == 200 and [b["status"] for b in body] == [201] * n
    # the native parse of fewer than 8 events is not used (the doc gate's
    # floor too): such a batch goes per event
    took = ("native" if "native" in taken and n >= 8
            else "doc" if "doc" in taken else "generic")
    assert took == leg, taken
    stored = {(e.entity_id, e.target_entity_id, e.properties.get("rating"))
              for e in Storage.get_events().find(app_id=app_id)}
    assert stored == {(d["entityId"], d["targetEntityId"],
                       d["properties"]["rating"]) for d in docs}


def test_missing_native_library_is_an_error(port_server, monkeypatch):
    """A native library that cannot be built raises: the batch fails with
    500, and is not parsed by ``json.loads`` in its place."""
    srv, app_id = port_server

    def no_library():
        raise RuntimeError("native build failed: no compiler")

    monkeypatch.setattr(native, "load", no_library)
    with pytest.raises(RuntimeError, match="no compiler"):
        tbase.uniform_interactions_from_body(b"[]", 50)
    rng = np.random.default_rng(9)
    status, _ = call(srv.test_port, "POST",
                     "/batch/events.json?accessKey=testkey",
                     [_rate(rng, k, timed=False) for k in range(10)])
    assert status == 500
    assert list(Storage.get_events().find(app_id=app_id)) == []


# -- the native body parser against the JAX package's -------------------------

def _parse_both(body: bytes, max_n: int = 50):
    return (tbase.uniform_interactions_from_body(body, max_n),
            jbase.uniform_interactions_from_body(body, max_n))


def _same_bundle(a, b) -> None:
    ai, *ascal = a
    bi, *bscal = b
    assert ascal == bscal
    assert np.array_equal(ai.user_idx, bi.user_idx)
    assert np.array_equal(ai.item_idx, bi.item_idx)
    assert np.array_equal(ai.values, bi.values)
    assert ai.values.dtype == bi.values.dtype == np.float32
    assert list(ai.user_ids) == list(bi.user_ids)
    assert list(ai.item_ids) == list(bi.item_ids)


def _check_body(body: bytes, max_n: int = 50) -> bool:
    """Both packages' parsers agree; where the port's accepts, its doc
    gate accepts the same with identical output. True when accepted."""
    got, ref = _parse_both(body, max_n)
    assert (got is None) == (ref is None), body
    if got is None:
        return False
    _same_bundle(got, ref)
    docs = json.loads(body)
    _same_bundle(got, tbase.uniform_interactions_from_docs(docs))
    return True


def test_native_parser_fixed_cases():
    base_doc = {"event": "rate", "entityType": "user", "entityId": "u1",
                "targetEntityType": "item", "targetEntityId": "i1",
                "properties": {"rating": 1.0}}
    plain = [dict(base_doc, entityId=f"u{k % 5}", targetEntityId=f"i{k}",
                  properties={"rating": float(1 + k % 5)}) for k in range(20)]
    assert _check_body(json.dumps(plain).encode())
    forms = [dict(base_doc, entityId="usér-ñ", properties={"rating": 2}),
             dict(base_doc, entityId="u2", properties={"rating": 2.5e2})]
    assert _check_body(json.dumps(forms, ensure_ascii=False).encode())
    assert not _check_body(json.dumps(plain).encode(), max_n=19)
    declined = [
        [dict(base_doc, eventTime="2026-01-01T00:00:00.000Z")],
        [dict(base_doc, entityId='a"b')],
        [dict(base_doc, extra=1)],
        [dict(base_doc, event="$set")],
        [dict(base_doc, properties={"r": 0.1})],
        [dict(base_doc, properties={"r": True})],
        [dict(base_doc, properties={})],
        [dict(base_doc, entityId="")],
        [dict(base_doc, entityId="x" * 201)],
        "not-a-list",
        [],
    ]
    for case in declined:
        assert not _check_body(json.dumps(case).encode()), case
    for bad in (b"\xff\xfe", b"\xc0\xaf", b"\xed\xa0\x80"):
        body = (b'[{"event": "rate", "entityType": "user", "entityId": "u'
                + bad + b'", "targetEntityType": "item", '
                b'"targetEntityId": "i1", "properties": {"rating": 1.0}}]')
        assert _parse_both(body) == (None, None)


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_native_parser_random_differential(seed):
    """The JAX package's randomized differential, against its parser."""
    rng = np.random.default_rng(seed)
    keys = ["event", "entityType", "entityId", "targetEntityType",
            "targetEntityId", "properties", "eventTime", "bogus"]
    accepted = 0
    for _trial in range(300):
        docs = []
        for _ in range(int(rng.integers(1, 12))):
            d = {"event": "rate", "entityType": "user",
                 "entityId": f"u{int(rng.integers(0, 6))}",
                 "targetEntityType": "item",
                 "targetEntityId": f"i{int(rng.integers(0, 6))}",
                 "properties": {"rating": float(int(rng.integers(1, 6)))}}
            for _m in range(int(rng.integers(0, 3))):
                k = keys[int(rng.integers(0, len(keys)))]
                roll = rng.random()
                if roll < 0.3 and k in d:
                    del d[k]
                elif roll < 0.6:
                    d[k] = ["x", 1, None][int(rng.integers(0, 3))]
                elif k == "properties":
                    d[k] = {"rating": float(rng.normal())}
                else:
                    d[k] = f"v{int(rng.integers(0, 4))}"
            docs.append(d)
        accepted += _check_body(json.dumps(docs).encode())
    assert accepted >= 10  # the accept leg is exercised
