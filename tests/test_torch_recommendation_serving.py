"""The port's recommendation serving slice (PyTorch, on the CPU) against the
JAX package's, on one planted model carried across from numpy.

Both packages get the same factors (300 users x 500 items x rank 16): the
JAX ``ALSModel`` through ``ALSAlgorithm.prepare_model``, the port's through
``convert.als_model_from_numpy``. Each query kind is compared through
``predict``, ``batch_predict``, ``batch_serve_json`` and an HTTP POST to the
port's ``PredictionServer``. Items agree exactly (planted Gaussian factors
have no near-ties); scores to rtol 1e-5 / atol 1e-6, since the two sides
sum the rank in different orders.

Concurrent POSTs go through the server's scheduler
(``serving/scheduler.py``). Their fusing is made deterministic without
wall-clock timing: the first dispatch waits on an event until the other
queries have queued, then the batches walk up the pow2 ladder. Each
client gets its own answer, the JAX package's for its query; a malformed
body in a fused batch gets a 400 alone; a shed is a 503 with
``Retry-After`` and ``X-PIO-Queue-Depth``; ``micro_batch=0`` serves one
query a call; ``GET /metrics`` exposes the serving families.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap
from incubator_predictionio_tpu.models.recommendation import engine as jeng
from incubator_predictionio_tpu.parallel.context import (
    RuntimeContext as JContext,
)
from incubator_predictionio_tpu.utils import json_codec as jcodec
from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.models.recommendation import (
    engine as teng,
)
from incubator_predictionio_tpu_torch.models.recommendation.convert import (
    als_model_from_numpy,
)
from incubator_predictionio_tpu_torch.ops import kernels
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.servers.prediction_server import (
    PredictionServer,
    ServerConfig,
)
from incubator_predictionio_tpu_torch.utils import json_codec as tcodec
from incubator_predictionio_tpu_torch.utils.planted import (
    planted_item_factors,
    planted_queries,
)

N_USERS, N_ITEMS, RANK = 300, 500, 16
RTOL, ATOL = 1e-5, 1e-6

QUERIES = {
    "plain": {"user": "u5", "num": 10},
    "exclude_seen": {"user": "u7", "num": 12, "excludeSeen": True},
    "blacklist": {"user": "u9", "num": 8,
                  "blacklist": ["i1", "i2", "i3", "nosuch"]},
    "whitelist": {"user": "u11", "num": 5,
                  "whitelist": ["i10", "i20", "i30", "i40", "i50", "i60"]},
    "categories": {"user": "u13", "num": 9, "categories": ["c1", "c3"]},
    "creation_year": {"user": "u15", "num": 6, "creationYear": 2005},
    "unknown_user": {"user": "nosuch", "num": 10},
    "num_zero": {"user": "u17", "num": 0},
}


def _planted():
    rng = np.random.default_rng(7)
    items = planted_item_factors(N_ITEMS, RANK, seed=7)
    users = planted_queries(items, N_USERS, seed=8)
    user_ids = [f"u{i}" for i in range(N_USERS)]
    item_ids = [f"i{i}" for i in range(N_ITEMS)]
    years = {f"i{i}": int(y) for i, y in
             enumerate(rng.integers(1990, 2020, N_ITEMS)) if i % 4}
    cats = {f"i{i}": (f"c{i % 5}",) for i in range(N_ITEMS) if i % 3}
    seen = {u: np.sort(rng.choice(N_ITEMS, 40, replace=False)).astype(
        np.int32) for u in range(0, N_USERS, 2) if u != 8}
    seen[7] = np.sort(np.argsort(-(items @ users[7]))[:6]).astype(np.int32)
    return users, items, user_ids, item_ids, years, cats, seen


@pytest.fixture(scope="module")
def pair():
    users, items, user_ids, item_ids, years, cats, seen = _planted()
    jalgo = jeng.ALSAlgorithm(jeng.ALSAlgorithmParams(rank=RANK))
    jmodel = jalgo.prepare_model(JContext(), jeng.ALSModel(
        user_factors=users, item_factors=items,
        user_bimap=JBiMap({u: i for i, u in enumerate(user_ids)}),
        item_bimap=JBiMap({t: i for i, t in enumerate(item_ids)}),
        item_years=years, item_categories=cats, user_seen=seen))
    raw = als_model_from_numpy(users, items, user_ids, item_ids,
                               item_years=years, item_categories=cats,
                               user_seen=seen, device="cpu")
    talgo = teng.ALSAlgorithm(teng.ALSAlgorithmParams(rank=RANK))
    tmodel = talgo.prepare_model(RuntimeContext(device="cpu"), raw)
    return jalgo, jmodel, talgo, tmodel, raw


def _assert_result(got, ref):
    """Two jsonable {"itemScores": [...]} results agree."""
    g, r = got["itemScores"], ref["itemScores"]
    assert [x["item"] for x in g] == [x["item"] for x in r]
    assert [x["creationYear"] for x in g] == [x["creationYear"] for x in r]
    np.testing.assert_allclose([x["score"] for x in g],
                               [x["score"] for x in r], rtol=RTOL, atol=ATOL)


def _jq(doc):
    return jcodec.extract(jeng.Query, doc)


def _tq(doc):
    return tcodec.extract(teng.Query, doc)


@pytest.mark.parametrize("kind", sorted(QUERIES))
def test_predict_matches_jax(pair, kind):
    jalgo, jmodel, talgo, tmodel, _ = pair
    doc = QUERIES[kind]
    ref = jcodec.to_jsonable(jalgo.predict(jmodel, _jq(doc)))
    got = tcodec.to_jsonable(talgo.predict(tmodel, _tq(doc)))
    _assert_result(got, ref)
    if kind not in ("unknown_user", "num_zero"):
        assert got["itemScores"], "the case must serve something"


def test_filters_hold(pair):
    _, _, talgo, tmodel, _ = pair
    got = talgo.predict(tmodel, _tq(QUERIES["exclude_seen"]))
    seen = {f"i{i}" for i in tmodel.user_seen[7]}
    assert len(got.item_scores) == 12
    assert not seen & {s.item for s in got.item_scores}
    got = talgo.predict(tmodel, _tq(QUERIES["whitelist"]))
    assert {s.item for s in got.item_scores} <= set(
        QUERIES["whitelist"]["whitelist"])
    got = talgo.predict(tmodel, _tq(QUERIES["creation_year"]))
    assert all(s.creation_year >= 2005 for s in got.item_scores)


def test_batch_predict_matches_jax(pair):
    jalgo, jmodel, talgo, tmodel, _ = pair
    docs = list(QUERIES.values()) + [{"user": f"u{i}", "num": 4 + i % 7}
                                     for i in range(20, 40)]
    ref = dict(jalgo.batch_predict(
        jmodel, [(i, _jq(d)) for i, d in enumerate(docs)]))
    got = dict(talgo.batch_predict(
        tmodel, [(i, _tq(d)) for i, d in enumerate(docs)]))
    assert sorted(got) == sorted(ref) == list(range(len(docs)))
    for i in range(len(docs)):
        _assert_result(tcodec.to_jsonable(got[i]),
                       jcodec.to_jsonable(ref[i]))


def test_batch_serve_json_matches_jax_and_object_path(pair):
    jalgo, jmodel, talgo, tmodel, _ = pair
    docs = list(QUERIES.values()) + [{"user": f"u{i}", "num": 3 + i % 5}
                                     for i in range(50, 60)]
    ref = jalgo.batch_serve_json(jmodel, docs)
    got = talgo.batch_serve_json(tmodel, docs)
    assert [g is None for g in got] == [r is None for r in ref]
    fast = [(i, d) for i, d in enumerate(docs) if got[i] is not None]
    assert len(fast) == 11  # "plain" and the ten extra docs
    objs = dict(talgo.batch_predict(
        tmodel, [(i, _tq(d)) for i, d in fast]))
    for i, _d in fast:
        _assert_result(json.loads(got[i]), json.loads(ref[i]))
        # byte identity with the object path of the same batch
        assert got[i] == json.dumps(tcodec.to_jsonable(objs[i])).encode()


@pytest.fixture(scope="module")
def server(pair):
    *_, raw = pair
    srv = PredictionServer(
        teng.RecommendationEngine().apply(),
        EngineParams(algorithm_params_list=[
            ("als", teng.ALSAlgorithmParams(rank=RANK))]),
        [raw], device="cpu")
    port = srv.start_background()
    yield srv, port
    srv.stop()


def _post(port, body: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json", data=body, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("kind", sorted(QUERIES))
def test_http_query_matches_jax(pair, server, kind):
    jalgo, jmodel, *_ = pair
    _, port = server
    status, got = _post(port, json.dumps(QUERIES[kind]).encode())
    assert status == 200
    _assert_result(got, jcodec.to_jsonable(
        jalgo.predict(jmodel, _jq(QUERIES[kind]))))


def test_http_status_and_malformed(server):
    srv, port = server
    for body in (b"{not json", b'{"num": 3}', b'{"user": "u1", "num": "x"}'):
        status, got = _post(port, body)
        assert status == 400 and "message" in got
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                timeout=30) as resp:
        info = json.loads(resp.read())
    assert info["status"] == "alive" and info["device"] == "cpu"
    assert info["algorithms"] == ["ALSAlgorithm"]
    assert info["requestCount"] >= 3


def test_handle_batch_mixes_fast_and_object_paths(pair, server):
    jalgo, jmodel, *_ = pair
    srv, _ = server
    docs = list(QUERIES.values())
    runtime.reset_launch_counts()
    out = srv._handle_batch([json.dumps(d).encode() for d in docs]
                            + [b"[broken"], "default", "default")
    assert isinstance(out[-1], ValueError)
    ref = dict(jalgo.batch_predict(
        jmodel, [(i, _jq(d)) for i, d in enumerate(docs)]))
    for i, res in enumerate(out[:-1]):
        got = json.loads(res) if isinstance(res, bytes) else res
        _assert_result(got, jcodec.to_jsonable(ref[i]))
    assert isinstance(out[0], bytes)  # "plain" rode the fast path
    assert kernels.SCORE_TOPK_LAUNCHES.value == 0  # CPU: no kernel


def test_template_data_source_waits_for_storage(tmp_path, monkeypatch):
    """The template's own data source reads the event store: training
    through the factory's engine reads rate and buy events and the items'
    ``$set`` properties of the app, and an unknown app raises at the read."""
    from incubator_predictionio_tpu_torch.data.datamap import DataMap
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.storage import App, Storage
    from incubator_predictionio_tpu_torch.data.store import EventStoreError

    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    Storage.reset()
    try:
        app_id = Storage.get_meta_data_apps().insert(App(0, "shop"))
        Storage.get_events().init(app_id)
        events = [Event(event="rate", entity_type="user", entity_id=u,
                        target_entity_type="item", target_entity_id=i,
                        properties=DataMap({"rating": r}))
                  for u, i, r in (("u1", "i1", 4.0), ("u2", "i2", 3.0),
                                  ("u1", "i2", 5.0), ("u3", "i1", 2.0))]
        events.append(Event(event="buy", entity_type="user", entity_id="u2",
                            target_entity_type="item", target_entity_id="i3"))
        events.append(Event(event="$set", entity_type="item", entity_id="i3",
                            properties=DataMap({"creationYear": 1999,
                                                "categories": ["c1"]})))
        Storage.get_events().insert_batch(events, app_id)
        engine = teng.RecommendationEngine().apply()
        algo = ("als", teng.ALSAlgorithmParams(rank=2, num_iterations=2,
                                               seed=1))
        [model] = engine.train(RuntimeContext(device="cpu"), EngineParams(
            data_source_params=("", teng.DataSourceParams(app_name="shop")),
            algorithm_params_list=[algo]))
        assert dict(model.user_bimap.items()) == {"u1": 0, "u2": 1, "u3": 2}
        assert dict(model.item_bimap.items()) == {"i1": 0, "i2": 1, "i3": 2}
        assert model.item_years == {"i3": 1999}
        assert model.item_categories == {"i3": ("c1",)}
        assert model.user_seen[1].tolist() == [1, 2]   # u2: a rate, a buy
        with pytest.raises(EventStoreError, match="nosuch"):
            engine.train(RuntimeContext(device="cpu"), EngineParams(
                data_source_params=("", teng.DataSourceParams(
                    app_name="nosuch")),
                algorithm_params_list=[algo]))
    finally:
        Storage.reset()


# -- the scheduler in front of _handle_batch --------------------------------

def _post_full(port, body: bytes, timeout=60):
    """(status, headers, json body) of one POST /queries.json."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json", data=body, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


class _Gate:
    """Stands in for the scheduler's handler: the first dispatch waits on
    an event while the script queues the rest, then every dispatch goes
    to the server's own ``_handle_batch``; each batch's width is kept."""

    def __init__(self, srv):
        self.srv = srv
        self.first_in = threading.Event()
        self.open = threading.Event()
        self.widths = []

    def __call__(self, bodies, engine, tenant):
        self.first_in.set()
        self.open.wait(30)
        self.widths.append(len(bodies))
        return self.srv._handle_batch(bodies, engine, tenant)


def _gated_server(pair, **config):
    *_, raw = pair
    srv = PredictionServer(
        teng.RecommendationEngine().apply(),
        EngineParams(algorithm_params_list=[
            ("als", teng.ALSAlgorithmParams(rank=RANK))]),
        [raw], device="cpu",
        config=ServerConfig(ip="127.0.0.1", port=0, **config))
    port = srv.start_background()
    gate = _Gate(srv)
    if srv._batcher is not None:
        srv._batcher._handle_batch = gate
    return srv, port, gate


def _wait_depth(srv, n):
    deadline = time.monotonic() + 30
    while srv._batcher.depth() < n:
        assert time.monotonic() < deadline, "queries did not queue"
        time.sleep(0.005)


def _fire(port, bodies):
    """POST every body on a thread of its own; returns (threads, out)."""
    out = [None] * len(bodies)

    def one(i):
        out[i] = _post_full(port, bodies[i])

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    return threads, out


@pytest.fixture
def quiet_shed(monkeypatch):
    """The shed off: a gated dispatch is slow by construction."""
    monkeypatch.setenv("PIO_SERVE_SHED", "0")


def test_concurrent_queries_fuse_and_match_jax(pair, quiet_shed):
    """One query holds the dispatcher while fifteen more queue; once the
    gate opens they drain up the pow2 ladder (1, 1, 2, 4, 8), and every
    client gets its own answer, the JAX package's for its query."""
    jalgo, jmodel, *_ = pair
    srv, port, gate = _gated_server(pair)
    try:
        docs = [{"user": f"u{i}", "num": 3 + i % 5} for i in range(40, 56)]
        docs[5] = QUERIES["blacklist"]      # an object-path query
        first, out0 = _fire(port, [json.dumps(docs[0]).encode()])
        assert gate.first_in.wait(30)
        rest, out = _fire(port, [json.dumps(d).encode() for d in docs[1:]])
        _wait_depth(srv, len(docs) - 1)
        gate.open.set()
        for t in first + rest:
            t.join(60)
        assert gate.widths == [1, 1, 2, 4, 8]
        for doc, (status, headers, body) in zip(docs, out0 + out):
            assert status == 200 and "X-PIO-Queue-Depth" in headers
            _assert_result(body, jcodec.to_jsonable(
                jalgo.predict(jmodel, _jq(doc))))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=30) as resp:
            info = json.loads(resp.read())
        assert info["maxBatchServed"] == 8
        assert info["scheduler"]["cap"] == 512
        assert info["scheduler"]["engines"]["default"]["depth"] == 0
        assert info["tenants"] is None
    finally:
        gate.open.set()
        srv.stop()


def test_malformed_body_in_a_fused_batch_fails_alone(pair, quiet_shed):
    jalgo, jmodel, *_ = pair
    srv, port, gate = _gated_server(pair)
    try:
        bodies = [json.dumps({"user": f"u{i}", "num": 4}).encode()
                  for i in range(60, 67)]
        bodies[3] = b"{not json"
        bodies[5] = b'{"user": "u1", "num": "x"}'
        first, out0 = _fire(port, [bodies[0]])
        assert gate.first_in.wait(30)
        rest, out = _fire(port, bodies[1:])
        _wait_depth(srv, len(bodies) - 1)
        gate.open.set()
        for t in first + rest:
            t.join(60)
        assert max(gate.widths) > 1
        for i, (status, _h, body) in enumerate(out0 + out):
            if i in (3, 5):
                assert status == 400 and "message" in body
            else:
                assert status == 200
                _assert_result(body, jcodec.to_jsonable(jalgo.predict(
                    jmodel, _jq(json.loads(bodies[i])))))
    finally:
        gate.open.set()
        srv.stop()


def test_shed_is_503_with_retry_after_and_queue_depth(pair, monkeypatch):
    """With the serve_p99 objective below any wall, an arrival that finds
    a query queued behind an in-flight dispatch is shed: 503, Retry-After
    and the queue's depth; the queued ones are answered, and a query
    after the load is admitted."""
    from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics

    monkeypatch.setenv("PIO_SLO_SERVE_P99_S", "0.000001")
    monkeypatch.setenv("PIO_SERVE_SHED", "1")
    srv, port, gate = _gated_server(pair)
    shed = obs_metrics.REGISTRY.get("pio_serve_shed_total")
    try:
        gate.open.set()
        assert _post_full(port, b'{"user": "u1", "num": 2}')[0] == 200
        gate.open.clear()
        gate.first_in.clear()
        first, out0 = _fire(port, [b'{"user": "u2", "num": 2}'])
        assert gate.first_in.wait(30)
        second, out1 = _fire(port, [b'{"user": "u3", "num": 2}'])
        _wait_depth(srv, 1)
        before = shed.labels(tenant="default", reason="overload").value
        status, headers, body = _post_full(port, b'{"user": "u4", "num": 2}')
        assert status == 503 and int(headers["Retry-After"]) >= 1
        assert headers["X-PIO-Queue-Depth"] == "1"
        assert "overloaded" in body["message"]
        assert shed.labels(tenant="default",
                           reason="overload").value == before + 1
        gate.open.set()
        for t in first + second:
            t.join(60)
        assert [o[0] for o in out0 + out1] == [200, 200]
        assert _post_full(port, b'{"user": "u5", "num": 2}')[0] == 200
    finally:
        gate.open.set()
        srv.stop()


def test_micro_batch_zero_serves_one_query_a_call(pair):
    jalgo, jmodel, *_ = pair
    srv, port, _gate = _gated_server(pair, micro_batch=0)
    try:
        assert srv._batcher is None
        threads, out = _fire(port, [json.dumps(QUERIES[k]).encode()
                                    for k in sorted(QUERIES)])
        for t in threads:
            t.join(60)
        for k, (status, headers, body) in zip(sorted(QUERIES), out):
            assert status == 200 and "X-PIO-Queue-Depth" not in headers
            _assert_result(body, jcodec.to_jsonable(
                jalgo.predict(jmodel, _jq(QUERIES[k]))))
        assert _post_full(port, b"[broken")[0] == 400
        info = srv.status()
        assert info["maxBatchServed"] == 1 and info["scheduler"] is None
    finally:
        srv.stop()


def test_metrics_route_exposes_the_serving_families(server):
    srv, port = server
    assert _post(port, b'{"user": "u8", "num": 3}')[0] == 200
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        text = resp.read().decode()
        ctype = resp.headers["Content-Type"]
    assert ctype.startswith("text/plain")
    for family in ('pio_query_latency_seconds_bucket{tenant="default"',
                   "pio_serve_batch_size_bucket",
                   "pio_serve_queue_wait_seconds_bucket",
                   'pio_serve_queue_depth{tenant="default"} 0',
                   "pio_serve_compile_cache_size",
                   'pio_http_requests_total{server="prediction"'):
        assert family in text, family
    info = srv.status()
    assert info["servingSecP99"] > 0 and info["scheduler"]["cap"] == 512
