"""The port's feedback loop and query-error shipping
(``servers/prediction_server.py``: ``_feedback``, ``_remote_log``,
``_AsyncPoster``, ``_post_with_retries``) on the CPU, against the JAX
package's.

The stack: a memory store, the port's recommendation engine trained on
seeded ratings, the port's ``EventServer`` and the port's
``PredictionServer`` (``device="cpu"``) deployed with ``feedback=True``
and the event server's address and key, as ``pio deploy --feedback``
builds it. Twins of ``tests/test_prediction_server.py``'s
``test_feedback_event_reaches_event_server`` and
``test_log_url_ships_query_errors``; the predict event's body equals the
one the JAX package's ``_feedback`` builds on the same query and
prediction, field for field but ``eventTime`` and a generated ``prId``;
the rendered-bytes fast path is off under feedback; a full poster drops
and counts without blocking; both packages' ``_post_with_retries`` retry
a 503 after its ``Retry-After`` and try a 400 once; and a ``pio_pr``
event moves neither the speed overlay nor the recommendation data
source's read.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from incubator_predictionio_tpu.servers import prediction_server as jps
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Storage,
)
from incubator_predictionio_tpu_torch.data.store import EventStore
from incubator_predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithmParams,
    DataSourceParams,
    RecommendationDataSource,
    RecommendationEngine,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.servers import prediction_server as tps
from incubator_predictionio_tpu_torch.servers.event_server import (
    EventServer,
    EventServerConfig,
)
from incubator_predictionio_tpu_torch.utils.http import (
    HttpServer,
    Request,
    Response,
    Router,
)
from incubator_predictionio_tpu_torch.workflow.workflow import CoreWorkflow

MEM_CONF = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
APP = "fb-app"
KEY = "fbkey"


def call(port, method, path, body=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _predict_events(es_port, want=1, timeout=10.0):
    """The app's ``predict`` events read back through the event server,
    once ``want`` of them arrived (or the timeout passed)."""
    deadline = time.time() + timeout
    found = []
    while time.time() < deadline:
        status, got = call(es_port, "GET",
                           f"/events.json?accessKey={KEY}&event=predict")
        found = got if status == 200 else []
        if len(found) >= want:
            break
        time.sleep(0.05)
    return found


@pytest.fixture
def stack(monkeypatch):
    """A memory store with seeded ratings, the recommendation engine
    trained on it, an event server and a prediction server with the
    feedback loop on (its overlay polled by hand)."""
    monkeypatch.setenv("PIO_SPEED_POLL_S", "3600")
    monkeypatch.setenv("PIO_RETRAIN_CONTINUE", "0")
    Storage.configure(dict(MEM_CONF))
    app_id = Storage.get_meta_data_apps().insert(App(0, APP))
    Storage.get_meta_data_access_keys().insert(AccessKey(KEY, app_id))
    rng = np.random.default_rng(11)
    EventStore.write([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{int(i)}",
              properties=DataMap({"rating": float(rng.integers(1, 6))}))
        for u in range(10) for i in rng.choice(16, 5, replace=False)], APP)
    engine = RecommendationEngine().apply()
    ep = EngineParams(
        data_source_params=("", DataSourceParams(app_name=APP)),
        algorithm_params_list=[("als", ALSAlgorithmParams(
            rank=4, num_iterations=4, lambda_=0.05, seed=3))])
    CoreWorkflow.run_train(engine, ep, engine_variant="served", device="cpu")
    es = EventServer(EventServerConfig(ip="127.0.0.1", port=0))
    es_port = es.start_background()
    ps = tps.PredictionServer(engine, device="cpu", config=tps.ServerConfig(
        ip="127.0.0.1", port=0, engine_variant="served",
        event_server_ip="127.0.0.1", event_server_port=es_port,
        access_key=KEY, feedback=True, server_key="sekrit"))
    ps_port = ps.start_background()
    yield types.SimpleNamespace(ps=ps, port=ps_port, es=es, es_port=es_port,
                                ep=ep)
    ps.stop()
    es.stop()
    Storage.reset()


def test_feedback_event_reaches_event_server(stack):
    """Twin of tests/test_prediction_server.py:119: the served answer
    comes back from the event server as a ``predict`` event of entityType
    ``pio_pr`` with the query, the prediction and the instance id."""
    status, answer = call(stack.port, "POST", "/queries.json",
                          {"user": "u3", "num": 4})
    assert status == 200 and len(answer["itemScores"]) == 4
    found = _predict_events(stack.es_port)
    assert found, "feedback predict event never arrived"
    ev = found[0]
    assert ev["entityType"] == "pio_pr"
    assert len(ev["entityId"]) == 64  # secrets.token_hex(32)
    assert ev["properties"]["query"] == {"user": "u3", "num": 4}
    assert ev["properties"]["prediction"] == answer
    assert ev["properties"]["engineInstanceId"] == \
        stack.ps.engine_instance.id
    assert call(stack.port, "GET", "/")[1]["feedbackEventsDropped"] == 0


def test_log_url_ships_query_errors(stack):
    """Twin of tests/test_prediction_server.py:399: a query error POSTs
    to ``log_url`` behind ``log_prefix`` with the engine instance and a
    stack trace; an answered query ships nothing."""
    ps = stack.ps
    received = []
    got_one = threading.Event()
    r = Router()

    @r.post("/collect")
    def collect(request: Request) -> Response:
        received.append(request.body.decode())
        got_one.set()
        return Response(200, {})

    collector = HttpServer(r, "127.0.0.1", 0)
    cport = collector.start_background()
    ps.config.log_url = f"http://127.0.0.1:{cport}/collect"
    ps.config.log_prefix = "PIOLOG "
    try:
        assert call(stack.port, "POST", "/queries.json",
                    {"user": "u1", "num": 2})[0] == 200
        status, _ = call(stack.port, "POST", "/queries.json", {"bogus": 1})
        assert status == 400
        assert got_one.wait(10), "no remote log arrived"
        time.sleep(0.2)  # a second line would have landed by now
        assert len(received) == 1
        assert received[0].startswith("PIOLOG ")
        doc = json.loads(received[0][len("PIOLOG "):])
        assert doc["engineInstance"] == {
            "id": ps.engine_instance.id,
            "engineId": ps.engine_instance.engine_id,
            "engineVariant": "served"}
        assert "Stack Trace" in doc["message"]
        assert "bogus" in doc["message"]
    finally:
        ps.config.log_url = None
        collector.stop()


def _built_events(monkeypatch, query, prediction):
    """(url, event) that the JAX package's ``_feedback`` and the port's
    post for one query and prediction from servers of the same config,
    their posters stubbed to run a post at once and their
    ``_post_with_retries`` to record it; and each side's answer."""
    instance = types.SimpleNamespace(id="inst-1")
    out = {}
    for name, mod in (("jax", jps), ("port", tps)):
        posts = []
        monkeypatch.setattr(
            mod, "_post_with_retries",
            lambda url, payload, headers, what, expect_status=None:
            posts.append((url, json.loads(payload), expect_status)))
        srv = mod.PredictionServer.__new__(mod.PredictionServer)
        srv.config = mod.ServerConfig(
            event_server_ip="10.0.0.7", event_server_port=7171,
            access_key="k-1", feedback=True)
        srv._feedback_poster = types.SimpleNamespace(
            submit=lambda fn, what: fn())
        answer = srv._feedback(instance, query, prediction)
        ((url, event, expect),) = posts
        out[name] = (url, event, expect, answer)
    return out


@pytest.mark.parametrize("case", ["plain", "prediction-prId",
                                  "query-prId", "non-dict"])
def test_predict_event_equals_the_jax_packages(monkeypatch, case):
    rng = np.random.default_rng(21)
    scores = [{"item": f"i{int(i)}", "score": float(s)}
              for i, s in zip(rng.integers(0, 99, 5), rng.standard_normal(5))]
    query = {"user": "u7", "num": 5}
    prediction = {"itemScores": scores}
    if case == "prediction-prId":
        prediction["prId"] = "pr-from-prediction"
    elif case == "query-prId":
        query["prId"] = "pr-from-query"
    elif case == "non-dict":
        prediction = [1.0, 2.0]
    out = _built_events(monkeypatch, query, prediction)
    (jurl, jev, jexp, jans), (turl, tev, texp, tans) = \
        out["jax"], out["port"]
    assert turl == jurl == \
        "http://10.0.0.7:7171/events.json?accessKey=k-1"
    assert texp == jexp == 201
    assert tans == jans
    generated = case != "prediction-prId"
    for ev in (jev, tev):
        ev.pop("eventTime")
        if generated:
            assert len(ev.pop("entityId")) == 64
    assert tev == jev
    if case == "prediction-prId":
        assert tev["entityId"] == "pr-from-prediction"
        assert tans["prId"] == "pr-from-prediction"
    if case == "query-prId":
        assert tev["prId"] == "pr-from-query"
        assert "prId" not in tans  # injected only when the prediction has one


def test_feedback_turns_the_fast_path_off(stack):
    """The recommendation engine's answers are rendered bytes on the fast
    path; with feedback on they are objects, each posted back."""
    ps = stack.ps
    bodies = [json.dumps({"user": f"u{u}", "num": 3}).encode()
              for u in range(3)]
    with_feedback = ps._handle_batch(bodies, "default", "default")
    assert all(isinstance(a, dict) for a in with_feedback)
    assert len(_predict_events(stack.es_port, want=3)) == 3
    ps.config.feedback = False
    try:
        fast = ps._handle_batch(bodies, "default", "default")
    finally:
        ps.config.feedback = True
    assert all(isinstance(a, bytes) for a in fast)
    assert [json.loads(a) for a in fast] == with_feedback


def test_a_full_poster_drops_counts_and_never_blocks(stack):
    """With the feedback poster's one worker held and its queue full,
    every further answer is served at once, its event dropped and
    counted on ``GET /``; what was queued is posted once the worker is
    free."""
    ps = stack.ps
    ps._feedback_poster.stop()
    poster = tps._AsyncPoster("feedback", workers=1, maxsize=1)
    ps._feedback_poster = poster
    held, release = threading.Event(), threading.Event()
    poster.submit(lambda: (held.set(), release.wait(30)), "hold")
    assert held.wait(10)
    try:
        t0 = time.monotonic()
        for u in range(5):
            status, _ = call(stack.port, "POST", "/queries.json",
                             {"user": f"u{u}", "num": 2})
            assert status == 200
        assert time.monotonic() - t0 < 10
        # the first answer's event waits in the queue; four dropped
        assert poster.dropped == 4
        assert call(stack.port, "GET", "/")[1]["feedbackEventsDropped"] == 4
    finally:
        release.set()
    assert len(_predict_events(stack.es_port, want=1)) == 1


@pytest.mark.parametrize("mod", [jps, tps], ids=["jax", "port"])
def test_a_503_is_retried_after_retry_after_and_a_400_tried_once(mod):
    """Both packages' ``_post_with_retries`` on one receiver: a 503 with
    ``Retry-After: 1`` is posted again no sooner than a second later, a
    400 once; neither raises."""
    hits = {"shed": [], "bad": []}
    r = Router()

    @r.post("/shed")
    def shed(request: Request) -> Response:
        hits["shed"].append(time.monotonic())
        if len(hits["shed"]) == 1:
            return Response(503, {"message": "shed"},
                            headers={"Retry-After": "1"})
        return Response(201, {"eventId": "x"})

    @r.post("/bad")
    def bad(request: Request) -> Response:
        hits["bad"].append(time.monotonic())
        return Response(400, {"message": "bad"})

    srv = HttpServer(r, "127.0.0.1", 0)
    port = srv.start_background()
    try:
        for route in ("shed", "bad"):
            mod._post_with_retries(
                f"http://127.0.0.1:{port}/{route}", b"{}",
                {"Content-Type": "application/json"}, route,
                expect_status=201)
    finally:
        srv.stop()
    assert len(hits["shed"]) == 2
    assert hits["shed"][1] - hits["shed"][0] >= 0.95
    assert len(hits["bad"]) == 1


def test_a_refused_connection_is_retried(monkeypatch):
    """A refused connection never carried the body, so it is retried up
    to the policy's attempts, as in the JAX package."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    counts = {}
    for name, mod in (("jax", jps), ("port", tps)):
        sleeps = []
        real_call = mod._POST_RETRY.call
        monkeypatch.setattr(
            type(mod._POST_RETRY), "call",
            lambda self, fn, **kw: real_call(fn, sleep=sleeps.append))
        mod._post_with_retries(f"http://127.0.0.1:{free}/events.json",
                               b"{}", {}, "feedback event")
        counts[name] = len(sleeps)
        monkeypatch.undo()
    assert counts == {"jax": 2, "port": 2}


def test_a_pio_pr_event_moves_neither_the_overlay_nor_training(stack):
    """The predict events land in the app the overlay tails and ``pio
    train`` reads; both filter by event name (``rate``/``buy``), so a
    ``pio_pr`` event adds no dirty key, folds nothing in and leaves the
    data source's read as it was."""
    ps = stack.ps
    (overlay,) = ps._speed_overlays
    overlay.poll()  # to the tail of the seeded ratings
    ds = RecommendationDataSource(stack.ep.data_source_params[1])
    before = ds.read_training(RuntimeContext(device="cpu"))
    for u in range(4):
        assert call(stack.port, "POST", "/queries.json",
                    {"user": f"u{u}", "num": 3})[0] == 200
    assert len(_predict_events(stack.es_port, want=4)) == 4
    polled = overlay.poll()
    assert polled["solved"] == 0
    assert overlay.stats()["dirty"] == 0 and overlay.stats()["size"] == 0
    after = ds.read_training(RuntimeContext(device="cpu"))
    bi, ai = before.interactions, after.interactions
    assert (bi.user_ids, bi.item_ids) == (ai.user_ids, ai.item_ids)
    for col in ("user_idx", "item_idx", "values"):
        np.testing.assert_array_equal(getattr(ai, col), getattr(bi, col))
