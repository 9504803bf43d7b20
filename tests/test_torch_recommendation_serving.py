"""The port's recommendation serving slice (PyTorch, on the CPU) against the
JAX package's, on one planted model carried across from numpy.

Both packages get the same factors (300 users x 500 items x rank 16): the
JAX ``ALSModel`` through ``ALSAlgorithm.prepare_model``, the port's through
``convert.als_model_from_numpy``. Each query kind is compared through
``predict``, ``batch_predict``, ``batch_serve_json`` and an HTTP POST to the
port's ``PredictionServer``. Items agree exactly (planted Gaussian factors
have no near-ties); scores to rtol 1e-5 / atol 1e-6, since the two sides
sum the rank in different orders.
"""

import json
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
                            + [b"[broken"])
    assert isinstance(out[-1], ValueError)
    ref = dict(jalgo.batch_predict(
        jmodel, [(i, _jq(d)) for i, d in enumerate(docs)]))
    for i, res in enumerate(out[:-1]):
        got = json.loads(res) if isinstance(res, bytes) else res
        _assert_result(got, jcodec.to_jsonable(ref[i]))
    assert isinstance(out[0], bytes)  # "plain" rode the fast path
    assert kernels.SCORE_TOPK_LAUNCHES.value == 0  # CPU: no kernel


def test_train_is_not_ported(pair):
    _, _, talgo, _, _ = pair
    with pytest.raises(NotImplementedError):
        talgo.train(RuntimeContext(device="cpu"), None)
