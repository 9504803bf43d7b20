"""The port's similarproduct template (``models/similarproduct/``: the ALS
and DIMSUM algorithms, the recommended-user engine) and
``ops/dimsum.py`` against the JAX package's, on the CPU, each package on
a memory store of its own with the same events:

- tests/test_other_templates.py's similarproduct, DIMSUM,
  ``test_dimsum_matches_numpy_cosine``, recommended-user, wire-format and
  warm-up cases, through both packages;
- training from one initial state (the port's ``als_init`` patched to the
  JAX init): the prepared data equal, the unit-norm item factors and the
  user factors within 1e-3 relative, as the implicit ecommerce twin
  (tests/test_torch_ecommerce.py); ``train_with_previous`` likewise, the
  fresh user rows of both taken from the JAX package's
  ``continue_state``;
- answers on the same (JAX-trained) factors, with and without filters:
  ids equal except among near-ties, scores rtol 1e-4
  (``test_torch_ecommerce.same_answer``; the JAX package serves a
  catalogue this small from its host mirror, the port through the
  score+top-k route);
- ``column_cosine_topk`` equal to JAX's, indices included, on rows with
  fewer neighbours above the threshold than ``top_n`` (zero-score ties);
- the speed overlay's item-side fold-in of both packages on the same
  factors, and the port's ``index_sink`` publish into the MIPS index
  (tests/test_mips.py::test_similarproduct_index_overlay_and_virtual_items);
- a JAX-named ``engineFactory`` resolving to the port, and a JAX-trained
  ``SimilarProductModel`` blob restored and served by the port.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from test_torch_ecommerce import same_answer

CPU = "cpu"
MEM_CONF = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
ALGO = dict(rank=8, num_iterations=10, lambda_=0.05, alpha=2.0, seed=7)
RU_ALGO = dict(rank=8, num_iterations=10, lambda_=0.05, seed=11)


class Pkg:
    def __init__(self, name: str, pkg: str):
        self.name = name

        def mod(path):
            return importlib.import_module(f"{pkg}.{path}")

        self.sp = mod("models.similarproduct.engine")
        self.ru = mod("models.similarproduct.recommended_user")
        self.dimsum = mod("ops.dimsum")
        self.params = mod("core.params")
        self.context = mod("parallel.context")
        self.storage = mod("data.storage")
        self.Event = mod("data.event").Event
        self.DataMap = mod("data.datamap").DataMap
        self.BiMap = mod("data.bimap").BiMap
        self.codec = mod("utils.json_codec")
        self.checkpoint = mod("workflow.checkpoint")
        self.Storage = self.storage.Storage

    def ctx(self):
        return (self.context.RuntimeContext(device=CPU) if self.name == "port"
                else self.context.RuntimeContext())

    def engine_params(self, app, algo="als", **kw):
        if algo == "als":
            ap = self.sp.ALSAlgorithmParams(**{**ALGO, **kw})
        else:
            ap = self.sp.DIMSUMAlgorithmParams(**kw)
        return self.params.EngineParams(
            data_source_params=("", self.sp.DataSourceParams(app_name=app)),
            algorithm_params_list=[(algo, ap)])

    def train(self, app, algo="als", **kw):
        ep = self.engine_params(app, algo, **kw)
        engine = self.sp.SimilarProductEngine().apply()
        [model] = engine.train(self.ctx(), ep)
        algorithm = self.algorithm(ep)
        return algorithm, algorithm.prepare_model(self.ctx(), model)

    def algorithm(self, ep):
        name, ap = ep.algorithm_params_list[0]
        cls = (self.sp.SimilarProductAlgorithm if name == "als"
               else self.sp.DIMSUMAlgorithm)
        return cls(ap)

    def prepared(self, app):
        ctx = self.ctx()
        ds = self.sp.SimilarProductDataSource(
            self.sp.DataSourceParams(app_name=app))
        return self.sp.SimilarProductPreparator().prepare(
            ctx, ds.read_training(ctx))

    def event(self, name, user, item=None, props=None, etype="user",
              ttype="item"):
        return self.Event(
            event=name, entity_type=etype, entity_id=user,
            target_entity_type=ttype if item else None,
            target_entity_id=item, properties=self.DataMap(props or {}))

    def insert(self, app_id, *events):
        for e in events:
            self.Storage.get_events().insert(e, app_id)

    def seed_app(self, name):
        self.Storage.get_meta_data_apps().insert(self.storage.App(0, name))
        return self.Storage.get_meta_data_apps().get_by_name(name).id


JAX = Pkg("jax", "incubator_predictionio_tpu")
PORT = Pkg("port", "incubator_predictionio_tpu_torch")
PKGS = (JAX, PORT)
BOTH = pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)


@pytest.fixture(autouse=True)
def mem_storage():
    for p in PKGS:
        p.Storage.configure(MEM_CONF)
    yield
    for p in PKGS:
        p.Storage.reset()


def seed_views(p, app_id, extra_like=False):
    """tests/test_other_templates.py ``seed_views``: block A's users view
    block A's items, B's B's; block A's items in ``catA``."""
    rng = np.random.default_rng(1)
    for users, items in (
            ([f"uA{i}" for i in range(6)], [f"iA{i}" for i in range(8)]),
            ([f"uB{i}" for i in range(6)], [f"iB{i}" for i in range(8)])):
        for u in users:
            for it in items:
                if rng.random() < 0.6:
                    p.insert(app_id, p.event("view", u, it))
    if extra_like:
        p.insert(app_id, p.event("like", "uA0", "iA1"))
    for i in range(8):
        p.insert(app_id, p.event("$set", f"iA{i}",
                                 props={"categories": ["catA"]},
                                 etype="item"))


def seed_both(name, extra_like=True):
    ids = {}
    for p in PKGS:
        ids[p.name] = p.seed_app(name)
        seed_views(p, ids[p.name], extra_like=extra_like)
    return ids


def seed_follows(p, app_id):
    """tests/test_other_templates.py ``seed_follows``: two communities
    following within themselves, one bridge edge."""
    rng = np.random.default_rng(3)
    for members in ([f"cA{i}" for i in range(7)],
                    [f"cB{i}" for i in range(7)]):
        for u in members:
            for v in members:
                if u != v and rng.random() < 0.7:
                    p.insert(app_id, p.event("follow", u, v, ttype="user"))
    p.insert(app_id, p.event("follow", "cA0", "cB0", ttype="user"))


def _items(r):
    return [s.item for s in r.item_scores]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _jax_init(monkeypatch):
    """The port's ``als_init`` (and ``continue_state``'s fresh rows)
    patched to the JAX package's."""
    import jax

    import incubator_predictionio_tpu.ops.als as jals
    from incubator_predictionio_tpu_torch.ops import als

    def state(st, device):
        return als.ALSState(
            torch.from_numpy(np.array(st.user_factors)).to(device),
            torch.from_numpy(np.array(st.item_factors)).to(device))

    def init(gen, n_users, n_items, rank, device=None, scale=0.1):
        return state(jals.als_init(jax.random.key(int(gen.initial_seed())),
                                   n_users, n_items, rank), device)

    def cont(prev_user, prev_item, n_users, n_items, seed=0, scale=0.1,
             device=None):
        st = jals.continue_state(np.asarray(prev_user),
                                 np.asarray(torch.as_tensor(prev_item)),
                                 n_users, n_items, seed=seed, scale=scale)
        return None if st is None else state(st, device)

    monkeypatch.setattr(als, "als_init", init)
    monkeypatch.setattr(als, "continue_state", cont)


# ---------------------------------------------------------------------------
# tests/test_other_templates.py, through both packages
# ---------------------------------------------------------------------------

@BOTH
def test_similarproduct_template(p):
    app_id = p.seed_app("simapp")
    seed_views(p, app_id, extra_like=True)
    algo, model = p.train("simapp")
    q = p.sp.Query
    r = algo.predict(model, q(items=("iA0",), num=3))
    assert r.item_scores
    assert all(i.startswith("iA") for i in _items(r))
    assert "iA0" not in _items(r)
    assert algo.predict(model, q(items=("nope",), num=3)).item_scores == ()
    r2 = algo.predict(model, q(items=("iA0",), num=4, black_list=("iA1",)))
    assert "iA1" not in _items(r2)
    r3 = algo.predict(model, q(items=("iB0",), num=3, categories=("catA",)))
    assert all(i.startswith("iA") for i in _items(r3))
    r4 = algo.predict(model, q(items=("iA0",), num=5,
                               white_list=("iA2", "iB3", "iA0")))
    assert set(_items(r4)) <= {"iA2", "iB3"}
    assert algo.predict(model, q(items=("iA0",), num=0)).item_scores == ()


@BOTH
def test_similarproduct_dimsum_variant(p):
    app_id = p.seed_app("dimapp")
    seed_views(p, app_id)
    algo, model = p.train("dimapp", algo="dimsum", threshold=0.05, top_n=10)
    q = p.sp.Query
    r = algo.predict(model, q(items=("iA0",), num=3))
    assert r.item_scores and all(i.startswith("iA") for i in _items(r))
    assert "iA0" not in _items(r)
    r2 = algo.predict(model, q(items=("iA0", "iA1"), num=3))
    assert r2.item_scores
    assert {"iA0", "iA1"}.isdisjoint(_items(r2))
    scores = [s.score for s in r2.item_scores]
    assert scores == sorted(scores, reverse=True)
    r3 = algo.predict(model, q(items=("iA0",), num=4, black_list=("iA1",)))
    assert "iA1" not in _items(r3)
    assert algo.predict(model, q(items=("nope",), num=3)).item_scores == ()


def test_dimsum_answers_equal_across_packages():
    seed_both("dimeq", extra_like=False)
    (ja, jm), (ta, tm) = (p.train("dimeq", algo="dimsum", threshold=0.05,
                                  top_n=10) for p in PKGS)
    np.testing.assert_array_equal(tm.sim_indices, jm.sim_indices)
    np.testing.assert_allclose(tm.sim_scores, jm.sim_scores, rtol=1e-5,
                               atol=1e-6)
    for items in (("iA0",), ("iA0", "iB1"), ("iB2", "iB3", "iB4")):
        for kw in ({}, {"black_list": ("iA1", "iB5")},
                   {"categories": ("catA",)}):
            j = ja.predict(jm, JAX.sp.Query(items=items, num=6, **kw))
            t = ta.predict(tm, PORT.sp.Query(items=items, num=6, **kw))
            same_answer(t, j, (items, kw))


@pytest.mark.parametrize("seed", [4, 5])
def test_dimsum_matches_numpy_cosine(seed):
    """ops/dimsum.py gives the exact cosine matrix (what DIMSUM only
    approximates): tests/test_other_templates.py's dense numpy check."""
    rng = np.random.default_rng(seed)
    n_users, n_items, nnz = 40, 12, 200
    users = rng.integers(0, n_users, nnz)
    items = rng.integers(0, n_items, nnz)
    weights = rng.random(nnz).astype(np.float32)
    dense = np.zeros((n_users, n_items), np.float64)
    np.add.at(dense, (users, items), weights)
    gram = dense.T @ dense
    norms = np.sqrt(np.maximum(np.diag(gram), 1e-12))
    ref = gram / np.outer(norms, norms)
    np.fill_diagonal(ref, 0.0)
    ref[ref < 0.2] = 0.0
    scores, indices = PORT.dimsum.column_cosine_topk(
        users, items, weights, n_items=n_items, threshold=0.2,
        top_n=n_items, device=CPU)
    got = np.zeros((n_items, n_items), np.float32)
    for i in range(n_items):
        got[i, indices[i]] = scores[i]
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("shape", [
    # (users, items, nnz, threshold, top_n): sparse rows leave fewer
    # neighbours above the threshold than top_n, so zero-score ties pad
    # them; 5,000 users span three chunks of 2,048
    (40, 12, 60, 0.3, 10),
    (300, 50, 400, 0.1, 20),
    (5000, 64, 6000, 0.05, 64),
], ids=["tiny", "sparse", "three_chunks"])
def test_column_cosine_topk_equals_jax_with_ties(shape):
    n_users, n_items, nnz, threshold, top_n = shape
    rng = np.random.default_rng(n_users)
    users = rng.integers(0, n_users, nnz)
    items = rng.integers(0, n_items, nnz)
    weights = rng.uniform(0.5, 2.0, nnz).astype(np.float32)
    js, ji = JAX.dimsum.column_cosine_topk(users, items, weights, n_items,
                                           threshold=threshold, top_n=top_n)
    ts, ti = PORT.dimsum.column_cosine_topk(users, items, weights, n_items,
                                            threshold=threshold, top_n=top_n,
                                            device=CPU)
    assert ts.shape == js.shape and ti.dtype == np.int32
    assert (np.asarray(js) == 0).any(axis=1).sum() > n_items // 2  # ties
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="16384"):
        PORT.dimsum.column_cosine_topk(users, items, weights,
                                       PORT.dimsum.MAX_ITEMS + 1, device=CPU)


@BOTH
def test_recommended_user_template(p):
    app_id = p.seed_app("social")
    seed_follows(p, app_id)
    engine = p.ru.RecommendedUserEngine().apply()
    ep = p.params.EngineParams(
        data_source_params=("", p.ru.DataSourceParams(app_name="social")),
        algorithm_params_list=[("als", p.ru.ALSAlgorithmParams(**RU_ALGO))])
    [model] = engine.train(p.ctx(), ep)
    algo = p.ru.RecommendedUserAlgorithm(ep.algorithm_params_list[0][1])
    model = algo.prepare_model(p.ctx(), model)
    q = p.ru.Query
    r = algo.predict(model, q(users=("cA1", "cA2"), num=3))
    names = [s.user for s in r.similar_user_scores]
    assert names and all(u.startswith("cA") for u in names)
    assert not {"cA1", "cA2"}.intersection(names)
    scores = [s.score for s in r.similar_user_scores]
    assert all(s > 0 for s in scores) and scores == sorted(scores,
                                                            reverse=True)
    r2 = algo.predict(model, q(users=("cA1",), num=5, black_list=(names[0],)))
    assert names[0] not in {s.user for s in r2.similar_user_scores}
    r3 = algo.predict(model, q(users=("cA1",), num=5,
                               white_list=("cB0", "cB1")))
    assert {s.user for s in r3.similar_user_scores} <= {"cB0", "cB1"}
    assert algo.predict(model, q(users=("ghost",), num=3)) \
        .similar_user_scores == ()


def _ru_trained(p, app):
    engine = p.ru.RecommendedUserEngine().apply()
    ep = p.params.EngineParams(
        data_source_params=("", p.ru.DataSourceParams(app_name=app)),
        algorithm_params_list=[("als", p.ru.ALSAlgorithmParams(**RU_ALGO))])
    [model] = engine.train(p.ctx(), ep)
    algo = p.ru.RecommendedUserAlgorithm(ep.algorithm_params_list[0][1])
    return algo, algo.prepare_model(p.ctx(), model)


def test_recommended_user_matches_jax(monkeypatch):
    """One initial state: the shared index equal, the unit feature rows
    within 1e-3 relative; the port's answers on the JAX features equal
    to JAX's."""
    for p in PKGS:
        seed_follows(p, p.seed_app("soc"))
    _jax_init(monkeypatch)
    (ja, jm), (ta, tm) = (_ru_trained(p, "soc") for p in PKGS)
    assert dict(tm.user_bimap.items()) == dict(jm.user_bimap.items())
    assert _rel(tm.user_features, jm.user_features) < 1e-3
    norms = torch.linalg.norm(tm.user_features, dim=1)
    torch.testing.assert_close(norms, torch.ones_like(norms))
    carried = ta.prepare_model(PORT.ctx(), PORT.ru.RecommendedUserModel(
        user_features=np.asarray(jm.user_features),
        user_bimap=PORT.BiMap(dict(jm.user_bimap.items()))))
    for users, kw in ((("cA1", "cA2"), {}), (("cB3",), {}),
                      (("cA0",), {"black_list": ("cA1", "cB0")}),
                      (("cA1",), {"white_list": ("cB0", "cB1", "cA3")}),
                      (("cA1", "ghost"), {}), (("ghost",), {})):
        j = ja.predict(jm, JAX.ru.Query(users=users, num=5, **kw))
        t = ta.predict(carried, PORT.ru.Query(users=users, num=5, **kw))
        assert [s.user for s in t.similar_user_scores] == \
            [s.user for s in j.similar_user_scores], (users, kw)
        np.testing.assert_allclose(
            [s.score for s in t.similar_user_scores],
            [s.score for s in j.similar_user_scores], rtol=1e-5, atol=1e-6)


@BOTH
def test_recommended_user_wire_format(p):
    q = p.codec.extract(p.ru.Query, {"users": ["u1", "u2"], "num": 5,
                                     "whiteList": ["u3"]})
    assert q.users == ("u1", "u2") and q.white_list == ("u3",)
    out = p.codec.to_jsonable(p.ru.PredictedResult(
        similar_user_scores=(p.ru.SimilarUserScore(user="u9", score=1.5),)))
    assert out == {"similarUserScores": [{"user": "u9", "score": 1.5}]}


@BOTH
def test_similarproduct_wire_format(p):
    q = p.codec.extract(p.sp.Query, {"items": ["i1"], "num": 4,
                                     "categories": ["c"],
                                     "blackList": ["i2"]})
    assert q.items == ("i1",) and q.black_list == ("i2",)
    assert q.categories == ("c",) and q.white_list is None
    out = p.codec.to_jsonable(p.sp.PredictedResult(
        item_scores=(p.sp.ItemScore(item="i9", score=0.5),)))
    assert out == {"itemScores": [{"item": "i9", "score": 0.5}]}
    ds = p.codec.extract(p.sp.DataSourceParams, {
        "appName": "A", "eventWeights": [["view", 1.0], ["like", 3.0]]})
    assert dict(ds.event_weights) == {"view": 1.0, "like": 3.0}


@BOTH
def test_warmup_runs_on_a_trained_model(p):
    app_id = p.seed_app("warmapp")
    seed_views(p, app_id, extra_like=True)
    algo, model = p.train("warmapp", num_iterations=4)
    algo.warmup(model, max_batch=4)


# ---------------------------------------------------------------------------
# against the JAX package: training, continuation, answers
# ---------------------------------------------------------------------------

def test_training_matches_jax_from_one_init(monkeypatch):
    seed_both("eq")
    _jax_init(monkeypatch)
    (_ja, jm), (_ta, tm) = (p.train("eq") for p in PKGS)
    jpd, tpd = (p.prepared("eq") for p in PKGS)
    for f in ("users", "items", "weights"):
        np.testing.assert_array_equal(getattr(tpd, f), getattr(jpd, f))
    assert dict(tm.item_bimap.items()) == dict(jm.item_bimap.items())
    assert dict(tm.user_bimap.items()) == dict(jm.user_bimap.items())
    assert tm.item_categories == jm.item_categories
    assert _rel(tm.item_factors_norm, jm.item_factors_norm) < 1e-3
    assert _rel(tm.user_factors, jm.user_factors) < 1e-3
    norms = torch.linalg.norm(tm.item_factors_norm, dim=1)
    torch.testing.assert_close(norms, torch.ones_like(norms))


def _port_model(jm):
    """The JAX package's trained model as the port's, on the CPU."""
    return PORT.sp.SimilarProductModel(
        item_factors_norm=torch.from_numpy(np.array(jm.item_factors_norm)),
        item_bimap=PORT.BiMap(dict(jm.item_bimap.items())),
        item_categories=dict(jm.item_categories),
        user_factors=torch.from_numpy(np.array(jm.user_factors)),
        user_bimap=PORT.BiMap(dict(jm.user_bimap.items())))


def _sp_queries(p):
    q = p.sp.Query
    return [q(items=("iA0",), num=4), q(items=("iB2", "iB5"), num=6),
            q(items=("iA0", "iB1"), num=16),
            q(items=("iA3",), num=5, categories=("catA",)),
            q(items=("iB0",), num=3, categories=("catA",)),
            q(items=("iA1",), num=5, white_list=("iA2", "iB3", "iA5")),
            q(items=("iB4",), num=4, black_list=("iB5", "iB6")),
            q(items=("nope", "iA2"), num=3), q(items=("nope",), num=3)]


def test_answers_match_jax_on_the_same_factors():
    seed_both("ans")
    ja, jm = JAX.train("ans")
    ep = PORT.engine_params("ans")
    ta = PORT.algorithm(ep)
    tm = ta.prepare_model(PORT.ctx(), _port_model(jm))
    for jq, tq in zip(_sp_queries(JAX), _sp_queries(PORT)):
        everything = dataclasses.replace(jq, num=len(jm.item_bimap))
        same_answer(ta.predict(tm, tq), ja.predict(jm, jq), tq,
                    full=ja.predict(jm, everything))


def test_train_with_previous_matches_jax(monkeypatch):
    """A second train with new events continues from the first in both
    packages, the item side seeded, the unit-norm factors within 1e-3
    relative; another rank, or another item id space, trains fresh."""
    ids = seed_both("cont")
    _jax_init(monkeypatch)
    firsts = {p.name: p.train("cont", num_iterations=4)[1] for p in PKGS}
    for p in PKGS:
        p.insert(ids[p.name], p.event("view", "uA1", "iB7"),
                 p.event("view", "uB2", "iA3"), p.event("view", "uNew", "iA3"),
                 p.event("view", "uNew", "iNew"))
    outs = {}
    for p in PKGS:
        ep = p.engine_params("cont", num_iterations=6)
        pd = p.prepared("cont")
        outs[p.name] = p.algorithm(ep).train_with_previous(
            p.ctx(), pd, firsts[p.name])
    jm, tm = outs["jax"], outs["port"]
    assert len(tm.item_bimap) == len(firsts["port"].item_bimap) + 1
    assert _rel(tm.item_factors_norm, jm.item_factors_norm) < 1e-3
    assert _rel(tm.user_factors, jm.user_factors) < 1e-3
    from incubator_predictionio_tpu_torch.ops import retrain

    seen = {}
    real = retrain.als_retrain
    monkeypatch.setattr(retrain, "als_retrain",
                        lambda *a, **kw: seen.update(kw) or real(*a, **kw))
    pd = PORT.prepared("cont")
    PORT.algorithm(PORT.engine_params("cont", num_iterations=2)) \
        .train_with_previous(PORT.ctx(), pd, firsts["port"])
    assert seen["implicit"] and seen["prev_state"].user_factors.shape == (0, 8)
    assert seen["prev_state"].item_factors is \
        firsts["port"].item_factors_norm
    seen.clear()
    fresh = PORT.algorithm(PORT.engine_params("cont", rank=4,
                                              num_iterations=2)) \
        .train_with_previous(PORT.ctx(), pd, firsts["port"])
    assert fresh.item_factors_norm.shape[1] == 4 and not seen


# ---------------------------------------------------------------------------
# the speed overlay: item-side fold-in, the index_sink publish
# ---------------------------------------------------------------------------

def test_item_side_overlay_matches_jax():
    """Both packages' overlays over the same (JAX-trained) user table:
    equal fold-ins for a brand-new item and a known item with new
    events, unit-norm, and equal answers naming them."""
    ids = seed_both("ov")
    ja, jm = JAX.train("ov")
    ep = PORT.engine_params("ov")
    ta = PORT.algorithm(ep)
    tm = ta.prepare_model(PORT.ctx(), _port_model(jm))
    dsp = {p.name: p.sp.DataSourceParams(app_name="ov") for p in PKGS}
    jov = ja.make_speed_overlay(jm, "ov", None, dsp["jax"])
    tov = ta.make_speed_overlay(tm, "ov", None, dsp["port"])
    assert tov.config.key_side == "target" and tov.config.implicit
    assert tov.index_sink is not None
    assert tov.solver.other_factors.data_ptr() == tm.user_factors.data_ptr()
    ja.attach_speed_overlay(jov)
    ta.attach_speed_overlay(tov)
    for p in PKGS:
        p.insert(ids[p.name], p.event("view", "uA0", "iFresh"),
                 p.event("view", "uA2", "iFresh"),
                 p.event("like", "uA3", "iFresh"),
                 p.event("view", "uB1", "iA4"))
    jp, tp = jov.poll(), tov.poll()
    assert (jp["solved"], jp["tail_rows"]) == (tp["solved"],
                                              tp["tail_rows"]) == (2, 4)
    for item in ("iFresh", "iA4"):
        j, t = np.asarray(jov.lookup(item)), tov.lookup(item)
        np.testing.assert_allclose(t, j, atol=1e-4)
        assert abs(float(np.linalg.norm(t)) - 1.0) < 1e-5
    for items in (("iFresh",), ("iFresh", "iA1"), ("iA4",)):
        same_answer(ta.predict(tm, PORT.sp.Query(items=items, num=5)),
                    ja.predict(jm, JAX.sp.Query(items=items, num=5)), items)


def test_similarproduct_index_overlay_and_virtual_items(monkeypatch):
    """tests/test_mips.py's case in the port: an index over the
    normalized serving table, plain queries routed two-stage, and a
    brand-new item published through the overlay's ``index_sink`` served
    as a result at its exact cosine score, never as its own match."""
    from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
    from incubator_predictionio_tpu_torch.ops import mips

    monkeypatch.setenv("PIO_SERVE_MIPS", "on")
    rng = np.random.default_rng(9)
    n_users, n_items, nnz = 48, 400, 3000
    sp = PORT.sp
    pd = sp.PreparedData(
        users=rng.integers(0, n_users, nnz).astype(np.int32),
        items=rng.integers(0, n_items, nnz).astype(np.int32),
        weights=rng.uniform(0.5, 3.0, nnz).astype(np.float32),
        user_bimap=PORT.BiMap({f"u{i}": i for i in range(n_users)}),
        item_bimap=PORT.BiMap({f"i{i}": i for i in range(n_items)}),
        item_categories={})
    algo = sp.SimilarProductAlgorithm(
        sp.ALSAlgorithmParams(rank=8, num_iterations=2, seed=2))
    model = algo.train(PORT.ctx(), pd)
    index = mips.index_for(model.item_factors_norm)
    assert index is not None and index.n_items == n_items
    # deploy adopts the trained index onto the put table
    model = algo.prepare_model(PORT.ctx(), model)
    assert mips.index_for(model.item_factors_norm) is index

    fam = obs_metrics.REGISTRY.get("pio_serve_candidates_scanned_total")
    before = fam.labels(stage="rerank").value
    result = algo.predict(model, sp.Query(items=("i7",), num=5))
    assert len(result.item_scores) == 5 and "i7" not in _items(result)
    assert fam.labels(stage="rerank").value > before  # routed two-stage

    holder = {}

    class _FakeOverlay:  # capture the sink without storage machinery
        def __init__(self, *a, **kw):
            holder["sink"] = kw["index_sink"]
            self.enabled = False

    import incubator_predictionio_tpu_torch.speed.overlay as ov_mod

    monkeypatch.setattr(ov_mod, "SpeedOverlay", _FakeOverlay)
    algo.make_speed_overlay(model, app_name="App", channel_name=None)
    base = model.item_factors_norm.numpy()
    fresh = (0.7 * base[7] + 0.3 * base[11]).astype(np.float32)
    fresh /= np.linalg.norm(fresh)
    holder["sink"](["brand-new-item"], [fresh])
    assert index.tail_size() == 1
    got = algo.predict(model, sp.Query(items=("i7",), num=5))
    names = _items(got)
    assert "brand-new-item" in names, names
    hit = got.item_scores[names.index("brand-new-item")]
    qv = base[7] / np.linalg.norm(base[7])
    assert hit.score == pytest.approx(float(fresh @ qv), rel=1e-5)
    # a known item's publish re-quantizes its row in place
    holder["sink"](["i11"], [fresh])
    assert index.tail_size() == 2
    # querying BY the new item never returns the item itself
    overlay = type("Ov", (), {"lookup": lambda self, key:
                              fresh if key == "brand-new-item" else None,
                              "enabled": True})()
    algo.attach_speed_overlay(overlay)
    try:
        self_q = algo.predict(model, sp.Query(items=("brand-new-item",),
                                              num=5))
        assert self_q.item_scores
        assert "brand-new-item" not in _items(self_q)
    finally:
        algo.attach_speed_overlay(None)
    mips.unregister_index(model.item_factors_norm)


def test_mips_build_failure_raises(monkeypatch):
    """Unlike the JAX package, which logs a failed build and serves
    exhaustively, the port raises."""
    from incubator_predictionio_tpu_torch.ops import mips

    monkeypatch.setenv("PIO_SERVE_MIPS", "on")

    def boom(*a, **kw):
        raise RuntimeError("build boom")

    monkeypatch.setattr(mips, "build_index", boom)
    app_id = PORT.seed_app("boom")
    seed_views(PORT, app_id)
    with pytest.raises(RuntimeError, match="build boom"):
        PORT.train("boom", num_iterations=2)


# ---------------------------------------------------------------------------
# the JAX names: engineFactory and checkpoint blobs
# ---------------------------------------------------------------------------

def test_jax_factory_and_blob_resolve_to_the_port():
    from incubator_predictionio_tpu_torch.cli import commands

    factory = commands.resolve_engine_factory(
        "incubator_predictionio_tpu.models.similarproduct:"
        "SimilarProductEngine")
    assert type(factory) is PORT.sp.SimilarProductEngine
    ru = commands.resolve_engine_factory(
        "incubator_predictionio_tpu.models.similarproduct:"
        "RecommendedUserEngine")
    assert type(ru) is PORT.ru.RecommendedUserEngine

    seed_both("blob")
    ja, jm = JAX.train("blob")
    blob = JAX.checkpoint.serialize_models([jm], "inst", JAX.ctx())
    [restored] = PORT.checkpoint.deserialize_models(blob)
    assert isinstance(restored, PORT.sp.SimilarProductModel)
    ep = PORT.engine_params("blob")
    ta = PORT.algorithm(ep)
    tm = ta.prepare_model(PORT.ctx(), restored)
    assert tm.item_factors_norm.dtype == torch.float32
    for jq, tq in zip(_sp_queries(JAX), _sp_queries(PORT)):
        everything = dataclasses.replace(jq, num=len(jm.item_bimap))
        same_answer(ta.predict(tm, tq), ja.predict(jm, jq), tq,
                    full=ja.predict(jm, everything))
    # and the port's own blob round-trips
    _a, pm = PORT.train("blob", num_iterations=2)
    [back] = PORT.checkpoint.deserialize_models(
        PORT.checkpoint.serialize_models([pm], "inst2", PORT.ctx()))
    np.testing.assert_array_equal(np.asarray(back.item_factors_norm),
                                  pm.item_factors_norm.numpy())
    assert dict(back.user_bimap.items()) == dict(pm.user_bimap.items())


def test_chip_smoke_similar_phase_rehearses_on_the_cpu():
    """chip_smoke.py's similar phase at its small size on the CPU: the
    store-trained template against the plain top-k, the overlay's
    brand-new item published and served, DIMSUM against scipy, the
    recommended-user answers."""
    import chip_smoke
    from incubator_predictionio_tpu_torch import runtime
    from incubator_predictionio_tpu_torch.core import params as params_mod
    from incubator_predictionio_tpu_torch.ops import als, kernels
    from incubator_predictionio_tpu_torch.parallel import context
    from incubator_predictionio_tpu_torch.servers import (
        prediction_server as server_mod,
    )
    from incubator_predictionio_tpu_torch.utils import planted

    _launches, err, stats = chip_smoke.similar_phase(
        torch.device(CPU), runtime, kernels, als, planted, params_mod,
        context, server_mod, small=True)
    assert stats["loss_rel_err"] <= chip_smoke.IMPLICIT_LOSS_TOL
    assert stats["overlay"]["new_item_rank"] == 0
    assert stats["overlay"]["virtual_id"] >= 300
    assert stats["dimsum"]["max_err"] <= chip_smoke.DIMSUM_TOL
    assert stats["follow"]["answers"] > 0 and err < 1e-4
