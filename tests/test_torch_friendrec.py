"""The port's friend-recommendation template (``models/
friendrecommendation/``) and ``ops/simrank.py`` against the JAX package's,
on the CPU, each package on a memory store of its own with the same
events:

- ``simrank`` within 1e-6 of JAX's on seeded graphs (duplicate edges and
  self-loops among them), and equal to the naive per-pair SimRank of
  tests/test_friend_recommendation.py within 1e-4; the adjacency built
  from the edge list as ``adj[src, dst] = 1.0`` builds it;
- every case of tests/test_friend_recommendation.py through both
  packages;
- the keyword, random and SimRank answers of both packages equal on the
  same events (the random ones bit for bit: the crc32-seeded generator);
- a JAX-trained blob decoded and served by the port;
- ``chip_smoke.py``'s friend-recommendation leg, rehearsed at its small
  size.
"""

import numpy as np
import pytest
import torch

from test_torch_classification import (  # noqa: F401 (the fixture)
    BOTH,
    CPU,
    JAX,
    PKGS,
    PORT,
    mem_storage,
)


def sr(p):
    return p.mod("ops.simrank")


def fr(p):
    return p.mod("models.friendrecommendation")


def simrank_port(src, dst, n, **kw):
    return sr(PORT).simrank(src, dst, n, device=CPU, **kw)


@pytest.mark.parametrize("n, e, decay, iters", [
    (40, 160, 0.8, 7), (97, 300, 0.6, 4), (64, 64, 0.8, 12)])
def test_simrank_equals_jax(n, e, decay, iters):
    rng = np.random.default_rng(n)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    src[:5], dst[:5] = 3, 3           # a self-loop, repeated
    src[5:9], dst[5:9] = 1, 2         # a duplicate edge
    want = sr(JAX).simrank(src, dst, n, decay=decay, iterations=iters)
    got = simrank_port(src, dst, n, decay=decay, iterations=iters)
    assert got.dtype == np.float32 and got.shape == (n, n)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (np.diagonal(got) == 1).all()


def test_adjacency_collapses_duplicates_as_jax_does():
    src = np.array([0, 0, 0, 1, 2])
    dst = np.array([1, 1, 2, 2, 2])
    w = sr(PORT).normalized_adjacency(src, dst, 4, CPU).numpy()
    adj = np.zeros((4, 4), np.float32)
    adj[src, dst] = 1.0
    np.testing.assert_array_equal(
        w, adj / np.maximum(adj.sum(axis=0), 1.0)[None, :])


def test_simrank_refuses_graphs_above_the_dense_ceiling():
    with pytest.raises(ValueError, match="16384"):
        simrank_port(np.zeros(1, int), np.zeros(1, int),
                     sr(PORT).MAX_NODES + 1)


def test_simrank_matches_naive_reference():
    """tests/test_friend_recommendation.py's naive per-pair SimRank, held
    to the port."""
    edges = [(0, 2), (1, 2), (0, 3), (1, 3), (3, 2), (2, 4), (3, 4)]
    src = np.array([a for a, _ in edges])
    dst = np.array([b for _, b in edges])
    n, c, iters = 5, 0.8, 12
    got = simrank_port(src, dst, n, decay=c, iterations=iters)

    in_nb = {v: [a for a, b in edges if b == v] for v in range(n)}
    s = np.eye(n)
    for _ in range(iters):
        nxt = np.eye(n)
        for a in range(n):
            for b in range(n):
                if a == b:
                    continue
                na, nb = in_nb[a], in_nb[b]
                if not na or not nb:
                    nxt[a, b] = 0.0
                    continue
                nxt[a, b] = c * sum(
                    s[x, y] for x in na for y in nb) / (len(na) * len(nb))
        s = nxt
    np.testing.assert_allclose(got, s, atol=1e-4)


# ---------------------------------------------------------------------------
# tests/test_friend_recommendation.py through both packages
# ---------------------------------------------------------------------------

def seeded_app(p):
    app_id = p.seed_app("frapp")
    kw = {
        ("user", "u1"): {"1": 0.6, "2": 0.4},
        ("user", "u2"): {"3": 1.0},
        ("item", "g1"): {"1": 0.5, "2": 0.5},   # overlaps u1
        ("item", "g2"): {"9": 1.0},             # overlaps nobody
        ("user", "u4"): ["1", "3"],             # a bare list: weight 1.0
        ("user", "u5"): None,                   # no keywords
    }
    events = [p.Event(event="$set", entity_type=etype, entity_id=eid,
                      properties=p.DataMap({"keywords": words}))
              for (etype, eid), words in kw.items()]
    # graph: u3 follows both u1 and u2 (a shared in-neighbor → SimRank
    # similarity between u1 and u2); both act on g1
    for (et, a), (tt, b), name in (
        (("user", "u3"), ("user", "u1"), "follow"),
        (("user", "u3"), ("user", "u2"), "follow"),
        (("user", "u1"), ("item", "g1"), "action"),
        (("user", "u2"), ("item", "g1"), "action"),
    ):
        events.append(p.Event(event=name, entity_type=et, entity_id=a,
                              target_entity_type=tt, target_entity_id=b))
    p.insert(app_id, events)
    return app_id


def _ep(p, algo, params):
    return p.engine_params(fr(p).DataSourceParams(app_name="frapp"),
                           [(algo, params)])


def trained(p, algo, params):
    seeded_app(p)
    engine = fr(p).FriendRecommendationEngine().apply()
    ep = _ep(p, algo, params)
    models = engine.train(p.ctx(), ep)
    return p.algorithms(engine, ep)[0], models[0]


@BOTH
def test_keyword_similarity_confidence_and_acceptance(p):
    algo, model = trained(p, "keyword", fr(p).KeywordSimilarityAlgoParams(
        sim_weight=2.0, sim_threshold=0.5))
    q = fr(p).Query
    pr = algo.predict(model, q(user="u1", item="g1"))
    # Σ w_u·w_i = 0.6*0.5 + 0.4*0.5 = 0.5; 0.5*2.0 >= 0.5 → accepted
    assert pr.confidence == pytest.approx(0.5)
    assert pr.acceptance
    p2 = algo.predict(model, q(user="u2", item="g1"))
    assert p2.confidence == pytest.approx(0.0) and not p2.acceptance
    assert algo.predict(model, q(user="ghost", item="g1")).confidence == 0.0
    assert algo.predict(model, q(user="u4", item="g1")).confidence == 0.5
    assert model.user_keywords["u5"] == {}


@BOTH
def test_random_baseline_is_deterministic(p):
    from_mod = p.mod("models.friendrecommendation.engine")
    algo, model = trained(p, "random", from_mod.RandomAlgoParams(seed=5))
    q = fr(p).Query(user="u1", item="g1")
    a, b = algo.predict(model, q), algo.predict(model, q)
    assert a == b
    assert 0.0 <= a.confidence < 1.0


@BOTH
def test_simrank_scores_structural_similarity(p):
    algo, model = trained(p, "simrank", fr(p).SimRankAlgoParams(
        iterations=8, acceptance_threshold=0.05))
    q = fr(p).Query
    # the user pair through the item slot's fallback
    assert algo.predict(model, q(user="u1", item="u2")).confidence > 0.0
    assert algo.predict(model, q(user="u2", item="g1")).confidence >= 0.0
    assert algo.predict(model, q(user="ghost", item="g1")).confidence == 0.0


def all_pairs(p):
    users = ["u1", "u2", "u3", "u4", "u5", "ghost"]
    targets = ["g1", "g2", "u1", "u2", "u3", "nope"]
    return [fr(p).Query(user=u, item=t) for u in users for t in targets]


@pytest.mark.parametrize("algo", ["keyword", "random", "simrank"])
def test_answers_equal_across_packages(algo):
    """The same events through both packages: every (user, target) answer
    equal, SimRank's confidence within 1e-6 (f32 products), the rest
    exactly."""
    out = {}
    for p in PKGS:
        ap = dict(keyword=fr(p).KeywordSimilarityAlgoParams(),
                  random=p.mod("models.friendrecommendation.engine")
                  .RandomAlgoParams(seed=9),
                  simrank=fr(p).SimRankAlgoParams())[algo]
        a, m = trained(p, algo, ap)
        out[p.name] = [a.predict(m, q) for q in all_pairs(p)]
    for j, t in zip(out["jax"], out["port"]):
        assert t.acceptance == j.acceptance
        if algo == "simrank":
            assert t.confidence == pytest.approx(j.confidence, abs=1e-6)
        else:
            assert t.confidence == j.confidence


@BOTH
def test_wire_format(p):
    q = p.codec.extract(fr(p).Query, {"user": "u1", "item": "g1"})
    assert (q.user, q.item) == ("u1", "g1")
    assert p.codec.to_jsonable(fr(p).Prediction(confidence=0.25,
                                                acceptance=True)) == \
        {"confidence": 0.25, "acceptance": True}


def test_jax_blob_resolves_in_the_port():
    """A JAX-trained engine of all three algorithms: its blob decodes in
    the port (the SimRank matrix as numpy, as it was) and answers as the
    JAX models do."""
    eps, engines = {}, {}
    for p in PKGS:
        eps[p.name] = p.engine_params(
            fr(p).DataSourceParams(app_name="frapp"),
            [("simrank", fr(p).SimRankAlgoParams()),
             ("keyword", fr(p).KeywordSimilarityAlgoParams()),
             ("random", p.mod("models.friendrecommendation.engine")
              .RandomAlgoParams())])
        engines[p.name] = fr(p).FriendRecommendationEngine().apply()
    seeded_app(JAX)
    jms = engines["jax"].train(JAX.ctx(), eps["jax"])
    blob = JAX.checkpoint.serialize_models(jms, "inst", JAX.ctx())
    restored = PORT.checkpoint.deserialize_models(blob)
    eng = PORT.mod("models.friendrecommendation.engine")
    assert [type(m) for m in restored] == [
        eng.SimRankModel, eng.KeywordSimilarityModel, eng.RandomModel]
    talgos = PORT.algorithms(engines["port"], eps["port"])
    tms = [a.prepare_model(PORT.ctx(), m) for a, m in zip(talgos, restored)]
    np.testing.assert_array_equal(tms[0].similarities, jms[0].similarities)
    jalgos = JAX.algorithms(engines["jax"], eps["jax"])
    for ja, ta, jm, tm in zip(jalgos, talgos, jms, tms):
        for jq, tq in zip(all_pairs(JAX), all_pairs(PORT)):
            got, want = ta.predict(tm, tq), ja.predict(jm, jq)
            assert (got.confidence, got.acceptance) == \
                (want.confidence, want.acceptance)


def test_chip_smoke_friendrec_leg_rehearses_on_the_cpu():
    """chip_smoke.py's friend-recommendation leg at its small size on the
    CPU: ``pio train`` in process, the f64 iteration held, the served
    S[a, b], the keyword and random answers recomputed on the host."""
    import chip_smoke
    from incubator_predictionio_tpu_torch import runtime
    from incubator_predictionio_tpu_torch.servers import (
        prediction_server as server_mod,
    )

    err, stats = chip_smoke.friendrec_leg(torch.device(CPU),
                                          server_mod, small=True)
    assert stats["f64_err"] <= chip_smoke.SIMRANK_F64_TOL
    assert stats["keyword_err"] == 0.0 and err <= chip_smoke.SIMRANK_F64_TOL
    assert stats["nonzero_share"] > 0.5 and stats["blob_bytes"] > 512 ** 2 * 4
