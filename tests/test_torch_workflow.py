"""The port's stored main path on the CPU, against the JAX package's:
events in the event store (SQLite under a temporary ``PIO_HOME``, the
zero-config default both packages read) → ``CoreWorkflow.run_train`` →
``load_models`` → ``PredictionServer`` → POST /queries.json.

- Over the same store contents the port's ``read_training`` + ``prepare``
  give the JAX package's ``PreparedData`` (equal arrays, equal BiMaps),
  repeated ratings resolved latest-wins.
- The port's store-trained ALS model fits within the parity bound of the
  JAX package's store-trained one (``PERF.md`` §2: fit < max(1.15·ref,
  ref + 0.02)); both with ``PIO_RETRAIN_CONTINUE=0`` on their shared
  store, so that neither package continues from the other's instance.
- The continuation retrain (each package on a memory store of its own,
  the same events): a second ``run_train`` with equal params continues,
  a changed λ or ``PIO_RETRAIN_CONTINUE=0`` trains fresh, the explicit
  ``prev_models`` seam seeds anyway, a model that fails to load trains
  fresh, and ``pio_train_sweeps_total{mode}`` counts the sweeps, as in
  the JAX package (tests/test_retrain_continue.py:318-492).
- A model the JAX package's ``run_train`` stored is deployed by the port's
  ``load_models`` and answers the JAX package's top-k for the same queries:
  ids equal except near-ties, scores within rtol 1e-5.
- The sequence engine trained from the store answers a query without
  ``recentItems`` from the user's history in the store.
"""

import json
import urllib.request
from datetime import timedelta

import numpy as np
import pytest
import torch

from incubator_predictionio_tpu.core.params import (
    EngineParams as JEngineParams,
)
from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap
from incubator_predictionio_tpu.data.storage import Storage as JStorage
from incubator_predictionio_tpu.models.recommendation import engine as jeng
from incubator_predictionio_tpu.parallel.context import (
    RuntimeContext as JContext,
)
from incubator_predictionio_tpu.workflow.workflow import (
    CoreWorkflow as JCoreWorkflow,
)
from incubator_predictionio_tpu_torch.core.params import (
    EngineParams,
    WorkflowParams,
)
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.interactions import Interactions
from incubator_predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Storage,
)
from incubator_predictionio_tpu_torch.models.recommendation import (
    engine as teng,
)
from incubator_predictionio_tpu_torch.models.sequence import engine as tseq
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.servers.prediction_server import (
    PredictionServer,
)
from incubator_predictionio_tpu_torch.utils.planted import planted_ratings
from incubator_predictionio_tpu_torch.utils.times import parse_iso8601
from incubator_predictionio_tpu_torch.workflow.workflow import CoreWorkflow

CPU = "cpu"
APP = "QsApp"
N_USERS, N_ITEMS, NNZ = 120, 80, 2_500
T0 = parse_iso8601("2024-05-01T00:00:00Z")
ALS = dict(rank=8, num_iterations=10, lambda_=0.05, seed=3)


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """Both packages' Storage on one fresh SQLite store under
    ``tmp_path``."""
    import os

    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    monkeypatch.setenv("PIO_RETRAIN_CONTINUE", "0")
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    Storage.reset()
    JStorage.reset()
    yield
    Storage.reset()
    JStorage.reset()


def _new_app(name):
    """What ``pio app new`` does: an app, its event store, an access key."""
    app_id = Storage.get_meta_data_apps().insert(App(0, name))
    Storage.get_events().init(app_id)
    key = Storage.get_meta_data_access_keys().insert(AccessKey("", app_id))
    assert key
    return app_id


def _rating_events(seed=11):
    """Planted ratings imported columnar, then later re-ratings of some
    pairs (latest wins), buys, and the items' ``$set`` properties."""
    app_id = _new_app(APP)
    users, items, ratings, _ = planted_ratings(
        n_users=N_USERS, n_items=N_ITEMS, nnz=NNZ, n_holdout=10, seed=seed)
    user_ids = [f"u{k}" for k in range(N_USERS)]
    item_ids = [f"i{k}" for k in range(N_ITEMS)]
    events = Storage.get_events()
    events.import_interactions(Interactions(
        user_idx=users, item_idx=items, values=ratings, user_ids=user_ids,
        item_ids=item_ids), app_id, base_time=T0)
    rng = np.random.default_rng(seed)
    later = T0 + timedelta(hours=1)
    extra = []
    for k, j in enumerate(rng.choice(NNZ, 60, replace=False)):
        extra.append(Event(
            event="rate", entity_type="user", entity_id=user_ids[users[j]],
            target_entity_type="item", target_entity_id=item_ids[items[j]],
            properties=DataMap({"rating": float(rng.integers(1, 6))}),
            event_time=later + timedelta(seconds=k)))
    for k in range(20):
        extra.append(Event(
            event="buy", entity_type="user",
            entity_id=user_ids[int(rng.integers(N_USERS))],
            target_entity_type="item",
            target_entity_id=item_ids[int(rng.integers(N_ITEMS))],
            event_time=later + timedelta(minutes=5, seconds=k)))
    for k in range(0, N_ITEMS, 2):
        extra.append(Event(
            event="$set", entity_type="item", entity_id=item_ids[k],
            properties=DataMap({"creationYear": 1990 + k % 30,
                                "categories": [f"c{k % 3}"]}),
            event_time=T0))
    events.insert_batch(extra, app_id)
    return app_id


def _port_params():
    return EngineParams(
        data_source_params=("", teng.DataSourceParams(app_name=APP)),
        algorithm_params_list=[("als", teng.ALSAlgorithmParams(**ALS))])


def _jax_params():
    return JEngineParams(
        data_source_params=("", jeng.DataSourceParams(app_name=APP)),
        algorithm_params_list=[("als", jeng.ALSAlgorithmParams(**ALS))])


def _fit(model, pd):
    uf = np.asarray(model.user_factors, np.float64)
    vf = np.asarray(model.item_factors, np.float64)
    pred = np.einsum("nk,nk->n", uf[pd.users], vf[pd.items])
    return float(np.sqrt(np.mean((pred - pd.ratings) ** 2)))


def _post(port, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(doc).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def test_store_reads_and_prepares_as_jax(stores):
    _rating_events()
    ref_td = jeng.RecommendationDataSource(
        jeng.DataSourceParams(app_name=APP)).read_training(JContext())
    ref = jeng.RecommendationPreparator().prepare(JContext(), ref_td)
    ctx = RuntimeContext(device=CPU)
    td = teng.RecommendationDataSource(
        teng.DataSourceParams(app_name=APP)).read_training(ctx)
    got = teng.RecommendationPreparator().prepare(ctx, td)
    assert len(td) == NNZ + 60 + 20
    assert len(got.users) < len(td)          # the re-ratings replaced some
    for f in ("users", "items", "ratings"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert dict(got.user_bimap.items()) == dict(ref.user_bimap.items())
    assert dict(got.item_bimap.items()) == dict(ref.item_bimap.items())
    assert got.item_years == ref.item_years and len(got.item_years) == 40
    assert got.item_categories == ref.item_categories


def test_run_train_load_models_and_serve(stores):
    """The quickstart path through the port: the instance's life cycle and
    params, the decoded factors bit for bit, the HTTP answers those of the
    trained model, and the fit within the parity bound of the JAX
    package's store-trained model."""
    _rating_events()
    eng = teng.RecommendationEngine().apply()
    ep = _port_params()
    ctx = RuntimeContext(device=CPU)
    iid = CoreWorkflow.run_train(eng, ep, ctx=ctx)
    inst = Storage.get_meta_data_engine_instances().get_latest_completed(
        "default", "NOT_VERSIONED", "default")
    assert inst.id == iid and inst.status == "COMPLETED"
    assert {"phase.read_s", "phase.prepare_s", "phase.als.prep_s",
            "phase.als.sweeps_s", "phase.checkpoint_s"} <= set(
                inst.runtime_conf)
    jiid = JCoreWorkflow.run_train(jeng.RecommendationEngine().apply(),
                                   _jax_params())
    jinst = JStorage.get_meta_data_engine_instances().get(jiid)
    assert jinst.status == "COMPLETED"
    for f in ("data_source_params", "preparator_params",
              "algorithms_params", "serving_params"):
        assert getattr(inst, f) == getattr(jinst, f), f

    [raw] = CoreWorkflow.load_models(iid)
    [trained] = eng.train(RuntimeContext(device=CPU), ep)   # same seed
    np.testing.assert_array_equal(raw.user_factors,
                                  trained.user_factors.numpy())
    np.testing.assert_array_equal(raw.item_factors,
                                  trained.item_factors.numpy())
    models = CoreWorkflow.load_models(iid, eng, ep, device=CPU)
    assert str(models[0].user_factors.device) == CPU

    pd = teng.RecommendationPreparator().prepare(
        ctx, teng.RecommendationDataSource(
            teng.DataSourceParams(app_name=APP)).read_training(ctx))
    [jmodel] = JCoreWorkflow.load_models(jiid)
    fit, ref_fit = _fit(raw, pd), _fit(jmodel, pd)
    assert fit < max(1.15 * ref_fit, ref_fit + 0.02), (fit, ref_fit)

    srv = PredictionServer(eng, ep, models, device=CPU)
    port = srv.start_background()
    try:
        algo = teng.ALSAlgorithm(teng.ALSAlgorithmParams(**ALS))
        for doc in ({"user": "u3", "num": 5},
                    {"user": "u7", "num": 8, "categories": ["c1"]},
                    {"user": "u9", "num": 4, "excludeSeen": True},
                    {"user": "nosuch", "num": 4}):
            body = _post(port, doc)
            q = teng.Query(user=doc["user"], num=doc["num"],
                           categories=tuple(doc.get("categories", ())) or None,
                           exclude_seen=doc.get("excludeSeen", False))
            ref = algo.predict(models[0], q)
            assert [s["item"] for s in body["itemScores"]] == [
                s.item for s in ref.item_scores]
            if doc["user"] != "nosuch":
                assert len(body["itemScores"]) == doc["num"]
    finally:
        srv.stop()


def test_a_failed_train_is_recorded_aborted(stores):
    _new_app(APP)      # no events: the sanity check fails the read
    eng = teng.RecommendationEngine().apply()
    with pytest.raises(ValueError, match="no ratings"):
        CoreWorkflow.run_train(eng, _port_params(), device=CPU)
    [inst] = Storage.get_meta_data_engine_instances().get_all()
    assert inst.status == "ABORTED"
    assert Storage.get_meta_data_engine_instances().get_latest_completed(
        "default", "NOT_VERSIONED", "default") is None


MEMORY = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
CONT_ALS = dict(rank=4, num_iterations=3, seed=7)


def _cont_events(event_cls, datamap_cls, tail: bool):
    """tests/test_retrain_continue.py's app: 8 users × 6 items at 0.8
    density, or its tail (every user rates a new item ``i6``)."""
    if tail:
        return [event_cls(event="rate", entity_type="user",
                          entity_id=f"u{u}", target_entity_type="item",
                          target_entity_id="i6",
                          properties=datamap_cls({"rating": 5.0}))
                for u in range(8)]
    rng = np.random.default_rng(0)
    out = []
    for u in range(8):
        for i in range(6):
            if rng.random() < 0.8:
                out.append(event_cls(
                    event="rate", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=datamap_cls(
                        {"rating": float(rng.integers(1, 6))})))
    return out


class _Pkg:
    """One package's side of a continuation test: its storage, events,
    engine, workflow and sweep counter."""

    def __init__(self, jax_side: bool):
        if jax_side:
            from incubator_predictionio_tpu.data.datamap import DataMap as DM
            from incubator_predictionio_tpu.data.event import Event as Ev
            from incubator_predictionio_tpu.data.storage import App as A
            from incubator_predictionio_tpu.obs import metrics

            self.storage, self.eng_mod, self.wf = JStorage, jeng, \
                JCoreWorkflow
            self.params_cls, self.app_cls = JEngineParams, A
        else:
            from incubator_predictionio_tpu_torch.obs import metrics

            DM, Ev = DataMap, Event
            self.storage, self.eng_mod, self.wf = Storage, teng, CoreWorkflow
            self.params_cls, self.app_cls = EngineParams, App
        self.metrics, self.event_cls, self.datamap_cls = metrics, Ev, DM
        self.jax_side = jax_side
        self.storage.configure(dict(MEMORY))
        self.app_id = self.storage.get_meta_data_apps().insert(
            self.app_cls(0, "contapp"))
        self.storage.get_events().init(self.app_id)
        self.add_events(tail=False)
        self.engine = self.eng_mod.RecommendationEngine().apply()

    def add_events(self, tail: bool):
        dao = self.storage.get_events()
        for e in _cont_events(self.event_cls, self.datamap_cls, tail):
            dao.insert(e, self.app_id)

    def params(self, lambda_=0.05, **als_kw):
        return self.params_cls(
            data_source_params=("", self.eng_mod.DataSourceParams(
                app_name="contapp")),
            algorithm_params_list=[("als", self.eng_mod.ALSAlgorithmParams(
                **dict(CONT_ALS, lambda_=lambda_, **als_kw)))])

    def train(self, params=None, **kw):
        if not self.jax_side:
            kw.setdefault("device", CPU)
        return self.wf.run_train(self.engine, params or self.params(), **kw)

    def sweeps(self, mode: str) -> float:
        m = self.metrics.REGISTRY.get("pio_train_sweeps_total")
        return 0.0 if m is None else m.labels(mode=mode).value


@pytest.fixture
def cont_pkgs(monkeypatch):
    """Both packages on memory stores of their own, the same app and
    events, continuation on (the default)."""
    monkeypatch.delenv("PIO_RETRAIN_CONTINUE", raising=False)
    Storage.reset()
    JStorage.reset()
    yield _Pkg(jax_side=True), _Pkg(jax_side=False)
    Storage.reset()
    JStorage.reset()


def _engaged(pkg, fn):
    """(continue sweeps, fresh sweeps) booked while ``fn`` ran."""
    c0, f0 = pkg.sweeps("continue"), pkg.sweeps("fresh")
    out = fn()
    return (pkg.sweeps("continue") - c0, pkg.sweeps("fresh") - f0), out


def test_workflow_explicit_prev_models_seam(cont_pkgs):
    """``run_train(prev_models=)``: a caller holding models seeds the
    continuation directly, even on a variant with no earlier COMPLETED
    instance (tests/test_retrain_continue.py:414-437), in both packages
    alike; the continued instance records its ``continue_seed`` phase."""
    seen = []
    for pkg in cont_pkgs:
        iid1 = pkg.train(engine_variant="seam-a")
        models = pkg.wf.load_models(iid1)
        fresh, _ = _engaged(pkg, lambda: pkg.train(engine_variant="seam-b"))
        seeded, iid3 = _engaged(pkg, lambda: pkg.train(
            engine_variant="seam-c", prev_models=models))
        assert fresh == (0, CONT_ALS["num_iterations"])
        assert seeded[0] > 0 and seeded[1] == 0
        seen.append((fresh, seeded[1]))
        inst = pkg.storage.get_meta_data_engine_instances().get(iid3)
        assert inst.status == "COMPLETED"
        if not pkg.jax_side:
            assert "phase.continue_seed_s" in inst.runtime_conf
            [model] = pkg.wf.load_models(iid3)
            assert model.user_factors.shape == (8, 4)
    assert seen[0] == seen[1]


def test_a_continuation_keeps_no_prep_plan(cont_pkgs):
    """``ALSAlgorithm.train_with_previous`` keeps no prep plan: each ``pio
    train`` is a process of its own, so a plan would never be reused. A
    continuation after a tail continues and leaves the plan cache
    empty."""
    from incubator_predictionio_tpu_torch.ops import retrain

    pkg = cont_pkgs[1]
    retrain.drop_plans()
    pkg.train()
    pkg.add_events(tail=True)
    (cont, fresh), _ = _engaged(pkg, pkg.train)
    assert cont > 0 and fresh == 0
    assert not retrain._PLAN_CACHE


def test_workflow_continuation_and_spec_change_auto_disable(cont_pkgs,
                                                            monkeypatch):
    """The first train is fresh; after a tail, a train with equal params
    continues (from the decoded instance, host arrays) and the continued
    model serves; a changed λ trains fresh; so does
    ``PIO_RETRAIN_CONTINUE=0`` with equal params. The same in both
    packages, sweep for sweep where the data decides nothing."""
    booked = []
    for pkg in cont_pkgs:
        first, iid1 = _engaged(pkg, lambda: pkg.train(engine_variant="c"))
        pkg.add_events(tail=True)
        second, iid2 = _engaged(pkg, lambda: pkg.train(engine_variant="c"))
        assert iid2 != iid1 and second[0] > 0 and second[1] == 0
        [model] = pkg.wf.load_models(iid2, pkg.engine, pkg.params(),
                                     **({} if pkg.jax_side
                                        else {"device": CPU}))
        algo = pkg.engine.algorithms(pkg.params())[0] if pkg.jax_side \
            else pkg.eng_mod.ALSAlgorithm(pkg.params().algorithm_params_list
                                          [0][1])
        assert algo.predict(model, pkg.eng_mod.Query(user="u1", num=3)
                            ).item_scores
        changed, _ = _engaged(pkg, lambda: pkg.train(
            pkg.params(lambda_=0.2), engine_variant="c"))
        monkeypatch.setenv("PIO_RETRAIN_CONTINUE", "0")
        off, _ = _engaged(pkg, lambda: pkg.train(
            pkg.params(lambda_=0.2), engine_variant="c"))
        monkeypatch.delenv("PIO_RETRAIN_CONTINUE")
        booked.append((first, changed, off))
        assert first == changed == off == (0, CONT_ALS["num_iterations"])
    assert booked[0] == booked[1]


@pytest.mark.parametrize("case", ["ok", "tensor", "rank", "prefix",
                                  "foreign"])
def test_engine_continuation_compat_gate(case):
    """A rank change, a reordered id space or another model class trains
    fresh; matching host arrays or in-process tensors seed: as the JAX
    package's ``_continuation_seed`` rules on the same cases."""
    users, items, vals = (np.random.default_rng(8).integers(0, 10, 200),
                          np.random.default_rng(9).integers(0, 8, 200),
                          np.ones(200, np.float32))
    ubm = {f"u{k}": k for k in range(10)}
    ibm = {f"i{k}": k for k in range(8)}
    rank = 6 if case == "rank" else 4
    if case == "prefix":
        ubm_prev = {f"u{k}": (k + 1) % 10 for k in range(10)}
    else:
        ubm_prev = ubm
    out = []
    for mod, bimap in ((jeng, JBiMap), (teng, BiMap)):
        pd = mod.PreparedData(
            users=users.astype(np.int32), items=items.astype(np.int32),
            ratings=vals, user_bimap=bimap(ubm), item_bimap=bimap(ibm),
            item_years={}, item_categories={})
        algo = mod.ALSAlgorithm(mod.ALSAlgorithmParams(
            rank=4, num_iterations=2, seed=1))
        uf = np.zeros((10, rank), np.float32)
        vf = np.zeros((8, rank), np.float32)
        if case == "tensor" and mod is teng:
            uf, vf = torch.from_numpy(uf), torch.from_numpy(vf)
        prev = object() if case == "foreign" else mod.ALSModel(
            user_factors=uf, item_factors=vf, user_bimap=bimap(ubm_prev),
            item_bimap=bimap(ibm), item_years={}, item_categories={})
        out.append(algo._continuation_seed(pd, prev) is None)
        if mod is teng and case == "foreign":
            model = algo.train_with_previous(RuntimeContext(device=CPU), pd,
                                             prev)
            assert model.user_factors.shape == (10, 4)
    assert out[0] == out[1] == (case in ("rank", "prefix", "foreign"))


def test_a_model_that_fails_to_load_trains_fresh(cont_pkgs, monkeypatch):
    """Continuation is an optimization: a blob that cannot be decoded
    gives a fresh train, not a failed one."""
    from incubator_predictionio_tpu_torch.workflow import checkpoint

    _jax, pkg = cont_pkgs
    pkg.train()

    def broken(_blob):
        raise ValueError("corrupt blob")

    monkeypatch.setattr(checkpoint, "deserialize_models", broken)
    booked, iid = _engaged(pkg, pkg.train)
    assert booked == (0, CONT_ALS["num_iterations"])
    assert pkg.storage.get_meta_data_engine_instances().get(
        iid).status == "COMPLETED"


def _same_top(got, ref):
    """Ids equal except among near-ties; scores within rtol 1e-5."""
    assert len(got) == len(ref)
    for (gi, gs), (ri, rs) in zip(got, ref):
        assert gs == pytest.approx(rs, rel=1e-5, abs=1e-6)
        if gi != ri:
            assert gs == pytest.approx(rs, rel=1e-5)


def test_a_jax_trained_model_is_deployed_by_the_port(stores):
    _rating_events()
    jengine = jeng.RecommendationEngine().apply()
    jep = _jax_params()
    jiid = JCoreWorkflow.run_train(jengine, jep)
    [jmodel] = JCoreWorkflow.load_models(jiid, jengine, jep)
    jalgo = jeng.ALSAlgorithm(jep.algorithm_params_list[0][1])

    eng = teng.RecommendationEngine().apply()
    ep = _port_params()
    models = CoreWorkflow.load_models(jiid, eng, ep, device=CPU)
    assert type(models[0]) is teng.ALSModel
    srv = PredictionServer(eng, ep, models, device=CPU)
    port = srv.start_background()
    try:
        docs = [{"user": f"u{u}", "num": n} for u, n in
                ((0, 10), (5, 3), (17, 25), (42, 80))]
        docs += [{"user": "u8", "num": 6, "excludeSeen": True},
                 {"user": "u9", "num": 5, "categories": ["c2"]},
                 {"user": "u11", "num": 5, "creationYear": 2005},
                 {"user": "u12", "num": 7, "blacklist": ["i1", "i2"]}]
        for doc in docs:
            body = _post(port, doc)
            ref = jalgo.predict(jmodel, jeng.Query(
                user=doc["user"], num=doc["num"],
                exclude_seen=doc.get("excludeSeen", False),
                categories=tuple(doc.get("categories", ())) or None,
                creation_year=doc.get("creationYear"),
                blacklist=tuple(doc.get("blacklist", ())) or None))
            _same_top([(s["item"], s["score"]) for s in body["itemScores"]],
                      [(s.item, s.score) for s in ref.item_scores])
            assert body["itemScores"]
    finally:
        srv.stop()


SESSIONS = {f"s{k}": [f"i{(3 * k + j) % 15}" for j in range(6 + k)]
            for k in range(6)}


def test_sequence_engine_through_the_store(stores):
    """Views in the store → ``run_train`` → ``load_models`` → HTTP: a query
    without ``recentItems`` is answered from the user's last events in the
    store, as the same query with them is."""
    app_id = _new_app("SeqApp")
    events = []
    for user, items in SESSIONS.items():
        events += [Event(event="view", entity_type="user", entity_id=user,
                         target_entity_type="item", target_entity_id=i,
                         event_time=T0 + timedelta(seconds=j))
                   for j, i in enumerate(items)]
    Storage.get_events().insert_batch(events[::-1], app_id)
    eng = tseq.SequenceEngine().apply()
    ep = EngineParams(
        data_source_params=("", tseq.DataSourceParams(app_name="SeqApp")),
        preparator_params=("", tseq.PreparatorParams(max_len=6)),
        algorithm_params_list=[("sasrec", tseq.SeqRecAlgorithmParams(
            app_name="SeqApp", d_model=8, n_layers=1, epochs=2,
            batch_size=4, seed=0))])
    iid = CoreWorkflow.run_train(eng, ep, device=CPU,
                                 params=WorkflowParams(batch="seq"))
    assert Storage.get_meta_data_engine_instances().get(iid).batch == "seq"
    models = CoreWorkflow.load_models(iid, eng, ep, device=CPU)
    assert models[0].step_losses is None      # not checkpointed
    srv = PredictionServer(eng, ep, models, device=CPU)
    port = srv.start_background()
    try:
        for user, items in SESSIONS.items():
            stored = _post(port, {"user": user, "num": 4})
            again = _post(port, {"user": user, "num": 4})   # the TTL cache
            given = _post(port, {"user": user, "num": 4,
                                 "recentItems": items[-6:]})
            assert stored == again == given
            assert len(stored["itemScores"]) == 4
        assert _post(port, {"user": "nobody", "num": 4}) == {
            "itemScores": []}
    finally:
        srv.stop()
