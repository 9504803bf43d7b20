"""The port's classification template (``models/classification/``) and its
ops (``ops/nb.py``, ``ops/logreg.py``) against the JAX package's, on the
CPU, each package on a memory store of its own with the same events:

- ``nb_fit`` / ``nb_predict`` equal to JAX's on seeded inputs (log-priors
  and log-likelihoods within 1e-6), an argmax tie going to the lowest class
  in both; ``logreg_fit`` (300 Adam steps, l2 1e-4 and 1e-2) within 2e-5
  of JAX's weights and bias, its probabilities within 1e-6;
- the cases of tests/test_ops_and_e2.py (``test_nb_fit_predict``,
  ``test_logreg_fit_predict``) and tests/test_other_templates.py
  (``test_classification_template``, ``test_classification_wire_format``)
  through both packages, the answers equal;
- ``pio eval`` through the port's CLI (in this process) against the JAX
  package's ``CoreWorkflow.run_evaluation``: the same stored results;
- a JAX-trained blob decoded and served by the port, and every remaining
  quickstart's JAX-named ``engineFactory`` resolving to the port;
- ``chip_smoke.py``'s classification leg, rehearsed at its small size.

``Pkg`` and the ``mem_storage`` fixture are shared with the regression,
friend-recommendation and stock files.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEM_CONF = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}


class Pkg:
    """One package's modules and the calls whose form differs between
    them (the device, the engine's algorithm list)."""

    def __init__(self, name: str, pkg: str):
        self.name = name
        self.pkg = pkg
        self.params = self.mod("core.params")
        self.evaluation = self.mod("core.evaluation")
        self.context = self.mod("parallel.context")
        self.storage = self.mod("data.storage")
        self.Storage = self.storage.Storage
        self.Event = self.mod("data.event").Event
        self.DataMap = self.mod("data.datamap").DataMap
        self.codec = self.mod("utils.json_codec")
        self.checkpoint = self.mod("workflow.checkpoint")
        self.CoreWorkflow = self.mod("workflow.workflow").CoreWorkflow

    def mod(self, path: str):
        return importlib.import_module(f"{self.pkg}.{path}")

    def ctx(self):
        return (self.context.RuntimeContext(device=CPU) if self.name == "port"
                else self.context.RuntimeContext())

    def algorithms(self, engine, ep) -> list:
        if self.name == "port":
            return engine.components(ep)[0]
        return engine.algorithms(ep)

    def serving(self, engine, ep):
        if self.name == "port":
            return engine.components(ep)[1]
        return engine.serving(ep)

    def run_train(self, engine, ep) -> str:
        return self.CoreWorkflow.run_train(engine, ep, ctx=self.ctx())

    def load_models(self, iid, engine, ep) -> list:
        return self.CoreWorkflow.load_models(iid, engine, ep, ctx=self.ctx())

    def engine_params(self, ds, algos) -> object:
        return self.params.EngineParams(data_source_params=("", ds),
                                        algorithm_params_list=list(algos))

    def seed_app(self, name: str) -> int:
        self.Storage.get_meta_data_apps().insert(self.storage.App(0, name))
        return self.Storage.get_meta_data_apps().get_by_name(name).id

    def insert(self, app_id: int, events) -> None:
        for e in events:
            self.Storage.get_events().insert(e, app_id)


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


def jnb(p):
    return p.mod("ops.nb")


def jlr(p):
    return p.mod("ops.logreg")


def clf(p):
    return p.mod("models.classification")


# ---------------------------------------------------------------------------
# ops/nb.py and ops/logreg.py against JAX's
# ---------------------------------------------------------------------------

def nb_both(x: np.ndarray, y: np.ndarray, c: int, lam: float):
    jm = jnb(JAX).nb_fit(jnp.asarray(x), jnp.asarray(y, jnp.int32), c, lam)
    tm = jnb(PORT).nb_fit(torch.from_numpy(x), torch.from_numpy(y), c, lam)
    return jm, tm


@pytest.mark.parametrize("lam", [1.0, 0.5])
def test_nb_fit_equals_jax(lam):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 9, (200, 4)).astype(np.float32)
    y = rng.integers(0, 3, 200).astype(np.int32)
    jm, tm = nb_both(x, y, 3, lam)
    np.testing.assert_allclose(tm.pi.numpy(), np.asarray(jm.pi), atol=1e-6)
    np.testing.assert_allclose(tm.theta.numpy(), np.asarray(jm.theta),
                               atol=1e-6)
    q = rng.integers(0, 9, (64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        jnb(PORT).nb_log_scores(tm, torch.from_numpy(q)).numpy(),
        np.asarray(jnb(JAX).nb_log_scores(jm, jnp.asarray(q))), atol=1e-5)
    np.testing.assert_array_equal(
        jnb(PORT).nb_predict(tm, torch.from_numpy(q)).numpy(),
        np.asarray(jnb(JAX).nb_predict(jm, jnp.asarray(q))))


def test_nb_argmax_tie_goes_to_the_lowest_class():
    """Classes 1 and 2 are trained on the same rows, so their log-scores
    are equal bit for bit: ``jnp.argmax`` and ``torch.argmax`` both answer
    the lower id, and every class ties on a query of zeros."""
    x = np.array([[6, 0], [1, 2], [1, 2]], np.float32)
    y = np.array([0, 1, 2], np.int32)
    jm, tm = nb_both(x, y, 3, 1.0)
    q = np.array([[0, 3], [0, 0], [4, 0]], np.float32)
    want = np.asarray(jnb(JAX).nb_predict(jm, jnp.asarray(q)))
    got = jnb(PORT).nb_predict(tm, torch.from_numpy(q)).numpy()
    scores = jnb(PORT).nb_log_scores(tm, torch.from_numpy(q)).numpy()
    assert scores[0, 1] == scores[0, 2] > scores[0, 0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 0, 0])


def test_nb_fit_predict():
    """tests/test_ops_and_e2.py::test_nb_fit_predict through the port, its
    predictions those of the JAX package."""
    rng = np.random.default_rng(1)
    n = 200
    labels = rng.integers(0, 2, n)
    feats = np.zeros((n, 4), np.float32)
    for i, y in enumerate(labels):
        base = 0 if y == 0 else 2
        feats[i, base] = rng.integers(3, 8)
        feats[i, base + 1] = rng.integers(1, 5)
        feats[i, rng.integers(0, 4)] += 1  # noise
    jm, tm = nb_both(feats, labels.astype(np.int32), 2, 1.0)
    assert jnb(PORT).nb_accuracy(tm, feats, labels) > 0.95
    assert jnb(PORT).nb_accuracy(tm, feats, labels) == \
        jnb(JAX).nb_accuracy(jm, feats, labels)
    single = jnb(PORT).nb_predict(tm, torch.from_numpy(feats[:1]))
    assert int(single[0]) == labels[0]


def lr_both(x, y, c, **kw):
    jm = jlr(JAX).logreg_fit(jnp.asarray(x), jnp.asarray(y, jnp.int32),
                             n_classes=c, **kw)
    tm = jlr(PORT).logreg_fit(torch.from_numpy(x), torch.from_numpy(y),
                              n_classes=c, **kw)
    return jm, tm


@pytest.mark.parametrize("l2", [1e-4, 1e-2])
def test_logreg_fit_equals_jax(l2):
    """300 Adam steps at lr 0.1: the explicit loss (the penalty on the
    weights alone) under ``torch.optim.Adam`` follows ``optax.adam``
    within 2e-5 (max |w| about 1.5; f32 rounding of the two programs)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(500, 3)).astype(np.float32)
    w_true = rng.normal(size=(3, 4)).astype(np.float32)
    y = (x @ w_true + rng.normal(0, 0.5, (500, 4))).argmax(1).astype(
        np.int32)
    jm, tm = lr_both(x, y, 4, steps=300, learning_rate=0.1, l2=l2)
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               atol=2e-5)
    np.testing.assert_allclose(tm.bias.numpy(), np.asarray(jm.bias),
                               atol=2e-5)
    np.testing.assert_allclose(
        jlr(PORT).logreg_proba(tm, torch.from_numpy(x)).numpy(),
        np.asarray(jlr(JAX).logreg_proba(jm, jnp.asarray(x))), atol=1e-6)
    np.testing.assert_array_equal(
        jlr(PORT).logreg_predict(tm, torch.from_numpy(x)).numpy(),
        np.asarray(jlr(JAX).logreg_predict(jm, jnp.asarray(x))))


def test_logreg_penalty_spares_the_bias():
    """A large l2 shrinks the weights toward 0 but leaves the bias free to
    fit the class priors, in both packages (Adam's ``weight_decay`` would
    shrink the bias too)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(400, 2)).astype(np.float32)
    y = np.where(rng.random(400) < 0.8, 0, 1).astype(np.int32)
    jm, tm = lr_both(x, y, 2, steps=300, learning_rate=0.1, l2=10.0)
    assert float(tm.weights.abs().max()) < 1e-2
    gap = float(tm.bias[0] - tm.bias[1])
    assert gap == pytest.approx(np.log(0.8 / 0.2), abs=0.15)
    np.testing.assert_allclose(tm.bias.numpy(), np.asarray(jm.bias),
                               atol=2e-5)


def test_logreg_fit_predict():
    """tests/test_ops_and_e2.py::test_logreg_fit_predict through the port."""
    rng = np.random.default_rng(2)
    n = 300
    x = rng.normal(size=(n, 3)).astype(np.float32)
    w_true = np.array([[2.0, -1.0], [-2.0, 1.5], [0.5, 0.5]], np.float32)
    y = (x @ w_true).argmax(axis=1).astype(np.int32)
    jm, tm = lr_both(x, y, 2, steps=200)
    assert jlr(PORT).logreg_accuracy(tm, x, y) > 0.95
    assert jlr(PORT).logreg_accuracy(tm, x, y) == \
        jlr(JAX).logreg_accuracy(jm, x, y)


# ---------------------------------------------------------------------------
# the template (tests/test_other_templates.py's classification cases)
# ---------------------------------------------------------------------------

def seed_classification(p, app_id):
    """tests/test_other_templates.py ``seed_classification``."""
    rng = np.random.default_rng(0)
    events = []
    for n in range(80):
        plan = float(n % 2)
        attrs = (
            {"attr0": int(rng.integers(5, 10)),
             "attr1": int(rng.integers(0, 3)),
             "attr2": int(rng.integers(0, 2))}
            if plan == 1.0 else
            {"attr0": int(rng.integers(0, 2)),
             "attr1": int(rng.integers(0, 3)),
             "attr2": int(rng.integers(5, 10))})
        events.append(p.Event(event="$set", entity_type="user",
                              entity_id=f"u{n}",
                              properties=p.DataMap({"plan": plan, **attrs})))
    p.insert(app_id, events)


def clf_params(p, **ds):
    c = clf(p)
    return p.engine_params(
        c.DataSourceParams(app_name="clf", **ds),
        [("naive", c.NaiveBayesAlgorithmParams(lambda_=1.0)),
         ("logreg", c.LogRegAlgorithmParams(steps=200))])


def trained(p):
    seed_classification(p, p.seed_app("clf"))
    engine = clf(p).ClassificationEngine().apply()
    ep = clf_params(p)
    iid = p.run_train(engine, ep)
    return engine, ep, p.load_models(iid, engine, ep)


@BOTH
def test_classification_template(p):
    engine, ep, models = trained(p)
    nb_algo, lr_algo = p.algorithms(engine, ep)
    q_plan1 = clf(p).Query(features=(8.0, 1.0, 0.0))
    q_plan0 = clf(p).Query(features=(0.0, 1.0, 8.0))
    assert nb_algo.predict(models[0], q_plan1).label == 1.0
    assert nb_algo.predict(models[0], q_plan0).label == 0.0
    assert lr_algo.predict(models[1], q_plan1).label == 1.0
    assert lr_algo.predict(models[1], q_plan0).label == 0.0


def grid_queries(p):
    return [clf(p).Query(features=(float(a), float(b), float(c)))
            for a in range(0, 10, 3) for b in range(3) for c in range(0, 10, 3)]


def test_classification_answers_equal_across_packages():
    """Both packages trained on the same events: the same models (naive
    Bayes within 1e-6, logistic regression within 2e-5) and the same label
    for every query of a grid over the attributes."""
    (je, jep, jms), (te, tep, tms) = trained(JAX), trained(PORT)
    assert tms[0].label_values == jms[0].label_values == (0.0, 1.0)
    np.testing.assert_allclose(tms[0].nb.theta.numpy(),
                               np.asarray(jms[0].nb.theta), atol=1e-6)
    np.testing.assert_allclose(tms[1].lr.weights.numpy(),
                               np.asarray(jms[1].lr.weights), atol=2e-5)
    for ja, ta, jm, tm in zip(JAX.algorithms(je, jep),
                              PORT.algorithms(te, tep), jms, tms):
        for jq, tq in zip(grid_queries(JAX), grid_queries(PORT)):
            assert ta.predict(tm, tq).label == ja.predict(jm, jq).label


@BOTH
def test_classification_wire_format(p):
    q = p.codec.extract(clf(p).Query, {"features": [1.0, 2.0, 3.0]})
    assert q.features == (1.0, 2.0, 3.0)
    assert p.codec.to_jsonable(clf(p).PredictedResult(label=2.0)) == \
        {"label": 2.0}


def test_port_model_lives_on_its_device():
    """A trained model's tensors are on the context's device; a model
    decoded from a blob (host numpy) is put there by ``prepare_model``."""
    engine, ep, models = trained(PORT)
    assert models[0].nb.theta.device.type == CPU
    blob = PORT.checkpoint.serialize_models(models, "x", PORT.ctx())
    decoded = PORT.checkpoint.deserialize_models(blob)
    assert isinstance(decoded[0].nb.theta, np.ndarray)
    algos = PORT.algorithms(engine, ep)
    put = [a.prepare_model(PORT.ctx(), m) for a, m in zip(algos, decoded)]
    assert isinstance(put[0].nb.theta, torch.Tensor)
    assert put[1].lr.weights.dtype == torch.float32
    for a, m in zip(algos, put):
        assert a.predict(m, clf(PORT).Query(features=(8.0, 1.0, 0.0))) \
            .label == 1.0


# ---------------------------------------------------------------------------
# pio eval, JAX blobs, the quickstarts' factories
# ---------------------------------------------------------------------------

def jax_evaluation(make_metric):
    """The JAX package's twin of ``chip_smoke.CLF_EVAL_MODULE``."""
    c = clf(JAX)
    evaluation = JAX.evaluation.Evaluation()
    evaluation.engine_metric = (c.ClassificationEngine().apply(),
                                make_metric())
    eps = [JAX.engine_params(
        c.DataSourceParams(app_name="clf-app", eval_k=3),
        [("naive", c.NaiveBayesAlgorithmParams(lambda_=lam))])
        for lam in (1.0, 10.0)]
    return evaluation, eps


def test_pio_eval_through_the_port_cli_matches_jax(tmp_path):
    """``pio eval`` of chip_smoke's evaluation module through the port's
    CLI, and the JAX package's ``run_evaluation`` of the same objects, on
    the same planted users: the same stored one-liner and scores."""
    import chip_smoke

    plan, attrs = chip_smoke.clf_users(240)
    for p in PKGS:
        p.insert(p.seed_app("clf-app"), [
            p.Event(event="$set", entity_type="user", entity_id=f"u{k}",
                    properties=p.DataMap({"attr0": int(a[0]),
                                          "attr1": int(a[1]),
                                          "attr2": int(a[2]),
                                          "plan": int(pl)}))
            for k, (pl, a) in enumerate(zip(plan, attrs))])
    one_liner, port_json = chip_smoke.pio_eval(
        str(tmp_path), torch.device(CPU), "clf_evaluation",
        chip_smoke.CLF_EVAL_MODULE.format(app="clf-app"))
    evaluation, eps = jax_evaluation(
        clf(JAX).engine.AccuracyMetric)
    iid, _result = JAX.CoreWorkflow.run_evaluation(evaluation, eps)
    inst = JAX.Storage.get_meta_data_evaluation_instances().get(iid)
    assert one_liner == inst.evaluator_results
    jax_json = json.loads(inst.evaluator_results_json)
    assert port_json["bestIdx"] == jax_json["bestIdx"]
    assert [s["score"] for s in port_json["engineParamsScores"]] == \
        [s["score"] for s in jax_json["engineParamsScores"]]
    assert port_json == jax_json


def test_jax_blob_resolves_in_the_port():
    """A JAX-trained classification instance's blob decodes in the port
    (its classes by name) and answers as the JAX models do."""
    je, jep, jms = trained(JAX)
    blob = JAX.checkpoint.serialize_models(jms, "inst", JAX.ctx())
    restored = PORT.checkpoint.deserialize_models(blob)
    engine = clf(PORT).ClassificationEngine().apply()
    ep = clf_params(PORT)
    algos = PORT.algorithms(engine, ep)
    assert type(restored[0]) is clf(PORT).engine.NBModel
    assert type(restored[1].lr) is jlr(PORT).LogRegModel
    tms = [a.prepare_model(PORT.ctx(), m) for a, m in zip(algos, restored)]
    for ja, ta, jm, tm in zip(JAX.algorithms(je, jep), algos, jms, tms):
        for jq, tq in zip(grid_queries(JAX), grid_queries(PORT)):
            assert ta.predict(tm, tq).label == ja.predict(jm, jq).label


@pytest.mark.parametrize("name, factory", [
    ("classification", "models.classification.engine:ClassificationEngine"),
    ("regression", "models.regression.engine:RegressionEngine"),
    ("friendrecommendation",
     "models.friendrecommendation.engine:FriendRecommendationEngine"),
    ("stock", "models.stock.engine:StockEngine"),
])
def test_quickstart_factory_resolves_to_the_port(name, factory):
    """Each quickstart's engine.json names the JAX package's factory; the
    port's CLI resolves it to its own module by name, with no map edited,
    and reads the variant's params as the JAX package does."""
    from incubator_predictionio_tpu_torch.cli import commands

    with open(os.path.join(REPO, "examples", f"{name}-quickstart",
                           "engine.json")) as f:
        variant = json.load(f)
    assert variant["engineFactory"].startswith("incubator_predictionio_tpu.")
    engine, ep = commands.engine_from_variant(variant)
    module, _, cls = factory.partition(":")
    got = commands.resolve_engine_factory(variant["engineFactory"])
    assert type(got) is getattr(PORT.mod(module), cls)
    jax_factory = getattr(JAX.mod(module), cls)()
    jax_ep = jax_factory.apply().jvalue_to_engine_params(variant)
    assert ep.to_jsonable() == jax_ep.to_jsonable()


def test_chip_smoke_classification_leg_rehearses_on_the_cpu():
    """chip_smoke.py's classification leg at its small size on the CPU:
    ``pio train`` and ``pio eval`` in process, the served labels the f64
    host argmax, the logistic regression equal to its CPU fit."""
    import chip_smoke
    from incubator_predictionio_tpu_torch import runtime
    from incubator_predictionio_tpu_torch.servers import (
        prediction_server as server_mod,
    )

    err, stats = chip_smoke.classification_leg(torch.device(CPU),
                                               server_mod, small=True)
    assert err == 0.0 and stats["near_ties"] == 0
    assert max(stats["accuracy"]) > 1 / 3 + chip_smoke.CLF_ACCURACY_MARGIN
