"""The port's evaluation (``core/metrics.py``, ``core/evaluation.py``,
``core/fast_eval.py``, ``Engine.eval`` / ``batch_eval``,
``CoreWorkflow.run_evaluation``, ``workflow/fake.py``, ``e2/``, the
recommendation template's ``read_eval`` and ``PrecisionAtK``, the sequence
engine's ``HitAtK`` and ``pio eval``) against the JAX package's, on the
CPU, each package on a memory store of its own with the same events:

- the cases of tests/test_metrics.py, tests/test_fast_eval.py, the e2
  cases of tests/test_ops_and_e2.py and tests/test_workflow.py's
  ``test_run_evaluation_lifecycle``, through both packages, on a fake
  engine built from each package's bases (tests/fake_engine.py's), with
  equal results;
- planted discrimination: tests/test_quality_planted.py's 60 × 40
  preference-biased ratings through both packages' ``run_evaluation``
  (an untrained and a trained candidate, ``PrecisionAtK(k=5)``,
  ``eval_k`` 3), the port's ``als_init`` patched to the JAX init: the
  same winner, the same ``best.json``, and per candidate the same
  Precision@5, where a served top-5 slot may differ only at a near-tie
  (``NEAR_TIE``: JAX scores within 1e-5 relative for the untrained
  candidate, whose factors are the shared init; within 2e-3 relative for
  the trained one, whose factors the two packages' solvers reach within
  1e-3 relative, tests/test_torch_als.py);
- the recommendation ``read_eval`` folds, fold for fold;
- ``HitAtK`` on the same (query, prediction, actual) triples;
- ``pio eval`` through the port's CLI (a child process on a SQLite
  store), and its refusal of an evaluation module that imports the JAX
  package.
"""

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "incubator_predictionio_tpu_torch.cli.main"]
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
    def __init__(self, name: str, pkg: str):
        self.name = name

        def mod(path):
            return importlib.import_module(f"{pkg}.{path}")

        self.base = mod("core.base")
        self.engine = mod("core.engine")
        self.params = mod("core.params")
        self.metrics = mod("core.metrics")
        self.evaluation = mod("core.evaluation")
        self.fast_eval = mod("core.fast_eval")
        self.context = mod("parallel.context")
        self.storage = mod("data.storage")
        self.workflow = mod("workflow.workflow")
        self.fake = mod("workflow.fake")
        self.e2 = mod("e2")
        self.rec = mod("models.recommendation.engine")
        self.seq = mod("models.sequence.engine")
        self.Event = mod("data.event").Event
        self.DataMap = mod("data.datamap").DataMap
        self.Storage = self.storage.Storage
        self.CoreWorkflow = self.workflow.CoreWorkflow

    def ctx(self):
        return (self.context.RuntimeContext(device=CPU) if self.name == "port"
                else self.context.RuntimeContext())

    def run_evaluation(self, *args, **kw):
        if self.name == "port":
            kw["device"] = CPU
        return self.CoreWorkflow.run_evaluation(*args, **kw)


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


# ---------------------------------------------------------------------------
# tests/fake_engine.py, built from either package's bases
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainingData:
    ds_id: int


@dataclasses.dataclass(frozen=True)
class EvalInfo:
    ds_id: int
    ex: int


@dataclasses.dataclass(frozen=True)
class PreparedData:
    ds_id: int
    pp_id: int


@dataclasses.dataclass(frozen=True)
class Model:
    ds_id: int
    pp_id: int
    ap_id: int


@dataclasses.dataclass(frozen=True)
class Query:
    qx: int


@dataclasses.dataclass(frozen=True)
class Prediction:
    model: Model
    qx: int


@dataclasses.dataclass(frozen=True)
class Actual:
    qx: int


def fake(p, calls=None):
    """tests/fake_engine.py's Engine0 family on package ``p``'s bases;
    ``calls`` counts reads, prepares and trains (test_fast_eval.py)."""
    b = p.base
    calls = {} if calls is None else calls
    ns = types.SimpleNamespace(calls=calls)

    @dataclasses.dataclass(frozen=True)
    class DSP(b.Params):
        id: int = 0

    @dataclasses.dataclass(frozen=True)
    class PP(b.Params):
        id: int = 0

    @dataclasses.dataclass(frozen=True)
    class AP(b.Params):
        id: int = 0
        mult: int = 1

    @dataclasses.dataclass(frozen=True)
    class SP(b.Params):
        id: int = 0

    def count(what):
        calls[what] = calls.get(what, 0) + 1

    class DataSource0(b.DataSource):
        def __init__(self, params: DSP = DSP()):
            super().__init__(params)

        def read_training(self, ctx):
            return TrainingData(ds_id=self.params.id)

        def read_eval(self, ctx):
            count("read")
            return [(TrainingData(self.params.id),
                     EvalInfo(self.params.id, ex),
                     [(Query(qx), Actual(qx)) for qx in range(3)])
                    for ex in range(2)]

    class Preparator0(b.Preparator):
        def __init__(self, params: PP = PP()):
            super().__init__(params)

        def prepare(self, ctx, td):
            count("prepare")
            return PreparedData(ds_id=td.ds_id, pp_id=self.params.id)

    class Algorithm0(b.Algorithm):
        offset = 0

        def __init__(self, params: AP = AP()):
            super().__init__(params)

        def train(self, ctx, pd):
            count("train")
            return Model(pd.ds_id, pd.pp_id, self.offset + self.params.id)

        def predict(self, model, query):
            return Prediction(model=model, qx=query.qx)

    class Algorithm1(Algorithm0):
        offset = 100

    class Serving0(b.Serving):
        def __init__(self, params: SP = SP()):
            super().__init__(params)

        def serve(self, query, predictions):
            return predictions[0]

    class SupplementServing(b.Serving):
        def supplement(self, query):
            return Query(qx=query.qx + 1000)

        def serve(self, query, predictions):
            assert query.qx < 1000, "serve must receive the original query"
            return predictions[0]

    class QxMetric(p.metrics.Metric):
        """Mean of prediction.model.ap_id."""

        def calculate(self, ctx, eval_data_set):
            scores = [pr.model.ap_id for _i, qpas in eval_data_set
                      for _q, pr, _a in qpas]
            return sum(scores) / len(scores) if scores else float("nan")

    def make_engine(cls=p.engine.Engine, serving=Serving0):
        return cls(DataSource0, Preparator0,
                   {"algo0": Algorithm0, "algo1": Algorithm1}, serving)

    def params(ds=1, pp=2, algos=None, sp=4):
        return p.params.EngineParams(
            data_source_params=("", DSP(ds)),
            preparator_params=("", PP(pp)),
            algorithm_params_list=list(algos or [("algo0", AP(3))]),
            serving_params=("", SP(sp)))

    ns.__dict__.update(DSP=DSP, PP=PP, AP=AP, SP=SP,
                       DataSource0=DataSource0, Preparator0=Preparator0,
                       Algorithm0=Algorithm0, Algorithm1=Algorithm1,
                       Serving0=Serving0,
                       SupplementServing=SupplementServing,
                       QxMetric=QxMetric, make_engine=make_engine,
                       params=params)
    return ns


# ---------------------------------------------------------------------------
# tests/test_metrics.py, through both packages
# ---------------------------------------------------------------------------

def qpa_metric(p, base, optional=False):
    class M(getattr(p.metrics, base)):
        def calculate_qpa(self, q, pr, a):
            return None if (optional and q is None) else float(q)
    return M()


def eds(*qs):
    return [(None, [(q, None, None) for q in qs])]


@BOTH
def test_average_metric(p):
    m = qpa_metric(p, "AverageMetric")
    assert m.calculate(p.ctx(), eds(1, 2, 3, 6)) == 3.0
    assert m.calculate(p.ctx(), eds(1, 2) + eds(3, 6)) == 3.0


@BOTH
def test_option_average_skips_none(p):
    m = qpa_metric(p, "OptionAverageMetric", optional=True)
    assert m.calculate(p.ctx(), eds(1, None, 3, None, 5)) == 3.0
    assert math.isnan(m.calculate(p.ctx(), eds(None, None)))


@BOTH
def test_stdev_metrics(p):
    m = qpa_metric(p, "StdevMetric")
    assert m.calculate(p.ctx(), eds(2, 2, 2)) == 0.0
    assert m.calculate(p.ctx(), eds(1, 3)) == 1.0
    om = qpa_metric(p, "OptionStdevMetric", optional=True)
    assert om.calculate(p.ctx(), eds(1, None, 3)) == 1.0


@BOTH
def test_sum_and_zero(p):
    assert qpa_metric(p, "SumMetric").calculate(p.ctx(), eds(1, 2, 3)) == 6.0
    assert p.metrics.ZeroMetric().calculate(p.ctx(), eds(1, 2)) == 0.0


@BOTH
def test_compare_ordering(p):
    m = qpa_metric(p, "AverageMetric")
    assert m.compare(2.0, 1.0) > 0
    assert m.compare(1.0, 2.0) < 0
    assert m.compare(1.0, 1.0) == 0


def test_metric_values_equal_across_packages():
    rng = np.random.default_rng(5)
    sets = [eds(*rng.normal(size=7).tolist()),
            eds(*rng.normal(size=3).tolist()) + eds(4.5, None, 2.0)]
    for base in ("AverageMetric", "OptionAverageMetric", "StdevMetric",
                 "OptionStdevMetric", "SumMetric"):
        opt = base.startswith("Option")
        for data in sets if opt else sets[:1]:
            j, t = (qpa_metric(p, base, optional=opt).calculate(p.ctx(), data)
                    for p in PKGS)
            assert t == j, base


def _evaluate_three(p, tmp_path):
    f = fake(p)
    engine = f.make_engine()
    eps = [f.params(algos=[("algo0", f.AP(i))]) for i in (1, 5, 3)]
    data = engine.batch_eval(p.ctx(), eps)
    best = tmp_path / f"best-{p.name}.json"
    evaluator = p.evaluation.MetricEvaluator(f.QxMetric(),
                                             output_path=str(best))
    return evaluator.evaluate(p.ctx(), None, data), best


@BOTH
def test_metric_evaluator_picks_best(p, tmp_path):
    result, best = _evaluate_three(p, tmp_path)
    assert result.best_idx == 1
    assert result.best_score.score == 5.0
    assert result.best_engine_params.algorithm_params_list[0][1].id == 5
    assert best.exists()
    assert "5" in result.to_one_liner()
    assert "<table" in result.to_html()
    assert result.to_jsonable()["bestIdx"] == 1


def test_metric_evaluator_results_equal_across_packages(tmp_path):
    (jr, jbest), (tr, tbest) = (_evaluate_three(p, tmp_path) for p in PKGS)
    assert tr.to_jsonable() == jr.to_jsonable()
    assert tr.to_one_liner() == jr.to_one_liner()
    assert tr.to_html() == jr.to_html()
    assert tbest.read_text() == jbest.read_text()
    with pytest.raises(ValueError, match="at least one"):
        PORT.evaluation.MetricEvaluator().evaluate(PORT.ctx(), None, [])


@BOTH
def test_evaluation_dsl_wiring(p):
    f = fake(p)
    ev = p.evaluation.Evaluation()
    engine = f.make_engine()
    ev.engine_metric = (engine, f.QxMetric())
    eng, evaluator = ev.engine_evaluator
    assert eng is engine
    assert isinstance(evaluator, p.evaluation.MetricEvaluator)
    with pytest.raises(RuntimeError):
        ev.engine = engine  # assign-once
    ev2 = p.evaluation.Evaluation()
    ev2.engine_metrics = (engine, f.QxMetric(), [f.QxMetric()])
    assert len(ev2.evaluator.other_metrics) == 1


@BOTH
def test_evaluation_requires_assignment(p):
    ev = p.evaluation.Evaluation()
    with pytest.raises(RuntimeError):
        _ = ev.engine
    with pytest.raises(RuntimeError):
        _ = ev.evaluator


# ---------------------------------------------------------------------------
# Engine.eval: the original query to serve, predictions joined by index
# ---------------------------------------------------------------------------

def _plain(out):
    """batch_eval output with each candidate's EngineParams dropped."""
    return [data for _ep, data in out]


@BOTH
def test_engine_eval_supplements_and_joins_by_query(p):
    f = fake(p)
    engine = f.make_engine(serving=f.SupplementServing)
    ep = f.params(algos=[("algo0", f.AP(2)), ("algo1", f.AP(7))])
    out = engine.eval(p.ctx(), ep)
    assert [info for info, _ in out] == [EvalInfo(1, 0), EvalInfo(1, 1)]
    for _info, qpas in out:
        assert [(q.qx, a.qx) for q, _p, a in qpas] == [(i, i)
                                                       for i in range(3)]
        for q, pred, _a in qpas:
            assert pred.qx == q.qx + 1000  # the algorithms saw the mark
            assert pred.model.ap_id == 2   # the first algorithm's


def test_engine_eval_equal_across_packages():
    outs = []
    for p in PKGS:
        f = fake(p)
        eps = [f.params(algos=[("algo0", f.AP(i)), ("algo1", f.AP(i))])
               for i in (1, 2)] + [f.params(ds=4, sp=9)]
        outs.append(_plain(f.make_engine().batch_eval(p.ctx(), eps)))
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# tests/test_fast_eval.py, through both packages
# ---------------------------------------------------------------------------

def make_fast(p, calls):
    return fake(p, calls).make_engine(cls=p.fast_eval.FastEvalEngine)


def _fast_eps(p, calls, variants):
    f = fake(p, calls)
    return [f.params(ds=v.get("ds", 1), pp=v.get("pp", 2),
                     algos=[("algo0", f.AP(v.get("ap", 3)))],
                     sp=v.get("sp", 4)) for v in variants]


@BOTH
@pytest.mark.parametrize("variants,expect", [
    ([{"sp": 1}, {"sp": 2}, {"sp": 3}], (1, 2, 2)),   # serving only
    ([{"ap": 1}, {"ap": 2}], (1, 2, 4)),              # algorithm params
    ([{"ds": 1}, {"ds": 2}], (2, 4, 4)),              # data source params
], ids=["serving_only_reuses_everything", "algo_reuses_prepared",
        "data_source_recomputes"])
def test_fast_eval_prefix_caches(p, variants, expect):
    calls = {}
    engine = make_fast(p, calls)
    out = engine.batch_eval(p.ctx(), _fast_eps(p, calls, variants))
    assert len(out) == len(variants)
    assert (calls.get("read"), calls.get("prepare"),
            calls.get("train")) == expect


def test_fast_eval_results_match_plain_engine_across_packages():
    """test_fast_eval.py::test_results_match_plain_engine in both packages,
    and the port's results equal to the JAX package's."""
    outs = {}
    for p in PKGS:
        calls = {}
        variants = [{"ap": 1}, {"ap": 2}, {"sp": 9}]
        fast = make_fast(p, calls).batch_eval(
            p.ctx(), _fast_eps(p, calls, variants))
        plain = fake(p).make_engine().batch_eval(
            p.ctx(), _fast_eps(p, {}, variants))
        assert _plain(fast) == _plain(plain), p.name
        assert p.fast_eval.FastEvalEngineWorkflow.__pio_api__ == \
            "Experimental"
        outs[p.name] = _plain(fast)
    assert outs["port"] == outs["jax"]


# ---------------------------------------------------------------------------
# tests/test_workflow.py::test_run_evaluation_lifecycle, workflow/fake.py
# ---------------------------------------------------------------------------

@BOTH
def test_run_evaluation_lifecycle(p):
    f = fake(p)
    evaluation = p.evaluation.Evaluation()
    evaluation.engine_metric = (f.make_engine(), f.QxMetric())
    candidates = [f.params(algos=[("algo0", f.AP(i))]) for i in (1, 4, 2)]
    instance_id, result = p.run_evaluation(
        evaluation, candidates, evaluation_class="tests.Eval")
    assert result.best_score.score == 4.0
    instances = p.Storage.get_meta_data_evaluation_instances()
    inst = instances.get(instance_id)
    assert inst.status == "EVALCOMPLETED"
    assert "4.0" in inst.evaluator_results
    assert json.loads(inst.evaluator_results_json) == result.to_jsonable()
    assert "<table" in inst.evaluator_results_html
    assert inst.evaluation_class == "tests.Eval"
    assert instances.get_completed()[0].id == instance_id


@BOTH
def test_run_evaluation_aborts_on_error(p):
    f = fake(p)

    class Boom(f.QxMetric):
        def calculate(self, ctx, eval_data_set):
            raise RuntimeError("metric boom")

    evaluation = p.evaluation.Evaluation()
    evaluation.engine_metric = (f.make_engine(), Boom())
    with pytest.raises(RuntimeError, match="metric boom"):
        p.run_evaluation(evaluation, [f.params()])
    [inst] = p.Storage.get_meta_data_evaluation_instances().get_all()
    assert inst.status == "EVALABORTED"
    assert not p.Storage.get_meta_data_evaluation_instances().get_completed()


@BOTH
def test_fake_run_through_run_evaluation(p):
    ran = []

    class Hello(p.fake.FakeRun):
        def __init__(self):
            super().__init__()
            self.func = lambda ctx: ran.append(type(ctx).__name__)

    hello = Hello()
    iid, result = p.run_evaluation(hello, hello.engine_params_list)
    assert ran == ["RuntimeContext"]
    assert result.no_save and result.to_one_liner() == "FakeEvalResult"
    inst = p.Storage.get_meta_data_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED" and inst.evaluator_results == ""
    with pytest.raises(RuntimeError):
        p.fake.FakeEngine().train()


# ---------------------------------------------------------------------------
# the e2 cases of tests/test_ops_and_e2.py, through both packages
# ---------------------------------------------------------------------------

@BOTH
def test_categorical_naive_bayes(p):
    LP, NB = p.e2.LabeledPoint, p.e2.CategoricalNaiveBayes
    points = [LP("spam", ("viagra", "now")), LP("spam", ("viagra", "later")),
              LP("ham", ("hello", "now")), LP("ham", ("hello", "later")),
              LP("ham", ("meeting", "now"))]
    model = NB.train(points)
    assert model.predict(("viagra", "now")) == "spam"
    assert model.predict(("hello", "later")) == "ham"
    assert model.log_score(LP("spam", ("unseen", "now"))) == float("-inf")
    score2 = model.log_score(
        LP("spam", ("unseen", "now")),
        default_likelihood=lambda ls: min(ls) if ls else float("-inf"))
    assert np.isfinite(score2)
    assert model.log_score(LP("nope", ("a", "b"))) is None
    with pytest.raises(ValueError):
        model.log_score(LP("spam", ("only-one",)))
    with pytest.raises(ValueError):
        NB.train([])


def test_naive_bayes_equal_across_packages():
    rng = np.random.default_rng(7)
    rows = [(str(rng.integers(3)),
             tuple(str(v) for v in rng.integers(4, size=3)))
            for _ in range(60)]
    models = [p.e2.CategoricalNaiveBayes.train(
        [p.e2.LabeledPoint(lab, f) for lab, f in rows]) for p in PKGS]
    assert models[1].priors == models[0].priors
    assert models[1].likelihoods == models[0].likelihoods
    for _lab, feats in rows[:20]:
        assert models[1].predict(feats) == models[0].predict(feats)


@BOTH
def test_markov_chain(p):
    model = p.e2.MarkovChain.train(rows=[0, 0, 1], cols=[1, 2, 0],
                                   counts=[3, 1, 2], top_n=2)
    assert model.predict([0, 1]) == [1, 0]
    assert model.predict([9]) == [-1]
    assert model.top_n(0) == [(1, 0.75), (2, 0.25)]


def test_markov_chain_equal_across_packages():
    rng = np.random.default_rng(8)
    rows, cols = rng.integers(0, 6, 40), rng.integers(0, 6, 40)
    counts = rng.integers(1, 5, 40)
    a, b = (p.e2.MarkovChain.train(rows, cols, counts, top_n=3)
            for p in PKGS)
    assert b.transitions == a.transitions and b.n == a.n


@BOTH
def test_binary_vectorizer(p):
    vec = p.e2.BinaryVectorizer.fit([("color", "red"), ("color", "blue"),
                                     ("size", "L")])
    assert vec.n == 3
    assert vec.transform({"color": "red", "size": "L"}).sum() == 2.0
    assert vec.transform({"color": "green"}).sum() == 0.0
    batch = vec.transform_batch([{"color": "blue"}, {}])
    assert batch.shape == (2, 3) and batch[1].sum() == 0
    assert vec.transform_batch([]).shape == (0, 3)
    other = PKGS[0].e2.BinaryVectorizer.fit([("color", "red"),
                                             ("color", "blue"), ("size", "L")])
    np.testing.assert_array_equal(
        vec.transform_batch([{"color": "blue", "size": "L"}]),
        other.transform_batch([{"color": "blue", "size": "L"}]))


@BOTH
def test_split_data(p):
    data = list(range(10))
    folds = p.e2.split_data(3, data, lambda d: (f"q{d}", f"a{d}"))
    assert len(folds) == 3
    train0, idx0, qa0 = folds[0]
    assert idx0 == 0
    assert 0 not in train0 and 3 not in train0
    assert ("q0", "a0") in qa0
    assert len([q for _t, _i, qa in folds for q, _a in qa]) == 10
    with pytest.raises(ValueError):
        p.e2.split_data(1, data, lambda d: (d, d))
    assert folds == JAX.e2.split_data(3, data, lambda d: (f"q{d}", f"a{d}"))


# ---------------------------------------------------------------------------
# the recommendation template: read_eval, PrecisionAtK, planted ratings
# ---------------------------------------------------------------------------

N_USERS, N_ITEMS, PLANT_RANK = 60, 40, 3
SIGMA = 0.2
DENSITY = 0.5


def planted_triples(seed=11):
    """tests/test_quality_planted.py's fixture: ratings 3.5 + U·Vᵀ + N(0, σ)
    with preference-biased observation (each user picks items with
    probability ∝ exp(2·(true score − max)))."""
    rng = np.random.default_rng(seed)
    u_true = rng.normal(0, 1 / np.sqrt(PLANT_RANK), (N_USERS, PLANT_RANK))
    v_true = rng.normal(0, 1.0, (N_ITEMS, PLANT_RANK))
    per_user = int(DENSITY * N_ITEMS)
    users_l, items_l = [], []
    for u in range(N_USERS):
        scores = u_true[u] @ v_true.T
        w = np.exp(2.0 * (scores - scores.max()))
        picks = rng.choice(N_ITEMS, size=per_user, replace=False,
                           p=w / w.sum())
        users_l.extend([u] * per_user)
        items_l.extend(picks.tolist())
    users, items = np.asarray(users_l), np.asarray(items_l)
    ratings = (3.5 + np.einsum("nk,nk->n", u_true[users], v_true[items])
               + rng.normal(0, SIGMA, len(users)))
    return users, items, ratings


def seed_planted(name="planted"):
    users, items, ratings = planted_triples()
    for p in PKGS:
        p.Storage.get_meta_data_apps().insert(p.storage.App(0, name))
        app_id = p.Storage.get_meta_data_apps().get_by_name(name).id
        dao = p.Storage.get_events()
        for u, i, r in zip(users, items, ratings):
            dao.insert(p.Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=p.DataMap({"rating": float(r)})), app_id)


def rec_params(p, lambda_=0.05, rank=8, eval_k=0, iterations=12,
               app="planted"):
    return p.params.EngineParams(
        data_source_params=("", p.rec.DataSourceParams(app_name=app,
                                                       eval_k=eval_k)),
        algorithm_params_list=[("als", p.rec.ALSAlgorithmParams(
            rank=rank, num_iterations=iterations, lambda_=lambda_,
            seed=7))])


def _jax_init(monkeypatch):
    """The port's ``als_init`` patched to the JAX package's."""
    import jax

    import incubator_predictionio_tpu.ops.als as jals
    from incubator_predictionio_tpu_torch.ops import als

    def init(gen, n_users, n_items, rank, device=None, scale=0.1):
        st = jals.als_init(jax.random.key(int(gen.initial_seed())), n_users,
                           n_items, rank)
        return als.ALSState(
            torch.from_numpy(np.array(st.user_factors)).to(device),
            torch.from_numpy(np.array(st.item_factors)).to(device))

    monkeypatch.setattr(als, "als_init", init)


def test_read_eval_folds_equal_jax():
    seed_planted()
    folds = []
    for p in PKGS:
        ds = p.rec.RecommendationDataSource(
            p.rec.DataSourceParams(app_name="planted", eval_k=3,
                                   eval_queries_num=7))
        folds.append(ds.read_eval(p.ctx()))
    (jf, tf) = folds
    assert len(tf) == len(jf) == 3
    for (jtd, jinfo, jqa), (ttd, tinfo, tqa) in zip(jf, tf):
        assert tinfo.fold == jinfo.fold
        for f in ("user_idx", "item_idx", "values"):
            np.testing.assert_array_equal(getattr(ttd.interactions, f),
                                          getattr(jtd.interactions, f))
        assert list(ttd.interactions.user_ids) == \
            list(jtd.interactions.user_ids)
        assert [(q.user, q.num, q.exclude_seen, a.items) for q, a in tqa] \
            == [(q.user, q.num, q.exclude_seen, a.items) for q, a in jqa]
    assert PORT.rec.RecommendationDataSource(PORT.rec.DataSourceParams(
        app_name="planted")).read_eval(PORT.ctx()) == []


@BOTH
def test_precision_at_k(p):
    r = p.rec
    pred = r.PredictedResult(item_scores=tuple(
        r.ItemScore(item=f"i{i}", score=1.0 - i / 10) for i in range(4)))
    m = r.PrecisionAtK(k=5)
    assert m.header() == "Precision@5"
    q = r.Query(user="u", num=5)
    assert m.calculate_qpa(q, pred, r.ActualResult(("i1", "i3", "x"))) \
        == 2 / 5
    assert m.calculate_qpa(q, pred, r.ActualResult(())) is None
    assert r.PrecisionAtK(k=2).calculate_qpa(
        q, pred, r.ActualResult(("i1", "i3"))) == 1 / 2


#: a served top-5 slot may differ from the JAX package's only where the
#: two items' JAX scores are this close, relative (module docstring)
NEAR_TIE = {0: 1e-5, 1: 2e-3}


def _evaluate_planted(p, tmp_path, monkeypatch):
    ev = p.evaluation.Evaluation()
    best = tmp_path / f"best-{p.name}.json"
    ev.engine_evaluator = (
        p.rec.RecommendationEngine().apply(),
        p.evaluation.MetricEvaluator(p.rec.PrecisionAtK(k=5),
                                     output_path=str(best)))
    good = rec_params(p, eval_k=3)
    untrained = rec_params(p, eval_k=3, iterations=0)
    _iid, result = p.run_evaluation(ev, [untrained, good])
    return result, json.loads(best.read_text()), [untrained, good]


def test_planted_discrimination_equal_across_packages(tmp_path, monkeypatch):
    seed_planted()
    _jax_init(monkeypatch)
    (jr, jbest, jeps), (tr, tbest, teps) = (
        _evaluate_planted(p, tmp_path, monkeypatch) for p in PKGS)
    # tests/test_quality_planted.py's claims, in the port
    assert tr.best_idx == jr.best_idx == 1
    assert tr.best_score.score > 0.35
    scores = [ms.score for _, ms in tr.engine_params_scores]
    assert scores[1] > scores[0] + 0.1
    assert tbest == jbest == teps[1].to_jsonable() == jeps[1].to_jsonable()
    # per candidate: the same Precision@5, every served slot the JAX one
    # or its near-tie
    for cand in (0, 1):
        assert tr.engine_params_scores[cand][1].score == \
            pytest.approx(jr.engine_params_scores[cand][1].score,
                          abs=1e-12), cand
    for cand in (0, 1):
        outs = []
        for p in PKGS:
            ep = rec_params(p, eval_k=3, iterations=(0, 12)[cand])
            outs.append(p.rec.RecommendationEngine().apply().eval(
                p.ctx(), ep))
        for (jinfo, jqpa), (tinfo, tqpa) in zip(*outs):
            assert tinfo.fold == jinfo.fold
            for (jq, jp, ja), (tq, tp, ta) in zip(jqpa, tqpa):
                assert tq.user == jq.user and ta.items == ja.items
                same_top(tp, jp, NEAR_TIE[cand], (cand, jq.user))


def same_top(got, ref, tol, what):
    gi = [s.item for s in got.item_scores]
    ri = [s.item for s in ref.item_scores]
    rs = {s.item: s.score for s in ref.item_scores}
    assert len(gi) == len(ri) and len(set(gi)) == len(gi), what
    np.testing.assert_allclose([s.score for s in got.item_scores],
                               [s.score for s in ref.item_scores],
                               rtol=max(tol, 1e-5), atol=1e-6,
                               err_msg=str(what))
    scale = max(abs(v) for v in rs.values()) if rs else 1.0
    for k, (g, r) in enumerate(zip(gi, ri)):
        if g != r:
            # the swapped item is the JAX answer's neighbour at a near-tie
            assert g in rs and abs(rs[g] - rs[r]) <= tol * scale, \
                (what, k, gi, ri)


def test_recommendation_eval_precision_at_k_block_structure():
    """test_recommendation_template.py::test_evaluation_precision_at_k in
    the port: two blocks of users rating their block's items."""
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    p = PORT
    p.Storage.get_meta_data_apps().insert(p.storage.App(0, "blocks"))
    app_id = p.Storage.get_meta_data_apps().get_by_name("blocks").id
    rng = np.random.default_rng(0)
    for block in "AB":
        for u in range(6):
            for i in range(8):
                if rng.random() < 0.7:
                    p.Storage.get_events().insert(p.Event(
                        event="rate", entity_type="user",
                        entity_id=f"u{block}{u}", target_entity_type="item",
                        target_entity_id=f"i{block}{i}",
                        properties=p.DataMap({"rating": 5.0})), app_id)
    engine = p.rec.RecommendationEngine().apply()
    ev = p.evaluation.Evaluation()
    ev.engine_metric = (engine, p.rec.PrecisionAtK(k=3))
    _iid, result = CoreWorkflow.run_evaluation(
        ev, [rec_params(p, app="blocks", eval_k=2, iterations=5,
                        lambda_=0.01, rank=4)], device=CPU)
    assert 0.2 < result.best_score.score <= 1.0


# ---------------------------------------------------------------------------
# HitAtK
# ---------------------------------------------------------------------------

def test_hit_at_k_equal_on_the_same_triples():
    rng = np.random.default_rng(3)
    triples = []
    for n in range(30):
        items = [f"i{j}" for j in rng.choice(20, size=5, replace=False)]
        actual = f"i{int(rng.integers(20))}"
        triples.append((n, items, actual if n % 2 else
                        types.SimpleNamespace(item=actual)))
    hits = []
    for p in PKGS:
        s = p.seq
        m = s.HitAtK()
        hits.append([m.calculate_one(
            s.Query(user=f"u{n}", num=5),
            s.PredictedResult(item_scores=tuple(
                s.ItemScore(item=i, score=1.0) for i in items)), actual)
            for n, items, actual in triples])
    assert hits[1] == hits[0] and 0 < sum(hits[0]) < len(triples)
    # the port's HitAtK also scores a whole evaluation output (the JAX
    # package's defines only calculate_one): the mean of the same hits
    s = PORT.seq
    data = [(None, [(s.Query(user=f"u{n}", num=5),
                     s.PredictedResult(item_scores=tuple(
                         s.ItemScore(item=i, score=1.0) for i in items)),
                     actual) for n, items, actual in triples])]
    assert s.HitAtK().calculate(PORT.ctx(), data) == \
        pytest.approx(sum(hits[0]) / len(hits[0]))


# ---------------------------------------------------------------------------
# pio eval through the port's CLI
# ---------------------------------------------------------------------------

PORT_EVALUATION = textwrap.dedent('''
    """The quickstart's evaluation objects, importing the port."""

    from incubator_predictionio_tpu_torch.core.evaluation import Evaluation
    from incubator_predictionio_tpu_torch.core.params import (
        EngineParams, EngineParamsGenerator)
    from incubator_predictionio_tpu_torch.models.recommendation import (
        ALSAlgorithmParams, DataSourceParams, PrecisionAtK,
        RecommendationEngine)

    evaluation = Evaluation()
    evaluation.engine_metric = (RecommendationEngine().apply(),
                                PrecisionAtK(k=5))


    class _Generator(EngineParamsGenerator):
        engine_params_list = [
            EngineParams(
                data_source_params=("", DataSourceParams(app_name="MyApp1",
                                                         eval_k=2)),
                algorithm_params_list=[("als", ALSAlgorithmParams(
                    rank=4, num_iterations=iters, lambda_=0.05, seed=3))])
            for iters in (0, 8)
        ]


    engine_params_generator = _Generator()
''')


def _sqlite_env(tmp_path):
    return {**os.environ, "PIO_HOME": str(tmp_path / "home"),
            "PIO_DEVICE": "cpu", "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": os.pathsep.join(
                [REPO] + [x for x in os.environ.get("PYTHONPATH", "")
                          .split(os.pathsep) if x])}


def _cli(env, cwd, *argv):
    return subprocess.run(CLI + list(argv), cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_pio_eval_through_the_port_cli(tmp_path):
    env = _sqlite_env(tmp_path)
    work = tmp_path / "work"
    work.mkdir()
    (work / "evaluation.py").write_text(PORT_EVALUATION)
    assert _cli(env, work, "app", "new", "MyApp1").returncode == 0
    users, items, ratings = planted_triples()
    events = [json.dumps({
        "event": "rate", "entityType": "user", "entityId": f"u{u}",
        "targetEntityType": "item", "targetEntityId": f"i{i}",
        "properties": {"rating": float(r)},
        "eventTime": "2024-01-01T00:00:00.000Z"})
        for u, i, r in zip(users, items, ratings)]
    (work / "events.jsonl").write_text("\n".join(events))
    assert _cli(env, work, "import", "--appid-or-name", "MyApp1", "--input",
                "events.jsonl").returncode == 0
    proc = _cli(env, work, "eval", "evaluation:evaluation",
                "evaluation:engine_params_generator")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].startswith("Evaluation completed. Instance ID: ")
    assert lines[-2].startswith("[")
    iid = lines[-1].rsplit(" ", 1)[1]
    best = json.loads((work / "best.json").read_text())
    assert best["algorithmParamsList"][0]["params"]["numIterations"] == 8
    # the instance, read back through the port's own store
    code = textwrap.dedent(f'''
        import json
        from incubator_predictionio_tpu_torch.data.storage import Storage
        inst = Storage.get_meta_data_evaluation_instances().get({iid!r})
        res = json.loads(inst.evaluator_results_json)
        print(json.dumps([inst.status, inst.evaluation_class,
                          res["bestIdx"], res["bestEngineParams"]]))
    ''')
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=work,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    status, cls, best_idx, best_ep = json.loads(out.stdout)
    assert (status, cls, best_idx) == ("EVALCOMPLETED",
                                       "evaluation:evaluation", 1)
    assert best_ep == best


def test_pio_eval_refuses_a_module_that_imports_the_jax_package(tmp_path,
                                                                monkeypatch):
    from incubator_predictionio_tpu_torch.cli import commands, main

    jax_module = (
        open(os.path.join(REPO, "examples", "recommendation-quickstart",
                          "evaluation.py")).read())
    (tmp_path / "jax_evaluation.py").write_text(jax_module)
    (tmp_path / "port_evaluation.py").write_text(PORT_EVALUATION)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PIO_DEVICE", "cpu")
    # in process (the JAX package already loaded): refused by its classes
    with pytest.raises(commands.CommandError, match="JAX package"):
        commands.resolve_port_object("jax_evaluation:evaluation")
    with pytest.raises(commands.CommandError, match="JAX package"):
        commands.resolve_port_object(
            "jax_evaluation:engine_params_generator")
    assert main.main(["eval", "jax_evaluation:evaluation",
                      "jax_evaluation:engine_params_generator"]) == 1
    ok = commands.resolve_port_object("port_evaluation:evaluation")
    assert type(ok).__module__ == \
        "incubator_predictionio_tpu_torch.core.evaluation"
    # a fresh process: refused because resolving it loaded the package
    env = _sqlite_env(tmp_path)
    proc = _cli(env, tmp_path, "eval", "jax_evaluation:evaluation",
                "jax_evaluation:engine_params_generator")
    assert proc.returncode == 1
    assert "must import incubator_predictionio_tpu_torch" in proc.stderr
    assert not (tmp_path / "best.json").exists()
    with pytest.raises(NotImplementedError, match="item 9"):
        main.main(["eval", "--hosts", "h1", "port_evaluation:evaluation"])


def test_chip_smoke_eval_phase_rehearses_on_the_cpu():
    """chip_smoke.py's eval phase at its small size on the CPU (the plain
    versions of the kernels; the launch checks run on the card only):
    ``pio eval`` in process, the trained candidate picked, every sampled
    answer the plain top-k of its fold's model."""
    import chip_smoke
    from incubator_predictionio_tpu_torch import runtime
    from incubator_predictionio_tpu_torch.ops import kernels

    _launches, err, stats = chip_smoke.eval_phase(torch.device(CPU), runtime,
                                                  kernels, small=True)
    assert stats["best_idx"] == 1
    assert stats["precision_at_5"][1] > stats["precision_at_5"][0] \
        + chip_smoke.EVAL_MARGIN
    assert stats["checked"] == 4 * chip_smoke.EVAL_CHECKED
    assert stats["queries"] == 4 * 300 and err < 1e-4
