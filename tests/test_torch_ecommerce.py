"""The port's e-commerce template (``models/ecommerce/``) against the JAX
package's, on the CPU, each package on a store of its own with the same
events:

- tests/test_other_templates.py's ecommerce cases (the template, the
  weighted items, ``seen_events``) and tests/test_speed_layer.py's
  micro-cache case, through both packages;
- training from one initial state (the port's ``als_init`` patched to
  the JAX init): the prepared data equal, the factors within 1e-3
  relative; fresh and continued (``train_with_previous``);
- answers on the same factors (the JAX-trained ones): every rung of the
  ladder (the base row, the recent views, popularity) and the implicit
  speed overlay's fold-in, under the constraints: ids equal except
  near-ties, scores rtol 1e-4;
- a JAX-trained instance deployed by the port's server;
- ``examples/ecommerce-quickstart`` through the port's CLI
  (``import_events.py`` against ``pio eventserver``, ``pio train``,
  ``pio deploy`` and ``pio undeploy``, ``PIO_DEVICE=cpu``);
- the speed layer behind the port's prediction server, on a memory
  store.
"""

import dataclasses
import importlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "ecommerce-quickstart")
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
ALGO = dict(rank=8, num_iterations=10, lambda_=0.05, alpha=2.0, seed=5)


class Pkg:
    def __init__(self, name: str, pkg: str):
        self.name = name

        def mod(path):
            return importlib.import_module(f"{pkg}.{path}")

        self.eng = mod("models.ecommerce.engine")
        self.params = mod("core.params")
        self.context = mod("parallel.context")
        self.storage = mod("data.storage")
        self.store = mod("data.store")
        self.Event = mod("data.event").Event
        self.DataMap = mod("data.datamap").DataMap
        self.BiMap = mod("data.bimap").BiMap
        self.workflow = mod("workflow.workflow")
        self.Storage = self.storage.Storage

    def ctx(self):
        return (self.context.RuntimeContext(device=CPU) if self.name == "port"
                else self.context.RuntimeContext())

    def engine_params(self, app, **algo):
        return self.params.EngineParams(
            data_source_params=("", self.eng.DataSourceParams(app_name=app)),
            algorithm_params_list=[("ecomm", self.eng.ECommAlgorithmParams(
                app_name=app, **{**ALGO, **algo}))])

    def algorithm(self, ep):
        return self.eng.ECommAlgorithm(ep.algorithm_params_list[0][1])

    def train(self, app, **algo):
        ep = self.engine_params(app, **algo)
        models = self.eng.ECommerceEngine().apply().train(self.ctx(), ep)
        algorithm = self.algorithm(ep)
        return algorithm, algorithm.prepare_model(self.ctx(), models[0])

    def event(self, name, user, item=None, props=None, etype="user"):
        return self.Event(
            event=name, entity_type=etype, entity_id=user,
            target_entity_type="item" if item else None,
            target_entity_id=item, properties=self.DataMap(props or {}))

    def insert(self, app_id, *events):
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


def seed_app(p, name):
    p.Storage.get_meta_data_apps().insert(p.storage.App(0, name))
    return p.Storage.get_meta_data_apps().get_by_name(name).id


def seed_views(p, app_id):
    """tests/test_other_templates.py ``seed_views``: two blocks of users
    viewing their block's items, block A's items in ``catA``."""
    rng = np.random.default_rng(1)
    for users, items in (
            ([f"uA{i}" for i in range(6)], [f"iA{i}" for i in range(8)]),
            ([f"uB{i}" for i in range(6)], [f"iB{i}" for i in range(8)])):
        for u in users:
            for it in items:
                if rng.random() < 0.6:
                    p.insert(app_id, p.event("view", u, it))
    for i in range(8):
        p.insert(app_id, p.event("$set", f"iA{i}",
                                 props={"categories": ["catA"]},
                                 etype="item"))


def seed_both(name, buys=True):
    ids = {}
    for p in PKGS:
        ids[p.name] = app_id = seed_app(p, name)
        seed_views(p, app_id)
        if buys:
            p.insert(app_id, p.event("buy", "uA0", "iA2"))
    return ids


def _items(result):
    return [s.item for s in result.item_scores]


def _scores(result):
    return [s.score for s in result.item_scores]


def same_answer(got, ref, what="", full=None):
    """Scores rtol 1e-4; ids equal except among near-ties: the item at a
    rank must be one whose JAX score is within 1e-4 · max|score| of the
    JAX score at that rank, judged over ``full`` (the JAX answer for the
    whole catalogue; by default ``ref`` itself). The JAX package serves a
    catalogue this small from its host mirror, whose numpy top-k orders
    exact ties its own way."""
    gi, ri = _items(got), _items(ref)
    gs, rs = np.asarray(_scores(got)), np.asarray(_scores(ref))
    assert len(gi) == len(ri) and len(set(gi)) == len(gi), (what, gi, ri)
    np.testing.assert_allclose(gs, rs, rtol=1e-4, atol=1e-6, err_msg=what)
    if not len(rs):
        return
    full = dict(zip(ri, rs)) if full is None else dict(
        zip(_items(full), _scores(full)))
    tol = 1e-4 * max(float(np.max(np.abs(rs))), 1e-6)
    for k in range(len(ri)):
        tied = {i for i, v in full.items() if abs(v - rs[k]) <= tol}
        assert gi[k] == ri[k] or gi[k] in tied, (what, k, gi, ri)


# ---------------------------------------------------------------------------
# tests/test_other_templates.py, through both packages
# ---------------------------------------------------------------------------

@BOTH
def test_ecommerce_template(p):
    app_id = seed_app(p, "shop2")
    seed_views(p, app_id)
    p.insert(app_id, p.event("buy", "uA0", "iA2"))
    algo, model = p.train("shop2")
    r = algo.predict(model, p.eng.Query(user="uA1", num=3))
    assert r.item_scores
    assert r.item_scores[0].item.startswith("iA")
    seen = {e.target_entity_id for e in p.Storage.get_events().find(
        app_id=app_id, entity_id="uA1")}
    assert not seen.intersection(_items(r))
    first = r.item_scores[0].item
    p.insert(app_id, p.event("$set", "unavailableItems",
                             props={"items": [first]}, etype="constraint"))
    r2 = algo.predict(model, p.eng.Query(user="uA1", num=3))
    assert first not in _items(r2)
    p.insert(app_id, p.event("view", "fresh", "iB0"),
             p.event("view", "fresh", "iB1"))
    r3 = algo.predict(model, p.eng.Query(user="fresh", num=2))
    assert r3.item_scores and all(i.startswith("iB") for i in _items(r3))
    r4 = algo.predict(model, p.eng.Query(user="nobody", num=2))
    assert len(r4.item_scores) == 2


@BOTH
def test_ecommerce_weighted_items(p):
    app_id = seed_app(p, "wshop")
    seed_views(p, app_id)
    algo, model = p.train("wshop")
    base = algo.predict(model, p.eng.Query(user="uA1", num=4))
    assert len(base.item_scores) >= 2
    first, second = base.item_scores[0], base.item_scores[1]
    p.insert(app_id, p.event("$set", "weightedItems", props={"weights": [
        {"items": [second.item], "weight": 100.0},
        {"items": [first.item], "weight": 0.001}]}, etype="constraint"))
    boosted = algo.predict(model, p.eng.Query(user="uA1", num=4))
    assert boosted.item_scores[0].item == second.item
    by_item = {s.item: s.score for s in boosted.item_scores}
    assert by_item[second.item] == pytest.approx(second.score * 100.0,
                                                 rel=1e-4)
    p.insert(app_id, p.event("$set", "weightedItems",
                             props={"weights": []}, etype="constraint"))
    reset = algo.predict(model, p.eng.Query(user="uA1", num=4))
    assert reset.item_scores[0].item == first.item


@BOTH
def test_ecommerce_seen_events_config(p):
    app_id = seed_app(p, "shop3")
    seed_views(p, app_id)
    algo, model = p.train("shop3", num_iterations=5, seen_events=("buy",))
    r = algo.predict(model, p.eng.Query(user="uA1", num=5))
    viewed = {e.target_entity_id for e in p.Storage.get_events().find(
        app_id=app_id, entity_id="uA1", event_names=["view"])}
    assert viewed.intersection(_items(r))


@BOTH
def test_ecommerce_micro_cache_dedupes_and_invalidates(p, monkeypatch):
    """The recent-events read runs once per write window, and a new write
    (the store's cursor moves) invalidates it at once."""
    p.Storage.get_meta_data_apps().insert(p.storage.App(0, "speedapp"))
    algo = p.eng.ECommAlgorithm(p.eng.ECommAlgorithmParams(
        app_name="speedapp", rank=4))
    p.store.EventStore.write([p.event("view", "fresh", "i0")], "speedapp")
    calls = []
    real = p.store.EventStore.find_by_entity

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(p.store.EventStore, "find_by_entity",
                        staticmethod(counting))

    class Model:
        item_bimap = p.BiMap({"i0": 0, "i1": 1})

    r1 = algo._recent_items(Model, "fresh")
    r2 = algo._recent_items(Model, "fresh")
    assert r1 == r2 == [0]
    assert len(calls) == 1
    p.store.EventStore.write([p.event("view", "fresh", "i1")], "speedapp")
    assert set(algo._recent_items(Model, "fresh")) == {0, 1}
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# against the JAX package: training and answers
# ---------------------------------------------------------------------------

def _jax_init(monkeypatch):
    """The port's ``als_init`` patched to the JAX package's."""
    import jax

    import incubator_predictionio_tpu.ops.als as jals
    from incubator_predictionio_tpu_torch.ops import als

    def init(gen, n_users, n_items, rank, device=None):
        seed = int(gen.initial_seed())
        st = jals.als_init(jax.random.key(seed), n_users, n_items, rank)
        return als.ALSState(
            torch.from_numpy(np.array(st.user_factors)).to(device),
            torch.from_numpy(np.array(st.item_factors)).to(device))

    monkeypatch.setattr(als, "als_init", init)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _port_model(jmodel):
    """The JAX package's trained model as the port's, on the CPU."""
    ec = PORT.eng
    model = ec.ECommModel(
        user_factors=torch.from_numpy(np.array(jmodel.user_factors)),
        item_factors=torch.from_numpy(np.array(jmodel.item_factors)),
        user_bimap=PORT.BiMap(dict(jmodel.user_bimap.items())),
        item_bimap=PORT.BiMap(dict(jmodel.item_bimap.items())),
        item_categories=dict(jmodel.item_categories),
        user_seen={u: np.asarray(s) for u, s in jmodel.user_seen.items()},
        item_popularity=np.asarray(jmodel.item_popularity))
    return model


def test_training_matches_jax_from_one_init(monkeypatch):
    """The same events in both stores: equal prepared data, seen sets and
    popularity; factors within 1e-3 relative from the JAX init."""
    seed_both("eq")
    _jax_init(monkeypatch)
    (jalgo, jmodel), (talgo, tmodel) = (p.train("eq") for p in PKGS)
    assert dict(tmodel.user_bimap.items()) == dict(jmodel.user_bimap.items())
    assert dict(tmodel.item_bimap.items()) == dict(jmodel.item_bimap.items())
    assert sorted(tmodel.user_seen) == sorted(jmodel.user_seen)
    for u, s in jmodel.user_seen.items():
        np.testing.assert_array_equal(tmodel.user_seen[u], s)
        assert tmodel.user_seen[u].dtype == np.asarray(s).dtype
    np.testing.assert_array_equal(tmodel.item_popularity.cpu().numpy(),
                                  np.asarray(jmodel.item_popularity))
    assert tmodel.item_categories == jmodel.item_categories
    assert _rel(tmodel.user_factors, jmodel.user_factors) < 1e-3
    assert _rel(tmodel.item_factors, jmodel.item_factors) < 1e-3
    for p in PKGS:
        ctx = p.ctx()
        ds = p.eng.ECommerceDataSource(p.eng.DataSourceParams(app_name="eq"))
        pd = p.eng.ECommercePreparator().prepare(ctx, ds.read_training(ctx))
        if p is JAX:
            jpd = pd
    for f in ("users", "items", "weights"):
        np.testing.assert_array_equal(getattr(pd, f), getattr(jpd, f))


def _queries(p):
    q = p.eng.Query
    return [q(user="uA1", num=4), q(user="uB2", num=20),
            q(user="uA3", num=3, categories=("catA",)),
            q(user="uB0", num=5, white_list=("iB1", "iB3", "iA0")),
            q(user="uA0", num=6, black_list=("iA4",)),
            q(user="fresh", num=3), q(user="nobody", num=4),
            q(user="uA2", num=0)]


def test_answers_match_jax_on_the_same_factors():
    """Every rung of the serving ladder — a known user's row, an unknown
    user's recent views, popularity — with filters and both constraints,
    the port on the JAX-trained factors."""
    ids = seed_both("ans")
    for p in PKGS:
        p.insert(ids[p.name], p.event("view", "fresh", "iB0"),
                 p.event("view", "fresh", "iB5"),
                 p.event("view", "fresh", "iA1"))
    jalgo, jmodel = JAX.train("ans")
    ep = PORT.engine_params("ans")
    talgo = PORT.algorithm(ep)
    tmodel = talgo.prepare_model(PORT.ctx(), _port_model(jmodel))
    for step in range(3):
        for jq, tq in zip(_queries(JAX), _queries(PORT)):
            everything = dataclasses.replace(jq, num=len(jmodel.item_bimap))
            same_answer(talgo.predict(tmodel, tq),
                        jalgo.predict(jmodel, jq), (step, tq),
                        full=jalgo.predict(jmodel, everything))
        for p in PKGS:  # the constraints, without retraining
            if step == 0:
                p.insert(ids[p.name], p.event(
                    "$set", "unavailableItems",
                    props={"items": ["iA5", "iB1"]}, etype="constraint"))
            else:
                p.insert(ids[p.name], p.event(
                    "$set", "weightedItems", props={"weights": [
                        {"items": ["iB3", "iA6"], "weight": 3.0}]},
                    etype="constraint"))


def test_implicit_overlay_answers_match_jax():
    """The implicit overlay of each package over the same (JAX-trained)
    item table: equal fold-ins for a cold user and a known user with new
    events, and equal answers, the fresh seen set excluded."""
    ids = seed_both("ov")
    jalgo, jmodel = JAX.train("ov")
    ep = PORT.engine_params("ov")
    talgo = PORT.algorithm(ep)
    tmodel = talgo.prepare_model(PORT.ctx(), _port_model(jmodel))
    jov = jalgo.make_speed_overlay(jmodel, "ov", None,
                                   JAX.eng.DataSourceParams(app_name="ov"))
    tov = talgo.make_speed_overlay(tmodel, "ov", None,
                                   PORT.eng.DataSourceParams(app_name="ov"))
    assert tov.config.implicit and tov.config.alpha == ALGO["alpha"]
    assert tov.solver.other_factors.data_ptr() == \
        tmodel.item_factors.data_ptr()
    jalgo.attach_speed_overlay(jov)
    talgo.attach_speed_overlay(tov)
    for p in PKGS:
        p.insert(ids[p.name], p.event("view", "cold", "iB0"),
                 p.event("view", "cold", "iB2"),
                 p.event("buy", "cold", "iB4"),
                 p.event("view", "uA2", "iB6"))
    jp, tp = jov.poll(), tov.poll()
    assert (jp["solved"], jp["tail_rows"], jp["dirty"]) == \
        (tp["solved"], tp["tail_rows"], tp["dirty"]) == (2, 4, 0)
    for user in ("cold", "uA2"):
        j, t = np.asarray(jov.lookup(user)), tov.lookup(user)
        np.testing.assert_allclose(t, j, atol=1e-4 * np.max(np.abs(j)))
    for user, num in (("cold", 5), ("uA2", 4), ("uB1", 3)):
        same_answer(talgo.predict(tmodel, PORT.eng.Query(user=user,
                                                         num=num)),
                    jalgo.predict(jmodel, JAX.eng.Query(user=user, num=num)),
                    user)
    got = _items(talgo.predict(tmodel, PORT.eng.Query(user="cold", num=16)))
    assert not {"iB0", "iB2", "iB4"}.intersection(got)
    assert talgo._recent_cache.get(("seen", "cold"),
                                   version=("u", tov.key_version("cold")))


def test_train_with_previous_matches_jax(monkeypatch):
    """A second train with new events continues from the first in both
    packages (factors within 1e-3 relative); another rank trains
    fresh."""
    ids = seed_both("cont")
    _jax_init(monkeypatch)
    firsts = {p.name: p.train("cont", num_iterations=4)[1] for p in PKGS}
    for p in PKGS:
        # new events of known users on known items: no row grows, so
        # both continuations start from the same factors (a grown row is
        # random, from each package's own generator)
        p.insert(ids[p.name], p.event("view", "uA1", "iB7"),
                 p.event("view", "uB2", "iA3"),
                 p.event("buy", "uB2", "iB3"))
    outs = {}
    for p in PKGS:
        ctx = p.ctx()
        ep = p.engine_params("cont", num_iterations=6)
        ds = p.eng.ECommerceDataSource(ep.data_source_params[1])
        pd = p.eng.ECommercePreparator().prepare(ctx, ds.read_training(ctx))
        algo = p.algorithm(ep)
        outs[p.name] = (algo.train_with_previous(ctx, pd, firsts[p.name]),
                        pd)
    (jm, jpd), (tm, tpd) = outs["jax"], outs["port"]
    assert dict(tpd.user_bimap.items()) == dict(
        firsts["port"].user_bimap.items())
    np.testing.assert_array_equal(tpd.weights, jpd.weights)
    assert _rel(tm.user_factors, jm.user_factors) < 1e-3
    assert _rel(tm.item_factors, jm.item_factors) < 1e-3
    # another rank: a fresh train, not a continuation
    ep = PORT.engine_params("cont", rank=4, num_iterations=2)
    fresh = PORT.algorithm(ep).train_with_previous(PORT.ctx(), tpd,
                                                   firsts["port"])
    assert fresh.user_factors.shape[1] == 4


def test_continuation_seeds_from_the_previous_factors(monkeypatch):
    from incubator_predictionio_tpu_torch.ops import retrain

    seed_views(PORT, seed_app(PORT, "seedcont"))
    _algo, first = PORT.train("seedcont", num_iterations=3)
    seen = {}
    real = retrain.als_retrain

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(retrain, "als_retrain", spy)
    ctx = PORT.ctx()
    ep = PORT.engine_params("seedcont", num_iterations=3)
    ds = PORT.eng.ECommerceDataSource(ep.data_source_params[1])
    pd = PORT.eng.ECommercePreparator().prepare(ctx, ds.read_training(ctx))
    PORT.algorithm(ep).train_with_previous(ctx, pd, first)
    assert seen["implicit"] and seen["prev_state"].user_factors is \
        first.user_factors
    assert seen.get("plan_key") is None


# ---------------------------------------------------------------------------
# a JAX-trained instance, the example through the CLI, the served overlay
# ---------------------------------------------------------------------------

@pytest.fixture
def sqlite_home(tmp_path, monkeypatch):
    home = tmp_path / "home"
    monkeypatch.setenv("PIO_HOME", str(home))
    monkeypatch.setenv("PIO_DEVICE", "cpu")
    monkeypatch.setenv("PIO_RETRAIN_CONTINUE", "0")
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    for p in PKGS:
        p.Storage.reset()
    yield home
    for p in PKGS:
        p.Storage.reset()


def test_jax_trained_instance_deployed_by_the_port(sqlite_home):
    """``run_train`` of the JAX package on a SQLite store; the port's
    ``load_models`` restores that instance and answers as the JAX
    model."""
    app_id = seed_app(JAX, "MyShop")
    JAX.Storage.get_events().init(app_id)
    seed_views(JAX, app_id)
    jengine = JAX.eng.ECommerceEngine().apply()
    jep = JAX.engine_params("MyShop")
    iid = JAX.workflow.CoreWorkflow.run_train(jengine, jep)
    [jmodel] = JAX.workflow.CoreWorkflow.load_models(iid, jengine, jep)
    jalgo = JAX.algorithm(jep)
    tengine = PORT.eng.ECommerceEngine().apply()
    tep = PORT.engine_params("MyShop")
    [tmodel] = PORT.workflow.CoreWorkflow.load_models(iid, tengine, tep,
                                                      device=CPU)
    assert isinstance(tmodel, PORT.eng.ECommModel)
    assert tmodel.item_factors.device.type == "cpu"
    talgo = PORT.algorithm(tep)
    for jq, tq in zip(_queries(JAX), _queries(PORT)):
        everything = dataclasses.replace(jq, num=len(jmodel.item_bimap))
        same_answer(talgo.predict(tmodel, tq), jalgo.predict(jmodel, jq),
                    tq, full=jalgo.predict(jmodel, everything))


def _child(argv, cwd, log):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    out = open(log, "w")
    return subprocess.Popen([*CLI, *argv], cwd=cwd, env=env, stdout=out,
                            stderr=subprocess.STDOUT), log


def _wait_port(child, pattern, timeout=120):
    proc, log = child
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        m = re.search(pattern, open(log).read())
        if m:
            return int(m.group(1))
        assert proc.poll() is None, open(log).read()
        time.sleep(0.1)
    proc.kill()
    raise AssertionError(open(log).read())


def _post(url, body):
    req = urllib.request.Request(
        url, json.dumps(body).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read() or b"null")


def test_ecommerce_quickstart_through_the_cli(sqlite_home, tmp_path,
                                              capsys):
    """The example as a user runs it: ``pio app new``, ``import_events.py``
    against ``pio eventserver``, ``pio build``/``pio train`` with the
    example's engine.json unedited (it names the JAX package's factory),
    ``pio deploy`` as a child answering /queries.json, ``pio undeploy``."""
    from incubator_predictionio_tpu_torch.cli.main import main

    assert main(["app", "new", "MyApp1"]) == 0
    key = re.search(r"Access Key: (\S+)", capsys.readouterr().out).group(1)
    PORT.Storage.reset()
    es = _child(["eventserver", "--ip", "127.0.0.1", "--port", "0"],
                str(tmp_path), str(tmp_path / "es.log"))
    try:
        es_port = _wait_port(es, r"running on http://[^:]+:(\d+)")
        seeded = subprocess.run(
            [sys.executable, os.path.join(EXAMPLE, "import_events.py"),
             "--access-key", key, "--url", f"http://127.0.0.1:{es_port}"],
            capture_output=True, text=True, timeout=120)
        assert seeded.returncode == 0, seeded.stderr
        assert "imported 240 events" in seeded.stdout
    finally:
        es[0].send_signal(signal.SIGTERM)
        assert es[0].wait(60) == 0, open(es[1]).read()
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    shutil.copyfile(os.path.join(EXAMPLE, "engine.json"),
                    engine_dir / "engine.json")
    cwd = os.getcwd()
    os.chdir(engine_dir)
    try:
        assert main(["build"]) == 0
        assert main(["train"]) == 0
    finally:
        os.chdir(cwd)
    iid = re.search(r"Engine instance ID: (\S+)",
                    capsys.readouterr().out).group(1)
    instance = PORT.Storage.get_meta_data_engine_instances().get(iid)
    assert instance.engine_factory == (
        "incubator_predictionio_tpu.models.ecommerce:ECommerceEngine")
    dep = _child(["deploy", "--ip", "127.0.0.1", "--port", "0"],
                 str(engine_dir), str(tmp_path / "deploy.log"))
    try:
        port = _wait_port(dep, r"deployed on http://[^:]+:(\d+)")
        url = f"http://127.0.0.1:{port}"
        status, body = _post(f"{url}/queries.json", {"user": "u1", "num": 4})
        assert status == 200 and len(body["itemScores"]) == 4
        _s, cold = _post(f"{url}/queries.json", {"user": "nobody", "num": 3})
        assert len(cold["itemScores"]) == 3      # popularity
        with urllib.request.urlopen(f"{url}/", timeout=60) as resp:
            info = json.loads(resp.read())
        assert info["algorithms"] == ["ECommAlgorithm"]
        assert info["speedOverlay"]["overlays"] == 0   # SQLite: no tail
        assert main(["undeploy", "--ip", "127.0.0.1", "--port",
                     str(port)]) == 0
        assert dep[0].wait(60) == 0, open(dep[1]).read()
    finally:
        if dep[0].poll() is None:
            dep[0].kill()


def test_ecommerce_speed_layer_behind_the_server(monkeypatch):
    """The port's server deploys an ecommerce instance from a memory
    store with its implicit overlay: a cold user's views fold in at a
    poll, and the served answer is the plain scoring of the folded vector
    with the freshly read seen set masked."""
    from incubator_predictionio_tpu_torch.ops.topk import (
        top_k_with_exclusions,
    )
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer,
        ServerConfig,
    )

    app_id = seed_app(PORT, "srv")
    seed_views(PORT, app_id)
    engine = PORT.eng.ECommerceEngine().apply()
    ep = PORT.engine_params("srv", num_iterations=4)
    PORT.workflow.CoreWorkflow.run_train(engine, ep, engine_variant="ec",
                                         device=CPU)
    monkeypatch.setenv("PIO_SPEED_POLL_S", "3600")
    server = PredictionServer(engine, device=CPU, config=ServerConfig(
        ip="127.0.0.1", port=0, engine_variant="ec"))
    port = server.start_background()
    try:
        [overlay] = server._speed_overlays
        assert overlay.config.implicit
        PORT.insert(app_id, PORT.event("view", "walkin", "iB1"),
                    PORT.event("view", "walkin", "iB3"))
        assert overlay.poll()["solved"] == 1
        vec = torch.from_numpy(overlay.lookup("walkin"))
        model = server.models[0]
        _s, body = _post(f"http://127.0.0.1:{port}/queries.json",
                         {"user": "walkin", "num": 4})
        mask = torch.ones(len(model.item_bimap), dtype=torch.bool)
        mask[[model.item_bimap["iB1"], model.item_bimap["iB3"]]] = False
        s, i = top_k_with_exclusions(model.item_factors @ vec, 4,
                                     allowed_mask=mask)
        inv = model.item_bimap.inverse
        assert [x["item"] for x in body["itemScores"]] == \
            [inv[int(k)] for k in i]
        np.testing.assert_allclose([x["score"] for x in body["itemScores"]],
                                   s.numpy(), rtol=1e-5)
        assert overlay.stats()["hits"] >= 1
    finally:
        server.stop()
