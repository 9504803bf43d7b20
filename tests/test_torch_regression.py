"""The port's regression template (``models/regression/``, served through
``core/base.AverageServing``) and ``ops/linreg.py`` against the JAX
package's, on the CPU, each package on a memory store of its own with the
same events:

- ``linreg_fit`` within 1e-5 of JAX's (relative to max |w|, l2 0 and
  0.5), batched as the stock template calls it; a Gram that is not
  positive definite (a duplicated column at l2 0) NaN in both packages;
  ``linreg_fit_sgd`` within 1e-6 of JAX's;
- every case of tests/test_regression_template.py through both packages,
  the weights and the served averages equal within 1e-5;
- ``pio eval`` through the port's CLI (in this process) against the JAX
  package's ``CoreWorkflow.run_evaluation``: the same stored MSE within
  1e-5, relative (f32 predictions in both);
- a JAX-trained blob decoded and served by the port;
- ``chip_smoke.py``'s regression leg, rehearsed at its small size.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_classification import (  # noqa: F401 (the fixture)
    BOTH,
    CPU,
    JAX,
    PKGS,
    PORT,
    mem_storage,
)

W_TRUE = np.array([2.0, -1.0, 0.5])
INTERCEPT = 0.7


def lin(p):
    return p.mod("ops.linreg")


def reg(p):
    return p.mod("models.regression")


def design(seed: int, n: int = 120, k: int = 3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k)).astype(np.float32)
    y = (x @ rng.normal(size=k) + 0.3
         + rng.normal(0, 0.1, n)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("l2", [0.0, 0.5])
def test_linreg_fit_equals_jax(l2):
    x, y = design(1)
    want = np.asarray(lin(JAX).linreg_fit(jnp.asarray(x), jnp.asarray(y),
                                          l2=l2))
    got = lin(PORT).linreg_fit(torch.from_numpy(x), torch.from_numpy(y),
                               l2=l2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    q = design(2, n=16)[0]
    np.testing.assert_allclose(
        lin(PORT).linreg_predict(torch.from_numpy(got),
                                 torch.from_numpy(q)).numpy(),
        np.asarray(lin(JAX).linreg_predict(jnp.asarray(want),
                                           jnp.asarray(q))), atol=1e-5)


def test_batched_linreg_fit_equals_jax_vmap():
    """The stock template's batched call against JAX's ``vmap``: one
    [B, K+1, K+1] factorization, each row its own solve."""
    xs, ys = zip(*(design(s, n=40, k=3) for s in range(6)))
    x, y = np.stack(xs), np.stack(ys)
    x[2] = 0.0  # an all-zero design: the ridge keeps the Gram definite
    want = np.asarray(jax.vmap(
        lambda a, b: lin(JAX).linreg_fit(a, b, l2=1e-4))(
            jnp.asarray(x), jnp.asarray(y)))
    got = lin(PORT).linreg_fit(torch.from_numpy(x), torch.from_numpy(y),
                               l2=1e-4).numpy()
    assert got.shape == (6, 4)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def singular_design():
    """A duplicated feature column, integer-valued so that the Gram's
    failing pivot is exactly 0 in f32: not positive definite at l2 0."""
    col = np.array([1.0, 2.0, 1.0, 2.0] * 4, np.float32)
    x = np.stack([col, col], axis=1)
    y = np.arange(16, dtype=np.float32)
    return x, y


def test_singular_gram_gives_nan_in_both():
    x, y = singular_design()
    want = np.asarray(lin(JAX).linreg_fit(jnp.asarray(x), jnp.asarray(y)))
    got = lin(PORT).linreg_fit(torch.from_numpy(x),
                               torch.from_numpy(y)).numpy()
    assert np.isnan(want).all() and np.isnan(got).all()
    # batched: only the singular system's row is NaN
    xb = np.stack([x, x + np.eye(16, 2, dtype=np.float32)])
    yb = np.stack([y, y])
    jb = np.asarray(jax.vmap(lin(JAX).linreg_fit)(jnp.asarray(xb),
                                                  jnp.asarray(yb)))
    tb = lin(PORT).linreg_fit(torch.from_numpy(xb),
                              torch.from_numpy(yb)).numpy()
    np.testing.assert_array_equal(np.isnan(tb), np.isnan(jb))
    assert np.isnan(tb[0]).all() and np.isfinite(tb[1]).all()
    np.testing.assert_allclose(tb[1], jb[1],
                               atol=1e-4 * np.abs(jb[1]).max())
    # a ridge makes the same system definite in both; how it splits the
    # weight between the two copies is ill-conditioned, their sum and the
    # intercept are not
    tw = lin(PORT).linreg_fit(torch.from_numpy(x), torch.from_numpy(y),
                              l2=1e-3).numpy()
    jw = np.asarray(lin(JAX).linreg_fit(jnp.asarray(x), jnp.asarray(y),
                                        l2=1e-3))
    np.testing.assert_allclose([tw[0] + tw[1], tw[2]],
                               [jw[0] + jw[1], jw[2]], rtol=1e-5)


@pytest.mark.parametrize("l2", [0.0, 0.05])
def test_linreg_fit_sgd_equals_jax(l2):
    x, y = design(3)
    want = np.asarray(lin(JAX).linreg_fit_sgd(
        jnp.asarray(x), jnp.asarray(y), steps=200, step_size=0.1, l2=l2))
    got = lin(PORT).linreg_fit_sgd(torch.from_numpy(x), torch.from_numpy(y),
                                   steps=200, step_size=0.1, l2=l2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_regression_template.py through both packages
# ---------------------------------------------------------------------------

def seed_points(p):
    app_id = p.seed_app("regapp")
    rng = np.random.default_rng(1)
    events = []
    for i in range(150):
        x = rng.normal(size=3)
        y = float(x @ W_TRUE + INTERCEPT + rng.normal(0, 0.05))
        events.append(p.Event(
            event="$set", entity_type="point", entity_id=f"p{i}",
            properties=p.DataMap({"label": y,
                                  "features": [float(v) for v in x]})))
    p.insert(app_id, events)


def params(p, eval_k=0, algos=("linear", "sgd")):
    r = reg(p)
    algo_params = {
        "linear": r.LinearAlgorithmParams(l2=0.0),
        "sgd": r.SGDAlgorithmParams(num_iterations=300, step_size=0.1),
    }
    return p.engine_params(r.DataSourceParams(app_name="regapp",
                                              eval_k=eval_k),
                           [(a, algo_params[a]) for a in algos])


def train(p, ep):
    seed_points(p)
    engine = reg(p).RegressionEngine().apply()
    return engine, engine.train(p.ctx(), ep)


@BOTH
def test_linear_recovers_planted_weights(p):
    _e, models = train(p, params(p, algos=("linear",)))
    w = np.asarray(models[0].weights)
    np.testing.assert_allclose(w[:3], W_TRUE, atol=0.05)
    assert abs(w[3] - INTERCEPT) < 0.05  # intercept last


@BOTH
def test_sgd_agrees_with_exact_solve(p):
    _e, models = train(p, params(p))
    np.testing.assert_allclose(np.asarray(models[1].weights),
                               np.asarray(models[0].weights), atol=0.1)


@BOTH
def test_average_serving_over_both_algorithms(p):
    ep = params(p)
    engine, models = train(p, ep)
    q = reg(p).Query(features=(1.0, 2.0, -1.0))
    preds = [a.predict(m, q) for a, m in zip(p.algorithms(engine, ep),
                                             models)]
    served = p.serving(engine, ep).serve(q, preds)
    assert served == pytest.approx(sum(preds) / 2)
    truth = float(np.array(q.features) @ W_TRUE + INTERCEPT)
    assert abs(served - truth) < 0.2


def test_served_averages_equal_across_packages():
    """The same events through both packages: the weights of both
    algorithms within 1e-5 and every served average within 1e-5."""
    out = {}
    for p in PKGS:
        ep = params(p)
        engine, models = train(p, ep)
        algos, serving = p.algorithms(engine, ep), p.serving(engine, ep)
        qs = [reg(p).Query(features=tuple(float(v) for v in row))
              for row in design(7, n=20)[0]]
        out[p.name] = ([np.asarray(m.weights) for m in models],
                       [serving.serve(q, [a.predict(m, q) for a, m in
                                          zip(algos, models)]) for q in qs])
    for jw, tw in zip(out["jax"][0], out["port"][0]):
        np.testing.assert_allclose(tw, jw, atol=1e-5)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], atol=1e-5)
    assert all(isinstance(v, float) for v in out["port"][1])


@BOTH
def test_file_datasource_reads_lr_data_format(p, tmp_path):
    rows = ["1.5 1.0 0.0 0.0", "0.5 0.0 1.0 0.0", "2.5 1.0 1.0 1.0"]
    path = tmp_path / "lr_data.txt"
    path.write_text("\n".join(rows) + "\n")
    r = reg(p)
    ds = r.engine.RegressionDataSource(r.DataSourceParams(filepath=str(path)))
    td = ds.read_training(p.ctx())
    assert len(td.labeled_points) == 3
    assert td.labeled_points[0].label == 1.5
    assert td.labeled_points[2].features == (1.0, 1.0, 1.0)


@BOTH
def test_eval_workflow_mse(p, tmp_path):
    seed_points(p)
    engine = reg(p).RegressionEngine().apply()
    evaluation = p.evaluation.Evaluation()
    evaluation.engine_evaluator = (
        engine, p.evaluation.MetricEvaluator(
            reg(p).MeanSquareError(),
            output_path=str(tmp_path / "best.json")))
    good = params(p, eval_k=3, algos=("linear",))
    _iid, result = p.CoreWorkflow.run_evaluation(
        evaluation, [good], **({"ctx": p.ctx()} if p is PORT else {}))
    # planted noise sigma = 0.05 → MSE floor ≈ 0.0025
    assert result.best_score.score < 0.01
    assert (tmp_path / "best.json").exists()


@BOTH
def test_wire_format_parity(p):
    q = p.codec.extract(reg(p).Query, {"features": [1.0, 2.0, 3.0]})
    assert q.features == (1.0, 2.0, 3.0)
    # predictions are bare doubles on the wire (the reference serves
    # Double through LAverageServing)
    assert p.codec.to_jsonable(1.25) == 1.25


def test_average_serving_is_exported_as_in_jax():
    from incubator_predictionio_tpu import core as jax_core
    from incubator_predictionio_tpu_torch import core

    assert core.AverageServing().serve(None, [1.0, 2.0, 4.5]) == \
        jax_core.AverageServing().serve(None, [1.0, 2.0, 4.5]) == 2.5
    assert set(jax_core.__all__) == set(core.__all__)
    assert core.AverageServing.FIRST_PREDICTION_ONLY is False


# ---------------------------------------------------------------------------
# pio eval and JAX blobs
# ---------------------------------------------------------------------------

def test_pio_eval_through_the_port_cli_matches_jax(tmp_path):
    """``pio eval`` of chip_smoke's regression evaluation module through the
    port's CLI, and the JAX package's ``run_evaluation`` of the same
    objects, on one lr_data.txt file: the same stored MSE."""
    import chip_smoke

    x, y = chip_smoke.reg_points(300)
    path = tmp_path / "lr_data.txt"
    np.savetxt(path, np.column_stack([y, x]), fmt="%.17g")
    _one_liner, port_json = chip_smoke.pio_eval(
        str(tmp_path), torch.device(CPU), "reg_evaluation",
        chip_smoke.REG_EVAL_MODULE.format(path=str(path)))
    r = reg(JAX)
    evaluation = JAX.evaluation.Evaluation()
    evaluation.engine_metric = (r.RegressionEngine().apply(),
                                r.MeanSquareError())
    ep = JAX.engine_params(
        r.DataSourceParams(filepath=str(path), eval_k=3),
        [("linear", r.LinearAlgorithmParams(l2=0.0)),
         ("sgd", r.SGDAlgorithmParams(num_iterations=200, step_size=0.1))])
    iid, _result = JAX.CoreWorkflow.run_evaluation(evaluation, [ep])
    inst = JAX.Storage.get_meta_data_evaluation_instances().get(iid)
    jax_json = json.loads(inst.evaluator_results_json)
    got = port_json["engineParamsScores"][0]["score"]["score"]
    want = jax_json["engineParamsScores"][0]["score"]["score"]
    # each prediction an f32 product in both: a last-digit difference
    assert got == pytest.approx(want, rel=1e-5)
    assert port_json["bestEngineParams"] == jax_json["bestEngineParams"]
    assert abs(got - 0.01) < 0.002


def test_jax_blob_resolves_in_the_port():
    ep_j, ep_t = params(JAX), params(PORT)
    _e, jms = train(JAX, ep_j)
    blob = JAX.checkpoint.serialize_models(jms, "inst", JAX.ctx())
    restored = PORT.checkpoint.deserialize_models(blob)
    assert type(restored[0]) is reg(PORT).engine.RegressionModel
    engine = reg(PORT).RegressionEngine().apply()
    algos, serving = PORT.algorithms(engine, ep_t), PORT.serving(engine, ep_t)
    tms = [a.prepare_model(PORT.ctx(), m) for a, m in zip(algos, restored)]
    assert isinstance(tms[0].weights, torch.Tensor)
    j_eng = reg(JAX).RegressionEngine().apply()
    j_algos, j_serving = JAX.algorithms(j_eng, ep_j), JAX.serving(j_eng, ep_j)
    for row in design(8, n=10)[0]:
        feats = tuple(float(v) for v in row)
        tq, jq = reg(PORT).Query(features=feats), reg(JAX).Query(
            features=feats)
        got = serving.serve(tq, [a.predict(m, tq)
                                 for a, m in zip(algos, tms)])
        want = j_serving.serve(jq, [a.predict(m, jq)
                                    for a, m in zip(j_algos, jms)])
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_chip_smoke_regression_leg_rehearses_on_the_cpu():
    """chip_smoke.py's regression leg at its small size on the CPU: the
    lr_data.txt read, ``pio train`` and ``pio eval`` in process, lstsq and
    the CPU fit held, the served averages."""
    import chip_smoke
    from incubator_predictionio_tpu_torch import runtime
    from incubator_predictionio_tpu_torch.servers import (
        prediction_server as server_mod,
    )

    err, stats = chip_smoke.regression_leg(torch.device(CPU),
                                           server_mod, small=True)
    assert stats["linear_vs_lstsq"] <= chip_smoke.LINREG_LSTSQ_TOL
    assert stats["sgd_card_vs_cpu"] == 0.0 and err < 1e-3
    assert abs(stats["mse"] - 0.01) < 1e-3
