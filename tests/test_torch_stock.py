"""The port's stock template (``models/stock/``) against the JAX package's,
on the CPU, each package on a memory store of its own with the same
events:

- every case of tests/test_stock_template.py through both packages;
- the panel equal, the regression strategy's weights (one batched solve
  in the port, a ``vmap`` in JAX) within 1e-4 of max |w| of JAX's, every
  day's scores within 1e-6 of JAX's;
- the backtest of ``CoreWorkflow.run_evaluation`` equal across the
  packages (one-liner, daily NAV and positions), and ``pio eval`` through
  the port's CLI (in this process) storing what the JAX package's
  ``run_evaluation`` stores;
- a JAX-trained blob decoded and served by the port;
- ``chip_smoke.py``'s stock leg, rehearsed at its small size.
"""

import json
from datetime import datetime, timedelta, timezone

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

T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
N_DAYS = 80


def st(p):
    return p.mod("models.stock")


def ste(p):
    return p.mod("models.stock.engine")


def seeded_app(p, gappy: bool = False):
    """tests/test_stock_template.py's fixture: UP compounds +1%/day, DOWN
    −1%/day, SPY flat with tiny noise; with ``gappy``, NEW lists on day
    50 (test_gappy_ticker_is_masked_not_poisoned)."""
    app_id = p.seed_app("stockapp")
    rng = np.random.default_rng(0)
    series = {
        "UP": 100.0 * np.cumprod(
            1.01 + 0.002 * rng.standard_normal(N_DAYS)),
        "DOWN": 100.0 * np.cumprod(
            0.99 + 0.002 * rng.standard_normal(N_DAYS)),
        "SPY": 100.0 * (1 + 0.0005 * rng.standard_normal(N_DAYS)).cumprod(),
    }
    events = [p.Event(event="price", entity_type="ticker", entity_id=t,
                      properties=p.DataMap({"price": float(price)}),
                      event_time=T0 + timedelta(days=d))
              for t, prices in series.items()
              for d, price in enumerate(prices)]
    if gappy:
        rng = np.random.default_rng(9)
        events += [p.Event(
            event="price", entity_type="ticker", entity_id="NEW",
            properties=p.DataMap(
                {"price": float(50.0 * (1.005 + 0.002 *
                                        rng.standard_normal()) ** (d - 50))}),
            event_time=T0 + timedelta(days=d)) for d in range(50, N_DAYS)]
    p.insert(app_id, events)
    return app_id


def _ep(p, algo, algo_params, eval_days=0):
    return p.engine_params(
        st(p).DataSourceParams(app_name="stockapp", eval_from_idx=30,
                               eval_days=eval_days),
        [(algo, algo_params)])


def trained(p, algo, algo_params, gappy=False):
    seeded_app(p, gappy)
    engine = st(p).StockEngine().apply()
    ep = _ep(p, algo, algo_params)
    return engine, ep, engine.train(p.ctx(), ep)


@BOTH
def test_panel_assembly_and_momentum_scores(p):
    engine, ep, models = trained(p, "momentum",
                                 st(p).MomentumStrategyParams(window=5))
    td = models[0].td
    assert td.tickers == ("DOWN", "SPY", "UP")
    assert len(td.times) == N_DAYS
    assert td.active.all()
    algo = p.algorithms(engine, ep)[0]
    pr = algo.predict(models[0], st(p).Query(idx=40))
    assert pr.scores["UP"] > pr.scores["SPY"] > pr.scores["DOWN"]
    assert algo.predict(models[0], st(p).Query(idx=2)).scores == {}


@BOTH
def test_regression_strategy_learns_trend(p):
    engine, ep, models = trained(
        p, "regression", st(p).RegressionStrategyParams(periods=(1, 5, 10)))
    algo = p.algorithms(engine, ep)[0]
    pr = algo.predict(models[0], st(p).Query(idx=60))
    assert pr.scores["UP"] > 0.005
    assert pr.scores["DOWN"] < -0.005


def backtest(p, algo, algo_params, **bt):
    seeded_app(p)
    engine = st(p).StockEngine().apply()
    evaluation = p.evaluation.Evaluation()
    evaluation.engine_evaluator = (
        engine, st(p).BacktestingEvaluator(st(p).BacktestingParams(**bt)))
    ep = _ep(p, algo, algo_params, eval_days=40)
    kw = {"ctx": p.ctx()} if p is PORT else {}
    return p.CoreWorkflow.run_evaluation(evaluation, [ep], **kw)


@BOTH
def test_backtest_evaluator_goes_long_the_winner(p):
    _iid, result = backtest(p, "momentum",
                            st(p).MomentumStrategyParams(window=5),
                            enter_threshold=0.001, exit_threshold=-0.001,
                            max_positions=1)
    assert result.overall.ret > 0.2
    assert result.overall.days > 30
    assert result.overall.sharpe > 1.0
    assert all(d.position_count <= 1 for d in result.daily)
    assert result.to_one_liner().startswith("ret=")


@BOTH
def test_gappy_ticker_is_masked_not_poisoned(p):
    engine, ep, models = trained(
        p, "regression", st(p).RegressionStrategyParams(periods=(1, 5, 10)),
        gappy=True)
    algo = p.algorithms(engine, ep)[0]
    assert np.isfinite(np.asarray(models[0].weights)).all()
    pr = algo.predict(models[0], st(p).Query(idx=55))
    assert "NEW" not in pr.scores
    assert abs(pr.scores["UP"]) < 0.1
    p2 = algo.predict(models[0], st(p).Query(idx=75))
    assert "NEW" in p2.scores and abs(p2.scores["NEW"]) < 0.1


@BOTH
def test_empty_strategy_flat_nav(p):
    _iid, result = backtest(p, "empty", ste(p).EmptyStrategyParams())
    assert result.overall.ret == pytest.approx(0.0)
    assert all(d.position_count == 0 for d in result.daily)


@pytest.mark.parametrize("gappy", [False, True])
def test_regression_equal_across_packages(gappy):
    """One batched solve on the device against JAX's ``vmap``: the weights
    within 1e-4 of max |w|, every day's scores within 1e-6 and over the
    same tickers."""
    out = {}
    for p in PKGS:
        engine, ep, models = trained(
            p, "regression",
            st(p).RegressionStrategyParams(periods=(1, 5, 10)), gappy=gappy)
        algo = p.algorithms(engine, ep)[0]
        out[p.name] = (models[0], [algo.predict(models[0],
                                                st(p).Query(idx=i))
                                   for i in range(N_DAYS)])
    (jm, jp), (tm, tp) = out["jax"], out["port"]
    np.testing.assert_array_equal(tm.td.prices, jm.td.prices)
    assert tm.td.times == jm.td.times
    assert isinstance(tm.weights, torch.Tensor)
    np.testing.assert_allclose(tm.weights.numpy(), jm.weights,
                               atol=1e-4 * np.abs(jm.weights).max())
    for j, t in zip(jp, tp):
        assert set(t.scores) == set(j.scores)
        for k, v in j.scores.items():
            assert t.scores[k] == pytest.approx(v, abs=1e-6)


@pytest.mark.parametrize("algo", ["momentum", "regression"])
def test_backtests_equal_across_packages(algo):
    results = []
    for p in PKGS:
        ap = (st(p).MomentumStrategyParams(window=5) if algo == "momentum"
              else st(p).RegressionStrategyParams(periods=(1, 5, 10)))
        _iid, r = backtest(p, algo, ap, enter_threshold=0.001,
                           exit_threshold=-0.001, max_positions=2)
        results.append(r)
    j, t = results
    assert t.to_one_liner() == j.to_one_liner()
    assert t.to_html() == j.to_html()
    assert t.to_jsonable() == j.to_jsonable()
    assert isinstance(t.daily[0].time, type(j.daily[0].time))


@BOTH
def test_wire_format(p):
    q = p.codec.extract(st(p).Query, {"idx": 7})
    assert q.idx == 7
    assert p.codec.to_jsonable(st(p).Prediction(scores={"UP": 0.5})) == \
        {"scores": {"UP": 0.5}}


def test_pio_eval_through_the_port_cli_matches_jax(tmp_path):
    """``pio eval`` of chip_smoke's stock evaluation module through the
    port's CLI, and the JAX package's ``run_evaluation`` of the same
    objects, on the same planted panel: the same stored one-liner, HTML
    and JSON (the regression strategy's scores within 1e-6 leave every
    entry and exit the same)."""
    import chip_smoke

    tickers, prices, listed = chip_smoke.stock_panel(12, 60)
    for p in PKGS:
        p.insert(p.seed_app("stock-app"), [
            p.Event(event="price", entity_type="ticker",
                    entity_id=tickers[k],
                    properties=p.DataMap({"price": float(prices[d, k])}),
                    event_time=T0 + timedelta(days=d))
            for d in range(60) for k in range(len(tickers))
            if d >= min(listed[k], 30)])
    src = chip_smoke.STOCK_EVAL_MODULE.format(app="stock-app", lo=30,
                                              days=29, hi=58)
    one_liner, port_json = chip_smoke.pio_eval(
        str(tmp_path), torch.device(CPU), "stock_evaluation", src)
    s = st(JAX)
    evaluation = JAX.evaluation.Evaluation()
    evaluation.engine_evaluator = (s.StockEngine().apply(),
                                   s.BacktestingEvaluator(
                                       s.BacktestingParams(
                                           enter_threshold=0.001,
                                           exit_threshold=-0.001,
                                           max_positions=10)))
    eps = [JAX.engine_params(
        s.DataSourceParams(app_name="stock-app", eval_from_idx=30,
                           eval_days=29), [algo])
        for algo in (("momentum", s.MomentumStrategyParams(window=5)),
                     ("regression", s.RegressionStrategyParams()))]
    iid, _result = JAX.CoreWorkflow.run_evaluation(evaluation, eps)
    inst = JAX.Storage.get_meta_data_evaluation_instances().get(iid)
    assert one_liner == inst.evaluator_results
    assert port_json == json.loads(inst.evaluator_results_json)
    port_inst = [i for i in PORT.Storage.get_meta_data_evaluation_instances()
                 .get_all()][0]
    assert port_inst.evaluator_results_html == inst.evaluator_results_html
    assert len(port_json["daily"]) == 29


def test_jax_blob_resolves_in_the_port():
    engine, ep, jms = trained(
        JAX, "regression", st(JAX).RegressionStrategyParams(periods=(1, 5)))
    blob = JAX.checkpoint.serialize_models(jms, "inst", JAX.ctx())
    [restored] = PORT.checkpoint.deserialize_models(blob)
    assert type(restored) is ste(PORT).StockModel
    assert type(restored.params) is ste(PORT).RegressionStrategyParams
    assert restored.td.times == jms[0].td.times
    t_engine = st(PORT).StockEngine().apply()
    t_ep = _ep(PORT, "regression",
               st(PORT).RegressionStrategyParams(periods=(1, 5)))
    talgo = PORT.algorithms(t_engine, t_ep)[0]
    tm = talgo.prepare_model(PORT.ctx(), restored)
    assert tm.weights.dtype == torch.float32
    jalgo = JAX.algorithms(engine, ep)[0]
    for i in (10, 40, 79):
        got = talgo.predict(tm, st(PORT).Query(idx=i)).scores
        want = jalgo.predict(jms[0], st(JAX).Query(idx=i)).scores
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15)


def test_chip_smoke_stock_leg_rehearses_on_the_cpu():
    """chip_smoke.py's stock leg at its small size on the CPU (its 300 days
    and the window kept, 20 tickers and SPY)."""
    import chip_smoke
    from incubator_predictionio_tpu_torch import runtime
    from incubator_predictionio_tpu_torch.servers import (
        prediction_server as server_mod,
    )

    err, stats = chip_smoke.stock_leg(torch.device(CPU),
                                      server_mod, small=True)
    assert stats["weights_vs_f64"] <= chip_smoke.STOCK_F64_TOL
    assert stats["score_err"] < 1e-12 and err <= chip_smoke.STOCK_F64_TOL
    assert stats["overall"]["days"] == chip_smoke.STOCK_EVAL_DAYS
