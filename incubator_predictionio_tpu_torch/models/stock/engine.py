"""Stock backtesting engine (the scala-stock experimental template): the
port of incubator_predictionio_tpu/models/stock/engine.py (:100-139 the
price panel, :142-171 the shift returns, :174-323 the strategies,
:326-458 the backtest).

Reference parity (examples/experimental/scala-stock/src/main/scala/):

- a price panel over (time × tickers) with an active mask (Data.scala
  RawData: _price/_active arrays); ``read_eval`` hands the panel to the
  evaluator in ``EvalInfo.td``;
- strategies scoring every ticker each day: ``empty`` (Algorithm.scala
  EmptyStrategy), ``momentum`` (a ShiftsIndicator-style windowed log
  return, Indicators.scala:40) and ``regression`` (RegressionStrategy.
  scala: per-ticker linear regression of the next-day return on
  shift-return indicators);
- a backtesting evaluator (BackTestingMetrics.scala): daily enter / exit
  by score thresholds under a position cap, NAV tracking, and an
  OverallStat of return, volatility and Sharpe. It is an ``Evaluator``,
  not a ``MetricEvaluator``: ``pio eval`` stores its one-liner, HTML and
  JSON through ``CoreWorkflow.run_evaluation``.

The regression strategy fits every ticker at once on the card: one
batched ``linreg_fit`` (``cholesky_ex`` / ``cholesky_solve`` over
[tickers, F+1, F+1]; the JAX package ``vmap``s the same solve), a ticker
whose Gram is not positive definite getting NaN weights as there. Its
weights stay on ``ctx.device`` and a day's scores are one device product
in f64. The panel and the day's features (``_row_log_returns``) are host
numpy, as in the JAX package.

Prices live in the event store as ``price`` events on ``ticker`` entities
(``properties.price``, the event time the trading day): the
YahooDataSource role without the HTTP fetch.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from incubator_predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    Evaluator,
    FirstServing,
    IdentityPreparator,
    Params,
)
from incubator_predictionio_tpu_torch.core.engine import Engine, EngineFactory
from incubator_predictionio_tpu_torch.data.store import EventStore
from incubator_predictionio_tpu_torch.ops.linreg import linreg_fit
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Query:
    """Score all tickers as of time index ``idx`` (Data.scala QueryDate)."""

    __camel_case__ = True

    idx: int


@dataclasses.dataclass(frozen=True)
class Prediction:
    __camel_case__ = True

    #: ticker → strategy score (Data.scala Prediction's HashMap)
    scores: Dict[str, float]


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    __camel_case__ = True

    app_name: str
    entity_type: str = "ticker"
    event_name: str = "price"
    price_attr: str = "price"
    market_ticker: str = "SPY"
    #: first index handed to eval queries + how many eval days
    eval_from_idx: int = 30
    eval_days: int = 0


@dataclasses.dataclass
class TrainingData:
    prices: np.ndarray       # [T, N] f64, NaN where inactive
    active: np.ndarray       # [T, N] bool
    tickers: Tuple[str, ...]
    times: Tuple[Any, ...]   # [T] event datetimes (trading days)
    market_ticker: str

    def sanity_check(self) -> None:
        if self.prices.size == 0:
            raise ValueError("TrainingData has no prices")


@dataclasses.dataclass(frozen=True)
class EvalInfo:
    from_idx: int
    #: the panel the queries index into — rides with the eval set so the
    #: backtesting evaluator can simulate against real prices
    td: Optional["TrainingData"] = None


class StockDataSource(DataSource):
    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        by_day: Dict[Any, Dict[str, float]] = {}
        tickers: set = set()
        for ev in EventStore.find(
                app_name=self.params.app_name,
                entity_type=self.params.entity_type,
                event_names=(self.params.event_name,)):
            price = ev.properties.get_or_else(self.params.price_attr, None)
            if not isinstance(price, (int, float)) or isinstance(price, bool):
                continue
            day = ev.event_time.date()
            by_day.setdefault(day, {})[ev.entity_id] = float(price)
            tickers.add(ev.entity_id)
        days = sorted(by_day)
        names = sorted(tickers)
        col = {t: j for j, t in enumerate(names)}
        prices = np.full((len(days), len(names)), np.nan)
        for i, day in enumerate(days):
            for t, p in by_day[day].items():
                prices[i, col[t]] = p
        return TrainingData(
            prices=prices,
            active=~np.isnan(prices),
            tickers=tuple(names),
            times=tuple(days),
            market_ticker=self.params.market_ticker,
        )

    def read_eval(self, ctx: RuntimeContext):
        if self.params.eval_days <= 0:
            return []
        td = self.read_training(ctx)
        lo = self.params.eval_from_idx
        hi = min(len(td.times) - 1, lo + self.params.eval_days)
        qa = [(Query(idx=i), None) for i in range(lo, hi)]
        return [(td, EvalInfo(from_idx=lo, td=td), qa)]


def _log_returns(prices: np.ndarray, period: int) -> np.ndarray:
    """log p_t − log p_{t−period}, 0 where undefined (ShiftsIndicator).

    Callers MUST also mask on activity at both endpoints: the NaN→1
    placeholder turns a missing endpoint into ±log(p) ≈ ±4.6 — two
    orders of magnitude above a real daily return."""
    logp = np.log(np.where(np.isnan(prices), 1.0, prices))
    out = np.zeros_like(logp)
    out[period:] = logp[period:] - logp[:-period]
    return out


def _row_log_returns(prices: np.ndarray, active: np.ndarray, i: int,
                     periods: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Features for ONE day: ([N, F] shift returns, [N] validity) — the
    serving-path form, touching only the |periods|+1 rows it needs
    instead of re-deriving the whole [0..i] prefix per query."""
    n = prices.shape[1]
    feats = np.zeros((n, len(periods)))
    ok = active[i].copy()
    logp_i = np.log(np.where(active[i], prices[i], 1.0))
    for f, p in enumerate(periods):
        if i < p:
            ok[:] = False
            break
        ok &= active[i - p]
        logp_prev = np.log(np.where(active[i - p], prices[i - p], 1.0))
        feats[:, f] = logp_i - logp_prev
    return feats, ok


@dataclasses.dataclass
class StockModel:
    td: TrainingData
    #: [N, F+1] regression weights (intercept last), a tensor on the
    #: device; None for non-regression strategies
    weights: Optional[np.ndarray]
    params: Any


@dataclasses.dataclass(frozen=True)
class EmptyStrategyParams(Params):
    __camel_case__ = True


class EmptyStrategy(Algorithm):
    """Algorithm.scala EmptyStrategy: predicts nothing for every day."""

    params_class = EmptyStrategyParams
    query_class_ = Query

    def __init__(self, params: EmptyStrategyParams = EmptyStrategyParams()):
        super().__init__(params)

    def train(self, ctx: RuntimeContext, td: TrainingData) -> StockModel:
        return StockModel(td=td, weights=None, params=self.params)

    def predict(self, model: StockModel, query: Query) -> Prediction:
        return Prediction(scores={})


@dataclasses.dataclass(frozen=True)
class MomentumStrategyParams(Params):
    __camel_case__ = True

    window: int = 5


class MomentumStrategy(Algorithm):
    """Windowed log return per ticker — the ShiftsIndicator as a
    standalone strategy."""

    params_class = MomentumStrategyParams
    query_class_ = Query

    def __init__(self,
                 params: MomentumStrategyParams = MomentumStrategyParams()):
        super().__init__(params)

    def train(self, ctx: RuntimeContext, td: TrainingData) -> StockModel:
        return StockModel(td=td, weights=None, params=self.params)

    def predict(self, model: StockModel, query: Query) -> Prediction:
        td = model.td
        w = model.params.window
        i = query.idx
        if not 0 <= i < len(td.times) or i < w:
            return Prediction(scores={})
        feats, ok = _row_log_returns(td.prices, td.active, i, (w,))
        return Prediction(scores={
            t: float(feats[j, 0])
            for j, t in enumerate(td.tickers) if ok[j]
        })


@dataclasses.dataclass(frozen=True)
class RegressionStrategyParams(Params):
    __camel_case__ = True

    #: shift-return indicator periods (RegressionStrategy.scala's
    #: ShiftsIndicator set)
    periods: Tuple[int, ...] = (1, 5, 22)
    max_training_window: int = 250
    #: ridge keeps the solve conditioned when indicators are near-collinear
    #: (steady trends make every shift-return a multiple of the 1-day one)
    l2: float = 1e-4


class RegressionStrategy(Algorithm):
    """Per-ticker next-day-return regression on shift-return indicators.

    The reference fits one breeze regression per ticker in a Scala loop
    (RegressionStrategy.scala:regress); here every ticker's normal
    equations solve in one batched device call (ops/linreg.py)."""

    params_class = RegressionStrategyParams
    query_class_ = Query

    def __init__(
        self,
        params: RegressionStrategyParams = RegressionStrategyParams(),
    ):
        super().__init__(params)

    def _features(self, prices: np.ndarray) -> np.ndarray:
        # [T, N, F] indicator stack
        return np.stack(
            [_log_returns(prices, p) for p in self.params.periods], axis=-1)

    def train(self, ctx: RuntimeContext, td: TrainingData) -> StockModel:
        t_end = len(td.times)
        t_start = max(max(self.params.periods) + 1,
                      t_end - self.params.max_training_window)
        if t_end - t_start < len(self.params.periods) + 2:
            return StockModel(td=td, weights=None, params=self.params)
        feats = self._features(td.prices)              # [T, N, F]
        next_ret = np.zeros_like(td.prices)
        next_ret[:-1] = _log_returns(td.prices, 1)[1:]  # ret of t→t+1
        x = feats[t_start:t_end - 1]                    # [S, N, F]
        y = next_ret[t_start:t_end - 1]                 # [S, N]
        # a sample is valid only when every endpoint it touches is active:
        # the day itself, the NEXT day (the target), and each feature's
        # t−period day — otherwise the NaN placeholder injects ±log(p)
        # outliers two orders above real returns
        ok = (td.active[t_start:t_end - 1]
              & td.active[t_start + 1:t_end])
        for p in self.params.periods:
            ok = ok & td.active[t_start - p:t_end - 1 - p]
        ok = ok[..., None]
        x = np.where(ok, x, 0.0)
        y = np.where(ok[..., 0], y, 0.0)
        # every ticker's normal equations in one batched solve
        weights = linreg_fit(
            torch.as_tensor(np.ascontiguousarray(        # [N, S, F]
                np.swapaxes(x, 0, 1), np.float32), device=ctx.device),
            torch.as_tensor(np.ascontiguousarray(        # [N, S]
                y.T, np.float32), device=ctx.device),
            l2=self.params.l2)
        return StockModel(td=td, weights=weights, params=self.params)

    def prepare_model(self, ctx: RuntimeContext,
                      model: StockModel) -> StockModel:
        if model.weights is None:
            return model
        return dataclasses.replace(model, weights=torch.as_tensor(
            model.weights).to(device=ctx.device, dtype=torch.float32))

    def predict(self, model: StockModel, query: Query) -> Prediction:
        td = model.td
        i = query.idx
        if model.weights is None or not 0 <= i < len(td.times):
            return Prediction(scores={})
        feats, ok = _row_log_returns(td.prices, td.active, i,
                                     model.params.periods)
        aug = np.concatenate([feats, np.ones((feats.shape[0], 1))], axis=1)
        w = model.weights
        scores = (torch.from_numpy(aug).to(w.device)
                  * w.to(torch.float64)).sum(dim=1).cpu().numpy()
        return Prediction(scores={
            t: float(scores[j])
            for j, t in enumerate(td.tickers) if ok[j]
        })


# ---------------------------------------------------------------------------
# Backtesting (BackTestingMetrics.scala)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BacktestingParams(Params):
    __camel_case__ = True

    enter_threshold: float = 0.0
    exit_threshold: float = 0.0
    max_positions: int = 1


@dataclasses.dataclass
class DailyStat:
    time: Any
    nav: float
    ret: float
    market: float
    position_count: int


@dataclasses.dataclass
class OverallStat:
    ret: float
    vol: float
    sharpe: float
    days: int


@dataclasses.dataclass
class BacktestingResult:
    daily: List[DailyStat]
    overall: OverallStat

    def to_one_liner(self) -> str:
        o = self.overall
        return (f"ret={o.ret:.4f} vol={o.vol:.4f} sharpe={o.sharpe:.2f} "
                f"days={o.days}")

    def to_jsonable(self) -> dict:
        return {
            "overall": dataclasses.asdict(self.overall),
            "daily": [
                {**dataclasses.asdict(d), "time": str(d.time)}
                for d in self.daily
            ],
        }

    def to_html(self) -> str:
        """BacktestingResult's NiceRendering role (the reference renders
        html.backtesting(); a NAV table serves the dashboard here)."""
        rows = "".join(
            f"<tr><td>{d.time}</td><td>{d.nav:.4f}</td>"
            f"<td>{d.ret:+.4%}</td><td>{d.market:+.4%}</td>"
            f"<td>{d.position_count}</td></tr>"
            for d in self.daily
        )
        o = self.overall
        return (
            f"<h3>Backtest: ret={o.ret:.2%} vol={o.vol:.2%} "
            f"sharpe={o.sharpe:.2f} over {o.days} days</h3>"
            "<table border=1><tr><th>date</th><th>NAV</th><th>ret</th>"
            f"<th>market</th><th>positions</th></tr>{rows}</table>"
        )


class BacktestingEvaluator(Evaluator):
    """Simulates the daily enter/exit book the reference's evaluator keeps
    (BackTestingMetrics.scala evaluateUnit/evaluateAll): scores ≥
    enterThreshold queue entries (best first, up to maxPositions), scores
    ≤ exitThreshold close positions, NAV compounds the equal-weighted
    next-day return of the held names."""

    def __init__(self, params: BacktestingParams = BacktestingParams()):
        super().__init__()
        self.params = params

    def _backtest(self, td: TrainingData,
                  day_preds: List[Tuple[int, Prediction]]) -> BacktestingResult:
        p = self.params
        positions: set = set()
        nav = 1.0
        daily: List[DailyStat] = []
        ret1 = np.zeros_like(td.prices)
        ret1[1:] = td.prices[1:] / td.prices[:-1] - 1.0  # NaN where gaps
        col = {t: j for j, t in enumerate(td.tickers)}
        mkt = col.get(td.market_ticker)
        for idx, pred in sorted(day_preds, key=lambda kv: kv[0]):
            if idx + 1 >= len(td.times):
                break
            ranked = sorted(pred.scores.items(), key=lambda kv: -kv[1])
            for t, s in ranked:
                if s <= p.exit_threshold:
                    positions.discard(t)
            for t, s in ranked:
                if s >= p.enter_threshold and len(positions) < p.max_positions:
                    positions.add(t)
            rets = [
                float(ret1[idx + 1, col[t]]) for t in positions
                if t in col and np.isfinite(ret1[idx + 1, col[t]])
            ]
            day_ret = float(np.mean(rets)) if rets else 0.0
            nav *= 1.0 + day_ret
            market = (float(ret1[idx + 1, mkt])
                      if mkt is not None
                      and np.isfinite(ret1[idx + 1, mkt]) else 0.0)
            daily.append(DailyStat(
                time=td.times[idx], nav=nav, ret=day_ret, market=market,
                position_count=len(positions)))
        rets = np.array([d.ret for d in daily]) if daily else np.zeros(1)
        vol = float(rets.std() * math.sqrt(252))
        mean = float(rets.mean() * 252)
        overall = OverallStat(
            ret=nav - 1.0,
            vol=vol,
            sharpe=mean / vol if vol > 0 else 0.0,
            days=len(daily),
        )
        return BacktestingResult(daily=daily, overall=overall)

    def evaluate(self, ctx: RuntimeContext, evaluation: Any,
                 engine_eval_data_set: Sequence[Tuple[Any, Any]],
                 params: Any = None) -> BacktestingResult:
        best: Optional[BacktestingResult] = None
        for _engine_params, eval_data in engine_eval_data_set:
            for info, qpas in eval_data:
                if info.td is None:
                    raise ValueError(
                        "EvalInfo.td missing — use StockDataSource's "
                        "read_eval")
                day_preds = [(q.idx, pr) for q, pr, _a in qpas]
                result = self._backtest(info.td, day_preds)
                if best is None or result.overall.ret > best.overall.ret:
                    best = result
        if best is None:
            raise ValueError("no evaluation data to backtest")
        return best


class StockEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            StockDataSource,
            IdentityPreparator,
            {
                "empty": EmptyStrategy,
                "momentum": MomentumStrategy,
                "regression": RegressionStrategy,
            },
            FirstServing,
        )
