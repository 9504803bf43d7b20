"""The port's DASE engine: four slots and the training run (ports of
tests/test_engine.py's wiring cases against the port's ``Engine``)."""

import dataclasses

import pytest

from incubator_predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    EmptyParams,
    IdentityPreparator,
    Params,
    Preparator,
    SanityCheck,
    Serving,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
)
from incubator_predictionio_tpu_torch.core.engine import Engine
from incubator_predictionio_tpu_torch.core.params import (
    EngineParams,
    WorkflowParams,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext


@dataclasses.dataclass(frozen=True)
class IdParams(Params):
    id: int = 0


@dataclasses.dataclass
class TD(SanityCheck):
    ds_id: int
    ok: bool = True

    def sanity_check(self) -> None:
        if not self.ok:
            raise ValueError("sanity failed")


@dataclasses.dataclass
class PD:
    ds_id: int
    pp_id: int


class DataSource0(DataSource):
    def read_training(self, ctx):
        return TD(self.params.id)


class BadDataSource(DataSource):
    def read_training(self, ctx):
        return TD(self.params.id, ok=False)


class Preparator0(Preparator):
    def prepare(self, ctx, td):
        return PD(td.ds_id, self.params.id)


class Algorithm0(Algorithm):
    def train(self, ctx, pd):
        return (pd.ds_id, pd.pp_id, self.params.id)


class Algorithm1(Algorithm):
    def train(self, ctx, pd):
        return (pd.ds_id, pd.pp_id, 100 + self.params.id)


class Serving0(Serving):
    def serve(self, query, predictions):
        return predictions[0]


def _engine(ds=DataSource0, prep=Preparator0):
    return Engine(ds, prep, {"algo0": Algorithm0, "algo1": Algorithm1},
                  Serving0)


def _params(algos=(("algo0", IdParams(3)),)):
    return EngineParams(data_source_params=("", IdParams(1)),
                        preparator_params=("", IdParams(2)),
                        algorithm_params_list=list(algos),
                        serving_params=("", IdParams(4)))


@pytest.fixture
def ctx():
    return RuntimeContext(device="cpu")


def test_train_runs_every_algorithm_in_order(ctx):
    models = _engine().train(ctx, _params(
        [("algo0", IdParams(10)), ("algo1", IdParams(20)),
         ("algo0", IdParams(30))]))
    assert models == [(1, 2, 10), (1, 2, 120), (1, 2, 30)]
    assert {"read", "prepare", "train.algo0", "train.algo1",
            "train.algo2"} <= set(ctx.timings)


def test_unknown_algorithm_name_raises(ctx):
    with pytest.raises(ValueError, match="algorithm"):
        _engine().train(ctx, _params([("nope", IdParams(1))]))


def test_stop_after_read_and_prepare(ctx):
    with pytest.raises(StopAfterReadInterruption):
        _engine().train(ctx, _params(), WorkflowParams(stop_after_read=True))
    with pytest.raises(StopAfterPrepareInterruption):
        _engine().train(ctx, _params(),
                        WorkflowParams(stop_after_prepare=True))


def test_sanity_check_runs_and_can_be_skipped(ctx):
    engine = _engine(ds=BadDataSource)
    with pytest.raises(ValueError, match="sanity failed"):
        engine.train(ctx, _params())
    assert engine.train(ctx, _params(),
                        WorkflowParams(skip_sanity_check=True)) == [(1, 2, 3)]


def test_identity_preparator_and_components(ctx):
    class Algo(Algorithm):
        def train(self, ctx, td):
            return td

    engine = Engine(DataSource0, IdentityPreparator, Algo, Serving0)
    params = EngineParams(data_source_params=("", IdParams(7)))
    assert engine.train(ctx, params) == [TD(7)]
    algorithms, serving = engine.components(params)
    assert [type(a) for a in algorithms] == [Algo]
    assert isinstance(serving, Serving0)
    assert isinstance(algorithms[0].params, EmptyParams)
