"""Planted ground truth through the port's engine on the CPU: the port of
tests/test_quality_planted.py::test_heldout_rmse_recovers_noise_floor.

The same planted ratings (3.5 + U·Vᵀ + N(0, σ), preference-biased
observation, seed 11) go into the port's event store, ``Engine.train``
fits them, and the RMSE on fresh (user, item) pairs, never observed, must
approach the noise floor, with the JAX test's bar (RMSE < 2.5·σ). The JAX
engine trained on the same events clears the same bar beside it.
"""

import numpy as np
import pytest

from incubator_predictionio_tpu.core import EngineParams as JEngineParams
from incubator_predictionio_tpu.data.datamap import DataMap as JDataMap
from incubator_predictionio_tpu.data.event import Event as JEvent
from incubator_predictionio_tpu.data.storage import App as JApp
from incubator_predictionio_tpu.data.storage import Storage as JStorage
from incubator_predictionio_tpu.models.recommendation import engine as jeng
from incubator_predictionio_tpu.parallel.context import (
    RuntimeContext as JContext,
)
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage import App, Storage
from incubator_predictionio_tpu_torch.models.recommendation import (
    engine as teng,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

N_USERS, N_ITEMS, PLANT_RANK = 60, 40, 3
SIGMA = 0.2
DENSITY = 0.5
MEMORY = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}


@pytest.fixture
def planted():
    """The JAX test's planted ratings, into both packages' memory stores;
    returns (U, V, the observed (u, i) pairs)."""
    rng = np.random.default_rng(11)
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
    for storage, app_cls, ev, dm in ((Storage, App, Event, DataMap),
                                     (JStorage, JApp, JEvent, JDataMap)):
        storage.configure(dict(MEMORY))
        app_id = storage.get_meta_data_apps().insert(app_cls(0, "planted"))
        storage.get_events().insert_batch([ev(
            event="rate", entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id=f"i{i}",
            properties=dm({"rating": float(r)}))
            for u, i, r in zip(users, items, ratings)], app_id)
    yield u_true, v_true, set(zip(users.tolist(), items.tolist()))
    Storage.reset()
    JStorage.reset()


def _heldout_rmse(model, u_true, v_true, seen) -> float:
    """The JAX test's measure: 2,000 random pairs, the observed skipped."""
    rng = np.random.default_rng(3)
    err, n = 0.0, 0
    uf = np.asarray(model.user_factors)
    vf = np.asarray(model.item_factors)
    for _ in range(2000):
        u = int(rng.integers(N_USERS))
        i = int(rng.integers(N_ITEMS))
        if (u, i) in seen:
            continue
        ui = model.user_bimap.get(f"u{u}")
        ii = model.item_bimap.get(f"i{i}")
        if ui is None or ii is None:
            continue
        pred = float(uf[ui] @ vf[ii])
        err += (pred - (3.5 + float(u_true[u] @ v_true[i]))) ** 2
        n += 1
    assert n > 300
    return float(np.sqrt(err / n))


def test_heldout_rmse_recovers_noise_floor(planted):
    """Trained on the observed half, the port recovers the planted
    structure: heldout RMSE < 2.5·σ, where the ratings' stdev is ≈ 1.1;
    the JAX engine's on the same events is held to the same bar."""
    u_true, v_true, seen = planted
    als_kw = dict(rank=8, num_iterations=12, lambda_=0.05, seed=7)
    model = teng.RecommendationEngine().apply().train(
        RuntimeContext(device="cpu"), EngineParams(
            data_source_params=("", teng.DataSourceParams(
                app_name="planted")),
            algorithm_params_list=[("als",
                                    teng.ALSAlgorithmParams(**als_kw))]))[0]
    ref = jeng.RecommendationEngine().apply().train(
        JContext(), JEngineParams(
            data_source_params=("", jeng.DataSourceParams(
                app_name="planted")),
            algorithm_params_list=[("als",
                                    jeng.ALSAlgorithmParams(**als_kw))]))[0]
    rmse = _heldout_rmse(model, u_true, v_true, seen)
    rmse_ref = _heldout_rmse(ref, u_true, v_true, seen)
    assert rmse < 2.5 * SIGMA, rmse
    assert rmse_ref < 2.5 * SIGMA, rmse_ref
