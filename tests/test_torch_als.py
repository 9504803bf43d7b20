"""The port's ALS training slice (PyTorch, on the CPU) against the JAX
package's, on seeded numpy inputs.

- ``ops/sparse``: the same buckets and split rows as the JAX numpy path;
- ``ops/als`` pieces (``_cg_solve_spd``, ``_solve_bucket``,
  ``_solve_heavy``) at rel 1e-4 in f32 and 2e-2 with a bf16 table;
- ``_mixed_run`` from one injected numpy state: the JAX XLA route against
  the port's plain route, and the JAX Pallas kernels (interpret mode)
  against the port's kernel routing (their plain versions on the CPU).
  Factors of an all-f32 schedule agree to rel 1e-3; with bf16 sweeps the
  fit RMSE agrees within 2% (the two round at other places);
- ports of the reference's training tests (tests/test_als.py:56-126);
- ``Engine.train`` with an in-memory data source, then ``PredictionServer``
  over HTTP, against the JAX engine trained on the same data from the same
  initial state.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_predictionio_tpu.core import base as jbase
from incubator_predictionio_tpu.core import engine as jengine_core
from incubator_predictionio_tpu.core import params as jparams
from incubator_predictionio_tpu.data.storage.base import (
    Interactions as JInteractions,
)
from incubator_predictionio_tpu.models.recommendation import engine as jeng
from incubator_predictionio_tpu.ops import als as jals
from incubator_predictionio_tpu.ops import sparse as jsparse
from incubator_predictionio_tpu.parallel.context import (
    RuntimeContext as JContext,
)
from incubator_predictionio_tpu.utils import json_codec as jcodec
from incubator_predictionio_tpu_torch.core import base as tbase
from incubator_predictionio_tpu_torch.core.engine import Engine
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.data.interactions import Interactions
from incubator_predictionio_tpu_torch.models.recommendation import (
    convert,
)
from incubator_predictionio_tpu_torch.models.recommendation import (
    engine as teng,
)
from incubator_predictionio_tpu_torch.ops import als
from incubator_predictionio_tpu_torch.ops import sparse as tsparse
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.servers.prediction_server import (
    PredictionServer,
)
from incubator_predictionio_tpu_torch.utils import json_codec as tcodec

CPU = "cpu"


def synthetic_ratings(n_users=60, n_items=40, rank=4, density=0.3, seed=0):
    """tests/test_als.py's planted low-rank ratings."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_users, rank)) / np.sqrt(rank)
    v = rng.normal(size=(n_items, rank)) / np.sqrt(rank)
    full = u @ v.T + 3.0
    mask = rng.random((n_users, n_items)) < density
    users, items = np.nonzero(mask)
    return users, items, full[users, items].astype(np.float32)


def heavy_ratings():
    """Planted ratings with one heavy user and one heavy item (split at
    max_width 16), a cold user and a cold item."""
    rng = np.random.default_rng(4)
    n_u, n_i = 50, 30
    u = rng.normal(size=(n_u, 4)) / 2
    v = rng.normal(size=(n_i, 4)) / 2
    mask = rng.random((n_u, n_i)) < 0.35
    mask[0, :] = True
    mask[:, 0] = True
    mask[n_u - 1, :] = False
    mask[:, n_i - 1] = False
    users, items = np.nonzero(mask)
    ratings = (u @ v.T + 3.0)[users, items] + rng.normal(0, 0.1, len(users))
    return users, items, ratings.astype(np.float32), n_u, n_i


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- ops/sparse ------------------------------------------------------------------

def _assert_buckets_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for f in ("row_ids", "cols", "vals", "mask"):
            np.testing.assert_array_equal(getattr(g, f), getattr(r, f))
            assert getattr(g, f).dtype == getattr(r, f).dtype


def _assert_heavy_equal(got, ref):
    assert (got is None) == (ref is None)
    if got is not None:
        for f in ("seg_ids", "row_ids", "cols", "vals", "mask"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize("max_width", [4, 16, 4096])
def test_build_padded_rows_matches_jax(max_width):
    rng = np.random.default_rng(max_width)
    rows = np.concatenate([rng.integers(0, 40, 500), np.zeros(70, int)])
    cols = rng.integers(0, 90, len(rows))
    vals = rng.normal(size=len(rows)).astype(np.float32)
    got = tsparse.build_padded_rows(rows, cols, vals, 40, max_width=max_width)
    ref = jsparse.build_padded_rows(rows, cols, vals, 40, max_width=max_width,
                                    impl="numpy")
    _assert_buckets_equal(got, ref)


def test_build_both_sides_and_split_heavy_match_jax():
    users, items, ratings, n_u, n_i = heavy_ratings()
    got = tsparse.build_both_sides(users, items, ratings, n_u, n_i,
                                   max_width=16)
    ref = jsparse.build_both_sides(users, items, ratings, n_u, n_i,
                                   max_width=16)
    for (g_light, g_heavy), (r_light, r_heavy) in zip(got, ref):
        _assert_buckets_equal(g_light, r_light)
        _assert_heavy_equal(g_heavy, r_heavy)
        assert g_heavy is not None  # the heavy user / item was split


# -- ops/als pieces ----------------------------------------------------------------

def _bucket_problem(seed=0, m=120, k=16, b=13, d=24):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 0.3, (m, k)).astype(np.float32)
    cols = rng.integers(0, m, (b, d)).astype(np.int32)
    vals = rng.normal(3.5, 1.0, (b, d)).astype(np.float32)
    mask = (rng.random((b, d)) < 0.8).astype(np.float32)
    mask[3] = 0.0
    x0 = rng.normal(0, 0.3, (b, k)).astype(np.float32)
    return table, cols, vals, mask, x0


@pytest.mark.parametrize("matvec", ["f32", "bf16"])
@pytest.mark.parametrize("extras", ["lam", "lam_shared_x0"])
def test_cg_solve_spd_matches_jax(matvec, extras):
    rng = np.random.default_rng(1)
    b, k = 9, 12
    g = rng.normal(size=(b, 30, k)).astype(np.float32)
    a = np.einsum("bdk,bdl->bkl", g, g).astype(np.float32)
    rhs = rng.normal(size=(b, k)).astype(np.float32)
    lam = rng.uniform(0.1, 1.0, b).astype(np.float32)
    shared = x0 = None
    if extras != "lam":
        y = rng.normal(size=(20, k)).astype(np.float32)
        shared = (y.T @ y).astype(np.float32)
        x0 = rng.normal(size=(b, k)).astype(np.float32)
    jdt = jnp.bfloat16 if matvec == "bf16" else jnp.float32
    tdt = torch.bfloat16 if matvec == "bf16" else torch.float32
    ref = jals._cg_solve_spd(
        jnp.asarray(a), jnp.asarray(rhs), 10, matvec_dtype=jdt,
        lam=jnp.asarray(lam),
        shared=None if shared is None else jnp.asarray(shared),
        x0=None if x0 is None else jnp.asarray(x0))
    got = als._cg_solve_spd(
        _t(a), _t(rhs), 10, matvec_dtype=tdt, lam=_t(lam),
        shared=None if shared is None else _t(shared),
        x0=None if x0 is None else _t(x0))
    assert _rel(got, ref) < (1e-4 if matvec == "f32" else 2e-2)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_solve_bucket_matches_jax(dt, warm):
    table, cols, vals, mask, x0 = _bucket_problem()
    jdt, prec = ((jnp.float32, jax.lax.Precision.HIGHEST) if dt == "f32"
                 else (jnp.bfloat16, jax.lax.Precision.DEFAULT))
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    ref = jals._solve_bucket(
        jnp.asarray(table), jnp.asarray(cols), jnp.asarray(vals),
        jnp.asarray(mask), 0.1, reg_nnz=True, compute_dtype=jdt,
        precision=prec, cg_iters=16,
        x0=jnp.asarray(x0) if warm else None)
    got = als._solve_bucket(_t(table), _t(cols), _t(vals), _t(mask), 0.1,
                            reg_nnz=True, compute_dtype=tdt, cg_iters=16,
                            x0=_t(x0) if warm else None)
    assert _rel(got, ref) < (1e-4 if dt == "f32" else 2e-2)
    assert (got[3] == 0).all()  # the where-guard zeroes the empty row


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_solve_heavy_matches_jax(dt):
    users, items, ratings, n_u, n_i = heavy_ratings()
    (_, heavy), _ = jsparse.build_both_sides(users, items, ratings, n_u, n_i,
                                             max_width=16)
    rng = np.random.default_rng(2)
    items_f = rng.normal(0, 0.3, (n_i, 8)).astype(np.float32)
    prev = rng.normal(0, 0.3, (n_u, 8)).astype(np.float32)
    jdt, prec = ((jnp.float32, jax.lax.Precision.HIGHEST) if dt == "f32"
                 else (jnp.bfloat16, jax.lax.Precision.DEFAULT))
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    j_ids, ref = jals._solve_heavy(
        jnp.asarray(items_f).astype(jdt), jals._heavy_tree(heavy), 0.05,
        0.0, True, jdt, prec, False, None, cg_iters=8,
        prev_factors=jnp.asarray(prev))
    t_ids, got = als._solve_heavy(
        _t(items_f).to(tdt), als._heavy_tree(heavy, CPU), 0.05, 0.0, True,
        tdt, False, None, cg_iters=8, prev_factors=_t(prev))
    np.testing.assert_array_equal(np.asarray(j_ids), t_ids.numpy())
    assert _rel(got, ref) < (1e-4 if dt == "f32" else 2e-2)


def test_gather_x0_and_scatter_drop_padding_rows():
    prev = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([2, -1, 0, -1])
    x0 = als._gather_x0(prev, ids)
    np.testing.assert_array_equal(
        x0.numpy(), np.asarray(jals._gather_x0(jnp.asarray(prev.numpy()),
                                               jnp.asarray(ids.numpy()))))
    out = als._scatter_rows_impl(torch.zeros(5, 3), ids,
                                 torch.ones(4, 3))
    assert out[:4].sum(-1).tolist() == [3.0, 0.0, 3.0, 0.0]


# -- _mixed_run ----------------------------------------------------------------------

MIXED_KW = dict(l2=0.05, iterations=3)


@pytest.fixture(scope="module")
def mixed_problem():
    users, items, ratings, n_u, n_i = heavy_ratings()
    rng = np.random.default_rng(9)
    uf = (0.1 * rng.normal(size=(n_u, 8))).astype(np.float32)
    vf = (0.1 * rng.normal(size=(n_i, 8))).astype(np.float32)
    (ul, uh), (il, ih) = jsparse.build_both_sides(users, items, ratings, n_u,
                                                  n_i, max_width=16)
    jtrees = (jals._buckets_tree(ul), jals._buckets_tree(il),
              jals._heavy_tree(uh), jals._heavy_tree(ih))
    ttrees = als.prepare_trees(users, items, ratings, n_u, n_i,
                               max_width=16, device=CPU)
    return users, items, ratings, uf, vf, jtrees, ttrees


def _run_both(mixed_problem, bf16_sweeps, kernel):
    users, items, ratings, uf, vf, jt, tt = mixed_problem
    jkw = dict(use_kernel=kernel)
    tkw = dict(use_kernel=kernel)
    if kernel:
        jkw.update(use_fused=(True, False), kernel_min_d=0)
        tkw.update(use_fused=(True, False), kernel_min_d=0)
    jstate = jals._mixed_run(
        jals.ALSState(user_factors=jnp.asarray(uf),
                      item_factors=jnp.asarray(vf)),
        jt[0], jt[1], MIXED_KW["l2"], MIXED_KW["iterations"], bf16_sweeps,
        True, jnp.float32, jax.lax.Precision.HIGHEST, jt[2], jt[3], **jkw)
    tstate = als._mixed_run(
        convert.als_state_from_numpy(uf, vf, device=CPU), tt[0], tt[1],
        MIXED_KW["l2"], MIXED_KW["iterations"], bf16_sweeps, True,
        torch.float32, tt[2], tt[3], **tkw)
    return jstate, tstate


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_mixed_run_f32_factors_match_jax(mixed_problem, kernel):
    jstate, tstate = _run_both(mixed_problem, 0, kernel)
    assert _rel(tstate.user_factors, jstate.user_factors) < 1e-3
    assert _rel(tstate.item_factors, jstate.item_factors) < 1e-3


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_mixed_run_bf16_schedule_fit_matches_jax(mixed_problem, kernel):
    users, items, ratings, *_ = mixed_problem
    jstate, tstate = _run_both(mixed_problem, 2, kernel)
    r_jax = jals.rmse(jstate, users, items, ratings)
    r_port = als.rmse(tstate, users, items, ratings)
    assert abs(r_port - r_jax) <= 0.02 * r_jax, (r_port, r_jax)
    # the cold user and item stay exactly zero on both routes
    assert (tstate.user_factors[-1] == 0).all()
    assert (tstate.item_factors[-1] == 0).all()


def _spy_entries(monkeypatch):
    """Record (entry, width, rows_per_program, table rows) of every
    kernel-wrapper call of ``ops/als``; the wrappers run on (on CPU
    tensors, their plain versions)."""
    calls = []
    for name in ("als_fused_solve_cg", "als_solve_cg"):
        real = getattr(als.als_kernels, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, a[1].shape[1], kw.get("rows_per_program"),
                          a[0].shape[0]))
            return _real(*a, **kw)

        monkeypatch.setattr(als.als_kernels, name, spy)
    return calls


#: users and items of :func:`wide_trees`, and its rank
WIDE_U, WIDE_I, WIDE_K = 90, 70, 32


@pytest.fixture(scope="module")
def wide_trees():
    """Buckets of width 8 to 64 on both sides at rank 32 (the R-row form
    takes d ≤ 32 there), no split rows: (state, u_tree, i_tree)."""
    rng = np.random.default_rng(21)
    mask = rng.random((WIDE_U, WIDE_I)) < np.linspace(0.08, 0.8,
                                                      WIDE_U)[:, None]
    users, items = np.nonzero(mask)
    ratings = rng.normal(3.5, 1, len(users)).astype(np.float32)
    u_tree, i_tree, uh, ih = als.prepare_trees(users, items, ratings, WIDE_U,
                                               WIDE_I, device=CPU)
    assert uh is None and ih is None
    widths = {c.shape[1] for tree in (u_tree, i_tree) for _r, c, _v, _m in tree}
    assert {8, 16, 32, 64} <= widths, widths
    state = convert.als_state_from_numpy(
        (0.1 * rng.normal(size=(WIDE_U, WIDE_K))).astype(np.float32),
        (0.1 * rng.normal(size=(WIDE_I, WIDE_K))).astype(np.float32),
        device=CPU)
    return state, u_tree, i_tree


def test_kernel_routing_reaches_both_kernels(wide_trees, monkeypatch):
    """With the kernels on, the fused entry on the user side only: buckets
    up to ``ROWS_MAX_D`` (8-32 wide, where the R-row form takes rank 32)
    take the R-row form on either half-sweep; the 64-wide ones take the
    fused entry on the user half-sweep (the item table) and the two-stage
    kernel's one-row form on the item half-sweep (the user table)."""
    calls = _spy_entries(monkeypatch)
    state, u_tree, i_tree = wide_trees
    als._mixed_run(state, u_tree, i_tree, 0.05, 2, 1, True, torch.float32,
                   None, None, use_kernel=True, use_fused=(True, False))
    assert {(c[0], c[2]) for c in calls if c[1] <= 32} == {
        ("als_solve_cg", 8)}
    assert {(c[0], c[2], c[3]) for c in calls if c[1] == 64} == {
        ("als_fused_solve_cg", None, WIDE_I), ("als_solve_cg", 1, WIDE_U)}


def test_fused_routing_rule_is_the_l2_budget(wide_trees, monkeypatch):
    """The routing rule, measured on the H100 (PERF.md §6): with the
    kernels on and no routing given, a bucket's width and the rank alone
    pick its entry, on both half-sweeps and whatever the other side's
    table size: up to ``ROWS_MAX_D`` the two-stage kernel's R-row form
    (``KERNEL_ROWS`` 8), above it the fused entry. The L2 budget that
    stood in for the TPU's VMEM rule is gone."""
    assert not hasattr(als, "FUSED_TABLE_BYTES")
    assert not hasattr(als, "_fused_fits")
    calls = _spy_entries(monkeypatch)
    state, u_tree, i_tree = wide_trees
    als._mixed_run(state, u_tree, i_tree, 0.05, 2, 1, True, torch.float32,
                   None, None, use_kernel=True)
    assert {(c[0], c[2]) for c in calls if c[1] <= 32} == {
        ("als_solve_cg", 8)}
    assert {(c[0], c[3]) for c in calls if c[1] > 32} == {
        ("als_fused_solve_cg", WIDE_I), ("als_fused_solve_cg", WIDE_U)}


@pytest.mark.parametrize("k", [16, 128, 160])
@pytest.mark.parametrize("d", [4, 8, 16, 32, 64, 128, 512])
def test_sweep_side_routes_each_width_to_its_entry(d, k, monkeypatch):
    """The decided routing (every bucket to a kernel, ``KERNEL_ROWS`` 8,
    ``ROWS_MAX_D`` 32): ``_sweep_side`` on CPU tensors sends a bucket of
    width up to 32 to the two-stage kernel's R-row form (its plain version
    here) where that form takes it (d ≤ the padded rank ≤ 128), every
    other bucket to the fused entry: at rank 16 the 32-wide bucket, above
    rank 128 every width. With the kernels off, every width to the plain
    route. Spied on the wrappers and on ``_solve_bucket``."""
    assert not hasattr(als, "KERNEL_MIN_D")
    assert (als.KERNEL_ROWS, als.ROWS_MAX_D) == (8, 32)
    calls = _spy_entries(monkeypatch)
    real_plain = als._solve_bucket

    def plain(*a, **kw):
        calls.append(("plain", a[1].shape[1], None, a[0].shape[0]))
        return real_plain(*a, **kw)

    monkeypatch.setattr(als, "_solve_bucket", plain)
    rng = np.random.default_rng(d)
    b = 5
    tree = ((torch.arange(b), torch.from_numpy(
        rng.integers(0, 30, (b, d)).astype(np.int32)),
        torch.from_numpy(rng.normal(3.5, 1, (b, d)).astype(np.float32)),
        torch.ones((b, d))),)
    other = torch.from_numpy(rng.normal(0, 0.3, (30, k)).astype(np.float32))
    rows8 = d <= 32 and k <= 128 and d <= als.als_kernels.padded_rank(k)
    expect = "als_solve_cg" if rows8 else "als_fused_solve_cg"
    outs = []
    for use_kernel in (True, False):
        calls.clear()
        outs.append(als._sweep_side(b, other, tree, None, 0.05, True,
                                    torch.float32, use_kernel=use_kernel,
                                    use_fused=True))
        want = expect if use_kernel else "plain"
        assert [c[0] for c in calls] == [want], (use_kernel, calls)
        if want == "als_solve_cg":
            assert calls[0][2] == 8
    # every route solves the same system: within 1e-3 of the plain route,
    # or, with fewer observations than the rank (the Gram singular but for
    # the ridge, the unconverged CG amplifying the order of sums), no more
    # than 3x as far from the f64 solve as the plain route
    if _rel(outs[0], outs[1]) > 1e-3:
        assert d < k
        x64 = als._solve_bucket(other.double(), tree[0][1],
                                tree[0][2].double(), tree[0][3].double(),
                                0.05, reg_nnz=True,
                                compute_dtype=torch.float64)
        assert _rel(outs[0], x64) <= 3 * _rel(outs[1], x64)


def test_kernel_route_above_the_kernels_rank():
    """Above rank 128 the CUDA route refuses only for want of a device: no
    rank check stands before the kernels, which take any rank up to
    ``MAX_RANK`` (here, with no card, the first copy to the device fails);
    on the CPU it trains through the plain versions at rank 160."""
    users, items, ratings = synthetic_ratings()
    rank = 160
    with pytest.raises((RuntimeError, AssertionError), match="CUDA") as err:
        als.als_train(users, items, ratings, 60, 40, rank=rank,
                      iterations=1, device="cuda")
    assert "rank" not in str(err.value)
    assert not hasattr(als, "_check_kernel_rank")
    assert als.als_kernels.MAX_RANK >= 1024
    state, _ = als.als_train(users, items, ratings, 60, 40, rank=rank,
                             iterations=1, device=CPU)
    assert torch.isfinite(state.user_factors).all()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_solve_bucket_matches_jax_at_rank_160(dt, warm):
    """The plain bucket solve above rank 128, where the kernels tile the
    Gram, against the JAX package's at the same rank."""
    table, cols, vals, mask, x0 = _bucket_problem(seed=5, m=600, k=160,
                                                  d=300)
    jdt, prec = ((jnp.float32, jax.lax.Precision.HIGHEST) if dt == "f32"
                 else (jnp.bfloat16, jax.lax.Precision.DEFAULT))
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    ref = jals._solve_bucket(
        jnp.asarray(table), jnp.asarray(cols), jnp.asarray(vals),
        jnp.asarray(mask), 0.1, reg_nnz=True, compute_dtype=jdt,
        precision=prec, cg_iters=16,
        x0=jnp.asarray(x0) if warm else None)
    got = als._solve_bucket(_t(table), _t(cols), _t(vals), _t(mask), 0.1,
                            reg_nnz=True, compute_dtype=tdt, cg_iters=16,
                            x0=_t(x0) if warm else None)
    assert tuple(got.shape) == (13, 160)
    assert _rel(got, ref) < (1e-4 if dt == "f32" else 2e-2)
    assert (got[3] == 0).all()


@pytest.fixture(scope="module")
def rank160_problem():
    """Planted ratings dense enough that every row has more observations
    (170-200) than the rank, 160, and an injected initial state."""
    rng = np.random.default_rng(14)
    n_u, n_i, k = 200, 180, 160
    u = rng.normal(size=(n_u, 6)) / 2
    v = rng.normal(size=(n_i, 6)) / 2
    users, items = np.nonzero(rng.random((n_u, n_i)) < 0.97)
    ratings = ((u @ v.T + 3.0)[users, items]
               + rng.normal(0, 0.1, len(users))).astype(np.float32)
    uf = (0.1 * rng.normal(size=(n_u, k))).astype(np.float32)
    vf = (0.1 * rng.normal(size=(n_i, k))).astype(np.float32)
    return users, items, ratings, n_u, n_i, uf, vf


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_mixed_run_f32_factors_match_jax_at_rank_160(rank160_problem,
                                                     kernel):
    """``_mixed_run`` at rank 160 from one injected state, two f32 sweeps:
    the plain route against the JAX XLA route, and the kernel routing
    (fused user side, two-stage item side, every bucket; on the CPU the
    plain versions) against the JAX kernel routing. With D barely above K
    each row's Gram is ill-conditioned and 16 CG steps leave it
    unconverged, which amplifies the packages' different orders of f32
    sums to ~3e-3 of the factors (measured on this problem: 1.0e-3 to
    2.8e-3): the factors are held to 5e-3 and the fit RMSE to 0.5%."""
    users, items, ratings, n_u, n_i, uf, vf = rank160_problem
    (ul, uh), (il, ih) = jsparse.build_both_sides(users, items, ratings, n_u,
                                                  n_i)
    jt = (jals._buckets_tree(ul), jals._buckets_tree(il),
          jals._heavy_tree(uh), jals._heavy_tree(ih))
    tt = als.prepare_trees(users, items, ratings, n_u, n_i, device=CPU)
    kw = dict(use_kernel=kernel)
    if kernel:
        kw.update(use_fused=(True, False), kernel_min_d=0)
    jstate = jals._mixed_run(
        jals.ALSState(user_factors=jnp.asarray(uf),
                      item_factors=jnp.asarray(vf)),
        jt[0], jt[1], 0.05, 2, 0, True, jnp.float32,
        jax.lax.Precision.HIGHEST, jt[2], jt[3], **kw)
    tstate = als._mixed_run(
        convert.als_state_from_numpy(uf, vf, device=CPU), tt[0], tt[1],
        0.05, 2, 0, True, torch.float32, tt[2], tt[3], **kw)
    assert tuple(tstate.user_factors.shape) == (n_u, 160)
    assert _rel(tstate.user_factors, jstate.user_factors) < 5e-3
    assert _rel(tstate.item_factors, jstate.item_factors) < 5e-3
    r_jax = jals.rmse(jstate, users, items, ratings)
    r_port = als.rmse(tstate, users, items, ratings)
    assert abs(r_port - r_jax) <= 5e-3 * r_jax, (r_port, r_jax)


def test_train_flops_matches_jax():
    kw = dict(nnz=20_000_000, n_users=138_493, n_items=26_744, rank=128,
              iterations=4, bf16_sweeps=2)
    assert als.train_flops(**kw) == pytest.approx(
        jals.train_flops(solver="cg", **kw))


# -- ports of tests/test_als.py:56-126 ----------------------------------------------

def test_als_fits_synthetic_low_rank():
    users, items, ratings = synthetic_ratings()
    state, history = als.als_train(
        users, items, ratings, n_users=60, n_items=40, rank=8, iterations=8,
        l2=0.01, track_rmse=True, device=CPU)
    assert history[-1] < 0.15
    assert history[-1] <= history[0]
    assert als.rmse(state, users, items, ratings) == pytest.approx(
        history[-1])


def test_als_mixed_bf16_schedule_recovers_planted_rank():
    users, items, ratings = synthetic_ratings(
        n_users=80, n_items=50, rank=4, density=0.4, seed=3)
    kw = dict(rank=8, iterations=8, l2=0.01, seed=5, device=CPU)
    f32, _ = als.als_train(users, items, ratings, 80, 50, **kw)
    mixed, _ = als.als_train(users, items, ratings, 80, 50, bf16_sweeps=6,
                             **kw)
    r_f32 = als.rmse(f32, users, items, ratings)
    r_mixed = als.rmse(mixed, users, items, ratings)
    assert r_f32 < 0.15
    assert r_mixed < r_f32 + 0.02
    nopolish, _ = als.als_train(users, items, ratings, 80, 50,
                                bf16_sweeps=8, **kw)
    assert torch.isfinite(nopolish.user_factors).all()


def test_als_f32_path_and_reg_modes():
    users, items, ratings = synthetic_ratings(seed=1)
    state, _ = als.als_train(users, items, ratings, 60, 40, rank=8,
                             iterations=4, compute_dtype=torch.float32,
                             reg_nnz=False, device=CPU)
    assert als.rmse(state, users, items, ratings) < 0.5


def test_als_cold_rows_stay_zero():
    users = np.array([0, 1, 2])
    items = np.array([0, 1, 2])
    ratings = np.array([4.0, 3.0, 5.0], np.float32)
    state, _ = als.als_train(users, items, ratings, 60, 40, rank=4,
                             iterations=2, device=CPU)
    assert (state.user_factors[59] == 0).all()
    assert (state.item_factors[39] == 0).all()


def test_als_heavy_row_trains():
    users = np.zeros(10, dtype=np.int64)
    items = np.arange(10)
    ratings = np.ones(10, np.float32)
    state, _ = als.als_train(users, items, ratings, 1, 10, rank=2,
                             iterations=1, max_width=4, device=CPU)
    assert torch.isfinite(state.user_factors).all()
    assert bool(state.user_factors.abs().sum() > 0)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    users, items, ratings = synthetic_ratings()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        als.als_train(users, items, ratings, 60, 40, rank=4, iterations=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.als_state_from_numpy(np.zeros((2, 4)), np.zeros((3, 4)))
    with pytest.raises(RuntimeError, match="CUDA"):
        RuntimeContext()


# -- the template: params, preparator, Engine.train → server --------------------------

def test_bf16_sweeps_parses_alike_in_both_packages():
    doc = {"rank": 12, "numIterations": 7, "lambda": 0.02, "seed": 4,
           "bf16Sweeps": 5}
    ref = jcodec.extract(jeng.ALSAlgorithmParams, doc)
    got = tcodec.extract(teng.ALSAlgorithmParams, doc)
    assert got.bf16_sweeps == ref.bf16_sweeps == 5
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


RATINGS = [("u1", "i1", 4.0), ("u2", "i1", 3.0), ("u1", "i2", 2.0),
           ("u3", "i3", 5.0), ("u1", "i1", 1.0), ("u2", "i3", 4.5)]


def test_preparator_matches_jax_on_both_forms():
    jtd = jeng.TrainingData(ratings=[jeng.Rating(*r) for r in RATINGS])
    ttd = teng.TrainingData(ratings=[teng.Rating(*r) for r in RATINGS])
    inter = dict(user_idx=np.array([0, 1, 0, 2, 0, 1], np.int32),
                 item_idx=np.array([0, 0, 1, 2, 0, 2], np.int32),
                 values=np.array([r[2] for r in RATINGS], np.float32),
                 user_ids=["u1", "u2", "u3"], item_ids=["i1", "i2", "i3"])
    jcol = jeng.TrainingData(interactions=JInteractions(**inter))
    tcol = teng.TrainingData(interactions=Interactions(**inter))
    for jtd_, ttd_ in ((jtd, ttd), (jcol, tcol)):
        ref = jeng.RecommendationPreparator().prepare(JContext(), jtd_)
        got = teng.RecommendationPreparator().prepare(
            RuntimeContext(device=CPU), ttd_)
        for f in ("users", "items", "ratings"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
        assert dict(got.user_bimap.items()) == dict(ref.user_bimap.items())
        assert dict(got.item_bimap.items()) == dict(ref.item_bimap.items())
        # latest wins: u1 rated i1 twice, the second time 1.0
        k = [i for i, (u, t) in enumerate(zip(got.users, got.items))
             if (u, t) == (got.user_bimap["u1"], got.item_bimap["i1"])]
        assert got.ratings[k].tolist() == [1.0]


def test_empty_training_data_fails_the_sanity_check():
    eng = Engine(_source([]), teng.RecommendationPreparator,
                 {"als": teng.ALSAlgorithm}, teng.RecommendationServing)
    with pytest.raises(ValueError, match="no ratings"):
        eng.train(RuntimeContext(device=CPU), _engine_params())


def _source(ratings):
    class MemorySource(tbase.DataSource):
        def read_training(self, ctx):
            return teng.TrainingData(
                ratings=[teng.Rating(*r) for r in ratings])

    return MemorySource


def _engine_params(**kw):
    return EngineParams(algorithm_params_list=[
        ("als", teng.ALSAlgorithmParams(rank=8, num_iterations=4,
                                        lambda_=0.01, seed=3, **kw))])


TRAIN_USERS, TRAIN_ITEMS = 40, 30


@pytest.fixture(scope="module")
def trained_pair():
    """The same ratings and initial state through JAX ``Engine.train`` and
    the port's."""
    users, items, ratings = synthetic_ratings(TRAIN_USERS, TRAIN_ITEMS,
                                              density=0.4, seed=8)
    triples = [(f"u{u}", f"i{i}", float(r))
               for u, i, r in zip(users, items, ratings)]
    rng = np.random.default_rng(12)
    uf = (0.1 * rng.normal(size=(TRAIN_USERS, 8))).astype(np.float32)
    vf = (0.1 * rng.normal(size=(TRAIN_ITEMS, 8))).astype(np.float32)

    class JMemorySource(jbase.DataSource):
        def read_training(self, ctx):
            return jeng.TrainingData(
                ratings=[jeng.Rating(*r) for r in triples])

    jparams_ = jeng.ALSAlgorithmParams(rank=8, num_iterations=4,
                                       lambda_=0.01, seed=3)
    jengine = jengine_core.Engine(JMemorySource, jeng.RecommendationPreparator,
                                  {"als": jeng.ALSAlgorithm},
                                  jeng.RecommendationServing)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jals, "als_init", lambda *a, **k: jals.ALSState(
            user_factors=jnp.asarray(uf), item_factors=jnp.asarray(vf)))
        mp.setattr(als, "als_init",
                   lambda gen, n_u, n_i, rank, device=None:
                   convert.als_state_from_numpy(uf, vf, device=device))
        [jmodel] = jengine.train(JContext(), jparams.EngineParams(
            algorithm_params_list=[("als", jparams_)]))
        teng_ = Engine(_source(triples), teng.RecommendationPreparator,
                       {"als": teng.ALSAlgorithm}, teng.RecommendationServing)
        ctx = RuntimeContext(device=CPU)
        [tmodel] = teng_.train(ctx, _engine_params())
    finally:
        mp.undo()
    jalgo = jeng.ALSAlgorithm(jparams_)
    jmodel = jalgo.prepare_model(JContext(), jmodel)
    return jalgo, jmodel, teng_, tmodel, ctx


def test_engine_train_matches_jax(trained_pair):
    _, jmodel, _, tmodel, ctx = trained_pair
    assert _rel(tmodel.user_factors, jmodel.user_factors) < 1e-3
    assert _rel(tmodel.item_factors, jmodel.item_factors) < 1e-3
    assert dict(tmodel.user_bimap.items()) == dict(jmodel.user_bimap.items())
    assert sorted(tmodel.user_seen) == sorted(jmodel.user_seen)
    for u, seen in jmodel.user_seen.items():
        np.testing.assert_array_equal(tmodel.user_seen[u], seen)
    assert {"read", "prepare", "train.algo0", "als.prep",
            "als.sweeps"} <= set(ctx.timings)


def _post(port, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(doc).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("doc", [
    {"user": "u3", "num": 5},
    {"user": "u7", "num": 8, "excludeSeen": True},
    {"user": "u11", "num": 4, "blacklist": ["i1", "i2"]},
    {"user": "nosuch", "num": 5},
], ids=["plain", "exclude_seen", "blacklist", "unknown"])
def test_trained_model_serves_like_jax(trained_pair, doc):
    jalgo, jmodel, teng_, tmodel, _ = trained_pair
    srv = PredictionServer(teng_, _engine_params(), [tmodel], device=CPU)
    port = srv.start_background()
    try:
        status, got = _post(port, doc)
    finally:
        srv.stop()
    assert status == 200
    ref = jcodec.to_jsonable(jalgo.predict(
        jmodel, jcodec.extract(jeng.Query, doc)))
    assert [x["item"] for x in got["itemScores"]] == \
        [x["item"] for x in ref["itemScores"]]
    np.testing.assert_allclose([x["score"] for x in got["itemScores"]],
                               [x["score"] for x in ref["itemScores"]],
                               rtol=1e-3, atol=1e-4)
