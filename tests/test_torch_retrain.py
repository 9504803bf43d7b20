"""The port's continuation retrain and the rest of single-device ALS
(PyTorch, on the CPU) against the JAX package's, on seeded numpy inputs at
the JAX package's own sizes (tests/test_retrain_continue.py: 40 × 30 ×
800 at rank 4 and the like).

- ``continue_state``: the previous tables an exact prefix, bit for bit,
  in both packages; the new rows at the init's scale (the two packages
  draw them from different generators); the same refusals;
- the BiMap prefix gate, case by case as the JAX package's;
- the early stop's floor and ceiling under both ``PIO_RETRAIN_FUSED``
  values, ``sweeps_used`` equal to JAX's; ``als_retrain(tol=0)`` fresh
  and without a plan equal to ``als_train`` (and to
  ``als_train_implicit``) bit for bit;
- ``als_retrain`` from one full-size previous state in both packages:
  the same ``mode`` and ``sweeps_used``, factors within rel 1e-3 (the
  f32 tolerance of tests/test_torch_als.py);
- plan reuse: trees equal to a fresh build bit for bit, ``prep_plan`` and
  ``prep_delta_rows`` equal to JAX's (reuse, the idempotent empty tail,
  the compaction bound, a prefix break, a growing index space);
- implicit feedback: ``als_train_implicit`` from the JAX init, one
  implicit half-sweep and an implicit continuation against JAX, rel 1e-3;
  ``_route(implicit=True)`` never the R-row form;
- the CG ``tol`` early exit (an untriggered one equal to the fixed budget
  bit for bit, a triggered one against JAX at rel 1e-4) and the Cholesky
  solver against JAX at rel 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap
from incubator_predictionio_tpu.ops import als as jals
from incubator_predictionio_tpu.ops import retrain as jretrain
from incubator_predictionio_tpu.ops import sparse as jsparse
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.ops import als, retrain

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_plans():
    retrain.drop_plans()
    jretrain.drop_plans()
    yield
    retrain.drop_plans()
    jretrain.drop_plans()


def _coo(rng, n_u, n_i, nnz, rank=4):
    """tests/test_retrain_continue.py's planted COO (repeats allowed)."""
    u_true = rng.normal(0, 1 / np.sqrt(rank), (n_u, rank)).astype(np.float32)
    v_true = rng.normal(0, 1, (n_i, rank)).astype(np.float32)
    users = rng.integers(0, n_u, nnz).astype(np.int64)
    items = rng.integers(0, n_i, nnz).astype(np.int64)
    vals = (3.0 + np.einsum("nk,nk->n", u_true[users], v_true[items])
            ).astype(np.float32)
    return users, items, vals


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _states(uf, vf):
    """The same numpy factors as a JAX and a port ALSState."""
    return (jals.ALSState(user_factors=jnp.asarray(uf),
                          item_factors=jnp.asarray(vf)),
            als.ALSState(user_factors=torch.from_numpy(uf.copy()),
                         item_factors=torch.from_numpy(vf.copy())))


# -- factor continuation ---------------------------------------------------------

@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_continue_state_prefix_copy_is_exact(form):
    prev_u = np.arange(12, dtype=np.float32).reshape(4, 3)
    prev_i = -np.arange(6, dtype=np.float32).reshape(2, 3)
    ref = jals.continue_state(prev_u, prev_i, 7, 5, seed=0)
    arg = (lambda a: a) if form == "numpy" else torch.from_numpy
    st = als.continue_state(arg(prev_u), arg(prev_i), 7, 5, seed=0,
                            device=CPU)
    for got, want, prev in ((st.user_factors, ref.user_factors, prev_u),
                            (st.item_factors, ref.item_factors, prev_i)):
        got = got.numpy()
        assert got.shape == np.asarray(want).shape and got.dtype == np.float32
        np.testing.assert_array_equal(got[:len(prev)], prev)
        np.testing.assert_array_equal(np.asarray(want)[:len(prev)], prev)
        # the new rows: als_init's scale, never zero or a copy
        fresh = got[len(prev):]
        assert np.all(np.any(fresh != 0, axis=1))
        assert 0.02 < np.std(fresh) < 0.5
    again = als.continue_state(prev_u, prev_i, 7, 5, seed=0, device=CPU)
    assert torch.equal(again.user_factors, st.user_factors)
    # the same size: the previous tables as they are
    same = als.continue_state(prev_u, prev_i, 4, 2, device=CPU)
    np.testing.assert_array_equal(same.user_factors.numpy(), prev_u)


@pytest.mark.parametrize("shape", [
    ((5, 3), (5, 3), 4, 5),      # users shrank
    ((5, 3), (5, 3), 5, 4),      # items shrank
    ((2, 3), (2, 4), 5, 5),      # ranks differ
    ((5, 3), (5, 3), 5, 5),      # the same size: kept
])
def test_continue_state_refusals_match_jax(shape):
    (pu, pi, n_u, n_i) = shape
    a, b = np.zeros(pu, np.float32), np.zeros(pi, np.float32)
    ref = jals.continue_state(a, b, n_u, n_i, seed=0)
    got = als.continue_state(a, b, n_u, n_i, seed=0, device=CPU)
    assert (got is None) == (ref is None)


@pytest.mark.parametrize("case", ["grown", "same", "reordered", "dropped",
                                  "renamed"])
def test_bimap_index_prefix_gate_matches_jax(case):
    prev = {"a": 0, "b": 1}
    other = {"grown": {"a": 0, "b": 1, "c": 2}, "same": {"a": 0, "b": 1},
             "reordered": {"b": 0, "a": 1, "c": 2}, "dropped": {"a": 0},
             "renamed": {"a": 0, "x": 1, "b": 2}}[case]
    want = JBiMap(prev).is_index_prefix_of(JBiMap(other))
    assert BiMap(prev).is_index_prefix_of(BiMap(other)) == want
    assert want == (case in ("grown", "same"))


# -- the early stop ---------------------------------------------------------------

@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("tol, min_sweeps, bf16", [
    (0.0, None, 0), (1e9, None, 0), (1e9, 3, 0), (1e9, None, 2),
    (1e9, 3, 2), (0.0, None, 2)])
def test_early_stop_floor_and_ceiling_match_jax(monkeypatch, fused, tol,
                                                min_sweeps, bf16):
    """The ceiling (tol 0 runs the budget), the floor (an absurd tol still
    runs ``min_sweeps``, at least 1; one probe chunk unfused) and the
    per-leg floors of a bf16 schedule (the bf16 leg's ``min(floor, lo)``,
    the f32 leg's ``max(floor - sweeps, 1)``): ``sweeps_used`` as JAX's."""
    monkeypatch.setenv("PIO_RETRAIN_FUSED", fused)
    monkeypatch.setenv("PIO_RETRAIN_PROBE_EVERY", "2")
    users, items, vals = _coo(np.random.default_rng(0), 40, 30, 800)
    kw = dict(rank=4, iterations=5, l2=0.05, seed=0, tol=tol,
              min_sweeps=min_sweeps, bf16_sweeps=bf16)
    ref, got = {}, {}
    jretrain.als_retrain(users, items, vals, 40, 30, stats=ref, **kw)
    retrain.als_retrain(users, items, vals, 40, 30, stats=got, device=CPU,
                        **kw)
    assert got["sweeps_used"] == ref["sweeps_used"]
    assert got["mode"] == ref["mode"] == "fresh"
    if tol == 0.0:
        assert got["sweeps_used"] == 5


def test_fixed_budget_matches_als_train_bit_for_bit():
    """tol 0, a fresh init and no plan: ``als_train``'s schedule, the
    same factors bit for bit (explicit with bf16 sweeps, and implicit
    against ``als_train_implicit``)."""
    users, items, vals = _coo(np.random.default_rng(1), 30, 20, 500)
    ref, _ = als.als_train(users, items, vals, 30, 20, rank=4, iterations=4,
                           l2=0.05, seed=3, bf16_sweeps=2, device=CPU)
    stats = {}
    got = retrain.als_retrain(users, items, vals, 30, 20, rank=4,
                              iterations=4, l2=0.05, seed=3, bf16_sweeps=2,
                              tol=0.0, stats=stats, device=CPU)
    assert torch.equal(ref.user_factors, got.user_factors)
    assert torch.equal(ref.item_factors, got.item_factors)
    assert stats["mode"] == "fresh" and stats["prep_plan"] == "off"
    w = np.abs(vals)
    ref = als.als_train_implicit(users, items, w, 30, 20, rank=4,
                                 iterations=3, l2=0.05, seed=3, device=CPU)
    got = retrain.als_retrain(users, items, w, 30, 20, rank=4, iterations=3,
                              l2=0.05, seed=3, implicit=True, tol=0.0,
                              device=CPU)
    assert torch.equal(ref.user_factors, got.user_factors)
    assert torch.equal(ref.item_factors, got.item_factors)


@pytest.mark.parametrize("run, expected", [
    ("als_train", 0), ("als_train_implicit", 0), ("retrain_tol0", 5),
    ("retrain_stop", 1), ("retrain_chunked", 3)])
def test_delta_is_computed_only_where_it_is_read(monkeypatch, run,
                                                 expected):
    """The relative factor delta costs passes over both tables, so a sweep
    computes it only where it is read: never in a fixed budget
    (``als_train``, ``als_train_implicit``); in ``als_retrain`` after each
    sweep from the floor on (floor 1, tol 0: all 5), once where a huge tol
    stops at the floor, once a chunk unfused (chunks of 2, 2 and 1)."""
    calls = []
    real = als._rel_delta

    def counting(prev, new):
        calls.append(1)
        return real(prev, new)

    monkeypatch.setattr(als, "_rel_delta", counting)
    monkeypatch.setenv("PIO_RETRAIN_PROBE_EVERY", "2")
    users, items, vals = _coo(np.random.default_rng(5), 30, 20, 500)
    kw = dict(rank=4, iterations=5, l2=0.05, seed=3, device=CPU)
    if run == "als_train":
        als.als_train(users, items, vals, 30, 20, bf16_sweeps=2, **kw)
    elif run == "als_train_implicit":
        als.als_train_implicit(users, items, np.abs(vals), 30, 20, **kw)
    else:
        monkeypatch.setenv("PIO_RETRAIN_FUSED",
                           "0" if run == "retrain_chunked" else "1")
        stats = {}
        retrain.als_retrain(users, items, vals, 30, 20,
                            tol=1e9 if run == "retrain_stop" else 0.0,
                            min_sweeps=1, stats=stats, **kw)
        assert stats["sweeps_used"] == (1 if run == "retrain_stop" else 5)
        assert np.isfinite(stats["final_delta"])
    assert len(calls) == expected


@pytest.fixture(scope="module")
def continuation_problem():
    """50 × 35 × 2,000 ratings, and rank-8 factors trained by the port on
    the first 1,900: a full-size previous state for both packages."""
    users, items, vals = _coo(np.random.default_rng(6), 50, 35, 2000)
    base, _ = als.als_train(users[:1900], items[:1900], vals[:1900], 50, 35,
                            rank=8, iterations=8, l2=0.05, seed=0,
                            device=CPU)
    return (users, items, vals, base.user_factors.numpy(),
            base.item_factors.numpy())


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("tol", [3e-2, 2e-2, 1e-2])
def test_continuation_matches_jax(monkeypatch, continuation_problem, fused,
                                  tol):
    """Both packages continue from the same full-size state (no random row
    drawn): the same mode and sweeps (1, 2 or the whole budget of 8 here),
    factors within rel 1e-3."""
    monkeypatch.setenv("PIO_RETRAIN_FUSED", fused)
    users, items, vals, uf, vf = continuation_problem
    jprev, tprev = _states(uf, vf)
    kw = dict(rank=8, iterations=8, l2=0.05, seed=0, tol=tol)
    ref, got = {}, {}
    jst = jretrain.als_retrain(users, items, vals, 50, 35, prev_state=jprev,
                               stats=ref, **kw)
    tst = retrain.als_retrain(users, items, vals, 50, 35, prev_state=tprev,
                              stats=got, device=CPU, **kw)
    assert got["mode"] == ref["mode"] == "continue"
    assert got["sweeps_used"] == ref["sweeps_used"]
    assert got["final_delta"] == pytest.approx(ref["final_delta"], rel=1e-4)
    assert _rel(tst.user_factors, jst.user_factors) < 1e-3
    assert _rel(tst.item_factors, jst.item_factors) < 1e-3


def test_rank_change_trains_fresh(continuation_problem):
    users, items, vals, uf, vf = continuation_problem
    stats = {}
    retrain.als_retrain(users, items, vals, 50, 35, rank=4, iterations=2,
                        prev_state=_states(uf, vf)[1], stats=stats,
                        device=CPU)
    assert stats["mode"] == "fresh"


def test_continuation_after_tail_reaches_fresh_quality():
    """tests/test_retrain_continue.py:266: a continuation after a 5% tail
    fits within 1.15 × the fresh fit + 0.02."""
    rng = np.random.default_rng(6)
    n_u, n_i = 50, 35
    users, items, vals = _coo(rng, n_u, n_i, 2000, rank=4)
    cut = int(len(vals) * 0.95)
    base = retrain.als_retrain(users[:cut], items[:cut], vals[:cut], n_u,
                               n_i, rank=8, iterations=8, l2=0.05, seed=0,
                               tol=0.0, device=CPU)
    stats = {}
    cont = retrain.als_retrain(users, items, vals, n_u, n_i, rank=8,
                               iterations=8, l2=0.05, seed=0,
                               prev_state=base, tol=1e-3, plan_key="parity",
                               stats=stats, device=CPU)
    fresh, _ = als.als_train(users, items, vals, n_u, n_i, rank=8,
                             iterations=8, l2=0.05, seed=0, device=CPU)
    r_cont = als.rmse(cont, users, items, vals)
    r_fresh = als.rmse(fresh, users, items, vals)
    assert stats["mode"] == "continue"
    assert r_cont <= r_fresh * 1.15 + 0.02, (r_cont, r_fresh)


# -- plan reuse -------------------------------------------------------------------

def _flat(trees):
    """The tensors of (u_tree, i_tree, u_heavy, i_heavy), in order."""
    out = []
    for part in trees:
        if part is None:
            continue
        for b in (part if part and isinstance(part[0], tuple) else (part,)):
            out.extend(b)
    return out


def _same_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _rows(tree):
    """A side's live rows by width, in row order: {width: (row_ids, cols,
    vals, mask)}, whatever the bucket layout."""
    out = {}
    for rids, cols, vals, mask in tree:
        live = rids >= 0
        out.setdefault(cols.shape[1], []).append(
            (rids[live], cols[live], vals[live], mask[live]))
    merged = {}
    for w, parts in out.items():
        rids, cols, vals, mask = (torch.cat(x) for x in zip(*parts))
        order = torch.argsort(rids)
        merged[w] = (rids[order], cols[order], vals[order], mask[order])
    return merged


def _same_rows(a, b):
    """Both sides of two prepared trees hold the same rows bit for bit:
    each at the same width with the same entries in the same slots."""
    for x, y in zip(a[:2], b[:2]):
        rx, ry = _rows(x), _rows(y)
        widths = {w for w in set(rx) | set(ry)
                  if len(rx.get(w, ((),))[0]) or len(ry.get(w, ((),))[0])}
        for w in widths:
            for p, q in zip(rx[w], ry[w]):
                assert p.dtype == q.dtype and torch.equal(p, q), w


def _two_sweeps(trees, n_u, n_i):
    ut, it, uh, ih = trees
    init = als.als_init(torch.Generator().manual_seed(0), n_u, n_i, 4,
                        device=CPU)
    out = als._mixed_run(init, ut, it, 0.05, 2, 0, True, torch.float32, uh,
                         ih)
    return out.user_factors, out.item_factors


def _both_prepare(users, items, vals, n_u, n_i, key):
    ref, got = {}, {}
    jretrain.prepare_with_reuse(users, items, vals, n_u, n_i, plan_key=key,
                                stats=ref)
    trees = retrain.prepare_with_reuse(users, items, vals, n_u, n_i,
                                       plan_key=key, stats=got, device=CPU)
    return trees, got, ref


def _check_against_fresh(trees, users, items, vals, n_u, n_i):
    fresh = retrain.prepare_with_reuse(users, items, vals, n_u, n_i,
                                       plan_key=None, device=CPU)
    plain = als.prepare_trees(users, items, vals, n_u, n_i, device=CPU)
    _same_trees(fresh, plain)
    # the reused trees hold the fresh build's rows (their layout differs:
    # cleared slots, appended buckets) and solve as they do, bit for bit
    _same_rows(trees, fresh)
    for x, y in zip(_two_sweeps(trees, n_u, n_i),
                    _two_sweeps(fresh, n_u, n_i)):
        assert torch.equal(x, y)


def _stats_keys(s):
    return {k: s.get(k) for k in ("prep_plan", "prep_delta_rows",
                                  "prep_spliced_entries",
                                  "prep_rebuilt_rows")}


def test_plan_reuse_is_bitwise_identical_to_fresh_build():
    rng = np.random.default_rng(2)
    users, items, vals = _coo(rng, 60, 40, 1500)
    t_u, t_i, t_v = _coo(rng, 60, 40, 120)
    u2, i2 = np.concatenate([users, t_u]), np.concatenate([items, t_i])
    v2 = np.concatenate([vals, t_v])
    _trees, got, ref = _both_prepare(users, items, vals, 60, 40, "p")
    assert got["prep_plan"] == ref["prep_plan"] == "miss"
    reused, got, ref = _both_prepare(u2, i2, v2, 60, 40, "p")
    assert _stats_keys(got) == _stats_keys(ref)
    assert got["prep_plan"] == "reused" and got["prep_delta_rows"] == 120
    np.testing.assert_array_equal(got["touched_item_rows"],
                                  ref["touched_item_rows"])
    _check_against_fresh(reused, u2, i2, v2, 60, 40)
    # idempotent: the same data again folds an empty tail
    again, got, ref = _both_prepare(u2, i2, v2, 60, 40, "p")
    assert _stats_keys(got) == _stats_keys(ref)
    assert got["prep_plan"] == "reused" and got["prep_delta_rows"] == 0
    _same_trees(again, reused)


def test_plan_reuse_compaction_bound_forces_fresh_rebuild():
    rng = np.random.default_rng(9)
    users, items, vals = _coo(rng, 40, 30, 600)
    _both_prepare(users, items, vals, 40, 30, "c")
    retrain._PLAN_CACHE["c"].user.dead_rows = 10_000
    jretrain._PLAN_CACHE["c"].user.dead_rows = 10_000
    t_u, t_i, t_v = _coo(rng, 40, 30, 50)
    u2, i2 = np.concatenate([users, t_u]), np.concatenate([items, t_i])
    v2 = np.concatenate([vals, t_v])
    rebuilt, got, ref = _both_prepare(u2, i2, v2, 40, 30, "c")
    assert got["prep_plan"] == ref["prep_plan"] == "rebuilt"
    assert retrain._PLAN_CACHE["c"].user.dead_rows == 0
    _check_against_fresh(rebuilt, u2, i2, v2, 40, 30)


@pytest.mark.parametrize("breach", ["value", "order", "device"])
def test_plan_reuse_invalidates_on_prefix_break(breach):
    """A changed interior triple (the latest-wins dedup moving a re-rated
    pair to the end) fails the digest: a fresh build, never a splice; so
    does a plan on another device."""
    users, items, vals = _coo(np.random.default_rng(4), 30, 20, 400)
    _both_prepare(users, items, vals, 30, 20, "q")
    if breach == "device":
        retrain._PLAN_CACHE["q"].device = torch.device("meta")
        got = {}
        retrain.prepare_with_reuse(users, items, vals, 30, 20, plan_key="q",
                                   stats=got, device=CPU)
        assert got["prep_plan"] == "invalidated"
        return
    u2, i2, v2 = users.copy(), items.copy(), vals.copy()
    if breach == "value":
        v2[5] += 1.0
    else:   # the pair at 5 re-rated: latest-wins keeps it at the end
        keep = np.r_[np.arange(5), np.arange(6, len(vals)), 5]
        u2, i2, v2 = u2[keep], i2[keep], v2[keep]
        v2[-1] = 5.0
    trees, got, ref = _both_prepare(u2, i2, v2, 30, 20, "q")
    assert got["prep_plan"] == ref["prep_plan"] == "invalidated"
    _same_trees(trees, retrain.prepare_with_reuse(u2, i2, v2, 30, 20,
                                                  device=CPU))


def test_plan_reuse_handles_growing_index_space():
    users, items, vals = _coo(np.random.default_rng(5), 20, 15, 300)
    t_u = np.asarray([20, 21, 3, 22], np.int64)
    t_i = np.asarray([15, 2, 16, 15], np.int64)
    t_v = np.asarray([1, 2, 3, 4], np.float32)
    u2, i2 = np.concatenate([users, t_u]), np.concatenate([items, t_i])
    v2 = np.concatenate([vals, t_v])
    _both_prepare(users, items, vals, 20, 15, "g")
    reused, got, ref = _both_prepare(u2, i2, v2, 23, 17, "g")
    assert _stats_keys(got) == _stats_keys(ref)
    assert got["prep_plan"] == "reused"
    _check_against_fresh(reused, u2, i2, v2, 23, 17)


def test_split_rows_keep_no_plan():
    """A plan holds no split rows (as in JAX): with a row past
    ``max_width`` the trees are built fresh and nothing is kept."""
    users, items, vals = _coo(np.random.default_rng(3), 20, 15, 300)
    kw = dict(max_width=8)
    ref, got = {}, {}
    jretrain.prepare_with_reuse(users, items, vals, 20, 15, plan_key="h",
                                stats=ref, **kw)
    trees = retrain.prepare_with_reuse(users, items, vals, 20, 15,
                                       plan_key="h", stats=got, device=CPU,
                                       **kw)
    assert got["prep_plan"] == ref["prep_plan"] == "miss"
    assert "h" not in retrain._PLAN_CACHE and "h" not in jretrain._PLAN_CACHE
    assert trees[2] is not None
    _same_trees(trees, als.prepare_trees(users, items, vals, 20, 15,
                                         device=CPU, **kw))


def test_retrain_loop_reuses_its_plan():
    """The in-process retrain loop: a miss, then reuse on the tail, and
    the spliced trees train as fresh ones."""
    rng = np.random.default_rng(11)
    users, items, vals = _coo(rng, 40, 30, 800)
    t_u, t_i, t_v = _coo(rng, 40, 30, 40)
    st = {}
    base = retrain.als_retrain(users, items, vals, 40, 30, rank=4,
                               iterations=3, l2=0.05, plan_key="loop",
                               stats=st, device=CPU)
    assert st["prep_plan"] == "miss" and st["prep_wall_s"] > 0
    u2, i2 = np.concatenate([users, t_u]), np.concatenate([items, t_i])
    v2 = np.concatenate([vals, t_v])
    reused, fresh = {}, {}
    a = retrain.als_retrain(u2, i2, v2, 40, 30, rank=4, iterations=3,
                            l2=0.05, prev_state=base, plan_key="loop",
                            stats=reused, device=CPU)
    b = retrain.als_retrain(u2, i2, v2, 40, 30, rank=4, iterations=3,
                            l2=0.05, prev_state=base, stats=fresh,
                            device=CPU)
    assert reused["prep_plan"] == "reused" and fresh["prep_plan"] == "off"
    assert reused["prep_delta_rows"] == 40
    assert reused["sweeps_used"] == fresh["sweeps_used"]
    assert torch.equal(a.user_factors, b.user_factors)
    assert torch.equal(a.item_factors, b.item_factors)


# -- implicit feedback -----------------------------------------------------------

@pytest.fixture(scope="module")
def implicit_problem():
    users, items, vals = _coo(np.random.default_rng(7), 30, 25, 900)
    return users, items, np.abs(vals)


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "plain"])
def test_als_train_implicit_matches_jax(monkeypatch, implicit_problem,
                                        kernel):
    """From the JAX init (the port's ``als_init`` patched to it): the
    kernel route (the fused entry's plain version with YᵀY) and the plain
    route against JAX's ``als_train_implicit``, rel 1e-3."""
    users, items, w = implicit_problem
    ref = jals.als_train_implicit(users, items, w, 30, 25, rank=4,
                                  iterations=3, l2=0.05, alpha=1.0, seed=0)
    init = jals.als_init(jax.random.key(0), 30, 25, 4)
    iu, ii = np.asarray(init.user_factors), np.asarray(init.item_factors)
    monkeypatch.setattr(als, "als_init", lambda *a, **k: als.ALSState(
        torch.from_numpy(iu.copy()), torch.from_numpy(ii.copy())))
    got = als.als_train_implicit(users, items, w, 30, 25, rank=4,
                                 iterations=3, l2=0.05, alpha=1.0, seed=0,
                                 device=CPU, use_kernel=kernel)
    assert _rel(got.user_factors, ref.user_factors) < 1e-3
    assert _rel(got.item_factors, ref.item_factors) < 1e-3


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "plain"])
def test_implicit_half_sweep_matches_jax(implicit_problem, kernel,
                                         monkeypatch):
    users, items, w = implicit_problem
    other = (0.3 * np.random.default_rng(1).normal(size=(25, 4))).astype(
        np.float32)
    (ul, _uh), _ = jsparse.build_both_sides(users, items, w, 30, 25)
    ref = jals._update_side_implicit(30, jnp.asarray(other), ul, 0.05, 1.0,
                                     jax.lax.Precision.HIGHEST)
    calls = []
    real = als.als_kernels.als_fused_solve_cg

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(als.als_kernels, "als_fused_solve_cg", spy)
    u_tree = als.prepare_trees(users, items, w, 30, 25, device=CPU)[0]
    got = als._sweep_side(30, torch.from_numpy(other), u_tree, None, 0.05,
                          True, torch.float32, use_kernel=kernel,
                          use_fused=True, implicit=True, alpha=1.0)
    assert _rel(got, ref) < 1e-3
    # every implicit bucket on the fused entry, with YᵀY and twice the CG
    assert len(calls) == (len(u_tree) if kernel else 0)
    assert all(c["implicit"] and c["yty"] is not None
               and c["iters"] == 2 * als.CG_ITERS for c in calls)


def test_implicit_continuation_matches_jax(implicit_problem):
    users, items, w = implicit_problem
    base = als.als_train_implicit(users[:800], items[:800], w[:800], 30, 25,
                                  rank=4, iterations=4, l2=0.05, device=CPU)
    jprev, tprev = _states(base.user_factors.numpy(),
                           base.item_factors.numpy())
    kw = dict(rank=4, iterations=6, l2=0.05, seed=0, implicit=True,
              tol=1e-3)
    ref, got = {}, {}
    jst = jretrain.als_retrain(users, items, w, 30, 25, prev_state=jprev,
                               stats=ref, **kw)
    tst = retrain.als_retrain(users, items, w, 30, 25, prev_state=tprev,
                              stats=got, device=CPU, **kw)
    assert got["mode"] == ref["mode"] == "continue"
    assert got["sweeps_used"] == ref["sweeps_used"]
    assert 1 <= got["sweeps_used"] <= 6
    assert _rel(tst.user_factors, jst.user_factors) < 1e-3
    assert torch.isfinite(tst.user_factors).all()


def test_implicit_loss_is_the_dense_objective(implicit_problem):
    """On distinct pairs, ``implicit_loss`` is the dense implicit
    objective over all 30 × 25 pairs."""
    users, items, w = implicit_problem
    _, first = np.unique(users * 25 + items, return_index=True)
    users, items, w = users[first], items[first], w[first]
    st = als.als_train_implicit(users, items, w, 30, 25, rank=4,
                                iterations=2, l2=0.05, device=CPU)
    uf = st.user_factors.double().numpy()
    vf = st.item_factors.double().numpy()
    c, p = np.ones((30, 25)), np.zeros((30, 25))
    c[users, items] = 1.0 + 0.5 * w
    p[users, items] = 1.0
    s = uf @ vf.T
    dense = float((c * (p - s) ** 2).sum()
                  + 0.05 * ((uf ** 2).sum() + (vf ** 2).sum()))
    got = als.implicit_loss(st, users, items, w, 0.5, 0.05)
    assert got == pytest.approx(dense, rel=1e-9)


@pytest.mark.parametrize("k", [16, 64, 128, 160])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 512])
def test_route_never_sends_implicit_to_the_rows_form(d, k):
    assert als._route(d, k, True, 0, True, implicit=True) == "fused"
    assert als._route(d, k, True, 0, False, implicit=True) == "plain"
    assert als._route(d, k, False, 0, True, implicit=True) == "plain"
    assert als._route(d, k, True, 0, True) != "plain"


# -- CG tol and the Cholesky solver ----------------------------------------------

def _spd(rng, b, k):
    a = rng.normal(size=(b, k, k)).astype(np.float32)
    return (np.einsum("bij,bkj->bik", a, a) / k).astype(np.float32), \
        rng.normal(size=(b, k)).astype(np.float32)


def test_untriggered_cg_tol_is_the_fixed_budget_bit_for_bit():
    a, b = _spd(np.random.default_rng(0), 6, 32)
    lam = torch.full((6,), 0.05)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    fixed = als._cg_solve_spd(ta, tb, 16, lam=lam)
    untriggered = als._cg_solve_spd(ta, tb, 16, lam=lam, tol=1e-30)
    assert torch.equal(fixed, untriggered)


@pytest.mark.parametrize("tol", [1e-1, 3e-2])
def test_triggered_cg_tol_matches_jax(tol):
    a, b = _spd(np.random.default_rng(1), 6, 32)
    lam = np.full(6, 0.05, np.float32)
    ref, n = jals._cg_solve_spd(jnp.asarray(a), jnp.asarray(b), 32,
                                lam=jnp.asarray(lam), tol=tol,
                                return_iters=True)
    assert 0 < int(n) < 32        # the exit fired before the budget
    got = als._cg_solve_spd(torch.from_numpy(a), torch.from_numpy(b), 32,
                            lam=torch.from_numpy(lam), tol=tol)
    assert _rel(got, ref) < 1e-4
    fixed = als._cg_solve_spd(torch.from_numpy(a), torch.from_numpy(b),
                              int(n), lam=torch.from_numpy(lam))
    assert torch.equal(got, fixed)


def test_cg_tol_knob_reaches_the_plain_route(monkeypatch):
    """``PIO_ALS_CG_TOL``, read per call, on the plain route's buckets
    and the split rows: the same factors as JAX's under the same knob."""
    users, items, vals = _coo(np.random.default_rng(12), 40, 30, 800)
    init = (0.1 * np.random.default_rng(2).normal(size=(40, 4))).astype(
        np.float32), (0.1 * np.random.default_rng(3).normal(
            size=(30, 4))).astype(np.float32)
    (ul, uh), (il, ih) = jsparse.build_both_sides(users, items, vals, 40, 30,
                                                  max_width=16)
    tt = als.prepare_trees(users, items, vals, 40, 30, max_width=16,
                           device=CPU)
    outs = {}
    for tol in ("0", "5e-2"):
        monkeypatch.setenv("PIO_ALS_CG_TOL", tol)
        js, ts = _states(*init)
        ref = jals._mixed_run(
            js, jals._buckets_tree(ul), jals._buckets_tree(il), 0.05, 2, 0,
            True, jnp.float32, jax.lax.Precision.HIGHEST,
            jals._heavy_tree(uh), jals._heavy_tree(ih), use_kernel=False)
        got = als._mixed_run(ts, tt[0], tt[1], 0.05, 2, 0, True,
                             torch.float32, tt[2], tt[3], use_kernel=False)
        assert _rel(got.user_factors, ref.user_factors) < 1e-3
        outs[tol] = got.user_factors
    assert not torch.equal(outs["0"], outs["5e-2"])


@pytest.mark.parametrize("implicit", [False, True])
def test_cholesky_reg_solve_matches_jax(monkeypatch, implicit):
    rng = np.random.default_rng(5)
    gram, rhs = _spd(rng, 7, 16)
    nnz = np.asarray([0, 1, 3, 5, 8, 2, 9], np.float32)
    yty = (_spd(rng, 1, 16)[0][0] if implicit else None)
    monkeypatch.setattr(jals, "_SOLVER", "cholesky")
    ref = jals._reg_solve(jnp.asarray(gram), jnp.asarray(rhs),
                          jnp.asarray(nnz), 0.05, True, implicit,
                          None if yty is None else jnp.asarray(yty))
    monkeypatch.setenv("PIO_ALS_SOLVER", "cholesky")
    got = als._reg_solve(torch.from_numpy(gram), torch.from_numpy(rhs),
                         torch.from_numpy(nnz), 0.05, True, implicit,
                         None if yty is None else torch.from_numpy(yty))
    assert _rel(got, ref) < 1e-5
    assert (got[0] == 0).all()


def test_cholesky_routes_every_bucket_to_the_plain_route(monkeypatch):
    """Under ``PIO_ALS_SOLVER=cholesky`` (read per call) a run with the
    kernels asked for calls no kernel wrapper, and from one state its
    factors are JAX's Cholesky training's (rel 1e-4); an unknown solver
    is refused."""
    calls = []
    for name in ("als_fused_solve_cg", "als_solve_cg"):
        monkeypatch.setattr(als.als_kernels, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    users, items, vals = _coo(np.random.default_rng(8), 40, 30, 800)
    rng = np.random.default_rng(4)
    js, ts = _states((0.1 * rng.normal(size=(40, 4))).astype(np.float32),
                     (0.1 * rng.normal(size=(30, 4))).astype(np.float32))
    (ul, uh), (il, ih) = jsparse.build_both_sides(users, items, vals, 40, 30,
                                                  max_width=16)
    tt = als.prepare_trees(users, items, vals, 40, 30, max_width=16,
                           device=CPU)
    monkeypatch.setenv("PIO_ALS_SOLVER", "cholesky")
    got = als._mixed_run(ts, tt[0], tt[1], 0.05, 3, 0, True, torch.float32,
                         tt[2], tt[3], use_kernel=True)
    assert calls == []
    monkeypatch.setattr(jals, "_SOLVER", "cholesky")
    ref = jals._mixed_run(
        js, jals._buckets_tree(ul), jals._buckets_tree(il), 0.05, 3, 0,
        True, jnp.float32, jax.lax.Precision.HIGHEST, jals._heavy_tree(uh),
        jals._heavy_tree(ih), use_kernel=False)
    assert _rel(got.user_factors, ref.user_factors) < 1e-4
    assert _rel(got.item_factors, ref.item_factors) < 1e-4
    monkeypatch.setenv("PIO_ALS_SOLVER", "lu")
    with pytest.raises(ValueError, match="PIO_ALS_SOLVER"):
        als.als_train(users, items, vals, 40, 30, rank=4, iterations=1,
                      device=CPU)
