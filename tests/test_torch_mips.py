"""The port's two-stage MIPS route (ops/mips.py, PyTorch on the CPU)
against the JAX package's (numpy and XLA), and the single-shard mirrors of
tests/test_mips.py.

The build: the port runs its heavy products as torch matmuls, the JAX
package as numpy ones, on the same seeded numpy draws. So int8 codes and
scales and the bf16 view are equal, PQ books and codes from the same
residuals equal, and the centroids within 1e-5, at least 99.9% of the rows
in the same bucket, every bucket within the cap. Serving is compared on
one index: the JAX package's, carried across with
``mips.index_from_arrays``; both packages' stages are f32 but sum in
different orders, so answers agree as ids except among near-ties (scores
within 1e-5 relative) and scores to rtol 1e-5. Inputs are made with numpy
from seeds (8,192 items, rank 32, k 20, 24 queries, as tests/test_mips.py).
The sharded cases wait for ROADMAP.md Queue 1 item 9; the similarproduct
case is in tests/test_torch_similarproduct.py.
"""

import copy
import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_predictionio_tpu.ops import mips as jmips
from incubator_predictionio_tpu.ops import topk as jtopk
from incubator_predictionio_tpu.utils import planted as jplanted
from incubator_predictionio_tpu_torch.ops import mips, topk
from incubator_predictionio_tpu_torch.utils.planted import (
    exhaustive_top_k,
    planted_item_factors,
    planted_queries,
    recall_against_oracle,
)

N_ITEMS, RANK, K, N_QUERIES = 8192, 32, 20, 24
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while the module runs: its tensors are
    small, and in a parallel test run (a process per core) each process's
    default pool would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def planted():
    vf = planted_item_factors(N_ITEMS, RANK, seed=3)
    queries = planted_queries(vf, N_QUERIES, seed=7)
    oracle = exhaustive_top_k(vf, queries, K)
    return vf, queries, oracle


@pytest.fixture
def mips_on(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_MIPS", "on")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(packed):
    return np.asarray(packed.numpy() if isinstance(packed, torch.Tensor)
                      else packed)[1].astype(np.int64)


def assert_same_answers(got, ref):
    """Packed [2, ..., k] answers: scores to rtol 1e-5, ids equal except
    where the reference's neighbouring scores are within 1e-5 relative."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    live = ref[0] > -1e37
    np.testing.assert_array_equal(got[0] > -1e37, live)
    if not live.any():
        return
    np.testing.assert_allclose(got[0][live], ref[0][live], rtol=RTOL,
                               atol=RTOL * np.abs(ref[0][live]).max())
    gi = got[1].reshape(-1, got.shape[-1])
    rs, ri = ref[0].reshape(-1, ref.shape[-1]), ref[1].reshape(
        -1, ref.shape[-1])
    for b, p in zip(*np.nonzero(gi != ri)):
        if rs[b, p] <= -1e37:
            continue
        near = [abs(rs[b, p] - rs[b, q]) <= RTOL * abs(rs[b, p])
                for q in (p - 1, p + 1) if 0 <= q < rs.shape[1]]
        assert any(near), (b, p, gi[b], ri[b])


#: the JAX index's arrays and scalars that make the port's
ARRAYS = ("codes", "scales", "bf16", "centroids", "cmax", "crad_cos",
          "crad_sin", "members", "assign", "counts", "pq_codes", "pq_books",
          "ext")
SCALARS = ("n_items", "c_local", "cap", "rank", "seed", "quant", "pq_m",
           "n_ext", "rebuilds", "delta_updates", "engine")


def carry(ji, table):
    """The JAX package's index ``ji`` as the port's (its arrays fetched as
    numpy through ``mips.index_from_arrays``, its tail, cold tier and
    probe counters copied), registered for the port's ``table``."""
    arrays = {n: (None if getattr(ji, n) is None
                  else np.asarray(getattr(ji, n))) for n in ARRAYS}
    arrays["bf16"] = arrays["bf16"].astype(np.float32)
    fields = {n: getattr(ji, n) for n in SCALARS}
    if ji.cold is not None:
        fields["cold"] = mips.ColdTier(**{
            f.name: copy.deepcopy(getattr(ji.cold, f.name))
            for f in dataclasses.fields(ji.cold)})
    ti = mips.index_from_arrays(arrays, "cpu", capacity_rows=ji.capacity,
                                **fields)
    with ji._lock:
        ti._tail = {g: np.array(v, np.float32) for g, v in ji._tail.items()}
        ti._tail_seqs = dict(ji._tail_seqs)
        ti._tail_seq = ji._tail_seq
        ti._next_virtual = ji._next_virtual
    ti.probe_hits[:] = ji.probe_hits
    ti._probe_samples, ti._dispatches = ji._probe_samples, ji._dispatches
    mips.register_index(table, ti)
    return ti


def _both(vf, n_items=N_ITEMS, seed=3):
    """(port table, port index, JAX table, JAX index): the JAX package's
    build, carried across to the port."""
    ttab = _t(vf.copy())
    jtab = jax.device_put(vf.copy())
    ji = jmips.build_index(jtab, n_items, seed=seed)
    return ttab, carry(ji, ttab), jtab, ji


def assert_build_close(ti, ji):
    """The port's build against the JAX package's on the same table."""
    assert (ti.quant, ti.cap, ti.c_total, ti.n_items, ti.capacity,
            ti.pq_m, ti.rank) == (ji.quant, ji.cap, ji.c_total, ji.n_items,
                                  ji.capacity, ji.pq_m, ji.rank)
    np.testing.assert_allclose(ti.centroids_np, ji.centroids_np, rtol=0,
                               atol=1e-5)
    assert float((ti.assign == ji.assign).mean()) >= 0.999
    # every row in exactly one bucket, the same rows as the JAX build's
    # (a rebuild's folded ext ids included), every bucket within the cap
    members, jmembers = ti.members_np, np.asarray(ji.members_np)
    assert ti.counts.sum() == (members >= 0).sum()
    assert ti.counts.max() <= ti.cap
    assert np.array_equal(np.sort(members[members >= 0]),
                          np.sort(jmembers[jmembers >= 0]))
    np.testing.assert_allclose(ti.cmax_np, np.asarray(ji.cmax), rtol=1e-5)


@pytest.mark.parametrize("quant", ["int8", "bf16", "pq"])
def test_build_against_jax(planted, mips_on, monkeypatch, quant):
    """The port's build against the JAX package's on one table: int8 codes
    and scales equal, the bf16 view equal bit for bit, the geometry close
    (:func:`assert_build_close`); PQ codes at least 99.9% the same."""
    monkeypatch.setenv("PIO_SERVE_MIPS_QUANT", quant)
    vf, _q, _o = planted
    ti = mips.build_index(_t(vf.copy()), N_ITEMS, seed=3, register=False)
    ji = jmips.build_index(jax.device_put(vf.copy()), N_ITEMS, seed=3,
                           register=False)
    assert ti.quant == quant
    assert_build_close(ti, ji)
    if quant == "int8":
        assert np.array_equal(ti.codes.numpy(), np.asarray(ji.codes))
        assert np.array_equal(ti.scales.numpy(), np.asarray(ji.scales))
    elif quant == "bf16":
        # torch's cast and ml_dtypes' both round to nearest even
        assert np.array_equal(ti.bf16.view(torch.int16).numpy(),
                              np.asarray(ji.bf16).view(np.int16))
    else:
        assert ti.pq_codes_np.shape == ji.pq_codes_np.shape
        same = ti.pq_codes_np == ji.pq_codes_np
        assert float(same.mean()) >= 0.999


def test_build_steps_against_jax(planted):
    """Each build step on the same inputs: the k-means centroids within
    1e-5; the balanced assignment (many chunks) at least 99.9% the same;
    PQ books and codes from the same residuals equal."""
    vf, _q, _o = planted
    vt = _t(vf)
    cent_j = jmips._spherical_kmeans(vf, 128, 3)
    cent_t = mips._spherical_kmeans(vt, 128, 3)
    np.testing.assert_allclose(cent_t.numpy(), cent_j, rtol=0, atol=1e-5)
    a_j = jmips._balanced_assign(vf, cent_j, 80, chunk=1000)
    a_t = mips._balanced_assign(vt, _t(cent_j), 80, chunk=1000)
    assert float((a_t == a_j).mean()) >= 0.999
    assert np.array_equal(a_t, mips._balanced_assign(vt, _t(cent_j), 80))
    assert np.bincount(a_t, minlength=128).max() <= 80
    res = vf - cent_j[a_j]
    books = mips._pq_train_books(_t(res), 8, 3)
    assert np.array_equal(books, jmips._pq_train_books(res, 8, 3))
    assert np.array_equal(mips._pq_encode(_t(res), books, chunk=1000),
                          jmips._pq_encode(res, books, chunk=1000))


def test_recall_against_oracle_matches_jax(planted):
    vf, queries, oracle = planted
    got = exhaustive_top_k(vf[::2], queries, K) * 2
    assert recall_against_oracle(got, oracle, K) == \
        jplanted.recall_against_oracle(got, oracle, K)


def test_index_from_arrays_is_the_jax_index(planted, mips_on):
    """A carried index holds the JAX index's arrays as they are."""
    vf, _q, _o = planted
    ttab, ti, _jt, ji = _both(vf)
    for name in ("codes", "scales", "centroids", "cmax", "members",
                 "pq_codes", "pq_books"):
        assert np.array_equal(getattr(ti, name).numpy(),
                              np.asarray(getattr(ji, name))), name
    assert np.array_equal(ti.assign, ji.assign)
    assert (ti.capacity, ti.c_total, ti.cap) == (ji.capacity, ji.c_total,
                                                ji.cap)
    assert mips.index_for(ttab) is ti


# ---------------------------------------------------------------------------
# the same answers from both packages, on one index
# ---------------------------------------------------------------------------

def _cold_pair(vf, monkeypatch):
    """The JAX package's index after a rebuild that tiers a quarter of the
    buckets to host memory (the planted probe-hit profile), carried
    across."""
    monkeypatch.setenv("PIO_MIPS_TIER", "on")
    ttab = _t(vf.copy())
    jtab = jax.device_put(vf.copy())
    ji = jmips.build_index(jtab, N_ITEMS, seed=3)
    ji.probe_hits[:] = 1
    ji.probe_hits[: ji.c_total // 4] = 0
    ji._probe_samples = 10_000
    ji = jmips.rebuild_index(jtab, trigger="manual")
    assert ji.cold is not None and ji.cold.rows > 0
    return ttab, carry(ji, ttab), jtab, ji


@pytest.mark.parametrize("quant", ["int8", "bf16", "pq"])
@pytest.mark.parametrize("case", ["plain", "exclude", "tail", "cold"])
def test_same_answers_as_jax(planted, mips_on, monkeypatch, quant, case):
    """Both packages' three entries on one index: B 1 (every query, k 20;
    k 1 and 128 on the plain case), the batched entry at B 3 and 64 (padded
    to 4 and 64), with exclusions, a published tail or a cold tier."""
    monkeypatch.setenv("PIO_SERVE_MIPS_QUANT", quant)
    vf, queries, oracle = planted
    if case == "cold":
        ttab, ti, jtab, ji = _cold_pair(vf, monkeypatch)
    else:
        ttab, ti, jtab, ji = _both(vf)
    if case == "tail":
        rng = np.random.default_rng(11)
        fresh = (queries[:4] / np.linalg.norm(queries[:4], axis=1,
                                              keepdims=True) * 10.0)
        known = rng.normal(size=(2, RANK)).astype(np.float32) * 3.0
        vecs = np.concatenate([fresh, known]).astype(np.float32)
        rows = [-1, -1, -1, -1, 17, int(oracle[5][0])]
        assert np.array_equal(mips.publish_rows(ttab, vecs, rows),
                              jmips.publish_rows(jtab, vecs, rows))
    uf = queries
    for j, q in enumerate(queries):
        ex = None
        if case == "exclude":
            ex = oracle[j][: 3 + j % 5]
        for k in ((1, K, 128) if case == "plain" and j < 4 else (K,)):
            got = topk.score_and_top_k(
                _t(q), ttab, k=k,
                exclude=None if ex is None else topk.pad_exclude(ex, "cpu"))
            ref = jtopk.score_and_top_k(
                jnp.asarray(q), jtab, k=k,
                exclude=None if ex is None else jtopk.pad_exclude(ex))
            assert_same_answers(got, ref)
        got_u = mips.mips_score_user_and_top_k(
            _t(uf), ttab, mips.index_for(ttab), j, K,
            exclude=None if ex is None else topk.pad_exclude(ex, "cpu"))
        ref_u = jmips.mips_score_user_and_top_k(
            jax.device_put(uf), jtab, jmips.index_for(jtab), j, K,
            exclude=None if ex is None else jtopk.pad_exclude(ex))
        assert_same_answers(got_u, ref_u)
    for b in (3, 64):
        rows = np.arange(b) % N_QUERIES
        got_b = topk.batch_score_top_k(_t(uf), ttab, rows, k=K)
        ref_b = jtopk.batch_score_top_k(jax.device_put(uf), jtab, rows,
                                        k=K)
        assert_same_answers(got_b, ref_b)
    if case == "cold":
        assert ti.cold.hits.sum() == ji.cold.hits.sum() > 0


def test_topk_rule_is_descending_ties_to_lowest_position():
    rng = np.random.default_rng(2)
    x = rng.integers(-3, 4, (5, 300)).astype(np.float32)
    x[:, ::7] = mips.NEG_INF
    x[0, 3] = -0.0
    vals, pos = mips._topk_desc(_t(x), 40)
    want = np.argsort(-(x + 0.0), axis=1, kind="stable")[:, :40]
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(x, want, 1))
    # lax.top_k's rule on the same input
    jv, jp = jax.lax.top_k(jnp.asarray(x), 40)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))


@pytest.mark.parametrize("quant", ["int8", "pq"])
def test_coarse_transient_chunks_keep_the_answers(planted, mips_on,
                                                  monkeypatch, quant):
    """A batch split into pow2 row chunks under a small transient budget
    answers as one dispatch does (ids except near-ties: a batched matmul
    may sum in another order at another width)."""
    monkeypatch.setenv("PIO_SERVE_MIPS_QUANT", quant)
    vf, queries, _o = planted
    ttab = _t(vf)
    index = mips.build_index(ttab, N_ITEMS, seed=3)
    whole = topk.batch_score_top_k(_t(queries), ttab, np.arange(16), k=K)
    nprobe = mips._quotas(index, K)[0]
    assert mips._chunk_rows(index, nprobe) >= 16
    monkeypatch.setattr(mips, "COARSE_TRANSIENT_BYTES", 1)
    assert mips._chunk_rows(index, nprobe) == 1
    chunked = topk.batch_score_top_k(_t(queries), ttab, np.arange(16),
                                     k=K)
    assert_same_answers(chunked, whole)


# ---------------------------------------------------------------------------
# single-shard mirrors of tests/test_mips.py
# ---------------------------------------------------------------------------

def test_recall_gate_vs_exhaustive_oracle(planted, mips_on):
    vf, queries, oracle = planted
    table = _t(vf)
    index = mips.build_index(table, N_ITEMS, seed=3)
    assert index.n_shards == 1
    got = np.stack([_ids(topk.score_and_top_k(_t(q), table, k=K,
                                              valid_items=N_ITEMS))
                    for q in queries])
    recall, worst = recall_against_oracle(got, oracle, K)
    assert recall >= 0.95, (recall, worst)

    fresh = np.stack([
        (queries[j] / np.linalg.norm(queries[j]) * 10.0)
        for j in range(4)]).astype(np.float32)
    virtual = mips.publish_rows(table, fresh)
    assert virtual is not None and (virtual >= index.capacity).all()
    got2 = np.stack([_ids(topk.score_and_top_k(_t(q), table, k=K,
                                               valid_items=N_ITEMS))
                     for q in queries])
    for j in range(4):
        assert int(got2[j][0]) == int(virtual[j])
    recall2, _ = recall_against_oracle(got2, oracle, K)
    assert recall2 >= 0.90, recall2


def test_auto_routing_and_fallbacks(planted, monkeypatch):
    vf, queries, oracle = planted
    table = _t(vf)
    monkeypatch.setenv("PIO_SERVE_MIPS_MIN_ITEMS", "65536")
    mips.build_index(table, N_ITEMS, seed=3)

    monkeypatch.setenv("PIO_SERVE_MIPS", "on")
    assert mips.route(table, k=K) is not None
    assert mips.route(table, k=K,
                      allowed_mask=torch.ones(N_ITEMS, dtype=torch.bool)
                      ) is None
    assert mips.route(table, k=N_ITEMS) is None

    monkeypatch.setenv("PIO_SERVE_MIPS", "off")
    assert mips.route(table, k=K) is None
    packed = topk.score_and_top_k(_t(queries[0]), table, k=K)
    assert set(_ids(packed)) == set(oracle[0])

    monkeypatch.setenv("PIO_SERVE_MIPS", "auto")
    assert mips.route(table, k=K) is not None
    other = _t(vf[:128])
    assert mips.route(other, k=K) is None
    # a copy of the table is another table: it routes exhaustive
    assert mips.route(table.clone(), k=K) is None
    small_ex = _t(np.arange(64, dtype=np.int32))
    big_ex = _t(np.arange(1024, dtype=np.int32))
    assert mips.route(table, k=K, exclude=small_ex) is not None
    assert mips.route(table, k=K, exclude=big_ex) is None
    assert not mips.build_enabled(N_ITEMS)      # < the floor
    monkeypatch.setenv("PIO_SERVE_MIPS_MIN_ITEMS", "4096")
    assert mips.build_enabled(N_ITEMS)
    monkeypatch.delenv("PIO_SERVE_MIPS_MIN_ITEMS")
    assert mips.min_items() == mips.MIN_ITEMS_DEFAULT
    # decided on the H100: the route won at no catalogue up to 1,048,576
    assert mips.MIN_ITEMS_DEFAULT > 1_048_576
    assert not mips.build_enabled(1_048_576)


def test_int8_roundtrip_cosine_error(planted):
    vf, _q, _o = planted
    codes, scales = mips._quantize_int8(_t(vf))
    rt = codes.numpy().astype(np.float32) * scales.numpy()[:, None]
    cos = (np.einsum("ik,ik->i", rt, vf)
           / np.maximum(np.linalg.norm(rt, axis=1)
                        * np.linalg.norm(vf, axis=1), 1e-12))
    assert float(cos.min()) >= 1.0 - 1e-4, float(cos.min())
    bf = _t(vf).to(torch.bfloat16).float().numpy()
    rel = np.abs(bf - vf) / np.maximum(np.abs(vf), 1e-6)
    assert float(np.median(rel)) < 1e-2


def test_bf16_view_build_and_update(planted, mips_on, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_MIPS_QUANT", "bf16")
    vf, queries, oracle = planted
    table = _t(vf)
    index = mips.build_index(table, N_ITEMS, seed=3)
    assert index.quant == "bf16"
    assert index.capacity == N_ITEMS
    assert index.codes.shape[0] < N_ITEMS  # placeholder, not a copy
    got = np.stack([_ids(mips.mips_score_and_top_k(q, table, index, K))
                    for q in queries])
    recall, _ = recall_against_oracle(got, oracle, K)
    assert recall >= 0.95, recall
    before = index.bf16
    vf2 = vf.copy()
    vf2[10] *= 2.0
    table2 = _t(vf2)
    assert mips.update_index(table, table2, N_ITEMS,
                             np.asarray([10])) is index
    # copy on write: a query in flight keeps the tensor it started with
    assert index.bf16 is not before
    assert torch.equal(before[10].float(),
                       torch.from_numpy(vf[10]).to(torch.bfloat16).float())
    qv = (vf2[10] / np.linalg.norm(vf2[10])).astype(np.float32)
    got2 = mips.mips_score_and_top_k(qv, table2, index, 10)
    assert 10 in _ids(got2).tolist()


def test_candidate_stage_determinism(planted, mips_on):
    vf, queries, _oracle = planted
    t1 = _t(vf)
    t2 = _t(vf.copy())
    a = mips.build_index(t1, N_ITEMS, seed=3, register=False)
    b = mips.build_index(t2, N_ITEMS, seed=3, register=False)
    assert torch.equal(a.centroids, b.centroids)
    assert np.array_equal(a.assign, b.assign)
    assert torch.equal(a.members, b.members)
    assert a.cap == b.cap and a.c_total == b.c_total
    q = queries[0]
    r1 = mips.mips_score_and_top_k(q, t1, a, K)
    r2 = mips.mips_score_and_top_k(q, t1, a, K)
    assert torch.equal(r1, r2)


def test_overlay_key_exact_merge(planted, mips_on):
    vf, queries, _oracle = planted
    table = _t(vf)
    mips.build_index(table, N_ITEMS, seed=3)

    q = queries[2]
    fresh = (q / np.linalg.norm(q) * 10.0).astype(np.float32)
    (vid,) = mips.publish_rows(table, fresh[None, :])
    packed = topk.score_and_top_k(_t(q), table, k=K).numpy()
    assert int(packed[1][0]) == int(vid)
    assert np.isclose(packed[0][0], float(fresh @ q), rtol=1e-5)

    row = 123
    newvec = (queries[3] / np.linalg.norm(queries[3])
              * 9.0).astype(np.float32)
    mips.publish_rows(table, newvec[None, :], rows=[row])
    p2 = topk.score_and_top_k(_t(queries[3]), table, k=K).numpy()
    ids = p2[1].astype(np.int64).tolist()
    assert row in ids
    assert np.isclose(p2[0][ids.index(row)],
                      float(newvec @ queries[3]), rtol=1e-5)

    excl = _t(np.asarray([vid], np.int32))
    p3 = topk.score_and_top_k(_t(q), table, k=K, exclude=excl)
    assert int(vid) not in _ids(p3).tolist()


def test_update_index_is_o_delta(planted, mips_on):
    vf, queries, _oracle = planted
    table = _t(vf)
    index = mips.build_index(table, N_ITEMS, seed=3)
    codes_before = index.codes.numpy().copy()
    built_before = index.built_at

    vf2 = vf.copy()
    touched = np.asarray([5, 77, 4095, 8000])
    vf2[touched] = planted_item_factors(4, RANK, seed=99) * 3.0
    table2 = _t(vf2)
    assert mips.update_index(table, table2, N_ITEMS, touched) is index
    assert mips.index_for(table2) is index
    assert mips.index_for(table) is None
    assert index.delta_updates == 1
    assert index.built_at >= built_before

    codes_after = index.codes.numpy()
    untouched = np.setdiff1d(np.arange(N_ITEMS), touched)
    assert np.array_equal(codes_after[untouched],
                          codes_before[untouched])
    assert not np.array_equal(codes_after[touched],
                              codes_before[touched])
    for row in touched:
        qv = (vf2[row] / np.linalg.norm(vf2[row])).astype(np.float32)
        got = mips.mips_score_and_top_k(qv, table2, index, 10)
        assert int(row) in _ids(got).tolist(), row
    oracle2 = exhaustive_top_k(vf2, queries, K)
    got2 = np.stack([_ids(mips.mips_score_and_top_k(q, table2, index, K))
                     for q in queries])
    recall, _ = recall_against_oracle(got2, oracle2, K)
    assert recall >= 0.95, recall

    bigger = _t(np.concatenate([vf2, vf2[:8]]))
    assert mips.update_index(table2, bigger, N_ITEMS + 8,
                             np.asarray([])) is None


def test_update_index_matches_jax(planted, mips_on):
    """The O(delta) splice leaves both packages' host mirrors and device
    arrays equal, and their answers on the new table the same."""
    vf, queries, _oracle = planted
    ttab, ti, jtab, ji = _both(vf)
    vf2 = vf.copy()
    touched = np.asarray([5, 77, 4095, 8000, 8100])
    vf2[touched] = planted_item_factors(5, RANK, seed=99) * 3.0
    ttab2, jtab2 = _t(vf2), jax.device_put(vf2)
    assert mips.update_index(ttab, ttab2, N_ITEMS, touched) is ti
    assert jmips.update_index(jtab, jtab2, N_ITEMS, touched) is ji
    for name in ("codes", "scales", "members", "cmax"):
        assert np.array_equal(np.asarray(getattr(ji, name)),
                              getattr(ti, name).numpy()), name
    np.testing.assert_allclose(ti.crad_cos.numpy(), np.asarray(ji.crad_cos),
                               rtol=0, atol=0)
    np.testing.assert_allclose(ti.crad_sin.numpy(), np.asarray(ji.crad_sin),
                               rtol=1e-7)
    assert np.array_equal(ti.assign, ji.assign)
    for q in queries[:8]:
        assert_same_answers(
            topk.score_and_top_k(_t(q), ttab2, k=K),
            jtopk.score_and_top_k(jnp.asarray(q), jtab2, k=K))


def test_zero_steady_state_recompiles(planted, mips_on):
    vf, queries, _oracle = planted
    table = _t(vf)
    mips.build_index(table, N_ITEMS, seed=3)
    uf = _t(queries)
    topk.score_and_top_k(_t(queries[0]), table, k=K)
    topk.score_user_and_top_k(uf, table, 0, k=K)
    for rung in (2, 4, 8, 16):
        topk.batch_score_top_k(uf, table, np.arange(rung), k=K)
    warm = topk.serve_compile_cache_size()
    assert mips.mips_compile_cache_size() > 0
    for _ in range(3):
        topk.score_and_top_k(_t(queries[1]), table, k=K)
        topk.score_user_and_top_k(uf, table, 2, k=K)
        for rung in (2, 4, 8, 16):
            topk.batch_score_top_k(uf, table,
                                   np.arange(rung) % N_QUERIES, k=K)
    assert topk.serve_compile_cache_size() == warm


def test_scan_accounting_and_probe_gauge(planted, mips_on):
    from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics

    vf, queries, _oracle = planted
    table = _t(vf)
    index = mips.build_index(table, N_ITEMS, seed=3)
    fam = obs_metrics.REGISTRY.get("pio_serve_candidates_scanned_total")
    _np_l, coarse, rerank = mips.scan_budget(index, K)
    c0 = fam.labels(stage="coarse").value
    r0 = fam.labels(stage="rerank").value
    topk.score_and_top_k(_t(queries[0]), table, k=K)
    assert fam.labels(stage="coarse").value - c0 == coarse
    assert fam.labels(stage="rerank").value - r0 == rerank
    e0 = fam.labels(stage="exhaustive").value
    os.environ["PIO_SERVE_MIPS"] = "off"
    try:
        topk.score_and_top_k(_t(queries[0]), table, k=K)
    finally:
        os.environ["PIO_SERVE_MIPS"] = "on"
    assert fam.labels(stage="exhaustive").value - e0 == N_ITEMS

    recall = mips.recall_probe(table, index, host_factors=vf)
    assert recall is not None and recall >= 0.9
    gauge = obs_metrics.REGISTRY.get("pio_serve_mips_recall")
    assert gauge.value == pytest.approx(recall)
    exposition = obs_metrics.REGISTRY.expose()
    assert "pio_mips_index_age_seconds" in exposition


def _planted_pd(seed, n_users=64, n_items=512, nnz=4096):
    from incubator_predictionio_tpu_torch.data.bimap import BiMap
    from incubator_predictionio_tpu_torch.models.recommendation.engine import (
        PreparedData,
    )

    rng = np.random.default_rng(seed)
    return PreparedData(
        users=rng.integers(0, n_users, nnz).astype(np.int32),
        items=rng.integers(0, n_items, nnz).astype(np.int32),
        ratings=rng.uniform(1, 5, nnz).astype(np.float32),
        user_bimap=BiMap({f"u{i}": i for i in range(n_users)}),
        item_bimap=BiMap({f"i{i}": i for i in range(n_items)}),
        item_years={}, item_categories={},
    )


def test_engine_builds_index_and_serves_through_it(monkeypatch):
    from incubator_predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        Query,
    )
    from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )

    monkeypatch.setenv("PIO_SERVE_MIPS", "on")
    pd = _planted_pd(5)
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=8, num_iterations=2,
                                           seed=1))
    ctx = RuntimeContext(device="cpu")
    model = algo.train(ctx, pd)
    index = mips.index_for(model.item_factors)
    assert index is not None and index.n_items == 512
    assert index.engine == "recommendation"

    fam = obs_metrics.REGISTRY.get("pio_serve_candidates_scanned_total")
    before = fam.labels(stage="rerank").value
    result = algo.predict(model, Query(user="u3", num=5))
    assert len(result.item_scores) == 5
    assert fam.labels(stage="rerank").value > before  # two-stage served

    # deploy in this process: prepare_model adopts the index onto the put
    # table (here the same tensor) instead of building again
    served = algo.prepare_model(ctx, model)
    assert mips.index_for(served.item_factors) is index
    # a restored model (host arrays, as a checkpoint gives them) gets a
    # build of its own: the same table and seed, the same index arrays
    restored = type(model)(**{**model.__dict__,
                              "item_factors": model.item_factors.numpy()})
    served2 = algo.prepare_model(ctx, restored)
    rebuilt = mips.index_for(served2.item_factors)
    assert rebuilt is not None and rebuilt is not index
    assert torch.equal(rebuilt.members, index.members)
    assert torch.equal(rebuilt.codes, index.codes)

    # the retrain seam: touched rows splice, none rebuilds
    model2 = type(model)(**{**model.__dict__,
                            "item_factors": model.item_factors.clone()})
    algo._refresh_mips_index(model2, prev_model=served2,
                             retrain_stats={"touched_item_rows":
                                            np.asarray([3, 7])})
    assert mips.index_for(model2.item_factors) is rebuilt
    assert rebuilt.delta_updates == 1
    model3 = type(model)(**{**model.__dict__,
                            "item_factors": model.item_factors.clone()})
    algo._refresh_mips_index(model3, prev_model=model2, retrain_stats={})
    fresh = mips.index_for(model3.item_factors)
    assert fresh is not None and fresh is not rebuilt
    assert fresh.delta_updates == 0


def test_engine_keeps_exhaustive_below_the_floor(monkeypatch):
    from incubator_predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
    )
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )

    monkeypatch.delenv("PIO_SERVE_MIPS", raising=False)
    monkeypatch.delenv("PIO_SERVE_MIPS_MIN_ITEMS", raising=False)
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=4, num_iterations=1,
                                           seed=1))
    model = algo.train(RuntimeContext(device="cpu"), _planted_pd(6))
    assert mips.index_for(model.item_factors) is None
    monkeypatch.setenv("PIO_SERVE_MIPS_MIN_ITEMS", "512")
    model = algo.train(RuntimeContext(device="cpu"), _planted_pd(6))
    assert mips.index_for(model.item_factors) is not None


def test_prediction_server_serves_through_the_index(monkeypatch):
    """``/queries.json`` through the scheduler on the two-stage route:
    ``GET /`` has the ``mips`` block, the daemon runs while the server
    does, and every answer equals the same index's direct answer."""
    import json
    import urllib.request

    from incubator_predictionio_tpu_torch.core.params import EngineParams
    from incubator_predictionio_tpu_torch.models.recommendation import (
        engine,
    )
    from incubator_predictionio_tpu_torch.models.recommendation.convert import (
        als_model_from_numpy,
    )
    from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
    from incubator_predictionio_tpu_torch.ops import mips_daemon
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer,
    )

    monkeypatch.setenv("PIO_SERVE_MIPS_MIN_ITEMS", "4096")
    vf = planted_item_factors(N_ITEMS, RANK, seed=3)
    uf = planted_queries(vf, 32, seed=7)
    model = als_model_from_numpy(
        uf, vf, [f"u{i}" for i in range(32)],
        [f"i{i}" for i in range(N_ITEMS)], device="cpu")
    ep = EngineParams(algorithm_params_list=[
        ("als", engine.ALSAlgorithmParams(rank=RANK))])
    srv = PredictionServer(engine.RecommendationEngine().apply(), ep,
                           [model], device="cpu")
    served = srv.models[0]
    index = mips.index_for(served.item_factors)
    assert index is not None and index.n_items == N_ITEMS
    fam = obs_metrics.REGISTRY.get("pio_serve_candidates_scanned_total")
    c0 = fam.labels(stage="coarse").value
    e0 = fam.labels(stage="exhaustive").value
    port = srv.start_background()
    try:
        assert mips_daemon.running()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=30) as resp:
            status = json.loads(resp.read())
        assert status["mips"]["indexes"][0]["items"] == N_ITEMS
        assert status["mips"]["daemon"]["running"] is True
        for u in range(8):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/queries.json",
                data=json.dumps({"user": f"u{u}", "num": 10}).encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=30) as resp:
                body = json.loads(resp.read())
            want = mips.mips_score_and_top_k(uf[u], served.item_factors,
                                             index, 10).numpy()
            assert [s["item"] for s in body["itemScores"]] == \
                [f"i{int(i)}" for i in want[1]]
            np.testing.assert_allclose(
                [s["score"] for s in body["itemScores"]], want[0],
                rtol=1e-6)
    finally:
        srv.stop()
    # stop() releases the server's daemon reference: no holder, and the
    # loop's thread joined (release wakes it; no poll tick to wait out)
    assert mips_daemon._DAEMON._refs == 0
    assert not mips_daemon.running()
    assert not any(t.name == "mips-rebuild-daemon" and t.is_alive()
                   for t in threading.enumerate())
    assert fam.labels(stage="coarse").value > c0
    # the warm-up and the queries all took the two-stage route
    assert fam.labels(stage="exhaustive").value == e0
