"""The port's MIPS catalogue lifecycle (ops/mips.py + ops/mips_daemon.py
on the CPU): the mirrors of tests/test_mips_lifecycle.py — PQ residual
codes, the background rebuild-and-swap, host-tiered cold buckets, the
rebuild daemon and the exhaustive-fallback merge — and the rebuild's ext
block against the JAX package's (the same published rows, the same ext
block; the re-clustered geometry close, as the build's is; the same
answers on the JAX package's rebuilt index carried across).

The daemon's lifecycle is held on events (a thread's start and join, the
loop's wake event), never on the wall clock, and on a daemon object of its
own: no index another test left registered can hold up its stop.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_predictionio_tpu.ops import mips as jmips
from incubator_predictionio_tpu.ops import topk as jtopk
from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.ops import mips, mips_daemon, topk
from incubator_predictionio_tpu_torch.utils.planted import (
    exhaustive_top_k,
    planted_item_factors,
    planted_queries,
    recall_against_oracle,
)

from test_torch_mips import (  # noqa: F401 — one_torch_thread applies here
    assert_build_close,
    assert_same_answers,
    carry,
    one_torch_thread,
)

N_ITEMS, RANK, K = 4096, 32, 10


@pytest.fixture(scope="module")
def planted():
    vf = planted_item_factors(N_ITEMS, RANK, seed=13)
    queries = planted_queries(vf, 8, seed=17)
    return vf, queries


@pytest.fixture
def mips_on(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_MIPS", "on")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dominating(rng, n):
    """Fresh publish vectors whose self-score beats every base row."""
    v = rng.normal(size=(n, RANK)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * 8.0


def _top_ids(table, q, **kw):
    packed = topk.score_and_top_k(_t(q), table, k=K, **kw)
    return packed[1].numpy().astype(np.int64).tolist()


# ---------------------------------------------------------------------------
# PQ residual codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [4, 8, 16, 32])
def test_pq_recall_parity_at_every_m(planted, mips_on, monkeypatch, m):
    monkeypatch.setenv("PIO_SERVE_MIPS_QUANT", "pq")
    monkeypatch.setenv("PIO_SERVE_MIPS_PQ_M", str(m))
    monkeypatch.setenv("PIO_SERVE_MIPS_NPROBE", str(N_ITEMS))
    vf, queries = planted
    table = _t(vf)
    index = mips.build_index(table, N_ITEMS, seed=13)
    assert index.quant == "pq"
    assert index.pq_m == m
    assert tuple(index.pq_books.shape) == (m, 256, RANK // m)

    oracle = exhaustive_top_k(vf, queries, K)
    got = np.stack([
        mips.mips_score_and_top_k(q, table, index, K)[1].numpy()
        .astype(np.int64) for q in queries])
    recall, worst = recall_against_oracle(got, oracle, K)
    assert recall >= 0.95, (m, recall, worst)


def test_pq_m_snaps_down_to_a_rank_divisor(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_MIPS_PQ_M", "24")
    assert mips._pq_m(32) == 16
    monkeypatch.setenv("PIO_SERVE_MIPS_PQ_M", "7")
    assert mips._pq_m(32) == 4
    monkeypatch.delenv("PIO_SERVE_MIPS_PQ_M")
    assert mips._pq_m(32) == 16
    assert mips._pq_m(8) == 8


# ---------------------------------------------------------------------------
# the age baseline (adopt + rebuild both reset it)
# ---------------------------------------------------------------------------

def test_adopt_and_rebuild_reset_the_age_baseline(planted, mips_on,
                                                  monkeypatch):
    t = {"now": 1000.0}
    monkeypatch.setattr(mips, "_now", lambda: t["now"])
    vf, _queries = planted
    table = _t(vf)
    index = mips.build_index(table, N_ITEMS, seed=13)
    assert index.built_at == 1000.0

    t["now"] = 1600.0
    table2 = _t(vf.copy())
    assert mips.adopt_index(table, table2) is index
    assert mips.index_for(table2) is index
    assert index.built_at == 1600.0
    mips._collect_index_age()
    age = obs_metrics.REGISTRY.get("pio_mips_index_age_seconds")
    assert age.value == pytest.approx(0.0)

    t["now"] = 2500.0
    new = mips.rebuild_index(table2, trigger="manual")
    assert new is not None and new is not index
    assert mips.index_for(table2) is new
    assert new.built_at == 2500.0


# ---------------------------------------------------------------------------
# rebuild-under-serve: the swap choreography
# ---------------------------------------------------------------------------

def test_rebuild_swap_preserves_every_published_key(planted, mips_on):
    vf, _queries = planted
    table = _t(vf.copy())
    old = mips.build_index(table, N_ITEMS, seed=13)
    rng = np.random.default_rng(23)
    fresh = _dominating(rng, 24)
    vids = mips.publish_rows(table, fresh)
    assert vids is not None and (vids >= old.capacity).all()
    row = 99
    override = _dominating(rng, 1)[0]
    mips.publish_rows(table, override[None, :], rows=[row])

    for i, vid in enumerate(vids):
        assert _top_ids(table, fresh[i])[0] == int(vid)
    assert _top_ids(table, override)[0] == row

    old_codes = old.codes
    new = mips.rebuild_index(table, trigger="tail", probe_recall=True)
    assert new is not None and new is not old
    assert mips.index_for(table) is new
    assert old._superseded is new
    assert new.tail_virtual_size() == 0
    assert new.n_ext >= len(vids)

    for i, vid in enumerate(vids):
        ids = _top_ids(table, fresh[i])
        assert ids[0] == int(vid), (i, ids)
    assert _top_ids(table, override)[0] == row
    # in-flight queries holding the OLD index object finish on the old
    # tensors (the swap never writes them)
    assert old.codes is old_codes
    got_old = mips.mips_score_and_top_k(fresh[0], table, old, K)
    assert int(got_old[1][0]) == int(vids[0])

    late = _dominating(rng, 1)
    orig_index_for = mips.index_for
    mips.index_for = lambda _t: old
    try:
        (late_vid,) = mips.publish_rows(table, late)
    finally:
        mips.index_for = orig_index_for
    assert new.tail_virtual_size() == 1
    assert _top_ids(table, late[0])[0] == int(late_vid)

    reb = obs_metrics.REGISTRY.get("pio_mips_rebuilds_total")
    assert reb.labels(trigger="tail").value >= 1


def test_back_to_back_rebuilds_reuse_compiled_shapes(planted, mips_on):
    vf, queries = planted
    table = _t(vf.copy())
    mips.build_index(table, N_ITEMS, seed=13)
    rng = np.random.default_rng(29)
    mips.publish_rows(table, _dominating(rng, 12))
    mips.rebuild_index(table, trigger="tail")
    _top_ids(table, queries[0])
    warm = mips.mips_compile_cache_size()
    for _ in range(2):
        mips.publish_rows(table, _dominating(rng, 2))
        mips.rebuild_index(table, trigger="tail")
        _top_ids(table, queries[0])
    assert mips.mips_compile_cache_size() == warm


def test_rebuild_ext_block_matches_jax(planted, mips_on):
    """A rebuild folding a published tail gives both packages the same ext
    block and a close geometry; on the JAX package's rebuilt index,
    carried across, the same answers after the swap."""
    vf, queries = planted
    ttab, jtab = _t(vf.copy()), jax.device_put(vf.copy())
    mips.build_index(ttab, N_ITEMS, seed=13)
    jmips.build_index(jtab, N_ITEMS, seed=13)
    rng = np.random.default_rng(41)
    fresh = _dominating(rng, 12)
    assert np.array_equal(mips.publish_rows(ttab, fresh),
                          jmips.publish_rows(jtab, fresh))
    ti = mips.rebuild_index(ttab, trigger="tail")
    ji = jmips.rebuild_index(jtab, trigger="tail")
    assert ti.n_ext == ji.n_ext == 12
    assert np.array_equal(ti.ext.numpy(), np.asarray(ji.ext))
    assert ti.tail_size() == ji.tail_size() == 0
    assert_build_close(ti, ji)
    carried = _t(vf.copy())
    carry(ji, carried)
    for q in np.concatenate([queries, fresh[:4]]):
        assert_same_answers(
            topk.score_and_top_k(_t(q), carried, k=K),
            jtopk.score_and_top_k(jnp.asarray(q), jtab, k=K))


# ---------------------------------------------------------------------------
# host-tiered cold buckets
# ---------------------------------------------------------------------------

def test_cold_tier_demote_serve_and_promote(planted, mips_on,
                                            monkeypatch):
    monkeypatch.setenv("PIO_MIPS_TIER", "on")
    vf, _queries = planted
    table = _t(vf.copy())
    index = mips.build_index(table, N_ITEMS, seed=13)
    index.probe_hits[:] = 1
    index.probe_hits[: index.c_total // 4] = 0
    index._probe_samples = 10_000

    new = mips.rebuild_index(table, trigger="manual")
    assert new is not None and new.cold is not None
    assert new.cold.rows > 0
    dev, host = new.tier_rows()
    assert host == new.cold.rows
    assert dev + host == N_ITEMS
    mips._collect_index_age()
    tier = obs_metrics.REGISTRY.get("pio_mips_tier_rows")
    assert tier.labels(tier="host").value >= new.cold.rows

    cold_ids = np.concatenate(
        [ids for ids in new.cold.member_ids if len(ids)])
    cold_id = next(int(c) for c in cold_ids[:256]
                   if int(np.argmax(vf @ vf[int(c)])) == int(c))
    ids = _top_ids(table, vf[cold_id])
    assert ids[0] == cold_id, ids
    assert int(new.cold.hits.sum()) > 0

    new.cold.hits[:] = 100
    assert mips_daemon.check_trigger(new) == "promote"
    promoted = mips.rebuild_index(table, trigger="promote")
    assert promoted is not None
    promoted_cold = (
        np.concatenate([ids for ids in promoted.cold.member_ids
                        if len(ids)])
        if promoted.cold is not None else np.empty(0, np.int64))
    assert cold_id not in promoted_cold.tolist()
    ids2 = _top_ids(table, vf[cold_id])
    assert ids2[0] == cold_id


def test_auto_tiering_waits_for_probe_samples(planted, mips_on,
                                              monkeypatch):
    monkeypatch.setenv("PIO_MIPS_TIER", "auto")
    vf, _queries = planted
    table = _t(vf.copy())
    mips.build_index(table, N_ITEMS, seed=13)
    new = mips.rebuild_index(table, trigger="manual")
    assert new is not None
    assert new.cold is None


# ---------------------------------------------------------------------------
# the rebuild daemon
# ---------------------------------------------------------------------------

def test_daemon_triggers_and_sweep(planted, mips_on, monkeypatch):
    monkeypatch.setenv("PIO_MIPS_REBUILD_TAIL", "8")
    vf, _queries = planted
    table = _t(vf.copy())
    index = mips.build_index(table, N_ITEMS, seed=13)
    assert mips_daemon.check_trigger(index) is None

    rng = np.random.default_rng(31)
    fresh = _dominating(rng, 8)
    vids = mips.publish_rows(table, fresh)
    assert mips_daemon.check_trigger(index) == "tail"

    assert mips_daemon.sweep_now() >= 1
    new = mips.index_for(table)
    assert new is not index
    assert new.tail_virtual_size() == 0
    for i, vid in enumerate(vids):
        assert _top_ids(table, fresh[i])[0] == int(vid)
    st = mips_daemon.stats()
    assert st["rebuilds"] >= 1
    assert st["tailTrigger"] == 8
    rec = st["last"][-1]
    assert rec["trigger"] == "tail"
    assert rec["traceId"]
    assert rec["ext"] >= len(vids)

    monkeypatch.setenv("PIO_MIPS_REBUILD_CHURN", "4")
    new.churn_rows = 5
    assert mips_daemon.check_trigger(new) == "churn"
    new.churn_rows = 0
    monkeypatch.setattr(mips, "_now",
                        lambda: new.built_at + 100_000.0)
    assert mips_daemon.check_trigger(new) is None
    new.churn_rows = 1
    assert mips_daemon.check_trigger(new) == "age"


def test_daemon_lifecycle_is_refcounted(monkeypatch):
    """acquire/release on a daemon of its own, held on events: the loop
    sweeps (an event marks each sweep), the second holder keeps it alive,
    the last release stops and joins the thread."""
    monkeypatch.setattr(mips, "registered_tables", lambda: [])
    monkeypatch.setenv("PIO_MIPS_REBUILD_POLL_S", "3600")
    daemon = mips_daemon._RebuildDaemon()
    swept = threading.Event()
    sweep = daemon.sweep

    def marked(honor_stop=True):
        done = sweep(honor_stop)
        swept.set()
        return done

    daemon.sweep = marked
    assert not daemon.running()
    daemon.acquire()
    daemon.acquire()
    try:
        assert daemon.running()
        daemon.notify()                 # a publish wakes the loop now
        assert swept.wait(timeout=60)
        thread = daemon._thread
        daemon.release()
        assert daemon.running()         # one holder left
        assert daemon._thread is thread
    finally:
        daemon.release()
    assert not daemon.running()
    assert not thread.is_alive()
    assert daemon.stats()["running"] is False
    assert daemon.failures == 0


# ---------------------------------------------------------------------------
# exhaustive-fallback visibility of published rows
# ---------------------------------------------------------------------------

def test_fallback_routes_see_published_rows(planted, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_MIPS", "on")
    vf, _queries = planted
    table = _t(vf.copy())
    mips.build_index(table, N_ITEMS, seed=13)
    rng = np.random.default_rng(37)
    fresh = _dominating(rng, 1)[0]
    (vid,) = mips.publish_rows(table, fresh[None, :])

    big_ex = _t(np.arange(1024, dtype=np.int32))
    assert mips.route(table, k=K, exclude=big_ex) is None
    ids = _top_ids(table, fresh, exclude=big_ex)
    assert ids[0] == int(vid)
    ex_vid = _t(np.concatenate([np.arange(1024), [int(vid)]]).astype(
        np.int32))
    assert int(vid) not in _top_ids(table, fresh, exclude=ex_vid)

    monkeypatch.setenv("PIO_SERVE_MIPS", "off")
    assert _top_ids(table, fresh)[0] == int(vid)
    uf = _t(np.stack([fresh, fresh]))
    packed = topk.score_user_and_top_k(uf, table, 1, k=K)
    assert int(packed[1][0]) == int(vid)
    batch = topk.batch_score_top_k(uf, table, np.asarray([0, 1]), k=K)
    assert int(batch[1][0][0]) == int(vid)
    assert int(batch[1][1][0]) == int(vid)

    mask = torch.ones(N_ITEMS, dtype=torch.bool)
    assert int(vid) not in _top_ids(table, fresh, allowed_mask=mask)
