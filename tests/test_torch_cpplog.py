"""The port's native event log (``data/storage/cpplog.py`` on
``native/src/eventlog.cc``) against the JAX package's, each package on a
log directory of its own under ``tmp_path``, the same seeded events in
both:

- byte compatibility: the same events with explicit ids and times give
  log files equal byte for byte, and a log written by either package reads
  back in the other with equal results;
- the sharded scan (tests/test_scan_sharded.py mirrored): byte-identical
  at every shard count, equal to the JAX package's, lock-free while
  writers append, and the pipelined scan → ``StreamingPrep`` path;
- the writer shards (tests/test_sharded_writers.py mirrored): a log
  written through N writer shards scans as the single-writer one, across
  roll, compaction and reload, with the vector cursor's contract;
- the tail read (``tail_cursor`` / ``read_interactions_since``) and the
  ``replication_*`` verbs DAO to DAO, equal to the JAX package's;
- random operation sequences (tests/test_storage_differential.py
  mirrored) observably equal on the port's memory, SQLite and cpplog
  stores and the JAX package's cpplog;
- ``pio upgrade`` on cpplog (the cpplog cases of tests/test_upgrade.py);
- no fallback: a library that cannot be built makes opening the store
  raise.
"""

import importlib
import shutil
import struct
import threading
import time
from datetime import timedelta

import numpy as np
import pytest

SHARD_COUNTS = (1, 2, 4)
SCAN_KW = dict(entity_type="user", target_entity_type="item",
               event_names=("rate",), value_prop="rating")


class Side:
    """One package's cpplog stack, reached by module path."""

    def __init__(self, name: str, pkg: str):
        self.name = name

        def mod(path):
            return importlib.import_module(f"{pkg}.{path}")

        self.pkg = pkg
        self.cpplog = mod("data.storage.cpplog")
        self.traincache = mod("data.storage.traincache")
        self.base = mod("data.storage.base")
        self.storage = mod("data.storage")
        self.Event = mod("data.event").Event
        self.DataMap = mod("data.datamap").DataMap
        self.times = mod("utils.times")
        self.native = mod("native")
        self.Interactions = self.base.Interactions

    def config(self, path):
        return self.base.StorageClientConfig(
            test=True, properties={"PATH": str(path)})

    def ev(self, name="rate", eid="u1", ms=0, target="i1", props=None,
           event_id=None, creation_ms=None):
        kw = {}
        if creation_ms is not None:
            kw["creation_time"] = self.times.from_millis(creation_ms)
        return self.Event(
            event=name, entity_type="user", entity_id=eid,
            target_entity_type="item" if target else None,
            target_entity_id=target,
            properties=self.DataMap(props or {}),
            event_time=self.times.from_millis(ms), event_id=event_id, **kw)

    def inter(self, users, items, vals, n_users=None, n_items=None):
        n_users = n_users or int(np.max(users)) + 1
        n_items = n_items or int(np.max(items)) + 1
        return self.Interactions(
            user_idx=np.asarray(users, np.int32),
            item_idx=np.asarray(items, np.int32),
            values=np.asarray(vals, np.float32),
            user_ids=[f"u{k}" for k in range(n_users)],
            item_ids=[f"i{k}" for k in range(n_items)])


JAX = Side("jax", "incubator_predictionio_tpu")
PORT = Side("port", "incubator_predictionio_tpu_torch")
SIDES = (JAX, PORT)


@pytest.fixture
def make_store(tmp_path, monkeypatch):
    """``make_store(side, sub, shards=1)`` → a fresh CppLogEvents of that
    package under ``tmp_path/sub``, app 1 initialised; every log counts as
    training scale (``MIN_NNZ`` 4 in both packages)."""
    for side in SIDES:
        monkeypatch.setattr(side.traincache, "MIN_NNZ", 4)
    clients = []

    def build(side, sub, shards=1):
        monkeypatch.setenv("PIO_LOG_SHARDS", str(shards))
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        client = side.cpplog.StorageClient(side.config(d))
        clients.append(client)
        dao = side.cpplog.CppLogEvents(client, None, prefix="t_")
        dao.init(1)
        monkeypatch.delenv("PIO_LOG_SHARDS")
        return dao

    yield build
    for c in clients:
        c.close()


def scan(dao, **kw):
    return dao.scan_interactions(app_id=1, **{**SCAN_KW, **kw})


def cold(dao, **kw):
    return scan(dao, use_cache=False, seed_cache=False, **kw)


def same(a, b):
    """Byte-identical reads: rows, values, and both id tables' bytes."""
    np.testing.assert_array_equal(a.user_idx, b.user_idx)
    np.testing.assert_array_equal(a.item_idx, b.item_idx)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.values.dtype == b.values.dtype
    for ta, tb in ((a.user_ids, b.user_ids), (a.item_ids, b.item_ids)):
        assert bytes(ta.blob) == bytes(tb.blob)
        np.testing.assert_array_equal(ta.offsets, tb.offsets)


def random_log(side, dao, seed, n=400, unordered=True):
    """tests/test_scan_sharded.py's log: a bulk import (unordered times on
    request), per-event inserts with explicit-id upserts, and deletes."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 23, n)
    items = rng.integers(0, 11, n)
    vals = rng.random(n).astype(np.float32)
    times = (rng.integers(0, 50_000, n) if unordered
             else 1000 + np.arange(n)).astype(np.int64)
    assert dao.import_interactions(side.inter(users, items, vals, 23, 11), 1,
                                   times=times) == n
    ids = []
    for k in range(30):
        ids.append(dao.insert(side.ev(
            eid=f"x{k % 5}", target=f"i{k % 4}",
            props={"rating": float(k)},
            ms=int(rng.integers(0, 50_000)), event_id=f"{k % 9:032d}"), 1))
    for eid in ids[::4]:
        dao.delete(eid, 1)


def writer_log(side, dao, seed=0, n=240):
    """tests/test_sharded_writers.py's stream: distinct times, a seeded
    columnar import, explicit-id upserts and deletes."""
    rng = np.random.default_rng(seed)
    times = 1000 + seed * 10_000_000 + 7 * rng.permutation(n).astype(
        np.int64)
    users = rng.integers(0, 23, n)
    items = rng.integers(0, 11, n)
    vals = (1.0 + rng.integers(0, 5, n)).astype(np.float32)
    assert dao.import_interactions(side.inter(users, items, vals, 23, 11), 1,
                                   times=times, id_seed=seed + 17) == n
    ids = []
    for k in range(30):
        ids.append(dao.insert(side.ev(
            eid=f"x{k % 5}", target=f"i{k % 4}",
            props={"rating": float(k)},
            ms=900_000_000 + seed * 10_000 + 3 * k,
            event_id=f"{k % 9:032d}",
            creation_ms=900_000_000 + seed * 10_000 + 3 * k), 1))
    for eid in ids[::4]:
        assert dao.delete(eid, 1)


def log_files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix == ".log"}


# -- byte compatibility ---------------------------------------------------

def fixed_events(side, n=60):
    """Events with every field fixed: ids, event and creation times."""
    rng = np.random.default_rng(11)
    out = []
    for k in range(n):
        kind = ("rate", "view", "$set")[k % 3]
        props = ({"rating": float(rng.integers(1, 11)) / 2} if kind == "rate"
                 else {"color": "red", "n": k} if kind == "$set" else {})
        out.append(side.ev(
            name=kind, eid=f"u{int(rng.integers(0, 7))}",
            target=None if kind == "$set" else f"i{int(rng.integers(0, 5))}",
            props=props, ms=1_700_000_000_000 + int(rng.integers(0, 10_000)),
            event_id=f"{k:032x}", creation_ms=1_700_000_100_000 + k))
    return out


def test_same_events_give_the_same_log_bytes(make_store, tmp_path):
    """The generic path (explicit ids, times and creation times), a seeded
    columnar import, an upsert and a delete: the two packages' log files
    are equal byte for byte."""
    for side in SIDES:
        dao = make_store(side, side.name)
        dao.insert_batch(fixed_events(side), 1)
        rng = np.random.default_rng(3)
        dao.import_interactions(
            side.inter(rng.integers(0, 9, 300), rng.integers(0, 6, 300),
                       rng.integers(1, 11, 300) / 2), 1,
            times=1_700_000_200_000 + np.arange(300, dtype=np.int64),
            id_seed=99)
        dao.insert(side.ev(eid="u3", props={"rating": 1.0},
                           ms=1_700_000_300_000, event_id=f"{4:032x}",
                           creation_ms=1_700_000_300_001), 1)
        assert dao.delete(f"{7:032x}", 1)
        dao.client.sync()
    jax_files = log_files(tmp_path / "jax")
    assert jax_files and jax_files == log_files(tmp_path / "port")


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_a_log_reads_back_in_the_other_package(make_store, tmp_path,
                                               writer, reader):
    """A log written and closed by one package, opened by the other: the
    same finds, gets, scans and aggregates as the writer's own reopen."""
    dao = make_store(writer, "w")
    dao.insert_batch(fixed_events(writer), 1)
    random_log(writer, dao, seed=4, n=120)
    dao.client.close()

    def reads(side):
        client = side.cpplog.StorageClient(side.config(tmp_path / "w"))
        try:
            d = side.cpplog.CppLogEvents(client, None, prefix="t_")
            evs = [e.to_jsonable() for e in d.find(app_id=1)]
            got = d.get(f"{5:032x}", 1)
            agg = d.aggregate_properties(app_id=1, entity_type="user")
            inter = cold(d)
            return (evs, got.to_jsonable(),
                    {k: v.to_jsonable() for k, v in agg.items()}, inter)
        finally:
            client.close()

    mine, theirs = reads(writer), reads(reader)
    assert mine[:3] == theirs[:3]
    assert len(mine[0]) > 100
    same(mine[3], theirs[3])


# -- the sharded scan (tests/test_scan_sharded.py) -------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_scan_byte_identical(make_store, monkeypatch, seed):
    """Every shard count gives the sequential scan byte for byte, and the
    port's equals the JAX package's."""
    refs = {}
    for side in SIDES:
        dao = make_store(side, side.name)
        random_log(side, dao, np.random.default_rng(seed).integers(1 << 30),
                   unordered=seed % 2 == 0)
        monkeypatch.setenv("PIO_SCAN_SHARDS", "1")
        refs[side.name] = ref = cold(dao)
        assert len(ref)
        for shards in SHARD_COUNTS[1:]:
            monkeypatch.setenv("PIO_SCAN_SHARDS", str(shards))
            stats = {}
            got = cold(dao, stats=stats)
            assert stats["scan_shards"] == shards
            assert len(stats["scan_shard_walls_s"]) == shards
            same(ref, got)
    same(refs["port"], refs["jax"])


def test_sharded_scan_time_window_identical(make_store, monkeypatch):
    refs = {}
    for side in SIDES:
        dao = make_store(side, side.name)
        random_log(side, dao, 3)
        kw = dict(start_time=side.times.from_millis(10_000),
                  until_time=side.times.from_millis(40_000))
        monkeypatch.setenv("PIO_SCAN_SHARDS", "1")
        refs[side.name] = ref = cold(dao, **kw)
        assert len(ref)
        for shards in SHARD_COUNTS[1:]:
            monkeypatch.setenv("PIO_SCAN_SHARDS", str(shards))
            same(ref, cold(dao, **kw))
    same(refs["port"], refs["jax"])


@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_warm_traincache_tail_fold_identical(make_store, monkeypatch,
                                             shards):
    """Projection written at import, a tail through the per-event path:
    the projection-served scan equals a cold full scan at every shard
    count, and the JAX package's warm scan."""
    monkeypatch.setenv("PIO_SCAN_SHARDS", str(shards))
    warm = {}
    for side in SIDES:
        dao = make_store(side, side.name)
        n = 12
        assert dao.import_interactions(
            side.inter(np.arange(n) % 5, np.arange(n) % 3,
                       np.arange(1, n + 1)), 1,
            times=1000 + np.arange(n, dtype=np.int64)) == n
        cpath = side.traincache.path_for(dao.client._file(dao.ns, 1, None))
        assert cpath.exists()
        for k in range(3):
            dao.insert(side.ev(eid=f"tail{k}", target="i0",
                               props={"rating": 9.0 + k}, ms=5000 + k), 1)
        stats = {}
        warm[side.name] = scan(dao, stats=stats)
        assert stats["scan_source"] == "cache"
        assert stats["scan_tail_rows"] == 3
        assert len(warm[side.name]) == n + 3
        cpath.unlink()
        same(warm[side.name], scan(dao))
    same(warm["port"], warm["jax"])


def test_insert_proceeds_during_inflight_scan(make_store, monkeypatch):
    """While a scan is stalled inside its native call, an insert completes
    (the scan holds no client lock), and lands past the scan's bound."""
    cpplog = PORT.cpplog
    dao = make_store(PORT, "p")
    random_log(PORT, dao, 5, n=50, unordered=False)
    n_before = len(cold(dao))
    orig = cpplog.CppLogEvents._scan_native
    started, release = threading.Event(), threading.Event()

    def slow_scan(self, *a, **kw):
        started.set()
        assert release.wait(timeout=30)
        return orig(self, *a, **kw)

    monkeypatch.setattr(cpplog.CppLogEvents, "_scan_native", slow_scan)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("inter", cold(dao)))
    t.start()
    try:
        assert started.wait(10)
        t0 = time.perf_counter()
        ids = dao.insert_batch([PORT.ev(eid="concurrent", target="i0",
                                        props={"rating": 1.0},
                                        ms=99_999)], 1)
        insert_wall = time.perf_counter() - t0
    finally:
        release.set()
    t.join(30)
    assert not t.is_alive()
    assert len(ids) == 1
    assert insert_wall < 5.0, insert_wall
    assert len(out["inter"]) == n_before


def test_delete_during_scan_skips_stale_cache_seed(make_store, monkeypatch):
    """A delete landing during the lock-free scan keeps its result out of
    the projection; the next scan reflects the delete and reseeds, and
    counts what the JAX package's counts."""
    cpplog = PORT.cpplog
    dao = make_store(PORT, "p")
    random_log(PORT, dao, 6, n=40, unordered=False)
    cpath = PORT.traincache.path_for(dao.client._file(dao.ns, 1, None))
    cpath.unlink(missing_ok=True)
    victim = next(iter(dao.find(app_id=1))).event_id
    orig = cpplog.CppLogEvents._scan_native
    started, release = threading.Event(), threading.Event()

    def slow_scan(self, *a, **kw):
        started.set()
        assert release.wait(timeout=30)
        return orig(self, *a, **kw)

    monkeypatch.setattr(cpplog.CppLogEvents, "_scan_native", slow_scan)
    t = threading.Thread(target=lambda: scan(dao, use_cache=False))
    t.start()
    try:
        assert started.wait(10)
        assert dao.delete(victim, 1)
    finally:
        release.set()
    t.join(30)
    assert not t.is_alive()
    assert not cpath.exists()
    monkeypatch.setattr(cpplog.CppLogEvents, "_scan_native", orig)
    monkeypatch.setenv("PIO_SCAN_SHARDS", "2")
    after = scan(dao)
    assert len(after) == 40 + 30 - 8 - 1 - (30 - 9)
    assert cpath.exists()
    jdao = make_store(JAX, "j")
    random_log(JAX, jdao, 6, n=40, unordered=False)
    assert jdao.delete(next(iter(jdao.find(app_id=1))).event_id, 1)
    same(after, scan(jdao))


def test_streaming_prep_matches_serial_prep(make_store, monkeypatch):
    """cpplog's ``shard_sink`` feeding ``StreamingPrep``: the port's
    histograms equal the JAX package's, and its trees the serial
    ``build_both_sides``'s bit for bit."""
    monkeypatch.setenv("PIO_SCAN_SHARDS", "3")
    preps = {}
    for side in SIDES:
        sparse = importlib.import_module(f"{side.pkg}.ops.sparse")
        dao = make_store(side, side.name)
        random_log(side, dao, 7, n=600, unordered=False)
        prep = sparse.StreamingPrep()
        stats = {}
        inter = cold(dao, stats=stats, shard_sink=prep.add_shard)
        assert prep.shards == 3
        preps[side.name] = (prep, inter, stats)
    prep, inter, stats = preps["port"]
    jprep = preps["jax"][0]
    np.testing.assert_array_equal(prep.user_degrees, jprep.user_degrees)
    np.testing.assert_array_equal(prep.item_degrees, jprep.item_degrees)
    np.testing.assert_array_equal(
        prep.user_degrees[:len(inter.user_ids)],
        np.bincount(inter.user_idx, minlength=len(inter.user_ids)))
    sparse = importlib.import_module("incubator_predictionio_tpu_torch."
                                     "ops.sparse")
    piped = prep.finish(inter, max_width=8,
                        reordered=bool(stats["scan_reordered"]))
    serial = sparse.build_both_sides(
        inter.user_idx, inter.item_idx, inter.values,
        len(inter.user_ids), len(inter.item_ids), max_width=8)
    # the native builder (the route the histograms feed) too
    native = sparse.build_both_sides(
        inter.user_idx, inter.item_idx, inter.values,
        len(inter.user_ids), len(inter.item_ids), max_width=8,
        impl="native", user_degrees=prep.user_degrees[:len(inter.user_ids)],
        item_degrees=prep.item_degrees[:len(inter.item_ids)])
    for got in (piped, native):
        assert flatten(got)
        for xs, ys in zip(flatten(got), flatten(serial), strict=True):
            for x, y in zip(xs, ys, strict=True):
                np.testing.assert_array_equal(x, y)


def flatten(sides):
    out = []
    for light, heavy in sides:
        for b in light:
            out.append((b.row_ids, b.cols, b.vals, b.mask))
        if heavy is not None:
            out.append((heavy.seg_ids, heavy.row_ids, heavy.cols,
                        heavy.vals, heavy.mask))
    return out


def test_scan_stats_report_lock_narrowing(make_store, monkeypatch):
    """The stats channel: the same keys as the JAX package's, shard walls
    and the native lock-held wall."""
    monkeypatch.setenv("PIO_SCAN_SHARDS", "2")
    keys = {}
    for side in SIDES:
        dao = make_store(side, side.name)
        random_log(side, dao, 8, n=200, unordered=False)
        stats = {}
        inter = cold(dao, stats=stats)
        assert stats["scan_shards"] == 2
        assert len(stats["scan_shard_walls_s"]) == 2
        assert stats["scan_lock_held_s"] >= 0.0
        assert stats["scan_rows"] == len(inter)
        keys[side.name] = sorted(stats)
    assert keys["port"] == keys["jax"]


def test_scan_metrics_on_the_ports_registry(make_store):
    """The scan and group-commit gauges reach the port's own
    ``obs/metrics.REGISTRY`` at scrape time, and a projection-served read
    sets ``pio_retrain_delta_rows`` to its tail."""
    from incubator_predictionio_tpu_torch.obs import metrics

    dao = make_store(PORT, "p")
    dao.import_interactions(PORT.inter(np.arange(80) % 3, np.arange(80) % 4,
                                       np.ones(80)), 1,
                            times=np.arange(80, dtype=np.int64))
    dao.insert_interactions(PORT.inter([0, 1], [1, 2], [2.0, 3.0], 3, 4), 1,
                            times=np.array([100, 101], np.int64))
    cold(dao)
    stats = {}
    scan(dao, stats=stats)
    assert (stats["scan_source"], stats["scan_tail_rows"]) == ("cache", 2)
    text = metrics.REGISTRY.expose()
    for name in ("pio_group_commit_appends", "pio_scan_rows",
                 "pio_scan_lock_held_seconds"):
        assert name in text
    assert metrics.REGISTRY.get("pio_retrain_delta_rows").value == 2
    assert metrics.REGISTRY.get("pio_scan_rows").value == 82
    assert metrics.REGISTRY.get("pio_group_commit_events").value == 2


# -- writer shards (tests/test_sharded_writers.py) ------------------------

@pytest.mark.parametrize("shards", (1, 2, 7))
def test_multiwriter_scan_byte_identical(make_store, shards):
    scans = {}
    for side in SIDES:
        ref = make_store(side, f"{side.name}_ref")
        got = make_store(side, f"{side.name}_sh", shards)
        writer_log(side, ref)
        writer_log(side, got)
        assert got.client.shards(got.ns, 1, None) == shards
        same(cold(ref), cold(got))
        scans[side.name] = cold(got)
    same(scans["port"], scans["jax"])


@pytest.mark.parametrize("shards", (2, 7))
def test_multiwriter_identical_across_roll_and_compact(make_store, shards):
    scans = {}
    for side in SIDES:
        ref = make_store(side, f"{side.name}_ref")
        got = make_store(side, f"{side.name}_sh", shards)
        writer_log(side, ref)
        writer_log(side, got)
        assert got.maybe_roll(1, limit_bytes=1) >= 1
        got.compact(1)
        writer_log(side, got, seed=1, n=60)
        writer_log(side, ref, seed=1, n=60)
        same(cold(ref), cold(got))
        scans[side.name] = cold(got)
    same(scans["port"], scans["jax"])


@pytest.mark.parametrize("shards", (2, 7))
def test_multiwriter_traincache_tail_fold_identical(make_store, shards):
    for side in SIDES:
        dao = make_store(side, side.name, shards)
        n = 12
        assert dao.import_interactions(
            side.inter(np.arange(n) % 5, np.arange(n) % 3,
                       np.arange(1, n + 1)), 1,
            times=1000 + np.arange(n, dtype=np.int64)) == n
        for k in range(5):
            dao.insert(side.ev(eid=f"tail{k}", target="i0",
                               props={"rating": 9.0 + k}, ms=5000 + k), 1)
        warm = scan(dao)
        assert len(warm) == n + 5
        same(warm, cold(dao))


def test_vector_cursor_monotonic_under_appends(make_store):
    got = {}
    for side in SIDES:
        dao = make_store(side, side.name, 3)
        cur = dao.tail_cursor(app_id=1)
        assert isinstance(cur, side.base.VectorCursor)
        assert int(cur) == 0
        seen = []
        for step in range(4):
            writer_log(side, dao, seed=step, n=30)
            inter, _t, append_ms, new_cur, reset = \
                dao.read_interactions_since(cur, app_id=1, **SCAN_KW)
            assert not reset
            assert isinstance(new_cur, side.base.VectorCursor)
            assert len(inter) > 0 and len(append_ms) == len(inter)
            assert not (new_cur < cur)
            assert int(new_cur) > int(cur)
            seen.append((tuple(new_cur), len(inter)))
            cur = new_cur
        inter, _t, _a, again, reset = dao.read_interactions_since(
            cur, app_id=1, **SCAN_KW)
        assert len(inter) == 0 and not reset and again == cur
        got[side.name] = seen
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("rewrite", ["compact", "roll"])
def test_vector_cursor_resets_on_rewrite(make_store, rewrite):
    """Compaction and a hot→cold roll renumber a shard's entries: a cursor
    from before reads as a reset, and a fresh cursor reads nothing new."""
    for side in SIDES:
        shards = 3 if rewrite == "compact" else 2
        dao = make_store(side, side.name, shards)
        writer_log(side, dao, n=60)
        cur = dao.read_interactions_since(
            side.base.VectorCursor((0,) * shards), app_id=1, **SCAN_KW)[3]
        if rewrite == "compact":
            dao.compact(1)
        else:
            assert dao.maybe_roll(1, limit_bytes=1) >= 1
        inter, _t, _a, _nc, reset = dao.read_interactions_since(
            cur, app_id=1, **SCAN_KW)
        assert reset and len(inter) == 0
        assert len(cold(dao)) > 0
        fresh = dao.tail_cursor(app_id=1)
        inter2, _t2, _a2, cur2, reset2 = dao.read_interactions_since(
            fresh, app_id=1, **SCAN_KW)
        assert not reset2 and len(inter2) == 0 and cur2 == fresh


def test_writer_reload_preserves_layout_and_data(make_store, tmp_path):
    """A reopen without ``PIO_LOG_SHARDS``: the ``.shards`` meta pins the
    layout, the scan is unchanged, a replay from zero gives every row."""
    dao = make_store(PORT, "reload", 3)
    writer_log(PORT, dao, n=90)
    before = cold(dao)
    dao.client.close()
    client2 = PORT.cpplog.StorageClient(PORT.config(tmp_path / "reload"))
    try:
        dao2 = PORT.cpplog.CppLogEvents(client2, None, prefix="t_")
        assert client2.shards("t_", 1, None) == 3
        after = cold(dao2)
        same(before, after)
        full = dao2.read_interactions_since(
            PORT.base.VectorCursor((0, 0, 0)), app_id=1, **SCAN_KW)
        assert len(full[0]) == len(after) and not full[4]
    finally:
        client2.close()
    # the JAX package reads the port's sharded layout the same way
    jclient = JAX.cpplog.StorageClient(JAX.config(tmp_path / "reload"))
    try:
        jdao = JAX.cpplog.CppLogEvents(jclient, None, prefix="t_")
        assert jclient.shards("t_", 1, None) == 3
        same(after, cold(jdao))
    finally:
        jclient.close()


def test_shard_spray_is_stable_per_entity(make_store):
    """An entity's history lands on one shard, the one the JAX package
    picks for it."""
    counts = {}
    for side in SIDES:
        dao = make_store(side, side.name, 5)
        rounds = []
        for r in range(3):
            for k in range(40):
                dao.insert(side.ev(eid=f"u{k}", target="i0",
                                   props={"rating": 1.0},
                                   ms=1000 + r * 100 + k), 1)
            rounds.append(tuple(
                int(dao.client.lib.pio_evlog_entry_count(
                    dao.client.handle_path(dao._hot_path(1, None, s))))
                for s in range(5)))
        first = np.array(rounds[0])
        for r, c in enumerate(rounds):
            np.testing.assert_array_equal(np.array(c), first * (r + 1))
        assert np.count_nonzero(first) >= 2
        counts[side.name] = rounds
    assert counts["port"] == counts["jax"]


# -- the tail read --------------------------------------------------------

def test_tail_read_matches_jax_over_insert_delete_insert(make_store):
    """``tail_cursor`` and ``read_interactions_since`` on the plain layout
    over inserts, a delete and more inserts, then a compaction: the same
    cursors, rows, ids and reset flags as the JAX package's."""
    def run(side):
        dao = make_store(side, side.name)
        steps = []

        def read(cur):
            inter, times, append_ms, new_cur, reset = \
                dao.read_interactions_since(cur, app_id=1, **SCAN_KW)
            assert len(append_ms) == len(inter)
            assert (np.asarray(append_ms) >= -1).all()
            steps.append((list(inter.user_ids), list(inter.item_ids),
                          inter.user_idx.tolist(), inter.item_idx.tolist(),
                          inter.values.tolist(), times.tolist(),
                          int(new_cur), reset))
            return new_cur

        cur = dao.tail_cursor(app_id=1)
        steps.append(int(cur))
        ids = dao.insert_batch([side.ev(eid=f"u{k % 3}", target=f"i{k}",
                                        props={"rating": float(k)},
                                        ms=100 + k, event_id=f"{k:032d}")
                                for k in range(6)], 1)
        cur = read(cur)
        assert dao.delete(ids[2], 1)
        cur = read(cur)
        dao.import_interactions(side.inter([0, 1, 0], [0, 1, 2], [5, 4, 3]),
                                1, times=np.array([300, 301, 302],
                                                  np.int64), id_seed=5)
        dao.insert(side.ev(eid="late", target="i9", props={"rating": 2.0},
                           ms=50, event_id=f"{99:032d}"), 1)
        cur = read(cur)
        cur = read(cur)  # drained
        old = cur
        dao.compact(1)
        read(old)        # a reset after the rewrite
        fresh = dao.tail_cursor(app_id=1)
        steps.append(int(fresh))
        read(fresh)
        return steps

    got, ref = run(PORT), run(JAX)
    assert got == ref
    assert got[-3][-1] is True        # the compaction surfaced as a reset
    assert list(got[1][:2]) == [["u0", "u1", "u2"],
                                [f"i{k}" for k in range(6)]]
    assert got[2][0] == []            # a delete adds no rating
    assert got[3][0] == ["late", "u0", "u1"]   # time order, first seen


# -- replication ----------------------------------------------------------

def replicate(leader, follower):
    """Ship every shard's frames from ``leader`` to ``follower`` with the
    replication verbs, in budgets small enough to take several reads."""
    status = leader.replication_status(1)
    follower.replication_configure(1, shards=status["shards"])
    for st in status["status"]:
        for tier in ("cold", "hot"):
            want = st[tier]
            at = 0
            while at < want:
                out = leader.replication_read(
                    1, shard=st["shard"], tier=tier, from_entry=at,
                    epoch=st["epoch"], max_bytes=1 << 16)
                assert out["n_entries"] > 0
                follower.replication_apply(1, shard=st["shard"], tier=tier,
                                           from_entry=at,
                                           frames=out["frames"])
                # replayed frames are a no-op
                follower.replication_apply(1, shard=st["shard"], tier=tier,
                                           from_entry=at,
                                           frames=out["frames"])
                at += out["n_entries"]
    return status


@pytest.mark.parametrize("shards", (1, 3))
def test_replication_ships_frames_dao_to_dao(make_store, tmp_path, shards):
    """The follower's segment files equal the leader's byte for byte (a
    delete ships as a frame), its reads equal the leader's, each package's
    follower equals the other's, a gap raises, and a rewritten leader
    segment refuses a read at the old epoch."""
    for side in SIDES:
        leader = make_store(side, f"{side.name}_lead", shards)
        follower = make_store(side, f"{side.name}_follow")
        writer_log(side, leader, n=1500)
        leader.insert_batch(fixed_events(side), 1)
        if shards > 1:
            assert leader.maybe_roll(1, limit_bytes=1) >= 1
            writer_log(side, leader, seed=2, n=40)
        status = replicate(leader, follower)
        assert status["shards"] == shards
        leader.client.sync()
        follower.client.sync()
        lead_files = log_files(tmp_path / f"{side.name}_lead")
        assert lead_files == log_files(tmp_path / f"{side.name}_follow")
        same(cold(leader), cold(follower))
        assert [e.to_jsonable() for e in follower.find(app_id=1)] == \
            [e.to_jsonable() for e in leader.find(app_id=1)]
        with pytest.raises(side.base.StorageError, match="gap"):
            follower.replication_apply(1, shard=0, tier="hot",
                                       from_entry=10 ** 6, frames=b"x")
        epoch = status["status"][0]["epoch"]
        leader.compact(1)
        with pytest.raises(side.base.StorageError, match="epoch"):
            leader.replication_read(1, shard=0, epoch=epoch)
        follower.replication_reset(1, shard=0)
        assert follower.replication_status(1)["status"][0]["total"] == 0
    assert log_files(tmp_path / "jax_follow") == \
        log_files(tmp_path / "port_follow")


def test_port_follower_of_a_jax_leader(make_store, tmp_path):
    """Frames a JAX leader ships land in a port follower bit for bit."""
    leader = make_store(JAX, "lead")
    follower = make_store(PORT, "follow")
    writer_log(JAX, leader, n=300)
    replicate(leader, follower)
    leader.client.sync()
    follower.client.sync()
    assert log_files(tmp_path / "lead") == log_files(tmp_path / "follow")
    same(cold(follower), cold(leader))


# -- no fallback ----------------------------------------------------------

def test_unbuildable_library_makes_the_store_raise(tmp_path, monkeypatch):
    """``CXX=/bin/false`` and an empty build directory: opening a cpplog
    store raises a StorageError naming the toolchain, and no SQLite or
    Python store takes its place."""
    native = PORT.native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(PORT.base.StorageError, match="native library"):
        PORT.cpplog.StorageClient(PORT.config(tmp_path / "log"))
    from incubator_predictionio_tpu_torch.data.storage import Storage

    Storage.configure({
        "PIO_STORAGE_SOURCES_LOG_TYPE": "cpplog",
        "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "log2"),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "ev",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG"})
    try:
        with pytest.raises(PORT.base.StorageError, match="native library"):
            Storage.get_events()
    finally:
        Storage.reset()
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(RuntimeError, match="native build failed"):
        native.fnv1a64_table(b"ab", np.array([0, 1, 2]))


def test_fnv1a64_matches_jax():
    rng = np.random.default_rng(2)
    ids = [bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                              dtype=np.uint8)) for _ in range(200)]
    ids += [b"", "éva".encode(), b"u1"]
    offs = np.zeros(len(ids) + 1, np.int64)
    np.cumsum([len(b) for b in ids], out=offs[1:])
    blob = b"".join(ids)
    got = PORT.native.fnv1a64_table(blob, offs)
    np.testing.assert_array_equal(got, JAX.native.fnv1a64_table(blob, offs))
    assert [PORT.native.fnv1a64(b) for b in ids] == \
        [JAX.native.fnv1a64(b) for b in ids]
    with pytest.raises(ValueError, match="malformed"):
        PORT.native.fnv1a64_table(b"abc", np.array([0, 2, 1]))


# -- data/store.py's backend extras ---------------------------------------

def test_event_store_interactions_passes_the_cpplog_extras(tmp_path,
                                                            monkeypatch):
    """``EventStore.interactions`` hands ``stats``, ``shard_sink``,
    ``use_cache`` and ``seed_cache`` to the cpplog DAO; another backend
    refuses them (TypeError), as in the JAX package."""
    from incubator_predictionio_tpu_torch.data.storage import App, Storage
    from incubator_predictionio_tpu_torch.data.store import EventStore

    monkeypatch.setattr(PORT.traincache, "MIN_NNZ", 4)
    monkeypatch.setenv("PIO_SCAN_SHARDS", "2")
    Storage.configure({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_SOURCES_LOG_TYPE": "cpplog",
        "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path),
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    try:
        app_id = Storage.get_meta_data_apps().insert(App(0, "x"))
        events = Storage.get_events()
        events.init(app_id)
        events.import_interactions(
            PORT.inter(np.arange(40) % 7, np.arange(40) % 5,
                       np.arange(40) % 4 + 1), app_id,
            times=np.arange(40, dtype=np.int64))
        cpath = PORT.traincache.path_for(
            events.client._file(events.ns, app_id, None))
        assert cpath.exists()
        shards, stats = [], {}
        got = EventStore.interactions(
            app_name="x", value_prop="rating", use_cache=False,
            seed_cache=False, stats=stats,
            shard_sink=lambda k, *cols: shards.append(k))
        assert stats["scan_source"] == "scan" and shards == [0, 1]
        cpath.unlink()
        EventStore.interactions(app_name="x", value_prop="rating",
                                seed_cache=False)
        assert not cpath.exists()
        EventStore.interactions(app_name="x", value_prop="rating")
        assert cpath.exists()
        stats = {}
        served = EventStore.interactions(app_name="x", value_prop="rating",
                                         stats=stats)
        assert stats["scan_source"] == "cache"
        same(served, got)
    finally:
        Storage.reset()
    Storage.configure({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        **{f"PIO_STORAGE_REPOSITORIES_{r}_{f}": v
           for r in ("METADATA", "EVENTDATA", "MODELDATA")
           for f, v in (("NAME", r.lower()), ("SOURCE", "MEM"))}})
    try:
        Storage.get_meta_data_apps().insert(App(0, "x"))
        with pytest.raises(TypeError):
            EventStore.interactions(app_name="x", value_prop="rating",
                                    stats={})
    finally:
        Storage.reset()


# -- random operation sequences (tests/test_storage_differential.py) -------

hypothesis = pytest.importorskip(
    "hypothesis", reason="property-based differential needs hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

_NAMES = ("rate", "view", "$set", "$unset", "$delete")
_insert = st.fixed_dictionaries({
    "op": st.just("insert"),
    "name": st.sampled_from(_NAMES),
    "eid": st.sampled_from(("u1", "u2")),
    "target": st.one_of(st.none(), st.sampled_from(("i1", "i2"))),
    "minutes": st.integers(0, 5),
    "micros": st.sampled_from((0, 400, 900)),
    "prop": st.sampled_from(("rating", "color")),
    "value": st.one_of(st.integers(0, 3), st.just("red")),
    "explicit": st.one_of(st.none(), st.integers(0, 2)),
})
_delete = st.fixed_dictionaries({"op": st.just("delete"),
                                 "which": st.integers(0, 6)})
_window_lo = st.one_of(st.none(), st.integers(0, 4))
_window_hi = st.one_of(st.none(), st.integers(1, 6))
_find = st.fixed_dictionaries({
    "op": st.just("find"),
    "etype": st.one_of(st.none(), st.just("user")),
    "eid": st.one_of(st.none(), st.sampled_from(("u1", "u2"))),
    "names": st.one_of(st.none(), st.just(("rate",)),
                       st.just(("rate", "view"))),
    "lo": _window_lo, "hi": _window_hi,
    "limit": st.one_of(st.none(), st.integers(1, 4)),
    "reversed": st.booleans(),
})
_aggregate = st.fixed_dictionaries({"op": st.just("aggregate"),
                                    "lo": _window_lo, "hi": _window_hi})
_ops = st.lists(st.one_of(_insert, _delete, _find, _aggregate),
                min_size=1, max_size=25)


def apply_ops(side, ops, dao):
    """The op list on one DAO → its observable outputs (events compare at
    epoch millis, the durable stores' granularity)."""
    t0 = side.times.parse_iso8601("2022-01-01T00:00:00Z")

    def at(minutes):
        return None if minutes is None else t0 + timedelta(minutes=minutes)

    def canon(e):
        return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
                e.target_entity_id, dict(e.properties.to_jsonable()),
                side.times.to_millis(e.event_time))

    out, ids = [], []
    for op in ops:
        if op["op"] == "insert":
            target = None if op["name"].startswith("$") else op["target"]
            ids.append(dao.insert(side.Event(
                event=op["name"], entity_type="user", entity_id=op["eid"],
                target_entity_type="item" if target else None,
                target_entity_id=target,
                properties=side.DataMap({op["prop"]: op["value"]}),
                event_time=t0 + timedelta(minutes=op["minutes"],
                                          microseconds=op["micros"]),
                event_id=(None if op["explicit"] is None
                          else f"{op['explicit']:032d}")), 1))
        elif op["op"] == "delete":
            if ids:
                out.append(("delete",
                            dao.delete(ids[op["which"] % len(ids)], 1)))
        elif op["op"] == "find":
            out.append(("find", [canon(e) for e in dao.find(
                app_id=1, entity_type=op["etype"], entity_id=op["eid"],
                event_names=op["names"], start_time=at(op["lo"]),
                until_time=at(op["hi"]), limit=op["limit"],
                reversed=op["reversed"])]))
        else:
            agg = dao.aggregate_properties(
                app_id=1, entity_type="user", start_time=at(op["lo"]),
                until_time=at(op["hi"]))
            out.append(("aggregate", {k: dict(v.to_jsonable())
                                      for k, v in sorted(agg.items())}))
    out.append(("final", [canon(e) for e in dao.find(app_id=1)]))
    return out


def open_dao(side, backend, where):
    mod = importlib.import_module(f"{side.pkg}.data.storage.{backend}")
    cfg = side.base.StorageClientConfig(test=True, properties={
        "PATH": ":memory:" if backend == "sqlite" else str(where)})
    client = mod.StorageClient(cfg)
    return client, mod.DATA_OBJECTS["Events"](client, cfg, prefix="diff_")


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ops=_ops)
def test_backends_agree_on_random_op_sequences(tmp_path_factory, ops):
    """The port's memory, SQLite and cpplog stores and the JAX package's
    cpplog give the same outputs on the same random operations."""
    outs, clients = [], []
    try:
        for side, backend in ((PORT, "memory"), (PORT, "cpplog"),
                              (PORT, "sqlite"), (JAX, "cpplog")):
            client, dao = open_dao(side, backend,
                                   tmp_path_factory.mktemp("diff"))
            clients.append(client)
            outs.append(apply_ops(side, ops, dao))
    finally:
        for c in clients:
            c.close()
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]
    assert outs[3] == outs[1]


# -- pio upgrade on cpplog (the cpplog cases of tests/test_upgrade.py) -----

@pytest.fixture
def upgrade_stores(tmp_path):
    """Both packages' Storage on cpplog events (memory metadata and
    models), each under its own directory."""
    def env(sub):
        return {
            "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
            "PIO_STORAGE_SOURCES_EV_TYPE": "cpplog",
            "PIO_STORAGE_SOURCES_EV_PATH": str(tmp_path / sub),
            "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}

    for side in SIDES:
        side.storage.Storage.configure(env(side.name))
    yield env
    for side in SIDES:
        side.storage.Storage.reset()


def upgrade_of(side):
    return importlib.import_module(f"{side.pkg}.cli.commands").upgrade


def minutes_ev(side, i, minutes=0):
    return side.ev(eid=f"u{i}", target=f"i{i % 5}",
                   props={"rating": float(1 + i % 5)},
                   ms=1_767_225_600_000 + 60_000 * minutes)


def test_cpplog_compact_drops_dead_records_and_preserves_live(
        upgrade_stores):
    results = {}
    for side in SIDES:
        S = side.storage.Storage
        app_id = S.get_meta_data_apps().insert(side.storage.App(0, "upapp"))
        dao = S.get_events()
        ids = dao.insert_batch([minutes_ev(side, i, i) for i in range(40)],
                               app_id)
        for eid in ids[:15]:
            assert dao.delete(eid, app_id)
        path = dao.client._file(dao.ns, app_id, None)
        dirty = path.stat().st_size
        before = [(e.entity_id, e.event_time, e.properties.get("rating"))
                  for e in dao.find(app_id=app_id)]
        assert len(before) == 25
        res = upgrade_of(side)("upapp")
        assert len(res) == 1 and res[0]["events"] == 25
        assert res[0]["bytes_after"] < dirty
        after = [(e.entity_id, e.event_time, e.properties.get("rating"))
                 for e in dao.find(app_id=app_id)]
        assert after == before
        new_id = dao.insert(minutes_ev(side, 99, 99), app_id)
        assert dao.get(new_id, app_id) is not None
        assert len(dao.scan_interactions(
            app_id=app_id, event_names=("rate",), value_prop="rating")) == 26
        results[side.name] = ([r["events"] for r in res], after)
    assert results["port"] == results["jax"]


def test_cpplog_compact_invalidates_traincache(upgrade_stores, monkeypatch):
    for side in SIDES:
        monkeypatch.setattr(side.traincache, "MIN_NNZ", 4)
        S = side.storage.Storage
        app_id = S.get_meta_data_apps().insert(side.storage.App(0, "up2"))
        dao = S.get_events()
        dao.import_interactions(side.inter(np.arange(8) % 3,
                                           np.arange(8) % 4, np.ones(8)),
                                app_id)
        cpath = side.traincache.path_for(
            dao.client._file(dao.ns, app_id, None))
        assert cpath.exists()
        upgrade_of(side)("up2")
        assert not cpath.exists()
        assert len(dao.scan_interactions(
            app_id=app_id, event_names=("rate",), value_prop="rating")) == 8


def test_cpplog_compact_upgrades_bare_json_and_keeps_compact_records(
        upgrade_stores):
    """Compact (columnar) records byte-copy, a forged legacy bare-JSON
    record gains its sidecar; the rewritten files are equal across the
    packages."""
    import json as _json

    def fnv(s):
        return PORT.native.fnv1a64(s.encode()) if s else 0

    files = {}
    for side in SIDES:
        S = side.storage.Storage
        app_id = S.get_meta_data_apps().insert(side.storage.App(0, "fmt"))
        dao = S.get_events()
        dao.import_interactions(
            side.inter(np.arange(12) % 4, np.arange(12) % 5,
                       1 + np.arange(12) % 5), app_id,
            times=1_767_225_600_000 + 60_000 * np.arange(12,
                                                          dtype=np.int64),
            id_seed=7)
        path = dao.client._file(dao.ns, app_id, None)
        doc = {"eventId": "f" * 32, "event": "rate", "entityType": "user",
               "entityId": "legacy", "targetEntityType": "item",
               "targetEntityId": "i9", "properties": {"rating": 2.5},
               "eventTime": "2026-01-01T00:30:00.000+00:00", "tags": [],
               "creationTime": "2026-01-01T00:30:00.000+00:00"}
        payload = _json.dumps(doc, separators=(",", ":")).encode()
        header = struct.pack("<qQQQQIi", 1767227400000, fnv("user"),
                             fnv("legacy"), fnv("rate"), fnv("f" * 32),
                             len(payload), 0)
        env = upgrade_stores(side.name)
        S.reset()
        with open(path, "ab") as f:
            f.write(header + payload)
        S.configure(env)
        S.get_meta_data_apps().insert(side.storage.App(0, "fmt"))
        dao = S.get_events()
        assert dao.get("f" * 32, app_id).entity_id == "legacy"
        size_before = path.stat().st_size
        res = dao.compact(app_id)
        assert res["events"] == 13
        assert 0 < res["bytes_after"] - size_before < 200
        blob = path.read_bytes()
        off, flags_seen = 0, []
        while off + 48 <= len(blob):
            *_h, plen, flags = struct.unpack_from("<qQQQQIi", blob, off)
            flags_seen.append(flags)
            off += 48 + plen
        assert len(flags_seen) == 13 and all(f & 2 for f in flags_seen)
        assert dao.get("f" * 32, app_id).properties.get("rating") == 2.5
        assert len(dao.scan_interactions(
            app_id=app_id, event_names=("rate",), value_prop="rating")) == 13
        files[side.name] = blob
    assert files["port"] == files["jax"]


def test_upgrade_verb_prints_what_the_jax_cli_prints(upgrade_stores, capsys):
    """``pio upgrade`` through both CLIs on cpplog stores holding the same
    events: the same report, byte counts included."""
    outs = {}
    for side in SIDES:
        main = importlib.import_module(f"{side.pkg}.cli.main").main
        S = side.storage.Storage
        app_id = S.get_meta_data_apps().insert(side.storage.App(0, "cliup"))
        dao = S.get_events()
        dao.insert_batch(fixed_events(side), app_id)
        for k in range(0, 60, 7):
            dao.delete(f"{k:032x}", app_id)
        assert main(["upgrade"]) == 0
        outs[side.name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    assert "live events rewritten" in outs["port"]


def test_upgrade_on_memory_says_nothing_to_upgrade(capsys):
    outs = {}
    env = {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
           **{f"PIO_STORAGE_REPOSITORIES_{r}_{f}": v
              for r in ("METADATA", "EVENTDATA", "MODELDATA")
              for f, v in (("NAME", r.lower()), ("SOURCE", "MEM"))}}
    for side in SIDES:
        main = importlib.import_module(f"{side.pkg}.cli.main").main
        side.storage.Storage.configure(env)
        try:
            assert main(["upgrade"]) == 0
        finally:
            side.storage.Storage.reset()
        outs[side.name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    assert outs["port"].startswith("Nothing to upgrade")


def test_compaction_keeps_a_copy_readable_by_the_jax_package(make_store,
                                                             tmp_path):
    """A port log after deletes and ``compact``: the JAX package opens the
    rewritten file and reads what the port reads."""
    dao = make_store(PORT, "c")
    random_log(PORT, dao, 9, n=80)
    dao.compact(1)
    ref = cold(dao)
    dao.client.close()
    copy = tmp_path / "copy"
    shutil.copytree(tmp_path / "c", copy)
    client = JAX.cpplog.StorageClient(JAX.config(copy))
    try:
        same(ref, cold(JAX.cpplog.CppLogEvents(client, None, prefix="t_")))
    finally:
        client.close()
