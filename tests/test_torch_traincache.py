"""The port's training projection (``data/storage/traincache.py`` and its
cpplog wiring) against the JAX package's: tests/test_traincache.py
mirrored, each case run through both packages on logs of their own (``MIN_NNZ``
lowered to 4 in both, as the JAX tests do), the port's projection-served
scans equal to a fresh full scan and to the JAX package's scans byte for
byte; the projection and prep-plan files readable across the packages; the
prep-plan sidecar's histograms kept O(delta) as the JAX package keeps them.
"""

import importlib

import numpy as np
import pytest

PKGS = ("incubator_predictionio_tpu", "incubator_predictionio_tpu_torch")


class Side:
    def __init__(self, pkg):
        def mod(path):
            return importlib.import_module(f"{pkg}.{path}")

        self.cpplog = mod("data.storage.cpplog")
        self.traincache = mod("data.storage.traincache")
        self.base = mod("data.storage.base")
        self.Event = mod("data.event").Event
        self.DataMap = mod("data.datamap").DataMap
        self.from_millis = mod("utils.times").from_millis


JAX, PORT = (Side(p) for p in PKGS)


@pytest.fixture
def pair(tmp_path, monkeypatch):
    """[(side, JAX events DAO), (side, port events DAO)], each on its own
    log directory, every log "training scale"."""
    out, clients = [], []
    for name, side in (("jax", JAX), ("port", PORT)):
        monkeypatch.setattr(side.traincache, "MIN_NNZ", 4)
        client = side.cpplog.StorageClient(side.base.StorageClientConfig(
            properties={"PATH": str(tmp_path / name)}))
        clients.append(client)
        out.append((side, side.cpplog.CppLogEvents(client, None,
                                                   prefix="t_")))
    yield out
    for c in clients:
        c.close()


def _imp(side, events, app_id=1, n=8, t0=1_000_000, users=None, items=None):
    users = users if users is not None else np.arange(n, dtype=np.int32) % 3
    items = items if items is not None else np.arange(n, dtype=np.int32) % 4
    inter = side.base.Interactions(
        user_idx=np.asarray(users, np.int32),
        item_idx=np.asarray(items, np.int32),
        values=np.arange(1, len(users) + 1, dtype=np.float32),
        user_ids=[f"u{k}" for k in range(int(max(users)) + 1)],
        item_ids=[f"i{k}" for k in range(int(max(items)) + 1)],
    )
    assert events.import_interactions(
        inter, app_id, times=t0 + np.arange(len(users), dtype=np.int64),
    ) == len(users)


def _scan(events, app_id=1, **kw):
    kw.setdefault("entity_type", "user")
    kw.setdefault("target_entity_type", "item")
    kw.setdefault("event_names", ("rate",))
    kw.setdefault("value_prop", "rating")
    return events.scan_interactions(app_id=app_id, **kw)


def _cache_path(side, events, app_id=1):
    return side.traincache.path_for(
        events.client._file(events.ns, app_id, None))


def _fresh_scan(side, events, app_id=1, **kw):
    """Ground truth: the same query with the projection removed."""
    _cache_path(side, events, app_id).unlink(missing_ok=True)
    return _scan(events, app_id, **kw)


def _triples(inter):
    return [(inter.user_ids[int(u)], inter.item_ids[int(i)], float(v))
            for u, i, v in zip(inter.user_idx, inter.item_idx, inter.values)]


def _same(a, b):
    """Byte for byte: rows, values and the id tables' blobs and offsets."""
    assert _triples(a) == _triples(b)
    np.testing.assert_array_equal(a.user_idx, b.user_idx)
    np.testing.assert_array_equal(a.item_idx, b.item_idx)
    for ta, tb in ((a.user_ids, b.user_ids), (a.item_ids, b.item_ids)):
        assert bytes(ta.blob) == bytes(tb.blob)
        np.testing.assert_array_equal(ta.offsets, tb.offsets)


def _both(pair, scenario):
    """Run ``scenario(side, events)`` in each package; the port's results
    equal the JAX package's, read for read."""
    (jside, jev), (tside, tev) = pair
    ref, got = scenario(jside, jev), scenario(tside, tev)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        if isinstance(r, tuple) or not hasattr(r, "user_idx"):
            assert g == r
        else:
            _same(g, r)
    return got


def test_import_creates_cache_and_scan_serves_it(pair):
    def scenario(side, ev):
        _imp(side, ev)
        assert _cache_path(side, ev).exists()
        stats = {}
        served = _scan(ev, stats=stats)
        assert stats["scan_source"] == "cache"
        truth = _fresh_scan(side, ev)
        _same(served, truth)
        assert len(served) == 8
        return [served]

    _both(pair, scenario)


def test_cache_matches_scan_interning_order(pair):
    def scenario(side, ev):
        inter = side.base.Interactions(
            user_idx=np.array([2, 0, 2, 1], np.int32),
            item_idx=np.array([1, 1, 0, 2], np.int32),
            values=np.array([1, 2, 3, 4], np.float32),
            user_ids=["a", "b", "c", "never-used"],
            item_ids=["x", "y", "z"])
        ev.import_interactions(inter, 1, times=np.arange(4, dtype=np.int64))
        served = _scan(ev)
        assert list(served.user_ids) == ["c", "a", "b"]
        assert list(served.item_ids) == ["y", "x", "z"]
        _same(served, _fresh_scan(side, ev))
        return [served]

    _both(pair, scenario)


def test_tail_fold_after_rest_ingest(pair):
    def scenario(side, ev):
        _imp(side, ev, t0=1000)
        for k, minutes in ((0, 10), (1, 11)):
            ev.insert(side.Event(
                event="rate", entity_type="user", entity_id=f"new{k}",
                target_entity_type="item", target_entity_id="i0",
                properties=side.DataMap({"rating": 9.0 + k}),
                event_time=side.from_millis(1_000_000_000 + minutes)), 1)
        stats = {}
        served = _scan(ev, stats=stats)
        assert (stats["scan_source"], stats["scan_tail_rows"]) == ("cache",
                                                                   2)
        assert len(served) == 10 and "new0" in list(served.user_ids)
        cache = side.traincache.load(_cache_path(side, ev))
        assert cache is not None and len(cache) == 10
        plan = (stats["plan_user_degrees"].tolist(),
                stats["plan_item_degrees"].tolist())
        _same(served, _fresh_scan(side, ev))
        return [served, plan]

    _both(pair, scenario)


def test_second_import_appends_to_cache(pair):
    def scenario(side, ev):
        _imp(side, ev, t0=1000)
        _imp(side, ev, n=4, t0=500_000, users=np.array([3, 3, 0, 4]),
             items=np.array([0, 5, 1, 2]))
        cache = side.traincache.load(_cache_path(side, ev))
        assert cache is not None and len(cache) == 12
        assert cache.raw_count == 12
        served = _scan(ev)
        _same(served, _fresh_scan(side, ev))
        return [served, (cache.times.tolist(), cache.vals.tolist())]

    _both(pair, scenario)


def test_delete_invalidates_cache(pair):
    def scenario(side, ev):
        _imp(side, ev)
        victim = next(iter(ev.find(app_id=1)))
        assert ev.delete(victim.event_id, 1)
        served = _scan(ev)
        assert len(served) == 7
        cache = side.traincache.load(_cache_path(side, ev))
        assert cache is not None and len(cache) == 7
        assert (cache.raw_count, cache.dead_count) == (9, 2)
        _same(served, _fresh_scan(side, ev))
        return [served]

    _both(pair, scenario)


def test_time_window_served_from_cache(pair):
    def scenario(side, ev):
        _imp(side, ev, t0=1000)
        lo, hi = side.from_millis(1002), side.from_millis(1006)
        served = _scan(ev, start_time=lo, until_time=hi)
        truth = _fresh_scan(side, ev, start_time=lo, until_time=hi)
        assert len(served) == 4
        _same(served, truth)
        return [served]

    _both(pair, scenario)


def test_non_servable_queries_bypass_cache(pair):
    def scenario(side, ev):
        _imp(side, ev)
        fixed = _scan(ev, event_values={"rate": 2.5})
        assert set(fixed.values.tolist()) == {2.5}
        default = _scan(ev, value_prop=None, default_value=7.0)
        assert set(default.values.tolist()) == {7.0}
        stats = {}
        two = _scan(ev, event_names=("rate", "buy"), stats=stats)
        assert stats["scan_source"] == "scan" and len(two) == 8
        return [fixed, default, two]

    _both(pair, scenario)


def test_out_of_order_tail_falls_back(pair):
    def scenario(side, ev):
        _imp(side, ev, t0=1_000_000)
        ev.insert(side.Event(
            event="rate", entity_type="user", entity_id="early",
            target_entity_type="item", target_entity_id="i0",
            properties=side.DataMap({"rating": 1.0}),
            event_time=side.from_millis(5)), 1)
        stats = {}
        served = _scan(ev, stats=stats)
        assert stats["scan_source"] == "scan"   # the full scan took it
        assert _triples(served)[0][0] == "early"
        _same(served, _fresh_scan(side, ev))
        return [served]

    _both(pair, scenario)


def test_small_logs_get_no_cache(pair, monkeypatch):
    def scenario(side, ev):
        monkeypatch.setattr(side.traincache, "MIN_NNZ", 1_000_000)
        _imp(side, ev)
        assert not _cache_path(side, ev).exists()
        served = _scan(ev)
        assert len(served) == 8
        assert not _cache_path(side, ev).exists()
        return [served]

    _both(pair, scenario)


def test_min_nnz_reads_its_variable(monkeypatch):
    """``MIN_NNZ`` comes from ``PIO_TRAINCACHE_MIN_NNZ`` at import, with
    the JAX package's default."""
    import subprocess
    import sys

    code = ("import incubator_predictionio_tpu_torch.data.storage."
            "traincache as t; print(t.MIN_NNZ)")
    for env, want in (({}, "1000000"),
                      ({"PIO_TRAINCACHE_MIN_NNZ": "12"}, "12")):
        monkeypatch.delenv("PIO_TRAINCACHE_MIN_NNZ", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == want
    assert JAX.traincache.MIN_NNZ == 1_000_000


def test_corrupt_cache_is_ignored(pair):
    def scenario(side, ev):
        _imp(side, ev)
        path = _cache_path(side, ev)
        path.write_bytes(path.read_bytes()[:40])
        assert side.traincache.load(path) is None
        served = _scan(ev)
        assert len(served) == 8
        _same(served, _fresh_scan(side, ev))
        return [served]

    _both(pair, scenario)


def test_drop_removes_cache(pair):
    def scenario(side, ev):
        _imp(side, ev)
        stats = {}
        _scan(ev, stats=stats)
        ppath = side.traincache.plan_path_for(
            ev.client._file(ev.ns, 1, None))
        assert _cache_path(side, ev).exists() and ppath.exists()
        ev.remove(1)
        assert not _cache_path(side, ev).exists()
        assert not ppath.exists()
        return []

    _both(pair, scenario)


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_projection_and_plan_files_load_in_the_other_package(
        tmp_path, writer, reader):
    """The two packages' files are the same format: a projection or a
    prep plan written by one loads in the other, field for field, and the
    same cache written by each is the same bytes."""
    spec = writer.traincache.Spec("user", "item", "rate", "rating")
    cache = writer.traincache.TrainCache(
        spec=spec, uidx=np.array([0, 1, 0], np.int32),
        iidx=np.array([1, 0, 2], np.int32),
        vals=np.array([1.5, 2.0, 4.5], np.float32),
        times=np.array([5, 6, 9], np.int64),
        user_tab=writer.base.IdTable.from_list(["a", "éb"]),
        item_tab=writer.base.IdTable.from_list(["x", "y", "z"]),
        raw_count=4, dead_count=1)
    path = tmp_path / "w.traincache"
    writer.traincache.write(path, cache)
    got = reader.traincache.load(path)
    assert got is not None
    assert got.spec.to_json() == spec.to_json()
    for f in ("uidx", "iidx", "vals", "times"):
        np.testing.assert_array_equal(getattr(got, f), getattr(cache, f))
    assert list(got.user_tab) == ["a", "éb"]
    assert (got.raw_count, got.dead_count) == (4, 1)
    again = tmp_path / "r.traincache"
    reader.traincache.write(again, got)
    assert again.read_bytes() == path.read_bytes()
    ppath = tmp_path / "w.prepplan"
    writer.traincache.save_plan(ppath, spec, 4, 1, np.array([2, 1]),
                                np.array([1, 1, 1]))
    rspec = reader.traincache.Spec("user", "item", "rate", "rating")
    ud, id_ = reader.traincache.load_plan(ppath, rspec, 4, 1)
    assert ud.tolist() == [2, 1] and id_.tolist() == [1, 1, 1]
    assert reader.traincache.load_plan(ppath, rspec, 5, 1) is None


def test_prep_plan_sidecar_roundtrip_and_keying(tmp_path):
    tc = PORT.traincache
    spec = tc.Spec("user", "item", "rate", "rating")
    p = tc.plan_path_for(tmp_path / "x.log")
    assert p.name == "x.log.prepplan"
    tc.save_plan(p, spec, 100, 0, np.arange(5, dtype=np.int64),
                 np.arange(3, dtype=np.int64) * 2)
    ud, id_ = tc.load_plan(p, spec, 100, 0)
    assert ud.tolist() == [0, 1, 2, 3, 4] and id_.tolist() == [0, 2, 4]
    assert tc.load_plan(p, spec, 101, 0) is None
    assert tc.load_plan(p, spec, 100, 1) is None
    assert tc.load_plan(p, tc.Spec("user", "item", "buy", "rating"), 100,
                        0) is None
    p.write_bytes(p.read_bytes()[:-8])   # torn
    assert tc.load_plan(p, spec, 100, 0) is None
    tc.invalidate(tmp_path / "x.log")
    assert not p.exists()


def test_concurrent_cache_stages_use_distinct_tmp_files(tmp_path):
    """Serialization runs outside the storage lock: two stages of one
    cache get distinct temp files; the last commit wins; no temp left."""
    tc = PORT.traincache
    spec = tc.Spec("user", "item", "rate", "rating")

    def make(val):
        return tc.TrainCache(
            spec=spec, uidx=np.zeros(4, np.int32), iidx=np.zeros(4, np.int32),
            vals=np.full(4, val, np.float32),
            times=np.arange(4, dtype=np.int64),
            user_tab=tc._build_table([b"u0"]),
            item_tab=tc._build_table([b"i0"]),
            raw_count=4, dead_count=0)

    cpath = tmp_path / "log.traincache"
    a = tc.stage(cpath, make(1.0))
    b = tc.stage(cpath, make(2.0))
    assert a._tmp != b._tmp
    a.commit()
    b.commit()
    loaded = tc.load(cpath)
    assert loaded is not None and loaded.vals[0] == 2.0
    assert not list(tmp_path.glob("*.tmp*"))
    c = tc.stage(cpath, make(3.0))
    c.abort()
    assert tc.load(cpath).vals[0] == 2.0
    assert not list(tmp_path.glob("*.tmp*"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_id_table_algebra_matches_jax(seed):
    """``merge_tables``, ``TableMerger`` and ``first_seen_reindex``: the
    port's give the JAX package's tables and remaps (the first-seen order
    the port's BiMap and retrain rely on)."""
    rng = np.random.default_rng(seed)

    def table(side, ids):
        return side.base.IdTable.from_list(ids)

    pool = [f"id{k}" for k in range(40)] + ["é", ""]
    a = list(dict.fromkeys(rng.choice(pool, 15).tolist()))
    b = list(dict.fromkeys(rng.choice(pool, 15).tolist()))
    idx = rng.integers(0, len(b), 30).astype(np.int32)
    outs = []
    for side in (JAX, PORT):
        tc = side.traincache
        merged, remap = tc.merge_tables(table(side, a), table(side, b))
        m = tc.TableMerger()
        r1, r2 = m.add(table(side, a)), m.add(table(side, b))
        ridx, rtab = tc.first_seen_reindex(idx, table(side, b))
        outs.append((list(merged), remap.tolist(), r1.tolist(), r2.tolist(),
                     list(m.table()), ridx.tolist(), list(rtab),
                     bytes(merged.blob), merged.offsets.tolist()))
    assert outs[1] == outs[0]
    assert outs[1][0][:len(a)] == a       # the base table stays a prefix
