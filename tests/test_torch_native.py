"""The port's host phases of ALS training against the JAX package's, bit for
bit, on seeded numpy inputs:

- the native bucket builder (``native/csr.py`` → ``native/src/
  csr_builder.cc``, built here with the host ``g++``) against the port's
  numpy route and the JAX package's ``build_padded_rows``: row ids,
  columns, values and masks equal, heavy rows split at ``max_width`` the
  same way, a degree histogram that is wrong on purpose detected and the
  exact plan redone, indices beyond int32 sent to the numpy route;
- the preparator's latest-wins dedup (``ops/sparse.latest_wins``, on the
  context's device, here the CPU) against the JAX preparator's
  ``_prepare_columnar`` on seeded duplicates;
- ``build_both_sides`` given the per-side degree histograms: the trees it
  builds without them, and the JAX package's;
- the event log (``native/src/eventlog.cc`` under ``data/storage/
  cpplog.py``): tests/test_native.py's durability, compact-record,
  threaded bulk-append, every-byte truncation and uniform-batch classes,
  with the JAX package reading the port's logs and rendering the same
  bytes where the ids and times are fixed.
"""

import numpy as np
import pytest
import torch

from incubator_predictionio_tpu.data.storage.base import (
    Interactions as JInteractions,
)
from incubator_predictionio_tpu.models.recommendation import engine as jeng
from incubator_predictionio_tpu.ops import sparse as jsparse
from incubator_predictionio_tpu.parallel.context import (
    RuntimeContext as JContext,
)
from incubator_predictionio_tpu_torch import native
from incubator_predictionio_tpu_torch.data.interactions import Interactions
from incubator_predictionio_tpu_torch.models.recommendation import (
    engine as teng,
)
from incubator_predictionio_tpu_torch.native import csr
from incubator_predictionio_tpu_torch.ops import als
from incubator_predictionio_tpu_torch.ops import sparse as tsparse
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

CASES = {
    "mixed": (0, 50, 40, 600, 64),
    "tiny_one_bucket": (1, 7, 5, 30, 8),
    "heavy_rows_split": (2, 100, 30, 2000, 16),
    "power_law": (3, 400, 300, 20_000, 256),
}


def _coo(seed, n_rows, n_cols, nnz, skew=False):
    rng = np.random.default_rng(seed)
    if skew:
        w = (np.arange(n_rows) + 1.0) ** -0.8
        rows = rng.choice(n_rows, nnz, p=w / w.sum()).astype(np.int64)
    else:
        rows = rng.integers(0, n_rows, nnz).astype(np.int64)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return rows, cols, vals


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for f in ("row_ids", "cols", "vals", "mask"):
            a, b = np.asarray(getattr(g, f)), np.asarray(getattr(r, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_buckets_equal_numpy_and_jax(case):
    seed, n_rows, n_cols, nnz, max_width = CASES[case]
    rows, cols, vals = _coo(seed, n_rows, n_cols, nnz,
                            skew=case == "power_law")
    got = tsparse.build_padded_rows(rows, cols, vals, n_rows,
                                    max_width=max_width, impl="native")
    _same(got, tsparse.build_padded_rows(rows, cols, vals, n_rows,
                                         max_width=max_width, impl="numpy"))
    _same(got, jsparse.build_padded_rows(rows, cols, vals, n_rows,
                                         max_width=max_width, impl="numpy"))
    if case == "heavy_rows_split":
        assert max(np.bincount(rows)) > max_width
        light, heavy = tsparse.split_heavy(got)
        jlight, jheavy = jsparse.split_heavy(
            jsparse.build_padded_rows(rows, cols, vals, n_rows,
                                      max_width=max_width, impl="numpy"))
        _same(light, jlight)
        for f in ("seg_ids", "row_ids", "cols", "vals", "mask"):
            np.testing.assert_array_equal(getattr(heavy, f),
                                          getattr(jheavy, f), err_msg=f)


@pytest.mark.parametrize("wrong", ["short", "long", "shifted",
                                   "wrong_shape", "negative"])
def test_a_wrong_degree_histogram_is_redone_exactly(wrong):
    rows, cols, vals = _coo(4, 60, 50, 1500)
    n_rows = 60
    degrees = np.bincount(rows, minlength=n_rows).astype(np.int64)
    bad = degrees.copy()
    if wrong == "short":
        bad[np.argmax(bad)] -= 5
    elif wrong == "long":
        bad[0] += 40
    elif wrong == "shifted":      # same total, in the wrong rows
        bad = np.roll(bad, 7)
    elif wrong == "wrong_shape":
        bad = bad[:-1]
    else:
        bad[1] = -bad[1]
    ref = tsparse.build_padded_rows(rows, cols, vals, n_rows, max_width=32,
                                    impl="numpy")

    def native_rows(hist):
        buckets = csr.build_buckets_native(rows, cols, vals, n_rows,
                                           min_width=8, max_width=32,
                                           degrees=hist)
        return [tsparse.PaddedRows(row_ids=r, cols=c, vals=v, mask=m)
                .pad_rows_to(8) for (_w, r, c, v, m) in buckets]

    _same(native_rows(bad), ref)
    _same(native_rows(degrees), ref)
    _same(native_rows(None), ref)


def test_indices_beyond_int32_take_the_numpy_route():
    rows = np.array([0, 2**31 + 5], np.int64)
    cols = np.array([0, 1], np.int64)
    vals = np.array([1.0, 2.0], np.float32)
    assert csr.build_buckets_native(rows, cols, vals, n_rows=2**31 + 6,
                                    min_width=8, max_width=64) is None
    _same(tsparse.build_padded_rows(rows, cols, vals, 2**31 + 6,
                                    impl="native"),
          tsparse.build_padded_rows(rows, cols, vals, 2**31 + 6,
                                    impl="numpy"))


def test_empty_rows_and_empty_input():
    rows = np.array([0] * 10 + [2], np.int64)
    cols = np.arange(11, dtype=np.int32)
    vals = np.ones(11, np.float32)
    _same(tsparse.build_padded_rows(rows, cols, vals, 10, impl="native"),
          jsparse.build_padded_rows(rows, cols, vals, 10, impl="numpy"))
    assert tsparse.build_padded_rows(
        np.empty(0, np.int64), np.empty(0, np.int32),
        np.empty(0, np.float32), 4, impl="native") == []


def test_auto_takes_native_from_the_threshold(monkeypatch):
    """``impl="auto"`` calls the native builder from ``NATIVE_MIN_NNZ``
    triples up (the JAX package's 100,000) and numpy below."""
    assert tsparse.NATIVE_MIN_NNZ == jsparse.NATIVE_MIN_NNZ == 100_000
    calls = []
    real = csr.build_buckets_native
    monkeypatch.setattr(csr, "build_buckets_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tsparse, "NATIVE_MIN_NNZ", 400)
    rows, cols, vals = _coo(5, 30, 20, 399)
    tsparse.build_padded_rows(rows, cols, vals, 30)
    assert calls == []
    rows, cols, vals = _coo(5, 30, 20, 400)
    got = tsparse.build_padded_rows(rows, cols, vals, 30)
    assert calls == [1]
    _same(got, tsparse.build_padded_rows(rows, cols, vals, 30,
                                         impl="numpy"))


def test_a_failed_build_raises_instead_of_falling_back(monkeypatch,
                                                       tmp_path):
    """Unlike the JAX package's quiet fallback to numpy, the native route
    raises when its library cannot be built."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    rows, cols, vals = _coo(6, 30, 20, 500)
    with pytest.raises(RuntimeError, match="native build failed"):
        tsparse.build_padded_rows(rows, cols, vals, 30, impl="native")
    monkeypatch.setattr(tsparse, "NATIVE_MIN_NNZ", 100)
    with pytest.raises(RuntimeError, match="native build failed"):
        tsparse.build_padded_rows(rows, cols, vals, 30)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.load()
    # the numpy route is taken only when asked for
    assert tsparse.build_padded_rows(rows, cols, vals, 30, impl="numpy")


def test_the_library_is_cached_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    path = native.lib_path()
    assert path.parent == tmp_path and not path.exists()
    assert native.build() == path and path.exists()
    mtime = path.stat().st_mtime_ns
    assert native.build() == path and path.stat().st_mtime_ns == mtime


def test_prepare_trees_routes_alike():
    """Both training sides' buckets on the CPU, native and numpy: the same
    tensors."""
    rows, cols, vals = _coo(7, 80, 60, 3000, skew=True)
    a = als.prepare_trees(rows, cols, vals, 80, 60, max_width=64,
                          device="cpu", impl="native")
    b = als.prepare_trees(rows, cols, vals, 80, 60, max_width=64,
                          device="cpu", impl="numpy")
    flat_a = [t for part in a if part is not None
              for t in torch.utils._pytree.tree_leaves(part)]
    flat_b = [t for part in b if part is not None
              for t in torch.utils._pytree.tree_leaves(part)]
    assert len(flat_a) == len(flat_b) > 0
    for x, y in zip(flat_a, flat_b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def _numpy_latest_wins(users, items, n_items):
    """The JAX preparator's route, the plain reference of
    ``latest_wins``: one ``np.unique`` over the reversed packed keys."""
    keys = np.asarray(users, np.int64) * n_items + np.asarray(items, np.int64)
    _, first_in_rev = np.unique(keys[::-1], return_index=True)
    return np.sort(len(keys) - 1 - first_in_rev)


DEDUP = {
    "few_duplicates": (0, 50, 40, 500),
    "many_duplicates": (1, 6, 5, 400),
    "no_duplicates": (2, 1000, 1000, 50),
    "one_pair": (3, 1, 1, 20),
}


@pytest.mark.parametrize("case", sorted(DEDUP))
def test_device_dedup_equals_the_jax_preparator(case):
    seed, n_users, n_items, nnz = DEDUP[case]
    rng = np.random.default_rng(seed)
    cols = dict(user_idx=rng.integers(0, n_users, nnz).astype(np.int32),
                item_idx=rng.integers(0, n_items, nnz).astype(np.int32),
                values=rng.standard_normal(nnz).astype(np.float32),
                user_ids=[f"u{k}" for k in range(n_users)],
                item_ids=[f"i{k}" for k in range(n_items)])
    ref = jeng.RecommendationPreparator().prepare(
        JContext(), jeng.TrainingData(interactions=JInteractions(**cols)))
    got = teng.RecommendationPreparator().prepare(
        RuntimeContext(device="cpu"),
        teng.TrainingData(interactions=Interactions(**cols)))
    for f in ("users", "items", "ratings"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert dict(got.user_bimap.items()) == dict(ref.user_bimap.items())
    assert dict(got.item_bimap.items()) == dict(ref.item_bimap.items())
    keep = tsparse.latest_wins(cols["user_idx"], cols["item_idx"], n_items,
                               torch.device("cpu"))
    np.testing.assert_array_equal(
        keep, _numpy_latest_wins(cols["user_idx"], cols["item_idx"], n_items))
    assert keep.dtype == np.int64
    assert np.all(np.diff(keep) > 0)


def test_dedup_of_nothing():
    empty = np.empty(0, np.int32)
    assert tsparse.latest_wins(empty, empty, 5, torch.device("cpu")
                               ).tolist() == []


# -- the degree histograms of build_both_sides ------------------------------

@pytest.mark.parametrize("impl", ["native", "numpy", "auto"])
@pytest.mark.parametrize("case", ["mixed", "heavy_rows_split", "power_law"])
def test_both_sides_with_degrees_equal_without(case, impl):
    """``build_both_sides(user_degrees=, item_degrees=)``: the same trees
    as the build without them, bit for bit, and as the JAX package's build
    given the same histograms; ``on_side`` fires once a side."""
    seed, n_rows, n_cols, nnz, max_width = CASES[case]
    rows, cols, vals = _coo(seed, n_rows, n_cols, nnz,
                            skew=case == "power_law")
    ud = np.bincount(rows, minlength=n_rows).astype(np.int64)
    id_ = np.bincount(cols, minlength=n_cols).astype(np.int64)
    seen = []
    with_deg = tsparse.build_both_sides(
        rows, cols, vals, n_rows, n_cols, max_width=max_width, impl=impl,
        user_degrees=ud, item_degrees=id_,
        on_side=lambda side, light, heavy: seen.append(side))
    plain = tsparse.build_both_sides(rows, cols, vals, n_rows, n_cols,
                                     max_width=max_width, impl=impl)
    ref = jsparse.build_both_sides(rows, cols, vals, n_rows, n_cols,
                                   max_width=max_width, user_degrees=ud,
                                   item_degrees=id_)
    assert sorted(seen) == ["item", "user"]
    for other in (plain, ref):
        for (light, heavy), (olight, oheavy) in zip(with_deg, other):
            _same(light, olight)
            assert (heavy is None) == (oheavy is None)
            if heavy is not None:
                for f in ("seg_ids", "row_ids", "cols", "vals", "mask"):
                    np.testing.assert_array_equal(
                        getattr(heavy, f), getattr(oheavy, f), err_msg=f)


def test_a_wrong_histogram_through_build_both_sides():
    """A histogram that disagrees with the triples is detected natively
    and the exact plan taken: the same trees as without one."""
    rows, cols, vals = _coo(8, 40, 30, 900)
    bad = np.roll(np.bincount(rows, minlength=40).astype(np.int64), 3)
    got = tsparse.build_both_sides(rows, cols, vals, 40, 30, max_width=32,
                                   impl="native", user_degrees=bad)
    want = tsparse.build_both_sides(rows, cols, vals, 40, 30, max_width=32,
                                    impl="numpy")
    for (light, _h), (wlight, _wh) in zip(got, want):
        _same(light, wlight)


# -- the event log (tests/test_native.py's event-log classes) --------------

from datetime import timedelta  # noqa: E402

from incubator_predictionio_tpu.data.storage import cpplog as jcpplog  # noqa: E402,E501
from incubator_predictionio_tpu.data.storage import (  # noqa: E402
    traincache as jtraincache,
)
from incubator_predictionio_tpu_torch.data.datamap import DataMap  # noqa: E402,E501
from incubator_predictionio_tpu_torch.data.event import Event  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import (  # noqa: E402
    StorageClientConfig,
    cpplog,
    traincache,
)
from incubator_predictionio_tpu_torch.data.storage.base import (  # noqa: E402,E501
    IdTable,
)
from incubator_predictionio_tpu_torch.utils.times import (  # noqa: E402
    parse_iso8601,
)

T0 = parse_iso8601("2021-06-01T00:00:00Z")


def _client(path):
    return cpplog.StorageClient(
        StorageClientConfig(properties={"PATH": str(path)}))


def _events(client):
    return cpplog.CppLogEvents(client, client.config, prefix="t_")


def _jevents_at(path):
    from incubator_predictionio_tpu.data.storage import (
        StorageClientConfig as JConfig,
    )

    client = jcpplog.StorageClient(JConfig(properties={"PATH": str(path)}))
    return client, jcpplog.CppLogEvents(client, client.config, prefix="t_")


def ev(name="rate", eid="u1", minutes=0, target=None, props=None):
    return Event(
        event=name, entity_type="user", entity_id=eid,
        target_entity_type="item" if target else None,
        target_entity_id=target, properties=DataMap(props or {}),
        event_time=T0 + timedelta(minutes=minutes))


def _ids(dao):
    return [e.event_id for e in dao.find(app_id=1)]


class TestEventLogDurability:
    def test_events_survive_reopen(self, tmp_path):
        c1 = _client(tmp_path)
        d1 = _events(c1)
        d1.init(1)
        ids = [d1.insert(ev(minutes=i, eid=f"u{i}"), 1) for i in range(5)]
        d1.delete(ids[2], 1)
        c1.close()
        c2 = _client(tmp_path)
        d2 = _events(c2)
        assert _ids(d2) == [ids[0], ids[1], ids[3], ids[4]]
        assert d2.get(ids[2], 1) is None
        assert d2.get(ids[3], 1).entity_id == "u3"
        c2.close()
        jc, jd = _jevents_at(tmp_path)   # the JAX package sees the same
        assert _ids(jd) == [ids[0], ids[1], ids[3], ids[4]]
        jc.close()

    def test_upsert_replaces_across_reopen(self, tmp_path):
        c1 = _client(tmp_path)
        d1 = _events(c1)
        d1.init(1)
        eid = d1.insert(ev(props={"rating": 1}), 1)
        d1.insert(ev(props={"rating": 9}).with_id(eid), 1)
        assert d1.get(eid, 1).properties.get("rating") == 9
        assert len(_ids(d1)) == 1
        c1.close()
        c2 = _client(tmp_path)
        d2 = _events(c2)
        assert d2.get(eid, 1).properties.get("rating") == 9
        assert len(_ids(d2)) == 1
        c2.close()

    def test_torn_tail_truncated_on_reopen(self, tmp_path):
        import struct

        c1 = _client(tmp_path)
        d1 = _events(c1)
        d1.init(1)
        good = [d1.insert(ev(minutes=i, eid=f"u{i}"), 1) for i in range(3)]
        c1.close()
        log_file = next(tmp_path.glob("*.log"))
        intact = log_file.stat().st_size
        with open(log_file, "ab") as f:
            f.write(struct.pack("<qQQQQIi", 12345, 2, 3, 4, 5, 500, 0))
            f.write(b"x" * 10)
        c2 = _client(tmp_path)
        d2 = _events(c2)
        assert _ids(d2) == good
        assert log_file.stat().st_size == intact
        extra = d2.insert(ev(minutes=9, eid="u9"), 1)
        c2.close()
        c3 = _client(tmp_path)
        assert _ids(_events(c3)) == good + [extra]
        c3.close()

    def test_torn_header_truncated_on_reopen(self, tmp_path):
        c1 = _client(tmp_path)
        d1 = _events(c1)
        d1.init(1)
        good = d1.insert(ev(minutes=0, eid="u0"), 1)
        c1.close()
        log_file = next(tmp_path.glob("*.log"))
        intact = log_file.stat().st_size
        with open(log_file, "ab") as f:
            f.write(b"\x01" * 20)
        c2 = _client(tmp_path)
        assert _ids(_events(c2)) == [good]
        assert log_file.stat().st_size == intact
        c2.close()

    def test_out_of_order_times_sorted_and_limited(self, tmp_path):
        c = _client(tmp_path)
        d = _events(c)
        d.init(1)
        for m in (5, 1, 9, 3, 7):
            d.insert(ev(minutes=m, eid=f"u{m}"), 1)
        assert [e.entity_id for e in d.find(app_id=1)] == [
            "u1", "u3", "u5", "u7", "u9"]
        assert [e.entity_id for e in d.find(app_id=1, reversed=True,
                                            limit=2)] == ["u9", "u7"]
        assert [e.entity_id for e in d.find(
            app_id=1, start_time=T0 + timedelta(minutes=3),
            until_time=T0 + timedelta(minutes=9))] == ["u3", "u5", "u7"]
        c.close()


class TestCompactRecords:
    """Compact interaction records: sidecar only, JSON rendered on read."""

    def test_rendered_json_matches_canonical_shape(self, tmp_path):
        import json

        client = _client(tmp_path)
        dao = _events(client)
        inter = Interactions(
            user_idx=np.array([0, 1], np.int32),
            item_idx=np.array([1, 0], np.int32),
            values=np.array([4.5, 2.0], np.float32),
            user_ids=IdTable.from_list(['u"quote', "uplain"]),
            item_ids=IdTable.from_list(["i\\back", "iplain"]))
        assert dao.import_interactions(inter, 1, event_name="rate",
                                       value_prop="rating") == 2
        got = sorted(dao.find(app_id=1), key=lambda e: e.entity_id)
        for e in got:
            doc = e.to_jsonable()
            assert Event.from_jsonable(
                json.loads(json.dumps(doc))).to_jsonable() == doc
        assert got[0].entity_id == 'u"quote'
        assert got[0].target_entity_id == "iplain"
        assert got[1].target_entity_id == "i\\back"
        assert got[0].properties.get("rating") == 4.5
        assert got[0].event_id and len(got[0].event_id) == 32
        size = sum(f.stat().st_size for f in tmp_path.iterdir())
        assert size < 2 * 250, size
        client.close()
        jc, jd = _jevents_at(tmp_path)   # rendered alike by the JAX package
        assert [e.to_jsonable() for e in sorted(
            jd.find(app_id=1), key=lambda e: e.entity_id)] == \
            [e.to_jsonable() for e in got]
        jc.close()

    def test_compact_records_survive_reopen_and_tombstone(self, tmp_path):
        client = _client(tmp_path)
        dao = _events(client)
        inter = Interactions(
            user_idx=np.arange(5, dtype=np.int32),
            item_idx=np.zeros(5, np.int32), values=np.ones(5, np.float32),
            user_ids=IdTable.from_list([f"u{k}" for k in range(5)]),
            item_ids=IdTable.from_list(["i0"]))
        dao.import_interactions(inter, 1, event_name="rate",
                                value_prop="rating")
        first = next(iter(dao.find(app_id=1, limit=1)))
        assert dao.delete(first.event_id, 1)
        client.close()
        client2 = _client(tmp_path)
        dao2 = _events(client2)
        live = list(dao2.find(app_id=1))
        assert len(live) == 4
        assert first.event_id not in {e.event_id for e in live}
        assert len(dao2.scan_interactions(
            app_id=1, event_names=("rate",), value_prop="rating")) == 4
        client2.close()


class TestParallelBulkAppend:
    """The threaded render of ``pio_evlog_append_interactions``: more than
    2M events span two super-batches; ``PIO_NATIVE_THREADS`` sets the
    pool."""

    N = 2_100_000

    def test_two_superbatches_threaded_roundtrip(self, tmp_path,
                                                 monkeypatch):
        monkeypatch.setenv("PIO_NATIVE_THREADS", "4")
        monkeypatch.setattr(traincache, "MIN_NNZ", self.N * 10)
        rng = np.random.default_rng(3)
        nu, ni = 5_000, 1_200
        users = rng.integers(0, nu, self.N).astype(np.int32)
        items = rng.integers(0, ni, self.N).astype(np.int32)
        vals = rng.random(self.N).astype(np.float32)
        client = _client(tmp_path)
        try:
            events = _events(client)
            assert events.import_interactions(Interactions(
                user_idx=users, item_idx=items, values=vals,
                user_ids=IdTable.from_list([f"u{k}" for k in range(nu)]),
                item_ids=IdTable.from_list([f"i{k}" for k in range(ni)])),
                1, event_name="rate", value_prop="rating",
                base_time=T0) == self.N
            out = events.scan_interactions(
                app_id=1, event_names=("rate",), value_prop="rating")
        finally:
            client.close()
        assert len(out) == self.N
        u_names = np.array([f"u{k}" for k in range(nu)])
        assert (np.asarray(out.user_ids.tolist())[out.user_idx]
                == u_names[users]).all()
        i_names = np.array([f"i{k}" for k in range(ni)])
        assert (np.asarray(out.item_ids.tolist())[out.item_idx]
                == i_names[items]).all()
        np.testing.assert_allclose(out.values, vals, rtol=1e-6)

    def test_threaded_matches_single_thread_bytes(self, tmp_path,
                                                  monkeypatch):
        """The same seed renders the same log at 1 and 4 threads, and the
        JAX package renders those bytes too."""
        import hashlib

        rng = np.random.default_rng(5)
        n = 200_000
        monkeypatch.setattr(traincache, "MIN_NNZ", n * 10)
        monkeypatch.setattr(jtraincache, "MIN_NNZ", n * 10)
        cols = dict(user_idx=rng.integers(0, 50, n).astype(np.int32),
                    item_idx=rng.integers(0, 20, n).astype(np.int32),
                    values=rng.random(n).astype(np.float32),
                    user_ids=[f"u{k}" for k in range(50)],
                    item_ids=[f"i{k}" for k in range(20)])

        def digest(path):
            return [(p.name, hashlib.sha256(p.read_bytes()).hexdigest())
                    for p in sorted(path.iterdir())]

        def run(sub, threads, jax=False):
            monkeypatch.setenv("PIO_NATIVE_THREADS", str(threads))
            path = tmp_path / sub
            path.mkdir()
            if jax:
                client, events = _jevents_at(path)
                inter = JInteractions(**cols)
            else:
                client = _client(path)
                events, inter = _events(client), Interactions(**cols)
            events.import_interactions(inter, 1, event_name="rate",
                                       value_prop="rating", base_time=T0,
                                       id_seed=12345)
            client.close()
            return digest(path)

        one = run("t1", 1)
        assert one == run("t4", 4) == run("jax", 4, jax=True)


class TestRandomTruncationRecovery:
    """A cut at every byte of a log reopens to a whole-event prefix, and an
    append after the recovery frames correctly."""

    def test_every_cut_point_recovers_prefix(self, tmp_path):
        import shutil

        base = tmp_path / "orig"
        base.mkdir()
        c1 = _client(base)
        d1 = _events(c1)
        d1.init(1)
        ids = [d1.insert(ev(minutes=i, eid=f"u{i}"), 1) for i in range(3)]
        c1.close()
        blob = next(base.glob("*.log")).read_bytes()
        prev = -1
        for cut in range(len(blob) + 1):
            work = tmp_path / f"cut{cut}"
            shutil.copytree(base, work)
            next(work.glob("*.log")).write_bytes(blob[:cut])
            c = _client(work)
            d = _events(c)
            found = _ids(d)
            assert found == ids[:len(found)]
            assert len(found) >= prev
            extra = d.insert(ev(minutes=99, eid="u99"), 1)
            c.close()
            c2 = _client(work)
            assert _ids(_events(c2)) == ids[:len(found)] + [extra]
            c2.close()
            prev = len(found)
            shutil.rmtree(work)
        assert prev == 3


class TestUniformBatchFastPath:
    """``insert_batch`` sends uniform id-less interaction batches through
    the columnar import; the ids it returns are the stored ones."""

    def _batch(self, n, name="rate"):
        return [ev(name=name, eid=f"u{k % 5}", minutes=k,
                   target=f"i{k % 3}", props={"rating": float(k % 4)})
                for k in range(n)]

    def test_fast_path_ids_resolve_and_scan_matches(self, tmp_path,
                                                    monkeypatch):
        calls = []
        real = cpplog.CppLogEvents._append_columnar_any
        monkeypatch.setattr(cpplog.CppLogEvents, "_append_columnar_any",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        c = _client(tmp_path)
        d = _events(c)
        d.init(1)
        ids = d.insert_batch(self._batch(20), 1)
        assert calls == [1]
        assert len(ids) == 20 and len(set(ids)) == 20
        for k, eid in enumerate(ids):
            got = d.get(eid, 1)
            assert got is not None and got.event_id == eid
            assert got.entity_id == f"u{k % 5}"
            assert got.properties.get("rating") == float(k % 4)
        assert len(d.scan_interactions(
            app_id=1, event_names=("rate",), value_prop="rating")) == 20
        assert d.delete(ids[3], 1)
        assert d.get(ids[3], 1) is None
        c.close()

    def test_non_utc_batches_take_the_generic_path(self, tmp_path):
        import dataclasses
        from datetime import timezone as _tz

        c = _client(tmp_path)
        d = _events(c)
        d.init(1)
        jst = _tz(timedelta(hours=9))
        batch = [dataclasses.replace(e, event_time=e.event_time.astimezone(
            jst)) for e in self._batch(12)]
        ids = d.insert_batch(batch, 1)
        assert len(ids) == 12
        for src, eid in zip(batch, ids):
            got = d.get(eid, 1)
            assert got.event_time == src.event_time
            assert got.event_time.utcoffset() == timedelta(hours=9)
        c.close()

    def test_non_uniform_batches_take_the_generic_path(self, tmp_path):
        c = _client(tmp_path)
        d = _events(c)
        d.init(1)
        mixed = self._batch(10)
        mixed[4] = ev(name="view", eid="u1", minutes=4, target="i1",
                      props={"rating": 1.0})
        ids = d.insert_batch(mixed, 1)
        assert len(ids) == 10
        assert all(d.get(e, 1) is not None for e in ids)
        explicit = [e.with_id(f"{k:032d}")
                    for k, e in enumerate(self._batch(10))]
        assert d.insert_batch(explicit, 1) == [f"{k:032d}"
                                               for k in range(10)]
        c.close()
