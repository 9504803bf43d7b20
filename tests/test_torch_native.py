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
  ``_prepare_columnar`` on seeded duplicates.
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
