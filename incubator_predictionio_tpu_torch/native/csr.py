"""ctypes wrapper for the native COO → padded-rows builder: the port's own
copy of incubator_predictionio_tpu/native/csr.py.

Produces exactly the same bucket layout as the numpy path in
``ops/sparse.py`` (stable within-row order, power-of-two widths, heavy rows
split at ``max_width``) — the test suite asserts bit-equality — but the
per-row fill loop runs in C++ (``src/csr_builder.cc``) instead of the
Python interpreter, which is what makes ML-20M-scale training reads cheap.
A library that cannot be built raises (``native.load``); the only ``None``
is the int32 guard's, which sends the caller to the int64 numpy path.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from incubator_predictionio_tpu_torch import native


def _as_ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def bucket_counts_from_degrees(
    degrees: np.ndarray, min_width: int, max_width: int, n_buckets: int
) -> np.ndarray:
    """Per-bucket segment counts from a per-row degree histogram — the
    same numbers ``pio_csr_plan`` derives from one O(nnz) pass over the
    rows array, computed instead from degrees alone (O(n_rows),
    vectorized), for a caller that already holds the histogram:
    ``ops/sparse.build_both_sides(user_degrees=, item_degrees=)``, and
    through it ``ops/sparse.StreamingPrep.finish``, whose histograms come
    from the cpplog scan's ``shard_sink``. The histograms the cpplog scan
    keeps in its prep-plan sidecar (its stats' ``plan_user_degrees`` /
    ``plan_item_degrees``) are passed by no training path, in this
    package as in the JAX one."""
    d = np.asarray(degrees, np.int64)
    counts = np.zeros(n_buckets, np.int64)
    # rows longer than max_width split into full-width segments + a tail
    counts[n_buckets - 1] += int((d // max_width).sum())
    rem = d % max_width
    rem = rem[rem > 0]
    widths = np.int64(min_width) << np.arange(n_buckets, dtype=np.int64)
    counts += np.bincount(
        np.searchsorted(widths, rem, side="left"), minlength=n_buckets)
    return counts


def build_buckets_native(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    min_width: int,
    max_width: int,
    degrees: Optional[np.ndarray] = None,
) -> Optional[List[Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]]:
    """Returns [(width, row_ids, cols, vals, mask)] per non-empty bucket,
    width-ascending, or None when a row or column index does not fit in
    int32 (the caller then takes the numpy path). Raises when the native
    library cannot be built.

    ``degrees`` (optional, int64[n_rows] with ``degrees.sum() == nnz``):
    a precomputed per-row nnz histogram replacing the native plan pass.
    The fill is safe against a wrong histogram: the native fill bound-
    checks every bucket and reports the segment total, and any mismatch
    falls back to the exact plan — worst case is one wasted allocation,
    never corrupt buckets."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if len(rows) and (
        int(rows.max()) >= 2**31 or int(cols.max()) >= 2**31
        or int(rows.min()) < 0 or int(cols.min()) < 0
    ):
        # int32 cast below would silently wrap; let the caller take the
        # numpy (int64) path instead of corrupting buckets
        return None
    lib = native.load()
    rows32 = np.ascontiguousarray(rows, np.int32)
    cols32 = np.ascontiguousarray(cols, np.int32)
    vals32 = np.ascontiguousarray(vals, np.float32)
    nnz = rows32.shape[0]
    n_buckets = 1
    while (min_width << (n_buckets - 1)) < max_width:
        n_buckets += 1

    def exact_counts() -> np.ndarray:
        counts = np.zeros(n_buckets, np.int64)
        rc = lib.pio_csr_plan(
            _as_ptr(rows32, ctypes.c_int32), nnz, n_rows,
            min_width, max_width, n_buckets, _as_ptr(counts, ctypes.c_int64),
        )
        if rc != 0:
            raise ValueError("csr plan failed (row index out of range?)")
        return counts

    counts = None
    if degrees is not None:
        d = np.asarray(degrees, np.int64)
        if d.shape == (n_rows,) and (
                len(d) == 0 or int(d.min()) >= 0) and int(d.sum()) == nnz:
            counts = bucket_counts_from_degrees(
                d, min_width, max_width, n_buckets)
    from_degrees = counts is not None
    if counts is None:
        counts = exact_counts()

    row_ids = [np.zeros(int(c), np.int32) for c in counts]
    out_cols = [np.zeros((int(c), min_width << b), np.int32)
                for b, c in enumerate(counts)]
    out_vals = [np.zeros((int(c), min_width << b), np.float32)
                for b, c in enumerate(counts)]
    out_mask = [np.zeros((int(c), min_width << b), np.float32)
                for b, c in enumerate(counts)]

    def ptr_array(arrs, ctype):
        pp = (ctypes.POINTER(ctype) * n_buckets)()
        for i, a in enumerate(arrs):
            pp[i] = _as_ptr(a, ctype)
        return pp

    rc = lib.pio_csr_fill(
        _as_ptr(rows32, ctypes.c_int32), _as_ptr(cols32, ctypes.c_int32),
        _as_ptr(vals32, ctypes.c_float), nnz, n_rows,
        min_width, max_width, n_buckets, _as_ptr(counts, ctypes.c_int64),
        ptr_array(row_ids, ctypes.c_int32), ptr_array(out_cols, ctypes.c_int32),
        ptr_array(out_vals, ctypes.c_float), ptr_array(out_mask, ctypes.c_float),
    )
    if rc != int(counts.sum()):
        # a degree-derived plan disagreed with the data (under-allocation
        # is rejected natively, over-allocation shows as a segment-count
        # shortfall): redo with the exact plan — never serve junk rows
        if from_degrees:
            return build_buckets_native(
                rows32, cols32, vals32, n_rows, min_width, max_width)
        raise ValueError("csr fill failed")
    return [
        (min_width << b, row_ids[b], out_cols[b], out_vals[b], out_mask[b])
        for b in range(n_buckets) if counts[b] > 0
    ]
