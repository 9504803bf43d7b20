"""Host-side sparse → degree-bucketed padded rows: the port's own copy of
incubator_predictionio_tpu/ops/sparse.py:22-350, both routes.

Rows (users or items) are grouped into buckets by degree ceiling (powers of
two from ``min_width``), each bucket padded to its ceiling: padding waste
stays under 2× and the number of distinct bucket widths is
O(log max_degree). Rows of degree above ``max_width`` are split into
segments; :func:`split_heavy` moves them out of the buckets for the
partial-Gram combining solve (ops/als.py ``_solve_heavy``).

:func:`build_padded_rows` takes the native C++ builder
(``native/csr.py`` → ``native/src/csr_builder.cc``) from
``NATIVE_MIN_NNZ`` triples up, as the JAX package does, and its numpy
route below that; both give the same buckets bit for bit. Unlike the JAX
package, a native library that cannot be built raises: the numpy route is
taken only when asked for (``impl="numpy"``) or when an index does not fit
in int32. The numpy route replaces the JAX package's per-segment Python
loops with array operations.

:func:`build_both_sides` builds both orientations at once and takes the
per-side degree histograms of the scan, and :class:`StreamingPrep`
accumulates those histograms from the cpplog scan's ``shard_sink`` while
the scan runs.

:func:`latest_wins` is the preparator's dedup of (user, item) pairs, the
last occurrence kept, on a torch device.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: triplet count above which the C++ builder is worth its call overhead
#: (the JAX package's value, ops/sparse.py:67)
NATIVE_MIN_NNZ = 100_000


@dataclasses.dataclass
class PaddedRows:
    """One degree bucket of padded neighbour lists.

    ``row_ids[i]`` is the original row of padded row ``i`` (-1 for a
    padding row); ``cols[i]`` / ``vals[i]`` are its neighbour columns and
    values, valid where ``mask[i] > 0``. Padding columns point at index 0
    with mask 0, so gathers stay in bounds."""

    row_ids: np.ndarray  # [B] int32
    cols: np.ndarray     # [B, D] int32
    vals: np.ndarray     # [B, D] float32
    mask: np.ndarray     # [B, D] float32

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    def pad_rows_to(self, multiple: int) -> "PaddedRows":
        """Pad the batch dimension to a multiple with row_id -1 and zero
        mask; the ALS scatter drops those rows."""
        b = self.row_ids.shape[0]
        target = ((b + multiple - 1) // multiple) * multiple
        if target == b:
            return self
        pad = target - b
        return PaddedRows(
            row_ids=np.concatenate([self.row_ids, np.full(pad, -1, np.int32)]),
            cols=np.concatenate(
                [self.cols, np.zeros((pad, self.width), np.int32)]),
            vals=np.concatenate(
                [self.vals, np.zeros((pad, self.width), np.float32)]),
            mask=np.concatenate(
                [self.mask, np.zeros((pad, self.width), np.float32)]),
        )


@dataclasses.dataclass
class HeavySegments:
    """Every split row's segments, for the partial-Gram combining solve:
    per-segment Grams and right-hand sides are summed by ``seg_ids``
    before one solve per heavy row."""

    seg_ids: np.ndarray  # [S] int32 → index into row_ids
    row_ids: np.ndarray  # [H] int32 original rows, ascending
    cols: np.ndarray     # [S, W] int32
    vals: np.ndarray     # [S, W] float32
    mask: np.ndarray     # [S, W] float32


def split_heavy(
    buckets: Sequence[PaddedRows],
    row_multiple: int = 8,
) -> Tuple[List[PaddedRows], Optional[HeavySegments]]:
    """Separate split rows (row ids that occur more than once) from the
    light buckets → (light buckets re-padded to ``row_multiple``,
    :class:`HeavySegments` or None when no row was split)."""
    all_ids = np.concatenate(
        [np.asarray(b.row_ids) for b in buckets]
    ) if buckets else np.empty(0, np.int32)
    live = all_ids[all_ids >= 0]
    uniq, counts = np.unique(live, return_counts=True)
    heavy_ids = uniq[counts > 1]
    if not len(heavy_ids):
        return list(buckets), None

    light: List[PaddedRows] = []
    seg_rows = []
    for b in buckets:
        ids = np.asarray(b.row_ids)
        is_heavy = np.isin(ids, heavy_ids) & (ids >= 0)
        for i in np.nonzero(is_heavy)[0]:
            seg_rows.append((int(ids[i]), b.cols[i], b.vals[i], b.mask[i]))
        keep = ~is_heavy & (ids >= 0)
        if keep.any():
            light.append(PaddedRows(
                row_ids=ids[keep], cols=b.cols[keep], vals=b.vals[keep],
                mask=b.mask[keep]).pad_rows_to(row_multiple))

    width = max(seg[1].shape[0] for seg in seg_rows)
    s = len(seg_rows)
    cols = np.zeros((s, width), np.int32)
    vals = np.zeros((s, width), np.float32)
    mask = np.zeros((s, width), np.float32)
    row_ids = np.asarray(heavy_ids, np.int32)
    index = {int(r): i for i, r in enumerate(row_ids)}
    seg_ids = np.empty(s, np.int32)
    for i, (rid, c, v, m) in enumerate(seg_rows):
        w = c.shape[0]
        cols[i, :w], vals[i, :w], mask[i, :w] = c, v, m
        seg_ids[i] = index[rid]
    return light, HeavySegments(
        seg_ids=seg_ids, row_ids=row_ids, cols=cols, vals=vals, mask=mask)


def build_padded_rows(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    min_width: int = 8,
    max_width: int = 4096,
    row_multiple: int = 8,
    impl: str = "auto",
    degrees: Optional[np.ndarray] = None,
) -> List[PaddedRows]:
    """COO triplets → degree-bucketed :class:`PaddedRows`, in ascending
    width; within a bucket, segments in row order. Rows of degree above
    ``max_width`` are split into ``max_width``-wide segments, so nothing
    is dropped. ``n_rows`` is the row space (rows without triples get no
    padded row).

    ``impl``: "auto" takes the native builder from ``NATIVE_MIN_NNZ``
    triples up and numpy below; "native" and "numpy" force a route. The
    native route raises when its library cannot be built, and falls to
    numpy only where an index exceeds int32.

    ``degrees``: an optional per-row nnz histogram (int64[n_rows], sum ==
    nnz) that replaces the native plan pass (``native/csr.py``); the
    numpy route has no plan pass and ignores it. A wrong histogram is
    detected natively and the exact plan is taken, so the buckets never
    depend on it."""
    if impl not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "native" or (impl == "auto" and len(rows) >= NATIVE_MIN_NNZ):
        from incubator_predictionio_tpu_torch.native.csr import (
            build_buckets_native,
        )

        buckets = build_buckets_native(
            np.asarray(rows), np.asarray(cols), np.asarray(vals), n_rows,
            min_width, max_width, degrees=degrees)
        if buckets is not None:
            return [PaddedRows(row_ids=r, cols=c, vals=v, mask=m)
                    .pad_rows_to(row_multiple)
                    for (_w, r, c, v, m) in buckets]
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int32)
    vals = np.asarray(vals, np.float32)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    row_ids_present, starts, counts = np.unique(
        rows, return_index=True, return_counts=True)

    # (row, start, length) of every segment, heavy rows split
    n_seg = -(-counts // max_width)
    seg_row = np.repeat(row_ids_present, n_seg)
    first = np.cumsum(n_seg) - n_seg
    seg_k = np.arange(int(n_seg.sum())) - np.repeat(first, n_seg)
    seg_start = np.repeat(starts, n_seg) + seg_k * max_width
    seg_len = np.minimum(np.repeat(counts, n_seg) - seg_k * max_width,
                         max_width)
    # bucket by power-of-two ceiling from min_width
    seg_width = np.full(len(seg_len), min_width, np.int64)
    while (seg_width < seg_len).any():
        seg_width = np.where(seg_width < seg_len, seg_width * 2, seg_width)

    out: List[PaddedRows] = []
    for width in np.unique(seg_width):
        sel = np.nonzero(seg_width == width)[0]
        b, lens = len(sel), seg_len[sel]
        slot = np.repeat(np.arange(b), lens)
        off = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                     lens)
        src = np.repeat(seg_start[sel], lens) + off
        c = np.zeros((b, int(width)), np.int32)
        v = np.zeros((b, int(width)), np.float32)
        m = np.zeros((b, int(width)), np.float32)
        c[slot, off] = cols[src]
        v[slot, off] = vals[src]
        m[slot, off] = 1.0
        out.append(PaddedRows(row_ids=seg_row[sel].astype(np.int32), cols=c,
                              vals=v, mask=m).pad_rows_to(row_multiple))
    return out


def build_both_sides(
    users: np.ndarray,
    items: np.ndarray,
    vals: np.ndarray,
    n_users: int,
    n_items: int,
    max_width: int = 4096,
    row_multiple: int = 8,
    split_row_multiple: int = 8,
    impl: str = "auto",
    user_degrees: Optional[np.ndarray] = None,
    item_degrees: Optional[np.ndarray] = None,
    on_side=None,
):
    """Both training orientations, built in two threads (the native
    builder's ctypes calls release the GIL) →
    ((user_light, user_heavy), (item_light, item_heavy)).

    ``user_degrees``/``item_degrees``: optional per-row histograms (see
    :func:`build_padded_rows`). ``on_side(side, light, heavy)``, side in
    {"user", "item"}, fires from the worker thread as soon as that side is
    built, so a consumer can start copying one side's buckets to the
    device while the other side is still padding."""
    def side(name, rows, cols, n_rows, degrees):
        out = split_heavy(
            build_padded_rows(rows, cols, vals, n_rows, max_width=max_width,
                              row_multiple=row_multiple, impl=impl,
                              degrees=degrees),
            row_multiple=split_row_multiple)
        if on_side is not None:
            on_side(name, out[0], out[1])
        return out

    with ThreadPoolExecutor(max_workers=2) as pool:
        fu = pool.submit(side, "user", users, items, n_users, user_degrees)
        fi = pool.submit(side, "item", items, users, n_items, item_degrees)
        return fu.result(), fi.result()


class StreamingPrep:
    """Scan→prep pipeline sink: consumes scan shards as they land (the
    JAX package's ``ops/sparse.StreamingPrep``).

    The sharded event-log scan (``data/storage/cpplog.py`` ``shard_sink``)
    hands over each completed shard, its indices already remapped into the
    global id tables, while later shards are still scanning with the GIL
    released. This sink does the prep work that one shard allows: the
    per-side degree histograms that replace the native csr plan pass
    (:func:`build_padded_rows` ``degrees``). ``overlap_s`` records the
    prep wall absorbed into the scan.

    ``finish(inter)`` then runs :func:`build_both_sides` on the final
    arrays. The histograms are used only when the scan did NOT reorder
    rows (``scan_reordered`` in the scan's stats): a reorder re-interns
    the ids, so the histograms would index a permuted table; they are
    dropped and the degrees recomputed natively."""

    def __init__(self) -> None:
        self.user_degrees = np.zeros(0, np.int64)
        self.item_degrees = np.zeros(0, np.int64)
        self.overlap_s = 0.0
        self.shards = 0

    def _accumulate(self, hist: np.ndarray, idx: np.ndarray) -> np.ndarray:
        add = np.bincount(idx, minlength=len(hist)).astype(np.int64)
        if len(add) > len(hist):
            add[:len(hist)] += hist
            return add
        hist += add
        return hist

    def add_shard(self, k: int, uidx, iidx, vals, times=None) -> None:
        import time

        t0 = time.perf_counter()
        self.user_degrees = self._accumulate(self.user_degrees, uidx)
        self.item_degrees = self._accumulate(self.item_degrees, iidx)
        self.shards += 1
        self.overlap_s += time.perf_counter() - t0

    def finish(
        self,
        inter,
        max_width: int = 4096,
        row_multiple: int = 8,
        split_row_multiple: int = 8,
        reordered: bool = False,
        on_side=None,
    ):
        """→ the ((user_light, user_heavy), (item_light, item_heavy))
        tuple of :func:`build_both_sides`, fed the accumulated histograms
        while they still hold for ``inter``."""
        n_users, n_items = len(inter.user_ids), len(inter.item_ids)
        ud = id_ = None
        if not reordered and self.shards:
            mu = min(n_users, len(self.user_degrees))
            ud = np.zeros(n_users, np.int64)
            ud[:mu] = self.user_degrees[:mu]
            mi = min(n_items, len(self.item_degrees))
            id_ = np.zeros(n_items, np.int64)
            id_[:mi] = self.item_degrees[:mi]
        return build_both_sides(
            inter.user_idx, inter.item_idx, inter.values, n_users, n_items,
            max_width=max_width, row_multiple=row_multiple,
            split_row_multiple=split_row_multiple,
            user_degrees=ud, item_degrees=id_, on_side=on_side)


def latest_wins(users, items, n_items: int, device) -> np.ndarray:
    """Positions of the triples to keep when (user, item) pairs repeat:
    the last occurrence of each pair, in ascending position (int64). The
    same rows in the same order as the JAX preparator's ``np.unique`` over
    packed keys (models/recommendation/engine.py ``_prepare_columnar``),
    computed on ``device``: a stable sort of the packed keys puts each
    pair's occurrences in position order, so the last of each run is the
    one kept. Only the kept positions come back to the host."""
    n = len(users)
    if n == 0:
        return np.empty(0, np.int64)
    u = torch.from_numpy(np.ascontiguousarray(users, np.int32)).to(device)
    i = torch.from_numpy(np.ascontiguousarray(items, np.int32)).to(device)
    keys = u.long() * max(int(n_items), 1) + i.long()
    del u, i
    sorted_keys, order = torch.sort(keys, stable=True)
    del keys
    last = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    last[:-1] = sorted_keys[1:] != sorted_keys[:-1]
    keep, _ = torch.sort(order[last])
    return keep.cpu().numpy()
