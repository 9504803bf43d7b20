"""Full-catalogue scoring and top-k with exclusions.

Port of incubator_predictionio_tpu/ops/topk.py. A query scores the whole
item table and ranks it without leaving the device; seen or filtered items
are masked before ranking. Results keep the packed form of the reference:
``[2, k]`` (or ``[2, B_pad, k_pad]``) float32, row 0 the scores and row 1
the item ids as floats (exact below 2**24 items), so a caller pays one
device-to-host copy per query.

Each entry first asks ``ops/mips.route`` whether a two-stage MIPS index
registered for the item table should serve the query (coarse bucket scan
+ exact rerank, ops/mips.py, as in the reference); it answers in the same
packed form, on the table's device. Otherwise every query with ``k <= 128``
goes through the hand-written kernel (ops/kernels.py), whatever the
catalogue size, and rows the speed overlay published into an index's
exact tail are merged into its answer. ``k > 128`` is the counterpart of
the reference's XLA path: one matmul and a stable sort, counted apart.
Sharded top-k is not ported (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.obs import profile as _profile
from incubator_predictionio_tpu_torch.ops import kernels
from incubator_predictionio_tpu_torch.ops import mips as _mips
from incubator_predictionio_tpu_torch.ops.kernels import NEG_INF

#: calls that took the matmul + sort route (k > 128)
WIDE_TOPK_CALLS = runtime.LaunchCounter("score_topk_wide")

#: distinct (B, k, items, rank) shapes dispatched by :func:`_score_top_k`
#: (``score_and_top_k``'s single rows and ``batch_score_top_k``'s padded
#: batches): the counterpart of the reference's jit cache size
_SHAPES: set = set()
_SHAPES_LOCK = threading.Lock()


def serve_compile_cache_size() -> int:
    """Distinct serving-dispatch shapes this process has run — the
    scheduler's ``pio_serve_compile_cache_size`` (the counterpart of the
    reference's count of compiled serving variants, and the serving twin
    of ``speed.foldin.foldin_compile_cache_size``). Bounded by the pow2
    ladder × the distinct (k, catalogue) shapes served; a warm ladder
    stops growing it. The two-stage route's shapes count too."""
    with _SHAPES_LOCK:
        return len(_SHAPES) + _mips.mips_compile_cache_size()


def top_k_with_exclusions(
    scores: torch.Tensor,                    # [I] f32
    k: int,
    exclude: Optional[torch.Tensor] = None,  # [E] item ids, -1 = no-op
    allowed_mask: Optional[torch.Tensor] = None,  # [I] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top_scores[k], top_indices[k]) of a score vector, descending with
    ties to the lowest id; masked and excluded items score ``NEG_INF``."""
    allowed = _allowed(scores.shape[0], scores.device, exclude, allowed_mask,
                       None)
    if allowed is not None:
        scores = scores.masked_fill(~allowed, NEG_INF)
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    return top_s[:k], top_i[:k]


def _fold_valid_mask(allowed_mask: Optional[torch.Tensor], n_items: int,
                     valid_items: Optional[int], device: torch.device
                     ) -> Optional[torch.Tensor]:
    """Fold a ``valid_items`` bound into the allowed mask: rows at or past
    it (a padded table's zero-factor tail) are never served."""
    if valid_items is None or valid_items >= n_items:
        return allowed_mask
    vm = torch.arange(n_items, device=device) < valid_items
    if allowed_mask is None:
        return vm
    return allowed_mask.bool() & vm


def _allowed(n_items: int, device: torch.device,
             exclude: Optional[torch.Tensor],
             allowed_mask: Optional[torch.Tensor],
             valid_items: Optional[int]) -> Optional[torch.Tensor]:
    """One [I] bool mask from a mask, a ``valid_items`` bound and an
    exclusion list. Negative and out-of-range exclusion ids are dropped
    (the reference's ``mode="drop"``): torch indexing would wrap a
    negative id, so they are sent to a spare slot past the end, which
    also keeps the fill free of a host sync."""
    if allowed_mask is not None:
        allowed_mask = allowed_mask.to(device=device, dtype=torch.bool)
    mask = _fold_valid_mask(allowed_mask, n_items, valid_items, device)
    if exclude is None:
        return mask
    ex = exclude.to(device=device, dtype=torch.long)
    safe = torch.where((ex >= 0) & (ex < n_items), ex,
                       torch.full_like(ex, n_items))
    keep = torch.ones(n_items + 1, dtype=torch.bool, device=device)
    keep.index_fill_(0, safe, False)
    keep = keep[:n_items]
    return keep if mask is None else keep & mask


def _score_top_k(queries: torch.Tensor, items: torch.Tensor, k: int,
                 allowed: Optional[torch.Tensor]) -> torch.Tensor:
    """Packed [2, B, k] for a batch of query rows: the kernel for
    ``k <= 128``, else one matmul and a stable sort."""
    with _SHAPES_LOCK:
        _SHAPES.add((queries.shape[0], int(k), items.shape[0],
                     items.shape[1]))
    if k <= kernels.MAX_K:
        top_s, top_i = kernels.score_topk(queries, items, allowed, k)
    else:
        if queries.device.type == "cuda":
            WIDE_TOPK_CALLS.add()
        top_s, top_i = kernels.score_topk_plain(queries, items, allowed, k)
    return torch.stack([top_s, top_i.to(torch.float32)])


def _exhaustive_top_k(user_vector: torch.Tensor, item_factors: torch.Tensor,
                      k: int, exclude: Optional[torch.Tensor],
                      allowed_mask: Optional[torch.Tensor],
                      valid_items: Optional[int]) -> torch.Tensor:
    """The exhaustive route of one query vector, packed [2, k], with the
    published tail of a registered index merged in. A filtered query
    skips the merge: a virtual id cannot honor an item mask."""
    n_items = item_factors.shape[0]
    _mips.book_exhaustive(n_items)
    allowed = _allowed(n_items, item_factors.device, exclude, allowed_mask,
                       valid_items)
    q = user_vector.reshape(1, -1).to(item_factors.dtype).contiguous()
    _pt0 = _profile.t0()  # None on the PIO_PROFILE=0 default hot path
    out = _score_top_k(q, item_factors, min(int(k), n_items), allowed)[:, 0]
    _profile.record(_pt0, "serve", "serve_topk",
                    2.0 * n_items * item_factors.shape[1], out)
    if allowed_mask is not None:
        return out
    return _mips.merge_published_fallback(
        item_factors, out,
        lambda: user_vector.detach().to("cpu", torch.float32).numpy(),
        out.shape[-1], exclude)


def score_and_top_k(
    user_vector: torch.Tensor,               # [K]
    item_factors: torch.Tensor,              # [I, K]
    k: int,
    exclude: Optional[torch.Tensor] = None,
    allowed_mask: Optional[torch.Tensor] = None,
    valid_items: Optional[int] = None,
) -> torch.Tensor:
    """Full-catalogue scoring and ranking of one query vector, packed
    [2, k] f32 (the two-stage route when an index serves the table).
    ``valid_items`` masks a padded table's tail."""
    index = _mips.route(item_factors, k=k, allowed_mask=allowed_mask,
                        exclude=exclude)
    if index is not None:
        return _mips.mips_score_and_top_k(user_vector, item_factors, index,
                                          k, exclude=exclude)
    return _exhaustive_top_k(user_vector, item_factors, k, exclude,
                             allowed_mask, valid_items)


def score_user_and_top_k(
    user_factors: torch.Tensor,              # [U, K]
    item_factors: torch.Tensor,              # [I, K]
    user_idx: int,
    k: int,
    exclude: Optional[torch.Tensor] = None,
    allowed_mask: Optional[torch.Tensor] = None,
    valid_items: Optional[int] = None,
) -> torch.Tensor:
    """Serving path of one known user: the row gather, full-catalogue
    scoring and top-k (or the two-stage route), packed [2, k] f32."""
    index = _mips.route(item_factors, k=k, allowed_mask=allowed_mask,
                        exclude=exclude)
    if index is not None:
        return _mips.mips_score_user_and_top_k(
            user_factors, item_factors, index, int(user_idx), k,
            exclude=exclude)
    return _exhaustive_top_k(user_factors[int(user_idx)], item_factors, k,
                             exclude, allowed_mask, valid_items)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1): the padding rule of the batched
    dispatch."""
    return 1 << max(int(n) - 1, 0).bit_length()


def pad_exclude(ids: Sequence[int], device=None) -> Optional[torch.Tensor]:
    """Exclusion ids as a power-of-two padded int32 tensor on ``device``
    (-1 = no-op slots), or None for an empty list."""
    ids = list(ids)
    if not ids:
        return None
    out = np.full(next_pow2(len(ids)), -1, np.int32)
    out[:len(ids)] = ids
    return torch.from_numpy(out).to(runtime.default_device(device))


def ladder_rungs(cap: int) -> Tuple[int, ...]:
    """The power-of-two batch widths up to ``cap``: the shapes
    :func:`batch_score_top_k` can dispatch."""
    cap = next_pow2(max(int(cap), 1))
    return tuple(1 << i for i in range(cap.bit_length()))


def batch_score_top_k(
    user_factors: torch.Tensor,
    item_factors: torch.Tensor,
    rows,                                    # [B] user indices
    k: int,
    valid_items: Optional[int] = None,
) -> torch.Tensor:
    """Score B users against the whole catalogue and rank, in one
    dispatch: packed [2, B_pad, k_pad] f32. ``rows`` pads to the next
    power of two with row 0 repeated and ``k`` to the next power of two
    capped at the catalogue, as in the reference; callers slice row b to
    their own ``num``. An empty batch gives [2, 0, k_pad]."""
    n_items = item_factors.shape[0]
    k_pad = min(next_pow2(int(k)), n_items)
    dev = item_factors.device
    b = len(rows)
    if b == 0:
        return torch.zeros((2, 0, k_pad), dtype=torch.float32, device=dev)
    rows_np = np.asarray(rows, np.int64).reshape(b)
    pad = next_pow2(b)
    if pad > b:
        rows_np = np.concatenate([rows_np, np.full(pad - b, rows_np[0])])
    # the scheduler's fused dispatch rides the same two-stage route as
    # the per-query entries
    index = _mips.route(item_factors, k=k_pad)
    if index is not None:
        return _mips.mips_batch_score_top_k(user_factors, item_factors,
                                            index, rows_np, k_pad)
    _mips.book_exhaustive(pad * n_items)
    idx = torch.from_numpy(rows_np).to(user_factors.device)
    queries = user_factors.index_select(0, idx).to(item_factors.dtype)
    allowed = _fold_valid_mask(None, n_items, valid_items, dev)
    _pt0 = _profile.t0()  # None on the PIO_PROFILE=0 default hot path
    out = _score_top_k(queries.contiguous(), item_factors, k_pad, allowed)
    _profile.record(_pt0, "serve", "serve_topk_batch",
                    2.0 * b * user_factors.shape[1] * n_items, out)
    return _mips.merge_published_fallback(
        item_factors, out,
        lambda: queries.detach().to("cpu", torch.float32).numpy(), k_pad,
        None)
