"""Hand-written CUDA kernels of the serving path, with their plain versions.

``score_topk`` replaces the TPU kernel ``score_and_top_k_pallas``
(incubator_predictionio_tpu/ops/pallas_kernels.py:317, body
``_topk_tile_kernel`` :186): exhaustive f32 scoring of a batch of query
vectors against the item table, the serve-time allow mask applied in the
kernel, and a top-k per query with ties to the lowest item id. Its source is
``csrc/score_topk.cu``, which says what bounds it on the card (the item
table read at one query, f32 FMAs at 64) and what its design does about
that (the [B, I] score matrix never reaches device memory).

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs :func:`score_topk_plain`, which the CPU tests use and the
chip smoke compares the kernel with.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from incubator_predictionio_tpu_torch import runtime

#: score of a disallowed item, and of a filler slot (pallas_kernels.py:52)
NEG_INF = -3.4e38
#: most slots the kernel keeps per query (the TPU kernel's 128 lanes)
MAX_K = 128
#: the TPU kernel this module's kernel replaces
REPLACES = "incubator_predictionio_tpu/ops/pallas_kernels.py:317"

SCORE_TOPK_LAUNCHES = runtime.LaunchCounter("score_topk")


def score_topk_plain(queries: torch.Tensor, items: torch.Tensor,
                     allowed: Optional[torch.Tensor], k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`score_topk`: ``queries @ items.T``,
    disallowed items set to ``NEG_INF``, then a stable descending sort,
    which puts ties in id order (``torch.topk`` orders no ties). Slots at
    or below ``NEG_INF / 2`` come back as (``NEG_INF``, -1)."""
    scores = queries @ items.T
    if allowed is not None:
        scores = scores.masked_fill(~allowed.bool()[None, :], NEG_INF)
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k].to(torch.int32)
    filler = top_s <= NEG_INF / 2
    return (top_s.masked_fill(filler, NEG_INF),
            top_i.masked_fill(filler, -1))


def score_topk(queries: torch.Tensor, items: torch.Tensor,
               allowed: Optional[torch.Tensor], k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores ``queries`` [B, K] against ``items`` [I, K] and returns the
    top ``k`` ≤ 128 per row as (scores [B, k] f32, ids [B, k] i32),
    descending with ties to the lowest id; ``allowed`` [I] (bool or
    uint8, None = all) masks items out. Fewer than ``k`` allowed items
    leave (``NEG_INF``, -1) fillers at the end."""
    if not 0 < k <= min(MAX_K, items.shape[0]):
        raise ValueError(f"k={k} must lie in [1, min(128, {items.shape[0]})]")
    if queries.device.type == "cpu" and items.device.type == "cpu":
        return score_topk_plain(queries, items, allowed, k)
    return _launch(queries, items, allowed, k)


def _launch(queries, items, allowed, k):
    dev = items.device
    if dev.type != "cuda" or queries.device != dev or (
            allowed is not None and allowed.device != dev):
        raise ValueError("score_topk: queries, items and allowed must lie "
                         f"on one CUDA device (got {queries.device}, {dev}, "
                         f"{None if allowed is None else allowed.device})")
    if queries.dtype != torch.float32 or items.dtype != torch.float32:
        raise TypeError("score_topk takes float32 queries and items")
    if queries.dim() != 2 or items.dim() != 2 \
            or queries.shape[1] != items.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} and "
                         f"{tuple(items.shape)} do not match")
    if not (queries.is_contiguous() and items.is_contiguous()):
        raise ValueError("score_topk takes contiguous queries and items")
    b, rank = queries.shape
    n_items = items.shape[0]
    if rank > 256:
        raise ValueError(f"score_topk takes rank <= 256, got {rank}")
    if allowed is not None:
        if allowed.shape != (n_items,):
            raise ValueError(f"allowed must be [{n_items}], got "
                             f"{tuple(allowed.shape)}")
        allowed = (allowed.view(torch.uint8) if allowed.dtype == torch.bool
                   else allowed.to(torch.uint8)).contiguous()
    lib = runtime.build_kernels()
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    work = torch.empty(lib.pio_score_topk_workspace_bytes(b, n_items, k),
                       dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pio_score_topk(
            queries.data_ptr(), items.data_ptr(),
            None if allowed is None else allowed.data_ptr(),
            b, n_items, rank, k, out_s.data_ptr(), out_i.data_ptr(),
            work.data_ptr(), stream)
    runtime.check_launch(rc, "score_topk")
    SCORE_TOPK_LAUNCHES.add()
    return out_s, out_i
