"""Item-item cosine column similarities — the DIMSUM-variant solver.

Port of incubator_predictionio_tpu/ops/dimsum.py. The reference's
similarproduct-dimsum template calls ``RowMatrix.columnSimilarities
(threshold)`` (examples/experimental/scala-parallel-similarproduct-dimsum/
src/main/scala/DIMSUMAlgorithm.scala:133), Spark's sampling
approximation of the item-item cosine matrix. Both packages compute it
exactly: users packed into chunks of 2,048 distinct users, each chunk's
triples scattered into a dense ``[2048, I]`` block and ``blockᵀ·block``
accumulated into the ``[I, I]`` Gram, then cosine normalization, the
threshold (exact, where DIMSUM's is probabilistic), a zeroed diagonal and
a per-row top-N. No Pallas kernel stands behind it in the JAX package
(XLA computes the Gram and ``lax.top_k``), so here the Gram is
``torch.matmul`` on ``device`` (CUDA by default) and the top-N a sort.

Ties: a row with fewer than ``top_n`` neighbours above the threshold is
padded with score-0 entries. ``lax.top_k`` orders equal scores by the
lowest index, and ``torch.topk`` gives no order among ties, so the top-N
is a stable descending sort, whose indices equal the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch.runtime import default_device

#: dense [I, I] similarity ceiling: above this the Gram no longer fits
#: comfortably (16k² f32 = 1 GB) and the ALS-factor variant is the right
#: tool anyway — this solver targets the template's catalogue scale
MAX_ITEMS = 16384

_CHUNK_ROWS = 2048
#: rows of the similarity matrix sorted at once (bounds the sort's
#: buffers to ``_SORT_ROWS × I`` values and int64 indices)
_SORT_ROWS = 2048


def _chunks(users: np.ndarray, items: np.ndarray, weights: np.ndarray):
    """Yield (row-in-chunk, item, weight) arrays, one per chunk of
    ``_CHUNK_ROWS`` distinct users in user order (JAX :84-104)."""
    order = np.argsort(users, kind="stable")
    users, items, weights = users[order], items[order], weights[order]
    _, user_dense = np.unique(users, return_inverse=True)
    chunk_of = user_dense // _CHUNK_ROWS
    row_in_chunk = user_dense % _CHUNK_ROWS
    n_chunks = int(chunk_of.max()) + 1 if len(users) else 0
    starts = np.zeros(n_chunks + 1, np.int64)
    np.cumsum(np.bincount(chunk_of, minlength=n_chunks), out=starts[1:])
    for c in range(n_chunks):
        lo, hi = starts[c], starts[c + 1]
        yield row_in_chunk[lo:hi], items[lo:hi], weights[lo:hi]


def gram(users: np.ndarray, items: np.ndarray, weights: np.ndarray,
         n_items: int, device=None) -> torch.Tensor:
    """The ``[I, I]`` f32 Gram ``Σ_chunks blockᵀ·block`` of the weighted
    user × item matrix on ``device``; repeated (user, item) pairs add."""
    dev = default_device(device)
    g = torch.zeros((n_items, n_items), dtype=torch.float32, device=dev)
    block = torch.empty((_CHUNK_ROWS, n_items), dtype=torch.float32,
                        device=dev)
    for rows, cols, vals in _chunks(np.asarray(users, np.int64),
                                    np.asarray(items, np.int64),
                                    np.asarray(weights, np.float32)):
        block.zero_()
        block.index_put_((torch.from_numpy(rows).to(dev),
                          torch.from_numpy(cols).to(dev)),
                         torch.from_numpy(vals).to(dev), accumulate=True)
        g.addmm_(block.T, block)
    return g


def cosine_topk(g: torch.Tensor, threshold: float, top_n: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine from the Gram, thresholded, diagonal zeroed, and the top
    ``top_n`` of each row by a stable descending sort (ties to the lowest
    index): ``(scores [I, T] f32, indices [I, T] int32)``."""
    n = g.shape[0]
    t = min(int(top_n), n)
    norms = torch.sqrt(torch.clamp(torch.diagonal(g), min=1e-12))
    scores = torch.empty((n, t), dtype=torch.float32, device=g.device)
    indices = torch.empty((n, t), dtype=torch.int32, device=g.device)
    for lo in range(0, n, _SORT_ROWS):
        hi = min(lo + _SORT_ROWS, n)
        sim = g[lo:hi] / (norms[lo:hi, None] * norms[None, :])
        sim = torch.where(sim >= threshold, sim, torch.zeros_like(sim))
        rows = torch.arange(lo, hi, device=g.device)
        sim[rows - lo, rows] = 0.0  # no self-similarity
        s, i = torch.sort(sim, dim=1, descending=True, stable=True)
        scores[lo:hi] = s[:, :t]
        indices[lo:hi] = i[:, :t].to(torch.int32)
    return scores, indices


def column_cosine_topk(
    users: np.ndarray,
    items: np.ndarray,
    weights: np.ndarray,
    n_items: int,
    threshold: float = 0.1,
    top_n: int = 100,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """→ (scores [I, T], indices [I, T]) as host numpy: per-item top-T
    cosine neighbours with similarity ≥ threshold (0-padded; an index
    whose score is 0 is absent), computed on ``device`` (CUDA unless the
    caller passes another). Exact where the reference's DIMSUM samples."""
    if n_items > MAX_ITEMS:
        raise ValueError(
            f"dimsum similarity targets catalogs ≤ {MAX_ITEMS} items "
            f"(got {n_items}); use the ALS similarproduct algorithm for "
            "larger catalogs")
    g = gram(users, items, weights, n_items, device)
    scores, indices = cosine_topk(g, float(threshold), int(top_n))
    return scores.cpu().numpy(), indices.cpu().numpy()
