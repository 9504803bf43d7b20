"""SimRank on the device: the port of incubator_predictionio_tpu/ops/
simrank.py, the friend-recommendation template's graph similarity.

The reference's parallel friend-recommendation template computes SimRank
by delta propagation over RDD pairs (examples/experimental/
scala-parallel-friend-recommendation/DeltaSimRankRDD.scala). Both packages
compute the recurrence exactly as two dense products a step:

    S ← C · (Wᵀ S) W,   diag(S) ← 1

with ``W`` the column-normalized in-neighbour adjacency. No Pallas kernel
stands behind it in the JAX package (XLA computes the products), so here
they are ``torch.matmul`` on the device, in the JAX package's order,
``(Wᵀ S) W``, so that f32 rounding follows it; on the card the caller
keeps TF32 off for the same reason. The adjacency is built on the device
from the edge list (``index_put_``: a repeated edge sets 1.0 again, as
``adj[src, dst] = 1.0`` does), never as a host array. The result comes
back to the host as numpy, as the JAX package's does: the template's
answers read it there.
"""

from __future__ import annotations

import numpy as np
import torch

from incubator_predictionio_tpu_torch.runtime import default_device

#: dense [N, N] similarity ceiling (the same as ops/dimsum.MAX_ITEMS)
MAX_NODES = 16384


def normalized_adjacency(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                         device=None, dtype=torch.float32) -> torch.Tensor:
    """``W``: the [N, N] 0/1 adjacency of the edges (src → dst) on
    ``device`` (CUDA unless the caller passes another), each column
    divided by its in-degree (at least 1)."""
    dev = default_device(device)
    adj = torch.zeros((n_nodes, n_nodes), dtype=dtype, device=dev)
    adj.index_put_((torch.as_tensor(np.asarray(src, np.int64), device=dev),
                    torch.as_tensor(np.asarray(dst, np.int64), device=dev)),
                   torch.ones((), dtype=dtype, device=dev))
    in_deg = adj.sum(dim=0)
    return adj.div_(torch.clamp(in_deg, min=1.0)[None, :])


def simrank_iterate(w_norm: torch.Tensor, decay: float,
                    iterations: int) -> torch.Tensor:
    """``iterations`` steps of ``S ← decay · (Wᵀ S) W`` with the diagonal
    set to 1, from the identity, in ``w_norm``'s dtype and on its
    device."""
    s = torch.eye(w_norm.shape[0], dtype=w_norm.dtype, device=w_norm.device)
    for _ in range(iterations):
        s = torch.matmul(torch.matmul(w_norm.T, s), w_norm).mul_(decay)
        # the fix-point constraint s(a, a) = 1
        s.fill_diagonal_(1.0)
    return s


def simrank(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    decay: float = 0.8,
    iterations: int = 7,
    device=None,
) -> np.ndarray:
    """SimRank similarity matrix [N, N] (host numpy, f32) of a directed
    edge list, computed on ``device`` (CUDA unless the caller passes
    another).

    ``decay`` is the reference's 0.8 (DeltaSimRankRDD.scala:31);
    ``iterations`` the usual budget (SimRank converges geometrically in
    ``decay^k``)."""
    if n_nodes > MAX_NODES:
        raise ValueError(
            f"dense SimRank targets graphs ≤ {MAX_NODES} nodes "
            f"(got {n_nodes})")
    w_norm = normalized_adjacency(src, dst, n_nodes, device)
    return simrank_iterate(w_norm, float(decay), int(iterations)).cpu().numpy()
