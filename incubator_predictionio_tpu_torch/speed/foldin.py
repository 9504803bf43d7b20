"""Batched fold-in: solve factor rows against a frozen factor table.

Port of incubator_predictionio_tpu/speed/foldin.py. For a user (or item)
with events newer than the deployed instance, the answer training would
have given its row is one regularized least-squares solve against the
OTHER side's frozen factor table: the per-row normal equation every ALS
sweep solves. Each ladder bucket goes through the fused gather + Gram +
CG entry training uses (``ops/als_kernels.als_fused_solve_cg``, the
counterpart of the JAX ``_solve_rows_kernel``, :104-127): on CUDA tensors
the hand-written kernel, on CPU tensors its plain version. There is no
second route: the JAX XLA route exists only for a failed Mosaic probe,
and the port has no probe. The fused entry runs CG whatever
``PIO_ALS_SOLVER`` says, as the JAX kernel route does.

Shape discipline: pending rows are padded onto a fixed ladder of bucket
widths × power-of-two batch sizes, so the shapes a solve dispatches are
bounded by the ladder whatever the traffic (``foldin_compile_cache_size``
counts the distinct ones). Histories longer than the widest bucket keep
their most recent entries.

Not ported: the ``obs/profile`` attribution of each dispatch
(ROADMAP.md Queue 1 item 8) and the mesh-sharded frozen table (item 9).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.ops import als as _als
from incubator_predictionio_tpu_torch.ops import als_kernels


def foldin_flops(degrees: Sequence[int], rank: int,
                 cg_iters: int) -> float:
    """Analytic useful FLOPs of one fold-in bucket dispatch: per row of
    degree d the Gram assembly is 4·d·K² + rhs 2·d·K, plus the CG solve
    ~iters·2·K² per row — the same counting convention as
    ``ops.als.train_flops`` (padding waste never counts as work)."""
    k = float(rank)
    d = float(sum(int(x) for x in degrees))
    return 4.0 * d * k * k + 2.0 * d * k \
        + len(degrees) * cg_iters * 2.0 * k * k


def _width_ladder() -> Tuple[int, ...]:
    """Fixed bucket widths (ascending), ``PIO_SPEED_WIDTHS``. Read per
    call so tests and operators can override it at runtime."""
    raw = os.environ.get("PIO_SPEED_WIDTHS", "8,32,128,512")
    widths = sorted({max(int(w), 1) for w in raw.split(",") if w.strip()})
    return tuple(widths) or (8, 32, 128, 512)


def max_batch() -> int:
    """Largest rows-per-dispatch bucket (power of two),
    ``PIO_SPEED_MAX_BATCH``. The overlay's adaptive fold-in budget
    (speed/overlay.py) sizes its per-poll rungs in multiples of this."""
    try:
        n = int(os.environ.get("PIO_SPEED_MAX_BATCH", "64"))
    except ValueError:
        n = 64
    return 1 << max(n - 1, 0).bit_length()


#: every (width, padded batch, implicit) shape dispatched in this process
_SHAPES: set = set()
_SHAPES_LOCK = threading.Lock()


def foldin_compile_cache_size() -> int:
    """Number of distinct ``(width, padded batch, implicit)`` shapes the
    fold-in has dispatched in this process — the counterpart of the JAX
    package's compiled-variant count. Bounded by the ladder; tests
    assert it stops growing once the ladder is warm."""
    with _SHAPES_LOCK:
        return len(_SHAPES)


class FoldInSolver:
    """Batched fold-in against one frozen factor table.

    ``other_factors`` [M, K]: a tensor stays on its device (the deployed
    model's table, with no host round trip); anything else goes to
    ``runtime.default_device(device)`` — CUDA unless ``device="cpu"``,
    raising without CUDA. ``rows`` of :meth:`solve` are (cols, vals)
    int32/float32 pairs indexed into that table.
    """

    def __init__(
        self,
        other_factors: Any,
        l2: float,
        reg_nnz: bool = True,
        implicit: bool = False,
        alpha: float = 1.0,
        cg_iters: Optional[int] = None,
        device=None,
    ) -> None:
        if isinstance(other_factors, torch.Tensor):
            table = (other_factors if device is None
                     else other_factors.to(torch.device(device)))
        else:
            table = torch.from_numpy(np.ascontiguousarray(
                other_factors, np.float32)).to(
                    runtime.default_device(device))
        self.other_factors = table.to(torch.float32).contiguous()
        self.device = self.other_factors.device
        self.rank = int(self.other_factors.shape[1])
        self.l2 = float(l2)
        self.reg_nnz = bool(reg_nnz)
        self.implicit = bool(implicit)
        self.alpha = float(alpha)
        self.cg_iters = int(cg_iters if cg_iters is not None
                            else _als.CG_ITERS)
        #: the batch-shared YᵀY of implicit ALS, computed once per solver
        #: (it depends only on the frozen table)
        self._yty = (_als._gram_all(self.other_factors)
                     if self.implicit else None)

    @staticmethod
    def _bucket_width(degree: int, widths: Sequence[int]) -> int:
        for w in widths:
            if degree <= w:
                return w
        return widths[-1]

    def _dispatch(self, cols: np.ndarray, vals: np.ndarray,
                  mask: np.ndarray) -> torch.Tensor:
        """One ladder bucket through the fused entry → [B, K] f32 on the
        table's device."""
        dev = self.device
        with _SHAPES_LOCK:
            _SHAPES.add((cols.shape[1], cols.shape[0], self.implicit))
        return als_kernels.als_fused_solve_cg(
            self.other_factors, torch.from_numpy(cols).to(dev),
            torch.from_numpy(vals).to(dev), torch.from_numpy(mask).to(dev),
            self.l2, reg_nnz=self.reg_nnz,
            iters=self.cg_iters * (2 if self.implicit else 1),
            implicit=self.implicit, alpha=self.alpha, yty=self._yty)

    def solve(
        self, rows: Sequence[Tuple[np.ndarray, np.ndarray]]
    ) -> np.ndarray:
        """Fold in a batch of keys → [len(rows), K] f32 (in input order).

        Empty histories solve to the zero vector (the cold-start fixed
        point); histories wider than the ladder keep their most RECENT
        ``widths[-1]`` interactions (callers pass history oldest-first).
        """
        n = len(rows)
        out = np.zeros((n, self.rank), np.float32)
        if n == 0:
            return out
        widths = _width_ladder()
        max_b = max_batch()
        by_width: dict = {}
        for slot, (cols, vals) in enumerate(rows):
            cols = np.asarray(cols, np.int32).reshape(-1)
            vals = np.asarray(vals, np.float32).reshape(-1)
            d = int(cols.shape[0])
            if d == 0:
                continue
            cap = widths[-1]
            if d > cap:  # keep the newest interactions
                cols, vals, d = cols[-cap:], vals[-cap:], cap
            by_width.setdefault(self._bucket_width(d, widths), []).append(
                (slot, cols, vals))
        slots, sols = [], []
        for width, members in sorted(by_width.items()):
            for s in range(0, len(members), max_b):
                chunk = members[s:s + max_b]
                b = len(chunk)
                b_pad = min(1 << max(b - 1, 0).bit_length(), max_b)
                cols = np.zeros((b_pad, width), np.int32)
                vals = np.zeros((b_pad, width), np.float32)
                mask = np.zeros((b_pad, width), np.float32)
                for r, (_slot, c, v) in enumerate(chunk):
                    cols[r, :len(c)] = c
                    vals[r, :len(v)] = v
                    mask[r, :len(c)] = 1.0
                sols.append(self._dispatch(cols, vals, mask)[:b])
                slots.extend(slot for slot, _c, _v in chunk)
        if sols:
            # one device-to-host copy for every bucket of the call
            out[np.asarray(slots)] = torch.cat(sols).cpu().numpy()
        return out

    def warmup(self) -> None:
        """One dispatch per ladder width at batch size 1 (the trickle
        shape), so the first live fold-in finds the kernels built and
        loaded."""
        for width in _width_ladder():
            # degree == width so each solve lands in ITS bucket
            self.solve([(np.zeros(width, np.int32),
                         np.ones(width, np.float32))])


def dense_reference_solve(
    other_factors: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    l2: float,
    reg_nnz: bool = True,
    implicit: bool = False,
    alpha: float = 1.0,
) -> np.ndarray:
    """Dense numpy least-squares reference for ONE row (a copy of the
    JAX package's) — the differential oracle of the fold-in tests.

    Explicit: (XᵀX + λ·nnz·I) w = Xᵀy. Implicit (Hu-Koren-Volinsky with
    binary preference): (YᵗY + Yᵤᵗ(Cᵤ−I)Yᵤ + λI) w = Yᵤᵗcᵤ, c = 1+αr.
    """
    other = np.asarray(other_factors, np.float64)
    x = other[np.asarray(cols, np.int64)]
    y = np.asarray(vals, np.float64)
    k = other.shape[1]
    if implicit:
        conf = 1.0 + alpha * y
        a = other.T @ other + x.T @ np.diag(conf - 1.0) @ x \
            + l2 * np.eye(k)
        b = x.T @ conf
    else:
        lam = l2 * (max(len(y), 1) if reg_nnz else 1.0)
        a = x.T @ x + lam * np.eye(k)
        b = x.T @ y
    return np.linalg.solve(a, b).astype(np.float32)
