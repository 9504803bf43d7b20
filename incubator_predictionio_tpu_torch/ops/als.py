"""Alternating least squares on one CUDA device: the port of
incubator_predictionio_tpu/ops/als.py (single-device training).

Each half-sweep solves every row of one side against the other side's
factors, bucket by bucket (ops/sparse.py), on a hand-written kernel
(ops/als_kernels.py) chosen by width and rank (``_route``, measured on
the H100): explicit buckets up to ``ROWS_MAX_D`` on the two-stage
kernel's R-row form where it takes the rank, the others on the fused
gather entry; every implicit bucket on the fused entry, the one that
carries the shared YᵀY term. The split (heavy) rows are assembled with
plain PyTorch (gather → batched Gram → CG), as the JAX package assembles
them with XLA outside any Pallas kernel. Factors are dense f32 tensors;
the ``bf16_sweeps`` early sweeps gather from a bf16 copy of the table and
run a loose CG, then f32 sweeps polish (``_mixed_run``).

``use_kernel=False`` is the JAX package's XLA route, all in PyTorch: the
chip smoke trains through it as the plain route of the whole training.

Every sweep loop runs through :func:`_als_run_converge`: a fixed budget
(``_mixed_run``, ``als_train``, ``als_train_implicit``) or the
convergence early stop of the continuation retrain (ops/retrain.py).
Where JAX judges the relative factor delta inside a ``lax.while_loop``,
the port computes it on the device after a sweep whose delta decides
the next one, and reads that one scalar on the host.

Knobs, read per call: ``PIO_ALS_SOLVER`` ("cg", the default, or
"cholesky": ``torch.linalg.cholesky`` / ``cholesky_solve``, and then
every bucket takes the plain route, as the JAX package's kernels take
only CG) and ``PIO_ALS_CG_TOL`` (the CG's residual early exit on the
plain route and the split rows; 0, the default, is the fixed budget).

Not ported: the sharded trainer (``als_train_placed`` :1566, ROADMAP
Queue 1 item 9) and the ``PIO_PROFILE`` device-time attribution.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch.ops import als_kernels
from incubator_predictionio_tpu_torch.ops.sparse import (
    HeavySegments,
    PaddedRows,
    build_both_sides,
)
from incubator_predictionio_tpu_torch.runtime import default_device

#: CG steps of an f32 sweep (als.py:196)
CG_ITERS = 16
#: warm-start every bucket CG from the previous sweep's factors (als.py:220)
CG_WARMSTART = True
#: CG steps of a bf16 sweep: 3 with warm start, 6 cold (als.py:339)
CG_ITERS_BF16 = 3 if CG_WARMSTART else 6
# Every bucket goes to a kernel: the JAX package's narrowest kernel-routed
# width, 64 (als.py:212), was a TPU measure (its Pallas kernel padded every
# row to 128 lanes). On the H100 every kernel entry beats the plain route
# on every bucket of width 8 to 64, 5.5-41x (the narrow-bucket cell of
# ``chip_smoke.py --als``, PERF.md §6).
#: rows per block of the two-stage kernel (1 or 8): 8, the R-row form
KERNEL_ROWS = 8
#: widest bucket routed to the two-stage kernel's R-row form whatever the
#: side (where the form takes the rank: up to 128); wider buckets, and
#: every bucket above rank 128, take the fused entry. In the same cell
#: R = 8 solves a whole bucket of width 8-32 1.3-7.5x faster than the
#: fused entry (level with it on a bucket of 48 rows), and loses to it at 64
ROWS_MAX_D = 32
#: element budget of one chunk's [rows, D, K] gather (als.py:602, 64 MB f32)
CHUNK_ELEMS = 1 << 24


def _solver() -> str:
    """``PIO_ALS_SOLVER`` (als.py:195): "cg", the default, or "cholesky";
    read per call."""
    solver = os.environ.get("PIO_ALS_SOLVER") or "cg"
    if solver not in ("cg", "cholesky"):
        raise ValueError(f"PIO_ALS_SOLVER is cg or cholesky, got {solver!r}")
    return solver


def _cg_tol_env() -> float:
    """``PIO_ALS_CG_TOL`` (als.py:242): the CG's relative residual early
    exit on the plain route and the split rows; 0, the default, is the
    fixed budget. Read per call."""
    try:
        return float(os.environ.get("PIO_ALS_CG_TOL", "0") or 0.0)
    except ValueError:
        return 0.0


def _kernel_enabled() -> bool:
    """The kernels solve by CG only (als.py:262): under the Cholesky
    solver every bucket takes the plain route."""
    return _solver() == "cg"


@dataclasses.dataclass
class ALSState:
    user_factors: torch.Tensor  # [n_users, rank] f32
    item_factors: torch.Tensor  # [n_items, rank] f32


def als_init(generator: torch.Generator, n_users: int, n_items: int,
             rank: int, scale: float = 0.1, device=None) -> ALSState:
    """Gaussian factors × ``scale``, drawn from ``generator`` (a CPU
    generator gives the same state on every device) and put on ``device``
    (CUDA by default)."""
    dev = default_device(device)
    uf = scale * torch.randn((n_users, rank), generator=generator)
    vf = scale * torch.randn((n_items, rank), generator=generator)
    return ALSState(user_factors=uf.to(dev), item_factors=vf.to(dev))


def _grow_factors(prev: torch.Tensor, fresh_rows: torch.Tensor
                  ) -> torch.Tensor:
    """Prefix-copy a factor table into a larger index space: the previous
    rows verbatim (row i still names entity i), then ``fresh_rows``."""
    prev = prev.float()
    if not fresh_rows.shape[0]:
        return prev
    return torch.cat([prev, fresh_rows.to(prev.device)])


def continue_state(prev_user, prev_item, n_users: int, n_items: int,
                   seed: int = 0, scale: float = 0.1,
                   device=None) -> Optional[ALSState]:
    """Seed a retrain from a previous model's factors (als.py:93): the
    previous tables as an exact prefix of the new index space, and
    :func:`als_init`-scale Gaussian rows for the new ids only, drawn from
    a CPU generator seeded by ``seed`` (user rows, then item rows).

    ``prev_user`` / ``prev_item`` are host numpy (a decoded checkpoint)
    or tensors (an in-process model, on any device); the state is put on
    ``device`` (CUDA by default), never on the CPU in its place. None
    when the previous tables cannot be a prefix: more rows than the new
    index space, or not one rank. The caller checks the id-space prefix
    itself (``BiMap.is_index_prefix_of``)."""
    dev = default_device(device)
    pu = torch.as_tensor(prev_user)
    pi = torch.as_tensor(prev_item)
    if (pu.dim() != 2 or pi.dim() != 2 or pu.shape[1] != pi.shape[1]
            or pu.shape[0] > n_users or pi.shape[0] > n_items):
        return None
    rank = pu.shape[1]
    gen = torch.Generator().manual_seed(int(seed))
    fresh_u = scale * torch.randn((n_users - pu.shape[0], rank),
                                  generator=gen)
    fresh_i = scale * torch.randn((n_items - pi.shape[0], rank),
                                  generator=gen)
    return ALSState(user_factors=_grow_factors(pu.to(dev), fresh_u),
                    item_factors=_grow_factors(pi.to(dev), fresh_i))


def _gram_rhs_nnz(other_factors, cols, vals, mask, compute_dtype,
                  implicit: bool, alpha: float,
                  gram_dtype=torch.float32):
    """Normal-equation pieces for a batch of padded rows → (gram, rhs,
    nnz), summed in f32; explicit uses mask² == mask, implicit builds
    Yᵤᵀ(Cᵤ−I)Yᵤ with c = 1 + α·r. The gather source is cast to
    ``compute_dtype`` first (explicit only) and its values widened to f32
    for the products, so bf16 products are exact."""
    src = (other_factors
           if implicit or other_factors.dtype == compute_dtype
           else other_factors.to(compute_dtype))
    gathered = src[cols]                                  # [..., D, K]
    masked = gathered * mask[..., None].to(gathered.dtype)
    gf, mf = gathered.float(), masked.float()
    if implicit:
        conf_minus1 = alpha * vals * mask
        gram = torch.einsum("...dk,...dl->...kl",
                            conf_minus1[..., None] * mf, gf)
        rhs = torch.einsum("...d,...dk->...k", (1.0 + conf_minus1) * mask,
                           mf)
    else:
        gram = torch.einsum("...dk,...dl->...kl", mf, gf)
        rhs = torch.einsum("...d,...dk->...k",
                           (vals * mask).to(gathered.dtype).float(), mf)
    return gram.to(gram_dtype), rhs, mask.sum(-1)


def _cg_solve_spd(a, b, iters: int, matvec_dtype=torch.float32, lam=None,
                  shared=None, x0=None, tol: float = 0.0):
    """Batched Jacobi-PCG → x ≈ (a [+ shared] [+ diag(lam)])⁻¹ b, [B, K].

    ``matvec_dtype=bfloat16`` runs the matvec on a bf16 Gram and a bf16
    copy of p, summed in f32; x, r, p and every reduction stay f32.
    ``lam`` [B] applies the ridge inside the matvec in f32, ``shared``
    [K, K] adds a batch-shared term there, ``x0`` warm-starts. The
    division guards make converged and all-zero systems fixed points.
    ``tol`` > 0 stops the batch before the step at which every row's
    preconditioned residual rᵀz is at most tol²·r₀ᵀz₀ (als.py:343; the
    test is read on the host before each step, where JAX's
    ``while_loop`` reads it on the device); 0 runs ``iters`` steps."""
    diag = torch.diagonal(a, dim1=-2, dim2=-1).float()
    if shared is not None:
        diag = diag + torch.diagonal(shared)[None, :]
    if lam is not None:
        diag = diag + lam[:, None]
    minv = torch.where(diag > 0, 1.0 / diag, torch.zeros_like(diag))
    a_mv = a if a.dtype == matvec_dtype else a.to(matvec_dtype)
    a_f = a_mv.float()

    def matvec(p):
        ap = torch.bmm(a_f, p.to(a_mv.dtype).float()[:, :, None])[:, :, 0]
        if shared is not None:
            ap = ap + p @ shared.T
        if lam is not None:
            ap = ap + lam[:, None] * p
        return ap

    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x = x0.float()
        r = b - matvec(x)
    z = minv * r
    rz = (r * z).sum(-1)
    p = z
    zero = torch.zeros_like(rz)
    limit = None
    if tol > 0.0:   # tol² in f32, as the JAX package squares it
        tol2 = torch.tensor(float(tol), dtype=torch.float32) ** 2
        limit = tol2.to(rz.device) * rz
    for _ in range(int(iters)):
        if limit is not None and not bool((rz > limit).any()):
            break
        ap = matvec(p)
        pap = (p * ap).sum(-1)
        alpha = torch.where(pap > 0, rz / pap, zero)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = minv * r
        rz2 = (r * z).sum(-1)
        beta = torch.where(rz > 0, rz2 / rz, zero)
        p = z + beta[:, None] * p
        rz = rz2
    return x


def _reg_solve(gram, rhs, nnz, l2: float, reg_nnz: bool, implicit: bool,
               yty, cg_iters: int = CG_ITERS,
               cg_matvec_dtype=torch.float32, x0=None, cg_tol: float = 0.0):
    """Regularize + batched SPD solve; zero factors for empty rows.
    Explicit is MLlib's ALS-WR (λ·nnz with ``reg_nnz``); implicit keeps
    YᵀY out of the matrix and runs twice the CG budget (worse
    conditioned). Under ``PIO_ALS_SOLVER=cholesky`` the regularized f32
    systems are factored (``torch.linalg.cholesky``) and solved, as XLA's
    ``cho_factor`` / ``cho_solve`` serve the JAX package (als.py:483)."""
    if implicit:
        lam = torch.full_like(nnz, float(l2))
        shared = yty
    else:
        lam = l2 * (nnz.clamp(min=1.0) if reg_nnz else torch.ones_like(nnz))
        shared = None
    if _solver() == "cg":
        sol = _cg_solve_spd(gram, rhs, cg_iters * (2 if implicit else 1),
                            matvec_dtype=cg_matvec_dtype, lam=lam,
                            shared=shared, x0=x0, tol=cg_tol)
    else:
        rank = gram.shape[-1]
        a = gram.float() + lam[:, None, None] * torch.eye(
            rank, dtype=torch.float32, device=gram.device)
        if shared is not None:
            a = a + shared[None]
        sol = torch.cholesky_solve(rhs[..., None],
                                   torch.linalg.cholesky(a))[..., 0]
    return torch.where(nnz[:, None] > 0, sol, torch.zeros_like(sol))


def _solve_bucket(other_factors, cols, vals, mask, l2: float,
                  reg_nnz: bool = True, compute_dtype=torch.float32,
                  cg_iters: int = CG_ITERS, x0=None, cg_tol: float = 0.0):
    """Batched normal-equation solve of one degree bucket → [B, K], plain
    PyTorch. A bf16 sweep keeps its Gram batch in bf16 and runs the CG
    matvec on it, with the ridge in f32 (the Cholesky solver factors an
    f32 Gram)."""
    gram, rhs, nnz = _gram_rhs_nnz(
        other_factors, cols, vals, mask, compute_dtype, implicit=False,
        alpha=0.0, gram_dtype=(compute_dtype if _solver() == "cg"
                               else torch.float32))
    return _reg_solve(gram, rhs, nnz, l2, reg_nnz, implicit=False, yty=None,
                      cg_iters=cg_iters, cg_matvec_dtype=compute_dtype, x0=x0,
                      cg_tol=cg_tol)


def _solve_bucket_implicit(other_factors, yty, cols, vals, mask, l2: float,
                           alpha: float, cg_iters: int = CG_ITERS, x0=None,
                           cg_tol: float = 0.0):
    """Implicit-feedback bucket solve (als.py:910), plain PyTorch: per row
    (YᵀY + Yᵤᵀ(Cᵤ−I)Yᵤ + λI) x = Yᵤᵀcᵤ with c = 1 + α·r and binary
    preference; YᵀY is shared by the batch and stays out of the matrix."""
    gram, rhs, nnz = _gram_rhs_nnz(other_factors, cols, vals, mask,
                                   torch.float32, implicit=True, alpha=alpha)
    return _reg_solve(gram, rhs, nnz, l2, True, implicit=True, yty=yty,
                      cg_iters=cg_iters, x0=x0, cg_tol=cg_tol)


def _gram_all(factors) -> torch.Tensor:
    """YᵀY of a whole factor table, [K, K] f32 (als.py:938)."""
    f = factors.float()
    return f.T @ f


def _solve_bucket_kernel(gsrc, cols, vals, mask, l2: float, reg_nnz: bool,
                         cg_iters: int, kernel_rows: int = 1, x0=None):
    """Bucket solve through the two-stage kernel; ``gsrc`` is already in
    the sweep's dtype."""
    return als_kernels.als_solve_cg(
        gsrc, cols, vals, mask, l2, reg_nnz=reg_nnz, iters=cg_iters,
        rows_per_program=kernel_rows, x0=x0)


def _solve_bucket_fused(gsrc, yty, cols, vals, mask, l2: float,
                        reg_nnz: bool, cg_iters: int, implicit: bool = False,
                        alpha: float = 0.0, x0=None):
    """Bucket solve through the fused gather kernel; the caller passes the
    implicit path's doubled CG budget itself."""
    return als_kernels.als_fused_solve_cg(
        gsrc, cols, vals, mask, l2, reg_nnz=reg_nnz, iters=cg_iters,
        implicit=implicit, alpha=alpha, yty=yty, x0=x0)


def _solve_bucket_chunked(solver_fn, cols, vals, mask, rank: int,
                          row_elems: Optional[int] = None, x0=None):
    """Apply ``solver_fn((cols, vals, mask[, x0])) -> sol`` in row chunks
    of at most ``CHUNK_ELEMS`` gathered elements (``row_elems`` per row,
    default D·rank), so a bucket's temporaries stay bounded."""
    b, d = cols.shape
    chunk = max(8, CHUNK_ELEMS // max(row_elems or (d * rank), 1))
    parts = []
    for s in range(0, max(b, 1), chunk):
        t = (cols[s:s + chunk], vals[s:s + chunk], mask[s:s + chunk])
        if x0 is not None:
            t = t + (x0[s:s + chunk],)
        parts.append(solver_fn(t))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _gram_rhs_nnz_chunked(other_factors, cols, vals, mask, compute_dtype,
                          implicit: bool, alpha: float):
    """:func:`_gram_rhs_nnz` in row chunks of at most ``CHUNK_ELEMS``
    gathered elements (the split segments are ``max_width`` wide)."""
    s_rows, d = cols.shape
    chunk = max(1, CHUNK_ELEMS // max(d * other_factors.shape[1], 1))
    parts = [_gram_rhs_nnz(other_factors, cols[s:s + chunk],
                           vals[s:s + chunk], mask[s:s + chunk],
                           compute_dtype, implicit, alpha)
             for s in range(0, s_rows, chunk)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _gather_x0(prev_factors, row_ids):
    """Warm start of a padded row batch → [rows, K] f32; padding rows
    (row_id -1) start from 0 instead of wrapping to the last row."""
    safe = prev_factors[row_ids.clamp(min=0)].float()
    return torch.where(row_ids[:, None] >= 0, safe, torch.zeros_like(safe))


def _scatter_rows_impl(out, row_ids, sol):
    """Write ``sol`` into ``out`` [n_rows + 1, K] in place; padding rows
    (row_id -1) go to the spare last row, which the caller slices off."""
    spare = out.shape[0] - 1
    out[torch.where(row_ids < 0, spare, row_ids)] = sol
    return out


def _solve_heavy(other_factors, heavy, l2: float, alpha: float,
                 reg_nnz: bool, compute_dtype, implicit: bool, yty,
                 cg_iters: int = CG_ITERS, prev_factors=None,
                 cg_tol: float = 0.0):
    """Partial-Gram combining solve for split rows → (row_ids, sol[H, K]):
    per-segment pieces as in a bucket, summed per row (``index_add_``,
    whose order of atomic sums varies on CUDA), then one solve per row."""
    seg_ids, row_ids, cols, vals, mask = heavy
    n_heavy = row_ids.shape[0]
    rank = other_factors.shape[1]
    pg, prhs, pnnz = _gram_rhs_nnz_chunked(
        other_factors, cols, vals, mask, compute_dtype, implicit, alpha)
    dev = pg.device
    gram = torch.zeros((n_heavy, rank, rank), device=dev).index_add_(
        0, seg_ids, pg)
    rhs = torch.zeros((n_heavy, rank), device=dev).index_add_(0, seg_ids,
                                                              prhs)
    nnz = torch.zeros(n_heavy, device=dev).index_add_(0, seg_ids, pnnz)
    x0 = (_gather_x0(prev_factors, row_ids)
          if prev_factors is not None else None)
    return row_ids, _reg_solve(
        gram, rhs, nnz, l2, reg_nnz, implicit, yty, cg_iters=cg_iters,
        cg_matvec_dtype=torch.float32 if implicit else compute_dtype, x0=x0,
        cg_tol=cg_tol)


def _route(d: int, rank: int, use_kernel: bool, kernel_min_d: int,
           use_fused: bool, implicit: bool = False) -> str:
    """The entry a bucket of width ``d`` at ``rank`` takes in
    :func:`_sweep_side`: "plain" (:func:`_solve_bucket`, or
    :func:`_solve_bucket_implicit`) with the kernels off or below
    ``kernel_min_d``; an implicit bucket the fused entry where
    ``use_fused`` (the only entry with the YᵀY term, als.py:255-260),
    else the plain route; an explicit one the two-stage kernel's R-row
    form ("rows8", ``KERNEL_ROWS`` 8) up to ``ROWS_MAX_D`` where that form
    takes the width and rank (``als_kernels.rows_form``); else the fused
    entry where ``use_fused``; else the two-stage kernel, in the R-row
    form where it takes the bucket and the one-row form ("rows1") where
    not."""
    if not use_kernel or d < kernel_min_d:
        return "plain"
    if implicit:
        return "fused" if use_fused else "plain"
    rows_form = KERNEL_ROWS == 8 and als_kernels.rows_form(d, rank)
    if use_fused and not (rows_form and d <= ROWS_MAX_D):
        return "fused"
    return "rows8" if rows_form else "rows1"


def _bucket_solver(route: str, gsrc, l2: float, reg_nnz: bool,
                   compute_dtype, cg_iters: int, d: int,
                   implicit: bool = False, alpha: float = 0.0, yty=None,
                   cg_tol: float = 0.0):
    """(solver, row_elems) of one bucket of width ``d`` on ``route`` (see
    :func:`_route`): ``solver((cols, vals, mask[, x0])) -> sol`` for
    :func:`_solve_bucket_chunked`, and the gathered elements a row counts
    for its chunks (None: D·rank). The fused entry runs the implicit
    path's doubled CG budget (als.py:755); the plain routes double it in
    :func:`_reg_solve`."""
    def x0(t):
        return t[3] if len(t) > 3 else None

    if route == "fused":
        def solver(t):
            return _solve_bucket_fused(
                gsrc, yty, t[0], t[1], t[2], l2, reg_nnz=reg_nnz,
                cg_iters=cg_iters * (2 if implicit else 1),
                implicit=implicit, alpha=alpha, x0=x0(t))
        return solver, 3 * d + 3 * gsrc.shape[1]
    if route in ("rows1", "rows8"):
        def solver(t):
            return _solve_bucket_kernel(gsrc, t[0], t[1], t[2], l2,
                                        reg_nnz=reg_nnz, cg_iters=cg_iters,
                                        kernel_rows=int(route[4:]), x0=x0(t))
        return solver, None
    if implicit:
        def solver(t):
            return _solve_bucket_implicit(gsrc, yty, t[0], t[1], t[2], l2,
                                          alpha, cg_iters=cg_iters, x0=x0(t),
                                          cg_tol=cg_tol)
        return solver, None

    def solver(t):
        return _solve_bucket(gsrc, t[0], t[1], t[2], l2, reg_nnz=reg_nnz,
                             compute_dtype=compute_dtype, cg_iters=cg_iters,
                             x0=x0(t), cg_tol=cg_tol)
    return solver, None


def _sweep_side(n_rows: int, other_factors, tree, heavy, l2: float,
                reg_nnz: bool, compute_dtype, cg_iters: int = CG_ITERS,
                use_kernel: bool = False, kernel_min_d: int = 0,
                prev_factors=None, use_fused: bool = False,
                implicit: bool = False, alpha: float = 0.0,
                cg_tol: float = 0.0):
    """One half-sweep: solve every bucket and the split rows → the side's
    new factors [n_rows, K] f32, each bucket on the entry :func:`_route`
    gives it. Implicit feedback (als.py:734-767) solves against the f32
    table whatever ``compute_dtype``, with YᵀY of the whole table shared
    by every bucket and the split rows."""
    rank = other_factors.shape[1]
    out = torch.zeros((n_rows + 1, rank), dtype=torch.float32,
                      device=other_factors.device)
    yty = _gram_all(other_factors) if implicit else None
    gsrc = (other_factors if implicit or other_factors.dtype == compute_dtype
            else other_factors.to(compute_dtype))
    for row_ids, cols, vals, mask in tree:
        d = cols.shape[1]
        x0 = (_gather_x0(prev_factors, row_ids)
              if prev_factors is not None else None)
        solver, row_elems = _bucket_solver(
            _route(d, rank, use_kernel, kernel_min_d, use_fused, implicit),
            gsrc, l2, reg_nnz, compute_dtype, cg_iters, d, implicit, alpha,
            yty, cg_tol)
        sol = _solve_bucket_chunked(solver, cols, vals, mask, rank,
                                    row_elems=row_elems, x0=x0)
        _scatter_rows_impl(out, row_ids, sol)
    if heavy is not None:
        h_ids, h_sol = _solve_heavy(
            gsrc, heavy, l2, alpha, reg_nnz, compute_dtype, implicit, yty,
            cg_iters=cg_iters, prev_factors=prev_factors, cg_tol=cg_tol)
        _scatter_rows_impl(out, h_ids, h_sol)
    return out[:n_rows]


def _buckets_tree(buckets: Sequence[PaddedRows], device) -> tuple:
    return tuple(
        (torch.from_numpy(b.row_ids.astype(np.int64)).to(device),
         torch.from_numpy(b.cols).to(device),
         torch.from_numpy(b.vals).to(device),
         torch.from_numpy(b.mask).to(device))
        for b in buckets)


def _heavy_tree(heavy: Optional[HeavySegments], device):
    if heavy is None:
        return None
    return (torch.from_numpy(heavy.seg_ids.astype(np.int64)).to(device),
            torch.from_numpy(heavy.row_ids.astype(np.int64)).to(device),
            torch.from_numpy(heavy.cols).to(device),
            torch.from_numpy(heavy.vals).to(device),
            torch.from_numpy(heavy.mask).to(device))


def _rel_delta(prev: ALSState, new: ALSState) -> torch.Tensor:
    """Relative Frobenius movement of one sweep, both sides (als.py:1827):
    ‖new − prev‖_F / ‖prev‖_F, an f32 scalar on the factors' device."""
    num = (((new.user_factors - prev.user_factors) ** 2).sum()
           + ((new.item_factors - prev.item_factors) ** 2).sum())
    den = (prev.user_factors ** 2).sum() + (prev.item_factors ** 2).sum()
    return torch.sqrt(num / den.clamp(min=1e-30))


def _als_run_converge(state: ALSState, user_tree, item_tree, l2: float,
                      tol: float, max_sweeps: int, min_sweeps: int,
                      reg_nnz: bool, compute_dtype, user_heavy=None,
                      item_heavy=None, cg_iters: int = CG_ITERS,
                      use_kernel: bool = False, kernel_min_d: int = 0,
                      use_fused: Tuple[bool, bool] = (False, False),
                      implicit: bool = False, alpha: float = 0.0,
                      cg_tol: float = 0.0, last_delta: bool = False
                      ) -> Tuple[ALSState, int, torch.Tensor]:
    """Sweeps with the convergence early stop (als.py:1841-1953) →
    (state, sweeps run, the last sweep's delta as a device scalar): users
    against items, then items against the new users, each CG warm-started
    from the side's previous factors when ``CG_WARMSTART``. A sweep runs
    while ``i < max_sweeps and (i < max(min_sweeps, 1) or delta >= tol)``,
    JAX's ``while_loop`` condition, so a NaN delta stops the run as it
    does there. The delta is computed only where it is read: after a
    sweep that reaches the floor and leaves another to decide on, and
    after the last one when ``last_delta`` asks for it (else the returned
    delta is inf). A fixed budget (``min_sweeps == max_sweeps``) without
    ``last_delta`` computes none."""
    st = state
    floor = max(int(min_sweeps), 1)
    i = 0
    delta = torch.tensor(float("inf"))
    while i < int(max_sweeps):
        if i >= floor and not float(delta) >= tol:
            break
        new_users = _sweep_side(
            st.user_factors.shape[0], st.item_factors, user_tree,
            user_heavy, l2, reg_nnz, compute_dtype, cg_iters=cg_iters,
            use_kernel=use_kernel, kernel_min_d=kernel_min_d,
            prev_factors=st.user_factors if CG_WARMSTART else None,
            use_fused=use_fused[0], implicit=implicit, alpha=alpha,
            cg_tol=cg_tol)
        new_items = _sweep_side(
            st.item_factors.shape[0], new_users, item_tree, item_heavy, l2,
            reg_nnz, compute_dtype, cg_iters=cg_iters, use_kernel=use_kernel,
            kernel_min_d=kernel_min_d,
            prev_factors=st.item_factors if CG_WARMSTART else None,
            use_fused=use_fused[1], implicit=implicit, alpha=alpha,
            cg_tol=cg_tol)
        new = ALSState(user_factors=new_users, item_factors=new_items)
        i += 1
        if (floor <= i < int(max_sweeps)) or (
                last_delta and i == int(max_sweeps)):
            delta = _rel_delta(st, new)
        st = new
    return st, i, delta


def _mixed_run(state: ALSState, u_tree, i_tree, l2: float, iterations: int,
               bf16_sweeps: int, reg_nnz: bool, compute_dtype, user_heavy,
               item_heavy, use_kernel: bool = True,
               kernel_min_d: int = 0,
               use_fused: Optional[Tuple[bool, bool]] = None) -> ALSState:
    """Mixed-precision schedule: ``bf16_sweeps`` early sweeps gathering
    from a bf16 table with ``CG_ITERS_BF16`` CG steps, then the rest at
    ``compute_dtype`` with ``CG_ITERS``, each leg a fixed budget of
    :func:`_als_run_converge`. ALS re-solves every row each half-sweep,
    so the bf16 sweeps only move the polish's starting point.

    ``use_kernel`` routes buckets of width ≥ ``kernel_min_d`` (by
    default every bucket) to the kernels (on CPU tensors their plain
    versions run; :func:`_route`) unless ``PIO_ALS_SOLVER`` is
    "cholesky"; False is the plain-PyTorch route throughout.
    ``use_fused`` (user side, item side) defaults to the fused entry on
    both sides above ``ROWS_MAX_D``: on the H100 it beats the two-stage
    entry and its gather at every ML-20M bucket, the item side's 70.9 MB
    user table read from HBM included (PERF.md §6), so the TPU's VMEM rule
    (``als_fused_fits``) and its L2 stand-in are gone."""
    lo = min(max(int(bf16_sweeps), 0), int(iterations))
    common = _route_kw(use_kernel, kernel_min_d, use_fused)
    if lo:
        state, _, _ = _als_run_converge(
            state, u_tree, i_tree, l2, 0.0, lo, lo, reg_nnz, torch.bfloat16,
            user_heavy, item_heavy, cg_iters=min(CG_ITERS_BF16, CG_ITERS),
            **common)
    if iterations - lo:
        state, _, _ = _als_run_converge(
            state, u_tree, i_tree, l2, 0.0, iterations - lo,
            iterations - lo, reg_nnz, compute_dtype, user_heavy, item_heavy,
            **common)
    return state


def _route_kw(use_kernel: bool, kernel_min_d: int,
              use_fused: Optional[Tuple[bool, bool]]) -> dict:
    """The routing keywords of :func:`_als_run_converge` for a run with
    the kernels asked for (``use_kernel``), resolved per call: the kernels
    only under the CG solver, the fused entry on both sides by default,
    and the ``PIO_ALS_CG_TOL`` early exit."""
    use_kernel = bool(use_kernel) and _kernel_enabled()
    return dict(use_kernel=use_kernel, kernel_min_d=kernel_min_d,
                use_fused=(tuple(use_fused) if use_fused is not None
                           else (use_kernel, use_kernel)),
                cg_tol=_cg_tol_env())


def train_flops(nnz: int, n_users: int, n_items: int, rank: int,
                iterations: int, bf16_sweeps: int = 0) -> float:
    """Analytic FLOPs of one training run (als.py:1955): per half-sweep
    the Gram 4·nnz·K², the rhs 2·nnz·K, and per row iters·2·K² of CG
    (warm starts add one matvec); useful work only."""
    k, nnz = float(rank), float(nnz)
    bf16 = min(max(int(bf16_sweeps), 0), int(iterations))
    iters = (bf16 * min(CG_ITERS_BF16, CG_ITERS)
             + (int(iterations) - bf16) * CG_ITERS) / max(int(iterations), 1)
    if CG_WARMSTART:
        iters += 1.0
    per_side_gram = 2.0 * nnz * k * k * 2.0
    per_side_rhs = 2.0 * nnz * k
    solves = (int(n_users) + int(n_items)) * iters * 2.0 * k * k
    return (2.0 * per_side_gram + 2.0 * per_side_rhs + solves) * int(iterations)


def rmse(state: ALSState, users, items, ratings, chunk: int = 1 << 20
         ) -> float:
    """Root-mean-square error over COO ratings, on the factors' device."""
    dev = state.user_factors.device
    users = np.asarray(users, np.int64)
    items = np.asarray(items, np.int64)
    ratings = np.asarray(ratings, np.float32)
    total, n = 0.0, len(ratings)
    for s in range(0, n, chunk):
        u = torch.from_numpy(users[s:s + chunk]).to(dev)
        i = torch.from_numpy(items[s:s + chunk]).to(dev)
        r = torch.from_numpy(ratings[s:s + chunk]).to(dev)
        pred = (state.user_factors[u] * state.item_factors[i]).sum(-1)
        total += float(((pred - r) ** 2).double().sum())
    return float(np.sqrt(total / max(n, 1)))


def prepare_trees(users, items, ratings, n_users: int, n_items: int,
                  max_width: int = 1 << 16, device=None, impl: str = "auto"):
    """Both sides' buckets and split rows, on ``device`` →
    (u_tree, i_tree, user_heavy, item_heavy). ``impl`` picks the bucket
    builder's route (``ops/sparse.build_padded_rows``)."""
    dev = default_device(device)
    (user_light, user_heavy), (item_light, item_heavy) = build_both_sides(
        users, items, ratings, n_users, n_items, max_width=max_width,
        impl=impl)
    return (_buckets_tree(user_light, dev), _buckets_tree(item_light, dev),
            _heavy_tree(user_heavy, dev), _heavy_tree(item_heavy, dev))


def als_train(users: np.ndarray, items: np.ndarray, ratings: np.ndarray,
              n_users: int, n_items: int, rank: int = 64,
              iterations: int = 10, l2: float = 0.1, seed: int = 0,
              reg_nnz: bool = True, compute_dtype: Any = torch.float32,
              max_width: int = 1 << 16, track_rmse: bool = False,
              bf16_sweeps: int = 0, device=None,
              stats: Optional[Dict[str, float]] = None
              ) -> Tuple[ALSState, List[float]]:
    """Full training on ``device`` (CUDA by default): build the padded
    buckets once, start from :func:`als_init` with a CPU generator seeded
    by ``seed``, run ``iterations`` sweeps of the mixed schedule. Rows of
    degree above ``max_width`` go through the partial-Gram combining
    solve. ``track_rmse`` records the fit RMSE after every sweep.
    ``stats`` receives the walls "als.prep" (buckets built and put on the
    device) and "als.sweeps" (every sweep, to the device's last step).
    Trains through the kernels, at any rank up to
    ``als_kernels.MAX_RANK``."""
    dev = default_device(device)
    t0 = time.perf_counter()
    u_tree, i_tree, u_hv, i_hv = prepare_trees(
        users, items, ratings, n_users, n_items, max_width, dev)
    state = als_init(torch.Generator().manual_seed(int(seed)), n_users,
                     n_items, rank, device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    history: List[float] = []
    if track_rmse:
        for sweep in range(iterations):
            state = _mixed_run(state, u_tree, i_tree, l2, 1,
                               1 if sweep < bf16_sweeps else 0, reg_nnz,
                               compute_dtype, u_hv, i_hv)
            history.append(rmse(state, users, items, ratings))
    else:
        state = _mixed_run(state, u_tree, i_tree, l2, iterations,
                           bf16_sweeps, reg_nnz, compute_dtype, u_hv, i_hv)
    _sync(dev)
    if stats is not None:
        stats["als.prep"] = t1 - t0
        stats["als.sweeps"] = time.perf_counter() - t1
    from incubator_predictionio_tpu_torch.ops.retrain import _book_sweeps

    _book_sweeps("fresh", iterations)
    return state, history


def als_train_implicit(users: np.ndarray, items: np.ndarray,
                       weights: np.ndarray, n_users: int, n_items: int,
                       rank: int = 64, iterations: int = 10, l2: float = 0.1,
                       alpha: float = 1.0, seed: int = 0,
                       max_width: int = 1 << 16, device=None,
                       use_kernel: bool = True,
                       stats: Optional[Dict[str, float]] = None) -> ALSState:
    """Implicit-feedback training (Hu-Koren-Volinsky, als.py:987) over
    (user, item, weight) observations on ``device`` (CUDA by default):
    confidence c = 1 + α·weight, binary preference, λ plain, f32
    throughout, from :func:`als_init` with a CPU generator seeded by
    ``seed``. With ``use_kernel`` every bucket takes the fused entry with
    the shared YᵀY (the split rows the plain assembly); False is the
    plain route. ``stats`` as :func:`als_train`'s."""
    dev = default_device(device)
    t0 = time.perf_counter()
    u_tree, i_tree, u_hv, i_hv = prepare_trees(
        users, items, weights, n_users, n_items, max_width, dev)
    state = als_init(torch.Generator().manual_seed(int(seed)), n_users,
                     n_items, rank, device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    state, _, _ = _als_run_converge(
        state, u_tree, i_tree, l2, 0.0, iterations, iterations, True,
        torch.float32, u_hv, i_hv, implicit=True, alpha=alpha,
        **_route_kw(use_kernel, 0, None))
    _sync(dev)
    if stats is not None:
        stats["als.prep"] = t1 - t0
        stats["als.sweeps"] = time.perf_counter() - t1
    from incubator_predictionio_tpu_torch.ops.retrain import _book_sweeps

    _book_sweeps("fresh", iterations)
    return state


def implicit_loss(state: ALSState, users, items, weights, alpha: float,
                  l2: float, chunk: int = 1 << 20) -> float:
    """The implicit objective Σ_all c·(p − xᵀy)² + λ(‖X‖² + ‖Y‖²) over
    every (user, item) pair, p = 1 and c = 1 + α·w where observed, p = 0
    and c = 1 elsewhere, in f64: Σ_all (xᵀy)² is Σ (XᵀX ∘ YᵀY), the
    observed pairs add c(1 − s)² − s²."""
    uf = state.user_factors.double()
    vf = state.item_factors.double()
    dev = uf.device
    total = float(((uf.T @ uf) * (vf.T @ vf)).sum())
    users = np.asarray(users, np.int64)
    items = np.asarray(items, np.int64)
    weights = np.asarray(weights, np.float64)
    for s in range(0, len(weights), chunk):
        u = torch.from_numpy(users[s:s + chunk]).to(dev)
        i = torch.from_numpy(items[s:s + chunk]).to(dev)
        c = 1.0 + alpha * torch.from_numpy(weights[s:s + chunk]).to(dev)
        sc = (uf[u] * vf[i]).sum(-1)
        total += float((c * (1.0 - sc) ** 2 - sc ** 2).sum())
    return total + l2 * float((uf ** 2).sum() + (vf ** 2).sum())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
