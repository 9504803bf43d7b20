"""Hand-written CUDA kernels of ALS training, with their plain versions.

Each solves one degree bucket of explicit-feedback ALS: per row, the Gram
and right-hand side of its normal equations over the row's observations,
then ``iters`` steps of Jacobi-preconditioned CG on
(Gram + λI [+ YᵀY]) x = rhs, cold from 0 or warm from ``x0``. The ridge λ
(λ·max(nnz, 1) with ``reg_nnz``, else λ) is applied inside the matvec.

- :func:`als_solve_cg` replaces ``als_solve_cg_pallas``
  (incubator_predictionio_tpu/ops/pallas_kernels.py:869): the masked rows
  are gathered from the table outside the kernel into a [B, D, K] block,
  and the kernel builds the Gram and runs the CG. ``rows_per_program`` 1
  is the body ``_als_cg_kernel`` (:653), 8 the body ``_als_cg_kernel_rows``
  (:756): the R-row form, for many short rows (:func:`rows_form`), which
  solves up to 8 rows a block, one warp each, without forming a Gram;
  longer rows take the one-row plan. No guard for empty rows.
- :func:`als_fused_solve_cg` replaces ``als_fused_solve_cg_pallas``
  (:1196, body ``_als_fused_kernel`` :1052): the kernel gathers the rows
  from the table itself, so the [B, D, K] block never reaches device
  memory. Implicit feedback (``implicit``, ``alpha``, ``yty``) is the same
  body with the shared YᵀY term in the matvec. Empty rows give exactly 0.

The kernels are in ``csrc/als_solve.cu``, whose note says what bounds them
on the card. Both entries share one stage 1 on the tensor cores, which
splits each row's d range over blocks and, above rank 128, the Gram into
128 × 128 tiles: :func:`solve_plan`, its launch plan, is computed here and
checked by the C entries. Any rank is taken, as by the JAX package, which
pads K to a multiple of 128 (``als_padded_dims``, pallas_kernels.py:846):
up to ``MAX_RANK``, where the CG's vectors fill shared memory. For CUDA
tensors a wrapper launches its kernel or raises; for CPU tensors it runs
its plain version, which does the same arithmetic in PyTorch (bf16 values
widened to f32 before f32 products, the rhs weights and the gw-weighted
rows rounded to bf16 where the TPU kernel rounds them) and which the chip
smoke compares the kernel with.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from incubator_predictionio_tpu_torch import runtime

#: row-group sizes of the two-stage kernel
ROWS = (1, 8)
#: the TPU kernels these replace, entry → pallas_call → body
REPLACES = {
    "als_solve_cg":
        "incubator_predictionio_tpu/ops/pallas_kernels.py:653",
    "als_solve_cg_rows8":
        "incubator_predictionio_tpu/ops/pallas_kernels.py:756",
    "als_fused_solve_cg":
        "incubator_predictionio_tpu/ops/pallas_kernels.py:1052",
}

ALS_SOLVE_CG_LAUNCHES = runtime.LaunchCounter("als_solve_cg")
ALS_SOLVE_CG_ROWS8_LAUNCHES = runtime.LaunchCounter("als_solve_cg_rows8")
ALS_FUSED_SOLVE_CG_LAUNCHES = runtime.LaunchCounter("als_fused_solve_cg")


#: stage-1 blocks per SM the launch plan aims at
SOLVE_BLOCKS_PER_SM = 2
#: most workspace one launch takes; a call with more rows runs in groups
WORKSPACE_CAP = 1 << 28


_GEOMETRY = runtime.csrc_constants("als_solve.cu")
#: the Gram tile above rank 128
GRAM_TILE = _GEOMETRY["kGramTile"]
#: widest padded rank of the R-row form
ROWS_MAX_RANK = _GEOMETRY["kRowsMaxRank"]
#: widest rank the kernels take (the CG above 128 keeps its vectors in
#: shared memory)
MAX_RANK = _GEOMETRY["kMaxRank"]


def padded_rank(k: int) -> int:
    """The rank the kernels compute at: 16, 32, 64 or 128, then a multiple
    of ``GRAM_TILE`` (padding coordinates solve to exactly 0;
    ``padded_rank`` of the source)."""
    if k <= GRAM_TILE:
        return next(kp for kp in (16, 32, 64, GRAM_TILE) if k <= kp)
    return -(-k // GRAM_TILE) * GRAM_TILE


def rows_form(d: int, k: int) -> bool:
    """Whether ``rows_per_program`` 8 takes the R-row form at width ``d``
    and rank ``k``: rows of d ≤ the padded rank, which is at most
    ``ROWS_MAX_RANK`` (``rows_form`` of the source). Other widths and
    ranks take the one-row plan (:func:`solve_plan`), whose slices spread
    a long row over many blocks."""
    kp = padded_rank(k)
    return kp <= ROWS_MAX_RANK and d <= kp


def gram_tiles(kp: int) -> int:
    """Stage-1 blocks per (row, slice): 1 up to rank 128, else the
    ``GRAM_TILE`` tiles of the Gram's upper triangle, diagonal included
    (``gram_tiles`` of the source; the fused entry with implicit
    confidences and a bf16 table sums all (kp / GRAM_TILE)² tiles)."""
    n = kp // GRAM_TILE
    return 1 if kp <= GRAM_TILE else n * (n + 1) // 2


def slab_rows(kp: int) -> int:
    """Rows of d in one staged slab of stage 1 (``slab_rows`` of the
    source, whose constants these are)."""
    return _GEOMETRY["kSlabRowsWide" if kp >= 64 else "kSlabRowsNarrow"]


def record_floats(kp: int) -> int:
    """f32 of one partial record: a [kp, kp] Gram and its rhs."""
    return kp * kp + kp


class SolvePlan(NamedTuple):
    """Launch plan of both entries' stage 1: each bucket row's d range is
    cut into ``slices`` slices of ``slice_rows`` rows (the last fewer),
    one stage-1 block per slice and Gram tile (``tiles``), which stages
    them in slabs of :func:`slab_rows`. ``rows`` rows go to one launch
    (the call runs in groups of them), whose workspace of
    ``workspace_bytes`` holds their partial records and, for several
    slices, the summed ones: none for one slice up to rank 128, where the
    stage-1 block solves the row itself."""
    kp: int
    tiles: int
    slices: int
    slice_rows: int
    rows: int
    workspace_bytes: int


def solve_plan(b: int, d: int, k: int, n_sms: int) -> SolvePlan:
    """The split of a [b, d, k] bucket chunk on a card of ``n_sms`` SMs:
    enough slices that b·slices·tiles reaches ``SOLVE_BLOCKS_PER_SM``
    blocks per SM where d allows (no more slices than slabs), of equal
    length, so that b = 8 fills the card in one wave exactly; rows per
    launch as many as keep the workspace within ``WORKSPACE_CAP`` (at
    least one)."""
    kp = padded_rank(k)
    tiles = gram_tiles(kp)
    want = min(max(1, -(-SOLVE_BLOCKS_PER_SM * n_sms // (b * tiles))),
               -(-d // slab_rows(kp)))
    slice_rows = -(-d // want)
    slices = -(-d // slice_rows)
    per_row = 4 * record_floats(kp) * (
        slices + 1 if slices > 1 else int(kp > GRAM_TILE))
    group = b if per_row == 0 else max(1, min(b, WORKSPACE_CAP // per_row))
    return SolvePlan(kp=kp, tiles=tiles, slices=slices,
                     slice_rows=slice_rows, rows=group,
                     workspace_bytes=group * per_row)


def als_bound(nnz: float, distinct_rows: int, b: int, d: int, k: int,
              iters: int, warm: bool, dtype,
              f32_flops: float = runtime.F32_3XTF32_FLOPS,
              implicit: bool = False) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for one explicit bucket solve, either entry, with a ``dtype`` table.
    Bytes: the ``distinct_rows`` table rows the bucket references,
    cols/vals/mask [b, d], x0 when ``warm`` and the [b, k] output, each
    once. Operations: the lesser of the function's two ways.
    - Through the Gram: the symmetric Gram, nnz·K·(K + 1) (its K(K + 1)/2
      entries, a multiply and an add each), and the rhs, 2·nnz·K, at the
      table dtype's peak: bf16 on the tensor cores, f32 at ``f32_flops``,
      by default the 3xTF32 rate (the fastest f32-accurate products;
      ``runtime.F32_FLOPS`` gives the FMA units' bound beside it); then
      (iters + warm) matvecs of 2·b·K² in f32 for the CG.
    - Without it (the R-row form's way): the rhs and the Jacobi diagonal,
      4·nnz·K, and (iters + warm) matvecs Tᵀ(T p) of 4·nnz·K, all in f32
      on the FMA units (matrix-vector products).
    ``implicit`` adds the shared [K, K] YᵀY, read once, to the bytes. The
    Gram way folds it into each row's Gram, b·K² adds once, and its CG
    matvecs stay 2·b·K² a step; the Gram-free way cannot fold it and adds
    its matvec, 2·b·K² a step."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (distinct_rows * k * itemsize + 3 * 4 * b * d
              + 4 * b * k * (2 if warm else 1) + (4 * k * k if implicit
                                                  else 0))
    peak = runtime.BF16_FLOPS if dtype == torch.bfloat16 else f32_flops
    steps = iters + int(warm)
    t_bytes = nbytes / runtime.HBM_BYTES_PER_S
    fold = float(b) * k * k / runtime.F32_FLOPS if implicit else 0.0
    t_yty = steps * 2.0 * b * k * k / runtime.F32_FLOPS if implicit else 0.0
    t_gram = (float(nnz) * k * (k + 1) + 2.0 * nnz * k) / peak \
        + steps * 2.0 * b * k * k / runtime.F32_FLOPS + fold
    t_free = (steps + 1) * 4.0 * nnz * k / runtime.F32_FLOPS + t_yty
    t_ops = min(t_gram, t_free)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bucket_bound(cols, mask, k: int, iters: int, warm: bool, dtype,
                 f32_flops: float = runtime.F32_3XTF32_FLOPS,
                 implicit: bool = False) -> Tuple[float, str]:
    """:func:`als_bound` of one bucket (or chunk) as the data holds it:
    its observations and the distinct table rows they reference."""
    b, d = cols.shape
    distinct = int(torch.unique(cols[mask > 0]).numel())
    return als_bound(float(mask.sum()), distinct, b, d, k, iters, warm, dtype,
                     f32_flops, implicit)


def _ridge(mask: torch.Tensor, l2: float, reg_nnz: bool
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nnz [B], λ [B]) of explicit ALS-WR."""
    nnz = mask.float().sum(-1)
    lam = l2 * (nnz.clamp(min=1.0) if reg_nnz else torch.ones_like(nnz))
    return nnz, lam


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype``, as f32."""
    return t.to(dtype).float()


def cg_plain(gram: torch.Tensor, b: torch.Tensor, lam: torch.Tensor,
             iters: int, x0: Optional[torch.Tensor] = None,
             yty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' CG in PyTorch: ap = p·Gram + λp (+ p·YᵀY), Jacobi
    diagonal Gram_kk + λ (+ YᵀY_kk), guards as in the kernel."""
    diag = torch.diagonal(gram, dim1=-2, dim2=-1) + lam[:, None]
    if yty is not None:
        diag = diag + torch.diagonal(yty)[None, :]
    minv = torch.where(diag > 0, 1.0 / diag, torch.zeros_like(diag))

    def matvec(p):
        ap = torch.bmm(p[:, None, :], gram)[:, 0, :] + lam[:, None] * p
        if yty is not None:
            ap = ap + p @ yty
        return ap

    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x = x0.to(b.dtype)
        r = b - matvec(x)
    z = minv * r
    rz = (r * z).sum(-1)
    p = z
    zero = torch.zeros_like(rz)
    for _ in range(int(iters)):
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


def als_solve_cg_plain(table, cols, vals, mask, l2: float,
                       reg_nnz: bool = True, iters: int = 16,
                       rows_per_program: int = 1,
                       x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`als_solve_cg` → [B, K] f32
    (``rows_per_program`` changes the layout, not the arithmetic)."""
    del rows_per_program
    g = (table[cols] * mask[..., None].to(table.dtype)).float()
    wv = _round(vals * mask, table.dtype)
    gram = torch.einsum("bdk,bdl->bkl", g, g)
    rhs = torch.einsum("bd,bdk->bk", wv, g)
    _, lam = _ridge(mask, l2, reg_nnz)
    return cg_plain(gram, rhs, lam, iters, x0)


def _fused_weights(vals, mask, implicit: bool, alpha: float):
    maskf = mask.float()
    if implicit:
        gw = alpha * vals * maskf          # (c − 1), 0 on padding
        return gw, maskf + gw              # rhs weight (1 + α·r)·mask
    return maskf, vals * maskf


def _fused_lam(mask, l2: float, reg_nnz: bool, implicit: bool):
    nnz, lam = _ridge(mask, l2, reg_nnz)
    if implicit:
        lam = torch.full_like(nnz, float(l2))
    return nnz, lam


def als_fused_solve_cg_plain(table, cols, vals, mask, l2: float,
                             reg_nnz: bool = True, iters: int = 16,
                             implicit: bool = False, alpha: float = 1.0,
                             yty: Optional[torch.Tensor] = None,
                             x0: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The plain version of :func:`als_fused_solve_cg` → [B, K] f32."""
    gw, rw = _fused_weights(vals, mask, implicit, alpha)
    t = table[cols]                                     # table dtype
    wt = (t * gw[..., None].to(t.dtype)).float()        # rounds like the TPU
    t = t.float()
    gram = torch.einsum("bdk,bdl->bkl", wt, t)
    rhs = torch.einsum("bd,bdk->bk", _round(rw, table.dtype), t)
    nnz, lam = _fused_lam(mask, l2, reg_nnz, implicit)
    x = cg_plain(gram, rhs, lam, iters, x0,
                 yty.float() if implicit else None)
    return torch.where(nnz[:, None] > 0, x, torch.zeros_like(x))


# -- wrappers ------------------------------------------------------------------

def _on_cpu(*ts) -> bool:
    return all(t is None or t.device.type == "cpu" for t in ts)


def _check(name: str, table, cols, vals, mask, x0, yty=None):
    dev = table.device
    if dev.type != "cuda" or any(
            t is not None and t.device != dev
            for t in (cols, vals, mask, x0, yty)):
        raise ValueError(f"{name}: all tensors must lie on one CUDA device")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes a float32 or bfloat16 table, got "
                        f"{table.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 cols, got {cols.dtype}")
    for what, t in (("vals", vals), ("mask", mask), ("x0", x0),
                    ("yty", yty)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 {what}, got {t.dtype}")
    if table.dim() != 2 or cols.dim() != 2 or vals.shape != cols.shape \
            or mask.shape != cols.shape:
        raise ValueError(f"{name}: table [M, K] and cols/vals/mask [B, D] "
                         f"expected, got {tuple(table.shape)}, "
                         f"{tuple(cols.shape)}, {tuple(vals.shape)}, "
                         f"{tuple(mask.shape)}")
    b, k = cols.shape[0], table.shape[1]
    if not 0 < k <= MAX_RANK:
        raise ValueError(f"{name} takes rank 1..{MAX_RANK}, got {k}")
    if x0 is not None and tuple(x0.shape) != (b, k):
        raise ValueError(f"{name}: x0 must be [{b}, {k}], got "
                         f"{tuple(x0.shape)}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def als_solve_cg(table, cols, vals, mask, l2: float, reg_nnz: bool = True,
                 iters: int = 16, rows_per_program: int = 1,
                 x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Two-stage bucket solve → [B, K] f32: ``table`` [M, K] (f32 or
    bf16; bf16 is the fast schedule), ``cols`` [B, D] int32, ``vals`` and
    ``mask`` [B, D] f32, optional warm start ``x0`` [B, K] f32;
    ``rows_per_program`` 1 or 8."""
    if rows_per_program not in ROWS:
        raise ValueError(f"rows_per_program must be 1 or 8, got "
                         f"{rows_per_program}")
    if _on_cpu(table, cols, vals, mask, x0):
        return als_solve_cg_plain(table, cols, vals, mask, l2, reg_nnz,
                                  iters, rows_per_program, x0)
    return _two_stage(table, cols, vals, mask, l2, reg_nnz, iters,
                      rows_per_program, x0)


def _two_stage(table, cols, vals, mask, l2: float, reg_nnz: bool,
               iters: int, rows_per_program: int,
               x0: Optional[torch.Tensor], n_sms: Optional[int] = None
               ) -> torch.Tensor:
    """:func:`als_solve_cg` on CUDA tensors; ``n_sms`` sizes the launch
    plan (None: the card's SM count; the card tests pass others to force
    one slice or many on the same rows)."""
    _check("als_solve_cg", table, cols, vals, mask, x0)
    dev = table.device
    b, d = cols.shape
    k = table.shape[1]
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    tab, colsc, maskc = table.contiguous(), cols.contiguous(), \
        mask.contiguous()
    g = torch.empty((b, d, k), dtype=table.dtype, device=dev)
    wv = (vals * mask).contiguous()
    lam = _ridge(mask, l2, reg_nnz)[1].contiguous()
    x0c = None if x0 is None else x0.contiguous()
    rows = 8 if rows_per_program == 8 and rows_form(d, k) else 1
    if rows == 8:
        plan = SolvePlan(padded_rank(k), 1, 1, d, b, 0)  # no plan: one launch
    else:
        plan = solve_plan(b, d, k, n_sms or runtime.sm_count(dev))
    lib = runtime.build_kernels()
    bf16 = int(table.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        # the masked rows, table[cols] * mask, in one hand-written pass
        rc = lib.pio_als_gather_rows(
            tab.data_ptr(), bf16, tab.shape[0], colsc.data_ptr(),
            maskc.data_ptr(), b * d, k, g.data_ptr(), _stream(dev))
        runtime.check_launch(rc, "als_solve_cg gather")
        for r0, r1, work in _row_groups(plan, b, dev):
            rc = lib.pio_als_solve_cg(
                g[r0:r1].data_ptr(), bf16, wv[r0:r1].data_ptr(),
                lam[r0:r1].data_ptr(),
                _ptr(None if x0c is None else x0c[r0:r1]),
                out[r0:r1].data_ptr(), r1 - r0, d, k, int(iters), rows,
                plan.slices, plan.slice_rows, _ptr(work),
                plan.workspace_bytes, _stream(dev))
            runtime.check_launch(rc, "als_solve_cg")
    # counted by the kernel that ran: rows = 8 outside the R-row form's
    # widths launches the one-row kernels
    (ALS_SOLVE_CG_ROWS8_LAUNCHES if rows == 8
     else ALS_SOLVE_CG_LAUNCHES).add()
    return out


def _row_groups(plan: SolvePlan, b: int, dev):
    """(first row, end row, workspace) of each launch of a call: groups of
    ``plan.rows`` rows sharing one stream-ordered workspace (concurrent
    calls on other streams never share it)."""
    work = (torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=dev)
            if plan.workspace_bytes else None)
    for r0 in range(0, b, plan.rows):
        yield r0, min(b, r0 + plan.rows), work


def als_fused_solve_cg(table, cols, vals, mask, l2: float,
                       reg_nnz: bool = True, iters: int = 16,
                       implicit: bool = False, alpha: float = 1.0,
                       yty: Optional[torch.Tensor] = None,
                       x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused gather bucket solve → [B, K] f32: arguments as
    :func:`als_solve_cg` (``mask`` the explicit Gram weights: 0 or 1 as
    the buckets hold it, and any other value weighs its row as in the
    plain version);
    ``implicit`` takes the confidences α·vals and the shared ``yty`` [K, K]
    f32 (λ then is plain, not λ·nnz). Rows with no observation give
    exactly 0."""
    if implicit and yty is None:
        raise ValueError("implicit als_fused_solve_cg needs yty")
    if _on_cpu(table, cols, vals, mask, x0, yty if implicit else None):
        return als_fused_solve_cg_plain(table, cols, vals, mask, l2, reg_nnz,
                                        iters, implicit, alpha, yty, x0)
    yty = yty if implicit else None
    _check("als_fused_solve_cg", table, cols, vals, mask, x0, yty)
    k = table.shape[1]
    if yty is not None and tuple(yty.shape) != (k, k):
        raise ValueError(f"yty must be [{k}, {k}], got {tuple(yty.shape)}")
    return _fused(table, cols, vals, mask, l2, reg_nnz, iters, implicit,
                  alpha, yty, x0)


def _fused(table, cols, vals, mask, l2: float, reg_nnz: bool, iters: int,
           implicit: bool, alpha: float, yty: Optional[torch.Tensor],
           x0: Optional[torch.Tensor], n_sms: Optional[int] = None
           ) -> torch.Tensor:
    """:func:`als_fused_solve_cg` on CUDA tensors (``yty`` None unless
    implicit); ``n_sms`` as :func:`_two_stage`'s."""
    dev = table.device
    b, d = cols.shape
    m, k = table.shape
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    gw, rw = _fused_weights(vals, mask, implicit, alpha)
    nnz, lam = _fused_lam(mask, l2, reg_nnz, implicit)
    tab = table.contiguous()
    colsc = cols.contiguous()
    gw, rw = gw.contiguous(), rw.contiguous()
    lam, nnz = lam.contiguous(), nnz.contiguous()
    ytyc = None if yty is None else yty.contiguous()
    x0c = None if x0 is None else x0.contiguous()
    plan = solve_plan(b, d, k, n_sms or runtime.sm_count(dev))
    lib = runtime.build_kernels()
    with torch.cuda.device(dev):
        for r0, r1, work in _row_groups(plan, b, dev):
            rc = lib.pio_als_fused_solve_cg(
                tab.data_ptr(), int(table.dtype == torch.bfloat16), m,
                colsc[r0:r1].data_ptr(), gw[r0:r1].data_ptr(),
                rw[r0:r1].data_ptr(), lam[r0:r1].data_ptr(),
                nnz[r0:r1].data_ptr(), _ptr(ytyc),
                _ptr(None if x0c is None else x0c[r0:r1]),
                out[r0:r1].data_ptr(), r1 - r0, d, k, int(iters),
                plan.slices, plan.slice_rows, _ptr(work),
                plan.workspace_bytes, _stream(dev))
            runtime.check_launch(rc, "als_fused_solve_cg")
    ALS_FUSED_SOLVE_CG_LAUNCHES.add()
    return out
