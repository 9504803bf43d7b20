"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where no CUDA device is present. On a
machine with one (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: both sides are f32 but sum the rank in
different orders, so scores agree to rtol 1e-5 and ids except among
near-ties; ALS solves agree to 1e-4 of max|x| with an f32 table and 1e-3
with a bf16 one (same arithmetic, other order of sums); flash attention to
1e-4 of max|out| in f32 (sums over the keys in other orders, the kernel's
products in 3xTF32) and 8e-3, one bf16 ulp, in bf16 (both round the same
f32 value; the kernel's P enters the PV product in bf16).
"""

import numpy as np
import pytest
import torch

from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.ops import (
    als,
    als_kernels,
    attention_kernels,
    kernels,
    topk,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _near_tie_equal(got_s, got_i, ref_s, ref_i):
    np.testing.assert_allclose(got_s, ref_s[:, :got_s.shape[1]], rtol=1e-5,
                               atol=1e-5 * np.abs(ref_s).max())
    for b, p in zip(*np.nonzero(got_i != ref_i[:, :got_i.shape[1]])):
        assert abs(ref_s[b, p] - ref_s[b, p + 1]) <= 1e-5 * abs(ref_s[b, p]) \
            or abs(ref_s[b, p] - ref_s[b, p - 1]) <= 1e-5 * abs(ref_s[b, p])


@pytest.mark.parametrize("b,n_items,rank,k", [
    (1, 500, 24, 7), (3, 2100, 16, 20), (8, 5000, 128, 128),
    (33, 40_000, 64, 100), (2, 300, 10, 5),
    # more than 1,024 tiles: three merge rounds, through both buffers
    (2, 1_100_000, 8, 64),
])
def test_kernel_matches_plain(dev, b, n_items, rank, k):
    rng = np.random.default_rng(n_items)
    items = torch.from_numpy(
        rng.standard_normal((n_items, rank), np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, rank), np.float32)).to(dev)
    allowed = torch.from_numpy(rng.random(n_items) > 0.2).to(dev)
    before = kernels.SCORE_TOPK_LAUNCHES.value
    got_s, got_i = kernels.score_topk(q, items, allowed, k)
    assert kernels.SCORE_TOPK_LAUNCHES.value == before + 1
    ref_s, ref_i = kernels.score_topk_plain(q, items, allowed, k + 1)
    torch.cuda.synchronize()
    _near_tie_equal(got_s.cpu().numpy(), got_i.cpu().numpy(),
                    ref_s.cpu().numpy(), ref_i.cpu().numpy())


def test_fillers_and_exclusions(dev):
    rng = np.random.default_rng(1)
    items = torch.from_numpy(rng.standard_normal((3000, 16),
                                                 np.float32)).to(dev)
    user = torch.from_numpy(rng.standard_normal(16, np.float32)).to(dev)
    mask = torch.zeros(3000, dtype=torch.bool, device=dev)
    mask[[5, 1500, 2999]] = True
    exclude = torch.tensor([-1, 1500, -1, 7], device=dev)
    out = topk.score_and_top_k(user, items, 6, exclude=exclude,
                               allowed_mask=mask).cpu().numpy()
    assert sorted(out[1][:2].tolist()) == [5, 2999]
    assert (out[0][2:] == np.float32(kernels.NEG_INF)).all()
    assert (out[1][2:] == -1).all()


def test_launch_on_mixed_devices_raises(dev):
    items = torch.zeros((100, 8), device=dev)
    with pytest.raises(ValueError):
        kernels.score_topk(torch.zeros((1, 8)), items, None, 5)
    with pytest.raises(TypeError):
        kernels.score_topk(torch.zeros((1, 8), dtype=torch.float64,
                                       device=dev), items.double(), None, 5)
    assert runtime.build_kernels() is runtime.build_kernels()


def _topk_exact(dev, q, items, allowed, k):
    """Kernel against the plain version slot for slot: integer factors
    make every score exact in any order of sums, ties included."""
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    got_s, got_i = kernels.score_topk(t(q), t(items), t(allowed), k)
    ref_s, ref_i = kernels.score_topk_plain(t(q), t(items), t(allowed), k)
    torch.cuda.synchronize()
    assert torch.equal(got_s.cpu(), ref_s.cpu())
    assert torch.equal(got_i.cpu(), ref_i.cpu())


@pytest.mark.parametrize("n_items,b", [(26_744, 1), (1_048_576, 1),
                                       (1_048_576, 64)])
@pytest.mark.parametrize("k", [1, 4, 128])
def test_topk_ties_across_tiles_and_blocks(dev, n_items, b, k):
    """The best row planted either side of a 256-item tile's edge and of a
    block's item range (16 tiles at B 1 on 1M items, 125 at B 64 on a card
    of 132 SMs): ties go to the lowest id whichever block holds it."""
    rng = np.random.default_rng(k + b)
    items = rng.integers(-2, 3, (n_items, 16)).astype(np.float32)
    ids = [i for i in (255, 256, 511, 512, 4095, 4096, 31_999, 32_000)
           if i < n_items] + [n_items - 1]
    items[ids] = 3.0
    q = rng.integers(1, 3, (b, 16)).astype(np.float32)
    _topk_exact(dev, q, items, None, k)


@pytest.mark.parametrize("b,k", [(1, 1), (1, 128), (3, 128), (9, 64)])
def test_topk_threshold_ties_in_later_tiles(dev, b, k):
    """Three score values over 100,000 items: the running threshold's
    score recurs in every later tile and block."""
    rng = np.random.default_rng(b * k)
    items = rng.integers(-1, 2, (100_000, 8)).astype(np.float32)
    q = rng.integers(-1, 2, (b, 8)).astype(np.float32)
    _topk_exact(dev, q, items, None, k)


@pytest.mark.parametrize("rank", [8, 10, 64, 128, 256, 257, 300, 512])
@pytest.mark.parametrize("b", [1, 3, 8, 9, 64])
def test_topk_row_groups_and_ranks(dev, b, rank):
    """One row group of exactly B rows (B ≤ 8), partial groups of 8 (9,
    and 64's last), ranks below, at and above a 32-column chunk, one not a
    multiple of 4 (the 4-byte copies), and above 256, where the query rows
    stream by chunk with the items (257 and 300 no multiple of a chunk,
    257 of 4): a model of any rank is served, as by the reference."""
    rng = np.random.default_rng(b * rank)
    items = torch.from_numpy(
        rng.standard_normal((3000, rank), np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, rank), np.float32)).to(dev)
    allowed = torch.from_numpy(rng.random(3000) > 0.1).to(dev)
    for k in (1, 128):
        got_s, got_i = kernels.score_topk(q, items, allowed, k)
        ref_s, ref_i = kernels.score_topk_plain(q, items, allowed, k + 1)
        torch.cuda.synchronize()
        _near_tie_equal(got_s.cpu().numpy(), got_i.cpu().numpy(),
                        ref_s.cpu().numpy(), ref_i.cpu().numpy())


@pytest.mark.parametrize("n_items", [257, 1000, 2049])
def test_topk_catalogue_not_a_multiple_of_the_tile(dev, n_items):
    rng = np.random.default_rng(n_items)
    items = rng.integers(-3, 4, (n_items, 12)).astype(np.float32)
    for b, k in ((1, 1), (3, 128), (9, 128)):
        _topk_exact(dev, rng.integers(-3, 4, (b, 12)).astype(np.float32),
                    items, None, k)


@pytest.mark.parametrize("n_allowed", [0, 1, 50])
def test_topk_fewer_allowed_items_than_k(dev, n_allowed):
    """Fewer allowed items than k (none: an all-disallowed catalogue):
    the allowed ones first, then (NEG_INF, -1) fillers."""
    rng = np.random.default_rng(n_allowed)
    items = rng.integers(-3, 4, (5000, 24)).astype(np.float32)
    allowed = np.zeros(5000, bool)
    allowed[rng.choice(5000, n_allowed, replace=False)] = True
    for b in (1, 9):
        q = rng.integers(-3, 4, (b, 24)).astype(np.float32)
        for k in (1, 128):
            _topk_exact(dev, q, items, allowed, k)


def test_topk_plan_matches_the_c_entry(dev):
    """The Python plan's workspace is what the C entry asks for, and the C
    entry refuses a plan that leaves items out."""
    lib = runtime.build_kernels()
    for b, n, k in ((1, 26_744, 128), (64, 1_048_576, 128), (9, 257, 1)):
        plan = kernels.topk_plan(b, n, 64, k, runtime.sm_count(dev))
        assert plan.workspace_bytes == lib.pio_score_topk_workspace_bytes(
            b, k, plan.item_blocks)
    q = torch.zeros((1, 8), device=dev)
    items = torch.zeros((3000, 8), device=dev)
    out_s = torch.empty((1, 5), device=dev)
    out_i = torch.empty((1, 5), dtype=torch.int32, device=dev)
    work = torch.empty(1 << 16, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for blocks, per in ((1, 11), (3, 3), (13, 1)):  # 12 tiles hold 3,000
        rc = lib.pio_score_topk(q.data_ptr(), items.data_ptr(), None, 1,
                                3000, 8, 5, blocks, per, out_s.data_ptr(),
                                out_i.data_ptr(), work.data_ptr(),
                                work.numel(), stream)
        assert rc != 0, (blocks, per)


# -- ALS bucket solves (ops/als_kernels.py → csrc/als_solve.cu) ---------------

def _als_problem(dev, m, k, b, d, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 0.3, (m, k)).astype(np.float32)
    cols = rng.integers(0, m, (b, d)).astype(np.int32)
    vals = rng.normal(3.5, 1.0, (b, d)).astype(np.float32)
    mask = (rng.random((b, d)) < 0.8).astype(np.float32)
    mask[min(3, b - 1)] = 0.0
    x0 = rng.normal(0, 0.3, (b, k)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (table, cols, vals, mask, x0))


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


# rank no multiple of 16, of 32, and the full 128; B = 13 pads a row group;
# above 128, ranks of one and of several 128 x 128 tiles (129 no multiple
# of 4 elements: the 4-byte copies)
ALS_SHAPES = [(150, 24, 13, 300), (400, 64, 24, 48), (600, 32, 13, 1024),
              (500, 128, 9, 200), (90, 10, 5, 40), (700, 129, 6, 400),
              (800, 160, 7, 500), (900, 256, 5, 600)]


@pytest.mark.parametrize("m,k,b,d", ALS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_als_two_stage_matches_plain(dev, m, k, b, d, dtype):
    table, cols, vals, mask, x0 = _als_problem(dev, m, k, b, d, k + d)
    table = table.to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    for warm in (None, x0):
        ref = als_kernels.als_solve_cg_plain(table, cols, vals, mask, 0.05,
                                             x0=warm)
        for rows in (1, 8):
            got = als_kernels.als_solve_cg(table, cols, vals, mask, 0.05,
                                           rows_per_program=rows, x0=warm)
            torch.cuda.synchronize()
            assert _rel(got, ref) < tol, (rows, warm is None)


@pytest.mark.parametrize("m,k,b,d", ALS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("implicit", [False, True])
def test_als_fused_matches_plain(dev, m, k, b, d, dtype, implicit):
    table, cols, vals, mask, x0 = _als_problem(dev, m, k, b, d, k + d)
    table = table.to(dtype)
    yty = table.float().T @ table.float() if implicit else None
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    for warm in (None, x0):
        kw = dict(iters=32 if implicit else 16, implicit=implicit,
                  alpha=2.0, yty=yty, x0=warm)
        ref = als_kernels.als_fused_solve_cg_plain(table, cols, vals, mask,
                                                   0.05, **kw)
        got = als_kernels.als_fused_solve_cg(table, cols, vals, mask, 0.05,
                                             **kw)
        torch.cuda.synchronize()
        assert _rel(got, ref) < tol, warm is None
        assert (got[mask.sum(-1) == 0] == 0).all()


# (m, k, b, d): D = 1, D no multiple of a slab or of the slices, every
# padded rank; row 3 (or the last) has no observation
ALS_EDGE_SHAPES = [(60, 32, 5, 1), (60, 128, 4, 1), (400, 64, 5, 1000),
                   (300, 24, 6, 700), (200, 10, 6, 333), (500, 16, 6, 130),
                   (500, 32, 6, 2500), (500, 64, 6, 2500),
                   (500, 128, 6, 2500), (2000, 128, 3, 9000)]


@pytest.mark.parametrize("m,k,b,d", ALS_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_als_two_stage_one_slice_and_many(dev, m, k, b, d, dtype):
    """The one-row two-stage kernel under a one-slice plan (the stage-1
    block solves) and a many-slice plan (partial Grams, a fixed-order
    sum, then the solve) on the same rows, cold and warm: each within the
    tolerance of the plain version (1e-3 where D < K, whose Gram is
    singular and 16 CG steps leave it unconverged), of each other, and on
    the row with no observation. Beyond that tolerance a D < K system is
    held to its f64 solve instead: no more than 3x as far from it as the
    plain version (chip_smoke.als_tolerance's rule)."""
    table, cols, vals, mask, x0 = _als_problem(dev, m, k, b, d, k + d)
    table = table.to(dtype)
    tol = 1e-4 if dtype == torch.float32 and d >= k else 1e-3
    empty = min(3, b - 1)
    for warm in (None, x0):
        ref = als_kernels.als_solve_cg_plain(table, cols, vals, mask, 0.05,
                                             x0=warm)
        outs = [als_kernels._two_stage(table, cols, vals, mask, 0.05, True,
                                       16, 1, warm, n_sms=n)
                for n in (1, 1000)]
        torch.cuda.synchronize()
        slices = [als_kernels.solve_plan(b, d, k, n).slices
                  for n in (1, 1000)]
        assert slices[0] == 1 and (slices[1] > 1 or d <= 128), slices
        for got in outs:
            far = _rel(got, ref) >= tol or float(
                (got[empty] - ref[empty]).abs().max()) > \
                tol * float(ref.abs().max())
            if far and d < k:
                exact = _f64_two_stage(table, cols, vals.to(dtype).float(),
                                       mask, 0.05, 16, warm)
                assert _rel(got.double(), exact) <= \
                    3 * _rel(ref.double(), exact) + 1e-6
            else:
                assert not far, (slices, warm is None)
        if d >= k:
            assert _rel(outs[1], outs[0]) < tol


def _f64_two_stage(table, cols, vals, mask, l2, iters, x0):
    """The two-stage bucket solve in f64 (the plain version's Gram, rhs and
    CG with sums pushed below f32 rounding)."""
    t = table.double()[cols] * mask.double()[..., None]
    gram = torch.einsum("bdk,bdl->bkl", t, t)
    rhs = torch.einsum("bd,bdk->bk", vals.double() * mask.double(), t)
    lam = l2 * mask.double().sum(-1).clamp(min=1.0)
    return als_kernels.cg_plain(gram, rhs, lam, iters,
                                None if x0 is None else x0.double())


def test_als_two_stage_plan_matches_the_c_entry(dev):
    lib = runtime.build_kernels()
    for b, d, k in ((8, 32_768, 128), (13, 300, 24), (5, 1, 32),
                    (1020, 256, 160), (8, 32_768, 256), (3, 100, 300)):
        plan = als_kernels.solve_plan(b, d, k, runtime.sm_count(dev))
        assert plan.workspace_bytes == \
            lib.pio_als_workspace_bytes(plan.rows, k, plan.slices)


def test_als_launch_counts(dev):
    """One count a call, by the kernel that ran: rows_per_program 8 on rows
    longer than the padded rank takes the one-row plan and counts there."""
    table, cols, vals, mask, x0 = _als_problem(dev, 150, 24, 13, 300, 1)
    short = _als_problem(dev, 150, 24, 13, 20, 3)
    counters = (als_kernels.ALS_SOLVE_CG_LAUNCHES,
                als_kernels.ALS_SOLVE_CG_ROWS8_LAUNCHES,
                als_kernels.ALS_FUSED_SOLVE_CG_LAUNCHES)
    before = [c.value for c in counters]
    als_kernels.als_solve_cg(table, cols, vals, mask, 0.05)
    als_kernels.als_solve_cg(table, cols, vals, mask, 0.05,
                             rows_per_program=8, x0=x0)
    als_kernels.als_solve_cg(*short[:4], 0.05, rows_per_program=8)
    als_kernels.als_fused_solve_cg(table, cols, vals, mask, 0.05)
    als_kernels.als_solve_cg_plain(table, cols, vals, mask, 0.05)
    als_kernels.als_fused_solve_cg_plain(table, cols, vals, mask, 0.05)
    assert [c.value - v for c, v in zip(counters, before)] == [2, 1, 1]


# the R-row form's widths (d <= the padded rank) and one long d that takes
# the one-row plan's slices; 21 rows, no multiple of any rows-a-block
ROWS_D = [1, 8, 16, 32, 63, 64, 3000]
#: most a D < K result past the tolerance may be from the nearer of the
#: plain version and the f64 solve (chip_smoke.NARROW_CEILING)
D_LT_K_CEILING = 3e-2


@pytest.mark.parametrize("d", ROWS_D)
@pytest.mark.parametrize("k", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_als_rows_form_matches_plain(dev, k, d, dtype):
    """rows_per_program 8 against the plain version, cold and warm, on 0/1
    masks (row 3 empty) and fractional ones: within 1e-4 of max|x| in f32
    where d >= K, else 1e-3; beyond that a D < K system (the R-row form
    forms no Gram, so its rounding differs from the plain version's) is
    held to its f64 solve, no more than 3x as far from it as the plain
    version, and within ``D_LT_K_CEILING`` of the nearer of the two. One
    launch of the kernel that the width takes."""
    b = 21
    table, cols, vals, mask, x0 = _als_problem(dev, 500, k, b, d, k * d + 7)
    table = table.to(dtype)
    frac = torch.from_numpy(np.random.default_rng(d).choice(
        np.float32([0.25, 0.5, 0.7, 1.0, 1.5]), (b, d))).to(dev)
    rows8 = als_kernels.rows_form(d, k)
    counter = (als_kernels.ALS_SOLVE_CG_ROWS8_LAUNCHES if rows8
               else als_kernels.ALS_SOLVE_CG_LAUNCHES)
    tol = 1e-4 if dtype == torch.float32 and d >= k else 1e-3
    for weights in (mask, mask * frac):
        for warm in (None, x0):
            ref = als_kernels.als_solve_cg_plain(table, cols, vals, weights,
                                                 0.05, x0=warm)
            before = counter.value
            got = als_kernels.als_solve_cg(table, cols, vals, weights, 0.05,
                                           rows_per_program=8, x0=warm)
            torch.cuda.synchronize()
            assert counter.value == before + 1
            assert bool(torch.isfinite(got).all())
            if _rel(got, ref) >= tol and d < k:
                exact = _f64_two_stage(table, cols, vals.to(dtype).float(),
                                       weights, 0.05, 16, warm)
                k_f64 = _rel(got.double(), exact)
                assert k_f64 <= 3 * _rel(ref.double(), exact) + 1e-6
                assert min(_rel(got, ref), k_f64) <= D_LT_K_CEILING, (
                    warm is None)
            else:
                assert _rel(got, ref) < tol, (warm is None,)


def test_als_rows_per_block_fit_shared_memory(dev):
    """The R-row form's rows a block: 1 to 8, their blocks within 227 KB
    of shared memory, 8 at the stored path's narrow widths in bf16, and 0
    (the one-row plan) past the padded rank or above rank 128."""
    lib = runtime.build_kernels()
    for k in (16, 32, 64, 128):
        kp = als_kernels.padded_rank(k)
        for d in (1, 8, 16, 32, 64, 128):
            for bf16, size in ((0, 4), (1, 2)):
                r = lib.pio_als_group_rows(d, k, bf16)
                if d > kp:
                    assert r == 0
                    continue
                # the row's block, then its f64 vectors u and p
                per = d * (kp + 16 // size) * size + 8 * (-(-d // 2) * 2
                                                          + kp)
                assert 1 <= r <= 8 and r * per <= 232_448, (k, d, bf16, r)
                if d <= 64 and bf16:
                    assert r == 8
    assert lib.pio_als_group_rows(8, 160, 0) == 0
    assert lib.pio_als_group_rows(129, 128, 1) == 0


def test_als_wrong_dtype_or_device_raises(dev):
    table, cols, vals, mask, x0 = _als_problem(dev, 150, 24, 13, 300, 2)
    with pytest.raises(ValueError):  # one tensor on the CPU
        als_kernels.als_solve_cg(table, cols.cpu(), vals, mask, 0.05)
    with pytest.raises(ValueError):
        als_kernels.als_fused_solve_cg(table, cols, vals, mask, 0.05,
                                       x0=x0.cpu())
    with pytest.raises(TypeError):
        als_kernels.als_solve_cg(table.double(), cols, vals, mask, 0.05)
    with pytest.raises(TypeError):
        als_kernels.als_fused_solve_cg(table, cols.long(), vals, mask, 0.05)
    with pytest.raises(ValueError):  # rank above the kernels' MAX_RANK
        als_kernels.als_fused_solve_cg(
            torch.zeros((150, als_kernels.MAX_RANK + 1), device=dev), cols,
            vals, mask, 0.05)


@pytest.mark.parametrize("m,k,b,d", ALS_EDGE_SHAPES + [
    (700, 129, 6, 400), (800, 160, 4, 3000), (900, 256, 3, 9000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_als_fused_one_slice_and_many(dev, m, k, b, d, dtype):
    """The fused entry under a one-slice plan and a many-slice plan on the
    same rows, cold and warm, explicit and implicit: each within the
    tolerance of the plain version, empty rows exactly 0; beyond it a
    D < K system is held to its f64 solve (no more than 3x as far from it
    as the plain version)."""
    table, cols, vals, mask, x0 = _als_problem(dev, m, k, b, d, k + d + 1)
    table = table.to(dtype)
    tol = 1e-4 if dtype == torch.float32 and d >= k else 1e-3
    for implicit in (False, True):
        yty = table.float().T @ table.float() if implicit else None
        iters = 32 if implicit else 16
        for warm in (None, x0):
            ref = als_kernels.als_fused_solve_cg_plain(
                table, cols, vals, mask, 0.05, True, iters, implicit, 2.0,
                yty, warm)
            for n in (1, 1000):
                got = als_kernels._fused(table, cols, vals, mask, 0.05, True,
                                         iters, implicit, 2.0, yty, warm,
                                         n_sms=n)
                torch.cuda.synchronize()
                assert (got[mask.sum(-1) == 0] == 0).all()
                if _rel(got, ref) >= tol and d < k:
                    exact = _f64_fused(table, cols, vals.to(dtype).float(),
                                       mask, 0.05, iters, warm, yty)
                    assert _rel(got.double(), exact) <= \
                        3 * _rel(ref.double(), exact) + 1e-6
                else:
                    assert _rel(got, ref) < tol, (n, implicit,
                                                  warm is None)


# (m, k, b, d): rank 128 with one slice (its CG from the accumulators) and
# many, a padded rank below 128, and the 128 x 128 tiles above it
ALS_FRACTION_SHAPES = [(500, 128, 6, 300), (400, 64, 6, 700),
                       (800, 256, 4, 500)]


@pytest.mark.parametrize("m,k,b,d", ALS_FRACTION_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_als_fractional_mask_matches_plain(dev, m, k, b, d, dtype):
    """A mask of weights other than 0 and 1 (the buckets hold only those)
    weighs the rows as the plain versions do: the fused entry's Gram
    Σ mask·t·tᵀ (in bf16 the weighted rows rounded, an asymmetric Gram),
    the two-stage entry's rows table[cols] * mask. Every row fractional, or
    one row only (the others take the unweighted triangle), cold and warm,
    one slice and many, R = 1 and 8: each within the tolerance of the plain
    version, the empty row exactly 0 from the fused entry."""
    table, cols, vals, mask, x0 = _als_problem(dev, m, k, b, d, k + d + 2)
    table = table.to(dtype)
    rng = np.random.default_rng(k + d)
    frac = torch.from_numpy(rng.choice(
        np.float32([0.25, 0.5, 0.7, 1.0, 1.5]), (b, d))).to(dev)
    one_row = mask.clone()
    one_row[0] *= frac[0]
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    for weights in (mask * frac, one_row):
        for warm in (None, x0):
            args = (table, cols, vals, weights, 0.05, True, 16)
            ref = als_kernels.als_fused_solve_cg_plain(*args, x0=warm)
            for n in (1, 1000):
                got = als_kernels._fused(*args, False, 1.0, None, warm,
                                         n_sms=n)
                torch.cuda.synchronize()
                assert (got[weights.sum(-1) == 0] == 0).all()
                assert _rel(got, ref) < tol, ("fused", n, warm is None)
            ref = als_kernels.als_solve_cg_plain(*args, x0=warm)
            for rows, n in ((1, 1), (1, 1000), (8, None)):
                got = als_kernels._two_stage(*args, rows, warm, n_sms=n)
                torch.cuda.synchronize()
                assert _rel(got, ref) < tol, ("two", rows, n, warm is None)


def _f64_fused(table, cols, vals, mask, l2, iters, x0, yty=None):
    """The fused bucket solve in f64 (implicit with ``yty``: confidences
    2·vals, plain λ); empty rows exactly 0."""
    t = table.double()[cols]
    m = mask.double()
    gw = 2.0 * vals.double() * m if yty is not None else m
    rw = m + gw if yty is not None else vals.double() * m
    gram = torch.einsum("bdk,bdl->bkl", t * gw[..., None], t)
    rhs = torch.einsum("bd,bdk->bk", rw, t)
    nnz = m.sum(-1)
    lam = torch.full_like(nnz, l2) if yty is not None \
        else l2 * nnz.clamp(min=1.0)
    x = als_kernels.cg_plain(gram, rhs, lam, iters,
                             None if x0 is None else x0.double(),
                             None if yty is None else yty.double())
    return torch.where(nnz[:, None] > 0, x, torch.zeros_like(x))


def test_als_above_rank_128_answers(dev):
    """Above rank 128 training answers through the kernels, as the
    reference trains at any rank: ``als_train`` at rank 160 and 256 through
    the kernels (every bucket, both entries) launches them and fits within
    the parity bound of the plain route from the same initial state."""
    rng = np.random.default_rng(4)
    n_u, n_i = 300, 280
    u = rng.normal(size=(n_u, 4)) / 2
    v = rng.normal(size=(n_i, 4)) / 2
    users, items = np.nonzero(rng.random((n_u, n_i)) < 0.8)
    ratings = (u @ v.T + 3.0)[users, items].astype(np.float32)
    trees = als.prepare_trees(users, items, ratings, n_u, n_i, device=dev)
    for rank in (160, 256):
        init = als.als_init(torch.Generator().manual_seed(0), n_u, n_i,
                            rank, device=dev)
        fits = []
        for use_kernel in (True, False):
            runtime.reset_launch_counts()
            st = als._mixed_run(init, trees[0], trees[1], 0.05, 3, 1, True,
                                torch.float32, trees[2], trees[3],
                                use_kernel=use_kernel, kernel_min_d=0,
                                use_fused=(True, False))
            counts = runtime.launch_counts()
            assert (counts["als_fused_solve_cg"] > 0) == use_kernel
            assert (counts["als_solve_cg"] > 0) == use_kernel
            assert torch.isfinite(st.user_factors).all()
            fits.append(als.rmse(st, users, items, ratings))
        assert fits[0] < max(1.15 * fits[1], fits[1] + 0.02), (rank, fits)
    state, _ = als.als_train(users, items, ratings, n_u, n_i, rank=160,
                             iterations=2, device=dev)
    assert tuple(state.user_factors.shape) == (n_u, 160)


def test_als_train_on_the_card_matches_plain_route(dev):
    """A small training through the kernels (every bucket routed to them)
    fits as well as the plain route from the same initial state."""
    rng = np.random.default_rng(3)
    n_u, n_i = 300, 200
    u = rng.normal(size=(n_u, 4)) / 2
    v = rng.normal(size=(n_i, 4)) / 2
    users, items = np.nonzero(rng.random((n_u, n_i)) < 0.4)
    ratings = (u @ v.T + 3.0)[users, items].astype(np.float32)
    trees = als.prepare_trees(users, items, ratings, n_u, n_i, device=dev)
    init = als.als_init(torch.Generator().manual_seed(0), n_u, n_i, 16,
                        device=dev)
    fits = []
    for use_kernel in (True, False):
        runtime.reset_launch_counts()
        st = als._mixed_run(init, trees[0], trees[1], 0.02, 6, 3, True,
                            torch.float32, trees[2], trees[3],
                            use_kernel=use_kernel, kernel_min_d=0,
                            use_fused=(True, False))
        counts = runtime.launch_counts()
        launched = counts["als_fused_solve_cg"] + counts["als_solve_cg"]
        assert (launched > 0) == use_kernel
        fits.append(als.rmse(st, users, items, ratings))
    assert fits[0] < max(1.15 * fits[1], fits[1] + 0.02), fits
    assert fits[0] < 0.1, fits


@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("k", [16, 64, 128])
def test_als_implicit_sweep_takes_the_fused_entry(dev, d, k):
    """An implicit half-sweep on the card: every bucket, however narrow,
    through the fused entry with the shared YᵀY (never the R-row form,
    which has no YᵀY term), within 1e-3 of max|x| of the plain route on
    the same tensors."""
    rng = np.random.default_rng(d * 1000 + k)
    m, b = 600, 300
    cols = torch.from_numpy(rng.integers(0, m, (b, d)).astype(np.int32))
    lens = rng.integers(1, d + 1, b)
    mask = torch.from_numpy(
        (np.arange(d)[None, :] < lens[:, None]).astype(np.float32))
    vals = torch.from_numpy(rng.uniform(0.5, 5, (b, d)).astype(np.float32))
    tree = ((torch.arange(b).to(dev), cols.to(dev), (vals * mask).to(dev),
             mask.to(dev)),)
    other = torch.from_numpy(
        (0.3 * rng.standard_normal((m, k))).astype(np.float32)).to(dev)
    prev = torch.from_numpy(
        (0.1 * rng.standard_normal((b, k))).astype(np.float32)).to(dev)
    outs = []
    for use_kernel in (True, False):
        runtime.reset_launch_counts()
        outs.append(als._sweep_side(b, other, tree, None, 0.05, True,
                                    torch.float32, use_kernel=use_kernel,
                                    prev_factors=prev, use_fused=True,
                                    implicit=True, alpha=1.0))
        counts = runtime.launch_counts()
        assert counts["als_fused_solve_cg"] == int(use_kernel)
        assert counts["als_solve_cg_rows8"] == counts["als_solve_cg"] == 0
    err = float((outs[0] - outs[1]).abs().max() / outs[1].abs().max())
    assert err < 1e-3, err


def _live_rows(tree):
    """{width: (row_ids, cols, vals, mask)} of a side's live rows, in row
    order."""
    out = {}
    for rids, cols, vals, mask in tree:
        live = rids >= 0
        if bool(live.any()):
            out.setdefault(cols.shape[1], []).append(
                (rids[live], cols[live], vals[live], mask[live]))
    merged = {}
    for w, parts in out.items():
        rids, cols, vals, mask = (torch.cat(x) for x in zip(*parts))
        order = torch.argsort(rids)
        merged[w] = (rids[order], cols[order], vals[order], mask[order])
    return merged


def test_plan_reuse_on_the_device(dev):
    """``prepare_with_reuse`` on the card: after a tail (new pairs, new
    users and items), the spliced resident trees equal a fresh build bit
    for bit, and a continuation from a state on the card trains from
    them."""
    from incubator_predictionio_tpu_torch.ops import retrain

    rng = np.random.default_rng(13)
    n_u, n_i = 400, 300
    users = rng.integers(0, n_u, 12_000)
    items = rng.integers(0, n_i, 12_000)
    vals = rng.uniform(1, 5, 12_000).astype(np.float32)
    t_u = np.r_[rng.integers(0, n_u, 600), np.arange(n_u, n_u + 20)]
    t_i = np.r_[rng.integers(0, n_i, 600), rng.integers(0, n_i + 10, 20)]
    t_v = rng.uniform(1, 5, 620).astype(np.float32)
    u2, i2, v2 = (np.r_[users, t_u], np.r_[items, t_i], np.r_[vals, t_v])
    retrain.drop_plans()
    try:
        base = retrain.als_retrain(users, items, vals, n_u, n_i, rank=16,
                                   iterations=3, l2=0.05, plan_key="dev",
                                   device=dev)
        stats = {}
        got = retrain.prepare_with_reuse(u2, i2, v2, n_u + 20, n_i + 10,
                                         plan_key="dev", stats=stats,
                                         device=dev)
        assert stats["prep_plan"] == "reused"
        assert stats["prep_delta_rows"] == 620
        fresh = als.prepare_trees(u2, i2, v2, n_u + 20, n_i + 10,
                                  device=dev)
        # the same rows at the same widths, the same entries in the same
        # slots, bit for bit (the layout differs: cleared slots, appended
        # buckets)
        for x, y in zip(got[:2], fresh[:2]):
            rx, ry = _live_rows(x), _live_rows(y)
            assert set(rx) == set(ry)
            for w in rx:
                for p, q in zip(rx[w], ry[w]):
                    assert p.device.type == "cuda" and torch.equal(p, q)
        stats = {}
        st = retrain.als_retrain(u2, i2, v2, n_u + 20, n_i + 10, rank=16,
                                 iterations=3, l2=0.05, prev_state=base,
                                 stats=stats, device=dev)
        assert stats["mode"] == "continue"
        assert st.user_factors.device.type == "cuda"
        assert tuple(st.user_factors.shape) == (n_u + 20, 16)
        assert torch.isfinite(st.user_factors).all()
    finally:
        retrain.drop_plans()


# -- flash attention (ops/attention_kernels.py → csrc/flash_attention.cu) -----

# (b, s_q, s_kv, h, d, causal, valid lengths or None, dtype)
FLASH_SHAPES = [
    (2, 100, 100, 2, 32, True, None, torch.float32),
    (2, 100, 100, 2, 32, False, None, torch.float32),
    (2, 40, 40, 2, 16, True, (17, 33), torch.float32),
    (1, 1, 64, 2, 32, False, None, torch.float32),
    (1, 1, 64, 2, 32, True, None, torch.float32),
    (2, 300, 100, 2, 8, True, None, torch.float32),
    (2, 100, 300, 3, 24, True, (250, 0), torch.float32),
    (2, 200, 200, 2, 128, True, (150, 7), torch.bfloat16),
    (1, 2048, 2048, 2, 64, True, (1000,), torch.bfloat16),
]


def _flash_inputs(dev, b, s_q, s_kv, h, d, lengths, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(dev).to(dtype)
               for shape in ((b, s_q, h, d), (b, s_kv, h, d),
                             (b, s_kv, h, d)))
    valid = None
    if lengths is not None:
        valid = torch.zeros((b, s_kv), dtype=torch.bool, device=dev)
        for r, n in enumerate(lengths):
            if n:
                valid[r, s_kv - n:] = True   # left padding, as SASRec
    return q, k, v, valid


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_matches_plain(dev, shape):
    b, s_q, s_kv, h, d, causal, lengths, dtype = shape
    q, k, v, valid = _flash_inputs(dev, b, s_q, s_kv, h, d, lengths, dtype,
                                   s_q + d)
    before = attention_kernels.FLASH_LAUNCHES.value
    got = attention_kernels.flash_attention(q, k, v, causal=causal,
                                            kv_valid=valid)
    assert attention_kernels.FLASH_LAUNCHES.value == before + 1
    ref = attention_kernels.flash_attention_plain(q, k, v, causal=causal,
                                                  kv_valid=valid)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, s_q, h, d)
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-4
    err = (got.float() - ref.float()).abs().max()
    assert err <= tol * ref.float().abs().max()
    if valid is not None:
        pos = torch.arange(s_q, device=dev)[:, None]
        keys = torch.arange(s_kv, device=dev)[None, :]
        live = valid[:, None, :] & ((pos >= keys) if causal else True)
        dead = ~live.any(-1)
        assert (got[dead] == 0).all()


def _holes(b, s):
    """Of every three 64-key tiles only the first has valid keys, every
    fifth of them invalid: live tiles with whole dead ones between."""
    key = np.arange(s)[None, :]
    return ((key // 64) % 3 == 0) & ((key - 1 - np.arange(b)[:, None]) % 5
                                     != 0)


def _one_key(b, s, keys):
    valid = np.zeros((b, s), bool)
    valid[np.arange(b), list(keys)] = True
    return valid


def _left(b, s, lengths):
    valid = np.zeros((b, s), bool)
    for r, n in enumerate(lengths):
        if n:
            valid[r, s - n:] = True
    return valid


_W = 8192
# (name, b, s_q, s_kv, h, d, causal, valid [b, s_kv]): the cases the tile
# skip and the tensor-core fragments can get wrong
SKIP_SHAPES = [
    ("holes", 2, 1024, 1024, 2, 32, True, _holes(2, 1024)),
    ("holes_not_causal", 1, 640, 640, 2, 64, False, _holes(1, 640)),
    ("one_key", 2, 512, 512, 2, 32, True, _one_key(2, 512, (192, 255))),
    ("one_key_not_causal", 2, 512, 512, 2, 32, False,
     _one_key(2, 512, (192, 255))),
    ("left_pads", 10, _W, _W, 2, 32, True,
     _left(10, _W, (0, 1, 63, 64, 65, _W - 65, _W - 64, _W - 63, _W - 1,
                    _W))),
    ("dead_q_tiles", 1, 1000, 1000, 2, 32, True, _left(1, 1000, (360,))),
    ("sq_lt_skv_pad", 2, 130, 700, 2, 32, True, _holes(2, 700)),
    ("sq_gt_skv_pad", 2, 700, 130, 2, 32, True, _left(2, 130, (100, 0))),
] + [(f"d{d}_holes", 2, 333, 333, 2, d, True, _holes(2, 333))
     for d in (8, 24, 80, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SKIP_SHAPES, ids=[c[0] for c in SKIP_SHAPES])
def test_flash_skip_cases_match_plain(dev, case, dtype):
    """Whole dead key tiles (skipped), holes, single live keys at a tile's
    edges, different left padding per row, dead query tiles, Sq != Skv
    with padding and head widths 8 to 128: the kernel against its plain
    version, and a query with no live key exactly 0."""
    name, b, s_q, s_kv, h, d, causal, valid_np = case
    rng = np.random.default_rng(len(name) + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(dev).to(dtype)
               for shape in ((b, s_q, h, d), (b, s_kv, h, d),
                             (b, s_kv, h, d)))
    valid = torch.from_numpy(valid_np).to(dev)
    got = attention_kernels.flash_attention(q, k, v, causal=causal,
                                            kv_valid=valid)
    ref = attention_kernels.flash_attention_plain(q, k, v, causal=causal,
                                                  kv_valid=valid)
    torch.cuda.synchronize()
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-4
    assert (got.float() - ref.float()).abs().max() \
        <= tol * ref.float().abs().max()
    pos = torch.arange(s_q, device=dev)[:, None]
    keys = torch.arange(s_kv, device=dev)[None, :]
    live = (valid[:, None, :] & ((pos >= keys) if causal else True)).any(-1)
    live = live.expand(b, s_q)
    assert (got[~live] == 0).all()
    assert (got[live].float().abs().sum(-1) > 0).all()


def test_flash_strided_views_match_contiguous(dev):
    """BSHD read through strides: q, k, v as views of one fused [B, S,
    3, H, D] projection."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 300, 3, 2, 32),
                                               np.float32)).to(dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = attention_kernels.flash_attention(q, k, v)
    ref = attention_kernels.flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_flash_gradient_matches_plain_autograd(dev):
    q, k, v, valid = _flash_inputs(dev, 2, 300, 300, 2, 32, (250, 40),
                                   torch.float32, 5)
    grads = []
    for fn in (attention_kernels.flash_attention,
               attention_kernels.flash_attention_plain):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        (fn(qq, kk, vv, kv_valid=valid) ** 2).sum().backward()
        grads.append((qq.grad, kk.grad, vv.grad))
    for got, ref in zip(*grads):
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_flash_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros((1, 16, 2, 32), device=dev)
    with pytest.raises(ValueError):   # k on the CPU
        attention_kernels.flash_attention(q, q.cpu(), q)
    with pytest.raises(TypeError):
        attention_kernels.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        attention_kernels.flash_attention(q, q.half(), q)


# (b, s, h, d, valid lengths or None, dtype): heads wider than 128 (the
# D-tiled kernel: one and two output-column blocks, a partial one), and
# more than 65,535 batch x heads (grid x)
FLASH_WIDE = [
    (2, 200, 2, 160, (150, 7), torch.float32),
    (2, 200, 2, 160, (150, 7), torch.bfloat16),
    (1, 300, 2, 256, None, torch.float32),
    (1, 300, 2, 256, (1,), torch.bfloat16),
    (1, 130, 1, 200, (0,), torch.float32),
    (2, 130, 1, 200, (65, 0), torch.bfloat16),
    (2, 333, 2, 192, (333, 64), torch.float32),
    (2, 333, 2, 192, (1, 300), torch.bfloat16),
    (1, 200, 1, 320, (150,), torch.float32),  # above 256: the D-tiled kernel
    (65_536, 16, 1, 8, None, torch.float32),
    (256, 20, 256, 16, None, torch.bfloat16),
    (256, 20, 256, 160, (20, 3) * 128, torch.bfloat16),
    (256, 20, 256, 256, None, torch.float32),
]


@pytest.mark.parametrize("shape", FLASH_WIDE)
def test_flash_wide_heads_and_many_heads(dev, shape):
    """Head widths above 128 and B·H above 65,535 answer through the
    kernel, as the reference's kernel pads only S: within the tolerance of
    the plain version, a row with no live key exactly 0, one launch."""
    b, s, h, d, lengths, dtype = shape
    q, k, v, valid = _flash_inputs(dev, b, s, s, h, d, lengths, dtype, d + s)
    before = attention_kernels.FLASH_LAUNCHES.value
    got = attention_kernels.flash_attention(q, k, v, kv_valid=valid)
    torch.cuda.synchronize()
    assert attention_kernels.FLASH_LAUNCHES.value == before + 1
    ref = attention_kernels.flash_attention_plain(q, k, v, kv_valid=valid)
    tol = 1e-4 if dtype == torch.float32 else 8e-3
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol * float(ref.float().abs().max()), err
    if lengths is not None:
        for r, n in enumerate(lengths):
            # causal, left padded: queries before the first live key are 0
            assert (got[r, :s - n] == 0).all()


# (name, b, s_q, s_kv, h, causal, valid [b, s_kv]): the tile skip, masks
# and Sq != Skv at the widths of flash_wide_kernel
WIDE_SKIP = [
    ("holes", 2, 640, 640, 2, True, _holes(2, 640)),
    ("holes_not_causal", 1, 640, 640, 2, False, _holes(1, 640)),
    ("one_key", 2, 512, 512, 2, True, _one_key(2, 512, (192, 255))),
    ("one_key_not_causal", 2, 512, 512, 1, False,
     _one_key(2, 512, (0, 511))),
    ("left_pads", 6, 1024, 1024, 2, True,
     _left(6, 1024, (0, 1, 63, 64, 65, 1024))),
    ("sq_lt_skv_pad", 2, 130, 700, 2, True, _holes(2, 700)),
    ("sq_gt_skv_pad", 2, 700, 130, 2, True, _left(2, 130, (100, 0))),
]


@pytest.mark.parametrize("d", [160, 192, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WIDE_SKIP, ids=[c[0] for c in WIDE_SKIP])
def test_flash_wide_skip_cases_match_plain(dev, case, dtype, d):
    """Heads of 160-256 on the tensor cores: holes, one live key, left
    padding, a row with no live key, Sq != Skv, causal and not, against
    the plain version (1e-4 of max|out| in f32, 8e-3 in bf16), a query
    with no live key exactly 0 and every other one not."""
    name, b, s_q, s_kv, h, causal, valid_np = case
    rng = np.random.default_rng(len(name) + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(dev).to(dtype)
               for shape in ((b, s_q, h, d), (b, s_kv, h, d),
                             (b, s_kv, h, d)))
    valid = torch.from_numpy(valid_np).to(dev)
    before = attention_kernels.FLASH_LAUNCHES.value
    got = attention_kernels.flash_attention(q, k, v, causal=causal,
                                            kv_valid=valid)
    ref = attention_kernels.flash_attention_plain(q, k, v, causal=causal,
                                                  kv_valid=valid)
    torch.cuda.synchronize()
    assert attention_kernels.FLASH_LAUNCHES.value == before + 1
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-4
    assert (got.float() - ref.float()).abs().max() \
        <= tol * ref.float().abs().max()
    pos = torch.arange(s_q, device=dev)[:, None]
    keys = torch.arange(s_kv, device=dev)[None, :]
    live = (valid[:, None, :] & ((pos >= keys) if causal else True)).any(-1)
    live = live.expand(b, s_q)
    assert (got[~live] == 0).all()
    assert (got[live].float().abs().sum(-1) > 0).all()


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_wide_strided_views_and_sdpa(dev, d, dtype):
    """Wide heads read through strides (views of one fused [B, S, 3, H, D]
    projection) give the contiguous inputs' output bit for bit, and agree
    with SDPA on every key valid, causal, at the tolerance of the plain
    version."""
    rng = np.random.default_rng(d)
    qkv = torch.from_numpy(rng.standard_normal((2, 300, 3, 2, d),
                                               np.float32)).to(dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = attention_kernels.flash_attention(q, k, v)
    ref = attention_kernels.flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous())
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        *(t.transpose(1, 2).float() for t in (q, k, v)),
        is_causal=True).transpose(1, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-4
    assert (got.float() - sdpa).abs().max() <= tol * sdpa.abs().max()


def test_sequence_model_serves_through_the_kernel(dev):
    """At a window of FLASH_MIN_SEQ the served forward launches the kernel
    once per layer and matches the plain route."""
    from incubator_predictionio_tpu_torch.models.sequence import (
        convert,
        engine,
    )
    from incubator_predictionio_tpu_torch.ops import transformer
    from incubator_predictionio_tpu_torch.utils import planted

    window = transformer.FLASH_MIN_SEQ
    fields = planted.random_transformer_fields(300, window + 1, 32, 2,
                                               seed=1)
    model = convert.seqrec_model_from_numpy(
        fields, [f"i{i}" for i in range(300)], 2, window + 1, device=dev)
    algo = engine.SeqRecAlgorithm(engine.SeqRecAlgorithmParams(app_name="a"))
    before = attention_kernels.FLASH_LAUNCHES.value
    got = algo.predict(model, engine.Query(
        user="u", num=5, recent_items=tuple(f"i{i}" for i in range(40))))
    assert attention_kernels.FLASH_LAUNCHES.value == before + 2
    tokens = torch.zeros((1, window), dtype=torch.int32, device=dev)
    tokens[0, -40:] = torch.arange(1, 41, device=dev)
    h = transformer.transformer_apply(
        model.weights, tokens, 2,
        attn_fn=attention_kernels.flash_attention_plain)
    scores = (h[0, -1] @ model.weights.item_emb.T).cpu()
    scores[:41] = float("-inf")
    top = torch.sort(scores, descending=True, stable=True)
    assert [s.item for s in got.item_scores] == \
        [f"i{int(i) - 1}" for i in top.indices[:5]]
    np.testing.assert_allclose([s.score for s in got.item_scores],
                               top.values[:5].numpy(), rtol=1e-4)


# -- the speed layer's fold-in (speed/foldin.py → the fused entry) ----------

@pytest.mark.parametrize("width", [8, 32, 128, 512])
@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("rank", [10, 128])
def test_foldin_on_the_card_matches_plain(dev, width, batch, implicit, rank):
    """``FoldInSolver`` on a CUDA table against the same solver on the
    CPU (the fused entry's plain version): every ladder width at batch 1,
    8 and 64, explicit and implicit, at rank 10 and 128; one fused
    launch a bucket; empty rows exactly 0. Held by
    ``chip_smoke.hold_foldin``: ``chip_smoke.als_tolerance``, and rows
    beyond it (only rows with fewer observations than the rank may be) no
    more than 3x as far from the f64 solve as the plain version."""
    import chip_smoke
    from incubator_predictionio_tpu_torch.speed.foldin import FoldInSolver

    rng = np.random.default_rng(width * batch + rank)
    table = rng.normal(0, 0.3, (3000, rank)).astype(np.float32)
    rows = []
    for r in range(batch):
        d = 0 if r == batch - 1 and batch > 1 else int(
            rng.integers(width // 4 + 1, width + 1))
        rows.append((rng.integers(0, 3000, d).astype(np.int32),
                     np.abs(rng.normal(3.0, 1.0, d)).astype(np.float32)))
    kw = dict(l2=0.05, implicit=implicit, alpha=1.0)
    before = als_kernels.ALS_FUSED_SOLVE_CG_LAUNCHES.value
    got = FoldInSolver(torch.from_numpy(table).to(dev), **kw).solve(rows)
    assert als_kernels.ALS_FUSED_SOLVE_CG_LAUNCHES.value == before + 1
    ref = FoldInSolver(table, device="cpu", **kw).solve(rows)
    chip_smoke.hold_foldin(als_kernels, als, torch.from_numpy(table).to(dev),
                           rows, got, ref, 0.05, implicit, 1.0,
                           f"fold-in width {width} B {batch}", trained=False)
    if batch > 1:
        assert (got[-1] == 0).all()


def test_foldin_overlay_polls_on_a_thread_while_queries_score(dev,
                                                              monkeypatch):
    """The overlay's poller launches the fused kernel from its own thread
    while another thread launches score+top-k; both agree with their
    plain versions."""
    import threading

    from incubator_predictionio_tpu_torch.data.datamap import DataMap
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.storage import App, Storage
    from incubator_predictionio_tpu_torch.data.store import EventStore
    from incubator_predictionio_tpu_torch.speed.foldin import FoldInSolver
    from incubator_predictionio_tpu_torch.speed.overlay import (
        SpeedOverlay,
        SpeedOverlayConfig,
    )

    Storage.configure({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    try:
        Storage.get_meta_data_apps().insert(App(0, "thr"))
        rng = np.random.default_rng(0)
        items = torch.from_numpy(
            rng.normal(0, 0.3, (5000, 64)).astype(np.float32)).to(dev)
        ov = SpeedOverlay(SpeedOverlayConfig(
            app_name="thr", value_prop="rating", l2=0.05), items,
            {f"i{k}": k for k in range(5000)})
        ov.start(interval_s=0.01)
        stop = threading.Event()
        errors = []

        def query():
            while not stop.is_set():
                q = items[int(rng.integers(5000))][None]
                s, _i = kernels.score_topk(q, items, None, 10)
                r, _j = kernels.score_topk_plain(q, items, None, 10)
                if not torch.allclose(s, r, rtol=1e-5, atol=1e-5):
                    errors.append((s, r))

        t = threading.Thread(target=query)
        t.start()
        hist = {}
        for u in range(40):
            its = rng.choice(5000, 6, replace=False)
            hist[f"u{u}"] = its
            EventStore.write([Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=DataMap({"rating": 4.0})) for i in its], "thr")
        import time

        # a user's events may reach two polls (the writes are not one
        # append), so wait until every user is covered and none is dirty
        deadline = time.monotonic() + 30
        while (ov.stats()["dirty"] or not all(ov.covers(u) for u in hist)) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        stop.set()
        t.join()
        ov.stop()
        assert not errors and ov.stats()["foldins"] >= 40
        plain = FoldInSolver(items.cpu(), l2=0.05)
        for u, its in hist.items():
            ref = plain.solve([(its.astype(np.int32),
                                np.full(6, 4.0, np.float32))])[0]
            assert np.max(np.abs(ov.lookup(u) - ref)) <= \
                1e-3 * np.max(np.abs(ref))
    finally:
        Storage.reset()


# -- the serving scheduler: two dispatchers beside a fold-in poller ----------

def test_scheduler_dispatchers_at_every_rung_beside_a_foldin_poller(dev):
    """The prediction server's scheduler with two dispatcher threads
    drains 2,048 queued queries up the pow2 ladder to B 512 (each batch
    one score+top-k launch) while a speed overlay's poller folds new users
    in on the same item table from a thread of its own; every answer holds
    against the plain top-k on its row, every folded vector against the
    plain fold-in (``chip_smoke.hold_foldin``)."""
    import json
    import threading
    import time

    from incubator_predictionio_tpu_torch.core.params import EngineParams
    from incubator_predictionio_tpu_torch.data.datamap import DataMap
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.storage import App, Storage
    from incubator_predictionio_tpu_torch.data.store import EventStore
    from incubator_predictionio_tpu_torch.models.recommendation import (
        convert,
        engine,
    )
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer,
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.speed.foldin import FoldInSolver
    from incubator_predictionio_tpu_torch.speed.overlay import (
        SpeedOverlay,
        SpeedOverlayConfig,
    )

    rng = np.random.default_rng(3)
    n_users, n_items, rank = 4096, 26_744, 128
    uf = rng.normal(0, 0.3, (n_users, rank)).astype(np.float32)
    itf = rng.normal(0, 0.3, (n_items, rank)).astype(np.float32)
    model = convert.als_model_from_numpy(
        uf, itf, [f"u{i}" for i in range(n_users)],
        [f"i{i}" for i in range(n_items)], device=dev)
    Storage.configure({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    srv = ov = None
    first_in, gate = threading.Event(), threading.Event()
    try:
        Storage.get_meta_data_apps().insert(App(0, "sched"))
        srv = PredictionServer(
            engine.RecommendationEngine().apply(),
            EngineParams(algorithm_params_list=[
                ("als", engine.ALSAlgorithmParams(rank=rank))]),
            [model], device=dev,
            config=ServerConfig(ip="127.0.0.1", port=0, micro_batch=512,
                                serve_workers=2))
        srv.start_background()
        items_t = srv.models[0].item_factors
        widths = []
        handle = srv._handle_batch

        def gated(bodies, engine_id, tenant):
            first_in.set()
            gate.wait(60)
            widths.append(len(bodies))
            return handle(bodies, engine_id, tenant)

        srv._batcher._handle_batch = gated
        ov = SpeedOverlay(SpeedOverlayConfig(
            app_name="sched", value_prop="rating", l2=0.05), items_t,
            {f"i{k}": k for k in range(n_items)})
        ov.start(interval_s=0.01)
        hist = {}

        def writer():
            wrng = np.random.default_rng(4)
            for u in range(40):
                its = wrng.choice(n_items, 6, replace=False)
                hist[f"new{u}"] = its
                EventStore.write([Event(
                    event="rate", entity_type="user", entity_id=f"new{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=DataMap({"rating": 4.0})) for i in its],
                    "sched")
                time.sleep(0.02)

        w = threading.Thread(target=writer, daemon=True)
        runtime.reset_launch_counts()
        w.start()
        users = rng.integers(0, n_users, 2048)
        futs = [srv._batcher.submit(json.dumps(
            {"user": f"u{users[0]}", "num": 10}).encode())]
        assert first_in.wait(60)
        futs += [srv._batcher.submit(json.dumps(
            {"user": f"u{u}", "num": 10}).encode()) for u in users[1:]]
        gate.set()
        answers = [f.result(120) for f in futs]
        launches = runtime.launch_counts()["score_topk"]
        w.join(60)
        # a user's events may reach two polls, so wait until every user is
        # covered and none is dirty
        deadline = time.monotonic() + 30
        while (ov.stats()["dirty"] or not all(ov.covers(u) for u in hist)) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        ov.stop()
        assert ov.stats()["foldins"] >= 40
        # six observations at rank 128: held by chip_smoke's fold-in rule
        # (als_tolerance, then the f64 3x rule for rows with D < K)
        import chip_smoke

        rows = [(its.astype(np.int32), np.full(6, 4.0, np.float32))
                for its in hist.values()]
        chip_smoke.hold_foldin(
            als_kernels, als, items_t, rows,
            np.stack([ov.lookup(u) for u in hist]),
            FoldInSolver(items_t.cpu(), l2=0.05).solve(rows), 0.05, False,
            1.0, "fold-ins beside the dispatchers", trained=False)
    finally:
        gate.set()
        if ov is not None:
            ov.stop()
        if srv is not None:
            srv.stop()
        Storage.reset()
    assert max(widths) == 512 and sum(widths) == 2048
    assert launches == len(widths)
    uf_t = torch.from_numpy(uf).to(dev)
    ref_s, ref_i = kernels.score_topk_plain(
        uf_t[torch.from_numpy(users).to(dev)], items_t, None, 11)
    ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
    got = [json.loads(a)["itemScores"] for a in answers]
    got_s = np.array([[x["score"] for x in g] for g in got], np.float32)
    got_i = np.array([[int(x["item"][1:]) for x in g] for g in got])
    _near_tie_equal(got_s, got_i, ref_s, ref_i)


@pytest.mark.parametrize("quant", ["int8", "bf16", "pq"])
def test_mips_two_stage_on_the_card_matches_its_cpu_run(dev, monkeypatch,
                                                        quant):
    """One index built on the card (262,144 × 64, the JAX bench's middle
    size) and the same index's tensors copied to the CPU: the two-stage
    route's answers at B 1 and 64 agree as ids except near-ties and scores
    to rtol 1e-5, every score is the exact f32 dot product, and recall@20
    against the exhaustive kernel is at least 0.95."""
    import dataclasses

    from incubator_predictionio_tpu_torch.ops import mips
    from incubator_predictionio_tpu_torch.utils.planted import (
        planted_item_factors,
        planted_queries,
        recall_against_oracle,
    )

    monkeypatch.setenv("PIO_SERVE_MIPS", "on")
    monkeypatch.setenv("PIO_SERVE_MIPS_QUANT", quant)
    n_items, rank, k = 262_144, 64, 20
    vf = planted_item_factors(n_items, rank, seed=11)
    qs = planted_queries(vf, 64, seed=5)
    table = torch.from_numpy(vf).to(dev)
    index = mips.build_index(table, n_items, seed=11, register=False)
    cpu_index = dataclasses.replace(index, **{
        f.name: getattr(index, f.name).cpu()
        for f in dataclasses.fields(index)
        if isinstance(getattr(index, f.name), torch.Tensor)})
    cpu_table = torch.from_numpy(vf)
    uf, cpu_uf = torch.from_numpy(qs).to(dev), torch.from_numpy(qs)
    def same(got, ref):
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[0]).max())
        for q, p in zip(*np.nonzero(got[1] != ref[1])):
            assert any(abs(ref[0][q, p] - ref[0][q, r])
                       <= 1e-5 * abs(ref[0][q, p])
                       for r in (p - 1, p + 1) if 0 <= r < ref.shape[-1])

    card = np.stack([mips.mips_score_user_and_top_k(uf, table, index, j, k)
                     .cpu().numpy() for j in range(len(qs))], axis=1)
    cpu = np.stack([mips.mips_score_user_and_top_k(cpu_uf, cpu_table,
                                                   cpu_index, j, k).numpy()
                    for j in range(len(qs))], axis=1)
    same(card, cpu)
    rows = np.arange(len(qs))
    card_b = mips.mips_batch_score_top_k(uf, table, index, rows, k).cpu()
    cpu_b = mips.mips_batch_score_top_k(cpu_uf, cpu_table, cpu_index, rows,
                                        k)
    same(card_b.numpy(), cpu_b.numpy())
    ids = card[1].astype(np.int64)
    dots = np.einsum("bk,bnk->bn", qs.astype(np.float64),
                     vf[ids].astype(np.float64))
    np.testing.assert_allclose(card[0], dots, rtol=1e-5,
                               atol=1e-5 * np.abs(dots).max())
    _s, oracle = kernels.score_topk(uf, table, None, k)
    recall, _ = recall_against_oracle(ids, oracle.cpu().numpy(), k)
    assert recall >= 0.95, recall


def test_mips_rebuild_swap_on_the_daemon_while_dispatchers_serve(
        dev, monkeypatch):
    """Two dispatcher threads drain batches of 64 queries through the
    two-stage route on one 262,144 × 64 catalogue while the rebuild daemon
    folds a published tail and swaps the index: every returned (id, score)
    is the exact f32 dot product (rtol 1e-5); recall@20 against the
    exhaustive kernel (over the table, and the published rows once they
    are in) stays ≥ 0.95 on the old index and on the new; the published
    keys that are their own best match are found first from the tail,
    then from the ext block."""
    import threading
    import time

    from incubator_predictionio_tpu_torch.ops import mips, mips_daemon
    from incubator_predictionio_tpu_torch.utils.planted import (
        planted_item_factors,
        planted_queries,
        recall_against_oracle,
    )

    monkeypatch.setenv("PIO_SERVE_MIPS", "on")
    monkeypatch.setenv("PIO_MIPS_REBUILD_TAIL", "16")
    n_items, rank, k = 262_144, 64, 20
    vf = planted_item_factors(n_items, rank, seed=11)
    table = torch.from_numpy(vf).to(dev)
    index = mips.build_index(table, n_items, seed=11)
    qs = planted_queries(vf, 512, seed=5)
    uf = torch.from_numpy(qs).to(dev)
    # the published rows: 12 blended vectors (the JAX bench's churn) and
    # 4 new keys that are their own best match (norm 8, above every row's:
    # tests/test_mips_lifecycle.py's construction)
    rng = np.random.default_rng(23)
    keys = rng.normal(size=(4, rank)).astype(np.float32)
    keys *= 8.0 / np.linalg.norm(keys, axis=1, keepdims=True)
    fresh = np.concatenate([planted_queries(vf, 12, seed=9), keys])
    # 0: nothing published; 1: publishing (answers not held to an
    # oracle); 2: published, the oracle includes the fresh rows
    phase = [0]
    answers, errors = [], []
    stop = threading.Event()

    def dispatcher(seed):
        drng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                rows = drng.integers(0, len(qs), 64)
                seen, served = phase[0], mips.index_for(table)
                out = topk.batch_score_top_k(uf, table, rows, k=k)
                answers.append((rows, seen, served, out.cpu().numpy()))
        except Exception as e:  # surfaced below
            errors.append(e)

    def wait_for(n):
        deadline = time.monotonic() + 120
        while len(answers) < n and not errors:
            assert time.monotonic() < deadline
            time.sleep(0.01)

    threads = [threading.Thread(target=dispatcher, args=(s,))
               for s in (1, 2)]
    mips_daemon.acquire()
    try:
        for t in threads:
            t.start()
        wait_for(8)
        phase[0] = 1
        vids = mips.publish_rows(table, fresh)
        phase[0] = 2
        tail_ids = [int(topk.score_and_top_k(torch.from_numpy(v).to(dev),
                                             table, k=k)[1][0])
                    for v in keys]
        mips_daemon.notify_publish()
        deadline = time.monotonic() + 300
        while mips.index_for(table) is index:
            assert time.monotonic() < deadline and not errors
            time.sleep(0.02)
        wait_for(len(answers) + 8)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
        mips_daemon.release()
    assert not errors, errors
    new = mips.index_for(table)
    assert new.n_ext == 16 and new.tail_virtual_size() == 0
    assert tail_ids == vids[12:].tolist()
    ext_ids = [int(topk.score_and_top_k(torch.from_numpy(v).to(dev),
                                        table, k=k)[1][0]) for v in keys]
    assert ext_ids == vids[12:].tolist()
    full = np.concatenate([vf, fresh])
    full_t = torch.from_numpy(full).to(dev)
    to_row = {int(v): n_items + i for i, v in enumerate(vids)}
    to_vid = np.concatenate([np.arange(n_items), vids])
    recalls = {True: [], False: []}
    for rows, seen, served, out in answers:
        ids = out[1].astype(np.int64)
        flat = np.vectorize(lambda i: to_row.get(int(i), int(i)))(ids)
        dots = np.einsum("bk,bnk->bn", qs[rows].astype(np.float64),
                         full[flat].astype(np.float64))
        np.testing.assert_allclose(out[0], dots, rtol=1e-5,
                                   atol=1e-5 * np.abs(dots).max())
        if seen == 1:
            continue
        _, top_i = kernels.score_topk(uf[rows], full_t if seen else table,
                                      None, k)
        oracle = to_vid[top_i.cpu().numpy()]
        rec, _ = recall_against_oracle(ids, oracle, k)
        recalls[served is index].append(rec)
    assert recalls[True] and recalls[False]
    assert min(np.mean(recalls[True]), np.mean(recalls[False])) >= 0.95


def test_a_dispatch_books_its_own_device_seconds_beside_a_foldin(dev):
    """ROADMAP Queue 3 fault 3's pin (``chip_smoke.stream_isolation``):
    with ``PIO_PROFILE=1``, an object-path query dispatched the moment a
    long fold-in (8,192 implicit rows of 2,048, one fused launch) is
    queued on a thread of its own books ``serve_topk`` seconds below a
    tenth of the fold-in's ``foldin_solve`` seconds: the dispatcher's
    stream is its own, so its wait never covers the fold-in's work."""
    import chip_smoke

    from incubator_predictionio_tpu_torch.core import params as params_mod
    from incubator_predictionio_tpu_torch.models.recommendation import (
        convert,
        engine,
    )
    from incubator_predictionio_tpu_torch.servers import (
        prediction_server as server_mod,
    )

    rng = np.random.default_rng(5)
    uf = (0.1 * rng.standard_normal((20_000, 128))).astype(np.float32)
    items = (0.1 * rng.standard_normal((26_744, 128))).astype(np.float32)
    out = chip_smoke.stream_isolation(dev, runtime, server_mod, engine,
                                      params_mod, convert, uf, items)
    assert len(out["trials"]["object"]) == chip_smoke.STREAM_TRIALS
    for row in out["trials"]["object"]:
        assert row["serve_s"] < chip_smoke.STREAM_SHARE * row["foldin_s"]
