"""The port's ALS bucket-solve kernels (their plain versions, on the CPU)
against the JAX package's Pallas kernels in interpret mode, on one seeded
numpy problem.

The problem is the reference tests' shape family (tests/
test_pallas_kernels.py:156-212, tests/test_fused_gram.py:51-122): rank 24,
which is no multiple of 128, so the TPU kernels pad it; B = 13 rows, no
multiple of 8, so the R = 8 form pads its last row group; D = 300, which
the TPU kernels stream in three 128-wide tiles; row 3 empty. Tolerances
are the reference's own: rel 1e-4 with an f32 table, rel 2e-2 with a bf16
table (the TPU kernel's bf16 matmul passes against the port's exact
products summed in f32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_predictionio_tpu.ops import pallas_kernels as pk
from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.ops import als_kernels as ak

M, K, B, D = 200, 24, 13, 300
L2, ALPHA, ITERS = 0.05, 2.0, 16
EMPTY = 3
TOL = {"f32": 1e-4, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _problem():
    rng = np.random.default_rng(11)
    table = rng.normal(0, 0.3, (M, K)).astype(np.float32)
    cols = rng.integers(0, M, (B, D)).astype(np.int32)
    vals = rng.normal(3.5, 1.0, (B, D)).astype(np.float32)
    mask = (rng.random((B, D)) < 0.8).astype(np.float32)
    mask[EMPTY] = 0.0
    x0 = rng.normal(0, 0.3, (B, K)).astype(np.float32)
    return table, cols, vals, mask, x0


PROBLEM = _problem()


@pytest.fixture(scope="module")
def jax_out():
    """The JAX kernels' outputs, computed once per (entry, dtype, warm)."""
    table, cols, vals, mask, x0 = PROBLEM
    cache = {}

    def get(entry, dt, warm):
        key = (entry, dt, warm)
        if key not in cache:
            tab = jnp.asarray(table).astype(JDT[dt])
            args = (tab, jnp.asarray(cols), jnp.asarray(vals),
                    jnp.asarray(mask), L2)
            x = jnp.asarray(x0) if warm else None
            if entry in ("rows1", "rows8"):
                out = pk.als_solve_cg_pallas(
                    *args, reg_nnz=True, iters=ITERS, interpret=True,
                    rows_per_program=1 if entry == "rows1" else 8, x0=x)
            else:
                implicit = entry == "implicit"
                yty = (jnp.asarray(table).T @ jnp.asarray(table)
                       if implicit else None)
                out = pk.als_fused_solve_cg_pallas(
                    *args, reg_nnz=True,
                    iters=ITERS * (2 if implicit else 1), implicit=implicit,
                    alpha=ALPHA, yty=yty, x0=x, interpret=True)
            cache[key] = np.asarray(out, np.float32)
        return cache[key]

    return get


def _port(entry, dt, warm):
    table, cols, vals, mask, x0 = PROBLEM
    tab = torch.from_numpy(table).to(TDT[dt])
    args = (tab, torch.from_numpy(cols), torch.from_numpy(vals),
            torch.from_numpy(mask), L2)
    x = torch.from_numpy(x0) if warm else None
    if entry in ("rows1", "rows8"):
        out = ak.als_solve_cg(*args, reg_nnz=True, iters=ITERS,
                              rows_per_program=1 if entry == "rows1" else 8,
                              x0=x)
    else:
        implicit = entry == "implicit"
        yty = torch.from_numpy(table).T @ torch.from_numpy(table) \
            if implicit else None
        out = ak.als_fused_solve_cg(*args, reg_nnz=True,
                                    iters=ITERS * (2 if implicit else 1),
                                    implicit=implicit, alpha=ALPHA, yty=yty,
                                    x0=x)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, K)
    return out.numpy()


def _rel(got, ref):
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("entry", ["rows1", "rows8"])
def test_two_stage_matches_jax_kernel(jax_out, entry, dt, warm):
    got, ref = _port(entry, dt, warm), jax_out(entry, dt, warm)
    rel = _rel(got, ref)
    assert rel < TOL[dt], (entry, dt, warm, rel)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_matches_jax_kernel(jax_out, dt, warm):
    got, ref = _port("fused", dt, warm), jax_out("fused", dt, warm)
    rel = _rel(got, ref)
    assert rel < TOL[dt], (dt, warm, rel)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_fused_implicit_matches_jax_kernel(jax_out, warm):
    got, ref = _port("implicit", "f32", warm), jax_out("implicit", "f32",
                                                       warm)
    rel = _rel(got, ref)
    assert rel < TOL["f32"], (warm, rel)


@pytest.mark.parametrize("entry", ["fused", "implicit"])
def test_fused_empty_row_is_exactly_zero(jax_out, entry):
    """The fused entry zeroes rows without observations, warm or cold
    (pallas_kernels.py:1318), in both packages."""
    for warm in (False, True):
        assert (_port(entry, "f32", warm)[EMPTY] == 0.0).all()
        assert (jax_out(entry, "f32", warm)[EMPTY] == 0.0).all()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("d", [8, 16, 32])
def test_rows_form_matches_jax_kernel_on_short_rows(d, k, dt):
    """The R-row form's widths (d <= the padded rank, many short rows:
    ops/sparse's buckets of 8-32), warm: the port's rows_per_program 8 (on
    the CPU its plain version) against the JAX package's R = 8 Pallas
    kernel in interpret mode, 11 rows (no multiple of 8, so the JAX kernel
    pads its last row group), row 3 empty. Tolerances as above, but a
    system with fewer observations than the rank is singular but for the
    ridge, and 16 CG steps iterate on its rounding: there, as in
    chip_smoke.als_tolerance, 1e-3 in f32 and, beyond it, the port no more
    than 3x as far from the f64 solve of the same system as the JAX
    kernel."""
    assert ak.rows_form(d, k)
    rng = np.random.default_rng(d * k)
    b = 11
    table = rng.normal(0, 0.3, (300, k)).astype(np.float32)
    cols = rng.integers(0, 300, (b, d)).astype(np.int32)
    vals = rng.normal(3.5, 1.0, (b, d)).astype(np.float32)
    lens = rng.integers(d // 2 + 1, d + 1, b)
    mask = (np.arange(d)[None, :] < lens[:, None]).astype(np.float32)
    mask[EMPTY] = 0.0
    x0 = rng.normal(0, 0.3, (b, k)).astype(np.float32)
    ref = np.asarray(pk.als_solve_cg_pallas(
        jnp.asarray(table).astype(JDT[dt]), jnp.asarray(cols),
        jnp.asarray(vals), jnp.asarray(mask), L2, reg_nnz=True, iters=ITERS,
        interpret=True, rows_per_program=8, x0=jnp.asarray(x0)), np.float32)
    got = ak.als_solve_cg(
        torch.from_numpy(table).to(TDT[dt]), torch.from_numpy(cols),
        torch.from_numpy(vals), torch.from_numpy(mask), L2, reg_nnz=True,
        iters=ITERS, rows_per_program=8, x0=torch.from_numpy(x0)).numpy()
    tol = max(TOL[dt], 1e-3)  # d < k at every case
    if _rel(got, ref) >= tol:
        tab = torch.from_numpy(table).to(TDT[dt]).double()
        t = tab[torch.from_numpy(cols)] * torch.from_numpy(mask).double()[
            ..., None]
        wv = (torch.from_numpy(vals * mask).to(TDT[dt])).double()
        lam = L2 * torch.from_numpy(mask).double().sum(-1).clamp(min=1.0)
        exact = ak.cg_plain(torch.einsum("bdk,bdl->bkl", t, t),
                            torch.einsum("bd,bdk->bk", wv, t), lam, ITERS,
                            torch.from_numpy(x0).double()).numpy()
        assert _rel(got, exact) <= 3 * _rel(ref, exact) + 1e-6, (
            d, k, dt, _rel(got, ref), _rel(got, exact), _rel(ref, exact))


def test_two_stage_empty_row_keeps_the_kernels_rule(jax_out):
    """The two-stage entry has no guard: cold, an empty row is the CG's
    fixed point 0; warm, it is whatever the CG makes of λ·x = 0 from x0,
    which the port reproduces instead of zeroing."""
    assert (_port("rows1", "f32", False)[EMPTY] == 0.0).all()
    for entry in ("rows1", "rows8"):
        got = _port(entry, "f32", True)[EMPTY]
        ref = jax_out(entry, "f32", True)[EMPTY]
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_row_groups_do_not_change_the_arithmetic():
    """R = 8 changes the layout of the kernel, not what it computes."""
    for dt in ("f32", "bf16"):
        np.testing.assert_array_equal(_port("rows1", dt, True),
                                      _port("rows8", dt, True))


def test_cpu_wrapper_is_the_plain_version():
    table, cols, vals, mask, x0 = (torch.from_numpy(a) for a in PROBLEM)
    for dt in (torch.float32, torch.bfloat16):
        tab = table.to(dt)
        assert torch.equal(
            ak.als_solve_cg(tab, cols, vals, mask, L2, x0=x0),
            ak.als_solve_cg_plain(tab, cols, vals, mask, L2, x0=x0))
        assert torch.equal(
            ak.als_fused_solve_cg(tab, cols, vals, mask, L2, x0=x0),
            ak.als_fused_solve_cg_plain(tab, cols, vals, mask, L2, x0=x0))
    assert ak.ALS_SOLVE_CG_LAUNCHES.value == 0
    assert ak.ALS_FUSED_SOLVE_CG_LAUNCHES.value == 0


def test_wrapper_rejects_bad_arguments():
    table, cols, vals, mask, _ = (torch.from_numpy(a) for a in PROBLEM)
    with pytest.raises(ValueError, match="rows_per_program"):
        ak.als_solve_cg(table, cols, vals, mask, L2, rows_per_program=4)
    with pytest.raises(ValueError, match="yty"):
        ak.als_fused_solve_cg(table, cols, vals, mask, L2, implicit=True)


def test_bound_counts_the_symmetric_gram():
    """One bound for both entries, the lesser of the function's two ways:
    the Gram's nnz·K·(K + 1) and the rhs's 2·nnz·K at the table dtype's
    peak (f32 at the 3xTF32 rate, or on the FMA units when asked), then
    (iters + warm)·2·B·K² of f32 CG; or, forming no Gram, (iters + warm +
    1)·4·nnz·K on the FMA units. Bytes of the referenced rows,
    cols/vals/mask, x0 and the output. A wide bucket takes the Gram's way
    at the 3xTF32 rate and the Gram-free way on the FMA units; a narrow
    one (d 8) the Gram-free way at any rate."""
    k, iters = 128, 16
    for nnz, distinct, b, d, gram_at_3xtf32 in (
            (5_000_000, 26_000, 20_000, 512, True),
            (120_000, 20_000, 16_384, 8, False)):
        for dt, peak, kw in ((torch.float32, 495e12 / 3, {}),
                             (torch.float32, 67e12, {"f32_flops": 67e12}),
                             (torch.bfloat16, 989e12, {})):
            ms, by = ak.als_bound(nnz, distinct, b, d, k, iters, True, dt,
                                  **kw)
            gram_s = (nnz * k * (k + 1) + 2 * nnz * k) / peak \
                + (iters + 1) * 2 * b * k * k / 67e12
            free_s = (iters + 2) * 4 * nnz * k / 67e12
            ops_s = min(gram_s, free_s)
            bytes_s = (distinct * k * (4 if dt == torch.float32 else 2)
                       + 12 * b * d + 8 * b * k) / 3.35e12
            assert ms == pytest.approx(1e3 * max(ops_s, bytes_s))
            assert by == ("operations" if ops_s > bytes_s else "bytes")
            if dt == torch.float32:
                assert (gram_s < free_s) == (gram_at_3xtf32 and not kw)
    # a bucket's bound counts its observations and the distinct rows they
    # reference, not the padding
    cols = torch.tensor([[3, 3, 7, 0], [7, 1, 0, 0]], dtype=torch.int32)
    mask = torch.tensor([[1, 1, 1, 0], [1, 1, 0, 0]], dtype=torch.float32)
    assert ak.bucket_bound(cols, mask, 8, 3, False, torch.float32) \
        == ak.als_bound(5.0, 3, 2, 4, 8, 3, False, torch.float32)


def test_implicit_bound_folds_yty_into_the_gram():
    """Implicit: the shared YᵀY adds K² f32 bytes once. The Gram way
    folds it into each row's Gram (B·K² adds once), its CG matvecs stay
    2·B·K² a step; the Gram-free way adds its matvec, 2·B·K² a step. The
    heaviest implicit ML-20M chunk (B 14,563, D 256, K 128) takes the
    Gram way, 32 warm steps."""
    k, iters = 128, 32
    for nnz, distinct, b, d in ((3_003_525, 26_744, 14_563, 256),
                                (120_000, 20_000, 16_384, 8)):
        ms, by = ak.als_bound(nnz, distinct, b, d, k, iters, True,
                              torch.float32, implicit=True)
        steps = iters + 1
        gram_s = (nnz * k * (k + 1) + 2 * nnz * k) / (495e12 / 3) \
            + steps * 2 * b * k * k / 67e12 + b * k * k / 67e12
        free_s = (steps + 1) * 4 * nnz * k / 67e12 \
            + steps * 2 * b * k * k / 67e12
        bytes_s = (distinct * k * 4 + 12 * b * d + 8 * b * k
                   + 4 * k * k) / 3.35e12
        ops_s = min(gram_s, free_s)
        assert ms == pytest.approx(1e3 * max(ops_s, bytes_s))
        assert by == ("operations" if ops_s > bytes_s else "bytes")
        explicit, _ = ak.als_bound(nnz, distinct, b, d, k, iters, True,
                                   torch.float32)
        assert explicit < ms


def test_replaces_names_the_tpu_kernels():
    src = open(pk.__file__).read().splitlines()
    for entry, body in (("als_solve_cg", "_als_cg_kernel("),
                        ("als_solve_cg_rows8", "_als_cg_kernel_rows("),
                        ("als_fused_solve_cg", "_als_fused_kernel(")):
        path, line = ak.REPLACES[entry].rsplit(":", 1)
        assert path.endswith("ops/pallas_kernels.py")
        assert src[int(line) - 1].startswith(f"def {body}"), entry


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Given a tensor off the CPU, a wrapper launches or raises; here (no
    card) the meta device stands in for one it cannot launch on."""
    table, cols, vals, mask, _ = (torch.from_numpy(a).to("meta")
                                  for a in PROBLEM)
    with pytest.raises(ValueError, match="CUDA"):
        ak.als_solve_cg(table, cols, vals, mask, L2)
    with pytest.raises(ValueError, match="CUDA"):
        ak.als_fused_solve_cg(table, cols, vals, mask, L2)
    assert ak.ALS_SOLVE_CG_LAUNCHES.value == 0
    assert ak.ALS_FUSED_SOLVE_CG_LAUNCHES.value == 0


# -- stage 1's launch plan (solve_plan), on the CPU ----------------------------

PLAN_SHAPES = [(8, 32_768, 128), (16, 8192, 128), (128, 1024, 128),
               (1024, 128, 128), (2048, 64, 128), (13, 300, 24),
               (5, 1, 32), (1, 100, 10), (3, 1000, 64), (9, 130, 16),
               (14_563, 256, 128), (13, 300, 129), (8, 32_768, 160),
               (1020, 256, 256), (3, 100, 300), (64, 500, 1000)]


@pytest.mark.parametrize("n_sms", [1, 132, 1000])
@pytest.mark.parametrize("b,d,k", PLAN_SHAPES)
def test_two_stage_plan_puts_every_d_row_in_one_slice(b, d, k, n_sms):
    plan = ak.solve_plan(b, d, k, n_sms)
    assert plan.kp == ak.padded_rank(k)
    starts = [s * plan.slice_rows for s in range(plan.slices)]
    ends = [min(d, s + plan.slice_rows) for s in starts]
    assert starts[0] == 0 and ends[-1] == d
    assert all(e > s for s, e in zip(starts, ends))
    assert all(a == b for a, b in zip(ends[:-1], starts[1:]))


@pytest.mark.parametrize("b,d,k", PLAN_SHAPES)
def test_two_stage_plan_fills_the_card_where_d_allows(b, d, k):
    n_sms = 132
    plan = ak.solve_plan(b, d, k, n_sms)
    most = -(-d // ak.slab_rows(plan.kp))  # one slab per slice
    assert b * plan.slices * plan.tiles >= min(
        ak.SOLVE_BLOCKS_PER_SM * n_sms, b * most * plan.tiles)


@pytest.mark.parametrize("n_sms", [1, 132, 1000])
@pytest.mark.parametrize("b,d,k", PLAN_SHAPES)
def test_two_stage_plan_has_no_more_slices_than_slabs(b, d, k, n_sms):
    """The C entries refuse a plan with more slices than slabs of d."""
    plan = ak.solve_plan(b, d, k, n_sms)
    assert plan.slices <= -(-d // ak.slab_rows(plan.kp))


@pytest.mark.parametrize("k,widths", [(10, (1, 16)), (24, (1, 8, 32)),
                                      (64, (8, 16, 32, 64)),
                                      (128, (8, 64, 128)), (129, ()),
                                      (256, ())])
def test_rows_form_takes_rows_up_to_the_padded_rank(k, widths):
    """rows_per_program 8 takes the R-row form where d <= the padded rank
    (at most ROWS_MAX_RANK, the source's constant), the one-row plan past
    it."""
    assert ak.ROWS_MAX_RANK == runtime.csrc_constants(
        "als_solve.cu")["kRowsMaxRank"] == 128
    kp = ak.padded_rank(k)
    for d in (1, 8, 16, 32, 64, 128, 129, 4096):
        assert ak.rows_form(d, k) == (d in widths or (kp <= 128 and
                                                      d <= kp)), (k, d)
    for d in widths:
        assert ak.rows_form(d, k)
    assert not ak.rows_form(kp + 1, k)


def test_slab_rows_are_the_kernel_sources():
    """The plan's slab rows are read from the kernel source, their one
    owner, which sizes the kernel's slabs with them."""
    src = (runtime.CSRC_DIR / "als_solve.cu").read_text()
    assert f"constexpr int kSlabRowsWide = {ak.slab_rows(64)};" in src
    assert f"constexpr int kSlabRowsNarrow = {ak.slab_rows(16)};" in src
    assert ak.slab_rows(128) == ak.slab_rows(64) == ak.slab_rows(256)
    assert ak.slab_rows(32) == ak.slab_rows(16)
    assert "static constexpr int TD = slab_rows(KT);" in src


@pytest.mark.parametrize("b,d,k", PLAN_SHAPES)
def test_two_stage_plan_workspace_bytes(b, d, k):
    """Partial records of every row and slice and, for several slices, the
    summed ones; above rank 128 at least one record a row, where stage 1
    writes its tiles (none for one slice below, where the block solves)."""
    plan = ak.solve_plan(b, d, k, 132)
    rec = plan.kp * plan.kp + plan.kp  # a Gram and its rhs, f32
    per = plan.slices + 1 if plan.slices > 1 else int(plan.kp > 128)
    assert plan.workspace_bytes == 4 * plan.rows * rec * per


# (k, padded rank, Gram tiles): 16/32/64/128, then multiples of 128 and the
# upper triangle's 128 x 128 tiles, as the JAX package's als_padded_dims
# pads K to a multiple of 128 (pallas_kernels.py:846)
PADDED = [(1, 16, 1), (16, 16, 1), (17, 32, 1), (33, 64, 1), (65, 128, 1),
          (128, 128, 1), (129, 256, 3), (160, 256, 3), (256, 256, 3),
          (257, 384, 6), (300, 384, 6), (512, 512, 10), (1000, 1024, 36)]


@pytest.mark.parametrize("k,kp,tiles", PADDED)
def test_padded_rank_and_tiles_above_128(k, kp, tiles):
    assert ak.padded_rank(k) == kp
    assert ak.gram_tiles(kp) == tiles
    plan = ak.solve_plan(50, 400, k, 132)
    assert (plan.kp, plan.tiles) == (kp, tiles)
    if kp > 128:  # the padded rank is the JAX package's
        assert kp == -(-k // 128) * 128


@pytest.mark.parametrize("b,d,k", [(14_563, 256, 256), (20_000, 64, 1000),
                                   (3, 100, 8192), (1020, 256, 256)])
def test_solve_plan_caps_the_workspace_by_row_groups(b, d, k):
    """A call whose records would exceed ``WORKSPACE_CAP`` runs in groups
    of ``rows`` rows sharing one workspace: as many as fit, at least one."""
    plan = ak.solve_plan(b, d, k, 132)
    per_row = plan.workspace_bytes // plan.rows
    assert per_row == 4 * ak.record_floats(plan.kp) * (
        plan.slices + 1 if plan.slices > 1 else 1)
    assert 1 <= plan.rows <= b
    assert plan.workspace_bytes <= max(ak.WORKSPACE_CAP, per_row)
    if plan.rows < b:
        assert (plan.rows + 1) * per_row > ak.WORKSPACE_CAP


def test_plan_constants_are_the_kernel_sources():
    """The Gram tile, the widest rank and the tile count are read from (or
    written as) the kernel source, their owner."""
    src = (runtime.CSRC_DIR / "als_solve.cu").read_text()
    assert f"constexpr int kGramTile = {ak.GRAM_TILE};" in src
    assert f"constexpr int kMaxRank = {ak.MAX_RANK};" in src
    assert "(kp / kGramTile) * (kp / kGramTile + 1) / 2" in src
    # the CG above 128 keeps five vectors of the padded rank in shared
    # memory, which a block may have 227 KB of
    assert 4 * (5 * ak.MAX_RANK + 32) <= 227 * 1024


# -- rank 160: above 128, where the kernels build the Gram in tiles ------------

# A table of 600 rows: with 200 (the problem above) the implicit YᵀY of
# rank 160 is nearly singular, and 32 CG steps leave both packages ~2% from
# the exact solve and 2.5e-3 from each other (the port as near to an f64
# solve as the reference: a conditioning effect, not an arithmetic one).
K160, M160 = 160, 600


def _problem160():
    rng = np.random.default_rng(12)
    table = rng.normal(0, 0.3, (M160, K160)).astype(np.float32)
    cols = rng.integers(0, M160, (B, D)).astype(np.int32)
    vals = rng.normal(3.5, 1.0, (B, D)).astype(np.float32)
    mask = (rng.random((B, D)) < 0.8).astype(np.float32)
    mask[EMPTY] = 0.0
    x0 = rng.normal(0, 0.3, (B, K160)).astype(np.float32)
    return table, cols, vals, mask, x0


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("entry,dt", [("rows1", "f32"), ("rows1", "bf16"),
                                      ("fused", "f32"), ("fused", "bf16"),
                                      ("implicit", "f32")])
def test_rank_160_matches_jax_kernel(entry, dt, warm):
    """Both entries' plain versions at rank 160 against the Pallas kernels
    in interpret mode, which pad it to 256: the arithmetic the port's
    kernels run above 128 (tiles of the padded rank) at the reference
    tests' tolerances (the implicit variant in f32, as those tests run
    it); empty rows of the fused entry exactly 0."""
    table, cols, vals, mask, x0 = _problem160()
    x = x0 if warm else None
    jargs = (jnp.asarray(table).astype(JDT[dt]), jnp.asarray(cols),
             jnp.asarray(vals), jnp.asarray(mask), L2)
    targs = (torch.from_numpy(table).to(TDT[dt]), torch.from_numpy(cols),
             torch.from_numpy(vals), torch.from_numpy(mask), L2)
    tx = None if x is None else torch.from_numpy(x)
    jx = None if x is None else jnp.asarray(x)
    if entry == "rows1":
        ref = pk.als_solve_cg_pallas(*jargs, reg_nnz=True, iters=ITERS,
                                     interpret=True, rows_per_program=1,
                                     x0=jx)
        got = ak.als_solve_cg(*targs, reg_nnz=True, iters=ITERS, x0=tx)
    else:
        implicit = entry == "implicit"
        yty = table.T @ table
        ref = pk.als_fused_solve_cg_pallas(
            *jargs, reg_nnz=True, iters=ITERS * (2 if implicit else 1),
            implicit=implicit, alpha=ALPHA,
            yty=jnp.asarray(yty) if implicit else None, x0=jx,
            interpret=True)
        got = ak.als_fused_solve_cg(
            *targs, reg_nnz=True, iters=ITERS * (2 if implicit else 1),
            implicit=implicit, alpha=ALPHA,
            yty=torch.from_numpy(yty) if implicit else None, x0=tx)
        assert (got[EMPTY] == 0).all()
    assert tuple(got.shape) == (B, K160)
    rel = _rel(got.numpy(), np.asarray(ref, np.float32))
    assert rel < TOL[dt], (entry, dt, warm, rel)
