"""The port's attention (PyTorch, on the CPU) against the JAX package's.

The same inputs, made with numpy from a seed, go through JAX's
``dot_product_attention``, ``blockwise_attention`` and ``flash_attention``
(the Pallas kernel in interpret mode) and the port's dense, blockwise and
``flash_attention`` (on CPU tensors, its plain version), on the JAX tests'
cases (tests/test_pallas_kernels.py:79-150): causal and not, ragged
validity, fully masked rows equal to 0, the decode row. Tolerances are the
JAX tests' own: atol 2e-5 for outputs, 3e-5 for gradients.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_predictionio_tpu.ops import attention as jatt
from incubator_predictionio_tpu.ops.pallas_kernels import (
    flash_attention as jflash,
)
from incubator_predictionio_tpu_torch.ops import attention as tatt
from incubator_predictionio_tpu_torch.ops import attention_kernels as tfa

ATOL, GRAD_ATOL = 2e-5, 3e-5


def _qkv(seed, b, s_q, s_kv, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32)
                 for shape in ((b, s_q, h, d), (b, s_kv, h, d),
                               (b, s_kv, h, d)))


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# (name, b, s_q, s_kv, h, d, causal, valid, q_block, kv_block)
CASES = [
    ("causal", 2, 100, 100, 2, 32, True, None, 32, 32),
    ("not_causal", 2, 100, 100, 2, 32, False, None, 32, 32),
    ("ragged", 2, 40, 40, 2, 16, True,
     np.arange(40)[None, :] < np.array([[17], [33]]), 16, 16),
    ("fully_masked", 1, 8, 8, 1, 16, True, np.zeros((1, 8), bool), 8, 8),
    ("decode", 1, 1, 64, 2, 32, False, None, 128, 128),
    # a left-padded window: every query before the first real key is dead
    ("left_padded", 2, 48, 48, 2, 16, True,
     np.arange(48)[None, :] >= np.array([[30], [0]]), 16, 16),
    # heads wider than 128 (the kernel's wide form), ragged validity
    ("wide_head", 2, 40, 40, 2, 160, True,
     np.arange(40)[None, :] < np.array([[25], [40]]), 16, 16),
    ("wide_head_256_left_padded", 2, 40, 40, 1, 256, True,
     np.arange(40)[None, :] >= np.array([[39], [7]]), 16, 16),
    ("wide_head_200_not_causal", 1, 24, 40, 2, 200, False,
     np.arange(40)[None, :] % 3 != 1, 8, 16),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_matches_jax_kernel_and_references(case):
    name, b, s_q, s_kv, h, d, causal, valid, qb, kb = case
    q, k, v = _qkv(len(name), b, s_q, s_kv, h, d)
    ref = np.asarray(jflash(_j(q), _j(k), _j(v), causal=causal,
                            kv_valid=_j(valid), interpret=True, q_block=qb,
                            kv_block=kb))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              kv_valid=_t(valid), q_block=qb,
                              kv_block=kb).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    plain = tfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                      kv_valid=_t(valid),
                                      kv_block=kb).numpy()
    np.testing.assert_array_equal(got, plain)
    dense = jatt.dot_product_attention(_j(q), _j(k), _j(v), causal=causal,
                                       kv_valid=_j(valid))
    np.testing.assert_allclose(got, np.asarray(dense), atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dense_and_blockwise_match_jax(case):
    name, b, s_q, s_kv, h, d, causal, valid, _qb, kb = case
    q, k, v = _qkv(len(name) + 1, b, s_q, s_kv, h, d)
    jd = jatt.dot_product_attention(_j(q), _j(k), _j(v), causal=causal,
                                    kv_valid=_j(valid))
    td = tatt.dot_product_attention(_t(q), _t(k), _t(v), causal=causal,
                                    kv_valid=_t(valid))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    jb = jatt.blockwise_attention(_j(q), _j(k), _j(v), causal=causal,
                                  block_size=kb, kv_valid=_j(valid))
    tb = tatt.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                  block_size=kb, kv_valid=_t(valid))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL)


def test_fully_masked_rows_are_exactly_zero():
    """Masked probabilities are zeroed: a query whose live tiles are all
    masked (the left padding of a window) gives exactly 0, not NaN and not
    a uniform softmax (exp(MASK - MASK) = 1)."""
    q, k, v = _qkv(3, 2, 70, 70, 2, 16)
    valid = np.arange(70)[None, :] >= np.array([[40], [70]])
    for fn in (functools.partial(tfa.flash_attention, kv_block=16),
               functools.partial(tatt.blockwise_attention, block_size=16),
               tatt.dot_product_attention):
        out = fn(_t(q), _t(k), _t(v), causal=True, kv_valid=_t(valid))
        assert torch.isfinite(out).all()
        assert (out[0, :40] == 0).all() and (out[1] == 0).all()
        assert (out[0, 40:].abs().sum(-1) > 0).all()


def _dead_tiles(b, s):
    """[b, s] bool: keys of 64-key tiles 1 and 2 all invalid (whole dead
    tiles), every third key invalid elsewhere (holes inside live tiles),
    and row 1 invalid up to key 200 (its first three query tiles dead
    under the causal mask)."""
    key = np.arange(s)[None, :]
    valid = ((key // 64) % 4 != 1) & ((key // 64) % 4 != 2) & (key % 3 != 1)
    valid = np.repeat(valid, b, 0)
    if b > 1:
        valid[1, :200] = False
    return valid


def _one_key(b, s, keys):
    valid = np.zeros((b, s), bool)
    valid[np.arange(b), list(keys)] = True
    return valid


# (name, b, s_q, s_kv, causal, valid): 64-key tiles, as the kernel's
SKIP_CASES = [
    ("dead_tiles", 2, 320, 320, True, _dead_tiles(2, 320)),
    ("dead_tiles_not_causal", 2, 320, 320, False, _dead_tiles(2, 320)),
    ("dead_q_tiles", 1, 320, 320, True,
     np.arange(320)[None, :] >= 200),
    ("one_key_tile_edges", 2, 256, 256, True, _one_key(2, 256, (128, 191))),
    ("sq_lt_skv", 2, 100, 320, True, _dead_tiles(2, 320)),
    ("sq_gt_skv", 2, 320, 130, True, _dead_tiles(2, 130)),
]


def _live(valid, s_q, causal):
    """[b, s_q] bool: the queries with at least one live key."""
    keys = np.arange(valid.shape[1])[None, None, :]
    pos = np.arange(s_q)[None, :, None]
    live = valid[:, None, :] & ((pos >= keys) if causal else True)
    return np.broadcast_to(live.any(-1), (valid.shape[0], s_q))


@pytest.mark.parametrize("case", SKIP_CASES, ids=[c[0] for c in SKIP_CASES])
def test_flash_dead_tiles_match_jax_and_dead_queries_are_zero(case):
    """Validity with whole dead 64-key tiles, holes, dead query tiles and a
    single live key at a tile's edge: the port's flash_attention (its plain
    version here) against the Pallas kernel in interpret mode at the CUDA
    kernel's 64-row tiles; a query with no live key is exactly 0 and every
    other one is not."""
    name, b, s_q, s_kv, causal, valid = case
    q, k, v = _qkv(len(name) + 40, b, s_q, s_kv, 2, 16)
    ref = np.asarray(jflash(_j(q), _j(k), _j(v), causal=causal,
                            kv_valid=_j(valid), interpret=True, q_block=64,
                            kv_block=64))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              kv_valid=_t(valid), kv_block=64).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    live = _live(valid, s_q, causal)
    assert live.any()
    assert (got[~live] == 0).all() and (ref[~live] == 0).all()
    assert (np.abs(got[live]).sum(-1) > 0).all()


@pytest.mark.parametrize("causal", [True, False])
def test_dead_key_tiles_contribute_exactly_nothing(causal):
    """What lets the kernel skip a tile with no live key: whatever k and v
    hold there, the output is bit for bit the same, in the port and in the
    Pallas kernel (the mask is per key, and a masked probability is 0)."""
    b, s = 2, 320
    valid = _dead_tiles(b, s)
    q, k, v = _qkv(50, b, s, s, 2, 16)
    k2, v2 = k.copy(), v.copy()
    k2[:, 64:192] = 1e4     # tiles 1 and 2: no valid key in either row
    v2[:, 64:192] = -3e4
    outs = []
    for kk, vv in ((k, v), (k2, v2)):
        outs.append((
            tfa.flash_attention(_t(q), _t(kk), _t(vv), causal=causal,
                                kv_valid=_t(valid), kv_block=64).numpy(),
            np.asarray(jflash(_j(q), _j(kk), _j(vv), causal=causal,
                              kv_valid=_j(valid), interpret=True,
                              q_block=64, kv_block=64))))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_dense_offsets_match_jax():
    """The sharded masking rule: global positions of the first query and
    key rows."""
    q, k, v = _qkv(4, 1, 16, 24, 2, 8)
    for q_off, kv_off in ((0, 0), (24, 8), (8, 24)):
        jd = jatt.dot_product_attention(_j(q), _j(k), _j(v), causal=True,
                                        q_offset=q_off, kv_offset=kv_off)
        td = tatt.dot_product_attention(_t(q), _t(k), _t(v), causal=True,
                                        q_offset=q_off, kv_offset=kv_off)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)


def test_bf16_inputs_compute_in_f32_and_return_bf16():
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(5, 1, 64, 64, 2, 16))
    ref = jflash(_j(q), _j(k), _j(v), causal=True, interpret=True,
                 q_block=16, kv_block=16)
    got = tfa.flash_attention(*(torch.from_numpy(np.asarray(a, np.float32))
                                .to(torch.bfloat16) for a in (q, k, v)),
                              causal=True, kv_block=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=8e-3 * float(jnp.abs(ref).max()))


@pytest.mark.parametrize("valid", [None, "left_padded"])
def test_flash_gradient_matches_jax_custom_vjp(valid):
    """The autograd Function's backward (the blockwise recompute) against
    jax.grad of the Pallas kernel's custom VJP, and against the dense
    reference (tests/test_pallas_kernels.py:131-150)."""
    q, k, v = _qkv(30, 1, 24, 24, 2, 16)
    mask = None if valid is None else np.arange(24)[None, :] >= 5

    def loss_jax(q, k, v):
        return jnp.sum(jflash(q, k, v, causal=True, kv_valid=_j(mask),
                              interpret=True, q_block=8, kv_block=8) ** 2)

    jg = jax.grad(loss_jax, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True, kv_valid=_t(mask),
                              kv_block=8)
    (out ** 2).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=GRAD_ATOL)
    dq, dk, dv = (_t(a).requires_grad_(True) for a in (q, k, v))
    (tatt.dot_product_attention(dq, dk, dv, causal=True,
                                kv_valid=_t(mask)) ** 2).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad),
                        (dq.grad, dk.grad, dv.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=GRAD_ATOL)


def test_backward_has_no_gradient_for_validity():
    q, k, v = (_t(a).requires_grad_(True) for a in _qkv(6, 1, 16, 16, 1, 8))
    valid = torch.ones((1, 16), requires_grad=True)
    tfa.flash_attention(q, k, v, kv_valid=valid).sum().backward()
    assert valid.grad is None and q.grad is not None


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A CUDA tensor launches the kernel or raises; here (no card) the meta
    device stands in for one it cannot launch on."""
    q = torch.empty((1, 64, 2, 32), device="meta")
    before = tfa.FLASH_LAUNCHES.value
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    assert tfa.FLASH_LAUNCHES.value == before


def test_cpu_wrapper_never_counts_a_launch():
    q, k, v = (_t(a) for a in _qkv(7, 1, 32, 32, 2, 8))
    before = tfa.FLASH_LAUNCHES.value
    tfa.flash_attention(q, k, v)
    assert tfa.FLASH_LAUNCHES.value == before


def test_bound_counts_live_pairs():
    """4·D FLOP per live pair and head, for f32 at a third of the TF32
    tensor-core peak (3xTF32), for bf16 at the bf16 peak: the engine's
    shape at B 1, S 8192 is 8.6 GFLOP, 0.0521 ms; the bench's S 32768 in
    bf16 is 1.10 TFLOP, 1.11 ms."""
    s = 8192
    pairs = tfa.live_pairs(s, torch.ones((1, s)), causal=True)
    assert pairs == s * (s + 1) // 2
    ms, by = tfa.flash_bound(1, 2, s, s, 32, torch.float32, pairs)
    assert by == "operations" and abs(ms - 0.05207) < 1e-4
    s = 32768
    pairs = tfa.live_pairs(s, torch.ones((1, s)), causal=True)
    ms, by = tfa.flash_bound(1, 8, s, s, 64, torch.bfloat16, pairs)
    assert by == "operations" and abs(ms - 1.112) < 2e-3
    valid = torch.zeros((2, 10))
    valid[0, 6:] = 1
    assert tfa.live_pairs(10, valid, causal=True) == 4 + 3 + 2 + 1
    assert tfa.live_pairs(10, valid, causal=False) == 40


def test_replaces_names_the_tpu_kernel():
    import incubator_predictionio_tpu.ops.pallas_kernels as pk

    path, line = tfa.REPLACES.split(":")
    assert path.endswith("pallas_kernels.py")
    src = open(pk.__file__).read().splitlines()
    assert src[int(line) - 1].startswith("def _flash_kernel(")
