"""The port's ops/topk (PyTorch, on the CPU) against the JAX package's
ops/topk (XLA) and its Pallas score+top-k kernel in interpret mode.

Inputs are made with numpy from a seed and handed to both. Scores agree to
rtol 1e-5 / atol 1e-6: both sides are f32 but sum the rank in different
orders. Ids agree exactly: planted Gaussian data has no near-ties, and the
deliberate ties use integer factors, whose dot products are exact in any
order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_predictionio_tpu.ops import topk as jtopk
from incubator_predictionio_tpu.ops.pallas_kernels import score_and_top_k_pallas
from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.ops import kernels
from incubator_predictionio_tpu_torch.ops import topk as ttopk
from incubator_predictionio_tpu_torch.utils import planted

RTOL, ATOL = 1e-5, 1e-6


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _assert_packed(got, ref, allowed_only=False):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL, atol=ATOL)
    live = ref[0] > -1e37
    if allowed_only:  # the XLA path keeps real ids on masked slots
        np.testing.assert_array_equal(got[1][live], ref[1][live])
        np.testing.assert_array_equal(got[1][~live], -1)
    else:
        np.testing.assert_array_equal(got[1], ref[1])


# the four TestPallasTopK cases (tests/test_pallas_kernels.py:27-78), plus
# duplicate-row ties and a valid_items bound
CASES = {
    "matches_reference": dict(n=500, rank=24, k=7),
    "exclusions_cannot_displace": dict(n=300, rank=16, k=5,
                                       exclude=np.arange(250)),
    "mask_and_negative_exclude": dict(n=260, rank=8, k=4, mask_every=3,
                                      exclude=np.array([-1, 7, -1, 11])),
    "k_exceeding_allowed": dict(n=40, rank=8, k=6, allow_first=3),
    "duplicate_row_ties": dict(n=300, rank=8, k=20, ties=True),
    "valid_items": dict(n=300, rank=16, k=10, valid_items=200),
}


def _case(name, seed):
    c = CASES[name]
    n, rank = c["n"], c["rank"]
    if c.get("ties"):
        rng = np.random.default_rng(seed)
        base = rng.integers(-3, 4, (n // 3, rank)).astype(np.float32)
        items = np.concatenate([base, base, base])[rng.permutation(n)]
        user = rng.integers(-3, 4, rank).astype(np.float32)
    else:
        items, user = _rand(seed, n, rank), _rand(seed + 1, rank)
    mask = None
    if "mask_every" in c:
        mask = np.ones(n, bool)
        mask[::c["mask_every"]] = False
    if "allow_first" in c:
        mask = np.zeros(n, bool)
        mask[:c["allow_first"]] = True
    exclude = c.get("exclude")
    if exclude is not None:
        exclude = exclude.astype(np.int32)
    return items, user, c["k"], exclude, mask, c.get("valid_items")


@pytest.mark.parametrize("name", sorted(CASES))
def test_score_and_top_k_matches_xla_and_pallas(name):
    items, user, k, exclude, mask, valid = _case(name, seed=len(name))
    got = ttopk.score_and_top_k(_t(user), _t(items), k, exclude=_t(exclude),
                                allowed_mask=_t(mask), valid_items=valid)
    j = dict(exclude=None if exclude is None else jnp.asarray(exclude),
             allowed_mask=None if mask is None else jnp.asarray(mask))
    ref_xla = jtopk.score_and_top_k(jnp.asarray(user), jnp.asarray(items),
                                    k, valid_items=valid, **j)
    _assert_packed(got, ref_xla, allowed_only=True)
    if valid is not None:
        j["allowed_mask"] = jtopk._fold_valid_mask(
            j["allowed_mask"], jnp.asarray(items), valid)
    ref_pallas = score_and_top_k_pallas(
        jnp.asarray(user), jnp.asarray(items), k, interpret=True,
        block_items=128, **j)
    _assert_packed(got, ref_pallas)


def test_duplicate_rows_rank_lowest_id_first():
    items, user, k, *_ = _case("duplicate_row_ties", seed=3)
    s, i = kernels.score_topk(_t(user)[None], _t(items), None, k)
    s, i = s[0].numpy(), i[0].numpy()
    assert (np.diff(s) <= 0).all()
    for a in range(k - 1):
        if s[a] == s[a + 1]:
            assert i[a] < i[a + 1]
    assert (s[:-1] == s[1:]).any()  # the case really has ties


def test_user_row_gather_matches_reference():
    users, items = _rand(20, 30, 16), _rand(21, 400, 16)
    seen = np.array([3, 9, 250], np.int32)
    got = ttopk.score_user_and_top_k(
        _t(users), _t(items), 7, k=12,
        exclude=ttopk.pad_exclude(seen, device="cpu"))
    ref = jtopk.score_user_and_top_k(jnp.asarray(users), jnp.asarray(items),
                                     7, k=12,
                                     exclude=jtopk.pad_exclude(seen))
    _assert_packed(got, ref)


@pytest.mark.parametrize("batch", [0, 1, 5])
def test_batch_score_top_k_padding(batch):
    users, items = _rand(30, 40, 16), _rand(31, 300, 16)
    rows = list(np.random.default_rng(batch).integers(0, 40, batch))
    got = ttopk.batch_score_top_k(_t(users), _t(items), rows, k=10)
    ref = jtopk.batch_score_top_k(jnp.asarray(users), jnp.asarray(items),
                                  rows, k=10)
    assert tuple(got.shape) == np.asarray(ref).shape
    assert got.shape[1] == (ttopk.next_pow2(batch) if batch else 0)
    assert got.shape[2] == 16
    for b in range(got.shape[1]):
        _assert_packed(got[:, b], np.asarray(ref)[:, b])


def test_batch_valid_items_masks_tail():
    users, items = _rand(40, 8, 16), _rand(41, 300, 16)
    got = ttopk.batch_score_top_k(_t(users), _t(items), [1, 2, 3], k=8,
                                  valid_items=100)
    ref = jtopk.batch_score_top_k(jnp.asarray(users), jnp.asarray(items),
                                  [1, 2, 3], k=8, valid_items=100)
    assert (got[1] < 100).all()
    for b in range(4):
        _assert_packed(got[:, b], np.asarray(ref)[:, b])


@pytest.mark.parametrize("route", ["single", "batch"])
def test_k_above_128_takes_the_wide_route(route):
    users, items = _rand(50, 6, 16), _rand(51, 500, 16)
    if route == "single":
        got = ttopk.score_and_top_k(_t(users[2]), _t(items), 150)
        ref = jtopk.score_and_top_k(jnp.asarray(users[2]),
                                    jnp.asarray(items), 150)
        _assert_packed(got, ref)
    else:
        got = ttopk.batch_score_top_k(_t(users), _t(items), [0, 2, 5], 200)
        ref = np.asarray(jtopk.batch_score_top_k(
            jnp.asarray(users), jnp.asarray(items), [0, 2, 5], 200))
        assert tuple(got.shape) == ref.shape == (2, 4, 256)
        for b in range(4):
            _assert_packed(got[:, b], ref[:, b])


def test_top_k_with_exclusions_drops_negative_ids():
    scores = _rand(60, 50)
    mask = np.ones(50, bool)
    mask[:10] = False
    exclude = np.array([-1, 12, -3, 49], np.int32)
    got_s, got_i = ttopk.top_k_with_exclusions(
        _t(scores), 8, exclude=_t(exclude), allowed_mask=_t(mask))
    ref_s, ref_i = jtopk.top_k_with_exclusions(
        jnp.asarray(scores), 8, exclude=jnp.asarray(exclude),
        allowed_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=RTOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


def test_batch_matches_the_host_oracle_on_planted_data():
    """Against the exhaustive numpy oracle, which shares no code with
    either package's device path."""
    items = planted.planted_item_factors(3000, 32, seed=5)
    users = planted.planted_queries(items, 40, seed=6)
    got = ttopk.batch_score_top_k(_t(users), _t(items), list(range(40)), 20)
    np.testing.assert_array_equal(got[1][:40, :20].numpy().astype(np.int64),
                                  planted.exhaustive_top_k(items, users, 20))


def test_helpers_match_reference():
    for n in (0, 1, 2, 3, 64, 65, 1000):
        assert ttopk.next_pow2(n) == jtopk.next_pow2(n)
    for cap in (1, 7, 64, 512):
        assert ttopk.ladder_rungs(cap) == jtopk.ladder_rungs(cap)
    assert ttopk.pad_exclude([], device="cpu") is None
    np.testing.assert_array_equal(
        ttopk.pad_exclude([4, 1, 9], device="cpu").numpy(),
        np.asarray(jtopk.pad_exclude([4, 1, 9])))


def test_cpu_calls_launch_no_kernel():
    runtime.reset_launch_counts()
    items, user = _rand(70, 100, 8), _rand(71, 8)
    ttopk.score_and_top_k(_t(user), _t(items), 5)
    ttopk.batch_score_top_k(_t(items[:4]), _t(items), [0, 1, 2], 150)
    assert kernels.SCORE_TOPK_LAUNCHES.value == 0
    assert ttopk.WIDE_TOPK_CALLS.value == 0


def test_kernel_wrapper_rejects_bad_k():
    items, user = _rand(80, 100, 8), _rand(81, 8)
    for k in (0, 129):
        with pytest.raises(ValueError):
            kernels.score_topk(_t(user)[None], _t(items), None, k)
