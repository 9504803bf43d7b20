"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where no CUDA device is present. On a
machine with one (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: both sides are f32 but sum the rank in
different orders, so scores agree to rtol 1e-5 and ids except among
near-ties.
"""

import numpy as np
import pytest
import torch

from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.ops import kernels, topk

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
