"""The port's CUDA kernel against its plain PyTorch version, on a card.

Imports only torch, numpy and the port, so it runs on a machine without
JAX: ``python -m pytest tests/test_torch_cuda.py --noconftest -q``. Every
test here carries the ``cuda`` marker and skips without a CUDA device.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from udal_tpu_torch.ops import cuda_nms, nms  # noqa: E402


def random_batch(seed, n, b=2, tied=False, size=256):
    """[b, n, 4] boxes and [b, n] scores drawn as tests/test_pallas_nms.py
    draws them; ``tied`` draws scores from three values, so ties are
    everywhere and break by the lowest index."""
    rng = np.random.RandomState(seed)
    y1 = rng.uniform(0, size - 30, (b, n))
    x1 = rng.uniform(0, size - 30, (b, n))
    h = rng.uniform(10, 80, (b, n))
    w = rng.uniform(10, 80, (b, n))
    boxes = np.stack([y1, x1, y1 + h, x1 + w], -1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (b, n)).astype(np.float32)
    if tied:
        scores = np.asarray([0.3, 0.6, 0.9], np.float32)[rng.randint(0, 3, (b, n))]
    return boxes, scores


def score_threshold(sigma):
    return 0.001 if sigma > 0 else float("-inf")


def assert_same_picks(got, want_idx, want_scores, want_len):
    """Equal valid_len, equal indices over it, scores to rtol 1e-6."""
    np.testing.assert_array_equal(got.valid_len.cpu().numpy(), want_len)
    for i, n in enumerate(want_len):
        np.testing.assert_array_equal(got.indices[i, :n].cpu().numpy(), want_idx[i][:n])
        np.testing.assert_allclose(got.scores[i, :n].cpu().numpy(), want_scores[i][:n],
                                   rtol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("sigma,tied,n,k", [(0.0, False, 5000, 100), (0.5, False, 5000, 100),
                                            (0.5, True, 5000, 100), (0.5, False, 200, 20),
                                            (0.0, False, 8000, 100)])
def test_kernel_matches_plain_on_the_card(cuda, sigma, tied, n, k):
    """B=8 at the main path's N=5000, K=100, plus a small and the largest
    supported N: the kernel keeps the plain version's arithmetic."""
    boxes, scores = random_batch(4, n, b=8, tied=tied)
    b = torch.from_numpy(boxes).to(cuda)
    s = torch.from_numpy(scores).to(cuda)
    thr = score_threshold(sigma)
    want = nms.batched_soft_nms(b, s, k, 0.5, thr, sigma)
    before = cuda_nms.launches
    got = cuda_nms.batched_soft_nms(b, s, k, 0.5, thr, sigma)
    torch.cuda.synchronize()
    assert cuda_nms.launches == before + 1
    assert_same_picks(got, want.indices.cpu().numpy(), want.scores.cpu().numpy(),
                      want.valid_len.cpu().numpy())


@pytest.mark.cuda
def test_kernel_refuses_more_candidates_than_it_holds(cuda):
    n = cuda_nms.MAX_CANDIDATES + 1
    with pytest.raises(ValueError, match="at most"):
        cuda_nms.soft_nms_cuda(torch.zeros(1, n, 4, device=cuda),
                               torch.zeros(1, n, device=cuda), 10, 0.5, 0.001, 0.5)
