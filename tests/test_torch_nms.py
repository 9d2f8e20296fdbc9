"""Soft-NMS of the PyTorch port on the CPU.

The plain version (``udal_tpu_torch.ops.nms``) against the JAX package's
``nms.soft_nms`` and its Pallas kernel in interpret mode, on the same
inputs, and the wrapper's routing and checks. The kernel itself is held
against the plain version on a card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu.ops import nms as jax_nms  # noqa: E402
from udal_tpu.ops.pallas_nms import pallas_soft_nms  # noqa: E402
from tests.test_torch_cuda import assert_same_picks, random_batch, score_threshold  # noqa: E402
from udal_tpu_torch.ops import cuda_nms, nms  # noqa: E402


CASES = [(sigma, seed, n, k, False) for sigma in (0.0, 0.5) for seed in (0, 1)
         for n, k in ((200, 20), (5000, 100))] + \
    [(sigma, 2, 500, 50, True) for sigma in (0.0, 0.5)]


@pytest.mark.parametrize("sigma,seed,n,k,tied", CASES)
def test_plain_matches_jax_and_pallas_interpret(sigma, seed, n, k, tied):
    boxes, scores = random_batch(seed, n, tied=tied)
    thr = score_threshold(sigma)
    got = nms.batched_soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores), k,
                               0.5, thr, sigma)
    for ref_fn in (lambda b, s: jax_nms.soft_nms(b, s, k, 0.5, thr, sigma),
                   lambda b, s: pallas_soft_nms(b, s, k, 0.5, thr, sigma,
                                                interpret=True)):
        refs = [ref_fn(b, s) for b, s in zip(boxes, scores)]
        assert_same_picks(got, [np.asarray(r.indices) for r in refs],
                           [np.asarray(r.scores) for r in refs],
                           np.asarray([int(r.valid_len) for r in refs]))
    assert got.scores[~got.valid].abs().sum() == 0
    single = nms.soft_nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), k,
                          0.5, thr, sigma)
    for g, w in zip(single, got):
        assert torch.equal(g, w[0])


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    boxes, scores = random_batch(3, 300)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    before = cuda_nms.launches
    got = cuda_nms.batched_soft_nms(b, s, 30)
    want = nms.batched_soft_nms(b, s, 30)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cuda_nms.launches == before


@pytest.mark.parametrize("boxes,scores,err", [
    (torch.zeros(2, 10, 4, dtype=torch.float64), torch.zeros(2, 10), TypeError),
    (torch.zeros(2, 10, 5), torch.zeros(2, 10), ValueError),
    (torch.zeros(2, 10, 4), torch.zeros(2, 9), ValueError),
    (torch.zeros(2, 4, 10).transpose(1, 2), torch.zeros(2, 10), ValueError),
])
def test_wrapper_checks_its_inputs(boxes, scores, err):
    with pytest.raises(err):
        cuda_nms.batched_soft_nms(boxes, scores, 5)


def test_kernel_entry_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_nms.soft_nms_cuda(torch.zeros(1, 8, 4), torch.zeros(1, 8), 4, 0.5, 0.001, 0.5)
