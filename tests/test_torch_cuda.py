"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports only torch, numpy and the port, so it runs on a machine without
JAX: ``python -m pytest tests/test_torch_cuda.py --noconftest -q``. Every
test here carries the ``cuda`` marker and skips without a CUDA device.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from udal_tpu_torch.ops import cuda_nms, fused_dw, fused_mbconv, nms  # noqa: E402


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


def bf16_ulp(t):
    """The spacing of bfloat16 values at |t| (8 significant bits)."""
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def assert_bf16_close(got, want, ulps, top_ulps):
    """|got - want| <= ulps · ulp(|want|) + top_ulps · ulp(max |want|)."""
    got, want = got.float(), want.float()
    bound = ulps * bf16_ulp(want) + top_ulps * bf16_ulp(want.abs().max())
    excess = ((got - want).abs() - bound).max().item()
    assert excess <= 0, f"exceeds {ulps} + {top_ulps} top bf16 ulps by {excess}"


def dw_operands(seed, n, c, h, w, k, dev, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = f32(rng.normal(0, 1, (n, c, h, w))).to(dtype)
    taps = f32(rng.normal(0, 1 / k, (c, k, k)))
    scale = f32(rng.uniform(0.5, 1.5, c))
    bias = f32(rng.normal(0, 0.1, c))
    mask = f32((rng.uniform(size=(n, c)) < 0.9) / 0.9)
    return x, taps, scale, bias, mask


@pytest.fixture
def no_tf32(cuda):
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = before


@pytest.mark.cuda
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("act,masked,mean", [("swish", True, True), ("identity", False, False),
                                             ("relu6", True, False)])
def test_fused_dw_kernel_matches_plain_f32(no_tf32, k, s, act, masked, mean):
    """f32, odd sizes (ragged spatial and channel tiles): the sums differ
    from cuDNN's only in order, so 1e-5 absolute on O(1) outputs."""
    x, taps, scale, bias, mask = dw_operands(0, 2, 11, 19, 70, k, no_tf32)
    mask = mask if masked else None
    want = fused_dw.fused_depthwise_plain(x, taps, scale, bias, mask, s, act, mean)
    before = fused_dw.launches
    got = fused_dw.fused_depthwise(x, taps, scale, bias, mask, s, act, mean)
    torch.cuda.synchronize()
    assert fused_dw.launches == before + 1
    for g, w in zip(got if mean else [got], want if mean else [want]):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k,s", [(3, 1), (5, 2)])
def test_fused_dw_kernel_matches_plain_bf16(cuda, k, s):
    """bf16 in and out, f32 inside both: the outputs are the same f32 values
    up to summation order, rounded once, so within one bf16 ulp; plus 1% of
    an ulp of the largest value for outputs near zero, where the
    pre-activation cancels and its f32 error scales with the terms."""
    x, taps, scale, bias, mask = dw_operands(1, 3, 16, 33, 40, k, cuda, torch.bfloat16)
    want_y, want_m = fused_dw.fused_depthwise_plain(x, taps, scale, bias, mask, s, "swish", True)
    got_y, got_m = fused_dw.fused_depthwise(x, taps, scale, bias, mask, s, "swish", True)
    assert got_y.dtype == torch.bfloat16 and got_m.dtype == torch.float32
    assert_bf16_close(got_y, want_y, 1, 0.01)
    torch.testing.assert_close(got_m, want_m, atol=1e-5, rtol=1e-5)


def expand_operands(seed, n, cin, ce, h, w, k, dev, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = f32(rng.normal(0, 1, (n, cin, h, w))).to(dtype)
    we = f32(rng.normal(0, 1 / np.sqrt(cin), (cin, ce)))
    b0 = f32(rng.normal(0, 0.1, ce))
    wd = f32(rng.normal(0, 1 / k, (ce, k, k)))
    b1 = f32(rng.normal(0, 0.1, ce))
    m1 = f32((rng.uniform(size=(n, ce)) < 0.9) / 0.9)
    m2 = f32((rng.uniform(size=(n, ce)) < 0.9) / 0.9)
    return x, we, b0, m1, wd, b1, m2


@pytest.mark.cuda
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("masked", [True, False])
def test_fused_expand_dw_kernel_matches_plain_f32(no_tf32, k, s, masked):
    """f32, Ce = 40 (a ragged channel tile), 70 columns (two column tiles at
    stride 1): sums over Cin and the taps in another order, so 1e-5."""
    x, we, b0, m1, wd, b1, m2 = expand_operands(2, 2, 24, 40, 17, 70, k, no_tf32)
    if not masked:
        m1 = m2 = None
    want = fused_mbconv.fused_expand_dw_plain(x, we, b0, m1, wd, b1, m2, s, k)
    before = fused_mbconv.launches
    got = fused_mbconv.fused_expand_dw(x, we, b0, m1, wd, b1, m2, s, k)
    torch.cuda.synchronize()
    assert fused_mbconv.launches == before + 1
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k,s", [(3, 2), (5, 1)])
def test_fused_expand_dw_kernel_matches_plain_bf16(cuda, k, s):
    """bf16: z is rounded to bf16 on both sides, but a z whose f32 values
    differ in the last bits can round apart; so 2 ulps of each value plus
    one ulp of the largest."""
    x, we, b0, m1, wd, b1, m2 = expand_operands(3, 4, 32, 96, 24, 40, k, cuda, torch.bfloat16)
    want = fused_mbconv.fused_expand_dw_plain(x, we, b0, m1, wd, b1, m2, s, k)
    got = fused_mbconv.fused_expand_dw(x, we, b0, m1, wd, b1, m2, s, k)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert_bf16_close(got[0], want[0], 2, 1)
    torch.testing.assert_close(got[1], want[1], atol=1e-2, rtol=1e-3)


@pytest.mark.cuda
def test_fused_kernels_raise_on_what_they_do_not_take(cuda):
    """No fallback: a CUDA tensor the kernels do not take raises."""
    x, taps, scale, bias, mask = dw_operands(4, 2, 8, 9, 9, 3, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_dw.fused_depthwise(x.half(), taps, scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dw.fused_depthwise(x.transpose(2, 3), taps, scale, bias)
    with pytest.raises(ValueError, match="k in"):
        fused_dw.fused_depthwise(x, torch.zeros(8, 7, 7, device=cuda), scale, bias)
    with pytest.raises(ValueError, match="mask"):
        fused_dw.fused_depthwise(x, taps, scale, bias, mask[:1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_dw.fused_depthwise_cuda(x.cpu(), taps.cpu(), scale.cpu(), bias.cpu())
    x, we, b0, m1, wd, b1, m2 = expand_operands(5, 2, 8, 16, 9, 9, 3, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_mbconv.fused_expand_dw(x.half(), we, b0, m1, wd, b1, m2, 1, 3)
    with pytest.raises(TypeError, match="we"):
        fused_mbconv.fused_expand_dw(x, we.bfloat16(), b0, m1, wd, b1, m2, 1, 3)
    with pytest.raises(ValueError, match="stride"):
        fused_mbconv.fused_expand_dw(x, we, b0, m1, wd, b1, m2, 3, 3)
