"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports only torch, numpy and the port, so it runs on a machine without
JAX: ``python -m pytest tests/test_torch_cuda.py --noconftest -q``. Every
test here carries the ``cuda`` marker and skips without a CUDA device.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.ops import cuda_nms, fused_dw, fused_mbconv, nms, packed  # noqa: E402
from udal_tpu_torch.utils import profiling  # noqa: E402


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
@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("n", [1, 37, 4999, 5000, 8192])
@pytest.mark.parametrize("mode", ["gaussian", "hard", "tied"])
def test_cluster_kernel_matches_plain(cuda, b, n, mode):
    """The cluster of blocks an image gives the plain version's picks
    (equal valid_len and indices, scores within 1e-6), and a second launch
    gives the same picks bit for bit: from one candidate (blocks with empty
    shards) to the largest N, one to 16 images."""
    boxes, scores = random_batch(20 + n, n, b=b, tied=mode == "tied")
    sigma = 0.0 if mode == "hard" else 0.5
    bt, st = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    thr = score_threshold(sigma)
    want = nms.batched_soft_nms(bt, st, 100, 0.5, thr, sigma)
    runs = [cuda_nms.soft_nms_cuda(bt, st, 100, 0.5, thr, sigma) for _ in range(2)]
    torch.cuda.synchronize()
    assert_same_picks(runs[0], want.indices.cpu().numpy(), want.scores.cpu().numpy(),
                      want.valid_len.cpu().numpy())
    for g, w in zip(runs[1], runs[0]):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cluster_kernel_breaks_ties_across_shards(cuda):
    """Equal top scores at the edges of different blocks' shards (the last
    candidate of shard 0, the first of the last shard, one inside shard 1),
    and an equal runner-up pair across shards, on boxes that do not overlap:
    the picks go to the lowest index first, as in the plain version."""
    n = 5000
    boxes, scores = random_batch(31, n, b=2)
    scores = scores * 0.5
    spans = cuda_nms.shards(n)
    top = [spans[0][1] - 1, spans[-1][0], spans[1][0] + 5]
    runner = [spans[-1][1] - 1, spans[1][0]]
    for i, j in enumerate(top + runner):
        boxes[:, j] = [1000.0 * (i + 1), 0.0, 1000.0 * (i + 1) + 10.0, 10.0]
    scores[:, top] = 0.9
    scores[:, runner] = 0.8
    bt, st = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    want = nms.batched_soft_nms(bt, st, 20, 0.5, 0.001, 0.5)
    got = cuda_nms.soft_nms_cuda(bt, st, 20, 0.5, 0.001, 0.5)
    torch.cuda.synchronize()
    assert got.indices[0, :5].tolist() == sorted(top) + sorted(runner)
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


def launched_path(path, fn):
    """fn's result, after checking that it launched the fused depthwise
    kernel once, on ``path``."""
    before = dict(fused_dw.path_launches)
    out = fn()
    torch.cuda.synchronize()
    after = dict(fused_dw.path_launches)
    assert after[path] == before[path] + 1 and sum(after.values()) == sum(before.values()) + 1
    return out


def assert_means_close(got, want):
    """SE means within 1e-3 of the largest."""
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fast", "general"])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("masked,mean", [(True, True), (False, False), (True, False),
                                         (False, True)])
def test_fused_dw_paths_match_plain_f32(no_tf32, path, k, s, masked, mean):
    """Both paths at W = 64 (rows of whole 16-byte groups), 19 rows (a
    ragged last band) and 11 channels: f32 within 1e-5, means within 1e-3
    of the largest."""
    x, taps, scale, bias, mask = dw_operands(21, 2, 11, 19, 64, k, no_tf32)
    mask = mask if masked else None
    want = fused_dw.fused_depthwise_plain(x, taps, scale, bias, mask, s, "swish", mean)
    got = launched_path(path, lambda: fused_dw.fused_depthwise_cuda(
        x, taps, scale, bias, mask, s, "swish", mean, path))
    if mean:
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
        assert_means_close(got[1], want[1])
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fast", "general"])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("masked,mean", [(True, True), (False, False)])
def test_fused_dw_paths_match_plain_bf16(cuda, path, k, s, masked, mean):
    """Both paths in bf16 at 33 x 40: within 1 bf16 ulp plus 1% of the top
    ulp, means within 1e-3 of the largest."""
    x, taps, scale, bias, mask = dw_operands(22, 3, 16, 33, 40, k, cuda, torch.bfloat16)
    mask = mask if masked else None
    want = fused_dw.fused_depthwise_plain(x, taps, scale, bias, mask, s, "swish", mean)
    got = launched_path(path, lambda: fused_dw.fused_depthwise_cuda(
        x, taps, scale, bias, mask, s, "swish", mean, path))
    if mean:
        assert_bf16_close(got[0], want[0], 1, 0.01)
        assert_means_close(got[1], want[1])
    else:
        assert_bf16_close(got, want, 1, 0.01)


@pytest.mark.cuda
def test_fused_dw_mc_prefix_takes_the_fast_path(cuda):
    """The MC prefix's shape (8 x 32 x 256 x 512 bf16, k3 s1, with the
    mean) goes to the fast path by default and holds its tolerances."""
    x, taps, scale, bias, _ = dw_operands(23, 8, 32, 256, 512, 3, cuda, torch.bfloat16)
    want = fused_dw.fused_depthwise_plain(x, taps, scale, bias, None, 1, "swish", True)
    got = launched_path("fast", lambda: fused_dw.fused_depthwise(x, taps, scale, bias, None, 1,
                                                                 "swish", True))
    assert_bf16_close(got[0], want[0], 1, 0.01)
    assert_means_close(got[1], want[1])


@pytest.mark.cuda
def test_fused_dw_general_path_takes_what_the_fast_path_does_not(cuda):
    """Rows that are not whole 16-byte groups (W = 70 in f32, W = 20 in
    bf16), a view 2 bytes off an aligned address and a band that does not
    fit the ring (f32, k5 s2, W = 2048) go to the general path, which holds
    the tolerances; asking for the fast path there raises."""
    cases = [dw_operands(24, 2, 5, 9, 70, 3, cuda), dw_operands(25, 2, 5, 9, 20, 3, cuda,
                                                                torch.bfloat16),
             dw_operands(26, 1, 3, 9, 2048, 5, cuda)]
    base = torch.empty(2 * 5 * 9 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    view = base[1:].view(2, 5, 9, 64)
    view.copy_(dw_operands(27, 2, 5, 9, 64, 3, cuda, torch.bfloat16)[0])
    assert view.data_ptr() % 16 != 0
    cases.append((view,) + cases[1][1:])
    for (x, taps, scale, bias, mask), s in zip(cases, (1, 1, 2, 1)):
        want = fused_dw.fused_depthwise_plain(x, taps, scale, bias, mask, s, "swish", True)
        got = launched_path("general", lambda: fused_dw.fused_depthwise(
            x, taps, scale, bias, mask, s, "swish", True))
        if x.dtype == torch.bfloat16:
            assert_bf16_close(got[0], want[0], 1, 0.01)
        else:
            torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
        assert_means_close(got[1], want[1])
        with pytest.raises(ValueError, match="fast path"):
            fused_dw.fused_depthwise_cuda(x, taps, scale, bias, mask, s, path="fast")


@pytest.mark.cuda
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_fused_dw_planner_counts_the_kernels_shared_memory(cuda, k, s):
    """The band planner's ring model equals the source's count at every
    band height, for bf16 and f32 rows of the widths d0 and the tests use."""
    for itemsize in (2, 4):
        for w in (40, 64, 256, 512, 1024):
            _, _, iwx = fused_dw.row_window(w, k, s, itemsize)
            for th in fused_dw.ROW_BANDS:
                assert (fused_dw.kernel_row_smem_bytes(itemsize == 2, th, iwx, k, s)
                        == fused_dw.row_smem_bytes(th, iwx, k, s, itemsize))


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
    got = fused_mbconv.fused_expand_dw(x, we, b0, m1, wd, b1, m2, s, k, "swish",
                                       fused_mbconv.split_weights(we))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert_bf16_close(got[0], want[0], 2, 1)
    torch.testing.assert_close(got[1], want[1], atol=1e-2, rtol=1e-3)


# the distinct (Cin, Ce, k, s) of EfficientNet-B0's expand blocks 1-15
D0_EXPAND = [(16, 96, 3, 2), (24, 144, 3, 1), (24, 144, 5, 2), (40, 240, 5, 1), (40, 240, 3, 2),
             (80, 480, 3, 1), (80, 480, 5, 1), (112, 672, 5, 1), (112, 672, 5, 2),
             (192, 1152, 5, 1), (192, 1152, 3, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,ce,k,s", D0_EXPAND)
def test_fused_expand_dw_tc_matches_plain_at_d0_blocks(cuda, cin, ce, k, s):
    """The bf16 kernel (expand on tensor cores, We split in hi and lo) at
    every block shape of d0, at 20x40: several pixel passes, Cin through
    the 16-channel ring, a ragged last channel tile at Ce = 144 and 240.
    The tolerance of the main path's check: 2 ulps plus 1 ulp of the
    largest y, SE sums to 1e-3 of the largest."""
    x, we, b0, m1, wd, b1, m2 = expand_operands(12, 2, cin, ce, 20, 40, k, cuda, torch.bfloat16)
    want = fused_mbconv.fused_expand_dw_plain(x, we, b0, m1, wd, b1, m2, s, k)
    before = fused_mbconv.launches
    got = fused_mbconv.fused_expand_dw_cuda(x, we, b0, m1, wd, b1, m2, s, k, "swish",
                                            fused_mbconv.split_weights(we))
    torch.cuda.synchronize()
    assert fused_mbconv.launches == before + 1
    assert_bf16_close(got[0], want[0], 2, 1)
    torch.testing.assert_close(got[1], want[1], rtol=1e-3,
                               atol=1e-3 * want[1].abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("k,s", [(3, 1), (5, 2)])
def test_fused_expand_dw_tc_takes_odd_widths_and_views(cuda, k, s):
    """W = 21 and Cin = 20 (plain loads instead of 16-byte copies), and x as
    a view 2 bytes off an aligned address: the same values."""
    x, we, b0, m1, wd, b1, m2 = expand_operands(13, 3, 20, 48, 19, 21, k, cuda, torch.bfloat16)
    want = fused_mbconv.fused_expand_dw_plain(x, we, b0, m1, wd, b1, m2, s, k)
    got = fused_mbconv.fused_expand_dw(x, we, b0, m1, wd, b1, m2, s, k, "swish",
                                       fused_mbconv.split_weights(we))
    assert_bf16_close(got[0], want[0], 2, 1)
    x2, we2, b0, m1, wd, b1, m2 = expand_operands(14, 2, 24, 96, 16, 32, k, cuda, torch.bfloat16)
    base = torch.empty(x2.numel() + 1, dtype=torch.bfloat16, device=cuda)
    xv = base[1:].view(x2.shape)
    xv.copy_(x2)
    assert xv.data_ptr() % 16 != 0
    want = fused_mbconv.fused_expand_dw_plain(x2, we2, b0, m1, wd, b1, m2, s, k)
    got = fused_mbconv.fused_expand_dw(xv, we2, b0, m1, wd, b1, m2, s, k, "swish",
                                       fused_mbconv.split_weights(we2))
    assert_bf16_close(got[0], want[0], 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,ce,k,s", D0_EXPAND + [(640, 3840, 3, 1), (384, 2304, 5, 1)])
def test_fused_expand_dw_planner_counts_the_kernels_shared_memory(cuda, cin, ce, k, s):
    """The tile planners' shared-memory model equals the source's count, for
    both kernels and both bf16 layouts at d0's block shapes and B7's
    widest, at the spatial sizes of d0's stages at 1024x512, of B7's
    deepest at 1536x768 and at the tests' 20x40."""
    for h, w in ((20, 40), (256, 512), (128, 256), (64, 128), (32, 64), (16, 32), (24, 48)):
        ho, wo = -(-h // s), -(-w // s)
        for vec in (False, True):
            th, tw, streamed = fused_mbconv.tc_tile_shape(ho, wo, cin, s, k, vec)
            assert (fused_mbconv.kernel_smem_bytes(True, cin, th, tw, s, k, streamed)
                    == fused_mbconv.tc_smem_bytes(cin, th, tw, s, k, streamed))
            assert (fused_mbconv.kernel_smem_bytes(True, cin, th, tw, s, k, not streamed)
                    == fused_mbconv.tc_smem_bytes(cin, th, tw, s, k, not streamed))
        th, tw = fused_mbconv.tile_shape(ho, wo, cin, s, k)
        assert (fused_mbconv.kernel_smem_bytes(False, cin, th, tw, s, k, False)
                == fused_mbconv.smem_bytes(cin, th, tw, s, k))


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
    with pytest.raises(ValueError, match="we_split"):
        fused_mbconv.fused_expand_dw(x.bfloat16(), we, b0, m1, wd, b1, m2, 1, 3)


def bf16_normal(seed, shape, dev, scale=1.0):
    x = np.random.RandomState(seed).normal(0, scale, shape).astype(np.float32)
    return torch.from_numpy(x).to(dev).bfloat16()


def launched(name, fn):
    """fn's result, after checking that it launched ``name``'s kernel once."""
    before = packed.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert packed.launches[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,m_tile", [(96, 40, 200, 32), (90, 27, 13, 45),
                                          (130, 192, 1152, 65), (327680, 192, 1152, 512)])
def test_packed_pointwise_kernel_matches_plain(cuda, m, k, n, m_tile):
    """Tensor-core products summed in another order than the plain f32
    product, rounded once: within 1 bf16 ulp plus 1% of an ulp of the
    largest value (near zero the sum cancels). Odd K and N (zero-padded
    fragments, the scalar path), row passes cut short by m_tile, and the
    tool's shape."""
    xp, w = bf16_normal(5, (m, k), cuda), bf16_normal(6, (k, n), cuda, 0.1)
    got = launched("packed_pointwise", lambda: packed.packed_pointwise(xp, w, m_tile))
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert_bf16_close(got, packed.packed_pointwise_plain(xp, w, m_tile), 1, 0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,m_tile", [(65536, 72, 200, 128), (8192, 200, 136, 8192),
                                          (3000, 27, 13, 125), (20000, 512, 264, 400)])
def test_packed_pointwise_ring_wraps(cuda, m, k, n, m_tile):
    """Shapes where a block walks many row tiles and its stage ring wraps:
    K not a multiple of 16 (72, 200, 27) or of the 64-column stage, N not
    a multiple of 128, one unit larger than the grid, the largest K."""
    xp, w = bf16_normal(15, (m, k), cuda), bf16_normal(16, (k, n), cuda, 0.1)
    got = launched("packed_pointwise", lambda: packed.packed_pointwise(xp, w, m_tile))
    assert_bf16_close(got, packed.packed_pointwise_plain(xp, w, m_tile), 1, 0.01)


@pytest.mark.cuda
def test_packed_pointwise_takes_a_misaligned_view(cuda):
    """x 2 bytes off an aligned address: plain loads and stores, the same
    values."""
    base = bf16_normal(17, (640 * 48 + 1,), cuda)
    xp = base[1:].view(640, 48)
    assert xp.data_ptr() % 16 != 0
    w = bf16_normal(18, (48, 136), cuda, 0.1)
    got = launched("packed_pointwise", lambda: packed.packed_pointwise(xp, w, 64))
    assert_bf16_close(got, packed.packed_pointwise_plain(xp, w, 64), 1, 0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cexp", [((2, 8, 3, 15), 5), ((2, 16, 4, 128), 16),
                                        ((80, 128, 32, 1152), 144)])
@pytest.mark.parametrize("direction", [1, -1])
def test_packed_wshift_kernel_matches_plain(cuda, shape, cexp, direction):
    """Exact: C = 5 (scalar path), C = 16 and the tool's C = 144 (16-byte
    vectors)."""
    x = bf16_normal(7, shape, cuda)
    g = shape[-1] // cexp
    got = launched("packed_wshift", lambda: packed.packed_wshift(x, cexp, g, direction))
    assert torch.equal(got, packed.packed_wshift_plain(x, cexp, g, direction))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,cin,tile", [(21, 15, 5, 7), (24, 40, 5, 8),
                                                (1000, 24, 3, 8), (40960, 192, 24, 512)])
@pytest.mark.parametrize("name", ["add_one_natural", "add_one_packed"])
def test_add_one_kernels_match_plain(cuda, rows, cols, cin, tile, name):
    """Exact: 315 values (scalar path), one and several 8192-value blocks
    with a ragged last one, and the tool's [40960, 192]."""
    x = bf16_normal(8, (rows, cols), cuda, 4.0)
    got = launched(name, lambda: getattr(packed, name)(x, cin, tile))
    assert torch.equal(got, packed.add_one_plain(x, cin, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3, 8])
@pytest.mark.parametrize("rows", [7, 600001])
def test_add_one_body_takes_odd_totals_and_unaligned_offsets(cuda, rows, offset):
    """Bit-equal to the plain version over 105 and 9,000,015 values (odd:
    a scalar tail after the vectors; the larger spans more than one wave of
    the grid-stride loop), from views ``offset`` values past an aligned
    address (1 and 3: every value on the scalar path; 8: vectors again)."""
    base = bf16_normal(12, (rows * 15 + offset,), cuda, 4.0)
    x = base[offset:].view(rows, 15)
    assert (x.data_ptr() % 16 == 0) == (offset % 8 == 0)
    for name in ("add_one_natural", "add_one_packed"):
        got = launched(name, lambda: getattr(packed, name)(x, 5, 1))
        assert torch.equal(got, packed.add_one_plain(x, 5, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cexp", [((2, 8, 3, 15), 5), ((2, 8, 5, 128), 16),
                                        ((8, 128, 32, 1152), 144)])
def test_packed_dw_w3_kernel_matches_plain(cuda, shape, cexp):
    """The plain version's products and sums in its order, uncontracted,
    rounded once: within 1 bf16 ulp (the kernel is built to be exact)."""
    x = bf16_normal(9, shape, cuda)
    taps = bf16_normal(10, (3, shape[-1]), cuda, 0.5)
    got = launched("packed_dw_w3", lambda: packed.packed_dw_w3(x, taps, cexp))
    assert_bf16_close(got, packed.packed_dw_w3_plain(x, taps, cexp), 1, 0)


@pytest.mark.cuda
def test_packed_kernels_take_misaligned_views(cuda):
    """A contiguous view 2 bytes past an aligned address takes the scalar
    path and gives the same values."""
    base = bf16_normal(11, (8 * 16 * 2 * 16 + 1,), cuda)
    x = base[1:].view(1 * 8 * 16, 2 * 16)
    assert x.data_ptr() % 16 != 0
    got = launched("add_one_packed", lambda: packed.add_one_packed(x, 16, 8))
    assert torch.equal(got, packed.add_one_plain(x, 16, 8))
    x4 = base[1:1 + 8 * 2 * 16].view(1, 8, 2, 16)
    got = launched("packed_wshift", lambda: packed.packed_wshift(x4, 8, 2, 1))
    assert torch.equal(got, packed.packed_wshift_plain(x4, 8, 2, 1))


@pytest.mark.cuda
def test_packed_kernels_raise_on_what_they_do_not_take(cuda):
    """No fallback: a CUDA tensor the kernels do not take raises."""
    with pytest.raises(TypeError, match="bfloat16"):
        packed.packed_pointwise(torch.zeros(16, 8, device=cuda), torch.zeros(8, 8, device=cuda), 16)
    with pytest.raises(TypeError, match="bfloat16"):
        packed.packed_wshift(torch.zeros(1, 8, 2, 16, device=cuda), 8, 2, 1)
    with pytest.raises(ValueError, match="K <="):
        packed.packed_pointwise(bf16_normal(0, (16, 520), cuda), bf16_normal(0, (520, 8), cuda),
                                16)
    with pytest.raises(ValueError, match="C4"):
        packed.packed_pointwise(bf16_normal(0, (100, 8), cuda), bf16_normal(0, (8, 8), cuda), 64)


# -- the inference surface's new operands and paths ---------------------------

SMALL = dict(image_size="128x128", num_classes=8, loss_attenuation=True, fpn_cell_repeats=1,
             box_class_repeats=1)
HEAD_ONLY = dict(mc_dropout=True, mc_classheadrate=0.05, mc_boxheadrate=0.05,
                 mc_dropoutsamp=3, enable_softmax=True)


class HostDropout:
    """Dropout bits drawn on the host, so a CPU and a card run share them."""

    def __init__(self, seed):
        self.generator = torch.Generator().manual_seed(seed)

    def draw(self, n, c, keep, device):
        return (torch.rand((n, c), generator=self.generator) < keep).to(device)


def kernel_counts():
    return fused_dw.launches, fused_mbconv.launches, cuda_nms.launches


def random_state(seed):
    """The small config's weights from ``seed``: convs at lecun scale, BN
    scales and variances in [0.5, 1.5], the rest N(0, 0.1), so that the
    class scores spread out (flax's initializers make them nearly equal,
    and near ties let f32 sums in another order reorder NMS picks). Fuse
    edge weights in [0.5, 1.5] too."""
    from udal_tpu_torch.config import get_detection_config
    from udal_tpu_torch.models.efficientdet import EfficientDetNet

    g = torch.Generator().manual_seed(seed)
    state = {}
    for k, v in EfficientDetNet(get_detection_config("efficientdet-d0").override(SMALL)) \
            .state_dict().items():
        if v.dim() == 4:
            state[k] = torch.randn(v.shape, generator=g) / float(np.prod(v.shape[1:])) ** 0.5
        elif k.endswith(("running_var", "edge_weights", "weight")):    # BN scales: 1-d
            state[k] = 0.5 + torch.rand(v.shape, generator=g)
        else:
            state[k] = 0.1 * torch.randn(v.shape, generator=g)
    return state


def small_driver(device, extra, state=None, **kwargs):
    from udal_tpu_torch.apps.serving import ServingDriver

    driver = ServingDriver.create("efficientdet-d0", state if state is not None else
                                  random_state(3), overrides={**SMALL, **extra},
                                  dtype=torch.float32, device=device, **kwargs)
    driver.masks = HostDropout(4)
    return driver


def assert_same_detection_sets(got, want):
    """Equal valid_len; per image the same scores and classes once sorted
    (the card's f32 sums run in another order)."""
    np.testing.assert_array_equal(got.valid_len.cpu().numpy(), want.valid_len.cpu().numpy())
    for i, n in enumerate(want.valid_len.tolist()):
        g, w = got.scores[i, :n].cpu(), want.scores[i, :n].cpu()
        torch.testing.assert_close(g.sort().values, w.sort().values, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.5, 0.0], ids=["gaussian", "hard"])
def test_kernel_matches_plain_on_per_class_operands(cuda, sigma):
    """Boxes shifted by class ids in [0, 10) times 2·1024 (up to 18,688 px),
    as ``per_class_nms`` shifts them at 1024x512."""
    boxes, scores = random_batch(7, 5000, b=8)
    classes = np.random.RandomState(8).randint(0, 10, (8, 5000, 1)).astype(np.float32)
    b = torch.from_numpy(boxes + classes * 2048.0).to(cuda)
    s = torch.from_numpy(scores).to(cuda)
    want = nms.batched_soft_nms(b.cpu(), s.cpu(), 100, 0.5, score_threshold(sigma), sigma)
    got = cuda_nms.batched_soft_nms(b, s, 100, 0.5, score_threshold(sigma), sigma)
    assert_same_picks(got, want.indices.numpy(), want.scores.numpy(), want.valid_len.numpy())


@pytest.mark.cuda
def test_per_class_nms_runs_one_kernel_launch(no_tf32):
    from udal_tpu_torch.config import get_detection_config
    from udal_tpu_torch.ops.postprocess import per_class_nms

    cfg = get_detection_config("efficientdet-d0").override(SMALL)
    rng = np.random.RandomState(9)
    cls = [torch.from_numpy(rng.normal(-1, 1.5, (2, 128 >> l, 128 >> l, 72)).astype(np.float32))
           for l in range(3, 8)]
    box = [torch.from_numpy(rng.normal(0, 0.2, (2, 128 >> l, 128 >> l, 72)).astype(np.float32))
           for l in range(3, 8)]
    want = per_class_nms(cfg, cls, box)
    before = cuda_nms.launches
    got = per_class_nms(cfg, [c.to(no_tf32) for c in cls], [b.to(no_tf32) for b in box])
    assert cuda_nms.launches == before + 1
    assert_same_detection_sets(got, want)
    torch.testing.assert_close(got.classes.cpu(), want.classes)


@pytest.mark.cuda
def test_head_only_serve_on_the_card_matches_the_cpu(no_tf32):
    """Head-only MC: the backbone once (fused_dw on its fast path, 15
    fused_expand_dw without masks), the heads at T·B, one soft-NMS."""
    cpu = small_driver("cpu", HEAD_ONLY)
    card = small_driver(no_tf32, HEAD_ONLY)
    images = np.random.RandomState(10).uniform(-2, 2, (2, 128, 128, 3)).astype(np.float32)
    want = cpu.serve_detections_preprocessed(images)
    before, fast = kernel_counts(), fused_dw.path_launches["fast"]
    got = card.serve_detections_preprocessed(images)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(kernel_counts(), before)) == (1, 15, 1)
    assert fused_dw.path_launches["fast"] == fast + 1
    assert_same_detection_sets(got, want)


@pytest.mark.cuda
def test_native_uint8_warp_entry_on_the_card_matches_the_cpu(no_tf32):
    cpu = small_driver("cpu", {"mc_dropout": False})
    card = small_driver(no_tf32, {"mc_dropout": False})
    frames = np.random.RandomState(11).randint(0, 256, (2, 90, 150, 3)).astype(np.uint8)
    warp = dict(warp_scale=np.asarray([[76 / 90, 128 / 150]] * 2, np.float32),
                warp_offset=np.zeros((2, 2), np.float32))
    want = cpu.serve_detections_preprocessed_uint8(frames, **warp)
    got = card.serve_detections_preprocessed_uint8(frames, **warp)
    assert_same_detection_sets(got, want)
    from udal_tpu_torch.ops.image_ops import warp_resize_batch
    x = torch.from_numpy(frames)
    args = (torch.from_numpy(warp["warp_scale"]), torch.from_numpy(warp["warp_offset"]), (128, 128))
    torch.testing.assert_close(warp_resize_batch(x.to(no_tf32), *args).cpu(),
                               warp_resize_batch(x, *args), atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_ensemble_serve_launches_each_members_kernels(no_tf32):
    from udal_tpu_torch.models.ensemble import stack_variables

    stacked = stack_variables([random_state(3), random_state(5)])
    cpu = small_driver("cpu", {"mc_dropout": False}, state=stacked, ensemble=True)
    card = small_driver(no_tf32, {"mc_dropout": False}, state=stacked, ensemble=True)
    images = np.random.RandomState(12).uniform(-2, 2, (2, 128, 128, 3)).astype(np.float32)
    want = cpu.serve_detections_preprocessed(images)
    before = kernel_counts()
    got = card.serve_detections_preprocessed(images)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(kernel_counts(), before)) == (2, 30, 1)
    assert_same_detection_sets(got, want)


def train_state(device, weights=None, **extra):
    """A train state of the small config (batch 2, no warmup, no dropout
    unless ``extra`` asks) from ``weights``, by default ``random_state(3)``,
    and its schedule."""
    from udal_tpu_torch.config import get_detection_config
    from udal_tpu_torch.train.train_lib import create_train_state

    cfg = get_detection_config("efficientdet-d0").override(
        {**SMALL, "lr_warmup_epoch": 0.0, "batch_size": 2, **extra}, allow_new_keys=True)
    state, schedule = create_train_state(cfg, 10, device=device, state_dict=(
        random_state(3) if weights is None else weights))
    return cfg, state, schedule


def train_batch(seed):
    from udal_tpu_torch.data.synthetic import synthetic_batch

    return synthetic_batch(np.random.RandomState(seed), 2, 128, 128, 8)


def step_grads(device, seed=5, weights=None, **extra):
    """One train step on ``train_batch(seed)``: (its values, its gradients
    on the host by name)."""
    from udal_tpu_torch.train.train_lib import train_step

    cfg, state, schedule = train_state(device, weights, **extra)
    _, vals = train_step(cfg, schedule, 10, state, *train_batch(seed))
    return ({k: float(v) for k, v in vals.items()},
            {n: p.grad.detach().float().cpu() for n, p in state.model.named_parameters()})


def tree_relative_l2(got, want):
    err = sum(float((got[n] - w).square().sum()) for n, w in want.items()) ** 0.5
    return err / sum(float(w.square().sum()) for w in want.values()) ** 0.5


@pytest.mark.cuda
def test_f32_train_step_on_the_card_matches_the_cpu(cuda):
    """f32 at train_matmul_precision "highest": the step turns TF32 off
    for itself (and restores the flag), so the card's step matches the
    CPU's: losses to 1e-4 relative, the gradients' tree to 1e-2 relative
    L2 (tests/test_torch_train_step.py says why not closer)."""
    torch.backends.cudnn.allow_tf32 = True
    want_vals, want = step_grads("cpu")
    got_vals, got = step_grads(cuda)
    assert torch.backends.cudnn.allow_tf32
    for k, v in want_vals.items():
        assert abs(got_vals[k] - v) <= 1e-4 * abs(v) + 1e-7, k
    assert tree_relative_l2(got, want) <= 1e-2


def bf16_churn(device, seeds, **extra):
    """Over the batches of ``seeds``, two distances from the f32 step on
    ``device`` (the same weights and dropout draws): the bf16 step's, and
    that of an f32 step whose weights were only rounded to bf16 (the
    network's own swing under a perturbation of that size). Each as (the
    gradients' mean relative L2, the loss's mean relative difference), and
    each batch's pair. Every bf16 value and gradient is finite."""
    rounded = {k: v.to(torch.bfloat16).float() if v.is_floating_point() else v
               for k, v in random_state(3).items()}
    out = {"bf16": [], "rounded": []}
    for seed in seeds:
        v32, g32 = step_grads(device, seed, **extra)
        v16, g16 = step_grads(device, seed, mixed_precision=True, **extra)
        assert all(np.isfinite(list(v16.values())))
        assert all(bool(torch.isfinite(g).all()) for g in g16.values())
        vr, gr = step_grads(device, seed, rounded, **extra)
        for name, (v, g) in (("bf16", (v16, g16)), ("rounded", (vr, gr))):
            out[name].append((tree_relative_l2(g, g32),
                              abs(v["loss"] - v32["loss"]) / abs(v32["loss"])))
    return ({k: tuple(float(x) for x in np.mean(v, axis=0)) for k, v in out.items()}, out)


@pytest.mark.cuda
def test_bf16_train_step_churns_no_more_than_rounded_weights(no_tf32):
    """Mixed precision as phase 8 trains it (the config's σ floor of 0.01,
    MC dropout 0.05), over eight batches: the bf16 step's distance from
    the f32 step is at most 1.5x (gradients) and 2x (loss) the distance of
    an f32 step whose weights were only rounded to bf16, as
    tests/test_bf16_accuracy.py holds bf16 churn to a reference churn. At
    this floor both are large (the gradients' near 1: the NLL's 1/σ² =
    1e4, BatchNorm over two values at the 1x1 levels) and the loss's varies
    tenfold from batch to batch; tests/test_torch_train_bf16.py holds the
    port's bf16 step to JAX's own churn on the CPU."""
    churn, batches = bf16_churn(no_tf32, range(5, 13), mc_dropout=True, mc_dropoutrate=0.05)
    print(f"bf16-vs-f32 churn (gradients, loss): mean {churn}, each batch {batches}")
    assert churn["bf16"][0] <= 1.5 * churn["rounded"][0], churn
    assert churn["bf16"][1] <= 2.0 * churn["rounded"][1], churn


@pytest.mark.cuda
def test_a_freshly_built_model_serves_through_the_kernels(no_tf32):
    """``EfficientDetModel`` built, loaded and moved to the card with no
    ``.eval()`` is in eval mode (as JAX's ``train=False`` default): a call
    launches 1/15/1, gives finite detections and leaves the running
    statistics as they were."""
    from udal_tpu_torch.config import get_detection_config
    from udal_tpu_torch.models.efficientdet import EfficientDetModel

    model = EfficientDetModel(get_detection_config("efficientdet-d0").override(SMALL))
    model.load_state_dict(random_state(3))
    model = model.to(no_tf32)
    assert not any(m.training for m in model.modules())
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    frames = torch.from_numpy(np.random.RandomState(8).randint(0, 256, (2, 96, 160, 3))
                              .astype(np.uint8)).to(no_tf32)
    before = kernel_counts()
    with torch.no_grad():
        out = model(frames)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(kernel_counts(), before)) == (1, 15, 1)
    assert all(bool(torch.isfinite(t.float()).all()) for t in out)
    for k, v in stats.items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.cuda
def test_trained_model_serves_through_the_kernels(no_tf32):
    """After MC-dropout train steps on the card (no kernel launched), eval
    mode runs the fused kernels (1/15 a forward) and gives a fresh fold's
    output; the serve of the trained weights launches 1/15/1."""
    import copy

    from udal_tpu_torch.apps.serving import ServingDriver
    from udal_tpu_torch.train.train_lib import train_step

    cfg, state, schedule = train_state(no_tf32, mc_dropout=True, mc_dropoutrate=0.05)
    state.model.eval()
    state.model.prepare_inference()
    before = kernel_counts()
    for seed in (5, 6):
        train_step(cfg, schedule, 10, state, *train_batch(seed))
    torch.cuda.synchronize()
    assert kernel_counts() == before
    x = torch.from_numpy(np.random.RandomState(7).uniform(-2, 2, (2, 128, 128, 3))
                         .astype(np.float32)).to(no_tf32)
    state.model.eval()
    with torch.no_grad():
        got = state.model(x)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(kernel_counts(), before)) == (1, 15, 0)
        fresh = copy.deepcopy(state.model)
        fresh.prepare_inference()
        want = fresh(x)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    driver = ServingDriver(cfg, state.model.state_dict(), device=no_tf32)
    before = kernel_counts()
    out = driver.serve_preprocessed(x.cpu().numpy())
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(kernel_counts(), before)) == (1, 15, 1)
    assert all(bool(torch.isfinite(t.float()).all()) for t in out)


@pytest.mark.cuda
@pytest.mark.parametrize("fit", ["mae", "mse", "rmse", "scalar", "per_class"])
def test_temperature_fits_on_the_card_match_the_cpu(cuda, fit):
    """The fits keep t on the device and read it once: the card's T within
    1e-5 relative of the CPU's on the same arrays. The residuals are
    tenths of a unit: with a few units the loop's fixed step of 0.1 on the
    squared error overshoots and oscillates (the JAX loop's arithmetic,
    ROADMAP C10), so a last-bit difference in a sum changes T."""
    from udal_tpu_torch.apps import calibration
    rng = np.random.RandomState(3)
    if fit in ("mae", "mse", "rmse"):
        sigma = rng.uniform(0.05, 0.5, (300, 4))
        res = np.abs(rng.normal(0, 1.0, (300, 4)) * sigma * 1.7)
        fn = lambda d: calibration.fit_temperature_regression(res, sigma, loss=fit, device=d)
    else:
        logits = rng.normal(0, 3, (300, 7))
        onehot = np.eye(7)[rng.randint(0, 7, 300)]
        fn = lambda d: calibration.fit_temperature_classification(
            onehot, logits, fit == "per_class", device=d)
    np.testing.assert_allclose(fn(cuda), fn("cpu"), rtol=1e-5)


@pytest.mark.cuda
def test_gaussian_blur_on_the_card_equals_the_cpu(cuda):
    """Integer sums after cv2's fixed-point kernel: bit for bit."""
    from udal_tpu_torch.ops.image_ops import gaussian_blur_uint8
    images = np.random.RandomState(5).randint(0, 256, (2, 67, 131, 3)).astype(np.uint8)
    assert torch.equal(gaussian_blur_uint8(images, 9, cuda).cpu(),
                       gaussian_blur_uint8(images, 9, "cpu"))


@pytest.mark.cuda
def test_augment_variants_on_the_card_equal_the_cpu(cuda):
    """The Validator's variants (heq, the four weathers, the four ladders)
    made on the card from a uint8 batch equal the same code on the CPU:
    bit for bit, but the rain's f32 Gaussian (the card may fuse its
    multiply-adds: a uint8 value off by at most 1 on at most 0.1% of the
    pixels)."""
    from udal_tpu_torch.data.augment import AugmentVariants

    images = torch.from_numpy(np.random.RandomState(6).randint(0, 256, (3, 67, 131, 3))
                              .astype(np.uint8))
    card, host = AugmentVariants(cuda), AugmentVariants("cpu")
    assert torch.equal(card.heq(images.to(cuda)).cpu(), host.heq(images))
    for weather in ("snow", "fog", "rain", "noise"):
        got = card.weather(images.to(cuda), weather).cpu()
        want = host.weather(images, weather)
        diff = (got.int() - want.int()).abs()
        if weather == "rain":
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
        else:
            assert torch.equal(got, want), weather
    for kind in ("ns", "mb", "ct", "br", "bl"):
        for g, w in zip(card.corruption(images.to(cuda), kind), host.corruption(images, kind)):
            assert torch.equal(g.cpu(), w), kind


@pytest.mark.cuda
def test_collect_pool_on_the_card_launches_each_kernel_per_batch(no_tf32):
    """``collect_pool`` over three batches queued on the card: 1/15/1
    launches of fused_dw / fused_expand_dw / soft-NMS a batch (in a trace
    of the card), and the pool
    the CPU driver gives, as sets of detections."""
    from udal_tpu_torch.apps import al_scoring

    frames = np.random.RandomState(9).randint(0, 256, (6, 96, 160, 3)).astype(np.uint8)
    batches = [(frames[i:i + 2], [f"f{i + j}" for j in range(2)]) for i in range(0, 6, 2)]
    driver = small_driver(no_tf32, {})
    with profiling.KernelLaunches() as launches:
        pool = al_scoring.collect_pool(driver, iter(batches), inflight=8)
    # the third batch replays the model step's CUDA graphs: counted on the card
    assert launches.counts == (3, 45, 3)
    host = al_scoring.collect_pool(small_driver("cpu", {}), iter(batches))
    assert pool.names == host.names
    for i in range(pool.n_images):
        np.testing.assert_allclose(np.sort(pool.feats["det_score"][i][pool.mask[i]]),
                                   np.sort(host.feats["det_score"][i][host.mask[i]]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_world_of_one_over_nccl_trains_and_serves_as_one_process(no_tf32):
    """``chip_smoke.py`` phase 13 (a) at the small config: in a world of
    one over NCCL (a TCP store on 127.0.0.1) the data-parallel step equals
    the single process's (MC dropout, cuDNN deterministic: values to 1e-6
    relative, gradients' tree to 1e-6 relative L2), ``serve_sharded`` of 4
    images in batches of 2 equals two ``serve`` calls (1/15/1 launches a
    batch) and ``serve_sample_parallel`` equals ``serve`` under the same
    masks (1/15/1)."""
    import torch.distributed as dist

    from udal_tpu_torch.models.efficientnet import ChannelDropout
    from udal_tpu_torch.parallel.dryrun import free_port
    from udal_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, replicate_state
    from udal_tpu_torch.train import train_lib

    extra = dict(mc_dropout=True, mc_dropoutrate=0.05, mc_dropoutsamp=2)

    def step(mesh=None):
        cfg, state, schedule = train_state(no_tf32, **extra)
        if mesh is not None:
            replicate_state(mesh, state)
        _, vals = train_lib.train_step(cfg, schedule, 10, state, *train_batch(5))
        return ({k: float(v) for k, v in vals.items()},
                {n: p.grad.detach().float().cpu() for n, p in state.model.named_parameters()})

    def driver():
        d = small_driver(no_tf32, extra, batch_size=2)
        d.masks = ChannelDropout(torch.Generator(device=no_tf32).manual_seed(6))
        return d

    frames = np.random.RandomState(10).randint(0, 256, (4, 96, 160, 3)).astype(np.uint8)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    info = None
    try:
        want_vals, want = step()
        info = initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=no_tf32)
        assert dist.get_backend() == "nccl" and info["process_count"] == 1
        mesh = make_mesh(device=no_tf32)
        got_vals, got = step(mesh)
        for k, v in want_vals.items():
            assert abs(got_vals[k] - v) <= 1e-6 * abs(v) + 1e-9, k
        assert tree_relative_l2(got, want) <= 1e-6

        before = kernel_counts()
        sharded = driver().serve_sharded(mesh, frames)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(kernel_counts(), before)) == (2, 30, 2)
        ref = driver()
        parts = [ref.serve(frames[:2]), ref.serve(frames[2:])]
        for g, w in zip(sharded, (torch.cat(ts) for ts in zip(*parts))):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)

        before = kernel_counts()
        sample = driver().serve_sample_parallel(mesh, frames[:2])
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(kernel_counts(), before)) == (1, 15, 1)
        for g, w in zip(sample, driver().serve(frames[:2])):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if info is not None:
            dist.destroy_process_group()


# -- the model step replayed as CUDA graphs (apps/detect_graph.py) -----------

BENCH_CONFIGS = Path(__file__).resolve().parents[1] / "bench_torch" / "configs"
# the forwards a driver replays: a benchmark configuration and the overrides
# that choose the forward; each with its launches a call
FORWARDS = {
    "kitti_mc_d0": ("kitti_mc_d0", {}, (1, 15, 1)),
    "kitti_head_d0": ("kitti_head_d0", {}, (1, 15, 1)),
    "deterministic": ("kitti_head_d0", dict(mc_dropout=False), (1, 15, 1)),
    "mc_without_the_fold": ("kitti_mc_d0", dict(mc_fast_fold=False), (1, 15, 1)),
    "ensemble": ("kitti_head_d0", dict(mc_dropout=False), (2, 30, 1)),
}


class KeptDraws:
    """The driver's mask source passed through, every draw kept (as the
    benchmark's ``KeptMasks`` keeps them)."""

    def __init__(self, source):
        self.source, self.kept = source, []

    def draw(self, n, c, keep, device):
        bits = self.source.draw(n, c, keep, device)
        self.kept.append(bits)
        return bits


def bench_driver(device, config, seed=1, mc_seed=0, ensemble=False, **overrides):
    """A benchmark configuration (bf16, T = 10, 7 classes) at 256x128 with
    flax-style random weights from ``seed``; with ``ensemble``, two
    members from ``seed`` and ``seed + 1``."""
    import json

    from udal_tpu_torch.apps.serving import ServingDriver
    from udal_tpu_torch.config import get_detection_config
    from udal_tpu_torch.models.ensemble import init_ensemble

    spec = json.loads((BENCH_CONFIGS / f"{config}.json").read_text())
    overrides = dict(spec["overrides"], image_size="256x128", **overrides)
    if not ensemble:
        return ServingDriver.create(spec["model_name"], seed=seed, device=device,
                                    mc_seed=mc_seed, overrides=overrides)
    cfg = get_detection_config(spec["model_name"])
    cfg.override(overrides, allow_new_keys=True)
    return ServingDriver(cfg, init_ensemble(cfg, 2, seed=seed)[1], device=device,
                         mc_seed=mc_seed, ensemble=True)


def forward_driver(device, forward, **kwargs):
    config, overrides, _ = FORWARDS[forward]
    return bench_driver(device, config, ensemble=forward == "ensemble", **overrides, **kwargs)


def eager_packed(driver, images, scales):
    """``_detect`` eagerly: the forward's stages, then the post-processing."""
    from udal_tpu_torch.ops.postprocess import postprocess_global

    with torch.inference_mode():
        x = torch.as_tensor(images, device=driver.device)
        s = torch.as_tensor(scales, device=driver.device)
        outs = driver._forward(x.to(driver.dtype))
        return postprocess_global(driver.config, outs[0], outs[1], image_scales=s).packed()


def graph_inputs(i, b=2):
    rng = np.random.RandomState(40 + i)
    return (rng.uniform(-2, 2, (b, 128, 256, 3)).astype(np.float32),
            np.full((b,), 1.5 + i, np.float32))


def graph_pool_bytes():
    """Bytes of the card's segments in a CUDA graph's private pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("forward", sorted(FORWARDS))
def test_replayed_serves_equal_eager_ones_bit_for_bit(cuda, forward):
    """Four calls: eager, capture, two replays; each packed tuple equals the
    eager forward's under the same masks, bit for bit, the mask sources
    see the same draws, and each call launches the port's kernels as
    many times as the forward has them, counted in a trace of the card
    (the fused separable conv 64 times a member: 24 BiFPN nodes, and 3
    tower layers and a predict conv a level in each head)."""
    graphs, eager = forward_driver(cuda, forward), forward_driver(cuda, forward)
    graphs.masks, eager.masks = KeptDraws(graphs.masks), KeptDraws(eager.masks)
    for i in range(4):
        with profiling.KernelLaunches() as launches:
            got = graphs.serve_preprocessed(*graph_inputs(i))
        assert launches.counts == FORWARDS[forward][2], i
        assert launches.fast == launches.counts[0], i
        assert launches.sepconv == 64 * launches.counts[0], i
        assert launches.sepconv_resident == 0, i
        want = eager_packed(eager, *graph_inputs(i))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), i
    assert graphs.graph_stats == dict(captures=1, replays=2, eager=1)
    assert len(graphs.masks.kept) == len(eager.masks.kept)
    assert (len(eager.masks.kept) > 0) == (forward not in ("deterministic", "ensemble"))
    for g, w in zip(graphs.masks.kept, eager.masks.kept):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_the_five_member_bdd_ensemble_replays_its_eager_serve_bit_for_bit(cuda):
    """The benchmark's ``bdd_ens5_d0`` (five d0 members, 10 BDD classes,
    1024x512, bf16) at batch 8 with flax-style random members: eager,
    capture, two replays; each call launches 5 / 75 / 1 of the port's
    kernels (every fused depthwise on its fast path) and 320 fused
    separable convs, 64 a member, counted in a trace of the card, and each
    packed tuple equals a twin driver's eager forward bit for bit."""
    import json

    from udal_tpu_torch.apps.serving import ServingDriver
    from udal_tpu_torch.config import get_detection_config
    from udal_tpu_torch.models.ensemble import init_ensemble

    spec = json.loads((BENCH_CONFIGS / "bdd_ens5_d0.json").read_text())
    cfg = get_detection_config(spec["model_name"])
    cfg.override(spec["overrides"], allow_new_keys=True)
    n, b = spec["members"], 8
    stacked = init_ensemble(cfg, n, seed=7)[1]
    graphs, eager = (ServingDriver(cfg, stacked, b, device=cuda, ensemble=True)
                     for _ in range(2))
    rng = np.random.RandomState(9)
    for i in range(4):
        images = rng.uniform(-2, 2, (b, 512, 1024, 3)).astype(np.float32)
        scales = np.full((b,), 1.0 + i, np.float32)
        with profiling.KernelLaunches() as launches:
            got = graphs.serve_preprocessed(images, scales)
        assert launches.counts == (n, 15 * n, 1), i
        assert launches.fast == n and launches.sepconv == 64 * n, i
        assert launches.sepconv_resident == 0, i
        want = eager_packed(eager, images, scales)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), i
    assert graphs.graph_stats == dict(captures=1, replays=2, eager=1)


@pytest.mark.cuda
def test_detections_a_caller_holds_outlive_the_next_replay(cuda):
    driver = bench_driver(cuda, "kitti_head_d0")
    held = [driver.serve_detections_preprocessed(*graph_inputs(i)) for i in range(4)]
    copies = [[t.clone() for t in d.packed()] for d in held]
    for i in range(4, 6):
        driver.serve_detections_preprocessed(*graph_inputs(i))
    torch.cuda.synchronize()
    for d, c in zip(held, copies):
        for g, w in zip(d.packed(), c):
            assert torch.equal(g, w)
    assert not torch.equal(held[2].boxes, held[3].boxes)
    assert driver.graph_stats == dict(captures=1, replays=4, eager=1)


@pytest.mark.cuda
def test_weights_loaded_after_the_capture_reach_the_replay(cuda):
    """``load_state_dict`` + ``prepare_inference`` write into the tensors the
    graphs read: the next call is a replay with a fresh driver's bits."""
    from udal_tpu_torch.models.efficientnet import ChannelDropout

    driver = bench_driver(cuda, "kitti_mc_d0")
    for i in range(3):
        driver.serve_preprocessed(*graph_inputs(i))
    other = bench_driver(cuda, "kitti_mc_d0", seed=2)
    driver.model.load_state_dict(other.model.state_dict())
    driver.model.prepare_inference()
    for d in (driver, other):
        d.masks = ChannelDropout(torch.Generator(device=cuda).manual_seed(9))
    got = driver.serve_preprocessed(*graph_inputs(7))
    assert driver.graph_stats == dict(captures=1, replays=2, eager=1)
    for g, w in zip(got, eager_packed(other, *graph_inputs(7))):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_a_dropped_driver_gives_its_graphs_memory_back(cuda):
    """No cycle holds a driver: ``del`` frees its graphs and their pool
    with the cycle collector off, and ``empty_cache`` returns the pool's
    segments to the card (a first driver warms the process's caches)."""
    import gc

    def used():
        driver = bench_driver(cuda, "kitti_mc_d0")
        for i in range(3):
            driver.serve_preprocessed(*graph_inputs(i))
        torch.cuda.synchronize()
        assert driver.graph_stats["captures"] == 1
        return driver

    used()
    gc.collect()
    torch.cuda.empty_cache()
    before, pools_before = torch.cuda.memory_reserved(), graph_pool_bytes()
    driver = used()
    held, pools_held = torch.cuda.memory_reserved(), graph_pool_bytes()
    gc.disable()
    try:
        del driver
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        after, pools_after = torch.cuda.memory_reserved(), graph_pool_bytes()
    finally:
        gc.enable()
    print(f"reserved {before} -> {held} (graph pool {pools_held}) -> {after} bytes")
    assert pools_held > pools_before and held - before >= pools_held - pools_before
    assert pools_after == pools_before
    assert after - before <= 2 * 2**20


@pytest.mark.cuda
def test_a_traced_replay_shows_its_kernels_and_spans(cuda):
    """Under torch.profiler a replayed call's device kernels are traced
    (the three of the port's among them, as many as the eager call's
    within 2%) and its root span says ``replay``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    driver = bench_driver(cuda, "kitti_head_d0")
    kernels = []
    for i in range(4):
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            driver.serve_preprocessed(*graph_inputs(i))
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        kernels.append(names)
        roots = [s for s in profiling.spans() if s.parent is None]
        assert [r.attrs["graph"] for r in roots] == [["eager", "capture", "replay", "replay"][i]]
    print("device operations a call (eager, capture, replay, replay):",
          [len(k) for k in kernels])
    for part in ("expand_dw_tc_kernel", "fused_dw", "soft_nms"):
        assert any(part in n for n in kernels[3]), part
    assert abs(len(kernels[3]) - len(kernels[0])) <= 0.02 * len(kernels[0])


def b7_blocks(stem_hw=(384, 768)):
    """(block args, input channels, input rows, input columns) of each of
    EfficientNet-B7's 55 blocks at d7x's 1536x768 canvas (the stem at
    stride 2)."""
    from udal_tpu_torch.models.efficientnet import backbone_spec, block_input_sizes

    spec = backbone_spec("efficientnet-b7")
    out, cin = [], spec.stem_filters
    for a, h, w in block_input_sizes(spec, *stem_hw):
        out.append((a, cin, h, w))
        cin = a.output_filters
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("block", [0, 1])
def test_fused_dw_at_b7s_expand_ratio_one_blocks(cuda, block):
    """B7's four e=1 blocks (64→32, then 32→32 with the identity skip)
    at d7x's 384x768 stem output, batch 8, bf16: the fast path, within the
    bf16 check of ``test_fused_dw_kernel_matches_plain_bf16``."""
    a, cin, h, w = b7_blocks()[block]
    assert a.expand_ratio == 1 and (cin, h, w) == ((64, 384, 768) if block == 0
                                                   else (32, 384, 768))
    x, taps, scale, bias, mask = dw_operands(block, 8, cin, h, w, 3, cuda, torch.bfloat16)
    want_y, want_m = fused_dw.fused_depthwise_plain(x, taps, scale, bias, mask, 1, "swish", True)
    fast = fused_dw.path_launches["fast"]
    got_y, got_m = fused_dw.fused_depthwise(x, taps, scale, bias, mask, 1, "swish", True)
    torch.cuda.synchronize()
    assert fused_dw.path_launches["fast"] == fast + 1
    assert_bf16_close(got_y, want_y, 1, 0.01)
    torch.testing.assert_close(got_m, want_m, atol=1e-5, rtol=1e-5)


# the distinct (Cin, Ce, k, s, H, W) of B7's 51 expanding blocks at d7x's canvas
B7_EXPAND = sorted({(cin, a.input_filters * a.expand_ratio, a.kernel_size, a.strides[0], h, w)
                    for a, cin, h, w in b7_blocks() if a.expand_ratio != 1})


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("cin,ce,k,s,h,w", B7_EXPAND)
def test_fused_expand_dw_tc_matches_plain_at_b7_blocks(cuda, cin, ce, k, s, h, w, masked):
    """The bf16 kernel at every expanding block shape of B7 at its d7x
    size (K up to 640, Ce up to 3840), batch 2, with and without masks, in
    the layout the planner takes (streamed: the 16-byte copies), with
    the tolerance of ``test_fused_expand_dw_tc_matches_plain_at_d0_blocks``."""
    x, we, b0, m1, wd, b1, m2 = expand_operands(cin, 2, cin, ce, h, w, k, cuda, torch.bfloat16)
    if not masked:
        m1 = m2 = None
    want = fused_mbconv.fused_expand_dw_plain(x, we, b0, m1, wd, b1, m2, s, k)
    before = fused_mbconv.launches
    got = fused_mbconv.fused_expand_dw_cuda(x, we, b0, m1, wd, b1, m2, s, k, "swish",
                                            fused_mbconv.split_weights(we))
    torch.cuda.synchronize()
    assert fused_mbconv.launches == before + 1
    assert_bf16_close(got[0], want[0], 2, 1)
    torch.testing.assert_close(got[1], want[1], rtol=1e-3,
                               atol=1e-3 * want[1].abs().max().item())


@pytest.mark.cuda
def test_d7x_serve_launches_4_51_1_from_a_trace(cuda):
    """EfficientDet-d7x at 1536x768 (the benchmark's bdd_head_d7x overrides,
    head-only MC, T = 10), batch 2: a replayed serve launches B2 four
    times (its fast path), B3 51 times, soft-NMS once and the fused
    separable conv 152 times (80 BiFPN nodes, and 5 tower layers and a
    predict conv a level in each head), every one on its resident kernel
    (Cin = 384), read from a trace of the card."""
    import json

    from udal_tpu_torch.apps.serving import ServingDriver

    spec = json.loads((BENCH_CONFIGS / "bdd_head_d7x.json").read_text())
    driver = ServingDriver.create(spec["model_name"], seed=1, device=cuda,
                                  overrides=spec["overrides"])
    g = torch.Generator().manual_seed(0)
    images = torch.randn((2, 768, 1536, 3), generator=g).to(cuda)
    scales = torch.ones(2, device=cuda)
    for _ in range(3):
        driver.serve_preprocessed(images, scales)
    with profiling.KernelLaunches() as launches:
        driver.serve_preprocessed(images, scales)
    assert driver.graph_stats == dict(captures=1, replays=2, eager=1)
    assert launches.counts == (4, 51, 1) and launches.fast == 4
    assert launches.sepconv == 152 and launches.sepconv_resident == 152


def two_bytes_off(t):
    """A copy of ``t`` 2 bytes off an aligned address, which the 16-byte
    copies cannot take."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = base[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("cin,ce,k,s,h,w", [(224, 1344, 5, 1, 48, 96), (640, 3840, 3, 1, 24, 48)])
def test_streamed_layout_equals_the_resident_one_bit_for_bit(cuda, cin, ce, k, s, h, w):
    """Both layouts accumulate the same K-chunks, hi then lo, in the same
    order. The resident one runs where the loads are plain (here: the
    split weights 2 bytes off an aligned address). At its tile the
    streamed layout gives the same y and SE sums bit for bit; at the
    planner's streamed tile the same y, and SE sums regrouped by tile,
    equal to f32 rounding. A plan of the other layout is refused."""
    x, we, b0, m1, wd, b1, m2 = expand_operands(7, 2, cin, ce, h, w, k, cuda, torch.bfloat16)
    split = fused_mbconv.split_weights(we)
    plain_loads = tuple(two_bytes_off(t) for t in split)
    args = (x, we, b0, m1, wd, b1, m2, s, k, "swish")
    ho, wo = -(-h // s), -(-w // s)
    resident = fused_mbconv.tc_tile_shape(ho, wo, cin, s, k, vec=False)
    planned = fused_mbconv.tc_tile_shape(ho, wo, cin, s, k)
    assert not resident.streamed and planned.streamed and resident[:2] != planned[:2]
    want = fused_mbconv.fused_expand_dw_cuda(*args, plain_loads)
    same_tile = fused_mbconv._launch(*args, split, resident._replace(streamed=True))
    got = fused_mbconv.fused_expand_dw_cuda(*args, split)
    assert torch.equal(same_tile[0], want[0]) and torch.equal(same_tile[1], want[1])
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5,
                               atol=1e-6 * want[1].abs().max().item())
    with pytest.raises(ValueError, match="16-byte copies"):
        fused_mbconv._launch(*args, plain_loads, planned)
    with pytest.raises(ValueError, match="16-byte copies"):
        fused_mbconv._launch(*args, split, resident)
