"""The port's cv2 replacements (``udal_tpu_torch/ops/cv_ops.py``) against
cv2 itself, each at its stated target: bit for bit, or within the bound
its docstring states (asserted here, the worst case printed).

The colour conversions are pure functions of a pixel, so they are held
over every 13th of the 2^24 colours (each byte value in each channel),
laid out as rows of widths that put pixels on both sides of cv2's
vector/scalar split; a full sweep of all 2^24 matched as well when the
functions were written."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from hypothesis import given, settings, strategies as st  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.ops import cv_ops  # noqa: E402
from udal_tpu_torch.ops.image_ops import (gaussian_blur_uint8,  # noqa: E402
                                          resize_bilinear_float, resize_bilinear_uint8)


@pytest.fixture(scope="module")
def all_colours():
    c = np.arange(0, 1 << 24, 13, dtype=np.uint32)       # every residue of each byte
    return np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8)


def _rows(colours, width):
    n = len(colours) // width * width
    return np.ascontiguousarray(colours[:n].reshape(-1, width, 3))


def _images(rng, count, lo=1, hi=70, channels=3):
    for _ in range(count):
        h, w = rng.randint(lo, hi, 2)
        yield rng.randint(0, 256, (h, w, channels)).astype(np.uint8)


@pytest.mark.parametrize("code,fn", [
    ("COLOR_RGB2GRAY", cv_ops.rgb_to_gray), ("COLOR_RGB2YUV", cv_ops.rgb_to_yuv),
    ("COLOR_YUV2RGB", cv_ops.yuv_to_rgb), ("COLOR_RGB2HSV", cv_ops.rgb_to_hsv),
    ("COLOR_HSV2RGB", cv_ops.hsv_to_rgb), ("COLOR_RGB2HLS", cv_ops.rgb_to_hls),
    ("COLOR_HLS2RGB", cv_ops.hls_to_rgb), ("COLOR_RGB2LAB", cv_ops.rgb_to_lab),
    ("COLOR_LAB2RGB", cv_ops.lab_to_rgb)])
def test_colour_conversions_bit_exact_over_all_colours(all_colours, code, fn):
    """The colours, in rows of 4030 (vector blocks and a 30-pixel tail)
    and of 71 pixels."""
    for width in (4030, 71):
        img = _rows(all_colours, width)
        np.testing.assert_array_equal(fn(img), cv2.cvtColor(img, getattr(cv2, code)),
                                      err_msg=f"{code} at width {width}")


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 4), w=st.integers(1, 600), seed=st.integers(0, 2 ** 31 - 1))
def test_hsv_hls_paths_follow_the_column_at_any_width(h, w, seed):
    """The vector/scalar split of HSV → RGB and RGB → HLS holds at any
    width (1-pixel rows and rows past one 256-pixel block included)."""
    img = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)
    for code, fn in (("COLOR_HSV2RGB", cv_ops.hsv_to_rgb), ("COLOR_RGB2HLS", cv_ops.rgb_to_hls),
                     ("COLOR_HLS2RGB", cv_ops.hls_to_rgb)):
        np.testing.assert_array_equal(fn(img), cv2.cvtColor(img, getattr(cv2, code)))


def test_equalize_hist_numpy_and_torch_batch():
    rng = np.random.RandomState(0)
    planes = []
    for t in range(400):
        h, w = rng.randint(1, 60, 2)
        kind = t % 4
        if kind == 0:
            g = rng.randint(0, 256, (h, w))
        elif kind == 1:
            g = rng.randint(rng.randint(0, 200), 256, (h, w))
        elif kind == 2:
            g = rng.randint(0, 4, (h, w)) * rng.randint(1, 60)
        else:
            g = np.full((h, w), rng.randint(256))
            g[0, 0] = rng.randint(256)
        g = g.astype(np.uint8)
        np.testing.assert_array_equal(cv_ops.equalize_hist(g), cv2.equalizeHist(g))
        planes.append(g)
    batch = np.stack([rng.randint(0, 256, (33, 47)) for _ in range(5)]).astype(np.uint8)
    batch[2] = 7                                                    # one occupied level
    got = cv_ops.equalize_hist(torch.from_numpy(batch))
    np.testing.assert_array_equal(got.numpy(), np.stack([cv2.equalizeHist(p) for p in batch]))


@pytest.mark.parametrize("clip", [0.05, 1.0, 3.0, 40.0])
def test_clahe_bit_exact(clip):
    rng = np.random.RandomState(int(clip * 100))
    for t in range(40):
        h, w = rng.randint(8, 130, 2)
        grid = rng.randint(1, min(h, w) // 2 + 1)
        src = rng.randint(0, 256, (h, w)) if t % 2 else np.clip(rng.randn(h, w) * 30 + 100, 0, 255)
        src = src.astype(np.uint8)
        want = cv2.createCLAHE(clipLimit=clip, tileGridSize=(grid, grid)).apply(src)
        np.testing.assert_array_equal(cv_ops.clahe(src, clip, grid), want, err_msg=f"{h}x{w} g{grid}")


def test_calc_hist_3d_counts():
    rng = np.random.RandomState(1)
    for img in _images(rng, 30):
        want = cv2.calcHist([img], [0, 1, 2], None, [8, 8, 8], [0, 256] * 3).flatten()
        np.testing.assert_array_equal(cv_ops.calc_hist_3d(img), want)


def test_rotation_matrix_and_nearest_warp_bit_exact():
    rng = np.random.RandomState(2)
    for t in range(300):
        h, w = rng.randint(1, 120, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        kind = t % 3
        if kind == 0:
            m = np.array([[1, 0, rng.uniform(-250, 250)], [0, 1, 0]], np.float32)
        elif kind == 1:
            lv = rng.uniform(-0.3, 0.3)
            m = np.array([[1, lv, 0], [0, 1, 0]] if t % 2 else [[1, 0, 0], [lv, 1, 0]], np.float32)
        else:
            deg = rng.uniform(-30, 30) if t % 5 else float(rng.choice([0, 30, -30]))
            rot = cv_ops.rotation_matrix_2d((w / 2.0, h / 2.0), deg, 1.0)
            np.testing.assert_array_equal(rot, cv2.getRotationMatrix2D((w / 2.0, h / 2.0), deg, 1.0))
            m = rot.astype(np.float32)
        want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_NEAREST,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=(128, 128, 128))
        np.testing.assert_array_equal(cv_ops.warp_affine_nearest(img, m, 128), want)


def test_box_blur_and_dilate_bit_exact():
    rng = np.random.RandomState(3)
    for img in _images(rng, 150, lo=1, hi=80):
        k = rng.randint(1, 11)
        np.testing.assert_array_equal(cv_ops.box_blur(img, k), cv2.blur(img, (k, k)))
    for _ in range(60):
        h, w = rng.randint(1, 60, 2)
        x = (rng.rand(h, w) < 0.1).astype(np.float32)
        np.testing.assert_array_equal(cv_ops.dilate_2x2(x), cv2.dilate(x, np.ones((2, 2))))


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11, 13])
def test_gaussian_blur_uint8_every_odd_size(k):
    """The 8-bit Gaussian at cv2's table sizes (1-7) and sampled ones,
    1-pixel sides included."""
    rng = np.random.RandomState(k)
    for img in _images(rng, 25, lo=1, hi=50):
        got = gaussian_blur_uint8(img[None], k)[0].numpy()
        np.testing.assert_array_equal(got, cv2.GaussianBlur(img, (k, k), 0))


def test_gaussian_blur3_f32_within_1e4():
    rng = np.random.RandomState(4)
    worst = 0.0
    for _ in range(40):
        h, w = rng.randint(1, 80, 2)
        x = (rng.rand(h, w, 3) * 400).astype(np.float32)
        worst = max(worst, float(np.abs(cv_ops.gaussian_blur3_f32(x) - cv2.GaussianBlur(x, (3, 3), 0)).max()))
        plane = x[..., 0].copy()
        worst = max(worst, float(np.abs(cv_ops.gaussian_blur3_f32(plane)
                                        - cv2.GaussianBlur(plane, (3, 3), 0)).max()))
    print(f"gaussian_blur3_f32: worst |err| {worst}")
    assert worst <= 1e-4


def test_filter2d_sharpness_and_motion():
    """The 3x3 /13 sharpness kernel and the 3- and 7-tap motion kernels
    bit for bit; the 12-tap motion kernel (144 taps: cv2's DFT) off by at
    most 1, only where the exact window sum is a tie (a multiple of 12
    plus 6), on at most 6% of the values in all."""
    rng = np.random.RandomState(5)
    sharp = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    for img in _images(rng, 100, lo=1, hi=60):
        np.testing.assert_array_equal(cv_ops.filter2d(img, sharp), cv2.filter2D(img, -1, sharp))
    worst, differ, total = 0, 0, 0
    for k in (3, 7, 12):
        kernel = cv_ops.motion_kernel(k)
        for img in _images(rng, 30, lo=2, hi=90):
            want = cv2.filter2D(img, -1, kernel)
            got = cv_ops.filter2d(img, kernel)
            if k < 12:
                np.testing.assert_array_equal(got, want)
                continue
            diff = np.abs(got.astype(int) - want)
            worst = max(worst, int(diff.max()))
            differ, total = differ + int((diff != 0).sum()), total + diff.size
            pad = cv_ops.reflect101_index
            p = img.astype(int)[:, pad(img.shape[1], 6, 5)]
            sums = sum(p[:, j:j + img.shape[1]] for j in range(12))
            assert (sums[diff != 0] % 12 == 6).all()
    print(f"filter2d 12-tap motion: max {worst}, share off {differ / total:.4f}")
    assert worst <= 1 and differ / total <= 0.06
    batch = np.stack(list(_images(np.random.RandomState(6), 1, lo=20, hi=21)) * 3)
    np.testing.assert_array_equal(cv_ops.filter2d(torch.from_numpy(batch), sharp).numpy(),
                                  np.stack([cv2.filter2D(im, -1, sharp) for im in batch]))


def test_yuv_and_equalize_on_tensors_equal_numpy():
    img = np.random.RandomState(7).randint(0, 256, (2, 9, 13, 3)).astype(np.uint8)
    t = torch.from_numpy(img)
    np.testing.assert_array_equal(cv_ops.rgb_to_yuv(t).numpy(), cv_ops.rgb_to_yuv(img))
    np.testing.assert_array_equal(cv_ops.yuv_to_rgb(t).numpy(), cv_ops.yuv_to_rgb(img))


def test_line_thickness_1_bit_exact_with_clipping():
    rng = np.random.RandomState(8)
    for _ in range(1500):
        h, w = rng.randint(1, 60, 2)
        x1, y1 = int(rng.randint(0, w)), int(rng.randint(0, h))
        x2, y2 = x1 + int(rng.randint(-40, 40)), y1 + int(rng.randint(-40, 70))
        want = np.zeros((h, w), np.uint8)
        cv2.line(want, (x1, y1), (x2, y2), 200, 1)
        got = np.zeros((h, w), np.uint8)
        cv_ops.draw_line(got, (x1, y1), (x2, y2), 200, 1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thickness", [2, 3, 4, 5])
def test_thick_lines_within_their_bound(thickness):
    """Thick lines: the capsule and cv2's polygon and discs differ on at
    most 15% of the pixels either draws (the outline pixels fall either
    way; measured over rain-like streaks)."""
    rng = np.random.RandomState(thickness)
    drawn = differ = 0
    for _ in range(300):
        h, w = 80, 90
        x1, y1 = int(rng.randint(0, w)), int(rng.randint(0, h))
        x2, y2 = x1 + int(rng.randint(-20, 20)), y1 + int(rng.randint(1, 100))
        want = np.zeros((h, w), np.uint8)
        cv2.line(want, (x1, y1), (x2, y2), 200, thickness)
        got = np.zeros((h, w), np.uint8)
        cv_ops.draw_line(got, (x1, y1), (x2, y2), 200, thickness)
        drawn += int(((got > 0) | (want > 0)).sum())
        differ += int((got != want).sum())
    print(f"thickness {thickness}: {differ / drawn:.3f} of the drawn pixels differ")
    assert differ / drawn <= 0.15


def test_resize_area_and_linear():
    """INTER_AREA in f32 within 1e-5 relative (down, integer and not, and
    up); INTER_LINEAR uint8 bit for bit and f32 within 1e-6."""
    rng = np.random.RandomState(9)
    worst = 0.0
    for h, w in [(375, 1242), (64, 64), (128, 96), (33, 45), (20, 50), (10, 12)]:
        x = (rng.rand(h, w) * 255).astype(np.float32)
        want = cv2.resize(x, (32, 32), interpolation=cv2.INTER_AREA)
        got = cv_ops.resize_area(x, (32, 32))
        worst = max(worst, float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-3))))
    print(f"resize_area: worst relative error {worst}")
    assert worst <= 1e-5
    img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    np.testing.assert_array_equal(resize_bilinear_uint8(img, (20, 31)), cv2.resize(img, (31, 20)))
    g = img[..., 0].astype(np.float32)
    assert np.abs(resize_bilinear_float(g[..., None], (32, 32))[..., 0]
                  - cv2.resize(g, (32, 32))).max() <= 1e-6 * 255
