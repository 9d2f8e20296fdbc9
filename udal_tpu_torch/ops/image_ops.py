"""Image operations on the device: the bilinear warp of native-size frames
(port of ``udal_tpu/ops/image_ops.py``), cv2's Gaussian blur of uint8
frames and cv2's bilinear resize of uint8 frames.

``warp_resize_batch`` resizes each image by its own per-axis scale and
crops it at its own offset, onto a fixed output canvas: the device half of
the ``device_resize`` reader contract, whose host ships native-size uint8
frames and the warp parameters. As in ``jax.image.scale_and_translate``
(method "linear", no antialiasing), each axis is one contraction with an
[out, in] matrix of triangle-filter weights; here the B per-image matrices
of an axis are one batched matmul.

``gaussian_blur_uint8`` is ``cv2.GaussianBlur(image, (k, k), 0)`` on uint8
frames, which the apps' consistency check asks for and the machine with
the card cannot import: cv2's bit-exact 8-bit path, σ = 0.3·((k−1)/2 − 1)
+ 0.8, the kernel in fixed point with 8 fraction bits (its rounding error
carried from tap to tap, the centre tap taking what is left of 256),
BORDER_REFLECT_101, a horizontal then a vertical pass in integers and one
rounding at the end.

``resize_bilinear_uint8`` is ``cv2.resize(image, (w, h),
interpolation=cv2.INTER_LINEAR)`` on uint8, the input reader's resize,
bit for bit: cv2's 8-bit path, source positions (d + 0.5)·(in/out) − 0.5
in f32, weights in fixed point with 11 fraction bits (each rounded on its
own), a horizontal pass in int32 (columns clamped, the weight at a clamped
edge 1), then cv2's vectorised vertical pass: each row sum shifted right
by 4, multiplied by its 11-bit weight keeping the high 16 bits, the two
added and rounded off by 2 more bits (rows clamped at the edges). numpy in,
numpy out on the host; a tensor in, a tensor out on its device.
"""

from __future__ import annotations

import math
from typing import List, Tuple, Union

import numpy as np
import torch


def weight_matrix(in_size: int, out_size: int, scale: torch.Tensor,
                  offset: torch.Tensor) -> torch.Tensor:
    """[B, out, in] bilinear weights for per-image ``scale`` and crop
    ``offset`` [B] (f32): output pixel i samples the source at
    s = (i + 0.5 + offset) / scale - 0.5 with the triangle filter. Each
    row is divided by its sum (0 where the sum is below 1000 f32 ulps) and
    zeroed where s lies outside [-0.5, in - 0.5], as
    ``jax.image.scale_and_translate`` computes its weights."""
    dev = scale.device
    inv = 1.0 / scale[:, None]
    # jax writes the sample with the translation -offset: (i + 0.5)/s - t/s - 0.5
    sample = (torch.arange(out_size, dtype=torch.float32, device=dev)[None] + 0.5) * inv \
        + offset[:, None] * inv - 0.5                                      # [B, out]
    src = torch.arange(in_size, dtype=torch.float32, device=dev)
    weights = torch.clamp_min(1.0 - torch.abs(sample[:, :, None] - src[None, None]), 0.0)
    total = weights.sum(dim=2, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, 0.0)


def warp_resize_batch(images: torch.Tensor, warp_scale: torch.Tensor,
                      warp_offset: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] uint8 or float images → [B, out_h, out_w, C] float32,
    image b resized by ``warp_scale[b]`` (y, x) and cropped at
    ``warp_offset[b]`` (y, x); regions past the scaled image are zero."""
    x = images.to(torch.float32)
    scale = torch.as_tensor(warp_scale, dtype=torch.float32, device=x.device)
    offset = torch.as_tensor(warp_offset, dtype=torch.float32, device=x.device)
    b, h, w, c = x.shape
    wy = weight_matrix(h, out_hw[0], scale[:, 0], offset[:, 0])        # [B, oh, H]
    wx = weight_matrix(w, out_hw[1], scale[:, 1], offset[:, 1])        # [B, ow, W]
    oh, ow = out_hw
    rows = torch.bmm(wy, x.reshape(b, h, w * c)).reshape(b, oh, w, c)
    rows = rows.transpose(2, 3).reshape(b, oh * c, w)                  # [B, oh·C, W]
    out = torch.bmm(rows, wx.transpose(1, 2)).reshape(b, oh, c, ow)
    return out.transpose(2, 3).contiguous()


def warp_resize_single(image: torch.Tensor, scale_yx, offset_yx,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """One [H, W, C] image resized by ``scale_yx`` and cropped at
    ``offset_yx`` → [out_h, out_w, C] float32."""
    scale = torch.as_tensor(scale_yx, dtype=torch.float32, device=image.device)
    offset = torch.as_tensor(offset_yx, dtype=torch.float32, device=image.device)
    return warp_resize_batch(image[None], scale[None], offset[None], out_hw)[0]


# cv2's tables for ksize 1-7 with σ from ksize (getGaussianKernel's small_gaussian_tab)
SMALL_GAUSSIAN_TABS = {1: [1.0], 3: [0.25, 0.5, 0.25],
                       5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                       7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}


def gaussian_kernel_fixed_point(ksize: int) -> List[int]:
    """cv2's fixed-point Gaussian kernel (8 fraction bits, sum 256) for an
    odd ``ksize`` and σ from ``ksize``: cv2's tables below 9, else the
    sampled Gaussian with its rounding error diffused."""
    if ksize % 2 == 0 or ksize < 1:
        raise ValueError(f"ksize must be odd and positive, got {ksize}")
    if ksize in SMALL_GAUSSIAN_TABS:
        return [int(v * 256) for v in SMALL_GAUSSIAN_TABS[ksize]]
    sigma = ksize * 0.15 + 0.35           # 0.3·((k−1)/2 − 1) + 0.8
    scale2 = -0.125 / (sigma * sigma)     # the taps sit at x = 2·offset
    half = (ksize - 1) // 2
    values = [math.exp(float(x * x) * scale2) for x in range(1 - ksize, 0, 2)]
    norm = 1.0 / (2 * sum(values) + 1.0)
    taps = [0] * ksize
    err = 0.0
    for i in range(half):                 # error diffusion from the edge in
        adj = values[i] * norm * 256.0 + err
        v = round(adj)                    # half to even, as cvRound
        err = adj - v
        taps[i] = taps[ksize - 1 - i] = v
    taps[half] = 256 - 2 * sum(taps[:half])
    return taps


def reflect101_index(n: int, before: int, after: int) -> np.ndarray:
    """Source indices of ``before + n + after`` positions along an axis of
    ``n`` under BORDER_REFLECT_101 (reflected as often as the pad needs,
    as cv2's borderInterpolate does; every index 0 when ``n`` is 1)."""
    i = np.arange(-before, n + after)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def gaussian_blur_uint8(images, ksize: int = 9, device=None) -> torch.Tensor:
    """``cv2.GaussianBlur(im, (ksize, ksize), 0)`` of each uint8 frame of
    ``images`` [B, H, W, C] (any odd ``ksize``), on ``device`` (the
    images' own unless given): uint8 [B, H, W, C]. Integer sums, so the
    result is cv2's bit for bit."""
    x = torch.as_tensor(images, device=device)
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"gaussian_blur_uint8 takes uint8 [B, H, W, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    taps = gaussian_kernel_fixed_point(ksize)
    pad = ksize // 2
    h, w = x.shape[1], x.shape[2]
    rows, cols = (torch.from_numpy(reflect101_index(n, pad, pad)).to(x.device) for n in (h, w))
    x = x.to(torch.int32)[:, rows][:, :, cols]
    rows = sum(t * x[:, :, i:i + w] for i, t in enumerate(taps))          # < 2^16
    out = sum(t * rows[:, i:i + h] for i, t in enumerate(taps))           # < 2^24
    return ((out + (1 << 15)) >> 16).to(torch.uint8)


def _linear_taps(src: int, dst: int, clamp_weights: bool
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(first index, second index, first weight, second weight) of each of
    ``dst`` outputs over ``src`` inputs, weights in 11-bit fixed point,
    computed as cv2 computes them. ``clamp_weights`` (the horizontal
    axis): a position past an edge takes that edge's pixel with weight 1;
    otherwise (the vertical axis) only the rows are clamped."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5
         ).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = (f - i.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        low, high = i < 0, i >= src - 1
        f = np.where(low | high, np.float32(0), f)
        i = np.where(low, 0, np.where(high, src - 1, i))
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), w0, w1


ImageLike = Union[np.ndarray, torch.Tensor]


def resize_bilinear_uint8(image: ImageLike, size_hw: Tuple[int, int]) -> ImageLike:
    """``cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    uint8 image [H, W] or [H, W, C], for ``size_hw`` = (h, w): numpy on the
    host for a numpy array, torch on the tensor's device for a tensor."""
    if image.dtype not in (np.uint8, torch.uint8):
        raise ValueError(f"resize_bilinear_uint8 takes uint8, got {image.dtype}")
    h, w = int(size_hw[0]), int(size_hw[1])
    x0, x1, a0, a1 = _linear_taps(image.shape[1], w, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(image.shape[0], h, clamp_weights=False)
    cols = (None, slice(None)) + (None,) * (image.ndim - 2)     # broadcast along W
    rows = (slice(None),) + (None,) * (image.ndim - 1)          # broadcast along H
    if isinstance(image, torch.Tensor):
        x0, x1, a0, a1, y0, y1, b0, b1 = (torch.from_numpy(v).to(image.device)
                                          for v in (x0, x1, a0, a1, y0, y1, b0, b1))
        px = image.to(torch.int32)
        s = (px[:, x0] * a0[cols] + px[:, x1] * a1[cols]) >> 4
        v = (((s[y0] * b0[rows]) >> 16) + ((s[y1] * b1[rows]) >> 16) + 2) >> 2
        return v.clamp(0, 255).to(torch.uint8)
    s = np.take(image, x0, axis=1).astype(np.int32)             # in place: the reader's hot loop
    s *= a0[cols]
    s1 = np.take(image, x1, axis=1).astype(np.int32)
    s1 *= a1[cols]
    s += s1
    s >>= 4
    v = np.take(s, y0, axis=0)
    v *= b0[rows]
    v >>= 16
    v1 = np.take(s, y1, axis=0)
    v1 *= b1[rows]
    v1 >>= 16
    v += v1
    v += 2
    v >>= 2
    return np.clip(v, 0, 255).astype(np.uint8)


def resize_bilinear_float(image: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    float32 image [H, W, C] on the host: the same sample positions and
    edge clamping as the uint8 path, the weights and both passes' sums in
    f32 as cv2 computes them (the two agree to a few f32 ulps: cv2's
    vectorised sums may fuse their multiply-adds)."""
    h, w = int(size_hw[0]), int(size_hw[1])
    x = np.asarray(image, np.float32)

    def taps(src, dst, clamp_weights):
        f = (np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5
        i = np.floor(f).astype(np.int64)
        f = (f - i).astype(np.float32)
        if clamp_weights:
            low, high = i < 0, i >= src - 1
            f = np.where(low | high, np.float32(0), f)
            i = np.where(low, 0, np.where(high, src - 1, i))
        return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), np.float32(1) - f, f

    x0, x1, a0, a1 = taps(x.shape[1], w, True)
    y0, y1, b0, b1 = taps(x.shape[0], h, False)
    cols = (None, slice(None)) + (None,) * (x.ndim - 2)
    rows = (slice(None),) + (None,) * (x.ndim - 1)
    s = np.take(x, x0, axis=1) * a0[cols] + np.take(x, x1, axis=1) * a1[cols]
    return np.take(s, y0, axis=0) * b0[rows] + np.take(s, y1, axis=0) * b1[rows]
