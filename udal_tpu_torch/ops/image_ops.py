"""Image operations on the device: the bilinear warp of native-size frames
(port of ``udal_tpu/ops/image_ops.py``) and cv2's Gaussian blur of uint8
frames.

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
"""

from __future__ import annotations

import math
from typing import List, Tuple

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


def gaussian_kernel_fixed_point(ksize: int) -> List[int]:
    """cv2's fixed-point Gaussian kernel (8 fraction bits, sum 256) for an
    odd ``ksize`` >= 9 and σ from ``ksize`` (below 9, cv2 takes tables)."""
    if ksize < 9 or ksize % 2 == 0:
        raise ValueError(f"ksize must be odd and at least 9, got {ksize}")
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


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def gaussian_blur_uint8(images, ksize: int = 9, device=None) -> torch.Tensor:
    """``cv2.GaussianBlur(im, (ksize, ksize), 0)`` of each uint8 frame of
    ``images`` [B, H, W, C] (H, W > ksize // 2), on ``device`` (the
    images' own unless given): uint8 [B, H, W, C]. Integer sums, so the
    result is cv2's bit for bit."""
    x = torch.as_tensor(images, device=device)
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"gaussian_blur_uint8 takes uint8 [B, H, W, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    taps = gaussian_kernel_fixed_point(ksize)
    pad = ksize // 2
    h, w = x.shape[1], x.shape[2]
    if min(h, w) <= pad:
        raise ValueError(f"frames of {h}x{w} are too small for a {ksize}-tap reflection")
    x = x.to(torch.int32)[:, _reflect101(h, pad, x.device)][:, :, _reflect101(w, pad, x.device)]
    rows = sum(t * x[:, :, i:i + w] for i, t in enumerate(taps))          # < 2^16
    out = sum(t * rows[:, i:i + h] for i, t in enumerate(taps))           # < 2^24
    return ((out + (1 << 15)) >> 16).to(torch.uint8)
