"""On-device bilinear warp of native-size frames: port of ``udal_tpu/ops/image_ops.py``.

``warp_resize_batch`` resizes each image by its own per-axis scale and
crops it at its own offset, onto a fixed output canvas: the device half of
the ``device_resize`` reader contract, whose host ships native-size uint8
frames and the warp parameters. As in ``jax.image.scale_and_translate``
(method "linear", no antialiasing), each axis is one contraction with an
[out, in] matrix of triangle-filter weights; here the B per-image matrices
of an axis are one batched matmul.
"""

from __future__ import annotations

from typing import Tuple

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
