"""Fused depthwise conv + BN + activation (+ dropout mask, SE mean).

Port of ``udal_tpu/ops/pallas_dw.py``. The TPU kernel ``_dw_kernel``
becomes a CUDA kernel written for Hopper (``csrc/fused_dw.cu``); beside it
stands its plain PyTorch version, ``fused_depthwise_plain``. The layout is
the port's NCHW (the TPU's C % 128 lane rule is gone):

    y = act(depthwise_k×k,s,TF SAME(x) · scale + bias) · mask[n, c]

computed in f32 and rounded to x's type, with the f32 spatial mean of y
per (n, c) when asked (the squeeze-excite input). ``fused_depthwise`` takes
the plain version for CPU tensors; for CUDA tensors it launches the kernel
or raises, and never falls back. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from udal_tpu_torch.models.efficientnet import activation_fn, same_pads
from udal_tpu_torch.ops._build import load_library

__all__ = ["ACTS", "fold_bn", "fused_depthwise", "fused_depthwise_plain", "same_pads"]

# activation name → the kernels' code (depthwise_tile.cuh, enum Act)
ACTS = {"swish": 0, "silu": 0, "swish_native": 0, "relu": 1, "relu6": 2, "identity": 3,
        "hswish": 4, "mish": 5}
KERNEL_TYPES = (torch.float32, torch.bfloat16)
TILE_OUTPUTS = 512      # output pixels a block covers
TILE_CHANNELS = 8       # channels a block covers (one warp each)
launches = 0

DepthwiseOut = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def fold_bn(gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm folded to (scale, bias), in f32."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def output_size(h: int, w: int, stride: int) -> Tuple[int, int]:
    return -(-h // stride), -(-w // stride)


def spatial_tile(ho: int, wo: int) -> Tuple[int, int]:
    """(rows, cols) of output pixels a block covers: up to 64 columns and
    ``TILE_OUTPUTS`` pixels."""
    tw = min(wo, 64)
    return max(1, min(ho, TILE_OUTPUTS // tw)), tw


def check_operands(x: torch.Tensor, params, masks, c: int) -> None:
    """What both fused kernels take: x [N, C, H, W] contiguous in f32 or
    bf16; f32 contiguous parameters; masks f32 [N, c] or None; one device."""
    if x.dim() != 4:
        raise ValueError(f"expected NCHW activations, got shape {tuple(x.shape)}")
    if x.dtype not in KERNEL_TYPES:
        raise TypeError(f"the fused kernels take float32 or bfloat16 activations, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the fused kernels take contiguous NCHW activations")
    for name, t in params.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous float32 tensor, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, activations on {x.device}")
    for name, m in masks.items():
        if m is None:
            continue
        if m.dtype != torch.float32 or tuple(m.shape) != (x.shape[0], c) \
                or not m.is_contiguous() or m.device != x.device:
            raise ValueError(f"{name} must be a contiguous float32 [{x.shape[0]}, {c}] "
                             f"tensor on {x.device}, got {m.dtype} {tuple(m.shape)} on "
                             f"{m.device}")


def check_conv(k: int, stride: int, act: str) -> None:
    if k not in (3, 5) or stride not in (1, 2):
        raise ValueError(f"the fused kernels take k in (3, 5) and stride in (1, 2), "
                         f"got k={k}, stride={stride}")
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act!r}")


def depthwise_same(x: torch.Tensor, taps: torch.Tensor, stride: int) -> torch.Tensor:
    """Depthwise conv of NCHW ``x`` with ``taps`` [C, k, k], TF SAME."""
    k = taps.shape[-1]
    ph, pw = same_pads(x.shape[-2], k, stride), same_pads(x.shape[-1], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, taps[:, None], stride=stride, groups=taps.shape[0])


def fused_depthwise_plain(x: torch.Tensor, taps: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                          stride: int = 1, act: str = "swish",
                          want_mean: bool = False) -> DepthwiseOut:
    """The plain PyTorch version: f32 arithmetic on x's values, y rounded to
    x's type; the mean is taken of the f32 y (after the mask)."""
    y = depthwise_same(x.float(), taps.float(), stride)
    y = activation_fn(act)(y * scale.float()[:, None, None] + bias.float()[:, None, None])
    if mask is not None:
        y = y * mask.float()[:, :, None, None]
    if want_mean:
        return y.to(x.dtype), y.mean(dim=(2, 3))
    return y.to(x.dtype)


@functools.cache
def _kernel():
    fn = load_library("fused_dw").udal_fused_dw
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fused_depthwise_cuda(x: torch.Tensor, taps: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                         stride: int = 1, act: str = "swish",
                         want_mean: bool = False) -> DepthwiseOut:
    """Launch ``csrc/fused_dw.cu`` on CUDA tensors (checked)."""
    global launches
    _check(x, taps, scale, bias, mask, stride, act)
    if x.device.type != "cuda":
        raise ValueError(f"the fused depthwise kernel takes CUDA tensors, got {x.device}")
    n, c, h, w = x.shape
    k = taps.shape[-1]
    ho, wo = output_size(h, w, stride)
    th, tw = spatial_tile(ho, wo)
    y = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device)
    partial = mean = None
    if want_mean:
        tiles = -(-ho // th) * -(-wo // tw)
        partial = torch.empty((tiles, n, c), dtype=torch.float32, device=x.device)
        mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), taps.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                        _ptr(mask), y.data_ptr(), _ptr(partial), _ptr(mean),
                        int(x.dtype == torch.bfloat16), n, c, h, w, k, stride, ho, wo,
                        same_pads(h, k, stride)[0], same_pads(w, k, stride)[0], th, tw,
                        TILE_CHANNELS, ACTS[act],
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused depthwise kernel launch failed with CUDA error {err}")
    launches += 1
    return (y, mean) if want_mean else y


def _check(x, taps, scale, bias, mask, stride, act) -> None:
    c = x.shape[1] if x.dim() == 4 else -1
    check_operands(x, {"taps": taps, "scale": scale, "bias": bias}, {"mask": mask}, c)
    k = taps.shape[-1]
    if tuple(taps.shape) != (c, k, k) or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"taps [C, k, k], scale and bias [C] for C={c}, got "
                         f"{tuple(taps.shape)}, {tuple(scale.shape)}, {tuple(bias.shape)}")
    check_conv(k, stride, act)


def fused_depthwise(x: torch.Tensor, taps: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                    stride: int = 1, act: str = "swish",
                    want_mean: bool = False) -> DepthwiseOut:
    """Fused depthwise conv + BN + activation (+ mask, + SE mean).

    Args:
      x: [N, C, H, W] activations, f32 or bf16, contiguous.
      taps: [C, k, k] f32 depthwise filters, k in (3, 5).
      scale, bias: [C] f32 folded BatchNorm (see ``fold_bn``).
      mask: optional [N, C] f32 channel-dropout multiplier, already scaled
        by 1/keep.
      stride: 1 or 2 (TF SAME padding).
      act: a name in ``ACTS``.
      want_mean: also return the f32 spatial mean [N, C] of y.

    Returns y [N, C, H', W'] in x's type, and the mean if ``want_mean``.
    The plain version runs for CPU tensors, the kernel for CUDA tensors.
    """
    _check(x, taps, scale, bias, mask, stride, act)
    if x.device.type == "cpu":
        return fused_depthwise_plain(x, taps, scale, bias, mask, stride, act, want_mean)
    return fused_depthwise_cuda(x, taps, scale, bias, mask, stride, act, want_mean)
