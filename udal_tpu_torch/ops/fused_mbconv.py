"""Fused MBConv front half: expand 1×1 → bn0/act/mask → depthwise k×k →
bn1/act/mask → SE sum.

Port of ``udal_tpu/ops/pallas_mbconv.py``. The TPU kernel ``_kernel``
becomes a CUDA kernel written for Hopper (``csrc/fused_expand_dw.cu``);
beside it stands its plain PyTorch version, ``fused_expand_dw_plain``. With
bn0 folded into the expand weights and bn1 into the taps:

    z = act(x · We + b0) · m1[n, e]          rounded to x's type
    a = act(depthwise_k×k,s,TF SAME(z) + b1) · m2[n, e]

returning ``y = a`` in x's type and ``se_sum = Σ_hw a`` in f32 (a sum, not
a mean). The expanded tensor z is rounded to the working type before the
depthwise, in the kernel's shared-memory tile as in the TPU kernel's ring
buffer, and in the plain version alike.

Two departures from the TPU kernel: the layout is the port's NCHW (the
batch-in-lanes [H, W, C, N] was a TPU layout), and the stride-2 windows
follow TF SAME, with the extra pad at the end as the model's convolution
has it, where the TPU kernel centres them on input row s·i (ROADMAP C1).
``fused_expand_dw`` takes the plain version for CPU tensors; for CUDA
tensors it launches the kernel or raises, and never falls back.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from udal_tpu_torch.models.efficientnet import activation_fn
from udal_tpu_torch.ops._build import load_library
from udal_tpu_torch.ops.fused_dw import (ACTS, check_conv, check_operands, depthwise_same,
                                         output_size, same_pads, spatial_tile)

CHANNEL_TILE = 16                 # expanded channels a block computes (kCT in the source)
SMEM_BUDGET = 160 * 1024          # bytes of shared memory a block may take
launches = 0


def fused_expand_dw_plain(x: torch.Tensor, we: torch.Tensor, b0: torch.Tensor,
                          m1: Optional[torch.Tensor], wd: torch.Tensor, b1: torch.Tensor,
                          m2: Optional[torch.Tensor], stride: int, ksize: int,
                          act: str = "swish") -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: f32 arithmetic on x's values, z and y
    rounded to x's type, se_sum of the f32 y."""
    fn = activation_fn(act)
    z = fn(F.conv2d(x.float(), we.float().t()[:, :, None, None])
           + b0.float()[:, None, None])
    if m1 is not None:
        z = z * m1.float()[:, :, None, None]
    z = z.to(x.dtype).float()
    a = fn(depthwise_same(z, wd.float(), stride) + b1.float()[:, None, None])
    if m2 is not None:
        a = a * m2.float()[:, :, None, None]
    return a.to(x.dtype), a.sum(dim=(2, 3))


def tile_shape(ho: int, wo: int, cin: int, stride: int, ksize: int,
               itemsize: int) -> Tuple[int, int]:
    """Output tile (rows, cols) whose staged tile fits ``SMEM_BUDGET``: the
    folded weights [Cin, 16] in f32 and the expanded tile
    [16, (th-1)·s+k, (tw-1)·s+k] in x's type."""
    th, tw = spatial_tile(ho, wo)

    def smem(th, tw):
        return (cin * CHANNEL_TILE * 4 + CHANNEL_TILE * ((th - 1) * stride + ksize)
                * ((tw - 1) * stride + ksize) * itemsize)

    while smem(th, tw) > SMEM_BUDGET and th > 1:
        th = (th + 1) // 2
    while smem(th, tw) > SMEM_BUDGET and tw > 1:
        tw = (tw + 1) // 2
    if smem(th, tw) > SMEM_BUDGET:
        raise ValueError(f"the fused expand + depthwise kernel cannot stage Cin={cin} "
                         f"input channels in {SMEM_BUDGET} bytes of shared memory")
    return th, tw


@functools.cache
def _kernel():
    fn = load_library("fused_expand_dw").udal_fused_expand_dw
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(x, we, b0, m1, wd, b1, m2, stride, ksize, act) -> None:
    ce = we.shape[-1]
    check_operands(x, {"we": we, "b0": b0, "wd": wd, "b1": b1}, {"m1": m1, "m2": m2}, ce)
    if (we.dim() != 2 or we.shape[0] != x.shape[1] or tuple(wd.shape) != (ce, ksize, ksize)
            or b0.shape != (ce,) or b1.shape != (ce,)):
        raise ValueError(f"we [Cin={x.shape[1]}, Ce], b0 and b1 [Ce], wd [Ce, {ksize}, "
                         f"{ksize}]; got {tuple(we.shape)}, {tuple(b0.shape)}, "
                         f"{tuple(b1.shape)}, {tuple(wd.shape)}")
    check_conv(ksize, stride, act)


def fused_expand_dw_cuda(x, we, b0, m1, wd, b1, m2, stride: int, ksize: int,
                         act: str = "swish") -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/fused_expand_dw.cu`` on CUDA tensors (checked)."""
    global launches
    _check(x, we, b0, m1, wd, b1, m2, stride, ksize, act)
    if x.device.type != "cuda":
        raise ValueError(f"the fused expand + depthwise kernel takes CUDA tensors, "
                         f"got {x.device}")
    n, cin, h, w = x.shape
    ce = we.shape[1]
    ho, wo = output_size(h, w, stride)
    th, tw = tile_shape(ho, wo, cin, stride, ksize, x.element_size())
    tiles = -(-ho // th) * -(-wo // tw)
    y = torch.empty((n, ce, ho, wo), dtype=x.dtype, device=x.device)
    partial = torch.empty((tiles, n, ce), dtype=torch.float32, device=x.device)
    se_sum = torch.empty((n, ce), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), we.data_ptr(), b0.data_ptr(), _ptr(m1), wd.data_ptr(),
                        b1.data_ptr(), _ptr(m2), y.data_ptr(), partial.data_ptr(),
                        se_sum.data_ptr(), int(x.dtype == torch.bfloat16), n, cin, ce, h, w,
                        ksize, stride, ho, wo, same_pads(h, ksize, stride)[0],
                        same_pads(w, ksize, stride)[0], th, tw, ACTS[act],
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused expand + depthwise kernel launch failed with CUDA error {err}")
    launches += 1
    return y, se_sum


def fused_expand_dw(x: torch.Tensor, we: torch.Tensor, b0: torch.Tensor,
                    m1: Optional[torch.Tensor], wd: torch.Tensor, b1: torch.Tensor,
                    m2: Optional[torch.Tensor], stride: int, ksize: int,
                    act: str = "swish") -> Tuple[torch.Tensor, torch.Tensor]:
    """MBConv front half: x [N, Cin, H, W] → (y [N, Ce, H', W'], se_sum [N, Ce]).

    Args:
      x: activations, f32 or bf16, contiguous NCHW.
      we: [Cin, Ce] f32 expand weights with the bn0 scale folded in.
      b0: [Ce] f32 expand-side bias (bn0).
      m1, m2: [N, Ce] f32 dropout masks pre-scaled by 1/keep, or None for
        deterministic inference.
      wd: [Ce, k, k] f32 depthwise taps with the bn1 scale folded in.
      b1: [Ce] f32 depthwise-side bias (bn1).
      stride, ksize: 1 or 2, 3 or 5 (TF SAME padding).
      act: a name in ``ACTS``.

    The plain version runs for CPU tensors, the kernel for CUDA tensors.
    """
    _check(x, we, b0, m1, wd, b1, m2, stride, ksize, act)
    if x.device.type == "cpu":
        return fused_expand_dw_plain(x, we, b0, m1, wd, b1, m2, stride, ksize, act)
    return fused_expand_dw_cuda(x, we, b0, m1, wd, b1, m2, stride, ksize, act)
