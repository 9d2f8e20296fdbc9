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

In bf16 the kernel runs the expand on tensor cores from a split of the
folded f32 weights, ``split_weights``: hi = bf16(We), lo = bf16(We - hi),
both multiplied into one f32 sum, so We keeps about 16 bits (its products
with bf16 x are exact in f32). Where the operands take 16-byte copies (every
launch of the models) the weights ride the kernel's load ring with x, a
16-channel chunk a stage; otherwise they stay in shared memory for the
whole of Cin. In f32 the expand runs on CUDA cores.

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
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from udal_tpu_torch.models.efficientnet import activation_fn
from udal_tpu_torch.ops._build import load_library
from udal_tpu_torch.ops.fused_dw import (ACTS, check_conv, check_operands, depthwise_same,
                                         output_size, same_pads, spatial_tile)

# The tile planners model each kernel's shared memory; before a launch the
# model is checked against the source's own count (udal_fused_expand_dw_smem).
CHANNEL_TILE = 16                 # f32: expanded channels a block computes (kCT in the source)
SMEM_BUDGET = 160 * 1024          # f32: bytes of shared memory a block may take
# bf16 (tensor cores): the source's kTcCT, kKC, kNP and kStages, and the
# shared memory of a block when two share an SM (228 KB, 1 KB each
# reserved, 256 bytes of static b0 and m1)
TC_CHANNEL_TILE = 32
TC_K_CHUNK, TC_PIXELS, TC_STAGES = 16, 256, 3
TC_SMEM_BUDGET = 112 * 1024
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


def smem_bytes(cin: int, th: int, tw: int, stride: int, ksize: int) -> int:
    """Dynamic shared memory of the f32 kernel (``f32_smem_bytes`` in the
    source): the folded weights [Cin, 16] and the expanded tile
    [16, (th-1)·s+k, (tw-1)·s+k], f32."""
    return 4 * CHANNEL_TILE * (cin + ((th - 1) * stride + ksize) * ((tw - 1) * stride + ksize))


def tile_shape(ho: int, wo: int, cin: int, stride: int, ksize: int) -> Tuple[int, int]:
    """Output tile (rows, cols) of the f32 kernel whose block fits
    ``SMEM_BUDGET``."""
    th, tw = spatial_tile(ho, wo)
    while smem_bytes(cin, th, tw, stride, ksize) > SMEM_BUDGET and th > 1:
        th = (th + 1) // 2
    while smem_bytes(cin, th, tw, stride, ksize) > SMEM_BUDGET and tw > 1:
        tw = (tw + 1) // 2
    if smem_bytes(cin, th, tw, stride, ksize) > SMEM_BUDGET:
        raise ValueError(f"the fused expand + depthwise kernel cannot stage Cin={cin} "
                         f"input channels in {SMEM_BUDGET} bytes of shared memory")
    return th, tw


def split_weights(we: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """We [Cin, Ce] f32 → (hi, lo), each We^T [Ce, Cin] contiguous bf16 with
    hi = bf16(We) and lo = bf16(We - hi): hi + lo keeps We to about 2^-16
    of its magnitude."""
    wt = we.float().t().contiguous()
    hi = wt.to(torch.bfloat16)
    return hi, (wt - hi.float()).to(torch.bfloat16)


class Plan(NamedTuple):
    """A launch's output tile and, in bf16, its layout."""
    th: int
    tw: int
    streamed: bool   # bf16 with 16-byte copies: We^T rides the ring with x


def tc_smem_bytes(cin: int, th: int, tw: int, stride: int, ksize: int,
                  streamed: bool) -> int:
    """Dynamic shared memory of the bf16 kernel (``tc_smem_bytes`` in the
    source). Resident (plain loads): We^T hi and lo [32, cin padded to 16 +
    8], the x ring [stages, 16, 256 + 8] and z [32, plane]. Streamed (16-byte
    copies): each ring stage also holds its 16 channels of We^T hi and lo [2,
    32, 16 + 8], and nothing of We^T stays; bf16 throughout."""
    ih, iw = (th - 1) * stride + ksize, (tw - 1) * stride + ksize
    iwx = (iw + 14) // 8 * 8                 # staged columns: whole 8-column groups
    plane = ih * iwx + (8 if ih * iwx % 16 == 0 else 0)
    ct, kc = TC_CHANNEL_TILE, TC_K_CHUNK
    stage = kc * (TC_PIXELS + 8) + (2 * ct * (kc + 8) if streamed else 0)
    weights = 0 if streamed else 2 * ct * (-(-cin // kc) * kc + 8)
    return 2 * (weights + TC_STAGES * stage + ct * plane)


def tc_staged_per_output(th: int, tw: int, stride: int, ksize: int) -> float:
    """Input pixels the bf16 kernel stages (the expand computes) per output
    pixel of a th x tw tile: its halo, widened to whole 8-column groups."""
    return ((th - 1) * stride + ksize) * (((tw - 1) * stride + ksize + 14) // 8 * 8) / (th * tw)


def tc_tile_shape(ho: int, wo: int, cin: int, stride: int, ksize: int,
                  vec: bool = True) -> Plan:
    """Tile of the bf16 kernel in the layout its loads take (streamed with
    the 16-byte copies, ``vec``; resident with plain loads): of the tiles
    with rows a power of two (or all of ``ho``) and up to 64 columns whose
    block fits ``TC_SMEM_BUDGET``, the one that stages the fewest input
    pixels per output pixel (the halo the expand recomputes), then the
    largest."""
    rows = sorted({min(ho, 1 << i) for i in range(12)})
    cols = sorted({min(wo, c) for c in (8, 16, 32, 64)})
    best = None
    for th in rows:
        for tw in cols:
            if tc_smem_bytes(cin, th, tw, stride, ksize, vec) > TC_SMEM_BUDGET:
                continue
            key = (tc_staged_per_output(th, tw, stride, ksize), -th * tw)
            if best is None or key < best[0]:
                best = (key, Plan(th, tw, vec))
    if best is None:
        raise ValueError(f"the tensor-core expand + depthwise kernel cannot stage Cin={cin} "
                         f"input channels in {TC_SMEM_BUDGET} bytes of shared memory")
    return best[1]


@functools.cache
def _kernel():
    fn = load_library("fused_expand_dw").udal_fused_expand_dw
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def kernel_smem_bytes(tc: bool, cin: int, th: int, tw: int, stride: int, ksize: int,
                      streamed: bool) -> int:
    """The source's count of a block's dynamic shared memory."""
    fn = load_library("fused_expand_dw").udal_fused_expand_dw_smem
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    return fn(int(tc), int(streamed), cin, th, tw, ksize, stride)


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
                         act: str = "swish",
                         we_split=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/fused_expand_dw.cu`` on CUDA tensors (checked). bf16
    needs ``we_split = split_weights(we)``."""
    _check(x, we, b0, m1, wd, b1, m2, stride, ksize, act)
    if x.device.type != "cuda":
        raise ValueError(f"the fused expand + depthwise kernel takes CUDA tensors, "
                         f"got {x.device}")
    n, cin, h, w = x.shape
    ce = we.shape[1]
    ho, wo = output_size(h, w, stride)
    if x.dtype != torch.bfloat16:
        plan = Plan(*tile_shape(ho, wo, cin, stride, ksize), False)
        return _launch(x, we, b0, m1, wd, b1, m2, stride, ksize, act, None, plan)
    if we_split is None:
        raise ValueError("the bf16 kernel takes the weights as we_split = split_weights(we)")
    hi, lo = we_split
    if hi.shape != (ce, cin) or lo.shape != (ce, cin) or hi.dtype != torch.bfloat16 \
            or lo.dtype != torch.bfloat16 or not (hi.is_contiguous() and lo.is_contiguous()) \
            or hi.device != x.device or lo.device != x.device:
        raise ValueError(f"we_split must be two contiguous bfloat16 [{ce}, {cin}] tensors "
                         f"on {x.device}")
    plan = tc_tile_shape(ho, wo, cin, stride, ksize, _vectorised(x, hi, lo))
    return _launch(x, we, b0, m1, wd, b1, m2, stride, ksize, act, we_split, plan)


def _vectorised(x, hi, lo) -> bool:
    """The bf16 kernel's 16-byte copies, and with them the streamed
    weights: W and Cin multiples of 8, x, hi and lo 16-byte aligned."""
    return (x.shape[3] % 8 == 0 and x.shape[1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, hi, lo)))


def _launch(x, we, b0, m1, wd, b1, m2, stride, ksize, act, we_split,
            plan: Plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch at ``plan`` of checked operands (bf16 with ``we_split``),
    after the planner's shared-memory count is checked against the
    source's. The plan's layout must be the one the operands' loads take."""
    global launches
    n, cin, h, w = x.shape
    ce = we.shape[1]
    ho, wo = output_size(h, w, stride)
    tc = x.dtype == torch.bfloat16
    hi, lo = we_split if tc else (None, None)
    vec = tc and _vectorised(x, hi, lo)
    th, tw, streamed = plan
    if streamed != vec:
        raise ValueError(f"a {'streamed' if streamed else 'resident'} plan for operands that "
                         f"{'take' if vec else 'do not take'} the 16-byte copies")
    planned = (tc_smem_bytes(cin, th, tw, stride, ksize, streamed) if tc
               else smem_bytes(cin, th, tw, stride, ksize))
    counted = kernel_smem_bytes(tc, cin, th, tw, stride, ksize, streamed)
    if counted != planned:
        raise RuntimeError(f"the tile planner counts {planned} bytes of shared memory for a "
                           f"{th}x{tw} tile at Cin={cin} (streamed={streamed}), the kernel "
                           f"{counted}")
    tiles = -(-ho // th) * -(-wo // tw)
    y = torch.empty((n, ce, ho, wo), dtype=x.dtype, device=x.device)
    partial = torch.empty((tiles, n, ce), dtype=torch.float32, device=x.device)
    se_sum = torch.empty((n, ce), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), we.data_ptr(), _ptr(hi), _ptr(lo), b0.data_ptr(),
                        _ptr(m1), wd.data_ptr(), b1.data_ptr(), _ptr(m2), y.data_ptr(),
                        partial.data_ptr(), se_sum.data_ptr(), int(tc), n, cin, ce, h, w,
                        ksize, stride, ho, wo, same_pads(h, ksize, stride)[0],
                        same_pads(w, ksize, stride)[0], th, tw, int(vec), ACTS[act],
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused expand + depthwise kernel launch failed with CUDA error {err}")
    launches += 1
    return y, se_sum


def fused_expand_dw(x: torch.Tensor, we: torch.Tensor, b0: torch.Tensor,
                    m1: Optional[torch.Tensor], wd: torch.Tensor, b1: torch.Tensor,
                    m2: Optional[torch.Tensor], stride: int, ksize: int,
                    act: str = "swish", we_split=None) -> Tuple[torch.Tensor, torch.Tensor]:
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
      we_split: ``split_weights(we)``, computed once by the caller; the bf16
        kernel needs it, the f32 kernel and the plain version multiply by
        ``we`` itself.

    The plain version runs for CPU tensors, the kernel for CUDA tensors.
    """
    _check(x, we, b0, m1, wd, b1, m2, stride, ksize, act)
    if x.device.type == "cpu":
        return fused_expand_dw_plain(x, we, b0, m1, wd, b1, m2, stride, ksize, act)
    return fused_expand_dw_cuda(x, we, b0, m1, wd, b1, m2, stride, ksize, act, we_split)
