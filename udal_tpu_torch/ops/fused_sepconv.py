"""Fused separable conv: pre-activation, depthwise 3×3, pointwise 1×1, the
folded bias and BatchNorm, post-activation and the channel-dropout mask.

The BiFPN nodes' and the heads' ``SeparableConv`` with what follows it at
inference, as one CUDA kernel written for Hopper (``csrc/fused_sepconv.cu``)
beside its plain PyTorch version, ``fused_sepconv_plain``. It replaces no
TPU kernel (the JAX package leaves these convolutions to XLA); unfused, the
port ran each as ATen's depthwise, cuDNN's 1×1 conv, a BatchNorm, the
activation and the mask multiply. On NCHW x:

    y = post(s[co] · Σ_ci W[co, ci] · dw_ci(pre(x)) + t[co]) · mask[n, co]

with dw the 3×3 stride-1 depthwise under TF SAME padding, (s, t) f32 [Cout]
(``fold_sepconv_bn``), mask an f32 [N, Cout] multiplier (``dropout_mask``)
or None. Arithmetic in f32; pre(x) and the depthwise are rounded to x's
type before the product, as the unfused chain rounds them, and y once.
``fused_sepconv`` takes the plain version for CPU tensors (f32 or bf16);
for CUDA tensors it launches the kernel, which takes bf16 alone, or
raises, and never falls back. f32 on the card runs the unfused chain
(``bifpn.takes_fused``): a CUDA-core f32 kernel of the same design took
twice the chain's time.

The kernel cuts the global rows (n · H + y) into bands of ``th`` rows by
``tw`` columns and the outputs into slices; ``plan`` chooses them (a band
may span images, so the small levels fill a block) and checks its
shared-memory model against the source's (``udal_fused_sepconv_smem``).
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
from udal_tpu_torch.ops.fused_dw import ACTS, check_operands, depthwise_same, fold_bn

__all__ = ["fold_sepconv_bn", "fused_sepconv", "fused_sepconv_plain", "plan"]

# the source's kKC (input channels a chunk), kStages, kLdw, kLeft
CHUNK, STAGES, LDW, LEFT = 32, 2, 40, 8
# (outputs, pixels) a block of each tensor-core configuration, Cfg<0..2> in
# the source
TC_CONFIGS = ((64, 256), (128, 128), (384, 64))
# a block's shared memory: two blocks of 256 threads share an SM
SMEM_BUDGET = 112 * 1024
launches = 0


class Plan(NamedTuple):
    cfg: int     # tensor-core configuration
    th: int      # global rows a band
    tw: int      # columns a band: all of W, or a multiple of 8
    slices: int  # blocks a band, one a slice of the outputs


def fold_sepconv_bn(bn, conv_bias: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, t) in f32 with ``bn``(z + conv_bias) = z · s + t: an inference
    BatchNorm (running statistics) and the bias of the conv before it."""
    scale, shift = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    return scale, shift if conv_bias is None else shift + conv_bias.float() * scale


def pair_width(tw: int) -> int:
    return tw + (tw & 1)


def staged_width(tw: int) -> int:
    """Columns a staged row holds: the band's pairs and their halo, in
    whole 16-byte groups (``staged_width`` in the source)."""
    return -(-(pair_width(tw) + 10) // 8) * 8


def smem_bytes(cfg: int, cin: int, th: int, tw: int) -> int:
    """A block's dynamic shared memory: the ring of (x, W) chunks (or the
    output tile that takes it over, if larger), the depthwise tile, the
    f32 taps, s and t."""
    cinp = -(-cin // CHUNK) * CHUNK
    xs = CHUNK * (th + 2) * staged_width(tw)
    mb, nb = TC_CONFIGS[cfg]
    ring = max(STAGES * (xs + mb * LDW), mb * (nb + 8))
    return 2 * (ring + CHUNK * (nb + 8)) + 4 * (cinp * 9 + 2 * mb)


def plan(n: int, cin: int, cout: int, h: int, w: int) -> Plan:
    """Bands and slices for x [n, cin, h, w] → [n, cout, h, w].

    The narrowest configuration whose block covers Cout (a wider Cout, in
    slices of 384). A band holds whole rows
    where a row's pairs fit the block's pixels, else the fewest bands of a
    multiple of 8 columns that fit them and the shared-memory budget; then
    as many rows as the pixels hold and the budget allows."""
    cfg = 0 if cout <= 64 else 1 if cout <= 128 else 2
    mb, nb = TC_CONFIGS[cfg]
    bands = 1 if pair_width(w) <= nb else -(-w // nb)
    while True:
        tw = w if bands == 1 else -(-(-(-w // bands)) // 8) * 8
        th = max(1, min(nb // pair_width(tw), n * h))
        while th > 1 and smem_bytes(cfg, cin, th, tw) > SMEM_BUDGET:
            th -= 1
        if smem_bytes(cfg, cin, th, tw) <= SMEM_BUDGET:
            break
        if tw <= 8:
            raise ValueError(f"the fused separable conv cannot stage Cin={cin} at W={w} in "
                             f"{SMEM_BUDGET} bytes of shared memory")
        bands += 1
    return Plan(cfg, th, tw, -(-cout // mb))


def fused_sepconv_plain(x: torch.Tensor, taps: torch.Tensor, w: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, pre: str = "identity",
                        post: str = "identity") -> torch.Tensor:
    """The plain PyTorch version: f32 arithmetic on x's values, pre(x) and
    the depthwise rounded to x's type, y once."""
    cin = x.shape[1]
    xp = activation_fn(pre)(x.float()).to(x.dtype).float()
    d = depthwise_same(xp, taps.reshape(cin, 3, 3).float(), 1).to(x.dtype).float()
    z = F.conv2d(d, w.reshape(w.shape[0], cin, 1, 1).float())
    y = activation_fn(post)(z * scale.float()[:, None, None] + bias.float()[:, None, None])
    if mask is not None:
        y = y * mask.float()[:, :, None, None]
    return y.to(x.dtype)


@functools.cache
def _kernel():
    fn = load_library("fused_sepconv").udal_fused_sepconv
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def kernel_smem_bytes(cfg: int, cin: int, th: int, tw: int) -> int:
    """The source's count of a block's dynamic shared memory."""
    fn = load_library("fused_sepconv").udal_fused_sepconv_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(cfg, cin, th, tw)


def _check(x, taps, w, scale, bias, mask, pre, post) -> Tuple[int, int]:
    """(Cin, Cout) of checked operands."""
    if x.dim() != 4:
        raise ValueError(f"expected NCHW activations, got shape {tuple(x.shape)}")
    cin, cout = x.shape[1], w.shape[0]
    check_operands(x, {"scale": scale, "bias": bias}, {"mask": mask}, cout)
    if taps.numel() != cin * 9 or taps.shape[0] != cin or taps.shape[-2:] != (3, 3):
        raise ValueError(f"the fused separable conv takes 3x3 depthwise taps [Cin={cin}, (1,) "
                         f"3, 3], got {tuple(taps.shape)}")
    if w.numel() != cout * cin or w.dim() not in (2, 4) or w.shape[1] != cin:
        raise ValueError(f"pointwise weights [Cout, Cin={cin}(, 1, 1)], got {tuple(w.shape)}")
    for name, t in (("taps", taps), ("w", w)):
        if t.dtype != x.dtype or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be a contiguous {x.dtype} tensor on {x.device}, got "
                             f"{t.dtype} on {t.device}")
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError(f"scale and bias [Cout={cout}], got {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    for act in (pre, post):
        if act not in ACTS:
            raise ValueError(f"unsupported activation {act!r}")
    return cin, cout


def fused_sepconv_cuda(x: torch.Tensor, taps: torch.Tensor, w: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       mask: Optional[torch.Tensor] = None, pre: str = "identity",
                       post: str = "identity") -> torch.Tensor:
    """Launch ``csrc/fused_sepconv.cu`` on CUDA bf16 tensors (checked)."""
    global launches
    cin, cout = _check(x, taps, w, scale, bias, mask, pre, post)
    if x.device.type != "cuda":
        raise ValueError(f"the fused separable conv kernel takes CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused separable conv kernel takes bfloat16, got {x.dtype}")
    n, _, h, wd = x.shape
    p = plan(n, cin, cout, h, wd)
    planned = smem_bytes(p.cfg, cin, p.th, p.tw)
    counted = kernel_smem_bytes(p.cfg, cin, p.th, p.tw)
    if counted != planned:
        raise RuntimeError(f"the band planner counts {planned} bytes of shared memory for {p}, "
                           f"the kernel {counted}")
    vec = int(wd % 8 == 0 and cin % 8 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), taps.data_ptr(), w.data_ptr(), scale.data_ptr(),
                        bias.data_ptr(), None if mask is None else mask.data_ptr(), y.data_ptr(),
                        n, cin, cout, h, wd, p.th, p.tw, p.cfg, vec, ACTS[pre],
                        ACTS[post], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused separable conv kernel launch failed with CUDA error {err}")
    launches += 1
    return y


def fused_sepconv(x: torch.Tensor, taps: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  pre: str = "identity", post: str = "identity") -> torch.Tensor:
    """A separable conv and what follows it at inference, as one call.

    Args:
      x: [N, Cin, H, W] activations, contiguous: bf16 on a card, f32 or
        bf16 on the CPU.
      taps: [Cin, 1, 3, 3] (or [Cin, 3, 3]) depthwise weights in x's type.
      w: [Cout, Cin, 1, 1] (or [Cout, Cin]) pointwise weights in x's type.
      scale, bias: [Cout] f32, the pointwise bias and the BatchNorm after it
        folded (``fold_sepconv_bn``); ones and the bias where none follows.
      mask: optional [N, Cout] f32 channel-dropout multiplier, already
        scaled by 1/keep.
      pre, post: names in ``ACTS`` applied to x and to the folded output.

    Returns y [N, Cout, H, W] in x's type. The plain version runs for CPU
    tensors, the kernel for CUDA tensors.
    """
    _check(x, taps, w, scale, bias, mask, pre, post)
    if x.device.type == "cpu":
        return fused_sepconv_plain(x, taps, w, scale, bias, mask, pre, post)
    return fused_sepconv_cuda(x, taps, w, scale, bias, mask, pre, post)
