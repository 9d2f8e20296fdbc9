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

The kernels cut the global rows (n · H + y) into bands of ``th`` rows by
``tw`` columns and the outputs into slices; ``plan`` chooses the kernel by
Cin and then the bands and slices (a band may span images, so the small
levels fill a block), and its shared-memory model is checked against the
source's before a launch. Cin ≤ 128 (d0 to d3) takes
``fused_sepconv_tc_kernel`` with a ``Plan``: a block per (band, slice), W's
chunk streamed with x's. Cin > 128 (d4 to d7x) takes the persistent
``fused_sepconv_resident_kernel`` with a ``ResidentPlan``: one block an SM,
each keeping its slice's rows of W in shared memory while its group walks
the bands, producer warps convolving and consumer warps multiplying; two
slices run as a cluster that shares each chunk's depthwise. ``launches``
counts kernel launches, ``resident_launches`` those of the resident kernel.
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

__all__ = ["fold_sepconv_bn", "fused_sepconv", "fused_sepconv_plain", "plan", "Plan",
           "ResidentPlan"]

# the source's kKC (input channels a chunk), kStages, kLdw, kLeft
CHUNK, STAGES, LDW, LEFT = 32, 2, 40, 8
# (outputs, pixels) a block of each tensor-core configuration, Cfg<0..2> in
# the source
TC_CONFIGS = ((64, 256), (128, 128), (384, 64))
# a block's shared memory: two blocks of 256 threads share an SM
SMEM_BUDGET = 112 * 1024
# the resident kernel (Cin above RESIDENT_FROM): a block's outputs at most
# (a slice is a multiple of a warp's 48 rows), its pixels a band, the
# ring's x stages, the depthwise tiles and the values of the consumer
# warps' output pieces (kRMb, kRWarpRows, kRNb, kRStages, kRTiles, 8 warps
# x 16 x kRLdo in the source); one block an SM may take 227 KB
RESIDENT_FROM = 128
R_OUTPUTS, R_ROWS, R_PIXELS, R_STAGES, R_TILES, R_PIECES = 192, 48, 64, 3, 4, 8 * 16 * 40
R_SMEM_BUDGET = 227 * 1024
launches = 0
resident_launches = 0


class Plan(NamedTuple):
    """A launch of ``fused_sepconv_tc_kernel`` (Cin ≤ 128)."""
    cfg: int     # tensor-core configuration
    th: int      # global rows a band
    tw: int      # columns a band: all of W, or a multiple of 8
    slices: int  # blocks a band, one a slice of the outputs


class ResidentPlan(NamedTuple):
    """A launch of ``fused_sepconv_resident_kernel`` (Cin > 128): block b
    keeps slice b % slices of the outputs and its group b // slices walks
    bands group, group + groups, … (groups = grid // slices)."""
    th: int      # global rows a band
    tw: int      # columns a band: all of W, or a multiple of 8
    mb: int      # outputs a slice: a multiple of 48, at most 192
    slices: int  # blocks a band; two run as a cluster sharing the depthwise
    grid: int    # blocks launched, a multiple of slices

    @property
    def pair(self) -> bool:
        return self.slices == 2


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


def resident_smem_bytes(cin: int, mb: int, pair: bool, th: int, tw: int) -> int:
    """A resident block's dynamic shared memory: its slice's rows of W
    (row stride Cin rounded to chunks + 8), the ring of x (half of each
    chunk's channels in a pair), the depthwise tiles, the consumer warps'
    output pieces, the tiles' two 8-byte barriers, the f32 taps, s and t."""
    cinp = -(-cin // CHUNK) * CHUNK
    ch = CHUNK // 2 if pair else CHUNK
    values = (mb * (cinp + 8) + R_STAGES * ch * (th + 2) * staged_width(tw)
              + R_TILES * CHUNK * (R_PIXELS + 8) + R_PIECES)
    return 2 * values + 16 * R_TILES + 4 * (cinp * 9 + 2 * mb)


@functools.cache
def sm_count() -> int:
    """The card's SMs, read once (132, an H100 SXM's, without a card)."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return 132


def resident_plan(n: int, cin: int, cout: int, h: int, w: int) -> ResidentPlan:
    """The resident kernel's launch for x [n, cin, h, w] → [n, cout, h, w],
    at most one block an SM.

    The fewest slices of at most 192 outputs whose W fits (each a multiple
    of 48); the band of at most 64 pixels, whole rows or a multiple of 8
    columns, that costs least over the tensor: per band the product's
    pixels, the depthwise's and the staged values (2 x 32 at d7x's P3 and
    P4, which the kernel convolves in 2 x 2 blocks); then one group of
    ``slices`` blocks a band up to the blocks the card holds."""
    rows = n * h
    tws = ([w] if pair_width(w) <= R_PIXELS else []) + list(range(min(R_PIXELS, w - 1) // 8 * 8,
                                                                  0, -8))
    slices = -(-cout // R_OUTPUTS)
    while True:
        mb = -(-(-(-cout // slices)) // R_ROWS) * R_ROWS
        pair = slices == 2
        best = None
        for tw in tws:
            th = max(1, min(R_PIXELS // pair_width(tw), rows))
            while th > 1 and resident_smem_bytes(cin, mb, pair, th, tw) > R_SMEM_BUDGET:
                th -= 1
            if resident_smem_bytes(cin, mb, pair, th, tw) > R_SMEM_BUDGET:
                continue
            bands = -(-rows // th) * -(-w // tw)
            cost = bands * (R_PIXELS + th * pair_width(tw) + (th + 2) * staged_width(tw))
            if best is None or cost < best[0]:
                best = (cost, th, tw, bands)
        if best is not None:
            break
        if mb == R_ROWS:
            raise ValueError(f"the resident separable conv cannot hold 48 rows of W at Cin={cin} "
                             f"in {R_SMEM_BUDGET} bytes of shared memory")
        slices += 1
    _, th, tw, bands = best
    groups = max(1, min(bands, sm_count() // slices))
    return ResidentPlan(th, tw, mb, slices, groups * slices)


def plan(n: int, cin: int, cout: int, h: int, w: int):
    """The launch for x [n, cin, h, w] → [n, cout, h, w]: a ``ResidentPlan``
    (``resident_plan``) for Cin > 128, else a ``Plan`` (``tc_plan``)."""
    if cin > RESIDENT_FROM:
        return resident_plan(n, cin, cout, h, w)
    return tc_plan(n, cin, cout, h, w)


def tc_plan(n: int, cin: int, cout: int, h: int, w: int) -> Plan:
    """The first kernel's bands and slices: the narrowest configuration
    whose block covers Cout (a wider Cout, in slices of 384). A band holds
    whole rows where a row's pairs fit the block's pixels, else the fewest
    bands of a multiple of 8 columns that fit them and the shared-memory
    budget; then as many rows as the pixels hold and the budget allows."""
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
def _resident_kernel():
    fn = load_library("fused_sepconv").udal_fused_sepconv_resident
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def kernel_smem_bytes(cfg: int, cin: int, th: int, tw: int) -> int:
    """The source's count of a block's dynamic shared memory."""
    fn = load_library("fused_sepconv").udal_fused_sepconv_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(cfg, cin, th, tw)


@functools.cache
def kernel_resident_smem_bytes(cin: int, mb: int, pair: bool, th: int, tw: int) -> int:
    """The source's count of a resident block's dynamic shared memory."""
    fn = load_library("fused_sepconv").udal_fused_sepconv_resident_smem
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn(cin, mb, int(pair), th, tw)


@functools.cache
def resident_capacity(cin: int, mb: int, pair: bool, th: int, tw: int, vec: bool) -> int:
    """Blocks of the resident kernel the card holds at once at that shared
    memory (twice its clusters for a pair), asked of the card once."""
    fn = load_library("fused_sepconv").udal_fused_sepconv_resident_capacity
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    blocks = fn(cin, mb, int(pair), th, tw, int(vec))
    if blocks <= 0:
        raise RuntimeError(f"the card holds no block of the resident separable conv at Cin={cin}, "
                           f"{mb} outputs a slice, bands {th}x{tw} (CUDA error {-blocks})")
    return blocks


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
    """Launch ``csrc/fused_sepconv.cu`` on CUDA bf16 tensors (checked), at
    ``plan``'s launch; a resident grid is cut to the blocks the card holds
    at once."""
    cin, cout = _check(x, taps, w, scale, bias, mask, pre, post)
    n, _, h, wd = x.shape
    p = plan(n, cin, cout, h, wd)
    if isinstance(p, ResidentPlan):
        cap = resident_capacity(cin, p.mb, p.pair, p.th, p.tw, _x_vectorised(x))
        p = p._replace(grid=min(p.grid, cap // p.slices * p.slices))
    return _launch(x, taps, w, scale, bias, mask, pre, post, p)


def _x_vectorised(x: torch.Tensor) -> bool:
    """x's rows take 16-byte copies: W a multiple of 8, x 16-byte aligned."""
    return x.shape[3] % 8 == 0 and x.data_ptr() % 16 == 0


def _launch(x, taps, w, scale, bias, mask, pre, post, p) -> torch.Tensor:
    """One launch of checked operands at ``p`` (a ``Plan`` or a
    ``ResidentPlan``), after the planner's shared-memory count is checked
    against the source's."""
    global launches, resident_launches
    cin, cout = _check(x, taps, w, scale, bias, mask, pre, post)
    if x.device.type != "cuda":
        raise ValueError(f"the fused separable conv kernel takes CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused separable conv kernel takes bfloat16, got {x.dtype}")
    n, _, h, wd = x.shape
    resident = isinstance(p, ResidentPlan)
    if resident:
        planned = resident_smem_bytes(cin, p.mb, p.pair, p.th, p.tw)
        counted = kernel_resident_smem_bytes(cin, p.mb, p.pair, p.th, p.tw)
    else:
        planned = smem_bytes(p.cfg, cin, p.th, p.tw)
        counted = kernel_smem_bytes(p.cfg, cin, p.th, p.tw)
    if counted != planned:
        raise RuntimeError(f"the band planner counts {planned} bytes of shared memory for {p}, "
                           f"the kernel {counted}")
    wvec = cin % 8 == 0 and w.data_ptr() % 16 == 0
    y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), taps.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), y.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if resident:
            err = _resident_kernel()(*ptrs, n, cin, cout, h, wd, p.th, p.tw, p.mb, p.slices,
                                     p.grid, int(_x_vectorised(x)), int(wvec), ACTS[pre],
                                     ACTS[post], stream)
        else:
            vec = int(_x_vectorised(x) and wvec)
            err = _kernel()(*ptrs, n, cin, cout, h, wd, p.th, p.tw, p.cfg, vec, ACTS[pre],
                            ACTS[post], stream)
    if err != 0:
        raise RuntimeError(f"fused separable conv kernel launch failed with CUDA error {err}")
    launches += 1
    resident_launches += resident
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
