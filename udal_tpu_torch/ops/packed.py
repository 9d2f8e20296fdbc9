"""Packed-layout probe kernels: the port of the five Pallas kernels of
``tools/perf_packed.py``.

The probes pack g pixels into the channel dimension, ``[N, H, W/g, g·C]``
(or ``[M, g·C]`` flat), which fills a TPU's 128 lanes when C is narrow. In
row-major memory on the card that packed tensor is the NHWC tensor
``[N, H, W, C]`` itself, so no copy is ever needed; the public functions
keep the JAX script's packed shapes so the tests compare like with like.

==================  ============================  =========================================
function            TPU kernel                    computes
==================  ============================  =========================================
packed_pointwise    ``perf_packed.py:80`` (B4)    ``xp @ wbd``, f32 sums, rounded once
packed_wshift       ``perf_packed.py:147`` (B5)   a ±1 pixel shift along W, zero fill
add_one_natural     ``perf_packed.py:236`` (B6)   ``x + 1`` through the [rows, C] view
add_one_packed      ``perf_packed.py:264`` (B7)   ``x + 1`` in the [Mp, g·C] view
packed_dw_w3        ``perf_packed.py:296`` (B8)   3-tap depthwise along W, per-lane taps
==================  ============================  =========================================

B4 runs on tensor cores (``csrc/packed_pointwise.cu``), B5–B8 are
``csrc/packed_lane.cu``. Each has a plain version ``<name>_plain``, a
checked launcher ``<name>_cuda`` and a dispatcher ``<name>``, which takes
the plain version for CPU tensors and, for CUDA tensors, launches the
kernel or raises; it never falls back. ``launches[name]`` counts kernel
launches. The kernels take bf16, the plain versions any floating type.

Where the JAX grid would leave the last rows of the output unwritten (a row
count that is not a multiple of its tile, ROADMAP C4), every function here
raises instead.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from udal_tpu_torch.ops._build import load_library

__all__ = ["add_one_natural", "add_one_packed", "packed_dw_w3", "packed_pointwise",
           "packed_wshift"]

KERNEL_TYPE = torch.bfloat16
ROW_TILE = 8                 # H rows a step of the JAX wshift and dw_w3 grids covers
POINTWISE_MAX_K = 512        # the kernel keeps a [K, 128] weight slice in shared memory
launches = dict.fromkeys(("packed_pointwise", "packed_wshift", "add_one_natural",
                          "add_one_packed", "packed_dw_w3"), 0)


def _check_float(t: torch.Tensor, name: str, dims: int) -> None:
    if t.dim() != dims:
        raise ValueError(f"{name} must have {dims} dimensions, got shape {tuple(t.shape)}")
    if not t.is_floating_point():
        raise TypeError(f"{name} must be a floating tensor, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tiles(rows: int, tile: int, what: str) -> None:
    if tile <= 0 or rows % tile:
        raise ValueError(f"{what}: {rows} rows are not a multiple of the tile {tile}; the TPU "
                         f"kernel's grid would leave the last rows unwritten (ROADMAP C4)")


def _check_packed(x: torch.Tensor, cexp: int) -> None:
    """x [N, H, W/g, g·C] with H a multiple of the JAX grids' row tile."""
    _check_float(x, "x", 4)
    if cexp <= 0 or x.shape[-1] % cexp:
        raise ValueError(f"the last dimension {x.shape[-1]} is not g·C for C={cexp}")
    _check_tiles(x.shape[1], ROW_TILE, "H")


def _check_cuda(*tensors: torch.Tensor) -> None:
    """What every launcher takes: bf16 tensors on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the packed kernels take CUDA tensors, got {dev}")
    for t in tensors:
        if t.dtype != KERNEL_TYPE:
            raise TypeError(f"the packed kernels take bfloat16 tensors, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(err: int, name: str) -> None:
    """Raise on a failed launch, else count it."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    launches[name] += 1


@functools.cache
def _kernel(library: str, symbol: str, *argtypes):
    fn = getattr(load_library(library), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# -- B4: packed pointwise ------------------------------------------------------

def _check_pointwise(xp: torch.Tensor, wbd: torch.Tensor, m_tile: int) -> None:
    _check_float(xp, "xp", 2)
    _check_float(wbd, "wbd", 2)
    if wbd.shape[0] != xp.shape[1]:
        raise ValueError(f"xp {tuple(xp.shape)} and wbd {tuple(wbd.shape)} do not chain")
    _check_tiles(xp.shape[0], m_tile, "M")


def packed_pointwise_plain(xp: torch.Tensor, wbd: torch.Tensor,
                           m_tile: int = 512) -> torch.Tensor:
    """``xp @ wbd`` in f32 on xp's and wbd's values, rounded once to xp's type."""
    _check_pointwise(xp, wbd, m_tile)
    return (xp.float() @ wbd.float()).to(xp.dtype)


def packed_pointwise_cuda(xp: torch.Tensor, wbd: torch.Tensor,
                          m_tile: int = 512) -> torch.Tensor:
    """Launch ``csrc/packed_pointwise.cu`` (checked)."""
    _check_pointwise(xp, wbd, m_tile)
    _check_cuda(xp, wbd)
    (m, k), n = xp.shape, wbd.shape[1]
    if k > POINTWISE_MAX_K:
        raise ValueError(f"the pointwise kernel takes K <= {POINTWISE_MAX_K}, got {k}")
    y = torch.empty((m, n), dtype=xp.dtype, device=xp.device)
    vec = k % 8 == 0 and n % 8 == 0 and _aligned(xp, wbd, y)
    with torch.cuda.device(xp.device):
        err = _kernel("packed_pointwise", "udal_packed_pointwise", _P, _P, _P, _I, _I, _I, _I,
                      _I, _P)(xp.data_ptr(), wbd.data_ptr(), y.data_ptr(), m, k, n, m_tile,
                              int(vec), _stream(xp))
    _launched(err, "packed_pointwise")
    return y


def packed_pointwise(xp: torch.Tensor, wbd: torch.Tensor, m_tile: int = 512) -> torch.Tensor:
    """Lane-packed 1×1 conv: ``xp [M, g·Cin] @ wbd [g·Cin, g·Cout]``.

    f32 accumulation, one rounding to xp's type; any ``wbd`` (the probe's is
    block-diagonal). M must be a multiple of ``m_tile``, the rows a block
    (the TPU grid's step) covers. The plain version runs for CPU tensors,
    the kernel for CUDA tensors.
    """
    if xp.device.type == "cpu":
        return packed_pointwise_plain(xp, wbd, m_tile)
    return packed_pointwise_cuda(xp, wbd, m_tile)


# -- B5: shift along W ---------------------------------------------------------

def _check_wshift(x: torch.Tensor, cexp: int, g: int, direction: int) -> None:
    _check_packed(x, cexp)
    if x.shape[-1] != g * cexp:
        raise ValueError(f"the last dimension {x.shape[-1]} is not g·C = {g}·{cexp}")
    if direction not in (1, -1):
        raise ValueError(f"direction must be +1 or -1, got {direction}")


def packed_wshift_plain(x: torch.Tensor, cexp: int, g: int, direction: int) -> torch.Tensor:
    """The unpacked view [N, H, W, C] shifted by one pixel along W (+1: the
    value at w + 1; -1: at w - 1), zeros at the edge, repacked. Exact."""
    _check_wshift(x, cexp, g, direction)
    n, h = x.shape[:2]
    u = x.reshape(n, h, -1, cexp)
    zero = torch.zeros_like(u[:, :, :1])
    y = torch.cat([u[:, :, 1:], zero], 2) if direction > 0 else torch.cat([zero, u[:, :, :-1]], 2)
    return y.reshape(x.shape)


def packed_wshift_cuda(x: torch.Tensor, cexp: int, g: int, direction: int) -> torch.Tensor:
    """Launch ``csrc/packed_lane.cu``'s shift (checked)."""
    _check_wshift(x, cexp, g, direction)
    _check_cuda(x)
    y = torch.empty_like(x)
    if y.numel():
        rows = x.shape[0] * x.shape[1]
        with torch.cuda.device(x.device):
            err = _kernel("packed_lane", "udal_packed_wshift", _P, _P, _I, _I, _I, _I, _P)(
                x.data_ptr(), y.data_ptr(), rows, x.numel() // rows, direction * cexp,
                int(cexp % 8 == 0 and _aligned(x, y)), _stream(x))
        _launched(err, "packed_wshift")
    return y


def packed_wshift(x: torch.Tensor, cexp: int, g: int, direction: int) -> torch.Tensor:
    """Shift a packed ``[N, H, W/g, g·C]`` tensor by one pixel along W.

    ``direction`` +1 gives each pixel the value of its right neighbour, -1
    that of its left; the pixel past the edge is zero. H must be a multiple
    of 8 (the JAX grid's row tile). The plain version runs for CPU tensors,
    the kernel for CUDA tensors.
    """
    if x.device.type == "cpu":
        return packed_wshift_plain(x, cexp, g, direction)
    return packed_wshift_cuda(x, cexp, g, direction)


# -- B6 and B7: x + 1 through the natural and the packed view -------------------

def _check_add_one(x: torch.Tensor, cin: int, tile: int) -> None:
    _check_float(x, "x", 2)
    if cin <= 0 or x.shape[1] % cin:
        raise ValueError(f"the last dimension {x.shape[1]} is not g·C for C={cin}")
    _check_tiles(x.shape[0], tile, "Mp")


def add_one_plain(x: torch.Tensor, cin: int, tile: int = 512) -> torch.Tensor:
    """``x + 1`` rounded to x's type: the plain version of B6 and B7, which
    compute the same function (C only shapes B6's view)."""
    _check_add_one(x, cin, tile)
    return x + 1


def _add_one_cuda(x: torch.Tensor, name: str) -> torch.Tensor:
    _check_cuda(x)
    y = torch.empty_like(x)
    if y.numel():
        with torch.cuda.device(x.device):
            err = _kernel("packed_lane", "udal_add_one", _P, _P, _L, _P)(
                x.data_ptr(), y.data_ptr(), x.numel(), _stream(x))
        _launched(err, name)
    return y


def add_one_natural_cuda(x: torch.Tensor, cin: int, tile: int = 512) -> torch.Tensor:
    """Launch B6 (checked): the natural [Mp·g, C] view is the same bytes, so
    the kernel is B7's."""
    _check_add_one(x, cin, tile)
    return _add_one_cuda(x, "add_one_natural")


def add_one_packed_cuda(x: torch.Tensor, cin: int, tile: int = 512) -> torch.Tensor:
    """Launch B7 (checked)."""
    _check_add_one(x, cin, tile)
    return _add_one_cuda(x, "add_one_packed")


def add_one_natural(x: torch.Tensor, cin: int, tile: int = 512) -> torch.Tensor:
    """``x + 1`` on a packed ``[Mp, g·C]`` tensor through its natural
    ``[Mp·g, C]`` view (the probe of an in-kernel relayout, identity in
    row-major memory). Mp must be a multiple of ``tile``. The length is the
    input's (ROADMAP C5). The plain version runs for CPU tensors, the kernel
    for CUDA tensors."""
    if x.device.type == "cpu":
        return add_one_plain(x, cin, tile)
    return add_one_natural_cuda(x, cin, tile)


def add_one_packed(x: torch.Tensor, cin: int, tile: int = 512) -> torch.Tensor:
    """``x + 1`` on a packed ``[Mp, g·C]`` tensor in its own view (B6's
    baseline); as ``add_one_natural`` otherwise."""
    if x.device.type == "cpu":
        return add_one_plain(x, cin, tile)
    return add_one_packed_cuda(x, cin, tile)


# -- B8: 3-tap depthwise along W -----------------------------------------------

def _check_dw_w3(x: torch.Tensor, taps: torch.Tensor, cexp: int) -> None:
    _check_packed(x, cexp)
    _check_float(taps, "taps", 2)
    if tuple(taps.shape) != (3, x.shape[-1]):
        raise ValueError(f"taps must be [3, g·C] = [3, {x.shape[-1]}], got "
                         f"{tuple(taps.shape)}")
    if taps.device != x.device:
        raise ValueError(f"taps on {taps.device}, x on {x.device}")


def packed_dw_w3_plain(x: torch.Tensor, taps: torch.Tensor, cexp: int) -> torch.Tensor:
    """``(x[w-1]·t0[l] + x[w]·t1[l]) + x[w+1]·t2[l]`` in f32 on the unpacked
    view, zeros outside [0, W), rounded once to x's type; l = (w mod g)·C + c
    is the lane of the packed row."""
    _check_dw_w3(x, taps, cexp)
    n, h, wp, ge = x.shape
    g = ge // cexp
    u = x.float().reshape(n, h, wp * g, cexp)
    t = taps.float().reshape(3, g, cexp).repeat(1, wp, 1)      # [3, W, C]: the lane of each w
    zero = torch.zeros_like(u[:, :, :1])
    left = torch.cat([zero, u[:, :, :-1]], 2)
    right = torch.cat([u[:, :, 1:], zero], 2)
    return ((left * t[0] + u * t[1]) + right * t[2]).to(x.dtype).reshape(x.shape)


def packed_dw_w3_cuda(x: torch.Tensor, taps: torch.Tensor, cexp: int) -> torch.Tensor:
    """Launch ``csrc/packed_lane.cu``'s depthwise (checked)."""
    _check_dw_w3(x, taps, cexp)
    _check_cuda(x)
    taps = taps.float().contiguous()
    y = torch.empty_like(x)
    if y.numel():
        rows = x.shape[0] * x.shape[1]
        with torch.cuda.device(x.device):
            err = _kernel("packed_lane", "udal_packed_dw_w3", _P, _P, _P, _I, _I, _I, _I, _I,
                          _P)(x.data_ptr(), taps.data_ptr(), y.data_ptr(), rows,
                              x.numel() // rows, cexp, x.shape[-1],
                              int(cexp % 8 == 0 and _aligned(x, taps, y)), _stream(x))
        _launched(err, "packed_dw_w3")
    return y


def packed_dw_w3(x: torch.Tensor, taps: torch.Tensor, cexp: int) -> torch.Tensor:
    """k = 3 depthwise along W of a packed ``[N, H, W/g, g·C]`` tensor with
    per-lane taps ``[3, g·C]`` (not collapsed to [3, C]: the JAX function
    takes one tap per lane), zero padding, f32 arithmetic, one rounding to
    x's type. H must be a multiple of 8. The plain version runs for CPU
    tensors, the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return packed_dw_w3_plain(x, taps, cexp)
    return packed_dw_w3_cuda(x, taps, cexp)
