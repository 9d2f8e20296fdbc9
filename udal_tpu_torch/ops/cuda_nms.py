"""Greedy soft-NMS as a CUDA kernel written for Hopper (``csrc/soft_nms.cu``).

Replaces the TPU kernel ``udal_tpu/ops/pallas_nms.py:_nms_kernel`` (wrapped
there by ``pallas_soft_nms`` / ``batched_pallas_soft_nms``). The kernel runs
one thread-block cluster of ``CLUSTER`` blocks per image: the image's
candidates are split into contiguous shards, one per block, one candidate
a thread, and each of the K picks is a block-local argmax whose winner
every block pushes into every block's shared memory, then the same
reduction of those winners in every block. It is bound by the latency of
the K dependent picks, not by bytes. See the source for the design.

``plan`` gives the shards and threads of a launch; a launch the card
refuses raises. ``batched_soft_nms`` takes the plain version
(``ops/nms.py``) for tensors on the CPU. For CUDA tensors it launches the
kernel or raises; it never falls back. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from udal_tpu_torch.ops import nms as nms_lib
from udal_tpu_torch.ops._build import load_library

CLUSTER = 8                    # blocks a cluster (kCluster in the source; see PERF.md)
MAX_THREADS = 1024             # threads a block, one candidate each (kMaxThreads)
MAX_CANDIDATES = CLUSTER * MAX_THREADS   # 8192
launches = 0


class NMSPlan(NamedTuple):
    shard: int     # candidates a block owns: [r * shard, min((r + 1) * shard, n))
    threads: int   # threads a block: whole warps, one candidate each


def plan(n: int) -> NMSPlan:
    """The launch of ``n`` candidates an image: the shard of each of the
    cluster's blocks and the threads a block, as the source computes them."""
    if not 1 <= n <= MAX_CANDIDATES:
        raise ValueError(f"the soft-NMS kernel takes 1 to at most {MAX_CANDIDATES} "
                         f"candidates an image, got {n}")
    shard = -(-n // CLUSTER)
    return NMSPlan(shard, (shard + 31) // 32 * 32)


def shards(n: int) -> List[Tuple[int, int]]:
    """The [start, stop) of the candidates each block of the cluster owns
    (empty past n)."""
    shard = plan(n).shard
    return [(min(n, r * shard), min(n, (r + 1) * shard)) for r in range(CLUSTER)]


@functools.cache
def _kernel():
    fn = load_library("soft_nms").udal_soft_nms
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(boxes: torch.Tensor, scores: torch.Tensor, max_output_size: int) -> None:
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"soft-NMS takes float32 boxes and scores, got "
                        f"{boxes.dtype} and {scores.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"soft-NMS takes boxes [B, N, 4] and scores [B, N], got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.shape[0] < 1 or boxes.shape[1] < 1 or max_output_size < 1:
        raise ValueError("soft-NMS needs B, N and K of at least 1")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("soft-NMS takes contiguous boxes and scores")


def launch_picks(boxes: torch.Tensor, scores: torch.Tensor, max_output_size: int,
                 iou_threshold: float, score_threshold: float,
                 sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors (checked): the K picks unpacked,
    (indices [B, K] int32, scores [B, K] f32), as ``greedy_picks`` makes
    them."""
    global launches
    _check(boxes, scores, max_output_size)
    if boxes.device.type != "cuda":
        raise ValueError(f"the soft-NMS kernel takes CUDA tensors, got {boxes.device}")
    b, n, _ = boxes.shape
    plan(n)
    idx = torch.empty((b, max_output_size), dtype=torch.int32, device=boxes.device)
    sel = torch.empty((b, max_output_size), dtype=torch.float32, device=boxes.device)
    with torch.cuda.device(boxes.device):
        err = _kernel()(boxes.data_ptr(), scores.data_ptr(), idx.data_ptr(),
                        sel.data_ptr(), b, n, max_output_size, iou_threshold,
                        score_threshold, sigma,
                        torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soft-NMS kernel launch (clusters of {CLUSTER} blocks) failed "
                           f"with CUDA error {err}")
    launches += 1
    return idx, sel


def soft_nms_cuda(boxes: torch.Tensor, scores: torch.Tensor, max_output_size: int,
                  iou_threshold: float, score_threshold: float,
                  sigma: float) -> nms_lib.NMSResult:
    """``launch_picks``, then pack the picks."""
    idx, sel = launch_picks(boxes, scores, max_output_size, iou_threshold, score_threshold,
                            sigma)
    return nms_lib.pack_picks(idx, sel, boxes.shape[1], score_threshold)


def batched_soft_nms(boxes: torch.Tensor, scores: torch.Tensor,
                     max_output_size: int, iou_threshold: float = 0.5,
                     score_threshold: float = 0.001,
                     sigma: float = 0.5) -> nms_lib.NMSResult:
    """Soft-NMS over [B, N, 4] boxes: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    _check(boxes, scores, max_output_size)
    if boxes.device.type == "cpu":
        return nms_lib.batched_soft_nms(boxes, scores, max_output_size,
                                        iou_threshold, score_threshold, sigma)
    return soft_nms_cuda(boxes, scores, max_output_size, iou_threshold,
                         score_threshold, sigma)
