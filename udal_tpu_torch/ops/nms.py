"""Greedy (soft-)NMS, plain PyTorch, batched over images.

Port of ``udal_tpu/ops/nms.py`` (TF NonMaxSuppressionV5 semantics):

* gaussian method (``sigma > 0``): candidates with IoU <= iou_threshold
  against a pick are decayed by exp(-iou^2 / sigma); IoU above the
  threshold suppresses hard;
* hard method (``sigma == 0``): binary suppression at iou_threshold;
* a candidate leaves the pool once hard-suppressed or decayed below
  score_threshold; ``valid_len`` counts picks above it.

This is the plain version of the CUDA kernel in ``ops/cuda_nms.py``: the
same expressions in the same order, vectorised over the batch, with a
Python loop over the K picks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e10


class NMSResult(NamedTuple):
    indices: torch.Tensor     # [B, K] int64 indices into the input boxes
    scores: torch.Tensor      # [B, K] decayed scores (0 for invalid slots)
    valid: torch.Tensor       # [B, K] bool validity
    valid_len: torch.Tensor   # [B] int32


def nms_from_config(nms_configs: dict):
    """Resolve (iou_thresh, score_thresh, sigma) like the JAX package."""
    method = nms_configs.get("method", "gaussian")
    if method == "hard" or not method:
        sigma = 0.0
        iou_thresh = nms_configs.get("iou_thresh") or 0.5
        score_thresh = nms_configs.get("score_thresh")
        score_thresh = score_thresh if score_thresh not in (None, 0.0) else float("-inf")
    elif method == "gaussian":
        sigma = nms_configs.get("sigma") or 0.5
        iou_thresh = 0.5
        score_thresh = nms_configs.get("score_thresh") or 0.001
    else:
        raise ValueError(f"invalid nms method {method!r}")
    return iou_thresh, score_thresh, sigma


def greedy_picks(boxes: torch.Tensor, scores: torch.Tensor, max_output_size: int,
                 iou_threshold: float, score_threshold: float, sigma: float):
    """The K greedy picks, unpacked: (indices [B, K] int64, scores [B, K]).

    boxes [B, N, 4] (y1, x1, y2, x2) and scores [B, N], float32. Each pick
    is the argmax of the working scores with ties to the lowest index; an
    exhausted pool yields NEG_INF picks.
    """
    work = scores.to(torch.float32).clone()
    b, n = work.shape
    y1, x1, y2, x2 = boxes.to(torch.float32).unbind(-1)
    area = torch.clamp_min(y2 - y1, 0.0) * torch.clamp_min(x2 - x1, 0.0)
    lane = torch.arange(n, device=work.device)
    sel_idx = torch.zeros((b, max_output_size), dtype=torch.int64, device=work.device)
    sel_scores = torch.full((b, max_output_size), NEG_INF, dtype=torch.float32,
                            device=work.device)
    for i in range(max_output_size):
        best_score = torch.amax(work, dim=1, keepdim=True)             # [B, 1]
        best = torch.amin(torch.where(work == best_score, lane, n), dim=1,
                          keepdim=True)                                 # [B, 1]
        sel_idx[:, i] = best[:, 0]
        sel_scores[:, i] = best_score[:, 0]

        by1, bx1, by2, bx2 = (t.gather(1, best) for t in (y1, x1, y2, x2))
        barea = torch.clamp_min(by2 - by1, 0.0) * torch.clamp_min(bx2 - bx1, 0.0)
        inter = (torch.clamp_min(torch.minimum(y2, by2) - torch.maximum(y1, by1), 0.0)
                 * torch.clamp_min(torch.minimum(x2, bx2) - torch.maximum(x1, bx1), 0.0))
        union = area + barea - inter
        iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-12), 0.0)
        if sigma > 0:
            weight = torch.where(iou <= iou_threshold,
                                 torch.exp(-(iou * iou) / sigma), 0.0)
        else:
            weight = (iou <= iou_threshold).to(torch.float32)
        decayed = work * weight
        dead = (weight == 0.0) | (decayed < score_threshold) | (lane == best)
        work = torch.where(dead, NEG_INF, decayed)
    return sel_idx, sel_scores


def pack_picks(sel_idx: torch.Tensor, sel_scores: torch.Tensor, n: int,
               score_threshold: float) -> NMSResult:
    """Valid picks first (stable), indices clipped to [0, n-1], invalid
    scores 0 — the epilogue of both the plain version and the kernel."""
    valid = (sel_scores > score_threshold) & (sel_scores > NEG_INF / 2)
    order = torch.sort((~valid).to(torch.int32), dim=1, stable=True).indices
    idx = torch.clamp(sel_idx.to(torch.int64).gather(1, order), 0, n - 1)
    valid = valid.gather(1, order)
    scores = torch.where(valid, sel_scores.gather(1, order), 0.0)
    return NMSResult(idx, scores, valid, valid.sum(dim=1, dtype=torch.int32))


def batched_soft_nms(boxes: torch.Tensor, scores: torch.Tensor,
                     max_output_size: int, iou_threshold: float = 0.5,
                     score_threshold: float = 0.001,
                     sigma: float = 0.5) -> NMSResult:
    """Greedy (soft-)NMS over [B, N, 4] boxes and [B, N] scores; K outputs."""
    sel_idx, sel_scores = greedy_picks(boxes, scores, max_output_size,
                                       iou_threshold, score_threshold, sigma)
    return pack_picks(sel_idx, sel_scores, boxes.shape[1], score_threshold)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, max_output_size: int,
             iou_threshold: float = 0.5, score_threshold: float = 0.001,
             sigma: float = 0.5) -> NMSResult:
    """One image: [N, 4] boxes, [N] scores → NMSResult of [K] tensors."""
    res = batched_soft_nms(boxes[None], scores[None], max_output_size,
                           iou_threshold, score_threshold, sigma)
    return NMSResult(*(t[0] for t in res))
