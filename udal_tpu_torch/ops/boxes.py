"""Box geometry: the IoU family, pairwise IoU and clipping.

Port of ``udal_tpu/ops/boxes.py``. Boxes are (y1, x1, y2, x2); every
function broadcasts over leading axes, and a zero denominator gives 0 (TF's
``divide_no_nan``), as in the JAX package.
"""

from __future__ import annotations

import math

import torch


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b with 0 where b == 0."""
    nonzero = b != 0
    return torch.where(nonzero, a / torch.where(nonzero, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def iou_per_anchor(pred_boxes: torch.Tensor, target_boxes: torch.Tensor,
                   iou_type: str = "iou") -> torch.Tensor:
    """Elementwise IoU (or GIoU, DIoU, CIoU) of aligned boxes [..., 4]."""
    t_ymin, t_xmin, t_ymax, t_xmax = target_boxes.unbind(-1)
    p_ymin, p_xmin, p_ymax, p_xmax = pred_boxes.unbind(-1)

    p_width = torch.clamp_min(p_xmax - p_xmin, 0.0)
    p_height = torch.clamp_min(p_ymax - p_ymin, 0.0)
    t_width = torch.clamp_min(t_xmax - t_xmin, 0.0)
    t_height = torch.clamp_min(t_ymax - t_ymin, 0.0)
    p_area = p_width * p_height
    t_area = t_width * t_height

    i_ymin = torch.maximum(p_ymin, t_ymin)
    i_xmin = torch.maximum(p_xmin, t_xmin)
    i_ymax = torch.minimum(p_ymax, t_ymax)
    i_xmax = torch.minimum(p_xmax, t_xmax)
    i_area = torch.clamp_min(i_xmax - i_xmin, 0.0) * torch.clamp_min(i_ymax - i_ymin, 0.0)

    union = p_area + t_area - i_area
    iou_v = _safe_div(i_area, union)
    if iou_type == "iou":
        return iou_v

    e_ymin = torch.minimum(p_ymin, t_ymin)
    e_xmin = torch.minimum(p_xmin, t_xmin)
    e_ymax = torch.maximum(p_ymax, t_ymax)
    e_xmax = torch.maximum(p_xmax, t_xmax)

    if iou_type == "giou":
        e_area = torch.clamp_min(e_xmax - e_xmin, 0.0) * torch.clamp_min(e_ymax - e_ymin, 0.0)
        return iou_v - _safe_div(e_area - union, e_area)

    center_dist_sq = (((t_ymin + t_ymax) - (p_ymin + p_ymax)) ** 2 +
                      ((t_xmin + t_xmax) - (p_xmin + p_xmax)) ** 2) / 4.0
    diag_sq = (e_ymax - e_ymin) ** 2 + (e_xmax - e_xmin) ** 2
    diou_v = iou_v - _safe_div(center_dist_sq, diag_sq)
    if iou_type == "diou":
        return diou_v

    if iou_type == "ciou":
        arctan = (torch.arctan(_safe_div(t_width, t_height)) -
                  torch.arctan(_safe_div(p_width, p_height)))
        v = 4.0 * (arctan / math.pi) ** 2
        alpha = _safe_div(v, (1.0 - iou_v) + v)
        return diou_v - alpha * v

    raise ValueError(f"Unknown iou_type {iou_type!r}")


def iou_loss(pred_boxes: torch.Tensor, target_boxes: torch.Tensor,
             iou_type: str = "iou") -> torch.Tensor:
    """Sum over anchors of (1 - IoU), rows whose target is all-zero masked.

    Inputs are [..., 4k] rows of k boxes; returns the sum over the boxes of
    each row, [...] (a scalar for [N, 4] inputs)."""
    if iou_type not in ("iou", "ciou", "diou", "giou"):
        raise ValueError(f"Unknown loss_type {iou_type!r}")
    shape = pred_boxes.shape
    pred = pred_boxes.reshape(shape[:-1] + (-1, 4))
    tgt = target_boxes.reshape(shape[:-1] + (-1, 4))
    mask = torch.any(tgt != 0.0, dim=-1).to(pred.dtype)
    per = iou_per_anchor(pred, tgt, iou_type)
    # the reference's reduction: every axis from ndim - 2 - (len(shape) - 2) on
    axes = tuple(range(pred.ndim - 2 - (len(shape) - 2), per.ndim))
    return torch.sum(mask * (1.0 - per), dim=axes)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix [..., N, M] of [..., N, 4] and [..., M, 4] boxes; a zero
    union gives 0."""
    area1 = torch.clamp_min(boxes1[..., 2] - boxes1[..., 0], 0.0) * \
        torch.clamp_min(boxes1[..., 3] - boxes1[..., 1], 0.0)
    area2 = torch.clamp_min(boxes2[..., 2] - boxes2[..., 0], 0.0) * \
        torch.clamp_min(boxes2[..., 3] - boxes2[..., 1], 0.0)
    yx1 = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    yx2 = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    inter = torch.prod(torch.clamp_min(yx2 - yx1, 0.0), dim=-1)
    union = area1[..., :, None] + area2[..., None, :] - inter
    return _safe_div(inter, union)


def clip_boxes(boxes: torch.Tensor, image_size) -> torch.Tensor:
    """Clip y1x1y2x2 boxes to [0, H] x [0, W]."""
    h, w = image_size
    hi = torch.tensor([h, w, h, w], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(torch.clamp_min(boxes, 0.0), hi)
