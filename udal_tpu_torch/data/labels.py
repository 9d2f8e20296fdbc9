"""Training labels: padded groundtruth → per-level anchor targets.

Port of ``udal_tpu/data/labels.py``: the same label dictionary (per-level
``cls_targets_<l>`` [B, H, W, A] int32 and ``box_targets_<l>`` [B, H, W, 4A]
f32, ``mean_num_positives`` [B] and the padded ``groundtruth_data`` [B, M,
7(+1)]). The target assignment runs batched on the groundtruth's device
(``ops/target_assign.py``), so a training step on the card assigns there.
"""

from __future__ import annotations

from typing import Dict

import torch

from udal_tpu_torch.ops import anchors as anchor_lib
from udal_tpu_torch.ops.target_assign import label_anchors_multilevel


def build_labels(config, gt_boxes, gt_classes, pseudo_scores=None) -> Dict[str, torch.Tensor]:
    """The training label dict of a padded batch of groundtruth, built on
    ``gt_boxes``' device.

    Args:
      config: detection Config.
      gt_boxes: [B, M, 4] (y1, x1, y2, x2) in pixels; padded rows all-zero.
      gt_classes: [B, M] ints; padded rows <= 0 (real classes start at 1).
      pseudo_scores: optional [B, M] per-detection scores (the STAC column).

    Returns the label dict; ``mean_num_positives`` is the batch mean of the
    positives, replicated over the batch as the reference's batched mean.
    """
    gt_boxes = torch.as_tensor(gt_boxes, dtype=torch.float32)
    device = gt_boxes.device
    gt_classes = torch.as_tensor(gt_classes, device=device).to(torch.int32)
    cls_t, box_t, num_pos = label_anchors_multilevel(anchor_lib.from_config(config), gt_boxes,
                                                     gt_classes, gt_classes > 0)

    labels: Dict[str, torch.Tensor] = {}
    for level in cls_t:
        labels[f"cls_targets_{level}"] = cls_t[level]
        labels[f"box_targets_{level}"] = box_t[level]
    labels["mean_num_positives"] = torch.mean(num_pos).expand(gt_boxes.shape[0]).contiguous()
    labels["groundtruth_data"] = groundtruth_data(gt_boxes, gt_classes, pseudo_scores)
    return labels


def groundtruth_data(gt_boxes, gt_classes, pseudo_scores=None) -> torch.Tensor:
    """[B, M, 7(+1)] rows [y1, x1, y2, x2, is_crowd (0), area, class(,
    pseudo score)] of padded groundtruth."""
    gt_boxes = torch.as_tensor(gt_boxes, dtype=torch.float32)
    area = ((gt_boxes[..., 2] - gt_boxes[..., 0]) *
            (gt_boxes[..., 3] - gt_boxes[..., 1]))
    cols = [gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2], gt_boxes[..., 3],
            torch.zeros_like(area), area,
            torch.as_tensor(gt_classes, device=gt_boxes.device).to(torch.float32)]
    if pseudo_scores is not None:
        cols.append(torch.as_tensor(pseudo_scores, dtype=torch.float32, device=gt_boxes.device))
    return torch.stack(cols, dim=-1)
