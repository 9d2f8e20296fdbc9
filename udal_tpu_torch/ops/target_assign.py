"""Anchor-to-groundtruth target assignment, batched over the images.

Port of ``udal_tpu/ops/target_assign.py``, which ``vmap``s one image's
assignment: here every function takes a leading batch axis. Ties break as
TF's ``argmax`` breaks them (the first maximum wins), and an anchor that is
the best of several groundtruth rows goes to the lowest row, as the
reference's one-hot trick gives; that trick's [B, M, N] one-hot is a
scatter-min over the rows here, with the same result.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from udal_tpu_torch.ops import anchors as anchor_lib
from udal_tpu_torch.ops.boxes import pairwise_iou


def argmax_match(similarity: torch.Tensor, row_valid: torch.Tensor,
                 matched_threshold: float = 0.5, unmatched_threshold: float = 0.5,
                 negatives_lower_than_unmatched: bool = True,
                 force_match_for_each_row: bool = True) -> torch.Tensor:
    """Match each anchor (column of the [B, M, N] similarity) to a row.

    Returns int64 [B, N]: >= 0 the row, -1 unmatched (negative), -2 ignored
    (between the thresholds). Invalid rows (``row_valid`` [B, M] False)
    count as similarity -1."""
    b, num_gt, num_anchors = similarity.shape
    sim = torch.where(row_valid[:, :, None], similarity,
                      torch.full_like(similarity, -1.0))
    if num_gt == 0:
        return torch.full((b, num_anchors), -1, dtype=torch.int64, device=sim.device)

    # argmax gives the first maximum (torch.max's index is not documented to)
    matched_vals = torch.amax(sim, dim=1)
    matches = torch.argmax(sim, dim=1)
    below = unmatched_threshold > matched_vals
    between = (matched_vals >= unmatched_threshold) & (matched_threshold > matched_vals)
    low, mid = (-1, -2) if negatives_lower_than_unmatched else (-2, -1)
    matches = torch.where(below, torch.full_like(matches, low), matches)
    matches = torch.where(between, torch.full_like(matches, mid), matches)

    if force_match_for_each_row:
        # each valid row's best anchor goes to that row; the lowest row wins
        force_cols = torch.argmax(sim, dim=2)                          # [B, M]
        rows = torch.arange(num_gt, device=sim.device).expand(b, num_gt)
        rows = torch.where(row_valid, rows, torch.full_like(rows, num_gt))
        force_rows = torch.full((b, num_anchors), num_gt, dtype=torch.int64,
                                device=sim.device)
        force_rows.scatter_reduce_(1, force_cols, rows, reduce="amin")
        matches = torch.where(force_rows < num_gt, force_rows, matches)
    return matches


def _gather_based_on_match(match_results: torch.Tensor, values: torch.Tensor,
                           unmatched_value: float, ignored_value: float) -> torch.Tensor:
    """Per-anchor values [B, N, ...] of matched rows of ``values`` [B, M,
    ...], with ``unmatched_value`` at -1 and ``ignored_value`` at -2: the
    reference's table [ignored, unmatched, values...] gathered at match + 2."""
    b = values.shape[0]
    tail = values.shape[2:]
    fill = lambda v: torch.full((b, 1) + tail, v, dtype=values.dtype,  # noqa: E731
                                device=values.device)
    table = torch.cat([fill(ignored_value), fill(unmatched_value), values], dim=1)
    idx = torch.clamp_min(match_results + 2, 0)
    idx = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return torch.gather(table, 1, idx)


def label_anchors(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                  match_threshold: float = 0.5
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Class and box targets of every anchor, for a batch of images.

    Args:
      anchor_boxes: [N, 4] anchors.
      gt_boxes: [B, M, 4] padded groundtruth (y1, x1, y2, x2), pixels.
      gt_classes: [B, M] int labels (real classes >= 1).
      gt_valid: [B, M] bool, which padded rows are real.
      match_threshold: the IoU threshold (matched == unmatched).

    Returns:
      cls_targets [B, N] int32 (class - 1, background -1, ignored -2),
      box_targets [B, N, 4] f32 (encoded; zeros where unmatched) and
      num_positives [B] f32 (anchors whose match is not -1).
    """
    gt_boxes = gt_boxes.to(torch.float32)
    sim = pairwise_iou(gt_boxes, anchor_boxes.expand(gt_boxes.shape[0], -1, -1))
    matches = argmax_match(sim, gt_valid, match_threshold, match_threshold)

    cls = _gather_based_on_match(matches, gt_classes.to(torch.float32), 0.0, 0.0)
    cls_targets = cls.to(torch.int32) - 1

    matched_gt = _gather_based_on_match(matches, gt_boxes, 0.0, 0.0)
    encoded = anchor_lib.encode_box_targets(matched_gt, anchor_boxes)
    box_targets = torch.where((matches >= 0)[..., None], encoded, torch.zeros_like(encoded))

    num_positives = torch.sum((matches != -1).to(torch.float32), dim=1)
    return cls_targets, box_targets, num_positives


def unpack_labels(flat: torch.Tensor, anchors: anchor_lib.Anchors) -> Dict[int, torch.Tensor]:
    """Flat per-anchor labels [B, N, ...] → per-level maps [B, H, W, A·k]."""
    out = {}
    a = anchors.get_anchors_per_location()
    for level, (start, end) in anchors.level_slices().items():
        fs = anchors.feat_sizes[level]
        out[level] = flat[:, start:end].reshape(flat.shape[0], fs["height"], fs["width"], -1)
        assert out[level].shape[-1] % a == 0
    return out


def label_anchors_multilevel(anchors: anchor_lib.Anchors, gt_boxes: torch.Tensor,
                             gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                             match_threshold: float = 0.5):
    """``label_anchors`` with the targets unpacked per level (dicts keyed by
    level) and the positives per image."""
    cls_t, box_t, num_pos = label_anchors(anchors.boxes(gt_boxes.device), gt_boxes,
                                          gt_classes, gt_valid, match_threshold)
    return unpack_labels(cls_t, anchors), unpack_labels(box_t, anchors), num_pos
