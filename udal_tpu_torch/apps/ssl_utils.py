"""SSL building blocks: class weighting, curricula, pseudo-label scoring,
label cleaning and fault injection (the TMLR 2025 SSL components).

Port of ``udal_tpu/apps/ssl_utils.py``:

* class-distribution image weights: per-class score 1/log(count), scaled to
  [lowest, highest]; per-image score = mean over the classes present;
* RCF curriculum: images sorted by class-weight score, split common/rare;
* PLS pseudo-label image scoring: d_i = (1 - beta) * s_i + beta * c_i;
  top / bottom / random splits;
* GLC groundtruth cleaning by consistency-filtered predictions (modes
  mistakes / md / noisy) and synthetic label-fault injection (missing
  detections, box noise, class mistakes);
* RCC rare-class collages (crops resized by cv2's INTER_LINEAR,
  ``ops.image_ops``), and the pseudo-label against groundtruth analysis
  (IoUs in f32, as the JAX package computes them).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from udal_tpu_torch.apps.calibration import iou_matrix_corners
from udal_tpu_torch.ops.boxes import pairwise_iou
from udal_tpu_torch.ops.image_ops import resize_bilinear_float, resize_bilinear_uint8


# ---------------------------------------------------------------------------
# Class-distribution weighting + RCF curriculum
# ---------------------------------------------------------------------------

def class_distribution_weights(class_counts: Dict[int, int],
                               lowest_weight: float = 1.0,
                               highest_weight: float = 10.0
                               ) -> Dict[int, float]:
    """Per-class weight 1/log(count) scaled to [lowest, highest].

    Classes with count <= 1 get the highest weight (log undefined) —
    parity `parent.py:1508-1527`.
    """
    classes = sorted(class_counts)
    counts = np.asarray([class_counts[c] for c in classes], np.float64)
    mask = counts > 1
    inv = 1.0 / np.log(counts[mask])
    if len(inv) and inv.max() > inv.min():
        scaled = lowest_weight + (inv - inv.min()) * \
            (highest_weight - lowest_weight) / (inv.max() - inv.min())
    else:
        scaled = np.full_like(inv, highest_weight)
    out: Dict[int, float] = {}
    j = 0
    for i, c in enumerate(classes):
        if mask[i]:
            out[c] = float(round(scaled[j], 5))
            j += 1
        else:
            out[c] = float(highest_weight)
    return out


def image_class_scores(per_image_classes: Sequence[Sequence[int]],
                       weights: Dict[int, float]) -> np.ndarray:
    """Mean class weight of the classes present in each image."""
    return np.asarray([np.mean([weights[c] for c in cls]) if len(cls) else 0.0
                       for cls in per_image_classes])


def rcf_curriculum_split(image_names: Sequence[str],
                         per_image_classes: Sequence[Sequence[int]],
                         weights: Dict[int, float],
                         rare_fraction: float = 0.5
                         ) -> Tuple[List[str], List[str]]:
    """(common, rare) split by per-image class-weight score —
    parity `parent.py:1454-1483`. The training loop zips common + rare
    (rare gets extra augmentation) per batch (`train_flags.py:358-459`)."""
    scores = image_class_scores(per_image_classes, weights)
    order = np.argsort(scores)
    n_rare = max(1, int(round(len(image_names) * rare_fraction)))
    common = [image_names[i] for i in order[:len(image_names) - n_rare]]
    rare = [image_names[i] for i in order[-n_rare:]]
    return common, rare


# ---------------------------------------------------------------------------
# PLS: pseudo-label image scoring
# ---------------------------------------------------------------------------

def pls_image_scores(per_image_det_scores: Sequence[Sequence[float]],
                     per_image_classes: Sequence[Sequence[int]],
                     weights: Dict[int, float],
                     beta: float = 0.5) -> np.ndarray:
    """d_i = (1 - beta) * s_i + beta * c_i — parity `pls.py:102-292`.

    s_i = mean detection score; c_i = normalized mean class weight.
    """
    s = np.asarray([np.mean(sc) if len(sc) else 0.0
                    for sc in per_image_det_scores])
    c = image_class_scores(per_image_classes, weights)
    if c.max() > c.min():
        c = (c - c.min()) / (c.max() - c.min())
    return (1.0 - beta) * s + beta * c


def pls_split(image_names: Sequence[str], scores: np.ndarray,
              portion: float, mode: str = "top",
              rng: Optional[np.random.RandomState] = None) -> List[str]:
    """Select a portion of the pool by PLS score: top / bottom / random."""
    n = max(1, int(round(len(image_names) * portion)))
    if mode == "random":
        rng = rng or np.random.RandomState(0)
        return list(rng.choice(image_names, n, replace=False))
    order = np.argsort(scores)
    picked = order[-n:] if mode == "top" else order[:n]
    return [image_names[i] for i in picked]


# ---------------------------------------------------------------------------
# GLC: GT cleaning via consistency-filtered predictions
# ---------------------------------------------------------------------------

def glc_clean_labels(gt_boxes: np.ndarray, gt_classes: np.ndarray,
                     pred_boxes: np.ndarray, pred_classes: np.ndarray,
                     pred_scores: np.ndarray, pred_consistency: np.ndarray,
                     mode: str = "md", iou_consist: float = 0.9,
                     md_max_inter: float = 0.0,
                     correct_score: float = 0.4
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Fix GT with consistent predictions — parity `glc.py:24-76`.

    modes:
      'md'       — add consistent, confident predictions that intersect no
                   GT (missing detections);
      'mistakes' — drop GT boxes matched by no consistent prediction;
      'noisy'    — replace matched GT coordinates with the prediction's.
    """
    consistent = (pred_consistency >= iou_consist) & \
        (pred_scores >= correct_score)
    pb, pc = pred_boxes[consistent], pred_classes[consistent]
    if mode == "md":
        if len(gt_boxes) and len(pb):
            inter = iou_matrix_corners(pb, gt_boxes).max(axis=1)
        else:
            inter = np.zeros(len(pb))
        add = inter <= md_max_inter
        return (np.concatenate([gt_boxes, pb[add]]) if len(pb) else gt_boxes,
                np.concatenate([gt_classes, pc[add]]) if len(pb) else gt_classes)
    if not len(gt_boxes):
        return gt_boxes, gt_classes
    if not len(pb):
        return (gt_boxes, gt_classes) if mode == "noisy" else \
            (gt_boxes[:0], gt_classes[:0])
    iou = iou_matrix_corners(gt_boxes, pb)
    best = iou.max(axis=1)
    best_idx = iou.argmax(axis=1)
    if mode == "mistakes":
        keep = best > 0
        return gt_boxes[keep], gt_classes[keep]
    if mode == "noisy":
        out = gt_boxes.copy()
        matched = best > 0.5
        out[matched] = pb[best_idx[matched]]
        return out, gt_classes
    raise ValueError(f"unknown glc mode {mode!r}")


# ---------------------------------------------------------------------------
# 3D ablation: synthetic label fault injection
# ---------------------------------------------------------------------------

def inject_label_faults(gt_boxes: np.ndarray, gt_classes: np.ndarray,
                        num_classes: int,
                        drop_fraction: float = 0.0,
                        box_noise_fraction: float = 0.0,
                        box_noise_scale: float = 0.1,
                        class_mistake_fraction: float = 0.0,
                        rng: Optional[np.random.RandomState] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic MD / box-noise / class-mistake injection —
    parity `3d.py:20-80` (pseudo-label robustness studies)."""
    rng = rng or np.random.RandomState(0)
    boxes = gt_boxes.copy().astype(np.float64)
    classes = gt_classes.copy()
    n = len(boxes)
    if n == 0:
        return boxes, classes
    keep = rng.rand(n) >= drop_fraction
    boxes, classes = boxes[keep], classes[keep]
    n = len(boxes)
    if n and box_noise_fraction > 0:
        noisy = rng.rand(n) < box_noise_fraction
        h = (boxes[:, 2] - boxes[:, 0])[:, None]
        w = (boxes[:, 3] - boxes[:, 1])[:, None]
        scale = np.concatenate([h, w, h, w], axis=1) * box_noise_scale
        boxes[noisy] += rng.randn(int(noisy.sum()), 4) * scale[noisy]
    if n and class_mistake_fraction > 0:
        flip = rng.rand(n) < class_mistake_fraction
        classes = classes.copy()
        classes[flip] = rng.randint(1, num_classes + 1, int(flip.sum()))
    return boxes, classes


# ---------------------------------------------------------------------------
# RCC: rare-class collage synthesis
# ---------------------------------------------------------------------------

def rcc_collage(background: np.ndarray,
                crops: Sequence[Tuple[np.ndarray, int]],
                rng: Optional[np.random.RandomState] = None,
                max_scale: float = 1.5, min_scale: float = 0.5
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paste rare-class crops onto a background at random scaled positions.

    Parity with the collage machinery (`parent.py:317-885`, `rcc.py:15`):
    returns (image, boxes, classes) for the synthesized sample.
    """
    rng = rng or np.random.RandomState(0)
    img = background.copy()
    H, W = img.shape[:2]
    boxes, classes = [], []
    for crop, cls in crops:
        s = rng.uniform(min_scale, max_scale)
        ch = max(4, min(int(crop.shape[0] * s), H - 1))
        cw = max(4, min(int(crop.shape[1] * s), W - 1))
        resize = resize_bilinear_uint8 if crop.dtype == np.uint8 else resize_bilinear_float
        crop_r = resize(crop, (ch, cw))
        y = rng.randint(0, H - ch)
        x = rng.randint(0, W - cw)
        img[y:y + ch, x:x + cw] = crop_r
        boxes.append([y, x, y + ch, x + cw])
        classes.append(cls)
    return img, np.asarray(boxes, np.float32), np.asarray(classes, np.int64)


# ---------------------------------------------------------------------------
# Pseudo-label vs ground-truth analysis (MD/FD per class)
# ---------------------------------------------------------------------------

def pseudo_vs_gt_analysis(gt_per_image: Sequence[Tuple[np.ndarray, np.ndarray]],
                          pseudo_per_image: Sequence[Tuple[np.ndarray,
                                                           np.ndarray]],
                          iou_thr: float = 0.5) -> Dict[str, object]:
    """Per-class pseudo-label quality: missing/false detections, mIoU, acc.

    The matched-detection analyses of the SSL study: pseudo boxes are
    greedily matched to GT by IoU; per class this reports
      md_rate  — GT without a matching pseudo box (missing detections),
      fd_rate  — pseudo boxes without a matching GT (false detections),
      miou     — mean IoU of matches,
      acc      — class agreement of matches,
    plus matched/GT/pseudo counts.

    Args:
      gt_per_image / pseudo_per_image: per image (boxes [N,4] y1x1y2x2,
        classes [N]) pairs.
    """
    stats: Dict[int, Dict[str, float]] = {}

    def bucket(c):
        return stats.setdefault(int(c), {
            "gt": 0, "pseudo": 0, "matched": 0, "md": 0, "fd": 0,
            "iou_sum": 0.0, "acc_sum": 0.0})

    for (g_boxes, g_cls), (p_boxes, p_cls) in zip(gt_per_image,
                                                  pseudo_per_image):
        g_boxes = np.asarray(g_boxes, float).reshape(-1, 4)
        p_boxes = np.asarray(p_boxes, float).reshape(-1, 4)
        g_cls = np.asarray(g_cls).astype(int)
        p_cls = np.asarray(p_cls).astype(int)
        for c in g_cls:
            bucket(c)["gt"] += 1
        for c in p_cls:
            bucket(c)["pseudo"] += 1
        if len(g_boxes) == 0 or len(p_boxes) == 0:
            for c in g_cls:
                bucket(c)["md"] += 1
            for c in p_cls:
                bucket(c)["fd"] += 1
            continue
        ious = pairwise_iou(torch.from_numpy(p_boxes.astype(np.float32)),
                            torch.from_numpy(g_boxes.astype(np.float32))).numpy()
        matched_gt, matched_p = set(), set()
        order = np.dstack(np.unravel_index(
            np.argsort(-ious, axis=None), ious.shape))[0]
        for (pi, gi) in order:
            if ious[pi, gi] < iou_thr:
                break
            if pi in matched_p or gi in matched_gt:
                continue
            matched_p.add(int(pi))
            matched_gt.add(int(gi))
            b = bucket(g_cls[gi])
            b["matched"] += 1
            b["iou_sum"] += float(ious[pi, gi])
            b["acc_sum"] += float(p_cls[pi] == g_cls[gi])
        for gi, c in enumerate(g_cls):
            if gi not in matched_gt:
                bucket(c)["md"] += 1
        for pi, c in enumerate(p_cls):
            if pi not in matched_p:
                bucket(c)["fd"] += 1

    out: Dict[str, object] = {"per_class": {}}
    total_md = total_fd = total_gt = total_p = 0
    for c, b in sorted(stats.items()):
        md_rate = b["md"] / b["gt"] if b["gt"] else float("nan")
        fd_rate = b["fd"] / b["pseudo"] if b["pseudo"] else float("nan")
        out["per_class"][c] = {
            "md_rate": md_rate, "fd_rate": fd_rate,
            "miou": b["iou_sum"] / b["matched"] if b["matched"] else
            float("nan"),
            "acc": b["acc_sum"] / b["matched"] if b["matched"] else
            float("nan"),
            "gt": b["gt"], "pseudo": b["pseudo"], "matched": b["matched"],
        }
        total_md += b["md"]
        total_fd += b["fd"]
        total_gt += b["gt"]
        total_p += b["pseudo"]
    out["md_rate"] = total_md / total_gt if total_gt else float("nan")
    out["fd_rate"] = total_fd / total_p if total_p else float("nan")
    return out


def augment_collage_crops(crops: Sequence[Tuple[np.ndarray, int]],
                          rng: Optional[np.random.RandomState] = None,
                          flip_prob: float = 0.5,
                          jitter: float = 0.2
                          ) -> List[Tuple[np.ndarray, int]]:
    """Per-crop augmentation for collage synthesis — flips + photometric
    jitter (`parent.py:317-885` collage scaling/augmentation)."""
    rng = rng or np.random.RandomState(0)
    out = []
    for crop, cls in crops:
        c = crop
        if rng.rand() < flip_prob:
            c = c[:, ::-1]
        gain = 1.0 + rng.uniform(-jitter, jitter)
        bias = rng.uniform(-jitter, jitter) * 64
        c = np.clip(c.astype(np.float32) * gain + bias, 0,
                    255).astype(np.uint8)
        out.append((c, cls))
    return out
