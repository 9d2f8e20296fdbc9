"""COCO-style detection evaluation in numpy.

The port's copy of ``udal_tpu/eval/coco.py``: the reference's COCOeval
semantics (detections matched to groundtruth greedily in score order, each
groundtruth used once, crowd regions matched without limit, 101-point
interpolated precision) and its fine IoU grid 0.05:0.05:0.95 for the
AP-vs-IoU curve. Feed ``update_state(groundtruth_data [B, M, 7],
detections [B, K, 7])`` a batch at a time, then read ``result()``: the 12
COCO numbers, the AP of each class (and AP@IoU with ``fine_grid``).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRS_COCO = np.round(np.arange(0.5, 1.0, 0.05), 2)          # 10 values
IOU_THRS_ALL = np.round(np.arange(0.05, 1.0, 0.05), 2)          # 19 values
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray
              ) -> np.ndarray:
    """IoU matrix [D, G]; crowd GT uses IoA (intersection / det area)."""
    d_area = dets[:, 2] * dets[:, 3]
    g_area = gts[:, 2] * gts[:, 3]
    x1 = np.maximum(dets[:, None, 0], gts[None, :, 0])
    y1 = np.maximum(dets[:, None, 1], gts[None, :, 1])
    x2 = np.minimum(dets[:, None, 0] + dets[:, None, 2],
                    gts[None, :, 0] + gts[None, :, 2])
    y2 = np.minimum(dets[:, None, 1] + dets[:, None, 3],
                    gts[None, :, 1] + gts[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    union = d_area[:, None] + g_area[None, :] - inter
    union = np.where(iscrowd[None, :], d_area[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


def _evaluate_image(dets: np.ndarray, det_scores: np.ndarray,
                    gts: np.ndarray, gt_crowd: np.ndarray,
                    iou_thrs: np.ndarray, area_rng: Tuple[float, float],
                    max_det: int):
    """Greedy matching for one (image, category) — COCOeval semantics.

    dets: [D, 4] xywh sorted by score desc (pre-truncated to max_det).
    Returns (det_matched [T, D] bool, det_ignore [T, D] bool,
             num_valid_gt int).
    """
    g_area = gts[:, 2] * gts[:, 3]
    gt_ignore = gt_crowd | (g_area < area_rng[0]) | (g_area > area_rng[1])
    # sort GT: valid first (COCO sorts by ignore flag)
    g_order = np.argsort(gt_ignore, kind="stable")
    gts = gts[g_order]
    gt_ignore = gt_ignore[g_order]
    gt_crowd_s = gt_crowd[g_order]

    D = len(dets)
    G = len(gts)
    T = len(iou_thrs)
    det_m = np.zeros((T, D), bool)
    det_ig = np.zeros((T, D), bool)
    if G:
        ious = _iou_xywh(dets, gts, gt_crowd_s)
        for ti, thr in enumerate(iou_thrs):
            gt_used = np.zeros(G, bool)
            for di in range(D):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(G):
                    if gt_used[gi] and not gt_crowd_s[gi]:
                        continue
                    # stop at ignored GT if a valid match was already found
                    if best_g > -1 and not gt_ignore[best_g] and gt_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g >= 0:
                    gt_used[best_g] = True
                    det_m[ti, di] = True
                    det_ig[ti, di] = gt_ignore[best_g]
    # unmatched dets outside the area range are ignored
    d_area = dets[:, 2] * dets[:, 3]
    out_of_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
    det_ig |= (~det_m) & out_of_rng[None, :]
    return det_m, det_ig, int(np.sum(~gt_ignore))


class COCOEvaluator:
    """Streaming COCO-AP evaluator over detection batches.

    API parity with the reference EvaluationMetric (`coco_metric.py:59-330`):
    `update_state(groundtruth_data, detections)` per batch, then `result()`.
    detections rows: [image_id, x, y, w, h, score, class];
    groundtruth rows: [y1, x1, y2, x2, is_crowd, area, class] (padded with
    class <= 0).
    """

    def __init__(self, label_map: Optional[Dict[int, str]] = None,
                 iou_thrs: np.ndarray = IOU_THRS_COCO,
                 fine_grid: bool = False):
        self.label_map = label_map
        self.iou_thrs = IOU_THRS_ALL if fine_grid else iou_thrs
        # per (image, class): lists of dets/gts
        self._dets: Dict[Tuple[int, int], List] = collections.defaultdict(list)
        self._gts: Dict[Tuple[int, int], List] = collections.defaultdict(list)
        self._images: set = set()
        self._classes: set = set()

    def update_state(self, groundtruth_data: np.ndarray,
                     detections: np.ndarray) -> None:
        """Add a batch: groundtruth [B, M, 7], detections [B, K, 7]."""
        groundtruth_data = np.asarray(groundtruth_data)
        detections = np.asarray(detections)
        for b in range(detections.shape[0]):
            img_id = int(detections[b, 0, 0])
            self._images.add(img_id)
            for row in detections[b]:
                score, cls = float(row[5]), int(row[6])
                if cls <= 0 or score <= 0:
                    continue
                self._classes.add(cls)
                self._dets[(img_id, cls)].append(
                    (row[1], row[2], row[3], row[4], score))
            for row in groundtruth_data[b]:
                cls = int(row[6])
                if cls <= 0:
                    continue
                self._classes.add(cls)
                y1, x1, y2, x2 = row[:4]
                self._gts[(img_id, cls)].append(
                    (x1, y1, x2 - x1, y2 - y1, bool(row[4])))

    def _accumulate(self, max_det: int = 100,
                    area_name: str = "all"
                    ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """Precision [T, R, K] and recall [T, K] arrays."""
        area_rng = AREA_RANGES[area_name]
        classes = sorted(self._classes)
        T = len(self.iou_thrs)
        K = len(classes)
        precision = -np.ones((T, len(RECALL_THRS), K))
        recall = -np.ones((T, K))
        for ki, cls in enumerate(classes):
            scores_all, matched_all, ignored_all = [], [], []
            npig = 0
            for img in self._images:
                dets = self._dets.get((img, cls), [])
                gts = self._gts.get((img, cls), [])
                if not dets and not gts:
                    continue
                d = np.asarray(dets, np.float64).reshape(-1, 5)
                order = np.argsort(-d[:, 4], kind="mergesort")[:max_det]
                d = d[order]
                g = np.asarray([r[:4] for r in gts], np.float64).reshape(-1, 4)
                crowd = np.asarray([r[4] for r in gts], bool)
                dm, dig, nvalid = _evaluate_image(
                    d[:, :4], d[:, 4], g, crowd, self.iou_thrs, area_rng,
                    max_det)
                npig += nvalid
                scores_all.append(d[:, 4])
                matched_all.append(dm)
                ignored_all.append(dig)
            if npig == 0:
                continue
            if scores_all:
                scores = np.concatenate(scores_all)
                order = np.argsort(-scores, kind="mergesort")
                dm = np.concatenate(matched_all, axis=1)[:, order]
                dig = np.concatenate(ignored_all, axis=1)[:, order]
                tps = dm & ~dig
                fps = ~dm & ~dig
                tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                for ti in range(T):
                    tp, fp = tp_cum[ti], fp_cum[ti]
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                    recall[ti, ki] = rc[-1] if len(rc) else 0.0
                    # precision envelope (monotone decreasing)
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, RECALL_THRS, side="left")
                    q = np.zeros(len(RECALL_THRS))
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[ti, :, ki] = q
            else:
                recall[:, ki] = 0.0
                precision[:, :, ki] = 0.0
        return precision, recall, classes

    @staticmethod
    def _mean(x: np.ndarray) -> float:
        valid = x[x > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def result(self) -> Dict[str, float]:
        """COCO summary + per-class AP (+AP-vs-IoU when fine_grid)."""
        p_all, r_all, classes = self._accumulate(100, "all")
        out = {}
        thrs = self.iou_thrs

        def ap_at(thr):
            ti = int(np.argmin(np.abs(thrs - thr)))
            return self._mean(p_all[ti])

        out["AP"] = self._mean(p_all[np.isin(thrs, IOU_THRS_COCO)]) \
            if len(thrs) > 10 else self._mean(p_all)
        out["AP50"] = ap_at(0.5)
        out["AP75"] = ap_at(0.75)
        for area in ("small", "medium", "large"):
            p, _, _ = self._accumulate(100, area)
            out[f"AP{area[0]}"] = self._mean(
                p[np.isin(thrs, IOU_THRS_COCO)] if len(thrs) > 10 else p)
        for md in (1, 10, 100):
            _, r, _ = self._accumulate(md, "all")
            out[f"ARmax{md}"] = self._mean(
                r[np.isin(thrs, IOU_THRS_COCO)] if len(thrs) > 10 else r)
        for area in ("small", "medium", "large"):
            _, r, _ = self._accumulate(100, area)
            out[f"AR{area[0]}"] = self._mean(
                r[np.isin(thrs, IOU_THRS_COCO)] if len(thrs) > 10 else r)

        coco_mask = np.isin(thrs, IOU_THRS_COCO) if len(thrs) > 10 else \
            np.ones(len(thrs), bool)
        for ki, cls in enumerate(classes):
            name = (self.label_map or {}).get(cls, str(cls))
            out[f"AP_/{name}"] = self._mean(p_all[coco_mask][:, :, ki])
        if len(thrs) > 10:
            for ti, thr in enumerate(thrs):
                out[f"AP@{thr:.2f}"] = self._mean(p_all[ti])
        return out
