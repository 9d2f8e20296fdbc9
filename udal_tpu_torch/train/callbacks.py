"""The per-epoch COCO evaluation callback.

Port of ``udal_tpu/train/callbacks.py``'s ``COCOCallback``: every
``map_freq`` epochs the validation stream is served through the full
post-processing (MC dropout when the config asks for it, then the global
soft-NMS), the COCO numbers go to the metrics writer, and the AP-vs-IoU
curve (the 0.05 grid), the class confusion matrix (IoU >= 0.5 matches)
and the detection-correctness ROC with its AUC (the port's own
``roc_curve`` / ``auc``) are written as numbers, one JSON file a panel
under ``<log_dir>/panels/<tag>_epoch<e>.json``.

The JAX callback draws those three panels with matplotlib, which the
machine with the card does not have. Its fourth panel, the grid of
detections over (NMS IoU, score) thresholds on the first validation
image, is drawn (``utils.visualize``, labels without their text) and
written as ``panels/nms_grid_epoch<e>.png``.

The serve is a ``ServingDriver`` over the train state's live weights on
the state's device (bf16 on a card, as ``cli eval`` serves), so on a card
each validation batch launches the soft-NMS, fused depthwise and fused
expand + depthwise kernels 1, 1 and 15 times; the grid adds one forward
of the probe image (1 fused depthwise, 15 fused expand + depthwise) and
one post-processing a cell (9 soft-NMS).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from udal_tpu_torch.apps.reader_batches import groundtruth_from_labels, serve_reader_batch
from udal_tpu_torch.apps.serving import ServingDriver
from udal_tpu_torch.apps.thresholding import auc, roc_curve
from udal_tpu_torch.data.image_codec import write_png
from udal_tpu_torch.eval.coco import COCOEvaluator
from udal_tpu_torch.ops.boxes import pairwise_iou
from udal_tpu_torch.ops.postprocess import postprocess_global
from udal_tpu_torch.utils.visualize import visualize_boxes_and_labels

NMS_GRID_IOUS = (0.3, 0.5, 0.7)
NMS_GRID_SCORES = (0.1, 0.3, 0.5)


def detection_rows(det, first_id: int) -> np.ndarray:
    """[B, K, 7] COCO rows [image id, x, y, w, h, score, class] of
    structured detections, the images numbered from ``first_id``."""
    boxes = det.boxes.float().cpu().numpy()
    scores = det.scores.float().cpu().numpy()
    classes = det.classes.float().cpu().numpy()
    ids = np.arange(first_id, first_id + boxes.shape[0])
    y1, x1, y2, x2 = [boxes[..., i] for i in range(4)]
    return np.stack([np.repeat(ids[:, None], boxes.shape[1], 1),
                     x1, y1, x2 - x1, y2 - y1, scores, classes], axis=-1)


def scaled_groundtruth(labels: Dict) -> np.ndarray:
    """The batch's groundtruth rows with boxes in the original image's
    frame (times ``image_scales``), where the served detections are."""
    gt = groundtruth_from_labels(labels).astype(np.float32).copy()
    gt[..., :4] *= np.asarray(labels["image_scales"], np.float32)[:, None, None]
    return gt


class COCOCallback:
    """Epoch-end COCO evaluation over a validation stream.

    Args:
      config: detection Config.
      val_iter_fn: () -> iterator of (images, labels) reader batches (any
        of the reader's three contracts).
      val_steps: batches an evaluation.
      log_dir: where ``panels/`` goes.
      label_map: {id: name} for the per-class AP keys and the panels.
    """

    def __init__(self, config, val_iter_fn: Callable[[], Iterator], val_steps: int,
                 log_dir: str, label_map: Optional[Dict[int, str]] = None):
        self.config = config
        self.val_iter_fn = val_iter_fn
        self.val_steps = val_steps
        self.log_dir = log_dir
        self.label_map = label_map or {}
        os.makedirs(os.path.join(log_dir, "panels"), exist_ok=True)

    def driver(self, state) -> ServingDriver:
        """A serving driver over the state's live (not EMA) weights, on
        the state's device."""
        device = next(state.model.parameters()).device
        return ServingDriver(self.config, state.model.state_dict(), device=device)

    def evaluate(self, driver: ServingDriver) -> Tuple[Dict[str, float], np.ndarray,
                                                       np.ndarray, Tuple]:
        """Serve ``val_steps`` validation batches through ``driver``:
        (the COCO numbers on the 0.05 grid, the confusion matrix, the
        (score, hit) pairs, the first batch)."""
        evaluator = COCOEvaluator(label_map=self.label_map, fine_grid=True)
        num_classes = int(self.config.num_classes)
        cm = np.zeros((num_classes + 1, num_classes + 1), np.int64)
        pairs: List[Tuple[float, float]] = []
        it = self.val_iter_fn()
        img_id = 0
        first_batch = None
        for _ in range(self.val_steps):
            images, labels = next(it)
            if first_batch is None:
                first_batch = (images, labels)
            det = serve_reader_batch(driver, images, labels, structured=True)
            rows = detection_rows(det, img_id)
            img_id += rows.shape[0]
            gt = scaled_groundtruth(labels)
            evaluator.update_state(gt, rows)
            self._update_confusion(cm, det.boxes.float().cpu(), rows[..., 5], rows[..., 6],
                                   gt, pairs)
        return (evaluator.result(), cm, np.asarray(pairs, np.float64).reshape(-1, 2),
                first_batch)

    def nms_grid(self, driver: ServingDriver, batch) -> np.ndarray:
        """The first image of ``batch`` at the network's size, drawn once a
        cell of (NMS IoU, score) thresholds (rows by IoU, columns by
        score) with the detections of one forward pass (one dropout draw
        with MC dropout) post-processed at that cell's thresholds, boxes
        in the network's frame."""
        images, labels = batch
        cfg = self.config
        with torch.inference_mode():
            if images.dtype in (np.uint8, torch.uint8):
                def first(key):
                    v = labels.get(key)
                    return None if v is None else v[:1]
                x, _ = driver._dispatch_uint8(images[:1], first("valid_hw"), None,
                                              first("warp_scale"), first("warp_offset"))
            else:
                x = torch.as_tensor(images[:1], device=driver.device)
            outs = driver.model(x.to(driver.dtype), driver.masks if cfg.mc_dropout else None)
            mean = np.asarray(cfg.mean_rgb, np.float32)
            std = np.asarray(cfg.stddev_rgb, np.float32)
            disp = np.clip(x[0].float().cpu().numpy() * std + mean, 0, 255).astype(np.uint8)
            base = (cfg.nms_configs.get("iou_thresh"), cfg.nms_configs.get("score_thresh"))
            rows = []
            try:
                for iou_t in NMS_GRID_IOUS:
                    cols = []
                    for score_t in NMS_GRID_SCORES:
                        cfg.nms_configs["iou_thresh"] = iou_t
                        cfg.nms_configs["score_thresh"] = score_t
                        det = postprocess_global(cfg, outs[0], outs[1])
                        scores = det.scores[0].float().cpu().numpy()
                        keep = scores > score_t
                        cols.append(visualize_boxes_and_labels(
                            disp.copy(), det.boxes[0].float().cpu().numpy()[keep],
                            det.classes[0].float().cpu().numpy()[keep].astype(int),
                            scores[keep], label_map=self.label_map))
                    rows.append(np.concatenate(cols, axis=1))
            finally:
                cfg.nms_configs["iou_thresh"], cfg.nms_configs["score_thresh"] = base
        return np.concatenate(rows, axis=0)

    @staticmethod
    def _update_confusion(cm, boxes: torch.Tensor, scores, classes, gt, pairs,
                          iou_thr=0.5, score_thr=0.3):
        """Greedy matches in score order: a match adds to cm[gt class,
        detected class], a missed groundtruth to cm[class, 0], a detection
        of an image without groundtruth to cm[0, class]; each detection
        adds (score, 1 if it hit a groundtruth of its class else 0) to
        ``pairs``."""
        for b in range(boxes.shape[0]):
            keep = scores[b] > score_thr
            g = gt[b]
            g = g[g[:, -1] > 0]
            db = boxes[b][torch.from_numpy(keep)]
            dc = classes[b][keep].astype(int)
            ds = scores[b][keep]
            matched_gt = set()
            if len(g) and len(db):
                ious = pairwise_iou(db, torch.from_numpy(g[:, :4])).numpy()
                for di in np.argsort(-ds):
                    gi = int(np.argmax(ious[di]))
                    hit = ious[di, gi] >= iou_thr and gi not in matched_gt
                    if hit:
                        matched_gt.add(gi)
                        cm[int(g[gi, -1]) % cm.shape[0], dc[di] % cm.shape[0]] += 1
                    pairs.append((ds[di], float(hit and dc[di] == int(g[gi, -1]))))
                for gi in range(len(g)):
                    if gi not in matched_gt:
                        cm[int(g[gi, -1]) % cm.shape[0], 0] += 1        # missed
            else:
                for di in range(len(db)):
                    cm[0, dc[di] % cm.shape[0]] += 1                    # spurious
                    pairs.append((ds[di], 0.0))

    def panels(self, results: Dict[str, float], cm: np.ndarray, pairs: np.ndarray) -> Dict:
        """The panels' numbers: AP at each IoU of the grid, the confusion
        matrix with its class names, the ROC (None with one outcome only)."""
        names = ["bg/miss"] + [self.label_map.get(i, str(i)) for i in range(1, cm.shape[0])]
        ap_vs_iou = sorted((float(k.split("@")[1]), v) for k, v in results.items()
                           if k.startswith("AP@"))
        roc = None
        if len(pairs) and len(np.unique(pairs[:, 1])) >= 2:
            fpr, tpr, thr = roc_curve(pairs[:, 1], pairs[:, 0])
            roc = {"fpr": fpr.tolist(), "tpr": tpr.tolist(),
                   "thresholds": [float(t) if np.isfinite(t) else None for t in thr],
                   "auc": float(auc(fpr, tpr))}
        return {"ap_vs_iou": [list(p) for p in ap_vs_iou] or None,
                "confusion_matrix": {"names": names, "matrix": cm.tolist()},
                "roc": roc}

    def __call__(self, epoch: int, state, writer=None) -> float:
        """Evaluate ``state``; write the panels and, with ``writer``, the
        COCO numbers (the per-class APs left out) and the ROC's AUC.
        Returns the AP."""
        driver = self.driver(state)
        results, cm, pairs, first_batch = self.evaluate(driver)
        grid = self.nms_grid(driver, first_batch)
        write_png(os.path.join(self.log_dir, "panels", f"nms_grid_epoch{epoch}.png"), grid)
        panels = self.panels(results, cm, pairs)
        for tag, payload in panels.items():
            if payload is None:
                continue
            with open(os.path.join(self.log_dir, "panels", f"{tag}_epoch{epoch}.json"),
                      "w") as f:
                json.dump(payload, f)
        if writer is not None:
            writer.write_image(epoch, "nms_grid", grid)
            metrics = {k: v for k, v in results.items() if not k.startswith("AP_/")}
            if panels["roc"] is not None:
                metrics["roc_auc"] = panels["roc"]["auc"]
            writer.write(epoch, metrics)
        return float(results["AP"])
