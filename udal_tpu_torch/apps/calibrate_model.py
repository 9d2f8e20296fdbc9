"""Calibration driver: gather groundtruth-assigned detections, fit and save
all calibrators.

Port of ``udal_tpu/apps/calibrate_model.py``: serve every validation batch
(any reader contract) with the port's ``ServingDriver``, assign each
groundtruth box its best prediction by IoU or MSE, keep the pairs with IoU
> 0, fit the regression and classification calibrators (the temperature
fits on the driver's device) and save them with
``calibration.save_calibrators`` (``.npz`` files under
``<out_dir>/{regression,classification}/``). The JAX package's reliability
diagrams (raw softmax and temperature-scaled) and the aleatoric σ's
regression calibration plot are written as their numbers:
``plots/reliability_raw.json``, ``plots/reliability_ts.json`` and
``plots/regression_reliability.json`` (``utils.uncert_plots``).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Tuple

import numpy as np

from udal_tpu_torch.apps.calibration import (ClassificationCalib, RegressionCalib,
                                             gt_box_assigner, save_calibrators, stable_softmax)
from udal_tpu_torch.apps.infer import split_serve_outputs
from udal_tpu_torch.apps.reader_batches import groundtruth_from_labels, serve_reader_batch
from udal_tpu_torch.utils.uncert_plots import regression_calibration_plot, reliability_diagram


class Calibrate:
    """Gather detections and fit all calibrators."""

    def __init__(self, driver, out_dir: str, val_split: float = 0.8):
        self.driver = driver
        self.config = driver.config
        self.out_dir = out_dir
        self.val_split = val_split

    def gather_detections(self, batches: Iterable[Tuple[np.ndarray, Dict]]
                          ) -> Dict[str, np.ndarray]:
        """Serve the batches and assign each groundtruth box its best
        prediction. Returns flat arrays over the matched (GT, prediction)
        pairs: gt_boxes, pred_boxes, sigma_al, sigma_cls, logits,
        gt_classes, pred_classes, scores, ious (empty where the serve has
        no such output)."""
        acc: Dict[str, List] = {k: [] for k in
                                ("gt_boxes", "pred_boxes", "sigma_al", "sigma_cls", "logits",
                                 "gt_classes", "pred_classes", "scores", "ious")}
        method = self.config.assign_gt_box or "IoU"
        for images, labels in batches:
            scales = np.asarray(labels.get("image_scales", np.ones(images.shape[0])))
            out = split_serve_outputs(self.config,
                                      serve_reader_batch(self.driver, images, labels))
            gt_data = groundtruth_from_labels(labels)
            for i in range(images.shape[0]):
                n_val = int(out["valid_len"][i])
                valid_gt = gt_data[i][gt_data[i][:, 6] > 0]
                if n_val == 0 or len(valid_gt) == 0:
                    continue
                boxes = out["boxes"][i][:n_val]
                gt_boxes = valid_gt[:, :4] * scales[i]
                idx, ious = gt_box_assigner(gt_boxes, boxes, method)
                keep = ious > 0
                if not np.any(keep):
                    continue
                sel = idx[keep]
                acc["gt_boxes"].append(gt_boxes[keep])
                acc["pred_boxes"].append(boxes[sel])
                acc["gt_classes"].append(valid_gt[keep, 6].astype(int))
                acc["pred_classes"].append(out["classes"][i][sel])
                acc["scores"].append(out["scores"][i][sel])
                acc["ious"].append(ious[keep])
                for key, src in (("sigma_al", "sigma_al"), ("sigma_cls", "sigma_cls"),
                                 ("logits", "logits")):
                    if src in out:
                        acc[key].append(out[src][i][sel])
        return {k: (np.concatenate(v) if v else np.zeros((0,))) for k, v in acc.items()}

    def run(self, batches: Iterable[Tuple[np.ndarray, Dict]]) -> Tuple[Dict, Dict]:
        """Gather, fit (with at least 8 pairs) and save; returns
        (regression, classification) calibrators."""
        data = self.gather_detections(batches)
        num_classes = self.config.num_classes
        device = self.driver.device
        regression: Dict = {}
        classification: Dict = {}
        if len(data["gt_boxes"]) >= 8:
            if data["sigma_al"].size:
                regression = RegressionCalib(data["gt_boxes"], data["pred_boxes"],
                                             data["sigma_al"], data["gt_classes"], num_classes,
                                             self.val_split, device=device).fit_all()
            if data["logits"].size:
                sigma_cls = data["sigma_cls"] if data["sigma_cls"].size else None
                # the per-class logit σ only when it is as wide as the logits
                if sigma_cls is not None and sigma_cls.shape[-1] != data["logits"].shape[-1]:
                    sigma_cls = None
                classification = ClassificationCalib(data["gt_classes"], data["logits"],
                                                     sigma_cls, num_classes,
                                                     device=device).fit_all()
                self.reliability_diagrams(data, classification)
            if data["sigma_al"].size:
                self.regression_plots(data)
        save_calibrators(self.out_dir, regression, classification)
        return regression, classification

    def reliability_diagrams(self, data, classification) -> Dict[str, Dict[str, float]]:
        """ECE / MCE / ACE of the raw softmax and, with a fitted ``ts_all``,
        of the temperature-scaled one; their numbers under ``plots/``."""
        logits = np.asarray(data["logits"])
        y = np.asarray(data["gt_classes"]).astype(int)
        plots = os.path.join(self.out_dir, "plots")
        probs = stable_softmax(logits)
        out = {"raw": reliability_diagram((probs.argmax(-1) + 1 == y).astype(float),
                                          probs.max(-1),
                                          os.path.join(plots, "reliability_raw.png"),
                                          title="raw softmax")}
        t = classification.get("ts_all")
        if t is not None:
            probs_t = stable_softmax(logits / np.asarray(t))
            out["ts"] = reliability_diagram((probs_t.argmax(-1) + 1 == y).astype(float),
                                            probs_t.max(-1),
                                            os.path.join(plots, "reliability_ts.png"),
                                            title="temperature scaled")
        return out

    def regression_plots(self, data) -> Dict[str, float]:
        """Calibration of the aleatoric box σ against the gathered
        residuals; its numbers under ``plots/``."""
        res = np.asarray(data["gt_boxes"]) - np.asarray(data["pred_boxes"])
        return regression_calibration_plot(
            res.ravel(), np.asarray(data["sigma_al"]).ravel(),
            os.path.join(self.out_dir, "plots", "regression_reliability.png"),
            title="aleatoric box sigma")
