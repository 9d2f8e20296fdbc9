"""Validation: groundtruth-assigned predictions with all uncertainties.

Port of ``udal_tpu/apps/validate.py``. The validation set is served in
batches by the port's ``ServingDriver``, every groundtruth box is assigned
its best prediction (IoU or MSE, ``config.assign_gt_box``), the
calibrators are applied on the host, and four text artifacts are written:

* ``validate_results.txt``: one Python-dict line per groundtruth box with
  its prediction and raw and calibrated uncertainties, read back by
  ``read_validate_results``;
* ``model_performance.txt``: misclassification rate, mIoU, coordinate RMSE;
* ``average_score.txt``: the mean detection score;
* ``validationstep_runtime.txt``: each batch's serve time, then mean, std
  and median after IQR outlier rejection.

With ``infer_augment``, each batch is also served as variants made on
the driver's device from its uint8 pixels (``data.augment.AugmentVariants``):
``heq`` (Y equalised in YUV), ``alb`` (snow, fog, rain, noise), ``aug``
(noise, motion blur, contrast and brightness ladders of three severities
each) and ``flip`` (vertical, horizontal): 19 variant serves a batch with
all four, beside the plain serve; their rows carry ``<name>@<tag>``.

Beside ``validate_results.txt``, the aleatoric and MC box σ's calibration
against the residuals goes to ``aleatoric/`` and ``mcdropout/`` (with at
least 8 residuals): ``calibration.json``, the figure's numbers
(``utils.uncert_plots.regression_calibration_plot``), and ``metrics.txt``,
the ``repr`` of its miscalibration area, sharpness and RMSUE.
"""

from __future__ import annotations

import ast
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from udal_tpu_torch.apps.calibration import (CalibrateBoxUncert, CalibrateClass,
                                             gt_box_assigner, load_calibrators, relativize)
from udal_tpu_torch.apps.infer import split_serve_outputs
from udal_tpu_torch.apps.reader_batches import (groundtruth_from_labels, is_fast_batch,
                                                serve_reader_batch)
from udal_tpu_torch.data.augment import AugmentVariants
from udal_tpu_torch.data.dataloader import denormalize_image
from udal_tpu_torch.data.label_maps import get_ocl_trc
from udal_tpu_torch.utils.uncert_plots import regression_calibration_plot

AUGMENTS = ("heq", "alb", "aug", "flip")


class Validator:
    """Batched validation with uncertainty artifacts."""

    def __init__(self, driver, save_dir: str,
                 calib_dir: Optional[str] = None,
                 infer_augment: Optional[List[str]] = None,
                 dataset_root: Optional[str] = None,
                 preprocessed_batches: bool = True):
        self.driver = driver
        self.config = driver.config
        self.save_dir = save_dir
        # True: reader batches of any contract (``serve_reader_batch``);
        # False: raw pixels (``serve``)
        self.preprocessed_batches = preprocessed_batches
        # KITTI label_2 txt / BDD json occlusion and truncation; None -> -1
        self.dataset_root = dataset_root
        self._ocl_trc_cache = {}
        self.infer_augment = infer_augment or \
            (self.config.infer_augment if isinstance(
                self.config.infer_augment, (list, tuple)) else None)
        for mode in self.infer_augment or ():
            if mode not in AUGMENTS:
                raise ValueError(f"infer_augment mode {mode!r} is none of {AUGMENTS}")
        self.variants = AugmentVariants(driver.device)
        os.makedirs(save_dir, exist_ok=True)
        self.box_calib = self.cls_calib = None
        if calib_dir and os.path.isdir(calib_dir):
            reg, cls = load_calibrators(calib_dir)
            if reg:
                self.box_calib = CalibrateBoxUncert(reg, self.config.num_classes)
            if cls:
                self.cls_calib = CalibrateClass(cls, self.config.num_classes)
        self.runtimes: List[float] = []

    def run(self, batches: Iterable[Tuple[np.ndarray, Dict]]) -> List[Dict]:
        """batches: (images, labels) with names. Returns the per-GT rows and
        writes the four artifacts."""
        rows: List[Dict] = []
        all_scores: List[float] = []
        for images, labels in batches:
            scales = np.asarray(labels.get("image_scales", np.ones(images.shape[0])))
            fast = is_fast_batch(images)

            if self.preprocessed_batches:
                def _serve(im):
                    if fast and not isinstance(im, torch.Tensor):
                        im = np.clip(np.asarray(im), 0, 255).astype(np.uint8)
                    return serve_reader_batch(self.driver, im, labels)
            else:
                def _serve(im):
                    return self.driver.serve(im)

            gt_data = groundtruth_from_labels(labels)
            if self.infer_augment:
                # the variants are made on raw pixels: fast batches are raw
                # uint8, normalised batches are mapped back first
                if self.preprocessed_batches and not fast:
                    raw = denormalize_image(images, self.config.mean_rgb,
                                            self.config.stddev_rgb)
                else:
                    raw = np.clip(np.asarray(images), 0, 255).astype(np.uint8)
                names = labels.get("image_names", labels.get("source_ids", []))
                for aug_images, tag in self._augment_variants(raw):
                    if self.preprocessed_batches and not fast:
                        aug_images = self._normalize(aug_images)
                    out_a = split_serve_outputs(self.config, _serve(aug_images))
                    for i in range(images.shape[0]):
                        name = f"{names[i]}@{tag}" if len(names) > i else tag
                        rows.extend(self._process_image(out_a, i, gt_data[i], scales[i], name,
                                                        all_scores))
            t0 = time.perf_counter()
            out = split_serve_outputs(self.config, _serve(images))
            self.runtimes.append(time.perf_counter() - t0)
            names = labels.get("image_names",
                               labels.get("source_ids",
                                          [str(i) for i in range(images.shape[0])]))
            for i in range(images.shape[0]):
                rows.extend(self._process_image(out, i, gt_data[i], scales[i], names[i],
                                                all_scores))

        self._write_results(rows)
        self._write_performance(rows, all_scores)
        self._write_runtimes()
        return rows

    def _normalize(self, images: torch.Tensor) -> torch.Tensor:
        """``normalize_image`` of a uint8 batch on its device (f32, as numpy
        computes it)."""
        dev = images.device
        mean = torch.tensor(self.config.mean_rgb, dtype=torch.float32, device=dev)
        std = torch.tensor(self.config.stddev_rgb, dtype=torch.float32, device=dev)
        return (images.to(torch.float32) - mean) / std

    def _augment_variants(self, images: np.ndarray):
        """(augmented uint8 batch on the driver's device, tag) for each
        configured mode, in the JAX package's order: heq, the alb weathers,
        the aug ladders, the flips."""
        imgs = torch.as_tensor(np.asarray(images, np.uint8), device=self.driver.device)
        if "heq" in self.infer_augment:
            yield self.variants.heq(imgs), "histeq"
        if "alb" in self.infer_augment:
            for weather in ("snow", "fog", "rain", "noise"):
                yield self.variants.weather(imgs, weather), weather
        if "aug" in self.infer_augment:
            for kind in ("ns", "mb", "ct", "br"):
                for s, rung in enumerate(self.variants.corruption(imgs, kind)):
                    yield rung, f"{kind}{s}"
        if "flip" in self.infer_augment:
            yield torch.flip(imgs, [1]), "vflip"
            yield torch.flip(imgs, [2]), "hflip"

    def _process_image(self, out, i, gt_rows, scale, name, all_scores):
        n_val = int(out["valid_len"][i])
        if n_val == 0:
            return []
        boxes = out["boxes"][i][:n_val]
        scores = out["scores"][i][:n_val]
        classes = out["classes"][i][:n_val]
        valid_gt = gt_rows[gt_rows[:, 6] > 0]
        if len(valid_gt) == 0:
            return []
        # groundtruth in network-input pixels, predictions in the original frame
        gt_boxes = valid_gt[:, :4] * scale
        gt_classes = valid_gt[:, 6].astype(int)
        method = self.config.assign_gt_box or "IoU"
        idx, ious = gt_box_assigner(gt_boxes, boxes, method)
        keep = ious > 0

        sig_al = out.get("sigma_al")
        sig_mc = out.get("sigma_mc")
        sig_cls = out.get("sigma_cls")
        logits = out.get("logits")

        pred_boxes = boxes[idx]
        cal_boxes = {}
        if self.box_calib is not None and sig_al is not None:
            cal_boxes = self.box_calib(sig_al[i][:n_val][idx], gt_classes, pred_boxes)
        cal_cls = {}
        if self.cls_calib is not None and logits is not None:
            cal_cls = self.cls_calib(logits[i][:n_val][idx])

        rows = []
        for g in np.where(keep)[0]:
            d = idx[g]
            all_scores.append(float(scores[d]))
            occl, trunc = self._gt_ocl_trc(name, g)
            row = {
                "image_name": name,
                "score": float(scores[d]),
                "bbox": [float(x) for x in boxes[d]],
                "gt_bbox": [float(x) for x in gt_boxes[g]],
                "gt_occl": occl,
                "gt_trunc": trunc,
                "class": float(classes[d]),
                "gt_class": float(gt_classes[g]),
                "iou": float(ious[g]),
            }
            if logits is not None:
                row["logits"] = [float(x) for x in logits[i][d]]
                row["probab"] = [float(x) for x in out["probab"][i][d]]
                row["entropy"] = float(out["entropy"][i][d])
            if sig_al is not None:
                row["uncalib_albox"] = [float(x) for x in sig_al[i][d]]
                rel = relativize(boxes[d:d + 1], sig_al[i][d:d + 1])[0]
                row["rel_albox"] = [float(x) for x in rel]
            if sig_mc is not None:
                row["uncalib_mcbox"] = [float(x) for x in sig_mc[i][d]]
            if sig_cls is not None:
                row["uncalib_mcclass"] = [float(x) for x in sig_cls[i][d]]
            for k, v in cal_boxes.items():
                row[f"{k}_albox"] = [float(x) for x in v[g]]
            for k, v in cal_cls.items():
                row[f"{k}_entropy"] = float(v["entropy"][g])
            rows.append(row)
        return rows

    def _gt_ocl_trc(self, name, g):
        """Occlusion and truncation of groundtruth box g of this image (or
        -1, -1)."""
        if self.dataset_root is None:
            return -1, -1
        base = name.split("@")[0]
        if base not in self._ocl_trc_cache:
            occl, trcs = get_ocl_trc(self.dataset_root, [base])
            self._ocl_trc_cache[base] = (occl[0], trcs[0])
        occl, trcs = self._ocl_trc_cache[base]
        if g < len(occl):
            return float(occl[g]), float(trcs[g])
        return -1, -1

    # -- artifacts ---------------------------------------------------------------

    def _write_results(self, rows):
        with open(os.path.join(self.save_dir, "validate_results.txt"), "w") as f:
            for row in rows:
                f.write(repr(row) + "\n")
        self._write_uncert_plots(rows)

    def _write_uncert_plots(self, rows):
        for key, tag in (("uncalib_albox", "aleatoric"), ("uncalib_mcbox", "mcdropout")):
            res, sig = [], []
            for r in rows:
                if key not in r:
                    continue
                res.extend(np.asarray(r["gt_bbox"]) - np.asarray(r["bbox"]))
                sig.extend(r[key])
            if len(res) < 8:
                continue
            d = os.path.join(self.save_dir, tag)
            metrics = regression_calibration_plot(np.asarray(res), np.asarray(sig),
                                                  os.path.join(d, "calibration.png"), title=tag)
            with open(os.path.join(d, "metrics.txt"), "w") as f:
                f.write(repr(metrics) + "\n")

    def _write_performance(self, rows, all_scores):
        if rows:
            miscls = float(np.mean([r["class"] != r["gt_class"] for r in rows]))
            miou = float(np.mean([r["iou"] for r in rows]))
            rmse = float(np.sqrt(np.mean([
                np.mean((np.asarray(r["bbox"]) - np.asarray(r["gt_bbox"])) ** 2)
                for r in rows])))
        else:
            miscls = miou = rmse = float("nan")
        with open(os.path.join(self.save_dir, "model_performance.txt"), "w") as f:
            f.write(f"misclassification: {miscls}\n")
            f.write(f"mIoU: {miou}\n")
            f.write(f"RMSE: {rmse}\n")
        with open(os.path.join(self.save_dir, "average_score.txt"), "w") as f:
            f.write(str(float(np.mean(all_scores)) if all_scores else 0.0))

    def _write_runtimes(self):
        path = os.path.join(self.save_dir, "validationstep_runtime.txt")
        with open(path, "w") as f:
            for t in self.runtimes:
                f.write(f"{t}\n")
            if self.runtimes:
                r = np.asarray(self.runtimes)
                q1, q3 = np.percentile(r, [25, 75])
                iqr = q3 - q1
                keep = r[(r >= q1 - 1.5 * iqr) & (r <= q3 + 1.5 * iqr)]
                f.write(f"mean: {keep.mean()} std: {keep.std()} median: {np.median(keep)}\n")


def read_validate_results(path: str) -> List[Dict]:
    """The rows of a validate_results.txt."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and line.startswith("{"):
                rows.append(ast.literal_eval(line))
    return rows
