"""Batched inference with uncertainty extraction, calibration and auto-labeling.

Port of ``udal_tpu/apps/infer.py``. The pool is served in batches by the
port's ``ServingDriver`` (on the card, through its kernels); each batch's
packed detections come to the host in one copy, where calibration and the
artifacts run in numpy:

* ``prediction_data.txt``: one Python-dict line per detection (image name,
  score, box, class, entropy and logits, raw and calibrated uncertainties),
  read back by ``read_prediction_data`` (``ast.literal_eval``);
* the auto-label gate: an image whose detections all have a weighted
  combined uncertainty under the mean of the optimal thresholds goes to
  ``labeled/`` (with KITTI-format pseudo-labels, ``<stem>.txt``), else to
  ``examine/``; each with an ``images.txt`` of its names;
* the top/bottom uncertainty buckets' ``images.txt`` (combined, and per
  kind under ``uncert/``);
* with ``save_visualizations``: each image's detection overlay and one
  panel per decoded uncertainty (``visualizations/<stem>{,_mean_albox,
  _mean_epbox,_max_epcls,_entropy}.png``, drawn by ``utils.visualize``),
  and in each per-kind bucket a copy of its images' overlays and their
  captioned ``contact_sheet.png``. The overlays are drawn
  on the batch's own pixels: native uint8 frames as they are, resized or
  normalised ones (mapped back to uint8) with the boxes divided by the
  image's scale.
"""

from __future__ import annotations

import ast
import os
import shutil
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from udal_tpu_torch.apps.calibration import (CalibrateBoxUncert, CalibrateClass,
                                             iou_matrix_corners, load_calibrators, relativize)
from udal_tpu_torch.apps.reader_batches import (is_fast_batch, raw_pixels_from_batch,
                                                serve_reader_batch)
from udal_tpu_torch.apps.thresholding import read_optimal_thresholds
from udal_tpu_torch.data.dataloader import denormalize_image
from udal_tpu_torch.data.image_codec import decode_image, write_png
from udal_tpu_torch.data.label_maps import get_label_map
from udal_tpu_torch.ops.image_ops import gaussian_blur_uint8
from udal_tpu_torch.utils.visualize import contact_sheet, overlay_panels


def _outputs_to_host(outputs) -> List[np.ndarray]:
    """The packed tuple's tensors as numpy arrays, in one device-to-host
    copy (one synchronisation): each flattened per image to f32 and
    concatenated, then split back (valid_len returns to int64; f32 holds
    its values exactly)."""
    ts = [torch.as_tensor(t) for t in outputs]
    b = ts[0].shape[0]
    flat = torch.cat([t.reshape(b, -1).to(torch.float32) for t in ts], dim=1).cpu().numpy()
    out, col = [], 0
    for t in ts:
        n = t[0].numel()
        a = flat[:, col:col + n].reshape(tuple(t.shape))
        if not t.is_floating_point():
            a = a.astype(np.int64)
        out.append(a)
        col += n
    return out


def split_serve_outputs(config, outputs) -> Dict[str, np.ndarray]:
    """Unpack the packed serving tuple (tensors or arrays) into named numpy
    arrays: boxes[..., 4:8] the aleatoric σ, [..., 8:12] the MC box σ,
    classes[..., 1:] the per-class logit σ, the logits' softmax and
    entropy. Which σ columns are there is read from the packed widths (an
    ensemble packs MC columns with ``mc_dropout`` off)."""
    has_logits = bool(config.enable_softmax)
    host = _outputs_to_host(outputs)
    if has_logits:
        boxes, scores, classes, valid, logits = host
    else:
        boxes, scores, classes, valid = host
        logits = None
    out: Dict[str, np.ndarray] = {"scores": scores, "valid_len": valid}
    la = bool(config.loss_attenuation)
    mc_box = boxes.shape[-1] >= 4 + 4 * la + 4
    mc_cls = classes.ndim == 3 and classes.shape[-1] > 1
    col = 4
    out["boxes"] = boxes[..., :4]
    if la:
        out["sigma_al"] = boxes[..., col:col + 4]
        col += 4
    if mc_box:
        out["sigma_mc"] = boxes[..., col:col + 4]
    if mc_cls:
        out["classes"] = classes[..., 0]
        out["sigma_cls"] = classes[..., 1:]
    else:
        out["classes"] = classes if classes.ndim == 2 else classes[..., 0]
    if logits is not None:
        out["logits"] = logits
        z = logits - logits.max(-1, keepdims=True)
        p = np.exp(z)
        p = p / p.sum(-1, keepdims=True)
        out["probab"] = p
        out["entropy"] = -np.sum(p * np.log(np.clip(p, 1e-12, 1)), -1)
    return out


class InferImages:
    """Pool inference with uncertainty artifacts and auto-labeling."""

    def __init__(self, driver, save_dir: str,
                 calib_dir: Optional[str] = None,
                 auto_labeling: bool = False,
                 opt_params: Optional[Sequence[float]] = None,
                 opt_thrs_path: Optional[str] = None,
                 min_score: float = 0.0,
                 save_visualizations: bool = False,
                 bucket_fraction: float = 0.1):
        self.driver = driver
        self.config = driver.config
        self.save_dir = save_dir
        self.min_score = min_score
        self.auto_labeling = auto_labeling
        self.save_visualizations = save_visualizations
        self.bucket_fraction = bucket_fraction
        self._image_uncert: List[Tuple[str, float]] = []
        self._image_uncert_kind: Dict[str, List[Tuple[str, float]]] = {}
        self._overlay_paths: Dict[str, str] = {}
        os.makedirs(save_dir, exist_ok=True)
        self.box_calib = self.cls_calib = None
        if calib_dir and os.path.isdir(calib_dir):
            reg, cls = load_calibrators(calib_dir)
            if reg:
                self.box_calib = CalibrateBoxUncert(reg, self.config.num_classes)
            if cls:
                self.cls_calib = CalibrateClass(cls, self.config.num_classes)
        self.opt_params = np.asarray(opt_params) if opt_params is not None else None
        self.opt_thrs = read_optimal_thresholds(opt_thrs_path) if opt_thrs_path else None
        self.label_map = get_label_map(self.config.label_map) or {}
        self.count_auto = 0
        self.count_skip = 0

    # -- auto-label gate --------------------------------------------------------

    def _combined_uncertainty(self, entropy, rel_albox) -> Optional[np.ndarray]:
        sel = self.config.thr_sel_uncert
        uncerts = []
        if "ENT" in sel and entropy is not None:
            uncerts.append(entropy)
        if "ALBOX" in sel and rel_albox is not None:
            uncerts.append(np.mean(rel_albox, axis=-1))
        if not uncerts or self.opt_params is None:
            return None
        return sum(p * u for p, u in zip(self.opt_params, uncerts))

    def _gate(self, combined: np.ndarray, scores: np.ndarray) -> bool:
        keep = scores > self.min_score
        thr = float(np.mean(self.opt_thrs)) if self.opt_thrs is not None else np.inf
        return bool(np.all(combined[keep] < thr))

    # -- main loop -----------------------------------------------------------------

    def _serve(self, batch):
        """One batch of any contract: a reader's ``(images, labels)``,
        ``(images, names, image_scales)`` of normalised network-size
        images, or ``(raw_images, names)``. Returns (batch size, names,
        the split outputs, the overlays' pixels and the scales that map
        the boxes onto them: both None without ``save_visualizations``;
        the scales None where the pixels are in the boxes' frame)."""
        pixels = overlay_scales = None
        if len(batch) == 2 and isinstance(batch[1], dict):
            images, labels = batch
            names = list(labels.get("image_names", labels.get("source_ids", [])))
            packed = serve_reader_batch(self.driver, images, labels)
            if self.save_visualizations:
                # detections are in the original frame: native (device-resize)
                # pixels are too, resized pixels need the boxes divided by scale
                native = is_fast_batch(images) and "warp_scale" in labels
                pixels = raw_pixels_from_batch(images, labels, self.config)
                if not native:
                    overlay_scales = np.asarray(labels.get(
                        "image_scales", np.ones(images.shape[0])), np.float32)
        elif len(batch) == 3:
            images, names, scales = batch
            packed = self.driver.serve_preprocessed(images, scales)
            if self.save_visualizations:
                pixels = denormalize_image(torch.as_tensor(images).cpu().numpy(),
                                           self.config.mean_rgb, self.config.stddev_rgb)
                overlay_scales = np.asarray(scales, np.float32)
        else:
            images, names = batch
            packed = self.driver.serve(images)
            pixels = images if self.save_visualizations else None
        return (images.shape[0], list(names), split_serve_outputs(self.config, packed),
                pixels, overlay_scales)

    def run(self, batches: Iterable[Tuple]) -> List[Dict]:
        """Serve the batches; write prediction_data.txt (and with
        ``auto_labeling`` the labeled/examine lists and pseudo-labels) and
        the buckets; return the per-detection rows."""
        rows: List[Dict] = []
        labeled_names: List[str] = []
        examine_names: List[str] = []
        for batch in batches:
            b, names, out, pixels, overlay_scales = self._serve(batch)
            for i in range(b):
                overlay = None
                if pixels is not None:
                    overlay = (pixels[i], None if overlay_scales is None else overlay_scales[i])
                rows.extend(self._image_rows(out, i, names[i], labeled_names,
                                             examine_names, overlay))
        with open(os.path.join(self.save_dir, "prediction_data.txt"), "w") as f:
            for row in rows:
                f.write(repr(row) + "\n")
        if self.auto_labeling:
            for name, lst in [("labeled", labeled_names), ("examine", examine_names)]:
                os.makedirs(os.path.join(self.save_dir, name), exist_ok=True)
                with open(os.path.join(self.save_dir, name, "images.txt"), "w") as f:
                    f.write("\n".join(lst))
        self._write_buckets()
        return rows

    def _image_rows(self, out, i, name, labeled_names, examine_names,
                    overlay=None) -> List[Dict]:
        """The image's rows; on the way its buckets' rankings, its gate
        and, with ``overlay`` = (pixels, scale or None), its overlays."""
        n_val = int(out["valid_len"][i])
        scores = out["scores"][i][:n_val]
        boxes = out["boxes"][i][:n_val]
        classes = out["classes"][i][:n_val]
        entropy = out.get("entropy")
        entropy_i = entropy[i][:n_val] if entropy is not None else None

        rel_al = rel_mc = mcc_max = None
        calibrated_boxes: Dict[str, np.ndarray] = {}
        if "sigma_mc" in out and n_val:
            rel_mc = relativize(boxes, out["sigma_mc"][i][:n_val])
        if "sigma_cls" in out and n_val:
            mcc_max = np.max(out["sigma_cls"][i][:n_val], axis=-1)
        if "sigma_al" in out:
            sig = out["sigma_al"][i][:n_val]
            rel_al = relativize(boxes, sig) if n_val else sig
            if self.box_calib and n_val:
                calibrated_boxes = {f"{k}_albox": v for k, v in
                                    self.box_calib(sig, classes, boxes).items()}
        # both the aleatoric and the epistemic box σ are calibrated
        if "sigma_mc" in out and self.box_calib and n_val:
            calibrated_boxes.update({
                f"{k}_mcbox": v for k, v in
                self.box_calib(out["sigma_mc"][i][:n_val], classes, boxes).items()})
        calibrated_cls: Dict[str, Dict] = {}
        if self.cls_calib is not None and "logits" in out and n_val:
            sig_cls = out.get("sigma_cls")
            # a seed from the image name, so every pass over an image draws alike
            seed = zlib.crc32(str(name).encode()) & 0x7FFFFFFF
            calibrated_cls = self.cls_calib(
                out["logits"][i][:n_val],
                uncert=sig_cls[i][:n_val] if sig_cls is not None else None, seed=seed)

        combined = self._combined_uncertainty(entropy_i, rel_al) if n_val else None
        if n_val:
            if combined is not None:
                img_u = float(np.mean(combined))
            elif entropy_i is not None:
                img_u = float(np.mean(entropy_i))
            elif rel_al is not None:
                img_u = float(np.mean(rel_al))
            else:
                img_u = float(-np.mean(scores))
            self._image_uncert.append((name, img_u))
            for kind, vals in (("albox", np.mean(rel_al, -1) if rel_al is not None else None),
                               ("mcbox", np.mean(rel_mc, -1) if rel_mc is not None else None),
                               ("mcclass", mcc_max), ("entropy", entropy_i)):
                if vals is not None and np.isfinite(vals).any():
                    self._image_uncert_kind.setdefault(kind, []).append(
                        (name, float(np.nanmax(vals))))
        if overlay is not None and n_val:
            pixels, scale = overlay
            planes = {"albox": np.mean(rel_al, -1) if rel_al is not None else None,
                      "mcbox": np.mean(rel_mc, -1) if rel_mc is not None else None,
                      "mcclass": mcc_max, "entropy": entropy_i}
            self._save_overlay(pixels, name, boxes if scale is None else boxes / scale,
                               classes, scores, planes)
        keep = np.where(scores > self.min_score)[0]
        subdir = ""
        if self.auto_labeling:
            ok = combined is not None and self._gate(combined, scores)
            subdir = "labeled" if ok else "examine"
            (labeled_names if ok else examine_names).append(name)
            if ok:
                self.count_auto += 1
                d = os.path.join(self.save_dir, "labeled")
                os.makedirs(d, exist_ok=True)
                stem = os.path.splitext(os.path.basename(str(name)))[0] or "img"
                write_kitti_labels(os.path.join(d, stem + ".txt"), boxes[keep], classes[keep],
                                   scores[keep], self.label_map)
            else:
                self.count_skip += 1

        rows = []
        for d in keep:
            row = {
                "image_name": name,
                "score_thresh": self.min_score,
                "det_score": float(scores[d]),
                "bbox": [float(x) for x in boxes[d]],
                "class": float(classes[d]),
            }
            if entropy_i is not None:
                row["entropy"] = float(entropy_i[d])
                row["logits"] = [float(x) for x in out["logits"][i][d]]
                row["probab"] = [float(x) for x in out["probab"][i][d]]
            if "sigma_al" in out:
                row["uncalib_albox"] = [float(x) for x in out["sigma_al"][i][d]]
            if "sigma_mc" in out:
                row["uncalib_mcbox"] = [float(x) for x in out["sigma_mc"][i][d]]
            if "sigma_cls" in out:
                row["uncalib_mcclass"] = [float(x) for x in out["sigma_cls"][i][d]]
            for k, v in calibrated_boxes.items():
                row[k] = [float(x) for x in v[d]]
            for k, v in calibrated_cls.items():
                row[f"{k}_entropy"] = float(v["entropy"][d])
                if "mcclass" in v:
                    row[f"{k}_mcclass"] = [float(x) for x in v["mcclass"][d]]
            if subdir:
                row["auto_label"] = subdir
            rows.append(row)
        return rows

    def _save_overlay(self, image, name, boxes, classes, scores, planes) -> None:
        """The plain overlay and one panel per uncertainty, as PNGs under
        ``visualizations/``. As the JAX package does, an image whose
        largest value is at most 20 is taken for normalised and mapped
        back to pixels first."""
        img = np.asarray(image, np.float32)
        if img.max() <= 20.0:
            img = img * np.asarray(self.config.stddev_rgb, np.float32) + \
                np.asarray(self.config.mean_rgb, np.float32)
        img = np.clip(img, 0, 255).astype(np.uint8)
        panels = overlay_panels(img, np.asarray(boxes), np.asarray(classes).astype(int),
                                np.asarray(scores), planes, min_score_thresh=self.min_score)
        out_dir = os.path.join(self.save_dir, "visualizations")
        os.makedirs(out_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(str(name)))[0] or "img"
        for suffix, vis in panels.items():
            path = os.path.join(out_dir, stem + suffix + ".png")
            write_png(path, vis)
            if not suffix:
                self._overlay_paths[str(name)] = path

    def _write_buckets(self):
        """Top/bottom uncertainty image lists: a combined ranking
        (bottom10/top10) and per uncertainty kind
        (uncert/{lower,upper}_uncert/<kind>/images.txt)."""
        if self._image_uncert:
            ranked = sorted(self._image_uncert, key=lambda t: t[1])
            k = max(1, int(round(len(ranked) * self.bucket_fraction)))
            for tag, sel in (("bottom10", ranked[:k]), ("top10", ranked[-k:])):
                self._write_names(os.path.join(self.save_dir, tag), sel)
        for kind, pairs in self._image_uncert_kind.items():
            ranked = sorted(pairs, key=lambda t: t[1])
            k = max(1, int(np.ceil(len(ranked) * self.bucket_fraction)))
            for tag, sel in (("lower_uncert", ranked[:k]), ("upper_uncert", ranked[-k:])):
                d = os.path.join(self.save_dir, "uncert", tag, kind)
                self._write_names(d, sel)
                self._bucket_artifacts(d, sel)

    def _bucket_artifacts(self, bucket_dir: str, sel) -> None:
        """Copy the bucket's overlays into it and tile them, read back from
        their PNGs, into its ``contact_sheet.png``."""
        copied, labels = [], []
        for name, u in sel:
            src = self._overlay_paths.get(str(name))
            if src and os.path.exists(src):
                shutil.copyfile(src, os.path.join(bucket_dir, os.path.basename(src)))
                copied.append(src)
                labels.append(f"{os.path.basename(src)} {u:.3g}")
        if copied:
            thumbs = []
            for path in copied:
                with open(path, "rb") as f:
                    thumbs.append(decode_image(f.read()))
            write_png(os.path.join(bucket_dir, "contact_sheet.png"),
                      contact_sheet(thumbs, labels=labels))

    @staticmethod
    def _write_names(directory: str, sel) -> None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "images.txt"), "w") as f:
            for name, u in sel:
                f.write(f"{name} {u}\n")


def consistency_check(driver, images: np.ndarray, base_boxes: np.ndarray,
                      base_classes: np.ndarray,
                      modes: Sequence[str] = ("flip", "blur", "noise"),
                      rng: Optional[np.random.RandomState] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Prediction consistency under augmentation: serve each variant of the
    raw uint8 ``images`` (a horizontal flip, cv2's 9x9 Gaussian blur on the
    driver's device, Gaussian noise of σ 12 from ``rng``), and give each
    base detection its best IoU against the variant's boxes (mapped back
    for the flip) averaged over the variants, and whether its class agrees
    in every variant.

    Returns (mean_iou [B, K], class_agreement [B, K] bool).
    """
    rng = rng or np.random.RandomState(0)
    b, k = base_classes.shape[:2]
    ious_all = []
    classes_all = []
    for mode in modes:
        if mode == "flip":
            aug = np.ascontiguousarray(images[:, :, ::-1])
        elif mode == "blur":
            aug = gaussian_blur_uint8(np.asarray(images, np.uint8), 9, driver.device)
        elif mode == "noise":
            aug = np.clip(images + rng.randn(*images.shape) * 12, 0, 255).astype(images.dtype)
        else:
            raise ValueError(mode)
        out = split_serve_outputs(driver.config, driver.serve(aug))
        boxes_aug = out["boxes"]
        if mode == "flip":
            w = images.shape[2]
            flipped = boxes_aug.copy()
            flipped[..., 1] = w - boxes_aug[..., 3]
            flipped[..., 3] = w - boxes_aug[..., 1]
            boxes_aug = flipped
        per_image_iou = np.zeros((b, k))
        per_image_cls = np.zeros((b, k))
        for i in range(b):
            m = iou_matrix_corners(base_boxes[i], boxes_aug[i])
            best = m.argmax(axis=1)
            per_image_iou[i] = m.max(axis=1)
            per_image_cls[i] = out["classes"][i][best]
        ious_all.append(per_image_iou)
        classes_all.append(per_image_cls)
    mean_iou = np.mean(np.stack(ious_all), axis=0)
    agree = np.all(np.stack(classes_all) == base_classes[None], axis=0)
    return mean_iou, agree


def read_prediction_data(path: str) -> List[Dict]:
    """The rows of a prediction_data.txt."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(ast.literal_eval(line))
    return rows


def write_kitti_labels(path: str, boxes: np.ndarray, classes: np.ndarray,
                       scores: np.ndarray, label_map: Dict[int, str]) -> None:
    """Pseudo-labels in KITTI's txt format (type, truncation, occlusion,
    alpha, x1 y1 x2 y2, zero dimensions and location, score)."""
    with open(path, "w") as f:
        for b, c, s in zip(boxes, classes, scores):
            name = label_map.get(int(c), str(int(c)))
            y1, x1, y2, x2 = [float(v) for v in b]
            f.write(f"{name} 0.0 0 0.0 {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
                    f"0.0 0.0 0.0 0.0 0.0 0.0 0.0 {float(s):.4f}\n")
