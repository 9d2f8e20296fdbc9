"""Semi-supervised learning: STAC pseudo-labelling and CSD consistency.

Port of ``udal_tpu/apps/ssl.py``:

* STAC: a teacher trained on the labelled split → pool inference →
  pseudo-label selection by the score threshold tau and/or
  inverse-uncertainty strategies (combo / alluncert / epuncert / ental,
  min-max normalised) → a pseudo TFRecord with per-detection
  ``image/object/pseudo_score`` → a student trained on labelled + pseudo
  batches (the ``config.unlabeled_start`` split of the train step);
  ``selftrain_rounds`` repeat the predict/train cycle with the student as
  the new teacher, and training is retried until its checkpoint exists;
* CSD: the labelled/unlabelled TFRecord split by ratio, the
  flip-consistency loss in the train step.

The stages are injected callables (``apps.ssl_runner`` wires them to the
port's training loop and ``InferImages``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from udal_tpu_torch.data import example_codec as codec
from udal_tpu_torch.data import tfrecord as tfr


def _rel_box(det: Dict, key: str) -> float:
    box = np.asarray(det["bbox"], np.float64)
    sig = np.asarray(det[key], np.float64)
    h, w = box[2] - box[0], box[3] - box[1]
    denom = np.maximum(np.asarray([h, w, h, w]), 1e-6)  # degenerate clipped boxes
    return float(np.mean(sig / denom))


def select_pseudo_labels(rows: List[Dict], strategy: str, tau: float,
                         opt_thrs: Optional[np.ndarray] = None,
                         opt_params: Optional[Sequence[float]] = None,
                         with_scores: bool = False):
    """Filter detections into per-image pseudo labels.

    Parity: `SSL_stac.score_image` (`SSL_stac.py:302-642`). Returns
    (image_names, per-image classes, per-image boxes[, per-image scores]).
    """
    by_image: Dict[str, List[Dict]] = {}
    order: List[str] = []
    for r in rows:
        if r["image_name"] not in by_image:
            by_image[r["image_name"]] = []
            order.append(r["image_name"])
        by_image[r["image_name"]].append(r[:] if isinstance(r, list) else r)

    calib = "calib" in strategy
    box_mode = "iso_perclscoo_" if calib else "uncalib_"
    cls_mode = "iso_percls_" if calib else "uncalib_"
    ent_key = "iso_percls_entropy" if calib else "entropy"

    names_out, classes_out, boxes_out, scores_out = [], [], [], []
    all_uncert, all_scores, all_meta = [], [], []
    for name in order:
        dets = by_image[name][:99]
        det_scores = np.asarray([d["det_score"] for d in dets])
        if "combo" in strategy:
            p = opt_params if opt_params is not None else [0.5, 0.5]
            u = np.asarray([p[0] * d.get(ent_key, d.get("entropy", 0.0)) +
                            p[1] * _rel_box(d, box_mode + "albox")
                            for d in dets])
        elif "alluncert" in strategy:
            u = np.asarray([np.mean([_rel_box(d, box_mode + "mcbox"),
                                     _rel_box(d, box_mode + "albox"),
                                     float(np.mean(d[cls_mode + "mcclass"]))])
                            for d in dets])
            u = 1.0 / np.maximum(u, 1e-12)
        elif "epuncert" in strategy:
            u = np.asarray([np.mean([_rel_box(d, box_mode + "mcbox"),
                                     float(np.mean(d[cls_mode + "mcclass"]))])
                            for d in dets])
            u = 1.0 / np.maximum(u, 1e-12)
        elif "ental" in strategy:
            u = np.asarray([np.mean([_rel_box(d, box_mode + "albox"),
                                     float(d.get(ent_key,
                                                 d.get("entropy", 0.0)))])
                            for d in dets])
            u = 1.0 / np.maximum(u, 1e-12)
        else:
            u = det_scores
        all_uncert.append(u)
        all_scores.append(det_scores)
        all_meta.append((name, dets))

    if not all_meta:
        return ([], [], [], []) if with_scores else ([], [], [])

    if "combo" in strategy:
        flat = np.concatenate(all_uncert)
        lo, hi = flat.min(), flat.max()
        norm = [(u - lo) / (hi - lo) if hi > lo else np.zeros_like(u)
                for u in all_uncert]
        thr = float(np.mean(opt_thrs)) if opt_thrs is not None else np.inf
        keeps = [(s > tau) & (n <= thr)
                 for s, n in zip(all_scores, norm)]
        img_scores = [1.0 - n for n in norm]      # high confidence = low unc
    elif any(k in strategy for k in ("alluncert", "epuncert", "ental")):
        flat = np.concatenate(all_uncert)
        lo, hi = flat.min(), flat.max()
        norm = [(u - lo) / (hi - lo) if hi > lo else np.zeros_like(u)
                for u in all_uncert]
        keeps = [(s > tau) for s in all_scores]
        if "alluncert" in strategy:
            keeps = [(n * k) > tau for n, k in zip(norm, keeps)]
        img_scores = norm
    else:
        keeps = [s > tau for s in all_scores]
        img_scores = all_scores

    for (name, dets), keep, sc in zip(all_meta, keeps, img_scores):
        if not np.any(keep):
            continue
        names_out.append(name)
        classes_out.append(np.asarray([d["class"] for d in dets])[keep])
        boxes_out.append(np.asarray([d["bbox"] for d in dets])[keep])
        scores_out.append(np.asarray(sc)[keep])
    if with_scores:
        return names_out, classes_out, boxes_out, scores_out
    return names_out, classes_out, boxes_out


def write_pseudo_tfrecord(path: str, images: Dict[str, np.ndarray],
                          names: Sequence[str],
                          classes: Sequence[np.ndarray],
                          boxes: Sequence[np.ndarray],
                          scores: Optional[Sequence[np.ndarray]] = None
                          ) -> int:
    """Write pseudo-labeled examples (reference schema incl. pseudo_score).

    Parity with the custom/pseudo TFRecord writers
    (`datasets/KITTI/kitti_tf_creator.py:233-319`).
    """
    from udal_tpu_torch.data.synthetic import make_example

    n = 0
    with tfr.TFRecordWriter(path) as w:
        for i, name in enumerate(names):
            img = images[name]
            ps = scores[i] if scores is not None else None
            w.write(make_example(img, np.asarray(boxes[i], np.float32),
                                 np.asarray(classes[i], np.int64),
                                 source_id=str(i), filename=name,
                                 pseudo_scores=ps))
            n += 1
    return n


class STAC:
    """STAC pseudo-label SSL orchestration (in-process).

    run(): teacher train → predict pool → select pseudo labels → write
    pseudo TFRecord → student train; `selftrain_rounds` > 0 repeats the
    predict/train cycle with the student as the new teacher
    (`SSL_stac.py:656-768,1118-1197`).
    """

    def __init__(self, work_dir: str, tau: float = 0.5,
                 selection_strategy: str = "score",
                 stac_lambda: float = 1.0,
                 activate_pseudoscore: bool = False,
                 train_fn: Optional[Callable] = None,
                 infer_fn: Optional[Callable] = None,
                 images_fn: Optional[Callable] = None,
                 opt_thrs: Optional[np.ndarray] = None,
                 opt_params: Optional[Sequence[float]] = None,
                 selftrain_rounds: int = 0,
                 train_done_fn: Optional[Callable] = None,
                 max_train_retries: int = 3):
        self.work_dir = work_dir
        self.tau = tau
        self.strategy = selection_strategy
        self.stac_lambda = stac_lambda
        self.activate_pseudoscore = activate_pseudoscore
        self.train_fn = train_fn
        self.infer_fn = infer_fn
        self.images_fn = images_fn
        self.opt_thrs = opt_thrs
        self.opt_params = opt_params
        self.selftrain_rounds = selftrain_rounds
        # crash-resume probe — the reference relaunches training until the
        # final checkpoint exists (`SSL_stac.py:673-708,786-793`)
        self.train_done_fn = train_done_fn
        self.max_train_retries = max_train_retries
        os.makedirs(work_dir, exist_ok=True)

    def _pseudo_round(self, round_idx: int) -> str:
        rows = self.infer_fn(round_idx)
        out = select_pseudo_labels(rows, self.strategy, self.tau,
                                   self.opt_thrs, self.opt_params,
                                   with_scores=True)
        names, classes, boxes, scores = out
        path = os.path.join(self.work_dir, f"pseudo_round{round_idx}.tfrecord")
        images = self.images_fn(names)
        write_pseudo_tfrecord(
            path, images, names, classes, boxes,
            scores if self.activate_pseudoscore else None)
        return path

    def _train(self, **kw) -> None:
        """Train with retry-until-checkpoint crash resume."""
        for _ in range(self.max_train_retries):
            self.train_fn(**kw)
            if self.train_done_fn is None or \
                    self.train_done_fn(kw["stage"], kw["round_idx"]):
                return
        raise RuntimeError(
            f"training never produced a checkpoint for {kw!r} after "
            f"{self.max_train_retries} attempts")

    def run(self) -> List[str]:
        artifacts = []
        self._train(stage="teacher", pseudo_path=None, round_idx=0)
        for r in range(1 + self.selftrain_rounds):
            pseudo = self._pseudo_round(r)
            artifacts.append(pseudo)
            self._train(stage="student", pseudo_path=pseudo, round_idx=r)
        return artifacts


def split_labeled_unlabeled(records: Sequence[bytes], ratio: float,
                            labeled_path: str, unlabeled_path: str,
                            seed: int = 0) -> Tuple[int, int]:
    """Write labeled/unlabeled TFRecord splits for CSD —
    parity `datasets/KITTI/kitti_tf_creator.py:84-170` (CSD split) and
    `SSL_csd.py:237-307`. Unlabeled examples keep their image but drop the
    object annotations."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(records))
    n_labeled = int(round(len(records) * ratio))
    with tfr.TFRecordWriter(labeled_path) as w:
        for i in idx[:n_labeled]:
            w.write(records[i])
    with tfr.TFRecordWriter(unlabeled_path) as w:
        for i in idx[n_labeled:]:
            feats = codec.parse_example(records[i])
            for k in list(feats):
                if k.startswith("image/object/"):
                    feats[k] = []
            w.write(codec.serialize_example(feats))
    return n_labeled, len(records) - n_labeled


class CSD:
    """CSD consistency SSL orchestration — parity `SSL_csd.py:19-307`.

    Splits the dataset, configures the flip-consistency loss (handled by
    the train step via config.ssl_method == 'CSD') and launches training.
    """

    def __init__(self, work_dir: str, ratio: float = 0.5,
                 csd_ramp: bool = True, csd_be: bool = True,
                 csd_be_thr: float = 0.0,
                 train_fn: Optional[Callable] = None):
        self.work_dir = work_dir
        self.ratio = ratio
        self.csd_ramp = csd_ramp
        self.csd_be = csd_be
        self.csd_be_thr = csd_be_thr
        self.train_fn = train_fn
        os.makedirs(work_dir, exist_ok=True)

    def run(self, records: Sequence[bytes]) -> Tuple[str, str]:
        labeled = os.path.join(self.work_dir, "csd_labeled.tfrecord")
        unlabeled = os.path.join(self.work_dir, "csd_unlabeled.tfrecord")
        split_labeled_unlabeled(records, self.ratio, labeled, unlabeled)
        overrides = {"ssl_method": "CSD", "csd_ramp": self.csd_ramp,
                     "csd_BE": self.csd_be, "csd_BE_thr": self.csd_be_thr}
        if self.train_fn is not None:
            self.train_fn(labeled, unlabeled, overrides)
        return labeled, unlabeled
