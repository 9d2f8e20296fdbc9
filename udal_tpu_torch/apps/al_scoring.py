"""Array-native active-learning pool scoring.

Port of ``udal_tpu/apps/al_scoring.py``. The packed serving outputs stay
``[n_images, max_dets, ...]`` numpy arrays end to end: every strategy of
``apps.active_learning``'s grammar is a masked reduction over the
detections axis, and the multi-term normalisations (min-max, z-score over
the pool) are single array ops. ``score_pool`` / ``select_pool`` give what
``score_images`` / ``select_images`` give on the same detections as dict
rows.

``collect_pool`` serves the pool through the port's ``ServingDriver``
with up to ``inflight`` serves queued on the device before the first copy
to the host. The serve itself calls no ``.item()``, ``.tolist()`` or
``.cpu()``; the one copy a batch is ``apps.infer._outputs_to_host``. An
upload from pageable host memory (numpy batches: ``torch.as_tensor`` in
``ServingDriver._pre`` / ``_dispatch_uint8``) does wait for the stream's
earlier work, so only the reader's ``device_put`` batches (pinned memory,
``non_blocking``) keep the window full.

Strategy-name grammar: options stack by substring (``mean`` or the
default max, ``calib``, ``norm``, ``perc``, ``bottomk`` / ``nee``), and
the uncertainty metric is the LAST underscore-separated token
(``entropy`` / ``mcbox`` / ``albox`` / ``mcclass``), or one of the
combination families ``combo`` / ``ental`` / ``alluncert`` / ``epuncert``
/ ``sota`` / ``highep_lowal``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from udal_tpu_torch.apps.active_learning import min_max_scaler, z_score_normalization


@dataclasses.dataclass
class DetectionPool:
    """Packed per-pool detection arrays (images with >=1 kept detection).

    ``feats`` holds per-detection feature planes keyed by the
    prediction_data.txt field names: ``entropy`` [N,K],
    ``uncalib_albox``/``uncalib_mcbox`` [N,K,4], ``uncalib_mcclass`` [N,K,C],
    ``det_score`` [N,K], plus calibrated planes such as
    ``iso_perclscoo_albox`` [N,K,4] and ``iso_percls_entropy`` [N,K].
    """

    names: List[str]            # [N] serve order
    boxes: np.ndarray           # [N, K, 4] original-frame corners
    classes: np.ndarray         # [N, K]
    mask: np.ndarray            # [N, K] bool: valid and score > min_score
    feats: Dict[str, np.ndarray]

    @property
    def n_images(self) -> int:
        return len(self.names)

    @property
    def n_detections(self) -> int:
        return int(self.mask.sum())


# ---------------------------------------------------------------------------
# Collection: serve batches -> packed pool arrays (no per-detection dicts)
# ---------------------------------------------------------------------------

def collect_pool(driver, batches: Iterable[Tuple], min_score: float = 0.0,
                 box_calib=None, cls_calib=None,
                 inflight: int = 8) -> DetectionPool:
    """Serve reader/raw batches and accumulate packed pool arrays.

    Accepts the same batch contracts as `InferImages.run`: ``(raw_images,
    names)``, ``(images, names, image_scales)`` (eval-reader normalized), or
    a reader's ``(images, labels)`` pair of any contract. Calibrators, when
    given, are applied once over all valid detections (flattened) instead
    of per image.

    Up to ``inflight`` serves are queued on the device before the oldest
    one's outputs are copied to the host (CUDA launches return before the
    work is done, so the host reads the next batch meanwhile); the window
    bounds the queue and the device's output buffers.
    """
    from collections import deque

    from udal_tpu_torch.apps.infer import split_serve_outputs

    pending: deque = deque()
    chunks: List[Dict[str, np.ndarray]] = []
    names: List[str] = []
    for batch in batches:
        if len(batch) == 2 and isinstance(batch[1], dict):
            from udal_tpu_torch.apps.reader_batches import serve_reader_batch

            images, labels = batch
            batch_names = list(labels.get("image_names",
                                          labels.get("source_ids", [])))
            pending.append(serve_reader_batch(driver, images, labels))
        elif len(batch) == 3:
            images, batch_names, scales = batch
            pending.append(driver.serve_preprocessed(images, scales))
        else:
            images, batch_names = batch
            pending.append(driver.serve(images))
        names.extend(str(n) for n in batch_names)
        while len(pending) > max(1, inflight):
            chunks.append(split_serve_outputs(driver.config,
                                              pending.popleft()))
    while pending:
        chunks.append(split_serve_outputs(driver.config, pending.popleft()))

    def cat(key):
        if key not in chunks[0]:
            return None
        return np.concatenate([c[key] for c in chunks], axis=0)

    scores = cat("scores")
    n, k = scores.shape
    valid = cat("valid_len").astype(int)
    valid_mask = np.arange(k)[None, :] < valid[:, None]
    mask = valid_mask & (scores > min_score)

    feats: Dict[str, np.ndarray] = {"det_score": scores}
    for key, feat in [("entropy", "entropy"), ("sigma_al", "uncalib_albox"),
                      ("sigma_mc", "uncalib_mcbox"),
                      ("sigma_cls", "uncalib_mcclass"),
                      ("logits", "logits"), ("probab", "probab")]:
        arr = cat(key)
        if arr is not None:
            feats[feat] = arr
    boxes = cat("boxes")
    classes = cat("classes")

    pool = DetectionPool(names=names, boxes=boxes, classes=classes,
                         mask=mask, feats=feats)
    _apply_calibrators(pool, valid_mask, box_calib, cls_calib)
    return _drop_empty_images(pool)


def _apply_calibrators(pool: DetectionPool, valid_mask: np.ndarray,
                       box_calib, cls_calib) -> None:
    """Flatten valid detections, apply the calibrators once, scatter
    the calibrated planes back — the vectorized equivalent of the per-image
    application in `InferImages.run` / `infer_model.py:652-740`.

    Calibration covers ALL valid detections (pre min-score filter), like the
    dict path, so per-image sampling noise aligns between the two paths.
    """
    idx = np.nonzero(valid_mask)
    if idx[0].size == 0:
        return
    if box_calib is not None:
        flat_boxes = pool.boxes[idx]
        flat_classes = pool.classes[idx]
        for src, tag in [("uncalib_albox", "albox"),
                         ("uncalib_mcbox", "mcbox")]:
            if src not in pool.feats:
                continue
            cal = box_calib(pool.feats[src][idx], flat_classes, flat_boxes)
            for k, v in cal.items():
                plane = np.zeros_like(pool.feats[src])
                plane[idx] = v
                pool.feats[f"{k}_{tag}"] = plane
    if cls_calib is not None and "logits" in pool.feats:
        import zlib

        unc = pool.feats.get("uncalib_mcclass")
        noise = None
        if unc is not None:
            n_samples = 10
            c = unc.shape[-1]
            counts = valid_mask.sum(axis=1)
            # per-image name-derived seeds, identical to the dict path
            chunks = [np.random.RandomState(
                zlib.crc32(str(pool.names[i]).encode()) & 0x7FFFFFFF)
                .randn(n_samples, int(counts[i]), c)
                for i in range(len(pool.names)) if counts[i]]
            noise = np.concatenate(chunks, axis=1)
        cal = cls_calib(pool.feats["logits"][idx],
                        uncert=unc[idx] if unc is not None else None,
                        noise=noise)
        for k, v in cal.items():
            plane = np.zeros(valid_mask.shape, np.float64)
            plane[idx] = v["entropy"]
            pool.feats[f"{k}_entropy"] = plane
            if "mcclass" in v:
                mc = np.zeros(unc.shape, np.float64)
                mc[idx] = v["mcclass"]
                pool.feats[f"{k}_mcclass"] = mc


def _drop_empty_images(pool: DetectionPool) -> DetectionPool:
    """Images with zero kept detections produce no prediction rows in the
    dict path and are therefore invisible to scoring; drop them here too."""
    keep = pool.mask.any(axis=1)
    if keep.all():
        return pool
    sel = np.nonzero(keep)[0]
    return DetectionPool(
        names=[pool.names[i] for i in sel], boxes=pool.boxes[sel],
        classes=pool.classes[sel], mask=pool.mask[sel],
        feats={k: v[sel] for k, v in pool.feats.items()})


def subset_pool(pool: DetectionPool, keep: Iterable[str]) -> DetectionPool:
    """Restrict the pool to ``keep`` image names (preserving serve order) —
    the loop-side filter the dict path applies with a per-row membership
    test (`active_learning_loop.py:528-543` re-reads prediction_data.txt
    and drops already-selected images)."""
    keep = set(keep)
    sel = [i for i, n in enumerate(pool.names) if n in keep]
    if len(sel) == len(pool.names):
        return pool
    idx = np.asarray(sel, int)
    return DetectionPool(
        names=[pool.names[i] for i in sel], boxes=pool.boxes[idx],
        classes=pool.classes[idx], mask=pool.mask[idx],
        feats={k: v[idx] for k, v in pool.feats.items()})


def pool_from_rows(rows: Sequence[Dict]) -> DetectionPool:
    """Build a DetectionPool from prediction_data.txt dict rows (the
    compatibility direction, used by tests and by loops resuming from the
    text artifact)."""
    by_image: Dict[str, List[Dict]] = {}
    order: List[str] = []
    for r in rows:
        name = r["image_name"]
        if name not in by_image:
            by_image[name] = []
            order.append(name)
        by_image[name].append(r)
    n = len(order)
    k = max(len(v) for v in by_image.values())

    vector_keys = {}
    scalar_keys = set()
    for r in rows:
        for key, v in r.items():
            if key in ("image_name", "auto_label", "score_thresh"):
                continue
            if isinstance(v, (list, tuple)):
                vector_keys[key] = max(vector_keys.get(key, 0), len(v))
            elif isinstance(v, (int, float)):
                scalar_keys.add(key)

    boxes = np.zeros((n, k, 4))
    classes = np.zeros((n, k))
    mask = np.zeros((n, k), bool)
    feats: Dict[str, np.ndarray] = {}
    for key in scalar_keys - {"class", "det_score"}:
        feats[key] = np.zeros((n, k))
    feats["det_score"] = np.zeros((n, k))
    for key, dim in vector_keys.items():
        if key == "bbox":
            continue
        feats[key] = np.zeros((n, k, dim))

    for i, name in enumerate(order):
        for j, det in enumerate(by_image[name]):
            mask[i, j] = True
            boxes[i, j] = det["bbox"]
            classes[i, j] = det["class"]
            feats["det_score"][i, j] = det["det_score"]
            for key in feats:
                if key != "det_score" and key in det:
                    feats[key][i, j] = det[key]
    return DetectionPool(names=order, boxes=boxes, classes=classes,
                         mask=mask, feats=feats)


# ---------------------------------------------------------------------------
# Scoring: vectorized masked reductions
# ---------------------------------------------------------------------------

def _rel_box_plane(boxes: np.ndarray, sigma: np.ndarray,
                   mask: np.ndarray) -> np.ndarray:
    """[N,K] mean over coords of sigma / [h,w,h,w] — the vectorized
    ``relativize``."""
    boxes = np.asarray(boxes, np.float64)   # match the dict path's f64 math
    sigma = np.asarray(sigma, np.float64)
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    # Boxes clipped to the image bounds can be exactly degenerate (h or w
    # == 0); clamp so such detections rank as hugely-uncertain finite values
    # instead of poisoning downstream reductions/ROCs with NaN/inf.
    denom = np.maximum(np.stack([h, w, h, w], axis=-1), 1e-6)
    rel = np.mean(sigma / denom, axis=-1)
    return np.where(mask, rel, 0.0)


def _mean_plane(feat: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[N,K] per-detection scalar from a scalar or vector feature plane."""
    feat = np.asarray(feat, np.float64)     # match the dict path's f64 math
    if feat.ndim == 3:
        feat = np.mean(feat, axis=-1)
    return np.where(mask, feat, 0.0)


def _strategy_planes(pool: DetectionPool, strategy: str,
                     opt_params: Optional[Sequence[float]]
                     ) -> List[np.ndarray]:
    """Per-detection [N,K] score planes for a strategy — the vectorized
    `_det_score_terms` (dict-path twin in `apps.active_learning`, reference
    `active_learning_loop.py:544-715`)."""
    f, m = pool.feats, pool.mask
    calib = "calib" in strategy
    box_mode = "iso_perclscoo_" if calib else "uncalib_"
    cls_mode = "iso_percls_" if calib else "uncalib_"
    ent_key = "iso_percls_entropy" if calib else "entropy"
    zeros = np.zeros(m.shape)

    def ent_plane():
        return _mean_plane(f.get(ent_key, f.get("entropy", zeros)), m)

    if "combo" in strategy:
        p = opt_params if opt_params is not None else [0.5, 0.5]
        box_key = box_mode + "albox"
        return [p[0] * ent_plane() +
                p[1] * _rel_box_plane(pool.boxes, f[box_key], m)]
    if "alluncert" in strategy or "sota" in strategy:
        return [_rel_box_plane(pool.boxes, f[box_mode + "mcbox"], m),
                _rel_box_plane(pool.boxes, f[box_mode + "albox"], m),
                _mean_plane(f[cls_mode + "mcclass"], m)]
    if "epuncert" in strategy:
        return [_rel_box_plane(pool.boxes, f[box_mode + "mcbox"], m),
                _mean_plane(f[cls_mode + "mcclass"], m)]
    if "ental" in strategy:
        return [_rel_box_plane(pool.boxes, f[box_mode + "albox"], m),
                ent_plane()]
    # single-metric: the LAST underscore token picks the feature
    metric = strategy.split("_")[-1]
    prefix = box_mode if "box" in strategy else (cls_mode if "class" in
                                                 strategy else "")
    key = prefix + metric
    if key in f:
        if "box" in strategy and "norm" in strategy:
            return [_rel_box_plane(pool.boxes, f[key], m)]
        return [_mean_plane(f[key], m)]
    return [_mean_plane(f["det_score"], m)]


def _masked_agg(plane: np.ndarray, mask: np.ndarray,
                strategy: str) -> np.ndarray:
    """[N] per-image aggregation: mean over valid dets if 'mean' in the
    strategy name, else max (the reference default)."""
    if "mean" in strategy:
        return plane.sum(axis=1) / mask.sum(axis=1)
    return np.where(mask, plane, -np.inf).max(axis=1)


def score_pool(pool: DetectionPool, strategy: str,
               opt_params: Optional[Sequence[float]] = None
               ) -> Tuple[np.ndarray, List[np.ndarray], List[str]]:
    """Vectorized `score_images`: (scores [N], per-image class arrays,
    image names)."""
    planes = _strategy_planes(pool, strategy, opt_params)
    per_term = np.stack([_masked_agg(p, pool.mask, strategy)
                         for p in planes], axis=1)       # [N, n_terms]
    if per_term.shape[1] == 1:
        scores = per_term[:, 0]
    elif "highep_lowal" in strategy:
        norm = np.stack([min_max_scaler(per_term[:, j])
                         for j in range(per_term.shape[1])])
        scores = norm[0] + norm[2] - norm[1]
    elif "sota" in strategy:
        scores = np.max(np.stack([z_score_normalization(per_term[:, j])
                                  for j in range(per_term.shape[1])]), axis=0)
    else:
        scores = np.sum(np.stack([min_max_scaler(per_term[:, j])
                                  for j in range(per_term.shape[1])]), axis=0)
    classes = [pool.classes[i][pool.mask[i]] for i in range(pool.n_images)]
    return scores, classes, list(pool.names)


def select_pool(pool: DetectionPool, strategy: str, num_per_iter: int,
                opt_params: Optional[Sequence[float]] = None,
                rng: Optional[np.random.RandomState] = None) -> List[str]:
    """Vectorized `select_images` — identical selection semantics
    (`active_learning_loop.py:767-840`)."""
    from udal_tpu_torch.apps.active_learning import select_from_scores

    if strategy.startswith("random"):
        rng = rng or np.random.RandomState(0)
        names = sorted(set(pool.names))
        return list(rng.choice(names, min(num_per_iter, len(names)),
                               replace=False))
    scores, classes, names = score_pool(pool, strategy, opt_params)
    return select_from_scores(scores, classes, names, strategy, num_per_iter)
