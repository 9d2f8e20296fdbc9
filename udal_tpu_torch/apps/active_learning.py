"""Active learning: acquisition scoring, selection, pool pruning, the loop.

Port of ``udal_tpu/apps/active_learning.py``:

* the scoring strategies, composed from name substrings: random / entropy
  / mcbox / albox / mcclass / combo / ental / alluncert / epuncert / sota
  (z-score max) / highep_lowal, with ``calib`` (calibrated uncertainty
  keys), ``norm`` (box σ relative to the box), ``mean`` against max
  aggregation over an image's detections, ``perc`` class-balancing
  weights, and top-k / ``bottomk`` / ``nee`` (binned exploration and
  exploitation) selection;
* perceptual-hash pool pruning (pHash by a 2-D DCT, wHash by Haar
  averaging, Hamming distances), the gray image resized by
  ``ops.cv_ops.resize_area`` (cv2's INTER_AREA);
* the iterative budget loop with injected stages (train, export,
  calibrate, validate, optimise, infer) and resume from the artifacts of
  completed iterations.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from udal_tpu_torch.ops.cv_ops import resize_area

DEFAULT_BUDGET_STEPS = [5, 5, 5, 10, 20, 30, 25]   # percent per iteration


# ---------------------------------------------------------------------------
# Perceptual hashing
# ---------------------------------------------------------------------------

def _to_gray(image: np.ndarray) -> np.ndarray:
    if image.ndim == 3:
        return image[..., :3] @ np.asarray([0.299, 0.587, 0.114])
    return image.astype(np.float64)


def _resize_gray(gray: np.ndarray, size: int) -> np.ndarray:
    """INTER_AREA of the gray image in f32, to ``size`` x ``size``."""
    return resize_area(gray.astype(np.float32), (size, size)).astype(np.float64)


def phash(image: np.ndarray, hash_size: int = 8) -> np.ndarray:
    """DCT perceptual hash → bool[64]."""
    from scipy.fft import dct

    g = _resize_gray(_to_gray(image), hash_size * 4)
    d = dct(dct(g, axis=0, norm="ortho"), axis=1, norm="ortho")
    low = d[:hash_size, :hash_size]
    med = np.median(low)
    return (low > med).flatten()


def whash(image: np.ndarray, hash_size: int = 8) -> np.ndarray:
    """Haar wavelet hash → bool[64]."""
    size = hash_size * 4
    g = _resize_gray(_to_gray(image), size)
    # repeated 2x2 Haar LL decomposition down to hash_size
    while g.shape[0] > hash_size:
        g = 0.25 * (g[0::2, 0::2] + g[1::2, 0::2] + g[0::2, 1::2] +
                    g[1::2, 1::2])
    med = np.median(g)
    return (g > med).flatten()


def hamming(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.sum(a != b))


def prune_pool(images: Sequence[np.ndarray], max_distance: int = 10,
               method: str = "phash") -> List[int]:
    """Drop near-duplicate images; returns kept indices.

    Parity: `active_learning_loop.py:198-316` (prune/full_prune with
    phash/whash Hamming matrix).
    """
    fn = phash if method == "phash" else whash
    hashes = [fn(im) for im in images]
    kept: List[int] = []
    for i, h in enumerate(hashes):
        if all(hamming(h, hashes[j]) > max_distance for j in kept):
            kept.append(i)
    return kept


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def min_max_scaler(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    rng = x.max() - x.min()
    return (x - x.min()) / rng if rng > 0 else np.zeros_like(x)


def z_score_normalization(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    s = x.std()
    return (x - x.mean()) / s if s > 0 else np.zeros_like(x)


def _rel_box(det: Dict, key: str) -> float:
    box = np.asarray(det["bbox"], np.float64)
    sig = np.asarray(det[key], np.float64)
    h = box[2] - box[0]
    w = box[3] - box[1]
    denom = np.maximum(np.asarray([h, w, h, w]), 1e-6)  # degenerate clipped boxes
    return float(np.mean(sig / denom))


def _det_score_terms(det: Dict, strategy: str) -> List[float]:
    """Per-detection uncertainty terms for a strategy —
    parity `score_image` (`active_learning_loop.py:544-715`)."""
    calib = "calib" in strategy
    box_mode = "iso_perclscoo_" if calib else "uncalib_"
    cls_mode = "iso_percls_" if calib else "uncalib_"
    ent_key = "iso_percls_entropy" if calib else "entropy"

    if "combo" in strategy:
        return [det.get(ent_key, det.get("entropy", 0.0)) * 1.0]
    if "alluncert" in strategy or "sota" in strategy:
        return [_rel_box(det, box_mode + "mcbox"),
                _rel_box(det, box_mode + "albox"),
                float(np.mean(det[cls_mode + "mcclass"]))]
    if "epuncert" in strategy:
        return [_rel_box(det, box_mode + "mcbox"),
                float(np.mean(det[cls_mode + "mcclass"]))]
    if "ental" in strategy:
        return [_rel_box(det, box_mode + "albox"),
                float(det.get(ent_key, det.get("entropy", 0.0)))]
    # single-metric strategies: last name component picks the key
    metric = strategy.split("_")[-1]
    prefix = box_mode if "box" in strategy else (cls_mode if "class" in
                                                 strategy else "")
    key = prefix + metric
    if key in det:
        v = det[key]
        if "box" in strategy and "norm" in strategy:
            return [_rel_box(det, key)]
        if isinstance(v, float):
            return [v]
        return [float(np.mean(v))]
    return [float(det["det_score"])]


def score_images(rows: List[Dict], strategy: str,
                 opt_params: Optional[Sequence[float]] = None
                 ) -> Tuple[np.ndarray, List[List[float]], List[str]]:
    """Aggregate per-detection uncertainty into one score per image.

    Returns (scores [n_images], classes per image, image names).
    """
    by_image: Dict[str, List[Dict]] = {}
    order: List[str] = []
    for r in rows:
        name = r["image_name"]
        if name not in by_image:
            by_image[name] = []
            order.append(name)
        by_image[name].append(r)

    agg = np.mean if "mean" in strategy else np.max
    per_image: List = []
    classes: List[List[float]] = []
    multi = None
    for name in order:
        dets = by_image[name]
        classes.append([d["class"] for d in dets])
        if "combo" in strategy:
            p = opt_params if opt_params is not None else [0.5, 0.5]
            vals = []
            ent_key = "iso_percls_entropy" if "calib" in strategy else "entropy"
            box_key = ("iso_perclscoo_albox" if "calib" in strategy
                       else "uncalib_albox")
            for d in dets:
                vals.append(p[0] * d.get(ent_key, d.get("entropy", 0.0)) +
                            p[1] * _rel_box(d, box_key))
            per_image.append(float(agg(vals)))
            multi = False
        else:
            terms = [_det_score_terms(d, strategy) for d in dets]
            k = len(terms[0])
            multi = k > 1
            if multi:
                per_image.append([float(agg([t[j] for t in terms]))
                                  for j in range(k)])
            else:
                per_image.append(float(agg([t[0] for t in terms])))

    if multi:
        arr = np.asarray(per_image)            # [n, k]
        if "highep_lowal" in strategy:
            norm = np.stack([min_max_scaler(arr[:, j])
                             for j in range(arr.shape[1])])
            ep = norm[0] + norm[2]
            al = norm[1]
            scores = ep - al
        elif "sota" in strategy:
            scores = np.max(np.stack([z_score_normalization(arr[:, j])
                                      for j in range(arr.shape[1])]), axis=0)
        else:
            scores = np.sum(np.stack([min_max_scaler(arr[:, j])
                                      for j in range(arr.shape[1])]), axis=0)
    else:
        scores = np.asarray(per_image)
    return scores, classes, order


def select_images(rows: List[Dict], strategy: str, num_per_iter: int,
                  opt_params: Optional[Sequence[float]] = None,
                  rng: Optional[np.random.RandomState] = None) -> List[str]:
    """Pick the AL batch — parity `select_images`
    (`active_learning_loop.py:767-840`). Returns selected image names."""
    if strategy.startswith("random"):
        rng = rng or np.random.RandomState(0)
        names = sorted({r["image_name"] for r in rows})
        return list(rng.choice(names, min(num_per_iter, len(names)),
                               replace=False))

    scores, classes, names = score_images(rows, strategy, opt_params)
    return select_from_scores(scores, classes, names, strategy, num_per_iter)


def select_from_scores(scores: np.ndarray, classes: Sequence,
                       names: Sequence[str], strategy: str,
                       num_per_iter: int) -> List[str]:
    """Selection from per-image scores — shared by the dict path above and
    the array-native path (`apps.al_scoring.select_pool`)."""
    if "perc" in strategy:
        flat = np.concatenate([np.asarray(c) for c in classes])
        cls_names = np.unique(flat)
        dist = np.asarray([np.sum(flat == c) for c in cls_names], np.float64)
        weights_present = dist.sum() / dist
        max_cls = int(np.max(cls_names))
        weights = np.zeros(max_cls)
        for c, w in zip(cls_names, weights_present):
            weights[int(c) - 1] = w
        per_img_w = [np.mean([weights[int(c) - 1] for c in np.unique(ic)])
                     for ic in classes]
        scores = np.asarray(per_img_w) * scores

    names = np.asarray(names)
    if "nee" in strategy:
        n = 5
        batch = num_per_iter // n
        remainder = num_per_iter % n
        sel: List[int] = []
        sorted_idx = np.argsort(scores)
        bins = np.array_split(sorted_idx, n)
        for i in range(n - 1):
            sel.extend(bins[i][-batch:])
        sel.extend(bins[-1][:batch + remainder])
        return [str(x) for x in names[sel]]
    order = np.argsort(scores, kind="stable")
    if "bottomk" in strategy:
        picked = order[:num_per_iter]
    else:
        picked = order[-num_per_iter:]
    return [str(x) for x in names[picked]]


# ---------------------------------------------------------------------------
# Loop orchestration
# ---------------------------------------------------------------------------

class ActiveLearning:
    """Iterative acquisition loop (in-process).

    The reference drives training/export/calibration/inference through
    `subprocess.run("python -m ...")` with crash-resume polling
    (`active_learning_loop.py:952-1136`); here the stages are injected
    callables so the loop composes with the framework's train/serve APIs
    (and remains unit-testable). Artifacts per iteration land in
    ``<work_dir>/iter_<i>/``.
    """

    def __init__(self, pool_names: Sequence[str], work_dir: str,
                 scoring_strategy: str = "combo",
                 budget_steps: Sequence[float] = DEFAULT_BUDGET_STEPS,
                 train_fn: Optional[Callable] = None,
                 infer_fn: Optional[Callable] = None,
                 opt_params: Optional[Sequence[float]] = None,
                 export_fn: Optional[Callable] = None,
                 calibrate_fn: Optional[Callable] = None,
                 validate_fn: Optional[Callable] = None,
                 optimize_fn: Optional[Callable] = None,
                 train_done_fn: Optional[Callable] = None,
                 warmup_dir: Optional[str] = None,
                 max_train_retries: int = 3,
                 resume: bool = True,
                 seed: int = 0):
        """Stage callables mirror the reference's per-iteration subprocess
        pipeline (`active_learning_loop.py:411-526,917-1136`):

        train_fn(selected_names, iter_dir): (re)train on the selection.
        train_done_fn(iter_dir) -> bool: crash-resume probe — the reference
          polls for ``ckpt-<num_epochs>.index`` and relaunches training until
          it appears (`:1009-1097`); train_fn is retried while this is False
          (up to max_train_retries).
        export_fn(iter_dir): export the previous iteration's model (mode 0).
        calibrate_fn(iter_dir): fit calibrators (mode 2; only when 'calib'
          is in the strategy and no calibrators exist yet).
        validate_fn(iter_dir): write validate_results.txt (mode 3; only for
          'combo' strategies without optimal params yet).
        optimize_fn(iter_dir) -> opt_params: the MainUncertViz threshold
          optimization over validate_results.txt (`:917-949`).
        infer_fn(remaining_names, iter_dir) -> prediction rows (mode 6).
        warmup_dir: a completed iteration-0 directory from another strategy
          run — iteration 0 selections are random and identical across
          strategies, so its model/prediction artifacts are copied instead
          of retraining (`:1101-1136`).
        resume: skip iterations whose artifacts are already complete
          (crash-resume at the loop level).
        """
        self.pool = list(pool_names)
        self.work_dir = work_dir
        self.strategy = scoring_strategy
        self.budget_steps = list(budget_steps)
        self.train_fn = train_fn
        self.infer_fn = infer_fn
        self.opt_params = opt_params
        self.export_fn = export_fn
        self.calibrate_fn = calibrate_fn
        self.validate_fn = validate_fn
        self.optimize_fn = optimize_fn
        self.train_done_fn = train_done_fn
        self.warmup_dir = warmup_dir
        self.max_train_retries = max_train_retries
        self.resume = resume
        self.rng = np.random.RandomState(seed)
        self.selected: List[str] = []
        os.makedirs(work_dir, exist_ok=True)

    def _iter_dir(self, i: int) -> str:
        d = os.path.join(self.work_dir, f"iter_{i}")
        os.makedirs(d, exist_ok=True)
        return d

    def _iter_complete(self, i: int) -> bool:
        d = os.path.join(self.work_dir, f"iter_{i}")
        if not os.path.exists(os.path.join(d, "selected.txt")):
            return False
        if self.train_fn is None:
            return True
        return os.path.exists(os.path.join(d, "train_done"))

    def _combo_stage(self, i: int, it_dir: str) -> None:
        """Per-iteration export → calibrate → validate → threshold-optimize
        pipeline (the reference's `exp_calib_val_infer` + `MainUncertViz`
        combo scoring, `active_learning_loop.py:411-526,917-949`)."""
        prev_dir = self._iter_dir(i - 1)
        if self.export_fn is not None and \
                not os.path.exists(os.path.join(prev_dir, "export")):
            self.export_fn(prev_dir)
        if "calib" in self.strategy and self.calibrate_fn is not None and \
                not os.path.exists(os.path.join(prev_dir, "calibration")):
            self.calibrate_fn(prev_dir)
        if "combo" in self.strategy and self.optimize_fn is not None:
            params_file = os.path.join(prev_dir, "optimal_params.txt")
            if not os.path.exists(params_file):
                if self.validate_fn is not None:
                    self.validate_fn(prev_dir)
                params = list(self.optimize_fn(prev_dir))
                with open(params_file, "w") as f:
                    f.write(",".join(str(p) for p in params))
            with open(params_file) as f:
                self.opt_params = [float(x.strip("[] "))
                                   for x in f.read().split(",")]

    def _train_with_resume(self, i: int, it_dir: str) -> None:
        """Retrain until the checkpoint-complete probe passes — parity with
        the reference's retry-until-ckpt loops (`:1009-1097`)."""
        done = os.path.join(it_dir, "train_done")
        # warm-up reuse: iteration 0 is the same random selection for every
        # strategy, so a completed warm-up model is copied, not retrained
        if i == 0 and self.warmup_dir and \
                os.path.exists(os.path.join(self.warmup_dir, "train_done")):
            import shutil

            for name in os.listdir(self.warmup_dir):
                src = os.path.join(self.warmup_dir, name)
                dst = os.path.join(it_dir, name)
                if os.path.exists(dst):
                    continue
                if os.path.isdir(src):
                    shutil.copytree(src, dst)
                else:
                    shutil.copy2(src, dst)
            if os.path.exists(done):
                return
        probe = self.train_done_fn or (lambda d: os.path.exists(
            os.path.join(d, "train_done")))
        for _ in range(self.max_train_retries):
            self.train_fn(self.selected, it_dir)
            if self.train_done_fn is None:
                break
            if probe(it_dir):
                break
        with open(done, "w") as f:
            f.write("ok")

    def _select(self, rows, remaining: Sequence[str], k: int) -> List[str]:
        """Score + select from whatever ``infer_fn`` produced.

        The array route is a packed ``al_scoring.DetectionPool`` (the
        serve's arrays, no per-detection dicts); a list of
        prediction_data.txt dict rows is accepted as well, e.g. when
        resuming a loop from a previous run's text artifact. Both routes
        select the same images (``tests/test_torch_active_learning.py``)."""
        from udal_tpu_torch.apps import al_scoring as als

        if isinstance(rows, als.DetectionPool):
            pool = als.subset_pool(rows, remaining)
            return als.select_pool(pool, self.strategy, k,
                                   self.opt_params, self.rng)
        keep = set(remaining)
        rows = [r for r in rows if r["image_name"] in keep]
        return select_images(rows, self.strategy, k,
                             self.opt_params, self.rng)

    def run(self) -> List[str]:
        """Run all budget iterations; returns the final selected set."""
        total = len(self.pool)
        for i, pct in enumerate(self.budget_steps):
            it_dir = self._iter_dir(i)
            if self.resume and self._iter_complete(i):
                with open(os.path.join(it_dir, "selected.txt")) as f:
                    self.selected = [l for l in f.read().splitlines() if l]
                continue
            k = max(1, int(round(total * pct / 100.0)))
            chosen = set(self.selected)
            remaining = [n for n in self.pool if n not in chosen]
            if not remaining:
                break
            if i == 0 or self.strategy.startswith("random") \
                    or self.infer_fn is None:
                k = min(k, len(remaining))
                picks = list(self.rng.choice(remaining, k, replace=False))
            else:
                self._combo_stage(i, it_dir)
                rows = self.infer_fn(remaining, it_dir)
                picks = self._select(rows, remaining, k)
            self.selected.extend(picks)
            with open(os.path.join(it_dir, "selected.txt"), "w") as f:
                f.write("\n".join(self.selected))
            if self.train_fn is not None:
                self._train_with_resume(i, it_dir)
        return self.selected
