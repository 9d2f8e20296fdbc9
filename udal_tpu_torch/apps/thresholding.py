"""Cost-sensitive uncertainty thresholding / failure recognition.

Port of ``udal_tpu/apps/thresholding.py`` (arXiv 2404.17427): thresholds at
a fixed TPR budget (CD: correct detections kept) or FPR budget (FD) from
the ROC (``roc_metrics``); ``UncertOptimal``, the combination weights that
minimise mean FD@CD over IoU thresholds 0.5:0.05:0.75, cached and written
as ``optimal_params_*``/``optimal_thrs_*`` files the JAX package's parsers
read; the JSD / AUROC / FD@CD table per uncertainty.

The machine with the card has no sklearn, so ``roc_curve`` and ``auc`` are
the port's own, with sklearn's semantics: scores sorted descending, ties
collapsed to one threshold (``_binary_clf_curve``), collinear points
dropped (``drop_intermediate=True``), a leading threshold of ``inf`` (as
sklearn >= 1.3) and ``auc`` by trapezoids. Numpy on the host.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def roc_curve(y_true, y_score, pos_label=None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve(y_true,
    y_score, pos_label=pos_label)`` gives them. Without ``pos_label``,
    y_true must take values in {0, 1} or {-1, 1} and 1 is positive."""
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    if len(y_true) != len(y_score):
        raise ValueError(f"y_true and y_score differ in length: {len(y_true)}, {len(y_score)}")
    if not (np.all(np.isfinite(y_score)) and np.all(np.isfinite(y_true))):
        raise ValueError("Input contains NaN or infinity")
    if pos_label is None:
        classes = np.unique(y_true)
        if not any(np.array_equal(classes, c) for c in ([0, 1], [-1, 1], [0], [-1], [1])):
            raise ValueError(f"y_true takes values in {classes.tolist()} and pos_label is not "
                             f"specified")
        pos_label = 1
    positive = (y_true == pos_label).astype(np.float64)
    order = np.argsort(y_score, kind="stable")[::-1]    # ties collapse below: any order
    y_score, positive = y_score[order], positive[order]
    idx = np.concatenate([np.flatnonzero(np.diff(y_score)), [len(y_score) - 1]])
    tps = np.cumsum(positive)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    thresholds = y_score[idx]
    if len(fps) > 2:
        keep = np.concatenate([[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    if fps[-1] <= 0:
        warnings.warn("No negative samples in y_true, false positive value should be "
                      "meaningless", RuntimeWarning)
        fpr = np.full(fps.shape, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn("No positive samples in y_true, true positive value should be "
                      "meaningless", RuntimeWarning)
        tpr = np.full(tps.shape, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """Area under the curve (x, y) by trapezoids; x monotonic either way."""
    x = np.asarray(x).reshape(-1)
    y = np.asarray(y).reshape(-1)
    if x.shape[0] < 2:
        raise ValueError(f"At least 2 points are needed to compute area under curve, but "
                         f"x.shape = {x.shape}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    return float(direction * (dx * (y[1:] + y[:-1]) / 2.0).sum())


DEFAULT_IOU_THRS = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75]


def roc_metrics(uncert: np.ndarray, y_true: np.ndarray,
                fpr_tpr: float = 0.95, fix_cd: bool = True):
    """Threshold + error rate + AUC at a fixed budget.

    y_true: 1 = correct detection, 0 = failure; low uncertainty should
    indicate correctness (pos_label=0 on the ROC).

    Returns (threshold, error_at_budget, auc) or 0 when the budget is
    unreachable.
    """
    fpr, tpr, thresholds = roc_curve(y_true, uncert, pos_label=0)
    roc_auc = auc(fpr, tpr)
    if fix_cd:
        if np.all(fpr > 1 - fpr_tpr):
            return 0
        if np.all(fpr <= 1 - fpr_tpr):
            idxs = [i for i, x in enumerate(1 - fpr) if x >= 1]
            return (min(thresholds[i] for i in idxs),
                    min((1 - tpr)[i] for i in idxs), roc_auc)
        roc_fpr = 1 - np.interp(1 - fpr_tpr, fpr, tpr)
        idx = int(np.argmin(np.abs(1 - tpr - roc_fpr)))
        return thresholds[idx], roc_fpr, roc_auc
    if np.all(tpr < fpr_tpr):
        return 0
    if np.all(tpr >= fpr_tpr):
        idxs = [i for i, x in enumerate(tpr) if x >= 1]
        return (min(thresholds[i] for i in idxs),
                min(fpr[i] for i in idxs), roc_auc)
    fpr95 = np.interp(fpr_tpr, tpr, fpr)
    idx = int(np.argmin(np.abs(fpr - fpr95)))
    return thresholds[idx], fpr95, roc_auc


# ---------------------------------------------------------------------------
# Dependency-free sequential model-based optimizer
# ---------------------------------------------------------------------------

def minimize_smbo(f: Callable[[np.ndarray], float], num_params: int,
                  bounds: Tuple[float, float] = (0.0, 1.0),
                  max_evals: int = 600, patience: int = 300,
                  seed: int = 0) -> Tuple[np.ndarray, float]:
    """Minimize f over a box; seeded exploration + elite-Gaussian refinement."""
    rng = np.random.RandomState(seed)
    lo, hi = bounds
    X: List[np.ndarray] = []
    Y: List[float] = []
    best_y = np.inf
    unchanged = 0
    for it in range(max_evals):
        if it < max(20, max_evals // 10) or rng.rand() < 0.25:
            x = rng.uniform(lo, hi, num_params)
        else:
            elite_n = max(1, len(Y) // 10)
            elite_idx = np.argsort(Y)[:elite_n]
            center = X[int(rng.choice(elite_idx))]
            scale = (hi - lo) * max(0.02, 0.3 * (1 - it / max_evals))
            x = np.clip(center + rng.randn(num_params) * scale, lo, hi)
        y = float(f(x))
        X.append(x)
        Y.append(y)
        if y < best_y - 1e-12:
            best_y = y
            unchanged = 0
        else:
            unchanged += 1
            if unchanged >= patience:
                break
    best = int(np.argmin(Y))
    return X[best], Y[best]


# ---------------------------------------------------------------------------
# Optimal uncertainty combination
# ---------------------------------------------------------------------------

class UncertOptimal:
    """Optimal weighted combination of uncertainties for failure detection.

    Either read cached ``optimal_params_*`` or optimize and persist both
    the weight vector and the per-IoU thresholds.
    """

    def __init__(self, gt_classes=None, tps_class=None, ious=None,
                 uncert: Optional[Sequence[np.ndarray]] = None,
                 added_name: str = "", source_path: str = "",
                 per_cls: bool = False, fpr_tpr: float = 0.95,
                 fix_cd: bool = True,
                 iou_thrs: Sequence[float] = DEFAULT_IOU_THRS,
                 seed: int = 0):
        self.gt_classes = (np.asarray(gt_classes).astype(int)
                           if gt_classes is not None else None)
        self.tps_class = np.asarray(tps_class) if tps_class is not None else None
        self.ious = np.asarray(ious) if ious is not None else None
        self.uncert = ([np.asarray(u, np.float64) for u in uncert]
                       if uncert is not None else None)
        self.added_name = added_name
        self.source_path = source_path
        self.per_cls = per_cls
        self.fpr_tpr = fpr_tpr
        self.fix_cd = fix_cd
        self.iou_thrs = list(iou_thrs)
        self.seed = seed
        self.opt_params: Optional[np.ndarray] = None

    # -- file naming -------------------------------------------------------------
    def _budget(self) -> str:
        return "cd" if self.fix_cd else "fd"

    def _fname(self, kind: str) -> str:
        return os.path.join(
            self.source_path,
            f"{kind}_{self._budget()}_{self.fpr_tpr}_iou_"
            f"{np.min(self.iou_thrs)}_{np.max(self.iou_thrs)}"
            f"{self.added_name}.txt")

    # -- objective --------------------------------------------------------------
    def _combined(self, params: np.ndarray) -> np.ndarray:
        if self.per_cls:
            num_classes = int(np.max(self.gt_classes))
            total = np.zeros_like(self.uncert[0])
            n = 0
            for c in range(num_classes):
                mask = self.gt_classes == c + 1
                for u in self.uncert:
                    total[mask] += u[mask] * params[n]
                    n += 1
            return total
        return sum(p * u for p, u in zip(params, self.uncert))

    def _objective(self, params: np.ndarray) -> float:
        combined = self._combined(params)
        errs = []
        for thr in self.iou_thrs:
            correct = ((self.ious >= thr) * self.tps_class).astype(int)
            r = roc_metrics(combined, correct, self.fpr_tpr, self.fix_cd)
            err = r[1] if r != 0 else 1.0
            if np.isnan(err):
                err = 1.0
            errs.append(err * 100)
        return float(np.mean(errs))

    # -- public -------------------------------------------------------------------
    def optimize(self, max_evals: int = 600) -> np.ndarray:
        if self.per_cls:
            num_params = len(self.uncert) * int(np.max(self.gt_classes))
        else:
            num_params = len(self.uncert)
        best, _ = minimize_smbo(self._objective, num_params,
                                max_evals=max_evals, seed=self.seed)
        self.opt_params = best
        os.makedirs(self.source_path or ".", exist_ok=True)
        with open(self._fname("optimal_params"), "w") as f:
            # reference format: "[w0 w1 ...]" parsed by float(x.strip('[]'))
            f.write("[" + " ".join(repr(float(p)) for p in self.opt_params)
                    + "]")
        thrs = []
        combined = self._combined(self.opt_params)
        for thr in self.iou_thrs:
            correct = ((self.ious >= thr) * self.tps_class).astype(int)
            r = roc_metrics(combined, correct, self.fpr_tpr, self.fix_cd)
            thrs.append(r[0] if r != 0 else 0.0)
        with open(self._fname("optimal_thrs"), "w") as f:
            f.write("[" + " ".join(repr(float(t)) for t in thrs) + "]")
        return self.opt_params

    def get_optimal_uncertainty(self, max_evals: int = 600) -> np.ndarray:
        path = self._fname("optimal_params")
        if os.path.exists(path):
            with open(path) as f:
                self.opt_params = np.asarray(
                    [float(x.strip("[]")) for x in f.read().split()])
            return self.opt_params
        return self.optimize(max_evals)

    def _fdcd_subset(self, weights: np.ndarray, mask: np.ndarray) -> float:
        """Mean FD@CD over the IoU grid for one GT subset and weight set."""
        comb = sum(w * u[mask] for w, u in zip(weights, self.uncert))
        errs = []
        for thr in self.iou_thrs:
            correct = ((self.ious[mask] >= thr) *
                       self.tps_class[mask]).astype(int)
            r = roc_metrics(comb, correct, self.fpr_tpr, self.fix_cd)
            err = r[1] if r != 0 else 1.0
            errs.append((1.0 if np.isnan(err) else err) * 100)
        return float(np.mean(errs))

    def per_class_fixed_params(self, global_params: np.ndarray,
                               max_evals: int = 600) -> np.ndarray:
        """Per-class weight optimization with fixing.

        The "redo with fix" pass: per-class weights are optimized
        jointly, then each class whose class-specific weights do not beat
        the globally-optimal weights on its own FD@CD is fixed back to the
        global weights. Requires ``per_cls=True``.
        """
        if not self.per_cls:
            raise ValueError("per_class_fixed_params requires per_cls=True")
        perc = self.get_optimal_uncertainty(max_evals)
        nu = len(self.uncert)
        num_classes = int(np.max(self.gt_classes))
        global_params = np.asarray(global_params, np.float64)
        fixed = np.array(perc, np.float64)
        for i in range(num_classes):
            mask = self.gt_classes == i + 1
            if not mask.any():
                fixed[i * nu:(i + 1) * nu] = global_params
                continue
            w_cls = fixed[i * nu:(i + 1) * nu]
            if self._fdcd_subset(w_cls, mask) >= \
                    self._fdcd_subset(global_params, mask):
                fixed[i * nu:(i + 1) * nu] = global_params
        self.opt_params = fixed
        with open(self._fname("optimal_params_clsoptfix"), "w") as f:
            f.write("[" + " ".join(repr(float(p)) for p in fixed) + "]")
        return fixed


def read_optimal_thresholds(source_path: str, fpr_tpr: float = 0.95,
                            fix_cd: bool = True,
                            iou_thrs: Sequence[float] = DEFAULT_IOU_THRS,
                            added_name: str = "") -> np.ndarray:
    budget = "cd" if fix_cd else "fd"
    path = os.path.join(
        source_path, f"optimal_thrs_{budget}_{fpr_tpr}_iou_"
        f"{np.min(iou_thrs)}_{np.max(iou_thrs)}{added_name}.txt")
    with open(path) as f:
        return np.asarray([float(x.strip("[]"))
                           for x in f.read().split()])


# ---------------------------------------------------------------------------
# Metric tables (JSD / AUROC / FD@CD per uncertainty)
# ---------------------------------------------------------------------------

def jensen_shannon_divergence(a: np.ndarray, b: np.ndarray,
                              bins: int = 50) -> float:
    """Empirical JSD between two 1-D samples via shared histograms."""
    lo = min(a.min(), b.min()) if len(a) and len(b) else 0.0
    hi = max(a.max(), b.max()) if len(a) and len(b) else 1.0
    if hi <= lo:
        hi = lo + 1e-6
    pa, _ = np.histogram(a, bins=bins, range=(lo, hi), density=False)
    pb, _ = np.histogram(b, bins=bins, range=(lo, hi), density=False)
    pa = pa / max(pa.sum(), 1)
    pb = pb / max(pb.sum(), 1)
    m = 0.5 * (pa + pb)

    def kl(p, q):
        mask = p > 0
        return float(np.sum(p[mask] * np.log2(p[mask] / np.maximum(q[mask],
                                                                   1e-12))))

    return 0.5 * kl(pa, m) + 0.5 * kl(pb, m)


def threshold_metrics(uncertainties: Dict[str, np.ndarray],
                      tps_class: np.ndarray, ious: np.ndarray,
                      fpr_tpr: float = 0.95, fix_cd: bool = True,
                      iou_thrs: Sequence[float] = DEFAULT_IOU_THRS
                      ) -> Dict[str, Dict[str, float]]:
    """Per-uncertainty JSD / AUROC / mean error@budget table (the
    ``thr_metrics_*.txt`` rows)."""
    out: Dict[str, Dict[str, float]] = {}
    for name, u in uncertainties.items():
        u = np.asarray(u, np.float64)
        errs, aucs = [], []
        for thr in iou_thrs:
            correct = ((ious >= thr) * tps_class).astype(int)
            r = roc_metrics(u, correct, fpr_tpr, fix_cd)
            if r == 0:
                errs.append(100.0)
                aucs.append(0.5)
            else:
                errs.append(r[1] * 100)
                aucs.append(r[2])
        correct_05 = ((ious >= 0.5) * tps_class).astype(bool)
        jsd = jensen_shannon_divergence(u[correct_05], u[~correct_05]) \
            if correct_05.any() and (~correct_05).any() else 0.0
        metric = "FD@CD" if fix_cd else "CD@FD"
        out[name] = {"jsd": jsd, "auroc": float(np.mean(aucs)),
                     f"{metric}({fpr_tpr})": float(np.mean(errs))}
    return out


def write_threshold_metrics(path: str, table: Dict[str, Dict[str, float]]
                            ) -> None:
    with open(path, "w") as f:
        for name, metrics in table.items():
            f.write(f"{name}: {metrics}\n")
