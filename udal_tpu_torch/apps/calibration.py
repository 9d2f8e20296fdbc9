"""Uncertainty calibration: fitting, inference-time application, persistence.

Port of ``udal_tpu/apps/calibration.py``. Regression (box σ) calibrators:
iso_all, ts_all, iso_percoo, ts_percoo, iso_perclscoo, rel_iso_perclscoo;
classification calibrators: ts_all, ts_percls, iso_all, iso_percls, and
the same four fitted on 10 logit draws from N(logit, σ_mc) as ``unc_*``.

The machine with the card has neither sklearn nor JAX, so this module
carries its own:

* ``IsotonicRegression``: sklearn's fit and predict for the two
  constructions the JAX package uses (``increasing=True``,
  ``out_of_bounds="clip"``, with or without ``y_min``/``y_max``): sort by
  X (ties by y), merge X closer than the dtype's resolution into their
  weighted mean (sklearn's ``_make_unique``), pool adjacent violators
  (scipy's ``isotonic_regression``, the algorithm sklearn calls), clip,
  keep only the ends of runs of equal y, and predict by linear
  interpolation of the clipped query. A float32 X stays float32.
* the temperature fits in torch autograd on a given device, with the JAX
  loop's arithmetic (f32 loss, t₀ = 1, 100 steps of t ← t − 0.1·∂L/∂t).
* a calibrator format without pickle: one ``.npz`` a calibrator, in the
  JAX package's directory layout (``<dir>/{regression,classification}/
  <sub>_<name>.npz``). ``convert.calibrators_from_jax`` turns the JAX
  package's pickles into it.

The metrics and the application are numpy on the host, as in the JAX
package, which spills detections to the host for calibration.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy import stats


# ---------------------------------------------------------------------------
# Isotonic regression (sklearn's semantics, without sklearn)
# ---------------------------------------------------------------------------

def _make_unique(X: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sklearn's ``_make_unique`` on sorted X with unit weights: a new group
    starts where X is at least the dtype's resolution past the group's first
    value; a group keeps its first X, the mean of its y (summed in order in
    X's dtype) and its count."""
    dt = X.dtype.type
    eps = dt(np.finfo(X.dtype).resolution)
    start = np.ones(len(X), bool)
    cur, prev = 0, -2
    for j in np.flatnonzero(np.diff(X) < eps) + 1:
        if prev != j - 1:
            cur = j - 1            # X[j-1] starts a group: its gap to X[j-2] is >= eps
        if X[j] - X[cur] >= eps:
            cur = j
        else:
            start[j] = False
        prev = j
    starts = np.flatnonzero(start)
    counts = np.diff(np.append(starts, len(X)))
    y_out = y[starts].copy()
    for g in np.flatnonzero(counts > 1):
        s = starts[g]
        y_out[g] = np.cumsum(y[s:s + counts[g]], dtype=X.dtype)[-1] / dt(counts[g])
    return X[starts], y_out, counts.astype(X.dtype)


def _pava(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Pool adjacent violators, increasing, in float64: scipy's ``pava``
    (Busing 2022, Algorithm 1, with its >= at lines 11 and 22), step for
    step, so the block means round as scipy's do."""
    x = [float(v) for v in y]
    wt = [float(v) for v in w]
    n = len(x)
    r = [0] * (n + 1)
    r[1] = 1
    b = 0
    xb_prev, wb_prev = x[0], wt[0]
    i = 1
    while i < n:
        b += 1
        xb, wb = x[i], wt[i]
        if xb_prev >= xb:
            b -= 1
            sb = wb_prev * xb_prev + wb * xb
            wb += wb_prev
            xb = sb / wb
            while i < n - 1 and xb >= x[i + 1]:
                i += 1
                sb += wt[i] * x[i]
                wb += wt[i]
                xb = sb / wb
            while b > 0 and x[b - 1] >= xb:
                b -= 1
                sb += wt[b] * x[b]
                wb += wt[b]
                xb = sb / wb
        x[b] = xb_prev = xb
        wt[b] = wb_prev = wb
        r[b + 1] = i + 1
        i += 1
    out = np.empty(n, np.float64)
    for k in range(b + 1):
        out[r[k]:r[k + 1]] = x[k]
    return out


class IsotonicRegression:
    """sklearn's ``IsotonicRegression(increasing=True, out_of_bounds="clip",
    y_min=..., y_max=...)``: ``fit(X, y)``, ``predict(T)``,
    ``X_thresholds_``/``y_thresholds_``, ``X_min_``/``X_max_``."""

    def __init__(self, y_min: Optional[float] = None, y_max: Optional[float] = None):
        self.y_min = y_min
        self.y_max = y_max

    @staticmethod
    def _as_1d(a, dtype) -> np.ndarray:
        a = np.asarray(a, dtype)
        if not (a.ndim == 1 or (a.ndim == 2 and a.shape[1] == 1)):
            raise ValueError("Isotonic regression input X should be a 1d array or 2d array "
                             "with 1 feature")
        a = a.reshape(-1)
        if not np.all(np.isfinite(a)):
            raise ValueError("Input contains NaN or infinity")
        return a

    def fit(self, X, y) -> "IsotonicRegression":
        X = np.asarray(X)
        dtype = X.dtype if X.dtype in (np.float32, np.float64) else np.float64
        X = self._as_1d(X, dtype)
        y = np.asarray(y, dtype).reshape(-1)
        if len(X) != len(y) or len(X) == 0:
            raise ValueError(f"X and y need the same nonzero length, got {len(X)} and {len(y)}")
        order = np.lexsort((y, X))
        X, y, w = _make_unique(X[order], y[order])
        y = _pava(y, w).astype(dtype)
        lo = -np.inf if self.y_min is None else self.y_min
        hi = np.inf if self.y_max is None else self.y_max
        np.clip(y, lo, hi, y)
        self.X_min_, self.X_max_ = np.min(X), np.max(X)
        keep = np.ones(len(y), bool)
        keep[1:-1] = (y[1:-1] != y[:-2]) | (y[1:-1] != y[2:])
        self.X_thresholds_, self.y_thresholds_ = X[keep], y[keep]
        return self

    def predict(self, T) -> np.ndarray:
        """Linear interpolation of T clipped to [X_min_, X_max_], as
        scipy's ``interp1d`` computes it: ``np.interp`` in float64; slope
        times offset plus the left value in float32."""
        xs, ys = self.X_thresholds_, self.y_thresholds_
        T = np.clip(self._as_1d(T, xs.dtype), self.X_min_, self.X_max_)
        if len(ys) == 1:
            return ys.repeat(T.shape)
        if xs.dtype == np.float64:
            return np.interp(T, xs, ys)
        hi = np.clip(np.searchsorted(xs, T), 1, len(xs) - 1)
        lo = hi - 1
        slope = (ys[hi] - ys[lo]) / (xs[hi] - xs[lo])
        return (slope * (T - xs[lo]) + ys[lo]).astype(T.dtype)

    def state(self, suffix: str = "") -> Dict[str, np.ndarray]:
        """The fitted arrays, keyed for an ``.npz`` (``suffix`` tells
        several apart)."""
        return {f"X_thresholds{suffix}": self.X_thresholds_,
                f"y_thresholds{suffix}": self.y_thresholds_,
                f"X_bounds{suffix}": np.asarray([self.X_min_, self.X_max_]),
                f"y_bounds{suffix}": np.asarray([np.nan if v is None else v
                                                 for v in (self.y_min, self.y_max)], np.float64)}

    @classmethod
    def from_state(cls, d, suffix: str = "") -> "IsotonicRegression":
        y_min, y_max = (None if np.isnan(v) else float(v) for v in d[f"y_bounds{suffix}"])
        iso = cls(y_min, y_max)
        iso.X_thresholds_ = np.asarray(d[f"X_thresholds{suffix}"])
        iso.y_thresholds_ = np.asarray(d[f"y_thresholds{suffix}"])
        iso.X_min_, iso.X_max_ = d[f"X_bounds{suffix}"].astype(iso.X_thresholds_.dtype)
        return iso


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def calc_nll(residuals: np.ndarray, box_uncert: np.ndarray) -> float:
    """Gaussian NLL of residuals under predicted sigma."""
    nll = np.nan_to_num(stats.norm.logpdf(residuals, scale=box_uncert))
    return float(-np.sum(nll) / len(nll))


def calc_ece_regression(gt: np.ndarray, pred: np.ndarray,
                        sigma: np.ndarray, n_intervals: int = 100) -> float:
    """Interval-coverage ECE."""
    p_m = np.linspace(0, 1, n_intervals)
    emp = []
    for p in p_m:
        fit = np.abs(pred - gt) <= np.abs(sigma * stats.norm.ppf((1 - p) / 2))
        emp.append(np.mean(fit, axis=0))
    emp = np.asarray(emp)
    if gt.ndim == 1:
        return float(np.mean(np.abs(emp - p_m)))
    return float(np.mean(np.abs(emp - p_m[:, None])))


def regression_metrics(gt: np.ndarray, pred: np.ndarray, sigma: np.ndarray
                       ) -> Dict[str, float]:
    """%-in-±sigma, ECE, NLL, RMSUE, sharpness."""
    residuals = np.abs(pred - gt)
    in_1s = float(np.mean(residuals <= sigma))
    rmsue = float(np.sqrt(np.mean((residuals - sigma) ** 2)))
    return {
        "pct_within_1sigma": in_1s,
        "ece": calc_ece_regression(gt, pred, sigma),
        "nll": calc_nll(residuals.flatten(), sigma.flatten()),
        "rmsue": rmsue,
        "sharpness": float(np.mean(sigma)),
    }


def classification_metrics(y_true_onehot: np.ndarray, probs: np.ndarray,
                           n_bins: int = 10) -> Dict[str, float]:
    """ECE/MCE/ACE/NLL/Brier."""
    conf = probs.max(-1)
    correct = (probs.argmax(-1) == y_true_onehot.argmax(-1)).astype(float)
    bins = np.linspace(0, 1, n_bins + 1)
    ece = mce = 0.0
    ace_terms = []
    for i in range(n_bins):
        m = (conf > bins[i]) & (conf <= bins[i + 1])
        if m.sum() == 0:
            continue
        gap = abs(correct[m].mean() - conf[m].mean())
        ece += m.mean() * gap
        mce = max(mce, gap)
        ace_terms.append(gap)
    eps = 1e-12
    nll = float(-np.mean(np.sum(y_true_onehot * np.log(probs + eps), -1)))
    brier = float(np.mean(np.sum((probs - y_true_onehot) ** 2, -1)))
    return {"ece": float(ece), "mce": float(mce),
            "ace": float(np.mean(ace_terms)) if ace_terms else 0.0,
            "nll": nll, "brier": brier}


# ---------------------------------------------------------------------------
# Temperature-scaling fits (gradient descent in torch autograd)
# ---------------------------------------------------------------------------

def fit_temperature_regression(residuals: np.ndarray, sigma: np.ndarray,
                               loss: str = "mae", steps: int = 100,
                               lr: float = 0.1, device="cuda") -> float:
    """T minimizing the error between residuals and sigma/|T| (mae, mse or
    rmse), on ``device``: the loss in f32 at t rounded to f32, t itself in
    f64 as the JAX loop's Python float, kept on the device and read once at
    the end. Returns |T|."""
    dev = torch.device(device)
    res = torch.as_tensor(np.asarray(residuals, np.float32).reshape(-1), device=dev)
    sig = torch.as_tensor(np.asarray(sigma, np.float32).reshape(-1), device=dev)
    t = torch.ones((), dtype=torch.float64, device=dev)
    for _ in range(steps):
        tt = t.float().requires_grad_()
        scaled = torch.where(tt.abs() > 0, sig / tt.abs(), torch.zeros_like(sig))
        err = res - scaled
        if loss == "mae":
            value = err.abs().mean()
        elif loss == "mse":
            value = err.square().mean()
        else:
            value = err.square().mean().sqrt()
        (grad,) = torch.autograd.grad(value, tt)
        t -= lr * grad.double()
    return abs(t.item())


def fit_temperature_classification(y_true_onehot: np.ndarray,
                                   logits: np.ndarray, per_class: bool,
                                   steps: int = 100, lr: float = 0.1, device="cuda"):
    """T (an f32 scalar, or an f32 vector a class) minimizing the
    cross-entropy of logits/T, on ``device``: every step in f32 as the JAX
    loop's numpy update, t kept on the device and read once at the end."""
    dev = torch.device(device)
    y = torch.as_tensor(np.asarray(y_true_onehot, np.float32), device=dev)
    lg = torch.as_tensor(np.asarray(logits, np.float32), device=dev)
    t = torch.ones(logits.shape[-1] if per_class else (), dtype=torch.float32, device=dev)
    step = torch.tensor(lr, dtype=torch.float32, device=dev)
    for _ in range(steps):
        tt = t.detach().requires_grad_()
        value = -(y * torch.log_softmax(lg / tt, dim=-1)).sum(-1).mean()
        (grad,) = torch.autograd.grad(value, tt)
        t = t - step * grad
    out = t.cpu().numpy()
    return out if per_class else np.float32(out)


# ---------------------------------------------------------------------------
# Regression calibration (fit all six variants)
# ---------------------------------------------------------------------------

REGRESSION_CALIBRATORS = ["iso_all", "ts_all", "iso_percoo", "ts_percoo",
                          "iso_perclscoo", "rel_iso_perclscoo"]


def relativize(boxes: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    return sigma / np.stack([h, w, h, w], axis=1)


class RegressionCalib:
    """Fit all regression calibrators; the temperature fits on ``device``."""

    def __init__(self, gt_boxes: np.ndarray, pred_boxes: np.ndarray,
                 sigma: np.ndarray, gt_classes: np.ndarray,
                 num_classes: int, val_split: float = 0.8, device="cuda"):
        self.gt = np.asarray(gt_boxes, np.float64)
        self.pred = np.asarray(pred_boxes, np.float64)
        self.sigma = np.nan_to_num(np.asarray(sigma, np.float64))
        self.classes = np.asarray(gt_classes).astype(int)
        self.num_classes = num_classes
        self.split = int(val_split * len(self.gt))
        self.device = device

    @staticmethod
    def _iso(sigma, residuals) -> IsotonicRegression:
        return IsotonicRegression().fit(sigma, residuals)

    def _per_class(self, sigma, res) -> List[IsotonicRegression]:
        """Per class and coordinate; a class with fewer than 2 rows takes
        the coordinate's fit over all rows."""
        out = []
        for c in range(1, self.num_classes + 1):
            m = self.classes == c
            for j in range(4):
                out.append(self._iso(sigma[m, j], res[m, j]) if m.sum() >= 2
                           else self._iso(sigma[:, j], res[:, j]))
        return out

    def _ts(self, residuals, sigma) -> float:
        return fit_temperature_regression(residuals, sigma, device=self.device)

    def fit_all(self) -> Dict[str, Any]:
        res = np.abs(self.pred - self.gt)
        return {
            "iso_all": self._iso(self.sigma.flatten(), res.flatten()),
            "ts_all": self._ts(res, self.sigma),
            "iso_percoo": [self._iso(self.sigma[:, j], res[:, j]) for j in range(4)],
            "ts_percoo": [self._ts(res[:, j], self.sigma[:, j]) for j in range(4)],
            "iso_perclscoo": self._per_class(self.sigma, res),
            "rel_iso_perclscoo": self._per_class(relativize(self.pred, self.sigma),
                                                 relativize(self.pred, res)),
        }

    def metrics_before_after(self, calibrators: Dict[str, Any]
                             ) -> Dict[str, Dict[str, float]]:
        out = {"raw": regression_metrics(self.gt, self.pred, self.sigma)}
        cal = calibrators["iso_all"].predict(self.sigma.flatten()).reshape(-1, 4)
        out["iso_all"] = regression_metrics(self.gt, self.pred, cal)
        out["ts_all"] = regression_metrics(self.gt, self.pred,
                                           self.sigma / calibrators["ts_all"])
        return out


# ---------------------------------------------------------------------------
# Classification calibration (fit all eight variants)
# ---------------------------------------------------------------------------

def stable_softmax(x: np.ndarray) -> np.ndarray:
    z = x - np.max(x, axis=-1, keepdims=True)
    e = np.exp(z)
    return e / np.sum(e, axis=-1, keepdims=True)


class ClassificationCalib:
    """Fit the eight classification calibrators; the ``unc_*`` four on 10
    draws of ``rng`` (``RandomState(0)`` unless given), the temperature
    fits on ``device``."""

    def __init__(self, y_true: np.ndarray, logits: np.ndarray,
                 sigma_mc: Optional[np.ndarray], num_classes: int,
                 rng: Optional[np.random.RandomState] = None, device="cuda"):
        self.y_true = np.asarray(y_true).astype(int)       # class ids (1-based)
        self.logits = np.asarray(logits, np.float64)
        self.sigma_mc = (np.asarray(sigma_mc, np.float64)
                         if sigma_mc is not None else None)
        self.num_classes = num_classes
        self.rng = rng or np.random.RandomState(0)
        self.device = device

    def _onehot(self, y):
        oh = np.zeros((len(y), self.num_classes))
        valid = (y >= 1) & (y <= self.num_classes)
        oh[np.arange(len(y))[valid], y[valid] - 1] = 1.0
        return oh

    def _fit_four(self, y_onehot, logits) -> Dict[str, Any]:
        probs = stable_softmax(logits)

        def iso(p, y):
            return IsotonicRegression(y_min=0, y_max=1).fit(p, y)

        return {
            "ts_all": fit_temperature_classification(y_onehot, logits, False,
                                                     device=self.device),
            "ts_percls": fit_temperature_classification(y_onehot, logits, True,
                                                        device=self.device),
            "iso_all": iso(probs.flatten(), y_onehot.flatten()),
            "iso_percls": [iso(probs[:, i], y_onehot[:, i]) for i in range(self.num_classes)],
        }

    def fit_all(self) -> Dict[str, Any]:
        y_onehot = self._onehot(self.y_true)
        out = self._fit_four(y_onehot, self.logits)
        if self.sigma_mc is not None:
            samples = (self.logits[None] + self.rng.randn(
                10, *self.logits.shape) * self.sigma_mc[None])
            s_logits = samples.reshape(-1, self.logits.shape[-1])
            s_onehot = np.tile(y_onehot, (10, 1))
            unc = self._fit_four(s_onehot, s_logits)
            out.update({f"unc_{k}": v for k, v in unc.items()})
        return out


# ---------------------------------------------------------------------------
# Persistence: one .npz a calibrator, no pickle
# ---------------------------------------------------------------------------

def _encode(calib) -> Dict[str, np.ndarray]:
    """An isotonic fit, a list of them, or a value (a temperature, a list
    or array of temperatures) as named arrays."""
    if isinstance(calib, IsotonicRegression):
        return {"kind": np.asarray("isotonic"), **calib.state()}
    if isinstance(calib, (list, tuple)) and calib and \
            all(isinstance(c, IsotonicRegression) for c in calib):
        out = {"kind": np.asarray("isotonic_list"), "count": np.asarray(len(calib))}
        for i, c in enumerate(calib):
            out.update(c.state(f"_{i}"))
        return out
    return {"kind": np.asarray("value"), "value": np.asarray(calib)}


def _decode(d) -> Any:
    kind = str(d["kind"])
    if kind == "isotonic":
        return IsotonicRegression.from_state(d)
    if kind == "isotonic_list":
        return [IsotonicRegression.from_state(d, f"_{i}") for i in range(int(d["count"]))]
    if kind == "value":
        v = d["value"]
        return v[()] if v.ndim == 0 else v
    raise ValueError(f"unknown calibrator kind {kind!r}")


def save_calibrators(directory: str, regression: Dict[str, Any],
                     classification: Dict[str, Any]) -> None:
    """``<directory>/{regression,classification}/<sub>_<name>.npz``."""
    for sub, d in [("regression", regression), ("classification", classification)]:
        os.makedirs(os.path.join(directory, sub), exist_ok=True)
        for name, calib in d.items():
            np.savez(os.path.join(directory, sub, f"{sub}_{name}.npz"), **_encode(calib))


def load_calibrators(directory: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(regression, classification) as ``save_calibrators`` wrote them."""
    out: List[Dict[str, Any]] = [{}, {}]
    for i, sub in enumerate(["regression", "classification"]):
        d = os.path.join(directory, sub)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if not name.endswith(".npz"):
                continue
            with np.load(os.path.join(d, name), allow_pickle=False) as f:
                out[i][name[len(sub) + 1:-len(".npz")]] = _decode(f)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Inference-time application
# ---------------------------------------------------------------------------

class CalibrateBoxUncert:
    """Apply the regression calibrators (all present variants)."""

    def __init__(self, calibrators: Dict[str, Any], num_classes: int):
        self.c = calibrators
        self.num_classes = num_classes

    def __call__(self, sigma: np.ndarray, classes: np.ndarray,
                 boxes: np.ndarray) -> Dict[str, np.ndarray]:
        sigma = np.nan_to_num(np.asarray(sigma, np.float64))
        classes = np.asarray(classes).astype(int)
        out: Dict[str, np.ndarray] = {}
        if "iso_all" in self.c:
            out["iso_all"] = self.c["iso_all"].predict(sigma.flatten()).reshape(-1, 4)
        if "ts_all" in self.c:
            out["ts_all"] = sigma / self.c["ts_all"]
        if "iso_percoo" in self.c:
            out["iso_percoo"] = np.stack(
                [self.c["iso_percoo"][j].predict(sigma[:, j]) for j in range(4)], axis=1)
        if "ts_percoo" in self.c:
            out["ts_percoo"] = np.stack(
                [sigma[:, j] / self.c["ts_percoo"][j] for j in range(4)], axis=1)
        for key, rel in [("iso_perclscoo", False), ("rel_iso_perclscoo", True)]:
            if key not in self.c:
                continue
            calibs = np.asarray(self.c[key], dtype=object).reshape(self.num_classes, 4)
            src = relativize(boxes, sigma) if rel else sigma
            res = np.zeros_like(src)
            for ci in range(1, self.num_classes + 1):
                m = classes == ci
                if not np.any(m):
                    continue
                for j in range(4):
                    res[m, j] = calibs[ci - 1, j].predict(src[m, j])
            if rel:
                h = boxes[:, 2] - boxes[:, 0]
                w = boxes[:, 3] - boxes[:, 1]
                res = res * np.stack([h, w, h, w], axis=1)
            out[key] = res
        return out


class CalibrateClass:
    """Apply the classification calibrators: per variant the calibrated
    probabilities and their entropy."""

    def __init__(self, calibrators: Dict[str, Any], num_classes: int):
        self.c = calibrators
        self.num_classes = num_classes

    @staticmethod
    def _entropy(probs: np.ndarray) -> np.ndarray:
        p = np.clip(probs, 1e-12, 1.0)
        p = p / p.sum(-1, keepdims=True)
        return -np.sum(p * np.log(p), axis=-1)

    def _apply_one(self, name: str, key: str,
                   logits: np.ndarray) -> Dict[str, np.ndarray]:
        if name.startswith("ts"):
            probs = stable_softmax(logits / np.asarray(self.c[key]))
        else:
            probs = stable_softmax(logits)
            if name.endswith("all"):
                probs = self.c[key].predict(probs.flatten()).reshape(probs.shape)
            else:
                probs = np.stack([self.c[key][i].predict(probs[:, i])
                                  for i in range(self.num_classes)], axis=1)
        return {"probs": probs, "entropy": self._entropy(probs)}

    def __call__(self, logits: np.ndarray, uncert: np.ndarray = None,
                 n_samples: int = 10, seed: int = 0,
                 noise: np.ndarray = None
                 ) -> Dict[str, Dict[str, np.ndarray]]:
        """Apply all fitted calibrators.

        With ``uncert`` (the per-class MC logit σ), the ``unc_*``
        calibrators run on ``n_samples`` draws from N(logit, σ) (from
        ``RandomState(seed)``, or ``noise`` [n_samples, n, C]): probs = the
        mean over the draws, ``mcclass`` = their std, the entropy of the
        mean, under the unprefixed name. Without ``uncert`` the ``unc_*``
        calibrators apply to the logits under their own names.
        """
        logits = np.asarray(logits, np.float64)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        sampled = None
        if uncert is not None:
            if noise is None:
                noise = np.random.RandomState(seed).randn(n_samples, *logits.shape)
            uncert = np.nan_to_num(np.asarray(uncert, np.float64))
            sampled = logits[None] + noise * uncert[None]
            sampled = sampled.reshape(-1, logits.shape[-1])
        for name in ("ts_all", "ts_percls", "iso_all", "iso_percls"):
            if sampled is not None and "unc_" + name in self.c:
                r = self._apply_one(name, "unc_" + name, sampled)
                probs = r["probs"].reshape(n_samples, -1, logits.shape[-1])
                mean = probs.mean(axis=0)
                out[name] = {"probs": mean, "entropy": self._entropy(mean),
                             "mcclass": probs.std(axis=0)}
            elif name in self.c:
                out[name] = self._apply_one(name, name, logits)
            if uncert is None and "unc_" + name in self.c:
                out["unc_" + name] = self._apply_one(name, "unc_" + name, logits)
        return out


# ---------------------------------------------------------------------------
# GT assignment (for gathering calibration data)
# ---------------------------------------------------------------------------

def iou_matrix_corners(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    y1 = np.maximum(a[:, None, 0], b[None, :, 0])
    x1 = np.maximum(a[:, None, 1], b[None, :, 1])
    y2 = np.minimum(a[:, None, 2], b[None, :, 2])
    x2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def gt_box_assigner(gt_boxes: np.ndarray, pred_boxes: np.ndarray,
                    method: str = "IoU") -> Tuple[np.ndarray, np.ndarray]:
    """Best prediction per GT (IoU max or MSE min) and its IoU: (pred_idx
    per gt, iou per gt)."""
    if len(pred_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((0,), int), np.zeros((0,))
    iou = iou_matrix_corners(gt_boxes, pred_boxes)
    if method == "MSE":
        mse = np.mean((gt_boxes[:, None] - pred_boxes[None]) ** 2, axis=-1)
        idx = np.argmin(mse, axis=1)
    else:
        idx = np.argmax(iou, axis=1)
    return idx, iou[np.arange(len(gt_boxes)), idx]
