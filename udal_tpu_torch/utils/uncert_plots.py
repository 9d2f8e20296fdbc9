"""Uncertainty analysis figures' numbers and the BRISQUE-style quality proxy.

Port of ``udal_tpu/utils/uncert_plots.py`` without matplotlib or cv2. The
numeric half is the JAX package's: the regression calibration curve
(scipy's normal quantiles), the MSCN coefficients (through
``ops.cv_ops.gaussian_blur_f64``, cv2's f64 Gaussian bit for bit) and the
quality score. The JAX package draws four figures with matplotlib, which
the machine with the card does not have; each writes its figure's numbers
instead, as JSON where the PNG would go (``<name>.json`` for
``<name>.png``), and returns what the JAX function returns:

* ``reliability_diagram``: the bins' accuracy, confidence and weight;
  returns ECE / MCE / ACE;
* ``regression_calibration_plot``: the coverage curve and the σ
  histogram; returns the miscalibration area, sharpness and RMSUE;
* ``spider_plot``: each method's axes normalised over the methods;
* ``metric_heatmap``: the matrix with its labels.

``top10_panel`` is a grid of images, so it stays a PNG: a contact sheet
(``utils.visualize.contact_sheet``, each image captioned with its label).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from udal_tpu_torch.data.image_codec import write_png
from udal_tpu_torch.ops.cv_ops import gaussian_blur_f64
from udal_tpu_torch.utils.visualize import contact_sheet


def _json_path(path: str) -> str:
    return os.path.splitext(path)[0] + ".json"


def _write_json(path: str, payload: Dict) -> str:
    """``payload`` at ``path`` with its extension made ``.json`` (NaN and
    infinities written as null); returns the path written."""
    out = _json_path(path)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)

    def clean(v):
        if isinstance(v, np.ndarray):
            v = v.tolist()
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        if isinstance(v, (float, np.floating)):
            return float(v) if np.isfinite(v) else None
        if isinstance(v, np.integer):
            return int(v)
        return v

    with open(out, "w") as f:
        json.dump(clean(payload), f)
    return out


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    """numpy's trapezoidal rule, term for term."""
    d = np.diff(x)
    return float(np.add.reduce(d * (y[1:] + y[:-1]) / 2.0))


# ---------------------------------------------------------------------------
# Classification reliability
# ---------------------------------------------------------------------------

def reliability_diagram(correct: np.ndarray, confidence: np.ndarray,
                        path: str, bins: int = 15,
                        title: str = "reliability") -> Dict[str, float]:
    """Confidence-vs-accuracy reliability numbers over ``bins`` equal bins
    of (lo, hi]; returns ECE / MCE / ACE."""
    correct = np.asarray(correct, float)
    confidence = np.asarray(confidence, float)
    edges = np.linspace(0, 1, bins + 1)
    accs, confs, weights = [], [], []
    n = max(len(correct), 1)
    for i in range(bins):
        m = (confidence > edges[i]) & (confidence <= edges[i + 1])
        if m.any():
            accs.append(correct[m].mean())
            confs.append(confidence[m].mean())
            weights.append(m.sum() / n)
        else:
            accs.append(np.nan)
            confs.append((edges[i] + edges[i + 1]) / 2)
            weights.append(0.0)
    accs_a = np.asarray(accs)
    confs_a = np.asarray(confs)
    w = np.asarray(weights)
    gaps = np.abs(accs_a - confs_a)
    valid = ~np.isnan(accs_a)
    ece = float(np.nansum(w[valid] * gaps[valid]))
    mce = float(np.nanmax(gaps[valid])) if valid.any() else 0.0
    ace = float(np.nanmean(gaps[valid])) if valid.any() else 0.0
    _write_json(path, {"title": title, "edges": edges, "accuracy": accs_a,
                       "confidence": confs_a, "weight": w,
                       "ECE": ece, "MCE": mce, "ACE": ace})
    return {"ECE": ece, "MCE": mce, "ACE": ace}


# ---------------------------------------------------------------------------
# Regression calibration
# ---------------------------------------------------------------------------

def regression_calibration_curve(residuals: np.ndarray, sigma: np.ndarray,
                                 num_points: int = 100):
    """(expected, observed) Gaussian central-interval coverage curve."""
    from scipy import stats

    residuals = np.abs(np.asarray(residuals, float).ravel())
    sigma = np.maximum(np.asarray(sigma, float).ravel(), 1e-12)
    exp_p = np.linspace(0.01, 0.99, num_points)
    z = stats.norm.ppf(0.5 + exp_p / 2)          # central interval half-width
    obs_p = np.asarray([(residuals <= zi * sigma).mean() for zi in z])
    return exp_p, obs_p


def regression_calibration_plot(residuals: np.ndarray, sigma: np.ndarray,
                                path: str, title: str = "calibration"
                                ) -> Dict[str, float]:
    """Average-calibration curve and σ histogram (40 bins) as numbers;
    returns the miscalibration area, sharpness and RMSUE."""
    exp_p, obs_p = regression_calibration_curve(residuals, sigma)
    miscal = _trapezoid(np.abs(obs_p - exp_p), exp_p)
    sharpness = float(np.sqrt(np.mean(np.square(sigma))))
    rmsue = float(np.sqrt(np.mean(
        np.square(np.abs(residuals).ravel() - np.asarray(sigma).ravel()))))
    counts, hist_edges = np.histogram(np.asarray(sigma).ravel(), bins=40)
    _write_json(path, {"title": title, "expected": exp_p, "observed": obs_p,
                       "sigma_histogram": {"counts": counts, "edges": hist_edges},
                       "miscal_area": miscal, "sharpness": sharpness, "rmsue": rmsue})
    return {"miscal_area": miscal, "sharpness": sharpness, "rmsue": rmsue}


# ---------------------------------------------------------------------------
# Thresholding panels
# ---------------------------------------------------------------------------

def spider_plot(metrics_by_method: Dict[str, Dict[str, float]],
                path: str, title: str = "uncertainty comparison") -> str:
    """Each method's metrics on the union of their names (sorted), each
    axis min-max normalised over the methods (0.5 where they all agree);
    returns the path written."""
    methods = list(metrics_by_method)
    axes_names = sorted({k for m in metrics_by_method.values() for k in m})
    normalised = {}
    for name in methods:
        vals = []
        for k in axes_names:
            col = [metrics_by_method[m].get(k, 0.0) for m in methods]
            lo, hi = min(col), max(col)
            v = metrics_by_method[name].get(k, 0.0)
            vals.append(0.5 if hi <= lo else (v - lo) / (hi - lo))
        normalised[name] = vals
    return _write_json(path, {"title": title, "axes": axes_names, "methods": normalised})


def metric_heatmap(matrix: np.ndarray, xlabels: Sequence[str],
                   ylabels: Sequence[str], path: str,
                   title: str = "") -> str:
    """The matrix [len(ylabels), len(xlabels)] with its labels; returns
    the path written."""
    return _write_json(path, {"title": title, "xlabels": list(xlabels),
                              "ylabels": list(ylabels),
                              "matrix": np.asarray(matrix, float)})


def top10_panel(images: List[np.ndarray], labels: List[str], path: str,
                title: str = "top uncertainty") -> str:
    """The images as one contact-sheet PNG at ``path``, five a row, each
    captioned with its label."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, contact_sheet(images, cols=5, labels=labels))
    return path


# ---------------------------------------------------------------------------
# BRISQUE-style quality proxy
# ---------------------------------------------------------------------------

def mscn_coefficients(gray: np.ndarray, sigma: float = 7.0 / 6.0
                      ) -> np.ndarray:
    """Mean-subtracted contrast-normalized coefficients (the BRISQUE core)."""
    gray = np.asarray(gray, np.float64)
    mu = gaussian_blur_f64(gray, 7, sigma)
    mu_sq = mu * mu
    var = gaussian_blur_f64(gray * gray, 7, sigma) - mu_sq
    sd = np.sqrt(np.abs(var))
    return (gray - mu) / (sd + 1.0)


def _pristine_distance(m: np.ndarray) -> float:
    """Distance of the MSCN feature vector (variance, kurtosis proxy,
    pairwise product asymmetries) from pristine natural-scene statistics."""
    feats = [np.var(m),
             np.mean(np.abs(m)) ** 2 / max(np.mean(m * m), 1e-12)]
    for (dy, dx) in ((0, 1), (1, 0), (1, 1), (1, -1)):
        h, w = m.shape[0] - abs(dy), m.shape[1] - abs(dx)
        a = m[:h, :w]
        b = np.roll(np.roll(m, -dy, axis=0), -dx, axis=1)[:h, :w]
        feats.append(np.mean(a * b))
    feats = np.asarray(feats, np.float64)
    # pristine natural-image MSCN statistics (variance ~1, shape ratio
    # ~0.64 for a unit-variance GGD with beta=2, small positive pairwise
    # correlations)
    pristine = np.asarray([1.0, 0.64, 0.30, 0.30, 0.12, 0.12])
    scale = np.asarray([0.25, 0.15, 0.25, 0.25, 0.15, 0.15])
    return float(np.sqrt(np.mean(((feats - pristine) / scale) ** 2)))


def brisque_like_score(image: np.ndarray) -> float:
    """No-reference quality score, higher = more distorted: the MSCN
    features' distance from pristine statistics, plus evidence of
    neighbour decorrelation (noise), a monotone MSCN-variance term and the
    clipped-pixel fraction. Only the ranking means anything
    (``docs/BRISQUE_PROXY.md``)."""
    img = np.asarray(image)
    if img.ndim == 3:
        gray = img[..., :3] @ np.asarray([0.299, 0.587, 0.114])
    else:
        gray = img.astype(np.float64)
    m = mscn_coefficients(gray)
    v = max(float(np.var(m)), 1e-9)
    corrs = []
    for (dy, dx) in ((0, 1), (1, 0)):
        h, w = m.shape[0] - abs(dy), m.shape[1] - abs(dx)
        a = m[:h, :w]
        b = np.roll(np.roll(m, -dy, axis=0), -dx, axis=1)[:h, :w]
        corrs.append(float(np.mean(a * b)) / v)
    clip_frac = float(np.mean((img >= 250) | (img <= 5)))
    return (_pristine_distance(m)
            + 10.0 * max(0.0, 0.35 - min(corrs))
            + 3.0 * float(np.log10(1.0 + v))
            + 3.0 * clip_frac)
