"""Offline uncertainty analysis: the validate-results thresholding pipeline
and the epistemic-vs-aleatoric grid.

Port of ``udal_tpu/apps/uncertainty_analysis.py``: read
``validate_results.txt``, relativize the box σ, select the uncertainties
named by ``thr_sel_uncert`` (ENT / ALBOX / MCBOX / MCCLASS), optimize their
combination and write optimal_params/optimal_thrs, the metric table and the
top-10 rows. The JAX package's spider plot and heatmap need matplotlib and
are not drawn; ``export_quadrant_crops`` (crops as PNG) raises
``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from udal_tpu_torch.apps.thresholding import (UncertOptimal, threshold_metrics,
                                              write_threshold_metrics)
from udal_tpu_torch.apps.validate import read_validate_results


def _safe_corr(a: Sequence[float], b: Sequence[float]) -> float:
    """Pearson correlation, 0.0 when degenerate — avoids numpy's
    divide-by-zero-stddev warning/nan, and treats ulp-level spread
    (constant data up to float rounding) as no correlation rather than
    returning a garbage ±1."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)

    def degenerate(x):
        return x.std() <= 1e-12 * max(1.0, float(np.abs(x).max()))

    if len(a) < 2 or degenerate(a) or degenerate(b):
        return 0.0
    return float(np.corrcoef(a, b)[0, 1])


def _relativize_rows(rows: List[Dict], key: str) -> np.ndarray:
    out = []
    for r in rows:
        box = np.asarray(r["bbox"], np.float64)
        sig = np.asarray(r[key], np.float64)
        h, w = box[2] - box[0], box[3] - box[1]
        out.append(np.mean(sig / np.asarray([h, w, h, w])))
    return np.asarray(out)


def select_uncertainties(rows: List[Dict], thr_sel_uncert: str
                         ) -> Dict[str, np.ndarray]:
    """The uncertainty columns named by ``thr_sel_uncert`` (ENT, ALBOX,
    MCBOX, MCCLASS substrings)."""
    out: Dict[str, np.ndarray] = {}
    if "ENT" in thr_sel_uncert and "entropy" in rows[0]:
        out["ENT"] = np.asarray([r["entropy"] for r in rows])
    if "ALBOX" in thr_sel_uncert and "uncalib_albox" in rows[0]:
        out["ALBOX"] = _relativize_rows(rows, "uncalib_albox")
    if "MCBOX" in thr_sel_uncert and "uncalib_mcbox" in rows[0]:
        out["MCBOX"] = _relativize_rows(rows, "uncalib_mcbox")
    if "MCCLASS" in thr_sel_uncert and "uncalib_mcclass" in rows[0]:
        out["MCCLASS"] = np.asarray(
            [np.mean(r["uncalib_mcclass"]) for r in rows])
    return out


class MainUncertAnalysis:
    """End-to-end thresholding pipeline over validate_results.txt."""

    def __init__(self, results_path: str, out_dir: str,
                 thr_sel_uncert: str = "ENTALBOX", fpr_tpr: float = 0.95,
                 fix_cd: bool = True, per_cls: bool = False, seed: int = 0):
        self.rows = read_validate_results(results_path)
        self.out_dir = out_dir
        self.thr_sel = thr_sel_uncert
        self.fpr_tpr = fpr_tpr
        self.fix_cd = fix_cd
        self.per_cls = per_cls
        self.seed = seed
        os.makedirs(out_dir, exist_ok=True)

    def run(self, max_evals: int = 300) -> Dict[str, object]:
        rows = self.rows
        ious = np.asarray([r["iou"] for r in rows])
        tps = np.asarray([float(r["class"] == r["gt_class"]) for r in rows])
        gt_classes = np.asarray([int(r["gt_class"]) for r in rows])
        uncerts = select_uncertainties(rows, self.thr_sel)
        if not uncerts:
            raise ValueError("no uncertainties found for "
                             f"{self.thr_sel!r} in validate results")

        uo = UncertOptimal(gt_classes=gt_classes, tps_class=tps, ious=ious,
                           uncert=list(uncerts.values()),
                           source_path=self.out_dir, per_cls=self.per_cls,
                           fpr_tpr=self.fpr_tpr, fix_cd=self.fix_cd,
                           seed=self.seed)
        params = uo.get_optimal_uncertainty(max_evals)

        combined = uo._combined(np.asarray(params))
        table = threshold_metrics({**uncerts, "COMBO": combined}, tps, ious,
                                  self.fpr_tpr, self.fix_cd)
        budget = "cd" if self.fix_cd else "fd"
        write_threshold_metrics(
            os.path.join(self.out_dir, f"thr_metrics_{budget}_"
                         f"{self.fpr_tpr}.txt"), table)
        self._write_top10(combined)
        return {"opt_params": params, "metrics": table}

    def _write_top10(self, combined) -> None:
        """The 10 rows with the largest combined uncertainty."""
        order = np.argsort(-combined)[:10]
        with open(os.path.join(self.out_dir, "top10_uncertain.txt"), "w") as f:
            for idx in order:
                f.write(repr(self.rows[int(idx)]) + "\n")


def epistemic_vs_aleatoric(rows: List[Dict],
                           epistemic_key: str = "uncalib_mcbox",
                           aleatoric_key: str = "uncalib_albox",
                           n_cells: int = 3
                           ) -> Dict[str, object]:
    """Quadrant/grid analysis of epistemic vs aleatoric uncertainty.

    Normalize both axes, split into an n x n grid, report per-cell counts,
    mean IoU and misclassification rate.
    """
    if aleatoric_key == "entropy":
        al = np.asarray([r["entropy"] for r in rows])
    else:
        al = _relativize_rows(rows, aleatoric_key)
    ep = _relativize_rows(rows, epistemic_key)

    def norm(x):
        rng = x.max() - x.min()
        return (x - x.min()) / rng if rng > 0 else np.zeros_like(x)

    al_n, ep_n = norm(al), norm(ep)
    edges = np.linspace(0, 1, n_cells + 1)
    cells = {}
    ious = np.asarray([r.get("iou", 0.0) for r in rows])
    mis = np.asarray([float(r["class"] != r["gt_class"]) for r in rows])
    for i in range(n_cells):
        for j in range(n_cells):
            m = ((ep_n >= edges[i]) & (ep_n <= edges[i + 1] if i == n_cells - 1
                                       else ep_n < edges[i + 1]) &
                 (al_n >= edges[j]) & (al_n <= edges[j + 1] if j == n_cells - 1
                                       else al_n < edges[j + 1]))
            cells[(i, j)] = {
                "count": int(m.sum()),
                "mean_iou": float(ious[m].mean()) if m.any() else float("nan"),
                "miscls_rate": float(mis[m].mean()) if m.any() else
                float("nan"),
            }
    corr = _safe_corr(ep, al) if len(rows) > 1 else 0.0
    return {"cells": cells, "correlation": corr, "epistemic": ep,
            "aleatoric": al}


def export_quadrant_crops(*args, **kwargs):
    """Per-cell detection crops saved as PNG with a quality score: not
    ported yet (ROADMAP A12)."""
    raise NotImplementedError("export_quadrant_crops: the crops' quality score needs the "
                              "JAX package's uncert_plots, not ported yet beside the port's "
                              "image codec (ROADMAP A12)")
