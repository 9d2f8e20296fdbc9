"""Offline uncertainty analysis: the validate-results thresholding pipeline
and the epistemic-vs-aleatoric grid.

Port of ``udal_tpu/apps/uncertainty_analysis.py``: read
``validate_results.txt``, relativize the box σ, select the uncertainties
named by ``thr_sel_uncert`` (ENT / ALBOX / MCBOX / MCCLASS), optimize their
combination and write optimal_params/optimal_thrs, the metric table and the
top-10 rows. The JAX package's spider plot and FD@CD heatmap are written
as their numbers (``plots/spider.json``, ``plots/fdcd_heatmap.json``:
``utils.uncert_plots``). ``export_quadrant_crops`` writes each grid
cell's crops as PNG (``data.image_codec.write_png``) and correlates the
epistemic σ with a no-reference quality score.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from udal_tpu_torch.apps.thresholding import (DEFAULT_IOU_THRS, UncertOptimal, roc_metrics,
                                              threshold_metrics, write_threshold_metrics)
from udal_tpu_torch.apps.validate import read_validate_results
from udal_tpu_torch.data.image_codec import write_png
from udal_tpu_torch.utils.uncert_plots import brisque_like_score, metric_heatmap, spider_plot


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
        self._write_panels(table, uncerts, combined, tps, ious)
        return {"opt_params": params, "metrics": table}

    def fdcd_matrix(self, methods: Dict[str, np.ndarray], tps, ious) -> np.ndarray:
        """FD@CD (%) of each method [rows] at each IoU threshold of
        ``DEFAULT_IOU_THRS`` [columns] (100 where the ROC is degenerate)."""
        mat = []
        for u in methods.values():
            row = []
            for thr in DEFAULT_IOU_THRS:
                correct = ((ious >= thr) * tps).astype(int)
                r = roc_metrics(u, correct, self.fpr_tpr, self.fix_cd)
                row.append((r[1] if r != 0 else 1.0) * 100)
            mat.append(row)
        return np.asarray(mat)

    def _write_panels(self, table, uncerts, combined, tps, ious) -> None:
        """The spider plot's and the FD@CD heatmap's numbers under
        ``plots/``, and the 10 rows with the largest combined
        uncertainty."""
        plots = os.path.join(self.out_dir, "plots")
        spider_plot(table, os.path.join(plots, "spider.png"),
                    title=f"uncertainty comparison ({self.thr_sel})")
        methods = {**uncerts, "COMBO": combined}
        metric_heatmap(self.fdcd_matrix(methods, tps, ious),
                       [f"IoU{t:.2f}" for t in DEFAULT_IOU_THRS], list(methods),
                       os.path.join(plots, "fdcd_heatmap.png"),
                       title="FD@CD (%) per IoU threshold")
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


def export_quadrant_crops(rows: List[Dict], image_loader, out_dir: str, n_cells: int = 3,
                          per_cell: int = 5, epistemic_key: str = "uncalib_mcbox",
                          aleatoric_key: str = "uncalib_albox") -> Dict[str, object]:
    """``epistemic_vs_aleatoric``'s grid, plus up to ``per_cell`` box crops
    a cell written as ``out_dir/cell_<i>_<j>/crop_<k>.png`` and the
    correlation of the crops' epistemic σ with their
    ``brisque_like_score`` (0.0 with fewer than 3 crops).

    Args:
      image_loader: callable(image_name) -> RGB uint8 array (or None).
    """
    res = epistemic_vs_aleatoric(rows, epistemic_key, aleatoric_key, n_cells)
    ep, al = res["epistemic"], res["aleatoric"]

    def norm(x):
        rng = x.max() - x.min()
        return (x - x.min()) / rng if rng > 0 else np.zeros_like(x)

    ep_n, al_n = norm(ep), norm(al)
    cell_of = (np.minimum((ep_n * n_cells).astype(int), n_cells - 1),
               np.minimum((al_n * n_cells).astype(int), n_cells - 1))

    qualities, eps_used = [], []
    counts = {}
    for i in range(n_cells):
        for j in range(n_cells):
            idxs = np.where((cell_of[0] == i) & (cell_of[1] == j))[0]
            cell_dir = os.path.join(out_dir, f"cell_{i}_{j}")
            os.makedirs(cell_dir, exist_ok=True)
            saved = 0
            for idx in idxs[:per_cell]:
                r = rows[int(idx)]
                img = image_loader(r["image_name"])
                if img is None:
                    continue
                y1, x1, y2, x2 = [int(max(v, 0)) for v in r["bbox"]]
                crop = img[y1:y2 + 1, x1:x2 + 1]
                if crop.size == 0:
                    continue
                write_png(os.path.join(cell_dir, f"crop_{saved}.png"), crop)
                qualities.append(brisque_like_score(crop))
                eps_used.append(float(ep[int(idx)]))
                saved += 1
            counts[(i, j)] = saved

    corr = _safe_corr(eps_used, qualities) if len(qualities) > 2 else 0.0
    res["crop_counts"] = counts
    res["quality_epistemic_corr"] = corr
    return res
