"""Pre-estimating the quality of an active-learning selection by dataset
similarity.

Port of ``udal_tpu/apps/al_eval.py``:

* per-class groundtruth-crop statistics: aspect ratio, mean 2-D DCT, the
  8x8x8 colour histogram (``ops.cv_ops.calc_hist_3d``: cv2's ``calcHist``
  counts), the gray crop resized by cv2's INTER_LINEAR in f32;
* the empirical Jensen–Shannon divergence between a selection's and a
  reference set's statistic distributions (scipy's KD-trees and Gaussian
  KDEs), combined with class-ratio terms;
* ranking of the methods and Kendall's tau with their per-class AP; the
  eval config rewritten for the next ranked model (read by the port's YAML
  reader, written as JSON, which is YAML) and metrics read from a run's
  ``metrics.jsonl``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import os

import numpy as np
from scipy.fft import dctn
from scipy.stats import kendalltau

from udal_tpu_torch.apps.thresholding import jensen_shannon_divergence
from udal_tpu_torch.ops.cv_ops import calc_hist_3d, rgb_to_gray
from udal_tpu_torch.ops.image_ops import resize_bilinear_float


def crop_statistics(image: np.ndarray, box: np.ndarray) -> Dict[str, object]:
    """Aspect ratio, mean 2-D DCT, 8x8x8 color histogram of one GT crop."""
    y1, x1, y2, x2 = [int(v) for v in box]
    crop = image[max(y1, 0):max(y2, y1 + 1), max(x1, 0):max(x2, x1 + 1)]
    if crop.size == 0:
        crop = image[:1, :1]
    h, w = crop.shape[:2]
    gray = rgb_to_gray(crop) if crop.ndim == 3 else crop
    gray32 = resize_bilinear_float(gray.astype(np.float32), (32, 32))
    dct = dctn(gray32, norm="ortho")
    hist = calc_hist_3d(crop.astype(np.uint8))
    hist = hist / max(hist.sum(), 1)
    return {"aspect": w / max(h, 1), "dct_mean": float(np.abs(dct).mean()),
            "hist": hist}


def collect_metrics(samples: Sequence[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]]
                    ) -> Dict[int, Dict[str, List]]:
    """Per-class crop statistics over (image, boxes, classes) samples —
    parity `collect_metrics` (`active_learning_eval.py:1034-1123`)."""
    out: Dict[int, Dict[str, List]] = {}
    for image, boxes, classes in samples:
        for box, cls in zip(boxes, classes):
            d = out.setdefault(int(cls), {"aspect": [], "dct": [],
                                          "hist": []})
            s = crop_statistics(image, box)
            d["aspect"].append(s["aspect"])
            d["dct"].append(s["dct_mean"])
            d["hist"].append(s["hist"])
    return out


def calculate_set_similarity(set_a: Dict[int, Dict[str, List]],
                             set_b: Dict[int, Dict[str, List]],
                             w_stats: float = 0.5, w_ratio: float = 0.5
                             ) -> float:
    """Similarity in [0, 1]: 1 - mean JSD over shared-class statistics,
    weighted with the class-ratio agreement —
    parity `calculate_set_similarity` (`active_learning_eval.py:946-1027`)."""
    shared = sorted(set(set_a) & set(set_b))
    if not shared:
        return 0.0
    jsds = []
    for c in shared:
        for key in ("aspect", "dct"):
            a = np.asarray(set_a[c][key])
            b = np.asarray(set_b[c][key])
            if len(a) and len(b):
                jsds.append(jensen_shannon_divergence(a, b, bins=20))
        ha = np.mean(np.asarray(set_a[c]["hist"]), axis=0)
        hb = np.mean(np.asarray(set_b[c]["hist"]), axis=0)
        m = 0.5 * (ha + hb)

        def kl(p, q):
            mask = p > 0
            return float(np.sum(p[mask] * np.log2(
                p[mask] / np.maximum(q[mask], 1e-12))))

        jsds.append(0.5 * kl(ha, m) + 0.5 * kl(hb, m))
    stat_sim = 1.0 - float(np.mean(jsds))

    counts_a = np.asarray([len(set_a[c]["aspect"]) for c in shared], float)
    counts_b = np.asarray([len(set_b[c]["aspect"]) for c in shared], float)
    ra = counts_a / counts_a.sum()
    rb = counts_b / counts_b.sum()
    ratio_sim = 1.0 - 0.5 * float(np.abs(ra - rb).sum())
    return w_stats * stat_sim + w_ratio * ratio_sim


# ---------------------------------------------------------------------------
# The full similarity machinery
# ---------------------------------------------------------------------------

def emp_kl_divergence(sample_p: np.ndarray, sample_q: np.ndarray) -> float:
    """Nearest-neighbour KL estimator for continuous samples (Pérez-Cruz
    2008) — parity `emp_KL_divergence` (`active_learning_eval.py:458-494`).

    sample_p/sample_q: [n, d] rows of samples.
    """
    from scipy.spatial import KDTree

    sample_p = np.asarray(sample_p, np.float64)
    sample_q = np.asarray(sample_q, np.float64)
    n_p, d = sample_p.shape
    n_q, d_q = sample_q.shape
    if d != d_q:
        raise ValueError("sample sets must share dimensionality")
    tree_p = KDTree(sample_p)
    tree_q = KDTree(sample_q)
    dist_p = tree_p.query(sample_p, k=2, eps=0.01, p=2)[0][:, 1]
    dist_q = tree_q.query(sample_p, k=1, eps=0.01, p=2)[0]
    return float(-np.log(dist_p / dist_q).sum() * d / n_p
                 + np.log(n_q / (n_p - 1)))


def empirical_jsd(P: np.ndarray, Q: np.ndarray, num_samples: int = 10000,
                  seed: int = 42) -> float:
    """Empirical Jensen–Shannon divergence between [n, d] sample sets —
    parity `empirical_jensen_shannon_divergence`
    (`active_learning_eval.py:497-585`): log-transform, per-set gaussian
    KDE, resample, KDE of the pooled samples as the midpoint M, then
    0.5*(KL(P||M)+KL(Q||M)) via the nearest-neighbour estimator."""
    from scipy.stats import gaussian_kde

    log_p = np.log(np.asarray(P, np.float64).T)
    log_q = np.log(np.asarray(Q, np.float64).T)
    log_p = log_p[:, np.all(np.isfinite(log_p), axis=0)]
    log_q = log_q[:, np.all(np.isfinite(log_q), axis=0)]
    if log_p.size == 0 or log_q.size == 0:
        raise ValueError("filtered data is empty, cannot build the KDE")
    kde_p = gaussian_kde(log_p)
    kde_q = gaussian_kde(log_q)
    s_p = kde_p.resample(size=num_samples, seed=seed)
    s_q = kde_q.resample(size=num_samples, seed=seed)
    kde_m = gaussian_kde(np.concatenate((s_p, s_q), axis=1))
    s_m = kde_m.resample(size=num_samples, seed=seed)
    samples_p, samples_q, samples_m = np.exp(s_p), np.exp(s_q), np.exp(s_m)
    return 0.5 * (emp_kl_divergence(samples_p.T, samples_m.T)
                  + emp_kl_divergence(samples_q.T, samples_m.T))


def collect_crop_metrics(samples: Sequence[Tuple[np.ndarray, np.ndarray,
                                                 Sequence]],
                         classes: Sequence) -> Dict[object, list]:
    """Per-class [3, n_crops] metric stack (aspect ratio, mean 2-D DCT,
    mean 8x8x8 color histogram) over GT crops — parity `collect_metrics`
    (`active_learning_eval.py:1034-1123`). Crops with min side <= 2 px are
    skipped; classes absent from a set stay []."""
    from scipy.fft import dct

    out: Dict[object, list] = {cl: [] for cl in classes}
    acc: Dict[object, List[list]] = {cl: [] for cl in classes}
    for image, boxes, labels in samples:
        image = np.asarray(image)
        for box, cl in zip(np.asarray(boxes), list(labels)):
            if cl not in acc:
                continue
            y1, x1, y2, x2 = map(int, box)
            crop = image[y1:y2, x1:x2, :]
            if crop.size == 0 or min(crop.shape[0], crop.shape[1]) <= 2:
                continue
            aspect = crop.shape[1] / crop.shape[0]
            avg_dct = float(np.mean(dct(dct(np.asarray(crop, np.float64),
                                            axis=0, norm="ortho"),
                                        axis=1, norm="ortho")))
            hist = calc_hist_3d(crop)
            acc[cl].append([aspect, avg_dct,
                            float(np.nan_to_num(np.mean(hist), nan=1))])
    for cl in classes:
        if acc[cl]:
            arr = np.asarray(acc[cl], np.float64).T    # [3, n]
            out[cl] = [arr[0], arr[1], arr[2]]
    return out


def calculate_set_similarity_full(crops_metrics_perc: Sequence[Dict],
                                  classes: Sequence, methods: Sequence[str],
                                  return_perclass: bool = False,
                                  num_samples: int = 10000):
    """Full reference similarity: per-class empirical JSD vs the reference
    set (the LAST entry) combined with class-ratio and class-weight terms —
    parity `calculate_set_similarity` (`active_learning_eval.py:946-1027`).

    Returns (sorted [(method, sim)], class-weighting-activated flag,
    per-class combined metrics when requested).
    """
    n_sets = len(crops_metrics_perc) - 1
    jsds, class_ratio = [], []
    for cl in classes:
        jt, ct = [], []
        val_data = np.asarray(crops_metrics_perc[-1][cl])
        for i in range(n_sets):
            if len(crops_metrics_perc[i][cl]) > 0:
                iter_data = np.asarray(crops_metrics_perc[i][cl])
                ct.append(len(crops_metrics_perc[-1][cl][0])
                          / len(crops_metrics_perc[i][cl][0]))
                jt.append(empirical_jsd(iter_data.T, val_data.T,
                                        num_samples=num_samples))
            else:
                ct.append(np.nan)
                jt.append(np.nan)
        class_ratio.append(ct)
        jsds.append(jt)

    total_dets = [np.sum([len(dist[cl][0]) if len(dist[cl]) > 0 else 0
                          for cl in classes])
                  for dist in crops_metrics_perc[:-1]]
    class_weights = np.mean(
        [[len(crops_metrics_perc[i][cl][0])
          if len(crops_metrics_perc[i][cl]) > 0 else 0
          for i in range(n_sets)] / np.asarray(total_dets)
         for cl in classes], axis=-1)
    classes_low_dets = class_weights < np.percentile(class_weights, 25)
    class_weights = 1 / class_weights
    activate = (np.round(np.nanstd(class_weights)
                         / np.nanmean(class_weights), 1) > 1.3)
    if activate:
        class_weights[classes_low_dets] = 0
    else:
        class_weights = np.ones_like(class_weights)
    beta = np.maximum(1, np.asarray(
        total_dets / np.percentile(total_dets, 25), dtype="int"))
    combined = []
    for c in range(len(classes)):
        m = np.add(jsds[c], 0.25 * (np.asarray(class_ratio[c]) * beta) + 0.5)
        m[np.isinf(m)] = np.nan
        combined.append(m)
    sim = np.nansum(1 / np.asarray(combined)
                    * class_weights.reshape([-1, 1]), axis=0) \
        / np.sum(class_weights)
    methods_sim = {methods[i]: sim[i] for i in range(len(methods))}
    ranked = sorted(methods_sim.items(), key=lambda x: x[1])
    return ranked, bool(activate), (combined if return_perclass else None)


def rank_correlation(similarities: Dict[str, float],
                     ap_scores: Dict[str, float]) -> Tuple[float, float]:
    """Kendall's tau between similarity-based and AP-based method rankings —
    parity `active_learning_eval.py:1126-1150`."""
    methods = sorted(set(similarities) & set(ap_scores))
    s = [similarities[m] for m in methods]
    a = [ap_scores[m] for m in methods]
    tau, p = kendalltau(s, a)
    return float(tau), float(p)


# ---------------------------------------------------------------------------
# Eval-config rewriting, metric scraping, Similarity pipeline
# ---------------------------------------------------------------------------

def update_eval_config(yaml_path: str, new_model_dir: str,
                       update_name=None, eval_samples: int = 0) -> None:
    """Rewrite an eval yaml for the next ranked model — parity
    `active_learning_eval.py:105-133`: swaps model_dir and optionally points
    val_file_pattern at a per-split ``_val_set<NAME>.tfrecord``."""
    from udal_tpu_torch.config import load_yaml, write_yaml

    data = load_yaml(yaml_path)
    data["model_dir"] = new_model_dir
    if update_name is not None:
        data["val_file_pattern"] = (
            data["val_file_pattern"].split("/_val")[0]
            + f"/_val_set{update_name}.tfrecord")
        data["eval_samples"] = int(eval_samples)
    write_yaml(yaml_path, data)


def extract_eval_metrics(log_dir: str) -> Dict[str, float]:
    """The last AP / AP50 / AP75 / val_loss / loss of a training run's
    ``<log_dir>/metrics.jsonl`` (what ``utils.metrics_writer`` writes).
    TensorBoard event files, which the JAX package also reads where
    TensorFlow is installed, are not read: the port writes none."""
    import json

    out: Dict[str, float] = {}
    jsonl = os.path.join(log_dir, "metrics.jsonl")
    if os.path.exists(jsonl):
        with open(jsonl) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                for k in ("AP", "AP50", "AP75", "val_loss", "loss"):
                    if k in rec:
                        out[k] = float(rec[k])
    return out


# eval config per dataset shorthand (`active_learning_eval.py:586-944` —
# the Similarity variants for KITTI / BDD / kCODA / bCODA map onto the
# shipped configs/eval files)
EVAL_CONFIG_BY_DATASET = {
    "k": "configs/eval/eval_k.yaml", "KITTI": "configs/eval/eval_k.yaml",
    "ks": "configs/eval/eval_ks.yaml",
    "kc": "configs/eval/eval_kc.yaml",
    "kCODA": "configs/eval/eval_cks.yaml",
    "cks": "configs/eval/eval_cks.yaml",
    "b": "configs/eval/eval_b.yaml", "BDD": "configs/eval/eval_b.yaml",
    "bs": "configs/eval/eval_bs.yaml",
    "bc": "configs/eval/eval_bc.yaml",
    "bCODA": "configs/eval/eval_cbs.yaml",
    "cbs": "configs/eval/eval_cbs.yaml",
}


class Similarity:
    """Pre-estimate AL-method quality from dataset similarity and rank.

    Redesign of the reference `Similarity` class
    (`active_learning_eval.py:586-944`): instead of hard-coded model-path
    lists, methods are given explicitly as {name: model_dir}; per-method
    AP comes from scraped training logs (or an injected eval callable), the
    per-method selected sets are compared to the reference set with the
    crop-statistics JSD similarity, and the two rankings are correlated
    with Kendall's tau.
    """

    def __init__(self, dataset: str, method_dirs: Dict[str, str],
                 performance: bool = True, n_iter: int = 1,
                 eval_fn=None):
        self.dataset = dataset
        self.method_dirs = dict(method_dirs)
        self.performance = performance
        self.n_iter = n_iter
        self.eval_fn = eval_fn
        self.eval_config = EVAL_CONFIG_BY_DATASET.get(dataset)

    def ap_by_method(self) -> Dict[str, float]:
        out = {}
        for name, mdir in self.method_dirs.items():
            if self.eval_fn is not None:
                out[name] = float(self.eval_fn(mdir))
                continue
            metrics = extract_eval_metrics(os.path.join(mdir, "logs"))
            if "AP" in metrics:
                out[name] = metrics["AP"]
        return out

    def run(self, samples_by_method: Dict[str, Sequence],
            reference_samples: Sequence) -> Dict[str, object]:
        """samples/reference: (image, boxes, classes) triples per method."""
        ref_stats = collect_metrics(reference_samples)
        sims = {name: calculate_set_similarity(
            collect_metrics(s), ref_stats)
            for name, s in samples_by_method.items()}
        aps = self.ap_by_method()
        shared = sorted(set(sims) & set(aps))
        ranking = sorted(shared, key=lambda m: -aps[m])
        tau, p = rank_correlation(sims, aps) if len(shared) >= 2 \
            else (float("nan"), float("nan"))
        return {"similarities": sims, "ap": aps, "ranking": ranking,
                "kendall_tau": tau, "p_value": p}
