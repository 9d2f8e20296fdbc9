"""The port's thresholding, label maps and offline analysis against sklearn
and the JAX package's, on the CPU.

``roc_curve`` and ``auc`` equal sklearn's (drawn inputs with ties, both
positive labels; the thresholds, fpr and tpr bit for bit, which is within
1e-12 in f64 and bit-equal in f32). The rest is the JAX package's numpy
logic on the port's ROC: equal results and equal files.
"""

import os
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from sklearn.metrics import auc as sk_auc  # noqa: E402
from sklearn.metrics import roc_curve as sk_roc_curve  # noqa: E402

import udal_tpu.apps.thresholding as jax_thr  # noqa: E402
import udal_tpu.apps.uncertainty_analysis as jax_ua  # noqa: E402
import udal_tpu.data.label_maps as jax_maps  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.apps import thresholding as thr  # noqa: E402
from udal_tpu_torch.apps import uncertainty_analysis as ua  # noqa: E402
from udal_tpu_torch.data import label_maps  # noqa: E402


def roc_equal(y, s, pos_label):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = sk_roc_curve(y, s, pos_label=pos_label)
        got = thr.roc_curve(y, s, pos_label=pos_label)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if np.all(np.isfinite(want[0])) and np.all(np.isfinite(want[1])):
        assert thr.auc(got[0], got[1]) == sk_auc(want[0], want[1])


@settings(max_examples=200, deadline=None)
@given(data=st.lists(st.tuples(st.integers(0, 1),
                               st.one_of(st.sampled_from([0.0, 0.1, 0.5, 1.0]),
                                         st.floats(-10, 10, allow_nan=False, width=32))),
                     min_size=1, max_size=50),
       dtype=st.sampled_from([np.float32, np.float64]), pos_label=st.sampled_from([0, 1]))
def test_roc_curve_equals_sklearn(data, dtype, pos_label):
    """Tied scores (four values half of the time), one class only (nan
    rates, as sklearn), collinear points dropped, the leading inf."""
    y = np.asarray([d[0] for d in data])
    s = np.asarray([d[1] for d in data], dtype)
    roc_equal(y, s, pos_label)


@pytest.mark.parametrize("labels", [[0, 1], [-1, 1]])
def test_roc_curve_default_positive_label(labels):
    rng = np.random.RandomState(0)
    y = np.asarray(labels)[rng.randint(0, 2, 300)]
    roc_equal(y, rng.uniform(0, 1, 300), None)
    with pytest.raises(ValueError):
        thr.roc_curve([0, 2, 1], [0.1, 0.2, 0.3])


def test_auc_matches_sklearn_both_directions():
    x = np.asarray([0.0, 0.2, 0.2, 0.7, 1.0])
    y = np.asarray([0.0, 0.4, 0.5, 0.9, 1.0])
    assert thr.auc(x, y) == sk_auc(x, y)
    assert thr.auc(x[::-1], y[::-1]) == sk_auc(x[::-1], y[::-1])
    with pytest.raises(ValueError):
        thr.auc([0.0, 1.0, 0.5], [0.0, 1.0, 1.0])


def failure_data(seed=0, n=400, num_classes=3):
    """Two uncertainties, one informative of failure; IoUs and class hits."""
    rng = np.random.RandomState(seed)
    ious = rng.uniform(0.3, 1.0, n)
    tps = (rng.uniform(0, 1, n) < 0.8).astype(float)
    bad = (ious < 0.6) | (tps == 0)
    u0 = rng.uniform(0, 1, n) + bad * rng.uniform(0.2, 1.0, n)
    u1 = rng.uniform(0, 1, n)
    classes = rng.randint(1, num_classes + 1, n)
    return classes, tps, ious, [u0, u1]


@pytest.mark.parametrize("fix_cd", [True, False])
@pytest.mark.parametrize("budget", [0.95, 0.8])
def test_roc_metrics_match_jax(fix_cd, budget):
    _, tps, ious, (u0, u1) = failure_data()
    for u in (u0, u1, np.round(u0, 1)):
        for thr_iou in (0.5, 0.7):
            correct = ((ious >= thr_iou) * tps).astype(int)
            assert thr.roc_metrics(u, correct, budget, fix_cd) == \
                jax_thr.roc_metrics(u, correct, budget, fix_cd)


def test_minimize_smbo_matches_jax():
    f = lambda x: float(np.sum((x - 0.3) ** 2))  # noqa: E731
    got = thr.minimize_smbo(f, 3, max_evals=200, patience=50, seed=4)
    want = jax_thr.minimize_smbo(f, 3, max_evals=200, patience=50, seed=4)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def read_files(directory):
    """{name: contents} of the files (not the folders) in ``directory``."""
    paths = (os.path.join(directory, n) for n in sorted(os.listdir(directory)))
    return {os.path.basename(p): open(p).read() for p in paths if os.path.isfile(p)}


@pytest.mark.parametrize("per_cls", [False, True])
def test_uncert_optimal_matches_jax(tmp_path, per_cls):
    """The weights, the thresholds and the files they are written to (names
    and contents); then the cache is read back, and the per-class pass
    with fixing."""
    classes, tps, ious, uncert = failure_data(1)
    out = {}
    for name, mod in (("jax", jax_thr), ("port", thr)):
        uo = mod.UncertOptimal(classes, tps, ious, uncert, source_path=str(tmp_path / name),
                               per_cls=per_cls, added_name="_k")
        params = uo.optimize(max_evals=120)
        cached = mod.UncertOptimal(classes, tps, ious, uncert, source_path=str(tmp_path / name),
                                   per_cls=per_cls, added_name="_k").get_optimal_uncertainty()
        fixed = uo.per_class_fixed_params(params[:2], max_evals=120) if per_cls else None
        out[name] = (params, cached, fixed, read_files(tmp_path / name),
                     mod.read_optimal_thresholds(str(tmp_path / name), added_name="_k"))
    for g, w in zip(out["port"], out["jax"]):
        if isinstance(w, dict):
            assert g == w
        elif w is not None:
            np.testing.assert_array_equal(g, w)
    assert "optimal_thrs_cd_0.95_iou_0.5_0.75_k.txt" in out["port"][3]


def test_threshold_metrics_and_jsd_match_jax(tmp_path):
    _, tps, ious, (u0, u1) = failure_data(2)
    table = thr.threshold_metrics({"A": u0, "B": u1}, tps, ious)
    assert table == jax_thr.threshold_metrics({"A": u0, "B": u1}, tps, ious)
    assert thr.threshold_metrics({"A": u0}, tps, ious, 0.9, False) == \
        jax_thr.threshold_metrics({"A": u0}, tps, ious, 0.9, False)
    assert thr.jensen_shannon_divergence(u0, u1) == jax_thr.jensen_shannon_divergence(u0, u1)
    thr.write_threshold_metrics(str(tmp_path / "port.txt"), table)
    jax_thr.write_threshold_metrics(str(tmp_path / "jax.txt"), table)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_label_maps_match_jax(tmp_path):
    """Registry names, dicts and yaml files (read by the port's own YAML
    reader) give the JAX package's maps; yaml outside the reader's flat
    subset raises."""
    for name in ("KITTI", "BDD", "COCO", "VOC", "WAYMO"):
        assert getattr(label_maps, name) == getattr(jax_maps, name)
    for name in ("kitti", "bdd", "coco", "voc", "waymo"):
        assert label_maps.get_label_map(name) == jax_maps.get_label_map(name)
    assert label_maps.get_label_map(None) is None
    assert label_maps.get_label_map({1: "a"}) == {1: "a"}
    path = tmp_path / "label_map.yaml"
    path.write_text("# a label map\n1: car\n2: 'van'\n3: \"truck\"  # quoted\n")
    assert label_maps.get_label_map(str(path)) == jax_maps.get_label_map(str(path)) == \
        {1: "car", 2: "van", 3: "truck"}
    path.write_text("classes:\n  1: car\n")
    with pytest.raises(ValueError, match="YAML"):
        label_maps.get_label_map(str(path))


@pytest.mark.parametrize("path", ["models/KITTI_test", "/data/BDD100K/val", "runs/CODA_x",
                                  "somewhere/else"])
@pytest.mark.parametrize("im_name", [None, "000042.png"])
def test_dataset_data_matches_jax(path, im_name):
    assert label_maps.get_dataset_data(path, im_name) == jax_maps.get_dataset_data(path, im_name)
    for val in (False, True):
        assert label_maps.available_datasets(val) == jax_maps.available_datasets(val)


def test_get_ocl_trc_matches_jax(tmp_path):
    root = tmp_path / "KITTI"
    (root / "training" / "label_2").mkdir(parents=True)
    (root / "training" / "label_2" / "000001.txt").write_text(
        "Car 0.10 1 -1 0 0 10 10 0 0 0 0 0 0 0\nDontCare -1 -1 -1 0 0 0 0 0 0 0 0 0 0 0\n")
    for root_dir, names in ((str(root), ["000001.png", "x.png"]), ("/elsewhere", ["a.png"])):
        assert label_maps.get_ocl_trc(root_dir, names) == jax_maps.get_ocl_trc(root_dir, names)


def validate_rows(seed=3, n=80):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        y1, x1 = rng.uniform(0, 100, 2)
        box = [float(v) for v in (y1, x1, y1 + rng.uniform(5, 50), x1 + rng.uniform(5, 50))]
        rows.append({"image_name": f"{i}.png", "bbox": box, "class": float(rng.randint(1, 4)),
                     "gt_class": float(rng.randint(1, 4)), "iou": float(rng.uniform(0.2, 1)),
                     "entropy": float(rng.uniform(0, 2)),
                     "uncalib_albox": rng.uniform(0.5, 5, 4).tolist(),
                     "uncalib_mcbox": rng.uniform(0.5, 5, 4).tolist(),
                     "uncalib_mcclass": rng.uniform(0, 1, 3).tolist()})
    return rows


def test_main_uncert_analysis_matches_jax(tmp_path):
    """The weights, the metric table, thr_metrics and top-10 files equal
    the JAX package's (its plots, drawn by matplotlib, are under plots/;
    the port writes their numbers there, held by the next test)."""
    path = tmp_path / "validate_results.txt"
    path.write_text("".join(repr(r) + "\n" for r in validate_rows()))
    got = ua.MainUncertAnalysis(str(path), str(tmp_path / "port"), "ENTALBOXMCBOX").run(60)
    want = jax_ua.MainUncertAnalysis(str(path), str(tmp_path / "jax"), "ENTALBOXMCBOX").run(60)
    np.testing.assert_array_equal(got["opt_params"], want["opt_params"])
    assert got["metrics"] == want["metrics"]
    port_files = read_files(tmp_path / "port")
    jax_files = {k: v for k, v in read_files(tmp_path / "jax").items() if k in port_files}
    assert port_files == jax_files and "top10_uncertain.txt" in port_files


def test_select_uncertainties_and_epistemic_vs_aleatoric_match_jax():
    rows = validate_rows(4)
    got = ua.select_uncertainties(rows, "ENTALBOXMCBOXMCCLASS")
    want = jax_ua.select_uncertainties(rows, "ENTALBOXMCBOXMCCLASS")
    assert sorted(got) == sorted(want) == ["ALBOX", "ENT", "MCBOX", "MCCLASS"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for al in ("uncalib_albox", "entropy"):
        g = ua.epistemic_vs_aleatoric(rows, aleatoric_key=al)
        w = jax_ua.epistemic_vs_aleatoric(rows, aleatoric_key=al)
        assert g["correlation"] == w["correlation"]
        assert str(g["cells"]) == str(w["cells"])


def test_analysis_panels_numbers_match_jax(tmp_path, monkeypatch):
    """The FD@CD matrix (method x IoU threshold) the port writes to
    ``plots/fdcd_heatmap.json`` and the spider plot's normalised axes in
    ``plots/spider.json`` equal what the JAX package hands its matplotlib
    figures, to 1e-9."""
    import json

    import udal_tpu.utils.uncert_plots as jax_plots

    seen = {}
    monkeypatch.setattr(jax_plots, "metric_heatmap",
                        lambda m, xl, yl, path, title="": seen.update(heatmap=(m, xl, yl)))
    monkeypatch.setattr(jax_plots, "spider_plot",
                        lambda table, path, title="": seen.update(spider=table))
    path = tmp_path / "validate_results.txt"
    path.write_text("".join(repr(r) + "\n" for r in validate_rows(5)))
    ua.MainUncertAnalysis(str(path), str(tmp_path / "port"), "ENTALBOXMCBOX").run(40)
    jax_ua.MainUncertAnalysis(str(path), str(tmp_path / "jax"), "ENTALBOXMCBOX").run(40)
    heat = json.loads((tmp_path / "port" / "plots" / "fdcd_heatmap.json").read_text())
    matrix, xlabels, ylabels = seen["heatmap"]
    np.testing.assert_allclose(heat["matrix"], matrix, rtol=1e-9, atol=1e-9)
    assert heat["xlabels"] == xlabels and heat["ylabels"] == ylabels == \
        ["ENT", "ALBOX", "MCBOX", "COMBO"]
    spider = json.loads((tmp_path / "port" / "plots" / "spider.json").read_text())
    table = seen["spider"]
    assert spider["axes"] == sorted({k for m in table.values() for k in m})
    for method, vals in spider["methods"].items():
        for axis, v in zip(spider["axes"], vals):
            col = [table[m].get(axis, 0.0) for m in table]
            lo, hi = min(col), max(col)
            want = 0.5 if hi <= lo else (table[method].get(axis, 0.0) - lo) / (hi - lo)
            assert v == pytest.approx(want, rel=1e-9, abs=1e-12)


def test_quadrant_crops_name_the_missing_codec(tmp_path):
    """``export_quadrant_crops``, which raised for want of a PNG encoder,
    equals the JAX package's: the grid, the crop counts, the quality
    correlation (1e-9) and each crop's PNG pixels (the port's encoder,
    PIL's in the JAX package), with some images missing."""
    from PIL import Image

    from udal_tpu_torch.data.image_codec import decode_image

    rows = validate_rows(6, 60)
    rng = np.random.RandomState(6)
    images = {r["image_name"]: rng.randint(0, 256, (160, 160, 3)).astype(np.uint8)
              for r in rows[::2]}
    loader = images.get
    got = ua.export_quadrant_crops(rows, loader, str(tmp_path / "port"), per_cell=3)
    want = jax_ua.export_quadrant_crops(rows, loader, str(tmp_path / "jax"), per_cell=3)
    assert got["crop_counts"] == want["crop_counts"] and sum(got["crop_counts"].values()) >= 5
    np.testing.assert_allclose(got["quality_epistemic_corr"], want["quality_epistemic_corr"],
                               rtol=1e-9)
    assert str(got["cells"]) == str(want["cells"]) and got["correlation"] == want["correlation"]
    for (i, j), n in want["crop_counts"].items():
        for k in range(n):
            name = os.path.join(f"cell_{i}_{j}", f"crop_{k}.png")
            port = decode_image((tmp_path / "port" / name).read_bytes())
            np.testing.assert_array_equal(port, np.asarray(Image.open(tmp_path / "jax" / name)))
