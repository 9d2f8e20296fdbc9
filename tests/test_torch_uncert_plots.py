"""The port's ``utils/uncert_plots.py`` against the JAX package's and cv2.

* ``cv_ops.gaussian_blur_f64`` bit for bit with cv2's 7x7 ``GaussianBlur``
  of f64 planes (σ = 7/6, BORDER_REFLECT_101) on hypothesis-drawn shapes,
  thin ones included; its kernel bit for bit with
  ``cv2.getGaussianKernel``.
* ``mscn_coefficients``, ``brisque_like_score`` and
  ``regression_calibration_curve`` equal the JAX package's (the
  coefficients bit for bit, the scores within 1e-9).
* The figures the port writes as numbers: ``reliability_diagram``'s ECE /
  MCE / ACE and ``regression_calibration_plot``'s three numbers equal the
  JAX package's (1e-9), and each JSON file holds them beside the curve;
  ``spider_plot`` and ``metric_heatmap`` write their inputs' numbers;
  ``top10_panel``'s PNG is the contact sheet of its images.
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from hypothesis import given, settings, strategies as st  # noqa: E402

import udal_tpu.utils.uncert_plots as jax_plots  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.data.image_codec import decode_image  # noqa: E402
from udal_tpu_torch.ops import cv_ops  # noqa: E402
from udal_tpu_torch.utils import uncert_plots as plots  # noqa: E402
from udal_tpu_torch.utils.visualize import contact_sheet  # noqa: E402

TOL = dict(rtol=1e-9, atol=1e-12)
APPROX = dict(rel=1e-9, abs=1e-12)


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), squared=st.booleans(),
       seed=st.integers(0, 2 ** 31 - 1))
def test_gaussian_blur_f64_equals_cv2(h, w, squared, seed):
    """Gray planes and their squares (what MSCN blurs), one-row and
    one-column planes (where cv2 drops a pass) included."""
    x = np.random.RandomState(seed).randint(0, 256, (h, w, 3)) @ np.asarray([0.299, 0.587, 0.114])
    if squared:
        x = x * x
    np.testing.assert_array_equal(cv_ops.gaussian_blur_f64(x),
                                  cv2.GaussianBlur(x, (7, 7), 7.0 / 6.0))


@pytest.mark.parametrize("ksize,sigma", [(7, 7.0 / 6.0), (5, 1.1), (9, 2.0), (3, 0.8)])
def test_gaussian_kernel_f64_against_cv2(ksize, sigma):
    """cv2's own kernel at (7, 7/6); elsewhere within two ulps of it."""
    want = cv2.getGaussianKernel(ksize, sigma, ktype=cv2.CV_64F).ravel()
    got = cv_ops.gaussian_kernel_f64(ksize, sigma)
    if (ksize, sigma) == (7, 7.0 / 6.0):
        np.testing.assert_array_equal(got, want)
    assert np.all(np.abs(got - want) <= 2 * np.spacing(want))


@pytest.mark.parametrize("shape", [(40, 50, 3), (17, 23), (64, 48, 3), (1, 30, 3), (30, 1)])
def test_mscn_and_brisque_equal_jax(shape):
    rng = np.random.RandomState(shape[0])
    image = rng.randint(0, 256, shape).astype(np.uint8)
    gray = image.astype(np.float64) if image.ndim == 2 else \
        image @ np.asarray([0.299, 0.587, 0.114])
    np.testing.assert_array_equal(plots.mscn_coefficients(gray), jax_plots.mscn_coefficients(gray))
    np.testing.assert_allclose(plots.brisque_like_score(image),
                               jax_plots.brisque_like_score(image), **TOL)


def test_brisque_rises_with_blur_and_noise():
    """A smooth scene scores lower than its blurred and noisy copies."""
    rng = np.random.RandomState(0)
    y, x = np.mgrid[:64, :64]
    scene = (128 + 60 * np.sin(x / 5.0) * np.cos(y / 7.0) + rng.randn(64, 64) * 4)
    scene = np.clip(np.stack([scene] * 3, -1), 0, 255).astype(np.uint8)
    noisy = np.clip(scene + rng.randn(*scene.shape) * 40, 0, 255).astype(np.uint8)
    base = plots.brisque_like_score(scene)
    assert plots.brisque_like_score(noisy) > base
    assert plots.brisque_like_score(noisy) == pytest.approx(jax_plots.brisque_like_score(noisy),
                                                            rel=1e-9)


def test_regression_calibration_curve_and_plot_equal_jax(tmp_path):
    rng = np.random.RandomState(1)
    res, sigma = rng.randn(500) * 2.5, rng.gamma(2.0, 1.0, 500)
    for g, w in zip(plots.regression_calibration_curve(res, sigma),
                    jax_plots.regression_calibration_curve(res, sigma)):
        np.testing.assert_allclose(g, w, **TOL)
    got = plots.regression_calibration_plot(res, sigma, str(tmp_path / "p" / "cal.png"), "t")
    want = jax_plots.regression_calibration_plot(res, sigma, str(tmp_path / "j" / "cal.png"), "t")
    assert sorted(got) == sorted(want) == ["miscal_area", "rmsue", "sharpness"]
    for k in want:
        assert got[k] == pytest.approx(want[k], **APPROX)
    panel = json.loads((tmp_path / "p" / "cal.json").read_text())
    assert not (tmp_path / "p" / "cal.png").exists()
    assert {k: panel[k] for k in got} == got and panel["title"] == "t"
    exp_p, obs_p = jax_plots.regression_calibration_curve(res, sigma)
    np.testing.assert_allclose(panel["expected"], exp_p, **TOL)
    np.testing.assert_allclose(panel["observed"], obs_p, **TOL)
    counts, edges = np.histogram(sigma, bins=40)
    assert panel["sigma_histogram"]["counts"] == counts.tolist()
    np.testing.assert_allclose(panel["sigma_histogram"]["edges"], edges, **TOL)


@pytest.mark.parametrize("n,bins", [(300, 15), (40, 10), (5, 15), (0, 15)])
def test_reliability_diagram_equals_jax(tmp_path, n, bins):
    """Empty bins (null accuracy in the JSON) and no samples at all."""
    rng = np.random.RandomState(n)
    correct, conf = rng.rand(n) > 0.4, rng.beta(5, 2, n)
    got = plots.reliability_diagram(correct, conf, str(tmp_path / "r.png"), bins)
    want = jax_plots.reliability_diagram(correct, conf, str(tmp_path / "j.png"), bins)
    for k in ("ECE", "MCE", "ACE"):
        assert got[k] == pytest.approx(want[k], **APPROX)
    panel = json.loads((tmp_path / "r.json").read_text())
    assert len(panel["accuracy"]) == len(panel["weight"]) == bins
    assert {k: panel[k] for k in got} == got
    for i in range(bins):
        m = (conf > panel["edges"][i]) & (conf <= panel["edges"][i + 1])
        assert (panel["accuracy"][i] is None) == (not m.any())
        if m.any():
            assert panel["accuracy"][i] == pytest.approx(correct[m].mean(), **APPROX)


def test_spider_heatmap_and_top10_write_their_numbers(tmp_path):
    table = {"ENT": {"AUROC": 0.7, "FD@CD": 0.4, "JSD": 0.2},
             "ALBOX": {"AUROC": 0.6, "FD@CD": 0.5},
             "COMBO": {"AUROC": 0.8, "FD@CD": 0.3, "JSD": 0.2}}
    path = plots.spider_plot(table, str(tmp_path / "plots" / "spider.png"), "cmp")
    spider = json.loads(open(path).read())
    assert path.endswith("spider.json") and spider["axes"] == ["AUROC", "FD@CD", "JSD"]
    assert spider["methods"]["ENT"] == pytest.approx([0.5, 0.5, 1.0])
    assert spider["methods"]["ALBOX"] == pytest.approx([0.0, 1.0, 0.0])
    m = np.arange(12.0).reshape(3, 4) / 7
    path = plots.metric_heatmap(m, list("abcd"), list("xyz"), str(tmp_path / "h.png"), "T")
    heat = json.loads(open(path).read())
    assert heat["xlabels"] == list("abcd") and heat["ylabels"] == list("xyz")
    np.testing.assert_array_equal(heat["matrix"], m)
    rng = np.random.RandomState(2)
    images = [rng.randint(0, 256, (30, 40, 3)).astype(np.uint8) for _ in range(7)]
    labels = [str(i) for i in range(7)]
    path = plots.top10_panel(images, labels, str(tmp_path / "top.png"))
    np.testing.assert_array_equal(decode_image(open(path, "rb").read()),
                                  contact_sheet(images, cols=5, labels=labels))


@pytest.mark.parametrize("shape", [(37, 53, 3), (16, 9), (1, 5, 3)])
def test_write_png_decodes_to_its_pixels_as_cv2_reads_them(tmp_path, shape):
    """The artifacts' fast PNG (Sub filter, zlib level 1): cv2 and the
    port's decoder read back the same pixels."""
    from udal_tpu_torch.data.image_codec import write_png

    image = np.random.RandomState(shape[0]).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, image)
    rgb = image if image.ndim == 3 else np.stack([image] * 3, -1)
    np.testing.assert_array_equal(decode_image(open(path, "rb").read()), rgb)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(want if image.ndim == 2 else want[..., ::-1], image)
