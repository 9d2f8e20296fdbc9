"""The port's calibration against sklearn and the JAX package's, on the CPU.

The isotonic fit and predict equal sklearn's ``IsotonicRegression`` over
drawn inputs with ties: to 1e-12 in float64 (the pool-adjacent-violators
means are scipy's, step for step, so they are in fact equal) and bit for
bit in float32. The temperature fits (torch autograd) agree with the JAX
package's (``jax.grad``) to 1e-5 relative: the same f32 loss and update,
summed in another order. Calibrators the JAX package pickled come across
through ``convert.calibrators_from_jax`` and predict what the unpickled
sklearn objects predict.
"""

import os
import pickle

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from sklearn.isotonic import IsotonicRegression as SkIsotonic  # noqa: E402

import udal_tpu.apps.calibration as jax_cal  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.apps import calibration as cal  # noqa: E402
from udal_tpu_torch.convert import calibrators_from_jax  # noqa: E402


def assert_iso_equal(got, want, dtype):
    """Thresholds, range and predictions: bit-equal in f32, 1e-12 in f64."""
    for g, w in ((got.X_thresholds_, want.X_thresholds_), (got.y_thresholds_, want.y_thresholds_),
                 (np.asarray([got.X_min_, got.X_max_]), np.asarray([want.X_min_, want.X_max_]))):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        if dtype == np.float32:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def queries(X, dtype, rng):
    """Inside, outside and exactly at the training range, and at its points."""
    lo, hi = float(np.min(X)), float(np.max(X))
    span = max(hi - lo, 1.0)
    return np.concatenate([rng.uniform(lo - span, hi + span, 40), X,
                           [lo, hi, lo - 1e3, hi + 1e3]]).astype(dtype)


values = st.one_of(st.sampled_from([0.0, 0.25, 0.5, 1.0, 2.0]),
                   st.floats(-100, 100, allow_nan=False, width=32))


@settings(max_examples=150, deadline=None)
@given(pairs=st.lists(st.tuples(values, values), min_size=1, max_size=40),
       dtype=st.sampled_from([np.float32, np.float64]),
       bounds=st.sampled_from([{}, dict(y_min=0, y_max=1)]))
def test_isotonic_equals_sklearn(pairs, dtype, bounds):
    """Ties in X (drawn from five values half of the time), constant y, a
    single distinct X, y outside [y_min, y_max], and queries out of range."""
    X = np.asarray([p[0] for p in pairs], dtype)
    y = np.asarray([p[1] for p in pairs], dtype)
    want = SkIsotonic(increasing=True, out_of_bounds="clip", **bounds).fit(X, y)
    got = cal.IsotonicRegression(**bounds).fit(X, y)
    assert_iso_equal(got, want, dtype)
    T = queries(X, dtype, np.random.RandomState(len(pairs)))
    p, q = got.predict(T), want.predict(T)
    assert p.dtype == q.dtype == dtype
    if dtype == np.float32:
        np.testing.assert_array_equal(p, q)
    else:
        np.testing.assert_allclose(p, q, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["near_ties", "constant", "single_x", "column", "large"])
def test_isotonic_edge_cases_equal_sklearn(dtype, case):
    """X closer than the dtype's resolution merges (sklearn's
    ``_make_unique``), constant y, one distinct X, an [n, 1] column, and
    10,000 calibration-sized points."""
    rng = np.random.RandomState(3)
    if case == "near_ties":
        res = np.finfo(dtype).resolution
        X = np.repeat(rng.uniform(0, 1, 30), 3) + np.tile([0, res / 3, res * 2], 30)
        y = rng.uniform(0, 2, 90)
    elif case == "constant":
        X, y = rng.uniform(0, 1, 50), np.full(50, 0.3)
    elif case == "single_x":
        X, y = np.full(7, 0.5), rng.uniform(0, 1, 7)
    elif case == "column":
        X, y = rng.uniform(0, 1, (60, 1)), rng.uniform(0, 1, 60)
    else:
        X = rng.gamma(2.0, 3.0, 10000)
        y = np.abs(rng.normal(0, X))
    X, y = X.astype(dtype), y.astype(dtype)
    want = SkIsotonic(increasing=True, out_of_bounds="clip").fit(X, y)
    got = cal.IsotonicRegression().fit(X, y)
    assert_iso_equal(got, want, dtype)
    T = queries(X.reshape(-1), dtype, rng)
    tol = dict(rtol=0, atol=0 if dtype == np.float32 else 1e-12)
    np.testing.assert_allclose(got.predict(T), want.predict(T), **tol)


def test_isotonic_refuses_what_sklearn_refuses():
    with pytest.raises(ValueError):
        cal.IsotonicRegression().fit(np.zeros((3, 2)), np.zeros(3))
    with pytest.raises(ValueError):
        cal.IsotonicRegression().fit([0.0, np.nan], [1.0, 2.0])
    with pytest.raises(ValueError):
        cal.IsotonicRegression().fit([0.0, 1.0], [1.0])


def regression_data(seed=0, n=120, num_classes=4):
    rng = np.random.RandomState(seed)
    gt = np.sort(rng.uniform(0, 200, (n, 4)).reshape(n, 2, 2), axis=1).reshape(n, 4)
    gt = gt[:, [0, 2, 1, 3]]                               # y1, x1, y2, x2
    gt[:, 2:] += 5
    sigma = rng.uniform(0.5, 8.0, (n, 4))
    pred = gt + rng.normal(0, 1.0, (n, 4)) * sigma * 1.7
    classes = rng.randint(1, num_classes + 1, n)
    classes[classes == num_classes] = 1                    # one class absent: the fallback
    return gt, pred, sigma, classes


@pytest.mark.parametrize("loss", ["mae", "mse", "rmse"])
def test_temperature_regression_matches_jax(loss):
    gt, pred, sigma, _ = regression_data()
    res = np.abs(pred - gt)
    got = cal.fit_temperature_regression(res, sigma, loss=loss, device="cpu")
    want = jax_cal.fit_temperature_regression(res, sigma, loss=loss)
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("per_class", [False, True])
def test_temperature_classification_matches_jax(per_class):
    rng = np.random.RandomState(1)
    logits = rng.normal(0, 3, (200, 5))
    onehot = np.eye(5)[rng.randint(0, 5, 200)]
    got = cal.fit_temperature_classification(onehot, logits, per_class, device="cpu")
    want = jax_cal.fit_temperature_classification(onehot, logits, per_class)
    assert np.asarray(got).dtype == np.float32 and np.shape(got) == np.shape(want)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_temperature_fits_take_the_device():
    with pytest.raises(RuntimeError):
        cal.fit_temperature_regression(np.ones(4), np.ones(4), device="meta")


def assert_calibrators_equal(got, want, dtype=np.float64):
    """Isotonic fits as above, temperatures to 1e-5 relative."""
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], want[name]
        if isinstance(w, list) and w and hasattr(w[0], "X_thresholds_"):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert_iso_equal(a, b, dtype)
        elif hasattr(w, "X_thresholds_"):
            assert_iso_equal(g, w, dtype)
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                       rtol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def fitted():
    """Both packages' calibrators fitted on the same arrays: regression (a
    class absent: its per-class fits fall back to all rows) and
    classification with the MC logit σ (the ``unc_*`` variants)."""
    gt, pred, sigma, classes = regression_data()
    rng = np.random.RandomState(2)
    logits = rng.normal(0, 2, (150, 4))
    y = rng.randint(1, 5, 150)
    logits[np.arange(150), y - 1] += 1.5
    sig_cls = rng.uniform(0.1, 1.0, (150, 4))
    out = {}
    for name, mod, kw in (("jax", jax_cal, {}), ("port", cal, dict(device="cpu"))):
        out[name] = (mod.RegressionCalib(gt, pred, sigma, classes, 4, **kw).fit_all(),
                     mod.ClassificationCalib(y, logits, sig_cls, 4, **kw).fit_all())
    out["data"] = dict(sigma=sigma, classes=classes, boxes=pred, logits=logits, sig_cls=sig_cls)
    return out


def test_regression_calib_matches_jax(fitted):
    assert_calibrators_equal(fitted["port"][0], fitted["jax"][0])
    assert sorted(fitted["port"][0]) == sorted(cal.REGRESSION_CALIBRATORS)


def test_classification_calib_matches_jax(fitted):
    """The eight variants, the ``unc_*`` four on the same 10 seeded draws."""
    assert len(fitted["port"][1]) == 8
    assert_calibrators_equal(fitted["port"][1], fitted["jax"][1])


def assert_applied_equal(port_reg, port_cls, jax_reg, jax_cls, data):
    """CalibrateBoxUncert and CalibrateClass (with and without the MC σ)."""
    got = cal.CalibrateBoxUncert(port_reg, 4)(data["sigma"], data["classes"], data["boxes"])
    want = jax_cal.CalibrateBoxUncert(jax_reg, 4)(data["sigma"], data["classes"], data["boxes"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-12, err_msg=k)
    for uncert in (None, data["sig_cls"]):
        got = cal.CalibrateClass(port_cls, 4)(data["logits"], uncert=uncert, seed=5)
        want = jax_cal.CalibrateClass(jax_cls, 4)(data["logits"], uncert=uncert, seed=5)
        assert sorted(got) == sorted(want)
        for k in want:
            assert sorted(got[k]) == sorted(want[k])
            for part in want[k]:
                np.testing.assert_allclose(got[k][part], want[k][part], rtol=1e-5, atol=1e-9,
                                           err_msg=f"{k}/{part}")


def test_applied_calibrators_match_jax(fitted):
    """The temperatures agree to 1e-5, so the applied values do too."""
    assert_applied_equal(*fitted["port"], *fitted["jax"], fitted["data"])


def test_save_load_roundtrip_without_pickle(fitted, tmp_path):
    reg, cls = fitted["port"]
    cal.save_calibrators(str(tmp_path), reg, cls)
    files = sorted(os.listdir(tmp_path / "regression")) + sorted(
        os.listdir(tmp_path / "classification"))
    assert files == sorted(f"regression_{k}.npz" for k in reg) + sorted(
        f"classification_{k}.npz" for k in cls)
    for name in os.listdir(tmp_path / "classification"):
        np.load(tmp_path / "classification" / name, allow_pickle=False)
    got_reg, got_cls = cal.load_calibrators(str(tmp_path))
    assert_calibrators_equal(got_reg, reg)
    assert_calibrators_equal(got_cls, cls)
    assert isinstance(got_reg["ts_all"], float | np.floating)
    assert got_cls["ts_percls"].dtype == np.float32
    assert cal.load_calibrators(str(tmp_path / "missing")) == ({}, {})


def test_calibrators_from_jax_predict_as_the_pickles(fitted, tmp_path):
    """The JAX package's own pickles (sklearn fits, floats, f32 arrays)
    through the converter, loaded by the port: the same predictions as the
    unpickled objects."""
    jax_reg, jax_cls = fitted["jax"]
    jax_cal.save_calibrators(str(tmp_path / "jax"), jax_reg, jax_cls)
    reg, cls = calibrators_from_jax(str(tmp_path / "jax"), str(tmp_path / "port"))
    unpickled = [{}, {}]
    for i, sub in enumerate(("regression", "classification")):
        for name in os.listdir(tmp_path / "jax" / sub):
            with open(tmp_path / "jax" / sub / name, "rb") as f:
                unpickled[i][name.replace(f"{sub}_", "", 1)] = pickle.load(f)
    loaded = cal.load_calibrators(str(tmp_path / "port"))
    for got in ((reg, cls), loaded):
        assert sorted(got[0]) == sorted(unpickled[0]) and sorted(got[1]) == sorted(unpickled[1])
        data = fitted["data"]
        got_box = cal.CalibrateBoxUncert(got[0], 4)(data["sigma"], data["classes"], data["boxes"])
        want_box = jax_cal.CalibrateBoxUncert(unpickled[0], 4)(data["sigma"], data["classes"],
                                                               data["boxes"])
        for k in want_box:
            np.testing.assert_array_equal(got_box[k], want_box[k], err_msg=k)
        for uncert in (None, data["sig_cls"]):
            got_cls = cal.CalibrateClass(got[1], 4)(data["logits"], uncert=uncert, seed=1)
            want_cls = jax_cal.CalibrateClass(unpickled[1], 4)(data["logits"], uncert=uncert,
                                                              seed=1)
            for k in want_cls:
                for part in want_cls[k]:
                    np.testing.assert_array_equal(got_cls[k][part], want_cls[k][part])


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    gt, pred, sigma, _ = regression_data(seed)
    got = cal.regression_metrics(gt, pred, sigma)
    assert got == jax_cal.regression_metrics(gt, pred, sigma)
    assert cal.calc_ece_regression(gt[:, 0], pred[:, 0], sigma[:, 0]) == \
        jax_cal.calc_ece_regression(gt[:, 0], pred[:, 0], sigma[:, 0])
    rng = np.random.RandomState(seed)
    logits = rng.normal(0, 2, (300, 6))
    probs = cal.stable_softmax(logits)
    np.testing.assert_array_equal(probs, jax_cal.stable_softmax(logits))
    onehot = np.eye(6)[rng.randint(0, 6, 300)]
    assert cal.classification_metrics(onehot, probs) == \
        jax_cal.classification_metrics(onehot, probs)


def test_gt_assignment_matches_jax():
    gt = regression_data(4, 12)[0]
    pred = regression_data(5, 30)[0]
    np.testing.assert_array_equal(cal.iou_matrix_corners(gt, pred),
                                  jax_cal.iou_matrix_corners(gt, pred))
    for method in ("IoU", "MSE"):
        for g, w in zip(cal.gt_box_assigner(gt, pred, method),
                        jax_cal.gt_box_assigner(gt, pred, method)):
            np.testing.assert_array_equal(g, w)
    empty = cal.gt_box_assigner(gt, np.zeros((0, 4)))
    assert empty[0].shape == (0,) and empty[1].shape == (0,)
    sigma = np.random.RandomState(4).uniform(0, 1, (30, 4))
    np.testing.assert_array_equal(cal.relativize(pred, sigma), jax_cal.relativize(pred, sigma))
