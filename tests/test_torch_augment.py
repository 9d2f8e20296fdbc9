"""The port's augmentations against ``udal_tpu.data.augment`` and
``udal_tpu.data.autoaugment`` (numpy and cv2), at the same seeds.

Every op, policy and weather draws from a shared ``RandomState`` in the
JAX modules' order, so images and boxes compare exactly: bit for bit,
boxes to 1e-5. One op carries a cv2 call the port reproduces within a
bound (``ops/cv_ops.py``): rain streaks thicker than one pixel (the
weather bridge's ``random`` mode: the capsule against cv2's polygon, then
a box blur) are held to it, and every other image of the same runs bit
for bit. The training reader with each policy (and GridMask) yields the
JAX reader's batches.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_reader import SEED, configs, record, take  # noqa: E402,F401
from udal_tpu.data import augment as jax_aug  # noqa: E402
from udal_tpu.data import autoaugment as jax_aa  # noqa: E402
from udal_tpu.data.dataloader import InputReader as JaxReader  # noqa: E402
from udal_tpu_torch.data import augment, autoaugment  # noqa: E402
from udal_tpu_torch.data.dataloader import InputReader  # noqa: E402

OPS = ["AutoContrast", "Equalize", "Posterize", "Solarize", "SolarizeAdd", "Color", "Contrast",
       "Brightness", "Sharpness", "Cutout", "BBox_Cutout", "TranslateX_BBox", "TranslateY_BBox",
       "ShearX_BBox", "ShearY_BBox", "Rotate_BBox", "Flip_Only_BBoxes", "Equalize_Only_BBoxes",
       "Solarize_Only_BBoxes", "Rotate_Only_BBoxes", "ShearX_Only_BBoxes", "ShearY_Only_BBoxes",
       "TranslateX_Only_BBoxes", "TranslateY_Only_BBoxes", "Cutout_Only_BBoxes"]


@pytest.fixture
def img():
    return np.random.RandomState(0).randint(0, 256, (67, 101, 3)).astype(np.uint8)


@pytest.fixture
def boxes():
    return np.asarray([[5.0, 8.0, 40.0, 60.0], [20.0, 50.5, 66.0, 100.0],
                       [0.0, 0.0, 10.0, 12.0]], np.float32)


def test_policy_tables_and_constants_equal_the_jax_module():
    """The tables C3's test cannot check against the reference tree, held
    to the JAX module's."""
    assert autoaugment.POLICIES == jax_aa.POLICIES
    assert autoaugment.RANDAUG_OPS == jax_aa.RANDAUG_OPS
    assert autoaugment.WEATHER_OPS == jax_aa.WEATHER_OPS
    assert autoaugment.SUBJECTIVE_PARAMS == jax_aa.SUBJECTIVE_PARAMS
    assert autoaugment.RANDOM_BOUNDS == jax_aa.RANDOM_BOUNDS
    for name in ("MAX_LEVEL", "REPLACE", "CUTOUT_MAX_PAD_FRACTION", "CUTOUT_CONST",
                 "TRANSLATE_CONST", "CUTOUT_BBOX_CONST", "TRANSLATE_BBOX_CONST"):
        assert getattr(autoaugment, name) == getattr(jax_aa, name), name
    assert list(augment.COLOR_OPS) == list(jax_aug.COLOR_OPS)


@pytest.mark.parametrize("name", OPS)
def test_every_op_equals_jax_at_levels_0_5_10(name, img, boxes):
    for level in (0.0, 5.0, 10.0):
        got = autoaugment.apply_op(name, img, boxes, level, np.random.RandomState(11))
        want = jax_aa.apply_op(name, img, boxes, level, np.random.RandomState(11))
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"{name} {level}")
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5, err_msg=f"{name} {level}")


@pytest.mark.parametrize("policy", ["v0", "v1", "v2", "v3", "test"])
def test_autoaugment_policies_equal_jax(policy, img, boxes):
    rp, rj = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(12):
        got = autoaugment.distort_image_with_autoaugment(img, boxes, policy, rp)
        want = jax_aa.distort_image_with_autoaugment(img, boxes, policy, rj)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    got = autoaugment.distort_image_with_randaugment(img, boxes, rng=np.random.RandomState(4))
    want = jax_aa.distort_image_with_randaugment(img, boxes, rng=np.random.RandomState(4))
    np.testing.assert_array_equal(got[0], want[0])


def _weather_close(got, want, op, params):
    """Bit for bit, but for rain thicker than 1 (the streak pixels,
    box-blurred, differ on at most 5% of the pixels)."""
    diff = np.abs(got.astype(int) - want)
    if op == "rain" and int(params[2]) > 1:
        assert (diff != 0).mean() <= 0.05, (diff != 0).mean()
    else:
        np.testing.assert_array_equal(got, want, err_msg=f"{op} {params}")


@pytest.mark.parametrize("mode", ["subjective", "random", "optimal"])
def test_weather_bridge_equals_jax(mode, img, boxes, tmp_path):
    if mode == "optimal":
        for op in jax_aa.WEATHER_OPS:
            (tmp_path / op).mkdir()
            with open(tmp_path / op / f"{op}_opt_params", "wb") as fp:
                pickle.dump([float(v) for v in jax_aa.SUBJECTIVE_PARAMS[op]], fp)
    rp, rj = np.random.RandomState(6), np.random.RandomState(6)
    for _ in range(24):
        peek = np.random.RandomState()
        peek.set_state(rp.get_state())                         # which op, which params
        op = jax_aa.WEATHER_OPS[peek.randint(len(jax_aa.WEATHER_OPS))]
        applied = peek.rand() < 0.5
        params = [peek.uniform(lo, hi) for lo, hi in jax_aa.RANDOM_BOUNDS[op]] \
            if mode == "random" else jax_aa.SUBJECTIVE_PARAMS[op]
        got = autoaugment.distort_image_with_weather(img, boxes, mode, save_path=str(tmp_path) + "/",
                                                     rng=rp)
        want = jax_aa.distort_image_with_weather(img, boxes, mode, save_path=str(tmp_path) + "/",
                                                 rng=rj)
        assert rp.randint(1 << 30) == rj.randint(1 << 30)      # the same draws so far
        if applied:
            _weather_close(got[0], want[0], op, params)
        else:
            np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for op in jax_aa.WEATHER_OPS:
        for params in (jax_aa.SUBJECTIVE_PARAMS[op],
                       [np.random.RandomState(9).uniform(lo, hi)
                        for lo, hi in jax_aa.RANDOM_BOUNDS[op]]):
            got = autoaugment.apply_weather_op(op, img, params, np.random.RandomState(1))
            want = jax_aa.apply_weather_op(op, img, params, np.random.RandomState(1))
            _weather_close(got, want, op, params)


def test_optimal_params_refuse_anything_but_numbers(tmp_path):
    class Evil:
        def __reduce__(self):
            return (print, ("unpickled",))

    (tmp_path / "fog").mkdir()
    with open(tmp_path / "fog" / "fog_opt_params", "wb") as fp:
        pickle.dump([Evil()], fp)
    with pytest.raises(pickle.UnpicklingError):
        autoaugment.load_weather_params(str(tmp_path / "fog" / "fog_opt_params"))
    with open(tmp_path / "fog" / "fog_opt_params", "wb") as fp:
        pickle.dump({"coef": 0.5}, fp)
    with pytest.raises(ValueError, match="list of numbers"):
        autoaugment.load_weather_params(str(tmp_path / "fog" / "fog_opt_params"))


def test_color_ops_randaugment_gridmask_mosaic_equal_jax(img, boxes):
    for name, fn in augment.COLOR_OPS.items():
        for level in (0.0, 5.0, 9.0):
            np.testing.assert_array_equal(fn(img, level), jax_aug.COLOR_OPS[name](img, level),
                                          err_msg=name)
    got = augment.randaugment(img, boxes, rng=np.random.RandomState(2))
    want = jax_aug.randaugment(img, boxes, rng=np.random.RandomState(2))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(augment.gridmask(img, rng=np.random.RandomState(5)),
                                  jax_aug.gridmask(img, rng=np.random.RandomState(5)))
    samples = [(np.roll(img, i, 0), boxes, np.arange(1, 4) + i) for i in range(4)]
    got = augment.mosaic(samples, (128, 160), rng=np.random.RandomState(7))
    want = jax_aug.mosaic(samples, (128, 160), rng=np.random.RandomState(7))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("weather", ["fog", "rain", "snow", "noise", "sat"])
def test_add_weather_equals_jax(weather, img):
    for severity in (0.2, 0.5, 0.9):
        np.testing.assert_array_equal(augment.add_weather(img, weather, severity),
                                      jax_aug.add_weather(img, weather, severity))
        np.testing.assert_array_equal(
            augment.add_weather(img, weather, severity, np.random.RandomState(4)),
            jax_aug.add_weather(img, weather, severity, np.random.RandomState(4)))


@pytest.mark.parametrize("kind", ["br", "ct", "bl", "ns", "mb"])
def test_apply_corruption_equals_jax(kind, img):
    """Bit for bit, but for the 12-tap motion blur at severity 0.8 (cv2's
    DFT: off by ≤ 1 where the window sum is a tie)."""
    for g, w, s in zip(augment.apply_corruption(kind, img), jax_aug.apply_corruption(kind, img),
                       augment.CORRUPTION_SEVERITIES):
        if kind == "mb" and s == 0.8:
            assert np.abs(g.astype(int) - w).max() <= 1
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{kind} {s}")


def test_batched_variants_equal_per_image():
    """``AugmentVariants`` on a batch equals the per-image functions (the
    shape-only draws cached, the second call from the cache)."""
    images = np.random.RandomState(8).randint(0, 256, (3, 40, 56, 3)).astype(np.uint8)
    t = torch.from_numpy(images)
    var = augment.AugmentVariants("cpu")
    for _ in range(2):
        for weather in ("snow", "fog", "rain", "noise"):
            got = var.weather(t, weather).numpy()
            np.testing.assert_array_equal(got, np.stack([augment.add_weather(im, weather)
                                                         for im in images]))
        for kind in ("ns", "mb", "ct", "br"):
            for s, rung in enumerate(var.corruption(t, kind)):
                np.testing.assert_array_equal(rung.numpy(), np.stack(
                    [augment.apply_corruption(kind, im)[s] for im in images]))
    assert len(var._draws) == 5                    # four weathers and the ns draws


@pytest.mark.parametrize("policy,grid_mask", [("v0", False), ("v3", True), ("randaug", False),
                                              ("albu", True)])
@pytest.mark.parametrize("contract", ["classic", "fast_input"])
def test_training_reader_with_policy_equals_jax(record, policy, grid_mask, contract):  # noqa: F811
    """uint8 batches bit for bit, classic batches within 1e-6, boxes to
    1e-5 and every label key to 1e-6."""
    kw = dict(fast_input=True) if contract == "fast_input" else {}
    jc, pc = configs()
    for c in (jc, pc):
        c.autoaugment_policy = policy
        c.grid_mask = grid_mask
    got = take(InputReader(record, True, prefetch=2, seed=SEED, names=True, **kw), pc, 2)
    with jax.disable_jit():
        want = take(JaxReader(record, True, prefetch=0, seed=SEED, names=True, **kw), jc, 2)
    image_tol = 0 if contract == "fast_input" else 1e-6
    for (pi, pl), (ji, jl) in zip(got, want):
        assert pi.dtype == np.asarray(ji).dtype
        np.testing.assert_allclose(pi, ji, rtol=0, atol=image_tol)
        assert set(pl) == set(jl)
        for k in jl:
            if isinstance(jl[k], list):
                assert pl[k] == jl[k], k
            else:
                np.testing.assert_allclose(np.asarray(pl[k], np.float64),
                                           np.asarray(jl[k], np.float64), rtol=0,
                                           atol=1e-5 if "box" in k else 1e-6, err_msg=k)
