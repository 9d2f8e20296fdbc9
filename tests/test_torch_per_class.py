"""Per-class NMS and ``generate_detections`` of the port against the JAX package.

Both get the same random per-level [T?, B, H, W, C] maps (numpy from a
seed, no ties). Per-class NMS shifts each candidate by its class times
2·max(h, w) and runs one soft-NMS (the kernel on the card, the plain
version here). Its σ outputs follow the JAX package: not multiplied by
``image_scales`` and not zeroed at invalid slots, unlike
``postprocess_global``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import configs  # noqa: E402
from tests.test_torch_postprocess import assert_std_close, level_maps  # noqa: E402
from udal_tpu.ops import postprocess as jax_post  # noqa: E402
from udal_tpu_torch.ops import postprocess  # noqa: E402

SCALES = np.asarray([1.0, 2.5], np.float32)


def decoded_max(jax_cfg, cls, box):
    """The largest |decoded box| before the clip: random maps decode boxes
    far past the canvas, and the MC σ cancel in f32 at that scale."""
    pn = jax_post.pre_nms(jax_cfg, [jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box])
    return float(np.abs(np.asarray(pn["boxes"])).max())


def both(fn_name, samples, topk=0, scales=SCALES, method="gaussian", seed=0):
    """(port result, JAX result, (JAX config, maps)) of
    ``postprocess.<fn_name>`` on the same maps."""
    jax_cfg, torch_cfg = configs(mc=bool(samples), extra=dict(enable_softmax=True))
    for cfg in (jax_cfg, torch_cfg):
        cfg.nms_configs.method = method
    cls, box = level_maps(torch_cfg, seed=seed + samples, samples=samples)
    got = getattr(postprocess, fn_name)(
        torch_cfg, [torch.from_numpy(c) for c in cls], [torch.from_numpy(b) for b in box],
        image_scales=None if scales is None else torch.from_numpy(scales), pre_nms_topk=topk)
    want = getattr(jax_post, fn_name)(
        jax_cfg, [jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box],
        image_scales=None if scales is None else jnp.asarray(scales), pre_nms_topk=topk)
    return got, want, (jax_cfg, cls, box)


@pytest.mark.parametrize("samples,method", [(0, "gaussian"), (3, "gaussian"), (3, "hard")])
def test_per_class_nms_matches(samples, method):
    got, want, (jax_cfg, cls, box) = both("per_class_nms", samples, method=method, seed=20)
    np.testing.assert_array_equal(got.valid_len.numpy(), np.asarray(want.valid_len))
    assert int(got.valid_len.min()) > 0
    # exact picks: the same classes in the same order, the same scores
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got.sigma_al.numpy(), np.asarray(want.sigma_al), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), rtol=1e-5,
                               atol=1e-5)
    assert (got.sigma_mc is None) == (want.sigma_mc is None) == (not samples)
    if samples:
        assert_std_close(got.sigma_mc.numpy(), np.asarray(want.sigma_mc),
                         decoded_max(jax_cfg, cls, box))
        assert_std_close(got.sigma_cls.numpy(), np.asarray(want.sigma_cls),
                         max(np.abs(c).max() for c in cls))


def test_per_class_nms_shifts_candidates_by_class(monkeypatch):
    """The one NMS sees each candidate moved by its class times 2·max(h, w)
    (256 px at 128x128) along both axes."""
    seen = {}
    nms = postprocess._nms

    def spy(config, boxes, scores):
        seen["boxes"] = boxes
        return nms(config, boxes, scores)

    monkeypatch.setattr(postprocess, "_nms", spy)
    _, torch_cfg = configs()
    cls, box = level_maps(torch_cfg, seed=21, samples=0)
    cls, box = [torch.from_numpy(c) for c in cls], [torch.from_numpy(b) for b in box]
    postprocess.per_class_nms(torch_cfg, cls, box)
    pn = postprocess.pre_nms(torch_cfg, cls, box, postprocess.MAX_DETECTION_POINTS)
    shift = seen["boxes"] - pn["boxes"]
    np.testing.assert_allclose(shift.numpy(), np.repeat(
        256.0 * pn["classes"][..., None].numpy(), 4, -1), atol=1e-3)
    assert len(torch.unique(pn["classes"])) > 1


def test_per_class_sigma_is_unscaled_and_unmasked_as_in_jax():
    """With fewer candidates (50) than outputs (K = 100), slots past the
    picks are invalid. ``postprocess_global`` zeroes their σ and scales
    every σ by ``image_scales``; ``per_class_nms`` does neither, in both
    packages."""
    got, want, _ = both("per_class_nms", 3, topk=50, seed=22)
    np.testing.assert_array_equal(got.valid_len.numpy(), np.asarray(want.valid_len))
    v = int(got.valid_len.max())
    assert 0 < v <= 50
    for name in ("sigma_al", "sigma_mc", "sigma_cls", "logits"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.abs(w[:, v:]).min() > 0, name          # not zeroed in JAX
        assert np.abs(g[:, v:]).min() > 0, name          # nor in the port
    np.testing.assert_allclose(got.sigma_al.numpy(), np.asarray(want.sigma_al), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.boxes.numpy()[:, v:] == 0) and np.all(got.scores.numpy()[:, v:] == 0)

    unscaled, _, _ = both("per_class_nms", 3, topk=50, scales=None, seed=22)
    np.testing.assert_array_equal(got.sigma_al.numpy(), unscaled.sigma_al.numpy())
    np.testing.assert_allclose(got.boxes.numpy()[1], 2.5 * unscaled.boxes.numpy()[1],
                               rtol=1e-6)

    glob, _, _ = both("postprocess_global", 3, topk=50, seed=22)
    v = int(glob.valid_len.max())
    assert v < 100
    assert np.all(glob.sigma_al.numpy()[:, v:] == 0)
    assert np.all(glob.sigma_mc.numpy()[:, v:] == 0)


@pytest.mark.parametrize("samples", [0, 3])
def test_generate_detections_matches(samples):
    jax_cfg, torch_cfg = configs(mc=bool(samples))
    cls, box = level_maps(torch_cfg, seed=30 + samples, samples=samples)
    ids = np.asarray([7, 11], np.int64)
    got = postprocess.generate_detections(
        torch_cfg, [torch.from_numpy(c) for c in cls], [torch.from_numpy(b) for b in box],
        torch.from_numpy(SCALES), torch.from_numpy(ids))
    want = jax_post.generate_detections(
        jax_cfg, [jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box],
        jnp.asarray(SCALES), jnp.asarray(ids))
    assert tuple(got.shape) == tuple(want.shape) == (2, 100, 7)
    want = np.asarray(want)
    np.testing.assert_array_equal(got[..., 0].numpy(), want[..., 0])
    np.testing.assert_array_equal(got[..., 6].numpy(), want[..., 6])
    np.testing.assert_allclose(got[..., 1:5].numpy(), want[..., 1:5], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[..., 5].numpy(), want[..., 5], rtol=1e-5, atol=1e-7)
