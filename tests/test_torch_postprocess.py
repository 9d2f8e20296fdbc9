"""Post-processing of the PyTorch port against the JAX package.

Anchors, box and uncertainty decoding, MC moments, ``pre_nms`` and
``postprocess_global`` get the same numpy inputs on both sides: random,
continuous per-level [T, B, H, W, C] class logits and box maps, so no two
candidates tie.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import configs  # noqa: E402
from udal_tpu.ops import anchors as jax_anchors  # noqa: E402
from udal_tpu.ops import postprocess as jax_post  # noqa: E402
from udal_tpu.ops import uncertainty as jax_unc  # noqa: E402
from udal_tpu_torch.ops import anchors, postprocess, uncertainty  # noqa: E402

# Boxes are in input pixels (up to ~10^2); both sides decode in float32 with
# exp, whose last bits differ between XLA and PyTorch.
ATOL = 1e-4


def assert_std_close(got, want, scale):
    """MC stds are sqrt(E[x²] - E[x]²) in float32 on both sides, which
    cancels catastrophically when the std is small against the values: the
    variance is good to a few ulps of E[x²] <= scale², not better."""
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(np.square(got), np.square(want),
                               atol=16 * eps * scale ** 2, rtol=0)


def level_maps(cfg, seed, samples, batch=2):
    """Per-level (class, box) maps [T?, B, H, W, C] as numpy."""
    rng = np.random.RandomState(seed)
    a = len(cfg.aspect_ratios) * cfg.num_scales
    box_ch = 8 * a if cfg.loss_attenuation else 4 * a
    lead = (samples, batch) if samples else (batch,)
    cls, box = [], []
    for level in range(cfg.min_level, cfg.max_level + 1):
        h = w = 128 >> level
        cls.append(rng.normal(-1.0, 1.5, lead + (h, w, a * cfg.num_classes)))
        mu = rng.normal(0.0, 0.2, lead + (h, w, box_ch // 2 if cfg.loss_attenuation else box_ch))
        parts = [mu]
        if cfg.loss_attenuation:
            parts.append(rng.uniform(0.01, 0.3, mu.shape))
        box.append(np.concatenate(parts, -1))
    as32 = lambda xs: [x.astype(np.float32) for x in xs]   # noqa: E731
    return as32(cls), as32(box)


@pytest.mark.parametrize("image_size", ["128x128", "1024x512", 640])
def test_anchors_equal(image_size):
    jax_cfg, torch_cfg = configs()
    jax_cfg.image_size = torch_cfg.image_size = image_size
    np.testing.assert_array_equal(anchors.from_config(torch_cfg).boxes_np,
                                  jax_anchors.from_config(jax_cfg).boxes_np)


def test_decode_box_outputs_matches():
    jax_cfg, torch_cfg = configs()
    grid = anchors.from_config(torch_cfg).boxes_np
    pred = np.random.RandomState(0).normal(0, 0.3, (2,) + grid.shape).astype(np.float32)
    got = anchors.decode_box_outputs(torch.from_numpy(pred), torch.from_numpy(grid))
    want = jax_anchors.decode_box_outputs(jnp.asarray(pred), jnp.asarray(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("method", ["l-norm", "n-flow"])
def test_decode_uncert_matches(method):
    jax_cfg, torch_cfg = configs()
    grid = anchors.from_config(torch_cfg).boxes_np
    rng = np.random.RandomState(1)
    mu = rng.normal(0, 0.3, (3, 2) + grid.shape).astype(np.float32)
    sd = rng.uniform(0.01, 0.5, mu.shape).astype(np.float32)
    got = uncertainty.decode_uncert(torch.from_numpy(mu), torch.from_numpy(sd),
                                    torch.from_numpy(grid), method)
    want = jax_unc.decode_uncert(jnp.asarray(mu), jnp.asarray(sd), jnp.asarray(grid),
                                 method)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("method", ["sample", "falsedec"])
def test_unported_decodes_raise(method):
    """The two decodes that once raised run now (their parity is in
    test_torch_uncertainty.py); a method name the package does not know
    still raises."""
    x = torch.zeros(4, 4)
    boxes, stds = uncertainty.decode_uncert(x, x + 0.1, x + torch.tensor([0., 0., 8., 8.]),
                                            method, n_samples=4)
    assert boxes.shape == stds.shape == (4, 4) and bool(torch.isfinite(stds).all())
    with pytest.raises(ValueError, match="Unknown"):
        uncertainty.decode_uncert(x, x, x, method + "-unknown")


def test_mc_moments_match():
    x = np.random.RandomState(2).normal(3.0, 2.0, (10, 2, 50, 4)).astype(np.float32)
    got = uncertainty.mc_moments(torch.from_numpy(x))
    want = jax_unc.mc_moments(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("samples,topk", [(3, 0), (3, 1000), (0, 0), (0, 700)])
def test_pre_nms_matches(samples, topk):
    """topk 0 keeps all 3069 anchors; 1000 / 700 take the exact top-k path."""
    jax_cfg, torch_cfg = configs(mc=bool(samples))
    cls, box = level_maps(torch_cfg, seed=samples + topk, samples=samples)
    got = postprocess.pre_nms(torch_cfg, [torch.from_numpy(c) for c in cls],
                              [torch.from_numpy(b) for b in box], topk)
    want = jax_post.pre_nms(jax_cfg, [jnp.asarray(c) for c in cls],
                            [jnp.asarray(b) for b in box], topk)
    for key in ("indices", "classes"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["scores_logits"].numpy(),
                               np.asarray(want["scores_logits"]), atol=1e-5, rtol=1e-6)
    for key in ("boxes", "sigma_al"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=1e-5, err_msg=key)
    for key, scale in (("sigma_mc", np.abs(np.asarray(want["boxes"])).max()),
                       ("sigma_cls", max(np.abs(c).max() for c in cls))):
        assert (got[key] is None) == (want[key] is None) == (not samples), key
        if samples:
            assert_std_close(got[key].numpy(), np.asarray(want[key]), scale)


@pytest.mark.parametrize("samples,method", [(3, "gaussian"), (0, "gaussian"), (3, "hard")])
def test_postprocess_global_matches(samples, method):
    jax_cfg, torch_cfg = configs(mc=bool(samples))
    for cfg in (jax_cfg, torch_cfg):
        cfg.nms_configs.method = method
    cls, box = level_maps(torch_cfg, seed=7 + samples, samples=samples)
    scales = np.asarray([1.0, 2.5], np.float32)
    got = postprocess.postprocess_global(
        torch_cfg, [torch.from_numpy(c) for c in cls], [torch.from_numpy(b) for b in box],
        image_scales=torch.from_numpy(scales)).packed()
    want = jax_post.postprocess_global(
        jax_cfg, [jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box],
        image_scales=jnp.asarray(scales)).packed()
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[3].min()) > 0
    np.testing.assert_array_equal(got[2][..., 0].numpy(), np.asarray(want[2])[..., 0])
    boxes, want_boxes = got[0].numpy(), np.asarray(want[0])
    np.testing.assert_allclose(boxes[..., :8], want_boxes[..., :8], atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=1e-5)
    if samples:   # sigma_mc and sigma_cls
        assert_std_close(boxes[..., 8:], want_boxes[..., 8:], np.abs(want_boxes).max())
        assert_std_close(got[2][..., 1:].numpy(), np.asarray(want[2])[..., 1:],
                         max(np.abs(c).max() for c in cls))
