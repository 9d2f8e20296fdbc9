"""Head-only MC dropout of the PyTorch port against the JAX package.

With ``mc_classheadrate`` / ``mc_boxheadrate`` set and no backbone rate
(the KITTI and BDD inference configurations' hparams), the JAX package
runs ``features`` once and ``predict_heads`` under ``vmap`` over T keys.
Here the JAX side runs ``features`` once (jitted) and ``predict_heads``
once per sample, unjitted, with ``spatial_dropout`` patched in
``udal_tpu.models.heads`` to draw numpy bits and record them; the port
replays those bits, each site's T samples stacked t-major, through
``mc_forward``. Then ``ServingDriver.serve_preprocessed`` of both packages,
the JAX one through a patched ``udal_tpu.apps.serving.mc_forward``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import udal_tpu.apps.serving as jax_serving  # noqa: E402
import udal_tpu.models.heads as jax_heads  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import (HEAD_ONLY, IMAGE, configs, random_variables,  # noqa: E402
                                       torch_model)
from tests.test_torch_mc import MaskTable, RecordingDropout, match_detections  # noqa: E402
from udal_tpu.models.efficientdet import EfficientDetNet as JaxNet  # noqa: E402
from udal_tpu.ops import postprocess as jax_post  # noqa: E402
from udal_tpu_torch.apps.serving import ServingDriver  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch  # noqa: E402
from udal_tpu_torch.models import mc_fast  # noqa: E402
from udal_tpu_torch.models.efficientdet import head_only_mc, mc_forward  # noqa: E402

T, B = 3, 2
ATOL, RTOL = 1e-4, 1e-3   # f32 on both sides, another summation order


def head_samples(jax_cfg, variables, images, rng, samples=T):
    """The JAX package's head-only MC forward with recorded masks: per-level
    [T, B, H, W, C] (class, box) and each site's bits [T·B, C], t-major."""
    model = JaxNet(jax_cfg)
    feats = jax.jit(lambda v, x: model.apply(v, x, False, method=JaxNet.features))(
        variables, jnp.asarray(images))
    recorders, outs = [], []
    for _ in range(samples):
        rec = RecordingDropout(rng)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_heads, "spatial_dropout", rec)
            outs.append(model.apply(variables, feats, False, method=JaxNet.predict_heads))
        recorders.append(rec)
    cls = [jnp.stack([o[0][i] for o in outs]) for i in range(len(outs[0][0]))]
    box = [jnp.stack([o[1][i] for o in outs]) for i in range(len(outs[0][1]))]
    sites = [np.concatenate([r.bits[i] for r in recorders]) for i in range(len(recorders[0].bits))]
    return cls, box, sites


def sigma_check(jax_cfg, cls, box, scales):
    """Matched pairs' σ: aleatoric to rtol 1e-3. The MC σ are sqrt(E[x²] -
    E[x]²) in f32 over T samples, and random weights decode boxes far
    past the canvas (hundreds of pixels) before the clip: the box
    variances agree to a few ulps of E[x²] at the largest decoded box,
    scaled as the σ are; the class variances at the largest logit."""
    eps = np.finfo(np.float32).eps
    big = np.abs(np.asarray(jax_post.pre_nms(jax_cfg, list(cls), list(box))["boxes"])).max()
    big = big * np.max(scales)
    logit = max(float(np.abs(np.asarray(c)).max()) for c in cls)

    def check(g_boxes, w_boxes, g_classes, w_classes):
        np.testing.assert_allclose(g_boxes[:, 4:8], w_boxes[:, 4:8], rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(g_boxes[:, 8:] ** 2, w_boxes[:, 8:] ** 2, rtol=1e-3,
                                   atol=16 * eps * big ** 2)
        np.testing.assert_allclose(g_classes[:, 1:] ** 2, w_classes[:, 1:] ** 2, rtol=1e-3,
                                   atol=16 * eps * logit ** 2)
    return check


@pytest.fixture(scope="module")
def case():
    jax_cfg, torch_cfg = configs(mc=True, samples=T, extra=HEAD_ONLY)
    variables = random_variables(jax_cfg, seed=5)
    rng = np.random.RandomState(6)
    images = rng.uniform(-2.0, 2.0, (B, IMAGE, IMAGE, 3)).astype(np.float32)
    cls, box, sites = head_samples(jax_cfg, variables, images, rng)
    return dict(jax_cfg=jax_cfg, torch_cfg=torch_cfg, variables=variables, images=images,
                cls=cls, box=box, sites=sites, model=torch_model(torch_cfg, variables))


def test_config_is_head_only(case):
    cfg = case["torch_cfg"]
    assert head_only_mc(cfg) and cfg.mc_dropoutrate == 0.0
    assert not head_only_mc(configs(mc=True)[1])
    # the heads draw one mask per level each (one repeat), in every sample
    assert len(case["sites"]) == 2 * 5
    assert all(s.shape[0] == T * B for s in case["sites"])
    assert sum(int((~s).sum()) for s in case["sites"]) > 0


def test_head_only_mc_forward_matches(case, monkeypatch):
    """The backbone and BiFPN run once, deterministically; only the heads
    draw masks. The fold's eligibility is never asked."""
    def refuse(*args):
        raise AssertionError("fast_mc_eligible reached on the head-only path")

    monkeypatch.setattr(mc_fast, "fast_mc_eligible", refuse)
    masks = MaskTable(case["sites"])
    with torch.inference_mode():
        cls, box = mc_forward(case["model"], torch.from_numpy(case["images"]), T, masks)
    assert masks.tables == []
    for g, w in zip(cls + box, case["cls"] + case["box"]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    # the sample axis carries the heads' dropout only: samples differ
    assert float((cls[0][0] - cls[0][1]).abs().max()) > 0


def test_serve_preprocessed_head_only_matches_as_matched_sets(case, monkeypatch):
    scales = np.asarray([1.0, 1.5], np.float32)
    stacked = (case["cls"], case["box"])

    def injected_mc_forward(model, variables, images, key, num_samples):
        assert num_samples == T
        return stacked

    monkeypatch.setattr(jax_serving, "mc_forward", injected_mc_forward)
    want = jax_serving.ServingDriver(case["jax_cfg"], case["variables"],
                                     use_pallas_nms=False).serve_preprocessed(
        case["images"], scales)

    v = case["variables"]
    driver = ServingDriver(case["torch_cfg"], flax_to_torch(v["params"], v["batch_stats"]),
                           device="cpu")
    driver.masks = MaskTable(case["sites"])
    got = driver.serve_preprocessed(case["images"], scales)
    assert driver.masks.tables == []
    # enable_softmax: the packed tuple ends in the logits
    assert [tuple(g.shape) for g in got] == [(B, 100, 12), (B, 100), (B, 100, 9), (B,),
                                             (B, 100, 8)]
    match_detections(got[:4], want[:4], sigma_check(case["jax_cfg"], *stacked, scales))
