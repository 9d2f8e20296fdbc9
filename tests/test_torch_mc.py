"""MC-dropout parity of the PyTorch port with the JAX package, masks injected.

The two frameworks draw different random bits, so both sides get the same
keep bits from numpy. JAX side: ``folded_block0_all_samples(masks=...)``,
then the per-sample forward from block 1, unjitted, once per sample, with
``spatial_dropout`` patched in ``udal_tpu.models.efficientnet`` and
``udal_tpu.models.heads`` (which imports it by name) to draw its bits from
numpy and record them. Port side: the recorded bits replayed through a
mask source, in the port's order (the fold's masks, then each site with
the T samples stacked t-major). Nothing in ``udal_tpu`` changes.

Then the slice as a whole: ``ServingDriver.serve_preprocessed`` of both
packages. ``jax.vmap`` cannot take per-sample masks, so the JAX serving
program receives the MC forward computed above through a patched
``udal_tpu.apps.serving.mc_forward``; its postprocess is its own.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import udal_tpu.apps.serving as jax_serving  # noqa: E402
import udal_tpu.models.efficientnet as jax_effnet  # noqa: E402
import udal_tpu.models.heads as jax_heads  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import IMAGE, configs, random_variables, torch_model  # noqa: E402
from udal_tpu.models import mc_fast as jax_mc_fast  # noqa: E402
from udal_tpu.models.efficientdet import EfficientDetNet as JaxNet  # noqa: E402
from udal_tpu.models.efficientdet import preprocess_images as jax_preprocess  # noqa: E402
from udal_tpu.ops.postprocess import postprocess_global  # noqa: E402
from udal_tpu_torch.apps.serving import ServingDriver  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch  # noqa: E402
from udal_tpu_torch.models import mc_fast  # noqa: E402
from udal_tpu_torch.models.efficientdet import mc_forward, preprocess_images  # noqa: E402

T, B = 3, 2
# f32 on both sides; the conv summation order differs (see test_torch_models)
ATOL, RTOL = 1e-4, 1e-3


class RecordingDropout:
    """Stand-in for the JAX package's spatial_dropout: numpy keep bits, the
    same scaling, every mask recorded."""

    def __init__(self, rng):
        self.rng = rng
        self.bits = []

    def __call__(self, module, x, rate, active):
        if rate <= 0.0 or not active:
            return x
        keep = 1.0 - rate
        bits = self.rng.uniform(size=(x.shape[0], x.shape[-1])) < keep
        self.bits.append(bits)
        mask = jnp.asarray(bits).reshape((x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],))
        return x * (mask.astype(x.dtype) / jnp.asarray(keep, x.dtype))


class MaskTable:
    """Port-side mask source that replays recorded keep bits in order."""

    def __init__(self, tables):
        self.tables = list(tables)

    def draw(self, n, c, keep, device):
        bits = self.tables.pop(0)
        assert bits.shape == (n, c), (bits.shape, (n, c))
        return torch.from_numpy(bits).to(device)


@pytest.fixture(scope="module")
def case():
    jax_cfg, torch_cfg = configs(mc=True, samples=T)
    variables = random_variables(jax_cfg, seed=3)
    rng = np.random.RandomState(4)
    images = rng.uniform(-2.0, 2.0, (B, IMAGE, IMAGE, 3)).astype(np.float32)
    rate = jax_cfg.mc_dropoutrate
    keep = 1.0 - rate

    x0, x0_mean = jax_mc_fast.mc_shared_prefix(variables, jnp.asarray(images),
                                               jnp.float32, pack=None)
    fold_bits = rng.uniform(size=(T, B, x0.shape[-1])) < keep
    y_all = jax_mc_fast.folded_block0_all_samples(
        variables, x0, x0_mean, jax.random.PRNGKey(0), rate, T,
        masks=jnp.asarray(fold_bits / keep, jnp.float32))

    model = JaxNet(jax_cfg)
    recorders, outs = [], []
    for t in range(T):
        rec = RecordingDropout(rng)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_effnet, "spatial_dropout", rec)
            mp.setattr(jax_heads, "spatial_dropout", rec)
            outs.append(model.apply(variables, y_all[:, t], False,
                                    method=JaxNet.forward_from_block1))
        recorders.append(rec)
    cls = [jnp.stack([o[0][i] for o in outs]) for i in range(len(outs[0][0]))]
    box = [jnp.stack([o[1][i] for o in outs]) for i in range(len(outs[0][1]))]
    sites = [np.concatenate([r.bits[i] for r in recorders])
             for i in range(len(recorders[0].bits))]
    return dict(jax_cfg=jax_cfg, torch_cfg=torch_cfg, variables=variables,
                images=images, x0=x0, x0_mean=x0_mean, fold_bits=fold_bits,
                y_all=y_all, cls=cls, box=box, sites=sites,
                model=torch_model(torch_cfg, variables))


def tables(case):
    """The port's draw order: the fold's [T·B, C0] bits, then the sites."""
    return [case["fold_bits"].reshape(T * B, -1)] + case["sites"]


def test_masks_reach_every_site(case):
    # blocks 1-15 draw two masks each; each head draws one per level
    assert len(case["sites"]) == 2 * 15 + 2 * 5
    assert sum(int((~s).sum()) for s in case["sites"]) > 0


def test_shared_prefix_and_fold_match(case):
    model = case["model"]
    rate = case["torch_cfg"].mc_dropoutrate
    with torch.inference_mode():
        x0, x0_mean = mc_fast.mc_shared_prefix(model, torch.from_numpy(case["images"]))
        masks = torch.from_numpy(case["fold_bits"].astype(np.float32) / (1.0 - rate))
        y = mc_fast.folded_block0_all_samples(model, x0, x0_mean, rate, T, masks=masks)
    np.testing.assert_allclose(x0.permute(0, 2, 3, 1).numpy(), np.asarray(case["x0"]),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(x0_mean.numpy(), np.asarray(case["x0_mean"]),
                               atol=ATOL, rtol=RTOL)
    want = np.asarray(case["y_all"]).transpose(1, 0, 4, 2, 3).reshape(y.shape)
    np.testing.assert_allclose(y.numpy(), want, atol=ATOL, rtol=RTOL)


def test_per_sample_forward_from_block1_matches(case):
    """The ``mc_fast`` stages after the fold (blocks 1-15, the BiFPN and the
    heads at T·B) against JAX's ``forward_from_block1`` sample by sample."""
    model = case["model"]
    y = np.asarray(case["y_all"]).transpose(1, 0, 4, 2, 3).reshape(T * B, -1, *case["y_all"].shape[2:4])
    masks = MaskTable(case["sites"])
    with torch.inference_mode():
        feats = model.backbone_features(torch.from_numpy(y.copy()), masks, start_block=1)
        cls, box = model.head_outputs(model.bifpn(feats), masks, T)
    for g, w in zip(cls + box, case["cls"] + case["box"]):
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL)


def test_mc_forward_takes_the_fold_and_matches(case):
    assert mc_fast.fast_mc_eligible(case["torch_cfg"], case["model"])
    with torch.inference_mode():
        cls, box = mc_forward(case["model"], torch.from_numpy(case["images"]), T,
                              MaskTable(tables(case)))
    for g, w in zip(cls + box, case["cls"] + case["box"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def box_iou(a, b):
    """IoU matrix of [N, 4] and [M, 4] y1x1y2x2 boxes."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.prod(np.clip(br - tl, 0, None), -1)
    area = lambda x: np.prod(np.clip(x[:, 2:4] - x[:, :2], 0, None), -1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-12)


def match_detections(got, want, sigma_check):
    """Packed detections as matched sets: per image the same count, and each
    reference detection pairs with one port detection of the same class,
    box IoU >= 0.99 and score within 1e-4; then ``sigma_check`` on the
    pairs' box and class columns. Near-tied scores may reorder picks, so the
    order is not compared."""
    g_boxes, g_scores, g_classes, g_len = (t.numpy() for t in got)
    w_boxes, w_scores, w_classes, w_len = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(g_len, w_len)
    assert w_len.min() > 0
    for b in range(len(w_len)):
        n = int(w_len[b])
        iou = box_iou(w_boxes[b, :n], g_boxes[b, :n])
        pairs = []
        for i in range(n):
            ok = ((iou[i] >= 0.99) & (np.abs(g_scores[b, :n] - w_scores[b, i]) <= 1e-4)
                  & (g_classes[b, :n, 0] == w_classes[b, i, 0]))
            ok[[j for _, j in pairs]] = False
            assert ok.any(), f"image {b}: reference detection {i} has no match"
            pairs.append((i, int(np.argmax(ok))))
        wi, gi = map(list, zip(*pairs))
        sigma_check(g_boxes[b, gi], w_boxes[b, wi], g_classes[b, gi], w_classes[b, wi])


def check_sigmas(g_boxes, w_boxes, g_classes, w_classes):
    # aleatoric σ: rtol 1e-3. MC σ (box and class) are sqrt(E[x²] - E[x]²)
    # in f32, which cancels: compare variances to a few ulps of E[x²].
    np.testing.assert_allclose(g_boxes[:, 4:8], w_boxes[:, 4:8], rtol=1e-3, atol=1e-6)
    eps = np.finfo(np.float32).eps
    for g, w, scale in ((g_boxes[:, 8:], w_boxes[:, 8:], np.abs(w_boxes[:, :4]).max()),
                        (g_classes[:, 1:], w_classes[:, 1:], 20.0)):
        np.testing.assert_allclose(g ** 2, w ** 2, rtol=1e-3, atol=64 * eps * scale ** 2)


def test_serve_preprocessed_mc_matches_as_matched_sets(case, monkeypatch):
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
    driver.masks = MaskTable(tables(case))
    got = driver.serve_preprocessed(case["images"], scales)
    assert driver.masks.tables == []
    assert [tuple(g.shape) for g in got] == [(B, 100, 12), (B, 100), (B, 100, 9), (B,)]
    match_detections(got, want, check_sigmas)


def test_preprocess_images_matches_jax_resize():
    """Downsampling 200x256 → 100x128 (antialiased on both sides) onto a
    128x128 canvas. The triangle-filter weights are computed differently
    (JAX in f32, PyTorch's separable AA kernel); both normalised inputs are
    O(1) and agree to 1e-5."""
    raw = np.random.RandomState(5).randint(0, 256, (B, 200, 256, 3)).astype(np.uint8)
    jax_cfg, _ = configs()
    got, g_scale = preprocess_images(torch.from_numpy(raw), jax_cfg.image_size,
                                     jax_cfg.mean_rgb, jax_cfg.stddev_rgb)
    want, w_scale = jax_preprocess(jnp.asarray(raw), jax_cfg.image_size,
                                   jax_cfg.mean_rgb, jax_cfg.stddev_rgb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(g_scale.numpy(), np.asarray(w_scale))


def test_serve_deterministic_end_to_end(case):
    """MC off: uint8 images through preprocess (a real resize), the network
    and the global postprocess. The JAX side runs the body of its
    ``ServingDriver._serve_impl`` with the network unjitted and the
    postprocess jitted: compiling the whole serving program on the CPU
    takes minutes."""
    jax_cfg, torch_cfg = configs(mc=False)
    v = case["variables"]
    raw = np.random.RandomState(6).randint(0, 256, (B, 200, 256, 3)).astype(np.uint8)
    images, scales = jax_preprocess(jnp.asarray(raw), jax_cfg.image_size,
                                    jax_cfg.mean_rgb, jax_cfg.stddev_rgb)
    cls, box = JaxNet(jax_cfg).apply(v, images, False)
    want = jax.jit(lambda c, b, s: postprocess_global(jax_cfg, c, b, image_scales=s))(
        list(cls), list(box), scales).packed()
    got = ServingDriver(torch_cfg, flax_to_torch(v["params"], v["batch_stats"]),
                        device="cpu").serve(raw)
    assert [tuple(g.shape) for g in got] == [(B, 100, 8), (B, 100), (B, 100), (B,)]

    def check_al(g_boxes, w_boxes, g_classes, w_classes):
        np.testing.assert_allclose(g_boxes[:, 4:8], w_boxes[:, 4:8], rtol=1e-3, atol=1e-6)

    as_cols = lambda p: (p[0], p[1], p[2][..., None], p[3])  # noqa: E731
    match_detections(as_cols(got), as_cols(want), check_al)


def test_serving_driver_runs_on_the_card_unless_asked(case, monkeypatch):
    """Built without ``device`` the driver takes the card; without one it
    raises before building anything, and never serves on the CPU quietly.
    The CPU is asked for by name."""
    v = case["variables"]
    state = flax_to_torch(v["params"], v["batch_stats"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServingDriver(case["torch_cfg"], state)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServingDriver(case["torch_cfg"], state, device="cuda:0")
    driver = ServingDriver(case["torch_cfg"], state, device="cpu")
    assert driver.device.type == "cpu" and driver.dtype == torch.float32
