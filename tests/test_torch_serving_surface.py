"""The port's serving surface against the JAX package's, with the same weights.

Every entry the apps reach (``serve_detections``,
``serve_detections_preprocessed``, ``serve_preprocessed_uint8`` and
``serve_detections_preprocessed_uint8`` with and without warp parameters,
``benchmark``) and ``reader_batches.serve_reader_batch`` for the reader's
three batch contracts: normalised f32, network-size uint8, native-size
uint8 with warp parameters. The deterministic config compares the
detections slot by slot; the head-only MC config replays the JAX side's
recorded masks (its ``mc_forward`` patched, as in test_torch_head_mc.py)
and compares matched sets. The JAX entries run as the package runs them
(jitted, the XLA NMS loop on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import udal_tpu.apps.reader_batches as jax_reader  # noqa: E402
import udal_tpu.apps.serving as jax_serving  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import HEAD_ONLY, configs, random_variables  # noqa: E402
from tests.test_torch_head_mc import head_samples, sigma_check  # noqa: E402
from tests.test_torch_mc import MaskTable, match_detections  # noqa: E402
from udal_tpu_torch.apps import reader_batches  # noqa: E402
from udal_tpu_torch.apps.serving import ServingDriver  # noqa: E402
from udal_tpu_torch.config import parse_image_size  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch  # noqa: E402
from udal_tpu_torch.ops.postprocess import Detections  # noqa: E402

B = 2
SCALES = np.asarray([1.25, 2.0], np.float32)
NATIVE = (90, 150)


def native_warp():
    """Warp parameters as the device-resize reader makes them for a native
    90x150 frame onto the 128x128 canvas: scale (sh/h, sw/w), offset 0,
    valid (sh, sw), image scale 1/scale."""
    h, w = NATIVE
    scale = min(128 / h, 128 / w)
    sh, sw = int(h * scale), int(w * scale)
    warp = np.asarray([[sh / h, sw / w]] * B, np.float32)
    return dict(warp_scale=warp, warp_offset=np.zeros((B, 2), np.float32),
                valid_hw=np.asarray([[sh, sw]] * B, np.int32),
                image_scales=np.full((B,), 1.0 / scale, np.float32))


def inputs():
    rng = np.random.RandomState(12)
    return dict(
        raw=rng.randint(0, 256, (B, 100, 160, 3)).astype(np.uint8),
        pre=rng.uniform(-2, 2, (B, 128, 128, 3)).astype(np.float32),
        u8=rng.randint(0, 256, (B, 128, 128, 3)).astype(np.uint8),
        u8_valid=np.asarray([[100, 128], [128, 90]], np.int32),
        native=rng.randint(0, 256, (B,) + NATIVE + (3,)).astype(np.uint8))


@pytest.fixture(scope="module")
def det():
    """Deterministic config (with the softmax logits), both drivers."""
    jax_cfg, torch_cfg = configs(extra=dict(enable_softmax=True))
    variables = random_variables(jax_cfg, seed=8)
    state = flax_to_torch(variables["params"], variables["batch_stats"])
    return dict(jax=jax_serving.ServingDriver(jax_cfg, variables, B, use_pallas_nms=False),
                port=ServingDriver(torch_cfg, state, B, device="cpu"), x=inputs())


def assert_same_detections(got, want):
    """Slot by slot: the same picks in the same order (f32 on both sides,
    random weights: no near ties), values to float32 parity."""
    assert isinstance(got, Detections)
    np.testing.assert_array_equal(got.valid_len.numpy(), np.asarray(want.valid_len))
    assert int(got.valid_len.min()) > 0
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5,
                               atol=1e-6)
    for name in ("boxes", "sigma_al", "logits"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def assert_same_packed(got, want):
    assert [tuple(g.shape) for g in got] == [tuple(np.shape(w)) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


ENTRIES = {
    "serve_detections": lambda d, x: d.serve_detections(x["raw"]),
    "serve_detections_preprocessed": lambda d, x: d.serve_detections_preprocessed(
        x["pre"], SCALES),
    "serve_detections_preprocessed_uint8": lambda d, x: d.serve_detections_preprocessed_uint8(
        x["u8"], x["u8_valid"], SCALES),
    "serve_detections_preprocessed_uint8 (warp)":
        lambda d, x: d.serve_detections_preprocessed_uint8(x["native"], **native_warp()),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_structured_entries_match(det, entry):
    got = ENTRIES[entry](det["port"], det["x"])
    assert_same_detections(got, ENTRIES[entry](det["jax"], det["x"]))


@pytest.mark.parametrize("warp", [False, True], ids=["resized", "native"])
def test_uint8_packed_entry_matches_and_agrees_with_structured(det, warp):
    x = det["x"]
    args = (x["native"],) if warp else (x["u8"], x["u8_valid"], SCALES)
    kw = native_warp() if warp else {}
    got = det["port"].serve_preprocessed_uint8(*args, **kw)
    assert_same_packed(got, det["jax"].serve_preprocessed_uint8(*args, **kw))
    structured = det["port"].serve_detections_preprocessed_uint8(*args, **kw).packed()
    assert all(torch.equal(a, b) for a, b in zip(got, structured))


def test_packed_and_structured_serves_agree(det):
    x, port = det["x"], det["port"]
    for packed, structured in ((port.serve(x["raw"]), port.serve_detections(x["raw"])),
                               (port.serve_preprocessed(x["pre"], SCALES),
                                port.serve_detections_preprocessed(x["pre"], SCALES))):
        assert len(packed) == 5      # enable_softmax: the logits last
        assert all(torch.equal(a, b) for a, b in zip(packed, structured.packed()))


def test_default_valid_hw_with_warp_is_the_network_size(det):
    """Without ``valid_hw`` the warped canvas counts as valid in full: the
    network size, not the native frame's, as in the JAX package."""
    x, port = det["x"], det["port"]
    warp = native_warp()
    warp.pop("valid_hw")
    default = port.serve_detections_preprocessed_uint8(x["native"], **warp)
    full = np.asarray([parse_image_size(port.config.image_size)] * B, np.int32)
    explicit = port.serve_detections_preprocessed_uint8(x["native"], valid_hw=full, **warp)
    assert all(torch.equal(a, b) for a, b in zip(default.packed(), explicit.packed()))
    assert_same_detections(default, det["jax"].serve_detections_preprocessed_uint8(
        x["native"], **warp))
    # without warp parameters the default is the input's own size
    images, _ = port._dispatch_uint8(x["native"], None, None, None, None)
    assert tuple(images.shape) == (B,) + NATIVE + (3,) and bool((images != 0).any(dim=2).all())


def reader_batches_of(x):
    """(images, labels) in each of the reader's three contracts."""
    warp = native_warp()
    return {
        "classic": (x["pre"], dict(image_scales=SCALES)),
        "fast_input": (x["u8"], dict(image_scales=SCALES, valid_hw=x["u8_valid"])),
        "device_resize": (x["native"], warp),
    }


@pytest.mark.parametrize("contract", ["classic", "fast_input", "device_resize"])
def test_serve_reader_batch_matches(det, contract):
    images, labels = reader_batches_of(det["x"])[contract]
    assert reader_batches.is_fast_batch(images) == (contract != "classic")
    assert reader_batches.is_fast_batch(torch.from_numpy(images)) == (contract != "classic")
    got = reader_batches.serve_reader_batch(det["port"], images, labels, structured=True)
    want = jax_reader.serve_reader_batch(det["jax"], images, labels, structured=True)
    assert_same_detections(got, want)
    packed = reader_batches.serve_reader_batch(det["port"], images, labels)
    assert all(torch.equal(a, b) for a, b in zip(packed, got.packed()))


def test_reader_label_helpers_match():
    rng = np.random.RandomState(13)
    y1x1 = rng.uniform(0, 50, (B, 5, 2))
    labels = dict(gt_boxes=np.concatenate([y1x1, y1x1 + 10], -1).astype(np.float32),
                  gt_classes=rng.randint(1, 8, (B, 5)).astype(np.float32))
    np.testing.assert_array_equal(reader_batches.groundtruth_from_labels(labels),
                                  jax_reader.groundtruth_from_labels(labels))
    classic = dict(groundtruth_data=np.ones((B, 3, 7), np.float32))
    np.testing.assert_array_equal(reader_batches.groundtruth_from_labels(classic),
                                  classic["groundtruth_data"])
    _, torch_cfg = configs()
    x = inputs()
    for images in (x["pre"], x["u8"]):
        np.testing.assert_array_equal(
            reader_batches.raw_pixels_from_batch(images, {}, torch_cfg),
            jax_reader.raw_pixels_from_batch(images, {}, torch_cfg))


def test_benchmark_returns_latency_and_fps(det):
    result = det["port"].benchmark(det["x"]["raw"], warmup=1, iters=2)
    assert set(result) == {"latency_ms", "fps"}
    assert result["latency_ms"] > 0
    assert result["fps"] == pytest.approx(B / result["latency_ms"] * 1e3)


def test_batch_size_is_kept_for_the_callers(det):
    assert det["port"].batch_size == det["jax"].batch_size == B
    created = ServingDriver.create("efficientdet-d0", overrides=dict(image_size="64x64"),
                                   batch_size=4, device="cpu")
    assert created.batch_size == 4 and created.num_members == 1


def test_head_only_uint8_warp_entry_matches_with_recorded_masks(monkeypatch):
    """The KITTI inference configuration's path at the test size: native
    uint8 frames, the warp and the normalisation on the device, head-only
    MC. The JAX side's network input is its own ``_u8_prep(_warp(...))``."""
    jax_cfg, torch_cfg = configs(mc=True, samples=2, extra=HEAD_ONLY)
    variables = random_variables(jax_cfg, seed=9)
    jdrv = jax_serving.ServingDriver(jax_cfg, variables, B, use_pallas_nms=False)
    x, warp = inputs(), native_warp()
    net_in = jdrv._u8_prep(jdrv._warp(jnp.asarray(x["native"]), jnp.asarray(warp["warp_scale"]),
                                      jnp.asarray(warp["warp_offset"])),
                           jnp.asarray(warp["valid_hw"]))
    cls, box, sites = head_samples(jax_cfg, variables, np.asarray(net_in),
                                   np.random.RandomState(14), samples=2)
    monkeypatch.setattr(jax_serving, "mc_forward", lambda *a: (cls, box))
    want = jdrv.serve_preprocessed_uint8(x["native"], **warp)

    port = ServingDriver(torch_cfg, flax_to_torch(variables["params"], variables["batch_stats"]),
                         B, device="cpu")
    port.masks = MaskTable(sites)
    got = port.serve_preprocessed_uint8(x["native"], **warp)
    assert port.masks.tables == []
    match_detections(got[:4], want[:4], sigma_check(jax_cfg, cls, box, warp["image_scales"]))
