"""The port's apps against the JAX package's, with the same weights, on the CPU.

Both drivers serve the test configuration of ``test_torch_fixtures.py``
(d0 at 128x128, one BiFPN cell, one head repeat, loss attenuation, softmax
logits, f32, deterministic) with the same weights through ``convert.py``,
on the reader's uint8 batches with groundtruth. Their detections agree slot
by slot (``test_torch_serving_surface.py``), so the apps' rows compare in
order: every raw field to 1e-4 relative, and 1e-4 absolute near 0, as that
test compares the serves. The calibrators are the JAX package's pickles,
converted (``convert.calibrators_from_jax``); the calibrated fields are
held to the JAX calibrators applied to the port's own raw values (an
isotonic calibrator's slope can stretch a 1e-5 difference in its input
past 1e-4). The auto-label threshold is
put midway in the widest gap between the images' largest combined
uncertainties, so a last-ulp difference cannot flip a decision.

A stub driver that hands both packages the same packed detections with MC
columns (box and class σ) covers the paths the deterministic serve does
not reach: the calibrated MC box σ, the sampled class calibration and the
``unc_*`` calibrators, with ``Calibrate.run``'s fits held as
``test_torch_calibration.py`` holds them. On the same detections, the
image artifacts too: ``InferImages(save_visualizations=True)``'s overlay
and panel PNGs (every batch contract) and its buckets' contact sheets,
equal to the JAX package's pixel for pixel, the labels' text included,
the Validator's ``metrics.txt``
files and the reliability numbers of ``Calibrate``.
"""

import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cv2  # noqa: E402

import udal_tpu.apps.calibrate_model as jax_calibrate  # noqa: E402
import udal_tpu.apps.calibration as jax_cal  # noqa: E402
import udal_tpu.apps.infer as jax_infer  # noqa: E402
import udal_tpu.apps.serving as jax_serving  # noqa: E402
import udal_tpu.apps.validate as jax_validate  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_calibration import assert_calibrators_equal  # noqa: E402
from tests.test_torch_fixtures import configs, random_variables  # noqa: E402
from tests.test_torch_visualize import assert_same_image, jax_drawings  # noqa: E402,F401
from udal_tpu_torch.apps import calibrate_model, calibration, infer, validate  # noqa: E402
from udal_tpu_torch.apps.serving import ServingDriver  # noqa: E402
from udal_tpu_torch.convert import calibrators_from_jax, flax_to_torch  # noqa: E402
from udal_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from udal_tpu_torch.ops.image_ops import gaussian_blur_uint8  # noqa: E402
from udal_tpu.utils.visualize import contact_sheet as jax_contact_sheet  # noqa: E402

B = 2
TOL = dict(rtol=1e-4, atol=1e-4)


def reader_batches(seed, n, size=128, num_classes=8):
    """n uint8 reader batches (fast-input contract) with names."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        images, labels = synthetic_batch(rng, B, size, size, num_classes)
        labels["image_names"] = [f"{seed}_{k}_{i}.png" for i in range(B)]
        out.append((images, labels))
    return out


def is_calibrated(key):
    return key.endswith(("_albox", "_mcbox", "_entropy", "_mcclass")) and \
        not key.startswith("uncalib_") and key != "rel_albox"


def assert_rows_close(got, want, recalibrate=None):
    """The same rows in the same order with the same keys; strings equal,
    numbers and lists of numbers within TOL. With ``recalibrate``, the
    calibrated fields are held instead to what the JAX package's
    calibrators give on the port's own raw row, to 1e-9: an isotonic
    calibrator's slope can be steep enough to stretch TOL on its input."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        expected = recalibrate(g) if recalibrate else {}
        for k, v in w.items():
            if isinstance(v, str):
                assert g[k] == v, k
            elif recalibrate and is_calibrated(k):
                np.testing.assert_allclose(g[k], expected[k], rtol=1e-9, atol=1e-12, err_msg=k)
            else:
                np.testing.assert_allclose(g[k], v, err_msg=k, **TOL)


def jax_recalibrator(calib_dir, num_classes, class_key):
    """Row -> the calibrated fields the JAX package's calibrators (its
    pickles) give on the row's raw σ, box (f32, as served), class and
    logits."""
    reg, cls = jax_cal.load_calibrators(calib_dir)
    box_calib = jax_cal.CalibrateBoxUncert(reg, num_classes)
    cls_calib = jax_cal.CalibrateClass(cls, num_classes)

    def recalibrate(row):
        box = np.asarray([row["bbox"]], np.float32)
        classes = np.asarray([row[class_key]])
        out = {}
        for kind in ("albox", "mcbox"):
            if f"uncalib_{kind}" in row:
                sigma = np.asarray([row[f"uncalib_{kind}"]], np.float32)
                out.update({f"{k}_{kind}": v[0] for k, v in
                            box_calib(sigma, classes, box).items()})
        out.update({f"{k}_entropy": v["entropy"][0] for k, v in
                    cls_calib(np.asarray([row["logits"]], np.float32)).items()})
        return out

    return recalibrate


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """Both drivers, the batches, and the JAX package's calibrators (fitted
    by its ``Calibrate.run``) with their conversion."""
    jax_cfg, torch_cfg = configs(extra=dict(enable_softmax=True, label_map="kitti"))
    variables = random_variables(jax_cfg, seed=8)
    state = flax_to_torch(variables["params"], variables["batch_stats"])
    root = tmp_path_factory.mktemp("apps")
    out = dict(jax=jax_serving.ServingDriver(jax_cfg, variables, B, use_pallas_nms=False),
               port=ServingDriver(torch_cfg, state, B, device="cpu"), root=root,
               calib=reader_batches(1, 2), infer=reader_batches(2, 2), val=reader_batches(3, 2))
    jax_calibrate.Calibrate(out["jax"], str(root / "calib_jax")).run(out["calib"])
    calibrators_from_jax(str(root / "calib_jax"), str(root / "calib_port"))
    return out


def test_gathered_detections_match_jax(apps):
    got = calibrate_model.Calibrate(apps["port"], "unused").gather_detections(apps["calib"])
    want = jax_calibrate.Calibrate(apps["jax"], "unused").gather_detections(apps["calib"])
    assert sorted(got) == sorted(want)
    assert len(want["gt_boxes"]) >= 8 and want["sigma_cls"].size == 0
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_split_serve_outputs_matches_jax(apps):
    images, labels = apps["infer"][0]
    got = infer.split_serve_outputs(apps["port"].config, apps["port"].serve_preprocessed_uint8(
        images, labels["valid_hw"]))
    want = jax_infer.split_serve_outputs(apps["jax"].config, apps["jax"].serve_preprocessed_uint8(
        images, labels["valid_hw"]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype.kind == np.asarray(want[k]).dtype.kind, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def gate_threshold(apps, params):
    """Midway in the widest gap between the images' largest combined
    uncertainties (the JAX side's), as a thresholds file."""
    app = jax_infer.InferImages(apps["jax"], str(apps["root"] / "probe"), opt_params=params)
    rows = app.run(apps["infer"])
    by_image = {}
    for r in rows:
        u = params[0] * r["entropy"] + params[1] * np.mean(
            calibration.relativize(np.asarray([r["bbox"]]), np.asarray([r["uncalib_albox"]])))
        by_image[r["image_name"]] = max(by_image.get(r["image_name"], -np.inf), u)
    top = np.sort(list(by_image.values()))
    i = int(np.argmax(np.diff(top) / top[1:]))
    thr = (top[i] + top[i + 1]) / 2
    d = apps["root"] / "thresholds"
    d.mkdir(exist_ok=True)
    (d / "optimal_thrs_cd_0.95_iou_0.5_0.75.txt").write_text(
        "[" + " ".join([repr(float(thr))] * 6) + "]")
    return str(d), i + 1


def test_infer_images_matches_jax(apps):
    """prediction_data.txt, the gate's labeled/examine names and the
    buckets, with the calibrators; the port adds KITTI pseudo-labels for
    the labeled images."""
    params = [0.5, 0.5]
    thr_dir, n_labeled = gate_threshold(apps, params)
    out = {}
    for name, mod, calib in (("jax", jax_infer, "calib_jax"), ("port", infer, "calib_port")):
        save = apps["root"] / f"infer_{name}"
        app = mod.InferImages(apps[name], str(save), calib_dir=str(apps["root"] / calib),
                              auto_labeling=True, opt_params=params, opt_thrs_path=thr_dir)
        rows = app.run(apps["infer"])
        read = mod.read_prediction_data(str(save / "prediction_data.txt"))
        lists = {p: (save / p / "images.txt").read_text().split()
                 for p in ("labeled", "examine")}
        out[name] = (rows, read, lists, (app.count_auto, app.count_skip), save)
    assert_rows_close(out["port"][0], out["jax"][0], jax_recalibrator(
        str(apps["root"] / "calib_jax"), 8, "class"))
    assert_rows_close(out["port"][1], out["port"][0])
    assert out["port"][2] == out["jax"][2]
    assert out["port"][3] == out["jax"][3] == (n_labeled, 2 * B - n_labeled)
    assert any(k.endswith("_albox") and k != "uncalib_albox" for k in out["port"][0][0])
    save = out["port"][4]
    for name in out["port"][2]["labeled"]:
        lines = (save / "labeled" / (os.path.splitext(name)[0] + ".txt")).read_text().splitlines()
        dets = [r for r in out["port"][0] if r["image_name"] == name]
        assert len(lines) == len(dets)
        first = lines[0].split()
        assert first[0] == {1: "car", 2: "van", 3: "truck", 4: "pedestrian", 5: "person_sitting",
                            6: "cyclist", 7: "tram"}.get(int(dets[0]["class"]),
                                                         str(int(dets[0]["class"])))
        assert float(first[4]) == pytest.approx(dets[0]["bbox"][1], abs=0.006)
    for kind in ("top10", "bottom10"):
        assert (save / kind / "images.txt").read_text().split()[::2] == \
            (out["jax"][4] / kind / "images.txt").read_text().split()[::2]


def test_infer_images_reads_every_batch_contract(apps):
    """(images, names, scales) of normalised images and (raw, names) serve
    as the JAX package's."""
    images, labels = apps["infer"][0]
    names = labels["image_names"]
    pre = ((images.astype(np.float32) - np.asarray(apps["port"].config.mean_rgb, np.float32))
           / np.asarray(apps["port"].config.stddev_rgb, np.float32))
    for batch in ((pre, names, np.asarray([1.0, 1.5], np.float32)), (images, names)):
        got = infer.InferImages(apps["port"], str(apps["root"] / "c_port")).run([batch])
        want = jax_infer.InferImages(apps["jax"], str(apps["root"] / "c_jax")).run([batch])
        assert_rows_close(got, want)


ALL_AUGMENTS = ["heq", "alb", "aug", "flip"]
AUGMENT_TAGS = {"heq": {"histeq"}, "alb": {"snow", "fog", "rain", "noise"},
                "aug": {f"{k}{s}" for k in ("ns", "mb", "ct", "br") for s in range(3)},
                "flip": {"vflip", "hflip"}}


def classic(batches, config):
    """The reader batches in the classic contract: normalised f32 images."""
    mean = np.asarray(config.mean_rgb, np.float32)
    std = np.asarray(config.stddev_rgb, np.float32)
    return [((im.astype(np.float32) - mean) / std, labels) for im, labels in batches]


@pytest.mark.parametrize("augment,preprocessed,contract", [
    (None, True, "uint8"), (["flip"], True, "uint8"), (None, False, "uint8"),
    (ALL_AUGMENTS, True, "uint8"), (ALL_AUGMENTS, True, "classic"),
    (["heq", "alb", "aug"], False, "uint8")],
    ids=["reader", "reader-flip", "raw", "reader-all-augments", "classic-all-augments",
         "raw-heq-alb-aug"])
def test_validator_matches_jax(apps, augment, preprocessed, contract):
    """Reader batches (with the flips, and with all four inference-time
    augmentations: 19 variant serves a batch, made on the driver's device
    in the port and per image in numpy and cv2 in the JAX package), in the
    uint8 and classic contracts, and the same frames as raw pixels."""
    out = {}
    batches = apps["val"] if contract == "uint8" else classic(apps["val"], apps["port"].config)
    for name, mod, calib in (("jax", jax_validate, "calib_jax"),
                             ("port", validate, "calib_port")):
        save = apps["root"] / f"val_{name}_{augment}_{preprocessed}_{contract}"
        v = mod.Validator(apps[name], str(save), calib_dir=str(apps["root"] / calib),
                          infer_augment=augment, preprocessed_batches=preprocessed)
        rows = v.run(batches)
        out[name] = (rows, mod.read_validate_results(str(save / "validate_results.txt")), save)
    assert_rows_close(out["port"][0], out["jax"][0], jax_recalibrator(
        str(apps["root"] / "calib_jax"), 8, "gt_class"))
    assert_rows_close(out["port"][1], out["port"][0])
    if augment:
        tags = {r["image_name"].split("@")[-1] for r in out["port"][0] if "@" in r["image_name"]}
        assert tags <= set().union(*(AUGMENT_TAGS[a] for a in augment))
        assert len(tags) >= len(augment)
    port, jax = out["port"][2], out["jax"][2]
    for name in ("model_performance.txt", "average_score.txt"):
        g = [float(t) for t in (port / name).read_text().replace(":", " ").split()
             if t[0].isdigit() or t[0] == "-"]
        w = [float(t) for t in (jax / name).read_text().replace(":", " ").split()
             if t[0].isdigit() or t[0] == "-"]
        np.testing.assert_allclose(g, w, **TOL)
    lines = (port / "validationstep_runtime.txt").read_text().splitlines()
    assert len(lines) == len(apps["val"]) + 1 and lines[-1].startswith("mean:")


def test_consistency_check_matches_jax(apps):
    """flip, blur (the port's on the driver's device, cv2's in the JAX
    package) and noise (the same draws) from the same base detections."""
    images = apps["infer"][0][0]
    base = jax_infer.split_serve_outputs(apps["jax"].config, apps["jax"].serve(images))
    got = infer.consistency_check(apps["port"], images, base["boxes"], base["classes"])
    want = jax_infer.consistency_check(apps["jax"], images, base["boxes"], base["classes"])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("shape", [(1, 9, 9, 3), (2, 37, 53, 3), (1, 128, 96, 1)])
@pytest.mark.parametrize("ksize", [9, 15])
def test_gaussian_blur_equals_cv2(shape, ksize):
    """Bit for bit: cv2's 8-bit path is integer arithmetic after the
    fixed-point kernel, and so is the port's."""
    images = np.random.RandomState(shape[1]).randint(0, 256, shape).astype(np.uint8)
    if min(shape[1:3]) <= ksize // 2:
        pytest.skip("frame smaller than the reflection")
    got = gaussian_blur_uint8(images, ksize).numpy()
    want = np.stack([cv2.GaussianBlur(im, (ksize, ksize), 0).reshape(im.shape) for im in images])
    np.testing.assert_array_equal(got, want)


def test_image_artifacts_name_what_is_missing(apps):
    """The Validator names an inference-time augmentation it does not
    know. (``InferImages(save_visualizations=True)`` no longer refuses:
    its artifacts are held below.)"""
    with pytest.raises(ValueError, match="nope"):
        validate.Validator(apps["port"], str(apps["root"] / "x"), infer_augment=["nope"])


# -- the MC columns, through a stub driver ---------------------------------------

class StubDriver:
    """Hands out fixed packed detections, batch after batch, from every
    serve entry: numpy for the JAX apps, tensors for the port's."""

    def __init__(self, config, packed, as_torch):
        self.config = config
        self.device = torch.device("cpu")
        self.packed = packed
        self.as_torch = as_torch
        self.calls = 0

    def _next(self, *args, **kwargs):
        out = self.packed[self.calls % len(self.packed)]
        self.calls += 1
        return tuple(torch.from_numpy(a) for a in out) if self.as_torch else out

    serve = serve_preprocessed = serve_preprocessed_uint8 = _next


def mc_packed(batches, num_classes=8, k=40, seed=0):
    """Detections near the groundtruth (and some elsewhere) with
    aleatoric, MC box and MC class σ and logits."""
    rng = np.random.RandomState(seed)
    out = []
    for _, labels in batches:
        boxes = np.zeros((B, k, 12), np.float32)
        gt = labels["gt_boxes"]
        for i in range(B):
            src = gt[i][labels["gt_classes"][i] > 0][rng.randint(0, 1 + int(
                (labels["gt_classes"][i] > 0).sum()) - 1, k)]
            boxes[i, :, :4] = src + rng.normal(0, 3, (k, 4))
        boxes[..., 4:12] = rng.uniform(0.5, 6, (B, k, 8))
        logits = rng.normal(0, 2, (B, k, num_classes)).astype(np.float32)
        classes = np.concatenate([logits.argmax(-1)[..., None] + 1.0, rng.uniform(
            0.05, 1.0, (B, k, num_classes))], -1).astype(np.float32)
        scores = np.sort(rng.uniform(0.05, 1, (B, k)), -1)[:, ::-1].astype(np.float32).copy()
        valid = (k - 7 * (np.arange(B) % 2)).astype(np.int32)
        out.append((boxes, scores, classes, valid, logits))
    return out


@pytest.fixture(scope="module")
def stubs():
    jax_cfg, torch_cfg = configs(extra=dict(enable_softmax=True, mc_dropout=True,
                                            mc_classheadrate=0.05, mc_boxheadrate=0.05))
    calib, pool = reader_batches(4, 3), reader_batches(5, 2)
    return dict(calib=calib, pool=pool, jax_cfg=jax_cfg, torch_cfg=torch_cfg,
                calib_packed=mc_packed(calib, seed=1), pool_packed=mc_packed(pool, seed=2))


def test_calibrate_run_matches_jax_with_mc_sigma(stubs, tmp_path):
    """The same detections to both: the six regression and eight
    classification calibrators (``unc_*`` from the MC class σ) fitted and
    saved alike; the port's files load back."""
    got = calibrate_model.Calibrate(StubDriver(stubs["torch_cfg"], stubs["calib_packed"], True),
                                    str(tmp_path / "port")).run(stubs["calib"])
    want = jax_calibrate.Calibrate(StubDriver(stubs["jax_cfg"], stubs["calib_packed"], False),
                                   str(tmp_path / "jax")).run(stubs["calib"])
    assert len(got[1]) == 8
    for g, w in zip(got, want):
        assert_calibrators_equal(g, w)
    for g, w in zip(calibration.load_calibrators(str(tmp_path / "port")), got):
        assert_calibrators_equal(g, w)
    with open(tmp_path / "jax" / "regression" / "regression_iso_all", "rb") as f:
        assert hasattr(pickle.load(f), "X_thresholds_")


def test_infer_and_validate_match_jax_with_mc_sigma(stubs, tmp_path):
    """Calibrated aleatoric and MC box σ, the sampled class calibration
    (``*_mcclass``, seeded by the image name) and the per-kind buckets."""
    jax_stub = StubDriver(stubs["jax_cfg"], stubs["calib_packed"], False)
    jax_calibrate.Calibrate(jax_stub, str(tmp_path / "calib_jax")).run(stubs["calib"])
    calibrators_from_jax(str(tmp_path / "calib_jax"), str(tmp_path / "calib_port"))
    for mod_j, mod_p in ((jax_infer.InferImages, infer.InferImages),
                         (jax_validate.Validator, validate.Validator)):
        rows = {}
        for name, mod, cfg, as_torch in (("jax", mod_j, stubs["jax_cfg"], False),
                                         ("port", mod_p, stubs["torch_cfg"], True)):
            app = mod(StubDriver(cfg, stubs["pool_packed"], as_torch),
                      str(tmp_path / f"{mod.__name__}_{name}"),
                      calib_dir=str(tmp_path / f"calib_{name}"))
            rows[name] = app.run(stubs["pool"])
        assert_rows_close(rows["port"], rows["jax"])
        keys = set(rows["port"][0])
        assert ("iso_percls_mcclass" in keys and "ts_all_mcbox" in keys) if \
            mod_p is infer.InferImages else "iso_all_albox" in keys
    buckets = tmp_path / "InferImages_port" / "uncert" / "upper_uncert"
    assert sorted(os.listdir(buckets)) == ["albox", "entropy", "mcbox", "mcclass"]
    for kind in os.listdir(buckets):
        assert (buckets / kind / "images.txt").read_text() == (
            tmp_path / "InferImages_jax" / "uncert" / "upper_uncert" / kind /
            "images.txt").read_text()


# -- the image artifacts and the figures' numbers, on the same detections ---------

def contract_batches(batches, config, contract):
    """The reader batches in another contract: native uint8 with warp
    parameters, normalised (images, names, scales), raw (images, names)."""
    if contract == "reader":
        return batches
    out = []
    for images, labels in batches:
        names = labels["image_names"]
        scales = np.asarray([1.0, 1.5], np.float32)
        if contract == "native":
            out.append((images, dict(labels, warp_scale=np.ones((B, 2), np.float32),
                                     warp_offset=np.zeros((B, 2), np.float32),
                                     image_scales=scales)))
        elif contract == "preprocessed":
            out.append((classic([(images, labels)], config)[0][0], names, scales))
        else:
            out.append((images, names))
    return out


@pytest.mark.parametrize("contract", ["reader", "native", "preprocessed", "raw"])
def test_infer_images_visualizations_match_jax(stubs, tmp_path, jax_drawings, contract):
    """The same detections to both drivers: the same PNG files under
    visualizations/ and in the buckets; every file's decoded pixels equal
    the JAX package's: the overlays and panels with their labels' text,
    and each bucket's contact sheet, cv2's tiling of the bucket's
    overlays in the bucket's order under their captions."""
    from PIL import Image

    from udal_tpu_torch.data.image_codec import decode_image

    saves = {}
    for name, mod, cfg, as_torch in (("jax", jax_infer, stubs["jax_cfg"], False),
                                     ("port", infer, stubs["torch_cfg"], True)):
        save = tmp_path / name
        app = mod.InferImages(StubDriver(cfg, stubs["pool_packed"], as_torch), str(save),
                              save_visualizations=True, bucket_fraction=0.5)
        app.run(contract_batches(stubs["pool"], stubs["torch_cfg"], contract))
        saves[name] = save
    assert jax_drawings
    files = {name: sorted(str(p.relative_to(save)) for p in save.rglob("*.png"))
             for name, save in saves.items()}
    assert files["port"] == files["jax"]
    sheets = [f for f in files["port"] if f.endswith("contact_sheet.png")]
    assert len(sheets) == 8
    assert len([f for f in files["port"] if f.startswith("visualizations")]) == \
        5 * len(stubs["pool"]) * B
    for f in files["port"]:
        got = decode_image((saves["port"] / f).read_bytes())
        want = np.asarray(Image.open(saves["jax"] / f))
        assert_same_image(got, want)
        if f in sheets:             # the captions drawn over cv2's tiling
            bucket = (saves["port"] / f).parent
            stems = [os.path.splitext(line.split()[0])[0]
                     for line in (bucket / "images.txt").read_text().splitlines()]
            thumbs = [decode_image((bucket / (s + ".png")).read_bytes()) for s in stems]
            assert not np.array_equal(got, jax_contact_sheet(thumbs))


def test_validator_calibration_panels_match_jax(stubs, tmp_path):
    """``aleatoric/`` and ``mcdropout/``: equal ``metrics.txt`` (the
    ``repr`` of the same three numbers) and the figure's numbers in
    ``calibration.json``, on the same detections."""
    out = {}
    for name, mod, cfg, as_torch in (("jax", jax_validate, stubs["jax_cfg"], False),
                                     ("port", validate, stubs["torch_cfg"], True)):
        mod.Validator(StubDriver(cfg, stubs["pool_packed"], as_torch),
                      str(tmp_path / name)).run(stubs["pool"])
        out[name] = tmp_path / name
    for tag in ("aleatoric", "mcdropout"):
        metrics = (out["port"] / tag / "metrics.txt").read_text()
        assert metrics == (out["jax"] / tag / "metrics.txt").read_text()
        assert (out["jax"] / tag / "calibration.png").exists()
        panel = json.loads((out["port"] / tag / "calibration.json").read_text())
        numbers = eval(metrics)
        assert {k: panel[k] for k in numbers} == numbers and panel["title"] == tag
        assert len(panel["expected"]) == len(panel["observed"]) == 100


def test_calibrate_reliability_numbers_match_jax(stubs, tmp_path, monkeypatch):
    """ECE / MCE / ACE of the raw softmax and the aleatoric σ's
    miscalibration area, sharpness and RMSUE, to 1e-9 of what the JAX
    package computes for its figures; those of the temperature-scaled
    softmax to 1e-9 of the JAX package's function at the port's own
    temperature (the two fits agree only as ``test_torch_calibration.py``
    holds them)."""
    import udal_tpu.utils.uncert_plots as jax_plots

    seen = {}
    real_reliability = jax_plots.reliability_diagram
    for fn in ("reliability_diagram", "regression_calibration_plot"):
        real = getattr(jax_plots, fn)

        def recording(*args, _real=real, **kwargs):
            seen[os.path.basename(args[2])] = _real(*args, **kwargs)
            return seen[os.path.basename(args[2])]

        monkeypatch.setattr(jax_plots, fn, recording)
    app = calibrate_model.Calibrate(StubDriver(stubs["torch_cfg"], stubs["calib_packed"], True),
                                    str(tmp_path / "port"))
    _, classification = app.run(stubs["calib"])
    jax_calibrate.Calibrate(StubDriver(stubs["jax_cfg"], stubs["calib_packed"], False),
                            str(tmp_path / "jax")).run(stubs["calib"])
    assert sorted(seen) == ["regression_reliability.png", "reliability_raw.png",
                            "reliability_ts.png"]
    data = app.gather_detections(stubs["calib"])
    probs = calibration.stable_softmax(data["logits"] / np.asarray(classification["ts_all"]))
    seen["reliability_ts.png"] = real_reliability(
        (probs.argmax(-1) + 1 == data["gt_classes"]).astype(float), probs.max(-1),
        str(tmp_path / "ts.png"))
    for png, want in seen.items():
        got = json.loads((tmp_path / "port" / "plots" / png.replace(".png", ".json")).read_text())
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-9, abs=1e-12), (png, k)
