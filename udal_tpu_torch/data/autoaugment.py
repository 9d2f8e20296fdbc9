"""AutoAugment v0–v3 detection policies and the weather bridge, on the host.

Port of ``udal_tpu/data/autoaugment.py``: the five policy tables
(AutoAugment for detection, as the JAX package lists them), the level →
argument mappings, the 25 ops with their box co-transformation, RandAugment
over the detection op set, and the weather bridge (rain, snow, fog,
brightness/contrast, CLAHE, hue/saturation) in its ``subjective``,
``random`` and ``optimal`` parameter modes. numpy on the input reader's
worker threads; every cv2 call of the JAX module is ``ops/cv_ops.py``'s
(bit for bit but for thick rain streaks, within their stated bound). Each
op takes the caller's ``np.random.RandomState`` and draws in the JAX
module's order, so a seed gives the JAX module's image.

Boxes are absolute-pixel [N, 4] (y1, x1, y2, x2).
"""

from __future__ import annotations

import io
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from udal_tpu_torch.ops import cv_ops

MAX_LEVEL = 10.0
REPLACE = 128  # gray fill for geometric ops / cutout

# Hparams of every policy (the JAX module's).
CUTOUT_MAX_PAD_FRACTION = 0.75
CUTOUT_CONST = 100
TRANSLATE_CONST = 250
CUTOUT_BBOX_CONST = 50
TRANSLATE_BBOX_CONST = 120


# ---------------------------------------------------------------------------
# Policy tables — (op, probability, magnitude) sub-policies. Public data
# from the AutoAugment detection paper, as the JAX module lists them.
# ---------------------------------------------------------------------------

POLICY_V0 = [
    [("TranslateX_BBox", 0.6, 4), ("Equalize", 0.8, 10)],
    [("TranslateY_Only_BBoxes", 0.2, 2), ("Cutout", 0.8, 8)],
    [("Sharpness", 0.0, 8), ("ShearX_BBox", 0.4, 0)],
    [("ShearY_BBox", 1.0, 2), ("TranslateY_Only_BBoxes", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("Color", 1.0, 6)],
]

POLICY_V1 = [
    [("TranslateX_BBox", 0.6, 4), ("Equalize", 0.8, 10)],
    [("TranslateY_Only_BBoxes", 0.2, 2), ("Cutout", 0.8, 8)],
    [("Sharpness", 0.0, 8), ("ShearX_BBox", 0.4, 0)],
    [("ShearY_BBox", 1.0, 2), ("TranslateY_Only_BBoxes", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("Color", 1.0, 6)],
    [("Color", 0.0, 0), ("ShearX_Only_BBoxes", 0.8, 4)],
    [("ShearY_Only_BBoxes", 0.8, 2), ("Flip_Only_BBoxes", 0.0, 10)],
    [("Equalize", 0.6, 10), ("TranslateX_BBox", 0.2, 2)],
    [("Color", 1.0, 10), ("TranslateY_Only_BBoxes", 0.4, 6)],
    [("Rotate_BBox", 0.8, 10), ("Contrast", 0.0, 10)],
    [("Cutout", 0.2, 2), ("Brightness", 0.8, 10)],
    [("Color", 1.0, 6), ("Equalize", 1.0, 2)],
    [("Cutout_Only_BBoxes", 0.4, 6), ("TranslateY_Only_BBoxes", 0.8, 2)],
    [("Color", 0.2, 8), ("Rotate_BBox", 0.8, 10)],
    [("Sharpness", 0.4, 4), ("TranslateY_Only_BBoxes", 0.0, 4)],
    [("Sharpness", 1.0, 4), ("SolarizeAdd", 0.4, 4)],
    [("Rotate_BBox", 1.0, 8), ("Sharpness", 0.2, 8)],
    [("ShearY_BBox", 0.6, 10), ("Equalize_Only_BBoxes", 0.6, 8)],
    [("ShearX_BBox", 0.2, 6), ("TranslateY_Only_BBoxes", 0.2, 10)],
    [("SolarizeAdd", 0.6, 8), ("Brightness", 0.8, 10)],
]

POLICY_V2 = [
    [("Color", 0.0, 6), ("Cutout", 0.6, 8), ("Sharpness", 0.4, 8)],
    [("Rotate_BBox", 0.4, 8), ("Sharpness", 0.4, 2), ("Rotate_BBox", 0.8, 10)],
    [("TranslateY_BBox", 1.0, 8), ("AutoContrast", 0.8, 2)],
    [("AutoContrast", 0.4, 6), ("ShearX_BBox", 0.8, 8), ("Brightness", 0.0, 10)],
    [("SolarizeAdd", 0.2, 6), ("Contrast", 0.0, 10), ("AutoContrast", 0.6, 0)],
    [("Cutout", 0.2, 0), ("Solarize", 0.8, 8), ("Color", 1.0, 4)],
    [("TranslateY_BBox", 0.0, 4), ("Equalize", 0.6, 8), ("Solarize", 0.0, 10)],
    [("TranslateY_BBox", 0.2, 2), ("ShearY_BBox", 0.8, 8), ("Rotate_BBox", 0.8, 8)],
    [("Cutout", 0.8, 8), ("Brightness", 0.8, 8), ("Cutout", 0.2, 2)],
    [("Color", 0.8, 4), ("TranslateY_BBox", 1.0, 6), ("Rotate_BBox", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("BBox_Cutout", 1.0, 4), ("Cutout", 0.2, 8)],
    [("Rotate_BBox", 0.0, 0), ("Equalize", 0.6, 6), ("ShearY_BBox", 0.6, 8)],
    [("Brightness", 0.8, 8), ("AutoContrast", 0.4, 2), ("Brightness", 0.2, 2)],
    [("TranslateY_BBox", 0.4, 8), ("Solarize", 0.4, 6), ("SolarizeAdd", 0.2, 10)],
    [("Contrast", 1.0, 10), ("SolarizeAdd", 0.2, 8), ("Equalize", 0.2, 4)],
]

POLICY_V3 = [
    [("Posterize", 0.8, 2), ("TranslateX_BBox", 1.0, 8)],
    [("BBox_Cutout", 0.2, 10), ("Sharpness", 1.0, 8)],
    [("Rotate_BBox", 0.6, 8), ("Rotate_BBox", 0.8, 10)],
    [("Equalize", 0.8, 10), ("AutoContrast", 0.2, 10)],
    [("SolarizeAdd", 0.2, 2), ("TranslateY_BBox", 0.2, 8)],
    [("Sharpness", 0.0, 2), ("Color", 0.4, 8)],
    [("Equalize", 1.0, 8), ("TranslateY_BBox", 1.0, 8)],
    [("Posterize", 0.6, 2), ("Rotate_BBox", 0.0, 10)],
    [("AutoContrast", 0.6, 0), ("Rotate_BBox", 1.0, 6)],
    [("Equalize", 0.0, 4), ("Cutout", 0.8, 10)],
    [("Brightness", 1.0, 2), ("TranslateY_BBox", 1.0, 6)],
    [("Contrast", 0.0, 2), ("ShearY_BBox", 0.8, 0)],
    [("AutoContrast", 0.8, 10), ("Contrast", 0.2, 10)],
    [("Rotate_BBox", 1.0, 10), ("Cutout", 1.0, 10)],
    [("SolarizeAdd", 0.8, 6), ("Equalize", 0.8, 8)],
]

POLICY_TEST = [
    [("TranslateX_BBox", 1.0, 4), ("Equalize", 1.0, 10)],
]

POLICIES = {"v0": POLICY_V0, "v1": POLICY_V1, "v2": POLICY_V2,
            "v3": POLICY_V3, "test": POLICY_TEST}

RANDAUG_OPS = [  # `autoaugment.py:1926-1937`
    "Equalize", "Solarize", "Color", "Cutout", "SolarizeAdd",
    "TranslateX_BBox", "TranslateY_BBox", "ShearX_BBox", "ShearY_BBox",
    "Rotate_BBox",
]


# ---------------------------------------------------------------------------
# Pixel ops (PIL semantics, like the reference's TF re-implementations)
# ---------------------------------------------------------------------------

def blend(image1: np.ndarray, image2: np.ndarray, factor: float) -> np.ndarray:
    """image1 + factor·(image2 − image1), clipped uint8."""
    a = image1.astype(np.float32)
    b = image2.astype(np.float32)
    return np.clip(a + factor * (b - a), 0, 255).astype(np.uint8)


def _gray(img: np.ndarray) -> np.ndarray:
    return np.repeat(cv_ops.rgb_to_gray(img)[..., None], 3, axis=-1)


def color(img, factor):
    return blend(_gray(img), img, factor)


def contrast(img, factor):
    mean = float(cv_ops.rgb_to_gray(img).mean())
    degenerate = np.full_like(img, int(mean + 0.5))
    return blend(degenerate, img, factor)


def brightness(img, factor):
    return blend(np.zeros_like(img), img, factor)


def sharpness(img, factor):
    kernel = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    smoothed = cv_ops.filter2d(img, kernel)
    # PIL leaves a 1px border unsmoothed
    degenerate = img.copy()
    degenerate[1:-1, 1:-1] = smoothed[1:-1, 1:-1]
    return blend(degenerate, img, factor)


def autocontrast(img, *_):
    out = np.empty_like(img)
    for ch in range(img.shape[-1]):
        c = img[..., ch]
        lo, hi = int(c.min()), int(c.max())
        if hi <= lo:
            out[..., ch] = c
        else:
            scale = 255.0 / (hi - lo)
            out[..., ch] = np.clip((c.astype(np.float32) - lo) * scale,
                                   0, 255).astype(np.uint8)
    return out


def equalize(img, *_):
    """PIL-style per-channel histogram equalization."""
    out = np.empty_like(img)
    for ch in range(img.shape[-1]):
        c = img[..., ch]
        histo = np.bincount(c.ravel(), minlength=256)
        nonzero = histo[histo != 0]
        if len(nonzero) <= 1:
            out[..., ch] = c
            continue
        step = (histo.sum() - nonzero[-1]) // 255
        if step == 0:
            out[..., ch] = c
            continue
        lut = (np.concatenate([[0], np.cumsum(histo)[:-1]]) + step // 2) // step
        out[..., ch] = np.clip(lut, 0, 255).astype(np.uint8)[c]
    return out


def posterize(img, bits):
    shift = 8 - int(bits)
    return np.left_shift(np.right_shift(img, shift), shift)


def solarize(img, threshold):
    # compare in int16: numpy segfaults comparing a strided uint8 view with
    # an out-of-range python scalar (threshold can be 256)
    return np.where(img.astype(np.int16) < threshold, img,
                    255 - img).astype(np.uint8)


def solarize_add(img, addition, threshold=128):
    added = np.clip(img.astype(np.int32) + int(addition), 0, 255)
    return np.where(img.astype(np.int16) < threshold, added,
                    img).astype(np.uint8)


def cutout(img, pad_size, rng, replace=REPLACE):
    h, w = img.shape[:2]
    cy, cx = rng.randint(h), rng.randint(w)
    y1, y2 = max(cy - pad_size, 0), min(cy + pad_size, h)
    x1, x2 = max(cx - pad_size, 0), min(cx + pad_size, w)
    out = img.copy()
    out[y1:y2, x1:x2] = replace
    return out


# ---------------------------------------------------------------------------
# Geometric ops with bbox co-transformation
# ---------------------------------------------------------------------------

def _warp(img, matrix, replace=REPLACE):
    return cv_ops.warp_affine_nearest(img, matrix[:2], replace)


def _transform_boxes(boxes, matrix, h, w):
    """Map (y1,x1,y2,x2) boxes through a forward affine; clip to image."""
    if len(boxes) == 0:
        return boxes
    y1, x1, y2, x2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    corners = np.stack([
        np.stack([x1, y1], -1), np.stack([x2, y1], -1),
        np.stack([x1, y2], -1), np.stack([x2, y2], -1)], axis=1)  # [N,4,2]
    ones = np.ones(corners.shape[:2] + (1,), np.float32)
    pts = np.concatenate([corners, ones], axis=-1) @ matrix[:2].T  # [N,4,2]
    xs, ys = pts[..., 0], pts[..., 1]
    out = np.stack([ys.min(1), xs.min(1), ys.max(1), xs.max(1)], axis=1)
    out[:, 0::2] = np.clip(out[:, 0::2], 0, h - 1)
    out[:, 1::2] = np.clip(out[:, 1::2], 0, w - 1)
    return out.astype(np.float32)


def translate_bbox(img, boxes, pixels, axis, replace=REPLACE):
    """TranslateX/Y with box shift; axis 0 = x, 1 = y."""
    dx, dy = (pixels, 0) if axis == 0 else (0, pixels)
    m = np.array([[1, 0, dx], [0, 1, dy], [0, 0, 1]], np.float32)
    return _warp(img, m, replace), _transform_boxes(
        boxes, m, img.shape[0], img.shape[1])


def shear_bbox(img, boxes, level, axis, replace=REPLACE):
    if axis == 0:
        m = np.array([[1, level, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    else:
        m = np.array([[1, 0, 0], [level, 1, 0], [0, 0, 1]], np.float32)
    return _warp(img, m, replace), _transform_boxes(
        boxes, m, img.shape[0], img.shape[1])


def rotate_bbox(img, boxes, degrees, replace=REPLACE):
    h, w = img.shape[:2]
    m = cv_ops.rotation_matrix_2d((w / 2.0, h / 2.0), degrees, 1.0)
    m3 = np.vstack([m, [0, 0, 1]]).astype(np.float32)
    return _warp(img, m3, replace), _transform_boxes(boxes, m3, h, w)


def bbox_cutout(img, boxes, pad_fraction, rng, replace=REPLACE):
    """Cutout inside one randomly chosen GT box (`autoaugment.py` BBox_Cutout)."""
    if len(boxes) == 0:
        return img
    b = boxes[rng.randint(len(boxes))]
    bh, bw = max(b[2] - b[0], 1), max(b[3] - b[1], 1)
    pad = int(pad_fraction * min(bh, bw))
    cy = rng.randint(int(b[0]), int(b[2]) + 1)
    cx = rng.randint(int(b[1]), int(b[3]) + 1)
    out = img.copy()
    out[max(cy - pad, 0):cy + pad, max(cx - pad, 0):cx + pad] = replace
    return out


def _apply_only_bboxes(img, boxes, fn) -> np.ndarray:
    """Apply a patch transform inside every GT box region."""
    out = img.copy()
    for b in boxes:
        y1, x1, y2, x2 = [int(v) for v in b]
        if y2 <= y1 or x2 <= x1:
            continue
        out[y1:y2 + 1, x1:x2 + 1] = fn(out[y1:y2 + 1, x1:x2 + 1])
    return out


# ---------------------------------------------------------------------------
# Level → arg mappings (`autoaugment.py:1484-1565`)
# ---------------------------------------------------------------------------

def _negate(v, rng):
    return -v if rng.rand() < 0.5 else v


def _enhance_level(level):
    return level / MAX_LEVEL * 1.8 + 0.1


def _shear_level(level, rng):
    return _negate(level / MAX_LEVEL * 0.3, rng)


def _translate_level(level, const, rng):
    return _negate(level / MAX_LEVEL * const, rng)


def _rotate_level(level, rng):
    return _negate(level / MAX_LEVEL * 30.0, rng)


def apply_op(name: str, img: np.ndarray, boxes: np.ndarray, level: float,
             rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    """Apply one named AutoAugment op at `level`; returns (image, boxes)."""
    if name == "AutoContrast":
        return autocontrast(img), boxes
    if name == "Equalize":
        return equalize(img), boxes
    if name == "Posterize":
        return posterize(img, int(level / MAX_LEVEL * 4)), boxes
    if name == "Solarize":
        return solarize(img, int(level / MAX_LEVEL * 256)), boxes
    if name == "SolarizeAdd":
        return solarize_add(img, int(level / MAX_LEVEL * 110)), boxes
    if name == "Color":
        return color(img, _enhance_level(level)), boxes
    if name == "Contrast":
        return contrast(img, _enhance_level(level)), boxes
    if name == "Brightness":
        return brightness(img, _enhance_level(level)), boxes
    if name == "Sharpness":
        return sharpness(img, _enhance_level(level)), boxes
    if name == "Cutout":
        return cutout(img, int(level / MAX_LEVEL * CUTOUT_CONST), rng), boxes
    if name == "BBox_Cutout":
        pad_frac = level / MAX_LEVEL * CUTOUT_MAX_PAD_FRACTION
        return bbox_cutout(img, boxes, pad_frac, rng), boxes
    if name == "TranslateX_BBox":
        return translate_bbox(img, boxes,
                              _translate_level(level, TRANSLATE_CONST, rng), 0)
    if name == "TranslateY_BBox":
        return translate_bbox(img, boxes,
                              _translate_level(level, TRANSLATE_CONST, rng), 1)
    if name == "ShearX_BBox":
        return shear_bbox(img, boxes, _shear_level(level, rng), 0)
    if name == "ShearY_BBox":
        return shear_bbox(img, boxes, _shear_level(level, rng), 1)
    if name == "Rotate_BBox":
        return rotate_bbox(img, boxes, _rotate_level(level, rng))
    if name == "Flip_Only_BBoxes":
        return _apply_only_bboxes(img, boxes, lambda p: p[:, ::-1]), boxes
    if name == "Equalize_Only_BBoxes":
        return _apply_only_bboxes(img, boxes, equalize), boxes
    if name == "Solarize_Only_BBoxes":
        thr = int(level / MAX_LEVEL * 256)
        return _apply_only_bboxes(img, boxes,
                                  lambda p: solarize(p, thr)), boxes
    if name == "Rotate_Only_BBoxes":
        deg = _rotate_level(level, rng)
        return _apply_only_bboxes(
            img, boxes, lambda p: rotate_bbox(p, np.zeros((0, 4)), deg)[0]), \
            boxes
    if name == "ShearX_Only_BBoxes":
        lv = _shear_level(level, rng)
        return _apply_only_bboxes(
            img, boxes,
            lambda p: shear_bbox(p, np.zeros((0, 4)), lv, 0)[0]), boxes
    if name == "ShearY_Only_BBoxes":
        lv = _shear_level(level, rng)
        return _apply_only_bboxes(
            img, boxes,
            lambda p: shear_bbox(p, np.zeros((0, 4)), lv, 1)[0]), boxes
    if name in ("TranslateX_Only_BBoxes", "TranslateY_Only_BBoxes"):
        px = _translate_level(level, TRANSLATE_BBOX_CONST, rng)
        axis = 0 if name.startswith("TranslateX") else 1
        return _apply_only_bboxes(
            img, boxes,
            lambda p: translate_bbox(p, np.zeros((0, 4)), px, axis)[0]), boxes
    if name == "Cutout_Only_BBoxes":
        pad = int(level / MAX_LEVEL * CUTOUT_BBOX_CONST)
        return _apply_only_bboxes(
            img, boxes,
            lambda p: cutout(p, pad, rng)), boxes
    raise ValueError(f"Unknown AutoAugment op {name!r}")


def distort_image_with_autoaugment(img: np.ndarray, boxes: np.ndarray,
                                   policy_name: str,
                                   rng: Optional[np.random.RandomState] = None
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pick one random sub-policy and apply its (op, prob, level) chain.

    Parity: `autoaugment.py:1694-1737` + `build_and_apply_nas_policy`.
    """
    rng = rng or np.random.RandomState()
    policy = POLICIES[policy_name]
    sub = policy[rng.randint(len(policy))]
    for (op, prob, level) in sub:
        if rng.rand() < prob:
            img, boxes = apply_op(op, img, boxes, level, rng)
    return img, boxes


def distort_image_with_randaugment(img, boxes, num_layers=1, magnitude=15,
                                   rng=None):
    """RandAugment over the detection op set (`autoaugment.py:1910-1956`)."""
    rng = rng or np.random.RandomState()
    for _ in range(num_layers):
        op = RANDAUG_OPS[rng.randint(len(RANDAUG_OPS))]
        prob = rng.uniform(0.2, 0.8)
        if rng.rand() < prob:
            img, boxes = apply_op(op, img, boxes, float(magnitude), rng)
    return img, boxes


# ---------------------------------------------------------------------------
# Weather bridge: albumentations' semantics in numpy (``ops/cv_ops.py``)
# ---------------------------------------------------------------------------

WEATHER_OPS = ["rain", "snow", "fog", "brct", "eql", "sat"]

# `subjective` fixed parameters and `random` bounds from the reference.
SUBJECTIVE_PARAMS = {
    "rain": [0.8, 20, 1, 10, 4],
    "snow": [3.0, 0.4],
    "fog": [0.3, 0.3],
    "brct": [0.3, 0.3],
    "eql": [3, 3],
    "sat": [8, 12, 8],
}
RANDOM_BOUNDS = {
    "rain": [(0.0, 1.0), (0, 100), (1, 5), (1, 10), (-20, 20)],
    "snow": [(0.0, 50), (0, 1)],
    "fog": [(0.05, 1), (0.05, 1)],
    "brct": [(-1, 1), (-1, 1)],
    "eql": [(0.05, 100), (1, 100)],
    "sat": [(-100, 100), (-100, 100), (-100, 100)],
}


class _NumbersOnly(pickle.Unpickler):
    """Unpickles plain data only (lists, tuples, numbers): any class or
    callable a pickle names is refused."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name}: an optimal-parameter file holds a "
                                     "list of numbers only")


def load_weather_params(path: str) -> List[float]:
    """The list of floats the JAX package pickled at ``path`` (its
    ``{save_path}{op}/{op}_opt_params``), through an unpickler that accepts
    lists and tuples of numbers and nothing else."""
    with open(path, "rb") as fp:
        params = _NumbersOnly(io.BytesIO(fp.read())).load()
    if not isinstance(params, (list, tuple)) or \
            not all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in params):
        raise ValueError(f"{path}: want a list of numbers, got {type(params).__name__}")
    return list(params)


def _weather_params(op: str, mode: str, save_path: Optional[str],
                    rng: np.random.RandomState) -> List[float]:
    if mode == "optimal":
        return load_weather_params(f"{save_path}{op}/{op}_opt_params")
    if mode == "random":
        return [rng.uniform(lo, hi) for (lo, hi) in RANDOM_BOUNDS[op]]
    return list(SUBJECTIVE_PARAMS[op])


def apply_weather_op(op: str, img: np.ndarray, params: Sequence[float],
                     rng: np.random.RandomState) -> np.ndarray:
    """One weather/photometric op with albumentations-equivalent params."""
    f = np.asarray(params, np.float32)
    x = img.astype(np.float32)
    if op == "rain":
        bright, drop_len, drop_w, blur, slant = f[:5]
        out = x * float(np.clip(bright, 0.1, 1.0))
        n = max(img.shape[0] * img.shape[1] // 2000, 1)
        ys = rng.randint(0, img.shape[0], n)
        xs = rng.randint(0, img.shape[1], n)
        canvas = out.astype(np.uint8).copy()
        for (yy, xx) in zip(ys, xs):
            cv_ops.draw_line(canvas, (xx, yy),
                             (int(xx + slant), int(yy + max(drop_len, 1))),
                             (200, 200, 200), max(int(drop_w), 1))
        return cv_ops.box_blur(canvas, max(int(blur), 1))
    if op == "snow":
        bright, point = f[:2]
        hls = cv_ops.rgb_to_hls(img).astype(np.float32)
        thr = 127.5 * (1 + float(np.clip(point, 0, 1)))
        light = hls[..., 1]
        boost = np.where(light < thr, light * max(bright, 1.0), light)
        hls[..., 1] = np.clip(boost, 0, 255)
        return cv_ops.hls_to_rgb(hls.astype(np.uint8))
    if op == "fog":
        coef, alpha = float(np.clip(f[0], 0, 1)), float(np.clip(f[1], 0, 1))
        fog = np.full_like(x, 255.0)
        return np.clip(x * (1 - coef * alpha) + fog * coef * alpha,
                       0, 255).astype(np.uint8)
    if op == "brct":
        b, c = float(f[0]), float(f[1])
        out = x * (1.0 + c) + 255.0 * b
        return np.clip(out, 0, 255).astype(np.uint8)
    if op == "eql":
        clip = float(max(f[0], 0.05))
        # tile grid clamped so every tile is ≥ 2px, as the JAX module clamps it
        grid = int(np.clip(round(f[1]), 1, max(min(img.shape[:2]) // 2, 1)))
        lab = cv_ops.rgb_to_lab(img)
        lab[..., 0] = cv_ops.clahe(lab[..., 0], clip, grid)
        return cv_ops.lab_to_rgb(lab)
    if op == "sat":
        hsv = cv_ops.rgb_to_hsv(img).astype(np.int32)
        hsv[..., 0] = (hsv[..., 0] + int(f[0])) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] + int(f[1]), 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] + int(f[2]), 0, 255)
        return cv_ops.hsv_to_rgb(hsv.astype(np.uint8))
    raise ValueError(f"Unknown weather op {op!r}")


def distort_image_with_weather(img: np.ndarray, boxes: np.ndarray,
                               mode: str = "subjective",
                               available_ops: Sequence[str] = tuple(WEATHER_OPS),
                               save_path: Optional[str] = None,
                               rng: Optional[np.random.RandomState] = None
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's albumentations bridge: one random op, p=0.5 gate."""
    rng = rng or np.random.RandomState()
    op = available_ops[rng.randint(len(available_ops))]
    if rng.rand() < 0.5:   # every reference transform carries p=0.5
        params = _weather_params(op, mode, save_path, rng)
        img = apply_weather_op(op, img, params, rng)
    return img, boxes
