"""Data augmentation: RandAugment's colour subset, GridMask, Mosaic, the
weather and corruption ladders, and the training reader's policy switch.

Port of ``udal_tpu/data/augment.py``. The per-image functions take and
return numpy uint8 images, as the JAX module's do, with the same draws from
the caller's ``np.random.RandomState``; their cv2 calls are
``ops/cv_ops.py``'s and ``ops/image_ops.py``'s.

``add_weather`` and ``apply_corruption`` compute in torch: the per-image
forms run on the CPU, and ``AugmentVariants`` runs the same arithmetic on
a batch on the serving driver's device (the Validator's ``alb`` and
``aug`` serves, and its ``heq``). With ``rng=None`` (``add_weather``) and
for the ``ns`` ladder (``apply_corruption``) the JAX module draws from a
fresh ``RandomState(0)`` for every image, so those draws depend on the
image's shape alone: ``AugmentVariants`` draws them once per shape on the
host and keeps them on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from udal_tpu_torch.ops import cv_ops
from udal_tpu_torch.ops.image_ops import (gaussian_blur_uint8, resize_bilinear_float,
                                          resize_bilinear_uint8)

CORRUPTION_SEVERITIES = (0.2, 0.5, 0.8)


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(a.astype(np.float32) +
                   factor * (b.astype(np.float32) - a.astype(np.float32)),
                   0, 255).astype(np.uint8)


# -- color ops (image only) ---------------------------------------------------

def autocontrast(img: np.ndarray, _level: float) -> np.ndarray:
    out = img.astype(np.float32)
    for c in range(img.shape[-1]):
        lo, hi = out[..., c].min(), out[..., c].max()
        if hi > lo:
            out[..., c] = (out[..., c] - lo) * 255.0 / (hi - lo)
    return np.clip(out, 0, 255).astype(np.uint8)


def equalize(img: np.ndarray, _level: float) -> np.ndarray:
    """``cv2.equalizeHist`` of each channel."""
    return np.moveaxis(cv_ops.equalize_hist(np.moveaxis(img, -1, 0)), 0, -1)


def solarize(img: np.ndarray, level: float) -> np.ndarray:
    threshold = int(256 - level * 256 / 10)
    return np.where(img < threshold, img, 255 - img).astype(np.uint8)


def posterize(img: np.ndarray, level: float) -> np.ndarray:
    bits = max(1, 8 - int(level * 4 / 10))
    shift = 8 - bits
    return ((img >> shift) << shift).astype(np.uint8)


def color_jitter(img: np.ndarray, level: float) -> np.ndarray:
    gray = (img @ np.asarray([0.299, 0.587, 0.114]))[..., None]
    gray3 = np.repeat(gray, 3, -1).astype(np.uint8)
    return _blend(gray3, img, 0.1 + level * 1.8 / 10)


def contrast(img: np.ndarray, level: float) -> np.ndarray:
    mean = np.full_like(img, int(img.mean()))
    return _blend(mean, img, 0.1 + level * 1.8 / 10)


def brightness(img: np.ndarray, level: float) -> np.ndarray:
    return _blend(np.zeros_like(img), img, 0.1 + level * 1.8 / 10)


def sharpness(img: np.ndarray, level: float) -> np.ndarray:
    blurred = gaussian_blur_uint8(img[None], 3)[0].numpy()
    return _blend(blurred, img, 0.1 + level * 1.8 / 10)


COLOR_OPS: Dict[str, Callable] = {
    "AutoContrast": autocontrast, "Equalize": equalize, "Solarize": solarize,
    "Posterize": posterize, "Color": color_jitter, "Contrast": contrast,
    "Brightness": brightness, "Sharpness": sharpness,
}


def randaugment(img: np.ndarray, boxes: np.ndarray,
                num_layers: int = 2, magnitude: float = 9.0,
                rng: Optional[np.random.RandomState] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """RandAugment over the colour ops (boxes unchanged)."""
    rng = rng or np.random.RandomState(0)
    names = list(COLOR_OPS)
    for _ in range(num_layers):
        op = names[rng.randint(len(names))]
        level = rng.uniform(0, magnitude)
        img = COLOR_OPS[op](img, level)
    return img, boxes


def gridmask(img: np.ndarray, ratio: float = 0.6, d_range=(32, 96),
             rotate: int = 0,
             rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """GridMask: zero a periodic grid of cells."""
    rng = rng or np.random.RandomState(0)
    h, w = img.shape[:2]
    d = rng.randint(d_range[0], min(d_range[1], max(h, w, d_range[0] + 1)))
    keep = int(d * ratio)
    mask = np.ones((h, w), np.uint8)
    off_y, off_x = rng.randint(0, d, 2)
    ys = (np.arange(h) + off_y) % d >= keep
    xs = (np.arange(w) + off_x) % d >= keep
    mask[np.ix_(ys, xs)] = 0
    return img * mask[..., None]


def mosaic(samples: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
           out_size: Tuple[int, int],
           rng: Optional[np.random.RandomState] = None
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Four images in the quadrants around a random centre, boxes kept
    (each quadrant resized by cv2's INTER_LINEAR)."""
    rng = rng or np.random.RandomState(0)
    assert len(samples) == 4
    H, W = out_size
    cy = rng.randint(H // 4, 3 * H // 4)
    cx = rng.randint(W // 4, 3 * W // 4)
    canvas = np.zeros((H, W, 3), samples[0][0].dtype)
    quads = [(0, 0, cy, cx), (0, cx, cy, W), (cy, 0, H, cx), (cy, cx, H, W)]
    out_boxes, out_classes = [], []
    for (img, boxes, classes), (y1, x1, y2, x2) in zip(samples, quads):
        qh, qw = y2 - y1, x2 - x1
        scale_y = qh / img.shape[0]
        scale_x = qw / img.shape[1]
        resize = resize_bilinear_uint8 if img.dtype == np.uint8 else resize_bilinear_float
        canvas[y1:y2, x1:x2] = resize(img, (qh, qw))
        if len(boxes):
            b = boxes * np.asarray([scale_y, scale_x, scale_y, scale_x])
            b += np.asarray([y1, x1, y1, x1])
            area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            keep = area > 4
            out_boxes.append(b[keep])
            out_classes.append(classes[keep])
    boxes = np.concatenate(out_boxes) if out_boxes else np.zeros((0, 4))
    classes = np.concatenate(out_classes) if out_classes else np.zeros((0,))
    return canvas, boxes.astype(np.float32), classes


# -- weather / corruption ladders ---------------------------------------------

def weather_draws(weather_type: str, shape: Tuple[int, ...], severity: float,
                  rng: np.random.RandomState) -> Optional[np.ndarray]:
    """The random part of ``add_weather`` for an image of ``shape``, drawn
    from ``rng`` in the JAX module's order: rain's blurred streak map (f32
    [H, W]), snow's dilated flakes (f32 [H, W]), noise's 25·severity-scaled
    normal draws (f64 [H, W, 3]); None for fog and sat."""
    h, w = shape[:2]
    if weather_type == "rain":
        streaks = np.zeros((h, w), np.float32)
        n = int(200 * severity) + 50
        xs = rng.randint(0, w, n)
        ys = rng.randint(0, max(h - 12, 1), n)
        for x, y in zip(xs, ys):
            streaks[y:y + 12, x] = 180
        return cv_ops.gaussian_blur3_f32(streaks)
    if weather_type == "snow":
        flakes = (rng.rand(h, w) < 0.002 + 0.008 * severity).astype(np.float32)
        return cv_ops.dilate_2x2(flakes)
    if weather_type == "noise":
        return rng.randn(h, w, 3) * 25 * severity
    if weather_type in ("fog", "sat"):
        return None
    raise ValueError(f"unknown weather {weather_type!r}")


def weather_batch(images: torch.Tensor, weather_type: str, severity: float,
                  draws: Optional[torch.Tensor]) -> torch.Tensor:
    """``add_weather``'s arithmetic on uint8 ``images`` [B, H, W, 3] (on
    their device) with ``draws`` (``weather_draws``, on the same device,
    shared by every image): uint8 [B, H, W, 3]."""
    out = images.to(torch.float32)
    if weather_type == "fog":
        fog = torch.full_like(out, 255.0)
        out = out * (1 - 0.5 * severity) + fog * (0.5 * severity)
    elif weather_type == "rain":
        out = torch.clamp(out + draws[..., None], 0, 255)
        out = cv_ops.gaussian_blur3_f32(out)
    elif weather_type == "snow":
        out = torch.clamp(out + draws[..., None] * 255, 0, 255)
        out = out * (1 - 0.2 * severity) + 255 * 0.2 * severity
    elif weather_type == "noise":
        out = out.to(torch.float64) + draws
    else:
        raise ValueError(f"weather {weather_type!r} has no batched form (sat: add_weather)")
    return torch.clamp(out, 0, 255).to(torch.uint8)


def add_weather(img: np.ndarray, weather_type: str,
                severity: float = 0.5,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """fog / rain / snow / noise / sat on one uint8 image (draws from a
    fresh ``RandomState(0)`` without ``rng``)."""
    rng = rng or np.random.RandomState(0)
    if weather_type == "sat":
        hsv = cv_ops.rgb_to_hsv(img).astype(np.float32)
        hsv[..., 1] = np.clip(hsv[..., 1] * (1 + severity), 0, 255)
        return cv_ops.hsv_to_rgb(hsv.astype(np.uint8))
    draws = weather_draws(weather_type, img.shape, severity, rng)
    draws = None if draws is None else torch.from_numpy(draws)
    return weather_batch(torch.from_numpy(np.ascontiguousarray(img))[None], weather_type,
                         severity, draws)[0].numpy()


def corruption_noise(shape: Tuple[int, ...]) -> np.ndarray:
    """The ``ns`` ladder's draws: ``RandomState(0).randn(*shape)``, f64."""
    return np.random.RandomState(0).randn(*shape)


def corruption_batch(images: torch.Tensor, kind: str, severity: float,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One rung of ``apply_corruption`` on uint8 ``images`` [B, H, W, 3] on
    their device (``noise``: ``corruption_noise`` of one image's shape on
    that device, for ``ns``): uint8 [B, H, W, 3]."""
    if kind == "br":
        out = images.to(torch.float32) * (1 + severity)
    elif kind == "ct":
        x = images.to(torch.float64)
        n = images[0].numel()
        mean = images.reshape(images.shape[0], -1).sum(1, dtype=torch.int64).to(torch.float64) / n
        mean = mean.reshape(-1, 1, 1, 1)
        out = (x - mean) * (1 - severity) + mean
    elif kind == "bl":
        return gaussian_blur_uint8(images, 2 * int(1 + 4 * severity) + 1)
    elif kind == "ns":
        out = images.to(torch.float64) + noise * 40 * severity
    elif kind == "mb":
        return cv_ops.filter2d(images, cv_ops.motion_kernel(max(3, int(15 * severity))))
    else:
        raise ValueError(f"unknown corruption {kind!r}")
    return torch.clamp(out, 0, 255).to(torch.uint8)


def apply_corruption(kind: str, img: np.ndarray,
                     severities: Sequence[float] = CORRUPTION_SEVERITIES
                     ) -> List[np.ndarray]:
    """Severity ladders of brightness (br), contrast (ct), Gaussian blur
    (bl), Gaussian noise (ns) and motion blur (mb): one image per
    severity."""
    x = torch.from_numpy(np.ascontiguousarray(img))[None]
    noise = torch.from_numpy(corruption_noise(img.shape)) if kind == "ns" else None
    return [corruption_batch(x, kind, s, noise)[0].numpy() for s in severities]


class AugmentVariants:
    """The Validator's inference-time variants of a uint8 batch, computed on
    ``device``: ``heq`` (histogram equalisation of Y in YUV), the four
    ``alb`` weathers and the four ``aug`` corruption ladders. The draws that
    depend on an image's shape alone are made once per shape on the host
    and kept on the device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._draws: Dict[Tuple, Optional[torch.Tensor]] = {}

    def _cached(self, key: Tuple, make: Callable[[], Optional[np.ndarray]]):
        if key not in self._draws:
            value = make()
            self._draws[key] = None if value is None else torch.from_numpy(value).to(self.device)
        return self._draws[key]

    def heq(self, images: torch.Tensor) -> torch.Tensor:
        yuv = cv_ops.rgb_to_yuv(images)
        y = cv_ops.equalize_hist(yuv[..., 0])
        return cv_ops.yuv_to_rgb(torch.cat([y[..., None], yuv[..., 1:]], -1))

    def weather(self, images: torch.Tensor, weather_type: str,
                severity: float = 0.5) -> torch.Tensor:
        shape = tuple(images.shape[1:])
        draws = self._cached(("weather", weather_type, shape, severity),
                             lambda: weather_draws(weather_type, shape, severity,
                                                   np.random.RandomState(0)))
        return weather_batch(images, weather_type, severity, draws)

    def corruption(self, images: torch.Tensor, kind: str,
                   severities: Sequence[float] = CORRUPTION_SEVERITIES) -> List[torch.Tensor]:
        shape = tuple(images.shape[1:])
        noise = self._cached(("ns", shape), lambda: corruption_noise(shape)) \
            if kind == "ns" else None
        return [corruption_batch(images, kind, s, noise) for s in severities]


def apply_policy(policy: Optional[str], img: np.ndarray, boxes: np.ndarray,
                 rng: Optional[np.random.RandomState] = None,
                 weather_mode: str = "subjective",
                 weather_save_path: Optional[str] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The training reader's ``config.autoaugment_policy``: None, 'randaug',
    'v0'–'v3' and 'test' (the AutoAugment tables), 'albu' /
    'albumentations' (the weather bridge in ``weather_mode``, optimal
    parameters under ``weather_save_path``)."""
    from udal_tpu_torch.data import autoaugment as aa

    rng = rng or np.random.RandomState(0)
    if not policy:
        return img, boxes
    if policy == "randaug":
        return aa.distort_image_with_randaugment(img, boxes, rng=rng)
    if policy in aa.POLICIES:
        return aa.distort_image_with_autoaugment(img, boxes, policy, rng)
    if policy in ("albu", "albumentations"):
        return aa.distort_image_with_weather(
            img, boxes, mode=weather_mode, save_path=weather_save_path,
            rng=rng)
    raise ValueError(f"unknown policy {policy!r}")
