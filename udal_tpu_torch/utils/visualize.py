"""Detections drawn over images, boxes coloured by class or uncertainty.

Port of ``udal_tpu/utils/visualize.py`` without cv2: numpy on the host,
through ``ops.cv_ops``. Boxes, label backgrounds and label text are cv2
5.0's pixels bit for bit (``cv_ops.rectangle``, ``cv_ops.get_text_size``
and ``cv_ops.put_text``, which composites cv2's measured glyph coverage),
and the contact sheet's thumbnails are cv2's INTER_LINEAR resize
(``ops.image_ops.resize_bilinear_uint8``) under captions drawn the same
way.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from udal_tpu_torch.ops.cv_ops import get_text_size, put_text, rectangle
from udal_tpu_torch.ops.image_ops import resize_bilinear_uint8

STANDARD_COLORS = [
    (0, 255, 0), (255, 0, 0), (0, 0, 255), (255, 255, 0), (255, 0, 255),
    (0, 255, 255), (255, 128, 0), (128, 0, 255), (0, 128, 255), (128, 255, 0),
]

LABEL_SCALE = 0.4
CAPTION_SCALE = 0.45


def _uncert_color(u_norm: float) -> tuple:
    """Green → yellow → red over a normalised uncertainty."""
    u = float(np.clip(u_norm, 0.0, 1.0))
    r = int(255 * min(1.0, 2 * u))
    g = int(255 * min(1.0, 2 * (1 - u)))
    return (r, g, 0)


def visualize_boxes_and_labels(image: np.ndarray, boxes: np.ndarray,
                               classes: np.ndarray, scores: np.ndarray,
                               label_map: Optional[Dict[int, str]] = None,
                               uncertainties: Optional[np.ndarray] = None,
                               min_score_thresh: float = 0.3,
                               line_thickness: int = 2) -> np.ndarray:
    """A copy of the uint8 RGB ``image`` with the detections scoring at
    least ``min_score_thresh`` drawn: boxes [N, 4] (y1, x1, y2, x2) in
    pixels, each with its label ("name: score%", and " s=σ" with
    uncertainties) in black on a background box above its top-left
    corner. Colours come from the class, or with ``uncertainties`` ([N] or
    [N, 4] σ, min-max normalised over the kept boxes) from green (lowest)
    to red (highest)."""
    img = np.ascontiguousarray(image.copy())
    keep = scores >= min_score_thresh
    boxes, classes, scores = boxes[keep], classes[keep], scores[keep]
    u = None
    if uncertainties is not None:
        u = np.asarray(uncertainties)[keep]
        if u.ndim > 1:
            u = u.mean(-1)
        rng = u.max() - u.min()
        u = (u - u.min()) / rng if rng > 0 else np.zeros_like(u)

    for i in range(len(boxes)):
        y1, x1, y2, x2 = [int(v) for v in boxes[i]]
        cls = int(classes[i])
        color = (_uncert_color(u[i]) if u is not None
                 else STANDARD_COLORS[cls % len(STANDARD_COLORS)])
        rectangle(img, (x1, y1), (x2, y2), color, line_thickness)
        name = (label_map or {}).get(cls, str(cls))
        text = f"{name}: {scores[i]:.0%}"
        if u is not None:
            text += f" s={u[i]:.2f}"
        (tw, th), _ = get_text_size(text, LABEL_SCALE, 1)
        ty = max(th + 2, y1)
        rectangle(img, (x1, ty - th - 2), (x1 + tw, ty), color, -1)
        put_text(img, text, (x1, ty - 2), LABEL_SCALE, (0, 0, 0), 1)
    return img


# Panel suffixes of the written artifacts: aleatoric box, epistemic box,
# epistemic class, entropy
UNCERTAINTY_PANELS = {
    "albox": "_mean_albox",
    "mcbox": "_mean_epbox",
    "mcclass": "_max_epcls",
    "entropy": "_entropy",
}


def overlay_panels(image: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
                   scores: np.ndarray,
                   uncert_planes: Dict[str, Optional[np.ndarray]],
                   label_map: Optional[Dict[int, str]] = None,
                   min_score_thresh: float = 0.3) -> Dict[str, np.ndarray]:
    """The plain detection overlay (suffix "") and one panel per given
    uncertainty, each colouring the same detections by that uncertainty:
    {suffix: uint8 image}."""
    out = {"": visualize_boxes_and_labels(
        image, boxes, classes, scores, label_map, min_score_thresh=min_score_thresh)}
    for kind, u in uncert_planes.items():
        if u is None:
            continue
        suffix = UNCERTAINTY_PANELS.get(kind, "_" + kind)
        out[suffix] = visualize_boxes_and_labels(
            image, boxes, classes, scores, label_map, uncertainties=u,
            min_score_thresh=min_score_thresh)
    return out


def contact_sheet(images: Sequence[np.ndarray], cols: int = 5,
                  thumb_hw: tuple = (180, 320),
                  labels: Optional[Sequence[str]] = None) -> np.ndarray:
    """The images resized to ``thumb_hw`` and tiled row by row, ``cols``
    a row, into one uint8 RGB grid; each ``labels`` entry (its first 40
    characters) captioned in yellow at its tile's top left."""
    th, tw = thumb_hw
    n = len(images)
    cols = max(1, min(cols, n))
    rows = (n + cols - 1) // cols
    canvas = np.zeros((rows * th, cols * tw, 3), np.uint8)
    for idx, im in enumerate(images):
        r, c = divmod(idx, cols)
        thumb = resize_bilinear_uint8(np.asarray(im, np.uint8), (th, tw))
        if thumb.ndim == 2:
            thumb = np.stack([thumb] * 3, -1)
        canvas[r * th:(r + 1) * th, c * tw:(c + 1) * tw] = thumb[..., :3]
        if labels is not None:
            put_text(canvas, str(labels[idx])[:40], (c * tw + 4, r * th + 16), CAPTION_SCALE,
                     (255, 255, 0), 1)
    return canvas


def draw_detection_grid(image: np.ndarray, detections_per_cell,
                        grid: tuple = (2, 2)) -> np.ndarray:
    """``visualize_boxes_and_labels`` of the image once per cell (each
    cell's keyword arguments from ``detections_per_cell``), tiled
    ``grid`` = (rows, cols)."""
    rows, cols = grid
    h, w = image.shape[:2]
    canvas = np.zeros((h * rows, w * cols, 3), np.uint8)
    for idx, det in enumerate(detections_per_cell[: rows * cols]):
        r, c = divmod(idx, cols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = visualize_boxes_and_labels(image, **det)
    return canvas
