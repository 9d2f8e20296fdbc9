"""Synthetic detection frames: noise with class-coloured rectangles.

The port's copy of ``make_image_with_boxes`` (``udal_tpu/data/synthetic.py``)
with its dense-noise background only (the smooth one resizes with cv2,
which the machine with the card does not have), and ``synthetic_batch``:
a batch in the reader's fast-input contract (network-size uint8 frames,
compact padded groundtruth, each frame's valid size), made on the host from
a seed, as tests and ``chip_smoke.py`` feed ``train_and_evaluate``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def make_image_with_boxes(rng: np.random.RandomState, height: int, width: int,
                          num_objects: int, num_classes: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Noise image [H, W, 3] uint8 with bright class-coloured rectangles,
    their boxes [n, 4] (y1, x1, y2, x2) f32 and classes [n] (1-based):
    the JAX package's draws in the same order, so a seed gives the same
    frame."""
    image = rng.randint(0, 60, (height, width, 3), np.uint8)
    boxes = []
    classes = []
    palette = (np.arange(1, num_classes + 1)[:, None] *
               np.asarray([[97, 61, 37]]) % 200 + 55).astype(np.uint8)
    for _ in range(num_objects):
        h = rng.randint(height // 8, height // 2)
        w = rng.randint(width // 8, width // 2)
        y1 = rng.randint(0, height - h)
        x1 = rng.randint(0, width - w)
        cls = rng.randint(1, num_classes + 1)
        image[y1:y1 + h, x1:x1 + w] = palette[cls - 1]
        boxes.append([y1, x1, y1 + h, x1 + w])
        classes.append(cls)
    return image, np.asarray(boxes, np.float32), np.asarray(classes, np.int64)


def synthetic_batch(rng: np.random.RandomState, batch: int, height: int, width: int,
                    num_classes: int, max_objects: int = 8, max_instances: int = 16
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(uint8 images [B, H, W, 3], labels) in the fast-input contract:
    ``gt_boxes`` [B, max_instances, 4] f32 and ``gt_classes`` [B,
    max_instances] int32 padded with zeros, 1 to ``max_objects`` boxes a
    frame, and ``valid_hw`` [B, 2] (the whole frame)."""
    images = np.zeros((batch, height, width, 3), np.uint8)
    gt_boxes = np.zeros((batch, max_instances, 4), np.float32)
    gt_classes = np.zeros((batch, max_instances), np.int32)
    for b in range(batch):
        n = rng.randint(1, max_objects + 1)
        images[b], boxes, classes = make_image_with_boxes(rng, height, width, n, num_classes)
        gt_boxes[b, :n], gt_classes[b, :n] = boxes, classes
    valid_hw = np.tile(np.asarray([[height, width]], np.int32), (batch, 1))
    return images, dict(gt_boxes=gt_boxes, gt_classes=gt_classes, valid_hw=valid_hw)
