"""Synthetic detection frames: noise with class-coloured rectangles.

The port's copy of ``make_image_with_boxes`` (``udal_tpu/data/synthetic.py``)
with its dense-noise background only (the smooth one resizes with cv2,
which the machine with the card does not have); ``synthetic_batch``: a
batch in the reader's fast-input contract (network-size uint8 frames,
compact padded groundtruth, each frame's valid size), made on the host from
a seed, as tests and ``chip_smoke.py`` feed ``train_and_evaluate``; and
``encode_png``, ``make_example`` and ``write_synthetic_dataset``: the same
frames as a TFRecord of PNG-encoded tf.Examples (the port's own encoder;
JPEG encoding is not ported).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from udal_tpu_torch.data import example_codec as codec
from udal_tpu_torch.data import image_codec
from udal_tpu_torch.data import tfrecord as tfr


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


def encode_png(image: np.ndarray) -> bytes:
    """RGB uint8 [H, W, 3] → PNG bytes (``data.image_codec.encode_png``)."""
    return image_codec.encode_png(image)


def make_example(image: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
                 source_id: str, filename: str,
                 pseudo_scores: Optional[np.ndarray] = None,
                 label_map: Optional[Dict[int, str]] = None,
                 image_format: str = "png") -> bytes:
    """One sample as a serialized tf.Example of the detection schema (the
    JAX package's keys and order), its image PNG-encoded."""
    if image_format != "png":
        raise NotImplementedError(f"image_format={image_format!r}: the port encodes PNG "
                                  "only (JPEG encoding is not ported)")
    h, w = image.shape[:2]
    feats = {
        "image/encoded": codec.bytes_feature(encode_png(image)),
        "image/format": codec.bytes_feature(image_format),
        "image/height": codec.int64_feature(h),
        "image/width": codec.int64_feature(w),
        "image/filename": codec.bytes_feature(filename),
        "image/source_id": codec.bytes_feature(source_id),
        "image/object/bbox/ymin": codec.float_list_feature(boxes[:, 0] / h),
        "image/object/bbox/xmin": codec.float_list_feature(boxes[:, 1] / w),
        "image/object/bbox/ymax": codec.float_list_feature(boxes[:, 2] / h),
        "image/object/bbox/xmax": codec.float_list_feature(boxes[:, 3] / w),
        "image/object/class/label": codec.int64_list_feature(classes),
    }
    if label_map:
        feats["image/object/class/text"] = codec.bytes_list_feature(
            [label_map.get(int(c), str(c)) for c in classes])
    if pseudo_scores is not None:
        feats["image/object/pseudo_score"] = codec.float_list_feature(pseudo_scores)
    return codec.serialize_example(feats)


def write_synthetic_dataset(path: str, num_images: int = 16, height: int = 128,
                            width: int = 192, num_classes: int = 7, max_objects: int = 4,
                            seed: int = 0, pseudo_scores: bool = False,
                            image_format: str = "png") -> List[Dict]:
    """Write a synthetic TFRecord of PNG frames, the JAX package's draws
    from ``seed``; returns each image's metadata for checks."""
    if image_format != "png":
        raise NotImplementedError(f"image_format={image_format!r}: the port encodes PNG "
                                  "only (JPEG encoding is not ported)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rng = np.random.RandomState(seed)
    meta = []
    with tfr.TFRecordWriter(path) as w:
        for i in range(num_images):
            n = rng.randint(1, max_objects + 1)
            image, boxes, classes = make_image_with_boxes(rng, height, width, n, num_classes)
            ps = rng.uniform(0.3, 1.0, len(classes)).astype(np.float32) \
                if pseudo_scores else None
            w.write(make_example(image, boxes, classes, str(i), f"img{i:06d}.png", ps))
            meta.append(dict(source_id=str(i), boxes=boxes, classes=classes,
                             height=height, width=width))
    return meta
