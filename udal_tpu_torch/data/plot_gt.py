"""Groundtruth boxes drawn over a TFRecord shard's frames.

Port of ``udal_tpu/data/plot_gt.py``: each frame of the shard with its
groundtruth boxes and labels drawn (``utils.visualize``)
and written as an RGB PNG (``data.image_codec.write_png``) named by the
frame's file name, or ``<source_id>.png``. The JAX package writes with
cv2, which picks the format from the extension; the port encodes PNG
only, so a frame named ``*.jpg`` is written as ``<stem>.png`` (ROADMAP
A13).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from udal_tpu_torch.data import tfrecord as tfr
from udal_tpu_torch.data.dataloader import parse_detection_example
from udal_tpu_torch.data.image_codec import write_png
from udal_tpu_torch.utils.visualize import visualize_boxes_and_labels


def plot_tfrecord_groundtruth(tfrecord_path: str, out_dir: str,
                              label_map: Optional[Dict[int, str]] = None,
                              max_images: int = 16) -> int:
    """Write up to ``max_images`` frames with their groundtruth drawn under
    ``out_dir``; returns how many were written."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for record in tfr.iterate_tfrecord(tfrecord_path):
        if n >= max_images:
            break
        ex = parse_detection_example(record)
        vis = visualize_boxes_and_labels(ex.image, ex.boxes, ex.classes,
                                         scores=np.ones(len(ex.classes)), label_map=label_map,
                                         min_score_thresh=0.0)
        stem = os.path.splitext(os.path.basename(ex.filename or f"{ex.source_id}.png"))[0]
        write_png(os.path.join(out_dir, stem + ".png"), vis)
        n += 1
    return n
