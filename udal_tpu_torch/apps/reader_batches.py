"""Adapters between the input reader's batch contracts and the serving driver.

Port of ``udal_tpu/apps/reader_batches.py``. The reader has three batch
contracts: normalised f32 at the network size; resized uint8
(``fast_input``); native-size uint8 with warp parameters
(``device_resize``). Apps that consume (images, labels) batches dispatch
through ``serve_reader_batch``, so every flow accepts all three; the uint8
contracts upload 4x fewer bytes and normalise (and warp) on the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from udal_tpu_torch.data.dataloader import denormalize_image


def is_fast_batch(images) -> bool:
    """True for a uint8 batch (numpy or torch), read without a copy."""
    dt = getattr(images, "dtype", None)
    if dt is not None:
        return dt in (np.uint8, torch.uint8)
    return np.asarray(images).dtype == np.uint8


def serve_reader_batch(driver, images, labels: Dict, structured: bool = False):
    """Serve one reader batch of any contract.

    Returns the packed tuple (default) or a structured ``Detections``
    (``structured=True``); detections are in the original-image frame (the
    driver multiplies by the reader's ``image_scales``).
    """
    scales = labels.get("image_scales")
    if is_fast_batch(images):
        kw = dict(valid_hw=labels.get("valid_hw"), image_scales=scales,
                  warp_scale=labels.get("warp_scale"),
                  warp_offset=labels.get("warp_offset"))
        if structured:
            return driver.serve_detections_preprocessed_uint8(images, **kw)
        return driver.serve_preprocessed_uint8(images, **kw)
    if structured:
        return driver.serve_detections_preprocessed(images, scales)
    return driver.serve_preprocessed(images, scales)


def groundtruth_from_labels(labels: Dict) -> np.ndarray:
    """[B, M, 7] groundtruth rows [y1, x1, y2, x2, is_crowd, area, class]
    (the classic reader contract), made from the compact fast-input labels
    when the batch has none."""
    if "groundtruth_data" in labels:
        return np.asarray(labels["groundtruth_data"])
    gb = np.asarray(labels["gt_boxes"], np.float32)
    gc = np.asarray(labels["gt_classes"], np.float32)
    area = (gb[..., 2] - gb[..., 0]) * (gb[..., 3] - gb[..., 1])
    return np.concatenate([gb, np.zeros_like(area)[..., None], area[..., None],
                           gc[..., None]], axis=-1)


def raw_pixels_from_batch(images, labels: Dict, config) -> np.ndarray:
    """uint8 pixels of a reader batch: fast-input batches are uint8 already
    (network-size, or native-size with device resize); normalised batches
    are mapped back."""
    if isinstance(images, torch.Tensor):
        images = images.cpu().numpy()
    if is_fast_batch(images):
        return np.asarray(images)
    return denormalize_image(images, config.mean_rgb, config.stddev_rgb)
