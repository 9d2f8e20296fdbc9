"""Multi-scale anchor generation and box decoding.

Port of ``udal_tpu/ops/anchors.py``: anchors are generated once on the host
with numpy (the same code, so the same float32 values), decoding and the
training targets' encoding are elementwise torch on the flat ``[N, 4]``
anchor tensor and broadcast over any leading (sample, batch) axes.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from udal_tpu_torch.config import get_feat_sizes, parse_image_size

# Pre-NMS candidate cap.
MAX_DETECTION_POINTS = 5000


class Anchors:
    """Multiscale anchor grid: per level (min..max), per location, the
    ``num_scales * len(aspect_ratios)`` anchors interleaved, as a flat
    ``[N, 4]`` (y1, x1, y2, x2) array in input-image pixels."""

    def __init__(self, min_level: int, max_level: int, num_scales: int,
                 aspect_ratios: Sequence[Union[float, Sequence[float]]],
                 anchor_scale: Union[float, Sequence[float]],
                 image_size: Union[int, str, Tuple[int, int]]):
        self.min_level = min_level
        self.max_level = max_level
        self.num_scales = num_scales
        self.aspect_ratios = list(aspect_ratios)
        n_levels = max_level - min_level + 1
        if isinstance(anchor_scale, (list, tuple)):
            if len(anchor_scale) != n_levels:
                raise ValueError(f"need {n_levels} anchor scales, got {anchor_scale}")
            self.anchor_scales = list(anchor_scale)
        else:
            self.anchor_scales = [anchor_scale] * n_levels
        self.image_size = parse_image_size(image_size)
        self.feat_sizes = get_feat_sizes(image_size, max_level)
        self.boxes_np = self._generate_boxes()
        self._on_device: Dict[torch.device, torch.Tensor] = {}
        self._limits: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}

    def boxes(self, device) -> torch.Tensor:
        """The anchor tensor on `device` (copied there once)."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = torch.from_numpy(self.boxes_np).to(device)
        return self._on_device[device]

    def clip_limit(self, device, dtype: torch.dtype) -> torch.Tensor:
        """[h, w, h, w] of the input resolution on `device` in `dtype`
        (copied there once), the upper bound boxes are clipped to."""
        key = (torch.device(device), dtype)
        if key not in self._limits:
            h, w = self.image_size
            self._limits[key] = torch.tensor([h, w, h, w], dtype=dtype, device=key[0])
        return self._limits[key]

    def get_anchors_per_location(self) -> int:
        return self.num_scales * len(self.aspect_ratios)

    def level_slices(self) -> Dict[int, Tuple[int, int]]:
        """Flat [start, end) index range of each pyramid level's anchors."""
        out, count = {}, 0
        a = self.get_anchors_per_location()
        for level in range(self.min_level, self.max_level + 1):
            fs = self.feat_sizes[level]
            out[level] = (count, count + fs["height"] * fs["width"] * a)
            count = out[level][1]
        return out

    def _level_configs(self, level: int):
        """(stride_yx, octave, aspect, scale) per anchor shape on a level."""
        f0, fl = self.feat_sizes[0], self.feat_sizes[level]
        stride = (f0["height"] / float(fl["height"]), f0["width"] / float(fl["width"]))
        out = []
        for octave in range(self.num_scales):
            for aspect in self.aspect_ratios:
                out.append((stride, octave / float(self.num_scales), aspect,
                            self.anchor_scales[level - self.min_level]))
        return out

    def _generate_boxes(self) -> np.ndarray:
        boxes_all: List[np.ndarray] = []
        for level in range(self.min_level, self.max_level + 1):
            boxes_level = []
            for (stride, octave, aspect, scale) in self._level_configs(level):
                base_x = scale * stride[1] * 2.0 ** octave
                base_y = scale * stride[0] * 2.0 ** octave
                if isinstance(aspect, (list, tuple)):
                    aspect_x, aspect_y = aspect
                else:
                    aspect_x = np.sqrt(aspect)
                    aspect_y = 1.0 / aspect_x
                half_x = base_x * aspect_x / 2.0
                half_y = base_y * aspect_y / 2.0
                x = np.arange(stride[1] / 2, self.image_size[1], stride[1])
                y = np.arange(stride[0] / 2, self.image_size[0], stride[0])
                xv, yv = np.meshgrid(x, y)
                xv, yv = xv.reshape(-1), yv.reshape(-1)
                boxes = np.stack([yv - half_y, xv - half_x, yv + half_y, xv + half_x],
                                 axis=1)
                boxes_level.append(boxes[:, None, :])
            # [locations, anchors_per_loc, 4] -> interleave per location
            boxes_all.append(np.concatenate(boxes_level, axis=1).reshape(-1, 4))
        return np.vstack(boxes_all).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _cached_anchors(min_level, max_level, num_scales, aspect_ratios, anchor_scale,
                    image_size) -> Anchors:
    return Anchors(min_level, max_level, num_scales, list(aspect_ratios),
                   anchor_scale, image_size)


def from_config(config) -> Anchors:
    """Build (cached) anchors from a detection Config."""
    ar = tuple(tuple(a) if isinstance(a, (list, tuple)) else a
               for a in config.aspect_ratios)
    scale = config.anchor_scale
    if isinstance(scale, list):
        scale = tuple(scale)
    return _cached_anchors(config.min_level, config.max_level, config.num_scales,
                           ar, scale, parse_image_size(config.image_size))


def anchors_to_centersize(anchor_boxes: torch.Tensor):
    """(ycenter, xcenter, h, w) of corner-encoded anchors."""
    ycenter_a = (anchor_boxes[..., 0] + anchor_boxes[..., 2]) / 2
    xcenter_a = (anchor_boxes[..., 1] + anchor_boxes[..., 3]) / 2
    ha = anchor_boxes[..., 2] - anchor_boxes[..., 0]
    wa = anchor_boxes[..., 3] - anchor_boxes[..., 1]
    return ycenter_a, xcenter_a, ha, wa


def decode_box_outputs(pred_boxes: torch.Tensor,
                       anchor_boxes: torch.Tensor) -> torch.Tensor:
    """Decode (ty, tx, th, tw) regression targets to absolute (y1, x1, y2, x2)."""
    anchor_boxes = anchor_boxes.to(pred_boxes.dtype)
    ycenter_a, xcenter_a, ha, wa = anchors_to_centersize(anchor_boxes)
    ty, tx, th, tw = pred_boxes.unbind(-1)
    w = torch.exp(tw) * wa
    h = torch.exp(th) * ha
    ycenter = ty * ha + ycenter_a
    xcenter = tx * wa + xcenter_a
    return torch.stack([ycenter - h / 2.0, xcenter - w / 2.0,
                        ycenter + h / 2.0, xcenter + w / 2.0], dim=-1)


def encode_box_targets(gt_boxes: torch.Tensor, anchor_boxes: torch.Tensor,
                       eps: float = 1e-8) -> torch.Tensor:
    """Inverse of ``decode_box_outputs``: FasterRCNN box coding of
    corner-encoded boxes against their anchors, with the coder's 1e-8
    guards on every height and width."""
    ycenter_a, xcenter_a, ha, wa = anchors_to_centersize(anchor_boxes)
    ycenter_g = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
    xcenter_g = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
    hg = gt_boxes[..., 2] - gt_boxes[..., 0]
    wg = gt_boxes[..., 3] - gt_boxes[..., 1]
    ha, wa, hg, wg = ha + eps, wa + eps, hg + eps, wg + eps
    ty = (ycenter_g - ycenter_a) / ha
    tx = (xcenter_g - xcenter_a) / wa
    th = torch.log(hg / ha)
    tw = torch.log(wg / wa)
    return torch.stack([ty, tx, th, tw], dim=-1)
