"""Class / box prediction heads in PyTorch: port of ``udal_tpu/models/heads.py``.

``box_class_repeats`` conv→BN→act blocks whose convs are shared across
pyramid levels, with a BatchNorm per (repeat, level); MC dropout
(channel-wise) after each activation; the focal-loss prior bias on the
class logits; 8·A box channels under loss attenuation.

Flax names these scopes ``class-0``, ``class-0-bn-3``, ``class-predict`` —
hyphens that cannot be Python attributes — so the heads are
``nn.ModuleDict``s keyed by those names, and the state dict keys follow
the flax paths.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from udal_tpu_torch.models.bifpn import SeparableConv
from udal_tpu_torch.models.efficientnet import (BatchNorm, ChannelDropout, Conv2d,
                                                activation_fn, spatial_dropout)

# focal-loss prior: P(foreground) = 0.01 at init
CLASS_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class _HeadStack(nn.ModuleDict):
    """Shared conv tower applied per level with per-(repeat, level) BN."""

    def __init__(self, num_levels: int, num_filters: int, repeats: int, prefix: str,
                 separable_conv: bool = True, act_type: str = "swish",
                 survival_prob: Optional[float] = None, mc_dropoutrate: float = 0.0):
        super().__init__()
        self.prefix = prefix
        self.repeats = repeats
        self.act = activation_fn(act_type)
        self.survival_prob = survival_prob
        self.mc_dropoutrate = mc_dropoutrate
        for i in range(repeats):
            self[f"{prefix}-{i}"] = (SeparableConv(num_filters, num_filters)
                                     if separable_conv else
                                     Conv2d(num_filters, num_filters, 3))
            for level in range(num_levels):
                self[f"{prefix}-{i}-bn-{level}"] = BatchNorm(num_filters)

    def forward(self, feat: torch.Tensor, level_id: int,
                masks: Optional[ChannelDropout] = None) -> torch.Tensor:
        x = feat
        for i in range(self.repeats):
            original = x
            x = self[f"{self.prefix}-{i}"](x)
            x = self[f"{self.prefix}-{i}-bn-{level_id}"](x)
            x = self.act(x)
            x = spatial_dropout(x, self.mc_dropoutrate, masks)
            if i > 0 and self.survival_prob:
                x = x + original
        return x


class _Head(nn.ModuleDict):
    """Tower ``stack`` then the ``<prefix>-predict`` conv, level by level."""

    def __init__(self, prefix: str, out_channels: int, num_filters: int,
                 num_levels: int, repeats: int, separable_conv: bool,
                 act_type: str, survival_prob: Optional[float],
                 mc_dropoutrate: float):
        super().__init__()
        self.predict_name = f"{prefix}-predict"
        self["stack"] = _HeadStack(num_levels, num_filters, repeats, prefix,
                                   separable_conv, act_type, survival_prob,
                                   mc_dropoutrate)
        self[self.predict_name] = (SeparableConv(num_filters, out_channels)
                                   if separable_conv else
                                   Conv2d(num_filters, out_channels, 3))

    def forward(self, feats: Sequence[torch.Tensor],
                masks: Optional[ChannelDropout] = None) -> List[torch.Tensor]:
        predict = self[self.predict_name]
        return [predict(self["stack"](f, i, masks)) for i, f in enumerate(feats)]


class ClassNet(_Head):
    """Per-level class logits: [B, A * num_classes, H, W]."""

    def __init__(self, num_classes: int, num_anchors: int, num_filters: int,
                 num_levels: int, repeats: int = 4, separable_conv: bool = True,
                 act_type: str = "swish", survival_prob: Optional[float] = None,
                 mc_dropoutrate: float = 0.0):
        super().__init__("class", num_classes * num_anchors, num_filters, num_levels,
                         repeats, separable_conv, act_type, survival_prob,
                         mc_dropoutrate)


class BoxNet(_Head):
    """Per-level box regression: [B, 4 * num_anchors, H, W] (pass 2·A
    anchors for loss attenuation's (μ, σ) doubling)."""

    def __init__(self, num_anchors: int, num_filters: int, num_levels: int,
                 repeats: int = 4, separable_conv: bool = True,
                 act_type: str = "swish", survival_prob: Optional[float] = None,
                 mc_dropoutrate: float = 0.0):
        super().__init__("box", 4 * num_anchors, num_filters, num_levels, repeats,
                         separable_conv, act_type, survival_prob, mc_dropoutrate)
