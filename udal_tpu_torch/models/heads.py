"""Class / box / segmentation heads in PyTorch: port of ``udal_tpu/models/heads.py``.

``box_class_repeats`` conv→BN→act blocks whose convs are shared across
pyramid levels, with a BatchNorm per (repeat, level); MC dropout
(channel-wise) after each activation; the focal-loss prior bias on the
class logits; 8·A box channels under loss attenuation. The segmentation
head decodes the pyramid from its coarsest level up with transposed convs
that reproduce flax's ``ConvTranspose(padding="SAME")``.

Flax names these scopes ``class-0``, ``class-0-bn-3``, ``class-predict`` —
hyphens that cannot be Python attributes — so the heads are
``nn.ModuleDict``s keyed by those names, and the state dict keys follow
the flax paths. At inference on a card each tower layer (separable conv,
the level's BatchNorm, activation, dropout mask) and each predict conv is
one ``fused_sepconv`` call where ``takes_fused`` says so (``bifpn.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from udal_tpu_torch.models.bifpn import SeparableConv, takes_fused
from udal_tpu_torch.models.efficientnet import (BatchNorm, ChannelDropout, Conv2d, KernelFold,
                                                activation_fn, dropout_mask, spatial_dropout)
from udal_tpu_torch.ops.fused_sepconv import fold_sepconv_bn

# focal-loss prior: P(foreground) = 0.01 at init
CLASS_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class _HeadStack(KernelFold, nn.ModuleDict):
    """Shared conv tower applied per level with per-(repeat, level) BN."""

    def __init__(self, num_levels: int, num_filters: int, repeats: int, prefix: str,
                 separable_conv: bool = True, act_type: str = "swish",
                 survival_prob: Optional[float] = None, mc_dropoutrate: float = 0.0):
        super().__init__()
        self.prefix = prefix
        self.repeats = repeats
        self.num_levels = num_levels
        self.act_type = act_type
        self.act = activation_fn(act_type)
        self.survival_prob = survival_prob
        self.mc_dropoutrate = mc_dropoutrate
        for i in range(repeats):
            self[f"{prefix}-{i}"] = (SeparableConv(num_filters, num_filters)
                                     if separable_conv else
                                     Conv2d(num_filters, num_filters, 3))
            for level in range(num_levels):
                self[f"{prefix}-{i}-bn-{level}"] = BatchNorm(num_filters)

    def fold(self) -> Optional[Dict[str, torch.Tensor]]:
        """Each repeat's separable-conv bias with each level's BatchNorm as
        f32 (scale, bias) [repeats, levels, C]; None for plain convs."""
        if not isinstance(self[f"{self.prefix}-0"], SeparableConv):
            return None
        folds = [fold_sepconv_bn(self[f"{self.prefix}-{i}-bn-{level}"],
                                 self[f"{self.prefix}-{i}"].pointwise.bias)
                 for i in range(self.repeats) for level in range(self.num_levels)]
        shape = (self.repeats, self.num_levels, -1)
        return dict(scale=torch.stack([s for s, _ in folds]).view(shape),
                    bias=torch.stack([b for _, b in folds]).view(shape))

    def forward(self, feat: torch.Tensor, level_id: int,
                masks: Optional[ChannelDropout] = None) -> torch.Tensor:
        x = feat
        f = self.operands() if takes_fused(self[f"{self.prefix}-0"], x) else None
        for i in range(self.repeats):
            original = x
            if f is not None:
                mask = dropout_mask(masks, x.shape[0], x.shape[1], self.mc_dropoutrate, x.device)
                x = self[f"{self.prefix}-{i}"].fused(
                    x, f["scale"][i, level_id], f["bias"][i, level_id], mask, post=self.act_type)
            else:
                x = self[f"{self.prefix}-{i}"](x)
                x = self[f"{self.prefix}-{i}-bn-{level_id}"](x)
                x = self.act(x)
                x = spatial_dropout(x, self.mc_dropoutrate, masks)
            if i > 0 and self.survival_prob:
                x = x + original
        return x


class _Head(KernelFold, nn.ModuleDict):
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

    def fold(self) -> Optional[Dict[str, torch.Tensor]]:
        """The predict conv's f32 (scale, bias) [Cout]: ones and its bias;
        None for a plain conv."""
        predict = self[self.predict_name]
        if not isinstance(predict, SeparableConv):
            return None
        bias = predict.pointwise.bias.detach().to(torch.float32, copy=True)
        return dict(scale=torch.ones_like(bias), bias=bias)

    def forward(self, feats: Sequence[torch.Tensor],
                masks: Optional[ChannelDropout] = None) -> List[torch.Tensor]:
        predict = self[self.predict_name]
        outs = []
        for i, f in enumerate(feats):
            x = self["stack"](f, i, masks)
            if takes_fused(predict, x):
                f = self.operands()
                outs.append(predict.fused(x, f["scale"], f["bias"]))
            else:
                outs.append(predict(x))
        return outs


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


def conv_transpose_same_pads(k: int, s: int) -> Tuple[int, int]:
    """(before, after) padding of the stride-dilated input in
    ``jax.lax.conv_transpose(padding="SAME")``, from ``jax.lax``'s
    ``_conv_transpose_padding``: the output is s times the input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class ConvTransposeSame(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(kernel, strides, padding="SAME")`` (with
    ``transpose_kernel=False``) on NCHW tensors.

    flax dilates the input by the stride, pads it by
    ``conv_transpose_same_pads`` and correlates with its [k, k, in, out]
    kernel as it is. ``conv_transpose2d`` with no padding pads by k - 1 on
    both sides and correlates with the spatially flipped weight, so the
    weight here is flax's kernel flipped in both spatial axes, laid out
    [in, out, k, k] (``convert.py``), and the k - 1 padding is cut (or
    extended with zeros) to flax's before the bias is added.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 2):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding=0, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        a, b = conv_transpose_same_pads(k, s)
        y = F.conv_transpose2d(x, self.weight, None, self.stride)
        y = F.pad(y, (a - (k - 1), b - (k - 1)) * 2)
        return y + self.bias.to(y.dtype)[:, None, None]


class SegmentationHead(nn.Module):
    """Transposed-conv decoder: from the coarsest level up, each step
    doubles the resolution (``up{i}``, ``bn{i}``, act) and adds the next
    finer level; ``logits`` doubles it once more. NCHW levels in, NCHW
    logits [B, seg_num_classes, 2·H_min, 2·W_min] out. No dropout."""

    def __init__(self, num_classes: int, num_filters: int, num_levels: int,
                 act_type: str = "swish"):
        super().__init__()
        self.act = activation_fn(act_type)
        for i in range(num_levels - 1):
            self.add_module(f"up{i}", ConvTransposeSame(num_filters, num_filters))
            self.add_module(f"bn{i}", BatchNorm(num_filters))
        self.logits = ConvTransposeSame(num_filters, num_classes)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = feats[-1]
        for i, feat in enumerate(reversed(feats[:-1])):
            x = self.act(getattr(self, f"bn{i}")(getattr(self, f"up{i}")(x)))
            x = x + feat
        return self.logits(x)
