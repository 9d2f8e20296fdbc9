"""BiFPN feature network in PyTorch: port of ``udal_tpu/models/bifpn.py``.

Weighted bidirectional fusion (attn / fastattn / channel_attn /
channel_fastattn / sum), 1x1-conv+BN channel resampling, SAME max-pool
downsampling, nearest upsampling, and a separable 3x3 conv after each
fusion. Submodules carry the flax scope names (``cell_0``, ``fnode3``,
``resample_0``, ``conv1x1`` ...). Tensors are NCHW.

At inference on a card a separable conv and what follows it (the node's
activation, its conv bias and BatchNorm; in the heads the per-level
BatchNorm, the activation and the dropout mask) run as one
``fused_sepconv`` call where ``takes_fused`` says so: a separable conv,
eval mode, no autograd, a CUDA bf16 tensor. Its operands are
the module's fold (``efficientnet.KernelFold``, kept by
``EfficientDetNet.prepare_inference``), or one made for the call where
none was kept, as ``MBConvBlock`` folds. Otherwise, in train mode, in
f32, on the CPU and for plain convs, the chain runs as the JAX modules
write it.

Flax creates a resampling 1x1 conv only where the incoming channel count
differs from the FPN width, which it learns from the input at init; here
the incoming widths are passed to the constructors instead.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from udal_tpu_torch.models.efficientnet import (BatchNorm, Conv2d, KernelFold,
                                                activation_fn, same_pads)
from udal_tpu_torch.ops.fused_sepconv import fold_sepconv_bn, fused_sepconv


def bifpn_topology(min_level: int, max_level: int) -> List[Dict[str, Any]]:
    """BiFPN node list: top-down path then bottom-up path. Offsets index
    the growing list of feature maps (inputs first, then created nodes)."""
    num_levels = max_level - min_level + 1
    node_ids = {min_level + i: [i] for i in range(num_levels)}
    id_cnt = itertools.count(num_levels)
    nodes = []
    for i in range(max_level - 1, min_level - 1, -1):
        nodes.append({"feat_level": i,
                      "inputs_offsets": [node_ids[i][-1], node_ids[i + 1][-1]]})
        node_ids[i].append(next(id_cnt))
    for i in range(min_level + 1, max_level + 1):
        nodes.append({"feat_level": i,
                      "inputs_offsets": node_ids[i][:] + [node_ids[i - 1][-1]]})
        node_ids[i].append(next(id_cnt))
    return nodes


def qufpn_topology(min_level: int, max_level: int) -> List[Dict[str, Any]]:
    """Quad-path FPN node list: (top-down → bottom-up) + (bottom-up →
    top-down) plus a final quad-add merge per level."""
    num_levels = max_level - min_level + 1
    node_ids = {min_level + i: [i] for i in range(num_levels)}
    id_cnt = itertools.count(num_levels)
    nodes: List[Dict[str, Any]] = []

    def last(l):
        return node_ids[l][-1]

    def first(l):
        return node_ids[l][0]

    for i in range(max_level - 1, min_level - 1, -1):      # top-down 1
        nodes.append({"feat_level": i,
                      "inputs_offsets": [last(i), last(i + 1)]})
        node_ids[i].append(next(id_cnt))
    node_ids[max_level].append(node_ids[max_level][-1])
    for i in range(min_level + 1, max_level):              # bottom-up 2
        nodes.append({"feat_level": i,
                      "inputs_offsets": node_ids[i][:] + [last(i - 1)]})
        node_ids[i].append(next(id_cnt))
    i = max_level
    nodes.append({"feat_level": i,
                  "inputs_offsets": [first(i)] + [last(i - 1)]})
    node_ids[i].append(next(id_cnt))
    node_ids[min_level].append(node_ids[min_level][-1])
    for i in range(min_level + 1, max_level + 1):          # bottom-up 3
        nodes.append({"feat_level": i,
                      "inputs_offsets": [
                          first(i),
                          last(i - 1) if i != min_level + 1
                          else first(i - 1)]})
        node_ids[i].append(next(id_cnt))
    node_ids[min_level].append(node_ids[min_level][-1])
    for i in range(max_level - 1, min_level, -1):          # top-down 4
        nodes.append({"feat_level": i,
                      "inputs_offsets": [node_ids[i][0], node_ids[i][-1],
                                         last(i + 1)]})
        node_ids[i].append(next(id_cnt))
    i = min_level
    nodes.append({"feat_level": i,
                  "inputs_offsets": [node_ids[i][0], last(i + 1)]})
    node_ids[i].append(next(id_cnt))
    node_ids[max_level].append(node_ids[max_level][-1])
    for i in range(max_level, min_level - 1, -1):          # quad-add
        nodes.append({"feat_level": i,
                      "inputs_offsets": [node_ids[i][2], node_ids[i][4]]})
        node_ids[i].append(next(id_cnt))
    return nodes


def get_topology(fpn_name: Optional[str], min_level: int, max_level: int
                 ) -> List[Dict[str, Any]]:
    if not fpn_name or fpn_name in ("bifpn", "bifpn_dyn"):
        return bifpn_topology(min_level, max_level)
    if fpn_name == "qufpn":
        return qufpn_topology(min_level, max_level)
    raise ValueError(f"unknown fpn_name {fpn_name!r}")


def nearest_upsample(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW ``x``: source index floor(dst *
    in / out), TF's resize_nearest_neighbor without half-pixel centres (for
    integer ratios, each pixel repeated)."""
    return F.interpolate(x, size=(target_h, target_w), mode="nearest")


def max_pool_downsample(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """SAME max-pool (-inf padding, extra row at the end) with kernel
    stride+1 and the stride chosen to hit the target size."""
    h, w = x.shape[-2], x.shape[-1]
    sh = (h - 1) // target_h + 1
    sw = (w - 1) // target_w + 1
    ph, pw = same_pads(h, sh + 1, sh), same_pads(w, sw + 1, sw)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, (sh + 1, sw + 1), (sh, sw))


class ResampleFeatureMap(nn.Module):
    """Match a feature map to (target_h, target_w, target_channels)."""

    def __init__(self, in_channels: int, target_num_channels: int, apply_bn: bool = True):
        super().__init__()
        self.conv1x1 = self.bn = None
        if in_channels != target_num_channels:
            self.conv1x1 = Conv2d(in_channels, target_num_channels, 1)
            if apply_bn:
                self.bn = BatchNorm(target_num_channels)

    def _maybe_1x1(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv1x1 is not None:
            x = self.conv1x1(x)
            if self.bn is not None:
                x = self.bn(x)
        return x

    def forward(self, x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
        h, w = x.shape[-2], x.shape[-1]
        if h > target_h and w > target_w:
            return max_pool_downsample(self._maybe_1x1(x), target_h, target_w)
        if h <= target_h and w <= target_w:
            x = self._maybe_1x1(x)
            if h < target_h or w < target_w:
                x = nearest_upsample(x, target_h, target_w)
            return x
        raise ValueError(f"Incompatible resample {h}x{w} -> {target_h}x{target_w}")


class SeparableConv(nn.Module):
    """Depthwise kxk + pointwise 1x1 (Keras SeparableConv2D)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True):
        super().__init__()
        self.depthwise = Conv2d(in_channels, in_channels, kernel_size,
                                groups=in_channels, bias=False)
        self.pointwise = Conv2d(in_channels, features, 1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))

    def fused(self, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              mask: Optional[torch.Tensor] = None, pre: str = "identity",
              post: str = "identity") -> torch.Tensor:
        """post(pointwise(depthwise(pre(x))) folded by (scale, bias)) · mask
        as one ``fused_sepconv`` call (the pointwise bias is in ``bias``);
        under autocast the weights are cast to x's type, as the chain's
        convolutions cast them."""
        taps, w = self.depthwise.weight, self.pointwise.weight
        if w.dtype != x.dtype:
            taps, w = taps.to(x.dtype), w.to(x.dtype)
        return fused_sepconv(x, taps, w, scale, bias, mask, pre, post)


def _kernel_takes(x: torch.Tensor) -> bool:
    """Whether the fused kernel takes x: a CUDA bf16 tensor (f32 on the
    card runs the chain, which is faster there). Tests take any CPU tensor
    for one here, to run the fused calls' plain version."""
    return x.is_cuda and x.dtype == torch.bfloat16


def takes_fused(conv: nn.Module, x: torch.Tensor) -> bool:
    """Whether ``conv`` and what follows it run as one ``fused_sepconv``
    call: it is a separable conv in eval mode, no autograd records the
    call, and the kernel takes x, in the weights' type or under autocast
    (f32 weights, bf16 activations: a mixed-precision ``eval_step``)."""
    if not isinstance(conv, SeparableConv) or conv.training or not _kernel_takes(x):
        return False
    weight = conv.pointwise.weight
    return (x.dtype == weight.dtype or torch.is_autocast_enabled(x.device.type)) and not (
        torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad))


def fuse_features(nodes: Sequence[torch.Tensor], weights: Optional[torch.Tensor],
                  weight_method: str) -> torch.Tensor:
    """Weighted feature fusion of same-shape NCHW maps."""
    dtype = nodes[0].dtype
    if weight_method == "attn":
        norm = torch.softmax(weights.to(dtype), dim=0)
        return sum(n * norm[i] for i, n in enumerate(nodes))
    if weight_method == "fastattn":
        w = torch.relu(weights.to(dtype))
        total = torch.sum(w) + 1e-4
        return sum(n * (w[i] / total) for i, n in enumerate(nodes))
    if weight_method == "channel_attn":
        norm = torch.softmax(weights.to(dtype), dim=-1)            # [C, E]
        return sum(n * norm[:, i, None, None] for i, n in enumerate(nodes))
    if weight_method == "channel_fastattn":
        w = torch.relu(weights.to(dtype))
        total = torch.sum(w, dim=-1) + 1e-4                        # [C]
        return sum(n * (w[:, i] / total)[:, None, None] for i, n in enumerate(nodes))
    if weight_method == "sum":
        out = nodes[0]
        for n in nodes[1:]:
            out = out + n
        return out
    raise ValueError(f"unknown weight_method {weight_method!r}")


class FNode(KernelFold, nn.Module):
    """One BiFPN node: resample inputs → weighted fuse → act+sepconv+BN."""

    def __init__(self, feat_level_hw: Tuple[int, int], in_channels: Sequence[int],
                 fpn_num_filters: int, weight_method: str = "fastattn",
                 act_type: str = "swish", conv_bn_act_pattern: bool = False,
                 separable_conv: bool = True, apply_bn_for_resampling: bool = True):
        super().__init__()
        self.feat_level_hw = feat_level_hw
        self.weight_method = weight_method
        self.conv_bn_act_pattern = conv_bn_act_pattern
        self.act_type = act_type
        self.act = activation_fn(act_type)
        for i, c in enumerate(in_channels):
            self.add_module(f"resample_{i}", ResampleFeatureMap(
                c, fpn_num_filters, apply_bn_for_resampling))
        self.num_inputs = len(in_channels)
        self.edge_weights = None
        if weight_method in ("attn", "fastattn"):
            self.edge_weights = nn.Parameter(torch.ones(self.num_inputs))
        elif weight_method in ("channel_attn", "channel_fastattn"):
            self.edge_weights = nn.Parameter(torch.ones(fpn_num_filters, self.num_inputs))
        if separable_conv:
            self.conv = SeparableConv(fpn_num_filters, fpn_num_filters,
                                      use_bias=not conv_bn_act_pattern)
        else:
            self.conv = Conv2d(fpn_num_filters, fpn_num_filters, 3,
                               bias=not conv_bn_act_pattern)
        self.bn = BatchNorm(fpn_num_filters)

    def fold(self) -> Optional[Dict[str, torch.Tensor]]:
        """The separable conv's bias and the node's BatchNorm as f32 (scale,
        bias) [C]; None for a plain conv."""
        if not isinstance(self.conv, SeparableConv):
            return None
        scale, bias = fold_sepconv_bn(self.bn, self.conv.pointwise.bias)
        return dict(scale=scale, bias=bias)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        th, tw = self.feat_level_hw
        resampled = [getattr(self, f"resample_{i}")(feat, th, tw)
                     for i, feat in enumerate(inputs)]
        x = fuse_features(resampled, self.edge_weights, self.weight_method)
        if takes_fused(self.conv, x):
            acts = (self.act_type, "identity")
            pre, post = acts[::-1] if self.conv_bn_act_pattern else acts
            f = self.operands()
            return self.conv.fused(x, f["scale"], f["bias"], None, pre, post)
        if not self.conv_bn_act_pattern:
            x = self.act(x)
        x = self.bn(self.conv(x))
        if self.conv_bn_act_pattern:
            x = self.act(x)
        return x


class FPNCell(nn.Module):
    """One repeat of the BiFPN graph. ``in_channels`` are the widths of the
    incoming maps, one per level min..max."""

    def __init__(self, min_level: int, max_level: int,
                 feat_hw: Sequence[Tuple[int, int]], in_channels: Sequence[int],
                 fpn_num_filters: int, fpn_name: Optional[str] = None,
                 weight_method: str = "fastattn", act_type: str = "swish",
                 conv_bn_act_pattern: bool = False, separable_conv: bool = True,
                 apply_bn_for_resampling: bool = True):
        super().__init__()
        self.min_level, self.max_level = min_level, max_level
        self.nodes = get_topology(fpn_name, min_level, max_level)
        widths = list(in_channels)
        for i, node in enumerate(self.nodes):
            self.add_module(f"fnode{i}", FNode(
                feat_hw[node["feat_level"] - min_level],
                [widths[o] for o in node["inputs_offsets"]], fpn_num_filters,
                weight_method, act_type, conv_bn_act_pattern, separable_conv,
                apply_bn_for_resampling))
            widths.append(fpn_num_filters)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        all_feats = list(feats)
        for i, node in enumerate(self.nodes):
            all_feats.append(getattr(self, f"fnode{i}")(
                [all_feats[o] for o in node["inputs_offsets"]]))
        # per level: the last node created at that level
        outputs = []
        for level in range(self.min_level, self.max_level + 1):
            for i, node in enumerate(reversed(self.nodes)):
                if node["feat_level"] == level:
                    outputs.append(all_feats[-1 - i])
                    break
        return outputs


class FPNCells(nn.Module):
    """Stack of ``fpn_cell_repeats`` BiFPN cells."""

    def __init__(self, min_level: int, max_level: int,
                 feat_hw: Sequence[Tuple[int, int]], in_channels: Sequence[int],
                 fpn_num_filters: int, fpn_cell_repeats: int,
                 fpn_name: Optional[str] = None, weight_method: str = "fastattn",
                 act_type: str = "swish", conv_bn_act_pattern: bool = False,
                 separable_conv: bool = True, apply_bn_for_resampling: bool = True):
        super().__init__()
        self.repeats = fpn_cell_repeats
        num_levels = max_level - min_level + 1
        for rep in range(fpn_cell_repeats):
            widths = in_channels if rep == 0 else [fpn_num_filters] * num_levels
            self.add_module(f"cell_{rep}", FPNCell(
                min_level, max_level, feat_hw, widths, fpn_num_filters, fpn_name,
                weight_method, act_type, conv_bn_act_pattern, separable_conv,
                apply_bn_for_resampling))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        for rep in range(self.repeats):
            feats = getattr(self, f"cell_{rep}")(feats)
        return feats
