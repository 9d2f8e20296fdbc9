"""EfficientDet in PyTorch: port of ``udal_tpu/models/efficientdet.py``.

Backbone → extra-level resampling → BiFPN → class/box (and segmentation)
heads, raw per-level outputs. A model is built in eval mode, the serving
forward (as the JAX modules default to ``train=False``); ``model.train()``
gives the training forward (BatchNorm on batch statistics, MC dropout at
every site from the mask source the caller passes, no kernel).
The JAX package's MC-dropout forward is a
``vmap`` over dropout keys; here the T samples are a T·B batch dimension
written out (t-major), with masks from an explicit ``ChannelDropout``
source. With dropout in the heads only, the backbone and BiFPN run once at
B and only the heads run at T·B. ``EfficientDetModel`` adds the
preprocessing and the post-processing around one pass of the network.

Public boundaries keep the JAX package's NHWC layout: images are
[B, H, W, 3] and per-level outputs [B, H, W, C] (or [T, B, H, W, C] from
``mc_forward``). Inside, tensors are NCHW.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from udal_tpu_torch.config import Config, get_feat_sizes, parse_image_size
from udal_tpu_torch.models.bifpn import FPNCells, ResampleFeatureMap
from udal_tpu_torch.models.efficientnet import (BatchNorm, ChannelDropout, EfficientNet,
                                                KernelFold, backbone_spec)
from udal_tpu_torch.models.heads import (CLASS_PRIOR_BIAS, BoxNet, ClassNet,
                                         ConvTransposeSame, SegmentationHead)
from udal_tpu_torch.ops.postprocess import per_class_nms, postprocess_global
from udal_tpu_torch.utils import profiling

# (class maps per level, box maps per level[, segmentation logits])
Outputs = Tuple[Union[List[torch.Tensor], torch.Tensor], ...]


def _nhwc(outs: Sequence) -> Outputs:
    """NCHW head outputs (lists of per-level maps, or one map) → NHWC views."""
    return tuple([t.permute(0, 2, 3, 1) for t in o] if isinstance(o, list)
                 else o.permute(0, 2, 3, 1) for o in outs)


def split_samples(outs: Outputs, num_samples: int, batch: int) -> Outputs:
    """Outputs of a t-major T·B batch → the same with [T, B, ...] maps."""
    def split(t):
        return t.reshape(num_samples, batch, *t.shape[1:])
    return tuple([split(t) for t in o] if isinstance(o, list) else split(o) for o in outs)


def head_only_mc(cfg: Config) -> bool:
    """MC dropout confined to the heads: no backbone rate, a head rate."""
    return bool(cfg.mc_dropout) and not cfg.mc_dropoutrate and \
        bool(cfg.mc_classheadrate or cfg.mc_boxheadrate)


class EfficientDetNet(nn.Module):
    """Backbone + BiFPN + the heads ``config.heads`` names."""

    def __init__(self, config: Config):
        super().__init__()
        cfg = self.config = config
        if not {"object_detection", "segmentation"} & set(cfg.heads):
            raise ValueError(f"no head to build in {cfg.heads}")
        min_level, max_level = cfg.min_level, cfg.max_level
        num_levels = self.num_levels = max_level - min_level + 1
        self.feat_sizes = get_feat_sizes(cfg.image_size, max_level)
        feat_hw = tuple((self.feat_sizes[l]["height"], self.feat_sizes[l]["width"])
                        for l in range(min_level, max_level + 1))

        mc_boxrate = mc_clsrate = mc_backbone = 0.0
        if cfg.mc_dropout:
            mc_boxrate = cfg.mc_boxheadrate or cfg.mc_dropoutrate
            mc_clsrate = cfg.mc_classheadrate or cfg.mc_dropoutrate
            mc_backbone = cfg.mc_dropoutrate

        # stochastic depth in the backbone, but never in b0's (as the JAX package)
        survival_prob = 0.0 if "b0" in cfg.backbone_name else cfg.survival_prob
        self.backbone = EfficientNet(backbone_spec(cfg.backbone_name,
                                                   survival_prob=survival_prob or None),
                                     cfg.act_type, mc_backbone)
        widths = [self.backbone.reduction_channels[l - 1]
                  for l in range(min_level, min(max_level, 5) + 1)]
        for level in range(6, max_level + 1):
            self.add_module(f"resample_p{level}", ResampleFeatureMap(
                widths[-1], cfg.fpn_num_filters, cfg.apply_bn_for_resampling))
            widths.append(cfg.fpn_num_filters)
        self.fpn_cells = FPNCells(
            min_level, max_level, feat_hw, widths, cfg.fpn_num_filters,
            cfg.fpn_cell_repeats, fpn_name=cfg.fpn_name,
            weight_method=cfg.fpn_weight_method or "fastattn",
            act_type=cfg.act_type, conv_bn_act_pattern=cfg.conv_bn_act_pattern,
            separable_conv=cfg.separable_conv,
            apply_bn_for_resampling=cfg.apply_bn_for_resampling)

        num_anchors = len(cfg.aspect_ratios) * cfg.num_scales
        if "object_detection" in cfg.heads:
            self.class_net = ClassNet(
                cfg.num_classes, num_anchors, cfg.fpn_num_filters, num_levels,
                cfg.box_class_repeats, cfg.separable_conv, cfg.act_type,
                cfg.survival_prob, mc_clsrate)
            # loss attenuation doubles the box output to 8·A (μ, σ)
            self.box_net = BoxNet(
                2 * num_anchors if cfg.loss_attenuation else num_anchors,
                cfg.fpn_num_filters, num_levels, cfg.box_class_repeats,
                cfg.separable_conv, cfg.act_type, cfg.survival_prob, mc_boxrate)
        if "segmentation" in cfg.heads:
            self.seg_head = SegmentationHead(cfg.seg_num_classes, cfg.fpn_num_filters,
                                             num_levels, cfg.act_type)
        self.eval()

    def prepare_inference(self) -> None:
        """Fold once for the fused kernels, after the weights are loaded and
        the model is on its device: every ``KernelFold`` module's (the
        backbone's MBConv blocks; each separable conv's bias with the
        BatchNorm after it: the BiFPN nodes', each head tower layer's per
        level, the predict convs'). A refold is written into the folds'
        tensors, which captured CUDA graphs read by address."""
        for m in self.modules():
            if isinstance(m, KernelFold):
                m.prepare_inference()

    def drop_folds(self) -> None:
        """Forget every fold: weights were loaded into the model in whatever
        mode it is. Until ``prepare_inference`` folds again, each fused call
        folds for itself."""
        for m in self.modules():
            if isinstance(m, KernelFold):
                m.folded = None

    def backbone_features(self, x: torch.Tensor, masks: Optional[ChannelDropout] = None,
                          start_block: int = 0) -> List[torch.Tensor]:
        """NCHW backbone input (or block ``start_block``'s input) → the
        backbone's maps from ``min_level`` on."""
        cfg = self.config
        return list(self.backbone(x, masks, start_block)[cfg.min_level:cfg.max_level + 1])

    def bifpn(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        """The backbone's maps → BiFPN maps: the extra levels resampled from
        the last, then the cells."""
        feats = list(feats)
        for level in range(6, self.config.max_level + 1):
            fs = self.feat_sizes[level]
            feats.append(getattr(self, f"resample_p{level}")(feats[-1], fs["height"], fs["width"]))
        return self.fpn_cells(feats)

    def features(self, x: torch.Tensor, masks: Optional[ChannelDropout] = None,
                 start_block: int = 0) -> List[torch.Tensor]:
        """NCHW backbone input (or block ``start_block``'s input) → BiFPN maps
        (spans ``model.backbone`` and ``model.bifpn``)."""
        with profiling.span("model.backbone", batch=x.shape[0]):
            feats = self.backbone_features(x, masks, start_block)
        with profiling.span("model.bifpn", levels=self.num_levels):
            return self.bifpn(feats)

    def predict_heads(self, feats: List[torch.Tensor],
                      masks: Optional[ChannelDropout] = None) -> Outputs:
        """NCHW heads' outputs: class and box maps per level (object
        detection), then the segmentation logits."""
        cfg = self.config
        outs = []
        if "object_detection" in cfg.heads:
            outs += [self.class_net(feats, masks), self.box_net(feats, masks)]
        if "segmentation" in cfg.heads:
            outs.append(self.seg_head(feats))
        return tuple(outs)

    def head_outputs(self, feats: List[torch.Tensor], masks: Optional[ChannelDropout] = None,
                     num_samples: Optional[int] = None, repeat: bool = False) -> Outputs:
        """NCHW BiFPN maps → NHWC heads' outputs (span ``model.heads``). With
        ``num_samples`` the maps are a t-major T·B batch (made here from maps
        at B with ``repeat``) and the outputs have [T, B, ...] maps."""
        batch = feats[0].shape[0] * (num_samples if repeat else 1)
        with profiling.span("model.heads", batch=batch, levels=self.num_levels):
            if repeat:
                feats = [f.repeat(num_samples, 1, 1, 1) for f in feats]
            outs = _nhwc(self.predict_heads(feats, masks))
            return outs if num_samples is None else split_samples(
                outs, num_samples, batch // num_samples)

    def forward(self, images: torch.Tensor,
                masks: Optional[ChannelDropout] = None) -> Outputs:
        """NHWC images [B, H, W, 3] → NHWC outputs: (class, box) per level
        [, segmentation logits]."""
        x = images.permute(0, 3, 1, 2).contiguous()
        return self.head_outputs(self.features(x, masks), masks)


def init_flax_style(model: EfficientDetNet, generator: torch.Generator) -> None:
    """Random weights drawn as flax's initializers draw them.

    Backbone, SE and BiFPN separable convs: variance_scaling(2, fan_out,
    normal); head convs: variance_scaling(1, fan_in, truncated_normal);
    resampling 1x1 convs and plain FNode convs: flax's default lecun_normal;
    plain head convs: normal(0.01). Biases 0, the class bias the focal prior
    -log(99), fuse edge weights 1, BatchNorm γ=1, β=0, mean 0, var 1.
    """

    def variance_scaling(w, scale, mode, truncated):
        receptive = w.shape[2] * w.shape[3]
        fan = (w.shape[1] if mode == "fan_in" else w.shape[0]) * receptive
        std = math.sqrt(scale / fan)
        if truncated:   # flax truncates at ±2 std and rescales to unit variance
            std /= 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        else:
            nn.init.normal_(w, 0.0, std, generator=generator)

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, ConvTransposeSame):
                # flax's default lecun_normal over its [k, k, in, out] kernel
                fan_in = mod.weight.shape[0] * mod.weight.shape[2] * mod.weight.shape[3]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.Conv2d):
                head = name.startswith(("class_net.", "box_net."))
                separable = name.endswith((".depthwise", ".pointwise"))
                if head and separable:
                    variance_scaling(mod.weight, 1.0, "fan_in", True)
                elif head:
                    nn.init.normal_(mod.weight, 0.0, 0.01, generator=generator)
                elif name.endswith(".conv1x1") or name.endswith(".conv"):
                    variance_scaling(mod.weight, 1.0, "fan_in", True)
                else:
                    variance_scaling(mod.weight, 2.0, "fan_out", False)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, BatchNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
                nn.init.zeros_(mod.running_mean)
                nn.init.ones_(mod.running_var)
            if getattr(mod, "edge_weights", None) is not None:
                nn.init.ones_(mod.edge_weights)
        if "object_detection" in model.config.heads:
            predict = model.class_net[model.class_net.predict_name]
            bias = predict.pointwise.bias if hasattr(predict, "pointwise") else predict.bias
            nn.init.constant_(bias, CLASS_PRIOR_BIAS)


def mc_forward(model: EfficientDetNet, images: torch.Tensor, num_samples: int,
               masks: ChannelDropout) -> Outputs:
    """MC-dropout forward of NHWC images: outputs with [T, B, H, W, C] maps.

    With dropout in the heads only, the backbone and BiFPN run once at B
    and their maps are repeated t-major for the heads at T·B. Otherwise
    takes the shared-prefix + block-0 fold (``mc_fast.py``) where it
    applies exactly, else runs the T samples as one t-major T·B batch: the
    stages of ``models/stages.py``.
    """
    from udal_tpu_torch.models.stages import forward_kind, forward_stages, run_stages

    stages = forward_stages([model], forward_kind(model, mc=True), images.shape[0], num_samples)
    return run_stages(stages, dict(images=images, masks=masks))


class EfficientDetModel(EfficientDetNet):
    """``EfficientDetNet`` with the preprocessing and the post-processing
    in one call, as the JAX package's ``EfficientDetModel``."""

    def forward(self, raw_images: torch.Tensor, masks: Optional[ChannelDropout] = None,
                pre_mode: Optional[str] = "infer", post_mode: Optional[str] = "global"):
        """``pre_mode="infer"``: raw [B, H, W, 3] images are normalised and
        resized onto the network's canvas (None: ``raw_images`` already
        are). One pass of the network (dropout only where ``masks`` is
        given). ``post_mode="global"``: ``postprocess_global``; another
        mode (``"per_class"``): ``per_class_nms``; both return the packed
        tuple followed by any segmentation logits. ``post_mode=None``, or
        no object-detection head: the raw NHWC outputs."""
        cfg = self.config
        scales = None
        images = raw_images
        if pre_mode == "infer":
            images, scales = preprocess_images(raw_images, cfg.image_size, cfg.mean_rgb,
                                               cfg.stddev_rgb)
            images = images.to(self.backbone.stem_conv.weight.dtype)
        outs = super().forward(images, masks)
        if post_mode is None or "object_detection" not in cfg.heads:
            return outs
        fn = postprocess_global if post_mode == "global" else per_class_nms
        det = fn(cfg, list(outs[0]), list(outs[1]), image_scales=scales)
        return det.packed() + tuple(outs[2:])


def preprocess_images(raw_images: torch.Tensor, image_size, mean_rgb, stddev_rgb
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [B, H, W, 3] images → normalised, aspect-preserving resized
    NHWC batch in f32, placed top-left on the padded canvas, and the scale
    back to the original frame [B].

    The bilinear resize antialiases when it downsamples, as
    ``jax.image.resize`` does.
    """
    h_out, w_out = parse_image_size(image_size)
    b, h_in, w_in = raw_images.shape[:3]
    x = raw_images.to(torch.float32)
    mean = torch.tensor(mean_rgb, dtype=torch.float32, device=x.device)
    std = torch.tensor(stddev_rgb, dtype=torch.float32, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)

    scale = min(h_out / h_in, w_out / w_in)
    scaled_h, scaled_w = int(h_in * scale), int(w_in * scale)
    if (scaled_h, scaled_w) != (h_in, w_in):
        x = F.interpolate(x, size=(scaled_h, scaled_w), mode="bilinear",
                          align_corners=False, antialias=True)
    x = F.pad(x, (0, w_out - scaled_w, 0, h_out - scaled_h))
    image_scale = torch.full((b,), 1.0 / scale, dtype=torch.float32, device=x.device)
    return x.permute(0, 2, 3, 1), image_scale
