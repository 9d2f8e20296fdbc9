"""Fast MC-dropout forward: shared-prefix hoisting + the block-0 fold.

Port of the v4 path of ``udal_tpu/models/mc_fast.py``. For an
expand-ratio-1 MBConv (EfficientNet block 0) the ops are

    x0 = act(bn1(dw(act(bn(stem(x))))))   # sample-independent (shared)
    u  = m ⊙ x0                           # spatial dropout, m per (n, c)
    s  = sigmoid(SE(mean_hw(u)))
    y  = bn2(project_1x1(s ⊙ u))

and two identities make the per-sample work one contraction:
mean_hw(m ⊙ x0) = m ⊙ mean_hw(x0), and project_1x1(σ ⊙ x0) = x0 @
(diag(σ)·W). The stem and block-0 depthwise run once at batch B instead of
T·B; all T samples' block-0 tails are one batched matmul with per-(t, b)
folded weights. The fold is exact algebra.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from udal_tpu_torch.models.efficientdet import EfficientDetNet
from udal_tpu_torch.models.efficientnet import ChannelDropout, activation_fn
from udal_tpu_torch.ops.fused_dw import fold_bn, fused_depthwise


def fast_mc_eligible(cfg, model: EfficientDetNet) -> bool:
    """True when the shared-prefix + block-0 fold applies exactly: MC
    dropout in the backbone, swish, and a block 0 with no expand conv, with
    SE and no residual skip (the fold emits bn2's output without it)."""
    if not cfg.get("mc_fast_fold", True):
        return False
    if not (cfg.mc_dropout and cfg.mc_dropoutrate):
        return False
    if cfg.act_type not in ("swish", "silu", "swish_native"):
        return False
    block0 = model.backbone.blocks_0
    return (block0.expand_conv is None and block0.se is not None
            and not block0.residual and block0.depthwise_conv.stride == (1, 1))


def _bn_affine(bn, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as (scale, bias), computed in f32, cast to dtype."""
    scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    return scale.to(dtype), bias.to(dtype)


def mc_shared_prefix(model: EfficientDetNet, images: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stem conv/bn/act + block-0 depthwise/bn/act, once at batch B.

    NHWC images → (x0 [B, C0, H, W] NCHW in the model's dtype, x0_mean
    [B, C0] in f32). The stem is written out with an explicit BN affine, in
    the JAX package's op order; block 0's depthwise, bn1, swish and mean are
    one ``fused_depthwise`` call.
    """
    bb = model.backbone
    dtype = bb.stem_conv.weight.dtype
    act = activation_fn("swish")
    x = images.permute(0, 3, 1, 2).contiguous().to(dtype)
    scale, bias = _bn_affine(bb.stem_bn, dtype)
    x = act(bb.stem_conv(x) * scale[:, None, None] + bias[:, None, None])
    b0 = bb.blocks_0
    f = b0.operands()
    return fused_depthwise(x.contiguous(), f["taps"], f["scale"], f["bias"], None,
                           b0.depthwise_conv.stride[0], "swish", want_mean=True)


def folded_block0_all_samples(model: EfficientDetNet, x0: torch.Tensor,
                              x0_mean: torch.Tensor, rate: float, num_samples: int,
                              masks: Optional[torch.Tensor] = None,
                              drop: Optional[ChannelDropout] = None) -> torch.Tensor:
    """Block-0 tail for all T samples as one batched matmul.

    y[t, b, d] = Σ_c Wfold[t, b, c, d] · x0[b, c] per pixel, where the
    folded weights carry dropout ⊙ SE ⊙ bn2: the shared x0 is read once.
    ``masks`` [T, B, C0] (keep bits scaled by 1/keep, f32) overrides the
    draw from ``drop``. Returns block 1's input [T·B, Co, H, W], t-major.
    """
    b0 = model.backbone.blocks_0
    dtype = x0.dtype
    act = activation_fn("swish")
    b, c0, h, w = x0.shape
    t = num_samples
    if masks is None:
        keep = 1.0 - rate
        masks = drop.draw(t * b, c0, keep, x0.device).view(t, b, c0).to(torch.float32) / keep
    wr = b0.se.reduce.weight[:, :, 0, 0].t()                   # [C0, Cse]
    we = b0.se.expand.weight[:, :, 0, 0].t()                   # [Cse, C0]
    se_in = (masks * x0_mean[None]).to(dtype)                  # [T, B, C0]
    z = act(se_in @ wr + b0.se.reduce.bias)
    se = z @ we + b0.se.expand.bias
    sigma = torch.sigmoid(se.to(torch.float32)) * masks        # [T, B, C0]

    wp = b0.project_conv.weight[:, :, 0, 0].t().to(torch.float32)  # [C0, Co]
    bscale, bbias = _bn_affine(b0.bn2, torch.float32)
    wfold = sigma[..., None] * (wp * bscale[None, :])           # [T, B, C0, Co]
    co = wp.shape[-1]
    lhs = wfold.permute(1, 0, 3, 2).reshape(b, t * co, c0).to(dtype)
    y = torch.bmm(lhs, x0.reshape(b, c0, h * w)).view(b, t, co, h, w)
    y = y + bbias.to(dtype)[None, None, :, None, None]
    return y.transpose(0, 1).reshape(t * b, co, h, w)


def block1_input(model: EfficientDetNet, images: torch.Tensor, num_samples: int,
                 masks: ChannelDropout) -> torch.Tensor:
    """The shared prefix at B and the block-0 fold of all samples: NHWC
    images → block 1's input [T·B, Co, H, W], t-major."""
    x0, x0_mean = mc_shared_prefix(model, images)
    return folded_block0_all_samples(model, x0, x0_mean, model.config.mc_dropoutrate,
                                     num_samples, drop=masks)
