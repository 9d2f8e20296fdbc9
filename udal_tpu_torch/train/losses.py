"""Detection losses: focal, box (Huber / MSE, with or without the
attenuation NLL), IoU and the CSD consistency loss.

Port of ``udal_tpu/train/losses.py``, the same functions on NHWC maps
(``EfficientDetNet``'s outputs are NHWC views). Under loss attenuation the
box head's second half holds per-anchor σ: (th, tw) get σ²/2 added, the
compensation for the log-normal decode (or the second half of the channels
with ``strict_loss_parity``, the reference's slice), and the loss is the NLL
0.25·Σ(L/σ² + log(1 + σ²)) / normalizer, optionally β-NLL weighted.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from udal_tpu_torch.ops import anchors as anchor_lib
from udal_tpu_torch.ops.boxes import iou_loss as iou_loss_fn
from udal_tpu_torch.parallel.collectives import all_reduce


def huber(targets: torch.Tensor, preds: torch.Tensor, delta: float) -> torch.Tensor:
    """Elementwise Huber loss (Keras convention)."""
    abs_err = torch.abs(targets - preds)
    quad = torch.clamp_max(abs_err, delta)
    lin = abs_err - quad
    return 0.5 * quad * quad + delta * lin


def focal_loss(y_true: torch.Tensor, y_pred: torch.Tensor, alpha: float, gamma: float,
               normalizer: torch.Tensor, label_smoothing: float = 0.0) -> torch.Tensor:
    """Elementwise focal loss over logits ``y_pred``, divided by ``normalizer``."""
    pred_prob = torch.sigmoid(y_pred)
    p_t = y_true * pred_prob + (1 - y_true) * (1 - pred_prob)
    alpha_factor = y_true * alpha + (1 - y_true) * (1 - alpha)
    modulating = (1.0 - p_t) ** gamma
    y_smooth = y_true * (1.0 - label_smoothing) + 0.5 * label_smoothing
    # numerically stable sigmoid BCE with logits
    ce = torch.clamp_min(y_pred, 0) - y_pred * y_smooth + torch.log1p(torch.exp(-torch.abs(y_pred)))
    return alpha_factor * modulating * ce / normalizer


def clip_uncert_channels(box_output: torch.Tensor, clip_min: float,
                         clip_max: float) -> torch.Tensor:
    """Clip the σ half of an 8·A box map."""
    half = box_output.shape[-1] // 2
    return torch.cat([box_output[..., :half],
                      torch.clamp(box_output[..., half:], clip_min, clip_max)], dim=-1)


def box_loss(box_targets: torch.Tensor, box_output: torch.Tensor,
             num_positives: torch.Tensor, delta: float = 0.1, loss_att: bool = False,
             loss_type: str = "huber", pseudo_scores: Optional[torch.Tensor] = None,
             strict_parity: bool = False, beta_nll: float = 0.0) -> torch.Tensor:
    """One level's box regression loss.

    Args:
      box_targets: [B, H, W, 4A].
      box_output: [B, H, W, 4A], or [B, H, W, 8A] (μ, σ) with attenuation.
      num_positives: the normalizer (positives + 1).
      pseudo_scores: optional [B] per-image weights.
      strict_parity: the σ²/2 compensation on the second half of the μ
        channels (the reference's slice) instead of every anchor's (th, tw).
      beta_nll: β-NLL: each NLL term weighted by σ^(2β), with no gradient
        through the weight.
    """
    normalizer = num_positives * 4.0
    if loss_att:
        half = box_output.shape[-1] // 2
        sigma = box_output[..., half:]
        mu = box_output[..., :half]
        idx = torch.arange(half, device=mu.device)
        hw = idx >= half // 2 if strict_parity else idx % 4 >= 2
        mu = mu + hw.to(mu.dtype) * torch.square(sigma) / 2.0
        box_output = mu

    mask = (box_targets != 0.0).to(box_output.dtype)
    if loss_type == "huber":
        per_elem = huber(box_targets, box_output, delta)
    else:
        per_elem = torch.square(box_targets - box_output)
    if pseudo_scores is not None:
        per_elem = per_elem * pseudo_scores[:, None, None, None]

    if loss_att:
        var = torch.square(sigma)
        nll = per_elem / var + torch.log1p(var)
        if beta_nll:
            nll = nll * (var ** beta_nll).detach()
        return 0.25 * torch.sum(nll * mask) / normalizer
    return torch.sum(per_elem * mask) / normalizer


def detection_loss(config, cls_outputs: Sequence[torch.Tensor],
                   box_outputs: Sequence[torch.Tensor], labels: Dict[str, torch.Tensor],
                   pseudo_scores: Optional[torch.Tensor] = None, group=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total detection loss over the levels, and its parts.

    Under data parallelism ``group`` is the data group: the normaliser
    (the positives + 1) is the global batch's, all-reduced, so the ranks'
    losses sum to the global batch's loss.

    ``labels``: ``cls_targets_<l>`` [B, H, W, A] (class − 1; background −1
    is the all-zero one-hot row, ignored −2 is masked),
    ``box_targets_<l>`` [B, H, W, 4A], ``mean_num_positives`` [B]. The loss
    is in the outputs' type (bf16 under mixed precision); the box loss is
    the levels' mean under attenuation, their sum otherwise.
    """
    dtype = cls_outputs[0].dtype
    positives = all_reduce(torch.sum(labels["mean_num_positives"]).reshape(1), group)[0]
    num_positives_sum = (positives + 1.0).to(dtype)
    classes = torch.arange(config.num_classes, device=cls_outputs[0].device)

    cls_losses, box_losses = [], []
    for level_idx, cls_out in enumerate(cls_outputs):
        level = level_idx + config.min_level
        cls_t = labels[f"cls_targets_{level}"]
        b, h, w = cls_t.shape[:3]
        onehot = (cls_t[..., None] == classes).to(dtype).reshape(b, h, w, -1)
        cls_l = focal_loss(onehot, cls_out, config.alpha, config.gamma, num_positives_sum,
                           config.label_smoothing)
        cls_l = cls_l.reshape(b, h, w, -1, config.num_classes)
        cls_l = cls_l * (cls_t != -2)[..., None].to(dtype)
        if pseudo_scores is not None:
            cls_l = cls_l * pseudo_scores[:, None, None, None, None]
        cls_losses.append(torch.sum(cls_l))

        box_losses.append(box_loss(
            labels[f"box_targets_{level}"], box_outputs[level_idx], num_positives_sum,
            delta=config.delta, loss_att=bool(config.loss_attenuation),
            loss_type="huber" if config.boxloss_type == "huber" else "mse",
            pseudo_scores=pseudo_scores,
            strict_parity=bool(config.get("strict_loss_parity", False)),
            beta_nll=float(config.get("la_beta_nll", 0.0))))

    cls_loss_total = sum(cls_losses)
    box_loss_total = sum(box_losses)
    if config.loss_attenuation:
        box_loss_total = box_loss_total / len(box_losses)

    box_iou = torch.zeros((), dtype=dtype, device=cls_outputs[0].device)
    if config.iou_loss_type:
        anchors = anchor_lib.from_config(config)
        anchor_boxes = anchors.boxes(cls_outputs[0].device)
        outs, tgts, anchor_rows = [], [], []
        for level_idx, o in enumerate(box_outputs):
            level = level_idx + config.min_level
            if config.loss_attenuation:
                o = o[..., : o.shape[-1] // 2]
            outs.append(o.reshape(-1, 4))
            tgts.append(labels[f"box_targets_{level}"].reshape(-1, 4))
            s, e = anchors.level_slices()[level]
            anchor_rows.append(anchor_boxes[s:e].repeat(o.shape[0], 1))
        out_flat, tgt_flat = torch.cat(outs), torch.cat(tgts)
        anc_flat = torch.cat(anchor_rows)
        mask = (tgt_flat != 0.0).to(dtype)
        dec_out = anchor_lib.decode_box_outputs(out_flat, anc_flat) * mask
        dec_tgt = anchor_lib.decode_box_outputs(tgt_flat, anc_flat) * mask
        box_iou = torch.sum(iou_loss_fn(dec_out, dec_tgt, config.iou_loss_type)) \
            / (num_positives_sum * 4.0)

    total = (cls_loss_total + config.box_loss_weight * box_loss_total +
             config.iou_loss_weight * box_iou)
    loss_vals = {"det_loss": total, "cls_loss": cls_loss_total, "box_loss": box_loss_total}
    if config.iou_loss_type:
        loss_vals["box_iou_loss"] = box_iou
    return total, loss_vals


def csd_consistency_loss(config, cls_outputs, box_outputs, cls_outputs_aug,
                         box_outputs_aug) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSD flip-consistency loss: the augmented forward saw the frame
    flipped left-right; its maps are flipped back (W axis) and compared:
    the Jensen-Shannon divergence of the softmaxed class maps and the MSE
    of the box maps with tx's sign flipped. Background elimination keeps
    the anchors whose best foreground probability passes ``csd_BE_thr`` in
    both views. Returns (class term, box term), each the levels' mean."""
    eps = 1e-10
    cls_l, box_l = [], []
    be_thr = float(config.get("csd_BE_thr", 0.0) or 0.0)
    use_be = bool(config.get("csd_BE", True))
    for level_idx, c in enumerate(cls_outputs):
        ca = torch.flip(cls_outputs_aug[level_idx], dims=[2])
        b_, h, w, _ = c.shape
        a = c.shape[-1] // config.num_classes
        c = c.reshape(b_, h, w, a, config.num_classes)
        ca = ca.reshape(b_, h, w, a, config.num_classes)
        p = torch.softmax(c, dim=-1)
        pa = torch.softmax(ca, dim=-1)
        m = 0.5 * (p + pa)
        jsd = 0.5 * (torch.sum(p * (torch.log(p + eps) - torch.log(m + eps)), -1) +
                     torch.sum(pa * (torch.log(pa + eps) - torch.log(m + eps)), -1))

        bx = box_outputs[level_idx].reshape(b_, h, w, a, 4)
        bxa = torch.flip(box_outputs_aug[level_idx], dims=[2]).reshape(b_, h, w, a, 4)
        sign = torch.tensor([1.0, -1.0, 1.0, 1.0], dtype=bx.dtype, device=bx.device)
        mse = torch.mean(torch.square(bx - bxa * sign), dim=-1)

        if use_be:
            fg = torch.amax(p[..., 1:], dim=-1)
            fga = torch.amax(pa[..., 1:], dim=-1)
            keep = ((fg > be_thr) & (fga > be_thr)).to(jsd.dtype)
            denom = torch.clamp_min(torch.sum(keep), 1.0)
            cls_l.append(torch.sum(jsd * keep) / denom)
            box_l.append(torch.sum(mse * keep) / denom)
        else:
            cls_l.append(torch.mean(jsd))
            box_l.append(torch.mean(mse))
    n = len(cls_l)
    return sum(cls_l) / n, sum(box_l) / n


def csd_ramp_weight(step: int, total_steps: int) -> float:
    """The CSD consistency weight at ``step``: Gaussian ramp-up over the
    first 10% of training, ramp-down over the last 10%."""
    t = step / max(total_steps, 1)
    up = math.exp(-5.0 * (1.0 - min(max(t / 0.1, 0.0), 1.0)) ** 2)
    down = math.exp(-12.5 * min(max((t - 0.9) / 0.1, 0.0), 1.0) ** 2)
    return up * down


def l2_named_parameters(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The weights the L2 term covers, by name: the JAX package's filter on
    the flax path ('bn', 'bias' or 'batch' in it excludes a leaf) applied to
    the port's parameter names, which carry the same scope names, so the
    same leaves are chosen: every kernel and the BiFPN's edge weights."""
    return {name: p for name, p in model.named_parameters()
            if not any(k in name.lower() for k in ("bn", "bias", "batch"))}


def l2_parameters(model: nn.Module):
    """The weights the L2 term covers (``l2_named_parameters``)."""
    return list(l2_named_parameters(model).values())


def l2_regularization(params: Sequence[torch.Tensor], weight_decay: float) -> torch.Tensor:
    """weight_decay · Σ‖w‖² / 2 over ``params`` (``l2_parameters(model)``)."""
    squares = torch._foreach_mul(list(params), list(params))
    return weight_decay * torch.stack([s.sum() for s in squares]).sum() / 2.0
