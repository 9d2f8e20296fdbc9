"""Plain PyTorch reference of one training step, for the check of ``correct``.

Written from the architecture, the repo's training configuration and the
EfficientDet recipe (google/automl ``hparams_config.py``, det_model_fn):
from the weights and momentum as they were before a step, the batch's
uint8 frames and groundtruth boxes, and the dropout keep bits the checked
step drew (in the order its sites draw them), it computes

- the targets: the anchors (``reference.anchors``), each anchor matched to
  the groundtruth box of highest IoU, a positive at IoU >= 0.5, background
  below, and each box's best anchor forced to it (the lowest box where two
  share one); classes one-hot, boxes in the Faster R-CNN coding;
- the train-mode forward: ``reference.py``'s network with every BatchNorm
  normalising by its batch's statistics (mean and biased variance over N,
  H, W), the BiFPN's fast-attention fusion, MC dropout from the kept bits;
- the loss: the focal loss (α 0.25, γ 1.5) over the positives + 1, the
  loss-attenuated MSE box loss (σ the box head's second half clipped to
  [0.01, 1024]; th and tw shifted by σ²/2; 0.25 · Σ (e²/σ² + log(1 + σ²))
  over the positives' coordinates ÷ 4·(positives + 1), the levels' mean)
  weighted 100, and L2 4e-5 · Σ w² / 2 over the kernels and fusion weights;
- the gradients by autograd; each tensor's clipped to norm 10, then all
  of them to global norm 10;
- SGD with momentum 0.9 (trace = g + 0.9 · trace, w −= lr · trace) at the
  schedule's rate: a linear warm-up from 0.008 to 0.08 over the first
  epoch, then the cosine, both scaled by batch / 64.

In float32 with TF32 off (``run``). With ``precision="bf16"`` or
``"fp8"`` the forward rounds every tensor it makes as ``reference.Arith``
does, and the gradients pass each rounding unchanged. Imports nothing of
the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench_torch import reference as R
from bench_torch.reference import Arith, Masks, run

__all__ = ["RUNNER", "HPARAMS", "learning_rate", "targets", "step", "run"]

# the KITTI runner (configs/train/train_runner.ini): batch 8, 500 epochs of
# 5985 examples
RUNNER = dict(batch_size=8, num_epochs=500, steps_per_epoch=5985 // 8)
# the recipe's defaults (google/automl hparams_config.py) and the repo's
# configs/train/allclasses_mcdropout_lossatt.yaml (box loss, attenuation)
HPARAMS = dict(learning_rate=0.08, lr_warmup_init=0.008, lr_warmup_epoch=1.0, momentum=0.9,
               clip_norm=10.0, weight_decay=4e-5, alpha=0.25, gamma=1.5,
               box_loss_weight=100.0, clip_min_uncert=0.01, clip_max_uncert=1024.0,
               match_iou=0.5)
LOSS_PARTS = ("cls_loss", "box_loss", "det_loss", "reg_l2_loss", "loss")


def learning_rate(step: int, batch_size: int = RUNNER["batch_size"]) -> float:
    """The rate of update ``step`` (the count before it) at ``batch_size``."""
    scale = batch_size / 64.0
    lr, init = HPARAMS["learning_rate"] * scale, HPARAMS["lr_warmup_init"] * scale
    warmup = int(HPARAMS["lr_warmup_epoch"] * RUNNER["steps_per_epoch"])
    if step < warmup:
        return init + step / max(warmup, 1) * (lr - init)
    total = RUNNER["num_epochs"] * RUNNER["steps_per_epoch"]
    return 0.5 * lr * (1 + math.cos(math.pi * step / (total - warmup)))


class TrainArith(Arith):
    """``Arith`` whose roundings pass the gradient unchanged."""

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return t
        return t + (super().q(t) - t).detach()


# -- targets --------------------------------------------------------------------

def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, N] IoU of y1x1y2x2 boxes; 0 where the union is 0."""
    area = lambda x: (x[:, 2] - x[:, 0]).clamp_min(0) * (x[:, 3] - x[:, 1]).clamp_min(0)
    lo = torch.maximum(a[:, None, :2], b[None, :, :2])
    hi = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (hi - lo).clamp_min(0).prod(-1)
    union = area(a)[:, None] + area(b)[None] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def targets(arch, boxes: torch.Tensor, classes: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-anchor class targets [B, N] (class − 1, background −1), box
    targets [B, N, 4] (zero where background) and the positives [B] of
    groundtruth ``boxes`` [B, M, 4] (pixels) with ``classes`` [B, M]
    (rows of class <= 0 are padding)."""
    anchors = R.anchors(arch, boxes.device)
    cls_t, box_t, positives = [], [], []
    for b in range(boxes.shape[0]):
        keep = classes[b] > 0
        gt, gc = boxes[b][keep].float(), classes[b][keep]
        n = anchors.shape[0]
        match = torch.full((n,), -1, dtype=torch.int64, device=boxes.device)
        if gt.shape[0]:
            iou = _iou(gt, anchors)                              # [M, N]
            best, row = iou.amax(0), iou.argmax(0)               # the first maximum
            match = torch.where(best >= HPARAMS["match_iou"], row, match)
            # each box takes its best anchor; a lower box wins a shared one
            for m in reversed(range(gt.shape[0])):
                match[int(iou[m].argmax())] = m
        pos = match >= 0
        g = gt[match.clamp_min(0)] if gt.shape[0] else torch.zeros((n, 4), device=boxes.device)
        ya, xa = (anchors[:, 0] + anchors[:, 2]) / 2, (anchors[:, 1] + anchors[:, 3]) / 2
        ha, wa = anchors[:, 2] - anchors[:, 0] + 1e-8, anchors[:, 3] - anchors[:, 1] + 1e-8
        hg, wg = g[:, 2] - g[:, 0] + 1e-8, g[:, 3] - g[:, 1] + 1e-8
        code = torch.stack([((g[:, 0] + g[:, 2]) / 2 - ya) / ha,
                            ((g[:, 1] + g[:, 3]) / 2 - xa) / wa,
                            torch.log(hg / ha), torch.log(wg / wa)], -1)
        cls_t.append(torch.where(pos, (gc[match.clamp_min(0)] - 1) if gt.shape[0]
                                 else torch.zeros_like(match), -1))
        box_t.append(torch.where(pos[:, None], code, 0.0))
        positives.append(pos.sum().float())
    return torch.stack(cls_t), torch.stack(box_t), torch.stack(positives)


# -- the train-mode network -----------------------------------------------------

def batch_norm(x, p, prefix: str, eps: float, ar: Arith) -> torch.Tensor:
    """BatchNorm by the batch's statistics: mean and biased variance over
    (N, H, W)."""
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3), unbiased=False)
    scale = p[f"{prefix}.weight"] / torch.sqrt(var + eps)
    return ar.q((x - mean[:, None, None]) * scale[:, None, None]
                + p[f"{prefix}.bias"][:, None, None])


def backbone(x, p, arch, ar: Arith, masks: Masks) -> List[torch.Tensor]:
    eps, rate = arch["bn_epsilon"], arch["mc_backbone_rate"]
    x = ar.act(batch_norm(ar.conv(x, p["backbone.stem_conv.weight"], stride=2), p,
                         "backbone.stem_bn", eps, ar))
    keep = set(R.reductions(arch)[arch["min_level"] - 1:])

    def drop(h):
        return ar.q(h * masks.take(h.shape[0], h.shape[1], rate)) if rate > 0 else h

    feats = []
    for i, b in enumerate(R.blocks(arch)):
        pre = f"backbone.blocks_{i}"
        inputs = x
        if b["e"] != 1:
            x = drop(ar.act(batch_norm(ar.conv(x, p[f"{pre}.expand_conv.weight"]), p,
                                      f"{pre}.bn0", eps, ar)))
        x = ar.conv(x, p[f"{pre}.depthwise_conv.weight"], stride=b["s"], groups=x.shape[1])
        x = drop(ar.act(batch_norm(x, p, f"{pre}.bn1", eps, ar)))
        se = x.mean((2, 3), keepdim=True)
        se = ar.act(ar.conv(se, p[f"{pre}.se.reduce.weight"], p[f"{pre}.se.reduce.bias"]))
        se = ar.conv(se, p[f"{pre}.se.expand.weight"], p[f"{pre}.se.expand.bias"])
        x = ar.q(torch.sigmoid(se) * x)
        x = batch_norm(ar.conv(x, p[f"{pre}.project_conv.weight"]), p, f"{pre}.bn2", eps, ar)
        if b["s"] == 1 and b["cin"] == b["cout"]:
            x = ar.q(x + inputs)
        if i in keep:
            feats.append(x)
    return feats


def resample(x, p, prefix, size, ar: Arith, eps) -> torch.Tensor:
    """``reference.resample`` with the 1x1 conv's BatchNorm in train mode."""
    if f"{prefix}.conv1x1.weight" in p:
        x = batch_norm(ar.conv(x, p[f"{prefix}.conv1x1.weight"], p[f"{prefix}.conv1x1.bias"]),
                       p, f"{prefix}.bn", eps, ar)
    return R.resample(x, {}, prefix, size, ar, eps)


def bifpn(feats, p, arch, ar: Arith) -> List[torch.Tensor]:
    eps = arch["bn_epsilon"]
    sizes = R.level_sizes(arch)
    lo, hi = arch["min_level"], arch["max_level"]
    for level in range(6, hi + 1):
        feats.append(resample(feats[-1], p, f"resample_p{level}", sizes[level], ar, eps))
    nodes = R.bifpn_nodes(lo, hi)
    for r in range(arch["fpn_cell_repeats"]):
        all_feats = list(feats)
        for n, (level, offsets) in enumerate(nodes):
            pre = f"fpn_cells.cell_{r}.fnode{n}"
            ins = [resample(all_feats[o], p, f"{pre}.resample_{j}", sizes[level], ar, eps)
                   for j, o in enumerate(offsets)]
            w = torch.relu(p[f"{pre}.edge_weights"])
            x = ar.q(sum(t * (w[j] / (w.sum() + 1e-4)) for j, t in enumerate(ins)))
            x = ar.conv(ar.act(x), p[f"{pre}.conv.depthwise.weight"], groups=x.shape[1])
            x = ar.conv(x, p[f"{pre}.conv.pointwise.weight"], p[f"{pre}.conv.pointwise.bias"])
            all_feats.append(batch_norm(x, p, f"{pre}.bn", eps, ar))
        feats = []
        for level in range(lo, hi + 1):
            last = max(i for i, (l, _) in enumerate(nodes) if l == level)
            feats.append(all_feats[len(all_feats) - len(nodes) + last])
    return feats


def head(feats, p, arch, name: str, ar: Arith, masks: Masks) -> List[torch.Tensor]:
    eps, rate = arch["bn_epsilon"], arch["mc_head_rate"]
    outs = []
    for level, x in enumerate(feats):
        for i in range(arch["box_class_repeats"]):
            pre = f"{name}_net.stack.{name}-{i}"
            x = ar.conv(x, p[f"{pre}.depthwise.weight"], groups=x.shape[1])
            x = ar.conv(x, p[f"{pre}.pointwise.weight"], p[f"{pre}.pointwise.bias"])
            x = ar.act(batch_norm(x, p, f"{pre}-bn-{level}", eps, ar))
            if rate > 0:
                x = ar.q(x * masks.take(x.shape[0], x.shape[1], rate))
        pre = f"{name}_net.{name}-predict"
        x = ar.conv(x, p[f"{pre}.depthwise.weight"], groups=x.shape[1])
        outs.append(ar.conv(x, p[f"{pre}.pointwise.weight"], p[f"{pre}.pointwise.bias"]))
    return outs


# -- the loss -------------------------------------------------------------------

def loss(arch, cls_maps, box_maps, cls_t, box_t, positives, p) -> Dict[str, torch.Tensor]:
    """The loss and its parts from NCHW per-level maps and per-anchor targets."""
    hp = HPARAMS
    a, c = R.num_anchors(arch), arch["num_classes"]
    norm = positives.sum() + 1.0
    cls_loss, box_losses = 0.0, []
    start = 0
    for cm, bm in zip(cls_maps, box_maps):
        b, _, h, w = cm.shape
        n = h * w * a
        ct = cls_t[:, start:start + n].reshape(b, h, w, a)
        bt = box_t[:, start:start + n].reshape(b, h, w, a * 4)
        start += n
        logits = cm.permute(0, 2, 3, 1).reshape(b, h, w, a, c)
        y = (ct[..., None] == torch.arange(c, device=ct.device)).float()
        prob = torch.sigmoid(logits)
        p_t = y * prob + (1 - y) * (1 - prob)
        alpha = y * hp["alpha"] + (1 - y) * (1 - hp["alpha"])
        ce = F.binary_cross_entropy_with_logits(logits, y, reduction="none")
        cls_loss = cls_loss + (alpha * (1 - p_t) ** hp["gamma"] * ce).sum() / norm
        out = bm.permute(0, 2, 3, 1)
        mu = out[..., :a * 4]
        sigma = out[..., a * 4:].clamp(hp["clip_min_uncert"], hp["clip_max_uncert"])
        var = sigma * sigma
        size = (torch.arange(a * 4, device=mu.device) % 4 >= 2).float()
        err = (bt - (mu + size * var / 2)) ** 2
        nll = (err / var + torch.log1p(var)) * (bt != 0).float()
        box_losses.append(0.25 * nll.sum() / (4.0 * norm))
    box_loss = sum(box_losses) / len(box_losses)
    det = cls_loss + hp["box_loss_weight"] * box_loss
    reg = hp["weight_decay"] * sum((v * v).sum() for k, v in p.items()
                                   if not any(s in k.lower() for s in ("bn", "bias", "batch"))
                                   and v.requires_grad) / 2.0
    return dict(cls_loss=cls_loss, box_loss=box_loss, det_loss=det, reg_l2_loss=reg,
                loss=det + reg)


# -- one step -------------------------------------------------------------------

def step(arch, weights: Dict[str, torch.Tensor], momentum: Optional[Dict[str, torch.Tensor]],
         frames_u8: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
         masks: Sequence[torch.Tensor], step_count: int, precision: str = "f32",
         batch_size: Optional[int] = None
         ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
    """The step's loss parts (floats) and the weights after its update,
    from ``weights`` and the optimizer's ``momentum`` (None before the
    first step) by parameter name; running statistics are left out. The
    rate is the schedule's at ``batch_size`` (by default the frames')."""
    ar = TrainArith(precision)
    device = frames_u8.device
    names = [k for k in weights if not k.endswith(("running_mean", "running_var"))]
    p = {k: weights[k].detach().clone().float().requires_grad_(k in names) for k in weights}
    cls_t, box_t, positives = targets(arch, boxes, classes)
    x = ar.q(R.normalise(frames_u8, arch)).permute(0, 3, 1, 2)
    kept = Masks(masks, device)
    with torch.enable_grad():
        feats = bifpn(backbone(x, p, arch, ar, kept), p, arch, ar)
        cls = head(feats, p, arch, "class", ar, kept)
        box = head(feats, p, arch, "box", ar, kept)
        kept.done()
        parts = loss(arch, cls, box, cls_t, box_t, positives, p)
        grads = torch.autograd.grad(parts["loss"], [p[k] for k in names], allow_unused=True)
    grads = [torch.zeros_like(p[k]) if g is None else g for k, g in zip(names, grads)]
    clip = HPARAMS["clip_norm"]
    norms = torch.stack([g.norm() for g in grads])
    per = torch.clamp_max(clip / norms.clamp_min(1e-12), 1.0)
    total = torch.linalg.vector_norm(norms * per)
    scale = per * torch.clamp_max(clip / total.clamp_min(1e-12), 1.0)
    lr = learning_rate(step_count, batch_size or frames_u8.shape[0])
    after = {}
    for k, g, s in zip(names, grads, scale):
        trace = g * s
        if momentum is not None and momentum.get(k) is not None:
            trace = trace + HPARAMS["momentum"] * momentum[k].float()
        after[k] = weights[k].float() - lr * trace
    return {k: float(v) for k, v in parts.items()}, after
