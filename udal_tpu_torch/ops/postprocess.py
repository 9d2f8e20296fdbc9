"""Detection post-processing with uncertainty: port of ``udal_tpu/ops/postprocess.py``.

Every mode (plain / loss attenuation / MC / LA+MC) flows through one
layout: per-level maps [T?, B, H, W, C] (NHWC, an optional leading MC
sample axis). ``pre_nms`` takes the T-moments of the class logits, keeps
the exact top-k candidates by max-class score, gathers and decodes only
those; ``postprocess_global`` runs soft-NMS (the CUDA kernel for CUDA
tensors, the plain version for CPU tensors) and packs the result as the
JAX package does; ``per_class_nms`` runs the same kernel once on boxes
shifted apart by class.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from udal_tpu_torch.ops import anchors as anchor_lib
from udal_tpu_torch.ops import cuda_nms
from udal_tpu_torch.ops import nms as nms_lib
from udal_tpu_torch.ops.uncertainty import decode_uncert, mc_moments, sample_mean
from udal_tpu_torch.utils import profiling

CLASS_OFFSET = 1  # background is class 0 in the label map
MAX_DETECTION_POINTS = anchor_lib.MAX_DETECTION_POINTS


@dataclasses.dataclass
class Detections:
    """Structured detection results (all fixed shape, batch leading)."""
    boxes: torch.Tensor                 # [B, K, 4] y1x1y2x2, input-image pixels
    scores: torch.Tensor                # [B, K]
    classes: torch.Tensor               # [B, K] float, CLASS_OFFSET applied
    valid_len: torch.Tensor             # [B]
    sigma_al: Optional[torch.Tensor] = None    # [B, K, 4] aleatoric box std
    sigma_mc: Optional[torch.Tensor] = None    # [B, K, 4] epistemic box std
    sigma_cls: Optional[torch.Tensor] = None   # [B, K, C] class-logit std
    logits: Optional[torch.Tensor] = None      # [B, K, C]

    def packed(self) -> Tuple[torch.Tensor, ...]:
        """(boxes ⊕ sigma_al ⊕ sigma_mc, scores, classes ⊕ sigma_cls,
        valid_len[, logits])."""
        boxes = self.boxes
        classes = self.classes
        if self.sigma_cls is not None:
            classes = torch.cat([classes[..., None], self.sigma_cls], dim=-1)
        if self.sigma_al is not None:
            boxes = torch.cat([boxes, self.sigma_al], dim=-1)
        if self.sigma_mc is not None:
            boxes = torch.cat([boxes, self.sigma_mc], dim=-1)
        out = [boxes, self.scores, classes, self.valid_len]
        if self.logits is not None:
            out.append(self.logits)
        return tuple(out)


def pre_nms(config, cls_outputs, box_outputs, pre_nms_topk: int = 0, sample_group=None):
    """Merge levels, select candidates, decode boxes + uncertainties.

    With a ``sample_group`` the maps' sample axis is this rank's share of
    the samples, split evenly over the group (``ServingDriver.
    serve_sample_parallel``); the T-moments are all-reduced, so every rank
    selects and decodes from the same moments.

    cls_outputs / box_outputs: per-level lists of [B, H, W, ·] or, with MC
    sampling, [T, B, H, W, ·]. Returns a dict of [B, M, ·] tensors: boxes,
    scores_logits, classes, indices, sigma_al?, sigma_mc?, sigma_cls?,
    logits?

    Candidates are flat (anchor, position) indices n = a·R + r, R the
    number of positions over all levels, as in the JAX package; the exact
    top-k ranks by the max-class (T-mean) logit with ties to the lower
    index, as ``jax.lax.top_k`` does.
    """
    anchors = anchor_lib.from_config(config)
    num_classes = config.num_classes
    loss_att = bool(config.loss_attenuation)
    mc_cls = cls_outputs[0].dim() == 5
    mc_box = box_outputs[0].dim() == 5
    num_anc = len(config.aspect_ratios) * config.num_scales
    halves = 2 if loss_att else 1

    def to_pos_minor(t):     # [T?, B, H, W, ch] -> [T?, B, ch, H*W]
        return t.reshape(*t.shape[:-3], t.shape[-3] * t.shape[-2], t.shape[-1]).transpose(-1, -2)

    cls_t = torch.cat([to_pos_minor(t) for t in cls_outputs], dim=-1)

    def to_anchor_major(t):  # [T?, B, H, W, S*A*4] -> [B, A, hw, T?*S*4]
        lead = t.shape[:-3]
        hw = t.shape[-3] * t.shape[-2]
        t = t.reshape(*lead, hw, halves, num_anc, 4)
        if len(lead) == 2:                       # [T, B, hw, S, A, 4]
            t = t.permute(1, 4, 2, 0, 3, 5)      # [B, A, hw, T, S, 4]
        else:                                    # [B, hw, S, A, 4]
            t = t.permute(0, 3, 1, 2, 4)         # [B, A, hw, S, 4]
        return t.reshape(t.shape[0], num_anc, hw, -1)

    box_rows = torch.cat([to_anchor_major(t) for t in box_outputs], dim=2)

    sigma_cls_t = None
    if mc_cls:
        cls_t, sigma_cls_t = mc_moments(cls_t, sample_group)    # [B, A*C, R]

    r_len = cls_t.shape[-1]
    b = cls_t.shape[-3]
    cls_acr = cls_t.reshape(b, num_anc, num_classes, r_len)
    scores_ar = torch.amax(cls_acr, dim=2)                 # [B, A, R]
    classes_ar = torch.argmax(cls_acr, dim=2)
    n_total = num_anc * r_len
    scores_flat = scores_ar.reshape(b, n_total)            # flat n = a*R + r

    max_nms_inputs = pre_nms_topk or config.nms_configs.get("max_nms_inputs", 0)
    if max_nms_inputs <= 0:
        max_nms_inputs = MAX_DETECTION_POINTS
    if max_nms_inputs >= n_total:
        flat_idx = torch.arange(n_total, device=cls_t.device).expand(b, n_total)
        scores_logits = scores_flat
    else:
        order = torch.sort(scores_flat, dim=1, descending=True, stable=True)
        scores_logits = order.values[:, :max_nms_inputs]
        flat_idx = order.indices[:, :max_nms_inputs]

    rows = flat_idx % r_len                                # [B, M]
    anc = flat_idx // r_len
    # anchor index in the (level, h, w, a) ordering of the anchor grid
    indices = rows * num_anc + anc

    def gather_cls(t):       # [B, A, C, R] -> [B, M, C]
        if t is None:
            return None
        rows_t = t.transpose(2, 3).reshape(b, num_anc * r_len, -1)
        return rows_t.gather(1, flat_idx[:, :, None].expand(-1, -1, rows_t.shape[-1]))

    classes = classes_ar.reshape(b, n_total).gather(1, flat_idx)

    def gather_box(t):       # [B, A, hw, T?*S*4] rows -> [T?, B, M, S, 4]
        m = rows.shape[1]
        flat = t.reshape(b, num_anc * r_len, t.shape[-1])
        g = flat.gather(1, flat_idx[:, :, None].expand(-1, -1, flat.shape[-1]))
        if mc_box:
            tdim = box_outputs[0].shape[0]
            return g.reshape(b, m, tdim, halves, 4).permute(2, 0, 1, 3, 4)
        return g.reshape(b, m, halves, 4)

    box_g = gather_box(box_rows)                           # [T?, B, M, S, 4]
    box_mu = box_g[..., 0, :]
    sigma_al_g = box_g[..., 1, :] if loss_att else None
    anchor_sel = anchors.boxes(cls_t.device)[indices]      # [B, M, 4]

    sigma_mc = None
    method = config.uncert_adjust_method
    if loss_att and not mc_box:
        boxes, sigma_al = decode_uncert(box_mu, sigma_al_g, anchor_sel, method=method,
                                        n_samples=config.decode_nsamples)
    elif mc_box and loss_att:
        boxes_t, sig_t = decode_uncert(box_mu, sigma_al_g, anchor_sel, method=method,
                                       n_samples=config.decode_nsamples)
        boxes, sigma_mc = mc_moments(boxes_t, sample_group)
        sigma_al = sample_mean(sig_t, sample_group)
    elif mc_box:
        boxes, sigma_mc = mc_moments(anchor_lib.decode_box_outputs(box_mu, anchor_sel), sample_group)
        sigma_al = None
    else:
        boxes = anchor_lib.decode_box_outputs(box_mu.to(torch.float32), anchor_sel)
        sigma_al = None

    def f32(t):
        return None if t is None else t.to(torch.float32)

    sigma_cls_acr = None if sigma_cls_t is None else \
        sigma_cls_t.reshape(b, num_anc, num_classes, r_len)
    return dict(boxes=f32(boxes),
                scores_logits=scores_logits.to(torch.float32),
                classes=classes, indices=indices,
                sigma_al=f32(sigma_al), sigma_mc=f32(sigma_mc),
                sigma_cls=f32(gather_cls(sigma_cls_acr)),
                logits=f32(gather_cls(cls_acr)) if config.enable_softmax else None)


def _nms(config, boxes: torch.Tensor, scores: torch.Tensor) -> nms_lib.NMSResult:
    """Soft-NMS of [B, M] candidates with the config's method and K: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    nms_configs = config.nms_configs
    iou_thr, score_thr, sigma = nms_lib.nms_from_config(
        nms_configs if isinstance(nms_configs, dict) else nms_configs.as_dict())
    k = nms_configs.get("max_output_size") or 100
    return cuda_nms.batched_soft_nms(boxes.contiguous(), scores.contiguous(), k,
                                     iou_thr, score_thr, sigma)


def _gather(t: Optional[torch.Tensor], indices: torch.Tensor) -> Optional[torch.Tensor]:
    """[B, M, ·] at the picks [B, K] -> [B, K, ·]."""
    if t is None:
        return None
    idx = indices.reshape(*indices.shape, *([1] * (t.dim() - 2)))
    return t.gather(1, idx.expand(-1, -1, *t.shape[2:]))


def _clip(config, boxes: torch.Tensor) -> torch.Tensor:
    """Boxes clipped to the input resolution."""
    h, w = anchor_lib.from_config(config).image_size
    return torch.minimum(torch.clamp_min(boxes, 0.0),
                         torch.tensor([h, w, h, w], dtype=boxes.dtype, device=boxes.device))


def _scales(image_scales, boxes: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(image_scales, device=boxes.device).to(boxes.dtype)[:, None, None]


def postprocess_global(config, cls_outputs, box_outputs, image_scales=None,
                       pre_nms_topk: int = 0, sample_group=None) -> Detections:
    """Global soft-NMS post-processing of per-level outputs → Detections
    (``sample_group``: a sample axis split over a process group, ``pre_nms``);
    span ``post``."""
    with profiling.span("post"):
        pn = pre_nms(config, cls_outputs, box_outputs, pre_nms_topk, sample_group)
        res = _nms(config, pn["boxes"], torch.sigmoid(pn["scores_logits"]))
        boxes = _gather(pn["boxes"], res.indices)
        classes = _gather(pn["classes"], res.indices).to(boxes.dtype) + CLASS_OFFSET
        sigma_al = _gather(pn["sigma_al"], res.indices)
        sigma_mc = _gather(pn["sigma_mc"], res.indices)

        # clip to input resolution then scale back to the original image
        boxes = _clip(config, boxes)
        if image_scales is not None:
            s = _scales(image_scales, boxes)
            boxes = boxes * s
            if sigma_al is not None:
                sigma_al = sigma_al * s
            if sigma_mc is not None:
                sigma_mc = sigma_mc * s

        # zero out invalid slots for determinism
        m = res.valid[..., None].to(boxes.dtype)
        sigma_cls = _gather(pn["sigma_cls"], res.indices)
        return Detections(boxes=boxes * m, scores=res.scores * res.valid.to(boxes.dtype),
                          classes=classes * m[..., 0], valid_len=res.valid_len,
                          sigma_al=None if sigma_al is None else sigma_al * m,
                          sigma_mc=None if sigma_mc is None else sigma_mc * m,
                          sigma_cls=None if sigma_cls is None else sigma_cls * m,
                          logits=_gather(pn["logits"], res.indices))


def per_class_nms(config, cls_outputs, box_outputs, image_scales=None,
                  pre_nms_topk: int = 0) -> Detections:
    """Per-class soft-NMS: each candidate is shifted by its class times
    2·max(h, w), so one NMS never suppresses across classes; the top
    ``MAX_DETECTION_POINTS`` candidates unless ``pre_nms_topk`` says
    otherwise.

    As in the JAX package, only the boxes are scaled by ``image_scales``
    and zeroed at invalid slots: the σ outputs and logits are neither
    scaled nor masked (``postprocess_global`` does both). Span ``post``.
    """
    with profiling.span("post"):
        pn = pre_nms(config, cls_outputs, box_outputs, pre_nms_topk or MAX_DETECTION_POINTS)
        h, w = anchor_lib.from_config(config).image_size
        offset = float(max(h, w)) * 2.0
        shifted = pn["boxes"] + pn["classes"][..., None].to(pn["boxes"].dtype) * offset
        res = _nms(config, shifted, torch.sigmoid(pn["scores_logits"]))

        boxes = _clip(config, _gather(pn["boxes"], res.indices))
        classes = _gather(pn["classes"], res.indices).to(boxes.dtype) + CLASS_OFFSET
        if image_scales is not None:
            boxes = boxes * _scales(image_scales, boxes)
        m = res.valid[..., None].to(boxes.dtype)
        return Detections(boxes=boxes * m, scores=res.scores * m[..., 0],
                          classes=classes * m[..., 0], valid_len=res.valid_len,
                          sigma_al=_gather(pn["sigma_al"], res.indices),
                          sigma_mc=_gather(pn["sigma_mc"], res.indices),
                          sigma_cls=_gather(pn["sigma_cls"], res.indices),
                          logits=_gather(pn["logits"], res.indices))


def generate_detections(config, cls_outputs, box_outputs, image_scales, image_ids,
                        pre_nms_topk: int = 0) -> torch.Tensor:
    """[B, K, 7] rows of [image_id, x, y, w, h, score, class] from the
    global post-processing."""
    det = postprocess_global(config, cls_outputs, box_outputs, image_scales, pre_nms_topk)
    ymin, xmin, ymax, xmax = det.boxes.unbind(-1)
    ids = torch.as_tensor(image_ids, device=det.boxes.device).to(det.boxes.dtype)[:, None] \
        * torch.ones_like(det.scores)
    return torch.stack([ids, xmin, ymin, xmax - xmin, ymax - ymin, det.scores, det.classes],
                       dim=-1)
