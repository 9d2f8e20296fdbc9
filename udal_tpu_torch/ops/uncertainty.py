"""Uncertainty decoding and MC-sample aggregation.

Port of ``udal_tpu/ops/uncertainty.py``: the decode of anchor-relative
(mean, std) boxes into absolute corner means and stds (closed-form
``l-norm`` / ``n-flow``, Monte-Carlo ``sample``, the naive ``falsedec``
baseline), the mean/std over the leading MC-sample axis, and the helpers
the apps and training use (``relativize_uncert``, ``clip_uncert``,
``entropy_from_logits``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from udal_tpu_torch.ops.anchors import anchors_to_centersize
from udal_tpu_torch.parallel.collectives import all_reduce, size


def _corner_moments(ycenter, xcenter, h, w, dycenter, dxcenter, dh, dw):
    """Means/variances of corners from center-size means/variances."""
    ymin = ycenter - h / 2.0
    xmin = xcenter - w / 2.0
    ymax = ycenter + h / 2.0
    xmax = xcenter + w / 2.0
    dymin = dycenter + dh / 4.0
    dxmin = dxcenter + dw / 4.0
    dymax = dycenter + dh / 4.0
    dxmax = dxcenter + dw / 4.0
    return (ymin, xmin, ymax, xmax), (dymin, dxmin, dymax, dxmax)


def decode_uncert(pred_boxes: torch.Tensor, box_uncert: torch.Tensor,
                  anchor_boxes: torch.Tensor, method: str = "l-norm",
                  n_samples: int = 30, generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode anchor-relative (mean, std) box distributions to absolute ones.

    pred_boxes / box_uncert: [..., 4] (ty, tx, th, tw) means and stds;
    anchor_boxes: [..., 4] broadcast against them. Computes in float32 and
    returns (boxes [..., 4] y1x1y2x2, stds [..., 4]) in the input dtype.

    ``sample`` pushes ``n_samples`` normal draws of (ty, tx, th, tw)
    through the decode and takes their moments. The noise ``eps`` [S, 4,
    ...] comes from ``generator`` (by default one seeded 0 on the boxes'
    device, as the JAX package defaults to ``PRNGKey(0)``), or is given.
    It is held whole: at the serving operating point (S = 100, T = 10,
    B = 8, M = 5000) that is 100·4·10·8·5000 f32 = 640 MB.
    """
    if method not in ("l-norm", "n-flow", "sample", "falsedec"):
        raise ValueError(f"Unknown uncertainty decode method: {method!r}")
    orig_dtype = pred_boxes.dtype
    ycenter_a, xcenter_a, ha, wa = anchors_to_centersize(
        anchor_boxes.to(torch.float32))
    ty, tx, th, tw = pred_boxes.to(torch.float32).unbind(-1)
    pred_var = torch.square(box_uncert.to(torch.float32))
    dty, dtx, dth, dtw = pred_var.unbind(-1)

    if method in ("l-norm", "n-flow"):
        # Exact moments: centers are affine in normal ty/tx; sizes are scaled
        # log-normals ('n-flow' builds the same distributions, same moments).
        w = torch.exp(tw + dtw / 2) * wa
        h = torch.exp(th + dth / 2) * ha
        ycenter = ty * ha + ycenter_a
        xcenter = tx * wa + xcenter_a
        dw = (torch.exp(dtw) - 1) * torch.exp(2 * tw + dtw) * wa ** 2
        dh = (torch.exp(dth) - 1) * torch.exp(2 * th + dth) * ha ** 2
        dycenter = dty * ha ** 2
        dxcenter = dtx * wa ** 2
        corners, dcorners = _corner_moments(ycenter, xcenter, h, w,
                                            dycenter, dxcenter, dh, dw)
    elif method == "sample":
        t_mean = torch.stack([ty, tx, th, tw], dim=0)
        t_std = torch.sqrt(torch.stack([dty, dtx, dth, dtw], dim=0))
        if eps is None:
            if generator is None:
                generator = torch.Generator(device=t_mean.device).manual_seed(0)
            eps = torch.randn((n_samples,) + tuple(t_mean.shape), generator=generator,
                              device=t_mean.device, dtype=torch.float32)
        samp = t_mean[None] + eps.to(t_mean.device, torch.float32) * t_std[None]   # [S, 4, ...]
        sy, sx, sh, sw = samp[:, 0], samp[:, 1], samp[:, 2], samp[:, 3]
        w = torch.exp(sw) * wa
        h = torch.exp(sh) * ha
        ycenter = sy * ha + ycenter_a
        xcenter = sx * wa + xcenter_a
        stacked = torch.stack([ycenter - h / 2, xcenter - w / 2,
                               ycenter + h / 2, xcenter + w / 2], dim=1)   # [S, 4, ...]
        mean = torch.mean(stacked, dim=0)
        var = torch.mean(torch.square(stacked), dim=0) - torch.square(mean)
        corners = tuple(mean.unbind(0))
        dcorners = tuple(var.unbind(0))
    else:
        # the naive (incorrect) decode, kept as an ablation baseline
        w = torch.exp(tw) * wa
        h = torch.exp(th) * ha
        ycenter = ty * ha + ycenter_a
        xcenter = tx * wa + xcenter_a
        dw = torch.exp(dtw) * wa
        dh = torch.exp(dth) * ha
        dycenter = dty * ha + ycenter_a
        dxcenter = dtx * wa + xcenter_a
        corners = (ycenter - h / 2, xcenter - w / 2, ycenter + h / 2, xcenter + w / 2)
        dcorners = (torch.abs(dycenter - dh / 2), torch.abs(dxcenter - dw / 2),
                    dycenter + dh / 2, dxcenter + dw / 2)

    coords = torch.stack(corners, dim=-1).to(orig_dtype)
    uncerts = torch.sqrt(torch.clamp_min(torch.stack(dcorners, dim=-1), 0.0))
    return coords, uncerts.to(orig_dtype)


def relativize_uncert(pred_boxes: torch.Tensor, box_uncert: torch.Tensor) -> torch.Tensor:
    """Per-coordinate stds divided by the box's height / width."""
    height = pred_boxes[..., 2] - pred_boxes[..., 0]
    width = pred_boxes[..., 3] - pred_boxes[..., 1]
    return box_uncert / torch.stack([height, width, height, width], dim=-1)


def mc_moments(stacked: torch.Tensor, sample_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and std over the leading MC-sample axis, accumulated in float32.
    With a ``sample_group`` the axis holds this rank's share of samples
    split evenly over the group: the ranks' means of x and x² are averaged
    by an all-reduce, and no per-sample map leaves the rank (a group of one
    computes what no group does)."""
    x = stacked.to(torch.float32)
    if sample_group is None:
        mean = torch.mean(x, dim=0)
        var = torch.mean(torch.square(x), dim=0) - torch.square(mean)
    else:
        means = torch.stack([torch.mean(x, dim=0), torch.mean(torch.square(x), dim=0)])
        means = all_reduce(means, sample_group) / size(sample_group)
        mean = means[0]
        var = means[1] - torch.square(mean)
    return mean, torch.sqrt(torch.clamp_min(var, 0.0))


def sample_mean(stacked: torch.Tensor, sample_group=None) -> torch.Tensor:
    """Mean over the leading sample axis in float32 (over the group's
    samples with a ``sample_group``, as ``mc_moments``)."""
    mean = torch.mean(stacked.to(torch.float32), dim=0)
    if sample_group is None:
        return mean
    return all_reduce(mean, sample_group) / size(sample_group)


def clip_uncert(log_sigma_sq: torch.Tensor, clip_min: float, clip_max: float) -> torch.Tensor:
    """Clip a predicted log-variance in the sigma domain."""
    sigma = torch.clamp(torch.sqrt(torch.exp(log_sigma_sq)), clip_min, clip_max)
    return torch.log(torch.square(sigma))


def entropy_from_logits(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Shannon entropy of softmax(logits)."""
    logp = torch.log_softmax(logits, dim=dim)
    return -torch.sum(torch.exp(logp) * logp, dim=dim)
