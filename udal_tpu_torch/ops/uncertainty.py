"""Uncertainty decoding and MC-sample aggregation.

Port of ``udal_tpu/ops/uncertainty.py``: the closed-form ``l-norm`` /
``n-flow`` decode of anchor-relative (mean, std) boxes into absolute corner
means and stds, and the mean/std over the leading MC-sample axis. The
``sample`` and ``falsedec`` decodes are not ported yet (ROADMAP A8).
"""

from __future__ import annotations

from typing import Tuple

import torch

from udal_tpu_torch.ops.anchors import anchors_to_centersize


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
                  anchor_boxes: torch.Tensor, method: str = "l-norm"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode anchor-relative (mean, std) box distributions to absolute ones.

    pred_boxes / box_uncert: [..., 4] (ty, tx, th, tw) means and stds;
    anchor_boxes: [..., 4] broadcast against them. Computes in float32 and
    returns (boxes [..., 4] y1x1y2x2, stds [..., 4]) in the input dtype.
    """
    if method in ("sample", "falsedec"):
        raise NotImplementedError(
            f"decode_uncert method {method!r} is not ported yet (ROADMAP A8)")
    if method not in ("l-norm", "n-flow"):
        raise ValueError(f"Unknown uncertainty decode method: {method!r}")
    orig_dtype = pred_boxes.dtype
    ycenter_a, xcenter_a, ha, wa = anchors_to_centersize(
        anchor_boxes.to(torch.float32))
    ty, tx, th, tw = pred_boxes.to(torch.float32).unbind(-1)
    pred_var = torch.square(box_uncert.to(torch.float32))
    dty, dtx, dth, dtw = pred_var.unbind(-1)

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
    coords = torch.stack(corners, dim=-1).to(orig_dtype)
    uncerts = torch.sqrt(torch.clamp_min(torch.stack(dcorners, dim=-1), 0.0))
    return coords, uncerts.to(orig_dtype)


def mc_moments(stacked: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and std over the leading MC-sample axis, accumulated in float32."""
    x = stacked.to(torch.float32)
    mean = torch.mean(x, dim=0)
    var = torch.mean(torch.square(x), dim=0) - torch.square(mean)
    return mean, torch.sqrt(torch.clamp_min(var, 0.0))
