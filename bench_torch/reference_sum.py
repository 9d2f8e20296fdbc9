"""Plain PyTorch reference of an EfficientDet whose BiFPN fuses by a plain sum.

``reference.py``'s network with ``fpn_weight_method: "sum"``, as
google/automl's ``FNode`` computes it for d6, d7 and d7x: each node adds
its resampled inputs (``tf.add_n``, no edge weights), then swish, the
separable 3x3 conv and BatchNorm. ``param_shapes`` is ``reference``'s
without the ``edge_weights`` leaves, which the program does not hold for
this fusion. Everything else is ``reference.py``'s, imported as it is:
the EfficientNet backbone, the P6..P``max_level`` resampling, the shared
class and box towers with a BatchNorm per level, MC dropout as channel
masks, the input, the anchors, the T-moments, top-k, soft-NMS and the
packed tuple, and the ``f32`` / ``bf16`` / ``fp8`` arithmetic (``Arith``).

Departures from the published model, all of them ``reference.py``'s: the
weights are random and calibrated (``weights.py``, ``calibrate``), not
trained; MC dropout masks come from the serve that is checked. Nothing
here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from bench_torch import reference as R
from bench_torch.reference import (Arith, Masks, RandomMasks, backbone, batch_norm, head,
                                   postprocess, resample, run)

__all__ = ["param_shapes", "bifpn", "network", "serve", "calibrate", "run", "Arith"]


def param_shapes(arch) -> Dict[str, Tuple[int, ...]]:
    """Every weight of the model by its state-dict name, with its shape."""
    return {k: v for k, v in R.param_shapes(arch).items() if not k.endswith(".edge_weights")}


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
            x = ar.q(sum(ins))
            x = ar.conv(ar.act(x), p[f"{pre}.conv.depthwise.weight"], groups=x.shape[1])
            x = ar.conv(x, p[f"{pre}.conv.pointwise.weight"], p[f"{pre}.conv.pointwise.bias"])
            all_feats.append(batch_norm(x, p, f"{pre}.bn", eps, ar))
        feats = []
        for level in range(lo, hi + 1):
            last = max(i for i, (l, _) in enumerate(nodes) if l == level)
            feats.append(all_feats[len(all_feats) - len(nodes) + last])
    return feats


def network(images, p, arch, ar: Arith, masks: Optional[Masks]):
    """Normalised NHWC images [B, H, W, 3] → per-level class and box maps
    [T, B, C, H, W] (T = 1 without masks), as ``reference.network``."""
    t = arch["mc_samples"] if masks is not None else 1
    x = images.permute(0, 3, 1, 2)
    b = x.shape[0]
    per_sample_backbone = masks is not None and arch["mc_backbone_rate"] > 0
    if per_sample_backbone:
        x = x.repeat(t, 1, 1, 1)
    feats = bifpn(backbone(x, p, arch, ar, masks), p, arch, ar)
    if not per_sample_backbone:
        feats = [f.repeat(t, 1, 1, 1) for f in feats]
    cls = head(feats, p, arch, "class", ar, masks)
    box = head(feats, p, arch, "box", ar, masks)
    if masks is not None:
        masks.done()
    split = [[m.reshape(t, b, *m.shape[1:]) for m in o] for o in (cls, box)]
    return split[0], split[1]


def serve(images, image_scales, p, arch, precision="f32", masks=None) -> Tuple[torch.Tensor, ...]:
    """Normalised NHWC images → the packed tuple, MC samples from ``masks``
    (the served keep bits in draw order)."""
    ar = Arith(precision)
    cls, box = network(ar.q(images), p, arch, ar,
                       None if masks is None else Masks(masks, images.device))
    return postprocess(cls, box, arch, image_scales)


def calibrate(images, p, arch, generator: torch.Generator,
              stored: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """``reference.calibrate`` through this network: the BatchNorm
    statistics set layer by layer from a pass with MC dropout on, each
    predict conv scaled to ``arch["output_std"]``, every value kept as
    ``stored`` holds it."""
    ar = Arith(calibrate=True, stored=stored)
    p = {k: ar.store(v) for k, v in p.items()}
    network(images, p, arch, ar, RandomMasks(generator, images.device))
    return p
