"""Model FLOPs of a configuration, counted from its layer shapes.

2 × the multiply-adds of every convolution and dense layer (depthwise
included, squeeze-excite on its pooled vector); no normalisation,
activation, resampling or post-processing. A layer that no dropout site
feeds counts once an image; a layer downstream of a site counts once a
sample (T times an image). So the count is the same whatever implements
the model: a fold, a fused kernel or an unfused chain.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from bench_torch import reference as R

# (name, multiply-adds an image, fed by a dropout site)
Layer = Tuple[str, float, bool]


def _conv(h, w, cin, cout, k, stride=1, groups=1) -> Tuple[float, int, int]:
    ho, wo = -(-h // stride), -(-w // stride)
    return float(ho * wo * cout * (cin // groups) * k * k), ho, wo


def layers(arch, mc: bool = True) -> List[Layer]:
    """Every convolution of the model with its multiply-adds an image and
    whether a dropout site feeds it (MC dropout on where ``mc``)."""
    out: List[Layer] = []
    h, w = arch["image_size"]
    back = mc and arch["mc_backbone_rate"] > 0
    heads = mc and arch["mc_head_rate"] > 0
    macs, h, w = _conv(h, w, 3, arch["stem_filters"], 3, 2)
    out.append(("stem", macs, False))
    cin, dropped = arch["stem_filters"], False
    levels: Dict[int, Tuple[int, int, int]] = {}
    red = set(R.reductions(arch))
    for i, b in enumerate(R.blocks(arch)):
        ce = cin
        if b["e"] != 1:
            ce = b["cin"] * b["e"]
            out.append((f"blocks_{i}.expand", _conv(h, w, cin, ce, 1)[0], dropped))
            dropped = dropped or back
        macs, h, w = _conv(h, w, ce, ce, b["k"], b["s"], ce)
        out.append((f"blocks_{i}.depthwise", macs, dropped))
        dropped = dropped or back
        cse = max(1, int(b["cin"] * b["se"]))
        out.append((f"blocks_{i}.se", float(2 * ce * cse), dropped))
        out.append((f"blocks_{i}.project", _conv(h, w, ce, b["cout"], 1)[0], dropped))
        cin = b["cout"]
        if i in red:
            levels[len(levels) + 1] = (h, w, cin)
    f = arch["fpn_num_filters"]
    sizes = R.level_sizes(arch)
    widths = {l: levels[l][2] for l in range(arch["min_level"], 6)}
    for level in range(6, arch["max_level"] + 1):
        if widths[level - 1] != f:
            lh, lw = sizes[level - 1]
            out.append((f"resample_p{level}", _conv(lh, lw, widths[level - 1], f, 1)[0],
                        dropped))
        widths[level] = f
    lo = arch["min_level"]
    for r in range(arch["fpn_cell_repeats"]):
        ws = [widths[l] if r == 0 else f for l in range(lo, arch["max_level"] + 1)]
        for n, (level, offsets) in enumerate(R.bifpn_nodes(lo, arch["max_level"])):
            for j, o in enumerate(offsets):
                if ws[o] != f:
                    ih, iw = sizes[lo + o] if o < len(widths) else sizes[level]
                    out.append((f"cell_{r}.fnode{n}.resample_{j}",
                                _conv(ih, iw, ws[o], f, 1)[0], dropped))
            lh, lw = sizes[level]
            out.append((f"cell_{r}.fnode{n}.conv", _conv(lh, lw, f, f, 3, 1, f)[0]
                        + _conv(lh, lw, f, f, 1)[0], dropped))
            ws.append(f)
    a = R.num_anchors(arch)
    couts = {"class": arch["num_classes"] * a,
             "box": 4 * a * (2 if arch["loss_attenuation"] else 1)}
    for name, cout in couts.items():
        for level in range(lo, arch["max_level"] + 1):
            lh, lw = sizes[level]
            d = dropped
            for i in range(arch["box_class_repeats"]):
                out.append((f"{name}-{i}.l{level}", _conv(lh, lw, f, f, 3, 1, f)[0]
                            + _conv(lh, lw, f, f, 1)[0], d))
                d = d or heads
            out.append((f"{name}-predict.l{level}", _conv(lh, lw, f, f, 3, 1, f)[0]
                        + _conv(lh, lw, f, cout, 1)[0], d))
    return out


def image_flops(arch, samples: int) -> float:
    """FLOPs of one image with ``samples`` MC samples (1: one pass with
    dropout where the configuration has it, as a training step's forward)."""
    return sum(2.0 * macs * (samples if fed else 1)
               for _, macs, fed in layers(arch, mc=True))
