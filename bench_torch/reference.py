"""Plain PyTorch reference of the served EfficientDet, for the check of ``correct``.

Written from the architecture and the configuration file alone: the
EfficientNet backbone with squeeze-excite, the P6/P7 resampling, the BiFPN
with fast attention, the shared class and box towers, MC dropout as
channel masks, the T-moments of the class logits and of the l-norm decoded
boxes, the exact top-k candidates, Gaussian soft-NMS and the packed tuple.
It imports nothing of the program: the weights come from the benchmark
(``weights.py``), the dropout masks from the serve that is checked, in the
order its sites draw them.

Tensors are NCHW and float32. With ``precision="fp8"`` the network is
computed in float8 e4m3, the step below the configuration's bf16 (the
control): every tensor it makes is rounded to it, with a per-tensor scale
(``Arith``); with ``precision="bf16"`` every tensor is rounded to bfloat16
(a witness of what the configuration's own precision does to the
network). The post-processing is float32. TF32 is switched off by
``run``.
"""

from __future__ import annotations

import itertools
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

CLASS_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
NEG_INF = -1e10


# -- architecture tables --------------------------------------------------------

def decode_block(s: str) -> Dict[str, int]:
    """One EfficientNet block string (r1_k3_s11_e1_i32_o16_se0.25)."""
    opts = {}
    for op in s.split("_"):
        key, value = re.split(r"(\d.*)", op)[:2]
        opts[key] = value
    return dict(repeats=int(opts["r"]), k=int(opts["k"]), s=int(opts["s"][0]),
                e=int(opts["e"]), cin=int(opts["i"]), cout=int(opts["o"]),
                se=float(opts["se"]))


def blocks(arch) -> List[Dict[str, int]]:
    """One entry per MBConv block, repeats written out (stride 1, the
    output width in, after the first)."""
    out = []
    for s in arch["backbone_blocks"]:
        b = decode_block(s)
        out.append(b)
        for _ in range(b["repeats"] - 1):
            out.append(dict(b, s=1, cin=b["cout"]))
    return out


def level_sizes(arch) -> List[Tuple[int, int]]:
    """(h, w) of pyramid levels 0 .. max_level, ceil-halved from the image."""
    h, w = arch["image_size"]
    sizes = [(h, w)]
    for _ in range(arch["max_level"]):
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        sizes.append((h, w))
    return sizes


def bifpn_nodes(min_level: int, max_level: int) -> List[Tuple[int, List[int]]]:
    """(level, input offsets) of each BiFPN node: top-down, then bottom-up."""
    ids = {l: [l - min_level] for l in range(min_level, max_level + 1)}
    count = itertools.count(max_level - min_level + 1)
    nodes = []
    for l in range(max_level - 1, min_level - 1, -1):
        nodes.append((l, [ids[l][-1], ids[l + 1][-1]]))
        ids[l].append(next(count))
    for l in range(min_level + 1, max_level + 1):
        nodes.append((l, ids[l][:] + [ids[l - 1][-1]]))
        ids[l].append(next(count))
    return nodes


def num_anchors(arch) -> int:
    return arch["num_scales"] * len(arch["aspect_ratios"])


def reductions(arch) -> List[int]:
    """Indices of the blocks whose outputs are reductions 1..5."""
    bl = blocks(arch)
    return [i for i in range(len(bl)) if i == len(bl) - 1 or bl[i + 1]["s"] > 1]


def param_shapes(arch) -> Dict[str, Tuple[int, ...]]:
    """Every weight of the model by its state-dict name, with its shape."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def bn(prefix, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{leaf}"] = (c,)

    shapes["backbone.stem_conv.weight"] = (arch["stem_filters"], 3, 3, 3)
    bn("backbone.stem_bn", arch["stem_filters"])
    cin = arch["stem_filters"]
    for i, b in enumerate(blocks(arch)):
        p = f"backbone.blocks_{i}"
        ce = cin
        if b["e"] != 1:
            ce = b["cin"] * b["e"]
            shapes[f"{p}.expand_conv.weight"] = (ce, cin, 1, 1)
            bn(f"{p}.bn0", ce)
        shapes[f"{p}.depthwise_conv.weight"] = (ce, 1, b["k"], b["k"])
        bn(f"{p}.bn1", ce)
        cse = max(1, int(b["cin"] * b["se"]))
        shapes[f"{p}.se.reduce.weight"] = (cse, ce, 1, 1)
        shapes[f"{p}.se.reduce.bias"] = (cse,)
        shapes[f"{p}.se.expand.weight"] = (ce, cse, 1, 1)
        shapes[f"{p}.se.expand.bias"] = (ce,)
        shapes[f"{p}.project_conv.weight"] = (b["cout"], ce, 1, 1)
        bn(f"{p}.bn2", b["cout"])
        cin = b["cout"]
    f = arch["fpn_num_filters"]
    bl = blocks(arch)
    widths = [bl[i]["cout"] for i in reductions(arch)[arch["min_level"] - 1:]]
    for level in range(6, arch["max_level"] + 1):
        if widths[-1] != f:
            shapes[f"resample_p{level}.conv1x1.weight"] = (f, widths[-1], 1, 1)
            shapes[f"resample_p{level}.conv1x1.bias"] = (f,)
            bn(f"resample_p{level}.bn", f)
        widths.append(f)
    for r in range(arch["fpn_cell_repeats"]):
        w = list(widths) if r == 0 else [f] * len(widths)
        for n, (_, offsets) in enumerate(bifpn_nodes(arch["min_level"], arch["max_level"])):
            p = f"fpn_cells.cell_{r}.fnode{n}"
            for j, o in enumerate(offsets):
                if w[o] != f:
                    shapes[f"{p}.resample_{j}.conv1x1.weight"] = (f, w[o], 1, 1)
                    shapes[f"{p}.resample_{j}.conv1x1.bias"] = (f,)
                    bn(f"{p}.resample_{j}.bn", f)
            shapes[f"{p}.edge_weights"] = (len(offsets),)
            shapes[f"{p}.conv.depthwise.weight"] = (f, 1, 3, 3)
            shapes[f"{p}.conv.pointwise.weight"] = (f, f, 1, 1)
            shapes[f"{p}.conv.pointwise.bias"] = (f,)
            bn(f"{p}.bn", f)
            w.append(f)
    a = num_anchors(arch)
    levels = arch["max_level"] - arch["min_level"] + 1
    outs = {"class": arch["num_classes"] * a,
            "box": 4 * a * (2 if arch["loss_attenuation"] else 1)}
    for head, cout in outs.items():
        for i in range(arch["box_class_repeats"]):
            p = f"{head}_net.stack.{head}-{i}"
            shapes[f"{p}.depthwise.weight"] = (f, 1, 3, 3)
            shapes[f"{p}.pointwise.weight"] = (f, f, 1, 1)
            shapes[f"{p}.pointwise.bias"] = (f,)
            for level in range(levels):
                bn(f"{head}_net.stack.{head}-{i}-bn-{level}", f)
        p = f"{head}_net.{head}-predict"
        shapes[f"{p}.depthwise.weight"] = (f, 1, 3, 3)
        shapes[f"{p}.pointwise.weight"] = (cout, f, 1, 1)
        shapes[f"{p}.pointwise.bias"] = (cout,)
    return shapes


# -- arithmetic -----------------------------------------------------------------

class Arith:
    """The network's arithmetic at the reference's precision: float32, or
    every tensor the network makes (each convolution's and matmul's inputs,
    weights and output, each normalisation, activation, mask, gate, sum)
    rounded to bfloat16, or to float8 e4m3 with a per-tensor scale."""

    def __init__(self, precision: str = "f32", calibrate: bool = False,
                 stored: torch.dtype = torch.float32):
        if precision not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision is f32, bf16 or fp8, got {precision!r}")
        self.precision = precision
        self.calibrate = calibrate
        self.stored = stored      # the type calibrated weights are kept in

    def store(self, t: torch.Tensor) -> torch.Tensor:
        """A calibrated weight as the served type holds it (in f32)."""
        return t.to(self.stored).to(torch.float32)

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """t rounded to float8 e4m3 with a per-tensor scale (fp8), to
        bfloat16 (bf16), else t."""
        if self.precision == "f32":
            return t
        if self.precision == "bf16":
            return t.to(torch.bfloat16).to(torch.float32)
        scale = torch.clamp_min(t.abs().amax(), 1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """swish"""
        return self.q(x * torch.sigmoid(x))

    def conv(self, x, w, b=None, stride=1, groups=1) -> torch.Tensor:
        """TF "SAME" convolution (the extra row and column of padding at
        the end at stride 2)."""
        k = w.shape[-1]
        pads = []
        for size in (x.shape[-1], x.shape[-2]):
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        y = F.conv2d(F.pad(self.q(x), pads), self.q(w), None, stride, 0, 1, groups)
        if b is not None:
            y = y + b[:, None, None]
        return self.q(y)


def batch_norm(x, p: Dict[str, torch.Tensor], prefix: str, eps: float,
               ar: Arith) -> torch.Tensor:
    """Inference BatchNorm with the running statistics; when calibrating,
    they are first set from the batch: each channel's mean over (N, H, W)
    and the layer's mean variance."""
    if ar.calibrate:
        p[f"{prefix}.running_mean"] = ar.store(x.mean((0, 2, 3)))
        # one variance for the layer (its channels' mean): a channel that barely
        # moves on the calibration frames is not amplified on others
        var = x.var((0, 2, 3), unbiased=False).mean()
        p[f"{prefix}.running_var"] = ar.store(var.expand(x.shape[1]).clone())
    scale = p[f"{prefix}.weight"] / torch.sqrt(p[f"{prefix}.running_var"] + eps)
    return ar.q((x - p[f"{prefix}.running_mean"][:, None, None]) * scale[:, None, None]
                + p[f"{prefix}.bias"][:, None, None])


class Masks:
    """The served MC-dropout keep bits, in the order the sites draw them;
    each site takes the next and checks its shape."""

    def __init__(self, bits: Sequence[torch.Tensor], device):
        self.bits = iter(bits)
        self.device = device

    def take(self, n: int, c: int, rate: float) -> torch.Tensor:
        try:
            bits = next(self.bits)
        except StopIteration:
            raise ValueError(f"the serve drew fewer masks than the reference's sites "
                             f"(a site [{n}, {c}] has none)") from None
        if tuple(bits.shape) != (n, c):
            raise ValueError(f"mask [{n}, {c}] expected, the serve drew {list(bits.shape)}")
        return bits.to(self.device, torch.float32)[:, :, None, None] / (1.0 - rate)

    def done(self) -> None:
        if next(self.bits, None) is not None:
            raise ValueError("the serve drew more masks than the reference's sites")


# -- the network ----------------------------------------------------------------

def backbone(x, p, arch, ar: Arith, masks: Optional[Masks]) -> List[torch.Tensor]:
    """Reductions 3..5 of NCHW images (already repeated T times t-major
    where the backbone drops out)."""
    eps = arch["bn_epsilon"]
    rate = arch["mc_backbone_rate"] if masks is not None else 0.0
    x = ar.act(batch_norm(ar.conv(x, p["backbone.stem_conv.weight"], stride=2), p,
                         "backbone.stem_bn", eps, ar))
    keep = set(reductions(arch)[arch["min_level"] - 1:])
    feats = []

    def drop(h):
        return ar.q(h * masks.take(h.shape[0], h.shape[1], rate)) if rate > 0 else h

    for i, b in enumerate(blocks(arch)):
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
    """A map to the BiFPN's width (1x1 conv + BN where it differs) and to
    ``size``: SAME max-pool down (kernel stride + 1), nearest up."""
    if f"{prefix}.conv1x1.weight" in p:
        x = batch_norm(ar.conv(x, p[f"{prefix}.conv1x1.weight"], p[f"{prefix}.conv1x1.bias"]),
                       p, f"{prefix}.bn", eps, ar)
    h, w = x.shape[-2:]
    th, tw = size
    if h > th and w > tw:
        sh, sw = (h - 1) // th + 1, (w - 1) // tw + 1
        pads = []
        for n, s in ((w, sw), (h, sh)):
            total = max((-(-n // s) - 1) * s + s + 1 - n, 0)
            pads += [total // 2, total - total // 2]
        return F.max_pool2d(F.pad(x, pads, value=float("-inf")), (sh + 1, sw + 1), (sh, sw))
    if (h, w) != (th, tw):
        rows = torch.arange(th, device=x.device) * h // th
        cols = torch.arange(tw, device=x.device) * w // tw
        x = x[:, :, rows][:, :, :, cols]
    return x


def bifpn(feats, p, arch, ar: Arith) -> List[torch.Tensor]:
    eps = arch["bn_epsilon"]
    sizes = level_sizes(arch)
    lo, hi = arch["min_level"], arch["max_level"]
    for level in range(6, hi + 1):
        feats.append(resample(feats[-1], p, f"resample_p{level}", sizes[level], ar, eps))
    nodes = bifpn_nodes(lo, hi)
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


def head(feats, p, arch, name: str, ar: Arith, masks: Optional[Masks]) -> List[torch.Tensor]:
    eps = arch["bn_epsilon"]
    rate = arch["mc_head_rate"] if masks is not None else 0.0
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
    if ar.calibrate:      # the predict conv's weight scaled to the output spread asked for
        bias = p[f"{pre}.pointwise.bias"][:, None]
        spread = torch.cat([(o.transpose(0, 1).flatten(1) - bias) for o in outs], 1).std()
        weight = p[f"{pre}.pointwise.weight"]
        p[f"{pre}.pointwise.weight"] = ar.store(weight * arch["output_std"][name] / spread)
    return outs


def network(images, p, arch, ar: Arith, masks: Optional[Masks]):
    """Normalised NHWC images [B, H, W, 3] → per-level class and box maps
    [T, B, C, H, W] (T = 1 without masks)."""
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


# -- the input and the post-processing ------------------------------------------------

def normalise(frames_u8, arch, valid_hw=None) -> torch.Tensor:
    """uint8 (or warped f32) NHWC frames → normalised f32, zero past valid_hw."""
    mean = torch.tensor(arch["mean_rgb"], device=frames_u8.device)
    std = torch.tensor(arch["stddev_rgb"], device=frames_u8.device)
    x = (frames_u8.to(torch.float32) - mean) / std
    if valid_hw is not None:
        h, w = x.shape[1:3]
        rows = torch.arange(h, device=x.device)[None] < valid_hw[:, :1]
        cols = torch.arange(w, device=x.device)[None] < valid_hw[:, 1:]
        x = x * (rows[:, :, None] & cols[:, None, :])[..., None]
    return x


def warp(frames_u8, scale, offset, out_hw) -> torch.Tensor:
    """Bilinear resize of each frame by its (y, x) scale, cropped at its
    offset, onto the out_hw canvas; zero past the scaled frame. Output pixel
    i samples the source at (i + 0.5 + offset) / scale - 0.5 with the
    triangle filter, weights normalised, as jax.image.scale_and_translate."""
    x = frames_u8.to(torch.float32)
    out = []
    for n in range(x.shape[0]):
        mats = []
        for axis in (0, 1):
            size, osize = x.shape[1 + axis], out_hw[axis]
            s = float(scale[n, axis])
            pos = (torch.arange(osize, dtype=torch.float32, device=x.device) + 0.5
                   + float(offset[n, axis])) / s - 0.5
            src = torch.arange(size, dtype=torch.float32, device=x.device)
            w = torch.clamp_min(1 - (pos[:, None] - src[None]).abs(), 0)
            total = w.sum(1, keepdim=True)
            w = torch.where(total > 1000 * torch.finfo(torch.float32).eps,
                            w / torch.where(total != 0, total, 1.0), 0.0)
            mats.append(w * ((pos >= -0.5) & (pos <= size - 0.5))[:, None])
        out.append(torch.einsum("ih,hwc,jw->ijc", mats[0], x[n], mats[1]))
    return torch.stack(out)


def anchors(arch, device) -> torch.Tensor:
    """[N, 4] anchors (y1, x1, y2, x2), ordered (level, y, x, anchor)."""
    sizes = level_sizes(arch)
    h0, w0 = arch["image_size"]
    out = []
    for level in range(arch["min_level"], arch["max_level"] + 1):
        fh, fw = sizes[level]
        sy, sx = sizes[0][0] / fh, sizes[0][1] / fw
        per = []
        for octave in range(arch["num_scales"]):
            for aspect in arch["aspect_ratios"]:
                ax = math.sqrt(aspect)
                hy = arch["anchor_scale"] * sy * 2 ** (octave / arch["num_scales"]) / ax / 2
                hx = arch["anchor_scale"] * sx * 2 ** (octave / arch["num_scales"]) * ax / 2
                ys = torch.arange(sy / 2, h0, sy, dtype=torch.float64)
                xs = torch.arange(sx / 2, w0, sx, dtype=torch.float64)
                yv, xv = torch.meshgrid(ys, xs, indexing="ij")
                per.append(torch.stack([yv - hy, xv - hx, yv + hy, xv + hx], -1).reshape(-1, 4))
        out.append(torch.stack(per, 1).reshape(-1, 4))
    return torch.cat(out).to(torch.float32).to(device)


def soft_nms(boxes, scores, arch) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy Gaussian soft-NMS of [B, M] candidates: (picks [B, K], their
    decayed scores, valid [B, K]), valid picks first."""
    cfg = arch["nms"]
    k, iou_thr, score_thr, sigma = (cfg["max_output_size"], cfg["iou_thresh"],
                                    cfg["score_thresh"], cfg["sigma"])
    work = scores.clone()
    b, m = work.shape
    y1, x1, y2, x2 = boxes.unbind(-1)
    area = (y2 - y1).clamp_min(0) * (x2 - x1).clamp_min(0)
    lane = torch.arange(m, device=work.device)
    picks, picked = [], []
    for _ in range(k):
        best_score, _ = work.max(1, keepdim=True)
        best = torch.where(work == best_score, lane, m).min(1, keepdim=True).values
        picks.append(best[:, 0])
        picked.append(best_score[:, 0])
        by1, bx1, by2, bx2 = (t.gather(1, best) for t in (y1, x1, y2, x2))
        inter = ((torch.minimum(y2, by2) - torch.maximum(y1, by1)).clamp_min(0)
                 * (torch.minimum(x2, bx2) - torch.maximum(x1, bx1)).clamp_min(0))
        union = area + (by2 - by1).clamp_min(0) * (bx2 - bx1).clamp_min(0) - inter
        iou = torch.where(union > 0, inter / union.clamp_min(1e-12), 0.0)
        weight = torch.where(iou <= iou_thr, torch.exp(-iou * iou / sigma), 0.0)
        decayed = work * weight
        dead = (weight == 0) | (decayed < score_thr) | (lane == best)
        work = torch.where(dead, NEG_INF, decayed)
    idx, sc = torch.stack(picks, 1), torch.stack(picked, 1)
    valid = (sc > score_thr) & (sc > NEG_INF / 2)
    order = torch.sort((~valid).to(torch.int32), dim=1, stable=True).indices
    valid = valid.gather(1, order)
    return (idx.gather(1, order).clamp(0, m - 1), torch.where(valid, sc.gather(1, order), 0.0),
            valid)


def postprocess(cls_maps, box_maps, arch, image_scales) -> Tuple[torch.Tensor, ...]:
    """Per-level [T, B, C, H, W] maps → the packed tuple (boxes ⊕ σ_al ⊕
    σ_mc [B, K, 12], scores [B, K], classes ⊕ σ_cls [B, K, 1 + C],
    valid_len [B], logits [B, K, C])."""
    a, c = num_anchors(arch), arch["num_classes"]
    t, b = cls_maps[0].shape[:2]
    # positions r over the levels (rows of h, w); class channel a·C + c
    logits = torch.cat([m.reshape(t, b, a * c, -1) for m in cls_maps], -1)
    mean = logits.mean(0)
    std = torch.sqrt(((logits - mean) ** 2).mean(0))
    r = mean.shape[-1]
    mean_acr, std_acr = mean.reshape(b, a, c, r), std.reshape(b, a, c, r)
    score_logit, cls = mean_acr.max(2)                          # [B, A, R]
    flat = score_logit.reshape(b, a * r)                        # candidate n = a·R + r
    if arch["max_nms_inputs"] >= a * r:
        sel = torch.arange(a * r, device=flat.device).expand(b, -1)
        top = flat
    else:
        top, sel = torch.sort(flat, dim=1, descending=True, stable=True)
        top, sel = top[:, :arch["max_nms_inputs"]], sel[:, :arch["max_nms_inputs"]]
    pos, anc = sel % r, sel // r
    bi = torch.arange(b, device=flat.device)[:, None]

    halves = 2 if arch["loss_attenuation"] else 1
    # box channel s·4A + a·4 + k: half s (mean, std), anchor a, coordinate k
    box = torch.cat([m.reshape(t, b, halves, a, 4, -1) for m in box_maps], -1)
    box = box[:, bi, :, anc, :, pos].permute(2, 0, 1, 3, 4)    # [T, B, M, S, 4]
    anchor = anchors(arch, flat.device)[pos * a + anc]          # [B, M, 4]
    yc_a, xc_a = (anchor[..., 0] + anchor[..., 2]) / 2, (anchor[..., 1] + anchor[..., 3]) / 2
    ha, wa = anchor[..., 2] - anchor[..., 0], anchor[..., 3] - anchor[..., 1]
    ty, tx, th, tw = box[..., 0, :].unbind(-1)                  # [T, B, M]
    if halves == 2:
        dty, dtx, dth, dtw = (box[..., 1, :] ** 2).unbind(-1)
    else:
        dty = dtx = dth = dtw = torch.zeros_like(ty)
    # l-norm: centres affine in normal (ty, tx), sizes log-normal
    w = torch.exp(tw + dtw / 2) * wa
    h = torch.exp(th + dth / 2) * ha
    yc, xc = ty * ha + yc_a, tx * wa + xc_a
    dw = (torch.exp(dtw) - 1) * torch.exp(2 * tw + dtw) * wa ** 2
    dh = (torch.exp(dth) - 1) * torch.exp(2 * th + dth) * ha ** 2
    dyc, dxc = dty * ha ** 2, dtx * wa ** 2
    corners = torch.stack([yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2], -1)
    var = torch.stack([dyc + dh / 4, dxc + dw / 4, dyc + dh / 4, dxc + dw / 4], -1)
    boxes = corners.mean(0)
    sigma_mc = torch.sqrt(((corners - boxes) ** 2).mean(0))
    sigma_al = torch.sqrt(var.clamp_min(0)).mean(0)
    scores = torch.sigmoid(top)
    classes = cls[bi, anc, pos]                                 # [B, M]
    sigma_cls = std_acr[bi, anc, :, pos]                        # [B, M, C]
    cand_logits = mean_acr[bi, anc, :, pos]

    picks, kept, valid = soft_nms(boxes, scores, arch)
    hh, ww = arch["image_size"]
    limit = torch.tensor([hh, ww, hh, ww], dtype=torch.float32, device=flat.device)
    s = image_scales.to(torch.float32)[:, None, None]
    vm = valid[..., None].to(torch.float32)

    def g(x):                                                   # [B, M, ..] at the picks
        return x[bi, picks]

    out_boxes = torch.minimum(g(boxes).clamp_min(0), limit) * s * vm
    packed = (torch.cat([out_boxes, g(sigma_al) * s * vm, g(sigma_mc) * s * vm], -1),
              kept,
              torch.cat([((g(classes) + 1).to(torch.float32) * vm[..., 0])[..., None],
                         g(sigma_cls) * vm], -1),
              valid.sum(1).to(torch.int32))
    if arch["enable_softmax"]:
        packed += (g(cand_logits),)
    return packed


def serve(images, image_scales, p, arch, precision="f32", masks=None) -> Tuple[torch.Tensor, ...]:
    """Normalised NHWC images → the packed tuple, MC samples from ``masks``
    (the served keep bits in draw order)."""
    ar = Arith(precision)
    device = images.device
    cls, box = network(ar.q(images), p, arch, ar,
                       None if masks is None else Masks(masks, device))
    return postprocess(cls, box, arch, image_scales)


class RandomMasks(Masks):
    """Fresh keep bits from a generator (the calibration pass's dropout)."""

    def __init__(self, generator: torch.Generator, device):
        self.generator, self.device = generator, device

    def take(self, n: int, c: int, rate: float) -> torch.Tensor:
        bits = torch.rand((n, c), generator=self.generator, device=self.device) < 1.0 - rate
        return bits.to(torch.float32)[:, :, None, None] / (1.0 - rate)

    def done(self) -> None:
        pass


def calibrate(images, p, arch, generator: torch.Generator,
              stored: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """``p`` with every BatchNorm's running statistics set from its input
    over normalised NHWC ``images`` with MC dropout on (one pass of the T
    samples, layer by layer, masks from ``generator``), so that every layer
    of the random network sees unit-scale inputs, as in a trained one, the
    samples' spread included; and each head's predict conv scaled so that
    its outputs spread about their bias by ``arch["output_std"]`` (a
    trained detector's class logits and box deltas, not a random network's
    exponent-sized tails). Every weight is kept as the ``stored`` type holds
    it, the statistics included, and each layer is calibrated on what the
    layers before it compute with those values: a network calibrated in f32
    and rounded after is no longer calibrated, and amplifies the rounding."""
    ar = Arith(calibrate=True, stored=stored)
    p = {k: ar.store(v) for k, v in p.items()}
    network(images, p, arch, ar, RandomMasks(generator, images.device))
    return p


def run(fn, *args, **kwargs):
    """``fn`` with TF32 off for matmuls and cuDNN, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return fn(*args, **kwargs)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
