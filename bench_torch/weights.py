"""Random weights of a configuration, made on the device from the run's seed.

Backbone, squeeze-excite and BiFPN convs normal with variance 2 / fan_in
(flax's variance_scaling(2, fan_out) the JAX package draws shrinks a
depthwise layer's output by its channel count, and the random network
collapses to its biases); the head towers' separable convs and the
resampling 1x1 convs truncated normal with variance 1 / fan_in, as flax
draws them; biases 0 and the class bias the focal prior; BatchNorm β = 0,
mean 0, var 1 and γ = ``arch["bn_gamma"]`` (below 1, so that each
activation works near its linear part: a random network at γ = 1
amplifies a rounding of its activations two to three times more); the
fusion edge weights 1. All draws are two calls on one ``torch.Generator``
on the device, over one flat buffer that the leaves are views of.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench_torch.reference import CLASS_PRIOR_BIAS, param_shapes

# flax's truncated normal: cut at ±2 std, rescaled to unit variance
TRUNC_STD = 0.87962566103423978


def _rule(name: str, shape, gamma: float) -> tuple:
    """(kind, std or value) of one leaf: kind is "normal", "trunc" or "const"."""
    leaf = name.rsplit(".", 1)[1]
    if leaf in ("running_mean", "bias"):
        if "-predict." in name and name.startswith("class_net."):
            return "const", CLASS_PRIOR_BIAS
        return "const", 0.0
    if leaf == "weight" and len(shape) == 1:       # a BatchNorm's scale
        return "const", gamma
    if leaf in ("running_var", "edge_weights") or len(shape) == 1:
        return "const", 1.0
    receptive = shape[2] * shape[3]
    head = name.startswith(("class_net.", "box_net."))
    if head and (".depthwise." in name or ".pointwise." in name):
        return "trunc", math.sqrt(1.0 / (shape[1] * receptive)) / TRUNC_STD
    if ".conv1x1." in name:
        return "trunc", math.sqrt(1.0 / (shape[1] * receptive)) / TRUNC_STD
    return "normal", math.sqrt(2.0 / (shape[1] * receptive))


def make(arch, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The state dict of ``arch`` (``reference.param_shapes``'s names), in
    ``dtype`` on ``device``, from ``seed``."""
    shapes = param_shapes(arch)
    rules = {n: _rule(n, s, arch["bn_gamma"]) for n, s in shapes.items()}
    sizes = {n: math.prod(s) for n, s in shapes.items()}
    normal = [n for n in shapes if rules[n][0] == "normal"]
    trunc = [n for n in shapes if rules[n][0] == "trunc"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for names, draw in ((normal, lambda t: t.normal_(generator=gen)),
                        (trunc, lambda t: torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                                                      generator=gen))):
        counts = [sizes[n] for n in names]
        flat = draw(torch.empty(sum(counts), device=device))
        std = torch.tensor([rules[n][1] for n in names], device=device)
        flat = flat * torch.repeat_interleave(std, torch.tensor(counts, device=device))
        for n, part in zip(names, torch.split(flat, counts)):
            out[n] = part.view(shapes[n]).to(dtype)
    for n, (kind, value) in rules.items():
        if kind == "const":
            out[n] = torch.full(shapes[n], value, device=device, dtype=dtype)
    return {n: out[n] for n in shapes}
