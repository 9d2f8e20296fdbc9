"""EfficientNet backbone in PyTorch: port of ``udal_tpu/models/efficientnet.py``.

Same block strings, width/depth rounding, SE layout and MC-dropout hooks
(channel-wise spatial dropout after the expand and depthwise activations of
every MBConv). The mode is PyTorch's: ``module.train()`` / ``module.eval()``.
In eval mode BatchNorm uses its running statistics; in train mode it
normalises with the batch's and updates the running ones as flax does, and
a residual block drops its branch per sample (stochastic depth) when the
spec sets a survival probability.

Submodules carry the flax scope names (``stem_conv``, ``blocks_3``,
``depthwise_conv``, ``bn1`` ...), so ``convert.py`` maps a flax tree onto
the state dict by renaming. Tensors are NCHW inside; convolutions use TF
"SAME" padding, which is uneven at stride 2.

In eval mode an MBConv's front half (expand, bn0, act, mask, depthwise,
bn1, act, mask and the SE squeeze) is one fused call: ``ops/fused_mbconv.py``
for blocks that expand, ``ops/fused_dw.py`` for those that do not. Each runs
its CUDA kernel on a card and its plain PyTorch version on the CPU. The
kernels take BatchNorm folded into their operands and have no backward, so
train mode runs the unfused chain of the JAX module (cuDNN convolutions and
PyTorch ops, as XLA runs the JAX training program).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from udal_tpu_torch.parallel import collectives
from udal_tpu_torch.parallel.collectives import all_reduce_sum, copy_to_group, gather_replicated

# Standard EfficientNet architecture notation (public, from the paper repos).
DEFAULT_BLOCKS_ARGS = [
    "r1_k3_s11_e1_i32_o16_se0.25", "r2_k3_s22_e6_i16_o24_se0.25",
    "r2_k5_s22_e6_i24_o40_se0.25", "r3_k3_s22_e6_i40_o80_se0.25",
    "r3_k5_s11_e6_i80_o112_se0.25", "r4_k5_s22_e6_i112_o192_se0.25",
    "r1_k3_s11_e6_i192_o320_se0.25",
]

# (width_coefficient, depth_coefficient, resolution, dropout_rate)
EFFICIENTNET_PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    "efficientnet-b8": (2.2, 3.6, 672, 0.5),
    "efficientnet-l2": (4.3, 5.3, 800, 0.5),
}

EFFICIENTNET_LITE_PARAMS = {
    "efficientnet-lite0": (1.0, 1.0, 224, 0.2),
    "efficientnet-lite1": (1.0, 1.1, 240, 0.2),
    "efficientnet-lite2": (1.1, 1.2, 260, 0.3),
    "efficientnet-lite3": (1.2, 1.4, 280, 0.3),
    "efficientnet-lite4": (1.4, 1.8, 300, 0.3),
}


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    kernel_size: int
    num_repeat: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    id_skip: bool
    se_ratio: Optional[float]
    strides: Tuple[int, int]


def decode_block_string(s: str) -> BlockArgs:
    ops = s.split("_")
    options = {}
    for op in ops:
        splits = re.split(r"(\d.*)", op)
        if len(splits) >= 2:
            options[splits[0]] = splits[1]
    return BlockArgs(
        kernel_size=int(options["k"]),
        num_repeat=int(options["r"]),
        input_filters=int(options["i"]),
        output_filters=int(options["o"]),
        expand_ratio=int(options["e"]),
        id_skip="noskip" not in s,
        se_ratio=float(options["se"]) if "se" in options else None,
        strides=(int(options["s"][0]), int(options["s"][1])),
    )


def round_filters(filters: int, width_coefficient: Optional[float],
                  depth_divisor: int = 8, min_depth: Optional[int] = None,
                  skip: bool = False) -> int:
    """Width scaling."""
    if skip or not width_coefficient:
        return filters
    filters *= width_coefficient
    min_depth = min_depth or depth_divisor
    new_filters = max(min_depth,
                      int(filters + depth_divisor / 2) // depth_divisor * depth_divisor)
    if new_filters < 0.9 * filters:
        new_filters += depth_divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: Optional[float],
                  skip: bool = False) -> int:
    if skip or not depth_coefficient:
        return repeats
    return int(math.ceil(depth_coefficient * repeats))


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    """Fully-resolved (scaled) backbone architecture."""
    blocks: Tuple[BlockArgs, ...]
    stem_filters: int
    head_filters: int
    dropout_rate: float
    use_se: bool
    num_classes: int = 1000
    bn_momentum: float = 0.99
    bn_epsilon: float = 1e-3
    survival_prob: Optional[float] = None


def backbone_spec(model_name: str, survival_prob: Optional[float] = None,
                  num_classes: int = 1000) -> BackboneSpec:
    """Resolve a model name to a scaled block list."""
    lite = "lite" in model_name
    table = EFFICIENTNET_LITE_PARAMS if lite else EFFICIENTNET_PARAMS
    width, depth, _, dropout = table[model_name]
    raw = [decode_block_string(s) for s in DEFAULT_BLOCKS_ARGS]
    blocks: List[BlockArgs] = []
    for i, b in enumerate(raw):
        fix = lite and (i == 0 or i == len(raw) - 1)
        blocks.append(dataclasses.replace(
            b,
            input_filters=round_filters(b.input_filters, width),
            output_filters=round_filters(b.output_filters, width),
            num_repeat=round_repeats(b.num_repeat, depth, skip=fix),
        ))
    return BackboneSpec(
        blocks=tuple(blocks),
        stem_filters=round_filters(32, width, skip=lite),
        head_filters=round_filters(1280, width, skip=lite),
        dropout_rate=dropout,
        use_se=not lite,
        num_classes=num_classes,
        survival_prob=survival_prob,
    )


def expand_blocks(spec: BackboneSpec) -> List[BlockArgs]:
    """One BlockArgs per MBConv block: repeats after the first keep the
    output width and stride 1."""
    expanded: List[BlockArgs] = []
    for a in spec.blocks:
        expanded.append(a)
        for _ in range(a.num_repeat - 1):
            expanded.append(dataclasses.replace(
                a, input_filters=a.output_filters, strides=(1, 1)))
    return expanded


def activation_fn(act_type: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if act_type in ("swish", "silu", "swish_native"):
        return F.silu
    if act_type == "relu":
        return F.relu
    if act_type == "relu6":
        return F.relu6
    if act_type == "hswish":
        return F.hardswish
    if act_type == "mish":
        return F.mish
    if act_type == "identity":
        return lambda x: x
    raise ValueError(f"Unsupported act_type {act_type!r}")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """BatchNorm over NCHW with flax's semantics: epsilon 1e-3, scale and
    bias as parameters, the running mean and variance as buffers.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch's, reduced over (N, H, W) in f32 as flax reduces them:
    the mean and the biased variance E[x²] − E[x]², clipped at 0; then it
    moves the running ones toward them, r = momentum·r + (1 − momentum)·batch.
    (``F.batch_norm(training=True)`` would move ``running_var`` toward the
    unbiased variance, n/(n − 1) times larger.) Built in eval mode, as the
    JAX modules default to ``train=False``.

    With a process ``group`` (``parallel.mesh.replicate_state`` sets the
    mesh's data group; ``Mesh.batch_norm_group`` gives grouped moments),
    train mode averages the ranks' means of x and x² (equal shards: the
    whole batch's moments) by an all-reduce that carries autograd, and
    normalises, and moves the running statistics, with them, as the JAX
    package's GSPMD program computes them over the global batch
    (``nn.SyncBatchNorm`` would move ``running_var`` toward the unbiased
    variance again). A group of one computes what no group does."""

    def __init__(self, num_features: int, eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.group = None
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        xf = x.float()
        if self.group is None:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp_min((xf * xf).mean((0, 2, 3)) - mean * mean, 0.0)
        else:       # the ranks' means of x and x² (equal shards), averaged
            means = torch.stack([xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))])
            moments = all_reduce_sum(means, self.group) / collectives.size(self.group)
            mean = moments[0]
            var = torch.clamp_min(moments[1] - mean * mean, 0.0)
        with torch.no_grad():
            for running, batch in ((self.running_mean, mean), (self.running_var, var)):
                running.mul_(self.momentum).add_(batch, alpha=1.0 - self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF "SAME" (low, high) padding: the extra row goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """nn.Conv2d with TF "SAME" padding (explicit and uneven at stride 2). A
    depthwise conv's groups follow its weight's channels: a channel-parallel
    block (``MBConvBlock.tp``) holds a slice of them."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=0, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (ph0, ph1) = same_pads(x.shape[-2], self.kernel_size[0], self.stride[0])
        (pw0, pw1) = same_pads(x.shape[-1], self.kernel_size[1], self.stride[1])
        groups = self.weight.shape[0] if self.groups > 1 else 1
        if ph0 == ph1 and pw0 == pw1:
            return F.conv2d(x, self.weight, self.bias, self.stride, (ph0, pw0), 1, groups)
        return F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), self.weight, self.bias,
                        self.stride, 0, 1, groups)


class ChannelDropout:
    """Source of spatial-dropout masks: one Bernoulli(keep) per (n, c).

    Draws from an explicit ``torch.Generator`` (on the tensors' device). The
    sites call ``draw`` in program order; a test can substitute a source
    that replays recorded masks.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def draw(self, n: int, c: int, keep: float, device) -> torch.Tensor:
        """Keep bits [n, c] (bool)."""
        return torch.rand((n, c), generator=self.generator, device=device) < keep


class ShardedDropout:
    """A mask source for one shard of a global batch: each draw takes the
    masks of all ``count`` shards from ``source`` and keeps shard
    ``index``'s rows, so every rank of a data-parallel step, a sharded serve
    or a sample-parallel serve sees the masks a single process would draw
    for the whole batch. A draw's rows are ``samples`` sample-major blocks
    of the shard's rows (1 for a training step and for the sample axis
    itself, T for an MC serve sharded by image)."""

    def __init__(self, source, index: int, count: int, samples: int = 1):
        self.source, self.index, self.count, self.samples = source, index, count, samples

    def draw(self, n: int, c: int, keep: float, device) -> torch.Tensor:
        bits = self.source.draw(n * self.count, c, keep, device)
        rows = n // self.samples
        return bits.view(self.samples, self.count, rows, c)[:, self.index].reshape(n, c)


def dropout_mask(masks: Optional[ChannelDropout], n: int, c: int, rate: float,
                 device) -> Optional[torch.Tensor]:
    """One site's channel-dropout multiplier [n, c] in f32 (keep bits scaled
    by 1/keep), as the fused kernels take it; None when the rate is 0 or no
    mask source is given (deterministic inference)."""
    if rate <= 0.0 or masks is None:
        return None
    keep = 1.0 - rate
    return masks.draw(n, c, keep, device).to(torch.float32) / keep


def spatial_dropout(x: torch.Tensor, rate: float,
                    masks: Optional[ChannelDropout]) -> torch.Tensor:
    """Channel-wise dropout of NCHW ``x``, scaled by 1/keep; identity when
    the rate is 0 or no mask source is given (deterministic inference)."""
    mask = dropout_mask(masks, x.shape[0], x.shape[1], rate, x.device)
    return x if mask is None else x * mask.to(x.dtype)[:, :, None, None]


def drop_connect(x: torch.Tensor, survival_prob: float,
                 masks: Optional[ChannelDropout]) -> torch.Tensor:
    """Stochastic depth on a residual branch: each sample's NCHW ``x`` kept
    with probability ``survival_prob`` (one [n, 1] draw from ``masks``) and
    scaled by 1/survival_prob; identity without a mask source."""
    if masks is None:
        return x
    keep = masks.draw(x.shape[0], 1, survival_prob, x.device)
    return x / survival_prob * keep.to(x.dtype)[:, :, None, None]


class SqueezeExcite(nn.Module):
    def __init__(self, filters: int, se_filters: int, act: Callable):
        super().__init__()
        self.act = act
        self.reduce = Conv2d(filters, se_filters, 1)
        self.expand = Conv2d(se_filters, filters, 1)

    def forward(self, x: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        """Scale NCHW ``x`` by the excitation of ``pooled`` [N, C], its
        spatial mean (f32 from the fused front half, x's type unfused)."""
        se = pooled.to(x.dtype)[:, :, None, None]
        se = self.expand(self.act(self.reduce(se)))
        return torch.sigmoid(se) * x


def _fold_tensors(fold: Dict) -> List[torch.Tensor]:
    """A fold's tensors in order (``we_split``'s pair flattened)."""
    return [t for v in fold.values() for t in (v if isinstance(v, tuple) else (v,))]


def refold(old: Optional[Dict], new: Optional[Dict]) -> Optional[Dict]:
    """The fold to keep: ``new`` written into the tensors of ``old`` where
    both hold tensors of the same shapes, types and devices under the same
    keys (a captured CUDA graph reads them by address), else ``new``."""
    if old is None or new is None or old.keys() != new.keys():
        return new
    old_t, new_t = _fold_tensors(old), _fold_tensors(new)
    if [(t.shape, t.dtype, t.device) for t in old_t] != \
            [(t.shape, t.dtype, t.device) for t in new_t]:
        return new
    with torch.inference_mode():     # the fold may have been made in inference mode
        for dst, src in zip(old_t, new_t):
            dst.copy_(src)
    return old


class KernelFold:
    """A module whose fused kernel reads operands made from its weights:
    its fold, f32 tensors with inference BatchNorm folded in. ``fold()``
    makes them (None where the module runs no kernel); ``prepare_inference``
    keeps them in ``folded``; ``operands()`` gives the kept fold, or one made
    for the call; entering or leaving train mode drops the fold, since an
    optimizer moves the weights it was made from.
    ``EfficientDetNet.prepare_inference`` and ``drop_folds`` walk every
    module of this type. Listed before ``nn.Module`` among the bases."""

    folded: Optional[Dict[str, torch.Tensor]] = None

    def fold(self) -> Optional[Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def operands(self) -> Dict[str, torch.Tensor]:
        """The fused call's operands: the kept fold, or one made now where
        ``prepare_inference`` made none (a forward after ``drop_folds`` or
        train mode, or of a model never prepared)."""
        if self.folded is not None:
            return self.folded
        with torch.no_grad():
            return self.fold()

    def prepare_inference(self) -> None:
        """Fold once, after the weights are loaded and the module is on its
        device; a later ``load_state_dict`` or ``to`` calls for a new fold.
        A fold of the same shapes is written into the tensors of the one it
        replaces, which a captured CUDA graph reads by address."""
        with torch.no_grad():
            self.folded = refold(self.folded, self.fold())

    def train(self, mode: bool = True):
        if mode or self.training:
            self.folded = None
        return super().train(mode)


class MBConvBlock(KernelFold, nn.Module):
    """Mobile inverted residual bottleneck with optional SE + MC dropout."""

    def __init__(self, block_args: BlockArgs, in_channels: int,
                 act_type: str = "swish", use_se: bool = True,
                 bn_epsilon: float = 1e-3, mc_dropoutrate: float = 0.0,
                 survival_prob: Optional[float] = None, bn_momentum: float = 0.99):
        super().__init__()
        a = block_args
        self.act_type = act_type
        self.act = activation_fn(act_type)
        self.mc_dropoutrate = mc_dropoutrate
        self.survival_prob = survival_prob
        filters = in_channels
        self.expand_conv = self.bn0 = None
        if a.expand_ratio != 1:
            filters = a.input_filters * a.expand_ratio
            self.expand_conv = Conv2d(in_channels, filters, 1, bias=False)
            self.bn0 = BatchNorm(filters, bn_epsilon, bn_momentum)
        # the depthwise conv acts on the actual channel count (a fixed lite
        # stem can differ from the rounded block_args filters)
        self.depthwise_conv = Conv2d(filters, filters, a.kernel_size, a.strides[0],
                                     groups=filters, bias=False)
        self.bn1 = BatchNorm(filters, bn_epsilon, bn_momentum)
        self.se = None
        if use_se and a.se_ratio and 0 < a.se_ratio <= 1:
            self.se = SqueezeExcite(filters, max(1, int(a.input_filters * a.se_ratio)),
                                    activation_fn(act_type))
        self.project_conv = Conv2d(filters, a.output_filters, 1, bias=False)
        self.bn2 = BatchNorm(a.output_filters, bn_epsilon, bn_momentum)
        self.residual = (a.id_skip and all(s == 1 for s in a.strides)
                         and a.input_filters == a.output_filters)
        # (model group, rank in it, its size) when the block's front half
        # runs on a slice of its channels (parallel/tensor_parallel.py)
        self.tp: Optional[Tuple[object, int, int]] = None
        self.eval()

    def fold(self) -> Dict[str, torch.Tensor]:
        """The fused call's f32 operands, inference BatchNorm folded in:
        ``we`` [Cin, Ce] (bn0 scale), ``b0``, ``wd`` [Ce, k, k] (bn1 scale)
        and ``b1`` for a block that expands, with ``we_split``, We^T as bf16
        hi and lo for the tensor-core kernel; the raw ``taps`` [C, k, k] with
        bn1's ``scale`` and ``bias`` for one that does not."""
        from udal_tpu_torch.ops.fused_dw import fold_bn  # ops/fused_dw imports this module
        from udal_tpu_torch.ops.fused_mbconv import split_weights

        bn1 = self.bn1
        s1, b1 = fold_bn(bn1.weight, bn1.bias, bn1.running_mean, bn1.running_var, bn1.eps)
        taps = self.depthwise_conv.weight[:, 0].float()
        if self.expand_conv is None:
            return dict(taps=taps.contiguous(), scale=s1, bias=b1)
        bn0 = self.bn0
        s0, b0 = fold_bn(bn0.weight, bn0.bias, bn0.running_mean, bn0.running_var, bn0.eps)
        we = self.expand_conv.weight[:, :, 0, 0].float() * s0[:, None]
        we = we.t().contiguous()
        return dict(we=we, we_split=split_weights(we), b0=b0,
                    wd=(taps * s1[:, None, None]).contiguous(), b1=b1)

    def forward_unfused(self, x: torch.Tensor,
                        masks: Optional[ChannelDropout] = None) -> torch.Tensor:
        """The JAX module's chain: expand → bn0 → act → dropout → depthwise
        → bn1 → act → dropout → SE → project → bn2 (→ drop_connect →
        residual), BatchNorm as the mode says. Train mode runs it."""
        if self.tp is not None:
            return self._forward_channel_parallel(x, masks)
        inputs = x
        rate = self.mc_dropoutrate
        if self.expand_conv is not None:
            x = spatial_dropout(self.act(self.bn0(self.expand_conv(x))), rate, masks)
        x = spatial_dropout(self.act(self.bn1(self.depthwise_conv(x))), rate, masks)
        if self.se is not None:
            x = self.se(x, x.mean((2, 3)))
        return self._tail(x, inputs, masks)

    def _tail(self, x: torch.Tensor, inputs: torch.Tensor,
              masks: Optional[ChannelDropout]) -> torch.Tensor:
        x = self.bn2(self.project_conv(x))
        if self.residual:
            if self.training and self.survival_prob:
                x = drop_connect(x, self.survival_prob, masks)
            x = x + inputs
        return x

    def _forward_channel_parallel(self, x: torch.Tensor,
                                  masks: Optional[ChannelDropout]) -> torch.Tensor:
        """The unfused chain with the front half on this rank's slice of
        the expanded channels (``self.tp``): expand (or the input's
        channels), bn0, act, dropout, depthwise, bn1, act, dropout and the
        SE squeeze on the slice; the channels and the squeeze gathered
        before the SE and the project conv, which every rank of the group
        runs whole. Each dropout site draws the masks of every channel and
        keeps the slice's columns, so the draws are a single process's."""
        group, index, count = self.tp
        inputs = x
        rate = self.mc_dropoutrate
        c = self.bn1.weight.shape[0]                 # channels on this rank
        cols = slice(index * c, (index + 1) * c)

        def dropout(h):
            m = dropout_mask(masks, h.shape[0], c * count, rate, h.device)
            return h if m is None else h * m[:, cols].to(h.dtype)[:, :, None, None]

        h = copy_to_group(x, group)
        if self.expand_conv is not None:
            h = dropout(self.act(self.bn0(self.expand_conv(h))))
        else:
            h = h[:, cols]
        h = dropout(self.act(self.bn1(self.depthwise_conv(h))))
        pooled = gather_replicated(h.mean((2, 3)), group, 1)
        h = gather_replicated(h, group, 1)
        if self.se is not None:
            h = self.se(h, pooled)
        return self._tail(h, inputs, masks)

    def forward(self, x: torch.Tensor,
                masks: Optional[ChannelDropout] = None) -> torch.Tensor:
        if self.training:
            return self.forward_unfused(x, masks)
        from udal_tpu_torch.ops.fused_dw import fused_depthwise  # (import cycle, see fold)
        from udal_tpu_torch.ops.fused_mbconv import fused_expand_dw

        inputs = x
        x = x.contiguous()
        f = self.operands()
        n, c = x.shape[0], self.bn1.weight.shape[0]
        k, s = self.depthwise_conv.kernel_size[0], self.depthwise_conv.stride[0]
        rate = self.mc_dropoutrate
        if self.expand_conv is not None:
            # the expand site draws, then the depthwise site, as in the unfused order
            m1 = dropout_mask(masks, n, c, rate, x.device)
            m2 = dropout_mask(masks, n, c, rate, x.device)
            x, se_sum = fused_expand_dw(x, f["we"], f["b0"], m1, f["wd"], f["b1"], m2,
                                        s, k, self.act_type, f["we_split"])
            pooled = se_sum / (x.shape[-2] * x.shape[-1])
        else:
            m2 = dropout_mask(masks, n, c, rate, x.device)
            x, pooled = fused_depthwise(x, f["taps"], f["scale"], f["bias"], m2, s,
                                        self.act_type, want_mean=True)
        if self.se is not None:
            x = self.se(x, pooled)
        x = self.bn2(self.project_conv(x))
        if self.residual:
            x = x + inputs
        return x


def block_input_sizes(spec: BackboneSpec, height: int,
                      width: int) -> List[Tuple[BlockArgs, int, int]]:
    """(block args, input rows, input columns) of each MBConv block for a
    stem output of ``height`` x ``width`` (the image at stride 2)."""
    out = []
    for a in expand_blocks(spec):
        out.append((a, height, width))
        height, width = -(-height // a.strides[0]), -(-width // a.strides[0])
    return out


class EfficientNet(nn.Module):
    """EfficientNet feature extractor (no classification head)."""

    def __init__(self, spec: BackboneSpec, act_type: str = "swish",
                 mc_dropoutrate: float = 0.0):
        super().__init__()
        self.act = activation_fn(act_type)
        self.stem_conv = Conv2d(3, spec.stem_filters, 3, 2, bias=False)
        self.stem_bn = BatchNorm(spec.stem_filters, spec.bn_epsilon, spec.bn_momentum)
        self.block_args = expand_blocks(spec)
        n = len(self.block_args)
        # a block ends a reduction when it is the last one or the next
        # block strides; reduction_channels[k-1] is reduction k's width
        self.is_reduction = [i == n - 1 or self.block_args[i + 1].strides[0] > 1
                             for i in range(n)]
        self.reduction_channels: List[int] = []
        channels = spec.stem_filters
        for idx, a in enumerate(self.block_args):
            # stochastic depth: the drop rate grows linearly with the block index
            survival = (1.0 - (1.0 - spec.survival_prob) * idx / n
                        if spec.survival_prob else None)
            self.add_module(f"blocks_{idx}", MBConvBlock(
                a, channels, act_type, spec.use_se, spec.bn_epsilon, mc_dropoutrate,
                survival, spec.bn_momentum))
            channels = a.output_filters
            if self.is_reduction[idx]:
                self.reduction_channels.append(channels)
        self.eval()

    def forward(self, x: torch.Tensor, masks: Optional[ChannelDropout] = None,
                start_block: int = 0) -> List[Optional[torch.Tensor]]:
        """[final features, reduction_1 ... reduction_5] of NCHW ``x``.

        ``start_block > 0`` treats ``x`` as the output of block
        ``start_block - 1`` and skips the stem and earlier blocks (the entry
        of the fast MC path); skipped reductions other than ``x`` itself are
        None.
        """
        if start_block == 0:
            x = self.act(self.stem_bn(self.stem_conv(x)))
        endpoints: List[Optional[torch.Tensor]] = []
        for idx in range(start_block):
            if self.is_reduction[idx]:
                endpoints.append(x if idx == start_block - 1 else None)
        for idx in range(start_block, len(self.block_args)):
            x = getattr(self, f"blocks_{idx}")(x, masks)
            if self.is_reduction[idx]:
                endpoints.append(x)
        return [x] + endpoints
