"""A closed loop of ``train.train_lib.train_step``: the KITTI training step.

Set-up: a pool of host uint8 frames at the network's size with 1 to
``mix["boxes"][1]`` groundtruth boxes each (``train_pool``, from the seed),
the weights of ``weights.make`` calibrated by the reference on the pool's
first frames (kept in f32, as training keeps them; the box head's σ half
starting at ``SIGMA_START`` with a spread of ``SIGMA_SPREAD``), and the
program's state from ``create_train_state`` over them: SGD with momentum, the
warm-up and cosine schedule of the KITTI runner (batch 8, 500 epochs of
748 steps, ``reference_train.RUNNER``), global clipping at 10, bf16 mixed
precision from the configuration. A call is one ``train_step`` of a pool
batch, its targets assigned on the card by ``prepare_batch``, its loss and
parts brought to the host; no validation and no checkpoint. A kept call
snapshots the weights and momentum before its step and the weights after,
on the host, and records the step's dropout draws (``serving.KeptMasks``).

The check runs ``reference_train.step`` from each kept call's snapshot with
its draws and gives two numbers, the largest over the kept steps:
``update_gap``, ‖w − wref‖ ÷ ‖wref − w₀ + lr · 0.9 · m₀‖ over every
parameter, w the weights after the step, w₀ and m₀ the weights and the
momentum before it: the gap of the updates over the reference step's own
part of its update, −lr · its clipped gradient, so that the momentum both
sides carry over does not dilute a fault in the step's gradient (a step
that applies the momentum alone reads 1), and ``loss_gap``, the largest
relative gap of the loss and its parts (the cell's file says which carry
a limit).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bench_torch import flops, weights
from bench_torch import reference as R
from bench_torch import reference_train as RT
from bench_torch import traffic
from bench_torch.serving import CALIBRATION_FRAMES, KeptMasks

END_TO_END = {"img_per_s": "img/s", "peak_mem_gib": "GiB", "setup_s": "s"}
# Where the box head's σ half starts. Calibrated as the serve's weights are,
# σ spreads about 0 by 0.1 and half of it sits at the loss's clip of 0.01:
# 1/σ² = 1e4 makes every tensor's gradient pass the clip of 10, so the
# update is each tensor's gradient direction alone, which bf16 rounding
# turns about at random (a bf16 reference step lies 0.7-1.2 from the f32
# one, as far as an unrelated update). At σ = 1 the loss weighs each
# positive's squared error once, the gradients stay inside the clip, and
# rounding moves the update by what it moves the gradients.
SIGMA_BIAS_LEAF, SIGMA_START = "box_net.box-predict.pointwise.bias", 1.0
# and how far it spreads about that start over the anchors: the steps lower
# σ toward the boxes' errors, and an anchor whose σ nears the clip gives one
# gradient that outweighs the rest (a step up to 10x the others, which
# rounding turns as above); at a spread of 0.01 no anchor comes near it
SIGMA_WEIGHT_LEAF, SIGMA_SPREAD = "box_net.box-predict.pointwise.weight", 0.01


def train_pool(mix: Dict, seed: int):
    """``pool_batches`` batches of (uint8 frames [B, H, W, 3], boxes [B, M,
    4] y1x1y2x2 in pixels, classes [B, M]), M = ``mix["boxes"][1]``: each
    image 1 to M boxes of 16 to 256 pixels a side (at most half the frame's
    side) inside the frame, classes 1..``classes``, padded rows zero."""
    frames = traffic.frame_pool(mix, seed)
    rng = np.random.default_rng([seed, 1])
    h, w = mix["frame_hw"]
    lo, hi = mix["boxes"]
    out = []
    for f in frames:
        b = f.shape[0]
        boxes = np.zeros((b, hi, 4), np.float32)
        classes = np.zeros((b, hi), np.int32)
        for i in range(b):
            n = int(rng.integers(lo, hi + 1))
            size = rng.uniform(16, min(256, h // 2, w // 2), (n, 2))
            y = rng.uniform(0, h - size[:, 0])
            x = rng.uniform(0, w - size[:, 1])
            boxes[i, :n] = np.stack([y, x, y + size[:, 0], x + size[:, 1]], -1)
            classes[i, :n] = rng.integers(1, mix["classes"] + 1, n)
        out.append((f, torch.from_numpy(boxes), torch.from_numpy(classes)))
    return out


def import_dynamo() -> None:
    """Import ``torch._dynamo`` (which torch.optim's first optimizer
    imports) with ``bench_torch/`` off ``sys.path``: ``python3
    bench_torch/run.py`` puts that directory first there, and its
    ``profile.py`` would stand in for the standard library's, which
    ``cProfile`` imports."""
    here = Path(__file__).resolve().parents[1]
    saved = list(sys.path)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    try:
        import torch._dynamo  # noqa: F401
    finally:
        sys.path[:] = saved


class Entry:
    kind = "train"
    end_to_end = END_TO_END

    def __init__(self, config: Dict, mix: Dict, seeds: Sequence[int], device,
                 overrides: Optional[Dict] = None):
        from udal_tpu_torch.config import get_detection_config
        from udal_tpu_torch.train import train_lib

        self.device = torch.device(device)
        self.arch = dict(config["arch"], **(overrides or {}).get("arch", {}))
        self.items = mix["batch"]
        self.pool = train_pool(dict(mix, classes=self.arch["num_classes"]), seeds[0])
        self.config = get_detection_config(config["model_name"])
        self.config.override(dict(config["overrides"], batch_size=self.items,
                                  num_epochs=RT.RUNNER["num_epochs"],
                                  **(overrides or {}).get("program", {})),
                             allow_new_keys=True)
        self.steps_per_epoch = RT.RUNNER["steps_per_epoch"]
        t = time.perf_counter()
        p = weights.make(self.arch, seeds[1], self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds[2])
        images = R.normalise(self.pool[0][0][:CALIBRATION_FRAMES].to(self.device), self.arch)
        c = time.perf_counter()
        p = R.run(R.calibrate, images, p, self.arch, gen)
        if self.arch["loss_attenuation"]:
            half = p[SIGMA_BIAS_LEAF].shape[0] // 2
            p[SIGMA_BIAS_LEAF][half:] = SIGMA_START
            p[SIGMA_WEIGHT_LEAF][half:] *= SIGMA_SPREAD / self.arch["output_std"]["box"]
        calibrate_s = time.perf_counter() - c
        self.setup_times = dict(weights_s=time.perf_counter() - t - calibrate_s,
                                calibrate_s=calibrate_s)
        t = time.perf_counter()
        import_dynamo()
        self.state, self.schedule = train_lib.create_train_state(
            self.config, self.steps_per_epoch, device=self.device, state_dict=p)
        self.setup_times["state_s"] = time.perf_counter() - t
        del p, images
        self.seed = seeds[3]
        self.kept: Dict[int, Dict] = {}

    # -- the program -------------------------------------------------------------

    def _snapshot(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().to("cpu", copy=True)
                for n, p in self.state.model.named_parameters()}

    def _momentum(self) -> Optional[Dict[str, torch.Tensor]]:
        opt = self.state.optimizer
        bufs = {n: opt.state.get(p, {}).get("momentum_buffer")
                for n, p in self.state.model.named_parameters()}
        if all(b is None for b in bufs.values()):
            return None
        return {n: None if b is None else b.to("cpu", copy=True) for n, b in bufs.items()}

    def call(self, i: int, keep: bool = False) -> Dict[str, float]:
        """One training step on pool batch ``i``; its loss and parts on the host."""
        from udal_tpu_torch.models.efficientnet import ChannelDropout
        from udal_tpu_torch.train import train_lib

        frames, boxes, classes = self.pool[i % len(self.pool)]
        step = self.state.step
        masks = KeptMasks(ChannelDropout(train_lib.step_generator(self.seed, step,
                                                                  self.device)))
        if keep:
            before, momentum = self._snapshot(), self._momentum()
            masks.keep = []
        _, vals = train_lib.train_step(self.config, self.schedule, self.steps_per_epoch,
                                       self.state, frames,
                                       dict(gt_boxes=boxes, gt_classes=classes),
                                       seed=self.seed, masks=masks)
        names = list(vals)
        host = torch.stack([vals[k].detach().float().reshape(()).to(self.device)
                            for k in names]).cpu()
        out = dict(zip(names, host.tolist()))
        if keep:
            self.kept[i] = dict(step=step, before=before, momentum=momentum,
                                after=self._snapshot(),
                                masks=[m.to("cpu") for m in masks.keep])
        return out

    def counters(self) -> Dict[str, int]:
        return {}

    def release(self) -> None:
        del self.state

    # -- the yardstick -------------------------------------------------------------

    def flops_per_call(self) -> float:
        """Forward and backward (3 × the forward's FLOPs) of the batch."""
        return 3.0 * self.items * flops.image_flops(self.arch, 1)

    def expand_launches(self) -> List:
        return []

    def expand_bound_s(self) -> float:
        return 0.0

    def reference_step(self, i: int, precision: str = "f32", rows: Optional[int] = None):
        """Kept call ``i``'s step by ``reference_train`` at ``precision``:
        its loss parts and the weights after it (host tensors). With
        ``rows``, a faulty step for the readings: the batch's first
        ``rows`` images alone, at the whole batch's rate."""
        k = self.kept[i]
        frames, boxes, classes = self.pool[i % len(self.pool)]
        dev, take = self.device, slice(rows)
        momentum = (None if k["momentum"] is None else
                    {n: None if v is None else v.to(dev) for n, v in k["momentum"].items()})
        parts, after = RT.run(RT.step, self.arch, {n: v.to(dev) for n, v in k["before"].items()},
                              momentum, frames[take].to(dev), boxes[take].to(dev),
                              classes[take].to(dev), [m[take].to(dev) for m in k["masks"]],
                              k["step"], precision, batch_size=self.items)
        return parts, {n: v.cpu() for n, v in after.items()}

    def gaps(self, i: int, parts: Dict[str, float], after: Dict[str, torch.Tensor],
             ref) -> Dict[str, float]:
        """The two compared numbers of a step of kept call ``i`` that gave
        loss ``parts`` and weights ``after``, against ``ref``, a
        ``reference_step`` of it."""
        ref_parts, ref_after = ref
        k = self.kept[i]
        carried = RT.learning_rate(k["step"], self.items) * RT.HPARAMS["momentum"]
        momentum = k["momentum"] or {}
        loss_gap = max(abs(parts[n] - ref_parts[n]) / max(abs(ref_parts[n]), 1e-12)
                       for n in RT.LOSS_PARTS)
        diff = moved = 0.0
        for n, want in ref_after.items():
            start = k["before"][n].double()       # w₀ − lr · 0.9 · m₀: the momentum's part
            if momentum.get(n) is not None:
                start = start - carried * momentum[n].double()
            diff += float((after[n].double() - want.double()).pow(2).sum())
            moved += float((want.double() - start).pow(2).sum())
        update_gap = (diff / moved) ** 0.5 if moved > 0 else float("inf")
        finite = lambda x: x if x == x and abs(x) != float("inf") else float("inf")  # noqa: E731
        return dict(loss_gap=finite(loss_gap), update_gap=finite(update_gap))

    def check(self, kept: Dict[int, Dict[str, float]]) -> Dict[str, float]:
        """The largest of each compared number over the kept steps."""
        rows = [self.gaps(i, out, self.kept[i]["after"], self.reference_step(i))
                for i, out in kept.items()]
        return {n: max(r[n] for r in rows) for n in ("loss_gap", "update_gap")}
