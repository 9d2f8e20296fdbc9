"""What the serve entries share: set-up, the closed-loop call, the check.

Set-up makes the frame pool from the seed, the weights on the device from
the seed (``weights.make``, BatchNorm statistics and the predict convs'
scale calibrated by the reference on the pool's first frames, each value
rounded to the configuration's dtype as it is set, so that program and
reference hold the same values), and the
program's ``ServingDriver`` over them (the calibration is the
reference's work, timed apart as ``calibrate_s``); the driver's MC-dropout source is
wrapped so that the draws of the calls the check compares are kept. A
call serves one batch of the pool and brings the packed tuple to the host.
The check serves the same frames through the plain reference with the
kept masks, in f32 and in bf16 (the witness), and compares the packed
tuples (``compare.py``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bench_torch import compare, flops, roofline, traffic, weights
from bench_torch import reference as R

# frames of the pool's first batch the weights are calibrated on
CALIBRATION_FRAMES = 2
END_TO_END = {"img_per_s": "img/s", "batch_ms_p95": "ms", "peak_mem_gib": "GiB",
              "setup_s": "s"}


class KeptMasks:
    """The program's mask source, passed through; while ``keep`` is a
    list, each draw is appended to it as well."""

    def __init__(self, source):
        self.source = source
        self.keep: Optional[List[torch.Tensor]] = None

    def draw(self, n, c, keep, device):
        bits = self.source.draw(n, c, keep, device)
        if self.keep is not None:
            self.keep.append(bits)
        return bits


class ServeEntry:
    """A closed loop over one serve entry of ``ServingDriver``; subclasses
    give the entry (``program_call``) and its reference input
    (``reference_input``)."""

    kind = "serve"
    end_to_end = END_TO_END

    def __init__(self, config: Dict, mix: Dict, seeds: Sequence[int], device,
                 overrides: Optional[Dict] = None):
        from udal_tpu_torch.apps.serving import ServingDriver
        from udal_tpu_torch.config import get_detection_config

        self.device = torch.device(device)
        self.arch = dict(config["arch"], **(overrides or {}).get("arch", {}))
        self.mix = mix
        self.items = mix["batch"]
        self.pool = traffic.frame_pool(mix, seeds[0])
        self.setup_inputs()
        program_config = get_detection_config(config["model_name"])
        program_config.override(dict(config["overrides"],
                                     **(overrides or {}).get("program", {})),
                                 allow_new_keys=True)
        self.samples = int(program_config.mc_dropoutsamp)
        if self.samples != self.arch["mc_samples"]:
            raise ValueError(f"the program serves {self.samples} samples, the "
                             f"configuration file {self.arch['mc_samples']}")
        t = time.perf_counter()
        p = weights.make(self.arch, seeds[1], self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds[2])
        images, _ = self.reference_input(0)
        # the weights in the type they are served in: the reference computes in
        # f32 on the very values the program holds
        served = getattr(torch, config["dtype"]) if self.device.type == "cuda" else torch.float32
        c = time.perf_counter()
        p = R.run(R.calibrate, images[:CALIBRATION_FRAMES], p, self.arch, gen, served)
        self.reference_weights = {k: v.to("cpu") for k, v in p.items()}   # synchronises
        # the reference's pass and its copy: the harness leaves them out of setup_s
        calibrate_s = time.perf_counter() - c
        self.setup_times = dict(weights_s=time.perf_counter() - t - calibrate_s,
                                calibrate_s=calibrate_s)
        t = time.perf_counter()
        self.driver = ServingDriver(program_config, p, self.items, device=self.device,
                                    mc_seed=seeds[3])
        self.setup_times["driver_s"] = time.perf_counter() - t
        del p, images
        self.masks = KeptMasks(self.driver.masks)
        self.driver.masks = self.masks
        self.kept_masks: Dict[int, List[torch.Tensor]] = {}

    def setup_inputs(self) -> None:
        """What the entry's calls take beside the frames (none here)."""

    # -- the program -------------------------------------------------------------

    def program_call(self, frames: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def call(self, i: int, keep: bool = False) -> Tuple[torch.Tensor, ...]:
        """Serve pool batch ``i``; the packed tuple on the host."""
        if keep:
            self.masks.keep = []
        out = tuple(t.cpu() for t in self.program_call(self.pool[i % len(self.pool)]))
        if keep:
            self.kept_masks[i], self.masks.keep = self.masks.keep, None
        return out

    def counters(self) -> Dict[str, int]:
        """The program's kernel launch counters."""
        from udal_tpu_torch.ops import cuda_nms, fused_dw, fused_mbconv
        return dict(fused_dw=fused_dw.launches, fused_expand_dw=fused_mbconv.launches,
                    soft_nms=cuda_nms.launches)

    def release(self) -> None:
        del self.driver
        self.masks.source = None

    # -- the yardstick --------------------------------------------------------------

    def reference_input(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pool batch ``i`` as the reference's normalised NHWC images on the
        device, and each image's scale back to its frame."""
        raise NotImplementedError

    def flops_per_call(self) -> float:
        return self.items * flops.image_flops(self.arch, self.samples)

    def expand_launches(self) -> List[Tuple[int, ...]]:
        """(n, cin, ce, h, w, k, s) of each fused expand + depthwise launch a
        call makes: the backbone's expanding blocks at T·B where the
        backbone drops out, at B where it does not."""
        n = self.items * (self.samples if self.arch["mc_backbone_rate"] > 0 else 1)
        h, w = [-(-x // 2) for x in self.arch["image_size"]]
        out, cin = [], self.arch["stem_filters"]
        for b in R.blocks(self.arch):
            if b["e"] != 1:
                out.append((n, cin, b["cin"] * b["e"], h, w, b["k"], b["s"]))
            h, w, cin = -(-h // b["s"]), -(-w // b["s"]), b["cout"]
        return out

    def expand_bound_s(self) -> float:
        return sum(roofline.expand_bound(*shape)[0] for shape in self.expand_launches()) / 1e3

    def check(self, kept: Dict[int, Tuple[torch.Tensor, ...]]) -> Dict[str, float]:
        """The compared numbers (``compare.compared``) over the kept calls'
        images: each call against the reference's serve of the same frames
        with the same masks, beside the bf16 witness's serve."""
        served, witness = [], []
        for i, out in kept.items():
            ref, wit = self.reference_serves(i, ("f32", "bf16"))
            served += compare.batch_numbers(out, ref)
            witness += compare.batch_numbers(wit, ref)
        return compare.compared(compare.aggregate(served), compare.aggregate(witness))

    def reference_serves(self, i: int, precisions: Sequence[str]) -> List[Tuple[torch.Tensor, ...]]:
        """Kept call ``i``'s frames served by the reference at each
        precision, with the masks the program drew; host tensors."""
        p = {k: v.to(self.device) for k, v in self.reference_weights.items()}
        images, scales = self.reference_input(i)
        return [tuple(t.cpu() for t in R.run(R.serve, images, scales, p, self.arch, precision,
                                             masks=self.kept_masks[i]))
                for precision in precisions]
