"""``ServingDriver.serve`` of a deep ensemble (``ensemble=True``): host
uint8 frames at the network's size, normalised on the card, each member's
deterministic forward in turn, the members' outputs stacked and reduced
by the post-processing; the packed tuple back on the host.

Set-up: the frame pool from the seed; for each of the configuration's
``members`` N, the weights of ``weights.make`` from a sub-seed of its own
(``harness.seeds_from(seeds[1], N)``), calibrated alone by the reference
on the pool's first frames and rounded to the served dtype
(``reference_ens.calibrate``); the program's ``ServingDriver`` over the
members stacked (``models.ensemble.stack_variables``). No layer drops
out, so the serve draws no masks and none is kept. The check serves the
kept calls' frames through ``reference_ens`` in f32 and in bf16 (the
witness) and compares the packed tuples (``compare.py``).
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import torch

from bench_torch import flops, harness, traffic, weights
from bench_torch import reference as R
from bench_torch import reference_ens as RE
from bench_torch.serving import CALIBRATION_FRAMES, ServeEntry


class Entry(ServeEntry):
    def __init__(self, config, mix, seeds, device, overrides=None):
        from udal_tpu_torch.apps.serving import ServingDriver
        from udal_tpu_torch.config import get_detection_config
        from udal_tpu_torch.models.ensemble import stack_variables

        overrides = overrides or {}
        self.device = torch.device(device)
        self.arch = dict(config["arch"], **overrides.get("arch", {}))
        self.members = int(overrides.get("members", config["members"]))
        if self.arch["mc_backbone_rate"] > 0 or self.arch["mc_head_rate"] > 0:
            raise ValueError("an ensemble's members serve without dropout")
        self.mix = mix
        self.items = mix["batch"]
        self.samples = 1                        # passes of one member a frame
        self.pool = traffic.frame_pool(mix, seeds[0])
        program_config = get_detection_config(config["model_name"])
        program_config.override(dict(config["overrides"], **overrides.get("program", {})),
                                allow_new_keys=True)
        self.program_config = program_config
        t = time.perf_counter()
        images, _ = self.reference_input(0)
        served = getattr(torch, config["dtype"]) if self.device.type == "cuda" else torch.float32
        members, calibrate_s = [], 0.0
        for i, seed in enumerate(harness.seeds_from(seeds[1], self.members)):
            p = weights.make(self.arch, seed, self.device)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seeds[2] + i)
            c = time.perf_counter()
            p = RE.run(RE.calibrate, images[:CALIBRATION_FRAMES], p, self.arch, gen, served)
            members.append({k: v.to("cpu") for k, v in p.items()})      # synchronises
            calibrate_s += time.perf_counter() - c
        self.reference_weights = members
        self.setup_times = dict(weights_s=time.perf_counter() - t - calibrate_s,
                                calibrate_s=calibrate_s)
        t = time.perf_counter()
        self.driver = ServingDriver(program_config, stack_variables(members), self.items,
                                    device=self.device, mc_seed=seeds[3], ensemble=True)
        self.setup_times["driver_s"] = time.perf_counter() - t
        if self.driver.num_members != self.members:
            raise ValueError(f"the program serves {self.driver.num_members} members, the "
                             f"configuration file {self.members}")
        del images

    def call(self, i: int, keep: bool = False) -> Tuple[torch.Tensor, ...]:
        """Serve pool batch ``i``; the packed tuple on the host."""
        return tuple(t.cpu() for t in self.driver.serve(self.pool[i % len(self.pool)]))

    def release(self) -> None:
        del self.driver

    def reference_input(self, i):
        frames = self.pool[i % len(self.pool)].to(self.device)
        if list(frames.shape[1:3]) != list(self.arch["image_size"]):
            raise ValueError("serve_uint8_ens takes frames at the network's size")
        return (R.normalise(frames, self.arch),
                torch.ones(frames.shape[0], device=self.device))

    def flops_per_call(self) -> float:
        return self.items * self.members * flops.image_flops(self.arch, 1)

    def expand_launches(self) -> List[Tuple[int, ...]]:
        """Each member's launches at B, member after member."""
        return super().expand_launches() * self.members

    def reference_serves(self, i: int, precisions: Sequence[str]):
        members = [{k: v.to(self.device) for k, v in p.items()}
                   for p in self.reference_weights]
        images, scales = self.reference_input(i)
        return [tuple(t.cpu() for t in RE.run(RE.serve, images, scales, members, self.arch,
                                              precision))
                for precision in precisions]
