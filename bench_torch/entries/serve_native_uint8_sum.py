"""``serve_native_uint8`` for a model whose BiFPN fuses by a plain sum
(``reference_sum.py``): ``ServingDriver.serve_detections_preprocessed_uint8``
of native-size host uint8 frames warped onto the canvas on the card, the
packed tuple back on the host. ``ServeEntry``'s set-up, with the weights
of ``weights.make`` less the ``edge_weights`` leaves (constants, so the
random draws are the same), calibrated by ``reference_sum``, and the check
served by ``reference_sum``."""

from __future__ import annotations

import time

import torch

from bench_torch import reference as R
from bench_torch import reference_sum as RS
from bench_torch import traffic, weights
from bench_torch.serving import CALIBRATION_FRAMES, KeptMasks, ServeEntry


class Entry(ServeEntry):
    def __init__(self, config, mix, seeds, device, overrides=None):
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
        if program_config.fpn_weight_method != "sum":
            raise ValueError(f"this entry serves sum fusion, the program's configuration "
                             f"fuses by {program_config.fpn_weight_method!r}")
        self.samples = int(program_config.mc_dropoutsamp)
        if self.samples != self.arch["mc_samples"]:
            raise ValueError(f"the program serves {self.samples} samples, the "
                             f"configuration file {self.arch['mc_samples']}")
        t = time.perf_counter()
        shapes = RS.param_shapes(self.arch)
        p = {k: v for k, v in weights.make(self.arch, seeds[1], self.device).items()
             if k in shapes}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds[2])
        images, _ = self.reference_input(0)
        served = getattr(torch, config["dtype"]) if self.device.type == "cuda" else torch.float32
        c = time.perf_counter()
        p = RS.run(RS.calibrate, images[:CALIBRATION_FRAMES], p, self.arch, gen, served)
        self.reference_weights = {k: v.to("cpu") for k, v in p.items()}   # synchronises
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
        self.kept_masks = {}

    def setup_inputs(self):
        self.warp = traffic.warp_args(self.mix, self.arch["image_size"])

    def program_call(self, frames):
        return self.driver.serve_detections_preprocessed_uint8(frames, **self.warp).packed()

    def reference_input(self, i):
        frames = self.pool[i % len(self.pool)].to(self.device)
        w = {k: v.to(self.device) for k, v in self.warp.items()}
        warped = R.warp(frames, w["warp_scale"], w["warp_offset"], self.arch["image_size"])
        return R.normalise(warped, self.arch, w["valid_hw"]), w["image_scales"]

    def reference_serves(self, i, precisions):
        p = {k: v.to(self.device) for k, v in self.reference_weights.items()}
        images, scales = self.reference_input(i)
        return [tuple(t.cpu() for t in RS.run(RS.serve, images, scales, p, self.arch, precision,
                                              masks=self.kept_masks[i]))
                for precision in precisions]
