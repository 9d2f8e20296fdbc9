"""``ServingDriver.serve_detections_preprocessed_uint8`` with the
device-resize reader's warp arguments: native-size host uint8 frames,
warped onto the canvas, normalised and zeroed past ``valid_hw`` on the
card; the packed tuple back on the host (the repo's auto-labeling path)."""

from __future__ import annotations

from bench_torch import reference as R
from bench_torch import traffic
from bench_torch.serving import ServeEntry


class Entry(ServeEntry):
    def setup_inputs(self):
        self.warp = traffic.warp_args(self.mix, self.arch["image_size"])

    def program_call(self, frames):
        return self.driver.serve_detections_preprocessed_uint8(frames, **self.warp).packed()

    def reference_input(self, i):
        frames = self.pool[i % len(self.pool)].to(self.device)
        w = {k: v.to(self.device) for k, v in self.warp.items()}
        warped = R.warp(frames, w["warp_scale"], w["warp_offset"], self.arch["image_size"])
        return R.normalise(warped, self.arch, w["valid_hw"]), w["image_scales"]
