"""``ServingDriver.serve``: host uint8 frames at the network's size, the
packed tuple back on the host (the main path, ``bench.py``'s operating
point). The frames are normalised on the card and served as they are."""

from __future__ import annotations

from bench_torch import reference as R
from bench_torch.serving import ServeEntry

import torch


class Entry(ServeEntry):
    def program_call(self, frames):
        return self.driver.serve(frames)

    def reference_input(self, i):
        frames = self.pool[i % len(self.pool)].to(self.device)
        if list(frames.shape[1:3]) != list(self.arch["image_size"]):
            raise ValueError("serve_uint8 takes frames at the network's size")
        return (R.normalise(frames, self.arch),
                torch.ones(frames.shape[0], device=self.device))
