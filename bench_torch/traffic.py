"""The one generator of the benchmark's traffic, driven by a mix's data file.

A mix (``mixes/<name>.json``) gives the batch, the frame size and how
many distinct batches the pool holds; native frames are warped onto the
configuration's canvas. The frames are uint8 noise made
on the host from the run's seed, as the input reader hands frames to the
serve; the same seed gives the same pool.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def frame_pool(mix: Dict, seed: int) -> List[torch.Tensor]:
    """``pool_batches`` host uint8 batches [batch, h, w, 3]."""
    rng = np.random.default_rng(seed)
    h, w = mix["frame_hw"]
    return [torch.from_numpy(rng.integers(0, 256, (mix["batch"], h, w, 3), dtype=np.uint8))
            for _ in range(mix["pool_batches"])]


def warp_args(mix: Dict, canvas_hw) -> Dict[str, torch.Tensor]:
    """The device-resize reader's arguments for native frames onto the
    network's canvas: the aspect-preserving scale, the scaled size as
    ``valid_hw``, ``image_scales`` back to the native frame, no crop offset
    (``chip_smoke.py`` phase 7's arithmetic)."""
    h, w = mix["frame_hw"]
    net_h, net_w = canvas_hw
    b = mix["batch"]
    scale = min(net_h / h, net_w / w)
    sh, sw = int(h * scale), int(w * scale)
    return dict(valid_hw=torch.tensor([[sh, sw]] * b, dtype=torch.int32),
                image_scales=torch.full((b,), 1.0 / scale),
                warp_scale=torch.tensor([[sh / h, sw / w]] * b),
                warp_offset=torch.zeros((b, 2)))
