"""Shared pieces of the harness's CPU tests: tiny sizes of every cell, and
a run of one on the CPU."""

from __future__ import annotations

import pytest
import torch

from bench_torch import harness

# the cells' configurations at 128x256 (P7 keeps a 1x2 map), their mixes at
# batch 2 with one pool batch (the frames the weights are calibrated on)
TINY_ARCH = dict(arch=dict(image_size=[128, 256]), program=dict(image_size="256x128"))
TINY_MIX = {"closed_b8_u8_1024x512": dict(batch=2, frame_hw=[128, 256], pool_batches=1),
            "closed_b8_native_375x1242": dict(batch=2, frame_hw=[94, 310], pool_batches=1),
            "closed_b32_native_375x1242": dict(batch=3, frame_hw=[94, 310], pool_batches=1)}
CELLS = ("kitti_mc.serve_b8", "kitti_head.serve_native_b8", "kitti_head.serve_native_b32")
# every call compared (a one-second window on the CPU makes a handful)
TINY_HARNESS = dict(check_every=1, check_most=2, trace_calls=2)


def tiny(cell: str, roots=(harness.ROOT,)) -> dict:
    mix = harness.load("workloads", cell, roots)["traffic"]
    return dict(TINY_ARCH, traffic=dict(TINY_MIX[mix]), harness=dict(TINY_HARNESS))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the CPU rehearsals run beside other tests."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def rehearse(cell: str, trace: bool = False, seed: int = 2**33 + 7, seconds: float = 1.0,
             overrides=None) -> dict:
    import time
    return harness.run(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                       overrides=overrides or tiny(cell), log=lambda *_: None)
