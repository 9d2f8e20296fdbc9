"""The benchmark's own arithmetic: model FLOPs, the expand kernel's bound,
the window's rate and tail."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from bench_torch import flops, harness, roofline

REPO = Path(__file__).resolve().parents[2]


def arch(name="kitti_mc_d0", **kw):
    return dict(harness.load("configs", name)["arch"], **kw)


def test_one_mbconv_block_by_hand():
    """Block 1 of b0 at 1024x512: 16 → 96 expand at 256x512, 3x3 stride-2
    depthwise to 128x256, SE 96 ↔ 4, 96 → 24 project."""
    layers = {n: (m, fed) for n, m, fed in flops.layers(arch())}
    assert layers["blocks_1.expand"] == (256 * 512 * 16 * 96, True)
    assert layers["blocks_1.depthwise"] == (128 * 256 * 96 * 9, True)
    assert layers["blocks_1.se"] == (2 * 96 * 4, True)
    assert layers["blocks_1.project"] == (128 * 256 * 96 * 24, True)
    # block 0's depthwise precedes the first dropout site: once an image
    assert layers["blocks_0.depthwise"] == (256 * 512 * 32 * 9, False)
    assert layers["stem"] == (256 * 512 * 32 * 3 * 9, False)


def test_one_bifpn_node_by_hand():
    """Node 0 of cell 1 fuses at P6 (8x16 at 1024x512): a 3x3 depthwise and
    a 64 → 64 pointwise; node 0 of cell 0 also resamples nothing (P6 and P7
    are already 64 wide)."""
    layers = {n: m for n, m, _ in flops.layers(arch())}
    assert layers["cell_1.fnode0.conv"] == 8 * 16 * 64 * 9 + 8 * 16 * 64 * 64
    # cell 0's node 2 fuses P4 (112 wide at 32x64) with node 1: one 1x1 resample
    assert layers["cell_0.fnode2.resample_0"] == 32 * 64 * 112 * 64
    assert "cell_1.fnode2.resample_0" not in layers


def test_samples_multiply_only_what_dropout_feeds():
    for name in ("kitti_mc_d0", "kitti_head_d0"):
        a = arch(name)
        once = sum(2 * m for _, m, fed in flops.layers(a) if not fed)
        per = sum(2 * m for _, m, fed in flops.layers(a) if fed)
        assert flops.image_flops(a, 10) == pytest.approx(once + 10 * per)
        assert flops.image_flops(a, 1) == pytest.approx(once + per)
    # the same network either way: one pass has the same FLOPs
    assert flops.image_flops(arch("kitti_mc_d0"), 1) == \
        pytest.approx(flops.image_flops(arch("kitti_head_d0"), 1))
    # head-only: the backbone and BiFPN once, the heads past their first conv T times
    head = {n: fed for n, _, fed in flops.layers(arch("kitti_head_d0"))}
    assert not head["blocks_15.project"] and not head["cell_2.fnode7.conv"]
    assert not head["class-0.l3"] and head["class-1.l3"] and head["box-predict.l7"]


def test_layer_table_matches_the_program_executed():
    """The multiply-adds of every convolution the program's network runs in
    one eager pass at a small size equal the table's."""
    from udal_tpu_torch.config import get_detection_config
    from udal_tpu_torch.models.efficientdet import EfficientDetNet

    cfg = harness.load("configs", "kitti_mc_d0")
    config = get_detection_config(cfg["model_name"])
    config.override(dict(cfg["overrides"], image_size="256x128"), allow_new_keys=True)
    model = EfficientDetNet(config).train()        # the unfused chain: every conv runs
    macs = []

    def hook(mod, inputs, out):
        w = mod.weight
        macs.append(out.shape[-2] * out.shape[-1] * w.shape[0] * w.shape[1] * w.shape[2]
                    * w.shape[3])

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 128, 256, 3))
    assert sum(macs) == sum(m for _, m, _ in flops.layers(arch(image_size=[128, 256])))


def test_expand_bound_is_chip_smokes():
    """The copied bound equals ``chip_smoke.py``'s at blocks 1, 3 and 12 of
    the main path (T·B = 80)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    blocks = {b[0]: b[1:] for b in smoke.EXPAND_BLOCKS}
    for index in (1, 3, 12):
        assert roofline.expand_bound(80, *blocks[index]) == smoke.expand_bound(80, *blocks[index])
    assert roofline.expand_bound(80, *blocks[1]) == pytest.approx((0.2504, "bytes"), abs=1e-4)


def test_stalls_move_the_rate_and_the_tail():
    """Five stalled calls in 100: the rate (all work over all time) falls
    and the 95th percentile rises; the median does not see them."""
    steady = [0.050] * 100
    stalled = [0.050] * 95 + [2.0] * 5
    a = harness.window_metrics(steady, 8, sum(steady))
    b = harness.window_metrics(stalled, 8, sum(stalled))
    assert a["rate"] == pytest.approx(160.0) and a["p95_ms"] == pytest.approx(50.0)
    assert b["rate"] == pytest.approx(800 / 14.75)
    assert b["p95_ms"] == pytest.approx(50.0 + 0.05 * 1950.0)
    assert b["median_ms"] == pytest.approx(50.0)
    assert harness.percentile([1, 2, 3, 4], 50) == 2.5
