"""EfficientDet-d7x's topology in the port against the benchmark's sum-fusion reference.

``bench_torch/reference_sum.py`` is plain PyTorch written from the
architecture; here it is held against the port's ``EfficientDetNet`` built
for ``efficientdet-d7x``: six levels (P8 max-pooled from P7), a BiFPN that
fuses by a plain sum (no edge weights), 5 tower repeats with a BatchNorm per
level, anchor scale 4. The backbone keeps B7's pattern at small widths (a
stem of 16, a first stage of two ``e=1`` blocks, the second an identity
skip, then expanding stages at strides 2) through a stand-in for
``backbone_spec``; the canvas is 256x512, so P8 is 1x2. Weights are the
benchmark's (``weights.make`` less the edge weights, calibrated by the
reference), the port computes in f32 on the CPU.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from bench_torch import harness, weights  # noqa: E402
from bench_torch import reference_sum as RS  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.config import get_detection_config  # noqa: E402
from udal_tpu_torch.models import bifpn, efficientdet, efficientnet  # noqa: E402
from udal_tpu_torch.models.efficientdet import EfficientDetNet, mc_forward  # noqa: E402
from udal_tpu_torch.utils import profiling  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CELL = "bdd_head_d7x.serve_native_b8"
BLOCKS = ["r2_k3_s11_e1_i16_o8_se0.25", "r2_k3_s22_e6_i8_o16_se0.25",
          "r1_k5_s22_e6_i16_o24_se0.25", "r2_k3_s22_e6_i24_o32_se0.25",
          "r1_k5_s22_e6_i32_o40_se0.25"]
SMALL = dict(stem_filters=16, backbone_blocks=BLOCKS, image_size=[256, 512],
             fpn_num_filters=16, fpn_cell_repeats=2, mc_samples=3, num_classes=4)
PROGRAM = dict(image_size="512x256", fpn_num_filters=16, fpn_cell_repeats=2, mc_dropoutsamp=3,
               num_classes=4)
# f32 on both sides in another order of operations (the port's grouped and
# 1x1 convolutions, its BatchNorm; the reference's explicit pads): the maps
# of a calibrated network agree to a few ulps of their unit scale
ATOL, RTOL = 2e-4, 2e-4


def _small_b7(model_name, survival_prob=None, num_classes=1000):
    """B7's block pattern at small widths (what ``backbone_spec`` would give
    for a model with these block strings)."""
    spec = efficientnet.backbone_spec(model_name, survival_prob, num_classes)
    blocks = tuple(efficientnet.decode_block_string(s) for s in BLOCKS)
    return efficientnet.BackboneSpec(blocks, 16, spec.head_filters, spec.dropout_rate,
                                     spec.use_se, num_classes, spec.bn_momentum,
                                     spec.bn_epsilon, survival_prob)


@pytest.fixture
def small_b7(monkeypatch):
    monkeypatch.setattr(efficientdet, "backbone_spec", _small_b7)


def _config():
    cfg = harness.load("configs", "bdd_head_d7x")
    arch = dict(cfg["arch"], **SMALL)
    program = get_detection_config(cfg["model_name"])
    program.override(dict(cfg["overrides"], **PROGRAM), allow_new_keys=True)
    return arch, program


class _Replay:
    """A mask source that hands out recorded keep bits in order."""

    def __init__(self, bits):
        self.bits = list(bits)

    def draw(self, n, c, keep, device):
        return self.bits.pop(0)


def test_the_configuration_is_d7x_at_its_published_widths():
    cfg = harness.load("configs", "bdd_head_d7x")
    arch = cfg["arch"]
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "bdd_head_d7x")
    assert entry["reduced"] == []
    spec = efficientnet.backbone_spec("efficientnet-b7")
    assert arch["backbone_blocks"] == [
        f"r{b.num_repeat}_k{b.kernel_size}_s{b.strides[0]}{b.strides[1]}_e{b.expand_ratio}"
        f"_i{b.input_filters}_o{b.output_filters}_se{b.se_ratio}" for b in spec.blocks]
    assert arch["stem_filters"] == spec.stem_filters == 64
    program = get_detection_config(cfg["model_name"])
    program.override(cfg["overrides"], allow_new_keys=True)
    for key in ("fpn_num_filters", "fpn_cell_repeats", "box_class_repeats", "min_level",
                "max_level", "anchor_scale", "fpn_weight_method", "num_classes"):
        assert arch[key] == program[key], key
    assert (arch["fpn_num_filters"], arch["fpn_cell_repeats"], arch["box_class_repeats"],
            arch["max_level"], arch["fpn_weight_method"]) == (384, 8, 5, 8, "sum")
    assert arch["image_size"] == [768, 1536] and program.image_size == "1536x768"
    shapes = RS.param_shapes(arch)
    assert sum(torch.Size(s).numel() for s in shapes.values()) == 77_301_554
    assert not any(k.endswith("edge_weights") for k in shapes)
    with torch.device("meta"):
        model = EfficientDetNet(program)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes


@pytest.mark.parametrize("mc", [False, True], ids=["deterministic", "mc"])
def test_the_port_computes_the_sum_fusion_reference(small_b7, mc):
    arch, program = _config()
    gen = torch.Generator().manual_seed(3)
    images = torch.randn((2, *arch["image_size"], 3), generator=gen)
    shapes = RS.param_shapes(arch)
    p = {k: v for k, v in weights.make(arch, 11, "cpu").items() if k in shapes}
    p = RS.run(RS.calibrate, images, p, arch, torch.Generator().manual_seed(5))
    model = EfficientDetNet(program)
    model.load_state_dict(p, strict=True)
    model.prepare_inference()
    t = arch["mc_samples"]
    bits = None
    with torch.inference_mode():
        if mc:
            # the head-only sites: class then box, each tower repeat of each level
            sites = [(t * 2, arch["fpn_num_filters"])] * (2 * 6 * arch["box_class_repeats"])
            g = torch.Generator().manual_seed(9)
            bits = [torch.rand(s, generator=g) < 0.95 for s in sites]
            cls, box = mc_forward(model, images, t, _Replay(bits))[:2]
        else:
            cls, box = model(images)[:2]
    ref_cls, ref_box = RS.run(RS.network, images, p, arch, RS.Arith("f32"),
                              None if bits is None else RS.Masks(bits, "cpu"))
    if mc:      # the pyramid's six levels on the BiFPN's and the heads' spans
        profiling.clear_spans()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), \
                torch.inference_mode():
            mc_forward(model, images, t, _Replay(bits))
        levels = {s.name: s.attrs.get("levels") for s in profiling.spans()}
        profiling.clear_spans()
        assert levels["model.bifpn"] == levels["model.heads"] == 6
    assert len(cls) == len(ref_cls) == 6 and cls[-1].shape[-3:-1] == (1, 2)
    for got, want in zip(list(cls) + list(box), list(ref_cls) + list(ref_box)):
        want = want.movedim(-3, -1)                     # [T, B, H, W, C]
        got = got if mc else got[None]
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_d7x_heads_with_fused_separable_convs_on_the_card(small_b7, monkeypatch):
    """d7x's BiFPN and heads at their widths (384 wide, 8 sum-fusion cells
    over P3-P8, 5 tower repeats, 10 classes) on the small B7 at 512x256,
    batch 2, T = 3 head-only MC, bf16 on the card: the head outputs with
    the fused separable convs (80 nodes, then 12 calls a level) and with
    the unfused chain, under the same masks, each against the f32 chain.
    The fused kernel rounds a conv's output once where the chain rounds
    after each op, so its outputs are no further from f32 than the
    chain's (the relative norm of the error over every map)."""
    from udal_tpu_torch.ops import fused_sepconv

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda:0")
    _, program = _config()
    d7x = get_detection_config("efficientdet-d7x")
    program.override(dict(fpn_num_filters=d7x.fpn_num_filters,
                          fpn_cell_repeats=d7x.fpn_cell_repeats, num_classes=10),
                     allow_new_keys=True)
    model = EfficientDetNet(program)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():       # unit-size maps through every conv and BatchNorm
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / fan_in ** 0.5)
            elif isinstance(m, efficientnet.BatchNorm):
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    model = model.to(cuda)
    g = torch.Generator().manual_seed(4)
    images = torch.randn((2, 256, 512, 3), generator=g).to(cuda)
    t = program.mc_dropoutsamp
    sites = [(t * 2, program.fpn_num_filters)] * (2 * 6 * program.box_class_repeats)
    bits = [(torch.rand(s, generator=g) < 0.95).to(cuda) for s in sites]

    def outputs(dtype):
        with torch.inference_mode():
            cls, box = mc_forward(model, images.to(dtype), t, _Replay(bits))[:2]
        return [o.float() for o in list(cls) + list(box)]

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with monkeypatch.context() as m:        # the card taken for the CPU: the chain
            m.setattr(bifpn, "_kernel_takes", lambda x: False)
            ref = outputs(torch.float32)
            model.to(torch.bfloat16)
            unfused = outputs(torch.bfloat16)
        model.prepare_inference()
        before = fused_sepconv.launches
        fused = outputs(torch.bfloat16)
        assert fused_sepconv.launches - before == 8 * 10 + 6 * 2 * 6
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    def err(got):
        return (sum(((a - b) ** 2).sum() for a, b in zip(got, ref))
                / sum((b ** 2).sum() for b in ref)).sqrt().item()

    print("relative error against f32: fused", err(fused), "unfused", err(unfused))
    assert err(fused) <= err(unfused)


def test_the_cell_rehearses_correct_and_its_control_fails(small_b7):
    from bench_torch import readings

    overrides = dict(arch=dict(SMALL, num_classes=4), program=PROGRAM,
                     traffic=dict(batch=2, frame_hw=[180, 320], pool_batches=1),
                     harness=dict(check_every=1, check_most=1, trace_calls=2))
    r = readings.readings(CELL, 2**31 + 11, 1, device="cpu", overrides=overrides)
    limits = harness.load("workloads", CELL)["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r["program"]
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]
