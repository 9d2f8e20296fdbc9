"""The fused separable conv (``ops/fused_sepconv.py``): its plain version
against the module chain, the folds, the dispatch, and, on a card, the
kernel against the plain version and the unfused chain.

Imports only torch, numpy and the port, so the card's tests run on a
machine without JAX: ``python -m pytest tests/test_torch_fused_sepconv.py
--noconftest -q``. The tests with the ``cuda`` marker skip without a CUDA
device.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.apps.serving import ServingDriver  # noqa: E402
from udal_tpu_torch.models import bifpn  # noqa: E402
from udal_tpu_torch.models.bifpn import FNode, SeparableConv  # noqa: E402
from udal_tpu_torch.models.efficientnet import BatchNorm, ChannelDropout  # noqa: E402
from udal_tpu_torch.models.heads import _Head, _HeadStack  # noqa: E402
from udal_tpu_torch.ops import fused_sepconv as fs  # noqa: E402

SMALL = dict(image_size="128x128", num_classes=8, loss_attenuation=True, fpn_cell_repeats=1,
             box_class_repeats=2, mc_dropout=True, mc_classheadrate=0.05,
             mc_boxheadrate=0.05, enable_softmax=True, mc_dropoutsamp=3)
# (pre, post, conv bias, BatchNorm, mask): a BiFPN node, one with
# conv_bn_act_pattern, a head tower layer, a predict conv
ROLES = {"node": ("swish", "identity", True, True, False),
         "node_pattern": ("identity", "swish", False, True, False),
         "tower": ("identity", "swish", True, True, True),
         "predict": ("identity", "identity", True, False, False)}
# the pyramids' levels (H, W): d0 at 1024x512, d7x at 1536x768
D0_LEVELS = [(64, 128), (32, 64), (16, 32), (8, 16), (4, 8)]
D7X_LEVELS = [(96, 192), (48, 96), (24, 48), (12, 24), (6, 12), (3, 6)]


def randomize(module, seed):
    """Weights, biases and BatchNorm statistics drawn from ``seed``, scaled
    so the maps keep unit size through a conv."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            elif isinstance(m, BatchNorm):
                c = m.weight.shape
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return module


def role_operands(role, n, cin, cout, h, w, seed, device="cpu", dtype=torch.float32):
    """x, a SeparableConv and its BatchNorm (or None), (scale, bias), the
    mask, pre and post of a role."""
    pre, post, use_bias, use_bn, masked = ROLES[role]
    conv = randomize(SeparableConv(cin, cout, use_bias=use_bias), seed)
    bn = randomize(BatchNorm(cout), seed + 1) if use_bn else None
    if bn is not None:
        scale, bias = fs.fold_sepconv_bn(bn, conv.pointwise.bias)
    else:
        scale, bias = torch.ones(cout), conv.pointwise.bias.detach().float().clone()
    g = torch.Generator().manual_seed(seed + 2)
    x = torch.randn((n, cin, h, w), generator=g)
    mask = ((torch.rand((n, cout), generator=g) < 0.9) / 0.9).float() if masked else None
    conv = conv.to(device=device, dtype=dtype)
    to = (lambda t: None if t is None else t.to(device))  # noqa: E731
    return (x.to(device=device, dtype=dtype), conv, None if bn is None else bn.to(device),
            to(scale), to(bias), to(mask), pre, post)


def chain(x, conv, bn, mask, pre, post):
    """The unfused chain: pre, the separable conv, BatchNorm, post, mask."""
    act = {"swish": torch.nn.functional.silu, "identity": lambda v: v}
    y = conv(act[pre](x))
    if bn is not None:
        y = bn(y)
    y = act[post](y)
    return y if mask is None else y * mask.to(y.dtype)[:, :, None, None]


@pytest.mark.parametrize("role", sorted(ROLES))
@pytest.mark.parametrize("n,cin,cout,h,w", [(3, 16, 16, 5, 7), (2, 24, 63, 9, 12),
                                            (2, 40, 72, 1, 1), (1, 8, 90, 6, 3)])
def test_plain_equals_the_module_chain_in_f32(role, n, cin, cout, h, w):
    """f32: the plain version computes the eval-mode chain's values, up to
    the order of its sums."""
    x, conv, bn, scale, bias, mask, pre, post = role_operands(role, n, cin, cout, h, w, cin)
    with torch.no_grad():
        want = chain(x, conv, bn, mask, pre, post)
        got = fs.fused_sepconv(x, conv.depthwise.weight, conv.pointwise.weight, scale, bias,
                               mask, pre, post)
    assert got.dtype == torch.float32 and got.shape == (n, cout, h, w)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_plain_rounds_pre_and_the_depthwise_to_bf16():
    """bf16: the plain version rounds x's pre-activation and the depthwise
    to bf16, as the unfused chain and the kernel do, and y once."""
    x, conv, bn, scale, bias, mask, pre, post = role_operands("node", 2, 16, 16, 6, 10, 3)
    xb = x.bfloat16()
    taps = conv.depthwise.weight.bfloat16()
    w = conv.pointwise.weight.bfloat16()
    got = fs.fused_sepconv(xb, taps, w, scale, bias, None, "swish", "identity")
    xp = torch.nn.functional.silu(xb.float()).bfloat16().float()
    d = fs.depthwise_same(xp, taps.float()[:, 0], 1).bfloat16().float()
    z = torch.nn.functional.conv2d(d, w.float())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, (z * scale[:, None, None] + bias[:, None, None]).bfloat16(),
                               atol=0, rtol=0)


def test_operands_it_does_not_take_raise():
    x, conv, bn, scale, bias, mask, pre, post = role_operands("tower", 2, 8, 8, 4, 4, 1)
    taps, w = conv.depthwise.weight, conv.pointwise.weight
    with pytest.raises(ValueError, match="3x3"):
        fs.fused_sepconv(x, torch.zeros(8, 1, 5, 5), w, scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_sepconv(x, taps.bfloat16(), w, scale, bias)
    with pytest.raises(ValueError, match=r"\[2, 8\]"):
        fs.fused_sepconv(x, taps, w, scale, bias, torch.ones(3, 8))
    with pytest.raises(ValueError, match="activation"):
        fs.fused_sepconv(x, taps, w, scale, bias, post="gelu")


def tiny_driver(seed=3, **extra):
    return ServingDriver.create("efficientdet-d0", overrides=dict(SMALL, **extra), device="cpu",
                                seed=seed)


def folds(model):
    """The separable convs' folds, not the MBConv blocks'."""
    return [m.folded for m in model.modules() if isinstance(m, (FNode, _HeadStack, _Head))]


def test_prepare_inference_refolds_into_the_same_tensors():
    """The driver folds every separable conv (8 BiFPN nodes, 2 towers, 2
    predict convs); a second fold after new weights writes into the same
    tensors (the addresses a captured graph reads) the values a fresh
    fold gives; ``drop_folds`` and train mode drop them."""
    driver = tiny_driver()
    model = driver.model
    first = folds(model)
    assert len(first) == 12 and all(f is not None for f in first)
    tower = model.class_net["stack"].folded
    assert tower["scale"].shape == (2, 5, 64) and tower["scale"].dtype == torch.float32
    ptrs = [t.data_ptr() for f in first for t in f.values()]
    other = randomize(tiny_driver(seed=5).model, 9).state_dict()
    model.load_state_dict(other)
    model.prepare_inference()
    again = folds(model)
    assert all(a is b for a, b in zip(first, again))
    assert ptrs == [t.data_ptr() for f in again for t in f.values()]
    fresh = tiny_driver(seed=5).model
    fresh.load_state_dict(other)
    fresh.prepare_inference()
    for a, b in zip(again, folds(fresh)):
        for k in a:
            torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
    node = model.fpn_cells.cell_0.fnode0
    scale, bias = fs.fold_sepconv_bn(node.bn, node.conv.pointwise.bias)
    torch.testing.assert_close(node.folded["bias"], bias, atol=0, rtol=0)
    model.drop_folds()
    assert all(f is None for f in folds(model))
    assert model.backbone.blocks_0.folded is None
    model.prepare_inference()
    model.train()
    assert all(f is None for f in folds(model))


class Calls(list):
    """The fused calls made, each its x's shape (and in ``dtypes`` its
    type)."""


@pytest.fixture
def counted(monkeypatch):
    """Counts the fused calls; ``fused_on_cpu()`` takes the CPU as a card."""
    calls = Calls()
    calls.dtypes = []
    real = bifpn.fused_sepconv

    def count(x, *args, **kwargs):
        calls.append(tuple(x.shape))
        calls.dtypes.append(x.dtype)
        return real(x, *args, **kwargs)

    def fused_on_cpu():
        monkeypatch.setattr(bifpn, "_kernel_takes", lambda x: True)

    monkeypatch.setattr(bifpn, "fused_sepconv", count)
    calls.fused_on_cpu = fused_on_cpu
    return calls


def test_the_cpu_train_mode_and_plain_convs_never_call_the_fused_op(counted):
    """On the CPU the chain runs as written; with the CPU taken as a card,
    eval mode fuses every separable conv (8 + 2 · 5 · 3 calls), train mode
    none, nor a model built with ``separable_conv: false``."""
    images = torch.randn(2, 128, 128, 3)
    driver = tiny_driver()
    with torch.inference_mode():
        driver.model(images)
    assert counted == []
    counted.fused_on_cpu()
    with torch.inference_mode():
        driver.model(images)
    assert len(counted) == 8 + 2 * 5 * 3
    del counted[:]
    driver.model.train()
    driver.model.prepare_inference()       # folds made, but train mode ignores them
    driver.model(images)
    assert counted == []
    plain = tiny_driver(separable_conv=False)
    assert all(f is None for f in folds(plain.model))
    with torch.inference_mode():
        plain.model(images)
    assert counted == []


def test_the_fused_path_computes_the_chain_in_a_model(counted):
    """A head-only MC forward with the CPU taken as a card: the fused
    calls' outputs equal the unfused chain's in f32 up to the order of the
    sums, under the same masks."""
    model = randomize(tiny_driver().model, 4)
    model.prepare_inference()
    images = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    x = images.permute(0, 3, 1, 2).contiguous()

    def run():
        with torch.inference_mode():
            masks = ChannelDropout(torch.Generator().manual_seed(2))
            return model.head_outputs(model.features(x), masks, 3, repeat=True)

    want = run()
    counted.fused_on_cpu()
    got = run()
    assert len(counted) == 8 + 2 * 5 * 3
    for g_maps, w_maps in zip(got, want):
        for g, w in zip(g_maps, w_maps):
            assert w.abs().max() > 0.1
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_a_model_never_prepared_folds_for_each_call(counted):
    """With the CPU taken as a card, a forward without folds (never
    prepared, or after ``drop_folds``: an ``eval_step``, the gathered
    tensor-parallel model) still makes every fused call, with operands
    folded for the call, and gives the prepared model's bits; no fold is
    kept."""
    model = randomize(tiny_driver().model, 4)
    images = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    counted.fused_on_cpu()

    def run():
        with torch.inference_mode():
            return model(images)

    model.drop_folds()
    unprepared = run()
    assert len(counted) == 8 + 2 * 5 * 3
    assert all(f is None for f in folds(model))
    model.prepare_inference()
    prepared = run()
    assert len(counted) == 2 * (8 + 2 * 5 * 3)
    for got, want in zip(unprepared[0] + unprepared[1], prepared[0] + prepared[1]):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_a_mixed_precision_forward_fuses_under_autocast(counted):
    """f32 weights under bf16 autocast, as a mixed-precision ``eval_step``
    runs the model, with the CPU taken as a card: every separable conv
    makes its fused call on bf16 activations (the weights cast as the
    chain's convolutions cast them), and the outputs are no further from
    the f32 forward's than the chain's under the same autocast."""
    model = randomize(tiny_driver().model, 4)
    model.drop_folds()
    images = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))

    def run(autocast):
        with torch.inference_mode(), torch.autocast("cpu", torch.bfloat16, enabled=autocast):
            cls, box = model(images)
        return torch.cat([t.float().flatten() for t in list(cls) + list(box)])

    ref, chain = run(False), run(True)
    counted.fused_on_cpu()
    fused = run(True)
    assert counted.dtypes == [torch.bfloat16] * (8 + 2 * 5 * 3)

    def err(got):
        return ((got - ref).norm() / ref.norm()).item()

    assert err(fused) <= err(chain), (err(fused), err(chain))


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture
def no_tf32(cuda):
    """The plain version's 1x1 conv in full f32 (cuDNN's TF32 off)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = before


def bf16_ulp(t):
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def assert_bf16_close(got, want, ulps, top_ulps):
    """|got - want| <= ulps · ulp(|want|) + top_ulps · ulp(max |want|)."""
    got, want = got.float(), want.float()
    bound = ulps * bf16_ulp(want) + top_ulps * bf16_ulp(want.abs().max())
    excess = ((got - want).abs() - bound).max().item()
    assert excess <= 0, f"exceeds {ulps} + {top_ulps} top bf16 ulps by {excess}"


# (role, n, cin, cout, levels): the main paths' shapes and the edges, bf16
CARD_CASES = {
    "d0_tower_b80": ("tower", 80, 64, 64, D0_LEVELS),
    "d0_tower_b320": ("tower", 320, 64, 64, [D0_LEVELS[0], D0_LEVELS[-1]]),
    "d0_node_b8": ("node", 8, 64, 64, D0_LEVELS),
    "d0_node_pattern_b8": ("node_pattern", 8, 64, 64, D0_LEVELS[::2]),
    "d0_class_predict": ("predict", 80, 64, 63, D0_LEVELS),
    "d0_box_predict": ("predict", 80, 64, 72, D0_LEVELS),
    "d7x_tower_b80": ("tower", 80, 384, 384, D7X_LEVELS),
    "d7x_node_b8": ("node", 8, 384, 384, D7X_LEVELS),
    "d7x_class_predict": ("predict", 80, 384, 90, D7X_LEVELS),
    "d7x_box_predict": ("predict", 80, 384, 72, [D7X_LEVELS[0], D7X_LEVELS[-1]]),
    "odd_widths": ("tower", 3, 40, 100, [(5, 7), (9, 21), (1, 1), (2, 300)]),
    "wide_outputs": ("node", 2, 24, 200, [(7, 12), (3, 520)]),
    "d4_odd_levels": ("tower", 3, 224, 224, [(5, 7), (9, 21), (1, 1), (2, 300)]),
    "ragged_second_slice": ("node", 2, 384, 200, [(7, 12), (3, 520)]),
    "five_slices": ("predict", 4, 160, 810, [(10, 40), (3, 6)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_on_the_card(no_tf32, case):
    """Each level of a case: one launch, of the resident kernel exactly
    where Cin > 128 (every d7x case, none of d0's), the plain version's
    values. Both round pre(x) and the depthwise to bf16, where f32 sums in
    another order (and the kernel's one-MUFU swish) can round a value
    apart, so 2 ulps of each value plus one of the largest."""
    role, n, cin, cout, levels = CARD_CASES[case]
    resident = int(cin > fs.RESIDENT_FROM)
    assert resident == case.startswith(("d7x", "d4", "ragged", "five"))
    for i, (h, w) in enumerate(levels):
        x, conv, bn, scale, bias, mask, pre, post = role_operands(
            role, n, cin, cout, h, w, 10 * i + cin, no_tf32, torch.bfloat16)
        taps, wt = conv.depthwise.weight.detach(), conv.pointwise.weight.detach()
        want = fs.fused_sepconv_plain(x, taps, wt, scale, bias, mask, pre, post)
        before, before_resident = fs.launches, fs.resident_launches
        got = fs.fused_sepconv(x, taps, wt, scale, bias, mask, pre, post)
        torch.cuda.synchronize()
        assert fs.launches == before + 1
        assert fs.resident_launches == before_resident + resident
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert_bf16_close(got, want, 2, 1)
        del x, want, got


@pytest.mark.cuda
@pytest.mark.parametrize("role,cin,cout,h,w", [("tower", 384, 384, 3, 6),
                                               ("tower", 384, 384, 24, 48),
                                               ("predict", 384, 90, 12, 24)])
def test_resident_kernel_at_any_grid(no_tf32, role, cin, cout, h, w):
    """The resident kernel at grids the planner would not take: more groups
    than bands (blocks that get no band and leave) and one or two groups
    (a block walks many times more bands than the grid), each the plain
    version's values and the same bits as at the planned grid."""
    x, conv, bn, scale, bias, mask, pre, post = role_operands(role, 16, cin, cout, h, w, 3,
                                                              no_tf32, torch.bfloat16)
    taps, wt = conv.depthwise.weight.detach(), conv.pointwise.weight.detach()
    want = fs.fused_sepconv_plain(x, taps, wt, scale, bias, mask, pre, post)
    planned = fs.fused_sepconv(x, taps, wt, scale, bias, mask, pre, post)
    p = fs.plan(16, cin, cout, h, w)
    bands = -(-(16 * h) // p.th) * -(-w // p.tw)
    for groups in (bands + 5, 1, 2):
        got = fs._launch(x, taps, wt, scale, bias, mask, pre, post,
                         p._replace(grid=groups * p.slices))
        torch.cuda.synchronize()
        assert_bf16_close(got, want, 2, 1)
        assert torch.equal(got, planned), groups


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "relu6", "hswish", "mish"])
def test_resident_kernel_takes_every_activation(no_tf32, act):
    """pre and post other than swish and the identity, each a constant of
    its own copy of the resident kernel's code (mish from the hardware exp,
    log and tanh), at a pair's bands of 2 x 32 and at odd levels: the plain
    version's values within 2 + 1 bf16 ulps."""
    for h, w in [(12, 32), (5, 7)]:
        x, conv, bn, scale, bias, mask, _, _ = role_operands("tower", 4, 384, 384, h, w, 8,
                                                             no_tf32, torch.bfloat16)
        taps, wt = conv.depthwise.weight.detach(), conv.pointwise.weight.detach()
        want = fs.fused_sepconv_plain(x, taps, wt, scale, bias, mask, act, act)
        before = fs.resident_launches
        got = fs.fused_sepconv(x, taps, wt, scale, bias, mask, act, act)
        torch.cuda.synchronize()
        assert fs.resident_launches == before + 1
        assert_bf16_close(got, want, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["x", "w"])
def test_resident_kernel_takes_a_misaligned_view(cuda, operand):
    """x (or W) 2 bytes off a 16-byte boundary at d7x's width: plain loads
    of x (or of W, into the same resident rows), the same values."""
    x, conv, bn, scale, bias, mask, pre, post = role_operands("node", 2, 384, 384, 12, 24, 5,
                                                              cuda, torch.bfloat16)
    taps, wt = conv.depthwise.weight.detach(), conv.pointwise.weight.detach()
    want = fs.fused_sepconv_plain(x, taps, wt, scale, bias, mask, pre, post)
    t = x if operand == "x" else wt
    base = torch.empty(t.numel() + 1, dtype=torch.bfloat16, device=cuda)
    view = base[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    args = (view, taps, wt) if operand == "x" else (x, taps, view)
    before = fs.resident_launches
    assert_bf16_close(fs.fused_sepconv(*args, scale, bias, mask, pre, post), want, 2, 1)
    assert fs.resident_launches == before + 1


@pytest.mark.cuda
def test_kernel_takes_a_misaligned_view(cuda):
    """x 2 bytes off a 16-byte boundary: the plain loads, the same values."""
    x, conv, bn, scale, bias, mask, pre, post = role_operands("tower", 4, 64, 64, 16, 32, 5,
                                                              cuda, torch.bfloat16)
    base = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    xv = base[1:].view(x.shape)
    xv.copy_(x)
    assert xv.data_ptr() % 16 != 0
    taps, wt = conv.depthwise.weight.detach(), conv.pointwise.weight.detach()
    want = fs.fused_sepconv_plain(x, taps, wt, scale, bias, mask, pre, post)
    assert_bf16_close(fs.fused_sepconv(xv, taps, wt, scale, bias, mask, pre, post), want, 2, 1)


@pytest.mark.cuda
def test_planner_counts_the_kernels_shared_memory(cuda):
    """The band planner's shared-memory model equals the source's count at
    every plan of the cases (each of the three tensor-core configurations,
    and the resident kernel's, pairs and single slices)."""
    for role, n, cin, cout, levels in CARD_CASES.values():
        for h, w in levels:
            p = fs.plan(n, cin, cout, h, w)
            if isinstance(p, fs.ResidentPlan):
                assert (fs.kernel_resident_smem_bytes(cin, p.mb, p.pair, p.th, p.tw)
                        == fs.resident_smem_bytes(cin, p.mb, p.pair, p.th, p.tw)), (p, cin)
                continue
            assert (fs.kernel_smem_bytes(p.cfg, cin, p.th, p.tw)
                    == fs.smem_bytes(p.cfg, cin, p.th, p.tw)), (p, cin)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda):
    """Half precision, a view that is not contiguous, CPU tensors, and f32
    on the card (which runs the chain instead)."""
    x, conv, bn, scale, bias, mask, pre, post = role_operands("tower", 2, 8, 8, 4, 4, 1, cuda)
    taps, wt = conv.depthwise.weight.detach(), conv.pointwise.weight.detach()
    with pytest.raises(TypeError, match="takes bfloat16"):
        fs.fused_sepconv(x, taps, wt, scale, bias)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fs.fused_sepconv(x.half(), taps.half(), wt.half(), scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_sepconv(x.transpose(2, 3), taps, wt, scale, bias)
    with pytest.raises(ValueError, match="CUDA"):
        fs.fused_sepconv_cuda(x.cpu(), taps.cpu(), wt.cpu(), scale.cpu(), bias.cpu())


def err_norm(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def module_case(role, device):
    """A BiFPN node or a head tower (three layers, per-level BatchNorm,
    dropout masks) at d0's width, f32, on ``device``; its f32 inputs; and
    how to run it (the tower at level 2 under fixed masks)."""
    g = torch.Generator().manual_seed(6)
    if role == "node":
        module = randomize(FNode((32, 64), [64, 64], 64), 7).eval()
        inputs = [torch.randn((8, 64, 32, 64), generator=g) for _ in range(2)]
        run = lambda m, xs: m(xs)  # noqa: E731
    else:
        module = randomize(_HeadStack(5, 64, 3, "class", mc_dropoutrate=0.05), 7).eval()
        inputs = [torch.randn((80, 64, 16, 32), generator=g)]
        run = lambda m, xs: m(xs[0], 2, ChannelDropout(  # noqa: E731
            torch.Generator(device=device).manual_seed(3)))
    return module.to(device), [x.to(device) for x in inputs], run


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["node", "tower"])
def test_fused_modules_are_no_further_from_f32_than_the_chain(no_tf32, role, monkeypatch):
    """A BiFPN node and a head tower in bf16 on the card: fused (folded)
    and unfused (the card taken for the CPU), each against the same module
    in f32; the fused output rounds once where the chain rounds after each
    op, so its error is no larger than the chain's."""
    module, inputs, run = module_case(role, no_tf32)
    xs = [x.bfloat16() for x in inputs]
    with torch.inference_mode():
        with monkeypatch.context() as m:
            m.setattr(bifpn, "_kernel_takes", lambda x: False)
            ref = run(module, inputs)
            module = module.to(dtype=torch.bfloat16)
            unfused = run(module, xs)
        module.prepare_inference()
        before = fs.launches
        fused = run(module, xs)
        assert fs.launches == before + (1 if role == "node" else 3)
    assert fused.dtype == torch.bfloat16
    assert err_norm(fused, ref) <= err_norm(unfused, ref), (err_norm(fused, ref),
                                                            err_norm(unfused, ref))


@pytest.mark.cuda
def test_a_fused_tower_under_autocast_is_no_further_from_f32_than_the_chain(
        no_tf32, monkeypatch):
    """The head tower with f32 weights on bf16 inputs under bf16 autocast
    (a mixed-precision ``eval_step``) and no fold: the fused calls (the
    weights cast to bf16, the fold made for the call) and the chain under
    the same autocast, each against the f32 module. (A single node's
    errors lie too close together for the order to be a test: 0.3% apart
    in the plain version on the CPU.)"""
    module, inputs, run = module_case("tower", no_tf32)
    xs = [x.bfloat16() for x in inputs]
    with torch.inference_mode():
        with monkeypatch.context() as m:
            m.setattr(bifpn, "_kernel_takes", lambda x: False)
            ref = run(module, inputs)
            with torch.autocast("cuda", torch.bfloat16):
                unfused = run(module, xs)
        before = fs.launches
        with torch.autocast("cuda", torch.bfloat16):
            fused = run(module, xs)
        assert fs.launches == before + 3
    assert fused.dtype == torch.bfloat16
    assert err_norm(fused, ref) <= err_norm(unfused, ref), (err_norm(fused, ref),
                                                            err_norm(unfused, ref))
