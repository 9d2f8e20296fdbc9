"""The port's fused MBConv front half (``udal_tpu_torch/ops/fused_mbconv.py``)
against the JAX package, and the port's ``MBConvBlock`` routed through the
fused plain versions against the flax ``MBConvBlock``.

- At stride 1 the plain version equals the TPU kernel
  ``udal_tpu/ops/pallas_mbconv.py:fused_expand_dw`` run in interpret mode,
  transposed to and from its [H, W, C, N] layout.
- At stride 2 the TPU kernel centres its windows on input row s·i, where
  the model's TF SAME convolution puts the extra pad at the end (ROADMAP
  C1). The port follows the model: it equals the chain written with
  ``lax.conv_general_dilated(..., "SAME")``, and the TPU kernel differs
  from both by far more than the tolerance. The divergence is deliberate.
- The block test feeds both sides the same numpy weights and records the
  flax block's dropout masks (``RecordingDropout``) to replay them in the
  port (``MaskTable``), for k in {3, 5}, s in {1, 2}, expand in {1, 6}.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import udal_tpu.models.efficientnet as jax_effnet  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_mc import MaskTable, RecordingDropout  # noqa: E402
from udal_tpu.ops.pallas_mbconv import fused_expand_dw as tpu_fused_expand_dw  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch  # noqa: E402
from udal_tpu_torch.models import efficientnet as torch_effnet  # noqa: E402
from udal_tpu_torch.ops import fused_mbconv  # noqa: E402

N, H, W, CIN, CE = 4, 8, 16, 8, 24
# f32 on both sides from the same values: the Cin-long expand sums and the
# k·k taps are summed in another order, which moves the last bits of O(1)
# outputs and of the O(10) SE sums.
ATOL, RTOL = 1e-5, 1e-5


def operands(seed, k):
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(x=f32(rng.normal(0, 1, (N, CIN, H, W))),
                we=f32(rng.normal(0, 1 / np.sqrt(CIN), (CIN, CE))),
                b0=f32(rng.normal(0, 0.1, CE)), wd=f32(rng.normal(0, 1.0 / k, (CE, k, k))),
                b1=f32(rng.normal(0, 0.1, CE)),
                m1=f32((rng.uniform(size=(N, CE)) < 0.8) / 0.8),
                m2=f32((rng.uniform(size=(N, CE)) < 0.8) / 0.8))


def port(o, s, k, masked=True):
    t = {n: torch.from_numpy(v) for n, v in o.items()}
    m1, m2 = (t["m1"], t["m2"]) if masked else (None, None)
    return fused_mbconv.fused_expand_dw(t["x"], t["we"], t["b0"], m1, t["wd"], t["b1"], m2,
                                        s, k)


def tpu_kernel(o, s, k, masked=True):
    """The TPU kernel in interpret mode, in and out of its [H, W, C, N]
    layout; without masks it gets masks of ones."""
    m1, m2 = (o["m1"], o["m2"]) if masked else (np.ones_like(o["m1"]),) * 2
    y, se = tpu_fused_expand_dw(
        jnp.asarray(o["x"].transpose(2, 3, 1, 0)), jnp.asarray(o["we"]), jnp.asarray(o["b0"]),
        jnp.asarray(m1.T), jnp.asarray(o["wd"].transpose(1, 2, 0)), jnp.asarray(o["b1"]),
        jnp.asarray(m2.T), stride=s, ksize=k, wt=8, interpret=True)
    return np.asarray(y).transpose(3, 2, 0, 1), np.asarray(se).T


def same_chain(o, s, k):
    """The MBConv front half in JAX with the model's TF SAME depthwise."""
    swish = lambda v: v * jax.nn.sigmoid(v)  # noqa: E731
    x = jnp.asarray(o["x"].transpose(0, 2, 3, 1))
    z = swish(jnp.einsum("nhwc,ce->nhwe", x, o["we"]) + o["b0"]) * o["m1"][:, None, None]
    a = jax.lax.conv_general_dilated(
        z, jnp.asarray(o["wd"].transpose(1, 2, 0)[:, :, None, :]), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=CE)
    a = swish(a + o["b1"]) * o["m2"][:, None, None]
    return np.asarray(a).transpose(0, 3, 1, 2), np.asarray(a.sum(axis=(1, 2)))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("masked", [True, False], ids=["masks", "no-masks"])
def test_plain_version_matches_the_tpu_kernel_at_stride_1(k, masked):
    o = operands(k, k)
    y, se = port(o, 1, k, masked)
    want_y, want_se = tpu_kernel(o, 1, k, masked)
    assert tuple(y.shape) == (N, CE, H, W) and se.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(se.numpy(), want_se, atol=10 * ATOL, rtol=RTOL)


@pytest.mark.parametrize("k", [3, 5])
def test_stride_2_follows_tf_same_not_the_tpu_kernel(k):
    """The port equals the TF SAME chain; the TPU kernel's centred windows
    differ from it by more than 10% of the output's largest value."""
    o = operands(10 + k, k)
    y, se = port(o, 2, k)
    want_y, want_se = same_chain(o, 2, k)
    assert tuple(y.shape) == (N, CE, H // 2, W // 2)
    np.testing.assert_allclose(y.numpy(), want_y, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(se.numpy(), want_se, atol=10 * ATOL, rtol=RTOL)
    tpu_y, _ = tpu_kernel(o, 2, k)
    assert np.abs(tpu_y - want_y).max() > 0.1 * np.abs(want_y).max()


def test_expanded_tensor_is_rounded_to_the_working_type():
    """bf16 input: z is rounded to bf16 before the depthwise, as the
    kernel's shared-memory tile holds it; y is rounded once more."""
    o = operands(20, 3)
    t = {n: torch.from_numpy(v) for n, v in o.items()}
    xb = t["x"].bfloat16()
    y, se = fused_mbconv.fused_expand_dw(xb, t["we"], t["b0"], t["m1"], t["wd"], t["b1"],
                                         t["m2"], 1, 3)
    z = torch_effnet.activation_fn("swish")(
        torch.einsum("nchw,ce->nehw", xb.float(), t["we"]) + t["b0"][:, None, None])
    z = (z * t["m1"][:, :, None, None]).bfloat16().float()
    a = torch.nn.functional.conv2d(z, t["wd"][:, None], padding=1, groups=CE)
    a = torch.nn.functional.silu(a + t["b1"][:, None, None]) * t["m2"][:, :, None, None]
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), a.bfloat16().float(), atol=0, rtol=2 ** -7)
    torch.testing.assert_close(se, a.sum((2, 3)), atol=1e-4, rtol=1e-5)


def test_tile_shape_fits_shared_memory():
    """The f32 kernel's tile: its folded weights and expanded tile, f32,
    fit the budget."""
    for ho, wo, cin, s, k in [(128, 256, 16, 2, 3), (64, 128, 24, 2, 5),
                              (16, 32, 192, 1, 5), (3, 200, 320, 2, 5)]:
        th, tw = fused_mbconv.tile_shape(ho, wo, cin, s, k)
        assert 1 <= th <= ho and 1 <= tw <= min(wo, 64)
        staged = (cin * fused_mbconv.CHANNEL_TILE * 4 + fused_mbconv.CHANNEL_TILE
                  * ((th - 1) * s + k) * ((tw - 1) * s + k) * 4)
        assert staged == fused_mbconv.smem_bytes(cin, th, tw, s, k)
        assert staged <= fused_mbconv.SMEM_BUDGET


def test_weight_split_keeps_the_f32_weights():
    """hi = bf16(We), lo = bf16(We - hi), both We^T [Ce, Cin]: hi + lo is We
    to 2^-16 of each weight (the bound is 2^-18 from two roundings)."""
    we = torch.from_numpy(np.random.RandomState(30).normal(0, 0.3, (40, 96)).astype(np.float32))
    hi, lo = fused_mbconv.split_weights(we)
    assert hi.shape == lo.shape == (96, 40) and hi.dtype == lo.dtype == torch.bfloat16
    assert hi.is_contiguous() and lo.is_contiguous()
    back = (hi.float() + lo.float()).t()
    assert torch.all((back - we).abs() <= 2.0 ** -16 * we.abs())
    assert (hi.float().t() - we).abs().max() > 2.0 ** -12 * we.abs().max()  # lo matters


def bf16_excess(got, want, ulps, top_ulps):
    """Largest amount by which |got - want| exceeds ulps · ulp(|want|) +
    top_ulps · ulp(max |want|) in bf16 (8 significant bits); <= 0 passes."""
    got, want = got.float(), want.float()
    ulp = lambda t: torch.ldexp(torch.ones_like(t), torch.frexp(t.abs())[1] - 8)  # noqa: E731
    return float(((got - want).abs() - ulps * ulp(want) - top_ulps * ulp(want.abs().max())).max())


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_split_expand_emulation_matches_the_plain_version(k, s):
    """The bf16 kernel's arithmetic in f32 on the CPU: x · hi + x · lo
    (bf16 products, exact in f32), then b0, z's swish as v/2 + v/2 tanh(v/2)
    with tanh off by its approximation's 2^-11 relative error (either
    way), m1 and the rounding of z, then the plain depthwise and the exact
    swish. Within the tolerance the card's kernel is held to: 2 bf16 ulps
    plus 1 ulp of the largest y, SE sums to 1e-3 of the largest."""
    o = {n: torch.from_numpy(v) for n, v in operands(40 + k + s, k).items()}
    x = o["x"].bfloat16()
    hi, lo = fused_mbconv.split_weights(o["we"])
    acc = (torch.einsum("nchw,ec->nehw", x.float(), hi.float())
           + torch.einsum("nchw,ec->nehw", x.float(), lo.float()))
    y, se = fused_mbconv.fused_expand_dw_plain(x, o["we"], o["b0"], o["m1"], o["wd"], o["b1"],
                                               o["m2"], s, k)
    for tanh_err in (-2.0 ** -11, 2.0 ** -11):
        h = 0.5 * (acc + o["b0"][:, None, None])
        z = (h + h * torch.tanh(h) * (1 + tanh_err)) * o["m1"][:, :, None, None]
        z = z.bfloat16().float()
        a = fused_mbconv.depthwise_same(z, o["wd"], s) + o["b1"][:, None, None]
        a = torch.nn.functional.silu(a) * o["m2"][:, :, None, None]
        assert bf16_excess(a.bfloat16(), y, 2, 1) <= 0
        torch.testing.assert_close(a.sum((2, 3)), se, rtol=1e-3,
                                   atol=1e-3 * float(se.abs().max()))


D0_BLOCKS = [(a.input_filters, a.input_filters * a.expand_ratio, h, w, a.kernel_size,
              a.strides[0])
             for a, h, w in torch_effnet.block_input_sizes(
                 torch_effnet.backbone_spec("efficientnet-b0"), 256, 512)[1:]]
# the distinct expand blocks of B7 at d7x's 1536x768 (expand ratio above 1)
B7_BLOCKS = sorted({(a.input_filters, a.input_filters * a.expand_ratio, h, w, a.kernel_size,
                     a.strides[0])
                    for a, h, w in torch_effnet.block_input_sizes(
                        torch_effnet.backbone_spec("efficientnet-b7"), 384, 768)
                    if a.expand_ratio > 1})
# the shapes of the card tests (tests/test_torch_cuda.py) beside d0's blocks
# at 1024x512 and B7's at 1536x768
TC_PLAN_CASES = D0_BLOCKS + [(24, 40, 17, 70, 3, 1), (32, 96, 24, 40, 5, 2),
                             (16, 96, 20, 24, 3, 2), (192, 1152, 9, 13, 5, 1)] + B7_BLOCKS
# the tiles d0's blocks took before the weights were streamed, in block order
D0_TILES = [(4, 64), (8, 64), (4, 32), (8, 64), (4, 64), (8, 64), (8, 64), (8, 64), (8, 64),
            (8, 64), (4, 32), (16, 32), (16, 32), (16, 32), (16, 32)]


def plan_for(cin, h, w, k, s, vec=True):
    return fused_mbconv.tc_tile_shape(-(-h // s), -(-w // s), cin, s, k, vec)


@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("cin,ce,h,w,k,s", TC_PLAN_CASES)
def test_tc_tile_shape_fits_shared_memory(cin, ce, h, w, k, s, vec):
    """The bf16 kernel's tile planner, in either layout (streamed with the
    16-byte copies, ``vec``): a tile inside the output whose block fits the
    budget, so two blocks share an SM (228 KB, less 1 KB reserved and the
    static b0 and m1 of each)."""
    ho, wo = -(-h // s), -(-w // s)
    th, tw, streamed = plan_for(cin, h, w, k, s, vec)
    assert streamed == vec
    assert 1 <= th <= ho and 1 <= tw <= min(wo, 64)
    smem = fused_mbconv.tc_smem_bytes(cin, th, tw, s, k, streamed)
    assert smem <= fused_mbconv.TC_SMEM_BUDGET
    assert 2 * (smem + 8 * fused_mbconv.TC_CHANNEL_TILE + 1024) <= 228 * 1024


@pytest.mark.parametrize("cin,ce,h,w,k,s", TC_PLAN_CASES)
def test_tc_plan_stages_no_more_streamed_from_cin_64(cin, ce, h, w, k, s):
    """From Cin = 64 on, the ring's 16 channels of We^T a stage take no
    more room than the resident [32, Cin + 8] pair, so the streamed plan
    stages no more pixels per output than the resident one would."""
    streamed, resident = plan_for(cin, h, w, k, s), plan_for(cin, h, w, k, s, vec=False)
    key = [fused_mbconv.tc_staged_per_output(p.th, p.tw, s, k) for p in (streamed, resident)]
    assert cin < 64 or key[0] <= key[1]


@pytest.mark.parametrize("block", range(15))
def test_d0_blocks_plan_resident_with_their_tiles(block):
    """At d0's 1024x512 every expand block plans the tile it had when the
    weights stayed resident, without 16-byte copies (resident) and with
    them (streamed)."""
    cin, ce, h, w, k, s = D0_BLOCKS[block]
    assert plan_for(cin, h, w, k, s) == (*D0_TILES[block], True)
    assert plan_for(cin, h, w, k, s, vec=False) == (*D0_TILES[block], False)


def test_a_plan_of_the_other_layout_is_refused():
    """A launch takes the layout its operands' loads take: a resident plan
    for operands the 16-byte copies take, or a streamed one for operands
    they do not (the weights 2 bytes off an aligned address), is refused
    before the kernel is built or launched."""
    t = {n: torch.from_numpy(v) for n, v in operands(5, 3).items()}
    x = torch.zeros(2, 16, 8, 16, dtype=torch.bfloat16)
    we = torch.from_numpy(np.asarray(np.random.RandomState(5).normal(0, 0.25, (16, CE)),
                                     np.float32))
    split = fused_mbconv.split_weights(we)
    off = tuple(torch.empty(v.numel() + 1, dtype=v.dtype)[1:].view(v.shape).copy_(v)
                for v in split)
    assert all(v.data_ptr() % 16 for v in off) and x.data_ptr() % 16 == 0
    args = (x, we, t["b0"], None, t["wd"], t["b1"], None, 1, 3, "swish")
    streamed, resident = fused_mbconv.Plan(8, 16, True), fused_mbconv.Plan(8, 16, False)
    with pytest.raises(ValueError, match="resident plan for operands that take"):
        fused_mbconv._launch(*args, split, resident)
    with pytest.raises(ValueError, match="streamed plan for operands that do not take"):
        fused_mbconv._launch(*args, off, streamed)


def computed_per_output(cin, h, w, k, s, plan):
    """The pixels the expand computes per output pixel of the launch: every
    tile's staged window in whole 256-pixel passes, over the real outputs
    (ragged edge tiles included)."""
    ho, wo = -(-h // s), -(-w // s)
    th, tw, _ = plan
    staged = ((th - 1) * s + k) * (((tw - 1) * s + k + 14) // 8 * 8)
    passes = -(-staged // fused_mbconv.TC_PIXELS)
    return -(-ho // th) * -(-wo // tw) * passes * fused_mbconv.TC_PIXELS / (ho * wo)


def test_b7_widest_block_streams_with_little_halo():
    """B7's Cin = 640 blocks (24x48, k3 s1): the resident We^T leaves z room
    for a 1x8 tile only (32 computed pixels an output); streamed, a 16x48
    tile computes at most 2.5."""
    (case,) = [c for c in B7_BLOCKS if c[0] == 640]
    cin, ce, h, w, k, s = case
    assert (h, w, k, s) == (24, 48, 3, 1)
    assert plan_for(cin, h, w, k, s, vec=False) == (1, 8, False)
    plan = plan_for(cin, h, w, k, s)
    assert plan == (16, 48, True)
    assert computed_per_output(cin, h, w, k, s, plan) <= 2.5
    assert computed_per_output(cin, h, w, k, s, (1, 8, False)) == 32


def test_b7_streams_27_of_its_51_expand_launches():
    """B7's expand blocks at 1536x768: 51 launches, every one streamed.
    Streaming changes the tiles of 27, at Cin 80 (stride 2), 224, 384 and
    640, and from Cin 224 on those compute fewer pixels an output than the
    resident weights left room for; the other 24 keep their tiles. (At Cin
    80, stride 2, the planner's key, blind to a ragged last column of
    tiles, takes 4x64 over 4x32 though it computes more.)"""
    blocks = [(a.input_filters, h, w, a.kernel_size, a.strides[0])
              for a, h, w in torch_effnet.block_input_sizes(
                  torch_effnet.backbone_spec("efficientnet-b7"), 384, 768)
              if a.expand_ratio > 1]
    wider = [b for b in blocks if plan_for(*b)[:2] != plan_for(*b, vec=False)[:2]]
    assert len(blocks) == 51 and all(plan_for(*b).streamed for b in blocks)
    assert len(wider) == 27
    assert {(b[0], b[4]) for b in wider} == {(80, 2), (224, 1), (224, 2), (384, 1), (640, 1)}
    for b in (b for b in wider if b[0] >= 224):
        assert (computed_per_output(*b, plan_for(*b))
                < computed_per_output(*b, plan_for(*b, vec=False)))


def test_d0_has_fifteen_expand_blocks():
    assert len(D0_BLOCKS) == 15 and D0_BLOCKS[0] == (16, 96, 256, 512, 3, 2)
    assert D0_BLOCKS[-1] == (192, 1152, 16, 32, 3, 1)


def random_block_variables(block, x, seed):
    """{'params', 'batch_stats'} of the flax block as numpy draws: lecun
    kernels, BN scales and variances in [0.5, 1.5], small biases."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: block.init(jax.random.PRNGKey(0), x, False))

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, np.sqrt(1.0 / np.prod(leaf.shape[:-1])), leaf.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape)
        return rng.normal(0, 0.1, leaf.shape)

    tree = jax.tree_util.tree_map_with_path(
        lambda p, l: np.asarray(draw(p, l), np.float32), shapes)
    return {k: jax.tree_util.tree_map(np.asarray, dict(v)) for k, v in tree.items()}


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("expand", [1, 6])
def test_mbconv_block_matches_flax_with_recorded_masks(k, s, expand):
    cin, cout, rate = 16, 16 if s == 1 else 24, 0.2
    args = dict(kernel_size=k, num_repeat=1, input_filters=cin, output_filters=cout,
                expand_ratio=expand, id_skip=True, se_ratio=0.25, strides=(s, s))
    flax_block = jax_effnet.MBConvBlock(jax_effnet.BlockArgs(**args), mc_dropoutrate=rate)
    rng = np.random.RandomState(100 + 10 * k + s + expand)
    x = rng.normal(0, 1, (2, 12, 12, cin)).astype(np.float32)
    v = random_block_variables(flax_block, jnp.asarray(x), seed=k + s + expand)
    rec = RecordingDropout(rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_effnet, "spatial_dropout", rec)
        want = flax_block.apply(v, jnp.asarray(x), False)
    assert len(rec.bits) == (2 if expand > 1 else 1)

    block = torch_effnet.MBConvBlock(torch_effnet.BlockArgs(**args), cin, mc_dropoutrate=rate)
    block.load_state_dict(flax_to_torch(v["params"], v["batch_stats"]), strict=True)
    assert block.residual == (s == 1)
    block.prepare_inference()
    masks = MaskTable(rec.bits)
    with torch.inference_mode():
        got = block(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), masks)
    assert masks.tables == []
    # f32; the expand, depthwise, SE and project sums run in other orders
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)
