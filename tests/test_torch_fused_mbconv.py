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
    for ho, wo, cin, s, k in [(128, 256, 16, 2, 3), (64, 128, 24, 2, 5),
                              (16, 32, 192, 1, 5), (3, 200, 320, 2, 5)]:
        for itemsize in (2, 4):
            th, tw = fused_mbconv.tile_shape(ho, wo, cin, s, k, itemsize)
            assert 1 <= th <= ho and 1 <= tw <= min(wo, 64)
            staged = (cin * fused_mbconv.CHANNEL_TILE * 4 + fused_mbconv.CHANNEL_TILE
                      * ((th - 1) * s + k) * ((tw - 1) * s + k) * itemsize)
            assert staged <= fused_mbconv.SMEM_BUDGET


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
