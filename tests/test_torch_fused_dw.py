"""The port's fused depthwise (``udal_tpu_torch/ops/fused_dw.py``) against
the JAX package's TPU kernel ``udal_tpu/ops/pallas_dw.py``, run in
interpret mode on the CPU.

The same numpy inputs go to both: NHWC with the taps [k, k, C] on the JAX
side, NCHW with the taps [C, k, k] in the port. C = 128, the TPU kernel's
lane width. These are also the TPU kernel's first tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu.ops import pallas_dw  # noqa: E402
from udal_tpu_torch.ops import fused_dw  # noqa: E402

N, H, W, C = 2, 12, 16, 128
# Both sides compute in f32 from the same values; the k·k products are
# summed in another order, which moves the last bits of O(1) outputs.
ATOL, RTOL = 1e-5, 1e-5


def operands(seed, k):
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(x=f32(rng.normal(0, 1, (N, H, W, C))),
                taps=f32(rng.normal(0, 1.0 / k, (k, k, C))),
                scale=f32(rng.uniform(0.5, 1.5, C)), bias=f32(rng.normal(0, 0.1, C)),
                mask=f32((rng.uniform(size=(N, C)) < 0.8) / 0.8))


def port_args(o):
    return (torch.from_numpy(o["x"].transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(o["taps"].transpose(2, 0, 1).copy()),
            torch.from_numpy(o["scale"]), torch.from_numpy(o["bias"]))


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("act", ["swish", "relu", "identity"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask+mean", "plain"])
def test_plain_version_matches_the_tpu_kernel(k, s, act, masked):
    o = operands(k * 10 + s, k)
    mask = o["mask"] if masked else None
    want = pallas_dw.fused_depthwise(jnp.asarray(o["x"]), jnp.asarray(o["taps"]),
                                     jnp.asarray(o["scale"]), jnp.asarray(o["bias"]),
                                     None if mask is None else jnp.asarray(mask), stride=s,
                                     act=act, want_mean=masked, interpret=True)
    got = fused_dw.fused_depthwise(*port_args(o), None if mask is None else
                                   torch.from_numpy(mask), s, act, want_mean=masked)
    y, want_y = (got[0], want[0]) if masked else (got, want)
    assert tuple(y.shape) == (N, C, -(-H // s), -(-W // s))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(want_y),
                               atol=ATOL, rtol=RTOL)
    if masked:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL, rtol=RTOL)


def test_fold_bn_matches_the_jax_fold():
    """Both fold in f32; rsqrt may differ in the last ulp."""
    rng = np.random.RandomState(7)
    gamma, beta, mean = (rng.normal(0, 1, C).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.1, 2.0, C).astype(np.float32)
    want = pallas_dw.fold_bn(*(jnp.asarray(a) for a in (gamma, beta, mean, var)), 1e-3)
    got = fused_dw.fold_bn(*(torch.from_numpy(a) for a in (gamma, beta, mean, var)), 1e-3)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_same_pads_is_the_models_own():
    from udal_tpu_torch.models import efficientnet

    assert fused_dw.same_pads is efficientnet.same_pads
    for size in (7, 8, 15, 16):
        for k in (3, 5):
            for s in (1, 2):
                assert fused_dw.same_pads(size, k, s) == pallas_dw._same_pads(size, k, s)


def test_bf16_is_rounded_once_from_f32():
    """A bf16 input is computed in f32 and rounded once: y equals the f32
    result on the same values, rounded to bf16; the mean is the f32 one."""
    o = operands(3, 3)
    x, taps, scale, bias = port_args(o)
    mask = torch.from_numpy(o["mask"])
    xb = x.bfloat16()
    y, mean = fused_dw.fused_depthwise(xb, taps, scale, bias, mask, 2, "swish", True)
    want_y, want_mean = fused_dw.fused_depthwise(xb.float(), taps, scale, bias, mask, 2,
                                                 "swish", True)
    assert y.dtype == torch.bfloat16 and mean.dtype == torch.float32
    assert torch.equal(y, want_y.bfloat16())
    assert torch.equal(mean, want_mean)


def test_wrapper_checks_its_operands():
    o = operands(4, 3)
    x, taps, scale, bias = port_args(o)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_dw.fused_depthwise(x.half(), taps, scale, bias)
    with pytest.raises(ValueError, match="k in"):
        fused_dw.fused_depthwise(x, torch.zeros(C, 7, 7), scale, bias)
    with pytest.raises(ValueError, match="mask"):
        fused_dw.fused_depthwise(x, taps, scale, bias, torch.ones(N, C - 1))
    with pytest.raises(ValueError, match="activation"):
        fused_dw.fused_depthwise(x, taps, scale, bias, act="gelu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_dw.fused_depthwise_cuda(x, taps, scale, bias)
