"""The port's on-device bilinear warp against ``udal_tpu/ops/image_ops.py``.

Per image a scale and a crop offset (y, x) as the device-resize reader
makes them; downscales and upscales, crops that start inside the scaled
image, and canvases that reach past it (zero there). Both sides compute
in f32 from the same uint8 or f32 pixels; the weight matrices are the
same expressions, the contraction order differs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu.ops import image_ops as jax_image_ops  # noqa: E402
from udal_tpu_torch.ops import image_ops  # noqa: E402

OUT = (48, 64)
CASES = {
    # (scale_y, scale_x, off_y, off_x) per image
    "downscale": [(0.5, 0.375, 0.0, 0.0), (0.8, 0.6, 3.0, 7.0)],
    "upscale": [(1.5, 2.0, 0.0, 0.0), (1.25, 1.75, 5.0, 11.0)],
    "past the image": [(0.3, 0.25, 0.0, 0.0), (2.0, 2.5, 30.0, 60.0)],
}


def images(dtype, seed=0, shape=(2, 40, 56, 3)):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.uniform(0, 255, shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "f32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_resize_batch_matches(dtype, case):
    x = images(dtype, seed=len(case))
    warp = np.asarray(CASES[case], np.float32)
    got = image_ops.warp_resize_batch(torch.from_numpy(x), torch.from_numpy(warp[:, :2]),
                                      torch.from_numpy(warp[:, 2:]), OUT)
    want = np.asarray(jax_image_ops.warp_resize_batch(
        jnp.asarray(x), jnp.asarray(warp[:, :2]), jnp.asarray(warp[:, 2:]), OUT))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2,) + OUT + (3,)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-3
    if case == "past the image":
        # the canvas past the scaled image is zero on both sides
        assert np.all(want[0, 13:] == 0) and np.all(got.numpy()[0, :, 15:] == 0)


def test_warp_resize_single_is_one_image_of_the_batch():
    x = images(np.uint8, seed=9)
    warp = np.asarray(CASES["downscale"], np.float32)
    batch = image_ops.warp_resize_batch(torch.from_numpy(x), torch.from_numpy(warp[:, :2]),
                                        torch.from_numpy(warp[:, 2:]), OUT)
    one = image_ops.warp_resize_single(torch.from_numpy(x[1]), warp[1, :2], warp[1, 2:], OUT)
    want = np.asarray(jax_image_ops.warp_resize_single(
        jnp.asarray(x[1].astype(np.float32)), jnp.asarray(warp[1, :2]),
        jnp.asarray(warp[1, 2:]), OUT))
    torch.testing.assert_close(one, batch[1])
    assert float(np.abs(one.numpy() - want).max()) <= 1e-3


def test_identity_warp_is_exact():
    """Scale 1, offset 0 onto a canvas of the image's size: each output
    pixel samples its own source pixel with weight 1."""
    x = images(np.uint8, seed=4, shape=(1,) + OUT + (3,))
    got = image_ops.warp_resize_batch(torch.from_numpy(x), torch.ones(1, 2), torch.zeros(1, 2),
                                      OUT)
    np.testing.assert_array_equal(got.numpy(), x.astype(np.float32))
