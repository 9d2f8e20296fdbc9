"""The segmentation head and ``EfficientDetModel`` of the port against flax's.

flax's ``ConvTranspose(padding="SAME")`` dilates its input by the stride,
pads it as ``jax.lax``'s ``_conv_transpose_padding`` says and correlates
with its kernel unflipped; the port's ``ConvTransposeSame`` takes the
flipped kernel (``convert.py``) through ``conv_transpose2d`` and cuts or
extends the padding to flax's. Then the whole head, and the model with its
pre- and post-processing in every (``pre_mode``, ``post_mode``) pair, with
the segmentation head beside the detection heads.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import IMAGE, SEGMENTATION, configs, random_variables  # noqa: E402
from tests.test_torch_serving_surface import assert_same_packed  # noqa: E402
from udal_tpu.models.efficientdet import EfficientDetModel as JaxModel  # noqa: E402
from udal_tpu.models.heads import SegmentationHead as JaxSeg  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch, load_flax, torch_to_flax  # noqa: E402
from udal_tpu_torch.models.efficientdet import EfficientDetModel  # noqa: E402
from udal_tpu_torch.models.heads import ConvTransposeSame, SegmentationHead  # noqa: E402

ATOL, RTOL = 1e-4, 1e-3
B = 2


def numpy_tree(tree, seed):
    """The variable tree's leaves redrawn from ``seed`` (BN scales and
    variances in [0.5, 1.5], kernels at lecun scale, the rest N(0, 0.1))."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0, np.sqrt(1.0 / np.prod(leaf.shape[:-1])), leaf.shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            v = rng.normal(0, 0.1, leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree_util.tree_map(np.asarray, tree))


def strip(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


@pytest.mark.parametrize("k,s", [(3, 2), (3, 1), (2, 2), (4, 2), (3, 4)])
def test_conv_transpose_same_matches_flax(k, s):
    """(3, 4) pads past flax's k - 1 at the end (zeros, then the bias)."""
    conv = fnn.ConvTranspose(5, (k, k), strides=(s, s), padding="SAME")
    x = np.random.RandomState(k * 10 + s).normal(0, 1, (B, 7, 6, 4)).astype(np.float32)
    variables = numpy_tree(conv.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=s)
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    port = ConvTransposeSame(4, 5, k, s)
    state = strip(flax_to_torch({"seg_head": {"c": variables["params"]}}, {}), "seg_head.c.")
    port.load_state_dict(state)
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape == (B, 7 * s, 6 * s, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_segmentation_head_matches_flax():
    head = JaxSeg(num_classes=3, num_filters=16, num_levels=5)
    rng = np.random.RandomState(1)
    feats = [rng.normal(0, 1, (B, 32 >> i, 32 >> i, 16)).astype(np.float32) for i in range(5)]
    variables = numpy_tree(head.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats],
                                     False), seed=2)
    want = np.asarray(head.apply(variables, [jnp.asarray(f) for f in feats], False))
    port = SegmentationHead(3, 16, 5)
    state = flax_to_torch({"seg_head": variables["params"]},
                          {"seg_head": variables["batch_stats"]})
    port.load_state_dict(strip(state, "seg_head."))
    with torch.inference_mode():
        got = port([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    assert tuple(got.shape) == (B, 3, 64, 64) and want.shape == (B, 64, 64, 3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=RTOL)
    # torch_to_flax gives flax's kernels back
    params, _ = torch_to_flax(port)
    for name in ("up0", "logits"):
        np.testing.assert_array_equal(params[name]["kernel"],
                                      variables["params"][name]["kernel"])


@pytest.fixture(scope="module")
def seg_case():
    jax_cfg, torch_cfg = configs(extra=dict(SEGMENTATION, enable_softmax=True))
    variables = random_variables(jax_cfg, seed=15)
    model = EfficientDetModel(torch_cfg)
    load_flax(model, variables["params"], variables["batch_stats"])
    rng = np.random.RandomState(16)
    return dict(jax_cfg=jax_cfg, variables=variables, model=model.eval(),
                raw={"infer": rng.randint(0, 256, (B, 100, 160, 3)).astype(np.uint8),
                     None: rng.uniform(-2, 2, (B, IMAGE, IMAGE, 3)).astype(np.float32)})


POST_MODES = ("global", "per_class", None)


def jax_outputs(seg_case, pre_mode):
    """The JAX package's model in each post mode at ``pre_mode``: the three
    calls in one jitted program, compiled once a pre mode."""
    cache = seg_case.setdefault("jax", {})
    if pre_mode not in cache:
        model = JaxModel(seg_case["jax_cfg"])
        cache[pre_mode] = jax.jit(lambda v, x: tuple(
            model.apply(v, x, False, pre_mode=pre_mode, post_mode=post)
            for post in POST_MODES))(seg_case["variables"], seg_case["raw"][pre_mode])
    return dict(zip(POST_MODES, cache[pre_mode]))


@pytest.mark.parametrize("post_mode", POST_MODES)
@pytest.mark.parametrize("pre_mode", ["infer", None])
def test_efficientdet_model_matches_in_every_mode(seg_case, pre_mode, post_mode):
    raw = seg_case["raw"][pre_mode]
    want = jax_outputs(seg_case, pre_mode)[post_mode]
    with torch.inference_mode():
        got = seg_case["model"](torch.from_numpy(raw), pre_mode=pre_mode, post_mode=post_mode)
    seg_got, seg_want = got[-1], np.asarray(want[-1])
    assert tuple(seg_got.shape) == seg_want.shape == (B, IMAGE // 4, IMAGE // 4, 3)
    np.testing.assert_allclose(seg_got.numpy(), seg_want, atol=ATOL, rtol=RTOL)
    if post_mode is None:     # the raw outputs: per-level class and box maps
        for g, w in zip(got[0] + got[1], list(want[0]) + list(want[1])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    else:                     # the packed tuple (with the logits), then the seg logits
        assert len(got) == len(want) == 6
        assert_same_packed(got[:5], want[:5])
