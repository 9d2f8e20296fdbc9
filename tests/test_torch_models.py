"""The PyTorch port's EfficientDet against the JAX package, MC off.

The same numpy weights go through the flax modules and, converted by
``convert.py``, through the port; the same numpy images go through both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import IMAGE, configs, random_variables, torch_model  # noqa: E402
from udal_tpu.models.efficientdet import EfficientDetNet as JaxNet  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch, load_flax  # noqa: E402
from udal_tpu_torch.models.efficientdet import EfficientDetNet, init_flax_style  # noqa: E402

# Both sides compute in float32. XLA and PyTorch's CPU convolutions sum in
# different orders, which moves the last bits of each conv output; through
# the network that grows to about 1e-5 absolute on outputs of magnitude
# ~10 (measured), well inside these bounds.
ATOL, RTOL = 1e-4, 1e-3


def nchw(a):
    return torch.from_numpy(np.array(a).transpose(0, 3, 1, 2).copy())


def assert_close_nhwc(got_nchw, want_nhwc):
    np.testing.assert_allclose(got_nchw.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_nhwc), atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def case():
    jax_cfg, torch_cfg = configs()
    variables = random_variables(jax_cfg, seed=0)
    images = np.random.RandomState(1).uniform(
        -2.0, 2.0, (2, IMAGE, IMAGE, 3)).astype(np.float32)

    def capture(mdl, method_name):
        return method_name == "__call__" and mdl.name in ("backbone", "fpn_cells")

    (cls, box), state = JaxNet(jax_cfg).apply(
        variables, jnp.asarray(images), False, capture_intermediates=capture,
        mutable=["intermediates"])
    inter = state["intermediates"]
    return dict(jax_cfg=jax_cfg, torch_cfg=torch_cfg, variables=variables,
                images=images, model=torch_model(torch_cfg, variables),
                backbone=inter["backbone"]["__call__"][0],
                fpn=inter["fpn_cells"]["__call__"][0], cls=cls, box=box)


def test_parameter_count_equals_flax_tree(case):
    want = sum(int(np.prod(v.shape))
               for v in jax.tree_util.tree_leaves(case["variables"]["params"]))
    assert sum(p.numel() for p in case["model"].parameters()) == want


def test_converter_places_every_leaf_and_rejects_leftovers(case):
    params, stats = case["variables"]["params"], case["variables"]["batch_stats"]
    model = EfficientDetNet(case["torch_cfg"])
    state = flax_to_torch(params, stats)
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(
        state["backbone.blocks_1.depthwise_conv.weight"].numpy(),
        params["backbone"]["blocks_1"]["depthwise_conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["class_net.stack.class-0-bn-3.running_var"].numpy(),
        stats["class_net"]["stack"]["class-0-bn-3"]["bn"]["var"])

    extra = {**params, "stray": {"kernel": np.zeros((1, 1, 2, 2), np.float32)}}
    with pytest.raises(KeyError, match="unplaced"):
        load_flax(model, extra, stats)
    short = {k: v for k, v in params.items() if k != "box_net"}
    with pytest.raises(KeyError, match="missing"):
        load_flax(model, short, stats)
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_torch({**params, "odd": {"gamma": np.zeros(2, np.float32)}}, stats)


def test_backbone_endpoints_match(case):
    with torch.inference_mode():
        got = case["model"].backbone(nchw(case["images"]))
    assert len(got) == len(case["backbone"]) == 6
    for g, w in zip(got, case["backbone"]):
        assert_close_nhwc(g, w)


def test_bifpn_outputs_match(case):
    with torch.inference_mode():
        got = case["model"].features(nchw(case["images"]))
    assert len(got) == len(case["fpn"]) == 5
    for g, w in zip(got, case["fpn"]):
        assert_close_nhwc(g, w)


def test_heads_match_on_the_same_features(case):
    with torch.inference_mode():
        cls, box = case["model"].predict_heads([nchw(f) for f in case["fpn"]])
    for g, w in zip(cls + box, list(case["cls"]) + list(case["box"])):
        assert_close_nhwc(g, w)


def test_whole_network_matches(case):
    with torch.inference_mode():
        cls, box = case["model"](torch.from_numpy(case["images"]))
    for g, w in zip(cls + box, list(case["cls"]) + list(case["box"])):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_random_init_follows_flax_initializers():
    """Backbone convs variance_scaling(2, fan_out, normal); head convs
    variance_scaling(1, fan_in, truncated normal at ±2σ); the class bias the
    focal prior; edge weights and BatchNorm at their flax defaults."""
    _, torch_cfg = configs()
    model = EfficientDetNet(torch_cfg)
    init_flax_style(model, torch.Generator().manual_seed(0))
    w = model.backbone.blocks_15.project_conv.weight          # [320, 1152, 1, 1]
    assert abs(w.std().item() / np.sqrt(2.0 / w.shape[0]) - 1) < 0.05
    head = model.class_net["stack"]["class-0"].pointwise.weight
    assert abs(head.std().item() / np.sqrt(1.0 / head.shape[1]) - 1) < 0.05
    assert head.abs().max().item() <= 2 * np.sqrt(1.0 / head.shape[1]) / 0.87962566103423978
    bias = model.class_net["class-predict"].pointwise.bias
    assert torch.allclose(bias, torch.full_like(bias, -np.log(99.0)))
    assert torch.equal(model.box_net["box-predict"].pointwise.bias,
                       torch.zeros_like(model.box_net["box-predict"].pointwise.bias))
    assert torch.equal(model.fpn_cells.cell_0.fnode4.edge_weights, torch.ones(3))
    bn = model.fpn_cells.cell_0.fnode4.bn
    assert torch.equal(bn.running_var, torch.ones(64)) and torch.equal(bn.weight, torch.ones(64))


def test_sum_fusion_over_six_levels_matches():
    """d7x's topology at d0's widths: sum fusion (no edge weights) and a
    six-level pyramid with P8 pooled from P7, six per-level tower
    BatchNorms, on a 256x256 canvas (P8 1x1), two cells and two repeats;
    the whole network and each BiFPN output against the flax modules."""
    extra = dict(image_size="256x256", fpn_weight_method="sum", max_level=8,
                 fpn_cell_repeats=2, box_class_repeats=2)
    jax_cfg, torch_cfg = configs(extra=extra)
    variables = random_variables(jax_cfg, seed=3, image=256)
    assert not any("edge_weights" in str(path) for path, _ in
                   jax.tree_util.tree_leaves_with_path(variables["params"]))
    images = np.random.RandomState(4).uniform(-2.0, 2.0, (2, 256, 256, 3)).astype(np.float32)
    (cls, box), state = JaxNet(jax_cfg).apply(
        variables, jnp.asarray(images), False,
        capture_intermediates=lambda mdl, name: name == "__call__" and mdl.name == "fpn_cells",
        mutable=["intermediates"])
    model = torch_model(torch_cfg, variables)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(variables["params"]))
    with torch.inference_mode():
        feats = model.features(nchw(images))
        got_cls, got_box = model(torch.from_numpy(images))
    want = state["intermediates"]["fpn_cells"]["__call__"][0]
    assert len(want) == 6
    assert [tuple(f.shape[2:]) for f in feats] == [(32, 32), (16, 16), (8, 8), (4, 4),
                                                  (2, 2), (1, 1)]
    for g, w in zip(feats, want):
        assert_close_nhwc(g, w)
    assert len(got_cls) == len(cls) == 6
    for g, w in zip(got_cls + got_box, list(cls) + list(box)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
