"""The port's train and eval steps against the JAX package's, on the CPU.

EfficientDet-d0 at its published widths cut to a 64x64 input, one BiFPN
cell, one head repeat, 8 classes, loss attenuation, MC dropout 0.05 and
batch 2, from the same numpy weights (``tests/test_torch_fixtures.py``).
The batch is in the reader's fast-input contract (uint8 frames, compact
groundtruth with a pseudo-score column, valid sizes), so both sides also
prepare it and assign the targets themselves.

JAX's ``train_step`` is jitted once per configuration, with its
``spatial_dropout`` patched (in ``udal_tpu.models.efficientnet`` and
``udal_tpu.models.heads``, which imports it by name) to multiply by masks
given as inputs, and ``clip_gradients`` patched to hand out the clipped
gradients it returns; nothing in ``udal_tpu`` changes. The port replays
the same keep bits through a mask source (``MaskTable``) in its own draw
order. Dropout off is the JAX program with all-ones masks against the
port's model without dropout.

Both sides run in f32 and sum in different orders. The random network's
gradients are ill-conditioned (the σ floor of 0.01 scales the attenuation
NLL by 1e4, and the BatchNorms of the 1x1 and 2x2 levels see two and eight
values a channel): JAX's f32 gradients are as close to the port's f64
ones as the port's own f32 ones are
(``test_jax_gradients_are_as_close_to_f64_as_the_ports``), and the
differences grow through the updates. So the steps run at the config's
rate (0.0025 here, no warmup), the gradients are compared as a tree
(relative L2) and leaf by leaf after one step (``assert_grads_close``),
and the weights, statistics and EMA leaf by leaf.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

import udal_tpu.models.efficientnet as jax_effnet  # noqa: E402
import udal_tpu.models.heads as jax_heads  # noqa: E402
import udal_tpu.train.train_lib as jax_train_lib  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import random_variables, small_overrides  # noqa: E402
from tests.test_torch_mc import MaskTable  # noqa: E402
from udal_tpu import config as jax_config  # noqa: E402
from udal_tpu.models.efficientdet import EfficientDetNet as JaxNet  # noqa: E402
from udal_tpu.train import schedules as jax_schedules  # noqa: E402
from udal_tpu_torch import config as torch_config  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch, params_to_flax, torch_to_flax  # noqa: E402
from udal_tpu_torch.convert import train_state_to_flax  # noqa: E402
from udal_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from udal_tpu_torch.models.efficientnet import BatchNorm  # noqa: E402
from udal_tpu_torch.ops import fused_dw, fused_mbconv  # noqa: E402
from udal_tpu_torch.train import train_lib  # noqa: E402
from udal_tpu_torch.train.schedules import clip_gradients  # noqa: E402

B, IMAGE, SPE, STEPS = 2, 64, 10, 3
RATE = 0.05
# no warmup: the config's rate scaled to the batch, 0.08·B/64 = 0.0025, from step 0
TRAIN = dict(image_size=IMAGE, batch_size=B, lr_warmup_epoch=0.0)
# losses and gradient norms: relative
LOSS_RTOL = 2e-4
# parameters, batch statistics, EMA: each leaf within this fraction of its largest value
TREE_TOL = 2e-4
# gradients (and the momentum, their sum): the whole tree's relative L2 error; after one
# step, each leaf that is not noise within GRAD_LEAF_TOL of its largest value
GRAD_L2_TOL, GRAD_LEAF_TOL = 1e-2, 3e-2


def train_configs(mc: bool = True, **extra):
    """(JAX config, port config) of the reduced d0 with ``TRAIN`` and ``extra``."""
    out = []
    for api in (jax_config, torch_config):
        cfg = api.get_detection_config("efficientdet-d0")
        cfg.override(small_overrides(mc))
        cfg.override({**TRAIN, **extra}, allow_new_keys=True)
        out.append(cfg)
    return tuple(out)


def make_batch(seed: int, pseudo: bool = True, batch: int = B):
    """uint8 frames and compact groundtruth (1-4 boxes a frame, 6 rows),
    the valid sizes cut below the frame, and a pseudo-score column."""
    rng = np.random.RandomState(seed)
    images, labels = synthetic_batch(rng, batch, IMAGE, IMAGE, 8, max_objects=4,
                                     max_instances=6)
    labels["valid_hw"] = np.asarray([[IMAGE, IMAGE - 14 * (b % 2)] for b in range(batch)],
                                    np.int32)
    if pseudo:
        labels["gt_pseudo"] = np.where(labels["gt_classes"] > 0,
                                       rng.uniform(0.5, 1.0, labels["gt_classes"].shape),
                                       -1.0).astype(np.float32)
    return images, labels


def jax_state(jax_cfg, variables):
    """The JAX TrainState of ``variables`` (no flax init), and its tx and
    schedule."""
    tx, schedule = jax_schedules.make_optimizer(jax_cfg, SPE)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jax_train_lib.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params)
        if jax_cfg.moving_average_decay else None)
    return state, tx, schedule


def jax_stepper(jax_cfg, tx, schedule, dtype=jnp.float32, compiler_options=None):
    """jit(state, images, labels, masks) → (state, values, clipped grads):
    JAX's ``train_step`` with each dropout site multiplied by the next of
    ``masks`` ([N, C] f32 multipliers) and the gradients ``clip_gradients``
    returns handed out. ``dtype=bfloat16`` builds the model as JAX's
    mixed precision does; ``compiler_options`` go to XLA."""
    model = JaxNet(jax_cfg, dtype=dtype)

    def step(state, images, labels, masks):
        sites = iter(masks)
        captured = {}

        def dropout(module, x, rate, active):
            if rate <= 0.0 or not active:
                return x
            m = next(sites)
            assert m.shape == (x.shape[0], x.shape[-1]), (m.shape, x.shape)
            return x * m.reshape((x.shape[0],) + (1,) * (x.ndim - 2) +
                                 (x.shape[-1],)).astype(x.dtype)

        def clip(grads, clip_norm):
            grads, norm = jax_schedules.clip_gradients(grads, clip_norm)
            captured["grads"] = grads
            return grads, norm

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_effnet, "spatial_dropout", dropout)
            mp.setattr(jax_heads, "spatial_dropout", dropout)
            mp.setattr(jax_train_lib, "clip_gradients", clip)
            state, vals = jax_train_lib.train_step(jax_cfg, model, tx, schedule, SPE, state,
                                                   images, labels, jax.random.PRNGKey(0))
        assert next(sites, None) is None, "more masks than dropout sites"
        return state, vals, captured["grads"]

    return jax.jit(step, compiler_options=compiler_options)


class RecordingSource:
    """A mask source that keeps everything and records each draw's shape."""

    def __init__(self):
        self.shapes = []

    def draw(self, n, c, keep, device):
        self.shapes.append((n, c))
        return torch.ones((n, c), dtype=torch.bool, device=device)


def site_shapes(torch_cfg, images, labels, ssl=False):
    """The port's draw order and shapes in one training forward (twice
    with CSD), from a copy of a fresh model."""
    state, schedule = train_lib.create_train_state(torch_cfg, SPE, device="cpu")
    rec = RecordingSource()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_lib, "ChannelDropout", lambda generator: rec)
        train_lib.train_step(torch_cfg, schedule, SPE, state, images, labels)
    return rec.shapes


def keep_bits(rng, shapes):
    return [rng.uniform(size=s) < 1.0 - RATE for s in shapes]


def multipliers(bits):
    return [b.astype(np.float32) / np.float32(1.0 - RATE) for b in bits]


def port_state(torch_cfg, variables):
    v = variables
    return train_lib.create_train_state(torch_cfg, SPE, device="cpu",
                                        state_dict=flax_to_torch(v["params"], v["batch_stats"]))


def run_port(torch_cfg, state, schedule, batches, tables, monkeypatch):
    """``train_step`` over ``batches``, step i replaying ``tables[i]``;
    returns each step's values and clipped gradients (flax layout)."""
    sources = iter([MaskTable(t) for t in tables])
    monkeypatch.setattr(train_lib, "ChannelDropout", lambda generator: next(sources))
    out = []
    for images, labels in batches:
        state, vals = train_lib.train_step(torch_cfg, schedule, SPE, state, images, labels)
        grads = params_to_flax(state.model, {n: p.grad for n, p in
                                             state.model.named_parameters()})
        out.append(({k: float(v) for k, v in vals.items()}, grads))
    return out


def leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, tree)))


def assert_tree_close(got, want, tol=TREE_TOL, what=""):
    """Same leaves; each within ``tol`` of the leaf's largest magnitude."""
    g, w = leaves(got), leaves(want)
    assert sorted(map(str, g)) == sorted(map(str, w)), what
    for path, want_v in w.items():
        got_v = g[path]
        assert got_v.shape == want_v.shape, (what, path)
        scale = max(float(np.max(np.abs(want_v))), 1e-6)
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=tol * scale,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def assert_values_close(got, want, what=""):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=f"{what} {k}")
    assert set(got) == set(want), (what, set(got) ^ set(want))


def assert_grads_close(got, want, per_leaf: bool, what=""):
    """The whole tree within ``GRAD_L2_TOL`` (relative L2) and, with
    ``per_leaf``, each leaf whose norm is at least 1% of the largest
    leaf's within ``GRAD_LEAF_TOL`` of its largest value. (Smaller leaves
    are rounding noise: a bias whose output a train-mode BatchNorm
    normalises has a zero gradient but for rounding.)"""
    g, w = leaves(got), leaves(want)
    assert sorted(map(str, g)) == sorted(map(str, w)), what
    err = np.sqrt(sum(float(np.sum((g[p] - v) ** 2)) for p, v in w.items()))
    norm = np.sqrt(sum(float(np.sum(v ** 2)) for v in w.values()))
    assert err <= GRAD_L2_TOL * norm, (what, err / norm)
    if per_leaf:
        norms = {p: float(np.linalg.norm(v)) for p, v in w.items()}
        large = max(norms.values())
        for path, v in w.items():
            if norms[path] >= 1e-2 * large:
                np.testing.assert_allclose(
                    g[path], v, rtol=0, atol=GRAD_LEAF_TOL * float(np.max(np.abs(v))),
                    err_msg=f"{what} {jax.tree_util.keystr(path)}")


def assert_state_close(state, want, what, per_leaf=True):
    """Parameters, batch statistics, SGD trace and EMA after the steps."""
    got = train_state_to_flax(state)
    assert got["step"] == int(want.step)
    assert_tree_close(got["params"], want.params, what=f"{what} params")
    assert_tree_close(got["batch_stats"], want.batch_stats, what=f"{what} batch_stats")
    assert_grads_close(got["opt_state"]["trace"], want.opt_state[0].trace, per_leaf,
                       f"{what} momentum")
    assert (got["ema_params"] is None) == (want.ema_params is None)
    if want.ema_params is not None:
        assert_tree_close(got["ema_params"], want.ema_params, what=f"{what} ema")


@pytest.fixture(scope="module")
def setup():
    jax_cfg, torch_cfg = train_configs()
    variables = random_variables(jax_cfg, seed=11)
    state, tx, schedule = jax_state(jax_cfg, variables)
    step = jax_stepper(jax_cfg, tx, schedule)
    batches = [make_batch(20 + i) for i in range(STEPS)]
    shapes = site_shapes(torch_cfg, *batches[0])
    bits = [keep_bits(np.random.RandomState(30 + i), shapes) for i in range(STEPS)]
    return dict(jax_cfg=jax_cfg, torch_cfg=torch_cfg, variables=variables, state=state,
                step=step, batches=batches, shapes=shapes, bits=bits)


def test_dropout_sites_in_order(setup):
    """Blocks 1-15 draw twice (expand, depthwise), block 0 once, then the
    class head and the box head once a level."""
    assert len(setup["shapes"]) == 1 + 2 * 15 + 2 * 5
    assert setup["shapes"][0] == (B, 32) and setup["shapes"][1] == (B, 96)
    assert setup["shapes"][-1] == (B, 64)


@pytest.mark.parametrize("mc", [False, True], ids=["dropout_off", "mc_dropout"])
def test_train_steps_match_jax(setup, mc, monkeypatch):
    """Steps 1 and 3 from the same variables: the loss dict (loss, its
    parts, gradient norm, learning rate), the clipped gradients, and after
    each step the parameters, batch statistics, momentum and EMA."""
    jax_cfg, torch_cfg = setup["jax_cfg"], train_configs(mc=mc)[1]
    state = setup["state"]
    want = []
    for i, (images, labels) in enumerate(setup["batches"]):
        masks = (multipliers(setup["bits"][i]) if mc else
                 [np.ones(s, np.float32) for s in setup["shapes"]])
        state, vals, grads = setup["step"](state, images, labels, masks)
        want.append((vals, grads, state))
    pstate, schedule = port_state(torch_cfg, setup["variables"])
    tables = setup["bits"] if mc else [[] for _ in range(STEPS)]
    got = []
    for i, batch in enumerate(setup["batches"]):
        got += run_port(torch_cfg, pstate, schedule, [batch], [tables[i]], monkeypatch)
        if i in (0, STEPS - 1):
            vals, grads, jstate = want[i]
            assert_values_close(got[i][0], vals, f"step {i + 1}")
            assert_grads_close(got[i][1], grads, i == 0, f"step {i + 1} gradients")
            assert_state_close(pstate, jstate, f"step {i + 1}", i == 0)
    assert got[0][0]["gradient_norm"] > 0 and got[0][0]["learning_rate"] > 0


@pytest.mark.parametrize("contract", ["classic", "uint8", "native_warp"])
def test_prepare_batch_matches_jax(contract):
    """The three batch contracts: normalised f32 with per-level targets
    (passed through), network-size uint8 with compact groundtruth and
    valid sizes, and native-size uint8 with warp parameters (resized on the
    device first): the same images (to 1e-4 on the normalised scale, the
    warp within 1e-3 of the 0-255 scale before it) and the same labels."""
    jax_cfg, torch_cfg = train_configs(mc=False)
    images, labels = make_batch(80)
    if contract == "classic":
        from udal_tpu_torch.data.labels import build_labels

        images = np.random.RandomState(81).uniform(-2, 2, images.shape).astype(np.float32)
        labels = {k: v.numpy() for k, v in build_labels(
            torch_cfg, labels["gt_boxes"], labels["gt_classes"]).items()}
    elif contract == "native_warp":
        images = np.random.RandomState(82).randint(0, 256, (B, 50, 90, 3)).astype(np.uint8)
        scale = min(IMAGE / 50, IMAGE / 90)
        labels["warp_scale"] = np.asarray([[int(50 * scale) / 50, int(90 * scale) / 90]] * B,
                                          np.float32)
        labels["warp_offset"] = np.zeros((B, 2), np.float32)
        labels["valid_hw"] = np.asarray([[int(50 * scale), int(90 * scale)]] * B, np.int32)
    want_images, want_labels = jax_train_lib.prepare_batch(jax_cfg, jnp.asarray(images),
                                                           dict(labels))
    got_images, got_labels = train_lib.prepare_batch(torch_cfg, images, labels, "cpu")
    atol = 1e-3 / 58.0 if contract == "native_warp" else 1e-4      # 58: the smallest std
    np.testing.assert_allclose(got_images.numpy(), np.asarray(want_images), rtol=0, atol=atol)
    assert set(got_labels) == set(want_labels)
    for k, w in want_labels.items():
        np.testing.assert_allclose(got_labels[k].numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_eval_step_matches_jax(setup):
    """The validation loss's parts in eval mode (running statistics; each
    MBConv front half through the fused call's plain version here). Without
    MC dropout: JAX's ``eval_step`` passes no dropout key."""
    jax_cfg, torch_cfg = train_configs(mc=False)
    images, labels = make_batch(40, pseudo=False)
    want = jax.jit(lambda s, i, l: jax_train_lib.eval_step(jax_cfg, JaxNet(jax_cfg), s, i, l))(
        setup["state"], images, labels)
    pstate, _ = port_state(torch_cfg, setup["variables"])
    got = train_lib.eval_step(torch_cfg, pstate, images, labels)
    assert_values_close({k: float(v) for k, v in got.items()}, want, "eval")
    assert not pstate.model.training


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 3, 3), (2, 7, 1, 1), (4, 3, 8, 6)])
def test_batchnorm_train_mode_matches_flax(shape, dtype):
    """Output and the running statistics' update against flax's BatchNorm
    (momentum 0.99, epsilon 1e-3) on batch statistics; one [2, C, 1, 1]
    case, where each channel's statistics come from two values. In bf16
    (flax's ``dtype=bfloat16``) both reduce the statistics in f32 and round
    the output once: within one bf16 ulp of the largest output."""
    rng = np.random.RandomState(sum(shape))
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    x = np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))        # representable
    c = shape[1]
    scale, bias = rng.uniform(0.5, 1.5, c), rng.normal(0, 0.1, c)
    mean, var = rng.normal(0, 0.1, c), rng.uniform(0.5, 1.5, c)
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3,
                           dtype=jnp.dtype(dtype))
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), variables)
    want, upd = bn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1), dtype),
                         mutable=["batch_stats"])
    port = BatchNorm(c).train()
    with torch.no_grad():
        for t, v in ((port.weight, scale), (port.bias, bias), (port.running_mean, mean),
                     (port.running_var, var)):
            t.copy_(torch.from_numpy(v.astype(np.float32)))
        got = port(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{dtype}" and want.dtype == jnp.dtype(dtype)
    want = np.asarray(want, np.float32)
    atol = 2.0 ** -8 * float(np.max(np.abs(want))) if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-5, atol=atol)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)


class CallCounts:
    """Counts the fused wrappers' calls (on the CPU they run their plain
    versions; on a card each call is one kernel launch)."""

    def __init__(self, monkeypatch):
        self.dw = self.expand = 0
        dw, expand = fused_dw.fused_depthwise, fused_mbconv.fused_expand_dw

        def count_dw(*a, **k):
            self.dw += 1
            return dw(*a, **k)

        def count_expand(*a, **k):
            self.expand += 1
            return expand(*a, **k)

        monkeypatch.setattr(fused_dw, "fused_depthwise", count_dw)
        monkeypatch.setattr(fused_mbconv, "fused_expand_dw", count_expand)


def test_trained_model_serves_through_the_fused_calls_with_a_fresh_fold(setup, monkeypatch):
    """After steps, eval mode runs each MBConv front half through its fused
    call (1 depthwise, 15 expand + depthwise a forward; train mode none),
    and the model gives what a fresh model with the same state dict gives:
    no fold made before the steps survives them."""
    torch_cfg = setup["torch_cfg"]
    state, schedule = port_state(torch_cfg, setup["variables"])
    state.model.eval()
    state.model.prepare_inference()           # a fold of the initial weights
    counts = CallCounts(monkeypatch)
    for images, labels in setup["batches"][:2]:
        train_lib.train_step(torch_cfg, schedule, SPE, state, images, labels)
    assert (counts.dw, counts.expand) == (0, 0)
    x = torch.from_numpy(np.random.RandomState(3).uniform(-2, 2, (B, IMAGE, IMAGE, 3))
                         .astype(np.float32))
    state.model.eval()
    with torch.no_grad():
        got = state.model(x)
    assert (counts.dw, counts.expand) == (1, 15)
    fresh = copy.deepcopy(state.model)
    fresh.load_state_dict(state.model.state_dict())
    fresh.prepare_inference()
    with torch.no_grad():
        want = fresh(x)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    stale = copy.deepcopy(fresh)
    stale.load_state_dict(flax_to_torch(setup["variables"]["params"],
                                        setup["variables"]["batch_stats"]))
    with torch.no_grad():
        assert not torch.allclose(stale(x)[0][0], got[0][0])


def test_a_model_is_built_in_eval_mode(setup, monkeypatch):
    """A model built and loaded without ``.eval()`` serves, as the JAX
    modules default to ``train=False``: every module is in eval mode, and a
    forward runs each MBConv front half through its fused call (1/15) and
    leaves the running statistics as they were. ``create_train_state``
    gives a model in train mode."""
    from udal_tpu_torch.models.efficientdet import EfficientDetModel

    torch_cfg, v = setup["torch_cfg"], setup["variables"]
    model = EfficientDetModel(torch_cfg)
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"]))
    assert not any(m.training for m in model.modules())
    stats = {k: t.clone() for k, t in model.state_dict().items() if "running" in k}
    counts = CallCounts(monkeypatch)
    x = torch.from_numpy(np.random.RandomState(4).uniform(-2, 2, (B, IMAGE, IMAGE, 3))
                         .astype(np.float32))
    with torch.no_grad():
        model(x, pre_mode=None, post_mode=None)
    assert (counts.dw, counts.expand) == (1, 15)
    for k, t in stats.items():
        assert torch.equal(model.state_dict()[k], t), k
    state, _ = train_lib.create_train_state(torch_cfg, SPE, device="cpu")
    assert all(m.training for m in state.model.modules())


def test_ema_tracks_the_parameters(setup):
    """The EMA moves toward the parameters after the update, by 1 - decay."""
    torch_cfg = setup["torch_cfg"]
    state, schedule = port_state(torch_cfg, setup["variables"])
    before = {k: v.clone() for k, v in state.ema_params.items()}
    train_lib.train_step(torch_cfg, schedule, SPE, state, *setup["batches"][0])
    d = torch_cfg.moving_average_decay
    for name, p in state.model.named_parameters():
        want = before[name] * d + p.detach() * (1.0 - d)
        torch.testing.assert_close(state.ema_params[name], want)
    assert not torch.equal(state.ema_params["backbone.stem_conv.weight"],
                           state.model.backbone.stem_conv.weight)


def test_entry_points_take_the_card_unless_asked(setup, monkeypatch, tmp_path):
    from udal_tpu_torch.train.loop import train_and_evaluate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        train_lib.create_train_state(setup["torch_cfg"], SPE)
    with pytest.raises(RuntimeError, match="CUDA device"):
        train_and_evaluate(setup["torch_cfg"], iter(setup["batches"]), 1, str(tmp_path))
    assert not list(tmp_path.iterdir())
    state, _ = train_lib.create_train_state(setup["torch_cfg"], SPE, device="cpu")
    assert next(state.model.parameters()).device.type == "cpu"
    assert torch_to_flax(state.model)[0].keys() == setup["variables"]["params"].keys()


def clipped_port_grads(torch_cfg, variables, batch, dtype):
    """The port's clipped gradients of one training forward (dropout off)
    in ``dtype``, in the flax layout."""
    state, _ = port_state(torch_cfg, variables)
    model = state.model.to(dtype).train()
    images, labels = train_lib.prepare_batch(torch_cfg, *batch, "cpu")
    labels = {k: v.to(dtype) if v.is_floating_point() else v for k, v in labels.items()}
    loss, _ = train_lib.compute_loss(torch_cfg, model, images.to(dtype), labels, None, 0, SPE)
    loss.backward()
    clip_gradients([p.grad for p in model.parameters()], torch_cfg.clip_gradients_norm)
    return params_to_flax(model, {n: p.grad for n, p in model.named_parameters()})


def test_jax_gradients_are_as_close_to_f64_as_the_ports(setup):
    """What the gradient tolerances rest on: against the port's f64
    gradients, JAX's f32 ones (dropout off, first batch) are as close as
    the port's own f32 ones, both within ``GRAD_L2_TOL`` / 5 as a tree; so
    the JAX-port difference is f32 rounding through an ill-conditioned
    network, not a different function."""
    torch_cfg = train_configs(mc=False)[1]
    batch = setup["batches"][0]
    _, _, jax_grads = setup["step"](setup["state"], *batch,
                                    [np.ones(s, np.float32) for s in setup["shapes"]])
    f64 = clipped_port_grads(torch_cfg, setup["variables"], batch, torch.float64)
    f32 = clipped_port_grads(torch_cfg, setup["variables"], batch, torch.float32)
    for grads, what in ((f32, "port f32"), (jax_grads, "JAX f32")):
        g, w = leaves(grads), leaves(f64)
        err = np.sqrt(sum(float(np.sum((g[p] - v) ** 2)) for p, v in w.items()))
        norm = np.sqrt(sum(float(np.sum(v ** 2)) for v in w.values()))
        assert err <= GRAD_L2_TOL / 5 * norm, (what, err / norm)


def test_stochastic_depth_schedule_and_drop_connect():
    """Stochastic depth where a config sets it (never in b0's backbone):
    block i of n survives with 1 − (1 − p)·i/n (``udal_tpu/models/
    efficientnet.py:385-391``), and ``drop_connect`` on JAX's own keep bits
    (drawn with ``jax.random.bernoulli`` as JAX's ``drop_connect`` draws
    them) gives JAX's output; in train mode a residual block draws one
    [n, 1] keep mask, in eval mode none."""
    from udal_tpu_torch.models.efficientnet import EfficientNet, backbone_spec, drop_connect

    net = EfficientNet(backbone_spec("efficientnet-b1", survival_prob=0.8))
    n = len(net.block_args)
    assert [getattr(net, f"blocks_{i}").survival_prob for i in range(n)] == \
        pytest.approx([1.0 - 0.2 * i / n for i in range(n)])
    _, torch_cfg = train_configs(mc=False, backbone_name="efficientnet-b1", survival_prob=0.8)
    from udal_tpu_torch.models.efficientdet import EfficientDetNet

    assert EfficientDetNet(torch_cfg).backbone.blocks_3.survival_prob is not None
    assert EfficientDetNet(train_configs(mc=False, survival_prob=0.8)[1]) \
        .backbone.blocks_3.survival_prob is None                  # b0

    x = np.random.RandomState(5).normal(0, 1, (6, 5, 5, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax_effnet.drop_connect(jnp.asarray(x), key, 0.7)
    bits = np.asarray(jax.random.bernoulli(key, 0.7, (6, 1, 1, 1))).reshape(6, 1)
    got = drop_connect(torch.from_numpy(x.transpose(0, 3, 1, 2)), 0.7, MaskTable([bits]))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-6, atol=1e-6)

    block = net.blocks_3                                     # a residual block
    assert block.residual
    rec = RecordingSource()
    xb = torch.randn(2, block.depthwise_conv.in_channels // 6, 9, 9)
    block.train()(xb, rec)
    assert rec.shapes[-1] == (2, 1)
    rec.shapes.clear()
    with torch.no_grad():
        block.eval()(xb, rec)
    assert (2, 1) not in rec.shapes
