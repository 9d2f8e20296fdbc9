"""Every function of the port's ``train/losses.py`` against the JAX
package's, value and gradient (torch autograd against ``jax.grad``), in f32.

Inputs are numpy draws from seeds: NHWC maps of d0's levels 3-7 at 64x64
(8 classes, 9 anchors), targets from ``build_labels`` on random boxes.
Tolerances: 1e-5 relative for values and gradients (both sides sum the same
terms in different orders), 1e-6 absolute below that.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import random_variables  # noqa: E402
from tests.test_torch_train_step import train_configs  # noqa: E402
from udal_tpu.train import losses as jax_losses  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch, params_to_flax  # noqa: E402
from udal_tpu_torch.data.labels import build_labels  # noqa: E402
from udal_tpu_torch.models.efficientdet import EfficientDetNet  # noqa: E402
from udal_tpu_torch.train import losses  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
B, A, C = 2, 9, 8
SIZES = [8, 4, 2, 1, 1]          # levels 3-7 at 64x64


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def value_and_grads(torch_fn, jax_fn, arrays):
    """(torch value, torch grads, jax value, jax grads) of scalar functions
    of the same f32 numpy ``arrays``."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = torch_fn(*ts)
    tg = torch.autograd.grad(tv, ts, allow_unused=True)
    jv, jg = jax.jit(jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])
    return tv, tg, jv, jg


def assert_same(torch_fn, jax_fn, arrays, rtol=RTOL, atol=ATOL):
    tv, tg, jv, jg = value_and_grads(torch_fn, jax_fn, arrays)
    close(tv, jv, rtol, atol, "value")
    for i, (g, w) in enumerate(zip(tg, jg)):
        close(g if g is not None else torch.zeros(arrays[i].shape), w, rtol, atol, f"grad {i}")


def test_huber_and_focal_loss():
    rng = np.random.RandomState(0)
    t = rng.normal(0, 0.3, (4, 50)).astype(np.float32)
    p = rng.normal(0, 0.3, (4, 50)).astype(np.float32)
    w = rng.normal(0, 1, (4, 50)).astype(np.float32)
    assert_same(lambda a, b: torch.sum(losses.huber(a, b, 0.1) * torch.from_numpy(w)),
                lambda a, b: jnp.sum(jax_losses.huber(a, b, 0.1) * w), [t, p])
    y = (rng.uniform(size=(4, 50)) < 0.3).astype(np.float32)
    logits = rng.normal(0, 3, (4, 50)).astype(np.float32)
    for smoothing in (0.0, 0.1):
        assert_same(lambda x: torch.sum(losses.focal_loss(torch.from_numpy(y), x, 0.25, 1.5,
                                                          torch.tensor(7.0), smoothing)),
                    lambda x: jnp.sum(jax_losses.focal_loss(y, x, 0.25, 1.5, 7.0, smoothing)),
                    [logits])


def test_clip_uncert_channels():
    x = np.random.RandomState(1).normal(0, 2, (2, 3, 3, 72)).astype(np.float32)
    close(losses.clip_uncert_channels(torch.from_numpy(x), 0.01, 1.5),
          jax_losses.clip_uncert_channels(jnp.asarray(x), 0.01, 1.5), 0, 0)


def box_case(seed, att):
    rng = np.random.RandomState(seed)
    tgt = rng.normal(0, 0.5, (B, 4, 4, 4 * A)).astype(np.float32)
    tgt[rng.uniform(size=tgt.shape) < 0.6] = 0.0
    out = rng.normal(0, 0.5, (B, 4, 4, (8 if att else 4) * A)).astype(np.float32)
    if att:       # σ away from 0, as after clip_uncert_channels
        out[..., 4 * A:] = rng.uniform(0.2, 1.5, out[..., 4 * A:].shape)
    return tgt, out


@pytest.mark.parametrize("att,loss_type,strict,beta,pseudo", [
    (False, "huber", False, 0.0, False), (False, "mse", False, 0.0, True),
    (True, "huber", False, 0.0, False), (True, "mse", False, 0.0, False),
    (True, "huber", True, 0.0, False), (True, "huber", False, 1.0, False),
    (True, "mse", False, 0.5, True)])
def test_box_loss(att, loss_type, strict, beta, pseudo):
    """Plain, attenuated (σ²/2 on every anchor's (th, tw), or on the second
    half with strict parity), β-NLL at 0, 0.5 and 1 (the weight carries no
    gradient), pseudo-score weights."""
    tgt, out = box_case(2, att)
    ps = np.asarray([0.4, 0.9], np.float32) if pseudo else None
    kw = dict(delta=0.1, loss_att=att, loss_type=loss_type, strict_parity=strict,
              beta_nll=beta)
    assert_same(
        lambda o: losses.box_loss(torch.from_numpy(tgt), o, torch.tensor(5.0),
                                  pseudo_scores=None if ps is None else torch.from_numpy(ps),
                                  **kw),
        lambda o: jax_losses.box_loss(tgt, o, 5.0, pseudo_scores=ps, **kw), [out])


def detection_case(seed, att):
    """Per-level class and box outputs and the labels of random boxes."""
    jax_cfg, torch_cfg = train_configs(mc=False, loss_attenuation=att)
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, 5, 4), np.float32)
    cls = np.zeros((B, 5), np.int32)
    for b in range(B):
        for i in range(3 + b):
            y1, x1 = rng.uniform(0, 40, 2)
            gt[b, i] = [y1, x1, y1 + rng.uniform(6, 24), x1 + rng.uniform(6, 24)]
            cls[b, i] = rng.randint(1, C + 1)
    labels = {k: v.numpy() for k, v in build_labels(torch_cfg, gt, cls).items()}
    for level in range(3, 8):      # ignored anchors (between the matcher's thresholds)
        t = labels[f"cls_targets_{level}"]
        t[rng.uniform(size=t.shape) < 0.1] = -2
    cls_out = [rng.normal(-2, 1.5, (B, s, s, A * C)).astype(np.float32) for s in SIZES]
    box_out = [rng.normal(0, 0.3, (B, s, s, (8 if att else 4) * A)).astype(np.float32)
               for s in SIZES]
    if att:
        for o in box_out:
            o[..., 4 * A:] = rng.uniform(0.2, 1.5, o[..., 4 * A:].shape)
    return jax_cfg, torch_cfg, labels, cls_out, box_out


@pytest.mark.parametrize("att,iou,pseudo", [(False, None, False), (True, None, True),
                                            (True, "ciou", False), (False, "giou", True)])
def test_detection_loss(att, iou, pseudo):
    """Every part of the loss dict and the gradients of the total: class
    target −2 masked, background as the all-zero one-hot row, pseudo-score
    weights, the box loss averaged over the levels under attenuation, and
    the IoU term on the decoded anchors."""
    jax_cfg, torch_cfg, labels, cls_out, box_out = detection_case(3, att)
    for cfg in (jax_cfg, torch_cfg):
        cfg.iou_loss_type = iou
    assert (labels["cls_targets_3"] == -2).any() and (labels["cls_targets_3"] == -1).any()
    n = len(SIZES)
    ps = np.asarray([0.6, 0.8], np.float32) if pseudo else None
    tl = {k: torch.from_numpy(v) for k, v in labels.items()}

    def port(*outs):
        return losses.detection_loss(torch_cfg, list(outs[:n]), list(outs[n:]), tl,
                                     None if ps is None else torch.from_numpy(ps))

    def ref(*outs):
        return jax_losses.detection_loss(jax_cfg, list(outs[:n]), list(outs[n:]), labels, ps)

    assert_same(lambda *o: port(*o)[0], lambda *o: ref(*o)[0], cls_out + box_out)
    got, want = port(*map(torch.from_numpy, cls_out + box_out))[1], ref(*cls_out + box_out)[1]
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], what=k)


@pytest.mark.parametrize("use_be", [True, False])
def test_csd_consistency_loss(use_be):
    jax_cfg, torch_cfg, _, cls_out, box_out = detection_case(4, False)
    for cfg in (jax_cfg, torch_cfg):
        cfg.override(dict(csd_BE=use_be, csd_BE_thr=0.02), allow_new_keys=True)
    rng = np.random.RandomState(5)
    cls_aug = [c + rng.normal(0, 0.5, c.shape).astype(np.float32) for c in cls_out]
    box_aug = [b + rng.normal(0, 0.1, b.shape).astype(np.float32) for b in box_out]
    n = len(SIZES)
    for part in (0, 1):
        assert_same(
            lambda *o: losses.csd_consistency_loss(torch_cfg, o[:n], o[n:2 * n], o[2 * n:3 * n],
                                                   o[3 * n:])[part],
            lambda *o: jax_losses.csd_consistency_loss(jax_cfg, o[:n], o[n:2 * n],
                                                       o[2 * n:3 * n], o[3 * n:])[part],
            cls_out + box_out + cls_aug + box_aug)


def test_csd_ramp_weight():
    total = 40
    got = [losses.csd_ramp_weight(s, total) for s in range(total + 3)]
    want = [float(jax_losses.csd_ramp_weight(jnp.asarray(s), total)) for s in range(total + 3)]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)     # JAX computes in f32


def test_l2_regularization_selects_the_same_leaves():
    """The port's parameter names select the leaves the JAX filter selects
    on the flax paths (kernels and edge weights; no BatchNorm, no bias);
    the value and the gradient of each leaf (weight_decay · w) agree."""
    jax_cfg, torch_cfg = train_configs(mc=False, heads=["object_detection", "segmentation"],
                                       max_level=6)
    variables = random_variables(jax_cfg, seed=6)
    model = EfficientDetNet(torch_cfg)
    model.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"]))
    selected = losses.l2_parameters(model)
    names = {n for n, p in model.named_parameters() if any(p is q for q in selected)}
    jax_paths = ["/".join(str(k.key) for k in path).lower() for path, _ in
                 jax.tree_util.tree_leaves_with_path(variables["params"])]
    jax_selected = [p for p in jax_paths
                    if not any(k in p for k in ("bn", "bias", "batch"))]
    assert len(names) == len(jax_selected)
    assert {n.lower().replace(".", "/").rsplit("/", 1)[0] for n in names} == \
        {p.rsplit("/", 1)[0] for p in jax_selected}
    assert any("edge_weights" in n for n in names) and any("seg_head" in n for n in names)
    value = losses.l2_regularization(selected, 4e-5)
    want, grads = jax.jit(jax.value_and_grad(lambda p: jax_losses.l2_regularization(p, 4e-5)))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    close(value, want)
    value.backward()
    got_grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert set(got_grads) == names
    tree = params_to_flax(model, {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                                  for n, p in model.named_parameters()})
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(tree))
    for path, w in jax.tree_util.tree_leaves_with_path(grads):
        close(got_leaves[path], w, what=jax.tree_util.keystr(path))
