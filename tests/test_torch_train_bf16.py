"""The port's bf16 training (``mixed_precision``) against the JAX package's,
on the CPU.

Mixed precision in JAX builds the flax modules with ``dtype=bfloat16``
(parameters stay f32, the loss follows the outputs' bf16); the port runs
the forward under bf16 autocast with f32 parameters and computes the loss
in the outputs' bf16. The two round in different places: XLA keeps
elementwise chains in f32 between bf16 loads and stores (its "excess
precision"), eager torch rounds after each op. So the bf16 parts are held
against JAX in two ways.

- Where the function is well conditioned (an MBConv block in train mode
  with its SE mean, BatchNorm casts and recorded dropout masks, the
  detection loss; BatchNorm alone is in ``test_torch_train_step.py``):
  the port's bf16 result
  against JAX's bf16 result directly, and each one's distance from the f32
  result against the other's.
- The whole train step at the reduced d0 of ``tests/test_torch_train_step.py``
  at the config's σ floor (0.01), with replayed MC masks: there the random
  network's gradient swings by a relative L2 near 1 under any perturbation
  of bf16 size (the NLL's 1/σ² = 1e4; BatchNorm over two values a channel at
  the 1x1 levels), in JAX's own bf16 step as in the port's and in an f32 step
  whose weights were only rounded to bf16. So the port's bf16-vs-f32 churn
  (gradients and losses, over three batches) is held to JAX's own churn,
  as ``tests/test_bf16_accuracy.py`` holds bf16 serving to a reference
  churn. The reference is JAX's bf16 step compiled to round after every op
  (``xla_allow_excess_precision`` off), as eager torch rounds: with its
  default, XLA's f32 chains halve the loss's churn at this σ floor (6% of
  the loss against 13% rounded, over these batches).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import udal_tpu.models.efficientnet as jax_effnet  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import random_variables  # noqa: E402
from tests.test_torch_fused_mbconv import random_block_variables  # noqa: E402
from tests.test_torch_losses import detection_case  # noqa: E402
from tests.test_torch_mc import MaskTable, RecordingDropout  # noqa: E402
from tests.test_torch_train_step import (jax_state, jax_stepper, keep_bits,  # noqa: E402
                                         leaves, make_batch, multipliers, port_state,
                                         run_port, site_shapes, train_configs)
from udal_tpu.train import losses as jax_losses  # noqa: E402
from udal_tpu_torch.convert import flax_to_torch, torch_to_flax  # noqa: E402
from udal_tpu_torch.models import efficientnet as torch_effnet  # noqa: E402
from udal_tpu_torch.train import losses, train_lib  # noqa: E402

BF16 = jnp.bfloat16
ULP = 2.0 ** -8              # bf16's relative spacing


def relative(got, want):
    """|got − want| / |want|, elementwise over a dict of floats."""
    return {k: abs(got[k] - w) / max(abs(w), 1e-12) for k, w in want.items()}


def tree_relative_l2(got, want):
    g, w = leaves(got), leaves(want)
    err = np.sqrt(sum(float(np.sum((np.float64(g[p]) - v) ** 2)) for p, v in w.items()))
    return err / np.sqrt(sum(float(np.sum(np.float64(v) ** 2)) for v in w.values()))


def max_relative(got, want):
    """The largest |got − want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("expand", [1, 6])
def test_mbconv_block_train_mode_bf16_matches_flax(expand):
    """A block in train mode with MC dropout (recorded masks), JAX's in
    ``dtype=bfloat16`` and the port's under bf16 autocast, from the same
    f32 weights and bf16 input: the outputs within 4 ulps of the largest
    value of each other, and each as far from the f32 block's output as the
    other (within 1.5x and 2 ulps); the running statistics (reduced in f32
    from bf16 values) within 1e-2 of the largest statistic."""
    k, s, cin, rate = 3, 1, 16, 0.2
    args = dict(kernel_size=k, num_repeat=1, input_filters=cin, output_filters=cin,
                expand_ratio=expand, id_skip=True, se_ratio=0.25, strides=(s, s))
    rng = np.random.RandomState(200 + expand)
    x = rng.normal(0, 1, (4, 12, 12, cin)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, BF16).astype(jnp.float32))
    outs, stats = {}, {}
    for dtype in (jnp.float32, BF16):
        flax_block = jax_effnet.MBConvBlock(jax_effnet.BlockArgs(**args), mc_dropoutrate=rate,
                                            dtype=dtype)
        v = random_block_variables(flax_block, jnp.asarray(x), seed=7 + expand)
        rec = RecordingDropout(np.random.RandomState(9))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_effnet, "spatial_dropout", rec)
            out, upd = flax_block.apply(v, jnp.asarray(x, dtype), True, mutable=["batch_stats"])
        outs[f"jax_{dtype.__name__}"] = np.asarray(out, np.float32)
        stats["jax"] = upd["batch_stats"]
    block = torch_effnet.MBConvBlock(torch_effnet.BlockArgs(**args), cin, mc_dropoutrate=rate)
    block.load_state_dict(flax_to_torch(v["params"], v["batch_stats"]), strict=True)
    block.train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = block(xt.to(torch.bfloat16), MaskTable(rec.bits))
    assert got.dtype == torch.bfloat16
    outs["port_bfloat16"] = got.float().numpy().transpose(0, 2, 3, 1)
    want32 = outs["jax_float32"]
    jax_churn = max_relative(outs["jax_bfloat16"], want32)
    port_churn = max_relative(outs["port_bfloat16"], want32)
    print(f"expand {expand}: jax bf16 vs f32 {jax_churn:.4g}, port {port_churn:.4g}, "
          f"port vs jax bf16 {max_relative(outs['port_bfloat16'], outs['jax_bfloat16']):.4g}")
    assert max_relative(outs["port_bfloat16"], outs["jax_bfloat16"]) <= 4 * ULP
    assert port_churn <= 1.5 * jax_churn + 2 * ULP
    got_stats, want_stats = leaves(torch_to_flax(block)[1]), leaves(stats["jax"])
    assert sorted(map(str, got_stats)) == sorted(map(str, want_stats))
    for p, w in want_stats.items():
        np.testing.assert_allclose(got_stats[p], w, rtol=0,
                                   atol=1e-2 * float(np.max(np.abs(w))),
                                   err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("att", [False, True])
def test_detection_loss_in_bf16_matches_jax(att):
    """The loss on bf16 outputs: each part of the loss dict in JAX's type
    (the class part in bf16; the box part, which meets the f32 targets, and
    the total in f32), within 1% of JAX's bf16 value, and
    within 1.5x (plus 2 ulps) of JAX's own distance from the f32 loss; the
    gradient of the total as close to JAX's f32 gradient as JAX's bf16 one
    (within 1.5x, plus 2 ulps)."""
    jax_cfg, torch_cfg, labels, cls_out, box_out = detection_case(4, att)
    n = len(cls_out)
    arrays = [np.asarray(jnp.asarray(a, BF16).astype(jnp.float32)) for a in cls_out + box_out]
    tl = {k: torch.from_numpy(v) for k, v in labels.items()}

    def ref(dtype):
        def fn(*outs):
            total, vals = jax_losses.detection_loss(jax_cfg, list(outs[:n]), list(outs[n:]),
                                                    labels)
            return total.astype(jnp.float32), vals
        vg = jax.jit(jax.value_and_grad(fn, argnums=tuple(range(2 * n)), has_aux=True))
        (_, vals), grads = vg(*[jnp.asarray(a, dtype) for a in arrays])
        types.update({k: str(v.dtype) for k, v in vals.items()})
        return ({k: float(v) for k, v in vals.items()},
                [np.asarray(g, np.float32) for g in grads])

    ts = [torch.tensor(a, dtype=torch.bfloat16, requires_grad=True) for a in arrays]
    total, vals = losses.detection_loss(torch_cfg, ts[:n], ts[n:], tl)
    grads = torch.autograd.grad(total.float(), ts)
    got = ({k: float(v) for k, v in vals.items()}, [g.float().numpy() for g in grads])
    types = {}
    want32 = ref(jnp.float32)
    want16 = ref(BF16)              # (last: ``types`` holds the bf16 run's types)
    assert {k: str(v.dtype).replace("torch.", "") for k, v in vals.items()} == types
    assert types["cls_loss"] == "bfloat16" and total.dtype == torch.float32
    assert set(got[0]) == set(want32[0])
    direct = relative(got[0], want16[0])
    port_churn, jax_churn = relative(got[0], want32[0]), relative(want16[0], want32[0])
    print("loss parts: port vs jax bf16", direct, "port churn", port_churn, "jax churn",
          jax_churn)
    for k in want32[0]:
        assert direct[k] <= 1e-2, (k, direct[k])
        assert port_churn[k] <= 1.5 * jax_churn[k] + 2 * ULP, (k, port_churn[k], jax_churn[k])

    def rel_l2(a, b):
        return np.sqrt(sum(np.sum((x - y) ** 2.0) for x, y in zip(a, b)) /
                       sum(np.sum(y ** 2.0) for y in b))

    g_port, g_jax = rel_l2(got[1], want32[1]), rel_l2(want16[1], want32[1])
    print(f"loss gradients: port churn {g_port:.4g}, jax churn {g_jax:.4g}, "
          f"port vs jax bf16 {rel_l2(got[1], want16[1]):.4g}")
    assert g_port <= 1.5 * g_jax + 2 * ULP


def step_once(jax_step, jax_state_, torch_cfg, variables, batch, bits, monkeypatch):
    """One JAX step and one port step from the same variables on ``batch``
    with the keep bits ``bits``: ((JAX values, JAX gradients), (port values,
    port gradients))."""
    _, vals, grads = jax_step(jax_state_, *batch, multipliers(bits))
    pstate, schedule = port_state(torch_cfg, variables)
    got = run_port(torch_cfg, pstate, schedule, [batch], [bits], monkeypatch)[0]
    return ({k: float(v) for k, v in vals.items()}, grads), got


def test_bf16_step_churn_is_no_worse_than_jaxs(monkeypatch):
    """Three batches, each with its own MC masks, at the config's σ floor:
    the port's bf16 step is finite and its distance from the f32 step (the
    clipped gradients' relative L2; the loss, its detection part and its
    box part, relative), averaged over the batches, is at most 1.25x JAX's
    own bf16-vs-f32 distance, every op rounded (plus 2 ulps for the
    losses). JAX's own gradient churn is above 0.5, and so is an f32
    step's whose weights were only rounded to bf16: the size of the swing
    is the network's, not a fault of either bf16 path."""
    steps, churn = {}, {"jax": [], "port": [], "rounded": []}
    loss_churn = {"jax": [], "port": []}
    jax32, torch32 = train_configs()
    jax16, torch16 = train_configs(mixed_precision=True)
    assert torch16.clip_min_uncert == 0.01
    variables = random_variables(jax32, seed=11)
    for name, cfg, dtype in (("f32", jax32, jnp.float32), ("bf16", jax16, BF16)):
        state, tx, schedule = jax_state(cfg, variables)
        steps[name] = (jax_stepper(cfg, tx, schedule, dtype=dtype,
                                   compiler_options={"xla_allow_excess_precision": False}),
                       state)
    rounded = {k: (v.to(torch.bfloat16).float() if v.is_floating_point() else v)
               for k, v in flax_to_torch(variables["params"], variables["batch_stats"]).items()}
    for i in range(3):
        batch = make_batch(60 + i)
        bits = keep_bits(np.random.RandomState(70 + i), site_shapes(torch32, *batch))
        (j32, p32) = step_once(*steps["f32"], torch32, variables, batch, bits, monkeypatch)
        (j16, p16) = step_once(*steps["bf16"], torch16, variables, batch, bits, monkeypatch)
        assert all(np.isfinite(list(p16[0].values())))
        assert all(np.all(np.isfinite(g)) for g in leaves(p16[1]).values())
        rstate, rschedule = train_lib.create_train_state(torch32, 10, device="cpu",
                                                         state_dict=rounded)
        r32 = run_port(torch32, rstate, rschedule, [batch], [bits], monkeypatch)[0]
        churn["jax"].append(tree_relative_l2(j16[1], j32[1]))
        churn["port"].append(tree_relative_l2(p16[1], p32[1]))
        churn["rounded"].append(tree_relative_l2(r32[1], p32[1]))
        loss_churn["jax"].append(relative(j16[0], j32[0]))
        loss_churn["port"].append(relative(p16[0], p32[0]))
    mean = {k: float(np.mean(v)) for k, v in churn.items()}
    print("gradient churn", churn, "loss churn", loss_churn)
    assert mean["port"] <= 1.25 * mean["jax"], mean
    assert mean["jax"] > 0.5 and mean["rounded"] > 0.5, mean
    for key in ("loss", "det_loss", "box_loss"):
        port = float(np.mean([c[key] for c in loss_churn["port"]]))
        ref = float(np.mean([c[key] for c in loss_churn["jax"]]))
        assert port <= 1.25 * ref + 2 * ULP, (key, port, ref)
