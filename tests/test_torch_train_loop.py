"""The port's checkpoints, training loop, training-state conversion and
ensemble from checkpoints, on the CPU.

- Checkpoints: save / restore / keep-N, and the EMA mismatch both ways
  (``tests/test_checkpoint_restore.py``'s cases for the port's format).
- ``train_and_evaluate``: 2 epochs x 2 steps with MC dropout, two steps a
  call, before the data runs out; a second call resumes at epoch 2 and
  runs the third, and ends where an unbroken 3-epoch run ends, bit for bit (the dropout of step s
  comes from (seed, s), the checkpoint holds the whole state); early
  stopping restores the best state.
- A JAX ``TrainState`` after one JAX step, saved by
  ``udal_tpu.utils.checkpoint`` (orbax) and restored there, converted into
  the port: one more step on each side gives the same weights (the
  tolerances of ``tests/test_torch_train_step.py``). Adam's moments
  convert too, and the port's state goes back to flax trees.
- ``ServingDriver.create_ensemble`` from two members' checkpoints serves
  what ``ServingDriver(ensemble=True)`` serves on the stacked weights.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_fixtures import random_variables  # noqa: E402
from tests.test_torch_train_step import (SPE, assert_state_close, jax_state,  # noqa: E402
                                         jax_stepper, make_batch, port_state,
                                         train_configs)
from udal_tpu.train.schedules import make_optimizer  # noqa: E402
from udal_tpu.utils import checkpoint as jax_checkpoint  # noqa: E402
from udal_tpu_torch.apps.serving import ServingDriver  # noqa: E402
from udal_tpu_torch.convert import (flax_to_torch, train_state_from_flax,  # noqa: E402
                                    train_state_to_flax)
from udal_tpu_torch.models.ensemble import stack_variables  # noqa: E402
from udal_tpu_torch.train import loop, train_lib  # noqa: E402
from udal_tpu_torch.utils import checkpoint  # noqa: E402


def batches(start=0):
    i = start
    while True:
        yield make_batch(100 + i, pseudo=False)
        i += 1


def small_state(ema: bool, value: float = 2.0):
    _, tcfg = train_configs(mc=False, moving_average_decay=0.999 if ema else 0)
    state, _ = train_lib.create_train_state(tcfg, SPE, device="cpu")
    with torch.no_grad():
        state.model.backbone.stem_conv.weight.fill_(value)
        if ema:
            for v in state.ema_params.values():
                v.fill_(value + 1)
    return state


def test_save_restore_keep_n(tmp_path):
    state = small_state(ema=True)
    state.step = 7
    for epoch in range(1, 5):
        checkpoint.save_checkpoint(str(tmp_path), state, epoch, keep_last_n=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_3", "ckpt_4"]
    assert checkpoint.latest_checkpoint(str(tmp_path)) == 4
    target = small_state(ema=True, value=0.0)
    restored, epoch = checkpoint.restore_checkpoint(str(tmp_path), target)
    assert epoch == 4 and restored.step == 7
    assert float(restored.model.backbone.stem_conv.weight.mean()) == 2.0
    assert float(next(iter(restored.ema_params.values())).mean()) == 3.0
    assert checkpoint.restore_checkpoint("_", target) == (target, 0)
    assert checkpoint.restore_checkpoint(str(tmp_path / "none"), target) == (target, 0)


def test_restore_no_ema_ckpt_into_ema_target(tmp_path):
    checkpoint.save_checkpoint(str(tmp_path), small_state(ema=False), 1)
    restored, epoch = checkpoint.restore_checkpoint(str(tmp_path), small_state(ema=True, value=0))
    assert epoch == 1 and restored.ema_params is None
    # serving falls back to the raw parameters
    sd = checkpoint.swap_in_ema(checkpoint.load_checkpoint(str(tmp_path), 1))
    assert float(sd["backbone.stem_conv.weight"].mean()) == 2.0


def test_restore_ema_ckpt_into_no_ema_target(tmp_path):
    checkpoint.save_checkpoint(str(tmp_path), small_state(ema=True), 1)
    restored, epoch = checkpoint.restore_checkpoint(str(tmp_path), small_state(ema=False))
    assert epoch == 1
    assert float(restored.ema_params["backbone.stem_conv.weight"].mean()) == 3.0
    sd = checkpoint.swap_in_ema(checkpoint.load_checkpoint(str(tmp_path), 1))
    assert float(sd["backbone.stem_conv.weight"].mean()) == 3.0


def loop_config(**extra):
    return train_configs(mc=True, **{"num_epochs": 2, "save_freq": 1, **extra})[1]


def test_train_and_evaluate_resumes_where_an_unbroken_run_ends(tmp_path):
    """A 3-epoch run whose data ends after 2 epochs of 2 steps stops with
    their checkpoints; a second call resumes at epoch 2 and runs the
    third; it ends where an unbroken run ends (whose schedule, over the
    same 3 epochs, the interrupted run also followed). The interrupted
    run's config asks for two steps a call, which changes nothing."""
    logs = []
    cfg = loop_config(num_epochs=3, steps_per_execution=2, host_sync_every=1)
    with pytest.raises(StopIteration):
        loop.train_and_evaluate(cfg, itertools.islice(batches(), 4), 2, str(tmp_path / "run"),
                                val_iter_fn=lambda: batches(50), val_steps=1, device="cpu",
                                log_fn=logs.append)
    assert [line.split()[:2] for line in logs] == [["epoch", "1/3"], ["epoch", "2/3"]]
    assert all("val_loss=" in line for line in logs)
    assert checkpoint.latest_checkpoint(str(tmp_path / "run")) == 2
    second = loop.train_and_evaluate(cfg, batches(4), 2, str(tmp_path / "run"), device="cpu",
                                     log_fn=logs.append)
    assert len(second["loss"]) == 1 and logs[-1].startswith("epoch 3/3")
    assert np.isfinite(second["loss"][0]) and second["final_state"].step == 6
    unbroken = loop.train_and_evaluate(loop_config(num_epochs=3), batches(), 2,
                                       str(tmp_path / "unbroken"), device="cpu",
                                       log_fn=logs.append)
    assert len(unbroken["loss"]) == 3 and unbroken["loss"][2] == second["loss"][0]
    got = second["final_state"].model.state_dict()
    for k, v in unbroken["final_state"].model.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    assert (tmp_path / "run" / "logs" / "metrics.jsonl").read_text().count("\n") == 3


def test_early_stopping_restores_the_best_state(tmp_path, monkeypatch):
    val = iter([1.0, 2.0, 3.0])
    monkeypatch.setattr(loop, "eval_step", lambda *a: {"val_det_loss": torch.tensor(next(val))})
    cfg = loop_config(early_stopping_patience=1)
    cfg.num_epochs = 3
    logs = []
    hist = loop.train_and_evaluate(cfg, batches(), 1, str(tmp_path), val_iter_fn=lambda: iter(
        [(None, {})]), val_steps=1, device="cpu", log_fn=logs.append)
    assert hist["val_loss"] == [1.0, 2.0] and "early stopping at epoch 2" in logs[-1]
    assert hist["final_state"].step == 1                # the state after epoch 1
    restored, epoch = checkpoint.restore_checkpoint(
        str(tmp_path), train_lib.create_train_state(cfg, 1, device="cpu")[0])
    assert epoch == 2 and restored.step == 1


def test_jax_checkpoint_continues_in_the_port(tmp_path, monkeypatch):
    """One JAX step, an orbax checkpoint restored by JAX, converted; the
    next step on each side from there."""
    jax_cfg, torch_cfg = train_configs(mc=False)
    variables = random_variables(jax_cfg, seed=13)
    state, tx, schedule = jax_state(jax_cfg, variables)
    step = jax_stepper(jax_cfg, tx, schedule)
    (im0, lb0), (im1, lb1) = make_batch(60, pseudo=False), make_batch(61, pseudo=False)
    state, _, _ = step(state, im0, lb0, [])
    jax_checkpoint.save_checkpoint(str(tmp_path), state, 1)
    template, _, _ = jax_state(jax_cfg, variables)
    restored, epoch = jax_checkpoint.restore_checkpoint(str(tmp_path), template)
    assert epoch == 1 and int(restored.step) == 1
    pstate, pschedule = port_state(torch_cfg, random_variables(jax_cfg, seed=14))
    train_state_from_flax(pstate, restored.step, restored.params, restored.batch_stats,
                          restored.opt_state, restored.ema_params)
    assert pstate.step == 1
    assert_state_close(pstate, restored, "converted")
    want, _, _ = step(restored, im1, lb1, [])
    train_lib.train_step(torch_cfg, pschedule, SPE, pstate, im1, lb1)
    assert_state_close(pstate, want, "the step after")


def test_adam_state_converts_both_ways():
    """optax Adam's (count, mu, nu) after two updates → the port's Adam;
    one more update on each side with the same gradients agrees, and
    ``train_state_to_flax`` gives optax's moments back."""
    jax_cfg, torch_cfg = train_configs(mc=False, optimizer="adam", moving_average_decay=0)
    variables = random_variables(jax_cfg, seed=15)
    tx, _ = make_optimizer(jax_cfg, SPE)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)
    rng = np.random.RandomState(16)
    grad_trees = [jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(0, 1, p.shape),
                                                               jnp.float32), params)
                  for _ in range(3)]
    update = jax.jit(lambda g, o, p: tx.update(g, o, p))
    for g in grad_trees[:2]:
        updates, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    pstate, pschedule = port_state(torch_cfg, variables)
    train_state_from_flax(pstate, 2, params, variables["batch_stats"], opt_state)
    back = train_state_to_flax(pstate)
    assert int(back["opt_state"]["count"]) == 2
    for name in ("mu", "nu"):
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(back["opt_state"][name]),
                jax.tree_util.tree_leaves_with_path(getattr(opt_state[0], name))):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=0)
    updates, opt_state = update(grad_trees[2], opt_state, params)
    params = optax.apply_updates(params, updates)
    grads = flax_to_torch(jax.tree_util.tree_map(np.asarray, grad_trees[2]), {})
    for n, p in pstate.model.named_parameters():
        p.grad = grads[n]
    for group in pstate.optimizer.param_groups:
        group["lr"] = pschedule(2)
    pstate.optimizer.step()
    flax_state = train_state_to_flax(pstate)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(flax_state["params"]),
                                 jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
    # and back: the port's own flax trees load into a fresh state unchanged
    fresh, _ = port_state(torch_cfg, variables)
    train_state_from_flax(fresh, flax_state["step"], flax_state["params"],
                          flax_state["batch_stats"], flax_state["opt_state"])
    again = train_state_to_flax(fresh)
    assert again["step"] == 2 and int(again["opt_state"]["count"]) == 3
    for name in ("params", "batch_stats", "opt_state"):
        for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(again[name]),
                                     jax.tree_util.tree_leaves_with_path(flax_state[name])):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{name} {jax.tree_util.keystr(path)}")


def test_create_ensemble_from_port_checkpoints(tmp_path, monkeypatch):
    _, cfg = train_configs(mc=False, moving_average_decay=0.5)
    dirs, members = [], []
    for i in range(2):
        state, schedule = train_lib.create_train_state(
            cfg, SPE, torch.Generator().manual_seed(i), device="cpu")
        train_lib.train_step(cfg, schedule, SPE, state, *make_batch(70 + i, pseudo=False))
        d = str(tmp_path / f"member{i}")
        checkpoint.save_checkpoint(d, state, 1)
        dirs.append(d)
        members.append({**state.model.state_dict(), **state.ema_params})
    images = np.random.RandomState(9).uniform(-2, 2, (2, 64, 64, 3)).astype(np.float32)
    got = ServingDriver.create_ensemble(cfg, dirs, device="cpu").serve_preprocessed(images)
    want = ServingDriver(cfg, stack_variables(members), device="cpu",
                         ensemble=True).serve_preprocessed(images)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        ServingDriver.create_ensemble(cfg, [str(tmp_path / "empty")], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):     # the card, unless asked
        ServingDriver.create_ensemble(cfg, dirs)
