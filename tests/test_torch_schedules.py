"""The port's schedules, optimizers and gradient clipping against the JAX
package's (optax).

The three schedules over every step of a run (warmup included) within 1e-5
relative (JAX computes them in f32, the cosine's argument included); SGD
with momentum and Adam for 3 updates on the same trees as optax, each
update at the schedule's rate for the step count before it, within 1e-6;
per-tensor and global clipping, one case where only the global clip
bites, within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu import config as jax_config  # noqa: E402
from udal_tpu.train import schedules as jax_schedules  # noqa: E402
from udal_tpu_torch import config as torch_config  # noqa: E402
from udal_tpu_torch.train import schedules  # noqa: E402

SPE = 5


def cfgs(**overrides):
    out = []
    for api in (jax_config, torch_config):
        cfg = api.get_detection_config("efficientdet-d0")
        cfg.override(dict(num_epochs=6, lr_warmup_epoch=1.0, first_lr_drop_epoch=3.0,
                          second_lr_drop_epoch=5.0, **overrides))
        cfg.override({"batch_size": 8}, allow_new_keys=True)
        out.append(cfg)
    return out


@pytest.mark.parametrize("method", ["stepwise", "cosine", "polynomial"])
def test_schedule_matches_jax_at_every_step(method):
    jcfg, tcfg = cfgs(lr_decay_method=method)
    want = jax_schedules.learning_rate_schedule(jcfg, SPE)
    got = schedules.learning_rate_schedule(tcfg, SPE)
    steps = range(6 * SPE)
    np.testing.assert_allclose([got(s) for s in steps], [float(want(s)) for s in steps],
                               rtol=1e-5, atol=0)
    assert got(0) == pytest.approx(0.008 * 8 / 64)            # the warmup's start


def trees(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.normal(0, 1, (3, 4)).astype(np.float32),
            "b": rng.normal(0, 1, (5,)).astype(np.float32)}


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizer_matches_optax_for_3_updates(name):
    jcfg, tcfg = cfgs(optimizer=name, lr_decay_method="cosine")
    tx, jsched = jax_schedules.make_optimizer(jcfg, SPE)
    params = jax.tree_util.tree_map(jnp.asarray, trees(0))
    opt_state = tx.init(params)
    torch_params = {k: torch.tensor(v, requires_grad=True) for k, v in trees(0).items()}
    opt, sched = schedules.make_optimizer(tcfg, list(torch_params.values()), SPE)
    assert isinstance(opt, torch.optim.SGD if name == "sgd" else torch.optim.Adam)
    for step in range(3):
        grads = trees(10 + step)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(grads[k])
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
        for k, p in torch_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name} step {step} {k}")


@pytest.mark.parametrize("scales,clip", [((1.0, 1.0), 10.0), ((30.0, 0.1), 10.0),
                                         ((2.0, 2.5), 3.5), ((0.1, 0.1), 10.0)],
                         ids=["no_clip", "per_tensor", "global_only", "small"])
def test_clip_gradients_matches_jax(scales, clip):
    """Per-tensor clip, then the global one; ``global_only``: each tensor
    below the clip, together above it."""
    g = trees(3)
    g = {k: v * s / np.linalg.norm(v) * (1.5 if k == "a" else 1.0)
         for (k, v), s in zip(sorted(g.items()), scales)}
    want, want_norm = jax_schedules.clip_gradients(jax.tree_util.tree_map(jnp.asarray, g), clip)
    got = [torch.from_numpy(g[k].copy()) for k in sorted(g)]
    got_norm = schedules.clip_gradients(got, clip)
    for t, k in zip(got, sorted(g)):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    norms = [np.linalg.norm(v) for v in g.values()]
    if scales == (2.0, 2.5):
        assert max(norms) < clip < np.sqrt(sum(n * n for n in norms))
        assert float(got_norm) == pytest.approx(clip, rel=1e-6)
