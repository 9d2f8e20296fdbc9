"""The port's data-parallel training over ``torch.distributed`` against the
JAX package's mesh, on the CPU.

Ranks are spawned gloo processes (``parallel.dryrun.spawn_world``) that
import only torch and the port: the functions named ``_*_rank`` below run
in them, this module importing JAX only inside the parent's tests and
fixtures. Inputs and weights go to the ranks as files (the weights through
``convert.flax_to_torch``), and results come back the same way.

* A data-parallel step at world 2 (a [2, 1] mesh, 2 rows a rank) from the
  reduced d0 of ``test_torch_train_step.py`` (random flax weights, MC
  dropout with recorded keep bits, the reader's fast-input contract with a
  pseudo-score column), against JAX's ``make_jitted_train_step`` on a
  (2, 1) mesh of the virtual devices and against the port's world-1 step,
  with that file's tolerances: the loss and its parts to ``LOSS_RTOL``
  (2e-4 relative), parameters, batch statistics and EMA each within
  ``TREE_TOL`` (2e-4) of the leaf's largest value, the momentum (the
  step's gradients) as a tree within 1e-2 relative L2 and leaf by leaf
  within 3e-2.
* Global-batch BatchNorm at world 4: output, input gradient and running
  statistics against flax's BatchNorm over the whole batch (rtol 1e-5);
  ``grouped_batch_stats`` and a BatchNorm reducing over groups of 2 of the
  4 against JAX's ``grouped_batch_stats`` (group 2 of 4).
* The SSL guard: a STAC batch split at ``unlabeled_start`` is refused on a
  mesh of two, naming ROADMAP A11b.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.parallel.dryrun import spawn_world  # noqa: E402

SPE = 10
BATCH = 4
# the port's train-step tests' rate: 0.04 · 4 / 64 = 0.0025, no warmup
EXTRA = dict(batch_size=BATCH, learning_rate=0.04)
BN_C, BN_ROWS = 3, 8


class Replay:
    """Replays recorded keep bits, one table a draw (in a rank)."""

    def __init__(self, tables):
        self.tables = list(tables)

    def draw(self, n, c, keep, device):
        bits = self.tables.pop(0)
        assert bits.shape == (n, c), (bits.shape, (n, c))
        return torch.from_numpy(bits).to(device)


def rank_inputs(path):
    """In a rank: the case's inputs, the port's config and a fresh state from
    the case's weights and its schedule, the dropout replaying the case's
    keep bits."""
    from udal_tpu_torch import config as torch_config
    from udal_tpu_torch.train import train_lib

    data = torch.load(path / "inputs.pt", weights_only=False)
    cfg = torch_config.get_detection_config("efficientdet-d0")
    cfg.override(data["overrides"], allow_new_keys=True)
    state, schedule = train_lib.create_train_state(cfg, SPE, device="cpu",
                                                   state_dict=data["state_dict"])
    train_lib.ChannelDropout = lambda generator: Replay(data["bits"])
    return data, cfg, state, schedule


def rank_batch(mesh, data):
    """This rank's rows of the case's global batch (``shard_batch``), as
    ``train_step`` takes them: (images, labels)."""
    from udal_tpu_torch.parallel.mesh import shard_batch

    rows = shard_batch(mesh, {"images": data["images"], **data["labels"]})
    return rows.pop("images"), rows


def _dp_rank(rank, info, path):
    """One rank of the world-2 step: its rows of the global batch in; the
    values, the state and the SSL guard's error out."""
    from udal_tpu_torch.parallel.mesh import make_mesh, replicate_state
    from udal_tpu_torch.train import train_lib
    from udal_tpu_torch.utils.checkpoint import state_payload

    data, cfg, state, schedule = rank_inputs(path)
    mesh = make_mesh(device="cpu")
    replicate_state(mesh, state)
    images, labels = rank_batch(mesh, data)
    state, vals = train_lib.train_step(cfg, schedule, SPE, state, images, labels)
    ssl = cfg.override(dict(ssl_method="STAC", unlabeled_start=2), allow_new_keys=True)
    try:
        train_lib.train_step(ssl, schedule, SPE, state, images, labels)
        ssl_error = None
    except ValueError as e:
        ssl_error = str(e)
    torch.save({"info": info, "mesh": (mesh.shape, mesh.data_index),
                "vals": {k: float(v) for k, v in vals.items()},
                "payload": state_payload(state), "ssl_error": ssl_error},
               path / f"rank{rank}.pt")


def _bn_rank(rank, info, path):
    """One rank of the world-4 BatchNorm checks (2 rows a rank)."""
    from udal_tpu_torch.models.efficientnet import BatchNorm
    from udal_tpu_torch.parallel.mesh import grouped_batch_stats, make_mesh

    d = np.load(path / "bn.npz")
    mesh = make_mesh(device="cpu")
    rows = mesh.data_rows(BN_ROWS)
    out = {}
    for tag, group in (("global", mesh.data_group), ("grouped", mesh.batch_norm_group(2))):
        bn = BatchNorm(BN_C).train()
        with torch.no_grad():
            for t, k in ((bn.weight, "scale"), (bn.bias, "bias"), (bn.running_mean, "mean"),
                         (bn.running_var, "var")):
                t.copy_(torch.from_numpy(d[k]))
        bn.group = group
        x = torch.from_numpy(d["x"][rows]).requires_grad_()
        y = bn(x)
        (y * torch.from_numpy(d["r"][rows])).sum().backward()
        out[tag] = dict(y=y.detach().numpy(), grad=x.grad.numpy(),
                        mean=bn.running_mean.numpy(), var=bn.running_var.numpy())
    mean, var = grouped_batch_stats(torch.from_numpy(d["x"][rows].transpose(0, 2, 3, 1)), mesh,
                                    group_size=2)
    out["grouped_batch_stats"] = (mean.numpy(), var.numpy())
    torch.save(out, path / f"bn{rank}.pt")


def mesh_case(path, seed, n_data, n_model, rank_fn):
    """One step of the reduced d0 from seeded flax weights, batch and keep
    bits: JAX's ``make_jitted_train_step`` on an (n_data, n_model) mesh of
    the virtual devices (tensor-parallel when n_model > 1, its
    ``spatial_dropout`` multiplying by the recorded masks), the port's
    single-process step, and ``rank_fn`` in n_data·n_model spawned ranks
    (each reads ``rank_inputs(path)`` and writes ``rank<r>.pt``)."""
    import jax

    import udal_tpu.models.efficientnet as jax_effnet
    import udal_tpu.models.heads as jax_heads
    import udal_tpu.parallel.mesh as jax_mesh
    import udal_tpu.train.train_lib as jax_train_lib
    from tests.test_torch_fixtures import random_variables, small_overrides
    from tests.test_torch_mc import MaskTable
    from tests.test_torch_train_step import (TRAIN, jax_state, keep_bits, make_batch,
                                             multipliers, port_state, site_shapes,
                                             train_configs)
    from udal_tpu.models.efficientdet import EfficientDetNet as JaxNet
    from udal_tpu_torch.convert import flax_to_torch
    from udal_tpu_torch.train import train_lib

    jax_cfg, torch_cfg = train_configs(mc=True, **EXTRA)
    variables = random_variables(jax_cfg, seed=seed)
    images, labels = make_batch(seed + 1, batch=BATCH)
    bits = keep_bits(np.random.RandomState(seed + 2), site_shapes(torch_cfg, images, labels))

    state, tx, schedule = jax_state(jax_cfg, variables)
    mesh = jax_mesh.make_mesh(n_data=n_data, n_model=n_model,
                              devices=jax.devices()[:n_data * n_model])
    sites = iter(multipliers(bits))

    def dropout(module, x, rate, active):
        if rate <= 0.0 or not active:
            return x
        m = next(sites)
        return x * m.reshape((x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],))

    with pytest.MonkeyPatch.context() as mp, mesh:
        mp.setattr(jax_effnet, "spatial_dropout", dropout)
        mp.setattr(jax_heads, "spatial_dropout", dropout)
        if n_model > 1:
            state = jax_mesh.shard_state_tp(mesh, state, tx)
        step = jax_train_lib.make_jitted_train_step(jax_cfg, JaxNet(jax_cfg), tx, schedule, SPE,
                                                    mesh, tensor_parallel=n_model > 1)
        batch = jax_mesh.shard_batch(mesh, {"images": images, **labels})
        jimages = batch.pop("images")
        jstate, jvals = step(state, jimages, batch, jax.random.PRNGKey(0))
        jvals = {k: float(v) for k, v in jvals.items()}
    assert next(sites, None) is None

    pstate, pschedule = port_state(torch_cfg, variables)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_lib, "ChannelDropout", lambda generator: MaskTable(bits))
        pstate, pvals = train_lib.train_step(torch_cfg, pschedule, SPE, pstate, images, labels)

    torch.save({"overrides": {**small_overrides(True), **TRAIN, **EXTRA},
                "state_dict": flax_to_torch(variables["params"], variables["batch_stats"]),
                "images": images, "labels": labels, "bits": bits}, path / "inputs.pt")
    spawn_world(rank_fn, n_data * n_model, path, device="cpu")
    ranks = [torch.load(path / f"rank{r}.pt", weights_only=False)
             for r in range(n_data * n_model)]
    return dict(jax=(jvals, jstate), world1=({k: float(v) for k, v in pvals.items()}, pstate),
                ranks=ranks, torch_cfg=torch_cfg, variables=variables)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX (2, 1) mesh step, the port's world-1 step and the port's
    world-2 ranks, from the same weights, batch and keep bits."""
    return mesh_case(tmp_path_factory.mktemp("dp"), 21, 2, 1, _dp_rank)


def rank_state(case, payload):
    """A port state holding a rank's saved (whole) state."""
    from tests.test_torch_train_step import port_state
    from udal_tpu_torch.utils.checkpoint import load_payload

    state, _ = port_state(case["torch_cfg"], case["variables"])
    return load_payload(state, payload)


def test_dp_step_at_world_2_matches_jax_mesh_step(dp):
    from tests.test_torch_train_step import assert_state_close, assert_values_close

    jvals, jstate = dp["jax"]
    for r, rank in enumerate(dp["ranks"]):
        assert rank["mesh"] == ({"data": 2, "model": 1}, r)
        assert_values_close(rank["vals"], jvals, f"rank {r}")
        assert_state_close(rank_state(dp, rank["payload"]), jstate, f"rank {r}")


def test_dp_step_at_world_2_matches_world_1(dp):
    """The ranks' step is the single process's over the whole batch: the
    same values and state, and the two ranks hold one state."""
    from tests.test_torch_train_step import (TREE_TOL, assert_tree_close, assert_values_close)
    from udal_tpu_torch.convert import train_state_to_flax

    vals, state = dp["world1"]
    want = train_state_to_flax(state)
    for r, rank in enumerate(dp["ranks"]):
        assert_values_close(rank["vals"], vals, f"rank {r} vs world 1")
        got = train_state_to_flax(rank_state(dp, rank["payload"]))
        for key in ("params", "batch_stats", "ema_params"):
            assert_tree_close(got[key], want[key], TREE_TOL, f"rank {r} {key}")
    a, b = (rank["payload"]["model"] for rank in dp["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_ranks_joined_by_initialize_multihost(dp):
    for r, rank in enumerate(dp["ranks"]):
        assert rank["info"] == {"process_index": r, "process_count": 2, "local_devices": 1,
                                "global_devices": 2}


def test_ssl_batches_are_refused_on_a_mesh_of_two(dp):
    for rank in dp["ranks"]:
        assert rank["ssl_error"] is not None and "A11b" in rank["ssl_error"]


def test_global_batch_norm_and_grouped_moments_match_jax(tmp_path):
    """Four ranks of 2 rows: the data group's BatchNorm equals flax's over
    the 8 rows (output, input gradient, running statistics), and the
    moments of groups of 2 ranks equal JAX's ``grouped_batch_stats`` on 4
    virtual devices."""
    import jax
    import jax.numpy as jnp
    from flax import linen as flax_nn

    from udal_tpu.parallel.mesh import grouped_batch_stats, make_mesh

    rng = np.random.RandomState(31)
    d = dict(x=rng.normal(0.5, 2.0, (BN_ROWS, BN_C, 3, 4)).astype(np.float32),
             r=rng.normal(0, 1, (BN_ROWS, BN_C, 3, 4)).astype(np.float32),
             scale=rng.uniform(0.5, 1.5, BN_C).astype(np.float32),
             bias=rng.normal(0, 0.1, BN_C).astype(np.float32),
             mean=rng.normal(0, 0.1, BN_C).astype(np.float32),
             var=rng.uniform(0.5, 1.5, BN_C).astype(np.float32))
    np.savez(tmp_path / "bn.npz", **d)
    spawn_world(_bn_rank, 4, tmp_path, device="cpu")
    ranks = [torch.load(tmp_path / f"bn{r}.pt", weights_only=False) for r in range(4)]

    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = {"params": {"scale": d["scale"], "bias": d["bias"]},
                 "batch_stats": {"mean": d["mean"], "var": d["var"]}}
    nhwc = jnp.asarray(d["x"].transpose(0, 2, 3, 1))
    r_nhwc = jnp.asarray(d["r"].transpose(0, 2, 3, 1))
    y, upd = bn.apply(variables, nhwc, mutable=["batch_stats"])
    grad = jax.grad(lambda x: jnp.sum(bn.apply(variables, x, mutable=["batch_stats"])[0]
                                      * r_nhwc))(nhwc)
    mesh = make_mesh(n_data=4, devices=jax.devices()[:4])
    g_mean, g_var = (np.asarray(a) for a in grouped_batch_stats(
        np.ascontiguousarray(d["x"].transpose(0, 2, 3, 1)), mesh, group_size=2))
    for r, out in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        glob = out["global"]
        np.testing.assert_allclose(glob["y"].transpose(0, 2, 3, 1), np.asarray(y)[rows],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(glob["grad"].transpose(0, 2, 3, 1), np.asarray(grad)[rows],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(glob["mean"], np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(glob["var"], np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-6, atol=1e-7)
        mean, var = out["grouped_batch_stats"]
        np.testing.assert_allclose(mean, g_mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(var, g_var, rtol=1e-4, atol=1e-5)
        grouped = out["grouped"]
        np.testing.assert_allclose(grouped["mean"], 0.99 * d["mean"] + 0.01 * g_mean[r],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(grouped["var"], 0.99 * d["var"] + 0.01 * g_var[r],
                                   rtol=1e-6, atol=1e-6)
    assert not np.allclose(g_mean[0], g_mean[2])
