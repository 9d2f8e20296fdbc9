"""The port's tensor parallelism (the mesh's 'model' axis) against the JAX
package's, on the CPU.

* ``param_partition_spec`` splits exactly the leaves JAX's splits (the last
  axis of a flax leaf where it divides), on the dim ``convert.py`` maps
  that axis to: every leaf of a d0 with the segmentation head, whose
  transposed convs hold it on dim 1. A slice of the port's tensor on that
  dim converts to the same slice of the flax leaf.
* ``shard_opt_state_tp`` keeps restored Adam moments, sliced as their
  parameters, and the step count (JAX's
  ``test_shard_state_tp_preserves_opt_state``).
* One step on a (2, 2) mesh of four spawned gloo ranks (channel-parallel
  MBConv blocks, gathered weights elsewhere), from the reduced d0 and
  recorded keep bits of ``test_torch_parallel_train.py``, against JAX's
  tensor-parallel ``make_jitted_train_step`` on a (2, 2) mesh of the
  virtual devices and against the port's single-process (data-parallel
  world 1) step: the loss and its parts, and every parameter, batch
  statistic and EMA leaf, within JAX's own TP-vs-DP tolerance
  (``tests/test_tensor_parallel.py``: rtol = atol = 2e-3; leaves against
  2e-3 of their largest value); the momentum (the step's gradients) with
  ``test_torch_train_step.py``'s gradient tolerance (1e-2 relative L2 of
  the tree, 3e-2 leaf by leaf past the rounding noise). Each rank holds
  about half the sharded state's bytes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_parallel_train import (SPE, mesh_case, rank_batch, rank_inputs,  # noqa: E402
                                             rank_state)
from udal_tpu_torch.parallel.dryrun import spawn_world  # noqa: E402

TP_TOL = 2e-3


def _tp_rank(rank, info, path):
    """One rank of the (2, 2) step: the whole state (gathered) and the
    rank's own bytes out."""
    from udal_tpu_torch.parallel.mesh import make_mesh, shard_state_tp
    from udal_tpu_torch.train import train_lib
    from udal_tpu_torch.utils.checkpoint import state_payload

    data, cfg, state, schedule = rank_inputs(path)

    def nbytes(st):
        ts = list(st.model.parameters()) + [v for s in st.optimizer.state.values()
                                            for v in s.values() if torch.is_tensor(v)]
        return sum(t.numel() * t.element_size() for t in ts)

    mesh = make_mesh(n_model=2, device="cpu")
    shard_state_tp(mesh, state)
    state, vals = train_lib.train_step(cfg, schedule, SPE, state, *rank_batch(mesh, data))
    local = nbytes(state)
    expand = tuple(state.model.backbone.blocks_1.expand_conv.weight.shape)
    with state.tp.gathered(state):
        payload = state_payload(state)
        whole = nbytes(state)
    torch.save({"mesh": (mesh.shape, mesh.data_index, mesh.model_index),
                "vals": {k: float(v) for k, v in vals.items()}, "payload": payload,
                "bytes": (local, whole), "expand": expand,
                "channel_parallel": sum(b.tp is not None for b in state.model.modules()
                                        if hasattr(b, "tp") and hasattr(b, "folded"))},
               path / f"rank{rank}.pt")


def test_param_partition_spec_follows_the_converter():
    import jax

    from udal_tpu.parallel.mesh import param_partition_spec as jax_spec
    from udal_tpu_torch import config as torch_config
    from udal_tpu_torch.convert import _flax_leaf
    from udal_tpu_torch.models.efficientdet import EfficientDetNet
    from udal_tpu_torch.parallel.mesh import param_partition_spec

    cfg = torch_config.get_detection_config("efficientdet-d0")
    cfg.override(dict(image_size=64, num_classes=8, fpn_cell_repeats=1, box_class_repeats=1,
                      heads=["object_detection", "segmentation"]))
    model = EfficientDetNet(cfg)
    seen = {"sharded": 0, "replicated": 0, "transposed": 0}
    for name, mod in model.named_modules():
        path = name.split(".") if name else []
        for leaf, t in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            t = torch.randn(t.shape)
            _, fpath, v = _flax_leaf(mod, path, leaf, t)
            full = ".".join(path + [leaf])
            dim = param_partition_spec(full, t, 2)
            want = jax_spec("/".join(fpath), v, 2)
            assert (dim is not None) == (want == jax.sharding.PartitionSpec(
                *([None] * (v.ndim - 1) + ["model"]))), full
            if dim is None:
                seen["replicated"] += 1
                continue
            seen["sharded"] += 1
            seen["transposed"] += dim == 1
            half = t.shape[dim] // 2
            _, _, v_slice = _flax_leaf(mod, path, leaf, t.narrow(dim, half, half))
            np.testing.assert_array_equal(v_slice, v[..., half:], err_msg=full)
    assert seen["transposed"] > 0 and seen["replicated"] > 0 and seen["sharded"] > 100
    assert param_partition_spec("x", torch.zeros(()), 2) is None
    assert param_partition_spec("bn.weight", torch.zeros(33), 2) is None
    assert param_partition_spec("bn.weight", torch.zeros(32), 1) is None


def test_shard_opt_state_tp_keeps_restored_moments():
    """A restored Adam state (moments not zero, a step count) resharded for
    rank 1 of a model group of 2: every moment is its parameter's slice of
    the restored one, unsplit moments stay whole, the count stays."""
    from udal_tpu_torch import config as torch_config
    from udal_tpu_torch.parallel.mesh import Mesh, param_partition_spec, shard_opt_state_tp
    from udal_tpu_torch.train import train_lib

    cfg = torch_config.get_detection_config("efficientdet-d0")
    cfg.override(dict(image_size=64, num_classes=8, fpn_cell_repeats=1, box_class_repeats=1,
                      optimizer="adam"))
    state, _ = train_lib.create_train_state(cfg, SPE, device="cpu")
    rng = torch.Generator().manual_seed(0)
    names = {p: n for n, p in state.model.named_parameters()}
    restored = {}
    for p in names:
        restored[p] = {"step": torch.tensor(7.0),
                       "exp_avg": torch.rand(p.shape, generator=rng),
                       "exp_avg_sq": torch.rand(p.shape, generator=rng)}
        state.optimizer.state[p] = {k: v.clone() for k, v in restored[p].items()}
    mesh = Mesh({"data": 1, "model": 2}, rank=1, device=torch.device("cpu"))
    shard_opt_state_tp(mesh, state.optimizer, names)
    sliced = 0
    for p, name in names.items():
        st = state.optimizer.state[p]
        assert float(st["step"]) == 7.0
        dim = param_partition_spec(name, p, 2)
        for key in ("exp_avg", "exp_avg_sq"):
            want = restored[p][key]
            if dim is not None:
                n = want.shape[dim] // 2
                want = want.narrow(dim, n, n)
                sliced += 1
            assert torch.equal(st[key], want), (name, key)
    assert sliced > 100


def test_shard_batch_takes_the_data_ranks_rows():
    """Rank 3 of a (2, 2) mesh is data rank 1: rows [2, 4) of a global
    batch of 4, as ``P('data')`` lays them out; a batch the data axis does
    not divide raises."""
    from udal_tpu_torch.parallel.mesh import Mesh, shard_batch

    mesh = Mesh({"data": 2, "model": 2}, rank=3, device=torch.device("cpu"))
    batch = {"images": np.arange(4 * 3).reshape(4, 3), "ids": torch.arange(4)}
    out = shard_batch(mesh, batch)
    np.testing.assert_array_equal(out["images"].numpy(), batch["images"][2:])
    assert out["ids"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, {"x": np.zeros((3, 1))})


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """JAX's tensor-parallel step on a (2, 2) mesh, the port's single-process
    step and the port's four (2, 2) ranks, from the same weights, batch and
    keep bits."""
    return mesh_case(tmp_path_factory.mktemp("tp"), 41, 2, 2, _tp_rank)


def _assert_close(got_vals, got_state, want_vals, want_tree, what):
    from tests.test_torch_train_step import assert_grads_close, assert_tree_close
    from udal_tpu_torch.convert import train_state_to_flax

    for k, v in want_vals.items():
        np.testing.assert_allclose(got_vals[k], v, rtol=TP_TOL, atol=TP_TOL,
                                   err_msg=f"{what} {k}")
    assert set(got_vals) == set(want_vals)
    got = train_state_to_flax(got_state)
    for key in ("params", "batch_stats", "ema_params"):
        assert_tree_close(got[key], want_tree[key], TP_TOL, f"{what} {key}")
    assert_grads_close(got["opt_state"]["trace"], want_tree["trace"], True, f"{what} momentum")


def test_tp_step_matches_jax_tp_step(tp):
    jvals, jstate = tp["jax"]
    want = dict(params=jstate.params, batch_stats=jstate.batch_stats,
                ema_params=jstate.ema_params, trace=jstate.opt_state[0].trace)
    for r, rank in enumerate(tp["ranks"]):
        assert rank["mesh"] == ({"data": 2, "model": 2}, r // 2, r % 2)
        _assert_close(rank["vals"], rank_state(tp, rank["payload"]), jvals, want, f"rank {r}")


def test_tp_step_matches_dp_step(tp):
    from udal_tpu_torch.convert import train_state_to_flax

    vals, state = tp["world1"]
    flax = train_state_to_flax(state)
    want = dict(params=flax["params"], batch_stats=flax["batch_stats"],
                ema_params=flax["ema_params"], trace=flax["opt_state"]["trace"])
    for r, rank in enumerate(tp["ranks"]):
        _assert_close(rank["vals"], rank_state(tp, rank["payload"]), vals, want, f"rank {r}")


def test_tp_ranks_hold_their_slices(tp):
    """Every MBConv block runs channel-parallel (d0's widths all divide by
    2); block 1's expand conv holds 48 of its 96 output channels; a rank's
    parameters and optimizer buffers take under 60% of the whole state's
    bytes (the replicated leaves are the rest); the ranks of a model group
    gather one state."""
    for rank in tp["ranks"]:
        assert rank["channel_parallel"] == 16
        assert rank["expand"] == (48, 16, 1, 1)
        local, whole = rank["bytes"]
        assert local < 0.6 * whole, (local, whole)
    for a, b in ((0, 1), (2, 3), (0, 2)):
        pa, pb = (tp["ranks"][i]["payload"]["model"] for i in (a, b))
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
