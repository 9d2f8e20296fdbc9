"""The port's serving over a mesh, its process-group handshake and the
multi-process CLI, on the CPU (ranks: spawned gloo processes importing
only torch and the port, as in ``test_torch_parallel_train.py``).

* ``serve_sharded`` at world 2 (each rank serves its 2 of 4 images) equals
  ``serve`` of the 4 from the same seed, as matched sets (IoU ≥ 0.99,
  score within 1e-4, σ as ``test_torch_mc.py`` holds them), on the MC path
  with the shared prefix and block-0 fold; at a world of one it serves in
  batches of ``batch_size`` and equals that many ``serve`` calls, to
  1e-5.
* ``serve_sample_parallel`` at world 2 (one of T = 2 head-only MC samples
  a rank, the moments all-reduced) equals the JAX package's
  ``serve_sample_parallel`` on a (2, 1) mesh of virtual devices under the
  JAX side's recorded masks (its ``mc_forward`` replaced by the recorded
  samples, as ``test_torch_serving_surface.py`` injects them), and the
  port's single-process ``serve`` under the same masks, as matched sets;
  both ranks return the same detections. A sample count the data axis does
  not divide raises JAX's error.
* ``initialize_multihost``: without arguments or torchrun's environment a
  world of one; spawned ranks joined from torchrun's environment run
  ``cli train --n_model 2`` (a (1, 2) mesh) for an epoch of 2 steps to a
  finite loss, rank 0 writing the checkpoint.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_parallel_train import Replay  # noqa: E402
from udal_tpu_torch.parallel.dryrun import spawn_world  # noqa: E402

T = 2
MC = dict(image_size="64x64")
HEAD = dict(image_size="64x64", mc_dropoutrate=0.0, mc_classheadrate=0.05,
            mc_boxheadrate=0.05, enable_softmax=True)


def _config(overrides):
    from udal_tpu_torch import config as torch_config

    cfg = torch_config.get_detection_config("efficientdet-d0")
    cfg.override(overrides, allow_new_keys=True)
    return cfg


def _serve_rank(rank, info, path):
    from udal_tpu_torch.apps.serving import ServingDriver
    from udal_tpu_torch.parallel.mesh import make_mesh

    d = torch.load(path / "serve.pt", weights_only=False)
    mesh = make_mesh(device="cpu")
    driver = ServingDriver(_config(d["mc"]), d["mc_state"], batch_size=2, device="cpu",
                           mc_seed=5)
    sharded = driver.serve_sharded(mesh, d["pool"])
    head = ServingDriver(_config(d["head"]), d["head_state"], batch_size=2, device="cpu")
    head.masks = Replay(d["sites"])
    sample = head.serve_sample_parallel(mesh, d["raw"])
    left = len(head.masks.tables)
    odd = ServingDriver(_config(dict(d["head"], mc_dropoutsamp=3)), d["head_state"],
                        device="cpu")
    try:
        odd.serve_sample_parallel(mesh, d["raw"])
        odd_error = None
    except ValueError as e:
        odd_error = str(e)
    torch.save({"sharded": [t.numpy() for t in sharded], "sample": [t.numpy() for t in sample],
                "left": left, "odd_error": odd_error}, path / f"serve{rank}.pt")


def _cli_rank(rank, info, path):
    from udal_tpu_torch import cli

    hist = cli.main(["train", "--train_file_pattern", str(path / "t.tfrecord"), "--model_dir",
                     str(path / "m"), "--batch_size", "2", "--num_epochs", "1",
                     "--steps_per_epoch", "2", "--device", "cpu", "--n_model", "2",
                     "--hparams", "image_size=64x64,num_classes=8,fpn_cell_repeats=1,"
                     "box_class_repeats=1"])
    torch.save({"info": info, "loss": hist["loss"], "step": hist["final_state"].step,
                "sharded": hist["final_state"].tp is not None}, path / f"cli{rank}.pt")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks' serves, and the JAX and single-process references."""
    import jax
    import jax.numpy as jnp

    import udal_tpu.apps.serving as jax_serving
    from tests.test_torch_fixtures import configs, random_variables, small_overrides
    from tests.test_torch_head_mc import head_samples
    from udal_tpu.parallel.mesh import make_mesh
    from udal_tpu_torch.convert import flax_to_torch

    path = tmp_path_factory.mktemp("serve")
    rng = np.random.RandomState(51)
    pool = rng.randint(0, 256, (4, 48, 80, 3)).astype(np.uint8)
    raw = rng.randint(0, 256, (2, 50, 64, 3)).astype(np.uint8)

    mc_jax, _ = configs(mc=True, samples=T, extra=MC)
    mc_vars = random_variables(mc_jax, seed=52)
    head_jax, _ = configs(mc=True, samples=T, extra=HEAD)
    head_vars = random_variables(head_jax, seed=53)
    jdrv = jax_serving.ServingDriver(head_jax, head_vars, 2, use_pallas_nms=False)
    net_in, scales = jax_serving.preprocess_images(jnp.asarray(raw), head_jax.image_size,
                                                   head_jax.mean_rgb, head_jax.stddev_rgb)
    cls, box, sites = head_samples(head_jax, head_vars, np.asarray(net_in),
                                   np.random.RandomState(54), samples=T)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_serving, "mc_forward", lambda *a: (cls, box))
        want = jdrv.serve_sample_parallel(make_mesh(n_data=2, devices=jax.devices()[:2]), raw)

    d = {"pool": pool, "raw": raw, "sites": sites,
         "mc": {**small_overrides(True, T), **MC},
         "head": {**small_overrides(True, T), **HEAD},
         "mc_state": flax_to_torch(mc_vars["params"], mc_vars["batch_stats"]),
         "head_state": flax_to_torch(head_vars["params"], head_vars["batch_stats"])}
    torch.save(d, path / "serve.pt")
    spawn_world(_serve_rank, 2, path, device="cpu")
    ranks = [torch.load(path / f"serve{r}.pt", weights_only=False) for r in range(2)]
    return dict(d, ranks=ranks, jax=[np.asarray(t) for t in want[:4]],
                sigma_args=(head_jax, cls, box, np.asarray(scales)))


def test_serve_sharded_equals_serve(served):
    from tests.test_torch_mc import check_sigmas, match_detections
    from udal_tpu_torch.apps.serving import ServingDriver

    ref = ServingDriver(_config(served["mc"]), served["mc_state"], device="cpu", mc_seed=5)
    want = ref.serve(served["pool"])
    for rank in served["ranks"]:
        got = [torch.from_numpy(t) for t in rank["sharded"]]
        assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
        match_detections(got, want, check_sigmas)


def test_serve_sharded_at_a_world_of_one_is_serve_batch_by_batch(served):
    from udal_tpu_torch.apps.serving import ServingDriver
    from udal_tpu_torch.parallel.mesh import make_mesh

    def driver():
        return ServingDriver(_config(served["mc"]), served["mc_state"], batch_size=2,
                             device="cpu", mc_seed=5)

    got = driver().serve_sharded(make_mesh(device="cpu"), served["pool"])
    ref = driver()
    parts = [ref.serve(served["pool"][:2]), ref.serve(served["pool"][2:])]
    for g, w in zip(got, (torch.cat(ts) for ts in zip(*parts))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_serve_sample_parallel_equals_jax_and_serve(served):
    from tests.test_torch_head_mc import sigma_check
    from tests.test_torch_mc import MaskTable, match_detections
    from udal_tpu_torch.apps.serving import ServingDriver

    check = sigma_check(*served["sigma_args"])
    single = ServingDriver(_config(served["head"]), served["head_state"], device="cpu")
    single.masks = MaskTable(served["sites"])
    alone = single.serve(served["raw"])
    for rank in served["ranks"]:
        assert rank["left"] == 0
        got = [torch.from_numpy(t) for t in rank["sample"][:4]]
        match_detections(got, served["jax"], check)
        match_detections(got, [t.numpy() for t in alone[:4]], check)
    for a, b in zip(*(rank["sample"] for rank in served["ranks"])):
        np.testing.assert_array_equal(a, b)


def test_serve_sample_parallel_needs_the_samples_to_divide(served):
    for rank in served["ranks"]:
        assert rank["odd_error"] == ("serve_sample_parallel requires the sample axis (3) "
                                     "divisible by the mesh 'data' axis (2)")


def test_initialize_multihost_alone_is_a_world_of_one(monkeypatch):
    from udal_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    info = initialize_multihost(device="cpu")
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1}
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None
    with pytest.raises(ValueError, match="world of that size"):
        make_mesh(n_data=2, device="cpu")


def test_cli_train_n_model_2_over_two_processes(tmp_path):
    from udal_tpu_torch.data.synthetic import write_synthetic_dataset
    from udal_tpu_torch.utils.checkpoint import latest_checkpoint

    write_synthetic_dataset(str(tmp_path / "t.tfrecord"), num_images=4, height=48, width=80,
                            num_classes=7)
    spawn_world(_cli_rank, 2, tmp_path, device="cpu", torchrun_env=True)
    ranks = [torch.load(tmp_path / f"cli{r}.pt", weights_only=False) for r in range(2)]
    for r, rank in enumerate(ranks):
        assert rank["info"]["process_index"] == r and rank["info"]["process_count"] == 2
        assert rank["sharded"] and rank["step"] == 2
        assert len(rank["loss"]) == 1 and np.isfinite(rank["loss"][0])
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert latest_checkpoint(str(tmp_path / "m")) == 1
    assert (tmp_path / "m" / "config.yaml").exists()
    # rank 0 wrote the whole state, gathered from the model group's slices
    from udal_tpu_torch.models.efficientdet import EfficientDetNet
    from udal_tpu_torch.utils.checkpoint import load_checkpoint

    saved = load_checkpoint(str(tmp_path / "m"), 1)
    whole = EfficientDetNet(_config(dict(image_size="64x64", num_classes=8, fpn_cell_repeats=1,
                                         box_class_repeats=1))).state_dict()
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == \
        {k: tuple(v.shape) for k, v in whole.items()}
    momenta = [v["momentum_buffer"] for v in saved["optimizer"]["state"].values()]
    params = [p for p in EfficientDetNet(_config(dict(
        image_size="64x64", num_classes=8, fpn_cell_repeats=1, box_class_repeats=1))).parameters()]
    assert [tuple(m.shape) for m in momenta] == [tuple(p.shape) for p in params]


def test_dryrun_multichip_on_four_gloo_processes():
    """``parallel.dryrun.dryrun_multichip(4)`` on the CPU: a tensor-parallel
    step on a (2, 2) mesh, ``serve_sharded`` of the pool with its AL
    scores and ``serve_sample_parallel``, in four spawned gloo processes
    (each rank asserts its results finite)."""
    from udal_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, device="cpu")
