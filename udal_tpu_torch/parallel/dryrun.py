"""Multi-process dry run of the port's distributed paths.

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``:
``dryrun_multichip(n)`` takes one training step of a small d0 on a mesh of
n ranks, ``(n/2, 2)`` (data x model, tensor parallelism) when n ≥ 4 and
even, else ``(n, 1)``; then serves a pool with ``serve_sharded``, scores it
for active learning (``apps.active_learning.score_images``) and serves one
image with ``serve_sample_parallel``. On the CPU it spawns n gloo
processes; on the card it runs a world of one over NCCL in this process
(the card's machine has one GPU).

    python -m udal_tpu_torch.parallel.dryrun [N] [--device cpu]

``spawn_world`` is the launcher: n processes started by ``spawn`` (each
imports only torch and the port), each joining a gloo or NCCL group over
TCP on 127.0.0.1 before it runs its function.
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int, device: Optional[str],
               backend: Optional[str], torchrun_env: bool, args: tuple) -> None:
    from udal_tpu_torch.parallel.mesh import initialize_multihost

    torch.set_num_threads(1)
    if torchrun_env:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                          LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
        info = initialize_multihost(device=device, backend=backend)
    else:
        info = initialize_multihost(f"127.0.0.1:{port}", world, rank, device=device,
                                    backend=backend)
    try:
        fn(rank, info, *args)
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable, world: int, *args, device: Optional[str] = None,
                backend: Optional[str] = None, torchrun_env: bool = False) -> None:
    """Run ``fn(rank, info, *args)`` in ``world`` spawned processes, each in
    the process group (``initialize_multihost``'s summary as ``info``),
    joined from explicit arguments or, with ``torchrun_env``, from the
    environment torchrun would set; raises when a process fails. ``fn``
    must be importable by name. The ranks run on the cards (NCCL, a rank's
    card by its local rank) unless ``device="cpu"`` asks for gloo on the
    CPU; without a card it raises before spawning."""
    from udal_tpu_torch.parallel.mesh import rank_device

    rank_device(device, 0)
    mp.start_processes(_rank_main, (fn, world, free_port(), device, backend, torchrun_env,
                                    args),
                       nprocs=world, join=True, start_method="spawn")


def _small_config(n_data: int):
    from udal_tpu_torch.config import get_detection_config

    cfg = get_detection_config("efficientdet-d0")
    cfg.override(dict(image_size=64, num_classes=8, loss_attenuation=True,
                      mc_dropout=True, mc_dropoutrate=0.05, mc_dropoutsamp=max(n_data, 2)))
    cfg.override({"batch_size": 2 * n_data}, allow_new_keys=True)
    return cfg


def dryrun_rank(rank: int, info: dict, n_devices: int, device: str) -> None:
    """One rank's share of the dry run (module docstring)."""
    from udal_tpu_torch.apps.active_learning import score_images
    from udal_tpu_torch.apps.infer import split_serve_outputs
    from udal_tpu_torch.apps.serving import ServingDriver
    from udal_tpu_torch.data.synthetic import synthetic_batch
    from udal_tpu_torch.parallel.mesh import (make_mesh, replicate_state, shard_batch,
                                              shard_state_tp)
    from udal_tpu_torch.train.train_lib import create_train_state, train_step

    n_model = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    n_data = n_devices // n_model
    mesh = make_mesh(n_data, n_model, device=device)
    cfg = _small_config(n_data)
    state, schedule = create_train_state(cfg, 10, device=mesh.device)
    state = (shard_state_tp if n_model > 1 else replicate_state)(mesh, state)
    rng = np.random.RandomState(0)
    images, labels = synthetic_batch(rng, cfg.batch_size, 64, 64, cfg.num_classes)
    rows = shard_batch(mesh, {"images": images, **labels})
    state, vals = train_step(cfg, schedule, 10, state, rows.pop("images"), rows)
    if not np.isfinite(float(vals["loss"])):
        raise AssertionError(f"rank {rank}: non-finite training loss {vals}")

    with state.tp.gathered(state) if state.tp is not None else contextlib.nullcontext():
        weights = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    driver = ServingDriver(cfg, weights, batch_size=2, device=mesh.device,
                           dtype=torch.float32)
    pool = (rng.rand(2 * n_data, 64, 64, 3) * 255).astype(np.uint8)
    packed = driver.serve_sharded(mesh, pool)
    out = split_serve_outputs(cfg, tuple(t.cpu().numpy() for t in packed))
    rows = [{"image_name": f"img{i}", "det_score": float(out["scores"][i][d]),
             "class": float(out["classes"][i][d]),
             "bbox": [float(x) for x in out["boxes"][i][d]]}
            for i in range(len(pool)) for d in range(min(int(out["valid_len"][i]), 3))]
    if rows:
        scores, _, _ = score_images(rows, "mean_score")
        if not np.all(np.isfinite(scores)):
            raise AssertionError(f"rank {rank}: non-finite AL pool scores")
    sp = driver.serve_sample_parallel(mesh, pool[:1])
    if not all(bool(torch.isfinite(t.float()).all()) for t in sp):
        raise AssertionError(f"rank {rank}: non-finite sample-parallel detections")


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """The dry run over ``n_devices`` ranks: gloo CPU processes with
    ``device="cpu"``; on the card (the default) a world of one over NCCL."""
    device = device or "cuda"
    if device == "cpu":
        spawn_world(dryrun_rank, n_devices, n_devices, "cpu", device="cpu")
        return
    if n_devices != 1:
        raise ValueError("on the card the dry run is a world of one (one GPU a machine); "
                         "pass device='cpu' for more ranks")
    from udal_tpu_torch.parallel.mesh import initialize_multihost

    info = initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=device)
    try:
        dryrun_rank(0, info, 1, device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    argv = sys.argv[1:]
    dev = "cpu" if "--device" in argv and argv[argv.index("--device") + 1] == "cpu" else None
    nums = [a for a in argv if a.isdigit()]
    n = int(nums[0]) if nums else 1
    dryrun_multichip(n, dev)
    print(f"dryrun_multichip({n}) OK")
