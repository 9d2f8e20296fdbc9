"""Epoch loop: train, validate, checkpoint, resume and stop early.

Port of ``udal_tpu/train/loop.py``'s ``train_and_evaluate``: an epoch of
``steps_per_epoch`` steps from ``train_iter``, one ``train_step`` call a
step, the validation loss through ``eval_step``, the COCO AP every
``map_freq`` epochs (``train/callbacks.py``), a checkpoint every
``save_freq`` epochs keeping the newest ``keep_checkpoint_max`` (at least
2), a resume from the latest checkpoint in ``model_dir``, and early
stopping that restores the best state.

Over several processes (``parallel.mesh``) every rank runs the loop: a
mesh of the world's ranks, ``config.n_model`` of them to a model group;
every rank restores, then the state is broadcast from rank 0 and, with
``n_model`` > 1, sharded over the model groups. Rank 0 alone writes the
checkpoints, the metrics, the COCO callback's output and the log; the
validation loss is averaged over the data group, so every rank takes the
same early-stopping decision and the ranks stop together.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from udal_tpu_torch.data.label_maps import get_label_map
from udal_tpu_torch.parallel.collectives import all_reduce
from udal_tpu_torch.parallel.mesh import make_mesh, replicate_state, shard_state_tp
from udal_tpu_torch.train.callbacks import COCOCallback
from udal_tpu_torch.train.train_lib import (create_train_state, eval_step, resolve_device,
                                            train_step)
from udal_tpu_torch.utils.checkpoint import (load_payload, restore_checkpoint,
                                             save_checkpoint, state_payload)
from udal_tpu_torch.utils.metrics_writer import MetricsWriter


class EarlyStopping:
    """Stops after ``patience`` epochs without a validation loss below the
    best less ``min_delta``; keeps a copy of the best state."""

    def __init__(self, patience: int, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = np.inf
        self.best_state = None
        self.count = 0

    def update(self, value: float, state) -> bool:
        """Returns True when training should stop."""
        if value < self.best - self.min_delta:
            self.best = value
            self.best_state = state_payload(state)
            self.count = 0
            return False
        self.count += 1
        return self.patience > 0 and self.count >= self.patience


def train_and_evaluate(config, train_iter: Iterator, steps_per_epoch: int, model_dir: str,
                       val_iter_fn: Optional[Callable[[], Iterator]] = None,
                       val_steps: int = 0, seed: int = 0, device=None,
                       log_fn: Callable[[str], None] = print,
                       coco_eval_fn: Optional[Callable] = None,
                       mesh=None) -> Dict[str, List[float]]:
    """Train for ``config.num_epochs`` epochs on ``device`` (the card
    unless ``device="cpu"``); returns the history: ``loss`` and
    ``val_loss`` per epoch, and ``final_state``.

    ``train_iter`` yields (images, labels) in either batch contract
    ``train_lib.prepare_batch`` takes (list-valued labels are dropped);
    ``val_iter_fn()`` gives a fresh validation iterator of ``val_steps``
    batches. The weights are drawn from ``seed`` (as flax's initializers
    draw them), and the dropout of step s from (``seed``, s).

    The host reads a loss only every ``host_sync_every`` steps (8), one
    that many steps old, so it runs ahead of the device; the epoch's mean
    is read once at its end. Every ``map_freq`` epochs (when there is a
    validation stream and ``map_freq`` > 0) ``coco_eval_fn(epoch, state,
    metrics_writer)`` returns the AP, recorded as ``history["AP"]``; by
    default a ``COCOCallback`` over ``val_iter_fn`` writing under
    ``model_dir/logs``. ``steps_per_execution`` is accepted and has
    no effect: eager PyTorch has no multi-step program to amortise a
    call's dispatch over, and k single steps give the same state and
    history as the JAX package's k-step call.

    ``mesh`` (``parallel.mesh.make_mesh``) runs the loop data- and
    tensor-parallel; without one it is made when the process group spans
    more than one rank or ``config.n_model`` > 1. ``config.batch_size``
    stays the global batch: each rank's ``train_iter`` yields its
    ``batch_size / n_data`` rows (a reader sharded by data rank), or the
    global batch, whose rows ``train_step`` takes.
    """
    n_model = int(config.get("n_model", 1) or 1)
    if mesh is None and (n_model > 1 or (torch.distributed.is_initialized()
                                         and torch.distributed.get_world_size() > 1)):
        mesh = make_mesh(n_model=n_model, device=device)
    device = mesh.device if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    if not lead:
        log_fn = lambda msg: None  # noqa: E731 - rank 0 logs
    state, schedule = create_train_state(config, steps_per_epoch,
                                         torch.Generator().manual_seed(seed), device)
    state, start_epoch = restore_checkpoint(model_dir, state)
    if mesh is not None:
        state = (shard_state_tp if mesh.shape["model"] > 1 else replicate_state)(mesh, state)

    def whole():
        """The state unsharded while open, under tensor parallelism."""
        return state.tp.gathered(state) if state.tp is not None else contextlib.nullcontext()

    stopper = EarlyStopping(config.early_stopping_patience or 0)
    history: Dict[str, List] = {"loss": [], "val_loss": []}
    keep_n = max(2, int(config.get("keep_checkpoint_max", 5) or 5))
    metrics_writer = MetricsWriter(os.path.join(model_dir, "logs")) if lead else None
    sync_every = max(1, int(config.get("host_sync_every", 8) or 8))
    map_freq = int(config.get("map_freq", 0) or 0)
    if coco_eval_fn is None and val_iter_fn is not None and val_steps > 0 and map_freq > 0:
        try:
            label_map = get_label_map(config.get("label_map"))
        except KeyError:                # a name the registry lacks: numbered classes
            label_map = None
        coco_eval_fn = COCOCallback(config, val_iter_fn, val_steps,
                                    os.path.join(model_dir, "logs"), label_map=label_map)

    def next_batch():
        images, labels = next(train_iter)
        return images, {k: v for k, v in labels.items() if not isinstance(v, list)}

    for epoch in range(start_epoch, int(config.num_epochs)):
        t0 = time.time()
        losses = []
        for _ in range(steps_per_epoch):
            state, vals = train_step(config, schedule, steps_per_epoch, state,
                                     *next_batch(), seed)
            losses.append(vals["loss"])
            if len(losses) % sync_every == 0:
                # a bounded lag: wait for a result sync_every steps old
                float(losses[-sync_every])
        epoch_loss = float(torch.stack(losses).float().mean())
        history["loss"].append(epoch_loss)
        msg = (f"epoch {epoch + 1}/{config.num_epochs} "
               f"loss={epoch_loss:.4f} ({time.time() - t0:.1f}s)")

        with whole():
            val_loss = None
            if val_iter_fn is not None and val_steps > 0:
                vit = val_iter_fn()
                vlosses = []
                for _ in range(val_steps):
                    images, labels = next(vit)
                    labels = {k: v for k, v in labels.items() if not isinstance(v, list)}
                    vlosses.append(eval_step(config, state, images, labels)["val_det_loss"])
                mean = torch.stack(vlosses).float().mean().reshape(1)
                if mesh is not None:        # the data ranks' mean: one decision everywhere
                    mean = all_reduce(mean, mesh.data_group) / mesh.shape["data"]
                val_loss = float(mean[0])
                history["val_loss"].append(val_loss)
                msg += f" val_loss={val_loss:.4f}"

            if (lead and coco_eval_fn is not None and map_freq > 0
                    and (epoch + 1) % map_freq == 0):
                ap = coco_eval_fn(epoch + 1, state, metrics_writer)
                history.setdefault("AP", []).append(float(ap))
                msg += f" AP={ap:.4f}"

            log_fn(msg)
            if lead:
                metrics_writer.write(epoch + 1, {
                    "loss": epoch_loss,
                    **({"val_loss": val_loss} if val_loss is not None else {})})

            if lead and (epoch + 1) % max(1, int(config.save_freq)) == 0:
                save_checkpoint(model_dir, state, epoch + 1, keep_last_n=keep_n)

            stop = val_loss is not None and stopper.update(val_loss, state)
            if stop:
                log_fn(f"early stopping at epoch {epoch + 1}; restoring best")
                if stopper.best_state is not None:
                    load_payload(state, stopper.best_state)
                    if lead:
                        save_checkpoint(model_dir, state, epoch + 1, keep_last_n=keep_n)
        if stop:
            break

    if lead:
        metrics_writer.close()
    history["final_state"] = state  # type: ignore[assignment]
    return history
