"""Learning-rate schedules, the optimizer and gradient clipping.

Port of ``udal_tpu/train/schedules.py``. A schedule is a plain function of
the step count: stepwise, cosine or polynomial decay after a linear warmup,
the learning rate scaled by batch_size / 64. optax's SGD with momentum
(trace = g + m·trace, update −lr·trace) is ``torch.optim.SGD`` with
dampening 0; its Adam is ``torch.optim.Adam`` with b1 = ``config.momentum``
and eps 1e-8. optax reads the schedule at the step count before the update;
``train_lib.train_step`` sets each group's rate from it before stepping.
Clipping is per tensor, then global, as a transform of its own in the step.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from udal_tpu_torch.parallel.collectives import all_reduce

Schedule = Callable[[int], float]


def _warmup(step: int, lr_warmup_init: float, adjusted_lr: float, warmup_steps: int) -> float:
    return lr_warmup_init + step / max(warmup_steps, 1) * (adjusted_lr - lr_warmup_init)


def stepwise_lr(adjusted_lr: float, lr_warmup_init: float, warmup_steps: int,
                first_drop_step: int, second_drop_step: int) -> Schedule:
    def schedule(step: int) -> float:
        lr = (_warmup(step, lr_warmup_init, adjusted_lr, warmup_steps)
              if step < warmup_steps else adjusted_lr)
        for mult, start in ((1.0, warmup_steps), (0.1, first_drop_step),
                            (0.01, second_drop_step)):
            if step >= start:
                lr = adjusted_lr * mult
        return lr
    return schedule


def cosine_lr(adjusted_lr: float, lr_warmup_init: float, warmup_steps: int,
              total_steps: int) -> Schedule:
    decay_steps = float(total_steps - warmup_steps)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return _warmup(step, lr_warmup_init, adjusted_lr, warmup_steps)
        return 0.5 * adjusted_lr * (1 + math.cos(math.pi * step / decay_steps))
    return schedule


def polynomial_lr(adjusted_lr: float, lr_warmup_init: float, warmup_steps: int,
                  power: float, total_steps: int) -> Schedule:
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return _warmup(step, lr_warmup_init, adjusted_lr, warmup_steps)
        return adjusted_lr * (1 - step / total_steps) ** power
    return schedule


def learning_rate_schedule(config, steps_per_epoch: int) -> Schedule:
    """The config's schedule; the rate scales with batch_size / 64."""
    batch_size = config.get("batch_size", 64) or 64
    scale = batch_size / 64.0
    adjusted_lr = config.learning_rate * scale
    lr_warmup_init = config.lr_warmup_init * scale
    warmup_steps = int(config.lr_warmup_epoch * steps_per_epoch)
    total_steps = int(config.num_epochs * steps_per_epoch)
    method = config.lr_decay_method
    if method == "stepwise":
        return stepwise_lr(adjusted_lr, lr_warmup_init, warmup_steps,
                           int(config.first_lr_drop_epoch * steps_per_epoch),
                           int(config.second_lr_drop_epoch * steps_per_epoch))
    if method == "cosine":
        return cosine_lr(adjusted_lr, lr_warmup_init, warmup_steps, total_steps)
    if method == "polynomial":
        return polynomial_lr(adjusted_lr, lr_warmup_init, warmup_steps, config.poly_lr_power,
                             total_steps)
    raise ValueError(f"unknown lr_decay_method: {method}")


def make_optimizer(config, params: Sequence[torch.Tensor], steps_per_epoch: int
                   ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """SGD with momentum or Adam over ``params``, and the schedule that sets
    its rate. The L2 term is in the loss, so neither decays weights."""
    schedule = learning_rate_schedule(config, steps_per_epoch)
    name = config.optimizer.lower()
    lr = schedule(0)
    if name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=config.momentum, dampening=0.0)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(config.momentum, 0.999), eps=1e-8)
    else:
        raise ValueError("optimizer should be adam or sgd")
    return opt, schedule


def clip_gradients(grads: List[torch.Tensor], clip_norm: float,
                   sharded: Optional[Sequence[bool]] = None, group=None) -> torch.Tensor:
    """Clip ``grads`` in place: each tensor to norm ``clip_norm``, then all
    of them together to global norm ``clip_norm``. Returns the global norm
    after both (a device scalar; nothing is read on the host). Under tensor
    parallelism the tensors flagged in ``sharded`` are this rank's slices:
    their norms are the whole tensors', summed over the model ``group``."""
    norms = torch.stack(torch._foreach_norm(grads))
    if group is not None and sharded is not None and any(sharded):
        mask = torch.tensor(list(sharded), device=norms.device)
        squares = all_reduce(torch.where(mask, norms * norms, torch.zeros_like(norms)), group)
        norms = torch.where(mask, torch.sqrt(squares), norms)
    per = torch.clamp_max(clip_norm / torch.clamp_min(norms, 1e-12), 1.0)
    gnorm = torch.linalg.vector_norm(norms * per)
    glob = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    torch._foreach_mul_(grads, list((per * glob).unbind()))
    return gnorm * glob
