"""Checkpoints of a ``TrainState``: save, restore, keep-N and the EMA swap.

Port of ``udal_tpu/utils/checkpoint.py`` with ``torch.save`` in place of
orbax: epoch ``e`` goes to ``<model_dir>/ckpt_<e>/state.pt`` (the step
count, the model's state dict, the optimizer's and the parameters' EMA or
None), the oldest beyond ``keep_last_n`` are deleted, and a restore loads
the latest unless told which. ``model_dir == "_"`` means "load nothing".
The EMA is taken as the checkpoint holds it: a checkpoint saved without
EMA restores into a state built with it as None, and one saved with EMA
into a state built without it brings its EMA along (the JAX package
reaches the same by a retry with the target's EMA flipped).
"""

from __future__ import annotations

import copy
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch


def state_payload(state) -> Dict[str, Any]:
    """A detached copy of everything a ``TrainState`` carries."""
    return {"step": int(state.step),
            "model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "optimizer": copy.deepcopy(state.optimizer.state_dict()),
            "ema_params": (None if state.ema_params is None else
                           {k: v.detach().clone() for k, v in state.ema_params.items()})}


def load_payload(state, payload: Dict[str, Any]):
    """Load ``payload`` (from ``state_payload`` or a checkpoint) into
    ``state`` in place, each tensor onto the model's device; returns it."""
    device = next(state.model.parameters()).device
    state.step = int(payload["step"])
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    ema = payload["ema_params"]
    state.ema_params = None if ema is None else {k: v.to(device).clone()
                                                 for k, v in ema.items()}
    state.model.drop_folds()
    return state


def _epochs(model_dir: str):
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(m.group(1)) for m in (re.fullmatch(r"ckpt_(\d+)", n)
                                            for n in os.listdir(model_dir)) if m)


def save_checkpoint(model_dir: str, state, epoch: int,
                    keep_last_n: Optional[int] = None) -> None:
    """Save ``state`` as epoch ``epoch`` (written whole, then renamed into
    place); keep the newest ``keep_last_n`` checkpoints."""
    final = os.path.join(model_dir, f"ckpt_{epoch}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state_payload(state), os.path.join(tmp, "state.pt"))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    if keep_last_n:
        for old in _epochs(model_dir)[:-keep_last_n]:
            shutil.rmtree(os.path.join(model_dir, f"ckpt_{old}"))


def latest_checkpoint(model_dir: str) -> Optional[int]:
    epochs = _epochs(model_dir)
    return epochs[-1] if epochs else None


def load_checkpoint(model_dir: str, epoch: int) -> Dict[str, Any]:
    """A checkpoint's payload, its tensors on the host."""
    return torch.load(os.path.join(model_dir, f"ckpt_{epoch}", "state.pt"),
                      map_location="cpu", weights_only=True)


def restore_checkpoint(model_dir: str, state, epoch: Optional[int] = None) -> Tuple[Any, int]:
    """Restore ``state`` in place from epoch ``epoch`` (the latest when
    None); returns (state, the epoch restored, 0 when nothing was)."""
    if model_dir == "_":
        return state, 0
    if epoch is None:
        epoch = latest_checkpoint(model_dir)
        if epoch is None:
            return state, 0
    return load_payload(state, load_checkpoint(model_dir, epoch)), epoch


def swap_in_ema(payload: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The model state dict of a payload with the EMA weights as the live
    parameters where the payload has them (the running statistics stay)."""
    model = dict(payload["model"])
    if payload["ema_params"] is not None:
        model.update(payload["ema_params"])
    return model
