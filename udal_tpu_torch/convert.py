"""Carry flax weights across to the PyTorch port.

``flax_to_torch(params, batch_stats)`` turns the JAX package's variable
trees (nested dicts of numpy arrays; no JAX needed) into a state dict for
``EfficientDetNet``. The port's modules carry the flax scope names, so the
mapping is a rename plus a layout change:

* ``<path>/kernel`` HWIO → ``<path>.weight`` OIHW (a depthwise
  ``[k, k, 1, C]`` kernel becomes ``[C, 1, k, k]``); ``<path>/bias`` →
  ``<path>.bias`` (SE 1x1 convs, resampling and pointwise convs);
* BatchNorm ``<path>/bn/{scale, bias}`` with batch_stats ``<path>/bn/{mean,
  var}`` → ``<path>.{weight, bias, running_mean, running_var}`` (the flax
  module wraps an ``nn.BatchNorm`` named ``bn``);
* fuse ``edge_weights`` carry over as they are;
* the segmentation head's transposed-conv kernels (``seg_head/<name>/kernel``,
  flax [k, k, in, out], not flipped: ``transpose_kernel=False``) become
  ``ConvTransposeSame`` weights [in, out, k, k], flipped in both spatial
  axes (``models/heads.py`` says why).

Flax scope names with hyphens (``class-0-bn-3``, ``box-predict``) are
``nn.ModuleDict`` keys on the torch side, so they rename like any other.
``torch_to_flax`` is the inverse. ``load_flax`` loads a converted tree and
raises on a leftover on either side. ``flax_to_torch_stacked`` converts a
deep ensemble's tree, whose leaves carry a leading member axis, into the
stacked state dict ``ServingDriver(ensemble=True)`` takes.

A training state goes both ways: ``train_state_from_flax`` loads a flax
``TrainState``'s leaves (params, batch_stats, optax's SGD trace or Adam
moments, the EMA and the step; numpy, or any array ``np.asarray`` takes)
into the port's ``TrainState``, and ``train_state_to_flax`` gives them
back as nested dicts. Optimizer buffers and the EMA are laid out as the
parameters they follow (``params_to_flax``).

``calibrators_from_jax`` turns the JAX package's pickled calibrators
(sklearn isotonic fits, temperatures) into the port's ``.npz`` files. It
unpickles sklearn objects, so it runs where sklearn is installed; the
port then loads the result on a machine without it.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from udal_tpu_torch.models.efficientnet import BatchNorm

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def flax_to_torch(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``EfficientDetNet`` from flax ``params`` and
    ``batch_stats``. Raises on a leaf it cannot place."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params).items():
        *mod, leaf = path
        if mod and mod[-1] == "bn" and leaf in _BN_PARAMS:
            key = ".".join(mod[:-1] + [_BN_PARAMS[leaf]])
        elif leaf == "kernel" and v.ndim == 4 and mod[0] == "seg_head":
            key, v = ".".join(mod + ["weight"]), v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        elif leaf == "kernel" and v.ndim == 4:
            key, v = ".".join(mod + ["weight"]), v.transpose(3, 2, 0, 1)
        elif leaf in ("bias", "edge_weights"):
            key = ".".join(mod + [leaf])
        else:
            raise KeyError(f"no torch counterpart for flax param {'/'.join(path)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    for path, v in _flatten(batch_stats).items():
        *mod, leaf = path
        if not (mod and mod[-1] == "bn" and leaf in _BN_STATS):
            raise KeyError(f"no torch counterpart for flax batch_stats {'/'.join(path)}")
        out[".".join(mod[:-1] + [_BN_STATS[leaf]])] = torch.from_numpy(
            np.asarray(v, dtype=np.float32).copy())
    return out


def flax_to_torch_stacked(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Stacked state dict [N, ...] a key from an N-member flax tree whose
    leaves carry a leading member axis (``udal_tpu.models.ensemble.
    stack_variables``): each member converted, then stacked."""
    flat = {**_flatten(params), **_flatten(batch_stats)}
    n = len(next(iter(flat.values())))

    def member(tree, i):
        return {k: member(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
                for k, v in tree.items()}

    members = [flax_to_torch(member(params, i), member(batch_stats, i)) for i in range(n)]
    return {k: torch.stack([m[k] for m in members]) for k in members[0]}


def _put(tree: Dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _flax_leaf(mod: nn.Module, path, leaf: str, t: torch.Tensor):
    """(is a batch statistic, flax path, value in flax's layout) of the
    tensor ``t`` that sits as ``leaf`` of ``mod`` (or follows it)."""
    v = t.detach().to(torch.float32).cpu().numpy()
    if isinstance(mod, BatchNorm):
        if leaf in ("weight", "bias"):
            return False, path + ["bn", "scale" if leaf == "weight" else "bias"], v
        return True, path + ["bn", leaf.replace("running_", "")], v
    if leaf == "weight" and isinstance(mod, nn.ConvTranspose2d):
        return False, path + ["kernel"], v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).copy()
    if leaf == "weight":
        return False, path + ["kernel"], v.transpose(2, 3, 1, 0)
    return False, path + [leaf], v


def torch_to_flax(model: nn.Module) -> Tuple[Dict, Dict]:
    """(params, batch_stats) as nested dicts of float32 numpy arrays: the
    inverse of ``flax_to_torch``."""
    trees: Tuple[Dict, Dict] = ({}, {})
    for name, mod in model.named_modules():
        path = name.split(".") if name else []
        for leaf, t in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            stat, fpath, v = _flax_leaf(mod, path, leaf, t)
            _put(trees[stat], fpath, v)
    return trees


def params_to_flax(model: nn.Module, named: Mapping[str, torch.Tensor]) -> Dict:
    """A flax params tree of tensors keyed by ``model``'s parameter names,
    each laid out as the parameter it follows: a gradient, an optimizer
    buffer, an EMA."""
    tree: Dict = {}
    for name, mod in model.named_modules():
        path = name.split(".") if name else []
        for leaf, _ in mod.named_parameters(recurse=False):
            _, fpath, v = _flax_leaf(mod, path, leaf, named[".".join(path + [leaf])])
            _put(tree, fpath, v)
    return tree


def _optax_part(opt_state, *fields: str):
    """The element of an optax chain's state that has ``fields``."""
    parts = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    for part in parts:
        if isinstance(part, Mapping) and all(f in part for f in fields):
            return part
        if all(hasattr(part, f) for f in fields):
            return {f: getattr(part, f) for f in fields}
    raise KeyError(f"no optax state with {fields} in {type(opt_state).__name__}")


def train_state_from_flax(state, step, params: Mapping, batch_stats: Mapping, opt_state,
                          ema_params: Optional[Mapping] = None):
    """Load a flax ``TrainState``'s leaves into the port's ``state`` (built
    for the same config and optimizer), in place, and return it.

    ``opt_state`` is optax's state as restored (its chain's tuple of named
    tuples) or as ``train_state_to_flax`` gives it: SGD's ``trace`` becomes
    each parameter's ``momentum_buffer`` (optax starts it at 0, torch at the
    first gradient: the same update); Adam's ``count``, ``mu`` and ``nu``
    become ``step``, ``exp_avg`` and ``exp_avg_sq``."""
    model, optimizer = state.model, state.optimizer
    device = next(model.parameters()).device
    load_flax(model, params, batch_stats)
    model.to(device)
    by_name = dict(model.named_parameters())

    def follow(tree):     # a params-shaped tree → {parameter name: a tensor of its own}
        # (flax_to_torch may share the arrays' memory: JAX's, read-only)
        return {k: v.to(device, copy=True) for k, v in flax_to_torch(tree, {}).items()}

    optimizer.state.clear()
    if isinstance(optimizer, torch.optim.SGD):
        for name, buf in follow(_optax_part(opt_state, "trace")["trace"]).items():
            optimizer.state[by_name[name]] = {"momentum_buffer": buf}
    elif isinstance(optimizer, torch.optim.Adam):
        adam = _optax_part(opt_state, "count", "mu", "nu")
        count = torch.tensor(float(np.asarray(adam["count"])))
        nu = follow(adam["nu"])
        for name, mu in follow(adam["mu"]).items():
            optimizer.state[by_name[name]] = {"step": count.clone(), "exp_avg": mu,
                                              "exp_avg_sq": nu[name]}
    else:
        raise TypeError(f"no optax counterpart for {type(optimizer).__name__}")
    state.ema_params = None if ema_params is None else follow(ema_params)
    state.step = int(np.asarray(step))
    model.drop_folds()
    return state


def train_state_to_flax(state) -> Dict:
    """The port's ``TrainState`` as flax trees of float32 numpy arrays:
    {"step", "params", "batch_stats", "opt_state", "ema_params"}, with
    ``opt_state`` {"trace"} for SGD (zeros before the first step) or
    {"count", "mu", "nu"} for Adam."""
    model, optimizer = state.model, state.optimizer
    params, batch_stats = torch_to_flax(model)
    named = dict(model.named_parameters())

    def buffers(key):
        return params_to_flax(model, {n: optimizer.state.get(p, {}).get(key, torch.zeros_like(p))
                                      for n, p in named.items()})

    if isinstance(optimizer, torch.optim.SGD):
        opt_state = {"trace": buffers("momentum_buffer")}
    else:
        first = optimizer.state.get(next(iter(named.values())), {})
        opt_state = {"count": np.asarray(int(first.get("step", 0)), np.int32),
                     "mu": buffers("exp_avg"), "nu": buffers("exp_avg_sq")}
    return {"step": state.step, "params": params, "batch_stats": batch_stats,
            "opt_state": opt_state,
            "ema_params": None if state.ema_params is None
            else params_to_flax(model, state.ema_params)}


def load_flax(model: nn.Module, params: Mapping, batch_stats: Mapping) -> nn.Module:
    """Load flax variables into ``model``: every flax leaf must land on a
    torch parameter or buffer and every one of those must be filled."""
    state = flax_to_torch(params, batch_stats)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise KeyError(f"flax tree does not fit the model: missing {missing[:8]} "
                       f"({len(missing)}), unplaced {extra[:8]} ({len(extra)})")
    for k, v in state.items():
        if tuple(v.shape) != tuple(expected[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != torch "
                             f"{tuple(expected[k].shape)}")
    model.load_state_dict(state, strict=True)
    return model


def _calibrator_from_jax(obj) -> Any:
    """The port's form of one unpickled calibrator: a fitted sklearn
    ``IsotonicRegression`` (its thresholds, input range and y bounds), a
    list of them, or a temperature (float, array, list of floats) as it is."""
    from udal_tpu_torch.apps.calibration import IsotonicRegression

    if isinstance(obj, (list, tuple)):
        return [_calibrator_from_jax(o) for o in obj]
    if hasattr(obj, "X_thresholds_"):
        if getattr(obj, "out_of_bounds", "clip") != "clip" or not getattr(obj, "increasing_",
                                                                          True):
            raise ValueError("the port's isotonic fit predicts increasing with clipping")
        iso = IsotonicRegression(obj.y_min, obj.y_max)
        iso.X_thresholds_ = np.asarray(obj.X_thresholds_)
        iso.y_thresholds_ = np.asarray(obj.y_thresholds_)
        iso.X_min_, iso.X_max_ = obj.X_min_, obj.X_max_
        return iso
    return obj


def calibrators_from_jax(src_dir: str, dst_dir: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read the calibrators ``udal_tpu.apps.calibration.save_calibrators``
    pickled under ``src_dir/{regression,classification}/<sub>_<name>``,
    write them in the port's format under ``dst_dir`` and return them as
    (regression, classification). Unpickle only files the JAX package
    wrote: unpickling runs code."""
    from udal_tpu_torch.apps.calibration import save_calibrators

    out = ({}, {})
    for i, sub in enumerate(("regression", "classification")):
        d = os.path.join(src_dir, sub)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as f:
                out[i][name.replace(f"{sub}_", "", 1)] = _calibrator_from_jax(pickle.load(f))
    save_calibrators(dst_dir, *out)
    return out


def flax_last_axis(name: str, ndim: int) -> int:
    """The dim of the port's tensor ``name`` (of ``ndim`` dims) that holds
    its flax leaf's last axis, as ``flax_to_torch`` lays it out: 1 for the
    segmentation head's transposed-conv kernels ([in, out, k, k]), 0 for
    every other kernel (OIHW), bias, edge weight and BatchNorm vector."""
    if ndim == 4 and name.startswith("seg_head.") and name.endswith(".weight"):
        return 1
    return 0
