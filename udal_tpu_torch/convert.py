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
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

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


def torch_to_flax(model: nn.Module) -> Tuple[Dict, Dict]:
    """(params, batch_stats) as nested dicts of float32 numpy arrays: the
    inverse of ``flax_to_torch``."""
    params: Dict = {}
    batch_stats: Dict = {}

    def put(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = value

    for name, mod in model.named_modules():
        path = name.split(".") if name else []
        for leaf, t in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            v = t.detach().to(torch.float32).cpu().numpy()
            if isinstance(mod, BatchNorm):
                if leaf in ("weight", "bias"):
                    put(params, path + ["bn", "scale" if leaf == "weight" else "bias"], v)
                else:
                    put(batch_stats, path + ["bn", leaf.replace("running_", "")], v)
            elif leaf == "weight" and isinstance(mod, nn.ConvTranspose2d):
                put(params, path + ["kernel"], v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).copy())
            elif leaf == "weight":
                put(params, path + ["kernel"], v.transpose(2, 3, 1, 0))
            else:
                put(params, path + [leaf], v)
    return params, batch_stats


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
