"""Tensor parallelism over the mesh's 'model' axis: the training forward on
channel-sharded state.

``parallel.mesh.shard_state_tp`` leaves each rank of a model group with its
slice of every leaf ``param_partition_spec`` splits. ``TensorParallel``
then runs the model on it as the JAX package's docstring describes its
GSPMD program:

* the MBConv blocks compute channel-parallel: expand, bn0, swish, dropout,
  depthwise, bn1, swish, dropout and the SE squeeze run on the rank's
  channels (``MBConvBlock.forward_unfused`` with ``block.tp`` set); an
  all-gather joins the channels before the SE reduce and the project conv;
* every other sharded leaf (the stem, the blocks' SE, project and bn2, the
  BiFPN, the heads) is all-gathered before the forward and used whole, the
  gather's backward handing each rank its slice of the gradient
  (``collectives.gather_replicated``); the BatchNorm statistics among them
  are updated whole and sliced back after it.

``gathered`` unshards the whole state in place for what needs it whole
(evaluation, the COCO callback, checkpoints, early stopping) and reshards
it after.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Tuple

import torch
from torch.func import functional_call

from udal_tpu_torch.parallel.collectives import all_gather, all_reduce, gather_replicated


class TensorParallel:
    """The 'model'-axis layout of one model: which tensors are sliced on
    which dim, and which of them the channel-parallel blocks use sliced.
    Built from the model's full tensors, before they are sliced."""

    def __init__(self, mesh, model: torch.nn.Module):
        from udal_tpu_torch.models.efficientnet import MBConvBlock
        from udal_tpu_torch.parallel.mesh import param_partition_spec

        self.mesh = mesh
        self.group, self.index, self.count = (mesh.model_group, mesh.model_index,
                                              mesh.shape["model"])
        tensors = dict(model.named_parameters())
        tensors.update(model.named_buffers())
        self.dims: Dict[str, int] = {}
        for name, t in tensors.items():
            dim = param_partition_spec(name, t, self.count)
            if dim is not None:
                self.dims[name] = dim
        self.local = set()
        for prefix, mod in model.named_modules():
            if not isinstance(mod, MBConvBlock):
                continue
            parts = ["depthwise_conv", "bn1"] + (["expand_conv", "bn0"]
                                                 if mod.expand_conv is not None else [])
            names = [f"{prefix}.{p}.{leaf}" for p in parts for leaf in
                     (("weight", "bias", "running_mean", "running_var") if p.startswith("bn")
                      else ("weight",))]
            if all(n in self.dims for n in names):
                self.local.update(names)
                mod.tp = (self.group, self.index, self.count)

    def is_sharded(self, name: str) -> bool:
        return name in self.dims

    def forward(self, model: torch.nn.Module, *args, **kwargs):
        """``model(*args, **kwargs)`` on the sharded state: the leaves the
        channel-parallel blocks use sliced stay as they are, the others are
        gathered for the call; BatchNorm statistics updated whole are
        sliced back into the rank's buffers."""
        whole = {}
        for name, p in model.named_parameters():
            if name in self.dims and name not in self.local:
                whole[name] = gather_replicated(p, self.group, self.dims[name])
        buffers = {}
        for name, b in model.named_buffers():
            if name in self.dims and name not in self.local:
                buffers[name] = all_gather(b, self.group, self.dims[name])
        out = functional_call(model, {**whole, **buffers}, args, kwargs, strict=False)
        with torch.no_grad():
            own = dict(model.named_buffers())
            for name, b in buffers.items():
                own[name].copy_(self._slice(b, self.dims[name]))
        return out

    def _slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        n = t.shape[dim] // self.count
        return t.narrow(dim, self.index * n, n)

    def _state_tensors(self, state) -> Iterator[Tuple[str, torch.Tensor]]:
        """(name, tensor) of every sliced tensor of ``state``, in one order
        on every rank: parameters, their optimizer buffers, buffers, EMA."""
        for name, p in state.model.named_parameters():
            if name in self.dims:
                yield name, p
                for v in state.optimizer.state.get(p, {}).values():
                    if torch.is_tensor(v) and v.shape == p.shape:
                        yield name, v
        for name, b in state.model.named_buffers():
            if name in self.dims:
                yield name, b
        if state.ema_params is not None:
            for name, e in state.ema_params.items():
                if name in self.dims:
                    yield name, e

    @contextlib.contextmanager
    def gathered(self, state):
        """Every sliced tensor of ``state`` whole, in place, while open;
        sliced again after, including tensors loaded meanwhile (an early
        stop's restore). Every rank of the model group enters it."""
        with torch.no_grad():
            for name, t in list(self._state_tensors(state)):
                t.data = all_gather(t.data, self.group, self.dims[name])
        state.model.drop_folds()
        try:
            yield state
        finally:
            with torch.no_grad():
                for name, t in list(self._state_tensors(state)):
                    t.data = self._slice(t.data, self.dims[name]).clone()
            state.model.drop_folds()

    def square_sums(self, named: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Σ‖t‖² of the whole tensors of a name → slice map: the sliced
        ones' sums over the model group plus the replicated ones'."""
        dev = next(iter(named.values())).device
        sums = torch.zeros(2, dtype=torch.float32, device=dev)
        for name, t in named.items():
            sums[0 if name in self.dims else 1] += torch.sum(t.detach().float() ** 2)
        all_reduce(sums[:1], self.group)
        return sums.sum()
