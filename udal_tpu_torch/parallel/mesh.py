"""Process mesh and sharding layout for data- and tensor-parallel training
and serving: port of ``udal_tpu/parallel/mesh.py`` over ``torch.distributed``.

The JAX package lays its devices out as a ``('data', 'model')`` mesh and
lets XLA insert the collectives. Here each process drives one device, the
processes (ranks) are laid out ``[n_data, n_model]`` row-major as JAX lays
out its devices, and the collectives are explicit calls on two families of
process groups (``parallel/collectives.py``):

* ``data`` groups: the ranks that share a model index (rank
  ``d·n_model + m`` for every d). Batches split over them; gradients, the
  detection loss's normaliser and BatchNorm's moments are summed over them.
* ``model`` groups: the ranks that share a data index. Tensor parallelism
  splits parameter channels over them (``shard_state_tp``).

Without an initialised process group the mesh is a world of one with no
groups, and every collective is a no-op; ``initialize_multihost`` sets the
group up from its arguments or torchrun's environment. A rank's device is
``cuda:<local rank>`` on a machine with cards (``device="cpu"`` asks for the
CPU and the gloo backend).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
from datetime import timedelta
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from udal_tpu_torch.parallel.collectives import all_gather, all_reduce, broadcast


@dataclasses.dataclass
class Mesh:
    """This rank's place in an ``[n_data, n_model]`` layout of the ranks, its
    device and the process groups of its two axes (None in a world of one
    without ``torch.distributed``)."""
    shape: Dict[str, int]
    rank: int
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    _bn_groups: Dict[int, object] = dataclasses.field(default_factory=dict)

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def data_rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` rows, as
        ``P('data')`` lays them out."""
        n = self.shape["data"]
        if batch % n:
            raise ValueError(f"a batch of {batch} rows does not split over the mesh's "
                             f"'data' axis ({n})")
        per = batch // n
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def batch_norm_group(self, group_size: int):
        """The process group of this rank's BatchNorm replicas when the
        moments are reduced over groups of at most ``group_size`` data
        ranks (``cross_replica_mean_groups``); every rank calls it at the
        same point, since it creates the groups on first use."""
        if self.data_group is None:
            return None
        if group_size not in self._bn_groups:
            n_data, n_model = self.shape["data"], self.shape["model"]
            mine = None
            for m in range(n_model):
                for g in cross_replica_mean_groups(n_data, group_size):
                    ranks = [d * n_model + m for d in g]
                    pg = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = pg
            self._bn_groups[group_size] = mine
        return self._bn_groups[group_size]


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This process's device: the CPU when asked for, else the card of its
    local rank (``LOCAL_RANK``, as torchrun sets it; else ``rank`` or the
    process group's rank), modulo the cards; raises when a card is asked
    for and there is none."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh runs on CUDA devices unless device='cpu' is given, and "
                           "torch.cuda.is_available() is False")
    if device.index is not None:
        return device
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) %
                        torch.cuda.device_count())


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """The ``('data', 'model')`` mesh over every rank of the process group
    (``n_data`` defaults to the world size over ``n_model``; the two must
    cover the world). Every rank calls it: it creates the groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a mesh of {n_data} x {n_model} ranks needs a world of that size; "
                         f"the process group has {world}")
    device = rank_device(device)
    if not dist.is_initialized():
        return Mesh({"data": 1, "model": 1}, 0, device)
    rank = dist.get_rank()
    groups = {}
    for axis, ranks_of in (("data", lambda m: [d * n_model + m for d in range(n_data)]),
                           ("model", lambda d: [d * n_model + m for m in range(n_model)])):
        for i in range(n_model if axis == "data" else n_data):
            ranks = ranks_of(i)
            pg = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = pg
    return Mesh({"data": n_data, "model": n_model}, rank, device, groups["data"],
                groups["model"])


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None,
                         backend: Optional[str] = None,
                         timeout_s: float = 300.0) -> dict:
    """Join the process group: from the arguments (``coordinator_address``
    "host:port", the world size and this process's rank), or else from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``). Without either it is a world of one and no group is
    made, as the JAX package's fallback is. NCCL on the card, gloo with
    ``device="cpu"`` (``backend`` overrides). Safe to call when the group
    exists; an explicit multi-process call that fails raises.

    Returns {process_index, process_count, local_devices, global_devices}.
    """
    env = all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"))
    explicit = coordinator_address is not None or (num_processes or 1) > 1
    if not dist.is_initialized() and (explicit or env):
        dev = rank_device(device, int(process_id or 0) if explicit else None)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        kwargs = dict(backend=backend, timeout=timedelta(seconds=timeout_s))
        if backend == "nccl":
            torch.cuda.set_device(dev)
            if "device_id" in inspect.signature(dist.init_process_group).parameters:
                kwargs["device_id"] = dev
        if explicit:
            dist.init_process_group(init_method=f"tcp://{coordinator_address}",
                                    world_size=int(num_processes or 1),
                                    rank=int(process_id or 0), **kwargs)
        else:
            dist.init_process_group(init_method="env://", **kwargs)
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": world, "local_devices": local, "global_devices": world}


def make_multihost_mesh(n_model: int = 1, device=None) -> Mesh:
    """The mesh over every process of the group; the data axis spans them
    all (the readers shard by data rank, ``data.dataloader.default_shard``)."""
    return make_mesh(n_model=n_model, device=device)


def shard_batch(mesh: Mesh, batch: Mapping) -> Dict[str, torch.Tensor]:
    """This rank's rows of a host batch (a dict of arrays with the global
    batch leading), on its device: rank d of the data axis holds rows
    [d·B/n, (d+1)·B/n)."""
    out = {}
    for k, v in batch.items():
        rows = mesh.data_rows(len(v))
        out[k] = torch.as_tensor(np.asarray(v)[rows] if not torch.is_tensor(v) else v[rows],
                                 device=mesh.device)
    return out


def replicate_state(mesh: Mesh, state):
    """Broadcast a ``TrainState``'s tensors (model parameters and buffers,
    optimizer state, EMA) from rank 0 to every rank, in place; sets the
    state's mesh and its BatchNorms' data group. Returns the state."""
    model = state.model
    tensors = list(model.parameters()) + list(model.buffers())
    for group_state in state.optimizer.state.values():
        tensors += [v for v in group_state.values() if torch.is_tensor(v)]
    if state.ema_params is not None:
        tensors += list(state.ema_params.values())
    with torch.no_grad():
        for t in tensors:
            broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, 0)
    state.mesh = mesh
    set_batch_norm_group(model, mesh.data_group)
    return state


def set_batch_norm_group(model: torch.nn.Module, group) -> None:
    """Every BatchNorm of ``model`` reduces its train-mode moments over
    ``group`` (None: this rank's batch alone)."""
    from udal_tpu_torch.models.efficientnet import BatchNorm

    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.group = group


def cross_replica_mean_groups(n_devices: int, group_size: int = 32) -> List[List[int]]:
    """Index groups of at most ``group_size`` replicas for grouped BatchNorm
    moments (the reference's grouped TPU BatchNorm)."""
    num_groups = max(1, n_devices // min(group_size, n_devices))
    per = n_devices // num_groups
    return [list(range(g * per, (g + 1) * per)) for g in range(num_groups)]


def grouped_batch_stats(x: torch.Tensor, mesh: Mesh, group_size: int = 32):
    """Per-group batch moments over the data axis: ``x`` is this rank's
    rows [B/n, ..., C]; the mean and variance of the rows of the rank's
    group (``cross_replica_mean_groups``) are reduced over its process
    group, then gathered over the data axis. Returns (mean, var), each
    [n_data, C]: row d holds the moments of data rank d's group, as the JAX
    package returns them."""
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    group = mesh.batch_norm_group(group_size)
    n_group = dist.get_world_size(group) if group is not None else 1
    sums = all_reduce(torch.stack([xf.mean(0), (xf * xf).mean(0)]), group) / n_group
    mean, var = sums[0], sums[1] - sums[0] * sums[0]
    return all_gather(mean[None], mesh.data_group), all_gather(var[None], mesh.data_group)


# ---------------------------------------------------------------------------
# Tensor parallelism (the 'model' axis)
# ---------------------------------------------------------------------------

def param_partition_spec(name: str, x: torch.Tensor, n_model: int) -> Optional[int]:
    """The dim of a state-dict leaf that the 'model' axis splits, or None
    (replicated).

    The JAX package splits a flax leaf's last axis where it divides by
    ``n_model``: output channels of conv kernels, a depthwise kernel's
    channels, BatchNorm vectors, biases and edge weights. The same axis of
    the port's tensor is where ``convert.py`` puts it
    (``convert.flax_last_axis``): dim 0 of a conv, depthwise or BatchNorm
    tensor, dim 1 of the segmentation head's transposed convs."""
    from udal_tpu_torch.convert import flax_last_axis

    if n_model <= 1 or x.dim() == 0:
        return None
    dim = flax_last_axis(name, x.dim())
    return dim if x.shape[dim] % n_model == 0 else None


def shard_params_tp(mesh: Mesh, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's slice of each tensor of a name → tensor map (state dict,
    EMA) that ``param_partition_spec`` splits; the others as they are."""
    n, i = mesh.shape["model"], mesh.model_index
    out = {}
    for name, t in tensors.items():
        dim = param_partition_spec(name, t, n)
        out[name] = t if dim is None else \
            t.narrow(dim, i * (t.shape[dim] // n), t.shape[dim] // n).clone()
    return out


def shard_opt_state_tp(mesh: Mesh, optimizer: torch.optim.Optimizer,
                       names: Mapping[torch.nn.Parameter, str]) -> None:
    """Slice an optimizer's per-parameter buffers (SGD's momentum, Adam's
    moments) as their parameters are sliced, in place; step counts and
    other scalars stay. Keeps restored moments across the reshard instead
    of starting them afresh. ``names`` maps each parameter to its name;
    call it before the parameters themselves are sliced."""
    for p, st in optimizer.state.items():
        for key, v in list(st.items()):
            if torch.is_tensor(v) and v.shape == p.shape:
                st[key] = shard_params_tp(mesh, {names[p]: v})[names[p]]


def shard_state_tp(mesh: Mesh, state):
    """Shard a ``TrainState`` over the 'model' axis in place and return it:
    every leaf ``param_partition_spec`` splits keeps only this rank's slice
    (parameters, BatchNorm statistics, optimizer buffers, EMA), the rest is
    replicated. The state's ``tp`` (``parallel.tensor_parallel``) then runs
    the training forward: channel-parallel MBConv blocks, gathered weights
    elsewhere. Broadcasts from rank 0 first (``replicate_state``)."""
    from udal_tpu_torch.parallel.tensor_parallel import TensorParallel

    replicate_state(mesh, state)
    model = state.model
    tp = TensorParallel(mesh, model)        # the layout, from the whole tensors
    names = {p: n for n, p in model.named_parameters()}
    shard_opt_state_tp(mesh, state.optimizer, names)
    full = dict(model.named_parameters())
    full.update(model.named_buffers())
    sliced = shard_params_tp(mesh, full)
    with torch.no_grad():
        for name, t in full.items():
            if sliced[name] is not t:
                t.data = sliced[name]
    if state.ema_params is not None:
        state.ema_params = shard_params_tp(mesh, state.ema_params)
    state.tp = tp
    return state
