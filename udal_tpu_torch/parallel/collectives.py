"""Collectives over ``torch.distributed`` process groups, with autograd where
training needs it.

Every collective of the port goes through the three wrappers here
(``all_reduce``, ``all_gather``, ``broadcast``). NCCL takes CUDA tensors,
gloo CPU tensors and, for these three, CUDA tensors too (measured on the
card by ``chip_smoke.py`` phase 13 (b): two processes sharing one card,
which NCCL refuses, run over gloo). A group of None is no group: each
wrapper returns its input (a single process without ``torch.distributed``).

The autograd functions carry gradients across the groups as the JAX
package's SPMD program does:

* ``all_reduce_sum``: forward the sum over the group, backward the sum of
  the gradients (``torch.distributed.nn.functional.all_reduce``).
  Global-batch BatchNorm reduces its moments with it.
* ``gather_replicated``: forward the concatenation of every rank's slice
  along ``dim``; backward the rank's own slice of the gradient. It is the
  gather into a computation every rank of the group repeats identically
  (Megatron's gather into a replicated region): each rank holds the whole
  gradient, so the slice is exact and summing would count it n times.
* ``copy_to_group``: forward the identity, backward the sum over the group.
  It marks where a replicated tensor enters a computation split over the
  group's channels: each rank's gradient is a part of the whole.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in the
    group's rank order."""
    if group is None:
        return t
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group`` (the world
    when None and the process group is initialised), in place."""
    if group is not None or dist.is_initialized():
        dist.broadcast(t, src=src, group=group)
    return t


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        start = group_rank(ctx.group) * ctx.n
        return grad.narrow(ctx.dim, start, ctx.n).contiguous(), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable (module docstring)."""
    return x if group is None else dist_nn.all_reduce(x, group=group)


def gather_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's slices of ``x`` joined along ``dim``, for a computation
    every rank repeats (module docstring)."""
    return x if group is None else _GatherReplicated.apply(x, group, dim)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose gradient is summed over ``group`` (module docstring)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def global_mean(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The mean of ``x`` over the rows of every rank of ``group`` (equal
    row counts), no gradient: the mean of a label-derived quantity."""
    if group is None:
        return torch.mean(x)
    s = all_reduce(torch.sum(x.detach()).reshape(1), group)
    return s[0] / (x.numel() * size(group))
