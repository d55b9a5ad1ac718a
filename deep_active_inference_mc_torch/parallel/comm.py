"""The port's collectives, written over ``all_reduce`` and ``broadcast`` only.

Those two are what every backend carries for CUDA tensors: NCCL, and gloo,
which is how several ranks share one card (NCCL refuses two ranks on one
device). A gather is therefore an all-reduce of zero-padded buffers, each
rank writing its own slice. ``group=None`` is the world; every function is
a no-op on a group of one.

Megatron's two tensor-parallel maps are ``torch.autograd.Function``s:

  - ``copy_to_model`` (*f*): identity forward, all-reduce of the gradient
    backward; it feeds a column-parallel layer, whose ranks each see the
    whole input;
  - ``reduce_from_model`` (*g*): all-reduce forward, identity backward; it
    sums a row-parallel layer's partial products.

Both reduce in float32, whatever the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def group_size(group: Group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group: Group) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def all_reduce_(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """In-place sum over ``group``; returns ``x``."""
    if group_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def _summed(x: torch.Tensor, group: Group) -> torch.Tensor:
    return all_reduce_(x.float().clone(), group).to(x.dtype)


def gather_rows(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Concatenate equal-sized leading-axis shards of every rank of
    ``group``, in rank order (an all-gather as a zero-padded all-reduce)."""
    n = group_size(group)
    if n == 1:
        return x
    dtype = x.dtype
    # Integers (env latents) travel as float64: exact below 2**53, and a
    # sum every backend carries.
    work = x.to(torch.float64 if not dtype.is_floating_point else torch.float32)
    full = work.new_zeros((n * x.shape[0],) + tuple(x.shape[1:]))
    r = group_rank(group)
    full[r * x.shape[0]:(r + 1) * x.shape[0]] = work
    return all_reduce_(full, group).to(dtype)


def gather_dim(x: torch.Tensor, dim: int, group: Group = None) -> torch.Tensor:
    """``gather_rows`` along ``dim``."""
    if group_size(group) == 1:
        return x
    return gather_rows(x.movedim(dim, 0).contiguous(), group).movedim(0, dim).contiguous()


def broadcast_(x: torch.Tensor, group: Group = None, src: int = 0) -> torch.Tensor:
    """In-place broadcast from global rank ``src``; returns ``x``."""
    if group_size(group) > 1:
        dist.broadcast(x, src, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's *f*: the input of a column-parallel layer."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's *g*: the output of a row-parallel layer."""
    return _ReduceFromModel.apply(x, group)
