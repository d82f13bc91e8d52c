"""Collectives over one process group, with the transpose rules of the
``jax.lax`` collectives that ``shard_map`` bodies use
(``c2dsr_tpu/parallel/embed.py``, ``sharded_loss.py``, ``sharded_eval.py``).

A :class:`Group` is a ``torch.distributed`` process group with this rank's
index in it; a group of one rank makes every function here the identity,
with no communication.  Each differentiable collective is an autograd
Function whose backward is written out:

* :func:`psum`: ``all_reduce`` forward; backward the identity.  That is
  ``shard_map``'s transpose where every rank consumes the replicated sum
  alike: the loss is then one replicated value, and each rank already
  holds its whole cotangent.  ``torch.distributed.nn.functional.all_reduce``
  all-reduces the gradient instead, which makes every sharded gradient M
  times too large; it is not used.
* :func:`pvary`: the identity forward; backward ``all_reduce``.  It marks a
  replicated value that each rank goes on to use in its own way (its vocab
  shard, its slot of a gathered buffer): the ranks' cotangents are then
  partial, and the transpose of that implicit broadcast sums them, as
  JAX's varying-axes transpose does.
* :func:`all_to_all`: chunk s of x [M, ...] goes to rank s; backward the
  reverse exchange.
* :func:`all_gather`: [M, *x.shape]; backward this rank's slice.
* :func:`pmax` and :func:`sum_`: no gradient (the max shift runs under
  ``stop_gradient`` in JAX; counts carry none).

Transport: NCCL where each rank has a card of its own, gloo otherwise
(``parallel/distributed.initialize``).  gloo in the PyTorch this runs on
(2.11) takes CUDA tensors for ``all_reduce``, ``all_gather``,
``all_gather_into_tensor`` and ``all_to_all_single`` (it refuses only the
list form of ``all_to_all``, which is not used), so every collective here
runs on the tensors where they lie, with no staging through host memory.
Collectives run on the current stream's order: gloo waits for the tensor's
producers and its result is ready when the call returns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """A process group and this rank's index in it (``size`` 1: no group)."""

    pg: Optional[object]
    size: int
    index: int


SELF = Group(None, 1, 0)


def _all_reduce(x: torch.Tensor, group: Group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group.pg)
    return out


def _all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty((group.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(out.unbind(0)), x, group=group.pg)
    return out


def _all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group.pg)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.group.index].contiguous(), None


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum over the group, consumed alike by every rank (backward: the
    identity)."""
    return x if group.size == 1 else _Psum.apply(x, group)


def pvary(x: torch.Tensor, group: Group) -> torch.Tensor:
    """x itself, used by each rank in its own way (backward: the sum of the
    ranks' cotangents)."""
    return x if group.size == 1 else _Pvary.apply(x, group)


def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """x [M, ...]: chunk s goes to rank s; the result's chunk s came from
    rank s."""
    if x.shape[0] != group.size:
        raise ValueError(f"all_to_all takes [{group.size}, ...], got "
                         f"{tuple(x.shape)}")
    return x if group.size == 1 else _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[M, *x.shape]: every rank's x, in rank order."""
    return x[None] if group.size == 1 else _AllGather.apply(x, group)


def pmax(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Elementwise max over the group, no gradient."""
    x = x.detach()
    return x if group.size == 1 else _all_reduce(x, group, dist.ReduceOp.MAX)


def sum_(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum over the group, no gradient (counts, reported losses, the
    gradients of replicated parameters)."""
    x = x.detach()
    return x if group.size == 1 else _all_reduce(x, group)


def gather_(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[M, *x.shape], no gradient."""
    x = x.detach()
    return x[None] if group.size == 1 else _all_gather(x, group)
