"""Autograd-aware collectives (no counterpart in the JAX package, where
GSPMD inserts these operations into the traced program itself).

Each is a ``torch.autograd.Function`` whose backward is again one of these
Functions, so a ``create_graph`` double backward (the WGAN-GP penalty
differentiates the critic's BatchNorm twice) runs through them.  Every
rank of ``group`` must call a collective in the same order, forward and
backward; ``group=None`` is the default process group.  Complex tensors
travel as their real views.

Two kinds of region use them:

* **data-parallel** (each rank holds its own rows of the batch; the loss
  is the mean over ranks): :func:`all_reduce` sums in the forward and in
  the backward, the cross-rank BatchNorm statistics' rule;
* **replicated** (every rank holds the same tensor and computes the same
  loss from it, and a part of the work is split between ranks):
  :func:`scatter` takes this rank's chunk and all-gathers the gradient,
  :func:`gather` all-gathers the chunks and hands back this rank's chunk
  of the gradient, :func:`copy_to_ranks` is the identity with a summed
  gradient (every rank uses the whole tensor for its own share of the
  work) and :func:`reduce_from_ranks` sums with the identity for backward.
  ``torch.distributed.nn``'s all-gather sums its gradient over ranks,
  which in a replicated region is the world size times too much.

:func:`data_parallel` names the group whose ranks split the batch; the
port's BatchNorms and the losses that reduce across samples read it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.distributed as dist

_DATA_GROUP: list = []  # the stack of active data-parallel groups


@contextlib.contextmanager
def data_parallel(group=None) -> Iterator[None]:
    """Inside the block the batch is split over the ranks of ``group``
    (``None``: the default group): every :class:`~..nn.blocks.BatchNorm`
    in train mode takes its statistics over the global batch, and
    :func:`data_mean` / :func:`data_max` reduce over the ranks."""
    _DATA_GROUP.append(group if group is not None else dist.group.WORLD)
    try:
        yield
    finally:
        _DATA_GROUP.pop()


def data_group():
    """The active data-parallel group, or None outside :func:`data_parallel`."""
    return _DATA_GROUP[-1] if _DATA_GROUP else None


def world(group=None) -> tuple:
    """(size, rank) of ``group``."""
    return dist.get_world_size(group), dist.get_rank(group)


def _real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(y.contiguous()) if x.is_complex() else y


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = _real(x.detach()).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return _like(y, x)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in rank order."""
    p, _ = world(group)
    xs = _real(x.detach()).movedim(dim, 0).contiguous()
    out = xs.new_empty((p * xs.shape[0],) + tuple(xs.shape[1:]))
    # torch >= 2.13 names it all_gather_single; older ones all_gather_into_tensor
    gather_fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather_fn(out, xs, group=group)
    return _like(out.movedim(0, dim), x)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    p, r = world(group)
    if x.shape[dim] % p:
        raise ValueError(f"axis {dim} of size {x.shape[dim]} does not split into {p} ranks")
    n = x.shape[dim] // p
    return x.narrow(dim, r * n, n).contiguous()


def _all_to_all(x: torch.Tensor, split: int, concat: int, group) -> torch.Tensor:
    """Tiled all-to-all: chunk j of axis ``split`` goes to rank j, and the
    chunks received concatenate along axis ``concat`` in rank order."""
    p, _ = world(group)
    if x.shape[split] % p:
        raise ValueError(f"axis {split} of size {x.shape[split]} does not split into {p} ranks")
    xr = _real(x.detach())
    shp = list(xr.shape)
    y = xr.reshape(shp[:split] + [p, shp[split] // p] + shp[split + 1:]).movedim(split, 0).contiguous()
    out = torch.empty_like(y)
    dist.all_to_all_single(out, y, group=group)
    out = out.movedim(0, concat)  # rank axis just before the concat axis
    s = list(out.shape)
    out = out.reshape(s[:concat] + [s[concat] * s[concat + 1]] + s[concat + 2:])
    return _like(out, x)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.args = (split, concat, group)
        return _all_to_all(x, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        split, concat, group = ctx.args
        return _AllToAll.apply(g, concat, split, group), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.args = (dim, group)
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        return _Gather.apply(g, dim, group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.args = (dim, group)
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        return _Scatter.apply(g, dim, group), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.group), None


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.dim()


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks; the gradient is summed over the ranks
    too (data-parallel: every rank's loss depends on the sum)."""
    return _AllReduce.apply(x, group)


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int, group=None) -> torch.Tensor:
    """Tiled all-to-all (``jax.lax.all_to_all(..., tiled=True)``): axis
    ``split_axis`` splits into one chunk per rank, chunk j goes to rank j,
    and the received chunks concatenate along ``concat_axis``.  The
    backward is the reverse all-to-all."""
    return _AllToAll.apply(x, _dim(x, split_axis), _dim(x, concat_axis), group)


def scatter(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """This rank's chunk of a replicated ``x`` along ``dim``; the backward
    all-gathers the chunks' gradients."""
    return _Scatter.apply(x, _dim(x, dim), group)


def gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's chunk, concatenated along ``dim`` in rank order (the
    same tensor on every rank); the backward takes this rank's chunk."""
    return _Gather.apply(x, _dim(x, dim), group)


def copy_to_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` itself, entering work split between ranks: the gradient is the
    sum of every rank's."""
    return _Copy.apply(x, group)


def reduce_from_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``, leaving work split between ranks into
    a replicated region: the gradient passes through unchanged."""
    return _Reduce.apply(x, group)


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data-parallel ranks of a per-rank batch mean
    (equal shards: the global batch mean), differentiable; ``x`` itself
    outside :func:`data_parallel`."""
    group = data_group()
    if group is None:
        return x
    return all_reduce(x, group) / dist.get_world_size(group)


@torch.no_grad()
def data_max(x: torch.Tensor) -> torch.Tensor:
    """The maximum over the data-parallel ranks (no gradient: the losses
    take it through ``detach``); ``x`` itself outside
    :func:`data_parallel`."""
    group = data_group()
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


@torch.no_grad()
def sum_no_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, outside autograd."""
    return _all_reduce(x, group)


@torch.no_grad()
def gather_batch(x: torch.Tensor, group: Optional[object] = None) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order, without gradient (the
    global batch, for metrics such as PSNR and SSIM that reduce over it)."""
    return _all_gather(x, 0, group)
