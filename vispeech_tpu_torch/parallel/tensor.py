"""The model axis's collectives (tensor parallelism), as autograd functions.

A model group holds ``size`` ranks that see the same batch and the same
random streams; a parameter sharded on the model axis (``sharding.py``)
holds its ``rank``-th slice of output channels on each.  Every rank runs
the same replicated compute (alike up to rounding: the training step
averages the replicated parameters' gradients over the group, so their
copies stay equal), and a sharded layer meets it through three functions,
chosen so that each rank's autograd yields the true gradient of its own
slice and of every replicated tensor:

- ``copy``: identity forward; the backward sums the gradient over the
  group (the input of a column-parallel conv, whose gradient each rank
  holds a part of: the part its own output channels send back);
- ``gather``: all-gathers the slices along a dim; the backward keeps the
  rank's own slice of the (replicated) gradient (the output of a
  column-parallel conv, or a sharded weight gathered for replicated
  compute: kernels B, C, D and E take full weights);
- ``all_reduce``: sums over the group, forward and backward (the squared
  norm of ``WNConvTranspose1d``'s weight norm, per input channel over
  output channels that lie on every rank).

Only ``all_reduce`` and ``all_gather`` (of a list) are called: gloo, which
runs the model axis on the CPU, carries both for CPU and CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place in its model group.  ``column``: the layer that
    holds it computes its own output channels and gathers them; else it
    gathers its weight and computes all of them."""

    group: dist.ProcessGroup
    rank: int
    size: int
    column: bool = True

    def own(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of the whole tensor ``t`` along ``dim``."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, dim, self)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _AllReduce.apply(x, self)


def _all_reduce(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=shard.group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.shard), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(shard.size)]
        dist.all_gather(parts, x, group=shard.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.own(grad, ctx.dim).contiguous(), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _all_reduce(x, shard)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.shard), None
